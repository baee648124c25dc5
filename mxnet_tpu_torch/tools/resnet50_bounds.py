"""Least times of ResNet-50's training-step parts on an H100, derived from
the model's shapes and the card's peak rates (no card needed: the shapes
come from the port's symbol on ``meta`` tensors).

- Convolutions: forward FLOPs from each convolution's output size and
  kernel, times 3 for forward and backward (the backward's data and weight
  gradients each cost a forward; the first convolution's data gradient is
  not needed), at the bf16 tensor-core peak.
- BatchNorm: each activation element read and written once forward (bf16
  in, bf16 out: 4 bytes) and its input and output gradient read and the
  input gradient written once backward (6 bytes), at the HBM rate.
- The batch's host-to-device copy: 256 x 3 x 224 x 224 fp32 over one
  direction of the card's PCIe Gen5 x16 link.

Peaks: NVIDIA's H100 SXM data sheet, dense (989 TFLOP/s bf16, 3.35 TB/s
HBM3, PCIe Gen5 128 GB/s both ways, 64 each way), at the 700 W limit.

    python3 mxnet_tpu_torch/tools/resnet50_bounds.py [--batch 256]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..", "..")))

BF16_FLOPS, HBM_BYTES, PCIE_BYTES = 989e12, 3.35e12, 64e9


def shapes(batch, px):
    """(BatchNorm activation elements, forward convolution FLOPs, the first
    convolution's forward FLOPs) of one step at ``batch``."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import OpCtx, get_op

    sym = mx.models.resnet.get_symbol(num_classes=1000, num_layers=50,
                                      image_shape=f"3,{px},{px}",
                                      layout="NCHW")
    args, _, auxs = sym.infer_shape(data=(batch, 3, px, px),
                                    softmax_label=(batch,))
    known = dict(zip(sym.list_arguments(), args))
    known.update(zip(sym.list_auxiliary_states(), auxs))
    vals, bn, conv, first = {}, 0, 0, None
    for node in sym._nodes():
        if node.is_variable:
            vals[(id(node), 0)] = torch.empty(known[node.name],
                                              device="meta")
            continue
        ins = [vals[(id(n), i)] for n, i in node.inputs]
        aux = [vals[(id(a), 0)] for a in node.aux_vars]
        outs, _ = get_op(node.op).normalized_call(
            OpCtx(device=torch.device("meta")), node.attrs, ins, aux)
        for i, o in enumerate(outs):
            vals[(id(node), i)] = o
        if node.op == "BatchNorm":
            bn += outs[0].numel()
        elif node.op == "Convolution":
            w = ins[1]
            flops = 2 * outs[0].numel() * w.shape[1] * w.shape[2] * w.shape[3]
            conv += flops
            first = flops if first is None else first
    return bn, conv, first


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--px", type=int, default=224)
    a = ap.parse_args(argv)
    bn, conv, first = shapes(a.batch, a.px)
    conv_step = 3 * conv - first
    bn_bytes = 10 * bn
    h2d = a.batch * 3 * a.px * a.px * 4
    print(json.dumps({
        "batch": a.batch, "px": a.px,
        "conv_tflop_per_step": conv_step / 1e12,
        "conv_bound_ms": conv_step / BF16_FLOPS * 1e3,
        "batchnorm_elements_per_step": bn,
        "batchnorm_gb_per_step": bn_bytes / 1e9,
        "batchnorm_bound_ms": bn_bytes / HBM_BYTES * 1e3,
        "h2d_mb_per_batch": h2d / 1e6,
        "h2d_bound_ms": h2d / PCIE_BYTES * 1e3}))


if __name__ == "__main__":
    main()
