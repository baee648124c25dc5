"""How far apart two fp32 runs of one ResNet-50 training step land, on the
card and on the CPU.

The step is ``chip_smoke.py`` phase 10's card-vs-CPU step (ResNet-50 at
batch 8, 64 px, 16 classes, SGD, TF32 off), every run on the ReLU masks of
the first card run. It runs on the card twice, once more with
``torch.backends.cudnn.deterministic``, and on the CPU with 8, 4 and 1
threads; for each pair it prints the per-example NLL gap and the arrays
whose gradients, moving statistics and updated weights part most (largest
difference over the array's max-abs). Two runs that differ only in the
order of their sums show how far fp32 can reproduce each array at all.
Run from the repo root on a machine with an NVIDIA GPU:

    python3 mxnet_tpu_torch/tools/fp32_step_spread.py [--seed 0]

and the pairs are written to ``fp32_step_spread.json`` in
``chip_smoke.py``'s output directory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.ops import get_op  # noqa: E402

PAIRS = [("card", "cpu8"), ("card", "cpu1"), ("cpu8", "cpu1"),
         ("cpu8", "cpu4"), ("card", "card_again"),
         ("card", "card_deterministic")]


def run_step(ctx, weights, seed, act, masks, record):
    """One SGD step of the Module on ``ctx``; the ReLUs record their masks
    (``record``) or take the recorded ones. Returns the per-example NLL,
    gradients, moving statistics and weights after the update, as numpy."""
    act_fn = act.fn
    used = []

    def relu(ctx_, attrs, data):
        if record:
            masks.append((data > 0).cpu())
            return act_fn(ctx_, attrs, data)
        mask = masks[len(used)].to(data.device)
        used.append(1)
        return data.masked_fill(~mask, 0.0)

    mod = cs._small_resnet(mx, ctx, None, True, weights)
    mod.init_optimizer(optimizer="sgd", optimizer_params=cs.FIT_SGD)
    batch, y = cs._cpu_batch(mx, seed + 22, ctx)
    act.fn = relu
    try:
        mod.forward(batch, is_train=True)
    finally:
        act.fn = act_fn
    mod.backward()
    probs = mod.get_outputs()[0].asnumpy()
    grads = {n: g.asnumpy()
             for n, g in mod._exec_group._executor.grad_dict.items()}
    mod.update()
    args, aux = mod.get_params()
    return (-np.log(probs[np.arange(len(y)), y.astype(int)]), grads,
            {n: a.asnumpy() for n, a in aux.items()},
            {n: a.asnumpy() for n, a in args.items()})


def spread(a, b, top=4):
    out = {"nll_max_abs": float(np.abs(a[0] - b[0]).max())}
    for i, key in ((1, "grad"), (2, "aux"), (3, "weight")):
        rel = sorted(((cs._rel(a[i][n], b[i][n]), n) for n in a[i]),
                     reverse=True)
        out[key] = [[n, r] for r, n in rel[:top]]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    card = cs.phase_device()
    symbol = cs.resnet_symbol(mx, cs.FIT_CPU_CLASSES, cs.FIT_CPU_PX)
    weights = cs.resnet_weights(symbol, cs.FIT_CPU_BATCH, cs.FIT_CPU_PX,
                                args.seed + 21)
    act, masks, runs = get_op("Activation"), [], {}
    runs["card"] = run_step(mx.gpu(0), weights, args.seed, act, masks, True)
    runs["card_again"] = run_step(mx.gpu(0), weights, args.seed, act, masks,
                                  False)
    torch.backends.cudnn.deterministic = True
    runs["card_deterministic"] = run_step(mx.gpu(0), weights, args.seed, act,
                                          masks, False)
    torch.backends.cudnn.deterministic = False
    threads = torch.get_num_threads()
    for n in (8, 4, 1):
        torch.set_num_threads(n)
        runs[f"cpu{n}"] = run_step(mx.cpu(), weights, args.seed, act, masks,
                                   False)
    torch.set_num_threads(threads)
    res = {"card": card}
    for a, b in PAIRS:
        res[f"{a} vs {b}"] = spread(runs[a], runs[b])
        print(f"{a} vs {b}: " + json.dumps(res[f"{a} vs {b}"]), flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "fp32_step_spread.json"), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
