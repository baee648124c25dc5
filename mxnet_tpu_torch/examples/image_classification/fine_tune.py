#!/usr/bin/env python
"""Fine-tune a checkpoint: load it, swap the classifier head, freeze the
body (reference: example/image-classification/fine_tune.py; its
``get_fine_tune_model`` slices the symbol at the flatten layer and trains a
fresh FC on top).

The synthetic flow: LeNet pretrained on a 10-class task, then fine-tuned on
a new 4-class task with only the new head trained (``fixed_param_names``
freezes the rest). ``python -m mxnet_tpu_torch.examples.image_classification.
fine_tune [--cpu] [--prefix P]`` runs on the card (gpu 0) unless ``--cpu``;
the checkpoint goes to ``P`` (default ``ft_base`` in the temporary
directory).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..")))

import mxnet_tpu_torch as mx  # noqa: E402


def make_data(rng, proto, n, noise=0.3):
    y = rng.randint(0, len(proto), n)
    x = proto[y] + rng.randn(n, 1, 28, 28).astype(np.float32) * noise
    return x, y.astype(np.float32)


def get_fine_tune_model(sym, num_classes, layer_name="flatten0"):
    """Slice at ``layer_name`` and attach a fresh head."""
    internals = sym.get_internals()
    net = internals[layer_name + "_output"]
    net = mx.sym.FullyConnected(data=net, num_hidden=num_classes,
                                name="fc_new")
    return mx.sym.SoftmaxOutput(data=net, name="softmax")


def main(argv=None):
    """Pretrain, fine-tune and check the frozen body; returns the head's
    accuracy on the new task and the frozen parameters' largest drift."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--prefix",
                    default=os.path.join(tempfile.gettempdir(), "ft_base"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    ctx = mx.cpu() if args.cpu else mx.gpu(0)

    rng = np.random.RandomState(0)
    proto10 = rng.randn(10, 1, 28, 28).astype(np.float32)
    x, y = make_data(rng, proto10, 512)
    it = mx.io.NDArrayIter(x, y, batch_size=64, shuffle=True)
    # named as in a fresh process (the slice point is "flatten0")
    with mx.name.NameManager():
        net = mx.models.lenet.get_symbol(10)
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(it, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.5},
            initializer=mx.init.Xavier(),
            epoch_end_callback=mx.callback.do_checkpoint(args.prefix),
            num_epoch=3)

    # fine-tune to a new 4-class task, body frozen
    sym_loaded, arg_params, aux_params = mx.model.load_checkpoint(
        args.prefix, 3, ctx=ctx)
    new_net = get_fine_tune_model(sym_loaded, 4)
    proto4 = np.random.RandomState(7).randn(4, 1, 28, 28).astype(np.float32)
    x2, y2 = make_data(np.random.RandomState(1), proto4, 384)
    it2 = mx.io.NDArrayIter(x2, y2, batch_size=64, shuffle=True)

    fixed = [n for n in new_net.list_arguments()
             if n not in ("data", "softmax_label")
             and not n.startswith("fc_new")]
    ft = mx.mod.Module(new_net, context=ctx, fixed_param_names=fixed)
    ft.bind(data_shapes=it2.provide_data, label_shapes=it2.provide_label)
    ft.init_params(mx.init.Xavier())
    ft.set_params(arg_params, aux_params, allow_missing=True)
    frozen_before = {n: arg_params[n].asnumpy() for n in fixed}
    ft.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": 0.1})
    for _ in range(4):
        it2.reset()
        for batch in it2:
            ft.forward(batch, is_train=True)
            ft.backward()
            ft.update()
    acc = dict(ft.score(it2, "acc"))["accuracy"]
    new_params, _ = ft.get_params()
    drift = max(float(np.abs(new_params[n].asnumpy() - before).max())
                for n, before in frozen_before.items())
    if drift != 0.0:
        raise mx.MXNetError(f"a frozen parameter moved ({drift})")
    print(f"fine-tuned head accuracy on new task: {acc:.3f} (body frozen)")
    return acc, drift


if __name__ == "__main__":
    main()
