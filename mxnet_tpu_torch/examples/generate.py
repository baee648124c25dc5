"""Autoregressive generation from the transformer LM (reference:
example/transformer-lm/generate.py), the decode half of ``train_lm.py``.

``models.transformer_lm.get_decode_symbol`` is a one-token graph over
per-layer fixed-size KV caches; the step is bound once and run for every
token (on the card: one CUDA graph, replayed), its cache outputs fed back
with ``alias`` (the caches are written in place, so nothing moves), and
only the sampled ids cross to the device. ``--scan`` generates greedily
with the ``GenerateScan`` op instead: one token step captured and replayed
on the device until the sequence ends.

Task: train on ``train_lm.py``'s 2nd-order Markov chain, then generate and
count how often the generated transitions are legal under the true table:
near 1 once the model has learned the chain, about 3/32 untrained. The
reference's gate is above 0.4.

    python -m mxnet_tpu_torch.examples.generate [--steps 600]
        [--gen-len 14] [--gen-batch 16] [--scan] [--cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from . import train_lm as tlm

VOCAB, SEQ = tlm.VOCAB, tlm.SEQ
LAYERS, HIDDEN, HEADS = 2, 64, 4


def train(ctx, steps, batch=32, lr=3e-3, seed=0):
    """Train the LM on the chain for ``steps`` Adam steps; returns (table,
    arg_params)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import DataBatch

    rng = np.random.RandomState(seed)
    table = tlm.make_chain(rng)
    net = mx.models.transformer_lm.get_symbol(
        vocab_size=VOCAB, num_layers=LAYERS, hidden=HIDDEN, heads=HEADS,
        seq_len=SEQ, causal=True)
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (batch, SEQ))],
             label_shapes=[("softmax_label", (batch, SEQ))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": lr})
    for _step in range(steps):
        x, y = tlm.sample_batch(rng, table, batch)
        b = DataBatch(data=[mx.nd.array(x, ctx)],
                      label=[mx.nd.array(y, ctx)])
        mod.forward_backward(b)
        mod.update()
    arg_params, _ = mod.get_params()
    return table, arg_params


def generator(arg_params, ctx, batch=1, max_len=SEQ):
    """Bind the decode graph once; return ``step(tokens, t) -> probs``."""
    import mxnet_tpu_torch as mx

    dsym, cache_names = mx.models.transformer_lm.get_decode_symbol(
        vocab_size=VOCAB, num_layers=LAYERS, hidden=HIDDEN, heads=HEADS,
        max_len=max_len)
    shapes = {"data": (batch, 1), "pos": (1,)}
    shapes.update({n: (batch, max_len, HIDDEN) for n in cache_names})
    ex = dsym.simple_bind(ctx, grad_req="null", **shapes)
    skip = set(cache_names) | {"data", "pos"}
    for name, arr in arg_params.items():
        if name in ex.arg_dict and name not in skip:
            ex.arg_dict[name].data.copy_(arr.data)

    def step(tok_ids, t):
        ex.forward(is_train=False,
                   data=np.asarray(tok_ids, np.float32).reshape(-1, 1),
                   pos=np.array([t], np.float32))
        outs = ex.outputs
        for n, o in zip(cache_names, outs[1:]):
            ex.arg_dict[n].alias(o)   # the same tensors: no copy
        return outs[0].asnumpy()

    step.executor = ex
    return step


def generate_scan(arg_params, prime, gen_len, ctx, max_len=SEQ):
    """Greedy generation of the whole sequence through ``GenerateScan``
    over the checkpoint's weights stacked by layer."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import stack_lm_params
    from mxnet_tpu_torch.ops.generate_scan import _INPUTS

    stacked = stack_lm_params(arg_params, LAYERS)
    stacked["pos_weight"] = stacked["pos_weight"][:max_len]
    ins = [mx.nd.array(np.asarray(stacked[n], np.float32), ctx)
           for n in _INPUTS[1:]]
    out = mx.nd.GenerateScan(
        mx.nd.array(np.asarray(prime, np.float32), ctx), *ins,
        num_layers=LAYERS, num_heads=HEADS, gen_len=gen_len)
    return out.asnumpy().astype(np.int64)


def generate(step, prime, length, greedy=True, seed=0):
    """prime: (B, P) int array; returns (B, P + length) tokens."""
    rng = np.random.RandomState(seed)
    prime = np.asarray(prime)
    toks = [prime[:, i] for i in range(prime.shape[1])]
    probs = None
    for t in range(prime.shape[1]):
        probs = step(toks[t], t)
    for t in range(prime.shape[1], prime.shape[1] + length):
        if greedy:
            nxt = probs.argmax(axis=1)
        else:
            nxt = np.array([rng.choice(VOCAB, p=p / p.sum())
                            for p in probs])
        toks.append(nxt)
        probs = step(nxt, t)
    return np.stack(toks, axis=1)


def legal_fraction(toks, table):
    """Share of generated transitions the true chain allows (toks: (B, T)
    ints; the 2 unconditioned prime tokens are skipped)."""
    ok = total = 0
    for row in toks:
        for i in range(2, len(row)):
            total += 1
            ok += table[row[i - 2], row[i - 1], row[i]] > 0
    return ok / max(total, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    # learned absolute positions bound generation to the trained window
    ap.add_argument("--gen-len", type=int, default=SEQ - 2)
    ap.add_argument("--gen-batch", type=int, default=16)
    ap.add_argument("--scan", action="store_true",
                    help="generate greedily with the GenerateScan op "
                         "instead of the per-step loop")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card, gpu(0))")
    args = ap.parse_args(argv)
    import mxnet_tpu_torch as mx

    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    table, arg_params = train(ctx, args.steps)
    gen_len = min(args.gen_len, SEQ - 2)
    rng = np.random.RandomState(3)
    prime = rng.randint(0, VOCAB, (args.gen_batch, 2))
    if args.scan:
        toks = generate_scan(arg_params, prime, gen_len, ctx)
    else:
        step = generator(arg_params, ctx, batch=args.gen_batch,
                         max_len=SEQ)
        toks = generate(step, prime, gen_len, greedy=False)
    frac = legal_fraction(toks, table)
    print(f"generated {toks.shape[0]}x{toks.shape[1]} tokens on {ctx}; "
          f"legal-transition fraction {frac:.3f} "
          f"(untrained baseline ~{3 / VOCAB:.3f})", flush=True)
    return frac


if __name__ == "__main__":
    main()
