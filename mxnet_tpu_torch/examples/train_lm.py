"""Train the transformer LM (models/transformer_lm.py) on synthetic text
(reference: example/transformer-lm/train_lm.py).

Synthetic "language": a 2nd-order Markov chain over a 32-token alphabet with
a sparse transition table, so the model must use context (unigram perplexity
stays high). Each context allows 3 continuations, so the perplexity floor is
about 2.6; after 800 steps it must be below 3.5, the reference's gate.
Reports per-token perplexity every 75 steps.

Each step is the module's fused step (forward, backward and Adam in one
function), captured on the card as one CUDA graph and replayed, as the
reference's step is one compiled program (``MXTPU_NO_FUSED_STEP=1`` runs
the split path).

Run on the card: ``python -m mxnet_tpu_torch.examples.train_lm``; on the
CPU: ``--cpu``. ``--seq-parallel N`` (sequence sharded over N devices) waits
for the multi-device work and raises.
"""
import argparse
import time

import numpy as np

VOCAB, SEQ = 32, 16


def make_chain(rng):
    """Sparse 2nd-order transitions: each (a, b) context allows 3 tokens."""
    table = np.zeros((VOCAB, VOCAB, VOCAB), np.float32)
    for a in range(VOCAB):
        for b in range(VOCAB):
            nxt = rng.choice(VOCAB, 3, replace=False)
            table[a, b, nxt] = rng.dirichlet([1.0] * 3)
    return table


def sample_batch(rng, table, batch):
    x = np.zeros((batch, SEQ), np.int64)
    x[:, 0] = rng.randint(0, VOCAB, batch)
    x[:, 1] = rng.randint(0, VOCAB, batch)
    for t in range(2, SEQ):
        for i in range(batch):
            x[i, t] = rng.choice(VOCAB, p=table[x[i, t - 2], x[i, t - 1]])
    y = np.full_like(x, -1)      # -1 = ignored by the loss (no next token)
    y[:, :-1] = x[:, 1:]
    return x.astype(np.float32), y.astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq-parallel", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the card, gpu(0))")
    args = ap.parse_args(argv)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import DataBatch

    if args.seq_parallel > 1:
        raise mx.MXNetError("--seq-parallel: sequence-parallel training "
                            "over a device mesh is not ported yet")
    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    net = mx.models.transformer_lm.get_symbol(
        vocab_size=VOCAB, num_layers=2, hidden=64, heads=4, seq_len=SEQ)
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (args.batch, SEQ))],
             label_shapes=[("softmax_label", (args.batch, SEQ))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 2e-3})

    rng = np.random.RandomState(0)
    table = make_chain(np.random.RandomState(42))
    ppl = float("inf")
    t0 = time.perf_counter()
    for step in range(args.steps):
        x, y = sample_batch(rng, table, args.batch)
        mod.forward(DataBatch(data=[mx.nd.array(x, ctx)],
                              label=[mx.nd.array(y, ctx)]), is_train=True)
        if step % 75 == 0 or step == args.steps - 1:
            probs = mod.get_outputs()[0].asnumpy().reshape(
                args.batch, SEQ, VOCAB)
            # per-token nll on positions with >= 2 tokens of context
            p = np.take_along_axis(probs[:, 2:-1],
                                   y[:, 2:-1, None].astype(int), 2)
            ppl = float(np.exp(-np.log(np.maximum(p, 1e-9)).mean()))
            print(f"step {step}: perplexity {ppl:.2f} "
                  f"(3 allowed continuations => floor ~2.6)", flush=True)
        mod.backward()
        mod.update()
    print(f"{args.steps} steps in {time.perf_counter() - t0:.1f} s on {ctx}",
          flush=True)
    if args.steps >= 800:
        assert ppl < 3.5, ppl
    return ppl


if __name__ == "__main__":
    main()
