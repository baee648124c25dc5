"""Decode throughput of the transformer LM at ``bench.py``'s accelerator
configuration (reference: ``bench.py`` ``bench_decode`` and
``bench_decode_scan``): vocab 32768, hidden 1024, 16 heads, 12 layers, a
2048-position cache, batch 8, weights and caches in bf16 through
``type_dict`` (the scores, softmax and PV stay fp32 inside the decode op).

* ``bench_decode``: tokens/s through the one-token graph
  (``get_decode_symbol``), one forward a token, the token and position
  copied in from pinned memory and the caches fed back with ``alias``
  (written in place, so the captured graph holds). ``captured=False`` runs
  the eager walk on the card.
* ``bench_decode_scan``: tokens/s of ``GenerateScan``, a whole sequence in
  one call (prime 4, the rest of the 2048 positions generated): one token
  step captured as a CUDA graph and replayed a token.

Each prints ``bench.py``'s JSON fields (``metric``, ``value``, ``unit``,
``vs_baseline``) and the port's own (ms a token, host issue ms, the
forward's graph counters). ``bench_decode`` times as ``bench.py``'s
``_measure`` does (runs of n1 and n steps after the warm-up, differenced);
``bench_decode_scan`` times whole calls after a warm-up call.

    python -m mxnet_tpu_torch.tools.decode_bench [--steps 256] [--scan]
        [--eager] [--cpu]

On the card unless ``--cpu`` (which shrinks the model to ``bench.py``'s CPU
sizes: vocab 256, hidden 32, 4 heads, 2 layers, cache 64, batch 2, fp32).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

ACCEL = dict(vocab=32768, hidden=1024, heads=16, layers=12, seq=2048,
             batch=8, dtype="bfloat16")
SMALL = dict(vocab=256, hidden=32, heads=4, layers=2, seq=64, batch=2,
             dtype="float32")


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(step, device, steps):
    """``bench.py``'s ``_measure``: one step, two more, then runs of n1 and
    ``steps`` steps each ended by a device sync; returns (steps a second
    over the difference, host ms to issue a step in the longer run)."""
    step()
    _sync(device)
    for _ in range(2):
        step()
    _sync(device)

    def timed(n):
        tic = time.perf_counter()
        for _ in range(n):
            step()
        issued = time.perf_counter() - tic
        _sync(device)
        return time.perf_counter() - tic, issued

    n1 = max(2, steps // 4)
    steps = max(steps, n1 + 1)
    t1, _ = timed(n1)
    t2, issued = timed(steps)
    return (steps - n1) / max(1e-9, t2 - t1), issued / steps * 1e3


def _host_in(t, host):
    """Copy host numpy ``host`` into tensor ``t`` in place; on the card
    from pinned memory without waiting for the device."""
    import torch

    src = torch.from_numpy(np.ascontiguousarray(host)).to(t.dtype)
    if t.is_cuda:
        t.copy_(src.pin_memory(), non_blocking=True)
    else:
        t.copy_(src)


def bind_decode(mx, ctx, cfg, seed=0):
    """The one-token decode graph bound at ``cfg`` with random weights
    (randn * 0.02 from ``seed``, as ``bench.py``); (executor, cache
    names)."""
    from mxnet_tpu_torch.models import transformer_lm

    dsym, cache_names = transformer_lm.get_decode_symbol(
        vocab_size=cfg["vocab"], num_layers=cfg["layers"],
        hidden=cfg["hidden"], heads=cfg["heads"], max_len=cfg["seq"])
    shapes = {"data": (cfg["batch"], 1), "pos": (1,)}
    shapes.update({n: (cfg["batch"], cfg["seq"], cfg["hidden"])
                   for n in cache_names})
    type_dict = ({n: "bfloat16" for n in dsym.list_arguments()
                  if n not in ("data", "pos")}
                 if cfg["dtype"] == "bfloat16" else None)
    ex = dsym.simple_bind(ctx, grad_req="null", type_dict=type_dict,
                          **shapes)
    rng = np.random.RandomState(seed)
    for name, arr in ex.arg_dict.items():
        if name not in shapes:
            _host_in(arr.data, (rng.randn(*arr.shape) * 0.02)
                     .astype(np.float32))
    return ex, cache_names


class DecodeLoop:
    """``bench.py``'s decode step over a bound executor: token ``t %
    vocab`` at position ``t % seq`` for every row, the caches fed back;
    ``captured`` False runs the eager walk even on the card."""

    def __init__(self, ex, cache_names, cfg, captured=True):
        from mxnet_tpu_torch.module.step_graph import ForwardProgram

        self.ex, self.cache_names, self.cfg = ex, cache_names, cfg
        if ex._eval_program is None:
            ex._eval_program = ForwardProgram(ex)
        self.program = ex._eval_program
        self.program.capturable = captured and \
            self.program.device.type == "cuda" and \
            self.program.refusal is None
        self.t = 0
        self.cache_copies = 0   # cache outputs that were not the bound array

    def __call__(self):
        ex, cfg = self.ex, self.cfg
        _host_in(ex.arg_dict["data"].data,
                 np.full((cfg["batch"], 1), self.t % cfg["vocab"],
                         np.float32))
        _host_in(ex.arg_dict["pos"].data,
                 np.array([self.t % cfg["seq"]], np.float32))
        outs = ex.forward(is_train=False)
        for n, o in zip(self.cache_names, outs[1:]):
            if o.data is not ex.arg_dict[n].data:
                self.cache_copies += 1
            ex.arg_dict[n].alias(o)
        self.t += 1
        return outs[0]


def bench_decode(ctx=None, steps=256, cfg=ACCEL, captured=True, seed=0,
                 loop=None):
    """Decode tokens/s through the one-token graph; a dict of
    ``bench.py``'s fields and the port's. ``loop``: a bound
    :class:`DecodeLoop` to reuse."""
    import mxnet_tpu_torch as mx

    ctx = ctx if ctx is not None else mx.gpu(0)
    if loop is None:
        ex, names = bind_decode(mx, ctx, cfg, seed)
        loop = DecodeLoop(ex, names, cfg, captured)
    else:
        loop.program.capturable = captured and \
            loop.program.device.type == "cuda"
    before = dict(loop.program.stats)
    rate, issue_ms = measure(loop, ctx.torch_device, steps)
    after = loop.program.stats
    tok_s = cfg["batch"] * rate
    return {
        "metric": f"transformer-lm-decode-tok/s(b={cfg['batch']},"
                  f"cache={cfg['seq']},{cfg['dtype']})",
        "value": round(tok_s, 1),
        "unit": "tok/s",
        "vs_baseline": 0.0,
        "mode": "captured" if loop.program.capturable else "eager",
        "ms_per_token": 1e3 / rate,
        "host_issue_ms_per_token": issue_ms,
        "tokens_timed": steps,
        "cache_copies": loop.cache_copies,
        "forward": {k: after[k] - before[k] for k in
                    ("eager_runs", "warmups", "captures", "replays",
                     "drops")},
        "loop": loop,
    }


def scan_inputs(mx, ctx, cfg, seed=0, prime_len=4):
    """``bench.py``'s GenerateScan inputs: random stacked weights (gammas
    1), a random prime; (prime, weights list, gen_len)."""
    from mxnet_tpu_torch.ops.transformer_stack import _ROLES

    rng = np.random.RandomState(seed)
    v, e, layers, seq = cfg["vocab"], cfg["hidden"], cfg["layers"], \
        cfg["seq"]

    def arr(a):
        nd = mx.nd.array(np.asarray(a, np.float32), ctx)
        return nd.astype("bfloat16") if cfg["dtype"] == "bfloat16" else nd

    def role_stack(name, shape_fn):
        shape = shape_fn(e, 4 * e)
        if name.endswith("gamma"):
            return np.ones((layers,) + shape, np.float32)
        return rng.randn(layers, *shape).astype(np.float32) * 0.02

    embed = arr(rng.randn(v, e) * 0.02)
    pos = arr(rng.randn(seq, e) * 0.02)
    stacked = [arr(role_stack(name, fn)) for name, fn in _ROLES]
    fg, fb = arr(np.ones(e)), arr(np.zeros(e))
    hw, hb = arr(rng.randn(v, e) * 0.02), arr(np.zeros(v))
    prime = mx.nd.array(rng.randint(0, v, (cfg["batch"], prime_len))
                        .astype(np.float32), ctx)
    return prime, [embed, pos, *stacked, fg, fb, hw, hb], seq - prime_len


def bench_decode_scan(ctx=None, reps=1, cfg=ACCEL, seed=0):
    """Tokens/s of ``GenerateScan`` over whole sequences: one call that
    warms up and captures the token step, then ``reps`` calls timed each
    (host clock to a device sync; ``bench.py`` differences two runs of
    several, each sequence taking seconds here). A dict of ``bench.py``'s
    fields and the port's: ms a sequence (the median), host issue ms a
    sequence, token-step replays and captures, the last call's tokens."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import generate_scan

    ctx = ctx if ctx is not None else mx.gpu(0)
    device = ctx.torch_device
    prime, weights, gen_len = scan_inputs(mx, ctx, cfg, seed)

    def call():
        return mx.nd.GenerateScan(
            prime, *weights, num_layers=cfg["layers"],
            num_heads=cfg["heads"], gen_len=gen_len)

    replays0 = generate_scan.stats["replays"]
    captures0 = generate_scan.stats["captures"]
    first = call().asnumpy()
    seq_ms, issue_ms = [], []
    for _ in range(reps):
        _sync(device)
        tic = time.perf_counter()
        out = call()
        issue_ms.append((time.perf_counter() - tic) * 1e3)
        _sync(device)
        seq_ms.append((time.perf_counter() - tic) * 1e3)
    ms = float(np.median(seq_ms))
    return {
        "metric": f"transformer-lm-decode-scan-tok/s(b={cfg['batch']},"
                  f"T={cfg['seq']},{cfg['dtype']})",
        "value": round(cfg["batch"] * gen_len / ms * 1e3, 1),
        "unit": "tok/s",
        "vs_baseline": 0.0,
        "dispatches_per_seq": 1,
        "ms_per_sequence": ms,
        "host_issue_ms_per_sequence": float(np.median(issue_ms)),
        "gen_len": gen_len,
        "replays": generate_scan.stats["replays"] - replays0,
        "captures": generate_scan.stats["captures"] - captures0,
        "first_tokens": first,
        "tokens": out.asnumpy(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--scan", action="store_true",
                    help="bench_decode_scan (GenerateScan) instead")
    ap.add_argument("--eager", action="store_true",
                    help="run the one-token graph eagerly on the card")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU at bench.py's CPU sizes")
    args = ap.parse_args(argv)
    import mxnet_tpu_torch as mx

    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    cfg = SMALL if args.cpu else ACCEL
    if args.scan:
        rec = bench_decode_scan(ctx, 1, cfg)
        rec.pop("tokens")
        rec.pop("first_tokens")
    else:
        rec = bench_decode(ctx, args.steps, cfg, captured=not args.eager)
        rec.pop("loop")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
