"""Serving benchmark: concurrent synthetic clients against ModelServer
(reference: tools/serve_bench.py, its base mode, ``--cold-start`` and
``--scenario decode``).

    python -m mxnet_tpu_torch.tools.serve_bench [--symbol S.json
        --params P.params --input-shape data:1x3x224x224] [--clients 32]
        [--requests 8] [--batch-sizes 1,3,5] [--max-batch 16]
        [--max-wait-ms 2] [--buckets pow2] [--cold-start [--cache-dir D]]
        [--scenario decode] [--json] [--cpu]

Loads a saved symbol and params (or, with no ``--symbol``/``--params``,
builds a small seeded MLP, saves it to a temporary directory and loads it
back, so the load path is always the deployment path), starts a
ModelServer, warms every bucket the traffic hits, fires ``--clients``
threads each submitting ``--requests`` requests cycling through
``--batch-sizes``, and prints the metrics snapshot and the executor-cache
stats. The stats are the amortization evidence: binds must not exceed the
bucket count however many request sizes the traffic mixes (the run fails
otherwise).

``--cold-start``: the run above keeps a shape manifest under
``--cache-dir``; then the server is restarted in a fresh subprocess, which
prewarms from the manifest and serves one request; the ``cold_start`` block
reports construct and prewarm seconds, time to first response, and the
programs (warm-ups and captures) the first request built (0: the
cold-start contract holds).

``--scenario decode``: one request trace of mixed generation lengths
through a GenerationSession with continuous admission and with FIFO
re-batching, then chunked prefill, prefix KV reuse and speculative
decoding; gates token-identical outputs, fewer steps and more tokens/s
for continuous batching, fewer steps and a lower TTFT for chunked prefill,
cheaper warm prefix hits, and speculative tokens/s above plain decode (the
two tokens/s gates on the medians of passes taken in turns).

On the card (``gpu(0)``) unless ``--cpu``. The reference's fleet,
lifecycle, scale-out, sessions and chaos scenarios (and the admission
flags only chaos runs use) are not ported.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
# the decode scenario's rounds of (a, b, b, a) passes for each tokens/s gate
DECODE_ROUNDS = 4


def parse_shape(spec):
    """'data:1x10' -> ('data', (1, 10))"""
    name, _, dims = spec.rpartition(":")
    return name, tuple(int(d) for d in dims.split("x"))


def make_demo_model(features, classes, outdir):
    """Build and save a small seeded MLP (the reference's demo model and
    weights), so the bench always goes through the saved-artifact path."""
    import mxnet_tpu_torch as mx

    net = mx.models.mlp.get_symbol(num_classes=classes)
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = net.infer_shape(data=(1, features))
    params = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        params[f"arg:{name}"] = mx.nd.array(
            rng.randn(*shape).astype(np.float32) * 0.3, mx.cpu())
    sym_file = os.path.join(outdir, "bench-symbol.json")
    params_file = os.path.join(outdir, "bench.params")
    net.save(sym_file)
    mx.nd.save(params_file, params)
    return sym_file, params_file


def _ctx(args):
    import mxnet_tpu_torch as mx

    return mx.cpu() if args.cpu else mx.gpu(0)


def drive(server, in_name, payloads, clients, requests, batch_sizes,
          keep=0):
    """``clients`` threads, each submitting ``requests`` requests (client
    ``i``'s ``j``-th is ``payloads[batch_sizes[(i + j) % n]]``) and then
    waiting for all of them. Returns ``(wall seconds, errors, kept)``:
    ``kept`` holds ``(client, j, rows, outputs)`` of the first ``keep``
    requests by (j, client) order, for the caller to check."""
    errors, kept, lock = [], [], threading.Lock()

    def client(idx):
        futs = []
        for i in range(requests):
            b = batch_sizes[(idx + i) % len(batch_sizes)]
            futs.append((i, b, server.submit({in_name: payloads[b]})))
        for i, b, f in futs:
            try:
                out = f.result(timeout=300)
                if out[0].shape[0] != b:
                    errors.append(f"client {idx}: got {out[0].shape[0]} "
                                  f"rows for a {b}-row request")
                if i * clients + idx < keep:
                    with lock:
                        kept.append((idx, i, b, out))
            except Exception as e:  # reported after the run
                errors.append(f"client {idx}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    kept.sort(key=lambda k: (k[1], k[0]))
    return wall, errors, kept


def run_cold_start_child(args, sym_file, params_file, in_name, in_shape,
                         batch_sizes):
    """The restarted replica: construct, prewarm from the manifest, serve
    one request, and print the cold-start numbers as JSON."""
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    server = mx.ModelServer((sym_file, params_file),
                            input_shapes={in_name: in_shape}, ctx=_ctx(args),
                            max_batch_size=args.max_batch,
                            max_wait_ms=args.max_wait_ms,
                            buckets=args.buckets)
    construct_s = time.perf_counter() - t0
    prewarm = server.prewarm(block=True)
    rng = np.random.RandomState(7)
    x = rng.randn(batch_sizes[0], *in_shape[1:]).astype(np.float32)
    t1 = time.perf_counter()
    out = server.infer({in_name: x})
    ttfr = time.perf_counter() - t1
    stats = server.cache_stats()
    doc = {
        "construct_s": construct_s,
        "prewarm": prewarm,
        "prewarm_captures": stats["captures"],
        "ttfr_s": ttfr,
        "total_to_first_response_s": time.perf_counter() - t0,
        "compiles_at_first_request": server.first_request_compiles,
        "manifest_entries": server.manifest.size() if server.manifest else 0,
        "buckets": server.buckets,
        "rows": int(out[0].shape[0]),
    }
    server.close()
    print(json.dumps(doc))
    return 0


def run_cold_start_parent(args, sym_file, params_file, in_name, in_shape):
    """Restart the server in a fresh subprocess on the kept manifest;
    returns its cold-start report (raises on failure)."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.serve_bench",
           "--cold-start-child", "--symbol", sym_file, "--params",
           params_file, "--input-shape",
           f"{in_name}:" + "x".join(str(d) for d in in_shape),
           "--batch-sizes", args.batch_sizes, "--cache-dir", args.cache_dir]
    if args.max_batch is not None:
        cmd += ["--max-batch", str(args.max_batch)]
    if args.max_wait_ms is not None:
        cmd += ["--max-wait-ms", str(args.max_wait_ms)]
    if args.buckets is not None:
        cmd += ["--buckets", args.buckets]
    if args.cpu:
        cmd += ["--cpu"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=540,
                       env=env)
    if r.returncode != 0:
        raise RuntimeError(f"cold-start child failed (rc={r.returncode}): "
                           f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


# -- --scenario decode -----------------------------------------------------------

def _random_decode_params(V, L, H, HEADS, T, seed=0, scale=0.1):
    """Random weights of the batch-decode graph (greedy decode is still
    deterministic)."""
    from mxnet_tpu_torch.models import transformer_lm

    dsym, cache_names = transformer_lm.get_batch_decode_symbol(
        vocab_size=V, num_layers=L, hidden=H, heads=HEADS, max_len=T)
    shapes = {"data": (1, 1), "pos": (1,)}
    shapes.update({n: (1, T, H) for n in cache_names})
    arg_shapes, _, _ = dsym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {name: (rng.randn(*s) * scale).astype(np.float32)
            for name, s in zip(dsym.list_arguments(), arg_shapes)
            if name not in shapes}


def _cycle_decode_params(V, L, H, HEADS, T, shift=3, scale=4.0):
    """Deterministic-cycle weights (next token = (cur + shift) % V): every
    block weight zero, a one-hot token embedding, the head a shifted
    one-hot readout of the final LayerNorm. Two models built so (a big
    target, a tiny draft) predict the same next token: a draft at full
    acceptance."""
    assert H >= V, "cycle weights need hidden >= vocab (one-hot embed)"
    params = _random_decode_params(V, L, H, HEADS, T, scale=0.0)
    for name in params:
        if name.endswith("_gamma"):
            params[name][:] = 0.0
    emb = np.zeros((V, H), np.float32)
    emb[np.arange(V), np.arange(V)] = scale
    params["tok_embed_weight"] = emb
    params["final_ln_gamma"][:] = 1.0
    head = np.zeros((V, H), np.float32)
    head[np.arange(V), (np.arange(V) - shift) % V] = 1.0
    params["head_weight"] = head
    return params


def run_decode_scenario(args):
    """One request trace through (a) FIFO re-batching, (b) continuous
    batching, (c) continuous with chunked prefill, (d) prefix KV reuse
    (the trace cold, then warm) and (e) speculative decoding on
    deterministic-cycle weights. (a) and (b), and (e) and its plain
    baseline, run in turns over several passes (``alternated``), and
    their tokens/s are the medians. Returns ``(doc, failures)``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving.metrics import percentile

    ctx = _ctx(args)
    V, L, H, HEADS, T = 32, 2, 32, 4, 48
    params = _random_decode_params(V, L, H, HEADS, T)
    rng = np.random.RandomState(0)
    gen_lens = [int(g) for g in args.gen_lens.split(",") if g.strip()]
    plen = max(2, int(args.prime_len))
    # long primes: prefill dominates TTFT (the chunk and prefix gates);
    # short primes: decode dominates (the slot-backfill gate)
    reqs = [(list(rng.randint(0, V, plen)), gen_lens[i % len(gen_lens)])
            for i in range(args.decode_requests)]
    short_reqs = [(list(rng.randint(0, V, 2)), gen_lens[i % len(gen_lens)])
                  for i in range(args.decode_requests)]
    chunk = max(2, int(args.prefill_chunk))

    def session(continuous=True, model=None, **kw):
        sess = mx.GenerationSession(
            model if model is not None else params, vocab_size=V,
            num_layers=kw.pop("num_layers", L),
            hidden=kw.pop("hidden", H), heads=kw.pop("heads", HEADS),
            max_len=T, slots=args.decode_slots, ctx=ctx,
            continuous=continuous, **kw)
        sess.warmup()   # every program built outside the timed window
        return sess

    def run(trace=None, sess=None, **kw):
        trace = trace if trace is not None else reqs
        own = sess is None
        if own:
            sess = session(**kw)
        base = sess.stats()
        n_ttft = len(sess.ttfts())
        t0 = time.perf_counter()
        futs = [sess.generate(p, g) for p, g in trace]
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        st = sess.stats()
        ttfts = sorted(sess.ttfts()[n_ttft:])
        if own:
            sess.close()
        steps = st["steps"] - base["steps"]
        tokens = st["tokens_out"] - base["tokens_out"]
        rec = {"wall_s": wall, "steps": steps, "tokens_out": tokens,
               "prefill_steps": st["prefill_steps"] - base["prefill_steps"],
               "decode_steps": st["decode_steps"] - base["decode_steps"],
               "d2h_syncs": st["d2h_syncs"] - base["d2h_syncs"],
               "ttft_p50_ms": percentile(ttfts, 50) * 1e3,
               "ttft_p99_ms": percentile(ttfts, 99) * 1e3,
               "chunk": st["chunk"],
               "occupancy": (st["slot_steps"] - base["slot_steps"])
               / max(steps * args.decode_slots, 1),
               "tokens_per_s": tokens / max(wall, 1e-9)}
        if st.get("spec"):
            rec["spec"] = st["spec"]
        if st.get("prefix_cache"):
            rec["prefix_cache"] = st["prefix_cache"]
        return rec, outs, st

    def alternated(trace, kw_a, kw_b):
        """The trace through two sessions in turns: each session warmed up
        and given one untimed pass (first-use costs out of the window),
        then a, b, b, a, ``DECODE_ROUNDS`` times. A window of one pass is
        30-40 steps of a tiny model, 60-170 ms on the CPU, and the host's
        load moves a step's time by tens of percent within seconds; turns
        cancel the drift, and each mode's ``tokens_per_s`` is the median of
        its passes (``tokens_per_s_passes``). Returns each mode's record
        (its first timed pass's counts) and the outputs of every pass."""
        sessions = [session(**kw_a), session(**kw_b)]
        recs, outs = ([], []), ([], [])
        try:
            for sess in sessions:
                run(trace=trace, sess=sess)
            for _ in range(DECODE_ROUNDS):
                for i in (0, 1, 1, 0):
                    rec, out, _ = run(trace=trace, sess=sessions[i])
                    recs[i].append(rec)
                    outs[i].append(out)
        finally:
            for sess in sessions:
                sess.close()
        merged = []
        for passes in recs:
            rec = dict(passes[0])
            rates = [r["tokens_per_s"] for r in passes]
            rec.update(tokens_per_s=float(np.median(rates)),
                       wall_s=float(np.median([r["wall_s"] for r in passes])),
                       tokens_per_s_passes=rates, passes=len(passes),
                       steps_passes=[r["steps"] for r in passes])
            merged.append(rec)
        return merged, outs

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    failures = []
    (fifo, cont), (fifo_outs, cont_outs) = alternated(
        short_reqs, {"continuous": False}, {"continuous": True})
    base, base_outs, _ = run(continuous=True)           # chunk 1, long
    chunked, chunk_outs, _ = run(prefill_chunk=chunk)   # long
    if not all(same(out, fifo_outs[0]) for out in cont_outs + fifo_outs):
        failures.append("continuous decode output differs from FIFO "
                        "re-batching (must be token-identical)")
    if not same(chunk_outs, base_outs):
        failures.append("chunked-prefill output differs from one-token-"
                        "per-step decode (must be token-identical)")
    if max(cont["steps_passes"]) >= min(fifo["steps_passes"]):
        failures.append(f"continuous took {cont['steps']} steps vs FIFO "
                        f"{fifo['steps']}: slot backfill not happening")
    if cont["tokens_per_s"] <= fifo["tokens_per_s"]:
        failures.append(
            f"continuous {cont['tokens_per_s']:.1f} tok/s did not beat "
            f"FIFO {fifo['tokens_per_s']:.1f} tok/s")
    if chunked["steps"] >= base["steps"]:
        failures.append(f"chunked prefill took {chunked['steps']} steps vs "
                        f"{base['steps']} one-token steps")
    if chunked["ttft_p50_ms"] >= base["ttft_p50_ms"]:
        failures.append(
            f"chunked TTFT p50 {chunked['ttft_p50_ms']:.1f} ms did not "
            f"beat the one-token baseline {base['ttft_p50_ms']:.1f} ms")

    # prefix KV reuse: the same trace cold, then warm, in one session
    psess = mx.GenerationSession(params, vocab_size=V, num_layers=L,
                                 hidden=H, heads=HEADS, max_len=T,
                                 slots=args.decode_slots, ctx=ctx,
                                 prefill_chunk=chunk, prefix_cache=64 << 20)
    psess.warmup()
    cold, cold_outs, _ = run(sess=psess)
    psess._prefix.page_out_all()   # the host tier must restore bit-equal
    warm, warm_outs, warm_st = run(sess=psess)
    pc = warm_st["prefix_cache"]
    psess.close()
    if not same(warm_outs, cold_outs):
        failures.append("prefix-cache warm outputs differ from the cold "
                        "run (restore must be bit-identical)")
    if pc["hits"] < len(reqs):
        failures.append(f"prefix cache hit only {pc['hits']}/{len(reqs)} "
                        "warm requests")
    if warm["prefill_steps"] >= cold["prefill_steps"]:
        failures.append(
            f"warm prefix run paid {warm['prefill_steps']} prefill steps "
            f"vs cold {cold['prefill_steps']}: reuse not engaged")

    # speculative decoding: cycle weights (full acceptance), a deep target
    sV, sL, sH, sHEADS = 32, 4, 256, 4
    target = _cycle_decode_params(sV, sL, sH, sHEADS, T)
    draft = _cycle_decode_params(sV, 1, 32, 2, T)
    spec_trace = [(list(rng.randint(0, sV, 4)),
                   gen_lens[i % len(gen_lens)] + 8)
                  for i in range(args.decode_requests)]
    target_kw = {"model": target, "num_layers": sL, "hidden": sH,
                 "heads": sHEADS}
    (plain, spec), (plain_outs, spec_outs) = alternated(
        spec_trace, target_kw,
        dict(target_kw, draft_params=draft, spec_k=args.spec_k,
             draft_config={"num_layers": 1, "hidden": 32, "heads": 2}))
    if not all(same(out, plain_outs[0]) for out in spec_outs + plain_outs):
        failures.append("speculative greedy output differs from plain "
                        "greedy (must be token-identical)")
    if spec["tokens_per_s"] <= plain["tokens_per_s"]:
        failures.append(
            f"speculative {spec['tokens_per_s']:.1f} tok/s did not beat "
            f"plain continuous {plain['tokens_per_s']:.1f} tok/s")
    doc = {"scenario": "decode", "device": str(ctx),
           "slots": args.decode_slots, "requests": len(reqs),
           "gen_lens": gen_lens, "prime_len": plen, "prefill_chunk": chunk,
           "continuous": cont, "fifo": fifo, "baseline": base,
           "chunked": chunked,
           "prefix_cache": {"cold": cold, "warm": warm, "cache": pc},
           "speculative": {"plain": plain, "spec": spec,
                           "speedup": spec["tokens_per_s"]
                           / max(plain["tokens_per_s"], 1e-9)},
           "token_identical": not any("identical" in f for f in failures),
           "speedup": fifo["wall_s"] / max(cont["wall_s"], 1e-9),
           "failures": failures}
    return doc, failures


def _print_decode(doc):
    print(f"decode scenario on {doc['device']}: {doc['requests']} requests,"
          f" {doc['slots']} KV slots, prime {doc['prime_len']}, gen lens "
          f"{doc['gen_lens']}")
    for label in ("fifo", "continuous", "baseline", "chunked"):
        r = doc[label]
        print(f"  {label:<11} {r['steps']:>4} steps ({r['prefill_steps']} "
              f"prefill / {r['decode_steps']} decode, {r['d2h_syncs']} D2H)"
              f"  ttft p50 {r['ttft_p50_ms']:.1f} ms  "
              f"{r['tokens_per_s']:.1f} tok/s")
    p = doc["prefix_cache"]
    print(f"  prefix:     cold {p['cold']['prefill_steps']} vs warm "
          f"{p['warm']['prefill_steps']} prefill steps, "
          f"{p['cache']['hits']} hits")
    s = doc["speculative"]
    print(f"  speculative: {s['plain']['tokens_per_s']:.1f} -> "
          f"{s['spec']['tokens_per_s']:.1f} tok/s (x{s['speedup']:.2f}, "
          f"acceptance {s['spec']['spec']['acceptance']:.2f})")


# -- main ----------------------------------------------------------------------

def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--symbol", help="saved symbol JSON file")
    ap.add_argument("--params", help="saved params file")
    ap.add_argument("--input-shape", default=None,
                    help="input template, e.g. data:1x10 (required with "
                         "--symbol; the batch dim is a template only)")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per client")
    ap.add_argument("--batch-sizes", default="1,3,5",
                    help="comma list of request batch sizes to cycle")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--buckets", default=None,
                    help="bucket spec: pow2 | auto | comma list "
                         "(default MXNET_SERVING_BUCKETS)")
    ap.add_argument("--features", type=int, default=32,
                    help="demo-model input width (no --symbol)")
    ap.add_argument("--classes", type=int, default=10,
                    help="demo-model class count (no --symbol)")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU (default: gpu(0))")
    ap.add_argument("--json", action="store_true",
                    help="print the report as one JSON document")
    ap.add_argument("--cold-start", action="store_true",
                    help="after the run, restart the server in a fresh "
                         "subprocess on the kept shape manifest and report "
                         "time to first response and the programs its "
                         "first request built")
    ap.add_argument("--cache-dir", default=None,
                    help="manifest directory for --cold-start (default: a "
                         "fresh temporary directory)")
    ap.add_argument("--cold-start-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--scenario", default=None, choices=("decode",),
                    help="the continuous-batching decode comparison")
    ap.add_argument("--decode-slots", type=int, default=4)
    ap.add_argument("--decode-requests", type=int, default=12)
    ap.add_argument("--gen-lens", default="4,12",
                    help="generation-length cycle for --scenario decode")
    ap.add_argument("--prime-len", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--spec-k", type=int, default=8)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cold_start or args.cold_start_child:
        if args.cache_dir is None:
            args.cache_dir = tempfile.mkdtemp(prefix="serve_cache_")
        # the shape manifest defaults to <dir>/serving_manifest.json
        os.environ["MXNET_COMPILE_CACHE_DIR"] = args.cache_dir
    import mxnet_tpu_torch as mx

    if args.scenario == "decode":
        doc, failures = run_decode_scenario(args)
        print(json.dumps(doc)) if args.json else _print_decode(doc)
        if failures:
            print("FAILED: " + "; ".join(failures), file=sys.stderr)
            return 1
        return 0
    if args.symbol or args.params:
        if not (args.symbol and args.params and args.input_shape):
            ap.error("--symbol, --params and --input-shape go together")
        sym_file, params_file = args.symbol, args.params
        in_name, in_shape = parse_shape(args.input_shape)
    else:
        sym_file, params_file = make_demo_model(
            args.features, args.classes,
            tempfile.mkdtemp(prefix="serve_bench_"))
        in_name, in_shape = "data", (1, args.features)
    batch_sizes = [int(b) for b in args.batch_sizes.split(",") if b]
    if args.cold_start_child:
        return run_cold_start_child(args, sym_file, params_file, in_name,
                                    in_shape, batch_sizes)
    server = mx.ModelServer((sym_file, params_file),
                            input_shapes={in_name: in_shape}, ctx=_ctx(args),
                            max_batch_size=args.max_batch,
                            max_wait_ms=args.max_wait_ms,
                            buckets=args.buckets)
    rng = np.random.RandomState(42)
    payloads = {b: rng.randn(b, *in_shape[1:]).astype(np.float32)
                for b in batch_sizes}
    # warm every bucket the traffic hits alone, so the timed window
    # measures serving, not binding and capturing
    for b in sorted(set(batch_sizes)):
        for _ in range(2):
            server.infer({in_name: payloads[b]})
    server.metrics.reset()
    wall, errors, _ = drive(server, in_name, payloads, args.clients,
                            args.requests, batch_sizes)
    snap = server.metrics.snapshot()
    stats = server.cache_stats()
    server.close()
    cold_start = None
    if args.cold_start:
        cold_start = run_cold_start_parent(args, sym_file, params_file,
                                           in_name, in_shape)
    n_req = args.clients * args.requests
    doc = {"device": str(server.predictor._ctx), "requests": n_req,
           "clients": args.clients, "batch_sizes": batch_sizes,
           "buckets": server.buckets, "wall_s": wall,
           "req_per_s": n_req / max(wall, 1e-9), "metrics": snap,
           "cache": stats, "errors": errors[:5], "cold_start": cold_start}
    if args.json:
        print(json.dumps(doc))
    else:
        print(f"serve_bench on {doc['device']}: {args.clients} clients x "
              f"{args.requests} req, batch sizes {batch_sizes}, buckets "
              f"{server.buckets}")
        print(f"  wall {wall:.2f}s ({doc['req_per_s']:.1f} req/s "
              "end-to-end)")
        print("  " + server.metrics.format_snapshot())
        print(f"  executor cache: {stats}")
        if cold_start:
            print(f"  cold start (restarted replica): construct "
                  f"{cold_start['construct_s']:.2f}s, prewarm "
                  f"{cold_start['prewarm']['seconds']:.2f}s "
                  f"({cold_start['prewarm']['bound']} bound / "
                  f"{cold_start['prewarm']['compiled']} built, source "
                  f"{cold_start['prewarm']['source']}), first response "
                  f"{cold_start['ttfr_s'] * 1e3:.1f} ms building "
                  f"{cold_start['compiles_at_first_request']} programs")
    if errors:
        print(f"FAILED: {len(errors)} request errors; first: {errors[0]}",
              file=sys.stderr)
        return 1
    if stats["binds"] > len(server.buckets):
        print(f"FAILED: {stats['binds']} binds > {len(server.buckets)} "
              "buckets: bucket amortization broken", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
