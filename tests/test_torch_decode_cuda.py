"""LM decode on the card: the one-token step replayed from one captured
graph, the GenerationSession's captured steps, and GenerateScan, each
against the same work run eagerly (or on the CPU). This file imports no
JAX, so it runs on a machine with only PyTorch:

    python -m pytest -m gpu --noconftest tests/test_torch_decode_cuda.py

fp32 with TF32 off, a small LM (vocab 64, hidden 64, 2 layers); token
streams equal, probabilities within 1e-6. Without a CUDA device each test
skips."""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import transformer_lm
from mxnet_tpu_torch.module.step_graph import ForwardProgram
from mxnet_tpu_torch.ops import generate_scan

pytestmark = pytest.mark.gpu
V, L, H, HEADS, T, B = 64, 2, 64, 4, 96, 4
TRACE = [([1, 2, 3, 4, 5, 6], 9), ([7, 8], 14), ([9, 10, 11], 5),
         ([12, 13, 14, 15, 16, 17, 18, 19, 20], 7), ([2, 4], 11),
         ([5, 6, 7, 8, 9, 10, 11, 12], 6)]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _weights(seed=0):
    dsym, names = transformer_lm.get_batch_decode_symbol(
        vocab_size=V, num_layers=L, hidden=H, heads=HEADS, max_len=T)
    shapes = {"data": (1, 1), "pos": (1,)}
    shapes.update({n: (1, T, H) for n in names})
    arg_shapes, _, _ = dsym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.2).astype(np.float32)
            for n, s in zip(dsym.list_arguments(), arg_shapes)
            if n not in shapes}


def _decode(captured, tokens=64):
    """``tokens`` one-token steps of the decode graph on the card: (probs
    of every step, the program's counters, cache outputs that were not the
    bound arrays)."""
    weights = _weights()
    dsym, names = transformer_lm.get_decode_symbol(
        vocab_size=V, num_layers=L, hidden=H, heads=HEADS, max_len=T)
    shapes = {"data": (B, 1), "pos": (1,)}
    shapes.update({n: (B, T, H) for n in names})
    ex = dsym.simple_bind(mx.gpu(0), grad_req="null", **shapes)
    for n, a in ex.arg_dict.items():
        if n in weights:
            a.data.copy_(torch.from_numpy(weights[n]))
    ex._eval_program = ForwardProgram(ex)
    ex._eval_program.capturable = captured
    tok = np.arange(B, dtype=np.float32).reshape(B, 1)
    probs, copies = [], 0
    for t in range(tokens):
        outs = ex.forward(is_train=False, data=tok,
                          pos=np.array([t], np.float32))
        for n, o in zip(names, outs[1:]):
            copies += o.data is not ex.arg_dict[n].data
            ex.arg_dict[n].alias(o)
        p = outs[0].asnumpy()
        probs.append(p)
        tok = p.argmax(axis=1).astype(np.float32).reshape(B, 1)
    return np.stack(probs), ex.forward_info(), copies


def test_decode_step_replays_one_graph_for_every_token():
    got, info, copies = _decode(True)
    want, einfo, _ = _decode(False)
    assert info["captured"] and info["captures"] == 1
    assert info["warmups"] == 1 and info["replays"] == 63
    assert info["drops"] == 0 and copies == 0
    assert einfo["eager_runs"] == 64 and not einfo["captured"]
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _session(ctx, eager=False, **kw):
    sess = mx.GenerationSession(_weights(), vocab_size=V, num_layers=L,
                                hidden=H, heads=HEADS, max_len=T, ctx=ctx,
                                chunk_cost_cap=False, **kw)
    if eager:
        lanes = [sess._target] + ([sess._draft] if sess._draft else [])
        for lane in lanes:
            for ex in lane.executors().values():
                ex._eval_program = ForwardProgram(ex)
                ex._eval_program.capturable = False
    return sess


def _trace(sess, trace=TRACE):
    futs = [sess.generate(p, g) for p, g in trace]
    out = [f.result(timeout=300) for f in futs]
    return out


@pytest.mark.parametrize("kw", [
    dict(slots=3, prefill_chunk=4),
    dict(slots=3, prefill_chunk=4, kv_paged=True, kv_block=8,
         prefix_cache=16 << 20),
    dict(slots=2, prefill_chunk=3, spec_k=4, prefix_cache=16 << 20),
], ids=["chunked", "paged_prefix", "speculative"])
def test_session_captured_steps_give_the_eager_tokens(kw):
    if "spec_k" in kw:
        kw = dict(kw, draft_params=_weights(1))
    outs = {}
    for eager in (False, True):
        sess = _session(mx.gpu(0), eager, **kw)
        outs[eager] = _trace(sess) + _trace(sess)   # the second: warm
        progs = sess.programs()
        sess.close()
        for name, p in progs.items():
            assert p["drops"] == 0, name
            assert p["captured"] != eager, name
    cpu = _session(mx.cpu(), **kw)
    on_cpu = _trace(cpu) + _trace(cpu)
    cpu.close()
    for a, b, c in zip(outs[False], outs[True], on_cpu):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_warmup_then_four_concurrent_callers():
    sess = _session(mx.gpu(0), slots=4, prefill_chunk=4, spec_k=3,
                    draft_params=_weights(1))
    sess.warmup()
    progs = sess.programs()
    assert all(p["captured"] for p in progs.values()), progs
    results = {}

    def call(i):
        results[i] = _trace(sess, TRACE[i:i + 3])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    after = sess.programs()
    sess.close()
    assert all(after[n]["captures"] == progs[n]["captures"]
               and after[n]["drops"] == 0 for n in after), after
    cpu = _session(mx.cpu(), slots=1)
    for i in range(4):
        want = _trace(cpu, TRACE[i:i + 3])
        for a, b in zip(results[i], want):
            np.testing.assert_array_equal(a, b)
    cpu.close()


def test_generate_scan_on_the_card_equals_the_cpu():
    from mxnet_tpu_torch.convert import stack_lm_params
    from mxnet_tpu_torch.ops.generate_scan import _INPUTS

    st = stack_lm_params(_weights(), L)
    prime = np.random.RandomState(5).randint(0, V, (B, 4))
    toks = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        ins = [mx.nd.array(np.asarray(st[n], np.float32), ctx)
               for n in _INPUTS[1:]]
        before = dict(generate_scan.stats)
        for _ in range(2):       # the second call replays the kept graph
            toks[ctx.device_type] = mx.nd.GenerateScan(
                mx.nd.array(prime, ctx), *ins, num_layers=L,
                num_heads=HEADS, gen_len=T - 4).asnumpy()
        if ctx.device_type == "gpu":
            assert generate_scan.stats["captures"] - before["captures"] == 1
            assert generate_scan.stats["replays"] - before["replays"] == \
                2 * (T - 1)
    np.testing.assert_array_equal(toks["gpu"], toks["cpu"])
