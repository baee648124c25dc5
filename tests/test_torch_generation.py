"""The port's GenerationSession on the CPU (counterparts of
tests/test_generation_decode.py and the session half of
tests/test_kvpool.py): continuous batching token-identical to each request
decoded alone and to FIFO mode; chunked prefill, prefix reuse (after a page
to the host tier too), speculative decoding and paged KV token-identical to
the dense continuous session; the chunk cap's math against the reference's;
typed errors and sheds; the env knobs; and one 12-request trace through the
JAX package's session and the port's on the same weights, every token
stream equal."""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import costmodel as jcostmodel
from mxnet_tpu.models import transformer_lm as jlm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import (GenerationSession, KVPoolExhausted,
                                     PrefixKVCache, costs)
from mxnet_tpu_torch.serving import kvpool as kvpool_mod

V, L, H, HEADS, T = 19, 2, 16, 4, 28
DRAFT_CFG = {"num_layers": 1, "hidden": 8, "heads": 2}
TRACE = [([1, 2, 3, 4, 5, 6], 4), ([7, 8], 7), ([9, 10, 11], 2),
         ([12, 13, 14, 15, 16, 17], 6), ([2, 4], 3)]


def _decode_params(num_layers=L, hidden=H, heads=HEADS, seed=3):
    dsym, cache_names = tlm.get_batch_decode_symbol(
        vocab_size=V, num_layers=num_layers, hidden=hidden, heads=heads,
        max_len=T)
    shapes = {"data": (1, 1), "pos": (1,)}
    shapes.update({n: (1, T, hidden) for n in cache_names})
    arg_shapes, _, _ = dsym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {name: (rng.randn(*s) * 0.1).astype(np.float32)
            for name, s in zip(dsym.list_arguments(), arg_shapes)
            if name not in shapes}


@pytest.fixture(scope="module")
def params():
    return _decode_params()


@pytest.fixture(scope="module")
def draft_params():
    """A smaller, disagreeing draft: correctness holds at any
    acceptance."""
    return _decode_params(seed=7, **DRAFT_CFG)


def _session(params, **kw):
    kw.setdefault("vocab_size", V)
    kw.setdefault("num_layers", L)
    kw.setdefault("hidden", H)
    kw.setdefault("heads", HEADS)
    kw.setdefault("max_len", T)
    kw.setdefault("chunk_cost_cap", False)
    kw.setdefault("ctx", mxt.cpu())
    return GenerationSession(params, **kw)


def _run_trace(sess, trace):
    futs = [sess.generate(p, g) for p, g in trace]
    return [f.result(timeout=120) for f in futs]


def _trace_of(params, trace=TRACE, **kw):
    sess = _session(params, **kw)
    try:
        return _run_trace(sess, trace), sess.stats()
    finally:
        sess.close()


@pytest.fixture(scope="module")
def dense(params):
    """The dense continuous session's streams of TRACE (2 slots)."""
    return _trace_of(params, slots=2)[0]


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- continuous batching ----------------------------------------------------------
def test_continuous_equals_each_request_alone_and_fifo(params, dense):
    alone = [_trace_of(params, [r], slots=1)[0][0] for r in TRACE]
    _same(dense, alone)
    fifo, st = _trace_of(params, slots=2, continuous=False)
    _same(fifo, dense)
    assert not st["continuous"]


def test_ctx_defaults_to_the_card(params):
    """Without ``ctx`` the session binds on gpu(0): here, with no card,
    binding fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception):
        GenerationSession(params, vocab_size=V, num_layers=L, hidden=H,
                          heads=HEADS, max_len=T)


def test_scheduler_is_not_ported(params):
    with pytest.raises(MXNetError, match="not ported"):
        _session(params, scheduler=object())


# -- chunked prefill --------------------------------------------------------------
@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 5, 6])
def test_chunked_prefill_token_identical_every_chunk(params, dense, chunk):
    outs, st = _trace_of(params, slots=2, prefill_chunk=chunk)
    _same(outs, dense)
    if chunk > 1:
        assert st["chunk_steps"] > 0


def test_chunked_prefill_fewer_steps_and_d2h_skip(params):
    """ceil(P/K) prefill steps, and the probabilities come to the host only
    on steps that sample."""
    st = _trace_of(params, [(list(range(9)), 2)], slots=1,
                   prefill_chunk=4)[1]
    # 9-token prime, chunk 4: [4, 4] prefill only, [1] and a sample, a sample
    assert st["steps"] == 4
    assert st["prefill_steps"] == 3
    assert st["decode_steps"] == 2
    assert st["d2h_syncs"] == 2
    bst = _trace_of(params, [(list(range(9)), 2)], slots=1)[1]
    assert bst["steps"] == 10
    assert bst["d2h_syncs"] == 2


def test_chunked_prefill_kv_close_to_the_one_token_path(params):
    """The KV rows a chunked prefill leaves (read through the prefix
    cache) against the one-token path's, within 1e-6 in every layer: the
    chunk's projections are one GEMM over K rows a slot, whose sums the
    CPU orders otherwise than K one-row GEMMs', from layer 0 on."""
    prime = [3, 1, 4, 1, 5, 9, 2, 6]
    entries = []
    for chunk in (1, 4):
        pc = PrefixKVCache(1 << 20)
        sess = _session(params, slots=1, prefill_chunk=chunk,
                        prefix_cache=pc)
        sess.generate(prime, 2).result(timeout=120)
        sess.close()
        ln, arrays = pc.lookup(prime, max_length=len(prime) - 1)
        assert ln == len(prime) - 1
        entries.append({n: np.asarray(a)[:ln] for n, a in arrays.items()})
    for n in entries[0]:
        np.testing.assert_allclose(entries[0][n], entries[1][n], rtol=0,
                                   atol=1e-6, err_msg=n)


CAP_CASES = [(8, 100.0, 450.0), (8, 10.0, 220.0), (8, 0.0, 500.0),
             (8, 100.0, 90.0), (1, 10.0, 500.0), (64, 3.75e9, 2.4e11),
             (16, 1.0, 1e9), (5, 7.0, 56.0), (5, 7.0, 56.1)]


@pytest.mark.parametrize("case", CAP_CASES)
def test_prefill_chunk_cap_math_is_the_reference(case):
    assert costs.prefill_chunk_cap(*case) == \
        jcostmodel.prefill_chunk_cap(*case)
    assert costs.prefill_chunk_cap(8, 10.0, 1e4, stall_factor=2.0) == \
        jcostmodel.prefill_chunk_cap(8, 10.0, 1e4, stall_factor=2.0) == 1


def test_operation_counts_of_the_bound_programs(params):
    """The cap's probes: the GEMMs and the attention products at the bound
    shapes, by hand; the chunk's count is linear in K."""
    sess = _session(params, slots=2, prefill_chunk=4)
    ex1, exk = sess._target._ex1, sess._target._exk
    sess.close()
    rows = 2

    def by_hand(k):
        per_layer = (8 * rows * k * H * H + 4 * rows * k * T * H
                     + 2 * rows * k * H * 4 * H * 2)
        return L * per_layer + 2 * rows * k * H * V

    assert costs.forward_flops(ex1) == by_hand(1)
    assert costs.forward_flops(exk) == by_hand(4)


def test_cost_cap_bounds_the_effective_chunk(params):
    sess = _session(params, slots=1, prefill_chunk=16, chunk_cost_cap=True)
    st = sess.stats()
    c1 = costs.forward_flops(sess._target._ex1)
    sess.close()
    assert st["chunk_requested"] == 16
    assert 1 <= st["chunk"] <= 16
    probe = _session(params, slots=1, prefill_chunk=16)
    ck = costs.forward_flops(probe._target._exk)
    probe.close()
    assert st["chunk"] == jcostmodel.prefill_chunk_cap(16, c1, ck)


# -- prefix reuse -----------------------------------------------------------------
def test_prefix_hit_bit_identical_after_page_out(params):
    prime = [2, 7, 1, 8, 2, 8, 1, 8]
    sess = _session(params, slots=2, prefill_chunk=4, prefix_cache=4 << 20)
    cold = sess.generate(prime, 5).result(timeout=120)
    st_cold = sess.stats()
    ln, dev = sess._prefix.lookup(prime, max_length=len(prime) - 1)
    dev_rows = {n: np.asarray(a)[:ln].copy() for n, a in dev.items()}
    assert sess._prefix.page_out_all() >= 1
    ln2, host = sess._prefix.lookup(prime, max_length=len(prime) - 1)
    assert ln2 == ln
    for n in dev_rows:
        assert isinstance(host[n], np.ndarray)
        assert np.array_equal(dev_rows[n], host[n][:ln])
    warm = sess.generate(prime, 5).result(timeout=120)
    st = sess.stats()
    sess.close()
    np.testing.assert_array_equal(cold, warm)
    assert st["prefix_cache"]["hits"] >= 3
    assert st["prefix_cache"]["page_outs"] >= 1
    assert st["prefill_tokens"] - st_cold["prefill_tokens"] == 1


def test_prefix_longest_common_prefix_and_multi_turn(params):
    sess = _session(params, slots=1, prefill_chunk=4, prefix_cache=4 << 20)
    turn1 = sess.generate([5, 6, 7, 8], 4).result(timeout=120)
    cont = list(turn1) + [9, 10]
    out = sess.generate(cont, 3).result(timeout=120)
    st = sess.stats()
    sess.close()
    expect = _trace_of(params, [(cont, 3)], slots=1, prefill_chunk=4)[0][0]
    np.testing.assert_array_equal(out, expect)
    assert st["prefix_cache"]["tokens_reused"] >= 7


def test_prefix_cache_lru_eviction_and_budget():
    pc = PrefixKVCache(max_bytes=4 * 10 * 4, device_bytes=80)   # 2 entries
    for i in range(6):
        assert pc.put([i, i + 1], {"c": torch.zeros((2, 10))})  # 80 B each
    st = pc.stats()
    assert st["entries"] == 2 and st["evictions"] == 4
    assert st["bytes"] <= pc.max_bytes
    assert st["device_bytes"] <= 80 and st["page_outs"] >= 1
    assert not pc.put([1], {"c": torch.zeros((99, 10))})        # too big
    assert pc.lookup([0, 1])[0] == 0
    assert pc.lookup([5, 6, 3])[0] == 2


def test_prefix_cache_disabled_paths(params):
    pc = PrefixKVCache(0)
    assert not pc.put([1, 2], {"c": np.zeros((2, 4), np.float32)})
    assert pc.lookup([1, 2]) == (0, None)
    assert _trace_of(params, TRACE[:1], slots=1)[1]["prefix_cache"] is None


def test_finished_sequence_leaves_its_dense_slot_zeroed(params):
    sess = _session(params, slots=1)
    sess.generate([1, 2, 3, 4, 5], 4).result(timeout=120)
    lane = sess._target
    out = None
    for _ in range(50):
        if all(not c.asnumpy()[0].any() for c in lane.caches.values()):
            out = sess.generate([7, 8], 5).result(timeout=120)
            break
        threading.Event().wait(0.05)
    sess.close()
    assert out is not None, "a finished sequence left its KV in the slot"
    want = _trace_of(params, [([7, 8], 5)], slots=1)[0][0]
    np.testing.assert_array_equal(out, want)


# -- speculative decoding ------------------------------------------------------------
def test_speculative_greedy_identical_mixed_trace(params, draft_params,
                                                  dense):
    outs, st = _trace_of(params, slots=2, prefill_chunk=3,
                         draft_params=draft_params, draft_config=DRAFT_CFG,
                         spec_k=4)
    _same(outs, dense)
    assert st["spec"]["rounds"] > 0
    assert st["spec"]["proposed"] >= st["spec"]["accepted"] >= 0


def test_speculative_full_acceptance_with_identical_draft(params):
    outs, st = _trace_of(params, [([1, 2], 9)], slots=1,
                         draft_params=params, spec_k=3)
    assert outs[0].shape[0] == 11
    assert st["spec"]["acceptance"] == 1.0
    assert st["spec"]["rounds"] >= 2
    np.testing.assert_array_equal(
        outs[0], _trace_of(params, [([1, 2], 9)], slots=1)[0][0])


def test_spec_k_validation(params):
    with pytest.raises(MXNetError, match="spec_k"):
        _session(params, draft_params=params, spec_k=1)


# -- paged KV --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [1, 3, 6])
def test_paged_token_identical_to_dense_across_chunks(params, dense, chunk):
    outs, st = _trace_of(params, slots=2, prefill_chunk=chunk,
                         kv_paged=True, kv_block=4)
    _same(outs, dense)
    assert st["paged"] and st["kv_block"] == 4


@pytest.mark.parametrize("kv_block", [1, 3, T])
def test_paged_token_identical_at_block_sizes(params, dense, kv_block):
    _same(_trace_of(params, slots=2, prefill_chunk=3, kv_paged=True,
                    kv_block=kv_block)[0], dense)


def _recorded_probs(params, **kw):
    """The probabilities of every fed row and column the target lane
    returns over TRACE (idle rows' are garbage in both layouts)."""
    sess = _session(params, slots=2, prefill_chunk=3, **kw)
    step0, seen = sess._target.step, []

    def step(feeds, want_probs):
        p = step0(feeds, want_probs)
        if p is not None:
            seen.append((p.shape, [p[i, :len(t)].copy()
                                   for i, t, _s in feeds]))
        return p

    sess._target.step = step
    _run_trace(sess, TRACE)
    sess.close()
    return seen


def test_paged_runs_the_dense_shapes_bit_for_bit(params):
    """The paged lane feeds one-token steps through its one-token program,
    as the dense lane does, so every probability array is the dense one's
    bit for bit (the reference's paged lane runs every step at the
    chunk)."""
    dense = _recorded_probs(params)
    paged = _recorded_probs(params, kv_paged=True, kv_block=4)
    assert len(paged) == len(dense)
    for (sa, ra), (sb, rb) in zip(paged, dense):
        assert sa == sb and len(ra) == len(rb)
        assert all(np.array_equal(a, b) for a, b in zip(ra, rb))


def test_paged_speculative_identical_to_dense_greedy(params, draft_params,
                                                     dense):
    _same(_trace_of(params, slots=2, draft_params=draft_params,
                    draft_config=DRAFT_CFG, spec_k=4, prefill_chunk=3,
                    kv_paged=True, kv_block=4)[0], dense)


def test_warm_prefix_hits_map_blocks_zero_copy(params):
    t1 = list(_trace_of(params, [([1, 2, 3, 4, 5, 6, 7, 8], 4)],
                        prefill_chunk=3)[0][0])
    t2 = _trace_of(params, [(t1 + [9, 10], 4)], prefill_chunk=3)[0][0]
    sess = _session(params, prefill_chunk=3, kv_paged=True, kv_block=4,
                    prefix_cache=1 << 20)
    p1 = list(_run_trace(sess, [([1, 2, 3, 4, 5, 6, 7, 8], 4)])[0])
    p2 = _run_trace(sess, [(p1 + [9, 10], 4)])[0]
    st = sess.stats()
    sess.close()
    assert p1 == t1
    np.testing.assert_array_equal(p2, t2)
    assert st["prefix_cache"]["hits"] >= 1
    assert st["prefix_cache"]["block_shares"] >= 1
    assert st["row_restores"] == 0
    assert st["kv_pool"]["shares"] >= 1


def test_host_tier_restore_is_token_identical(params):
    t1 = list(_trace_of(params, [([1, 2, 3, 4, 5, 6, 7, 8], 4)],
                        prefill_chunk=3)[0][0])
    t2 = _trace_of(params, [(t1 + [9], 4)], prefill_chunk=3)[0][0]
    sess = _session(params, prefill_chunk=3, kv_paged=True, kv_block=4,
                    prefix_cache=1 << 20)
    p1 = list(_run_trace(sess, [([1, 2, 3, 4, 5, 6, 7, 8], 4)])[0])
    sess._prefix.page_out_all()
    assert sess._target.pool.stats()["page_outs"] >= 1
    p2 = _run_trace(sess, [(p1 + [9], 4)])[0]
    st = sess.stats()
    sess.close()
    np.testing.assert_array_equal(p2, t2)
    assert st["prefix_cache"]["block_promotes"] >= 1
    assert st["kv_pool"]["page_ins"] >= 1


def test_pool_exhaustion_sheds_typed_while_residents_complete(params):
    block_nbytes = 4 * 8 * H * 4   # names * block tokens * hidden * fp32
    sess = _session(params, slots=3, kv_paged=True, kv_block=8,
                    kv_pool_mb=7 * block_nbytes / float(1 << 20))
    assert sess._target.pool.capacity() == 7
    futs = [sess.generate([1 + i, 2, 3, 4, 5, 6], 12) for i in range(3)]
    done, shed = [], []
    for f in futs:
        try:
            done.append(f.result(timeout=120))
        except KVPoolExhausted as e:
            shed.append(e)
    st = sess.stats()
    sess.close()
    assert shed and done
    assert st["kv_sheds"] == len(shed)
    assert all(e.needed for e in shed)
    want = _trace_of(params, [([1, 2, 3, 4, 5, 6], 12)], slots=1)[0][0]
    np.testing.assert_array_equal(done[0], want)


def test_undersized_pool_rejected_at_construction(params):
    block_nbytes = 4 * 8 * H * 4
    with pytest.raises(MXNetError, match="cannot hold"):
        _session(params, slots=1, kv_paged=True, kv_block=8,
                 kv_pool_mb=2 * block_nbytes / float(1 << 20))


def test_paged_off_constructs_no_pool(params, monkeypatch):
    def _boom(*a, **kw):
        raise AssertionError("KVBlockPool constructed with paging off")

    monkeypatch.setattr(kvpool_mod, "KVBlockPool", _boom)
    outs, st = _trace_of(params, TRACE[:1], slots=1)
    assert not st["paged"] and len(outs[0]) == 10


# -- scheduling, errors, knobs, observability ------------------------------------------
def test_interleaved_prefill_never_delays_decode_rows(params):
    done_at = []
    sess = _session(params, slots=2, prefill_chunk=4)
    ev = threading.Event()
    fa = sess.generate([1, 2], 6)
    fa.add_done_callback(lambda f: (done_at.append(sess.steps), ev.set()))
    sess.generate(list(range(16)), 2).result(timeout=120)
    ev.wait(timeout=120)
    sess.close()
    assert done_at[0] == 6


def test_generate_validates_the_context_window(params):
    sess = _session(params, slots=1)
    with pytest.raises(MXNetError, match=r"max_len"):
        sess.generate(list(range(T)), 1)
    with pytest.raises(MXNetError, match=r"prime \(20\)"):
        sess.generate(list(range(20)), T)
    with pytest.raises(MXNetError):
        sess.generate([], 3)
    with pytest.raises(MXNetError):
        sess.generate([1], 0)
    out = sess.generate(list(range(T - 1)), 1).result(timeout=120)
    sess.close()
    assert out.shape[0] == T
    with pytest.raises(mxt.serving.ServerClosed):
        sess.generate([1], 1)


def test_mis_shaped_checkpoint_rejected_typed(params):
    bad = dict(params)
    bad["transformer_pos_weight"] = params["transformer_pos_weight"][:T // 2]
    with pytest.raises(MXNetError, match="transformer_pos_weight"):
        _session(bad, slots=1)
    del bad["transformer_pos_weight"]
    with pytest.raises(MXNetError, match="missing"):
        _session(bad, slots=1)


def test_env_knobs(params, monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_PREFILL_CHUNK", "3")
    monkeypatch.setenv("MXNET_SERVING_PREFIX_CACHE_MB", "1")
    monkeypatch.setenv("MXNET_SERVING_DECODE_SLOTS", "3")
    st = _trace_of(params, TRACE[:1])[1]
    assert st["chunk_requested"] == 3 and st["slots"] == 3
    assert st["prefix_cache"]["max_bytes"] == 1 << 20
    monkeypatch.setenv("MXNET_SERVING_SPEC_K", "5")
    st = _trace_of(params, TRACE[:1], slots=1, draft_params=params)[1]
    assert st["spec"]["k"] == 5
    monkeypatch.setenv("MXNET_SERVING_KV_PAGED", "1")
    monkeypatch.setenv("MXNET_SERVING_KV_BLOCK", "7")
    st = _trace_of(params, TRACE[:1], slots=1)[1]
    assert st["paged"] and st["kv_block"] == 7
    with pytest.raises(MXNetError):
        _session(params, kv_paged=True, kv_block=T + 1)
    monkeypatch.setenv("MXNET_SERVING_SPEC_K", "four")
    with pytest.raises(MXNetError, match="not a number"):
        _session(params, draft_params=params)


def test_ttft_and_metrics(params):
    sess = _session(params, slots=1, prefill_chunk=4, prefix_cache=1 << 20)
    sess.generate([1, 2, 3, 4, 5], 3).result(timeout=120)
    sess.generate([1, 2, 3, 4, 5], 3).result(timeout=120)
    st = sess.stats()
    snap = sess.metrics.snapshot()
    sess.close()
    assert st["ttft_p50_ms"] > 0 and len(sess.ttfts()) == 2
    assert snap["ttft_p50_ms"] > 0 and snap["completed"] == 2
    assert snap["prefix"]["hits"] >= 1
    assert snap["prefix"]["tokens_reused"] >= 4
    assert snap["sampled_step_p50_ms"] > 0


def test_deadline_and_drain(params):
    sess = _session(params, slots=1)
    first = sess.generate(list(range(10)), 10)
    late = sess.generate([1, 2], 2, timeout_s=1e-6)
    with pytest.raises(mxt.serving.DeadlineExceeded):
        late.result(timeout=120)
    first.result(timeout=120)
    queued = [sess.generate([1, 2], 20) for _ in range(3)]
    sess.close(drain=False)
    errs = 0
    for f in queued:
        try:
            f.result(timeout=120)
        except mxt.serving.ServerClosed:
            errs += 1
    assert errs >= 1


def test_warmup_without_polluting_the_prefix_cache(params):
    sess = _session(params, slots=2, prefill_chunk=4, prefix_cache=1 << 20,
                    draft_params=params, spec_k=3)
    sess.warmup()
    st = sess.stats()
    assert st["steps"] > 0
    assert st["prefix_cache"]["entries"] == 0
    progs = sess.programs()
    out = sess.generate([1, 2, 3], 2).result(timeout=120)
    sess.close()
    assert set(progs) == {"target.one_token", "target.chunked",
                          "draft.chunked"}
    assert all(p["refusal"] == "the CPU runs the evaluation forward "
               "eagerly" for p in progs.values())
    np.testing.assert_array_equal(
        out, _trace_of(params, [([1, 2, 3], 2)], slots=2)[0][0])


def test_twelve_requests_match_the_reference_session(params):
    """One trace of 12 requests, mixed lengths and a shared prefix, through
    the JAX package's GenerationSession and the port's (chunked prefill,
    4 slots): every token stream equal."""
    rng = np.random.RandomState(11)
    shared = list(rng.randint(0, V, 6))
    trace = []
    for i in range(12):
        head = shared if i % 4 == 0 else []
        prime = head + list(rng.randint(0, V, int(rng.randint(1, 8))))
        trace.append((prime, int(rng.randint(1, T - len(prime)))))
    ref = mxj.serving.GenerationSession(
        params, vocab_size=V, num_layers=L, hidden=H, heads=HEADS,
        max_len=T, slots=4, prefill_chunk=3, chunk_cost_cap=False,
        ctx=mxj.cpu())
    want = _run_trace(ref, trace)
    ref.close()
    got = _trace_of(params, trace, slots=4, prefill_chunk=3)[0]
    _same(got, want)
