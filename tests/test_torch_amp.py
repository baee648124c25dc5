"""Mixed precision in the port: ``Executor(amp_dtype="bfloat16")`` against
the JAX package's ``Executor(..., amp_dtype="bfloat16")`` on the transformer
LM, the argument cast's rules, the LM ops' output dtypes under bf16, and the
16-bit flash attention (the plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode. Inputs are made with numpy; token
ids are int32, as the reference's bench feeds them under amp (float32 ids
would round in bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import ops as jops
from mxnet_tpu.executor import Executor as JExecutor
from mxnet_tpu.ops.flash_attention import flash_attention as jax_flash
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch.executor import _amp_cast
from mxnet_tpu_torch.ndarray import _dtype_name
from mxnet_tpu_torch.ops import flash_attention as tfa

VOCAB, LAYERS, HIDDEN, HEADS, SEQ, BATCH = 512, 2, 64, 4, 32, 2
SHAPES = {"data": (BATCH, SEQ), "softmax_label": (BATCH, SEQ)}
# the reference's own bf16 tolerance (tests/test_amp.py,
# test_amp_bf16_tracks_fp32), for single ops with O(1) outputs
RTOL, ATOL = 2e-2, 2e-2
# Whole-LM limits on |log p| differences (p about 1/512, log p spread about
# 1), as (mean, max). On the CPU, seeds 0 and 2, the port's bf16 run reads
# mean 6.8e-3-7.1e-3, max 4.1e-2-4.3e-2 from the reference's bf16 run:
# the same gap as either package's bf16 run from its own fp32 run (mean
# 6.4e-3-7.7e-3, max 3.7e-2-4.8e-2), since XLA on the CPU computes bf16
# elementwise ops in fp32 and skips some of the roundings the port makes.
# ``PYTHONPATH=. python tests/test_torch_amp.py`` prints these readings. The
# limits are about twice them; fp16 (3 more mantissa bits)
# read mean 8.4e-4-9.4e-4, max 5.4e-3-6.0e-3 from fp32.
LOGP_LIMITS = {"bfloat16": (1.5e-2, 1e-1), "float16": (2e-3, 1.5e-2),
               None: (1e-5, 1e-4)}   # fp32 against fp32 reads max 2.9e-6
ARGMAX_FLOOR = 0.95                  # 62 of 64 rows; the readings 63-64


def _lm(pkg, hidden=HIDDEN, heads=HEADS):
    return pkg.models.transformer_lm.get_symbol(
        vocab_size=VOCAB, num_layers=LAYERS, hidden=hidden, heads=heads,
        seq_len=SEQ)


def _weights(symbol, seed=0):
    rng = np.random.default_rng(seed)
    arg_shapes, _, _ = symbol.infer_shape(**SHAPES)
    out = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in SHAPES:
            continue
        scale = 1.0 / np.sqrt(shape[-1]) if len(shape) == 2 else 0.1
        out[name] = (rng.standard_normal(shape) * scale).astype(np.float32)
        if name.endswith("_gamma"):
            out[name] += 1.0
    return out


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (BATCH, SEQ)).astype(np.int32)


def _port_probs(weights, tokens, amp_dtype, **width):
    """The port's Executor on the LM, and each op's output dtypes in its
    graph walk: under amp every op computes in the amp dtype, except the
    fp32 softmax and the reshape of the fp32 label."""
    import mxnet_tpu_torch.executor as texe

    seen = {}
    get_op = texe.get_op

    class _Spy:
        def __init__(self, name):
            self.name, self.op = name, get_op(name)

        def normalized_call(self, *a):
            outs, aux = self.op.normalized_call(*a)
            seen.setdefault(self.name, set()).update(
                _dtype_name(o.dtype) for o in outs)
            return outs, aux

    symbol = _lm(mxt, **width)
    args, _ = mxt.convert.params_from_numpy(weights, {}, mxt.cpu())
    args["data"] = mxt.nd.array(tokens, mxt.cpu(), dtype=np.int32)
    args["softmax_label"] = mxt.nd.zeros(SHAPES["softmax_label"], mxt.cpu())
    exe = mxt.executor.Executor(symbol, mxt.cpu(), args, amp_dtype=amp_dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(texe, "get_op", _Spy)
        (out,) = exe.forward()
    # the bound fp32 arrays stay fp32 master copies under amp
    assert all(exe.arg_dict[n].dtype == torch.float32 for n in weights)
    assert exe.arg_dict["data"].dtype == torch.int32
    compute = amp_dtype or "float32"
    want = {op: {compute} for op in seen}
    want.update(SoftmaxOutput={"float32"}, Reshape={compute, "float32"})
    assert seen == want
    assert out.dtype == torch.float32
    return out.asnumpy()


def _jax_probs(weights, tokens, amp_dtype, **width):
    args = {n: mxj.nd.array(w) for n, w in weights.items()}
    args["data"] = mxj.nd.array(tokens, dtype=np.int32)
    args["softmax_label"] = mxj.nd.zeros(SHAPES["softmax_label"])
    return JExecutor(_lm(mxj, **width), mxj.cpu(), args,
                     amp_dtype=amp_dtype).forward()[0].asnumpy()


def _logp_gap(got, want):
    """(mean, max) of |log got - log want|, and the share of rows whose
    argmax agrees."""
    err = np.abs(np.log(got) - np.log(want))
    return err.mean(), err.max(), (got.argmax(1) == want.argmax(1)).mean()


def _assert_logp_close(got, want, dtype):
    mean_lim, max_lim = LOGP_LIMITS[dtype]
    mean, top, agree = _logp_gap(got, want)
    assert mean <= mean_lim and top <= max_lim, (mean, top)
    assert agree >= ARGMAX_FLOOR


def test_amp_executor_matches_jax_executor(monkeypatch):
    """The LM under bf16 amp, same weights and int32 ids, through both
    packages' Executors: every op of the port's walk in bf16 but the fp32
    softmax, and log-probabilities within twice the measured bf16 gap."""
    monkeypatch.delenv("MXTPU_FLASH_ATTENTION", raising=False)
    weights, tokens = _weights(_lm(mxt)), _tokens()
    want = _jax_probs(weights, tokens, "bfloat16")
    got = _port_probs(weights, tokens, "bfloat16")
    assert got.shape == want.shape == (BATCH * SEQ, VOCAB)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    _assert_logp_close(got, want, "bfloat16")


# 2 heads of 128 (hidden 256): the head width of most public decoder LMs,
# which the port's 16-bit kernel runs at its width 128 on the card
D128 = dict(hidden=256, heads=2)


def test_amp_executor_matches_jax_executor_at_head_dim_128(monkeypatch):
    """As test_amp_executor_matches_jax_executor, with the LM in 2 heads
    of 128, at the same limits."""
    monkeypatch.delenv("MXTPU_FLASH_ATTENTION", raising=False)
    weights, tokens = _weights(_lm(mxt, **D128)), _tokens()
    want = _jax_probs(weights, tokens, "bfloat16", **D128)
    got = _port_probs(weights, tokens, "bfloat16", **D128)
    assert got.shape == want.shape == (BATCH * SEQ, VOCAB)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    _assert_logp_close(got, want, "bfloat16")


# 2 heads of 512 (hidden 1024): the width of the LM that the port's 16-bit
# cluster kernel serves on the card (flash_fwd_tc_cluster)
D512 = dict(hidden=1024, heads=2)


def test_amp_executor_matches_jax_executor_at_head_dim_512(monkeypatch):
    """As test_amp_executor_matches_jax_executor, with the LM at hidden 1024
    in 2 heads of 512, at the same limits."""
    monkeypatch.delenv("MXTPU_FLASH_ATTENTION", raising=False)
    weights, tokens = _weights(_lm(mxt, **D512)), _tokens()
    want = _jax_probs(weights, tokens, "bfloat16", **D512)
    got = _port_probs(weights, tokens, "bfloat16", **D512)
    assert got.shape == want.shape == (BATCH * SEQ, VOCAB)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    _assert_logp_close(got, want, "bfloat16")


def _tracks_fp32(amp, **width):
    weights, tokens = _weights(_lm(mxt, **width), seed=2), _tokens(seed=3)
    full = _port_probs(weights, tokens, None, **width)
    _assert_logp_close(full, _jax_probs(weights, tokens, None, **width),
                       None)
    half = _port_probs(weights, tokens, amp, **width)
    _assert_logp_close(half, full, amp)


@pytest.mark.parametrize("amp", ["bfloat16", "float16"])
def test_amp_tracks_fp32(amp):
    """The port's 16-bit run stays within its type's measured gap of its
    fp32 run (the reference's check_consistency-across-dtypes pattern),
    and that fp32 run within 1e-4 of the reference's fp32 Executor."""
    _tracks_fp32(amp)


@pytest.mark.parametrize("amp", ["bfloat16", "float16"])
def test_amp_tracks_fp32_at_head_dim_128(amp):
    """As test_amp_tracks_fp32, with the LM in 2 heads of 128, at the same
    limits."""
    _tracks_fp32(amp, **D128)


# a feed through Executor.forward(data=...) into a float32-bound ``data``,
# with ids past 256 (bf16 holds integers exactly only up to 256)
FEED_LM = dict(vocab_size=2048, num_layers=1, hidden=64, heads=4,
               seq_len=16)
FEED_SHAPES = {"data": (2, 16), "softmax_label": (2, 16)}
# Its 32 rows over 2048 classes hold near-ties: the reference's own bf16 run
# picks another argmax than its fp32 run on 2 of 32 rows, and the port's
# bf16 run agrees with the reference's on 30 of 32 (ids of seed 5), within
# LOGP_LIMITS. A copy of these ids into the float32 binding rounds them in
# bf16: 16 rows read id 2048, past the table (NaN), and the other 16 are
# 0.76 off in mean log-probability, argmax agreeing on none. The floor is
# 29 of 32.
FEED_ARGMAX_FLOOR = 0.9


def _feed_executors(amp_dtype):
    """The port's and the JAX package's Executor on a 1-layer LM with the
    same weights, ``data`` bound as float32 zeros in both, as
    ``nd.zeros`` and ``Predictor`` bind it."""
    symbol = mxt.models.transformer_lm.get_symbol(**FEED_LM)
    rng = np.random.default_rng(4)
    arg_shapes, _, _ = symbol.infer_shape(**FEED_SHAPES)
    weights = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name not in FEED_SHAPES:
            scale = 1.0 / np.sqrt(shape[-1]) if len(shape) == 2 else 0.1
            weights[name] = (rng.standard_normal(shape) * scale).astype(
                np.float32) + (1.0 if name.endswith("_gamma") else 0.0)
    args, _ = mxt.convert.params_from_numpy(weights, {}, mxt.cpu())
    jargs = {n: mxj.nd.array(w) for n, w in weights.items()}
    for n, shape in FEED_SHAPES.items():
        args[n] = mxt.nd.zeros(shape, mxt.cpu())
        jargs[n] = mxj.nd.zeros(shape)
    port = mxt.executor.Executor(symbol, mxt.cpu(), args,
                                 amp_dtype=amp_dtype)
    ref = JExecutor(mxj.models.transformer_lm.get_symbol(**FEED_LM),
                    mxj.cpu(), jargs, amp_dtype=amp_dtype)
    return port, ref


@pytest.mark.parametrize("as_ndarray", [False, True])
def test_amp_feed_keeps_int32_ids(monkeypatch, as_ndarray):
    """int32 ids in [1500, 2048) fed into a float32-bound ``data`` under
    bf16 amp: the port rebinds ``data`` to the fed int32 array, as the
    reference does, so the ids pass the amp cast unrounded, and the
    log-probabilities meet the bf16 limits against the reference. (A copy
    into the bound float32 buffer would round them in bf16.)"""
    monkeypatch.delenv("MXTPU_FLASH_ATTENTION", raising=False)
    port, ref = _feed_executors("bfloat16")
    ids = np.random.default_rng(5).integers(
        1500, 2048, FEED_SHAPES["data"]).astype(np.int32)
    bound = port.arg_dict["data"]
    feed = mxt.nd.array(ids, mxt.cpu(), dtype=np.int32) if as_ndarray \
        else ids
    (got,) = port.forward(data=feed)
    want = ref.forward(data=ids)[0].asnumpy()
    assert port.arg_dict["data"] is bound and bound.dtype == torch.int32
    np.testing.assert_array_equal(bound.asnumpy(), ids)
    assert got.shape == want.shape == (32, 2048)
    mean, top, agree = _logp_gap(got.asnumpy(), want)
    mean_lim, max_lim = LOGP_LIMITS["bfloat16"]
    assert mean <= mean_lim and top <= max_lim, (mean, top)
    assert agree >= FEED_ARGMAX_FLOOR


def test_feed_of_another_shape_rebinds(monkeypatch):
    """Batch-1 ids fed into a batch-2 binding: the output follows the feed,
    (16, V), as in the reference, in place of a broadcast to the binding."""
    monkeypatch.delenv("MXTPU_FLASH_ATTENTION", raising=False)
    port, ref = _feed_executors(None)
    ids = np.random.default_rng(6).integers(0, 2048, (1, 16)).astype(
        np.int32)
    (got,) = port.forward(data=ids)
    want = ref.forward(data=ids)[0].asnumpy()
    assert got.shape == want.shape == (16, 2048)
    assert port.arg_dict["data"].shape == (1, 16)
    _assert_logp_close(got.asnumpy(), want, None)


@pytest.mark.parametrize("name,dtype,amp,want", [
    ("fc1_weight", torch.float32, torch.bfloat16, torch.bfloat16),
    ("softmax_label", torch.float32, torch.bfloat16, torch.float32),
    ("data", torch.int32, torch.bfloat16, torch.int32),
    ("data", torch.uint8, torch.bfloat16, torch.bfloat16),
    ("data", torch.uint8, None, torch.float32),
    ("fc1_weight", torch.float32, None, torch.float32),
    ("fc1_weight", torch.float16, torch.bfloat16, torch.float16),
])
def test_amp_cast_rules(name, dtype, amp, want):
    """The reference's rules, one case each: float32 is cast, a label is
    left alone, int32 passes, uint8 goes to the compute dtype (float32
    without amp), other dtypes pass."""
    v = torch.arange(6).reshape(2, 3).to(dtype)
    got = _amp_cast(name, v, amp)
    assert got.dtype == want
    np.testing.assert_array_equal(got.float().numpy(), v.float().numpy())


def _ids(shape, n):
    return lambda rng: rng.integers(0, n, shape).astype(np.int32)


def _randn(*shape):
    return lambda rng: rng.standard_normal(shape).astype(np.float32)


_W = [_randn(12, 12)] * 4
# the LM's ops, as the amp graph feeds them: int32 ids, bf16 activations and
# weights, an fp32 label
AMP_CASES = [
    ("Embedding", {"input_dim": 10, "output_dim": 4},
     [_ids((2, 5), 10), _randn(10, 4)], ["int32", "bfloat16"]),
    ("LayerNorm", {}, [_randn(2, 5, 8), _randn(8), _randn(8)],
     ["bfloat16"] * 3),
    ("FullyConnected", {"num_hidden": 6},
     [_randn(4, 3, 5), _randn(6, 15), _randn(6)], ["bfloat16"] * 3),
    ("Activation", {"act_type": "relu"}, [_randn(3, 7)], ["bfloat16"]),
    ("SoftmaxOutput", {"use_ignore": True, "ignore_label": -1},
     [_randn(6, 10), _randn(6)], ["bfloat16", "float32"]),
    ("elemwise_add", {}, [_randn(2, 3, 4), _randn(2, 3, 4)],
     ["bfloat16"] * 2),
    ("broadcast_add", {}, [_randn(2, 3, 4), _randn(1, 3, 4)],
     ["bfloat16"] * 2),
    ("expand_dims", {"axis": 0}, [_randn(3, 4)], ["bfloat16"]),
    ("Reshape", {"shape": (-1, 4)}, [_randn(2, 3, 4)], ["bfloat16"]),
    ("Reshape", {"shape": (-1,)}, [_randn(2, 3)], ["float32"]),
    ("RingAttention", {"num_heads": 3, "causal": True},
     [_randn(2, 8, 12)] + _W, ["bfloat16"] * 5),
]


@pytest.mark.parametrize("name,attrs,makers,dtypes", AMP_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(AMP_CASES)])
def test_lm_op_dtype_under_amp_matches_jax_body(name, attrs, makers, dtypes):
    """Each op of the LM gives the reference body's output dtype on the
    dtypes amp feeds it (LayerNorm and attention return the input dtype,
    SoftmaxOutput fp32, Embedding the weight's), and values within bf16
    tolerance of it."""
    rng = np.random.default_rng(0)
    inputs = [m(rng) for m in makers]
    jin = [jnp.asarray(a).astype(getattr(jnp, dt))
           for a, dt in zip(inputs, dtypes)]
    tin = [torch.from_numpy(a).to(getattr(torch, dt))
           for a, dt in zip(inputs, dtypes)]
    want = jops.get_op(name).fn(jops.OpCtx(), dict(attrs), *jin)
    got = tops.get_op(name).fn(tops.OpCtx(), dict(attrs), *tin)
    assert _dtype_name(got.dtype) == str(want.dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float16", 1e-2)])
@pytest.mark.parametrize("causal,q_offset,t_q,t_k", [
    (True, 8, 37, 45), (True, 0, 29, 29), (False, 3, 21, 50)])
def test_16bit_flash_matches_pallas_interpret(dtype, tol, causal, q_offset,
                                              t_q, t_k):
    """fp16 and bf16 attention at a ragged T, causal with q_offset: the
    port's wrapper (its plain version on the CPU) against the JAX kernel in
    interpret mode on the same rounded inputs; output in q's dtype. The
    tolerance is one rounding of an O(1) output to the type (fp16 carries
    3 more mantissa bits than bf16)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, t, 2, 16)).astype(
        np.float32)).to(getattr(torch, dtype)) for t in (t_q, t_k, t_k))
    want = jax_flash(*(jnp.asarray(x.float().numpy()).astype(dtype)
                       for x in (q, k, v)),
                     causal=causal, q_offset=q_offset, interpret=True)
    got = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert str(want.dtype) == dtype and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float16", 1e-2)])
@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("causal,q_offset,t_q,t_k", [
    (True, 8, 37, 45), (False, 3, 21, 50)])
def test_16bit_flash_wide_heads_match_pallas_interpret(dtype, tol, d, causal,
                                                       q_offset, t_q, t_k):
    """As test_16bit_flash_matches_pallas_interpret at head dims 320 and
    512, which the card runs in a cluster of blocks that split d
    (flash_fwd_tc_cluster), at the same limits."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, t, 2, d)).astype(
        np.float32)).to(getattr(torch, dtype)) for t in (t_q, t_k, t_k))
    assert tfa.launch_plan(q.dtype, 1, t_q, 2, d)[0] == "flash_fwd_tc_cluster"
    want = jax_flash(*(jnp.asarray(x.float().numpy()).astype(dtype)
                       for x in (q, k, v)),
                     causal=causal, q_offset=q_offset, interpret=True)
    got = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert str(want.dtype) == dtype and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("d,offset,want", [
    (64, 0, 16), (48, 0, 16), (128, 0, 16), (16, 0, 16), (8, 0, 16),
    (50, 0, 2), (36, 0, 2), (4, 0, 2), (64, 1, 2), (64, 4, 2), (64, 8, 16),
    (32, 3, 2)])
def test_copy_bytes_rule_16bit(d, offset, want):
    """For 2-byte types the tensor-core kernel copies 16 bytes at a time
    only when every row of every tensor starts 16-byte aligned: d % 8 == 0
    and aligned bases. A contiguous view at an offset of one to seven
    elements, or any other d, takes the element-wise path (2)."""
    buf = torch.zeros(2 * 5 * 3 * d + offset, dtype=torch.bfloat16)
    x = buf[offset:].view(2, 5, 3, d)
    assert x.is_contiguous()
    aligned = torch.zeros((2, 5, 3, d), dtype=torch.float16)
    assert tfa.copy_bytes(d, x.data_ptr(), aligned.data_ptr(),
                          itemsize=2) == want
    assert tfa.copy_bytes(d, aligned.data_ptr(), itemsize=2) == \
        (16 if d % 8 == 0 else 2)


def test_cpu_16bit_flash_does_not_count_launches():
    """Only CUDA launches count, in the total and by dtype."""
    tfa.reset_launches()
    q = torch.zeros((1, 8, 2, 16), dtype=torch.float16)
    tfa.flash_attention(q, q, q, causal=True)
    assert tfa.flash_attention.launches == 0
    assert tfa.flash_attention.launches_by_dtype == {
        "float32": 0, "bfloat16": 0, "float16": 0}


if __name__ == "__main__":
    # the readings LOGP_LIMITS was set from: (mean, max, argmax share), in
    # 4 heads of 16 and in 2 heads of 128
    for width, (w_seed, t_seed) in ((w, s) for w in ({}, D128)
                                    for s in ((0, 1), (2, 3))):
        weights = _weights(_lm(mxt, **width), seed=w_seed)
        tokens = _tokens(seed=t_seed)
        port = {a: _port_probs(weights, tokens, a, **width)
                for a in (None, "bfloat16", "float16")}
        ref = {a: _jax_probs(weights, tokens, a, **width)
               for a in (None, "bfloat16")}
        for name, got, want in (
                ("port bf16 vs jax bf16", port["bfloat16"], ref["bfloat16"]),
                ("port bf16 vs port fp32", port["bfloat16"], port[None]),
                ("jax bf16 vs jax fp32", ref["bfloat16"], ref[None]),
                ("port fp16 vs port fp32", port["float16"], port[None]),
                ("port fp32 vs jax fp32", port[None], ref[None])):
            print(f"{width or 'heads 4 of 16'} seed {w_seed}: {name}: "
                  + " ".join(f"{x:.3g}" for x in _logp_gap(got, want)))
