"""The decode attention cores and ops against the JAX package on the CPU:
``cached_attention_core``/``DecodeAttention`` (one token at a shared
position), ``batch_cached_attention_core`` (a position per row; chunked
with ``nlen``), ``paged_cached_attention_core`` and ``BatchDecodeAttention``
in its three forms. Each case feeds both packages the same numpy inputs
from a seed, in fp32: outputs within rtol 1e-5, atol 1e-6. The caches are
compared bit for bit on dyadic inputs (multiples of 1/8, whose projections
both packages compute exactly), so a written row must land where the
reference writes it and nothing else may move; the reference returns new
caches, the port writes the given ones in place."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.base import MXNetError as JError
from mxnet_tpu.ops import attention as ja
from mxnet_tpu.ops import get_op as jget_op
from mxnet_tpu.ops.registry import OpCtx as JOpCtx
from mxnet_tpu_torch.base import MXNetError as TError
from mxnet_tpu_torch.ops import attention as ta
from mxnet_tpu_torch.ops import get_op as tget_op
from mxnet_tpu_torch.ops.registry import OpCtx as TOpCtx

B, E, HEADS, T, K = 3, 16, 4, 12, 4
RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed, k=K, dyadic=False):
    """hn (B, k, E), the four (E, E) weights and two (B, T, E) caches."""
    rng = np.random.RandomState(seed)

    def draw(*shape, scale=1.0):
        if dyadic:
            return (rng.randint(-4, 5, shape) / 8.0).astype(np.float32)
        return (rng.randn(*shape) * scale).astype(np.float32)

    hn = draw(B, k, E)
    ws = [draw(E, E, scale=0.3) for _ in range(4)]
    ck, cv = draw(B, T, E), draw(B, T, E)
    return hn, ws, ck, cv


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t", [0, 5, T - 1])
@pytest.mark.parametrize("dyadic", [False, True])
def test_cached_attention_core_at_a_shared_position(t, dyadic):
    hn, ws, ck, cv = _inputs(t, k=1, dyadic=dyadic)
    jo, jck, jcv = ja.cached_attention_core(
        jnp.asarray(hn), *map(jnp.asarray, ws), jnp.asarray(ck),
        jnp.asarray(cv), jnp.int32(t), HEADS)
    tck, tcv = _t(ck), _t(cv)
    to, rk, rv = ta.cached_attention_core(_t(hn), *map(_t, ws), tck, tcv,
                                          t, HEADS)
    assert rk is tck and rv is tcv   # written in place, returned as given
    _close(to.numpy(), jo)
    if dyadic:
        assert np.array_equal(tck.numpy(), np.asarray(jck))
        assert np.array_equal(tcv.numpy(), np.asarray(jcv))


@pytest.mark.parametrize("pos", [0, 7, T - 1])
def test_decode_attention_op(pos):
    hn, ws, ck, cv = _inputs(10 + pos, k=1, dyadic=True)
    p = np.array([pos], np.float32)
    attrs = {"num_heads": HEADS}
    jo, jck, jcv = jget_op("DecodeAttention").fn(
        JOpCtx(), attrs, jnp.asarray(hn), *map(jnp.asarray, ws),
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(p))
    tck, tcv = _t(ck), _t(cv)
    to, _, _ = tget_op("DecodeAttention").fn(
        TOpCtx(), attrs, _t(hn), *map(_t, ws), tck, tcv, _t(p))
    _close(to.numpy(), jo)
    assert np.array_equal(tck.numpy(), np.asarray(jck))
    assert np.array_equal(tcv.numpy(), np.asarray(jcv))


@pytest.mark.parametrize("dyadic", [False, True])
def test_batch_core_one_token_rows_at_different_depths(dyadic):
    hn, ws, ck, cv = _inputs(20, k=1, dyadic=dyadic)
    pos = np.array([0, 6, T - 1], np.int32)
    jo, jck, jcv = ja.batch_cached_attention_core(
        jnp.asarray(hn), *map(jnp.asarray, ws), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(pos), HEADS)
    tck, tcv = _t(ck), _t(cv)
    to, _, _ = ta.batch_cached_attention_core(
        _t(hn), *map(_t, ws), tck, tcv, _t(pos).long(), HEADS)
    _close(to.numpy(), jo)
    if dyadic:
        assert np.array_equal(tck.numpy(), np.asarray(jck))
        assert np.array_equal(tcv.numpy(), np.asarray(jcv))


# (start positions, valid lengths): idle, partial and full rows; a row
# whose padded columns clip onto its own last valid position
CHUNK_CASES = [
    ([0, 3, 5], [4, 2, 0]),
    ([2, 0, 8], [0, 4, 4]),
    ([T - 2, T - 1, 1], [2, 1, 3]),
]


def _targets(starts):
    return np.minimum(np.asarray(starts)[:, None] + np.arange(K)[None],
                      T - 1).astype(np.int32)


@pytest.mark.parametrize("case", range(len(CHUNK_CASES)))
@pytest.mark.parametrize("dyadic", [False, True])
def test_batch_core_chunked_with_valid_lengths(case, dyadic):
    starts, nlen = CHUNK_CASES[case]
    hn, ws, ck, cv = _inputs(30 + case, dyadic=dyadic)
    tgt, nl = _targets(starts), np.asarray(nlen, np.int32)
    jo, jck, jcv = ja.batch_cached_attention_core(
        jnp.asarray(hn), *map(jnp.asarray, ws), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(tgt), HEADS, nlen=jnp.asarray(nl))
    tck, tcv = _t(ck), _t(cv)
    to, _, _ = ta.batch_cached_attention_core(
        _t(hn), *map(_t, ws), tck, tcv, _t(tgt).long(), HEADS,
        nlen=_t(nl).long())
    _close(to.numpy(), jo)
    if dyadic:
        assert np.array_equal(tck.numpy(), np.asarray(jck))
        assert np.array_equal(tcv.numpy(), np.asarray(jcv))


def _pools(ck, cv, bs, seed):
    """The dense caches laid out in pools of ``bs``-token blocks (row b's
    blocks at ids 2 + b*S ...), a random TRASH block, and the tables;
    row 2's last table entries unmapped (the NULL block)."""
    s = -(-T // bs)
    nb = 2 + B * s
    rng = np.random.RandomState(seed)
    pk = np.zeros((nb, bs, E), np.float32)
    pv = np.zeros((nb, bs, E), np.float32)
    pk[1] = rng.randn(bs, E)
    pv[1] = rng.randn(bs, E)
    btab = (2 + np.arange(B * s)).reshape(B, s).astype(np.int32)
    for b in range(B):
        for j in range(s):
            rows = slice(j * bs, min((j + 1) * bs, T))
            n = rows.stop - rows.start
            pk[btab[b, j], :n] = ck[b, rows]
            pv[btab[b, j], :n] = cv[b, rows]
    return pk, pv, btab


@pytest.mark.parametrize("bs", [1, 3, T])
@pytest.mark.parametrize("case", range(len(CHUNK_CASES)))
def test_paged_core_against_the_reference(bs, case):
    starts, nlen = CHUNK_CASES[case]
    hn, ws, ck, cv = _inputs(40 + case, dyadic=True)
    pk, pv, btab = _pools(ck, cv, bs, case)
    tgt, nl = _targets(starts), np.asarray(nlen, np.int32)
    jo, jpk, jpv = ja.paged_cached_attention_core(
        jnp.asarray(hn), *map(jnp.asarray, ws), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(tgt), HEADS, jnp.asarray(nl),
        jnp.asarray(btab), T)
    tpk, tpv = _t(pk), _t(pv)
    to, _, _ = ta.paged_cached_attention_core(
        _t(hn), *map(_t, ws), tpk, tpv, _t(tgt).long(), HEADS,
        _t(nl).long(), _t(btab), T)
    _close(to.numpy(), jo)
    keep = np.arange(pk.shape[0]) != ta.KV_TRASH_BLOCK   # never read
    assert np.array_equal(tpk.numpy()[keep], np.asarray(jpk)[keep])
    assert np.array_equal(tpv.numpy()[keep], np.asarray(jpv)[keep])


@pytest.mark.parametrize("bs", [1, 3, T])
def test_paged_core_equals_the_dense_core_in_the_port(bs):
    starts, nlen = CHUNK_CASES[0]
    hn, ws, ck, cv = _inputs(50)
    pk, pv, btab = _pools(ck, cv, bs, 7)
    tgt, nl = _t(_targets(starts)).long(), _t(np.asarray(nlen)).long()
    dense, dck, _ = ta.batch_cached_attention_core(
        _t(hn), *map(_t, ws), _t(ck), _t(cv), tgt, HEADS, nlen=nl)
    paged, tpk, _ = ta.paged_cached_attention_core(
        _t(hn), *map(_t, ws), _t(pk), _t(pv), tgt, HEADS, nl, _t(btab), T)
    assert torch.equal(dense, paged)
    view = tpk[_t(btab).long()].reshape(B, -1, E)[:, :T]
    assert torch.equal(view, dck)


@pytest.mark.parametrize("dyadic", [False, True])
def test_chunked_core_against_single_steps_in_the_port(dyadic):
    """A chunk of K against K one-token steps that write only valid
    columns: the valid outputs allclose, the caches equal on dyadic inputs
    and within 1e-6 on random ones (the chunk's projections are one GEMM
    where the steps make K, and the CPU orders their sums otherwise)."""
    starts, nlen = [0, 3, 5], [4, 2, 0]
    hn, ws, ck, cv = _inputs(60, dyadic=dyadic)
    tgt = _targets(starts)
    sck, scv, outs = _t(ck), _t(cv), []
    for j in range(K):
        step_k, step_v = sck.clone(), scv.clone()
        o, _, _ = ta.batch_cached_attention_core(
            _t(hn[:, j:j + 1]), *map(_t, ws), step_k, step_v,
            _t(tgt[:, j]).long(), HEADS)
        valid = torch.from_numpy(j < np.asarray(nlen))[:, None, None]
        sck = torch.where(valid, step_k, sck)
        scv = torch.where(valid, step_v, scv)
        outs.append(o)
    cck, ccv = _t(ck), _t(cv)
    co, _, _ = ta.batch_cached_attention_core(
        _t(hn), *map(_t, ws), cck, ccv, _t(tgt).long(), HEADS,
        nlen=_t(np.asarray(nlen)).long())
    atol = 0 if dyadic else 1e-6
    np.testing.assert_allclose(cck.numpy(), sck.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(ccv.numpy(), scv.numpy(), rtol=0, atol=atol)
    so = torch.cat(outs, dim=1).numpy()
    for b in range(B):
        n = nlen[b]
        np.testing.assert_allclose(co.numpy()[b, :n], so[b, :n],
                                   rtol=RTOL, atol=ATOL)


def _op_both(name, attrs, *xs):
    """Both packages' op bodies on the same inputs, each run for its
    error: (port error, reference error) messages."""
    errs = []
    for get_op, ctx, conv, err in (
            (tget_op, TOpCtx(), _t, TError),
            (jget_op, JOpCtx(), jnp.asarray, JError)):
        with pytest.raises(err) as ei:
            get_op(name).fn(ctx, dict(attrs), *[conv(x) for x in xs])
        errs.append(str(ei.value))
    return errs


def _decode_args(k, pos_shape, nlen_rows=None, btab_rows=None, e=E):
    rng = np.random.RandomState(0)
    args = [rng.randn(B, k, e).astype(np.float32)]
    args += [rng.randn(e, e).astype(np.float32) for _ in range(4)]
    args += [np.zeros((B, T, e), np.float32)] * 2
    args.append(np.zeros(pos_shape, np.float32))
    if nlen_rows is not None:
        args.append(np.ones((nlen_rows,), np.float32))
    if btab_rows is not None:
        args.append(np.zeros((btab_rows, 2), np.float32))
    return args


VALIDATION = [
    ("DecodeAttention", {"num_heads": HEADS}, dict(k=2, pos_shape=(1,))),
    ("DecodeAttention", {"num_heads": 5}, dict(k=1, pos_shape=(1,))),
    ("BatchDecodeAttention", {"num_heads": HEADS, "chunk": 2},
     dict(k=3, pos_shape=(B, 2), nlen_rows=B)),
    ("BatchDecodeAttention", {"num_heads": 5}, dict(k=1, pos_shape=(B,))),
    ("BatchDecodeAttention", {"num_heads": HEADS},
     dict(k=1, pos_shape=(B + 1,))),
    ("BatchDecodeAttention", {"num_heads": HEADS, "chunk": 2},
     dict(k=2, pos_shape=(B, 2), nlen_rows=B + 1)),
    ("BatchDecodeAttention", {"num_heads": HEADS, "paged": 1, "max_len": T},
     dict(k=1, pos_shape=(B, 1), nlen_rows=B - 1, btab_rows=B)),
    ("BatchDecodeAttention", {"num_heads": HEADS, "paged": 1, "max_len": T},
     dict(k=1, pos_shape=(B, 1), nlen_rows=B, btab_rows=B + 1)),
]


@pytest.mark.parametrize("case", range(len(VALIDATION)))
def test_validation_errors_match_the_reference(case):
    name, attrs, kw = VALIDATION[case]
    port, ref = _op_both(name, attrs, *_decode_args(**kw))
    assert port == ref


def test_decode_ops_list_the_reference_inputs():
    for attrs in ({}, {"chunk": 4}, {"paged": 1}, {"chunk": 3, "paged": 1}):
        assert tget_op("BatchDecodeAttention").input_names(attrs) == \
            jget_op("BatchDecodeAttention").input_names(attrs)
    assert tget_op("DecodeAttention").input_names({}) == \
        jget_op("DecodeAttention").input_names({})
    assert (ta.KV_NULL_BLOCK, ta.KV_TRASH_BLOCK, ta.KV_RESERVED_BLOCKS) == \
        (ja.KV_NULL_BLOCK, ja.KV_TRASH_BLOCK, ja.KV_RESERVED_BLOCKS)
