"""The decode graphs, ``GenerateScan`` and ``TransformerStack`` against the
JAX package and against the port's own training forward, on the CPU
(counterparts of tests/test_transformer_decode.py and
tests/test_generate_scan.py): incremental one-token decode reproduces the
full forward's per-position distributions, the greedy token streams of the
two packages are equal (every argmax decision clearing twice the
packages' probability difference), the probabilities agree within rtol
1e-5, atol 1e-6, and ``GenerateScan`` emits the step loop's tokens. The
decode graphs' cache outputs are the bound arrays, written in place; the
reference's documented loop (``arr.alias(out)`` after each forward) gives
the same tokens in both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu.models import transformer_lm as jlm
from mxnet_tpu.ops import get_op as jget_op
from mxnet_tpu.ops.registry import OpCtx as JOpCtx
from mxnet_tpu.ops.transformer_stack import _ROLES as J_ROLES
from mxnet_tpu_torch.convert import LM_ROLE_NAMES, stack_lm_params
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.ops import get_op as tget_op
from mxnet_tpu_torch.ops.registry import OpCtx as TOpCtx
from mxnet_tpu_torch.ops.transformer_stack import _ROLES

V, L, H, HEADS, T, B = 37, 2, 32, 4, 12, 3
RTOL, ATOL = 1e-5, 1e-6


def _weights(seed=0, max_len=T, vocab=V):
    """Random weights in ``get_symbol``'s names (gammas near 1)."""
    dsym, names = tlm.get_decode_symbol(vocab_size=vocab, num_layers=L,
                                        hidden=H, heads=HEADS,
                                        max_len=max_len)
    shapes = {"data": (B, 1), "pos": (1,)}
    shapes.update({n: (B, max_len, H) for n in names})
    arg_shapes, _, _ = dsym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in zip(dsym.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        w = rng.randn(*s) * (0.3 if n.endswith("_weight") else 0.05)
        out[n] = (w + (1.0 if n.endswith("gamma") else 0.0)) \
            .astype(np.float32)
    return out


def _bind_decode(mx, lm, weights, max_len=T, type_dict=None, batch=B):
    dsym, names = lm.get_decode_symbol(vocab_size=V, num_layers=L,
                                       hidden=H, heads=HEADS,
                                       max_len=max_len)
    shapes = {"data": (batch, 1), "pos": (1,)}
    shapes.update({n: (batch, max_len, H) for n in names})
    ex = dsym.simple_bind(mx.cpu(), grad_req="null", type_dict=type_dict,
                          **shapes)
    for n, a in ex.arg_dict.items():
        if n in weights:
            a[:] = weights[n]
    return ex, names


def _greedy_loop(mx, lm, weights, prime, gen_len, max_len=T):
    """The reference's documented loop (example/transformer-lm/
    generate.py): feed by ``arr[:] =``, forward, ``alias`` each cache
    output into its input, argmax on the host. Returns (tokens (B, P +
    gen_len), the probabilities of every step)."""
    ex, names = _bind_decode(mx, lm, weights, max_len)
    toks = [prime[:, i] for i in range(prime.shape[1])]
    probs = []
    for t in range(prime.shape[1] + gen_len - 1):
        ex.arg_dict["data"][:] = toks[t].reshape(-1, 1).astype(np.float32)
        ex.arg_dict["pos"][:] = np.array([t], np.float32)
        outs = ex.forward(is_train=False)
        probs.append(outs[0].asnumpy())
        for n, o in zip(names, outs[1:]):
            ex.arg_dict[n].alias(o)
        if t + 1 >= prime.shape[1]:
            toks.append(probs[-1].argmax(axis=1).astype(np.float32))
    return np.stack(toks, axis=1).astype(np.int64), np.stack(probs)


def _top2_gap(p):
    s = np.sort(p, axis=-1)
    return s[..., -1] - s[..., -2]


def test_incremental_decode_matches_the_full_forward():
    weights = _weights()
    sym = tlm.get_symbol(vocab_size=V, num_layers=L, hidden=H, heads=HEADS,
                         seq_len=T)
    ex = sym.simple_bind(mxt.cpu(), data=(B, T), softmax_label=(B, T),
                         grad_req="null")
    for n, a in ex.arg_dict.items():
        if n in weights:
            a[:] = weights[n]
    toks = np.random.RandomState(1).randint(0, V, (B, T)).astype(np.float32)
    ex.arg_dict["data"][:] = toks
    full = ex.forward(is_train=False)[0].asnumpy().reshape(B, T, V)
    dex, names = _bind_decode(mxt, tlm, weights)
    for t in range(T):
        outs = dex.forward(is_train=False, data=toks[:, t:t + 1],
                           pos=np.array([t], np.float32))
        for n, o in zip(names, outs[1:]):
            assert o.data is dex.arg_dict[n].data   # the bound cache
            dex.arg_dict[n].alias(o)
        np.testing.assert_allclose(outs[0].asnumpy(), full[:, t],
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=f"position {t}")


def test_decode_rejects_multi_token_input():
    dsym, names = tlm.get_decode_symbol(vocab_size=V, num_layers=L,
                                        hidden=H, heads=HEADS, max_len=T)
    shapes = {"data": (B, 2), "pos": (1,)}
    shapes.update({n: (B, T, H) for n in names})
    with pytest.raises(mxt.MXNetError, match="one token"):
        dsym.simple_bind(mxt.cpu(), grad_req="null", **shapes)


def test_decode_bf16_close_to_f32():
    """bf16 weights and caches through ``type_dict``, as ``bench.py``'s
    decode binds them: within bf16 tolerance of fp32."""
    weights = _weights(5)
    dsym, _names = tlm.get_decode_symbol(vocab_size=V, num_layers=L,
                                         hidden=H, heads=HEADS, max_len=T)
    bf16 = {n: "bfloat16" for n in dsym.list_arguments()
            if n not in ("data", "pos")}
    toks = np.random.RandomState(5).randint(0, V, (B, 1)).astype(np.float32)
    probs = []
    for td in (None, bf16):
        ex, _ = _bind_decode(mxt, tlm, weights, type_dict=td)
        out = ex.forward(is_train=False, data=toks,
                         pos=np.array([0], np.float32))[0]
        probs.append(out.asnumpy().astype(np.float32))
    assert np.isfinite(probs[1]).all()
    np.testing.assert_allclose(probs[1], probs[0], rtol=0.1, atol=0.02)


def test_greedy_streams_and_probabilities_match_the_reference():
    """The reference's documented loop in both packages: the same tokens,
    probabilities within rtol 1e-5, atol 1e-6; every argmax the streams
    turn on clears twice the packages' largest difference at its step."""
    weights = _weights(2)
    prime = np.random.RandomState(2).randint(0, V, (B, 3))
    jt, jp = _greedy_loop(mxj, jlm, weights, prime, T - 3)
    tt, tp = _greedy_loop(mxt, tlm, weights, prime, T - 3)
    diff = np.abs(tp - jp).max(axis=(1, 2))
    gaps = _top2_gap(jp[prime.shape[1] - 1:]).min(axis=1)
    assert (gaps > 2 * diff[prime.shape[1] - 1:]).all(), "a near-tie"
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)


def _feeds(chunk, paged, bs=4, seed=9):
    """Inputs of one batch-decode step: tokens, positions (rows at depths
    0, 3, 7), valid lengths, block tables; caches left zero."""
    rng = np.random.RandomState(seed)
    starts = np.array([0, 3, 7])
    f = {"data": rng.randint(0, V, (B, chunk)).astype(np.float32)}
    if chunk == 1 and not paged:
        f["pos"] = starts.astype(np.float32)
    else:
        f["pos"] = np.minimum(starts[:, None] + np.arange(chunk),
                              T - 1).astype(np.float32)
        f["nlen"] = np.array([chunk, 1, 0], np.float32)
    if paged:
        s = -(-T // bs)
        f["btab"] = (2 + np.arange(B * s)).reshape(B, s).astype(np.float32)
    return f


@pytest.mark.parametrize("chunk,paged", [(1, False), (4, False), (1, True),
                                         (3, True)])
def test_batch_decode_symbol_matches_the_reference(chunk, paged):
    weights = _weights(3)
    bs = 4
    feeds = _feeds(chunk, paged, bs)
    outs = []
    for mx, lm in ((mxj, jlm), (mxt, tlm)):
        dsym, names = lm.get_batch_decode_symbol(
            vocab_size=V, num_layers=L, hidden=H, heads=HEADS, max_len=T,
            chunk=chunk, paged=paged)
        cache = ((2 + B * -(-T // bs), bs, H) if paged else (B, T, H))
        shapes = {k: v.shape for k, v in feeds.items()}
        shapes.update({n: cache for n in names})
        ex = dsym.simple_bind(mx.cpu(), grad_req="null", **shapes)
        for n, a in ex.arg_dict.items():
            if n in weights:
                a[:] = weights[n]
            elif n in feeds:
                a[:] = feeds[n]
        res = ex.forward(is_train=False)
        outs.append([o.asnumpy() for o in res])
    jo, to = outs
    # every row and column, idle ones too (they attend the same stale
    # positions in both packages); the pools but the never-read TRASH block
    np.testing.assert_allclose(to[0], jo[0], rtol=RTOL, atol=ATOL)
    keep = slice(None) if not paged else np.arange(to[1].shape[0]) != 1
    for a, b in zip(to[1:], jo[1:]):
        np.testing.assert_allclose(a[keep], b[keep], rtol=RTOL, atol=ATOL)


def test_symbols_list_the_reference_names():
    pairs = [(tlm.get_decode_symbol(V, L, H, HEADS, T),
              jlm.get_decode_symbol(V, L, H, HEADS, T))]
    for chunk, paged in ((1, False), (4, False), (1, True), (3, True)):
        pairs.append((tlm.get_batch_decode_symbol(V, L, H, HEADS, T, chunk,
                                                  paged),
                       jlm.get_batch_decode_symbol(V, L, H, HEADS, T, chunk,
                                                   paged)))
    for (ts, tn), (js, jn) in pairs:
        assert tn == jn
        assert ts.list_arguments() == js.list_arguments()
        assert ts.list_outputs() == js.list_outputs()
    tp = tlm.get_symbol(V, L, H, HEADS, T, pipeline=True)
    jp = jlm.get_symbol(V, L, H, HEADS, T, pipeline=True)
    assert tp.list_arguments() == jp.list_arguments()
    with pytest.raises(ValueError):
        tlm.get_batch_decode_symbol(V, L, H, HEADS, T, chunk=T + 1)


def _stacked(weights):
    return stack_lm_params(weights, L)


def _scan_inputs(weights, ctx, dtype=np.float32):
    from mxnet_tpu_torch.ops.generate_scan import _INPUTS

    st = _stacked(weights)
    return [mxt.nd.array(np.asarray(st[n], dtype), ctx) for n in _INPUTS[1:]]


def test_stack_lm_params_follows_the_reference_name_map():
    weights = _weights(4)
    st = _stacked(weights)
    assert [r for r, _ in _ROLES] == [r for r, _ in J_ROLES]
    for role, _shape in _ROLES:
        want = np.stack([weights[f"layer{i}_{LM_ROLE_NAMES[role]}"]
                         for i in range(L)])
        assert np.array_equal(st[role], want)
    assert np.array_equal(st["embed_weight"], weights["tok_embed_weight"])
    assert np.array_equal(st["head_bias"], weights["head_bias"])


def test_generate_scan_matches_the_step_loop_and_the_reference():
    weights = _weights(6)
    prime = np.random.RandomState(7).randint(0, V, (B, 4))
    want, probs = _greedy_loop(mxt, tlm, weights, prime, T - 4)
    ins = _scan_inputs(weights, mxt.cpu())
    got = mxt.nd.GenerateScan(mxt.nd.array(prime, mxt.cpu()), *ins,
                              num_layers=L, num_heads=HEADS,
                              gen_len=T - 4).asnumpy().astype(np.int64)
    np.testing.assert_array_equal(got, want)
    st = _stacked(weights)
    from mxnet_tpu.ops.generate_scan import _INPUTS as J_INPUTS

    ref = mxj.nd.GenerateScan(
        mxj.nd.array(prime.astype(np.float32)),
        *[mxj.nd.array(np.asarray(st[n], np.float32))
          for n in J_INPUTS[1:]],
        num_layers=L, num_heads=HEADS, gen_len=T - 4).asnumpy()
    assert (_top2_gap(probs[3:]) > 1e-4).all(), "a near-tie"
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_generate_scan_rejects_overlong():
    ins = _scan_inputs(_weights(), mxt.cpu())
    with pytest.raises(mxt.MXNetError, match="position table"):
        mxt.nd.GenerateScan(mxt.nd.zeros((B, 4), mxt.cpu()), *ins,
                            num_layers=L, num_heads=HEADS, gen_len=T)
    with pytest.raises(mxt.MXNetError, match="num_layers"):
        mxt.nd.GenerateScan(mxt.nd.zeros((B, 4), mxt.cpu()), *ins,
                            num_heads=HEADS, gen_len=2)


def test_generate_scan_temperature_sampling():
    """temperature > 0 samples from the node's generator: the same seed
    gives the same tokens, another seed others; in the vocabulary; the
    prime kept; greedy does not depend on the seed."""
    ins = _scan_inputs(_weights(), mxt.cpu())
    prime = np.random.RandomState(7).randint(0, V, (B, 4))

    def gen(temp, seed):
        mxt.random.seed(seed)
        return mxt.nd.GenerateScan(
            mxt.nd.array(prime, mxt.cpu()), *ins, num_layers=L,
            num_heads=HEADS, gen_len=T - 4,
            temperature=temp).asnumpy().astype(np.int64)

    np.testing.assert_array_equal(gen(0.0, 1), gen(0.0, 2))
    s1, s1b, s2 = gen(1.5, 1), gen(1.5, 1), gen(1.5, 2)
    np.testing.assert_array_equal(s1, s1b)
    assert not np.array_equal(s1, s2)
    assert ((0 <= s1) & (s1 < V)).all()
    np.testing.assert_array_equal(s1[:, :4], prime)


def test_transformer_stack_op_matches_the_reference():
    rng = np.random.RandomState(8)
    x = rng.randn(B, T, H).astype(np.float32)
    st = _stacked(_weights(8))
    ins = [x] + [st[r] for r, _ in _ROLES]
    attrs = {"num_layers": L, "num_heads": HEADS, "causal": True}
    got = tget_op("TransformerStack").fn(TOpCtx(), dict(attrs),
                                         *[torch.from_numpy(a) for a in ins])
    want = jget_op("TransformerStack").fn(JOpCtx(), dict(attrs),
                                          *[jnp.asarray(a) for a in ins])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)


def test_pipeline_symbol_off_the_mesh_matches_the_reference():
    """``get_symbol(pipeline=True)``: the blocks as one TransformerStack
    over stacked weights, one forward in each package."""
    st = _stacked(_weights(9))
    toks = np.random.RandomState(9).randint(0, V, (B, T)).astype(np.float32)
    probs = []
    for mx, lm in ((mxj, jlm), (mxt, tlm)):
        sym = lm.get_symbol(V, L, H, HEADS, T, pipeline=True)
        ex = sym.simple_bind(mx.cpu(), data=(B, T), softmax_label=(B, T),
                             grad_req="null")
        w = _weights(9)
        for n, a in ex.arg_dict.items():
            if n.startswith("stack_"):
                a[:] = st[n[len("stack_"):]]
            elif n in w:
                a[:] = w[n]
        ex.arg_dict["data"][:] = toks
        probs.append(ex.forward(is_train=False)[0].asnumpy())
    np.testing.assert_allclose(probs[1], probs[0], rtol=1e-4, atol=1e-6)
