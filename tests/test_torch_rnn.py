"""The RNN toolkit, the port against the JAX package on the CPU: the fused
``RNN`` op in each mode (1 and 2 layers, bidirectional, ``state_outputs``;
both of the port's CPU routes: the whole stack in one loop, and layer by
layer with the reference's dropout between layers on fed masks), every
cell's ``unroll`` (NTC and TNC, ``merge_outputs``), the ``lstm_lm``
factories, ``encode_sentences`` and ``BucketSentenceIter`` under the same
seeds, and RNN checkpoints read by the other package; plus a counterpart of
each test of ``tests/test_rnn.py``. Forward and gradients: inputs, weights
and head gradients are numpy arrays fed to both packages. fp32 limits:
outputs 1e-5, gradients 1e-4 (rtol, with atol 1e-6 and 1e-5), as in
``tests/test_torch_symbol_ops.py``; ``tests/test_rnn.py``'s own limits
where it has them (1e-4 against its numpy LSTM)."""
import random

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu.ops.rnn_op import rnn_param_size as j_param_size
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import rnn_op as trnn

OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")
    monkeypatch.setenv("MXTPU_FUSED_GRADS", "1")
    monkeypatch.delenv("MXTPU_DONATE_PARAMS", raising=False)


@pytest.fixture
def fed_masks(monkeypatch):
    """Both packages take their dropout masks from ``masks`` in draw order
    (the reference's ``jax.random.bernoulli``, the port's
    :func:`~mxnet_tpu_torch.ops.nn.keep_mask`)."""
    masks = []
    state = {"j": 0, "t": 0}

    def pick(side, shape):
        m = masks[state[side] % len(masks)]
        state[side] += 1
        assert m.shape == tuple(shape), (m.shape, shape)
        return m

    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape:
                        jax.numpy.asarray(pick("j", shape)))
    monkeypatch.setattr(tnn, "keep_mask", lambda gen, keep, shape, device:
                        torch.from_numpy(pick("t", shape)).to(device))
    return masks


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _run(pkg, sym, arrays, heads, is_train=True):
    """Bind ``sym`` over ``arrays`` with a gradient for each, forward (and
    backward with ``heads`` in training); outputs and gradients as numpy."""
    ctx = pkg.cpu()
    args = {n: pkg.nd.array(a, ctx) for n, a in arrays.items()}
    grads = {n: pkg.nd.zeros(a.shape, ctx) for n, a in arrays.items()}
    ex = sym.bind(ctx, args, args_grad=grads)
    outs = [o.asnumpy() for o in ex.forward(is_train=is_train)]
    if not is_train:
        return outs, {}
    ex.backward([pkg.nd.array(h, ctx) for h in heads])
    return outs, {n: ex.grad_dict[n].asnumpy() for n in arrays}


def _compare(build, arrays, heads, is_train=True):
    got = _run(mxt, build(mxt), arrays, heads, is_train)
    want = _run(mxj, build(mxj), arrays, heads, is_train)
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **OUT)
    for n in want[1]:
        np.testing.assert_allclose(got[1][n], want[1][n], **GRAD,
                                   err_msg=n)
    return got


# ---------------------------------------------------------------------------
# the fused RNN op

T, N, C, H = 4, 3, 5, 6


def _rnn_sym(pkg, mode, layers, bi, state_outputs, p=0.0):
    ins = [pkg.sym.Variable("data"), pkg.sym.Variable("params"),
           pkg.sym.Variable("state")]
    if mode == "lstm":
        ins.append(pkg.sym.Variable("state_cell"))
    return pkg.sym.RNN(*ins, state_size=H, num_layers=layers, mode=mode,
                       bidirectional=bi, state_outputs=state_outputs, p=p,
                       name="rnn")


def _rnn_arrays(rng, mode, layers, bi):
    d = 2 if bi else 1
    arrays = {"data": _rand(rng, T, N, C),
              "params": _rand(rng, trnn.rnn_param_size(mode, layers, C, H,
                                                       bi), scale=0.3),
              "state": _rand(rng, layers * d, N, H, scale=0.5)}
    if mode == "lstm":
        arrays["state_cell"] = _rand(rng, layers * d, N, H, scale=0.5)
    return arrays


def _rnn_heads(rng, mode, layers, bi, state_outputs):
    d = 2 if bi else 1
    heads = [_rand(rng, T, N, d * H)]
    if state_outputs:
        heads += [_rand(rng, layers * d, N, H)
                  for _ in range(2 if mode == "lstm" else 1)]
    return heads


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("layers,bi", [(1, False), (2, False), (1, True),
                                       (2, True)])
@pytest.mark.parametrize("state_outputs", [False, True])
def test_rnn_op_matches_reference(mode, layers, bi, state_outputs):
    """The whole stack in one loop (the CPU route at p = 0)."""
    rng = np.random.default_rng([len(mode), layers, bi])
    arrays = _rnn_arrays(rng, mode, layers, bi)
    heads = _rnn_heads(rng, mode, layers, bi, state_outputs)
    trnn.reset_launches()
    outs, _ = _compare(lambda pkg: _rnn_sym(pkg, mode, layers, bi,
                                            state_outputs),
                       arrays, heads)
    assert trnn.cudnn_calls == 0   # CPU tensors take the plain route
    assert len(outs) == len(heads)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bi", [False, True])
def test_rnn_op_layer_dropout_on_fed_masks_matches_reference(fed_masks, mode,
                                                             bi):
    """p > 0 in training: layer by layer, the reference's mask between the
    layers (here fed to both)."""
    rng = np.random.default_rng(11)
    layers, d, p = 3, 2 if bi else 1, 0.4
    fed_masks.append(rng.random((T, N, d * H)) >= p)
    fed_masks.append(rng.random((T, N, d * H)) >= p)
    arrays = _rnn_arrays(rng, mode, layers, bi)
    heads = _rnn_heads(rng, mode, layers, bi, True)
    _compare(lambda pkg: _rnn_sym(pkg, mode, layers, bi, True, p=p), arrays,
             heads)


def test_rnn_op_dropout_is_off_in_inference():
    rng = np.random.default_rng(12)
    arrays = _rnn_arrays(rng, "lstm", 2, False)
    got = _run(mxt, _rnn_sym(mxt, "lstm", 2, False, False, p=0.5), arrays,
               [], is_train=False)[0]
    want = _run(mxt, _rnn_sym(mxt, "lstm", 2, False, False), arrays, [],
                is_train=False)[0]
    np.testing.assert_array_equal(got[0], want[0])


def test_rnn_param_size_and_shapes_match_reference():
    for mode in ("lstm", "gru", "rnn_tanh"):
        for layers, bi in ((1, False), (3, True)):
            assert trnn.rnn_param_size(mode, layers, C, H, bi) == \
                j_param_size(mode, layers, C, H, bi)
            shapes = [pkg_sym.infer_shape(data=(T, N, C))
                      for pkg_sym in (_rnn_sym(mxt, mode, layers, bi, True),
                                      _rnn_sym(mxj, mode, layers, bi, True))]
            assert shapes[0] == shapes[1]


def test_fused_lstm_equals_unrolled_cells():
    """The unrolled LSTMCell stack and the fused op agree when the cells'
    weights are packed into the flat vector with 1.0 (the cells'
    ``forget_bias``) added to the forget slice of ``b_ih``."""
    rng = np.random.default_rng(13)
    layers = 2
    stack = mxt.rnn.SequentialRNNCell()
    for i in range(layers):
        stack.add(mxt.rnn.LSTMCell(H, prefix=f"l{i}_"))
    data = mxt.sym.Variable("data")
    outs, _ = stack.unroll(T, inputs=data, layout="TNC", merge_outputs=True)
    arrays = {"data": _rand(rng, T, N, C)}
    shapes = dict(zip(outs.list_arguments(), outs.infer_shape(
        data=(T, N, C), __batch_size__=(N,))[0]))
    flat = []
    for name, shape in shapes.items():
        if name != "data":
            arrays[name] = _rand(rng, *shape, scale=0.3) \
                if "begin_state" not in name else np.zeros(shape, np.float32)
    for i in range(layers):
        b_ih = arrays[f"l{i}_i2h_bias"].copy()
        b_ih[H:2 * H] += 1.0
        flat += [arrays[f"l{i}_i2h_weight"].ravel(),
                 arrays[f"l{i}_h2h_weight"].ravel(), b_ih,
                 arrays[f"l{i}_h2h_bias"]]
    unrolled = _run(mxt, outs, arrays, [], is_train=False)[0][0]
    fused = _run(mxt, _rnn_sym(mxt, "lstm", layers, False, False), {
        "data": arrays["data"], "params": np.concatenate(flat),
        "state": np.zeros((layers, N, H), np.float32),
        "state_cell": np.zeros((layers, N, H), np.float32)}, [],
        is_train=False)[0][0]
    np.testing.assert_allclose(fused, unrolled, **OUT)


# ---------------------------------------------------------------------------
# cells


def _make_cell(pkg, kind):
    rnn = pkg.rnn
    if kind == "rnn":
        return rnn.RNNCell(H, prefix="r_")
    if kind == "lstm":
        return rnn.LSTMCell(H, prefix="l_", forget_bias=0.5)
    if kind == "gru":
        return rnn.GRUCell(H, prefix="g_")
    if kind == "seq":
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.LSTMCell(H, prefix="s0_"))
        cell.add(rnn.GRUCell(H, prefix="s1_"))
        return cell
    if kind == "dropout":
        return rnn.DropoutCell(rnn.LSTMCell(H, prefix="d_"), dropout=0.3)
    if kind == "zoneout":
        return rnn.ZoneoutCell(rnn.RNNCell(H, prefix="z_"),
                               zoneout_outputs=0.3)
    return rnn.BidirectionalCell(rnn.LSTMCell(H, prefix="bl_"),
                                 rnn.GRUCell(H, prefix="br_"))


def _unrolled(pkg, kind, layout, merge, steps=3):
    cell = _make_cell(pkg, kind)
    outs, states = cell.unroll(steps, inputs=pkg.sym.Variable("data"),
                               layout=layout, merge_outputs=merge)
    outs = [outs] if merge else list(outs)
    return pkg.sym.Group(outs + list(states))


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "seq", "dropout",
                                  "zoneout", "bidir"])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("merge", [False, True])
def test_cell_unroll_matches_reference(fed_masks, kind, layout, merge):
    steps = 3
    rng = np.random.default_rng(14)
    fed_masks.append(rng.random((N, H)) >= 0.3)
    shape = (N, steps, C) if layout == "NTC" else (steps, N, C)
    sym = _unrolled(mxt, kind, layout, merge, steps)
    assert sym.list_arguments() == \
        _unrolled(mxj, kind, layout, merge, steps).list_arguments()
    arg_shapes, out_shapes, _ = sym.infer_shape(data=shape,
                                                __batch_size__=(N,))
    arrays = {n: _rand(rng, *s, scale=0.4)
              for n, s in zip(sym.list_arguments(), arg_shapes)}
    heads = [_rand(rng, *s) for s in out_shapes]
    _compare(lambda pkg: _unrolled(pkg, kind, layout, merge, steps), arrays,
             heads)


def test_rnn_cell_unroll_shapes():
    cell = mxt.rnn.RNNCell(num_hidden=8, prefix="rnn_")
    outputs, states = cell.unroll(3, input_prefix="t")
    assert len(outputs) == 3
    args = set(mxt.sym.Group(outputs).list_arguments())
    assert "rnn_i2h_weight" in args and "rnn_h2h_weight" in args


def test_lstm_cell_param_sharing():
    cell = mxt.rnn.LSTMCell(num_hidden=8, prefix="lstm_")
    outputs, _ = cell.unroll(4, input_prefix="t")
    weights = [a for a in mxt.sym.Group(outputs).list_arguments()
               if a.endswith("weight")]
    assert sorted(weights) == ["lstm_h2h_weight", "lstm_i2h_weight"]


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_one_cell_step_matches_reference(kind):
    """tests/test_rnn.py test_lstm_forward_exec and test_gru_cell, held to
    the reference's outputs."""
    rng = np.random.default_rng(15)

    def build(pkg):
        cell = (pkg.rnn.LSTMCell(4, prefix="l_") if kind == "lstm"
                else pkg.rnn.GRUCell(4, prefix="g_"))
        states = [pkg.sym.Variable("h0")]
        if kind == "lstm":
            states.append(pkg.sym.Variable("c0"))
        out, new = cell(pkg.sym.Variable("x"), states)
        return pkg.sym.Group([out] + new)

    sym = build(mxt)
    shapes = {"x": (2, 3), "h0": (2, 4), "c0": (2, 4)}
    arg_shapes, out_shapes, _ = sym.infer_shape(
        **{k: v for k, v in shapes.items() if k in sym.list_arguments()})
    arrays = {n: _rand(rng, *s, scale=0.1)
              for n, s in zip(sym.list_arguments(), arg_shapes)}
    outs, _ = _compare(build, arrays, [_rand(rng, *s) for s in out_shapes])
    assert outs[0].shape == (2, 4) and np.isfinite(outs[0]).all()


def test_sequential_cell_stack():
    stacked = mxt.rnn.SequentialRNNCell()
    stacked.add(mxt.rnn.LSTMCell(num_hidden=4, prefix="l0_"))
    stacked.add(mxt.rnn.LSTMCell(num_hidden=4, prefix="l1_"))
    _, states = stacked.unroll(2, input_prefix="t")
    assert len(states) == 4


def _np_lstm_ref(x, w_ih, w_hh, b_ih, b_hh, h0, c0):
    outs = []
    h, c = h0.copy(), c0.copy()

    def sig(v):
        return 1 / (1 + np.exp(-v))

    for t in range(x.shape[0]):
        gates = x[t] @ w_ih.T + b_ih + h @ w_hh.T + b_hh
        i, f, g, o = np.split(gates, 4, axis=-1)
        c = sig(f) * c + sig(i) * np.tanh(g)
        h = sig(o) * np.tanh(c)
        outs.append(h.copy())
    return np.stack(outs), h, c


def test_fused_rnn_op_lstm_matches_numpy():
    """tests/test_rnn.py's numpy LSTM at its limits (rtol 1e-4, atol
    1e-5)."""
    rng = np.random.RandomState(0)
    t, n, c, h = 5, 3, 4, 6
    w_ih = rng.randn(4 * h, c).astype(np.float32) * 0.3
    w_hh = rng.randn(4 * h, h).astype(np.float32) * 0.3
    b_ih = rng.randn(4 * h).astype(np.float32) * 0.1
    b_hh = rng.randn(4 * h).astype(np.float32) * 0.1
    params = np.concatenate([w_ih.ravel(), w_hh.ravel(), b_ih, b_hh])
    assert params.size == trnn.rnn_param_size("lstm", 1, c, h)
    x = rng.randn(t, n, c).astype(np.float32)
    h0 = rng.randn(1, n, h).astype(np.float32) * 0.1
    c0 = rng.randn(1, n, h).astype(np.float32) * 0.1
    sym = mxt.sym.RNN(mxt.sym.Variable("data"), mxt.sym.Variable("p"),
                      mxt.sym.Variable("s"), mxt.sym.Variable("sc"),
                      state_size=h, num_layers=1, mode="lstm",
                      state_outputs=True, name="r")
    cpu = mxt.cpu()
    outs = sym.eval(ctx=cpu, data=mxt.nd.array(x, cpu),
                    p=mxt.nd.array(params, cpu), s=mxt.nd.array(h0, cpu),
                    sc=mxt.nd.array(c0, cpu))
    want = _np_lstm_ref(x, w_ih, w_hh, b_ih, b_hh, h0[0], c0[0])
    np.testing.assert_allclose(outs[0].asnumpy(), want[0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(outs[1].asnumpy()[0], want[1], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(outs[2].asnumpy()[0], want[2], rtol=1e-4,
                               atol=1e-5)


def test_fused_rnn_shapes_and_grad():
    """tests/test_rnn.py's shapes; its numeric gradient check becomes the
    data gradient held to the reference's (1e-4)."""
    t, n, c, h, layers = 4, 2, 3, 5, 2

    def build(pkg):
        return pkg.sym.RNN(pkg.sym.Variable("data"), pkg.sym.Variable("p"),
                           pkg.sym.Variable("s"), pkg.sym.Variable("sc"),
                           state_size=h, num_layers=layers, mode="lstm",
                           name="r")

    arg_shapes, out_shapes, _ = build(mxt).infer_shape(data=(t, n, c))
    assert arg_shapes[1] == (trnn.rnn_param_size("lstm", layers, c, h),)
    assert arg_shapes[2] == (layers, n, h)
    assert out_shapes[0] == (t, n, h)
    rng = np.random.RandomState(1)
    arrays = {"data": rng.randn(t, n, c).astype(np.float32) * 0.3,
              "p": rng.randn(arg_shapes[1][0]).astype(np.float32) * 0.2,
              "s": np.zeros((layers, n, h), np.float32),
              "sc": np.zeros((layers, n, h), np.float32)}
    _compare(build, arrays, [rng.randn(t, n, h).astype(np.float32)])


def test_fused_rnn_bidirectional():
    t, n, c, h = 4, 2, 3, 5
    sym = mxt.sym.RNN(mxt.sym.Variable("data"), mxt.sym.Variable("p"),
                      mxt.sym.Variable("s"), state_size=h, num_layers=1,
                      mode="gru", bidirectional=True, name="r")
    arg_shapes, out_shapes, _ = sym.infer_shape(data=(t, n, c))
    assert arg_shapes[1] == (trnn.rnn_param_size("gru", 1, c, h, True),)
    assert out_shapes[0] == (t, n, 2 * h)


# ---------------------------------------------------------------------------
# the LSTM LM factories

VOCAB, LAYERS, HIDDEN, EMBED, SEQ, BATCH = 20, 2, 8, 6, 5, 3


def _lm_arrays(sym, rng):
    shapes = {"data": (BATCH, SEQ), "softmax_label": (BATCH, SEQ)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    arrays = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            arrays[name] = rng.integers(0, VOCAB, shape).astype(np.float32)
        else:
            arrays[name] = _rand(rng, *shape, scale=0.3)
    return arrays


@pytest.mark.parametrize("fused", [False, True])
def test_lstm_lm_factories_match_reference(fused):
    """One training forward and backward of each factory's bucket-5 graph.
    The port's fused graph gives its rows batch-major, the reference's
    time-major: the outputs are compared with the reference's rows
    permuted, the gradients as they are."""
    def build(pkg):
        factory = (pkg.models.lstm_lm.fused_sym_gen_factory if fused
                   else pkg.models.lstm_lm.sym_gen_factory)
        sym, data_names, label_names = factory(
            num_hidden=HIDDEN, num_embed=EMBED, num_layers=LAYERS,
            vocab_size=VOCAB)(SEQ)
        assert (data_names, label_names) == (["data"], ["softmax_label"])
        return sym

    rng = np.random.default_rng(16)
    arrays = _lm_arrays(build(mxt), rng)
    assert build(mxt).list_arguments() == build(mxj).list_arguments()
    heads = [np.ones((BATCH * SEQ, VOCAB), np.float32)]
    got = _run(mxt, build(mxt), arrays, heads)
    want = _run(mxj, build(mxj), arrays, heads)
    ref = want[0][0]
    if fused:
        ref = ref.reshape(SEQ, BATCH, VOCAB).transpose(1, 0, 2).reshape(
            -1, VOCAB)
    np.testing.assert_allclose(got[0][0], ref, **OUT)
    for n in arrays:
        if n not in ("data", "softmax_label"):
            np.testing.assert_allclose(got[1][n], want[1][n], **GRAD,
                                       err_msg=n)


# ---------------------------------------------------------------------------
# data and checkpoints


def _sentences(rng, n, vocab=30):
    return [list(rng.randint(1, vocab, rng.choice([3, 5, 6, 8])))
            for _ in range(n)]


def test_encode_sentences_matches_reference():
    sents = [["a", "b", "c"], ["b", "d"], ["e", "a", "a", "f"]]
    for kw in ({}, {"start_label": 1, "invalid_label": 0},
               {"vocab": {"a": 3, "b": 4, "c": 5, "d": 6, "e": 7, "f": 8}}):
        got = mxt.rnn.encode_sentences(sents, **dict(kw))
        kw2 = dict(kw)
        if "vocab" in kw2:
            kw2["vocab"] = dict(kw2["vocab"])
        want = mxj.rnn.encode_sentences(sents, **kw2)
        assert got == want
    coded, vocab = mxt.rnn.encode_sentences([["a", "b"], ["b", "c"]],
                                            start_label=1)
    assert len(vocab) >= 3 and coded[0][1] == coded[1][0]


@pytest.mark.parametrize("buckets", [[4, 6, 8], None])
def test_bucket_sentence_iter_matches_reference(buckets):
    """Same seeds of ``random`` and ``np.random``, same batches, keys and
    descriptors, over two epochs."""
    sents = _sentences(np.random.RandomState(3), 90)
    res = []
    for pkg in (mxt, mxj):
        random.seed(4)
        np.random.seed(4)
        it = pkg.rnn.BucketSentenceIter(sents, 4, buckets=buckets,
                                        invalid_label=0)
        seen = [it.default_bucket_key, [tuple(d) for d in it.provide_data]]
        for _ in range(2):
            it.reset()
            for b in it:
                seen.append((b.bucket_key, b.data[0].asnumpy(),
                             b.label[0].asnumpy(), b.pad,
                             [tuple(d) for d in b.provide_data],
                             [tuple(d) for d in b.provide_label]))
        res.append(seen)
    assert len(res[0]) == len(res[1]) > 4
    assert res[0][:2] == res[1][:2]
    for g, w in zip(res[0][2:], res[1][2:]):
        assert g[0] == w[0] and g[3:] == w[3:]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])


def test_bucket_sentence_iter():
    sentences = [[1, 2, 3], [4, 5, 6, 7, 8], [1, 2, 3, 4], [5, 6]] * 8
    it = mxt.rnn.BucketSentenceIter(sentences, batch_size=4, buckets=[4, 6],
                                    invalid_label=0)
    batch = next(iter(it))
    assert batch.bucket_key in (4, 6)
    assert batch.data[0].shape[0] == 4
    assert batch.data[0].context == mxt.cpu()


@pytest.mark.parametrize("writer,reader", [(mxt, mxj), (mxj, mxt)])
def test_rnn_checkpoint_read_by_the_other_package(tmp_path, writer, reader):
    rng = np.random.default_rng(17)
    cell = writer.rnn.LSTMCell(4, prefix="l_")
    outs, _ = cell.unroll(3, input_prefix="t")
    sym = writer.sym.Group(outs)
    args = {"l_i2h_weight": _rand(rng, 16, 5), "l_h2h_weight": _rand(rng, 16, 4),
            "l_i2h_bias": _rand(rng, 16), "l_h2h_bias": _rand(rng, 16)}
    prefix = str(tmp_path / "rnn")
    writer.rnn.save_rnn_checkpoint(
        cell, prefix, 3, sym, {n: writer.nd.array(a, writer.cpu())
                               for n, a in args.items()}, {})
    kw = {"ctx": reader.cpu()} if reader is mxt else {}
    loaded_sym, arg, aux = reader.rnn.load_rnn_checkpoint(
        reader.rnn.LSTMCell(4, prefix="l_"), prefix, 3, **kw)
    assert loaded_sym.list_arguments() == sym.list_arguments()
    assert set(arg) == set(args) and aux == {}
    for n, a in args.items():
        np.testing.assert_array_equal(arg[n].asnumpy(), a)
    calls = []
    cb = writer.rnn.do_rnn_checkpoint(cell, prefix + "cb", period=2)
    for epoch in range(4):
        cb(epoch, sym, {n: writer.nd.array(a, writer.cpu())
                        for n, a in args.items()}, {})
        calls.append((tmp_path / f"rnncb-{epoch + 1:04d}.params").exists())
    assert calls == [False, True, False, True]
