"""Symbol composition and the ops the RNN cells use, the port against the JAX
package on the CPU: every Symbol operator (``+ - * / **`` with symbols and
scalars, the reflected forms, unary minus) and its ``mx.nd`` op, indexing
and iteration over a multi-output symbol, ``Group``, partial-shape
inference, ``Concat``, ``SliceChannel``, ``Dropout`` (the identity at p = 0
and in inference; in training on a fed mask), JSON written by either
package, and the Executor's per-node random numbers. Inputs and head
gradients are numpy arrays fed to both packages; fp32 limits: outputs 1e-5,
gradients 1e-4 (rtol, with atol 1e-6 and 1e-5)."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import nn as tnn

OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _rand(rng, *shape, scale=1.0, low=None):
    a = rng.standard_normal(shape) * scale
    if low is not None:
        a = np.abs(a) + low
    return a.astype(np.float32)


def _run(pkg, build, arrays, heads, is_train=True):
    """Bind ``build(pkg)`` over ``arrays`` with a gradient for each one, run
    a forward (a training one by default) and, in training, a backward
    with ``heads``; returns (outputs, gradients by name) as numpy."""
    ctx = pkg.cpu()
    sym = build(pkg)
    args = {n: pkg.nd.array(a, ctx) for n, a in arrays.items()}
    grads = {n: pkg.nd.zeros(a.shape, ctx) for n, a in arrays.items()}
    ex = sym.bind(ctx, args, args_grad=grads)
    outs = ex.forward(is_train=is_train)
    if not is_train:
        return [o.asnumpy() for o in outs], {}
    ex.backward([pkg.nd.array(h, ctx) for h in heads])
    return ([o.asnumpy() for o in outs],
            {n: ex.grad_dict[n].asnumpy() for n in arrays})


def _compare(build, arrays, heads, is_train=True):
    got = _run(mxt, build, arrays, heads, is_train)
    want = _run(mxj, build, arrays, heads, is_train)
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **OUT)
    for n in want[1]:
        np.testing.assert_allclose(got[1][n], want[1][n], **GRAD)
    return got


BINARY = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "pow": lambda a, b: a ** b,
}
SCALAR = {
    "add": lambda a: a + 1.5, "radd": lambda a: 1.5 + a,
    "sub": lambda a: a - 1.5, "rsub": lambda a: 1.5 - a,
    "mul": lambda a: a * -2.5, "rmul": lambda a: -2.5 * a,
    "div": lambda a: a / 3.0, "rdiv": lambda a: 3.0 / a,
    "pow": lambda a: a ** 2.0, "neg": lambda a: -a,
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_symbol_binary_operator_matches_reference(op):
    rng = np.random.default_rng(0)
    arrays = {"a": _rand(rng, 3, 4, low=0.5), "b": _rand(rng, 3, 4, low=0.5)}

    def build(pkg):
        return BINARY[op](pkg.sym.Variable("a"), pkg.sym.Variable("b"))

    _compare(build, arrays, [_rand(rng, 3, 4)])


@pytest.mark.parametrize("op", sorted(SCALAR))
def test_symbol_scalar_operator_matches_reference(op):
    rng = np.random.default_rng(1)
    arrays = {"a": _rand(rng, 3, 4, low=0.5)}

    def build(pkg):
        return SCALAR[op](pkg.sym.Variable("a"))

    _compare(build, arrays, [_rand(rng, 3, 4)])


def test_symbol_operators_name_the_reference_ops():
    """Each operator makes the reference's op node, so either package's
    JSON of a composed graph binds in the other."""
    for pkg in (mxt, mxj):
        a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
        graph = pkg.sym.Group([a + b, a - 1, 1 - a, a * b, 2 * a, a / b,
                               2 / a, a ** b, a ** 2, -a])
        ops = [n["op"] for n in __import__("json").loads(graph.tojson())
               ["nodes"] if n["op"] != "null"]
        assert ops == ["elemwise_add", "_minus_scalar", "_rminus_scalar",
                       "elemwise_mul", "_mul_scalar", "elemwise_div",
                       "_rdiv_scalar", "_power", "_power_scalar",
                       "_mul_scalar"]


@pytest.mark.parametrize("writer,reader", [(mxt, mxj), (mxj, mxt)])
def test_composed_json_binds_in_the_other_package(writer, reader):
    rng = np.random.default_rng(2)
    arrays = {"a": _rand(rng, 2, 6, low=0.5), "b": _rand(rng, 2, 6, low=0.5)}

    def graph(pkg):
        a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
        parts = pkg.sym.SliceChannel(a * b + 1.0, num_outputs=3)
        return pkg.sym.Group([parts[0] - parts[2] / 2.0, -parts[1] ** 2])

    loaded = reader.sym.load_json(graph(writer).tojson())
    got = _run(reader, lambda _: loaded, arrays, [], is_train=False)[0]
    want = _run(writer, graph, arrays, [], is_train=False)[0]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **OUT)


@pytest.mark.parametrize("name,attrs", [
    ("_plus_scalar", {"scalar": 1.5}), ("_minus_scalar", {"scalar": 1.5}),
    ("_rminus_scalar", {"scalar": 1.5}), ("_mul_scalar", {"scalar": -2.5}),
    ("_div_scalar", {"scalar": 3.0}), ("_rdiv_scalar", {"scalar": 3.0}),
    ("_power_scalar", {"scalar": 2.0}), ("elemwise_add", None),
    ("elemwise_sub", None), ("elemwise_mul", None), ("elemwise_div", None),
    ("_power", None)])
def test_nd_counterpart_of_each_operator(name, attrs):
    rng = np.random.default_rng(3)
    a, b = _rand(rng, 3, 5, low=0.5), _rand(rng, 3, 5, low=0.5)
    res = []
    for pkg in (mxt, mxj):
        ins = [pkg.nd.array(a, pkg.cpu())]
        if attrs is None:
            ins.append(pkg.nd.array(b, pkg.cpu()))
        res.append(getattr(pkg.nd, name)(*ins, **(attrs or {})).asnumpy())
    np.testing.assert_allclose(res[0], res[1], **OUT)


def test_getitem_iter_and_group():
    """A multi-output symbol indexes by position and by output name and
    iterates over its outputs; ``Group`` keeps its members' outputs in
    order. Names and arguments agree with the reference."""
    for pkg in (mxt, mxj):
        x = pkg.sym.Variable("x")
        parts = pkg.sym.SliceChannel(x, num_outputs=3, name="sl")
        assert parts.list_outputs() == ["sl_output0", "sl_output1",
                                        "sl_output2"]
        assert [p.list_outputs() for p in parts] == [
            ["sl_output0"], ["sl_output1"], ["sl_output2"]]
        assert parts["sl_output2"].list_outputs() == ["sl_output2"]
        assert parts[1].list_outputs() == ["sl_output1"]
        with pytest.raises(Exception):
            parts["nope"]
        g = pkg.sym.Group([parts[2], x * 2, parts[0]])
        assert len(g.list_outputs()) == 3
        assert g.list_outputs()[0] == "sl_output2"
        assert g.list_arguments() == ["x"]
    rng = np.random.default_rng(4)
    arrays = {"x": _rand(rng, 2, 6)}

    def build(pkg):
        x = pkg.sym.Variable("x")
        parts = list(pkg.sym.SliceChannel(x, num_outputs=3))
        return pkg.sym.Group([parts[2], x * 2.0, parts[0]])

    _compare(build, arrays, [_rand(rng, 2, 2), _rand(rng, 2, 6),
                             _rand(rng, 2, 2)])


def test_partial_shape_takes_the_batch_of_the_data():
    """A 0 in a declared shape (the cells' begin states, ``(0, H)``) takes
    the batch from the first known shape, or from ``__batch_size__``."""
    for pkg in (mxt, mxj):
        data = pkg.sym.Variable("data")
        h0 = pkg.sym.Variable("h0", shape=(0, 5))
        net = pkg.sym.FullyConnected(data, num_hidden=5, name="fc") + h0
        args, outs, _ = net.infer_shape(data=(7, 3))
        assert dict(zip(net.list_arguments(), args))["h0"] == (7, 5)
        assert outs == [(7, 5)]
        # time-major data (T, N, C): the caller names the batch
        both = pkg.sym.Group([data * 1.0, h0 * 1.0])
        args, _, _ = both.infer_shape(data=(7, 4, 3), __batch_size__=(4,))
        assert args == [(7, 4, 3), (4, 5)]
        args, _, _ = h0.infer_shape()
        assert args == [None]


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_concat_matches_reference(dim):
    rng = np.random.default_rng(5)
    shapes = [(2, 3, 4)] * 3
    arrays = {f"x{i}": _rand(rng, *s) for i, s in enumerate(shapes)}
    out_shape = list(shapes[0])
    out_shape[dim] *= 3

    def build(pkg):
        return pkg.sym.Concat(*[pkg.sym.Variable(n) for n in arrays],
                              dim=dim)

    _compare(build, arrays, [_rand(rng, *out_shape)])
    sym = build(mxt)
    assert sym.list_arguments() == ["x0", "x1", "x2"]
    assert sym.infer_shape(**{n: a.shape for n, a in arrays.items()})[1] \
        == [tuple(out_shape)]


@pytest.mark.parametrize("axis,squeeze,alias", [
    (1, False, False), (0, True, False), (2, True, True), (-1, False, True)])
def test_slice_channel_matches_reference(axis, squeeze, alias):
    rng = np.random.default_rng(6)
    shape = (4, 4, 4) if squeeze else (2, 6, 3)
    n = shape[axis]
    arrays = {"x": _rand(rng, *shape)}
    part = list(shape)
    part[axis] = 1
    if squeeze:
        del part[axis]

    def build(pkg):
        op = pkg.sym.split if alias else pkg.sym.SliceChannel
        return op(pkg.sym.Variable("x"), num_outputs=n, axis=axis,
                  squeeze_axis=squeeze)

    (outs, _) = _compare(build, arrays, [_rand(rng, *part)
                                         for _ in range(n)])
    assert all(o.shape == tuple(part) for o in outs)


def test_slice_channel_refuses_an_uneven_split():
    x = mxt.nd.array(np.zeros((2, 5), np.float32), mxt.cpu())
    with pytest.raises(ValueError):
        mxt.nd.SliceChannel(x, num_outputs=2)


@pytest.mark.parametrize("p,is_train", [(0.0, True), (0.5, False),
                                        (0.0, False)])
def test_dropout_identity_matches_reference(p, is_train):
    rng = np.random.default_rng(7)
    arrays = {"x": _rand(rng, 4, 8)}
    got = _compare(lambda pkg: pkg.sym.Dropout(pkg.sym.Variable("x"), p=p),
                   arrays, [_rand(rng, 4, 8)], is_train)
    np.testing.assert_array_equal(got[0][0], arrays["x"])


@pytest.fixture
def fed_masks(monkeypatch):
    """Both packages draw their Dropout masks from ``masks`` in order: the
    reference's ``jax.random.bernoulli`` and the port's
    :func:`~mxnet_tpu_torch.ops.nn.keep_mask` are replaced."""
    masks = []
    state = {"j": 0, "t": 0}

    def jax_bernoulli(key, p, shape):
        m = masks[state["j"] % len(masks)]
        state["j"] += 1
        assert m.shape == tuple(shape)
        return jax.numpy.asarray(m)

    def torch_mask(gen, keep, shape, device):
        m = masks[state["t"] % len(masks)]
        state["t"] += 1
        assert m.shape == tuple(shape)
        return torch.from_numpy(m).to(device)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(tnn, "keep_mask", torch_mask)
    return masks


@pytest.mark.parametrize("p", [0.25, 0.5])
def test_dropout_on_a_fed_mask_matches_reference(fed_masks, p):
    rng = np.random.default_rng(8)
    fed_masks.append(rng.random((4, 8)) >= p)
    arrays = {"x": _rand(rng, 4, 8)}
    (outs, grads) = _compare(
        lambda pkg: pkg.sym.Dropout(pkg.sym.Variable("x"), p=p), arrays,
        [_rand(rng, 4, 8)])
    keep = fed_masks[0]
    np.testing.assert_allclose(outs[0], np.where(keep, arrays["x"] / (1 - p),
                                                 0), **OUT)


def test_nd_dropout_draws_from_the_device_generator():
    """``mx.nd.Dropout`` in training draws from ``mx.random``'s generator:
    the same seed gives the same mask again."""
    x = mxt.nd.ones((64, 64), mxt.cpu())
    draws = []
    for _ in range(2):
        mxt.random.seed(3)
        draws.append(mxt.nd.Dropout(x, p=0.5, is_train=True).asnumpy())
    np.testing.assert_array_equal(draws[0], draws[1])
    assert set(np.unique(draws[0])) == {0.0, 2.0}
    np.testing.assert_array_equal(
        mxt.nd.Dropout(x, p=0.5).asnumpy(), x.asnumpy())


# ---------------------------------------------------------------------------
# the per-node generator


def _masks(first_random, seed=5, shape=(32, 48)):
    """Train-forward outputs of two Dropout nodes of equal shape over ones,
    after a first node that draws (``_sample_uniform``) or does not
    (``_zeros``) at the same place in the graph."""
    sym = mxt.sym
    first = (sym.uniform(shape=shape, name="first") if first_random
             else sym._zeros(shape=shape, name="first"))
    x = sym.Variable("x")
    net = sym.Group([first, sym.Dropout(x, p=0.5, name="da"),
                     sym.Dropout(x, p=0.5, name="db")])
    ctx = mxt.cpu()
    ex = net.bind(ctx, {"x": mxt.nd.ones(shape, ctx)},
                  args_grad={"x": mxt.nd.zeros(shape, ctx)})
    mxt.random.seed(seed)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    return outs[1:], ex


def test_dropout_nodes_draw_from_their_own_generators():
    """Two Dropout nodes of equal shape get different masks; their masks do
    not change when a node before them in the walk draws numbers (in place
    of one that draws none); the same seed gives the same masks."""
    (a, b), _ = _masks(False)
    (a2, b2), _ = _masks(True)
    (a3, b3), _ = _masks(False)
    assert (a != b).mean() > 0.3
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(b, b2)
    np.testing.assert_array_equal(a, a3)
    (a4, _), _ = _masks(False, seed=6)
    assert (a != a4).mean() > 0.3


def test_dropout_keep_share_and_scale():
    """Kept share within 4 sigma of 1 - p; kept values scaled by 1/(1-p)."""
    shape, p = (256, 512), 0.3
    ctx = mxt.cpu()
    x = mxt.sym.Variable("x")
    ex = mxt.sym.Dropout(x, p=p).bind(
        ctx, {"x": mxt.nd.ones(shape, ctx)},
        args_grad={"x": mxt.nd.zeros(shape, ctx)})
    out = ex.forward(is_train=True)[0].asnumpy()
    n = out.size
    kept = (out != 0).mean()
    assert abs(kept - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
    np.testing.assert_allclose(np.unique(out), [0.0, 1 / (1 - p)], rtol=1e-6)


def test_backward_out_grads_replays_the_forward_masks():
    """``backward(out_grads)`` differentiates the masks of the forward the
    caller saw: the gradient of each Dropout is its output's mask over
    ones, scaled."""
    (a, b), ex = _masks(False)
    shape = a.shape
    ctx = mxt.cpu()
    heads = [mxt.nd.zeros(shape, ctx), mxt.nd.ones(shape, ctx),
             mxt.nd.ones(shape, ctx)]
    ex.backward(heads)
    np.testing.assert_allclose(ex.grad_dict["x"].asnumpy(), a + b, **OUT)
    ex.backward(heads)
    np.testing.assert_allclose(ex.grad_dict["x"].asnumpy(), a + b, **OUT)
