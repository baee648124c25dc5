"""The port's NDArray surface and module functions against the JAX package's
``mxnet_tpu.nd`` on the same numpy inputs, on the CPU: properties, copies,
views, indexing, writes (which rebind, as the JAX package's immutable
payload does, so a write to a slice or alias never shows in its parent),
arithmetic and comparison dtypes, in-place operators, reductions, the
module-level helpers, the imperative op namespace, random, storage and
context."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

C = mxt.cpu()


def _pair(a):
    a = np.asarray(a)
    return mxj.nd.array(a, dtype=a.dtype), mxt.nd.array(a, C, dtype=a.dtype)


def _same(got, want, rtol=1e-6):
    """``got`` (port) equals ``want`` (JAX package) in value, shape, dtype."""
    g = got.asnumpy() if isinstance(got, mxt.nd.NDArray) else np.asarray(got)
    w = want.asnumpy() if isinstance(want, mxj.nd.NDArray) else \
        np.asarray(want)
    assert g.shape == w.shape
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7)


X = np.arange(24, dtype=np.float32).reshape(2, 3, 4) * 0.5 - 3
I = np.arange(-6, 6, dtype=np.int32).reshape(3, 4)

UNARY_VIEWS = [
    ("T", lambda a: a.T), ("transpose", lambda a: a.transpose((1, 0, 2))),
    ("reshape", lambda a: a.reshape((0, -1))),
    ("broadcast_to", lambda a: a[:1].broadcast_to((3, 3, 4))),
    ("expand_dims", lambda a: a.expand_dims(1)),
    ("flatten", lambda a: a.flatten()), ("slice", lambda a: a.slice(1, 2)),
    ("at", lambda a: a.at(1)), ("getitem_int", lambda a: a[1]),
    ("getitem_slice", lambda a: a[:, 1:3]),
    ("getitem_tuple", lambda a: a[1, :, ::2]),
    ("astype_int", lambda a: a.astype("int32")),
    ("astype_f16", lambda a: a.astype(np.float16)),
    ("copy", lambda a: a.copy()), ("abs", lambda a: a.abs()),
    ("neg", lambda a: -a),
    ("sum", lambda a: a.sum()), ("sum_axis", lambda a: a.sum(axis=1)),
    ("max", lambda a: a.max(axis=(0, 2), keepdims=True)),
    ("min", lambda a: a.min()), ("mean", lambda a: a.mean(axis=-1)),
]


@pytest.mark.parametrize("name,fn", UNARY_VIEWS, ids=[u[0] for u in UNARY_VIEWS])
def test_unary_surface(name, fn):
    j, t = _pair(X)
    _same(fn(t), fn(j))


@pytest.mark.parametrize("name", ["sum", "max", "min", "mean"])
def test_int_reductions_keep_reference_dtype(name):
    j, t = _pair(I)
    _same(getattr(t, name)(), getattr(j, name)())


def test_properties():
    j, t = _pair(X)
    assert t.shape == j.shape and t.size == j.size == 24
    assert t.ndim == j.ndim and len(t) == len(j)
    assert t.context == C and t.ctx == C
    assert t.dtype == torch.float32
    s_j, s_t = _pair(np.array([2.5], np.float32))
    assert s_t.asscalar() == s_j.asscalar() == 2.5
    assert float(s_t) == 2.5 and int(s_t) == 2 and bool(s_t)
    with pytest.raises(mxt.MXNetError):
        t.asscalar()
    np.testing.assert_array_equal(np.asarray(t), X)
    t.wait_to_read()


BINOPS = [
    ("add", lambda a, b: a + b), ("radd", lambda a, b: b + a),
    ("sub", lambda a, b: a - b), ("rsub", lambda a, b: b - a),
    ("mul", lambda a, b: a * b), ("rmul", lambda a, b: b * a),
    ("div", lambda a, b: a / b), ("rdiv", lambda a, b: b / a),
    ("mod", lambda a, b: a % b), ("pow", lambda a, b: a ** b),
    ("eq", lambda a, b: a == b), ("ne", lambda a, b: a != b),
    ("gt", lambda a, b: a > b), ("ge", lambda a, b: a >= b),
    ("lt", lambda a, b: a < b), ("le", lambda a, b: a <= b),
]
# (lhs, rhs) where rhs is an array (wrapped) or a Python scalar
OPERANDS = {
    "f32_f32": (X[0], X[1] * 0.7 + 0.1),
    "f32_int": (X[0], 3),
    "f32_float": (X[0], -1.5),
    "i32_i32": (I, I[::-1] + 7),
    "i32_int": (I, 4),
    "i32_float": (I, 2.5),
    "i32_neg_int": (I, -4),
}


def _binop_params():
    # integer ** a negative or fractional scalar is an error in both
    return [pytest.param(op, fn, k, id=f"{k}-{op}")
            for k in OPERANDS for op, fn in BINOPS
            if not (op == "pow" and k in ("i32_float", "i32_neg_int"))]


@pytest.mark.parametrize("op,fn,operands", _binop_params())
def test_binops_values_and_dtypes(op, fn, operands):
    lhs, rhs = OPERANDS[operands]
    if op in ("rdiv", "div", "mod") and operands == "f32_f32":
        lhs = lhs + 7.0
    j, t = _pair(lhs)
    if np.isscalar(rhs):
        rj = rt = rhs
    else:
        rj, rt = _pair(rhs)
    if op == "pow" and operands == "f32_f32":
        j, t = _pair(np.abs(lhs) + 0.5)
    _same(fn(t, rt), fn(j, rj), rtol=1e-6)


def test_comparison_with_other_type_is_not_implemented():
    _, t = _pair(X)
    assert (t == "x") is False
    assert (t != None) is True  # noqa: E711


INPLACE = [("iadd", "__iadd__"), ("isub", "__isub__"), ("imul", "__imul__"),
           ("itruediv", "__itruediv__")]


@pytest.mark.parametrize("name,method", INPLACE, ids=[i[0] for i in INPLACE])
@pytest.mark.parametrize("other", ["array", "scalar"])
def test_inplace_ops_rebind_and_leave_views(name, method, other):
    """In-place operators compute the JAX package's value; an array taken
    from the NDArray before the write (a view here) keeps the old value,
    as the JAX package's immutable payload does."""
    j, t = _pair(X)
    view_t, view_j = t[0], j[0]
    rj, rt = _pair(X * 0.5 + 4) if other == "array" else (2.0, 2.0)
    res_t = getattr(t, method)(rt)
    res_j = getattr(j, method)(rj)
    assert res_t is t and res_j is j
    _same(t, j)
    _same(view_t, view_j)
    np.testing.assert_array_equal(view_t.asnumpy(), X[0])


@pytest.mark.parametrize("key", [
    slice(None), 1, (0, slice(1, 3)), (slice(None), 2, slice(0, 4, 2))],
    ids=["all", "int", "tuple", "stepped"])
@pytest.mark.parametrize("value", ["scalar", "numpy", "ndarray"])
def test_setitem_matches_and_never_writes_through(key, value):
    j, t = _pair(X)
    views_t = [t.slice(0, 1), t.reshape((6, 4)), t[0], t.T]
    olds = [v.asnumpy().copy() for v in views_t]
    shape = np.empty(X.shape)[key].shape
    if value == "scalar":
        vj = vt = 9.0
    elif value == "numpy":
        vj = vt = np.full(shape, -2.0, np.float32)
    else:
        vj, vt = _pair(np.full(shape, 5.0, np.float32))
    j[key] = vj
    t[key] = vt
    _same(t, j)
    for v, old in zip(views_t, olds):
        np.testing.assert_array_equal(v.asnumpy(), old)


def test_slice_write_does_not_change_parent():
    """No write-through either way: a write to a slice leaves the parent,
    a write to the parent leaves the slice (the JAX package too)."""
    for nd, ctx in ((mxj.nd, None), (mxt.nd, C)):
        a = nd.array(X) if ctx is None else nd.array(X, ctx)
        s = a.slice(0, 1)
        s[:] = 100.0
        np.testing.assert_array_equal(a.asnumpy(), X)
        a[:] = -1.0
        np.testing.assert_array_equal(s.asnumpy(), np.full((1, 3, 4), 100.0))


def test_alias_copy_copyto_and_read_only():
    _, a = _pair(X)
    _, b = _pair(X * 2)
    assert a.alias(b) is a
    np.testing.assert_array_equal(a.asnumpy(), X * 2)
    a[:] = 0.0          # rebinds a only
    np.testing.assert_array_equal(b.asnumpy(), X * 2)
    with pytest.raises(mxt.MXNetError, match="shape"):
        a.alias(mxt.nd.zeros((2,), C))
    with pytest.raises(mxt.MXNetError, match="dtype"):
        a.alias(mxt.nd.zeros(X.shape, C, dtype="int32"))
    c = b.copy()
    c[:] = 1.0
    np.testing.assert_array_equal(b.asnumpy(), X * 2)
    dst = mxt.nd.zeros(X.shape, C, dtype="int32")
    assert b.copyto(dst) is dst
    assert dst.dtype == torch.int32
    np.testing.assert_array_equal(dst.asnumpy(), (X * 2).astype(np.int32))
    moved = b.copyto(C)
    assert moved is not b and moved.context == C
    with pytest.raises(mxt.MXNetError, match="shape"):
        b.copyto(mxt.nd.zeros((3,), C))
    with pytest.raises(TypeError):
        b.copyto("cpu")
    ro = mxt.nd.NDArray(torch.zeros(X.shape), writable=False)
    for write in (lambda: ro.__setitem__(slice(None), 1.0),
                  lambda: ro.__iadd__(1.0), lambda: b.copyto(ro)):
        with pytest.raises(mxt.MXNetError, match="read-only"):
            write()


def test_factories_match_jax():
    _same(mxt.nd.ones((2, 3), C), mxj.nd.ones((2, 3)))
    _same(mxt.nd.ones(4, C, dtype="int32"), mxj.nd.ones(4, dtype="int32"))
    _same(mxt.nd.full((2, 2), 7.5, C), mxj.nd.full((2, 2), 7.5))
    _same(mxt.nd.arange(5, ctx=C), mxj.nd.arange(5))
    _same(mxt.nd.arange(1, 4, 0.5, repeat=2, ctx=C),
          mxj.nd.arange(1, 4, 0.5, repeat=2))
    _same(mxt.nd.arange(0, 6, 2, ctx=C, dtype="int32"),
          mxj.nd.arange(0, 6, 2, dtype="int32"))
    (j1, t1), (j2, t2) = _pair(X), _pair(X + 1)
    _same(mxt.nd.concatenate([t1, t2], axis=1),
          mxj.nd.concatenate([j1, j2], axis=1))
    _same(mxt.nd.moveaxis(t1, 0, -1), mxj.nd.moveaxis(j1, 0, -1))
    idx_j, idx_t = _pair(np.array([0, 3, 1], np.float32))
    out_j, out_t = mxj.nd.zeros((3, 4)), mxt.nd.zeros((3, 4), C)
    assert mxt.nd.onehot_encode(idx_t, out_t) is out_t
    _same(out_t, mxj.nd.onehot_encode(idx_j, out_j))
    got = mxt.nd.bulk_asnumpy([t1, np.ones(2)])
    np.testing.assert_array_equal(got[0], X)
    np.testing.assert_array_equal(got[1], np.ones(2))


MODULE_FNS = ["add", "subtract", "multiply", "divide", "true_divide",
              "power", "maximum", "minimum", "equal", "not_equal",
              "greater", "greater_equal", "lesser", "lesser_equal"]


@pytest.mark.parametrize("fn", MODULE_FNS)
@pytest.mark.parametrize("form", ["nd_nd", "nd_scalar", "scalar_nd",
                                  "scalar_scalar", "int_float"])
def test_module_functions_match_jax(fn, form):
    a = np.abs(X[0]) + 0.5
    b = X[1] * 0.3 + 1.0
    if form == "nd_nd":
        (ja, ta), (jb, tb) = _pair(a), _pair(b)
    elif form == "nd_scalar":
        (ja, ta), jb = _pair(a), 2.0
        tb = jb
    elif form == "scalar_nd":
        ja, (jb, tb) = 3.0, _pair(b)
        ta = ja
    elif form == "int_float":
        (ja, ta), jb = _pair(I), 0.5
        tb = jb
    else:
        ja = ta = 3.0
        jb = tb = 2.0
    got = getattr(mxt.nd, fn)(ta, tb)
    want = getattr(mxj.nd, fn)(ja, jb)
    if form == "scalar_scalar":
        assert got == want
    else:
        _same(got, want)


def test_negative():
    j, t = _pair(X)
    _same(mxt.nd.negative(t), mxj.nd.negative(j))


def test_imperative_ops_and_aux_free_updates():
    """``mx.nd.<op>`` runs the op eagerly; the update ops return new arrays
    and leave their inputs, as the JAX package's do."""
    (jw, tw), (jg, tg), (jm, tm) = _pair(X), _pair(X * 0.1), _pair(X * 0)
    kw = dict(lr=0.1, momentum=0.9, wd=1e-3)
    tw2, tm2 = mxt.nd.sgd_mom_update(tw, tg, tm, **kw)
    jw2, jm2 = mxj.nd.sgd_mom_update(jw, jg, jm, **kw)
    _same(tw2, jw2)
    _same(tm2, jm2)
    _same(tw, jw)
    assert tw2.data.data_ptr() != tw.data.data_ptr()
    _same(mxt.nd.dot(tw.reshape((6, 4)), tw.reshape((6, 4)),
                     transpose_b=True),
          mxj.nd.dot(jw.reshape((6, 4)), jw.reshape((6, 4)),
                     transpose_b=True))
    _same(mxt.nd.topk(tw.reshape((-1,)), k=3, ret_typ="value"),
          mxj.nd.topk(jw.reshape((-1,)), k=3, ret_typ="value"))
    # keyword NDArray inputs and a name are accepted
    _same(mxt.nd.elemwise_add(lhs=tw, rhs=tg, name="x"),
          mxj.nd.elemwise_add(lhs=jw, rhs=jg, name="x"))
    with pytest.raises(mxt.MXNetError, match="given twice"):
        mxt.nd.elemwise_add(tw, lhs=tg)
    with pytest.raises(mxt.MXNetError, match="not registered"):
        mxt.ops.imperative_invoke("no_such_op", tw)


def test_no_input_ops_place_on_ctx():
    z = mxt.nd._zeros(shape=(2, 3), ctx=C)
    assert z.context == C and z.shape == (2, 3)
    with C:
        o = mxt.nd._ones(shape=(2,))
    assert o.context == C
    u = mxt.random.uniform(0, 1, (3,), ctx=C)
    assert u.context == C and u.dtype == torch.float32


def test_no_input_ops_default_to_the_card(monkeypatch):
    """Without ``ctx``, an op with no inputs goes to gpu(0): without a card
    it raises rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mxt.nd._zeros(shape=(2,)),
                 lambda: mxt.random.normal(shape=(2,)),
                 lambda: mxt.random.randint(0, 4, (2,))):
        with pytest.raises(mxt.MXNetError, match="CUDA"):
            call()


def test_random_module_distribution_and_seed():
    mxt.random.seed(11)
    u = mxt.random.uniform(-2.0, 2.0, (200000,), ctx=C).asnumpy()
    n = mxt.random.normal(1.0, 0.5, (200000,), ctx=C).asnumpy()
    r = mxt.random.randint(3, 9, (200000,), ctx=C)
    assert u.dtype == np.float32 and n.dtype == np.float32
    assert r.dtype == torch.int32
    assert u.min() >= -2.0 and u.max() < 2.0 and abs(u.mean()) < 0.02
    assert abs(u.var() - 16 / 12) < 0.02
    assert abs(n.mean() - 1.0) < 0.01 and abs(n.std() - 0.5) < 0.01
    rv = r.asnumpy()
    assert rv.min() == 3 and rv.max() == 8
    mxt.random.seed(11)
    np.testing.assert_array_equal(
        mxt.random.uniform(-2.0, 2.0, (200000,), ctx=C).asnumpy(), u)


def test_random_device_streams_differ():
    """Each device's generator has its own seed: cuda:0 and cuda:1 (and the
    CPU) draw unrelated streams from one global seed."""
    from mxnet_tpu_torch.random import _device_seed

    seeds = {_device_seed(5, torch.device(d))
             for d in ("cpu", "cuda:0", "cuda:1", "cuda:2")}
    assert len(seeds) == 4
    assert _device_seed(5, torch.device("cuda:0")) == \
        _device_seed(5, torch.device("cuda:0"))
    assert _device_seed(5, torch.device("cpu")) != \
        _device_seed(6, torch.device("cpu"))


def test_storage_cpu():
    import gc

    gc.collect()   # no collection of older garbage inside the window
    before = mxt.storage.live_bytes()
    keep = mxt.nd.zeros((1024, 256), C)
    view = keep.reshape((-1,))
    grown = mxt.storage.live_bytes() - before
    assert grown >= 1024 * 256 * 4
    assert grown < 2 * 1024 * 256 * 4      # the view adds no storage
    per = mxt.storage.live_bytes_per_device()
    assert per["cpu(0)"] >= 1024 * 256 * 4
    info = mxt.storage.memory_info(C)
    assert set(info["cpu(0)"]) == {"bytes_in_use", "peak_bytes_in_use",
                                   "bytes_limit"}
    assert info["cpu(0)"]["bytes_in_use"] >= 1024 * 256 * 4
    del keep, view
    mxt.storage.gc()


def test_context_rest():
    assert mxt.num_gpus() == torch.cuda.device_count()
    pinned = mxt.Context("cpu_pinned", 0)
    assert repr(pinned) == "cpu_pinned(0)"
    assert pinned.torch_device == torch.device("cpu")
    assert pinned != mxt.cpu()
    assert mxt.current_context() == mxt.gpu(0)
    with mxt.cpu():
        assert mxt.current_context() == mxt.cpu()
