"""The ResNet slice's ops and symbols against the JAX package on the CPU:
the ``Convolution``, ``Pooling`` and ``BatchNorm`` bodies (outputs, new aux
and gradients against ``jax.vjp``, fp32 and bf16), a bottleneck and a basic
``residual_unit`` through each package's Executor, and the ResNet symbols'
names and shapes (``tests/test_torch_fit.py`` trains ResNet-8 through both
packages' ``Module``). Inputs, weights and head gradients are made with
numpy and fed to both.

Limits: fp32 outputs and aux within 1e-5 of the reference's max-abs,
gradients within 1e-4; bf16 outputs of the reference's dtype, outputs and
gradients within 2e-2 (see :func:`_grad_gap`). The reference runs as
``test_torch_module.py`` runs it (``MXNET_GRAPHOPT=0``,
``MXTPU_FUSED_GRADS=1``, no parameter donation). ``PYTHONPATH=. python
tests/test_torch_resnet.py`` prints a bf16 bottleneck's gradient gaps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import ops as jops
from mxnet_tpu.ops.registry import OpCtx as JOpCtx
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch.ops.registry import OpCtx as TOpCtx

LIMITS = {"float32": dict(out=1e-5, grad=1e-4, aux=1e-5),
          "bfloat16": dict(out=2e-2, grad=2e-2, aux=1e-5)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs: the tier-1 run puts six test
    workers on the host's cores, and thread pools of one thread a core in
    each oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")
    monkeypatch.setenv("MXTPU_FUSED_GRADS", "1")
    monkeypatch.delenv("MXTPU_DONATE_PARAMS", raising=False)


def _rel_err(got, want):
    """Max abs difference over the reference's max-abs; infinities must
    sit at the same places with the same sign (a max-pool window that lies
    in the padding) and are left out."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    inf = np.isinf(want)
    assert np.array_equal(inf, np.isinf(got))
    assert np.array_equal(got[inf], want[inf])
    got, want = got[~inf], want[~inf]
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _run_op(name, attrs, inputs, aux=(), dtype="float32", is_train=True,
            seed=0):
    """Output, new aux and input gradients (for a random head gradient) of
    one op in both packages; float inputs enter as fp32 and are cast to
    ``dtype`` inside, so the gradients arrive in fp32."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jfn(*xs):
        xs = [x.astype(jdt) if jnp.issubdtype(x.dtype, jnp.floating) else x
              for x in xs]
        outs, new_aux = jops.get_op(name).normalized_call(
            JOpCtx(is_train=is_train), attrs, xs,
            [jnp.asarray(a) for a in aux])
        return outs[0], new_aux

    j_out, vjp, j_aux = jax.vjp(jfn, *(jnp.asarray(a) for a in inputs),
                                has_aux=True)
    head = np.random.default_rng(seed).standard_normal(j_out.shape)
    j_grads = vjp(jnp.asarray(head, j_out.dtype))

    leaves = [torch.from_numpy(a).requires_grad_(a.dtype == np.float32)
              for a in inputs]
    xs = [x.to(tdt) if x.is_floating_point() else x for x in leaves]
    outs, t_aux = tops.get_op(name).normalized_call(
        TOpCtx(is_train=is_train, device=torch.device("cpu")), attrs, xs,
        [torch.from_numpy(a) for a in aux])
    t_out = outs[0]
    diff = [x for x in leaves if x.requires_grad]
    t_grads = torch.autograd.grad(t_out, diff,
                                  torch.from_numpy(head).to(t_out.dtype),
                                  allow_unused=True)
    t_grads = [np.zeros(x.shape, np.float32) if g is None else g.numpy()
               for x, g in zip(diff, t_grads)]
    j_grads = [np.asarray(g) for x, g in zip(inputs, j_grads)
               if x.dtype == np.float32]
    assert str(t_out.dtype).split(".")[1] == str(j_out.dtype), \
        (t_out.dtype, j_out.dtype)
    return ((t_out.detach().float().numpy(), np.asarray(
        j_out.astype(jnp.float32))),
            [(a.numpy(), np.asarray(b)) for a, b in zip(t_aux, j_aux)],
            list(zip(t_grads, j_grads)))


def _grad_gap(got, want, exact, dtype):
    """The gap of a gradient to the reference's. In bf16 the gap to the
    fp32 result (``exact``, the reference's) may stand in for it: a gradient
    no further from the fp32 one than the reference's bf16 gradient is,
    plus the limit, counts as within the limit. The reference rounds its
    bf16 backward at every op and sums some reductions (bias and gamma
    gradients) in bf16, where torch sums in fp32: through three BatchNorms
    both packages' bf16 gradients sit up to 0.23 of max-abs off fp32, and
    2.6e-2 off each other (gamma of a bottleneck's second BatchNorm)."""
    gap = _rel_err(got, want)
    lim = LIMITS[dtype]["grad"]
    if dtype != "float32" and gap > lim \
            and _rel_err(got, exact) <= _rel_err(want, exact) + lim:
        return lim
    return gap


def _check(name, attrs, inputs, aux=(), dtype="float32", is_train=True):
    lim = LIMITS[dtype]
    out, new_aux, grads = _run_op(name, attrs, inputs, aux, dtype, is_train)
    exact = grads
    if dtype != "float32" and max([_rel_err(*g) for g in grads],
                                  default=0.0) > lim["grad"]:
        exact = _run_op(name, attrs, inputs, aux, "float32", is_train)[2]
    gaps = {"out": _rel_err(*out),
            "aux": max([_rel_err(*a) for a in new_aux], default=0.0),
            "grad": max([_grad_gap(t, j, e, dtype)
                         for (t, j), (_, e) in zip(grads, exact)],
                        default=0.0)}
    for key, gap in gaps.items():
        assert gap <= lim[key], (key, gaps)
    return out, new_aux, grads


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Convolution


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attrs", [
    dict(kernel=(3, 3), num_filter=6, pad=(1, 1)),
    dict(kernel=(3, 3), num_filter=6, stride=(2, 2), no_bias=True),
    dict(kernel=(3, 3), num_filter=6, pad=(2, 2), dilate=(2, 2)),
    dict(kernel=(1, 1), num_filter=6, num_group=2, stride=(2, 2)),
    dict(kernel=(3, 3), num_filter=6, pad=(1, 1), stride=(2, 2),
         layout="NHWC", workspace=512),
    dict(kernel=(7, 7), num_filter=4, pad=(3, 3), stride=(2, 2),
         no_bias=True, layout="NHWC")], ids=lambda a: "-".join(
             f"{k}{v}" for k, v in a.items()))
def test_convolution_matches_reference(attrs, dtype):
    rng = np.random.default_rng(1)
    nhwc = attrs.get("layout") == "NHWC"
    data = _rand(rng, *((2, 9, 9, 4) if nhwc else (2, 4, 9, 9)))
    kh, kw = attrs["kernel"]
    cin = 4 // attrs.get("num_group", 1)
    weight = _rand(rng, *((6, kh, kw, cin) if nhwc else (6, cin, kh, kw)),
                   scale=0.3)[:attrs["num_filter"]]
    inputs = [data, weight]
    if not attrs.get("no_bias"):
        inputs.append(_rand(rng, attrs["num_filter"]))
    _check("Convolution", attrs, inputs, dtype=dtype)


def test_convolution_nhwc_equals_nchw():
    """NHWC data and OHWI weights give the NCHW path's numbers, permuted."""
    rng = np.random.default_rng(2)
    x, w, b = _rand(rng, 2, 4, 8, 8), _rand(rng, 5, 4, 3, 3), _rand(rng, 5)
    attrs = dict(kernel=(3, 3), num_filter=5, pad=(1, 1), stride=(2, 2))
    op = tops.get_op("Convolution").fn
    nchw = op(TOpCtx(), attrs, *map(torch.from_numpy, (x, w, b)))
    nhwc = op(TOpCtx(), dict(attrs, layout="NHWC"),
              torch.from_numpy(x.transpose(0, 2, 3, 1)),
              torch.from_numpy(w.transpose(0, 2, 3, 1)), torch.from_numpy(b))
    np.testing.assert_allclose(nhwc.permute(0, 3, 1, 2).numpy(),
                               nchw.numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Pooling


def _relu_with_zero_windows(rng, shape):
    """ReLU output with some 2x2 windows all zeros (tied maxima)."""
    x = np.maximum(_rand(rng, *shape), 0.0)
    x[:, :, 0:2, 0:2] = 0.0
    x[:, :, 2:4, 4:6] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attrs,shape", [
    (dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
     (2, 3, 9, 9)),
    (dict(pool_type="avg", kernel=(2, 2), stride=(2, 2)), (2, 3, 8, 8)),
    (dict(pool_type="sum", kernel=(3, 3), stride=(1, 1), pad=(1, 1)),
     (2, 3, 7, 7)),
    (dict(pool_type="avg", kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
     (2, 3, 7, 7)),
    # full, where torch's ceil_mode would keep fewer windows: 5 + 2 pad,
    # kernel 2 stride 2 gives 4 windows here, the last in the padding
    (dict(pool_type="avg", kernel=(2, 2), stride=(2, 2), pad=(1, 1),
          pooling_convention="full"), (2, 3, 5, 5)),
    (dict(pool_type="max", kernel=(2, 2), stride=(2, 2), pad=(1, 1),
          pooling_convention="full"), (2, 3, 5, 5)),
    (dict(pool_type="max", kernel=(3, 3), stride=(2, 2),
          pooling_convention="full"), (2, 3, 6, 6)),
    (dict(pool_type="sum", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
          pooling_convention="full"), (2, 3, 8, 8)),
    # padding wider than half a window (torch's own padding refuses it)
    (dict(pool_type="max", kernel=(3, 3), stride=(1, 1), pad=(2, 2)),
     (1, 2, 5, 5)),
    (dict(pool_type="avg", global_pool=True, kernel=(7, 7)), (2, 3, 7, 7)),
    (dict(pool_type="max", global_pool=True, kernel=(1, 1)), (2, 3, 5, 5)),
    (dict(pool_type="sum", global_pool=True, kernel=(1, 1)), (2, 3, 5, 5)),
    (dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
          layout="NHWC"), (2, 9, 9, 3)),
    (dict(pool_type="avg", global_pool=True, kernel=(7, 7), layout="NHWC"),
     (2, 5, 5, 3)),
    # tied maxima: windows of zeros after a ReLU
    (dict(pool_type="max", kernel=(2, 2), stride=(2, 2), tied=True),
     (2, 3, 8, 8)),
    (dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
          tied=True), (2, 3, 8, 8)),
    (dict(pool_type="max", global_pool=True, kernel=(1, 1), tied=True),
     (2, 3, 8, 8))], ids=str)
def test_pooling_matches_reference(attrs, shape, dtype):
    rng = np.random.default_rng(3)
    attrs = dict(attrs)
    data = _relu_with_zero_windows(rng, shape) if attrs.pop("tied", False) \
        else _rand(rng, *shape)
    _check("Pooling", attrs, [data], dtype=dtype)


def test_pooling_full_keeps_the_window_ceil_mode_drops():
    """The ``full`` case above has one more window than torch's
    ``ceil_mode`` gives."""
    x = torch.zeros(1, 1, 5, 5)
    got = tops.get_op("Pooling").fn(
        TOpCtx(), dict(pool_type="avg", kernel=(2, 2), stride=(2, 2),
                       pad=(1, 1), pooling_convention="full"), x)
    ceil = torch.nn.functional.avg_pool2d(x, 2, 2, 1, ceil_mode=True)
    assert got.shape[-1] == 4 and ceil.shape[-1] == 3


def test_max_pool_of_int32():
    """Integer max pooling, padded with the integers' least value."""
    x = np.arange(-20, 16, dtype=np.int32).reshape(1, 1, 6, 6)
    for attrs in (dict(pool_type="max", kernel=(3, 3), stride=(2, 2),
                       pad=(1, 1)),
                  dict(pool_type="max", kernel=(2, 2), stride=(2, 2),
                       pad=(1, 1), pooling_convention="full")):
        want = jops.get_op("Pooling").fn(JOpCtx(), attrs, jnp.asarray(x))
        got = tops.get_op("Pooling").fn(TOpCtx(), attrs, torch.from_numpy(x))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# BatchNorm


def _bn_inputs(rng, shape, axis=1):
    c = shape[axis]
    data = _rand(rng, *shape, scale=2.0) + 0.5
    return ([data, _rand(rng, c) + 1.0, _rand(rng, c)],
            [_rand(rng, c), np.abs(_rand(rng, c)) + 0.5])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attrs,shape,is_train", [
    (dict(fix_gamma=False, eps=2e-5, momentum=0.9), (4, 3, 5, 5), True),
    (dict(fix_gamma=True, eps=2e-5), (4, 3, 5, 5), True),
    (dict(fix_gamma=False), (4, 3, 5, 5), False),
    (dict(fix_gamma=False, use_global_stats=True), (4, 3, 5, 5), True),
    (dict(fix_gamma=False, axis=3, momentum=0.8), (4, 5, 5, 3), True),
    (dict(fix_gamma=False, axis=-1), (4, 5, 5, 3), False),
    (dict(fix_gamma=False), (8, 6), True)], ids=str)
def test_batch_norm_matches_reference(attrs, shape, is_train, dtype):
    rng = np.random.default_rng(4)
    inputs, aux = _bn_inputs(rng, shape, attrs.get("axis", 1))
    _, new_aux, grads = _check("BatchNorm", attrs, inputs, aux, dtype,
                               is_train)
    moved = is_train and not attrs.get("use_global_stats")
    for (got, _), old in zip(new_aux, aux):
        assert np.array_equal(got, old) != moved
    if attrs.get("fix_gamma"):
        assert not grads[1][0].any() and not grads[1][1].any()


def test_batch_norm_saves_only_its_inputs_and_statistics():
    """The training forward keeps the data, the fp32 mean and 1/std and
    gamma for its backward: no full-size intermediate."""
    x = torch.randn(4, 3, 5, 5, requires_grad=True)
    g, b = torch.ones(3, requires_grad=True), torch.zeros(3,
                                                          requires_grad=True)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        (out,), _ = tops.get_op("BatchNorm").normalized_call(
            TOpCtx(is_train=True), {"fix_gamma": False}, [x, g, b],
            [torch.zeros(3), torch.ones(3)])
    assert sorted(saved) == sorted([(4, 3, 5, 5), (3,), (3,), (3,)])


# ---------------------------------------------------------------------------
# residual unit and the ResNet symbols


def bind_args(symbol, shapes, rng):
    """Random numpy arguments and aux states for ``symbol`` at ``shapes``."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    args = {}
    for n, s in zip(symbol.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        fan_in = np.prod(s[1:]) if len(s) > 1 else 1
        args[n] = _rand(rng, *s, scale=1.0 / np.sqrt(fan_in))
        if n.endswith("_gamma"):
            args[n] += 1.0
    aux = {n: (np.abs(_rand(rng, *s)) + 0.5 if n.endswith("_var")
               else _rand(rng, *s) * 0.1)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


def unit_results(bottle_neck, dim_match, dtype):
    """A residual unit through each package's Executor (the reference also
    in fp32): train forward, gradients of a random head, new aux."""
    rng = np.random.default_rng(5)
    nf, shape = 16, (2, 16 if dim_match else 8, 8, 8)
    stride = (1, 1) if dim_match else (2, 2)
    got = {}
    for pkg in (mxt, mxj):
        got[pkg] = pkg.models.resnet.residual_unit(
            pkg.sym.Variable("data"), nf, stride, dim_match, name="u",
            bottle_neck=bottle_neck)
    args, aux = bind_args(got[mxt], {"data": shape}, rng)
    data = _rand(rng, *shape)
    out_shape = got[mxt].infer_shape(data=shape)[1][0]
    head = _rand(rng, *out_shape)
    res = {}
    for pkg, amp in ((mxt, dtype), (mxj, dtype), (mxj, "float32")):
        ctx = pkg.cpu()
        arrs = {n: pkg.nd.array(a, ctx) for n, a in args.items()}
        arrs["data"] = pkg.nd.array(data, ctx)
        grads = {n: pkg.nd.zeros(a.shape, ctx) for n, a in arrs.items()}
        ex = pkg.executor.Executor(
            got[pkg], ctx, arrs, grads, "write",
            [pkg.nd.array(aux[n], ctx)
             for n in got[pkg].list_auxiliary_states()],
            amp_dtype=None if amp == "float32" else amp)
        out = ex.forward(is_train=True)[0].asnumpy().astype(np.float32)
        ex.backward([pkg.nd.array(head, ctx, dtype=amp)])
        res[pkg, amp] = (
            out, {n: g.asnumpy() for n, g in ex.grad_dict.items()},
            {n: a.asnumpy() for n, a in ex.aux_dict.items()})
    return res, aux


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bottle_neck,dim_match", [
    (True, False), (True, True), (False, False)])
def test_residual_unit_matches_reference(bottle_neck, dim_match, dtype):
    """A residual unit through each package's Executor: train forward,
    gradients of a random head and the new aux; stride 2 with the 1x1
    shortcut convolution, or the identity shortcut; bottleneck or basic."""
    res, aux = unit_results(bottle_neck, dim_match, dtype)
    lim = LIMITS[dtype]
    (t_out, t_g, t_aux), (j_out, j_g, j_aux) = res[mxt, dtype], \
        res[mxj, dtype]
    exact = res[mxj, "float32"][1]
    assert _rel_err(t_out, j_out) <= lim["out"]
    for n in j_g:
        assert _grad_gap(t_g[n], j_g[n], exact[n], dtype) <= lim["grad"], n
    # past the first BatchNorm the statistics are of bf16 activations that
    # differ by rounding: held to the output limit
    aux_lim = lim["aux"] if dtype == "float32" else lim["out"]
    for n in j_aux:
        assert _rel_err(t_aux[n], j_aux[n]) <= aux_lim, n
        assert not np.array_equal(t_aux[n], aux[n]), n


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet50_symbol_names_and_shapes(layout):
    shape = (2, 3, 224, 224) if layout == "NCHW" else (2, 224, 224, 3)
    syms = [pkg.models.resnet.get_symbol(1000, 50, "3,224,224", layout=layout)
            for pkg in (mxt, mxj)]
    t, j = syms
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    assert len(t.list_auxiliary_states()) == 2 * 51
    t_shapes = t.infer_shape(data=shape, softmax_label=(2,))
    j_shapes = j.infer_shape(data=shape, softmax_label=(2,))
    for a, b in zip(t_shapes, j_shapes):
        assert [tuple(s) for s in a] == [tuple(s) for s in b]
    n_params = sum(int(np.prod(s)) for n, s in zip(t.list_arguments(),
                                                     t_shapes[0])
                   if n not in ("data", "softmax_label"))
    assert n_params == 25_549_486


@pytest.mark.parametrize("kw", [
    dict(num_layers=20, image_shape="3,32,32"),
    dict(num_layers=164, image_shape="3,28,28"),
    dict(num_layers=18, image_shape="3,32,32"),
    dict(num_layers=34, image_shape="3,64,64", layout="NHWC")], ids=str)
def test_resnet_depths_match_reference(kw):
    t = mxt.models.resnet.get_symbol(10, **kw)
    j = mxj.models.resnet.get_symbol(10, **kw)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert mxt.models.get_model("resnet") is mxt.models.resnet


def test_space_to_depth_stem_is_not_ported():
    with pytest.raises(mxt.MXNetError, match="not ported"):
        mxt.models.resnet.get_symbol(10, 50, "3,64,64", layout="NHWC",
                                     conv0_space_to_depth=True)


if __name__ == "__main__":
    # the bf16 gaps that _grad_gap's docstring cites: per gradient array,
    # the port against the reference, and each against the reference's fp32
    _res, _ = unit_results(True, True, "bfloat16")
    _e = _res[mxj, "float32"][1]
    for _n in _e:
        _t, _j = _res[mxt, "bfloat16"][1][_n], _res[mxj, "bfloat16"][1][_n]
        print(f"{_n}: port-ref {_rel_err(_t, _j):.3g}, port-fp32 "
              f"{_rel_err(_t, _e[_n]):.3g}, ref-fp32 {_rel_err(_j, _e[_n]):.3g}")
