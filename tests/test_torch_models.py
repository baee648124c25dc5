"""The image-classification model zoo and ``LRN`` against the JAX package
on the CPU: each of the nine builders emits the reference builder's symbol
JSON (node by node) and infers the same shapes at ``tests/test_misc.py``'s
parameters; ``get_model`` knows the reference's names; a forward with fed
numpy weights matches the reference's within 1e-5 of its max-abs; ``LRN``'s
output and gradient match ``jax.vjp`` of the reference's body (fp32 1e-5,
bf16 2e-2); and ``get_internals``, ``get_children``, ``attr`` and
``list_attr`` return what the reference's ``Symbol`` returns."""
import json

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

# tests/test_misc.py:248-335's builders and shapes
BUILDERS = [
    ("mlp", {}, (2, 784)),
    ("lenet", {}, (2, 1, 28, 28)),
    ("alexnet", {}, (2, 3, 224, 224)),
    ("vgg", {"num_layers": 11}, (2, 3, 224, 224)),
    ("googlenet", {}, (2, 3, 224, 224)),
    ("inception-bn", {}, (2, 3, 224, 224)),
    ("inception-v3", {}, (2, 3, 299, 299)),
    ("inception-resnet-v2", {}, (2, 3, 299, 299)),
    ("resnext", {"num_layers": 50}, (2, 3, 224, 224)),
]
# the forward's inputs: small where the net takes them
FORWARD = [
    ("mlp", {}, (2, 784)),
    ("lenet", {}, (2, 1, 28, 28)),
    ("alexnet", {}, (1, 3, 224, 224)),
    ("vgg", {"num_layers": 11}, (2, 3, 32, 32)),
    ("googlenet", {}, (2, 3, 64, 64)),
    ("inception-bn", {}, (2, 3, 64, 64)),
    ("resnext", {"num_layers": 50, "image_shape": "3,64,64"},
     (2, 3, 64, 64)),
    ("inception-v3", {}, (1, 3, 299, 299)),
    ("inception-resnet-v2", {}, (1, 3, 299, 299)),
]
FWD_LIMIT = 1e-5
LRN_LIMITS = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs (the tier-1 run puts six
    test workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")


def _symbols(name, kw, classes=10):
    """The builder's symbol from each package, named alike (fresh name
    counters)."""
    out = {}
    for pkg in (mxt, mxj):
        with pkg.name.NameManager():
            out[pkg] = pkg.models.get_model(name).get_symbol(
                num_classes=classes, **kw)
    return out[mxt], out[mxj]


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name,kw,shape", BUILDERS,
                         ids=[b[0] for b in BUILDERS])
def test_builder_emits_the_reference_json(name, kw, shape):
    t_sym, j_sym = _symbols(name, kw)
    t_json, j_json = json.loads(t_sym.tojson()), json.loads(j_sym.tojson())
    assert len(t_json["nodes"]) == len(j_json["nodes"])
    for a, b in zip(t_json["nodes"], j_json["nodes"]):
        assert a == b
    assert t_json == j_json
    t_shapes = t_sym.infer_shape(data=shape)
    j_shapes = j_sym.infer_shape(data=shape)
    for t, j in zip(t_shapes, j_shapes):
        assert [tuple(s) for s in t] == [tuple(s) for s in j]
    assert t_shapes[1] == [(shape[0], 10)]


def test_get_model_names_match_the_reference():
    from mxnet_tpu import models as jmodels

    names = sorted(jmodels._MODELS)
    assert sorted(mxt.models._MODELS) == names
    for name in names:
        assert mxt.models.get_model(name).__name__.rsplit(".", 1)[1] == \
            jmodels.get_model(name).__name__.rsplit(".", 1)[1]


def _weights(symbol, shape, rng):
    """Random numpy arguments and aux states: fan-in scaled weights,
    gammas near 1, moving variances near 1."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=shape)
    args = {}
    for n, s in zip(symbol.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        fan_in = np.prod(s[1:]) if len(s) > 1 else 1
        w = rng.standard_normal(s).astype(np.float32) / np.sqrt(fan_in)
        args[n] = w + 1.0 if n.endswith("_gamma") else w
    aux = {n: (np.abs(rng.standard_normal(s)) + 0.5 if n.endswith("_var")
               else 0.1 * rng.standard_normal(s)).astype(np.float32)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _forward(pkg, symbol, args, aux, x):
    ctx = pkg.cpu()
    arrs = {n: pkg.nd.array(a, ctx) for n, a in args.items()}
    arrs["data"] = pkg.nd.array(x, ctx)
    arrs["softmax_label"] = pkg.nd.zeros((x.shape[0],), ctx)
    ex = pkg.executor.Executor(
        symbol, ctx, arrs, aux_states=[
            pkg.nd.array(aux[n], ctx)
            for n in symbol.list_auxiliary_states()])
    return ex.forward(is_train=False)[0].asnumpy()


@pytest.mark.parametrize("name,kw,shape", FORWARD,
                         ids=[f[0] for f in FORWARD])
def test_forward_matches_the_reference(name, kw, shape):
    """An evaluation forward of each builder's graph on fed numpy weights:
    the probabilities within 1e-5 of the reference's max-abs."""
    t_sym, j_sym = _symbols(name, kw)
    rng = np.random.default_rng(3)
    args, aux = _weights(t_sym, shape, rng)
    x = rng.standard_normal(shape).astype(np.float32)
    got = _forward(mxt, t_sym, args, aux, x)
    want = _forward(mxj, j_sym, args, aux, x)
    assert got.shape == (shape[0], 10)
    assert _rel_err(got, want) <= FWD_LIMIT


# -- LRN ----------------------------------------------------------------------

LRN_CASES = [
    {"nsize": 5, "alpha": 1e-4, "beta": 0.75, "knorm": 1.0},
    {"nsize": 1, "alpha": 0.5, "beta": 0.5, "knorm": 1.0},
    {"nsize": 2, "alpha": 1e-2, "beta": 0.75, "knorm": 2.0},
    {"nsize": 3, "alpha": 0.3, "beta": 1.5, "knorm": 0.5},
    {"nsize": 5, "alpha": 1.0, "beta": 0.25, "knorm": 3.0},
    {},   # the reference's defaults (5, 1e-4, 0.75, 2.0)
]


def _lrn_both(attrs, x, head, dtype):
    """LRN's output and input gradient (for ``head``) in each package,
    the input cast to ``dtype`` inside (the gradient arrives in fp32)."""
    jdt = jnp.dtype(dtype)

    def jfn(v):
        outs, _ = jops.get_op("LRN").normalized_call(
            JOpCtx(is_train=True), attrs, [v.astype(jdt)], [])
        return outs[0]

    j_out, vjp = jax.vjp(jfn, jnp.asarray(x))
    (j_grad,) = vjp(jnp.asarray(head, j_out.dtype))
    leaf = torch.from_numpy(x).requires_grad_()
    outs, _ = tops.get_op("LRN").normalized_call(
        TOpCtx(is_train=True, device=torch.device("cpu")), attrs,
        [leaf.to(getattr(torch, dtype))], [])
    (t_grad,) = torch.autograd.grad(
        outs[0], [leaf], torch.from_numpy(head).to(outs[0].dtype))
    assert str(outs[0].dtype).split(".")[1] == str(j_out.dtype)
    return ((outs[0].detach().float().numpy(),
             np.asarray(j_out.astype(jnp.float32))),
            (t_grad.numpy(), np.asarray(j_grad)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attrs", LRN_CASES,
                         ids=[str(a.get("nsize", "default"))
                              + f"-{i}" for i, a in enumerate(LRN_CASES)])
def test_lrn_matches_reference_vjp(attrs, dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 5, 4)).astype(np.float32) * 2
    head = rng.standard_normal(x.shape).astype(np.float32)
    (out, want), (grad, want_grad) = _lrn_both(attrs, x, head, dtype)
    assert _rel_err(out, want) <= LRN_LIMITS[dtype]
    assert _rel_err(grad, want_grad) <= LRN_LIMITS[dtype]


def test_lrn_operator_case_matches_reference():
    """``tests/test_operator.py``'s LRN case (nsize 3 on (2, 4, 3, 3))
    through each package's ``Symbol.eval``."""
    x = np.random.default_rng(0).random((2, 4, 3, 3)).astype(np.float32)
    got = mxt.sym.LRN(mxt.sym.Variable("data"), nsize=3).eval(
        ctx=mxt.cpu(), data=mxt.nd.array(x, mxt.cpu()))[0].asnumpy()
    want = mxj.sym.LRN(mxj.sym.Variable("data"), nsize=3).eval(
        ctx=mxj.cpu(), data=mxj.nd.array(x))[0].asnumpy()
    assert got.shape == x.shape
    assert _rel_err(got, want) <= LRN_LIMITS["float32"]


# -- Symbol introspection -----------------------------------------------------

@pytest.mark.parametrize("name,kw,shape", BUILDERS,
                         ids=[b[0] for b in BUILDERS])
def test_internals_children_and_attrs_match_reference(name, kw, shape):
    t_sym, j_sym = _symbols(name, kw)
    t_int, j_int = t_sym.get_internals(), j_sym.get_internals()
    assert t_int.list_outputs() == j_int.list_outputs()
    assert t_sym.get_children().list_outputs() == \
        j_sym.get_children().list_outputs()
    assert t_sym.list_attr() == j_sym.list_attr()
    assert t_sym.attr("normalization") == j_sym.attr("normalization")
    for out in ("flatten0_output", j_int.list_outputs()[-2]):
        if out not in j_int.list_outputs():
            continue
        t_node, j_node = t_int[out], j_int[out]
        assert t_node.list_arguments() == j_node.list_arguments()
        assert t_node.list_attr() == j_node.list_attr()
        assert t_node.infer_shape(data=shape)[1] == \
            j_node.infer_shape(data=shape)[1]
    assert t_int.attr("x") is None and j_int.attr("x") is None
    assert t_int.list_attr() == j_int.list_attr() == {}
    v = mxt.sym.Variable("v")
    assert v.get_children() is None
    assert mxj.sym.Variable("v").get_children() is None
