"""The imperative slice end to end on the CPU, against the JAX package:
optimizer steps through ``mx.nd`` over every parameter of a 2-layer,
64-wide transformer LM (weights carried across with ``convert``), random
draws through ``mx.random``, and a ``CustomOp`` run imperatively and inside
a one-op Symbol through ``Executor.forward``."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

C = mxt.cpu()
LM = dict(vocab_size=64, num_layers=2, hidden=64, heads=4, seq_len=16)
SHAPES = {"data": (2, 16), "softmax_label": (2, 16)}
STEPS = 3
RTOL, ATOL = 1e-5, 1e-6


def _param_shapes():
    symbol = mxt.models.transformer_lm.get_symbol(**LM)
    arg_shapes, _, _ = symbol.infer_shape(**SHAPES)
    return {n: s for n, s in zip(symbol.list_arguments(), arg_shapes)
            if n not in SHAPES}


def _draw(shapes, rng, scale=1.0, positive=False):
    out = {}
    for n, s in shapes.items():
        a = rng.standard_normal(s).astype(np.float32) * scale
        out[n] = np.abs(a) if positive else a
    return out


def _both(arrays):
    """The same numpy arrays as JAX-package NDArrays and as port NDArrays
    (placed by ``convert.params_from_numpy``)."""
    jax_side = {n: mxj.nd.array(a) for n, a in arrays.items()}
    torch_side, _ = mxt.convert.params_from_numpy(arrays, {}, C)
    return jax_side, torch_side


def _assert_close(port, ref):
    assert set(port) == set(ref)
    for n in ref:
        np.testing.assert_allclose(port[n].asnumpy(), ref[n].asnumpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


@pytest.mark.parametrize("opt", ["sgd_mom_update", "adam_update"])
def test_optimizer_steps_over_lm_params_match_jax(opt):
    shapes = _param_shapes()
    assert len(shapes) > 10
    rng = np.random.default_rng(0)
    w_j, w_t = _both(_draw(shapes, rng, 0.05))
    states = [_both(_draw(shapes, rng, 0.01, positive=(opt == "adam_update"
                                                        and k == 1)))
              for k in range(1 if opt == "sgd_mom_update" else 2)]
    attrs = dict(lr=0.05, wd=1e-4, rescale_grad=0.5, clip_gradient=0.8)
    if opt == "sgd_mom_update":
        attrs["momentum"] = 0.9
    else:
        attrs.update(beta1=0.8, beta2=0.95, epsilon=1e-6)
    for _ in range(STEPS):
        g_j, g_t = _both(_draw(shapes, rng, 2.0))
        for n in shapes:
            st_j = [s[0][n] for s in states]
            st_t = [s[1][n] for s in states]
            out_j = getattr(mxj.nd, opt)(w_j[n], g_j[n], *st_j, **attrs)
            out_t = getattr(mxt.nd, opt)(w_t[n], g_t[n], *st_t, **attrs)
            # write-back: each name rebinds to its own new array
            w_j[n], w_t[n] = out_j[0], out_t[0]
            for s, nj, nt in zip(states, out_j[1:], out_t[1:]):
                s[0][n], s[1][n] = nj, nt
    _assert_close(w_t, w_j)
    for s in states:
        _assert_close(s[1], s[0])
    # no two port NDArrays share a buffer where the JAX package has two
    ptrs = [a.data.data_ptr() for a in w_t.values()]
    ptrs += [a.data.data_ptr() for s in states for a in s[1].values()]
    assert len(set(ptrs)) == len(ptrs)


def test_random_draws_over_lm_params():
    """``mx.random.normal`` at every parameter shape: right shapes, float32,
    the asked moments, reproducible under one seed."""
    shapes = _param_shapes()

    def draw():
        mxt.random.seed(3)
        return {n: mxt.random.normal(0.0, 0.5, s, ctx=C)
                for n, s in shapes.items()}

    a, b = draw(), draw()
    flat = np.concatenate([v.asnumpy().ravel() for v in a.values()])
    assert all(a[n].shape == tuple(s) and a[n].dtype == torch.float32
               for n, s in shapes.items())
    assert abs(flat.mean()) < 0.01 and abs(flat.std() - 0.5) < 0.01
    for n in shapes:
        assert torch.equal(a[n].data, b[n].data)


def _register_custom(pkg):
    """The same CustomOp in either package: outputs 2x + y and x * y."""

    class AxpyMul(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x, y = in_data
            self.assign(out_data[0], req[0], x * 2.0 + y)
            self.assign(out_data[1], req[1], x * y)

    @pkg.operator.register("axpy_mul_parity")
    class AxpyMulProp(pkg.operator.CustomOpProp):
        def list_arguments(self):
            return ["x", "y"]

        def list_outputs(self):
            return ["axpy", "mul"]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return AxpyMul()


def test_custom_op_matches_jax(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")
    _register_custom(mxj)
    _register_custom(mxt)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    y = rng.standard_normal((5, 7)).astype(np.float32)

    # imperative
    got = mxt.nd.Custom(mxt.nd.array(x, C), mxt.nd.array(y, C),
                        op_type="axpy_mul_parity")
    want = mxj.ops.imperative_invoke("Custom", mxj.nd.array(x),
                                     mxj.nd.array(y),
                                     op_type="axpy_mul_parity")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=RTOL,
                                   atol=ATOL)

    # a one-op Symbol through Executor.forward, shapes inferred
    outs = {}
    for name, pkg, ctx in (("jax", mxj, mxj.cpu()), ("port", mxt, C)):
        sym = pkg.sym.Custom(pkg.sym.Variable("x"), pkg.sym.Variable("y"),
                             op_type="axpy_mul_parity", name="am")
        assert sym.list_arguments() == ["x", "y"]
        assert sym.list_outputs() == ["am_output0", "am_output1"]
        _, out_shapes, _ = sym.infer_shape(x=x.shape, y=y.shape)
        assert out_shapes == [x.shape, x.shape]
        args = {"x": pkg.nd.array(x, ctx), "y": pkg.nd.array(y, ctx)}
        ex = sym.bind(ctx, args)
        outs[name] = [o.asnumpy() for o in ex.forward()]
    for g, w in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs["port"][0], 2 * x + y, rtol=1e-6)


def test_custom_op_unregistered_raises():
    with pytest.raises(mxt.MXNetError, match="not registered"):
        mxt.nd.Custom(mxt.nd.zeros((2,), C), op_type="no_such_custom_op")


def test_port_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the JAX
    package (a grep of the sources; the subprocess check of
    test_torch_transformer_predict.py covers what importing pulls in)."""
    import os
    import re

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bad_import = re.compile(r"^\s*(import|from)\s+(jax|mxnet_tpu)(\.|\s|$)",
                            re.M)
    files = [os.path.join(repo, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(repo, "mxnet_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    offenders = []
    for path in files:
        with open(path) as f:
            text = f.read()
        offenders += [f"{os.path.relpath(path, repo)}: {m.group(0).strip()}"
                      for m in bad_import.finditer(text)]
    assert offenders == []
