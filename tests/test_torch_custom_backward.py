"""A ``Custom`` op's backward on the CPU, held to the JAX package's
``custom_vjp`` (mxnet_tpu/operator.py:145-180): the user's ``backward``
gives the gradients, whatever torch ops its forward ran. The case of
ROADMAP C8: ``y = Custom(data * w)`` with forward ``sign(x)`` and backward
``3 * out_grad``, ``w = 1.5``, head gradients of ones: ``grad(data) = 4.5``
and ``grad(w) = 3 * data`` (the port gave zeros before). Then a custom op
of two inputs and two outputs through ``simple_bind``, one whose prop says
``need_top_grad`` is false (the reference passes the head gradients all
the same), and three SGD steps of a Module over one, against the
reference's."""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")
    monkeypatch.setenv("MXTPU_FUSED_GRADS", "1")
    monkeypatch.delenv("MXTPU_DONATE_PARAMS", raising=False)
    monkeypatch.delenv("MXTPU_NO_FUSED_STEP", raising=False)


def _register(pkg):
    """The three test ops in ``pkg``'s registry."""
    op, prop = pkg.operator.CustomOp, pkg.operator.CustomOpProp

    class Sign(op):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], pkg.nd.sign(in_data[0]))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 3)

    @pkg.operator.register("c8_sign")
    class SignProp(prop):
        def create_operator(self, ctx, shapes, dtypes):
            return Sign()

    class Pair(op):
        """(a * b, a - b); its backward scales each path by its own
        factor, so a wrong route of a head gradient shows."""

        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data
            self.assign(out_data[0], req[0], a * b)
            self.assign(out_data[1], req[1], a - b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            a, b = in_data
            g0, g1 = out_grad
            self.assign(in_grad[0], req[0], g0 * b * 2 + g1)
            self.assign(in_grad[1], req[1], g0 * a - g1 * 0.5
                        + out_data[0] * 0.1)

    @pkg.operator.register("c8_pair")
    class PairProp(prop):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["prod", "diff"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Pair()

    class Halve(op):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 0.5)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 0.5
                        + in_data[0] * 0)

    @pkg.operator.register("c8_halve")
    class HalveProp(prop):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def create_operator(self, ctx, shapes, dtypes):
            return Halve()


for _pkg in (mxt, mxj):
    _register(_pkg)


def _ctx(pkg):
    return pkg.cpu()


def _nd(pkg, a):
    return pkg.nd.array(a, pkg.cpu()) if pkg is mxt else pkg.nd.array(a)


def test_c8_custom_backward_is_called():
    x = np.array([[1.0, -2.0, 3.0], [-0.5, 4.0, 0.25]], np.float32)
    got = {}
    for pkg in (mxt, mxj):
        d, w = pkg.sym.Variable("data"), pkg.sym.Variable("w")
        y = pkg.sym.Custom(d * w, op_type="c8_sign")
        ex = y.simple_bind(_ctx(pkg), data=(2, 3), w=(2, 3))
        ex.arg_dict["data"][:] = x
        ex.arg_dict["w"][:] = np.full((2, 3), 1.5, np.float32)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([_nd(pkg, np.ones((2, 3), np.float32))])
        got[pkg] = (out, ex.grad_dict["data"].asnumpy(),
                    ex.grad_dict["w"].asnumpy())
    out, g_data, g_w = got[mxt]
    np.testing.assert_array_equal(out, np.sign(x))
    np.testing.assert_allclose(g_data, np.full((2, 3), 4.5), rtol=RTOL)
    np.testing.assert_allclose(g_w, 3 * x, rtol=RTOL)
    for a, b in zip(got[mxt], got[mxj]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_multi_input_multi_output_custom_gradients():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal((4, 3)).astype(np.float32)
    heads = [rng.standard_normal((4, 3)).astype(np.float32)
             for _ in range(2)]
    got = {}
    for pkg in (mxt, mxj):
        va, vb = pkg.sym.Variable("va"), pkg.sym.Variable("vb")
        y = pkg.sym.Custom(va, vb, op_type="c8_pair", name="pair")
        ex = y.simple_bind(_ctx(pkg), va=(4, 3), vb=(4, 3))
        ex.arg_dict["va"][:] = a
        ex.arg_dict["vb"][:] = b
        outs = [o.asnumpy() for o in ex.forward(is_train=True)]
        ex.backward([_nd(pkg, h) for h in heads])
        got[pkg] = outs + [ex.grad_dict["va"].asnumpy(),
                           ex.grad_dict["vb"].asnumpy()]
    want_a = heads[0] * b * 2 + heads[1]
    want_b = heads[0] * a - heads[1] * 0.5 + a * b * 0.1
    np.testing.assert_allclose(got[mxt][2], want_a, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[mxt][3], want_b, rtol=RTOL, atol=ATOL)
    for x, y in zip(got[mxt], got[mxj]):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


def test_need_top_grad_false_still_passes_the_head_gradients():
    x = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    head = np.full((2, 3), 3.0, np.float32)
    got = {}
    for pkg in (mxt, mxj):
        d = pkg.sym.Variable("data")
        ex = pkg.sym.Custom(d, op_type="c8_halve").simple_bind(
            _ctx(pkg), data=(2, 3))
        ex.arg_dict["data"][:] = x
        ex.forward(is_train=True)
        ex.backward([_nd(pkg, head)])
        got[pkg] = ex.grad_dict["data"].asnumpy()
    np.testing.assert_allclose(got[mxt], np.full((2, 3), 1.5), rtol=RTOL)
    np.testing.assert_allclose(got[mxt], got[mxj], rtol=RTOL, atol=ATOL)


def test_module_trains_through_a_custom_op():
    """Three SGD steps of a Module whose graph holds a Custom op: the
    port's (its fused step runs eagerly: the rule refuses the capture)
    against the reference's."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    y = rng.integers(0, 3, 8).astype(np.float32)
    w = {"fc_weight": (rng.standard_normal((3, 5)) * 0.3).astype(np.float32),
         "fc_bias": np.zeros(3, np.float32)}
    got = {}
    for pkg in (mxt, mxj):
        d = pkg.sym.Variable("data")
        h = pkg.sym.Custom(d, op_type="c8_halve", name="halve")
        net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            h, num_hidden=3, name="fc"), name="softmax")
        mod = pkg.mod.Module(net, context=_ctx(pkg))
        mod.bind(data_shapes=[("data", (8, 5))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(arg_params={k: _nd(pkg, v) for k, v in w.items()})
        mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
        batch = pkg.io.DataBatch(data=[_nd(pkg, x)], label=[_nd(pkg, y)])
        for _ in range(3):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        got[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        if pkg is mxt:
            assert "Custom node 'halve'" in mod.step_info()["refusal"]
    for k in w:
        np.testing.assert_allclose(got[mxt][k], got[mxj][k], rtol=2e-4,
                                   atol=2e-5)
        assert np.abs(got[mxt][k] - w[k]).max() > 1e-3
