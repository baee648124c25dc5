"""The port's optimizers and initializers against the JAX package's: SGD,
SGD with momentum and Adam over one fixed gradient sequence made with numpy,
with lr/wd multipliers (by name, by index and from the symbol's attributes),
``rescale_grad`` and ``clip_gradient``; and the initializers' name dispatch
and statistics (their draws come from other generators, so the values
differ and the distributions are compared)."""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

# Both packages run the same fp32 update formulas elementwise; measured
# gaps are a few fp32 steps (<= 2.4e-7 on weights of size about 1).
RTOL, ATOL = 1e-5, 1e-6

SHAPES = {"fc_weight": (4, 3), "fc_bias": (4,), "ln_gamma": (3,)}


def _grad_sequence(steps, seed=0):
    rng = np.random.default_rng(seed)
    return [{n: (rng.standard_normal(s) * 2).astype(np.float32)
             for n, s in SHAPES.items()} for _ in range(steps)]


def _initial(seed=1):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}


def _symbol(pkg):
    """A graph whose weight carries lr and wd multipliers as attributes."""
    w = pkg.sym.Variable("fc_weight", __lr_mult__=0.5, __wd_mult__=2.0)
    return pkg.sym.FullyConnected(pkg.sym.Variable("data"), weight=w,
                                  num_hidden=4, name="fc")


def _run(pkg, name, kwargs, steps=5, use_sym=False):
    """The weights after ``steps`` updates through ``Updater.update_multi``
    (indices 0, 1, 2 named as in SHAPES), as numpy arrays."""
    names = list(SHAPES)
    kw = dict(kwargs, param_idx2name=dict(enumerate(names)))
    if use_sym:
        kw["sym"] = _symbol(pkg)
    opt = pkg.optimizer.create(name, **kw)
    if not use_sym:
        opt.set_lr_mult({"fc_bias": 2.0})
        opt.set_wd_mult({"ln_gamma": 0.5})
    updater = pkg.optimizer.get_updater(opt)
    ctx = pkg.cpu()
    weights = [pkg.nd.array(_initial()[n], ctx) for n in names]
    for grads in _grad_sequence(steps):
        updater.update_multi(list(range(len(names))),
                             [pkg.nd.array(grads[n], ctx) for n in names],
                             weights)
    return [w.asnumpy() for w in weights], opt


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "wd": 0.01, "rescale_grad": 0.25}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "clip_gradient": 0.5,
             "rescale_grad": 0.5}),
    ("adam", {"learning_rate": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01, "rescale_grad": 0.25,
              "clip_gradient": 0.3}),
    ("adam", {"learning_rate": 0.01, "beta1": 0.8, "beta2": 0.99,
              "epsilon": 1e-6}),
])
@pytest.mark.parametrize("use_sym", [False, True])
def test_optimizer_matches_reference(name, kwargs, use_sym):
    """Five updates on one gradient sequence; multipliers set by name
    (``set_lr_mult``/``set_wd_mult``, which also zeroes wd off ``*_weight``
    and ``*_gamma``) or read from the symbol's ``__lr_mult__``/
    ``__wd_mult__``."""
    got, topt = _run(mxt, name, kwargs, use_sym=use_sym)
    want, jopt = _run(mxj, name, kwargs, use_sym=use_sym)
    assert topt.lr_mult == jopt.lr_mult and topt.wd_mult == jopt.wd_mult
    assert topt.num_update == jopt.num_update == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_adam_bias_correction_and_state():
    """One Adam step from zero state moves every entry by lr (the bias-
    corrected m/sqrt(v) is +-1), and the state holds the moments."""
    opt = mxt.optimizer.create("adam", learning_rate=0.01, epsilon=0.0)
    updater = mxt.optimizer.Updater(opt)
    g = np.array([3.0, -0.5, 1e-3], np.float32)
    w = mxt.nd.zeros((3,), mxt.cpu())
    updater(0, mxt.nd.array(g, mxt.cpu()), w)
    np.testing.assert_allclose(w.asnumpy(), -0.01 * np.sign(g), rtol=1e-5)
    mean, var = updater.states[0]
    np.testing.assert_allclose(mean.asnumpy(), 0.1 * g, rtol=1e-6)
    np.testing.assert_allclose(var.asnumpy(), 0.001 * g * g, rtol=1e-5)


def test_optimizer_registry():
    assert isinstance(mxt.optimizer.create("SGD"), mxt.optimizer.SGD)
    assert isinstance(mxt.optimizer.create("adam"), mxt.optimizer.Adam)
    assert mxt.optimizer.SGD().create_state(0, mxt.nd.zeros((2,), mxt.cpu())) \
        is None

    @mxt.optimizer.register
    class Halve(mxt.optimizer.Optimizer):
        def update(self, index, weight, grad, state):
            weight._data = weight._data * 0.5

    w = mxt.nd.ones((2,), mxt.cpu())
    mxt.optimizer.get_updater(mxt.optimizer.create("halve"))(0, w, w)
    np.testing.assert_array_equal(w.asnumpy(), [0.5, 0.5])
    with pytest.raises(mxt.MXNetError):
        mxt.optimizer.create("no_such_optimizer")


# ---------------------------------------------------------------------------
# initializers

INIT_SHAPES = {"fc1_weight": (256, 512), "fc1_bias": (256,),
               "ln_gamma": (64,), "ln_beta": (64,),
               "conv_weight": (64, 32, 3, 3), "bn_moving_mean": (64,),
               "bn_moving_avg": (64,), "bn_moving_var": (64,)}


def _init_arrays(pkg, init):
    out = {}
    for name, shape in INIT_SHAPES.items():
        arr = pkg.nd.zeros(shape, pkg.cpu()) + 5.0
        init(name, arr)
        out[name] = arr.asnumpy()
    return out


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.init.Uniform(0.1),
    lambda pkg: pkg.init.Normal(0.05),
    lambda pkg: pkg.init.Xavier(),
    lambda pkg: pkg.init.Xavier(rnd_type="gaussian", factor_type="in",
                                magnitude=2),
    lambda pkg: pkg.init.Xavier(factor_type="out"),
    lambda pkg: pkg.init.Zero(),
    lambda pkg: pkg.init.One(),
    lambda pkg: pkg.init.Constant(0.25),
])
def test_initializer_dispatch_and_statistics(make):
    """The name decides the rule (bias/beta 0, gamma 1, BatchNorm's moving
    mean/avg 0 and moving var 1, ``*_weight`` the initializer's own), as in
    the reference;
    random weights agree with the reference's in range, mean and standard
    deviation (within 5 % at these sizes: 131 072 and 18 432 draws)."""
    mxt.random.seed(3)
    got = _init_arrays(mxt, make(mxt))
    want = _init_arrays(mxj, make(mxj))
    for name in INIT_SHAPES:
        g, w = got[name], want[name]
        assert g.shape == w.shape and g.dtype == np.float32
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, w)
            continue
        assert not np.array_equal(g, w)      # other generators
        np.testing.assert_allclose(g.std(), w.std(), rtol=0.05)
        assert abs(g.mean() - w.mean()) < 0.05 * w.std()
        assert np.abs(g).max() <= 1.3 * np.abs(w).max()


def test_xavier_uniform_bound():
    """Xavier uniform: U(-s, s) with s = sqrt(3 / ((fan_in + fan_out) / 2)),
    fans of a convolution weight scaled by its window."""
    arr = mxt.nd.zeros((64, 32, 3, 3), mxt.cpu())
    mxt.init.Xavier()("conv_weight", arr)
    s = np.sqrt(3.0 / ((32 * 9 + 64 * 9) / 2.0))
    a = arr.asnumpy()
    assert np.abs(a).max() <= s and np.abs(a).max() > 0.99 * s
    np.testing.assert_allclose(a.std(), s / np.sqrt(3), rtol=0.03)


def test_initializer_seeded_and_on_the_arrays_device():
    """One seed gives the same weights again; draws land on the array's own
    device (here the CPU), not the default context."""
    draws = []
    for _ in range(2):
        mxt.random.seed(7)
        arr = mxt.nd.zeros((5, 4), mxt.cpu())
        mxt.init.Xavier()("w_weight", arr)
        assert arr.context == mxt.cpu()
        draws.append(arr.asnumpy())
    np.testing.assert_array_equal(*draws)
    with pytest.raises(mxt.MXNetError):
        mxt.init.Xavier()("unknown_name", mxt.nd.zeros((2,), mxt.cpu()))
