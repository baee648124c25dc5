"""The port's optimizers and initializers against the JAX package's: every
optimizer of the reference's registry (SGD with and without momentum,
ccSGD, NAG, SGLD on noise fed to both, DCASGD, Adam, AdaGrad, RMSProp
centred and not, AdaDelta, Test) over one fixed gradient sequence made with
numpy, with lr/wd multipliers (by name, by index and from the symbol's
attributes), ``rescale_grad``, ``clip_gradient`` and learning-rate
schedules; ``Updater`` states through ``get_states``/``set_states``; and
the initializers' name dispatch and statistics (their draws come from other
generators, so the values differ and the distributions are compared)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _scheduler(pkg, spec):
    kind, step, factor = spec
    if kind == "factor":
        return pkg.lr_scheduler.FactorScheduler(step=step, factor=factor)
    return pkg.lr_scheduler.MultiFactorScheduler(step=step, factor=factor)


def _noise(steps, seed=2):
    """The Gaussian draws SGLD takes, in its order of updates."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for _ in range(steps) for s in SHAPES.values()]


def _run(pkg, name, kwargs, steps=5, use_sym=False):
    """The weights after ``steps`` updates through ``Updater.update_multi``
    (indices 0, 1, 2 named as in SHAPES), as numpy arrays. SGLD's noise is
    fed: the port's generator draw and the reference's ``jax.random.normal``
    return the same numpy arrays in turn."""
    names = list(SHAPES)
    kw = dict(kwargs, param_idx2name=dict(enumerate(names)))
    if "lr_scheduler" in kw:
        kw["lr_scheduler"] = _scheduler(pkg, kw["lr_scheduler"])
    if use_sym:
        kw["sym"] = _symbol(pkg)
    opt = pkg.optimizer.create(name, **kw)
    if name == "sgld" and pkg is mxt:
        draws = iter(_noise(steps))
        opt._normal = lambda w: torch.from_numpy(next(draws))
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
    ("ccsgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01,
             "lr_scheduler": ("factor", 2, 0.5)}),
    ("nag", {"learning_rate": 0.05, "clip_gradient": 0.5,
             "rescale_grad": 0.5, "wd": 0.01}),
    ("sgld", {"learning_rate": 0.01, "wd": 0.01,
              "lr_scheduler": ("factor", 3, 0.5)}),
    ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9, "lamda": 0.1,
                "wd": 0.01}),
    ("dcasgd", {"learning_rate": 0.05, "clip_gradient": 0.5}),
    ("adagrad", {"learning_rate": 0.1, "wd": 0.01,
                 "lr_scheduler": ("multifactor", [2, 4], 0.5)}),
    ("adagrad", {"learning_rate": 0.1, "eps": 1e-4, "rescale_grad": 0.25,
                 "clip_gradient": 0.3}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": False, "wd": 0.01,
                 "clip_gradient": 0.3, "gamma1": 0.9}),
    ("adadelta", {"wd": 0.01}),
    ("adadelta", {"rho": 0.8, "epsilon": 1e-4, "rescale_grad": 0.5}),
    ("test", {"rescale_grad": 0.5}),
])
@pytest.mark.parametrize("use_sym", [False, True])
def test_optimizer_matches_reference(name, kwargs, use_sym, monkeypatch):
    """Five updates on one gradient sequence; multipliers set by name
    (``set_lr_mult``/``set_wd_mult``, which also zeroes wd off ``*_weight``
    and ``*_gamma``) or read from the symbol's ``__lr_mult__``/
    ``__wd_mult__``."""
    if name == "sgld":
        fed = {}

        def normal(key, shape, dtype=jnp.float32):
            return jnp.asarray(next(fed["draws"]), dtype)

        monkeypatch.setattr(jax.random, "normal", normal)
    got, topt = _run(mxt, name, kwargs, use_sym=use_sym)
    if name == "sgld":
        fed["draws"] = iter(_noise(5))
    want, jopt = _run(mxj, name, kwargs, use_sym=use_sym)
    assert topt.lr_mult == jopt.lr_mult and topt.wd_mult == jopt.wd_mult
    assert topt.num_update == jopt.num_update == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_every_reference_optimizer_name_creates():
    """Each name of the JAX package's registry (its ten classes and the
    ``ccsgd`` alias) creates the port's optimizer of the same class name."""
    from mxnet_tpu import optimizer as jopt

    names = sorted(jopt._registry._reg)
    assert len(names) == 10 and "ccsgd" in names
    for name in names:
        got = mxt.optimizer.create(name)
        assert type(got).__name__ == type(jopt.create(name)).__name__
    assert mxt.optimizer.ccSGD is mxt.optimizer.SGD


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
    ("dcasgd", {"momentum": 0.9}), ("dcasgd", {}), ("adagrad", {}),
    ("rmsprop", {}), ("adadelta", {}), ("adam", {}), ("sgd", {})])
def test_updater_states_round_trip(name, kwargs):
    """Three updates, the states through ``get_states`` (a pickle of numpy
    arrays by index) into a new Updater of the same optimizer, two more:
    the same weights and states as five updates in one Updater."""
    names = list(SHAPES)
    grads = _grad_sequence(5)

    def weights():
        return [mxt.nd.array(_initial()[n], mxt.cpu()) for n in names]

    def step(updater, w, g):
        updater.update_multi(list(range(3)),
                             [mxt.nd.array(g[n], mxt.cpu()) for n in names],
                             w)

    opt = mxt.optimizer.create(name, learning_rate=0.05, **kwargs)
    whole, w1 = mxt.optimizer.get_updater(opt), weights()
    for g in grads:
        step(whole, w1, g)
    opt = mxt.optimizer.create(name, learning_rate=0.05, **kwargs)
    first, w2 = mxt.optimizer.get_updater(opt), weights()
    for g in grads[:3]:
        step(first, w2, g)
    raw = first.get_states()
    again = mxt.optimizer.get_updater(opt)
    again.set_states(raw)
    assert set(again.states) == {0, 1, 2}
    for g in grads[3:]:
        step(again, w2, g)
    for a, b in zip(w1, w2):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    flat = list(itertools.chain.from_iterable(
        s if isinstance(s, tuple) else (s,) for s in whole.states.values()))
    flat2 = list(itertools.chain.from_iterable(
        s if isinstance(s, tuple) else (s,) for s in again.states.values()))
    for a, b in zip(flat, flat2):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


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
