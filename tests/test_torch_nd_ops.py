"""Every op that mxnet_tpu/ops/tensor.py registers, and every alias, run
through the port's body (mxnet_tpu_torch.ops) and the JAX package's body on
the same numpy inputs, on the CPU. Values at rtol 1e-5 / atol 1e-6 (fp32),
NaN positions included, and the result dtype, must match. Inputs are drawn
inside each op's domain; fixed cases add what lies outside it: NaN and
infinite values, casts past int32's range, negative, out-of-range and NaN
indices, and ties (``topk`` orders them as ``lax.top_k``).
The sampling ops cannot match values (threefry vs mt19937/Philox): they are
held to shape, dtype, mean and variance, and to same-seed reproducibility."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import ops as jops
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import ops as tops

RTOL, ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")


def _randn(*shape, scale=1.0):
    return lambda rng: (scale * rng.standard_normal(shape)).astype(np.float32)


def _unif(lo, hi, *shape):
    return lambda rng: rng.uniform(lo, hi, shape).astype(np.float32)


def _ids(shape, n):
    return lambda rng: rng.integers(0, n, shape).astype(np.float32)


def _ints(shape, lo=-5, hi=6):
    return lambda rng: rng.integers(lo, hi, shape).astype(np.int32)


def _with_nans(*shape):
    def make(rng):
        x = rng.standard_normal(shape).astype(np.float32)
        x[rng.random(shape) < 0.3] = np.nan
        return x
    return make


def _fixed(values, dtype=np.float32):
    """These exact values (NaN, infinities, ties, out-of-range ids)."""
    return lambda rng: np.array(values, dtype)


# NaN, the infinities, values past int32 and its limits, and a few in range
SPECIALS = [np.nan, np.inf, -np.inf, 3e9, -3e9, 2.7, -2.7, 2147483520.0,
            -2147483648.0, 0.0, -0.0, 1e-3]
# ids for a 5-row table: negative ones wrap, -6 and 5 are out of range,
# NaN is 0, 3e9 saturates and is out of range
ODD_IDS = [-1, -5, -6, 5, 7, np.nan, 3e9, 2, 0]
TIES = [[0, 1, 1, 0, 1, 0], [2, 2, 2, 2, 2, 2], [1, 0, 1, 0, 0, 1]]
# lax.top_k's total order: -NaN < -inf < -0.0 < 0.0 < inf < NaN
SIGNED = [[-0.0, 0.0, -0.0, 1.0, np.nan, -np.nan, np.inf, -np.inf],
          [0.0, -0.0, np.nan, np.nan, -1.0, -np.inf, -np.nan, 0.0]]


def _distinct(*shape):
    """Values without ties (a permutation of a spread grid)."""
    return lambda rng: (rng.permutation(int(np.prod(shape))).reshape(shape)
                        .astype(np.float32) * 0.37 - 3.0)


X = _randn(3, 4)
POS = _unif(0.5, 3.0, 3, 4)
UNIT = _unif(-0.9, 0.9, 3, 4)
TWO = [_randn(2, 3, 4), _randn(2, 3, 4)]
BCAST = [_randn(2, 3, 4), _randn(1, 3, 1)]
OPT = dict(lr=0.05, wd=1e-3, rescale_grad=0.5, clip_gradient=1.0)

# canonical op name -> list of (attrs, input makers); aliases take the first
CASES = {
    "abs": [({}, [X])],
    "sign": [({}, [X]), ({}, [_fixed(SPECIALS)])],
    "round": [({}, [_randn(3, 4, scale=3)])],
    "ceil": [({}, [_randn(3, 4, scale=3)])],
    "floor": [({}, [_randn(3, 4, scale=3)])],
    "rint": [({}, [_randn(3, 4, scale=3)])],
    "fix": [({}, [_randn(3, 4, scale=3)])],
    "square": [({}, [X]), ({}, [_ints((3, 4))])],
    "sqrt": [({}, [POS])], "rsqrt": [({}, [POS])], "exp": [({}, [X])],
    "log": [({}, [POS])], "log10": [({}, [POS])], "log2": [({}, [POS])],
    "log1p": [({}, [POS])], "expm1": [({}, [X])],
    "sin": [({}, [X])], "cos": [({}, [X])], "tan": [({}, [UNIT])],
    "arcsin": [({}, [UNIT])], "arccos": [({}, [UNIT])],
    "arctan": [({}, [X])], "sinh": [({}, [X])], "cosh": [({}, [X])],
    "tanh": [({}, [X])], "arcsinh": [({}, [X])],
    "arccosh": [({}, [_unif(1.1, 4.0, 3, 4)])],
    "arctanh": [({}, [UNIT])], "degrees": [({}, [X])],
    "radians": [({}, [X])], "negative": [({}, [X])],
    "reciprocal": [({}, [POS])], "sigmoid": [({}, [X])],
    "relu": [({}, [X])], "softsign": [({}, [X])],
    "gamma": [({}, [POS])], "gammaln": [({}, [POS])],
    "_copy": [({}, [X])], "_CrossDeviceCopy": [({}, [X])],
    "BlockGrad": [({}, [X])],
    "Cast": [({"dtype": "int32"}, [_randn(3, 4, scale=4)]),
             ({"dtype": "float16"}, [X]), ({}, [_ints((3, 4))]),
             ({"dtype": "int32"}, [_fixed(SPECIALS)]),
             ({"dtype": "uint8"}, [_fixed(SPECIALS + [255.5, 256.0, -1.0])]),
             ({"dtype": "int8"}, [_fixed(SPECIALS + [127.9, -128.9])]),
             ({"dtype": "int32"}, [_fixed([np.nan, np.inf, -np.inf, 65504.0,
                                           -65504.0, 2.7, -2.7, 0.0],
                                          np.float16)])],
    "elemwise_add": [({}, TWO)], "elemwise_sub": [({}, TWO)],
    "elemwise_mul": [({}, TWO)],
    "elemwise_div": [({}, [X, POS]), ({}, [_ints((3, 4)), _ints((3, 4), 1)])],
    "_power": [({}, [POS, X])], "_maximum": [({}, TWO)],
    "_minimum": [({}, TWO)], "_hypot": [({}, TWO)], "_grad_add": [({}, TWO)],
    "_equal": [({}, [_ids((3, 4), 3), _ids((3, 4), 3)]),
               ({}, [_ints((3, 4), 0, 3), _ints((3, 4), 0, 3)])],
    "_not_equal": [({}, [_ids((3, 4), 3), _ids((3, 4), 3)])],
    "_greater": [({}, TWO)], "_greater_equal": [({}, TWO)],
    "_lesser": [({}, TWO)], "_lesser_equal": [({}, TWO)],
    "_plus_scalar": [({"scalar": 1.5}, [X]), ({"scalar": 2.5}, [_ints((4,))]),
                     ({"scalar": 2}, [_ints((4,))])],
    "_minus_scalar": [({"scalar": 1.5}, [X])],
    "_rminus_scalar": [({"scalar": 1.5}, [X])],
    "_mul_scalar": [({"scalar": -2.0}, [X])],
    "_div_scalar": [({"scalar": 4.0}, [X]), ({"scalar": 2}, [_ints((4,))])],
    "_rdiv_scalar": [({"scalar": 3.0}, [POS])],
    "_power_scalar": [({"scalar": 2.0}, [X])],
    "_rpower_scalar": [({"scalar": 2.0}, [X])],
    "_hypot_scalar": [({"scalar": 3.0}, [X])],
    "_maximum_scalar": [({"scalar": 0.2}, [X])],
    "_minimum_scalar": [({"scalar": 0.2}, [X])],
    "_equal_scalar": [({"scalar": 1.0}, [_ids((3, 4), 3)])],
    "_not_equal_scalar": [({"scalar": 1.0}, [_ids((3, 4), 3)])],
    "_greater_scalar": [({"scalar": 0.1}, [X])],
    "_greater_equal_scalar": [({"scalar": 1.0}, [_ids((3, 4), 3)])],
    "_lesser_scalar": [({"scalar": 0.1}, [X])],
    "_lesser_equal_scalar": [({"scalar": 1.0}, [_ids((3, 4), 3)])],
    "broadcast_add": [({}, BCAST)], "broadcast_plus": [({}, BCAST)],
    "broadcast_sub": [({}, BCAST)], "broadcast_minus": [({}, BCAST)],
    "broadcast_mul": [({}, BCAST)],
    "broadcast_div": [({}, [_randn(2, 3, 4), _unif(0.5, 2, 1, 3, 1)])],
    "broadcast_power": [({}, [_unif(0.5, 2, 2, 3, 4), _randn(1, 3, 1)])],
    "broadcast_maximum": [({}, BCAST)], "broadcast_minimum": [({}, BCAST)],
    "broadcast_hypot": [({}, BCAST)], "broadcast_equal": [({}, BCAST)],
    "broadcast_not_equal": [({}, BCAST)], "broadcast_greater": [({}, BCAST)],
    "broadcast_greater_equal": [({}, BCAST)],
    "broadcast_lesser": [({}, BCAST)],
    "broadcast_lesser_equal": [({}, BCAST)],
    "broadcast_to": [({"shape": (0, 3, 0)}, [_randn(2, 1, 4)])],
    "broadcast_axis": [({"axis": 1, "size": 3}, [_randn(2, 1, 4)]),
                       ({"axis": (0, 2), "size": (2, 5)}, [_randn(1, 3, 1)])],
    "sum": [({}, [_randn(2, 3, 4)]), ({"axis": 1, "keepdims": True},
                                      [_randn(2, 3, 4)]),
            ({"axis": (0, 2), "exclude": True}, [_randn(2, 3, 4)]),
            ({"axis": 0}, [_ints((3, 4))])],
    "mean": [({"axis": -1}, [_randn(2, 3, 4)]), ({}, [_ints((3, 4))])],
    "prod": [({"axis": (0, 2)}, [_unif(0.5, 1.5, 2, 3, 4)])],
    "nansum": [({"axis": 1}, [_with_nans(3, 5)])],
    "nanprod": [({"axis": 0}, [_with_nans(3, 5)])],
    "max": [({"axis": 1}, [_randn(2, 3, 4)]), ({}, [_ints((3, 4))])],
    "min": [({"axis": (1, 2), "keepdims": True}, [_randn(2, 3, 4)])],
    "norm": [({}, [_randn(2, 3, 4)])],
    "argmax": [({"axis": 1}, [_distinct(3, 5)]), ({}, [_distinct(3, 5)]),
               ({"axis": 0, "keepdims": True}, [_distinct(3, 5)])],
    "argmin": [({"axis": 1}, [_distinct(3, 5)])],
    "argmax_channel": [({}, [_distinct(3, 5)])],
    "topk": [({"k": 2}, [_distinct(3, 6)]),
             ({"k": 3, "ret_typ": "value", "is_ascend": True},
              [_distinct(3, 6)]),
             ({"k": 2, "ret_typ": "both", "axis": 0}, [_distinct(4, 3)]),
             ({"k": 2, "ret_typ": "mask"}, [_distinct(3, 6)]),
             # ties: lax.top_k puts the lowest index first
             ({"k": 2}, [_fixed(TIES)]),
             ({"k": 3, "ret_typ": "both"}, [_fixed(TIES)]),
             ({"k": 2, "ret_typ": "mask"}, [_fixed(TIES)]),
             ({"k": 4, "ret_typ": "value", "is_ascend": True},
              [_fixed(TIES)]),
             ({"k": 2, "ret_typ": "both", "is_ascend": True},
              [_fixed(TIES)]),
             ({"k": 2, "ret_typ": "mask", "is_ascend": True, "axis": 0},
              [_fixed(np.array(TIES).T)]),
             ({"k": 8, "ret_typ": "both"}, [_fixed(SIGNED)]),
             ({"k": 5, "ret_typ": "both", "is_ascend": True},
              [_fixed(SIGNED)]),
             ({"k": 3}, [_fixed([[3, 1, 3, 2, -7, 3]], np.int32)])],
    "sort": [({}, [_distinct(3, 5)]), ({"is_ascend": False, "axis": 0},
                                       [_distinct(3, 5)])],
    "argsort": [({}, [_distinct(3, 5)]),
                ({"is_ascend": False}, [_ids((3, 6), 3)])],
    "dot": [({}, [_randn(3, 4), _randn(4, 5)]),
            ({"transpose_a": True, "transpose_b": True},
             [_randn(4, 3), _randn(5, 4)]),
            ({}, [_randn(2, 3, 4), _randn(4, 5)]),
            ({}, [_randn(2, 3, 4), _randn(6, 4, 5)]),
            ({}, [_randn(4), _randn(4)])],
    "batch_dot": [({}, [_randn(2, 3, 4), _randn(2, 4, 5)]),
                  ({"transpose_a": True, "transpose_b": True},
                   [_randn(2, 4, 3), _randn(2, 5, 4)])],
    "transpose": [({}, [_randn(2, 3, 4)]),
                  ({"axes": (1, 0, 2)}, [_randn(2, 3, 4)])],
    "expand_dims": [({"axis": 1}, [X])],
    "Reshape": [({"shape": (0, -1)}, [_randn(2, 3, 4)]),
                ({"shape": (-1, 4), "reverse": True}, [_randn(2, 3, 4)])],
    "Flatten": [({}, [_randn(2, 3, 4)])],
    "reverse": [({"axis": 1}, [X]), ({"axis": (0, 1)}, [X])],
    "repeat": [({"repeats": 2, "axis": 1}, [X]), ({"repeats": 3}, [X])],
    "tile": [({"reps": (2, 1, 3)}, [X])],
    "slice": [({"begin": (1, 0), "end": (3, 2)}, [_randn(4, 5)]),
              ({"begin": (0, None), "end": (2, -1)}, [_randn(4, 5)])],
    "_crop_assign": [({"begin": (1, 1), "end": (3, 4)},
                      [_randn(4, 5), _randn(2, 3)])],
    "_crop_assign_scalar": [({"begin": (1,), "end": (3,), "scalar": 7.0},
                             [_randn(4, 5)])],
    "slice_axis": [({"axis": 1, "begin": 1, "end": 4}, [_randn(3, 5)]),
                   ({"axis": 0, "begin": 1, "end": None}, [_randn(3, 5)])],
    "clip": [({"a_min": -0.5, "a_max": 0.5}, [X])],
    "take": [({}, [_randn(5, 3), _ids((2, 4), 5)]),
             ({"axis": 1}, [_randn(2, 5, 3), _ids((4,), 5)]),
             ({}, [_randn(5, 3), _fixed(ODD_IDS)]),
             ({"axis": 1}, [_randn(2, 5, 3), _fixed(ODD_IDS)]),
             ({}, [_ints((5, 3)), _fixed(ODD_IDS)]),
             ({}, [_randn(5, 3), _fixed([-1, 7, -6, 4], np.int32)])],
    "batch_take": [({}, [_randn(4, 5), _ids((4,), 5)]),
                   ({}, [_randn(9, 5), _fixed(ODD_IDS)])],
    "one_hot": [({"depth": 6}, [_ids((2, 3), 6)]),
                ({"depth": 4, "on_value": 2.0, "off_value": -1.0},
                 [_ids((5,), 4)]),
                ({"depth": 5}, [_fixed(ODD_IDS)])],
    "SwapAxis": [({"dim1": 0, "dim2": 2}, [_randn(2, 3, 4)])],
    "where": [({}, [_ids((3, 4), 2), _randn(3, 4), _randn(3, 4)])],
    "ElementWiseSum": [({"num_args": 3}, [X, X, _randn(3, 4)])],
    "smooth_l1": [({}, [_randn(3, 4, scale=2)]),
                  ({"scalar": 2.0}, [_randn(3, 4)])],
    "softmax_cross_entropy": [({}, [_randn(4, 6), _ids((4,), 6)])],
    "softmax": [({}, [_randn(2, 3, 4)]), ({"axis": 1}, [_randn(2, 3, 4)])],
    "log_softmax": [({}, [_randn(2, 3, 4)]),
                    ({"axis": 0}, [_randn(2, 3, 4)])],
    "_identity_with_attr_like_rhs": [({}, TWO)],
    "_zeros": [({"shape": (2, 3)}, []),
               ({"shape": (4,), "dtype": "int32"}, [])],
    "_ones": [({"shape": (2, 3)}, [])],
    "_arange": [({"start": 2, "stop": 11, "step": 3}, []),
                ({"start": 5, "repeat": 2}, []),
                ({"start": 0, "stop": 6, "dtype": "int32"}, [])],
    "zeros_like": [({}, [X])], "ones_like": [({}, [X])],
    "_sample_uniform": [({"shape": (400, 500), "low": -1.0, "high": 3.0},
                         [])],
    "_sample_normal": [({"shape": (400, 500), "loc": 0.5, "scale": 2.0},
                        [])],
    "sgd_update": [(OPT, [_randn(3, 4), _randn(3, 4, scale=4)])],
    "sgd_mom_update": [(dict(OPT, momentum=0.9),
                        [_randn(3, 4), _randn(3, 4, scale=4), _randn(3, 4)]),
                       ({"lr": 0.1}, [_randn(3, 4), _randn(3, 4),
                                      _randn(3, 4)])],
    "adam_update": [(dict(OPT, beta1=0.8, beta2=0.99),
                     [_randn(3, 4), _randn(3, 4, scale=4), _randn(3, 4),
                      _unif(0.1, 1.0, 3, 4)])],
    "rmsprop_update": [(dict(OPT, gamma1=0.9),
                        [_randn(3, 4), _randn(3, 4, scale=4),
                         _unif(0.1, 1.0, 3, 4)])],
}

# mean, variance of each sampling op's distribution from its attrs
MOMENTS = {
    "_sample_uniform": lambda a: ((a["low"] + a["high"]) / 2,
                                  (a["high"] - a["low"]) ** 2 / 12),
    "_sample_normal": lambda a: (a["loc"], a["scale"] ** 2),
}


def _tensor_op_names():
    """Every name (ops and aliases) that mxnet_tpu/ops/tensor.py registers,
    with its canonical op name."""
    return [(n, op.name) for n, op in jreg._OPS.items()
            if op.fn.__module__ == "mxnet_tpu.ops.tensor"]


def _params():
    out = []
    for name, canon in _tensor_op_names():
        cases = CASES.get(canon, [])
        if name != canon:
            cases = cases[:1]
        for i, (attrs, makers) in enumerate(cases):
            out.append(pytest.param(name, attrs, makers, id=f"{name}-{i}"))
    return out


def test_every_tensor_op_has_a_case():
    names = _tensor_op_names()
    assert len(names) > 150
    assert sorted({c for _, c in names} - set(CASES)) == []
    assert sorted(set(CASES) - {c for _, c in names}) == []


def test_nd_exposes_every_tensor_op():
    """``mx.nd`` has an eager function for every op the JAX package's
    ``mx.nd`` generates from ops/tensor.py."""
    missing = [n for n, _ in _tensor_op_names()
               if hasattr(mxj.nd, n) and not callable(getattr(mxt.nd, n,
                                                              None))]
    assert missing == []


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name,attrs,makers", _params())
def test_op_matches_jax_body(name, attrs, makers):
    rng = np.random.default_rng(0)
    inputs = [m(rng) for m in makers]
    want = _as_list(jops.get_op(name).fn(
        jops.OpCtx(), dict(attrs), *(jnp.asarray(a) for a in inputs)))
    got = _as_list(tops.get_op(name).fn(
        tops.OpCtx(device=CPU), dict(attrs),
        *(torch.from_numpy(a) for a in inputs)))
    assert len(got) == len(want)
    canon = jops.get_op(name).name
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if canon in MOMENTS:
            mean, var = MOMENTS[canon](attrs)
            # 200k draws: the sample mean's std is sqrt(var / 2e5) < 0.005
            assert abs(g.mean() - mean) < 0.02
            assert abs(g.var() - var) / var < 0.02
            continue
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["_sample_uniform", "_sample_normal"])
def test_sampling_reproducible_under_seed(name):
    attrs = {"shape": (64,)}
    draw = lambda: tops.get_op(name).fn(tops.OpCtx(device=CPU), attrs)  # noqa
    mxt.random.seed(7)
    a = draw()
    b = draw()
    mxt.random.seed(7)
    a2 = draw()
    b2 = draw()
    assert torch.equal(a, a2) and torch.equal(b, b2)
    assert not torch.equal(a, b)
    mxt.random.seed(8)
    assert not torch.equal(draw(), a)


def test_sampling_uses_explicit_generator():
    """``OpCtx.rng`` overrides the per-device generator."""
    attrs = {"shape": (16,)}
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tops.get_op("_sample_normal").fn(tops.OpCtx(rng=g1, device=CPU), attrs)
    b = tops.get_op("_sample_normal").fn(tops.OpCtx(rng=g2, device=CPU), attrs)
    assert torch.equal(a, b)


def test_optimizer_clip_order():
    """sgd clips before adding wd*w; adam adds wd*w before it clips (the
    reference's two orders), visible with a large wd*w."""
    w = np.full((4,), 10.0, np.float32)
    g = np.full((4,), 0.5, np.float32)
    z = np.zeros((4,), np.float32)
    attrs = dict(lr=0.1, wd=1.0, clip_gradient=1.0)
    tw, tg, tz = (torch.from_numpy(a) for a in (w, g, z))
    sgd = tops.get_op("sgd_update").fn(tops.OpCtx(), attrs, tw, tg)
    np.testing.assert_allclose(sgd.numpy(), 10 - 0.1 * (0.5 + 10), rtol=1e-6)
    adam = tops.get_op("adam_update").fn(tops.OpCtx(), attrs, tw, tg, tz,
                                         tz)
    # g = clip(0.5 + 10) = 1; mean = 0.1, var = 0.001
    want = 10 - 0.1 * 0.1 / (np.sqrt(0.001) + 1e-8)
    np.testing.assert_allclose(adam[0].numpy(), want, rtol=1e-5)
