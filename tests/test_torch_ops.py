"""Each op that the port registers (mxnet_tpu_torch.ops) against the JAX
package's op body of the same name, fp32, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import ops as jops
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch.ndarray import infer_reshape

RTOL, ATOL = 1e-5, 1e-6


def _randn(*shape):
    return lambda rng: rng.standard_normal(shape).astype(np.float32)


def _weight(out_dim, in_dim):
    """Weights at an initializer's scale (std 1/sqrt(fan_in)), so that
    activations stay O(1) as in a real model."""
    return lambda rng: (rng.standard_normal((out_dim, in_dim))
                        / np.sqrt(in_dim)).astype(np.float32)


def _ids(shape, n):
    return lambda rng: rng.integers(0, n, shape).astype(np.float32)


def _fixed(values):
    return lambda rng: np.array(values, np.float32)


_W = [_weight(12, 12)] * 4   # RingAttention q/k/v/out weights

# op name, attrs, input makers
CASES = [
    ("Embedding", {"input_dim": 10, "output_dim": 4},
     [_ids((2, 5), 10), _randn(10, 4)]),
    # negative ids wrap, ids outside [-10, 10) give NaN rows, NaN is id 0
    ("Embedding", {"input_dim": 10, "output_dim": 4},
     [_fixed([[-1, -10, -11, 10], [np.nan, 3e9, -3e9, 9]]), _randn(10, 4)]),
    ("LayerNorm", {}, [_randn(2, 5, 8), _randn(8), _randn(8)]),
    ("LayerNorm", {"axis": 1, "eps": 1e-3},
     [_randn(3, 6, 2), _randn(6), _randn(6)]),
    ("FullyConnected", {"num_hidden": 6},
     [_randn(4, 3, 5), _randn(6, 15), _randn(6)]),
    ("FullyConnected", {"num_hidden": 6, "no_bias": True},
     [_randn(4, 5), _randn(6, 5)]),
    ("Activation", {"act_type": "relu"}, [_randn(3, 7)]),
    ("Activation", {"act_type": "sigmoid"}, [_randn(3, 7)]),
    ("Activation", {"act_type": "tanh"}, [_randn(3, 7)]),
    ("Activation", {"act_type": "softrelu"}, [_randn(3, 7)]),
    ("SoftmaxOutput", {"use_ignore": True, "ignore_label": -1},
     [_randn(6, 10), _ids((6,), 10)]),
    ("SoftmaxOutput", {"multi_output": True},
     [_randn(2, 5, 3), _ids((2, 3), 5)]),
    ("elemwise_add", {}, [_randn(2, 3, 4), _randn(2, 3, 4)]),
    ("broadcast_add", {}, [_randn(2, 3, 4), _randn(1, 3, 4)]),
    ("expand_dims", {"axis": 0}, [_randn(3, 4)]),
    ("expand_dims", {"axis": -1}, [_randn(3, 4)]),
    ("Reshape", {"shape": (0, -1)}, [_randn(2, 3, 4)]),
    ("Reshape", {"shape": (-1, 4)}, [_randn(2, 3, 4)]),
    ("Reshape", {"shape": (-1,)}, [_randn(2, 3, 4)]),
    ("Reshape", {"shape": (4, 0, 2)}, [_randn(2, 3, 4)]),
    ("RingAttention", {"num_heads": 3, "causal": True},
     [_randn(2, 8, 12)] + _W),
    ("RingAttention", {"num_heads": 3, "causal": False},
     [_randn(2, 8, 12)] + _W),
    ("MultiHeadAttention", {"num_heads": 4, "causal": True},
     [_randn(1, 16, 12)] + _W),
]


@pytest.mark.parametrize("name,attrs,makers", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_matches_jax_body(name, attrs, makers):
    rng = np.random.default_rng(0)
    inputs = [m(rng) for m in makers]
    want = jops.get_op(name).fn(jops.OpCtx(), dict(attrs),
                                *(jnp.asarray(a) for a in inputs))
    got = tops.get_op(name).fn(tops.OpCtx(), dict(attrs),
                               *(torch.from_numpy(a) for a in inputs))
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("old,new,want", [
    # MXNet's documented examples (ReshapeParam, matrix_op-inl.h)
    ((2, 3, 4), (4, 0, 2), (4, 3, 2)),
    ((2, 3, 4), (6, 1, -1), (6, 1, 4)),
    ((2, 3, 4), (3, -1, 8), (3, 1, 8)),
    ((2, 3, 4), (-2,), (2, 3, 4)),
    ((2, 3, 4), (2, -2), (2, 3, 4)),
    ((2, 3, 4), (-2, 1, 1), (2, 3, 4, 1, 1)),
    ((2, 3, 4), (-3, 4), (6, 4)),
    ((2, 3, 4, 5), (-3, -3), (6, 20)),
    ((2, 3, 4), (0, -3), (2, 12)),
    ((2, 3, 4), (-3, -2), (6, 4)),
    ((2, 3, 4), (-4, 1, 2, -2), (1, 2, 3, 4)),
    ((2, 3, 4), (2, -4, -1, 3, -2), (2, 1, 3, 4)),
])
def test_reshape_special_codes(old, new, want):
    assert infer_reshape(old, new) == want
    x = torch.arange(int(np.prod(old)), dtype=torch.float32).reshape(old)
    got = tops.get_op("Reshape").fn(tops.OpCtx(), {"shape": new}, x)
    assert tuple(got.shape) == want
    np.testing.assert_array_equal(got.numpy().ravel(), x.numpy().ravel())


def test_ndarray_surface_matches_jax_package():
    """array/zeros/empty, shape, dtype, asnumpy, reshape and the full-slice
    write, as the Predictor uses them, on the CPU."""
    import mxnet_tpu as mxj
    import mxnet_tpu_torch as mxt

    src = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    a_j, a_t = mxj.nd.array(src), mxt.nd.array(src, mxt.cpu())
    assert a_t.shape == a_j.shape and a_t.dtype == torch.float32
    np.testing.assert_array_equal(a_t.asnumpy(), a_j.asnumpy())
    np.testing.assert_array_equal(a_t.reshape((0, -1)).asnumpy(),
                                  a_j.reshape((0, -1)).asnumpy())
    z_t = mxt.nd.zeros((2, 3, 4), mxt.cpu())
    z_t[:] = src * 2
    np.testing.assert_array_equal(z_t.asnumpy(), src * 2)
    z_t[:] = 7.0
    assert (z_t.asnumpy() == 7.0).all()
    e_t = mxt.nd.empty((5,), mxt.cpu(), dtype="int32")
    assert e_t.shape == (5,) and e_t.dtype == torch.int32
    assert a_t.as_in_context(mxt.cpu()) is a_t
    assert a_t.context == mxt.cpu()
