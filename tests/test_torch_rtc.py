"""The port's runtime kernels (mxnet_tpu_torch.rtc) on the CPU, where no CUDA
source can run: the source ``Rtc`` writes around a body (the signature per
dtype), the argument and shape checks, that ``push`` and ``__call__`` raise
on CPU and ``meta`` tensors (no fallback), and the JAX package's
``PallasKernel`` axpy (interpret mode, as tests/test_deploy.py runs it)
against the port's plain axpy on the same inputs. The kernels themselves run
in tests/test_torch_cuda_kernels.py on the card."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch import rtc_examples as ex

C = mxt.cpu()


@pytest.mark.parametrize("dtype,ctype", [
    ("float32", "float"), ("float16", "__half"),
    ("bfloat16", "__nv_bfloat16"), ("int32", "int"),
    ("int64", "long long")])
def test_rtc_signature_per_dtype(dtype, ctype):
    x = mxt.nd.zeros((3, 5), C, dtype=dtype)
    y = mxt.nd.zeros((7,), C, dtype=dtype)
    k = rtc.Rtc("scale", [("x", x)], [("y", y)], "y[0] = x[0];")
    src = k.source
    assert f'extern "C" __global__ void scale(const {ctype}* x, {ctype}* y)' \
        in src
    assert f"typedef {ctype} x_t;" in src
    assert "const long long x_size = 15LL;" in src
    assert "const long long y_size = 7LL;" in src
    assert "#include <cuda_bf16.h>" in src and "#include <cuda_fp16.h>" in src
    assert src.rstrip().endswith("y[0] = x[0];\n}")


def test_rtc_signature_mixed_inputs_and_outputs():
    a = mxt.nd.zeros((4,), C)
    b = mxt.nd.zeros((4,), C, dtype="int32")
    o1 = mxt.nd.zeros((4,), C, dtype="bfloat16")
    o2 = mxt.nd.zeros((2, 2), C, dtype="int64")
    k = rtc.Rtc("mix", [("a", a), ("b", b)], [("o1", o1), ("o2", o2)], "")
    assert re.search(r'void mix\(const float\* a, const int\* b, '
                     r'__nv_bfloat16\* o1, long long\* o2\)', k.source)
    assert k.input_names == ["a", "b"] and k.output_names == ["o1", "o2"]


def test_rtc_argument_checks():
    x = mxt.nd.zeros((4,), C)
    with pytest.raises(mxt.MXNetError, match="at least one output"):
        rtc.Rtc("k", [("x", x)], [], "")
    with pytest.raises(mxt.MXNetError, match="repeated"):
        rtc.Rtc("k", [("x", x)], [("x", x)], "")
    with pytest.raises(mxt.MXNetError, match="no CUDA type"):
        rtc.Rtc("k", [("x", mxt.nd.zeros((4,), C, dtype="uint8"))],
                [("y", x)], "")
    k = rtc.Rtc("k", [("x", x)], [("y", x.copy())], "")
    with pytest.raises(mxt.MXNetError, match="expected 1 inputs and 1 "
                       "outputs"):
        k.push([x, x], [x])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_push_off_the_card_raises(device):
    """No fallback: a CPU (or meta) tensor raises before anything compiles,
    for both front ends, on NDArrays and on tensors."""
    x = torch.zeros(8, device=device)
    y = torch.zeros(8, device=device)
    k = ex.axpy_kernel()
    with pytest.raises(mxt.MXNetError, match="only on the card"):
        k.push([mxt.nd.NDArray(x), mxt.nd.NDArray(y)])
    with pytest.raises(mxt.MXNetError, match="only on the card"):
        k(x, y)
    r = ex.sgd_mom_rtc(x, x.clone(), x.clone())
    with pytest.raises(mxt.MXNetError, match="only on the card"):
        r.push([mxt.nd.NDArray(x)], [mxt.nd.NDArray(y),
                                     mxt.nd.NDArray(y.clone())])
    assert k.launches == 0 and r.launches == 0
    assert k.compile_s == 0.0 and r.compile_s == 0.0


def test_launch_dims_checked():
    with pytest.raises(mxt.MXNetError, match="grid_dims"):
        rtc._dims((0, 1), "grid_dims")
    with pytest.raises(mxt.MXNetError, match="block_dims"):
        rtc._dims((1, 1, 1, 1), "block_dims")
    assert rtc._dims((5,), "grid_dims") == (5, 1, 1)
    assert rtc._default_grid(1000003) == ((3907, 1, 1), (256, 1, 1))
    assert rtc._default_grid(0) == ((1, 1, 1), (256, 1, 1))


def test_options_and_toolkit_paths(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    opts = rtc.default_options()
    assert opts[0] == "--gpu-architecture=sm_90a"
    assert f"-I{tmp_path}/include" in opts
    with pytest.raises(mxt.MXNetError, match="NVRTC not found"):
        rtc._nvrtc_path()
    (tmp_path / "lib64").mkdir()
    (tmp_path / "lib64" / "libnvrtc.so.12").write_bytes(b"")
    (tmp_path / "lib64" / "libnvrtc-builtins.so.12").write_bytes(b"")
    assert rtc._nvrtc_path().endswith("lib64/libnvrtc.so.12")


def test_float_literals_round_trip():
    for v in (1.0, 0.05, 0.9, 1e-4, 0.5, 3):
        lit = ex._f32(v)
        assert lit.endswith("f") and ("." in lit or "e" in lit)
        assert np.float32(float(lit[:-1])) == np.float32(v)
    body = ex.sgd_mom_body(lr=0.1, clip_gradient=-1.0)
    assert "fminf" not in body
    assert "fminf(fmaxf(g, -1.0f), 1.0f)" in ex.sgd_mom_body(
        lr=0.1, clip_gradient=1)


def test_pallas_axpy_matches_port_plain_axpy():
    """The JAX package's own runtime-kernel case, run in interpret mode,
    against the port's plain axpy on the same numpy inputs."""
    rng = np.random.default_rng(0)
    x = rng.random((16, 16)).astype(np.float32)
    y = rng.random((16, 16)).astype(np.float32)

    def axpy(x_ref, y_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + y_ref[...]

    kern = mxj.rtc.PallasKernel("axpy", axpy)
    want = kern.push([mxj.nd.array(x), mxj.nd.array(y)]).asnumpy()
    got = ex.axpy_reference(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(x) * 2.0 + jnp.asarray(y)), got.numpy())


def test_sgd_mom_plain_matches_jax_op():
    """The plain SGD-momentum the Rtc kernel is held to is the JAX
    package's ``sgd_mom_update`` on the same inputs."""
    rng = np.random.default_rng(1)
    w, g, m = (rng.standard_normal((6, 5)).astype(np.float32)
               for _ in range(3))
    got = ex.sgd_mom_reference(*(torch.from_numpy(a) for a in (w, g, m)))
    from mxnet_tpu import ops as jops

    want = jops.get_op("sgd_mom_update").fn(
        jops.OpCtx(), dict(ex.SGD_MOM_ARGS),
        *(jnp.asarray(a) for a in (w, g, m)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
