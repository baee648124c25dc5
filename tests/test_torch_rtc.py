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


@pytest.mark.parametrize("n,itemsize,want", [
    (4096 * 32768, 4, 131072), (4096 * 32768, 2, 65536), (1000003, 4, 977),
    (1, 4, 1), (7, 2, 1), (1024, 4, 1), (1028, 4, 2), (2048, 2, 1),
    (2056, 2, 2), (0, 4, 1)])
def test_axpy_grid_a_thread_a_vector(n, itemsize, want):
    """The axpy launch: one thread for each 16-byte vector (a partial one
    counts), in blocks of 256; a function of n and the element size."""
    grid, block = ex.axpy_dims(n, itemsize)
    assert grid == (want, 1, 1) and block == (256, 1, 1)


@pytest.mark.parametrize("n,offset,itemsize,want", [
    # x, y and o at one byte offset: the head runs to the 16-byte boundary
    (1000003, 0, 4, (0, 250000, 3)), (1000003, 4, 4, (3, 250000, 0)),
    (1000003, 8, 4, (2, 250000, 1)), (1000003, 12, 4, (1, 250000, 2)),
    (1000003, 2, 2, (7, 124999, 4)), (1000003, 14, 2, (1, 125000, 2)),
    (1, 4, 4, (1, 0, 0)), (3, 0, 4, (0, 0, 3)), (7, 0, 2, (0, 0, 7)),
    (7, 6, 2, (5, 0, 2)), (8, 0, 2, (0, 1, 0)), (0, 4, 4, (0, 0, 0))])
def test_axpy_head_vectors_tail(n, offset, itemsize, want):
    base = 1 << 20
    got = ex.axpy_split(n, base + offset, base + 4096 + offset,
                        base + 8192 + offset, itemsize)
    assert got == want
    head, vectors, tail = got
    assert head + vectors * (16 // itemsize) + tail == n


@pytest.mark.parametrize("offsets", [(4, 0, 0), (0, 4, 0), (0, 0, 8),
                                     (2, 2, 0)])
def test_axpy_unlike_alignment_runs_scalar(offsets):
    """Inputs viewed at an offset while the output is aligned (or any other
    mix): no 16-byte vector can serve all three, so all of it is head."""
    base = 1 << 20
    x, y, o = (base + 4096 * i + off for i, off in enumerate(offsets))
    assert ex.axpy_split(1000003, x, y, o, 2) == (1000003, 0, 0)


def test_axpy_source_vectors():
    for dtype, ve in (("float32", 4), ("bfloat16", 8)):
        src = ex.axpy_source(dtype)
        assert f"#define VE {ve}" in src
        assert "ov[i] = axpy4(xv[i], yv[i])" in src
        assert 'extern "C" __global__' in src
    assert "#include <cuda_bf16.h>" in ex.axpy_source("bfloat16")


class _FakeLauncher:
    def __init__(self, log):
        self.log = log

    def __call__(self, values, grid, block):
        self.log.append((list(values), grid, block))


def _stub_card(monkeypatch, log, device=torch.device("cuda", 0)):
    """Launches without a card: tensors pass as if on ``device``, and each
    compile returns a launcher that records its calls."""
    built = []

    def launcher(self, source, device, n_params):
        built.append((source, device.index, n_params))
        return _FakeLauncher(log)

    monkeypatch.setattr(rtc, "_check_cuda_tensors",
                        lambda what, tensors: device)
    monkeypatch.setattr(rtc._Program, "launcher", launcher)
    return built


def test_rtc_push_builds_source_once_per_signature(monkeypatch):
    """A repeated push with the same (dtype, size) signature builds no
    source and compiles nothing; another signature builds its own."""
    log, calls = [], []
    real = rtc.rtc_source

    def counting(*args):
        calls.append(args[0])
        return real(*args)

    built = _stub_card(monkeypatch, log)
    g, w, m = (torch.zeros(10) for _ in range(3))
    k = ex.sgd_mom_rtc(g, w, m)
    monkeypatch.setattr(rtc, "rtc_source", counting)
    for _ in range(3):
        k.push([g], [w, m])
    assert len(calls) == 1 and len(built) == 1 and len(log) == 3
    assert built[0][1:] == (0, 3)
    assert log[0][1:] == ((1, 1, 1), (256, 1, 1))
    assert log[0][0] == [t.data_ptr() for t in (g, w, m)]
    g2, w2, m2 = (torch.zeros(300) for _ in range(3))
    k.push([g2], [w2, m2])
    k.push([g2], [w2, m2], grid_dims=(5,), block_dims=(32,))
    k.push([g], [w, m])
    assert len(calls) == 2 and len(built) == 2 and k.launches == 6
    assert "weight_size = 300LL" in built[1][0]
    assert log[4][1:] == ((5, 1, 1), (32, 1, 1))


def test_cuda_kernel_launch_record_reused(monkeypatch):
    """CudaKernel keeps one launch record per (device, argument count);
    axpy's launch is a thread a vector; a call's grid_dims win. (The
    output is allocated on the CPU here, where the stub puts it.)"""
    log = []
    built = _stub_card(monkeypatch, log, torch.device("cpu"))
    k = ex.axpy_kernel("bfloat16")
    x = torch.zeros(1000003, dtype=torch.bfloat16)
    for _ in range(3):
        out = k(x, x)
    k(x, x, grid_dims=(7,))
    assert len(built) == 1 and built[0][2] == 4 and k.launches == 4
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert log[0][1:] == ((489, 1, 1), (256, 1, 1))   # 125001 vectors
    assert log[0][0][3] == 1000003
    assert log[3][1:] == ((7, 1, 1), (256, 1, 1))
