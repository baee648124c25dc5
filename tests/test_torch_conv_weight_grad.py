"""The port's fp32 convolution weight gradient off cuDNN
(``mxnet_tpu_torch.ops.nn._ConvIeeeWeightGrad``).

On the card with TF32 off, the ``Convolution`` op's weight gradient runs
PyTorch's native CUDA convolution, because cuDNN's algorithm for some
shapes (LeNet's first convolution at batch 8) lands 1e-3 of max-abs from
float64. Here on the CPU the function runs on CPU tensors and must give
autograd's gradients of ``F.conv2d`` exactly (groups, bias, stride,
padding, dilation); the op itself keeps ``F.conv2d`` on the CPU. The card
tests (marked ``gpu``) hold the route and its accuracy; this file imports
no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_conv_weight_grad.py
"""
import pytest
import torch
import torch.nn.functional as F

from mxnet_tpu_torch.ops import get_op
from mxnet_tpu_torch.ops.nn import _ConvIeeeWeightGrad, _native_weight_grad
from mxnet_tpu_torch.ops.registry import OpCtx

CASES = [
    # (in channels, filters, kernel, stride, pad, dilation, groups, bias)
    (1, 20, 5, (1, 1), (0, 0), (1, 1), 1, True),
    (8, 6, 3, (2, 1), (1, 0), (1, 2), 2, False),
    (8, 8, 3, (1, 1), (1, 1), (1, 1), 4, True),
    (6, 4, 1, (2, 2), (0, 0), (1, 1), 1, False),
]


def _inputs(c, f, k, groups, bias, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, c, 11, 11, generator=g, dtype=dtype)
    w = torch.randn(f, c // groups, k, k, generator=g, dtype=dtype)
    b = torch.randn(f, generator=g, dtype=dtype) if bias else None
    return [t.requires_grad_() if t is not None else None for t in (x, w, b)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", CASES)
def test_function_equals_autograd_of_conv2d(case, dtype):
    c, f, k, stride, pad, dil, groups, bias = case
    x, w, b = _inputs(c, f, k, groups, bias, dtype)
    conf = (stride, pad, dil, groups)
    got = _ConvIeeeWeightGrad.apply(x, w, b, conf)
    want = F.conv2d(x, w, b, *conf)
    assert torch.equal(got, want)
    dy = torch.randn_like(want)
    leaves = [t for t in (x, w, b) if t is not None]
    for a, e in zip(torch.autograd.grad(got, leaves, dy),
                    torch.autograd.grad(want, leaves, dy)):
        assert torch.equal(a, e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", CASES)
def test_native_weight_grad_equals_autograd(case, dtype):
    """The card's weight gradient (``_native_weight_grad``: the native
    convolution called directly, no process-wide cuDNN switch), run here on
    CPU tensors, against autograd's weight gradient of ``F.conv2d``: within
    the dtype's rounding (fp32 1e-6, fp64 1e-13 of max-abs; read 3.2e-7
    and 6.4e-16, exact without groups or dilation)."""
    c, f, k, stride, pad, dil, groups, bias = case
    x, w, b = _inputs(c, f, k, groups, bias, dtype)
    conf = (stride, pad, dil, groups)
    y = F.conv2d(x, w, b, *conf)
    dy = torch.randn_like(y)
    (want,) = torch.autograd.grad(y, [w], dy)
    got = _native_weight_grad(dy, x.detach(), w.detach(), stride, pad, dil,
                              groups)
    limit = 1e-6 if dtype == torch.float32 else 1e-13
    assert float((got - want).abs().max()) <= limit * float(
        want.abs().max())
    if groups == 1 and dil == (1, 1):
        assert torch.equal(got, want)


def test_function_gradcheck():
    x, w, b = _inputs(2, 3, 3, 1, True, torch.float64)
    assert torch.autograd.gradcheck(
        lambda x_, w_, b_: _ConvIeeeWeightGrad.apply(
            x_, w_, b_, ((1, 1), (1, 1), (1, 1), 1)), (x, w, b))


def test_only_the_needed_gradients():
    """A weight that needs no gradient leaves the input's; data that needs
    none (a first layer) leaves the weight's."""
    x, w, _ = _inputs(4, 5, 3, 1, False, torch.float32)
    conf = ((1, 1), (0, 0), (1, 1), 1)
    y = _ConvIeeeWeightGrad.apply(x.detach(), w, None, conf)
    (gw,) = torch.autograd.grad(y.sum(), [w])
    assert gw.shape == w.shape
    y = _ConvIeeeWeightGrad.apply(x, w.detach(), None, conf)
    (gx,) = torch.autograd.grad(y.sum(), [x])
    assert gx.shape == x.shape


def test_the_cpu_keeps_conv2d():
    x, w, _ = _inputs(1, 20, 5, 1, False, torch.float32)
    ctx = OpCtx(is_train=True, device=torch.device("cpu"))
    y = get_op("Convolution").fn(
        ctx, {"kernel": (5, 5), "num_filter": 20, "no_bias": True}, x, w)
    assert type(y.grad_fn).__name__ == "ConvolutionBackward0"


# -- on the card ----------------------------------------------------------------

def _lenet_conv1_weight_grad(allow_tf32):
    """The port's weight gradient of LeNet's first convolution at batch 8
    on the card, its gap to float64 over float64's max-abs, and the route
    (the autograd node's name)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 1, 28, 28, generator=gen, dtype=torch.float64)
    w = torch.randn(20, 1, 5, 5, generator=gen, dtype=torch.float64) * 0.2
    dy = torch.randn(8, 20, 24, 24, generator=gen, dtype=torch.float64)
    want = torch.nn.grad.conv2d_weight(x, w.shape, dy)
    ctx = OpCtx(is_train=True, device=torch.device("cuda", 0))
    ww = w.float().cuda().requires_grad_()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        y = get_op("Convolution").fn(
            ctx, {"kernel": (5, 5), "num_filter": 20, "no_bias": True},
            x.float().cuda(), ww)
        (got,) = torch.autograd.grad(y, [ww], dy.float().cuda())
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    gap = float((got.double().cpu() - want).abs().max() / want.abs().max())
    return gap, type(y.grad_fn).__name__


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.gpu
def test_tf32_off_weight_gradient_is_fp32_exact_on_the_card(card):
    gap, route = _lenet_conv1_weight_grad(False)
    assert route == "_ConvIeeeWeightGradBackward"
    assert gap <= 1e-5, gap


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_native_weight_grad_is_convolution_backward_without_cudnn(card,
                                                                  case):
    """On the card the direct call gives ``convolution_backward``'s weight
    gradient with cuDNN off bit for bit (the dilated case, through
    ``F.unfold``, within 1e-6 of max-abs), and it leaves cuDNN on."""
    c, f, k, stride, pad, dil, groups, bias = case
    x, w, b = (t.detach().cuda() if t is not None else None
               for t in _inputs(c, f, k, groups, bias, torch.float32))
    dy = torch.randn_like(F.conv2d(x, w, b, stride, pad, dil, groups))
    got = _native_weight_grad(dy, x, w, stride, pad, dil, groups)
    assert torch.backends.cudnn.enabled
    with torch.backends.cudnn.flags(enabled=False):
        want = torch.ops.aten.convolution_backward(
            dy, x, w, None, stride, pad, dil, False, [0, 0], groups,
            [False, True, False])[1]
    if dil == (1, 1):
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


@pytest.mark.gpu
def test_tf32_on_keeps_cudnn_on_the_card(card):
    _, route = _lenet_conv1_weight_grad(True)
    assert route == "ConvolutionBackward0"
