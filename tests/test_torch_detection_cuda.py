"""The detection ops on the card against the same ops on the CPU, and
inside a captured CUDA graph. This file imports no JAX, so it runs on a
machine with only PyTorch:

    python -m pytest -m gpu --noconftest tests/test_torch_detection_cuda.py

fp32; class targets, masks, class ids and ROIPooling's forward exact, the
rest within 1e-5 of max-abs. Without a CUDA device each test skips."""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import get_op
from mxnet_tpu_torch.ops.registry import OpCtx

pytestmark = pytest.mark.gpu
LIMIT = 1e-5


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card")


def _run(name, attrs, *xs, device):
    outs = get_op(name).fn(OpCtx(device=torch.device(device)), dict(attrs),
                           *[torch.from_numpy(x).to(device) for x in xs])
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return [o.cpu() for o in outs]


def _close(got, want):
    return float((got - want).abs().max()) <= LIMIT * max(
        1.0, float(want.abs().max()))


def test_roi_pooling_bin_edges_divide_exactly():
    """A 7-row ROI in 6 bins: the last bin ends at ceil(6 * 7/6) = 7. The
    card divides by a Python scalar through its reciprocal (7/6 rounds up,
    6 * that ceils to 8); the op divides by a tensor."""
    data = np.arange(2 * 3 * 10 * 9, dtype=np.float32).reshape(2, 3, 10, 9)
    rois = np.array([[0, 0, 0, 8, 6], [1, 1.5, 0.5, 7, 6.4],
                     [1, 0, 0, 5, 9]], np.float32)
    for pooled in ((6, 6), (6, 5), (3, 7)):
        attrs = {"pooled_size": pooled, "spatial_scale": 1.0}
        got, = _run("ROIPooling", attrs, data, rois, device="cuda")
        want, = _run("ROIPooling", attrs, data, rois, device="cpu")
        assert torch.equal(got, want), pooled


def test_roi_pooling_gradient_on_the_card():
    rng = np.random.default_rng(0)
    data = np.maximum(rng.standard_normal((4, 8, 16, 16), dtype=np.float32),
                      0)
    x0 = rng.uniform(0, 40, (32, 2))
    rois = np.concatenate([rng.integers(0, 4, (32, 1)), x0,
                           np.minimum(x0 + rng.uniform(4, 30, (32, 2)), 63)],
                          1).astype(np.float32)
    head = rng.standard_normal((32, 8, 6, 6), dtype=np.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        d = torch.from_numpy(data).to(dev).requires_grad_()
        out = get_op("ROIPooling").fn(
            OpCtx(is_train=True), {"pooled_size": (6, 6),
                                   "spatial_scale": 0.25},
            d, torch.from_numpy(rois).to(dev))
        grads[dev] = (out.detach().cpu(), torch.autograd.grad(
            out, d, torch.from_numpy(head).to(dev))[0].cpu())
    assert torch.equal(grads["cuda"][0], grads["cpu"][0])
    assert _close(grads["cuda"][1], grads["cpu"][1])


def _target_inputs(rng, b=4, g=6, classes=5):
    anchors = get_op("MultiBoxPrior").fn(
        OpCtx(), {"sizes": (0.2, 0.35), "ratios": (1.0, 2.0, 0.5)},
        torch.zeros(1, 1, 8, 8)).numpy()
    lab = np.full((b, g, 5), -1.0, np.float32)
    for i in range(b):
        for j in range(rng.integers(1, g)):
            x0, y0 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            lab[i, j] = [rng.integers(0, classes), x0, y0, x0 + w, y0 + h]
    pred = rng.standard_normal((b, classes + 1, anchors.shape[1]),
                               dtype=np.float32)
    return anchors, lab, pred


def test_multibox_target_and_detection_on_the_card():
    rng = np.random.default_rng(1)
    anchors, lab, pred = _target_inputs(rng)
    attrs = {"overlap_threshold": 0.5, "negative_mining_ratio": 3}
    got = _run("MultiBoxTarget", attrs, anchors, lab, pred, device="cuda")
    want = _run("MultiBoxTarget", attrs, anchors, lab, pred, device="cpu")
    assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
    assert _close(got[0], want[0])
    probs = (rng.integers(0, 8, pred.shape) / 8.0).astype(np.float32)
    loc = rng.standard_normal((4, anchors.shape[1] * 4),
                              dtype=np.float32) * 0.3
    attrs = {"threshold": 0.2, "nms_threshold": 0.5, "nms_topk": 100}
    got, = _run("MultiBoxDetection", attrs, probs, loc, anchors,
                device="cuda")
    want, = _run("MultiBoxDetection", attrs, probs, loc, anchors,
                 device="cpu")
    assert torch.equal(got[..., :2], want[..., :2])
    assert _close(got[..., 2:], want[..., 2:])


def test_proposal_on_the_card():
    rng = np.random.default_rng(2)
    k, fh, fw = 6, 9, 11
    probs = (rng.integers(0, 16, (2, 2 * k, fh, fw)) / 16.0).astype(
        np.float32)
    deltas = rng.standard_normal((2, 4 * k, fh, fw), dtype=np.float32) * 0.2
    info = np.array([[fh * 8, fw * 8, 1.0], [fh * 8 - 5, fw * 8, 0.5]],
                    np.float32)
    attrs = dict(feature_stride=8, scales=(2.0, 4.0), ratios=(0.5, 1.0, 2.0),
                 rpn_pre_nms_top_n=100, rpn_post_nms_top_n=40,
                 threshold=0.7, rpn_min_size=4)
    got, = _run("Proposal", attrs, probs, deltas, info, device="cuda")
    want, = _run("Proposal", attrs, probs, deltas, info, device="cpu")
    assert torch.equal(got[:, 0], want[:, 0])
    assert _close(got[:, 1:], want[:, 1:])


def test_detection_ops_capture_in_a_cuda_graph():
    """MultiBoxPrior (a kept constant), MultiBoxTarget and ROIPooling's
    forward and gradient inside one captured graph: a replay on new
    inputs written in place gives what an eager call gives."""
    rng = np.random.default_rng(3)
    anchors, lab, pred = _target_inputs(rng)
    dev = torch.device("cuda")
    ctx = OpCtx(is_train=True, device=dev)
    lab_t = torch.from_numpy(lab).to(dev)
    pred_t = torch.from_numpy(pred).to(dev)
    data = torch.randn(2, 4, 8, 8, device=dev, requires_grad=True)
    rois = torch.tensor([[0, 0, 0, 7, 7], [1, 1, 2, 6, 5]], device=dev,
                        dtype=torch.float32)
    prior, target, roi = (get_op(n).fn for n in (
        "MultiBoxPrior", "MultiBoxTarget", "ROIPooling"))
    attrs = {"overlap_threshold": 0.5, "negative_mining_ratio": 3}
    roi_attrs = {"pooled_size": (3, 3), "spatial_scale": 1.0}

    def body():
        anc = prior(ctx, {"sizes": (0.2, 0.35), "ratios": (1.0, 2.0, 0.5)},
                    torch.empty(1, 1, 8, 8, device=dev))
        outs = target(ctx, attrs, anc, lab_t, pred_t)
        pooled = roi(ctx, roi_attrs, data, rois)
        grad, = torch.autograd.grad(pooled.sum(), data)
        return [*outs, pooled, grad]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = body()
    lab2, pred2 = _target_inputs(np.random.default_rng(4))[1:]
    lab_t.copy_(torch.from_numpy(lab2))
    pred_t.copy_(torch.from_numpy(pred2))
    with torch.no_grad():
        data.copy_(torch.randn(2, 4, 8, 8, device=dev))
    graph.replay()
    torch.cuda.synchronize()
    eager = body()
    for s, e in zip(static, eager):
        assert torch.equal(s, e)
