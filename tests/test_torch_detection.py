"""The detection ops against the JAX package on the CPU: ``MultiBoxPrior``,
``MultiBoxTarget``, ``MultiBoxDetection``, ``Proposal``, ``ROIPooling``,
``Correlation``, ``SoftmaxActivation`` and ``MakeLoss``. Each case feeds
both packages' op bodies the same numpy inputs made from a seed, in fp32:
outputs within 1e-5 of their max-abs, integer-valued outputs (class ids,
masks, class targets, batch indices) exact, gradients against
``jax.vjp``. The cases with ties (equal scores, all hardness equal,
repeated best anchors, tied maxima) hold the port to the reference's
order. Where a random case's result turns on a comparison (an IoU against
a threshold, a rank), the test first asserts that every such comparison
clears the tolerance, so that a failure names a near-tie."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import ops as jops
from mxnet_tpu.ops.registry import OpCtx as JOpCtx
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch.ops.registry import OpCtx as TOpCtx

LIMIT = 1e-5
# the least gap a decision of a random case must clear
GAP = 1e-5


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _both(name, attrs, *xs):
    """The op body of each package on the same numpy inputs: (port,
    reference) lists of numpy outputs."""
    t = tops.get_op(name).fn(TOpCtx(), dict(attrs),
                             *[torch.from_numpy(np.array(x)) for x in xs])
    j = jax.jit(lambda *a: jops.get_op(name).fn(JOpCtx(), dict(attrs), *a))(
        *[jnp.asarray(x) for x in xs])
    as_list = (lambda o: list(o) if isinstance(o, (tuple, list)) else [o])
    return ([o.detach().numpy() for o in as_list(t)],
            [np.asarray(o) for o in as_list(j)])


def _vjp_both(name, attrs, xs, head, wrt=(0,)):
    """Output and gradients with respect to the inputs ``wrt`` of each
    package under the head gradient ``head``."""
    ts = [torch.tensor(x, requires_grad=i in wrt) for i, x in enumerate(xs)]
    out = tops.get_op(name).fn(TOpCtx(is_train=True), dict(attrs), *ts)
    out.backward(torch.from_numpy(head))
    t_grads = [ts[i].grad.numpy() for i in wrt]

    def f(*diff):
        full = [jnp.asarray(x) for x in xs]
        for i, d in zip(wrt, diff):
            full[i] = d
        return jops.get_op(name).fn(JOpCtx(is_train=True), dict(attrs),
                                    *full)

    @jax.jit
    def out_and_grads(diff, h):
        out, vjp = jax.vjp(f, *diff)
        return out, vjp(h)

    j_out, j_grads = out_and_grads([jnp.asarray(xs[i]) for i in wrt],
                                   jnp.asarray(head))
    j_grads = [np.asarray(g) for g in j_grads]
    return (out.detach().numpy(), t_grads), (np.asarray(j_out), j_grads)


# -- the reference's own cases (tests/test_detection.py), through Symbol.eval

def _eval(pkg, build, feeds):
    sym = build(pkg)
    ctx = pkg.cpu()
    args = {k: (pkg.nd.array(v, ctx) if pkg is mxt else pkg.nd.array(v))
            for k, v in feeds.items()}
    return [o.asnumpy() for o in sym.eval(ctx=ctx, **args)]


def _case_prior():
    return (lambda mx: mx.sym.MultiBoxPrior(
        mx.sym.Variable("data"), sizes=(0.5, 0.25), ratios=(1.0, 2.0)),
        {"data": np.zeros((1, 3, 4, 4), np.float32)})


def _case_target():
    anchors = np.array([[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                        [0.0, 0.5, 0.5, 1.0]], np.float32)[None]
    label = np.array([[[1.0, 0.05, 0.05, 0.45, 0.45],
                       [-1, 0, 0, 0, 0]]], np.float32)
    return (lambda mx: mx.sym.MultiBoxTarget(
        mx.sym.Variable("a"), mx.sym.Variable("l"), mx.sym.Variable("p")),
        {"a": anchors, "l": label, "p": np.zeros((1, 2, 3), np.float32)})


def _case_detection():
    anchors = np.array([[0.1, 0.1, 0.4, 0.4], [0.12, 0.12, 0.42, 0.42],
                        [0.6, 0.6, 0.9, 0.9]], np.float32)[None]
    cls_prob = np.zeros((1, 2, 3), np.float32)
    cls_prob[0, 1] = [0.9, 0.8, 0.7]
    cls_prob[0, 0] = 1.0 - cls_prob[0, 1]
    return (lambda mx: mx.sym.MultiBoxDetection(
        mx.sym.Variable("c"), mx.sym.Variable("l"), mx.sym.Variable("a"),
        nms_threshold=0.5),
        {"c": cls_prob, "l": np.zeros((1, 12), np.float32), "a": anchors})


def _case_roi():
    data = np.arange(36, dtype=np.float32).reshape(1, 1, 6, 6)
    return (lambda mx: mx.sym.ROIPooling(
        mx.sym.Variable("d"), mx.sym.Variable("r"), pooled_size=(2, 2),
        spatial_scale=1.0),
        {"d": data, "r": np.array([[0, 0, 0, 5, 5]], np.float32)})


def _case_roi_batch():
    data = np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32)
    rois = np.array([[0, 0, 0, 7, 7], [1, 2, 2, 6, 6]], np.float32)
    return (lambda mx: mx.sym.ROIPooling(
        mx.sym.Variable("d"), mx.sym.Variable("r"), pooled_size=(3, 3),
        spatial_scale=1.0), {"d": data, "r": rois})


def _case_correlation():
    x = np.random.RandomState(1).randn(1, 4, 6, 6).astype(np.float32)
    return (lambda mx: mx.sym.Correlation(
        mx.sym.Variable("a"), mx.sym.Variable("b"), kernel_size=1,
        max_displacement=1, stride1=1, stride2=1, pad_size=1),
        {"a": x, "b": x})


REFERENCE_CASES = {"prior": _case_prior, "target": _case_target,
                   "detection": _case_detection, "roi": _case_roi,
                   "roi_batch": _case_roi_batch,
                   "correlation": _case_correlation}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_detection_cases(case):
    build, feeds = REFERENCE_CASES[case]()
    got = _eval(mxt, build, feeds)
    want = _eval(mxj, build, feeds)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= LIMIT
    if case == "target":
        loc_t, loc_mask, cls_t = got
        assert cls_t[0].tolist() == [2.0, 0.0, 0.0]
        assert loc_mask.reshape(3, 4).sum(1).tolist() == [4, 0, 0]
    if case == "detection":
        kept = got[0][0][got[0][0, :, 0] >= 0]
        np.testing.assert_allclose(sorted(kept[:, 1]), [0.7, 0.9], atol=1e-6)
    if case == "roi":
        np.testing.assert_array_equal(got[0][0, 0], [[14, 17], [32, 35]])


# -- MultiBoxPrior

PRIOR_ATTRS = [
    {"sizes": (0.2, 0.3), "ratios": (1.0, 2.0, 0.5)},
    {"sizes": 0.4, "ratios": 1.0},
    {"sizes": (0.1,), "ratios": (1.0, 3.0), "steps": (0.1, 0.125),
     "offsets": (0.25, 0.75)},
    {"sizes": (0.5, 0.7), "ratios": (2.0, 0.5), "steps": (-1.0, 0.2)},
]


@pytest.mark.parametrize("attrs", PRIOR_ATTRS, ids=range(len(PRIOR_ATTRS)))
def test_multibox_prior(attrs):
    x = np.zeros((2, 3, 5, 7), np.float32)
    (got,), (want,) = _both("MultiBoxPrior", attrs, x)
    assert got.shape == want.shape
    assert _rel_err(got, want) <= LIMIT


def test_ops_have_contrib_aliases():
    for name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                 "Proposal"):
        assert tops.get_op("_contrib_" + name) is tops.get_op(name)


# -- MultiBoxTarget

def _anchors(h=4, w=4):
    return tops.get_op("MultiBoxPrior").fn(
        TOpCtx(), {"sizes": (0.3, 0.45), "ratios": (1.0, 2.0, 0.5)},
        torch.zeros(1, 1, h, w)).numpy()


def _labels(rng, b, g):
    """(B, G, 5) boxes of random class and corners, the last rows of each
    sample padded with -1."""
    lab = np.full((b, g, 5), -1.0, np.float32)
    for i in range(b):
        for j in range(rng.randint(1, g + 1)):
            x0, y0 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.15, 0.4, 2)
            lab[i, j] = [rng.randint(0, 3), x0, y0, x0 + w, y0 + h]
    return lab


def _target_gaps(anchors, label, cls_pred, attrs):
    """Assert that every decision of the target op clears GAP: each
    anchor's best IoU against the threshold, and where negatives are mined,
    the hardness on each side of the keep boundary."""
    a = torch.from_numpy(anchors).reshape(-1, 4)
    from mxnet_tpu_torch.ops.contrib_det import _iou_matrix

    thresh = float(attrs.get("overlap_threshold", 0.5))
    for b in range(label.shape[0]):
        valid = label[b, :, 0] >= 0
        iou = _iou_matrix(a, torch.from_numpy(label[b, :, 1:5])).numpy()
        best = np.where(valid[None], iou, -1.0).max(1)
        assert np.abs(best - thresh).min() > GAP, "an IoU near the threshold"
    ratio = float(attrs.get("negative_mining_ratio", -1))
    if ratio <= 0 or not np.any(cls_pred):
        return
    (_, _, cls_t), _ = _both("MultiBoxTarget",
                             {**attrs, "negative_mining_ratio": -1},
                             anchors, label, cls_pred)
    conf = torch.softmax(torch.from_numpy(cls_pred), 1).numpy()
    for b in range(label.shape[0]):
        neg = cls_t[b] == 0
        hard = np.sort(conf[b, 1:].max(0)[neg])[::-1]
        keep = int(ratio * (~neg).sum())
        if 0 < keep < len(hard):
            assert hard[keep - 1] - hard[keep] > GAP, "a rank near a tie"


TARGET_CASES = {
    "no_mining": {"overlap_threshold": 0.5},
    "mining": {"overlap_threshold": 0.5, "negative_mining_ratio": 3},
    "mining_all_tied": {"overlap_threshold": 0.4,
                        "negative_mining_ratio": 2},
    "variances": {"overlap_threshold": 0.3, "variances": (0.2, 0.1, 0.3, 0.4),
                  "negative_mining_ratio": 1},
}


@pytest.mark.parametrize("case", sorted(TARGET_CASES))
def test_multibox_target(case):
    attrs = TARGET_CASES[case]
    rng = np.random.RandomState(sorted(TARGET_CASES).index(case))
    anchors = _anchors()
    label = _labels(rng, 3, 4)
    na = anchors.shape[1]
    cls_pred = rng.randn(3, 4, na).astype(np.float32)
    if case == "mining_all_tied":
        cls_pred[:] = 0.0     # every hardness ties (tests/test_detection.py)
    _target_gaps(anchors, label, cls_pred, attrs)
    got, want = _both("MultiBoxTarget", attrs, anchors, label, cls_pred)
    loc_t, loc_mask, cls_t = got
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_array_equal(cls_t, want[2])
    np.testing.assert_array_equal(loc_mask, want[1])
    assert _rel_err(loc_t, want[0]) <= LIMIT
    if "negative_mining_ratio" in attrs:
        assert (cls_t == -1).any()     # the mining ignored some negatives


@pytest.mark.parametrize("pad_first", [False, True])
def test_multibox_target_repeated_best_anchor(pad_first):
    """A valid box whose best anchor is anchor 0, below the threshold,
    beside a padded row (whose IoU column is all -1, so its best anchor is
    anchor 0 too). The reference's scatter keeps the later row's value:
    with the padded row after the box, anchor 0 loses its forced match;
    before it, anchor 0 keeps it."""
    anchors = np.array([[0.0, 0.0, 0.5, 0.5], [0.6, 0.6, 1.0, 1.0],
                        [0.6, 0.0, 1.0, 0.4]], np.float32)[None]
    box = [1.0, 0.0, 0.0, 0.3, 0.3]        # IoU 0.36 with anchor 0
    pad = [-1.0, -1.0, -1.0, -1.0, -1.0]
    label = np.array([[pad, box] if pad_first else [box, pad]], np.float32)
    cls_pred = np.zeros((1, 3, 3), np.float32)
    got, want = _both("MultiBoxTarget", {"overlap_threshold": 0.5},
                      anchors, label, cls_pred)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2][0, 0] == (2.0 if pad_first else 0.0)


def test_multibox_target_makes_no_graph():
    anchors = torch.from_numpy(_anchors())
    label = torch.from_numpy(_labels(np.random.RandomState(5), 2, 3))
    pred = torch.randn(2, 3, anchors.shape[1], requires_grad=True)
    outs = tops.get_op("MultiBoxTarget").fn(
        TOpCtx(is_train=True), {"negative_mining_ratio": 3}, anchors, label,
        pred)
    assert all(o.grad_fn is None and not o.requires_grad for o in outs)


# -- MultiBoxDetection

def _detection_inputs(rng, b, na, classes, quantum):
    """Probabilities on a grid of ``quantum`` (ties among scores), some
    anchors with every score under the threshold, and random offsets."""
    raw = rng.randint(0, 8, (b, classes + 1, na)).astype(np.float32)
    raw[:, 1:, rng.rand(na) < 0.3] = 0.0
    probs = (raw * quantum).astype(np.float32)
    loc = (rng.randn(b, na * 4) * 0.5).astype(np.float32)
    return probs, loc


def _nms_gaps(probs, loc, anchors, attrs):
    """Assert that no IoU among the decoded top boxes lies within GAP of
    the NMS threshold."""
    from mxnet_tpu_torch.ops.contrib_det import _decode, _iou_matrix

    var = attrs.get("variances", (0.1, 0.1, 0.2, 0.2))
    a = torch.from_numpy(anchors).reshape(-1, 4)
    boxes = _decode(a, torch.from_numpy(loc).reshape(loc.shape[0], -1, 4),
                    var)
    iou = _iou_matrix(boxes, boxes).numpy()
    assert np.abs(iou - attrs["nms_threshold"]).min() > GAP, \
        "an IoU near the NMS threshold"


DETECTION_CASES = {
    "ties": {"threshold": 0.2, "nms_threshold": 0.5, "nms_topk": 400},
    "topk_cut": {"threshold": 0.05, "nms_threshold": 0.45, "nms_topk": 20},
    "all_below": {"threshold": 0.99, "nms_threshold": 0.5, "nms_topk": 30},
}


@pytest.mark.parametrize("case", sorted(DETECTION_CASES))
def test_multibox_detection(case):
    """The whole (B, A, 6) output, rows of entries that are not kept (class
    -1, score -1 or suppressed) included: their order follows lax.top_k's
    among tied scores."""
    attrs = DETECTION_CASES[case]
    rng = np.random.RandomState(sorted(DETECTION_CASES).index(case) + 10)
    anchors = _anchors()
    na = anchors.shape[1]
    probs, loc = _detection_inputs(rng, 2, na, 3, 0.125)
    _nms_gaps(probs, loc, anchors, attrs)
    (got,), (want,) = _both("MultiBoxDetection", attrs, probs, loc, anchors)
    assert got.shape == want.shape == (2, na, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    assert _rel_err(got[..., 2:], want[..., 2:]) <= LIMIT
    if case == "all_below":
        assert (got[..., 0] == -1).all()
    else:
        assert ((got[..., 0] >= 0).sum() > 1) and (got[..., 0] == -1).any()


# -- Proposal

PROPOSAL_CASES = {
    "ties": dict(feature_stride=4, scales=(2.0, 4.0), ratios=(0.5, 1.0, 2.0),
                 rpn_pre_nms_top_n=60, rpn_post_nms_top_n=20, threshold=0.7,
                 rpn_min_size=4),
    "post_over_pre": dict(feature_stride=4, scales=(3.0,), ratios=(1.0,),
                          rpn_pre_nms_top_n=12, rpn_post_nms_top_n=30,
                          threshold=0.5, rpn_min_size=6),
    "defaults": {},
}


@pytest.mark.parametrize("case", sorted(PROPOSAL_CASES))
def test_proposal(case):
    attrs = PROPOSAL_CASES[case]
    rng = np.random.RandomState(sorted(PROPOSAL_CASES).index(case) + 20)
    k = len(attrs.get("scales", (8, 16, 32))) * \
        len(attrs.get("ratios", (0.5, 1, 2)))
    n, fh, fw = 2, 6, 5
    # scores on a grid of 1/16: many ties among the foreground scores
    probs = (rng.randint(0, 16, (n, 2 * k, fh, fw)) / 16.0).astype(np.float32)
    deltas = (rng.randn(n, 4 * k, fh, fw) * 0.2).astype(np.float32)
    stride = attrs.get("feature_stride", 16)
    info = np.array([[fh * stride, fw * stride, 1.0],
                     [fh * stride - 3, fw * stride - 5, 0.5]], np.float32)
    (got,), (want,) = _both("Proposal", attrs, probs, deltas, info)
    assert got.shape == want.shape
    assert got.shape == (n * attrs.get("rpn_post_nms_top_n", 300), 5)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert _rel_err(got[:, 1:], want[:, 1:]) <= LIMIT


# -- ROIPooling

def _roi_inputs(rng):
    """A (2, 3, 8, 9) map on a grid of 1/4 (tied maxima in most bins) and
    ROIs inside the map, across its edge (empty bins) and at fractional
    coordinates under spatial_scale 0.5."""
    data = (rng.randint(-4, 5, (2, 3, 8, 9)) / 4.0).astype(np.float32)
    rois = np.array([[0, 0, 0, 15, 13], [1, 4, 2, 11, 9], [1, 9, 9, 30, 26],
                     [0, 3.4, 5.5, 7.5, 6.5], [1, 0, 0, 1, 1],
                     [0.9, 12, 1, 17, 15]], np.float32)
    return data, rois


@pytest.mark.parametrize("pooled", [(2, 2), (3, 4), (6, 6)])
def test_roi_pooling_and_gradient(pooled):
    rng = np.random.RandomState(pooled[0] * 10 + pooled[1])
    data, rois = _roi_inputs(rng)
    attrs = {"pooled_size": pooled, "spatial_scale": 0.5}
    head = rng.randn(len(rois), 3, *pooled).astype(np.float32)
    (out, (grad,)), (want, (want_grad,)) = _vjp_both(
        "ROIPooling", attrs, [data, rois], head)
    assert out.shape == want.shape == (len(rois), 3) + pooled
    assert _rel_err(out, want) <= LIMIT
    assert _rel_err(grad, want_grad) <= LIMIT
    # the cases hold what they are meant to: empty bins, and a gradient
    # split among tied maxima (an entry that is neither 0 nor a sum of
    # whole head entries of its bins)
    assert (want == 0).all(axis=1).any()
    assert not np.allclose(np.round(want_grad * 4), want_grad * 4) \
        or pooled == (2, 2)


def test_roi_pooling_tie_split():
    """A bin whose maximum is held by three entries passes a third of its
    gradient to each, as jnp.max's VJP does."""
    data = np.zeros((1, 1, 2, 2), np.float32)
    data[0, 0] = [[1.0, 1.0], [1.0, 0.5]]
    rois = np.array([[0, 0, 0, 1, 1]], np.float32)
    head = np.ones((1, 1, 1, 1), np.float32)
    (out, (grad,)), (want, (want_grad,)) = _vjp_both(
        "ROIPooling", {"pooled_size": (1, 1), "spatial_scale": 1.0},
        [data, rois], head)
    np.testing.assert_allclose(grad[0, 0], [[1 / 3, 1 / 3], [1 / 3, 0]],
                               rtol=1e-6)
    assert _rel_err(grad, want_grad) <= LIMIT


# -- Correlation, SoftmaxActivation, MakeLoss

@pytest.mark.parametrize("is_multiply", [True, False])
@pytest.mark.parametrize("conf", [(1, 1, 1, 1, 1), (3, 2, 1, 2, 2),
                                  (1, 2, 2, 1, 3)],
                         ids=["k1d1", "k3d2", "k1d2s2"])
def test_correlation(is_multiply, conf):
    kernel, max_d, s1, s2, pad = conf
    rng = np.random.RandomState(kernel + 3 * max_d)
    a = rng.randn(2, 4, 7, 6).astype(np.float32)
    b = rng.randn(2, 4, 7, 6).astype(np.float32)
    attrs = {"kernel_size": kernel, "max_displacement": max_d,
             "stride1": s1, "stride2": s2, "pad_size": pad,
             "is_multiply": is_multiply}
    (got,), (want,) = _both("Correlation", attrs, a, b)
    assert got.shape == want.shape
    assert _rel_err(got, want) <= LIMIT


@pytest.mark.parametrize("mode", ["channel", "instance"])
def test_softmax_activation(mode):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 3, 4).astype(np.float32) * 3
    head = rng.randn(*x.shape).astype(np.float32)
    (out, (grad,)), (want, (want_grad,)) = _vjp_both(
        "SoftmaxActivation", {"mode": mode}, [x], head)
    assert _rel_err(out, want) <= LIMIT
    assert _rel_err(grad, want_grad) <= LIMIT


@pytest.mark.parametrize("attrs", [{}, {"grad_scale": 0.25},
                                   {"grad_scale": 3.0,
                                    "normalization": "batch"},
                                   {"normalization": "valid"}],
                         ids=["default", "scale", "batch", "valid"])
def test_make_loss_gradient(attrs):
    """The gradient is the constant scale whatever the head gradient."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 3, 2).astype(np.float32)
    head = rng.randn(*x.shape).astype(np.float32)
    (out, (grad,)), (want, (want_grad,)) = _vjp_both("MakeLoss", attrs, [x],
                                                     head)
    np.testing.assert_array_equal(out, x)
    np.testing.assert_array_equal(grad, want_grad)
    scale = attrs.get("grad_scale", 1.0)
    if attrs.get("normalization") == "batch":
        scale /= x.shape[0]
    assert (grad == np.float32(scale)).all()


def test_ops_infer_shapes_on_meta():
    """Each op runs on meta tensors (shape inference) and gives the
    reference's output shapes."""
    cases = [
        ("MultiBoxPrior", PRIOR_ATTRS[0], [(2, 3, 5, 7)]),
        ("MultiBoxTarget", {"negative_mining_ratio": 3},
         [(1, 96, 4), (2, 3, 5), (2, 4, 96)]),
        ("MultiBoxDetection", {"nms_topk": 50},
         [(2, 4, 96), (2, 384), (1, 96, 4)]),
        ("Proposal", PROPOSAL_CASES["ties"],
         [(2, 12, 6, 5), (2, 24, 6, 5), (2, 3)]),
        ("ROIPooling", {"pooled_size": (3, 3), "spatial_scale": 0.5},
         [(2, 3, 8, 9), (5, 5)]),
        ("Correlation", {"max_displacement": 2, "pad_size": 2},
         [(1, 4, 6, 6), (1, 4, 6, 6)]),
    ]
    for name, attrs, shapes in cases:
        metas = [torch.empty(s, device="meta") for s in shapes]
        outs = tops.get_op(name).fn(TOpCtx(device=torch.device("meta")),
                                    dict(attrs), *metas)
        outs = outs if isinstance(outs, (tuple, list)) else [outs]
        want = jax.eval_shape(
            lambda *a: jops.get_op(name).fn(JOpCtx(), dict(attrs), *a),
            *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])
        want = want if isinstance(want, (tuple, list)) else [want]
        assert [tuple(o.shape) for o in outs] == \
            [tuple(w.shape) for w in want], name
