"""The port's two-stage detection examples (``mxnet_tpu_torch/examples/
rcnn``) against the reference's (``example/rcnn``) on the CPU: the Fast
R-CNN toy's and Faster R-CNN's graphs emit the reference's symbol JSON and
infer its shapes; both examples' scenes and targets equal the reference's;
one Adam step of Faster R-CNN's training graph (RPN, Proposal, the Custom
ProposalTarget op, ROIPooling, heads) through ``Module`` with fed numpy
weights gives the reference's outputs, gradients and weights
(``tests/test_torch_module.py``'s fp32 limits); the test graph's outputs;
the test graph takes the training graph's parameters, a key it has no
argument for ignored, as the reference's ``set_params`` does; and short
runs of both examples (Faster R-CNN's box losses falling). The
reference's example files load under private names.

The step compares equal only if both packages take every decision alike.
Each test first runs the Proposal op of the port on each package's inputs
to it (evaluated from the graph at the same weights), measures how far
apart the two runs' scores, boxes and overlaps are (delta), and asserts
that every decision on which the output depends clears 2 delta: the order
of the proposals it returns, which of two overlapping boxes ranks higher,
each overlap against the NMS threshold, each box against the minimum size,
and downstream each proposal's overlap with the ground truth against
ProposalTarget's 0.5 and each rounded coordinate of ROIPooling."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.examples.rcnn import rcnn_toy
from mxnet_tpu_torch.examples.rcnn import train_faster_rcnn as frcnn
from mxnet_tpu_torch.ops import rcnn as t_rcnn

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BATCH, LR = 2, 2e-3
LIMITS = dict(out=1e-5, grad=1e-5, w=LR / 10)


def _load(path, name):
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


REF_FRCNN = _load(os.path.join(REPO, "example", "rcnn",
                               "train_faster_rcnn.py"),
                  "_reference_train_faster_rcnn")
REF_TOY = _load(os.path.join(REPO, "example", "rcnn", "rcnn_toy.py"),
                "_reference_rcnn_toy")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")
    monkeypatch.setenv("MXTPU_FUSED_GRADS", "1")
    monkeypatch.delenv("MXTPU_DONATE_PARAMS", raising=False)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pair(build_t, build_j):
    with mxt.name.NameManager():
        t = build_t()
    with mxj.name.NameManager():
        j = build_j()
    return t, j


TRAIN_SHAPES = {"data": (BATCH, 1, frcnn.IMG, frcnn.IMG),
                "gt_boxes": (BATCH, 5),
                "rpn_bbox_target": (BATCH, 4 * frcnn.K, frcnn.FEAT,
                                    frcnn.FEAT),
                "rpn_bbox_weight": (BATCH, 4 * frcnn.K, frcnn.FEAT,
                                    frcnn.FEAT),
                "im_info": (BATCH, 3),
                "rpn_label": (BATCH, frcnn.K * frcnn.FEAT * frcnn.FEAT)}
TEST_SHAPES = {"data": TRAIN_SHAPES["data"], "im_info": (BATCH, 3)}
TOY_SHAPES = {"data": (4, 1, rcnn_toy.IMG, rcnn_toy.IMG), "rois": (32, 5),
              "roi_bbox_target": (32, 4), "roi_bbox_weight": (32, 1),
              "label": (32,)}
GRAPHS = {
    "faster_train": (lambda: frcnn.get_train_symbol(BATCH),
                     lambda: REF_FRCNN.get_train_symbol(BATCH), TRAIN_SHAPES),
    "faster_test": (lambda: frcnn.get_test_symbol(BATCH),
                    lambda: REF_FRCNN.get_test_symbol(BATCH), TEST_SHAPES),
    "toy": (lambda: rcnn_toy.build(mxt), lambda: REF_TOY.build(mxj),
            TOY_SHAPES),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_symbols_match_the_reference(graph):
    build_t, build_j, shapes = GRAPHS[graph]
    t, j = _pair(build_t, build_j)
    assert t.tojson() == j.tojson()
    t_sh, j_sh = t.infer_shape(**shapes), j.infer_shape(**shapes)
    assert [[tuple(s) for s in a] for a in t_sh] == \
        [[tuple(s) for s in a] for a in j_sh]


def test_scenes_and_targets_match_the_reference():
    for got, want in ((frcnn.make_batch(np.random.RandomState(4), 3),
                       REF_FRCNN.make_batch(np.random.RandomState(4), 3)),
                      (rcnn_toy.make_batch(np.random.RandomState(5), 3),
                       REF_TOY.make_batch(np.random.RandomState(5), 3))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(frcnn.anchors_np(), REF_FRCNN.anchors_np())
    for scales, ratios, base in (((8, 16, 32), (0.5, 1, 2), 16),
                                 ((3.0, 4.0), (1.0, 2.0), 4)):
        from mxnet_tpu.ops import rcnn as j_rcnn

        np.testing.assert_array_equal(
            t_rcnn.generate_base_anchors(scales, ratios, base),
            j_rcnn.generate_base_anchors(scales, ratios, base))
        np.testing.assert_array_equal(
            t_rcnn.full_anchor_field(5, 7, base, scales, ratios),
            j_rcnn.full_anchor_field(5, 7, base, scales, ratios))


def _weights(sym, seed=0):
    rng = np.random.default_rng(seed)
    arg_shapes, _, _ = sym.infer_shape(**TRAIN_SHAPES)
    out = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in TRAIN_SHAPES:
            continue
        fan_in = np.prod(shape[1:]) if len(shape) > 1 else 1
        out[name] = (rng.standard_normal(shape) / np.sqrt(fan_in)
                     ).astype(np.float32)
    return out


def _arr(pkg):
    return (lambda v: pkg.nd.array(v, pkg.cpu())) if pkg is mxt \
        else pkg.nd.array


def _proposal_inputs(pkg, sym, weights, arrays):
    """The Proposal node's three inputs, evaluated at ``weights``."""
    graph = json.loads(sym.tojson())
    node = next(n for n in graph["nodes"] if n["op"] == "Proposal")
    names = [graph["nodes"][i[0]]["name"] for i in node["inputs"]]
    internals = sym.get_internals()
    group = pkg.sym.Group([internals[n + "_output"] for n in names[:2]])
    feed = dict(zip(frcnn.DATA_NAMES, (arrays[0], arrays[1], arrays[3],
                                       arrays[4], arrays[5])))
    arr = _arr(pkg)
    args = {n: arr(weights[n]) for n in group.list_arguments()
            if n in weights}
    args.update({n: arr(feed[n]) for n in group.list_arguments()
                 if n in feed})
    probs, deltas = [o.asnumpy() for o in group.eval(ctx=pkg.cpu(), **args)]
    return probs, deltas, arrays[5]


PROPOSAL_ATTRS = dict(feature_stride=frcnn.STRIDE, scales=frcnn.SCALES,
                      ratios=frcnn.RATIOS, rpn_pre_nms_top_n=200,
                      rpn_post_nms_top_n=frcnn.POST_NMS, threshold=0.7,
                      rpn_min_size=6)


def _proposal_stages(probs, deltas, info):
    """The port's Proposal computation on these inputs, stage by stage:
    (fg scores, boxes, keep, top indices, top scores, overlaps of the top
    boxes, final scores, rois)."""
    from mxnet_tpu_torch.ops.contrib_det import _suppressed
    from mxnet_tpu_torch.ops.tensor import top_k

    p, d, inf = (torch.from_numpy(np.array(a)) for a in (probs, deltas, info))
    n, twok, fh, fw = p.shape
    k = twok // 2
    anchors = torch.from_numpy(frcnn.anchors_np())
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    fg = p[:, k:].permute(0, 2, 3, 1).reshape(n, -1)
    dd = d.reshape(n, k, 4, fh, fw).permute(0, 3, 4, 1, 2).reshape(n, -1, 4)
    cx = dd[..., 0] * aw + anchors[:, 0] + aw / 2
    cy = dd[..., 1] * ah + anchors[:, 1] + ah / 2
    w = torch.exp(torch.clamp(dd[..., 2], -10, 10)) * aw
    h = torch.exp(torch.clamp(dd[..., 3], -10, 10)) * ah
    hi_x, hi_y = (inf[:, 1] - 1)[:, None], (inf[:, 0] - 1)[:, None]
    boxes = torch.stack([
        torch.minimum(torch.clamp(cx - (w - 1) / 2, min=0), hi_x),
        torch.minimum(torch.clamp(cy - (h - 1) / 2, min=0), hi_y),
        torch.minimum(torch.clamp(cx + (w - 1) / 2, min=0), hi_x),
        torch.minimum(torch.clamp(cy + (h - 1) / 2, min=0), hi_y)], -1)
    ms = (PROPOSAL_ATTRS["rpn_min_size"] * inf[:, 2])[:, None]
    size = torch.minimum(boxes[..., 2] - boxes[..., 0],
                         boxes[..., 3] - boxes[..., 1]) + 1 - ms
    score = torch.where(size >= 0, fg, torch.full_like(fg, -1.0))
    top_s, top_i = top_k(score, PROPOSAL_ATTRS["rpn_pre_nms_top_n"])
    tb = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    iou = t_rcnn._iou_matrix_plus1(tb, tb)
    dead = _suppressed(iou, top_s, 0.7) | (top_s <= 0)
    final = torch.where(dead, torch.full_like(top_s, -1.0), top_s)
    rois = t_rcnn._proposal(None, dict(PROPOSAL_ATTRS), p, d, inf)
    return {k_: v.numpy() for k_, v in dict(
        fg=fg, score=score, boxes=boxes, size=size, top_i=top_i,
        top_s=top_s, iou=iou, final=final, rois=rois).items()}


def _close(gap, delta):
    return np.abs(gap) <= 2 * delta


def _proposal_near_ties(t_stage, j_stage, gts):
    """Near-ties at the decisions the step's output depends on (module
    docstring); returns {decision: count}."""
    d_s = float(np.abs(t_stage["fg"] - j_stage["fg"]).max())
    d_box = float(np.abs(t_stage["boxes"] - j_stage["boxes"]).max())
    d_roi = float(np.abs(t_stage["rois"] - j_stage["rois"]).max())
    assert max(d_s, d_box, d_roi) < 1e-4
    ties = {"size": int(_close(t_stage["size"], d_box).sum())}
    post = PROPOSAL_ATTRS["rpn_post_nms_top_n"]
    order = overlap = nms = cut = 0
    for b in range(BATCH):
        s, o = t_stage["top_s"][b], j_stage["fg"][b][t_stage["top_i"][b]]
        iou, fin = t_stage["iou"][b], t_stage["final"][b]
        # the order of the returned proposals: the top post + 1 survivors
        alive = np.flatnonzero(fin > 0)[:post + 1]
        gaps = s[alive][:-1] - s[alive][1:]
        order += int((_close(gaps, d_s) & ~((gaps == 0) & (
            o[alive][:-1] == o[alive][1:]))).sum())
        # which of two overlapping boxes ranks higher, and each overlap
        # against the threshold, where the result turns on it: a box whose
        # one suppressor is the other, or a box that nothing else suppresses
        j_iou = j_stage["iou"][b]
        d_iou = float(np.abs(iou - j_iou).max())
        upper = np.triu(np.ones_like(iou, bool), 1) & (s[:, None] > 0)
        hits = upper & (iou > 0.7)            # [j, i]: j suppresses i
        count = hits.sum(0)
        sg = s[:, None] - s[None, :]
        tied = (sg == 0) & (o[:, None] == o[None, :])
        flip = hits & _close(sg, d_s) & ~tied
        overlap += int((flip & ((count[None, :] == 1)
                                | (count[:, None] == 0))).sum())
        edge = upper & _close(iou - 0.7, d_iou)
        nms += int((edge & ((hits & (count[None, :] == 1))
                            | (~hits & (count[None, :] == 0)))).sum())
        # the pre-NMS cut matters where fewer than post survive before it
        rest = np.sort(t_stage["score"][b])[::-1][len(s)]
        if (fin[:-1] > 0).sum() < post and _close(s[-1] - rest, d_s):
            cut += 1
    ties.update(order=order, overlap=overlap, nms=nms, cut=cut)
    # downstream: ProposalTarget's fg/bg split at IoU 0.5 and ROIPooling's
    # rounding of the ROIs scaled by 1 / STRIDE
    rois_t, rois_j = t_stage["rois"], j_stage["rois"]
    fg_ties = 0
    for b in range(BATCH):
        sel = rois_t[:, 0] == b
        gt = gts[b:b + 1, 1:]
        it = frcnn.iou_np(rois_t[sel][:, 1:], gt)[:, 0]
        ij = frcnn.iou_np(rois_j[sel][:, 1:], gt)[:, 0]
        fg_ties += int(_close(it - 0.5, np.abs(it - ij).max()).sum())
    scaled = rois_t[:, 1:] / frcnn.STRIDE
    frac = scaled - np.floor(scaled)
    ties["roi_rounding"] = int(_close(frac - 0.5,
                                      d_roi / frcnn.STRIDE).sum())
    ties["fg_split"] = fg_ties
    return ties


def _step(pkg, sym, weights, arrays):
    ctx = pkg.cpu()
    arr = _arr(pkg)
    mod = pkg.mod.Module(sym, context=ctx, data_names=frcnn.DATA_NAMES,
                         label_names=("rpn_label",))
    mod.bind(data_shapes=[(n, TRAIN_SHAPES[n]) for n in frcnn.DATA_NAMES],
             label_shapes=[("rpn_label", TRAIN_SHAPES["rpn_label"])])
    mod.init_params(arg_params={n: arr(w) for n, w in weights.items()})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": LR})
    imgs, gts, rl, rt, rw_, info = arrays
    mod.forward(pkg.io.DataBatch(
        data=[arr(a) for a in (imgs, gts, rt, rw_, info)],
        label=[arr(rl)]), is_train=True)
    mod.backward()
    outs = [o.asnumpy() for o in mod.get_outputs()]
    grads = mod._exec_group._executor.grad_dict
    grads = {n: grads[n].asnumpy() for n in weights}
    mod.update()
    new = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    return outs, grads, new, mod


def test_train_step_matches_the_reference():
    """One Adam step through forward(is_train=True)/backward()/update():
    the RPN's and the heads' outputs, the sampled ROIs and labels exactly,
    every gradient and the weights after the update (the ProposalTarget's
    inputs need no gradient, so autograd runs its forward alone and the
    heads' gradient reaches the backbone through ROIPooling); then the
    test graph on the updated weights, through set_params with a key it
    has no argument for."""
    t_sym, j_sym = _pair(lambda: frcnn.get_train_symbol(BATCH),
                         lambda: REF_FRCNN.get_train_symbol(BATCH))
    weights = _weights(t_sym)
    arrays = frcnn.make_batch(np.random.RandomState(7), BATCH)
    t_in = _proposal_inputs(mxt, t_sym, weights, arrays)
    j_in = _proposal_inputs(mxj, j_sym, weights, arrays)
    ties = _proposal_near_ties(_proposal_stages(*t_in),
                               _proposal_stages(*j_in), arrays[1])
    assert not any(ties.values()), f"near-ties at decisions: {ties}"

    t_out, t_grad, t_w, t_mod = _step(mxt, t_sym, weights, arrays)
    j_out, j_grad, j_w, j_mod = _step(mxj, j_sym, weights, arrays)
    names = ("rpn_cls_prob", "rpn_bbox_loss", "cls_prob", "bbox_loss",
             "rois", "label")
    for name, g, w in zip(names, t_out, j_out):
        assert g.shape == w.shape, name
        if name == "label":
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= LIMITS["out"] * max(
                1.0, np.abs(w).max()), name
    assert (t_out[5] > 0).any() and (t_out[5] == 0).any()
    for n in weights:
        assert np.isfinite(t_grad[n]).all(), n
        assert _rel(t_grad[n], j_grad[n]) <= LIMITS["grad"], n
        assert np.abs(t_w[n] - j_w[n]).max() <= LIMITS["w"], n
    info = t_mod.step_info()
    assert info["captured"] is False

    # the test graph takes the training graph's parameters; set_params
    # ignores a key it has no argument for, in both packages
    outs = []
    for pkg, build, (args, auxs) in (
            (mxt, frcnn.get_test_symbol, t_mod.get_params()),
            (mxj, REF_FRCNN.get_test_symbol, j_mod.get_params())):
        with pkg.name.NameManager():
            test_sym = build(BATCH)
        test_mod = pkg.mod.Module(test_sym, context=pkg.cpu(),
                                  data_names=("data", "im_info"),
                                  label_names=())
        test_mod.bind(data_shapes=[(n, TEST_SHAPES[n]) for n in TEST_SHAPES],
                      for_training=False)
        extra = dict(args, train_only_weight=args["c1_bias"])
        assert set(extra) - set(test_sym.list_arguments())
        test_mod.set_params(extra, auxs)
        arr = _arr(pkg)
        test_mod.forward(pkg.io.DataBatch(
            data=[arr(arrays[0]), arr(arrays[5])]), is_train=False)
        outs.append([o.asnumpy() for o in test_mod.get_outputs()])
    for g, w in zip(*outs):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * max(1.0, np.abs(w).max())


def _target_op(pkg, module, rois, gts):
    """ProposalTargetOp's forward on ``rois`` and ``gts``, through the
    package's CustomOp interface."""
    arr = _arr(pkg)
    prop = module.ProposalTargetProp(batch_images=str(BATCH))
    _, out_shapes, _ = prop.infer_shape([list(rois.shape), list(gts.shape)])
    op = prop.create_operator(pkg.cpu(), None, None)
    outs = [arr(np.zeros(s, np.float32)) for s in out_shapes]
    op.forward(True, ["write"] * 4, [arr(rois), arr(gts)], outs, [])
    return [o.asnumpy() for o in outs]


def test_custom_target_op_draws_like_the_reference():
    """ProposalTargetOp on the same ROIs in both packages: the same sample
    (RandomState(11) made with the operator), labels and targets."""
    rng = np.random.RandomState(2)
    gts = frcnn.make_batch(rng, BATCH)[1]
    rois = np.concatenate([
        np.repeat(np.arange(BATCH, dtype=np.float32), frcnn.POST_NMS)[:, None],
        np.abs(rng.randn(BATCH * frcnn.POST_NMS, 4) * 12 + 24).astype(
            np.float32)], 1)
    rois[:, 3:] = np.maximum(rois[:, 3:], rois[:, 1:3] + 4)
    for i in range(BATCH):      # a few proposals on each ground truth
        rois[i * frcnn.POST_NMS:i * frcnn.POST_NMS + 3, 1:] = \
            gts[i, 1:] + rng.uniform(-2, 2, (3, 4))
    got = _target_op(mxt, frcnn, rois, gts)
    want = _target_op(mxj, REF_FRCNN, rois, gts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] > 0).any() and (got[1] == 0).any()


def test_faster_rcnn_trains_on_cpu():
    """One short epoch at batch 2: finite, falling box losses."""
    losses = []
    acc, miou = frcnn.train_and_eval(
        epochs=2, batch=BATCH, steps_per_epoch=6, ctx=mxt.cpu(),
        log=lambda s: losses.append(s))
    vals = [float(s.rsplit(" ", 1)[1]) for s in losses if
            s.startswith("epoch")]
    assert len(vals) == 2 and np.isfinite(vals).all()
    assert vals[1] < vals[0], vals
    assert 0.0 <= acc <= 1.0 and 0.0 <= miou <= 1.0


def test_rcnn_toy_runs_on_cpu():
    """rcnn_toy.py's loop, a few steps (its 0.8 gate is for 120 steps):
    finite class probabilities over the ROIs."""
    log = []
    acc = rcnn_toy.train(mxt.cpu(), steps=4, log=log.append)
    assert 0.0 <= acc <= 1.0 and len(log) == 2


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception, match="CUDA"):
        frcnn.train_and_eval(epochs=1, steps_per_epoch=1)
    with pytest.raises(Exception, match="CUDA"):
        rcnn_toy.main([])
