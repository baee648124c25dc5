"""The port's SSD example (``mxnet_tpu_torch/examples/ssd``) against the
reference's (``example/ssd``) on the CPU: the training and detection graphs
emit the reference's symbol JSON and infer its shapes; one Adam step of the
training graph through ``Module`` with fed numpy weights gives the
reference's outputs and gradients (``tests/test_torch_module.py``'s fp32
limits), its targets exactly; the detection graph's (B, A, 6) output;
``MApMetric``'s exact case (``tests/test_ssd_example.py``); and two epochs
on 64 images with a falling loss. The reference's example files load under
private names, so that neither package's ``symbol``/``train``/``metric``
shadows the other's.

The steps compare equal only if both packages take every decision the same
way: each test first measures how far apart the two packages' inputs to
those decisions are (the class scores that rank negatives and detections)
and asserts that every decision clears twice that distance, so that a
failure names a near-tie."""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.examples.ssd import evaluate, metric, symbol, train

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BATCH, LR = 8, 5e-3
# tests/test_torch_module.py's fp32 limits
LIMITS = dict(out=1e-5, grad=1e-5, w=LR / 10)


def _load(path, name):
    """A reference example file as module ``name`` (sys.path restored)."""
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


REF_SYMBOL = _load(os.path.join(REPO, "example", "ssd", "symbol.py"),
                   "_reference_ssd_symbol")
REF_METRIC = _load(os.path.join(REPO, "example", "ssd", "metric.py"),
                   "_reference_ssd_metric")
REF_TRAIN = _load(os.path.join(REPO, "example", "ssd", "train.py"),
                  "_reference_ssd_train")


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


def _pair(build):
    """``build(symbol_module)`` in each package, with fresh name counters:
    (port's symbol, reference's symbol)."""
    with mxt.name.NameManager():
        t = build(symbol)
    with mxj.name.NameManager():
        j = build(REF_SYMBOL)
    return t, j


SHAPES = {"data": (BATCH, 3, 64, 64), "label": (BATCH, 2, 5)}


@pytest.mark.parametrize("graph", ["train", "detect"])
def test_symbols_match_the_reference(graph):
    t, j = _pair(lambda m: m.get_ssd_train(2) if graph == "train"
                 else m.get_ssd_detect(2))
    assert t.tojson() == j.tojson()
    shapes = dict(SHAPES) if graph == "train" else {"data": SHAPES["data"]}
    t_sh, j_sh = t.infer_shape(**shapes), j.infer_shape(**shapes)
    assert [[tuple(s) for s in a] for a in t_sh] == \
        [[tuple(s) for s in a] for a in j_sh]


def test_dataset_matches_the_reference():
    for n, seed in ((4, 0), (64, 1)):
        got = train.make_dataset(n, np.random.RandomState(seed))
        want = REF_TRAIN.make_dataset(n, np.random.RandomState(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _weights(sym, seed=0):
    """Fan-in scaled numpy weights for every argument but the inputs."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, _ = sym.infer_shape(**SHAPES)
    out = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in SHAPES:
            continue
        fan_in = np.prod(shape[1:]) if len(shape) > 1 else 1
        out[name] = (rng.standard_normal(shape) / np.sqrt(fan_in)
                     ).astype(np.float32)
    return out


def _batch():
    x, y = train.make_dataset(BATCH, np.random.RandomState(3))
    return x, y


def _body_outputs(pkg, sym_mod, weights, x):
    """(loc_preds, cls_preds, anchors) of the SSD body at ``weights``."""
    with pkg.name.NameManager():
        body = pkg.sym.Group(list(sym_mod.get_ssd_body(
            pkg.sym.Variable("data"), 2)))
    ctx = pkg.cpu()
    arr = (lambda v: pkg.nd.array(v, ctx)) if pkg is mxt else pkg.nd.array
    args = {n: arr(weights[n]) for n in body.list_arguments() if n != "data"}
    return [o.asnumpy() for o in body.eval(ctx=ctx, data=arr(x), **args)]


def _probs(cls_preds):
    return torch.softmax(torch.from_numpy(np.array(cls_preds)), 1).numpy()


def _near_ties(values, other, delta):
    """Adjacent pairs of ``values`` sorted high to low (lowest index first
    among equals) that lie within 2 * delta of each other and are not
    exactly equal in ``other`` (the other package's values) too: the
    decisions on which the packages could part."""
    order = np.lexsort((np.arange(len(values)), -values))
    v, o = values[order], other[order]
    gap = v[:-1] - v[1:]
    exact = (gap == 0) & (o[:-1] == o[1:])
    return int(((gap <= 2 * delta) & ~exact).sum())


def _mining_near_ties(probs, other, anchors, label, delta, ratio=3,
                      thresh=0.5):
    """Near-ties at MultiBoxTarget's mining decisions: the hardness on each
    side of every sample's keep boundary (the positives and the IoU
    decisions are the data's alone)."""
    from mxnet_tpu_torch.ops.contrib_det import _iou_matrix

    a = torch.from_numpy(anchors).reshape(-1, 4)
    ties = checked = 0
    for b in range(label.shape[0]):
        valid = label[b, :, 0] >= 0
        iou = _iou_matrix(a, torch.from_numpy(label[b, :, 1:5])).numpy()
        iou = np.where(valid[None], iou, -1.0)
        pos = iou.max(1) >= thresh
        pos[iou.argmax(0)[valid]] = True
        hard, hard_o = probs[b, 1:].max(0)[~pos], other[b, 1:].max(0)[~pos]
        keep = int(ratio * pos.sum())
        if 0 < keep < len(hard):
            order = np.lexsort((np.arange(len(hard)), -hard))
            edge = order[keep - 1:keep + 1]
            ties += _near_ties(hard[edge], hard_o[edge], delta)
            checked += 1
    return ties, checked


def _module(pkg, sym, weights):
    ctx = pkg.cpu()
    mod = pkg.mod.Module(sym, context=ctx, label_names=("label",))
    mod.bind(data_shapes=[("data", SHAPES["data"])],
             label_shapes=[("label", SHAPES["label"])])
    arr = (lambda v: pkg.nd.array(v, ctx)) if pkg is mxt else pkg.nd.array
    mod.init_params(arg_params={n: arr(w) for n, w in weights.items()})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": LR})
    return mod, arr


def _step(pkg, sym, weights, x, y):
    """One Adam step: (outputs, gradients, weights after the update)."""
    mod, arr = _module(pkg, sym, weights)
    mod.forward(pkg.io.DataBatch(data=[arr(x)], label=[arr(y)]),
                is_train=True)
    mod.backward()
    outs = [o.asnumpy() for o in mod.get_outputs()]
    grads = mod._exec_group._executor.grad_dict
    grads = {n: grads[n].asnumpy() for n in weights}
    mod.update()
    new = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    return outs, grads, new


def test_train_step_matches_the_reference():
    t_sym, j_sym = _pair(lambda m: m.get_ssd_train(2))
    weights = _weights(t_sym)
    x, y = _batch()
    # the precondition: the class scores that rank the negatives differ
    # between the packages by delta, and every rank decision clears 2 delta
    t_body = _body_outputs(mxt, symbol, weights, x)
    j_body = _body_outputs(mxj, REF_SYMBOL, weights, x)
    t_p, j_p = _probs(t_body[1]), _probs(j_body[1])
    delta = float(np.abs(t_p - j_p).max())
    assert delta < 1e-5
    ties, checked = _mining_near_ties(t_p, j_p, t_body[2], y, delta)
    assert checked and not ties, f"{ties} near-ties in the negative ranks"

    t_out, t_grad, t_w = _step(mxt, t_sym, weights, x, y)
    j_out, j_grad, j_w = _step(mxj, j_sym, weights, x, y)
    cls_prob, loc_loss, cls_t, loc_t = t_out
    np.testing.assert_array_equal(cls_t, j_out[2])
    assert (cls_t == -1).any() and (cls_t > 0).any()
    assert _rel(loc_t, j_out[3]) <= LIMITS["out"]
    assert np.abs(cls_prob - j_out[0]).max() <= LIMITS["out"]
    assert np.abs(loc_loss - j_out[1]).max() <= LIMITS["out"]
    for n in weights:
        assert np.isfinite(t_grad[n]).all()
        assert _rel(t_grad[n], j_grad[n]) <= LIMITS["grad"], n
        assert np.abs(t_w[n] - j_w[n]).max() <= LIMITS["w"], n


def _detections(pkg, sym_mod, weights, x):
    with pkg.name.NameManager():
        det = sym_mod.get_ssd_detect(2)
    ctx = pkg.cpu()
    arr = (lambda v: pkg.nd.array(v, ctx)) if pkg is mxt else pkg.nd.array
    args = {n: arr(weights[n]) for n in det.list_arguments() if n != "data"}
    return det.eval(ctx=ctx, data=arr(x), **args)[0].asnumpy()


def test_detection_graph_matches_the_reference():
    """The whole (B, A, 6) output at the weights of a detector trained by
    the example's recipe (4 epochs at batch 8 on 64 images), after
    checking that the scores it ranks are apart by more than the packages'
    difference. (At random weights every anchor scores near 1/3, and among
    1280 such scores a sample about one pair lies within rounding: K^2 * 2
    delta / range. Trained, 4-70 anchors a sample clear the threshold,
    about 1e-3 near-ties a sample.)"""
    np.random.seed(0)     # the iterator's first shuffle
    mod, _, _ = train.train_ssd(epochs=4, batch=8, train_size=64,
                                ctx=mxt.cpu(), log=lambda s: None)
    weights = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    x, _ = _batch()
    t_body = _body_outputs(mxt, symbol, weights, x)
    j_body = _body_outputs(mxj, REF_SYMBOL, weights, x)
    t_p, j_p = _probs(t_body[1]), _probs(j_body[1])
    delta = float(np.abs(t_p - j_p).max())
    assert delta < 1e-5
    n_ranked = 0
    for b in range(BATCH):
        score, other = t_p[b, 1:].max(0), j_p[b, 1:].max(0)
        ranked = score > 0.1    # the rest score -1, tied exactly
        n_ranked += ranked.sum()
        assert not _near_ties(score[ranked], other[ranked], delta), \
            "a near-tie among the ranked scores"
        assert np.abs(score - 0.1).min() > 2 * delta
    assert n_ranked > BATCH
    got = _detections(mxt, symbol, weights, x)
    want = _detections(mxj, REF_SYMBOL, weights, x)
    assert got.shape == want.shape == (BATCH, 1280, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert (got[..., 0] >= 0).any()
    assert _rel(got[..., 1:], want[..., 1:]) <= LIMITS["out"]


def test_map_metric_exact_case():
    """tests/test_ssd_example.py's case: TP, duplicate (FP), TP gives AP
    0.5 + 0.5 * 2/3; the two TPs alone give 1."""
    labels = np.array([[[0, 0.1, 0.1, 0.4, 0.4],
                        [0, 0.6, 0.6, 0.9, 0.9]]], np.float32)
    dets = np.array([[[0, 0.9, 0.1, 0.1, 0.4, 0.4],
                      [0, 0.8, 0.11, 0.11, 0.41, 0.41],
                      [0, 0.7, 0.6, 0.6, 0.9, 0.9]]], np.float32)
    for m_mod, nd in ((metric, lambda v: mxt.nd.array(v, mxt.cpu())),
                      (REF_METRIC, mxj.nd.array)):
        m = m_mod.MApMetric(ovp_thresh=0.5)
        m.update([nd(labels)], [nd(dets)])
        assert abs(m.get()[1] - (0.5 + 0.5 * 2 / 3)) < 1e-6
        m2 = m_mod.MApMetric(ovp_thresh=0.5)
        m2.update([nd(labels)], [nd(dets[:, [0, 2]])])
        assert abs(m2.get()[1] - 1.0) < 1e-6
    rec = np.array([0.2, 0.4, 0.4, 0.8])
    prec = np.array([1.0, 0.8, 0.6, 0.7])
    for use_07 in (False, True):
        assert metric.voc_ap(rec, prec, use_07) == \
            REF_METRIC.voc_ap(rec, prec, use_07)


def test_two_epochs_on_64_images():
    losses = []
    np.random.seed(0)     # the iterator's first shuffle
    mod, det_mod, it = train.train_ssd(
        epochs=2, batch=8, train_size=64, ctx=mxt.cpu(),
        log=lambda s: losses.append(float(s.rsplit(" ", 1)[1])))
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[1] < losses[0], losses
    maps = evaluate.evaluate_net(det_mod, n_images=32)
    assert set(maps) == {0.5, 0.75}
    miou, acc = train.detection_quality(det_mod, n_images=32)
    assert 0.0 <= miou <= 1.0 and 0.0 <= acc <= 1.0
    dets = det_mod.predict(mxt.io.NDArrayIter(
        train.make_dataset(32, np.random.RandomState(1))[0],
        batch_size=32)).asnumpy()
    kept = dets[dets[:, :, 0] >= 0]
    assert dets.shape == (32, 1280, 6) and np.isfinite(kept).all()
    assert ((kept[:, 1] > 0.1) & (kept[:, 1] <= 1)).all()


def test_examples_default_to_the_card():
    """Without ``--cpu`` the examples bind on gpu(0), which the CPU-only
    host does not have."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception, match="CUDA"):
        train.train_ssd(epochs=1, train_size=32)
    with pytest.raises(Exception, match="CUDA"):
        evaluate.main(["--epochs", "1"])
