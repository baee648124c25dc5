"""VOC-style mean average precision for SSD (reference: example/ssd/
metric.py, after evaluate/eval_voc.py voc_eval and voc_ap), an
``EvalMetric`` over host numpy."""
from __future__ import annotations

import numpy as np

import mxnet_tpu_torch as mx


def voc_ap(rec, prec, use_07_metric=False):
    """AP from recall and precision arrays (reference: eval_voc.py
    voc_ap): the 11-point form, or the area under the precision envelope."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap += p / 11.0
        return ap
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def _iou(box, boxes):
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    wh = np.maximum(0.0, rb - lt)
    inter = wh[:, 0] * wh[:, 1]
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = a + b - inter
    return np.where(union > 0, inter / union, 0.0)


class MApMetric(mx.metric.EvalMetric):
    """mAP over classes at an IoU threshold.

    ``update`` takes MultiBoxDetection's output (B, A, 6) rows [cls_id,
    score, x1, y1, x2, y2] (cls_id -1: not a detection) and labels (B, M,
    5) rows [cls, x1, y1, x2, y2] (-1 padded), in one coordinate space.
    """

    def __init__(self, ovp_thresh=0.5, use_07_metric=False, name="mAP"):
        super().__init__(name)
        self.ovp_thresh = ovp_thresh
        self.use_07 = use_07_metric
        self.reset()

    def reset(self):
        self._recs: dict = {}   # class -> [(score, tp)]
        self._gts: dict = {}    # class -> ground-truth count
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for lab, det in zip(labels, preds):
            lab = lab.asnumpy() if hasattr(lab, "asnumpy") else np.asarray(lab)
            det = det.asnumpy() if hasattr(det, "asnumpy") else np.asarray(det)
            for b in range(det.shape[0]):
                gl = lab[b]
                gl = gl[gl[:, 0] >= 0]
                for row in gl:
                    self._gts[int(row[0])] = self._gts.get(int(row[0]), 0) + 1
                d = det[b]
                d = d[d[:, 0] >= 0]
                order = np.argsort(-d[:, 1])
                matched = np.zeros(len(gl), bool)
                for j in order:
                    c = int(d[j, 0])
                    cand = np.where(gl[:, 0] == c)[0]
                    tp = 0
                    if len(cand):
                        ious = _iou(d[j, 2:6], gl[cand, 1:5])
                        k = int(np.argmax(ious))
                        # VOC: a detection pairs with its best-IoU box; if
                        # that box is taken it is a false positive
                        if ious[k] >= self.ovp_thresh \
                                and not matched[cand[k]]:
                            matched[cand[k]] = True
                            tp = 1
                    self._recs.setdefault(c, []).append((float(d[j, 1]), tp))

    def get(self):
        aps = []
        for c, n_gt in self._gts.items():
            recs = sorted(self._recs.get(c, []), key=lambda r: -r[0])
            tps = np.array([r[1] for r in recs], np.float64)
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(1.0 - tps)
            rec = tp_cum / n_gt
            prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
            aps.append(voc_ap(rec, prec, self.use_07))
        value = float(np.mean(aps)) if aps else 0.0
        return self.name, value
