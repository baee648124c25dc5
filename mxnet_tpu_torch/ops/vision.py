"""Region and vision operators (reference: mxnet_tpu/ops/vision.py, after
src/operator/{roi_pooling,correlation}-inl.h): ``ROIPooling``, which Faster
R-CNN's heads run on, and ``Correlation`` (FlowNet's patch correlation).

``ROIPooling`` is the reference's masked max, vectorised over the ROIs
and the output cells at once (no loop over ROIs, so it captures): a cell's
mask over the feature map, ``-inf`` outside it, ``amax`` over the map. Its
gradient is autograd's through ``amax``, which splits a cell's gradient
evenly among tied maxima as ``jnp.max``'s VJP does. The masked form holds
R * C * ph * pw * H * W values: fine at the examples' shapes, far too many
at VGG-16's (see PERF.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op


def _bin_mask(start, size, bins, extent):
    """(R, bins, extent): position x lies in bin p of each ROI, the bin
    spanning [floor(start + p * size), ceil(start + (p + 1) * size))."""
    dev = start.device
    p = torch.arange(bins, dtype=torch.float32, device=dev)[None, :]
    lo = torch.floor(start[:, None] + p * size[:, None])
    hi = torch.ceil(start[:, None] + (p + 1) * size[:, None])
    x = torch.arange(extent, dtype=torch.float32, device=dev)[None, None, :]
    return (x >= lo[..., None]) & (x < hi[..., None])


@register_op("ROIPooling", inputs=("data", "rois"))
def _roi_pooling(ctx, attrs, data, rois):
    """Max-pool each ROI of ``data`` (N, C, H, W) to ``pooled_size``: (R,
    C, ph, pw). ``rois`` is (R, 5) rows [batch_idx, x1, y1, x2, y2] in
    image coordinates, scaled by ``spatial_scale`` and rounded half to
    even; the batch index is truncated. An empty bin gives 0 and passes no
    gradient."""
    ph, pw = attrs["pooled_size"]
    scale = float(attrs["spatial_scale"])
    h, w = data.shape[2], data.shape[3]
    batch = rois[:, 0].to(torch.int32).long()
    x1 = torch.round(rois[:, 1] * scale)
    y1 = torch.round(rois[:, 2] * scale)
    x2 = torch.round(rois[:, 3] * scale)
    y2 = torch.round(rois[:, 4] * scale)
    # true divisions: CUDA divides by a Python scalar through its
    # reciprocal, which rounds 7/6 up, and 6 * bin then ceils to 8, not 7
    bin_h = torch.clamp(y2 - y1 + 1.0, min=1.0) / torch.full_like(y1, ph)
    bin_w = torch.clamp(x2 - x1 + 1.0, min=1.0) / torch.full_like(x1, pw)
    mask = (_bin_mask(y1, bin_h, ph, h)[:, :, None, :, None]
            & _bin_mask(x1, bin_w, pw, w)[:, None, :, None, :])  # R,ph,pw,H,W
    fmap = torch.index_select(data, 0, batch)[:, :, None, None]  # R,C,1,1,H,W
    vals = torch.where(mask[:, None], fmap,
                       torch.full((), float("-inf"), dtype=data.dtype,
                                  device=data.device))
    out = torch.amax(vals, dim=(-2, -1))
    empty = ~mask.any(dim=(-2, -1))[:, None]
    return torch.where(empty, torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)


@register_op("Correlation", inputs=("data1", "data2"))
def _correlation(ctx, attrs, data1, data2):
    """Patch cross-correlation of two feature maps: one output channel a
    displacement (dy, dx) in steps of ``stride2`` up to
    ``max_displacement``, the products (or, without ``is_multiply``, the
    absolute differences) summed over a ``kernel_size`` patch and the
    channels and divided by kernel_size**2 * C."""
    kernel = int(attrs.get("kernel_size", 1))
    max_d = int(attrs.get("max_displacement", 1))
    s1 = int(attrs.get("stride1", 1))
    s2 = int(attrs.get("stride2", 1))
    pad = int(attrs.get("pad_size", max_d))
    is_mult = bool(attrs.get("is_multiply", True))
    c, h, w = data1.shape[1:]
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    kh = kernel // 2
    out_h = (h + 2 * pad - kernel + 1 - 2 * max_d + s1 - 1) // s1
    out_w = (w + 2 * pad - kernel + 1 - 2 * max_d + s1 - 1) // s1
    base = max_d + kh

    def window(p, y, x):
        return p[:, :, y: y + out_h * s1: s1, x: x + out_w * s1: s1]

    outs = []
    for dy in range(-max_d, max_d + 1, s2):
        for dx in range(-max_d, max_d + 1, s2):
            acc = 0.0
            for ky in range(kernel):
                for kx in range(kernel):
                    a = window(p1, base - kh + ky, base - kh + kx)
                    b = window(p2, base + dy - kh + ky, base + dx - kh + kx)
                    acc = acc + (a * b if is_mult else torch.abs(a - b))
            outs.append(torch.sum(acc, dim=1) / (kernel * kernel * c))
    return torch.stack(outs, dim=1)
