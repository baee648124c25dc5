"""FusedCrossEntropyHead: the LM head and softmax cross-entropy without the
(N, V) logits matrix (reference: mxnet_tpu/ops/fused_ce.py).

The dense head (FullyConnected to the vocabulary, then SoftmaxOutput) makes an
(N, V) logits matrix and keeps the (N, V) probabilities for its backward. This
op fuses projection, log-softmax and NLL into one pass over vocabulary chunks,
as the reference's ``lax.scan`` does, here as a Python loop over chunks:

- forward: an online logsumexp over the chunks (running max, rescaled sum),
  and each token's label logit gathered on the way. The residuals are O(N):
  x, w, b, the per-token logsumexp and the label.
- backward: each chunk's logits recomputed from the saved logsumexp; the
  chunk's (softmax - onehot) slab goes straight into dx (accumulated in fp32
  across chunks), the chunk's rows of dw, and db. One (N, chunk) slab is live
  at a time; no (N, V) tensor is ever made.

The projection runs in the compute dtype (bf16 under amp) and the statistics
in fp32, as in the reference. A ragged last chunk is sliced short, which is
the reference's zero-padded chunk with its padded columns masked to -inf,
without the padding. The chunk products are plain large matrix products,
which the reference leaves to XLA and this op to ``torch.matmul``.

Semantics follow SoftmaxOutput's loss protocol: ``grad_scale``,
``use_ignore``/``ignore_label``, ``normalization`` null|batch|valid, and the
incoming head gradient ignored. The output is the per-token NLL (N,) in
fp32, 0 at ignored positions.
"""
from __future__ import annotations

import torch

from .registry import register_op
from .tensor import as_int32

__all__ = []


def _head_infer(attrs, shapes):
    data = shapes.get("data")
    if data is not None:
        num_classes = int(attrs["num_classes"])
        shapes.setdefault("weight", (num_classes, int(data[-1])))
        if not attrs.get("no_bias", False):
            shapes.setdefault("bias", (num_classes,))
    return shapes


def _chunk_logits(x, w, b32, c0, c1):
    """fp32 logits of vocabulary rows [c0, c1): the product in x's dtype,
    the bias added in fp32."""
    return torch.matmul(x, w[c0:c1].to(x.dtype).T).float() + b32[c0:c1]


def _mm_f32(a, b):
    """``a @ b`` of 16-bit operands as an fp32 product (the reference's
    ``preferred_element_type=float32``): on the card cuBLAS's 16-bit GEMM
    with an fp32 output; on the CPU the same products in fp32, where the
    16-bit operands are exact."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, label, num_classes, chunk, use_ignore,
                ignore_label, grad_scale, norm, batches, valid_total):
        n = x.shape[0]
        b32 = b.float()
        li = as_int32(label.reshape(-1)).to(torch.int64)
        m = torch.full((n,), float("-inf"), dtype=torch.float32,
                       device=x.device)
        s = torch.zeros(n, dtype=torch.float32, device=x.device)
        lbl = torch.zeros(n, dtype=torch.float32, device=x.device)
        for c0 in range(0, num_classes, chunk):
            c1 = min(c0 + chunk, num_classes)
            logits = _chunk_logits(x, w, b32, c0, c1)          # (N, chunk)
            new_m = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - new_m) \
                + torch.exp(logits - new_m[:, None]).sum(dim=-1)
            m = new_m
            in_chunk = (li >= c0) & (li < c1)
            got = logits.gather(1, (li - c0).clamp(0, c1 - c0 - 1)[:, None])
            lbl = torch.where(in_chunk, got[:, 0], lbl)
        lse = torch.log(s) + m
        nll = lse - lbl
        if use_ignore:
            nll = torch.where(li == ignore_label, 0.0, nll)
        ctx.save_for_backward(x, w, b, lse, label)
        ctx.attrs = (num_classes, chunk, use_ignore, ignore_label, grad_scale,
                     norm, batches, valid_total)
        return nll

    @staticmethod
    def backward(ctx, g):
        # g, the head gradient, is unused: this op is the loss
        x, w, b, lse, label = ctx.saved_tensors
        (num_classes, chunk, use_ignore, ignore_label, grad_scale, norm,
         batches, valid_total) = ctx.attrs
        n = x.shape[0]
        b32 = b.float()
        li = as_int32(label.reshape(-1)).to(torch.int64)
        keep = (li != ignore_label).float() if use_ignore \
            else torch.ones(n, dtype=torch.float32, device=x.device)
        if norm == "batch":
            scale = keep * (grad_scale / (n * batches))
        elif norm == "valid":
            count = valid_total(x.device) if valid_total else keep.sum()
            scale = keep * (grad_scale / torch.clamp(count, min=1.0))
        else:
            scale = keep * grad_scale
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty_like(w)
        db = torch.empty_like(b)
        for c0 in range(0, num_classes, chunk):
            c1 = min(c0 + chunk, num_classes)
            wc = w[c0:c1].to(x.dtype)
            p = torch.exp(_chunk_logits(x, w, b32, c0, c1) - lse[:, None])
            onehot = (li - c0)[:, None] == torch.arange(
                c1 - c0, device=x.device)
            slab32 = (p - onehot.float()) * scale[:, None]
            slab = slab32.to(x.dtype)
            # fp32 accumulation across chunks; rounding the running sum to
            # the 16-bit type every chunk would add noise to dx
            dx += _mm_f32(slab, wc)
            dw[c0:c1] = torch.matmul(slab.T, x).to(w.dtype)
            db[c0:c1] = slab32.sum(dim=0).to(b.dtype)
        return (dx.to(x.dtype), dw, db) + (None,) * 9


@register_op(
    "FusedCrossEntropyHead",
    inputs=lambda attrs: (["data", "weight", "label"]
                          if attrs.get("no_bias", False)
                          else ["data", "weight", "bias", "label"]),
    infer_param_shapes=_head_infer)
def _fused_ce_head(ctx, attrs, data, weight, *rest):
    """Per-token NLL (N,) fp32 of the label under softmax(data @ weight.T +
    bias), computed over ``chunk_size`` vocabulary rows at a time."""
    num_classes = int(attrs["num_classes"])
    chunk = min(int(attrs.get("chunk_size", 2048)), num_classes)
    if attrs.get("no_bias", False):
        (label,) = rest
        bias = torch.zeros(num_classes, dtype=torch.float32,
                           device=data.device)
    else:
        bias, label = rest
    if data.dim() != 2:
        data = data.reshape(-1, data.shape[-1])
    use_ignore = bool(attrs.get("use_ignore", False))
    ignore_label = int(attrs.get("ignore_label", -1))
    norm = attrs.get("normalization", "null")
    valid_total = None
    if ctx.replicas is not None and norm == "valid":
        li = as_int32(label.reshape(-1))
        valid_total = ctx.replicas.put_count(
            ctx, (li != ignore_label).sum().float() if use_ignore
            else torch.tensor(float(li.numel())))
    return _FusedCE.apply(
        data, weight, bias, label, num_classes, chunk, use_ignore,
        ignore_label, float(attrs.get("grad_scale", 1.0)), norm,
        ctx.replica_count, valid_total)
