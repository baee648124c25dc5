"""A stack of identical transformer blocks as one op (reference:
mxnet_tpu/ops/transformer_stack.py).

Per-layer weights are stacked on a leading L axis, one tensor a role
(:data:`_ROLES`). Off a mesh the body is a loop over the L layers, where the
reference scans them; with a pipe axis above 1 the reference runs GPipe over
the mesh, which is not ported. The block is pre-norm: x + MHA(LN(x)), then
h + FFN(LN(h)), as ``models/transformer_lm``'s per-layer symbols, with the
weights stacked.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register_op

_ROLES = (
    ("ln1_gamma", lambda e, h: (e,)),
    ("ln1_beta", lambda e, h: (e,)),
    ("q_weight", lambda e, h: (e, e)),
    ("k_weight", lambda e, h: (e, e)),
    ("v_weight", lambda e, h: (e, e)),
    ("out_weight", lambda e, h: (e, e)),
    ("ln2_gamma", lambda e, h: (e,)),
    ("ln2_beta", lambda e, h: (e,)),
    ("ff1_weight", lambda e, h: (h, e)),   # FC convention: (out, in)
    ("ff1_bias", lambda e, h: (h,)),
    ("ff2_weight", lambda e, h: (e, h)),
    ("ff2_bias", lambda e, h: (e,)),
)

_INPUTS = ("data",) + tuple(name for name, _ in _ROLES)


def _stack_infer(attrs, shapes):
    d = shapes.get("data")
    if d is not None:
        e = d[2]
        n_layers = int(attrs["num_layers"])
        hid = int(attrs.get("ffn_hidden", 4 * e))
        for name, shape_fn in _ROLES:
            shapes.setdefault(name, (n_layers,) + shape_fn(e, hid))
    return shapes


def _layer_norm(x, gamma, beta, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


def _block(params, x, heads, causal):
    """One pre-norm transformer block; ``params`` ordered as
    :data:`_ROLES`, x (B, T, E). The scores take x's dtype, the softmax
    fp32, as the reference's."""
    (g1, b1, wq, wk, wv, wo, g2, b2, w1, bb1, w2, bb2) = params
    b, t, e = x.shape
    dh = e // heads

    h = _layer_norm(x, g1, b1)
    q = (h @ wq.T).reshape(b, t, heads, dh)
    k = (h @ wk.T).reshape(b, t, heads, dh)
    v = (h @ wv.T).reshape(b, t, heads, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(float(dh), dtype=x.dtype, device=x.device))
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=x.device))
        scores = scores.masked_fill(~mask, float("-inf"))
    attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    ctx_v = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, e)
    x = x + ctx_v @ wo.T

    h = _layer_norm(x, g2, b2)
    ff = torch.relu(h @ w1.T + bb1)
    return x + ff @ w2.T + bb2


@register_op("TransformerStack", inputs=_INPUTS,
             infer_param_shapes=_stack_infer,
             attr_defaults={"num_heads": 1, "causal": True,
                            "num_microbatches": 0})
def _transformer_stack(ctx, attrs, data, *stacked):
    """data (B, T, E) -> (B, T, E) through ``num_layers`` identical blocks.
    attrs: ``num_layers``, ``num_heads``, ``ffn_hidden`` (default 4E),
    ``causal``, ``num_microbatches`` (the pipeline's; unused here)."""
    heads = int(attrs.get("num_heads", 1))
    causal = bool(attrs.get("causal", True))
    n_layers = int(attrs["num_layers"])
    if data.shape[2] % heads != 0:
        raise MXNetError(f"TransformerStack: hidden {data.shape[2]} not "
                         f"divisible by num_heads {heads}")
    mesh = ctx.mesh
    pp = mesh.shape.get("pipe", 1) if mesh is not None else 1
    if pp > 1:
        raise MXNetError("TransformerStack: pipeline parallelism over a "
                         "mesh's pipe axis is not ported")
    x = data
    for i in range(n_layers):
        x = _block(tuple(w[i] for w in stacked), x, heads, causal)
    return x


