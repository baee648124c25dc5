"""Multi-head attention as a framework op (reference: mxnet_tpu/ops/attention.py,
the RingAttention part).

Off a mesh, ``RingAttention`` (alias ``MultiHeadAttention``) is plain fused
attention: QKV projections, :func:`_full_attention` per head, output
projection. ``_full_attention`` calls the flash wrapper, which launches the
CUDA kernel for tensors on the card at any T and takes its plain version for
CPU tensors. The sequence-sharded ring path, Ulysses attention and the decode
ops wait for later work.
"""
from __future__ import annotations

from ..base import MXNetError
from .flash_attention import flash_attention
from .registry import register_op

_WEIGHTS = ("q_weight", "k_weight", "v_weight", "out_weight")


def _attn_infer(attrs, shapes):
    d = shapes.get("data")
    if d is not None:
        e = d[2]
        for w in _WEIGHTS:
            shapes.setdefault(w, (e, e))
    return shapes


def _full_attention(q, k, v, causal):
    # CUDA kernel: K/V stream through shared memory, scores stay on chip.
    # The wrapper routes by device: CPU tensors take its plain version.
    return flash_attention(q, k, v, causal=causal)


def _seq_parallel_layer(ctx, attrs, data, wq, wk, wv, wo, op_name):
    """QKV projection, head/shape checks, the mesh guard, attention and the
    output projection. Only the unsharded branch is ported."""
    heads = int(attrs.get("num_heads", 1))
    causal = bool(attrs.get("causal", False))
    b, t, e = data.shape
    if e % heads != 0:
        raise MXNetError(f"{op_name}: hidden {e} not divisible by "
                         f"num_heads {heads}")
    dh = e // heads

    mesh = ctx.mesh
    sp = mesh.shape.get("seq", 1) if mesh is not None else 1
    if sp > 1:
        raise MXNetError(f"{op_name}: sequence-parallel attention over a "
                         "mesh is not yet ported")
    q = (data @ wq.T).reshape(b, t, heads, dh)
    k = (data @ wk.T).reshape(b, t, heads, dh)
    v = (data @ wv.T).reshape(b, t, heads, dh)
    attn = _full_attention(q, k, v, causal)
    return attn.reshape(b, t, e) @ wo.T


@register_op("RingAttention", inputs=("data",) + _WEIGHTS,
             alias=("MultiHeadAttention",), infer_param_shapes=_attn_infer)
def _ring_attention_layer(ctx, attrs, data, wq, wk, wv, wo):
    """data: (B, T, E) -> (B, T, E). attrs: num_heads, causal."""
    return _seq_parallel_layer(ctx, attrs, data, wq, wk, wv, wo,
                               "RingAttention")
