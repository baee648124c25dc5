"""Attention over local blocks (reference: mxnet_tpu/parallel/ring_attention.py).

Only :func:`local_attention`, the plain attention body, is ported: the
unsharded attention op uses it where the flash kernel does not apply, and
the kernel's plain version is written from its math. ``ring_attention``
itself, which rotates K/V blocks around a device mesh, waits for the
multi-device work.
"""
from __future__ import annotations

import torch

__all__ = ["local_attention"]


def local_attention(q, k, v, causal=False, q_offset=0, k_offset=0, scale=None):
    """Plain attention on local blocks.

    q: (B, Tq, H, D), k/v: (B, Tk, H, D). Returns the unnormalised output
    and the softmax statistics for online combination: (o_unnorm (B, Tq, H,
    D), row_max (B, H, Tq), row_sum (B, H, Tq)). Scores are fp32.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qi = q_offset + torch.arange(tq, device=q.device)[:, None]
        ki = k_offset + torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(qi < ki, float("-inf"))
    m = s.amax(dim=-1)                                        # (B, H, Tq)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = p.sum(dim=-1)                                         # (B, H, Tq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype))
    return o, m, l
