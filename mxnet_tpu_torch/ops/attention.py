"""Multi-head attention as a framework op (reference: mxnet_tpu/ops/attention.py,
the RingAttention part).

Off a mesh, ``RingAttention`` (alias ``MultiHeadAttention``) is plain fused
attention: QKV projections, :func:`_full_attention` per head, output
projection. ``_full_attention`` calls the flash wrapper, which launches the
CUDA kernel for tensors on the card at any T and takes its plain version for
CPU tensors. The sequence-sharded ring path and Ulysses attention wait for
later work.

The decode ops (``DecodeAttention``, ``BatchDecodeAttention``) attend one
token, or a chunk of K tokens a row, against fixed-size KV caches. They are
torch compositions, as the reference's are ``jnp``. Where the reference
returns new caches, these write this step's K/V rows into the given cache
tensors in place and return those same tensors: the caller's
``arr.alias(out)`` is then a no-op, a captured forward keeps reading the
same memory, and a step moves only the new rows where the reference's
one-hot select rewrites the whole cache. The scores, softmax and PV run in
fp32 and are cast to the input dtype, as in the reference.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .flash_attention import flash_attention
from .registry import register_op
from .tensor import as_int32

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


# -- decode: one token (or a chunk of K a row) against fixed-size KV caches --

def _project(hn, wq, wk, wv):
    return hn @ wq.T, hn @ wk.T, hn @ wv.T


def _heads_f32(cache, heads):
    """(B, T, E) -> (B, H, T, E/H) in fp32, in one copy (cast and
    transpose together)."""
    b, t, e = cache.shape
    out = torch.empty((b, heads, t, e // heads), dtype=torch.float32,
                      device=cache.device)
    return out.copy_(cache.reshape(b, t, heads, e // heads).transpose(1, 2))


def _scores_pv(q, cache_k, cache_v, tgt, heads, dtype):
    """Attention of the queries ``q`` (B, K, E) against the caches (B, T,
    E), query j of row b masked to positions ``<= tgt[b, j]``: fp32
    scores, softmax and PV, cast to ``dtype``; (B, K, E). A query whose
    mask is empty gives NaN, as in the reference."""
    b, kk, e = q.shape
    dh = e // heads
    tmax = cache_k.shape[1]
    qh = q.reshape(b, kk, heads, dh).transpose(1, 2).float()    # (B,H,K,D)
    scores = torch.matmul(qh, _heads_f32(cache_k, heads).transpose(2, 3)) \
        / math.sqrt(float(dh))                                    # (B,H,K,T)
    mask = torch.arange(tmax, device=q.device)[None, None, :] \
        <= tgt[:, :, None]                                        # (B,K,T)
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, _heads_f32(cache_v, heads)).to(dtype)
    return out.transpose(1, 2).reshape(b, kk, e)


def _out_proj(x, wo):
    return x @ wo.T


def _attend(hn, q, cache_k, cache_v, wo, tgt, heads):
    return _out_proj(_scores_pv(q, cache_k, cache_v, tgt, heads, hn.dtype),
                     wo)


def _write_at(cache, vals, at):
    """``vals`` (B, 1, E) into ``cache`` (B, T, E) at position ``at`` (a
    (1,) index tensor), in place."""
    cache.index_copy_(1, at, vals.to(cache.dtype))


def cached_attention_core(hn, wq, wk, wv, wo, cache_k, cache_v, t, heads):
    """One token at the shared position ``t`` (an int or a 0-d integer
    tensor): project q/k/v, write k/v into the caches at ``t`` in place
    (clamped into the cache, as ``dynamic_update_slice`` clamps its start),
    attend against positions ``<= t``. hn: (B, 1, E); returns (out (B, 1,
    E), cache_k, cache_v), the caches being the given tensors."""
    b = hn.shape[0]
    tmax = cache_k.shape[1]
    q, k, v = _project(hn, wq, wk, wv)
    t = torch.as_tensor(t, device=hn.device).to(torch.int64).reshape(1)
    at = t.clamp(0, tmax - 1)
    _write_at(cache_k, k, at)
    _write_at(cache_v, v, at)
    out = _attend(hn, q, cache_k, cache_v, wo, t.expand(b).reshape(b, 1),
                  heads)
    return out, cache_k, cache_v


@register_op("DecodeAttention",
             inputs=("data",) + _WEIGHTS + ("cache_k", "cache_v", "pos"),
             num_outputs=3, infer_param_shapes=_attn_infer)
def _decode_attention_step(ctx, attrs, data, wq, wk, wv, wo, cache_k,
                           cache_v, pos):
    """Single-token attention step over a fixed-size KV cache. data (B, 1,
    E) current-token hidden; pos (1,) current position (0-based); returns
    (out (B, 1, E), cache_k, cache_v), the caches written in place at
    ``pos``. Weight names match RingAttention's, so a trained checkpoint
    binds directly."""
    heads = int(attrs.get("num_heads", 1))
    b, t, e = data.shape
    if t != 1:
        raise MXNetError(f"DecodeAttention: data must be one token "
                         f"(B, 1, E), got T={t}")
    if e % heads != 0:
        raise MXNetError(f"DecodeAttention: hidden {e} not divisible by "
                         f"num_heads {heads}")
    p = as_int32(pos.reshape(())).to(torch.int64)
    return cached_attention_core(data, wq, wk, wv, wo, cache_k, cache_v,
                                 p, heads)


def _write_rows(cache, vals, tgt, valid):
    """Write ``vals[b, j]`` (B, K, E) into ``cache`` (B, T, E) at ``tgt[b,
    j]`` where ``valid[b, j]``, in place, moving only those rows: the
    reference's one-hot-window select (a position no valid column targets
    keeps its value; one outside the cache is not written). Every column
    scatters, each to its target clamped into the cache, and every column
    that lands on one position writes the same value there: the last valid
    column's row for that position, else the position's old row. So the
    order in which the scatter lands repeated positions does not matter.
    Two valid columns of a row at one position (which no caller makes)
    leave the later one's row, where the reference leaves their sum."""
    b, t_max, _e = cache.shape
    kk = tgt.shape[1]
    ok = valid & (tgt >= 0) & (tgt < t_max)
    idx = tgt.clamp(0, t_max - 1)
    same = (idx[:, :, None] == idx[:, None, :]) & ok[:, None, :]  # (B,K,K)
    cols = torch.arange(kk, device=cache.device)
    last = torch.where(same, cols, -1).amax(dim=-1)              # (B,K)
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, kk)
    new = vals.to(cache.dtype)[rows, last.clamp(min=0)]
    put = torch.where((last >= 0)[..., None], new, cache[rows, idx])
    cache.index_put_((rows, idx), put)


def batch_cached_attention_core(hn, wq, wk, wv, wo, cache_k, cache_v, pos,
                                heads, nlen=None):
    """Per-row positions: row b feeds its tokens at its own positions and
    attends to its own prefix, so rows never mix. ``hn`` (B, 1, E) with
    ``pos`` (B,) and no ``nlen`` is the single-token form; otherwise
    ``pos`` is the (B, K) per-token target matrix (``start_b + j``) and
    ``nlen`` (B,) each row's valid chunk length (an idle row with 0 writes
    nothing). The caches are written in place; returns (out (B, K, E),
    cache_k, cache_v)."""
    b, kk, _e = hn.shape
    q, k, v = _project(hn, wq, wk, wv)
    if kk == 1 and nlen is None:
        tgt = pos.reshape(b, 1)
        valid = torch.ones((b, 1), dtype=torch.bool, device=hn.device)
    else:
        tgt = pos.reshape(b, kk)
        if nlen is None:
            nlen = torch.full((b,), kk, dtype=torch.int64, device=hn.device)
        valid = torch.arange(kk, device=hn.device)[None, :] < nlen[:, None]
    return _chunked_write_and_attend(hn, q, k, v, wo, cache_k, cache_v,
                                     tgt, valid, heads)


def _chunked_write_and_attend(hn, q, k, v, wo, cache_k, cache_v, tgt,
                              valid, heads):
    """The chunked body: this step's K/V rows into the caches in place
    (:func:`_write_rows`), per-query prefix masks, fp32 attention, output
    projection."""
    _write_rows(cache_k, k, tgt, valid)
    _write_rows(cache_v, v, tgt, valid)
    return _attend(hn, q, cache_k, cache_v, wo, tgt, heads), cache_k, cache_v


# paged KV layout: reserved physical block ids. Block 0 is the NULL block,
# always zero, the gather target of unmapped block-table entries; block 1 is
# the TRASH block, where masked writes land; it is never mapped into a
# table, so never read.
KV_NULL_BLOCK = 0
KV_TRASH_BLOCK = 1
KV_RESERVED_BLOCKS = 2


def paged_cached_attention_core(hn, wq, wk, wv, wo, pool_k, pool_v, pos,
                                heads, nlen, btab, max_len):
    """Block-table form of the chunked step: K/V live in pools of blocks
    (num_blocks, block_tokens, E) and row b's positions map through its
    table ``btab[b]`` (S = ceil(max_len / block_tokens) physical ids; 0,
    the NULL block, where unmapped). This step's K/V rows scatter into the
    pools at ``(btab[b, pos // bs], pos % bs)``, masked ones into the TRASH
    block, whose repeated indices are never read; then each row's blocks
    are gathered into a dense (B, max_len, E) view and attended as the
    dense chunked form does, so the probabilities equal the dense layout's.
    A valid write never lands on a block another table maps: the pool's
    copy-on-write gives each written block one owner
    (``serving.kvpool.KVBlockPool``). Returns (out, pool_k, pool_v), the
    pools written in place."""
    b, kk, e = hn.shape
    _nblk, bs, _e = pool_k.shape
    table = as_int32(btab).to(torch.int64)                         # (B,S)
    q, k, v = _project(hn, wq, wk, wv)
    tgt = pos.reshape(b, kk)
    valid = torch.arange(kk, device=hn.device)[None, :] < nlen[:, None]
    slot = (tgt // bs).clamp(0, table.shape[1] - 1)
    bids = torch.where(valid, torch.gather(table, 1, slot), KV_TRASH_BLOCK)
    ids, off = bids.reshape(-1), (tgt % bs).reshape(-1)
    pool_k.index_put_((ids, off), k.reshape(-1, e).to(pool_k.dtype))
    pool_v.index_put_((ids, off), v.reshape(-1, e).to(pool_v.dtype))
    view_k = pool_k[table].reshape(b, -1, e)[:, :max_len]
    view_v = pool_v[table].reshape(b, -1, e)[:, :max_len]
    return _attend(hn, q, view_k, view_v, wo, tgt, heads), pool_k, pool_v


def _batch_decode_inputs(attrs):
    """BatchDecodeAttention's inputs: ``nlen`` on the chunked form (chunk >
    1) and the paged form (masked even at chunk 1), ``btab`` on the paged
    form only."""
    base = ["data", *_WEIGHTS, "cache_k", "cache_v", "pos"]
    paged = int(attrs.get("paged", 0))
    if int(attrs.get("chunk", 1)) > 1 or paged:
        base.append("nlen")
    if paged:
        base.append("btab")
    return base


def _lengths(nlen, b):
    nl = as_int32(nlen.reshape(-1)).to(torch.int64)
    if nl.shape[0] != b:
        raise MXNetError(f"BatchDecodeAttention: nlen must carry one "
                         f"length per row, got {nl.shape[0]} for batch {b}")
    return nl


@register_op("BatchDecodeAttention",
             inputs=_batch_decode_inputs,
             num_outputs=3, infer_param_shapes=_attn_infer)
def _batch_decode_attention_step(ctx, attrs, data, wq, wk, wv, wo, cache_k,
                                 cache_v, pos, nlen=None, btab=None):
    """Cached attention with a position per row (continuous batching).
    ``chunk=1``: data (B, 1, E), pos (B,), caches (B, T_max, E).
    ``chunk=K > 1``: data (B, K, E), pos (B, K) per-token positions, nlen
    (B,) valid lengths (decode rows 1, idle rows 0). ``paged=1``: the
    caches are block pools (num_blocks, block_tokens, E), ``btab`` (B, S)
    the block tables, ``max_len`` the gather width, and pos/nlen take their
    chunked shapes at any chunk. Returns (out, cache_k, cache_v), the
    caches written in place."""
    heads = int(attrs.get("num_heads", 1))
    chunk = int(attrs.get("chunk", 1))
    paged = int(attrs.get("paged", 0))
    b, t, e = data.shape
    if t != chunk:
        raise MXNetError(f"BatchDecodeAttention: data must carry chunk="
                         f"{chunk} tokens per row (B, {chunk}, E), got "
                         f"T={t}")
    if e % heads != 0:
        raise MXNetError(f"BatchDecodeAttention: hidden {e} not divisible "
                         f"by num_heads {heads}")
    if paged:
        p = as_int32(pos.reshape(b, chunk)).to(torch.int64)
        nl = _lengths(nlen, b)
        max_len = int(attrs["max_len"])
        if btab.shape[0] != b:
            raise MXNetError(f"BatchDecodeAttention: btab must carry one "
                             f"block table per row, got {btab.shape[0]} "
                             f"for batch {b}")
        return paged_cached_attention_core(data, wq, wk, wv, wo, cache_k,
                                           cache_v, p, heads, nl, btab,
                                           max_len)
    if chunk == 1:
        p = as_int32(pos.reshape(-1)).to(torch.int64)
        if p.shape[0] != b:
            raise MXNetError(f"BatchDecodeAttention: pos must carry one "
                             f"position per row, got {p.shape[0]} for "
                             f"batch {b}")
        return batch_cached_attention_core(data, wq, wk, wv, wo, cache_k,
                                           cache_v, p, heads)
    p = as_int32(pos.reshape(b, chunk)).to(torch.int64)
    return batch_cached_attention_core(data, wq, wk, wv, wo, cache_k,
                                       cache_v, p, heads,
                                       nlen=_lengths(nlen, b))
