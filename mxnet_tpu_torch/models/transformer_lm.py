"""Transformer language model (reference: mxnet_tpu/models/transformer_lm.py).

Pre-norm transformer blocks whose attention is the RingAttention op,
unsharded. Layout: data (B, T) token ids; SoftmaxOutput over the flattened
(B*T) positions, label (B, T) next-token ids; or, with ``fused_head``, the
vocabulary-chunked FusedCrossEntropyHead, whose output is the per-token NLL.
Parameter names and shapes are the reference's, so its checkpoints bind
directly, and the two heads share ``head_weight``. ``pipeline=True`` builds
the blocks as one TransformerStack op (layer-stacked weights), off the mesh.
:func:`get_decode_symbol` and :func:`get_batch_decode_symbol` are the
decode graphs over per-layer KV caches, with the training graph's weight
names. The MoE and Ulysses variants wait for later work.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol", "get_decode_symbol", "get_batch_decode_symbol"]


def _block(h, seq_len, hidden, heads, causal, name):
    att = sym.RingAttention(
        data=sym.LayerNorm(h, name=f"{name}_ln1"),
        num_heads=heads, causal=causal, name=f"{name}_att")
    h = h + att
    ln2 = sym.LayerNorm(h, name=f"{name}_ln2")
    ff = sym.FullyConnected(
        sym.Reshape(ln2, shape=(-1, hidden)),
        num_hidden=hidden * 4, name=f"{name}_ff1")
    ff = sym.Activation(ff, act_type="relu")
    ff = sym.FullyConnected(ff, num_hidden=hidden, name=f"{name}_ff2")
    return h + sym.Reshape(ff, shape=(-1, seq_len, hidden))


def get_symbol(vocab_size=256, num_layers=2, hidden=64, heads=4,
               seq_len=32, causal=True, fused_head=False, pipeline=False,
               num_microbatches=0):
    """Token-level LM: Embedding + learned positions -> pre-norm blocks ->
    per-position softmax head over the vocabulary (``fused_head``: the
    projection and the cross-entropy fused, output the per-token NLL).
    ``pipeline``: the blocks are one TransformerStack op with
    layer-stacked weights (``stack_*``)."""
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    pos = sym.Variable("transformer_pos_weight",
                       shape=(seq_len, hidden))    # (T, H) learned
    tok = sym.Embedding(data=data, input_dim=vocab_size,
                        output_dim=hidden, name="tok_embed")   # (B,T,H)
    h = sym.broadcast_add(tok, sym.expand_dims(pos, axis=0))
    if pipeline:
        h = sym.TransformerStack(
            data=h, num_layers=num_layers, num_heads=heads, causal=causal,
            num_microbatches=num_microbatches, name="stack")
    else:
        for i in range(num_layers):
            h = _block(h, seq_len, hidden, heads, causal, f"layer{i}")
    h = sym.LayerNorm(h, name="final_ln")
    flat_label = sym.Reshape(label, shape=(-1,))
    if fused_head:
        # never makes the (B*T, V) logits; the weight keeps the dense
        # head's name and shape, so checkpoints swap between the two heads
        return sym.FusedCrossEntropyHead(
            data=sym.Reshape(h, shape=(-1, hidden)), label=flat_label,
            num_classes=vocab_size, use_ignore=True, ignore_label=-1,
            normalization="valid", name="head")
    logits = sym.FullyConnected(sym.Reshape(h, shape=(-1, hidden)),
                                num_hidden=vocab_size, name="head")
    # ignore_label=-1: the final position has no next token
    return sym.SoftmaxOutput(logits, flat_label, use_ignore=True,
                             ignore_label=-1, normalization="valid",
                             name="softmax")


def _decode_blocks(h, num_layers, hidden, heads, chunk, att_op, att_kw):
    """The per-layer blocks of a decode graph: each layer's attention is
    ``att_op`` over its own ``layer{i}_cache_k/v``; returns (h, cache
    names, the attention's cache outputs)."""
    cache_names, new_caches = [], []
    for i in range(num_layers):
        name = f"layer{i}"
        ck = sym.Variable(f"{name}_cache_k")
        cv = sym.Variable(f"{name}_cache_v")
        cache_names += [f"{name}_cache_k", f"{name}_cache_v"]
        att = att_op(data=sym.LayerNorm(h, name=f"{name}_ln1"),
                     cache_k=ck, cache_v=cv, num_heads=heads,
                     name=f"{name}_att", **att_kw)
        h = h + att[0]
        new_caches += [att[1], att[2]]
        ln2 = sym.LayerNorm(h, name=f"{name}_ln2")
        ff = sym.FullyConnected(sym.Reshape(ln2, shape=(-1, hidden)),
                                num_hidden=hidden * 4, name=f"{name}_ff1")
        ff = sym.Activation(ff, act_type="relu")
        ff = sym.FullyConnected(ff, num_hidden=hidden, name=f"{name}_ff2")
        h = h + sym.Reshape(ff, shape=(-1, chunk, hidden))
    return h, cache_names, new_caches


def _prob_head(h, hidden, vocab_size):
    h = sym.LayerNorm(h, name="final_ln")
    logits = sym.FullyConnected(sym.Reshape(h, shape=(-1, hidden)),
                                num_hidden=vocab_size, name="head")
    return sym.SoftmaxActivation(logits, name="prob")


def get_decode_symbol(vocab_size=256, num_layers=2, hidden=64, heads=4,
                      max_len=64):
    """One-token decode graph with per-layer KV caches. Inputs: ``data``
    (B, 1) current token, ``pos`` (1,) its position, ``layer{i}_cache_k/v``
    (B, max_len, hidden). Outputs: Group([probs (B, vocab)] + caches), the
    caches being the bound cache arrays, written in place at ``pos``, so
    the reference's ``arr.alias(out)`` feedback changes nothing. Weight
    names match :func:`get_symbol`'s, so a trained checkpoint (either head)
    binds directly. Returns (symbol, cache_names)."""
    data = sym.Variable("data")
    pos = sym.Variable("pos")
    pos_w = sym.Variable("transformer_pos_weight", shape=(max_len, hidden))
    tok = sym.Embedding(data=data, input_dim=vocab_size,
                        output_dim=hidden, name="tok_embed")      # (B,1,H)
    h = sym.broadcast_add(tok, sym.expand_dims(sym.take(pos_w, pos),
                                               axis=0))
    h, cache_names, new_caches = _decode_blocks(
        h, num_layers, hidden, heads, 1, sym.DecodeAttention, {"pos": pos})
    prob = _prob_head(h, hidden, vocab_size)
    return sym.Group([prob] + new_caches), cache_names


def get_batch_decode_symbol(vocab_size=256, num_layers=2, hidden=64,
                            heads=4, max_len=64, chunk=1, paged=False):
    """Continuous-batching decode graph: a position per row, so one step
    serves sequences at different depths. ``chunk=1``: ``data`` (B, 1),
    ``pos`` (B,), caches (B, max_len, hidden). ``chunk=K > 1``: ``data``
    (B, K), ``pos`` (B, K) per-token positions (entries past a row's valid
    length must still be < max_len), ``nlen`` (B,) valid counts; probs come
    back (B*K, vocab) row-major. ``paged``: the caches are block pools
    (num_blocks, block_tokens, hidden), ``btab`` (B, S) the block tables
    (S = ceil(max_len / block_tokens)), ``pos`` always (B, K) and ``nlen``
    always present. Outputs Group([probs] + caches), the caches written in
    place. Returns (symbol, cache_names)."""
    chunk = int(chunk)
    if chunk < 1 or chunk > max_len:
        raise ValueError(
            f"chunk must be in [1, max_len={max_len}], got {chunk}")
    data = sym.Variable("data")
    pos = sym.Variable("pos")            # (B,) per row | (B, K) per token
    pos_w = sym.Variable("transformer_pos_weight", shape=(max_len, hidden))
    tok = sym.Embedding(data=data, input_dim=vocab_size,
                        output_dim=hidden, name="tok_embed")      # (B,K,H)
    pw = sym.take(pos_w, pos)
    if chunk == 1 and not paged:
        pw = sym.expand_dims(pw, axis=1)             # (B,H) -> (B,1,H)
    h = sym.broadcast_add(tok, pw)
    att_kw = {"pos": pos}
    if paged:
        att_kw.update(nlen=sym.Variable("nlen"), btab=sym.Variable("btab"),
                      chunk=chunk, paged=1, max_len=max_len)
    elif chunk > 1:
        att_kw.update(nlen=sym.Variable("nlen"), chunk=chunk)
    h, cache_names, new_caches = _decode_blocks(
        h, num_layers, hidden, heads, chunk, sym.BatchDecodeAttention,
        att_kw)
    prob = _prob_head(h, hidden, vocab_size)
    return sym.Group([prob] + new_caches), cache_names
