"""Transformer language model (reference: mxnet_tpu/models/transformer_lm.py).

Pre-norm transformer blocks whose attention is the RingAttention op,
unsharded. Layout: data (B, T) token ids; SoftmaxOutput over the flattened
(B*T) positions, label (B, T) next-token ids; or, with ``fused_head``, the
vocabulary-chunked FusedCrossEntropyHead, whose output is the per-token NLL.
Parameter names and shapes are the reference's, so its checkpoints bind
directly, and the two heads share ``head_weight``. The MoE, pipeline and
Ulysses variants and the decode symbols wait for later work.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol"]


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
               seq_len=32, causal=True, fused_head=False):
    """Token-level LM: Embedding + learned positions -> pre-norm blocks ->
    per-position softmax head over the vocabulary (``fused_head``: the
    projection and the cross-entropy fused, output the per-token NLL)."""
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    pos = sym.Variable("transformer_pos_weight",
                       shape=(seq_len, hidden))    # (T, H) learned
    tok = sym.Embedding(data=data, input_dim=vocab_size,
                        output_dim=hidden, name="tok_embed")   # (B,T,H)
    h = sym.broadcast_add(tok, sym.expand_dims(pos, axis=0))
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
