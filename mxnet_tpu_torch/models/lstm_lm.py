"""LSTM language model for PTB (reference: mxnet_tpu/models/lstm_lm.py),
``sym_gen(seq_len)`` factories for ``BucketingModule``.

``sym_gen_factory`` unrolls a ``SequentialRNNCell`` of ``LSTMCell``s (about
13 nodes a step and layer); ``fused_sym_gen_factory`` runs the stack as one
``RNN`` node (cuDNN on the card). The fused graph turns the RNN's
time-major output back to batch-major before the prediction layer, so its
rows pair with the ``(N, T)`` labels that ``update_metric`` hands the
metric, as the unrolled graph's do. The reference flattens the time-major
output and transposes only the loss's label, so its metric pairs each
prediction with another position's label; the loss and the gradients are
the same either way (the rows are a permutation).
"""
from __future__ import annotations

from .. import symbol as sym
from ..rnn import LSTMCell, SequentialRNNCell


def sym_gen_factory(num_hidden=200, num_embed=200, num_layers=2,
                    vocab_size=10000, dropout=0.0):
    """Unrolled-cell variant (reference lstm_bucketing.py sym_gen)."""

    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data, input_dim=vocab_size,
                              output_dim=num_embed, name="embed")
        stack = SequentialRNNCell()
        for i in range(num_layers):
            stack.add(LSTMCell(num_hidden=num_hidden, prefix=f"lstm_l{i}_"))
        outputs, states = stack.unroll(seq_len, inputs=embed, layout="NTC",
                                       merge_outputs=False)
        outs = [sym.expand_dims(o, axis=1) for o in outputs]
        pred = sym.Concat(*outs, dim=1) if len(outs) > 1 else outs[0]
        pred = sym.Reshape(pred, shape=(-1, num_hidden))
        pred = sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
        label_r = sym.Reshape(label, shape=(-1,))
        return (sym.SoftmaxOutput(pred, label_r, name="softmax"),
                ["data"], ["softmax_label"])

    return sym_gen


def fused_sym_gen_factory(num_hidden=200, num_embed=200, num_layers=2,
                          vocab_size=10000, dropout=0.0):
    """Fused-RNN variant: one ``RNN`` node for the whole stack (MXNet's
    cuDNN path, src/operator/rnn.cc), its output batch-major again."""

    def sym_gen(seq_len):
        data = sym.Variable("data")          # (N, T)
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data, input_dim=vocab_size,
                              output_dim=num_embed, name="embed")  # (N,T,E)
        tnc = sym.transpose(embed, axes=(1, 0, 2))  # (T, N, E)
        rnn = sym.RNN(tnc, sym.Variable("rnn_parameters"),
                      sym.Variable("rnn_state"),
                      sym.Variable("rnn_state_cell"),
                      state_size=num_hidden, num_layers=num_layers,
                      mode="lstm", p=dropout, name="rnn")  # (T, N, H)
        ntc = sym.transpose(rnn, axes=(1, 0, 2))  # (N, T, H)
        pred = sym.Reshape(ntc, shape=(-1, num_hidden))
        pred = sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
        label_r = sym.Reshape(label, shape=(-1,))
        return (sym.SoftmaxOutput(pred, label_r, name="softmax"),
                ["data"], ["softmax_label"])

    return sym_gen
