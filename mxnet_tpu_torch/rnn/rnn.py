"""RNN checkpoint helpers (reference: mxnet_tpu/rnn/rnn.py)."""
from __future__ import annotations

from ..model import save_checkpoint, load_checkpoint

__all__ = ["rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Pack cell weights then checkpoint (reference: rnn/rnn.py save_rnn_checkpoint)."""
    if not isinstance(cells, (list, tuple)):
        cells = [cells]
    for cell in cells:
        arg_params = cell.pack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch, ctx=None):
    """Load and unpack cell weights (reference: rnn/rnn.py
    load_rnn_checkpoint); the arrays land on ``ctx`` (default: the current
    context)."""
    sym, arg, aux = load_checkpoint(prefix, epoch, ctx=ctx)
    if not isinstance(cells, (list, tuple)):
        cells = [cells]
    for cell in cells:
        arg = cell.unpack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback variant (reference: rnn/rnn.py do_rnn_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback


def rnn_unroll(cell, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC"):
    """Legacy free-function unroll (reference: rnn/rnn.py:7 rnn_unroll);
    superseded by ``cell.unroll`` which this delegates to."""
    return cell.unroll(length, inputs=inputs, begin_state=begin_state,
                       input_prefix=input_prefix, layout=layout)
