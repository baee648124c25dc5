"""Symbolic RNN cells (reference: mxnet_tpu/rnn/rnn_cell.py).

A cell builds an unrolled graph whose steps share the cell's parameter
variables; ``BucketingModule`` binds one such graph per sequence length.
Each step is a few ``FullyConnected`` and elementwise nodes, so the port's
eager executor walks every step's nodes on the host; the fused ``RNN`` op
(cuDNN on the card) is the alternative with one node for the whole stack.
"""
from __future__ import annotations

from .. import symbol
from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ZoneoutCell", "ModifierCell"]


class RNNParams:
    """Container for cell parameter symbols, shared by name
    (reference: rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract RNN cell (reference: rnn_cell.py BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_shape(self):
        raise NotImplementedError()

    def begin_state(self, func=None, **kwargs):
        """Initial state symbols (reference: rnn_cell.py begin_state).

        States are free variables with partial shape (0, num_hidden) — the
        0 batch dim resolves at bind time (MXNet partial-shape convention)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called directly."
        states = []
        for shape in self.state_shape:
            self._init_counter += 1
            state = symbol.Variable(
                f"{self._prefix}begin_state_{self._init_counter}",
                **({"shape": shape} if shape is not None else {}))
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split fused weights for checkpoint compat (reference: rnn_cell.py).

        Cells here are already unfused — identity."""
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=False):
        """Unroll the cell `length` steps (reference: rnn_cell.py unroll)."""
        self.reset()
        if inputs is None:
            inputs = [symbol.Variable(f"{input_prefix}t{i}_data")
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1, \
                "unroll doesn't allow grouped symbol as input"
            axis = layout.find("T")
            inputs = list(symbol.SliceChannel(inputs, axis=axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
        else:
            assert len(inputs) == length
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            # stack per-step outputs back on the layout's T axis, so TNC
            # callers get (T, N, C) and NTC callers get (N, T, C)
            t_axis = layout.find("T")
            outputs = [symbol.expand_dims(i, axis=t_axis) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=t_axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell with tanh (reference: rnn_cell.py:141 RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]


    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB, num_hidden=self._num_hidden,
                                    name=f"{name}h2h")
        output = symbol.Activation(i2h + h2h, act_type=self._activation,
                                   name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference: rnn_cell.py:207 LSTMCell)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None, forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hB = self.params.get("h2h_bias")
        self._forget_bias = forget_bias

    @property
    def state_shape(self):
        return [(0, self._num_hidden), (0, self._num_hidden)]


    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name=f"{name}h2h")
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4,
                                          name=f"{name}slice")
        in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid",
                                    name=f"{name}i")
        forget_gate = symbol.Activation(slice_gates[1] + self._forget_bias,
                                        act_type="sigmoid", name=f"{name}f")
        in_transform = symbol.Activation(slice_gates[2], act_type="tanh",
                                         name=f"{name}c")
        out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid",
                                     name=f"{name}o")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh",
                                              name=f"{name}state")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (post-0.9 reference addition; same structure)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]


    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name=f"{name}h2h")
        i2h_s = symbol.SliceChannel(i2h, num_outputs=3, name=f"{name}i2h_slice")
        h2h_s = symbol.SliceChannel(h2h, num_outputs=3, name=f"{name}h2h_slice")
        reset = symbol.Activation(i2h_s[0] + h2h_s[0], act_type="sigmoid",
                                  name=f"{name}r")
        update = symbol.Activation(i2h_s[1] + h2h_s[1], act_type="sigmoid",
                                   name=f"{name}z")
        next_h_tmp = symbol.Activation(i2h_s[2] + reset * h2h_s[2],
                                       act_type="tanh", name=f"{name}h")
        next_h = (1.0 - update) * next_h_tmp + update * states[0]
        return next_h, [next_h]


class SequentialRNNCell(BaseRNNCell):
    """Stack cells (reference: rnn_cell.py:283 SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "Either specify params for SequentialRNNCell or child cells, not both."
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_shape(self):
        return sum([c.state_shape for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_shape)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference: rnn_cell.py ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_shape(self):
        return self.base_cell.state_shape

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(**kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class DropoutCell(ModifierCell):
    """Apply dropout on base cell output."""

    def __init__(self, base_cell, dropout=0.5):
        super().__init__(base_cell)
        self.dropout = dropout

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        if self.dropout > 0:
            output = symbol.Dropout(data=output, p=self.dropout)
        return output, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization on states."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        if self.zoneout_outputs > 0 and self.prev_output is not None:
            mask = symbol.Dropout(symbol.ones_like(next_output),
                                  p=self.zoneout_outputs)
            next_output = mask * next_output + (1.0 - mask) * self.prev_output
        self.prev_output = next_output
        return next_output, next_states


class BidirectionalCell(BaseRNNCell):
    """Run two cells over both directions (reference-era pattern)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]

    @property
    def state_shape(self):
        return sum([c.state_shape for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=False):
        self.reset()
        if inputs is None:
            inputs = [symbol.Variable(f"{input_prefix}t{i}_data")
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            axis = layout.find("T")
            inputs = list(symbol.SliceChannel(inputs, axis=axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
        if begin_state is None:
            begin_state = self.begin_state()
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_shape)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout, merge_outputs=False)
        outputs = [
            symbol.Concat(l_o, r_o, dim=1,
                          name=f"{self._output_prefix}t{i}")
            for i, (l_o, r_o) in enumerate(zip(l_outputs,
                                               reversed(r_outputs)))]
        if merge_outputs:
            t_axis = layout.find("T")
            outputs = [symbol.expand_dims(i, axis=t_axis) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=t_axis)
        return outputs, l_states + r_states
