"""The fused RNN operator (reference: mxnet_tpu/ops/rnn_op.py; MXNet's
``src/operator/rnn.cc`` is cuDNN-only).

One ``RNN`` node runs a whole multi-layer, optionally bidirectional
recurrence. The interface is the reference's: inputs (data, parameters,
state[, state_cell]), data ``(T, N, C)``, one flat parameter vector with a
``[W_ih, W_hh, b_ih, b_hh]`` block per layer and direction (gate order LSTM
i, f, c, o; GRU r, z, n with the recurrent bias inside ``r * (W_hn h +
b_hn)``), outputs (output[, state_n[, cell_n]]).

Two routes, chosen by the device of the data:
- **card** (CUDA tensors): cuDNN's RNN through ``torch._cudnn_rnn``.
  cuDNN's weight buffer is the bound flat vector itself where cuDNN lays
  the configuration out as the reference does (one layer, one direction).
  With more layers or directions cuDNN keeps every matrix first and every
  bias after them (MXNet's own layout), so its buffer is a gather of the
  vector, one kernel a call (:func:`_cudnn_layout` finds the layout once
  per configuration by passing a probe vector through
  ``torch._cudnn_rnn_flatten_weight``). The per-matrix weights passed
  beside the buffer are views of the bound vector, so autograd brings
  cuDNN's weight gradients back into it.
- **plain** (CPU tensors, and the card's cross-check through
  ``rnn_forward(..., plain=True)``): the reference's step loop in torch ops.

With ``p`` > 0 in training the layers run one at a time and the output of
each but the last goes through the reference's dropout, its masks drawn from
the node's generator; cuDNN's own dropout is never used. The reference draws
every layer's mask from the node's one key (equal masks for equal shapes);
here they are successive draws of the node's generator.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .nn import dropout_apply
from .registry import register_op

__all__ = ["rnn_param_size", "rnn_forward", "reset_launches"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
_CUDNN_MODE = {"rnn_relu": 0, "rnn_tanh": 1, "lstm": 2, "gru": 3}

# calls of cuDNN's RNN (the card route), counted where they launch, and
# the gathers of the flat vector into cuDNN's layout among them
cudnn_calls = 0
weight_gathers = 0
_LAYOUTS: dict = {}


def reset_launches():
    global cudnn_calls, weight_gathers
    cudnn_calls = weight_gathers = 0


def _layer_param_size(mode, input_size, state_size):
    g = _GATES[mode]
    return g * state_size * (input_size + state_size) + 2 * g * state_size


def rnn_param_size(mode, num_layers, input_size, state_size,
                   bidirectional=False):
    """Length of the flat parameter vector (reference: rnn-inl.h
    GetParamSize)."""
    d = 2 if bidirectional else 1
    return sum(d * _layer_param_size(
        mode, input_size if layer == 0 else state_size * d, state_size)
        for layer in range(num_layers))


def _rnn_inputs(attrs):
    ins = ["data", "parameters", "state"]
    if attrs.get("mode", "lstm") == "lstm":
        ins.append("state_cell")
    return ins


def _rnn_num_outputs(attrs):
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


def _rnn_infer(attrs, shapes):
    data = shapes.get("data")
    if data is not None:
        _, n, c = data
        mode = attrs.get("mode", "lstm")
        nl = int(attrs.get("num_layers", 1))
        h = int(attrs["state_size"])
        bi = bool(attrs.get("bidirectional", False))
        d = 2 if bi else 1
        shapes.setdefault("parameters", (rnn_param_size(mode, nl, c, h, bi),))
        shapes.setdefault("state", (nl * d, n, h))
        if mode == "lstm":
            shapes.setdefault("state_cell", (nl * d, n, h))
    return shapes


def _layer_weights(params, mode, in_sz, h, d):
    """Views ``[W_ih, W_hh, b_ih, b_hh]`` of each direction's block, in the
    order of ``params`` (one layer's slice of the flat vector)."""
    g = _GATES[mode]
    out, off = [], 0
    for _ in range(d):
        for shape in ((g * h, in_sz), (g * h, h), (g * h,), (g * h,)):
            size = int(np.prod(shape))
            out.append(params[off:off + size].view(shape))
            off += size
    return out


def _cell_step(mode, x, hprev, cprev, w_ih, w_hh, b_ih, b_hh):
    """One time step (reference: rnn_op.py ``cell_step``)."""
    if mode == "gru":
        xr, xz, xn = F.linear(x, w_ih, b_ih).chunk(3, -1)
        hr, hz, hn = F.linear(hprev, w_hh, b_hh).chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        return (1 - z) * torch.tanh(xn + r * hn) + z * hprev, cprev
    gates = F.linear(x, w_ih, b_ih) + F.linear(hprev, w_hh, b_hh)
    if mode == "lstm":
        i, f, c, o = gates.chunk(4, -1)
        c_new = torch.sigmoid(f) * cprev + torch.sigmoid(i) * torch.tanh(c)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    act = torch.tanh if mode == "rnn_tanh" else torch.relu
    return act(gates), cprev


def _plain_layers(mode, x, weights, h0, c0, nl, d):
    """The reference's loop over ``nl`` layers and ``d`` directions;
    ``weights`` holds each layer's views. Returns (output, h_n, c_n)."""
    hs, cs = [], []
    for layer in range(nl):
        outs = []
        for k in range(d):
            w = weights[layer][4 * k:4 * k + 4]
            h, c = h0[layer * d + k], c0[layer * d + k]
            seq = [None] * x.shape[0]
            steps = range(x.shape[0] - 1, -1, -1) if k else range(x.shape[0])
            for t in steps:
                h, c = _cell_step(mode, x[t], h, c, *w)
                seq[t] = h
            outs.append(torch.stack(seq))
            hs.append(h)
            cs.append(c)
        x = torch.cat(outs, -1) if d > 1 else outs[0]
    return x, torch.stack(hs), torch.stack(cs)


def _cudnn_layout(mode, device, in_sz, h, nl, bi, n_params):
    """How cuDNN lays out the weights of this configuration: None where its
    buffer is the op's flat vector as it is, else the index that gathers
    the buffer from the vector (``n_params`` where cuDNN pads). Found by
    passing a probe vector 1, 2, 3, ... through
    ``torch._cudnn_rnn_flatten_weight``, once per configuration."""
    key = (mode, device, in_sz, h, nl, bi)
    if key not in _LAYOUTS:
        d = 2 if bi else 1
        probe = torch.arange(1, n_params + 1, dtype=torch.float64
                             if n_params >= 2 ** 24 else torch.float32,
                             device=device)
        views, off = [], 0
        for layer in range(nl):
            lin = in_sz if layer == 0 else h * d
            size = d * _layer_param_size(mode, lin, h)
            views += _layer_weights(probe[off:off + size], mode, lin, h, d)
            off += size
        buf = torch._cudnn_rnn_flatten_weight(
            views, 4, in_sz, _CUDNN_MODE[mode], h, 0, nl, False, bi)
        idx = buf.to(torch.int64) - 1
        idx = torch.where(idx < 0, n_params, idx)
        same = idx.numel() == n_params and torch.equal(
            idx, torch.arange(n_params, device=device))
        _LAYOUTS[key] = None if same else idx
    return _LAYOUTS[key]


def _cudnn_layers(mode, x, params, weights, h0, c0, h, nl, bi, train):
    """cuDNN over ``nl`` layers whose flat block is ``params``; ``weights``
    are views of it. Returns (output, h_n, c_n)."""
    global cudnn_calls, weight_gathers
    idx = _cudnn_layout(mode, params.device, x.shape[-1], h, nl, bi,
                        params.numel())
    buf = params.detach()
    if idx is not None:
        buf = torch.cat([buf, buf.new_zeros(1)])[idx]
        weight_gathers += 1
    out = torch._cudnn_rnn(
        x.contiguous(), weights, 4, buf, h0.contiguous(),
        c0.contiguous() if c0 is not None else None, _CUDNN_MODE[mode], h,
        0, nl, False, 0.0, train, bi, [], None)
    cudnn_calls += 1
    return out[0], out[1], out[2]


def rnn_forward(ctx, attrs, data, parameters, state, state_cell=None,
                plain=None):
    """The RNN op's body. ``plain`` picks the route: None takes cuDNN for
    CUDA tensors and the step loop otherwise; True takes the step loop on
    any device."""
    mode = attrs.get("mode", "lstm")
    nl = int(attrs.get("num_layers", 1))
    h = int(attrs["state_size"])
    bi = bool(attrs.get("bidirectional", False))
    p_drop = float(attrs.get("p", 0.0))
    d = 2 if bi else 1
    t, n, c = data.shape
    if mode not in _GATES:
        raise MXNetError(f"RNN: unknown mode {mode!r}")
    if data.device.type == "meta":
        out = torch.empty((t, n, d * h), dtype=data.dtype, device="meta")
        hn = torch.empty((nl * d, n, h), dtype=data.dtype, device="meta")
        outs = [out, hn, hn]
    else:
        outs = _run_layers(ctx, mode, nl, h, d, p_drop, data, parameters,
                           state, state_cell if mode == "lstm" else None,
                           data.device.type != "cuda" if plain is None
                           else plain)
    if not attrs.get("state_outputs", False):
        return outs[0]
    return tuple(outs[:3 if mode == "lstm" else 2])


def _run_layers(ctx, mode, nl, h, d, p_drop, data, parameters, state,
                state_cell, plain):
    """(output, h_n, c_n) of the stack: all layers in one run, or with
    dropout in training one run a layer with the mask between them."""
    bounds, off = [0], 0   # each layer's block of the flat vector
    in_sizes = [data.shape[-1]] + [h * d] * (nl - 1)
    for in_sz in in_sizes:
        off += d * _layer_param_size(mode, in_sz, h)
        bounds.append(off)
    weights = [_layer_weights(parameters[bounds[k]:bounds[k + 1]], mode,
                              in_sizes[k], h, d) for k in range(nl)]
    drop = p_drop > 0 and ctx.is_train
    train = torch.is_grad_enabled() and not torch.is_inference_mode_enabled()
    c0 = state_cell if state_cell is not None else torch.zeros_like(state)
    runs = [(k, k + 1) for k in range(nl)] if drop else [(0, nl)]
    x, hs, cs = data, [], []
    for lo, hi in runs:
        h0, c0_ = state[lo * d:hi * d], c0[lo * d:hi * d]
        if plain:
            x, hn, cn = _plain_layers(mode, x, weights[lo:hi], h0, c0_,
                                      hi - lo, d)
        else:
            x, hn, cn = _cudnn_layers(
                mode, x, parameters[bounds[lo]:bounds[hi]],
                [w for ws in weights[lo:hi] for w in ws], h0,
                c0_ if state_cell is not None else None, h, hi - lo, d == 2,
                train)
        hs.append(hn)
        cs.append(cn)
        if drop and hi < nl:
            x = dropout_apply(ctx, x, p_drop)
    return [x, torch.cat(hs), torch.cat(cs)]


@register_op("RNN", inputs=_rnn_inputs, num_outputs=_rnn_num_outputs,
             infer_param_shapes=_rnn_infer)
def _rnn(ctx, attrs, data, parameters, state, state_cell=None):
    """The fused recurrence: cuDNN on the card, the reference's step loop on
    the CPU (module docstring)."""
    return rnn_forward(ctx, attrs, data, parameters, state, state_cell)
