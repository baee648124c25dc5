"""Operator registry: ops as functions over ``torch.Tensor``s with declared
metadata (reference: mxnet_tpu/ops/registry.py, the same contract).

An op is ``fn(ctx, attrs, *inputs) -> outputs``. Output shapes are not
declared per op: :mod:`mxnet_tpu_torch.symbol` runs the body on ``meta``
tensors, which carry shape and dtype and no data, where the reference runs
abstract evaluation. Only *parameter* shapes (weights inferred from the data
shape and attrs, e.g. FullyConnected's ``num_hidden``) need a per-op
``infer_param_shapes`` rule, because evaluation cannot run backward. Ops with
aux states return ``(outputs, new_aux)``.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..base import MXNetError

__all__ = ["OpCtx", "OpDef", "Replicas", "register_op", "register_replica_fn",
           "get_op", "list_ops", "coerce_attrs"]


class Replicas:
    """The replicas of one data-parallel training walk: ``count`` executors
    of one graph, each on its slice of the global batch, walked node by node
    together (``Executor._walk_replicas``). A loss op that normalises by
    the global count of valid labels records each replica's count during
    its forward (:meth:`put_count`); its backward, which runs once every
    forward has, reads their total."""

    def __init__(self, count):
        self.count = count
        self._counts = {}

    def put_count(self, ctx, count):
        """Record replica ``ctx.replica``'s ``count`` under its node; return
        the function of a device that sums every replica's count there (in
        replica order)."""
        parts = self._counts.setdefault(ctx.node, {})
        parts[ctx.replica] = count

        def total(device):
            out = parts[0].to(device)
            for r in range(1, self.count):
                out = out + parts[r].to(device)
            return out

        return total


@dataclass
class OpCtx:
    """Execution context threaded into op bodies.

    ``is_train`` mirrors the reference's ``ctx.is_train`` (OpContext,
    include/mxnet/operator.h:46); ``rng`` is an explicit ``torch.Generator``
    for ops that draw random numbers; ``mesh`` is the device mesh the
    enclosing program is partitioned over (None off mesh); ``device`` is the
    ``torch.device`` on which ops with no inputs create their result (None:
    the current context's). ``node`` is the walking node's index in the
    graph's topological order (a per-node ``rng`` seeds from it).
    ``replicas`` is the :class:`Replicas` of a data-parallel walk (None
    for one device) and ``replica`` this walk's index in it.
    """

    is_train: bool = False
    rng: object | None = None
    node: int = 0
    mesh: object | None = None
    device: object | None = None
    replicas: Replicas | None = None
    replica: int = 0

    @property
    def replica_count(self):
        """How many slices the global batch is split into (1 off a
        data-parallel walk)."""
        return 1 if self.replicas is None else self.replicas.count


@dataclass
class OpDef:
    name: str
    fn: Callable  # fn(ctx: OpCtx, attrs: dict, *inputs) -> out | tuple | (outs, new_aux)
    input_names: Callable[[dict], list[str]]
    aux_names: Callable[[dict], list[str]]
    num_outputs: Callable[[dict], int]
    infer_param_shapes: Callable | None = None  # (attrs, shapes: dict[str, tuple|None]) -> dict
    attr_defaults: dict = field(default_factory=dict)
    alias: Sequence[str] = ()
    # replica_fn(ctxs, attrs, inputs, aux) -> [(outs, new_aux)] a replica:
    # the op over every replica of a data-parallel walk at once, where its
    # result depends on the whole batch (BatchNorm's statistics)
    replica_fn: Callable | None = None

    def normalized_call(self, ctx, attrs, inputs, aux):
        """Run the body; always return (list_of_outputs, list_of_new_aux)."""
        out = self.fn(ctx, attrs, *inputs, *aux)
        n_aux = len(self.aux_names(attrs))
        if n_aux:
            outs, new_aux = out
            outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
            return outs, list(new_aux)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        return outs, []


_OPS: dict[str, OpDef] = {}


def _const(value):
    return lambda attrs: value


def register_op(
    name,
    inputs=("data",),
    aux=(),
    num_outputs=1,
    infer_param_shapes=None,
    attr_defaults=None,
    alias=(),
):
    """Decorator registering an op body.

    `inputs` / `aux` / `num_outputs` may be static values or callables of the
    attr dict (the reference's variable-arity ops, e.g. Concat's ``num_args``).
    """

    def _do(fn):
        op = OpDef(
            name=name,
            fn=fn,
            input_names=inputs if callable(inputs) else _const(list(inputs)),
            aux_names=aux if callable(aux) else _const(list(aux)),
            num_outputs=num_outputs if callable(num_outputs) else _const(num_outputs),
            infer_param_shapes=infer_param_shapes,
            attr_defaults=attr_defaults or {},
            alias=alias,
        )
        _OPS[name] = op
        for a in alias:
            _OPS[a] = op
        return fn

    return _do


def register_replica_fn(name):
    """Decorator: ``fn(ctxs, attrs, inputs, aux)`` runs op ``name`` over
    the replicas of a data-parallel walk together (lists a replica of
    :class:`OpCtx`s, inputs and aux), returning each replica's ``(outs,
    new_aux)``."""

    def _do(fn):
        get_op(name).replica_fn = fn
        return fn

    return _do


def get_op(name: str) -> OpDef:
    op = _OPS.get(name)
    if op is None:
        raise MXNetError(f"operator '{name}' is not registered")
    return op


def list_ops():
    return sorted(_OPS)


# -- attribute coercion -------------------------------------------------------
# Symbol JSON serializes attrs as strings (the reference's dmlc::Parameter
# parses them, e.g. fully_connected-inl.h:29-44); accept both native values and
# their string forms so graphs round-trip through JSON.

def coerce_attr(value):
    if not isinstance(value, str):
        return value
    low = value.strip()
    if low in ("True", "true"):
        return True
    if low in ("False", "false"):
        return False
    if low in ("None", ""):
        return None
    try:
        return ast.literal_eval(low)
    except (ValueError, SyntaxError):
        return value


def coerce_attrs(attrs: dict) -> dict:
    return {k: coerce_attr(v) for k, v in attrs.items()}
