"""Symbol: the symbolic graph layer (reference: mxnet_tpu/symbol.py).

A Symbol is a list of (node, output_index) heads over a DAG of ``_Node``s,
as in the reference. Shape inference runs each op body on ``meta`` tensors
(shape and dtype, no data) where the reference uses abstract evaluation;
backward inference of *parameter* shapes uses the per-op
``infer_param_shapes`` rules. The JSON format is the reference's
(``mxnet_tpu_v1``), so a graph written by either package loads in the other.
"""
from __future__ import annotations

import json

import numpy as np

from .attribute import AttrScope
from .base import MXNetError
from .name import NameManager
from .ops import get_op, list_ops
from .ops.registry import OpCtx, coerce_attrs

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]

_FORMAT = "mxnet_tpu_v1"


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "aux_vars")
    """Graph node. ``op`` is a registered op name, or None for a variable.
    ``inputs`` is a list of (node, out_index); ``aux_vars`` a list of variable
    nodes holding mutable auxiliary state."""

    def __init__(self, op, name, attrs=None, inputs=None, aux_vars=None):
        self.op = op
        self.name = name
        self.attrs = attrs or {}
        self.inputs = inputs or []
        self.aux_vars = aux_vars or []

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        if self.is_variable:
            return 1
        return get_op(self.op).num_outputs(self.attrs)


def _topo_order(heads):
    """Iterative post-order DFS (deep graphs exceed recursion limits)."""
    seen = set()
    order = []
    stack = [(n, False) for n, _ in reversed(heads)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        children = [n for n, _ in node.inputs] + list(node.aux_vars)
        for child in reversed(children):
            if id(child) not in seen:
                stack.append((child, False))
    return order


def _is_aux(node):
    return node.attrs.get("__aux__", False)


class Symbol:
    __slots__ = ("_heads",)

    def __init__(self, heads):
        self._heads = list(heads)

    @property
    def name(self):
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def __repr__(self):
        return f"<Symbol {self.name or 'grouped'}>"

    def __iter__(self):
        return (self[i] for i in range(len(self.list_outputs())))

    def __getitem__(self, index):
        """One output, by position or by its name in ``list_outputs``."""
        if isinstance(index, str):
            outputs = self.list_outputs()
            if index not in outputs:
                raise MXNetError(f"no output named {index!r} in {outputs}")
            index = outputs.index(index)
        return Symbol([self._entries()[index]])

    def _entries(self):
        """Flatten heads into (node, out_idx) output entries."""
        entries = []
        for node, idx in self._heads:
            if idx is None:
                for i in range(node.num_outputs()):
                    entries.append((node, i))
            else:
                entries.append((node, idx))
        return entries

    # -- graph queries -------------------------------------------------------
    def _nodes(self):
        return _topo_order(self._entries())

    def list_arguments(self):
        return [n.name for n in self._nodes() if n.is_variable and not _is_aux(n)]

    def list_outputs(self):
        out = []
        for node, idx in self._entries():
            if node.is_variable:
                out.append(node.name)
            elif node.num_outputs() == 1:
                out.append(f"{node.name}_output")
            else:
                out.append(f"{node.name}_output{idx}")
        return out

    def list_auxiliary_states(self):
        return [n.name for n in self._nodes() if n.is_variable and _is_aux(n)]

    def get_internals(self):
        """Every node's outputs as one grouped Symbol, named as in
        :meth:`list_outputs` (``<node>_output``), in topological order
        (reference: symbol.py ``get_internals``)."""
        return Symbol([(n, i) for n in self._nodes()
                       for i in range(n.num_outputs())])

    def get_children(self):
        """The inputs of the heads' nodes as one grouped Symbol, None for a
        variable (reference: symbol.py ``get_children``)."""
        kids = [e for node, _ in self._entries() for e in node.inputs]
        return Symbol(kids) if kids else None

    # -- attributes ----------------------------------------------------------
    def attr(self, key):
        """Attribute ``key`` of the head's node (None if unset, or if the
        Symbol has several heads)."""
        if len(self._heads) == 1:
            return self._heads[0][0].attrs.get(key)
        return None

    def list_attr(self):
        """The head's node's attributes as strings ({} for several
        heads)."""
        if len(self._heads) == 1:
            return {k: str(v) for k, v in self._heads[0][0].attrs.items()}
        return {}

    def attr_dict(self):
        """Every node's attributes as strings, by node name; the optimizer
        reads ``__lr_mult__``/``__wd_mult__`` here."""
        return {n.name: {k: str(v) for k, v in n.attrs.items()}
                for n in self._nodes() if n.attrs}

    # -- composition (the reference's op names, symbol.py:177-212) -----------
    def _binop(self, other, op_ew, op_scalar):
        if isinstance(other, Symbol):
            return _create(op_ew, self, other)
        return _create(op_scalar, self, scalar=float(other))

    def __add__(self, other):
        return self._binop(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _create("_rminus_scalar", self, scalar=float(other))

    def __mul__(self, other):
        return self._binop(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _create("_rdiv_scalar", self, scalar=float(other))

    def __pow__(self, other):
        return self._binop(other, "_power", "_power_scalar")

    def __neg__(self):
        return _create("_mul_scalar", self, scalar=-1.0)

    # -- inference -----------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """Infer shapes from known argument shapes.

        Returns (arg_shapes, out_shapes, aux_shapes) in declaration order;
        unknown results are None (reference: symbol.py infer_shape).
        """
        arg_names = self.list_arguments()
        known = {}
        if args:
            if len(args) > len(arg_names):
                raise MXNetError("too many positional shapes")
            known.update({n: tuple(s) for n, s in zip(arg_names, args) if s})
        for k, v in kwargs.items():
            if v is not None:
                known[k] = tuple(v)
        return self._infer(known)[:3]

    def infer_type(self, **kwargs):
        """Infer dtypes from argument dtypes given by name (reference:
        symbol.py infer_type): (arg_types, out_types, aux_types) as numpy
        dtypes, or the string "bfloat16"; None where a shape is unknown."""
        return self._infer({}, dtype_hints=kwargs)[3:]

    def _infer(self, known, dtype_hints=None):
        import torch

        from .ndarray import _dtype_name, _torch_dtype

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        vals: dict[int, list] = {}   # id(node) -> [meta tensor | None]
        # MXNet partial shapes: a 0 in a declared variable shape (the RNN
        # cells' begin states) takes the batch, ``__batch_size__`` when the
        # caller knows it (time-major data), else the first known shape's
        # leading dim
        known = dict(known)
        default_batch = known.pop("__batch_size__", (None,))[0]
        if default_batch is None:
            default_batch = next(
                (s[0] for s in known.values() if s and s[0]), None)
        nodes = self._nodes()
        for node in nodes:
            if node.is_variable:
                shp = known.get(node.name)
                if shp is None and "__shape__" in node.attrs:
                    shp = tuple(node.attrs["__shape__"])
                    if 0 in shp and default_batch is not None:
                        shp = tuple(default_batch if d == 0 else d
                                    for d in shp)
                    if 0 in shp:
                        shp = None
                dt = _torch_dtype((dtype_hints or {}).get(node.name)
                                  or node.attrs.get("__dtype__"))
                vals[id(node)] = [meta(shp, dt) if shp is not None else None]
                continue
            op = get_op(node.op)
            attrs = node.attrs
            in_names = op.input_names(attrs)
            aux_names = op.aux_names(attrs)
            ins = [vals[id(n)][i] for n, i in node.inputs]
            if (any(s is None for s in ins) or node.aux_vars) \
                    and op.infer_param_shapes is not None:
                shape_map = {nm: tuple(s.shape)
                             for nm, s in zip(in_names, ins) if s is not None}
                shape_map = op.infer_param_shapes(dict(attrs), shape_map)
                for j, ((inode, _), nm) in enumerate(zip(node.inputs,
                                                         in_names)):
                    if ins[j] is None and shape_map.get(nm) is not None:
                        ins[j] = meta(tuple(shape_map[nm]), torch.float32)
                        if inode.is_variable:
                            vals[id(inode)] = [ins[j]]
                for av, anm in zip(node.aux_vars, aux_names):
                    if vals.get(id(av), [None])[0] is None \
                            and shape_map.get(anm):
                        vals[id(av)] = [meta(tuple(shape_map[anm]),
                                             torch.float32)]
            aux = [vals.get(id(av), [None])[0] for av in node.aux_vars]
            if any(s is None for s in ins) or any(s is None for s in aux):
                vals[id(node)] = [None] * node.num_outputs()
                continue
            try:
                outs, _ = op.normalized_call(
                    OpCtx(device=torch.device("meta")), attrs, ins, aux)
            except Exception as e:
                raise MXNetError(
                    f"shape inference failed for op {op.name} with shapes "
                    f"{[tuple(s.shape) for s in ins]}: {e}") from e
            vals[id(node)] = list(outs)

        def shape_of(node, idx=0):
            t = vals[id(node)][idx]
            return None if t is None else tuple(t.shape)

        def type_of(node, idx=0):
            t = vals[id(node)][idx]
            if t is None:
                return None
            name = _dtype_name(t.dtype)
            return name if name == "bfloat16" else np.dtype(name)

        by_name = {n.name: n for n in nodes if n.is_variable}
        args = [by_name[n] for n in self.list_arguments()]
        auxs = [by_name[n] for n in self.list_auxiliary_states()]
        entries = self._entries()
        return ([shape_of(n) for n in args], [shape_of(*e) for e in entries],
                [shape_of(n) for n in auxs], [type_of(n) for n in args],
                [type_of(*e) for e in entries], [type_of(n) for n in auxs])

    # -- serialization -------------------------------------------------------
    def tojson(self):
        nodes = self._nodes()
        idx = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": n.op or "null",
                "name": n.name,
                "attrs": {k: _attr_str(v) for k, v in n.attrs.items()},
                "inputs": [[idx[id(i)], o] for i, o in n.inputs],
                "aux_inputs": [idx[id(a)] for a in n.aux_vars],
            })
        heads = [[idx[id(n)], (o if o is not None else 0)]
                 for n, o in self._entries()]
        return json.dumps({"format": _FORMAT, "nodes": jnodes,
                           "heads": heads}, indent=2)

    def save(self, fname):
        """Write :meth:`tojson` to ``fname`` (either package loads it)."""
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- execution -----------------------------------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind an executor (reference: symbol.py bind). ``args_grad``
        (dict or list of NDArrays) receives the gradients under
        ``grad_req`` (write, add or null; one string, a list or a dict)."""
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    amp_dtype=None, **kwargs):
        """Allocate zeroed argument, gradient and aux arrays from the shapes
        inferred from ``kwargs``, then bind (reference: symbol.py
        simple_bind). ``type_dict`` names the dtype of an argument; with
        ``grad_req`` a dict, only the arguments it asks gradients of get a
        grad array. ``amp_dtype`` is the Executor's."""
        from . import ndarray as nd
        from .executor import Executor

        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        names = self.list_arguments()
        if any(s is None for s in arg_shapes):
            missing = [n for n, s in zip(names, arg_shapes) if s is None]
            raise MXNetError(f"simple_bind: cannot infer shapes for {missing}")
        type_dict = type_dict or {}
        args = [nd.zeros(s, ctx, dtype=type_dict.get(n))
                for n, s in zip(names, arg_shapes)]
        if isinstance(grad_req, dict):
            args_grad = {n: nd.zeros(s, ctx)
                         for n, s in zip(names, arg_shapes)
                         if grad_req.get(n, "null") != "null"}
        else:
            args_grad = None if grad_req == "null" else [
                nd.zeros(s, ctx) for s in arg_shapes]
        aux_states = [nd.zeros(s, ctx) for s in aux_shapes]
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        amp_dtype=amp_dtype)

    def eval(self, ctx=None, **kwargs):
        """Bind the named arrays and run one inference forward (reference:
        symbol.py ``eval``); returns the output NDArrays."""
        from .context import current_context

        return self.bind(ctx or current_context(), kwargs).forward()


def _attr_str(v):
    if isinstance(v, (tuple, list)):
        return str(tuple(v))
    return str(v)


# ---------------------------------------------------------------------------
# symbol construction


def Variable(name, attr=None, shape=None, dtype=None, **kwargs):
    """Create a free variable (reference: symbol.py Variable)."""
    if not isinstance(name, str):
        raise TypeError("Variable name must be a string")
    attrs = dict(AttrScope.current().get(attr))
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype
    attrs.update(kwargs)
    return Symbol([(_Node(None, name, attrs), 0)])


var = Variable


def Group(symbols):
    """One symbol whose outputs are those of ``symbols``, in order
    (reference: symbol.py ``Group``)."""
    heads = []
    for s in symbols:
        heads.extend(s._entries())
    return Symbol(heads)


def _create(op_name, *args, name=None, attr=None, **kwargs):
    """Create an op node (reference: symbol.py _create)."""
    op = get_op(op_name)
    sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
    attrs = coerce_attrs({k: v for k, v in kwargs.items()
                          if not isinstance(v, Symbol)})
    for k, v in op.attr_defaults.items():
        attrs.setdefault(k, v)
    # variable-arity ops (Concat) count their inputs
    probe = op.input_names(attrs)
    if probe and probe[0] == "arg0" and "num_args" not in attrs:
        attrs["num_args"] = len(args) + len(sym_kwargs)
    name = NameManager.current().get(name, op.name.lower().lstrip("_"))
    node_attrs = dict(attrs)
    for k, v in AttrScope.current().get(attr).items():
        node_attrs.setdefault(k, v)

    in_names = op.input_names(node_attrs)
    entries = []
    for a in args:
        if not isinstance(a, Symbol):
            raise TypeError(f"{op_name}: positional inputs must be Symbols, "
                            f"got {type(a)}")
        es = a._entries()
        if len(es) != 1:
            raise MXNetError(f"{op_name}: cannot use a grouped symbol as "
                             "one input")
        entries.append(es[0])
    by_name = dict(zip(in_names, entries))
    for k, v in sym_kwargs.items():
        if k not in in_names:
            raise MXNetError(f"{op_name}: unknown input '{k}' (expects "
                             f"{in_names})")
        if k in by_name:
            raise MXNetError(f"{op_name}: input '{k}' given twice")
        es = v._entries()
        if len(es) != 1:
            raise MXNetError(f"{op_name}: cannot use a grouped symbol as "
                             "one input")
        by_name[k] = es[0]
    inputs = []
    for nm in in_names:
        if nm in by_name:
            inputs.append(by_name[nm])
        else:
            # auto-create missing parameter variables, e.g. fc1_weight
            inputs.append((_Node(None, f"{name}_{nm}",
                                 dict(AttrScope.current().get(None))), 0))
    aux_vars = [_Node(None, f"{name}_{anm}", {"__aux__": True})
                for anm in op.aux_names(node_attrs)]
    node = _Node(op.name, name, node_attrs, inputs, aux_vars)
    n_out = node.num_outputs()
    return Symbol([(node, i) for i in range(n_out)])


def load_json(json_str: str) -> Symbol:
    data = json.loads(json_str)
    if data.get("format") != _FORMAT:
        raise MXNetError("unsupported symbol JSON format "
                         f"{data.get('format')!r}")
    nodes = []
    for jn in data["nodes"]:
        attrs = coerce_attrs(jn.get("attrs", {}))
        node = _Node(None if jn["op"] == "null" else jn["op"], jn["name"],
                     attrs)
        node.inputs = [(nodes[i], o) for i, o in jn["inputs"]]
        node.aux_vars = [nodes[i] for i in jn.get("aux_inputs", [])]
        nodes.append(node)
    return Symbol([(nodes[i], o) for i, o in data["heads"]])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def _init_symbol_module():
    g = globals()
    for opname in list_ops():
        if opname in g:
            continue

        def _fn(*args, _op_name=opname, **kw):
            return _create(_op_name, *args, **kw)

        _fn.__name__ = opname
        _fn.__doc__ = f"Symbolic creator for operator '{opname}'."
        g[opname] = _fn


_init_symbol_module()
