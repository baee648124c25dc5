"""Executor: binds a Symbol to a device, evaluates it and differentiates it
(reference: mxnet_tpu/executor.py).

The reference lowers the whole graph to one jitted XLA program per entry
point. PyTorch runs eagerly, so ``forward`` walks the graph in topological
order and calls each op body on the bound tensors; the op bodies launch
their kernels on the current CUDA stream. The reference's graph rewrites at
bind (graphopt) do not change fp32 math and are not ported.

- ``forward(is_train=False)`` is the reference's jitted forward: the walk
  under ``torch.inference_mode()`` (:meth:`Executor.eager_forward`), run by
  a :class:`~mxnet_tpu_torch.module.step_graph.ForwardProgram`, which on the
  card captures it as one CUDA graph a binding (its second forward) and
  replays it; each forward's outputs are new tensors.
- ``forward(is_train=True)`` with gradients bound is the reference's fused
  forward+backward (:meth:`Executor._fwd_bwd`, a body over given tensors
  that writes no bound array, so a module's one-program step can close
  over it): the walk runs under autograd, each differentiable argument
  entering as a fresh leaf (so the optimizer's later updates of the bound
  arrays record no graph), and backward runs at once with head gradients of
  ones, which the loss ops ignore. The gradients wait for ``backward()``,
  which writes them into the bound grad arrays in place under ``grad_req``
  (write, add or null); after a fused step that returned none
  (:data:`GRADS_ELIDED`) it writes nothing.
- ``backward(out_grads)`` runs the observed forward again with the given head
  gradients: on the arguments bound now, the aux inputs of that forward and
  its random numbers.
- Random numbers (Dropout's masks, the RNN op's, ``_sample_*``): in every
  walk, training or evaluation, each node draws from its own generator, seeded on the host
  from the step's seed (the next of :func:`mxnet_tpu_torch.random.
  step_seed`'s stream) and the node's index in the topological order
  (:class:`NodeRandom`; the reference's ``fold_in(key, node_index)``). A
  node's numbers do not depend on how many numbers the nodes walked before
  it drew, and nothing is read back from the device.
- ``copy_params_from`` writes into the bound arrays in place.

``amp_dtype`` (e.g. ``"bfloat16"``) is the reference's mixed precision: the
bound fp32 arrays stay fp32 master copies, and each ``forward`` casts them
to the compute dtype as they enter the graph walk (:func:`_amp_cast`); the
cast's backward brings their gradients back in fp32.
"""
from __future__ import annotations

import threading

import numpy as np

from .base import MXNetError
from .ndarray import _torch_dtype
from .ops import OpCtx, get_op

__all__ = ["Executor", "GRADS_ELIDED"]

# a fused training step ran and returned no gradients (no reader declared,
# see Module's step): backward() writes nothing, get_grads raises
GRADS_ELIDED = object()


def _amp_cast(name, v, amp_dtype):
    """The reference's argument cast under mixed precision
    (mxnet_tpu/executor.py ``_amp_cast``): labels pass through; uint8
    (raw image pixels) goes to the compute dtype, float32 without amp;
    without amp nothing else changes; float32 goes to ``amp_dtype``; every
    other dtype (int32 token ids among them) passes through."""
    import torch

    if name.endswith("label"):
        return v
    if v.dtype == torch.uint8:
        return v.to(amp_dtype or torch.float32)
    if amp_dtype is None:
        return v
    if v.dtype == torch.float32:
        return v.to(amp_dtype)
    return v


# the dtypes jax.numpy makes of numpy's 64-bit ones (64-bit mode off)
_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _as_tensor(v):
    """A fed array as a tensor: an NDArray's own, else a CPU tensor over
    ``np.asarray(v)`` with 64-bit types narrowed as jax.numpy does."""
    import torch

    from .ndarray import NDArray

    if isinstance(v, NDArray):
        return v.data
    a = np.asarray(v)
    a = a.astype(_CANONICAL.get(a.dtype, a.dtype), copy=False)
    return torch.from_numpy(np.ascontiguousarray(a))


def _fed_tensor(v, device):
    """A fed array (see :func:`_as_tensor`) as a tensor on ``device``, with
    its own dtype and shape (never a numpy array's memory)."""
    from .ndarray import NDArray

    return _as_tensor(v).to(device, copy=not isinstance(v, NDArray))


def _feed(holder, v, device):
    """Feed ``v`` into the bound NDArray ``holder``: copied into its tensor
    where shape and dtype agree (a captured forward keeps reading the same
    memory), else ``holder`` is rebound to :func:`_fed_tensor` of it."""
    src = _as_tensor(v)
    t = holder.data
    if src.shape == t.shape and src.dtype == t.dtype:
        t.copy_(src)
    else:
        holder._data = _fed_tensor(v, device)


class NodeRandom:
    """The random source of training walks on ``device``: :meth:`node`
    gives node ``i`` its generator, made on first use and seeded from the
    walk's seed and ``i``. :meth:`begin` starts a walk: it takes a seed
    (default: the next of the host's step-seed stream) and re-seeds on the
    host every generator made so far, so the same object replays the same
    numbers, and a captured step that registered these generators draws a
    replay's numbers from the seed set before it."""

    def __init__(self, device):
        self.device = device
        self.seed = None
        self._gens = {}

    def begin(self, seed=None):
        from . import random as _random

        self.seed = _random.step_seed() if seed is None else seed
        for index, gen in self._gens.items():
            gen.manual_seed(_random.mix(self.seed, index))

    def node(self, index):
        import torch

        from . import random as _random

        gen = self._gens.get(index)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_random.mix(self.seed, index))
            self._gens[index] = gen
        return gen

    @property
    def generators(self):
        """The generators made so far, by node index."""
        return dict(self._gens)


def _write_into(holder, value):
    """``value`` into the bound NDArray ``holder``: in place where shape and
    dtype agree (a captured step keeps reading the same memory), else
    ``holder`` is rebound to it."""
    t = holder.data
    if t.shape == value.shape and t.dtype == value.dtype \
            and t.device == value.device:
        t.copy_(value)
    else:
        holder._data = value


def _normalize(arrays, names, what, allow_missing=False):
    """``arrays`` (a dict by name, or a list in ``names``' order, None for
    none) as a dict by name."""
    if isinstance(arrays, dict):
        missing = [n for n in names if n not in arrays]
        if missing and not allow_missing:
            raise MXNetError(f"{what}: missing arrays for {missing}")
        return {n: arrays[n] for n in names if n in arrays}
    arrays = list(arrays)
    if not allow_missing and len(arrays) != len(names):
        raise MXNetError(f"{what}: expected {len(names)} arrays "
                         f"({names}), got {len(arrays)}")
    return {n: a for n, a in zip(names, arrays) if a is not None}


class Executor:
    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, amp_dtype=None):
        self._symbol = symbol
        self._ctx = ctx
        self._amp_dtype = None if amp_dtype is None \
            else _torch_dtype(amp_dtype)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = _normalize(args, self.arg_names, "args")
        self.grad_dict = {} if args_grad is None else _normalize(
            args_grad, self.arg_names, "args_grad", allow_missing=True)
        self.aux_dict = _normalize(aux_states or [], self.aux_names,
                                   "aux_states")
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self.grad_req = {n: grad_req.get(n, "null")
                             for n in self.arg_names}
        # a request on an argument with no grad array is null
        for n in self.arg_names:
            if n not in self.grad_dict:
                self.grad_req[n] = "null"
        self._diff_args = [n for n in self.arg_names
                           if self.grad_req[n] != "null"]
        self._entries = symbol._entries()
        self._topo = symbol._nodes()
        self.outputs: list = []
        self._pending_grads = None
        self._last_aux = None        # aux inputs of the last train forward
        self._last_rng = None        # its NodeRandom
        self._grads_were_elided = False
        self.walking = None          # the node the last walk reached
        self._eval_program = None    # the evaluation forward's program
        # one evaluation forward (or warm-up) of this binding at a time: a
        # server's prewarm thread may warm a bucket traffic also reaches
        self._eval_lock = threading.Lock()
        self._warmed = False

    def _walk(self, op_ctx, arg_vals, aux_vals):
        """Evaluate the graph on ``arg_vals``/``aux_vals`` (dicts of tensors
        by name); returns (output tensors, new aux tensors by name). An op's
        aux update is seen by every later reader in the same walk."""
        outs, new_aux = self._walk_replicas([op_ctx], [arg_vals], [aux_vals])
        return outs[0], new_aux[0]

    def _walk_replicas(self, op_ctxs, arg_vals, aux_vals):
        """:meth:`_walk` for the replicas of a data-parallel group (executors
        of this graph, each on its own device and slice of the batch) in
        lockstep: a node runs for every replica before the next node, and an
        op with a replica body (``OpDef.replica_fn``: BatchNorm) runs once
        over all of them. One list entry a replica in, and in each result."""
        count = len(op_ctxs)
        vals = [{} for _ in range(count)]
        new_aux = [dict(a) for a in aux_vals]
        self.walking = None
        for index, node in enumerate(self._topo):
            key = (id(node), 0)
            if node.is_variable:
                for r in range(count):
                    if node.name in arg_vals[r]:
                        vals[r][key] = _amp_cast(
                            node.name, arg_vals[r][node.name], self._amp_dtype)
                    elif node.name in aux_vals[r]:
                        vals[r][key] = aux_vals[r][node.name]
                    else:
                        raise MXNetError(f"unbound variable '{node.name}'")
                continue
            op = get_op(node.op)
            self.walking = node
            ins = [[v[(id(n), i)] for n, i in node.inputs] for v in vals]
            aux = [[v[(id(a), 0)] for a in node.aux_vars] for v in vals]
            for op_ctx in op_ctxs:
                op_ctx.node = index
            if count > 1 and op.replica_fn is not None:
                results = op.replica_fn(op_ctxs, node.attrs, ins, aux)
            else:
                results = [op.normalized_call(c, node.attrs, i, a)
                           for c, i, a in zip(op_ctxs, ins, aux)]
            for v, na, (outs, aux_out) in zip(vals, new_aux, results):
                for i, o in enumerate(outs):
                    v[(id(node), i)] = o
                for a_node, a_new in zip(node.aux_vars, aux_out):
                    na[a_node.name] = a_new
                    v[(id(a_node), 0)] = a_new
        outs = [[v[(id(n), i)] for n, i in self._entries] for v in vals]
        return outs, new_aux

    def _fwd_bwd(self, args, aux_vals, rng, out_grads=None):
        """The training walk over ``args``/``aux_vals`` (tensors by name)
        under autograd, then its backward with ``out_grads`` (head gradients
        of ones if None); ``rng`` is the walk's :class:`NodeRandom`. Writes
        no bound array. Returns (outputs, new aux, gradients by
        differentiable argument)."""
        return fwd_bwd_replicas(
            [self], [args], [aux_vals], [rng],
            None if out_grads is None else [out_grads])[0]

    def forward(self, is_train=False, **kwargs):
        """Evaluate the graph; each of ``kwargs`` is fed into its bound
        argument first, as in the reference: the bound NDArray now holds the
        fed values, with the feed's dtype and shape, on the executor's
        device (copied in place where those agree, see :func:`_feed`).
        With ``is_train`` and gradients bound, also computes the gradients
        that :meth:`backward` writes. Returns the output NDArrays."""
        from .ndarray import NDArray

        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {k}")
            _feed(self.arg_dict[k], v, self._ctx.torch_device)
        self._pending_grads = None
        if not is_train:
            with self._eval_lock:
                outs = self._forward_program().run()
            self.outputs = [NDArray(o) for o in outs]
            return self.outputs
        train_replicas([self])
        return self.outputs

    def _forward_program(self):
        if self._eval_program is None:
            from .module.step_graph import ForwardProgram

            self._eval_program = ForwardProgram(self)
        return self._eval_program

    def warmup(self):
        """Build the evaluation forward's program on the bound inputs
        (reference: ``Executor.warmup``, the AOT compile trigger): on the
        card its warm-up and its capture (and the capture's replay), so
        the next ``forward(is_train=False)`` replays; on the CPU one eager
        forward. ``outputs`` and the last forward's bookkeeping are left
        alone, so a prewarm thread can warm a binding that traffic also
        uses. Returns the wall seconds, the device's work included."""
        import time

        import torch

        t0 = time.perf_counter()
        with self._eval_lock:
            prog = self._forward_program()
            prog.run()
            if prog.capturable and not prog.captured:
                prog.run()
            if prog.device.type == "cuda":
                torch.cuda.current_stream(prog.device).synchronize()
        self._warmed = True
        return time.perf_counter() - t0

    def eager_forward(self, rng=None):
        """The evaluation forward walked eagerly over the bound arrays (the
        function the captured graph replays); returns the output tensors
        and changes nothing bound. Random nodes draw from ``rng`` (a
        :class:`NodeRandom`; by default a new one on the next step seed),
        as the reference's forward folds its key into each node's index."""
        import torch

        if rng is None:
            rng = NodeRandom(self._ctx.torch_device)
            rng.begin()
        op_ctx = OpCtx(is_train=False, rng=rng,
                       device=self._ctx.torch_device)
        args = {n: a.data for n, a in self.arg_dict.items()}
        aux_vals = {n: a.data for n, a in self.aux_dict.items()}
        with torch.inference_mode():
            outs, _ = self._walk(op_ctx, args, aux_vals)
        return outs

    def forward_info(self):
        """The evaluation forward's program state (``ForwardProgram.info``:
        captured, the refusal, eager forwards, warm-ups, captures, replays,
        drops); None before the first evaluation forward."""
        prog = self._eval_program
        return None if prog is None else prog.info()

    def backward(self, out_grads=None):
        """Write the gradients into the bound grad arrays under grad_req
        (reference: Executor::Backward). With ``out_grads`` (one per output,
        NDArrays or tensors), the last train forward runs again with them
        as head gradients. After a fused step that returned no gradients
        (:data:`GRADS_ELIDED`) it writes nothing."""
        from .ndarray import NDArray

        if out_grads is not None:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            device = self._ctx.torch_device
            rerun_replicas([self], [[
                (g.data if isinstance(g, NDArray) else g).to(device)
                for g in out_grads]])
        if self._pending_grads is GRADS_ELIDED:
            self._pending_grads = None
            return
        if self._pending_grads is None:
            raise MXNetError("backward called before forward(is_train=True)")
        for name, g in self._pending_grads.items():
            holder = self.grad_dict[name]
            _write_into(holder, holder.data + g
                        if self.grad_req[name] == "add" else g)
        self._pending_grads = None
        self._grads_were_elided = False

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    @property
    def output_dict(self):
        return dict(zip(self.output_names, self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter arrays into the bound ones, in place, each
        keeping its dtype and device (reference: executor.py
        copy_params_from)."""
        for given, bound, what in ((arg_params, self.arg_dict, "arg"),
                                   (aux_params or {}, self.aux_dict, "aux")):
            for name, arr in given.items():
                if name in bound:
                    dst = bound[name]
                    if tuple(arr.shape) != dst.shape:
                        raise MXNetError(
                            f"copy_params_from: {name} has shape "
                            f"{tuple(arr.shape)}, bound {dst.shape}")
                    dst._check_writable("copy into")
                    dst.data.copy_(arr.data)
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {what} param {name}")


def _train_ctxs(execs, rngs):
    """The training walk's :class:`OpCtx` of each executor of ``execs``,
    sharing one :class:`~mxnet_tpu_torch.ops.registry.Replicas` when there
    are several."""
    from .ops.registry import Replicas

    replicas = Replicas(len(execs)) if len(execs) > 1 else None
    return [OpCtx(is_train=True, rng=rng, device=ex._ctx.torch_device,
                  replicas=replicas, replica=r)
            for r, (ex, rng) in enumerate(zip(execs, rngs))]


def fwd_bwd_replicas(execs, args, aux_vals, rngs, out_grads=None):
    """:meth:`Executor._fwd_bwd` over the replicas of a data-parallel group
    (executors of one graph, one a device and slice of the batch): their
    training walks in lockstep (:meth:`Executor._walk_replicas`, sharing a
    :class:`~mxnet_tpu_torch.ops.registry.Replicas`), then one backward
    through all of them, so a cross-replica op's gradient reaches every
    replica. One list entry a replica in; returns each replica's (outputs,
    new aux, gradients by differentiable argument)."""
    import torch

    ex0 = execs[0]
    args = [dict(a) for a in args]
    leaves = []   # (replica, argument name, leaf tensor)
    for r, a in enumerate(args):
        for n in ex0._diff_args:
            if a[n].is_floating_point():
                a[n] = a[n].detach().requires_grad_()
                leaves.append((r, n, a[n]))
    with torch.enable_grad():
        outs, new_aux = ex0._walk_replicas(_train_ctxs(execs, rngs), args,
                                           aux_vals)
    if out_grads is None:
        out_grads = [[torch.ones_like(o) for o in os_] for os_ in outs]
    heads = [(o, g) for os_, gs in zip(outs, out_grads)
             for o, g in zip(os_, gs) if o.requires_grad]
    got = torch.autograd.grad(
        [o for o, _ in heads], [t for _, _, t in leaves],
        [g for _, g in heads], allow_unused=True) if heads and leaves \
        else [None] * len(leaves)
    got = {(r, n): g for (r, n, _), g in zip(leaves, got)}
    result = []
    for r, a in enumerate(args):
        # an argument the outputs do not depend on (or an integer one) gets
        # zeros, as jax.vjp gives
        grads = {n: got[(r, n)] if got.get((r, n)) is not None
                 else torch.zeros_like(a[n]) for n in ex0._diff_args}
        result.append(([o.detach() for o in outs[r]],
                       {n: t.detach() for n, t in new_aux[r].items()},
                       grads))
    return result


def train_replicas(execs):
    """``forward(is_train=True)`` of each executor of ``execs`` (one, or the
    replicas of a data-parallel group): the walks in lockstep on the bound
    arrays, each replica drawing from its own :class:`NodeRandom` (the
    first on the next step seed, replica r on ``mix(seed, r)``); the new aux
    states installed, the outputs set and the gradients kept for
    ``backward()``."""
    import torch

    from . import random as _random
    from .ndarray import NDArray

    rngs = []
    for r, ex in enumerate(execs):
        rng = NodeRandom(ex._ctx.torch_device)
        rng.begin(None if r == 0 else _random.mix(rngs[0].seed, r))
        rngs.append(rng)
    aux_vals = [{n: a.data for n, a in ex.aux_dict.items()} for ex in execs]
    args = [{n: a.data for n, a in ex.arg_dict.items()} for ex in execs]
    for ex, aux, rng in zip(execs, aux_vals, rngs):
        # an explicit backward(out_grads) later re-runs the forward the
        # caller observed: the aux inputs before this forward's update, and
        # the random numbers it drew
        ex._pending_grads = None
        ex._last_aux = aux
        ex._last_rng = rng
    if execs[0]._diff_args:
        results = fwd_bwd_replicas(execs, args, aux_vals, rngs)
        for ex, (_, _, grads) in zip(execs, results):
            ex._pending_grads = grads
    else:
        with torch.no_grad():
            outs, new_aux = execs[0]._walk_replicas(
                _train_ctxs(execs, rngs), args, aux_vals)
        results = list(zip(outs, new_aux, [None] * len(execs)))
    for ex, (outs, new_aux, _) in zip(execs, results):
        for n in ex.aux_names:
            ex.aux_dict[n]._data = new_aux[n]
        ex.outputs = [NDArray(o) for o in outs]


def rerun_replicas(execs, out_grads):
    """``backward(out_grads)``'s re-run of the last training forward of each
    executor of ``execs`` with the given head gradients (one list a
    replica, on its device): the arguments bound now, that forward's aux
    inputs and random numbers; the gradients are kept for the write."""
    if any(ex._last_aux is None for ex in execs):
        raise MXNetError("backward(out_grads) called before "
                         "forward(is_train=True)")
    rngs = [ex._last_rng for ex in execs]
    for rng in rngs:
        rng.begin(rng.seed)
    results = fwd_bwd_replicas(
        execs, [{n: a.data for n, a in ex.arg_dict.items()} for ex in execs],
        [ex._last_aux for ex in execs], rngs, out_grads)
    for ex, (_, _, grads) in zip(execs, results):
        ex._pending_grads = grads
