"""The module's programs captured as CUDA graphs: the one-program training
step (reference: the fused step of mxnet_tpu/module/module.py,
``_maybe_build_fused_step`` :489 and ``_fused_forward`` :751) and the
evaluation forward (reference: the jitted forward of mxnet_tpu/executor.py,
``_jit_fwd`` :316-319).

:class:`StepProgram` is a function that runs forward, backward and the
optimizer's update over the arrays a module bound once: the bound inputs,
weights, aux states and optimizer states, and a device tensor of each
parameter's learning rate and weight decay. It writes the new aux states in
place; the new weights and states in place under donation, else into staged
copies that ``Module.update`` installs. :class:`ForwardProgram` is an
executor's evaluation forward over its bound arguments and aux states; each
run hands out copies of the graph's outputs (one device-to-device copy), so
outputs are new arrays every forward, as a jitted forward's are; an output
that is a bound argument's own tensor (the decode ops' caches, written in
place) is handed out as that tensor, so feeding it back with ``alias``
keeps the graph.

Both run as :class:`GraphProgram` says: on the card the first run of a
binding runs the function eagerly on a side stream (a real run: it lets
cuBLAS, cuDNN and the RNN op's layout probe set themselves up), the next one
captures it as one ``torch.cuda.CUDAGraph`` and replays it, and every later
run replays it. On the CPU, or where a rule refuses the capture, the same
function runs eagerly every time.

- The graph is valid for the tensors it was captured over. Each run checks
  that every bound array still holds the same tensor object; one that was
  rebound (a batch of another shape or dtype, a feed through
  ``forward(**kwargs)``, restored optimizer states) drops the graph, and the
  binding warms up and captures again.
- Random nodes draw from the program's :class:`~mxnet_tpu_torch.executor.
  NodeRandom`: its generators are registered with the graph and re-seeded on
  the host before each run from the host's step-seed stream, so a replay
  draws what the eager function draws for the same seed.
- The learning rates and weight decays go from pinned host memory to the
  device tensor the step's graph reads before each step.
- A capture that fails raises, naming the op whose body was running; it is
  never replaced by the eager function.
- The port's kernel wrappers count their launch calls in Python, so their
  counters see the warm-up and the capture (which records the launches and
  runs none) but no replay: the kernels a replay runs are read from a
  profiler trace of it.
- Every graph has a memory pool of its own: a bucket of a
  ``BucketingModule`` may replay in any order and its outputs and staged
  update stay valid until its own next step.
- No automatic Python collection runs while a capture is under way
  (:func:`~mxnet_tpu_torch.storage.no_collection`): a dropped binding's
  executor and program hold each other, so only a collection frees its
  graph, and a graph destroyed during a capture invalidates it.
- One capture at a time in the process (:data:`CAPTURE_LOCK`, also held
  over a program's first warm-up, which synchronises the device): a
  server's prewarm thread captures one bucket while the engine's workers
  replay others, and two captures at once would share the caching
  allocator's capture state.
- A capture runs on the thread of the program's last warm-up: cuBLAS and
  cuDNN make a handle a thread at its first call, which a capture may not
  do. A run on another thread warms up again there (an engine's pool runs
  a binding's forwards on any of its threads); replays run anywhere.
"""
from __future__ import annotations

import threading
import time

from ..base import MXNetError
from ..executor import NodeRandom
from ..storage import no_collection

__all__ = ["GraphProgram", "StepProgram", "ForwardProgram",
           "capture_refusal", "CAPTURE_LOCK"]

CAPTURE_LOCK = threading.RLock()


def capture_refusal(symbol):
    """Why a program over ``symbol``'s graph cannot be captured (None if it
    can), decided from its op list: a ``Custom`` node runs the user's host
    code, which the reference embeds through ``pure_callback``; a
    ``GenerateScan`` node captures and replays its own token step, and one
    capture cannot hold another."""
    for node in symbol._nodes():
        if node.op == "Custom":
            return (f"Custom node '{node.name}': its forward and backward "
                    "are user host code")
        if node.op == "GenerateScan":
            return (f"GenerateScan node '{node.name}': it captures and "
                    "replays its own token step")
    return None


class GraphProgram:
    """A function over an executor's bound arrays, run eagerly, warmed up,
    captured and replayed as the module docstring says. A subclass gives
    :meth:`_body` (the function) and may extend :meth:`_bindings` (the
    tensors the graph reads and writes: here the bound arguments and aux
    states) and :meth:`_where` (what the function was running when a
    capture failed); :attr:`WHAT` names the program in messages."""

    WHAT = "the program"

    def __init__(self, executor):
        self.ex = executor
        self.device = executor._ctx.torch_device
        self.rng = NodeRandom(self.device)
        self.refusal = capture_refusal(executor._symbol)
        self.capturable = self.device.type == "cuda" and self.refusal is None
        self._graph = None
        self._static = None
        self._bound = None        # the tensors the graph was captured over
        self._warm = None         # the tensors of the last warm-up
        self._warm_thread = None  # the thread of the last warm-up
        self._stream = None
        self.replayed = False     # the last run replayed the graph
        self.stats = {"eager_runs": 0, "warmups": 0, "captures": 0,
                      "replays": 0, "drops": 0, "warmup_ms": None,
                      "capture_ms": None}

    # -- state ------------------------------------------------------------------
    @property
    def captured(self):
        return self._graph is not None

    def info(self):
        """``captured``, the refusal's reason (None if none) and the
        counters of :attr:`stats` (``drops`` counts graphs dropped for a
        rebound array)."""
        reason = self.refusal
        if reason is None and self.device.type != "cuda":
            reason = f"the CPU runs {self.WHAT} eagerly"
        return {"captured": self.captured, "refusal": reason, **self.stats}

    def drop(self):
        """Forget the graph and its pool (a rebind, a new binding)."""
        self._graph = None
        self._static = None
        self._bound = None
        self._warm = None

    def _bindings(self):
        ex = self.ex
        return [ex.arg_dict[n].data for n in ex.arg_names] \
            + [ex.aux_dict[n].data for n in ex.aux_names]

    @staticmethod
    def _same(a, b):
        return b is not None and len(a) == len(b) \
            and all(x is y for x, y in zip(a, b))

    def _body(self):
        raise NotImplementedError

    def _where(self):
        node = self.ex.walking
        if node is None:
            return "the start of the graph walk"
        return f"{node.op} node '{node.name}', the last node walked"

    # -- running ----------------------------------------------------------------
    def run(self):
        """The body's result: eager, warm-up, capture and replay, or replay
        (the graph's static result)."""
        bound = self._bindings()
        self.rng.begin()
        self.replayed = False
        if not self.capturable:
            self.stats["eager_runs"] += 1
            return self._body()
        if self._graph is not None and not self._same(bound, self._bound):
            self.drop()
            self.stats["drops"] += 1
        if self._graph is None:
            here = threading.get_ident()
            if not self._same(bound, self._warm) \
                    or self._warm_thread != here:
                result = self._warmup(bound)
                self._warm_thread = here
                return result
            self._capture(bound)
        self._graph.replay()
        self.stats["replays"] += 1
        self.replayed = True
        return self._static

    def _side_stream(self):
        import torch

        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return self._stream

    def _warmup(self, bound):
        """The body on the side stream. The first warm-up is timed between
        two device syncs; a later one (a binding whose arrays are rebound
        at every run never captures) only orders the streams."""
        import torch

        first = self.stats["warmups"] == 0
        if not first:
            return self._warmup_body(bound)
        with CAPTURE_LOCK:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            result = self._warmup_body(bound)
            torch.cuda.synchronize(self.device)
            self.stats["warmup_ms"] = (time.perf_counter() - t0) * 1e3
        return result

    def _warmup_body(self, bound):
        import torch

        stream = self._side_stream()
        with torch.cuda.stream(stream):
            result = self._body()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.stats["warmups"] += 1
        self._warm = bound
        return result

    def _capture(self, bound):
        with CAPTURE_LOCK:
            self._capture_locked(bound)

    def _capture_locked(self, bound):
        import torch

        graph = torch.cuda.CUDAGraph()
        for gen in self.rng.generators.values():
            graph.register_generator_state(gen)
        where = []
        t0 = time.perf_counter()
        try:
            with no_collection(), \
                    torch.cuda.graph(graph, stream=self._side_stream(),
                                     capture_error_mode="thread_local"):
                try:
                    static = self._body()
                except Exception:
                    where.append(self._where())
                    raise
        except Exception as e:
            raise MXNetError(
                f"capturing {self.WHAT} failed at "
                f"{where[0] if where else 'the end of the capture'}: {e}"
            ) from e
        torch.cuda.synchronize(self.device)
        self.stats["capture_ms"] = (time.perf_counter() - t0) * 1e3
        self.stats["captures"] += 1
        self._graph = graph
        self._static = static
        self._bound = bound


class StepResult:
    """What one step gives the module: the outputs, the staged (weight,
    state leaves) pairs (empty under donation), the aux states before the
    step (None under donation) and the gradients (None unless asked)."""

    __slots__ = ("outputs", "staged", "aux_prev", "grads")

    def __init__(self, outputs, staged, aux_prev, grads):
        self.outputs = outputs
        self.staged = staged
        self.aux_prev = aux_prev
        self.grads = grads


class StepProgram(GraphProgram):
    """The fused step of one bound module (module docstring).

    ``indices`` are the updater's indices of ``executor._diff_args``;
    ``want_grads`` keeps the gradients as outputs; ``donate`` writes the new
    weights and states in place."""

    WHAT = "the training step"

    def __init__(self, executor, updater, indices, want_grads, donate):
        import torch

        super().__init__(executor)
        self.updater = updater
        self.optimizer = updater.optimizer
        self.names = list(executor._diff_args)
        self.indices = list(indices)
        self.want_grads = want_grads
        self.donate = donate
        n = len(self.names)
        self.rates = torch.zeros((2, n), dtype=torch.float32,
                                 device=self.device)
        self._lrs = [self.rates[0, p] for p in range(n)]
        self._wds = [self.rates[1, p] for p in range(n)]
        self._phase = None

    def _bindings(self):
        ts = super()._bindings()
        for i in self.indices:
            ts += self.optimizer._state_leaves(self.updater.states[i])
        return ts

    # -- rates ------------------------------------------------------------------
    def plan_rates(self, lrs_steps, wds_steps):
        """The learning rates and weight decays of ``n`` steps (one float32
        a parameter each) as one device tensor (n, 2, P), copied from pinned
        host memory without a wait (the allocator keeps a pinned block until
        its copy has run); a step takes its row through :meth:`set_rates`."""
        import numpy as np
        import torch

        host = np.asarray([[l, w] for l, w in zip(lrs_steps, wds_steps)],
                          dtype=np.float32).reshape(
            (len(lrs_steps),) + tuple(self.rates.shape))
        src = torch.from_numpy(host)
        if self.device.type == "cuda":
            src = src.pin_memory()
        return src.to(self.device, non_blocking=True)

    def set_rates(self, row):
        """Make ``row`` (a row of :meth:`plan_rates`) the rates the next
        step reads."""
        self.rates.copy_(row)

    # -- the function -----------------------------------------------------------
    def _body(self):
        """Forward, backward and update over the bound arrays."""
        import torch

        ex = self.ex
        args = {n: a.data for n, a in ex.arg_dict.items()}
        aux = {n: a.data for n, a in ex.aux_dict.items()}
        self._phase = "forward"
        outs, new_aux, grads = ex._fwd_bwd(args, aux, self.rng)
        self._phase = "update"
        with torch.no_grad():
            aux_prev = None if self.donate \
                else [aux[n].clone() for n in ex.aux_names]
            for n in ex.aux_names:
                aux[n].copy_(new_aux[n])
            staged = []
            for p, (name, i) in enumerate(zip(self.names, self.indices)):
                w = args[name]
                s = self.optimizer._state_leaves(self.updater.states[i])
                if not self.donate:
                    w = w.clone()
                    s = tuple(x.clone() for x in s)
                    staged.append((w, s))
                self.optimizer._tree_update(w, grads[name], s, self._lrs[p],
                                            self._wds[p])
        kept = [grads[n] for n in self.names] if self.want_grads else None
        return StepResult(outs, staged, aux_prev, kept)

    def _where(self):
        if self._phase == "update":
            return f"the {type(self.optimizer).__name__} update"
        return super()._where() + " (the backward runs after the walk)"


class ForwardProgram(GraphProgram):
    """The evaluation forward of one executor (module docstring): the graph
    walked in inference mode over the bound arguments and aux states.
    :meth:`run` returns output tensors of the caller's own: the eager
    function's, or copies of a replay's static outputs."""

    WHAT = "the evaluation forward"

    def _body(self):
        return self.ex.eager_forward(self.rng)

    def run(self):
        """One evaluation forward (module docstring): new output tensors,
        but for an output that is a bound argument's tensor, which is
        handed out as itself."""
        outs = super().run()
        if not self.replayed:
            return outs
        bound = {id(t) for t in self._bound}
        return [o if id(o) in bound else o.clone() for o in outs]
