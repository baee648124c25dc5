"""Dependency engine: asynchronous scheduling over read/write variables
(reference: mxnet_tpu/engine.py).

The reference's threaded dependency engine (include/mxnet/engine.h:75-229,
src/engine/threaded_engine.h). Device work needs no engine here: PyTorch
queues kernels on the current CUDA stream and returns. The engine orders
host work against host work and against the arrays it reads: serving
batches (``DynamicBatcher`` pushes each one with its parameters read and
its executor written), weight swaps, checkpoint writes. An op that
launches device work completes when its function returns; a reader that
needs the device's result synchronises itself (``asnumpy``,
:func:`mxnet_tpu_torch.ndarray.waitall`).

Semantics kept from the reference:

* opaque versioned variables: an op declares ``const_vars`` (reads) and
  ``mutable_vars`` (writes); conflicting ops serialise, independent ops
  run in parallel on a worker pool;
* ``wait_for_var`` / ``wait_for_all`` barriers;
* the synchronous ``NaiveEngine`` under ``MXNET_ENGINE_TYPE=NaiveEngine``;
  ``NativeEngine`` (``src/engine.cc``, built into the host library) under
  ``MXNET_ENGINE_TYPE=NativeEngine``;
* the duplicate-var check;
* asynchronous errors: an exception inside a pushed function taints the
  vars it writes, flows through the ops that read them, and is raised at
  the next ``wait_for_var`` of such a var or at ``wait_for_all``;
* ``on_skipped``: called with the failure when the engine completes an op
  without running it (an upstream taint, a quiesce window, a refused
  dispatch), so promises its function owns still resolve;
* ``begin_quiesce``/``end_quiesce`` and ``debug_snapshot``.

The reference's profiler records, telemetry gauges, fault injection,
flight recorder, stall watchdog and trace hand-off only observe; they are
not ported. ``shutdown()`` (not in the reference) stops a pool's workers,
so tests and servers leave no thread behind.
"""
from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from .base import MXNetError

__all__ = ["Var", "Engine", "ThreadedEngine", "NaiveEngine", "NativeEngine",
           "get_engine", "set_engine"]


def _default_workers(num_workers):
    if num_workers is None:
        num_workers = int(os.environ.get("MXNET_CPU_WORKER_NTHREADS", "0")) \
            or (os.cpu_count() or 4)
    return max(2, int(num_workers))


class Var:
    """Opaque dependency variable: an ordered queue of pending (op,
    is_write) entries and a count of readers in flight (the reference's
    VersionedVarBlock chain, threaded_engine.h:77-93, as a deque under one
    lock)."""

    __slots__ = ("_lock", "_queue", "_num_pending_reads", "name", "_native",
                 "_exc", "__weakref__")
    _counter = [0]

    def __init__(self, name: str | None = None):
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._num_pending_reads = 0
        self._exc = None  # the failure that produced this var's value
        Var._counter[0] += 1
        self.name = name or f"var{Var._counter[0]}"

    def __repr__(self):
        return f"Var({self.name})"


class _OpRecord:
    __slots__ = ("fn", "reads", "writes", "wait", "done", "exc", "name",
                 "flowed", "on_skipped")

    def __init__(self, fn, reads, writes, name, on_skipped=None):
        self.fn = fn
        self.reads = reads
        self.writes = writes
        self.wait = len(reads) + len(writes)
        self.done = threading.Event()
        self.exc = None
        self.name = name
        self.flowed = False   # exc came from a tainted input, not a raise
        self.on_skipped = on_skipped


class Engine:
    """The engine interface (reference: include/mxnet/engine.h:75)."""

    def new_variable(self, name=None) -> Var:
        return Var(name)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0, name="op",
             on_skipped=None):
        raise NotImplementedError

    def wait_for_var(self, var: Var):
        raise NotImplementedError

    def wait_for_all(self):
        raise NotImplementedError

    def begin_quiesce(self, exc, timeout_s=5.0) -> bool:
        """Ops dispatching from now on do not run: they complete as failed
        with ``exc`` (dependents, waiters and ``on_skipped`` promises
        resolve typed), and the call waits up to ``timeout_s`` for ops
        running on other threads. True when they drained in time. A
        synchronous engine has nothing in flight."""
        return True

    def end_quiesce(self):
        """Disarm :meth:`begin_quiesce`; taints it left are settled."""

    def shutdown(self):
        """Stop the worker pool once queued work is done (not in the
        reference)."""

    def debug_snapshot(self):
        return {"type": type(self).__name__}

    @staticmethod
    def _check_duplicate(const_vars, mutable_vars):
        """Reject repeated or overlapping vars (reference:
        threaded_engine.h:358 ``CheckDuplicate``)."""
        cset, mset = set(const_vars), set(mutable_vars)
        if len(cset) != len(const_vars) or len(mset) != len(mutable_vars):
            raise MXNetError("duplicate vars in const_vars or mutable_vars")
        if cset & mset:
            raise MXNetError("const_vars and mutable_vars overlap")


class NaiveEngine(Engine):
    """Runs every pushed function inline (src/engine/naive_engine.cc:16)."""

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0, name="op",
             on_skipped=None):
        self._check_duplicate(const_vars, mutable_vars)
        fn()

    def wait_for_var(self, var):
        pass

    def wait_for_all(self):
        pass


class ThreadedEngine(Engine):
    """Worker-pool engine with versioned-variable dependency resolution
    (src/engine/threaded_engine.h:93-195):

    * a read is granted at once unless a writer heads the var's queue;
      otherwise it queues behind that writer;
    * a write queues; it is granted at the head with no reader in flight;
    * an op dispatches when all its vars granted it;
    * completion releases each var, waking the next writer or a run of
      readers.
    """

    def __init__(self, num_workers: int | None = None):
        self._pool = ThreadPoolExecutor(
            max_workers=_default_workers(num_workers),
            thread_name_prefix="mxtpu-engine")
        self._lock = threading.Lock()
        self._inflight = 0
        self._all_done = threading.Condition(self._lock)
        self._last_exc = None
        # vars carrying a failure not yet raised (weak: an abandoned var
        # and its traceback can be collected)
        self._tainted: weakref.WeakSet = weakref.WeakSet()
        self._quiesce_exc = None
        self._executing = 0            # ops inside _execute
        self._tls = threading.local()  # the caller's own op, for quiesce
        # failures already raised to a caller (by identity): a flow-through
        # straggler must not taint again with one of them (bounded)
        self._delivered: deque = deque(maxlen=128)
        self._pending_ops: set = set()

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0, name="op",
             on_skipped=None):
        self._check_duplicate(const_vars, mutable_vars)
        rec = _OpRecord(fn, list(const_vars), list(mutable_vars), name,
                        on_skipped=on_skipped)
        with self._lock:
            self._inflight += 1
            self._pending_ops.add(rec)
        granted = 0
        for v in rec.reads:
            with v._lock:
                if not (v._queue and v._queue[0][1]):  # no writer at head
                    v._num_pending_reads += 1
                    granted += 1
                else:
                    v._queue.append((rec, False))
        for v in rec.writes:
            with v._lock:
                if not v._queue and v._num_pending_reads == 0:
                    v._queue.append((rec, True))  # head writer owns the var
                    granted += 1
                else:
                    v._queue.append((rec, True))
        self._sub_wait(rec, granted)
        return rec

    def _sub_wait(self, rec, n):
        # dispatch from push only when push's own decrement brings the wait
        # count to zero: with n == 0 and vars declared, every grant belongs
        # to a completer, and checking rec.wait here would race one that
        # already granted and dispatched (the op would run twice)
        if n == 0:
            if not rec.reads and not rec.writes:
                self._dispatch(rec)
            return
        with self._lock:
            rec.wait -= n
            ready = rec.wait == 0
        if ready:
            self._dispatch(rec)

    def _execute(self, rec):
        """Run one granted op on a worker and complete it."""
        ran = False
        with self._lock:
            self._executing += 1
        self._tls.executing = getattr(self._tls, "executing", 0) + 1
        try:
            # an op whose inputs came from a failed op does not run: the
            # failure flows to its outputs, so it surfaces at the var the
            # caller waits on
            upstream = next((v._exc for v in rec.reads + rec.writes
                             if v._exc is not None), None)
            if upstream is not None:
                rec.exc = upstream
                rec.flowed = True
            elif self._quiesce_exc is not None:
                rec.exc = self._quiesce_exc
            else:
                ran = True
                rec.fn()
        except BaseException as e:
            rec.exc = e
            with self._lock:
                self._last_exc = e
        finally:
            self._tls.executing -= 1
            with self._lock:
                self._executing -= 1
                if self._quiesce_exc is not None:
                    self._all_done.notify_all()
            try:
                self._taint_outputs(rec)
            finally:
                # the promises resolve before the op completes, so a
                # waiter on its vars finds them resolved
                self._notify_skipped(rec, ran)
                self._complete(rec)

    @staticmethod
    def _notify_skipped(rec, ran):
        """Tell the owner of ``on_skipped`` that its op is completing
        failed without running (outside every lock; its own failure is
        swallowed)."""
        if rec.on_skipped is None or ran or rec.exc is None:
            return
        try:
            rec.on_skipped(rec.exc)
        except Exception:
            pass

    def _dispatch(self, rec):
        try:
            self._pool.submit(self._execute, rec)
        except BaseException as e:
            # the pool refused (shut down): complete the op as failed so
            # dependents and waiters still wake
            rec.exc = e
            with self._lock:
                self._last_exc = e
            self._taint_outputs(rec)
            self._notify_skipped(rec, False)
            self._complete(rec)

    def _taint_outputs(self, rec):
        """Taint ``rec``'s outputs with its failure, unless the failure
        flowed through and was already delivered to a caller (the
        ``wait_for_var`` settle race). A failure an op raises always
        taints, even an exception object delivered before."""
        if rec.exc is None or not rec.writes:
            return
        with self._lock:
            if rec.flowed and any(rec.exc is d for d in self._delivered):
                return
            for v in rec.writes:
                v._exc = rec.exc
                self._tainted.add(v)

    def _complete(self, rec):
        to_wake: list[_OpRecord] = []

        def _grant(r):
            with self._lock:
                r.wait -= 1
                if r.wait == 0:
                    to_wake.append(r)

        for v in rec.reads:
            with v._lock:
                v._num_pending_reads -= 1
                if v._num_pending_reads == 0 and v._queue and v._queue[0][1]:
                    _grant(v._queue[0][0])  # the waiting writer now owns it
        for v in rec.writes:
            with v._lock:
                if v._queue and v._queue[0][0] is rec:
                    v._queue.popleft()
                while v._queue:
                    nxt, is_write = v._queue[0]
                    if is_write:
                        if v._num_pending_reads == 0:
                            _grant(nxt)
                        break
                    v._queue.popleft()
                    v._num_pending_reads += 1
                    _grant(nxt)
        rec.done.set()
        with self._lock:
            self._inflight -= 1
            self._pending_ops.discard(rec)
            if self._inflight == 0:
                self._all_done.notify_all()
        for nxt in to_wake:
            self._dispatch(nxt)

    def wait_for_var(self, var: Var):
        """Block until every op pushed so far that touches ``var`` is done,
        then raise this var's failure if its producers failed. Failures on
        other vars stay for their own waits (or ``wait_for_all``)."""
        rec = self.push(lambda: None, const_vars=(var,), name="wait_for_var")
        rec.done.wait()
        with self._lock:
            exc, var._exc = var._exc, None
            self._tainted.discard(var)
            if exc is not None:
                if self._last_exc is exc:
                    self._last_exc = None
                # one op taints all its outputs with the same object:
                # delivering it here settles them all
                self._delivered.append(exc)
                for v in list(self._tainted):
                    if v._exc is exc:
                        v._exc = None
                        self._tainted.discard(v)
        if exc is not None:
            raise exc

    def wait_for_all(self):
        with self._lock:
            while self._inflight:
                self._all_done.wait()
        self._reraise()

    def begin_quiesce(self, exc, timeout_s=5.0):
        """See :meth:`Engine.begin_quiesce`. The caller's own running op
        is not waited for."""
        with self._lock:
            self._quiesce_exc = exc
        exclude = getattr(self._tls, "executing", 0)
        deadline = time.perf_counter() + timeout_s
        with self._lock:
            while self._executing > exclude:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return False
                self._all_done.wait(timeout=min(remaining, 0.1))
        return True

    def end_quiesce(self):
        with self._lock:
            exc, self._quiesce_exc = self._quiesce_exc, None
            if exc is None:
                return
            if self._last_exc is exc:
                self._last_exc = None
            self._delivered.append(exc)
            for v in list(self._tainted):
                if v._exc is exc:
                    v._exc = None
                    self._tainted.discard(v)

    def shutdown(self):
        """Wait for the queued ops, then stop the workers (their
        failures stay for a later ``wait_for_all``). A push after this
        completes failed."""
        with self._lock:
            while self._inflight:
                self._all_done.wait()
        self._pool.shutdown(wait=True)

    def debug_snapshot(self):
        """Pending ops and the vars each still waits on."""
        with self._lock:
            inflight = self._inflight
            recs = list(self._pending_ops)
        pending = [{"op": r.name,
                    "state": "waiting_on_deps" if r.wait > 0
                    else "dispatched",
                    "reads": [v.name for v in r.reads],
                    "writes": [v.name for v in r.writes],
                    "unresolved": self._unresolved_deps(r)}
                   for r in recs if not r.done.is_set()]
        return {"type": type(self).__name__, "inflight": inflight,
                "workers_total": self._pool._max_workers,
                "pending_ops": pending}

    @staticmethod
    def _unresolved_deps(rec):
        """The vars that have not granted ``rec`` and who holds them."""
        deps = []
        for v in rec.reads:
            with v._lock:
                entries = list(v._queue)
            if any(e[0] is rec for e in entries):
                deps.append({"var": v.name, "mode": "read",
                             "blocked_by": entries[0][0].name})
        for v in rec.writes:
            with v._lock:
                entries = list(v._queue)
                readers = v._num_pending_reads
            if entries and entries[0][0] is rec:
                if rec.wait > 0 and readers > 0:
                    deps.append({"var": v.name, "mode": "write",
                                 "blocked_on_readers": readers})
            else:
                pos = next((i for i, e in enumerate(entries)
                            if e[0] is rec), None)
                if pos is not None:
                    deps.append({"var": v.name, "mode": "write",
                                 "blocked_by": entries[0][0].name,
                                 "queue_position": pos})
        return deps

    def _reraise(self):
        # a full barrier settles every failure: clear every taint, raising
        # the last failure (or, if a wait_for_var took it, another one a
        # var still carries)
        with self._lock:
            exc, self._last_exc = self._last_exc, None
            for v in self._tainted:
                if exc is None and v._exc is not None:
                    exc = v._exc
                v._exc = None
            self._tainted.clear()
        if exc is not None:
            raise exc


class NativeEngine(Engine):
    """The C++ threaded engine (``src/engine.cc``, in the host library of
    :func:`mxnet_tpu_torch._native.host_lib`); Python functions cross
    through one long-lived ctypes trampoline (the token travels in the C
    ``ctx`` pointer), which takes the GIL a call. Failures are raised at
    the next wait, whichever var they came from."""

    def __init__(self, num_workers: int | None = None):
        from . import _native

        lib = _native.host_lib()
        if lib is None or not hasattr(lib, "mxtpu_engine_create"):
            raise MXNetError("native engine library unavailable")
        self._lib = lib
        self._h = lib.mxtpu_engine_create(_default_workers(num_workers))
        self._pending = {}
        self._lock = threading.Lock()
        self._counter = 0
        self._last_exc = [None]
        self._quiesce_exc = [None]
        self._finalizers = []

        def _trampoline(ctx):
            token = int(ctx or 0)
            with self._lock:
                entry = self._pending.pop(token, None)
            if entry is None:
                return
            fn, on_skipped = entry
            qexc = self._quiesce_exc[0]
            if qexc is not None:
                self._last_exc[0] = qexc
                if on_skipped is not None:
                    try:
                        on_skipped(qexc)
                    except Exception:
                        pass
                return
            try:
                fn()
            except BaseException as e:   # raised at the next wait
                self._last_exc[0] = e

        self._cb = _native.ENGINE_CALLBACK(_trampoline)  # lives with self

    def _attach_native(self, v):
        v._native = self._lib.mxtpu_engine_new_var(self._h)
        # free the C++ var when the Python var is collected
        self._finalizers.append(weakref.finalize(
            v, self._lib.mxtpu_engine_delete_var, self._h, v._native))

    def new_variable(self, name=None):
        v = Var(name)
        self._attach_native(v)
        return v

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0, name="op",
             on_skipped=None):
        import ctypes

        if self._h is None:
            raise MXNetError("push after NativeEngine.shutdown()")
        self._check_duplicate(const_vars, mutable_vars)
        for v in list(const_vars) + list(mutable_vars):
            if not hasattr(v, "_native"):
                self._attach_native(v)
        with self._lock:
            self._counter += 1
            token = self._counter
            self._pending[token] = (fn, on_skipped)
        n_r, n_w = len(const_vars), len(mutable_vars)
        reads = (ctypes.c_void_p * max(1, n_r))(
            *[v._native for v in const_vars])
        writes = (ctypes.c_void_p * max(1, n_w))(
            *[v._native for v in mutable_vars])
        self._lib.mxtpu_engine_push(self._h, self._cb,
                                    ctypes.c_void_p(token),
                                    reads, n_r, writes, n_w)

    def wait_for_var(self, var):
        done = threading.Event()
        self.push(done.set, const_vars=(var,), name="wait_for_var")
        done.wait()
        self._reraise()

    def wait_for_all(self):
        self._lib.mxtpu_engine_wait_all(self._h)   # blocks without the GIL
        self._reraise()

    def begin_quiesce(self, exc, timeout_s=5.0):
        """Flag only: queued functions are skipped and surface ``exc``;
        running C tasks are not waited for."""
        self._quiesce_exc[0] = exc
        return True

    def end_quiesce(self):
        exc, self._quiesce_exc[0] = self._quiesce_exc[0], None
        if exc is not None and self._last_exc[0] is exc:
            self._last_exc[0] = None

    def shutdown(self):
        """Wait for the queued ops and join the C workers. The C vars of
        Python vars still alive are left to the process."""
        if self._h is None:
            return
        for fin in self._finalizers:
            fin.detach()
        self._finalizers = []
        h, self._h = self._h, None
        self._lib.mxtpu_engine_destroy(h)

    def debug_snapshot(self):
        with self._lock:
            n = len(self._pending)
        return {"type": type(self).__name__, "inflight": n}

    def _reraise(self):
        exc, self._last_exc[0] = self._last_exc[0], None
        if exc is not None:
            raise exc


_ENGINE: Engine | None = None
_ENGINE_LOCK = threading.Lock()


def get_engine() -> Engine:
    """The process's engine, made on first use under ``MXNET_ENGINE_TYPE``
    (reference: src/engine/engine.cc:13-39): ``ThreadedEngine`` (default),
    ``NaiveEngine``, or ``NativeEngine`` (falls back to
    ``ThreadedEngine`` with a warning where the host library does not
    build)."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            kind = os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEngine")
            if kind == "NaiveEngine":
                _ENGINE = NaiveEngine()
            elif kind == "NativeEngine":
                try:
                    _ENGINE = NativeEngine()
                except MXNetError:
                    import logging

                    logging.warning(
                        "MXNET_ENGINE_TYPE=NativeEngine requested but the "
                        "native library is unavailable; falling back to the "
                        "python ThreadedEngine")
                    _ENGINE = ThreadedEngine()
            else:
                _ENGINE = ThreadedEngine()
        return _ENGINE


def set_engine(engine: Engine | None):
    """Install ``engine`` as the process's engine (None: the next
    :func:`get_engine` makes one)."""
    global _ENGINE
    with _ENGINE_LOCK:
        _ENGINE = engine
