"""LRU cache of bound forward executors, keyed by bucket input shapes
(reference: mxnet_tpu/serving/executor_cache.py).

The batcher pads requests into a bounded set of shape buckets; this cache
binds each bucket once, through :meth:`Predictor.bind_forward`, so cached
executors share the predictor's parameter and aux NDArrays (no copy of the
weights, and a weight swap reaches every bucket). On the card each
binding's evaluation forward is one captured CUDA graph (its warm-up, then
its capture, then replays; ``module/step_graph.py``): one bind and one
capture a bucket.

Concurrency: binding serializes per key, not under the map lock. A prewarm
thread binding and capturing one bucket does not block traffic on a warm
bucket, and LRU eviction never races a bind in flight (an in-flight key
lives in the slot table, not the LRU map). Concurrent misses on one key
wait for the same bind. :meth:`warm` builds the program inside the bind
slot (:meth:`Executor.warmup`), so traffic for that bucket finds it
captured.

Weights (the port's departures from the reference, whose executors read
``NDArray._data`` at every dispatch; a captured graph reads the storage it
was captured over):

* :meth:`swap_params` validates the new version, builds every replacement
  tensor on the device, and only then copies each into the bound tensor in
  place: no rebind and no capture, and the graphs read the new weights.
* :meth:`page_out` moves every parameter and aux array to pinned host
  memory and drops each cached binding's graph (a graph keeps its tensors
  alive); :meth:`page_in` moves them back and captures each binding that
  was built before again (``ROADMAP.md`` C10): zero rebinds, one capture a
  cached bucket. :meth:`pin` exempts the weights from paging.

``stats()`` counts binds, hits, misses, evictions, warms, bind waits,
pages, swaps, and the warm-ups, captures and replays of the cached
bindings' programs (those of evicted bindings included).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np

__all__ = ["ExecutorCache", "shape_key", "built"]

_PROGRAM_KEYS = ("warmups", "captures", "replays", "eager_runs", "drops")


def shape_key(input_shapes):
    """Canonical hashable key for a dict name -> shape tuple."""
    return tuple(sorted((k, tuple(v)) for k, v in input_shapes.items()))


def _program_stats(ex):
    prog = ex._eval_program
    return {k: (prog.stats[k] if prog is not None else 0)
            for k in _PROGRAM_KEYS}


def built(ex):
    """The binding's program is ready: warmed, captured, or eager by rule
    (the CPU, a refused capture) and run once."""
    prog = ex._eval_program
    return ex._warmed or (prog is not None and (
        prog.captured or (not prog.capturable and prog.stats["eager_runs"])))


class _BindSlot:
    """One bind in flight: waiters block on ``ready``; ``error`` reaches
    every waiter of a failed bind."""

    __slots__ = ("ready", "error")

    def __init__(self):
        self.ready = threading.Event()
        self.error = None


class ExecutorCache:
    """LRU of ``shape_key -> (executor, out_shapes)`` bound off one
    :class:`~mxnet_tpu_torch.predictor.Predictor`. ``capacity`` should be at
    least the bucket count so steady traffic never rebinds; evictions are
    counted. ``manifest`` (a :class:`~mxnet_tpu_torch.serving.manifest.
    ShapeManifest`) records every bind for restart prewarming."""

    def __init__(self, predictor, capacity=8, manifest=None):
        if capacity < 1:
            raise ValueError("ExecutorCache: capacity must be >= 1")
        self._pred = predictor
        self._cap = capacity
        self._manifest = manifest
        self._entries = OrderedDict()
        self._binding = {}  # shape_key -> _BindSlot (binds in flight)
        self._lock = threading.Lock()
        self._stats = {"binds": 0, "hits": 0, "misses": 0, "evictions": 0,
                       "warmed": 0, "bind_waits": 0, "page_outs": 0,
                       "page_ins": 0, "param_swaps": 0}
        self._evicted = dict.fromkeys(_PROGRAM_KEYS, 0)
        self._pinned = False
        self._paged_out = False
        self._paged_bytes = 0
        self._page_busy = False
        self._pages = []   # [(NDArray, its device), ...]
        self._rewarm = []  # keys built before a page_out

    def get(self, input_shapes):
        """``(executor, out_shapes)`` for these exact (bucketed) input
        shapes, bound on first use. Concurrent misses on one key wait for
        one bind."""
        return self._lookup(input_shapes, warm=False)[0]

    def warm(self, input_shapes):
        """Bind and build (warm up and capture) the executor for
        ``input_shapes`` inside the bind slot, so traffic for this bucket
        waits for the same bind and finds the graph captured. Returns
        ``{"bound", "compiled", "seconds"}`` (``compiled``: this call
        built the program)."""
        t0 = time.perf_counter()
        entry, bound, compiled = self._lookup(input_shapes, warm=True)
        if not bound and not compiled:
            # cached already (bound by traffic moments ago): make sure its
            # program is built
            compiled = self._maybe_warm(entry[0])
        return {"bound": bound, "compiled": compiled,
                "seconds": time.perf_counter() - t0}

    def _lookup(self, input_shapes, warm):
        """(entry, bound here, built here). The map lock covers only the
        LRU and slot tables; the bind (and warm) run in the key's slot with
        no lock held."""
        key = shape_key(input_shapes)
        while True:
            with self._lock:
                hit = self._entries.get(key)
                if hit is not None:
                    self._entries.move_to_end(key)
                    self._stats["hits"] += 1
                    return hit, False, False
                slot = self._binding.get(key)
                owner = slot is None
                if owner:
                    slot = _BindSlot()
                    self._binding[key] = slot
                    self._stats["misses"] += 1
                    self._stats["binds"] += 1
                else:
                    self._stats["bind_waits"] += 1
            if not owner:
                # wait for the bind in flight, then look again (the owner
                # installs the entry before it signals)
                slot.ready.wait()
                if slot.error is not None:
                    raise slot.error
                continue
            try:
                entry = self._pred.bind_forward(input_shapes)
                compiled = self._maybe_warm(entry[0]) if warm else False
            except BaseException as e:
                with self._lock:
                    self._binding.pop(key, None)
                slot.error = e
                slot.ready.set()
                raise
            with self._lock:
                self._entries[key] = entry
                self._binding.pop(key, None)
                while len(self._entries) > self._cap:
                    self._evict_oldest()
            slot.ready.set()
            self._record_manifest(input_shapes)
            return entry, True, compiled

    def _evict_oldest(self):
        # caller holds the lock
        _, (ex, _) = self._entries.popitem(last=False)
        for k, v in _program_stats(ex).items():
            self._evicted[k] += v
        self._stats["evictions"] += 1

    def _maybe_warm(self, ex):
        """Build the binding's program once (a binding already built, by a
        warm or by traffic, is left alone)."""
        if built(ex):
            return False
        ex.warmup()
        with self._lock:
            self._stats["warmed"] += 1
        return True

    def _record_manifest(self, input_shapes):
        if self._manifest is None:
            return
        try:
            self._manifest.record(input_shapes)
        except Exception:  # manifest trouble must never fail a bind
            pass

    def programs(self):
        """``{shape_key: forward_info}`` of the cached bindings (None for a
        binding that has not run)."""
        with self._lock:
            items = list(self._entries.items())
        return {key: ex.forward_info() for key, (ex, _) in items}

    # -- weights ----------------------------------------------------------------
    def _param_arrays(self):
        seen, out = set(), []
        for arr in list(self._pred._arg_params.values()) \
                + list(self._pred._aux_params.values()):
            if id(arr) not in seen:
                seen.add(id(arr))
                out.append(arr)
        return out

    def resident_param_bytes(self):
        """Parameter and aux bytes of this model (on the device or, paged
        out, on the host)."""
        return sum(a.data.numel() * a.data.element_size()
                   for a in self._param_arrays())

    def pin(self):
        """Mark the weights hot: :meth:`page_out` does nothing until
        :meth:`unpin`."""
        with self._lock:
            self._pinned = True

    def unpin(self):
        with self._lock:
            self._pinned = False

    def _executors(self):
        with self._lock:
            exs = [ex for ex, _ in self._entries.values()]
        return exs + [self._pred._executor]

    def page_out(self, force=False):
        """Move the parameter and aux arrays to pinned host memory and
        drop every cached binding's graph, so their device memory is
        freed. Bindings stay cached (no rebind later). Returns the bytes
        paged out (0 when pinned unless ``force``, already paged out, on
        the CPU, or a page operation is in flight). No traffic may reach
        the cache while it is paged out."""
        import torch

        with self._lock:
            if (self._pinned and not force) or self._paged_out \
                    or self._page_busy:
                return 0
            self._page_busy = True
            entries = list(self._entries.items())
        try:
            pages, nbytes = [], 0
            for arr in self._param_arrays():
                t = arr.data
                if t.device.type == "cpu":
                    continue
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t)
                pages.append((arr, t.device, host))
                nbytes += t.numel() * t.element_size()
            if not pages:
                return 0
            rewarm = [key for key, (ex, _) in entries if built(ex)]
            for ex in self._executors():
                with ex._eval_lock:
                    if ex._eval_program is not None:
                        ex._eval_program.drop()
                    ex._warmed = False
            for arr, _, host in pages:
                arr._data = host  # drops the last device reference
            with self._lock:
                self._pages = [(arr, dev) for arr, dev, _ in pages]
                self._rewarm = rewarm
                self._paged_bytes = nbytes
                self._paged_out = True
                self._stats["page_outs"] += 1
            return nbytes
        finally:
            with self._lock:
                self._page_busy = False

    def page_in(self):
        """Move the paged-out arrays back to their devices (bit for bit)
        and capture again every cached binding that was built before the
        page-out (C10). Returns True when a restore happened."""
        import torch

        with self._lock:
            if not self._paged_out or self._page_busy:
                return False
            self._page_busy = True
            pages, rewarm = self._pages, self._rewarm
        try:
            for arr, dev in pages:
                arr._data = arr.data.to(dev, non_blocking=True)
            for dev in {dev for _, dev in pages}:
                torch.cuda.current_stream(dev).synchronize()
            with self._lock:
                self._pages, self._rewarm = [], []
                self._paged_bytes = 0
                self._paged_out = False
                self._stats["page_ins"] += 1
                exs = [self._entries[k][0] for k in rewarm
                       if k in self._entries]
        finally:
            with self._lock:
                self._page_busy = False
        for ex in exs:
            ex.warmup()
        return True

    def swap_params(self, arg_params, aux_params=None):
        """Replace the served parameter and aux values with a new version
        of the same shapes, keeping every binding and graph. Everything is
        checked first (the exact name sets, each shape) and every
        replacement tensor is made on its array's device (in its dtype);
        only then is each copied into the bound tensor in place. A failure
        before the copies leaves the live version serving. The caller
        pushes this through the engine with the server's params var
        written (:meth:`ModelServer.swap_params`), so it lands between
        batches.

        Raises :class:`~mxnet_tpu_torch.serving.errors.LifecycleError` on a
        mismatch or while the weights are paged out. Returns the bytes
        swapped in."""
        import torch

        from .errors import LifecycleError

        aux_params = aux_params if aux_params is not None else {}
        with self._lock:
            if self._paged_out or self._page_busy:
                raise LifecycleError(
                    "swap_params while weights are paged out (or a page "
                    "transition is in flight): page_in first; the swap "
                    "replaces live device arrays, not host copies")
            self._page_busy = True
        try:
            copies, nbytes = [], 0
            for kind, cur_map, new_map in (
                    ("arg", self._pred._arg_params, arg_params),
                    ("aux", self._pred._aux_params, aux_params)):
                cur_names, new_names = set(cur_map), set(new_map)
                if cur_names != new_names:
                    missing = sorted(cur_names - new_names)
                    extra = sorted(new_names - cur_names)
                    raise LifecycleError(
                        f"swap_params: {kind} param set does not match the "
                        f"served model (missing: {missing or 'none'}, "
                        f"unexpected: {extra or 'none'})")
                for name, arr in cur_map.items():
                    new = new_map[name]
                    host = new.asnumpy() if hasattr(new, "asnumpy") \
                        else np.asarray(new)
                    if tuple(host.shape) != tuple(arr.shape):
                        raise LifecycleError(
                            f"swap_params: {kind} param {name!r} shape "
                            f"{tuple(host.shape)} != served "
                            f"{tuple(arr.shape)}: a shape change needs a "
                            "rebind, not a hot swap")
                    t = arr.data
                    src = torch.from_numpy(np.ascontiguousarray(host)).to(
                        device=t.device, dtype=t.dtype)
                    copies.append((t, src))
                    nbytes += t.numel() * t.element_size()
            with torch.no_grad():
                for t, src in copies:
                    t.copy_(src)
            if copies and copies[0][0].device.type == "cuda":
                torch.cuda.current_stream(copies[0][0].device).synchronize()
            with self._lock:
                self._stats["param_swaps"] += 1
            return nbytes
        finally:
            with self._lock:
                self._page_busy = False

    def set_capacity(self, capacity):
        """Set the LRU capacity, evicting the oldest entries past it
        (binds in flight are untouched)."""
        if capacity < 1:
            raise ValueError("ExecutorCache: capacity must be >= 1")
        with self._lock:
            self._cap = capacity
            while len(self._entries) > self._cap:
                self._evict_oldest()

    @property
    def paged_out(self):
        with self._lock:
            return self._paged_out

    def stats(self):
        with self._lock:
            progs = dict(self._evicted)
            for ex, _ in self._entries.values():
                for k, v in _program_stats(ex).items():
                    progs[k] += v
            return dict(self._stats, **progs, size=len(self._entries),
                        entries=len(self._entries), capacity=self._cap,
                        paged_out=self._paged_out,
                        paged_out_bytes=self._paged_bytes,
                        pinned=self._pinned)

    def __len__(self):
        with self._lock:
            return len(self._entries)
