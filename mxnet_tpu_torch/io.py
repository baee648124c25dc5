"""Data descriptors, batches and iterators (reference: mxnet_tpu/io.py).

An iterator's batches are host (CPU) NDArrays; the executor moves each fed
array to its device (:func:`mxnet_tpu_torch.executor._fed_tensor`), a
blocking copy from pageable memory. :class:`DevicePrefetchIter` takes that
copy off the step's path: a thread copies each next batch into pinned host
memory and on to the card on a side stream while the step runs.
:class:`PrefetchingIter` runs any iterator in a background thread, or, with
``MXNET_IO_WORKERS > 1``, decodes batches in a pool of threads through the
``decode_plan``/``decode_work`` protocol of :class:`NDArrayIter` and
``image.ImageIter``, in order. ``image.ImageIter`` is the image and
RecordIO iterator. The reference's telemetry, flight-recorder and
fault-injection sites in these classes are not ported.
"""
from __future__ import annotations

import collections
import os
import queue as _queue
import threading
import time

import numpy as np

from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ResizeIter", "PrefetchingIter",
           "DevicePrefetchIter"]


def _env_io_workers():
    """``MXNET_IO_WORKERS`` (default 1: one producer thread, no pool)."""
    try:
        return max(1, int(os.environ.get("MXNET_IO_WORKERS", "1")))
    except ValueError:
        return 1


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """Named shape descriptor with dtype and layout."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        """The batch axis of ``layout`` (0 when there is none)."""
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One minibatch: lists of data and label NDArrays (or arrays)."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label if label is not None else []
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """The iterator protocol: ``reset``, ``next`` (a :class:`DataBatch`, or
    ``StopIteration`` at the end of an epoch), ``provide_data`` and
    ``provide_label``."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Input arrays as a sorted list of (name, numpy array)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = {}
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out[k] = np.asarray(v)
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """Batches of in-memory arrays. ``shuffle`` permutes the examples with
    the global ``np.random`` at construction and at each ``reset``; the last
    batch of an epoch is padded from the start (``pad``, the batch's ``pad``
    field counting the repeated examples), dropped (``discard``) or carried
    into the next epoch (``roll_over``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
        self.shuffle = shuffle
        if last_batch_handle == "discard":
            n = self.data[0][1].shape[0]
            self.idx = self.idx[:n - n % batch_size]
        self.data_list = [x[1] for x in self.data] + [x[1] for x in
                                                      self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size"
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])))
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])))
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size \
                + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None,
                             provide_data=self.provide_data,
                             provide_label=self.provide_label)
        raise StopIteration

    def _getdata(self, data_source, cursor=None):
        cursor = self.cursor if cursor is None else cursor
        assert cursor < self.num_data, "DataIter needs reset."
        if cursor + self.batch_size <= self.num_data:
            sel = self.idx[cursor:cursor + self.batch_size]
        else:
            pad = self.batch_size - self.num_data + cursor
            sel = np.concatenate([self.idx[cursor:], self.idx[:pad]])
        return [_host_float32(x[sel]) for _, x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self, cursor=None):
        cursor = self.cursor if cursor is None else cursor
        if self.last_batch_handle == "pad" and \
                cursor + self.batch_size > self.num_data:
            return cursor + self.batch_size - self.num_data
        return 0

    # -- the decode-plan protocol of PrefetchingIter's thread pool ------------
    def decode_plan(self):
        """The batches' start cursors, in the serial order (the permutation
        is fixed at ``reset``); None under ``roll_over``, whose epochs
        depend on the one before."""
        if self.last_batch_handle == "roll_over":
            return None
        return list(range(0, self.num_data, self.batch_size))

    def decode_work(self, cursor, tls):
        """The batch at ``cursor``; thread-safe (reads only)."""
        return DataBatch(data=self._getdata(self.data, cursor),
                         label=self._getdata(self.label, cursor),
                         pad=self.getpad(cursor), index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


def _host_float32(a):
    """A fresh numpy array as a float32 CPU NDArray: no copy when it is
    float32 already."""
    import torch

    if a.dtype == np.float32 and a.flags.c_contiguous:
        return NDArray(torch.from_numpy(a))
    return array(a, cpu())


class CSVIter(DataIter):
    """Batches of rows of CSV files (reference: io.py ``CSVIter``): each
    row of ``data_csv`` reshaped to ``data_shape``; labels from
    ``label_csv`` or zeros. ``round_batch`` carries the last partial batch
    into the next epoch."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0],) + tuple(label_shape),
                             np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="roll_over" if round_batch else "pad",
            label_name="label")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class MNISTIter(DataIter):
    """Batches of MNIST idx files, optionally gzipped (reference: io.py
    ``MNISTIter``): images scaled to [0, 1], (1, 28, 28) or ``flat``."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 silent=False, seed=0, input_shape=None, **kwargs):
        super().__init__(batch_size)
        images = _read_idx(image).astype(np.float32) / 255.0
        labels = _read_idx(label).astype(np.float32)
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1, 28, 28)
        self._inner = NDArrayIter(images, labels, batch_size, shuffle=shuffle,
                                  label_name="softmax_label")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


def _read_idx(path):
    """An idx file (big-endian magic whose low byte is the rank, the dims,
    then uint8 data) as a numpy array."""
    import gzip
    import struct

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


class ResizeIter(DataIter):
    """``size`` batches an epoch of ``data_iter``, restarting it when it
    runs out (reference: io.py ``ResizeIter``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _Failure:
    """An exception delivered in the batches' order: the consumer raises it
    where the serial iterator would have."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


def _put_until(q, item, stop):
    """Put ``item`` on the bounded queue ``q`` unless ``stop`` is set
    first; True when it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False


def _drain(q):
    while True:
        try:
            q.get_nowait()
        except _queue.Empty:
            return


class PrefetchingIter(DataIter):
    """Batches of one or more iterators prepared in the background
    (reference: io.py ``PrefetchingIter``): one producer thread keeps up to
    ``prefetch_depth`` batches ahead; ``num_workers > 1`` (default
    ``MXNET_IO_WORKERS``) over one iterator with a ``decode_plan`` decodes
    with that many threads, delivering the batches in the serial order. An
    exception reaches the consumer at the batch where it happened.
    ``starved_count`` counts the batches the consumer had to wait for."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2, num_workers=None):
        if not isinstance(iters, list):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._queue = _queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._threads = []
        self._cv = threading.Condition()
        self._peek = None     # the batch iter_next fetched, owed to next
        self._eof = False
        self.starved_count = 0
        if num_workers is None:
            num_workers = _env_io_workers()
        self._workers = max(1, int(num_workers))
        self._start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape) for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape) for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def _start(self):
        plan = (self.iters[0].decode_plan()
                if self._workers > 1 and self.n_iter == 1
                and hasattr(self.iters[0], "decode_plan") else None)
        if plan is not None:
            state = {"claim": 0, "emit": 0}   # shared by the workers
            self._threads = [
                threading.Thread(target=self._pool_worker, args=(plan, state),
                                 daemon=True, name=f"mxtpu-io-decode-{k}")
                for k in range(self._workers)]
        else:
            self._threads = [threading.Thread(
                target=self._producer, daemon=True, name="mxtpu-io-prefetch")]
        for t in self._threads:
            t.start()

    def _producer(self):
        while not self._stop.is_set():
            try:
                batches = [i.next() for i in self.iters]
            except StopIteration:
                _put_until(self._queue, None, self._stop)
                return
            except Exception as e:   # delivered in order, ends the thread
                _put_until(self._queue, _Failure(e), self._stop)
                return
            merged = DataBatch(
                data=sum([b.data for b in batches], []),
                label=sum([(b.label or []) for b in batches], []),
                pad=batches[0].pad, index=batches[0].index)
            if not _put_until(self._queue, merged, self._stop):
                return

    def _pool_worker(self, plan, state):
        """Claim the next plan entry, decode it, and put it once every
        earlier entry is in the queue; entry ``len(plan)`` is the end."""
        src = self.iters[0]
        tls = {}
        cv = self._cv
        while True:
            with cv:
                i = state["claim"]
                state["claim"] += 1
            if i > len(plan) or self._stop.is_set():
                return
            if i == len(plan):
                item = None
            else:
                try:
                    item = src.decode_work(plan[i], tls)
                except Exception as e:   # delivered in order
                    item = _Failure(e)
            with cv:
                while state["emit"] != i and not self._stop.is_set():
                    cv.wait(timeout=0.1)
                if self._stop.is_set():
                    return
            put = _put_until(self._queue, item, self._stop)
            with cv:
                if put:
                    state["emit"] += 1
                cv.notify_all()
            if not put or item is None or isinstance(item, _Failure):
                if isinstance(item, _Failure):
                    self._stop.set()   # the consumer stops at the error
                return

    def close(self):
        """Stop and join the threads and drop the prepared batches;
        ``reset`` starts them again."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []
        _drain(self._queue)
        self._peek = None
        self._eof = True

    def __del__(self):
        try:
            self.close()
        except Exception:   # interpreter shutdown
            pass

    def reset(self):
        self.close()
        self._eof = False
        for i in self.iters:
            i.reset()
        self._stop.clear()
        self._start()

    def next(self):
        if self._peek is not None:
            batch, self._peek = self._peek, None
            return batch
        if self._eof:
            raise StopIteration
        if self._queue.empty():
            self.starved_count += 1
        batch = self._queue.get()
        if batch is None:
            self._eof = True
            raise StopIteration
        if isinstance(batch, _Failure):
            self._eof = True
            raise batch.exc
        return batch

    def iter_next(self):
        if self._peek is not None:
            return True
        try:
            self._peek = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        assert self._peek is not None, "call iter_next() first"
        return self._peek.data

    def getlabel(self):
        assert self._peek is not None, "call iter_next() first"
        return self._peek.label

    def getindex(self):
        assert self._peek is not None, "call iter_next() first"
        return self._peek.index

    def getpad(self):
        assert self._peek is not None, "call iter_next() first"
        return self._peek.pad


class PinnedRing:
    """``slots`` sets of pinned host buffers and a side CUDA stream: the
    staging area of :class:`DevicePrefetchIter` on the card. ``stage``
    copies host tensors into the next slot's buffers and issues their
    ``non_blocking`` copies to the device on the side stream, recording an
    event after them. A slot is refilled only once the event of its last
    copy has completed, so a copy never reads a buffer being rewritten."""

    def __init__(self, device, slots):
        import torch

        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._bufs = [[] for _ in range(slots)]
        self._events = [None] * slots
        self._next = 0

    def stage(self, tensors):
        """Device copies of the CPU ``tensors`` on the side stream, and the
        event that marks their completion."""
        import torch

        k = self._next
        self._next = (k + 1) % len(self._bufs)
        if self._events[k] is not None:
            self._events[k].synchronize()
        bufs = self._bufs[k]
        out = []
        with torch.cuda.stream(self.stream):
            for j, t in enumerate(tensors):
                if j == len(bufs):
                    bufs.append(None)
                if bufs[j] is None or bufs[j].shape != t.shape \
                        or bufs[j].dtype != t.dtype:
                    bufs[j] = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
                bufs[j].copy_(t)
                out.append(bufs[j].to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[k] = event
        return out, event


class DevicePrefetchIter(DataIter):
    """Batches staged onto the executor group's device ahead of the step
    (reference: io.py ``DevicePrefetchIter``, redesigned for the card). A
    thread takes host batches from ``data_iter`` and stages each through
    ``exec_group.stage_batch``: on the card into a :class:`PinnedRing` of
    ``depth + 1`` slots and on to the device on a side stream, up to
    ``depth`` batches ahead; on the CPU the batch passes as it is. ``next``
    makes the consumer's stream wait for the batch's copy event and marks
    each staged tensor as used on that stream (``record_stream``), so the
    allocator does not hand its memory out while the step still reads it.
    Staging only moves data, so the step's outputs and parameters are
    bit-identical to the synchronous feed's.

    ``staged_count``, ``stage_seconds`` (the stager's host time),
    ``h2d_bytes`` and ``starved_count`` (batches the consumer had to wait
    for) accumulate.
    ``Module.fit`` arms it under ``MXNET_DEVICE_PREFETCH=1``
    (:meth:`Module.device_prefetch`); ``stage_superbatch`` pulls a
    super-batch for ``Module.run_n_steps``."""

    def __init__(self, data_iter, exec_group, depth=2):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self._group = exec_group
        self._depth = max(1, int(depth))
        device = exec_group.contexts[0].torch_device
        self._ring = PinnedRing(device, self._depth + 1) \
            if device.type == "cuda" else None
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = None
        self._eof = False
        self.staged_count = 0
        self.stage_seconds = 0.0
        self.h2d_bytes = 0
        self.starved_count = 0
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self._start()

    def _stage(self, batch):
        t0 = time.perf_counter()
        nbytes, event = self._group.stage_batch(batch, self._ring)
        self.stage_seconds += time.perf_counter() - t0
        self.h2d_bytes += nbytes
        self.staged_count += 1
        return batch, event

    def _stager(self):
        while not self._stop.is_set():
            try:
                item = self._stage(self.data_iter.next())
            except StopIteration:
                item = None
            except Exception as e:   # delivered in order, ends the thread
                item = _Failure(e)
            if not _put_until(self._queue, item, self._stop) \
                    or item is None or isinstance(item, _Failure):
                return

    def _start(self):
        self._thread = threading.Thread(target=self._stager, daemon=True,
                                        name="mxtpu-io-device-stage")
        self._thread.start()

    def _halt(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _drain(self._queue)

    def close(self):
        """Stop and join the stager and drop the staged batches, then close
        the wrapped iterator where it has ``close``; ``reset`` starts
        again."""
        self._halt()
        self._eof = True
        inner_close = getattr(self.data_iter, "close", None)
        if inner_close is not None:
            inner_close()

    def __del__(self):
        try:
            self.close()
        except Exception:   # interpreter shutdown
            pass

    def reset(self):
        self._halt()
        self._eof = False
        self.data_iter.reset()
        self._stop.clear()
        self._start()

    def next(self):
        if self._eof:
            raise StopIteration
        if self._queue.empty():
            self.starved_count += 1
        item = self._queue.get()
        if item is None:
            self._eof = True
            raise StopIteration
        if isinstance(item, _Failure):
            self._eof = True
            raise item.exc
        batch, event = item
        if event is not None:
            import torch

            stream = torch.cuda.current_stream(self._ring.device)
            stream.wait_event(event)
            for arr in list(batch.data) + list(batch.label or []):
                if isinstance(arr, NDArray) and arr.data.is_cuda:
                    arr.data.record_stream(stream)
        return batch

    def stage_superbatch(self, n):
        """Up to ``n`` staged batches for one ``Module.run_n_steps`` call
        (reference: io.py ``stage_superbatch``): fewer only at the end of
        the epoch; raises ``StopIteration`` when the epoch has no batch
        left."""
        batches = []
        while len(batches) < n:
            try:
                batches.append(self.next())
            except StopIteration:
                break
        if not batches:
            raise StopIteration
        return batches

    def iter_next(self):
        raise NotImplementedError(
            "DevicePrefetchIter supports the next() protocol only")
