"""Data descriptors, batches and iterators (reference: mxnet_tpu/io.py:
``DataDesc``, ``DataBatch``, ``DataIter`` and ``NDArrayIter``).

An iterator's batches are host (CPU) NDArrays; the executor moves each fed
array to its device (:func:`mxnet_tpu_torch.executor._fed_tensor`). The
reference's other iterators (CSV, MNIST, image and RecordIO, prefetching and
device staging) are not ported yet.
"""
from __future__ import annotations

import collections

import numpy as np

from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


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

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            sel = self.idx[self.cursor:self.cursor + self.batch_size]
        else:
            pad = self.batch_size - self.num_data + self.cursor
            sel = np.concatenate([self.idx[self.cursor:], self.idx[:pad]])
        return [array(x[sel], cpu()) for _, x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0
