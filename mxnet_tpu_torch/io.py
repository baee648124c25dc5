"""Data descriptors and batches (reference: mxnet_tpu/io.py, ``DataDesc`` and
``DataBatch``). The iterators (``NDArrayIter`` and the rest) are not ported
yet; a training loop builds its ``DataBatch`` itself."""
from __future__ import annotations

import collections

import numpy as np

__all__ = ["DataDesc", "DataBatch"]


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
