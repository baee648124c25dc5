"""RNN data iterators (reference: mxnet_tpu/rnn/io.py).

The batches are CPU NDArrays; the executor copies each to its device when
it is fed. The reference's global ``random`` and ``np.random`` draw the
shuffles, so both packages give the same batches under the same seeds."""
from __future__ import annotations

import random

import numpy as np

from ..context import cpu
from ..io import DataIter, DataBatch, DataDesc
from .. import ndarray as nd

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0):
    """Map token sentences to int arrays, building a vocab
    (reference: rnn/io.py encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab, f"Unknown token {word}"
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketed iterator over encoded sentences (reference: rnn/io.py BucketSentenceIter)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32"):
        super().__init__(batch_size)
        if not buckets:
            buckets = [i for i, j in enumerate(np.bincount(
                [len(s) for s in sentences])) if j >= batch_size]
        buckets.sort()

        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.default_bucket_key = max(buckets)

        self.provide_data = [DataDesc(data_name,
                                      (batch_size, self.default_bucket_key))]
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, self.default_bucket_key))]
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd.array(buck, cpu(), dtype=self.dtype))
            self.ndlabel.append(nd.array(label, cpu(), dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape)],
                         provide_label=[DataDesc(self.label_name, label.shape)])
