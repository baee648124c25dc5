"""Data loaders for the image-classification examples (reference:
example/image-classification/common/data.py)."""
from __future__ import annotations

import os

import numpy as np

import mxnet_tpu_torch as mx


def add_data_args(parser):
    data = parser.add_argument_group("Data", "the input data")
    data.add_argument("--data-train", type=str, help="training record file")
    data.add_argument("--data-val", type=str, help="validation record file")
    data.add_argument("--image-shape", type=str, default="3,224,224")
    data.add_argument("--num-classes", type=int, default=1000)
    data.add_argument("--num-examples", type=int, default=1281167)
    data.add_argument("--rgb-mean", type=str, default="123.68,116.779,103.939")
    data.add_argument("--data-nthreads", type=int, default=4)
    data.add_argument("--pad-size", type=int, default=0)
    return data


def add_data_aug_args(parser):
    aug = parser.add_argument_group("Augmentation", "image augmentations")
    aug.add_argument("--random-crop", type=int, default=1)
    aug.add_argument("--random-mirror", type=int, default=1)
    aug.add_argument("--max-random-h", type=int, default=0)
    aug.add_argument("--max-random-s", type=int, default=0)
    aug.add_argument("--max-random-l", type=int, default=0)
    aug.add_argument("--max-random-aspect-ratio", type=float, default=0)
    aug.add_argument("--max-random-rotate-angle", type=int, default=0)
    aug.add_argument("--max-random-shear-ratio", type=float, default=0)
    aug.add_argument("--max-random-scale", type=float, default=1)
    aug.add_argument("--min-random-scale", type=float, default=1)
    return aug


class SyntheticDataIter(mx.io.DataIter):
    """One random host batch, ``max_iter`` times an epoch (``--benchmark
    1``)."""

    def __init__(self, num_classes, data_shape, max_iter, dtype="float32"):
        super().__init__(data_shape[0])
        self.batch_size = data_shape[0]
        self.cur_iter = 0
        self.max_iter = max_iter
        self.data_shape = data_shape
        rng = np.random.RandomState(0)
        label = rng.randint(0, num_classes, self.batch_size)
        data = rng.uniform(-1, 1, data_shape).astype(np.float32)
        self._batch = mx.io.DataBatch(
            data=[mx.nd.array(data, mx.cpu())],
            label=[mx.nd.array(label.astype(np.float32), mx.cpu())],
            provide_data=self.provide_data,
            provide_label=self.provide_label)

    @property
    def provide_data(self):
        return [mx.io.DataDesc("data", self.data_shape)]

    @property
    def provide_label(self):
        return [mx.io.DataDesc("softmax_label", (self.batch_size,))]

    def next(self):
        self.cur_iter += 1
        if self.cur_iter > self.max_iter:
            raise StopIteration
        return self._batch

    def reset(self):
        self.cur_iter = 0


def get_rec_iter(args, kv=None):
    """The training and validation ``ImageIter``s over RecordIO files
    (reference: common/data.py ``get_rec_iter``, the same call: random crop
    and mirror, shuffled; like the reference it passes no
    ``preprocess_threads``, so ``--data-nthreads`` is not read)."""
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    if args.benchmark:
        shape = (args.batch_size,) + image_shape
        return SyntheticDataIter(args.num_classes, shape, 500), None
    rank, nworker = (kv.rank, kv.num_workers) if kv else (0, 1)
    idx = os.path.splitext(args.data_train)[0] + ".idx"
    train = mx.image.ImageIter(
        batch_size=args.batch_size, data_shape=image_shape,
        path_imgrec=args.data_train,
        path_imgidx=idx if os.path.exists(idx) else None,
        shuffle=True, part_index=rank, num_parts=nworker,
        rand_crop=bool(args.random_crop),
        rand_mirror=bool(args.random_mirror))
    val = None
    if args.data_val:
        val = mx.image.ImageIter(
            batch_size=args.batch_size, data_shape=image_shape,
            path_imgrec=args.data_val, shuffle=False,
            part_index=rank, num_parts=nworker)
    return train, val
