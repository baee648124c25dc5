"""Image decoding, augmentation and ``ImageIter`` (reference:
mxnet_tpu/image.py).

``imdecode`` decodes JPEGs through the host library's libjpeg
(``src/im2rec.cc``, built by :func:`mxnet_tpu_torch._native.host_lib` where
libjpeg links) and every other image, or every image on a host without
libjpeg, through PIL. :data:`ROUTES` counts the decodes each route made in
this process (:func:`decode_route` names the route JPEGs take here).
``ImageIter`` reads RecordIO packs or image lists, applies the reference's
augmenter chain on the host and emits CPU batches, NCHW or NHWC, float32 or
uint8; with ``preprocess_threads > 0`` a pool of spawned worker processes
decodes whole batches into shared-memory slots. Batches are host
NDArrays: ``io.DevicePrefetchIter`` or the executor's feed moves them to
the card.
"""
from __future__ import annotations

import collections
import os
import random

import numpy as np

from . import _native
from . import recordio
from .base import MXNetError
from .io import DataIter, DataBatch, DataDesc
from .ndarray import NDArray

__all__ = ["imdecode", "imresize", "scale_down", "resize_short", "center_crop",
           "random_crop", "color_normalize", "HorizontalFlipAug", "CastAug",
           "CreateAugmenter", "ImageIter", "decode_route", "ROUTES"]

# decodes made in this process, by route ("libjpeg", "pil")
ROUTES: collections.Counter = collections.Counter()


def decode_route():
    """The route a JPEG takes through :func:`imdecode` on this host:
    ``"libjpeg"`` (the host library) or ``"pil"``."""
    return "libjpeg" if _native.host_has_jpeg() else "pil"


def imdecode(buf, flag=1, to_rgb=True, min_size=0):
    """Decode an encoded image to an HWC uint8 array, RGB unless
    ``to_rgb`` is false (reference: image.py ``imdecode``). A colour JPEG
    takes libjpeg where the host library has it; other images, and a JPEG
    libjpeg refuses (arithmetic coding), take PIL, as in the reference.

    ``min_size > 0`` decodes a JPEG on the libjpeg route at the coarsest
    1/1-1/8 scale whose shorter edge stays >= ``min_size`` (``ImageIter``
    passes it when its chain starts with a shorter-edge resize); PIL
    decodes at full size."""
    data = buf if isinstance(buf, bytes) else bytes(buf)
    if flag == 1 and len(data) > 3 and data[0] == 0xFF and data[1] == 0xD8:
        arr = _imdecode_native(data, min_size)
        if arr is not None:
            ROUTES["libjpeg"] += 1
            return arr if to_rgb else arr[:, :, ::-1]
    ROUTES["pil"] += 1
    from io import BytesIO

    from PIL import Image

    img = Image.open(BytesIO(data))
    if flag == 0:
        img = img.convert("L")
        arr = np.asarray(img)[:, :, None]
    else:
        img = img.convert("RGB")
        arr = np.asarray(img)
        if not to_rgb:
            arr = arr[:, :, ::-1]
    return arr


def _imdecode_native(data, min_size=0):
    import ctypes

    if not _native.host_has_jpeg():
        return None
    lib = _native.host_lib()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    if min_size > 0:
        rc = lib.mxtpu_jpeg_decode_minsize(
            data, len(data), int(min_size), ctypes.byref(w),
            ctypes.byref(h), ctypes.byref(ptr))
    else:
        rc = lib.mxtpu_jpeg_decode(data, len(data), ctypes.byref(w),
                                   ctypes.byref(h), ctypes.byref(ptr))
    if rc != 0:
        return None   # refused by libjpeg: PIL gets a try
    try:
        arr = np.ctypeslib.as_array(
            ptr, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.mxtpu_buf_free(ptr)
    return arr


def imresize(src, w, h, interp=2):
    """Bilinear resize of an HWC uint8 image to ``w`` x ``h`` with PIL."""
    from PIL import Image

    arr = np.asarray(src).astype(np.uint8)
    squeeze = arr.shape[-1] == 1
    img = Image.fromarray(arr[:, :, 0] if squeeze else arr)
    out = np.asarray(img.resize((w, h), Image.BILINEAR))
    return out[:, :, None] if squeeze else out


def scale_down(src_size, size):
    """Scale size down to fit in src_size (reference: image.py scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so the shorter edge = size (reference: image.py resize_short)."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, min_area, ratio, interp=2):
    """Random-area, random-aspect crop resized to `size` (reference:
    image.py:99 random_size_crop — the inception-style crop). Falls back
    to plain random_crop when the area constraint can't be met."""
    h, w = src.shape[:2]
    new_ratio = random.uniform(*ratio)
    if new_ratio * h > w:
        max_area = w * int(w / new_ratio)
    else:
        max_area = h * int(h * new_ratio)
    min_area = min_area * h * w
    if max_area < min_area:
        return random_crop(src, size, interp)
    new_area = random.uniform(min_area, max_area)
    new_w = min(w, int(np.sqrt(new_area * new_ratio)))
    new_h = min(h, int(np.sqrt(new_area / new_ratio)))
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src.astype(np.float32) - mean
    if std is not None:
        src = src / std
    return src


class Augmenter:
    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    """Inception-style crop (reference: image.py RandomSizedCropAug)."""

    def __init__(self, size, min_area, ratio, interp=2):
        self.size = size
        self.min_area = min_area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.min_area, self.ratio,
                                self.interp)[0]


class RandomOrderAug(Augmenter):
    """Apply child augmenters in a fresh random order per image
    (reference: image.py RandomOrderAug)."""

    def __init__(self, ts):
        self.ts = list(ts)

    def __call__(self, src):
        order = list(self.ts)
        random.shuffle(order)
        for t in order:
            src = t(src)
        return src


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            return src[:, ::-1]
        return src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
        return np.clip(src.astype(np.float32) * alpha, 0, 255)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
        coef = np.array([0.299, 0.587, 0.114])
        src = src.astype(np.float32)
        gray = (src * coef[None, None, :src.shape[2]]).sum() * (
            3.0 / src.size)
        return np.clip(src * alpha + gray * (1.0 - alpha), 0, 255)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
        coef = np.array([0.299, 0.587, 0.114])
        src = src.astype(np.float32)
        gray = (src * coef[None, None, :src.shape[2]]).sum(
            axis=2, keepdims=True)
        return np.clip(src * alpha + gray * (1.0 - alpha), 0, 255)


def ColorJitterAug(brightness, contrast, saturation):
    """Brightness/contrast/saturation jitter in random order (reference:
    image.py ColorJitterAug): returns a RandomOrderAug over the enabled
    jitter augmenters."""
    ts = []
    if brightness > 0:
        ts.append(BrightnessJitterAug(brightness))
    if contrast > 0:
        ts.append(ContrastJitterAug(contrast))
    if saturation > 0:
        ts.append(SaturationJitterAug(saturation))
    return RandomOrderAug(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise (reference: image.py LightingAug):
    adds eigvec @ (alpha * eigval) with alpha ~ N(0, alphastd) per image."""

    def __init__(self, alphastd, eigval, eigvec):
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return src.astype(np.float32) + rgb.astype(np.float32)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32) if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(src.astype(np.float32), self.mean, self.std)


class CastAug(Augmenter):
    def __call__(self, src):
        return src.astype(np.float32)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, inter_method=2):
    """Default augmenter chain (reference: image.py CreateAugmenter /
    src/io/image_aug_default.cc)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if contrast:
        auglist.append(ContrastJitterAug(contrast))
    if saturation:
        auglist.append(SaturationJitterAug(saturation))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ---------------------------------------------------------------------------
# The decode pool (reference: image.py's spawned workers). Python threads
# cannot decode in parallel under the interpreter lock, so the workers are
# processes started with spawn (the parent runs CUDA and other threads, and
# fork would copy their state). Each worker opens the record file itself,
# decodes and augments whole batches into a shared-memory slot and returns
# only the count, so the pixels never cross a pipe. Workers import the
# package but never touch CUDA.
_WORKER: dict = {}


def _parse_imglist(path_imglist):
    """A ``.lst`` file as ``{index: (label array, relative path)}``
    (``tools/im2rec.py`` writes this format)."""
    imglist = {}
    with open(path_imglist) as fin:
        for line in fin:
            parts = line.strip().split("\t")
            label = np.array([float(p) for p in parts[1:-1]], np.float32)
            imglist[int(parts[0])] = (label, parts[-1])
    return imglist


def _augment_hwc(arr, auglist, h, w):
    """One decoded image through the augmenter chain, checked to come out
    ``h`` x ``w``: the one implementation behind the serial path and the
    pool."""
    for aug in auglist:
        arr = aug(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[:2] != (h, w):
        raise MXNetError(f"augmented image shape {arr.shape} != {(h, w)}")
    return arr


def _decode_hint(auglist):
    """The scaled-decode ``min_size``: the target of a leading shorter-edge
    resize (:class:`ResizeAug`), else 0 (any other first augmenter sees the
    image at its full size)."""
    if auglist and type(auglist[0]) is ResizeAug:
        return int(auglist[0].size)
    return 0


def _decode_sample(rec, imglist, path_root, idx, auglist, h, w,
                   min_size=0):
    """One record or listed file as ``(label, augmented HWC image)``."""
    if rec is not None:
        header, img = recordio.unpack(rec.read_idx(idx))
        lab, arr = header.label, imdecode(img, min_size=min_size)
    else:
        lab, fname = imglist[idx]
        with open(os.path.join(path_root, fname), "rb") as f:
            arr = imdecode(f.read(), min_size=min_size)
    return lab, _augment_hwc(arr, auglist, h, w)


def _decode_worker_init(path_imgrec, path_imgidx, path_imglist, imglist,
                        path_root, data_shape, label_width, auglist, seed,
                        layout="NCHW", pixel_dtype="<f4"):
    random.seed(seed ^ os.getpid())
    np.random.seed((seed ^ os.getpid()) % (2 ** 31))
    rec = None
    if path_imgrec is not None:
        rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
    if path_imglist is not None:
        # parsed here: under spawn a large list would be pickled into every
        # worker
        imglist = _parse_imglist(path_imglist)
    _WORKER.update(rec=rec, imglist=imglist, path_root=path_root,
                   data_shape=tuple(data_shape), label_width=label_width,
                   auglist=auglist, layout=layout,
                   pixel_dtype=np.dtype(pixel_dtype))


def _decode_batch(indices, shm_name, batch_size):
    """Decode and augment the records ``indices`` into the shared-memory
    slot ``shm_name``: the pixels in the chain's output dtype (uint8 when
    the float cast is left to the consumer), then ``(batch_size,
    label_width)`` float32 labels. Returns the count and the decodes by
    route."""
    from multiprocessing import shared_memory

    c, h, w = _WORKER["data_shape"]
    lw = _WORKER["label_width"]
    auglist = _WORKER["auglist"]
    nhwc = _WORKER["layout"] == "NHWC"
    before = collections.Counter(ROUTES)
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        shape = (batch_size, h, w, c) if nhwc else (batch_size, c, h, w)
        data = np.ndarray(shape, _WORKER["pixel_dtype"], buffer=shm.buf)
        label = np.ndarray((batch_size, lw), np.float32,
                           buffer=shm.buf, offset=data.nbytes)
        for i, idx in enumerate(indices):
            lab, arr = _decode_sample(_WORKER["rec"], _WORKER["imglist"],
                                      _WORKER["path_root"], idx, auglist,
                                      h, w, min_size=_decode_hint(auglist))
            data[i] = arr if nhwc else np.transpose(arr, (2, 0, 1))
            label[i] = np.asarray(lab, np.float32).reshape(-1)[:lw]
        del data, label   # no view of the buffer may outlive close()
    finally:
        shm.close()
    return len(indices), dict(ROUTES - before)


def _host_array(arr):
    """A numpy array that owns its memory as a CPU NDArray, without a
    copy."""
    import torch

    return NDArray(torch.from_numpy(arr))


class ImageIter(DataIter):
    """Batches of decoded, augmented images from a RecordIO pack
    (``path_imgrec``, with ``path_imgidx`` for random access) or an image
    list (reference: image.py ``ImageIter``).

    ``preprocess_threads > 0`` decodes in that many spawned worker
    processes, ``prefetch_buffer`` batches ahead of the consumer, each into
    its own shared-memory slot; it needs random access (an index or a list).
    ``part_index``/``num_parts`` take one contiguous part of the records.
    ``data_shape`` is (C, H, W) whatever the ``layout`` ("NCHW" or "NHWC")
    of the batches; ``dtype`` "uint8" ships raw pixels (the executor casts
    them on the device) and needs a chain that ends in uint8.
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", preprocess_threads=0,
                 prefetch_buffer=4, layout="NCHW", dtype="float32",
                 **kwargs):
        super().__init__(batch_size)
        self.layout = layout
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        if path_imgrec:
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(
                    path_imgidx, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self.imgidx = None
            self.imglist = None
        else:
            self.imgrec = None
            if path_imglist:
                imglist = _parse_imglist(path_imglist)
            else:
                imglist = {i: (np.array([float(item[0])], np.float32), item[1])
                           for i, item in enumerate(imglist)}
            self.imglist = imglist
            self.imgidx = list(imglist.keys())
        self.path_root = path_root
        if self.imgidx is not None and num_parts > 1:
            n = len(self.imgidx)
            per = n // num_parts
            self.imgidx = self.imgidx[part_index * per:(part_index + 1) * per]

        self.shuffle = shuffle
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.auglist = (aug_list if aug_list is not None
                        else CreateAugmenter(data_shape, **kwargs))
        # a trailing CastAug is dropped: crop and flip keep uint8, and the
        # batch takes one cast of the whole batch instead of one an image
        if self.auglist and type(self.auglist[-1]) is CastAug:
            self.auglist = self.auglist[:-1]
        # the chain's output dtype, probed once with the random states put
        # back (a probabilistic augmenter must not shift the seeded stream)
        c, h, w = self.data_shape
        _py_state, _np_state = random.getstate(), np.random.get_state()
        try:
            self._pixel_dtype = np.dtype(_augment_hwc(
                np.zeros((h, w, c), np.uint8), self.auglist, h, w).dtype)
        finally:
            random.setstate(_py_state)
            np.random.set_state(_np_state)
        self.dtype = np.dtype(dtype)
        if self.dtype == np.uint8 and self._pixel_dtype != np.uint8:
            raise MXNetError(
                "dtype='uint8' needs a uint8 augmenter chain, but this one "
                f"produces {self._pixel_dtype} (jitter/normalize augmenters "
                "need floats — drop them or use dtype='float32')")
        self.data_name = data_name
        self.label_name = label_name
        self.cur = 0
        self.seq = list(self.imgidx) if self.imgidx is not None else None

        self._pool = None
        self._pending = None
        self._next_chunk = 0
        self._chunks = []
        if preprocess_threads > 0:
            if self.seq is None:
                raise MXNetError(
                    "preprocess_threads requires path_imgidx (random access) "
                    "or an image list")
            import pickle

            try:
                pickle.dumps(self.auglist)
            except Exception as e:
                raise MXNetError(
                    "preprocess_threads>0 requires picklable augmenters "
                    "(module-level classes/functions, not lambdas or "
                    f"closures): {e}") from e
            self._path_imgrec = path_imgrec
            self._path_imgidx = path_imgidx
            self._path_imglist = path_imglist
            self._n_workers = preprocess_threads
            self._prefetch_buffer = max(1, prefetch_buffer)
        else:
            self._n_workers = 0
        self.reset()

    # -- the decode pool ------------------------------------------------------
    def _ensure_pool(self):
        if self._pool is not None:
            return
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        from multiprocessing import shared_memory

        _native.host_lib()   # built once here, not by each worker
        self._pool = ProcessPoolExecutor(
            max_workers=self._n_workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_decode_worker_init,
            initargs=(self._path_imgrec, self._path_imgidx,
                      self._path_imglist,
                      None if self._path_imglist else self.imglist,
                      self.path_root, self.data_shape, self.label_width,
                      self.auglist, random.randint(0, 2 ** 30), self.layout,
                      self._pixel_dtype.str))
        c, h, w = self.data_shape
        nbytes = self.batch_size * (c * h * w * self._pixel_dtype.itemsize
                                    + 4 * self.label_width)
        self._slots = [shared_memory.SharedMemory(create=True, size=nbytes)
                       for _ in range(self._prefetch_buffer)]
        self._free_slots = list(range(len(self._slots)))

    def _schedule_epoch(self):
        bs = self.batch_size
        self._chunks = [self.seq[i:i + bs]
                        for i in range(0, len(self.seq), bs)]
        self._next_chunk = 0
        if self._pending:
            # a window left by a reset in mid-epoch: wait for it, so that
            # no worker still writes into a slot handed out again
            for fut, slot in self._pending:
                fut.cancel()
                if not fut.cancelled():
                    try:
                        fut.result()
                    except Exception:   # the batch is dropped either way
                        pass
                self._free_slots.append(slot)
        self._pending = collections.deque()
        self._fill_window()

    def _fill_window(self):
        self._ensure_pool()
        while self._free_slots and self._next_chunk < len(self._chunks):
            slot = self._free_slots.pop()
            self._pending.append(
                (self._pool.submit(_decode_batch,
                                   self._chunks[self._next_chunk],
                                   self._slots[slot].name, self.batch_size),
                 slot))
            self._next_chunk += 1

    def close(self):
        """Stop the decode pool and free its shared memory; ``next`` then
        raises StopIteration until ``reset``."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            for shm in self._slots:
                shm.close()
                shm.unlink()
            self._slots = []
            self._free_slots = []
            self._pending = None
            self._chunks = []

    def __del__(self):
        try:
            self.close()
        except Exception:   # interpreter shutdown
            pass

    @property
    def provide_data(self):
        c, h, w = self.data_shape
        shape = (h, w, c) if self.layout == "NHWC" else (c, h, w)
        return [DataDesc(self.data_name, (self.batch_size,) + shape,
                         dtype=self.dtype, layout=self.layout)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        if self.shuffle and self.seq is not None:
            random.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0
        if self._n_workers:
            self._schedule_epoch()

    def next_sample(self):
        """The next ``(label, decoded image)`` (reference: image.py
        ``next_sample``)."""
        min_size = _decode_hint(self.auglist)
        if self.seq is not None and self.imglist is None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            header, img = recordio.unpack(self.imgrec.read_idx(idx))
            return header.label, imdecode(img, min_size=min_size)
        if self.imgrec is not None:
            s = self.imgrec.read()
            if s is None:
                raise StopIteration
            header, img = recordio.unpack(s)
            return header.label, imdecode(img, min_size=min_size)
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root, fname), "rb") as f:
            img = imdecode(f.read(), min_size=min_size)
        return label, img

    def _batch(self, data, label, pad, nhwc_source):
        """A DataBatch of host NDArrays from the decoded pixels (HWC per
        image when ``nhwc_source``, else already in the layout) and the
        ``(batch, label_width)`` labels: cast and transpose in one pass
        into fresh memory."""
        b = self.batch_size
        c, h, w = self.data_shape
        if nhwc_source and self.layout != "NHWC":
            out = np.empty((b, c, h, w), self.dtype)
            out[...] = np.transpose(data, (0, 3, 1, 2))
        else:
            out = data.astype(self.dtype)   # always a copy
        label_out = np.array(label[:, 0] if self.label_width == 1 else label,
                             np.float32)
        return DataBatch([_host_array(out)], [_host_array(label_out)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def _next_parallel(self):
        """The oldest batch of the window, copied out of its slot before
        the slot goes back to the pool, and the window topped up."""
        if not self._pending:
            raise StopIteration
        fut, slot = self._pending.popleft()
        try:
            n, routes = fut.result()
        except Exception:
            self._free_slots.append(slot)
            self._fill_window()
            raise
        ROUTES.update(routes)
        c, h, w = self.data_shape
        shm = self._slots[slot]
        shape = ((self.batch_size, h, w, c) if self.layout == "NHWC"
                 else (self.batch_size, c, h, w))
        data = np.ndarray(shape, self._pixel_dtype, buffer=shm.buf)
        label = np.ndarray((self.batch_size, self.label_width), np.float32,
                           buffer=shm.buf, offset=data.nbytes)
        pad = self.batch_size - n
        if pad:
            data[n:] = 0
            label[n:] = 0.0
        batch = self._batch(data, label, pad, nhwc_source=False)
        self._free_slots.append(slot)
        self._fill_window()
        return batch

    # -- the decode-plan protocol of io.PrefetchingIter's thread pool ---------
    def decode_plan(self):
        """One batch's records a work item; None without random access, or
        when the process pool already decodes in parallel."""
        if self.seq is None or self._n_workers:
            return None
        bs = self.batch_size
        return [self.seq[i:i + bs] for i in range(0, len(self.seq), bs)]

    def decode_work(self, chunk, tls):
        """Decode and augment one batch; thread-safe, each thread reading
        through its own clone of the record file."""
        rec = None
        if self.imgrec is not None:
            rec = tls.get("rec")
            if rec is None:
                rec = tls["rec"] = self.imgrec.clone()
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, h, w, c), self._pixel_dtype)
        batch_label = np.zeros((self.batch_size, self.label_width),
                               np.float32)
        min_size = _decode_hint(self.auglist)
        for i, idx in enumerate(chunk):
            lab, arr = _decode_sample(rec, self.imglist, self.path_root,
                                      idx, self.auglist, h, w,
                                      min_size=min_size)
            batch_data[i] = arr
            batch_label[i] = np.asarray(lab, np.float32).reshape(-1)[
                :self.label_width]
        return self._batch(batch_data, batch_label,
                           self.batch_size - len(chunk), nhwc_source=True)

    def next(self):
        if self._n_workers:
            return self._next_parallel()
        c, h, w = self.data_shape
        # the batch in the chain's output dtype: uint8 copies an image at a
        # quarter of the bytes, and the float cast is one pass at the end
        batch_data = np.zeros((self.batch_size, h, w, c), self._pixel_dtype)
        batch_label = np.zeros((self.batch_size, self.label_width), np.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, data = self.next_sample()
                batch_data[i] = _augment_hwc(data, self.auglist, h, w)
                batch_label[i] = np.asarray(label, np.float32).reshape(-1)[
                    :self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        return self._batch(batch_data, batch_label, self.batch_size - i,
                           nhwc_source=True)
