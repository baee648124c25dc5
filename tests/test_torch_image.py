"""The port's image module against the JAX package's, on the CPU: ``imdecode``
on the libjpeg route (the port's host library against the JAX package's
native library, with the ``min_size`` scaled decode) and on the PIL route;
every augmenter and ``CreateAugmenter`` under the same ``random`` and
``np.random`` seeds (geometry exact, colour within 1e-6: both run the same
float32 numpy arithmetic, so the readings are 0); ``ImageIter`` batches
over a RecordIO file and an image list (serial, NCHW and NHWC, float32 and
uint8, shuffled and augmented under seeded generators) equal to the JAX
package's; the decode pool equal to the serial path; and ``nd.imdecode``."""
import os
import random
from io import BytesIO

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import image as jimage
from mxnet_tpu_torch import _native
from mxnet_tpu_torch import image as timage

COLOUR_TOL = 1e-6


def _jpeg(arr, quality=90, **kw):
    buf = BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality, **kw)
    return buf.getvalue()


def _png(arr):
    buf = BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _smooth(h, w, seed=0):
    """A photo-like HWC uint8 image: a coarse random grid, upsampled."""
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    base = np.asarray(Image.fromarray(grid).resize((w, h), Image.BILINEAR),
                      np.float32)
    return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(
        np.uint8)


def test_host_library_decodes_jpeg():
    """This host links libjpeg: the port's host library carries the JPEG
    functions, as the JAX package's does."""
    from mxnet_tpu.utils import nativelib

    assert _native.host_has_jpeg() == hasattr(nativelib.get_lib(),
                                              "mxtpu_jpeg_decode")
    assert timage.decode_route() == "libjpeg"


@pytest.mark.parametrize("route", ["libjpeg", "pil"])
@pytest.mark.parametrize("min_size", [0, 60, 130])
@pytest.mark.parametrize("to_rgb", [True, False])
def test_imdecode_matches_reference(route, min_size, to_rgb, monkeypatch):
    """A 260 x 300 JPEG, the scaled decode keeping the shorter edge >=
    ``min_size`` on the libjpeg route (1/4 and 1/2 here; PIL decodes at
    full size), counted by route."""
    if route == "pil":
        monkeypatch.setattr(_native, "host_has_jpeg", lambda: False)
        monkeypatch.setattr(jimage, "_imdecode_native", lambda *a: None)
    data = _jpeg(_smooth(260, 300))
    before = timage.ROUTES[route]
    got = timage.imdecode(data, to_rgb=to_rgb, min_size=min_size)
    want = jimage.imdecode(data, to_rgb=to_rgb, min_size=min_size)
    assert timage.ROUTES[route] == before + 1
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if route == "libjpeg" and min_size:
        assert min(got.shape[:2]) >= min_size
        assert got.shape[:2] == ({60: (65, 75), 130: (130, 150)}[min_size])


@pytest.mark.parametrize("make,flag", [
    (lambda a: _png(a), 1), (lambda a: _png(a), 0),
    (lambda a: _jpeg(a), 0),
    (lambda a: _jpeg(a, progressive=True), 1),
    (lambda a: _png(np.ascontiguousarray(a[:, :, 0])), 1)])
def test_imdecode_other_images_match_reference(make, flag):
    """PNG, grayscale output, a progressive JPEG and a one-channel source."""
    data = make(_smooth(33, 47, seed=1))
    got = timage.imdecode(data, flag=flag)
    want = jimage.imdecode(data, flag=flag)
    np.testing.assert_array_equal(got, want)
    assert got.shape[2] == (3 if flag else 1)


def _augmenters(pkg):
    img = pkg.image
    return {
        "resize": img.ResizeAug(20),
        "force_resize": img.ForceResizeAug((17, 23)),
        "random_crop": img.RandomCropAug((16, 12)),
        "random_crop_upscale": img.RandomCropAug((40, 50)),
        "center_crop": img.CenterCropAug((16, 12)),
        "random_sized_crop": img.RandomSizedCropAug((16, 16), 0.3,
                                                    (0.75, 1.33)),
        "flip": img.HorizontalFlipAug(0.5),
        "cast": img.CastAug(),
        "brightness": img.BrightnessJitterAug(0.4),
        "contrast": img.ContrastJitterAug(0.4),
        "saturation": img.SaturationJitterAug(0.4),
        "color_jitter": img.ColorJitterAug(0.3, 0.3, 0.3),
        "lighting": img.LightingAug(0.1, [55.46, 4.794, 1.148],
                                    [[-0.5675, 0.7192, 0.4009],
                                     [-0.5808, -0.0045, -0.8140],
                                     [-0.5836, -0.6948, 0.4203]]),
        "normalize": img.ColorNormalizeAug([123.68, 116.28, 103.53],
                                           [58.395, 57.12, 57.375]),
    }


@pytest.mark.parametrize("name", list(_augmenters(mxt)))
def test_augmenters_match_reference(name):
    """Eight draws of each augmenter under one seed of ``random`` and
    ``np.random`` in both packages."""
    src = _smooth(30, 25, seed=2)
    out = {}
    for pkg in (mxt, mxj):
        aug = _augmenters(pkg)[name]
        random.seed(5)
        np.random.seed(5)
        out[pkg] = [np.asarray(aug(src)) for _ in range(8)]
    for got, want in zip(out[mxt], out[mxj]):
        assert got.shape == want.shape and got.dtype == want.dtype
        if got.dtype == np.uint8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=COLOUR_TOL)


@pytest.mark.parametrize("kwargs", [
    {}, dict(resize=36, rand_crop=True, rand_mirror=True),
    dict(rand_crop=True, mean=True, std=True),
    dict(brightness=0.2, contrast=0.2, saturation=0.2, mean=np.ones(3))])
def test_create_augmenter_matches_reference(kwargs):
    chains = [timage.CreateAugmenter((3, 24, 24), **kwargs),
              jimage.CreateAugmenter((3, 24, 24), **kwargs)]
    assert [type(a).__name__ for a in chains[0]] \
        == [type(a).__name__ for a in chains[1]]
    src = _smooth(40, 32, seed=3)
    outs = []
    for chain in chains:
        random.seed(1)
        np.random.seed(1)
        x = src
        for aug in chain:
            x = aug(x)
        outs.append(np.asarray(x))
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=COLOUR_TOL)


def _rec(tmp_path, n=22, seed=4):
    """``n`` JPEG records of photo-like images of 30-44 px, label i % 3,
    keys 0..n-1."""
    rng = np.random.default_rng(seed)
    rec, idx = str(tmp_path / "data.rec"), str(tmp_path / "data.idx")
    w = mxt.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        h, wd = (int(rng.integers(30, 45)) for _ in range(2))
        w.write_idx(i, mxt.recordio.pack(
            mxt.recordio.IRHeader(0, float(i % 3), i, 0),
            _jpeg(_smooth(h, wd, seed=100 + i))))
    w.close()
    return rec, idx


def _batches(pkg, seed=0, **kwargs):
    random.seed(seed)
    np.random.seed(seed)
    it = pkg.image.ImageIter(**kwargs)
    out = []
    for _ in range(2):   # two epochs: reset reshuffles
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return out, it


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("aug", [
    dict(shuffle=False), dict(shuffle=True, rand_crop=True, rand_mirror=True),
    dict(shuffle=True, resize=28)])
@pytest.mark.parametrize("indexed", [True, False])
def test_image_iter_matches_reference(tmp_path, layout, dtype, aug, indexed):
    """Two epochs of 4-image batches over 22 records (a padded last
    batch), serial; without an index the file is read in order (no
    shuffle)."""
    rec, idx = _rec(tmp_path)
    if not indexed:
        aug = dict(aug, shuffle=False)
    kwargs = dict(batch_size=4, data_shape=(3, 24, 24), path_imgrec=rec,
                  path_imgidx=idx if indexed else None, layout=layout,
                  dtype=dtype, **aug)
    got, t_it = _batches(mxt, **kwargs)
    want, _ = _batches(mxj, **kwargs)
    assert t_it.provide_data[0].shape == ((4, 3, 24, 24) if layout == "NCHW"
                                          else (4, 24, 24, 3))
    assert len(got) == len(want) == 12
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.dtype == wd.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp
    assert got[5][2] == 2 and got[0][2] == 0


def test_image_iter_from_list_matches_reference(tmp_path):
    """An image list (``.lst`` of index, label, path) over files under
    ``path_root``, and an in-memory ``imglist``, with label_width 2."""
    root = tmp_path / "imgs"
    root.mkdir()
    lines = []
    for i in range(7):
        Image.fromarray(_smooth(30 + i, 28, seed=i)).save(root / f"{i}.png")
        lines.append(f"{i}\t{i % 2}\t{i * 0.5}\t{i}.png\n")
    lst = tmp_path / "data.lst"
    lst.write_text("".join(lines))
    for kwargs in (dict(path_imglist=str(lst), label_width=2),
                   dict(imglist=[[i % 2, f"{i}.png"] for i in range(7)])):
        got, _ = _batches(mxt, batch_size=3, data_shape=(3, 20, 20),
                          path_root=str(root), shuffle=True, rand_crop=True,
                          **kwargs)
        want, _ = _batches(mxj, batch_size=3, data_shape=(3, 20, 20),
                           path_root=str(root), shuffle=True, rand_crop=True,
                           **kwargs)
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp


def test_image_iter_parts_and_refusals(tmp_path):
    rec, idx = _rec(tmp_path)
    it = timage.ImageIter(4, (3, 24, 24), path_imgrec=rec, path_imgidx=idx,
                          part_index=1, num_parts=3)
    ref = jimage.ImageIter(4, (3, 24, 24), path_imgrec=rec, path_imgidx=idx,
                           part_index=1, num_parts=3)
    assert it.seq == ref.seq == list(range(7, 14))
    with pytest.raises(mxt.MXNetError, match="uint8"):
        timage.ImageIter(4, (3, 24, 24), path_imgrec=rec, path_imgidx=idx,
                         dtype="uint8", mean=True)
    with pytest.raises(mxt.MXNetError, match="path_imgidx"):
        timage.ImageIter(4, (3, 24, 24), path_imgrec=rec,
                         preprocess_threads=2)
    with pytest.raises(mxt.MXNetError, match="picklable"):
        timage.ImageIter(4, (3, 24, 24), path_imgrec=rec, path_imgidx=idx,
                         preprocess_threads=2, aug_list=[lambda x: x])


@pytest.mark.parametrize("layout,dtype", [("NCHW", "float32"),
                                          ("NHWC", "uint8")])
def test_decode_pool_matches_serial(tmp_path, layout, dtype):
    """Two spawned workers decode the batches into shared memory: equal to
    the serial path's (no random augmentation), over two epochs, a reset in
    mid-epoch, and their decodes counted by route in this process."""
    rec, idx = _rec(tmp_path)
    kwargs = dict(batch_size=4, data_shape=(3, 24, 24), path_imgrec=rec,
                  path_imgidx=idx, resize=26, layout=layout, dtype=dtype)
    serial, _ = _batches(mxt, **kwargs)
    before = sum(timage.ROUTES.values())
    pooled, it = _batches(mxt, preprocess_threads=2, prefetch_buffer=3,
                          **kwargs)
    assert sum(timage.ROUTES.values()) == before + 2 * 22
    for (gd, gl, gp), (wd, wl, wp) in zip(pooled, serial):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp
    it.next()
    it.reset()
    np.testing.assert_array_equal(it.next().data[0].asnumpy(), serial[0][0])
    it.close()
    with pytest.raises(StopIteration):
        it.next()


def test_nd_imdecode_matches_reference():
    data = _jpeg(_smooth(20, 24, seed=6))
    ctx = mxt.cpu()
    got = mxt.nd.imdecode(data, ctx=ctx)
    want = mxj.nd.imdecode(data)
    assert got.context == ctx and got.dtype == mxt.nd.array(
        np.zeros(1, np.uint8), ctx, dtype="uint8").dtype
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    mean = np.array([10.0, 20.0, 30.0], np.float32)
    got = mxt.nd.imdecode(data, clip_rect=(2, 3, 14, 11), mean=mean, ctx=ctx)
    want = mxj.nd.imdecode(data, clip_rect=(2, 3, 14, 11), mean=mean)
    assert got.shape == (8, 12, 3)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    out = mxt.nd.zeros((2, 20, 24, 3), ctx)
    mxt.nd.imdecode(data, out=out, index=1)
    np.testing.assert_array_equal(out.asnumpy()[1],
                                  want_full := mxj.nd.imdecode(data).asnumpy())
    assert not out.asnumpy()[0].any() and want_full.shape == (20, 24, 3)
    with pytest.raises(mxt.MXNetError, match="shape"):
        mxt.nd.imdecode(data, out=mxt.nd.zeros((5, 5, 3), ctx))


def test_host_library_rebuilds_from_other_sources(tmp_path, monkeypatch):
    """A library whose hash sidecar names other sources is stale; one whose
    sidecar matches but that cannot load (copied from a host with another
    libjpeg) is rebuilt."""
    monkeypatch.setattr(_native, "HOST_LIB", str(tmp_path / "libh.so"))
    monkeypatch.setattr(_native, "_HOST", {})
    assert _native._host_stale()
    lib = _native.host_lib()
    assert lib is not None and not _native._host_stale()
    # a path this process never loaded (dlopen reuses a loaded one by name)
    monkeypatch.setattr(_native, "HOST_LIB", str(tmp_path / "libcopy.so"))
    monkeypatch.setattr(_native, "_HOST", {})
    with open(_native.HOST_LIB, "wb") as f:
        f.write(b"not a library")
    with open(_native.HOST_LIB + ".hash", "w") as f:
        f.write(_native._host_hash())
    assert not _native._host_stale()
    assert hasattr(_native.host_lib(), "mxtpu_recio_open")
    assert os.path.getsize(_native.HOST_LIB) > 1000
