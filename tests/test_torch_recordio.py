"""The port's RecordIO against the JAX package's: record files and their
``.idx`` written by either package are byte-identical and read back by the
other, sequentially and by key, through the port's native reader and its
file reads; ``pack``/``unpack`` and ``pack_img``/``unpack_img`` give equal
bytes and arrays; and ``mxnet_tpu_torch/tools/im2rec.py`` writes the files
the JAX package's ``tools/im2rec.py`` writes. Every comparison is exact."""
import importlib.util
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import _native
from mxnet_tpu_torch.tools import im2rec as t_im2rec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _payloads(seed=0, n=9):
    """Records of every length mod 4, an empty one among them."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
            for k in [0, 1, 2, 3, 4, 5, 17, 1000, 4097][:n]]


def _write(pkg, tmp_path, name, payloads, indexed):
    rec = str(tmp_path / f"{name}.rec")
    idx = str(tmp_path / f"{name}.idx")
    if indexed:
        w = pkg.recordio.MXIndexedRecordIO(idx, rec, "w")
        for i, p in enumerate(payloads):
            w.write_idx(i * 3 + 1, p)
    else:
        w = pkg.recordio.MXRecordIO(rec, "w")
        for p in payloads:
            w.write(p)
    w.close()
    return rec, idx


def _read_all(pkg, rec):
    r = pkg.recordio.MXRecordIO(rec, "r")
    out = []
    while True:
        s = r.read()
        if s is None:
            break
        out.append(s)
    r.close()
    return out


@pytest.mark.parametrize("indexed", [False, True])
def test_record_files_byte_identical_and_cross_readable(tmp_path, indexed):
    payloads = _payloads()
    t_rec, t_idx = _write(mxt, tmp_path, "port", payloads, indexed)
    j_rec, j_idx = _write(mxj, tmp_path, "ref", payloads, indexed)
    with open(t_rec, "rb") as a, open(j_rec, "rb") as b:
        assert a.read() == b.read()
    if indexed:
        with open(t_idx) as a, open(j_idx) as b:
            assert a.read() == b.read()
    for pkg, rec in ((mxt, j_rec), (mxj, t_rec)):
        assert _read_all(pkg, rec) == payloads
    if indexed:
        for pkg, (rec, idx) in ((mxt, (j_rec, j_idx)), (mxj, (t_rec, t_idx))):
            r = pkg.recordio.MXIndexedRecordIO(idx, rec, "r")
            assert r.keys == [i * 3 + 1 for i in range(len(payloads))]
            for i in reversed(range(len(payloads))):
                assert r.read_idx(i * 3 + 1) == payloads[i]
            r.close()


@pytest.mark.parametrize("native", [True, False])
def test_indexed_reads_native_and_file(tmp_path, monkeypatch, native):
    """``read_idx`` through the host library's mmap reader and through the
    file handle, and from a clone, in any order."""
    payloads = _payloads(1)
    rec, idx = _write(mxj, tmp_path, "ref", payloads, True)
    if not native:
        monkeypatch.setattr(_native, "host_lib", lambda: None)
    r = mxt.recordio.MXIndexedRecordIO(idx, rec, "r")
    order = [4, 0, 8, 2, 2, 7]
    assert [r.read_idx(k * 3 + 1) for k in order] == \
        [payloads[k] for k in order]
    assert (r._native is not None) == native
    c = r.clone()
    assert c.read_idx(3 * 5 + 1) == payloads[5] and c.idx is r.idx
    c.close()
    r.close()


@pytest.mark.parametrize("label,ids", [
    (3.0, (7, 0)), (-1.5, (2 ** 40, 9)),
    (np.array([1.0, 2.5, -3.0], np.float32), (5, 6)), ([0.25, 4.0], (0, 1))])
def test_pack_unpack_match_reference(label, ids):
    payload = b"\x00payload\xff" * 3
    packed = {pkg: pkg.recordio.pack(pkg.recordio.IRHeader(0, label, *ids),
                                     payload) for pkg in (mxt, mxj)}
    assert packed[mxt] == packed[mxj]
    for pkg in (mxt, mxj):
        h, s = pkg.recordio.unpack(packed[mxt])
        assert s == payload and (h.id, h.id2) == ids
        np.testing.assert_array_equal(np.asarray(h.label, np.float32),
                                      np.asarray(label, np.float32))
        assert h.flag == (0 if np.isscalar(label) else len(label))


@pytest.mark.parametrize("fmt,quality", [(".jpg", 95), (".jpg", 60),
                                         (".png", 95)])
def test_pack_img_unpack_img_match_reference(fmt, quality):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (21, 34, 3), dtype=np.uint8)
    header = mxt.recordio.IRHeader(0, 4.0, 11, 0)
    got = mxt.recordio.pack_img(header, img, quality=quality, img_fmt=fmt)
    want = mxj.recordio.pack_img(mxj.recordio.IRHeader(0, 4.0, 11, 0), img,
                                 quality=quality, img_fmt=fmt)
    assert got == want
    (th, t_img), (jh, j_img) = (mxt.recordio.unpack_img(got),
                                mxj.recordio.unpack_img(got))
    np.testing.assert_array_equal(t_img, j_img)
    assert th.label == jh.label == 4.0 and th.id == 11
    if fmt == ".png":
        np.testing.assert_array_equal(t_img, img)


def _reference_im2rec():
    spec = importlib.util.spec_from_file_location(
        "reference_im2rec", os.path.join(ROOT, "tools", "im2rec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(root):
    from PIL import Image

    rng = np.random.default_rng(3)
    for cls in ("cat", "dog"):
        os.makedirs(root / cls)
        for i in range(3):
            h, w = [(30, 44), (50, 26), (32, 32)][i]
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(root / cls / f"{i}.jpg", quality=90)


@pytest.mark.parametrize("opts", [["--resize", "24"], ["--pass-through"],
                                  ["--resize", "24", "--no-native"], []])
def test_im2rec_tool_matches_reference(tmp_path, monkeypatch, opts):
    """The list and the packed files of both tools, byte for byte: the
    host library's threaded packer (resize and re-encode, or bytes as they
    are) and PIL's."""
    _images(tmp_path / "imgs")
    monkeypatch.chdir(tmp_path)
    ref = _reference_im2rec()
    for name, main in (("port", t_im2rec.main), ("ref", None)):
        for extra in (["--list", "--recursive"], opts):
            argv = [name, "imgs", *extra]
            if main is None:
                monkeypatch.setattr(sys, "argv", ["im2rec.py", *argv])
                ref.main()
            else:
                main(argv)
    for ext in (".lst", ".rec", ".idx"):
        with open(tmp_path / f"port{ext}", "rb") as a, \
                open(tmp_path / f"ref{ext}", "rb") as b:
            assert a.read() == b.read(), ext
    r = mxt.recordio.MXIndexedRecordIO(str(tmp_path / "ref.idx"),
                                       str(tmp_path / "ref.rec"), "r")
    labels = [mxt.recordio.unpack(r.read_idx(k))[0].label for k in r.keys]
    assert labels == [0.0] * 3 + [1.0] * 3
