"""RecordIO: packed binary record files (reference: mxnet_tpu/recordio.py).

Each record is ``[magic:u32][length:u32][data][pad to 4 bytes]``;
:class:`MXIndexedRecordIO` adds a text ``.idx`` file of ``key\\tposition``
lines. :class:`IRHeader` packs an image record's flag, label and ids.
Files are byte-identical to the JAX package's in both directions.
Indexed reads go through the host library's mmap-backed reader
(``src/recordio.cc``, :func:`mxnet_tpu_torch._native.host_lib`) where it is
built, and through the file handle otherwise.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import _native
from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A


class _NativeReader:
    """Offset-addressed reads from the mmap of a record file."""

    def __init__(self, lib, uri):
        self._lib = lib
        self._h = lib.mxtpu_recio_open(uri.encode())
        if not self._h:
            raise MXNetError(f"cannot open record file {uri}")

    def read_at(self, pos):
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.mxtpu_recio_read_at(self._h, pos, ctypes.byref(ptr))
        if n < 0:
            raise MXNetError(f"bad record offset {pos}")
        return ctypes.string_at(ptr, n)

    def close(self):
        if self._h:
            self._lib.mxtpu_recio_close(self._h)
            self._h = None


class MXRecordIO:
    """Sequential record reader (``flag="r"``) or writer (``"w"``)
    (reference: recordio.py ``MXRecordIO``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)

    def close(self):
        if self.handle is not None:
            self.handle.close()
            self.handle = None

    def __del__(self):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def write(self, buf: bytes):
        assert self.writable
        self.handle.write(struct.pack("<II", _MAGIC, len(buf)))
        self.handle.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self) -> bytes | None:
        assert not self.writable
        header = self.handle.read(8)
        if len(header) < 8:
            return None
        magic, length = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError(f"{self.uri}: invalid record magic")
        buf = self.handle.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        return buf

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        self.handle.seek(pos)

    def clone(self):
        """A new read handle over the same file: each decode thread reads
        through its own (reference: recordio.py ``clone``)."""
        assert not self.writable, "clone() is read-mode only"
        return MXRecordIO(self.uri, "r")


class MXIndexedRecordIO(MXRecordIO):
    """Keyed random access through a ``.idx`` file (reference: recordio.py
    ``MXIndexedRecordIO``)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self._native = None
        super().__init__(uri, flag)
        if flag == "r":
            with open(idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    key = key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.handle is not None and self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write(f"{key}\t{self.idx[key]}\n")
        if self._native is not None:
            self._native.close()
            self._native = None
        super().close()

    def clone(self):
        """A new read handle sharing this reader's parsed index."""
        assert not self.writable, "clone() is read-mode only"
        new = self.__class__.__new__(self.__class__)
        new.idx_path = self.idx_path
        new.idx = self.idx
        new.keys = self.keys
        new.key_type = self.key_type
        new._native = None
        MXRecordIO.__init__(new, self.uri, "r")
        return new

    def read_idx(self, idx):
        if self._native is None and not self.writable:
            lib = _native.host_lib()
            if lib is not None:
                self._native = _NativeReader(lib, self.uri)
        if self._native is not None:
            return self._native.read_at(self.idx[idx])
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


class IRHeader:
    """Image record header: flag, label, id, id2 (reference: recordio.py
    ``IRHeader``)."""

    __slots__ = ("flag", "label", "id", "id2")

    def __init__(self, flag, label, id, id2):
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2


_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """A header and a payload as one record (reference: recordio.py
    ``pack``); an array label is stored after the header with its length as
    the flag."""
    label = header.label
    if isinstance(label, (np.ndarray, list, tuple)):
        label = np.asarray(label, dtype=np.float32)
        hdr = struct.pack(_IR_FORMAT, len(label), 0.0, header.id, header.id2)
        return hdr + label.tobytes() + s
    return struct.pack(_IR_FORMAT, 0, float(label), header.id, header.id2) + s


def unpack(s: bytes):
    """A record as ``(IRHeader, payload)`` (reference: recordio.py
    ``unpack``)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header: IRHeader, img, quality=95, img_fmt=".jpg") -> bytes:
    """Encode an HWC uint8 image (JPEG at ``quality``, or PNG) with PIL and
    pack it (reference: recordio.py ``pack_img``). Without PIL the raw
    array goes in as ``.npy`` bytes, as in the reference."""
    from io import BytesIO

    buf = BytesIO()
    arr = np.asarray(img, dtype=np.uint8)
    try:
        from PIL import Image
    except ImportError:
        np.save(buf, arr)
        return pack(header, buf.getvalue())
    Image.fromarray(arr).save(
        buf, format="JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG",
        quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor=-1):
    """A record as ``(IRHeader, image array)`` (reference: recordio.py
    ``unpack_img``): ``.npy`` payloads load as they are, images decode
    through PIL."""
    from io import BytesIO

    header, payload = unpack(s)
    if payload[:6] == b"\x93NUMPY":
        return header, np.load(BytesIO(payload))
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("image decode requires PIL") from e
    return header, np.asarray(Image.open(BytesIO(payload)))
