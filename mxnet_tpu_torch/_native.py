"""Build and load the package's native libraries.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into ``_build/lib<name>.so`` beside this file and
loaded with ``ctypes``; a library newer than its source is reused. Every
library compiles as objects, one ``nvcc -c`` each for ``MXTT_PART`` = 0, 1,
... (one for a library not in ``PARTS``), all started together, then linked
(:func:`compile_library`).

The host library (:func:`host_lib`) is the repo's RecordIO codec, native
dependency engine and JPEG codec, ``src/recordio.cc``, ``src/engine.cc`` and
``src/im2rec.cc``, compiled with ``g++ -ljpeg`` into
``_build/libmxtpu_host.so``. On a host without libjpeg it is built without
``im2rec.cc`` (the ``nojpeg`` build: the record reader and writer and the
engine, no JPEG functions), and rebuilt once libjpeg links. A sidecar holds
the sources' hash, so a library built from other sources is rebuilt (git
keeps no mtimes). Nothing here runs at import, so the package imports on
hosts without CUDA or a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from .base import MXNetError

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# objects a library builds as (one where not listed): the source says what
# each MXTT_PART instantiates
PARTS = {"flash_attention_fwd_tc": 2}

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_LOGS: dict = {}   # name -> nvcc/ptxas output of this process's build


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise MXNetError("nvcc not found: the CUDA kernels need the CUDA "
                         "toolkit (set CUDA_HOME)")
    return path


def compile_library(src: str, out: str, parts: int = 1):
    """Compile ``src`` into the shared library ``out``: ``parts`` objects,
    one ``nvcc -c`` each with ``-DMXTT_PART`` = 0, 1, ..., all started
    together, then linked. Returns (ok, nvcc's and ptxas's output); ``out``
    is replaced only where every step succeeded."""
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    objs = [f"{tmp}.{k}.o" for k in range(parts)]
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-c", f"-DMXTT_PART={k}", "-o", obj, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, obj in enumerate(objs)]
    logs = [p.communicate()[0] for p in procs]
    ok = all(p.returncode == 0 for p in procs)
    if ok:
        link = subprocess.run(
            [_nvcc(), "-shared", "-Xcompiler", "-fPIC", "-o", tmp, *objs],
            capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        ok = link.returncode == 0
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if ok:
        os.replace(tmp, out)
    return ok, "".join(logs)


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library's path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    ok, BUILD_LOGS[name] = compile_library(src, out, PARTS.get(name, 1))
    if not ok:
        raise MXNetError(f"nvcc failed for {src}:\n{BUILD_LOGS[name]}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
        return lib


# ------------------------------------------------------------- host library

REPO_SRC = os.path.join(os.path.dirname(_HERE), "src")
HOST_SOURCES = ("recordio.cc", "engine.cc", "im2rec.cc")
JPEG_SOURCE = "im2rec.cc"   # needs libjpeg
# the engine's callback: void (*)(void* ctx)
ENGINE_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
HOST_LIB = os.path.join(BUILD_DIR, "libmxtpu_host.so")
_HOST = {}   # "lib": the loaded CDLL (None: no compiler or no sources)


def _host_hash():
    h = hashlib.sha256()
    for name in HOST_SOURCES:
        with open(os.path.join(REPO_SRC, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()


def jpeg_linkable():
    """Whether ``g++`` finds libjpeg's header and library here."""
    try:
        r = subprocess.run(
            ["g++", "-x", "c++", "-", "-o", os.devnull, "-ljpeg"],
            input=b"#include <cstdio>\n#include <jpeglib.h>\n"
                  b"int main(){jpeg_std_error(nullptr);return 0;}",
            capture_output=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return False
    return r.returncode == 0


def _host_stale():
    try:
        with open(HOST_LIB + ".hash") as f:
            lines = f.read().split("\n")
    except OSError:
        return True
    if lines[0].strip() != _host_hash():
        return True
    return "nojpeg" in lines[1:] and jpeg_linkable()


def _build_host():
    """Compile the host library (with libjpeg, else without
    :data:`JPEG_SOURCE`);
    returns its path or None when neither build links."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [os.path.join(REPO_SRC, n) for n in HOST_SOURCES]
    tmp = f"{HOST_LIB}.{os.getpid()}.tmp"
    nojpeg = [s for s in srcs if not s.endswith(JPEG_SOURCE)]
    base = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", "-o",
            tmp]
    for cmd, marker in ((base + srcs + ["-ljpeg"], ""),
                        (base + nojpeg, "\nnojpeg")):
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (FileNotFoundError, subprocess.TimeoutExpired) as e:
            BUILD_LOGS["mxtpu_host"] = str(e)
            continue
        BUILD_LOGS["mxtpu_host"] = proc.stdout + proc.stderr
        if proc.returncode == 0:
            os.replace(tmp, HOST_LIB)
            with open(HOST_LIB + ".hash", "w") as f:
                f.write(_host_hash() + marker)
            return HOST_LIB
    return None


def _declare_host(lib):
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    sigs = {
        "mxtpu_recio_open": (c.c_void_p, [c.c_char_p]),
        "mxtpu_recio_count": (c.c_int64, [c.c_void_p]),
        "mxtpu_recio_get": (c.c_int64, [c.c_void_p, c.c_int64,
                                        c.POINTER(u8p)]),
        "mxtpu_recio_read_at": (c.c_int64, [c.c_void_p, c.c_int64,
                                            c.POINTER(u8p)]),
        "mxtpu_recio_close": (None, [c.c_void_p]),
        "mxtpu_recw_open": (c.c_void_p, [c.c_char_p]),
        "mxtpu_recw_tell": (c.c_int64, [c.c_void_p]),
        "mxtpu_recw_write": (c.c_int, [c.c_void_p, c.c_char_p, c.c_int64]),
        "mxtpu_recw_close": (None, [c.c_void_p]),
        # the dependency engine (src/engine.cc)
        "mxtpu_engine_create": (c.c_void_p, [c.c_int]),
        "mxtpu_engine_destroy": (None, [c.c_void_p]),
        "mxtpu_engine_new_var": (c.c_void_p, [c.c_void_p]),
        "mxtpu_engine_delete_var": (None, [c.c_void_p, c.c_void_p]),
        "mxtpu_engine_push": (None, [
            c.c_void_p, ENGINE_CALLBACK, c.c_void_p,
            c.POINTER(c.c_void_p), c.c_int, c.POINTER(c.c_void_p),
            c.c_int]),
        "mxtpu_engine_wait_all": (None, [c.c_void_p]),
        # libjpeg builds only
        "mxtpu_jpeg_decode": (c.c_int, [c.c_char_p, c.c_int64,
                                        c.POINTER(c.c_int),
                                        c.POINTER(c.c_int), c.POINTER(u8p)]),
        "mxtpu_jpeg_decode_minsize": (c.c_int, [
            c.c_char_p, c.c_int64, c.c_int, c.POINTER(c.c_int),
            c.POINTER(c.c_int), c.POINTER(u8p)]),
        "mxtpu_buf_free": (None, [u8p]),
        "mxtpu_im2rec_pack": (c.c_int64, [c.c_char_p, c.c_char_p,
                                          c.c_char_p, c.c_char_p, c.c_int,
                                          c.c_int, c.c_int]),
    }
    for name, (res, args) in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args


def host_lib():
    """The loaded host library, built on first use; None where no build
    links (no ``g++``). ``MXTPU_NO_NATIVE_BUILD=1`` uses a library already
    built and builds none."""
    with _LOCK:
        if "lib" in _HOST:
            return _HOST["lib"]
        path = HOST_LIB if os.path.exists(HOST_LIB) else None
        if os.environ.get("MXTPU_NO_NATIVE_BUILD") != "1" \
                and (path is None or _host_stale()):
            path = _build_host() or path
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                # built on another host (a libjpeg this one lacks)
                if os.environ.get("MXTPU_NO_NATIVE_BUILD") == "1" \
                        or _build_host() is None:
                    raise
                lib = ctypes.CDLL(path)
            _declare_host(lib)
        _HOST["lib"] = lib
        return lib


def host_has_jpeg():
    """Whether the host library decodes JPEG (it was linked with
    libjpeg)."""
    lib = host_lib()
    return lib is not None and hasattr(lib, "mxtpu_jpeg_decode")
