"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into ``_build/lib<name>.so`` beside this file and
loaded with ``ctypes``; a library newer than its source is reused. Nothing
here runs at import, so the package imports on hosts without CUDA.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

from .base import MXNetError

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

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


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library's path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise MXNetError(f"nvcc failed for {src}:\n{BUILD_LOGS[name]}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
        return lib
