"""Builds and loads the port's hand-written CUDA kernels.

Each source under ``simseg_tpu_torch/csrc`` has a plain C interface; it is
compiled with ``nvcc`` for ``sm_90a`` at first use into a shared library
in ``simseg_tpu_torch/_build/`` (gitignored), named by the source's hash,
and loaded with ``ctypes``. Nothing is prebuilt, and nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (once per source version); returns the
    path of the shared library."""
    source = os.path.join(CSRC, f"{name}.cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, with its
    ``<name>_error_string`` (CUDA error code -> message) declared."""
    lib = ctypes.CDLL(build_library(name))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check_status(lib: ctypes.CDLL, name: str, fn: str, status: int) -> None:
    """Raises if a launcher returned a CUDA error (0 is success)."""
    if status != 0:
        msg = getattr(lib, f"{name}_error_string")(status).decode()
        raise RuntimeError(f"{fn} failed: {msg}")
