"""Builds and loads the port's hand-written CUDA kernels.

Each source under ``simseg_tpu_torch/csrc`` has a plain C interface; it is
compiled with ``nvcc`` for ``sm_90a`` at first use into a shared library
in ``simseg_tpu_torch/_build/`` (gitignored), named by the hash of the
source and of the ``csrc`` headers it includes, and loaded with ``ctypes``.
Nothing is prebuilt, and nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_digest(name: str, csrc: str = CSRC) -> str:
    """12 hex digits of the SHA-256 of ``<csrc>/<name>.cu`` followed by each
    header of ``csrc`` that it includes (quoted ``#include``, transitively,
    each once, in the order first met), so that an edited header builds a
    new library. A source that includes none hashes as its bytes alone."""
    h = hashlib.sha256()
    pending, seen = [f"{name}.cu"], set()
    while pending:
        file = pending.pop(0)
        path = os.path.join(csrc, file)
        if file in seen or (seen and not os.path.exists(path)):
            continue  # met before, or not a header of csrc
        seen.add(file)
        with open(path, "rb") as f:
            data = f.read()
        if len(seen) > 1:
            h.update(file.encode() + b"\0")
        h.update(data)
        pending += [m.decode() for m in _INCLUDE.findall(data)]
    return h.hexdigest()[:12]


def build_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (once per version of it and its headers);
    returns the path of the shared library."""
    source = os.path.join(CSRC, f"{name}.cu")
    path = os.path.join(BUILD_DIR, f"lib{name}-{source_digest(name, CSRC)}.so")
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
