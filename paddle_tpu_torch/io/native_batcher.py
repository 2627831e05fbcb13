"""Native batch assembly behind ``DataLoader`` for datasets of whole arrays
(counterpart of ``paddle_tpu/io/native_batcher.py`` and of the batcher
half of ``paddle_tpu/core/native.py``).

A C++ thread gathers each batch's rows of the dataset's arrays into
buffers ahead of the consumer, outside the interpreter lock. The source is
the repo-root ``csrc/batcher.cpp`` (shared with the JAX package, read and
never edited here); it builds with ``g++`` at first use into the
git-ignored ``paddle_tpu_torch/csrc/build/``, under a name that carries a
hash of the source and the flags (a build writes a temporary file and
renames it, so concurrent first uses agree). Bound with ``ctypes``.

Where the library cannot be built, the loader batches in Python on a
machine without a card, as the reference does; on a machine with a CUDA
card the build error raises. :data:`BATCHES` counts the batches the
native path served since the last :func:`reset_batch_count`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = ["NativeBatcher", "supported", "load", "BATCHES", "batch_count",
           "reset_batch_count"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "batcher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared")

#: batches the native path served since the last reset (a plain int)
BATCHES = {"native": 0}

_lock = threading.Lock()
_lib = None
_error = None


def batch_count() -> int:
    return BATCHES["native"]


def reset_batch_count() -> None:
    BATCHES["native"] = 0


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"batcher-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) for "
                           "csrc/batcher.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)


def _bind(lib) -> None:
    c = ctypes
    lib.bt_create.restype = c.c_void_p
    lib.bt_create.argtypes = [c.c_int64, c.c_int, c.c_int64]
    lib.bt_add_source.restype = None
    lib.bt_add_source.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.bt_start.restype = None
    lib.bt_start.argtypes = [c.c_void_p, c.POINTER(c.c_int64), c.c_int64]
    lib.bt_num_batches.restype = c.c_int64
    lib.bt_num_batches.argtypes = [c.c_void_p]
    lib.bt_next.restype = c.c_int64
    lib.bt_next.argtypes = [c.c_void_p, c.POINTER(c.c_char_p), c.c_uint64]
    lib.bt_destroy.restype = None
    lib.bt_destroy.argtypes = [c.c_void_p]


def load():
    """The bound library (built at first use). Raises ``RuntimeError`` or
    ``OSError`` when it cannot be built or loaded; a failure is
    remembered."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                path = _lib_path()
                if not path.exists():
                    _build(path)
                lib = ctypes.CDLL(str(path))
                _bind(lib)
                _lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError,
                    AttributeError) as e:
                _error = e
        if _error is not None:
            raise _error
        return _lib


def supported() -> bool:
    """True when the native path can run. Without a card a failed build
    gives False (the loader batches in Python); with one it raises."""
    try:
        load()
    except (OSError, RuntimeError):
        if torch.cuda.is_available():
            raise
        return False
    return True


class NativeBatcher:
    """Iterate index-gathered batches of several aligned numpy arrays,
    assembled by a C++ thread; each batch is a list of fresh arrays."""

    _h = None

    def __init__(self, arrays, indices, batch_size, drop_last=False,
                 prefetch=2):
        lib = load()
        self._lib = lib
        # C-contiguous arrays kept alive for the batcher's lifetime
        self._arrays = [np.ascontiguousarray(a) for a in arrays]
        self._indices = np.ascontiguousarray(np.asarray(indices, np.int64))
        if len(self._indices):
            lo, hi = int(self._indices.min()), int(self._indices.max())
            if lo < 0:
                raise ValueError("the native batcher takes non-negative "
                                 "indices only")
            for a in self._arrays:
                if a.shape[0] <= hi:
                    raise ValueError("index out of range for a source array")
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)
        self._h = lib.bt_create(self.batch_size, int(drop_last), int(prefetch))
        for a in self._arrays:
            row_bytes = a.dtype.itemsize * int(np.prod(a.shape[1:],
                                                       dtype=np.int64))
            lib.bt_add_source(self._h, a.ctypes.data_as(ctypes.c_char_p),
                              row_bytes)
        lib.bt_start(self._h, self._indices.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)), len(self._indices))
        self._remaining = lib.bt_num_batches(self._h)

    def __len__(self):
        return int(self._lib.bt_num_batches(self._h))

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None or self._remaining <= 0:
            self.close()
            raise StopIteration
        outs = [np.empty((self.batch_size,) + a.shape[1:], a.dtype)
                for a in self._arrays]
        ptrs = (ctypes.c_char_p * len(outs))(
            *[ctypes.cast(o.ctypes.data, ctypes.c_char_p) for o in outs])
        count = self._lib.bt_next(self._h, ptrs, len(outs))
        if count == 0:
            self.close()
            raise StopIteration
        self._remaining -= 1
        BATCHES["native"] += 1
        if count < self.batch_size:
            outs = [o[:count] for o in outs]
        return outs

    def close(self):
        if self._h is not None:
            self._lib.bt_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
