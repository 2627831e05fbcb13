"""Native runtime loader for the TCPStore (counterpart of the store half of
``paddle_tpu/core/native.py``; the batcher half is
``paddle_tpu_torch/io/native_batcher.py``).

The source is the repo-root ``csrc/tcp_store.cpp`` (shared with the JAX
package, read and never edited here). It builds with ``g++`` at first use
into the git-ignored ``paddle_tpu_torch/csrc/build/``, under a name that
carries a hash of the source and the flags; a build writes a temporary
file and renames it into place, so concurrent first uses agree. Bound
with ``ctypes``.

:func:`load` returns None where the library cannot be built on a machine
without a card (as the reference's does where no toolchain exists); on a
machine with a CUDA card the build error raises: the port keeps no
pure-Python store.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..analysis import locksan

__all__ = ["load", "available", "SOURCE", "BUILD_DIR"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "tcp_store.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared")

_LOCK = locksan.Lock("native.load")
_LIB = None
_ERROR: BaseException | None = None


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"tcp_store-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) for "
                           "csrc/tcp_store.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)


def _cuda_present() -> bool:
    import torch

    return torch.cuda.is_available()


def load():
    """The bound library, or None when it cannot be built here. On a
    machine with a CUDA card a failed build raises instead (remembered:
    every later call raises the same error)."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is None and _ERROR is None:
            try:
                path = _lib_path()
                if not path.exists():
                    _build(path)
                lib = ctypes.CDLL(str(path))
                _bind(lib)             # AttributeError = stale-ABI binary
                _LIB = lib
            except (OSError, RuntimeError, subprocess.SubprocessError,
                    AttributeError) as e:
                _ERROR = e
        if _ERROR is not None:
            if _cuda_present():
                raise RuntimeError(
                    f"the native TCPStore library did not build: "
                    f"{_ERROR}") from _ERROR
            return None
        return _LIB


def available() -> bool:
    return load() is not None


def _bind(lib):
    c = ctypes
    lib.ts_server_start.restype = c.c_void_p
    lib.ts_server_start.argtypes = [c.c_int]
    lib.ts_server_port.restype = c.c_int
    lib.ts_server_port.argtypes = [c.c_void_p]
    lib.ts_server_stop.restype = None
    lib.ts_server_stop.argtypes = [c.c_void_p]
    lib.ts_connect.restype = c.c_int
    lib.ts_connect.argtypes = [c.c_char_p, c.c_int, c.c_int]
    lib.ts_set.restype = c.c_int
    lib.ts_set.argtypes = [c.c_int, c.c_char_p, c.c_uint32, c.c_char_p,
                           c.c_uint32]
    lib.ts_get.restype = c.c_int
    lib.ts_get.argtypes = [c.c_int, c.c_char_p, c.c_uint32, c.c_char_p,
                           c.c_uint32]
    lib.ts_add.restype = c.c_int64
    lib.ts_add.argtypes = [c.c_int, c.c_char_p, c.c_uint32, c.c_int64]
    lib.ts_wait.restype = c.c_int
    lib.ts_wait.argtypes = [c.c_int, c.c_char_p, c.c_uint32, c.c_int64]
    lib.ts_delete.restype = c.c_int
    lib.ts_delete.argtypes = [c.c_int, c.c_char_p, c.c_uint32]
    lib.ts_close.restype = None
    lib.ts_close.argtypes = [c.c_int]
