"""Build and bind the hand-written Hopper kernels under ``csrc/``.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so one file builds in
seconds), loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         --split-compile=0 -Xptxas=-v -shared -Xcompiler -fPIC \\
         -o csrc/build/<name>-<hash>.so csrc/<name>.cu

The output directory ``paddle_tpu_torch/csrc/build/`` is git-ignored; a
library's file name carries a hash of its source and the flags, so an
edited source builds anew and an unchanged one is reused. The first use of
any kernel builds every missing library, one ``nvcc`` per source, all
started together; ``--split-compile=0`` lets one source's many kernel
instantiations (the flash files') optimise on every core. ``-Xptxas=-v``
leaves each kernel's registers, shared memory and spills in the build's
log, ``csrc/build/<name>-<hash>.log``. A missing ``nvcc`` raises.

Calling convention of every C entry: tensor pointers and the CUDA stream
are ``c_void_p`` (a plain ``c_int`` would cut a 64-bit pointer), sizes are
``c_int``, and the return value is ``cudaGetLastError()`` right after the
launch. :func:`check` raises when it is not 0, so a launch the card refused
(too many threads, too much shared memory) never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..telemetry import perf as _perf

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "sources",
           "build_all", "function", "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile=0", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels build at first use "
        "and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # every source includes these
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel; returns
    ``{name: library path}``. Raises with the compiler's output when a
    build fails."""
    out = {src.stem: _lib_path(src) for src in sources()}
    todo = [(src, out[src.stem]) for src in sources()
            if not out[src.stem].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.monotonic()
    for src, lib in todo:
        # write under a per-process name, then rename: concurrent builds
        # of the same source never see a half-written library
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        procs.append((src, lib, tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    watcher = _perf.compile_watcher()
    for src, lib, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
            # the build's wall, from the common start to this library's
            # end (nvcc runs them all at once)
            watcher.record_compile(f"nvcc.{src.stem}",
                                   (("library", (), lib.name),),
                                   time.monotonic() - t0)
        else:
            failed.append(f"{src.name} (rc={rc}):\n"
                          + lib.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        paths = build_all()
        if name not in paths:
            raise RuntimeError(f"no kernel source csrc/{name}.cu")
        lib = ctypes.CDLL(str(paths[name]))
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def function(lib_name: str, fn_name: str, argtypes):
    """The C entry ``fn_name`` of ``csrc/<lib_name>.cu`` with its argument
    types set (built and loaded at first use)."""
    key = (lib_name, fn_name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(_library(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(err: int, lib_name: str, what: str) -> None:
    """Raise when a C entry returned a CUDA error code (non-zero)."""
    if err:
        msg = _library(lib_name).ptt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
