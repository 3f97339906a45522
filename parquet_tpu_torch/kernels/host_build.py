"""Build and load the port's host library (the native prepare walk and the
host value functions).

`parquet_tpu_torch/native/prepare.cc` (the chunk walk and codecs) and
`values.cc` (the host value functions), with the headers `prepare.h` and
`bits.h`, compile in one `g++ -O3 -fPIC -std=c++17 -shared ... -lz` into
`build/parquet_tpu_torch/host-<key>/` at
the repository root (listed in .gitignore), keyed by a hash of the sources
and the flags, under the same lock scheme as the CUDA library
(kernels/build.py). It needs a C++ compiler and zlib, and no card: the CPU
tests build and run it too. A failed build raises `HostBuildError`.

Nothing here runs at import: `load()` builds on first use.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .build import BUILD_ROOT

__all__ = ["HostBuildError", "load"]

NATIVE = Path(__file__).resolve().parents[1] / "native"
SOURCES = ("prepare.cc", "values.cc", "prepare.h", "bits.h")
CXX_SOURCES = ("prepare.cc", "values.cc")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIB_NAME = "libpqt_host.so"

_lib = None
_lib_lock = threading.Lock()


class HostBuildError(RuntimeError):
    """No C++ compiler, or the host library failed to compile, link or load."""


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise HostBuildError("no C++ compiler (g++) found to build the host library")


def _key() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> None:
    tmp = out_dir / (LIB_NAME + ".tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE / n) for n in CXX_SOURCES), "-lz"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise HostBuildError(
            f"host library build failed ({proc.returncode}): {' '.join(cmd)}\n"
            + proc.stdout.decode(errors="replace")
        )
    os.replace(tmp, out_dir / LIB_NAME)


def load() -> ctypes.CDLL:
    """The loaded host library (built on first use). Raises HostBuildError
    if it cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / f"host-{_key()}"
        out_dir.mkdir(parents=True, exist_ok=True)
        lib_path = out_dir / LIB_NAME
        with open(out_dir / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not lib_path.exists():
                    _build(out_dir)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        try:
            _lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            raise HostBuildError(f"cannot load {lib_path}: {e}") from e
        return _lib
