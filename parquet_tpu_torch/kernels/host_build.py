"""Build and load the port's host library (the native prepare walk and the
host value functions).

`parquet_tpu_torch/native/prepare.cc` (the chunk walk and codecs),
`values.cc` (the host value functions) and `encode.cc` (the fused chunk
encode walk and gzip compression), with the headers `prepare.h`, `encode.h`
and `bits.h`, compile in one `g++ -O3 -fPIC -std=c++17 -shared ... -lz` into
`build/parquet_tpu_torch/host-<key>/` at
the repository root (listed in .gitignore), keyed by a hash of the sources
and the flags, under the same lock scheme as the CUDA library
(kernels/build.py). It needs a C++ compiler and zlib, and no card: the CPU
tests build and run it too. A failed build raises `HostBuildError`.

The ZSTD codec is a second, separate library: `native/zstd.cc` compiles
alone into `libpqt_zstd.so` in a `zstd-<key>/` directory beside it
(`load_zstd()`, at the first ZSTD use), so that a host without libzstd
loses the ZSTD codec only, never the host library. It links `-lzstd`
where libzstd's development link (`libzstd.so`) resolves, and the runtime
library by its soname (`-l:libzstd.so.1`) where it does not; without
`zstd.h`, `zstd.cc` declares the few libzstd functions it calls itself.
The key of `zstd-<key>/` covers those flags.

Nothing here runs at import: `load()` and `load_zstd()` build on first use.
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

__all__ = ["HostBuildError", "load", "load_zstd"]

NATIVE = Path(__file__).resolve().parents[1] / "native"
SOURCES = ("prepare.cc", "values.cc", "encode.cc", "prepare.h", "encode.h", "bits.h")
# the read-side and value sources, then the write walk's: all one library
CXX_SOURCES = ("prepare.cc", "values.cc")
ENCODE_SOURCES = ("encode.cc",)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIB_NAME = "libpqt_host.so"
ZSTD_SOURCES = ("zstd.cc",)
ZSTD_LIB_NAME = "libpqt_zstd.so"
# libzstd's development link, and the runtime library linked by its
# soname where that link does not resolve
ZSTD_DEV_LINK = "libzstd.so"
ZSTD_RUNTIME = "libzstd.so.1"
# -DPQT_ZSTD_DECLARE builds zstd.cc's declared-prototype branch where
# zstd.h is present too (the tests build that branch so)
ZSTD_DEFINES: tuple = ()

_lib = None
_lib_lock = threading.Lock()
_zstd = None
_zstd_error: "HostBuildError | None" = None
_zstd_lock = threading.Lock()


class HostBuildError(RuntimeError):
    """No C++ compiler, or the host library failed to compile, link or load."""


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise HostBuildError("no C++ compiler (g++) found to build the host library")


def _key(sources=SOURCES, flags=()) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(flags)).encode())
    for name in sources:
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path, lib_name: str, sources, link: str, failure, defines=()) -> None:
    """One `g++ ... -shared` of `sources` into out_dir/lib_name, linked with
    `link`; a failure raises HostBuildError whose first line is
    failure(compiler output)."""
    tmp = out_dir / (lib_name + ".tmp")
    cmd = [_cxx(), *CXX_FLAGS, *defines, "-o", str(tmp), *(str(NATIVE / n) for n in sources),
           link]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        log = proc.stdout.decode(errors="replace")
        raise HostBuildError(f"{failure(log)}\n({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out_dir / lib_name)


def _build(out_dir: Path) -> None:
    _compile(out_dir, LIB_NAME, CXX_SOURCES + ENCODE_SOURCES, "-lz",
             lambda log: "host library build failed")


def _locked_build(out_dir: Path, lib_name: str, build) -> ctypes.CDLL:
    """`build(out_dir)` under the directory's file lock unless the library
    is there already, then load it."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / lib_name
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not lib_path.exists():
                build(out_dir)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise HostBuildError(f"cannot load {lib_path}: {e}") from e


def load() -> ctypes.CDLL:
    """The loaded host library (built on first use). Raises HostBuildError
    if it cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _locked_build(BUILD_ROOT / f"host-{_key()}", LIB_NAME, _build)
        return _lib


def _resolves(lib: str) -> bool:
    """True when the compiler's library search path holds `lib` (the
    compiler prints the bare name back when it finds none)."""
    proc = subprocess.run([_cxx(), f"-print-file-name={lib}"], capture_output=True, text=True)
    found = proc.stdout.strip()
    return os.path.isabs(found) and os.path.exists(found)


def _zstd_flags() -> tuple:
    """(defines, link) of the ZSTD build on this host."""
    link = "-lzstd" if _resolves(ZSTD_DEV_LINK) else f"-l:{ZSTD_RUNTIME}"
    return tuple(ZSTD_DEFINES), link


def _zstd_failure(log: str) -> str:
    if "zstd.h" in log:
        return "zstd library: zstd.h not found (libzstd's development header)"
    if f"-l:{ZSTD_RUNTIME}" in log:
        return (f"zstd library: {ZSTD_RUNTIME} not found (neither libzstd's development "
                f"link {ZSTD_DEV_LINK} nor its runtime library)")
    if "-lzstd" in log:
        return "zstd library: libzstd not found (-lzstd)"
    return "zstd library: build failed"


def load_zstd() -> ctypes.CDLL:
    """The loaded ZSTD library (built on first use). Raises HostBuildError,
    naming the missing header or library, if it cannot be built or loaded;
    a failure is kept, and raised again without a second build."""
    global _zstd, _zstd_error
    with _zstd_lock:
        if _zstd is None and _zstd_error is None:
            try:
                defines, link = _zstd_flags()
                _zstd = _locked_build(
                    BUILD_ROOT / f"zstd-{_key(ZSTD_SOURCES, defines + (link,))}",
                    ZSTD_LIB_NAME,
                    lambda out: _compile(out, ZSTD_LIB_NAME, ZSTD_SOURCES, link,
                                         _zstd_failure, defines),
                )
            except HostBuildError as e:
                _zstd_error = e
        if _zstd_error is not None:
            raise _zstd_error
        return _zstd
