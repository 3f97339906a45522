"""Build and load the port's CUDA kernels.

Every `kernels/csrc/*.cu` source compiles with `nvcc` for `sm_90a` (one
`nvcc -c` per source, all started together), and the objects link into one
shared library with a plain C interface, loaded with `ctypes`. Pointers and
the CUDA stream are passed as `ctypes.c_void_p`. The `*.cuh` headers
(bitpack.cuh, hybrid.cuh, scan.cuh, validity.cuh) are included by the sources and compile
with them.

The library goes to `build/parquet_tpu_torch/<key>/` at the repository root
(listed in .gitignore), keyed by a hash of the sources, the headers and the
flags, so a changed source or header rebuilds and an unchanged one loads at once. A lock file
guards a concurrent first use. A failed build raises `KernelBuildError`:
nothing gives way to the plain PyTorch versions.

Nothing here runs at import: `load()` builds on the first kernel launch.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["KernelBuildError", "load", "build_seconds"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "parquet_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
LIB_NAME = "libpqt_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
_D = ctypes.c_double
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    "pqt_expand_hybrid": (_P, _I, _I, _I, _P, _P),
    "pqt_dict_gather4": (_P, _LL, _P, _LL, _P, _P),
    "pqt_dict_gather8": (_P, _LL, _P, _LL, _P, _P),
    "pqt_delta_scratch_words": (_I,),
    "pqt_delta_packed_decode": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    "pqt_bss_transpose_pages": (_P, _I, _P, _P),
    "pqt_merge_mixed_numeric4": (
        _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _I, _LL, _P, _P,
    ),
    "pqt_merge_mixed_numeric8": (
        _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _I, _LL, _P, _P,
    ),
    "pqt_merge_bytes_scratch_words": (_LL,),
    "pqt_merge_mixed_bytes": (
        _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _P, _LL, _LL, _P, _P, _P, _P, _I,
        _LL, _LL, _P, _P, _P, _P,
    ),
    "pqt_record_starts": (_P, _LL, _P, _P, _P, _P),
    "pqt_list_layout": (_P, _P, _LL, _LL, _LL, _P, _P, _P, _P, _P),
    "pqt_pad_ragged_scratch_words": (_LL, _LL, _I),
    "pqt_pad_ragged": (_P, _LL, _I, _P, _I, _LL, _LL, _P, _P, _P),
    "pqt_expand_nullable": (_P, _LL, _I, _P, _LL, _P, _P, _P),
    "pqt_predicate_mask": (
        _P, _LL, _I, _I, _LL, _LL, _D, _D, _I, _ULL, _P, _P, _I, _P, _P,
    ),
    "pqt_fixed_members": (_P, _LL, _I, _P, _I, _I, _P, _P),
    "pqt_leaf_verdict": (_P, _LL, _P, _LL, _P, _LL, _I, _P, _P, _P),
    "pqt_list_contains_mask": (_P, _P, _LL, _P, _LL, _LL, _P, _P, _P, _P),
    "pqt_mask_scan": (_P, _LL, _LL, _P, _P, _P, _P),
    "pqt_mask_take": (_P, _LL, _LL, _P, _LL, _I, _P, _P, _P, _P),
    "pqt_take_rows": (_P, _LL, _LL, _I, _P, _P, _LL, _P, _P),
    "pqt_bitpack_encode": (_P, _LL, _I, _P, _LL, _P),
    "pqt_rle_hybrid_encode": (_P, _LL, _I, _P, _P, _P, _LL, _P, _P, _P),
    "pqt_dict_indices_scratch_words": (_LL,),
    "pqt_dict_indices": (_P, _LL, _I, _P, _P, _P, _P, _P),
    "pqt_delta_block_encode": (_P, _LL, _I, _P, _P, _P, _P, _P),
    "pqt_plain_bytearray_encode": (_P, _P, _LL, _LL, _P, _P, _P),
    "pqt_masked_agg": (_P, _P, _LL, _I, _I, _I, _I, _I, _P, _P, _P),
    "pqt_expand_page_grid": (_P, _I, _P, _P, _P, _P, _I, _I, _P, _LL, _I, _I, _I, _P, _P),
}

_lib = None
_lib_lock = threading.Lock()
_build_seconds: float | None = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or a kernel source failed to compile or link."""


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found: the CUDA kernels build only where a CUDA toolkit is installed"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _key(sources: list[Path]) -> str:
    """Hash of the flags and of `sources` (the build passes the headers too,
    so an edited header rebuilds)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the first failure's output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for c in cmds
    ]
    outs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelBuildError(
                f"kernel build failed ({p.returncode}): {' '.join(cmd)}\n{out}"
            )


def _build(out_dir: Path, sources: list[Path]) -> Path:
    nvcc = _nvcc()
    lib_path = out_dir / LIB_NAME
    objs = [out_dir / (s.stem + ".o") for s in sources]
    _run_all(
        [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(sources, objs)]
    )
    tmp = out_dir / (LIB_NAME + ".tmp")
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]])
    os.replace(tmp, lib_path)
    return lib_path


def load():
    """The loaded kernel library (built on first use). Raises
    KernelBuildError if it cannot be built."""
    global _lib, _build_seconds
    with _lib_lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        out_dir = BUILD_ROOT / _key(sources + _headers())
        out_dir.mkdir(parents=True, exist_ok=True)
        lib_path = out_dir / LIB_NAME
        t0 = time.perf_counter()
        with open(out_dir / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not lib_path.exists():
                    _build(out_dir, sources)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {lib_path}: {e}") from e
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def build_seconds() -> float | None:
    """Seconds the first load() took (build included), or None before it."""
    return _build_seconds
