"""Decoded-memory ceiling against adversarial files.

Analogue of the reference's allocTracker (reference: alloc.go:10-89,
WithMaximumMemorySize file_reader.go:144-149): advertised uncompressed sizes
are *checked* before decompression, and the ACTUAL decoded buffers (value
arrays, levels, dictionaries — which a lying header cannot understate, e.g.
an RLE run expanding a few bytes into millions of values) are *registered*
as they materialize, raising a clean error past the ceiling instead of
OOMing. Python's GC replaces the reference's finalizer-based deregistration:
a row group's budget is released when the reader moves on (release()).

Thread-safe: chunk preparation runs on worker threads (core/reader.py).
"""

from __future__ import annotations

import threading

__all__ = ["AllocTracker", "AllocError", "decoded_nbytes"]


class AllocError(MemoryError):
    pass


class AllocTracker:
    def __init__(self, max_bytes: int):
        if max_bytes <= 0:
            raise ValueError("alloc: ceiling must be positive")
        self.max_bytes = max_bytes
        self.used = 0
        self._lock = threading.Lock()

    def check(self, size: int) -> None:
        """Pre-check an advertised allocation (reference: alloc.go test())."""
        if size < 0:
            raise AllocError("alloc: negative advertised size")
        if self.used + size > self.max_bytes:
            raise AllocError(
                f"alloc: would exceed memory ceiling "
                f"({self.used} + {size} > {self.max_bytes})"
            )

    def register(self, size: int) -> None:
        """Account an actual materialized buffer (reference: alloc.go
        register()); raises once the ceiling is crossed."""
        with self._lock:
            self.check(size)
            self.used += size

    def register_buffers(self, *buffers) -> None:
        """Register the actual byte sizes of decoded buffers (ndarrays,
        ByteArrayData, bytes-likes); None entries are skipped."""
        self.register(sum(decoded_nbytes(b) for b in buffers))

    def release(self, size: int | None = None) -> None:
        with self._lock:
            if size is None:
                self.used = 0
            else:
                self.used = max(0, self.used - size)


def decoded_nbytes(v) -> int:
    """Actual in-memory size of a decoded buffer, in bytes."""
    if v is None:
        return 0
    nbytes = getattr(v, "nbytes", None)  # ndarray / memoryview
    if nbytes is not None:
        return int(nbytes)
    offsets = getattr(v, "offsets", None)  # ByteArrayData
    if offsets is not None:
        return int(offsets.nbytes) + len(v.data)
    try:
        return len(v)  # bytes / bytearray
    except TypeError:
        return 0
