"""Pluggable byte sinks: where a Parquet file's bytes actually go.

A copy of parquet_tpu/sink/sink.py, cut to the sinks FileWriter opens:
LocalFileSink (a temp file renamed over the destination at close, so a
crash, an encode fault or an abort never leaves a torn file), MemorySink and
FileObjectSink, behind the small ByteSink contract:

    write(data)     append bytes at the current position
    tell()          bytes written so far
    flush()         push buffered bytes toward durability
    close()         COMMIT: make the written bytes the visible artifact
    abort()         DISCARD: tear down without committing (idempotent,
                    safe after close — never destroys committed output)
    sink_id         stable identity for logs

BufferedSink wraps any of them and batches small writes (page headers are
tens of bytes) into spill_bytes-sized runs before they reach the inner sink.
An http(s):// URL opens io.remote_sink.HttpSink, the multipart object-store
sink with the same atomicity contract. Every concrete sink feeds the plain
sink_bytes_written_total / sink_write_calls_total counts of sink_counts()
(sink/counts.py; wrappers do not count twice). The seeded write-fault
injector is testing.flaky.FlakySink.
"""

from __future__ import annotations

import io as _io
import itertools
import os
from pathlib import Path

from .counts import count_sink as _count_sink

__all__ = [
    "BufferedSink",
    "ByteSink",
    "SinkError",
    "LocalFileSink",
    "MemorySink",
    "FileObjectSink",
    "open_sink",
]


class SinkError(OSError):
    """Terminal IO failure of a byte sink: the write/flush/commit is not
    satisfiable (sink closed or aborted, rename failed, remote store
    refused). An OSError subclass so callers treating IO failures
    generically need no new clause; FileWriter re-raises sink failures as
    typed WriterError. `code` names the failure shape ("http_403",
    "put_retry_exhausted", "breaker_open", "sink_closed") for tests and
    error routing, mirroring SourceError."""

    def __init__(self, *args, code: str | None = None):
        super().__init__(*args)
        self.code = code


def _count_write(nbytes: int) -> None:
    # concrete sinks only — wrappers delegate and must not double-count
    _count_sink("sink_bytes_written_total", nbytes)
    _count_sink("sink_write_calls_total")


class ByteSink:
    """Base contract for byte sinks (see module docstring).

    Sinks are context managers: a clean `with` exit commits (close), an
    exception aborts — so `with LocalFileSink(p) as s: ...` can never leave
    a torn file at p. close() and abort() are idempotent; abort() after a
    successful close() is a no-op (committed output is never destroyed)."""

    def write(self, data) -> int:
        """Append `data` at the current position; returns len(data). A sink
        that cannot take all of it raises — short writes are a contract
        violation (real transports that commit them must be wrapped)."""
        raise NotImplementedError

    def tell(self) -> int:
        """Bytes written so far (the next write's offset)."""
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        """Commit. Idempotent; raising here means the artifact did NOT
        become visible (atomic sinks leave nothing behind)."""
        pass

    def abort(self) -> None:
        """Discard without committing. Idempotent; must be safe after
        close() (no-op) and after a failed write (best-effort cleanup).
        The default is a no-op, NOT close(): for a subclass whose close()
        is its commit (finalize a multipart upload, rename a temp file),
        an inherited abort-that-commits would publish exactly the
        half-written bytes abort exists to discard."""

    @property
    def sink_id(self) -> str:
        """Stable identity for logs and error messages."""
        return f"{type(self).__name__}:{id(self):#x}"

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False


# unique-per-process suffix so concurrent writers to one destination never
# collide on the temp name (last committed rename wins, as with O_TRUNC)
_tmp_seq = itertools.count()


class LocalFileSink(ByteSink):
    """Atomic local-file sink: bytes accumulate in `<dir>/.<name>.<pid>.<n>.tmp`
    next to the destination (same filesystem, so the commit rename is atomic)
    and the destination appears only at close(), complete. abort() — or the
    process dying — leaves at most a stale temp file, never a torn parquet
    file where a reader (or a glob-driven dataset) would pick it up."""

    def __init__(self, path):
        # pin the destination NOW: a relative path + a cwd change before
        # close() must not commit the file into the wrong directory (the
        # old writer pinned it via open() at construction; rename must too)
        self._path = os.path.abspath(os.fspath(path))
        d, name = os.path.split(self._path)
        self._tmp = os.path.join(
            d, f".{name}.{os.getpid()}.{next(_tmp_seq)}.tmp"
        )
        self._f = open(self._tmp, "wb")
        self._pos = 0
        self._committed = False
        self._aborted = False

    @property
    def path(self) -> str:
        return self._path

    @property
    def sink_id(self) -> str:
        return f"file:{self._path}"

    def write(self, data) -> int:
        if self._committed or self._aborted:
            raise SinkError(f"sink closed: {self._path}")
        n = self._f.write(data)
        self._pos += n
        _count_write(n)
        return n

    def tell(self) -> int:
        return self._pos

    def flush(self) -> None:
        if not (self._committed or self._aborted):
            self._f.flush()

    def close(self) -> None:
        if self._committed or self._aborted:
            return
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            os.replace(self._tmp, self._path)
        except OSError:
            self.abort()
            raise
        self._committed = True

    def abort(self) -> None:
        if self._committed or self._aborted:
            return  # never unlink a committed file (or double-abort)
        self._aborted = True
        try:
            self._f.close()
        finally:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass


class MemorySink(ByteSink):
    """An in-memory byte buffer as a sink (tests, size probes, staging
    bytes for a network PUT)."""

    def __init__(self, sink_id: str | None = None):
        self._buf = bytearray()
        self._id = sink_id or f"mem:{id(self):#x}"
        self._closed = False

    @property
    def sink_id(self) -> str:
        return self._id

    def write(self, data) -> int:
        if self._closed:
            raise SinkError("sink closed: memory sink")
        self._buf += data
        n = len(data)
        _count_write(n)
        return n

    def tell(self) -> int:
        return len(self._buf)

    def getvalue(self) -> bytes:
        """The written bytes (valid before and after close)."""
        return bytes(self._buf)

    def close(self) -> None:
        self._closed = True

    def abort(self) -> None:
        self._closed = True


class FileObjectSink(ByteSink):
    """Adapter over an arbitrary writable binary file-like object (BytesIO,
    a pipe, an already-open handle). The CALLER owns the object's lifetime:
    close() flushes but never closes it, abort() leaves it untouched (the
    caller decides what a half-written stream means for them)."""

    def __init__(self, f):
        self._f = f
        self._pos = 0

    def write(self, data) -> int:
        written = self._f.write(data)
        if written is not None and written != len(data):
            # raw unbuffered streams may legally short-write; accepting it
            # would silently drift every footer offset from the real bytes
            raise SinkError(
                f"short write to file object: {written}/{len(data)} bytes"
            )
        n = len(data)
        self._pos += n
        _count_write(n)
        return n

    def tell(self) -> int:
        return self._pos

    def flush(self) -> None:
        flush = getattr(self._f, "flush", None)
        if flush is not None:
            flush()

    def close(self) -> None:
        self.flush()

    def abort(self) -> None:
        pass


class BufferedSink(ByteSink):
    """Write-combining wrapper: writes accumulate in memory and spill to the
    inner sink in runs of >= `spill_bytes` (default 1 MiB). Page headers are
    tens of bytes and a row group writes hundreds of them — batching them
    turns per-page syscalls (or per-page PUTs, for request-priced sinks)
    into a handful of large sequential writes. flush()/close() drain the
    buffer; abort() drops it and aborts the inner sink."""

    def __init__(self, inner: ByteSink, *, spill_bytes: int = 1 << 20):
        if spill_bytes < 1:
            raise ValueError("spill_bytes must be >= 1")
        self.inner = inner
        self.spill_bytes = int(spill_bytes)
        self._buf = bytearray()
        self._flushed = 0  # bytes already handed to the inner sink
        self._closed = False

    @property
    def sink_id(self) -> str:
        return self.inner.sink_id

    def buffered(self) -> int:
        """Bytes held in memory, not yet written through (tests/tuning)."""
        return len(self._buf)

    def write(self, data) -> int:
        if self._closed:
            # without this, a buffered write after close/abort would report
            # success and silently vanish until (never) the next spill
            raise SinkError("sink closed: buffered sink")
        self._buf += data
        if len(self._buf) >= self.spill_bytes:
            self._spill()
        return len(data)

    def _spill(self) -> None:
        if self._buf:
            # hand off state only AFTER the fallible inner write: a caller
            # retrying past a transient spill fault must not silently lose
            # this run of bytes while tell() still counts them
            self.inner.write(bytes(self._buf))
            self._flushed += len(self._buf)
            self._buf = bytearray()

    def tell(self) -> int:
        return self._flushed + len(self._buf)

    def flush(self) -> None:
        self._spill()
        self.inner.flush()

    def close(self) -> None:
        self._spill()
        self._closed = True
        self.inner.close()

    def abort(self) -> None:
        self._buf = bytearray()
        self._closed = True
        self.inner.abort()


def open_sink(obj) -> tuple[ByteSink, bool]:
    """Coerce `obj` into a (ByteSink, owns) pair — the FileWriter
    constructor's one entry point for every accepted destination shape.

      str / Path           -> LocalFileSink        (owned: writer commits
                                                    atomically at close)
      http(s):// URL       -> io.remote_sink.HttpSink  (owned: multipart
                                                    commit at close, same
                                                    atomicity contract)
      ByteSink             -> passed through       (caller keeps lifetime)
      writable file-like   -> FileObjectSink       (caller keeps lifetime)
    """
    if isinstance(obj, ByteSink):
        return obj, False
    if isinstance(obj, str) and obj.startswith(("http://", "https://")):
        # the write-side twin of open_source's URL coercion: remote
        # writes inherit signing (io.sign registry) and the resilience
        # policy's breaker with zero per-callsite wiring
        from ..io.remote_sink import HttpSink

        return HttpSink(obj), True
    if isinstance(obj, (str, Path)):
        return LocalFileSink(obj), True
    if (
        hasattr(obj, "write")
        and hasattr(obj, "tell")
        and hasattr(obj, "abort")
    ):
        return obj, False  # duck-typed sink (custom remote implementations)
    if hasattr(obj, "write"):
        if isinstance(obj, _io.TextIOBase):
            raise TypeError("cannot write parquet to a text-mode file object")
        return FileObjectSink(obj), False
    raise TypeError(
        f"cannot open {type(obj).__name__!r} as a byte sink (expected a "
        "path, a ByteSink, or a writable binary file object)"
    )
