"""Pluggable byte sources: where a Parquet file's bytes actually come from.

Its counts are io.counts counts; a retry is also an io.retry count of the
request's trace and a rate-limited source_retry log event.

The decode stack above this layer (reader/planner/cache) never touches a
file handle directly — it speaks the small ByteSource contract:

    size()                    total byte length
    read_at(offset, n)        exactly n bytes at offset (or raise)
    read_ranges([(o, n)...])  batched positional reads, one result per range
    source_id                 stable identity for cache keys
    close()

That is the seam production readers interpose on: the reference reader (and
the original FileReader here) assumed one cheap seekable local handle guarded
by a position lock, which serializes a 16-thread prepare pool and models an
object store not at all. Concrete sources:

  LocalFileSource    lock-free os.pread on a local fd — no shared cursor,
                     so concurrent chunk preparers never contend
  MemorySource       an in-memory buffer (zero-copy slicing)
  FileObjectSource   adapter over an arbitrary seekable file-like (BytesIO,
                     sockets wrapped in a buffer, ...) — the compatibility
                     lane for FileReader(file_obj)
  RetryingSource     wraps any source with a deadline + capped exponential
                     backoff + jitter retry ladder for transient faults
                     (the remote-object-store shape); exhausting the budget
                     raises the typed SourceError

Every CONCRETE source feeds the always-on io_bytes_read_total /
io_read_calls_total counters (wrappers don't double-count); RetryingSource
adds io_retries_total{reason=...} per failed attempt. The seeded fault
injector lives in testing.flaky (FlakySource).
"""

from __future__ import annotations

import errno as _errno
import io as _io
import os
import random
import threading
import time
from pathlib import Path

from ..obs.log import log_event as _log_event
from ..utils import trace as _trace
from .counts import count as _count

__all__ = [
    "ByteSource",
    "SourceError",
    "LocalFileSource",
    "MemorySource",
    "FileObjectSource",
    "RetryingSource",
    "SourceFile",
    "open_source",
]


class SourceError(OSError):
    """Terminal IO failure of a byte source: the read is not satisfiable
    (range past EOF, retry budget exhausted, source closed, circuit
    breaker open). An OSError subclass so callers treating IO failures
    generically (the dataset layer's skip policy) need no new clause — but
    typed, so tests can pin that the retry ladder converted a transient
    fault storm into exactly this, never a raw errno leak. `code` is an
    optional stable discriminator ("breaker_open") layers above branch on
    — the serve executor turns breaker fast-fails into 503s instead of
    422s with it."""

    def __init__(self, *args, code: str | None = None):
        super().__init__(*args)
        self.code = code


def _count_read(nbytes: int) -> None:
    # concrete sources only — wrappers delegate and must not double-count
    _count("io_bytes_read_total", nbytes)
    _count("io_read_calls_total")


class ByteSource:
    """Base contract for byte sources (see module docstring).

    Subclasses implement size() and read_at(); read_ranges() has a
    loop-of-read_at default that batching sources (HTTP multi-range,
    io_uring) override. Sources are context managers; close() is
    idempotent and a no-op by default."""

    def size(self) -> int:
        raise NotImplementedError

    def read_at(self, offset: int, n: int) -> bytes:
        """Exactly `n` bytes at `offset`. A source that cannot deliver them
        (EOF inside the range, transport failure) raises — short returns
        are a contract violation RetryingSource guards against."""
        raise NotImplementedError

    def read_ranges(self, ranges) -> list:
        """One buffer per (offset, n) range, in order."""
        return [self.read_at(off, n) for off, n in ranges]

    @property
    def source_id(self) -> str:
        """Stable identity for (source_id, offset, len) cache keys. Two
        sources over the SAME underlying bytes should agree (LocalFileSource
        keys on inode+size+mtime so reopened paths share cache entries and
        rewritten files never hit stale ones)."""
        return f"{type(self).__name__}:{id(self):#x}"

    def generation(self):
        """A hashable content-generation signature, or None when the
        source has no cheaper validity check than its bytes. Remote
        sources return (size, ETag) — what lets the FooterCache validate
        a URL-keyed footer the way it stats a local path. Wrapper sources
        delegate to their inner source."""
        return None

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# POSIX-only; non-POSIX platforms fall back to a lock-guarded lseek+read
_PREAD = getattr(os, "pread", None)


class LocalFileSource(ByteSource):
    """A local file read with positionless os.pread — no shared cursor, no
    lock, so any number of threads read concurrently (the seek/read+position
    -restore dance of the original reader is gone, not just guarded).
    Platforms without os.pread serialize on a per-source lock instead."""

    def __init__(self, path):
        self._path = os.fspath(path)
        self._fd = os.open(self._path, os.O_RDONLY)
        self._lock = None if _PREAD is not None else threading.Lock()
        st = os.fstat(self._fd)
        self._size = st.st_size
        # identity pins the CONTENT, not just the name: a rewritten file
        # (new mtime/size/inode) can never serve another generation's blocks
        self._id = (
            f"file:{os.path.realpath(self._path)}"
            f":{st.st_ino}:{st.st_size}:{st.st_mtime_ns}"
        )
        self._closed = False

    @property
    def path(self) -> str:
        return self._path

    @property
    def source_id(self) -> str:
        return self._id

    def size(self) -> int:
        return self._size

    def read_at(self, offset: int, n: int) -> bytes:
        if offset < 0 or n < 0:
            raise ValueError(f"read_at({offset}, {n}): negative offset/length")
        if n == 0:
            return b""
        if self._closed:
            raise SourceError(f"source closed: {self._path}")
        if offset + n > self._size:
            raise SourceError(
                f"read past end of {self._path}: "
                f"[{offset}, {offset + n}) > {self._size}"
            )
        parts = []
        pos, want = offset, n
        while want:
            if _PREAD is not None:
                buf = _PREAD(self._fd, want, pos)
            else:
                with self._lock:
                    os.lseek(self._fd, pos, os.SEEK_SET)
                    buf = os.read(self._fd, want)
            if not buf:
                raise SourceError(
                    f"short read from {self._path}: wanted {n} at {offset}, "
                    f"got {n - want}"
                )
            parts.append(buf)
            pos += len(buf)
            want -= len(buf)
        _count_read(n)
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            os.close(self._fd)


class MemorySource(ByteSource):
    """An in-memory byte buffer as a source (tests, pre-staged footers,
    tiny sidecar files)."""

    def __init__(self, data, source_id: str | None = None):
        self._mv = memoryview(data)
        self._id = source_id or f"mem:{id(self):#x}:{len(self._mv)}"

    @property
    def source_id(self) -> str:
        return self._id

    def size(self) -> int:
        return len(self._mv)

    def read_at(self, offset: int, n: int) -> bytes:
        if offset < 0 or n < 0:
            raise ValueError(f"read_at({offset}, {n}): negative offset/length")
        if offset + n > len(self._mv):
            raise SourceError(
                f"read past end of memory source: [{offset}, {offset + n}) "
                f"> {len(self._mv)}"
            )
        _count_read(n)
        return bytes(self._mv[offset : offset + n])


class FileObjectSource(ByteSource):
    """Adapter over an arbitrary seekable binary file-like object.

    Prefers positionless os.pread when the object exposes a real fd;
    otherwise falls back to lock-guarded seek+read. No position restore:
    nothing above this layer shares the object's cursor anymore (every
    consumer reads through read_at), so saving and re-seeking the old
    position — the original reader's lock dance — has nothing left to
    protect."""

    def __init__(self, f):
        self._f = f
        self._lock = threading.Lock()
        try:
            self._fd = f.fileno()
        except (AttributeError, OSError, _io.UnsupportedOperation):
            self._fd = None
        with self._lock:
            pos = f.tell()
            self._size = f.seek(0, _io.SEEK_END)
            f.seek(pos)

    def size(self) -> int:
        return self._size

    def read_at(self, offset: int, n: int) -> bytes:
        if offset < 0 or n < 0:
            raise ValueError(f"read_at({offset}, {n}): negative offset/length")
        if n == 0:
            return b""
        if offset + n > self._size:
            raise SourceError(
                f"read past end of file object: [{offset}, {offset + n}) "
                f"> {self._size}"
            )
        if self._fd is not None and _PREAD is not None:
            try:
                buf = _PREAD(self._fd, n, offset)
                if len(buf) == n:
                    _count_read(n)
                    return buf
            except OSError:
                pass  # e.g. a pipe-backed fd: fall through to seek+read
        with self._lock:
            self._f.seek(offset)
            buf = self._f.read(n)
        if len(buf) != n:
            raise SourceError(
                f"short read from file object: wanted {n} at {offset}, "
                f"got {len(buf)}"
            )
        _count_read(n)
        return buf


_TRANSIENT_DEFAULT = (OSError, TimeoutError)


class RetryingSource(ByteSource):
    """Retry ladder for transient source faults (the remote-read shape).

    Each read gets up to `attempts` tries under a wall-clock `deadline_s`;
    failed attempts back off exponentially from `base_delay_s`, capped at
    `max_delay_s`, with multiplicative jitter (`jitter`, 0..1) so a fleet
    of readers retrying the same stalled store doesn't synchronize into
    waves. A short return from the inner source (a contract violation real
    transports do commit) retries like an error. Every failed attempt
    counts io_retries_total{reason=<errno name | short_read | exception
    type>}; exhausting the budget raises SourceError chained to the last
    underlying failure.

    `sleep` is injectable so tests sweep the full ladder in microseconds;
    `seed` pins the jitter stream for reproducible schedules."""

    def __init__(
        self,
        inner: ByteSource,
        *,
        attempts: int = 4,
        deadline_s: float = 30.0,
        base_delay_s: float = 0.01,
        max_delay_s: float = 2.0,
        jitter: float = 0.25,
        retry_on: tuple = _TRANSIENT_DEFAULT,
        sleep=time.sleep,
        seed: int | None = None,
    ):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        self.inner = inner
        self.attempts = attempts
        self.deadline_s = deadline_s
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.retry_on = retry_on
        self._sleep = sleep
        self._rng = random.Random(seed)

    @property
    def source_id(self) -> str:
        return self.inner.source_id

    def generation(self):
        gen = getattr(self.inner, "generation", None)
        return gen() if gen is not None else None

    def size(self) -> int:
        return self.inner.size()

    def _reason(self, exc) -> str:
        if isinstance(exc, OSError) and exc.errno:
            return _errno.errorcode.get(exc.errno, f"errno_{exc.errno}")
        return type(exc).__name__

    def read_at(self, offset: int, n: int) -> bytes:
        t0 = time.monotonic()
        last: Exception | None = None
        reason = "unknown"
        for attempt in range(self.attempts):
            try:
                buf = self.inner.read_at(offset, n)
            except ValueError:
                raise  # caller bug (negative range), not a transport fault
            except self.retry_on as e:
                # a SourceError from the inner source is TERMINAL (past-EOF,
                # source closed, a nested ladder's exhausted budget): backing
                # off cannot change it, so propagate immediately — unless the
                # caller explicitly opted SourceError into retry_on
                if isinstance(e, SourceError) and not any(
                    rt is SourceError for rt in self.retry_on
                ):
                    raise
                last, reason = e, self._reason(e)
            else:
                if len(buf) == n:
                    return buf
                last = SourceError(
                    f"inner source returned {len(buf)}/{n} bytes at {offset}"
                )
                reason = "short_read"
            _count("io_retries_total", reason=reason)
            # per-request attribution: the retry shows in this request's
            # trace (and merged multi-process view), not just the process
            # counter: a remote.get followed by io.retry reads as one story
            _trace.count("io.retry")
            # structured mirror of the counter: rate-limited per event key,
            # so a retry storm costs counters (exact) not disk (sampled)
            _log_event(
                "source_retry", level="warning", reason=reason,
                attempt=attempt + 1, offset=offset, nbytes=n,
                source=self.inner.source_id,
            )
            if attempt + 1 >= self.attempts:
                break
            delay = min(self.max_delay_s, self.base_delay_s * (2**attempt))
            delay *= 1.0 + self.jitter * self._rng.random()
            if time.monotonic() - t0 + delay > self.deadline_s:
                reason = f"{reason} (deadline)"
                break
            self._sleep(delay)
        raise SourceError(
            f"read of {n} bytes at {offset} failed after "
            f"{min(attempt + 1, self.attempts)} attempt(s) "
            f"[last: {reason}]",
            code="retry_exhausted",
        ) from last

    def read_ranges(self, ranges) -> list:
        ranges = list(ranges)
        if len(ranges) > 1:
            # fast path: ONE batched attempt through the inner source, so
            # a concurrency-capable transport (HttpSource fans read_ranges
            # out on pqt-io) keeps its parallelism under the retry ladder.
            # A retryable fault drops to the per-range ladder below —
            # healthy batch-mates may re-fetch once on that path, the
            # price of never letting one flaky range burn the batch's
            # retry budget.
            try:
                bufs = self.inner.read_ranges(ranges)
            except ValueError:
                raise  # caller bug, not a transport fault
            except self.retry_on as e:
                if isinstance(e, SourceError) and not any(
                    rt is SourceError for rt in self.retry_on
                ):
                    raise  # terminal (past-EOF, breaker open, ...)
                _count("io_retries_total", reason=self._reason(e))
            else:
                if len(bufs) == len(ranges) and all(
                    len(b) == n for b, (_o, n) in zip(bufs, ranges)
                ):
                    return bufs
                _count("io_retries_total", reason="short_read")
        # per-range retry: each range gets its own full ladder
        return [self.read_at(off, n) for off, n in ranges]

    def close(self) -> None:
        self.inner.close()


class SourceFile:
    """File-like view (seek/tell/read) over a ByteSource, with an
    INDEPENDENT cursor per instance — the compatibility shim for the page
    walks and footer parser that still speak stream. Reads clamp at EOF
    (short return, like a real file) instead of raising, so truncated-file
    corruption surfaces as the decode ladder's typed errors, exactly as
    with a plain handle."""

    __slots__ = ("_src", "_pos")

    def __init__(self, source: ByteSource):
        self._src = source
        self._pos = 0

    @property
    def source(self) -> ByteSource:
        return self._src

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        elif whence == 2:
            self._pos = self._src.size() + offset
        else:
            raise ValueError(f"invalid whence {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        end = self._src.size()
        if self._pos < 0 or self._pos >= end:
            return b""
        want = end - self._pos if n is None or n < 0 else min(n, end - self._pos)
        if want <= 0:
            return b""
        buf = self._src.read_at(self._pos, want)
        self._pos += len(buf)
        return buf

    def close(self) -> None:  # the READER owns the source's lifetime
        pass


def _wrap_policy(source: ByteSource) -> ByteSource:
    """Apply the installed resilience policy (io.hedge: chaos wrapper,
    circuit breaker, retry ladder, hedged reads) to a source open_source
    just CONSTRUCTED. The default policy is all-off and this is the
    identity; lazy import keeps source.py <-> hedge.py acyclic."""
    from .hedge import wrap_resilient

    return wrap_resilient(source)


def open_source(obj) -> tuple[ByteSource, bool]:
    """Coerce `obj` into a (ByteSource, owns) pair — the FileReader
    constructor's one entry point for every accepted source shape.

      str / Path            -> LocalFileSource       (owned: reader closes)
      bytes-like            -> MemorySource          (owned, close no-op)
      io.BytesIO            -> MemorySource snapshot (owned)
      ByteSource            -> passed through        (caller keeps lifetime)
      seekable file-like    -> FileObjectSource      (caller keeps lifetime)

    Sources this function CONSTRUCTS additionally pass through the
    process resilience policy (io.hedge.configure_resilience): with a
    policy installed, every reader/dataset/daemon open inherits breakers,
    retries and hedging here, with no per-callsite wiring. Pre-built
    ByteSource and file-like objects pass through untouched — an explicit
    stack is the caller's to compose.

    An http(s):// URL string opens an io.remote.HttpSource (range GETs on
    the pooled persistent connections), so URLs ride every path-shaped
    API — FileReader, ParquetDataset, readahead — and inherit the same
    policy stack remote reads were built for."""
    if isinstance(obj, ByteSource):
        return obj, False
    if isinstance(obj, str) and obj.startswith(("http://", "https://")):
        from .remote import HttpSource

        return _wrap_policy(HttpSource(obj)), True
    if isinstance(obj, (str, Path)):
        return _wrap_policy(LocalFileSource(obj)), True
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return _wrap_policy(MemorySource(obj)), True
    if isinstance(obj, _io.BytesIO):
        # snapshot: decouples decode from later caller mutation of the BytesIO
        return _wrap_policy(MemorySource(obj.getvalue())), True
    if hasattr(obj, "read_at") and hasattr(obj, "size"):
        return obj, False  # duck-typed source (custom remote implementations)
    if hasattr(obj, "read") and hasattr(obj, "seek"):
        return FileObjectSource(obj), False
    raise TypeError(
        f"cannot open {type(obj).__name__!r} as a byte source (expected a "
        "path, bytes, a ByteSource, or a seekable binary file object)"
    )
