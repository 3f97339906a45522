"""Remote byte sources: HTTP(S) range GETs and signed-URL object stores.

The first transport that is not the local filesystem — the scenario the
whole IO stack above this module was shaped for. The planner's coalescing
and budgeted readahead, and the breaker/retry/hedge stack at the
`open_source` choke point, were built for ~ms-latency range reads; this
module puts an actual remote store under them:

  HttpSource         a ByteSource over one HTTP(S) URL. Every read_at is
                     a `Range: bytes=a-b` GET on a pooled persistent
                     connection (stdlib http.client — no new deps); size
                     and ETag come from one HEAD at open (with a
                     range-GET fallback for HEAD-less servers) and pin
                     the object GENERATION: the ETag rides the source_id
                     (so caches can never mix generations) and every
                     response is validated against it — an object
                     rewritten mid-read is a typed error, not silent
                     corruption. Batched read_ranges fans the ranges out
                     as concurrent in-flight GETs on the pqt-io pool.
  ObjectStoreSource  the S3/GCS-style presigned-URL variant: a `sign`
                     hook supplies (url, expires_at); reads re-sign
                     before the expiry horizon (refresh_margin_s) and
                     once more reactively when the store answers 403 —
                     credential rotation costs one extra round trip, not
                     a failed scan. The generation carries ACROSS
                     re-signs, so a re-signed URL pointing at different
                     bytes is caught like any rewrite.

Failure taxonomy (what the resilience stack keys on):

  terminal   -> SourceError(code=...): http_404, http_403, http_416,
               other 4xx, source_changed (ETag/size drift), read past
               EOF. The retry ladder treats SourceError as terminal —
               retrying a 404 is pure backoff waste.
  transient  -> TransientSourceError(code=...), an OSError subclass the
               retry ladder retries naturally: http_5xx, http_408/429,
               truncated_body (fewer bytes than the 206 promised),
               transport faults (reset/timeout/BadStatusLine).

URLs compose like any path: `open_source("https://...")` builds an
HttpSource and applies the installed resilience policy, so FileReader,
ParquetDataset units and readahead over URLs inherit breaker -> retry ->
hedge with zero per-callsite wiring.

Counts (io.counts): io_http_requests_total{status=},
io_http_connections_total{event=new|reused}, io_multirange_requests_total
{outcome=}, io_multirange_parts_total, io_resigns_total.

The port's copy of parquet_tpu.io.remote: no traceparent header (the copy
rule drops obs.propagate) and no trace spans. pooled_roundtrip also carries
io.remote_sink's PUT path.
"""

from __future__ import annotations

import http.client
import re
import threading
import time
from urllib.parse import urlsplit

from .counts import count as _count
from .source import ByteSource, SourceError, _count_read

__all__ = [
    "HttpSource",
    "ObjectStoreSource",
    "TransientSourceError",
    "host_pool",
    "pooled_roundtrip",
]

_MAX_HOST_POOLS = 64


class TransientSourceError(OSError):
    """A retryable transport fault (5xx, truncated body, reset): an
    OSError subclass so RetryingSource's default retry_on absorbs it, but
    typed — `code` names the fault ("http_503", "truncated_body") for
    tests and for the SourceError(code="retry_exhausted") chain when the
    ladder gives up."""

    def __init__(self, *args, code: str | None = None):
        super().__init__(*args)
        self.code = code


class _HostPool:
    """Persistent connections to ONE (scheme, host, port), checked out per
    request and returned after a fully-drained response. Bounded: past
    `max_idle` parked connections, a returned one is simply closed."""

    def __init__(self, scheme: str, host: str, port: int, *, max_idle: int = 8):
        self.scheme = scheme
        self.host = host
        self.port = port
        self.max_idle = int(max_idle)
        self._lock = threading.Lock()
        self._idle: list = []
        self._closed = False

    def acquire(self, timeout_s: float):
        """-> (connection, reused). `reused` matters to the caller: a
        parked keep-alive the server closed in the meantime fails the
        NEXT request through no fault of the source, and only reused
        connections earn the one fresh-connection retry."""
        with self._lock:
            if self._idle:
                conn = self._idle.pop()
                _count("io_http_connections_total", event="reused")
                return conn, True
        cls = (
            http.client.HTTPSConnection
            if self.scheme == "https"
            else http.client.HTTPConnection
        )
        _count("io_http_connections_total", event="new")
        return cls(self.host, self.port, timeout=timeout_s), False

    def release(self, conn) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < self.max_idle:
                self._idle.append(conn)
                return
        conn.close()

    def discard(self, conn) -> None:
        conn.close()

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
            self._closed = True
        for c in idle:
            c.close()


_pools: dict[tuple, _HostPool] = {}
_pools_lock = threading.Lock()


def host_pool(scheme: str, host: str, port: int) -> _HostPool:
    """The process-wide connection pool for one origin (every HttpSource
    to one store shares it — a thousand-shard corpus does not open a
    thousand sockets). Bounded at _MAX_HOST_POOLS origins, oldest-idle
    closed past it."""
    key = (scheme, host, port)
    with _pools_lock:
        pool = _pools.get(key)
        if pool is None:
            if len(_pools) >= _MAX_HOST_POOLS:
                _, victim = next(iter(_pools.items()))
                del _pools[(victim.scheme, victim.host, victim.port)]
                victim.close()
            pool = _HostPool(scheme, host, port)
            _pools[key] = pool
        return pool


def _default_port(scheme: str) -> int:
    return 443 if scheme == "https" else 80


def _status_error(status: int, reason: str, context: str):
    """Map one HTTP status to the failure taxonomy (returns an exception
    to raise; 2xx never reaches here)."""
    msg = f"{context}: HTTP {status} {reason}"
    if status >= 500 or status in (408, 429):
        return TransientSourceError(msg, code=f"http_{status}")
    return SourceError(msg, code=f"http_{status}")


def pooled_roundtrip(
    pool: _HostPool,
    method: str,
    target: str,
    headers: dict,
    *,
    body: bytes | None = None,
    timeout_s: float = 20.0,
    counter: str = "io_http_requests_total",
):
    """One request on a pooled connection — the shared transport core of
    HttpSource reads AND remote_sink's PUT path. Returns (status, reason,
    headers, body); transport-level failures discard the connection and
    surface as TransientSourceError(code="transport").

    A transport fault on a REUSED connection gets one silent retry on a
    fresh socket first: a parked keep-alive the server idle-closed says
    nothing about source health, and every mainstream HTTP client absorbs
    that shape rather than failing the call (with the default all-off
    resilience policy there is no ladder above to catch it). The retry
    resends `body` verbatim — every caller's requests are idempotent
    (range GET, part PUT, complete-by-manifest)."""
    for attempt in (0, 1):
        conn, reused = pool.acquire(timeout_s)
        try:
            conn.request(method, target, body=body, headers=headers)
            resp = conn.getresponse()
            # the body MUST drain fully before the connection can be
            # reused; HEAD bodies are empty by contract
            resp_body = resp.read()
        except (http.client.HTTPException, OSError, EOFError) as e:
            pool.discard(conn)
            if isinstance(e, (SourceError, TransientSourceError)):
                raise
            if reused and attempt == 0:
                continue  # stale keep-alive: once more, fresh socket
            raise TransientSourceError(
                f"http transport fault on {pool.host}:{pool.port}: "
                f"{type(e).__name__}: {e}",
                code="transport",
            ) from e
        _count(counter, status=str(resp.status))
        if resp.will_close:
            pool.discard(conn)
        else:
            pool.release(conn)
        return resp.status, resp.reason, resp.headers, resp_body


class HttpSource(ByteSource):
    """Range-GET ByteSource over one HTTP(S) URL (see module docstring).

    `size`/`etag` may be passed by a caller that already knows them (the
    ObjectStoreSource re-sign path) to skip the opening HEAD — they PIN
    the expected generation. `headers` are sent with every request
    (auth tokens etc.). Thread-safe: concurrent read_at calls each check
    a connection out of the shared per-host pool."""

    def __init__(
        self,
        url: str,
        *,
        timeout_s: float = 20.0,
        headers: dict | None = None,
        size: int | None = None,
        etag: str | None = None,
        signer=None,
    ):
        split = urlsplit(url)
        if split.scheme not in ("http", "https"):
            raise ValueError(
                f"HttpSource: unsupported scheme {split.scheme!r} in {url!r}"
            )
        if not split.hostname:
            raise ValueError(f"HttpSource: no host in {url!r}")
        self.url = url
        self.timeout_s = float(timeout_s)
        self.headers = dict(headers or {})
        self._scheme = split.scheme
        self._host = split.hostname
        self._port = split.port or _default_port(split.scheme)
        path = split.path or "/"
        self._target = f"{path}?{split.query}" if split.query else path
        self._pool = host_pool(self._scheme, self._host, self._port)
        if signer is None:
            # the registry seam: open_source("https://...") picks up header
            # signing with zero per-callsite wiring (resolved ONCE, here)
            from .sign import signer_for

            signer = signer_for(url)
        self._signer = signer
        # one-shot multi-range batches until the server proves it only
        # speaks single-range (read_ranges latches this False)
        self._multirange = True
        if size is None:
            self._size, self._etag = self._stat()
        else:
            self._size, self._etag = int(size), etag
        netloc = (
            self._host
            if self._port == _default_port(self._scheme)
            else f"{self._host}:{self._port}"
        )
        # the QUERY is deliberately excluded: a presigned URL's rotating
        # signature must not fracture the cache identity of one object
        self._id = (
            f"http:{self._scheme}://{netloc}{path}"
            f"#{self._etag or '-'}:{self._size}"
        )

    # -- identity --------------------------------------------------------------

    @property
    def source_id(self) -> str:
        return self._id

    def generation(self):
        """(size, etag): what pins this object's content generation (the
        FooterCache validates URL-keyed footers against it, the way local
        paths validate against (size, mtime))."""
        return (self._size, self._etag)

    def size(self) -> int:
        return self._size

    # -- one HTTP round trip ---------------------------------------------------

    def _request(self, method: str, extra_headers: dict | None = None):
        """One request on a pooled connection (see pooled_roundtrip, which
        holds the transport-fault semantics): merges the instance headers,
        applies the header-auth signer when one is bound."""
        hdrs = dict(self.headers)
        if extra_headers:
            hdrs.update(extra_headers)
        if self._signer is not None:
            hdrs.update(self._signer.headers(method, self.url, b""))
        return pooled_roundtrip(
            self._pool, method, self._target, hdrs, timeout_s=self.timeout_s
        )

    def _stat(self) -> tuple:
        """Learn (size, etag) via HEAD, falling back to a 1-byte range GET
        for servers that reject HEAD (405/501). One transient fault gets
        one short-backoff retry HERE: the stat runs at construction,
        BEFORE open_source has wrapped the source in the resilience
        policy, so without it a single 503 on open fails a scan the
        ladder would have absorbed one call later."""
        try:
            return self._stat_once()
        except TransientSourceError:
            time.sleep(0.05)
            return self._stat_once()

    def _stat_once(self) -> tuple:
        status, reason, headers, _ = self._request("HEAD")
        if status == 200:
            length = headers.get("Content-Length")
            if length is None:
                raise SourceError(
                    f"HEAD {self.url}: no Content-Length", code="no_size"
                )
            return int(length), headers.get("ETag")
        if status in (405, 501):
            status, reason, headers, body = self._request(
                "GET", {"Range": "bytes=0-0"}
            )
            if status == 206:
                total = (headers.get("Content-Range") or "").rpartition("/")[2]
                if total.isdigit():
                    return int(total), headers.get("ETag")
            if status == 200:
                return len(body), headers.get("ETag")
        raise _status_error(status, reason, f"stat of {self.url}")

    # -- reads -----------------------------------------------------------------

    def _validate_generation(self, headers, context: str) -> None:
        etag = headers.get("ETag")
        if self._etag and etag and etag != self._etag:
            raise SourceError(
                f"{context}: object changed (ETag {self._etag} -> {etag})",
                code="source_changed",
            )
        total = (headers.get("Content-Range") or "").rpartition("/")[2]
        if total.isdigit() and int(total) != self._size:
            raise SourceError(
                f"{context}: object changed (size {self._size} -> {total})",
                code="source_changed",
            )

    def read_at(self, offset: int, n: int) -> bytes:
        if offset < 0 or n < 0:
            raise ValueError(f"read_at({offset}, {n}): negative offset/length")
        if n == 0:
            return b""
        if offset + n > self._size:
            raise SourceError(
                f"read past end of {self.url}: "
                f"[{offset}, {offset + n}) > {self._size}"
            )
        context = f"GET {self.url} [{offset}, {offset + n})"
        hdrs = {"Range": f"bytes={offset}-{offset + n - 1}"}
        if self._etag:
            # mid-scan revalidation: a server seeing a stale validator
            # answers 200 + the CURRENT full body instead of a 206 slice
            # of bytes that no longer exist — the 200 path below then
            # surfaces the rewrite as a typed source_changed rather than
            # silently mis-slicing the new generation
            hdrs["If-Range"] = self._etag
        t0 = time.perf_counter()
        status, reason, headers, body = self._request("GET", hdrs)
        dt = time.perf_counter() - t0
        if status == 206:
            self._validate_generation(headers, context)
            if len(body) != n:
                # the transfer closed short of the promised range — the
                # transport shape RetryingSource exists to re-read
                raise TransientSourceError(
                    f"{context}: truncated body ({len(body)}/{n} bytes)",
                    code="truncated_body",
                )
            _count_read(n)
            self._observe(n, dt)
            return body
        if status == 200:
            # a server that ignores Range — or one whose If-Range check
            # failed — ships the whole CURRENT object; honest accounting
            # bills the full transfer
            self._validate_generation(headers, context)
            declared = headers.get("Content-Length")
            if declared is not None and declared.isdigit() and (
                int(declared) != self._size
            ):
                # an ETag-less server can only betray a rewrite by length
                raise SourceError(
                    f"{context}: object changed "
                    f"(size {self._size} -> {declared})",
                    code="source_changed",
                )
            if len(body) < offset + n:
                raise TransientSourceError(
                    f"{context}: truncated body "
                    f"({len(body)}/{self._size} bytes of a full-object 200)",
                    code="truncated_body",
                )
            _count_read(len(body))
            self._observe(len(body), dt)
            return body[offset : offset + n]
        raise _status_error(status, reason, context)

    def _observe(self, nbytes: int, seconds: float) -> None:
        # the SOURCE feeds the IO tuner, per request: fetch_ranges times a
        # whole batch, but read_ranges here executes its runs CONCURRENTLY
        # on pqt-io, so batch-wall / runs would underestimate per-request
        # latency by up to the pool width — only the request site knows
        # the true number (fetch_ranges skips non-"local" profiles for
        # exactly this reason)
        from .autotune import io_tuner

        io_tuner().observe(self._id, nbytes, seconds, 1)

    def read_ranges(self, ranges) -> list:
        """N coalesced runs in ONE round trip when the server speaks
        multi-range (`Range: bytes=a-b,c-d` -> 206 multipart/byteranges),
        else concurrent per-range GETs on the pqt-io pool (one pooled
        connection each). The first response proving the server doesn't
        do multi-range (single-part 206, or a 416 on the comma form)
        latches the fallback for this source's lifetime; transport faults
        fall back for THIS call without latching. From INSIDE a pqt-io
        worker (readahead tasks run there) the fan-out degrades to
        sequential — a bounded pool that submits to itself and waits is a
        deadlock."""
        ranges = list(ranges)
        if (
            len(ranges) > 1
            and self._multirange
            and sum(n for _, n in ranges) > 0
        ):
            got = self._read_multirange(ranges)
            if got is not None:
                return got
        if (
            len(ranges) <= 1
            or threading.current_thread().name.startswith("pqt-io")
        ):
            return [self.read_at(off, n) for off, n in ranges]
        from .planner import io_pool

        futs = [io_pool().submit(self.read_at, off, n) for off, n in ranges]
        out, first_err = [], None
        for f in futs:
            try:
                out.append(f.result())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if first_err is None:
                    first_err = e
                out.append(None)
        if first_err is not None:
            raise first_err
        return out

    # -- multi-range: N runs, one round trip -----------------------------------

    def _read_multirange(self, ranges):
        """One `Range: bytes=a-b,c-d` GET for every run. Returns the
        payload list on success, None to fall back to per-range GETs —
        never raises for "the server doesn't do multi-range" (that is
        the expected legacy shape, not a fault). Terminal generation
        mismatches and transport faults DO raise, exactly like read_at
        (the retry/validation ladder above owns those)."""
        for off, n in ranges:
            if off < 0 or n < 0 or off + n > self._size:
                raise SourceError(
                    f"read past end of {self.url}: "
                    f"[{off}, {off + n}) > {self._size}"
                )
        spec = ",".join(f"{off}-{off + n - 1}" for off, n in ranges if n)
        hdrs = {"Range": f"bytes={spec}"}
        if self._etag:
            hdrs["If-Range"] = self._etag
        context = f"GET {self.url} [{len(ranges)} ranges]"
        t0 = time.perf_counter()
        try:
            status, reason, headers, body = self._request("GET", hdrs)
        except TransientSourceError:
            # a transport fault says nothing about multi-range
            # support: fall back THIS call, try again next time
            _count_multirange("transport_fallback")
            return None
        dt = time.perf_counter() - t0
        ctype = (headers.get("Content-Type") or "").lower()
        if status == 206 and ctype.startswith("multipart/byteranges"):
            self._validate_generation(headers, context)
            parts = _parse_multipart_byteranges(body, ctype)
            if parts is None:
                _count_multirange("parse_fallback")
                return None
            out = []
            for off, n in ranges:
                if n == 0:
                    out.append(b"")
                    continue
                payload = parts.get((off, off + n - 1))
                if payload is None or len(payload) != n:
                    _count_multirange("parse_fallback")
                    return None
                out.append(payload)
            nbytes = sum(len(p) for p in out)
            _count_read(nbytes)
            _count("io_multirange_parts_total", len(parts))
            _count_multirange("ok")
            self._observe(nbytes, dt)
            return out
        if status == 200:
            # a Range-blind server ships the whole CURRENT object: one
            # transfer still answers every run — slice locally (and bill
            # the full body, like read_at's 200 path)
            self._validate_generation(headers, context)
            if len(body) < self._size:
                raise TransientSourceError(
                    f"{context}: truncated body "
                    f"({len(body)}/{self._size} bytes of a full-object 200)",
                    code="truncated_body",
                )
            _count_read(len(body))
            _count_multirange("full_body")
            self._observe(len(body), dt)
            return [body[off : off + n] for off, n in ranges]
        if status in (206, 416):
            # single-part 206 (the server honored ONE range) or a 416 on
            # the comma form: a legacy server — latch per-range forever
            self._multirange = False
            _count_multirange("unsupported")
            return None
        raise _status_error(status, reason, context)

    def close(self) -> None:
        pass  # connections belong to the shared per-host pool


def _count_multirange(outcome: str) -> None:
    _count("io_multirange_requests_total", outcome=outcome)


def _parse_multipart_byteranges(body: bytes, content_type: str):
    """multipart/byteranges -> {(first, last): payload}. None on any
    structural surprise (missing boundary, malformed part headers, a
    Content-Range that doesn't parse) — the caller falls back to
    per-range GETs rather than guessing."""
    m = re.search(r'boundary="?([^";,\s]+)"?', content_type)
    if m is None:
        return None
    delim = b"--" + m.group(1).encode("ascii", "replace")
    parts: dict = {}
    segments = body.split(delim)
    # segments[0] is the preamble; the last begins with "--" (the close)
    for seg in segments[1:]:
        if seg.startswith(b"--"):
            break
        seg = seg.lstrip(b"\r\n")
        head, sep, payload = seg.partition(b"\r\n\r\n")
        if not sep:
            return None
        content_range = None
        for line in head.split(b"\r\n"):
            name, _, value = line.partition(b":")
            if name.strip().lower() == b"content-range":
                content_range = value.strip()
        if content_range is None:
            return None
        cm = re.match(rb"bytes (\d+)-(\d+)/(\d+|\*)", content_range)
        if cm is None:
            return None
        first, last = int(cm.group(1)), int(cm.group(2))
        # each part ends with the CRLF that precedes the next delimiter
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        if len(payload) != last - first + 1:
            return None
        parts[(first, last)] = payload
    return parts or None


class ObjectStoreSource(ByteSource):
    """Presigned-URL object read (S3/GCS shape): HttpSource + a re-signing
    hook.

    `sign()` returns the current presigned URL — either a plain string or
    (url, expires_at_epoch_s). Reads re-sign proactively within
    `refresh_margin_s` of expiry and REACTIVELY once per read when the
    store answers 401/403 (clock skew, rotated credentials); both count
    io_resigns_total. The object's (size, ETag) generation is learned
    once and pinned across re-signs — a re-signed URL resolving to
    different bytes raises the same typed source_changed as any rewrite.
    """

    def __init__(
        self,
        sign,
        *,
        refresh_margin_s: float = 30.0,
        clock=time.time,
        timeout_s: float = 20.0,
        headers: dict | None = None,
    ):
        if not callable(sign):
            raise TypeError("ObjectStoreSource: sign must be callable")
        self._sign = sign
        self.refresh_margin_s = float(refresh_margin_s)
        self._clock = clock
        self._timeout_s = timeout_s
        self._headers = headers
        self._lock = threading.Lock()
        self._inner: HttpSource | None = None
        self._expires_at: float | None = None
        self._ensure()

    def _resign(self) -> None:
        # lock held
        signed = self._sign()
        url, expires_at = (
            signed if isinstance(signed, tuple) else (signed, None)
        )
        prev = self._inner
        self._inner = HttpSource(
            url,
            timeout_s=self._timeout_s,
            headers=self._headers,
            # carry the pinned generation across re-signs (and skip the
            # re-HEAD); the first sign learns it from the store
            size=prev._size if prev is not None else None,
            etag=prev._etag if prev is not None else None,
        )
        self._expires_at = float(expires_at) if expires_at is not None else None
        if prev is not None:
            _count("io_resigns_total")

    def _ensure(self) -> HttpSource:
        with self._lock:
            if self._inner is None or (
                self._expires_at is not None
                and self._clock() >= self._expires_at - self.refresh_margin_s
            ):
                self._resign()
            return self._inner

    def _force_resign(self, stale: HttpSource) -> HttpSource:
        with self._lock:
            if self._inner is stale:  # a racing reader may have re-signed
                self._resign()
            return self._inner

    @property
    def source_id(self) -> str:
        return self._ensure().source_id

    def generation(self):
        return self._ensure().generation()

    def size(self) -> int:
        return self._ensure().size()

    @staticmethod
    def _auth_rejected(e: SourceError) -> bool:
        return getattr(e, "code", None) in ("http_401", "http_403")

    def read_at(self, offset: int, n: int) -> bytes:
        inner = self._ensure()
        try:
            return inner.read_at(offset, n)
        except SourceError as e:
            if not self._auth_rejected(e):
                raise
            # the signature the store judged, not the clock we guessed:
            # re-sign once and retry this read before giving up
            return self._force_resign(inner).read_at(offset, n)

    def read_ranges(self, ranges) -> list:
        ranges = list(ranges)
        inner = self._ensure()
        try:
            return inner.read_ranges(ranges)
        except SourceError as e:
            if not self._auth_rejected(e):
                raise
            return self._force_resign(inner).read_ranges(ranges)

    def close(self) -> None:
        pass
