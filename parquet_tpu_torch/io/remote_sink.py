"""Remote byte sinks: atomic multipart object-store writes over HTTP(S).

The write-side twin of io.remote, which makes URLs work everywhere a
*path* does for reads; this module closes the write direction with the
same typed-failure, crash-never-tears discipline that LocalFileSink pins
locally:

  HttpSink           a ByteSink over one HTTP(S) URL. Bytes accumulate in
                     memory and seal into fixed-size PARTS; each part
                     rides a bounded-in-flight PUT on the pqt-io pool
                     (S3 multipart shape: initiate -> part PUTs ->
                     complete), with per-part CRC32 verification against
                     the store's part ETag and a per-part retry ladder
                     with capped exponential backoff. The LocalFileSink
                     atomicity contract holds exactly: close() is the
                     complete-multipart COMMIT (the object appears at the
                     destination all at once or not at all), abort() is
                     abort-upload (idempotent, safe after close, never
                     destroys committed output) — a crash or fault at ANY
                     point never leaves a torn or partially-visible
                     object. An output that never overflows one part
                     skips multipart entirely: one single-shot PUT, atomic
                     by nature.
  ObjectStoreSink    the header-auth variant: HttpSink that REQUIRES a
                     request signer (explicit or resolved from the
                     io.sign registry) — writes to a real store fail at
                     construction, not with N unsigned 403s mid-upload.

Failure taxonomy (mirrors the read side; FileWriter converts sink
OSErrors to typed WriterError + auto-abort):

  transient  -> TransientSourceError absorbed by the per-part retry
               ladder: http_5xx/408/429, connection reset/timeout
               ("transport"), part_etag_mismatch (the store's CRC
               disagrees with ours — re-send the part).
  terminal   -> SinkError(code=...): other 4xx (http_403 and friends),
               retry exhaustion ("put_retry_exhausted"), breaker
               fast-fail ("breaker_open"), use-after-close. Terminal
               failures latch the sink: close() refuses to commit and
               aborts instead.

URL coercion flows through sink.open_sink, so FileWriter(sink="https://
...") / merge_files(-o URL) inherit this path with zero wiring; the
process resilience policy (io.hedge) contributes its breaker — the same
breaker->retry stack reads get — keyed per PUT origin.

Multipart wire protocol (what testing/httpstub.py's writable mode and a
thin S3 adapter both speak):

  POST   {url}?uploads                          -> {"upload_id": id}
  PUT    {url}?partNumber=N&uploadId=id  body   -> ETag: "crc32-<8hex>"
  POST   {url}?uploadId=id   {"parts": [...]}   -> {"etag": ...}  COMMIT
  DELETE {url}?uploadId=id                      -> 204            ABORT
  PUT    {url}                           body   -> single-shot (one part)

Counts (io.counts, under the reference's metric names):
io_put_requests_total{status=}, io_put_bytes_total,
io_put_retries_total{reason=}, sink_multipart_{initiated,parts,completed,
aborted}_total.

The port's copy of parquet_tpu.io.remote_sink: no traceparent header, no
trace span and no event log (the copy rule drops those hooks); a part PUT
goes straight to io_pool().
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from urllib.parse import urlsplit

from ..sink.sink import ByteSink, SinkError, _count_write
from .counts import count as _count
from .remote import (
    TransientSourceError,
    _default_port,
    host_pool,
    pooled_roundtrip,
)
from .source import SourceError

__all__ = ["HttpSink", "ObjectStoreSink"]

DEFAULT_PART_BYTES = 8 << 20
_MIN_PART_BYTES = 1 << 10  # floor: a 0-byte "part" loops forever


def _put_status_error(status: int, reason: str, context: str):
    """Status -> taxonomy for the write path: transient shapes become
    TransientSourceError (the per-part ladder absorbs them), terminal
    ones SinkError — the sink-side twin of remote._status_error."""
    msg = f"{context}: HTTP {status} {reason}"
    if status >= 500 or status in (408, 429):
        return TransientSourceError(msg, code=f"http_{status}")
    return SinkError(msg, code=f"http_{status}")


class HttpSink(ByteSink):
    """See module docstring. Single-writer like every ByteSink (the
    encode stack serializes writes); the part PUTs it launches fan out on
    the pqt-io pool and are joined at close()/abort().

    Parameters
    ----------
    url            the destination object URL (http/https)
    part_bytes     sealed part size (default 8 MiB; the bench sweeps it)
    max_in_flight  concurrent part PUTs in the air before write() blocks
                   on the oldest (memory bound = part_bytes * in-flight)
    attempts       per-part/commit retry budget (transient faults only)
    backoff_s /    capped exponential backoff between attempts
    backoff_cap_s  (sleep injectable for tests)
    signer         io.sign-style header signer; None consults the
                   configure_signer registry (no match -> unsigned)
    headers        extra headers on every request (auth tokens etc.)
    """

    def __init__(
        self,
        url: str,
        *,
        part_bytes: int = DEFAULT_PART_BYTES,
        max_in_flight: int = 4,
        timeout_s: float = 20.0,
        headers: dict | None = None,
        signer=None,
        attempts: int = 4,
        backoff_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        sleep=time.sleep,
    ):
        split = urlsplit(url)
        if split.scheme not in ("http", "https"):
            raise ValueError(
                f"HttpSink: unsupported scheme {split.scheme!r} in {url!r}"
            )
        if not split.hostname:
            raise ValueError(f"HttpSink: no host in {url!r}")
        if part_bytes < _MIN_PART_BYTES:
            raise ValueError(
                f"HttpSink: part_bytes {part_bytes} < {_MIN_PART_BYTES}"
            )
        if max_in_flight < 1:
            raise ValueError("HttpSink: max_in_flight must be >= 1")
        if attempts < 1:
            raise ValueError("HttpSink: attempts must be >= 1")
        self.url = url
        self.part_bytes = int(part_bytes)
        self.max_in_flight = int(max_in_flight)
        self.timeout_s = float(timeout_s)
        self.headers = dict(headers or {})
        self.attempts = int(attempts)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._sleep = sleep
        self._scheme = split.scheme
        self._host = split.hostname
        self._port = split.port or _default_port(split.scheme)
        self._path = split.path or "/"
        if split.query:
            raise ValueError(
                f"HttpSink: query strings are reserved for the multipart "
                f"protocol: {url!r}"
            )
        self._pool = host_pool(self._scheme, self._host, self._port)
        if signer is None:
            from .sign import signer_for

            signer = signer_for(url)
        self._signer = signer
        # the breaker the process resilience policy grants reads, keyed
        # per PUT origin: a store answering nothing but 503s fast-fails
        # the remaining parts instead of burning a full ladder on each
        from .hedge import breaker_registry, resilience_config

        policy = resilience_config()
        self._breaker = (
            (policy.registry or breaker_registry()).breaker_for(
                f"put:{self._scheme}://{self._host}:{self._port}"
            )
            if policy.breaker
            else None
        )
        netloc = (
            self._host
            if self._port == _default_port(self._scheme)
            else f"{self._host}:{self._port}"
        )
        self._id = f"http:{self._scheme}://{netloc}{self._path}"
        self._buf = bytearray()
        self._pos = 0
        self._upload_id: str | None = None
        self._next_part = 1
        self._parts: list[dict] = []  # completed part manifest entries
        self._pending: list = []  # in-flight part futures, launch order
        self._failed: BaseException | None = None
        self._committed = False
        self._aborted = False

    @property
    def sink_id(self) -> str:
        return self._id

    # -- one signed round trip with the per-part ladder ------------------------

    def _send(
        self,
        method: str,
        target: str,
        body: bytes | None,
        context: str,
        *,
        retry: bool = True,
    ):
        """One request, signed, retried through the capped-backoff ladder
        (transient shapes only — a 403 is wrong on attempt 1 and wrong on
        attempt 4). Returns (status, headers, body) for 2xx; raises the
        typed error otherwise. The breaker (when the policy grants one)
        gates every attempt and learns from every outcome."""
        # netloc must agree with the Host header http.client will send
        # (default ports omitted), or the signature never verifies
        netloc = (
            self._host
            if self._port == _default_port(self._scheme)
            else f"{self._host}:{self._port}"
        )
        url = f"{self._scheme}://{netloc}{target}"
        last: BaseException | None = None
        for attempt in range(self.attempts if retry else 1):
            if attempt:
                reason = getattr(last, "code", None) or "transport"
                _count("io_put_retries_total", reason=str(reason))
                self._sleep(
                    min(self.backoff_cap_s, self.backoff_s * (2 ** (attempt - 1)))
                )
            if self._breaker is not None:
                try:
                    self._breaker.before_read()
                except SourceError as e:
                    raise SinkError(
                        f"{context}: {e}", code="breaker_open"
                    ) from e
            hdrs = dict(self.headers)
            if self._signer is not None:
                hdrs.update(self._signer.headers(method, url, body or b""))
            try:
                status, reason_s, resp_headers, resp_body = pooled_roundtrip(
                    self._pool,
                    method,
                    target,
                    hdrs,
                    body=body,
                    timeout_s=self.timeout_s,
                    counter="io_put_requests_total",
                )
                if status >= 300:
                    raise _put_status_error(status, reason_s, context)
            except TransientSourceError as e:
                if self._breaker is not None:
                    self._breaker.record_failure()
                if not retry:
                    raise  # the caller owns the ladder (_put_part)
                last = e
                continue
            except SinkError:
                if self._breaker is not None:
                    self._breaker.record_failure()
                raise
            if self._breaker is not None:
                self._breaker.record_success()
            return status, resp_headers, resp_body
        raise SinkError(
            f"{context}: gave up after {self.attempts} attempts: {last}",
            code="put_retry_exhausted",
        ) from last

    # -- multipart plumbing ----------------------------------------------------

    def _ensure_upload(self) -> str:
        if self._upload_id is None:
            _, _, body = self._send(
                "POST", f"{self._path}?uploads", b"",
                f"initiate multipart {self.url}",
            )
            try:
                self._upload_id = str(json.loads(body or b"{}")["upload_id"])
            except (ValueError, KeyError) as e:
                raise SinkError(
                    f"initiate multipart {self.url}: malformed response "
                    f"{body[:128]!r}",
                    code="bad_initiate_response",
                ) from e
            _count("sink_multipart_initiated_total")
        return self._upload_id

    def _put_part(self, part_number: int, data: bytes) -> dict:
        """Upload ONE sealed part (runs on pqt-io or inline). The store's
        part ETag carries a CRC32 of what it RECEIVED; a mismatch with
        what we SENT is a torn transfer shaped like success — re-sent
        like any transient fault rather than trusted."""
        crc = zlib.crc32(data) & 0xFFFFFFFF
        expect = f'"crc32-{crc:08x}"'
        target = (
            f"{self._path}?partNumber={part_number}&uploadId={self._upload_id}"
        )
        context = f"part {part_number} of {self.url}"
        last: BaseException | None = None
        for attempt in range(self.attempts):
            if attempt:
                reason = getattr(last, "code", None) or "transport"
                _count("io_put_retries_total", reason=str(reason))
                self._sleep(
                    min(self.backoff_cap_s, self.backoff_s * (2 ** (attempt - 1)))
                )
            try:
                _, resp_headers, _ = self._send(
                    "PUT", target, data, context, retry=False
                )
            except TransientSourceError as e:
                last = e
                continue
            etag = resp_headers.get("ETag")
            if etag is not None and etag != expect:
                last = TransientSourceError(
                    f"{context}: part ETag {etag} != {expect} "
                    f"(torn transfer acknowledged as success)",
                    code="part_etag_mismatch",
                )
                continue
            _count("io_put_bytes_total", len(data))
            _count("sink_multipart_parts_total")
            return {
                "part_number": part_number,
                "etag": etag or expect,
                "size": len(data),
            }
        raise SinkError(
            f"{context}: gave up after {self.attempts} attempts: {last}",
            code="put_retry_exhausted",
        ) from last

    def _launch(self, data: bytes) -> None:
        """Seal `data` as the next part and put it in flight (bounded)."""
        self._ensure_upload()
        part_number = self._next_part
        self._next_part += 1
        while len(self._pending) >= self.max_in_flight:
            self._reap(self._pending.pop(0))
        if threading.current_thread().name.startswith("pqt-io"):
            # never submit-to-self: a bounded pool waiting on itself is a
            # deadlock (same degrade as HttpSource.read_ranges)
            try:
                self._parts.append(self._put_part(part_number, data))
            except BaseException as e:  # noqa: BLE001 — latched, re-raised
                if self._failed is None:
                    self._failed = e
            return
        from .planner import io_pool

        self._pending.append(io_pool().submit(self._put_part, part_number, data))

    def _reap(self, fut) -> None:
        try:
            self._parts.append(fut.result())
        except BaseException as e:  # noqa: BLE001 — latched for close/abort
            if self._failed is None:
                self._failed = e

    def _drain(self) -> None:
        while self._pending:
            self._reap(self._pending.pop(0))

    def _raise_failed(self, context: str):
        e = self._failed
        if isinstance(e, SinkError):
            raise SinkError(f"{context}: {e}", code=e.code) from e
        raise SinkError(f"{context}: {e}", code="put_failed") from e

    # -- the ByteSink contract -------------------------------------------------

    def write(self, data) -> int:
        if self._committed or self._aborted:
            raise SinkError(f"sink closed: {self.url}", code="sink_closed")
        if self._failed is not None:
            # fail the WRITE, not just the eventual close: the writer's
            # auto-abort fires now instead of encoding gigabytes into a
            # sink that can no longer commit
            self._raise_failed(f"write to {self.url}")
        n = len(data)
        self._buf += data
        self._pos += n
        _count_write(n)
        while len(self._buf) >= self.part_bytes:
            part = bytes(self._buf[: self.part_bytes])
            del self._buf[: self.part_bytes]
            self._launch(part)
            if self._failed is not None:
                self._raise_failed(f"write to {self.url}")
        return n

    def tell(self) -> int:
        return self._pos

    def flush(self) -> None:
        """A no-op by design: remote bytes are durable only at COMMIT
        (parts of an uncompleted upload are invisible), so there is no
        intermediate durability for flush to buy — and force-sealing a
        short part here would fragment the part-size the bench tunes."""

    def close(self) -> None:
        if self._committed or self._aborted:
            return
        try:
            if self._upload_id is None and not self._pending:
                # everything fits one part: single-shot PUT, atomic by
                # nature — 1 request instead of 3
                data = bytes(self._buf)
                self._buf = bytearray()
                _, resp_headers, _ = self._send(
                    "PUT", self._path, data, f"put {self.url}"
                )
                etag = resp_headers.get("ETag")
                crc = zlib.crc32(data) & 0xFFFFFFFF
                if etag is not None and etag != f'"crc32-{crc:08x}"':
                    raise SinkError(
                        f"put {self.url}: object ETag {etag} does not match "
                        f"sent bytes (torn transfer acknowledged as success)",
                        code="put_etag_mismatch",
                    )
                _count("io_put_bytes_total", len(data))
            else:
                if self._buf:
                    self._launch(bytes(self._buf))
                    self._buf = bytearray()
                self._drain()
                if self._failed is not None:
                    self._raise_failed(f"commit of {self.url}")
                manifest = json.dumps(
                    {
                        "parts": sorted(
                            self._parts, key=lambda p: p["part_number"]
                        )
                    }
                ).encode("utf-8")
                self._send(
                    "POST",
                    f"{self._path}?uploadId={self._upload_id}",
                    manifest,
                    f"complete multipart {self.url}",
                )
                _count("sink_multipart_completed_total")
        except BaseException:
            # commit did NOT happen; leave nothing behind (abort-upload
            # is best-effort — an unreachable store keeps the close()
            # error, not a second one from the cleanup)
            self.abort()
            raise
        self._committed = True

    def abort(self) -> None:
        if self._committed or self._aborted:
            return  # never destroy committed output (or double-abort)
        self._aborted = True
        self._buf = bytearray()
        # absorb in-flight parts first: an abort racing its own part PUTs
        # could otherwise delete the upload out from under them
        while self._pending:
            fut = self._pending.pop(0)
            try:
                fut.result()
            except BaseException:  # noqa: BLE001 — aborting anyway
                pass
        if self._upload_id is not None:
            try:
                self._send(
                    "DELETE",
                    f"{self._path}?uploadId={self._upload_id}",
                    None,
                    f"abort multipart {self.url}",
                    retry=False,
                )
            except BaseException:  # noqa: BLE001 — best-effort by contract
                pass
            _count("sink_multipart_aborted_total")


class ObjectStoreSink(HttpSink):
    """HttpSink that REQUIRES header-auth signing (S3/GCS shape): pass a
    signer or register one via io.sign.configure_signer — a store write
    without credentials should fail at construction, not as a stream of
    unsigned 403s mid-upload."""

    def __init__(self, url: str, *, signer=None, **kw):
        if signer is None:
            from .sign import signer_for

            signer = signer_for(url)
        if signer is None:
            raise ValueError(
                f"ObjectStoreSink: no signer for {url!r} (pass signer= or "
                "configure_signer(...))"
            )
        super().__init__(url, signer=signer, **kw)
