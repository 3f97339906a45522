"""The flight recorder: bounded per-request evidence for "why was request
X slow at 14:02?".

The span tracer (utils/trace.py) answers that question only if someone wrapped the read in
`decode_trace()` BEFORE it ran; the registry answers it only in aggregate.
This module retains the recent past: a lock-cheap bounded ring of
RequestRecords — id, tenant, endpoint, status, plan/pruning summary, bytes
streamed, queue-wait, per-stage timing rollup, and (for sampled, slow or
errored requests) the full span tree as a Perfetto-loadable Chrome-trace
document. The serve daemon exposes the ring at /v1/debug/requests; the
library paths (ParquetDataset units, EncodePipeline groups) record into
the SAME ring, so one listing interleaves serving and pipeline activity.

Bounds, because every input here is potentially client-controlled:

  * the ring holds at most `ObsConfig.ring_size` records — old ones
    evict (obs_ring_evictions_total), and the id index evicts WITH them;
    library one-shots (`record()`: dataset units, encode groups) live in
    a SIBLING deque under the same bound, so a busy pipeline churning
    hundreds of units/s can never evict the serve-request evidence an
    operator comes back for — one merged listing still interleaves both;
  * request ids sanitize exactly like tenant keys (charset + 64-char
    truncation) — a hostile X-Request-Id can neither grow the ring past
    its bound nor smuggle bytes into the debug JSON;
  * span trees are the expensive part, so at most `max_traces` records
    keep one (oldest dropped first, the summary record stays); a trace is
    kept when the accumulator-sampler fires (`trace_sample_rate`), and
    ALWAYS for requests that errored or exceeded `slow_ms` — the requests
    an operator actually asks about;
  * error messages truncate; everything else in a record is code-shaped
    (summary dicts, stage names) and small by construction.

The sampler is a deterministic accumulator (acc += rate; fire on
overflow), not a PRNG: rate 1.0 samples everything, 0.25 exactly every
4th, and tests replay schedules without seeding anything.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass

from ..utils import metrics as _metrics

__all__ = [
    "ObsConfig",
    "RequestRecord",
    "FlightRecorder",
    "RECORDER",
    "recorder",
    "configure",
    "sanitize_request_id",
]

_ID_OK = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._:-"
)
_MAX_ID = 64
_MAX_ERROR = 300


def sanitize_request_id(raw) -> str | None:
    """The bounded, charset-safe form of a client-supplied X-Request-Id
    (the same discipline as tenant keys): strip, truncate to 64, replace
    anything outside [A-Za-z0-9._:-] with '_'. None/empty -> None (the
    recorder generates one)."""
    if raw is None:
        return None
    rid = str(raw).strip()[:_MAX_ID]
    if not rid:
        return None
    return "".join(c if c in _ID_OK else "_" for c in rid)


@dataclass
class ObsConfig:
    """The observability knobs one daemon (or embedder) runs under."""

    ring_size: int = 512  # request records retained
    trace_sample_rate: float = 0.01  # share of OK-and-fast requests whose
    #                                  span tree is kept (error/slow: always)
    slow_ms: float = 1000.0  # at/over this wall time a request is "slow"
    max_traces: int = 16  # span trees retained (each can be ~MBs)

    def __post_init__(self):
        if self.ring_size < 1:
            raise ValueError("obs: ring_size must be >= 1")
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError("obs: trace_sample_rate must be in [0, 1]")
        if self.slow_ms <= 0:
            raise ValueError("obs: slow_ms must be positive")
        if self.max_traces < 0:
            raise ValueError("obs: max_traces must be >= 0")


class RequestRecord:
    """One request's (or pipeline unit's) retained evidence."""

    __slots__ = (
        "id",
        "seq",
        "endpoint",
        "tenant",
        "status",
        "start",
        "duration_ms",
        "bytes",
        "queue_wait_ms",
        "plan",
        "stages",
        "detail",
        "error",
        "trace_kind",
        "trace_id",
        "open",
        "_trace",
        "_t0",
    )

    def __init__(self, rid: str, seq: int, endpoint: str, tenant: str):
        self.id = rid
        self.seq = seq
        self.endpoint = endpoint
        self.tenant = tenant
        self.status = None
        self.start = time.time()
        self.duration_ms = None
        self.bytes = 0
        self.queue_wait_ms = 0.0
        self.plan = None  # the /v1/plan-shaped pruning/dry-run summary
        self.stages = None  # {stage: {seconds, bytes, calls}} rollup
        self.detail = None  # small code-shaped extras (file, group, rows)
        self.error = None
        self.trace_kind = None  # None | "sampled" | "slow" | "error" — why
        #   the span tree was KEPT; persists after max_traces evicts the
        #   tree itself (has_trace False + trace_kind set = evicted)
        self.trace_id = None  # cross-process propagation key (32 hex),
        #   set by the server from the resolved traceparent

        self.open = True
        self._trace = None  # the Chrome-trace doc, when retained
        self._t0 = time.perf_counter()

    def to_summary(self) -> dict:
        return {
            "id": self.id,
            "endpoint": self.endpoint,
            "tenant": self.tenant,
            "status": self.status,
            "start": self.start,
            "duration_ms": self.duration_ms,
            "bytes": self.bytes,
            "queue_wait_ms": self.queue_wait_ms,
            "has_trace": self._trace is not None,
            "trace_kind": self.trace_kind,
            "trace_id": self.trace_id,
            "open": self.open,
        }

    def to_dict(self) -> dict:
        out = self.to_summary()
        out["plan"] = self.plan
        out["stages"] = self.stages
        out["detail"] = self.detail
        out["error"] = self.error
        return out


class FlightRecorder:
    """The bounded ring + id index. Every mutation is O(1) under one lock
    held for dict/deque work only — no serialization, no IO."""

    def __init__(self, config: ObsConfig | None = None):
        self._config = config if config is not None else ObsConfig()
        self._lock = threading.Lock()
        self._ring: deque[RequestRecord] = deque()  # serve requests
        self._lib: deque[RequestRecord] = deque()  # library one-shots
        self._index: dict[str, RequestRecord] = {}
        self._traced: deque[RequestRecord] = deque()
        self._seq = 0
        self._sample_acc = 0.0

    @property
    def config(self) -> ObsConfig:
        return self._config

    def configure(self, config: ObsConfig) -> "FlightRecorder":
        """Apply new knobs (the ring trims immediately if shrunk)."""
        with self._lock:
            self._config = config
            self._trim_locked()
        return self

    # -- record lifecycle ------------------------------------------------------

    def begin(
        self, endpoint: str, tenant: str, request_id=None, *, library=False
    ) -> RequestRecord:
        """Open a record (listed immediately, flagged open until finish —
        an operator can see in-flight requests). `request_id` is the
        client-supplied value, already-or-not sanitized; None generates.
        `library` records (one-shots from record()) ring-buffer separately
        so pipeline churn cannot evict request evidence."""
        rid = sanitize_request_id(request_id) or uuid.uuid4().hex[:16]
        with self._lock:
            self._seq += 1
            rec = RequestRecord(rid, self._seq, endpoint, str(tenant)[:_MAX_ID])
            (self._lib if library else self._ring).append(rec)
            self._index[rid] = rec  # duplicate id: newest wins the lookup
            self._trim_locked()
        _metrics.inc("obs_requests_recorded_total", endpoint=endpoint)
        return rec

    def finish(
        self,
        rec: RequestRecord,
        status,
        *,
        nbytes: int = 0,
        error=None,
        trace=None,
        duration_s: float | None = None,
    ) -> RequestRecord:
        """Close a record: status, bytes, the trace's stage rollup and
        queue-wait, and — when sampled/slow/errored — the span tree."""
        cfg = self._config
        if duration_s is None:
            duration_s = time.perf_counter() - rec._t0
        rec.duration_ms = round(duration_s * 1e3, 3)
        rec.status = status
        rec.bytes = int(nbytes)
        if error is not None:
            rec.error = str(error)[:_MAX_ERROR]
        if trace is not None:
            rollup = trace.stage_rollup()
            rec.stages = rollup
            wait = rollup.get("pool.wait")
            if wait:
                rec.queue_wait_ms = round(wait["seconds"] * 1e3, 3)
            kind = None
            if error is not None or _is_error_status(status):
                kind = "error"
            elif rec.duration_ms >= cfg.slow_ms:
                kind = "slow"
            elif self._sample():
                kind = "sampled"
            if kind is not None and cfg.max_traces > 0:
                doc = trace.to_chrome_trace()
                req_meta = {
                    "id": rec.id,
                    "endpoint": rec.endpoint,
                    "tenant": rec.tenant,
                }
                if rec.trace_id is not None:
                    req_meta["trace_id"] = rec.trace_id
                doc.setdefault("otherData", {})["request"] = req_meta
                with self._lock:
                    rec._trace = doc
                    rec.trace_kind = kind
                    self._traced.append(rec)
                    while len(self._traced) > cfg.max_traces:
                        old = self._traced.popleft()
                        if old is not rec:
                            old._trace = None
                _metrics.inc("obs_traces_retained_total")
        rec.open = False
        return rec

    def record(
        self,
        endpoint: str,
        *,
        status="ok",
        duration_s: float = 0.0,
        nbytes: int = 0,
        detail: dict | None = None,
        error=None,
        tenant: str = "-",
    ) -> RequestRecord:
        """One-shot library record (a dataset unit, an encoded row group):
        begin+finish with an auto id, no trace, in the sibling ring."""
        rec = self.begin(endpoint, tenant, library=True)
        rec.detail = detail
        return self.finish(
            rec, status, nbytes=nbytes, error=error, duration_s=duration_s
        )

    # -- read side -------------------------------------------------------------

    def get(self, request_id) -> RequestRecord | None:
        rid = sanitize_request_id(request_id)
        if rid is None:
            return None
        with self._lock:
            return self._index.get(rid)

    def list(
        self,
        *,
        limit: int = 100,
        slow_only: bool = False,
        endpoint: str | None = None,
    ) -> list[dict]:
        """Newest-first record summaries, optionally filtered to slow
        requests (>= slow_ms) and/or one endpoint."""
        cfg = self._config
        with self._lock:
            # one interleaved listing across both rings, by open order
            records = sorted(
                [*self._ring, *self._lib], key=lambda r: r.seq
            )
        out = []
        for rec in reversed(records):
            if endpoint is not None and rec.endpoint != endpoint:
                continue
            if slow_only and not (
                rec.duration_ms is not None and rec.duration_ms >= cfg.slow_ms
            ):
                continue
            out.append(rec.to_summary())
            if len(out) >= limit:
                break
        return out

    def stats(self) -> dict:
        """Ring occupancy (the bounds tests hammer against)."""
        with self._lock:
            return {
                "records": len(self._ring) + len(self._lib),
                "requests": len(self._ring),
                "library": len(self._lib),
                "indexed": len(self._index),
                "traces": sum(1 for r in self._traced if r._trace is not None),
            }

    # -- internals -------------------------------------------------------------

    def _sample(self) -> bool:
        rate = self._config.trace_sample_rate
        if rate <= 0.0:
            return False
        with self._lock:
            self._sample_acc += rate
            if self._sample_acc >= 1.0 - 1e-12:
                self._sample_acc -= 1.0
                return True
        return False

    def _trim_locked(self) -> None:
        evicted = 0
        for ring in (self._ring, self._lib):
            while len(ring) > self._config.ring_size:
                old = ring.popleft()
                evicted += 1
                if self._index.get(old.id) is old:
                    del self._index[old.id]
                old._trace = None  # the traced deque skips cleared entries
        while len(self._traced) > max(self._config.max_traces, 0):
            self._traced.popleft()._trace = None
        if evicted:
            _metrics.inc("obs_ring_evictions_total", evicted)
        _metrics.set_gauge(
            "obs_ring_records", len(self._ring) + len(self._lib)
        )


def _is_error_status(status) -> bool:
    if isinstance(status, int):
        return status >= 400
    return status == "error"


# The process-wide ring: the serve daemon configures it from its
# ServeConfig; the dataset and encode pipelines record into it as-is.
RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return RECORDER


def configure(config: ObsConfig) -> FlightRecorder:
    """Point the process-wide recorder at `config` (what ScanService does
    at construction) and return it."""
    return RECORDER.configure(config)
