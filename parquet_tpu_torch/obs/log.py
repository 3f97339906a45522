"""Structured JSON-lines logging with request context and rate limiting.

The package had ZERO logging until this module: noteworthy events (a
quarantined unit, a retry storm, an admission rejection, a SIGTERM drain)
either bumped a counter — visible only to someone already scraping
/metrics — or vanished. This is the operator-facing event stream that
complements the counters: one JSON object per line on a stdlib `logging`
logger, so it composes with any handler/shipper an embedder already runs.

Design rules, in order of importance:

  * the LIBRARY never prints: the "parquet_tpu_torch" logger starts with a
    NullHandler and propagate=False, so importing parquet_tpu_torch emits
    nothing anywhere until someone calls `configure_logging()` (the
    `parquet-tool serve` daemon does; embedders attach their own handler);
  * every event is rate-limited per event key through a token bucket
    (default: burst 20, refill 5/s) BEFORE formatting, so a hot failure
    loop (a flaky source retrying thousands of times a second) costs a
    counter bump, not a disk full of identical lines — the next admitted
    line carries `"suppressed": N` so the gap is visible, and
    `log_suppressed_total{event=}` counts what the limiter absorbed;
  * request context injects automatically: the serve daemon wraps each
    request in `log_context(request_id=, tenant=)` and every event logged
    anywhere below (executor, reader, source retry ladder) carries the
    ids — the grep key that joins the log stream to /v1/debug/requests;
  * emission is counted (`log_events_total{event=}`) whether or not a
    handler is attached, so tests pin wiring without configuring output.

    from parquet_tpu_torch.obs.log import configure_logging, log_event

    configure_logging()                      # JSON lines on stderr
    log_event("unit_quarantined", level="warning", file=path, group=3)
    # {"ts":"2026-08-03T14:02:11.042Z","level":"warning",
    #  "event":"unit_quarantined","request_id":"r01","file":...,"group":3}
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from datetime import datetime, timezone

from ..utils import metrics as _metrics

__all__ = [
    "log_event",
    "log_context",
    "configure_logging",
    "JsonLinesFormatter",
    "TokenBucketLimiter",
    "request_id",
    "tenant",
    "trace_id",
]

LOGGER_NAME = "parquet_tpu_torch"

_request_id_var: ContextVar = ContextVar("pqt_log_request_id", default=None)
_tenant_var: ContextVar = ContextVar("pqt_log_tenant", default=None)
_trace_id_var: ContextVar = ContextVar("pqt_log_trace_id", default=None)

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_logger = logging.getLogger(LOGGER_NAME)
# silent-by-default library discipline: no output (and no propagation into
# the embedder's root handlers) until configure_logging() opts in
_logger.addHandler(logging.NullHandler())
_logger.propagate = False


def request_id() -> str | None:
    """The request id bound to this context (None outside a request)."""
    return _request_id_var.get()


def tenant() -> str | None:
    """The tenant key bound to this context (None outside a request)."""
    return _tenant_var.get()


def trace_id() -> str | None:
    """The propagation trace-id bound to this context (None outside a
    propagated request) — the cross-PROCESS join key, where request_id
    joins within one daemon."""
    return _trace_id_var.get()


@contextmanager
def log_context(
    request_id: str | None = None,
    tenant: str | None = None,
    trace_id: str | None = None,
):
    """Bind request_id/tenant/trace_id for every log_event in the enclosed
    block — including pool workers the block submits through
    instrumented_submit (contextvars carry, exactly like the decode
    trace)."""
    tok_r = _request_id_var.set(request_id)
    tok_t = _tenant_var.set(tenant)
    tok_tr = _trace_id_var.set(trace_id)
    try:
        yield
    finally:
        _request_id_var.reset(tok_r)
        _tenant_var.reset(tok_t)
        _trace_id_var.reset(tok_tr)


class TokenBucketLimiter:
    """Per-key token bucket: `burst` immediate events per key, refilling at
    `rate` per second. admit() returns (admitted, suppressed_since_last) so
    the first line after a suppression window can say how much it hides.
    Keys are CODE-controlled event names — the table is bounded by the
    vocabulary of call sites, never by input."""

    def __init__(self, rate: float = 5.0, burst: int = 20, clock=time.monotonic):
        if rate <= 0 or burst < 1:
            raise ValueError("log limiter: rate must be > 0 and burst >= 1")
        self.rate = float(rate)
        self.burst = int(burst)
        self._clock = clock
        self._lock = threading.Lock()
        self._state: dict[str, list] = {}  # key -> [tokens, last, suppressed]

    def admit(self, key: str) -> tuple[bool, int]:
        now = self._clock()
        with self._lock:
            st = self._state.get(key)
            if st is None:
                st = self._state[key] = [float(self.burst), now, 0]
            st[0] = min(float(self.burst), st[0] + (now - st[1]) * self.rate)
            st[1] = now
            if st[0] >= 1.0:
                st[0] -= 1.0
                suppressed, st[2] = st[2], 0
                return True, suppressed
            st[2] += 1
            return False, st[2]


_limiter = TokenBucketLimiter()
_limiter_lock = threading.Lock()


def set_limiter(limiter: TokenBucketLimiter) -> TokenBucketLimiter:
    """Swap the process-wide rate limiter (tests inject a pinned clock);
    returns the previous one so tests can restore it."""
    global _limiter
    with _limiter_lock:
        prev, _limiter = _limiter, limiter
    return prev


class JsonLinesFormatter(logging.Formatter):
    """One JSON object per line: ts / level / event / request context /
    event fields. Values that don't serialize render via str() — a log
    line must never raise."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": datetime.fromtimestamp(record.created, timezone.utc)
            .isoformat(timespec="milliseconds")
            .replace("+00:00", "Z"),
            "level": record.levelname.lower(),
            "event": getattr(record, "pqt_event", record.getMessage()),
        }
        rid = getattr(record, "pqt_request_id", None)
        if rid is not None:
            doc["request_id"] = rid
        ten = getattr(record, "pqt_tenant", None)
        if ten is not None:
            doc["tenant"] = ten
        tid = getattr(record, "pqt_trace_id", None)
        if tid is not None:
            doc["trace_id"] = tid
        fields = getattr(record, "pqt_fields", None)
        if fields:
            for k, v in fields.items():
                doc.setdefault(k, v)  # reserved keys (ts/level/event) win
        return json.dumps(doc, default=str)


def configure_logging(stream=None, level=logging.INFO) -> logging.Handler:
    """Attach the JSON-lines handler (stderr by default) and open the
    logger at `level`. Replaces a previously configured obs handler, so
    calling it twice (two ScanServers in one process) doesn't double every
    line. Returns the handler (tests hand a StringIO and detach after)."""
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    handler.setFormatter(JsonLinesFormatter())
    handler._pqt_obs_handler = True  # the replace-don't-stack marker
    for h in list(_logger.handlers):
        if getattr(h, "_pqt_obs_handler", False):
            _logger.removeHandler(h)
    _logger.addHandler(handler)
    _logger.setLevel(level)
    return handler


def log_event(event: str, *, level: str = "info", **fields) -> bool:
    """Emit one structured event (rate-limited per event key). Returns
    True when the line was admitted, False when the limiter absorbed it.
    Either way the always-on registry counts it (log_events_total /
    log_suppressed_total), so wiring is testable with no handler."""
    admitted, suppressed = _limiter.admit(event)
    if not admitted:
        _metrics.inc("log_suppressed_total", event=event)
        return False
    _metrics.inc("log_events_total", event=event)
    if suppressed:
        fields = {**fields, "suppressed": suppressed}
    _logger.log(
        _LEVELS.get(level, logging.INFO),
        event,
        extra={
            "pqt_event": event,
            "pqt_fields": fields,
            "pqt_request_id": _request_id_var.get(),
            "pqt_tenant": _tenant_var.get(),
            "pqt_trace_id": _trace_id_var.get(),
        },
    )
    return True
