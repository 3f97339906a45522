"""Per-tenant cost accounting: who is spending the machine.

Admission (serve/admission.py) bounds what a tenant MAY do — concurrency
and a scanned-byte budget. Nothing so far records what each tenant DID:
by the time the byte-budget 429s fire, the operator still cannot name the
tenant that heated the daemon. This module is the ledger between those
two moments, fed through the request's existing scope:

  * CPU seconds — `time.thread_time()` deltas bracketing each executor
    unit (one row group decoded on a pqt-serve worker). Thread time is
    exact per-thread CPU, so concurrent tenants on one pool never bleed
    into each other's bill;
  * decoded bytes, source-read bytes, cache hits/misses — read from the
    request-scoped DecodeTrace's stage rollup when the request finishes
    (the same rollup the flight recorder stores), charged once per
    request;
  * payload bytes and request counts — from the serve handler's finish
    path.

The charge key travels on a contextvar (`cost_context(tenant)`) exactly
like the log context and the decode trace: instrumented_submit carries it
onto pool workers, so a unit task bills the tenant whose request
submitted it with no threading of arguments. The tenant value is the
ADMISSION-RESOLVED key (sanitized, truncated, overflow-collapsed), and
the ledger itself enforces the same bound (`max_tenants`, shared
`__overflow__` bucket) so an embedder bypassing admission still cannot
grow it.

Two always-on metric families ride every charge (documented in
utils/metrics.py): serve_tenant_cpu_seconds_total{tenant=} and
serve_tenant_decoded_bytes_total{tenant=}. The full usage table is served
at GET /v1/debug/tenants and by `parquet-tool debug <url> --tenants`.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar

from ..utils import metrics as _metrics

__all__ = [
    "CostLedger",
    "LEDGER",
    "ledger",
    "cost_context",
    "charged_tenant",
    "unit_clock",
    "charge_request_from_trace",
]

OVERFLOW_TENANT = "__overflow__"  # the admission layer's shared bucket

_tenant_var: ContextVar = ContextVar("pqt_cost_tenant", default=None)


def charged_tenant() -> str | None:
    """The tenant this context's work bills to (None outside a request)."""
    return _tenant_var.get()


@contextmanager
def cost_context(tenant: str | None):
    """Bind the charge key for the enclosed block — including pool work
    it submits through instrumented_submit (contextvars carry)."""
    token = _tenant_var.set(tenant)
    try:
        yield
    finally:
        _tenant_var.reset(token)


class _Usage:
    __slots__ = (
        "cpu_seconds",
        "decoded_bytes",
        "source_bytes",
        "payload_bytes",
        "cache_hits",
        "cache_misses",
        "requests",
        "units",
    )

    def __init__(self):
        self.cpu_seconds = 0.0
        self.decoded_bytes = 0
        self.source_bytes = 0
        self.payload_bytes = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.requests = 0
        self.units = 0

    def to_dict(self) -> dict:
        return {
            "cpu_seconds": round(self.cpu_seconds, 6),
            "decoded_bytes": self.decoded_bytes,
            "source_bytes": self.source_bytes,
            "payload_bytes": self.payload_bytes,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "requests": self.requests,
            "units": self.units,
        }


class CostLedger:
    """Bounded per-tenant usage accumulators (thread-safe, O(1) charges).

    Keys saturate exactly like the admission tenant table: past
    `max_tenants` distinct names everything new collapses into the shared
    overflow bucket, so a hostile header flood cannot grow the ledger or
    the serve_tenant_* label sets."""

    def __init__(self, max_tenants: int = 1024, registry=None):
        if max_tenants <= 0:
            raise ValueError("cost: max_tenants must be positive")
        self.max_tenants = int(max_tenants)
        self._registry = registry if registry is not None else _metrics.REGISTRY
        self._lock = threading.Lock()
        self._tenants: dict[str, _Usage] = {}

    def _usage(self, tenant) -> tuple[str, _Usage]:
        # caller holds self._lock
        key = str(tenant if tenant is not None else "default")[:64] or "default"
        u = self._tenants.get(key)
        if u is None:
            if len(self._tenants) >= self.max_tenants:
                key = OVERFLOW_TENANT
                u = self._tenants.get(key)
                if u is not None:
                    return key, u
            u = self._tenants[key] = _Usage()
        return key, u

    # -- charges ---------------------------------------------------------------

    def charge_cpu(self, tenant, seconds: float, units: int = 1) -> None:
        """Bill `seconds` of executor CPU (one unit's thread-time delta)."""
        if seconds < 0:
            seconds = 0.0
        with self._lock:
            key, u = self._usage(tenant)
            u.cpu_seconds += seconds
            u.units += units
        self._registry.inc(
            "serve_tenant_cpu_seconds_total", seconds, tenant=key
        )

    def charge_request(
        self,
        tenant,
        *,
        decoded_bytes: int = 0,
        source_bytes: int = 0,
        payload_bytes: int = 0,
        cache_hits: int = 0,
        cache_misses: int = 0,
    ) -> None:
        """Bill one finished request's byte/cache usage (from its trace
        rollup — see charge_request_from_trace)."""
        with self._lock:
            key, u = self._usage(tenant)
            u.decoded_bytes += int(decoded_bytes)
            u.source_bytes += int(source_bytes)
            u.payload_bytes += int(payload_bytes)
            u.cache_hits += int(cache_hits)
            u.cache_misses += int(cache_misses)
            u.requests += 1
        if decoded_bytes:
            self._registry.inc(
                "serve_tenant_decoded_bytes_total",
                int(decoded_bytes),
                tenant=key,
            )

    # -- reads -----------------------------------------------------------------

    def table(self) -> list[dict]:
        """The /v1/debug/tenants body: per-tenant usage rows, hottest CPU
        first."""
        with self._lock:
            rows = [
                {"tenant": k, **u.to_dict()} for k, u in self._tenants.items()
            ]
        rows.sort(key=lambda r: (-r["cpu_seconds"], r["tenant"]))
        return rows

    def totals(self) -> dict:
        """Usage summed across every tenant (the reconciliation side of
        the tests: per-tenant charges must sum to process totals)."""
        total = _Usage()
        with self._lock:
            for u in self._tenants.values():
                total.cpu_seconds += u.cpu_seconds
                total.decoded_bytes += u.decoded_bytes
                total.source_bytes += u.source_bytes
                total.payload_bytes += u.payload_bytes
                total.cache_hits += u.cache_hits
                total.cache_misses += u.cache_misses
                total.requests += u.requests
                total.units += u.units
        return total.to_dict()

    def reset(self) -> None:
        """Drop every accumulator (tests only)."""
        with self._lock:
            self._tenants.clear()


# the process-wide ledger the serve daemon charges (embedders may build
# their own and pass it where a ledger is accepted)
LEDGER = CostLedger()


def ledger() -> CostLedger:
    return LEDGER


@contextmanager
def unit_clock(ledger: CostLedger | None = None):
    """Bill the enclosed block's CPU (thread-time delta — exact for this
    thread, blind to neighbors) to the context's tenant. The executor
    wraps each row-group unit in one of these; outside a cost_context it
    measures and discards, costing two clock reads."""
    t0 = time.thread_time()
    try:
        yield
    finally:
        dt = time.thread_time() - t0
        tenant = _tenant_var.get()
        if tenant is not None:
            (ledger if ledger is not None else LEDGER).charge_cpu(tenant, dt)


def charge_request_from_trace(
    tenant, trace, nbytes: int = 0, ledger: CostLedger | None = None
) -> None:
    """Charge one finished request's byte/cache usage out of its
    request-scoped DecodeTrace: decoded bytes from the `decode.bytes`
    account (credited at the decompress_block choke point and by the
    fused native walk — the per-trace mirror of bytes_uncompressed_total,
    so tenant totals reconcile exactly with the process counter),
    source-read bytes from `io.read` (the planner's batched source
    fetches; the window-replay `io` stage would double-bill the same
    bytes on top), and the cache hit/miss split from the io_cache_hit/
    io_cache_miss counts BlockCache records into the active trace."""
    if tenant is None or trace is None:
        return
    rollup = trace.stage_rollup()

    def _get(stage, field):
        s = rollup.get(stage)
        return s[field] if s else 0

    decoded = _get("decode.bytes", "bytes")
    source = _get("io.read", "bytes") or _get("io", "bytes")
    (ledger if ledger is not None else LEDGER).charge_request(
        tenant,
        decoded_bytes=decoded,
        source_bytes=source,
        payload_bytes=int(nbytes),
        cache_hits=_get("io_cache_hit", "calls"),
        cache_misses=_get("io_cache_miss", "calls"),
    )
