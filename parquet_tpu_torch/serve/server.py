"""The scan daemon: a concurrent scan/query HTTP service over the card.

The port of parquet_tpu/serve/server.py. stdlib-only
(ThreadingHTTPServer — one thread per connection, scan and query work on
the bounded pqt-serve pool):

  POST /v1/scan     {"paths": ..., "columns": ..., "filters": ..., "limit":
                    ..., "format": "jsonl", "shard": [i, n]} → chunked-
                    transfer jsonl stream of the rows. Headers: `X-Tenant`
                    (budget accounting key), `X-Timeout-Ms` (deadline
                    override).
  POST /v1/query    {"paths": ..., "filters": ..., "aggregates":
                    [["count"], ["sum", "v"], ...], "group_by": [...],
                    "max_groups": N} → ONE small JSON body: aggregation
                    push-down, each row-group unit filtered and reduced on
                    the daemon's torch.device (serve/query_device) on the
                    pqt-serve pool and merged exactly (serve/aggregate.py).
                    Same admission/budget/deadline discipline as /v1/scan.
  GET  /v1/plan     dry-run of the same request (query params or POSTed
                    body): pruned vs total row groups, estimated bytes —
                    zero source reads when the footer cache is warm.
  POST /v1/append   one jsonl row batch into the lake table (`?flush=1`
                    commits a generation before the ack).
  GET  /metrics     Prometheus text exposition of the serve counters
                    (serve.counts.serve_counts()) and the query units'
                    engines (query_device_units_total{engine=}).
  GET  /healthz     {"status": "ok"|"degraded"|"draining", "in_flight": n,
                    "slo": verdict}; 503 while draining so load balancers
                    stop routing here.
  GET  /v1/debug/vars  daemon snapshot: uptime, pid, version, pool sizes
                    and depths, resilience policy, cache/admission budgets.
  GET  /v1/debug/slo  the burn-rate engine's verdict (ok/warn/burning)
                    + per-window math (obs/slo.py); the same verdict
                    folds into /healthz as "degraded" at 200.

Error discipline: EVERY failure renders as a structured JSON body
({"error": {code, message, status, request_id}}) — never a traceback.
Failures after the 200 header is sent (the stream already started) emit a
terminal `{"error": ...}` line and abort the chunked encoding WITHOUT the
terminating 0-chunk, so clients always detect the torn transfer instead
of mistaking a prefix for the full result.

Shutdown: SIGTERM/SIGINT (install_signal_handlers) or drain() begin a
graceful drain — new requests get typed 503s while in-flight ones run to
completion — then the listener stops; close() commits the ingest tail.

What the reference's hooks became in the port:

  utils.metrics     the counters are plain counts in
                    serve.counts.serve_counts() under the reference's
                    names; the serve_request_seconds histogram and its
                    exemplars are dropped, and /metrics renders counters
                    only, in the classic text format, whatever the Accept
                    header asks for (OpenMetrics included);
  utils.trace       decode_trace (the request-scoped trace) is dropped;
  obs.recorder      the flight-recorder ring and /v1/debug/requests[/<id>
                    [/trace]] are cut; sanitize_request_id and the id mint
                    are copied, so X-Request-Id is echoed (or minted for
                    scan, query, plan and append) and error bodies carry
                    request_id; the ring's knobs (trace_sample_rate,
                    debug_ring_size, debug_max_traces) are gone, slow_ms
                    stays and drives serve_slow_requests_total;
  obs.propagate     dropped: no traceparent is echoed and error bodies
                    carry no trace_id;
  obs.cost          dropped, with /v1/debug/tenants;
  obs.log           dropped: slow requests count in
                    serve_slow_requests_total, drains in
                    serve_drains_total{drained=}, admission rejections in
                    admission_rejected_total{code=};
  obs.prof          dropped, with /v1/debug/profile;
  obs.fleet         dropped, with /v1/debug/fleet;
  obs.slo           ported (obs/slo.py): /v1/debug/slo and /healthz's
                    "slo" field and "degraded" status;
  obs.pool          instrumented_submit is serve.counts.submit (no context
                    carry), pool_depths its serve_pool_stats().

The cut debug routes answer a typed 501 not_ported naming the cut module,
and so does a format="arrow-ipc" scan (the stream needs pyarrow), refused
before admission.

ServeConfig.device takes None, a string or a torch.device. None means
CUDA, by the port's rule, and a daemon without CUDA and without device=
raises at construction; device="cpu" runs the kernels' plain versions.
(The reference's None means its pyarrow host engine, which the port does
not have: a query unit outside the device envelope answers a typed 400
device_declined, counted in query_device_counts().)
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from ..core.reader import PARQUET_ERRORS, host_threads, resolve_device
from ..io.cache import BlockCache
from ..io.planner import IO_THREADS
from ..obs.slo import BurnRateEngine, SLOObjective
from . import counts as _counts
from .admission import AdmissionController
from .executor import SERVE_THREADS, execute_query, execute_stream, not_ported_format
from .protocol import (
    ScanRequest,
    ServeError,
    parse_query_request,
    parse_scan_request,
    scan_request_from_query,
)
from .session import ScanSession
from ..utils.counters import key as _key

__all__ = ["ServeConfig", "ScanService", "ScanServer", "sanitize_request_id"]

_ID_OK = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._:-"
)
_MAX_ID = 64


def sanitize_request_id(raw) -> str | None:
    """The bounded, charset-safe form of a client-supplied X-Request-Id
    (the same discipline as tenant keys): strip, truncate to 64, replace
    anything outside [A-Za-z0-9._:-] with '_'. None/empty -> None (the
    daemon mints one)."""
    if raw is None:
        return None
    rid = str(raw).strip()[:_MAX_ID]
    if not rid:
        return None
    return "".join(c if c in _ID_OK else "_" for c in rid)


def _mint_request_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class ServeConfig:
    """Everything a daemon instance is allowed to do, in one place."""

    host: str = "127.0.0.1"
    port: int = 8080
    root: str | None = None  # confine requested paths to this directory
    cache_mb: int = 64  # shared block cache (0 disables)
    # tiered cache: cache_disk_mb > 0 grows the block cache into a RAM ->
    # local-disk TieredCache (io/tiercache.py) spilling to cache_dir (a
    # private temp dir when None; a given dir is REUSED across restarts —
    # intact spilled blocks re-serve after a crash). The RAM tier is
    # cache_mb (its default applies when 0 but a disk tier is asked for).
    cache_disk_mb: int = 0
    cache_dir: str | None = None
    # resolve the read coalesce gap (and readahead depth) per fetch from
    # the observed per-transport latency profile (io/autotune.py): local
    # corpora keep the 64 KiB default, remote-backed source factories
    # coalesce MiB-scale
    io_autotune: bool = False
    max_inflight: int = 32
    tenant_concurrent: int = 8
    tenant_budget_mb: int | None = None  # scanned-byte budget per window
    budget_window_s: float = 60.0
    default_timeout_s: float | None = 30.0
    max_timeout_s: float = 300.0
    # brownout: shed NEW scans with typed 503s + Retry-After once the
    # pqt-serve pool's windowed mean queue wait crosses brownout_wait_ms
    # (or its queue depth crosses brownout_depth) — degrade loudly and
    # early instead of admitting work that will only 504 later. None
    # disables (the default: an explicitly sized deployment opts in).
    brownout_wait_ms: float | None = None
    brownout_depth: int | None = None
    brownout_window_s: float = 2.0
    window: int = 2  # per-request unit lookahead (backpressure bound)
    # request bodies are small JSON specs; a client-declared Content-Length
    # is rejected with a typed 413 past this, BEFORE any bytes are buffered
    max_body_bytes: int = 1 << 20
    # the write path: a lake-table directory (lake/manifest.py) arms
    # POST /v1/append on this replica — batches buffer in the ingest
    # writer and commit one manifest generation per flush. None keeps the
    # daemon read-only (/v1/append answers a typed 503 ingest_disabled).
    # The table is created on demand with lake_schema (DSL text) when the
    # directory is not yet a table; lake_sort_key orders flushed files'
    # row groups (and drives compaction's sort stage).
    lake_root: str | None = None
    lake_schema: str | None = None
    lake_sort_key: str | None = None
    lake_flush_mb: int = 4  # ingest buffer bound; a flush commits a generation
    # append bodies are DATA, not specs: they get their own, larger cap
    max_append_bytes: int = 32 << 20
    # per-socket-op timeout: a client that stalls (stops sending its body,
    # or accepts the 200 and stops reading) would otherwise pin its handler
    # thread AND its admission ticket forever — the cooperative deadline
    # can't fire while the thread is blocked in a socket call
    socket_timeout_s: float = 60.0
    shard: tuple | None = None  # this daemon's (index, count) corpus stripe
    source_factory: object = None  # chaos/remote seam: path -> ByteSource
    # {path prefix -> object-store base URL}: requested paths under a
    # mapped prefix resolve to URLs and read through the shared block/
    # footer caches; everything else stays root-confined (escapes 403)
    remote_map: dict | None = None
    # the torch.device POST /v1/query units decode and reduce on: None is
    # CUDA (construction raises without it), or a string / torch.device
    # ("cpu" runs the kernels' plain versions). The reference's None is
    # its pyarrow host engine, which the port does not have: a unit outside
    # the device envelope answers a typed 400 device_declined.
    device: object = None
    # a PRE-BUILT BlockCache/TieredCache (caller-owned, survives close()):
    # how a daemon and co-resident dataset workers pool ONE tier budget.
    # Overrides cache_mb/cache_disk_mb.
    block_cache: object = None
    slow_ms: float = 1000.0  # serve_slow_requests_total bar
    # the SLO this replica promises (obs/slo.py burn-rate engine): the
    # availability objective over server-side failures (5xx), and an
    # optional latency bar — None disables the latency SLI. The verdict
    # serves /v1/debug/slo and folds into /healthz as "degraded".
    slo_availability: float = 0.999
    slo_p99_ms: float | None = None
    # test/chaos seam (like source_factory): a pre-built BurnRateEngine —
    # how fake-clock tests replay a fault schedule deterministically
    slo_engine: object = None

    def __post_init__(self):
        if self.window < 1:
            raise ValueError("serve: window must be >= 1")
        if self.cache_mb < 0:
            raise ValueError("serve: cache_mb must be >= 0")
        if self.cache_disk_mb < 0:
            raise ValueError("serve: cache_disk_mb must be >= 0")
        if self.socket_timeout_s is not None and self.socket_timeout_s <= 0:
            raise ValueError("serve: socket_timeout_s must be positive")
        if self.max_body_bytes < 1:
            raise ValueError("serve: max_body_bytes must be >= 1")
        if self.max_append_bytes < 1:
            raise ValueError("serve: max_append_bytes must be >= 1")
        if self.lake_flush_mb < 1:
            raise ValueError("serve: lake_flush_mb must be >= 1")
        if self.default_timeout_s is not None and self.default_timeout_s <= 0:
            raise ValueError(
                "serve: default_timeout_s must be positive (None disables)"
            )
        if self.max_timeout_s <= 0:
            raise ValueError("serve: max_timeout_s must be positive")
        if self.brownout_wait_ms is not None and self.brownout_wait_ms <= 0:
            raise ValueError(
                "serve: brownout_wait_ms must be positive (None disables)"
            )
        if self.brownout_depth is not None and self.brownout_depth <= 0:
            raise ValueError(
                "serve: brownout_depth must be positive (None disables)"
            )
        if self.brownout_window_s <= 0:
            raise ValueError("serve: brownout_window_s must be positive")
        if self.slow_ms <= 0:
            raise ValueError("serve: slow_ms must be positive")
        # validate the shard assignment AT STARTUP: a daemon silently
        # serving the wrong stripe (shard index past the count) would
        # answer every request with a plausible-looking empty subset —
        # the one misconfiguration a mesh cannot detect from outside
        if self.shard is not None:
            try:
                i, n = (int(x) for x in tuple(self.shard))
            except (TypeError, ValueError):
                raise ValueError(
                    f"serve: shard must be (index, count), got {self.shard!r}"
                ) from None
            if n < 1 or not 0 <= i < n:
                raise ValueError(
                    f"serve: shard index {i} out of range for count {n} "
                    "(need n >= 1 and 0 <= index < count)"
                )
            self.shard = (i, n)
        # the SLO knobs: SLOObjective owns their invariants
        if self.slo_engine is None:
            SLOObjective(
                availability=self.slo_availability, p99_ms=self.slo_p99_ms
            )


class ScanService:
    """The daemon's request brain, HTTP-free so tests and embedders drive
    it directly: session (shared caches + confinement) + admission."""

    def __init__(self, config: ServeConfig):
        self.config = config
        # first: no CUDA and no device= raises before anything is built
        self.device = resolve_device(config.device)
        if config.block_cache is not None:
            block_cache = config.block_cache
            self._owns_cache = False
        elif config.cache_disk_mb:
            from ..io.tiercache import TieredCache

            block_cache = TieredCache(
                ram_bytes=(config.cache_mb or 64) << 20,
                disk_bytes=config.cache_disk_mb << 20,
                cache_dir=config.cache_dir,
            )
            self._owns_cache = True
        elif config.cache_mb:
            block_cache = BlockCache(config.cache_mb << 20)
            self._owns_cache = True
        else:
            block_cache = None
            self._owns_cache = True
        self.session = ScanSession(
            root=config.root,
            block_cache=block_cache,
            source_factory=config.source_factory,
            shard=config.shard,
            coalesce_gap="auto" if config.io_autotune else None,
            remote_map=config.remote_map,
        )
        self.admission = AdmissionController(
            max_inflight=config.max_inflight,
            tenant_concurrent=config.tenant_concurrent,
            tenant_budget_bytes=(
                config.tenant_budget_mb << 20
                if config.tenant_budget_mb is not None
                else None
            ),
            budget_window_s=config.budget_window_s,
            default_timeout_s=config.default_timeout_s,
            max_timeout_s=config.max_timeout_s,
            brownout_wait_s=(
                config.brownout_wait_ms / 1e3
                if config.brownout_wait_ms is not None
                else None
            ),
            brownout_depth=config.brownout_depth,
            brownout_window_s=config.brownout_window_s,
        )
        self.started_at = time.time()
        # the burn-rate health engine: fed one sample per finished
        # recorded request (_Handler._finish), read by /v1/debug/slo and
        # /healthz. A config-passed engine (fake clock) wins.
        if config.slo_engine is not None:
            self.slo = config.slo_engine
        else:
            self.slo = BurnRateEngine(
                SLOObjective(
                    availability=config.slo_availability,
                    p99_ms=config.slo_p99_ms,
                )
            )
        # the write path (lake/): /v1/append buffers into this writer and
        # commits one manifest generation per flush. Built at startup so
        # a misconfigured lake root fails the daemon, not the first append.
        self.lake = None
        self.ingest = None
        if config.lake_root is not None:
            from ..lake.ingest import IngestWriter
            from ..lake.manifest import LakeError, LakeTable

            try:
                self.lake = LakeTable.open(config.lake_root)
            except LakeError:
                if config.lake_schema is None:
                    raise
                self.lake = LakeTable.create(
                    config.lake_root, config.lake_schema,
                    sort_key=config.lake_sort_key,
                )
            self.ingest = IngestWriter(
                self.lake, flush_bytes=config.lake_flush_mb << 20
            )

    # -- request entry points (raise ServeError; HTTP layer renders) -----------

    def plan(self, request) -> dict:
        """The /v1/plan dry-run body (no admission: planning is cheap and
        cached; hammering /v1/plan cannot starve scans of pool threads)."""
        return self.session.plan(request).summary()

    def scan(self, request, tenant: str, timeout_ms=None):
        """Admit, plan, charge, and open the result stream. Returns
        (ticket, content_type, chunk iterator); the caller MUST close the
        iterator and release the ticket (both context-manage safely). A
        format the port does not stream (arrow-ipc) is refused first,
        before admission."""
        if request.format != "jsonl":
            raise not_ported_format(request.format)
        deadline = self.admission.deadline_for(
            timeout_ms if timeout_ms is not None else request.timeout_ms
        )
        ticket = self.admission.admit(tenant)
        try:
            planned = self.session.plan(request)
            # ticket.tenant is the RESOLVED accounting key (it may have
            # collapsed to the overflow bucket under tenant-table pressure)
            self.admission.charge(ticket.tenant, planned.estimated_bytes)
            deadline.check()
            chunks = execute_stream(
                planned,
                self.session,
                deadline=deadline,
                window=self.config.window,
                device=self.device,
            )
        except BaseException:
            ticket.release()
            raise
        return ticket, "application/x-ndjson", chunks

    def query(self, request, tenant: str, timeout_ms=None):
        """POST /v1/query: aggregation push-down. Admission is EXACTLY the
        scan discipline — same ticket, same deadline clamp, and the tenant
        byte budget is charged with the same plan estimate (aggregation
        must not become a budget bypass: the daemon still decodes those
        bytes, it just doesn't ship them). Returns (ticket, body dict); the
        caller renders and must release the ticket."""
        from .aggregate import query_columns

        deadline = self.admission.deadline_for(
            timeout_ms if timeout_ms is not None else request.timeout_ms
        )
        ticket = self.admission.admit(tenant)
        try:
            cols = query_columns(request)
            planned = self.session.plan(
                ScanRequest(
                    paths=request.paths,
                    # [] is meaningful: a pure count(*) decodes nothing and
                    # its plan estimate is zero bytes
                    columns=cols,
                    filters=request.filters,
                    limit=None,
                    format="jsonl",
                    shard=request.shard,
                    timeout_ms=request.timeout_ms,
                )
            )
            self.admission.charge(ticket.tenant, planned.estimated_bytes)
            deadline.check()
            body = execute_query(
                planned,
                request,
                self.session,
                deadline=deadline,
                window=self.config.window,
                device=self.device,
            )
        except BaseException:
            ticket.release()
            raise
        return ticket, body

    def append(self, body: bytes, content_type, tenant: str, *,
               flush: bool = False):
        """POST /v1/append: one row batch into the lake table's ingest
        buffer. Admission is the scan discipline — same ticket, and the
        tenant byte budget is charged the BODY size up front (ingest work
        scales with payload exactly the way scans scale with plan bytes).
        Returns (ticket, ack dict); the caller releases the ticket."""
        if self.ingest is None:
            raise ServeError(
                503, "ingest_disabled",
                "this replica serves no lake table (start it with a "
                "--lake root to accept appends)",
            )
        from ..lake.ingest import rows_from_payload
        from ..lake.manifest import LakeError

        ticket = self.admission.admit(tenant)
        try:
            self.admission.charge(ticket.tenant, len(body))
            try:
                rows = rows_from_payload(body, content_type)
                if not rows:
                    raise ServeError(
                        400, "bad_request", "append body holds no rows"
                    )
                ack = self.ingest.append(rows, flush=flush)
            except LakeError as e:
                raise _lake_serve_error(e) from None
            except ServeError:
                # ServeError subclasses ValueError: already typed, keep it
                raise
            except PARQUET_ERRORS + (ValueError,) as e:
                # schema-shaped failures (a row that doesn't shred:
                # ShredError/WriterError are ValueErrors) are the
                # CLIENT's rows being wrong, not the daemon
                raise ServeError(
                    422, "bad_rows", f"{type(e).__name__}: {e}"
                ) from None
        except BaseException:
            ticket.release()
            raise
        return ticket, ack

    def healthz(self) -> tuple[int, dict]:
        draining = self.admission.draining
        verdict = self.slo.evaluate()["verdict"]
        # draining wins (the replica must not be routed to AT ALL, 503);
        # burning degrades at 200 — still serving, a router may merely
        # deprioritize it. "warn" stays "ok": /healthz is a routing
        # signal, not a pager (the full math lives at /v1/debug/slo).
        if draining:
            status_str = "draining"
        elif verdict == "burning":
            status_str = "degraded"
        else:
            status_str = "ok"
        in_flight = self.admission.in_flight
        body = {
            "status": status_str,
            "in_flight": in_flight,
            "slo": verdict,
        }
        if draining:
            # the mesh client's failover reads this to tell "drains in a
            # couple seconds, come back" from "gone" — the remaining
            # in-flight count above says how much work is still leaving
            body["retry_after_s"] = min(30, 1 + in_flight)
        return (503 if draining else 200), body

    # -- the /v1/debug bodies (HTTP-free, like plan/scan) ----------------------

    def debug_slo(self) -> dict:
        """GET /v1/debug/slo: the burn-rate engine's full verdict + window
        math."""
        return self.slo.evaluate()

    def debug_vars(self) -> dict:
        """The /v1/debug/vars snapshot: uptime, pid, version, the pools,
        resilience policy, cache/admission budgets — the reference's body
        without its "obs" knobs (cut with the flight recorder) and
        "process" self-stats (cut with the metrics registry). "pools"
        holds the pool-sizing variables the port reads ("env", where
        set), the worker counts of the process-wide pools ("sizes", the
        port's own key) and the pqt-serve pool's depths."""
        from .. import __version__ as _version
        from ..io.autotune import io_tuner as _io_tuner
        from ..io.hedge import resilience_config

        cfg = self.config
        res = resilience_config()
        pool = _counts.serve_pool_stats()
        uptime = round(time.time() - self.started_at, 3)
        return {
            "pid": os.getpid(),
            "version": _version,
            "uptime_s": uptime,
            "started_at": self.started_at,
            "pools": {
                "env": {
                    k: os.environ[k]
                    for k in ("PQT_HOST_THREADS", "PQT_DATA_THREADS")
                    if k in os.environ
                },
                "sizes": {
                    _counts.POOL: SERVE_THREADS,
                    "pqt-host": host_threads(),
                    "pqt-io": IO_THREADS,
                },
                "depths": {
                    _counts.POOL: {
                        k: pool[k] for k in ("queued", "active")
                    }
                },
            },
            "serve": {
                "root": cfg.root,
                "cache_mb": cfg.cache_mb,
                "cache_disk_mb": cfg.cache_disk_mb,
                "cache_dir": cfg.cache_dir,
                "io_autotune": cfg.io_autotune,
                "max_inflight": cfg.max_inflight,
                "tenant_concurrent": cfg.tenant_concurrent,
                "tenant_budget_mb": cfg.tenant_budget_mb,
                "budget_window_s": cfg.budget_window_s,
                "default_timeout_s": cfg.default_timeout_s,
                "max_timeout_s": cfg.max_timeout_s,
                "brownout_wait_ms": cfg.brownout_wait_ms,
                "brownout_depth": cfg.brownout_depth,
                "window": cfg.window,
                "max_body_bytes": cfg.max_body_bytes,
                "socket_timeout_s": cfg.socket_timeout_s,
                "shard": list(cfg.shard) if cfg.shard else None,
            },
            "lake": (
                {
                    "root": self.lake.root,
                    "sort_key": self.lake.sort_key,
                    "generation": self.lake.manifest.current_generation(),
                    "flush_mb": cfg.lake_flush_mb,
                    "max_append_bytes": cfg.max_append_bytes,
                    "buffered_rows": (
                        self.ingest.buffered_rows
                        if self.ingest is not None
                        else 0
                    ),
                }
                if self.lake is not None
                else None
            ),
            "slo": {
                "availability": self.slo.objective.availability,
                "p99_ms": self.slo.objective.p99_ms,
            },
            "resilience": {
                "breaker": res.breaker,
                "retry": res.retry,
                "hedge": res.hedge,
            },
            "cache": (
                self.session.block_cache.stats()
                if self.session.block_cache is not None
                else None
            ),
            "io_autotune": _io_tuner().stats(),
        }


def _count_request(tenant: str, status: int) -> None:
    _counts.count("serve_requests_total", status=str(status), tenant=tenant)


# the LakeError -> ServeError taxonomy map: lake codes stay the error
# currency end to end, the HTTP layer only picks the status
_LAKE_STATUS = {
    "unsupported_format": 415,
    "bad_payload": 400,
    "bad_manifest": 500,
    "no_such_generation": 404,
    "no_such_table": 503,
    "commit_conflict": 409,
    "closed": 503,
}


def _lake_serve_error(e) -> "ServeError":
    code = getattr(e, "code", "lake_error")
    return ServeError(_LAKE_STATUS.get(code, 500), code, str(e))


# the reference's debug routes whose module the port does not carry
_CUT_ROUTES = {
    "/v1/debug/requests": "obs.recorder (the flight recorder)",
    "/v1/debug/profile": "obs.prof (the sampling profiler)",
    "/v1/debug/tenants": "obs.cost (the tenant cost ledger)",
    "/v1/debug/fleet": "obs.fleet (the fleet scrape)",
}


def _cut_route(route: str):
    for prefix, module in _CUT_ROUTES.items():
        if route == prefix or route.startswith(prefix + "/"):
            return ServeError(
                501, "not_ported",
                f"{prefix} is not served by this daemon: it needs {module}, "
                "which parquet_tpu_torch does not port",
            )
    return None


# `# HELP` lines of the families /metrics renders (the reference's texts;
# the last two families are the port's own)
_HELP = {
    "serve_requests_total": "scan-service requests finished, by status and tenant",
    "serve_scan_bytes_total": "response payload bytes streamed by /v1/scan",
    "serve_slow_requests_total": "requests at/over the slow_ms threshold, per endpoint",
    "serve_shed_total": "requests shed before execution, per reason",
    "serve_aggregate_requests_total": (
        "aggregation push-down queries executed (/v1/query and the CLI twin)"
    ),
    "events_total": "torn chunked streams (serve_stream_aborted)",
    "query_device_units_total": "query units by engine (device, declined)",
    "admission_rejected_total": "typed admission rejections, per code",
    "serve_drains_total": "graceful drains, by whether they drained in time",
}
_PREFIX = "parquet_tpu_"


def render_metrics() -> str:
    """The classic Prometheus text exposition of the serve counters and
    the query units' engines: counters only (no gauges, no histograms),
    families prefixed parquet_tpu_ as the reference prefixes them. /metrics
    answers it whatever the Accept header asks for, OpenMetrics included."""
    from .aggregate import query_device_counts

    samples = dict(_counts.serve_counts())
    for engine, n in query_device_counts().items():
        samples[_key("query_device_units_total", {"engine": engine})] = n
    return render_counts(samples)


def render_counts(samples: dict, helps: dict = _HELP) -> str:
    """Counts keyed name{labels} as classic Prometheus counter families
    (a `# HELP` line where `helps` names the family, then `# TYPE`)."""
    lines = []
    seen = set()
    for k in sorted(samples):
        fam = k.partition("{")[0]
        if fam not in seen:
            seen.add(fam)
            if fam in helps:
                lines.append(f"# HELP {_PREFIX}{fam} {helps[fam]}")
            lines.append(f"# TYPE {_PREFIX}{fam} counter")
        lines.append(f"{_PREFIX}{k} {samples[k]}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "parquet-tpu-serve"

    # -- plumbing --------------------------------------------------------------

    def setup(self):
        # StreamRequestHandler applies self.timeout to the connection; a
        # stalled read/write then raises TimeoutError (handled as a gone
        # client) instead of pinning the thread + admission slot forever
        self.timeout = getattr(self.server, "socket_timeout", 60.0)
        super().setup()

    def log_message(self, fmt, *args):  # noqa: A003 - BaseHTTPRequestHandler API
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    @property
    def service(self) -> ScanService:
        return self.server.service

    def _tenant(self) -> str:
        # resolved through admission so a flood of distinct X-Tenant values
        # cannot grow per-tenant state or the counts' label set unbounded
        return self.service.admission.resolve_tenant(
            self.headers.get("X-Tenant")
        )

    def _timeout_ms(self):
        return self.headers.get("X-Timeout-Ms")

    def _read_body(self, cap: int | None = None) -> bytes:
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            raise ServeError(400, "bad_request", "bad Content-Length") from None
        if cap is None:
            cap = getattr(self.server, "max_body_bytes", 1 << 20)
        if n > cap:
            # reject on the DECLARED length, before buffering a byte — one
            # request must not be able to exhaust daemon memory ahead of
            # admission (the unread body closes the connection in _drain_body)
            raise ServeError(
                413, "body_too_large",
                f"request body {n} bytes exceeds the {cap}-byte limit",
            )
        body = self.rfile.read(n) if n > 0 else b""
        self._body_read = True
        return body

    def _drain_body(self) -> None:
        """Consume a request body the route never read, so the next
        keep-alive request isn't parsed out of leftover body bytes; bodies
        too large (or unreadable) to drain close the connection instead."""
        if getattr(self, "_body_read", False):
            return
        self._body_read = True
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self.close_connection = True
            return
        if n <= 0:
            return
        if n > getattr(self.server, "max_body_bytes", 1 << 20):
            self.close_connection = True
            return
        try:
            self.rfile.read(n)
        except OSError:
            self.close_connection = True

    def _send_json(self, status: int, body: dict, *, retry_after=None) -> None:
        self._send_payload(
            status, (json.dumps(body) + "\n").encode(), retry_after=retry_after
        )

    def _send_payload(
        self, status: int, payload: bytes, *,
        content_type: str = "application/json", retry_after=None,
    ) -> None:
        self._drain_body()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        if getattr(self, "_rid", None):
            self.send_header("X-Request-Id", self._rid)
        if retry_after is not None:
            self.send_header("Retry-After", str(retry_after))
        self.end_headers()
        self.wfile.write(payload)

    def _send_error_body(self, e: ServeError) -> None:
        # absorb a client that hung up before reading its error: an escape
        # from THIS send would bubble past the route's except clauses into
        # socketserver's traceback dump (TimeoutError is an OSError)
        body = e.to_body()
        if getattr(self, "_rid", None):
            # the correlation key rides the error body too, so a client
            # that logs only bodies can still quote the id to an operator
            body["error"]["request_id"] = self._rid
        try:
            self._send_json(e.status, body, retry_after=e.retry_after_s)
        except OSError:
            self.close_connection = True

    # -- chunked streaming -----------------------------------------------------

    def _write_chunk(self, payload: bytes) -> None:
        self.wfile.write(b"%x\r\n" % len(payload) + payload + b"\r\n")

    def _stream(self, chunks, content_type: str):
        """Send a 200 + chunked body. The FIRST chunk is pulled before the
        status line goes out, so planning/admission/decode errors that
        surface lazily still produce a clean typed error response.
        Returns the status for the route wrapper to finish the counts
        with."""
        started = False
        status = 200
        try:
            it = iter(chunks)
            try:
                first = next(it)
            except StopIteration:
                first = None
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Transfer-Encoding", "chunked")
            if getattr(self, "_rid", None):
                self.send_header("X-Request-Id", self._rid)
            self.end_headers()
            started = True
            if first:
                self._write_chunk(first)
            for payload in it:
                if payload:
                    self._write_chunk(payload)
            self._write_chunk(b"")  # terminating 0-chunk: complete transfer
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            status = 499  # client gone or stalled; executor aborts via gen.close()
            self.close_connection = True
        except Exception as exc:  # noqa: BLE001 - the no-traceback contract
            # EVERY failure is absorbed here (a stray one escaping would be
            # double-counted by the route handler — and, once the 200 went
            # out, its 500 response line would corrupt the open chunked
            # stream). Non-ServeError = a bug, rendered as the typed 500.
            e = (
                exc
                if isinstance(exc, ServeError)
                else ServeError(500, "internal", f"{type(exc).__name__}: {exc}")
            )
            status = e.status
            if not started:
                self._send_error_body(e)
            else:
                # mid-stream failure: typed terminal record, then ABORT the
                # chunked encoding (no 0-chunk) so the client cannot
                # mistake the prefix for a complete result
                _counts.count("events_total", event="serve_stream_aborted")
                if content_type == "application/x-ndjson":
                    try:
                        self._write_chunk(
                            (json.dumps(e.to_body()) + "\n").encode()
                        )
                    except OSError:
                        pass
                self.close_connection = True
        finally:
            chunks.close()
        return status

    # -- request finishing (counts + SLI sample, one place) --------------------

    def _finish(self, *, endpoint, tenant, status, t0) -> None:
        dt = time.perf_counter() - t0
        _count_request(tenant, status)
        # one SLI sample per finished recorded request
        self.service.slo.record(status, dt)
        # endpoint labels are the matched-route constants, never the raw
        # client path — a 404 probe flood cannot grow the label set
        if dt * 1e3 >= self.service.config.slow_ms:
            _counts.count("serve_slow_requests_total", endpoint=endpoint)

    # -- routes ----------------------------------------------------------------

    def _recorded_request(self, endpoint: str, tenant: str, t0, run) -> None:
        """One copy of the request discipline every recorded endpoint runs
        under: mint the request id, render failures through the typed-
        error ladder, and finish the counts in one place. `run()` does
        the endpoint work and returns its status."""
        if not self._rid:
            self._rid = _mint_request_id()
        status = 500
        try:
            try:
                status = run()
            except ServeError as e:
                self._send_error_body(e)
                status = e.status
            except (BrokenPipeError, ConnectionResetError, TimeoutError):
                self.close_connection = True
                status = 499
            except Exception as e:  # noqa: BLE001 - no-traceback contract
                self._send_internal_error(e)
                status = 500
        finally:
            self._finish(endpoint=endpoint, tenant=tenant, status=status, t0=t0)

    def _scan_request(self, tenant: str, t0: float) -> None:
        """POST /v1/scan under the record discipline."""

        def run():
            request = parse_scan_request(self._read_body())
            ticket, content_type, chunks = self.service.scan(
                request, tenant, timeout_ms=self._timeout_ms()
            )
            with ticket:
                return self._stream(chunks, content_type)

        self._recorded_request("/v1/scan", tenant, t0, run)

    def _query_request(self, tenant: str, t0: float) -> None:
        """POST /v1/query under the record discipline: aggregation
        push-down. The response is ONE small JSON body (Content-Length,
        not chunked) rendered through the canonical serializer, so daemon
        bytes match run_local_query's render_query_body bytes."""
        from .aggregate import render_query_body

        def run():
            request = parse_query_request(self._read_body())
            ticket, body = self.service.query(
                request, tenant, timeout_ms=self._timeout_ms()
            )
            with ticket:
                self._send_payload(200, render_query_body(body))
                return 200

        self._recorded_request("/v1/query", tenant, t0, run)

    def _append_request(self, tenant: str, t0: float) -> None:
        """POST /v1/append under the record discipline: one row batch
        into the lake ingest buffer. `?flush=1` forces the buffer to
        commit a generation before the ack (the durability handshake)."""

        def run():
            flush = (
                parse_qs(urlsplit(self.path).query).get("flush", ["0"])[0]
                in ("1", "true")
            )
            body = self._read_body(
                cap=getattr(self.server, "max_append_bytes", 32 << 20)
            )
            ticket, ack = self.service.append(
                body,
                self.headers.get("Content-Type"),
                tenant,
                flush=flush,
            )
            with ticket:
                self._send_json(200, ack)
                return 200

        self._recorded_request("/v1/append", tenant, t0, run)

    def _plan_request(self, tenant: str, t0: float, request_fn) -> None:
        """GET/POST /v1/plan under the same record discipline."""

        def run():
            body = self.service.plan(request_fn())
            self._send_json(200, body)
            return 200

        self._recorded_request("/v1/plan", tenant, t0, run)

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        split = urlsplit(self.path)
        route = split.path
        t0 = time.perf_counter()
        self._body_read = False  # per-request: the handler serves many
        self._rid = self._request_id()
        tenant = self._tenant()
        try:
            if route == "/healthz":
                status, body = self.service.healthz()
                self._send_json(
                    status, body, retry_after=body.get("retry_after_s")
                )
                return
            if route == "/metrics":
                # the classic text format for every scraper: an Accept
                # header asking for OpenMetrics gets it too (the port keeps
                # no exemplars for the OpenMetrics variant to carry)
                self._send_payload(
                    200, render_metrics().encode(),
                    content_type="text/plain; version=0.0.4; charset=utf-8",
                )
                return
            if route == "/v1/plan":
                self._plan_request(
                    tenant, t0,
                    lambda: scan_request_from_query(parse_qs(split.query)),
                )
                return
            if route == "/v1/debug/vars":
                self._send_json(200, self.service.debug_vars())
                return
            if route == "/v1/debug/slo":
                self._send_json(200, self.service.debug_slo())
                return
            cut = _cut_route(route)
            if cut is not None:
                raise cut
            raise ServeError(404, "no_such_route", f"unknown path {route!r}")
        except ServeError as e:
            self._send_error_body(e)
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            self.close_connection = True  # scraper/LB hung up or stalled
        except Exception as e:  # noqa: BLE001 - the no-traceback contract
            self._send_internal_error(e)

    def _request_id(self) -> str | None:
        """The sanitized client-supplied X-Request-Id (None: a recorded
        endpoint mints one). Bounded exactly like tenant keys."""
        return sanitize_request_id(self.headers.get("X-Request-Id"))

    def _send_internal_error(self, e) -> None:
        """Best-effort typed 500: never let a dead socket turn a handler
        bug into a socketserver traceback dump."""
        try:
            self._send_error_body(
                ServeError(500, "internal", f"{type(e).__name__}: {e}")
            )
        except OSError:
            self.close_connection = True

    def do_POST(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        route = urlsplit(self.path).path
        t0 = time.perf_counter()
        self._body_read = False  # per-request: the handler serves many
        self._rid = self._request_id()
        tenant = self._tenant()
        try:
            if route == "/v1/scan":
                self._scan_request(tenant, t0)
                return
            if route == "/v1/query":
                self._query_request(tenant, t0)
                return
            if route == "/v1/append":
                self._append_request(tenant, t0)
                return
            if route == "/v1/plan":
                self._plan_request(
                    tenant, t0, lambda: parse_scan_request(self._read_body())
                )
                return
            raise ServeError(404, "no_such_route", f"unknown path {route!r}")
        except ServeError as e:
            self._send_error_body(e)
            _count_request(tenant, e.status)
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            self.close_connection = True
            _count_request(tenant, 499)
        except Exception as e:  # noqa: BLE001 - the no-traceback contract
            self._send_internal_error(e)
            _count_request(tenant, 500)


class ScanServer:
    """Lifecycle wrapper: bind, serve (foreground or background thread),
    drain, stop. `port=0` binds an ephemeral port (tests/bench).

    Subclass seams (a mesh router rides the whole lifecycle — bind,
    background serve, drain, signal handlers — with its own brain):
    `service_cls` builds the request brain from the config, `handler_cls`
    is the per-connection handler, `thread_name` names the accept loop."""

    service_cls = ScanService
    handler_cls = _Handler
    thread_name = "pqt-serve-http"

    def __init__(self, config: ServeConfig, *, verbose: bool = False):
        self.config = config
        self.service = type(self).service_cls(config)
        self._httpd = ThreadingHTTPServer(
            (config.host, config.port), type(self).handler_cls
        )
        self._httpd.daemon_threads = True
        self._httpd.service = self.service
        self._httpd.verbose = verbose
        self._httpd.socket_timeout = config.socket_timeout_s
        self._httpd.max_body_bytes = config.max_body_bytes
        self._httpd.max_append_bytes = config.max_append_bytes
        self._thread: threading.Thread | None = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- run -------------------------------------------------------------------

    def serve_forever(self) -> None:
        self._httpd.serve_forever(poll_interval=0.1)

    def start_background(self) -> "ScanServer":
        self._thread = threading.Thread(
            target=self.serve_forever, name=type(self).thread_name,
            daemon=True,
        )
        self._thread.start()
        return self

    # -- stop ------------------------------------------------------------------

    def drain(self, timeout: float | None = 30.0) -> bool:
        """Graceful shutdown, the SIGTERM semantics: stop admitting (new
        scans get typed 503s), let in-flight requests complete (bounded by
        `timeout`), then stop the listener. True iff fully drained;
        counted serve_drains_total{drained=}."""
        self.service.admission.begin_drain()
        drained = self.service.admission.wait_drained(timeout=timeout)
        _counts.count("serve_drains_total", drained=str(drained).lower())
        self.shutdown()
        return drained

    def shutdown(self) -> None:
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self) -> None:
        try:
            self.shutdown()
        finally:
            # the ingest buffer's tail commits one last generation (rows
            # a client appended without ?flush=1 survive a clean stop)
            ingest = getattr(self.service, "ingest", None)
            if ingest is not None:
                try:
                    ingest.close()
                except Exception:  # noqa: BLE001 — close() must not raise
                    pass
            self._httpd.server_close()
            # a tiered cache the SERVICE built owns spill files/fds; a
            # config-passed block_cache belongs to the caller (it may be
            # shared with live dataset workers). BlockCache has no close;
            # a sessionless service (a mesh router) has no cache at all.
            session = getattr(self.service, "session", None)
            cache = getattr(session, "block_cache", None)
            if getattr(self.service, "_owns_cache", True) and hasattr(
                cache, "close"
            ):
                cache.close()

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT → graceful drain then stop (main thread only)."""
        import signal

        def _on_term(signum, frame):
            # the handler must not block the main loop: drain on a thread,
            # which shuts the listener down when the last request leaves
            threading.Thread(
                target=self.drain, name="pqt-serve-drain", daemon=True
            ).start()

        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
