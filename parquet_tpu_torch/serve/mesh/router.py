"""The mesh router: one daemon's HTTP surface, a fleet's execution.

`MeshRouter` binds the exact `/v1/scan`, `/v1/query`, `/v1/plan`,
`/metrics`, `/healthz`, `/v1/debug/*` surface as a single daemon —
existing clients work unchanged — but executes against a replica fleet:

SCATTER. The stride-slice shard contract is the enabler: a daemon's plan
orders units file-major, and `shard=[k, U]` selects exactly unit k of U.
The router probes ONE replica's /v1/plan for U, then issues one backend
request PER UNIT with `shard=[k, U]`, each routed to the unit's ring
owner, executed on the bounded pqt-mesh pool with an in-order lookahead
window (the executor's _pipelined discipline, one level up). Unit bodies
re-assemble in plan order:

- jsonl: a daemon's body IS the concatenation of per-unit payloads in
  plan order (empty units contribute nothing) — concatenating the
  per-unit responses reproduces it byte-for-byte.
- /v1/query: each unit's response is the canonical body of a one-unit
  query; the router absorbs them IN UNIT ORDER into the same QueryState
  the daemon merges with. 413 group_overflow fires at the same unit it
  would on the daemon.

Requests that pin their own `shard` or `limit` (and 0/1-unit plans) pass
through whole to one replica — a limited scan's sequential row cap is
the daemon's own semantics, and re-deriving it would be a second
implementation to keep byte-identical. Either path, responses are
byte-identical to a single daemon serving the whole corpus; the
differential tests pin exactly that.

FAILURE. Backend faults inside a scatter are retried by the mesh client
across replicas (any replica can serve any unit — the corpus is shared);
only fleet exhaustion surfaces, as the typed `partial_failure` ServeError.
Before the stream starts that is a clean JSON error; mid-stream it is the
typed terminal jsonl record + chunked-encoding abort (no 0-chunk) every
client of the single daemon already detects. Never a silently torn or
spliced stream.

The port's copy of parquet_tpu.serve.mesh.router. The router holds no
device and never resolves one (it constructs on a host without CUDA); its
replicas run the query units on theirs. What differs from the reference:

  merge     a replica's /v1/query body carries no types, so the router's
            partials are untyped, as the reference's are. The reference
            merges them through pyarrow's inference, which makes every
            integer int64: sums wrap in int64 (a uint64 column whose unit
            sums each stay below 2^63 but together cross it answers the
            wrapped int64 where one daemon answers the uint64 value), and a
            partial at or above 2^63 does not convert (a 500 internal).
            The port keeps the int64 inference, byte-equal to the reference
            router wherever that answers, and repairs the second case: an
            aggregate with a partial at or above 2^63 can only be uint64,
            so it merges in the uint64 domain from then on and answers what
            one daemon answers. The first case cannot be told apart without
            a type on the wire, and stays the reference's.
            Floats, strings, booleans and mixed int / float pairs merge as
            pyarrow infers them, so routed group-by and float bodies equal
            the direct daemon's. A DECIMAL sum travels as its str(): the
            reference's merge of two strings has no sum kernel (a 500
            internal); the port sums them as decimals, exactly, and answers
            what one daemon answers. Temporal min / max travel as strings
            too and compare as strings, by their bytes, as the reference's
            do.
  formats   format="arrow-ipc" scans re-frame the unit streams through
            one writer of the port's (core/arrow_ipc.py) where the
            reference's router uses pyarrow's: the routed body equals the
            direct daemon's, byte for byte.
  pool      pqt-mesh has MESH_THREADS workers, a constant (no
            PQT_MESH_THREADS); /v1/debug/vars lists it under "sizes".

The router keeps the reference's observability: its own flight records
and tenant cost (the process-wide recorder and ledger), a child
traceparent on every backend attempt, hedge and scatter unit (the mesh
client), the pqt-mesh pool through obs.pool, and /metrics as the
process registry renders it (the mesh counts are its samples:
serve.counts.mesh_counts()).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from dataclasses import dataclass
from urllib.parse import urlsplit

from ...obs import cost as _cost
from ...obs.pool import instrumented_submit
from ...obs.recorder import ObsConfig as _ObsConfig
from ...obs.recorder import configure as _obs_configure
from ...obs.slo import BurnRateEngine as _BurnRateEngine
from ...obs.slo import SLOObjective as _SLOObjective
from ...utils import metrics as _metrics
from ..admission import AdmissionController
from ..aggregate import QueryState, result_dict
from ..counts import mesh_count
from ..protocol import CONTENT_TYPES, QueryRequest, ScanRequest, ServeError, agg_name
from ..server import (
    ScanServer,
    ScanService,
    ServeConfig,
    _count_request,
    _Handler,
)
from .client import MeshClient, MeshResponse
from .table import ReplicaTable

__all__ = ["MESH_THREADS", "MeshConfig", "MeshService", "MeshRouter", "mesh_pool"]

# -- the scatter pool ----------------------------------------------------------

MESH_THREADS = 16

_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def mesh_pool() -> ThreadPoolExecutor:
    """The router's fan-out executor ("pqt-mesh", MESH_THREADS workers).
    Its own pool: scatter tasks block on backend HTTP, and hedged
    duplicates those tasks launch run on pqt-hedge — two pools, so
    neither can deadlock waiting on work only itself could run."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=MESH_THREADS, thread_name_prefix="pqt-mesh"
            )
        return _pool


@dataclass
class MeshConfig(ServeConfig):
    """ServeConfig plus the fleet: the router shares the daemon's HTTP/
    admission/SLO knobs (host, port, max_inflight, timeouts, SLO...) and
    adds routing. Unused daemon knobs (root, caches, shard, device) are
    ignored."""

    replicas: tuple = ()  # backend daemon base URLs, the static fleet
    vnodes: int = 64  # ring points per replica
    scatter: bool = True  # False = pure passthrough routing
    scatter_window: int = 8  # in-flight backend unit requests per request
    backend_timeout_s: float = 30.0  # per-hop transport cap
    probe_timeout_s: float = 2.0  # /healthz probes (debug page only)
    hedge: bool = True  # duplicate a slow first attempt past p95
    hedge_min_s: float = 0.05
    hedge_max_s: float = 2.0
    breaker_failures: int = 3  # consecutive faults to open a replica
    breaker_open_s: float = 2.0

    def __post_init__(self):
        super().__post_init__()
        reps = tuple(dict.fromkeys(str(u).rstrip("/") for u in self.replicas))
        if not reps:
            raise ValueError("mesh: at least one replica URL required")
        self.replicas = reps
        if self.vnodes < 1:
            raise ValueError("mesh: vnodes must be >= 1")
        if self.scatter_window < 1:
            raise ValueError("mesh: scatter_window must be >= 1")
        if self.backend_timeout_s <= 0:
            raise ValueError("mesh: backend_timeout_s must be positive")
        if self.breaker_failures < 1:
            raise ValueError("mesh: breaker_failures must be >= 1")
        if self.breaker_open_s <= 0:
            raise ValueError("mesh: breaker_open_s must be positive")
        if not 0 < self.hedge_min_s <= self.hedge_max_s:
            raise ValueError("mesh: need 0 < hedge_min_s <= hedge_max_s")


# -- request (de)serialization -------------------------------------------------


def _jsonable(v):
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def _scan_obj(req: ScanRequest) -> dict:
    obj: dict = {"paths": list(req.paths), "format": req.format}
    if req.columns is not None:
        obj["columns"] = list(req.columns)
    if req.filters is not None:
        obj["filters"] = _jsonable(req.filters)
    if req.limit is not None:
        obj["limit"] = req.limit
    if req.shard is not None:
        obj["shard"] = list(req.shard)
    if req.timeout_ms is not None:
        obj["timeout_ms"] = req.timeout_ms
    return obj


def _query_obj(req: QueryRequest) -> dict:
    obj: dict = {
        "paths": list(req.paths),
        "aggregates": [
            [a.op] if a.column is None else [a.op, a.column]
            for a in req.aggregates
        ],
        "max_groups": req.max_groups,
    }
    if req.filters is not None:
        obj["filters"] = _jsonable(req.filters)
    if req.group_by:
        obj["group_by"] = list(req.group_by)
    if req.shard is not None:
        obj["shard"] = list(req.shard)
    if req.timeout_ms is not None:
        obj["timeout_ms"] = req.timeout_ms
    return obj


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _doc_partial(doc: dict, query: QueryRequest):
    """A replica's /v1/query body as a QueryState partial. Its values are
    untyped (None: the merge's int64 inference), except an aggregate with
    a value at or above 2^63, which only a uint64 column gives: it is
    tagged "uint64" (the module docstring's merge repair)."""
    names = [agg_name(a) for a in query.aggregates]
    if query.group_by:
        groups = {
            tuple(g["key"]): [g["aggregates"].get(n) for n in names]
            for g in doc.get("groups", [])
        }
    else:
        r = doc.get("result") or {}
        groups = {(): [r.get(n) for n in names]}
    types = [
        "uint64"
        if any(_is_int(vals[j]) and vals[j] >= 1 << 63 for vals in groups.values())
        else None
        for j in range(len(names))
    ]
    return (
        (groups, types),
        int(doc.get("rows_scanned", 0)),
        int(doc.get("rows_matched", 0)),
    )


def _as_serve_error(resp: MeshResponse) -> ServeError:
    """A replica's typed error body, re-raised as this router's error —
    the client sees the replica's code/status, not a generic 502."""
    err = resp.error_body()
    if err and "code" in err:
        return ServeError(
            int(err.get("status") or resp.status),
            str(err["code"]),
            str(err.get("message", "")),
            retry_after_s=_hdr_retry_after(resp),
        )
    return ServeError(
        502, "bad_gateway",
        f"replica {resp.replica.label} answered http {resp.status} "
        "with no typed body",
    )


def _hdr_retry_after(resp: MeshResponse):
    raw = resp.headers.get("Retry-After") if resp.headers else None
    try:
        return float(raw) if raw is not None else None
    except (TypeError, ValueError):
        return None


# -- the service ---------------------------------------------------------------


class MeshService:
    """The router's request brain: the entry points the daemon's _Handler
    calls on a ScanService (scan/query/plan/healthz/debug_*), so the
    handler drives it unchanged — but execution is fleet-wide."""

    def __init__(self, config: MeshConfig):
        self.config = config
        self.table = ReplicaTable(
            config.replicas,
            failure_threshold=config.breaker_failures,
            open_s=config.breaker_open_s,
        )
        self.client = MeshClient(
            self.table,
            vnodes=config.vnodes,
            timeout_s=config.backend_timeout_s,
            hedge=config.hedge,
            hedge_min_s=config.hedge_min_s,
            hedge_max_s=config.hedge_max_s,
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
        self.recorder = _obs_configure(
            _ObsConfig(
                ring_size=config.debug_ring_size,
                trace_sample_rate=config.trace_sample_rate,
                slow_ms=config.slow_ms,
                max_traces=config.debug_max_traces,
            )
        )
        self.ledger = _cost.LEDGER
        self.started_at = time.time()
        if config.slo_engine is not None:
            self.slo = config.slo_engine
        else:
            self.slo = _BurnRateEngine(
                _SLOObjective(
                    availability=config.slo_availability,
                    p99_ms=config.slo_p99_ms,
                )
            )

    # the flight-recorder, SLO, profile and fleet views only touch
    # self.recorder / self.slo / self.ledger: the daemon's apply verbatim
    debug_requests = ScanService.debug_requests
    debug_request = ScanService.debug_request
    debug_trace = ScanService.debug_trace
    debug_slo = ScanService.debug_slo
    debug_fleet = ScanService.debug_fleet
    debug_tenants = ScanService.debug_tenants
    debug_profile = ScanService.debug_profile

    # -- plumbing --------------------------------------------------------------

    def _headers(self, tenant: str) -> dict:
        return {
            "Content-Type": "application/json",
            "Accept": "*/*",
            "X-Tenant": tenant,
        }

    def _hop_timeout(self, deadline) -> float:
        rem = deadline.remaining()
        if rem is None:
            return self.config.backend_timeout_s
        return max(0.1, min(rem, self.config.backend_timeout_s))

    def _backend(
        self, method, target, *, key, headers, body, deadline
    ) -> MeshResponse:
        resp = self.client.request(
            method, target, key=key, headers=headers, body=body,
            timeout_s=self._hop_timeout(deadline),
        )
        if resp.status != 200:
            raise _as_serve_error(resp)
        return resp

    def _probe_plan(self, obj: dict, sig: str, hdrs, deadline) -> dict:
        body = json.dumps(obj).encode()
        resp = self._backend(
            "POST", "/v1/plan", key=sig, headers=hdrs, body=body,
            deadline=deadline,
        )
        try:
            return json.loads(resp.body)
        except (ValueError, UnicodeDecodeError):
            raise ServeError(
                502, "bad_gateway",
                f"replica {resp.replica.label} answered /v1/plan with "
                "an unparseable body",
            ) from None

    def _scatter_bodies(self, base_obj, target, sig, hdrs, units, deadline):
        """Per-unit backend bodies, IN PLAN ORDER, fetched with a bounded
        lookahead window on the pqt-mesh pool (the _pipelined discipline:
        submission is capped, consumption is strictly ordered, waits are
        deadline-sliced)."""
        mesh_count("mesh_scatter_units_total", units, endpoint=target)
        pool = mesh_pool()
        window = self.config.scatter_window

        def fetch(k: int) -> bytes:
            obj = dict(base_obj)
            obj["shard"] = [k, units]
            return self._backend(
                "POST", target, key=f"{sig}#{k}", headers=hdrs,
                body=json.dumps(obj).encode(), deadline=deadline,
            ).body

        def gen():
            pending: deque = deque()
            k = 0
            try:
                while k < units or pending:
                    while k < units and len(pending) < window:
                        pending.append(instrumented_submit(pool, fetch, k, pool="pqt-mesh"))
                        k += 1
                    fut = pending[0]
                    while True:
                        try:
                            body = fut.result(timeout=0.2)
                            break
                        except _FutTimeout:
                            deadline.check()
                    pending.popleft()
                    yield body
            finally:
                for f in pending:
                    # queued tasks cancel; running stragglers finish on
                    # the pool and their results/errors are absorbed by
                    # the attempt's own breaker/latency bookkeeping
                    f.cancel()

        return gen()

    # -- /v1/scan --------------------------------------------------------------

    def scan(self, request: ScanRequest, tenant, timeout_ms=None, record=None):
        deadline = self.admission.deadline_for(
            timeout_ms if timeout_ms is not None else request.timeout_ms
        )
        ticket = self.admission.admit(tenant)
        try:
            content_type = CONTENT_TYPES[request.format]
            sig = "|".join(request.paths)
            hdrs = self._headers(tenant)
            if (
                not self.config.scatter
                or request.shard is not None
                or request.limit is not None
            ):
                # the daemon's own sequential row-cap / explicit-stripe
                # semantics: forward whole, byte-identical by construction
                mesh_count(
                    "mesh_requests_total", endpoint="/v1/scan",
                    mode="passthrough",
                )
                return ticket, content_type, self._passthrough_scan(
                    request, sig, hdrs, deadline
                )
            summary = self._probe_plan(
                _scan_obj(request._replace(limit=None)), sig, hdrs, deadline
            )
            if record is not None:
                record.plan = summary
            self.admission.charge(
                ticket.tenant, int(summary.get("estimated_bytes") or 0)
            )
            deadline.check()
            units = int(summary.get("units") or 0)
            if units <= 1:
                mesh_count(
                    "mesh_requests_total", endpoint="/v1/scan",
                    mode="passthrough",
                )
                return ticket, content_type, self._passthrough_scan(
                    request, sig, hdrs, deadline
                )
            mesh_count(
                "mesh_requests_total", endpoint="/v1/scan", mode="scatter"
            )
            inner = self._scatter_bodies(
                _scan_obj(request), "/v1/scan", sig, hdrs, units, deadline
            )
            if request.format == "arrow-ipc":
                return ticket, content_type, _reframe_arrow(inner)
            return ticket, content_type, _concat_jsonl(inner)
        except BaseException:
            ticket.release()
            raise

    def _passthrough_scan(self, request, sig, hdrs, deadline):
        def gen():
            resp = self._backend(
                "POST", "/v1/scan", key=sig, headers=hdrs,
                body=json.dumps(_scan_obj(request)).encode(),
                deadline=deadline,
            )
            if resp.body:
                yield resp.body

        return gen()

    # -- /v1/query -------------------------------------------------------------

    def query(self, request: QueryRequest, tenant, timeout_ms=None, record=None):
        deadline = self.admission.deadline_for(
            timeout_ms if timeout_ms is not None else request.timeout_ms
        )
        ticket = self.admission.admit(tenant)
        try:
            sig = "|".join(request.paths)
            hdrs = self._headers(tenant)
            if not self.config.scatter or request.shard is not None:
                mesh_count(
                    "mesh_requests_total", endpoint="/v1/query",
                    mode="passthrough",
                )
                return ticket, self._passthrough_query(
                    request, sig, hdrs, deadline
                )
            probe: dict = {"paths": list(request.paths)}
            if request.filters is not None:
                probe["filters"] = _jsonable(request.filters)
            summary = self._probe_plan(probe, sig, hdrs, deadline)
            if record is not None:
                record.plan = summary
            self.admission.charge(
                ticket.tenant, int(summary.get("estimated_bytes") or 0)
            )
            deadline.check()
            units = int(summary.get("units") or 0)
            if units <= 1:
                mesh_count(
                    "mesh_requests_total", endpoint="/v1/query",
                    mode="passthrough",
                )
                return ticket, self._passthrough_query(
                    request, sig, hdrs, deadline
                )
            mesh_count(
                "mesh_requests_total", endpoint="/v1/query", mode="scatter"
            )
            state = QueryState(request)
            inner = self._scatter_bodies(
                _query_obj(request), "/v1/query", sig, hdrs, units, deadline
            )
            try:
                for raw in inner:
                    try:
                        doc = json.loads(raw)
                    except (ValueError, UnicodeDecodeError):
                        raise ServeError(
                            502, "bad_gateway",
                            "replica answered /v1/query with an "
                            "unparseable body",
                        ) from None
                    # absorbing per-unit docs IN UNIT ORDER replays the
                    # daemon's exact pairwise merge sequence
                    state.absorb(_doc_partial(doc, request))
            finally:
                inner.close()
            return ticket, result_dict(request, state, units=units)
        except BaseException:
            ticket.release()
            raise

    def _passthrough_query(self, request, sig, hdrs, deadline) -> dict:
        resp = self._backend(
            "POST", "/v1/query", key=sig, headers=hdrs,
            body=json.dumps(_query_obj(request)).encode(),
            deadline=deadline,
        )
        try:
            # the handler re-renders through render_query_body; a JSON
            # round trip is value- and order-preserving, so the bytes
            # out equal the replica's bytes
            return json.loads(resp.body)
        except (ValueError, UnicodeDecodeError):
            raise ServeError(
                502, "bad_gateway",
                f"replica {resp.replica.label} answered /v1/query with "
                "an unparseable body",
            ) from None

    # -- /v1/plan --------------------------------------------------------------

    def plan(self, request: ScanRequest) -> dict:
        mesh_count(
            "mesh_requests_total", endpoint="/v1/plan", mode="passthrough"
        )
        deadline = self.admission.deadline_for(request.timeout_ms)
        return self._probe_plan(
            _scan_obj(request), "|".join(request.paths),
            self._headers("router"), deadline,
        )

    # -- health + debug --------------------------------------------------------

    def healthz(self) -> tuple[int, dict]:
        draining = self.admission.draining
        verdict = self.slo.evaluate()["verdict"]
        counts = self.table.counts()
        routable = counts["up"] + counts["degraded"]
        if draining:
            status_str = "draining"
        elif verdict == "burning" or routable == 0:
            status_str = "degraded"
        else:
            status_str = "ok"
        in_flight = self.admission.in_flight
        body = {
            "status": status_str,
            "in_flight": in_flight,
            "slo": verdict,
            "replicas": counts,
        }
        if draining:
            body["retry_after_s"] = min(30, 1 + in_flight)
        return (503 if draining else 200), body

    def debug_mesh(self) -> dict:
        """GET /v1/debug/mesh: live-probed replica states + routing
        config — the operator's one-page answer to "where is my fleet"."""
        return {
            "replicas": self.client.probe(
                timeout_s=self.config.probe_timeout_s
            ),
            "counts": self.table.counts(),
            "ring": {
                "vnodes": self.config.vnodes,
                "nodes": self.table.urls(),
            },
            "scatter": {
                "enabled": self.config.scatter,
                "window": self.config.scatter_window,
            },
            "hedge": {
                "enabled": self.client.hedge,
                "min_s": self.config.hedge_min_s,
                "max_s": self.config.hedge_max_s,
            },
        }

    def debug_vars(self) -> dict:
        """The /v1/debug/vars snapshot in mesh mode; "pools" holds the
        pqt-mesh worker count ("sizes", the port's own key) and every
        instrumented pool's depths."""
        from ... import __version__ as _version
        from ...obs.pool import pool_depths

        cfg = self.config
        return {
            "pid": os.getpid(),
            "version": _version,
            "uptime_s": round(time.time() - self.started_at, 3),
            "started_at": self.started_at,
            "mode": "mesh",
            "replicas": self.table.urls(),
            "pools": {"sizes": {"pqt-mesh": MESH_THREADS}, "depths": pool_depths()},
            "serve": {
                "max_inflight": cfg.max_inflight,
                "tenant_concurrent": cfg.tenant_concurrent,
                "tenant_budget_mb": cfg.tenant_budget_mb,
                "default_timeout_s": cfg.default_timeout_s,
                "max_timeout_s": cfg.max_timeout_s,
                "max_body_bytes": cfg.max_body_bytes,
                "socket_timeout_s": cfg.socket_timeout_s,
            },
            "mesh": {
                "vnodes": cfg.vnodes,
                "scatter": cfg.scatter,
                "scatter_window": cfg.scatter_window,
                "backend_timeout_s": cfg.backend_timeout_s,
                "hedge": cfg.hedge,
                "breaker_failures": cfg.breaker_failures,
                "breaker_open_s": cfg.breaker_open_s,
            },
            "obs": {
                "trace_sample_rate": cfg.trace_sample_rate,
                "slow_ms": cfg.slow_ms,
                "debug_ring_size": cfg.debug_ring_size,
                "debug_max_traces": cfg.debug_max_traces,
            },
            "slo": {
                "availability": self.slo.objective.availability,
                "p99_ms": self.slo.objective.p99_ms,
            },
            "process": _metrics.process_stats(),
        }


# -- stream re-assembly --------------------------------------------------------


def _concat_jsonl(inner):
    """jsonl re-assembly: unit payload concatenation in plan order (empty
    units are skipped, exactly as the daemon's executor skips them)."""
    try:
        for body in inner:
            if body:
                yield body
    finally:
        inner.close()


def _reframe_arrow(inner):
    """arrow-ipc re-assembly: each unit response is a complete IPC stream
    of that unit's batches; re-write them through ONE writer in unit
    order — the daemon's single-writer framing, byte-for-byte."""
    from ...core import arrow_ipc

    out = arrow_ipc.ChunkedStreamWriter()
    try:
        for body in inner:
            reader = arrow_ipc.open_stream(body)
            payload = out.open(reader.schema) + b"".join(
                out.write_batch(batch) for batch in reader
            )
            if payload:
                yield payload
        if out.opened:
            yield out.close()
    finally:
        inner.close()


# -- the HTTP layer ------------------------------------------------------------

class _RouterHandler(_Handler):
    """The daemon's handler, plus the router-only debug route. Every
    inherited route (scan/query/plan/healthz/metrics/debug) drives
    MeshService through the ScanService signatures."""

    server_version = "parquet-tpu-mesh"

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        route = urlsplit(self.path).path
        if route != "/v1/debug/mesh":
            super().do_GET()
            return
        self._body_read = False
        self._rid = self._request_id()
        self._tp = self._trace_context()
        try:
            self._send_json(200, self.service.debug_mesh())
        except ServeError as e:
            self._send_error_body(e)
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            self.close_connection = True
        except Exception as e:  # noqa: BLE001 - the no-traceback contract
            self._send_internal_error(e)

    def do_POST(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        route = urlsplit(self.path).path
        if route != "/v1/append":
            super().do_POST()
            return
        # Ingest is replica-pinned, not routable: an append must land on
        # exactly the replica that owns the lake table's manifest (one
        # writer per table), and the router has no write-routing table
        # yet. A typed 501 says "the route exists, target a replica"
        # instead of a bare 404's "no such thing".
        self._body_read = False
        self._rid = self._request_id()
        self._tp = self._trace_context()
        tenant = self._tenant()
        e = ServeError(
            501, "not_routable",
            "/v1/append is not routable: ingest targets one replica's "
            "lake table (POST to that replica directly; mesh "
            "write-routing is not implemented)",
        )
        self._send_error_body(e)
        _count_request(tenant, e.status)


class MeshRouter(ScanServer):
    """A ScanServer whose brain is a MeshService: same lifecycle (bind,
    background serve, drain, signal handlers), fleet execution."""

    service_cls = MeshService
    handler_cls = _RouterHandler
    thread_name = "pqt-mesh-http"
