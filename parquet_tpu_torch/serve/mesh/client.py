"""The resilient mesh client: one backend HTTP call, fleet semantics.

`MeshClient.request()` is the only way the router talks to a replica. It
composes the io layer's resilience primitives PER REPLICA instead of per
source:

- attempts walk the ring's deterministic preference order for the
  request's key (owner first), each gated by that replica's circuit
  breaker — an open breaker costs a dict lookup, not a connect timeout;
- a 503 whose body says `draining` marks the replica draining for its
  Retry-After hint and fails over WITHOUT feeding the breaker (a clean
  drain is health, not failure); brownout/throttle 503/429s fail over the
  same way;
- transport faults (reset, truncated chunked stream, stale keep-alive)
  and residual 5xxs feed the breaker and fail over;
- 2xx/4xx are terminal: the replica answered, the router forwards it;
- when every candidate refused with a Retry-After hint and nothing is
  hard-down, ONE bounded sleep honors the smallest hint and the walk
  repeats — a whole-fleet brownout degrades to backoff, not to an error;
- a first attempt that outlives the replica's observed p95 (clamped to
  [hedge_min_s, hedge_max_s]) launches ONE duplicate on the next
  candidate; first answer wins. Hedge attempts run on the shared
  pqt-hedge pool — never the caller's pool, which may be the scatter
  pool, and a bounded pool submitting to itself deadlocks.

Exhaustion raises MeshError — a ServeError, so the HTTP layer renders the
same typed body discipline as every other failure: `partial_failure`
mid-scatter, `no_replicas` when the table has nothing routable.

The port's copy of parquet_tpu.serve.mesh.client. The reference injects a
traceparent child span into every attempt (obs.propagate, which the port
does not carry): the port sends none, as its HttpSource sends none. Hedge
attempts go on pqt-hedge with a plain submit (the reference's
instrumented_submit carries its trace context), and the counts are
serve.counts.mesh_counts()'.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import FIRST_COMPLETED, wait

from ...io.hedge import hedge_pool
from ...io.remote import host_pool, pooled_roundtrip
from ...io.source import SourceError
from ..counts import mesh_count
from ..protocol import ServeError
from .ring import HashRing
from .table import ReplicaTable

__all__ = ["MeshClient", "MeshError", "MeshResponse"]


class MeshError(ServeError):
    """A typed fleet-level failure (no replica could answer)."""


class MeshResponse:
    """One backend answer: status/headers/body plus the replica that won."""

    __slots__ = ("status", "headers", "body", "replica")

    def __init__(self, status, headers, body, replica):
        self.status = status
        self.headers = headers
        self.body = body
        self.replica = replica

    def error_body(self) -> dict | None:
        """The parsed typed error body of a non-2xx answer, if any."""
        try:
            obj = json.loads(self.body)
        except (ValueError, UnicodeDecodeError):
            return None
        return obj.get("error") if isinstance(obj, dict) else None


class _Failover(Exception):
    """One attempt failed in a way the next candidate may absorb."""

    def __init__(self, reason: str, detail: str, retry_after_s=None):
        super().__init__(detail)
        self.reason = reason
        self.retry_after_s = retry_after_s


class MeshClient:
    def __init__(
        self,
        table: ReplicaTable,
        *,
        vnodes: int = 64,
        timeout_s: float = 30.0,
        hedge: bool = True,
        hedge_quantile: float = 0.95,
        hedge_min_s: float = 0.05,
        hedge_max_s: float = 2.0,
        retry_backoff_cap_s: float = 0.5,
    ):
        self.table = table
        self.ring = HashRing(table.urls(), vnodes=vnodes)
        self.timeout_s = float(timeout_s)
        self.hedge = bool(hedge) and len(table) > 1
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_min_s = float(hedge_min_s)
        self.hedge_max_s = float(hedge_max_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)

    # -- single attempt --------------------------------------------------------

    def _attempt(
        self, replica, method, target, headers, body, timeout_s
    ) -> MeshResponse:
        """One HTTP round trip to one replica, classified. Returns a
        terminal MeshResponse or raises _Failover."""
        try:
            replica.breaker.before_read()
        except SourceError as e:
            mesh_count("mesh_retries_total", reason="breaker_open")
            raise _Failover(
                "breaker_open", f"{replica.label}: {e}", retry_after_s=None
            ) from None
        hdrs = dict(headers)
        t0 = time.perf_counter()
        try:
            status, _reason, rhdrs, rbody = pooled_roundtrip(
                host_pool(replica.scheme, replica.host, replica.port),
                method,
                target,
                hdrs,
                body=body,
                timeout_s=timeout_s,
                counter="mesh_backend_requests_total",
            )
        except OSError as e:
            # connect refused, reset, truncated chunked body (a TORN
            # replica stream surfaces here as a transport fault — the
            # retry re-fetches the whole answer, never splices a prefix)
            replica.note_failure()
            mesh_count("mesh_retries_total", reason="transport")
            raise _Failover(
                "transport", f"{replica.label}: {e}"
            ) from None
        replica.latency.record(time.perf_counter() - t0)
        resp = MeshResponse(status, rhdrs, rbody, replica)
        if status < 500 and status != 429:
            # the replica ANSWERED: 2xx is the result, 4xx is the
            # request's own fault — both terminal, both health
            replica.note_ok()
            return resp
        retry_after = _retry_after_s(rhdrs)
        err = resp.error_body() or {}
        code = err.get("code", f"http_{status}")
        if code == "draining":
            replica.note_draining(retry_after)
            mesh_count("mesh_retries_total", reason="draining")
            raise _Failover("draining", f"{replica.label}: draining",
                            retry_after_s=retry_after)
        if status == 429 or code in ("brownout", "queue_full", "throttled"):
            # shedding, not sick: fail over without tripping the breaker
            mesh_count("mesh_retries_total", reason="shed")
            raise _Failover("shed", f"{replica.label}: {code}",
                            retry_after_s=retry_after or 1)
        replica.note_failure()
        mesh_count("mesh_retries_total", reason="5xx")
        raise _Failover(
            "5xx", f"{replica.label}: {code} (http {status})",
            retry_after_s=retry_after,
        )

    # -- the public call -------------------------------------------------------

    def request(
        self,
        method: str,
        target: str,
        *,
        key: str,
        headers: dict | None = None,
        body: bytes | None = None,
        timeout_s: float | None = None,
    ) -> MeshResponse:
        """One fleet call: preference-ordered failover + optional hedge.
        Returns the first terminal MeshResponse (any 2xx/4xx); raises
        MeshError when the fleet is exhausted."""
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        base = dict(headers or {})
        base.setdefault("Accept", "*/*")
        order = [self.table.by_url[u] for u in self.ring.preference(key)]
        failures: list = []
        for round_no in (0, 1):
            cands = [r for r in order if r.routable()]
            if not cands and round_no == 0 and not failures:
                # nothing routable before we even tried: last resort is
                # every replica whose breaker admits a probe — a stale
                # draining flag must not brick the router
                cands = [
                    r for r in order if r.breaker.state != "open"
                ]
            hedged = self.hedge and len(cands) > 1 and round_no == 0
            for i, rep in enumerate(cands):
                try:
                    if hedged and i == 0:
                        return self._hedged(
                            rep, cands[1], method, target, base, body,
                            timeout_s, failures,
                        )
                    return self._attempt(
                        rep, method, target, base, body, timeout_s
                    )
                except _Failover as f:
                    failures.append(f)
            # one bounded backoff pass: only when someone hinted a retry
            hints = [
                f.retry_after_s for f in failures
                if f.retry_after_s is not None
            ]
            if round_no == 0 and hints:
                time.sleep(min(min(hints), self.retry_backoff_cap_s))
                continue
            break
        if not failures:
            raise MeshError(
                503, "no_replicas",
                "mesh: no routable replica (all draining, down, or "
                "breaker-open)",
                retry_after_s=1,
            )
        mesh_count("mesh_partial_failures_total", target=_target_label(target))
        raise MeshError(
            503, "partial_failure",
            "mesh: every replica failed for this request: "
            + "; ".join(str(f) for f in failures[-4:]),
            retry_after_s=1,
        )

    def _hedged(
        self, primary, backup, method, target, headers, body, timeout_s,
        failures,
    ) -> MeshResponse:
        """First attempt with a p95-armed duplicate. The primary's window
        drives the delay; no window yet (cold client) means no hedge."""
        p95 = primary.p95_s()
        if p95 is None:
            return self._attempt(
                primary, method, target, headers, body, timeout_s
            )
        delay = min(max(p95, self.hedge_min_s), self.hedge_max_s)
        pool = hedge_pool()
        futs = {
            pool.submit(
                self._attempt, primary, method, target, headers, body,
                timeout_s,
            ): "primary"
        }
        done, not_done = wait(futs, timeout=delay, return_when=FIRST_COMPLETED)
        if not done:
            mesh_count("mesh_hedges_total", outcome="launched")
            futs[
                pool.submit(
                    self._attempt, backup, method, target, headers, body,
                    timeout_s,
                )
            ] = "hedge"
        pending = set(futs)
        first_error = None
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                try:
                    resp = fut.result()
                except _Failover as f:
                    if first_error is None:
                        first_error = f
                    else:
                        failures.append(f)
                    continue
                # a loser still running is absorbed by its own attempt
                # bookkeeping (latency + breaker); nothing to cancel
                if len(futs) > 1:
                    mesh_count(
                        "mesh_hedges_total",
                        outcome=(
                            "won_hedge"
                            if futs[fut] == "hedge"
                            else "won_primary"
                        ),
                    )
                if first_error is not None:
                    failures.append(first_error)
                return resp
        raise first_error

    # -- active probing (debug page / bench, never the request path) -----------

    def probe(self, timeout_s: float = 2.0) -> list:
        """GET every replica's /healthz and refresh its passive state.
        Returns the /v1/debug/mesh snapshot rows."""
        rows = []
        for rep in self.table.replicas:
            row = rep.snapshot()
            try:
                status, _r, hdrs, body = pooled_roundtrip(
                    host_pool(rep.scheme, rep.host, rep.port),
                    "GET", "/healthz", {"Accept": "application/json"},
                    timeout_s=timeout_s,
                    counter="mesh_backend_requests_total",
                )
            except OSError as e:
                rep.note_down()
                row.update(state="down", healthz=None, error=str(e))
                rows.append(row)
                continue
            try:
                doc = json.loads(body)
            except (ValueError, UnicodeDecodeError):
                doc = {}
            if status == 503 and doc.get("status") == "draining":
                rep.note_draining(
                    doc.get("retry_after_s") or _retry_after_s(hdrs)
                )
            elif status == 200:
                rep.note_ok(degraded=doc.get("status") == "degraded")
            else:
                rep.note_failure()
            row.update(state=rep.state(), healthz=doc or None)
            rows.append(row)
        return rows


def _retry_after_s(headers):
    raw = headers.get("Retry-After") if headers is not None else None
    if raw is None:
        return None
    try:
        return max(0.0, float(raw))
    except (TypeError, ValueError):
        return None


def _target_label(target: str) -> str:
    """Bounded metric label: the route constant, never a raw path."""
    for route in ("/v1/scan", "/v1/query", "/v1/plan"):
        if target.startswith(route):
            return route
    return "other"
