"""The router's replica table: static membership, passive health state.

One entry per `--replica URL`. Health is learned two ways and both are
cheap: PASSIVELY from every backend response the mesh client sees (a 503
`draining` body marks the replica draining for its Retry-After hint; a
transport fault feeds its circuit breaker), and ACTIVELY only on demand —
`probe()` GETs /healthz when a caller (GET /v1/debug/mesh, the bench)
wants fresh states, never on the request path.

The composite state each replica reports is a small closed vocabulary:

  up           serving, breaker closed
  degraded     serving but its own SLO verdict says "burning" — still
               routable, the client merely deprioritizes it
  draining     it answered 503 {"status": "draining"} — shed to peers
               until its Retry-After hint elapses
  open-breaker its circuit breaker is open (consecutive transport
               failures) — fast-fail window, probes resume via half-open
  down         an active probe could not reach it at all

The port's copy of parquet_tpu.serve.mesh.table, over the port's own
CircuitBreaker and _LatencyWindow (io/hedge.py). The reference mirrors each
replica's state on the mesh_replica_state gauge family; the port keeps no
gauges: every passive note counts mesh_replica_state_total{replica=,
state=} in serve.counts.mesh_counts() under the state after it, and the
current state is `snapshot()`'s (GET /v1/debug/mesh)."""

from __future__ import annotations

import threading
import time
from urllib.parse import urlsplit

from ...io.hedge import CircuitBreaker, _LatencyWindow
from ..counts import mesh_count

__all__ = ["Replica", "ReplicaTable", "STATE_VALUES"]

# ascending severity (the reference's gauge encoding, which dashboards
# max() over a fleet); the keys are the state vocabulary
STATE_VALUES = {
    "up": 0,
    "degraded": 1,
    "draining": 2,
    "open-breaker": 3,
    "down": 4,
}


def _default_port(scheme: str) -> int:
    return 443 if scheme == "https" else 80


class Replica:
    """One backend daemon: parsed address + breaker + latency window +
    the passive state the client and /v1/debug/mesh read."""

    def __init__(
        self, url: str, *, failure_threshold: int = 3, open_s: float = 2.0
    ):
        url = url.rstrip("/")
        split = urlsplit(url)
        if split.scheme not in ("http", "https"):
            raise ValueError(
                f"mesh: replica URL must be http(s)://host:port, got {url!r}"
            )
        if not split.hostname:
            raise ValueError(f"mesh: no host in replica URL {url!r}")
        if split.path or split.query:
            raise ValueError(
                f"mesh: replica URL must not carry a path, got {url!r}"
            )
        self.url = url
        self.scheme = split.scheme
        self.host = split.hostname
        self.port = split.port or _default_port(split.scheme)
        self.label = f"{self.host}:{self.port}"
        self.breaker = CircuitBreaker(
            f"mesh:{self.label}",
            failure_threshold=failure_threshold,
            open_s=open_s,
            label=f"mesh:{self.label}",
        )
        self.latency = _LatencyWindow()
        self._lock = threading.Lock()
        self._flag = "up"  # up | degraded | draining | down
        self._flag_until = 0.0  # draining/down expire (the replica may heal)
        self._count_state()

    # -- passive state ---------------------------------------------------------

    def note_ok(self, degraded: bool = False) -> None:
        with self._lock:
            self._flag = "degraded" if degraded else "up"
            self._flag_until = 0.0
        self.breaker.record_success()
        self._count_state()

    def note_draining(self, retry_after_s=None) -> None:
        """Drain-aware failover: respect the replica's own hint for how
        long to shed (a missing hint backs off briefly and re-probes —
        "draining" usually means "gone in seconds")."""
        hold = float(retry_after_s) if retry_after_s else 1.0
        with self._lock:
            self._flag = "draining"
            self._flag_until = time.monotonic() + min(hold, 30.0)
        self._count_state()

    def note_down(self, hold_s: float = 1.0) -> None:
        with self._lock:
            self._flag = "down"
            self._flag_until = time.monotonic() + hold_s
        self._count_state()

    def note_failure(self) -> None:
        self.breaker.record_failure()
        self._count_state()

    # -- reads -----------------------------------------------------------------

    def state(self) -> str:
        """The composite routing state (breaker wins over stale flags)."""
        if self.breaker.state == "open":
            return "open-breaker"
        with self._lock:
            flag, until = self._flag, self._flag_until
        if flag in ("draining", "down") and time.monotonic() >= until:
            return "up"  # hint expired: eligible again, next attempt decides
        return flag

    def routable(self) -> bool:
        return self.state() in ("up", "degraded")

    def p95_s(self):
        return self.latency.quantile(0.95)

    def _count_state(self) -> None:
        mesh_count(
            "mesh_replica_state_total", replica=self.label, state=self.state()
        )

    def snapshot(self) -> dict:
        p95 = self.p95_s()
        return {
            "url": self.url,
            "state": self.state(),
            "breaker": self.breaker.state,
            "p95_ms": round(p95 * 1e3, 3) if p95 is not None else None,
        }


class ReplicaTable:
    """The static fleet: replicas in --replica order, unique by URL."""

    def __init__(
        self, urls, *, failure_threshold: int = 3, open_s: float = 2.0
    ):
        urls = list(dict.fromkeys(u.rstrip("/") for u in urls))
        if not urls:
            raise ValueError("mesh: at least one --replica URL required")
        self.replicas = [
            Replica(u, failure_threshold=failure_threshold, open_s=open_s)
            for u in urls
        ]
        self.by_url = {r.url: r for r in self.replicas}

    def __len__(self) -> int:
        return len(self.replicas)

    def urls(self) -> list:
        return [r.url for r in self.replicas]

    def routable(self) -> list:
        return [r for r in self.replicas if r.routable()]

    def counts(self) -> dict:
        out = {s: 0 for s in STATE_VALUES}
        for r in self.replicas:
            out[r.state()] += 1
        return out

    def snapshot(self) -> list:
        return [r.snapshot() for r in self.replicas]
