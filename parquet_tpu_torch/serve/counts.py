"""The serve daemon's plain counters and the pqt-serve pool's queue numbers.

The reference's daemon writes its metrics registry (utils/metrics); the
port keeps plain counts under the reference's metric names instead, keyed
as io.counts keys them (utils.counters), name{label="value"}:

  serve_requests_total{status=,tenant=}   finished requests
  serve_shed_total{reason=}               brownout and breaker sheds
  serve_scan_bytes_total                  /v1/scan payload bytes
  serve_aggregate_requests_total          /v1/query bodies computed
  serve_slow_requests_total{endpoint=}    requests at or over slow_ms
  events_total{event="serve_stream_aborted"}  torn chunked streams

and two counts of the port's own, for what the reference only logs
(obs.log events, which the port logs too):

  admission_rejected_total{code=}         each typed admission rejection
                                          (the reference's rate-limited
                                          admission_rejected:<code> event)
  serve_drains_total{drained=}            each ScanServer.drain(), with
                                          whether it drained in time (the
                                          reference's drain_begin /
                                          drain_complete events)

Each count is a sample of the process registry (utils.metrics), which
the daemon's /metrics renders; serve_counts() is the view of the counts
since the last reset. The pqt-serve pool goes through
obs.pool.instrumented_submit like every pqt-* pool (`submit` is that, on
the pool's name); `serve_pool_stats()` reads the pool's depth and its
queue-wait histogram back out of the registry, as the brownout check and
/v1/debug/vars do.

The mesh router (serve/mesh/) keeps its counts apart, in mesh_counts(),
under the reference's mesh_* names:

  mesh_requests_total{endpoint=,mode=}    routed requests (scatter or
                                          passthrough)
  mesh_scatter_units_total{endpoint=}     plan units fanned out
  mesh_retries_total{reason=}             failed-over backend attempts
  mesh_hedges_total{outcome=}             hedged duplicates and who won
  mesh_partial_failures_total{target=}    requests that exhausted the fleet
  mesh_replica_state_total{replica=,state=}  the reference's
                                          mesh_replica_state gauge as a
                                          count: one a passive note, under
                                          the state the replica is in
                                          after it (the current state is
                                          ReplicaTable.snapshot()'s)

and mesh_backend_requests_total{status=}, the router-to-replica round
trips, which io.remote.pooled_roundtrip counts in io_counts() under the
name the mesh client hands it; mesh_counts() shows them too.
"""

from __future__ import annotations

from functools import partial

from ..obs.pool import instrumented_submit
from ..utils import metrics as _metrics
from ..utils.counters import LabelledCounts

__all__ = [
    "count",
    "serve_counts",
    "reset_serve_counts",
    "submit",
    "serve_pool_stats",
    "mesh_count",
    "mesh_counts",
    "reset_mesh_counts",
]

_COUNTS = LabelledCounts()
_MESH = LabelledCounts()

POOL = "pqt-serve"

# fn(*args) on a pqt-serve executor, with the context carry and the pool's
# gauges and histograms
submit = partial(instrumented_submit, pool=POOL)


def count(name: str, n: int = 1, **labels) -> None:
    """Add n to the count `name` (with its labels)."""
    _COUNTS.count(name, n, **labels)


def serve_counts() -> dict:
    """A snapshot of every serve count (see the module docstring)."""
    return _COUNTS.snapshot()


def reset_serve_counts() -> None:
    """Zero the view of the counts (the registry and the pool's numbers
    stay: they are the process's)."""
    _COUNTS.reset()


def serve_pool_stats() -> dict:
    """The pqt-serve pool right now: {"queued": tasks waiting, "active":
    tasks running, "wait_count": waits ended, "wait_sum": their seconds},
    read from the process registry."""
    reg = _metrics.REGISTRY
    h = reg.hist_stats("pool_queue_wait_seconds", pool=POOL)
    return {
        "queued": reg.get("pool_queue_depth", pool=POOL),
        "active": reg.get("pool_active_workers", pool=POOL),
        "wait_count": h["count"],
        "wait_sum": h["sum"],
    }

def mesh_count(name: str, n: int = 1, **labels) -> None:
    """Add n to the mesh count `name` (with its labels)."""
    _MESH.count(name, n, **labels)


def mesh_counts() -> dict:
    """A snapshot of every mesh count, the backend round trips included
    (see the module docstring)."""
    from ..io.counts import io_counts

    out = _MESH.snapshot()
    out.update(
        (k, v) for k, v in io_counts().items()
        if k.startswith("mesh_backend_requests_total")
    )
    return out


def reset_mesh_counts() -> None:
    """Zero the mesh counts (the backend round trips live in io_counts():
    reset_io_counts() zeroes them)."""
    _MESH.reset()
