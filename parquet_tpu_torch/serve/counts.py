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
(obs.log events):

  admission_rejected_total{code=}         each typed admission rejection
                                          (the reference's rate-limited
                                          admission_rejected:<code> event)
  serve_drains_total{drained=}            each ScanServer.drain(), with
                                          whether it drained in time (the
                                          reference's drain_begin /
                                          drain_complete events)

It also holds the pqt-serve pool's numbers that the reference reads back
out of its registry (pool_queue_depth and the pool_queue_wait_seconds
histogram): the tasks queued and running, and the count and sum of the
queue waits. `submit()` is the reference's instrumented_submit without the
context carry: it records them around a plain executor submit, and
AdmissionController's brownout and /v1/debug/vars read them through
`serve_pool_stats()`.
"""

from __future__ import annotations

import threading
import time

from ..utils.counters import LabelledCounts

__all__ = [
    "count",
    "serve_counts",
    "reset_serve_counts",
    "submit",
    "serve_pool_stats",
]

_COUNTS = LabelledCounts()
_LOCK = threading.Lock()  # guards _POOL

POOL = "pqt-serve"
# the pool's live depth (queued, active) and its queue-wait totals
_POOL = {"queued": 0, "active": 0, "wait_count": 0, "wait_sum": 0.0}


def count(name: str, n: int = 1, **labels) -> None:
    """Add n to the count `name` (with its labels)."""
    _COUNTS.count(name, n, **labels)


def serve_counts() -> dict:
    """A snapshot of every serve count (see the module docstring)."""
    return _COUNTS.snapshot()


def reset_serve_counts() -> None:
    """Zero the counts and the queue-wait totals (the live depth stays:
    it counts tasks that are still queued or running)."""
    _COUNTS.reset()
    with _LOCK:
        _POOL["wait_count"] = 0
        _POOL["wait_sum"] = 0.0


def _run(t_submit: float, fn, args):
    wait = time.perf_counter() - t_submit
    with _LOCK:
        _POOL["queued"] -= 1
        _POOL["active"] += 1
        _POOL["wait_count"] += 1
        _POOL["wait_sum"] += wait
    try:
        return fn(*args)
    finally:
        with _LOCK:
            _POOL["active"] -= 1


def submit(executor, fn, *args):
    """Submit fn(*args) to the pqt-serve executor, recording its queue wait
    and the pool's depth."""
    with _LOCK:
        _POOL["queued"] += 1
    try:
        fut = executor.submit(_run, time.perf_counter(), fn, args)
    except BaseException:
        with _LOCK:
            _POOL["queued"] -= 1  # shutdown race: the task never queued
        raise

    def _on_done(f):
        if f.cancelled():  # cancelled before it started: _run never ran
            with _LOCK:
                _POOL["queued"] -= 1

    fut.add_done_callback(_on_done)
    return fut


def serve_pool_stats() -> dict:
    """The pqt-serve pool right now: {"queued": tasks waiting, "active":
    tasks running, "wait_count": waits ended, "wait_sum": their seconds}
    (the brownout check reads the queue and the waits; /v1/debug/vars the
    depths)."""
    with _LOCK:
        return dict(_POOL)
