"""One instrumented submit shared by every pqt-* worker pool.

The process runs dedicated pools — pqt-io (readahead, range fetches,
remote parts), pqt-hedge (hedged reads), pqt-data (dataset unit decode),
pqt-encode (parallel row-group encode), pqt-serve (scan execution) and
pqt-mesh (the router's scatter) — and the two numbers every capacity
question starts with are how deep each queue is and how long work waits
in it. This wrapper is the ONE choke point they all submit through
(the device read's pqt-host and pqt-dispatch hops use plain
trace.traced_submit, as the reference's do), feeding:

  pool_queue_depth{pool=}         gauge: tasks submitted, not yet running
  pool_active_workers{pool=}      gauge: tasks currently running
  pool_queue_wait_seconds{pool=}  histogram: submit -> first instruction
  pool_task_seconds{pool=}        histogram: task wall time

— the direct inputs the ROADMAP's elastic-SLO controller needs (scale a
pool when queue_wait grows, shrink when depth stays 0). The `pool` label
set is code-controlled (the pqt-* names + test pools), so it is
bounded by construction.

instrumented_submit() subsumes trace.traced_submit(): it carries the
caller's contextvars (active decode_trace, log_context request ids) into
the worker AND credits the measured queue wait to the trace as a
`pool.wait` stage — which is how a request record's queue-wait rollup is
exact, not sampled. Cancelled futures (executor drain, error teardown)
release their queue-depth contribution through a done-callback.
"""

from __future__ import annotations

import threading
import time
from contextvars import copy_context

from ..utils import metrics as _metrics
from ..utils import trace as _trace

__all__ = ["instrumented_submit", "pool_depths"]

_lock = threading.Lock()
_queued: dict[str, int] = {}
_active: dict[str, int] = {}


def _adjust(pool: str, dq: int = 0, da: int = 0) -> None:
    with _lock:
        if dq:
            _queued[pool] = _queued.get(pool, 0) + dq
            _metrics.set_gauge("pool_queue_depth", _queued[pool], pool=pool)
        if da:
            _active[pool] = _active.get(pool, 0) + da
            _metrics.set_gauge("pool_active_workers", _active[pool], pool=pool)


def pool_depths() -> dict:
    """{pool: {"queued": n, "active": n}} right now (tests/diagnostics)."""
    with _lock:
        names = set(_queued) | set(_active)
        return {
            n: {"queued": _queued.get(n, 0), "active": _active.get(n, 0)}
            for n in names
        }


def _run(pool: str, ctx, t_submit: float, fn, args):
    wait = time.perf_counter() - t_submit
    _adjust(pool, dq=-1, da=+1)
    _metrics.observe("pool_queue_wait_seconds", wait, pool=pool)
    t0 = time.perf_counter()
    try:
        return ctx.run(_charge_wait_and_call, wait, fn, args)
    finally:
        _adjust(pool, da=-1)
        _metrics.observe(
            "pool_task_seconds", time.perf_counter() - t0, pool=pool
        )


def _charge_wait_and_call(wait: float, fn, args):
    # inside the carried context: the submitting request's DecodeTrace (if
    # any) aggregates this task's queue wait under the pool.wait stage —
    # the flight recorder reads it back as the record's queue_wait_ms
    _trace.add_seconds("pool.wait", wait)
    return fn(*args)


def instrumented_submit(executor, fn, *args, pool: str | None = None, ctx=None):
    """Submit `fn(*args)` to `executor` with contextvars carry (the
    traced_submit contract) plus queue/active gauges and wait/task-time
    histograms under the `pool` label (defaults to the executor's thread
    name prefix). The drop-in replacement for traced_submit at every
    pqt-* pool call site. Callers fanning ONE logical group out as N tasks
    pass a shared `ctx` template (snapshotted once per group): each task
    still receives a private copy — Context.run refuses re-entry on a
    shared object, and group tasks overlap — but the per-task cost drops
    to Context.copy instead of a fresh per-submit thread-state snapshot."""
    name = pool or getattr(executor, "_thread_name_prefix", "") or "pool"
    ctx = ctx.copy() if ctx is not None else copy_context()
    _adjust(name, dq=+1)
    t_submit = time.perf_counter()
    try:
        fut = executor.submit(_run, name, ctx, t_submit, fn, args)
    except BaseException:
        _adjust(name, dq=-1)  # shutdown race: the task never queued
        raise

    def _on_done(f):
        if f.cancelled():  # cancel-before-start: _run never decremented
            _adjust(name, dq=-1)

    fut.add_done_callback(_on_done)
    return fut
