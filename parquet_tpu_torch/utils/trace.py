"""Hierarchical span tracing + per-stage decode instrumentation.

The Go library this project was modelled on has no observability at all
(SURVEY §5: 'no pprof hooks, no timing instrumentation'). This module
provides the opt-in, per-read layer:
a `decode_trace()` collects BOTH flat per-stage aggregates (wall time, bytes,
calls — the report() table) and hierarchical spans (file → row-group → chunk
→ page → stage, including the native prepare sub-clocks) exportable as Chrome
trace-event JSON for Perfetto / chrome://tracing. The always-on process
counters live in utils/metrics.py; `bump()` dual-reports into them.

Zero overhead when no trace is active: one contextvar read, no span
allocations (asserted by test via the span_allocations() counter).

Thread model: the active trace propagates through a `contextvars.ContextVar`,
so concurrent traces on different threads are ISOLATED (the old module-global
was racy under the 16-thread prepare pool), while pool workers doing a traced
read's prepare/dispatch work join the submitting read's trace via
`traced_submit()` (an explicit `copy_context()` carry — ThreadPoolExecutor
does not propagate context by itself). All merges into a shared trace are
lock-protected.

    from parquet_tpu_torch.utils.trace import decode_trace

    with decode_trace() as t:
        reader.read_row_group(0)
    print(t.report())                 # per-stage table, hottest first
    t.write_chrome_trace("trace.json")  # load in ui.perfetto.dev

    with torch_profile("prof"):       # wraps torch.profiler (CUDA too)
        reader.read_row_group(0)      # prof/trace.json: kernels, copies
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar, copy_context
from dataclasses import dataclass

from . import metrics as _metrics

__all__ = [
    "decode_trace",
    "stage",
    "timed_stage",
    "span",
    "add_bytes",
    "add_seconds",
    "add_seconds_batch",
    "bump",
    "count",
    "active",
    "current",
    "traced_submit",
    "span_allocations",
    "torch_profile",
    "DecodeTrace",
]

_active_var: ContextVar = ContextVar("pqt_decode_trace", default=None)

# Depth of stage() / timed_stage() aggregates currently OPEN in this
# context. Seconds committed while an enclosing stage aggregate is open
# (an inner decode stage under serve.execute, a native sub-clock inside a
# measured parent) are already part of that parent's wall time — they are
# marked "nested" on their own StageStats so rollups and the report TOTAL
# can count them EXACTLY once. The contextvar rides the same
# copy_context() carry as the trace itself, so nesting detected inside a
# pool worker attributes against the stage open on that worker.
_stage_depth_var: ContextVar = ContextVar("pqt_stage_depth", default=0)

# Process-wide count of span-event allocations: the zero-overhead oracle.
# A read with no trace active must leave it untouched — tests assert that by
# counter, not timing. Mutated only while some trace's lock is held, so the
# count is exact for single-trace workloads and best-effort across
# concurrently active traces.
_span_allocs = 0

# Per-trace span cap: a traced 10M-row assembled read bills stage("assemble")
# per row; past the cap events drop (counted in events_dropped) while the
# stage AGGREGATES stay exact.
_MAX_EVENTS = 1 << 17


@dataclass
class StageStats:
    seconds: float = 0.0
    bytes: int = 0
    calls: int = 0
    # the share of `seconds` that elapsed INSIDE another open stage
    # aggregate (a sub-clock): already billed to the enclosing stage, so
    # exclusive rollups subtract it — TOTAL counts wall time once
    nested_seconds: float = 0.0


class DecodeTrace:
    """One read's collected stages + spans. Safe to mutate from many threads
    (every merge takes the trace lock); read it after the `with` block."""

    def __init__(self):
        self.stages: dict[str, StageStats] = {}
        self.events_dropped = 0
        # cross-process propagation key (obs/propagate.py): an opaque
        # 32-hex trace-id set by whoever opened the request scope, or None
        # for library reads outside any scope. Carried into the Chrome
        # export so trace-merge can stitch multi-process documents.
        self.trace_id: str | None = None
        self._lock = threading.Lock()
        self._t0 = time.perf_counter_ns()
        # finished spans: (name, tid, start_ns rel to _t0, dur_ns, args|None)
        self._events: list[tuple] = []
        self._threads: dict[int, str] = {}

    # -- collection (lock-protected merge; called from pool threads) ----------

    def _stat(self, name: str) -> StageStats:
        # caller holds self._lock
        s = self.stages.get(name)
        if s is None:
            s = self.stages[name] = StageStats()
        return s

    def _commit(
        self,
        name: str,
        seconds: float = 0.0,
        nbytes: int = 0,
        calls: int = 0,
        start_ns: int | None = None,
        dur_ns: int = 0,
        args: dict | None = None,
        nested: bool = False,
    ) -> None:
        global _span_allocs
        with self._lock:
            if calls or nbytes or seconds:
                s = self._stat(name)
                s.seconds += seconds
                s.bytes += nbytes
                s.calls += calls
                if nested:
                    s.nested_seconds += seconds
            if start_ns is not None:
                tid = threading.get_ident()
                if tid not in self._threads:
                    self._threads[tid] = threading.current_thread().name
                if len(self._events) >= _MAX_EVENTS:
                    self.events_dropped += 1
                else:
                    _span_allocs += 1
                    self._events.append(
                        (name, tid, start_ns - self._t0, dur_ns, args)
                    )

    # -- reporting -------------------------------------------------------------

    def counters(self) -> dict:
        """{name: calls} for every bump()-style event collected — the
        robustness counters ride here: prepare_fused_engaged/_declined,
        prepare_fused_fault_<stage>, prepare_fallback_recovered,
        chunks_quarantined, chunks_nulled, row_groups_quarantined."""
        with self._lock:
            return {name: s.calls for name, s in self.stages.items() if s.calls}

    def stage_rollup(self) -> dict:
        """The flat per-stage aggregates as plain JSON-shaped data:
        {stage: {"seconds", "bytes", "calls"}} — what the flight recorder
        stores per request (the span TREE is sampled; this rollup is kept
        for every record, and its pool.wait entry is the record's
        queue-wait). Stages whose time elapsed inside another measured
        stage (sub-clocks: the native prepare.* split, an inner decode
        stage under serve.execute) additionally carry "nested_seconds" —
        the share already billed to their parent — so a consumer summing
        `seconds - nested_seconds` counts wall time exactly once."""
        with self._lock:
            out = {}
            for n, s in self.stages.items():
                d = {"seconds": s.seconds, "bytes": s.bytes, "calls": s.calls}
                if s.nested_seconds:
                    d["nested_seconds"] = s.nested_seconds
                out[n] = d
            return out

    def exclusive_seconds(self) -> float:
        """Wall seconds across all stages with sub-clock time counted
        ONCE: sum of per-stage (seconds - nested_seconds) — the same
        quantity the report() TOTAL footer shows (computed there inline,
        atomically with its per-stage listing); exposed as API for
        embedders and tests."""
        with self._lock:
            return sum(
                s.seconds - s.nested_seconds for s in self.stages.values()
            )

    def report(self, sort: str = "time") -> str:
        """Per-stage table. sort="time" (default) lists the hottest stages
        first (wall seconds, descending); sort="name" is alphabetical.
        A TOTAL footer sums seconds/bytes/calls across stages; sub-clock
        seconds (time a stage spent inside another measured stage — the
        native prepare.* split under its parent, inner decode stages under
        serve.execute) count toward the TOTAL exactly once, and stages
        that are partly or wholly sub-clocks are marked with a trailing
        `*` (their own line still shows inclusive seconds)."""
        if sort not in ("time", "name"):
            raise ValueError(f'report sort must be "time" or "name", got {sort!r}')
        with self._lock:
            items = [
                (n, s.seconds, s.bytes, s.calls, s.nested_seconds)
                for n, s in self.stages.items()
            ]
        if sort == "name":
            items.sort(key=lambda kv: kv[0])
        else:
            items.sort(key=lambda kv: (-kv[1], kv[0]))

        def line(name, seconds, nbytes, calls, mark=""):
            rate = f" ({nbytes / seconds / 1e6:.0f} MB/s)" if seconds > 0 and nbytes else ""
            return (
                f"{name:12s} {seconds * 1000:8.1f} ms  {nbytes:>12,} B  "
                f"{calls:>6} calls{rate}{mark}"
            )

        lines = [
            line(n, sec, b, c, "  *" if nested else "")
            for n, sec, b, c, nested in items
        ]
        lines.append(
            line(
                "TOTAL",
                sum(sec - nested for _, sec, _b, _c, nested in items),
                sum(b for _, _s, b, _c, _n in items),
                sum(c for _, _s, _b, c, _n in items),
            )
        )
        if any(nested for *_rest, nested in items):
            lines.append(
                "(* partly sub-clocked: time also inside an enclosing "
                "stage; TOTAL counts it once)"
            )
        return "\n".join(lines)

    # -- Chrome trace-event export ---------------------------------------------

    def to_chrome_trace(self) -> dict:
        """The collected spans as a Chrome trace-event JSON object (the
        format Perfetto and chrome://tracing load). Every span is a complete
        ("X") event with microsecond ts/dur relative to trace start, on its
        real thread lane; one thread_name metadata ("M") event names each
        lane (MainThread / pqt-host_* / pqt-dispatch_*). Aggregates and
        bump() counters ride in otherData."""
        pid = os.getpid()
        with self._lock:
            events = list(self._events)
            threads = dict(self._threads)
            stages = {
                n: {
                    "seconds": s.seconds,
                    "bytes": s.bytes,
                    "calls": s.calls,
                    **(
                        {"nested_seconds": s.nested_seconds}
                        if s.nested_seconds
                        else {}
                    ),
                }
                for n, s in self.stages.items()
            }
            dropped = self.events_dropped
        out = [
            {
                "ph": "M",
                "name": "thread_name",
                "pid": pid,
                "tid": tid,
                "ts": 0,
                "dur": 0,
                "args": {"name": tname},
            }
            for tid, tname in sorted(threads.items())
        ]
        events.sort(key=lambda e: (e[1], e[2], -e[3]))  # (tid, start, -dur)
        for name, tid, rel_ns, dur_ns, args in events:
            ev = {
                "ph": "X",
                "name": name,
                "cat": name.split(".", 1)[0],
                "pid": pid,
                "tid": tid,
                "ts": rel_ns / 1e3,
                "dur": dur_ns / 1e3,
            }
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        doc = {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "stages": stages,
                "counters": {n: v["calls"] for n, v in stages.items() if v["calls"]},
                "events_dropped": dropped,
            },
        }
        if self.trace_id is not None:
            doc["otherData"]["propagation"] = {"trace_id": self.trace_id}
        return doc

    def write_chrome_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


@contextmanager
def decode_trace():
    """Activate stage + span collection for the enclosed reads (this thread,
    plus any pool work submitted from it via traced_submit). Nested traces
    shadow; traces on OTHER threads are unaffected (contextvar isolation)."""
    t = DecodeTrace()
    token = _active_var.set(t)
    try:
        yield t
    finally:
        _active_var.reset(token)
        # root span: the whole traced region, on the activating thread
        t._commit(
            "decode_trace",
            start_ns=t._t0,
            dur_ns=time.perf_counter_ns() - t._t0,
        )


def _enter_stage() -> tuple:
    """Open a stage aggregate in this context: returns (reset token,
    was-nested). The depth rides the same contextvar carry as the trace,
    so sub-clocks committed inside a pool task see the stage their
    submitter (or the task itself) holds open."""
    depth = _stage_depth_var.get()
    return _stage_depth_var.set(depth + 1), depth > 0


def _exit_stage(token) -> None:
    try:
        _stage_depth_var.reset(token)
    except ValueError:  # pragma: no cover - exotic cross-context consumer
        # a generator suspended inside the stage was resumed from another
        # context: losing the reset mis-tags later commits there as
        # nested at worst — never break the decode over bookkeeping
        pass


@contextmanager
def stage(name: str, nbytes: int = 0, record_span: bool = True):
    """Time a pipeline stage: aggregates into stages[name] AND records a
    span (no-op without an active trace). record_span=False keeps the
    aggregate but skips the span event — for per-ROW micro-stages (the
    assembled-rows loop) that would otherwise flood the event budget with
    sub-microsecond spans and crowd out the meaningful hierarchy. A stage
    opened while another stage aggregate is already open commits its
    seconds as nested (sub-clocked): its wall time is part of the parent's
    and rollup TOTALs count it once."""
    t = _active_var.get()
    if t is None:
        yield
        return
    token, nested = _enter_stage()
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        dt = time.perf_counter_ns() - t0
        _exit_stage(token)
        t._commit(
            name,
            dt / 1e9,
            nbytes,
            1,
            start_ns=t0 if record_span else None,
            dur_ns=dt,
            nested=nested,
        )


class _Elapsed:
    """Result holder for timed_stage(): .seconds is valid after the block."""

    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = 0.0


@contextmanager
def timed_stage(name: str, nbytes: int = 0, record_span: bool = True):
    """Like stage(), but ALWAYS measures: yields a holder whose `.seconds`
    is the block's wall time even when no trace is active. For callers that
    feed an always-on metric (e.g. the dataset's wait-time histogram) from
    the same clock read that bills the trace stage — one perf_counter pair,
    two consumers, no skew between what the trace and the registry report."""
    t = _active_var.get()
    out = _Elapsed()
    token, nested = (None, False) if t is None else _enter_stage()
    t0 = time.perf_counter_ns()
    try:
        yield out
    finally:
        dt = time.perf_counter_ns() - t0
        out.seconds = dt / 1e9
        if t is not None:
            _exit_stage(token)
            t._commit(
                name,
                out.seconds,
                nbytes,
                1,
                start_ns=t0 if record_span else None,
                dur_ns=dt,
                nested=nested,
            )


@contextmanager
def span(name: str, args: dict | None = None):
    """Pure hierarchy span (file / row_group / chunk levels): records a
    trace event with optional args but does NOT enter the stage aggregates —
    its children (stages) already bill the time, and double-billing would
    corrupt the TOTAL row."""
    t = _active_var.get()
    if t is None:
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t._commit(name, start_ns=t0, dur_ns=time.perf_counter_ns() - t0, args=args)


def active() -> bool:
    """True while a decode_trace() is collecting in this context — callers
    use this to skip instrumentation work (e.g. native per-stage clocks)
    when nobody listens."""
    return _active_var.get() is not None


def current() -> "DecodeTrace | None":
    """The trace active in this context, or None."""
    return _active_var.get()


def traced_submit(executor, fn, *args):
    """Submit `fn(*args)` to `executor` carrying the caller's contextvars —
    including the active decode_trace — into the worker thread.
    ThreadPoolExecutor does not do this by itself; every pool hop of a
    traced read must route through here or its stages vanish."""
    return executor.submit(copy_context().run, fn, *args)


def add_bytes(name: str, nbytes: int) -> None:
    t = _active_var.get()
    if t is not None:
        t._commit(name, 0.0, nbytes, 0)


def add_seconds(name: str, seconds: float, nbytes: int = 0) -> None:
    """Credit externally-measured wall time to a stage. The span is placed
    ending 'now' (the measurement must have just finished). When a stage
    aggregate is open in this context, the credited time is part of that
    stage's wall and commits as nested (counted once in TOTALs)."""
    t = _active_var.get()
    if t is not None:
        dur = int(seconds * 1e9)
        t._commit(
            name,
            seconds,
            nbytes,
            1,
            start_ns=time.perf_counter_ns() - dur,
            dur_ns=dur,
            nested=_stage_depth_var.get() > 0,
        )


def add_seconds_batch(pairs) -> None:
    """Credit a list of (name, seconds) sub-stage clocks that together just
    finished (how the fused native chunk walk reports its internal
    decompress/levels/prescan/copy/crc split). Spans are laid back-to-back
    ENDING now, so they nest inside the enclosing span (their sum never
    exceeds the native call's wall time). Like add_seconds, the batch
    commits as nested when an enclosing stage aggregate is open — the
    sub-clocks are a BREAKDOWN of their parent, not additional wall."""
    t = _active_var.get()
    if t is None:
        return
    nested = _stage_depth_var.get() > 0
    pairs = [(n, s) for n, s in pairs if s > 0]
    cursor = time.perf_counter_ns() - sum(int(s * 1e9) for _, s in pairs)
    for name, sec in pairs:
        dur = int(sec * 1e9)
        t._commit(name, sec, 0, 1, start_ns=cursor, dur_ns=dur, nested=nested)
        cursor += dur


def bump(name: str, nbytes: int = 0) -> None:
    """Count an event (with optional byte volume) under an active trace —
    how tests pin down that an opportunistic path actually engaged. Always
    dual-reports into the process-wide metrics registry (metrics.event), so
    the count survives outside any trace."""
    _metrics.event(name)
    t = _active_var.get()
    if t is not None:
        t._commit(name, 0.0, nbytes, 1)


def count(name: str, n: int = 1) -> None:
    """Count an event under the active trace ONLY — no registry write.
    For call sites that already feed a dedicated always-on counter (the
    block cache's io_cache_hits_total) and need just the per-request
    attribution: one contextvar read when no trace is active, no extra
    lock traffic on hot paths."""
    t = _active_var.get()
    if t is not None:
        t._commit(name, 0.0, 0, n)


def span_allocations() -> int:
    """Process-wide span-event allocation count — the zero-overhead oracle:
    reads with no active trace must not move it."""
    return _span_allocs


@contextmanager
def torch_profile(logdir: str):
    """Capture a torch.profiler trace of the enclosed block (CPU activity,
    and CUDA activity when CUDA is present: kernels, copies, streams) and
    write it as a Chrome trace to `logdir`/trace.json. The device's own
    clock, where a span measures host time only (a span around a launch
    measures the launch, not the kernel). Yields the profiler."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
