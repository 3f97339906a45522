"""Continuous sampling profiler: live CPU visibility into the pqt-* pools.

The flight recorder answers "what did request X do"; the metrics registry
answers "how much has this process done". Neither answers the operator's
third question — *where is the CPU going right now* — without attaching
an external profiler to a production daemon. This module is the stdlib
answer: a daemon-thread wall-clock sampler over `sys._current_frames()`
that attributes every sample to its POOL LANE (the named pqt-io /
pqt-data / pqt-serve / pqt-encode / pqt-hedge / pqt-dispatch worker
pools, plus "main" and "other"), renders collapsed-stack text any
flamegraph tool loads (flamegraph.pl, speedscope, inferno), and a top-N
self-time table for a terminal.

Contracts:

  * bounded memory: at most `max_stacks` distinct stacks are retained
    (overflow collapses into a per-lane `~overflow~` bucket, counted, so
    totals stay exact) and stacks truncate at `max_depth` frames;
  * bounded overhead: one `sys._current_frames()` walk per interval —
    the walk is O(threads x depth) dict/tuple work with no allocation
    proportional to history; the pin (<5% on the scan headline at the
    default 10 ms interval) is asserted by tests/test_prof.py;
  * frame identity is (file stem, function, first line) — NOT the
    current line — so one hot function is one flamegraph frame instead
    of hundreds of line-level shards;
  * everything is injectable: `frames_fn` (the stack source),
    `threads_fn` (ident -> name), `clock`; `sample_once()` drives the
    sampler synchronously, so tests replay deterministic schedules with
    no thread and no timing;
  * one live capture per process: `capture()` takes a process-wide lock
    (the sampler is global by nature — two concurrent ones would just
    double the overhead and split the story); a busy capture raises
    ProfilerBusy, which the serve daemon maps to a typed 409.

Always-on counters: obs_profile_samples_total{lane=} and
obs_profile_windows_total (documented in utils/metrics.py).

    from parquet_tpu_torch.obs.prof import capture

    prof = capture(seconds=5)           # blocks, samples the process
    print(prof.render_top(15))          # hottest self-time frames
    open("prof.txt", "w").write(prof.collapsed())  # flamegraph input

Served live by `parquet-tool serve` at GET /v1/debug/profile?seconds=N
and fetched by `parquet-tool profile --live <url>`.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from ..utils import metrics as _metrics

__all__ = [
    "SamplingProfiler",
    "ProfilerBusy",
    "capture",
    "lane_of",
    "POOL_LANES",
]

# the named pool prefixes samples attribute to (thread_name_prefix gives
# workers names like "pqt-serve_3"); FIRST match wins, so more specific
# prefixes are listed before the pools they would otherwise collide with
# (the daemon's accept loop and drain threads must not pollute the
# pqt-serve WORKER lane with idle select() time)
POOL_LANES = (
    "pqt-serve-http",
    "pqt-serve-drain",
    "pqt-io",
    "pqt-data",
    "pqt-serve",
    "pqt-encode",
    "pqt-hedge",
    "pqt-dispatch",
    # every other pqt-* pool, so no worker thread folds into "other"
    "pqt-mesh-http",  # the mesh router's accept loop (serve/mesh/router.py)
    "pqt-mesh",  # the router's scatter fan-out pool
    "pqt-host",  # reader prepare pool (core/reader.py)
    "pqt-flush",  # writer background flush pool (sink/encoder.py)
    "pqt-prof",  # the profiler's own sampler thread
    "pqt-httpstub",  # the testing stub's serve thread
    "pqt-flaky-replica",  # the chaos proxy's serve thread (testing/)
    "pqt-compact",  # the lake compactor's background fold loop (lake/compactor.py)
)

_OVERFLOW_FRAME = "~overflow~"


class ProfilerBusy(RuntimeError):
    """Another capture window is already sampling this process."""


def lane_of(thread_name: str) -> str:
    """The pool lane a thread name attributes to: the matching pqt-*
    prefix, "main" for MainThread, else "other" (connection handlers,
    user threads). Code-controlled vocabulary — the metrics label set is
    bounded by construction."""
    name = thread_name or ""
    for lane in POOL_LANES:
        if name.startswith(lane):
            return lane
    if name == "MainThread":
        return "main"
    return "other"


def _frame_id(frame) -> str:
    """Stable frame identity: file stem + function + definition line.
    The CURRENT line would shard one hot function into hundreds of
    flamegraph frames; the definition line disambiguates same-named
    functions in one file."""
    code = frame.f_code
    stem = os.path.splitext(os.path.basename(code.co_filename))[0]
    return f"{stem}:{code.co_name}:{code.co_firstlineno}"


class SamplingProfiler:
    """A bounded wall-clock stack sampler. start()/stop() run the daemon
    thread; sample_once() drives it synchronously (tests, embedders with
    their own scheduler). Read collapsed()/top()/snapshot() after (or
    during — reads are lock-consistent)."""

    def __init__(
        self,
        interval_s: float = 0.010,
        *,
        max_stacks: int = 2048,
        max_depth: int = 48,
        frames_fn=None,
        threads_fn=None,
        clock=time.perf_counter,
        exclude_threads=(),
    ):
        if interval_s <= 0:
            raise ValueError("prof: interval_s must be positive")
        if max_stacks < 1:
            raise ValueError("prof: max_stacks must be >= 1")
        if max_depth < 1:
            raise ValueError("prof: max_depth must be >= 1")
        self.interval_s = float(interval_s)
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self._frames_fn = frames_fn if frames_fn is not None else sys._current_frames
        self._threads_fn = (
            threads_fn
            if threads_fn is not None
            else lambda: {t.ident: t.name for t in threading.enumerate()}
        )
        self._clock = clock
        # thread idents never sampled by the daemon loop (the capture
        # REQUESTER's own sleep would otherwise dominate the 'other'
        # lane — the same pollution the pqt-serve-http split prevents)
        self._exclude = set(exclude_threads)
        self._lock = threading.Lock()
        self._counts: dict[tuple, int] = {}  # (lane, stack tuple) -> samples
        self._lane_totals: dict[str, int] = {}
        self._samples = 0
        self._truncated = 0  # samples folded into ~overflow~ buckets
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t_start = None
        self._duration = 0.0

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            raise RuntimeError("prof: profiler already started")
        self._stop.clear()
        self._t_start = self._clock()
        self._thread = threading.Thread(
            target=self._run, name="pqt-prof", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> "SamplingProfiler":
        """Stop sampling (idempotent) and seal the capture duration."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        if self._t_start is not None:
            self._duration = self._clock() - self._t_start
            self._t_start = None
            _metrics.inc("obs_profile_windows_total")
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _run(self) -> None:
        skip = self._exclude | {threading.get_ident()}
        while not self._stop.wait(self.interval_s):
            self.sample_once(exclude=skip)

    # -- sampling --------------------------------------------------------------

    def sample_once(self, exclude: set | None = None) -> int:
        """Take one sample of every live thread (minus `exclude` idents
        and the calling thread when driven synchronously). Returns the
        number of thread stacks recorded. The deterministic entry point:
        the daemon loop is just clock + this."""
        frames = self._frames_fn()
        names = self._threads_fn()
        skip = exclude if exclude is not None else {threading.get_ident()}
        recorded = 0
        per_lane: dict[str, int] = {}
        entries = []
        for tid, frame in list(frames.items()):
            if tid in skip:
                continue
            lane = lane_of(names.get(tid, ""))
            stack = []
            f = frame
            while f is not None and len(stack) < self.max_depth:
                stack.append(_frame_id(f))
                f = f.f_back
            stack.reverse()  # outermost first: the collapsed-stack order
            entries.append((lane, tuple(stack)))
            per_lane[lane] = per_lane.get(lane, 0) + 1
            recorded += 1
        with self._lock:
            for key in entries:
                if key in self._counts or len(self._counts) < self.max_stacks:
                    self._counts[key] = self._counts.get(key, 0) + 1
                else:
                    # bounded: fold into the lane's overflow bucket (which
                    # may itself claim one of the remaining slots exactly
                    # once per lane) so totals stay exact
                    ok = (key[0], (_OVERFLOW_FRAME,))
                    self._counts[ok] = self._counts.get(ok, 0) + 1
                    self._truncated += 1
            for lane, n in per_lane.items():
                self._lane_totals[lane] = self._lane_totals.get(lane, 0) + n
            self._samples += recorded
        for lane, n in per_lane.items():
            _metrics.inc("obs_profile_samples_total", n, lane=lane)
        return recorded

    # -- reads -----------------------------------------------------------------

    @property
    def duration_s(self) -> float:
        """Sealed capture duration (live value while still sampling)."""
        if self._t_start is not None:
            return self._clock() - self._t_start
        return self._duration

    def snapshot(self) -> dict:
        """The capture as plain JSON-shaped data (the /v1/debug/profile
        format=json body)."""
        with self._lock:
            stacks = [
                {"lane": lane, "stack": list(stack), "count": n}
                for (lane, stack), n in sorted(
                    self._counts.items(), key=lambda kv: -kv[1]
                )
            ]
            return {
                "samples": self._samples,
                "interval_s": self.interval_s,
                "duration_s": round(self.duration_s, 6),
                "lanes": dict(sorted(self._lane_totals.items())),
                "truncated_samples": self._truncated,
                "stacks": stacks,
            }

    def collapsed(self) -> str:
        """Flamegraph-compatible collapsed-stack text: one line per
        distinct stack, `lane;frame;frame;... count`, hottest first. Feed
        straight to flamegraph.pl / speedscope / inferno."""
        with self._lock:
            items = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return "".join(
            ";".join((lane, *stack)) + f" {n}\n" for (lane, stack), n in items
        )

    def top(self, n: int = 20) -> list[dict]:
        """Hottest frames by SELF time (samples where the frame was
        innermost), with the lane split: [{"frame", "self", "pct",
        "lanes": {lane: samples}}], descending."""
        agg: dict[str, dict] = {}
        with self._lock:
            total = self._samples
            for (lane, stack), count in self._counts.items():
                leaf = stack[-1] if stack else "?"
                a = agg.setdefault(leaf, {"self": 0, "lanes": {}})
                a["self"] += count
                a["lanes"][lane] = a["lanes"].get(lane, 0) + count
        out = [
            {
                "frame": frame,
                "self": a["self"],
                "pct": round(100.0 * a["self"] / total, 1) if total else 0.0,
                "lanes": dict(sorted(a["lanes"].items())),
            }
            for frame, a in agg.items()
        ]
        out.sort(key=lambda d: (-d["self"], d["frame"]))
        return out[:n]

    def render_top(self, n: int = 20) -> str:
        """The top() table as terminal text, with a lane-share header."""
        with self._lock:  # reads are lock-consistent, mid-capture too
            snap_lanes = dict(sorted(self._lane_totals.items()))
            samples = self._samples
        total = samples or 1
        lines = [
            f"profile: {samples} samples over "
            f"{self.duration_s:.2f}s at {self.interval_s * 1e3:.0f} ms"
        ]
        if snap_lanes:
            lines.append(
                "lanes:   "
                + "  ".join(
                    f"{lane}={cnt} ({100.0 * cnt / total:.0f}%)"
                    for lane, cnt in snap_lanes.items()
                )
            )
        lines.append(f"{'SELF':>6} {'PCT':>6}  FRAME (LANES)")
        for row in self.top(n):
            lanes = ",".join(
                f"{k}:{v}" for k, v in row["lanes"].items()
            )
            lines.append(
                f"{row['self']:>6} {row['pct']:>5.1f}%  {row['frame']} ({lanes})"
            )
        return "\n".join(lines) + "\n"


# one live capture window per process: sampling is process-global, so two
# would double overhead and split the evidence; the serve endpoint maps a
# busy lock to a typed 409
_capture_lock = threading.Lock()


def capture(
    seconds: float,
    interval_s: float = 0.010,
    *,
    sleep=time.sleep,
    **kwargs,
) -> SamplingProfiler:
    """Run one bounded capture window (blocking the calling thread —
    the sampler itself is on its own daemon thread) and return the
    stopped profiler. The CALLER's thread is excluded from sampling: it
    spends the window asleep right here, and ~window/interval samples of
    this sleep would otherwise dominate the 'other' lane. Raises
    ProfilerBusy when a window is already running in this process."""
    if seconds <= 0:
        raise ValueError("prof: seconds must be positive")
    if not _capture_lock.acquire(blocking=False):
        raise ProfilerBusy(
            "a profile capture window is already running in this process"
        )
    try:
        kwargs.setdefault("exclude_threads", {threading.get_ident()})
        prof = SamplingProfiler(interval_s, **kwargs)
        prof.start()
        try:
            sleep(seconds)
        finally:
            prof.stop()
        return prof
    finally:
        _capture_lock.release()
