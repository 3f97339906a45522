"""The elastic-SLO feedback controller for ParquetDataset.

The dataset's knobs are otherwise STATIC: prefetch depth, pqt-data worker
count and the readahead byte budget are fixed at construction, so a
latency spike stalls the train loop until a human re-tunes. This module
closes the loop:

    ds = ParquetDataset(glob, batch_size=8192, slo_wait_ms=5.0, ...)

attaches an AIMD (additive-increase / multiplicative-decrease) controller
that targets a CONSUMER-WAIT SLO — "the train loop should almost never
block more than slo_wait_ms on next()" — using windowed deltas of the
dataset's instruments (utils.instruments) as its inputs:

  dataset_wait_seconds            how long consumers actually blocked
                                  (count + sum + the bucket <= the SLO
                                  bound -> per-window violation share)
  pool_queue_wait_seconds{pqt-data}  decode tasks queueing behind too few
                                  workers (the scale-WORKERS signal)

Control law, evaluated once per `window_s` on the injected clock:

  pressure  (violation share over the window > tolerated, or the mean
            wait > the SLO): prefetch target += increase_step (additive),
            workers track the target, the readahead budget grows
            proportionally. One step per window: AIMD probes, it does not
            leap.
  idle      (no violations AND mean wait < idle_fraction * SLO) for
            `idle_windows` consecutive windows: target *= decrease_factor
            (multiplicative) — capacity returns quickly when the spike
            passes.
  otherwise hold.

Everything the controller changes is ADVISORY — speed, never the stream:
the epoch order, the batch grid and the checkpoint cursor are pure
functions of (seed, epoch, shard, batch_size), none of which the
controller touches, so `state_dict()` resume stays byte-identical with the
controller on, off, or mid-adaptation (pinned in tests/test_torch_controller.py).
Controller state is therefore deliberately NOT in state_dict().

Observability: the `dataset_prefetch_target` level (the target; the
dataset's prefetch_depth count shows actual in-flight), and `violations`,
the wait observations over the SLO so far, which the dataset adds to its
count dataset_slo_violations_total.

The port's copy of parquet_tpu.data.controller: the same control law,
validation, state() and clock= / registry= injection. The reference reads
and writes its metrics registry (utils.metrics); the port reads and writes
utils.instruments.INSTRUMENTS (the same API, the same bucket bounds) but
keeps its violations in the attribute `violations` where the reference
increments dataset_slo_violations_total in the registry, and the
structured log of each step (obs.log) is dropped: state() counts the
steps.
"""

from __future__ import annotations

import os
import threading
import time

from ..utils.instruments import INSTRUMENTS

__all__ = ["AIMDController"]


class AIMDController:
    """Clock-injectable AIMD controller over (prefetch depth, worker
    count, readahead budget). Thread-safe: tick() may be called from the
    consumer thread and targets read from the fill loop concurrently.

    Parameters
    ----------
    slo_wait_ms     the consumer-wait SLO: next() blocking longer than
                    this is a violation
    min_depth/max_depth   prefetch-target clamp (min_depth >= 1: the
                    controller always keeps the pipeline asynchronous)
    max_workers     pqt-data worker clamp (None = PQT_DATA_THREADS or cpu)
    readahead_unit_bytes  budget granted per unit of prefetch target when
                    a Readahead scheduler is attached
    window_s        control interval on the injected clock
    violation_share tolerated fraction of over-SLO waits per window
    increase_step   additive depth increase under pressure
    decrease_factor multiplicative depth decay when idle
    idle_fraction   "idle" means mean wait below this fraction of the SLO
    idle_windows    consecutive idle windows required before decaying
    clock           injectable monotonic clock (tests drive fake time)
    registry        injectable instrument store (utils.instruments) for
                    BOTH reads and writes (defaults to the process one;
                    tests isolate their histogram streams with it)

    dataset_wait_seconds is process-global and unlabeled, so two
    controlled datasets sharing the default registry read each other's
    waits (and last-write-win the dataset_prefetch_target gauge): run
    concurrent controlled datasets with per-dataset registries, or accept
    that the controllers co-steer against merged traffic.
    """

    def __init__(
        self,
        *,
        slo_wait_ms: float,
        initial_depth: int = 2,
        min_depth: int = 1,
        max_depth: int = 32,
        max_workers: int | None = None,
        readahead_unit_bytes: int = 4 << 20,
        window_s: float = 0.5,
        violation_share: float = 0.01,
        increase_step: int = 1,
        decrease_factor: float = 0.5,
        idle_fraction: float = 0.1,
        idle_windows: int = 4,
        clock=time.monotonic,
        registry=None,
    ):
        if slo_wait_ms <= 0:
            raise ValueError("controller: slo_wait_ms must be positive")
        if not 1 <= min_depth <= max_depth:
            raise ValueError("controller: need 1 <= min_depth <= max_depth")
        if window_s <= 0:
            raise ValueError("controller: window_s must be positive")
        if increase_step < 1:
            raise ValueError("controller: increase_step must be >= 1")
        if not 0.0 < decrease_factor < 1.0:
            raise ValueError("controller: decrease_factor must be in (0, 1)")
        self.slo_wait_ms = float(slo_wait_ms)
        self.slo_s = slo_wait_ms / 1e3
        self.min_depth = int(min_depth)
        self.max_depth = int(max_depth)
        if max_workers is None:
            env = os.environ.get("PQT_DATA_THREADS")
            max_workers = int(env) if env else (os.cpu_count() or 1)
        self.max_workers = max(1, int(max_workers))
        self.readahead_unit_bytes = int(readahead_unit_bytes)
        self.window_s = float(window_s)
        self.violation_share = float(violation_share)
        self.increase_step = int(increase_step)
        self.decrease_factor = float(decrease_factor)
        self.idle_fraction = float(idle_fraction)
        self.idle_windows = int(idle_windows)
        self._clock = clock
        self._registry = registry if registry is not None else INSTRUMENTS
        self._lock = threading.Lock()
        self._depth = max(self.min_depth, min(self.max_depth, int(initial_depth)))
        self._idle_streak = 0
        self._window_start = None  # first tick() arms the window
        self._last: dict | None = None  # histogram totals at window start
        self.ticks = 0  # completed control windows (tests pin convergence)
        self.increases = 0
        self.decreases = 0
        self.violations = 0  # wait observations over the SLO, all windows
        self._registry.set("dataset_prefetch_target", self._depth)

    # -- targets (read by the dataset's fill loop) -----------------------------

    @property
    def prefetch_target(self) -> int:
        with self._lock:
            return self._depth

    @property
    def worker_target(self) -> int:
        """Workers track the prefetch target (a window of k in-flight
        units can use at most k decoders), clamped to max_workers."""
        with self._lock:
            return max(1, min(self._depth, self.max_workers))

    @property
    def readahead_budget(self) -> int:
        with self._lock:
            return max(1, self._depth) * self.readahead_unit_bytes

    # -- the inputs ------------------------------------------------------------

    def _violation_bound(self, buckets) -> float | None:
        """The largest histogram bucket bound <= the SLO: observations past
        it are (conservatively) counted as violations. None when the SLO is
        below every bound (then only the mean-wait signal drives)."""
        best = None
        for le in buckets:
            if le <= self.slo_s:
                best = le
        return best

    def _read_inputs(self) -> dict:
        """Windowed totals of the driving instruments (monotonic — the
        delta between two reads is the window's traffic)."""
        wait = self._registry.hist_stats("dataset_wait_seconds")
        bound = self._violation_bound(wait["buckets"])
        if bound is not None:
            under = wait["bucket_counts"][wait["buckets"].index(bound)]
        else:
            # SLO below every bucket bound: no bucket can witness a
            # violation, so count nothing as one (violations stay 0) and
            # let the mean-wait signal drive alone
            under = wait["count"]
        pool_wait = self._registry.hist_stats(
            "pool_queue_wait_seconds", pool="pqt-data"
        )
        return {
            "count": wait["count"],
            "sum": wait["sum"],
            "under_slo": under,
            "pool_count": pool_wait["count"],
            "pool_sum": pool_wait["sum"],
        }

    # -- the control law -------------------------------------------------------

    def tick(self) -> bool:
        """Evaluate one control window if `window_s` has elapsed (cheap
        no-op otherwise — call freely from the consumer loop). Returns
        True when a window was evaluated."""
        now = self._clock()
        with self._lock:
            if self._window_start is None:
                self._window_start = now
                self._last = self._read_inputs()
                return False
            if now - self._window_start < self.window_s:
                return False
            cur = self._read_inputs()
            last, self._last = self._last, cur
            self._window_start = now
            self.ticks += 1
            d_count = cur["count"] - last["count"]
            d_sum = cur["sum"] - last["sum"]
            d_under = cur["under_slo"] - last["under_slo"]
            violations = max(0, d_count - d_under)
            self.violations += violations
            mean_wait = (d_sum / d_count) if d_count else 0.0
            share = (violations / d_count) if d_count else 0.0
            pressured = (d_count > 0) and (
                share > self.violation_share or mean_wait > self.slo_s
            )
            idle = (d_count > 0) and (
                violations == 0 and mean_wait < self.idle_fraction * self.slo_s
            )
            old = self._depth
            if pressured:
                self._idle_streak = 0
                self._depth = min(self.max_depth, old + self.increase_step)
                if self._depth != old:
                    self.increases += 1
            elif idle:
                self._idle_streak += 1
                if self._idle_streak >= self.idle_windows:
                    self._idle_streak = 0
                    self._depth = max(
                        self.min_depth, int(old * self.decrease_factor)
                    )
                    if self._depth != old:
                        self.decreases += 1
            else:
                self._idle_streak = 0
            changed = self._depth != old
            depth = self._depth
        if changed:
            self._registry.set("dataset_prefetch_target", depth)
        return True

    def state(self) -> dict:
        """Diagnostic snapshot (NOT checkpoint state — the controller is
        advisory and deliberately absent from DatasetIterator.state_dict)."""
        with self._lock:
            return {
                "depth": self._depth,
                "worker_target": max(1, min(self._depth, self.max_workers)),
                "ticks": self.ticks,
                "increases": self.increases,
                "decreases": self.decreases,
                "idle_streak": self._idle_streak,
            }
