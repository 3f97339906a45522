"""Scripted chaos: phased fault schedules driven through the whole stack.

faults.py corrupts bytes, flaky.py corrupts single operations; this module
corrupts TIME — it scripts a fault timeline (phases with durations and
FlakySource/FlakySink knob overrides) and drives it through every byte
source the system opens, so "the store had a latency spike, then an error
burst, then went dark, then recovered" becomes one deterministic,
replayable object:

    schedule = standard_schedule(phase_s=2.0)   # spike -> errors -> blackout -> recovery
    with ChaosHarness(schedule, seed=7, breaker=True, retry=True) as chaos:
        report = run_dataset_chaos(glob, batch_size=4096,
                                   slo_wait_ms=50.0, chaos=chaos)

Pieces:

  Phase / FaultSchedule   the timeline. `params_at(t)` returns the knob
                          overrides of the phase containing `t` (relative
                          to the schedule's armed start). Phases validate
                          their knob names at construction — a typo'd
                          "eror_rate" fails the script, not silently
                          no-ops the burst. Deterministic under fake time:
                          FlakySource reads the schedule through its own
                          injectable clock.
  ChaosHarness            a context manager that (a) arms the schedule,
                          (b) installs a resilience policy through
                          io.hedge.configure_resilience whose innermost
                          chaos_wrapper wraps every concrete source the
                          process opens in a schedule-driven FlakySource
                          (seeded per source_id, so multi-threaded opens
                          stay reproducible), with the breaker/retry/hedge
                          stack under test layered above, and (c) restores
                          the previous policy and resets the breakers on
                          exit — chaos never leaks past its block.
  run_dataset_chaos       stream a ParquetDataset under the harness,
                          timing every next() and attributing it to the
                          phase it landed in; returns per-phase consumer-
                          wait percentiles + SLO violation shares + the
                          hedge/retry/skip counters — the measured
                          "degraded in typed steps, never collapsed"
                          artifact.

A serve-side chaos run builds on the same ChaosHarness via
ServeConfig.source_factory or the installed policy.

The port's copy of parquet_tpu.testing.chaos. run_dataset_chaos reads its
hedge, retry, skip and violation figures as deltas of io.counts.io_counts()
and data.dataset.dataset_counts() (the reference reads its metrics
registry), takes `device=` for the dataset's delivery (None is CUDA, as
everywhere in the port), and adds to the reference's report "devices",
the device types the batches were delivered on.
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass, field

from .flaky import _SOURCE_KNOBS, FlakySource

__all__ = [
    "Phase",
    "FaultSchedule",
    "standard_schedule",
    "ChaosHarness",
    "run_dataset_chaos",
    "percentile",
]

# every knob a phase may script (source + sink vocabularies share names;
# sink-only knobs listed explicitly)
_PHASE_KNOBS = set(_SOURCE_KNOBS) | {"flush_error_rate"}


@dataclass(frozen=True)
class Phase:
    """One segment of a fault timeline: `duration_s` of the FlakySource/
    FlakySink overrides in `params` (empty params = healthy)."""

    name: str
    duration_s: float
    params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.duration_s <= 0:
            raise ValueError(f"phase {self.name!r}: duration_s must be positive")
        unknown = set(self.params) - _PHASE_KNOBS
        if unknown:
            raise ValueError(
                f"phase {self.name!r}: unknown fault knobs {sorted(unknown)} "
                f"(known: {sorted(_PHASE_KNOBS)})"
            )


class FaultSchedule:
    """A sequence of Phases on a time axis.

    The schedule arms at the first `params_at()`/`phase_at()` call (or an
    explicit `start()`), then each query maps clock time to the phase
    containing it. Past the end, the LAST phase's params hold — end a
    timeline with a healthy "recovery" phase to model a store that came
    back. The schedule holds no clock of its own: every consumer passes
    its OWN (injectable) clock's now, which is what makes chaos
    deterministic under fake time."""

    def __init__(self, phases):
        phases = list(phases)
        if not phases:
            raise ValueError("schedule: need at least one phase")
        self.phases = phases
        self.total_s = sum(p.duration_s for p in phases)
        self._t0: float | None = None

    def start(self, now: float) -> "FaultSchedule":
        """Arm the timeline at `now` (idempotent; queries self-arm too)."""
        if self._t0 is None:
            self._t0 = float(now)
        return self

    @property
    def started(self) -> bool:
        return self._t0 is not None

    def phase_at(self, now: float) -> Phase:
        """The Phase containing `now` (arms at `now` on first query; the
        last phase holds past the end)."""
        self.start(now)
        t = now - self._t0
        for p in self.phases:
            if t < p.duration_s:
                return p
            t -= p.duration_s
        return self.phases[-1]

    def params_at(self, now: float) -> dict:
        """The FlakySource/FlakySink overrides in force at `now` (the hook
        flaky.py consults per operation)."""
        return self.phase_at(now).params

    def elapsed(self, now: float) -> float:
        self.start(now)
        return now - self._t0

    def done(self, now: float) -> bool:
        self.start(now)
        return now - self._t0 >= self.total_s


def standard_schedule(
    *,
    phase_s: float = 2.0,
    spike_p: float = 0.3,
    spike_ms: float = 30.0,
    error_rate: float = 0.3,
    warmup_s: float | None = None,
    base: dict | None = None,
) -> FaultSchedule:
    """The canonical four-act chaos timeline: healthy warmup, latency
    spike, error burst, blackout, recovery. One knob (`phase_s`) scales the
    whole run; the individual severities have the defaults the acceptance
    pins were tuned against. `base` (e.g. a constant latency_s modeling a
    remote store) overlays EVERY phase under its own params."""
    base = dict(base or {})
    return FaultSchedule([
        Phase("warmup", warmup_s if warmup_s is not None else phase_s, base),
        Phase("latency_spike", phase_s,
              {**base, "spike_rate": spike_p, "spike_s": spike_ms / 1e3}),
        Phase("error_burst", phase_s, {**base, "error_rate": error_rate}),
        Phase("blackout", phase_s, {**base, "permanent": True}),
        Phase("recovery", phase_s, base),
    ])


class ChaosHarness:
    """Install a schedule-driven fault wrapper (plus the resilience stack
    under test) as the process resilience policy, scoped to a with-block.

    Parameters mirror io.hedge.ResilienceConfig: `breaker`/`retry`/`hedge`
    enable those layers ABOVE the injected faults (breaker_kw/retry_kw/
    hedge_kw pass through). Each wrapper's rng seed mixes `seed`, the
    source_id (crc32) and that source's OPEN ORDINAL — the ordinal
    matters: unit decodes open a fresh source per row group, and a seed
    that were a pure function of source_id would replay the same first
    draw on every one-read open, collapsing "30% of reads spike" into
    all-or-nothing per file. The stream is exactly reproducible when each
    file's opens are sequential (single-threaded tests; the fake-clock
    suites), and statistically faithful under concurrent opens.
    `clock`/`sleep` are injected into every FlakySource (fake time drives
    the phases; a no-op sleep makes latency phases free in unit tests).
    """

    def __init__(
        self,
        schedule: FaultSchedule,
        *,
        seed: int = 0,
        breaker: bool = False,
        retry: bool = False,
        hedge: bool = False,
        breaker_kw: dict | None = None,
        retry_kw: dict | None = None,
        hedge_kw: dict | None = None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        self.schedule = schedule
        self.seed = int(seed)
        self._clock = clock
        self._sleep = sleep
        self._breaker = breaker
        self._retry = retry
        self._hedge = hedge
        self._breaker_kw = dict(breaker_kw or {})
        self._retry_kw = dict(retry_kw or {})
        self._hedge_kw = dict(hedge_kw or {})
        self._prev = None
        self._config = None
        self._wrap_lock = threading.Lock()
        self._ordinals: dict[str, int] = {}  # per-source_id open counter
        self.sources: list[FlakySource] = []  # every wrapper handed out

    # -- the wrapper (usable standalone: ServeConfig.source_factory) -----------

    def wrap(self, source) -> FlakySource:
        """Wrap one ByteSource in a schedule-driven FlakySource (seed mixed
        from the harness seed, the source_id and its open ordinal). Also
        the building block for a daemon's source_factory:
        `lambda path: chaos.wrap(LocalFileSource(path))`."""
        sid = source.source_id
        with self._wrap_lock:
            ordinal = self._ordinals.get(sid, 0)
            self._ordinals[sid] = ordinal + 1
        fs = FlakySource(
            source,
            seed=(
                zlib.crc32(sid.encode()) ^ self.seed ^ (ordinal << 16)
            ) & 0x7FFFFFFF,
            schedule=self.schedule,
            clock=self._clock,
            sleep=self._sleep,
        )
        with self._wrap_lock:
            self.sources.append(fs)
        return fs

    # -- scoped install --------------------------------------------------------

    def __enter__(self) -> "ChaosHarness":
        from ..io.hedge import ResilienceConfig, configure_resilience

        self.schedule.start(self._clock())
        # retries in chaos tests must not sleep real wall time unless the
        # caller wants them to: default the ladder's sleep to the harness's
        retry_kw = dict(self._retry_kw)
        retry_kw.setdefault("sleep", self._sleep)
        self._config = ResilienceConfig(
            breaker=self._breaker,
            breaker_kw=self._breaker_kw,
            retry=self._retry,
            retry_kw=retry_kw,
            hedge=self._hedge,
            hedge_kw=self._hedge_kw,
            chaos_wrapper=self.wrap,
        )
        self._prev = configure_resilience(self._config)
        return self

    def __exit__(self, *exc):
        from ..io.hedge import breaker_registry, configure_resilience

        configure_resilience(self._prev)
        if self._config is not None and self._config.registry is not None:
            self._config.registry.reset()
        else:
            breaker_registry().reset()
        return False

    def faults_injected(self) -> int:
        return sum(s.faults_injected for s in self.sources)

    def spikes_injected(self) -> int:
        return sum(s.spikes_injected for s in self.sources)


def percentile(values, q: float) -> float | None:
    """The q-quantile (0..1) of `values` by rank (None when empty) — the
    chaos report's p50/p99 without a numpy dependency on the hot path."""
    if not values:
        return None
    vals = sorted(values)
    k = min(len(vals) - 1, max(0, int(q * len(vals))))
    return vals[k]


def run_dataset_chaos(
    paths_or_glob,
    *,
    chaos: ChaosHarness,
    batch_size: int,
    slo_wait_ms: float | None = None,
    controller=None,
    enable_controller: bool = True,
    columns=None,
    cache_bytes: int = 0,
    prefetch: int = 2,
    step_s: float = 0.0,
    max_batches: int | None = None,
    until_schedule_done: bool = True,
    dataset_kw: dict | None = None,
    device=None,
) -> dict:
    """Stream a dataset under an (already entered) ChaosHarness and report
    per-phase consumer waits.

    The consumer loop times every `next()` (the wait a train step would
    feel), attributes it to the schedule phase at that moment, optionally
    sleeps `step_s` (a device-bound step), and keeps cycling epochs until
    the schedule has played out (`until_schedule_done`) or `max_batches`.
    Corrupt/blacked-out units quarantine via on_error="skip" — the typed
    degradation under test; a raised error here IS a harness failure.
    `enable_controller=False` keeps the SLO for REPORTING (violation
    counts) but detaches the controller — the A/B that shows whether the
    controller is what holds the SLO. The batches arrive on `device`
    (None is CUDA).

    Returns {"phases": {name: {waits, p50_ms, p99_ms, max_ms, violations,
    violation_share}}, "batches", "rows", "units_skipped", "hedge": {...},
    "breaker_fast_fails", "controller": {...}, "devices": [...]} — the
    measured shape of the degradation."""
    from ..data.dataset import ParquetDataset, dataset_counts
    from ..io.counts import io_counts

    clock = chaos._clock
    per_phase: dict[str, list[float]] = {p.name: [] for p in chaos.schedule.phases}
    io0, ds0 = io_counts(), dataset_counts()
    kw = dict(dataset_kw or {})
    ds = ParquetDataset(
        paths_or_glob,
        batch_size=batch_size,
        columns=columns,
        prefetch=prefetch,
        num_epochs=None if until_schedule_done else 1,
        remainder="keep",
        on_error="skip",
        cache_bytes=cache_bytes,
        slo_wait_ms=(slo_wait_ms if enable_controller else None),
        controller=controller,
        device=device,
        **kw,
    )
    batches = rows = 0
    devices: set[str] = set()
    t_wall0 = time.perf_counter()
    with ds:
        it = iter(ds)
        while True:
            if max_batches is not None and batches >= max_batches:
                break
            if (
                until_schedule_done
                and chaos.schedule.done(clock())
                and batches > 0
            ):
                break
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            wait_s = time.perf_counter() - t0
            phase = chaos.schedule.phase_at(clock())
            per_phase.setdefault(phase.name, []).append(wait_s)
            batches += 1
            rows += int(next(iter(batch.values())).shape[0])
            for col in batch.values():
                # a masked or ragged column is a tuple of tensors
                for t in col if isinstance(col, tuple) else (col,):
                    devices.add(t.device.type)
            if step_s:
                chaos._sleep(step_s)
        it.close()
    wall = time.perf_counter() - t_wall0
    io_d = _delta(io_counts(), io0)
    ds_d = _delta(dataset_counts(), ds0)
    slo_s = (slo_wait_ms / 1e3) if slo_wait_ms is not None else None
    phases = {}
    for name, waits in per_phase.items():
        viol = (
            sum(1 for w in waits if w > slo_s) if slo_s is not None else 0
        )
        phases[name] = {
            "waits": len(waits),
            "p50_ms": _ms(percentile(waits, 0.50)),
            "p99_ms": _ms(percentile(waits, 0.99)),
            "max_ms": _ms(max(waits) if waits else None),
            "violations": viol,
            "violation_share": (
                round(viol / len(waits), 4) if waits else None
            ),
        }
    hedge = {
        k.split('"')[1]: v
        for k, v in io_d.items()
        if k.startswith("io_hedges_total")
    }
    return {
        "phases": phases,
        "batches": batches,
        "rows": rows,
        "wall_s": round(wall, 4),
        "slo_wait_ms": slo_wait_ms,
        "units_skipped": ds_d.get("units_skipped", 0),
        "faults_injected": chaos.faults_injected(),
        "spikes_injected": chaos.spikes_injected(),
        "hedge": hedge,
        "retries": sum(
            v for k, v in io_d.items() if k.startswith("io_retries_total")
        ),
        "slo_violations_total": ds_d.get("dataset_slo_violations_total", 0),
        "controller": (
            ds._controller.state() if ds._controller is not None else None
        ),
        "devices": sorted(devices),
    }


def _delta(now: dict, then: dict) -> dict:
    """What changed since `then` (a counts snapshot): {key: now - then},
    zero differences left out."""
    out = {}
    for k, v in now.items():
        d = v - then.get(k, 0)
        if d:
            out[k] = d
    return out


def _ms(seconds) -> float | None:
    return None if seconds is None else round(seconds * 1e3, 3)
