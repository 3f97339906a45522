"""FlakySource/FlakySink: seeded transport-fault injection for the IO layers.

The fault-injection harness in testing/faults.py corrupts BYTES (what a
rotten disk or lying writer produces); this module corrupts the TRANSPORT —
what a loaded object store or flaky NFS mount produces: transient EIO,
short reads, injected latency, latency spikes, and (optionally) permanent
failure. Wrapped around any ByteSource and driven from an integer seed, it
gives the retry ladder (io.source.RetryingSource) a deterministic
adversary:

    src = RetryingSource(
        FlakySource(LocalFileSource(path), seed=7, error_rate=0.3),
        sleep=lambda s: None,    # tests: no real backoff waits
    )

Every fault draw comes from one numpy default_rng stream, so a failing test
replays exactly; each CALL re-rolls, so a retried read naturally has a fresh
chance to succeed — the transient-fault shape. `fault_window` confines
faults to a byte region (e.g. only the footer tail); `permanent=True` makes
every read fail, the budget-exhaustion shape.

`schedule=` accepts a testing.chaos.FaultSchedule (anything with a
`params_at(t)` -> dict): each operation reads the schedule's CURRENT phase
parameters at the injected `clock` and overlays them on the constructor
knobs — the chaos harness drives a whole latency-spike -> error-burst ->
blackout -> recovery timeline through one wrapper, deterministically under
fake time (advance the fake clock, the phase changes; the rng stream stays
one seeded sequence either way).

The port's copy of parquet_tpu.testing.flaky, read side: FlakySink (the
write-side mirror) comes with the remote sink.
"""

from __future__ import annotations

import errno as _errno
import time

import numpy as np

__all__ = ["FlakySource"]

# the knobs a FaultSchedule phase may override
_SOURCE_KNOBS = (
    "error_rate", "short_rate", "latency_s", "latency_jitter_s",
    "spike_rate", "spike_s", "permanent",
)


class FlakySource:
    """A ByteSource wrapper injecting seeded transport faults.

    Parameters
    ----------
    inner        the wrapped ByteSource
    seed         rng seed; one stream across all fault draws
    error_rate   probability a read raises a transient OSError(EIO)
    short_rate   probability a read returns a truncated buffer (a contract
                 violation real transports commit; RetryingSource re-reads)
    latency_s    fixed sleep added to every read (the range-GET shape);
                 latency_jitter_s adds a uniform extra draw on top
    spike_rate   probability a read stalls an EXTRA spike_s on top of the
                 base latency — the hot-shard / GC-pause / tail-latency
                 shape (see the latency_spike preset)
    permanent    every read fails with EIO — the budget-exhaustion case
    fault_window (offset, length) confining faults to reads that overlap
                 the window (None = everywhere)
    schedule     a FaultSchedule whose current phase overrides the knobs
                 above per operation (chaos timelines)
    clock        the schedule's time base (injectable: fake time makes
                 chaos phases deterministic)
    """

    def __init__(
        self,
        inner,
        *,
        seed: int = 0,
        error_rate: float = 0.0,
        short_rate: float = 0.0,
        latency_s: float = 0.0,
        latency_jitter_s: float = 0.0,
        spike_rate: float = 0.0,
        spike_s: float = 0.0,
        permanent: bool = False,
        fault_window: tuple[int, int] | None = None,
        schedule=None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        self.inner = inner
        self._rng = np.random.default_rng(seed)
        self.error_rate = float(error_rate)
        self.short_rate = float(short_rate)
        self.latency_s = float(latency_s)
        self.latency_jitter_s = float(latency_jitter_s)
        self.spike_rate = float(spike_rate)
        self.spike_s = float(spike_s)
        self.permanent = bool(permanent)
        self.fault_window = fault_window
        self.schedule = schedule
        self._clock = clock
        self._sleep = sleep
        self.faults_injected = 0
        self.reads = 0
        self.spikes_injected = 0

    @classmethod
    def latency_spike(cls, inner, *, seed: int = 0, p: float = 0.05, ms: float = 50.0, **kw):
        """Preset: a source whose reads occasionally STALL — each read has
        probability `p` of an extra `ms`-millisecond spike (seeded, so a
        failing chaos run replays exactly). The serving-layer adversary: a
        latency-spiked source must produce slow responses or typed
        timeouts, never a hung worker or a torn response body."""
        return cls(inner, seed=seed, spike_rate=p, spike_s=ms / 1e3, **kw)

    @property
    def source_id(self) -> str:
        return self.inner.source_id

    def generation(self):
        gen = getattr(self.inner, "generation", None)
        return gen() if gen is not None else None

    def size(self) -> int:
        return self.inner.size()

    def _in_window(self, offset: int, n: int) -> bool:
        if self.fault_window is None:
            return True
        w_off, w_len = self.fault_window
        return offset < w_off + w_len and offset + n > w_off

    def _params(self) -> dict:
        """The effective knobs for THIS operation: the constructor values,
        overlaid with the schedule's current phase when one is attached."""
        p = {k: getattr(self, k) for k in _SOURCE_KNOBS}
        if self.schedule is not None:
            p.update(
                (k, v)
                for k, v in self.schedule.params_at(self._clock()).items()
                if k in p
            )
        return p

    def read_at(self, offset: int, n: int) -> bytes:
        self.reads += 1
        p = self._params()
        if p["latency_s"] or p["latency_jitter_s"]:
            extra = (
                float(self._rng.uniform(0, p["latency_jitter_s"]))
                if p["latency_jitter_s"]
                else 0.0
            )
            self._sleep(p["latency_s"] + extra)
        # spikes draw only when enabled so existing seeds' fault streams
        # are unchanged by the knob's existence
        if p["spike_rate"] and float(self._rng.random()) < p["spike_rate"]:
            self.spikes_injected += 1
            self._sleep(p["spike_s"])
        if self._in_window(offset, n):
            if p["permanent"]:
                self.faults_injected += 1
                raise OSError(_errno.EIO, f"injected permanent EIO at {offset}")
            roll = float(self._rng.random())
            if roll < p["error_rate"]:
                self.faults_injected += 1
                raise OSError(_errno.EIO, f"injected transient EIO at {offset}")
            if roll < p["error_rate"] + p["short_rate"] and n > 1:
                self.faults_injected += 1
                cut = int(self._rng.integers(0, n))
                return self.inner.read_at(offset, cut)
        return self.inner.read_at(offset, n)

    def read_ranges(self, ranges) -> list:
        # per-range faults: one flaky range in a batch, not all-or-nothing
        return [self.read_at(off, n) for off, n in ranges]

    def close(self) -> None:
        self.inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
