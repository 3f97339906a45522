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

FlakySink is the WRITE-side mirror: wrapped around any ByteSink it injects
seeded write/flush/commit faults (including latency spikes, the same knobs
and `latency_spike` preset as FlakySource), the adversary for the
FileWriter error path — flush failures must surface as typed WriterError
and, because path sinks commit atomically, the destination must never hold
a torn file:

    sink = FlakySink(LocalFileSink(path), seed=7, error_rate=0.3)
    with pytest.raises(WriterError):
        with FileWriter(sink, schema) as w: ...
    assert not os.path.exists(path)          # nothing committed

The port's copy of parquet_tpu.testing.flaky.
"""

from __future__ import annotations

import errno as _errno
import time

import numpy as np

__all__ = ["FlakySource", "FlakySink"]

# the knobs a FaultSchedule phase may override, shared by source and sink
_SOURCE_KNOBS = (
    "error_rate", "short_rate", "latency_s", "latency_jitter_s",
    "spike_rate", "spike_s", "permanent",
)
_SINK_KNOBS = (
    "error_rate", "flush_error_rate", "latency_s", "spike_rate", "spike_s",
    "permanent",
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


class FlakySink:
    """A ByteSink wrapper injecting seeded write-path faults (the mirror of
    FlakySource for the FileWriter/sink error ladder).

    Parameters
    ----------
    inner            the wrapped ByteSink
    seed             rng seed; one stream across all fault draws
    error_rate       probability a write raises a transient OSError(EIO)
                     BEFORE any bytes reach the inner sink (clean failure)
    fail_after_bytes when set, every write past this many successfully
                     written bytes fails — the disk-full / quota shape
    flush_error_rate probability flush() raises OSError(EIO)
    commit_error     close() (the commit) raises OSError(EIO) — the
                     rename-fails shape; abort stays clean
    latency_s        fixed sleep added to every write (the PUT shape)
    spike_rate       probability a write stalls an EXTRA spike_s — the
                     stalled-PUT / throttled-store shape (see the
                     latency_spike preset, FlakySource parity)
    permanent        every write fails with EIO
    schedule         a FaultSchedule whose current phase overrides the
                     knobs above per operation (chaos timelines)
    clock            the schedule's time base (injectable)
    """

    def __init__(
        self,
        inner,
        *,
        seed: int = 0,
        error_rate: float = 0.0,
        fail_after_bytes: int | None = None,
        flush_error_rate: float = 0.0,
        commit_error: bool = False,
        latency_s: float = 0.0,
        spike_rate: float = 0.0,
        spike_s: float = 0.0,
        permanent: bool = False,
        schedule=None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        self.inner = inner
        self._rng = np.random.default_rng(seed)
        self.error_rate = float(error_rate)
        self.fail_after_bytes = fail_after_bytes
        self.flush_error_rate = float(flush_error_rate)
        self.commit_error = bool(commit_error)
        self.latency_s = float(latency_s)
        self.spike_rate = float(spike_rate)
        self.spike_s = float(spike_s)
        self.permanent = bool(permanent)
        self.schedule = schedule
        self._clock = clock
        self._sleep = sleep
        self.faults_injected = 0
        self.writes = 0
        self.bytes_written = 0
        self.spikes_injected = 0

    @classmethod
    def latency_spike(cls, inner, *, seed: int = 0, p: float = 0.05, ms: float = 50.0, **kw):
        """Preset: a sink whose writes occasionally STALL — each write has
        probability `p` of an extra `ms`-millisecond spike (seeded). The
        FlakySource.latency_spike mirror for the encode/flush pipeline."""
        return cls(inner, seed=seed, spike_rate=p, spike_s=ms / 1e3, **kw)

    @property
    def sink_id(self) -> str:
        return self.inner.sink_id

    def _params(self) -> dict:
        p = {k: getattr(self, k) for k in _SINK_KNOBS}
        if self.schedule is not None:
            p.update(
                (k, v)
                for k, v in self.schedule.params_at(self._clock()).items()
                if k in p
            )
        return p

    def write(self, data) -> int:
        self.writes += 1
        p = self._params()
        if p["latency_s"]:
            self._sleep(p["latency_s"])
        if p["spike_rate"] and float(self._rng.random()) < p["spike_rate"]:
            self.spikes_injected += 1
            self._sleep(p["spike_s"])
        if p["permanent"]:
            self.faults_injected += 1
            raise OSError(_errno.EIO, "injected permanent EIO on write")
        if (
            self.fail_after_bytes is not None
            and self.bytes_written + len(data) > self.fail_after_bytes
        ):
            self.faults_injected += 1
            raise OSError(
                _errno.ENOSPC,
                f"injected write failure past {self.fail_after_bytes} bytes",
            )
        if p["error_rate"] and float(self._rng.random()) < p["error_rate"]:
            self.faults_injected += 1
            raise OSError(
                _errno.EIO, f"injected transient EIO at write {self.writes}"
            )
        n = self.inner.write(data)
        self.bytes_written += len(data)
        return n

    def tell(self) -> int:
        return self.inner.tell()

    def flush(self) -> None:
        rate = self._params()["flush_error_rate"]
        if rate and float(self._rng.random()) < rate:
            self.faults_injected += 1
            raise OSError(_errno.EIO, "injected EIO on flush")
        self.inner.flush()

    def close(self) -> None:
        if self.commit_error:
            self.faults_injected += 1
            # the inner sink must not commit either: a failed commit that
            # still renamed the temp file would be the torn-file bug itself
            self.inner.abort()
            raise OSError(_errno.EIO, "injected EIO on commit")
        self.inner.close()

    def abort(self) -> None:
        self.inner.abort()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False
