"""Hedged reads and circuit breakers: the failover layer of the IO stack.

RetryingSource (source.py) answers a TRANSIENT fault after the fact: wait,
try again. This module answers the two failure shapes retry alone handles
badly:

  tail latency   one read in twenty stalls 50x longer than the median (a
                 hot shard, a GC pause, a slow replica). Retrying only
                 starts AFTER the stall. `HedgedSource` instead launches a
                 duplicate of a read that has outlived the observed latency
                 quantile and takes whichever copy answers first — the
                 classic tail-at-scale move. The loser is cancelled when
                 still queued, or absorbed (result dropped, latency still
                 recorded) when already running.

  blackout       a source that fails EVERY read. The retry ladder burns
                 its full attempts x backoff budget on each of potentially
                 thousands of reads. A `CircuitBreaker` per source_id trips
                 after `failure_threshold` consecutive failures and
                 fast-fails every subsequent read with the typed
                 SourceError(code="breaker_open") until `open_s` has
                 passed; then ONE half-open probe read is let through — it
                 closes the breaker on success and re-arms the open timer
                 on failure.

Composition is explicit and order matters:

    RetryingSource(BreakerSource(src))   breaker counts RAW failures; the
                                         fast-fail is a SourceError, which
                                         the retry ladder treats as
                                         terminal (no pointless backoff)
    BreakerSource(RetryingSource(src))   breaker counts post-retry
                                         EXHAUSTION (trips only when the
                                         ladder itself gives up)

`ResilienceConfig` + `configure_resilience()` wire the layer through
`open_source`, the choke point every FileReader construction passes: when a
policy is installed, every concrete source opened anywhere (reader, dataset
units, serve executor, readahead) comes back wrapped per the policy — the
chaos harness (testing/chaos.py) also injects its FlakySource through the
same hook. The default policy is all-off: zero wrappers, zero cost.

Counts (io.counts): io_hedges_total{outcome=launched|win_primary|
win_hedge|failed}, and the io_breaker_state{source=} gauge (0 closed, 1
open, 2 half-open; the label set is bounded by BreakerRegistry's
max_sources). A hedge launch and every breaker transition are also logged
(obs.log), and a launch is an io.hedge count of the request's trace.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from dataclasses import dataclass, field

from ..obs.log import log_event as _log_event
from ..obs.pool import instrumented_submit
from ..utils import metrics as _metrics
from ..utils import trace as _trace
from .counts import count as _count
from .source import ByteSource, RetryingSource, SourceError

__all__ = [
    "HedgedSource",
    "CircuitBreaker",
    "BreakerRegistry",
    "BreakerSource",
    "breaker_registry",
    "ResilienceConfig",
    "configure_resilience",
    "resilience_config",
    "wrap_resilient",
    "hedge_pool",
]


# -- the hedge pool ------------------------------------------------------------

_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def hedge_pool() -> ThreadPoolExecutor:
    """The process-wide hedged-read executor ("pqt-hedge", 8 workers). Its
    OWN pool, never pqt-io: hedged reads are issued FROM pqt-io readahead
    tasks, and a bounded pool that submits to itself deadlocks the moment every worker is waiting on a future only another
    worker can run."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="pqt-hedge")
        return _pool


class _LatencyWindow:
    """A bounded ring of recent read latencies with on-demand quantiles
    (128 floats: the sort is cheaper than any streaming sketch at this
    size, and the window forgets a past latency regime in ~128 reads)."""

    __slots__ = ("_buf", "_n", "_next", "_lock")

    def __init__(self, size: int = 128):
        self._buf = [0.0] * size
        self._n = 0  # filled entries
        self._next = 0  # ring cursor
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._next] = seconds
            self._next = (self._next + 1) % len(self._buf)
            if self._n < len(self._buf):
                self._n += 1

    def quantile(self, q: float) -> float | None:
        with self._lock:
            if self._n < 8:  # too few samples to call a tail
                return None
            vals = sorted(self._buf[: self._n])
        k = min(self._n - 1, max(0, int(q * self._n)))
        return vals[k]


class HedgedSource(ByteSource):
    """Duplicate a read that has outlived the observed latency quantile;
    first result wins.

    Every read runs as a task on the pqt-hedge pool. The caller waits
    `hedge delay` = clamp(quantile(`delay_quantile`) of the last ~128 read
    latencies, [`min_delay_s`, `max_delay_s`]) for the primary; past that it
    launches ONE duplicate and returns whichever finishes first with data.
    The loser is cancelled if still queued; if running, its completion is
    absorbed by a done-callback that records the latency and swallows the
    result/exception. Both copies failing raises the primary's error.

    Wrap OUTSIDE RetryingSource for independent retry ladders per copy, or
    INSIDE so the ladder retries a hedged read as one unit. Not free: each
    read pays a pool hop, so this belongs on ~ms-latency (remote-shaped)
    sources, not raw local files.
    """

    def __init__(
        self,
        inner: ByteSource,
        *,
        delay_quantile: float = 0.95,
        min_delay_s: float = 0.01,
        max_delay_s: float = 1.0,
        initial_delay_s: float = 0.05,
        window: int = 128,
        clock=time.perf_counter,
    ):
        if not 0.0 < delay_quantile < 1.0:
            raise ValueError("hedge: delay_quantile must be in (0, 1)")
        if min_delay_s < 0 or max_delay_s < min_delay_s:
            raise ValueError("hedge: need 0 <= min_delay_s <= max_delay_s")
        self.inner = inner
        self.delay_quantile = float(delay_quantile)
        self.min_delay_s = float(min_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.initial_delay_s = float(initial_delay_s)
        self._clock = clock
        self._window = _LatencyWindow(window)
        self.hedges_launched = 0
        self.hedges_won = 0

    @property
    def source_id(self) -> str:
        return self.inner.source_id

    def generation(self):
        gen = getattr(self.inner, "generation", None)
        return gen() if gen is not None else None

    def size(self) -> int:
        return self.inner.size()

    def hedge_delay(self) -> float:
        """The current stall bar: the latency-window quantile clamped to
        [min_delay_s, max_delay_s] (initial_delay_s until the window has
        enough samples to call a tail)."""
        q = self._window.quantile(self.delay_quantile)
        if q is None:
            q = self.initial_delay_s
        return min(self.max_delay_s, max(self.min_delay_s, q))

    def _timed_read(self, offset: int, n: int) -> bytes:
        t0 = self._clock()
        try:
            return self.inner.read_at(offset, n)
        finally:
            self._window.record(self._clock() - t0)

    def read_at(self, offset: int, n: int) -> bytes:
        delay = self.hedge_delay()
        primary = instrumented_submit(
            hedge_pool(), self._timed_read, offset, n, pool="pqt-hedge"
        )
        try:
            # a primary failing BEFORE the bar propagates from here: there
            # is nothing to race, retry ladders handle plain failure
            return primary.result(timeout=delay)
        except _FutTimeout:
            pass
        # the primary outlived the bar: race a duplicate
        hedge = instrumented_submit(
            hedge_pool(), self._timed_read, offset, n, pool="pqt-hedge"
        )
        self.hedges_launched += 1
        _count("io_hedges_total", outcome="launched")
        # per-request attribution beside the process-wide counter: the
        # hedge launch is visible in this request's merged trace
        _trace.count("io.hedge")
        _log_event(
            "hedged_read", delay_ms=round(delay * 1e3, 3), offset=offset,
            nbytes=n, source=self.inner.source_id,
        )
        return self._race(primary, hedge)

    def _race(self, primary, hedge) -> bytes:
        """First copy to return data wins; the loser is cancelled or
        absorbed. Both failing re-raises the primary's error (the hedge's
        is the same fault one more time, not new information)."""
        from concurrent.futures import FIRST_COMPLETED, wait

        pending = {primary: "primary", hedge: "hedge"}
        first_error = {}
        while pending:
            done, _ = wait(list(pending), return_when=FIRST_COMPLETED)
            for fut in done:
                who = pending.pop(fut)
                err = fut.exception()
                if err is None:
                    self._absorb(pending)
                    if who == "hedge":
                        self.hedges_won += 1
                    _count("io_hedges_total", outcome=f"win_{who}")
                    return fut.result()
                first_error[who] = err
        _count("io_hedges_total", outcome="failed")
        raise first_error.get("primary") or first_error["hedge"]

    @staticmethod
    def _absorb(pending: dict) -> None:
        """Cancel still-queued losers; running ones get a callback that
        retrieves their outcome so a late failure never surfaces as an
        'exception was never retrieved' warning."""
        for fut in pending:
            if not fut.cancel():
                fut.add_done_callback(
                    lambda f: f.cancelled() or f.exception()
                )

    def read_ranges(self, ranges) -> list:
        return [self.read_at(off, n) for off, n in ranges]

    def close(self) -> None:
        self.inner.close()


# -- circuit breaker -----------------------------------------------------------

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"
_STATE_GAUGE = {_CLOSED: 0, _OPEN: 1, _HALF_OPEN: 2}


class CircuitBreaker:
    """closed -> open -> half-open failure gate for one source.

    Closed: reads pass; `failure_threshold` CONSECUTIVE failures trip it
    open (any success resets the streak). Open: `before_read()` fast-fails
    with SourceError(code="breaker_open") — no transport touch, no retry
    ladder spin — until `open_s` has elapsed on the injected clock. Then
    half-open: ONE probe read is admitted (concurrent readers keep
    fast-failing); its success closes the breaker, its failure re-opens it
    and re-arms the timer. Thread-safe; every transition is logged and
    mirrored on the io_breaker_state{source=} gauge."""

    def __init__(
        self,
        source_id: str,
        *,
        failure_threshold: int = 5,
        open_s: float = 5.0,
        clock=time.monotonic,
        label: str | None = None,
    ):
        if failure_threshold < 1:
            raise ValueError("breaker: failure_threshold must be >= 1")
        if open_s <= 0:
            raise ValueError("breaker: open_s must be positive")
        self.source_id = source_id
        self.failure_threshold = int(failure_threshold)
        self.open_s = float(open_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = _CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        # the gauge label: bounded / sanitized by the registry (NOT the raw
        # source_id, which embeds paths and mtimes)
        self._label = label if label is not None else source_id[:96]
        self._set_gauge()

    def _set_gauge(self) -> None:
        _metrics.set_gauge(
            "io_breaker_state", _STATE_GAUGE[self._state], source=self._label
        )

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        # lock held
        if (
            self._state == _OPEN
            and self._clock() - self._opened_at >= self.open_s
        ):
            self._state = _HALF_OPEN
            self._probing = False
            self._set_gauge()

    def _transition(self, state: str, event: str) -> None:
        # lock held
        self._state = state
        self._set_gauge()
        _log_event(
            f"breaker_{event}", level="warning", source=self._label,
            failures=self._failures,
        )

    def before_read(self) -> None:
        """The admission gate: raises the typed fast-fail while open, and
        claims the single half-open probe slot."""
        with self._lock:
            self._maybe_half_open()
            if self._state == _CLOSED:
                return
            if self._state == _HALF_OPEN and not self._probing:
                self._probing = True  # this caller IS the probe
                return
        raise SourceError(
            f"breaker open for source {self._label}: fast-failing reads "
            f"for {self.open_s:.1f}s after {self.failure_threshold} "
            "consecutive failures",
            code="breaker_open",
        )

    def abort_probe(self) -> None:
        """Release the half-open probe slot without a verdict — the read
        never reached the transport (a ValueError caller bug), so it says
        nothing about source health. Without this, a probe that dies
        pre-flight would leave _probing latched and every later read
        fast-failing forever."""
        with self._lock:
            self._probing = False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != _CLOSED:
                self._transition(_CLOSED, "closed")
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == _HALF_OPEN:
                # the probe failed: back to open, timer re-armed
                self._opened_at = self._clock()
                self._probing = False
                self._transition(_OPEN, "reopened")
            elif (
                self._state == _CLOSED
                and self._failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._transition(_OPEN, "opened")


class BreakerRegistry:
    """Process-wide breakers keyed by source_id, BOUNDED like every other
    externally-keyed table in this codebase: past `max_sources` distinct
    ids, the least-recently-used CLOSED breaker is evicted; when every breaker is open — a full-fleet blackout — new
    sources share the overflow breaker rather than growing the table."""

    OVERFLOW = "__overflow__"

    def __init__(self, *, max_sources: int = 256, clock=time.monotonic,
                 **breaker_kw):
        if max_sources < 1:
            raise ValueError("breaker registry: max_sources must be >= 1")
        self.max_sources = int(max_sources)
        self._clock = clock
        self._kw = breaker_kw
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    def _label_for(self, source_id: str, n: int) -> str:
        # one bounded, readable label per breaker slot: the basename
        # tail of the id (paths dominate), truncated, uniquified by slot
        tail = source_id.rsplit("/", 1)[-1][:64]
        return f"{tail}#{n}"

    def breaker_for(self, source_id: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(source_id)
            if b is not None:
                return b
            if len(self._breakers) >= self.max_sources:
                victim = next(
                    (
                        k
                        for k, v in self._breakers.items()
                        if v.state == _CLOSED and k != self.OVERFLOW
                    ),
                    None,
                )
                if victim is not None:
                    ev = self._breakers.pop(victim)
                    _metrics.set_gauge("io_breaker_state", 0, source=ev._label)
                else:
                    source_id = self.OVERFLOW
                    b = self._breakers.get(source_id)
                    if b is not None:
                        return b
            b = CircuitBreaker(
                source_id,
                clock=self._clock,
                label=self._label_for(source_id, len(self._breakers)),
                **self._kw,
            )
            self._breakers[source_id] = b
            return b

    def states(self) -> dict:
        """{source_id: state} right now (tests/diagnostics)."""
        with self._lock:
            items = list(self._breakers.items())
        return {k: b.state for k, b in items}

    def reset(self) -> None:
        """Drop every breaker (tests, chaos-harness teardown)."""
        with self._lock:
            breakers = list(self._breakers.values())
            self._breakers.clear()
        for b in breakers:
            _metrics.set_gauge("io_breaker_state", 0, source=b._label)


_default_registry: BreakerRegistry | None = None
_default_registry_lock = threading.Lock()


def breaker_registry() -> BreakerRegistry:
    """The process-wide breaker registry (shared by every BreakerSource
    that wasn't handed an explicit breaker — reader, dataset and daemon
    reads of one blacked-out file all trip ONE breaker)."""
    global _default_registry
    with _default_registry_lock:
        if _default_registry is None:
            _default_registry = BreakerRegistry()
        return _default_registry


class BreakerSource(ByteSource):
    """A ByteSource gated by a CircuitBreaker.

    Each read asks the breaker first (typed fast-fail while open), then
    reports the outcome. ValueError (caller bugs: negative ranges) and the
    breaker's own fast-fail never count as source failures; everything
    else — OSError, short-read SourceError, a nested retry ladder's
    exhaustion — does."""

    def __init__(self, inner: ByteSource, breaker: CircuitBreaker | None = None,
                 *, registry: BreakerRegistry | None = None):
        self.inner = inner
        if breaker is None:
            reg = registry if registry is not None else breaker_registry()
            breaker = reg.breaker_for(inner.source_id)
        self.breaker = breaker

    @property
    def source_id(self) -> str:
        return self.inner.source_id

    def generation(self):
        gen = getattr(self.inner, "generation", None)
        return gen() if gen is not None else None

    def size(self) -> int:
        return self.inner.size()

    def read_at(self, offset: int, n: int) -> bytes:
        self.breaker.before_read()
        try:
            buf = self.inner.read_at(offset, n)
        except ValueError:
            # caller bug, not source health — but a claimed half-open
            # probe slot must be released or the breaker latches
            self.breaker.abort_probe()
            raise
        except Exception:
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        return buf

    def read_ranges(self, ranges) -> list:
        # per-range accounting: one blacked-out range trips the breaker at
        # the same cadence batched and unbatched readers observe
        return [self.read_at(off, n) for off, n in ranges]

    def close(self) -> None:
        self.inner.close()


# -- the resilience policy open_source applies ---------------------------------


@dataclass
class ResilienceConfig:
    """What open_source wraps every concrete source with. All-off by
    default (the wrap is the identity). `chaos_wrapper` is the innermost
    layer — the chaos harness injects its scheduled FlakySource THERE, so
    the breaker/retry/hedge stack under test sits above the faults exactly
    as it would above a faulty transport."""

    breaker: bool = False
    breaker_kw: dict = field(default_factory=dict)
    retry: bool = False
    retry_kw: dict = field(default_factory=dict)
    hedge: bool = False
    hedge_kw: dict = field(default_factory=dict)
    chaos_wrapper: object = None  # fn(ByteSource) -> ByteSource, innermost
    registry: BreakerRegistry | None = None

    @property
    def active(self) -> bool:
        return bool(
            self.breaker or self.retry or self.hedge or self.chaos_wrapper
        )


_config = ResilienceConfig()
_config_lock = threading.Lock()


def configure_resilience(config: ResilienceConfig | None) -> ResilienceConfig:
    """Install the process-wide resilience policy (None resets to all-off).
    Returns the PREVIOUS config so scoped users (chaos harness, tests)
    can restore it."""
    global _config
    with _config_lock:
        prev = _config
        cfg = config if config is not None else ResilienceConfig()
        if cfg.breaker and cfg.registry is None and cfg.breaker_kw:
            # non-default breaker knobs need their own registry (the shared
            # one was built with defaults and its breakers are keyed, not
            # parameterized, per source)
            cfg.registry = BreakerRegistry(**cfg.breaker_kw)
        _config = cfg
        return prev


def resilience_config() -> ResilienceConfig:
    with _config_lock:
        return _config


def wrap_resilient(source: ByteSource) -> ByteSource:
    """Apply the installed policy to a freshly opened concrete source:
    chaos (innermost) -> breaker -> retry -> hedge (outermost). With the
    default all-off policy this returns `source` unchanged. The breaker
    sits UNDER retry so the ladder counts raw faults and the typed
    breaker_open fast-fail is terminal to it; the hedge sits on TOP so a
    duplicate read carries its own full retry ladder."""
    cfg = resilience_config()
    if not cfg.active:
        return source
    if cfg.chaos_wrapper is not None:
        source = cfg.chaos_wrapper(source)
    if cfg.breaker:
        source = BreakerSource(source, registry=cfg.registry)
    if cfg.retry:
        source = RetryingSource(source, **cfg.retry_kw)
    if cfg.hedge:
        source = HedgedSource(source, **cfg.hedge_kw)
    return source
