"""SLO burn-rate health engine: a typed, windowed verdict for routers.

`/healthz` so far answers "is the process up and not draining" — a useful
liveness bit, but the ROADMAP's multi-host serve needs the ROUTING
question: "is this replica healthy ENOUGH", where "enough" is an error
budget being consumed at a survivable rate, not a human eyeballing
`/metrics`. This module is the Google-SRE multi-window burn-rate model
over the serve daemon's own request outcomes:

  SLIs        availability — the share of finished requests that did NOT
              fail server-side (5xx; client errors and client-gone 499s
              spend nobody's budget), against `SLOObjective.availability`
              (default 99.9%). Optionally latency — the share of requests
              at/under `p99_ms`, against an implied 99% target (a "p99
              objective" IS "at most 1% of requests slower than the bar").

  burn rate   error_fraction / error_budget per window: burn 1.0 spends
              the budget exactly at sustainable speed, 14.4 empties a
              30-day budget in 50 hours — the classic page threshold.

  windows     fast 5m + slow 1h, BOTH required to fire: the fast window
              alone flaps on a single bad minute, the slow window alone
              pages an hour late. Implemented as a bounded ring of
              10-second buckets (requests / bad / slow / latency
              histogram), so memory is fixed and a fake clock replays any
              schedule deterministically.

  verdict     "burning"  fast AND slow burn >= `page_burn` (either SLI)
              "warn"     fast burn >= `warn_burn` on either SLI
              "ok"       otherwise

The daemon feeds `record()` from the same `_finish` path that observes
serve_request_seconds, evaluates on demand (`GET /v1/debug/slo` returns
the full window math), and folds the verdict into `/healthz` as a
`degraded` status — still HTTP 200, deliberately distinct from
`draining`'s 503: a degraded replica can still serve (a router may
deprioritize it), a draining one must not be routed to at all.

Gauges (refreshed at every evaluate()): slo_burn_rate{sli=,window=},
slo_error_budget_remaining{sli=} (windowed, slow window), and
slo_verdict (0 ok / 1 warn / 2 burning).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..utils import metrics as _metrics

__all__ = ["SLOObjective", "BurnRateEngine", "VERDICT_LEVELS"]

VERDICT_LEVELS = {"ok": 0, "warn": 1, "burning": 2}

# the reported-p99 estimate buckets (seconds): serve_request_seconds'
# bounds, reused so the debug body and the exposition agree on shape
_LAT_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

# the latency SLI's implied objective: "p99 <= bar" == "at most 1% of
# requests over the bar" — a 1% bad-event budget
_LATENCY_BUDGET = 0.01


@dataclass(frozen=True)
class SLOObjective:
    """What this replica promises. availability in (0, 1); p99_ms None
    disables the latency SLI entirely."""

    availability: float = 0.999
    p99_ms: float | None = None
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    page_burn: float = 14.4  # both windows at/over this -> burning
    warn_burn: float = 1.0  # fast window at/over this -> warn

    def __post_init__(self):
        if not 0.0 < self.availability < 1.0:
            raise ValueError(
                "slo: availability must be in (0, 1), got "
                f"{self.availability!r}"
            )
        if self.p99_ms is not None and self.p99_ms <= 0:
            raise ValueError("slo: p99_ms must be positive (None disables)")
        if not 0 < self.fast_window_s <= self.slow_window_s:
            raise ValueError(
                "slo: need 0 < fast_window_s <= slow_window_s"
            )
        if self.page_burn < self.warn_burn or self.warn_burn <= 0:
            raise ValueError("slo: need 0 < warn_burn <= page_burn")


class _Bucket:
    """One 10-second aggregate: counts only, fixed size."""

    __slots__ = ("start", "requests", "bad", "slow", "lat_counts")

    def __init__(self, start: float):
        self.start = start
        self.requests = 0
        self.bad = 0  # 5xx server failures (availability burn)
        self.slow = 0  # over the p99 bar (latency burn)
        self.lat_counts = [0] * (len(_LAT_BUCKETS) + 1)  # +Inf tail


class BurnRateEngine:
    """Bounded-memory multi-window burn-rate evaluation (see module
    docstring). `clock` is injectable (time.monotonic by default) so
    tests replay fault schedules without sleeping; `bucket_s` trades
    window-edge resolution for ring length."""

    def __init__(
        self,
        objective: SLOObjective | None = None,
        *,
        clock=time.monotonic,
        bucket_s: float = 10.0,
    ):
        if bucket_s <= 0:
            raise ValueError("slo: bucket_s must be positive")
        self.objective = objective if objective is not None else SLOObjective()
        self._clock = clock
        self.bucket_s = float(bucket_s)
        self._lock = threading.Lock()
        self._buckets: list[_Bucket] = []
        # ring length: the slow window plus one bucket of slack
        self._max_buckets = int(self.objective.slow_window_s / bucket_s) + 1

    # -- ingest ----------------------------------------------------------------

    def record(self, status, seconds: float) -> None:
        """One finished request: its HTTP status (int, or "error"/"ok"
        strings from library records) and wall seconds. Client errors
        (4xx) and client-gone (499) spend no budget — the replica did its
        job; 5xx and "error" burn availability."""
        bad = (
            status == "error"
            if not isinstance(status, int)
            else status >= 500
        )
        p99_ms = self.objective.p99_ms
        slow = p99_ms is not None and seconds * 1e3 > p99_ms
        now = self._clock()
        with self._lock:
            b = self._bucket_locked(now)
            b.requests += 1
            if bad:
                b.bad += 1
            if slow:
                b.slow += 1
            slot = len(_LAT_BUCKETS)
            for i, le in enumerate(_LAT_BUCKETS):
                if seconds <= le:
                    slot = i
                    break
            b.lat_counts[slot] += 1

    def _bucket_locked(self, now: float) -> _Bucket:
        start = now - (now % self.bucket_s)
        if not self._buckets or self._buckets[-1].start < start:
            self._buckets.append(_Bucket(start))
            if len(self._buckets) > self._max_buckets:
                del self._buckets[: len(self._buckets) - self._max_buckets]
        return self._buckets[-1]

    # -- evaluate --------------------------------------------------------------

    def _window_locked(self, now: float, window_s: float) -> dict:
        cutoff = now - window_s
        requests = bad = slow = 0
        lat = [0] * (len(_LAT_BUCKETS) + 1)
        for b in self._buckets:
            # a bucket is IN the window when any part of it is: edge
            # buckets count whole — the 10 s quantization the ring buys
            if b.start + self.bucket_s <= cutoff:
                continue
            requests += b.requests
            bad += b.bad
            slow += b.slow
            for i, c in enumerate(b.lat_counts):
                lat[i] += c
        return {"requests": requests, "bad": bad, "slow": slow, "lat": lat}

    @staticmethod
    def _p99_estimate_ms(lat: list, requests: int) -> float | None:
        """Upper-bound p99 from the coarse latency histogram: the first
        bound whose cumulative count covers 99% (None with no data; the
        +Inf tail reports as the top finite bound — "over the scale")."""
        if not requests:
            return None
        want = 0.99 * requests
        acc = 0
        for i, c in enumerate(lat):
            acc += c
            if acc >= want:
                if i < len(_LAT_BUCKETS):
                    return _LAT_BUCKETS[i] * 1e3
                return _LAT_BUCKETS[-1] * 1e3
        return _LAT_BUCKETS[-1] * 1e3

    def evaluate(self) -> dict:
        """The full verdict + window math (the /v1/debug/slo body).
        Refreshes the slo_* gauges as a side effect, so any scrape after
        an evaluate sees the current burn rates."""
        obj = self.objective
        now = self._clock()
        with self._lock:
            fast = self._window_locked(now, obj.fast_window_s)
            slow = self._window_locked(now, obj.slow_window_s)

        def burn(win: dict, kind: str) -> float:
            if not win["requests"]:
                return 0.0
            if kind == "availability":
                frac = win["bad"] / win["requests"]
                budget = 1.0 - obj.availability
            else:
                frac = win["slow"] / win["requests"]
                budget = _LATENCY_BUDGET
            return frac / budget

        slis = {"availability": (burn(fast, "availability"),
                                 burn(slow, "availability"))}
        if obj.p99_ms is not None:
            slis["latency"] = (burn(fast, "latency"), burn(slow, "latency"))

        verdict = "ok"
        for fast_burn, slow_burn in slis.values():
            if fast_burn >= obj.page_burn and slow_burn >= obj.page_burn:
                verdict = "burning"
                break
            if fast_burn >= obj.warn_burn:
                verdict = "warn"

        windows = {}
        for label, win in (("5m", fast), ("1h", slow)):
            entry = {
                "seconds": (
                    obj.fast_window_s if label == "5m" else obj.slow_window_s
                ),
                "requests": win["requests"],
                "errors": win["bad"],
                "error_rate": (
                    round(win["bad"] / win["requests"], 6)
                    if win["requests"]
                    else 0.0
                ),
                "p99_ms_estimate": self._p99_estimate_ms(
                    win["lat"], win["requests"]
                ),
            }
            if obj.p99_ms is not None:
                entry["slow_requests"] = win["slow"]
            windows[label] = entry

        body = {
            "verdict": verdict,
            "objective": {
                "availability": obj.availability,
                "p99_ms": obj.p99_ms,
                "page_burn": obj.page_burn,
                "warn_burn": obj.warn_burn,
            },
            "windows": windows,
            "burn_rates": {
                sli: {"5m": round(f, 4), "1h": round(s, 4)}
                for sli, (f, s) in slis.items()
            },
        }

        # gauge mirror: burn per (sli, window), windowed budget remaining
        # (slow window — the budget a router would reason about), verdict
        for sli, (f, s) in slis.items():
            _metrics.set_gauge("slo_burn_rate", round(f, 4), sli=sli,
                               window="5m")
            _metrics.set_gauge("slo_burn_rate", round(s, 4), sli=sli,
                               window="1h")
            budget = (
                1.0 - obj.availability
                if sli == "availability"
                else _LATENCY_BUDGET
            )
            win = slow
            used = (
                (win["bad"] if sli == "availability" else win["slow"])
                / win["requests"]
                if win["requests"]
                else 0.0
            )
            _metrics.set_gauge(
                "slo_error_budget_remaining",
                round(max(0.0, 1.0 - used / budget), 4),
                sli=sli,
            )
        _metrics.set_gauge("slo_verdict", VERDICT_LEVELS[verdict])
        return body
