"""Admission control: who gets to scan, for how long, at what volume.

A serving daemon dies three ways: unbounded queueing (every request
admitted, none finishing), one tenant starving the rest, and requests
that never end. This module bounds all three BEFORE the executor spends
a thread on them:

  * global in-flight cap (`max_inflight`) — request N+1 gets a typed 429
    `queue_full` body, never an unbounded queue;
  * per-tenant concurrency + a scanned-byte token bucket keyed on the
    `X-Tenant` header — budgets refill continuously at
    `tenant_budget_bytes / budget_window_s`, charged with the PLAN
    estimate so an over-budget scan is refused before reading data
    (429 `tenant_over_budget`, with a Retry-After hint);
  * per-request deadline (default/max configurable, `X-Timeout-Ms` or
    body `timeout_ms` override) — cooperative cancellation points in the
    executor check it between units and every few thousand rows, so an
    expired request frees its slot instead of scanning to the end;
  * brownout — when the pqt-serve pool's windowed mean queue wait crosses
    `brownout_wait_s` (or its queue depth crosses `brownout_depth`), NEW
    requests shed with a typed 503 `brownout` + Retry-After BEFORE they
    join the pile-up. Shedding early is the point: without it every
    admitted request queues until the deadline sweeps them all into 504s
    at once — clients get no signal to back off until the worst moment.
    Sheds count serve_shed_total{reason="queue_wait"};
  * graceful drain — `begin_drain()` (the SIGTERM path) rejects NEW
    requests with a typed 503 `draining` while in-flight ones run to
    completion; `wait_drained()` tells the server when the last one left.

Everything here is clock-injectable (tests pin time) and updates the
always-on registry: the `serve_queue_depth` gauge tracks in-flight
requests; each typed rejection is logged as a rate-limited
admission_rejected:<code> event (obs.log) and counted
admission_rejected_total{code=} (serve.counts.serve_counts()); brownout
reads the pqt-serve pool's pool_queue_wait_seconds histogram and
pool_queue_depth gauge back out of the process registry (windowed
deltas) through serve.counts.serve_pool_stats(), or calls the `pool_stats`
callable a test passes instead.
"""

from __future__ import annotations

import threading
import time

from ..obs.log import log_event as _log_event
from ..utils import metrics as _metrics
from . import counts as _counts
from .protocol import ServeError


def _rejected(code: str, tenant: str) -> None:
    # every typed admission rejection, counted and logged by its code. The
    # code rides the EVENT KEY so the limiter buckets per code: a
    # queue_full flood cannot absorb the one draining line at SIGTERM time
    # (codes are code-controlled, so the key set stays bounded)
    _counts.count("admission_rejected_total", code=code)
    _log_event(f"admission_rejected:{code}", level="warning", code=code, tenant=tenant)

__all__ = ["AdmissionController", "Deadline", "Ticket"]


class Deadline:
    """A cooperative per-request deadline. `check()` raises the typed 504
    at every cancellation point; `remaining()` bounds blocking waits so a
    stuck unit can never hold a request past its budget."""

    __slots__ = ("_expires", "_clock")

    def __init__(self, timeout_s: float | None, clock=time.monotonic):
        self._clock = clock
        self._expires = None if timeout_s is None else clock() + float(timeout_s)

    def remaining(self) -> float | None:
        if self._expires is None:
            return None
        return self._expires - self._clock()

    def expired(self) -> bool:
        return self._expires is not None and self._clock() >= self._expires

    def check(self) -> None:
        if self.expired():
            raise ServeError(
                504, "deadline_exceeded",
                "request deadline exceeded (raise timeout_ms / X-Timeout-Ms)",
            )


class _TenantState:
    __slots__ = ("concurrent", "tokens", "last_refill")

    def __init__(self, tokens: float, now: float):
        self.concurrent = 0
        self.tokens = tokens
        self.last_refill = now


class Ticket:
    """One admitted request's slot; a context manager so the slot releases
    on EVERY exit path (stream done, stream aborted, handler error)."""

    def __init__(self, controller: "AdmissionController", tenant: str):
        self._controller = controller
        self.tenant = tenant
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._controller._release(self.tenant)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class AdmissionController:
    # tenants past this many distinct X-Tenant values share one overflow
    # bucket: the header is CLIENT-controlled, so per-tenant state (and the
    # serve_requests_total{tenant=} label set) must stay bounded or random
    # header values become a remote memory-growth vector
    OVERFLOW_TENANT = "__overflow__"

    def __init__(
        self,
        *,
        max_inflight: int = 32,
        tenant_concurrent: int = 8,
        tenant_budget_bytes: int | None = None,
        budget_window_s: float = 60.0,
        default_timeout_s: float | None = 30.0,
        max_timeout_s: float = 300.0,
        max_tenants: int = 1024,
        brownout_wait_s: float | None = None,
        brownout_depth: int | None = None,
        brownout_window_s: float = 2.0,
        clock=time.monotonic,
        pool_stats=None,
    ):
        if max_inflight <= 0:
            raise ValueError("admission: max_inflight must be positive")
        if tenant_concurrent <= 0:
            raise ValueError("admission: tenant_concurrent must be positive")
        if budget_window_s <= 0:
            raise ValueError("admission: budget_window_s must be positive")
        if max_tenants <= 0:
            raise ValueError("admission: max_tenants must be positive")
        if brownout_wait_s is not None and brownout_wait_s <= 0:
            raise ValueError("admission: brownout_wait_s must be positive")
        if brownout_depth is not None and brownout_depth <= 0:
            raise ValueError("admission: brownout_depth must be positive")
        if brownout_window_s <= 0:
            raise ValueError("admission: brownout_window_s must be positive")
        self.max_inflight = int(max_inflight)
        self.tenant_concurrent = int(tenant_concurrent)
        self.tenant_budget_bytes = tenant_budget_bytes
        self.budget_window_s = float(budget_window_s)
        self.default_timeout_s = default_timeout_s
        self.max_timeout_s = float(max_timeout_s)
        self.max_tenants = int(max_tenants)
        self.brownout_wait_s = brownout_wait_s
        self.brownout_depth = brownout_depth
        self.brownout_window_s = float(brownout_window_s)
        # () -> {"queued", "wait_count", "wait_sum", ...} of the pqt-serve
        # pool, read from the process registry
        self._pool_stats = (
            pool_stats if pool_stats is not None else _counts.serve_pool_stats
        )
        # windowed brownout state: last pqt-serve queue-wait totals + when
        # they were read, and the verdict cached between windows
        self._bw_last: tuple[float, int, float] | None = None  # (t, count, sum)
        self._bw_hot = False
        self._clock = clock
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._inflight = 0
        self._draining = False
        self._tenants: dict[str, _TenantState] = {}
        # names ever handed out as accounting/label keys — NEVER shrinks
        # (serve_counts() keys can't be evicted), so it must saturate:
        # past max_tenants distinct names, everything new is the overflow
        # bucket for the life of the process
        self._label_names: set[str] = set()

    def resolve_tenant(self, raw) -> str:
        """The bounded accounting key for a client-supplied X-Tenant value:
        sanitized/truncated, and collapsed to the shared overflow bucket
        once max_tenants distinct names have been seen — on ANY endpoint,
        admitted or not, so a /v1/plan or rejection flood cannot grow the
        serve_requests_total{tenant=} label set (or daemon memory) either."""
        tenant = (raw or "default").strip()[:64] or "default"
        with self._lock:
            if tenant in self._label_names:
                return tenant
            if len(self._label_names) < self.max_tenants:
                self._label_names.add(tenant)
                return tenant
            return self.OVERFLOW_TENANT

    # -- deadlines -------------------------------------------------------------

    def deadline_for(self, timeout_ms) -> Deadline:
        """The request's deadline: the caller's timeout_ms (header or body)
        clamped to max_timeout_s, else the configured default."""
        if timeout_ms is None:
            seconds = self.default_timeout_s
        else:
            try:
                seconds = int(timeout_ms) / 1e3
            except (TypeError, ValueError):
                raise ServeError(
                    400, "bad_request",
                    f"X-Timeout-Ms must be an integer, got {timeout_ms!r}",
                ) from None
            if seconds <= 0:
                raise ServeError(
                    400, "bad_request", "X-Timeout-Ms must be positive"
                )
        if seconds is not None:
            seconds = min(seconds, self.max_timeout_s)
        return Deadline(seconds, clock=self._clock)

    # -- admit / release -------------------------------------------------------

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    # -- brownout --------------------------------------------------------------

    def _brownout_hot(self) -> bool:
        """Is the pqt-serve pool under brownout pressure right now?

        Evaluated at most once per brownout_window_s (the verdict is cached
        between windows — admissions must not pay a stats read each):
        hot when the windowed MEAN queue wait crosses brownout_wait_s, or
        the instantaneous queue depth crosses brownout_depth (the wedged-
        pool case, where no task starts so no new wait is ever observed).
        Called with self._lock held."""
        now = self._clock()
        if self._bw_last is None:
            h = self._pool_stats()
            self._bw_last = (now, h["wait_count"], h["wait_sum"])
            return False
        t0, c0, s0 = self._bw_last
        if now - t0 >= self.brownout_window_s:
            h = self._pool_stats()
            self._bw_last = (now, h["wait_count"], h["wait_sum"])
            d_count = h["wait_count"] - c0
            d_sum = h["wait_sum"] - s0
            mean = (d_sum / d_count) if d_count else 0.0
            self._bw_hot = (
                self.brownout_wait_s is not None
                and d_count > 0
                and mean > self.brownout_wait_s
            )
        if not self._bw_hot and self.brownout_depth is not None:
            depth = self._pool_stats()["queued"]
            if depth > self.brownout_depth:
                return True
        return self._bw_hot

    def admit(self, tenant: str) -> Ticket:
        """Claim a slot for `tenant` or raise the typed rejection."""
        try:
            with self._lock:
                if self._draining:
                    raise ServeError(
                        503, "draining",
                        "daemon is draining; retry another replica",
                    )
                if (
                    self.brownout_wait_s is not None
                    or self.brownout_depth is not None
                ) and self._brownout_hot():
                    _counts.count("serve_shed_total", reason="queue_wait")
                    raise ServeError(
                        503, "brownout",
                        "daemon is shedding load (scan queue wait over the "
                        "brownout threshold); retry after backoff",
                        retry_after_s=max(1, int(self.brownout_window_s)),
                    )
                if self._inflight >= self.max_inflight:
                    raise ServeError(
                        429, "queue_full",
                        f"daemon at max in-flight requests ({self.max_inflight})",
                        retry_after_s=1,
                    )
                tenant, st = self._tenant_state(tenant)
                if st.concurrent >= self.tenant_concurrent:
                    raise ServeError(
                        429, "tenant_concurrency",
                        f"tenant {tenant!r} at max concurrent requests "
                        f"({self.tenant_concurrent})",
                        retry_after_s=1,
                    )
                st.concurrent += 1
                self._inflight += 1
                _metrics.set_gauge("serve_queue_depth", self._inflight)
        except ServeError as e:
            _rejected(e.code, tenant)  # outside the lock: logging IO must
            raise  # never serialize admissions
        return Ticket(self, tenant)

    def _release(self, tenant: str) -> None:
        with self._lock:
            self._inflight -= 1
            _metrics.set_gauge("serve_queue_depth", self._inflight)
            st = self._tenants.get(tenant)
            if st is not None:
                st.concurrent -= 1
            if self._inflight == 0:
                self._drained.notify_all()

    # -- tenant byte budgets ---------------------------------------------------

    def _tenant_state(self, tenant: str) -> tuple[str, _TenantState]:
        """(key, state) for `tenant`, creating the state under the bounded
        table discipline: evict an idle tenant to make room, else collapse
        to the overflow bucket. Callers must key all later accounting on
        the RETURNED name (Ticket.tenant carries it)."""
        st = self._tenants.get(tenant)
        if st is None:
            if len(self._tenants) >= self.max_tenants:
                victim = next(
                    (
                        k
                        for k, s in self._tenants.items()
                        if s.concurrent == 0 and k != self.OVERFLOW_TENANT
                    ),
                    None,
                )
                if victim is not None:
                    del self._tenants[victim]
                else:
                    tenant = self.OVERFLOW_TENANT
                    st = self._tenants.get(tenant)
                    if st is not None:
                        return tenant, st
            cap = float(self.tenant_budget_bytes or 0)
            st = self._tenants[tenant] = _TenantState(cap, self._clock())
        return tenant, st

    def charge(self, tenant: str, nbytes: int) -> None:
        """Debit `nbytes` (the plan's estimate) from the tenant's bucket.

        Token bucket: capacity tenant_budget_bytes, continuous refill over
        budget_window_s. A request larger than the whole capacity is still
        admitted when the bucket is FULL (one oversized scan per window
        beats never serving it), driving the bucket to empty."""
        if self.tenant_budget_bytes is None:
            return
        cap = float(self.tenant_budget_bytes)
        with self._lock:
            tenant, st = self._tenant_state(tenant)
            now = self._clock()
            st.tokens = min(
                cap,
                st.tokens + (now - st.last_refill) * cap / self.budget_window_s,
            )
            st.last_refill = now
            if nbytes <= st.tokens:
                st.tokens -= nbytes
                return
            if st.tokens >= cap:  # full bucket: let the oversized scan through
                st.tokens = 0.0
                return
            deficit = nbytes - st.tokens
            retry = min(
                self.budget_window_s, deficit * self.budget_window_s / cap
            )
            err = ServeError(
                429, "tenant_over_budget",
                f"tenant {tenant!r} scanned-byte budget exhausted "
                f"(needs {nbytes:,} B, {int(st.tokens):,} B available)",
                retry_after_s=max(1, int(retry)),
            )
        _rejected(err.code, tenant)  # outside the lock (see admit)
        raise err

    # -- drain -----------------------------------------------------------------

    def begin_drain(self) -> None:
        """Stop admitting (the SIGTERM handler's first act). Idempotent;
        in-flight requests are unaffected."""
        with self._lock:
            self._draining = True
            if self._inflight == 0:
                self._drained.notify_all()

    def wait_drained(self, timeout: float | None = None) -> bool:
        """Block until every in-flight request released (True) or the
        timeout passed (False)."""
        with self._lock:
            if not self._draining:
                raise RuntimeError("admission: wait_drained before begin_drain")
            return self._drained.wait_for(
                lambda: self._inflight == 0, timeout=timeout
            )
