"""Latency-aware IO auto-tuning: pick coalesce/readahead knobs per source.

The planner's coalesce gap answers one question — below how many wasted
gap bytes is merging two ranges into one read cheaper than paying a second
request? The answer is the transport's bandwidth-delay product: on a local
NVMe pread (~50us, ~GB/s) the break-even sits around the 64 KiB default;
on a ~25ms-RTT object store the same math says *megabytes*, and the fixed
local default issues dozens of tiny range GETs where one fat read would
do. A fixed knob (`coalesce_gap=`) cannot serve both; this module closes
the loop:

  IOTuner       per-transport EWMAs of observed read behavior, fed from
                fetch_ranges (the one choke point every planner-batched
                read already passes): per-RUN latency (seconds / runs in
                the batch) and achieved bandwidth (bytes / seconds).
                `params_for()` turns them into an IOParams — coalesce gap
                and readahead budget — by the bandwidth-delay product,
                clamped between the LOCAL profile (the 64 KiB default,
                modest readahead) and the REMOTE ceiling (MiB-scale gap,
                deep readahead).
  profile_key   the aggregation key: transports, not files. Every
                LocalFileSource collapses to "local", every HttpSource to
                its "http(s)://host:port" — a thousand-shard corpus on one
                store trains ONE profile, and a fresh file on a known-slow
                store starts tuned.

Consumers opt in with the string "auto" where they would pass a gap:
`FileReader(coalesce_gap="auto")`, `ParquetDataset(io_autotune=True)`,
`ServeConfig(io_autotune=True)`. Resolution happens inside fetch_ranges /
Readahead, so the first read of an unknown transport uses the LOCAL
profile (64 KiB — correct for the common case and merely suboptimal for a
remote one) and every read after it is tuned by what the transport
actually did. Below `remote_floor_s` of per-run latency the tuner returns
the LOCAL profile EXACTLY: observation noise on a fast local disk must
never perturb the default byte-for-byte behavior tests pin.

Observation is always on (one lock + three float updates per BATCHED
read, not per range); only knob RESOLUTION is opt-in. The gauges
io_autotune_gap_bytes{profile=} / io_autotune_latency_ms{profile=} mirror
each profile's current verdict for operators; `io_tuner().stats()` is the
debug-vars form.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

from ..utils import metrics as _metrics

__all__ = [
    "IOParams",
    "IOTuner",
    "io_tuner",
    "profile_key",
    "LOCAL_GAP",
    "LOCAL_READAHEAD",
    "MAX_GAP",
    "MAX_READAHEAD",
]

# the LOCAL profile: the planner's defaults, what an untrained (or provably
# fast) transport resolves to — auto-tuning must be a no-op until the
# observed latency says otherwise
LOCAL_GAP = 64 << 10
LOCAL_READAHEAD = 8 << 20

# the REMOTE ceiling: one merged read never grows past MAX_GAP of pure
# gap waste, and the readahead budget recommendation stays bounded
MAX_GAP = 8 << 20
MAX_READAHEAD = 128 << 20

# assume this floor bandwidth until a transport demonstrates one: the
# very first high-latency observation should already coalesce harder
# instead of waiting for a bandwidth estimate to converge
_FLOOR_BANDWIDTH = 8 << 20  # 8 MiB/s


class IOParams(NamedTuple):
    """One transport's tuned knobs (what `params_for` returns)."""

    coalesce_gap: int
    readahead_bytes: int
    latency_s: float  # the EWMA per-run latency behind the verdict
    bandwidth_bps: float  # the EWMA achieved bandwidth behind the verdict
    observations: int

    @property
    def remote(self) -> bool:
        """Whether the transport tuned AWAY from the local profile."""
        return self.coalesce_gap > LOCAL_GAP


def profile_key(source_id_or_path: str) -> str:
    """Collapse a source_id (or a path/URL) to its TRANSPORT key.

    "http:https://host:9000/bucket/obj#etag:123" -> "https://host:9000"
    "http://host/file.parquet"                   -> "http://host"
    "file:/data/x.parquet:41:9:17"               -> "local"
    anything else (mem:, custom sources)         -> "local"

    Files on one store share latency physics, not names — profiling per
    transport is what lets shard #2 start with shard #1's tuning."""
    s = str(source_id_or_path)
    # an HttpSource source_id prefixes the URL with "http:" — strip the
    # tag, not a plain URL's scheme
    if s.startswith(("http:http://", "http:https://")):
        s = s[5:]
    if s.startswith(("http://", "https://")):
        scheme, _, rest = s.partition("://")
        host = rest.split("/", 1)[0].split("#", 1)[0]
        return f"{scheme}://{host}" if host else "local"
    return "local"


class _Profile:
    __slots__ = ("latency_s", "bandwidth_bps", "observations")

    def __init__(self):
        self.latency_s = 0.0
        self.bandwidth_bps = 0.0
        self.observations = 0


class IOTuner:
    """EWMA-per-transport observer + knob resolver (thread-safe).

    alpha            EWMA weight of the newest observation
    remote_floor_s   per-run latency below which a transport IS the local
                     profile (noise guard: a loaded CI box must not
                     re-tune local preads)
    min_observations observations before a profile may deviate from local
    max_profiles     bound on distinct transport keys (LRU evicted)
    """

    def __init__(
        self,
        *,
        alpha: float = 0.25,
        remote_floor_s: float = 0.002,
        min_observations: int = 3,
        readahead_depth: int = 16,
        max_profiles: int = 64,
    ):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("autotune: alpha must be in (0, 1]")
        if min_observations < 1:
            raise ValueError("autotune: min_observations must be >= 1")
        self.alpha = float(alpha)
        self.remote_floor_s = float(remote_floor_s)
        self.min_observations = int(min_observations)
        self.readahead_depth = int(readahead_depth)
        self.max_profiles = int(max_profiles)
        self._lock = threading.Lock()
        self._profiles: OrderedDict[str, _Profile] = OrderedDict()

    # -- observation (fed by fetch_ranges, always on) --------------------------

    def observe(
        self, source_id: str, nbytes: int, seconds: float, runs: int = 1
    ) -> None:
        """Record one batched read: `runs` transport requests moving
        `nbytes` in `seconds` of wall. Degenerate observations (zero
        bytes, non-positive wall) are dropped, not averaged."""
        if nbytes <= 0 or seconds <= 0 or runs <= 0:
            return
        key = profile_key(source_id)
        per_run = seconds / runs
        bw = nbytes / seconds
        with self._lock:
            p = self._profiles.get(key)
            if p is None:
                p = _Profile()
                self._profiles[key] = p
                while len(self._profiles) > self.max_profiles:
                    self._profiles.popitem(last=False)
            else:
                self._profiles.move_to_end(key)
            if p.observations == 0:
                p.latency_s, p.bandwidth_bps = per_run, bw
            else:
                a = self.alpha
                p.latency_s += a * (per_run - p.latency_s)
                p.bandwidth_bps += a * (bw - p.bandwidth_bps)
            p.observations += 1
            lat_ms, params = self._params_locked(key, p)
        # gauges outside the tuner lock (the registry has its own)
        _metrics.set_gauge("io_autotune_gap_bytes", params.coalesce_gap, profile=key)
        _metrics.set_gauge("io_autotune_latency_ms", lat_ms, profile=key)

    # -- resolution ------------------------------------------------------------

    def _params_locked(self, key: str, p: _Profile | None):
        if (
            p is None
            or p.observations < self.min_observations
            or p.latency_s < self.remote_floor_s
        ):
            lat = 0.0 if p is None else p.latency_s
            bw = 0.0 if p is None else p.bandwidth_bps
            n = 0 if p is None else p.observations
            return round(lat * 1e3, 3), IOParams(
                LOCAL_GAP, LOCAL_READAHEAD, lat, bw, n
            )
        # the bandwidth-delay product: the bytes the transport could have
        # delivered in the time one more request costs — below that, gap
        # bytes are cheaper than a second round trip
        bdp = p.latency_s * max(p.bandwidth_bps, _FLOOR_BANDWIDTH)
        gap = int(min(MAX_GAP, max(LOCAL_GAP, bdp)))
        readahead = int(
            min(
                MAX_READAHEAD,
                max(LOCAL_READAHEAD, bdp * self.readahead_depth),
            )
        )
        return round(p.latency_s * 1e3, 3), IOParams(
            gap, readahead, p.latency_s, p.bandwidth_bps, p.observations
        )

    def params_for(self, source_id_or_path: str) -> IOParams:
        """The tuned knobs for a source/path/URL (LOCAL profile when the
        transport is unknown, under-observed, or provably fast)."""
        key = profile_key(source_id_or_path)
        with self._lock:
            return self._params_locked(key, self._profiles.get(key))[1]

    def gap_for(self, source_id_or_path: str) -> int:
        return self.params_for(source_id_or_path).coalesce_gap

    def readahead_for(self, source_id_or_path: str) -> int:
        return self.params_for(source_id_or_path).readahead_bytes

    # -- introspection ---------------------------------------------------------

    def stats(self) -> dict:
        """Per-transport snapshot for /v1/debug/vars and tests."""
        with self._lock:
            keys = list(self._profiles)
        out = {}
        for key in keys:
            with self._lock:
                p = self._profiles.get(key)
                if p is None:
                    continue
                lat_ms, params = self._params_locked(key, p)
            out[key] = {
                "latency_ms": lat_ms,
                "bandwidth_mb_s": round(params.bandwidth_bps / 1e6, 3),
                "observations": params.observations,
                "coalesce_gap": params.coalesce_gap,
                "readahead_bytes": params.readahead_bytes,
                "remote": params.remote,
            }
        return out

    def reset(self) -> None:
        """Forget every profile (tests, bench runs that must start cold)."""
        with self._lock:
            self._profiles.clear()


_tuner: IOTuner | None = None
_tuner_lock = threading.Lock()


def io_tuner() -> IOTuner:
    """The process-wide tuner every fetch_ranges call feeds — reader,
    dataset workers and the serve daemon all train (and consult) ONE set
    of transport profiles."""
    global _tuner
    with _tuner_lock:
        if _tuner is None:
            _tuner = IOTuner()
        return _tuner
