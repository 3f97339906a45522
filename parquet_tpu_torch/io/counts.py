"""The io layer's plain counters, shared by the sources, the planner, the
caches and the reader's quarantine: the reference's metric families under
their names (io_bytes_read_total, io_read_calls_total,
io_retries_total{reason=...}, io_cache_hits_total / _misses_total /
_evictions_total, io_footer_cache_*, io_readahead_fetched_total /
_dropped_total / _errors_total, io_coalesce_*, io_http_*, io_multirange_*,
io_resigns_total, io_sign_requests_total{method=...},
io_hedges_total{outcome=...}, cache_tier_*) and the reader's
chunks_quarantined, chunks_nulled and row_groups_quarantined. A labelled
count is keyed as the reference's registry keys it: name{label="value"}.
The reference's gauges (cache bytes, breaker state, autotune verdicts) are
not kept: the objects they mirror answer stats() themselves."""

from __future__ import annotations

import threading

__all__ = ["count", "io_counts", "reset_io_counts"]

_COUNTS: dict = {}
_LOCK = threading.Lock()


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def count(name: str, n: int = 1, **labels) -> None:
    """Add n to the count `name` (with its labels)."""
    key = _key(name, labels)
    with _LOCK:
        _COUNTS[key] = _COUNTS.get(key, 0) + n


def io_counts() -> dict:
    """A snapshot of every io count (see the module docstring)."""
    with _LOCK:
        return dict(_COUNTS)


def reset_io_counts() -> None:
    with _LOCK:
        _COUNTS.clear()
