"""The io layer's plain counters, shared by the sources, the planner, the
caches and the reader's quarantine: the reference's metric families under
their names (io_bytes_read_total, io_read_calls_total,
io_retries_total{reason=...}, io_cache_hits_total / _misses_total /
_evictions_total, io_footer_cache_*, io_readahead_fetched_total /
_dropped_total / _errors_total, io_coalesce_*, io_http_*, io_multirange_*,
io_resigns_total, io_sign_requests_total{method=...},
io_hedges_total{outcome=...}, cache_tier_*) and the reader's
chunks_quarantined, chunks_nulled and row_groups_quarantined. A labelled
count is keyed as the reference's registry keys it: name{label="value"}
(utils.counters); the reader's three are the registry's
events_total{event=...}, as the reference's trace.bump() keeps them.
Every count is a sample of the process registry (utils.metrics), which
also holds the layer's gauges (cache bytes, breaker state, autotune
verdicts); io_counts() is the view of the counts since the last reset."""

from __future__ import annotations

from ..utils.counters import LabelledCounts, event_alias

__all__ = ["count", "io_counts", "reset_io_counts"]

_COUNTS = LabelledCounts(
    alias=event_alias(("chunks_quarantined", "chunks_nulled", "row_groups_quarantined"))
)


def count(name: str, n: int = 1, **labels) -> None:
    """Add n to the count `name` (with its labels)."""
    _COUNTS.count(name, n, **labels)


def io_counts() -> dict:
    """A snapshot of every io count (see the module docstring)."""
    return _COUNTS.snapshot()


def reset_io_counts() -> None:
    _COUNTS.reset()
