"""The lake layer's plain counters: the reference's metric families under
their names (lake_manifest_commits_total, lake_files_unlinked_total,
lake_orphans_reaped_total, lake_append_rows_total, lake_append_bytes_total,
lake_flushes_total, lake_compactions_total, lake_compact_files_total,
lake_compact_rows_total) and, for the compactor loop's event-log hooks,
lake_compact_skipped_total{reason=...} and lake_compact_errors_total. A
labelled count is keyed as io.counts keys it (utils.counters): name{label="value"}. Each count is a sample of the
process registry (utils.metrics); lake_counts() is its view since the
last reset."""

from __future__ import annotations

from ..utils.counters import LabelledCounts

__all__ = ["count", "lake_counts", "reset_lake_counts"]

_COUNTS = LabelledCounts()


def count(name: str, n: int = 1, **labels) -> None:
    """Add n to the count `name` (with its labels)."""
    _COUNTS.count(name, n, **labels)


def lake_counts() -> dict:
    """A snapshot of every lake count (see the module docstring)."""
    return _COUNTS.snapshot()


def reset_lake_counts() -> None:
    _COUNTS.reset()
