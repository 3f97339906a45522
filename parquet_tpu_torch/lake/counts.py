"""The lake layer's plain counters: the reference's metric families under
their names (lake_manifest_commits_total, lake_files_unlinked_total,
lake_orphans_reaped_total, lake_append_rows_total, lake_append_bytes_total,
lake_flushes_total, lake_compactions_total, lake_compact_files_total,
lake_compact_rows_total) and, for the compactor loop's event-log hooks,
lake_compact_skipped_total{reason=...} and lake_compact_errors_total. A
labelled count is keyed as io.counts keys it: name{label="value"}."""

from __future__ import annotations

import threading

__all__ = ["count", "lake_counts", "reset_lake_counts"]

_COUNTS: dict = {}
_LOCK = threading.Lock()


def count(name: str, n: int = 1, **labels) -> None:
    """Add n to the count `name` (with its labels)."""
    if labels:
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        name = f"{name}{{{inner}}}"
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def lake_counts() -> dict:
    """A snapshot of every lake count (see the module docstring)."""
    with _LOCK:
        return dict(_COUNTS)


def reset_lake_counts() -> None:
    with _LOCK:
        _COUNTS.clear()
