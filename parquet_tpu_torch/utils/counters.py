"""A process-wide store of labelled counts, one per layer (io, lake, serve).

A count is keyed as the reference's metrics registry keys a sample,
name{label="value",...}: labels sorted by name, each value escaped as the
Prometheus text format escapes it (backslash, double quote, newline)."""

from __future__ import annotations

import threading

__all__ = ["LabelledCounts", "key"]


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def key(name: str, labels: dict) -> str:
    """The count key of `name` with its labels (sorted, escaped)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class LabelledCounts:
    """Counts under their keys, behind one lock."""

    def __init__(self):
        self._counts: dict = {}
        self._lock = threading.Lock()

    def count(self, name: str, n: int = 1, **labels) -> None:
        """Add n to the count `name` (with its labels)."""
        k = key(name, labels)
        with self._lock:
            self._counts[k] = self._counts.get(k, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
