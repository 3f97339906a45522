"""A small instrument store: histograms and last-value levels.

The dataset's SLO controller (data/controller.py) steers on windowed
deltas of histograms, which plain counts (utils.counters) cannot give: the
reference reads them from its process metrics registry (utils.metrics,
which the port does not carry). This is the part of that registry the
controller uses that counts cannot hold, with its API and its bucket
bounds:

  set(name, value, **labels)   set a level (the reference's gauges)
  get(name, **labels)          a level (0 when never set)
  observe(name, v, **labels)   one histogram observation
  hist_stats(name, **labels)   {"count", "sum", "buckets",
                                "bucket_counts"}: running totals, each
                               bucket counting the observations at or
                               below its bound

The bounds decide which waits the controller counts as violations of its
SLO (the largest bound at or below it), so they are the reference's.

INSTRUMENTS is the process-wide store. The dataset writes into it:
dataset_wait_seconds (each consumer wait), pool_queue_wait_seconds
{pool="pqt-data"} (each decode task's submit-to-start wait); an attached
controller sets dataset_prefetch_target. A controller built with its own
store (`registry=`) reads and writes only that one. The violations a
controller counts are a count of the dataset's (dataset_counts()).
"""

from __future__ import annotations

import threading

__all__ = ["DEFAULT_BUCKETS", "Instruments", "INSTRUMENTS"]

DEFAULT_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


class _Hist:
    __slots__ = ("count", "total", "bucket_counts")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.bucket_counts = [0] * len(DEFAULT_BUCKETS)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        for i, le in enumerate(DEFAULT_BUCKETS):
            if v <= le:
                self.bucket_counts[i] += 1


def _key(name: str, labels: dict) -> tuple:
    return name, tuple(sorted(labels.items()))


class Instruments:
    """Levels and histograms behind one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict = {}
        self._hists: dict = {}

    def set(self, name: str, value, **labels) -> None:
        with self._lock:
            self._values[_key(name, labels)] = value

    def get(self, name: str, **labels):
        with self._lock:
            return self._values.get(_key(name, labels), 0)

    def observe(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Hist()
            h.observe(value)

    def hist_stats(self, name: str, **labels) -> dict:
        """One histogram's running totals (zeros when never observed)."""
        with self._lock:
            h = self._hists.get(_key(name, labels))
            count, total, counts = (
                (0, 0.0, [0] * len(DEFAULT_BUCKETS))
                if h is None
                else (h.count, h.total, list(h.bucket_counts))
            )
        return {
            "count": count,
            "sum": total,
            "buckets": DEFAULT_BUCKETS,
            "bucket_counts": counts,
        }


INSTRUMENTS = Instruments()
