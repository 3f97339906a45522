"""The histograms and levels the dataset's SLO controller steers on.

Since the port carries the metrics registry, this is a name for it:
`Instruments` is utils.metrics.MetricsRegistry (set / get / observe /
hist_stats, the reference's bucket bounds) and INSTRUMENTS is the process
registry, so each observation is kept once and shows on /metrics.

The dataset writes into it: dataset_wait_seconds (each consumer wait),
pool_queue_wait_seconds{pool="pqt-data"} (each decode task's
submit-to-start wait, through obs.pool.instrumented_submit); an attached
controller sets dataset_prefetch_target. A controller built with its own
store (`registry=`) reads and writes only that one. The violations a
controller counts are a count of the dataset's (dataset_counts()).
"""

from __future__ import annotations

from .metrics import _DEFAULT_BUCKETS as DEFAULT_BUCKETS
from .metrics import REGISTRY as INSTRUMENTS
from .metrics import MetricsRegistry as Instruments

__all__ = ["DEFAULT_BUCKETS", "Instruments", "INSTRUMENTS"]
