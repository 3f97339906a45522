"""parquet_tpu_torch.data: sharded, prefetching, checkpointable datasets.

The port of parquet_tpu/data: multi-file plans (plan.py: footer-only
planning, the shard and shuffle math) driven by a bounded
prefetch-and-rebatch pipeline (dataset.py) that delivers batches through
the dispatch thread's pinned uploads (device_put_pipelined), with the
elastic-SLO controller (controller.py) that moves its prefetch depth,
worker count and readahead budget.
"""

from .controller import AIMDController
from .dataset import DatasetIterator, ParquetDataset, dataset_counts, reset_dataset_counts
from .plan import NotPortedError, ScanPlan, Unit, build_plan, expand_paths

__all__ = [
    "AIMDController",
    "DatasetIterator",
    "NotPortedError",
    "ParquetDataset",
    "ScanPlan",
    "Unit",
    "build_plan",
    "dataset_counts",
    "expand_paths",
    "reset_dataset_counts",
]
