"""parquet_tpu.lake — the write-path table layer (Iceberg-lite).

Streaming ingest (serve /v1/append -> IngestWriter), background
compaction (Compactor, pqt-compact lane), and the atomic snapshot
manifest (LakeManifest) that makes concurrent append/scan/compact
race-free: every reader pins ONE generation, every writer publishes by
a single rename. See lake/manifest.py for the layout and crash story.

The port's copy of parquet_tpu.lake; its counts are in lake_counts().
"""

from .compactor import CompactionResult, Compactor, pruned_ratio
from .counts import lake_counts, reset_lake_counts
from .ingest import IngestWriter, rows_from_payload
from .manifest import (
    FileEntry,
    LakeError,
    LakeManifest,
    LakeTable,
    Snapshot,
    is_lake_table,
    manifest_ref_root,
)

__all__ = [
    "CompactionResult",
    "Compactor",
    "FileEntry",
    "IngestWriter",
    "LakeError",
    "LakeManifest",
    "LakeTable",
    "Snapshot",
    "is_lake_table",
    "lake_counts",
    "manifest_ref_root",
    "pruned_ratio",
    "reset_lake_counts",
    "rows_from_payload",
]
