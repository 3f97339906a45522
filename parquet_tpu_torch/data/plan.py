"""Scan planning for the streaming dataset: files -> sharded unit order.

The port of parquet_tpu/data/plan.py. Pure bookkeeping, apart from the
prefetch and decode machinery of dataset.py:

  * a ScanPlan is built from footers only (FileReader.open_metadata: no
    data page is read), one work unit per (file, row group) with the row
    count the footer promises;
  * `filters` prune units at plan time through the reader's statistics and
    bloom pruning: excluded row groups never enter the plan;
  * `epoch_order(epoch)` derives each epoch's visit order from (seed,
    epoch) alone, then stripes it over `shard_count` slots, so every unit
    is visited by exactly one (process, worker) per epoch and a mid-epoch
    resume or another host recomputes the same order.

A corrupt file (unreadable footer) follows the dataset's on_error policy:
"raise" propagates, otherwise the file's units are dropped from the plan
(listed in ScanPlan.skipped_files, counted as files_skipped in
dataset_counts()). http(s):// URLs pass through as they are: their footers
parse through io.remote.HttpSource, validated in `footer_cache` by (size,
ETag). A lake table directory, or one of its manifest files
(table/_lake/gen-N.json), expands to one pinned generation's file list
(lake/manifest.py).
"""

from __future__ import annotations

import glob as _glob
import hashlib
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ..core.reader import PARQUET_ERRORS, FileReader

__all__ = ["NotPortedError", "Unit", "ScanPlan", "expand_paths", "build_plan"]


class NotPortedError(ValueError):
    """An option of the reference's dataset layer whose layer the port does
    not carry; the message names it."""


def not_ported(what: str, layer: str) -> NotPortedError:
    return NotPortedError(f"dataset: {what} needs {layer}, which is not ported")


class Unit(NamedTuple):
    """One schedulable work unit: a single row group of a single file."""

    file_index: int  # index into ScanPlan.files
    path: str
    row_group: int
    num_rows: int


def _expand_lake_ref(s: str):
    """A lake-table reference expands to ONE pinned snapshot's file list:
    a table directory (holding _lake/CURRENT) pins the current
    generation, a manifest file path (table/_lake/gen-N.json) pins
    generation N — time travel for scans. Returns None when `s` is not a
    lake reference; the file list preserves MANIFEST order (it is a
    consistent snapshot, not a directory listing to be re-sorted —
    callers that sort sort deterministically anyway)."""
    from ..lake.manifest import is_lake_table, manifest_ref_root

    ref = manifest_ref_root(s)
    if ref is not None:
        root, gen = ref
    elif os.path.isdir(s) and is_lake_table(s):
        root, gen = s, None
    else:
        return None
    from ..lake.manifest import LakeManifest

    return LakeManifest(root).open_snapshot(gen).paths(
        os.path.realpath(root)
    )


def expand_paths(paths_or_glob) -> list[str]:
    """The dataset's input spec as a sorted file list. A string (or Path)
    is a glob pattern when it holds magic characters, else one file; a list
    or tuple passes through, and an http(s):// URL passes through as it is
    (remote objects neither glob nor stat: a missing one raises at its
    open). A lake-table directory or manifest file expands to that
    snapshot's file list (see _expand_lake_ref): every scan plans against
    exactly one generation. Sorted, because glob order depends on the file
    system and the shard and shuffle math needs every process to see the
    same file indices."""
    if isinstance(paths_or_glob, (str, Path)):
        s = str(paths_or_glob)
        if s.startswith(("http://", "https://")):
            return [s]
        lake = _expand_lake_ref(s)
        if lake is not None:
            return lake
        if _glob.has_magic(s):
            hits = _glob.glob(s)
            if not hits:
                raise FileNotFoundError(f"dataset: glob {s!r} matched no files")
            return sorted(hits)
        if not os.path.exists(s):
            raise FileNotFoundError(f"dataset: no such file {s!r}")
        return [s]
    out: list[str] = []
    for p in paths_or_glob:
        lake = _expand_lake_ref(str(p))
        out.extend(lake if lake is not None else [str(p)])
    if not out:
        raise ValueError("dataset: empty path list")
    return sorted(out)


class ScanPlan:
    """The global (pre-shard) work list of a dataset scan."""

    def __init__(
        self,
        files: list[str],
        metas: list,
        units: list[Unit],
        skipped_files: list | None = None,
        *,
        units_total: int | None = None,
        units_pruned_stats: int = 0,
        units_pruned_bloom: int = 0,
    ):
        self.files = files
        # each file's FileMetaData (None for a skipped file): per-unit
        # readers open with metadata=, so each footer parses exactly once
        self.metas = metas
        self.units = units
        # (path, error) of every file on_error dropped
        self.skipped_files = list(skipped_files or [])
        # the pruning summary: row groups the files held and how many the
        # filters excluded by statistics and by bloom filters
        # (units_total - pruned_stats - pruned_bloom == len(units))
        self.units_total = len(units) if units_total is None else units_total
        self.units_pruned_stats = units_pruned_stats
        self.units_pruned_bloom = units_pruned_bloom

    @property
    def num_units(self) -> int:
        return len(self.units)

    def pruning_summary(self) -> dict:
        return {
            "units_total": self.units_total,
            "units_pruned_stats": self.units_pruned_stats,
            "units_pruned_bloom": self.units_pruned_bloom,
            "units_admitted": len(self.units),
        }

    @property
    def total_rows(self) -> int:
        return sum(u.num_rows for u in self.units)

    def fingerprint(self) -> dict:
        """What a checkpoint pins: the digest covers every unit's (file
        basename, row group, row count), so a renamed, reordered or
        re-rowed file set is refused even when the totals match, while a
        moved directory is not (contents are not hashed)."""
        h = hashlib.sha1()
        for u in self.units:
            h.update(f"{os.path.basename(u.path)}#{u.row_group}#{u.num_rows};".encode())
        return {
            "files": len(self.files),
            "units": self.num_units,
            "rows": self.total_rows,
            "digest": h.hexdigest(),
        }

    def epoch_order(
        self,
        epoch: int,
        *,
        seed: int = 0,
        shuffle: bool = False,
        shard_index: int = 0,
        shard_count: int = 1,
    ) -> list[int]:
        """This shard's unit visit order for `epoch` (indices into .units):
        a permutation that is a pure function of (seed, epoch) over the
        global unit list, of which each shard takes its stride slice, so the
        shards partition the epoch exactly. Without shuffle the order is the
        file-major plan order."""
        if not 0 <= shard_index < shard_count:
            raise ValueError(
                f"dataset: shard_index {shard_index} out of range for shard_count {shard_count}"
            )
        n = self.num_units
        if shuffle:
            order = np.random.default_rng([seed, epoch]).permutation(n)
        else:
            order = np.arange(n)
        return [int(i) for i in order[shard_index::shard_count]]


def build_plan(
    paths_or_glob,
    *,
    filters=None,
    on_error: str = "raise",
    footer_cache=None,
    block_cache=None,
) -> ScanPlan:
    """Parse every file's footer and lay out the unit list. `filters` (the
    (column, op, value) DNF convention of FileReader) prune row groups by
    statistics and bloom filters; the summary rides the returned plan. The
    filter is checked once against the first readable schema: a misspelled
    column is a configuration error. With on_error != "raise" a file whose
    footer (or pruning) fails is skipped instead of ending the scan.
    `footer_cache` (io.cache.FooterCache) parses each footer once a file
    generation; `block_cache` (io.cache.BlockCache) serves the bloom pages
    the pruning reads."""
    from .dataset import _bump

    files = expand_paths(paths_or_glob)
    metas: list = []
    units: list[Unit] = []
    skipped: list[tuple[str, str]] = []
    units_total = pruned_stats = pruned_bloom = 0
    filters_checked = filters is None
    for fi, path in enumerate(files):
        try:
            meta = FileReader.open_metadata(path, footer_cache=footer_cache)
        except PARQUET_ERRORS + (OSError,) as e:
            if on_error == "raise":
                raise
            _bump("files_skipped")
            metas.append(None)
            skipped.append((path, f"{type(e).__name__}: {e}"))
            continue
        if not filters_checked:
            # outside the skip policy: a misspelled filter column would
            # otherwise skip every file and plan an empty dataset
            from ..core.filter import normalize_dnf
            from ..core.schema import Schema

            normalize_dnf(Schema.from_thrift(meta.schema), filters)
            filters_checked = True
        groups = meta.row_groups or []
        # per-file tallies commit only after the file planned cleanly
        f_stats = f_bloom = 0
        try:
            if filters is not None:
                # bloom pages are read from the file: a live reader, which
                # touches no device (hence device="cpu" whatever the scan's)
                with FileReader(
                    path, metadata=meta, device="cpu", block_cache=block_cache
                ) as r:
                    admitted, f_stats, f_bloom = r.prune_row_groups_counted(filters)
            else:
                admitted = range(len(groups))
        except PARQUET_ERRORS + (OSError,) as e:
            # OSError: the file vanished (or lost read permission) between
            # the glob and the open: the same policy as corruption
            if on_error == "raise":
                raise
            _bump("files_skipped")
            metas.append(None)
            skipped.append((path, f"{type(e).__name__}: {e}"))
            continue
        metas.append(meta)
        units_total += len(groups)
        pruned_stats += f_stats
        pruned_bloom += f_bloom
        for gi in admitted:
            units.append(Unit(fi, path, gi, int(groups[gi].num_rows or 0)))
    return ScanPlan(
        files,
        metas,
        units,
        skipped,
        units_total=units_total,
        units_pruned_stats=pruned_stats,
        units_pruned_bloom=pruned_bloom,
    )
