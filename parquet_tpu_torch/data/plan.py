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

Cut, each raising NotPortedError (a ValueError) that names the layer: lake
table references (the lake layer), http(s) sources and `footer_cache=` /
`block_cache=` (the io layer), and `on_error` other than "raise" (the
reader's corruption policies).
"""

from __future__ import annotations

import glob as _glob
import hashlib
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ..core.reader import FileReader

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


def _refuse_unported_ref(s: str) -> None:
    """Lake table references and remote URLs, which the reference expands
    or opens through layers the port does not carry."""
    if s.startswith(("http://", "https://")):
        raise not_ported(f"the remote source {s!r}", "the io layer (io/source.py)")
    if os.path.isdir(s) and os.path.isdir(os.path.join(s, "_lake")) or (
        f"{os.sep}_lake{os.sep}" in s and s.endswith(".json")
    ):
        raise not_ported(f"the lake reference {s!r}", "the lake layer (lake/manifest.py)")


def expand_paths(paths_or_glob) -> list[str]:
    """The dataset's input spec as a sorted file list. A string (or Path)
    is a glob pattern when it holds magic characters, else one file; a list
    or tuple passes through. Sorted, because glob order depends on the file
    system and the shard and shuffle math needs every process to see the
    same file indices."""
    if isinstance(paths_or_glob, (str, Path)):
        s = str(paths_or_glob)
        _refuse_unported_ref(s)
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
        _refuse_unported_ref(str(p))
        out.append(str(p))
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
        *,
        units_total: int | None = None,
        units_pruned_stats: int = 0,
        units_pruned_bloom: int = 0,
    ):
        self.files = files
        # each file's FileMetaData: per-unit readers open with metadata=, so
        # each footer parses exactly once
        self.metas = metas
        self.units = units
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
    filter is checked once against the first schema: a misspelled column is
    a configuration error."""
    if on_error != "raise":
        raise not_ported(f"on_error={on_error!r}", "the reader's corruption policies")
    if footer_cache is not None:
        raise not_ported("footer_cache=", "the io layer (io/cache.py)")
    if block_cache is not None:
        raise not_ported("block_cache=", "the io layer (io/cache.py)")
    files = expand_paths(paths_or_glob)
    metas: list = []
    units: list[Unit] = []
    units_total = pruned_stats = pruned_bloom = 0
    filters_checked = filters is None
    for fi, path in enumerate(files):
        meta = FileReader.open_metadata(path)
        if not filters_checked:
            from ..core.filter import normalize_dnf
            from ..core.schema import Schema

            normalize_dnf(Schema.from_thrift(meta.schema), filters)
            filters_checked = True
        groups = meta.row_groups or []
        f_stats = f_bloom = 0
        if filters is not None:
            # bloom pages are read from the file: a live reader, which
            # touches no device (hence device="cpu" whatever the scan's)
            with FileReader(path, metadata=meta, device="cpu") as r:
                admitted, f_stats, f_bloom = r.prune_row_groups_counted(filters)
        else:
            admitted = range(len(groups))
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
        units_total=units_total,
        units_pruned_stats=pruned_stats,
        units_pruned_bloom=pruned_bloom,
    )
