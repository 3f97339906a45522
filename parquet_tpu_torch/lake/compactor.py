"""Background compaction: fold small ingest files into sort-keyed row
groups, one manifest generation per fold.

Every flush commits one small file; a few hundred flushes later the table
is a pile of row groups whose key ranges all overlap, and a filtered scan
prunes almost nothing. compact_once() picks the small files of the
current snapshot, rewrites them as ONE file — a k-way merge by the
table's sort key into full-size row groups (each carrying tight min/max
stats and a sorting_columns declaration), or a verbatim merge_files fold
when the table has no key — and commits the swap as one generation.

Crash safety is inherited, not bolted on: the rewrite lands through the
atomic sink, the manifest commit is the only publish, and the replaced
files stay on disk until retention drops every generation referencing
them (manifest._prune_retention). A crash at ANY point between rewrite
and commit loses nothing — the orphan rewrite is reaped by
reap_orphans() on a later cycle.

The worker thread is its own lane ("pqt-compact") and is
clock-injectable: tests drive compact_once() directly or tick a fake
clock.

The before/after `pruned_ratio` recorded on each CompactionResult is the
measurable point of the exercise: the fraction of row-group units a
sort-key point probe (at the merged run's median key) prunes at plan
time, before vs after the rewrite.

The port's copy of parquet_tpu.lake.compactor. The rewrite reads rows on
the host (FileReader(device="cpu"): iter_rows touches no device). Its
counts are lake_counts() (lake_compactions_total, lake_compact_files_total,
lake_compact_rows_total, lake_compact_skipped_total{reason=},
lake_compact_errors_total), beside the lake_compact_seconds histogram and
the reference's log events (lake_compaction, lake_compact_skipped,
lake_compact_error).
"""

from __future__ import annotations

import heapq
import os
import threading
import time

from ..core.merge import merge_files
from ..core.reader import FileReader
from ..core.writer import FileWriter
from ..obs import log as _obslog
from ..utils import metrics as _metrics
from .counts import count as _count
from .ingest import _FILE_SEQ
from .manifest import FileEntry, LakeError, LakeTable

__all__ = ["CompactionResult", "Compactor", "pruned_ratio"]


def pruned_ratio(paths, filters) -> float:
    """Fraction of row-group units plan-time pruning excludes for
    `filters` over `paths` (0.0 when there are no units)."""
    from ..data.plan import build_plan

    plan = build_plan(list(paths), filters=filters)
    if not plan.units_total:
        return 0.0
    pruned = plan.units_pruned_stats + plan.units_pruned_bloom
    return pruned / plan.units_total


class CompactionResult:
    """What one fold did, for operators and the bench trend store."""

    __slots__ = (
        "generation", "files_in", "rows", "bytes_in", "bytes_out",
        "pruned_ratio_before", "pruned_ratio_after", "seconds",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class Compactor:
    """One table's background folder. start()/stop() run the loop on a
    pqt-compact thread; compact_once() is the whole unit of work."""

    def __init__(
        self,
        table: LakeTable,
        *,
        min_files: int = 2,
        max_files: int = 32,
        small_file_bytes: int = 64 << 20,
        row_group_size: int = 1 << 16,
        codec: str = "snappy",
        interval_s: float = 5.0,
        reap_grace_s: float = 300.0,
        clock=time.monotonic,
    ):
        if min_files < 2:
            raise ValueError("compactor: min_files must be >= 2")
        if max_files < min_files:
            raise ValueError("compactor: max_files must be >= min_files")
        self.table = table
        self.min_files = int(min_files)
        self.max_files = int(max_files)
        self.small_file_bytes = int(small_file_bytes)
        self.row_group_size = int(row_group_size)
        self.codec = codec
        self.interval_s = float(interval_s)
        self.reap_grace_s = float(reap_grace_s)
        self._clock = clock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.compactions = 0
        self.last_result: CompactionResult | None = None

    # -- candidate selection ---------------------------------------------------

    def _candidates(self, snap):
        small = [
            f for f in snap.files
            if f.bytes < self.small_file_bytes and f.rows > 0
        ]
        if len(small) < self.min_files:
            return []
        return small[: self.max_files]

    # -- one fold --------------------------------------------------------------

    def compact_once(self):
        """Fold the current snapshot's small files into one; None when
        there is nothing worth folding."""
        manifest = self.table.manifest
        snap = manifest.open_snapshot()
        picked = self._candidates(snap)
        if not picked:
            return None
        t0 = time.perf_counter()
        key = self.table.sort_key
        in_paths = [manifest.data_path(f.path) for f in picked]
        rel = os.path.join(
            "data", f"compact-{os.getpid()}-{next(_FILE_SEQ):06d}.parquet"
        )
        out_path = manifest.data_path(rel)
        manifest.ensure_dirs()
        probe = None
        if key is not None:
            rows, min_key, max_key, probe = self._sorted_rewrite(
                in_paths, out_path, key
            )
        else:
            # no sort key: a verbatim row-group fold (no re-encode) still
            # collapses per-file overhead and footer count
            merge_files(
                out_path, in_paths,
                key_value_metadata={"parquet_tpu.lake": "compact"},
            )
            rows = sum(f.rows for f in picked)
            min_key = max_key = None
        before = after = None
        if probe is not None:
            filters = [(key, "==", probe)]
            try:
                before = pruned_ratio(in_paths, filters)
                after = pruned_ratio([out_path], filters)
            except (ValueError, OSError):
                before = after = None
        # THE swap: one generation replaces the inputs with the fold. The
        # inputs stay on disk for every retained generation that still
        # names them; retention (not this thread) unlinks them later.
        gen = manifest.commit(
            add=[FileEntry(rel, rows, os.path.getsize(out_path),
                           min_key, max_key)],
            remove=[f.path for f in picked],
        )
        dt = time.perf_counter() - t0
        result = CompactionResult(
            generation=gen.generation,
            files_in=len(picked),
            rows=rows,
            bytes_in=sum(f.bytes for f in picked),
            bytes_out=os.path.getsize(out_path),
            pruned_ratio_before=before,
            pruned_ratio_after=after,
            seconds=dt,
        )
        self.compactions += 1
        self.last_result = result
        _count("lake_compactions_total")
        _count("lake_compact_files_total", len(picked))
        _count("lake_compact_rows_total", rows)
        _metrics.observe("lake_compact_seconds", dt)
        _obslog.log_event(
            "lake_compaction",
            generation=gen.generation,
            files_in=len(picked),
            rows=rows,
            pruned_ratio_before=before,
            pruned_ratio_after=after,
        )
        return result

    def _sorted_rewrite(self, in_paths, out_path, key):
        """k-way merge every input's rows by `key` into one sorted file.
        Inputs are themselves key-sorted (ingest flushes sort), so the
        heap holds one row per input — the memory bound is files, not
        rows. Returns (rows, min_key, max_key, median probe key)."""

        def keyed(path):
            # a host row read: no device is touched, whatever the caller's
            with FileReader(path, device="cpu") as r:
                for row in r.iter_rows():
                    v = row.get(key)
                    yield ((v is None, v), row)

        writer = FileWriter(
            out_path,
            self.table.schema,
            codec=self.codec,
            row_group_size=self.row_group_size,
            sorting_columns=[key],
            key_value_metadata={"parquet_tpu.lake": "compact"},
        )
        rows = 0
        min_key = max_key = None
        keys_seen: list = []
        try:
            merged = heapq.merge(
                *(keyed(p) for p in in_paths), key=lambda kr: kr[0]
            )
            for k, row in merged:
                writer.write_row(row)
                rows += 1
                if not k[0]:
                    if min_key is None:
                        min_key = k[1]
                    max_key = k[1]
                    keys_seen.append(k[1])
            writer.close()
        except BaseException:
            writer.abort()
            raise
        probe = keys_seen[len(keys_seen) // 2] if keys_seen else None
        return rows, min_key, max_key, probe

    # -- the background loop ---------------------------------------------------

    def run_cycle(self) -> None:
        """One loop body: fold if worthwhile, then reap crash debris."""
        try:
            self.compact_once()
        except LakeError as e:
            # commit_conflict = an append won the race; next cycle re-plans
            _count(
                "lake_compact_skipped_total",
                reason=getattr(e, "code", "lake_error"),
            )
            _obslog.log_event(
                "lake_compact_skipped", level="warning",
                reason=getattr(e, "code", "lake_error"), detail=str(e),
            )
        self.table.manifest.reap_orphans(grace_s=self.reap_grace_s)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_cycle()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                _count("lake_compact_errors_total")
                _obslog.log_event(
                    "lake_compact_error", level="error",
                    error=f"{type(e).__name__}: {e}",
                )

    def start(self) -> "Compactor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="pqt-compact", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
