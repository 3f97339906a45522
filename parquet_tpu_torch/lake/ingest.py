"""Streaming ingest: row batches -> size-bounded files -> one generation
per flush.

The write path mirrors the read path's two wire formats (serve/protocol's
FORMATS): jsonl (one JSON object per line) and arrow-ipc (an Arrow IPC
stream, parsed by the port's own reader, core/arrow_ipc.py).
rows_from_payload() decodes either into the plain row dicts
FileWriter.write_rows ingests.

IngestWriter buffers appended rows in memory up to `flush_bytes` of
estimated payload, then flushes: rows are (optionally) sorted by the
table's sort key, encoded into ONE data/ingest-*.parquet through the
parallel EncodePipeline (FileWriter(parallel=...) on the pqt-encode
pool), and the manifest commits generation N+1 referencing it. The sink
contract makes the data file atomic and the manifest commit makes it
visible — a crash mid-flush loses only the un-acked buffer, never a
committed generation. Thread-safe: the daemon's handler threads append
concurrently under one lock (encoding happens inside the lock too — the
flush IS the serialization point that gives each flush one generation).

The port's copy of parquet_tpu.lake.ingest. Its counts are lake_counts() (lake_append_rows_total, lake_append_bytes_total,
lake_flushes_total), beside the lake_flush_seconds histogram.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

from ..core.writer import FileWriter
from ..utils import metrics as _metrics
from .counts import count as _count
from .manifest import FileEntry, LakeError, LakeTable, Snapshot

__all__ = ["rows_from_payload", "IngestWriter"]

# data-file names must be unique across every writer THIS process ever
# creates, not per-writer: a retained generation may still reference a
# name the current snapshot dropped (compaction), and the atomic sink
# would happily replace those bytes — breaking time-travel identity.
# pid handles other processes; this counter handles this one.
_FILE_SEQ = itertools.count(1)

_JSONL_TYPES = ("application/x-ndjson", "application/json")
_ARROW_TYPES = ("application/vnd.apache.arrow.stream",)


def rows_from_payload(body: bytes, content_type: str) -> list:
    """Decode one append body into row dicts, by declared content type.
    Raises LakeError(code="unsupported_format") for an unknown type and
    LakeError(code="bad_payload") for a body that does not parse."""
    ct = (content_type or "").partition(";")[0].strip().lower()
    if ct in _JSONL_TYPES or ct == "":
        rows = []
        for ln, line in enumerate(body.splitlines(), 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError as e:
                raise LakeError(
                    f"append: jsonl line {ln} does not parse: {e}",
                    code="bad_payload",
                ) from None
            if not isinstance(row, dict):
                raise LakeError(
                    f"append: jsonl line {ln} is not an object "
                    f"(got {type(row).__name__})", code="bad_payload",
                )
            rows.append(row)
        return rows
    if ct in _ARROW_TYPES:
        from ..core.arrow_ipc import ArrowInvalid, open_stream

        try:
            with open_stream(body) as reader:
                table = reader.read_all()
            return table.to_pylist()
        except (ArrowInvalid, OSError, ValueError) as e:
            raise LakeError(
                f"append: arrow-ipc stream does not parse: {e}",
                code="bad_payload",
            ) from None
    raise LakeError(
        f"append: unsupported content type {content_type!r} (expected "
        f"{_JSONL_TYPES[0]} or {_ARROW_TYPES[0]})", code="unsupported_format",
    )


def _row_cost(row: dict) -> int:
    """Cheap upper-ish estimate of a row's encoded footprint, for the
    flush threshold only (exact sizes come from the committed file)."""
    cost = 8
    for v in row.values():
        if isinstance(v, (bytes, str)):
            cost += len(v) + 8
        elif isinstance(v, (list, tuple, dict)):
            cost += 16 * (len(v) + 1)
        else:
            cost += 8
    return cost


class IngestWriter:
    """The append buffer of one lake table (one per daemon)."""

    def __init__(
        self,
        table: LakeTable,
        *,
        flush_bytes: int = 4 << 20,
        codec: str = "snappy",
        row_group_size: int = 1 << 16,
        parallel=True,
        clock=time.time,
    ):
        if flush_bytes < 1:
            raise ValueError("ingest: flush_bytes must be >= 1")
        self.table = table
        self.flush_bytes = int(flush_bytes)
        self.codec = codec
        self.row_group_size = int(row_group_size)
        self.parallel = parallel
        self._clock = clock
        self._lock = threading.Lock()
        self._rows: list = []
        self._buffered = 0
        self._closed = False
        self.appended_rows = 0
        self.flushes = 0

    @property
    def buffered_rows(self) -> int:
        return len(self._rows)

    def append(self, rows, *, flush: bool = False) -> dict:
        """Buffer `rows`; flush when asked or when the buffer crosses the
        size bound. Returns the ack body: rows taken, buffered backlog,
        and the generation the rows are durable under (None = buffered
        only — not yet committed)."""
        rows = list(rows)
        with self._lock:
            if self._closed:
                raise LakeError("ingest: writer is closed", code="closed")
            self._rows.extend(rows)
            cost = sum(_row_cost(r) for r in rows)
            self._buffered += cost
            self.appended_rows += len(rows)
            _count("lake_append_rows_total", len(rows))
            _count("lake_append_bytes_total", cost)
            snap = None
            if self._rows and (flush or self._buffered >= self.flush_bytes):
                snap = self._flush_locked()
            return {
                "rows": len(rows),
                "buffered_rows": len(self._rows),
                "flushed": snap is not None,
                "generation": (
                    snap.generation
                    if snap is not None
                    else self.table.manifest.current_generation() or None
                ),
            }

    def flush(self):
        """Commit the buffer as one file + one generation; None if empty."""
        with self._lock:
            if self._closed:
                raise LakeError("ingest: writer is closed", code="closed")
            if not self._rows:
                return None
            return self._flush_locked()

    def _flush_locked(self) -> Snapshot:
        t0 = time.perf_counter()
        rows, self._rows = self._rows, []
        self._buffered = 0
        key = self.table.sort_key
        if key is not None:
            # sort-keyed flushes: every committed file carries tight
            # min/max key stats, so even pre-compaction scans prune
            rows.sort(key=lambda r: (r.get(key) is None, r.get(key)))
        rel = os.path.join(
            "data", f"ingest-{os.getpid()}-{next(_FILE_SEQ):06d}.parquet"
        )
        path = self.table.manifest.data_path(rel)
        self.table.manifest.ensure_dirs()
        writer = FileWriter(
            path,
            self.table.schema,
            codec=self.codec,
            row_group_size=self.row_group_size,
            parallel=self.parallel,
            sorting_columns=[key] if key is not None else None,
            key_value_metadata={"parquet_tpu.lake": "ingest"},
        )
        try:
            writer.write_rows(rows)
            writer.close()
        except BaseException:
            writer.abort()
            # the buffer is gone but nothing was committed: surface the
            # failure to the caller, who still owns the rows it sent
            raise
        nbytes = os.path.getsize(path)
        min_key = max_key = None
        if key is not None:
            keyed = [r.get(key) for r in rows if r.get(key) is not None]
            if keyed:
                min_key, max_key = keyed[0], keyed[-1]
        snap = self.table.manifest.commit(
            add=[FileEntry(rel, len(rows), nbytes, min_key, max_key)],
            sort_key=key,
        )
        self.flushes += 1
        _count("lake_flushes_total")
        _metrics.observe("lake_flush_seconds", time.perf_counter() - t0)
        return snap

    def close(self):
        """Flush the tail and refuse further appends. Returns the final
        snapshot (None when nothing was buffered)."""
        with self._lock:
            if self._closed:
                return None
            snap = self._flush_locked() if self._rows else None
            self._closed = True
            return snap
