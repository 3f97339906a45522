"""Row-group-level file merge: concatenate parquet files WITHOUT re-encoding.

A copy of parquet_tpu/core/merge.py. The compaction primitive (parquet-mr
ships it as `parquet-tools merge`): every input row group's chunk bytes
copy verbatim into the output, only the footer's offsets are rewritten. No decode, no re-compression - merging N files
costs one sequential read + write of their page bytes.

Schemas must match exactly (element-by-element). Statistics, encodings and
sorting_columns carry over untouched (they describe the values, which are
byte-identical); page indexes and bloom filters live OUTSIDE the chunk
byte ranges in their source files and are NOT carried - re-write the file
with `write_page_index=`/`bloom_filters=` if you need them on the merged
output.

Output goes through the ByteSink seam (sink/sink.py): a path gets the
atomic tmp+rename LocalFileSink, so a failed or interrupted merge/split
never leaves a torn output where the inputs' readers (or a compaction
daemon's glob) would pick it up; any ByteSink can be passed directly.
"""

from __future__ import annotations

from ..meta.file_meta import (
    MAGIC,
    ParquetFileError,
    read_file_metadata,
    serialize_footer,
)
from ..meta.parquet_types import FileMetaData, KeyValue
from ..sink.sink import open_sink
from .chunk import chunk_byte_range

__all__ = ["merge_files", "split_row_groups"]

_COPY_BLOCK = 8 << 20

def _copy_group(out, pos: int, f, rg, ordinal: int, src_label: str) -> int:
    """Copy one row group's chunk bytes verbatim from open input `f` to open
    output `out` at byte position `pos`, rewriting the group's footer
    offsets IN PLACE (callers pass a private RowGroup). Returns the new
    position. Shared by merge_files and split_row_groups so the two lanes
    can never diverge on offset handling."""
    first_new = None
    for cc in rg.columns or []:
        if cc.file_path:
            raise ParquetFileError(
                "parquet: merge/split does not support external column "
                f"chunks ({src_label!r})"
            )
        offset, total = chunk_byte_range(cc)
        delta = pos - offset
        f.seek(offset)
        remaining = total
        while remaining:
            block = f.read(min(remaining, _COPY_BLOCK))
            if not block:
                raise ParquetFileError(
                    f"parquet: merge/split input truncated ({src_label!r})"
                )
            out.write(block)
            remaining -= len(block)
        md = cc.meta_data
        for attr in (
            "data_page_offset", "dictionary_page_offset", "index_page_offset"
        ):
            v = getattr(md, attr)
            if v is not None:
                setattr(md, attr, v + delta)
        # regions outside the chunk range are not carried
        md.bloom_filter_offset = None
        md.bloom_filter_length = None
        cc.offset_index_offset = None
        cc.offset_index_length = None
        cc.column_index_offset = None
        cc.column_index_length = None
        if cc.file_offset:  # modern writers set 0: keep it
            cc.file_offset += delta
        if first_new is None:
            first_new = pos
        pos += total
    rg.file_offset = first_new
    rg.ordinal = ordinal
    return pos



def split_row_groups(in_path, out_pattern: str, groups_per_part: int = 1,
                     created_by: str | None = None) -> list:
    """Shard a file into parts of `groups_per_part` row groups each by
    copying chunk bytes VERBATIM (the converse of merge_files - no decode,
    no re-encoding). Returns the
    written part paths. `out_pattern` must contain %d."""
    if "%d" not in out_pattern:
        raise ParquetFileError("parquet: split pattern must contain %d")
    if groups_per_part < 1:
        raise ParquetFileError("parquet: groups_per_part must be >= 1")
    with open(in_path, "rb") as f:
        meta = read_file_metadata(f)
    n_groups = len(meta.row_groups or [])
    parts = []
    for part, lo in enumerate(range(0, n_groups, groups_per_part)):
        out = out_pattern % part
        _copy_groups(
            out, in_path, meta,
            range(lo, min(lo + groups_per_part, n_groups)),
            created_by or "parquet_tpu split",
        )
        parts.append(out)
    return parts


def _copy_groups(out_path, in_path, meta, group_indices, created_by) -> None:
    """One output file holding verbatim copies of the selected row groups.

    Deep-copies the footer structs it mutates (thrift round-trip) so the
    caller's metadata - shared across parts - stays untouched."""
    from ..meta.parquet_types import RowGroup

    import os

    st_in = os.stat(in_path)
    try:
        st_out = os.stat(out_path)
        if (st_out.st_dev, st_out.st_ino) == (st_in.st_dev, st_in.st_ino):
            raise ParquetFileError(
                f"parquet: split output {out_path!r} is the input"
            )
    except OSError:
        pass
    out_groups = []
    num_rows = 0
    out, owns = open_sink(out_path)
    try:
        with open(in_path, "rb") as f:
            out.write(MAGIC)
            pos = len(MAGIC)
            for gi in group_indices:
                rg = RowGroup.loads((meta.row_groups[gi]).dumps())  # private copy
                pos = _copy_group(out, pos, f, rg, len(out_groups), str(in_path))
                out_groups.append(rg)
                num_rows += rg.num_rows or 0
            out_meta = FileMetaData(
                version=2,
                schema=meta.schema,
                num_rows=num_rows,
                row_groups=out_groups,
                created_by=created_by,
                key_value_metadata=meta.key_value_metadata,
                column_orders=meta.column_orders,
            )
            out.write(serialize_footer(out_meta))
    except BaseException:
        out.abort()  # atomic sinks leave no partial part file
        raise
    if owns:
        out.close()  # commit
    else:
        out.flush()


def merge_files(out_path, in_paths, created_by: str | None = None,
                key_value_metadata: dict | None = None) -> FileMetaData:
    """Merge `in_paths` (order preserved) into `out_path` (a path, committed
    atomically, or any ByteSink) by copying row groups byte-for-byte.
    Returns the written FileMetaData."""
    if not in_paths:
        raise ParquetFileError("parquet: merge needs at least one input")
    import os

    out_key = None
    if isinstance(out_path, (str, os.PathLike)):
        try:
            out_id = os.stat(out_path)
            out_key = (out_id.st_dev, out_id.st_ino)
        except OSError:
            out_key = None  # output doesn't exist yet: cannot collide
    for p in in_paths:
        st = os.stat(p)
        if out_key is not None and (st.st_dev, st.st_ino) == out_key:
            raise ParquetFileError(
                f"parquet: merge output {out_path!r} is also an input "
                f"({p!r}) — opening it for write would destroy the source"
            )
    metas = []
    for p in in_paths:
        with open(p, "rb") as f:
            metas.append(read_file_metadata(f))
    schema = metas[0].schema
    for p, m in zip(in_paths[1:], metas[1:]):
        if m.schema != schema:
            raise ParquetFileError(
                f"parquet: merge schema mismatch: {p!r} does not match "
                f"{in_paths[0]!r}"
            )
        if m.column_orders != metas[0].column_orders:
            # stats interpretation differs: refusing beats silently
            # re-labeling another writer's ordering guarantees
            raise ParquetFileError(
                f"parquet: merge column-order mismatch: {p!r} does not "
                f"match {in_paths[0]!r}"
            )
    out_groups = []
    num_rows = 0
    out, owns = open_sink(out_path)
    try:
        out.write(MAGIC)
        pos = len(MAGIC)
        for path, meta in zip(in_paths, metas):
            with open(path, "rb") as f:
                for rg in meta.row_groups or []:
                    pos = _copy_group(out, pos, f, rg, len(out_groups), path)
                    out_groups.append(rg)
                    num_rows += rg.num_rows or 0
        kv = dict(key_value_metadata or {})
        out_meta = FileMetaData(
            version=2,
            schema=schema,
            num_rows=num_rows,
            row_groups=out_groups,
            created_by=created_by or "parquet_tpu merge",
            key_value_metadata=(
                [KeyValue(key=k, value=v) for k, v in kv.items()] or None
            ),
            # carried from the inputs (verified equal above): the copied
            # statistics keep the ordering their writer declared for them
            column_orders=metas[0].column_orders,
        )
        out.write(serialize_footer(out_meta))
    except BaseException:
        out.abort()  # atomic sinks leave no partial merge output
        raise
    if owns:
        out.close()  # commit
    else:
        out.flush()
    return out_meta
