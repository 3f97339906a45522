"""Per-column totals of a file's metadata.

The port's cut of parquet_tpu/utils/metrics.py: the reference's process
metrics registry stays cut (the port keeps plain counts per layer:
io_counts(), filter_counts(), row_counts(), write_counts(),
prepare_counts(), query_device_counts()); what `parquet-tool meta` needs
is its two pure functions over a FileMetaData, `summarize_columns` and
the `encoding_name` it uses.
"""

from __future__ import annotations

from ..meta.parquet_types import Encoding

__all__ = ["encoding_name", "summarize_columns"]


def encoding_name(enc) -> str:
    try:
        return Encoding(int(enc)).name
    except Exception:
        return str(enc)


def summarize_columns(metadata) -> dict:
    """Per-column totals across every row group of a FileMetaData:
    {dotted path: {encodings, compressed, uncompressed, ratio}} — the
    metadata-sourced feed for `parquet-tool meta`'s summary lines."""
    out: dict[str, dict] = {}
    for rg in metadata.row_groups or []:
        for cc in rg.columns or []:
            md = cc.meta_data
            if md is None:
                continue
            name = ".".join(md.path_in_schema or [])
            s = out.setdefault(
                name, {"encodings": [], "compressed": 0, "uncompressed": 0}
            )
            for e in md.encodings or []:
                en = encoding_name(e)
                if en not in s["encodings"]:
                    s["encodings"].append(en)
            s["compressed"] += md.total_compressed_size or 0
            s["uncompressed"] += md.total_uncompressed_size or 0
    for s in out.values():
        s["encodings"] = sorted(s["encodings"])
        s["ratio"] = (
            s["uncompressed"] / s["compressed"] if s["compressed"] else None
        )
    return out
