"""BYTE_STREAM_SPLIT codec (Parquet encoding 9).

Not supported by the reference at all (its encoding matrix stops at
DELTA_BYTE_ARRAY, reference: chunk_reader.go:41-159) — this exceeds parity.
The encoding stores the k-th byte of every value contiguously: for width-W
values, stream = all byte-0s, then all byte-1s, ... byte-(W-1)s. It carries
no compression itself; it groups similar bytes (exponents, high-order bytes)
so a general-purpose codec behind it compresses better — the layout transform
IS the whole codec, which makes it the most array-native encoding in the
format: decode/encode are a single (W, n) <-> (n, W) transpose, vectorized
here.

Applies to fixed-width types: FLOAT/DOUBLE (classic), INT32/INT64/
FIXED_LEN_BYTE_ARRAY (format 2.11+).
"""

from __future__ import annotations

import numpy as np

from ..meta.parquet_types import Type

__all__ = ["decode_byte_stream_split", "encode_byte_stream_split", "bss_width"]


_WIDTHS = {
    Type.FLOAT: 4,
    Type.DOUBLE: 8,
    Type.INT32: 4,
    Type.INT64: 8,
}

# explicit little-endian wire dtypes (the repo-wide convention, ops/plain.py)
_DTYPES = {
    Type.FLOAT: np.dtype("<f4"),
    Type.DOUBLE: np.dtype("<f8"),
    Type.INT32: np.dtype("<i4"),
    Type.INT64: np.dtype("<i8"),
}


def bss_width(ptype, type_length=None) -> int:
    """Element width in bytes, or 0 if the type cannot be byte-stream-split."""
    if ptype in _WIDTHS:
        return _WIDTHS[ptype]
    if ptype == Type.FIXED_LEN_BYTE_ARRAY and type_length:
        return int(type_length)
    return 0


def decode_byte_stream_split(data, n: int, ptype, type_length=None):
    """Decode n values; returns a typed 1-D array (or (n, W) uint8 for FLBA)."""
    w = bss_width(ptype, type_length)
    if w == 0:
        raise ValueError(f"byte_stream_split: unsupported type {ptype}")
    need = n * w
    if len(data) < need:
        raise ValueError(
            f"byte_stream_split: stream has {len(data)} bytes, needs {need}"
        )
    raw = (
        np.frombuffer(data, dtype=np.uint8, count=need)
        if need
        else np.empty(0, dtype=np.uint8)
    )
    # (W, n) streams -> (n, W) little-endian value rows: one transpose
    rows = np.ascontiguousarray(raw.reshape(w, n).T)
    if ptype == Type.FIXED_LEN_BYTE_ARRAY:
        return rows
    return rows.view(_DTYPES[ptype]).reshape(n)


def encode_byte_stream_split(values, ptype, type_length=None) -> bytes:
    w = bss_width(ptype, type_length)
    if w == 0:
        raise ValueError(f"byte_stream_split: unsupported type {ptype}")
    if ptype == Type.FIXED_LEN_BYTE_ARRAY:
        rows = np.asarray(values, dtype=np.uint8)
        if rows.ndim != 2 or rows.shape[1] != w:
            raise ValueError("byte_stream_split: FLBA values must be (n, width)")
    else:
        arr = np.ascontiguousarray(np.asarray(values, dtype=_DTYPES[ptype]))
        rows = arr.view(np.uint8).reshape(len(arr), w)
    return np.ascontiguousarray(rows.T).tobytes()
