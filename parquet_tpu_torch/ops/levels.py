"""Repetition/definition level codec (host path).

Levels are RLE-encoded (hybrid) at width bit_length(max_level). V1 data pages
prefix the level stream with a 4-byte LE length (reference:
hybrid_decoder.go:56-66); V2 pages store levels raw, sizes in the page header
(reference: page_v2.go:79-131). max_level == 0 means the stream is absent and
all levels are 0 (reference: helpers.go:210-231 constDecoder).
"""

from __future__ import annotations

import struct

import numpy as np

from .bitpack import bit_width
from .rle_hybrid import decode_hybrid, encode_hybrid

__all__ = [
    "decode_levels_v1",
    "decode_levels_v2",
    "encode_levels_v1",
    "encode_levels_v2",
    "LevelError",
    "rows_from_rep",
]


class LevelError(ValueError):
    pass


def _single_rle_run(buf, num_values: int, width: int):
    """Value of the stream's first RLE run if it alone covers num_values,
    else None. The all-one-value level stream (no nulls / flat data) is the
    overwhelmingly common case; recognizing it from the run header skips the
    full hybrid decode AND the O(n) range check / non-null count."""
    pos = 0
    header = 0
    shift = 0
    while True:
        if pos >= len(buf) or shift > 35:
            return None
        b = buf[pos]
        pos += 1
        header |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if header & 1 or (header >> 1) < num_values:
        return None
    nbytes = (width + 7) // 8
    if pos + nbytes > len(buf):
        return None
    return int.from_bytes(buf[pos : pos + nbytes], "little")


def decode_levels_v1(
    data, num_values: int, max_level: int, want_const: bool = False
):
    """Returns (levels, total bytes consumed incl. the 4-byte size prefix);
    with want_const=True, (levels, consumed, const_value_or_None)."""
    if max_level == 0:
        z = np.zeros(num_values, dtype=np.uint16)
        return (z, 0, 0) if want_const else (z, 0)
    buf = memoryview(data) if not isinstance(data, memoryview) else data
    if len(buf) < 4:
        raise LevelError("levels: truncated v1 size prefix")
    (size,) = struct.unpack_from("<I", buf, 0)
    if 4 + size > len(buf):
        raise LevelError(f"levels: v1 stream size {size} exceeds page")
    width = bit_width(max_level)
    cv = _single_rle_run(buf[4 : 4 + size], num_values, width) if num_values else None
    if cv is not None:
        if cv > max_level:
            raise LevelError(f"levels: value {cv} exceeds max level {max_level}")
        levels = np.full(num_values, cv, dtype=np.uint16)
        return (levels, 4 + size, cv) if want_const else (levels, 4 + size)
    levels = decode_hybrid(buf[4 : 4 + size], num_values, width, dtype=np.uint16)
    _check(levels, max_level)
    return (levels, 4 + size, None) if want_const else (levels, 4 + size)


def decode_levels_v2(data, num_values: int, max_level: int, want_const: bool = False):
    """V2: `data` is exactly the level stream (length from the page header).
    With want_const=True returns (levels, const_value_or_None)."""
    if max_level == 0:
        z = np.zeros(num_values, dtype=np.uint16)
        return (z, 0) if want_const else z
    width = bit_width(max_level)
    cv = _single_rle_run(data, num_values, width) if num_values else None
    if cv is not None:
        if cv > max_level:
            raise LevelError(f"levels: value {cv} exceeds max level {max_level}")
        levels = np.full(num_values, cv, dtype=np.uint16)
        return (levels, cv) if want_const else levels
    levels = decode_hybrid(data, num_values, width, dtype=np.uint16)
    _check(levels, max_level)
    return (levels, None) if want_const else levels


def encode_levels_v1(levels, max_level: int) -> bytes:
    if max_level == 0:
        return b""
    stream = encode_hybrid(np.asarray(levels), bit_width(max_level))
    return struct.pack("<I", len(stream)) + stream


def encode_levels_v2(levels, max_level: int) -> bytes:
    if max_level == 0:
        return b""
    return encode_hybrid(np.asarray(levels), bit_width(max_level))


def _check(levels: np.ndarray, max_level: int) -> None:
    if levels.size and int(levels.max()) > max_level:
        raise LevelError(
            f"levels: value {int(levels.max())} exceeds max level {max_level}"
        )


def rows_from_rep(rep, n: int | None = None) -> np.ndarray:
    """Positions where a record starts (rep == 0), as int64 indices.

    `rep is None` means the column has no repetition dimension: every entry
    starts a record, so the starts are 0..n-1 (`n` required then)."""
    if rep is None:
        if n is None:
            raise ValueError("rows_from_rep: n required when rep is None")
        return np.arange(n, dtype=np.int64)
    return np.flatnonzero(np.asarray(rep) == 0)
