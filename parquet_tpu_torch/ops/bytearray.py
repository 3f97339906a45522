"""DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY codecs (host path).

Format (parquet-format Encodings.md; reference: type_bytearray.go:98-292):
  DELTA_LENGTH_BYTE_ARRAY = delta-bp int32 lengths stream, then all value bytes
  concatenated. DELTA_BYTE_ARRAY = delta-bp int32 shared-prefix lengths, then a
  DELTA_LENGTH_BYTE_ARRAY stream of suffixes; value[i] = value[i-1][:prefix[i]]
  + suffix[i].

Lengths/offsets decode vectorizes via the delta codec; only the prefix
reconstruction of DELTA_BYTE_ARRAY is inherently sequential (each value depends
on the previous), and stays a host loop.
"""

from __future__ import annotations

import numpy as np

from ..core.arrays import ByteArrayData
from .delta import decode_delta, encode_delta

__all__ = [
    "decode_delta_length_byte_array",
    "encode_delta_length_byte_array",
    "decode_delta_byte_array",
    "encode_delta_byte_array",
    "ByteArrayError",
]


class ByteArrayError(ValueError):
    pass


def decode_delta_length_byte_array(data, num_values: int) -> tuple[ByteArrayData, int]:
    buf = memoryview(data) if not isinstance(data, memoryview) else data
    lengths, consumed = decode_delta(buf, 32, max_total=num_values)
    if len(lengths) < num_values:
        raise ByteArrayError(
            f"delta-length: stream has {len(lengths)} lengths, need {num_values}"
        )
    lengths = lengths[:num_values].astype(np.int64)
    if num_values and lengths.min() < 0:
        raise ByteArrayError("delta-length: negative length")
    offsets = np.zeros(num_values + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    total = int(offsets[-1])
    if consumed + total > len(buf):
        raise ByteArrayError("delta-length: value bytes exceed page")
    blob = bytes(buf[consumed : consumed + total])
    return ByteArrayData(offsets=offsets, data=blob), consumed + total


def encode_delta_length_byte_array(values: ByteArrayData) -> bytes:
    lengths = (values.offsets[1:] - values.offsets[:-1]).astype(np.int32)
    return encode_delta(lengths, 32) + values.data


def decode_delta_byte_array(data, num_values: int) -> tuple[ByteArrayData, int]:
    buf = memoryview(data) if not isinstance(data, memoryview) else data
    prefixes, consumed = decode_delta(buf, 32, max_total=num_values)
    if len(prefixes) < num_values:
        raise ByteArrayError("delta-byte-array: prefix stream too short")
    prefixes = prefixes[:num_values].astype(np.int64)
    suffixes, consumed2 = decode_delta_length_byte_array(buf[consumed:], num_values)
    # Sequential prefix reconstruction with bounds checks
    # (reference: type_bytearray.go:227-230).
    out_parts: list[bytes] = []
    prev = b""
    soff = suffixes.offsets
    sdata = suffixes.data
    for i in range(num_values):
        p = int(prefixes[i])
        if p < 0 or p > len(prev):
            raise ByteArrayError(
                f"delta-byte-array: prefix {p} exceeds previous value length {len(prev)}"
            )
        v = prev[:p] + sdata[soff[i] : soff[i + 1]]
        out_parts.append(v)
        prev = v
    return ByteArrayData.from_list(out_parts), consumed + consumed2


def encode_delta_byte_array(values: ByteArrayData) -> bytes:
    n = len(values)
    prefixes = np.zeros(n, dtype=np.int32)
    suffix_parts: list[bytes] = []
    prev = b""
    for i in range(n):
        v = values[i]
        p = _shared_prefix(prev, v)
        prefixes[i] = p
        suffix_parts.append(v[p:])
        prev = v
    return encode_delta(prefixes, 32) + encode_delta_length_byte_array(
        ByteArrayData.from_list(suffix_parts)
    )


def _shared_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i
