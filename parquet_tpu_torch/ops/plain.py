"""PLAIN encoding per physical type (host path).

Semantics match the reference's per-type codecs (reference: type_boolean.go,
type_int32.go, type_int64.go, type_int96.go, type_float.go, type_double.go,
type_bytearray.go) but decode whole pages as array views instead of one boxed
value per call. Numeric decode is a dtype view of the wire bytes — bit-exact by
construction, including NaN payloads (SURVEY §7.3 hard-part #2).
"""

from __future__ import annotations

import numpy as np

from ..meta.parquet_types import Type
from ..core.arrays import ByteArrayData

__all__ = [
    "decode_plain",
    "encode_plain",
    "PlainError",
    "byte_array_gather_plain",
    "plain_encode_bytearray_plain",
]


class PlainError(ValueError):
    pass


_NUMERIC_DTYPES = {
    Type.INT32: np.dtype("<i4"),
    Type.INT64: np.dtype("<i8"),
    Type.FLOAT: np.dtype("<f4"),
    Type.DOUBLE: np.dtype("<f8"),
}


def decode_plain(data, num_values: int, ptype: Type, type_length: int | None = None):
    """Decode `num_values` PLAIN values. Returns (values, bytes_consumed)."""
    buf = memoryview(data) if not isinstance(data, memoryview) else data
    if ptype in _NUMERIC_DTYPES:
        dt = _NUMERIC_DTYPES[ptype]
        need = num_values * dt.itemsize
        if len(buf) < need:
            raise PlainError(
                f"plain: need {need} bytes for {num_values} {ptype.name}, have {len(buf)}"
            )
        return np.frombuffer(buf, dtype=dt, count=num_values), need
    if ptype == Type.BOOLEAN:
        need = (num_values + 7) // 8
        if len(buf) < need:
            raise PlainError("plain: boolean payload too short")
        bits = np.unpackbits(
            np.frombuffer(buf, dtype=np.uint8, count=need), bitorder="little"
        )
        return bits[:num_values].astype(bool), need
    if ptype == Type.INT96:
        need = num_values * 12
        if len(buf) < need:
            raise PlainError("plain: int96 payload too short")
        return (
            np.frombuffer(buf, dtype=np.uint8, count=need).reshape(num_values, 12),
            need,
        )
    if ptype == Type.FIXED_LEN_BYTE_ARRAY:
        if not type_length or type_length < 0:
            raise PlainError("plain: fixed_len_byte_array requires type_length")
        need = num_values * type_length
        if len(buf) < need:
            raise PlainError("plain: fixed payload too short")
        return (
            np.frombuffer(buf, dtype=np.uint8, count=need).reshape(
                num_values, type_length
            ),
            need,
        )
    if ptype == Type.BYTE_ARRAY:
        return _decode_plain_byte_array(buf, num_values)
    raise PlainError(f"plain: unsupported type {ptype}")


def _decode_plain_byte_array(buf: memoryview, num_values: int):
    # Inline 4-byte LE length before each value (reference: type_bytearray.go:24-45).
    # The offset chain is data-dependent: one native walk at memcpy speed
    # (ptq_byte_array_gather); byte_array_gather_plain is its oracle.
    from ..utils.native import get_native

    try:
        offsets, flat, consumed = get_native().byte_array_gather(buf, num_values)
    except ValueError as e:
        raise PlainError(str(e)) from e
    return ByteArrayData(offsets=offsets, data=flat), consumed


def byte_array_gather_plain(buf, num_values: int):
    """The PLAIN byte-array decode as a Python walk: the oracle the tests
    hold ptq_byte_array_gather against. Returns (ByteArrayData, consumed)."""
    end = len(buf)
    offsets = np.empty(num_values + 1, dtype=np.int64)
    offsets[0] = 0
    parts = []
    pos = 0
    total = 0
    b = buf
    for i in range(num_values):
        if pos + 4 > end:
            raise PlainError("plain: truncated byte_array length")
        ln = int.from_bytes(b[pos : pos + 4], "little")
        pos += 4
        if ln < 0 or pos + ln > end:
            raise PlainError(f"plain: byte_array length {ln} exceeds page")
        parts.append(bytes(b[pos : pos + ln]))
        pos += ln
        total += ln
        offsets[i + 1] = total
    return ByteArrayData(offsets=offsets, data=b"".join(parts)), pos


def encode_plain(values, ptype: Type, type_length: int | None = None) -> bytes:
    """Encode values (in the array representations of decode_plain) as PLAIN."""
    if ptype in _NUMERIC_DTYPES:
        dt = _NUMERIC_DTYPES[ptype]
        return np.ascontiguousarray(np.asarray(values, dtype=dt)).tobytes()
    if ptype == Type.BOOLEAN:
        v = np.asarray(values, dtype=bool)
        return np.packbits(v.astype(np.uint8), bitorder="little").tobytes()
    if ptype in (Type.INT96, Type.FIXED_LEN_BYTE_ARRAY):
        v = np.asarray(values, dtype=np.uint8)
        if v.ndim != 2:
            raise PlainError(f"plain: {ptype.name} expects a (n, width) uint8 array")
        if ptype == Type.INT96 and v.shape[1] != 12:
            raise PlainError("plain: int96 rows must be 12 bytes")
        if ptype == Type.FIXED_LEN_BYTE_ARRAY and type_length and v.shape[1] != type_length:
            raise PlainError("plain: fixed-len width mismatch")
        return v.tobytes()
    if ptype == Type.BYTE_ARRAY:
        from ..utils.native import get_native

        if not isinstance(values, ByteArrayData):
            values = ByteArrayData.from_list([bytes(x) for x in values])
        # one C pass over (offsets, data): the write path's hot loop for
        # string chunks; plain_encode_bytearray_plain is its oracle
        return get_native().plain_encode_bytearray(values.data, values.offsets)
    raise PlainError(f"plain: unsupported type {ptype}")


def plain_encode_bytearray_plain(values) -> bytes:
    """The PLAIN byte-array encode as a Python loop over the items: the
    oracle the tests hold ptq_plain_encode_bytearray against."""
    if isinstance(values, ByteArrayData):
        items = values.to_list()
    else:
        items = [bytes(x) for x in values]
    out = bytearray()
    for item in items:
        out += len(item).to_bytes(4, "little")
        out += item
    return bytes(out)
