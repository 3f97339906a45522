"""Shared ULEB128 varint helpers for the byte-stream codecs."""

from __future__ import annotations

__all__ = ["read_uvarint", "read_zigzag", "emit_uvarint", "emit_zigzag"]


def read_uvarint(buf, pos: int, end: int, err=ValueError) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= end:
            raise err("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            if result >= 1 << 64:
                # overflow — same rejection as Go's binary.ReadUvarint
                raise err("varint overflows uint64")
            return result, pos
        shift += 7
        if shift > 63:
            raise err("varint too long")


def read_zigzag(buf, pos: int, end: int, err=ValueError) -> tuple[int, int]:
    n, pos = read_uvarint(buf, pos, end, err)
    return (n >> 1) ^ -(n & 1), pos


def emit_uvarint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def emit_zigzag(out: bytearray, v: int) -> None:
    emit_uvarint(out, (v << 1) ^ (v >> 63))
