"""Split-block bloom filters (parquet-format BloomFilter.md), the read side.

A copy of parquet_tpu/core/bloom.py cut to what row-group pruning needs:
parse a chunk's filter (`BloomFilter.from_buffer`) and probe it
(`might_contain`, `might_contain_hash`). A chunk's filter is an array of
32-byte blocks (8 uint32 words); a value hashes with XXH64 (seed 0) over
its PLAIN-encoded bytes, the hash's top 32 bits pick the block, and the low
32 bits x 8 fixed odd salts pick one bit per word. Equality predicates on
high-cardinality columns — exactly where min/max statistics are useless —
prune row groups whose filter proves the value absent.

A probe hashes through the port's host library (ptq_xxh64 in
native/values.cc), as the JAX module does through its own; the pure-Python
`xxh64` below is the spec implementation the tests hold it against.
Building and writing filters (and the batch hashes they use) wait for the
write slice.
"""

from __future__ import annotations

import struct

import numpy as np

from ..meta.parquet_types import BloomFilterHeader, Type

__all__ = ["BloomFilter", "plain_bytes_for_hash", "xxh64"]

_SALT = np.array(
    [
        0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
        0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31,
    ],
    dtype=np.uint64,
)

_M64 = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """Pure-Python XXH64 (the spec implementation): the oracle of ptq_xxh64."""
    p, end = 0, len(data)
    if end >= 32:
        vs = [
            (seed + _P1 + _P2) & _M64,
            (seed + _P2) & _M64,
            seed & _M64,
            (seed - _P1) & _M64,
        ]
        while p + 32 <= end:
            for j in range(4):
                lane = int.from_bytes(data[p + 8 * j : p + 8 * j + 8], "little")
                vs[j] = (_rotl((vs[j] + lane * _P2) & _M64, 31) * _P1) & _M64
            p += 32
        h = (
            _rotl(vs[0], 1) + _rotl(vs[1], 7) + _rotl(vs[2], 12) + _rotl(vs[3], 18)
        ) & _M64
        for acc in vs:
            h = ((h ^ (_rotl((acc * _P2) & _M64, 31) * _P1) & _M64) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + end) & _M64
    while p + 8 <= end:
        k = (_rotl((int.from_bytes(data[p : p + 8], "little") * _P2) & _M64, 31) * _P1) & _M64
        h = (_rotl(h ^ k, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= end:
        h = (_rotl(h ^ ((int.from_bytes(data[p : p + 4], "little") * _P1) & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < end:
        h = (_rotl(h ^ ((data[p] * _P5) & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


def plain_bytes_for_hash(ptype, value, unsigned: bool = False) -> bytes | None:
    """PLAIN-encoded bytes of one filter value (the hash input), or None
    when the value has no exact physical form for this type."""
    try:
        if ptype == Type.INT32:
            return struct.pack("<I" if unsigned else "<i", value)
        if ptype == Type.INT64:
            return struct.pack("<Q" if unsigned else "<q", value)
        if ptype == Type.FLOAT:
            # +0.0 == -0.0 but their bit patterns differ; both sides of the
            # bloom (insert and probe) normalize to +0.0 so equality survives
            return struct.pack("<f", value + 0.0)
        if ptype == Type.DOUBLE:
            return struct.pack("<d", value + 0.0)
        if ptype in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
            if isinstance(value, str):
                return value.encode("utf-8")
            if isinstance(value, (bytes, bytearray, memoryview)):
                return bytes(value)
    except struct.error:
        return None
    return None


class BloomFilter:
    """One column chunk's split-block bloom filter."""

    def __init__(self, blocks: np.ndarray):
        if blocks.dtype != np.uint32 or len(blocks) % 8:
            raise ValueError("bloom: bitset must be uint32 words in 8-word blocks")
        self.blocks = blocks

    @property
    def num_bytes(self) -> int:
        return self.blocks.nbytes

    def might_contain_hash(self, h: int) -> bool:
        nb = len(self.blocks) // 8
        bi = ((h >> 32) * nb) >> 32
        x = np.uint64(h & 0xFFFFFFFF)
        bits = ((x * _SALT) & np.uint64(0xFFFFFFFF)) >> np.uint64(27)
        words = self.blocks[bi * 8 : bi * 8 + 8]
        return bool(
            np.all((words >> bits.astype(np.uint32)) & np.uint32(1))
        )

    def might_contain(self, ptype, value, unsigned: bool = False) -> bool:
        """False only when the value is PROVABLY absent; unsupported value
        forms answer True (no pruning)."""
        raw = plain_bytes_for_hash(ptype, value, unsigned)
        if raw is None:
            return True
        from ..utils.native import get_native

        lib = get_native()
        if self.might_contain_hash(lib.xxh64(raw)):
            return True
        if ptype in (Type.FLOAT, Type.DOUBLE) and value == 0.0:
            # writers that normalize -0.0 -> +0.0 insert +0.0, but FOREIGN
            # writers may have inserted the raw -0.0 bit pattern; 0.0 ==
            # -0.0, so the probe must admit either before claiming absence
            neg = struct.pack("<f" if ptype == Type.FLOAT else "<d", -0.0)
            return self.might_contain_hash(lib.xxh64(neg))
        return False

    @classmethod
    def from_buffer(cls, buf) -> "BloomFilter":
        """Parse [BloomFilterHeader][bitset] as stored in the file."""
        from ..meta.thrift import CompactReader

        r = CompactReader(buf)
        header = BloomFilterHeader.read(r)
        n = header.numBytes or 0
        if n <= 0 or n % 32 or r.pos + n > len(buf):
            raise ValueError(f"bloom: bad bitset size {n}")
        if header.algorithm is not None and header.algorithm.BLOCK is None:
            raise ValueError("bloom: unsupported algorithm")
        if header.hash is not None and header.hash.XXHASH is None:
            raise ValueError("bloom: unsupported hash")
        if (
            header.compression is not None
            and header.compression.UNCOMPRESSED is None
        ):
            raise ValueError("bloom: unsupported compression")
        bits = np.frombuffer(buf, dtype=np.uint32, count=n // 4, offset=r.pos)
        return cls(bits.copy())
