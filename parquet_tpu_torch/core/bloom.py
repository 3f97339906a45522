"""Split-block bloom filters (parquet-format BloomFilter.md).

A copy of parquet_tpu/core/bloom.py. The read side parses a chunk's filter
(`BloomFilter.from_buffer`) and probes it (`might_contain`,
`might_contain_hash`); the write side sizes a filter
(`BloomFilter.sized_for`), hashes a chunk's values (`bloom_hash_values`),
inserts them (`insert_hashes`) and serializes it (`header`, `to_bytes`).
A chunk's filter is an array of
32-byte blocks (8 uint32 words); a value hashes with XXH64 (seed 0) over
its PLAIN-encoded bytes, the hash's top 32 bits pick the block, and the low
32 bits x 8 fixed odd salts pick one bit per word. Equality predicates on
high-cardinality columns — exactly where min/max statistics are useless —
prune row groups whose filter proves the value absent.

Hashes and inserts run through the port's host library (ptq_xxh64,
ptq_xxh64_fixed, ptq_xxh64_offsets and ptq_bloom_insert in
native/values.cc), as the JAX module's do through its own; without the
library they raise HostBuildError. The pure-Python `xxh64`,
`bloom_hash_values_plain` and `BloomFilter.insert_hashes_plain` are the
spec implementations the tests hold them against.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..meta.parquet_types import (
    BloomFilterAlgorithm,
    BloomFilterCompression,
    BloomFilterHash,
    BloomFilterHeader,
    BloomFilterUncompressed,
    SplitBlockAlgorithm,
    Type,
    XxHash,
)

__all__ = [
    "BloomFilter",
    "bloom_hash_values",
    "bloom_hash_values_plain",
    "plain_bytes_for_hash",
    "xxh64",
]

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


_FIXED_WIDTH = {Type.INT32: 4, Type.INT64: 8, Type.FLOAT: 4, Type.DOUBLE: 8}


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


def _hash_input(ptype, values):
    """(kind, array) of a chunk's values as the hash reads them: "bytes"
    with a ByteArrayData, else "fixed" with a contiguous 2-D (FLBA) or 1-D
    array of the type's width, floats with -0.0 normalized to +0.0."""
    from .arrays import ByteArrayData

    if isinstance(values, ByteArrayData):
        return "bytes", values
    arr = np.ascontiguousarray(np.asarray(values))
    if arr.ndim == 2:  # FLBA rows
        return "fixed", arr
    width = _FIXED_WIDTH.get(ptype)
    if width is None or arr.itemsize != width:
        raise ValueError(f"bloom: unsupported type {ptype} for hashing")
    if ptype in (Type.FLOAT, Type.DOUBLE):
        # normalize -0.0 -> +0.0 (see plain_bytes_for_hash)
        arr = np.ascontiguousarray(arr + arr.dtype.type(0.0))
    return "fixed", arr


def bloom_hash_values(ptype, values) -> np.ndarray:
    """XXH64 of every value's PLAIN bytes -> uint64 hashes, one native
    batch call."""
    from ..utils.native import get_native

    lib = get_native()
    kind, arr = _hash_input(ptype, values)
    if kind == "bytes":
        return lib.xxh64_offsets(arr.data, arr.offsets)
    width = arr.shape[1] if arr.ndim == 2 else arr.itemsize
    return lib.xxh64_fixed(arr, len(arr), width)


def bloom_hash_values_plain(ptype, values) -> np.ndarray:
    """The Python loop of bloom_hash_values: its oracle."""
    kind, arr = _hash_input(ptype, values)
    if kind == "bytes":
        return np.array([xxh64(v) for v in arr.to_list()], dtype=np.uint64)
    if arr.ndim == 2:
        return np.array([xxh64(r.tobytes()) for r in arr], dtype=np.uint64)
    width = arr.itemsize
    raw = arr.tobytes()
    return np.array(
        [xxh64(raw[i * width : (i + 1) * width]) for i in range(len(arr))],
        dtype=np.uint64,
    )


class BloomFilter:
    """One column chunk's split-block bloom filter."""

    MIN_BYTES = 32
    MAX_BYTES = 128 << 20

    def __init__(self, blocks: np.ndarray):
        if blocks.dtype != np.uint32 or len(blocks) % 8:
            raise ValueError("bloom: bitset must be uint32 words in 8-word blocks")
        self.blocks = blocks

    @classmethod
    def sized_for(cls, ndv: int, fpp: float = 0.05) -> "BloomFilter":
        """Empty filter sized for `ndv` distinct values at false-positive
        rate `fpp` (parquet-mr's optimal-bits formula, bytes rounded up to a
        power of two within [32 B, 128 MB])."""
        ndv = max(int(ndv), 1)
        if not 0.0 < fpp < 1.0:
            raise ValueError("bloom: fpp must be in (0, 1)")
        bits = -8.0 * ndv / math.log(1.0 - fpp ** (1.0 / 8.0))
        # ceil to whole bytes BEFORE the power-of-two round-up: int() here
        # would undershoot the requested fpp whenever optimal bytes lands
        # just above a power of two
        nbytes = 1 << max(math.ceil(bits / 8.0) - 1, 0).bit_length()
        nbytes = min(max(nbytes, cls.MIN_BYTES), cls.MAX_BYTES)
        return cls(np.zeros(nbytes // 4, dtype=np.uint32))

    @property
    def num_bytes(self) -> int:
        return self.blocks.nbytes

    def insert_hashes(self, hashes: np.ndarray) -> None:
        from ..utils.native import get_native

        get_native().bloom_insert(self.blocks, hashes)

    def insert_hashes_plain(self, hashes: np.ndarray) -> None:
        """The Python loop of insert_hashes: its oracle."""
        nb = len(self.blocks) // 8
        for h in np.asarray(hashes, dtype=np.uint64).tolist():
            bi = ((h >> 32) * nb) >> 32
            x = np.uint64(h & 0xFFFFFFFF)
            bits = ((x * _SALT) & np.uint64(0xFFFFFFFF)) >> np.uint64(27)
            self.blocks[bi * 8 : bi * 8 + 8] |= (
                np.uint32(1) << bits.astype(np.uint32)
            )

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

    # -- wire form -------------------------------------------------------------

    def header(self) -> BloomFilterHeader:
        return BloomFilterHeader(
            numBytes=self.num_bytes,
            algorithm=BloomFilterAlgorithm(BLOCK=SplitBlockAlgorithm()),
            hash=BloomFilterHash(XXHASH=XxHash()),
            compression=BloomFilterCompression(
                UNCOMPRESSED=BloomFilterUncompressed()
            ),
        )

    def to_bytes(self) -> bytes:
        return self.header().dumps() + self.blocks.tobytes()

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
