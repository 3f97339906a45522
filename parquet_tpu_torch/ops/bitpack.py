"""Vectorized bit-packing kernels (host path).

The reference generates 4,574 lines of width-specialized Go (reference:
bitpack_gen.go, bitbacking32.go:10-44, bitpacking64.go:10) to pack/unpack groups
of 8 values at bit widths 0..64. Here the same operation is a single vectorized
formulation, parameterized by width:

    unpack:  bytes --np.unpackbits(LSB-first)--> bitstream --reshape (N, W)-->
             bit-matrix @ [1, 2, 4, ...]  (per-value little-endian bit weights)
    pack:    values -> bit-matrix ((v >> j) & 1) -> flatten -> np.packbits

Parquet's RLE/bit-packed hybrid packs values LSB-first back to back, so bit j of
value i is bit (i*W + j) of the byte stream — exactly NumPy's little bitorder.
"""

from __future__ import annotations

import numpy as np

__all__ = ["unpack_bits", "pack_bits", "bit_width", "bytes_for"]


def bit_width(v: int) -> int:
    """Number of bits needed to represent v (0 -> 0)."""
    return int(v).bit_length()


def bytes_for(num_values: int, width: int) -> int:
    """Bytes occupied by num_values bit-packed values (caller pads to groups of 8)."""
    return (num_values * width + 7) // 8


def unpack_bits(
    data, num_values: int, width: int, dtype=np.uint64, bit_offset: int = 0
) -> np.ndarray:
    """Unpack `num_values` little-endian bit-packed values of `width` bits.

    `data` is a bytes-like; values start `bit_offset` bits into it (windowed
    consumers like PackedLevels.widen pass unaligned starts) and only the
    covering bytes are consumed. Returns an array of `dtype`.
    """
    if width == 0:
        return np.zeros(num_values, dtype=dtype)
    if width > 64:
        raise ValueError(f"bitpack: unsupported width {width}")
    byte0 = bit_offset >> 3
    off = bit_offset - (byte0 << 3)
    nbytes = (off + num_values * width + 7) >> 3
    raw = np.frombuffer(data, dtype=np.uint8, offset=byte0, count=nbytes)
    bits = np.unpackbits(raw, bitorder="little")
    needed = num_values * width
    if bits.size - off < needed:
        raise ValueError("bitpack: input too short")
    bits = bits[off : off + needed].reshape(num_values, width)
    weights = (np.uint64(1) << np.arange(width, dtype=np.uint64))
    out = bits.astype(np.uint64) @ weights
    return out.astype(dtype, copy=False)


def pack_bits(values: np.ndarray, width: int) -> bytes:
    """Pack values (non-negative, < 2**width) LSB-first at `width` bits each.

    The caller is responsible for padding to a multiple of 8 values where the
    format requires it (hybrid bit-packed runs always cover groups of 8).
    """
    if width == 0 or len(values) == 0:
        return b""
    if width > 64:
        raise ValueError(f"bitpack: unsupported width {width}")
    v = np.asarray(values).astype(np.uint64, copy=False)
    if width < 64 and v.size and int(v.max()) >= (1 << width):
        raise ValueError(
            f"bitpack: value {int(v.max())} does not fit in {width} bits"
        )
    shifts = np.arange(width, dtype=np.uint64)
    bits = ((v[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()
