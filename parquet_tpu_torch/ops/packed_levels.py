"""Bit-packed repetition/definition level storage with widen-on-demand.

The reference keeps R/D levels bit-packed at width = bit_length(max_level) in
`packedArray` (reference: packed_array.go:13-101) — ~1/8 the memory of widened
arrays. The round-2 design here stored levels as uint16 ndarrays: 16x the
packed footprint on billion-row nested scans. PackedLevels restores the
reference's advantage the array-native way: levels at rest are a contiguous
LSB-first bitstream; consumers get vectorized windows on demand (`widen`), or
use NumPy operators directly (`==`, `<`, `np.asarray`) which widen
transiently — peak memory is packed + one transient window, instead of a
permanently widened array per chunk.

Opt-in via FileReader(..., compact_levels=True): ChunkData.def_levels /
rep_levels (and DeviceColumn's level arrays) then hold PackedLevels instead of
ndarrays. Record assembly widens per chunk transiently; the device-batch
validity-mask path compares packed levels directly.
"""

from __future__ import annotations

import numpy as np

from .bitpack import bit_width, pack_bits, unpack_bits

__all__ = ["PackedLevels", "widen_levels"]


class PackedLevels:
    """Immutable bit-packed level array (LSB-first, like Parquet's hybrid
    bit-packed runs: bit j of value i is bit i*width+j of the stream)."""

    __slots__ = ("_packed", "width", "_n")

    def __init__(self, packed: np.ndarray, width: int, n: int):
        self._packed = packed  # uint8, >= ceil(n*width/8) bytes
        self.width = width
        self._n = n

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_array(cls, levels, max_level: int) -> "PackedLevels":
        """Pack a widened level array at width bit_length(max_level)."""
        arr = np.asarray(levels)
        w = bit_width(max_level)
        n = arr.shape[0]
        if arr.size and int(arr.max()) > max_level:
            # checked against max_level, not the bit width: level 3 fits
            # width 2 but exceeds max_level 2 (and width 0 must stay empty)
            raise ValueError(
                f"levels: value {int(arr.max())} exceeds max level {max_level}"
            )
        if w == 0 or n == 0:
            return cls(np.empty(0, dtype=np.uint8), w, n)
        packed = np.frombuffer(pack_bits(arr, w), dtype=np.uint8)
        return cls(packed, w, n)

    # -- core access -----------------------------------------------------------

    def widen(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        """Vectorized unpack of levels [start, stop) into a uint16 array.

        Windowed widening is the memory contract: callers that stream (row
        windows, per-chunk assembly) materialize only their window.
        """
        n = self._n
        if stop is None:
            stop = n
        start = max(0, min(start, n))
        stop = max(start, min(stop, n))
        w = self.width
        count = stop - start
        if w == 0 or count == 0:
            return np.zeros(count, dtype=np.uint16)
        return unpack_bits(
            self._packed, count, w, dtype=np.uint16, bit_offset=start * w
        )

    # -- ndarray interop -------------------------------------------------------

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            # NumPy 2 protocol: widening always materializes a new array, so
            # a no-copy request cannot be honored
            raise ValueError("PackedLevels cannot be converted without a copy")
        out = self.widen()
        return out.astype(dtype) if dtype is not None else out

    def __len__(self) -> int:
        return self._n

    @property
    def shape(self) -> tuple:
        return (self._n,)

    @property
    def dtype(self):
        return np.dtype(np.uint16)

    @property
    def nbytes(self) -> int:
        return self._packed.nbytes

    @property
    def packed(self) -> np.ndarray:
        return self._packed

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self._n)
            if step < 0:
                # indices() yields start > stop here; widen the covering
                # window [stop+1, start+1) and stride it backwards
                win = self.widen(stop + 1, start + 1)
                return win[::step]
            win = self.widen(start, stop)
            return win[::step] if step != 1 else win
        if isinstance(key, (int, np.integer)):
            i = int(key)
            if i < 0:
                i += self._n
            if not 0 <= i < self._n:
                raise IndexError(f"level index {key} out of range ({self._n})")
            if self.width == 0:
                return np.uint16(0)
            return self.widen(i, i + 1)[0]
        return self.widen()[key]  # fancy indexing: widen once

    def max(self):
        if self._n == 0:
            raise ValueError("max of empty levels")
        if self.width == 0:
            return np.uint16(0)
        return self.widen().max()

    def tolist(self) -> list:
        return self.widen().tolist()

    # -- comparisons (transient widen) -----------------------------------------

    def __eq__(self, other):  # type: ignore[override]
        return self.widen() == other

    def __ne__(self, other):  # type: ignore[override]
        return self.widen() != other

    def __lt__(self, other):
        return self.widen() < other

    def __le__(self, other):
        return self.widen() <= other

    def __gt__(self, other):
        return self.widen() > other

    def __ge__(self, other):
        return self.widen() >= other

    __hash__ = None  # arrays are unhashable

    def __repr__(self) -> str:
        return f"PackedLevels(n={self._n}, width={self.width}, nbytes={self.nbytes})"


def widen_levels(levels):
    """ndarray view of a level array that may be packed (None passes through)."""
    if levels is None or isinstance(levels, np.ndarray):
        return levels
    return np.asarray(levels)
