"""Columnar value containers.

The reference moves decoded values as `[]interface{}` — one heap-boxed value
per cell (reference: interfaces.go:29-52, SURVEY §7.1 'invert the execution
model'). Here every column is a typed array end-to-end:

  - numeric/boolean columns: NumPy arrays (bit-exact views of the wire bytes)
  - BYTE_ARRAY columns: Arrow-style (offsets, flat byte buffer) — no per-string
    materialization (SURVEY §7.3 hard-part #3)
  - INT96: (n, 12) uint8 rows (legacy Impala timestamps)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["ByteArrayData"]

@dataclass
class ByteArrayData:
    """Variable-length binary column: values[i] = data[offsets[i]:offsets[i+1]]."""

    offsets: np.ndarray  # int64, length n+1, offsets[0] == 0
    data: bytes

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> bytes:
        return self.data[self.offsets[i] : self.offsets[i + 1]]

    def to_list(self) -> list[bytes]:
        """Per-value bytes (a fresh list each call)."""
        o = self.offsets.tolist()
        d = self.data
        return [d[o[i] : o[i + 1]] for i in range(len(o) - 1)]

    @classmethod
    def from_list(cls, items) -> "ByteArrayData":
        lengths = np.fromiter((len(x) for x in items), dtype=np.int64, count=len(items))
        offsets = np.zeros(len(items) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        return cls(offsets=offsets, data=b"".join(items))


    def _take_offsets(self, indices):
        """(indices as int64, the taken rows' lengths, their new offsets),
        after the range check."""
        indices = np.asarray(indices, dtype=np.int64)
        if len(indices) and (
            int(indices.min()) < 0 or int(indices.max()) >= len(self)
        ):
            raise IndexError("byte-array take: index out of range")
        o = self.offsets
        lengths = (o[1:] - o[:-1])[indices]
        new_off = np.zeros(len(indices) + 1, dtype=np.int64)
        np.cumsum(lengths, out=new_off[1:])
        return indices, lengths, new_off

    def take(self, indices: np.ndarray) -> "ByteArrayData":
        """Gather rows by index (dictionary expansion): the offsets by a
        NumPy cumsum, the bytes by one native pass (ptq_bytearray_take).
        `take_plain` is its oracle."""
        indices, _lengths, new_off = self._take_offsets(indices)
        total = int(new_off[-1])
        if total == 0:
            return ByteArrayData(offsets=new_off, data=b"")
        from ..utils.native import get_native

        data = get_native().bytearray_take(self.data, self.offsets, indices, new_off, total)
        return ByteArrayData(offsets=new_off, data=data)

    def take_plain(self, indices: np.ndarray) -> "ByteArrayData":
        """`take` in NumPy alone, the oracle the tests hold the native take
        against: one fancy-index over the source buffer; for output row k
        the source positions are starts[k] + [0, len_k), expressed as
        arange(total) - repeat(out_starts) + repeat(src_starts)."""
        indices, lengths, new_off = self._take_offsets(indices)
        total = int(new_off[-1])
        if total == 0:
            return ByteArrayData(offsets=new_off, data=b"")
        src = np.frombuffer(self.data, dtype=np.uint8)
        starts = self.offsets[:-1][indices]
        gather = (
            np.arange(total, dtype=np.int64)
            - np.repeat(new_off[:-1], lengths)
            + np.repeat(starts, lengths)
        )
        return ByteArrayData(offsets=new_off, data=src[gather].tobytes())

    def __eq__(self, other) -> bool:
        if not isinstance(other, ByteArrayData):
            return NotImplemented
        return (
            np.array_equal(self.offsets, other.offsets) and self.data == other.data
        )
