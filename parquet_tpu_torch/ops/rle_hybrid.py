"""RLE / bit-packing hybrid codec (host path) + run-table prescan for the device path.

Wire format (parquet-format Encodings.md, same semantics as the reference's
hybrid_decoder.go:81-165): a sequence of runs, each introduced by a ULEB128
header. Low bit 0 → RLE run of (header >> 1) copies of one value stored in
ceil(width/8) little-endian bytes. Low bit 1 → bit-packed run of (header >> 1)
groups of 8 values at `width` bits, LSB-first.

The reference decodes this one value per virtual call (hybrid_decoder.go:81-113,
the hottest loop in the library, SURVEY §3.1). Here decode is two phases:

  1. `prescan` — a cheap sequential byte-level walk of the run *headers* only,
     producing a run table (kind, count, value, payload offset). This touches a
     tiny fraction of the data and is the only inherently sequential part
     (SURVEY §7.3 hard-part #1).
  2. expansion — fully vectorized/parallel: RLE runs become broadcasts,
     bit-packed runs become one batched unpack. On host this is NumPy; on the
     GPU the same run table drives the expansion kernel
     (kernels/csrc/expand_hybrid.cu).

Encoding: unlike the reference, which only ever emits bit-packed runs
(reference: hybrid_encoder.go:55-70, README.md:42), `encode_hybrid` emits RLE
runs for 8-aligned stretches of repeated values — strictly smaller output for
level streams and low-cardinality dictionaries, still spec-conformant.

On the host the prescan, the one-shot decode and the encode each run as one
native pass of the port's host library (native/prepare.cc, native/values.cc);
`prescan_hybrid_plain`, `decode_hybrid_plain` and `encode_hybrid_plain` are
the Python versions the tests hold them against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bitpack import pack_bits, unpack_bits
from .varint import emit_uvarint as _emit_uvarint, read_uvarint

__all__ = [
    "RunTable",
    "prescan_hybrid",
    "prescan_hybrid_plain",
    "decode_hybrid",
    "decode_hybrid_plain",
    "expand_runs",
    "encode_hybrid",
    "encode_hybrid_plain",
]


class HybridError(ValueError):
    pass


@dataclass
class RunTable:
    """Prescanned hybrid stream: one row per run.

    is_rle[i]       True for RLE runs
    counts[i]       number of values produced by run i (bit-packed: groups*8)
    rle_values[i]   the repeated value (0 for bit-packed runs)
    bp_offsets[i]   byte offset of run i's packed payload within `packed` (RLE: 0)
    packed          all bit-packed payload bytes, concatenated
    consumed        bytes of the input stream consumed (headers + payloads)
    """

    is_rle: np.ndarray
    counts: np.ndarray
    rle_values: np.ndarray
    bp_offsets: np.ndarray
    packed: bytes
    consumed: int

    @property
    def total_values(self) -> int:
        return int(self.counts.sum())


def prescan_hybrid(data, num_values: int, width: int) -> RunTable:
    """Walk run headers until `num_values` values are covered: one native
    pass (ptq_prescan_hybrid), then the packed payloads compacted as the JAX
    package compacts them. `prescan_hybrid_plain` is its oracle.

    Validates every count and payload size before accepting it, per the
    reference's validation-before-allocation discipline (reference:
    hybrid_decoder.go:126-129, SURVEY §5 failure handling).
    """
    if width < 0 or width > 64:
        raise HybridError(f"hybrid: invalid bit width {width}")
    from ..utils.native import get_native

    try:
        is_rle, counts, values, offsets, consumed = get_native().prescan_hybrid(
            data, num_values, width
        )
    except ValueError as e:
        raise HybridError(f"hybrid: {e}") from e
    # Compact the packed buffer to just the bit-packed payloads so device
    # buffers sized by len(packed) don't scale with RLE-heavy streams.
    new_offsets = np.zeros(len(counts), dtype=np.int64)
    bp_idx = np.flatnonzero(~is_rle)
    if len(bp_idx) == 0:
        packed = b""
    else:
        nb = (counts[bp_idx] // 8) * width
        offs = offsets[bp_idx]
        if len(bp_idx) > 1:
            new_offsets[bp_idx[1:]] = np.cumsum(nb[:-1])
        if len(bp_idx) == 1 or bool(np.all(offs[1:] == offs[:-1] + nb[:-1])):
            # payload regions are back-to-back (the no-RLE common case):
            # one zero-copy slice of the input
            mv = memoryview(data) if not isinstance(data, memoryview) else data
            packed = mv[int(offs[0]) : int(offs[0] + nb.sum())]
        else:
            packed = b"".join(
                data[o : o + n] for o, n in zip(offs.tolist(), nb.tolist())
            )
    return RunTable(
        is_rle=is_rle,
        counts=counts,
        rle_values=values,
        bp_offsets=new_offsets,
        packed=packed,
        consumed=consumed,
    )


def prescan_hybrid_plain(data, num_values: int, width: int) -> RunTable:
    """`prescan_hybrid` as a Python walk over the run headers: the oracle the
    tests hold the native prescan against."""
    if width < 0 or width > 64:
        raise HybridError(f"hybrid: invalid bit width {width}")
    buf = memoryview(data) if not isinstance(data, memoryview) else data
    end = len(buf)
    vbytes = (width + 7) // 8
    pos = 0
    produced = 0
    kinds: list[bool] = []
    counts: list[int] = []
    values: list[int] = []
    offsets: list[int] = []
    packed_parts: list[bytes] = []
    packed_len = 0
    while produced < num_values:
        header, pos = read_uvarint(buf, pos, end, HybridError)
        if header & 1:
            groups = header >> 1
            count = groups * 8
            nbytes = groups * width
            if count == 0:
                raise HybridError("hybrid: empty bit-packed run")
            if pos + nbytes > end:
                raise HybridError("hybrid: bit-packed payload exceeds buffer")
            kinds.append(False)
            counts.append(count)
            values.append(0)
            offsets.append(packed_len)
            packed_parts.append(bytes(buf[pos : pos + nbytes]))
            packed_len += nbytes
            pos += nbytes
        else:
            count = header >> 1
            if count == 0:
                raise HybridError("hybrid: empty RLE run")
            if pos + vbytes > end:
                raise HybridError("hybrid: RLE value exceeds buffer")
            v = int.from_bytes(buf[pos : pos + vbytes], "little")
            if width < 64 and v >= (1 << width):
                raise HybridError(
                    f"hybrid: RLE value {v} does not fit bit width {width}"
                )
            pos += vbytes
            kinds.append(True)
            counts.append(count)
            values.append(v)
            offsets.append(0)
        produced += count
    return RunTable(
        is_rle=np.array(kinds, dtype=bool),
        counts=np.array(counts, dtype=np.int64),
        rle_values=np.array(values, dtype=np.uint64),
        bp_offsets=np.array(offsets, dtype=np.int64),
        packed=b"".join(packed_parts),
        consumed=pos,
    )


def expand_runs(table: RunTable, num_values: int, width: int, dtype=np.uint32) -> np.ndarray:
    """Vectorized expansion of a prescanned run table into a value array.

    No per-run Python loop (adversarial streams can hold millions of
    one-value runs): RLE positions broadcast via np.repeat of the run
    table, bit-packed positions gather from one unpack of the whole packed
    buffer — both O(values) in C.
    """
    counts = table.counts.astype(np.int64)
    k = len(counts)
    if k == 0 or num_values == 0:
        if num_values > 0:
            raise HybridError(
                f"hybrid: stream produced 0 values, expected {num_values}"
            )
        return np.empty(0, dtype=dtype)
    ends = np.cumsum(counts)
    if int(ends[-1]) < num_values:
        raise HybridError(
            f"hybrid: stream produced {int(ends[-1])} values, expected {num_values}"
        )
    # clamp to the first k' runs covering num_values; partial last run
    kp = int(np.searchsorted(ends, num_values, side="left")) + 1
    takes = counts[:kp].copy()
    takes[kp - 1] = num_values - (int(ends[kp - 2]) if kp > 1 else 0)
    is_rle = np.asarray(table.is_rle[:kp], dtype=bool)
    out = np.empty(num_values, dtype=dtype)
    run_of = np.repeat(np.arange(kp), takes)  # run index at each position
    rle_pos = is_rle[run_of]
    if rle_pos.any():
        out[rle_pos] = table.rle_values[:kp].astype(dtype)[run_of[rle_pos]]
    if not rle_pos.all():
        # one unpack of every bit-packed payload (payloads are dense:
        # counts are multiples of 8), then a gather by global bp index
        bp_counts = np.where(is_rle, 0, counts[:kp])
        bp_total = int(bp_counts.sum())
        if width == 0:
            out[~rle_pos] = 0
        else:
            first_off = int(table.bp_offsets[:kp][~is_rle][0])
            bp_vals = unpack_bits(
                table.packed[first_off : first_off + (bp_total // 8) * width],
                bp_total,
                width,
                dtype=dtype,
            )
            bp_base = np.zeros(kp, dtype=np.int64)
            np.cumsum(bp_counts[:-1], out=bp_base[1:])
            starts = np.zeros(kp, dtype=np.int64)
            np.cumsum(takes[:-1], out=starts[1:])
            # index math only over the bit-packed positions: temporaries
            # scale with the bp count, not num_values (a stream that is one
            # huge RLE run plus 8 bp values should not allocate 16B/value)
            bp_pos = np.flatnonzero(~rle_pos)
            bp_runs = run_of[bp_pos]
            out[bp_pos] = bp_vals[bp_base[bp_runs] + (bp_pos - starts[bp_runs])]
    return out


def decode_hybrid(data, num_values: int, width: int, dtype=np.uint32) -> np.ndarray:
    """One-shot host decode: one native pass (ptq_hybrid_decode) into 32- or
    64-bit lanes, viewed or cast to `dtype`. `decode_hybrid_plain` is its
    oracle."""
    if num_values == 0:
        return np.empty(0, dtype=dtype)
    if width < 0 or width > 64:
        raise HybridError(f"hybrid: invalid bit width {width}")
    from ..utils.native import get_native

    nbits = 32 if width <= 32 else 64
    try:
        out, _ = get_native().hybrid_decode(data, num_values, width, nbits)
    except ValueError as e:
        raise HybridError(f"hybrid: {e}") from e
    want = np.dtype(dtype)
    if want == out.dtype:
        return out
    if want.itemsize == out.dtype.itemsize:  # e.g. int32 view of uint32
        return out.view(want)
    return out.astype(want)


def decode_hybrid_plain(data, num_values: int, width: int, dtype=np.uint32) -> np.ndarray:
    """`decode_hybrid` as the Python prescan + the vectorized expansion: the
    oracle the tests hold the native decode against."""
    if num_values == 0:
        return np.empty(0, dtype=dtype)
    table = prescan_hybrid_plain(data, num_values, width)
    return expand_runs(table, num_values, width, dtype=dtype)


def encode_hybrid(values, width: int) -> bytes:
    """Encode values as a hybrid stream.

    8-aligned stretches of ≥8 identical values become RLE runs; everything else
    is bit-packed in groups of 8 (the trailing partial group is zero-padded,
    which the decoder discards — padding only ever appears at stream end).
    """
    v = np.asarray(values)
    n = len(v)
    if n == 0:
        return b""
    if width == 0:
        # Single RLE run covering everything; value occupies 0 bytes.
        out = bytearray()
        _emit_uvarint(out, n << 1)
        return bytes(out)
    if width < 0 or width > 64:
        raise HybridError(f"hybrid: invalid bit width {width}")
    from ..utils.native import get_native

    # one native pass (ptq_hybrid_encode), byte-identical to
    # encode_hybrid_plain: the write path's hottest loop
    return get_native().hybrid_encode(v.astype(np.uint64, copy=False), width)


def encode_hybrid_plain(values, width: int) -> bytes:
    """`encode_hybrid` as a NumPy run split and a Python loop over the runs:
    the oracle the tests hold the native encoder against."""
    v = np.asarray(values)
    n = len(v)
    if n == 0:
        return b""
    if width == 0:
        out = bytearray()
        _emit_uvarint(out, n << 1)
        return bytes(out)
    v64 = v.astype(np.uint64, copy=False)
    run_starts = np.nonzero(np.concatenate(([True], v64[1:] != v64[:-1])))[0]
    run_lengths = np.diff(np.append(run_starts, n))
    out = bytearray()
    vbytes = (width + 7) // 8
    pos = 0
    for start, length in zip(run_starts, run_lengths):
        if length < 8:
            continue
        # 8-align the RLE window so surrounding bit-packed segments stay
        # multiples of 8 values (mid-stream padding would shift the stream).
        rle_start = (int(start) + 7) & ~7
        rle_end = (int(start) + int(length)) & ~7
        if rle_end - rle_start < 8:
            continue
        if rle_start > pos:
            _emit_bitpacked(out, v64[pos:rle_start], width)
        _emit_uvarint(out, (rle_end - rle_start) << 1)
        out += int(v64[start]).to_bytes(vbytes, "little")
        pos = rle_end
    if pos < n:
        _emit_bitpacked(out, v64[pos:n], width, pad=True)
    return bytes(out)


def _emit_bitpacked(out: bytearray, vals: np.ndarray, width: int, pad: bool = False) -> None:
    n = len(vals)
    if n == 0:
        return
    if n % 8:
        if not pad:
            raise HybridError("hybrid: internal — unaligned bit-packed segment")
        vals = np.concatenate([vals, np.zeros(8 - n % 8, dtype=vals.dtype)])
    groups = len(vals) // 8
    _emit_uvarint(out, (groups << 1) | 1)
    out += pack_bits(vals, width)
