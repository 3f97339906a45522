"""DELTA_BINARY_PACKED codec (host path) + block-table prescan for the device path.

Wire format (parquet-format Encodings.md; same semantics as the reference's
deltabp_decoder.go/deltabp_encoder.go): ULEB128 header <block size> <miniblocks
per block> <total value count> <first value: zigzag>, then per block: <min
delta: zigzag> <one width byte per miniblock> <bit-packed miniblock payloads>.

Semantics reproduced from the reference (SURVEY §7.3 hard-part #2):
  - all delta arithmetic wraps at the type width — min-delta subtraction can
    overflow by design (reference: deltabp_encoder.go:58-61), so decode runs in
    unsigned modular arithmetic and bit-casts at the end;
  - a miniblock that holds >=1 value always carries its full payload,
    (miniblock_len/8)*width bytes, zero-padded (reference: deltabp_decoder.go
    buf construction in flush());
  - unused trailing miniblocks carry a width byte but NO payload; writers
    should set those widths to 0 but readers must accept arbitrary values
    (parquet-format Encodings.md; the reference writes 0-width there,
    deltabp_encoder.go flush()).

The reference decodes one value per call through a virtual unpacker table
(deltabp_decoder.go:113-174); here the whole stream becomes one concatenated
(delta + min_delta) vector and a single wrapping cumulative sum — an associative
scan, which is exactly what the device kernel parallelizes
(kernels/csrc/delta_packed_decode.cu).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bitpack import pack_bits, unpack_bits
from .varint import emit_uvarint as _emit_uvarint_impl, emit_zigzag as _emit_zigzag_impl, read_uvarint, read_zigzag

__all__ = [
    "DeltaError",
    "decode_delta",
    "decode_delta_plain",
    "encode_delta",
    "encode_delta_plain",
    "prescan_delta",
    "prescan_delta_packed",
    "DeltaTable",
    "DeltaPackedTable",
]

# Defaults carried over from the reference (chunk_writer.go:53-57,69-73).
DEFAULT_BLOCK_SIZE = 128
DEFAULT_MINIBLOCKS = 4


class DeltaError(ValueError):
    pass




@dataclass
class DeltaTable:
    """Prescanned delta stream, ready for parallel expansion.

    deltas_plus_min  uint64 array of length total-1: (raw delta + block min_delta)
                     mod 2**nbits, in order
    first_value      unsigned first value (mod 2**nbits)
    total            total value count from the header
    consumed         bytes consumed from the input
    """

    deltas_plus_min: np.ndarray
    first_value: int
    total: int
    consumed: int


def prescan_delta(data, nbits: int, max_total: int | None = None) -> DeltaTable:
    """Parse headers + unpack miniblocks into a flat modular-delta vector.

    The header walk is sequential but touches only varints and width bytes; the
    miniblock unpacking is vectorized per miniblock. `max_total` bounds the
    header's value count before any allocation (validation-before-allocation,
    reference: SURVEY §5) — callers pass the page/chunk value count.
    """
    if nbits not in (32, 64):
        raise DeltaError(f"delta: unsupported type width {nbits}")
    mask = (1 << nbits) - 1
    buf = memoryview(data) if not isinstance(data, memoryview) else data
    end = len(buf)
    pos = 0
    block_size, pos = read_uvarint(buf, pos, end, DeltaError)
    mini_count, pos = read_uvarint(buf, pos, end, DeltaError)
    total, pos = read_uvarint(buf, pos, end, DeltaError)
    first, pos = read_zigzag(buf, pos, end, DeltaError)
    if block_size <= 0 or block_size % 128 != 0 or block_size > (1 << 20):
        raise DeltaError(f"delta: invalid block size {block_size}")
    if mini_count <= 0 or mini_count > 512 or block_size % mini_count != 0:
        raise DeltaError(f"delta: invalid miniblock count {mini_count}")
    mini_len = block_size // mini_count
    if mini_len % 8 != 0:
        raise DeltaError(f"delta: miniblock length {mini_len} not a multiple of 8")
    if max_total is not None and total > max(max_total, 0):
        raise DeltaError(
            f"delta: stream claims {total} values, caller expects at most {max_total}"
        )
    # Absolute backstop: a tiny stream must not drive a huge allocation. Every
    # block needs at least 1 min-delta byte + mini_count width bytes, and
    # covers block_size values, so `end` bytes cannot encode more than:
    plausible = 1 + (end // (1 + mini_count) + 1) * block_size
    if total > plausible:
        raise DeltaError(
            f"delta: implausible value count {total} for {end}-byte stream"
        )

    n_deltas = max(total - 1, 0)
    parts: list[np.ndarray] = []
    produced = 0
    while produced < n_deltas:
        min_delta, pos = read_zigzag(buf, pos, end, DeltaError)
        if pos + mini_count > end:
            raise DeltaError("delta: truncated miniblock widths")
        widths = bytes(buf[pos : pos + mini_count])
        pos += mini_count
        md = np.uint64(min_delta & mask)
        for w in widths:
            remaining = n_deltas - produced
            if remaining <= 0:
                # Unused trailing miniblock: no payload on the wire; the width
                # byte may hold any value (Encodings.md).
                continue
            if w > nbits:
                raise DeltaError(f"delta: miniblock width {w} exceeds type width")
            payload = (mini_len // 8) * w
            if pos + payload > end:
                raise DeltaError("delta: miniblock payload exceeds buffer")
            take = min(mini_len, remaining)
            if w == 0:
                vals = np.zeros(take, dtype=np.uint64)
            else:
                vals = unpack_bits(buf[pos : pos + payload], take, w, dtype=np.uint64)
            if nbits == 32:
                vals = (vals + md) & np.uint64(0xFFFFFFFF)
            else:
                vals = vals + md  # uint64 wraps naturally
            parts.append(vals)
            pos += payload
            produced += take
    deltas = (
        np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)
    )
    return DeltaTable(
        deltas_plus_min=deltas,
        first_value=first & mask,
        total=total,
        consumed=pos,
    )


@dataclass
class DeltaPackedTable:
    """Header-only prescan of a delta stream: payload bytes stay *packed*.

    The device path uploads the wire bytes plus these tiny tables and unpacks
    on device (kernels/device_ops.py delta_packed_decode) — the upload is
    the encoded size, not 8 bytes/value. One entry per miniblock that covers
    >=1 real delta (zero-width miniblocks included: they still carry the
    block's min_delta).
    """

    widths: np.ndarray  # uint32[M]
    byte_starts: np.ndarray  # int64[M], payload offset in the stream
    out_starts: np.ndarray  # int32[M], delta index (0-based) at miniblock start
    mins: np.ndarray  # uint64[M], block min_delta mod 2**nbits
    first_value: int  # unsigned first value (mod 2**nbits)
    total: int  # value count from the header
    consumed: int  # bytes consumed from the input


def prescan_delta_packed(data, nbits: int, max_total: int | None = None) -> DeltaPackedTable:
    """Walk delta block/miniblock *headers* only; never unpack payloads.

    Same validation discipline as prescan_delta (reference:
    deltabp_decoder.go:51-111 header sanity); the payload bytes are left in
    place for the device kernel.
    """
    if nbits not in (32, 64):
        raise DeltaError(f"delta: unsupported type width {nbits}")
    mask = (1 << nbits) - 1
    buf = memoryview(data) if not isinstance(data, memoryview) else data
    end = len(buf)
    pos = 0
    block_size, pos = read_uvarint(buf, pos, end, DeltaError)
    mini_count, pos = read_uvarint(buf, pos, end, DeltaError)
    total, pos = read_uvarint(buf, pos, end, DeltaError)
    first, pos = read_zigzag(buf, pos, end, DeltaError)
    if block_size <= 0 or block_size % 128 != 0 or block_size > (1 << 20):
        raise DeltaError(f"delta: invalid block size {block_size}")
    if mini_count <= 0 or mini_count > 512 or block_size % mini_count != 0:
        raise DeltaError(f"delta: invalid miniblock count {mini_count}")
    mini_len = block_size // mini_count
    if mini_len % 8 != 0:
        raise DeltaError(f"delta: miniblock length {mini_len} not a multiple of 8")
    if max_total is not None and total > max(max_total, 0):
        raise DeltaError(
            f"delta: stream claims {total} values, caller expects at most {max_total}"
        )
    plausible = 1 + (end // (1 + mini_count) + 1) * block_size
    if total > plausible:
        raise DeltaError(
            f"delta: implausible value count {total} for {end}-byte stream"
        )

    n_deltas = max(total - 1, 0)
    widths: list[int] = []
    byte_starts: list[int] = []
    out_starts: list[int] = []
    mins: list[int] = []
    produced = 0
    while produced < n_deltas:
        min_delta, pos = read_zigzag(buf, pos, end, DeltaError)
        if pos + mini_count > end:
            raise DeltaError("delta: truncated miniblock widths")
        wbytes = bytes(buf[pos : pos + mini_count])
        pos += mini_count
        md = min_delta & mask
        for w in wbytes:
            remaining = n_deltas - produced
            if remaining <= 0:
                continue  # unused trailing miniblock: width byte, no payload
            if w > nbits:
                raise DeltaError(f"delta: miniblock width {w} exceeds type width")
            payload = (mini_len // 8) * w
            if pos + payload > end:
                raise DeltaError("delta: miniblock payload exceeds buffer")
            widths.append(w)
            byte_starts.append(pos)
            out_starts.append(produced)
            mins.append(md)
            pos += payload
            produced += min(mini_len, remaining)
    return DeltaPackedTable(
        widths=np.array(widths, dtype=np.uint32),
        byte_starts=np.array(byte_starts, dtype=np.int64),
        out_starts=np.array(out_starts, dtype=np.int32),
        mins=np.array(mins, dtype=np.uint64),
        first_value=first & mask,
        total=total,
        consumed=pos,
    )


def decode_delta(data, nbits: int, max_total: int | None = None) -> tuple[np.ndarray, int]:
    """Decode a full DELTA_BINARY_PACKED stream in one native pass
    (ptq_delta_decode, after ptq_delta_peek_total sizes the output).

    Returns (values as int32/int64 ndarray, bytes consumed). The count comes
    from the stream header; `max_total` (the page/chunk value count) bounds it
    before allocation. `decode_delta_plain` is its oracle.
    """
    if nbits not in (32, 64):
        raise DeltaError(f"delta: unsupported type width {nbits}")
    from ..utils.native import get_native

    try:
        return get_native().delta_decode(data, nbits, max_total)
    except OverflowError as e:
        raise DeltaError(f"delta: {e}") from e
    except ValueError as e:
        raise DeltaError(f"delta: {e}") from e


def decode_delta_plain(data, nbits: int, max_total: int | None = None) -> tuple[np.ndarray, int]:
    """`decode_delta` as the Python prescan and one wrapping NumPy cumsum:
    the oracle the tests hold the native decode against."""
    t = prescan_delta(data, nbits, max_total)
    if nbits == 32:
        seq = np.empty(t.total, dtype=np.uint32)
        if t.total:
            seq[0] = t.first_value
            if t.total > 1:
                seq[1:] = np.cumsum(t.deltas_plus_min.astype(np.uint32), dtype=np.uint32)
                seq[1:] += np.uint32(t.first_value)
        return seq.view(np.int32), t.consumed
    seq = np.empty(t.total, dtype=np.uint64)
    if t.total:
        seq[0] = t.first_value
        if t.total > 1:
            seq[1:] = np.cumsum(t.deltas_plus_min, dtype=np.uint64)
            seq[1:] += np.uint64(t.first_value)
    return seq.view(np.int64), t.consumed


def encode_delta(
    values,
    nbits: int,
    block_size: int = DEFAULT_BLOCK_SIZE,
    mini_count: int = DEFAULT_MINIBLOCKS,
) -> bytes:
    """Encode int32/int64 values as DELTA_BINARY_PACKED in one native pass
    (ptq_delta_encode), byte-identical to `encode_delta_plain`, its oracle.
    A block shape no decoder takes (more than 512 miniblocks, miniblocks
    not a multiple of 8 values) raises DeltaError."""
    if nbits not in (32, 64):
        raise DeltaError(f"delta: unsupported type width {nbits}")
    from ..utils.native import get_native

    try:
        return get_native().delta_encode(values, nbits, block_size, mini_count)
    except ValueError as e:
        raise DeltaError(f"delta: {e} (block size {block_size}, {mini_count} miniblocks)") from e


def encode_delta_plain(
    values,
    nbits: int,
    block_size: int = DEFAULT_BLOCK_SIZE,
    mini_count: int = DEFAULT_MINIBLOCKS,
) -> bytes:
    """`encode_delta` in NumPy and a Python loop over the blocks: the oracle
    the tests hold the native encoder against."""
    if nbits not in (32, 64):
        raise DeltaError(f"delta: unsupported type width {nbits}")
    mask = (1 << nbits) - 1
    udtype = np.uint32 if nbits == 32 else np.uint64
    sdtype = np.int32 if nbits == 32 else np.int64
    v = np.asarray(values, dtype=sdtype).view(udtype)
    n = len(v)
    mini_len = block_size // mini_count

    out = bytearray()
    _emit_uvarint(out, block_size)
    _emit_uvarint(out, mini_count)
    _emit_uvarint(out, n)
    first = int(v[0]) if n else 0
    _emit_zigzag(out, _to_signed(first, nbits))
    if n <= 1:
        return bytes(out)

    # Wrapping deltas in unsigned arithmetic.
    deltas = (v[1:] - v[:-1]).astype(udtype)
    sdeltas = deltas.view(sdtype)
    for block_start in range(0, len(deltas), block_size):
        block = deltas[block_start : block_start + block_size]
        sblock = sdeltas[block_start : block_start + block_size]
        min_delta = int(sblock.min())
        _emit_zigzag(out, min_delta)
        adj = (block - udtype(min_delta & mask)).astype(udtype)
        widths = []
        payloads = []
        for m in range(mini_count):
            mini = adj[m * mini_len : (m + 1) * mini_len]
            if len(mini) == 0:
                widths.append(0)
                payloads.append(b"")
                continue
            w = int(mini.max()).bit_length()
            widths.append(w)
            if len(mini) < mini_len:
                mini = np.concatenate([mini, np.zeros(mini_len - len(mini), dtype=udtype)])
            payloads.append(pack_bits(mini, w) if w else b"")
        out += bytes(widths)
        for p in payloads:
            out += p
    return bytes(out)


_emit_uvarint = _emit_uvarint_impl
_emit_zigzag = _emit_zigzag_impl


def _to_signed(v: int, nbits: int) -> int:
    if v >= 1 << (nbits - 1):
        v -= 1 << nbits
    return v




