"""Batched page-decode pipeline: column chunks into device memory.

The port of the decode half of parquet_tpu/kernels/pipeline.py. The host
walks pages, parses Thrift headers, decompresses blocks and decodes R/D
levels; the value streams of a whole chunk are fused into one batch of
upload buffers and decoded by the kernels in device_ops.py:

  RLE_DICTIONARY  all pages' run tables concatenate into one table (bit
                  offsets rebased into one packed buffer, output starts into
                  one output index space, run counts clamped to each page's
                  real value count) -> ONE expand_hybrid launch per batch,
                  then one dict_gather against the dictionary (numeric) or
                  the indices plus the uploaded dictionary (byte arrays).
  DELTA_BP        all pages' wire streams concatenate with per-miniblock and
                  per-page tables -> ONE delta_packed_decode launch per batch.
  PLAIN numeric   the pages' raw little-endian values, one upload.

Chunks that mix device-routable pages with host-decoded ones are demoted to
host decode and one upload (_commit_routes), exactly as the JAX staged walk
does, so DecodeStats counts the same pages for the same file.

The decode of one chunk runs in two phases:

  prepare_chunk_plan()     host-only: page walk, decompress, levels,
                           prescan, frozen upload buffers.
  plan.dispatch_device()   uploads + kernel launches on the given device
                           (torch.cuda's current stream; nothing syncs).
  plan.device_column()     the decoded values resident on the device.
  plan.finalize()          fetches and reassembles a host ChunkData equal
                           to core.chunk.read_chunk (the parity oracle).

Buffer shapes are padded to power-of-two buckets exactly as the JAX package
pads them, so the frozen upload buffers are byte-identical to its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.arrays import ByteArrayData
from ..core.chunk import ChunkData, ChunkError, _check_crc, iter_chunk_pages
from ..core.compress import decompress_block
from ..core.page import (
    MissingDictionaryError,
    PageError,
    _decode_values,
    decode_dict_page,
    typed_page_errors,
)
from ..core.schema import Column
from ..meta.parquet_types import Encoding, PageType, Type
from ..ops.delta import decode_delta, prescan_delta_packed
from ..ops.levels import decode_levels_v1, decode_levels_v2
from ..ops.rle_hybrid import expand_runs, prescan_hybrid
from .device_ops import (
    MAX_DEVICE_BATCH_BITS,
    bytes_to_words32,
    bytes_to_words64,
    delta_packed_decode,
    dict_gather,
    expand_hybrid,
)

__all__ = [
    "DecodeStats",
    "DeviceColumn",
    "prepare_chunk_plan",
    "plan_chunk_device",
    "read_chunk_device",
    "to_device",
]

# Patchable in tests to force multi-batch splitting on small inputs.
_BATCH_BITS_CAP = MAX_DEVICE_BATCH_BITS


def _bucket(n: int, floor: int = 1024) -> int:
    """Next power-of-two bucket >= n (>= floor)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def to_device(host: np.ndarray, device) -> torch.Tensor:
    """Copy a host array to `device` (a read-only buffer is copied on the
    host first: torch refuses to alias one)."""
    host = np.require(host, requirements=["C", "W"])
    return torch.from_numpy(host).to(device)


class _FrozenHybrid(NamedTuple):
    """Upload-ready hybrid batch (built in prepare; dispatched by transfer)."""

    buf: np.ndarray
    width: int
    n_pad: int
    run_pad: int
    total: int


class _FrozenDelta(NamedTuple):
    """Upload-ready delta batch (built in prepare; dispatched by transfer)."""

    meta32: np.ndarray
    wide: np.ndarray
    nbits: int
    n_pad: int
    m_pad: int
    p_pad: int
    total: int


@dataclass
class DecodeStats:
    """Page routing counts (the counterpart of the JAX TpuDecodeStats)."""

    pages: int = 0
    device_values: int = 0
    host_fallback_pages: int = 0
    device_batches: int = 0


_NUMERIC_DTYPE = {
    Type.INT32: np.int32,
    Type.INT64: np.int64,
    Type.FLOAT: np.float32,
    Type.DOUBLE: np.float64,
}


# -- per-chunk batch assembly --------------------------------------------------


class _HybridBatch:
    """Concatenated, clamped run tables of dict-encoded pages of a chunk.

    Run counts are clamped so each page contributes exactly its real value
    count to the output index space (the final bit-packed group of a page may
    encode up to 7 padding values; clamping the last run's count drops them
    without touching bit offsets). The device expansion therefore yields the
    concatenation of all pages' values directly.
    """

    def __init__(self, width: int):
        self.width = width
        self.is_rle: list[np.ndarray] = []
        self.counts: list[np.ndarray] = []
        self.values: list[np.ndarray] = []
        self.bit_starts: list[np.ndarray] = []
        self.packed: list[bytes] = []
        self.packed_bits = 0
        self.out_count = 0

    def fits(self, table, width: int) -> bool:
        return (
            width == self.width
            and self.packed_bits + len(table.packed) * 8 <= _BATCH_BITS_CAP
        )

    def add_page(self, table, take: int) -> None:
        counts = table.counts.astype(np.int64)
        cum = np.cumsum(counts)
        if take > (int(cum[-1]) if len(cum) else 0):
            raise PageError("page: hybrid run table shorter than value count")
        k = int(np.searchsorted(cum, take, side="left"))
        counts = counts[: k + 1].copy()
        counts[k] = take - (int(cum[k - 1]) if k else 0)
        self.is_rle.append(table.is_rle[: k + 1])
        self.counts.append(counts)
        self.values.append(table.rle_values[: k + 1])
        self.bit_starts.append(table.bp_offsets[: k + 1] * 8 + self.packed_bits)
        self.packed.append(table.packed)
        self.packed_bits += len(table.packed) * 8
        self.out_count += take

    def freeze(self) -> _FrozenHybrid:
        """Build the ONE packed upload buffer: [is_rle | out_start |
        rle_value | bit_start | words] (layout in csrc/expand_hybrid.cu)."""
        counts = np.concatenate(self.counts)
        out_start = np.zeros(len(counts), dtype=np.int64)
        np.cumsum(counts[:-1], out=out_start[1:])
        total = int(counts.sum())
        if total != self.out_count:
            raise PageError("page: hybrid batch count mismatch")
        n_pad = _bucket(max(total, 1))
        run_pad = _bucket(len(counts), 64)
        packed = b"".join(self.packed)
        words = bytes_to_words32(packed)
        w_pad = _bucket(len(words), 1024)
        buf = np.zeros(4 * run_pad + w_pad, dtype=np.uint32)
        buf[run_pad : 2 * run_pad] = np.int32(n_pad + 1).view(np.uint32)  # sentinel
        k = len(counts)
        buf[:k] = np.concatenate(self.is_rle)
        buf[run_pad : run_pad + k] = out_start.astype(np.int32).view(np.uint32)
        buf[2 * run_pad : 2 * run_pad + k] = np.concatenate(self.values).astype(
            np.uint32
        )
        buf[3 * run_pad : 3 * run_pad + k] = (
            np.concatenate(self.bit_starts).astype(np.int32).view(np.uint32)
        )
        buf[4 * run_pad : 4 * run_pad + len(words)] = words
        return _FrozenHybrid(buf, self.width, n_pad, run_pad, total)


def dispatch_hybrid(frozen: _FrozenHybrid, device) -> torch.Tensor:
    """Upload a frozen hybrid batch and expand it: int32[total]."""
    buf = to_device(frozen.buf.view(np.int32), device)
    return expand_hybrid(buf, frozen.width, frozen.run_pad, frozen.total)


class _DeltaBatch:
    """Concatenated *packed* delta streams of a chunk's pages.

    Only wire bytes + tiny per-miniblock/per-page tables go to the device;
    device_ops.delta_packed_decode unpacks + prefix-sums everything in one
    launch, segmented per page."""

    def __init__(self, nbits: int):
        self.nbits = nbits
        self.streams: list[bytes] = []
        self.stream_bytes = 0
        self.widths: list[np.ndarray] = []
        self.byte_starts: list[np.ndarray] = []
        self.out_starts: list[np.ndarray] = []
        self.mins: list[np.ndarray] = []
        self.page_starts: list[int] = []
        self.page_firsts: list[int] = []
        self.out_count = 0

    def fits(self, table) -> bool:
        return (self.stream_bytes + table.consumed) * 8 <= _BATCH_BITS_CAP

    def add_page(self, table, stream: bytes) -> None:
        if table.total == 0:
            return  # no values: nothing to contribute
        b = self.out_count
        self.widths.append(table.widths)
        self.byte_starts.append(table.byte_starts + self.stream_bytes)
        self.out_starts.append(table.out_starts + (b + 1))
        self.mins.append(table.mins)
        self.page_starts.append(b)
        self.page_firsts.append(table.first_value)
        self.streams.append(stream[: table.consumed])
        self.stream_bytes += table.consumed
        self.out_count += table.total

    def freeze(self) -> _FrozenDelta | None:
        """Build the packed uploads (layout in csrc/delta_packed_decode.cu):
        one for 32-bit values, two for 64-bit (tables at 32, words at 64)."""
        if not self.page_starts:
            return None
        nbits = self.nbits
        ud = np.uint32 if nbits == 32 else np.uint64
        total = self.out_count
        n_pad = _bucket(total)
        m = sum(len(w) for w in self.widths)
        m_pad = _bucket(max(m, 1), 64)
        p = len(self.page_starts)
        p_pad = _bucket(p, 64)
        sentinel = np.int32(n_pad + 1).view(np.uint32)
        stream = b"".join(self.streams)
        words = bytes_to_words32(stream) if nbits == 32 else bytes_to_words64(stream)
        w_pad = _bucket(len(words), 1024)
        tail32 = (2 * m_pad + 2 * p_pad + w_pad) if nbits == 32 else 0
        meta32 = np.zeros(3 * m_pad + p_pad + tail32, dtype=np.uint32)
        meta32[2 * m_pad : 3 * m_pad] = sentinel  # out_starts padding
        meta32[3 * m_pad : 3 * m_pad + p_pad] = sentinel  # page_start padding
        if m:
            meta32[:m] = np.concatenate(self.widths)
            meta32[m_pad : m_pad + m] = (
                (np.concatenate(self.byte_starts) * 8).astype(np.int32).view(np.uint32)
            )
            meta32[2 * m_pad : 2 * m_pad + m] = (
                np.concatenate(self.out_starts).astype(np.int32).view(np.uint32)
            )
        meta32[3 * m_pad : 3 * m_pad + p] = (
            np.asarray(self.page_starts, dtype=np.int32).view(np.uint32)
        )
        if nbits == 32:
            base = 3 * m_pad + p_pad
            if m:
                meta32[base : base + m] = np.concatenate(self.mins).astype(ud)
            meta32[base + m_pad : base + m_pad + p] = np.array(
                self.page_firsts, dtype=ud
            )
            meta32[base + m_pad + p_pad : base + m_pad + p_pad + len(words)] = words
            wide = np.zeros(0, dtype=np.uint32)
        else:
            wide = np.zeros(m_pad + p_pad + w_pad, dtype=np.uint64)
            if m:
                wide[:m] = np.concatenate(self.mins).astype(ud)
            wide[m_pad : m_pad + p] = np.array(self.page_firsts, dtype=ud)
            wide[m_pad + p_pad : m_pad + p_pad + len(words)] = words
        return _FrozenDelta(meta32, wide, nbits, n_pad, m_pad, p_pad, total)


def dispatch_delta(frozen: _FrozenDelta, device) -> torch.Tensor:
    """Upload a frozen delta batch and decode it: int32/int64[total]."""
    meta32 = to_device(frozen.meta32.view(np.int32), device)
    wide_np = frozen.wide.view(np.int32 if frozen.nbits == 32 else np.int64)
    wide = to_device(wide_np, device)
    return delta_packed_decode(
        meta32, wide, frozen.nbits, frozen.m_pad, frozen.p_pad, frozen.total
    )


# -- the chunk plan ------------------------------------------------------------


@dataclass
class DeviceColumn:
    """Decoded column delivered in device memory. Numeric columns carry
    `values` (real dtype; floats viewed on the device from their bit
    patterns). Byte-array columns carry `data` + int64 `offsets`, or — for
    dictionary-encoded chunks — `indices` (int32) plus the dictionary both
    host-side and as `dict_data`/`dict_offsets` on the device.

    def/rep levels stay host-side as uint16 NumPy arrays (record assembly
    is a host concern)."""

    num_values: int
    values: torch.Tensor | None = None
    indices: torch.Tensor | None = None
    dictionary: object | None = None  # host ByteArrayData | np.ndarray
    data: torch.Tensor | None = None  # uint8 payload (byte arrays)
    offsets: torch.Tensor | None = None  # int64 offsets, len = n + 1
    dict_data: torch.Tensor | None = None  # uint8 dictionary payload
    dict_offsets: torch.Tensor | None = None
    def_levels: np.ndarray | None = None
    rep_levels: np.ndarray | None = None


class _ChunkPlan:
    """Host-side record of one chunk's device decode."""

    def __init__(self, column: Column, expected: int):
        self.column = column
        self.expected = expected
        self.page_infos: list[tuple] = []  # (n, def, rep, kind, payload)
        self.dictionary = None
        self.dict_dev: torch.Tensor | None = None
        self.dev_hybrid: list[torch.Tensor] = []  # per batch, page order
        self.dev_delta: list[torch.Tensor] = []  # per batch, page order
        self.stats: DecodeStats | None = None
        # frozen upload buffers (built at the END of prepare, host-only)
        self.frozen_hybrid: list[_FrozenHybrid] = []
        self.frozen_delta: list[_FrozenDelta] = []
        self.plain_host: np.ndarray | None = None
        self.dev_plain: torch.Tensor | None = None
        self.device = None
        self._dispatched = False

    # -- device dispatch (nothing synchronizes here) ---------------------------

    def dispatch_device(self, device) -> "_ChunkPlan":
        """Upload the frozen buffers to `device` and launch the kernels."""
        if self._dispatched:
            return self
        self._dispatched = True
        self.device = torch.device(device)
        d = self.dictionary
        if self.frozen_hybrid and isinstance(d, np.ndarray) and d.ndim == 1:
            # The dictionary goes up only when device-decoded indices will
            # gather against it (device_column). Floats travel as bit
            # patterns: the gather is dtype-agnostic.
            if d.dtype.itemsize in (4, 8):
                u = np.int32 if d.dtype.itemsize == 4 else np.int64
                self.dict_dev = to_device(d.view(u), self.device)
        if self.plain_host is not None:
            self.dev_plain = _upload_typed(self.plain_host, self.device)
            self.plain_host = None
        stats = self.stats
        for frozen in self.frozen_hybrid:
            self.dev_hybrid.append(dispatch_hybrid(frozen, self.device))
            if stats is not None:
                stats.device_values += frozen.total
                stats.device_batches += 1
        for frozen in self.frozen_delta:
            self.dev_delta.append(dispatch_delta(frozen, self.device))
            if stats is not None:
                stats.device_values += frozen.total
                stats.device_batches += 1
        self.frozen_hybrid = []
        self.frozen_delta = []
        return self

    # -- fetch + host reassembly (equal to core.chunk.read_chunk) --------------

    def finalize(self) -> ChunkData:
        column = self.column
        hybrid_flat = _fetch(self.dev_hybrid, np.uint32)
        delta_flat = _fetch(self.dev_delta, None)
        pages_values = []
        all_def: list[np.ndarray] = []
        all_rep: list[np.ndarray] = []
        hpos = 0
        dpos = 0
        num_values_total = 0
        for n, dfl, rep, kind, payload in self.page_infos:
            num_values_total += n
            if dfl is not None:
                all_def.append(dfl)
            if rep is not None:
                all_rep.append(rep)
            if kind == "dict":
                idx = hybrid_flat[hpos : hpos + payload]
                hpos += payload
                pages_values.append(_materialize(self.dictionary, idx))
            elif kind == "indices":
                pages_values.append(_materialize(self.dictionary, payload))
            elif kind == "delta":
                if payload:
                    pages_values.append(delta_flat[dpos : dpos + payload])
                    dpos += payload
            elif kind == "values":
                pages_values.append(payload)
        if num_values_total != self.expected:
            raise ChunkError(
                f"chunk: pages hold {num_values_total} values, "
                f"metadata says {self.expected}"
            )
        return ChunkData(
            column=column,
            num_values=num_values_total,
            values=_concat_values(pages_values, column),
            def_levels=np.concatenate(all_def) if all_def else None,
            rep_levels=np.concatenate(all_rep) if all_rep else None,
            dictionary=self.dictionary,
        )

    # -- decode-to-device ------------------------------------------------------

    def device_column(self) -> DeviceColumn:
        """Deliver the chunk's decoded values in device memory. Shapes the
        device routes do not cover (byte-array PLAIN/delta pages, booleans,
        FLBA dictionaries, demoted mixed chunks) take host decode + one
        upload."""
        if not self._dispatched:
            raise RuntimeError("device_column: plan was not dispatched")
        column = self.column
        dev = self.device
        kinds = {k for _, _, _, k, _ in self.page_infos if k != "empty"}
        all_def = [d for _, d, _, _, _ in self.page_infos if d is not None]
        all_rep = [r for _, _, r, _, _ in self.page_infos if r is not None]
        out = DeviceColumn(
            num_values=sum(n for n, *_ in self.page_infos),
            def_levels=np.concatenate(all_def) if all_def else None,
            rep_levels=np.concatenate(all_rep) if all_rep else None,
        )

        if (
            kinds <= {"dict", "empty"}
            and self.dev_hybrid
            and (isinstance(self.dictionary, ByteArrayData) or self.dict_dev is not None)
        ):
            idx = self._dev_indices()
            if isinstance(self.dictionary, ByteArrayData):
                out.indices = idx
                out.dictionary = self.dictionary
                out.dict_data = to_device(
                    np.frombuffer(self.dictionary.data, dtype=np.uint8), dev
                )
                out.dict_offsets = to_device(self.dictionary.offsets, dev)
            else:
                out.values = _device_view(dict_gather(self.dict_dev, idx), column)
            return out

        if kinds <= {"delta", "empty"} and self.dev_delta:
            out.values = (
                self.dev_delta[0]
                if len(self.dev_delta) == 1
                else torch.cat(self.dev_delta)
            )
            return out

        if "values" in kinds and kinds <= {"values", "empty"} and column.type in _NUMERIC_DTYPE:
            if self.dev_plain is not None:
                out.values = self.dev_plain
            else:
                parts = [p for _, _, _, k, p in self.page_infos if k == "values"]
                host = parts[0] if len(parts) == 1 else np.concatenate(parts)
                out.values = _upload_typed(host, dev)
            return out

        # The JAX package's mixed dict/PLAIN device merges (numeric, DOUBLE
        # excluded; and byte arrays) serve chunks that only its native fused
        # walk leaves mixed: the staged walk demotes every mixed chunk in
        # _commit_routes, so they land here, as they do there.
        # Mixed, unsupported, or fully empty shapes: host decode, then upload.
        data = self.finalize()
        if isinstance(data.values, ByteArrayData):
            out.data = to_device(np.frombuffer(data.values.data, dtype=np.uint8), dev)
            out.offsets = to_device(data.values.offsets, dev)
        else:
            out.values = _upload_typed(np.asarray(data.values), dev)
        return out

    def _dev_indices(self) -> torch.Tensor:
        """All dispatched dict-index batches as one int32 device tensor."""
        return self.dev_hybrid[0] if len(self.dev_hybrid) == 1 else torch.cat(self.dev_hybrid)


def _fetch(parts: list, view):
    """Device batches -> one host array (None when there are none)."""
    if not parts:
        return None
    flat = torch.cat(parts) if len(parts) > 1 else parts[0]
    host = flat.cpu().numpy()
    return host.view(view) if view is not None else host


# -- the chunk decoder ---------------------------------------------------------


def plan_chunk_device(
    f,
    chunk,
    column: Column,
    device,
    validate_crc: bool = False,
    stats: DecodeStats | None = None,
) -> _ChunkPlan:
    """Host prepare + device dispatch for one chunk (the counterpart of the
    JAX plan_chunk_tpu). Call .finalize() for a host ChunkData or
    .device_column() to keep the decoded values on the device."""
    return prepare_chunk_plan(
        f, chunk, column, validate_crc=validate_crc, stats=stats
    ).dispatch_device(device)


def read_chunk_device(
    f,
    chunk,
    column: Column,
    device,
    validate_crc: bool = False,
    stats: DecodeStats | None = None,
) -> ChunkData:
    """Device-backend chunk decode with a fetch: levels on host, values on
    the device, reassembled equal to core.chunk.read_chunk (the counterpart
    of the JAX read_chunk_tpu)."""
    return plan_chunk_device(
        f, chunk, column, device, validate_crc=validate_crc, stats=stats
    ).finalize()


def prepare_chunk_plan(
    f,
    chunk,
    column: Column,
    validate_crc: bool = False,
    stats: DecodeStats | None = None,
) -> _ChunkPlan:
    """Host-only prepare: the per-page walk (decompress, level decode,
    prescan), then batch building or demotion to host decode. Touches no
    device; the returned plan goes to the device via plan.dispatch_device()."""
    md = chunk.meta_data
    codec = md.codec or 0
    expected = md.num_values or 0
    plan = _ChunkPlan(column, expected)
    plan.stats = stats
    ptype = column.type

    # Device-routable pages stage here until the whole chunk is walked; batch
    # building (or demotion to host decode) happens in _commit_routes.
    pending: list[tuple] = []

    for raw in iter_chunk_pages(f, chunk):
        header = raw.header
        pt = header.type
        if pt == int(PageType.DICTIONARY_PAGE):
            if plan.dictionary is not None:
                raise ChunkError("chunk: more than one dictionary page")
            if validate_crc:
                _check_crc(header, raw.payload)
            block = decompress_block(raw.payload, codec, header.uncompressed_page_size or 0)
            plan.dictionary = decode_dict_page(header, block, column)
            continue
        if pt == int(PageType.INDEX_PAGE):
            continue
        if pt not in (int(PageType.DATA_PAGE), int(PageType.DATA_PAGE_V2)):
            raise ChunkError(f"chunk: unknown page type {pt}")
        if validate_crc:
            _check_crc(header, raw.payload)

        n, dfl, rep, non_null, enc, values_buf = _split_page(
            raw, header, pt, codec, column
        )
        if stats is not None:
            stats.pages += 1

        # -- route the value stream --------------------------------------------
        if enc in (int(Encoding.RLE_DICTIONARY), int(Encoding.PLAIN_DICTIONARY)):
            if plan.dictionary is None:
                raise MissingDictionaryError(
                    "page: dictionary encoding without dictionary"
                )
            if non_null == 0:
                plan.page_infos.append((n, dfl, rep, "empty", None))
                continue
            width = values_buf[0] if values_buf else 0
            if width > 32:
                raise PageError(f"page: invalid dict index width {width}")
            with typed_page_errors("dict index stream"):
                table = prescan_hybrid(values_buf[1:], non_null, width)
            if len(table.packed) * 8 > _BATCH_BITS_CAP:
                # One page alone exceeds the int32 bit-offset range of the
                # kernel: decode it on host.
                plan.page_infos.append(
                    (n, dfl, rep, *_host_decode_dict_page(table, width, non_null, stats))
                )
                continue
            pending.append(("dict", len(plan.page_infos), table, width, non_null, None))
            plan.page_infos.append((n, dfl, rep, "dict", non_null))
        elif enc == int(Encoding.DELTA_BINARY_PACKED) and ptype in (
            Type.INT32,
            Type.INT64,
        ):
            nbits = 32 if ptype == Type.INT32 else 64
            with typed_page_errors("delta stream"):
                table = prescan_delta_packed(values_buf, nbits, max_total=non_null)
            if table.consumed * 8 > _BATCH_BITS_CAP:
                # Same int32-range guard as the hybrid path: host decode.
                plan.page_infos.append(
                    (n, dfl, rep, *_host_decode_delta_page(values_buf, nbits, non_null, stats))
                )
                continue
            pending.append(("delta", len(plan.page_infos), table, nbits, non_null, values_buf))
            plan.page_infos.append((n, dfl, rep, "delta", table.total))
        elif enc == int(Encoding.PLAIN) and ptype in _NUMERIC_DTYPE:
            dt = _NUMERIC_DTYPE[ptype]
            need = non_null * np.dtype(dt).itemsize
            if len(values_buf) < need:
                raise PageError("page: plain payload too short")
            vals = np.frombuffer(values_buf, dtype=dt, count=non_null)
            plan.page_infos.append((n, dfl, rep, "values", vals))
        else:
            # Anything else (byte arrays, boolean, deltas on other types):
            # host decode for this page.
            dict_size = len(plan.dictionary) if plan.dictionary is not None else None
            values, indices = _decode_values(
                values_buf, non_null, enc, column, dict_size
            )
            if indices is not None:
                plan.page_infos.append((n, dfl, rep, "indices", indices))
            else:
                plan.page_infos.append((n, dfl, rep, "values", values))
            if stats is not None:
                stats.host_fallback_pages += 1

    _commit_routes(plan, pending, stats)
    return plan


def _commit_routes(plan: _ChunkPlan, pending: list, stats) -> None:
    """Build device batches — or demote to host decode if the chunk's pages
    are not homogeneous.

    Device decode only pays when the whole chunk's values stay on device; a
    chunk that mixes device-kinds with host-kinds (e.g. pyarrow's mid-chunk
    dictionary->PLAIN fallback once the dict page overflows) decodes
    entirely on host and device_column does one typed upload."""
    kinds = {k for _, _, _, k, _ in plan.page_infos}
    kinds.discard("empty")
    pending_kinds = {p[0] for p in pending}
    # Homogeneous PLAIN numeric chunks: pre-concatenate the upload buffer
    # here (host-only) so dispatch is a single transfer.
    if kinds == {"values"} and not pending and plan.column.type in _NUMERIC_DTYPE:
        parts = [p for _, _, _, k, p in plan.page_infos if k == "values"]
        plan.plain_host = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return
    if kinds == pending_kinds and len(pending_kinds) == 1:
        hybrid_batches: list[_HybridBatch] = []
        delta_batches: list[_DeltaBatch] = []
        for kind, _idx, table, arg, non_null, buf in pending:
            if kind == "dict":
                if not hybrid_batches or not hybrid_batches[-1].fits(table, arg):
                    hybrid_batches.append(_HybridBatch(arg))
                hybrid_batches[-1].add_page(table, non_null)
            else:
                if not delta_batches or not delta_batches[-1].fits(table):
                    delta_batches.append(_DeltaBatch(arg))
                delta_batches[-1].add_page(table, buf)
        plan.frozen_hybrid = [b.freeze() for b in hybrid_batches]
        plan.frozen_delta = [
            f for f in (b.freeze() for b in delta_batches) if f is not None
        ]
        return
    # Demote: host-decode the would-be device pages in place.
    for kind, idx, table, arg, non_null, buf in pending:
        n, dfl, rep, _k, _p = plan.page_infos[idx]
        if kind == "dict":
            plan.page_infos[idx] = (
                n, dfl, rep, *_host_decode_dict_page(table, arg, non_null, stats)
            )
        else:
            plan.page_infos[idx] = (
                n, dfl, rep, *_host_decode_delta_page(buf, arg, non_null, stats)
            )
    # a demotion can leave the chunk all-'values' numeric: pre-concat so its
    # upload still happens at dispatch, not in device_column
    kinds_after = {k for _, _, _, k, _ in plan.page_infos}
    kinds_after.discard("empty")
    if kinds_after == {"values"} and plan.column.type in _NUMERIC_DTYPE:
        parts = [p for _, _, _, k, p in plan.page_infos if k == "values"]
        if parts:
            plan.plain_host = parts[0] if len(parts) == 1 else np.concatenate(parts)


def _host_decode_dict_page(table, width: int, non_null: int, stats):
    """Host fallback for a dict-coded page: ('indices', expanded indices)."""
    if stats is not None:
        stats.host_fallback_pages += 1
    return "indices", expand_runs(table, non_null, width, np.uint32)


def _host_decode_delta_page(values_buf, nbits: int, non_null: int, stats):
    """Host fallback for a delta page: ('values', decoded values)."""
    if stats is not None:
        stats.host_fallback_pages += 1
    with typed_page_errors("delta stream"):
        vals, _ = decode_delta(values_buf, nbits, max_total=non_null)
    return "values", vals[:non_null]


def _split_page(raw, header, pt, codec, column: Column):
    """Split a data page into levels (host-decoded) and the value stream."""
    if pt == int(PageType.DATA_PAGE):
        h = header.data_page_header
        if h is None:
            raise PageError("page: DATA_PAGE without data_page_header")
        n = h.num_values or 0
        block = decompress_block(raw.payload, codec, header.uncompressed_page_size or 0)
        buf = memoryview(block)
        pos = 0
        rep = None
        with typed_page_errors("v1 level stream"):
            if column.max_rep > 0:
                rep, used = decode_levels_v1(buf, n, column.max_rep)
                pos += used
            dfl = None
            non_null = n
            if column.max_def > 0:
                dfl, used, cv = decode_levels_v1(
                    buf[pos:], n, column.max_def, want_const=True
                )
                pos += used
                if cv is not None:
                    non_null = n if cv == column.max_def else 0
                else:
                    non_null = int((dfl == column.max_def).sum())
        return n, dfl, rep, non_null, h.encoding, buf[pos:]

    h = header.data_page_header_v2
    if h is None:
        raise PageError("page: DATA_PAGE_V2 without data_page_header_v2")
    n = h.num_values or 0
    rep_len = h.repetition_levels_byte_length or 0
    def_len = h.definition_levels_byte_length or 0
    buf = memoryview(raw.payload)
    if rep_len < 0 or def_len < 0 or rep_len + def_len > len(buf):
        raise ChunkError("chunk: v2 level sizes exceed page")
    with typed_page_errors("v2 level stream"):
        rep = (
            decode_levels_v2(buf[:rep_len], n, column.max_rep)
            if column.max_rep > 0
            else None
        )
        dfl = None
        non_null = n
        if column.max_def > 0:
            dfl, cv = decode_levels_v2(
                buf[rep_len : rep_len + def_len], n, column.max_def, want_const=True
            )
            if cv is not None:
                non_null = n if cv == column.max_def else 0
            else:
                non_null = int((dfl == column.max_def).sum())
    values_buf = buf[rep_len + def_len :]
    if h.is_compressed is None or h.is_compressed:
        un = (header.uncompressed_page_size or 0) - rep_len - def_len
        values_buf = decompress_block(values_buf, codec, max(un, 0))
    return n, dfl, rep, non_null, h.encoding, values_buf


_VIEW = {
    4: (np.int32, torch.float32),
    8: (np.int64, torch.float64),
}


def _device_view(vals: torch.Tensor, column: Column) -> torch.Tensor:
    """View gathered bit patterns as the column's real dtype."""
    if column.type == Type.FLOAT:
        return vals.view(torch.float32)
    if column.type == Type.DOUBLE:
        return vals.view(torch.float64)
    return vals


def _upload_typed(host: np.ndarray, device) -> torch.Tensor:
    """Upload a host array; floats travel as bit patterns and are viewed
    back as floats on the device."""
    if host.dtype.kind == "f" and host.dtype.itemsize in _VIEW:
        as_int, as_float = _VIEW[host.dtype.itemsize]
        return to_device(host.view(as_int), device).view(as_float)
    return to_device(host, device)


def _materialize(dictionary, indices):
    """Expand dictionary indices for host delivery. An index past the
    dictionary is corrupt input: surface it typed."""
    try:
        if isinstance(dictionary, ByteArrayData):
            return dictionary.take(np.asarray(indices, dtype=np.int64))
        return np.asarray(dictionary)[np.asarray(indices)]
    except (IndexError, ValueError) as e:
        raise PageError(f"page: dictionary index out of range: {e}") from e


def _concat_values(parts, column: Column):
    from ..core.chunk import _concat_byte_arrays, _empty_dtype

    parts = [p for p in parts if p is not None]
    if any(isinstance(p, ByteArrayData) for p in parts):
        return _concat_byte_arrays(parts)
    arrs = [np.asarray(p) for p in parts if len(p)]
    if arrs:
        return np.concatenate(arrs) if len(arrs) > 1 else arrs[0]
    if column.type == Type.BYTE_ARRAY:
        return ByteArrayData(offsets=np.zeros(1, dtype=np.int64), data=b"")
    return np.empty(0, dtype=_empty_dtype(column))
