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

  BYTE_STREAM_SPLIT 4-byte pages ship their byte streams raw, one (4, n_pad)
                  staging each -> one bss_transpose launch per chunk (per
                  64 pages), writing the pages one after another.
  Mixed chunks    dict pages with a mid-chunk fall-back to PLAIN pages (a
                  writer's dictionary passing its size limit): the dict
                  batches expand as above and one merge launch joins them
                  with the PLAIN upload in row order (merge_mixed_numeric;
                  merge_mixed_bytes for byte arrays).

Host prepare is the fused native walk (utils/native.chunk_prepare: one C
call per chunk does header parse, decompress, level decode and prescan) and
_plan_from_tables; a chunk the walk declines or aborts on takes the staged
per-page Python walk, the error-semantics reference, which raises the exact
typed error on a genuinely corrupt chunk (the fused -> staged -> raise
ladder of the JAX pipeline). PQT_FUSED_PREPARE=0 forces the staged walk. The
staged walk demotes chunks that mix device-routable pages with host-decoded
ones to host decode and one upload (_commit_routes); the fused walk keeps
the JAX routing exactly, so DecodeStats counts the same pages for the same
file as TpuDecodeStats does on either walk.

The decode of one chunk runs in two phases:

  prepare_chunk_plan()     host-only: page walk, decompress, levels,
                           prescan, frozen upload buffers.
  plan.dispatch_device()   uploads + kernel launches on the given device
                           (the current stream, the dispatch thread's when
                           a reader stages the plan; nothing syncs), then
                           an event recorded after them.
  plan.device_column()     the decoded values resident on the device; the
                           caller's stream first waits on that event.
  plan.finalize()          fetches and reassembles a host ChunkData equal
                           to core.chunk.read_chunk (the parity oracle).

Buffer shapes are padded to power-of-two buckets exactly as the JAX package
pads them, so the frozen upload buffers are byte-identical to its own.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.alloc import decoded_nbytes
from ..core.arrays import ByteArrayData
from ..core.chunk import (
    ChunkData,
    ChunkError,
    _check_crc,
    chunk_byte_range,
    iter_chunk_pages,
)
from ..core.column_store import DICT_MAX_UNIQUES
from ..core.compress import decompress_block, is_builtin_codec
from ..core.page import (
    MissingDictionaryError,
    PageError,
    _decode_values,
    decode_dict_page,
    encode_dict_page,
    frame_page,
    typed_page_errors,
)
from ..core.schema import Column
from ..core.stats import column_is_unsigned
from ..meta.parquet_types import (
    DictionaryPageHeader,
    Encoding,
    PageHeader,
    PageType,
    Type,
)
from ..ops.delta import _to_signed, decode_delta, prescan_delta_packed
from ..ops.levels import decode_levels_v1, decode_levels_v2
from ..ops.rle_hybrid import RunTable, expand_runs, prescan_hybrid
from ..ops.varint import emit_uvarint, emit_zigzag
from ..obs.log import log_event as _log_event
from ..utils import metrics as _metrics
from ..utils import trace as _trace
from ..utils.counters import LabelledCounts, event_alias
from ..utils.native import PrepareFault, get_native
from ..sink.encoder import (
    EncodedChunk,
    _ChunkEncodePlan,
    _chunk_meta,
    _split_starts,
    _value_width,
)
from .device_ops import (
    MAX_DEVICE_BATCH_BITS,
    _bucket,
    bss_transpose_pages,
    bytes_to_words32,
    bytes_to_words64,
    delta_block_encode,
    delta_packed_decode,
    dict_gather,
    dict_indices,
    expand_hybrid,
    list_layout,
    merge_mixed_bytes,
    merge_mixed_numeric,
    plain_bytearray_encode,
    rle_hybrid_encode,
)

__all__ = [
    "DecodeStats",
    "DeviceColumn",
    "EncodeDeclined",
    "assemble_delta_device_stream",
    "assemble_hybrid_device_stream",
    "encode_device_column",
    "hybrid_segments",
    "host_byte_array",
    "prepare_chunk_plan",
    "plan_chunk_device",
    "read_chunk_device",
    "to_device",
    "device_put_pipelined",
    "dispatch",
    "dispatch_pool",
    "dispatch_stream",
    "handoff",
    "mark_pool_thread",
    "on_pool_thread",
    "prepare_counts",
    "reset_prepare_counts",
]

# Patchable in tests to force multi-batch splitting on small inputs.
_BATCH_BITS_CAP = MAX_DEVICE_BATCH_BITS


def _page_merge_tables(page_infos, plain_entries):
    """Padded per-page tables for the mixed-merge kernels: (page_kind,
    page_row_start, aux, n_rows). `plain_entries(payload)` maps a 'values'
    payload to (aux entries consumed, rows contributed)."""
    kinds_t: list[int] = []
    row_starts: list[int] = [0]
    aux: list[int] = []
    idx_base = plain_base = rowpos = 0
    for _n, _d, _r, kind, payload in page_infos:
        if kind == "dict":
            kinds_t.append(1)
            aux.append(idx_base)
            idx_base += payload
            rowpos += payload
            row_starts.append(rowpos)
        elif kind == "values":
            adv, rows = plain_entries(payload)
            kinds_t.append(0)
            aux.append(plain_base)
            plain_base += adv
            rowpos += rows
            row_starts.append(rowpos)
    P = len(kinds_t)
    P_pad = _bucket(max(P, 1), 16)
    page_kind = np.zeros(P_pad, dtype=np.int32)
    page_kind[:P] = kinds_t
    prs = np.full(P_pad + 1, rowpos, dtype=np.int32)
    prs[: P + 1] = row_starts
    aux_np = np.zeros(P_pad, dtype=np.int32)
    aux_np[:P] = aux
    return page_kind, prs, aux_np, rowpos


def _skewed_dict_bound(dictionary, dict_rows: int, plain_bytes: int):
    """(byte bound, acceptable?) for the ragged byte merge: the output is
    sized to the worst-case dictionary entry per row, so a skewed dictionary
    (one huge entry) keeps the host fallback: 4x the expected size or 64 MB,
    whichever is larger."""
    dict_lens = np.diff(dictionary.offsets)
    n_dict = len(dictionary.offsets) - 1
    max_len = int(dict_lens.max()) if n_dict and dict_rows else 0
    mean_len = float(dict_lens.mean()) if n_dict else 0.0
    bound = plain_bytes + dict_rows * max_len
    est = plain_bytes + int(dict_rows * mean_len) + 1
    ok = bound < (1 << 31) and bound <= max(64 << 20, 4 * est)
    return bound, ok


# -- the dispatch thread -------------------------------------------------------
#
# One process-wide single-thread executor ("pqt-dispatch") owns device
# dispatch: the uploads and kernel launches of every chunk plan a reader
# stages, and the batch uploads of device_put_pipelined. The counterpart of
# parquet_tpu/kernels/pipeline.py's dispatch_pool. A CUDA stream is current
# per thread, and every wrapper of device_ops launches on the current stream,
# so the dispatch thread runs each task under a non-default stream of its
# own, one per device (dispatch_stream). Work it queues reaches another
# thread's stream only through an event: a plan records one after its last
# upload and launch (_ChunkPlan.dispatch_device), and the consumer's stream
# waits on it before it touches a dispatched tensor (handoff()). The
# executor's worker is joined at interpreter exit after its queue drains,
# before CUDA is torn down.

_dispatcher: ThreadPoolExecutor | None = None
_dispatcher_lock = threading.Lock()
# device index -> the dispatch thread's stream on that device
_streams: dict = {}
# set on the threads of the port's own executors (dispatch, pqt-host)
_pool_thread = threading.local()


def mark_pool_thread() -> None:
    """Executor initializer: the calling thread serves one of the port's
    pools (see on_pool_thread)."""
    _pool_thread.active = True


def on_pool_thread() -> bool:
    """True on a thread of the dispatch executor or of the pqt-host pool.
    Such a thread must not block on futures of those executors: a batch
    stream dropped in a reference cycle is finalized by whichever thread
    the garbage collector runs on, and its wait there could be on work
    queued behind the waiting thread itself."""
    return getattr(_pool_thread, "active", False)


def dispatch_pool() -> ThreadPoolExecutor:
    """The process-wide single-thread device-dispatch executor."""
    global _dispatcher
    with _dispatcher_lock:
        if _dispatcher is None:
            _dispatcher = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pqt-dispatch", initializer=mark_pool_thread
            )
        return _dispatcher


def _cuda_index(device) -> int | None:
    """The CUDA device index of `device` (a bare "cuda" is the calling
    thread's current device), or None for a CPU target."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return dev.index if dev.index is not None else torch.cuda.current_device()


def dispatch_stream(device) -> torch.cuda.Stream:
    """The dispatch thread's own stream on CUDA `device`, made on first use.
    Making it raises when CUDA cannot: there is no fallback to the caller's
    stream."""
    idx = _cuda_index(device)
    if idx is None:
        raise ValueError(f"dispatch_stream: {device} is not a CUDA device")
    with _dispatcher_lock:
        s = _streams.get(idx)
        if s is None:
            s = _streams[idx] = torch.cuda.Stream(device=idx)
        return s


def _run_on_stream(fn, idx, args):
    """Dispatch-thread task body: fn(*args) on the dispatch stream of CUDA
    device `idx` (plainly for a CPU target)."""
    if idx is None:
        return fn(*args)
    with torch.cuda.device(idx), torch.cuda.stream(dispatch_stream(torch.device("cuda", idx))):
        return fn(*args)


def dispatch(fn, device, *args) -> Future:
    """Run fn(*args) on the dispatch thread, on `device`'s dispatch stream.
    The device index resolves on the calling thread, so a bare "cuda" means
    the caller's current device, not the dispatch thread's. The task runs
    in the caller's context (an active decode trace, the request's log and
    cost context) through traced_submit, the reference's hop here: no pool
    gauges or histograms."""
    return _trace.traced_submit(
        dispatch_pool(), _run_on_stream, fn, _cuda_index(device), args
    )


def record_event(device) -> "torch.cuda.Event | None":
    """An event recorded on the current stream of CUDA `device` (None for a
    CPU target): what a consumer on another stream waits on."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def handoff(event, tensors, device) -> None:
    """Make the calling thread's current stream on `device` wait on `event`,
    and mark every tensor in `tensors` as used on that stream, so the
    caching allocator does not hand its memory to the producing stream's
    next allocation while this stream may still read it
    (Tensor.record_stream). A no-op for a CPU target (event None)."""
    if event is None:
        return
    cur = torch.cuda.current_stream(device)
    cur.wait_event(event)
    for t in tensors:
        if t is not None and t.is_cuda:
            t.record_stream(cur)


def to_device(host: np.ndarray, device) -> torch.Tensor:
    """Copy a host array to `device` (a read-only buffer is copied on the
    host first: torch refuses to alias one).

    For a CUDA target the copy is non_blocking on the current stream (the
    dispatch stream when the dispatch thread calls) from page-locked
    memory. A pageable array is staged into a block of torch's caching host
    allocator first: that copy has consumed `host` when this returns, so
    the caller may recycle it at once (utils/native.release_buffers), and
    the allocator records the upload's event on the block and reuses it only
    once the upload is done. A failed pinned allocation raises: there is no
    pageable fallback. A CPU target keeps the plain copy (pinning needs
    CUDA)."""
    host = np.require(host, requirements=["C", "W"])
    src = torch.from_numpy(host)
    dev = torch.device(device)
    if dev.type != "cuda":
        return src.to(dev)
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    pinned.copy_(src)
    return pinned.to(dev, non_blocking=True)


def _put_batch(batch: dict, device) -> tuple:
    """Upload one {key: np.ndarray | None} batch (the dispatch thread's task
    for device_put_pipelined): (tensors, event after the last copy)."""
    out = {k: None if v is None else to_device(np.asarray(v), device) for k, v in batch.items()}
    return out, record_event(device)


def _take_batch(put: tuple, device) -> dict:
    """The consumer's side of one uploaded batch: its stream waits on the
    batch's event, and each tensor is marked as used there."""
    out, event = put
    handoff(event, out.values(), device)
    return out


def device_put_pipelined(batches, device=None, depth: int = 2):
    """Yield device-resident copies of host batches ({key: np.ndarray, or
    None}), keeping up to `depth` uploads in flight on the dispatch thread
    ahead of the consumer (depth 2: while the consumer works on batch k,
    batch k+1 is already going up). The counterpart of
    parquet_tpu/kernels/pipeline.py's device_put_pipelined.

    `device` is a CUDA device (None means CUDA, and raises without it) or
    "cpu". Order is kept. A batch is safe on the consumer's current stream
    when it is yielded: that stream waits on the batch's upload event. An
    error from `batches` is deferred to the position where it happened
    (every batch before it is yielded first); an error from an upload
    surfaces at the yield of its batch. depth=0 uploads synchronously on the
    calling thread. Each upload runs under a `device_put` trace stage (the
    dispatch carries the caller's decode_trace onto the dispatch thread);
    the stage measures the upload's host time, not the copy's."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            'device_put_pipelined: CUDA is not available; pass device="cpu"'
        )
    if depth <= 0:
        for b in batches:
            # upload inside the stage, yield outside it: a yield under the
            # stage would bill the consumer's time to the upload
            with _trace.stage("device_put"):
                put = _put_batch(b, dev)
            yield _take_batch(put, dev)
        return

    def put(b):
        with _trace.stage("device_put"):
            return _put_batch(b, dev)

    it = iter(batches)
    pending: deque = deque()
    source_err = None

    def fill():
        # a source failure is held, not raised here: the batches already
        # uploaded still reach the consumer, and the error surfaces where
        # the source failed
        nonlocal source_err
        if source_err is not None:
            return
        while len(pending) < depth:
            try:
                b = next(it)
            except StopIteration:
                return
            except BaseException as e:  # noqa: BLE001 - re-raised in order
                source_err = e
                return
            pending.append(dispatch(put, dev, b))

    fill()
    while pending:
        fut = pending.popleft()
        fill()
        yield _take_batch(fut.result(), dev)
    if source_err is not None:
        raise source_err


# -- prepare counters ------------------------------------------------------------
#
# Which walk each chunk took, and which device routes the plans used: the
# counters the JAX package bumps through utils.trace (prepare_fused_engaged,
# prepare_fused_declined, prepare_fused_fault_<stage>,
# prepare_fallback_recovered, repack_engaged, repack_declined), plus the
# port's route counts (route_bss, route_merge_numeric, route_merge_bytes,
# route_host_merge: a mixed chunk merged on the host). Process-wide, like
# device_ops launch counts: read with prepare_counts(), zero with
# reset_prepare_counts().

# each a sample of the registry's events_total; the reference's names are
# also counts of the active decode trace, the port's route counts are not
_COUNTS = LabelledCounts(alias=event_alias(), traced=lambda name: not name.startswith("route_"))


def _bump(name: str, n: int = 1, nbytes: int = 0) -> None:
    _COUNTS.count(name, n)
    if nbytes:
        _trace.add_bytes(name, nbytes)


def prepare_counts() -> dict:
    """A snapshot of the prepare and route counters."""
    return _COUNTS.snapshot()


def reset_prepare_counts() -> None:
    _COUNTS.reset()


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


# One lock for every DecodeStats (held for a few additions): prepare threads
# and the dispatch thread bump the same counts at once, and `x.n += k` is not
# atomic.
_STATS_LOCK = threading.Lock()


@dataclass
class DecodeStats:
    """Page routing counts (the counterpart of the JAX TpuDecodeStats),
    bumped through add() from any thread."""

    pages: int = 0
    device_values: int = 0
    host_fallback_pages: int = 0
    device_batches: int = 0

    def add(self, **counts: int) -> None:
        with _STATS_LOCK:
            for name, n in counts.items():
                setattr(self, name, getattr(self, name) + n)


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


# The def level a column without a def stream reports for every entry on
# the device (DeviceColumn.level_tensors).
DEF_SATURATED = np.iinfo(np.int32).max


@dataclass
class DeviceColumn:
    """Decoded column delivered in device memory. Numeric columns carry
    `values` (real dtype; floats viewed on the device from their bit
    patterns). Byte-array columns carry `data` + int64 `offsets`, or — for
    dictionary-encoded chunks — `indices` (int32) plus the dictionary both
    host-side and as `dict_data`/`dict_offsets` on the device.

    def/rep levels stay host-side as uint16 NumPy arrays (record assembly
    is a host concern); list_layout() uploads them once when a consumer
    wants a repeated depth's layout on the device."""

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
    # memoized device copies of the level streams (one upload, shared by
    # every list_layout() depth)
    _dev_rep: torch.Tensor | None = None
    _dev_def: torch.Tensor | None = None

    @property
    def device(self) -> torch.device | None:
        """The device the column's tensors lie on."""
        for t in (self.values, self.indices, self.data):
            if t is not None:
                return t.device
        return None

    def list_layout(self, parent_rep: int, elem_def: int):
        """Arrow-style offsets and validity of one repeated depth, computed
        on the column's device from its level streams (device_ops.
        list_layout): the levels go up once as int32 (memoized) and the
        results stay on the device.

        Returns (offsets int32[n + 1], first_def int32[n], n_slots, a 0-d
        int64 tensor); entries past n_slots are padding. Feed
        `first_def < node.max_def` for the depth's null mask. A column with
        no def stream counts every entry as fully defined (its def levels
        saturate at the int32 maximum). Replaces
        parquet_tpu/kernels/pipeline.py:DeviceColumn.list_layout."""
        rep, dfl = self.level_tensors()
        return list_layout(rep, dfl, parent_rep, elem_def)

    def level_tensors(self):
        """(rep, def) as int32 tensors on the column's device, uploaded once
        and shared by every list_layout() depth and every LIST `contains`
        filter of the column. With no def stream every entry counts as fully
        defined: its def levels saturate at the int32 maximum
        (DEF_SATURATED)."""
        if self.rep_levels is None:
            raise ValueError("column has no repetition levels")
        dev = self.device
        if self._dev_rep is None:
            self._dev_rep = to_device(np.asarray(self.rep_levels, dtype=np.int32), dev)
        if self._dev_def is None:
            if self.def_levels is None:
                self._dev_def = torch.full(
                    (self.num_values,), DEF_SATURATED, dtype=torch.int32, device=dev
                )
            else:
                self._dev_def = to_device(np.asarray(self.def_levels, dtype=np.int32), dev)
        return self._dev_rep, self._dev_def


class _ChunkPlan:
    """Host-side record of one chunk's device decode."""

    def __init__(self, column: Column, expected: int):
        self.column = column
        self.expected = expected
        self.page_infos: list[tuple] = []  # (n, def, rep, kind, payload)
        # whole-chunk level arrays from the native walk (page slices view
        # them); when set, finalize/device_column skip the per-page concat
        self.native_def: np.ndarray | None = None
        self.native_rep: np.ndarray | None = None
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
        # BYTE_STREAM_SPLIT pages shipped raw: [((4, n_pad) uint8 staging,
        # num_values)], in the order of the "bss" page_infos
        self.bss_host: list[tuple] = []
        self.dev_bss: list[tuple] = []  # [(device streams, num_values)]
        self.device = None
        self._dispatched = False
        # recorded on the dispatching stream after the last upload and launch
        self.event = None

    # -- device dispatch (nothing synchronizes here) ---------------------------

    def dispatch_device(self, device) -> "_ChunkPlan":
        """Upload the frozen buffers to `device` and launch the kernels on
        the current stream, then record the plan's event there."""
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
        for streams, nv in self.bss_host:
            self.dev_bss.append((to_device(streams, self.device), nv))
            if stats is not None:
                stats.add(device_values=nv, device_batches=1)
        self.bss_host = []
        for frozen in self.frozen_hybrid:
            self.dev_hybrid.append(dispatch_hybrid(frozen, self.device))
            if stats is not None:
                stats.add(device_values=frozen.total, device_batches=1)
        for frozen in self.frozen_delta:
            self.dev_delta.append(dispatch_delta(frozen, self.device))
            if stats is not None:
                stats.add(device_values=frozen.total, device_batches=1)
        self.frozen_hybrid = []
        self.frozen_delta = []
        self.event = record_event(self.device)
        return self

    def _handoff(self) -> None:
        """Before the calling thread touches the dispatched tensors: its
        current stream waits on the plan's event, and each tensor is marked
        as used there (the dispatch thread's stream allocated them)."""
        handoff(
            self.event,
            [self.dict_dev, self.dev_plain, *self.dev_hybrid, *self.dev_delta,
             *(t for t, _ in self.dev_bss)],
            self.device,
        )

    # -- fetch + host reassembly (equal to core.chunk.read_chunk) --------------

    def finalize(self, keep_dict_indices: bool = False) -> ChunkData:
        column = self.column
        self._handoff()
        hybrid_flat = _fetch(self.dev_hybrid, np.uint32)
        if keep_dict_indices and self.dictionary is not None:
            kinds = {k for _, _, _, k, _ in self.page_infos if k != "empty"}
            if kinds and kinds <= {"dict", "indices"}:
                return self._finalize_indices(hybrid_flat)
        delta_flat = _fetch(self.dev_delta, None)
        bss_pages = None
        if self.dev_bss or self.bss_host:
            # fetch the device transposes (dispatched), or transpose the
            # staged streams on the host (a plan finalized undispatched)
            np_dt = _NUMERIC_DTYPE.get(column.type)
            if self.dev_bss:
                flat = bss_transpose_pages(self.dev_bss).cpu().numpy().view(np_dt)
                bss_pages = np.split(flat, np.cumsum([nv for _, nv in self.dev_bss])[:-1])
            else:
                bss_pages = [
                    np.ascontiguousarray(st[:, :nv].T).view(np_dt).reshape(nv)
                    for st, nv in self.bss_host
                ]
            bss_pages.reverse()  # pop from the front
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
            elif kind == "bss":
                pages_values.append(bss_pages.pop())
            elif kind == "values":
                pages_values.append(payload)
        if num_values_total != self.expected:
            raise ChunkError(
                f"chunk: pages hold {num_values_total} values, "
                f"metadata says {self.expected}"
            )
        def_levels, rep_levels = self._levels(all_def, all_rep)
        return ChunkData(
            column=column,
            num_values=num_values_total,
            values=_concat_values(pages_values, column),
            def_levels=def_levels,
            rep_levels=rep_levels,
            dictionary=self.dictionary,
        )

    def _finalize_indices(self, hybrid_flat) -> ChunkData:
        """The dictionary-preserving delivery (to_arrow's read_dictionary=):
        the decoded indices pass through unmaterialized."""
        parts = []
        hpos = 0
        all_def, all_rep = [], []
        total = 0
        for n, dfl, rep, kind, payload in self.page_infos:
            total += n
            if dfl is not None:
                all_def.append(dfl)
            if rep is not None:
                all_rep.append(rep)
            if kind == "dict":
                parts.append(hybrid_flat[hpos : hpos + payload])
                hpos += payload
            elif kind == "indices":
                parts.append(np.asarray(payload))
        if total != self.expected:
            raise ChunkError(
                f"chunk: pages hold {total} values, metadata says {self.expected}"
            )
        idx = (
            (np.concatenate(parts) if len(parts) != 1 else parts[0])
            if parts else np.empty(0, np.int32)
        )
        def_levels, rep_levels = self._levels(all_def, all_rep)
        return ChunkData(
            column=self.column,
            num_values=total,
            values=None,
            def_levels=def_levels,
            rep_levels=rep_levels,
            dictionary=self.dictionary,
            indices=idx.astype(np.int32, copy=False),
        )

    def _levels(self, all_def, all_rep):
        """The chunk's (def, rep) levels: the native walk's whole-chunk
        arrays, or the pages' arrays concatenated."""
        if self.native_def is not None or self.native_rep is not None:
            return self.native_def, self.native_rep
        return (
            np.concatenate(all_def) if all_def else None,
            np.concatenate(all_rep) if all_rep else None,
        )

    # -- decode-to-device ------------------------------------------------------

    def device_column(self) -> DeviceColumn:
        """Deliver the chunk's decoded values in device memory. Shapes the
        device routes do not cover (byte-array PLAIN/delta pages, booleans,
        FLBA dictionaries, demoted mixed chunks) take host decode + one
        upload."""
        if not self._dispatched:
            raise RuntimeError("device_column: plan was not dispatched")
        self._handoff()
        column = self.column
        dev = self.device
        kinds = {k for _, _, _, k, _ in self.page_infos if k != "empty"}
        def_levels, rep_levels = self._levels(
            [d for _, d, _, _, _ in self.page_infos if d is not None],
            [r for _, _, r, _, _ in self.page_infos if r is not None],
        )
        out = DeviceColumn(
            num_values=sum(n for n, *_ in self.page_infos),
            def_levels=def_levels,
            rep_levels=rep_levels,
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

        if kinds <= {"bss", "empty"} and self.dev_bss:
            out.values = _device_view(bss_transpose_pages(self.dev_bss), column)
            return out

        if "values" in kinds and kinds <= {"values", "empty"} and column.type in _NUMERIC_DTYPE:
            if self.dev_plain is not None:
                out.values = self.dev_plain
            else:
                parts = [p for _, _, _, k, p in self.page_infos if k == "values"]
                host = parts[0] if len(parts) == 1 else np.concatenate(parts)
                out.values = _upload_typed(host, dev)
            return out

        # Mixed dict+PLAIN numeric chunk (a writer's dictionary passing its
        # size limit mid-chunk): dict pages keep their device expansion,
        # PLAIN pages ride the raw upload, and one merge joins both in row
        # order. Only the native walk leaves chunks mixed; the staged walk
        # demotes them in _commit_routes.
        if (
            column.type in _NUMERIC_DTYPE
            # DOUBLE excluded, as the JAX pipeline excludes it (written for
            # its TPU x64 emulation, which cannot bitcast f64<->u64): mixed
            # doubles take the host merge below. Lifting it would be a route
            # the reference lacks.
            and column.type != Type.DOUBLE
            and kinds <= {"dict", "values", "empty"}
            and "dict" in kinds
            and self.dev_hybrid
            and self.dict_dev is not None
            and self.dev_plain is not None
        ):
            merged = merge_mixed_numeric(*self._merge_numeric_args())
            out.values = _device_view(merged, column)
            _bump("route_merge_numeric")
            return out

        # Mixed dict+PLAIN byte-array chunk: dict pages ship indices plus the
        # dictionary, PLAIN pages their raw bytes, and one ragged merge
        # materializes the (data, offsets) column on the device.
        if (
            kinds <= {"dict", "values", "empty"}
            and "dict" in kinds
            and self.dev_hybrid
            and isinstance(self.dictionary, ByteArrayData)
            and self._merge_ragged_bytes(out)
        ):
            _bump("route_merge_bytes")
            return out

        # Mixed, unsupported, or fully empty shapes: host decode, then upload.
        if "dict" in kinds and "values" in kinds:
            _bump("route_host_merge")
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

    def _merge_numeric_args(self) -> tuple:
        """The arguments of merge_mixed_numeric for this dispatched mixed
        chunk: indices, dictionary and PLAIN upload in the bit-pattern domain
        (floats are viewed back once after the merge), and the page tables."""
        dev = self.device
        page_kind, prs, aux_np, n_rows = _page_merge_tables(
            self.page_infos, lambda p: (len(p), len(p))
        )
        plain = self.dev_plain
        if plain.is_floating_point():
            plain = plain.view(torch.int32 if plain.element_size() == 4 else torch.int64)
        return (
            self._dev_indices(),
            self.dict_dev,
            plain,
            to_device(page_kind, dev),
            to_device(prs, dev),
            to_device(aux_np, dev),
            n_rows,
        )

    def _merge_ragged_bytes(self, out: DeviceColumn) -> bool:
        """Device merge of a mixed dict/PLAIN byte-array chunk. Returns False
        (leaving `out` untouched) when the shape is unsuitable."""
        args = self._merge_bytes_args()
        if args is None:
            return False
        out.data, out.offsets = merge_mixed_bytes(*args)
        out.dictionary = self.dictionary
        return True

    def _merge_bytes_args(self) -> tuple | None:
        """The arguments of merge_mixed_bytes for this dispatched mixed chunk,
        or None when the shape is unsuitable: a skewed dictionary whose
        worst-case bound would blow device memory, or PLAIN pages that did
        not decode to ByteArrayData.

        Only raw page bytes, int32 PLAIN offsets and per-page tables go up;
        merge_mixed_bytes derives the rest on the device. `data` is sized to
        the bound from _skewed_dict_bound, so nothing waits for the device;
        the bytes past offsets[n_rows] are unspecified."""
        d = self.dictionary
        dev = self.device
        dict_rows = plain_rows = plain_bytes = 0
        for _n, _d, _r, kind, payload in self.page_infos:
            if kind == "dict":
                dict_rows += payload
            elif kind == "values":
                if not isinstance(payload, ByteArrayData):
                    return None
                plain_rows += len(payload.offsets) - 1
                plain_bytes += len(payload.data)
        bound, ok = _skewed_dict_bound(d, dict_rows, plain_bytes)
        n_rows = dict_rows + plain_rows
        if n_rows == 0 or not ok:
            return None
        if len(d.data) + plain_bytes >= (1 << 31):
            return None  # int32 plain offsets would overflow
        page_kind, prs, aux_np, _nr = _page_merge_tables(
            self.page_infos, lambda p: (len(p.offsets), len(p.offsets) - 1)
        )
        P_pad = len(page_kind)
        pools = [np.frombuffer(d.data, dtype=np.uint8)]
        base = len(d.data)
        po_parts: list[np.ndarray] = []
        src_base: list[int] = []
        for _n, _dl, _rl, kind, payload in self.page_infos:
            if kind == "dict":
                src_base.append(0)
            elif kind == "values":
                src_base.append(base)
                po_parts.append(payload.offsets.astype(np.int32))
                pools.append(np.frombuffer(payload.data, dtype=np.uint8))
                base += len(payload.data)
        srcb = np.zeros(P_pad, dtype=np.int64)
        srcb[: len(src_base)] = src_base
        po32 = np.concatenate(po_parts) if po_parts else np.zeros(2, dtype=np.int32)
        pool = pools[0] if len(pools) == 1 else np.concatenate(pools)
        if len(pool) == 0:
            pool = np.zeros(1, dtype=np.uint8)
        return (
            self._dev_indices(),
            to_device(np.asarray(d.offsets, dtype=np.int64), dev),
            to_device(pool, dev),
            to_device(po32, dev),
            to_device(page_kind, dev),
            to_device(prs, dev),
            to_device(aux_np, dev),
            to_device(srcb, dev),
            n_rows,
            bound,
        )


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
    alloc=None,
    stats: DecodeStats | None = None,
) -> _ChunkPlan:
    """Host-only prepare: page walk, decompress, level decode, prescan.

    Touches no device; the returned plan goes to the device via
    plan.dispatch_device(). The whole-chunk native walk handles the common
    shapes in one C call; a chunk it declines takes the per-page Python walk
    (the error-semantics reference). A chunk the native walk ABORTED on that
    the staged walk then decodes cleanly counts as
    prepare_fallback_recovered; a genuinely corrupt chunk raises the staged
    walk's typed error. `alloc` (a memory ceiling, core.alloc.AllocTracker)
    needs the staged walk's per-page accounting: the fused walk declines."""
    plan, fault = _native_prepare(f, chunk, column, validate_crc, alloc, stats)
    if plan is not None:
        return plan
    t0 = time.perf_counter()
    plan = _staged_prepare(f, chunk, column, validate_crc, alloc, stats)
    _metrics.observe("chunk_decode_seconds", time.perf_counter() - t0)
    if fault is not None:
        # the native walk aborted but the staged walk decoded cleanly
        _bump("prepare_fallback_recovered")
        _log_event(
            "prepare_fallback_recovered", level="warning",
            column=".".join(column.path), fault=str(fault),
        )
    return plan


# Page-table column indices of the native whole-chunk walk (layout defined in
# native/prepare.cc ptq_chunk_prepare).
_PC_KIND, _PC_N, _PC_NONNULL, _PC_ENC, _PC_ROUTE = 0, 1, 2, 3, 4
_PC_VOFF, _PC_VLEN, _PC_LVLBASE = 5, 6, 7
_PC_RUNS, _PC_RUNE, _PC_PACKS, _PC_PACKE = 8, 9, 10, 11
_PC_MINIS, _PC_MINIE, _PC_DSTART, _PC_DCONS = 12, 13, 14, 15
_PC_EXTRA, _PC_DFIRST = 16, 17


def _native_prepare(f, chunk, column, validate_crc, alloc, stats):
    """Whole-chunk native prepare: ONE C call walks every page (header
    parse, CRC verify when validate_crc, decompress, level decode, value
    prescan) and returns packed tables; batch assembly is then a handful of
    vectorized NumPy ops instead of a per-page Python loop.

    Returns (plan, fault): a ready _ChunkPlan and None, or None and an
    optional PrepareFault. fault is set when the native walk RAN and aborted
    (corrupt/unsupported/capacity, with stage + page + byte offset); it is
    None when the walk was never attempted (a memory ceiling, a registered
    codec override, an unreadable chunk range). Either way the caller falls back to the staged
    walk. PQT_FUSED_PREPARE=0 forces the staged walk (the differential-test
    control), as it does in the JAX package."""
    if os.environ.get("PQT_FUSED_PREPARE", "1") == "0":
        return None, None  # forced staged path: not a decline, no counter
    plan, fault = _native_prepare_impl(f, chunk, column, validate_crc, alloc, stats)
    if plan is None:
        _bump("prepare_fused_declined")
        if fault is not None:
            _bump(f"prepare_fused_fault_{fault.stage}")
    else:
        _bump("prepare_fused_engaged")
    return plan, fault


def _native_prepare_impl(f, chunk, column, validate_crc, alloc, stats):
    if alloc is not None:
        # a memory ceiling needs the per-page accounting only the staged
        # walk performs (validate_crc, by contrast, is fused natively)
        return None, None
    md = chunk.meta_data
    codec = int(md.codec or 0)
    if codec not in (0, 1, 2, 5, 7) or not is_builtin_codec(codec):
        return None, None
    try:
        offset, total = chunk_byte_range(chunk)
    except ChunkError:
        return None, None
    f.seek(offset)
    buf = f.read(total)
    if len(buf) != total:
        return None, None  # truncated: the staged walk raises the exact error
    ptype = column.type
    np_dt = _NUMERIC_DTYPE.get(ptype)
    type_size = np.dtype(np_dt).itemsize if np_dt is not None else 0
    delta_nbits = 32 if ptype == Type.INT32 else (64 if ptype == Type.INT64 else 0)
    expected = int(md.num_values or 0)
    if expected < 0:
        return None, None
    lib = get_native()  # a failed host build raises: no quiet decline
    t_walk = time.perf_counter()
    res = lib.chunk_prepare(
        buf,
        codec,
        column.max_def,
        column.max_rep,
        type_size,
        delta_nbits,
        expected,
        int(md.total_uncompressed_size or 0),
        collect_stages=_trace.active(),
        validate_crc=validate_crc,
    )
    if isinstance(res, PrepareFault):
        return None, res
    t_walk = time.perf_counter() - t_walk
    stage_ns = res.get("stage_ns")
    if stage_ns is not None:
        # one batch: the sub-stage spans lay back to back ending now, so
        # they nest inside the enclosing chunk.prepare span
        _trace.add_seconds_batch(
            [
                (name, int(stage_ns[slot]) / 1e9)
                for slot, name in enumerate(_PREPARE_STAGES)
                if stage_ns[slot]
            ]
        )
    try:
        plan = _plan_from_tables(column, expected, res, stats, np_dt, delta_nbits)
    except (PageError, ChunkError):
        raise
    except Exception:
        return None, None  # unexpected table shape: let the staged walk decide
    # the process counters, recorded only once the plan is committed (a
    # chunk that falls back to the staged walk is counted by that walk):
    # the fused walk bypasses decompress_block and the per-page decoders,
    # so it reports its own totals (io_bytes over the chunk window and the
    # metadata's uncompressed size, page bytes over the value streams)
    _metrics.observe("chunk_decode_seconds", t_walk)
    _metrics.io_bytes(len(buf), int(md.total_uncompressed_size or 0), codec)
    # decompress_block's per-trace decoded-byte account, which the fused
    # walk bypasses: tenant cost stays exact on this lane too
    _trace.add_bytes("decode.bytes", int(md.total_uncompressed_size or 0))
    pages_arr = res["pages"]
    if len(pages_arr):
        for e in np.unique(pages_arr[:, _PC_ENC]):
            sel = pages_arr[pages_arr[:, _PC_ENC] == e]
            _metrics.page_decoded(
                _metrics.encoding_name(int(e)), n=len(sel), nbytes=int(sel[:, _PC_VLEN].sum())
            )
    return plan, None


# the fused walk's stage_ns slots, as trace stages
_PREPARE_STAGES = (
    "prepare.decompress",
    "prepare.levels",
    "prepare.prescan",
    "prepare.copy",
    "prepare.crc",
)


def _release(res, keep_values: bool) -> None:
    """Hand the walk's staging buffers that no plan view escapes into back
    to this thread's pool: `packed` and `delta` always, `values` unless the
    plan keeps a view of it (a PLAIN upload buffer, or a decoded dictionary
    page, which can alias it zero-copy)."""
    names = ("packed", "delta") if keep_values else ("values", "packed", "delta")
    get_native().release_buffers(res, names)


def _plan_from_tables(column, expected, res, stats, np_dt, delta_nbits):
    plan = _ChunkPlan(column, expected)
    plan.stats = stats
    pages = res["pages"].tolist()
    values_buf = res["values"]
    def_all = res["def"]
    rep_all = res["rep"]
    n_data = sum(1 for P in pages if P[_PC_KIND] == 0)
    if stats is not None:
        stats.add(pages=n_data)
    data_pages = []
    for P in pages:
        if P[_PC_KIND] == 1:  # dictionary page
            header = PageHeader(
                type=int(PageType.DICTIONARY_PAGE),
                dictionary_page_header=DictionaryPageHeader(
                    num_values=P[_PC_N], encoding=P[_PC_ENC]
                ),
            )
            block = memoryview(values_buf)[P[_PC_VOFF] : P[_PC_VOFF] + P[_PC_VLEN]]
            plan.dictionary = decode_dict_page(header, block, column, count_metrics=False)
        elif P[_PC_KIND] == 0:
            data_pages.append(P)
    if column.max_def > 0 and data_pages:
        plan.native_def = def_all
    if column.max_rep > 0 and data_pages:
        plan.native_rep = rep_all

    def _levels(P):
        base, n = P[_PC_LVLBASE], P[_PC_N]
        dfl = def_all[base : base + n] if column.max_def > 0 else None
        rep = rep_all[base : base + n] if column.max_rep > 0 else None
        return dfl, rep

    routes = {P[_PC_ROUTE] for P in data_pages if P[_PC_ROUTE] != 4}

    if routes == {3} or not routes:  # PLAIN numeric (and/or empty pages)
        first = None
        nbytes = 0
        for P in data_pages:
            if P[_PC_ROUTE] == 4:
                continue
            if first is None:
                first = P[_PC_VOFF]
            nbytes += P[_PC_VLEN]
        whole = None
        if first is not None and np_dt is not None:
            # routes wrote values_out sequentially: one zero-copy view is the
            # whole chunk's upload buffer (no per-page concatenation)
            whole = np.frombuffer(
                values_buf, dtype=np_dt, count=nbytes // np.dtype(np_dt).itemsize,
                offset=first,
            )
        repacked = (
            whole is not None
            and delta_nbits != 0
            and _repack_plain_as_delta(plan, whole, delta_nbits)
        )
        for P in data_pages:
            dfl, rep = _levels(P)
            if P[_PC_ROUTE] == 4:
                plan.page_infos.append((P[_PC_N], dfl, rep, "empty", None))
            elif repacked:
                plan.page_infos.append(
                    (P[_PC_N], dfl, rep, "delta", P[_PC_NONNULL])
                )
            else:
                vals = np.frombuffer(
                    values_buf, dtype=np_dt, count=P[_PC_NONNULL],
                    offset=P[_PC_VOFF],
                )
                plan.page_infos.append((P[_PC_N], dfl, rep, "values", vals))
        if not repacked:
            plan.plain_host = whole
        _release(res, keep_values=not repacked or plan.dictionary is not None)
        return plan

    if routes == {5} and np_dt is not None:
        # BYTE_STREAM_SPLIT 4-byte pages shipped RAW: each page's streams
        # stage into a (4, bucket) array (4 contiguous copies: the host never
        # strides byte by byte) and the device does the transpose
        for P in data_pages:
            dfl, rep = _levels(P)
            if P[_PC_ROUTE] == 4:
                plan.page_infos.append((P[_PC_N], dfl, rep, "empty", None))
                continue
            nv = P[_PC_NONNULL]
            raw = np.frombuffer(
                values_buf, dtype=np.uint8, count=P[_PC_VLEN], offset=P[_PC_VOFF]
            )
            staged = np.zeros((4, _bucket(max(nv, 1))), dtype=np.uint8)
            staged[:, :nv] = raw.reshape(4, nv)
            plan.bss_host.append((staged, nv))
            plan.page_infos.append((P[_PC_N], dfl, rep, "bss", nv))
        _bump("route_bss")
        # the staging copied out of values
        _release(res, keep_values=plan.dictionary is not None)
        return plan

    if routes == {1} or (
        routes == {1, 3} and np_dt is not None and column.type != Type.DOUBLE
        # DOUBLE mixed chunks take the host merge (kept from the JAX
        # pipeline: its device merge excludes DOUBLE); freezing their batches
        # would only upload indices that finalize() fetches back: demote
    ):
        # Dictionary-encoded chunk, possibly with a mid-chunk fall-back to
        # PLAIN pages: dict pages build device run batches, PLAIN pages ride
        # the contiguous raw upload, and device_column merges in page order.
        frozen = _freeze_hybrid_from_tables(data_pages, res)
        if frozen is not None:
            plan.frozen_hybrid = frozen
            first = None
            nbytes = 0
            for P in data_pages:
                dfl, rep = _levels(P)
                if P[_PC_ROUTE] == 4:
                    plan.page_infos.append((P[_PC_N], dfl, rep, "empty", None))
                elif P[_PC_ROUTE] == 3:
                    vals = np.frombuffer(
                        values_buf, dtype=np_dt, count=P[_PC_NONNULL],
                        offset=P[_PC_VOFF],
                    )
                    plan.page_infos.append((P[_PC_N], dfl, rep, "values", vals))
                    if first is None:
                        first = P[_PC_VOFF]
                    nbytes += P[_PC_VLEN]
                else:
                    plan.page_infos.append(
                        (P[_PC_N], dfl, rep, "dict", P[_PC_NONNULL])
                    )
            if first is not None:
                plan.plain_host = np.frombuffer(
                    values_buf, dtype=np_dt,
                    count=nbytes // np.dtype(np_dt).itemsize, offset=first,
                )
            return plan
        # oversized page: fall through to the demote path below

    if routes == {2} and all(
        P[_PC_DCONS] * 8 <= _BATCH_BITS_CAP
        for P in data_pages
        if P[_PC_ROUTE] == 2
    ):  # delta-bp chunk (an oversized page demotes the whole chunk, as below)
        frozen = _freeze_delta_from_tables(data_pages, res, delta_nbits)
        if frozen is not None:
            plan.frozen_delta = frozen
            for P in data_pages:
                dfl, rep = _levels(P)
                if P[_PC_ROUTE] == 4:
                    plan.page_infos.append((P[_PC_N], dfl, rep, "empty", None))
                else:
                    plan.page_infos.append(
                        (P[_PC_N], dfl, rep, "delta", P[_PC_EXTRA])
                    )
            return plan

    if (
        column.type == Type.BYTE_ARRAY
        and routes <= {0, 1}
        and 1 in routes
        and all(
            P[_PC_ENC] == int(Encoding.PLAIN)
            for P in data_pages
            if P[_PC_ROUTE] == 0
        )
        and plan.dictionary is not None
        and _skewed_dict_bound(
            plan.dictionary,
            sum(P[_PC_NONNULL] for P in data_pages if P[_PC_ROUTE] == 1),
            # PLAIN stream length bounds the page's data bytes; close enough
            # for the skew gate (the merge re-checks exactly)
            sum(P[_PC_VLEN] for P in data_pages if P[_PC_ROUTE] == 0),
        )[1]
    ):
        # Dict pages with a mid-chunk PLAIN byte-array fallback: dict index
        # batches stay device-bound; PLAIN pages decode their offsets on the
        # host and device_column's ragged merge joins both in row order.
        frozen = _freeze_hybrid_from_tables(data_pages, res)
        if frozen is not None:
            plan.frozen_hybrid = frozen
            dict_size = (
                len(plan.dictionary) if plan.dictionary is not None else None
            )
            for P in data_pages:
                dfl, rep = _levels(P)
                if P[_PC_ROUTE] == 4:
                    plan.page_infos.append((P[_PC_N], dfl, rep, "empty", None))
                elif P[_PC_ROUTE] == 1:
                    plan.page_infos.append(
                        (P[_PC_N], dfl, rep, "dict", P[_PC_NONNULL])
                    )
                else:
                    stream = memoryview(values_buf)[
                        P[_PC_VOFF] : P[_PC_VOFF] + P[_PC_VLEN]
                    ]
                    values, _idx = _decode_values(
                        stream, P[_PC_NONNULL], P[_PC_ENC], column, dict_size
                    )
                    plan.page_infos.append((P[_PC_N], dfl, rep, "values", values))
                    if stats is not None:
                        stats.add(host_fallback_pages=1)
            return plan

    # Mixed-route chunk (or an oversized device page): host-decode in place,
    # the policy of _commit_routes: device decode only pays when the whole
    # chunk stays on the device.
    if 1 in routes and len(routes) > 1:
        _bump("route_host_merge")
    dict_size = len(plan.dictionary) if plan.dictionary is not None else None
    for P in data_pages:
        dfl, rep = _levels(P)
        route = P[_PC_ROUTE]
        if route == 4:
            plan.page_infos.append((P[_PC_N], dfl, rep, "empty", None))
            continue
        if route == 1:
            idx = _expand_dict_from_tables(P, res)
            plan.page_infos.append((P[_PC_N], dfl, rep, "indices", idx))
            if stats is not None:
                stats.add(host_fallback_pages=1)
        elif route == 2:
            stream = res["delta_stream"][
                P[_PC_DSTART] : P[_PC_DSTART] + P[_PC_DCONS]
            ]
            vals, _ = decode_delta(
                memoryview(stream), delta_nbits, max_total=P[_PC_NONNULL]
            )
            plan.page_infos.append(
                (P[_PC_N], dfl, rep, "values", vals[: P[_PC_NONNULL]])
            )
            if stats is not None:
                stats.add(host_fallback_pages=1)
        elif route == 3:
            vals = np.frombuffer(
                values_buf, dtype=np_dt, count=P[_PC_NONNULL], offset=P[_PC_VOFF]
            )
            plan.page_infos.append((P[_PC_N], dfl, rep, "values", vals))
        elif route == 5:
            # raw BSS page in a mixed chunk: de-interleave on the host
            nv = P[_PC_NONNULL]
            raw = np.frombuffer(
                values_buf, dtype=np.uint8, count=P[_PC_VLEN], offset=P[_PC_VOFF]
            )
            vals = (
                np.ascontiguousarray(raw.reshape(4, nv).T)
                .view(np_dt)
                .reshape(nv)
            )
            plan.page_infos.append((P[_PC_N], dfl, rep, "values", vals))
        else:  # route 0: host decoder on the raw stream
            stream = memoryview(values_buf)[P[_PC_VOFF] : P[_PC_VOFF] + P[_PC_VLEN]]
            values, indices = _decode_values(
                stream, P[_PC_NONNULL], P[_PC_ENC], column, dict_size
            )
            if indices is not None:
                plan.page_infos.append((P[_PC_N], dfl, rep, "indices", indices))
            else:
                plan.page_infos.append((P[_PC_N], dfl, rep, "values", values))
            if stats is not None:
                stats.add(host_fallback_pages=1)
    kinds_after = {k for _, _, _, k, _ in plan.page_infos}
    kinds_after.discard("empty")
    if kinds_after == {"values"} and column.type in _NUMERIC_DTYPE:
        parts = [p for _, _, _, k, p in plan.page_infos if k == "values"]
        if parts:
            plan.plain_host = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return plan


def _freeze_hybrid_from_tables(data_pages, res) -> list | None:
    """Vectorized _HybridBatch.freeze over the native walk's global run
    tables. Pages group sequentially per index width under the bit cap (the
    policy of _commit_routes); returns None when a single page exceeds the
    cap (demote-all, matching the staged walk)."""
    cap = _BATCH_BITS_CAP
    groups: list[list] = []  # [width, rs, re, ps, pe, bits]
    cur = None
    for P in data_pages:
        if P[_PC_ROUTE] != 1:
            continue
        width = P[_PC_EXTRA]
        bits = (P[_PC_PACKE] - P[_PC_PACKS]) * 8
        if bits > cap:
            return None
        if cur is None or cur[0] != width or cur[5] + bits > cap:
            cur = [width, P[_PC_RUNS], P[_PC_RUNE], P[_PC_PACKS], P[_PC_PACKE], bits]
            groups.append(cur)
        else:
            cur[2] = P[_PC_RUNE]
            cur[4] = P[_PC_PACKE]
            cur[5] += bits
    frozen = []
    h_counts = res["h_counts"]
    h_is_rle = res["h_is_rle"]
    h_values = res["h_values"]
    h_byteoff = res["h_byteoff"]
    packed_all = res["packed"]
    for width, rs, re, ps, pe, _bits in groups:
        counts = h_counts[rs:re]
        k = len(counts)
        total = int(counts.sum())
        n_pad = _bucket(max(total, 1))
        run_pad = _bucket(k, 64)
        words = bytes_to_words32(bytes(packed_all[ps:pe]))
        w_pad = _bucket(len(words), 1024)
        buf = np.zeros(4 * run_pad + w_pad, dtype=np.uint32)
        buf[run_pad : 2 * run_pad] = np.int32(n_pad + 1).view(np.uint32)  # sentinel
        buf[:k] = h_is_rle[rs:re]
        out_start = np.zeros(k, dtype=np.int64)
        np.cumsum(counts[:-1], out=out_start[1:])
        buf[run_pad : run_pad + k] = out_start.astype(np.int32).view(np.uint32)
        buf[2 * run_pad : 2 * run_pad + k] = h_values[rs:re].astype(np.uint32)
        buf[3 * run_pad : 3 * run_pad + k] = (
            ((h_byteoff[rs:re] - ps) * 8).astype(np.int32).view(np.uint32)
        )
        buf[4 * run_pad : 4 * run_pad + len(words)] = words
        frozen.append(_FrozenHybrid(buf, width, n_pad, run_pad, total))
    return frozen


def _repack_plain_as_delta(plan: _ChunkPlan, whole: np.ndarray, nbits: int) -> bool:
    """Transfer-side re-encoding of a PLAIN int chunk: the host deltas and
    bit-packs the values (native DELTA_BINARY_PACKED encoder) and the device
    delta kernel rebuilds them bit-exactly, so the upload carries the
    column's entropy, not its width (ids, timestamps, counters shrink
    10-50x). Chunks that sample as incompressible ship raw (returns False,
    the caller keeps the PLAIN upload). One whole-chunk stream, not one per
    page."""
    n = len(whole)
    raw_bytes = n * whole.dtype.itemsize
    if n < 1 << 16 or raw_bytes < 1 << 19:
        return False  # small chunk: upload latency, not bandwidth, dominates
    lib = get_native()
    # profitability estimate from 4 contiguous sample windows: max zigzag
    # delta width ~ the packed width the encoder will pick
    est_bits = 0
    win = 1024
    for lo in (0, n // 3, (2 * n) // 3, n - win):
        w = whole[max(lo, 0) : max(lo, 0) + win]
        if len(w) < 2:
            continue
        d = np.diff(w.astype(np.int64, copy=False))
        if len(d):
            zz = int(np.abs(d).max()) << 1
            est_bits = max(est_bits, zz.bit_length())
    if est_bits * n >= 4 * raw_bytes:  # est packed size >= raw/2: not worth it
        _bump("repack_declined", nbytes=raw_bytes)
        return False
    try:
        stream = lib.delta_encode(whole, nbits, 1024, 4)
    except (ValueError, OverflowError):
        _bump("repack_declined", nbytes=raw_bytes)
        return False
    if len(stream) * 8 > _BATCH_BITS_CAP or len(stream) * 2 > raw_bytes:
        # sampled estimate missed: ship raw rather than inflate
        _bump("repack_declined", nbytes=raw_bytes)
        return False
    try:
        widths, byte_starts, out_starts, mins, first, total, consumed = (
            lib.prescan_delta_packed(stream, nbits, n)
        )
    except (ValueError, OverflowError):
        _bump("repack_declined", nbytes=raw_bytes)
        return False
    if int(total) != n:
        _bump("repack_declined", nbytes=raw_bytes)
        return False
    first_u = int(first) & ((1 << 64) - 1)
    first_i64 = first_u - (1 << 64) if first_u >= 1 << 63 else first_u
    P2 = [0] * 18
    P2[_PC_ROUTE] = 2
    P2[_PC_EXTRA] = n
    P2[_PC_DCONS] = int(consumed)
    P2[_PC_MINIS] = 0
    P2[_PC_MINIE] = len(widths)
    P2[_PC_DSTART] = 0
    P2[_PC_DFIRST] = first_i64
    res2 = {
        "d_widths": np.asarray(widths, dtype=np.uint32),
        "d_bytestart": np.asarray(byte_starts, dtype=np.int64),
        "d_outstart": np.asarray(out_starts, dtype=np.int32),
        "d_mins": np.asarray(mins, dtype=np.uint64),
        "delta_stream": np.frombuffer(stream, dtype=np.uint8),
    }
    plan.frozen_delta = _freeze_delta_from_tables([P2], res2, nbits)
    if plan.frozen_delta:
        _bump("repack_engaged", nbytes=len(stream))
    return bool(plan.frozen_delta)


def _freeze_delta_from_tables(data_pages, res, nbits: int) -> list:
    """Vectorized _DeltaBatch.freeze over the native walk's global miniblock
    tables (pages group sequentially under the bit cap)."""
    cap = _BATCH_BITS_CAP
    groups: list[list] = []  # [pages, ms, me, lo, hi, bits]
    cur = None
    for P in data_pages:
        if P[_PC_ROUTE] != 2 or P[_PC_EXTRA] == 0:
            continue  # empty streams contribute nothing (add_page parity)
        bits = P[_PC_DCONS] * 8
        if cur is None or cur[5] + bits > cap:
            cur = [[P], P[_PC_MINIS], P[_PC_MINIE], P[_PC_DSTART],
                   P[_PC_DSTART] + P[_PC_DCONS], bits]
            groups.append(cur)
        else:
            cur[0].append(P)
            cur[2] = P[_PC_MINIE]
            cur[4] = P[_PC_DSTART] + P[_PC_DCONS]
            cur[5] += bits
    frozen = []
    ud = np.uint32 if nbits == 32 else np.uint64
    d_widths = res["d_widths"]
    d_bytestart = res["d_bytestart"]
    d_outstart = res["d_outstart"]
    d_mins = res["d_mins"]
    stream_all = res["delta_stream"]
    for plist, ms, me, lo, hi, _bits in groups:
        totals = np.array([P[_PC_EXTRA] for P in plist], dtype=np.int64)
        bases = np.zeros(len(plist), dtype=np.int64)
        np.cumsum(totals[:-1], out=bases[1:])
        total = int(totals.sum())
        minis_per_page = np.array(
            [P[_PC_MINIE] - P[_PC_MINIS] for P in plist], dtype=np.int64
        )
        m = me - ms
        n_pad = _bucket(total)
        m_pad = _bucket(max(m, 1), 64)
        p = len(plist)
        p_pad = _bucket(p, 64)
        sentinel = np.int32(n_pad + 1).view(np.uint32)
        stream = bytes(stream_all[lo:hi])
        words = bytes_to_words32(stream) if nbits == 32 else bytes_to_words64(stream)
        w_pad = _bucket(len(words), 1024)
        tail32 = (2 * m_pad + 2 * p_pad + w_pad) if nbits == 32 else 0
        meta32 = np.zeros(3 * m_pad + p_pad + tail32, dtype=np.uint32)
        meta32[2 * m_pad : 3 * m_pad] = sentinel
        meta32[3 * m_pad : 3 * m_pad + p_pad] = sentinel
        out_starts = d_outstart[ms:me].astype(np.int64) + np.repeat(
            bases + 1, minis_per_page
        )
        if m:
            meta32[:m] = d_widths[ms:me]
            meta32[m_pad : m_pad + m] = (
                ((d_bytestart[ms:me] - lo) * 8).astype(np.int32).view(np.uint32)
            )
            meta32[2 * m_pad : 2 * m_pad + m] = (
                out_starts.astype(np.int32).view(np.uint32)
            )
        meta32[3 * m_pad : 3 * m_pad + p] = bases.astype(np.int32).view(np.uint32)
        firsts = np.array([P[_PC_DFIRST] for P in plist], dtype=np.int64).view(
            np.uint64
        )
        if nbits == 32:
            base = 3 * m_pad + p_pad
            if m:
                meta32[base : base + m] = d_mins[ms:me].astype(ud)
            meta32[base + m_pad : base + m_pad + p] = firsts.astype(ud)
            meta32[base + m_pad + p_pad : base + m_pad + p_pad + len(words)] = words
            wide = np.zeros(0, dtype=np.uint32)
        else:
            wide = np.zeros(m_pad + p_pad + w_pad, dtype=np.uint64)
            if m:
                wide[:m] = d_mins[ms:me]
            wide[m_pad : m_pad + p] = firsts
            wide[m_pad + p_pad : m_pad + p_pad + len(words)] = words
        frozen.append(_FrozenDelta(meta32, wide, nbits, n_pad, m_pad, p_pad, total))
    return frozen


def _expand_dict_from_tables(P, res) -> np.ndarray:
    """Host expansion of one dict page straight from the global run tables
    (mirrors _host_decode_dict_page without re-prescanning the stream)."""
    rs, re, ps = P[_PC_RUNS], P[_PC_RUNE], P[_PC_PACKS]
    width = P[_PC_EXTRA]
    is_rle = res["h_is_rle"][rs:re].astype(bool)
    counts = res["h_counts"][rs:re]
    if len(counts) and not is_rle[-1] and width > 0:
        # the native walk clamps the final run's count to the page's value
        # count; expand_runs wants the FULL bit-packed count (its dense-unpack
        # math needs multiples of 8) and clamps itself
        counts = counts.copy()
        counts[-1] = ((P[_PC_PACKE] - int(res["h_byteoff"][re - 1])) // width) * 8
    table = RunTable(
        is_rle=is_rle,
        counts=counts,
        rle_values=res["h_values"][rs:re],
        bp_offsets=res["h_byteoff"][rs:re] - ps,
        packed=bytes(res["packed"][ps : P[_PC_PACKE]]),
        consumed=0,
    )
    return expand_runs(table, P[_PC_NONNULL], width, np.uint32)


def _staged_prepare(
    f,
    chunk,
    column: Column,
    validate_crc: bool = False,
    alloc=None,
    stats: DecodeStats | None = None,
) -> _ChunkPlan:
    """The per-page Python prepare walk (the error-semantics reference):
    decompress, level decode, prescan, then batch building or demotion to
    host decode."""
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
        if alloc is not None:
            alloc.check(header.uncompressed_page_size or 0)
        pt = header.type
        if pt == int(PageType.DICTIONARY_PAGE):
            if plan.dictionary is not None:
                raise ChunkError("chunk: more than one dictionary page")
            if validate_crc:
                _check_crc(header, raw.payload)
            block = decompress_block(raw.payload, codec, header.uncompressed_page_size or 0)
            plan.dictionary = decode_dict_page(header, block, column)
            if alloc is not None:
                alloc.register_buffers(plan.dictionary)
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
        # byte volumes ride decompress_block's choke point; pages by encoding
        # count here, as this walk prescans value streams without the
        # core.page decoders
        _metrics.page_decoded(
            _metrics.encoding_name(enc), nbytes=header.uncompressed_page_size or 0
        )
        if stats is not None:
            stats.add(pages=1)
        if alloc is not None:
            # actual levels + the eventual decoded value footprint (a lying
            # header cannot understate these: non_null comes from the real
            # level stream, dict indices decode at 4 B/value, delta totals
            # are plausibility-bounded by the prescan)
            alloc.register(
                decoded_nbytes(dfl) + decoded_nbytes(rep) + len(values_buf) + non_null * 8
            )

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
                stats.add(host_fallback_pages=1)

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
        stats.add(host_fallback_pages=1)
    return "indices", expand_runs(table, non_null, width, np.uint32)


def _host_decode_delta_page(values_buf, nbits: int, non_null: int, stats):
    """Host fallback for a delta page: ('values', decoded values)."""
    if stats is not None:
        stats.add(host_fallback_pages=1)
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


# -- write path: device column -> encoded pages --------------------------------
#
# The inverse of the decode above, ported from the encode half of
# parquet_tpu/kernels/pipeline.py: a device-resident column (a training
# batch, a checkpoint shard, a DeviceColumn's values) becomes parquet pages
# without a host round trip of its raw values. The dictionary probe, the
# hybrid run plan and bit-pack, the DELTA block scans and the byte-array
# framing are kernels (dict_indices, rle_hybrid_encode, bitpack_encode,
# delta_block_encode, plain_bytearray_encode); the host emits run and block
# headers, frames pages and compresses, and the bytes equal
# sink.encoder.encode_chunk's for the same values.


class EncodeDeclined(ValueError):
    """A column the device encoder does not take, as the reference routes
    them: a nested or optional leaf, a writer with the page index on, a
    dictionary-eligible BYTE_ARRAY, a tensor whose width or kind does not
    match the leaf, or an encoding other than PLAIN, dictionary and
    DELTA_BINARY_PACKED. FileWriter encodes such a column on the host,
    counted as device_write_declined. A kernel that fails to build or launch
    raises its own error and is never declined."""


def hybrid_segments(in_rle: np.ndarray, rle_break: np.ndarray) -> np.ndarray:
    """Start positions of the hybrid stream's segments: each RLE window (a
    break starts one, so adjacent windows of different runs stay apart) and
    each stretch of bit-packed values between them."""
    seg_start = np.asarray(rle_break, dtype=bool).copy()
    if len(seg_start):
        mask = np.asarray(in_rle, dtype=bool)
        seg_start[0] = True
        seg_start[1:] |= mask[1:] != mask[:-1]
    return np.flatnonzero(seg_start)


def assemble_hybrid_device_stream(
    in_rle: np.ndarray, starts: np.ndarray, packed: np.ndarray, width: int, rle_values
) -> bytes:
    """Turn rle_hybrid_encode's run plan into the exact
    ops/rle_hybrid.encode_hybrid byte stream. `in_rle` is the fetched mask,
    `starts` its hybrid_segments, `packed` the packed payload words and
    `rle_values` the repeated value of each RLE segment, in order (the
    caller gathers them in one launch; the reference reads each with its own
    device sync). The last bit-packed group is padded with zero values to 8:
    where its bytes run past `packed` (ceil(n * width / 32) + 1 words, short
    of ceil(n_bp / 8) * width bytes when nearly every value is packed and n
    is not a multiple of 8), they are zeros."""
    n = len(in_rle)
    out = bytearray()
    if n == 0:
        return b""
    if width == 0:
        emit_uvarint(out, n << 1)
        return bytes(out)
    vbytes = (width + 7) // 8
    packed_bytes = memoryview(np.ascontiguousarray(packed)).cast("B")
    mask = np.asarray(in_rle, dtype=bool)
    bounds = np.append(starts, n).tolist()
    values = iter(np.asarray(rle_values).tolist())
    bp_done = 0  # bit-packed values consumed (tracks the payload cursor)
    for a, b in zip(bounds[:-1], bounds[1:]):
        if mask[a]:
            emit_uvarint(out, (b - a) << 1)
            out += int(next(values)).to_bytes(vbytes, "little")
        else:
            groups = (b - a + 7) // 8
            emit_uvarint(out, (groups << 1) | 1)
            byte0 = (bp_done // 8) * width
            payload = packed_bytes[byte0 : byte0 + groups * width]
            out += payload
            out += bytes(groups * width - len(payload))
            bp_done += groups * 8
    return bytes(out)


def assemble_delta_device_stream(
    nbits: int,
    n: int,
    first: int,  # values[0] in the UNSIGNED nbits domain (0 when n == 0)
    mins: np.ndarray,  # per-block min delta, signed
    widths: np.ndarray,  # int32: per-miniblock bit widths
    payload: bytes,  # packed payloads at cumsum(4 * width) byte offsets
) -> bytes:
    """Frame delta_block_encode's tables into the exact ops/delta.encode_delta
    byte stream (block_size=128, mini_count=4): uvarint header, then per
    block `<zigzag min> <4 width bytes> <payloads>`. A miniblock of 32
    values is 4 * width bytes, so the payloads slice out by a running
    cursor."""
    out = bytearray()
    emit_uvarint(out, 128)
    emit_uvarint(out, 4)
    emit_uvarint(out, n)
    emit_zigzag(out, _to_signed(int(first), nbits))
    if n <= 1:
        return bytes(out)
    n_deltas = n - 1
    mins = np.asarray(mins).tolist()
    widths = np.asarray(widths).tolist()
    pay = 0
    for blk in range((n_deltas + 127) // 128):
        emit_zigzag(out, mins[blk])
        ws = widths[blk * 4 : blk * 4 + 4]
        out += bytes(ws)
        for k, w in enumerate(ws):
            if blk * 128 + k * 32 < n_deltas:  # mini has values: full payload
                out += payload[pay : pay + 4 * w]
            pay += 4 * w
    return bytes(out)


class _DevicePageFramer:
    """Host framing of device-produced page payloads through
    core/page.frame_page (compress, Thrift header, optional CRC), as the
    host encoder frames a flat REQUIRED column's pages."""

    def __init__(self, cfg, value_encoding):
        self._cfg = cfg
        self._value_encoding = value_encoding
        self.parts: list = []
        self.pos = 0
        self.uncompressed_total = 0
        self.n_pages = 0

    def add(self, hdr: bytes, block: bytes, uncompressed: int) -> None:
        self.parts.append(hdr)
        self.parts.append(block)
        self.pos += len(hdr) + len(block)
        self.uncompressed_total += len(hdr) + uncompressed

    def frame(self, raw: bytes, n_values: int) -> None:
        cfg = self._cfg
        header, block = frame_page(raw, n_values, self._value_encoding, cfg.codec,
                                   cfg.data_page_version, cfg.with_crc)
        self.add(header.dumps(), block, len(raw))
        self.n_pages += 1


# leaf type -> (tensor dtypes the device encoder takes, their NumPy dtype)
_DEVICE_ENCODE_DTYPES = {
    Type.INT32: ((torch.int32,), np.int32),
    Type.INT64: ((torch.int64,), np.int64),
    Type.FLOAT: ((torch.float32,), np.float32),
    Type.DOUBLE: ((torch.float64,), np.float64),
}


def encode_device_column(column: Column, values, cfg, kv: dict | None = None, *,
                         enable_dict: bool = True):
    """Encode one device-resident column into an EncodedChunk whose bytes
    equal the host encoder's for the same values: a drop-in for
    sink.encoder's assemble_group/commit_group.

    `values` is a 1-D int32/int64/float32/float64 tensor, or for a
    BYTE_ARRAY leaf a `(data, offsets)` pair (uint8 bytes and n + 1 integer
    offsets, the layout the device read delivers). The leaf must be flat
    REQUIRED. On a CUDA tensor the dictionary probe, the index hybrid
    encode and bit-pack, the DELTA block scans and the byte-array framing
    run as kernels; on a CPU tensor as their plain versions. A bloom filter
    (`cfg.bloom_specs`) hashes the chunk's dictionary, or its values
    downloaded to the host, as the host encoder does. Shapes the device
    encoder does not take raise EncodeDeclined: the page index among them
    (its per-page statistics are the host encoder's), counted by the writer
    as device_write_declined."""
    if column.max_rep > 0 or column.max_def > 0:
        raise EncodeDeclined(
            "encode_device_column: only flat REQUIRED columns encode on the "
            "device (nested and optional columns go through the host writer)"
        )
    if cfg.write_page_index:
        raise EncodeDeclined(
            "encode_device_column: the page index is a host-encoder option"
        )
    if column.type == Type.BYTE_ARRAY:
        if enable_dict:
            # the host encoder would probe a dictionary, and there is no
            # byte-array uniqueness kernel: decline to keep the bytes equal
            raise EncodeDeclined(
                "encode_device_column: dictionary-eligible BYTE_ARRAY columns "
                "encode on the host (disable the dictionary for this column to "
                "take the device PLAIN route)"
            )
        return _encode_device_bytearray(column, values, cfg, kv)
    if not isinstance(values, torch.Tensor):
        raise TypeError(
            f"encode_device_column: expected a torch.Tensor, got {type(values).__name__}"
        )
    dev = values.contiguous()
    accepted = _DEVICE_ENCODE_DTYPES.get(column.type)
    if dev.dim() != 1 or accepted is None or dev.dtype not in accepted[0]:
        # an int64 batch for an INT32 leaf, ints for a DOUBLE leaf: the host
        # encoder casts them exactly (or refuses), the device one cannot
        raise EncodeDeclined(
            f"encode_device_column: {column.path_str} is {column.type!s} but the "
            f"tensor is {dev.dtype} of shape {tuple(dev.shape)} (width or kind mismatch)"
        )
    np_dt = np.dtype(accepted[1])
    n = dev.numel()
    nbits = np_dt.itemsize * 8
    # uniqueness domain: bit patterns, so NaN payloads dedup like the host
    bits = dev.view(torch.int32 if nbits == 32 else torch.int64)
    dict_values = None
    indices = None
    if enable_dict and n:
        idx_dev, firsts_dev, nu_dev = dict_indices(bits)
        nu = int(nu_dev)
        if nu <= DICT_MAX_UNIQUES:
            width = max(int(nu - 1).bit_length(), 1)
            if nu * np_dt.itemsize + (n * width) // 8 < n * np_dt.itemsize:
                dict_values = dev[firsts_dev[:nu].long()].cpu().numpy()
                indices = idx_dev
    value_encoding = (
        Encoding.RLE_DICTIONARY
        if dict_values is not None
        else cfg.column_encodings.get(column.path, Encoding.PLAIN)
    )
    delta_route = (
        dict_values is None
        and value_encoding == Encoding.DELTA_BINARY_PACKED
        and column.type in (Type.INT32, Type.INT64)
    )
    if dict_values is None and not delta_route and value_encoding != Encoding.PLAIN:
        raise EncodeDeclined(
            "encode_device_column: only PLAIN, dictionary and DELTA_BINARY_PACKED "
            f"device encodes exist for numeric columns (column asks for {value_encoding})"
        )
    host_typed = None
    stats_src = None
    if dict_values is not None:
        stats_src = dict_values
    elif delta_route:
        # DELTA never downloads the column: min/max reduce on the device in
        # the column's order (unsigned leaves: the sign bit flipped, reduced
        # signed, flipped back), and the 2-element stats_src gives the same
        # Statistics bytes
        if n:
            flip = -(1 << (nbits - 1)) if column_is_unsigned(column) else 0
            keyed = dev ^ flip
            stats_src = (torch.stack([keyed.min(), keyed.max()]) ^ flip).cpu().numpy()
        else:
            stats_src = np.zeros(0, dtype=np_dt)
        if cfg.bloom_specs.get(column.path) is not None:
            # the bloom filter hashes every value: the one download DELTA
            # otherwise never makes
            host_typed = dev.cpu().numpy()
    else:
        host_typed = dev.cpu().numpy()
        stats_src = host_typed

    framer = _DevicePageFramer(cfg, value_encoding)
    dict_offset = None
    if dict_values is not None:
        header, block = encode_dict_page(column, dict_values, cfg.codec, cfg.with_crc)
        dict_offset = framer.pos
        framer.add(header.dumps(), block, header.uncompressed_page_size or 0)
        data_offset = framer.pos
        width = max(int(len(dict_values) - 1).bit_length(), 1)
        for a, b in _split_starts(n, max(int(cfg.max_page_size // 4), 1)):
            page_idx = indices[a:b]
            in_rle, rle_break, packed, _n_bp = rle_hybrid_encode(page_idx, width)
            in_rle, rle_break = torch.stack([in_rle, rle_break]).cpu().numpy()
            starts = hybrid_segments(in_rle, rle_break)
            rle_at = starts[in_rle[starts]]
            rle_values = (
                page_idx[torch.from_numpy(rle_at).to(page_idx.device)].cpu().numpy()
                if len(rle_at) else ()
            )
            # only the words that hold the bit-packed groups come back
            bp_groups = (len(in_rle) - int(in_rle.sum()) + 7) // 8
            stream = assemble_hybrid_device_stream(
                in_rle, starts, packed[: (bp_groups * width + 3) // 4].cpu().numpy(), width,
                rle_values,
            )
            framer.frame(bytes([width]) + stream, b - a)
    elif delta_route:
        data_offset = framer.pos
        pages = list(_split_starts(n, max(int(cfg.max_page_size // np_dt.itemsize), 1)))
        firsts = [0]
        if n:
            # every page's first value in one gather and one copy
            at = torch.tensor([a for a, _ in pages], dtype=torch.int64, device=dev.device)
            firsts = bits[at].cpu().numpy().view(np.uint32 if nbits == 32 else np.uint64)
        for (a, b), first in zip(pages, firsts):
            mins, widths, words = delta_block_encode(bits[a:b])
            widths = widths.cpu().numpy()
            # the payload is sum(widths) words; nothing past it comes back
            payload = words[: int(widths.sum(dtype=np.int64))].cpu().numpy().tobytes()
            stream = assemble_delta_device_stream(
                nbits, b - a, int(first), mins.cpu().numpy(), widths, payload
            )
            framer.frame(stream, b - a)
    else:
        data_offset = framer.pos
        for a, b in _split_starts(n, max(int(cfg.max_page_size // np_dt.itemsize), 1)):
            framer.frame(host_typed[a:b].tobytes(), b - a)
    plan = _ChunkEncodePlan(
        nv=n,
        num_entries=n,
        null_count=0,
        def_levels=None,
        rep_levels=None,
        typed=host_typed,
        dict_result=(dict_values, None) if dict_values is not None else None,
        value_encoding=value_encoding,
        page_values=None,
        dict_size=len(dict_values) if dict_values is not None else None,
        stats_src=stats_src,
    )
    cc, bloom = _chunk_meta(
        cfg, column, kv, plan,
        uncompressed_total=framer.uncompressed_total,
        pos=framer.pos,
        data_offset=data_offset,
        dict_offset=dict_offset,
        n_pages=framer.n_pages,
    )
    return EncodedChunk(parts=framer.parts, nbytes=framer.pos, chunk=cc, bloom=bloom)


def host_byte_array(data: torch.Tensor, offsets: torch.Tensor) -> ByteArrayData:
    """A (data, offsets) pair of tensors as a host ByteArrayData, the
    offsets rebased to 0 and only the bytes they span copied."""
    off = offsets.cpu().numpy().astype(np.int64)
    lo, hi = int(off[0]), int(off[-1])
    return ByteArrayData(offsets=off - lo, data=data[lo:hi].cpu().numpy().tobytes())


def _encode_device_bytearray(column: Column, values, cfg, kv: dict | None):
    """BYTE_ARRAY half of encode_device_column: `values` is a (data, offsets)
    pair. The PLAIN framing (`<4-byte LE length><bytes>` per value) runs as
    one plain_bytearray_encode launch, and PLAIN streams concatenate, so the
    host slices each page's bytes out of one framed download. Statistics
    (lexicographic byte-string min/max) scan on the host, over the bytes
    downloaded once more."""
    try:
        data, offsets = values
    except (TypeError, ValueError):
        raise TypeError(
            "encode_device_column: BYTE_ARRAY columns take a (data, offsets) pair"
        ) from None
    value_encoding = cfg.column_encodings.get(column.path, Encoding.PLAIN)
    if value_encoding != Encoding.PLAIN:
        raise EncodeDeclined(
            "encode_device_column: only PLAIN device encodes exist for BYTE_ARRAY "
            f"columns (column asks for {value_encoding})"
        )
    if (
        not isinstance(data, torch.Tensor)
        or not isinstance(offsets, torch.Tensor)
        or data.dtype != torch.uint8
        or data.dim() != 1
        or offsets.dim() != 1
        or offsets.dtype not in (torch.int32, torch.int64)
        or offsets.numel() == 0
    ):
        raise EncodeDeclined(
            "encode_device_column: BYTE_ARRAY takes 1-D uint8 data and 1-D int32 "
            "or int64 offsets tensors"
        )
    offsets = offsets.to(torch.int64).contiguous()
    bad = host_byte_array(data, offsets)
    rel = bad.offsets
    n = len(rel) - 1
    framed = plain_bytearray_encode(data.contiguous(), offsets, 4 * n + int(rel[-1])).cpu().numpy()
    framer = _DevicePageFramer(cfg, value_encoding)
    data_offset = framer.pos
    for a, b in _split_starts(n, max(int(cfg.max_page_size // _value_width(bad)), 1)):
        framer.frame(framed[4 * a + int(rel[a]) : 4 * b + int(rel[b])].tobytes(), b - a)
    plan = _ChunkEncodePlan(
        nv=n,
        num_entries=n,
        null_count=0,
        def_levels=None,
        rep_levels=None,
        typed=bad,
        dict_result=None,
        value_encoding=value_encoding,
        page_values=None,
        dict_size=None,
        stats_src=bad,
    )
    cc, bloom = _chunk_meta(
        cfg, column, kv, plan,
        uncompressed_total=framer.uncompressed_total,
        pos=framer.pos,
        data_offset=data_offset,
        dict_offset=None,
        n_pages=framer.n_pages,
    )
    return EncodedChunk(parts=framer.parts, nbytes=framer.pos, chunk=cc, bloom=bloom)
