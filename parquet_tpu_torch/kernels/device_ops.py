"""Device primitives: the kernels of the decode, batch, filter, write, query
and multi-device paths.

Each primitive has three parts:

  * a CUDA C++ kernel in `kernels/csrc/` (built by `kernels/build.py`), the
    port of one XLA program of `parquet_tpu/kernels/device_ops.py`;
  * a plain PyTorch version of the same function (`*_plain`). It runs on any
    device; the wrapper uses it only for tensors that lie on the CPU, and
    `chip_smoke.py` holds the kernel against it on the card;
  * the wrapper, which checks its inputs, takes the plain version for a CPU
    tensor, and for a CUDA tensor launches the kernel on the current stream
    or raises. Each wrapper carries a plain int `launches`, which goes up by
    one where the kernel is launched and nowhere else (under one lock: the
    dispatch thread of kernels/pipeline.py launches beside the callers).

Bit patterns travel in signed dtypes: uploads are int32 (the uint32 words of
the frozen buffers) or int64 (uint64 words), and outputs hold the unsigned
results' bit patterns in int32/int64. PyTorch has no shifts, adds or
searchsorted on uint32/uint64 tensors on the CPU, so the plain versions
compute in int64 lanes with explicit masks.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

__all__ = [
    "MAX_DEVICE_BATCH_BITS",
    "bytes_to_words32",
    "bytes_to_words64",
    "expand_hybrid",
    "expand_hybrid_plain",
    "HYBRID_TILE",
    "HYBRID_STAGE_RUNS",
    "dict_gather",
    "dict_gather_plain",
    "delta_packed_decode",
    "delta_packed_decode_plain",
    "DELTA_TILE",
    "bss_transpose",
    "bss_transpose_plain",
    "bss_transpose_pages",
    "bss_transpose_pages_plain",
    "BSS_PAGES_PER_LAUNCH",
    "merge_mixed_numeric",
    "merge_mixed_numeric_plain",
    "merge_mixed_bytes",
    "merge_mixed_bytes_plain",
    "MERGE_BYTES_TILE",
    "record_starts",
    "record_starts_plain",
    "RECORD_STARTS_TILE",
    "list_layout",
    "list_layout_plain",
    "LIST_LAYOUT_TILE",
    "pad_ragged",
    "pad_ragged_plain",
    "PAD_RAGGED_TILE",
    "PAD_RAGGED_TILE_BYTES",
    "expand_nullable",
    "expand_nullable_plain",
    "EXPAND_NULLABLE_TILE",
    "EXPAND_NULLABLE_GROUP",
    "predicate_mask",
    "predicate_mask_plain",
    "predicate_block",
    "leaf_verdict",
    "leaf_verdict_plain",
    "LEAF_VERDICT_TILE",
    "LEAF_VERDICT_GROUP",
    "list_contains_mask",
    "list_contains_mask_plain",
    "LIST_CONTAINS_TILE",
    "mask_take",
    "mask_take_plain",
    "mask_take_scan",
    "mask_take_scan_plain",
    "mask_take_rows",
    "mask_take_rows_plain",
    "MASK_TAKE_TILE",
    "MASK_TAKE_BLOCKS",
    "bitpack_encode",
    "bitpack_encode_plain",
    "BITPACK_TILE",
    "rle_hybrid_encode",
    "rle_hybrid_encode_plain",
    "RLE_PLAN_TILE",
    "dict_indices",
    "dict_indices_plain",
    "DICT_INDICES_TILE",
    "delta_block_encode",
    "delta_block_encode_plain",
    "DELTA_ENCODE_TILE",
    "DELTA_ENCODE_GROUP",
    "plain_bytearray_encode",
    "plain_bytearray_encode_plain",
    "FRAME_TILE",
    "masked_agg",
    "masked_agg_plain",
    "expand_page_grid",
    "expand_page_grid_plain",
    "PAGE_GRID_TILE",
    "PAGE_GRID_ITEMS",
    "PAGE_GRID_STAGE_RUNS",
    "KERNELS",
    "reset_launch_counts",
]

# Largest bit offset the kernels' int32 position tables can hold (the host
# batches split before it; 2^31 bits = 256 MiB of packed payload).
MAX_DEVICE_BATCH_BITS = 1 << 31

_M32 = 0xFFFFFFFF


def bytes_to_words32(data: bytes) -> np.ndarray:
    """Pad bytes to a uint32 LE word array (+1 guard word for the hi gather)."""
    pad = (-len(data)) % 4
    buf = bytes(data) + b"\x00" * (pad + 4)
    return np.frombuffer(buf, dtype="<u4")


def bytes_to_words64(data: bytes) -> np.ndarray:
    pad = (-len(data)) % 8
    buf = bytes(data) + b"\x00" * (pad + 8)
    return np.frombuffer(buf, dtype="<u8")


# -- shared wrapper plumbing ---------------------------------------------------


def _check_vec(t: torch.Tensor, dtypes, name: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D tensor, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; False when all lie on one CUDA
    device; raises for any other device or a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(
            f"device {dev} not supported: the kernels run on CUDA, the plain "
            "versions on the CPU"
        )
    return False


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _launch(name: str, device: torch.device, fn, *args) -> None:
    """Call a C entry point on `device`'s current stream; raise on a nonzero
    cudaError_t (a refused launch never runs, and no synchronize reports it)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


_COUNT_LOCK = threading.Lock()


def _count(fn, n: int = 1, table: str | None = None, key=None) -> None:
    """Add n to fn.launches (and to fn.<table>[key]) under one lock: the
    dispatch thread and the callers' threads launch at once, and `+=` on an
    attribute is not atomic."""
    with _COUNT_LOCK:
        fn.launches += n
        if table is not None:
            counts = getattr(fn, table)
            counts[key] = counts.get(key, 0) + n


def _lib():
    from .build import load

    return load()


def _to_signed32(v: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding uint32 values -> int32 with the same bit pattern."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values in int64 lanes."""
    return t.to(torch.int64) & _M32


def _lshr64(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 lanes (as uint64) by s in [0, 63]."""
    mask = torch.bitwise_not(torch.full_like(x, -1) << (64 - s).clamp(max=63))
    return torch.where(s == 0, x, (x >> s) & mask)


def _search_right(table: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """searchsorted(table, i, side='right') - 1 (int64)."""
    return torch.searchsorted(table, i, right=True).to(torch.int64) - 1


# -- expand_hybrid -------------------------------------------------------------


def expand_hybrid_plain(
    buf: torch.Tensor, width: int, run_pad: int, total: int
) -> torch.Tensor:
    """Plain version of the hybrid expansion (layout in
    kernels/csrc/expand_hybrid.cu). Returns int32[total] holding the uint32
    values' bit patterns."""
    dev = buf.device
    if width == 0 or total == 0:
        return torch.zeros(total, dtype=torch.int32, device=dev)
    is_rle = buf[:run_pad] != 0
    out_start = buf[run_pad : 2 * run_pad].contiguous()
    rle_value = _u32(buf[2 * run_pad : 3 * run_pad])
    bit_start = buf[3 * run_pad : 4 * run_pad].to(torch.int64)
    words = _u32(buf[4 * run_pad :])
    i = torch.arange(total, dtype=torch.int32, device=dev)
    r = _search_right(out_start, i)
    within = i.to(torch.int64) - out_start.to(torch.int64)[r]
    bitpos = bit_start[r] + within * width
    rle = is_rle[r]
    # RLE outputs read word 0 (their bitpos is meaningless): keep gathers in range
    bitpos = torch.where(rle, torch.zeros_like(bitpos), bitpos)
    w0 = bitpos >> 5
    s = bitpos & 31
    lo = words[w0] >> s
    hi = torch.where(s == 0, torch.zeros_like(lo), (words[w0 + 1] << (32 - s)) & _M32)
    mask = (1 << width) - 1 if width < 32 else _M32
    v = torch.where(rle, rle_value[r], (lo | hi) & mask)
    return _to_signed32(v)


# Outputs one block of the CUDA kernel expands, and the run-table entries it
# stages in shared memory (kTile and kStageRuns of
# kernels/csrc/expand_hybrid.cu, pinned by a test): a tile of a longer
# table spanning more runs reads the tables in place.
HYBRID_TILE = 1024
HYBRID_STAGE_RUNS = 128


def expand_hybrid(buf: torch.Tensor, width: int, run_pad: int, total: int) -> torch.Tensor:
    """Expand a prescanned RLE/bit-packed hybrid batch (the packed upload of
    kernels/pipeline._HybridBatch.freeze) into int32[total] values.

    Replaces parquet_tpu/kernels/device_ops.py:expand_hybrid_device; the
    port writes exactly `total` outputs instead of an n_pad bucket."""
    _check_vec(buf, (torch.int32,), "expand_hybrid: buf")
    if not 0 <= width <= 32:
        raise ValueError(f"expand_hybrid: width {width} outside 0..32")
    if run_pad <= 0 or buf.numel() < 4 * run_pad + 2:
        raise ValueError(
            f"expand_hybrid: buf of {buf.numel()} words too short for run_pad {run_pad}"
        )
    if total < 0 or total >= (1 << 31):
        raise ValueError(f"expand_hybrid: total {total} outside int32 range")
    if _on_cpu(buf):
        return expand_hybrid_plain(buf, width, run_pad, total)
    out = torch.empty(total, dtype=torch.int32, device=buf.device)
    if total:
        _launch(
            "expand_hybrid", buf.device, _lib().pqt_expand_hybrid,
            _ptr(buf), run_pad, width, total, _ptr(out),
        )
        _count(expand_hybrid, 1, "launches_by_width", width)
    return out


expand_hybrid.launches = 0
# the same launches by bit width (the shapes of the tuning queue)
expand_hybrid.launches_by_width = {}


# -- dict_gather ---------------------------------------------------------------


def dict_gather_plain(dictionary: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Plain version of `dictionary[indices]` with jnp's out-of-range rule:
    a negative index wraps once, then the index clamps into [0, D-1]."""
    d = dictionary.numel()
    idx = indices.to(torch.int64)
    idx = torch.where(idx < 0, idx + d, idx).clamp(0, d - 1)
    return dictionary[idx]


def dict_gather(dictionary: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """out[i] = dictionary[indices[i]] for 4- and 8-byte elements (floats as
    their int32/int64 bit patterns). Replaces
    parquet_tpu/kernels/device_ops.py:dict_gather_device."""
    _check_vec(
        dictionary, (torch.int32, torch.int64), "dict_gather: dictionary"
    )
    _check_vec(indices, (torch.int32,), "dict_gather: indices")
    n = indices.numel()
    if n and dictionary.numel() == 0:
        raise ValueError("dict_gather: empty dictionary with indices to gather")
    if _on_cpu(dictionary, indices):
        return dict_gather_plain(dictionary, indices)
    out = torch.empty(n, dtype=dictionary.dtype, device=dictionary.device)
    if n:
        lib = _lib()
        fn = lib.pqt_dict_gather4 if dictionary.dtype == torch.int32 else lib.pqt_dict_gather8
        _launch(
            "dict_gather", dictionary.device, fn,
            _ptr(dictionary), dictionary.numel(), _ptr(indices), n, _ptr(out),
        )
        _count(dict_gather)
    return out


dict_gather.launches = 0


# -- delta_packed_decode -------------------------------------------------------


def _delta_fields(meta32, wide, nbits, m_pad, p_pad):
    """Split the frozen uploads into (width, bit_start, out_start, page_start,
    mb_min, page_first, words); unsigned fields as int64 lanes."""
    width = _u32(meta32[:m_pad])
    bit_start = meta32[m_pad : 2 * m_pad].to(torch.int64)
    out_start = meta32[2 * m_pad : 3 * m_pad].contiguous()
    page_start = meta32[3 * m_pad : 3 * m_pad + p_pad].contiguous()
    if nbits == 32:
        base = 3 * m_pad + p_pad
        mb_min = _u32(meta32[base : base + m_pad])
        page_first = _u32(meta32[base + m_pad : base + m_pad + p_pad])
        words = _u32(meta32[base + m_pad + p_pad :])
    else:
        mb_min = wide[:m_pad]
        page_first = wide[m_pad : m_pad + p_pad]
        words = wide[m_pad + p_pad :]
    return width, bit_start, out_start, page_start, mb_min, page_first, words


def delta_packed_decode_plain(
    meta32: torch.Tensor,
    wide: torch.Tensor,
    nbits: int,
    m_pad: int,
    p_pad: int,
    total: int,
) -> torch.Tensor:
    """Plain version of the DELTA_BINARY_PACKED chunk decode (layout in
    kernels/csrc/delta_packed_decode.cu). int32 or int64 [total]."""
    dev = meta32.device
    out_dtype = torch.int32 if nbits == 32 else torch.int64
    if total == 0:
        return torch.zeros(0, dtype=out_dtype, device=dev)
    width, bit_start, out_start, page_start, mb_min, page_first, words = _delta_fields(
        meta32, wide, nbits, m_pad, p_pad
    )
    i = torch.arange(total, dtype=torch.int32, device=dev)
    i64 = i.to(torch.int64)
    p = _search_right(page_start, i)
    is_start = i64 == page_start.to(torch.int64)[p]
    m = _search_right(out_start, i).clamp(min=0)  # -1 only at page starts
    w = width[m]
    bitpos = bit_start[m] + (i64 - out_start.to(torch.int64)[m]) * w
    bitpos = torch.where(is_start, torch.zeros_like(bitpos), bitpos)
    if nbits == 32:
        w0 = bitpos >> 5
        s = bitpos & 31
        lo = words[w0] >> s
        hi = torch.where(s == 0, torch.zeros_like(lo), (words[w0 + 1] << (32 - s)) & _M32)
        mask = torch.where(w >= 32, torch.full_like(w, _M32), (1 << w.clamp(max=31)) - 1)
        d = (((lo | hi) & mask) + mb_min[m]) & _M32
        d = torch.where(is_start, torch.zeros_like(d), d)
        c = torch.cumsum(d, 0) & _M32
        vals = (page_first[p] + c - c[page_start.to(torch.int64)[p]]) & _M32
        return _to_signed32(vals)
    w0 = bitpos >> 6
    s = bitpos & 63
    lo = _lshr64(words[w0], s)
    hi = torch.where(s == 0, torch.zeros_like(lo), words[w0 + 1] << (64 - s).clamp(max=63))
    mask = torch.where(
        w >= 64, torch.full_like(w, -1), (torch.ones_like(w) << w.clamp(max=63)) - 1
    )
    d = ((lo | hi) & mask) + mb_min[m]
    d = torch.where(is_start, torch.zeros_like(d), d)
    c = torch.cumsum(d, 0)  # int64 adds wrap: the uint64 scan's bit pattern
    return page_first[p] + c - c[page_start.to(torch.int64)[p]]


# Outputs one block of the CUDA kernel decodes (kTile of
# kernels/csrc/delta_packed_decode.cu, pinned by a test).
DELTA_TILE = 2048


def delta_packed_decode(
    meta32: torch.Tensor,
    wide: torch.Tensor,
    nbits: int,
    m_pad: int,
    p_pad: int,
    total: int,
) -> torch.Tensor:
    """Decode a frozen DELTA_BINARY_PACKED batch (kernels/pipeline.
    _DeltaBatch.freeze) into int32/int64[total]. Replaces
    parquet_tpu/kernels/device_ops.py:delta_packed_decode_device."""
    if nbits not in (32, 64):
        raise ValueError(f"delta_packed_decode: nbits {nbits} not 32 or 64")
    _check_vec(meta32, (torch.int32,), "delta_packed_decode: meta32")
    _check_vec(
        wide, (torch.int32 if nbits == 32 else torch.int64,), "delta_packed_decode: wide"
    )
    if m_pad <= 0 or p_pad <= 0:
        raise ValueError("delta_packed_decode: m_pad and p_pad must be positive")
    if total < 0 or total >= (1 << 31):
        raise ValueError(f"delta_packed_decode: total {total} outside int32 range")
    if nbits == 32:
        if meta32.numel() < 4 * m_pad + 2 * p_pad + 2:
            raise ValueError("delta_packed_decode: meta32 too short for its tables")
    elif meta32.numel() < 3 * m_pad + p_pad or wide.numel() < m_pad + p_pad + 2:
        raise ValueError("delta_packed_decode: uploads too short for their tables")
    if _on_cpu(meta32, wide):
        return delta_packed_decode_plain(meta32, wide, nbits, m_pad, p_pad, total)
    dt = torch.int32 if nbits == 32 else torch.int64
    dev = meta32.device
    out = torch.empty(total, dtype=dt, device=dev)
    if total:
        lib = _lib()
        # the per-tile look-back descriptors; no scratch of `total` elements
        scratch = torch.empty(lib.pqt_delta_scratch_words(total), dtype=torch.int64, device=dev)
        _launch(
            "delta_packed_decode", dev, lib.pqt_delta_packed_decode,
            _ptr(meta32), _ptr(wide), nbits, m_pad, p_pad, total, _ptr(out), _ptr(scratch),
        )
        _count(delta_packed_decode)
    return out


delta_packed_decode.launches = 0


# -- bss_transpose -------------------------------------------------------------


def bss_transpose_plain(streams: torch.Tensor, num_values: int) -> torch.Tensor:
    """Plain version of the BYTE_STREAM_SPLIT de-interleave: byte k of value
    i is streams[k, i]. Returns int32[num_values] holding the uint32 words'
    bit patterns."""
    b = streams[:, :num_values].to(torch.int64)
    v = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
    return _to_signed32(v)


def bss_transpose_pages_plain(pages) -> torch.Tensor:
    """Plain version of the chunk's de-interleave: every page's values, one
    page after another (the JAX pipeline's concatenate of the pages)."""
    return torch.cat([bss_transpose_plain(s, nv) for s, nv in pages])


# Pages one launch of the chunk's de-interleave takes (kPages of
# kernels/csrc/bss_transpose.cu, pinned by a test): the page table travels
# in the kernel's parameters.
BSS_PAGES_PER_LAUNCH = 64


def _check_streams(streams: torch.Tensor, num_values: int, name: str) -> None:
    if not isinstance(streams, torch.Tensor):
        raise TypeError(f"{name}: streams must be a torch.Tensor")
    if streams.dtype != torch.uint8 or streams.dim() != 2 or streams.shape[0] != 4:
        raise ValueError(
            f"{name}: expected a (4, n_pad) uint8 tensor, got "
            f"{tuple(streams.shape)} {streams.dtype}"
        )
    if not streams.is_contiguous():
        raise ValueError(f"{name}: streams must be contiguous")
    n_pad = streams.shape[1]
    if not 0 <= num_values <= n_pad or n_pad >= (1 << 31):
        raise ValueError(f"{name}: {num_values} values in a stream of {n_pad}")


def bss_transpose_pages(pages) -> torch.Tensor:
    """De-interleave a chunk's 4-byte BYTE_STREAM_SPLIT pages into one
    int32[sum of num_values] (int32 bit patterns), page after page: `pages`
    is a non-empty sequence of (streams, num_values), each streams a (4,
    n_pad) uint8 tensor (one stream per row, padded) whose value i is the
    little-endian word of streams[0..3, i]. Replaces the JAX pipeline's
    bss_transpose_device per page and the concatenate of the pages: one
    launch writes up to BSS_PAGES_PER_LAUNCH pages at their offsets."""
    pages = list(pages)
    if not pages:
        raise ValueError("bss_transpose_pages: no pages")
    for streams, nv in pages:
        _check_streams(streams, nv, "bss_transpose_pages")
    if _on_cpu(*(s for s, _ in pages)):
        return bss_transpose_pages_plain(pages)
    dev = pages[0][0].device
    out = torch.empty(sum(nv for _, nv in pages), dtype=torch.int32, device=dev)
    table = np.array([(_ptr(s), s.shape[1], nv) for s, nv in pages if nv], dtype=np.int64)
    if len(table):
        _launch(
            "bss_transpose", dev, _lib().pqt_bss_transpose_pages,
            table.ctypes.data, len(table), _ptr(out),
        )
        _count(bss_transpose, -(-len(table) // BSS_PAGES_PER_LAUNCH))
    return out


def bss_transpose(streams: torch.Tensor, num_values: int) -> torch.Tensor:
    """De-interleave one 4-byte BYTE_STREAM_SPLIT page: the four byte
    streams arrive as a (4, n_pad) uint8 tensor (one stream per row,
    padded), and out[i] is the little-endian word of streams[0..3, i], as
    int32 bit patterns. Replaces parquet_tpu/kernels/device_ops.py:
    bss_transpose_device (and its jitted _bss_transpose_padded); the port
    writes exactly `num_values` words, with bss_transpose_pages' kernel."""
    _check_streams(streams, num_values, "bss_transpose")
    if _on_cpu(streams):
        return bss_transpose_plain(streams, num_values)
    return bss_transpose_pages([(streams, num_values)])


bss_transpose.launches = 0


# -- the mixed dict/PLAIN merges -----------------------------------------------


def _bucket(n: int, floor: int = 1024) -> int:
    """Next power-of-two bucket >= n (>= floor): the shapes the JAX pipeline
    pads its uploads to (pipeline._bucket, _pad_device). The merges'
    out-of-range reads are defined against those padded shapes, so the port
    replicates their effect from the sizes alone and uploads no padding."""
    b = floor
    while b < n:
        b <<= 1
    return b


def _take_or_zero(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] where 0 <= i < len(t), else 0 (the zero padding's value)."""
    n = t.numel()
    if n == 0:
        return torch.zeros(i.shape, dtype=t.dtype, device=t.device)
    return torch.where(i < n, t[i.clamp(0, n - 1)], torch.zeros((), dtype=t.dtype, device=t.device))


def _merge_pages(page_kind, page_row_start, page_aux, n_rows, dev):
    """(is_dict, src, pg) per output row: the row's page (a search over the
    page row starts), whether it is a dict page, and aux[pg] + its offset
    within the page."""
    p_pad = page_kind.numel()
    rows = torch.arange(n_rows, dtype=torch.int64, device=dev)
    prs = page_row_start.to(torch.int64)
    pg = torch.searchsorted(prs[1:].contiguous(), rows, right=True).clamp(max=p_pad - 1)
    rel = rows - prs[pg]
    return page_kind[pg] == 1, page_aux.to(torch.int64)[pg] + rel, pg


def _check_pages(page_kind, page_row_start, page_aux, name):
    for t, what in ((page_kind, "page_kind"), (page_row_start, "page_row_start"),
                    (page_aux, "page_aux")):
        _check_vec(t, (torch.int32,), f"{name}: {what}")
    p_pad = page_kind.numel()
    if p_pad == 0 or page_aux.numel() != p_pad or page_row_start.numel() != p_pad + 1:
        raise ValueError(
            f"{name}: page tables of {p_pad}, {page_row_start.numel()} and "
            f"{page_aux.numel()} entries (want P, P + 1, P with P >= 1)"
        )


def merge_mixed_numeric_plain(
    idx_all: torch.Tensor,
    dictionary: torch.Tensor,
    plain: torch.Tensor,
    page_kind: torch.Tensor,
    page_row_start: torch.Tensor,
    page_aux: torch.Tensor,
    n_rows: int,
) -> torch.Tensor:
    """Plain version of the mixed dict/PLAIN numeric merge, with the JAX
    program's clamping over its zero-padded inputs: the row's source index
    clamps below at 0 and above at the last padded slot; a dict index clamps
    into [0, bucket(n_dict) - 1] and reads 0 past the real dictionary."""
    dev = dictionary.device
    is_dict, src, _pg = _merge_pages(page_kind, page_row_start, page_aux, n_rows, dev)
    src = src.clamp(min=0)
    d_pad = _bucket(max(idx_all.numel(), 1))
    i = _take_or_zero(idx_all, src.clamp(max=d_pad - 1)).to(torch.int64)
    i = i.clamp(0, _bucket(max(dictionary.numel(), 1)) - 1)
    dv = _take_or_zero(dictionary, i)
    pv = _take_or_zero(plain, src.clamp(max=_bucket(max(plain.numel(), 1)) - 1))
    return torch.where(is_dict, dv, pv)


def merge_mixed_numeric(
    idx_all: torch.Tensor,
    dictionary: torch.Tensor,
    plain: torch.Tensor,
    page_kind: torch.Tensor,
    page_row_start: torch.Tensor,
    page_aux: torch.Tensor,
    n_rows: int,
) -> torch.Tensor:
    """Merge a mixed dict/PLAIN numeric chunk in output-row order: a row of a
    dict page reads dictionary[idx_all[aux + rel]], a row of a PLAIN page
    reads plain[aux + rel] (4- or 8-byte elements; floats as bit patterns).
    Page tables as pipeline._page_merge_tables builds them. Replaces
    parquet_tpu/kernels/device_ops.py:merge_mixed_numeric_device, called as
    the JAX pipeline calls it (inputs zero-padded to their buckets, the
    output sliced to n_rows); the port writes exactly n_rows values."""
    _check_vec(idx_all, (torch.int32,), "merge_mixed_numeric: idx_all")
    _check_vec(dictionary, (torch.int32, torch.int64), "merge_mixed_numeric: dictionary")
    _check_vec(plain, (dictionary.dtype,), "merge_mixed_numeric: plain")
    _check_pages(page_kind, page_row_start, page_aux, "merge_mixed_numeric")
    if not 0 <= n_rows < (1 << 31):
        raise ValueError(f"merge_mixed_numeric: n_rows {n_rows} outside int32 range")
    sizes = (idx_all.numel(), dictionary.numel(), plain.numel())
    if max(sizes) >= (1 << 31):
        raise ValueError(f"merge_mixed_numeric: inputs of {sizes} exceed int32 range")
    tensors = (idx_all, dictionary, plain, page_kind, page_row_start, page_aux)
    if _on_cpu(*tensors):
        return merge_mixed_numeric_plain(*tensors, n_rows)
    dev = dictionary.device
    out = torch.empty(n_rows, dtype=dictionary.dtype, device=dev)
    if n_rows:
        lib = _lib()
        fn = (
            lib.pqt_merge_mixed_numeric4
            if dictionary.dtype == torch.int32
            else lib.pqt_merge_mixed_numeric8
        )
        _launch(
            "merge_mixed_numeric", dev, fn,
            _ptr(idx_all), sizes[0], _bucket(max(sizes[0], 1)),
            _ptr(dictionary), sizes[1], _bucket(max(sizes[1], 1)),
            _ptr(plain), sizes[2], _bucket(max(sizes[2], 1)),
            _ptr(page_kind), _ptr(page_row_start), _ptr(page_aux), page_kind.numel(),
            n_rows, _ptr(out),
        )
        _count(merge_mixed_numeric)
    return out


merge_mixed_numeric.launches = 0


def _bytes_rows(idx_all, doff, po32, page_kind, page_row_start, page_aux,
                page_src_base, n_rows):
    """(start, length) per output row of the ragged merge, int64."""
    dev = doff.device
    is_dict, src, pg = _merge_pages(page_kind, page_row_start, page_aux, n_rows, dev)
    d_pad = _bucket(max(idx_all.numel(), 1))
    j = torch.where(is_dict, src, torch.zeros_like(src)).clamp(0, d_pad - 1)
    idx = _take_or_zero(idx_all, j).to(torch.int64)
    # doff pads to bucket(len(doff), 1024) with its last offset: an index
    # past the dictionary reads an empty entry
    idx = idx.clamp(0, _bucket(doff.numel()) - 2)
    last = doff.numel() - 1
    dstart = doff[idx.clamp(max=last)]
    dlen = doff[(idx + 1).clamp(max=last)] - dstart
    e_pad = _bucket(po32.numel())
    e = torch.where(is_dict, torch.zeros_like(src), src).clamp(0, e_pad - 2)
    p0 = _take_or_zero(po32, e).to(torch.int64)
    p1 = _take_or_zero(po32, e + 1).to(torch.int64)
    start = torch.where(is_dict, dstart, p0 + page_src_base[pg])
    length = torch.where(is_dict, dlen, p1 - p0).clamp(min=0)
    return start, length


def merge_mixed_bytes_plain(
    idx_all: torch.Tensor,
    doff: torch.Tensor,
    pool: torch.Tensor,
    po32: torch.Tensor,
    page_kind: torch.Tensor,
    page_row_start: torch.Tensor,
    page_aux: torch.Tensor,
    page_src_base: torch.Tensor,
    n_rows: int,
    data_bytes: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ragged mixed dict/PLAIN byte-array merge, with
    the JAX program's clamping over its padded inputs. Returns (data
    uint8[data_bytes], offsets int64[n_rows + 1]); bytes past
    offsets[n_rows] are zero."""
    dev = doff.device
    start, length = _bytes_rows(
        idx_all, doff, po32, page_kind, page_row_start, page_aux, page_src_base, n_rows
    )
    offsets = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(length, 0, out=offsets[1:])
    total = int(offsets[-1])
    if total > data_bytes:
        raise ValueError(f"merge_mixed_bytes: {total} bytes exceed the bound {data_bytes}")
    data = torch.zeros(data_bytes, dtype=torch.uint8, device=dev)
    if total:
        row = torch.repeat_interleave(torch.arange(n_rows, device=dev), length)
        pos = torch.arange(total, dtype=torch.int64, device=dev) - offsets[row]
        data[:total] = pool[(start[row] + pos).clamp(0, pool.numel() - 1)]
    return data, offsets


# Rows one block of the CUDA kernel merges (kTile of
# kernels/csrc/merge_mixed_bytes.cu, pinned by a test).
MERGE_BYTES_TILE = 1024


def merge_mixed_bytes(
    idx_all: torch.Tensor,
    doff: torch.Tensor,
    pool: torch.Tensor,
    po32: torch.Tensor,
    page_kind: torch.Tensor,
    page_row_start: torch.Tensor,
    page_aux: torch.Tensor,
    page_src_base: torch.Tensor,
    n_rows: int,
    data_bytes: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize a mixed dict/PLAIN byte-array chunk: dict rows copy their
    dictionary entry (doff offsets into the head of `pool`), PLAIN rows copy
    their bytes (po32: the PLAIN pages' int32 offset arrays concatenated;
    page_src_base: each PLAIN page's byte base in `pool`). Returns (data
    uint8[data_bytes], offsets int64[n_rows + 1]). `data_bytes` is the
    caller's upper bound on the total, so nothing waits for the device to
    size the output; the kernel writes data[:offsets[n_rows]] and leaves the
    rest of `data` unwritten. Replaces
    parquet_tpu/kernels/device_ops.py:merge_mixed_bytes_device, called as
    the JAX pipeline calls it (padded inputs, sliced outputs)."""
    _check_vec(idx_all, (torch.int32,), "merge_mixed_bytes: idx_all")
    _check_vec(doff, (torch.int64,), "merge_mixed_bytes: doff")
    _check_vec(pool, (torch.uint8,), "merge_mixed_bytes: pool")
    _check_vec(po32, (torch.int32,), "merge_mixed_bytes: po32")
    _check_vec(page_src_base, (torch.int64,), "merge_mixed_bytes: page_src_base")
    _check_pages(page_kind, page_row_start, page_aux, "merge_mixed_bytes")
    if page_src_base.numel() != page_kind.numel():
        raise ValueError("merge_mixed_bytes: page_src_base must have one entry per page")
    if doff.numel() < 1 or po32.numel() < 2 or pool.numel() < 1:
        raise ValueError("merge_mixed_bytes: doff, po32 and pool must not be empty")
    if not 0 <= n_rows < (1 << 31) or data_bytes < 0:
        raise ValueError(f"merge_mixed_bytes: n_rows {n_rows} / data_bytes {data_bytes}")
    if max(idx_all.numel(), doff.numel(), po32.numel()) >= (1 << 31):
        raise ValueError("merge_mixed_bytes: tables exceed int32 range")
    tensors = (idx_all, doff, pool, po32, page_kind, page_row_start, page_aux, page_src_base)
    if _on_cpu(*tensors):
        return merge_mixed_bytes_plain(*tensors, n_rows, data_bytes)
    dev = doff.device
    data = torch.empty(data_bytes, dtype=torch.uint8, device=dev)
    offsets = torch.empty(n_rows + 1, dtype=torch.int64, device=dev)
    lib = _lib()
    # the per-tile look-back descriptors; no scratch of n_rows elements
    scratch = torch.empty(lib.pqt_merge_bytes_scratch_words(n_rows), dtype=torch.int64, device=dev)
    _launch(
        "merge_mixed_bytes", dev, lib.pqt_merge_mixed_bytes,
        _ptr(idx_all), idx_all.numel(), _bucket(max(idx_all.numel(), 1)),
        _ptr(doff), doff.numel(), _bucket(doff.numel()),
        _ptr(pool), pool.numel(),
        _ptr(po32), po32.numel(), _bucket(po32.numel()),
        _ptr(page_kind), _ptr(page_row_start), _ptr(page_aux), _ptr(page_src_base),
        page_kind.numel(), n_rows, data_bytes,
        _ptr(data), _ptr(offsets), _ptr(scratch),
    )
    _count(merge_mixed_bytes)
    return data, offsets


merge_mixed_bytes.launches = 0


# -- the batch path: record starts, list layout, ragged padding, nulls ---------
#
# Scans (kernels/csrc/scan.cuh) with their epilogues. The one-pass scans of
# record_starts and list_layout (and of list_contains_mask below) take only
# their look-back descriptors: a counter, a pad word and 16 bytes a tile.
# expand_nullable (and leaf_verdict below) count a validity's tiles, then
# place them (kernels/csrc/validity.cuh): their scratch is a count a tile
# and a count a group of tiles.

_INT32_LIMIT = 1 << 31
# dtypes the byte-width kernels copy (1-, 4- and 8-byte elements)
_COPY_DTYPES = (
    torch.bool, torch.uint8, torch.int8, torch.int32, torch.float32, torch.int64, torch.float64,
)


def _check_len(n: int, name: str) -> None:
    if n >= _INT32_LIMIT:
        raise ValueError(f"{name}: {n} entries exceed the int32 range of the scans")


def _check_values(values: torch.Tensor, name: str) -> None:
    """Values of the byte-width kernels: a 1-D contiguous tensor of a copyable
    dtype. 2-D values (FIXED_LEN_BYTE_ARRAY, INT96 as (n, w) uint8) have no
    row layout here, as in the reference, whose select fails to broadcast."""
    if not isinstance(values, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(values).__name__}")
    if values.dim() != 1:
        raise ValueError(
            f"{name}: values of shape {tuple(values.shape)} have no device batch "
            "layout (only 1-D columns pad or expand)"
        )
    _check_vec(values, _COPY_DTYPES, name)


def _descriptors(n: int, tile: int, device) -> torch.Tensor:
    """Look-back scratch of a one-pass scan over n items in tiles of `tile`:
    a counter, a pad word and 16 bytes a tile (zeroed by the kernel's own
    memset)."""
    return torch.empty(2 + 2 * -(-n // tile), dtype=torch.int64, device=device)


def record_starts_plain(rep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the record starts: (row_of int32[n] = inclusive count
    of rep == 0, minus 1; n_rows int64 0-d)."""
    starts = (rep == 0).to(torch.int32)
    row_of = torch.cumsum(starts, 0, dtype=torch.int32) - 1
    return row_of, starts.sum(dtype=torch.int64)


# Entries a tile of the record-starts kernel scans (kThreads * kItems of
# kernels/csrc/record_starts.cu, pinned by a test).
RECORD_STARTS_TILE = 8192


def record_starts(rep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Which record each level entry belongs to: row_of int32[n] (the
    inclusive count of rep == 0 minus 1, so -1 for leading entries that start
    no record) and n_rows, a 0-d int64 tensor (the JAX program's count is
    int64 under x64). Replaces
    parquet_tpu/kernels/device_ops.py:record_starts_device."""
    _check_vec(rep, (torch.int32,), "record_starts: rep")
    n = rep.numel()
    _check_len(n, "record_starts")
    if _on_cpu(rep):
        return record_starts_plain(rep)
    dev = rep.device
    row_of = torch.empty(n, dtype=torch.int32, device=dev)
    if not n:
        return row_of, torch.zeros((), dtype=torch.int64, device=dev)
    n_rows = torch.empty((), dtype=torch.int64, device=dev)
    lib = _lib()
    descriptors = _descriptors(n, RECORD_STARTS_TILE, dev)
    _launch(
        "record_starts", dev, lib.pqt_record_starts,
        _ptr(rep), n, _ptr(row_of), _ptr(n_rows), _ptr(descriptors),
    )
    _count(record_starts)
    return row_of, n_rows


record_starts.launches = 0


def list_layout_plain(
    rep: torch.Tensor, dfl: torch.Tensor, parent_rep: int, elem_def: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the list layout, the reference's scatter-adds into
    slot clip(slot_of, 0, n - 1) as written: (offsets int32[n + 1],
    first_def int32[n], n_slots int64 0-d)."""
    dev = rep.device
    n = rep.numel()
    r64 = rep.to(torch.int64)
    boundary = r64 <= parent_rep
    slot_of = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    elem_start = (r64 <= parent_rep + 1) & (dfl.to(torch.int64) >= elem_def)
    slot = slot_of.clamp(0, max(n - 1, 0)).to(torch.int64)
    counts = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, slot, elem_start.to(torch.int32)
    )
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    first_def = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, slot, torch.where(boundary, dfl, torch.zeros_like(dfl))
    )
    return offsets, first_def, boundary.sum(dtype=torch.int64)


# Entries a tile of the list-layout kernel scans (kThreads * kItems of
# kernels/csrc/list_layout.cu, pinned by a test).
LIST_LAYOUT_TILE = 4096


def list_layout(
    rep: torch.Tensor, dfl: torch.Tensor, parent_rep: int, elem_def: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One nesting depth's Arrow-style layout from device-resident levels:
    (offsets int32[n + 1], entries past n_slots repeating the total;
    first_def int32[n], each slot's boundary entry's def level, entries past
    n_slots 0; n_slots, a 0-d int64 tensor). An entry opens a slot iff
    rep <= parent_rep and starts an element iff rep <= parent_rep + 1 and
    dfl >= elem_def; leading entries before the first boundary count into
    slot 0, as the reference's clip puts them. Replaces
    parquet_tpu/kernels/device_ops.py:list_layout_device."""
    _check_vec(rep, (torch.int32,), "list_layout: rep")
    _check_vec(dfl, (torch.int32,), "list_layout: dfl")
    n = rep.numel()
    if dfl.numel() != n:
        raise ValueError(f"list_layout: {n} rep levels but {dfl.numel()} def levels")
    _check_len(n, "list_layout")
    parent_rep, elem_def = int(parent_rep), int(elem_def)
    if _on_cpu(rep, dfl):
        return list_layout_plain(rep, dfl, parent_rep, elem_def)
    dev = rep.device
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    first_def = torch.empty(n, dtype=torch.int32, device=dev)
    if not n:
        offsets.zero_()
        return offsets, first_def, torch.zeros((), dtype=torch.int64, device=dev)
    n_slots = torch.empty((), dtype=torch.int64, device=dev)
    descriptors = _descriptors(n, LIST_LAYOUT_TILE, dev)
    _launch(
        "list_layout", dev, _lib().pqt_list_layout,
        _ptr(rep), _ptr(dfl), n, parent_rep, elem_def,
        _ptr(offsets), _ptr(first_def), _ptr(n_slots), _ptr(descriptors),
    )
    _count(list_layout)
    return offsets, first_def, n_slots


list_layout.launches = 0


def pad_ragged_plain(values: torch.Tensor, lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Plain version of the ragged padding, as the reference's `pad` writes
    it: int32 row offsets, a [rows, max_len] index matrix clipped into
    [0, nv - 1], and zeros past each row's length (all zeros when nv == 0)."""
    dev = values.device
    rows = lengths.numel()
    offs = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
    offs[1:] = torch.cumsum(lengths, 0, dtype=torch.int32)
    ar = torch.arange(max_len, dtype=torch.int32, device=dev)
    idx = offs[:-1, None] + ar[None, :]
    nv = values.numel()
    mask = ar[None, :] < lengths[:, None]
    if not nv:
        return torch.zeros((rows, max_len), dtype=values.dtype, device=dev)
    vals = values[idx.clamp(0, nv - 1).to(torch.int64)]
    return torch.where(mask, vals, torch.zeros((), dtype=values.dtype, device=dev))


# Rows one block of the CUDA kernel pads at most, and the output bytes a
# tile of wide rows aims at (it then takes fewer rows, a multiple of 16):
# kTileRows and kTileBytes of kernels/csrc/pad_ragged.cu, pinned by a test.
PAD_RAGGED_TILE = 512
PAD_RAGGED_TILE_BYTES = 32768


def pad_ragged(values: torch.Tensor, lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Pad a flat element vector into [rows, max_len] by per-row lengths
    (int32 or int64): row r takes values[offs[r] : offs[r] + lengths[r]]
    (offs the int32 exclusive scan of lengths), gather indices clip into
    [0, nv - 1], and slots past a
    row's length are 0 (the bit pattern 0; all zeros when nv == 0). Values
    keep their dtype (1-, 4- or 8-byte elements). Replaces the jitted
    `pad` of parquet_tpu/core/reader.py:_pad_ragged_device."""
    _check_values(values, "pad_ragged: values")
    _check_vec(lengths, (torch.int32, torch.int64), "pad_ragged: lengths")
    max_len = int(max_len)
    if max_len < 0:
        raise ValueError(f"pad_ragged: max_len {max_len} is negative")
    rows, nv = lengths.numel(), values.numel()
    _check_len(max(rows, nv), "pad_ragged")
    if _on_cpu(values, lengths):
        return pad_ragged_plain(values, lengths, max_len)
    dev = values.device
    out = torch.empty((rows, max_len), dtype=values.dtype, device=dev)
    if not rows * max_len:
        return out
    lib = _lib()
    elem = values.element_size()
    # the tiles' length sums; no scratch of `rows` elements
    scratch = torch.empty(lib.pqt_pad_ragged_scratch_words(rows, max_len, elem),
                          dtype=torch.int64, device=dev)
    _launch(
        "pad_ragged", dev, lib.pqt_pad_ragged,
        _ptr(values), nv, elem, _ptr(lengths), lengths.element_size(), rows, max_len,
        _ptr(out), _ptr(scratch),
    )
    _count(pad_ragged)
    return out


pad_ragged.launches = 0


def expand_nullable_plain(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the null expansion, as the reference's `expand`
    writes it: idx = inclusive count of the mask - 1 clipped into
    [0, nv - 1], then where(mask, values[idx], 0) (zeros when nv == 0)."""
    dev = values.device
    nv = values.numel()
    if not nv:
        return torch.zeros(mask.shape, dtype=values.dtype, device=dev)
    idx = (torch.cumsum(mask, 0, dtype=torch.int64) - 1).clamp(0, nv - 1)
    return torch.where(mask, values[idx], torch.zeros((), dtype=values.dtype, device=dev))


# Rows a tile of the null expansion's two launches (tile counts, then a
# placement) and tiles a group of its counts (kThreads * kItems and kGroup
# of kernels/csrc/expand_nullable.cu, pinned by a test).
EXPAND_NULLABLE_TILE = 4096
EXPAND_NULLABLE_GROUP = 256


def _tile_counts(n: int, tile: int, group: int, device) -> torch.Tensor:
    """Scratch of a two-launch validity scan (kernels/csrc/validity.cuh)
    over n rows: each tile's count of valid rows, then each group's."""
    tiles = -(-n // tile)
    return torch.empty(tiles + -(-tiles // group), dtype=torch.int32, device=device)


def expand_nullable(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scatter the dense non-null values into row positions, nulls 0 (the
    bit pattern 0): out[i] = values[clip(count(mask[:i + 1]) - 1, 0, nv - 1)]
    where mask[i], else 0; all zeros when nv == 0. Values keep their dtype
    (1-, 4- or 8-byte elements). Replaces the jitted `expand` of
    parquet_tpu/core/reader.py:_expand_nullable_device."""
    _check_values(values, "expand_nullable: values")
    _check_vec(mask, (torch.bool,), "expand_nullable: mask")
    n, nv = mask.numel(), values.numel()
    _check_len(max(n, nv), "expand_nullable")
    if _on_cpu(values, mask):
        return expand_nullable_plain(values, mask)
    dev = values.device
    out = torch.empty(n, dtype=values.dtype, device=dev)
    if not n:
        return out
    scratch = _tile_counts(n, EXPAND_NULLABLE_TILE, EXPAND_NULLABLE_GROUP, dev)
    _launch(
        "expand_nullable", dev, _lib().pqt_expand_nullable,
        _ptr(values), nv, values.element_size(), _ptr(mask), n, _ptr(out), _ptr(scratch),
    )
    _count(expand_nullable)
    return out


expand_nullable.launches = 0


# -- the filter path: predicate masks, LIST contains, verdicts, compaction -----
#
# Four kernels of the device filter (core/filter_device.py and the reader's
# filter_rows= compaction). Masks are torch.bool tensors; counts are 0-d
# int64 tensors, the JAX programs' dtype under x64.

_PRED_OPS = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5, "in": 6, "not_in": 7}
# the kernel's value dtype codes (predicate_mask.cu)
_PRED_DTYPES = {
    torch.bool: 0, torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3,
    torch.float32: 6, torch.float64: 7,
}
# the most in-list members one launch compares against (kMaxMembers of
# predicate_mask.cu; core/filter_device.py sends longer lists to the host)
MAX_MEMBERS = 64


def predicate_block(itemsize: int) -> int:
    """Elements one block of predicate_mask.cu takes from 16-byte-aligned
    values of `itemsize` bytes (kThreads * max(kStepBytes / itemsize,
    kMinPer), pinned by a test): the kernel's edge sizes sit around it."""
    return 256 * max(16 // itemsize, 4)

_I64_MIN = -(1 << 63)


def _pred_view(values: torch.Tensor) -> torch.Tensor:
    """Booleans compare as int8, as the reference compares them."""
    return values.view(torch.int8) if values.dtype == torch.bool else values


def _pred_domain(values: torch.Tensor, unsigned: bool, bits):
    """(the integer range a bracket must lie in, or None for floats; the
    unsigned sub-width mask)."""
    if values.dtype.is_floating_point:
        return None, None
    width = 8 * _pred_view(values).element_size()
    if unsigned:
        nbits = width if bits is None else min(int(bits), width)
        return (0, (1 << width) - 1), (1 << nbits) - 1
    return (-(1 << (width - 1)), (1 << (width - 1)) - 1), None


def _coerce_bracket(values, x, domain, name):
    """A bracket end in the column's dtype: an int within the integer range,
    or a float rounded to float32 for a float32 column."""
    if domain is None:
        x = float(x)
        return float(np.float32(x)) if values.dtype == torch.float32 else x
    if isinstance(x, (bool, np.bool_)):
        x = int(x)
    if not isinstance(x, (int, np.integer)):
        raise TypeError(f"{name}: integer column compared with {type(x).__name__}")
    x = int(x)
    if not domain[0] <= x <= domain[1]:
        raise ValueError(f"{name}: bracket {x} outside the column's range {domain}")
    return x


def _check_members(members) -> None:
    if len(members) > MAX_MEMBERS:
        raise ValueError(f"predicate_mask: {len(members)} members > {MAX_MEMBERS}")


def _fixed_patterns(values: torch.Tensor, op: str, lo, members) -> list[bytes]:
    """The byte patterns an FLBA compare tests rows against: `lo` for == and
    !=, the members for in / not_in; a pattern of another width than the
    rows' can equal no row and is dropped."""
    pats = [bytes(lo)] if op in ("==", "!=") else [bytes(m) for m in members]
    _check_members(pats)
    return [p for p in pats if len(p) == values.shape[1]]


def predicate_mask_plain(
    values: torch.Tensor, op: str, lo=None, hi=None, exact: bool = True, *,
    members=(), unsigned: bool = False, bits: int | None = None,
) -> torch.Tensor:
    """Plain version of the predicate mask, as the reference writes it: the
    bracket rule for the six comparisons, an OR of equalities for in /
    not_in, unsigned bit patterns compared as unsigned (int64 lanes for
    32-bit patterns, the sign bit flipped for 64-bit ones) and FLBA rows
    ((n, w) uint8) compared with the byte pattern `lo` or the members'."""
    if values.dim() == 2:
        hit = torch.zeros(values.shape[0], dtype=torch.bool, device=values.device)
        for p in _fixed_patterns(values, op, lo, members):
            pat = torch.tensor(list(p), dtype=torch.uint8, device=values.device)
            hit |= (values == pat).all(dim=1)
        return hit if op in ("==", "in") else ~hit
    domain, umask = _pred_domain(values, unsigned, bits)
    x = _pred_view(values)

    def key(v):
        if domain is None:
            # a float bracket is exact in the column's dtype already, so the
            # scalar compares in that dtype, as the reference's does
            return v
        if unsigned and values.dtype == torch.int64:
            k = v ^ (1 << 63)  # the sign flip that orders unsigned as signed
            return k - (1 << 64) if k >= (1 << 63) else k
        return v

    if unsigned:
        if x.dtype == torch.int32:
            x = x.to(torch.int64) & _M32
        if umask is not None and umask < (1 << 63):
            x = x & umask
        if x.dtype == torch.int64 and values.dtype == torch.int64:
            x = x ^ _I64_MIN
    if op in ("in", "not_in"):
        hit = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        for m in members:
            hit |= x == key(m)
        return hit if op == "in" else ~hit
    lo_k, hi_k = key(lo), key(hi)
    if op == "==":
        return (x == lo_k) if exact else torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if op == "!=":
        return (x != lo_k) if exact else torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if op == "<":
        return (x < lo_k) if exact else (x <= lo_k)
    if op == "<=":
        return x <= lo_k
    if op == ">":
        return (x > hi_k) if exact else (x >= hi_k)
    return x >= hi_k


def predicate_mask(
    values: torch.Tensor, op: str, lo=None, hi=None, exact: bool = True, *,
    members=(), unsigned: bool = False, bits: int | None = None,
) -> torch.Tensor:
    """bool[n] mask of one leaf predicate over a column's dense values.

    `op` is one of ==, !=, <, <=, >, >= against the bracket (lo, hi, exact)
    of the reference (an inexact bracket: == all false, != all true, the
    ordered ops on the end that stays exact), or in / not_in against up to
    64 `members`. Values are bool (compared as int8), int8/16/32/64 or
    float32/64; with `unsigned=True` int32/int64 values are bit patterns
    compared as unsigned, masked to `bits` low bits when given. A bracket
    end is coerced to the column's dtype here (float32 rounding; an integer
    outside the dtype's range raises ValueError, a non-integer TypeError).
    2-D uint8 values are FIXED_LEN_BYTE_ARRAY rows, compared with the
    pattern `lo` (bytes) by == and !=, or with the member patterns by in /
    not_in, in one launch either way. Replaces
    parquet_tpu/kernels/device_ops.py:predicate_mask_device with the
    unsigned view, member OR and FLBA compare of
    parquet_tpu/core/filter_device.py folded in."""
    if op not in _PRED_OPS:
        raise ValueError(f"predicate_mask: unsupported op {op!r}")
    if not isinstance(values, torch.Tensor):
        raise TypeError(f"predicate_mask: expected a torch.Tensor, got {type(values).__name__}")
    if not values.is_contiguous():
        raise ValueError("predicate_mask: values must be contiguous")
    _check_len(values.shape[0] if values.dim() else 0, "predicate_mask")
    if values.dim() == 2:
        if values.dtype != torch.uint8 or op not in ("==", "!=", "in", "not_in"):
            raise ValueError(
                "predicate_mask: fixed-width rows are uint8 [n, w] compared with ==, !=, "
                "in or not_in"
            )
        pats = _fixed_patterns(values, op, lo, members)
        if _on_cpu(values):
            return predicate_mask_plain(values, op, lo, members=members)
        n, w = values.shape
        out = torch.empty(n, dtype=torch.bool, device=values.device)
        if n:
            table = (
                torch.frombuffer(bytearray(b"".join(pats)), dtype=torch.uint8).to(values.device)
                if pats and w else None
            )
            _launch(
                "predicate_mask", values.device, _lib().pqt_fixed_members,
                _ptr(values), n, w, None if table is None else _ptr(table), len(pats),
                int(op in ("!=", "not_in")), _ptr(out),
            )
            _count(predicate_mask)
        return out
    _check_vec(values, tuple(_PRED_DTYPES), "predicate_mask: values")
    if unsigned and values.dtype not in (torch.int32, torch.int64):
        raise ValueError("predicate_mask: unsigned compares int32/int64 bit patterns only")
    domain, umask = _pred_domain(values, unsigned, bits)
    if op in ("in", "not_in"):
        _check_members(members)
        members = [_coerce_bracket(values, m, domain, "predicate_mask") for m in members]
        lo = hi = None
    else:
        lo = _coerce_bracket(values, lo, domain, "predicate_mask")
        hi = _coerce_bracket(values, hi, domain, "predicate_mask")
    if _on_cpu(values):
        return predicate_mask_plain(
            values, op, lo, hi, exact, members=members, unsigned=unsigned, bits=bits
        )
    n = values.numel()
    out = torch.empty(n, dtype=torch.bool, device=values.device)
    if not n:
        return out
    code = _PRED_DTYPES[values.dtype] + (2 if unsigned else 0)
    floats = domain is None

    def bits64(v):  # an integer as the int64 bit pattern the kernel reads
        return v - (1 << 64) if v >= (1 << 63) else v

    mem = list(members) + [0] * (1 if not members else 0)
    mem_i = np.array([0 if floats else bits64(m) for m in mem], dtype=np.int64)
    mem_f = np.array([m if floats else 0.0 for m in mem], dtype=np.float64)
    lo_i = 0 if floats or lo is None else bits64(lo)
    hi_i = 0 if floats or hi is None else bits64(hi)
    lo_f = lo if floats and lo is not None else 0.0
    hi_f = hi if floats and hi is not None else 0.0
    _launch(
        "predicate_mask", values.device, _lib().pqt_predicate_mask,
        _ptr(_pred_view(values)), n, code, _PRED_OPS[op], lo_i, hi_i, lo_f, hi_f,
        int(bool(exact)), (1 << 64) - 1 if umask is None else umask,
        mem_i.ctypes.data, mem_f.ctypes.data, len(members), _ptr(out),
    )
    _count(predicate_mask)
    return out


predicate_mask.launches = 0


def _wrap_clamp(indices: torch.Tensor, n: int) -> torch.Tensor:
    """jnp's index rule: a negative index wraps once, then clamps into
    [0, n - 1] (int64)."""
    idx = indices.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def leaf_verdict_plain(
    verdict: torch.Tensor, indices: torch.Tensor | None = None,
    valid: torch.Tensor | None = None, fill: bool = False,
) -> torch.Tensor:
    """Plain version of the leaf verdict, as the reference writes it: the
    verdict gathered through the indices (jnp's index rule), then, with a
    validity, didx = clip(cumsum(valid) - 1, 0, nd - 1) and
    where(valid, dense[didx], fill) (all `fill` when nd == 0)."""
    v = verdict.to(torch.bool)
    dense = v if indices is None else v[_wrap_clamp(indices, v.numel())]
    if valid is None:
        return dense
    nd = dense.numel()
    if not nd:
        return torch.full(valid.shape, bool(fill), dtype=torch.bool, device=valid.device)
    didx = (torch.cumsum(valid, 0, dtype=torch.int64) - 1).clamp(0, nd - 1)
    return torch.where(valid, dense[didx], bool(fill))


# Rows a tile of the leaf-verdict kernel's validity path holds, and tiles a
# group of its counts (kThreads * kItems and kGroup of
# kernels/csrc/leaf_verdict.cu, pinned by a test).
LEAF_VERDICT_TILE = 4096
LEAF_VERDICT_GROUP = 256


def leaf_verdict(
    verdict: torch.Tensor, indices: torch.Tensor | None = None,
    valid: torch.Tensor | None = None, fill: bool = False,
) -> torch.Tensor:
    """A leaf's bool row mask from a verdict over its dense values, in one
    pass: the verdict (bool or uint8) per dense value, or per dictionary
    entry gathered through int32 `indices` (a negative index wraps once,
    then indices clamp into range); with a row validity (bool), null rows
    get `fill` (False; True for arrow's not_in) and the valid rows read
    the dense verdict in order. Replaces the verdict gather, validity scan
    and expansion of parquet_tpu/core/filter_device.py (:153-182, :252,
    :271)."""
    _check_vec(verdict, (torch.bool, torch.uint8), "leaf_verdict: verdict")
    tensors = [verdict]
    nd = verdict.numel()
    if indices is not None:
        _check_vec(indices, (torch.int32,), "leaf_verdict: indices")
        nd = indices.numel()
        if nd and not verdict.numel():
            raise ValueError("leaf_verdict: empty verdict with indices to gather")
        tensors.append(indices)
    n = nd
    if valid is not None:
        _check_vec(valid, (torch.bool,), "leaf_verdict: valid")
        n = valid.numel()
        tensors.append(valid)
    _check_len(max(n, nd, verdict.numel()), "leaf_verdict")
    if _on_cpu(*tensors):
        return leaf_verdict_plain(verdict, indices, valid, fill)
    dev = verdict.device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if not n:
        return out
    scratch = None
    if valid is not None:
        # each tile's count of valid rows, then each group's; no scratch of
        # n rows
        scratch = _tile_counts(n, LEAF_VERDICT_TILE, LEAF_VERDICT_GROUP, dev)
    _launch(
        "leaf_verdict", dev, _lib().pqt_leaf_verdict,
        _ptr(verdict), verdict.numel(), None if indices is None else _ptr(indices), nd,
        None if valid is None else _ptr(valid), n, int(bool(fill)), _ptr(out),
        None if scratch is None else _ptr(scratch),
    )
    _count(leaf_verdict, 1, "launches_by_kind", "gather" if valid is None else "validity")
    return out


leaf_verdict.launches = 0
# launches without a validity (the gather) and with one (the validity scan)
leaf_verdict.launches_by_kind = {}


def list_contains_mask_plain(
    rep: torch.Tensor, dfl: torch.Tensor, dense_match: torch.Tensor, elem_def: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the LIST contains mask, as the reference writes it:
    a clipped gather of the dense mask, then a scatter-max of the entry
    matches into rows clip(row_of, 0, n - 1)."""
    dev = rep.device
    n = rep.numel()
    valid = dfl.to(torch.int64) == int(elem_def)
    nv = dense_match.numel()
    if nv:
        didx = (torch.cumsum(valid, 0, dtype=torch.int64) - 1).clamp(0, nv - 1)
        entry_match = valid & dense_match[didx]
    else:
        entry_match = torch.zeros(n, dtype=torch.bool, device=dev)
    starts = rep == 0
    row_of = (torch.cumsum(starts, 0, dtype=torch.int64) - 1).clamp(0, max(n - 1, 0))
    rows = torch.zeros(n, dtype=torch.int32, device=dev).scatter_reduce_(
        0, row_of, entry_match.to(torch.int32), "amax"
    )
    return rows.to(torch.bool), starts.sum(dtype=torch.int64)


# Entries a tile of the LIST-contains kernel scans (kThreads * kItems of
# kernels/csrc/list_contains_mask.cu, pinned by a test).
LIST_CONTAINS_TILE = 4096


def list_contains_mask(
    rep: torch.Tensor, dfl: torch.Tensor, dense_match: torch.Tensor, elem_def: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """('tags', 'contains', x) at the list-slot level: (rows bool[n], n_rows
    a 0-d int64 tensor). Entry i is a present element iff dfl[i] ==
    elem_def; the k-th present element takes dense_match[clip(k, 0, nv - 1)],
    and a matching entry sets rows[clip(row_of, 0, n - 1)], row_of being the
    count of record starts (rep == 0) up to it, minus 1. Entries past
    n_rows are padding. Replaces
    parquet_tpu/kernels/device_ops.py:list_contains_mask_device."""
    _check_vec(rep, (torch.int32,), "list_contains_mask: rep")
    _check_vec(dfl, (torch.int32,), "list_contains_mask: dfl")
    _check_vec(dense_match, (torch.bool,), "list_contains_mask: dense_match")
    n = rep.numel()
    if dfl.numel() != n:
        raise ValueError(f"list_contains_mask: {n} rep levels but {dfl.numel()} def levels")
    _check_len(max(n, dense_match.numel()), "list_contains_mask")
    elem_def = int(elem_def)
    if _on_cpu(rep, dfl, dense_match):
        return list_contains_mask_plain(rep, dfl, dense_match, elem_def)
    dev = rep.device
    rows = torch.empty(n, dtype=torch.bool, device=dev)
    if not n:
        return rows, torch.zeros((), dtype=torch.int64, device=dev)
    n_rows = torch.empty((), dtype=torch.int64, device=dev)
    descriptors = _descriptors(n, LIST_CONTAINS_TILE, dev)
    _launch(
        "list_contains_mask", dev, _lib().pqt_list_contains_mask,
        _ptr(rep), _ptr(dfl), n, _ptr(dense_match), dense_match.numel(), elem_def,
        _ptr(rows), _ptr(n_rows), _ptr(descriptors),
    )
    _count(list_contains_mask)
    return rows, n_rows


list_contains_mask.launches = 0


def mask_take_scan_plain(mask: torch.Tensor, out_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the mask scan, as the reference writes it: a
    scatter-max of arange(n) into src[clip(where(mask, pos, out_pad), 0,
    out_pad)] over zeros(out_pad + 1), cut to out_pad."""
    n = mask.numel()
    pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    tgt = torch.where(mask, pos, out_pad).clamp(0, out_pad)
    src = torch.zeros(out_pad + 1, dtype=torch.int32, device=mask.device)
    src.scatter_reduce_(
        0, tgt, torch.arange(n, dtype=torch.int32, device=mask.device), "amax"
    )
    return src[:out_pad], mask.sum(dtype=torch.int64)


def mask_take_rows_plain(
    rows: torch.Tensor, src: torch.Tensor, count: torch.Tensor, out_rows: int
) -> torch.Tensor:
    """Plain version of the row gather: rows[src[j]] for j < min(count,
    out_rows), rows[0] past it; zeros when there are no rows."""
    dev = rows.device
    if not rows.shape[0]:
        return torch.zeros((out_rows,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=dev)
    j = torch.arange(out_rows, device=dev)
    sel = torch.where(j < count, src[:out_rows].to(torch.int64), 0)
    return rows[sel]


def mask_take_plain(values: torch.Tensor, mask: torch.Tensor, out_pad: int):
    """Plain version of mask_take: (taken[out_pad], count)."""
    src, count = mask_take_scan_plain(mask, out_pad)
    return mask_take_rows_plain(values, src, count, out_pad), count


# mask_take.cu's tile (mask entries a block scans at once) and its grid's cap
# (the chunks' counts it keeps as scratch); tests pin both to the source.
MASK_TAKE_TILE = 4096
MASK_TAKE_BLOCKS = 1024


def _mask_arg(mask: torch.Tensor, out_pad: int) -> tuple[int, int]:
    """(n, out_pad) of a compaction, checked."""
    _check_vec(mask, (torch.bool,), "mask_take: mask")
    out_pad = int(out_pad)
    if out_pad < 0:
        raise ValueError(f"mask_take: out_pad {out_pad} is negative")
    n = mask.numel()
    _check_len(max(n, out_pad), "mask_take")
    return n, out_pad


def _check_rows(rows: torch.Tensor, name: str) -> None:
    """Rows of a compaction: a contiguous tensor of at least one dimension,
    rows along the first."""
    if not isinstance(rows, torch.Tensor) or rows.dim() < 1:
        raise ValueError(f"mask_take: {name} must be a tensor of at least one dimension")
    if not rows.is_contiguous():
        raise ValueError(f"mask_take: {name} must be contiguous")


def _word(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest copy word (16, 8, 4, 2 or 1 bytes) dividing the row width
    and every tensor's address."""
    word = 16
    while word > 1 and (row_bytes % word or any(t.data_ptr() % word for t in tensors)):
        word //= 2
    return word


def mask_take_scan(mask: torch.Tensor, out_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The first half of mask_take: (src int32[out_pad], count a 0-d int64
    tensor), src[p] the index of the p-th kept entry for p < min(count,
    out_pad) and 0 past it. One scan per row group serves every leaf's
    mask_take_rows."""
    n, out_pad = _mask_arg(mask, out_pad)
    if _on_cpu(mask):
        return mask_take_scan_plain(mask, out_pad)
    dev = mask.device
    src = torch.empty(out_pad, dtype=torch.int32, device=dev)
    if not n:
        src.zero_()
        return src, torch.zeros((), dtype=torch.int64, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    scratch = torch.empty(MASK_TAKE_BLOCKS, dtype=torch.int32, device=dev)
    _launch(
        "mask_take", dev, _lib().pqt_mask_scan,
        _ptr(mask), n, out_pad, _ptr(src), _ptr(count), _ptr(scratch),
    )
    _count(mask_take)
    return src, count


def mask_take_rows(
    rows: torch.Tensor, src: torch.Tensor, count: torch.Tensor, out_rows: int
) -> torch.Tensor:
    """The second half of mask_take: out[j] = rows[src[j]] for j <
    min(count, out_rows) and rows[0] past it (zeros when rows is empty),
    over the leading dimension of a contiguous tensor of any dtype and
    trailing shape. `count` stays on the device: nothing waits for it."""
    _check_rows(rows, "rows")
    _check_vec(src, (torch.int32,), "mask_take: src")
    out_rows = int(out_rows)
    if not 0 <= out_rows <= src.numel():
        raise ValueError(f"mask_take: {out_rows} output rows from {src.numel()} positions")
    _check_len(max(rows.shape[0], out_rows), "mask_take")
    if _on_cpu(rows, src, count):
        return mask_take_rows_plain(rows, src, count, out_rows)
    dev = rows.device
    out = torch.empty((out_rows,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=dev)
    row_bytes = rows.element_size() * math.prod(rows.shape[1:])
    if not out.numel():
        return out
    _launch(
        "mask_take", dev, _lib().pqt_take_rows,
        _ptr(rows), rows.shape[0], row_bytes, _word(row_bytes, rows, out), _ptr(src),
        _ptr(count), out_rows, _ptr(out),
    )
    _count(mask_take)
    return out


def mask_take(values: torch.Tensor, mask: torch.Tensor, out_pad: int):
    """Compact values[mask] into out_pad rows: (taken, count a 0-d int64
    tensor). A count above out_pad keeps the first out_pad kept rows and
    returns the full count; positions past the count hold values[0]; no
    values give zeros. One scan that places the values itself
    (mask_take_scan + mask_take_rows is the route for several leaves under
    one mask). Replaces parquet_tpu/kernels/device_ops.py:mask_take_device."""
    n, out_pad = _mask_arg(mask, out_pad)
    _check_rows(values, "values")
    if values.shape[0] != n:
        raise ValueError(f"mask_take: {values.shape[0]} values under a mask of {n}")
    if _on_cpu(values, mask):
        return mask_take_plain(values, mask, out_pad)
    dev = values.device
    out = torch.empty((out_pad,) + tuple(values.shape[1:]), dtype=values.dtype, device=dev)
    if not n:
        return out.zero_(), torch.zeros((), dtype=torch.int64, device=dev)
    if not out.numel():
        return out, mask_take_scan(mask, 0)[1]
    row_bytes = values.element_size() * math.prod(values.shape[1:])
    count = torch.empty((), dtype=torch.int64, device=dev)
    scratch = torch.empty(MASK_TAKE_BLOCKS, dtype=torch.int32, device=dev)
    _launch(
        "mask_take", dev, _lib().pqt_mask_take,
        _ptr(mask), n, out_pad, _ptr(values), row_bytes, _word(row_bytes, values, out),
        _ptr(out), _ptr(count), _ptr(scratch),
    )
    _count(mask_take)
    return out, count


mask_take.launches = 0


# -- the write path: bit-pack, hybrid run plan, dictionary probe, DELTA blocks,
#    byte-array framing ---------------------------------------------------------


def bitpack_encode_plain(values: torch.Tensor, width: int) -> torch.Tensor:
    """Plain version of the LSB-first bit-pack: value i at bits [i*width,
    (i+1)*width) of little-endian uint32 words, ceil(n*width/32) + 1 words
    (the last a zero guard word); one zero word for width 0 or no values.
    Values are masked to `width` bits; each splits into a lo/hi word
    contribution and a scatter-add joins them (disjoint bits: add is or)."""
    dev = values.device
    n = values.numel()
    if width == 0 or n == 0:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    n_words = (n * width + 31) // 32 + 1
    v = _u32(values) & ((1 << width) - 1)
    bitpos = torch.arange(n, dtype=torch.int64, device=dev) * width
    w0 = bitpos >> 5
    shifted = v << (bitpos & 31)  # < 2^63: no sign overflow
    words = torch.zeros(n_words, dtype=torch.int64, device=dev)
    words.index_add_(0, w0, shifted & _M32)
    words.index_add_(0, (w0 + 1).clamp(max=n_words - 1), shifted >> 32)
    return _to_signed32(words)


# Values a block of the bit-pack takes (kTile of
# kernels/csrc/bitpack_encode.cu, pinned by a test): 32 * width whole words.
BITPACK_TILE = 1024


def bitpack_encode(values: torch.Tensor, width: int) -> torch.Tensor:
    """Bit-pack uint32 values (int32 bit patterns) at `width` bits into
    int32[ceil(n*width/32) + 1] words, LSB first. Replaces
    parquet_tpu/kernels/device_ops.py:bitpack_encode_device; the caller pads
    to whole groups of 8 where the hybrid format needs them. The write
    path's pack runs inside rle_hybrid_encode's kernel, not here."""
    _check_vec(values, (torch.int32,), "bitpack_encode: values")
    width = int(width)
    if not 0 <= width <= 32:
        raise ValueError(f"bitpack_encode: width {width} outside 0..32")
    n = values.numel()
    _check_len(n, "bitpack_encode")
    if _on_cpu(values):
        return bitpack_encode_plain(values, width)
    dev = values.device
    if width == 0 or n == 0:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty((n * width + 31) // 32 + 1, dtype=torch.int32, device=dev)
    _launch(
        "bitpack_encode", dev, _lib().pqt_bitpack_encode,
        _ptr(values), n, width, _ptr(out), out.numel(),
    )
    _count(bitpack_encode)
    return out


bitpack_encode.launches = 0


def rle_hybrid_encode_plain(values: torch.Tensor, width: int):
    """Plain version of the hybrid encode's run plan and payload, as the
    reference writes it (run extents, 8-aligned RLE windows of >= 8 equal
    values, compaction of the rest, one pack)."""
    dev = values.device
    n = values.numel()
    if n == 0:
        return (
            torch.zeros(0, dtype=torch.bool, device=dev),
            torch.zeros(0, dtype=torch.bool, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
        )
    # run extents by cummax/cummin, the bit-packed values compacted by a
    # scatter into a trash slot: no host sync
    i = torch.arange(n, dtype=torch.int64, device=dev)
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    boundary[1:] = values[1:] != values[:-1]
    is_end = torch.ones(n, dtype=torch.bool, device=dev)
    is_end[:-1] = boundary[1:]
    run_start = torch.cummax(torch.where(boundary, i, 0), 0).values
    run_end = torch.cummin(torch.where(is_end, i + 1, n).flip(0), 0).values.flip(0)
    rle_s = (run_start + 7) & ~7
    rle_e = run_end & ~7
    qualifies = (run_end - run_start >= 8) & (rle_e - rle_s >= 8)
    in_rle = qualifies & (i >= rle_s) & (i < rle_e)
    rle_break = in_rle & (i == rle_s)
    keep = ~in_rle
    pos = torch.cumsum(keep, 0, dtype=torch.int64) - 1
    bp = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    bp.scatter_(0, torch.where(keep, pos, n), values)
    return in_rle, rle_break, bitpack_encode_plain(bp[:n], width), keep.sum(dtype=torch.int32)


# Values a tile of the run-plan kernel takes, and tiles a group of it
# (kThreads * kItems and kGroup of kernels/csrc/rle_hybrid_encode.cu, pinned
# by a test).
RLE_PLAN_TILE = 1024
RLE_PLAN_GROUP = 256


def rle_hybrid_encode(values: torch.Tensor, width: int):
    """The device half of the RLE/bit-pack hybrid encode of uint32 values
    (int32 bit patterns) < 2**width: (in_rle bool[n], rle_break bool[n],
    packed int32 words, n_bp a 0-d int32 tensor). An 8-aligned window of >= 8
    equal values is an RLE run (in_rle), starting where rle_break is set;
    every other value, in order, is bit-packed into `packed` (zero-padded,
    bitpack_encode's layout over n values); n_bp counts them.
    kernels/pipeline.assemble_hybrid_device_stream frames the result into
    ops/rle_hybrid.encode_hybrid's bytes. Replaces
    parquet_tpu/kernels/device_ops.py:rle_hybrid_encode_device; its pack
    runs inside the kernel's placement (no bitpack_encode launch)."""
    _check_vec(values, (torch.int32,), "rle_hybrid_encode: values")
    width = int(width)
    if not 0 <= width <= 32:
        raise ValueError(f"rle_hybrid_encode: width {width} outside 0..32")
    n = values.numel()
    _check_len(n, "rle_hybrid_encode")
    if _on_cpu(values):
        return rle_hybrid_encode_plain(values, width)
    dev = values.device
    in_rle = torch.empty(n, dtype=torch.bool, device=dev)
    rle_break = torch.empty(n, dtype=torch.bool, device=dev)
    if not n:
        return (in_rle, rle_break, torch.zeros(1, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    n_bp = torch.empty((), dtype=torch.int32, device=dev)  # the kernel writes it
    packed = torch.empty((n * width + 31) // 32 + 1, dtype=torch.int32, device=dev)
    # one record a tile (first and last run boundary, kept values), then one
    # a group of tiles; no scratch of n elements
    ntiles = -(-n // RLE_PLAN_TILE)
    tiles = torch.empty((ntiles + -(-ntiles // RLE_PLAN_GROUP), 4), dtype=torch.int32,
                        device=dev)
    _launch(
        "rle_hybrid_encode", dev, _lib().pqt_rle_hybrid_encode,
        _ptr(values), n, width, _ptr(in_rle), _ptr(rle_break), _ptr(packed), packed.numel(),
        _ptr(n_bp), _ptr(tiles),
    )
    _count(rle_hybrid_encode)
    return in_rle, rle_break, packed, n_bp


rle_hybrid_encode.launches = 0


def dict_indices_plain(bits: torch.Tensor):
    """Plain version of the first-occurrence dictionary probe, by sorting:
    torch.unique groups the keys, a scatter-min finds each group's first
    row, and the groups rank by it."""
    dev = bits.device
    n = bits.numel()
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return empty, empty.clone(), torch.zeros((), dtype=torch.int32, device=dev)
    _uniq, inv = torch.unique(bits, return_inverse=True)
    nu = _uniq.numel()
    first = torch.full((nu,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, inv, torch.arange(n, dtype=torch.int64, device=dev), "amin")
    order = torch.argsort(first)
    rank = torch.empty(nu, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(nu, dtype=torch.int64, device=dev)
    firsts = torch.full((n,), n, dtype=torch.int32, device=dev)
    firsts[:nu] = first[order].to(torch.int32)
    return rank[inv].to(torch.int32), firsts, torch.tensor(nu, dtype=torch.int32, device=dev)


# Rows one block of the CUDA kernel dedupes and ranks (kTile of
# kernels/csrc/dict_indices.cu, pinned by a test).
DICT_INDICES_TILE = 1024


def dict_indices(bits: torch.Tensor):
    """First-occurrence dictionary of a column's bit patterns (int32 or
    int64; floats as their patterns, so NaN payloads stay distinct):
    (indices int32[n], firsts int32[n], n_uniques a 0-d int32 tensor).
    Dictionary entry k is bits[firsts[k]], the k-th distinct value in row
    order; indices[i] is row i's entry; firsts holds n past n_uniques.
    Replaces parquet_tpu/kernels/device_ops.py:dict_indices_device (sort
    based); the kernel hashes instead, with the same outputs."""
    _check_vec(bits, (torch.int32, torch.int64), "dict_indices: bits")
    n = bits.numel()
    _check_len(2 * n, "dict_indices")
    if _on_cpu(bits):
        return dict_indices_plain(bits)
    dev = bits.device
    indices = torch.empty(n, dtype=torch.int32, device=dev)
    firsts = torch.empty(n, dtype=torch.int32, device=dev)
    nu = torch.zeros((), dtype=torch.int32, device=dev)
    if not n:
        return indices, firsts, nu
    lib = _lib()
    # the tile descriptors, the hash table and the rows' slots
    scratch = torch.empty(lib.pqt_dict_indices_scratch_words(n), dtype=torch.int64, device=dev)
    _launch(
        "dict_indices", dev, lib.pqt_dict_indices,
        _ptr(bits), n, bits.element_size(), _ptr(scratch), _ptr(indices), _ptr(firsts), _ptr(nu),
    )
    _count(dict_indices, 1, "launches_by_width", 8 * bits.element_size())
    return indices, firsts, nu


dict_indices.launches = 0
# the same launches by key width in bits, 32 or 64 (the shapes of the tuning
# queue)
dict_indices.launches_by_width = {}


def _bit_length(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Bit length of unsigned values held in int64 lanes (uint64 patterns)."""
    out = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for b in range(nbits):
        out += (_lshr64(x, torch.full_like(x, b)) != 0).to(torch.int32)
    return out


def delta_block_encode_plain(values: torch.Tensor):
    """Plain version of the DELTA_BINARY_PACKED block tables and payload of
    one page, as the reference writes them: wrapping deltas, per-128-block
    signed minimum, per-32-miniblock bit widths, payloads at
    cumsum(4 * width) byte offsets placed by a scatter-add of word
    contributions. 64-bit lanes wrap as uint64 does."""
    dev = values.device
    n = values.numel()
    nbits = values.element_size() * 8
    nd = max(n - 1, 0)
    nb = (nd + 127) // 128
    nm = 4 * nb
    if nb == 0:
        return (
            torch.zeros(0, dtype=values.dtype, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
        )
    p = 128 * nb
    if nbits == 32:
        u = _u32(values)
        d = (u[1:] - u[:-1]) & _M32
        sd = torch.where(d >= (1 << 31), d - (1 << 32), d)
        big = (1 << 31) - 1
    else:
        d = values[1:] - values[:-1]  # two's complement: uint64 wrap
        sd = d
        big = (1 << 63) - 1
    sdp = torch.full((p,), big, dtype=torch.int64, device=dev)
    sdp[:nd] = sd
    mins = sdp.view(nb, 128).amin(1)
    dp = torch.zeros(p, dtype=torch.int64, device=dev)
    dp[:nd] = d
    valid = torch.arange(p, device=dev) < nd
    adj = torch.where(valid, dp - mins.repeat_interleave(128), 0)
    if nbits == 32:
        adj = adj & _M32
        amax = adj.view(nm, 32).amax(1)
    else:
        flip = -(1 << 63)  # unsigned max as a signed max of sign-flipped lanes
        amax = (adj ^ flip).view(nm, 32).amax(1) ^ flip
    widths = _bit_length(amax, nbits)
    pay = torch.zeros(nm + 1, dtype=torch.int64, device=dev)
    pay[1:] = torch.cumsum(4 * widths.to(torch.int64), 0)
    i = torch.arange(p, dtype=torch.int64, device=dev)
    m = i >> 5
    w = widths.to(torch.int64)[m]
    bitpos = pay[m] * 8 + (i & 31) * w
    n_words = nm * nbits
    words = torch.zeros(n_words + 3, dtype=torch.int64, device=dev)
    w0 = bitpos >> 5
    s = bitpos & 31
    lo = (adj & _M32) << s
    words.index_add_(0, w0, lo & _M32)
    words.index_add_(0, w0 + 1, lo >> 32)
    if nbits == 64:
        hi = _lshr64(adj, torch.full_like(adj, 32)) << s
        words.index_add_(0, w0 + 1, hi & _M32)
        words.index_add_(0, w0 + 2, hi >> 32)
    return mins.to(values.dtype), widths, _to_signed32(words[:n_words])


# Deltas a tile of the encode kernel covers (kG delta blocks of 128 in
# kernels/csrc/delta_block_encode.cu) and tiles a group of its payload sums
# (kGroup), both pinned by a test.
DELTA_ENCODE_TILE = 1024
DELTA_ENCODE_GROUP = 256


def delta_block_encode(values: torch.Tensor):
    """DELTA_BINARY_PACKED tables and payload of one page of int32/int64
    values (unsigned columns as their bit patterns), blocks of 128 deltas in
    4 miniblocks of 32: (mins, widths, words). For the page's n - 1 deltas
    in nb = ceil((n - 1) / 128) blocks: mins[nb] (the values' dtype) is each
    block's signed minimum delta; widths int32[4 * nb] each miniblock's bit
    width, 0 past the deltas; words int32[4 * nb * nbits] the payloads of
    all miniblocks, each 4 * width bytes, butted together in order: the
    first sum(widths) words. The kernel leaves the words after them
    unwritten (the plain version zeroes them), so a caller reads only that
    prefix. Replaces parquet_tpu/kernels/device_ops.py:
    delta_block_encode_device, whose tables run over a padded bucket (the
    blocks past the data carry INT_MAX there)."""
    _check_vec(values, (torch.int32, torch.int64), "delta_block_encode: values")
    n = values.numel()
    _check_len(8 * n, "delta_block_encode")
    if _on_cpu(values):
        return delta_block_encode_plain(values)
    dev = values.device
    nbits = values.element_size() * 8
    nb = (max(n - 1, 0) + 127) // 128
    mins = torch.empty(nb, dtype=values.dtype, device=dev)
    widths = torch.empty(4 * nb, dtype=torch.int32, device=dev)
    words = torch.empty(4 * nb * nbits, dtype=torch.int32, device=dev)
    if not nb:
        return mins, widths, words
    # each tile's payload words, then each group's
    tiles = -(-(n - 1) // DELTA_ENCODE_TILE)
    scratch = torch.empty(tiles + -(-tiles // DELTA_ENCODE_GROUP), dtype=torch.int32, device=dev)
    _launch(
        "delta_block_encode", dev, _lib().pqt_delta_block_encode,
        _ptr(values), n, nbits, _ptr(mins), _ptr(widths), _ptr(words), _ptr(scratch),
    )
    _count(delta_block_encode)
    return mins, widths, words


delta_block_encode.launches = 0


# plain_bytearray_encode.cu's tile: output bytes a block writes, one int32 of
# scratch a tile (a test pins it to the source).
FRAME_TILE = 4096


def plain_bytearray_encode_plain(
    data: torch.Tensor, offsets: torch.Tensor, out_len: int
) -> torch.Tensor:
    """Plain version of the PLAIN BYTE_ARRAY framing: value i's 4-byte LE
    length at 4*i + offsets[i] - offsets[0], its bytes after it; output
    positions at or past out_len are dropped."""
    dev = data.device
    n = offsets.numel() - 1
    off = offsets.to(torch.int64)
    out = torch.zeros(out_len + 1, dtype=torch.uint8, device=dev)
    if n <= 0:
        return out[:out_len]
    i = torch.arange(n, dtype=torch.int64, device=dev)
    lens = off[1:] - off[:-1]
    at = 4 * i + off[:-1] - off[0]
    for k in range(4):
        pos = at + k
        out.scatter_(0, torch.where(pos < out_len, pos, out_len),
                     ((lens >> (8 * k)) & 0xFF).to(torch.uint8))
    j = torch.arange(data.numel(), dtype=torch.int64, device=dev)
    v = torch.searchsorted(off[1:].contiguous(), j, right=True)
    inside = (j >= off[0]) & (j < off[n])
    pos = j - off[0] + 4 * (v + 1)
    out.scatter_(0, torch.where(inside & (pos < out_len), pos, out_len), data)
    return out[:out_len]


def plain_bytearray_encode(
    data: torch.Tensor, offsets: torch.Tensor, out_len: int
) -> torch.Tensor:
    """PLAIN framing of a byte-array column, `<4-byte LE length><bytes>` per
    value, from uint8 data and int64 offsets[n + 1] into uint8[out_len];
    out_len = 4*n + offsets[n] - offsets[0] holds the whole stream (the
    caller knows the offsets on the host: it splits pages by them). PLAIN
    streams concatenate, so page a..b is bytes [4a + off[a] - off[0],
    4b + off[b] - off[0]). Replaces
    parquet_tpu/kernels/device_ops.py:plain_bytearray_encode_device (which
    zero-pads to a bucket)."""
    _check_vec(data, (torch.uint8,), "plain_bytearray_encode: data")
    _check_vec(offsets, (torch.int64,), "plain_bytearray_encode: offsets")
    n = offsets.numel() - 1
    out_len = int(out_len)
    if n < 0 or out_len < 4 * n:
        raise ValueError(
            f"plain_bytearray_encode: {out_len} output bytes for {max(n, 0)} values"
        )
    _check_len(n, "plain_bytearray_encode")
    if _on_cpu(data, offsets):
        return plain_bytearray_encode_plain(data, offsets, out_len)
    dev = data.device
    out = torch.empty(out_len, dtype=torch.uint8, device=dev)
    if out_len:
        heads = torch.empty(-(-out_len // FRAME_TILE), dtype=torch.int32, device=dev)
        _launch(
            "plain_bytearray_encode", dev, _lib().pqt_plain_bytearray_encode,
            _ptr(data), _ptr(offsets), n, out_len, _ptr(out), _ptr(heads),
        )
        _count(plain_bytearray_encode)
    return out


plain_bytearray_encode.launches = 0


# -- the query and multi-device paths: masked aggregate, page-grid expansion ----

_AGG_OPS = {"count": 0, "sum": 1, "min": 2, "max": 3}
_AGG_DTYPES = {
    torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3, torch.bool: 4,
}
# pass 1's block count: one block per 1,024 elements, at most 1,024 blocks
_AGG_MAX_BLOCKS = 1024
_INT64_MIN = -(1 << 63)


def _agg_out_dtype(dtype: torch.dtype, op: str, unsigned: bool) -> torch.dtype:
    """count -> int64; an integer or bool sum -> int64; a float result keeps
    its dtype; an unsigned view's min/max -> int64 (the uint64 pattern)."""
    if op == "count" or (not dtype.is_floating_point and (op == "sum" or unsigned)):
        return torch.int64
    return dtype


def _agg_bits(values: torch.Tensor, unsigned: bool, bits) -> int:
    width = values.element_size() * 8
    if not unsigned or bits is None or bits >= width:
        return width
    if bits < 1:
        raise ValueError(f"masked_agg: sub-width of {bits} bits")
    return int(bits)


def _agg_identity(dtype: torch.dtype, op: str, unsigned: bool, dev) -> torch.Tensor:
    out = _agg_out_dtype(dtype, op, unsigned)
    if op in ("count", "sum"):
        return torch.zeros((), dtype=out, device=dev)
    lo = op == "min"
    if dtype.is_floating_point:
        v = math.inf if lo else -math.inf
    elif unsigned:
        v = -1 if lo else 0  # the uint64 patterns of UINT64_MAX and 0
    elif dtype == torch.bool:
        v = lo
    else:
        info = torch.iinfo(dtype)
        v = info.max if lo else info.min
    return torch.full((), v, dtype=out, device=dev)


def _signed_zero(r, values, mask, op):
    """A float min (max) equal to zero is -0.0 (+0.0) when a kept value is
    that zero: XLA's reduce orders -0.0 below +0.0."""
    want_neg = op == "min"
    zeros = mask & (values == 0) & (torch.signbit(values) == want_neg)
    signed = torch.full_like(r, -0.0 if want_neg else 0.0)
    return torch.where((r == 0) & zeros.any(), signed, r)


def masked_agg_plain(values, mask, op: str, *, unsigned: bool = False, bits=None):
    """Plain version of masked_agg (semantics in kernels/csrc/masked_agg.cu).
    Unsigned views compute in int64 lanes: the uint64 order is the int64
    order with the sign bit flipped."""
    dev = values.device
    n = values.numel()
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    if op == "count":
        return mask.sum(dtype=torch.int64)
    if n == 0:
        return _agg_identity(values.dtype, op, unsigned, dev)
    if values.dtype.is_floating_point:
        v = values.to(torch.float64)
        if op == "sum":
            r = torch.where(mask, v, 0.0).sum() + 0.0  # a sum of -0.0s is +0.0
        else:
            w = torch.where(mask, v, math.inf if op == "min" else -math.inf)
            r = _signed_zero(w.amin() if op == "min" else w.amax(), v, mask, op)
        r = r.to(values.dtype)
        return torch.where(torch.isnan(r), torch.full_like(r, math.nan), r)
    v = values.to(torch.int64)
    if unsigned:
        keep = _agg_bits(values, True, bits)
        if keep < 64:
            v = v & ((1 << keep) - 1)
    if op == "sum":
        return torch.where(mask, v, 0).sum()
    ident = _agg_identity(values.dtype, op, unsigned, dev).to(torch.int64)
    if unsigned:
        v = v ^ _INT64_MIN
        ident = ident ^ _INT64_MIN
    w = torch.where(mask, v, ident)
    r = w.amin() if op == "min" else w.amax()
    if unsigned:
        return r ^ _INT64_MIN
    return r.to(values.dtype) if values.dtype != torch.bool else r != 0


def masked_agg(values: torch.Tensor, mask, op: str, *, unsigned: bool = False, bits=None):
    """One count, sum, min or max of a 1-D column under a bool row mask (None:
    every row), as a 0-d tensor on the column's device:

      count    the true mask entries, int64;
      sum      integers and bools in 64-bit two's complement, int64 (an
               unsigned view's uint64 pattern); floats accumulated in double,
               in the column's dtype;
      min/max  masked-out rows take the identity (the dtype's max/min, +-inf,
               True/False); the column's dtype, or int64 holding the uint64
               pattern for an unsigned view; NaN propagates; -0.0 < +0.0.

    `unsigned` reads int32/int64 values as their unsigned bit patterns,
    masked to the low `bits` (UINT_8, UINT_16) when given, and widened to 64
    bits in the load. n = 0 gives the identity. Replaces
    parquet_tpu/kernels/device_ops.py:masked_agg_device (and the counts,
    the unsigned view and the widening of serve/query_device.py)."""
    _check_vec(values, tuple(_AGG_DTYPES), "masked_agg: values")
    if mask is not None:
        _check_vec(mask, (torch.bool,), "masked_agg: mask")
        if mask.numel() != values.numel():
            raise ValueError(
                f"masked_agg: {mask.numel()} mask entries for {values.numel()} values"
            )
    if op not in _AGG_OPS:
        raise ValueError(f"masked_agg: unsupported op {op!r}")
    if unsigned and values.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"masked_agg: no unsigned view of {values.dtype}")
    bits = _agg_bits(values, unsigned, bits)
    if _on_cpu(values, *(() if mask is None else (mask,))):
        return masked_agg_plain(values, mask, op, unsigned=unsigned, bits=bits)
    dev = values.device
    n = values.numel()
    nb = max(1, min(_AGG_MAX_BLOCKS, -(-n // 1024)))
    partial = torch.empty(nb, dtype=torch.int64, device=dev)
    out = torch.empty((), dtype=_agg_out_dtype(values.dtype, op, unsigned), device=dev)
    _launch(
        "masked_agg", dev, _lib().pqt_masked_agg,
        _ptr(values), None if mask is None else _ptr(mask), n, _AGG_DTYPES[values.dtype],
        _AGG_OPS[op], int(unsigned), bits, nb, _ptr(partial), _ptr(out),
    )
    _count(masked_agg)
    return out


masked_agg.launches = 0


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes wrapped to the int32 range (two's complement)."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def expand_page_grid_plain(words, starts, is_rle, values, bit_starts, dictionary,
                           width: int, n_out: int) -> torch.Tensor:
    """Plain version of the page-grid expansion (kernels/csrc/
    expand_page_grid.cu): the JAX program's int32 arithmetic in int64 lanes
    wrapped to int32, its gathers wrapped once and clamped."""
    dev = words.device
    n_pages, n_words = words.shape
    n_runs = starts.shape[1]
    if n_pages == 0 or n_out == 0:
        return torch.empty((n_pages, n_out), dtype=dictionary.dtype, device=dev)
    i = torch.arange(n_out, dtype=torch.int64, device=dev).expand(n_pages, n_out).contiguous()
    r = (torch.searchsorted(starts.to(torch.int64), i, right=True) - 1).clamp(0, n_runs - 1)

    def take(t):
        return t.to(torch.int64).gather(1, r)

    within = _wrap32(i - take(starts))
    bitpos = _wrap32(take(bit_starts) + within * width)
    w0 = bitpos >> 5
    s = bitpos & 31
    wd = _u32(words)

    def word(j):
        j = torch.where(j < 0, j + n_words, j).clamp(0, n_words - 1)
        return wd.gather(1, j)

    lo = word(w0) >> s
    hi = torch.where(s == 0, 0, (word(torch.clamp(w0 + 1, max=n_words - 1)) << ((32 - s) & 31)) & _M32)
    vmask = (1 << width) - 1 if width < 32 else _M32
    idx = torch.where(take(is_rle) == 1, _u32(values).gather(1, r), (lo | hi) & vmask)
    # XLA's gather reads the uint32 index as int32 and clamps it
    return dictionary[_wrap32(idx).clamp(0, dictionary.numel() - 1)]


# Outputs a tile (a block) and a thread of the page-grid expansion, and the
# most runs a tile stages in shared memory (kTile, kItems and kStageRuns of
# kernels/csrc/expand_page_grid.cu, pinned by a test).
PAGE_GRID_TILE = 2048
PAGE_GRID_ITEMS = 8
PAGE_GRID_STAGE_RUNS = 128


def expand_page_grid(words, starts, is_rle, values, bit_starts, dictionary,
                     width: int, n_out: int) -> torch.Tensor:
    """Expand a padded page grid of hybrid RLE/bit-packed index pages and
    gather each index from `dictionary`: (P, n_out) of the dictionary's dtype
    (int32 or int64; floats as their bit patterns). `words` (P, W) holds the
    pages' packed payload as uint32 patterns in int32, `starts`, `is_rle`,
    `values` (uint32 patterns) and `bit_starts` (P, R) their run tables,
    padded as parallel/mesh.build_page_grid pads them (each starts row
    non-decreasing). Positions past a page's real count hold what the JAX
    program computes there; an index at or past the dictionary's end takes
    its last entry, one at or above 2^31 its first (XLA reads the uint32
    index as int32 and clamps). Replaces parquet_tpu/parallel/mesh.py:
    _expand_one_page (vmapped) and the dictionary gather of
    sharded_decode_step."""
    grid = (words, starts, is_rle, values, bit_starts)
    for name, t in zip(("words", "starts", "is_rle", "values", "bit_starts"), grid):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 2:
            raise TypeError(f"expand_page_grid: {name} must be a 2-D int32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"expand_page_grid: {name} must be contiguous")
    _check_vec(dictionary, (torch.int32, torch.int64), "expand_page_grid: dictionary")
    n_pages, n_words = words.shape
    n_runs = starts.shape[1]
    if any(t.shape != (n_pages, n_runs) for t in grid[2:]) or starts.shape[0] != n_pages:
        raise ValueError("expand_page_grid: run tables disagree with the grid's shape")
    if n_words < 1 or n_runs < 1:
        raise ValueError("expand_page_grid: a grid needs at least one word and one run")
    if not 0 <= width <= 32:
        raise ValueError(f"expand_page_grid: width {width} outside 0..32")
    n_out = int(n_out)
    if not 0 <= n_out < (1 << 31):
        raise ValueError(f"expand_page_grid: n_out {n_out} outside the int32 range")
    if n_pages * n_out and dictionary.numel() == 0:
        raise ValueError("expand_page_grid: empty dictionary with outputs to gather")
    if _on_cpu(*grid, dictionary):
        return expand_page_grid_plain(*grid, dictionary, width, n_out)
    dev = words.device
    out = torch.empty((n_pages, n_out), dtype=dictionary.dtype, device=dev)
    if out.numel():
        _launch(
            "expand_page_grid", dev, _lib().pqt_expand_page_grid,
            _ptr(words), n_words, _ptr(starts), _ptr(is_rle), _ptr(values),
            _ptr(bit_starts), n_runs, width, _ptr(dictionary), dictionary.numel(),
            dictionary.element_size(), n_pages, n_out, _ptr(out),
        )
        _count(expand_page_grid)
    return out


expand_page_grid.launches = 0


# The kernels of the decode, batch, filter, write, query and multi-device
# paths, by name.
KERNELS = {
    "expand_hybrid": expand_hybrid,
    "dict_gather": dict_gather,
    "delta_packed_decode": delta_packed_decode,
    "bss_transpose": bss_transpose,
    "merge_mixed_numeric": merge_mixed_numeric,
    "merge_mixed_bytes": merge_mixed_bytes,
    "record_starts": record_starts,
    "list_layout": list_layout,
    "pad_ragged": pad_ragged,
    "expand_nullable": expand_nullable,
    "predicate_mask": predicate_mask,
    "leaf_verdict": leaf_verdict,
    "list_contains_mask": list_contains_mask,
    "mask_take": mask_take,
    "bitpack_encode": bitpack_encode,
    "rle_hybrid_encode": rle_hybrid_encode,
    "dict_indices": dict_indices,
    "delta_block_encode": delta_block_encode,
    "plain_bytearray_encode": plain_bytearray_encode,
    "masked_agg": masked_agg,
    "expand_page_grid": expand_page_grid,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    expand_hybrid.launches_by_width = {}
    dict_indices.launches_by_width = {}
    leaf_verdict.launches_by_kind = {}
