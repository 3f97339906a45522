"""Device primitives: the kernels of the decode path and of the batch path.

Each primitive has three parts:

  * a CUDA C++ kernel in `kernels/csrc/` (built by `kernels/build.py`), the
    port of one XLA program of `parquet_tpu/kernels/device_ops.py`;
  * a plain PyTorch version of the same function (`*_plain`). It runs on any
    device; the wrapper uses it only for tensors that lie on the CPU, and
    `chip_smoke.py` holds the kernel against it on the card;
  * the wrapper, which checks its inputs, takes the plain version for a CPU
    tensor, and for a CUDA tensor launches the kernel on the current stream
    or raises. Each wrapper carries a plain int `launches`, which goes up by
    one where the kernel is launched and nowhere else.

Bit patterns travel in signed dtypes: uploads are int32 (the uint32 words of
the frozen buffers) or int64 (uint64 words), and outputs hold the unsigned
results' bit patterns in int32/int64. PyTorch has no shifts, adds or
searchsorted on uint32/uint64 tensors on the CPU, so the plain versions
compute in int64 lanes with explicit masks.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "MAX_DEVICE_BATCH_BITS",
    "bytes_to_words32",
    "bytes_to_words64",
    "expand_hybrid",
    "expand_hybrid_plain",
    "dict_gather",
    "dict_gather_plain",
    "delta_packed_decode",
    "delta_packed_decode_plain",
    "bss_transpose",
    "bss_transpose_plain",
    "merge_mixed_numeric",
    "merge_mixed_numeric_plain",
    "merge_mixed_bytes",
    "merge_mixed_bytes_plain",
    "record_starts",
    "record_starts_plain",
    "list_layout",
    "list_layout_plain",
    "pad_ragged",
    "pad_ragged_plain",
    "expand_nullable",
    "expand_nullable_plain",
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
        expand_hybrid.launches += 1
    return out


expand_hybrid.launches = 0


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
        dict_gather.launches += 1
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
        tile = lib.pqt_delta_tile()
        scratch_c = torch.empty(total, dtype=dt, device=dev)
        block_sums = torch.empty((total + tile - 1) // tile, dtype=dt, device=dev)
        _launch(
            "delta_packed_decode", dev, lib.pqt_delta_packed_decode,
            _ptr(meta32), _ptr(wide), nbits, m_pad, p_pad, total,
            _ptr(out), _ptr(scratch_c), _ptr(block_sums),
        )
        delta_packed_decode.launches += 1
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


def bss_transpose(streams: torch.Tensor, num_values: int) -> torch.Tensor:
    """De-interleave a 4-byte BYTE_STREAM_SPLIT page: the four byte streams
    arrive as a (4, n_pad) uint8 tensor (one stream per row, padded), and
    out[i] is the little-endian word of streams[0..3, i], as int32 bit
    patterns. Replaces parquet_tpu/kernels/device_ops.py:bss_transpose_device
    (and its jitted _bss_transpose_padded); the port writes exactly
    `num_values` words."""
    if not isinstance(streams, torch.Tensor):
        raise TypeError("bss_transpose: streams must be a torch.Tensor")
    if streams.dtype != torch.uint8 or streams.dim() != 2 or streams.shape[0] != 4:
        raise ValueError(
            f"bss_transpose: expected a (4, n_pad) uint8 tensor, got "
            f"{tuple(streams.shape)} {streams.dtype}"
        )
    if not streams.is_contiguous():
        raise ValueError("bss_transpose: streams must be contiguous")
    n_pad = streams.shape[1]
    if not 0 <= num_values <= n_pad or n_pad >= (1 << 31):
        raise ValueError(f"bss_transpose: {num_values} values in a stream of {n_pad}")
    if _on_cpu(streams):
        return bss_transpose_plain(streams, num_values)
    out = torch.empty(num_values, dtype=torch.int32, device=streams.device)
    if num_values:
        _launch(
            "bss_transpose", streams.device, _lib().pqt_bss_transpose,
            _ptr(streams), n_pad, num_values, _ptr(out),
        )
        bss_transpose.launches += 1
    return out


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
        merge_mixed_numeric.launches += 1
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
    tile = lib.pqt_merge_bytes_tile()
    starts = torch.empty(max(n_rows, 1), dtype=torch.int64, device=dev)
    block_sums = torch.empty(max((n_rows + tile - 1) // tile, 1), dtype=torch.int64, device=dev)
    _launch(
        "merge_mixed_bytes", dev, lib.pqt_merge_mixed_bytes,
        _ptr(idx_all), idx_all.numel(), _bucket(max(idx_all.numel(), 1)),
        _ptr(doff), doff.numel(), _bucket(doff.numel()),
        _ptr(pool), pool.numel(),
        _ptr(po32), po32.numel(), _bucket(po32.numel()),
        _ptr(page_kind), _ptr(page_row_start), _ptr(page_aux), _ptr(page_src_base),
        page_kind.numel(), n_rows, data_bytes,
        _ptr(data), _ptr(offsets), _ptr(starts), _ptr(block_sums),
    )
    merge_mixed_bytes.launches += 1
    return data, offsets


merge_mixed_bytes.launches = 0


# -- the batch path: record starts, list layout, ragged padding, nulls ---------
#
# Four scans (kernels/csrc/scan.cuh) with their epilogues. The scans carry a
# scratch the wrapper allocates: a partial buffer of the scan's dtype and
# num_tiles + 1 tile sums (pqt_scan_tile() elements per tile).

_INT32_LIMIT = 1 << 31
# dtypes the byte-width kernels copy (1-, 4- and 8-byte elements)
_COPY_DTYPES = (
    torch.bool, torch.uint8, torch.int8, torch.int32, torch.float32, torch.int64, torch.float64,
)


def _tile_sums(lib, n: int, dtype, device) -> torch.Tensor:
    tile = lib.pqt_scan_tile()
    return torch.empty((n + tile - 1) // tile + 1, dtype=dtype, device=device)


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


def record_starts_plain(rep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the record starts: (row_of int32[n] = inclusive count
    of rep == 0, minus 1; n_rows int64 0-d)."""
    starts = (rep == 0).to(torch.int32)
    row_of = torch.cumsum(starts, 0, dtype=torch.int32) - 1
    return row_of, starts.sum(dtype=torch.int64)


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
    tile_sums = _tile_sums(lib, n, torch.int32, dev)
    _launch(
        "record_starts", dev, lib.pqt_record_starts,
        _ptr(rep), n, _ptr(row_of), _ptr(n_rows), _ptr(tile_sums),
    )
    record_starts.launches += 1
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
    lib = _lib()
    partial = torch.empty(n, dtype=torch.int64, device=dev)
    tile_sums = _tile_sums(lib, n, torch.int64, dev)
    _launch(
        "list_layout", dev, lib.pqt_list_layout,
        _ptr(rep), _ptr(dfl), n, parent_rep, elem_def,
        _ptr(offsets), _ptr(first_def), _ptr(n_slots), _ptr(partial), _ptr(tile_sums),
    )
    list_layout.launches += 1
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
    offs = torch.empty(rows, dtype=torch.int32, device=dev)
    tile_sums = _tile_sums(lib, rows, torch.int32, dev)
    _launch(
        "pad_ragged", dev, lib.pqt_pad_ragged,
        _ptr(values), nv, values.element_size(), _ptr(lengths), lengths.element_size(),
        rows, max_len,
        _ptr(out), _ptr(offs), _ptr(tile_sums),
    )
    pad_ragged.launches += 1
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
    lib = _lib()
    partial = torch.empty(n, dtype=torch.int32, device=dev)
    tile_sums = _tile_sums(lib, n, torch.int32, dev)
    _launch(
        "expand_nullable", dev, lib.pqt_expand_nullable,
        _ptr(values), nv, values.element_size(), _ptr(mask), n,
        _ptr(out), _ptr(partial), _ptr(tile_sums),
    )
    expand_nullable.launches += 1
    return out


expand_nullable.launches = 0


# The kernels of the decode path, by name.
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
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
