"""Multi-device scale-out: sharded page-grid decode over torch.distributed ranks.

A port of parquet_tpu/parallel/mesh.py. The natural parallel axes of the
workload are pages x columns x row groups; here the pages of one column are
split over the ranks of a process group, one device a rank:

  each rank takes a contiguous block of a fixed-shape padded page grid (the
  page count padded to a multiple of the world size with all-zero pages, as
  the JAX version pads its "pages" axis), expands and gathers it on its
  device in one expand_page_grid launch (kernels/csrc/expand_page_grid.cu),
  takes the block's masked min/max/count under each page's real count with
  masked_agg, and all-reduces the three scalars over the group (MIN / MAX /
  SUM, NCCL on the card, gloo on the CPU).

The decoded block stays on its rank's device; only the stats cross ranks.
The page grid is P pages x R runs x W words x n_out values a page, so every
page expands in the same launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.reader import resolve_device
from ..kernels.device_ops import expand_page_grid, masked_agg
from ..kernels.pipeline import to_device
from .scan import _all_reduce, _distributed, _resolve

__all__ = ["PageGrid", "build_page_grid", "decode_page_block", "sharded_decode_step"]


class PageGrid:
    """Host-side padded page batch: one column's pages as fixed-shape arrays."""

    def __init__(self, words, starts, is_rle, values, bit_starts, counts, width: int):
        self.words = words  # (P, W) uint32
        self.starts = starts  # (P, R) int32 run output starts (pad: n_out + 1)
        self.is_rle = is_rle  # (P, R) int32
        self.values = values  # (P, R) uint32
        self.bit_starts = bit_starts  # (P, R) int32
        self.counts = counts  # (P,) int32 real values per page
        self.width = width

    @property
    def num_pages(self) -> int:
        return self.words.shape[0]


def build_page_grid(tables, takes, width: int, out_per_page: int) -> PageGrid:
    """Pad per-page run tables (ops/rle_hybrid.prescan_hybrid) into a grid."""
    n_pages = len(tables)
    max_runs = max((len(t.counts) for t in tables), default=1)
    max_words = max((len(t.packed) + 7) // 4 + 1 for t in tables)
    words = np.zeros((n_pages, max_words), dtype=np.uint32)
    starts = np.full((n_pages, max_runs), out_per_page + 1, dtype=np.int32)
    is_rle = np.zeros((n_pages, max_runs), dtype=np.int32)
    values = np.zeros((n_pages, max_runs), dtype=np.uint32)
    bit_starts = np.zeros((n_pages, max_runs), dtype=np.int32)
    counts = np.zeros(n_pages, dtype=np.int32)
    for p, (t, take) in enumerate(zip(tables, takes)):
        w = np.frombuffer(
            bytes(t.packed) + b"\x00" * ((-len(t.packed)) % 4 + 4), dtype="<u4"
        )
        words[p, : len(w)] = w
        r = len(t.counts)
        out_start = np.zeros(r, dtype=np.int64)
        np.cumsum(t.counts[:-1], out=out_start[1:])
        starts[p, :r] = out_start
        is_rle[p, :r] = t.is_rle
        values[p, :r] = t.rle_values.astype(np.uint32)
        bit_starts[p, :r] = t.bp_offsets * 8
        counts[p] = take
    return PageGrid(words, starts, is_rle, values, bit_starts, counts, width)


_DICT_DTYPES = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def _block(a: np.ndarray, pad_pages: int, lo: int, hi: int) -> np.ndarray:
    """Pages [lo, hi) of `a` after padding its page axis with zero pages."""
    if pad_pages:
        a = np.pad(a, [(0, pad_pages)] + [(0, 0)] * (a.ndim - 1))
    return a[lo:hi]


def decode_page_block(words, starts, is_rle, values, bit_starts, counts, dictionary,
                      width: int, n_out: int, device):
    """Expand + gather a block of pages (host arrays laid out as PageGrid's)
    on `device` in one expand_page_grid launch. Returns (decoded (P, n_out)
    of the dictionary's dtype, valid bool[P * n_out]: the positions below
    each page's real count). The valid mask is one broadcast compare, not
    fused into the kernel."""
    dev = resolve_device(device)
    d = np.ascontiguousarray(dictionary)
    if d.dtype not in _DICT_DTYPES:
        raise ValueError(f"page grid: dictionary of {d.dtype}")

    def up(a):
        return to_device(np.ascontiguousarray(a).view(np.int32), dev)

    bits = to_device(d.view(np.int32 if d.dtype.itemsize == 4 else np.int64), dev)
    decoded = expand_page_grid(
        up(words), up(starts), up(is_rle), up(values), up(bit_starts), bits, width, n_out,
    ).view(_DICT_DTYPES[d.dtype])
    valid = (
        torch.arange(n_out, dtype=torch.int32, device=dev).reshape(1, n_out)
        < to_device(np.ascontiguousarray(counts, dtype=np.int32), dev).reshape(-1, 1)
    ).reshape(-1)
    return decoded, valid


def _page_stats(decoded: torch.Tensor, valid: torch.Tensor) -> dict:
    """Masked min/max/count of a decoded block under its valid mask. An
    integer block's masked-out positions enter the max as -iinfo.max, as
    the reference's where(valid, decoded, -big) does."""
    flat = decoded.reshape(-1)
    mn = masked_agg(flat, valid, "min")
    mx = masked_agg(flat, valid, "max")
    count = masked_agg(flat, valid, "count")
    if not decoded.dtype.is_floating_point and flat.numel():
        floor = torch.full((), -torch.iinfo(decoded.dtype).max, dtype=decoded.dtype,
                           device=decoded.device)
        padded = count < flat.numel()
        mx = torch.where(padded, torch.maximum(mx, floor), mx)
    return {"min": mn, "max": mx, "count": count}


def sharded_decode_step(group, grid: PageGrid, dictionary, n_out: int, *, device=None):
    """One sharded decode step: expand pages + dictionary gather + global stats.

    `group` is a torch.distributed ProcessGroup or DeviceMesh (flattened), or
    None: the default group when one is initialised, else this process
    alone. Each rank expands its contiguous block of the grid's pages
    (padded to a multiple of the world size) on `device` (default CUDA).
    Returns (decoded (P_local, n_out) on the device, {"min", "max", "count"}
    0-d tensors reduced over the group). The dictionary is int32, int64,
    float32 or float64 (floats are gathered as their bit patterns).
    """
    dev = resolve_device(device)
    g, rank, size = _resolve(group)
    pad_pages = (-grid.num_pages) % size
    per = (grid.num_pages + pad_pages) // size
    lo, hi = rank * per, (rank + 1) * per

    blocks = [
        _block(a, pad_pages, lo, hi)
        for a in (grid.words, grid.starts, grid.is_rle, grid.values, grid.bit_starts,
                  grid.counts)
    ]
    decoded, valid = decode_page_block(*blocks, dictionary, grid.width, n_out, dev)
    stats = _page_stats(decoded, valid)
    if _distributed():
        stats = {
            "min": _all_reduce(stats["min"], "MIN", g),
            "max": _all_reduce(stats["max"], "MAX", g),
            "count": _all_reduce(stats["count"], "SUM", g),
        }
    return decoded, stats
