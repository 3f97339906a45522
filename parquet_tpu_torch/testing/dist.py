"""Multi-rank runs on one machine, and the steps of the multi-device check.

`spawn(fn, world_size, *args)` starts `world_size` processes with
torch.multiprocessing (spawn), initialises a torch.distributed group in each
through a `file://` store in a temporary directory (no TCP port, so
concurrent runs cannot collide), runs `fn(rank, world_size, *args)` and
returns the results by rank. Every wait has a deadline: past it the
children are killed and `spawn` raises. A child imports only this module's
dependencies (torch, numpy, the port), so nothing it runs imports JAX.

The steps are the port of the entry point's checks of the multi-device
path (the reference's __graft_entry__.py): `decode_step` (expand a page
grid, gather, count and a masked checksum), `mesh_step` (a pages x cols
DeviceMesh: counts and checksums summed over "pages", gathered over
"cols") and `train_step` (a masked sum over a sharded MaskedColumn batch,
summed over the group). chip_smoke.py runs them at world size 1 on the
card; `run_checks` is the worker the CPU tests run over gloo.

    python -c "from parquet_tpu_torch.testing.dist import spawn, echo; print(spawn(echo, 2))"
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.reader import FileReader, MaskedColumn, resolve_device
from ..kernels.device_ops import masked_agg
from ..parallel.mesh import PageGrid, decode_page_block, sharded_decode_step
from ..parallel.scan import distributed_column_stats, mesh_reduce_stats
from .parity import batches_to_numpy

__all__ = [
    "spawn",
    "echo",
    "decode_step",
    "mesh_step",
    "train_step",
    "run_checks",
    "stats_to_numpy",
]


def _child(fn, rank: int, world: int, init: str, backend: str, out, args) -> None:
    try:
        torch.set_num_threads(1)
        if backend == "nccl":  # NCCL takes one card a rank
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, *args, timeout: float = 60.0, backend: str = "gloo") -> list:
    """Run fn(rank, world_size, *args) in `world_size` spawned processes of
    one torch.distributed group; return the results by rank. Raises
    RuntimeError with a child's traceback when one fails, and TimeoutError
    (after killing the children) when they are not done in `timeout`
    seconds. `fn` must be importable by name (a module-level function)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_child, args=(fn, r, world_size, init, backend, out, args))
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        results: dict = {}
        try:
            deadline = _now() + timeout
            while len(results) < world_size:
                try:
                    rank, ok, payload = out.get(timeout=0.2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"spawn: rank {dead[0]} exited with {procs[dead[0]].exitcode} "
                            "before reporting"
                        ) from None
                    if _now() > deadline:
                        raise TimeoutError(
                            f"spawn: {world_size - len(results)} of {world_size} ranks "
                            f"not done in {timeout} s"
                        ) from None
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{payload}")
                results[rank] = payload
            for p in procs:
                p.join(max(deadline - _now(), 0.01))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
    return [results[r] for r in range(world_size)]


def _now() -> float:
    return time.monotonic()


def echo(rank: int, world: int) -> tuple:
    """(rank, world, the group's all-reduced rank sum): a harness check."""
    t = torch.tensor([rank])
    dist.all_reduce(t)
    return rank, world, int(t)


def stats_to_numpy(stats: dict) -> dict:
    """{key: {"min", "max", "count"}} of 0-d tensors as NumPy scalars."""
    return {
        k: {f: v.detach().cpu().numpy()[()] for f, v in s.items()} for k, s in stats.items()
    }


# -- the steps of the multi-device check --------------------------------------


def decode_step(grid: PageGrid, dictionary, n_out: int, device=None):
    """The entry's decode_step: expand + gather every page of `grid` on one
    device, then the count of real values and the checksum (their sum,
    wrapping in 64 bits). Returns (decoded (P, n_out), {"count",
    "checksum"} 0-d tensors)."""
    dev = resolve_device(device)
    decoded, valid = decode_page_block(
        grid.words, grid.starts, grid.is_rle, grid.values, grid.bit_starts, grid.counts,
        dictionary, grid.width, n_out, dev,
    )
    flat = decoded.reshape(-1)
    return decoded, {"count": masked_agg(flat, valid, "count"),
                     "checksum": masked_agg(flat, valid, "sum")}


def mesh_step(mesh, words, starts, is_rle, values, bit_starts, counts, dictionaries,
              width: int, n_out: int, device=None):
    """The dry run's sharded step over a 2-D DeviceMesh with dims ("pages",
    "cols"): the arrays are stacked (cols, pages, ...); this rank expands its
    column's block of pages, sums its count and checksum over "pages" and
    all-gathers the column checksums over "cols". Returns (decoded block,
    count, col_checksums (n_cols,))."""
    dev = resolve_device(device)
    pi, ci = mesh.get_coordinate()
    per = words.shape[1] // mesh.size(0)
    blk = slice(pi * per, (pi + 1) * per)
    decoded, valid = decode_page_block(
        words[ci, blk], starts[ci, blk], is_rle[ci, blk], values[ci, blk],
        bit_starts[ci, blk], counts[ci, blk], dictionaries[ci], width, n_out, dev,
    )
    flat = decoded.reshape(-1)
    local = torch.stack([masked_agg(flat, valid, "count"), masked_agg(flat, valid, "sum")])
    dist.all_reduce(local, group=mesh.get_group("pages"))
    gathered = [torch.empty_like(local[1:]) for _ in range(mesh.size(1))]
    dist.all_gather(gathered, local[1:].contiguous(), group=mesh.get_group("cols"))
    return decoded, local[0], torch.cat(gathered)


def train_step(batch: dict, group=None, x=("x",), a=("a",)) -> torch.Tensor:
    """The dry run's train_step on this rank's shard of a batch: the masked
    sum of the MaskedColumn `x` plus the sum of the column `a`, and x's
    valid count, summed over `group` when torch.distributed is initialised.
    Returns int64[2]."""
    xc: MaskedColumn = batch[x]
    local = torch.stack([
        masked_agg(xc.values, xc.mask, "sum") + masked_agg(batch[a], None, "sum"),
        masked_agg(xc.mask, xc.mask, "count"),
    ])
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(local, group=group)
    return local


# -- the CPU tests' worker ---------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def run_checks(rank: int, world: int, spec: dict) -> dict:
    """Run the checks `spec` names on this rank (the default group), with
    tensors on spec["device"] (default the CPU; "cuda" is the rank's own
    card, rank modulo the card count), and return their results as NumPy:

      "reduce"   [(per-rank stats, replicas)]: mesh_reduce_stats of this
                 rank's {key: {"min", "max", "count"}};
      "stats"    [(path, columns, filters)]: distributed_column_stats;
      "decode"   [(grid, dictionary, n_out)]: sharded_decode_step;
      "batches"  [(path, batch_size, kwargs)]: iter_device_batches(
                 sharding=the default group);
      "steps"    (grid, dictionary, n_out, stacked mesh arrays, path): the
                 three steps over a 2 x 2 ("pages", "cols") DeviceMesh and
                 distributed_column_stats over it.
    """
    out: dict = {}
    dev = torch.device(spec.get("device", "cpu"))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    for stats, replicas in spec.get("reduce", ()):
        mine = {k: {f: torch.as_tensor(v, device=dev) for f, v in s.items()}
                for k, s in stats[rank].items()}
        out.setdefault("reduce", []).append(
            stats_to_numpy(mesh_reduce_stats(mine, None, replicas))
        )
    for path, columns, filters in spec.get("stats", ()):
        with FileReader(path, device=dev) as r:
            out.setdefault("stats", []).append(
                distributed_column_stats(r, columns, filters=filters)
            )
    for grid, dictionary, n_out in spec.get("decode", ()):
        decoded, stats = sharded_decode_step(None, grid, dictionary, n_out, device=dev)
        out.setdefault("decode", []).append((_np(decoded), stats_to_numpy({"s": stats})["s"]))
    for path, batch_size, kwargs in spec.get("batches", ()):
        with FileReader(path, device=dev) as r:
            it = r.iter_device_batches(batch_size, sharding=dist.group.WORLD, **kwargs)
            out.setdefault("batches", []).append([batches_to_numpy(b) for b in it])
    if "steps" in spec:
        out["steps"] = _steps(dev, *spec["steps"])
    return out


def _steps(dev, grid, dictionary, n_out, stacked, path) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(dev.type, (2, 2), mesh_dim_names=("pages", "cols"))
    decoded, stats = decode_step(grid, dictionary, n_out, device=dev)
    m_decoded, m_count, m_sums = mesh_step(mesh, *stacked, device=dev)
    with FileReader(path, device=dev) as r:
        total = torch.zeros(2, dtype=torch.int64, device=dev)
        for b in r.iter_device_batches(128 * 4, sharding=dist.group.WORLD, nullable="mask",
                                       drop_remainder=False):
            total += train_step(b)
        col_stats = distributed_column_stats(r, [("a",), ("ts",)], group=mesh)
    return {
        "decode": (_np(decoded), stats_to_numpy({"s": stats})["s"]),
        "mesh": (_np(m_decoded), _np(m_count), _np(m_sums)),
        "train": _np(total),
        "stats": col_stats,
    }
