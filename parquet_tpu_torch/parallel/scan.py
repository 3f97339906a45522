"""Sharded columnar scans: map-reduce over row groups across devices and ranks.

A port of parquet_tpu/parallel/scan.py. The row group is the distribution
unit: each is decoded straight into the memory of one of the given devices
(round-robin), a map function runs on that device's columns, and the small
per-group results are moved to the first device and folded there.

    out = scan_row_groups(
        reader, [torch.device("cuda:0")],
        map_fn=lambda cols: cols[("fare",)].values.sum(),
        reduce_fn=lambda a, b: a + b,
    )

column_stats() is the canonical scan: per-column min/max/count computed on
the device (kernels/device_ops.masked_agg, no mask), folded with
torch.minimum / torch.maximum, which propagate NaN as jnp.minimum does.

Across processes, row groups shard by rank (process_row_groups), each rank
folds its own, and the per-rank partials all-reduce over a torch.distributed
group (mesh_reduce_stats): MIN / MAX / SUM, NCCL on the card and gloo on the
CPU. NaN has a rule at each level, the reference's: the per-group min/max
and the fold propagate it; the collective skips it (a NaN partial enters
as the identity, as jax.lax.pmin / pmax treat it on the CPU mesh), so a
column whose every partial is NaN reduces to (+inf, -inf).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..core.reader import resolve_column_prefixes, resolve_device
from ..kernels.device_ops import masked_agg
from ..meta.parquet_types import Type

__all__ = [
    "scan_row_groups",
    "column_stats",
    "process_row_groups",
    "mesh_reduce_stats",
    "distributed_column_stats",
]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def scan_row_groups(reader, devices, map_fn, reduce_fn, columns=None, indices=None):
    """Decode row groups onto `devices` round-robin and map-reduce.

    `map_fn(cols)` receives {leaf path: DeviceColumn} with tensors on the
    device that decoded the group and returns a tree (dicts, lists, tuples)
    of tensors; `reduce_fn(acc, x)` folds two such trees. `indices`
    restricts the scan to those row groups (default: all; a rank passes its
    own slice). Returns the folded result (None when no group was scanned).

    Every group's decode is launched before the first result is folded: the
    launches queue on each device's current stream.
    """
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("scan: no devices given")
    if indices is None:
        indices = range(reader.num_row_groups)
    shard_results = []
    for k, i in enumerate(indices):
        # round-robin by LOCAL position: a rank's strided indices still
        # spread over every local device
        dev = devices[k % len(devices)]
        cols = reader.read_row_group_device(i, columns=columns, device=dev)
        shard_results.append(map_fn(cols))
    if not shard_results:
        return None
    # fold on the first device: each result is moved there explicitly
    home = devices[0]
    acc = _tree_map(lambda t: t.to(home), shard_results[0])
    for x in shard_results[1:]:
        acc = reduce_fn(acc, _tree_map(lambda t: t.to(home), x))
    return acc


def _dtype_limits(dtype: torch.dtype, device):
    """(lowest, highest) of a dtype as 0-d tensors: the fold identities."""
    if dtype.is_floating_point:
        lo, hi = -float("inf"), float("inf")
    elif dtype == torch.bool:
        lo, hi = False, True
    else:
        info = torch.iinfo(dtype)
        lo, hi = info.min, info.max
    return (torch.full((), lo, dtype=dtype, device=device),
            torch.full((), hi, dtype=dtype, device=device))


def _chunk_stats(dc):
    """min/max/count of one DeviceColumn's values on its device."""
    v = dc.values
    n = torch.full((), v.shape[0], dtype=torch.int64, device=v.device)
    if v.shape[0] == 0:
        lo, hi = _dtype_limits(v.dtype, v.device)
        return {"min": hi, "max": lo, "count": n}
    return {"min": masked_agg(v, None, "min"), "max": masked_agg(v, None, "max"), "count": n}


def _stats_map_fn(cols):
    return {p: _chunk_stats(dc) for p, dc in cols.items() if dc.values is not None}


def _fold(a, b, lo: bool):
    """torch.minimum / torch.maximum (NaN propagates), with -0.0 ordered
    below +0.0 as XLA orders them."""
    r = torch.minimum(a, b) if lo else torch.maximum(a, b)
    if not a.dtype.is_floating_point:
        return r
    both = torch.where(torch.signbit(a) == lo, a, b)
    return torch.where((a == b) & (a == 0), both, r)


def _stats_reduce_fn(a, b):
    out = {}
    for p in a.keys() | b.keys():
        if p not in a:
            out[p] = b[p]
        elif p not in b:
            out[p] = a[p]
        else:
            out[p] = {
                "min": _fold(a[p]["min"], b[p]["min"], True),
                "max": _fold(a[p]["max"], b[p]["max"], False),
                "count": a[p]["count"] + b[p]["count"],
            }
    return out


def _scalar(t):
    """A 0-d tensor as the NumPy scalar np.asarray(x)[()] gives."""
    return t.detach().cpu().numpy()[()]


def _stats_materialize(folded) -> dict:
    # count == 0: every shard contributed only the fold identity (inverted
    # dtype extremes): there are no values, so there are no bounds
    out = {}
    for p, s in folded.items():
        count = int(s["count"])
        out[p] = {
            "min": _scalar(s["min"]) if count else None,
            "max": _scalar(s["max"]) if count else None,
            "count": count,
        }
    return out


def column_stats(reader, devices, columns=None, filters=None):
    """Global per-column {min, max, count} over the whole file.

    Numeric columns only (dictionary-encoded byte-array columns have no
    device values; project them out with `columns=`). `filters` prunes row
    groups (statistics + bloom) before any decode: the stats then cover the
    surviving groups whole, not exact predicate matches."""
    indices = reader.prune_row_groups(filters) if filters is not None else None
    folded = scan_row_groups(
        reader, devices, _stats_map_fn, _stats_reduce_fn, columns=columns, indices=indices,
    )
    return {} if folded is None else _stats_materialize(folded)


# -- scale-out over ranks ----------------------------------------------------------
#
# Row groups shard by rank (each rank touches only its slice of the file),
# each rank folds its own on its device, and the per-rank partials (a few
# scalars a column) all-reduce over a torch.distributed group: the decoded
# data never crosses ranks.


def _group_of(group):
    """The process group a collective runs on: None is the default group; a
    DeviceMesh of any rank count is flattened to the group of all its ranks
    (as the reference flattens an N-D mesh)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(group, DeviceMesh):
        return group
    if group.ndim == 1:
        return group.get_group()
    ranks = sorted(int(r) for r in group.mesh.flatten().tolist())
    if ranks == list(range(dist.get_world_size())):
        return None
    return dist.new_group(ranks)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _resolve(group=None) -> tuple:
    """(process group, rank in it, its size); (None, 0, 1) when
    torch.distributed is not initialised."""
    if not _distributed():
        return None, 0, 1
    g = _group_of(group)
    return g, dist.get_rank(g), dist.get_world_size(g)


def process_row_groups(num_row_groups: int, process_index=None, process_count=None):
    """The row-group indices owned by this rank (round-robin by rank). The
    defaults are the default group's rank and size when torch.distributed
    is initialised, else 0 and 1."""
    _g, rank, size = _resolve()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    return list(range(pi, num_row_groups, pc))


_REDUCE = (("min", "MIN"), ("max", "MAX"), ("count", "SUM"))


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """all_reduce of a 0-d tensor into a copy. Bools travel as uint8. For
    MIN / MAX a float NaN enters as the identity (+inf / -inf): the
    collective skips NaN, as the reference's pmin / pmax do on its CPU mesh,
    whatever the backend's own rule (gloo's depends on the operands' order;
    NCCL's is not measured)."""
    x = t.reshape(1).to(torch.uint8) if t.dtype == torch.bool else t.reshape(1).clone()
    if op != "SUM" and x.dtype.is_floating_point:
        x = torch.where(torch.isnan(x), math.inf if op == "MIN" else -math.inf, x)
    dist.all_reduce(x, op=getattr(dist.ReduceOp, op), group=group)
    return x.to(t.dtype).reshape(t.shape)


def mesh_reduce_stats(stats: dict, group=None, replicas_per_participant: int = 1) -> dict:
    """All-reduce per-column {min, max, count} over every rank of `group` (a
    ProcessGroup, a DeviceMesh of any rank count, or None for the default
    group): MIN of the mins, MAX of the maxes, SUM of the counts divided by
    `replicas_per_participant` (a partial replicated over r ranks counts
    once). Every rank must pass the same keys: the collectives run in one
    sorted key order, built from the shared schema, not from which chunks a
    rank happened to decode. Values are 0-d tensors on the group's device
    (CUDA for NCCL)."""
    g = _group_of(group)
    n = dist.get_world_size(g)
    r = replicas_per_participant
    if n % max(r, 1) != 0:
        raise ValueError(f"group of {n} ranks not divisible by {r} replicas")
    out = {}
    for p in sorted(stats):
        s = stats[p]
        red = {k: _all_reduce(torch.as_tensor(s[k]), op, g) for k, op in _REDUCE}
        red["count"] = red["count"] // r
        out[p] = red
    return out


def _numeric_dtype(leaf):
    return {
        Type.INT32: torch.int32,
        Type.INT64: torch.int64,
        Type.FLOAT: torch.float32,
        Type.DOUBLE: torch.float64,
        Type.BOOLEAN: torch.bool,
    }.get(leaf.type)


def _stats_key_nodes(reader, columns) -> list:
    """The numeric leaves every rank reports on, from the schema and the
    projection (the reader's own included), so all ranks enter the
    collectives with the same keys whatever they decoded."""
    selected = resolve_column_prefixes(reader.schema, columns) if columns else reader._selected
    return [
        leaf
        for leaf in reader.schema.leaves
        if _numeric_dtype(leaf) is not None and (selected is None or leaf.path in selected)
    ]


def _stats_identity(leaf, device):
    lo, hi = _dtype_limits(_numeric_dtype(leaf), device)
    return {"min": hi, "max": lo, "count": torch.zeros((), dtype=torch.int64, device=device)}


def distributed_column_stats(reader, columns=None, group=None, devices=None, filters=None):
    """Whole-file column stats over the ranks of a torch.distributed group.

    Each rank decodes only its own row groups (process_row_groups) on its
    `devices` (default: the reader's device), folds them, and contributes
    one partial per numeric leaf, the fold identity for anything it did not
    decode, so every rank's keys match. The partials all-reduce over
    `group` (mesh_reduce_stats; one participant per rank). Without an
    initialised group the local fold is the answer. `filters` prunes row
    groups (statistics + bloom) before any decode; every rank prunes from
    the same metadata, so ownership stays consistent."""
    devices = [reader.device] if devices is None else [resolve_device(d) for d in devices]
    g, rank, size = _resolve(group)
    indices = process_row_groups(reader.num_row_groups, rank, size)
    if filters is not None:
        admitted = set(reader.prune_row_groups(filters))
        indices = [i for i in indices if i in admitted]
    key_nodes = _stats_key_nodes(reader, columns)
    acc = scan_row_groups(
        reader, devices, _stats_map_fn, _stats_reduce_fn, columns=columns, indices=indices,
    )
    full = {leaf.path: _stats_identity(leaf, devices[0]) for leaf in key_nodes}
    if acc:
        full.update({p: s for p, s in acc.items() if p in full})
    if _distributed():
        full = mesh_reduce_stats(full, g)
    return _stats_materialize(full)
