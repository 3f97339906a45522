"""Device-resident query units: filter and partially aggregate on the card.

A port of parquet_tpu/serve/query_device.py. Each unit (one row group of
one file) decodes its columns straight into device memory
(FileReader.read_row_group_device), the residual predicate evaluates as a
resident bool row mask (FileReader._device_group_mask with pyarrow's null
convention, the host vec engine as its typed and counted fallback), and
each aggregate reduces in ONE masked_agg launch (kernels/csrc/
masked_agg.cu) whose scalar is the only value that crosses back to the
host. Every device operation of the unit runs in a kernel of
kernels/device_ops.py:

  * the matched count (jnp.sum(mask)) and the nullable count
    (jnp.sum(mask & valid), the & a torch bitwise op) are masked_agg
    counts;
  * the alignment of the row mask with a nullable column's dense values
    (mask[flatnonzero(valid)]) is mask_take's two halves: one scan of the
    validity, uploaded once per column, and one row gather of the mask;
  * a chunk that arrives as indices + a numeric host dictionary expands
    through dict_gather (the port's read path gathers numeric dictionaries
    itself, so its chunks arrive with values);
  * the unsigned view, its sub-width mask and the widening to 64 bits are
    folded into masked_agg's load: no widened copy is written.

Each aggregate costs one host sync: its value and its live count come back
together.

The engagement envelope is the reference's, narrow and typed: global (no
group_by) count/sum/min/max over flat integer leaves (signed and unsigned,
compared and summed in their bit-pattern view domain), count over anything
flat. Everything else (group_by, float sums, decimal and temporal logical
domains, repeated columns, columns with no device value form) raises
DeviceQueryError. Integer sums wrap in 64-bit two's complement exactly like
pyarrow's unchecked int64/uint64 kernels, min/max over zero matching rows is
None, count skips nulls.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.assembly import logical_kind
from ..core.filter import normalize_dnf
from ..core.filter_vec import VecFilterError
from ..core.reader import resolve_device
from ..core.stats import column_is_unsigned
from ..kernels.device_ops import dict_gather, mask_take_rows, mask_take_scan, masked_agg
from ..kernels.pipeline import to_device
from ..meta.parquet_types import Type

__all__ = ["DeviceQueryError", "device_unit_partial"]

_M64 = (1 << 64) - 1


class DeviceQueryError(Exception):
    """This unit's query shape cannot run device-resident (group_by,
    non-integer aggregate domain, undeliverable column, a filter the whole
    engine ladder declined)."""


def _require(cond: bool, why: str) -> None:
    if not cond:
        raise DeviceQueryError(f"query_device: {why}")


def _agg_leaf(schema, name: str):
    try:
        leaf = schema.column(tuple(name.split(".")))
    except Exception as e:
        raise DeviceQueryError(f"query_device: column {name!r}: {e}") from None
    _require(leaf.is_leaf, f"column {name!r} is not a leaf")
    _require(leaf.max_rep == 0, f"column {name!r} is repeated")
    return leaf


def _int_domain(leaf):
    """(unsigned, bits) engagement check for sum/min/max: plain signed or
    unsigned integers only. `bits` is the sub-width the unsigned view masks
    to (core/filter_device._device_numeric_view's rule), None for none."""
    _require(
        leaf.type in (Type.INT32, Type.INT64),
        f"column {leaf.path_str}: non-integer physical type",
    )
    unsigned = column_is_unsigned(leaf)
    kind = logical_kind(leaf)
    if not unsigned:
        _require(kind is None, f"column {leaf.path_str}: logical domain needs pyarrow semantics")
        return False, None
    bits = kind[1] if isinstance(kind, tuple) and kind[0] == "uint" else None
    return True, bits


def _dense_values(dc, leaf, dev):
    """The chunk's dense values as a resident tensor (a chunk delivered as
    indices + a numeric host dictionary expands with one small upload and
    dict_gather)."""
    if dc.values is not None:
        _require(dc.values.dim() == 1, f"column {leaf.path_str}: no 1-D device value form")
        return dc.values
    if dc.indices is not None and dc.dictionary is not None:
        d = dc.dictionary
        if isinstance(d, np.ndarray) and d.ndim == 1 and d.dtype in (np.int32, np.int64):
            return dict_gather(to_device(d, dev), dc.indices)
    raise DeviceQueryError(f"query_device: column {leaf.path_str}: no device value form")


def _validity(dc, leaf):
    """Host bool[num_rows] validity (None = all valid)."""
    if leaf.max_def > 0 and dc.def_levels is not None:
        v = np.asarray(dc.def_levels) == leaf.max_def
        if not v.all():
            return v
    return None


def _as_int(v: int, unsigned: bool) -> int:
    """A 64-bit result pattern as the Python int of its domain."""
    return v & _M64 if unsigned else v


def device_unit_partial(reader, row_group: int, query, filters, device=None):
    """One unit's ((groups, types), scanned, matched) partial, computed on
    the device (`device`, or the reader's). Types are "int64" / "uint64"
    tags (the merge domain of serve/aggregate._merge_value). Raises
    DeviceQueryError when the query shape is outside the device envelope."""
    _require(not query.group_by, "group_by needs a hash groupby")
    schema = reader.schema
    aggs = query.aggregates
    plans = []  # (op, leaf | None, unsigned, bits)
    paths: list = []
    for a in aggs:
        if a.column is None:
            plans.append(("count*", None, False, None))
            continue
        leaf = _agg_leaf(schema, a.column)
        _require(a.op in ("count", "sum", "min", "max"), f"unsupported op {a.op!r}")
        unsigned, bits = (False, None) if a.op == "count" else _int_domain(leaf)
        plans.append((a.op, leaf, unsigned, bits))
        if leaf.path not in paths:
            paths.append(leaf.path)

    normalized = None
    if filters is not None:
        normalized = normalize_dnf(schema, filters)
        for conj in normalized:
            for e in conj:
                if e[0] not in paths:
                    paths.append(e[0])

    dev = reader.device if device is None else resolve_device(device)
    n = int(reader.row_group(row_group).num_rows or 0)
    group = reader.read_row_group_device(row_group, paths or None, device=dev)

    mask = None
    matched = n
    if normalized is not None:
        # the reference's host path filters with pyarrow null conventions,
        # so the resident mask uses the same "arrow" mode
        try:
            mask = reader._device_group_mask(
                row_group, group, normalized, n, dev, null_mode="arrow"
            )
        except VecFilterError as e:
            raise DeviceQueryError(f"query_device: {e}") from None
        matched = int(masked_agg(mask, mask, "count"))

    valid_dev: dict = {}  # path -> (validity on the device, aligned row mask)

    def aligned(path, valid):
        """(validity tensor, the row mask at the valid rows), once a column."""
        if path not in valid_dev:
            vd = to_device(valid, dev)
            dm = None
            if mask is not None:
                nd = int(valid.sum())
                src, count = mask_take_scan(vd, nd)
                dm = mask_take_rows(mask, src, count, nd)
            valid_dev[path] = (vd, dm)
        return valid_dev[path]

    vals: list = []
    types: list = [None] * len(aggs)
    for j, (op, leaf, unsigned, bits) in enumerate(plans):
        if op == "count*":
            vals.append(matched)
            continue
        dc = group.get(leaf.path)
        _require(dc is not None, f"column {leaf.path_str} not delivered")
        valid = _validity(dc, leaf)
        if op == "count":
            # count skips nulls: |mask & valid| with no value math at all
            if valid is None:
                cnt = matched if mask is not None else int(dc.num_values)
            elif mask is None:
                cnt = int(valid.sum())
            else:
                vd, _dm = aligned(leaf.path, valid)
                cnt = int(masked_agg(mask, mask & vd, "count"))
            vals.append(cnt)
            continue
        dense = _dense_values(dc, leaf, dev)
        nd = int(valid.sum()) if valid is not None else n
        _require(dense.shape[0] == nd, f"column {leaf.path_str}: dense length mismatch")
        if mask is None:
            dm = None
        elif valid is None:
            dm = mask
        else:
            dm = aligned(leaf.path, valid)[1]
        r = masked_agg(dense, dm, op, unsigned=unsigned, bits=bits)
        if dm is None:
            live, value = nd, int(r)
        else:
            # one sync for both: the live count gates the value
            live, value = torch.stack(
                [masked_agg(dense, dm, "count"), r.to(torch.int64)]
            ).tolist()
        if live == 0:
            # pyarrow's sum/min/max over zero non-null matching values is null
            vals.append(None)
            continue
        vals.append(_as_int(value, unsigned))
        types[j] = "uint64" if unsigned else "int64"
    return ({(): vals}, types), n, matched
