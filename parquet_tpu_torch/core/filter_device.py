"""Device-resident residual filtering: normalized DNF -> device row mask.

A port of parquet_tpu/core/filter_device.py. The device twin of
core/filter_vec.dnf_mask: the same (already normalized) DNF evaluates over
one row group's device-delivered columns ({leaf path:
kernels.pipeline.DeviceColumn}) and yields a torch.bool row mask that never
leaves the card. It feeds kernels.device_ops.mask_take for the compaction
(predicate -> mask -> gather).

Every device operation of a leaf runs in one of the filter kernels of
kernels/device_ops.py:

  * predicate_mask compares a chunk's resident dense values against the
    filter value's (stat_lo, stat_hi) bracket in the PHYSICAL storage
    domain (lo == hi: exactly representable; lo != hi: the value falls
    BETWEEN stored values, so equality is impossible and ordered ops use
    the exact end), unsigned logical types as unsigned bit patterns, an
    in-list as one launch over its members (not_in negated in the kernel),
    FIXED_LEN_BYTE_ARRAY rows against one byte pattern or the members';
  * a dictionary-preserved chunk (byte arrays) compares its small HOST
    dictionary once with the host engine's own comparators
    (filter_vec._raw_compare / _member_mask), and leaf_verdict gathers that
    verdict through the resident indices;
  * leaf_verdict also lifts a nullable column's dense verdict to rows
    through the validity scan, with both null conventions: "row" (a null
    fails every value op) and "arrow" (not_in keeps nulls);
  * list_contains_mask lifts a LIST leaf's element hits to rows through its
    level streams (uploaded once per column, DeviceColumn.level_tensors).

Validity masks are built on the host from the level streams DeviceColumn
carries and uploaded once per referenced leaf. The DNF's AND / OR between
leaf masks are torch bitwise ops on bool tensors.

Anything outside that envelope — non-dictionary byte arrays (no device
value ordering), out-of-range brackets, unorderable physical domains —
raises the typed DeviceFilterError, and the CALLER takes the host engine
(counted, never silent): exactness always wins over residency. A CUDA
error is not a decline: it propagates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.device_ops import MAX_MEMBERS, leaf_verdict, list_contains_mask, predicate_mask
from ..kernels.pipeline import DEF_SATURATED, to_device
from ..meta.parquet_types import Type
from .assembly import logical_kind
from .filter import FilterError
from .filter_vec import VecFilterError, _member_mask, _raw_compare
from .stats import column_is_unsigned

__all__ = ["DeviceFilterError", "device_dnf_mask"]

class DeviceFilterError(FilterError):
    """The device mask pipeline cannot evaluate this predicate over these
    device-delivered columns (no device value form, uncovered shape,
    out-of-range bracket). Callers fall back to the host vec engine, which
    is exact for everything it covers; same contract as
    filter_vec.VecFilterError one rung down the ladder."""


def device_dnf_mask(group: dict, dnf, n_rows: int, *, null_mode: str = "row", device=None):
    """bool[n_rows] DEVICE row mask of a normalized DNF over one row group's
    device-delivered columns ({leaf path: DeviceColumn}), on `device` (by
    default the device the columns lie on). Raises DeviceFilterError when
    any referenced predicate cannot run on the device — all or nothing, so
    engines never mix within one group."""
    if null_mode not in ("row", "arrow"):
        raise ValueError('null_mode must be "row" or "arrow"')
    if device is None:
        device = next((dc.device for dc in group.values() if dc.device is not None), None)
    if device is None:
        raise DeviceFilterError("filter_device: no device-delivered column")
    ctx: dict = {"device": torch.device(device)}
    out = None
    for conj in dnf:
        m = None
        for entry in conj:
            lm = _leaf_mask(group, entry, n_rows, null_mode, ctx)
            m = lm if m is None else (m & lm)
        if m is None:  # empty conjunction is vacuously true
            return torch.ones(n_rows, dtype=torch.bool, device=ctx["device"])
        out = m if out is None else (out | m)
    if out is None:
        return torch.ones(n_rows, dtype=torch.bool, device=ctx["device"])
    return out


# -- per-leaf masks -------------------------------------------------------------


def _leaf_mask(group, entry, n_rows, null_mode, ctx):
    path, leaf, op, value, vlo, vhi = entry
    dc = group.get(path)
    if dc is None:
        raise DeviceFilterError(
            f"filter_device: column {'.'.join(path)} not delivered on device"
        )
    dev = ctx["device"]
    if op == "contains":
        return _contains_mask(dc, leaf, vlo, vhi, n_rows, (path, ctx))
    if leaf.max_rep != 0:
        raise DeviceFilterError(f"filter_device: {'.'.join(path)} is repeated")
    if dc.num_values != n_rows:
        raise DeviceFilterError(
            f"filter_device: {'.'.join(path)}: {dc.num_values} level entries "
            f"for {n_rows} rows"
        )
    valid = None
    if leaf.max_def > 0 and dc.def_levels is not None:
        v = np.asarray(dc.def_levels) == leaf.max_def
        if not v.all():
            valid = v
    if op == "is_null":
        if valid is None:
            return torch.zeros(n_rows, dtype=torch.bool, device=dev)
        return to_device(~valid, dev)
    if op == "not_null":
        if valid is None:
            return torch.ones(n_rows, dtype=torch.bool, device=dev)
        return _valid_upload(valid, ctx, path)
    if op in ("in", "not_in") and null_mode == "arrow":
        # same decline as filter_vec._leaf_mask: pyarrow's is_in CASTS the
        # value set to float32, diverging from exact semantics — the host
        # engine decides
        if leaf.type == Type.FLOAT and isinstance(vlo, list) and any(
            lo is not None
            and isinstance(lo, float)
            and float(np.float32(lo)) != lo
            for lo, _ in vlo
        ):
            raise DeviceFilterError(
                f"filter_device: {leaf.path_str}: in-list member inexact in "
                "float32 (pyarrow is_in casts the value set)"
            )
    verdict, indices = _dense_compare(dc, leaf, op, vlo, vhi, (path, ctx))
    nd = int(valid.sum()) if valid is not None else n_rows
    n_dense = indices.numel() if indices is not None else verdict.numel()
    if n_dense != nd:
        raise DeviceFilterError(
            f"filter_device: {'.'.join(path)}: {n_dense} dense values "
            f"for {nd} defined cells"
        )
    if valid is None:
        return verdict if indices is None else leaf_verdict(verdict, indices)
    # pyarrow's pc.invert(pc.is_in(...)) maps null to True: nulls KEPT
    keep_nulls = op == "not_in" and null_mode == "arrow"
    return leaf_verdict(verdict, indices, _valid_upload(valid, ctx, path), keep_nulls)


def _valid_upload(valid_np, ctx, path):
    """One leaf's validity on the device: uploaded once per path, shared by
    every predicate of the DNF that references the column."""
    key = ("valid", path)
    hit = ctx.get(key)
    if hit is None:
        hit = ctx[key] = to_device(valid_np, ctx["device"])
    return hit


def _contains_mask(dc, leaf, vlo, vhi, n_rows, ckey):
    """List-slot membership on the device: the dense element equality mask
    lifts through the level streams to rows (list_contains_mask, the kernel
    twin of filter_vec._contains_mask)."""
    if dc.rep_levels is None:
        raise DeviceFilterError(
            f"filter_device: {leaf.path_str}: contains without repetition levels"
        )
    rl = np.asarray(dc.rep_levels)
    if len(rl) == 0:
        return torch.zeros(n_rows, dtype=torch.bool, device=ckey[1]["device"])
    if int(rl[0]) != 0:
        raise DeviceFilterError(
            f"filter_device: {leaf.path_str}: stream opens mid-record"
        )
    if int((rl == 0).sum()) != n_rows:
        raise DeviceFilterError(
            f"filter_device: {leaf.path_str}: record count != row count"
        )
    if dc.def_levels is not None:
        nd = int((np.asarray(dc.def_levels) == leaf.max_def).sum())
        elem_def = leaf.max_def
    else:
        nd = len(rl)
        elem_def = DEF_SATURATED  # the device def stream of a column without one
    verdict, indices = _dense_compare(dc, leaf, "==", vlo, vhi, ckey)
    dm = verdict if indices is None else leaf_verdict(verdict, indices)
    if dm.numel() != nd:
        raise DeviceFilterError(
            f"filter_device: {leaf.path_str}: level/value mismatch"
        )
    rep, dfl = dc.level_tensors()
    rows, _n = list_contains_mask(rep, dfl, dm, elem_def)
    return rows[:n_rows]


# -- dense value comparison -----------------------------------------------------


def _dense_compare(dc, leaf, op, vlo, vhi, ckey):
    """The verdict of one value op over the chunk's dense (non-null) values,
    as (verdict, indices): a bool device mask over the dense values
    (indices None), or, for a dictionary-preserved chunk, the host
    dictionary's verdict uploaded as uint8 with the resident int32 indices
    to gather it through."""
    if vlo is None:
        raise DeviceFilterError(
            f"filter_device: {leaf.path_str}: no orderable physical form"
        )
    via_dict = dc.values is None and dc.indices is not None and dc.dictionary is not None
    if not via_dict and dc.values is None:
        raise DeviceFilterError(
            f"filter_device: {leaf.path_str}: no device value form "
            "(raw byte arrays have no resident ordering)"
        )
    if op in ("in", "not_in"):
        if any(lo is None for lo, _ in vlo):
            raise DeviceFilterError(
                f"filter_device: {leaf.path_str}: unorderable in-list member"
            )
        if len(vlo) > MAX_MEMBERS:
            # one launch compares against at most MAX_MEMBERS members
            raise DeviceFilterError(
                f"filter_device: {leaf.path_str}: in-list of {len(vlo)} "
                f"members (> {MAX_MEMBERS}) takes the host engine"
            )
        if via_dict:
            # an inexact bracket can equal no stored value: exact members only
            exact = [lo for lo, hi in vlo if lo == hi]
            m = _host(lambda: _member_mask(dc.dictionary, leaf, exact, ckey))
            return _upload_verdict(~m if op == "not_in" else m, ckey), dc.indices
        return _device_members(dc.values, leaf, op, vlo), None
    if via_dict:
        dcmp = _host(lambda: _raw_compare(dc.dictionary, leaf, op, vlo, vhi, ckey))
        return _upload_verdict(dcmp, ckey), dc.indices
    return _device_compare(dc.values, leaf, op, vlo, vhi), None


def _host(fn):
    """A host-engine comparator whose decline is the device engine's."""
    try:
        return fn()
    except VecFilterError as e:
        raise DeviceFilterError(str(e)) from None


def _upload_verdict(verdict_np, ckey):
    return to_device(np.asarray(verdict_np, dtype=bool).view(np.uint8), ckey[1]["device"])


def _device_members(values, leaf, op, brackets):
    """An in-list over resident values in one launch against the exact
    members (an inexact bracket can equal no stored value, as in the host
    engine's exact-members-only isin)."""
    if values.dim() == 2:
        # FLBA rows against every member's byte pattern
        return predicate_mask(values, op, members=[bytes(lo) for lo, _ in brackets])
    unsigned, bits = _unsigned_view(values, leaf)
    members = [lo for lo, hi in brackets if lo == hi]
    return _declining(leaf, lambda: predicate_mask(
        values, op, members=members, unsigned=unsigned, bits=bits))


def _device_compare(values, leaf, op, vlo, vhi):
    """predicate_mask over resident values. The wrapper coerces the bracket
    to the values' dtype on the host (float32 rounding; booleans compare as
    int8); a bracket it refuses (outside the dtype's range, not an integer
    on an integer column) or a dtype it does not take declines instead of
    wrapping."""
    if values.dim() == 2:
        return _fixed_compare(values, op, vlo)
    unsigned, bits = _unsigned_view(values, leaf)
    return _declining(leaf, lambda: predicate_mask(
        values, op, vlo, vhi, bool(vlo == vhi), unsigned=unsigned, bits=bits))


def _declining(leaf, launch):
    """A kernel wrapper's refusal of its inputs (ValueError, TypeError) is
    the device engine's typed decline; anything else propagates."""
    try:
        return launch()
    except (ValueError, TypeError) as e:
        raise DeviceFilterError(f"filter_device: {leaf.path_str}: {e}") from None


def _unsigned_view(values, leaf):
    """(unsigned, bits): whether the resident int32/int64 values are bit
    patterns of an unsigned logical type, and its logical width (None: the
    stored width)."""
    if not (column_is_unsigned(leaf) and values.dtype in (torch.int32, torch.int64)):
        return False, None
    kind = logical_kind(leaf)
    return True, (kind[1] if isinstance(kind, tuple) and kind[0] == "uint" else None)


def _fixed_compare(values, op, value):
    """FIXED_LEN_BYTE_ARRAY rows ((n, width) uint8) on the device: equality
    family only, exactly like filter_vec._fixed_compare."""
    if op not in ("==", "!="):
        raise DeviceFilterError(
            "filter_device: ordered comparison on fixed-width bytes"
        )
    return predicate_mask(values, op, bytes(value))
