"""Carry state between the JAX package and the port, as plain NumPy.

The "parameters" of the decode path are the host prescan tables and the
frozen upload buffers; both packages hold them as NumPy arrays. These
helpers let a test feed one upload buffer to both packages' kernels,
compare the two packages' DeviceColumns field by field, and flatten either
package's device batches to NumPy. Nothing here imports the JAX package:
the JAX side passes `frozen._asdict()`, and its arrays convert through
`np.asarray`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.device_ops import delta_packed_decode, expand_hybrid
from ..kernels.pipeline import DeviceColumn, to_device

__all__ = ["DeviceBatch", "batches_to_numpy", "frozen_from_numpy", "to_numpy"]


class DeviceBatch(NamedTuple):
    """A frozen batch uploaded to a device: the kernel's wrapper and its
    arguments. `run()` launches it (or runs the plain version on the CPU)."""

    kernel: object
    args: tuple

    def run(self) -> torch.Tensor:
        return self.kernel(*self.args)


def frozen_from_numpy(fields: dict, device) -> DeviceBatch:
    """A frozen hybrid batch (fields buf, width, n_pad, run_pad, total) or
    delta batch (meta32, wide, nbits, n_pad, m_pad, p_pad, total), uploaded
    to `device` in the dtypes the port's kernels take."""
    dev = torch.device(device)
    if "buf" in fields:
        buf = np.asarray(fields["buf"], dtype=np.uint32).view(np.int32)
        return DeviceBatch(
            expand_hybrid,
            (to_device(buf, dev), int(fields["width"]), int(fields["run_pad"]),
             int(fields["total"])),
        )
    nbits = int(fields["nbits"])
    meta32 = np.asarray(fields["meta32"], dtype=np.uint32).view(np.int32)
    wide_u = np.uint32 if nbits == 32 else np.uint64
    wide = np.asarray(fields["wide"], dtype=wide_u).view(
        np.int32 if nbits == 32 else np.int64
    )
    return DeviceBatch(
        delta_packed_decode,
        (to_device(meta32, dev), to_device(wide, dev), nbits, int(fields["m_pad"]),
         int(fields["p_pad"]), int(fields["total"])),
    )


_FIELDS = ("values", "indices", "data", "offsets", "dict_data", "dict_offsets")


def to_numpy(col: DeviceColumn) -> dict:
    """A DeviceColumn's fields as NumPy (None stays None); the host
    dictionary and the level arrays pass through."""
    out = {"num_values": col.num_values}
    for name in _FIELDS:
        t = getattr(col, name)
        out[name] = None if t is None else t.detach().cpu().numpy()
    out["dictionary"] = col.dictionary
    out["def_levels"] = col.def_levels
    out["rep_levels"] = col.rep_levels
    return out


def _leaf_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def batches_to_numpy(batch: dict) -> dict:
    """A device batch, {leaf path: array | (values, mask) | (values,
    lengths)}, of either package flattened to NumPy: a plain column maps to
    {path: array}, a MaskedColumn or RaggedColumn (any NamedTuple) to one
    entry per field, {(path, field): array}. Torch tensors and JAX arrays
    both convert."""
    out = {}
    for path, node in batch.items():
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            for field, x in zip(node._fields, node):
                out[(path, field)] = _leaf_numpy(x)
        else:
            out[path] = _leaf_numpy(node)
    return out
