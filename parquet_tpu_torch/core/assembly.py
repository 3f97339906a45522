"""Logical-type dispatch of a leaf column.

A copy of parquet_tpu/core/assembly.py cut to `logical_kind`, which
core/filter.py consults to coerce a filter value into the column's physical
domain. Record assembly and the value conversions (`convert_logical`) wait
for the slice that assembles rows on the host.
"""

from __future__ import annotations

from ..meta.parquet_types import ConvertedType, Type
from .schema import Column

__all__ = ["logical_kind"]


def logical_kind(node: Column):
    """The single dispatch point for value-level logical conversions.

    Returns one of None | 'int96' | 'decimal' | 'date' | ('timestamp', unit,
    utc) | ('time', unit, utc) | ('uint', bits).
    """
    ct = node.converted_type
    lt = node.logical_type
    if node.type == Type.INT96:
        return "int96"
    if lt is not None and lt.INTEGER is not None and not lt.INTEGER.isSigned:
        if node.type == Type.INT32:
            return ("uint", 32)
        if node.type == Type.INT64:
            return ("uint", 64)
    if ct in (ConvertedType.UINT_32, ConvertedType.UINT_64):
        return ("uint", 32 if node.type == Type.INT32 else 64)
    if ct == ConvertedType.DECIMAL or (lt is not None and lt.DECIMAL is not None):
        return "decimal"
    if ct == ConvertedType.DATE or (lt is not None and lt.DATE is not None):
        return "date"
    if lt is not None and lt.TIMESTAMP is not None:
        u = lt.TIMESTAMP.unit
        return ("timestamp", u.unit_name() if u is not None else "MICROS",
                bool(lt.TIMESTAMP.isAdjustedToUTC))
    if ct == ConvertedType.TIMESTAMP_MILLIS:
        return ("timestamp", "MILLIS", True)
    if ct == ConvertedType.TIMESTAMP_MICROS:
        return ("timestamp", "MICROS", True)
    if lt is not None and lt.TIME is not None:
        u = lt.TIME.unit
        return ("time", u.unit_name() if u is not None else "MICROS",
                bool(lt.TIME.isAdjustedToUTC))
    if ct == ConvertedType.TIME_MILLIS:
        return ("time", "MILLIS", True)
    if ct == ConvertedType.TIME_MICROS:
        return ("time", "MICROS", True)
    return None
