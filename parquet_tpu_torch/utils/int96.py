"""INT96 legacy timestamp helpers.

A copy of parquet_tpu/utils/int96.py. Equivalent of the reference's
int96_time.go (:17-28 julian-day math, :33-49 Int96ToTime/TimeToInt96,
:54-56 IsAfterUnixEpoch): INT96 stores nanoseconds since midnight in the low
8 bytes (LE) and the Julian day number in the high 4 bytes (LE) — the legacy
Impala/Hive timestamp encoding.
"""

from __future__ import annotations

import datetime as dt

import numpy as np

__all__ = [
    "int96_to_datetime",
    "datetime_to_int96",
    "int96_to_unix_nanos",
    "is_after_unix_epoch",
    "JULIAN_UNIX_EPOCH",
]

# Julian day number of 1970-01-01.
JULIAN_UNIX_EPOCH = 2_440_588

_EPOCH = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)


def int96_to_unix_nanos(raw) -> int:
    """12 bytes -> nanoseconds since the unix epoch (can be negative)."""
    b = bytes(raw)
    if len(b) != 12:
        raise ValueError(f"int96: need 12 bytes, got {len(b)}")
    nanos = int.from_bytes(b[:8], "little")
    jday = int.from_bytes(b[8:], "little")
    return (jday - JULIAN_UNIX_EPOCH) * 86_400_000_000_000 + nanos


def int96_to_datetime(raw) -> dt.datetime:
    nanos = int96_to_unix_nanos(raw)
    # Python datetimes hold microseconds; sub-microsecond precision truncates.
    return _EPOCH + dt.timedelta(microseconds=nanos // 1000)


def datetime_to_int96(value: dt.datetime) -> bytes:
    if value.tzinfo is None:
        value = value.replace(tzinfo=dt.timezone.utc)
    delta = value - _EPOCH
    total_micros = (delta.days * 86_400_000_000) + delta.seconds * 1_000_000 + delta.microseconds
    days, rem = divmod(total_micros, 86_400_000_000)
    nanos = rem * 1000
    jday = days + JULIAN_UNIX_EPOCH
    return nanos.to_bytes(8, "little") + jday.to_bytes(4, "little")


def is_after_unix_epoch(raw) -> bool:
    """True if the timestamp is after 1970-01-01T00:00:00Z
    (reference: int96_time.go:54-56)."""
    return int96_to_unix_nanos(raw) > 0


def int96_array_to_unix_nanos(arr: np.ndarray) -> np.ndarray:
    """Vectorized (n, 12) uint8 -> int64 unix nanoseconds."""
    a = np.asarray(arr, dtype=np.uint8)
    if a.ndim != 2 or a.shape[1] != 12:
        raise ValueError("int96: expected (n, 12) uint8 array")
    nanos = a[:, :8].copy().view("<u8").reshape(-1).astype(np.int64)
    jday = a[:, 8:].copy().view("<u4").reshape(-1).astype(np.int64)
    return (jday - JULIAN_UNIX_EPOCH) * 86_400_000_000_000 + nanos
