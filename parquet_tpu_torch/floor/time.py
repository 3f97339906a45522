"""Nanosecond-precision time-of-day for the TIME logical type.

datetime.time caps at microseconds, which silently truncates TIME(NANOS)
columns; this type keeps the full nanos-since-midnight value plus the
isAdjustedToUTC flag, the same information the reference's floor.Time
carries (reference: floor/time.go:10-13, ctors :26-45, converters :92-105).

A copy of parquet_tpu/floor/time.py. The read path (core/assembly.py
convert_logical) returns Time for TIME(NANOS) columns and datetime.time for
MILLIS/MICROS, where no precision exists to lose; core/filter.py lifts TIME
filter values with sub-microsecond digits into it.
"""

from __future__ import annotations

import datetime as dt
import functools

__all__ = ["Time", "NANOS_PER_DAY"]

NANOS_PER_DAY = 24 * 3600 * 1_000_000_000


@functools.total_ordering
class Time:
    """Time of day as nanoseconds since midnight, with a UTC flag."""

    __slots__ = ("nanos", "utc")

    def __init__(self, hour=0, minute=0, second=0, nanosecond=0, *, utc=True):
        nanos = ((hour * 60 + minute) * 60 + second) * 1_000_000_000 + nanosecond
        if not 0 <= nanos < NANOS_PER_DAY:
            raise ValueError(f"Time: {nanos} ns outside a day")
        self.nanos = nanos
        self.utc = bool(utc)

    @classmethod
    def from_nanos(cls, nanos: int, *, utc: bool = True) -> "Time":
        t = cls.__new__(cls)
        if not 0 <= nanos < NANOS_PER_DAY:
            raise ValueError(f"Time: {nanos} ns outside a day")
        t.nanos = int(nanos)
        t.utc = bool(utc)
        return t

    @classmethod
    def from_time(cls, t: dt.time, *, utc: bool | None = None) -> "Time":
        if utc is None:
            utc = t.tzinfo is not None
        return cls(t.hour, t.minute, t.second, t.microsecond * 1000, utc=utc)

    # -- components ------------------------------------------------------------

    @property
    def hour(self) -> int:
        return self.nanos // 3_600_000_000_000

    @property
    def minute(self) -> int:
        return (self.nanos // 60_000_000_000) % 60

    @property
    def second(self) -> int:
        return (self.nanos // 1_000_000_000) % 60

    @property
    def nanosecond(self) -> int:
        return self.nanos % 1_000_000_000

    # -- conversions -----------------------------------------------------------

    def to_time(self) -> dt.time:
        """datetime.time equivalent; sub-microsecond digits are truncated."""
        return dt.time(
            self.hour,
            self.minute,
            self.second,
            self.nanosecond // 1000,
            tzinfo=dt.timezone.utc if self.utc else None,
        )

    def isoformat(self) -> str:
        ns = self.nanosecond
        frac = f".{ns:09d}".rstrip("0").rstrip(".") if ns else ""
        return f"{self.hour:02d}:{self.minute:02d}:{self.second:02d}{frac}"

    # -- dunder ----------------------------------------------------------------

    def __repr__(self):
        return f"Time({self.isoformat()!r}, utc={self.utc})"

    def __eq__(self, other):
        if isinstance(other, Time):
            return self.nanos == other.nanos and self.utc == other.utc
        return NotImplemented

    def __lt__(self, other):
        if isinstance(other, Time):
            return self.nanos < other.nanos
        return NotImplemented

    def __hash__(self):
        return hash((self.nanos, self.utc))
