"""The write path's routing counts, shared by the writer and the encode
threads: device_write_engaged / device_write_declined (device columns
encoded on the card or, declined, on the host; FileWriter), and
encode_fused_engaged / encode_fused_declined / encode_fallback_recovered /
encode_fused_fault_<stage> (host chunks through the fused native encode
walk, outside it, or refused by it and recovered by the staged encoder;
sink/encoder.py).

The sinks' own counts live apart, in sink_counts(): sink_bytes_written_total
and sink_write_calls_total, fed by every concrete sink (LocalFileSink,
MemorySink, FileObjectSink, io.remote_sink.HttpSink) and by no wrapper, as
the reference's metric families of those names are.

Both are views of the process registry (utils.metrics): a routing count is
its events_total{event=...} sample, as the reference's trace.bump() keeps
it (and a count of the active decode trace), a sink count its own
family."""

from __future__ import annotations

from ..utils.counters import LabelledCounts, event_alias

__all__ = [
    "count",
    "count_sink",
    "reset_sink_counts",
    "reset_write_counts",
    "sink_counts",
    "write_counts",
]

_BASE_COUNTS = (
    "device_write_engaged",
    "device_write_declined",
    "encode_fused_engaged",
    "encode_fused_declined",
    "encode_fallback_recovered",
)
_COUNTS = LabelledCounts(alias=event_alias())
_SINK_COUNTS = LabelledCounts()


def count(name: str, n: int = 1) -> None:
    """Add n to the write count `name`."""
    _COUNTS.count(name, n)


def write_counts() -> dict:
    """A snapshot of every write count (see the module docstring)."""
    return {**dict.fromkeys(_BASE_COUNTS, 0), **_COUNTS.snapshot()}


def reset_write_counts() -> None:
    _COUNTS.reset()


def count_sink(name: str, n: int = 1) -> None:
    """Add n to the sink count `name`."""
    _SINK_COUNTS.count(name, n)


def sink_counts() -> dict:
    """A snapshot of the sinks' byte and call counts."""
    return _SINK_COUNTS.snapshot()


def reset_sink_counts() -> None:
    _SINK_COUNTS.reset()
