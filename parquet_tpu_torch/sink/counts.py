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
the reference's metric families of those names are."""

from __future__ import annotations

import threading

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
_COUNTS = dict.fromkeys(_BASE_COUNTS, 0)
_COUNTS_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add n to the write count `name`."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def write_counts() -> dict:
    """A snapshot of every write count (see the module docstring)."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_write_counts() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()
        _COUNTS.update(dict.fromkeys(_BASE_COUNTS, 0))


_SINK_COUNTS: dict = {}


def count_sink(name: str, n: int = 1) -> None:
    """Add n to the sink count `name`."""
    with _COUNTS_LOCK:
        _SINK_COUNTS[name] = _SINK_COUNTS.get(name, 0) + n


def sink_counts() -> dict:
    """A snapshot of the sinks' byte and call counts."""
    with _COUNTS_LOCK:
        return dict(_SINK_COUNTS)


def reset_sink_counts() -> None:
    with _COUNTS_LOCK:
        _SINK_COUNTS.clear()
