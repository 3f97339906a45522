"""Byte sinks and the chunk encoder of the write path."""

from .sink import ByteSink, FileObjectSink, LocalFileSink, MemorySink, SinkError, open_sink

__all__ = [
    "ByteSink",
    "FileObjectSink",
    "LocalFileSink",
    "MemorySink",
    "SinkError",
    "open_sink",
]
