"""Byte sinks, the chunk encoder and the parallel encode pipeline of the
write path."""

from .encoder import (
    EncodedChunk,
    EncodedRowGroup,
    EncodePipeline,
    EncoderConfig,
    assemble_group,
    commit_group,
    encode_chunk,
    encode_pool,
)
from .sink import (
    BufferedSink,
    ByteSink,
    FileObjectSink,
    LocalFileSink,
    MemorySink,
    SinkError,
    open_sink,
)

__all__ = [
    "BufferedSink",
    "ByteSink",
    "EncodePipeline",
    "EncodedChunk",
    "EncodedRowGroup",
    "EncoderConfig",
    "FileObjectSink",
    "LocalFileSink",
    "MemorySink",
    "SinkError",
    "assemble_group",
    "commit_group",
    "encode_chunk",
    "encode_pool",
    "open_sink",
]
