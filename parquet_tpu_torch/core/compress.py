"""Block compression registry (UNCOMPRESSED and GZIP built in).

Pluggable codec registry mirroring the reference's BlockCompressor model
(reference: compress.go:16-157). Decompressed output is validated against the
expected size before use (reference: compress.go:102-123). Only the two
codecs the standard library carries are built in; every other codec raises
the typed "codec not registered" CompressionError unless the caller
registers an implementation with register_codec.
"""

from __future__ import annotations

import zlib

from ..meta.file_meta import ParquetFileError
from ..meta.parquet_types import CompressionCodec

__all__ = [
    "compress_block",
    "decompress_block",
    "register_codec",
    "codec_supported",
    "CompressionError",
]


class CompressionError(ParquetFileError):
    """Corrupt or unsupported compressed block. A ParquetFileError so the
    API boundary's documented catch-all covers codec-level corruption the
    same as every other malformed-file path."""


class _Uncompressed:
    name = "UNCOMPRESSED"

    def compress(self, data):
        return bytes(data)

    def decompress(self, data, uncompressed_size):
        return bytes(data)


class _Gzip:
    name = "GZIP"

    def compress(self, data):
        c = zlib.compressobj(wbits=31)  # gzip container
        return c.compress(data) + c.flush()

    def decompress(self, data, uncompressed_size):
        # wbits=47: auto-detect gzip or zlib headers. Decompression stops at
        # the advertised size: a bomb that inflates past it raises without
        # ever materializing the excess (validation-before-allocation).
        # d.eof also guards integrity: it only turns true once the stream's
        # trailer (gzip CRC32/ISIZE) has been read and verified.
        d = zlib.decompressobj(wbits=47)
        out = d.decompress(bytes(data), max(uncompressed_size, 1))
        if d.unconsumed_tail or not d.eof:
            raise CompressionError(
                "gzip stream truncated or inflates past advertised size "
                f"{uncompressed_size}"
            )
        return out


_REGISTRY: dict = {
    int(CompressionCodec.UNCOMPRESSED): _Uncompressed(),
    int(CompressionCodec.GZIP): _Gzip(),
}


def register_codec(codec: CompressionCodec, impl) -> None:
    """Register/override a codec implementation (objects with .compress(bytes)
    and .decompress(bytes, uncompressed_size))."""
    _REGISTRY[int(codec)] = impl


def codec_supported(codec: CompressionCodec) -> bool:
    return int(codec) in _REGISTRY


def _get(codec):
    impl = _REGISTRY.get(int(codec))
    if impl is None:
        try:
            name = CompressionCodec(codec).name
        except ValueError:
            name = str(codec)
        raise CompressionError(
            f"compression codec {name} not registered "
            "(use parquet_tpu_torch.core.compress.register_codec)"
        )
    return impl


def compress_block(data: bytes, codec) -> bytes:
    return _get(codec).compress(data)


def decompress_block(data: bytes, codec, uncompressed_size: int) -> bytes:
    """Decompress and validate the advertised uncompressed size
    (reference: compress.go:107-120)."""
    if uncompressed_size < 0:
        raise CompressionError(f"invalid uncompressed size {uncompressed_size}")
    impl = _get(codec)
    try:
        out = impl.decompress(data, uncompressed_size)
    except CompressionError:
        raise
    except Exception as e:
        raise CompressionError(f"decompression failed: {e}") from e
    if len(out) != uncompressed_size:
        raise CompressionError(
            f"decompressed size {len(out)} != advertised {uncompressed_size}"
        )
    return out
