"""Block compression registry.

Pluggable codec registry mirroring the reference's BlockCompressor model
(reference: compress.go:16-157). Decompressed output is validated against the
expected size before use (reference: compress.go:102-123). Built in:
UNCOMPRESSED and GZIP from the standard library, and SNAPPY, LZ4_RAW and the
legacy LZ4 codec (Hadoop framing on write; framed or bare raw blocks on
read, parquet-cpp's contract) over the port's host library
(utils/native.py, built on first use). ZSTD, BROTLI and LZO raise the typed
"codec not registered" CompressionError unless the caller registers an
implementation with register_codec.
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


class _Codec:
    name = "?"

    def compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, data: bytes, uncompressed_size: int) -> bytes:
        raise NotImplementedError


class _Uncompressed(_Codec):
    name = "UNCOMPRESSED"

    def compress(self, data):
        return bytes(data)

    def decompress(self, data, uncompressed_size):
        return bytes(data)


class _Gzip(_Codec):
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


def _native():
    """The host library, resolved at first use (never at import)."""
    from ..utils.native import get_native

    return get_native()


class _NativeSnappy(_Codec):
    name = "SNAPPY"

    def compress(self, data):
        return _native().snappy_compress(data)

    def decompress(self, data, uncompressed_size):
        return _native().snappy_decompress(data, uncompressed_size)


class _NativeLz4Raw(_Codec):
    """LZ4_RAW (codec 7): one raw LZ4 block per page."""

    name = "LZ4_RAW"

    def compress(self, data):
        return _native().lz4_compress(bytes(data))

    def decompress(self, data, uncompressed_size):
        return _native().lz4_decompress(data, uncompressed_size)


class _Lz4Hadoop(_Codec):
    """Legacy LZ4 (codec 5): Hadoop framing on disk, repeated
    [4B BE uncompressed size][4B BE compressed size][raw block], with a
    bare-raw-block fallback on read (parquet-cpp's contract; pyarrow and
    parquet-mr both write the framed form)."""

    name = "LZ4"

    def __init__(self, raw: _Codec):
        self._raw = raw

    # Hadoop's BlockCompressorStream splits writes at the codec buffer size
    # (256 KiB by default): larger pages emit several [sizes][block] frames
    _BLOCK = 256 << 10

    def compress(self, data):
        import struct

        data = bytes(data)
        out = bytearray()
        for lo in range(0, max(len(data), 1), self._BLOCK):
            piece = data[lo : lo + self._BLOCK]
            block = self._raw.compress(piece)
            out += struct.pack(">II", len(piece), len(block)) + block
        return bytes(out)

    def decompress(self, data, uncompressed_size):
        return _native().lz4_decompress(data, uncompressed_size, hadoop=True)


_REGISTRY: dict = {
    int(CompressionCodec.UNCOMPRESSED): _Uncompressed(),
    int(CompressionCodec.GZIP): _Gzip(),
    int(CompressionCodec.SNAPPY): _NativeSnappy(),
    int(CompressionCodec.LZ4_RAW): _NativeLz4Raw(),
}
_REGISTRY[int(CompressionCodec.LZ4)] = _Lz4Hadoop(_REGISTRY[int(CompressionCodec.LZ4_RAW)])


def register_codec(codec: CompressionCodec, impl) -> None:
    """Register/override a codec implementation (objects with .compress(bytes)
    and .decompress(bytes, uncompressed_size))."""
    _REGISTRY[int(codec)] = impl


def codec_supported(codec: CompressionCodec) -> bool:
    return int(codec) in _REGISTRY


def is_builtin_codec(codec) -> bool:
    """True while `codec` still resolves to a stock implementation: the
    native whole-chunk walk inlines UNCOMPRESSED, SNAPPY, GZIP, LZ4 and
    LZ4_RAW and must stand down when register_codec has overridden one."""
    impl = _REGISTRY.get(int(codec))
    return isinstance(impl, (_Uncompressed, _Gzip, _NativeSnappy, _NativeLz4Raw, _Lz4Hadoop))


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
