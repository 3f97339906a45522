"""Block compression registry.

Pluggable codec registry mirroring the reference's BlockCompressor model
(reference: compress.go:16-157). Decompressed output is validated against the
expected size before use (reference: compress.go:102-123). Built in:
UNCOMPRESSED and GZIP from the standard library, and SNAPPY, LZ4_RAW and the
legacy LZ4 codec (Hadoop framing on write; framed or bare raw blocks on
read, parquet-cpp's contract) over the port's host library
(utils/native.py, built on first use), and ZSTD over the system's libzstd
(native/zstd.cc, its own small library, built at the first ZSTD use by
kernels/host_build.load_zstd; a host with the runtime library and no
zstd.h builds it too). Where libzstd is missing, ZSTD raises the typed
"codec not registered" CompressionError, naming what is missing; BROTLI
and LZO always do. A codec the caller registers with
register_codec takes precedence over the built-in one.
"""

from __future__ import annotations

import ctypes
import threading
import zlib

from ..meta.file_meta import ParquetFileError
from ..meta.parquet_types import CompressionCodec
from ..utils import metrics as _metrics
from ..utils.trace import add_bytes as _trace_add_bytes

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


class _NativeZstd(_Codec):
    """ZSTD (codec 6) over libzstd (native/zstd.cc): level 3 with the
    content size in the frame, as the reference's zstandard
    ZstdCompressor() writes it. Each pqt-host thread compresses and
    decompresses with its own libzstd context. The library builds at the
    first call; where it cannot, every call raises the typed "not
    registered" CompressionError naming the missing header or library."""

    name = "ZSTD"
    LEVEL = 3  # zstandard.ZstdCompressor()'s default

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()

    def lib(self):
        if self._lib is None:
            from ..kernels.host_build import HostBuildError, load_zstd

            with self._lock:
                try:
                    lib = load_zstd()
                except HostBuildError as e:
                    why = str(e).splitlines()[0]
                    raise CompressionError(
                        f"compression codec ZSTD not registered: {why} "
                        "(use parquet_tpu_torch.core.compress.register_codec)"
                    ) from None
                ll, p = ctypes.c_longlong, ctypes.c_char_p
                lib.ptq_zstd_bound.argtypes = [ll]
                lib.ptq_zstd_bound.restype = ll
                lib.ptq_zstd_compress.argtypes = [p, ll, ctypes.c_void_p, ll, ctypes.c_int]
                lib.ptq_zstd_compress.restype = ll
                lib.ptq_zstd_decompress.argtypes = [p, ll, ctypes.c_void_p, ll]
                lib.ptq_zstd_decompress.restype = ll
                lib.ptq_zstd_error.argtypes = []
                lib.ptq_zstd_error.restype = ctypes.c_char_p
                lib.ptq_zstd_version.argtypes = []
                lib.ptq_zstd_version.restype = ctypes.c_uint
                self._lib = lib
        return self._lib

    def available(self) -> bool:
        try:
            self.lib()
        except CompressionError:
            return False
        return True

    def version(self) -> str:
        v = self.lib().ptq_zstd_version()
        return f"{v // 10000}.{v // 100 % 100}.{v % 100}"

    def compress(self, data):
        lib = self.lib()
        data = bytes(data)
        cap = lib.ptq_zstd_bound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.ptq_zstd_compress(data, len(data), out, cap, self.LEVEL)
        if n < 0:
            raise CompressionError(f"zstd compression failed: {lib.ptq_zstd_error().decode()}")
        return out.raw[:n]

    def decompress(self, data, uncompressed_size):
        lib = self.lib()
        out = ctypes.create_string_buffer(max(uncompressed_size, 1))
        n = lib.ptq_zstd_decompress(bytes(data), len(data), out, uncompressed_size)
        if n < 0:
            raise CompressionError(f"zstd decompression failed: {lib.ptq_zstd_error().decode()}")
        return out.raw[:n]


_REGISTRY: dict = {
    int(CompressionCodec.UNCOMPRESSED): _Uncompressed(),
    int(CompressionCodec.GZIP): _Gzip(),
    int(CompressionCodec.SNAPPY): _NativeSnappy(),
    int(CompressionCodec.LZ4_RAW): _NativeLz4Raw(),
    int(CompressionCodec.ZSTD): _NativeZstd(),
}
_REGISTRY[int(CompressionCodec.LZ4)] = _Lz4Hadoop(_REGISTRY[int(CompressionCodec.LZ4_RAW)])


def register_codec(codec: CompressionCodec, impl) -> None:
    """Register/override a codec implementation (objects with .compress(bytes)
    and .decompress(bytes, uncompressed_size))."""
    _REGISTRY[int(codec)] = impl


def codec_supported(codec: CompressionCodec) -> bool:
    impl = _REGISTRY.get(int(codec))
    return impl is not None and (not isinstance(impl, _NativeZstd) or impl.available())


_GZIP_FUSED_OK: bool | None = None


def fused_gzip_identical() -> bool:
    """One-time probe: the native deflate (ptq_gzip_compress) must produce a
    gzip stream byte-identical to zlib.compressobj(wbits=31), true when the
    host library and CPython link the same zlib build. A CPython bundling a
    different zlib keeps GZIP chunks on the staged encoder (the fused walk's
    byte-identity contract is absolute)."""
    global _GZIP_FUSED_OK
    if _GZIP_FUSED_OK is None:
        probe = bytes(range(256)) * 16 + b"parquet_tpu gzip probe " * 64
        _GZIP_FUSED_OK = _native().gzip_compress(probe) == _Gzip().compress(probe)
    return _GZIP_FUSED_OK


def is_fused_encode_codec(codec) -> bool:
    """True while `codec` resolves to an implementation the fused native
    ENCODE walk reproduces byte for byte: the stock UNCOMPRESSED
    pass-through, the native snappy encoder (the walk calls the same
    function), or stock gzip once the deflate identity probe has passed.
    register_codec overrides stand the fused encoder down."""
    impl = _REGISTRY.get(int(codec))
    if isinstance(impl, (_Uncompressed, _NativeSnappy)):
        return True
    if isinstance(impl, _Gzip):
        return fused_gzip_identical()
    return False


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
    # every staged decode path funnels through here: the one choke point
    # for the always-on byte counters (the fused native walk bypasses it and
    # reports its own totals in kernels/pipeline.py). The same output bytes
    # ride the active trace as the `decode.bytes` account, so a request's
    # decoded bytes reconcile with the process bytes_uncompressed_total
    # delta (what the serve cost ledger charges a tenant)
    _metrics.io_bytes(len(data), len(out), impl.name)
    _trace_add_bytes("decode.bytes", len(out))
    return out
