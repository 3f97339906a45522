"""The port's native ZSTD codec (native/zstd.cc over libzstd, built at the
first ZSTD use into libpqt_zstd.so) against the reference's zstandard
codec: the golden ZSTD file reads with no codec registered, equal to the
reference, through FileReader and `parquet-tool cat`; a port ZSTD write
reads back through the reference; the branch for a host with libzstd's
runtime library and no zstd.h (zstd.cc's own declarations, forced with
PQT_ZSTD_DECLARE, linked by the runtime soname) builds, compresses like
zstandard and reads the golden file; where neither the header nor the
runtime library is there, ZSTD is the typed "not registered"
CompressionError naming the library; a registered codec takes
precedence; libpqt_host.so does not link libzstd."""

import contextlib
import io
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
zstandard = pytest.importorskip("zstandard")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.tools.parquet_tool import main as jmain  # noqa: E402

from parquet_tpu_torch import FileReader, FileWriter, parse_schema  # noqa: E402
from parquet_tpu_torch.core import compress as tcompress  # noqa: E402
from parquet_tpu_torch.core.compress import CompressionError  # noqa: E402
from parquet_tpu_torch.kernels import host_build  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import CompressionCodec  # noqa: E402
from parquet_tpu_torch.tools.parquet_tool import main as tmain  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "data"
ZSTD_FILE = GOLDEN / "alltypes_zstd_v2_nodict.parquet"
ZSTD = int(CompressionCodec.ZSTD)


def _native():
    impl = tcompress._REGISTRY[ZSTD]
    assert isinstance(impl, tcompress._NativeZstd)
    return impl


def _rows(reader_cls, path, **kw):
    with reader_cls(str(path), **kw) as r:
        return list(r.iter_rows())


def test_golden_zstd_file_reads_with_no_codec_registered():
    assert type(tcompress._REGISTRY[ZSTD]) is tcompress._NativeZstd
    assert _rows(FileReader, ZSTD_FILE, device="cpu") == _rows(JReader, ZSTD_FILE)


@pytest.mark.parametrize("backend", ["host", "device_roundtrip"])
def test_golden_zstd_columns_equal_the_reference(backend):
    with JReader(str(ZSTD_FILE)) as jr, FileReader(str(ZSTD_FILE), backend=backend,
                                                   device="cpu") as r:
        for i in range(r.num_row_groups):
            got, want = r.read_row_group(i), jr.read_row_group(i)
            assert got.keys() == want.keys()
            for p in got:
                a, b = got[p].values, want[p].values
                if hasattr(a, "offsets"):
                    assert bytes(a.data) == bytes(b.data)
                    assert np.array_equal(a.offsets, b.offsets)
                else:
                    assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def test_parquet_tool_cat_reads_zstd():
    outs = []
    for main in (jmain, tmain):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["cat", str(ZSTD_FILE)]) == 0
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and outs[1].count("\n") == 1500


@pytest.mark.parametrize("n", [0, 1, 1000, 300_000])
def test_port_zstd_write_reads_back_through_the_reference(n, tmp_path):
    rng = np.random.default_rng(n)
    schema = parse_schema("message m { required int64 a; optional binary s (STRING); }")
    path = tmp_path / "z.parquet"
    a = rng.integers(-(2**40), 2**40, n)
    s = [None if i % 7 == 0 else f"v{int(x) % 1000}" for i, x in enumerate(a)]
    with FileWriter(str(path), schema, codec="zstd") as w:
        w.write_rows([{"a": int(x), "s": y} for x, y in zip(a, s)])
    got = _rows(JReader, path)
    assert [r["a"] for r in got] == [int(x) for x in a]
    assert [r["s"] for r in got] == s
    with JReader(str(path)) as jr:
        for rg in jr.metadata.row_groups:
            assert {c.meta_data.codec for c in rg.columns} == {ZSTD}


@pytest.mark.parametrize("size", [0, 1, 777, 1 << 20])
def test_compressed_bytes_against_zstandard(size):
    """Decompression agrees both ways at every size. The compressed bytes
    are held equal only where this image's libzstd and zstandard's bundled
    zstd are the same release: the test says which it found."""
    data = (np.random.default_rng(size).integers(0, 16, size, dtype=np.uint8)).tobytes()
    z = _native()
    ours, theirs = z.compress(data), zstandard.ZstdCompressor().compress(data)
    assert z.decompress(theirs, size) == data
    assert zstandard.ZstdDecompressor().decompress(ours, max_output_size=max(size, 1)) == data
    bundled = ".".join(map(str, zstandard.ZSTD_VERSION))
    if z.version() == bundled:
        assert ours == theirs, f"libzstd {z.version()} = bundled {bundled}, bytes differ"
    else:
        print(f"libzstd {z.version()} != zstandard's bundled {bundled}: bytes not compared")


def test_corrupt_and_oversized_streams_raise_typed():
    z = _native()
    good = z.compress(b"x" * 1000)
    with pytest.raises(CompressionError):
        tcompress.decompress_block(good[:-3], ZSTD, 1000)
    with pytest.raises(CompressionError):
        tcompress.decompress_block(good, ZSTD, 999)  # inflates past the advertised size
    with pytest.raises(CompressionError):
        tcompress.decompress_block(b"not zstd at all", ZSTD, 10)
    assert tcompress.decompress_block(good, ZSTD, 1000) == b"x" * 1000


def test_each_thread_keeps_its_own_context():
    z = _native()
    blobs = [(bytes([k]) * (50_000 + k), None) for k in range(16)]
    blobs = [(d, z.compress(d)) for d, _ in blobs]
    errors = []

    def work(k):
        try:
            for _ in range(20):
                d, c = blobs[(k * 7 + _) % len(blobs)]
                assert z.decompress(c, len(d)) == d
                assert z.decompress(z.compress(d), len(d)) == d
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert not errors
    src = (host_build.NATIVE / "zstd.cc").read_text()
    assert "thread_local Contexts ctx;" in src


def fresh_zstd(monkeypatch, tmp_path, **constants):
    """A ZSTD codec registered anew over a fresh build of host_build's ZSTD
    library into tmp_path, with host_build's ZSTD constants set."""
    from parquet_tpu_torch.utils.native import get_native

    get_native()  # the host library (not ZSTD's) loads from the real build root
    monkeypatch.setattr(host_build, "BUILD_ROOT", tmp_path / "build")
    for k, v in constants.items():
        monkeypatch.setattr(host_build, k, v)
    monkeypatch.setattr(host_build, "_zstd", None)
    monkeypatch.setattr(host_build, "_zstd_error", None)
    impl = tcompress._NativeZstd()
    monkeypatch.setitem(tcompress._REGISTRY, ZSTD, impl)
    return impl


# ZSTD_H_235446 is zstd.h's include guard: defined, an #include <zstd.h>
# declares nothing, so a build that compiles with it needs none of the header
NO_HEADER = ("-DPQT_ZSTD_DECLARE", "-DZSTD_H_235446")
NO_DEV_LINK = "libpqt-absent-dev-link.so"


def test_the_header_guard_hides_zstd_h(monkeypatch, tmp_path):
    # the control of the next test: without PQT_ZSTD_DECLARE the guard
    # leaves zstd.cc nothing to compile against
    impl = fresh_zstd(monkeypatch, tmp_path, ZSTD_DEFINES=("-DZSTD_H_235446",))
    with pytest.raises(CompressionError, match="not registered: zstd library: build failed"):
        impl.lib()


@pytest.mark.parametrize("size", [0, 1, 777, 1 << 20])
def test_declared_branch_links_the_runtime_library(monkeypatch, tmp_path, size):
    """A host with libzstd.so.1 and neither zstd.h nor libzstd.so: the
    declared prototypes compile, the runtime library links by its soname,
    and the codec agrees with zstandard and reads the golden file."""
    impl = fresh_zstd(monkeypatch, tmp_path, ZSTD_DEFINES=NO_HEADER,
                      ZSTD_DEV_LINK=NO_DEV_LINK)
    assert host_build._zstd_flags() == (NO_HEADER, "-l:libzstd.so.1")
    lib = host_build.load_zstd()._name
    assert Path(lib).is_relative_to(tmp_path / "build")
    assert "libzstd.so.1" in subprocess.run(["ldd", lib], capture_output=True,
                                            text=True).stdout
    data = (np.random.default_rng(size).integers(0, 16, size, dtype=np.uint8)).tobytes()
    ours, theirs = impl.compress(data), zstandard.ZstdCompressor().compress(data)
    assert impl.decompress(theirs, size) == data
    assert zstandard.ZstdDecompressor().decompress(ours, max_output_size=max(size, 1)) == data
    bundled = ".".join(map(str, zstandard.ZSTD_VERSION))
    if impl.version() == bundled:
        assert ours == theirs, f"libzstd {impl.version()} = bundled {bundled}, bytes differ"
    assert _rows(FileReader, ZSTD_FILE, device="cpu") == _rows(JReader, ZSTD_FILE)


def test_the_build_key_covers_the_flags(monkeypatch, tmp_path):
    fresh_zstd(monkeypatch, tmp_path)
    default = Path(host_build.load_zstd()._name).parent
    fresh_zstd(monkeypatch, tmp_path, ZSTD_DEFINES=NO_HEADER)
    declared = Path(host_build.load_zstd()._name).parent
    fresh_zstd(monkeypatch, tmp_path, ZSTD_DEFINES=NO_HEADER, ZSTD_DEV_LINK=NO_DEV_LINK)
    runtime = Path(host_build.load_zstd()._name).parent
    assert len({default, declared, runtime}) == 3
    assert all(d.name.startswith("zstd-") for d in (default, declared, runtime))


def test_no_header_and_no_runtime_library_is_the_typed_refusal(monkeypatch, tmp_path):
    """A host with neither zstd.h nor any libzstd: the build fails, ZSTD
    stays unregistered and every use raises the typed CompressionError
    naming the library."""
    fresh_zstd(monkeypatch, tmp_path, ZSTD_DEFINES=NO_HEADER, ZSTD_DEV_LINK=NO_DEV_LINK,
               ZSTD_RUNTIME="libzstd.so.999")
    for call in (lambda: tcompress.decompress_block(b"x", ZSTD, 1),
                 lambda: tcompress.compress_block(b"x", ZSTD)):
        with pytest.raises(CompressionError) as e:
            call()
        assert "compression codec ZSTD not registered" in str(e.value)
        assert "libzstd.so.999 not found" in str(e.value)
    assert not tcompress.codec_supported(CompressionCodec.ZSTD)
    with pytest.raises(host_build.HostBuildError, match="libzstd.so.999 not found"):
        host_build.load_zstd()  # kept, not rebuilt
    with pytest.raises(CompressionError, match="not registered"):
        _rows(FileReader, ZSTD_FILE, device="cpu")


def test_a_registered_codec_takes_precedence(monkeypatch):
    calls = []

    class Spy:
        name = "ZSTD"

        def compress(self, data):
            return zstandard.ZstdCompressor().compress(bytes(data))

        def decompress(self, data, n):
            calls.append(n)
            return zstandard.ZstdDecompressor().decompress(bytes(data), max_output_size=max(n, 1))

    monkeypatch.setitem(tcompress._REGISTRY, ZSTD, Spy())
    assert _rows(FileReader, ZSTD_FILE, device="cpu") == _rows(JReader, ZSTD_FILE)
    assert calls
    monkeypatch.undo()
    assert isinstance(tcompress._REGISTRY[ZSTD], tcompress._NativeZstd)


def test_host_library_does_not_link_libzstd():
    from parquet_tpu_torch.utils.native import get_native

    host = get_native()._lib._name
    zstd = host_build.load_zstd()._name
    assert Path(zstd).name == host_build.ZSTD_LIB_NAME and Path(host).parent != Path(zstd).parent
    ldd = subprocess.run(["ldd", host], capture_output=True, text=True).stdout
    assert "libzstd" not in ldd
    assert "libzstd" in subprocess.run(["ldd", zstd], capture_output=True, text=True).stdout
    assert "zstd.cc" not in host_build.SOURCES and "-lzstd" not in " ".join(host_build.CXX_FLAGS)
