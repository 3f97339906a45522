"""The port's bloom filter write side against the JAX package's, on the CPU.

* bloom_hash_values for every type FileWriter gives a filter (INT32, INT64,
  FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY; -0.0, NaN, empty and
  multibyte strings) equals the JAX package's and the port's Python oracle.
* The host library's ptq_xxh64_fixed, ptq_xxh64_offsets, ptq_bloom_insert
  and ptq_bloom_check give what the JAX package's library gives and what
  their Python oracles give (ptq_bloom_check has no caller in either
  package: it is held against might_contain_hash).
* BloomFilter.sized_for(ndv, fpp).to_bytes() equals the JAX package's byte
  for byte, empty and filled.
* A filter the port's FileWriter writes reads back through both packages'
  read_bloom_filter and answers both packages' probes the same, never
  "absent" for a written value.
* The write side's call sites raise HostBuildError without the library.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core import bloom as jbloom  # noqa: E402
from parquet_tpu.core.arrays import ByteArrayData as JBytes  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.meta.parquet_types import Type as JT  # noqa: E402
from parquet_tpu.utils.native import get_native as j_native  # noqa: E402

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileReader, FileWriter  # noqa: E402
from parquet_tpu_torch.core import bloom as tbloom  # noqa: E402
from parquet_tpu_torch.core.arrays import ByteArrayData  # noqa: E402
from parquet_tpu_torch.kernels import host_build  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Type as T  # noqa: E402
from parquet_tpu_torch.utils import native as tnative  # noqa: E402


@pytest.fixture(scope="module")
def tlib():
    return tnative.get_native()


@pytest.fixture(scope="module")
def jlib():
    lib = j_native()
    assert lib is not None, "the JAX package's native library (native/build) is missing"
    return lib


def _words(seed: int = 3) -> list[bytes]:
    rng = np.random.default_rng(seed)
    fixed = [b"", "東京".encode(), "zürich".encode(), b"x" * 100, b"same", b"same"]
    return fixed + [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                    for n in rng.integers(0, 50, 500)]


def _cases():
    rng = np.random.default_rng(11)
    f64 = rng.normal(size=400)
    f64[:4] = (0.0, -0.0, np.nan, np.inf)
    f32 = f64.astype(np.float32)
    words = _words()
    return {
        "int32": (T.INT32, JT.INT32, rng.integers(-(1 << 31), 1 << 31, 700).astype(np.int32)),
        "int64": (T.INT64, JT.INT64, rng.integers(-(1 << 62), 1 << 62, 700).astype(np.int64)),
        "float": (T.FLOAT, JT.FLOAT, f32),
        "double": (T.DOUBLE, JT.DOUBLE, f64),
        "byte_array": (T.BYTE_ARRAY, JT.BYTE_ARRAY, words),
        "flba": (T.FIXED_LEN_BYTE_ARRAY, JT.FIXED_LEN_BYTE_ARRAY,
                 rng.integers(0, 256, (300, 12), dtype=np.uint8)),
        "empty": (T.INT64, JT.INT64, np.zeros(0, dtype=np.int64)),
    }


CASES = sorted(_cases())


def _values(label, pkg):
    ttype, jtype, v = _cases()[label]
    if isinstance(v, list):
        v = (ByteArrayData if pkg == "torch" else JBytes).from_list(v)
    return (ttype if pkg == "torch" else jtype), v


@pytest.mark.parametrize("label", CASES)
def test_bloom_hash_values_match_jax_and_oracle(label):
    ttype, tv = _values(label, "torch")
    jtype, jv = _values(label, "jax")
    got = tbloom.bloom_hash_values(ttype, tv)
    assert got.dtype == np.uint64
    assert np.array_equal(got, jbloom.bloom_hash_values(jtype, jv))
    assert np.array_equal(got, tbloom.bloom_hash_values_plain(ttype, tv))


def test_zero_signs_hash_alike():
    for ptype, dt in ((T.FLOAT, np.float32), (T.DOUBLE, np.float64)):
        h = tbloom.bloom_hash_values(ptype, np.array([0.0, -0.0], dtype=dt))
        assert h[0] == h[1]


def test_unsupported_hash_type_raises_like_jax():
    with pytest.raises(ValueError) as t_err:
        tbloom.bloom_hash_values(T.INT32, np.zeros(3, dtype=np.int64))
    with pytest.raises(ValueError) as j_err:
        jbloom.bloom_hash_values(JT.INT32, np.zeros(3, dtype=np.int64))
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("stride", [1, 4, 8, 13, 32, 33])
def test_xxh64_fixed_matches_jax_and_spec(tlib, jlib, stride):
    rng = np.random.default_rng(stride)
    for n in (0, 1, 5, 257):
        data = rng.integers(0, 256, n * stride, dtype=np.uint8)
        got = tlib.xxh64_fixed(data, n, stride)
        assert np.array_equal(got, jlib.xxh64_fixed(data, n, stride))
        raw = data.tobytes()
        assert got.tolist() == [tbloom.xxh64(raw[i * stride:(i + 1) * stride]) for i in range(n)]


def test_xxh64_fixed_refuses_a_short_buffer(tlib):
    with pytest.raises(ValueError, match="exceed"):
        tlib.xxh64_fixed(np.zeros(7, dtype=np.uint8), 1, 8)


def test_xxh64_offsets_matches_jax_and_spec(tlib, jlib):
    words = _words(5)
    col = ByteArrayData.from_list(words)
    got = tlib.xxh64_offsets(col.data, col.offsets)
    assert np.array_equal(got, jlib.xxh64_offsets(col.data, col.offsets))
    assert got.tolist() == [tbloom.xxh64(w) for w in words]
    empty = ByteArrayData.from_list([])
    assert len(tlib.xxh64_offsets(empty.data, empty.offsets)) == 0


@pytest.mark.parametrize("nbytes", [32, 64, 1024, 1 << 16])
def test_bloom_insert_and_check_match_jax_and_oracle(tlib, jlib, nbytes):
    rng = np.random.default_rng(nbytes)
    hashes = rng.integers(0, 1 << 64, 3000, dtype=np.uint64, endpoint=False)
    blocks = np.zeros(nbytes // 4, dtype=np.uint32)
    jblocks = blocks.copy()
    tlib.bloom_insert(blocks, hashes[:1000])
    jlib.bloom_insert(jblocks, hashes[:1000])
    oracle = tbloom.BloomFilter(np.zeros(nbytes // 4, dtype=np.uint32))
    oracle.insert_hashes_plain(hashes[:1000])
    assert np.array_equal(blocks, jblocks) and np.array_equal(blocks, oracle.blocks)
    hit = tlib.bloom_check(blocks, hashes)
    assert hit.dtype == bool
    assert np.array_equal(hit, jlib.bloom_check(jblocks, hashes))
    assert hit.tolist() == [oracle.might_contain_hash(int(h)) for h in hashes]
    assert hit[:1000].all()


def test_bloom_functions_refuse_an_empty_bitset(tlib):
    empty = np.zeros(0, dtype=np.uint32)
    with pytest.raises(ValueError, match="empty bitset"):
        tlib.bloom_insert(empty, np.ones(2, dtype=np.uint64))
    with pytest.raises(ValueError, match="empty bitset"):
        tlib.bloom_check(empty, np.ones(2, dtype=np.uint64))


@pytest.mark.parametrize("ndv", [0, 1, 100, 1000, 4096, 65_536, 10**6])
@pytest.mark.parametrize("fpp", [0.001, 0.01, 0.05, 0.3])
def test_sized_for_serializes_like_jax(ndv, fpp):
    t = tbloom.BloomFilter.sized_for(ndv, fpp)
    j = jbloom.BloomFilter.sized_for(ndv, fpp)
    assert t.num_bytes == j.num_bytes
    assert t.header().dumps() == j.header().dumps()
    assert t.to_bytes() == j.to_bytes()
    values = np.arange(min(ndv, 5000), dtype=np.int64) * 7919
    t.insert_hashes(tbloom.bloom_hash_values(T.INT64, values))
    j.insert_hashes(jbloom.bloom_hash_values(JT.INT64, values))
    assert t.to_bytes() == j.to_bytes()
    again = tbloom.BloomFilter.from_buffer(t.to_bytes())
    assert np.array_equal(again.blocks, t.blocks)


def test_sized_for_refuses_bad_fpp_like_jax():
    for fpp in (0.0, 1.0, -1.0):
        with pytest.raises(ValueError) as t_err:
            tbloom.BloomFilter.sized_for(10, fpp)
        with pytest.raises(ValueError) as j_err:
            jbloom.BloomFilter.sized_for(10, fpp)
        assert str(t_err.value) == str(j_err.value)


def test_filters_the_port_writes_read_back_in_both_packages(tmp_path):
    schema = parquet_tpu_torch.parse_schema(
        "message m { required int64 id; required double x; required binary s (STRING);"
        " required int32 k; required fixed_len_byte_array(6) f; }")
    rng = np.random.default_rng(21)
    n, groups = 3000, 3
    path = tmp_path / "bloom.parquet"
    written = {"id": [], "x": [], "s": [], "k": [], "f": []}
    with FileWriter(path, schema, bloom_filters={"id": True, "x": {"fpp": 0.05},
                                                 "s": {"ndv": 50, "fpp": 0.01}, "k": True,
                                                 "f": True}) as w:
        for g in range(groups):
            ids = rng.integers(0, 1 << 40, n).astype(np.int64)
            xs = np.round(rng.normal(size=n), 3)
            ss = [f"key-{int(v)}".encode() for v in rng.integers(0, 50, n)]
            ks = rng.integers(-50, 50, n).astype(np.int32)
            fs = rng.integers(0, 256, (n, 6), dtype=np.uint8)
            w.write_column("id", ids)
            w.write_column("x", xs)
            w.write_column("s", np.array(ss, dtype=object))
            w.write_column("k", ks)
            w.write_column("f", fs)
            w.flush_row_group()
            for key, v in (("id", ids), ("x", xs), ("s", ss), ("k", ks), ("f", fs)):
                written[key].append(v)
    probes = {
        "id": (T.INT64, JT.INT64, [int(v) for v in written["id"][1][:40]] + list(range(40))),
        "x": (T.DOUBLE, JT.DOUBLE, [float(v) for v in written["x"][2][:40]] + [9.5, -0.0]),
        "s": (T.BYTE_ARRAY, JT.BYTE_ARRAY, written["s"][0][:20] + [b"key-999", "key-3"]),
        "k": (T.INT32, JT.INT32, [int(v) for v in written["k"][0][:20]] + [1000, -1000]),
        "f": (T.FIXED_LEN_BYTE_ARRAY, JT.FIXED_LEN_BYTE_ARRAY,
              [r.tobytes() for r in written["f"][1][:20]] + [b"\x00" * 6]),
    }
    with FileReader(path, device="cpu") as tr, JReader(str(path)) as jr:
        for g in range(groups):
            for key, (ttype, jtype, vals) in probes.items():
                tbf, jbf = tr.read_bloom_filter(g, key), jr.read_bloom_filter(g, key)
                assert tbf is not None and np.array_equal(tbf.blocks, jbf.blocks)
                got = [tbf.might_contain(ttype, v) for v in vals]
                assert got == [jbf.might_contain(jtype, v) for v in vals]
            mine = written["id"][g][:200]
            assert all(tr.read_bloom_filter(g, "id").might_contain(T.INT64, int(v)) for v in mine)


def test_write_side_call_sites_raise_host_build_error_without_the_library(monkeypatch):
    monkeypatch.setattr(tnative, "_cached", None)

    def no_library():
        raise host_build.HostBuildError("host library build failed (1): g++ ...")

    monkeypatch.setattr(host_build, "load", no_library)
    with pytest.raises(host_build.HostBuildError, match="build failed"):
        tbloom.bloom_hash_values(T.INT64, np.arange(3, dtype=np.int64))
    with pytest.raises(host_build.HostBuildError, match="build failed"):
        tbloom.BloomFilter.sized_for(10).insert_hashes(np.arange(3, dtype=np.uint64))


# -- every new ctypes binding has its C parameter's width -----------------------


_C_TYPES = {
    "size_t": "c_size_t", "ssize_t": "c_ssize_t", "int": "c_int", "int64_t": "c_int64",
    "uint64_t": "c_uint64",
}


def _definition(name: str):
    """(return type, [parameter declarations]) of a host-library function,
    from whichever of the library's sources defines it."""
    import re

    for src in host_build.CXX_SOURCES + host_build.ENCODE_SOURCES:
        text = (host_build.NATIVE / src).read_text()
        m = re.search(rf"^(\w+) {name}\(([^)]*)\) \{{", text, re.M)
        if m:
            return m.group(1), [" ".join(p.split()) for p in m.group(2).split(",")]
    raise AssertionError(f"{name} is defined in no host source")


NEW_FUNCTIONS = ("ptq_xxh64_fixed", "ptq_xxh64_offsets", "ptq_bloom_insert",
                 "ptq_bloom_check", "ptq_gzip_compress", "ptq_chunk_encode")


@pytest.mark.parametrize("name", NEW_FUNCTIONS)
def test_write_side_signatures_match_the_sources(tlib, name):
    import ctypes
    import re

    ret, params = _definition(name)
    fn = getattr(tlib._lib, name)
    want = [ctypes.c_void_p if "*" in p else getattr(ctypes, _C_TYPES[re.sub(r"\s+\w+$", "", p)])
            for p in params]
    assert list(fn.argtypes) == want
    assert fn.restype is getattr(ctypes, _C_TYPES[ret])
    assert ctypes.sizeof(fn.restype) == 8


def test_the_encode_walk_builds_from_its_own_source():
    assert host_build.ENCODE_SOURCES == ("encode.cc",)
    assert {"encode.cc", "encode.h", "bits.h"} <= set(host_build.SOURCES)
    src = (host_build.NATIVE / "encode.cc").read_text()
    assert '#include "bits.h"' in src and '#include "parquet_tpu_native.h"' not in src
    for name in ("prepare.cc", "values.cc", "encode.cc"):
        assert "static inline ssize_t hybrid_encode_any" not in (host_build.NATIVE / name).read_text()
    assert "static inline ssize_t hybrid_encode_any" in (host_build.NATIVE / "bits.h").read_text()
