"""The mixed dict/PLAIN merges and BYTE_STREAM_SPLIT route, on the CPU.

* The plain versions of bss_transpose, merge_mixed_numeric and
  merge_mixed_bytes equal the JAX device programs bit for bit on seeded
  inputs, called as the JAX pipeline calls them (inputs padded to their
  buckets, outputs sliced): out-of-range indices, empty pages, one-row
  pages, all-dict and all-PLAIN chunks included.
* Every golden file reads through the port's device_roundtrip and device
  (device="cpu") backends equal to the JAX reader, ZSTD through a codec the
  test registers.
* dict_overflow_mixed_pages.parquet, a pyarrow SNAPPY file with dictionary
  fallback and BYTE_STREAM_SPLIT, and the port's own synth file take the
  mixed and BSS routes; the route counters show it.
"""

import io
import threading
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import parquet_tpu.kernels.device_ops as jops  # noqa: E402  (turns x64 on first)
from parquet_tpu.core import chunk as jchunk  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.kernels import pipeline as jpipe  # noqa: E402

from parquet_tpu_torch.core import compress as tcompress  # noqa: E402
from parquet_tpu_torch.core.arrays import ByteArrayData  # noqa: E402
from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.kernels import device_ops as ops  # noqa: E402
from parquet_tpu_torch.kernels import pipeline as tpipe  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import CompressionCodec as C  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Encoding as E  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Type as T  # noqa: E402
from parquet_tpu_torch.testing.parity import to_numpy  # noqa: E402
from parquet_tpu_torch.testing.synth import (  # noqa: E402
    ColumnSpec,
    MixedBytesCase,
    bss_pages_cases,
    column_values,
    mixed_bytes_args,
    mixed_bytes_edge_cases,
    write_file,
)

GOLDEN = Path(__file__).parent / "golden" / "data"
GOLDEN_FILES = sorted(p.name for p in GOLDEN.glob("*.parquet"))


class _Zstd:
    """A ZSTD codec over the zstandard module (the port builds in none). A
    zstandard (de)compressor object is not thread-safe and the reader's
    prepare pool runs a codec from several threads, so each thread keeps
    its own."""

    name = "ZSTD"

    def __init__(self):
        self._tl = threading.local()

    def _get(self):
        import zstandard

        tl = self._tl
        if not hasattr(tl, "d"):
            tl.c = zstandard.ZstdCompressor()
            tl.d = zstandard.ZstdDecompressor()
        return tl

    def compress(self, data):
        return self._get().c.compress(bytes(data))

    def decompress(self, data, uncompressed_size):
        return self._get().d.decompress(bytes(data), max_output_size=max(uncompressed_size, 1))


@pytest.fixture
def zstd(monkeypatch):
    monkeypatch.setitem(tcompress._REGISTRY, int(C.ZSTD), _Zstd())


# -- the plain versions against the JAX programs --------------------------------


@pytest.mark.parametrize("n", [0, 1, 7, 1024, 5000])
def test_bss_transpose_plain_matches_jax(n):
    rng = np.random.default_rng(n)
    n_pad = jpipe._bucket(max(n, 1))
    streams = rng.integers(0, 256, size=(4, n_pad), dtype=np.uint8)
    want = np.asarray(jops.bss_transpose_device(jnp.asarray(streams), n))
    got = ops.bss_transpose(torch.from_numpy(streams), n)
    assert got.dtype == torch.int32 and got.numpy().view(np.uint32).tobytes() == want.tobytes()


BSS_PAGES = bss_pages_cases(seed=15)


@pytest.mark.parametrize("label,pages", BSS_PAGES, ids=[c[0] for c in BSS_PAGES])
def test_bss_transpose_pages_plain_matches_jax(label, pages):
    """A chunk's pages in one output, as the JAX pipeline builds it
    (jnp.concatenate of bss_transpose_device per page): empty and short
    pages, offsets that are not multiples of 4, more pages than one
    launch's table and an unpadded page, bit for bit; each page alone
    through bss_transpose too."""
    want = np.asarray(jnp.concatenate(
        [jops.bss_transpose_device(jnp.asarray(s), nv) for s, nv in pages]))
    got = ops.bss_transpose_pages([(torch.from_numpy(s), nv) for s, nv in pages])
    assert got.dtype == torch.int32 and got.numpy().view(np.uint32).tobytes() == want.tobytes()
    for s, nv in pages[:5]:
        want = np.asarray(jops.bss_transpose_device(jnp.asarray(s), nv))
        assert ops.bss_transpose(torch.from_numpy(s), nv).numpy().tobytes() == want.tobytes()


def test_bss_pages_per_launch_pinned_to_the_kernel():
    """BSS_PAGES_PER_LAUNCH, by which the wrapper counts launches, is the
    kernel's page table (kPages of bss_transpose.cu), and the edge cases
    hold more pages than one table."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "bss_transpose.cu").read_text()
    assert int(re.search(r"constexpr int kPages = (\d+);", src).group(1)) == \
        ops.BSS_PAGES_PER_LAUNCH
    assert max(len(pages) for _, pages in BSS_PAGES) > ops.BSS_PAGES_PER_LAUNCH


def test_bss_transpose_pages_refuses_bad_pages():
    s = torch.zeros((4, 1024), dtype=torch.uint8)
    with pytest.raises(ValueError, match="no pages"):
        ops.bss_transpose_pages([])
    with pytest.raises(ValueError, match="values in a stream"):
        ops.bss_transpose_pages([(s, 5), (s, 1025)])
    with pytest.raises(ValueError, match="uint8"):
        ops.bss_transpose_pages([(s.view(torch.int32), 5)])


def _pages(rng, layout, n_dict, bad=()):
    """Page tables, dict indices and PLAIN values for a page layout: a list
    of ("dict" | "plain", rows). `bad` indices go into the first dict page."""
    infos, idx, plain = [], [], []
    for kind, rows in layout:
        if kind == "dict":
            v = rng.integers(0, max(n_dict, 1), size=rows).astype(np.int32)
            if bad and len(idx) == 0 and rows:
                v[: len(bad)] = bad[:rows]
            idx.append(v)
            infos.append((rows, None, None, "dict", rows))
        else:
            p = rng.integers(-(2**62), 2**62, size=rows)
            plain.append(p)
            infos.append((rows, None, None, "values", p))
    idx = np.concatenate(idx) if idx else np.zeros(0, np.int32)
    plain = np.concatenate(plain) if plain else np.zeros(0, np.int64)
    return infos, idx, plain


NUMERIC_LAYOUTS = {
    "mixed": [("dict", 3000), ("dict", 1), ("plain", 2500), ("plain", 0), ("dict", 700)],
    "one_page": [("dict", 2000)],
    "all_plain": [("plain", 1500), ("plain", 1)],
    "one_row_pages": [("dict", 1), ("plain", 1), ("dict", 1), ("plain", 1)],
    "empty_pages": [("dict", 0), ("plain", 900), ("dict", 0), ("dict", 64)],
}
OUT_OF_RANGE = (-1, None, None, 2**31 - 1)  # None: n_dict and n_dict + 1


@pytest.mark.parametrize("n_dict", [5, 1000, 1024, 3000])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("layout", sorted(NUMERIC_LAYOUTS))
def test_merge_mixed_numeric_plain_matches_jax(layout, itemsize, n_dict):
    rng = np.random.default_rng(n_dict + itemsize)
    bad = (-1, n_dict, n_dict + 1, 2**31 - 1)
    infos, idx, plain = _pages(rng, NUMERIC_LAYOUTS[layout], n_dict, bad)
    ut, it = (np.uint32, np.int32) if itemsize == 4 else (np.uint64, np.int64)
    dictionary = rng.integers(0, 2**63, size=n_dict).astype(ut)
    plain = plain.astype(ut)
    kind, prs, aux, n_rows = jpipe._page_merge_tables(infos, lambda p: (len(p), len(p)))
    tkind, tprs, taux, tn = tpipe._page_merge_tables(infos, lambda p: (len(p), len(p)))
    assert (kind.tobytes(), prs.tobytes(), aux.tobytes(), n_rows) == (
        tkind.tobytes(), tprs.tobytes(), taux.tobytes(), tn)
    pad = jpipe._pad_device
    want = np.asarray(jops.merge_mixed_numeric_device(
        pad(jnp.asarray(idx)), pad(jnp.asarray(dictionary)), pad(jnp.asarray(plain)),
        jnp.asarray(kind), jnp.asarray(prs), jnp.asarray(aux), jpipe._bucket(max(n_rows, 1)),
    ))[:n_rows]
    got = ops.merge_mixed_numeric(
        torch.from_numpy(idx), torch.from_numpy(dictionary.view(it)),
        torch.from_numpy(plain.view(it)), torch.from_numpy(kind), torch.from_numpy(prs),
        torch.from_numpy(aux), n_rows,
    )
    assert got.numpy().view(ut).tobytes() == want.tobytes()


def _bytes_case(rng, layout, n_dict, bad):
    """A chunk of a ByteArrayData dictionary, dict pages (`bad` indices at
    the head of the first) and PLAIN pages, for testing.synth.mixed_bytes_args."""
    words = [bytes(rng.integers(97, 123, size=int(k), dtype=np.uint8))
             for k in rng.integers(0, 20, size=n_dict)]
    pages = []
    for kind, rows in layout:
        if kind == "dict":
            v = rng.integers(0, max(n_dict, 1), size=rows).astype(np.int32)
            if not any(k == "dict" for k, _p in pages) and rows:
                v[: len(bad)] = bad[:rows]
            pages.append(("dict", v))
        else:
            vals = [bytes(rng.integers(65, 91, size=int(k), dtype=np.uint8))
                    for k in rng.integers(0, 30, size=rows)]
            pages.append(("plain", ByteArrayData.from_list(vals)))
    return MixedBytesCase("", ByteArrayData.from_list(words), pages)


@pytest.mark.parametrize("n_dict", [3, 1023, 1500])
@pytest.mark.parametrize("layout", sorted(NUMERIC_LAYOUTS))
def test_merge_mixed_bytes_plain_matches_jax(layout, n_dict):
    rng = np.random.default_rng(n_dict)
    bad = (-1, n_dict, n_dict + 1, 2**31 - 1)
    *host, n_rows, bound = mixed_bytes_args(_bytes_case(rng, NUMERIC_LAYOUTS[layout], n_dict, bad))
    _assert_merge_bytes_matches_jax(tuple(host), n_rows, bound)


def _assert_merge_bytes_matches_jax(host, n_rows, bound):
    """The port's merge_mixed_bytes (its plain version, for CPU tensors) on
    the host arrays against the JAX program on them padded exactly as its
    _merge_ragged_bytes pads them: equal offsets, equal bytes up to the last
    offset, `bound` bytes of data."""
    idx, doff, pool, po32, kind, prs, aux, srcb = host
    b = jpipe._bucket
    po32p = np.zeros(b(len(po32), 1024), np.int32)
    po32p[: len(po32)] = po32
    poolp = np.zeros(b(max(len(pool), 1), 1024), np.uint8)
    poolp[: len(pool)] = pool
    doffp = np.full(b(len(doff), 1024), doff[-1], np.int64)
    doffp[: len(doff)] = doff
    jdata, joff = jops.merge_mixed_bytes_device(
        jpipe._pad_device(jnp.asarray(idx)), jnp.asarray(doffp), jnp.asarray(poolp),
        jnp.asarray(po32p), jnp.asarray(kind), jnp.asarray(prs), jnp.asarray(aux),
        jnp.asarray(srcb), jnp.int32(n_rows), b(max(n_rows, 1), 1024), b(max(bound, 1)),
    )
    joff = np.asarray(joff)[: n_rows + 1]
    data, off = ops.merge_mixed_bytes(*map(torch.from_numpy, host), n_rows, bound)
    assert off.numpy().tobytes() == joff.tobytes()
    total = int(joff[-1])
    assert data.numpy()[:total].tobytes() == np.asarray(jdata)[:total].tobytes()
    assert len(data) == bound
    return total


_BYTES_EDGE = mixed_bytes_edge_cases(ops.MERGE_BYTES_TILE)


@pytest.mark.parametrize("case", range(len(_BYTES_EDGE)), ids=[c.label for c in _BYTES_EDGE])
def test_merge_mixed_bytes_edge_cases_match_jax(case):
    """The generator's edge chunks (PLAIN rows of 100 KiB and more, empty
    rows and an all-empty tile, row counts around the kernel's tile, the
    out-of-range indices across a tile boundary, lengths around multiples of
    16): the port's plain version equals the JAX program, called as the JAX
    pipeline calls it."""
    *host, n_rows, bound = mixed_bytes_args(_BYTES_EDGE[case])
    total = _assert_merge_bytes_matches_jax(tuple(host), n_rows, bound)
    if _BYTES_EDGE[case].label == "all rows empty":
        assert total == 0


def test_merge_bytes_tile_pinned_to_the_kernel():
    """MERGE_BYTES_TILE, around which the edge chunks put their row counts,
    is the kernel's tile (kThreads * kItems of merge_mixed_bytes.cu)."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "merge_mixed_bytes.cu").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    items = int(re.search(r"kItems = (\d+);", src).group(1))
    assert threads * items == ops.MERGE_BYTES_TILE


# -- every golden file against the JAX reader ----------------------------------


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if hasattr(a, "offsets"):
        return np.array_equal(a.offsets, b.offsets) and bytes(a.data) == bytes(b.data)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _assert_device_columns_equal(tcol, jcol, ctx):
    t = to_numpy(tcol)
    assert t["num_values"] == jcol.num_values, ctx
    for f in ("values", "indices", "offsets", "dict_data", "dict_offsets", "data"):
        a, b = t[f], getattr(jcol, f)
        assert (a is None) == (b is None), (ctx, f)
        if a is None:
            continue
        b = np.asarray(b)
        if f == "data" and t["offsets"] is not None:
            # the merged data is sized to a bound in both packages; the
            # bytes past offsets[-1] are padding
            n = int(t["offsets"][-1])
            a, b = a[:n], b[:n]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), (ctx, f)
    for f in ("def_levels", "rep_levels"):
        assert _same(t[f], getattr(jcol, f)), (ctx, f)
    assert _same(t["dictionary"], jcol.dictionary), ctx


@pytest.mark.parametrize("name", GOLDEN_FILES)
def test_golden_device_roundtrip_matches_jax(name, zstd):
    raw = (GOLDEN / name).read_bytes()
    with FileReader(raw, backend="device_roundtrip", device="cpu") as tr:
        groups = [tr.read_row_group(i) for i in range(tr.num_row_groups)]
    n = 0
    with JReader(io.BytesIO(raw)) as jr:
        for i in range(jr.num_row_groups):
            for cc in jr.row_group(i).columns:
                p = tuple(cc.meta_data.path_in_schema)
                ref = jchunk.read_chunk(io.BytesIO(raw), cc, jr.schema.column(p))
                got = groups[i][p]
                assert got.num_values == ref.num_values, (name, p)
                for f in ("values", "def_levels", "rep_levels", "dictionary"):
                    assert _same(getattr(got, f), getattr(ref, f)), (name, p, f)
                n += 1
    assert n == sum(len(g) for g in groups)


@pytest.mark.parametrize("name", GOLDEN_FILES)
def test_golden_device_columns_match_jax(name, zstd):
    raw = (GOLDEN / name).read_bytes()
    with JReader(io.BytesIO(raw), backend="tpu") as jr, FileReader(raw, device="cpu") as tr:
        jgroups = [jr.read_row_group_device(i) for i in range(jr.num_row_groups)]
        tgroups = tr.read_row_groups_device()
        assert len(tgroups) == len(jgroups)
        for tg, jg in zip(tgroups, jgroups):
            assert tg.keys() == jg.keys()
            for p in tg:
                _assert_device_columns_equal(tg[p], jg[p], (name, p))
    jstats = jpipe.TpuDecodeStats()
    with JReader(io.BytesIO(raw)) as jr:
        for i in range(jr.num_row_groups):
            for cc in jr.row_group(i).columns:
                col = jr.schema.column(tuple(cc.meta_data.path_in_schema))
                jpipe.plan_chunk_tpu(io.BytesIO(raw), cc, col, stats=jstats).device_column()
    assert tr.stats.__dict__ == jstats.__dict__


# -- the routes the new kernels serve ------------------------------------------


def _routes_of(path_or_raw):
    tpipe.reset_prepare_counts()
    with FileReader(path_or_raw, device="cpu") as tr:
        groups = tr.read_row_groups_device()
    return groups, tpipe.prepare_counts()


def test_dict_overflow_golden_takes_the_merge_route():
    raw = (GOLDEN / "dict_overflow_mixed_pages.parquet").read_bytes()
    _groups, counts = _routes_of(raw)
    assert counts.get("route_merge_numeric", 0) + counts.get("route_merge_bytes", 0) > 0, counts
    assert not counts.get("prepare_fused_declined"), counts


def _pyarrow_mixed(tmp_path, n=60_000):
    rng = np.random.default_rng(17)
    t = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64) * 3 + 11),
        "i32": pa.array(rng.integers(0, 2**31 - 1, n).astype(np.int32)),
        "dbl": pa.array(rng.random(n)),
        "s": pa.array([f"key-{k:07d}" for k in rng.integers(0, 40_000, n)]),
        "f": pa.array(rng.random(n).astype(np.float32)),
    })
    path = tmp_path / "mixed_snappy.parquet"
    pq.write_table(
        t, path, compression="snappy", use_dictionary=["id", "i32", "dbl", "s"],
        dictionary_pagesize_limit=64 << 10, data_page_size=32 << 10,
        use_byte_stream_split=["f"], row_group_size=30_000,
    )
    return path, t


def test_pyarrow_dict_fallback_and_bss_take_the_new_routes(tmp_path):
    path, t = _pyarrow_mixed(tmp_path)
    groups, counts = _routes_of(path)
    assert counts["prepare_fused_engaged"] == 10 and not counts.get("prepare_fused_declined")
    # id and i32 merge on the device, s through the ragged merge, dbl (DOUBLE)
    # on the host, f through the BSS transpose: two row groups each
    assert counts["route_merge_numeric"] == 4, counts
    assert counts["route_merge_bytes"] == 2, counts
    assert counts["route_host_merge"] == 2, counts
    assert counts["route_bss"] == 2, counts
    for name in ("id", "i32", "dbl", "f"):
        got = np.concatenate([g[(name,)].values.numpy() for g in groups])
        assert got.tobytes() == t.column(name).to_numpy().tobytes(), name
    strings = []
    for g in groups:
        c = g[("s",)]
        off = c.offsets.numpy()
        strings += ByteArrayData(offsets=off, data=c.data.numpy()[: off[-1]].tobytes()).to_list()
    assert strings == [s.encode() for s in t.column("s").to_pylist()]
    with JReader(str(path), backend="tpu") as jr:
        for i, tg in enumerate(groups):
            jg = jr.read_row_group_device(i)
            for p in tg:
                _assert_device_columns_equal(tg[p], jg[p], p)


def _synth_specs(n, rng):
    keys = ByteArrayData.from_list([f"zone-{i:06d}".encode() for i in range(5000)])
    valid = rng.random(n) >= 0.05
    return [
        ColumnSpec("trip_id", T.INT64, encoding=E.RLE_DICTIONARY, codec=C.SNAPPY,
                   dictionary=np.arange(n, dtype=np.int64) + 10**9,
                   indices=np.arange(n, dtype=np.int32), dict_fallback_bytes=16 << 10),
        ColumnSpec("fare", T.FLOAT, values=rng.random(n).astype(np.float32),
                   encoding=E.BYTE_STREAM_SPLIT, codec=C.SNAPPY),
        ColumnSpec("count", T.INT32, values=rng.integers(-9, 9**9, n).astype(np.int32),
                   encoding=E.BYTE_STREAM_SPLIT, codec=C.SNAPPY, page_version=2),
        ColumnSpec("zone", T.BYTE_ARRAY, encoding=E.RLE_DICTIONARY, codec=C.SNAPPY,
                   dictionary=keys, utf8=True, dict_fallback_bytes=8 << 10,
                   indices=rng.integers(0, 5000, n).astype(np.int32)),
        ColumnSpec("passengers", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.SNAPPY,
                   valid=valid, dictionary=np.arange(7, dtype=np.int32),
                   indices=rng.integers(0, 7, int(valid.sum())).astype(np.int32),
                   dict_fallback_bytes=12),
    ]


def test_synth_file_matches_pyarrow_and_takes_the_new_routes(tmp_path):
    rng = np.random.default_rng(20261017)
    n = 40_000
    specs = _synth_specs(n, rng)
    path = tmp_path / "synth.parquet"
    write_file(path, specs, row_group_rows=20_000, page_bytes=16 << 10)
    table = pq.read_table(path)
    for s in specs:
        want = column_values(s)
        col = table.column(s.name)
        if isinstance(want, ByteArrayData):
            assert [v.encode() for v in col.to_pylist()] == want.to_list(), s.name
        else:
            got = col.drop_null().to_numpy()
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), s.name
        if s.valid is not None:
            assert np.array_equal(~np.asarray(col.is_null()), s.valid)
    meta = pq.ParquetFile(path).metadata
    encs = set(meta.row_group(0).column(0).encodings)
    assert {"PLAIN", "RLE_DICTIONARY"} <= encs
    groups, counts = _routes_of(path)
    assert counts["prepare_fused_engaged"] == 2 * len(specs), counts
    assert counts["route_merge_numeric"] == 4 and counts["route_merge_bytes"] == 2, counts
    assert counts["route_bss"] == 4, counts
    with JReader(str(path), backend="tpu") as jr:
        for i, tg in enumerate(groups):
            jg = jr.read_row_group_device(i)
            for p in tg:
                _assert_device_columns_equal(tg[p], jg[p], p)


def test_synth_fallback_keeps_trailing_nulls_in_the_dictionary_pages(tmp_path):
    # a dictionary that never passes its limit writes no PLAIN page, even
    # when the chunk's last rows are null
    valid = np.ones(5000, dtype=bool)
    valid[-300:] = False
    spec = ColumnSpec("p", T.INT32, encoding=E.RLE_DICTIONARY, valid=valid,
                      dictionary=np.arange(7, dtype=np.int32),
                      indices=np.arange(int(valid.sum()), dtype=np.int32) % 7,
                      dict_fallback_bytes=1 << 20)
    path = tmp_path / "p.parquet"
    write_file(path, [spec], row_group_rows=2500, page_bytes=1 << 10)
    with FileReader(path, device="cpu") as r:
        for g in range(r.num_row_groups):
            for _p, cc, column in r._selected_chunks(g):
                plan = tpipe.prepare_chunk_plan(r._window(cc), cc, column)
                assert {pi[3] for pi in plan.page_infos} <= {"dict", "empty"}
    got = pq.read_table(path).column("p").drop_null().to_numpy()
    assert np.array_equal(got, column_values(spec))
