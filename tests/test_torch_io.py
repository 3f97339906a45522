"""parquet_tpu_torch.io against the JAX package's parquet_tpu.io.

The same inputs, made from a seed with numpy, go through both packages'
io layers, and everything must agree exactly: bytes, lists, counts, error
classes and texts.

  * the sources: LocalFileSource, MemorySource, FileObjectSource,
    SourceFile, the open_source table, RetryingSource over FlakySource
    seeds (outcomes, retry counts by reason, the flaky counters);
  * the planner: plan_ranges over a footer with page indexes and blooms,
    coalesce lists, fetch_ranges bytes, BlockCache and FooterCache hits,
    misses and evictions under one sequence of operations, Readahead's
    accept/drop verdicts, the autotune verdicts under one latency series;
  * the reader: every byte through a LocalFileSource (os.pread, no reader
    lock), the planned host fetch (coalesce_gap, block_cache), the footer
    cache, and the inputs that worked before (bytes, BytesIO, file
    objects) giving the JAX reader's columns.

The JAX package's counters are its metrics registry's; the port's are
io_counts(). The slow sweep is the counterpart of tests/test_io.py's retry
matrix.
"""

from __future__ import annotations

import io
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from parquet_tpu import io as jio  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.testing.flaky import FlakySource as JFlaky  # noqa: E402
from parquet_tpu.utils import metrics as jmetrics  # noqa: E402

from parquet_tpu_torch import io as pio  # noqa: E402
from parquet_tpu_torch.core.arrays import ByteArrayData  # noqa: E402
from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.testing.flaky import FlakySource  # noqa: E402

NOSLEEP = lambda s: None  # noqa: E731
WATCHDOG_SECONDS = 60.0


# -- helpers -------------------------------------------------------------------


def counts_delta(before: dict, prefixes=("io_", "cache_tier_")) -> dict:
    """The JAX registry's counter increments since `before` (gauges and
    histograms skipped), keyed as the port keys io_counts()."""
    out = {}
    for k, v in jmetrics.snapshot().items():
        name = k.split("{", 1)[0]
        if not name.endswith("_total") or not name.startswith(prefixes):
            continue
        if not isinstance(v, (int, float)):
            continue
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


class Counted:
    """Both packages' counters over one block: `.jax` and `.port` hold the
    increments (the port's counts are reset on entry)."""

    def __init__(self, prefixes=("io_", "cache_tier_")):
        self.prefixes = prefixes

    def __enter__(self):
        self._before = jmetrics.snapshot()
        pio.reset_io_counts()
        return self

    def __exit__(self, *exc):
        self.jax = counts_delta(self._before, self.prefixes)
        self.port = {
            k: v for k, v in pio.io_counts().items()
            if v and k.split("{", 1)[0].startswith(self.prefixes)
        }
        return False


def outcome(fn):
    """('ok', value) or (error class name, message)."""
    try:
        v = fn()
    except Exception as e:  # noqa: BLE001 — the outcome is what is compared
        return (type(e).__name__, str(e))
    if isinstance(v, (memoryview, bytearray)):
        v = bytes(v)
    return ("ok", v)


def digest(groups) -> list:
    """Comparable form of [{path: ChunkData}] from either package."""
    out = []
    for g in groups:
        d = {}
        for path, cd in g.items():
            v = cd.values
            if hasattr(v, "offsets") and hasattr(v, "data"):
                vals = (np.asarray(v.offsets).tobytes(), bytes(v.data))
            else:
                vals = np.ascontiguousarray(np.asarray(v)).tobytes()
            lv = tuple(
                None if x is None else np.asarray(x).astype(np.uint16).tobytes()
                for x in (cd.def_levels, cd.rep_levels)
            )
            d[path] = (cd.num_values, vals, lv)
        out.append(d)
    return out


def blob_of(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def blob_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_io") / "blob.bin"
    p.write_bytes(blob_of(1 << 16, seed=3))
    return str(p)


def _table(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    mask = rng.random(rows) < 0.2
    return pa.table({
        "a": pa.array(rng.integers(0, 1 << 40, rows), pa.int64(), mask=mask),
        "b": pa.array([f"s{k % 53}" for k in range(rows)]),
        "c": pa.array(rng.standard_normal(rows)),
        "d": pa.array(rng.integers(0, 9, rows).astype(np.int32)),
    })


@pytest.fixture(scope="module")
def pq_path(tmp_path_factory):
    """Four row groups, snappy, with page indexes."""
    p = tmp_path_factory.mktemp("torch_io_pq") / "f.parquet"
    pq.write_table(_table(4000, 1), str(p), row_group_size=1000, compression="snappy",
                   write_page_index=True, data_page_size=4096)
    return str(p)


@pytest.fixture(scope="module")
def bloom_path(tmp_path_factory):
    """A file of the port's writer with bloom filters and a page index."""
    from parquet_tpu_torch import FileWriter, parse_schema

    p = str(tmp_path_factory.mktemp("torch_io_bloom") / "bloom.parquet")
    schema = parse_schema("message m { required int64 k; required binary s (STRING); }")
    rng = np.random.default_rng(4)
    with FileWriter(p, schema, codec="snappy", bloom_filters=["k", "s"],
                    write_page_index=True, row_group_size=600) as w:
        for _ in range(3):
            n = 600
            w.write_column("k", rng.integers(0, 1 << 30, n).astype(np.int64))
            w.write_column("s", [f"x{int(v)}".encode() for v in rng.integers(0, 99, n)])
            w.flush_row_group()
    return p


def read_all(reader_cls, src, **kw):
    kw = dict(kw)
    if reader_cls is FileReader:
        kw.setdefault("device", "cpu")
    with reader_cls(src, **kw) as r:
        return [r.read_row_group(i) for i in range(r.num_row_groups)]


# -- sources -------------------------------------------------------------------


def _shapes(path):
    data = open(path, "rb").read()
    return {
        "str": lambda m: path,
        "Path": lambda m: __import__("pathlib").Path(path),
        "bytes": lambda m: data,
        "bytearray": lambda m: bytearray(data),
        "memoryview": lambda m: memoryview(data),
        "BytesIO": lambda m: io.BytesIO(data),
        "ByteSource": lambda m: m.MemorySource(data, source_id="mem:x"),
        "fileobj": lambda m: open(path, "rb"),
        "bad": lambda m: 12345,
    }


@pytest.mark.parametrize(
    "shape", ["str", "Path", "bytes", "bytearray", "memoryview", "BytesIO", "ByteSource",
              "fileobj", "bad"],
)
def test_open_source_table(blob_path, shape):
    make = _shapes(blob_path)[shape]

    def run(m):
        obj = make(m)
        try:
            src, owns = m.open_source(obj)
        except TypeError as e:
            return ("TypeError", str(e))
        try:
            return (type(src).__name__, owns, src.size(), src.read_at(100, 50))
        finally:
            if owns:
                src.close()
            if hasattr(obj, "close") and not isinstance(obj, (io.BytesIO,)):
                obj.close()

    assert run(pio) == run(jio)


def test_local_source_errors_and_identity(blob_path, tmp_path):
    def run(m):
        out = []
        src = m.LocalFileSource(blob_path)
        out.append(src.source_id == m.LocalFileSource(blob_path).source_id)
        out.append(outcome(lambda: src.read_at(0, 0)))
        out.append(outcome(lambda: src.read_at(65530, 6)))
        out.append(outcome(lambda: src.read_at(65530, 7)))
        out.append(outcome(lambda: src.read_at(-1, 3)))
        out.append(src.generation())
        src.close()
        src.close()  # idempotent
        out.append(outcome(lambda: src.read_at(0, 4)))
        return out

    assert run(pio) == run(jio)
    # a rewritten file is another generation
    p = tmp_path / "g.bin"
    p.write_bytes(b"abc")
    a = pio.LocalFileSource(str(p)).source_id
    os.utime(p, ns=(1, 1))
    assert pio.LocalFileSource(str(p)).source_id != a


def test_memory_and_file_object_sources(blob_path):
    data = open(blob_path, "rb").read()

    def run(m):
        out = []
        ms = m.MemorySource(data)
        out += [ms.size(), outcome(lambda: ms.read_at(10, 20)), outcome(lambda: ms.read_at(65535, 2))]
        out.append(outcome(lambda: ms.read_ranges([(0, 3), (5, 2), (65534, 2)])))
        fo = m.FileObjectSource(io.BytesIO(data))
        out += [fo.size(), outcome(lambda: fo.read_at(7, 9)), outcome(lambda: fo.read_at(65530, 9))]
        with open(blob_path, "rb") as f:
            fs = m.FileObjectSource(f)
            out.append(outcome(lambda: fs.read_at(1000, 33)))
        sf = m.SourceFile(ms)
        out += [sf.seek(-10, 2), sf.read(4), sf.tell(), sf.read(), sf.read(3), sf.seek(5), sf.read(2)]
        out.append(outcome(lambda: sf.seek(0, 3)))
        return out

    with Counted() as c:
        port = run(pio)
    with Counted() as cj:
        jax = run(jio)
    assert port == jax
    assert c.port == cj.jax


FLAKY_MIXES = [
    dict(error_rate=0.4),
    dict(short_rate=0.4),
    dict(error_rate=0.25, short_rate=0.25),
    dict(error_rate=0.3, fault_window=(1000, 5000)),
    dict(permanent=True),
    dict(spike_rate=0.5, spike_s=0.001, error_rate=0.1),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mix", range(len(FLAKY_MIXES)))
def test_retrying_over_flaky_seeds(blob_path, seed, mix):
    faults = FLAKY_MIXES[mix]
    data = open(blob_path, "rb").read()
    reads = [(int(o), int(n)) for o, n in zip(
        np.random.default_rng(seed).integers(0, 60000, 12),
        np.random.default_rng(seed + 100).integers(1, 4000, 12),
    )]

    def run(m, flaky_cls):
        fl = flaky_cls(m.MemorySource(data, source_id="mem:blob"), seed=seed, sleep=NOSLEEP,
                       **faults)
        src = m.RetryingSource(fl, attempts=4, sleep=NOSLEEP, seed=seed)
        out = [outcome(lambda o=o, n=n: src.read_at(o, n)) for o, n in reads]
        out.append(outcome(lambda: src.read_ranges(reads[:4])))
        return out, (fl.reads, fl.faults_injected, fl.spikes_injected)

    with Counted() as c:
        port = run(pio, FlakySource)
    with Counted() as cj:
        jax = run(jio, JFlaky)
    assert port == jax
    for o, (kind, _v) in zip(reads, port[0]):
        if kind == "ok":
            assert _v == data[o[0]:o[0] + o[1]]
    assert c.port == cj.jax


def test_retrying_deadline_and_terminal(blob_path):
    data = open(blob_path, "rb").read()

    def run(m, flaky_cls):
        out = []
        fl = flaky_cls(m.MemorySource(data), seed=3, permanent=True, sleep=NOSLEEP)
        clock = iter(range(0, 10_000, 7))
        src = m.RetryingSource(fl, attempts=10, deadline_s=20.0, base_delay_s=5.0,
                               sleep=NOSLEEP, seed=1)
        import time as _t
        real = _t.monotonic
        _t.monotonic = lambda: float(next(clock))
        try:
            out.append(outcome(lambda: src.read_at(0, 10)))
        finally:
            _t.monotonic = real
        out.append(outcome(lambda: m.RetryingSource(m.MemorySource(data), attempts=0)))
        # a SourceError from the inner source is terminal: no retry
        out.append(outcome(lambda: m.RetryingSource(m.MemorySource(data), sleep=NOSLEEP)
                           .read_at(65530, 100)))
        return out

    with Counted() as c:
        port = run(pio, FlakySource)
    with Counted() as cj:
        jax = run(jio, JFlaky)
    assert port == jax
    assert c.port == cj.jax


# -- the planner ---------------------------------------------------------------


@pytest.mark.parametrize("page_index", [False, True])
@pytest.mark.parametrize("blooms", [False, True])
def test_plan_ranges_equal(bloom_path, pq_path, page_index, blooms):
    from parquet_tpu.io.planner import plan_ranges as jplan

    for path in (pq_path, bloom_path):
        meta = FileReader.open_metadata(path)
        jmeta = JReader.open_metadata(path)
        n = len(meta.row_groups)
        for rgs in (None, [0], [n - 1, 0], [n + 3]):
            leaves = [tuple(c.meta_data.path_in_schema) for c in meta.row_groups[0].columns]
            for cols in (None, leaves[:1], [leaves[-1]], []):
                assert pio.plan_ranges(
                    meta, row_groups=rgs, columns=cols, page_index=page_index, blooms=blooms
                ) == jplan(jmeta, row_groups=rgs, columns=cols, page_index=page_index, blooms=blooms)


@pytest.mark.parametrize("seed", range(6))
def test_coalesce_lists(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(0, 40))
    offs = rng.integers(0, 1 << 22, k)
    lens = rng.integers(0, 1 << 16, k)
    ranges = list(zip(offs.tolist(), lens.tolist()))
    ranges += ranges[: k // 3]  # duplicates
    for gap in (0, 1, 4096, 64 << 10, 8 << 20):
        for max_run in (1 << 16, 16 << 20):
            with Counted() as c:
                got = pio.coalesce(ranges, gap=gap, max_run=max_run)
            with Counted() as cj:
                want = jio.coalesce(ranges, gap=gap, max_run=max_run)
            assert got == want
            assert c.port == cj.jax


def test_fetch_ranges_and_block_cache_sequence(blob_path):
    """One sequence of fetches through a small BlockCache: bytes, hits,
    misses, evictions and stats equal the reference's after every step."""
    rng = np.random.default_rng(9)
    steps = []
    for _ in range(25):
        k = int(rng.integers(1, 6))
        steps.append([(int(rng.integers(0, 60000)), int(rng.integers(1, 3000))) for _ in range(k)])
        steps.append(steps[-1][: max(1, k // 2)])  # a repeat: hits

    def run(m):
        src = m.LocalFileSource(blob_path)
        cache = m.BlockCache(24 << 10)
        out = []
        for i, ranges in enumerate(steps):
            got = m.fetch_ranges(src, ranges, cache=cache, gap=(0, 512, 8192)[i % 3])
            out.append({k: bytes(v) for k, v in got.items()})
            out.append(cache.stats())
        cache.invalidate(src.source_id)
        out.append(cache.stats())
        out.append(outcome(lambda: m.BlockCache(0)))
        src.close()
        return out

    with Counted() as c:
        port = run(pio)
    with Counted() as cj:
        jax = run(jio)
    assert port == jax
    assert c.port == cj.jax
    assert c.port["io_cache_evictions_total"] > 0 and c.port["io_cache_hits_total"] > 0


def test_footer_cache_sequence(pq_path, tmp_path):
    p = tmp_path / "copy.parquet"
    p.write_bytes(open(pq_path, "rb").read())

    def run(m, reader_cls):
        fc = m.FooterCache(max_entries=2)
        out = []
        os.utime(p, ns=(1, 1_000_000_007))
        for step in range(6):
            meta = reader_cls.open_metadata(str(p), footer_cache=fc)
            out.append(meta.num_rows)
            if step == 2:
                os.utime(p, ns=(2, 2_000_000_014))  # a new generation
        out.append(fc.get(str(tmp_path / "missing.parquet")))
        fc.put("k1", "m1", sig=(1, "e"))
        fc.put("k2", "m2", sig=(2, "e"))
        out += [fc.get("k1", sig=(1, "e")), fc.get("k1", sig=(1, "f")), len(fc)]
        out.append(outcome(lambda: m.FooterCache(0)))
        return out

    with Counted() as c:
        port = run(pio, FileReader)
    with Counted() as cj:
        jax = run(jio, JReader)
    assert port == jax
    assert c.port == cj.jax


def test_readahead_verdicts(blob_path):
    plan = [[(0, 4096)], [(8192, 16384)], [(40000, 30000)], [], [(60000, 5000), (100, 10)]]

    def run(m):
        cache = m.BlockCache(1 << 20)
        ra = m.Readahead(cache, budget_bytes=24 << 10)
        verdicts = []
        # a blocker keeps the first fetch in flight, so the budget is
        # really held while the later schedules are judged
        gate = threading.Event()
        inner = m.LocalFileSource(blob_path)

        class Gated(m.ByteSource):
            source_id = inner.source_id

            def size(self):
                return inner.size()

            def read_at(self, o, n):
                gate.wait(WATCHDOG_SECONDS)
                return inner.read_at(o, n)

        g = Gated()
        for ranges in plan:
            verdicts.append(ra.schedule(g, ranges))
        gate.set()
        ra.drain()
        verdicts.append(ra.schedule(blob_path, [(30000, 1000)]))
        ra.drain()
        ra.close(wait=True)
        verdicts.append(ra.schedule(blob_path, [(0, 10)]))
        verdicts.append(sorted(k[1:] for k in cache._blocks))
        verdicts.append(outcome(lambda: m.Readahead(None)))
        inner.close()
        return verdicts

    with Counted() as c:
        port = run(pio)
    with Counted() as cj:
        jax = run(jio)
    assert port == jax
    assert c.port == cj.jax
    assert c.port["io_readahead_dropped_total"] >= 1


def test_autotune_verdicts():
    rng = np.random.default_rng(5)
    series = [
        ("http:https://store:9000/b/o#e:1", int(rng.integers(1 << 16, 1 << 22)),
         float(rng.uniform(0.001, 0.05)), int(rng.integers(1, 4)))
        for _ in range(20)
    ] + [("file:/x:1:2:3", 1 << 20, 0.0001, 1) for _ in range(5)] + [
        ("http://h/a", 0, 1.0, 1), ("http://h/a", 10, 0.0, 1), ("http://h/a", 1 << 20, 0.02, 1),
    ]

    def run(m):
        t = m.IOTuner(min_observations=3)
        out = []
        for sid, nbytes, secs, runs in series:
            t.observe(sid, nbytes, secs, runs)
            out.append(tuple(t.params_for(sid)))
        out.append(t.stats())
        out.append([m.profile_key(k) for k in (
            "http:https://host:9000/bucket/obj#etag:123", "http://host/file.parquet",
            "file:/data/x.parquet:41:9:17", "mem:0x1", "https://h", "http://")])
        out.append(outcome(lambda: m.IOTuner(alpha=0)))
        t.reset()
        out.append(t.stats())
        return out

    assert run(pio) == run(jio)


# -- the reader ----------------------------------------------------------------


def test_reader_reads_through_local_source(pq_path):
    with FileReader(pq_path, device="cpu") as r:
        assert isinstance(r._source, pio.LocalFileSource)
        assert not hasattr(r, "_lock")  # no reader lock around the reads
        want = [r.read_row_group(i) for i in range(r.num_row_groups)]
        # concurrent host reads of one reader: no shared cursor to race on
        got: dict = {}
        errors = []

        def work(i):
            try:
                got[i] = r.read_row_group(i % r.num_row_groups)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WATCHDOG_SECONDS)
        assert not errors
        for i, g in got.items():
            assert digest([g]) == digest([want[i % r.num_row_groups]])
    assert digest(want) == digest(read_all(JReader, pq_path))


@pytest.mark.parametrize("gap", [None, 0, 1, "auto", 1 << 20])
@pytest.mark.parametrize("cached", [False, True])
def test_reader_fetch_counts_match(pq_path, gap, cached):
    """The planned host fetch: the same reads, the same coalesced runs,
    the same cache outcomes as the reference (two passes, the second warm
    when a cache is attached)."""
    cols = [["a", "c"], None]

    def run(m, reader_cls):
        cache = m.BlockCache(8 << 20) if cached else None
        out = []
        for _ in range(2):
            for c in cols:
                out.append(digest(read_all(reader_cls, pq_path, columns=c, block_cache=cache,
                                           coalesce_gap=gap)))
        return out

    jio.io_tuner().reset()
    pio.io_tuner().reset()
    with Counted() as c:
        port = run(pio, FileReader)
    with Counted() as cj:
        jax = run(jio, JReader)
    assert port == jax
    assert c.port == cj.jax


def test_reader_footer_cache(pq_path):
    def run(m, reader_cls):
        fc = m.FooterCache()
        out = []
        for _ in range(3):
            with (reader_cls(pq_path, footer_cache=fc, device="cpu") if reader_cls is FileReader
                  else reader_cls(pq_path, footer_cache=fc)) as r:
                out.append(r.num_rows)
        return out

    with Counted() as c:
        port = run(pio, FileReader)
    with Counted() as cj:
        jax = run(jio, JReader)
    assert port == jax
    assert c.port == cj.jax
    assert c.port["io_footer_cache_hits_total"] == 2


@pytest.mark.parametrize("shape", ["bytes", "BytesIO", "fileobj", "ByteSource"])
def test_reader_inputs_that_worked_before(pq_path, shape):
    data = open(pq_path, "rb").read()
    make = {
        "bytes": lambda m: data,
        "BytesIO": lambda m: io.BytesIO(data),
        "fileobj": lambda m: open(pq_path, "rb"),
        "ByteSource": lambda m: m.MemorySource(data),
    }[shape]
    src = make(pio)
    got = read_all(FileReader, src)
    jsrc = make(jio)
    want = read_all(JReader, jsrc)
    for s in (src, jsrc):
        if hasattr(s, "close") and not isinstance(s, bytes):
            s.close()
    assert digest(got) == digest(want)


def test_reader_truncated_file_keeps_typed_errors(pq_path):
    """A cut file: the planned fetch declines the out-of-bounds ranges and
    the reads raise the reference's typed errors."""
    from parquet_tpu_torch.core.reader import PARQUET_ERRORS

    data = open(pq_path, "rb").read()
    meta = FileReader.open_metadata(pq_path)
    for cut in (len(data) // 2, len(data) - 200):
        bad = data[:cut]
        for gi in range(len(meta.row_groups)):
            got = outcome(lambda: FileReader(bad, metadata=meta, device="cpu").read_row_group(gi))
            want = outcome(lambda: JReader(bad, metadata=JReader.open_metadata(pq_path))
                           .read_row_group(gi))
            assert got[0] == want[0]
            if got[0] != "ok":
                assert got[1] == want[1]
                assert got[0] in {e.__name__ for e in PARQUET_ERRORS}


def test_reader_over_retrying_flaky_source(pq_path):
    want = digest(read_all(JReader, pq_path))
    src = pio.RetryingSource(
        FlakySource(pio.LocalFileSource(pq_path), seed=6, error_rate=0.25, short_rate=0.1),
        attempts=32, sleep=NOSLEEP, seed=4,
    )
    got = digest(read_all(FileReader, src))
    src.close()
    assert got == want


def test_byte_array_values_survive_window_slices(pq_path):
    """The fetched window is a memoryview of the run: decoded byte arrays
    must own their bytes (the run buffer may be reused by the cache)."""
    cache = pio.BlockCache(8 << 20)
    with FileReader(pq_path, columns=["b"], device="cpu", block_cache=cache) as r:
        g = r.read_row_group(0)
    v = g[("b",)].values
    assert isinstance(v, ByteArrayData)
    assert bytes(v.data)[:2] == b"s0"


# -- slow: the reference's retry matrix over the reader --------------------------


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize(
    "faults",
    [
        dict(error_rate=0.4),
        dict(short_rate=0.4),
        dict(error_rate=0.25, short_rate=0.25),
        dict(error_rate=0.15, latency_s=0.0002),
    ],
)
def test_retry_matrix_typed_or_identical(pq_path, seed, faults):
    """Every (seed, fault mix): the port's read raises the typed SourceError
    (budget exhausted) or returns the clean read's bytes, and the outcome
    equals the reference's under the same seeds."""
    want = digest(read_all(JReader, pq_path, columns=["a"]))

    def run(m, flaky, reader_cls):
        src = m.RetryingSource(flaky(m.LocalFileSource(pq_path), seed=seed, **faults),
                               attempts=6, sleep=NOSLEEP, seed=seed)
        try:
            return ("ok", digest(read_all(reader_cls, src, columns=["a"])))
        except m.SourceError as e:
            return ("SourceError", str(e).split(" [last")[0])
        finally:
            src.close()

    got = run(pio, FlakySource, FileReader)
    assert got == run(jio, JFlaky, JReader)
    if got[0] == "ok":
        assert got[1] == want
