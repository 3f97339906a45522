"""The overlap layer on the CPU: the pipelined reads against the serial ones
and the JAX package's.

The port prepares chunks on the "pqt-host" pool (PQT_HOST_THREADS) and
uploads and launches them on the "pqt-dispatch" thread (on a CUDA stream of
its own on the card; plainly here, with device="cpu"). Pinned here:

* read_row_groups_device, read_row_group_device(filters=) and
  iter_device_batches (plain, nullable="mask", lists="pad",
  filter_rows=True) with a pool of 4 equal the serial read
  (PQT_HOST_THREADS=1) and the JAX package's read on CPU jax, exactly;
* DecodeStats, prepare_counts() and filter_counts() totals equal the serial
  read's;
* the prepares run on pqt-host threads and every dispatch on pqt-dispatch;
* device_put_pipelined keeps order at depths 0, 1 and 3, defers a source
  error to its position and surfaces an upload error at its batch;
* two readers on two threads read equal, and a corrupt chunk raises its
  typed error through the pool.

Every test that runs the pools runs under a watchdog (a daemon thread
joined with a timeout), so a deadlock fails instead of hanging the run.
"""

import threading
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402

from parquet_tpu_torch import FileReader, filter_counts, reset_filter_counts  # noqa: E402
from parquet_tpu_torch.core import reader as treader  # noqa: E402
from parquet_tpu_torch.core.compress import _REGISTRY  # noqa: E402
from parquet_tpu_torch.kernels import pipeline as tpipe  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import CompressionCodec as C  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Encoding as E  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Type as T  # noqa: E402
from parquet_tpu_torch.testing.parity import batches_to_numpy, to_numpy  # noqa: E402
from parquet_tpu_torch.testing.synth import ColumnSpec, write_file  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "data"
GOLDEN_READABLE = [
    "alltypes_plain_v1_none.parquet",
    "alltypes_v2_gzip.parquet",
    "delta_byte_array.parquet",
    "dict_overflow_mixed_pages.parquet",
    "multi_rowgroup_small_pages.parquet",
    "nulls_heavy.parquet",
    "foreign_zero_row.parquet",
]
WATCHDOG_S = 120.0
MAX_LEN = 8
POOL = 4


def watch(fn, timeout: float = WATCHDOG_S):
    """fn() on a daemon thread joined with a timeout: a hang fails."""
    out: dict = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised on this thread
            out["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"watchdog: still running after {timeout} s (a hang)")
    if "error" in out:
        raise out["error"]
    return out.get("value")


@pytest.fixture
def threads(monkeypatch):
    """set(n): PQT_HOST_THREADS for the calls that follow."""
    return lambda n: monkeypatch.setenv("PQT_HOST_THREADS", str(n))


def _arrow_file(path, n, group):
    """id, a float64 with nulls in the first and last groups, a dictionary
    string, a DELTA int64, a float32 and a LIST<int32> with null and empty
    lists; small pages, several groups."""
    rng = np.random.default_rng(n)
    lists = [
        None if i % 13 == 0 else [int(x) for x in rng.integers(-99, 99, i % (MAX_LEN + 1))]
        for i in range(n)
    ]
    x = rng.standard_normal(n)
    nulls_at = [(i < group or i >= n - group // 2) and i % 7 == 0 for i in range(n)]
    table = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "x": pa.array([None if z else float(v) for z, v in zip(nulls_at, x)], pa.float64()),
        "s": pa.array([f"key-{i % 37}" for i in range(n)]),
        "d": pa.array(np.cumsum(rng.integers(-5, 100, n)).astype(np.int64)),
        "f": pa.array(rng.standard_normal(n).astype(np.float32)),
        "tags": pa.array(lists, pa.list_(pa.int32())),
    })
    pq.write_table(table, path, row_group_size=group, data_page_size=2048,
                   use_dictionary=["s", "f", "tags"],
                   column_encoding={"d": "DELTA_BINARY_PACKED", "id": "PLAIN", "x": "PLAIN"},
                   write_statistics=True)
    return path


def _synth_file(path, n, group):
    """The port's synth writer: a dictionary LIST (V2, SNAPPY), an optional
    dictionary int32 (GZIP) and a DELTA int64, with chunk statistics."""
    rng = np.random.default_rng(n + 1)
    valid = rng.random(n) > 0.08
    lengths = np.where(valid, rng.integers(0, MAX_LEN + 1, n), 0)
    opt_valid = rng.random(n) > 0.2
    specs = [
        ColumnSpec("items", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.SNAPPY, page_version=2,
                   valid=valid, list_lengths=lengths, dictionary=np.arange(500, dtype=np.int32) * 3,
                   indices=rng.integers(0, 500, int(lengths.sum())).astype(np.int32)),
        ColumnSpec("opt", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.GZIP, valid=opt_valid,
                   dictionary=np.arange(9, dtype=np.int32),
                   indices=rng.integers(0, 9, int(opt_valid.sum())).astype(np.int32)),
        ColumnSpec("ts", T.INT64, encoding=E.DELTA_BINARY_PACKED, page_version=2,
                   values=np.cumsum(rng.integers(-5, 100, n)).astype(np.int64)),
    ]
    write_file(path, specs, row_group_rows=group, page_bytes=1024)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("overlap")
    return {
        "arrow": _arrow_file(d / "arrow.parquet", 2300, 400),
        "synth": _synth_file(d / "synth.parquet", 1700, 300),
    }


def _file(files, name):
    return files[name] if name in files else GOLDEN / name


def _cols_equal(a: dict, b: dict) -> None:
    """Two {path: DeviceColumn} groups (the port's, or the port's and the
    JAX package's) field by field, bytes and dtypes."""
    assert a.keys() == b.keys()
    for p in a:
        x = to_numpy(a[p])
        y = b[p]
        assert x["num_values"] == y.num_values, p
        for f in ("values", "indices", "data", "offsets", "dict_data", "dict_offsets"):
            u = x[f]
            v = getattr(y, f)
            if isinstance(v, torch.Tensor):
                v = v.numpy()
            assert (u is None) == (v is None), (p, f)
            if u is not None:
                v = np.asarray(v)
                if f == "data" and u.shape != v.shape:
                    # a mixed byte chunk's merged payload is sized to its
                    # bound in the port and to a bucket in the JAX program:
                    # the bytes past the last offset are unspecified
                    end = int(x["offsets"][-1])
                    u, v = u[:end], v[:end]
                assert (u.dtype, u.shape) == (v.dtype, v.shape), (p, f)
                assert u.tobytes() == v.tobytes(), (p, f)
        for f in ("def_levels", "rep_levels"):
            u, v = x[f], getattr(y, f)
            assert (u is None) == (v is None), (p, f)
            if u is not None:
                np.testing.assert_array_equal(u, np.asarray(v))


def _read(path, **kw):
    with FileReader(path, device="cpu") as r:
        groups = r.read_row_groups_device(**kw)
        return groups, r.stats


READS = GOLDEN_READABLE + ["arrow", "synth"]


@pytest.mark.parametrize("name", READS)
def test_pipelined_read_equals_serial_and_jax(files, threads, name):
    path = _file(files, name)
    threads(1)
    serial, serial_stats = _read(path)
    threads(POOL)
    assert treader._host_pool() is not None
    piped, piped_stats = watch(lambda: _read(path))
    assert len(piped) == len(serial)
    for a, b in zip(piped, serial):
        _cols_equal(a, b)
    assert piped_stats == serial_stats
    with JReader(str(path), backend="tpu") as jr:
        for i, g in enumerate(piped):
            _cols_equal(g, jr.read_row_group_device(i))


def test_prepare_on_host_pool_and_dispatch_on_its_thread(files, threads, monkeypatch):
    names = {"prepare": set(), "dispatch": set()}
    prep = treader.prepare_chunk_plan
    dispatch = tpipe._ChunkPlan.dispatch_device

    def spy_prep(*a, **k):
        names["prepare"].add(threading.current_thread().name.split("_")[0])
        return prep(*a, **k)

    def spy_dispatch(self, device):
        names["dispatch"].add(threading.current_thread().name.split("_")[0])
        return dispatch(self, device)

    monkeypatch.setattr(treader, "prepare_chunk_plan", spy_prep)
    monkeypatch.setattr(tpipe._ChunkPlan, "dispatch_device", spy_dispatch)
    threads(POOL)
    watch(lambda: _read(files["arrow"]))
    assert names == {"prepare": {"pqt-host"}, "dispatch": {"pqt-dispatch"}}
    names["prepare"].clear()
    names["dispatch"].clear()
    threads(1)
    caller = watch(lambda: (_read(files["arrow"]), threading.current_thread().name)[1])
    # serial prepare runs on the calling thread; dispatch stays on its own
    assert names == {"prepare": {caller.split("_")[0]}, "dispatch": {"pqt-dispatch"}}


FILTERS = {
    "arrow": [("d", ">=", 20_000), ("id", "<", 2000)],
    "synth": [[("ts", "<", 30_000)], [("opt", "==", 3)]],
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filtered_group_read_equals_serial_and_jax(files, threads, name):
    path = files[name]
    flt = FILTERS[name]

    def read():
        with FileReader(path, device="cpu") as r:
            return [r.read_row_group_device(i, filters=flt) for i in range(r.num_row_groups)]

    threads(1)
    serial = read()
    threads(POOL)
    piped = watch(read)
    with JReader(str(path), backend="tpu") as jr:
        for i, ((cols, mask), (scols, smask)) in enumerate(zip(piped, serial)):
            _cols_equal(cols, scols)
            assert torch.equal(mask, smask)
            jcols, jmask = jr.read_row_group_device(i, filters=flt)
            _cols_equal(cols, jcols)
            np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


BATCH_MODES = {
    "plain": ("arrow", dict(batch_size=333, columns=["id", "s", "d", "f"])),
    "mask": ("arrow", dict(batch_size=250, columns=["id", "x", "d"], nullable="mask",
                           drop_remainder=False)),
    "pad": ("synth", dict(batch_size=200, lists="pad", max_list_len=MAX_LEN, nullable="mask",
                          drop_remainder=False)),
    "filter_rows": ("arrow", dict(batch_size=128, columns=["id", "x", "tags"], nullable="mask",
                                  lists="pad", max_list_len=MAX_LEN,
                                  filters=[("d", ">=", 20_000), ("id", "<", 2000)],
                                  filter_rows=True, drop_remainder=False)),
}


def _batches(path, kw):
    with FileReader(path, device="cpu") as r:
        return [batches_to_numpy(b) for b in r.iter_device_batches(**kw)]


def _batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert (x[k].dtype, x[k].shape) == (y[k].dtype, y[k].shape), k
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("mode", sorted(BATCH_MODES))
def test_batch_stream_equals_serial_and_jax(files, threads, mode):
    name, kw = BATCH_MODES[mode]
    path = files[name]
    threads(1)
    serial = _batches(path, kw)
    threads(POOL)
    piped = watch(lambda: _batches(path, kw))
    _batches_equal(piped, serial)
    with JReader(str(path)) as jr:
        want = [batches_to_numpy(b) for b in jr.iter_device_batches(**kw)]
    _batches_equal(piped, want)
    assert len(piped) > 2


def test_counters_equal_the_serial_read(files, threads):
    """DecodeStats, prepare_counts() and filter_counts() are bumped from the
    pool's and the dispatch thread's threads; their totals equal the serial
    read's."""

    def run():
        tpipe.reset_prepare_counts()
        reset_filter_counts()
        stats = []
        for name in ("arrow", "synth"):
            with FileReader(files[name], device="cpu") as r:
                r.read_row_groups_device()
                for _ in r.iter_device_batches(**BATCH_MODES["filter_rows"][1]) if (
                        name == "arrow") else ():
                    pass
                stats.append(r.stats)
        return stats, tpipe.prepare_counts(), filter_counts()

    threads(1)
    serial = run()
    threads(POOL)
    piped = watch(run)
    assert piped == serial
    assert serial[1].get("prepare_fused_engaged", 0) > 0
    assert serial[2].get("device_filter_engaged", 0) > 0


def test_two_readers_on_two_threads_read_equal(files, threads):
    threads(1)
    want = {n: _read(files[n])[0] for n in files}
    threads(POOL)
    got: dict = {}
    errs: list = []

    def worker(name):
        try:
            for _ in range(3):
                got.setdefault(name, []).append(_read(files[name])[0])
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    def run():
        ts = [threading.Thread(target=worker, args=(n,)) for n in files]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WATCHDOG_S)

    watch(run)
    assert not errs, errs
    for name, reads in got.items():
        assert len(reads) == 3
        for groups in reads:
            for a, b in zip(groups, want[name]):
                _cols_equal(a, b)


def test_settle_on_a_pool_thread_does_not_wait_on_its_own_queue(threads):
    """A batch stream dropped in a reference cycle is finalized wherever the
    garbage collector runs, the dispatch thread included: its settle there
    must not wait on dispatch work queued behind that very thread."""
    threads(POOL)
    ready = threading.Event()
    queued: list = []

    def settle_here():
        ready.wait(WATCHDOG_S)
        treader._settle([[("x", queued[0])]])
        return tpipe.on_pool_thread()

    first = tpipe.dispatch(settle_here, "cpu")
    queued.append(tpipe.dispatch(lambda: "after", "cpu"))
    ready.set()
    assert first.result(timeout=WATCHDOG_S) is True
    assert queued[0].result(timeout=WATCHDOG_S) == "after"
    assert treader._host_pool().submit(tpipe.on_pool_thread).result(timeout=WATCHDOG_S)
    assert not tpipe.on_pool_thread()


def test_corrupt_chunk_raises_typed_through_the_pool(files, threads, tmp_path):
    raw = bytearray(Path(files["arrow"]).read_bytes())
    with FileReader(files["arrow"], device="cpu") as r:
        md = r.row_group(1).columns[0].meta_data
    off = md.dictionary_page_offset or md.data_page_offset
    raw[off : off + 24] = b"\xff" * 24
    bad = tmp_path / "bad.parquet"
    bad.write_bytes(bytes(raw))
    threads(POOL)
    with pytest.raises(treader.PARQUET_ERRORS):
        watch(lambda: _read(bad))
    threads(1)
    with pytest.raises(treader.PARQUET_ERRORS):
        watch(lambda: _read(bad))


class _Zstd:
    """A ZSTD codec over zstandard, one (de)compressor per thread."""

    name = "ZSTD"

    def __init__(self):
        self._tl = threading.local()

    def _get(self):
        import zstandard

        if not hasattr(self._tl, "d"):
            self._tl.d = zstandard.ZstdDecompressor()
        return self._tl.d

    def decompress(self, data, uncompressed_size):
        return self._get().decompress(bytes(data), max_output_size=max(uncompressed_size, 1))


def test_codec_override_under_the_pool(threads, monkeypatch):
    """A registered codec declines the fused walk, so the staged walk runs
    it from several prepare threads at once."""
    monkeypatch.setitem(_REGISTRY, int(C.ZSTD), _Zstd())
    path = GOLDEN / "alltypes_zstd_v2_nodict.parquet"
    threads(1)
    serial, _ = _read(path)
    threads(POOL)
    for _ in range(3):
        piped, _ = watch(lambda: _read(path))
        for a, b in zip(piped, serial):
            _cols_equal(a, b)


# -- device_put_pipelined --------------------------------------------------------


def _source(n):
    for k in range(n):
        yield {"a": np.arange(4 * k, 4 * k + 4, dtype=np.int64), "b": None,
               "c": np.full(3, k, dtype=np.float32)}


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_device_put_pipelined_keeps_order(depth):
    got = watch(lambda: list(tpipe.device_put_pipelined(_source(7), "cpu", depth=depth)))
    assert len(got) == 7
    for k, b in enumerate(got):
        assert b["b"] is None
        assert isinstance(b["a"], torch.Tensor) and b["a"].tolist() == list(range(4 * k, 4 * k + 4))
        assert b["c"].dtype == torch.float32 and b["c"].tolist() == [k] * 3


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_device_put_pipelined_defers_source_error(depth):
    """A source failure surfaces where it happened: the batches before it
    are yielded first (the reference's tests/test_dataset.py contract)."""

    def src():
        yield {"a": np.arange(4)}
        yield {"a": np.arange(4, 8)}
        raise RuntimeError("boom")

    def run():
        got = []
        with pytest.raises(RuntimeError, match="boom"):
            for b in tpipe.device_put_pipelined(src(), "cpu", depth=depth):
                got.append(b["a"].tolist())
        return got

    assert watch(run) == [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.mark.parametrize("depth", [0, 2])
def test_device_put_pipelined_upload_error_at_its_batch(depth):
    """An upload that fails (an object array has no tensor form) raises at
    the yield of its own batch, after the batches before it."""

    def src():
        yield {"a": np.arange(3)}
        yield {"a": np.array(["x", None], dtype=object)}
        yield {"a": np.arange(3, 6)}

    def run():
        got = []
        with pytest.raises(TypeError):
            for b in tpipe.device_put_pipelined(src(), "cpu", depth=depth):
                got.append(b["a"].tolist())
        return got

    assert watch(run) == [[0, 1, 2]]


def test_device_put_pipelined_matches_the_reference_on_cpu():
    from parquet_tpu.kernels.pipeline import device_put_pipelined as jput

    want = [{k: None if v is None else np.asarray(v) for k, v in b.items()}
            for b in jput(_source(5), depth=2)]
    got = watch(lambda: list(tpipe.device_put_pipelined(_source(5), "cpu", depth=2)))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if w[k] is None:
                assert g[k] is None
            else:
                assert g[k].numpy().tobytes() == w[k].tobytes()


def test_cuda_paths_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a machine with CUDA takes the CUDA path")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(tpipe.device_put_pipelined(_source(1)))
    with pytest.raises(ValueError):
        tpipe.dispatch_stream("cpu")
    assert tpipe.record_event("cpu") is None
    # a CPU target's handoff is a no-op
    tpipe.handoff(None, [torch.zeros(1)], "cpu")


def test_counters_survive_a_thread_stress():
    """More threads than cores bump one DecodeStats, the prepare counters
    and a launch counter at once, under a short switch interval: no update
    is lost (`x.n += k` alone would lose some)."""
    import sys

    from parquet_tpu_torch.kernels import device_ops as ops

    def kernel():
        pass

    kernel.launches = 0
    kernel.by_width = {}
    stats = tpipe.DecodeStats()
    n_threads, n_iter = 24, 2000
    before = tpipe.prepare_counts().get("stress_probe", 0)

    def work(k):
        for _ in range(n_iter):
            stats.add(pages=1, device_values=3)
            ops._count(kernel, 1, "by_width", k % 3)
            tpipe._bump("stress_probe")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WATCHDOG_S)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n_iter
    assert (stats.pages, stats.device_values) == (total, 3 * total)
    assert kernel.launches == total and sum(kernel.by_width.values()) == total
    assert tpipe.prepare_counts()["stress_probe"] - before == total
