"""parquet_tpu_torch.data against the JAX package's parquet_tpu.data.

The same shard files go through the port's ParquetDataset (device="cpu":
CPU tensors) and the reference's (host NumPy batches). Pinned here, as
tests/test_dataset.py pins them for the reference:

  * the plan: glob order, unit layout, filter pruning, the same
    epoch_order as the reference for every (seed, epoch, shard);
  * sharding: every unit visited by exactly one shard per epoch (and the
    worker sub-split); shard="torch" reads the default process group;
  * the stream equals the reference's batch for batch (rebatched with a
    carry across units; remainder drop / keep / pad; nullable="zero";
    filter_rows);
  * a mid-epoch resume from state_dict() reproduces the rest of the
    stream byte for byte, as the reference's does;
  * the prefetch pipeline under two iterators on two threads, under a
    watchdog;
  * delivery through device_put_pipelined equals CPU delivery;
  * each cut option raises NotPortedError, naming its layer.
"""

import glob
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from parquet_tpu.data import ParquetDataset as JDataset  # noqa: E402
from parquet_tpu.data import build_plan as jbuild_plan  # noqa: E402

from parquet_tpu_torch.core.reader import PARQUET_ERRORS, FileReader  # noqa: E402
from parquet_tpu_torch.data import (  # noqa: E402
    NotPortedError,
    ParquetDataset,
    build_plan,
    dataset_counts,
    expand_paths,
    reset_dataset_counts,
)
from parquet_tpu_torch.meta.file_meta import ParquetFileError  # noqa: E402

WATCHDOG_SECONDS = 60.0
N_FILES = 5
ROWS = [700, 800, 900, 1000, 1100]  # per file; row_group_size=300 -> 3-4 units
ROW_GROUP = 300


def _write_shards(d, rows=ROWS, seed=0, nulls=False):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(rows):
        mask = (rng.random(n) < 0.2) if nulls else None
        t = pa.table({
            "x": pa.array(rng.standard_normal(n).astype(np.float32), mask=mask),
            "y": pa.array(rng.integers(0, 1 << 40, n).astype(np.int64)),
            "z": pa.array(rng.integers(0, 7, n).astype(np.int32)),
        })
        p = str(d / f"shard-{i:03d}.parquet")
        pq.write_table(t, p, row_group_size=ROW_GROUP)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dataset_shards")
    _write_shards(d)
    return d


@pytest.fixture(scope="module")
def pattern(shard_dir):
    return str(shard_dir / "shard-*.parquet")


def _source_rows(pattern, col="x"):
    return np.concatenate([pq.read_table(p).column(col).to_numpy() for p in sorted(glob.glob(pattern))])


def _drain(it):
    """Batches as {path: np.ndarray} (a tensor of the port, an array of the
    reference)."""
    return [{k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in b.items()}
            for b in it]


def _batches_equal(a, b):
    assert len(a) == len(b), (len(a), len(b))
    for ba, bb in zip(a, b):
        assert ba.keys() == bb.keys()
        for k in ba:
            assert ba[k].dtype == bb[k].dtype and ba[k].shape == bb[k].shape, k
            assert ba[k].tobytes() == bb[k].tobytes(), k


def _both(pattern, **kw):
    """The port's stream (device="cpu") and the reference's, drained."""
    got = _drain(iter(ParquetDataset(pattern, device="cpu", **kw)))
    want = _drain(iter(JDataset(pattern, **kw)))
    return got, want


def with_watchdog(fn, timeout: float = WATCHDOG_SECONDS):
    result: dict = {}

    def target():
        try:
            result["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
            result["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"watchdog: dataset still running after {timeout}s (hang)")
    if "error" in result:
        raise result["error"]
    return result.get("value")


class TestPlan:
    def test_units_and_rows_equal_the_reference(self, pattern):
        plan, jplan = build_plan(pattern), jbuild_plan(pattern)
        assert plan.num_units == jplan.num_units == sum(-(-n // ROW_GROUP) for n in ROWS)
        assert plan.total_rows == jplan.total_rows == sum(ROWS)
        assert [tuple(u) for u in plan.units] == [tuple(u) for u in jplan.units]
        assert plan.fingerprint() == jplan.fingerprint()
        assert [u.row_group for u in plan.units[:3]] == [0, 1, 2]

    def test_expand_paths_sorted_and_errors(self, pattern, shard_dir):
        files = expand_paths(pattern)
        assert files == sorted(files) and len(files) == N_FILES
        assert expand_paths(files[0]) == [files[0]]
        assert expand_paths(list(reversed(files))) == files
        with pytest.raises(FileNotFoundError):
            expand_paths(str(shard_dir / "nope-*.parquet"))
        with pytest.raises(FileNotFoundError):
            expand_paths(str(shard_dir / "nope.parquet"))
        with pytest.raises(ValueError):
            expand_paths([])

    @pytest.mark.parametrize("filters", [
        [("y", ">=", 0)], [("y", "<", -1)], [("z", "==", 3)], [("z", ">", 6)],
        [[("y", "<", 1 << 30)], [("z", "in", [0, 1])]],
    ])
    def test_filters_prune_like_the_reference(self, pattern, filters):
        plan, jplan = build_plan(pattern, filters=filters), jbuild_plan(pattern, filters=filters)
        assert [tuple(u) for u in plan.units] == [tuple(u) for u in jplan.units]
        assert plan.pruning_summary() == jplan.pruning_summary()

    def test_impossible_filter_prunes_every_unit(self, pattern):
        assert build_plan(pattern, filters=[("y", ">=", 0)]).num_units > 0
        plan = build_plan(pattern, filters=[("y", "<", -1)])
        assert plan.num_units == 0
        assert plan.pruning_summary()["units_pruned_stats"] == plan.units_total

    @pytest.mark.parametrize("seed", [0, 5])
    @pytest.mark.parametrize("epoch", [0, 3])
    def test_epoch_order_equals_the_reference(self, pattern, seed, epoch):
        plan, jplan = build_plan(pattern), jbuild_plan(pattern)
        for shuffle in (False, True):
            for count in (1, 2, 4):
                for i in range(count):
                    kw = dict(seed=seed, shuffle=shuffle, shard_index=i, shard_count=count)
                    assert plan.epoch_order(epoch, **kw) == jplan.epoch_order(epoch, **kw)

    def test_epoch_order_is_seed_epoch_function(self, pattern):
        plan = build_plan(pattern)
        a = plan.epoch_order(3, seed=5, shuffle=True)
        assert a == plan.epoch_order(3, seed=5, shuffle=True)
        assert a != plan.epoch_order(4, seed=5, shuffle=True)
        assert a != plan.epoch_order(3, seed=6, shuffle=True)
        assert sorted(a) == list(range(plan.num_units))
        with pytest.raises(ValueError):
            plan.epoch_order(0, shard_index=2, shard_count=2)

    @pytest.mark.parametrize("shuffle", [False, True])
    @pytest.mark.parametrize("count", [1, 2, 4])
    def test_shards_partition_exactly_once(self, pattern, shuffle, count):
        plan = build_plan(pattern)
        seen = []
        for i in range(count):
            seen.extend(plan.epoch_order(1, seed=2, shuffle=shuffle, shard_index=i,
                                         shard_count=count))
        assert sorted(seen) == list(range(plan.num_units))

    def test_worker_subsplit_partitions(self, pattern):
        plan = build_plan(pattern)
        units = []
        for si in range(2):
            for wi in range(2):
                ds = ParquetDataset(pattern, batch_size=64, shard=(si, 2), worker=(wi, 2),
                                    shuffle=True, seed=1, device="cpu")
                jds = JDataset(pattern, batch_size=64, shard=(si, 2), worker=(wi, 2),
                               shuffle=True, seed=1)
                assert ds.epoch_order(0) == jds.epoch_order(0)
                units.extend(ds.epoch_order(0))
        assert sorted(units) == list(range(plan.num_units))

    def test_open_metadata_and_reuse(self, pattern):
        p = sorted(glob.glob(pattern))[0]
        meta = FileReader.open_metadata(p)
        with FileReader(p, device="cpu") as r:
            assert meta.num_rows == r.metadata.num_rows
            with FileReader(p, metadata=meta, schema=r.schema, device="cpu") as r2:
                assert r2.num_rows == r.num_rows and r2.schema is r.schema
                assert r2.metadata is meta

    def test_open_many_is_all_or_nothing(self, pattern):
        files = sorted(glob.glob(pattern))
        readers = FileReader.open_many(files, device="cpu")
        assert [r.num_rows for r in readers] == [pq.read_table(p).num_rows for p in files]
        for r in readers:
            r.close()
            r.close()
        with pytest.raises(FileNotFoundError):
            FileReader.open_many(files + [files[0] + ".nope"], device="cpu")


class TestStream:
    @pytest.mark.parametrize("prefetch", [0, 2])
    def test_matches_the_reference_and_the_source(self, pattern, prefetch):
        got, want = _both(pattern, batch_size=256, prefetch=prefetch, remainder="keep")
        _batches_equal(got, want)
        gx = np.concatenate([b[("x",)] for b in got])
        assert np.array_equal(gx, _source_rows(pattern))
        assert all(b[("x",)].shape[0] == 256 for b in got[:-1])

    @pytest.mark.parametrize("remainder", ["drop", "keep", "pad"])
    @pytest.mark.parametrize("batch_size", [1, 299, 512, 450, 100_000])
    def test_remainder_modes_equal_the_reference(self, pattern, remainder, batch_size):
        got, want = _both(pattern, batch_size=batch_size, remainder=remainder,
                          columns=["x", "z"])
        _batches_equal(got, want)

    def test_remainder_shapes(self, pattern):
        total = sum(ROWS)
        b = 512
        full = total // b
        drop = _drain(iter(ParquetDataset(pattern, batch_size=b, device="cpu")))
        assert len(drop) == full
        keep = _drain(iter(ParquetDataset(pattern, batch_size=b, remainder="keep", device="cpu")))
        assert len(keep) == full + 1 and keep[-1][("x",)].shape[0] == total - full * b
        pad = _drain(iter(ParquetDataset(pattern, batch_size=b, remainder="pad", device="cpu")))
        assert len(pad) == full + 1 and pad[-1][("x",)].shape[0] == b
        tail = total - full * b
        assert np.all(pad[-1][("x",)][tail:] == 0)

    def test_multi_epoch_reshuffles_like_the_reference(self, pattern):
        got, want = _both(pattern, batch_size=300, shuffle=True, seed=4, num_epochs=2,
                          remainder="keep")
        _batches_equal(got, want)
        half = len(got) // 2
        e0 = np.concatenate([b[("y",)] for b in got[:half]])
        e1 = np.concatenate([b[("y",)] for b in got[half:]])
        assert not np.array_equal(e0, e1)
        assert np.array_equal(np.sort(e0), np.sort(e1))

    def test_nulls_raise_by_default_and_zero_fill(self, tmp_path):
        _write_shards(tmp_path, rows=[600, 650], nulls=True)
        pat = str(tmp_path / "shard-*.parquet")
        with pytest.raises(ParquetFileError, match="nulls"):
            _drain(iter(ParquetDataset(pat, batch_size=100, device="cpu")))
        got, want = _both(pat, batch_size=100, nullable="zero", remainder="keep")
        _batches_equal(got, want)

    @pytest.mark.parametrize("filters", [
        [("y", "<", 1 << 39)], [("z", "in", [1, 3])], [[("z", "==", 0)], [("y", ">", 1 << 39)]],
    ])
    def test_filter_rows_equals_the_reference(self, pattern, filters):
        got, want = _both(pattern, batch_size=128, columns=["x"], filters=filters,
                          filter_rows=True, remainder="keep")
        _batches_equal(got, want)
        assert all(list(b) == [("x",)] for b in got)

    def test_raw_byte_array_column_refused(self, tmp_path):
        p = tmp_path / "s.parquet"
        pq.write_table(pa.table({"s": pa.array([f"v{i}" for i in range(50)])}), p,
                       use_dictionary=False)
        with pytest.raises(ParquetFileError, match="raw byte array"):
            _drain(iter(ParquetDataset(str(p), batch_size=10, device="cpu")))

    def test_schema_mismatch_across_files(self, tmp_path):
        _write_shards(tmp_path, rows=[400])
        t = pa.table({"x": pa.array(np.arange(400, dtype=np.int32)),
                      "y": pa.array(np.arange(400, dtype=np.int64)),
                      "z": pa.array(np.arange(400, dtype=np.int32))})
        pq.write_table(t, tmp_path / "shard-zzz.parquet", row_group_size=200)
        ds = ParquetDataset(str(tmp_path / "shard-*.parquet"), batch_size=128, device="cpu")
        with pytest.raises(ParquetFileError, match="schema mismatch"):
            _drain(iter(ds))

    def test_bad_projection_and_filter_raise(self, pattern):
        ds = ParquetDataset(pattern, batch_size=128, columns=["nope"], device="cpu")
        with pytest.raises(ParquetFileError, match="not in schema"):
            ds.plan  # noqa: B018
        with pytest.raises(ValueError):
            build_plan(pattern, filters=[("nope", ">=", 0)])

    def test_closed_dataset_refuses_iteration(self, pattern):
        ds = ParquetDataset(pattern, batch_size=128, prefetch=2, device="cpu")
        it = iter(ds)
        next(it)
        it.close()
        ds.close()
        ds.close()  # idempotent
        with pytest.raises(RuntimeError, match="closed"):
            iter(ds)

    def test_config_validation(self, pattern):
        for kw in (dict(batch_size=0), dict(batch_size=8, remainder="nope"),
                   dict(batch_size=8, on_error="nope"), dict(batch_size=8, shard=(2, 2)),
                   dict(batch_size=8, prefetch=-1), dict(batch_size=8, nullable="mask"),
                   dict(batch_size=8, num_epochs=-1), dict(batch_size=8, filter_rows=True)):
            with pytest.raises(ValueError):
                ParquetDataset(pattern, device="cpu", **kw)
        with pytest.raises(ValueError, match='only shard= accepts "torch"'):
            ParquetDataset(pattern, batch_size=8, worker="torch", device="cpu")

    def test_no_cuda_and_no_device_raises(self, pattern):
        if torch.cuda.is_available():
            pytest.skip("a machine with CUDA delivers to it")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ParquetDataset(pattern, batch_size=8)

    def test_sync_path_records_wait(self, pattern):
        reset_dataset_counts()
        n = len(_drain(iter(ParquetDataset(pattern, batch_size=512, prefetch=0, device="cpu"))))
        c = dataset_counts()
        assert c["batches"] == n and c["rows"] == n * 512
        assert c["wait_seconds_count"] > 0 and c["wait_seconds_sum"] > 0


CUTS = [
    dict(on_error="skip"), dict(on_error="null", nullable="zero"), dict(cache_bytes=1 << 20),
    dict(cache_disk_bytes=1 << 20), dict(cache_dir="/nonexistent"), dict(block_cache=object()),
    dict(readahead_bytes=1 << 20), dict(io_autotune=True), dict(slo_wait_ms=5.0),
    dict(controller=object()), dict(device=[torch.device("cpu"), torch.device("cpu")]),
]


@pytest.mark.parametrize("kw", CUTS, ids=lambda kw: next(iter(kw)))
def test_cut_options_raise_not_ported(pattern, kw):
    kw = dict(kw)
    kw.setdefault("device", "cpu")
    with pytest.raises(NotPortedError, match="not ported"):
        ParquetDataset(pattern, batch_size=8, **kw)


@pytest.mark.parametrize("kw", [dict(on_error="skip"), dict(footer_cache=object()),
                                dict(block_cache=object())], ids=lambda kw: next(iter(kw)))
def test_plan_cut_options_raise_not_ported(pattern, kw):
    with pytest.raises(NotPortedError, match="not ported"):
        build_plan(pattern, **kw)


def test_unported_references_raise(tmp_path):
    (tmp_path / "table" / "_lake").mkdir(parents=True)
    with pytest.raises(NotPortedError, match="lake"):
        expand_paths(str(tmp_path / "table"))
    with pytest.raises(NotPortedError, match="io layer"):
        expand_paths("https://example.invalid/a.parquet")


class TestCheckpoint:
    @pytest.mark.parametrize("count", [1, 2, 4])
    @pytest.mark.parametrize("seed", [0, 7])
    def test_resume_byte_identical(self, pattern, count, seed):
        for index in range(count):
            kw = dict(batch_size=192, shuffle=True, seed=seed, shard=(index, count),
                      num_epochs=2, remainder="keep")
            it = iter(ParquetDataset(pattern, device="cpu", **kw))
            jit = iter(JDataset(pattern, **kw))
            head = []
            # cut mid-epoch, mid-unit: 192 does not divide the 300-row units
            for b in it:
                head.append(b)
                if len(head) == 3:
                    break
            for _ in range(3):
                next(jit)
            state = it.state_dict()
            jstate = jit.state_dict()
            assert {k: v for k, v in state.items() if k != "plan"} == {
                k: v for k, v in jstate.items() if k != "plan"}
            assert state["plan"] == jstate["plan"]
            rest = _drain(it)
            _batches_equal(rest, _drain(jit))
            it2 = ParquetDataset(pattern, device="cpu", prefetch=0, **kw).iterator(state=state)
            _batches_equal(rest, _drain(it2))

    def test_state_covers_delivered_batches_only(self, pattern):
        ds = ParquetDataset(pattern, batch_size=256, num_epochs=1, device="cpu")
        it = iter(ds)
        s0 = it.state_dict()
        assert (s0["epoch"], s0["unit_pos"], s0["row_offset"]) == (0, 0, 0)
        first = next(it)
        s1 = it.state_dict()
        it2 = ds.iterator(state=s1)
        _batches_equal(_drain(it), _drain(it2))
        replay = next(ds.iterator(state=s0))
        assert torch.equal(replay[("x",)], first[("x",)])

    def test_exhausted_state_resumes_empty(self, pattern):
        ds = ParquetDataset(pattern, batch_size=512, num_epochs=1, device="cpu")
        it = iter(ds)
        _drain(it)
        state = it.state_dict()
        assert state["exhausted"]
        assert _drain(ds.iterator(state=state)) == []

    def test_mismatched_config_rejected(self, pattern):
        state = iter(ParquetDataset(pattern, batch_size=128, device="cpu")).state_dict()
        for kw in ({"batch_size": 64}, {"batch_size": 128, "seed": 9, "shuffle": True},
                   {"batch_size": 128, "shard": (0, 2)}):
            with pytest.raises(ValueError, match="mismatch"):
                ParquetDataset(pattern, device="cpu", **kw).iterator(state=state)

    def test_changed_file_set_rejected_moved_dir_accepted(self, tmp_path):
        _write_shards(tmp_path, rows=[600, 600])
        pat = str(tmp_path / "shard-*.parquet")
        it = iter(ParquetDataset(pat, batch_size=100, remainder="keep", device="cpu"))
        for _ in range(3):
            next(it)
        state = it.state_dict()
        rest = _drain(it)
        moved = tmp_path / "moved"
        moved.mkdir()
        for p in sorted(tmp_path.glob("shard-*.parquet")):
            p.rename(moved / p.name)
        at_new_home = ParquetDataset(str(moved / "shard-*.parquet"), batch_size=100,
                                     remainder="keep", device="cpu")
        _batches_equal(rest, _drain(at_new_home.iterator(state=state)))
        (moved / "shard-000.parquet").rename(moved / "shard-009.parquet")
        renamed = ParquetDataset(str(moved / "shard-*.parquet"), batch_size=100,
                                 remainder="keep", device="cpu")
        with pytest.raises(ValueError, match="plan mismatch"):
            renamed.iterator(state=state)

    def test_started_iterator_rejects_load(self, pattern):
        it = iter(ParquetDataset(pattern, batch_size=128, device="cpu"))
        state = it.state_dict()
        next(it)
        with pytest.raises(RuntimeError):
            it.load_state_dict(state)


class TestPrefetch:
    def test_two_iterators_two_threads_watchdog(self, pattern):
        xs = _source_rows(pattern)

        def run():
            ds = ParquetDataset(pattern, batch_size=128, prefetch=2, remainder="keep",
                                device="cpu")
            out = [None, None]
            errs = []

            def worker(slot):
                try:
                    out[slot] = np.concatenate([b[("x",)].numpy() for b in ds])
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)

            ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(WATCHDOG_SECONDS)
            assert not errs, errs
            return out

        for got in with_watchdog(run):
            assert got is not None and np.array_equal(got, xs)

    def test_close_mid_stream_cancels(self, pattern):
        ds = ParquetDataset(pattern, batch_size=100, prefetch=3, device="cpu")
        it = iter(ds)
        next(it)
        it.close()
        with pytest.raises(StopIteration):
            next(it)
        ds.close()
        ds.close()

    def test_counts_and_gauge(self, pattern):
        import gc

        gc.collect()  # iterators other tests dropped give their units back
        reset_dataset_counts()
        depth = dataset_counts().get("prefetch_depth", 0)
        n = with_watchdog(lambda: len(_drain(iter(ParquetDataset(
            pattern, batch_size=512, prefetch=2, device="cpu")))))
        c = dataset_counts()
        assert c["batches"] == n and c["rows"] == n * 512
        assert c["wait_seconds_count"] > 0
        # the gauge is back where it was once the stream is drained
        assert c.get("prefetch_depth", 0) == depth

    def test_pools_stay_apart(self, pattern):
        """Units decode on pqt-data threads, never on the reader's pqt-host
        pool (a unit that fanned out into its own pool would deadlock)."""
        from parquet_tpu_torch.data import dataset as tds

        seen = set()
        load = tds.DatasetIterator._load_unit

        def spy(self, unit, off):
            seen.add(threading.current_thread().name.split("_")[0])
            return load(self, unit, off)

        tds.DatasetIterator._load_unit = spy
        try:
            with_watchdog(lambda: _drain(iter(ParquetDataset(pattern, batch_size=512,
                                                             prefetch=2, device="cpu"))))
        finally:
            tds.DatasetIterator._load_unit = load
        assert seen == {"pqt-data"}


class TestDelivery:
    def test_pipelined_delivery_equals_cpu_delivery(self, pattern, monkeypatch):
        """The CUDA route's delivery (device_put_pipelined at depth 2 on the
        dispatch thread), pointed at the CPU, equals CPU delivery batch for
        batch, and the checkpoints it commits are the same."""
        from parquet_tpu_torch.data import dataset as tds
        from parquet_tpu_torch.kernels import pipeline as tpipe

        calls = []
        real = tpipe.device_put_pipelined

        def spy(batches, device=None, depth=2):
            calls.append(depth)
            return real(batches, "cpu", depth=depth)

        kw = dict(batch_size=256, shuffle=True, seed=3, remainder="keep", num_epochs=2)
        want_it = iter(ParquetDataset(pattern, device="cpu", **kw))
        want = []
        want_states = []
        for b in want_it:
            want.append(b)
            want_states.append(want_it.state_dict())
        ds = ParquetDataset(pattern, device="cpu", **kw)
        monkeypatch.setattr(tds, "device_put_pipelined", spy)
        monkeypatch.setattr(ds, "device", torch.device("cuda"))
        it = iter(ds)
        got = []
        states = []

        def drain():
            for b in it:
                got.append(b)
                states.append(it.state_dict())

        with_watchdog(drain)
        assert calls == [2]
        _batches_equal(_drain(got), _drain(want))
        assert states == want_states

    def test_shard_torch_reads_the_default_group(self, pattern, monkeypatch):
        import torch.distributed as dist

        with pytest.raises(RuntimeError, match="process group"):
            ParquetDataset(pattern, batch_size=8, shard="torch", device="cpu")
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_rank", lambda: 1)
        monkeypatch.setattr(dist, "get_world_size", lambda: 3)
        ds = ParquetDataset(pattern, batch_size=8, shard="torch", device="cpu")
        assert (ds.shard_index, ds.shard_count) == (1, 3)
        assert ds.epoch_order(0) == build_plan(pattern).epoch_order(0, shard_index=1,
                                                                    shard_count=3)

    @pytest.mark.parametrize("count", [2, 4])
    def test_shards_deliver_every_row_once(self, pattern, count):
        ys = []
        for k in range(count):
            ds = ParquetDataset(pattern, batch_size=64, shard=(k, count), remainder="keep",
                                shuffle=True, seed=2, device="cpu")
            jds = JDataset(pattern, batch_size=64, shard=(k, count), remainder="keep",
                           shuffle=True, seed=2)
            got = _drain(iter(ds))
            _batches_equal(got, _drain(iter(jds)))
            ys.extend(b[("y",)] for b in got)
        assert np.array_equal(np.sort(np.concatenate(ys)), np.sort(_source_rows(pattern, "y")))


def test_raise_policy_propagates(tmp_path):
    paths = _write_shards(tmp_path, rows=[500])
    meta = FileReader.open_metadata(paths[0])
    cc = meta.row_groups[0].columns[0].meta_data
    with open(paths[0], "r+b") as f:
        f.seek(cc.data_page_offset + 16)
        f.write(b"\xff" * 64)
    ds = ParquetDataset(str(tmp_path / "*.parquet"), batch_size=100, device="cpu")
    with pytest.raises(PARQUET_ERRORS):
        with_watchdog(lambda: _drain(iter(ds)))
