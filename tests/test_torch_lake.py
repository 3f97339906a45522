"""parquet_tpu_torch.lake against the JAX package's parquet_tpu.lake, as
tests/test_lake.py pins the reference: the snapshot manifest, streaming
ingest, the compactor, and lake references in the dataset's plan.

Each scenario runs once per package, in a directory of its own, under one
fake clock each (the same sequence), and the two tables must agree: every
_lake document (TABLE.json, CURRENT, each gen-N.json) as equal JSON, every
data file byte for byte, LakeError codes and texts, ingest acks and
CompactionResults. Data file names carry the pid and each package's own
file counter, so they are compared mapped, in order of first appearance.
The concurrency hammer runs on the port alone, scaled down, every join under
a watchdog."""

import json
import os
import re
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu import lake as jlake  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.data import ParquetDataset as JDataset  # noqa: E402
from parquet_tpu.data import build_plan as jbuild_plan  # noqa: E402
from parquet_tpu.data import expand_paths as jexpand_paths  # noqa: E402
from parquet_tpu.utils import metrics  # noqa: E402

from parquet_tpu_torch import lake  # noqa: E402
from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.data import ParquetDataset, build_plan, expand_paths  # noqa: E402
from parquet_tpu_torch.lake import (  # noqa: E402
    Compactor,
    IngestWriter,
    LakeError,
    LakeTable,
    lake_counts,
    reset_lake_counts,
)

GOLDEN = Path(__file__).parent / "golden" / "data"
WATCHDOG_S = 30.0
SCHEMA = "message m { required int64 k; optional binary v (STRING); }"
JAX = types.SimpleNamespace(name="jax", lake=jlake)
PORT = types.SimpleNamespace(name="torch", lake=lake)
PACKAGES = (JAX, PORT)
NAME = re.compile(r"(ingest|compact)-\d+-\d+\.parquet")


class FakeClock:
    """A clock that ticks one second a call: the same sequence in each
    package's run, so created_unix fields compare equal."""

    def __init__(self, start=1_760_000_000.0):
        self.t = start

    def __call__(self):
        self.t += 1.0
        return self.t


def _rows(base, n):
    return [{"k": base + i, "v": f"v{base + i}"} for i in range(n)]


def _interleaved(flushes, rows_per):
    # interleaved key ranges: every pre-compaction file spans the keys
    return [[{"k": j * flushes + i, "v": f"r{i}.{j}"} for j in range(rows_per)]
            for i in range(flushes)]


def _scan_rows(paths):
    out = []
    for p in paths:
        with FileReader(p, device="cpu") as r:
            out.extend(r.iter_rows())
    return out


def table_state(root) -> dict:
    """Every _lake document and data file of a table, data file names
    mapped to their order of first appearance (gens ascending, then the
    rest sorted), so two packages' tables compare."""
    lake_dir, data_dir = os.path.join(root, "_lake"), os.path.join(root, "data")
    docs = {}
    for name in sorted(os.listdir(lake_dir)):
        with open(os.path.join(lake_dir, name)) as f:
            docs[name] = json.load(f)
    order = []
    for name in sorted(docs):
        for entry in docs[name].get("files", []):
            base = os.path.basename(entry["path"])
            if base not in order:
                order.append(base)
    on_disk = sorted(os.listdir(data_dir)) if os.path.isdir(data_dir) else []
    order += [n for n in on_disk if n not in order]
    names = {n: f"{NAME.match(n).group(1) if NAME.match(n) else n}#{i}"
             for i, n in enumerate(order)}

    def mapped(text):
        return NAME.sub(lambda m: names.get(m.group(0), m.group(0)), text)

    return {
        "docs": json.loads(mapped(json.dumps(docs))),
        "data": {names[n]: open(os.path.join(data_dir, n), "rb").read() for n in on_disk},
    }


def both(tmp_path, scenario, **create):
    """scenario(pkg, table, clock) on a fresh table of each package; returns
    {package name: (scenario's result, table state)}."""
    create.setdefault("sort_key", "k")
    got = {}
    for pkg in PACKAGES:
        clock = FakeClock()
        root = str(tmp_path / pkg.name / "t")
        table = pkg.lake.LakeTable.create(root, SCHEMA, clock=clock, **create)
        got[pkg.name] = (scenario(pkg, table, clock), table_state(table.root))
    return got


def same(got):
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][0] == got["jax"][0]
    return got["torch"]


def lake_error(fn, root=None):
    """(code, text) of the LakeError fn() raises, the table root masked and
    data file names mapped to their kind."""
    with pytest.raises(Exception) as ei:
        fn()
    assert type(ei.value).__name__ == "LakeError"
    text = str(ei.value)
    if root is not None:
        text = text.replace(os.path.realpath(root), "<root>")
    return ei.value.code, NAME.sub(lambda m: m.group(1), text)


# -- the reader's file metadata -------------------------------------------------


@pytest.mark.parametrize("name", sorted(p.name for p in GOLDEN.glob("*.parquet")))
def test_reader_file_metadata_matches_jax(name):
    """FileReader.created_by and .key_value_metadata (the lake reads its
    data files' "parquet_tpu.lake" key through them) on the golden files:
    footers only, so every codec's file opens."""
    with FileReader(str(GOLDEN / name), device="cpu") as r, JReader(str(GOLDEN / name)) as jr:
        assert r.created_by == jr.created_by
        assert r.key_value_metadata == jr.key_value_metadata


# -- manifest ------------------------------------------------------------------


class TestManifest:
    def test_empty_table_is_generation_zero(self, tmp_path):
        def scenario(pkg, t, clock):
            snap = t.manifest.open_snapshot()
            return (t.manifest.current_generation(), snap.generation, snap.files,
                    t.snapshot_paths(), pkg.lake.is_lake_table(t.root))

        res, _ = same(both(tmp_path, scenario))
        assert res == (0, 0, (), [], False)

    def test_commit_points_and_time_travel(self, tmp_path):
        def scenario(pkg, t, clock):
            w = pkg.lake.IngestWriter(t, parallel=False, clock=clock)
            for base in (0, 100, 200):
                w.append(_rows(base, 10), flush=True)
            m = t.manifest
            snaps = [(s.generation, len(s.files), s.total_rows, s.parent)
                     for s in map(m.open_snapshot, (1, 2, 3))]
            return (m.current_generation(), m.generations(), snaps,
                    lake_error(lambda: m.open_snapshot(9)))

        res, _ = same(both(tmp_path, scenario))
        assert res[:3] == (3, [1, 2, 3], [(1, 1, 10, None), (2, 2, 20, 1), (3, 3, 30, 2)])
        assert res[3][0] == "no_such_generation"

    def test_expect_generation_conflict_is_typed(self, tmp_path):
        def scenario(pkg, t, clock):
            pkg.lake.IngestWriter(t, parallel=False).append(_rows(0, 5), flush=True)
            return lake_error(lambda: t.manifest.commit(add=[], expect_generation=0))

        assert same(both(tmp_path, scenario))[0][0] == "commit_conflict"

    def test_remove_unreferenced_and_double_add_are_typed(self, tmp_path):
        def scenario(pkg, t, clock):
            pkg.lake.IngestWriter(t, parallel=False).append(_rows(0, 5), flush=True)
            rel = t.manifest.open_snapshot().files[0].path
            return (
                lake_error(lambda: t.manifest.commit(remove=["data/never-was.parquet"])),
                lake_error(lambda: t.manifest.commit(add=[pkg.lake.FileEntry(rel, 1, 1)])),
            )

        res, _ = same(both(tmp_path, scenario))
        assert [code for code, _ in res] == ["commit_conflict"] * 2

    @pytest.mark.parametrize("bad", ["/etc/passwd", "../outside.parquet", "a/../../b", ""])
    def test_manifest_paths_are_confined(self, tmp_path, bad):
        def scenario(pkg, t, clock):
            return lake_error(lambda: t.manifest.commit(add=[pkg.lake.FileEntry(bad, 1, 1)]))

        assert same(both(tmp_path, scenario))[0][0] == "bad_manifest"

    def test_retention_drops_old_gens_but_keeps_referenced_files(self, tmp_path):
        def scenario(pkg, t, clock):
            w = pkg.lake.IngestWriter(t, parallel=False)
            for base in range(0, 50, 10):
                w.append(_rows(base, 10), flush=True)
            m = t.manifest
            referenced = {os.path.basename(f.path) for g in m.generations()
                          for f in m.open_snapshot(g).files}
            on_disk = {n for n in os.listdir(m.data_dir) if n.endswith(".parquet")}
            return (m.generations(), m.open_snapshot(4).total_rows,
                    lake_error(lambda: m.open_snapshot(1)), on_disk == referenced)

        res, _ = same(both(tmp_path, scenario, retain=2))
        assert res[0] == [4, 5] and res[1] == 40 and res[2][0] == "no_such_generation"
        assert res[3] is True

    def test_open_bad_table_is_typed(self, tmp_path):
        got = {}
        for pkg in PACKAGES:
            root = tmp_path / pkg.name
            root.mkdir()
            L = pkg.lake
            errs = [lake_error(lambda: L.LakeTable.open(str(root / "nope")), root),
                    lake_error(lambda: L.LakeTable.create(str(root / "t"), SCHEMA,
                                                          sort_key="zz"), root)]
            L.LakeTable.create(str(root / "t"), SCHEMA, sort_key="k")
            errs.append(lake_error(lambda: L.LakeTable.create(str(root / "t"), SCHEMA), root))
            # a corrupt CURRENT, and a gen file that claims another number
            lake_dir = root / "t" / "_lake"
            (lake_dir / "CURRENT").write_text("{not json")
            m = L.LakeTable.open(str(root / "t")).manifest
            errs.append(lake_error(m.current_generation, root))
            (lake_dir / "CURRENT").write_text('{"generation": 2}')
            (lake_dir / "gen-00000002.json").write_text('{"generation": 3, "files": []}')
            errs.append(lake_error(m.open_snapshot, root))
            (lake_dir / "TABLE.json").write_text('{"schema": "message m { bogus"}')
            errs.append(lake_error(lambda: L.LakeTable.open(str(root / "t")), root))
            got[pkg.name] = errs
        assert got["torch"] == got["jax"]
        assert [c for c, _ in got["torch"]] == [
            "no_such_table", "bad_schema", "table_exists", "bad_manifest", "bad_manifest",
            "bad_manifest"]

    def test_table_reopens_with_its_identity(self, tmp_path):
        def scenario(pkg, t, clock):
            pkg.lake.IngestWriter(t, parallel=False).append(_rows(0, 3), flush=True)
            again = pkg.lake.LakeTable.open(t.root)
            return (again.sort_key, again.manifest.retain, len(again.snapshot_paths()),
                    [c.path_str for c in again.schema.leaves])

        res, _ = same(both(tmp_path, scenario, retain=7))
        assert res == ("k", 7, 1, ["k", "v"])


# -- ingest --------------------------------------------------------------------


class TestIngest:
    def test_buffer_then_flush_publishes_one_generation(self, tmp_path):
        def scenario(pkg, t, clock):
            w = pkg.lake.IngestWriter(t, parallel=False)
            acks = [w.append(_rows(0, 7)), w.append(_rows(100, 3), flush=True)]
            snap = t.manifest.open_snapshot()
            return acks, snap.total_rows, len(snap.files), w.flushes, w.appended_rows

        res, _ = same(both(tmp_path, scenario))
        assert res[0][0] == {"rows": 7, "buffered_rows": 7, "flushed": False,
                             "generation": None}
        assert res[0][1]["flushed"] is True and res[0][1]["generation"] == 1
        assert res[1:] == (10, 1, 1, 10)

    def test_size_bound_triggers_flush(self, tmp_path):
        def scenario(pkg, t, clock):
            w = pkg.lake.IngestWriter(t, flush_bytes=64, parallel=False)
            return [w.append(_rows(i * 50, 50)) for i in range(3)] + [w.flush()]

        res, _ = same(both(tmp_path, scenario))
        assert [a["generation"] for a in res[:3]] == [1, 2, 3] and res[3] is None

    @pytest.mark.parametrize("parallel", [False, True], ids=["serial", "pipeline"])
    def test_flushed_file_is_key_sorted_with_minmax(self, tmp_path, parallel):
        def scenario(pkg, t, clock):
            # row_group_size is the writer's estimated bytes: a group a
            # 4,096-row batch of write_rows here
            w = pkg.lake.IngestWriter(t, parallel=parallel, row_group_size=1024)
            keys = np.random.default_rng(4).permutation(10_000)
            w.append([{"k": int(k), "v": None if k % 5 == 0 else f"s{k}"} for k in keys],
                     flush=True)
            entry = t.manifest.open_snapshot().files[0]
            return entry.to_dict()["min_key"], entry.max_key, entry.rows

        res, state = same(both(tmp_path, scenario))
        assert res == (0, 9999, 10_000)
        root = str(tmp_path / "torch" / "t")
        paths = LakeTable.open(root).snapshot_paths()
        assert [r["k"] for r in _scan_rows(paths)] == list(range(10_000))
        # the data file's metadata, read back through the ride-along
        # properties, as the reference's reader gives it
        with FileReader(paths[0], device="cpu") as r, JReader(paths[0]) as jr:
            assert r.key_value_metadata == jr.key_value_metadata == {
                "parquet_tpu.lake": "ingest"}
            assert r.created_by == jr.created_by == "parquet_tpu"
            assert r.num_row_groups == 3

    def test_close_flushes_the_tail_then_refuses(self, tmp_path):
        def scenario(pkg, t, clock):
            w = pkg.lake.IngestWriter(t, parallel=False)
            w.append(_rows(0, 4))
            snap = w.close()
            return (snap.total_rows, w.close(), lake_error(lambda: w.append(_rows(9, 1))),
                    lake_error(w.flush))

        res, _ = same(both(tmp_path, scenario))
        assert res[0] == 4 and res[1] is None
        assert res[2][0] == res[3][0] == "closed"

    def test_bad_rows_fail_the_flush_and_commit_nothing(self, tmp_path):
        def scenario(pkg, t, clock):
            w = pkg.lake.IngestWriter(t, parallel=False)
            with pytest.raises(Exception) as ei:
                w.append([{"k": "not a number"}], flush=True)
            data = os.listdir(t.manifest.data_dir)
            return (type(ei.value).__name__, t.manifest.current_generation(), data,
                    w.buffered_rows)

        res, _ = same(both(tmp_path, scenario))
        assert res[1:] == (0, [], 0)

    @pytest.mark.parametrize("body,ctype", [
        (b'{"k": 1}\n\n{"k": 2, "v": "x"}\n', "application/x-ndjson"),
        (b'{"k": 1}', "application/json; charset=utf-8"),
        (b'{"k": 1}\n', ""),
        (b"not json\n", "application/json"),
        (b"[1, 2]", "application/json"),
        (b"k\n1\n", "text/csv"),
    ])
    def test_payload_decoding(self, body, ctype):
        def run(L):
            try:
                return L.rows_from_payload(body, ctype)
            except Exception as e:  # noqa: BLE001 — compared below
                return type(e).__name__, e.code, str(e)

        assert run(lake) == run(jlake)

    def test_arrow_ipc_is_a_typed_cut(self, tmp_path):
        """Once the port's cut (its unsupported_format refusal), now
        parity: the port parses an arrow-ipc body with its own reader into
        the reference's rows (pyarrow's stream and the port writer's), the
        appends commit the reference's tables byte for byte, and a body
        that does not parse is the reference's bad_payload."""
        pa = pytest.importorskip("pyarrow")
        import io as _io

        from parquet_tpu_torch.core import arrow_format as paf
        from parquet_tpu_torch.core import arrow_ipc

        table = pa.table({"k": [3, 4, 1], "v": ["x", None, "yz"]})
        buf = _io.BytesIO()
        with pa.ipc.new_stream(buf, table.schema) as wr:
            wr.write_table(table)
        ours = arrow_ipc.serialize_table(paf.table({
            "k": paf.array(np.array([9, 2])),
            "v": paf.Array.from_buffers(paf.large_string(), 2,
                                        [paf.py_buffer(np.array([1], np.uint8)),
                                         np.array([0, 1, 1], np.int64), b"q"]),
        }))
        ctype = "application/vnd.apache.arrow.stream"
        for body in (buf.getvalue(), ours):
            assert lake.rows_from_payload(body, ctype) == jlake.rows_from_payload(body, ctype)
        assert lake.rows_from_payload(ours, ctype) == [{"k": 9, "v": "q"}, {"k": 2, "v": None}]

        def scenario(pkg, t, clock):
            w = pkg.lake.IngestWriter(t, parallel=False)
            acks = [w.append(pkg.lake.rows_from_payload(b, ctype), flush=True)
                    for b in (buf.getvalue(), ours)]
            w.close()
            return acks

        same(both(tmp_path, scenario))
        for body in (b"\xff\xff\xff\xff\x10\x00\x00\x00", b"ARROW1\x00\x00"):
            with pytest.raises(LakeError) as ei:
                lake.rows_from_payload(body, ctype)
            with pytest.raises(jlake.LakeError) as ej:
                jlake.rows_from_payload(body, ctype)
            assert ei.value.code == ej.value.code == "bad_payload"

    def test_counts_match_the_reference_metrics(self, tmp_path):
        """lake_counts() moves as the reference's counters do over the same
        appends, flushes, compaction and reaping."""
        got = {}
        for pkg in PACKAGES:
            before = metrics.snapshot()
            reset_lake_counts()
            t = pkg.lake.LakeTable.create(str(tmp_path / pkg.name), SCHEMA, sort_key="k",
                                          retain=2)
            w = pkg.lake.IngestWriter(t, parallel=False)
            for rows in _interleaved(4, 30):
                w.append(rows, flush=True)
            pkg.lake.Compactor(t).compact_once()
            w.append(_rows(500, 5), flush=True)  # gen 4 ages out: its files go
            open(os.path.join(t.manifest.data_dir, ".x.1.0.tmp"), "wb").close()
            t.manifest.reap_orphans(grace_s=0.0)
            counts = metrics.delta(before) if pkg is JAX else lake_counts()
            got[pkg.name] = {k: v for k, v in counts.items()
                             if k.startswith("lake_") and not k.endswith(("_sum", "_count"))
                             and "_bucket" not in k}
        assert got["torch"] == got["jax"]
        assert got["torch"]["lake_flushes_total"] == 5
        assert got["torch"]["lake_files_unlinked_total"] > 0


# -- plan/dataset integration --------------------------------------------------


class TestLakeRefs:
    def _table(self, root, L=jlake):
        t = L.LakeTable.create(str(root), SCHEMA, sort_key="k")
        w = L.IngestWriter(t, parallel=False, row_group_size=7)
        w.append(_rows(0, 10), flush=True)
        w.append(_rows(100, 10), flush=True)
        w.append(_rows(50, 20), flush=True)
        return t

    def test_expand_paths_pins_current_and_named_generations(self, tmp_path):
        # one table, written by the reference, expanded by both packages
        t = self._table(tmp_path / "t")
        root = str(tmp_path / "t")
        gen1 = os.path.join(root, "_lake", "gen-00000001.json")
        for ref in (root, gen1, [root], [gen1, root], os.path.join(root, "_lake", "gen-2.json")):
            assert expand_paths(ref) == jexpand_paths(ref)
        assert lake.is_lake_table(root) and lake.manifest_ref_root(gen1) == (root, 1)
        cur = expand_paths(root)
        assert len(cur) == 3 and expand_paths(gen1) == cur[:1]
        assert cur == t.snapshot_paths()
        # a generation outside the window is the lake's typed error
        with pytest.raises(LakeError) as ei:
            expand_paths(os.path.join(root, "_lake", "gen-00000009.json"))
        assert ei.value.code == "no_such_generation"
        for ref in (root, [root], gen1):
            got, want = build_plan(ref), jbuild_plan(ref)
            assert (got.files, got.units, got.total_rows) == (want.files, want.units,
                                                              want.total_rows)
        assert build_plan(root).total_rows == 40

    def test_dataset_over_a_table_matches(self, tmp_path):
        self._table(tmp_path / "t")
        root = str(tmp_path / "t")
        for ref in (root, os.path.join(root, "_lake", "gen-00000002.json")):
            kw = dict(batch_size=6, columns=["k"], remainder="keep", shuffle=True, seed=3)
            got = [b[("k",)].numpy() for b in ParquetDataset(ref, device="cpu", **kw)]
            want = [np.asarray(b[("k",)]) for b in JDataset(ref, **kw)]
            assert len(got) == len(want)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))

    def test_non_lake_paths_are_untouched(self, tmp_path):
        f = tmp_path / "plain.txt"
        f.write_text("x")
        (tmp_path / "d" / "_lake").mkdir(parents=True)
        for ref in (str(f), str(tmp_path / "d"), str(tmp_path / "d" / "_lake" / "x.json")):
            assert lake.manifest_ref_root(ref) == jlake.manifest_ref_root(ref)
        assert expand_paths(str(f)) == jexpand_paths(str(f)) == [str(f)]
        assert expand_paths(str(tmp_path / "d")) == [str(tmp_path / "d")]


# -- compaction ----------------------------------------------------------------


def _fill(pkg, t, clock, flushes=5, rows_per=200):
    w = pkg.lake.IngestWriter(t, parallel=False, clock=clock)
    for rows in _interleaved(flushes, rows_per):
        w.append(rows, flush=True)


def _result(r):
    return None if r is None else {k: v for k, v in r.to_dict().items() if k != "seconds"}


class TestCompactor:
    def test_fold_preserves_rows_and_improves_pruning(self, tmp_path):
        def scenario(pkg, t, clock):
            _fill(pkg, t, clock, flushes=6, rows_per=300)
            before = sorted(r["k"] for r in _scan_rows(t.snapshot_paths()))
            c = pkg.lake.Compactor(t, row_group_size=256, clock=clock)
            result = _result(c.compact_once())
            after = sorted(r["k"] for r in _scan_rows(t.snapshot_paths()))
            return result, before == after, _result(c.compact_once()), c.compactions

        (res, again, nothing, n), state = same(both(tmp_path, scenario))
        assert again and nothing is None and n == 1
        assert res["files_in"] == 6 and res["rows"] == 1800 and res["generation"] == 7
        assert res["pruned_ratio_after"] > res["pruned_ratio_before"]
        with FileReader(LakeTable.open(str(tmp_path / "torch" / "t")).snapshot_paths()[0],
                        device="cpu") as r:
            assert r.key_value_metadata == {"parquet_tpu.lake": "compact"}

    def test_pruned_ratio_matches(self, tmp_path):
        def scenario(pkg, t, clock):
            _fill(pkg, t, clock, flushes=4, rows_per=1000)
            paths = t.snapshot_paths()
            filters = [[("k", ">=", 10), ("k", "<", 30)], [("k", "==", 7)]]
            before = [pkg.lake.pruned_ratio(paths, f) for f in filters]
            # the sorted rewrite checks its size every 1,000 rows: four groups
            pkg.lake.Compactor(t, row_group_size=50).compact_once()
            after = [pkg.lake.pruned_ratio(t.snapshot_paths(), f) for f in filters]
            return before, after

        (before, after), _ = same(both(tmp_path, scenario))
        assert before == [0.0, 0.0] and after == [0.75, 0.75]

    def test_time_travel_is_byte_identical_across_compaction(self, tmp_path):
        def scenario(pkg, t, clock):
            _fill(pkg, t, clock, flushes=4, rows_per=100)
            pin = 3
            paths = t.snapshot_paths(pin)
            before = [open(p, "rb").read() for p in paths]
            pkg.lake.Compactor(t).compact_once()
            pkg.lake.IngestWriter(t, parallel=False).append(_rows(10_000, 5), flush=True)
            return (t.manifest.open_snapshot(pin).generation, t.snapshot_paths(pin) == paths,
                    [open(p, "rb").read() for p in paths] == before)

        assert same(both(tmp_path, scenario))[0] == (3, True, True)

    def test_crash_mid_compact_loses_nothing(self, tmp_path):
        def scenario(pkg, t, clock):
            _fill(pkg, t, clock, flushes=3, rows_per=50)
            committed = sorted(r["k"] for r in _scan_rows(t.snapshot_paths()))
            m = t.manifest
            orphan = os.path.join(m.data_dir, "compact-99999-000001.parquet")
            with open(t.snapshot_paths()[0], "rb") as f, open(orphan, "wb") as g:
                g.write(f.read())
            with open(os.path.join(m.data_dir, ".dead.1234.0.tmp"), "wb") as f:
                f.write(b"partial")
            reaped = m.reap_orphans(grace_s=0.0)
            return (reaped, os.path.exists(orphan),
                    sorted(r["k"] for r in _scan_rows(t.snapshot_paths())) == committed)

        assert same(both(tmp_path, scenario))[0] == (2, False, True)

    def test_reap_respects_the_grace_window(self, tmp_path):
        def scenario(pkg, t, clock):
            _fill(pkg, t, clock, flushes=2, rows_per=10)
            fresh = os.path.join(t.manifest.data_dir, "inflight.parquet")
            with open(fresh, "wb") as f:
                f.write(b"x")
            return t.manifest.reap_orphans(grace_s=3600.0), os.path.exists(fresh)

        assert same(both(tmp_path, scenario))[0] == (0, True)

    def test_no_sort_key_falls_back_to_rowgroup_fold(self, tmp_path):
        def scenario(pkg, t, clock):
            w = pkg.lake.IngestWriter(t, parallel=False)
            w.append(_rows(0, 100), flush=True)
            w.append(_rows(100, 100), flush=True)
            result = _result(pkg.lake.Compactor(t).compact_once())
            got = sorted(r["k"] for r in _scan_rows(t.snapshot_paths()))
            return result, len(t.manifest.open_snapshot().files), got == list(range(200))

        (res, files, ok), _ = same(both(tmp_path, scenario, sort_key=None))
        assert res["rows"] == 200 and res["pruned_ratio_before"] is None
        assert files == 1 and ok

    def test_candidates_and_options_match(self, tmp_path):
        def scenario(pkg, t, clock):
            _fill(pkg, t, clock, flushes=5, rows_per=20)
            L = pkg.lake
            errs = []
            for kw in ({"min_files": 1}, {"min_files": 3, "max_files": 2}):
                with pytest.raises(ValueError) as ei:
                    L.Compactor(t, **kw)
                errs.append(str(ei.value))
            first = _result(L.Compactor(t, max_files=3).compact_once())
            none = _result(L.Compactor(t, min_files=4, small_file_bytes=1).compact_once())
            return errs, first, none

        (errs, first, none), _ = same(both(tmp_path, scenario))
        assert first["files_in"] == 3 and none is None

    def test_background_thread_runs_on_its_own_lane(self, tmp_path):
        t = LakeTable.create(str(tmp_path / "t"), SCHEMA, sort_key="k")
        _fill(PORT, t, FakeClock(), flushes=3, rows_per=20)
        c = Compactor(t, interval_s=0.01)
        names = []
        real = c.run_cycle

        def cycle():
            names.append(threading.current_thread().name)
            real()

        c.run_cycle = cycle
        c.start()
        try:
            deadline = time.monotonic() + WATCHDOG_S
            while c.compactions == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            c.stop(timeout=WATCHDOG_S)
        assert c._thread is None and c.compactions >= 1
        assert set(names) == {"pqt-compact"}
        assert len(t.manifest.open_snapshot().files) == 1

    def test_run_cycle_counts_a_lost_race(self, tmp_path):
        t = LakeTable.create(str(tmp_path / "t"), SCHEMA, sort_key="k")
        _fill(PORT, t, FakeClock(), flushes=2, rows_per=5)
        c = Compactor(t)
        real = t.manifest.commit

        def racing_commit(**kw):
            # another folder wins the race: one picked file is gone
            real(remove=kw["remove"][:1])
            return real(**kw)

        t.manifest.commit = racing_commit
        reset_lake_counts()
        c.run_cycle()
        assert lake_counts() == {'lake_compact_skipped_total{reason="commit_conflict"}': 1,
                                 "lake_manifest_commits_total": 1}
        assert c.compactions == 0 and t.manifest.current_generation() == 3


# -- the concurrency hammer ----------------------------------------------------


class TestHammer:
    def test_every_scan_pins_exactly_one_generation(self, tmp_path):
        """Appends, flushes and compactions race while scanners replan; every
        scan sees an internally consistent snapshot (the planned row total
        equals the manifest's claim for that generation, every referenced
        file opens). Scaled down from the reference's 24 appends."""
        t = LakeTable.create(str(tmp_path / "t"), SCHEMA, sort_key="k")
        w = IngestWriter(t, parallel=False)
        c = Compactor(t, min_files=2, max_files=8)
        stop = threading.Event()
        failures: list = []
        appends, per = 12, 40

        def writer():
            try:
                for i in range(appends):
                    w.append(_rows(i * per, per), flush=(i % 3 == 2))
            except Exception as e:  # noqa: BLE001
                failures.append(f"writer: {type(e).__name__}: {e}")
            finally:
                stop.set()

        def compactor():
            while not stop.wait(0.002):
                try:
                    c.compact_once()
                except LakeError:
                    continue  # lost a commit race; re-plan next tick
                except Exception as e:  # noqa: BLE001
                    failures.append(f"compactor: {type(e).__name__}: {e}")
                    return

        def scanner():
            last_gen = 0
            deadline = time.monotonic() + WATCHDOG_S
            while (not stop.is_set() or last_gen == 0) and time.monotonic() < deadline:
                try:
                    snap = t.manifest.open_snapshot()
                    if snap.generation == 0:
                        continue
                    plan = build_plan(t.snapshot_paths(snap.generation))
                    if plan.total_rows != snap.total_rows:
                        failures.append(f"scanner: gen {snap.generation} planned "
                                        f"{plan.total_rows}, manifest {snap.total_rows}")
                        return
                    if snap.generation < last_gen:
                        failures.append("scanner: generation went backward")
                        return
                    last_gen = snap.generation
                except LakeError:
                    continue  # pinned gen aged out mid-scan: retry
                except Exception as e:  # noqa: BLE001
                    failures.append(f"scanner: {type(e).__name__}: {e}")
                    return

        threads = [threading.Thread(target=f) for f in (writer, compactor, scanner, scanner)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WATCHDOG_S)
            assert not th.is_alive(), "hammer thread wedged"
        assert not failures, failures
        w.close()
        while c.compact_once() is not None:
            pass
        rows = sorted(r["k"] for r in _scan_rows(t.snapshot_paths()))
        assert rows == list(range(appends * per))
        assert t.manifest.open_snapshot().total_rows == appends * per
