"""parquet_tpu_torch.tools against the JAX package's parquet_tpu.tools, as
tests/test_tools.py pins the reference: every host subcommand of
parquet-tool and csv2parquet run through both packages' `main` on the same
files (seeded with numpy's default_rng, and the golden files), with equal
exit codes, byte-equal stdout and stderr, and byte-equal written files;
`scan --aggregate --cpu` byte-equal to the reference's; `profile --cpu` in
its modes and refusals; the typed refusals of what the port cuts; the
device rule (no CUDA and no --cpu: exit 1); summarize_columns.

Everything runs on the CPU: the device subcommands take --cpu here."""

import contextlib
import io
import json
import re
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.meta.parquet_types import Type  # noqa: E402
from parquet_tpu.schema.builder import message, optional, required, string  # noqa: E402
from parquet_tpu.tools import csv2parquet as jcsv  # noqa: E402
from parquet_tpu.tools import parquet_tool as jtool  # noqa: E402
from parquet_tpu.utils.metrics import summarize_columns as jsummarize  # noqa: E402

from parquet_tpu_torch.tools import csv2parquet as tcsv  # noqa: E402
from parquet_tpu_torch.tools import parquet_tool as ttool  # noqa: E402
from parquet_tpu_torch.utils.metrics import summarize_columns  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).parent / "golden" / "data"
GOLDEN_FILES = sorted(p.name for p in GOLDEN.glob("*.parquet"))


def run(main, argv):
    """(exit code, stdout, stderr) of one CLI call; argparse's exits count
    as exit codes."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def both(argv, tmp_path, main_j=jtool.main, main_t=ttool.main, mask=None):
    """Run argv through both packages. "{out}" in an argument becomes a
    directory of each package's own; returns (jax result, port result,
    jax dir, port dir) with each dir's path masked out of the texts."""
    dirs = []
    results = []
    for name, main in (("jax", main_j), ("torch", main_t)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        dirs.append(d)
        rc, out, err = run(main, [a.replace("{out}", str(d)) for a in argv])
        out, err = out.replace(str(d), "{out}"), err.replace(str(d), "{out}")
        if mask is not None:
            out, err = mask(out), mask(err)
        results.append((rc, out, err))
    return results[0], results[1], dirs[0], dirs[1]


def files_in(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """Seeded rows in three row groups: CRCs, the page index and a bloom
    filter on `name`, nulls in `name` and `score`."""
    rng = np.random.default_rng(24)
    path = str(tmp_path_factory.mktemp("sample") / "s.parquet")
    schema = message(
        required("id", Type.INT64),
        optional("name", string()),
        optional("score", Type.DOUBLE),
        required("flag", Type.BOOLEAN),
    )
    ids = rng.permutation(600)
    with JWriter(path, schema, codec="snappy", with_crc=True, write_page_index=True,
                 bloom_filters=["name"]) as w:
        for g in range(3):
            w.write_rows([
                {
                    "id": int(ids[g * 200 + i]),
                    "name": f"n{int(ids[g * 200 + i]) % 37}" if i % 5 else None,
                    "score": float(rng.standard_normal()) if i % 7 else None,
                    "flag": bool(rng.integers(2)),
                }
                for i in range(200)
            ])
            w.flush_row_group()
    return path


@pytest.fixture(scope="module")
def poisoned(tmp_path_factory):
    """(clean, damaged): one bit flipped in row group 1's first chunk."""
    from parquet_tpu.core.chunk import chunk_byte_range

    d = tmp_path_factory.mktemp("poison")
    schema = message(required("id", Type.INT64), optional("name", string()))
    clean = str(d / "clean.parquet")
    with JWriter(clean, schema, codec="snappy", with_crc=True) as w:
        for g in range(3):
            w.write_rows([{"id": g * 50 + i, "name": f"n{i % 7}"} for i in range(50)])
            w.flush_row_group()
    data = bytearray(open(clean, "rb").read())
    with JReader(clean) as r:
        off, total = chunk_byte_range(r.row_group(1).columns[0])
    data[off + total // 2] ^= 0x20
    bad = str(d / "bad.parquet")
    open(bad, "wb").write(bytes(data))
    garbage = d / "garbage.parquet"
    garbage.write_bytes(b"PAR1 this is not parquet PAR1")
    return clean, bad, str(garbage)


# -- the host subcommands ----------------------------------------------------------

SAMPLE_ARGVS = [
    ["cat", "{f}"],
    ["cat", "--raw", "{f}"],
    ["cat", "{f}", "--columns", "id,score"],
    ["cat", "{f}", "--filter", "id >= 300", "--filter", "score > 0"],
    ["cat", "{f}", "--filter", "name in ('n1','n2', 'n3')"],
    ["cat", "{f}", "--filter", "id not_in (1, 2, 3)"],
    ["cat", "{f}", "--filter", "name == 'n5'"],
    ["cat", "{f}", "--filter", "id ~ 3"],
    ["cat", "{f}", "--filter", "id in 1,2"],
    ["head", "-n", "7", "{f}"],
    ["head", "-n", "3", "{f}", "--columns", "name", "--filter", "flag == 1"],
    ["meta", "{f}"],
    ["pages", "{f}"],
    ["schema", "{f}"],
    ["rowcount", "{f}"],
    ["verify", "{f}"],
    ["verify", "--no-crc", "{f}"],
    ["rowcount", "{missing}"],
    ["cat", "{missing}"],
]


@pytest.mark.parametrize("argv", SAMPLE_ARGVS, ids=lambda a: " ".join(a))
def test_host_subcommands_match_reference(argv, sample, tmp_path):
    argv = [a.replace("{f}", sample).replace("{missing}", str(tmp_path / "nope.parquet"))
            for a in argv]
    j, t, _, _ = both(argv, tmp_path)
    assert t == j


GOLDEN_ARGVS = [["cat"], ["cat", "--raw"], ["head", "-n", "3"], ["meta"], ["schema"],
                ["rowcount"], ["pages"], ["verify"]]


@pytest.mark.parametrize("name", GOLDEN_FILES)
@pytest.mark.parametrize("cmd", GOLDEN_ARGVS, ids=lambda a: " ".join(a))
def test_golden_files_match_reference(cmd, name, tmp_path):
    # the ZSTD golden file reads through the port's native rung, with no
    # codec registered
    j, t, _, _ = both(cmd + [str(GOLDEN / name)], tmp_path)
    assert t == j


@pytest.mark.parametrize("which", ["clean", "bad", "garbage"])
def test_verify_poisoned_matches_reference(which, poisoned, tmp_path):
    clean, bad, garbage = poisoned
    path = {"clean": clean, "bad": bad, "garbage": garbage}[which]
    rcs = []
    for argv in (["verify", path], ["verify", "--no-crc", path]):
        j, t, _, _ = both(argv, tmp_path)
        assert t == j
        rcs.append(t[0])
    assert rcs[0] == (0 if which == "clean" else 1)


@pytest.mark.parametrize("force", [False, True])
def test_salvage_writes_the_reference_file(force, poisoned, tmp_path):
    _clean, bad, _ = poisoned
    argv = ["salvage", bad, "-o", "{out}/saved.parquet"]
    if force:
        for name in ("jax", "torch"):
            (tmp_path / name).mkdir()
            (tmp_path / name / "saved.parquet").write_bytes(b"x")
        j, t, _, _ = both(argv, tmp_path)
        assert j[0] == t[0] == 1 and "already exists" in t[2] and t == j
        argv.append("--force")
    j, t, jd, td = both(argv, tmp_path)
    assert t == j and t[0] == 0
    assert "salvaged 2/3 row groups (100/150 rows)" in t[1]
    assert files_in(td) == files_in(jd)


SPLIT_ARGVS = [
    ["split", "-n", "150", "{f}", "{out}/part_%d.parquet"],
    ["split", "-n", "1000", "{f}", "{out}/part_%d.parquet"],
    ["split", "-n", "77", "--codec", "gzip", "{f}", "{out}/part_%d.parquet"],
    ["split", "--size", "4K", "{f}", "{out}/part_%d.parquet"],
    ["split", "--groups", "2", "{f}", "{out}/part_%d.parquet"],
    ["split", "--groups", "1", "-n", "5", "{f}", "{out}/part_%d.parquet"],
    ["split", "--groups", "1", "--codec", "gzip", "{f}", "{out}/part_%d.parquet"],
    ["split", "-n", "5", "--size", "1K", "{f}", "{out}/part_%d.parquet"],
    ["split", "{f}", "{out}/part_%d.parquet"],
    ["split", "-n", "5", "{f}", "{out}/part.parquet"],
    ["split", "--size", "0", "{f}", "{out}/part_%d.parquet"],
    ["split", "--size", "12Q", "{f}", "{out}/part_%d.parquet"],
]


@pytest.mark.parametrize("argv", SPLIT_ARGVS, ids=lambda a: " ".join(a))
def test_split_writes_the_reference_parts(argv, sample, tmp_path):
    j, t, jd, td = both([a.replace("{f}", sample) for a in argv], tmp_path)
    assert t == j
    assert files_in(td) == files_in(jd)


@pytest.mark.parametrize("form", ["canonical", "legacy", "exists", "forced", "one"])
def test_merge_writes_the_reference_file(form, sample, poisoned, tmp_path):
    clean = poisoned[0]
    if form == "canonical":
        argv = ["merge", sample, sample, "-o", "{out}/m.parquet"]
    elif form == "legacy":
        argv = ["merge", "{out}/m.parquet", clean, clean]
    elif form == "one":
        argv = ["merge", "{out}/m.parquet"]
    else:
        for name in ("jax", "torch"):
            (tmp_path / name).mkdir()
            (tmp_path / name / "m.parquet").write_bytes(b"x")
        argv = ["merge", clean, clean, "-o", "{out}/m.parquet"]
        if form == "forced":
            argv.append("--force")
    j, t, jd, td = both(argv, tmp_path)
    assert t == j
    assert files_in(td) == files_in(jd)


LAKE_SCHEMA = "message m { required int64 k; optional binary v (STRING); }"


def _lake_mask(text: str) -> str:
    text = re.sub(r"(ingest|compact)-\d+-\d+\.parquet", r"\1-N.parquet", text)
    text = re.sub(r'"created_unix": [0-9.e+]+', '"created_unix": T', text)
    return re.sub(r'"seconds": [0-9.e+-]+', '"seconds": S', text)


def _lake_data(d: Path) -> list:
    """The table's data files' bytes, in name order (names carry the pid
    and each package's counter)."""
    return [p.read_bytes() for p in sorted((d / "t" / "data").glob("*.parquet"),
                                           key=lambda p: (p.name.split("-")[0], p.name[-14:]))]


def test_lake_cli_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    src = tmp_path / "rows.jsonl"
    steps = [
        ["lake", "init", "{out}/t", "--schema", LAKE_SCHEMA, "--sort-key", "k"],
        ["lake", "init", "{out}/t", "--schema", LAKE_SCHEMA],
    ]
    for b in range(3):
        steps.append(["lake", "append", "{out}/t", str(src) + f".{b}"])
        (tmp_path / f"rows.jsonl.{b}").write_text("".join(
            json.dumps({"k": int(k), "v": None if k % 4 == 0 else f"v{k}"}) + "\n"
            for k in rng.integers(0, 1000, 40)))
    (tmp_path / "empty.jsonl").write_text("")
    (tmp_path / "arrow.jsonl").write_text("not json\n")
    steps += [
        ["lake", "append", "{out}/t", str(tmp_path / "empty.jsonl")],
        ["lake", "append", "{out}/t", str(tmp_path / "arrow.jsonl")],
        ["lake", "manifest", "{out}/t", "--json"],
        ["lake", "manifest", "{out}/t"],
        ["lake", "compact", "{out}/t", "--min-files", "9"],
        ["lake", "compact", "{out}/t", "--reap", "--reap-grace-s", "0"],
        ["lake", "compact", "{out}/t"],
        ["lake", "manifest", "{out}/t", "--gen", "2", "--json"],
        ["lake", "manifest", "{out}/t", "--gen", "99"],
        ["lake", "manifest", "{out}/t"],
        ["lake", "manifest", "{out}/nope"],
    ]
    for argv in steps:
        j, t, jd, td = both(argv, tmp_path, mask=_lake_mask)
        assert t == j, argv
    assert _lake_data(td) == _lake_data(jd)


# -- scan --aggregate --------------------------------------------------------------


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("q")
    rng = np.random.default_rng(9)
    for i in range(3):
        t = pa.table({
            "a": pa.array(rng.integers(0, 100, 500).astype(np.int64)),
            "u": pa.array(rng.integers(0, 2**40, 500).astype(np.uint64)),
            "n": pa.array(rng.integers(-50, 50, 500).astype(np.int32),
                          mask=rng.random(500) < 0.2),
            "b": pa.array(rng.standard_normal(500)),
            "g": pa.array([f"k{j % 4}" for j in range(500)]),
        })
        pq.write_table(t, d / f"q-{i}.parquet", row_group_size=200)
    return str(d / "q-*.parquet")


AGG_CASES = [
    ('["count"]', []),
    ('["count", ["sum", "a"], ["min", "a"], ["max", "a"]]', []),
    ('["count", ["sum", "a"], ["min", "a"], ["max", "a"]]', ["--filters", '[["a", ">=", 50]]']),
    ('[["sum", "u"], ["max", "u"], ["count", "n"], ["sum", "n"]]', ["--filter", "b > 0"]),
    ('["count", ["min", "n"]]', ["--filters", '[[["a", "<", 10]], [["a", ">", 90]]]']),
    ('["count"]', ["--filter", "a >= 1000"]),
    ('["median"]', []),
    ('[["sum"]]', []),
    ('not json', []),
    ('["count"]', ["--max-groups", "0"]),
    ('["count"]', ["--filter", "a > 1", "--filters", "[]"]),
]


@pytest.mark.parametrize("spec,extra", AGG_CASES, ids=lambda v: str(v))
def test_scan_aggregate_cpu_is_byte_equal(spec, extra, shards, tmp_path):
    j, _t, _, _ = both(["scan", shards, "--aggregate", spec, *extra], tmp_path)
    t = run(ttool.main, ["scan", shards, "--cpu", "--aggregate", spec, *extra])
    assert t == j


@pytest.mark.parametrize("spec,extra", [
    ('["count", ["max", "b"]]', []),
    ('[["sum", "b"]]', []),
    ('["count", ["sum", "a"]]', ["--group-by", "g"]),
])
def test_scan_aggregate_outside_the_device_envelope_is_typed(spec, extra, shards):
    # the device declines these units (float aggregates, group_by) and the
    # host engine answers them: the reference's bytes
    j = run(jtool.main, ["scan", shards, "--aggregate", spec, *extra])
    t = run(ttool.main, ["scan", shards, "--cpu", "--aggregate", spec, *extra])
    assert j[0] == 0 and json.loads(j[1])["rows_scanned"] == 1500
    assert t == j


def test_scan_aggregate_equals_run_local_query(shards):
    from parquet_tpu_torch.serve import parse_query_request, render_query_body, run_local_query

    rc, out, _ = run(ttool.main, ["scan", shards, "--cpu", "--aggregate",
                                  '["count", ["sum", "a"]]', "--filters", '[["a", ">=", 50]]'])
    q = parse_query_request(json.dumps({
        "paths": [shards], "aggregates": ["count", ["sum", "a"]],
        "filters": [["a", ">=", 50]]}).encode())
    assert rc == 0 and out.encode() == render_query_body(run_local_query(q.paths, q, device="cpu"))


# -- scan (the throughput path) ----------------------------------------------------


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_scan_cpu_reports_rows_and_wait_share(shards):
    rc, out, _ = run(ttool.main, ["scan", shards, "--cpu", "--columns", "a,u,b",
                                  "--batch-size", "256", "--json"])
    assert rc == 0
    assert "3 files" in out and "1,500 rows" in out and "scan: wait" in out
    doc = _last_json(out)
    assert doc["rows"] == 1500 and doc["files"] == 3 and doc["batches"] == 6
    assert doc["rows_s"] > 0 and 0 <= doc["wait_share"] <= 1
    assert doc["units_skipped"] == 0 and doc["io_bytes_read"] > 0


def test_scan_cpu_counts_match_the_reference(shards, tmp_path):
    # the same plan, pruning and rows as the reference's scan; only the
    # timings and the io bytes (the port reads the selected chunks) differ
    argv = ["scan", shards, "--columns", "a,n", "--batch-size", "300", "--json",
            "--filter", "a < 20", "--epochs", "2"]
    j = run(jtool.main, argv)
    t = run(ttool.main, argv + ["--cpu"])
    assert j[0] == t[0] == 0
    jd, td = _last_json(j[1]), _last_json(t[1])
    for k in ("files", "units", "rows", "batches", "units_skipped", "prefetch", "file_bytes",
              "pruning"):
        assert td[k] == jd[k], k
    assert t[1].splitlines()[:2] == j[1].splitlines()[:2]


def test_scan_cpu_cache_and_on_error(shards, tmp_path):
    import shutil

    rc, out, _ = run(ttool.main, ["scan", shards, "--cpu", "--columns", "a", "--batch-size",
                                  "256", "--cache-mb", "32", "--epochs", "2", "--json"])
    doc = _last_json(out)
    assert rc == 0 and doc["rows"] == 3000 and doc["io_cache_hit_rate"] > 0
    d = tmp_path / "bad"
    d.mkdir()
    for p in Path(shards).parent.glob("q-*.parquet"):
        shutil.copy(p, d / p.name)
    (d / "q-zz.parquet").write_bytes(b"PAR1junkPAR1")
    pattern = str(d / "q-*.parquet")
    j = run(jtool.main, ["scan", pattern, "--columns", "a", "--batch-size", "256"])
    t = run(ttool.main, ["scan", pattern, "--cpu", "--columns", "a", "--batch-size", "256"])
    assert j[0] == t[0] == 1 and t[2] == j[2] and "invalid footer" in t[2]
    j = run(jtool.main, ["scan", pattern, "--columns", "a", "--on-error", "skip", "--json"])
    t = run(ttool.main, ["scan", pattern, "--cpu", "--columns", "a", "--on-error", "skip",
                         "--json"])
    assert j[0] == t[0] == 0 and t[2] == j[2] and "skipped" in t[2]
    assert _last_json(t[1])["rows"] == _last_json(j[1])["rows"] == 1500


def test_scan_cpu_nullable_policy(shards):
    # default --nullable zero: a nullable column streams; error refuses it
    rc, out, _ = run(ttool.main, ["scan", shards, "--cpu", "--columns", "n", "--json"])
    assert rc == 0 and _last_json(out)["rows"] == 1500
    j = run(jtool.main, ["scan", shards, "--columns", "n", "--nullable", "error"])
    t = run(ttool.main, ["scan", shards, "--cpu", "--columns", "n", "--nullable", "error"])
    assert j[0] == t[0] == 1 and "null" in t[2]


# -- csv2parquet -------------------------------------------------------------------


def _csv(tmp_path, n=300, seed=3) -> Path:
    rng = np.random.default_rng(seed)
    p = tmp_path / "in.csv"
    lines = ["id,name,age,score,ok,tiny,big,raw,doc,u16"]
    for i in range(n):
        lines.append(",".join([
            str(i),
            f"name {rng.integers(50)}" if i % 9 else "",
            str(rng.integers(0, 90)) if i % 11 else "",
            f"{rng.standard_normal():.6f}",
            ["true", "0", "T", "no", "Y", ""][i % 6],
            str(rng.integers(-128, 128)),
            str(int(rng.integers(0, 2**62))),
            f"r{i % 13}",
            json.dumps({"i": i}).replace(",", ";"),
            str(rng.integers(0, 65536)),
        ]))
    p.write_text("\n".join(lines) + "\n")
    return p


HINTS = "age=int32,score=double,ok=boolean,tiny=int8,big=uint64,raw=byte_array,doc=json,u16=uint16"
CSV_ARGVS = [
    [],
    ["-typehints", HINTS],
    ["-typehints", HINTS, "--codec", "gzip", "--row-group-size", "64"],
    ["-typehints", "id=int64,score=double", "--page-index", "--bloom", "name,id", "--sort", "id"],
    ["-typehints", HINTS, "--parallel", "2", "--row-group-size", "100"],
    ["-typehints", "age=int,score=double", "--codec", "uncompressed"],
]


@pytest.mark.parametrize("argv", CSV_ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_csv2parquet_writes_the_reference_file(argv, tmp_path):
    src = _csv(tmp_path)
    j, t, jd, td = both([*argv, "-o", "{out}/out.parquet", str(src)], tmp_path,
                        main_j=jcsv.main, main_t=tcsv.main)
    assert t == j and t[0] == 0
    assert (td / "out.parquet").read_bytes() == (jd / "out.parquet").read_bytes()


@pytest.mark.parametrize("case", ["bad_hint", "unknown_type", "unknown_column", "ragged",
                                  "bad_value", "bad_bool", "inexact_float", "empty"])
def test_csv2parquet_errors_match_reference(case, tmp_path):
    src = tmp_path / "in.csv"
    src.write_text("a,b\n1,x\n2,y\n")
    argv = []
    if case == "bad_hint":
        argv = ["-typehints", "a"]
    elif case == "unknown_type":
        argv = ["-typehints", "a=int128"]
    elif case == "unknown_column":
        argv = ["-typehints", "zz=int64"]
    elif case == "ragged":
        src.write_text("a,b\n1,x\n2\n")
    elif case == "bad_value":
        src.write_text("a,b\n1,x\nseven,y\n")
        argv = ["-typehints", "a=int64"]
    elif case == "bad_bool":
        src.write_text("a,b\n1,maybe\n")
        argv = ["-typehints", "b=boolean"]
    elif case == "inexact_float":
        src.write_text("a,b\n0.1,x\n")
        argv = ["-typehints", "a=float"]
    else:
        src.write_text("")
    j, t, _, _ = both([*argv, "-o", "{out}/out.parquet", str(src)], tmp_path,
                      main_j=jcsv.main, main_t=tcsv.main)
    assert t == j and t[0] in (1, 2)


def test_csv2parquet_parse_type_hints_matches_reference():
    for text in ("", "a=int64, b = DOUBLE ,", "x=json,y=uint8"):
        assert tcsv.parse_type_hints(text) == jcsv.parse_type_hints(text)


# -- profile ---------------------------------------------------------------------


def _trace(path) -> list:
    doc = json.loads(Path(path).read_text())
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    for e in events:
        for key in ("ph", "ts", "dur", "pid", "tid", "name"):
            assert key in e, e
    assert "counts_delta" in doc["otherData"]
    return events


def _ranges(events) -> list:
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_profile_cpu_default_mode(sample, tmp_path):
    out = tmp_path / "t.json"
    rc, text, _ = run(ttool.main, ["profile", sample, "-o", str(out), "--cpu", "--metrics"])
    assert rc == 0
    names = _ranges(_trace(out))
    assert names.count("file") == 1
    assert sorted(n for n in names if n.startswith("row_group ")) == [
        f"row_group {i}" for i in range(3)]
    assert "profile: 600 rows via backend=device, " in text
    assert "trace events -> " in text and "profile: io " in text
    # --metrics: the count registries' delta (the fused walk on every
    # chunk) and the launches, none on the CPU (plain versions)
    assert "metrics delta (this profile run):" in text
    assert "  prepare.prepare_fused_engaged = 12" in text
    assert "kernel launches: none" in text
    assert "Self CPU" in text  # the key_averages report


@pytest.mark.parametrize("mode", ["--host", "--rows", "--write"])
def test_profile_host_modes(mode, sample, tmp_path):
    out = tmp_path / "t.json"
    rc, text, _ = run(ttool.main, ["profile", sample, "-o", str(out), mode])
    assert rc == 0
    names = _ranges(_trace(out))
    assert "file" in names
    if mode == "--host":
        assert sum(n.startswith("row_group ") for n in names) == 3
        assert "profile: 600 rows via backend=host, " in text
    elif mode == "--rows":
        assert "profile: 600 rows via backend=host, " in text
    else:
        assert "profile: 600 rows via write-encode, " in text
        assert re.search(r"profile: encode ladder fused=\d+ staged=\d+, [\d,]+ B written", text)


def test_profile_cpu_device_mode(sample, tmp_path):
    out = tmp_path / "t.json"
    rc, text, _ = run(ttool.main, ["profile", sample, "-o", str(out), "--device", "--cpu",
                                   "--columns", "id,score", "--filter",
                                   '[[["id", ">=", 100]]]'])
    assert rc == 0, text
    names = _ranges(_trace(out))
    assert {"file", "query.aggregate", "query.batches"} <= set(names)
    with JReader(sample) as r:
        want = sum(1 for row in r.iter_rows() if row["id"] >= 100)
    assert (f"profile: device query over 600 rows -> {want:,} matched (aggregate lane: device), "
            f"{want:,} rows compacted into filtered batches") in text
    assert "profile: mask engine device=6 host_fallback=0" in text


def test_profile_cpu_device_mode_default_filter(tmp_path):
    # the median of the first numeric leaf's first group, as the reference
    # picks it; a nullable leaf batches as a MaskedColumn
    path = tmp_path / "n.parquet"
    rng = np.random.default_rng(1)
    pq.write_table(pa.table({"x": pa.array(rng.integers(0, 1000, 900)),
                             "y": pa.array(rng.standard_normal(900),
                                           mask=rng.random(900) < 0.3)}),
                   path, row_group_size=300)
    out = tmp_path / "t.json"
    rc, text, _ = run(ttool.main, ["profile", str(path), "-o", str(out), "--device", "--cpu"])
    assert rc == 0, text
    x = pq.read_table(path).column("x").to_numpy()
    want = int((x >= float(np.median(x[:300]))).sum())
    assert f"-> {want:,} matched" in text and f"{want:,} rows compacted" in text


PROFILE_REFUSALS = [
    (["profile"], 2, "FILE and -o are required"),
    (["profile", "{f}"], 2, "FILE and -o are required"),
    (["profile", "{f}", "-o", "{t}", "--write", "--rows"], 2, "mutually exclusive"),
    (["profile", "{f}", "-o", "{t}", "--filter", "[]"], 2, "--filter applies to --device mode"),
    (["profile", "{f}", "-o", "{t}", "--device", "--host"], 2, "--device is exclusive"),
    (["profile", "{f}", "-o", "{t}", "--top"], 2, "--live mode only"),
    (["profile", "{f}", "-o", "{t}", "--seconds", "3"], 2, "--live mode only"),
    (["profile", "--live", "http://127.0.0.1:9", "--columns", "a"], 2, "file mode"),
    (["profile", "{f}", "--live", "http://127.0.0.1:9"], 2, "file mode"),
    (["profile", "--live", "http://127.0.0.1:9", "--seconds", "0.1"], 1, "cannot reach"),
]


@pytest.mark.parametrize("argv,rc,msg", PROFILE_REFUSALS, ids=lambda v: str(v))
def test_profile_refusals_match_reference(argv, rc, msg, sample, tmp_path):
    argv = [a.replace("{f}", sample).replace("{t}", str(tmp_path / "t.json")) for a in argv]
    j = run(jtool.main, argv)
    t = run(ttool.main, argv)
    assert t == j
    assert t[0] == rc and msg in t[2]


# -- the subcommands and flags that were cut, held against the reference ---------------


@pytest.mark.parametrize("argv,msg", [
    (["trace-merge", "a.json", "b.json"], "a.json"),
    (["debug", "--fleet", "http://127.0.0.1:9"], "fleet"),
])
def test_cut_subcommands_exit_2(argv, msg):
    """trace-merge of missing inputs and a fleet of one unreachable replica:
    the port's tool answers as the reference's (the same exit code and
    message)."""
    got, want = run(ttool.main, argv), run(jtool.main, argv)
    assert got == want and got[0] == 1 and msg in got[2]


@pytest.mark.parametrize("flag,value", [("--trace-sample-rate", "0.5"), ("--debug-ring", "10"),
                                        ("--debug-max-traces", "3")])
@pytest.mark.parametrize("cmd", ["serve", "route"])
def test_serve_refuses_flags_it_has_no_field_for(cmd, flag, value, monkeypatch):
    """The obs flags reach the daemon's (or router's) config as the
    reference's do: both tools build a server whose config holds the value
    (its serve loop, shutdown and signal handlers stubbed) and exit 0."""
    from parquet_tpu.obs.recorder import RECORDER as JREC
    from parquet_tpu.serve import server as jserver

    from parquet_tpu_torch.obs.recorder import RECORDER as PREC
    from parquet_tpu_torch.serve import server as pserver

    argv = [cmd, "--port", "0", flag, value]
    if cmd == "route":
        argv += ["--replica", "http://127.0.0.1:9"]
    field = {"--trace-sample-rate": "trace_sample_rate", "--debug-ring": "debug_ring_size",
             "--debug-max-traces": "debug_max_traces"}[flag]
    configs = []
    saved = (PREC.config, JREC.config)
    try:
        for mod in (pserver, jserver):
            monkeypatch.setattr(mod.ScanServer, "serve_forever",
                                lambda self: configs.append(self.config))
            monkeypatch.setattr(mod.ScanServer, "install_signal_handlers", lambda self: None)
            # a listener never served: its shutdown() would wait forever
            monkeypatch.setattr(mod.ScanServer, "shutdown", lambda self: None)
        got = run(ttool.main, argv + (["--cpu"] if cmd == "serve" else []))
        want = run(jtool.main, argv)
    finally:
        PREC.configure(saved[0])
        JREC.configure(saved[1])
    assert got[0] == want[0] == 0
    assert got[1].splitlines()[-1] == want[1].splitlines()[-1] == "serve: drained, bye"
    assert [getattr(c, field) for c in configs] == [type(getattr(configs[1], field))(value)] * 2


def test_route_refuses_cpu():
    rc, _out, err = run(ttool.main, ["route", "--cpu", "--replica", "http://127.0.0.1:9",
                                     "--port", "0"])
    assert rc == 2 and "--cpu belongs on the replica daemons" in err


def test_debug_without_url_matches_reference():
    assert run(ttool.main, ["debug"]) == run(jtool.main, ["debug"])


# -- the device rule ----------------------------------------------------------------


NO_CUDA_ARGVS = [
    ["profile", "{f}", "-o", "{t}"],
    ["profile", "{f}", "-o", "{t}", "--device"],
    ["profile", "{f}", "-o", "{t}", "--metrics"],
    ["scan", "{f}"],
    ["scan", "{f}", "--aggregate", '["count"]'],
    ["scan", "{f}", "--slo-ms", "100"],
    ["serve", "--port", "0"],
    ["serve", "--port", "0", "--root", "{d}"],
]


@pytest.mark.parametrize("argv", NO_CUDA_ARGVS, ids=lambda a: " ".join(a))
def test_device_subcommands_without_cuda_exit_1(argv, sample, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.replace("{f}", sample).replace("{t}", str(tmp_path / "t.json"))
            .replace("{d}", str(tmp_path)) for a in argv]
    rc, out, err = run(ttool.main, argv)
    assert (rc, out, err) == (1, "", "parquet-tool: CUDA is not available; pass --cpu\n")
    assert not (tmp_path / "t.json").exists()


@pytest.mark.parametrize("argv", [["cat", "{f}"], ["meta", "{f}"], ["verify", "{f}"],
                                  ["profile", "{f}", "-o", "{t}", "--host"],
                                  ["profile", "{f}", "-o", "{t}", "--rows"]],
                         ids=lambda a: " ".join(a))
def test_host_subcommands_need_no_cuda(argv, sample, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.replace("{f}", sample).replace("{t}", str(tmp_path / "t.json")) for a in argv]
    assert run(ttool.main, argv)[0] == 0


@pytest.mark.parametrize("sub", ["cat", "head", "meta", "pages", "schema", "rowcount", "verify",
                                 "salvage", "split", "merge", "lake"])
def test_host_subcommands_take_no_cpu_flag(sub):
    argv = {"salvage": ["salvage", "f", "-o", "g"], "split": ["split", "-n", "1", "f", "g%d"],
            "merge": ["merge", "f", "-o", "g"], "lake": ["lake", "manifest", "t"]}.get(sub, [sub, "f"])
    rc, _out, err = run(ttool.main, argv + ["--cpu"])
    assert rc == 2 and "unrecognized arguments: --cpu" in err


# -- utils.metrics -----------------------------------------------------------------


@pytest.mark.parametrize("name", GOLDEN_FILES)
def test_summarize_columns_matches_reference(name):
    from parquet_tpu.meta.file_meta import read_file_metadata as jread
    from parquet_tpu_torch.meta.file_meta import read_file_metadata as tread

    with open(GOLDEN / name, "rb") as f:
        jm = jread(f)
    with open(GOLDEN / name, "rb") as f:
        tm = tread(f)
    assert summarize_columns(tm) == jsummarize(jm)


def test_encoding_name_matches_reference():
    from parquet_tpu.utils.metrics import encoding_name as jname
    from parquet_tpu_torch.utils.metrics import encoding_name

    for e in (0, 2, 3, 4, 5, 6, 7, 8, 9, 42, "x"):
        assert encoding_name(e) == jname(e)


# -- the copy rule -----------------------------------------------------------------


@pytest.mark.parametrize("rel", ["parquet_tpu_torch/tools", "parquet_tpu_torch/utils/metrics.py",
                                 "examples_torch"])
def test_no_jax_and_no_reference_imports(rel):
    target = ROOT / rel
    files = sorted(target.rglob("*.py")) if target.is_dir() else [target]
    assert files
    bad = re.compile(r"^\s*(import|from)\s+(jax|parquet_tpu)(\s|\.|$)", re.M)
    for p in files:
        assert not bad.search(p.read_text()), p


# -- launch counts of child processes ------------------------------------------------


def test_launch_counts_file_of_a_child_process(tmp_path):
    """PQT_LAUNCH_COUNTS=<path>: a process writes launch_counts() there at
    exit (how chip_smoke.py reads the launches of the tool's children)."""
    import os
    import subprocess
    import sys

    from parquet_tpu_torch.kernels import device_ops as ops

    path = tmp_path / "counts.json"
    subprocess.run(
        [sys.executable, "-c", "import parquet_tpu_torch.kernels.device_ops"],
        check=True, cwd=str(ROOT), timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT), "PQT_LAUNCH_COUNTS": str(path)},
    )
    got = json.loads(path.read_text())
    assert set(got) == set(ops.KERNELS) | {"expand_hybrid_by_width", "dict_indices_by_width",
                                           "leaf_verdict_by_kind"}
    assert all(got[k] == 0 for k in ops.KERNELS)
    counts = ops.launch_counts()
    assert set(counts) == set(got)
