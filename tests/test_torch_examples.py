"""The port's examples (examples_torch/) against the JAX package.

Every examples/*.py has its counterpart under examples_torch/ (the same
name; tpu_columnar_scan.py becomes cuda_columnar_scan.py). Each runs as a
subprocess with --cpu in a temp directory and exits 0 printing `on cpu`
(the two train loops' own assertions are checks too: the loss falls, the
learned signs match the generator, the resumed stream is byte-equal);
without --cpu on a host without CUDA each exits 1 with the typed message
and never carries on on the CPU. What each prints is held against the
JAX package's API run on the file the example wrote: the groups admitting
the ghost id, the admitted row ranges, the filtered counts and the mean
fare, the device batches, the column stats, the floor rows and the
low-level reads' lines; write_low_level's file is byte-equal to the JAX
writer's of the same rows. examples/*.py are not run here: they write
fixed /tmp paths (tests/test_examples.py runs them).

They live apart from examples/: tests/test_examples.py runs every
examples/*.py with JAX on the CPU and no CUDA."""

import datetime as dt
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
import parquet_tpu as jpq  # noqa: E402
from parquet_tpu import floor as jfloor  # noqa: E402
from parquet_tpu.parallel.scan import column_stats, distributed_column_stats  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.name for p in (ROOT / "examples_torch").glob("*.py"))
COUNTERPART = {"tpu_columnar_scan.py": "cuda_columnar_scan.py"}
# readers of write_low_level's example.parquet (cwd-relative): written first
NEEDS_WRITE = {"read_low_level.py", "cuda_columnar_scan.py"}
GOLDEN_DICT = ROOT / "tests" / "golden" / "data" / "alltypes_dict_snappy_v1.parquet"
TIMEOUT_S = 180


def _run(name, cwd, *args, env=None):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / name), *args],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=cwd,
        env={**os.environ, "HOME": str(cwd), **(env or {})},
    )


@pytest.fixture(scope="module")
def cpu_runs(tmp_path_factory):
    """{name: (completed process, its working directory)} of every example
    run once with --cpu, four at a time, each in its own directory."""

    def one(name):
        cwd = tmp_path_factory.mktemp(name.removesuffix(".py"))
        if name in NEEDS_WRITE:
            pre = _run("write_low_level.py", cwd, "--cpu")
            assert pre.returncode == 0, pre.stderr[-1500:]
        return _run(name, cwd, "--cpu"), cwd

    with ThreadPoolExecutor(4) as pool:
        return dict(zip(EXAMPLES, pool.map(one, EXAMPLES)))


@pytest.fixture(scope="module")
def no_cuda_runs(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("no_cuda")
    with ThreadPoolExecutor(4) as pool:
        runs = pool.map(lambda n: _run(n, cwd, env={"CUDA_VISIBLE_DEVICES": ""}), EXAMPLES)
        return dict(zip(EXAMPLES, runs))


def test_both_examples_are_here():
    # every reference example has its counterpart here, and nothing else is
    want = sorted(COUNTERPART.get(p.name, p.name) for p in (ROOT / "examples").glob("*.py"))
    assert EXAMPLES == want and len(EXAMPLES) == 9


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, cpu_runs):
    r, _cwd = cpu_runs[name]
    assert r.returncode == 0, f"{name}:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}"
    if name == "train_loop.py":
        assert "training works" in r.stdout and "on cpu" in r.stdout
    elif name == "streaming_train_loop.py":
        assert "byte-identically" in r.stdout and "on cpu" in r.stdout
    else:
        assert r.stdout.splitlines()[-1] == "on cpu"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_cuda_exits_1(name, no_cuda_runs):
    r = no_cuda_runs[name]
    assert r.returncode == 1
    assert r.stdout == ""
    stem = name.removesuffix(".py")
    assert r.stderr.strip() == f"{stem}: CUDA is not available; pass --cpu"


def lines(cpu_runs, name) -> list:
    r, _cwd = cpu_runs[name]
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.splitlines()


def test_analytics_pruning_prints_the_references_answers(cpu_runs):
    out = lines(cpu_runs, "analytics_pruning.py")
    path = cpu_runs["analytics_pruning.py"][1] / "example_analytics.parquet"
    n = 2_000_000
    with jpq.FileReader(str(path)) as r:
        assert r.num_row_groups == 8 and r.num_rows == n
        ghost = r.prune_row_groups([("trip_id", "==", (1 << 41) + 7)])
        cutoff = dt.datetime.fromtimestamp(
            (1_700_000_000_000_000 + n - 5_000) / 1e6, tz=dt.timezone.utc
        ).replace(tzinfo=None)
        band = [("ts", ">=", cutoff)]
        ranges = r.prune_pages(r.num_row_groups - 1, band)
        rows = len(list(r.iter_rows(filters=band)))
    with jpq.FileReader(str(path), backend="tpu_roundtrip") as r:
        sizes = [len(b[("ts",)]) for b in r.iter_device_batches(
            65_536, filters=band, drop_remainder=False)]
    assert ghost == []
    assert out[0] == f"groups admitting ghost trip_id: {ghost}"
    assert out[1] == f"admitted row ranges: {ranges}"
    assert re.fullmatch(rf"filtered scan: {rows} rows in \d+ ms", out[2]) and rows == 5_000
    assert out[3] == f"device batches after pushdown: {len(sizes)} ({sum(sizes)} rows)"


@dataclass
class Trip:
    id: int
    vendor: Optional[str]
    ts: dt.datetime
    tags: list[str]


def test_dataclass_floor_prints_the_references_rows(cpu_runs):
    out = lines(cpu_runs, "dataclass_floor.py")
    path = cpu_runs["dataclass_floor.py"][1] / "trips.parquet"
    want = list(jfloor.Reader(str(path), Trip))
    assert [(t.id, t.vendor, t.tags) for t in want] == [(1, "CMT", ["fast"]), (2, None, [])]
    assert out[:-1] == [repr(t) for t in want]


def test_distributed_stats_prints_the_references_stats(cpu_runs):
    out = lines(cpu_runs, "distributed_stats.py")
    path = cpu_runs["distributed_stats.py"][1] / "example_dstats.parquet"

    def parsed(line, head):
        assert line.startswith(head)
        got = eval(line[len(head):], {"np": np, "__builtins__": {}})  # noqa: S307 - our output
        return {k: {s: v.item() if hasattr(v, "item") else v for s, v in d.items()}
                for k, d in got.items()}

    def plain(stats):
        return {k: {s: np.asarray(v).item() for s, v in d.items()} for k, d in stats.items()}

    with jpq.FileReader(str(path)) as r:
        assert r.num_row_groups == 10
        mesh = plain(column_stats(r, jax.local_devices()))
        local = plain(distributed_column_stats(r))
    assert out[0] == "devices: ['cpu']"
    assert parsed(out[1], "mesh scan: ") == mesh
    assert parsed(out[2], "multi-host shape: ") == local
    assert mesh[("x",)] == {"min": 0, "max": 499_999, "count": 500_000}


def test_filtered_scan_prints_the_references_answers(cpu_runs):
    out = lines(cpu_runs, "filtered_scan.py")
    path = cpu_runs["filtered_scan.py"][1] / "example_filtered.parquet"
    with jpq.FileReader(str(path)) as r:
        keep = r.prune_row_groups([("ts", ">=", 850_000)])
        fares = [row["fare"] for row in r.iter_rows(
            filters=[("ts", ">=", 850_000), ("fare", ">", 75.0)])]
        groups = r.num_row_groups
    assert groups == 10 and keep == [8, 9]
    assert out[0] == f"row groups: {groups}, surviving pruning: {keep}"
    assert out[1] == f"{len(fares)} matching rows, mean fare {sum(fares) / len(fares):.2f}"


def test_write_low_level_writes_the_references_bytes(cpu_runs, tmp_path):
    assert lines(cpu_runs, "write_low_level.py")[0] == "wrote example.parquet"
    schema = jpq.parse_schema("""
    message example {
      required int64 id;
      optional binary name (STRING);
      optional group scores (LIST) {
        repeated group list {
          optional double element;
        }
      }
    }
    """)
    want = tmp_path / "example.parquet"
    with jpq.FileWriter(str(want), schema, codec="snappy") as w:
        w.write_row({"id": 1, "name": "alice", "scores": [9.5, 8.0]})
        w.write_row({"id": 2, "name": None, "scores": []})
    got = cpu_runs["write_low_level.py"][1] / "example.parquet"
    assert got.read_bytes() == want.read_bytes()


def reference_walk(path) -> list:
    """read_low_level's lines from the JAX package's host walk."""
    with jpq.FileReader(str(path)) as r:
        out = [f"{r.num_rows} rows, {r.num_row_groups} row groups"]
        for i in range(r.num_row_groups):
            for col_path, chunk in r.read_row_group(i).items():
                out.append(f"  rg{i} {'.'.join(col_path)}: {len(chunk.values)} values, "
                           f"{type(chunk.values).__name__}")
    return out


def reference_scan(path) -> list:
    """cuda_columnar_scan's lines from the JAX package's host read."""
    out = []
    with jpq.FileReader(str(path)) as r:
        for i in range(r.num_row_groups):
            for col_path, chunk in r.read_row_group(i).items():
                v = chunk.values
                dtype = str(v.dtype) if isinstance(v, np.ndarray) else "bytes"
                out.append(f"rg{i} {'.'.join(col_path)}: n={len(v)} dtype={dtype}")
    return out


def test_read_low_level_prints_the_references_walk(cpu_runs):
    out = lines(cpu_runs, "read_low_level.py")
    assert out[:-1] == reference_walk(cpu_runs["read_low_level.py"][1] / "example.parquet")


@pytest.mark.parametrize("file", ["example.parquet", "golden dictionary file"])
def test_cuda_columnar_scan_prints_the_references_scan(cpu_runs, file, tmp_path):
    if file == "example.parquet":
        out = lines(cpu_runs, "cuda_columnar_scan.py")
        path = cpu_runs["cuda_columnar_scan.py"][1] / "example.parquet"
    else:  # dictionary chunks: the gather and the byte arrays' indices
        r = _run("cuda_columnar_scan.py", tmp_path, str(GOLDEN_DICT), "--cpu")
        assert r.returncode == 0, r.stderr[-2000:]
        out, path = r.stdout.splitlines(), GOLDEN_DICT
    assert out[-2:] == ["device columns equal the host read", "on cpu"]
    assert out[:-2] == reference_scan(path)
