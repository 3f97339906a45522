"""Scans, collectives and the sharded page-grid decode of the port against
the JAX package, on the CPU.

  * build_page_grid's arrays; expand_page_grid (its plain version) and
    sharded_decode_step at world size 1 against the JAX sharded_decode_step
    on 4 CPU devices, whole decoded rows (padding positions and an
    out-of-range dictionary included) and stats;
  * column_stats over ["cpu"] * 8 against the JAX column_stats over the 8
    virtual CPU devices (tests/conftest.py): all-null column, all-null bool
    shard, filter pushdown, a NaN chunk, signed zeros;
  * over gloo, in processes spawned by parquet_tpu_torch.testing.dist (two
    spawns, world sizes 2 and 4): mesh_reduce_stats (per-rank partials, a
    NaN partial, replicas) against pmin/pmax/psum on a CPU mesh of the same
    size, distributed_column_stats against the JAX one over such a mesh,
    sharded_decode_step at world size 4, iter_device_batches(sharding=)
    against the shards of the JAX package's sharded batches, and the three
    steps of the entry point's check over a 2 x 2 DeviceMesh against the
    JAX steps on a 2 x 2 CPU mesh.

Tolerance: exact everywhere (NaN compares equal to NaN).
"""

from __future__ import annotations

import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from parquet_tpu.core.reader import FileReader as JaxReader  # noqa: E402
from parquet_tpu.ops.rle_hybrid import encode_hybrid as jencode  # noqa: E402
from parquet_tpu.ops.rle_hybrid import prescan_hybrid as jprescan  # noqa: E402
from parquet_tpu.parallel import mesh as jmesh  # noqa: E402
from parquet_tpu.parallel import scan as jscan  # noqa: E402

from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.core.schema import Schema  # noqa: E402
from parquet_tpu_torch.core.writer import FileWriter  # noqa: E402
from parquet_tpu_torch.kernels import device_ops as ops  # noqa: E402
from parquet_tpu_torch.ops.rle_hybrid import prescan_hybrid  # noqa: E402
from parquet_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from parquet_tpu_torch.parallel import scan as pscan  # noqa: E402
from parquet_tpu_torch.testing import dist as tdist  # noqa: E402
from parquet_tpu_torch.testing.synth import page_grid_edge_cases  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from __graft_entry__ import _grid_tensors  # noqa: E402

jnp = jax.numpy
CPUS = jax.devices("cpu")


def _port_grid(g) -> pmesh.PageGrid:
    return pmesh.PageGrid(g.words, g.starts, g.is_rle, g.values, g.bit_starts, g.counts,
                          g.width)


def _same_value(a, b) -> bool:
    if a is None or b is None:
        return a is b
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype:
        return False
    if np.issubdtype(a.dtype, np.floating):
        return (np.isnan(a) and np.isnan(b)) or a.tobytes() == b.tobytes()
    return bool(a == b)


def _stats_equal(got: dict, want: dict) -> bool:
    if got.keys() != want.keys():
        return False
    for k in want:
        for f in ("min", "max", "count"):
            if not _same_value(got[k][f], want[k][f]):
                return False
    return True


# -- the page grid -----------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 3, 7, 12, 17])
def test_build_page_grid_matches_jax(width):
    rng = np.random.default_rng(width)
    tables, jtables, takes = [], [], []
    for p in range(5):
        n = 300 - 37 * p
        idx = rng.integers(0, 1 << width, n, dtype=np.uint64).astype(np.uint32)
        idx[50:120] = idx[50]  # an RLE run
        stream = jencode(idx, width)
        tables.append(prescan_hybrid(stream, n, width))
        jtables.append(jprescan(stream, n, width))
        takes.append(n)
    got = pmesh.build_page_grid(tables, takes, width, 320)
    want = jmesh.build_page_grid(jtables, takes, width, 320)
    for f in ("words", "starts", "is_rle", "values", "bit_starts", "counts"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.width == want.width


def _jax_decode(grid, dictionary, n_out, n_dev=4):
    dec, st = jmesh.sharded_decode_step(
        jmesh.make_decode_mesh(CPUS[:n_dev]), grid, dictionary, n_out
    )
    return np.asarray(dec), {k: np.asarray(v)[()] for k, v in st.items()}


GRID_CASES = {
    "ragged": dict(n_pages=6, out=512, dict_size=100, seed=3, cut=None),
    "single": dict(n_pages=1, out=64, dict_size=2, seed=1, cut=None),
    "out_of_range_dict": dict(n_pages=5, out=256, dict_size=64, seed=2, cut=20),
    "width32": dict(n_pages=4, out=128, dict_size=1 << 32, seed=4, cut=None),
}


def _grid_case(name):
    c = GRID_CASES[name]
    if c["dict_size"] == 1 << 32:
        # width 32: dictionary indices are the full uint32 range (clamped)
        rng = np.random.default_rng(c["seed"])
        tables, takes = [], []
        for p in range(c["n_pages"]):
            n = c["out"] - 3 * p
            idx = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            tables.append(jprescan(jencode(idx, 32), n, 32))
            takes.append(n)
        grid = jmesh.build_page_grid(tables, takes, 32, c["out"])
        dictionary = rng.integers(-(2**62), 2**62, 1000).astype(np.int64)
        return grid, dictionary, c["out"]
    grid, dictionary, _exp = _grid_tensors(c["n_pages"], c["out"], c["dict_size"], seed=c["seed"])
    if c["cut"]:
        dictionary = dictionary[: c["cut"]]
    return grid, dictionary, c["out"]


@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_sharded_decode_step_world1_matches_jax(name):
    """At world size 1 (no group) one rank decodes every page; its rows equal
    the JAX step's whole rows (its page axis padded to the mesh size)."""
    grid, dictionary, n_out = _grid_case(name)
    want_dec, want_st = _jax_decode(grid, dictionary, n_out)
    dec, st = pmesh.sharded_decode_step(None, _port_grid(grid), dictionary, n_out, device="cpu")
    assert np.array_equal(dec.numpy(), want_dec[: grid.num_pages])
    assert _stats_equal({"s": tdist.stats_to_numpy({"s": st})["s"]}, {"s": want_st})


def test_expand_page_grid_padding_page_matches_jax():
    """An all-zero padding page (the mesh pads with them) and a page whose
    counts end early expand to the JAX program's values at every position."""
    grid, dictionary, n_out = _grid_case("ragged")
    want_dec, _ = _jax_decode(grid, dictionary, n_out, n_dev=4)  # 6 pages -> 8
    padded = [np.pad(a, [(0, 2)] + [(0, 0)] * (a.ndim - 1))
              for a in (grid.words, grid.starts, grid.is_rle, grid.values, grid.bit_starts)]
    args = [torch.from_numpy(a.view(np.int32)) for a in padded]
    got = ops.expand_page_grid(*args, torch.from_numpy(dictionary), grid.width, n_out)
    assert np.array_equal(got.numpy(), want_dec)


PAGE_GRID_EDGE = page_grid_edge_cases(ops.PAGE_GRID_TILE, ops.PAGE_GRID_ITEMS,
                                      ops.PAGE_GRID_STAGE_RUNS, seed=47)


def _jax_expand_grid(grid, dictionary, width, n_out):
    """The reference's vmapped _expand_one_page and the dictionary gather
    of sharded_decode_step, jitted as there, on one device."""
    words, starts, is_rle, values, bit_starts = grid

    @jax.jit
    def step(w, s, r, v, b, d):
        return d[jax.vmap(partial(jmesh._expand_one_page, width=width, n_out=n_out))(w, s, r, v, b)]

    return np.asarray(step(words.view(np.uint32), starts, is_rle, values.view(np.uint32),
                           bit_starts, dictionary))


@pytest.mark.parametrize("case", PAGE_GRID_EDGE, ids=[c.label for c in PAGE_GRID_EDGE])
def test_expand_page_grid_edge_cases_match_jax(case):
    """The page-grid expansion's tile edges (n_out off the tile, runs
    shorter than a thread's outputs, more runs a tile than the stage holds,
    a page ending inside a tile, a padding page, bit starts that wrap or
    are negative, a first start above 0, is_rle 2, dictionaries shorter
    than the index range) at widths 0-32: the port equals the JAX program
    bit for bit."""
    got = ops.expand_page_grid(*map(torch.from_numpy, case.grid),
                               torch.from_numpy(case.dictionary), case.width, case.n_out)
    want = _jax_expand_grid(case.grid, case.dictionary, case.width, case.n_out)
    assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want)


def _runs_a_tile(starts: np.ndarray, n_out: int, tile: int) -> int:
    """The most runs any tile of any page spans."""
    most = 0
    for row in starts:
        for b in range(0, n_out, tile):
            last = min(b + tile, n_out) - 1
            first = max(int(np.searchsorted(row, b, side="right")) - 1, 0)
            most = max(most, max(int(np.searchsorted(row, last, side="right")) - 1, 0) - first + 1)
    return most


def test_page_grid_edge_cases_cover_the_tile():
    """The cases reach every path of the kernel: each width of 0, 1, 3, 12,
    17 and 32; n_out off a multiple of the tile; runs shorter than a
    thread's outputs in tables staged whole and past the stage; tiles over
    more runs than the stage holds, and a table longer than the stage whose
    tiles each span fewer; bitpos past 2^31 and below 0; an all-zero
    padding page; both dictionary widths, shorter than the index range."""
    t, items, stage = ops.PAGE_GRID_TILE, ops.PAGE_GRID_ITEMS, ops.PAGE_GRID_STAGE_RUNS
    assert {c.width for c in PAGE_GRID_EDGE} == {0, 1, 3, 12, 17, 32}
    for w in (0, 1, 3, 12, 17, 32):
        mine = [c for c in PAGE_GRID_EDGE if c.width == w]
        assert any(c.n_out % t for c in mine)
        runs = [(c.grid[1].shape[1], _runs_a_tile(c.grid[1], c.n_out, t)) for c in mine]
        assert any(r <= stage for r, _ in runs) and any(m > stage for _, m in runs)
        assert any(r > stage >= m for r, m in runs)
        short = [c for c in mine if (np.diff(c.grid[1], axis=1) < items).any()]
        assert any(c.grid[1].shape[1] <= stage for c in short)
        assert any(_runs_a_tile(c.grid[1], c.n_out, t) > stage for c in short)
        bs = np.concatenate([c.grid[4].ravel().astype(np.int64) for c in mine])
        assert bs.max() + w > 2**31 - 1 - w * t or w == 0
        assert bs.min() < 0
        assert any((c.grid[1] == 0).all(axis=1).any() for c in mine)
        assert any((c.grid[2] == 2).any() for c in mine)
        # run values past the dictionary's end and at or above 2^31 (read as
        # negative int32): both clamps
        vals = np.concatenate([c.grid[3][c.grid[2] == 1].view(np.uint32) for c in mine])
        assert (vals >= 1 << 31).any()
        assert ((vals < 1 << 31) & (vals >= min(len(c.dictionary) for c in mine))).any()
    assert {c.dictionary.dtype for c in PAGE_GRID_EDGE} == {np.dtype(np.int32), np.dtype(np.int64)}


def test_page_grid_tile_pinned_to_the_kernel():
    """PAGE_GRID_TILE, PAGE_GRID_ITEMS and PAGE_GRID_STAGE_RUNS, around
    which the edge cases put their runs and sizes, are the kernel's kTile,
    kItems and kStageRuns (expand_page_grid.cu)."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "expand_page_grid.cu").read_text()
    k = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert "constexpr int kTile = kThreads * kItems;" in src
    assert k["kThreads"] * k["kItems"] == ops.PAGE_GRID_TILE
    assert k["kItems"] == ops.PAGE_GRID_ITEMS
    assert k["kStageRuns"] == ops.PAGE_GRID_STAGE_RUNS


def test_expand_page_grid_refuses_bad_input():
    z = torch.zeros((2, 3), dtype=torch.int32)
    d = torch.arange(4)
    with pytest.raises(ValueError, match="width"):
        ops.expand_page_grid(z, z, z, z, z, d, 33, 4)
    with pytest.raises(ValueError, match="disagree"):
        ops.expand_page_grid(z, z, z[:1], z, z, d, 3, 4)
    with pytest.raises(ValueError, match="empty dictionary"):
        ops.expand_page_grid(z, z, z, z, z, d[:0], 3, 4)
    with pytest.raises(TypeError):
        ops.expand_page_grid(z.long(), z, z, z, z, d, 3, 4)


# -- column_stats over devices -----------------------------------------------------


@pytest.fixture(scope="module")
def scan_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_scan")
    rng = np.random.default_rng(21)
    files = {}
    n = 40_000
    f = rng.standard_normal(n)
    f[12_345] = np.nan  # group 2 holds a NaN
    f[30_000] = -0.0
    t = pa.table({
        "x": pa.array(rng.integers(-(2**40), 2**40, n).astype(np.int64)),
        "f": pa.array(f),
        "i": pa.array(rng.integers(-(2**31), 2**31, n).astype(np.int32)),
        "g": pa.array(rng.standard_normal(n).astype(np.float32)),
        "cat": pa.array([f"c{i % 9}" for i in range(n)]),
    })
    files["scan"] = str(tmp / "scan.parquet")
    pq.write_table(t, files["scan"], row_group_size=5_000, compression="snappy")
    files["allnull"] = str(tmp / "allnull.parquet")
    pq.write_table(pa.table({"x": pa.array([None] * 2000, pa.int64())}), files["allnull"],
                   row_group_size=500)
    files["nb"] = str(tmp / "nb.parquet")
    pq.write_table(pa.table({"b": pa.array([None] * 1000 + [True, False] * 500, pa.bool_())}),
                   files["nb"], row_group_size=1000)
    files["zeros"] = str(tmp / "zeros.parquet")
    pq.write_table(pa.table({"z": pa.array([0.0, -0.0] * 600 + [-0.0, 0.0] * 600)}),
                   files["zeros"], row_group_size=300, use_dictionary=False)
    files["pushdown"] = str(tmp / "pushdown.parquet")
    pq.write_table(pa.table({"x": pa.array(np.concatenate(
        [np.arange(0, 4096), np.arange(1_000_000, 1_004_096)]).astype(np.int64))}),
        files["pushdown"], row_group_size=4096, use_dictionary=False)
    files["dry"] = _dry_file(tmp / "dry.parquet")
    return files


STATS_CASES = [
    ("scan", ["x", "f", "i", "g"], None),
    ("scan", None, None),
    ("scan", ["x"], [("x", ">=", 0)]),
    ("allnull", ["x"], None),
    ("nb", ["b"], None),
    ("zeros", None, None),
    ("pushdown", None, [("x", ">=", 1_000_000)]),
    ("pushdown", None, [("x", "<", -1)]),
    ("scan", ["cat"], None),
]


@pytest.mark.parametrize("case", STATS_CASES, ids=[str(c) for c in STATS_CASES])
def test_column_stats_matches_jax(scan_files, case):
    name, columns, filters = case
    path = scan_files[name]
    with JaxReader(path) as jr:
        want = jscan.column_stats(jr, CPUS, columns=columns, filters=filters)
    with FileReader(path, device="cpu") as r:
        got = pscan.column_stats(r, ["cpu"] * 8, columns=columns, filters=filters)
    assert _stats_equal(got, want), (got, want)


def test_scan_row_groups_map_reduce_and_no_devices(scan_files):
    with FileReader(scan_files["scan"], device="cpu") as r:
        total = pscan.scan_row_groups(
            r, ["cpu", "cpu"], lambda c: ops.masked_agg(c[("x",)].values, None, "sum"),
            lambda a, b: a + b, columns=["x"],
        )
        with pytest.raises(ValueError, match="no devices"):
            pscan.scan_row_groups(r, [], lambda c: 0, lambda a, b: a)
    x = pq.read_table(scan_files["scan"]).column("x").to_numpy()
    assert int(total) == int(x.sum())


def test_process_row_groups_partition_matches_jax():
    for pc in (1, 3, 4):
        for pi in range(pc):
            assert pscan.process_row_groups(10, pi, pc) == jscan.process_row_groups(10, pi, pc)
    assert pscan.process_row_groups(5) == list(range(5))  # no group initialised


def test_distributed_column_stats_without_a_group_matches_jax(scan_files):
    with JaxReader(scan_files["scan"]) as jr:
        want = jscan.distributed_column_stats(jr, columns=["x", "f"])
    with FileReader(scan_files["scan"], device="cpu") as r:
        got = pscan.distributed_column_stats(r, columns=["x", "f"])
    assert _stats_equal(got, want)


# -- over gloo -----------------------------------------------------------------------


def _dry_file(path) -> str:
    """The entry point's dry-run file (a dictionary-friendly int64 `a`, a
    DELTA `ts`, an optional `x` with every fifth row null), written with the
    port's write_column in 4 row groups of 2,048 rows."""
    from parquet_tpu.schema.dsl import parse_schema

    n_rows = 8_192
    rng = np.random.default_rng(7)
    a = rng.integers(0, 50, n_rows).astype(np.int64)
    ts = (10_000 + np.cumsum(rng.integers(0, 9, n_rows))).astype(np.int64)
    xv = rng.integers(0, 99, n_rows).astype(np.int64)
    valid = np.arange(n_rows) % 5 != 0
    jschema = parse_schema("message m { required int64 a; required int64 ts; optional int64 x; }")
    schema = Schema.from_thrift(jschema.to_thrift())
    with FileWriter(str(path), schema, codec="snappy",
                    column_encodings={"ts": "DELTA_BINARY_PACKED"}) as w:
        for g in range(4):
            s = slice(g * 2048, (g + 1) * 2048)
            w.write_column("a", a[s])
            w.write_column("ts", ts[s])
            w.write_column("x", xv[s][valid[s]], def_levels=valid[s].astype(np.uint16))
            w.flush_row_group()
    return str(path)


def _reduce_cases(world: int):
    """(per-rank partials, replicas) cases: distinct partials, a NaN partial
    on the last rank, and every rank the same partial over `world` replicas."""
    rng = np.random.default_rng(world)
    distinct = []
    for r in range(world):
        distinct.append({
            ("x",): {"min": np.int64(rng.integers(-100, 100)),
                     "max": np.int64(rng.integers(100, 300)), "count": np.int64(5 + r)},
            ("f",): {"min": np.float64(-r - 0.5), "max": np.float64(r * 1.5),
                     "count": np.int64(3)},
            ("b",): {"min": np.bool_(r % 2), "max": np.bool_(r == 0), "count": np.int64(1)},
        })
    nan = [dict(p) for p in distinct]
    nan[-1][("f",)] = {"min": np.float64(np.nan), "max": np.float64(np.nan),
                       "count": np.int64(2)}
    same = [distinct[0]] * world
    return [(distinct, 1), (nan, 1), (same, world)]


def _jax_reduce(partials, world: int, replicas: int) -> dict:
    """The reference's reduce_one (pmin/pmax/psum // r) over a CPU mesh of
    `world` devices, one partial a device."""
    mesh = Mesh(np.array(CPUS[:world]), ("_all",))

    def step(tree):
        return {p: {"min": jax.lax.pmin(s["min"], "_all"), "max": jax.lax.pmax(s["max"], "_all"),
                    "count": jax.lax.psum(s["count"], "_all") // replicas}
                for p, s in tree.items()}

    stacked = {k: {f: jax.device_put(np.stack([np.asarray(p[k][f]).reshape(1)
                                                for p in partials]),
                                     NamedSharding(mesh, P("_all")))
                   for f in ("min", "max", "count")}
               for k in partials[0]}
    out = jax.shard_map(step, mesh=mesh, in_specs=P("_all"), out_specs=P("_all"),
                        check_vma=False)(stacked)
    return {k: {f: np.asarray(v)[0] for f, v in s.items()} for k, s in out.items()}


def _jax_batches(path, batch_size, world, **kw):
    mesh = Mesh(np.array(CPUS[:world]), ("d",))
    with JaxReader(path) as jr:
        out = []
        for b in jr.iter_device_batches(batch_size, sharding=NamedSharding(mesh, P("d")), **kw):
            flat = {}
            for p, v in b.items():
                if isinstance(v, tuple):
                    flat.update({(p, f): _shards(a, world) for f, a in zip(v._fields, v)})
                else:
                    flat[p] = _shards(v, world)
            out.append(flat)
    return out


def _shards(a, world):
    """The per-device shards of a JAX array in device order (the whole array
    on shard 0 and empty elsewhere when it is not sharded)."""
    shards = sorted(a.addressable_shards, key=lambda s: s.device.id)
    if len(shards) == world:
        return [np.asarray(s.data) for s in shards]
    whole = np.asarray(a)
    return [whole] + [whole[:0]] * (world - 1)


BATCH_KW = dict(nullable="mask", drop_remainder=False)


def _spec(world, files, grid_case):
    spec = {
        "reduce": _reduce_cases(world),
        "stats": [(files["scan"], ["x", "i", "g"], None),
                  (files["scan"], ["f"], None),
                  (files["pushdown"], None, [("x", ">=", 1_000_000)]),
                  (files["nb"], None, None)],
        "batches": [(files["dry"], 1000, BATCH_KW)],  # 8,192 rows: a 192-row tail
    }
    if world == 4:
        spec["decode"] = [(_port_grid(g), d, n) for g, d, n in map(_grid_case, grid_case)]
        spec["steps"] = _steps_inputs(files["dry"])
    return spec


GRID_SPAWNED = ("ragged", "out_of_range_dict")


@pytest.fixture(scope="module")
def spawned(scan_files):
    """One gloo spawn per world size, run at its first use: {world: results
    by rank}."""
    cache: dict = {}

    def get(world):
        if world not in cache:
            cache[world] = tdist.spawn(
                tdist.run_checks, world, _spec(world, scan_files, GRID_SPAWNED), timeout=120.0
            )
        return world, cache[world], GRID_SPAWNED

    return get


@pytest.fixture(params=[2, 4])
def ranks(request, spawned):
    return spawned(request.param)


def test_gloo_mesh_reduce_stats_matches_jax(ranks):
    world, out, _ = ranks
    for c, (partials, replicas) in enumerate(_reduce_cases(world)):
        want = _jax_reduce(partials, world, replicas)
        for r in range(world):
            assert _stats_equal(out[r]["reduce"][c], want), (c, r, out[r]["reduce"][c], want)
        if replicas > 1:
            # every rank the same partial: the reference's own function
            got_ref = jscan.mesh_reduce_stats(
                {k: {f: jnp.asarray(v) for f, v in s.items()} for k, s in partials[0].items()},
                Mesh(np.array(CPUS[:world]), ("hosts",)), replicas_per_participant=replicas)
            ref = {k: {f: np.asarray(v)[()] for f, v in s.items()} for k, s in got_ref.items()}
            assert _stats_equal(out[0]["reduce"][c], ref)


def _nan_rule(path, column, world) -> dict:
    """The reference's NaN rule, level by level, for a column read by
    `world` participants: a participant's fold propagates NaN (jnp.min,
    jnp.minimum), the collective skips it (pmin / pmax on the CPU mesh)."""
    pf = pq.ParquetFile(path)
    groups = [pf.read_row_group(g, columns=[column]).column(0).to_numpy()
              for g in range(pf.num_row_groups)]
    parts = [np.concatenate(groups[r::world]) for r in range(world)]
    lo = [p.min() for p in parts]  # NaN propagates within a participant
    hi = [p.max() for p in parts]
    lo = [v for v in lo if not np.isnan(v)]
    hi = [v for v in hi if not np.isnan(v)]
    return {(column,): {"min": np.float64(min(lo, default=np.inf)),
                        "max": np.float64(max(hi, default=-np.inf)),
                        "count": sum(len(g) for g in groups)}}


def test_gloo_distributed_column_stats_matches_jax(ranks, scan_files):
    """Against the JAX function over a CPU mesh of the same size. A NaN
    column is held against the reference's rules level by level instead:
    the single-process reference folds every group (NaN included) into one
    partial before its collective, while each rank here folds only its own,
    so which participant reads the NaN group changes the answer."""
    world, out, _ = ranks
    mesh = Mesh(np.array(CPUS[:world]), ("hosts",))
    for c, (path, columns, filters) in enumerate(_spec(world, scan_files, ())["stats"]):
        if columns == ["f"]:
            want = _nan_rule(path, "f", world)
            for r in range(world):
                assert _stats_equal(out[r]["stats"][c], want), (c, r, out[r]["stats"][c], want)
            continue
        with JaxReader(path) as jr:
            want = jscan.distributed_column_stats(jr, columns, mesh=mesh, devices=CPUS[:world],
                                                  filters=filters)
        for r in range(world):
            assert _stats_equal(out[r]["stats"][c], want), (c, r)


def test_gloo_sharded_batches_match_jax_shards(ranks, scan_files):
    world, out, _ = ranks
    want = _jax_batches(scan_files["dry"], 1000, world, **BATCH_KW)
    for r in range(world):
        got = out[r]["batches"][0]
        assert len(got) == len(want)
        for gb, wb in zip(got, want):
            assert gb.keys() == wb.keys()
            for p in wb:
                assert gb[p].dtype == wb[p][r].dtype and np.array_equal(gb[p], wb[p][r]), p


def test_gloo_sharded_decode_step_matches_jax(spawned):
    world, out, grid_cases = spawned(4)
    for c, name in enumerate(grid_cases):
        grid, dictionary, n_out = _grid_case(name)
        want_dec, want_st = _jax_decode(grid, dictionary, n_out, n_dev=4)
        got = np.concatenate([out[r]["decode"][c][0] for r in range(4)])
        assert np.array_equal(got, want_dec), name
        for r in range(4):
            assert _stats_equal({"s": out[r]["decode"][c][1]}, {"s": want_st})


# -- the entry point's steps over a 2 x 2 mesh ---------------------------------------


def _steps_inputs(dry_path):
    """decode_step's grid (entry(): 4 pages of 2,048, 100 keys) and the dry
    run's stacked (cols, pages) arrays for a 2 x 2 mesh (2 columns of 4
    pages of 512, 64 keys, seeds 0 and 1), padded as the reference pads."""
    grid, dictionary, _ = _grid_tensors(4, 2048, 100)
    return (_port_grid(grid), dictionary, 2048, _stacked(), dry_path)


def _stacked():
    out_per_page = 512
    grids, dicts = [], []
    for c in range(2):
        g, d, _e = _grid_tensors(4, out_per_page, dict_size=64, seed=c)
        grids.append(g)
        dicts.append(d)

    def stack(attr, fill=0):
        arrs = [getattr(g, attr) for g in grids]
        if arrs[0].ndim == 1:
            return np.stack(arrs)
        dim = max(a.shape[-1] for a in arrs)
        return np.stack([np.pad(a, [(0, 0), (0, dim - a.shape[-1])], constant_values=fill)
                         for a in arrs])

    return (stack("words"), stack("starts", out_per_page + 1), stack("is_rle"),
            stack("values"), stack("bit_starts"), stack("counts"), np.stack(dicts),
            grids[0].width, out_per_page)


def _jax_mesh_step(words, starts, is_rle, values, bit_starts, counts, dict_arr, width, n_out):
    """The reference dry run's col_step / step over a 2 x 2 CPU mesh."""
    mesh = Mesh(np.array(CPUS[:4]).reshape(2, 2), ("pages", "cols"))

    def col_step(words, starts, is_rle, values, bit_starts, counts, dict_dev):
        expand = jax.vmap(partial(jmesh._expand_one_page, width=width, n_out=n_out))
        decoded = dict_dev[expand(words, starts, is_rle, values, bit_starts)]
        valid = jnp.arange(n_out, dtype=jnp.int32).reshape(1, -1) < counts.reshape(-1, 1)
        count = jax.lax.psum(jnp.sum(valid.astype(jnp.int64)), "pages")
        checksum = jax.lax.psum(jnp.sum(jnp.where(valid, decoded, 0)), "pages")
        return decoded, count, jax.lax.all_gather(checksum, "cols")

    def step(*args):
        return jax.vmap(col_step)(*args)

    spec = P("cols", "pages")
    fn = jax.shard_map(step, mesh=mesh, in_specs=(spec,) * 6 + (P("cols"),),
                       out_specs=(spec, P("cols"), P("cols")))
    put = lambda a, s: jax.device_put(a, NamedSharding(mesh, s))  # noqa: E731
    args = [put(a, spec) for a in (words, starts, is_rle, values, bit_starts, counts)]
    dec, cnt, sums = jax.jit(fn)(*args, put(dict_arr, P("cols")))
    return np.asarray(dec), np.asarray(cnt), np.asarray(sums)


def test_gloo_entry_steps_match_jax(spawned, scan_files):
    _world, out, _ = spawned(4)
    from __graft_entry__ import entry

    fn, args = entry()
    jdec, jst = jax.jit(fn)(*args)
    stacked = _stacked()
    mdec, mcnt, msums = _jax_mesh_step(*stacked)
    with JaxReader(scan_files["dry"]) as jr:
        mesh = Mesh(np.array(CPUS[:4]).reshape(2, 2), ("pages", "cols"))
        sharding = NamedSharding(mesh, P(mesh.axis_names))
        total = seen = 0
        for b in jr.iter_device_batches(128 * 4, sharding=sharding, nullable="mask",
                                        drop_remainder=False):
            xa = b[("x",)]
            total += int(jnp.where(xa.mask, xa.values, 0).sum() + b[("a",)].sum())
            seen += int(xa.mask.sum())
        jstats = jscan.distributed_column_stats(jr, columns=[("a",), ("ts",)], mesh=mesh,
                                                devices=CPUS[:4])
    for r in range(4):
        st = out[r]["steps"]
        dec, dst = st["decode"]
        assert np.array_equal(dec, np.asarray(jdec))
        assert int(dst["count"]) == int(jst["count"]) and int(dst["checksum"]) == int(
            jst["checksum"])
        pi, ci = divmod(r, 2)
        sdec, scnt, ssums = st["mesh"]
        assert np.array_equal(sdec, mdec[ci, pi * 2:(pi + 1) * 2])
        assert int(scnt) == int(mcnt.reshape(-1)[ci])
        assert np.array_equal(ssums, msums.reshape(2, -1)[ci])
        assert st["train"].tolist() == [total, seen]
        assert _stats_equal(st["stats"], jstats)


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        tdist.spawn(tdist.run_checks, 2, {"reduce": [([{}], 1)]}, timeout=60.0)


def test_port_modules_import_no_jax():
    code = (
        "import sys, chip_smoke, parquet_tpu_torch.serve, parquet_tpu_torch.parallel, "
        "parquet_tpu_torch.testing.dist\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'parquet_tpu' or m.startswith('parquet_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_shard_batches_splits_rows_and_keeps_the_tail_on_rank0():
    from parquet_tpu_torch.core.reader import MaskedColumn, _shard_batches

    def stream():
        for n in (8, 8, 3):
            v = torch.arange(n)
            yield {("v",): v, ("m",): MaskedColumn(v * 2, v % 2 == 0)}

    for world in (1, 2, 4):
        per_rank = [list(_shard_batches(stream(), r, world)) for r in range(world)]
        for k, want in enumerate(stream()):
            got = [b[k] for b in per_rank]
            for p in (("v",),):
                assert torch.equal(torch.cat([g[p] for g in got]), want[p])
            assert torch.equal(torch.cat([g[("m",)].mask for g in got]), want[("m",)].mask)
        tails = [b[-1][("v",)].numel() for b in per_rank]
        assert tails == ([3] + [0] * (world - 1) if world > 1 else [3])
