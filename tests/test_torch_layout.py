"""The batch path's four device programs, plain versions against JAX.

record_starts, list_layout, pad_ragged and expand_nullable of the port take
their plain PyTorch versions for CPU tensors; each is held against the JAX
program it replaces (record_starts_device, list_layout_device, and the
jitted inner functions of _pad_ragged_device and _expand_nullable_device)
on seeded inputs that reach every clamp of the reference: leading entries
before the first record or slot, gather indices past either end of the
values, no values at all, all-null and no-null masks. The comparison is
exact, dtypes included. DeviceColumn.list_layout is held against the JAX
package's on the same files. The CUDA kernels themselves run in
chip_smoke.py.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops as jops  # noqa: E402  (turns x64 on first)
import jax.numpy as jnp  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.core.reader import _expand_nullable_device as j_expand  # noqa: E402
from parquet_tpu.core.reader import _pad_ragged_device as j_pad  # noqa: E402

from parquet_tpu_torch import FileReader  # noqa: E402
from parquet_tpu_torch.kernels import device_ops as ops  # noqa: E402
from parquet_tpu_torch.kernels.pipeline import DeviceColumn  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import CompressionCodec as C  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Encoding as E  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Type as T  # noqa: E402
from parquet_tpu_torch.testing.synth import (  # noqa: E402
    ColumnSpec,
    expand_nullable_edge_cases,
    nullable_args,
    pad_ragged_edge_cases,
    pad_ragged_tile_rows,
    pad_ragged_wide,
    list_layout_edge_cases,
    record_starts_edge_cases,
    write_file,
)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _levels(seed: int, n: int, max_rep: int = 2, max_def: int = 3, lead: int = 0):
    """Seeded rep/def streams; the first `lead` entries start no record."""
    rng = np.random.default_rng(seed)
    rep = rng.integers(0, max_rep + 1, n).astype(np.int32)
    if n > lead:
        rep[lead] = 0
    rep[:lead] = rng.integers(1, max_rep + 1, lead) if max_rep else 0
    dfl = rng.integers(0, max_def + 1, n).astype(np.int32)
    return rep, dfl


LEVEL_CASES = {
    "empty": (0, 0),
    "one": (1, 0),
    "one_leading": (1, 1),
    "leading": (300, 3),
    "long": (5000, 0),
    "long_leading": (5001, 17),
}


@pytest.mark.parametrize("case", sorted(LEVEL_CASES))
def test_record_starts_plain_matches_jax(case):
    n, lead = LEVEL_CASES[case]
    rep, _ = _levels(len(case), n, lead=lead)
    row_of, n_rows = ops.record_starts(torch.from_numpy(rep))
    j_row_of, j_n_rows = jops.record_starts_device(jnp.asarray(rep))
    _same(row_of, j_row_of)
    # the count is int64 on both sides (the JAX program's under x64)
    _same(n_rows, j_n_rows)
    if lead:
        assert (row_of[:lead] == -1).all()


RECORD_EDGE = record_starts_edge_cases(ops.RECORD_STARTS_TILE, seed=19)


@pytest.mark.parametrize("label,rep", RECORD_EDGE, ids=[c[0] for c in RECORD_EDGE])
def test_record_starts_edge_cases_match_jax(label, rep):
    """The record-start kernel's edge cases (sizes around its tile, leading
    non-starts longer than a tile, a tile with no start, a tile of starts
    only): the plain version equals the JAX program bit for bit."""
    row_of, n_rows = ops.record_starts(torch.from_numpy(rep))
    j_row_of, j_n_rows = jops.record_starts_device(jnp.asarray(rep))
    _same(row_of, j_row_of)
    _same(n_rows, j_n_rows)


def test_record_starts_edge_cases_cover_the_tile():
    """Sizes tile - 1, tile and tile + 1, a leading run of non-starts past
    the first tile, and a whole tile without a start and one of starts
    only."""
    t = ops.RECORD_STARTS_TILE
    sizes = {len(rep) for _, rep in RECORD_EDGE}
    assert {0, 1, t - 1, t, t + 1} <= sizes
    starts = [np.flatnonzero(rep == 0) for _, rep in RECORD_EDGE]
    assert any(len(s) and s[0] > t for s in starts)
    tiles = [rep[k * t : (k + 1) * t] for _, rep in RECORD_EDGE for k in range(len(rep) // t)]
    assert any((x != 0).all() for x in tiles) and any((x == 0).all() for x in tiles)


def test_record_starts_tile_pinned_to_the_kernel():
    """RECORD_STARTS_TILE, around which the edge cases put their sizes and
    the wrapper sizes its look-back descriptors, is the kernel's tile
    (kThreads * kItems of record_starts.cu), whole 16-byte vectors."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "record_starts.cu").read_text()
    k = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert k["kThreads"] * k["kItems"] == ops.RECORD_STARTS_TILE
    assert k["kItems"] % 4 == 0


@pytest.mark.parametrize("case", sorted(LEVEL_CASES))
@pytest.mark.parametrize("parent_rep,elem_def", [(0, 1), (0, 2), (1, 3), (0, 4)])
def test_list_layout_plain_matches_jax(case, parent_rep, elem_def):
    n, lead = LEVEL_CASES[case]
    rep, dfl = _levels(len(case) + 7 * elem_def, n, lead=lead)
    got = ops.list_layout(torch.from_numpy(rep), torch.from_numpy(dfl), parent_rep, elem_def)
    want = jops.list_layout_device(jnp.asarray(rep), jnp.asarray(dfl), parent_rep, elem_def)
    for g, w in zip(got, want):
        _same(g, w)


LAYOUT_EDGE = list_layout_edge_cases(ops.LIST_LAYOUT_TILE, seed=29)


@pytest.mark.parametrize("label,rep,dfl,parent_rep,elem_def", LAYOUT_EDGE,
                         ids=[c[0] for c in LAYOUT_EDGE])
def test_list_layout_edge_cases_match_jax(label, rep, dfl, parent_rep, elem_def):
    """The list-layout kernel's edge cases (sizes around its tile,
    boundaries at tile and vector edges, tiles of no boundary and of
    boundaries only, leading non-boundaries past a tile, tails starting in
    the first and the last tile): the plain version equals the JAX program
    bit for bit."""
    got = ops.list_layout(torch.from_numpy(rep), torch.from_numpy(dfl), parent_rep, elem_def)
    want = jops.list_layout_device(jnp.asarray(rep), jnp.asarray(dfl), parent_rep, elem_def)
    for g, w in zip(got, want, strict=True):
        _same(g, w)


def test_list_layout_edge_cases_cover_the_tile():
    """Sizes tile - 1, tile and tile + 1; boundaries at a tile's first and
    last entry and at a 4-entry vector's; a tile without a boundary and one
    of boundaries only; a stream of boundaries only and one with none past
    a tile; leading non-boundaries past the first tile; a tail (entries
    from n_slots on) starting in the first tile and one in the last."""
    t = ops.LIST_LAYOUT_TILE
    assert {0, 1, t - 1, t, t + 1} <= {len(c[1]) for c in LAYOUT_EDGE}
    seen = set()
    for _, rep, _, parent_rep, _ in LAYOUT_EDGE:
        n = len(rep)
        b = np.flatnonzero(rep <= parent_rep)
        inner = b[b > 0]
        seen |= {("tile first", bool((inner % t == 0).any())),
                 ("tile last", bool((b % t == t - 1).any())),
                 ("vector first", bool((inner % 4 == 0).any())),
                 ("vector last", bool((b % 4 == 3).any()))}
        tiles = [rep[k * t : (k + 1) * t] <= parent_rep for k in range(n // t)]
        seen.add(("no boundary tile", any(not x.any() for x in tiles)))
        seen.add(("boundary tile", any(x.all() for x in tiles)))
        if n > t:
            seen.add(("all boundaries", len(b) == n))
            seen.add(("no boundary", len(b) == 0))
            seen.add(("leading", len(b) > 0 and b[0] > t))
            seen.add(("tail in the first tile", 0 < len(b) < t))
            seen.add(("tail in the last tile", len(b) < n and len(b) // t == (n - 1) // t))
    assert {k for k, v in seen if v} == {k for k, _ in seen}


def test_list_layout_tile_pinned_to_the_kernel():
    """LIST_LAYOUT_TILE, around which the edge cases put their sizes and
    the wrapper sizes its look-back descriptors, is the kernel's tile
    (kThreads * kItems of list_layout.cu), whole 4-entry vectors."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "list_layout.cu").read_text()
    k = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert k["kThreads"] * k["kItems"] == ops.LIST_LAYOUT_TILE
    assert k["kItems"] % 4 == 0


def test_list_layout_leading_entry_counts_into_slot_zero():
    # slot_of == -1 for the leading entry: the reference's clip puts it in
    # slot 0 (the seeded check of the issue text)
    rep = np.array([1, 0, 1, 0, 0], np.int32)
    dfl = np.array([2, 2, 1, 0, 2], np.int32)
    offsets, first_def, n_slots = ops.list_layout(torch.from_numpy(rep), torch.from_numpy(dfl), 0, 2)
    assert offsets.tolist() == [0, 2, 2, 3, 3, 3]
    assert first_def.tolist() == [2, 0, 2, 0, 0]
    assert int(n_slots) == 3
    want = jops.list_layout_device(jnp.asarray(rep), jnp.asarray(dfl), 0, 2)
    for g, w in zip((offsets, first_def, n_slots), want):
        _same(g, w)


def test_list_layout_saturated_def_and_no_boundary():
    rep = np.array([1, 1, 2, 1], np.int32)  # no entry opens a slot
    dfl = np.full(4, np.iinfo(np.int32).max, np.int32)
    got = ops.list_layout(torch.from_numpy(rep), torch.from_numpy(dfl), 0, 3)
    want = jops.list_layout_device(jnp.asarray(rep), jnp.asarray(dfl), 0, 3)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[0].tolist() == [0, 3, 3, 3, 3]  # rep <= 1 starts an element


DTYPES = [np.bool_, np.int32, np.int64, np.float32, np.float64]


def _values(rng, nv, dt):
    if dt is np.bool_:
        return rng.random(nv) > 0.5
    if np.dtype(dt).kind == "f":
        return rng.standard_normal(nv).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, nv, dtype=dt, endpoint=True)


# (rows, max_len, nv, lengths rule): "fit" sums to nv; "over" asks past the
# end of the values (clamp high); "neg" has negative lengths, so a later
# row's offset is below its elements (clamp low); "none" has nv == 0
PAD_CASES = {
    "fit": (64, 8, None, "fit"),
    "max_len_1": (50, 1, None, "fit"),
    "over": (40, 6, 30, "over"),
    "neg": (30, 5, 40, "neg"),
    "none": (12, 4, 0, "over"),
    "no_rows": (0, 4, 5, "over"),
    "long_rows": (3, 2500, None, "fit"),
}


def _pad_inputs(case, dt, len_dtype, seed):
    rows, max_len, nv, rule = PAD_CASES[case]
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len + 1, rows)
    if rule == "neg" and rows:
        lengths[rows // 2] = -7
    if nv is None:
        nv = int(lengths.sum())
    return _values(rng, nv, dt), lengths.astype(len_dtype), max_len


@pytest.mark.parametrize("case", sorted(PAD_CASES))
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
def test_pad_ragged_plain_matches_jax(case, dt):
    for len_dtype in (np.int32, np.int64):
        values, lengths, max_len = _pad_inputs(case, dt, len_dtype, seed=len(case))
        got = ops.pad_ragged(torch.from_numpy(values), torch.from_numpy(lengths), max_len)
        want = j_pad(jnp.asarray(values), jnp.asarray(lengths), max_len)
        _same(got, want.values)


PAD_EDGE = pad_ragged_edge_cases(seed=17)


@pytest.mark.parametrize("case", PAD_EDGE, ids=[c.label for c in PAD_EDGE])
def test_pad_ragged_edge_cases_match_jax(case):
    """The padding kernel's edge cases (tile boundaries, negative lengths at
    a tile's first and last row, wrapping and clipped offsets, lengths past
    int32, nv 0 and over, max_len 0, 1, 16 and 2,500, rows written in
    spans): the plain version equals the JAX program bit for bit."""
    got = ops.pad_ragged(torch.from_numpy(case.values), torch.from_numpy(case.lengths),
                         case.max_len)
    want = j_pad(jnp.asarray(case.values), jnp.asarray(case.lengths), case.max_len)
    _same(got, want.values)


def test_pad_ragged_edge_cases_cover_every_width_and_tile_edge():
    """Each element width and length dtype has cases at a tile's edges
    (tile - 1, tile, tile + 1 rows), cases whose int32 offsets wrap or clip
    (the reference's rules, not an in-range copy), wide rows (16-row
    tiles) and rows wider than a tile's bytes (written in spans), whose
    spans cross row ends."""
    seen = {}
    for c in PAD_EDGE:
        key = (c.values.itemsize, c.lengths.dtype.itemsize)
        t = pad_ragged_tile_rows(max(c.max_len, 1), c.values.itemsize)
        offs = np.cumsum(c.lengths.astype(np.int32).astype(np.int64))
        wraps = bool((offs > 2**31 - 1).any() or (offs > len(c.values)).any()
                     or (c.lengths < 0).any())
        marks = seen.setdefault(key, set())
        marks.add("edge" if abs(len(c.lengths) - t) <= 1 else "wrap" if wraps else "other")
        if t == 16:
            marks.add("wide")
        if pad_ragged_wide(c.max_len, c.values.itemsize):
            span = ops.PAD_RAGGED_TILE_BYTES // c.values.itemsize
            if len(c.lengths) * c.max_len > span and c.max_len % span:
                marks.add("spans")
    assert sorted(seen) == [(e, w) for e in (1, 4, 8) for w in (4, 8)]
    assert all({"edge", "wrap", "wide", "spans"} <= m for m in seen.values()), seen


def test_pad_ragged_tile_pinned_to_the_kernel():
    """PAD_RAGGED_TILE and PAD_RAGGED_TILE_BYTES, from which the edge cases
    take their tiles, are the kernel's (kThreads * kItems and kTileBytes of
    pad_ragged.cu); a tile is a multiple of 16 rows; rows whose output
    exceeds kTileBytes go to the span kernel (wide_rows), as
    synth.pad_ragged_wide says, at any max_len."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "pad_ragged.cu").read_text()
    k = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert k["kThreads"] * k["kItems"] == ops.PAD_RAGGED_TILE
    assert k["kTileBytes"] == ops.PAD_RAGGED_TILE_BYTES
    for max_len in (1, 16, 100, 2500, 1 << 20):
        for e in (1, 4, 8):
            t = pad_ragged_tile_rows(max_len, e)
            assert t % 16 == 0 and 16 <= t <= ops.PAD_RAGGED_TILE
    assert "return max_len * elem_bytes > kTileBytes;" in src
    for e in (1, 4, 8):
        edge = ops.PAD_RAGGED_TILE_BYTES // e
        assert not pad_ragged_wide(edge, e) and pad_ragged_wide(edge + 1, e)
        for max_len in (2**31 - 1, 2**31 + 4096, 2**40):
            assert pad_ragged_tile_rows(max_len, e) == ops.PAD_RAGGED_TILE


MASK_CASES = {
    "random": (500, None),
    "all_null": (300, 0.0),
    "no_null": (300, 1.0),
    "empty": (0, None),
    "one_valid": (1, 1.0),
    "one_null": (1, 0.0),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("short", [0, 5, None], ids=["exact", "short", "no_values"])
def test_expand_nullable_plain_matches_jax(case, dt, short):
    n, p = MASK_CASES[case]
    rng = np.random.default_rng(n + (short or 0))
    mask = rng.random(n) < (0.7 if p is None else p)
    # fewer values than valid rows reach the reference's high clamp
    nv = 0 if short is None else max(int(mask.sum()) - short, 0)
    values = _values(rng, nv, dt)
    got = ops.expand_nullable(torch.from_numpy(values), torch.from_numpy(mask))
    want = j_expand(jnp.asarray(values), jnp.asarray(mask))
    _same(got, want.values)


NULLABLE_EDGE = expand_nullable_edge_cases(ops.EXPAND_NULLABLE_TILE, seed=43,
                                           group=ops.EXPAND_NULLABLE_GROUP)


@pytest.mark.parametrize("case", NULLABLE_EDGE, ids=[c.label for c in NULLABLE_EDGE])
def test_expand_nullable_edge_cases_match_jax(case):
    """The null expansion's tile and group edges, masks all valid, all null
    and random, nv exact, short (the high clamp), zero and long, 1-, 4- and
    8-byte values and views off 16 bytes: the port equals the reference's
    jitted `expand` bit for bit."""
    values, mask = nullable_args(case)
    got = ops.expand_nullable(torch.from_numpy(values), torch.from_numpy(mask))
    _same(got, j_expand(jnp.asarray(values), jnp.asarray(mask)).values)


def test_expand_nullable_edge_cases_cover_the_tile():
    """The cases reach every size the two launches turn on: around a
    thread's 16 rows and a tile, a whole group of tiles and past it, past
    two groups; each element width with nv short, zero and long, and views
    of the values and the mask off 16 bytes."""
    t, g = ops.EXPAND_NULLABLE_TILE, ops.EXPAND_NULLABLE_GROUP
    sizes = {len(c.mask) - c.mask_shift for c in NULLABLE_EDGE}
    assert {0, 1, 15, 16, 17, t - 1, t, t + 1, g * t, g * t + 1, 2 * g * t + t + 3} <= sizes
    for e in (1, 4, 8):
        mine = [c for c in NULLABLE_EDGE if c.values.itemsize == e]
        assert {"exact", "short", "zero", "long"} <= {c.label.split("nv ")[1].split()[0]
                                                      for c in mine}
        assert any(c.values_shift * e % 16 and c.mask_shift % 16 for c in mine)
    for c in NULLABLE_EDGE:
        m = c.mask[c.mask_shift:]
        if "all valid" in c.label:
            assert m.all() and len(m)
        if "all null" in c.label:
            assert not m.any() and len(m)


def test_expand_nullable_tile_pinned_to_the_kernel():
    """EXPAND_NULLABLE_TILE and EXPAND_NULLABLE_GROUP, around which the edge
    cases put their sizes and the wrapper sizes the tile and group counts,
    are the kernel's tile (kThreads * kItems of expand_nullable.cu, whole
    16-byte vectors of the validity) and its tiles a group."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "expand_nullable.cu").read_text()
    k = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert k["kThreads"] * k["kItems"] == ops.EXPAND_NULLABLE_TILE
    assert k["kItems"] % 16 == 0
    assert re.search(r"constexpr int kGroup = kThreads;", src)
    assert k["kThreads"] == ops.EXPAND_NULLABLE_GROUP
    assert "constexpr int kVec = 16;" in (build.CSRC / "validity.cuh").read_text()


def test_two_d_values_refused_on_both_sides():
    values = np.zeros((6, 4), np.uint8)
    lengths = np.array([1, 2, 0, 1, 1], np.int64)
    mask = np.array([True, False, True, True, True, True, True])
    with pytest.raises(ValueError):
        j_pad(jnp.asarray(values), jnp.asarray(lengths), 3)
    with pytest.raises(ValueError, match="no device batch layout"):
        ops.pad_ragged(torch.from_numpy(values), torch.from_numpy(lengths), 3)
    with pytest.raises(ValueError):
        j_expand(jnp.asarray(values), jnp.asarray(mask))
    with pytest.raises(ValueError, match="no device batch layout"):
        ops.expand_nullable(torch.from_numpy(values), torch.from_numpy(mask))


def test_wrapper_input_checks():
    i32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.record_starts(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="def levels"):
        ops.list_layout(i32, torch.zeros(3, dtype=torch.int32), 0, 1)
    with pytest.raises(TypeError):
        ops.pad_ragged(i32, torch.zeros(2, dtype=torch.int16), 3)
    with pytest.raises(ValueError, match="negative"):
        ops.pad_ragged(i32, torch.zeros(2, dtype=torch.int32), -1)
    with pytest.raises(TypeError):
        ops.expand_nullable(i32, torch.ones(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.expand_nullable(torch.zeros(4, dtype=torch.complex64), torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError):  # the kernels copy 1-, 4- and 8-byte elements
        ops.pad_ragged(torch.zeros(4, dtype=torch.int16), torch.zeros(2, dtype=torch.int32), 3)


# -- DeviceColumn.list_layout --------------------------------------------------


def _list_files(tmp_path):
    """A pyarrow LIST file (optional element, null/empty lists) and a synth
    LIST file (required element, dictionary leaf, V2 pages)."""
    rng = np.random.default_rng(11)
    lists = [None if i % 11 == 0 else [int(x) for x in rng.integers(0, 50, i % 7)] for i in range(900)]
    a = tmp_path / "arrow_list.parquet"
    pq.write_table(pa.table({"v": pa.array(lists, pa.list_(pa.int32()))}), a, row_group_size=400)
    n = 700
    valid = rng.random(n) > 0.1
    lengths = np.where(valid, rng.integers(0, 9, n), 0)
    s = tmp_path / "synth_list.parquet"
    write_file(s, [ColumnSpec(
        "items", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.SNAPPY, page_version=2,
        valid=valid, list_lengths=lengths, dictionary=np.arange(64, dtype=np.int32),
        indices=rng.integers(0, 64, int(lengths.sum())).astype(np.int32),
    )], row_group_rows=300, page_bytes=512)
    return [a, s]


def test_device_column_list_layout_matches_jax(tmp_path):
    for path in _list_files(tmp_path):
        with FileReader(path, device="cpu") as r, JReader(str(path), backend="tpu") as jr:
            leaf = r.schema.leaves[0]
            for g in range(r.num_row_groups):
                (dc,) = r.read_row_group_device(g).values()
                (jdc,) = jr.read_row_group_device(g).values()
                for parent_rep, elem_def in ((0, leaf.max_def - 1), (0, leaf.max_def), (0, 1)):
                    got = dc.list_layout(parent_rep, elem_def)
                    want = jdc.list_layout(parent_rep, elem_def)
                    for a, b in zip(got, want):
                        _same(a, b)
                # the levels went up once and are shared by every depth
                rep_dev = dc._dev_rep
                dc.list_layout(0, 2)
                assert dc._dev_rep is rep_dev and rep_dev.dtype == torch.int32
                # record starts of the same stream: one id per row
                row_of, n_rows = ops.record_starts(dc._dev_rep)
                _same(row_of, jops.record_starts_device(jnp.asarray(dc.rep_levels.astype(np.int32)))[0])
                assert int(n_rows) == r.row_group(g).num_rows


def test_device_column_list_layout_without_def_stream_and_without_rep():
    rep = np.array([0, 1, 1, 0, 0, 1], np.uint16)
    dc = DeviceColumn(num_values=6, values=torch.zeros(6, dtype=torch.int32), rep_levels=rep)
    offsets, first_def, n_slots = dc.list_layout(0, 1)
    assert dc._dev_def.dtype == torch.int32 and int(dc._dev_def[0]) == np.iinfo(np.int32).max
    assert offsets.tolist() == [0, 3, 4, 6, 6, 6, 6] and int(n_slots) == 3
    want = jops.list_layout_device(
        jnp.asarray(rep.astype(np.int32)), jnp.full(6, np.iinfo(np.int32).max, jnp.int32), 0, 1
    )
    for a, b in zip((offsets, first_def, n_slots), want):
        _same(a, b)
    flat = DeviceColumn(num_values=3, values=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="no repetition levels"):
        flat.list_layout(0, 1)
