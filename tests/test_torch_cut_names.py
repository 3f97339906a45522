"""The public names the port's copies had cut, against the reference's.

The same seeded inputs go through the JAX package's function and the
port's, on the CPU:

  * core/schema.py: Schema.sub_schema on a group, a nested group and a
    leaf (the SchemaError), Schema.clone independent of its source;
  * ops/levels.py: slot_ids and list_layout over every repeated depth of
    the level streams of tests/test_assembly_vec.py's nested shapes;
  * core/assembly_vec.py: assemble_rows on flat, LIST and MAP groups (raw
    and not), slice_column on the list columns of assemble_row_columns and
    on a ("slices", elems, offsets, mask) spec;
  * core/filter_vec.py: mask_to_ranges on empty, all-true, all-false,
    alternating and random masks;
  * core/arrays.py: byte_array_from_items on str, bytes, multibyte, empty
    and exotic items, with and without a to_bytes converter, and its errors;
  * core/reader.py: resolve_column_prefixes, now in the module's __all__.

Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
from parquet_tpu.core import arrays as jarrays  # noqa: E402
from parquet_tpu.core import assembly_vec as javec  # noqa: E402
from parquet_tpu.core import filter_vec as jfvec  # noqa: E402
from parquet_tpu.core import reader as jreader  # noqa: E402
from parquet_tpu.core.schema import SchemaError as JSchemaError  # noqa: E402
from parquet_tpu.ops import levels as jlevels  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema as j_parse, schema_to_string as j_str  # noqa: E402
from tests.test_assembly_vec import _nested_tables  # noqa: E402

from parquet_tpu_torch.core import arrays as parrays  # noqa: E402
from parquet_tpu_torch.core import assembly_vec as pavec  # noqa: E402
from parquet_tpu_torch.core import filter_vec as pfvec  # noqa: E402
from parquet_tpu_torch.core import reader as preader  # noqa: E402
from parquet_tpu_torch.core.schema import SchemaError as PSchemaError  # noqa: E402
from parquet_tpu_torch.ops import levels as plevels  # noqa: E402
from parquet_tpu_torch.schema.dsl import parse_schema as p_parse, schema_to_string as p_str  # noqa: E402

SCHEMA = """
message doc {
  required int64 id;
  optional group meta {
    required binary name (STRING);
    optional int32 rank;
    optional group geo {
      required double lat;
      required double lon;
    }
  }
  repeated group tags {
    required binary tag (STRING);
  }
}
"""


# -- Schema.sub_schema / clone ---------------------------------------------------


def schema_view(s) -> list:
    return [(c.path, c.max_def, c.max_rep, c.leaf_index, c.type, c.repetition)
            for c in s.leaves]


@pytest.mark.parametrize("path", ["meta", "meta.geo", ("meta", "geo"), "tags"])
def test_sub_schema_equals_the_references(path):
    got, want = p_parse(SCHEMA).sub_schema(path), j_parse(SCHEMA).sub_schema(path)
    assert p_str(got) == j_str(want)
    assert [(p, d, r, i, t.name, rep.name) for p, d, r, i, t, rep in schema_view(got)] == \
        [(p, d, r, i, t.name, rep.name) for p, d, r, i, t, rep in schema_view(want)]


@pytest.mark.parametrize("path", ["id", "meta.rank", "meta.geo.lat"])
def test_sub_schema_of_a_leaf_raises_like_the_reference(path):
    with pytest.raises(PSchemaError) as got:
        p_parse(SCHEMA).sub_schema(path)
    with pytest.raises(JSchemaError) as want:
        j_parse(SCHEMA).sub_schema(path)
    assert str(got.value) == str(want.value)


def test_sub_schema_of_a_missing_path_raises_like_the_reference():
    with pytest.raises(PSchemaError) as got:
        p_parse(SCHEMA).sub_schema("nope.x")
    with pytest.raises(JSchemaError) as want:
        j_parse(SCHEMA).sub_schema("nope.x")
    assert str(got.value) == str(want.value)


def test_clone_equals_and_is_independent_of_its_source():
    src = p_parse(SCHEMA)
    clone = src.clone()
    assert p_str(clone) == p_str(src) == j_str(j_parse(SCHEMA).clone())
    assert schema_view(clone) == schema_view(src)
    clone.column("id").element.name = "renamed"
    clone.column("meta.name").element.logicalType.STRING = None
    assert src.column("id").name == "id"
    assert src.column("meta.name").is_string()
    assert clone.column("meta.name").element.logicalType is not \
        src.column("meta.name").element.logicalType


# -- nested files: levels and assembly -------------------------------------------


@pytest.fixture(scope="module")
def nested_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cut_names")
    out = {}
    for name, table in _nested_tables().items():
        path = str(root / f"{name}.parquet")
        pq.write_table(table, path, compression="snappy", row_group_size=150)
        out[name] = path
    flat = pa.table({
        "a": np.arange(300, dtype=np.int64),
        "s": pa.array([None if i % 7 == 0 else f"s{i % 19}" for i in range(300)]),
        "f": np.random.default_rng(5).standard_normal(300),
    })
    out["flat"] = str(root / "flat.parquet")
    pq.write_table(flat, out["flat"], row_group_size=120)
    return out


SHAPES = sorted(_nested_tables()) + ["flat"]


def both_chunks(path: str, group: int = 0):
    with preader.FileReader(path, device="cpu") as p, jreader.FileReader(path) as j:
        return (p.schema, p.read_row_group(group)), (j.schema, j.read_row_group(group))


@pytest.mark.parametrize("name", [n for n in SHAPES if n not in ("flat", "optional_scalars")])
def test_slot_ids_and_list_layout_equal_the_references(nested_files, name):
    (_ps, chunks), _ = both_chunks(nested_files[name])
    checked = 0
    for cd in chunks.values():
        leaf = cd.column
        if cd.rep_levels is None:
            continue
        rep, dfl = np.asarray(cd.rep_levels), np.asarray(cd.def_levels)
        for elem_rep in range(1, leaf.max_rep + 1):
            got_slots = plevels.slot_ids(rep, elem_rep - 1)
            want_slots = jlevels.slot_ids(rep, elem_rep - 1)
            assert got_slots.dtype == want_slots.dtype
            np.testing.assert_array_equal(got_slots, want_slots)
            n_slots = int(got_slots[-1]) + 1 if len(got_slots) else 0
            for elem_def in range(1, leaf.max_def + 1):
                got = plevels.list_layout(rep, dfl, got_slots, n_slots, elem_rep, elem_def)
                want = jlevels.list_layout(rep, dfl, want_slots, n_slots, elem_rep, elem_def)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
                checked += 1
    assert checked


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("name", SHAPES)
def test_assemble_rows_equals_the_references(nested_files, name, raw):
    (ps, pc), (js, jc) = both_chunks(nested_files[name])
    got, want = pavec.assemble_rows(ps, pc, raw), javec.assemble_rows(js, jc, raw)
    assert got is not None and got == want


@pytest.mark.parametrize("name", ["flat", "list_int", "map"])
def test_slice_column_on_list_columns_equals_the_references(nested_files, name):
    (ps, pc), (js, jc) = both_chunks(nested_files[name])
    pnames, pcols, pn = pavec.assemble_row_columns(ps, pc, False)
    jnames, jcols, jn = javec.assemble_row_columns(js, jc, False)
    assert (pnames, pn) == (jnames, jn)
    for pcol, jcol in zip(pcols, jcols):
        assert isinstance(pcol, list)  # the port never defers a slices spec
        for s, e in [(0, pn), (0, 0), (3, 17), (pn - 5, pn), (pn, pn)]:
            want = javec.slice_column(jcol, s, e)
            if isinstance(want, tuple):
                want = javec._materialize_spec(want)
            assert pavec.slice_column(pcol, s, e) == list(want)


@pytest.mark.parametrize("masked", [False, True])
def test_slice_column_on_a_slices_spec_equals_the_references(masked):
    rng = np.random.default_rng(8)
    lengths = rng.integers(0, 5, 40)
    offsets = np.zeros(41, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    elems = rng.integers(-99, 99, int(offsets[-1])).tolist()
    mask = (rng.random(40) < 0.3) if masked else None
    spec = ("slices", elems, offsets, mask)
    for s, e in [(0, 40), (0, 0), (5, 23), (39, 40), (40, 40)]:
        got, want = pavec.slice_column(spec, s, e), javec.slice_column(spec, s, e)
        assert got[0] == want[0] and got[1] is want[1]
        np.testing.assert_array_equal(got[2], want[2])
        assert (got[3] is None) == (want[3] is None)
        if got[3] is not None:
            np.testing.assert_array_equal(got[3], want[3])
        assert javec._materialize_spec(got) == javec._materialize_spec(want)


def test_row_windows_go_through_slice_column(nested_files, monkeypatch):
    # the reader's ranged and masked row windows and the assembler's windows
    # slice each column with slice_column, as the reference's do
    calls = []
    real = pavec.slice_column

    def spy(col, s, e):
        calls.append((s, e))
        return real(col, s, e)

    monkeypatch.setattr(preader, "slice_column", spy)
    monkeypatch.setattr(pavec, "slice_column", spy)
    monkeypatch.setattr(preader, "_ASSEMBLE_WINDOW", 32)
    path, flt = nested_files["struct_of_list"], [("s.y", "<", 100)]
    seen = {}
    with preader.FileReader(path, device="cpu") as r, jreader.FileReader(path) as j:
        assert list(r.iter_rows()) == list(j.iter_rows())
        seen["ranged"] = len(calls)
        assert list(r.iter_rows(filters=flt)) == list(j.iter_rows(filters=flt))
        seen["masked"] = len(calls) - seen["ranged"]
        (ps, pc), (js, jc) = both_chunks(path)
        assert list(preader.RecordAssembler(ps, pc, raw=False)) == \
            list(jreader.RecordAssembler(js, jc, raw=False))
        seen["assembler"] = len(calls) - seen["ranged"] - seen["masked"]
    assert seen["ranged"] >= 150 // 32 and seen["masked"] > 0 and seen["assembler"] > 0


# -- mask_to_ranges --------------------------------------------------------------


def masks():
    rng = np.random.default_rng(4)
    return {
        "empty": np.zeros(0, dtype=bool),
        "all_true": np.ones(9, dtype=bool),
        "all_false": np.zeros(9, dtype=bool),
        "alternating": np.arange(11) % 2 == 0,
        "alternating_odd": np.arange(10) % 2 == 1,
        "random": rng.random(500) < 0.4,
        "edges": np.array([1, 0, 0, 1, 1, 0, 1], dtype=bool),
    }


@pytest.mark.parametrize("kind", sorted(masks()))
def test_mask_to_ranges_equals_the_references(kind):
    m = masks()[kind]
    got, want = pfvec.mask_to_ranges(m), jfvec.mask_to_ranges(m)
    assert got == want
    assert all(type(a) is int and type(b) is int for a, b in got)
    covered = np.zeros(len(m), dtype=bool)
    for a, b in got:
        covered[a:b] = True
    np.testing.assert_array_equal(covered, m)


# -- byte_array_from_items -------------------------------------------------------


class Token:
    def __init__(self, v):
        self.v = v


def token_bytes(t) -> bytes:
    return f"<{t.v}>".encode()


ITEMS = {
    "str": [f"v{i}" for i in range(50)],
    "bytes": [bytes([i % 256]) * (i % 7) for i in range(60)],
    "multibyte": ["héllo", "日本語", "", "x" * 300, "ü"] * 20,
    "empty": [],
    "empty_values": ["", b"", ""],
    "mixed": ["a", b"\x00raw\xff", "日", b""],
    "exotic": [memoryview(b"ab"), bytearray(b"cd"), b"ef", "gh"],
}


@pytest.mark.parametrize("kind", sorted(ITEMS))
def test_byte_array_from_items_equals_the_references(kind):
    items = ITEMS[kind]
    got, want = parrays.byte_array_from_items(items), jarrays.byte_array_from_items(items)
    assert got.data == want.data
    assert got.offsets.dtype == want.offsets.dtype
    np.testing.assert_array_equal(got.offsets, want.offsets)


def test_byte_array_from_items_with_a_converter_equals_the_references():
    items = [Token(i) for i in range(30)]
    got = parrays.byte_array_from_items(items, to_bytes=token_bytes)
    want = jarrays.byte_array_from_items(items, to_bytes=token_bytes)
    assert got.data == want.data and got.to_list() == want.to_list()


def test_byte_array_from_items_refuses_what_the_reference_refuses():
    for mod in (parrays, jarrays):
        with pytest.raises(TypeError, match="cannot convert int to bytes"):
            mod.byte_array_from_items(["a", 3])


# -- resolve_column_prefixes -----------------------------------------------------


def test_resolve_column_prefixes_is_exported_and_equal():
    assert "resolve_column_prefixes" in preader.__all__
    for columns in (None, ["meta"], ["meta.geo", "id"], [("tags",)]):
        got = preader.resolve_column_prefixes(p_parse(SCHEMA), columns)
        want = jreader.resolve_column_prefixes(j_parse(SCHEMA), columns)
        assert repr(got) == repr(want)
