"""Fixed-size device batches: the port's iter_device_batches against JAX.

The same files (written by pyarrow and by the port's synth writer from
numpy seeds) stream through parquet_tpu_torch's
`FileReader(path, device="cpu").iter_device_batches(...)` and through the
JAX package's `iter_device_batches` on CPU jax. Both packages' batches are
flattened to NumPy (testing.parity.batches_to_numpy) and compared exactly:
batch count, paths, batch types, shapes, dtypes and bytes of values, masks
and lengths. Every refusal raises the same exception type on both sides.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu import MaskedColumn as JMasked  # noqa: E402
from parquet_tpu import RaggedColumn as JRagged  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402

from parquet_tpu_torch import FileReader, MaskedColumn, RaggedColumn  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import CompressionCodec as C  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Encoding as E  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Type as T  # noqa: E402
from parquet_tpu_torch.testing.parity import batches_to_numpy  # noqa: E402
from parquet_tpu_torch.testing.synth import ColumnSpec, column_values, write_file  # noqa: E402

MAX_LEN = 8


def _arrow_file(path, n, group):
    """id, a float64 with nulls in the first and last groups only, a
    dictionary string, a bool, a float32, and a LIST<int32> with null,
    empty and at-limit (MAX_LEN) lists."""
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
        "b": pa.array(rng.random(n) > 0.5),
        "f": pa.array(rng.standard_normal(n).astype(np.float32)),
        "tags": pa.array(lists, pa.list_(pa.int32())),
    })
    pq.write_table(table, path, row_group_size=group)
    return path


def _synth_file(path, n, group):
    """The port's synth writer: a dictionary LIST (required element, V2,
    SNAPPY), a PLAIN LIST (V1), an optional dictionary int32 with nulls in
    some groups only, and a DELTA int64."""
    rng = np.random.default_rng(n + 1)
    valid = rng.random(n) > 0.08
    lengths = np.where(valid, rng.integers(0, MAX_LEN + 1, n), 0)
    lengths[5] = MAX_LEN
    plain_len = rng.integers(0, 4, n)
    opt_valid = np.ones(n, dtype=bool)
    opt_valid[group : 2 * group : 3] = False  # nulls in the second group only
    specs = [
        ColumnSpec("items", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.SNAPPY, page_version=2,
                   valid=valid, list_lengths=lengths, dictionary=np.arange(500, dtype=np.int32) * 3,
                   indices=rng.integers(0, 500, int(lengths.sum())).astype(np.int32)),
        ColumnSpec("scores", T.INT64, list_lengths=plain_len,
                   values=rng.integers(-(2**40), 2**40, int(plain_len.sum()))),
        ColumnSpec("opt", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.GZIP, valid=opt_valid,
                   dictionary=np.arange(9, dtype=np.int32), indices=rng.integers(0, 9, int(opt_valid.sum())).astype(np.int32)),
        ColumnSpec("ts", T.INT64, encoding=E.DELTA_BINARY_PACKED, page_version=2,
                   values=np.cumsum(rng.integers(-5, 100, n)).astype(np.int64)),
    ]
    write_file(path, specs, row_group_rows=group, page_bytes=1024)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("batches")
    return {
        "arrow": _arrow_file(d / "arrow.parquet", 1750, 500),
        "synth": _synth_file(d / "synth.parquet", 1300, 400),
        "tiny": _arrow_file(d / "tiny.parquet", 45, 20),
    }


def _both(path, **kw):
    with JReader(str(path)) as jr, FileReader(path, device="cpu") as r:
        want = list(jr.iter_device_batches(**kw))
        got = list(r.iter_device_batches(**kw))
    return got, want


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for path in g:
            kinds = {MaskedColumn: JMasked, RaggedColumn: JRagged}
            assert kinds.get(type(g[path]), "array") == (
                type(w[path]) if isinstance(w[path], (JMasked, JRagged)) else "array"
            ), path
        gn, wn = batches_to_numpy(g), batches_to_numpy(w)
        assert gn.keys() == wn.keys()
        for k in gn:
            a, b = gn[k], wn[k]
            assert (a.dtype, a.shape) == (b.dtype, b.shape), k
            assert a.tobytes() == b.tobytes(), k


# (file, batch size): 1; a divisor of the row group; one that spans groups;
# one larger than the file
SIZES = [("tiny", 1), ("arrow", 250), ("arrow", 650), ("arrow", 10_000),
         ("synth", 200), ("synth", 550), ("synth", 5_000)]


@pytest.mark.parametrize("name,batch_size", SIZES)
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batches_match_jax(files, name, batch_size, drop_remainder):
    got, want = _both(files[name], batch_size=batch_size, nullable="mask", lists="pad",
                      max_list_len=MAX_LEN, drop_remainder=drop_remainder)
    _assert_same_batches(got, want)
    rows = sum(next(iter(batches_to_numpy(b).values())).shape[0] for b in got)
    total = pq.ParquetFile(files[name]).metadata.num_rows
    assert rows == (total if not drop_remainder else total - total % batch_size)


def test_flat_null_free_columns_batch_as_tensors(files):
    got, want = _both(files["arrow"], batch_size=300, columns=["id", "s", "b", "f"],
                      drop_remainder=False)
    _assert_same_batches(got, want)
    first = got[0]
    assert all(isinstance(t, torch.Tensor) for t in first.values())
    # a dictionary string column yields its int32 indices
    assert first[("s",)].dtype == torch.int32
    assert first[("id",)].tolist() == list(range(300))


def test_masked_column_structure_is_stable(files):
    # "x" has nulls in the first and last groups only: every batch still
    # carries a MaskedColumn, and the null rows read 0
    got, want = _both(files["arrow"], batch_size=333, columns=["x"], nullable="mask",
                      drop_remainder=False)
    _assert_same_batches(got, want)
    assert all(isinstance(b[("x",)], MaskedColumn) for b in got)
    masks = np.concatenate([b[("x",)].mask.numpy() for b in got])
    vals = np.concatenate([b[("x",)].values.numpy() for b in got])
    assert not masks.all() and masks[500:1500].all()
    assert (vals[~masks] == 0).all()


def test_padded_lists_equal_the_generator(files, tmp_path):
    rng = np.random.default_rng(3)
    n = 600
    valid = rng.random(n) > 0.1
    lengths = np.where(valid, rng.integers(0, 5, n), 0)
    spec = ColumnSpec("items", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.SNAPPY,
                      page_version=2, valid=valid, list_lengths=lengths,
                      dictionary=np.arange(70, dtype=np.int32) - 35,
                      indices=rng.integers(0, 70, int(lengths.sum())).astype(np.int32))
    path = tmp_path / "gen.parquet"
    write_file(path, [spec], row_group_rows=250, page_bytes=256)
    got, want = _both(path, batch_size=128, lists="pad", max_list_len=4, drop_remainder=False)
    _assert_same_batches(got, want)
    vals = np.concatenate([b[spec.path].values.numpy() for b in got])
    lens = np.concatenate([b[spec.path].lengths.numpy() for b in got])
    np.testing.assert_array_equal(lens, lengths)
    flat = vals[np.arange(4)[None, :] < lens[:, None]]
    np.testing.assert_array_equal(flat, column_values(spec))
    assert (vals[np.arange(4)[None, :] >= lens[:, None]] == 0).all()


def test_synth_list_file_reads_back_in_jax_and_pyarrow(tmp_path):
    """The synth LIST column (null and empty lists, required or optional
    elements, dictionary or PLAIN leaf, V1 or V2 pages cut at record
    boundaries) reads back as the generator's lists."""
    rng = np.random.default_rng(9)
    n = 900
    valid = rng.random(n) > 0.1
    lengths = np.where(valid, rng.integers(0, 7, n), 0)
    ev = rng.random(int(lengths.sum())) > 0.15
    for version in (1, 2):
        for dict_leaf in (True, False):
            for opt in (False, True):
                cells = int(ev.sum()) if opt else int(lengths.sum())
                leaf = (
                    dict(encoding=E.RLE_DICTIONARY, dictionary=np.arange(40, dtype=np.int32) * 5,
                         indices=rng.integers(0, 40, cells).astype(np.int32))
                    if dict_leaf else dict(values=rng.integers(-500, 500, cells).astype(np.int32))
                )
                spec = ColumnSpec("l", T.INT32, codec=C.SNAPPY, page_version=version, valid=valid,
                                  list_lengths=lengths, element_valid=ev if opt else None, **leaf)
                path = tmp_path / f"l{version}{dict_leaf}{opt}.parquet"
                write_file(path, [spec], row_group_rows=400, page_bytes=300)
                vals, k, e, want = list(column_values(spec)), 0, 0, []
                for r in range(n):
                    if not valid[r]:
                        want.append(None)
                        continue
                    row = []
                    for _ in range(lengths[r]):
                        if opt and not ev[e]:
                            row.append(None)
                        else:
                            row.append(int(vals[k]))
                            k += 1
                        e += 1
                    want.append(row)
                assert pq.read_table(path).column("l").to_pylist() == want
                with JReader(str(path)) as jr:
                    got = jr.to_arrow().column("l").to_pylist()
                assert got == want
                md = pq.ParquetFile(path).metadata
                assert md.num_row_groups == 3 and md.row_group(0).num_rows == 400


# -- refusals ------------------------------------------------------------------


def _raises_alike(path, eager: bool, **kw):
    """Both packages raise the same exception type (by name, a ValueError
    on both sides) at the call (eager) or at the first next()."""
    errs = []
    for reader in (JReader(str(path)), FileReader(path, device="cpu")):
        with reader as r:
            with pytest.raises(ValueError) as info:
                it = r.iter_device_batches(**kw)
                if eager:
                    raise AssertionError("expected the call itself to raise")
                list(it)
            errs.append(info.value)
    assert type(errs[0]).__name__ == type(errs[1]).__name__, errs
    return errs


def _refusal_file(tmp_path, kind):
    path = tmp_path / f"{kind}.parquet"
    if kind == "raw_bytes":
        pq.write_table(pa.table({"s": pa.array(["a", "bb", "ccc"] * 30)}), path, use_dictionary=False)
    elif kind == "merged_bytes":
        # the dictionary falls back to PLAIN pages: a mixed chunk merged on
        # the device into (data, offsets)
        words = [f"w{i:05d}" for i in range(3000)]
        pq.write_table(pa.table({"s": pa.array(words)}), path, dictionary_pagesize_limit=2048)
    elif kind == "nulls":
        pq.write_table(pa.table({"x": pa.array([1, None, 3] * 20, pa.int64())}), path)
    elif kind == "lists":
        pq.write_table(pa.table({"l": pa.array([[1, 2], [], None] * 20, pa.list_(pa.int32()))}), path)
    elif kind == "nested":
        pq.write_table(pa.table({"ll": pa.array([[[1, 2]], []] * 5, pa.list_(pa.list_(pa.int32())))}), path)
    elif kind == "null_elements":
        pq.write_table(pa.table({"l": pa.array([[1, None, 3], [4]] * 5, pa.list_(pa.int32()))}), path)
    elif kind == "oversize":
        pq.write_table(pa.table({"l": pa.array([[1] * 20, [2]], pa.list_(pa.int32()))}), path)
    elif kind == "two_d":
        t = pa.table({
            "f": pa.array([None if i % 5 == 0 else b"abcd" for i in range(40)], pa.binary(4)),
            "lf": pa.array([[b"wxyz"] * (i % 3) for i in range(40)], pa.list_(pa.binary(4))),
        })
        pq.write_table(t, path, row_group_size=16, use_dictionary=False)
    return path


REFUSALS = {
    "raw_byte_array": ("raw_bytes", False, dict(batch_size=10), "no device array form"),
    "merged_byte_array": ("merged_bytes", False, dict(batch_size=10), "no device array form"),
    "nulls_under_error": ("nulls", False, dict(batch_size=10), "contains nulls"),
    "repeated_under_error": ("lists", False, dict(batch_size=10), "is repeated"),
    "nested_eager": ("nested", True, dict(batch_size=1, lists="pad", max_list_len=4), "single-level"),
    "null_elements": ("null_elements", False, dict(batch_size=1, lists="pad", max_list_len=4),
                      "null elements"),
    "oversize_row": ("oversize", False,
                     dict(batch_size=1, lists="pad", max_list_len=8, drop_remainder=False),
                     "max_list_len"),
    "two_d_masked": ("two_d", False, dict(batch_size=8, columns=["f"], nullable="mask"), None),
    "two_d_padded": ("two_d", False,
                     dict(batch_size=8, columns=["lf"], lists="pad", max_list_len=4), None),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(tmp_path, case):
    kind, eager, kw, match = REFUSALS[case]
    errs = _raises_alike(_refusal_file(tmp_path, kind), eager, **kw)
    if match is not None:
        assert all(match in str(e) for e in errs), errs
    if case.startswith("two_d"):
        assert "no device batch layout" in str(errs[1])


BAD_ARGS = {
    "zero_batch": dict(batch_size=0),
    "nullable": dict(batch_size=4, nullable="bogus"),
    "lists": dict(batch_size=4, lists="bogus"),
    "no_max_list_len": dict(batch_size=4, lists="pad"),
    "zero_max_list_len": dict(batch_size=4, lists="pad", max_list_len=0),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_bad_arguments_raise_eagerly_on_both_sides(tmp_path, case):
    errs = _raises_alike(_refusal_file(tmp_path, "lists"), True, **BAD_ARGS[case])
    assert all(type(e) is ValueError for e in errs)


def test_batch_path_options_left_out():
    # nothing of the reference's iter_device_batches is left out any more:
    # filters= and filter_rows= came with the filtering slice, sharding=
    # with the multi-device slice (tests/test_torch_parallel.py holds it)
    import inspect

    params = inspect.signature(FileReader.iter_device_batches).parameters
    assert {"filters", "filter_rows", "sharding"} <= set(params)


def test_no_cuda_raises_at_the_call(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with FileReader(files["tiny"], device="cpu") as r:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            r.iter_device_batches(4, device="cuda")
