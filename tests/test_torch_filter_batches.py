"""Filtered device batches: iter_device_batches(filters=, filter_rows=True)
of the port against the JAX package.

The same files (the numeric corpus of tests/test_device_query.py, written by
the JAX package's FileWriter; pyarrow and synth files with nulls and LIST
columns from tests/test_torch_batches.py) stream through both packages'
iter_device_batches with a predicate pushed down: row groups pruned by
statistics, then every surviving group's rows compacted to the matching
ones (on the CPU the port's kernels run their plain versions). Batches are
flattened with testing.parity.batches_to_numpy and compared exactly:
count, paths, batch types, shapes, dtypes and bytes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from tests.test_device_query import BATCH_FILTERS, _numeric_corpus  # noqa: E402
from tests.test_torch_batches import MAX_LEN, _arrow_file, _assert_same_batches, _synth_file  # noqa: E402

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileReader  # noqa: E402


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("filter_batches")
    return {
        "corpus": _numeric_corpus(d),
        "arrow": str(_arrow_file(d / "arrow.parquet", 1750, 500)),
        "synth": str(_synth_file(d / "synth.parquet", 1300, 400)),
    }


def _both(path, **kw):
    with JReader(path) as jr, FileReader(path, device="cpu") as r:
        want = list(jr.iter_device_batches(**kw))
        parquet_tpu_torch.reset_filter_counts()
        got = list(r.iter_device_batches(**kw))
    return got, want


@pytest.mark.parametrize("filt", BATCH_FILTERS, ids=str)
def test_filtered_batches_match_jax(files, filt):
    got, want = _both(files["corpus"], batch_size=512, columns=["id", "v"],
                      drop_remainder=False, filters=filt, filter_rows=True)
    _assert_same_batches(got, want)
    c = parquet_tpu_torch.filter_counts()
    assert not c.get("device_filter_declined")


def test_filtered_masked_batches_match_jax(files):
    """nullable="mask": a MaskedColumn's values and mask compacted together,
    the filter on the nullable column itself and on one outside the
    projection."""
    for filt in ([("maybe", ">=", 700), ("v", "<", 0.5)],
                 [[("maybe", "is_null")], [("tag", ">", 3 << 30)]]):
        got, want = _both(files["corpus"], batch_size=300, columns=["id", "maybe"],
                          drop_remainder=False, nullable="mask", filters=filt,
                          filter_rows=True)
        assert got and isinstance(got[0][("maybe",)], parquet_tpu_torch.MaskedColumn)
        assert ("tag",) not in got[0] and ("v",) not in got[0]
        _assert_same_batches(got, want)


@pytest.mark.parametrize("path_key,filt", [
    ("arrow", [("tags", "contains", 5), ("id", "<", 1500)]),
    ("arrow", [[("tags", "contains", -3)], [("x", "is_null")]]),
    ("synth", [("items", "contains", 33)]),
    ("synth", [("items", "contains", 3), ("opt", "not_null"), ("ts", ">=", 100)]),
])
def test_filtered_ragged_batches_match_jax(files, path_key, filt):
    """lists="pad" + contains: the LIST leaf's contains mask, and a
    RaggedColumn's padded values and lengths compacted row by row."""
    kw = dict(batch_size=97, drop_remainder=False, lists="pad", max_list_len=MAX_LEN,
              nullable="mask", filters=filt, filter_rows=True)
    if path_key == "synth":
        kw["columns"] = ["items", "opt", "ts"]
    got, want = _both(files[path_key], **kw)
    assert got
    _assert_same_batches(got, want)
    c = parquet_tpu_torch.filter_counts()
    assert c.get("device_filter_engaged", 0) > 0 and not c.get("device_filter_declined")


def test_group_pruning_and_counters(files):
    """filters= alone prunes row groups by statistics and streams the
    surviving groups whole; with filter_rows=True the device engine engages
    once per admitted group."""
    p = files["corpus"]
    got, want = _both(p, batch_size=250, columns=["id"], filters=[("id", "<", 10)])
    _assert_same_batches(got, want)
    assert sum(b[("id",)].shape[0] for b in got) == 1500  # the whole first group
    assert parquet_tpu_torch.filter_counts() == {
        "groups_pruned_stats": 3, "groups_pruned_bloom": 0,
    }
    filt = [("id", ">=", 1400), ("id", "<", 3100)]
    got, want = _both(p, batch_size=128, columns=["id"], drop_remainder=False,
                      filters=filt, filter_rows=True)
    _assert_same_batches(got, want)
    with FileReader(p, device="cpu") as r:
        admitted = r.prune_row_groups(filt)
    assert admitted == [0, 1, 2]
    assert parquet_tpu_torch.filter_counts() == {
        "groups_pruned_stats": 1, "groups_pruned_bloom": 0,
        "device_filter_engaged": len(admitted),
    }
    ids = np.concatenate([b[("id",)].numpy() for b in got])
    np.testing.assert_array_equal(ids, np.arange(1400, 3100))


def test_filter_rows_requires_filters_and_validates_eagerly(files):
    with FileReader(files["corpus"], device="cpu") as r, JReader(files["corpus"]) as jr:
        for reader in (r, jr):
            with pytest.raises(ValueError, match="filter_rows"):
                reader.iter_device_batches(8, filter_rows=True)
        with pytest.raises(parquet_tpu_torch.FilterError):
            r.iter_device_batches(8, filters=[("nope", "==", 1)])
        with pytest.raises(parquet_tpu_torch.FilterError):
            r.iter_device_batches(8, filters=[("id", "~", 1)])


def test_filtered_synth_batches_match_jax(files):
    """A filter on a column outside the projection over the synth file
    (dictionary LIST, DELTA): the filter-only leaf is read, not batched."""
    got, want = _both(files["synth"], batch_size=64, columns=["ts"], drop_remainder=True,
                      filters=[("opt", "in", [1, 2, 3])], filter_rows=True)
    assert got and set(got[0]) == {("ts",)}
    _assert_same_batches(got, want)
