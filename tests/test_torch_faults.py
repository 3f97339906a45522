"""The port's fault harness, on_error, max_memory and compact_levels against
the JAX package's.

The same seeded fault cases (the port's testing.faults and the
reference's make the same cases from the same bytes) go through both
packages' readers, and each case's outcome must be the reference's: the
typed error's class and text, or the same decoded columns.

  * the harness: map_pages, iter_fault_cases and run_case agree, on the
    host rung and on the device round trip (device="cpu", the plain
    versions), for CRC'd V1/V2 files and a CRC-less one;
  * on_error "raise", "skip" and "null": every fault case and a poisoned
    file give the reference's groups, quarantine counts and rows, on the
    host read and on the device round trip; device delivery
    (read_row_group_device) raises under every policy;
  * max_memory: the reference's AllocError (text and all) or its columns
    on the host read, the same class on the device reads;
  * compact_levels: packed levels byte for byte the reference's, widened
    equal to the unpacked read.

The slow sweep is the counterpart of tests/test_faults.py's.
"""

from __future__ import annotations

import io
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.testing import faults as jfaults  # noqa: E402
from parquet_tpu.utils.trace import decode_trace  # noqa: E402

from parquet_tpu_torch.core.alloc import AllocError  # noqa: E402
from parquet_tpu_torch.core.reader import PARQUET_ERRORS, FileReader  # noqa: E402
from parquet_tpu_torch.io import io_counts, reset_io_counts  # noqa: E402
from parquet_tpu_torch.ops.packed_levels import PackedLevels  # noqa: E402
from parquet_tpu_torch.testing import faults as pfaults  # noqa: E402

WATCHDOG_SECONDS = 30.0
BACKENDS = {"host": ("host", "host"), "roundtrip": ("device_roundtrip", "tpu_roundtrip")}


def with_watchdog(fn, timeout: float = WATCHDOG_SECONDS):
    result: dict = {}

    def target():
        try:
            result["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            result["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"watchdog: case still running after {timeout}s (hang)")
    if "error" in result:
        raise result["error"]
    return result.get("value")


def _table(rows: int = 3000):
    rng = np.random.default_rng(42)
    mask = rng.random(rows) < 0.2
    return pa.table({
        "i": pa.array(rng.integers(0, 1 << 40, rows), pa.int64(), mask=mask),
        "s": pa.array([f"v{k % 37}" for k in range(rows)]),
        "f": pa.array(rng.random(rows).astype(np.float64)),
    })


def _bytes(version: str, compression: str = "snappy", crc: bool = True) -> bytes:
    buf = io.BytesIO()
    pq.write_table(_table(), buf, compression=compression, data_page_version=version,
                   write_page_checksum=crc, row_group_size=1500)
    return buf.getvalue()


def _digest(groups) -> list:
    out = []
    for g in groups:
        d = {}
        for path, cd in g.items():
            v = cd.values
            if hasattr(v, "offsets") and hasattr(v, "data"):
                vals = (np.asarray(v.offsets).tobytes(), bytes(v.data))
            else:
                vals = np.ascontiguousarray(np.asarray(v)).tobytes()
            lv = tuple(None if x is None else np.asarray(x).astype(np.uint16).tobytes()
                       for x in (cd.def_levels, cd.rep_levels))
            d[path] = (cd.num_values, vals, lv)
        out.append(d)
    return out


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is what is compared
        return (type(e).__name__, str(e))


def _read(cls, data, backend, **kw):
    if cls is FileReader:
        kw["device"] = "cpu"
    with cls(io.BytesIO(data), backend=backend, **kw) as r:
        return _digest([r.read_row_group(i) for i in range(r.num_row_groups)])


def _jax_quarantine(tr) -> dict:
    return {k: tr.stages[k].calls for k in
            ("chunks_quarantined", "chunks_nulled", "row_groups_quarantined") if k in tr.stages}


def _port_quarantine() -> dict:
    return {k: v for k, v in io_counts().items()
            if k in ("chunks_quarantined", "chunks_nulled", "row_groups_quarantined") and v}


# -- the harness ---------------------------------------------------------------


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_map_pages_and_cases_equal(version):
    data = _bytes(version)
    assert pfaults.map_pages(data) == [
        pfaults.PageSite(**s.__dict__) for s in jfaults.map_pages(data)
    ]
    got = [(c.name, c.data, c.must_fail, c.validate_crc, c.check_data)
           for c in pfaults.iter_fault_cases(data, seed=7)]
    want = [(c.name, c.data, c.must_fail, c.validate_crc, c.check_data)
            for c in jfaults.iter_fault_cases(data, seed=7)]
    assert got == want and len(got) >= 12


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_quick_fuzz_outcomes_equal(version, backend):
    pb, jb = BACKENDS[backend]
    data = _bytes(version)
    pristine = pfaults.read_all(data, True, pb, "cpu")
    jpristine = jfaults._read_all(data, True, jb)
    for case in pfaults.iter_fault_cases(data, seed=7):
        got = with_watchdog(lambda c=case: pfaults.run_case(c, pristine=pristine, backend=pb))
        want = jfaults.run_case(case, pristine=jpristine, backend=jb)
        assert got == want, case.name


def test_quick_fuzz_no_crc():
    data = _bytes("1.0", compression="none", crc=False)
    pristine = pfaults.read_all(data, False, "host", "cpu")
    jpristine = jfaults._read_all(data, False, "host")
    for case in pfaults.iter_fault_cases(data, seed=13, validate_crc=False):
        for pb, jb in BACKENDS.values():
            got = with_watchdog(lambda c=case, b=pb: pfaults.run_case(c, pristine=pristine,
                                                                      backend=b))
            assert got == jfaults.run_case(case, pristine=jpristine, backend=jb), case.name


def test_harness_flags_raw_exceptions(monkeypatch):
    """The port's harness catches a decoder leaking a raw exception."""
    data = _bytes("1.0")
    case = next(iter(pfaults.iter_fault_cases(data, seed=7)))
    import parquet_tpu_torch.testing.faults as mod

    def leak(*a, **k):
        raise IndexError("raw")

    monkeypatch.setattr(mod, "read_all", leak)
    with pytest.raises(pfaults.FaultViolation, match="raw IndexError"):
        pfaults.run_case(case)


# -- on_error ------------------------------------------------------------------


@pytest.mark.parametrize("on_error", ["raise", "skip", "null"])
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_fault_cases_under_on_error(version, backend, on_error):
    """Every fault case read under the policy: the reference's outcome
    (typed error text, or the delivered groups) and quarantine counts."""
    pb, jb = BACKENDS[backend]
    data = _bytes(version)
    for case in pfaults.iter_fault_cases(data, seed=7):
        kw = dict(validate_crc=case.validate_crc, on_error=on_error)
        reset_io_counts()
        got = with_watchdog(lambda c=case: _outcome(lambda: _read(FileReader, c.data, pb, **kw)))
        with decode_trace() as tr:
            want = _outcome(lambda c=case: _read(JReader, c.data, jb, **kw))
        assert got == want, case.name
        assert _port_quarantine() == _jax_quarantine(tr), case.name


def _poisoned(tmp_path) -> str:
    """3-group checksummed file with one bit-flipped chunk (column "a" of
    group 1), as the reference's test builds it."""
    from parquet_tpu_torch.core.chunk import chunk_byte_range

    rng = np.random.default_rng(5)
    rows = 6000
    mask = rng.random(rows) < 0.25
    t = pa.table({
        "a": pa.array(rng.integers(0, 1000, rows), pa.int64(), mask=mask),
        "b": pa.array([f"s{i % 50}" for i in range(rows)]),
        "c": pa.array(np.arange(rows, dtype=np.int32)),
    })
    p = str(tmp_path / "poisoned.parquet")
    pq.write_table(t, p, compression="snappy", row_group_size=2000, write_page_checksum=True,
                   use_dictionary=False, column_encoding={"a": "PLAIN", "b": "PLAIN"})
    data = bytearray(open(p, "rb").read())
    with FileReader(p, device="cpu") as r:
        off, total = chunk_byte_range(r.row_group(1).columns[0])
    data[off + total // 2] ^= 0xFF
    bad = str(tmp_path / "poisoned_bad.parquet")
    open(bad, "wb").write(bytes(data))
    return bad


def _norm_rows(rows):
    return [{k: (None if v is None else v) for k, v in r.items()} for r in rows]


@pytest.mark.parametrize("on_error", ["raise", "skip", "null"])
@pytest.mark.parametrize("columns", [None, ["a", "b"], ["b", "c"]])
def test_poisoned_file_rows_and_groups(tmp_path, on_error, columns):
    bad = _poisoned(tmp_path)
    kw = dict(validate_crc=True, on_error=on_error, columns=columns)
    reset_io_counts()
    with FileReader(bad, device="cpu", **kw) as r:
        got_rows = _outcome(lambda: _norm_rows(r.iter_rows()))
        got_groups = _outcome(lambda: _digest([r.read_row_group(i) for i in range(3)]))
    got_counts = _port_quarantine()
    with decode_trace() as tr:
        with JReader(bad, **kw) as r:
            want_rows = _outcome(lambda: _norm_rows(r.iter_rows()))
            want_groups = _outcome(lambda: _digest([r.read_row_group(i) for i in range(3)]))
    assert got_rows == want_rows
    assert got_groups == want_groups
    assert got_counts == _jax_quarantine(tr)
    if on_error == "skip" and columns != ["b", "c"]:
        assert len(got_rows[1]) == 4000 and got_groups[1][1] == {}
    if on_error == "null" and columns is None:
        assert len(got_rows[1]) == 6000
        assert all(row["a"] is None for row in got_rows[1][2000:4000])
        assert got_counts == {"chunks_quarantined": 2, "chunks_nulled": 2}


@pytest.mark.parametrize("on_error", ["raise", "skip", "null"])
def test_poisoned_filtered_rows(tmp_path, on_error):
    bad = _poisoned(tmp_path)
    filters = [("c", ">=", 1500), ("c", "<", 4500)]
    with FileReader(bad, device="cpu", validate_crc=True, on_error=on_error) as r:
        got = _outcome(lambda: _norm_rows(r.iter_rows(filters=filters)))
    with JReader(bad, validate_crc=True, on_error=on_error) as r:
        want = _outcome(lambda: _norm_rows(r.iter_rows(filters=filters)))
    assert got == want


def _lying(tmp_path, lie: str) -> str:
    """A 2-group file whose footer lies about column "i" of group 1: its
    data_page_offset is 0 ("offset0") or its total_compressed_size is
    negative ("negsize"). The page bytes are intact."""
    from parquet_tpu_torch.meta.file_meta import serialize_footer

    p = str(tmp_path / "clean.parquet")
    pq.write_table(_table(), p, compression="snappy", row_group_size=1500,
                   use_dictionary=False)
    meta = FileReader.open_metadata(p)
    md = meta.row_groups[1].columns[0].meta_data
    assert md.path_in_schema == ["i"] and md.dictionary_page_offset is None
    if lie == "offset0":
        md.data_page_offset = 0
    else:
        md.total_compressed_size = -1
    data = open(p, "rb").read()
    body = data[: len(data) - 8 - int.from_bytes(data[-8:-4], "little")]
    bad = str(tmp_path / f"lying_{lie}.parquet")
    open(bad, "wb").write(body + serialize_footer(meta))
    return bad


@pytest.mark.parametrize("on_error", ["raise", "skip", "null"])
@pytest.mark.parametrize("lie", ["offset0", "negsize"])
def test_lying_footer_range_under_on_error(tmp_path, lie, on_error):
    """A footer whose chunk range is unusable is a corrupt chunk: "raise"
    gives the reference's ChunkError, "skip" / "null" quarantine it on the
    host read, the device round trip, the row path and the dataset, as the
    reference does; device delivery raises under every policy."""
    from parquet_tpu.data import ParquetDataset as JDataset
    from parquet_tpu_torch.data import ParquetDataset, dataset_counts, reset_dataset_counts

    bad = _lying(tmp_path, lie)
    data = open(bad, "rb").read()
    for pb, jb in BACKENDS.values():
        reset_io_counts()
        got = _outcome(lambda: _read(FileReader, data, pb, on_error=on_error))
        got_counts = _port_quarantine()
        with decode_trace() as tr:
            want = _outcome(lambda: _read(JReader, data, jb, on_error=on_error))
        assert got == want, pb
        assert got_counts == _jax_quarantine(tr), pb
        if on_error == "raise":
            assert got[0] == "ChunkError"
        else:
            assert got[0] == "ok" and got_counts["chunks_quarantined"] == 1
    with FileReader(bad, device="cpu", on_error=on_error) as r:
        got_rows = _outcome(lambda: _norm_rows(r.iter_rows()))
        got_filtered = _outcome(lambda: _norm_rows(r.iter_rows(filters=[("f", "<", 0.5)])))
        with pytest.raises(PARQUET_ERRORS):
            r.read_row_group_device(1)
    with JReader(bad, on_error=on_error) as r:
        want_rows = _outcome(lambda: _norm_rows(r.iter_rows()))
        want_filtered = _outcome(lambda: _norm_rows(r.iter_rows(filters=[("f", "<", 0.5)])))
    assert got_rows == want_rows and got_filtered == want_filtered
    if on_error == "skip":
        assert len(got_rows[1]) == 1500
    if on_error == "null":
        assert len(got_rows[1]) == 3000 and all(x["i"] is None for x in got_rows[1][1500:])
    kw = dict(batch_size=500, columns=["i", "f"], nullable="zero", remainder="keep",
              on_error=on_error)
    reset_dataset_counts()
    got_ds = _outcome(lambda: [{k: v.numpy().tobytes() for k, v in b.items()}
                               for b in ParquetDataset(bad, device="cpu", **kw)])
    want_ds = _outcome(lambda: [{k: np.asarray(v).tobytes() for k, v in b.items()}
                                for b in JDataset(bad, **kw)])
    assert got_ds == want_ds
    if on_error == "skip":
        assert len(got_ds[1]) == 3 and dataset_counts()["units_skipped"] == 1


@pytest.mark.parametrize("on_error", ["raise", "skip", "null"])
def test_device_delivery_always_raises(tmp_path, on_error):
    bad = _poisoned(tmp_path)
    with FileReader(bad, device="cpu", validate_crc=True, on_error=on_error) as r:
        with pytest.raises(PARQUET_ERRORS) as ei:
            r.read_row_group_device(1)
        with pytest.raises(PARQUET_ERRORS):
            r.read_row_groups_device()
        with pytest.raises(PARQUET_ERRORS):
            list(r.iter_device_batches(1000, nullable="mask"))
        assert r.read_row_group_device(0, columns=["a"])[("a",)].num_values == 2000
    # the reference's device decode of the group raises the same typed error
    from parquet_tpu.core.reader import PARQUET_ERRORS as JERRORS

    with JReader(bad, validate_crc=True, on_error=on_error, backend="tpu_roundtrip") as r:
        with pytest.raises(JERRORS) as ej:
            r._plan_row_group(1, None)
    assert (type(ei.value).__name__, str(ei.value)) == (type(ej.value).__name__, str(ej.value))


def test_on_error_rejects_unknown_mode(tmp_path):
    bad = _poisoned(tmp_path)
    with pytest.raises(ValueError, match="on_error") as ei:
        FileReader(bad, device="cpu", on_error="ignore")
    with pytest.raises(ValueError, match="on_error") as ej:
        JReader(bad, on_error="ignore")
    assert str(ei.value) == str(ej.value)


# -- max_memory ----------------------------------------------------------------


@pytest.mark.parametrize("limit", [1, 4096, 40_000, 120_000, 1 << 30])
@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_max_memory_host(version, limit):
    data = _bytes(version)
    got = _outcome(lambda: _read(FileReader, data, "host", max_memory=limit))
    want = _outcome(lambda: _read(JReader, data, "host", max_memory=limit))
    assert got == want
    if limit == 1:
        assert got[0] == "AllocError"
    if limit == 1 << 30:
        assert got[0] == "ok"


@pytest.mark.parametrize("limit", [1, 40_000, 1 << 30])
def test_max_memory_device(limit):
    data = _bytes("1.0")
    with FileReader(io.BytesIO(data), device="cpu", max_memory=limit) as r:
        got = _outcome(lambda: [sorted(g) for g in r.read_row_groups_device()])
        got1 = _outcome(lambda: sorted(r.read_row_group_device(1)))
    want = _outcome(lambda: _read(JReader, data, "tpu_roundtrip", max_memory=limit))
    assert got[0] == got1[0] == want[0]
    if limit == 1:
        assert got[0] == "AllocError" and issubclass(AllocError, MemoryError)


def test_max_memory_rows_and_range_decode(tmp_path):
    p = str(tmp_path / "pi.parquet")
    pq.write_table(_table(6000), p, row_group_size=3000, write_page_index=True,
                   data_page_size=2048)
    filters = [("f", "<", 0.05)]
    for limit in (2000, 60_000, 1 << 30):
        with FileReader(p, device="cpu", max_memory=limit) as r:
            got = _outcome(lambda: _norm_rows(r.iter_rows(filters=filters)))
        with JReader(p, max_memory=limit) as r:
            want = _outcome(lambda: _norm_rows(r.iter_rows(filters=filters)))
        assert got == want


# -- compact_levels ------------------------------------------------------------


def _nested(tmp_path) -> str:
    rng = np.random.default_rng(8)
    n = 2500
    lists = [None if rng.random() < 0.1 else
             [None if rng.random() < 0.2 else int(x) for x in rng.integers(0, 99, rng.integers(0, 5))]
             for _ in range(n)]
    t = pa.table({
        "l": pa.array(lists, pa.list_(pa.int32())),
        "o": pa.array(rng.integers(0, 9, n), pa.int64(), mask=rng.random(n) < 0.3),
        "r": pa.array(np.arange(n, dtype=np.int64)),
    })
    p = str(tmp_path / "nested.parquet")
    pq.write_table(t, p, row_group_size=1000)
    return p


def test_compact_levels_host(tmp_path):
    p = _nested(tmp_path)
    with FileReader(p, device="cpu", compact_levels=True) as r:
        got = [r.read_row_group(i) for i in range(r.num_row_groups)]
        rows = list(r.iter_rows())
    with FileReader(p, device="cpu") as r:
        plain = [r.read_row_group(i) for i in range(r.num_row_groups)]
    with JReader(p, compact_levels=True) as r:
        want = [r.read_row_group(i) for i in range(r.num_row_groups)]
        jrows = list(r.iter_rows())
    assert rows == jrows
    for g, pg, w in zip(got, plain, want):
        for path, cd in g.items():
            for name in ("def_levels", "rep_levels"):
                lv, plv, wlv = getattr(cd, name), getattr(pg[path], name), getattr(w[path], name)
                if plv is None:
                    assert lv is None and wlv is None
                    continue
                assert isinstance(lv, PackedLevels)
                assert lv.packed.tobytes() == wlv.packed.tobytes() and lv.width == wlv.width
                assert np.array_equal(lv.widen(), plv)
                assert np.array_equal(lv[3:17], plv[3:17])
    assert _digest(got) == _digest(plain)


def test_compact_levels_device(tmp_path):
    p = _nested(tmp_path)
    with FileReader(p, device="cpu", compact_levels=True) as r:
        dev = r.read_row_groups_device()
        one = r.read_row_group_device(2, columns=["o"])
    with FileReader(p, device="cpu") as r:
        plain = r.read_row_groups_device()
    for g, pg in zip(dev, plain):
        for path, dc in g.items():
            if pg[path].def_levels is not None:
                assert isinstance(dc.def_levels, PackedLevels)
                assert np.array_equal(np.asarray(dc.def_levels), np.asarray(pg[path].def_levels))
            assert torch.equal(dc.values, pg[path].values)
    assert isinstance(one[("o",)].def_levels, PackedLevels)


# -- slow: the reference's extended sweep ----------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("compression,crc", [("snappy", True), ("gzip", True), ("none", False)])
def test_extended_sweep(version, compression, crc):
    data = _bytes(version, compression=compression, crc=crc)
    pristine = {b: pfaults.read_all(data, crc, b, "cpu") for b, _ in BACKENDS.values()}
    jpristine = {jb: jfaults._read_all(data, crc, jb) for _, jb in BACKENDS.values()}
    for seed in (3, 11, 99, 1234, 31337):
        for case in pfaults.iter_fault_cases(data, seed=seed, truncations=8, bit_flips=8,
                                             header_flips=6, validate_crc=crc):
            for pb, jb in BACKENDS.values():
                got = with_watchdog(
                    lambda c=case, b=pb: pfaults.run_case(c, pristine=pristine[b], backend=b))
                assert got == jfaults.run_case(case, pristine=jpristine[jb], backend=jb)
