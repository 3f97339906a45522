"""The port's span tracing (parquet_tpu_torch/utils/trace.py) against the
reference's (parquet_tpu/utils/trace.py), the counterpart of
tests/test_trace.py.

Pinned on the CPU:

  * span trees: the same file read by the port's FileReader(device="cpu")
    and by the reference's FileReader(backend="tpu_roundtrip") on CPU jax
    (or both on the host) under decode_trace() gives the same tree. A node
    is (thread lane, span name, attributes, parent span name), the parent
    being the innermost span that holds it on its thread; times are left
    out. Trees compare as multisets, and the trace counters (bump counts
    and stage calls) as dicts. The read shapes: row groups decoded on the
    device path, on the host, with filters (query.mask), and as filtered
    device batches (query.take), and as rows (assemble, assembly.rows;
    assembly.filter under a filter), over SNAPPY, GZIP and uncompressed
    files;
  * zero overhead: a read with no trace active leaves span_allocations()
    where it was (device and host reads);
  * the collection machinery on the same calls: the exclusive rollup and
    report() (numbers masked), the event cap, the Chrome document's shape,
    traced_submit's context carry;
  * torch_profile (the port's jax_profile) writes a Chrome trace with
    the block's operators.

Tolerance: exact.
"""

from __future__ import annotations

import collections
import json
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
from parquet_tpu.core.reader import FileReader as JaxReader  # noqa: E402
from parquet_tpu.utils import trace as jtrace  # noqa: E402

from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.utils import trace as ptrace  # noqa: E402

ROWS = 20_000
ROW_GROUP = 8_000
FILTER = [("a", "<", 5_000)]


@pytest.fixture(scope="module", params=["snappy", "gzip", "none"])
def sample(request, tmp_path_factory):
    rng = np.random.default_rng(3)
    t = pa.table({
        "a": np.arange(ROWS, dtype=np.int64),
        "b": rng.standard_normal(ROWS),
        "s": pa.array([f"k{i % 37}" for i in range(ROWS)]),
        "o": pa.array([None if i % 5 == 0 else i for i in range(ROWS)], type=pa.int32()),
    })
    path = str(tmp_path_factory.mktemp("trace") / f"t-{request.param}.parquet")
    pq.write_table(t, path, row_group_size=ROW_GROUP, compression=request.param)
    return path


def span_tree(doc: dict) -> collections.Counter:
    """The document's spans as (lane, name, attributes, parent name): the
    lane is the thread's name without its worker number, the parent the
    innermost span on the same thread that holds the span."""
    lanes = {e["tid"]: re.sub(r"_\d+$", "", e["args"]["name"])
             for e in doc["traceEvents"] if e["ph"] == "M"}
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    nodes = []
    for i, e in enumerate(spans):
        parent = None
        for j, p in enumerate(spans):
            if j == i or p["tid"] != e["tid"]:
                continue
            holds = p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
            if holds and (p["dur"] > e["dur"] or (p["dur"] == e["dur"] and j < i)):
                if parent is None or p["dur"] < parent["dur"]:
                    parent = p
        nodes.append((lanes[e["tid"]], e["name"], json.dumps(e.get("args"), sort_keys=True),
                      parent["name"] if parent else None))
    return collections.Counter(nodes)


def read(reader, mode: str) -> None:
    if mode in ("rows", "rows_filtered"):
        for _row in reader.iter_rows(filters=FILTER if mode == "rows_filtered" else None):
            pass
        return
    if mode == "batches":
        for _b in reader.iter_device_batches(4096, columns=["a", "b"], filters=FILTER,
                                             filter_rows=True, drop_remainder=False):
            pass
        return
    if mode == "groups":
        reader.read_row_groups_device()
        return
    for i in range(reader.num_row_groups):
        if mode == "host":
            reader.read_row_group(i)
        elif mode == "filtered":
            reader.read_row_group_device(i, filters=FILTER)
        else:
            reader.read_row_group_device(i)


def traced(pkg: str, path: str, mode: str):
    if pkg == "port":
        with ptrace.decode_trace() as t, FileReader(path, device="cpu") as r:
            read(r, mode)
    else:
        backend = "host" if mode in ("host", "rows", "rows_filtered") else "tpu_roundtrip"
        with jtrace.decode_trace() as t, JaxReader(path, backend=backend) as r:
            read(r, mode)
    return t


@pytest.mark.parametrize("mode", ["device", "groups", "host", "filtered", "batches", "rows",
                                  "rows_filtered"])
def test_span_trees_equal_the_references(sample, mode):
    got, want = traced("port", sample, mode), traced("jax", sample, mode)
    assert span_tree(got.to_chrome_trace()) == span_tree(want.to_chrome_trace())
    assert got.counters() == want.counters()
    names = {n[1] for n in span_tree(got.to_chrome_trace())}
    expect = {"host": {"row_group", "chunk", "page"},
              "device": {"row_group.device", "chunk.prepare", "dispatch"},
              "groups": {"chunk.prepare", "dispatch"},
              "filtered": {"row_group.device", "query.mask"},
              "batches": {"chunk.prepare", "dispatch", "query.mask", "query.take"},
              "rows": {"row_group", "assemble", "assembly.rows"},
              "rows_filtered": {"row_group", "assembly.filter", "assemble"}}[mode]
    assert expect <= names


def pool_series(pkg: str, path: str) -> tuple[dict, dict]:
    """The registry's samples and pool_depths() entries of the device read's
    two pool hops (pqt-host, pqt-dispatch) after read_row_groups_device."""
    if pkg == "port":
        from parquet_tpu_torch.obs import pool
        from parquet_tpu_torch.utils import metrics
        with FileReader(path, device="cpu") as r:
            r.read_row_groups_device()
    else:
        from parquet_tpu.obs import pool
        from parquet_tpu.utils import metrics
        with JaxReader(path, backend="tpu_roundtrip") as r:
            r.read_row_groups_device()
    hops = ("pqt-host", "pqt-dispatch")
    # the sampling profiler's per-lane samples name the pools' threads too;
    # a profiler an earlier test of the process ran leaves them behind
    series = {k: v for k, v in metrics.snapshot().items()
              if any(h in k for h in hops) and not k.startswith("obs_profile_samples_total")}
    depths = {k: v for k, v in pool.pool_depths().items() if k in hops}
    return series, depths


def test_the_read_hops_feed_no_pool_series_like_the_references(sample, monkeypatch):
    # the reference hops with traced_submit: a context carry, no gauges or
    # histograms; 4 prepare threads so the pqt-host fan-out runs
    monkeypatch.setenv("PQT_HOST_THREADS", "4")
    assert pool_series("port", sample) == pool_series("jax", sample) == ({}, {})


@pytest.mark.parametrize("mode", ["device", "host"])
def test_an_untraced_read_allocates_no_span(sample, mode):
    before = ptrace.span_allocations()
    with FileReader(sample, device="cpu") as r:
        read(r, mode)
    assert ptrace.span_allocations() == before
    assert not ptrace.active() and ptrace.current() is None


def drive(mod):
    """The same stage / span / clock calls into one package's trace."""
    with mod.decode_trace() as t:
        with mod.span("file", {"path": "x"}):
            with mod.stage("outer", nbytes=100):
                mod.add_seconds("inner", 0.25, nbytes=10)
                mod.add_seconds_batch([("prepare.levels", 0.125), ("prepare.copy", 0.0625),
                                       ("prepare.crc", 0.0)])
            with mod.timed_stage("timed") as el:
                pass
            mod.add_bytes("decode.bytes", 4096)
            mod.bump("engaged", nbytes=7)
            mod.count("io_cache_hit", 3)
    return t, el


def test_rollup_report_and_counters_equal():
    (got, gel), (want, wel) = drive(ptrace), drive(jtrace)
    assert gel.seconds >= 0 and wel.seconds >= 0
    rg, rw = got.stage_rollup(), want.stage_rollup()
    assert set(rg) == set(rw)
    for name in ("inner", "prepare.levels", "prepare.copy", "decode.bytes", "engaged",
                 "io_cache_hit"):
        assert rg[name] == rw[name], name
    assert got.counters() == want.counters()
    mask = lambda s: re.sub(r"\d[\d,.]*", "0", s)  # noqa: E731
    assert mask(got.report(sort="name")) == mask(want.report(sort="name"))
    assert got.exclusive_seconds() <= sum(v["seconds"] for v in rg.values())
    with pytest.raises(ValueError, match="report sort"):
        got.report(sort="size")


def test_the_event_cap_drops_spans_and_keeps_aggregates(monkeypatch):
    monkeypatch.setattr(ptrace, "_MAX_EVENTS", 4)
    monkeypatch.setattr(jtrace, "_MAX_EVENTS", 4)
    out = []
    for mod in (ptrace, jtrace):
        with mod.decode_trace() as t:
            for _ in range(10):
                with mod.stage("s"):
                    pass
        out.append((t.events_dropped, t.counters(),
                    len([e for e in t.to_chrome_trace()["traceEvents"] if e["ph"] == "X"])))
    assert out[0] == out[1] == (7, {"s": 10}, 4)


def test_chrome_documents_have_the_references_shape():
    got = drive(ptrace)[0]
    want = drive(jtrace)[0]
    got.trace_id = want.trace_id = "ab" * 16
    a, b = got.to_chrome_trace(), want.to_chrome_trace()
    assert set(a) == set(b) and set(a["otherData"]) == set(b["otherData"])
    assert a["otherData"]["counters"] == b["otherData"]["counters"]
    assert a["otherData"]["propagation"] == b["otherData"]["propagation"]
    assert sorted(e["name"] for e in a["traceEvents"]) == sorted(e["name"] for e in b["traceEvents"])


def test_traced_submit_carries_the_trace_onto_a_pool():
    with ThreadPoolExecutor(2, thread_name_prefix="pqt-test") as pool:
        for mod in (ptrace, jtrace):
            with mod.decode_trace() as t:
                def work():
                    with mod.stage("on_pool"):
                        return mod.current()

                assert mod.traced_submit(pool, work).result(30) is t
                assert pool.submit(mod.current).result(30) is None
            assert t.counters() == {"on_pool": 1}


def test_torch_profile_writes_a_chrome_trace(tmp_path):
    import torch

    with ptrace.torch_profile(str(tmp_path / "prof")) as prof:
        torch.arange(1000).sum()
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert prof is not None and doc["traceEvents"]
    assert any("sum" in str(e.get("name", "")) for e in doc["traceEvents"])
