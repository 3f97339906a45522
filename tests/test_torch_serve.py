"""The port's serve layer against the JAX package's, on the CPU, no sockets.

  * protocol: parse_scan_request and scan_request_from_query give equal
    requests for the same input, and over the reference's rejection table
    (tests/test_serve.py's TestProtocol) raise equal (status, code,
    message);
  * admission: the same scripts driven through both AdmissionControllers
    on one fake clock (queue full and release, per-tenant concurrency, the
    token bucket, deadlines, the bounded tenant table, drain, brownout fed
    with equal queue-wait numbers) give the same verdict sequences; the
    port counts each rejection as admission_rejected_total{code=};
  * session: equal PlannedScan.summary() for plans of the same requests
    (globs, projections, filters that prune by statistics and by bloom
    filters, shards, estimated bytes), equal typed 403 / 404 / 400 / 422
    for escapes, missing files, bad columns and a corrupt footer, and
    remote_map over each package's RangeHttpStub;
  * SLO: BurnRateEngine.evaluate() of both packages equal after the same
    status and latency schedule on a fake clock;
  * the CUDA rule: a ScanService with no CUDA and no device= raises at
    construction.

Tolerance: exact everywhere (verdicts, summaries and bodies compare equal).
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
from parquet_tpu.core.writer import FileWriter as JaxWriter  # noqa: E402
from parquet_tpu.obs import slo as jslo  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema as jax_parse_schema  # noqa: E402
from parquet_tpu.serve import admission as jadm  # noqa: E402
from parquet_tpu.serve import protocol as jproto  # noqa: E402
from parquet_tpu.serve import session as jsess  # noqa: E402

from parquet_tpu_torch.obs import slo as pslo  # noqa: E402
from parquet_tpu_torch.serve import admission as padm  # noqa: E402
from parquet_tpu_torch.serve import counts as pcounts  # noqa: E402
from parquet_tpu_torch.serve import protocol as pproto  # noqa: E402
from parquet_tpu_torch.serve import session as psess  # noqa: E402

ROWS_A, ROWS_B = 2400, 1800
ROW_GROUP = 800


# -- the corpus ------------------------------------------------------------------


def write_corpus(d):
    """Two files of several row groups, ids globally sorted so statistics
    prune whole groups, and a bloom-filtered file whose probe keys sit
    inside every group's min/max (only the bloom filter can prune them)."""
    rng = np.random.default_rng(7)
    for name, (base, n) in {"a.parquet": (0, ROWS_A), "b.parquet": (ROWS_A, ROWS_B)}.items():
        t = pa.table({
            "id": pa.array(np.arange(base, base + n, dtype=np.int64)),
            "k": pa.array(rng.integers(0, 9, n).astype(np.int32)),
            "v": pa.array(rng.standard_normal(n)),
            "name": pa.array([f"n{i % 13}" for i in range(n)]),
            "opt": pa.array(rng.integers(-50, 50, n), mask=rng.random(n) < 0.2),
        })
        pq.write_table(t, str(d / name), row_group_size=ROW_GROUP)
    schema = jax_parse_schema("message m { required binary s (UTF8); }")
    (d / "bloom").mkdir()
    with JaxWriter(str(d / "bloom" / "bloomed.parquet"), schema, bloom_filters=["s"]) as w:
        for part in ([f"k{i}" for i in range(500)], [f"k{i}" for i in range(500, 1000)]):
            w.write_column("s", part)
            w.flush_row_group()
    return d


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("serve_corpus"))


def typed(fn):
    """fn()'s result, or its ServeError as (status, code, message, retry)."""
    try:
        return ("ok", fn())
    except (jproto.ServeError, pproto.ServeError) as e:
        return ("err", e.status, e.code, e.message, e.retry_after_s)


# -- protocol --------------------------------------------------------------------

SCAN_BODIES = [
    {"paths": "a.parquet"},
    {"paths": ["a.parquet", "b.parquet"], "columns": "id,v", "limit": 0},
    {"paths": "a.parquet", "columns": "id,v", "filters": [["id", "<", 10]], "limit": 5,
     "format": "arrow-ipc", "shard": "1/2", "timeout_ms": 1000},
    {"paths": "*.parquet", "columns": [], "filters": [[["id", "<", 3]], [["id", ">=", 9]]],
     "shard": [0, 3]},
    {"paths": "a.parquet", "filters": [], "shard": "2,4"},
    {"paths": "a.parquet", "filters": [["name", "in", ["n1", "n2"]], ["opt", "is_null"]]},
]

REJECTED_BODIES = [
    b"",
    b"not json",
    b"[1,2]",
    b'{"paths": []}',
    b'{"paths": "a", "nope": 1}',
    b'{"paths": "a", "limit": -1}',
    b'{"paths": "a", "limit": true}',
    b'{"paths": "a", "format": "csv"}',
    b'{"paths": "a", "shard": [2, 2]}',
    b'{"paths": "a", "shard": "x"}',
    b'{"paths": "a", "timeout_ms": 0}',
    b'{"paths": "a", "columns": [1]}',
    b'{"paths": [""]}',
    b'{"paths": "a", "filters": [["id", "~", 1]]}',
    b'{"paths": "a", "filters": "id < 3"}',
    b'{"paths": "a", "filters": [["id"]]}',
    b'{"paths": "a", "filters": [[3, "<", 3]]}',
]

QUERY_STRINGS = [
    {"paths": ["a.parquet,b.parquet"], "columns": ["id"], "filters": ['[["id", ">=", 7]]'],
     "limit": ["3"], "shard": ["0/2"]},
    {"paths": ["a.parquet", "b.parquet"], "columns": ["id", "v"], "timeout_ms": ["50"],
     "format": ["arrow-ipc"]},
    {"paths": ["*.parquet"], "filters": ['[[["id", "<", 3]], [["id", ">", 9]]]']},
    {},
    {"columns": ["id"]},
    {"paths": ["a.parquet"], "filters": ["not json"]},
    {"paths": ["a.parquet"], "limit": ["x"]},
    {"paths": ["a.parquet"], "timeout_ms": ["1.5"]},
    {"paths": ["a.parquet"], "shard": ["3/2"]},
    {"paths": ["a.parquet"], "format": ["csv"]},
]


@pytest.mark.parametrize("body", SCAN_BODIES, ids=range(len(SCAN_BODIES)))
def test_parse_scan_request_matches_the_reference(body):
    raw = json.dumps(body).encode()
    got, want = typed(lambda: pproto.parse_scan_request(raw)), typed(
        lambda: jproto.parse_scan_request(raw))
    assert got[0] == want[0] == "ok"
    assert type(got[1]).__name__ == "ScanRequest"
    assert tuple(got[1]) == tuple(want[1])
    assert got[1]._fields == want[1]._fields


@pytest.mark.parametrize("raw", REJECTED_BODIES, ids=range(len(REJECTED_BODIES)))
def test_scan_rejections_match_the_reference(raw):
    got = typed(lambda: pproto.parse_scan_request(raw))
    want = typed(lambda: jproto.parse_scan_request(raw))
    assert got[0] == "err" and got == want


@pytest.mark.parametrize("qs", QUERY_STRINGS, ids=range(len(QUERY_STRINGS)))
def test_scan_request_from_query_matches_the_reference(qs):
    got = typed(lambda: pproto.scan_request_from_query(qs))
    want = typed(lambda: jproto.scan_request_from_query(qs))
    if want[0] == "ok":
        assert got[0] == "ok" and tuple(got[1]) == tuple(want[1])
    else:
        assert got == want


def test_the_protocol_exports_match():
    assert pproto.FORMATS == jproto.FORMATS
    assert set(jproto.__all__) <= set(pproto.__all__)


# -- admission -------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakePool:
    """Equal queue-wait numbers for both controllers: the reference reads
    them through a registry (hist_stats / get), the port through
    pool_stats()."""

    def __init__(self):
        self.depth = 0
        self.count = 0
        self.sum = 0.0

    def hist_stats(self, name, **labels):
        assert name == "pool_queue_wait_seconds" and labels == {"pool": "pqt-serve"}
        return {"count": self.count, "sum": self.sum}

    def get(self, name, **labels):
        assert name == "pool_queue_depth" and labels == {"pool": "pqt-serve"}
        return self.depth

    def stats(self):
        return {"queued": self.depth, "wait_count": self.count, "wait_sum": self.sum}


def run_script(mod, script, clock, pool, **kw):
    """Drive one package's AdmissionController through `script`; each step
    gives a comparable verdict."""
    extra = (
        {"registry": pool} if mod is jadm else {"pool_stats": pool.stats}
    ) if pool is not None else {}
    a = mod.AdmissionController(clock=clock, **kw, **extra)
    tickets = []
    out = []
    for step in script:
        op, args = step[0], step[1:]
        if op == "admit":
            r = typed(lambda: a.admit(args[0]))
            if r[0] == "ok":
                tickets.append(r[1])
                r = ("ok", r[1].tenant)
        elif op == "release":
            tickets[args[0]].release()
            r = ("in_flight", a.in_flight)
        elif op == "charge":
            r = typed(lambda: a.charge(*args))
        elif op == "tick":
            clock.t += args[0]
            r = None
        elif op == "resolve":
            r = a.resolve_tenant(args[0])
        elif op == "deadline":
            d = typed(lambda: a.deadline_for(args[0]))
            r = d if d[0] == "err" else ("ok", d[1].remaining(), d[1].expired())
        elif op == "drain":
            a.begin_drain()
            r = ("draining", a.draining)
        elif op == "wait_drained":
            r = a.wait_drained(timeout=args[0])
        elif op == "tenants":
            r = sorted(a._tenants)
        elif op == "wait":  # the pool's queue: (count, sum, depth) deltas
            pool.count += args[0]
            pool.sum += args[1]
            pool.depth = args[2]
            r = None
        else:
            raise AssertionError(op)
        out.append(r)
    return out


SCRIPTS = {
    "queue_full_and_release": (
        dict(max_inflight=2),
        [("admit", "x"), ("admit", "y"), ("admit", "z"), ("release", 0), ("release", 0),
         ("admit", "z"), ("release", 2), ("release", 1)],
    ),
    "tenant_concurrency": (
        dict(max_inflight=10, tenant_concurrent=1),
        [("admit", "alice"), ("admit", "alice"), ("admit", "bob"), ("release", 1),
         ("release", 0), ("admit", "alice"), ("release", 2)],
    ),
    "token_bucket": (
        dict(tenant_budget_bytes=1000, budget_window_s=10.0),
        [("charge", "t", 600), ("charge", "t", 600), ("tick", 2.0), ("charge", "t", 600),
         ("tick", 100.0), ("charge", "t", 5000), ("charge", "t", 1), ("tick", 0.5),
         ("charge", "t", 40), ("charge", "u", 999), ("charge", "u", 2)],
    ),
    "deadlines": (
        dict(default_timeout_s=5.0, max_timeout_s=60.0),
        [("deadline", None), ("deadline", "1500"), ("deadline", 120_000), ("deadline", "x"),
         ("deadline", 0), ("deadline", -3)],
    ),
    "bounded_tenant_table": (
        dict(max_tenants=2, tenant_concurrent=4),
        [("resolve", "x"), ("resolve", "y"), ("resolve", "z"), ("resolve", "x"),
         ("resolve", None), ("admit", "x"), ("admit", "y"), ("admit", "z"), ("release", 0),
         ("release", 2), ("admit", "v"), ("tenants",), ("release", 1), ("release", 3)],
    ),
    "tenant_names": (
        dict(max_tenants=8),
        [("resolve", None), ("resolve", "  "), ("resolve", "q" * 200), ("resolve", " a b ")],
    ),
    "drain": (
        dict(),
        [("admit", "x"), ("drain",), ("admit", "y"), ("wait_drained", 0.01), ("release", 0),
         ("wait_drained", 5.0)],
    ),
    "brownout_wait": (
        dict(brownout_wait_s=0.05, brownout_window_s=2.0),
        [("admit", "a"), ("wait", 4, 1.0, 0), ("admit", "b"), ("tick", 2.0), ("admit", "c"),
         ("wait", 10, 0.1, 0), ("tick", 1.0), ("admit", "d"), ("tick", 1.0), ("admit", "e"),
         ("tick", 2.5), ("admit", "f")],
    ),
    "brownout_depth": (
        dict(brownout_depth=3, brownout_window_s=1.0),
        [("admit", "a"), ("wait", 0, 0.0, 5), ("admit", "b"), ("wait", 0, 0.0, 3),
         ("admit", "c"), ("tick", 1.0), ("wait", 0, 0.0, 4), ("admit", "d")],
    ),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_admission_scripts_match_the_reference(name):
    kw, script = SCRIPTS[name]
    uses_pool = name.startswith("brownout")
    got = run_script(padm, script, FakeClock(), FakePool() if uses_pool else None, **kw)
    want = run_script(jadm, script, FakeClock(), FakePool() if uses_pool else None, **kw)
    assert got == want
    assert any(r is not None and r[0] == "err" for r in got if isinstance(r, tuple)) or name in (
        "tenant_names", "bounded_tenant_table")


def test_admission_rejections_are_counted_by_code():
    pcounts.reset_serve_counts()
    a = padm.AdmissionController(max_inflight=1, tenant_budget_bytes=10, clock=FakeClock())
    t = a.admit("x")
    for _ in range(2):
        with pytest.raises(pproto.ServeError):
            a.admit("y")
    a.charge("x", 10)
    with pytest.raises(pproto.ServeError):
        a.charge("x", 5)
    t.release()
    a.begin_drain()
    with pytest.raises(pproto.ServeError):
        a.admit("z")
    assert pcounts.serve_counts() == {
        'admission_rejected_total{code="queue_full"}': 2,
        'admission_rejected_total{code="tenant_over_budget"}': 1,
        'admission_rejected_total{code="draining"}': 1,
    }


def test_brownout_sheds_are_counted():
    pcounts.reset_serve_counts()
    pool = FakePool()
    clock = FakeClock()
    a = padm.AdmissionController(brownout_depth=1, clock=clock, pool_stats=pool.stats)
    a.admit("a").release()
    pool.depth = 2
    with pytest.raises(pproto.ServeError) as ei:
        a.admit("b")
    assert (ei.value.status, ei.value.code, ei.value.retry_after_s) == (503, "brownout", 2)
    assert pcounts.serve_counts()['serve_shed_total{reason="queue_wait"}'] == 1


def test_serve_pool_stats_track_submits():
    from concurrent.futures import ThreadPoolExecutor

    gate = threading.Event()
    with ThreadPoolExecutor(1) as ex:
        before = pcounts.serve_pool_stats()
        first = pcounts.submit(ex, gate.wait, 30.0)
        second = pcounts.submit(ex, lambda: 7)
        third = pcounts.submit(ex, lambda: 8)
        assert third.cancel()
        assert pcounts.serve_pool_stats()["queued"] >= 1
        gate.set()
        assert first.result(30.0) is True and second.result(30.0) == 7
    after = pcounts.serve_pool_stats()
    assert (after["queued"], after["active"]) == (before["queued"], before["active"]) == (0, 0)
    assert after["wait_count"] - before["wait_count"] == 2


@pytest.mark.parametrize("labels", [
    {},
    {"reason": "queue_wait"},
    {"tenant": 'a"b\\c', "status": "200"},
    {"endpoint": "line\nbreak", "a": 1},
])
def test_count_keys_are_the_reference_registry_keys(labels):
    from parquet_tpu.utils.metrics import _key as jax_key

    from parquet_tpu_torch.utils.counters import LabelledCounts, key

    assert key("events_total", labels) == jax_key("events_total", labels)
    store = LabelledCounts()
    store.count("events_total", 2, **labels)
    store.count("events_total", **labels)
    assert store.snapshot() == {jax_key("events_total", labels): 3}
    store.reset()
    assert store.snapshot() == {}


def test_metrics_help_names_what_the_port_counts():
    from parquet_tpu_torch.serve.server import render_metrics

    key = 'parquet_tpu_events_total{event="serve_stream_aborted"}'

    def sample(lines):
        # the registry is the process's: the event is read as its growth
        hits = [ln.rsplit(" ", 1)[1] for ln in lines if ln.startswith(key + " ")]
        return int(hits[0]) if hits else 0

    pcounts.reset_serve_counts()
    try:
        before = render_metrics().splitlines()
        pcounts.count("events_total", event="serve_stream_aborted")
        lines = render_metrics().splitlines()
    finally:
        pcounts.reset_serve_counts()
    # the registry's HELP text, the reference's: the port's trace.bump()
    # reports into events_total as the reference's does
    assert "# HELP parquet_tpu_events_total every trace.bump() event, always-on" in lines
    assert sample(lines) - sample(before) == 1


# -- session ---------------------------------------------------------------------

PLAN_REQUESTS = [
    {"paths": "a.parquet"},
    {"paths": "*.parquet"},
    {"paths": ["b.parquet", "a.parquet", "a.parquet"]},
    {"paths": "*.parquet", "columns": ["id", "name"]},
    {"paths": "*.parquet", "columns": ["opt"], "filters": [["id", "<", ROW_GROUP]]},
    {"paths": "*.parquet", "filters": [[["id", "<", 100]], [["id", ">=", ROWS_A + 1700]]]},
    {"paths": "*.parquet", "filters": [["id", ">", 10**9]]},
    {"paths": "*.parquet", "shard": [1, 3]},
    {"paths": "*.parquet", "columns": ["k"], "shard": [0, 2]},
    {"paths": "bloom/bloomed.parquet", "filters": [["s", "==", "k499x"]]},
    {"paths": "bloom/bloomed.parquet", "filters": [["s", "==", "k17"]]},
    {"paths": "bloom/*.parquet", "columns": ["s"]},
]


def both_sessions(root, **kw):
    return psess.ScanSession(root=str(root), **kw), jsess.ScanSession(root=str(root), **kw)


@pytest.mark.parametrize("body", PLAN_REQUESTS, ids=range(len(PLAN_REQUESTS)))
def test_plan_summaries_match_the_reference(corpus, body):
    ps, js = both_sessions(corpus)
    raw = json.dumps(body).encode()
    got = ps.plan(pproto.parse_scan_request(raw))
    want = js.plan(jproto.parse_scan_request(raw))
    assert got.summary() == want.summary()
    assert [tuple(u) for u in got.units] == [tuple(u) for u in want.units]
    assert got.shard == want.shard


def test_bloom_and_statistics_both_prune(corpus):
    ps, _ = both_sessions(corpus)
    s = ps.plan(pproto.parse_scan_request(json.dumps(PLAN_REQUESTS[9]).encode())).summary()
    assert s["units"] == 0 and s["units_pruned_bloom"] >= 1
    s = ps.plan(pproto.parse_scan_request(json.dumps(PLAN_REQUESTS[4]).encode())).summary()
    assert s["units_pruned_stats"] == 5 and s["estimated_bytes"] > 0


def test_daemon_shard_stripes_units(corpus):
    ps, js = both_sessions(corpus, shard=(1, 2))
    raw = b'{"paths": "*.parquet"}'
    assert ps.plan(pproto.parse_scan_request(raw)).summary() == js.plan(
        jproto.parse_scan_request(raw)).summary()


@pytest.fixture(scope="module")
def broken(tmp_path_factory, corpus):
    """A root with a file whose footer is cut and one that is not Parquet."""
    d = tmp_path_factory.mktemp("serve_broken")
    raw = (corpus / "a.parquet").read_bytes()
    (d / "cut.parquet").write_bytes(raw[:-9] + b"PAR1")
    (d / "text.parquet").write_bytes(b"hello, not parquet at all")
    (d / "a.parquet").write_bytes(raw)
    return d


SESSION_ERRORS = [
    ("corpus", {"paths": "../etc/passwd"}),
    ("corpus", {"paths": "/etc/passwd"}),
    ("corpus", {"paths": "bloom/../../x.parquet"}),
    ("corpus", {"paths": "missing.parquet"}),
    ("corpus", {"paths": "nothing-*.parquet"}),
    ("corpus", {"paths": "a.parquet", "columns": ["nope"]}),
    ("corpus", {"paths": "a.parquet", "filters": [["nope", "<", 1]]}),
    ("corpus", {"paths": "a.parquet", "filters": [["id", "<", "x"]]}),
    ("broken", {"paths": "cut.parquet"}),
    ("broken", {"paths": "text.parquet"}),
]


@pytest.mark.parametrize("where,body", SESSION_ERRORS, ids=range(len(SESSION_ERRORS)))
def test_session_errors_match_the_reference(corpus, broken, where, body):
    root = corpus if where == "corpus" else broken
    ps, js = both_sessions(root)
    raw = json.dumps(body).encode()
    got = typed(lambda: ps.plan(pproto.parse_scan_request(raw)))
    want = typed(lambda: js.plan(jproto.parse_scan_request(raw)))
    assert want[0] == "err" and got[:3] == want[:3]
    if want[1] in (403, 404):
        assert got == want


def test_symlink_escape_is_403(corpus, tmp_path):
    outside = tmp_path / "outside.parquet"
    outside.write_bytes((corpus / "a.parquet").read_bytes())
    root = tmp_path / "root"
    root.mkdir()
    (root / "link.parquet").symlink_to(outside)
    ps, js = both_sessions(root)
    raw = b'{"paths": "link.parquet"}'
    got = typed(lambda: ps.plan(pproto.parse_scan_request(raw)))
    assert got == typed(lambda: js.plan(jproto.parse_scan_request(raw)))
    assert got[1:3] == (403, "path_outside_root")


def test_remote_map_plans_from_each_stub(corpus):
    from parquet_tpu.testing.httpstub import RangeHttpStub as JaxStub

    from parquet_tpu_torch.testing.httpstub import RangeHttpStub

    files = {n: (corpus / n).read_bytes() for n in ("a.parquet", "b.parquet")}
    with RangeHttpStub(files=files) as pstub, JaxStub(files=files) as jstub:
        ps = psess.ScanSession(root=str(corpus), remote_map={"warm": pstub.base_url + "/"})
        js = jsess.ScanSession(root=str(corpus), remote_map={"warm": jstub.base_url + "/"})
        for body in ({"paths": "warm/a.parquet"},
                     {"paths": ["warm/b.parquet", "a.parquet"], "columns": ["id"],
                      "filters": [["id", ">=", ROWS_A + 900]]}):
            raw = json.dumps(body).encode()
            got = ps.plan(pproto.parse_scan_request(raw))
            want = js.plan(jproto.parse_scan_request(raw))
            assert got.summary() == want.summary()
            assert [u.path.startswith(pstub.base_url) for u in got.units] == [
                u.path.startswith(jstub.base_url) for u in want.units]
        assert pstub.requests > 0
        raw = b'{"paths": "warm/../../../etc/passwd"}'
        got = typed(lambda: ps.plan(pproto.parse_scan_request(raw)))
        assert got == typed(lambda: js.plan(jproto.parse_scan_request(raw)))
        assert got[1:3] == (403, "path_outside_root")


# -- SLO -------------------------------------------------------------------------

SLO_CASES = {
    "defaults": (dict(), [(200, 0.01)] * 50 + [(500, 0.2)] * 3 + [(404, 0.001)] * 5),
    "latency": (dict(p99_ms=50.0), [(200, 0.01)] * 30 + [(200, 0.3)] * 4 + [(499, 2.0)]),
    "burning": (dict(availability=0.99), [(503, 0.002)] * 40 + [(200, 6.0)] * 2
                + [("error", 0.1), ("ok", 0.1)]),
}


@pytest.mark.parametrize("name", sorted(SLO_CASES))
def test_burn_rate_engine_matches_the_reference(name):
    kw, schedule = SLO_CASES[name]
    engines = []
    for mod in (pslo, jslo):
        clock = FakeClock()
        e = mod.BurnRateEngine(mod.SLOObjective(**kw), clock=clock, bucket_s=10.0)
        bodies = []
        for i, (status, secs) in enumerate(schedule):
            clock.t += 7.0 if i % 5 == 0 else 0.5
            e.record(status, secs)
            if i % 9 == 0:
                bodies.append(e.evaluate())
        clock.t += 400.0  # the fast window empties, the slow one keeps the errors
        bodies.append(e.evaluate())
        clock.t += 4000.0
        bodies.append(e.evaluate())
        engines.append(bodies)
    assert engines[0] == engines[1]
    if name == "burning":
        assert any(b["verdict"] == "burning" for b in engines[0])


def test_slo_objective_validation_matches():
    for bad in (dict(availability=1.0), dict(p99_ms=0), dict(fast_window_s=0),
                dict(fast_window_s=10, slow_window_s=5), dict(warn_burn=20.0, page_burn=10.0)):
        with pytest.raises(ValueError) as p:
            pslo.SLOObjective(**bad)
        with pytest.raises(ValueError) as j:
            jslo.SLOObjective(**bad)
        assert str(p.value) == str(j.value)


# -- the CUDA rule ---------------------------------------------------------------


def test_service_without_cuda_and_device_raises(corpus, monkeypatch):
    import torch

    from parquet_tpu_torch.serve import ScanService, ServeConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScanService(ServeConfig(root=str(corpus), port=0))
    svc = ScanService(ServeConfig(root=str(corpus), port=0, device="cpu"))
    assert svc.device.type == "cpu"


def test_serve_config_validation():
    from parquet_tpu_torch.serve import ServeConfig

    for kw, match in ((dict(default_timeout_s=-1), "default_timeout_s"),
                      (dict(max_timeout_s=0), "max_timeout_s"),
                      (dict(max_body_bytes=0), "max_body_bytes"),
                      (dict(slow_ms=0), "slow_ms"),
                      (dict(shard=(2, 2)), "shard"),
                      (dict(slo_availability=1.5), "availability")):
        with pytest.raises(ValueError, match=match):
            ServeConfig(**kw)
    assert ServeConfig(shard=["1", "3"]).shard == (1, 3)
