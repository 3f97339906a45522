"""The port's serve mesh against the JAX package's, over loopback HTTP.

Two fleets on one seeded corpus: the reference's (three ScanServers, a
MeshRouter over them and a direct daemon) and the port's (the same, with
device="cpu" replicas: the kernels' plain versions). Pinned:

  * HashRing: lookup and preference equal over 10,000 keys for 1-5 nodes;
    the same typed ValueErrors;
  * Replica / ReplicaTable: the same state, routability and breaker state
    after every step of the same note scripts (fake time); the same URL
    and MeshConfig validation errors;
  * routed bodies: /v1/query (integer aggregates, unfiltered and
    filtered), /v1/scan jsonl and /v1/plan through the port's router
    byte-equal to the JAX router's, to the port's direct daemon's and to
    the JAX direct daemon's; limit and explicit-shard passthroughs too;
  * typed errors through the router: shard validation, a path outside the
    root, a missing file, /v1/append's 501 not_routable; arrow-ipc scans
    (scattered, limited, filtered, projected, sharded, empty) byte-equal
    to the port's direct daemon and parsed equal to the JAX router's
    bodies; group_by and float sums, which the
    replicas' host engines answer, byte-equal through both routers;
  * the merge of untyped partials (a uint64 column): where each unit's sum
    is below 2^63 and the total crosses it, the port's router answers the
    JAX router's wrapped int64 and one daemon the uint64 value; where a
    unit's sum is at or above 2^63 the JAX router answers a 500 and the
    port's router the direct daemon's value (the repair);
  * resilience on the port's fleet: a replica killed mid-hammer, a
    draining replica, a dead replica's breaker opening; seeded wire faults
    and torn payloads from a FlakyReplica change no body;
  * FlakyReplica of both packages: the same faults in the same order for
    one seed, the same counters;
  * the router's surface: /v1/debug/mesh, /v1/debug/vars in mesh mode,
    /healthz with replica counts, /metrics with the mesh families.

Every socket binds port 0 and has a timeout, every thread join is bounded
(WATCHDOG_S), every daemon, proxy and router is closed in a finally.
Tolerance: exact bytes throughout.
"""

from __future__ import annotations

import http.client
import json
import re
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
from parquet_tpu.serve import ScanServer as JaxServer  # noqa: E402
from parquet_tpu.serve import ServeConfig as JaxConfig  # noqa: E402
from parquet_tpu.serve import mesh as jmesh  # noqa: E402
from parquet_tpu.serve.mesh import table as jtable  # noqa: E402
from parquet_tpu.testing.flaky_replica import FlakyReplica as JaxFlakyReplica  # noqa: E402

from parquet_tpu_torch.serve import ScanServer, ServeConfig  # noqa: E402
from parquet_tpu_torch.serve import mesh as pmesh  # noqa: E402
from parquet_tpu_torch.serve.counts import mesh_counts, reset_mesh_counts  # noqa: E402
from parquet_tpu_torch.serve.mesh import table as ptable  # noqa: E402
from parquet_tpu_torch.testing.flaky_replica import FlakyReplica  # noqa: E402

WATCHDOG_S = 30.0  # every blocking wait in this file is bounded by this

ROWS_PER_FILE = 800
ROW_GROUP = 200
FILES = ("a.parquet", "b.parquet", "c.parquet")
UNITS = len(FILES) * ROWS_PER_FILE // ROW_GROUP
GROUPS = ("alpha", "beta", "gamma", "delta", "epsilon")
RID = {"X-Request-Id": "mesh-test"}  # one id, so typed error bodies compare


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh_corpus")
    rng = np.random.default_rng(23)
    for f, name in enumerate(FILES):
        base = f * ROWS_PER_FILE
        n = ROWS_PER_FILE
        t = pa.table({
            "id": pa.array(np.arange(base, base + n, dtype=np.int64)),
            "k": pa.array(rng.integers(-40, 40, n).astype(np.int32)),
            "opt": pa.array(rng.integers(-9, 9, n), mask=rng.random(n) < 0.2),
            "u": pa.array(rng.integers(0, 1 << 40, n).astype(np.uint64)),
            "v": pa.array(rng.standard_normal(n)),
            "g": pa.array([GROUPS[i % len(GROUPS)] for i in range(n)]),
        })
        pq.write_table(t, str(d / name), row_group_size=ROW_GROUP)
    # the merge cases: uint64 columns of two 3-row units each; in cross
    # each unit's sum is 3 * 2^61 (below 2^63) and the total crosses 2^63,
    # in big each unit's sum is 3 * 2^62 (at or above 2^63)
    (d / "wide").mkdir()
    for name, value in (("cross.parquet", 1 << 61), ("big.parquet", 1 << 62)):
        t = pa.table({"w": pa.array(np.full(6, value, dtype=np.uint64))})
        pq.write_table(t, str(d / "wide" / name), row_group_size=3)
    return d


def close_all(things):
    for s in things:
        try:
            s.close()
        except Exception:  # noqa: BLE001 - close every one, whatever
            pass


@pytest.fixture(scope="module")
def fleets(corpus):
    """{"port": (direct, replicas, router), "jax": (...)} over the corpus."""
    made = []
    try:
        out = {}
        for pkg in ("jax", "port"):
            if pkg == "port":
                daemon = lambda: ScanServer(ServeConfig(port=0, root=str(corpus), device="cpu"))  # noqa: E731
                mesh = pmesh
            else:
                daemon = lambda: JaxServer(JaxConfig(port=0, root=str(corpus)))  # noqa: E731
                mesh = jmesh
            direct = daemon().start_background()
            made.append(direct)
            replicas = [daemon().start_background() for _ in range(3)]
            made.extend(replicas)
            router = mesh.MeshRouter(mesh.MeshConfig(
                port=0, replicas=tuple(r.url for r in replicas))).start_background()
            made.append(router)
            out[pkg] = (direct, replicas, router)
        yield out
    finally:
        close_all(made)


@pytest.fixture(scope="module")
def arrow_fleet(corpus):
    """A port fleet (direct, replicas, router) of its own for the routed
    arrow-ipc scans."""
    made = []
    try:
        daemon = lambda: ScanServer(ServeConfig(port=0, root=str(corpus), device="cpu"))  # noqa: E731
        direct = daemon().start_background()
        made.append(direct)
        replicas = [daemon().start_background() for _ in range(3)]
        made.extend(replicas)
        router = pmesh.MeshRouter(pmesh.MeshConfig(
            port=0, replicas=tuple(r.url for r in replicas))).start_background()
        made.append(router)
        yield direct, replicas, router
    finally:
        close_all(made)


def request(server, method, path, body=None, headers=None):
    """One HTTP exchange with a hard socket timeout: (status, headers, body)."""
    if isinstance(body, dict):
        body = json.dumps(body).encode()
    conn = http.client.HTTPConnection(server.host, server.port, timeout=WATCHDOG_S)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def error_code(body: bytes) -> str:
    return json.loads(body)["error"]["code"]


def with_watchdog(fn, timeout: float = WATCHDOG_S * 2):
    """fn() on a thread, failing the test if it outlives `timeout`."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 - surfaced below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"watchdog: still running after {timeout} s (hang)")
    if err:
        raise err[0]
    return out[0]


# -- consistent hashing ----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_ring_matches_the_reference(n):
    nodes = [f"http://10.0.0.{i}:{8000 + i}" for i in range(n)]
    a = pmesh.HashRing(nodes, vnodes=64)
    b = jmesh.HashRing(nodes, vnodes=64)
    assert a.nodes == b.nodes
    for k in range(10_000):
        key = f"*.parquet#{k}"
        assert a.lookup(key) == b.lookup(key)
        assert a.preference(key) == b.preference(key)
    owners = {a.lookup(f"plan#{k}") for k in range(500)}
    assert owners == set(nodes)


@pytest.mark.parametrize("nodes,vnodes", [((), 64), (("http://h:1",), 0)], ids=["empty", "vnodes"])
def test_ring_rejections_match(nodes, vnodes):
    msgs = []
    for mod in (pmesh, jmesh):
        with pytest.raises(ValueError) as ei:
            mod.HashRing(nodes, vnodes=vnodes)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("urls", [(), ("ftp://nope:1",), ("http://host:1/path",), ("http://:8",),
                                  ("http://h:1?q=1",)], ids=range(5))
def test_table_rejections_match(urls):
    msgs = []
    for mod in (pmesh, jmesh):
        with pytest.raises(ValueError) as ei:
            mod.ReplicaTable(urls)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


MESH_CONFIGS = [
    dict(replicas=()),
    dict(replicas=("http://h:1",), vnodes=0),
    dict(replicas=("http://h:1",), scatter_window=0),
    dict(replicas=("http://h:1",), backend_timeout_s=0),
    dict(replicas=("http://h:1",), breaker_failures=0),
    dict(replicas=("http://h:1",), breaker_open_s=0),
    dict(replicas=("http://h:1",), hedge_min_s=1.0, hedge_max_s=0.5),
    dict(replicas=("http://h:1",), window=0),
]


@pytest.mark.parametrize("kw", MESH_CONFIGS, ids=range(len(MESH_CONFIGS)))
def test_mesh_config_rejections_match(kw):
    msgs = []
    for mod in (pmesh, jmesh):
        with pytest.raises(ValueError) as ei:
            mod.MeshConfig(port=0, **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_mesh_config_normalizes_replicas():
    urls = ("http://h:1/", "http://h:2", "http://h:1")
    assert pmesh.MeshConfig(port=0, replicas=urls).replicas == jmesh.MeshConfig(
        port=0, replicas=urls).replicas == ("http://h:1", "http://h:2")


# -- the replica table under fake time --------------------------------------------


class FakeTime:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


REPLICA_SCRIPTS = {
    "breaker_opens_and_half_opens": [("fail",), ("fail",), ("fail",), ("tick", 1.0), ("tick", 1.5),
                                     ("ok",), ("fail",)],
    "success_resets_the_streak": [("fail",), ("fail",), ("ok",), ("fail",), ("fail",), ("fail",)],
    "draining_hint_then_expiry": [("drain", 5), ("tick", 4.9), ("tick", 0.2), ("drain", None),
                                  ("tick", 0.5), ("tick", 0.6), ("drain", 100), ("tick", 29.0),
                                  ("tick", 1.5)],
    "down_then_ok": [("down", 2.0), ("tick", 1.0), ("ok",), ("down", 0.5), ("tick", 0.6)],
    "degraded": [("ok", True), ("fail",), ("ok", False), ("ok", True), ("drain", 1)],
    "open_breaker_wins_over_flags": [("drain", 30), ("fail",), ("fail",), ("fail",), ("tick", 3.0),
                                     ("fail",)],
}


def run_replica_script(mod, table_mod, script, monkeypatch):
    fake = FakeTime()
    monkeypatch.setattr(table_mod, "time", fake)
    table = mod.ReplicaTable(("http://127.0.0.1:9001", "http://127.0.0.1:9002/"),
                             failure_threshold=3, open_s=2.0)
    rep = table.by_url["http://127.0.0.1:9001"]
    rep.breaker._clock = fake.monotonic
    out = []
    for step in script:
        op = step[0]
        if op == "fail":
            rep.note_failure()
        elif op == "ok":
            rep.note_ok(*step[1:])
        elif op == "drain":
            rep.note_draining(step[1])
        elif op == "down":
            rep.note_down(step[1])
        elif op == "tick":
            fake.t += step[1]
        out.append((rep.state(), rep.routable(), rep.breaker.state, table.counts(),
                    [r.url for r in table.routable()], table.snapshot()))
    return out


@pytest.mark.parametrize("name", sorted(REPLICA_SCRIPTS))
def test_replica_states_match_the_reference(name, monkeypatch):
    script = REPLICA_SCRIPTS[name]
    got = run_replica_script(pmesh, ptable, script, monkeypatch)
    want = run_replica_script(jmesh, jtable, script, monkeypatch)
    assert got == want


def test_replica_notes_are_counted_by_state(monkeypatch):
    """The reference's mesh_replica_state gauge is a count in the port: one
    a note, under the state after it."""
    reset_mesh_counts()
    run_replica_script(pmesh, ptable, REPLICA_SCRIPTS["open_breaker_wins_over_flags"], monkeypatch)
    got = {k: v for k, v in mesh_counts().items() if k.startswith("mesh_replica_state_total")}
    assert got == {
        'mesh_replica_state_total{replica="127.0.0.1:9001",state="up"}': 1,
        'mesh_replica_state_total{replica="127.0.0.1:9002",state="up"}': 1,
        'mesh_replica_state_total{replica="127.0.0.1:9001",state="draining"}': 3,
        'mesh_replica_state_total{replica="127.0.0.1:9001",state="open-breaker"}': 2,
    }


# -- routed bodies: the port's router, its direct daemon, the JAX fleet -------------

AGGS = ["count", ["count", "opt"], ["sum", "id"], ["min", "id"], ["max", "id"], ["sum", "k"],
        ["min", "k"], ["max", "k"], ["sum", "opt"], ["min", "opt"], ["max", "opt"], ["sum", "u"],
        ["max", "u"]]

QUERIES = [
    {"paths": "*.parquet", "aggregates": AGGS},
    {"paths": "*.parquet", "aggregates": AGGS, "filters": [["id", ">=", 700], ["id", "<", 1900]]},
    {"paths": "*.parquet", "aggregates": AGGS, "filters": [["g", "in", ["beta", "delta"]],
                                                          ["k", ">", 0]]},
    {"paths": ["b.parquet", "a.parquet"], "aggregates": ["count", ["sum", "u"]],
     "filters": [[["id", "<", 90]], [["opt", "is_null"]]]},
    {"paths": "*.parquet", "aggregates": ["count"]},
    {"paths": "*.parquet", "aggregates": AGGS, "shard": [1, 3]},
    {"paths": "*.parquet", "aggregates": AGGS, "filters": [["id", ">", 10**9]]},
    {"paths": "a.parquet", "aggregates": AGGS, "filters": [["id", "<", ROW_GROUP]]},
]


def without_trace_id(raw: bytes) -> bytes:
    """An error body without its trace_id (each request's is its own),
    re-rendered as both packages' daemons render bodies."""
    doc = json.loads(raw)
    doc["error"].pop("trace_id", None)
    return (json.dumps(doc) + "\n").encode()


def all_equal(fleets, method, path, body=None, headers=None):
    """The exchange on the port's router and direct daemon and on the JAX
    router and direct daemon: every status and body equal (error bodies
    without their trace_id). Returns the port router's (status, body)."""
    out = [request(fleets[pkg][i], method, path, body, headers)
           for pkg in ("port", "jax") for i in (2, 0)]
    got = [(st, raw if st == 200 else without_trace_id(raw)) for st, _h, raw in out]
    assert len(set(got)) == 1, [(st, raw[:300]) for st, raw in got]
    return got[0]


@pytest.mark.parametrize("body", QUERIES, ids=range(len(QUERIES)))
def test_routed_query_bodies_equal(fleets, body):
    reset_mesh_counts()
    status, raw = all_equal(fleets, "POST", "/v1/query", body)
    assert status == 200
    doc = json.loads(raw)
    mode = "passthrough" if "shard" in body or doc["units"] <= 1 else "scatter"
    assert mesh_counts()[f'mesh_requests_total{{endpoint="/v1/query",mode="{mode}"}}'] == 1


SCANS = [
    {"paths": "*.parquet"},
    {"paths": "*.parquet", "columns": ["id", "g"], "filters": [["id", ">=", 700], ["id", "<", 1900]]},
    {"paths": ["c.parquet", "a.parquet"], "columns": ["k", "opt", "u"],
     "filters": [["opt", "not_null"], ["k", "<", 0]]},
    {"paths": "*.parquet", "limit": 123},
    {"paths": "*.parquet", "columns": ["v"], "shard": [2, 3]},
    {"paths": "*.parquet", "filters": [["id", ">", 10**9]]},
]


@pytest.mark.parametrize("body", SCANS, ids=range(len(SCANS)))
def test_routed_scan_bodies_equal(fleets, body):
    status, raw = all_equal(fleets, "POST", "/v1/scan", body)
    assert status == 200
    if "limit" in body:
        assert len(raw.splitlines()) == body["limit"]


def test_routed_scan_rows_and_stripes(fleets):
    router = fleets["port"][2]
    raw = request(router, "POST", "/v1/scan", {"paths": "*.parquet", "columns": ["id"],
                                               "filters": [["id", ">=", 700], ["id", "<", 1900]]})[2]
    assert [json.loads(line)["id"] for line in raw.splitlines()] == list(range(700, 1900))
    stripes = [request(router, "POST", "/v1/scan", {"paths": "*.parquet", "shard": [i, 3]})[2]
               for i in range(3)]
    whole = request(router, "POST", "/v1/scan", {"paths": "*.parquet"})[2]
    assert sum(len(s.splitlines()) for s in stripes) == len(whole.splitlines()) == 3 * ROWS_PER_FILE


PLANS = [
    ("POST", {"paths": "*.parquet"}),
    ("POST", {"paths": "*.parquet", "columns": ["id"], "filters": [["id", "<", 450]]}),
    ("GET", "/v1/plan?paths=a.parquet,b.parquet&columns=k"),
]


@pytest.mark.parametrize("how", PLANS, ids=range(len(PLANS)))
def test_routed_plan_bodies_equal(fleets, how):
    method, what = how
    if method == "GET":
        status, raw = all_equal(fleets, "GET", what)
    else:
        status, raw = all_equal(fleets, "POST", "/v1/plan", what)
    assert status == 200 and json.loads(raw)["units"] >= 1


# -- typed errors through the router ---------------------------------------------------

ERRORS = [
    ("/v1/query", {"paths": "*.parquet", "aggregates": ["count"], "shard": [3, 3]}, 400),
    ("/v1/scan", {"paths": "*.parquet", "shard": [0, 0]}, 400),
    ("/v1/scan", {"paths": "*.parquet", "shard": "x"}, 400),
    ("/v1/scan", {"paths": "../escape.parquet"}, 403),
    ("/v1/scan", {"paths": "missing.parquet"}, 404),
    ("/v1/query", {"paths": "nope-*.parquet", "aggregates": ["count"]}, 404),
    ("/v1/query", {"paths": "a.parquet", "aggregates": [["sum", "nope"]]}, 400),
    ("/v1/plan", {"paths": "a.parquet", "limit": -1}, 400),
]


@pytest.mark.parametrize("path,body,status", ERRORS, ids=range(len(ERRORS)))
def test_typed_errors_equal_through_the_routers(fleets, path, body, status):
    st, raw = all_equal(fleets, "POST", path, body, RID)
    assert st == status and json.loads(raw)["error"]["request_id"] == RID["X-Request-Id"]


def test_append_is_typed_not_routable(fleets):
    out = [request(fleets[pkg][2], "POST", "/v1/append", b'{"k": 1}\n',
                   {"Content-Type": "application/x-ndjson", **RID}) for pkg in ("port", "jax")]
    assert out[0][0] == out[1][0] == 501
    assert without_trace_id(out[0][2]) == without_trace_id(out[1][2])
    assert error_code(out[0][2]) == "not_routable"
    assert "replica" in json.loads(out[0][2])["error"]["message"]


@pytest.mark.parametrize("body,status,code", [
    ({"paths": "*.parquet", "format": "arrow-ipc"}, 200, None),
    ({"paths": "*.parquet", "format": "arrow-ipc", "limit": 5}, 200, None),
], ids=["scatter", "passthrough"])
def test_arrow_ipc_is_the_daemons_not_ported(fleets, body, status, code):
    """Once the port's cut (the daemon's 501 not_ported), now parity: the
    port's router re-frames the replicas' arrow-ipc streams through one
    writer, and its body equals its direct daemon's byte for byte,
    scattered and with a limit (passed through); the JAX router's body
    parses equal."""
    direct, _replicas, router = fleets["port"]
    got = request(router, "POST", "/v1/scan", body, RID)
    want = request(direct, "POST", "/v1/scan", body, RID)
    assert (got[0], got[2]) == (want[0], want[2])
    assert got[0] == status and code is None
    assert got[1]["Content-Type"] == "application/vnd.apache.arrow.stream"
    ref = request(fleets["jax"][2], "POST", "/v1/scan", body)
    assert ref[0] == 200
    assert pa.ipc.open_stream(got[2]).read_all().equals(pa.ipc.open_stream(ref[2]).read_all())
    assert router.service.admission.in_flight == 0


@pytest.mark.parametrize("body", [
    {"paths": "*.parquet", "format": "arrow-ipc", "filters": [["v", ">", 0.25]]},
    {"paths": "*.parquet", "format": "arrow-ipc", "columns": ["id", "g"],
     "filters": [["id", ">=", 700], ["id", "<", 1900]]},
    {"paths": "*.parquet", "format": "arrow-ipc", "shard": [1, 2]},
    {"paths": "*.parquet", "format": "arrow-ipc", "filters": [["id", "<", -1]]},
], ids=["filtered", "columns", "shard", "empty"])
def test_routed_arrow_ipc_is_the_direct_daemons_bytes(arrow_fleet, fleets, body):
    """The reference's invariant (its TestRoutedByteIdentity): the routed
    arrow-ipc body is the direct daemon's, byte for byte, and one valid
    stream; pyarrow reads it equal to the JAX direct daemon's body. A
    fleet of its own, so the shared routers' SLO windows see none of these
    requests."""
    direct, _replicas, router = arrow_fleet
    got = request(router, "POST", "/v1/scan", body, RID)
    want = request(direct, "POST", "/v1/scan", body, RID)
    assert got[0] == want[0] == 200 and got[2] == want[2]
    table = pa.ipc.open_stream(pa.py_buffer(got[2])).read_all()
    ref = request(fleets["jax"][0], "POST", "/v1/scan", body)
    assert table.equals(pa.ipc.open_stream(ref[2]).read_all())
    if "filters" in body and body["filters"][0][0] == "v":
        assert table.num_rows > 0 and np.all(table.column("v").to_numpy() > 0.25)


@pytest.mark.parametrize("body", [
    {"paths": "*.parquet", "group_by": ["g"], "aggregates": [["count"], ["sum", "v"],
                                                             ["min", "id"], ["max", "v"]]},
    {"paths": "*.parquet", "aggregates": [["sum", "v"]]},
], ids=["group_by_float_sums", "float_sum"])
def test_declined_units_forward_the_replicas_typed_400(fleets, body):
    """The reference's routed float-sum identity: the replicas' devices
    decline these units and their host engines answer them; each router's
    merge of the per-unit bodies equals its direct daemon's, and the port's
    bodies equal the reference's byte for byte."""
    got = request(fleets["port"][2], "POST", "/v1/query", body, RID)
    want = request(fleets["port"][0], "POST", "/v1/query", body, RID)
    jr = request(fleets["jax"][2], "POST", "/v1/query", body)
    jd = request(fleets["jax"][0], "POST", "/v1/query", body)
    assert got[0] == want[0] == jr[0] == jd[0] == 200
    assert got[2] == want[2] == jr[2] == jd[2]


# -- the merge of untyped partials: uint64 ---------------------------------------------


@pytest.fixture()
def wide_bodies(fleets):
    def run(name):
        body = {"paths": f"wide/{name}", "aggregates": ["count", ["sum", "w"], ["min", "w"],
                                                        ["max", "w"]]}
        return {(pkg, role): request(fleets[pkg][i], "POST", "/v1/query", body, RID)
                for pkg in ("port", "jax") for i, role in ((0, "direct"), (2, "router"))}

    return run


def test_uint64_unit_sums_crossing_2_63_keep_the_int64_wrap(wide_bodies):
    """Each unit of cross.parquet sums to 3 * 2^61 (below 2^63), the total
    6 * 2^61 crosses it: one daemon (either package) answers the uint64
    total, both routers its int64 wrap (the reference's pyarrow inference,
    kept: no type rides the wire to tell the column's domain)."""
    out = wide_bodies("cross.parquet")
    total = 6 << 61
    direct = json.loads(out["port", "direct"][2])["result"]
    assert out["port", "direct"][2] == out["jax", "direct"][2]
    assert direct == {"count": 6, "sum(w)": total, "min(w)": 1 << 61, "max(w)": 1 << 61}
    routed = json.loads(out["port", "router"][2])["result"]
    assert out["port", "router"][2] == out["jax", "router"][2]
    assert routed["sum(w)"] == total - (1 << 64) < 0
    assert {k: v for k, v in routed.items() if k != "sum(w)"} == {
        k: v for k, v in direct.items() if k != "sum(w)"}


def test_uint64_unit_sum_at_2_63_is_repaired(wide_bodies):
    """A unit of big.parquet sums to 3 * 2^62 (at or above 2^63): the JAX
    router cannot convert it (a 500 internal), the port's router merges that
    aggregate as uint64 and answers the direct daemon's bytes."""
    out = wide_bodies("big.parquet")
    assert out["port", "direct"][2] == out["jax", "direct"][2]
    direct = json.loads(out["port", "direct"][2])["result"]
    assert direct == {"count": 6, "sum(w)": (6 << 62) & ((1 << 64) - 1), "min(w)": 1 << 62,
                      "max(w)": 1 << 62}
    st, _h, raw = out["jax", "router"]
    assert (st, error_code(raw)) == (500, "internal") and "too large" in raw.decode()
    assert out["port", "router"][:1] == (200,) and out["port", "router"][2] == out["port", "direct"][2]


# -- resilience on the port's fleet ---------------------------------------------------


def mini_fleet(corpus, n=3, **mesh_kw):
    replicas = [ScanServer(ServeConfig(port=0, root=str(corpus), device="cpu")).start_background()
                for _ in range(n)]
    router = pmesh.MeshRouter(pmesh.MeshConfig(
        port=0, replicas=tuple(r.url for r in replicas), **mesh_kw)).start_background()
    return replicas, router


def test_replica_killed_mid_hammer_typed_retries_only(corpus):
    replicas, router = mini_fleet(corpus)
    try:
        def run():
            want = request(router, "POST", "/v1/scan", {"paths": "*.parquet"})[2]
            results: list = []
            stop = threading.Event()

            def hammer():
                while not stop.is_set():
                    try:
                        st, _h, body = request(router, "POST", "/v1/scan", {"paths": "*.parquet"})
                    except http.client.HTTPException as e:
                        results.append(("torn", repr(e)))
                        continue
                    if st == 200:
                        results.append(("ok", None) if body == want else ("mismatch", len(body)))
                    else:
                        results.append(("typed", error_code(body)))

            threads = [threading.Thread(target=hammer) for _ in range(4)]
            for t in threads:
                t.start()
            time.sleep(0.4)
            replicas[1].close()  # a hard kill, requests in flight
            time.sleep(1.2)
            stop.set()
            for t in threads:
                t.join(WATCHDOG_S)
                assert not t.is_alive(), "a hammer thread hung"
            kinds = {k for k, _ in results}
            assert "mismatch" not in kinds and "torn" not in kinds, results
            assert ("ok", None) in results
            st, _h, body = request(router, "POST", "/v1/scan", {"paths": "*.parquet"})
            assert st == 200 and body == want

        with_watchdog(run)
    finally:
        close_all([router] + replicas)


def test_replica_draining_bodies_stay_equal(corpus):
    replicas, router = mini_fleet(corpus)
    query = {"paths": "*.parquet", "aggregates": AGGS}
    try:
        def run():
            want_scan = request(router, "POST", "/v1/scan", {"paths": "*.parquet"})[2]
            want_query = request(router, "POST", "/v1/query", query)[2]
            t = threading.Thread(target=replicas[0].drain, kwargs={"timeout": WATCHDOG_S})
            t.start()
            end = time.monotonic() + WATCHDOG_S
            while not replicas[0].service.admission.draining:
                assert time.monotonic() < end
                time.sleep(0.005)
            for _ in range(3):
                st, _h, body = request(router, "POST", "/v1/scan", {"paths": "*.parquet"})
                assert st == 200 and body == want_scan
                st, _h, body = request(router, "POST", "/v1/query", query)
                assert st == 200 and body == want_query
            st, _h, body = request(router, "GET", "/v1/debug/mesh")
            states = [r["state"] for r in json.loads(body)["replicas"]]
            assert st == 200 and states.count("draining") == 1, states
            t.join(WATCHDOG_S)
            assert not t.is_alive()

        with_watchdog(run)
    finally:
        close_all([router] + replicas)


def test_dead_replica_opens_its_breaker(corpus):
    replicas, router = mini_fleet(corpus, breaker_failures=2, breaker_open_s=WATCHDOG_S)
    try:
        def run():
            reset_mesh_counts()
            replicas[2].close()
            dead = router.service.table.by_url[replicas[2].url]
            for i in range(12):
                st, _h, _b = request(router, "POST", "/v1/scan",
                                     {"paths": "*.parquet", "filters": [["id", ">=", i]]})
                assert st == 200
                if dead.breaker.state == "open":
                    break
            assert dead.breaker.state == "open" and dead.state() == "open-breaker"
            t0 = time.monotonic()
            st, _h, _b = request(router, "POST", "/v1/scan", {"paths": "*.parquet"})
            assert st == 200 and time.monotonic() - t0 < WATCHDOG_S / 2
            counts = mesh_counts()
            assert counts.get('mesh_retries_total{reason="transport"}', 0) >= 2
            st, _h, body = request(router, "GET", "/healthz")
            assert st == 200 and json.loads(body)["replicas"]["open-breaker"] == 1

        with_watchdog(run)
    finally:
        close_all([router] + replicas)


# -- FlakyReplica ---------------------------------------------------------------------


# the traceparent each outcomes() request sends: both proxies record it
OUTCOME_TP = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"


def outcomes(proxy_cls, backend_url, n, **knobs):
    """n sequential GET /healthz through a fresh proxy, each with
    OUTCOME_TP: each one's outcome (status and body length, or the
    transport failure's kind), and the proxy's counters."""
    out = []
    with proxy_cls(backend_url, seed=7, **knobs) as proxy:
        for _ in range(n):
            conn = http.client.HTTPConnection("127.0.0.1", proxy.port, timeout=WATCHDOG_S)
            try:
                conn.request("GET", "/healthz", headers={"traceparent": OUTCOME_TP})
                resp = conn.getresponse()
                out.append(("answer", resp.status, len(resp.read())))
            except http.client.IncompleteRead as e:
                out.append(("torn", len(e.partial)))
            except (http.client.HTTPException, OSError) as e:
                out.append(("dropped", type(e).__name__))
            finally:
                conn.close()
        counters = (proxy.requests, proxy.faults_injected, proxy.proxied, proxy.traceparents)
    return out, counters


@pytest.mark.parametrize("knobs", [
    dict(error_rate=0.2, drop_rate=0.15, short_rate=0.2),
    dict(short_rate=0.5),
    dict(error_rate=0.3, spike_rate=0.5, spike_s=0.001, latency_s=0.001),
    dict(permanent=True),
], ids=["mixed", "short", "errors_spikes", "permanent"])
def test_flaky_replica_matches_the_reference(fleets, knobs):
    backend = fleets["port"][0].url
    got = with_watchdog(lambda: outcomes(FlakyReplica, backend, 40, **knobs))
    want = with_watchdog(lambda: outcomes(JaxFlakyReplica, backend, 40, **knobs))
    assert got == want
    # faults fired; each proxy recorded every traceparent that reached it
    assert got[1][1] > 0 and got[1][3] == want[1][3] and set(got[1][3]) == {OUTCOME_TP}


def test_flaky_replica_refuses_a_bad_backend():
    for cls in (FlakyReplica, JaxFlakyReplica):
        with pytest.raises(ValueError, match="need an http://host:port backend"):
            cls("ftp://h:1")


@pytest.mark.parametrize("knobs,seed", [(dict(error_rate=0.2, drop_rate=0.15, short_rate=0.15), 23),
                                        (dict(short_rate=0.5), 5)], ids=["wire_faults", "torn"])
def test_wire_faults_change_no_routed_body(corpus, knobs, seed):
    """503s, resets and torn payloads between the router and one replica:
    every routed body equals the clean replica's (a torn answer is
    re-fetched whole, never spliced)."""
    backend = ScanServer(ServeConfig(port=0, root=str(corpus), device="cpu")).start_background()
    clean = ScanServer(ServeConfig(port=0, root=str(corpus), device="cpu")).start_background()
    proxy = FlakyReplica(backend.url, seed=seed, **knobs).start()
    router = pmesh.MeshRouter(pmesh.MeshConfig(port=0, replicas=(proxy.url, clean.url)))
    router.start_background()
    query = {"paths": "*.parquet", "aggregates": AGGS}
    try:
        def run():
            want_scan = request(clean, "POST", "/v1/scan", {"paths": "*.parquet"})[2]
            want_query = request(clean, "POST", "/v1/query", query)[2]
            for _ in range(5):
                st, _h, body = request(router, "POST", "/v1/scan", {"paths": "*.parquet"})
                assert st == 200 and body == want_scan
                st, _h, body = request(router, "POST", "/v1/query", query)
                assert st == 200 and body == want_query
            # every attempt through the proxy carried the router's child
            # traceparent, in the reference's wire format
            assert proxy.faults_injected > 0 and proxy.traceparents
            assert all(re.fullmatch(r"00-[0-9a-f]{32}-[0-9a-f]{16}-01", tp)
                       for tp in proxy.traceparents)

        with_watchdog(run)
    finally:
        close_all([router, proxy, backend, clean])


# -- the router's surface ---------------------------------------------------------------


def test_debug_mesh_shape(fleets):
    _direct, replicas, router = fleets["port"]
    status, _h, body = request(router, "GET", "/v1/debug/mesh")
    doc = json.loads(body)
    assert status == 200 and len(doc["replicas"]) == 3
    for row in doc["replicas"]:
        assert row["state"] == "up" and row["healthz"]["status"] == "ok"
        assert set(row) == {"url", "state", "breaker", "p95_ms", "healthz"}
    assert doc["counts"] == {"up": 3, "degraded": 0, "draining": 0, "open-breaker": 0, "down": 0}
    assert doc["ring"] == {"vnodes": 64, "nodes": [r.url for r in replicas]}
    assert doc["scatter"] == {"enabled": True, "window": 8}
    assert doc["hedge"] == {"enabled": True, "min_s": 0.05, "max_s": 2.0}
    jdoc = json.loads(request(fleets["jax"][2], "GET", "/v1/debug/mesh")[2])
    assert set(jdoc) == set(doc) and jdoc["counts"] == doc["counts"]


def test_debug_vars_mesh_mode(fleets):
    router = fleets["port"][2]
    doc = json.loads(request(router, "GET", "/v1/debug/vars")[2])
    jdoc = json.loads(request(fleets["jax"][2], "GET", "/v1/debug/vars")[2])
    assert doc["mode"] == "mesh" and len(doc["replicas"]) == 3
    assert doc["mesh"] == jdoc["mesh"] and doc["serve"] == jdoc["serve"]
    assert set(jdoc) == set(doc) and doc["obs"] == jdoc["obs"]
    assert doc["pools"]["sizes"] == {"pqt-mesh": 16}
    assert set(doc["pools"]) == set(jdoc["pools"]) | {"sizes"}


def test_healthz_reports_replica_counts(fleets):
    """The bodies agree but for the SLO verdict, which each router derives
    from its own answers: the JAX router's 500 on a uint64 sum at or above
    2^63 (which the port's router repairs, ROADMAP section 3) is an error
    only in its window. Each status follows its own router's verdict."""
    got = request(fleets["port"][2], "GET", "/healthz")
    want = request(fleets["jax"][2], "GET", "/healthz")
    assert got[0] == want[0] == 200
    docs = [json.loads(got[2]), json.loads(want[2])]
    for doc, router in zip(docs, (fleets["port"][2], fleets["jax"][2])):
        verdict = router.service.slo.evaluate()["verdict"]
        assert doc["slo"] == verdict
        assert doc["status"] == ("degraded" if verdict == "burning" else "ok")
    assert [{k: v for k, v in d.items() if k not in ("status", "slo")} for d in docs[:1]] == [
        {k: v for k, v in docs[1].items() if k not in ("status", "slo")}]
    assert docs[0]["replicas"]["up"] == 3


def test_metrics_render_the_mesh_families(fleets):
    direct, _replicas, router = fleets["port"]
    request(router, "POST", "/v1/scan", {"paths": "a.parquet"})
    status, _h, body = request(router, "GET", "/metrics")
    text = body.decode()
    assert status == 200
    for family in ("mesh_requests_total", "mesh_backend_requests_total",
                   "mesh_scatter_units_total", "mesh_replica_state_total",
                   "serve_requests_total"):
        name = f"parquet_tpu_{family}"
        assert f"# HELP {name} " in text and f"# TYPE {name} counter" in text, family
    assert "# TYPE parquet_tpu_mesh_replica_state gauge" in text
    assert 'parquet_tpu_mesh_scatter_units_total{endpoint="/v1/scan"}' in text


def test_router_constructs_without_a_device(monkeypatch):
    """The router holds no device: it builds where CUDA is absent and no
    device= is given (its replicas are what need one)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    router = pmesh.MeshRouter(pmesh.MeshConfig(port=0, replicas=("http://127.0.0.1:9",)))
    with router.start_background() as r:
        assert not hasattr(r.service, "device")
        with pytest.raises(RuntimeError, match="CUDA"):
            ScanServer(ServeConfig(port=0))
