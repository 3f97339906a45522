"""The port's scan daemon against the JAX package's, over loopback HTTP.

Two daemons on one corpus: the reference's ScanServer and the port's with
device="cpu" (the kernels' plain versions). Pinned:

  * scans: /v1/scan bodies byte-equal for columns, filters, limit, shard
    and globs; plans: /v1/plan bodies equal, GET and POST;
  * queries inside the device envelope: /v1/query bodies byte-equal to the
    reference run with device=None (its pyarrow engine) and with
    device=True (its jax engine on the CPU); outside it the port's host
    engine answers, counted host_fallback, byte-equal to the reference's;
  * typed errors: equal status and code for bad JSON, an unknown column, a
    path outside the root, a missing file, a body over the limit (413
    before buffering), an unknown route; keep-alive after an error with an
    unread body; a corrupt row group: 422 before the first chunk, and a
    torn stream (terminal error line, no 0-chunk) mid-stream;
  * admission with gated sources, on both daemons: queue full then
    recovery, budget exhaustion, a deadline that expires mid-scan (504,
    /healthz 200 after), drain (the request in flight completes, a new one
    is a 503, /healthz a 503);
  * eight concurrent clients get byte-identical bodies;
  * /v1/append (the counterpart of tests/test_lake.py's TestAppendHTTP):
    buffered then flushed acks equal, typed errors equal, a daemon query of
    the table equal; arrow-ipc appends commit the reference's rows;
  * arrow-ipc scans (whole, filtered, limited, sharded, empty, across two
    files): 200, the reference's Content-Type, bodies that parse equal to
    the reference daemon's; a draining daemon's 503 for them too;
  * the port's own answers: each
    debug route the reference's status and body keys; /metrics the
    registry's exposition (classic and OpenMetrics); /v1/debug/vars' keys;
    X-Request-Id echoed and minted; traceparent resolved and echoed.

Every socket binds port 0, every daemon is closed in a fixture's finally
with its admission at 0 in flight, every wait has a timeout of its own,
requests are held in flight by gated sources (never a sleep race), and no
wall time is asserted. Tolerance: exact (bytes, statuses, codes).
"""

from __future__ import annotations

import http.client
import json
import os
import re
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
from parquet_tpu.io.source import LocalFileSource as JaxLocalSource  # noqa: E402
from parquet_tpu.serve import ScanServer as JaxServer  # noqa: E402
from parquet_tpu.serve import ServeConfig as JaxConfig  # noqa: E402

from parquet_tpu_torch.io import planner as pplanner  # noqa: E402
from parquet_tpu_torch.io.source import LocalFileSource  # noqa: E402
from parquet_tpu_torch.serve import executor as pexecutor  # noqa: E402
from parquet_tpu_torch.serve import (  # noqa: E402
    ScanServer,
    ServeConfig,
    query_device_counts,
    reset_query_device_counts,
    reset_serve_counts,
    serve_counts,
)

WATCHDOG_S = 30.0  # every blocking wait in this file is bounded by this

ROWS_A, ROWS_B = 2400, 1800
ROW_GROUP = 800
LAKE_SCHEMA = "message m { required int64 k; optional binary v (STRING); }"


def write_corpus(d):
    rng = np.random.default_rng(11)
    for name, (base, n) in {"a.parquet": (0, ROWS_A), "b.parquet": (ROWS_A, ROWS_B)}.items():
        t = pa.table({
            "id": pa.array(np.arange(base, base + n, dtype=np.int64)),
            "k": pa.array(rng.integers(0, 9, n).astype(np.int32)),
            "v": pa.array(rng.standard_normal(n)),
            "name": pa.array([f"n{i % 13}" for i in range(n)]),
            "opt": pa.array(rng.integers(-50, 50, n), mask=rng.random(n) < 0.2),
        })
        pq.write_table(t, str(d / name), row_group_size=ROW_GROUP)
    return d


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("serve_http_corpus"))


def wait_until(what, cond):
    """A bounded wait: the daemon finishes a request's counts and releases
    its ticket just after the client has the response."""
    end = time.monotonic() + WATCHDOG_S
    while not cond():
        assert time.monotonic() < end, f"{what}: not reached in {WATCHDOG_S} s"
        time.sleep(0.002)


def close_idle(servers):
    """Close every daemon, each after its admission is back at 0 in flight."""
    try:
        for s in servers:
            wait_until("in flight back to 0", lambda s=s: s.service.admission.in_flight == 0)
            assert s.service.admission.in_flight == 0
    finally:
        for s in servers:
            s.close()


@pytest.fixture(scope="module")
def pair(corpus):
    """(port, reference with device=None, reference with device=True)."""
    servers = []
    try:
        servers.append(ScanServer(ServeConfig(port=0, root=str(corpus), device="cpu")))
        servers.append(JaxServer(JaxConfig(port=0, root=str(corpus))))
        servers.append(JaxServer(JaxConfig(port=0, root=str(corpus), device=True)))
        for s in servers:
            s.start_background()
        yield tuple(servers)
    finally:
        for s in servers:
            s.close()


@pytest.fixture(autouse=True)
def pair_idle_after(request):
    """After every test that used the shared daemons: 0 in flight."""
    yield
    if "pair" in request.fixturenames:
        for s in request.getfixturevalue("pair"):
            wait_until("in flight back to 0", lambda s=s: s.service.admission.in_flight == 0)


@pytest.fixture()
def daemons():
    """A factory of daemons closed in the fixture's finally, each after its
    admission is back at 0 in flight."""
    made = []

    def make(pkg, **cfg):
        s = (ScanServer(ServeConfig(port=0, device="cpu", **cfg)) if pkg == "port"
             else JaxServer(JaxConfig(port=0, **cfg)))
        made.append(s)
        return s.start_background()

    try:
        yield make
    finally:
        close_idle(made)


def request(server, method, path, body=None, headers=None):
    """One HTTP exchange with a hard socket timeout. Returns (status,
    headers, body bytes)."""
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
    doc = json.loads(body)
    assert set(doc) == {"error"}, doc
    assert set(doc["error"]) - {"request_id", "trace_id"} == {"code", "message", "status"}
    return doc["error"]["code"]


def same(servers, method, path, body=None, headers=None):
    """The exchange on each daemon: every status equal, every body equal;
    returns the port's (status, body)."""
    out = [request(s, method, path, body, headers) for s in servers]
    assert len({(o[0], o[2]) for o in out}) == 1, [(o[0], o[2][:300]) for o in out]
    return out[0][0], out[0][2]


# -- scans and plans -------------------------------------------------------------

SCANS = [
    {"paths": ["a.parquet", "b.parquet"]},
    {"paths": "*.parquet", "columns": ["id", "name"], "filters": [["id", ">=", ROWS_A - 5]],
     "limit": 8},
    {"paths": "*.parquet", "columns": "opt,k", "filters": [["opt", "is_null"]]},
    {"paths": "b.parquet", "filters": [[["id", "<", ROWS_A + 10]], [["name", "in", ["n3"]],
                                                                    ["k", ">", 6]]]},
    {"paths": "*.parquet", "shard": [1, 2]},
    {"paths": "*.parquet", "columns": ["v"], "shard": "0/3", "limit": 1000},
    {"paths": "*.parquet", "filters": [["id", ">", 10**9]]},
    {"paths": "a.parquet", "limit": 0},
    {"paths": ["b.parquet", "a.parquet", "*.parquet"], "columns": ["id"], "limit": 2500},
]


@pytest.mark.parametrize("body", SCANS, ids=range(len(SCANS)))
def test_scan_bodies_equal_the_reference(pair, body):
    port, ref, _ = pair
    status, raw = same((port, ref), "POST", "/v1/scan", body)
    assert status == 200
    assert raw.endswith(b"\n") or (raw == b"" and (body.get("limit") == 0 or "filters" in body))


def arrow_scan(server, body):
    """(status, Content-Type, body) of an arrow-ipc scan; a torn stream's
    partial body (a mid-stream typed error) is returned, not raised."""
    conn = http.client.HTTPConnection(server.host, server.port, timeout=WATCHDOG_S)
    try:
        conn.request("POST", "/v1/scan", body=json.dumps({**body, "format": "arrow-ipc"}).encode())
        resp = conn.getresponse()
        try:
            raw = resp.read()
        except http.client.IncompleteRead as e:
            raw = e.partial
        return resp.status, resp.getheader("Content-Type"), raw
    finally:
        conn.close()


@pytest.mark.parametrize("body", SCANS, ids=range(len(SCANS)))
def test_arrow_ipc_scans_parse_equal_the_reference(pair, body):
    """Whole, filtered, limited, sharded and empty arrow-ipc scans: 200 and
    the reference's Content-Type on both daemons; the port's body, read by
    pyarrow, equals the reference's body, and the port's own reader gives
    pyarrow's rows."""
    from parquet_tpu_torch.core import arrow_ipc

    port, ref, _ = pair
    got = [arrow_scan(s, body) for s in (port, ref)]
    assert [g[:2] for g in got] == [(200, "application/vnd.apache.arrow.stream")] * 2
    mine, want = (pa.ipc.open_stream(g[2]).read_all() for g in got)
    assert mine.equals(want)
    assert arrow_ipc.open_stream(got[0][2]).read_all().to_pylist() == want.to_pylist()
    if body.get("limit") is not None:
        assert mine.num_rows <= body["limit"]


def test_arrow_ipc_schema_mismatch_is_the_references_422(tmp_path, daemons):
    """Two files of different schemas in one arrow-ipc scan: the first
    file's batches stream, then both daemons tear the stream at the
    schema_mismatch (no end-of-stream marker), byte for byte alike."""
    pq.write_table(pa.table({"x": pa.array([1, 2], pa.int64())}), str(tmp_path / "a.parquet"))
    pq.write_table(pa.table({"x": pa.array(["p"])}), str(tmp_path / "b.parquet"))
    outs = [arrow_scan(daemons(pkg, root=str(tmp_path)), {"paths": "*.parquet"})
            for pkg in ("port", "jax")]
    assert outs[0] == outs[1]
    status, _ct, raw = outs[0]
    assert status == 200 and not raw.endswith(b"\xff\xff\xff\xff\x00\x00\x00\x00")
    first = pa.ipc.open_stream(raw + b"\xff\xff\xff\xff\x00\x00\x00\x00").read_all()
    assert first.column("x").to_pylist() == [1, 2]


def test_arrow_ipc_scan_of_a_declined_filter_is_a_typed_501(tmp_path, daemons):
    """An inexact float32 in-list member: the host mask declines it, the
    reference evaluates it with pyarrow compute (a 200), the port answers
    the host query engine's typed 501 not_ported before the stream."""
    pq.write_table(pa.table({"f": pa.array(np.arange(8, dtype=np.float32) / 4)}),
                   str(tmp_path / "f.parquet"))
    body = {"paths": "f.parquet", "filters": [["f", "in", [0.1, 0.5]]]}
    port, ref = (daemons(pkg, root=str(tmp_path)) for pkg in ("port", "jax"))
    status, _ct, raw = arrow_scan(port, body)
    assert (status, error_code(raw)) == (501, "not_ported")
    status, _ct, raw = arrow_scan(ref, body)
    assert status == 200 and pa.ipc.open_stream(raw).read_all().column("f").to_pylist() == [0.5]


PLANS = [
    ("GET", "/v1/plan?paths=a.parquet"),
    ("GET", "/v1/plan?paths=a.parquet,b.parquet&filters="
     + json.dumps([["id", "<", ROW_GROUP]]).replace(" ", "")),
    ("GET", "/v1/plan?paths=*.parquet&columns=id&columns=k&shard=1/2"),
    ("POST", {"paths": "a.parquet"}),
    ("POST", {"paths": "*.parquet", "columns": ["name"],
              "filters": [[["id", "<", 5]], [["id", ">=", ROWS_A + 1700]]]}),
]


@pytest.mark.parametrize("how", PLANS, ids=range(len(PLANS)))
def test_plan_bodies_equal_the_reference(pair, how):
    port, ref, _ = pair
    method, what = how
    if method == "GET":
        status, raw = same((port, ref), "GET", what)
    else:
        status, raw = same((port, ref), "POST", "/v1/plan", what)
    assert status == 200 and json.loads(raw)["files"] >= 1


def test_plan_get_equals_post(pair):
    port = pair[0]
    via_get = request(port, "GET", "/v1/plan?paths=a.parquet")[2]
    via_post = request(port, "POST", "/v1/plan", {"paths": "a.parquet"})[2]
    assert via_get == via_post


# -- queries ---------------------------------------------------------------------

AGGS = ["count", ["count", "opt"], ["sum", "id"], ["min", "id"], ["max", "id"], ["sum", "k"],
        ["min", "k"], ["max", "k"], ["sum", "opt"], ["min", "opt"], ["max", "opt"]]

QUERIES = [
    {"paths": "*.parquet", "aggregates": ["count"]},
    {"paths": "*.parquet", "aggregates": AGGS},
    {"paths": "*.parquet", "aggregates": AGGS,
     "filters": [["name", "in", ["n1", "n5"]], ["id", "<", 3000]]},
    {"paths": ["a.parquet"], "aggregates": ["count", ["count", "v"], ["count", "name"]],
     "filters": [["opt", "is_null"]]},
    {"paths": "*.parquet", "aggregates": [["sum", "opt"], {"op": "max", "column": "k"}],
     "filters": [[["id", "<", 100]], [["k", ">=", 7], ["opt", "not_null"]]]},
    {"paths": "*.parquet", "aggregates": AGGS, "shard": [1, 2]},
    {"paths": "*.parquet", "aggregates": AGGS, "filters": [["id", ">", 10**9]]},
]


@pytest.mark.parametrize("body", QUERIES, ids=range(len(QUERIES)))
def test_query_bodies_equal_the_reference(pair, body):
    reset_query_device_counts()
    status, raw = same(pair, "POST", "/v1/query", body)
    assert status == 200
    doc = json.loads(raw)
    decodes = body["aggregates"] != ["count"] or "filters" in body
    assert query_device_counts() == ({"device": doc["units"]} if decodes and doc["units"] else {})


@pytest.mark.parametrize("body", [
    {"paths": "*.parquet", "aggregates": ["count"], "group_by": ["name"]},
    {"paths": "*.parquet", "aggregates": [["sum", "v"]]},
    {"paths": "a.parquet", "aggregates": [["min", "name"]], "filters": [["id", "<", 5]]},
], ids=["group_by", "float_sum", "string_min"])
def test_query_outside_the_envelope_is_declined(pair, body):
    """The device declines these units, and the daemon answers them on its
    host engine (counted host_fallback), byte-equal to the reference's
    pyarrow engine."""
    reset_query_device_counts()
    status, raw = same(pair, "POST", "/v1/query", body)
    assert status == 200
    units = json.loads(raw)["units"]
    assert units >= 1
    assert query_device_counts() == {"host_fallback": units}


# -- typed errors ----------------------------------------------------------------

ERRORS = [
    ("POST", "/v1/scan", b"not json", 400, "bad_request"),
    ("POST", "/v1/scan", b'{"paths": "a.parquet", "columns": ["nope"]}', 400, "bad_columns"),
    ("POST", "/v1/scan", b'{"paths": "a.parquet", "filters": [["nope", "<", 1]]}', 400,
     "bad_request"),
    ("POST", "/v1/scan", b'{"paths": "../etc/passwd"}', 403, "path_outside_root"),
    ("POST", "/v1/scan", b'{"paths": "/etc/passwd"}', 403, "path_outside_root"),
    ("POST", "/v1/scan", b'{"paths": "missing.parquet"}', 404, "not_found"),
    ("POST", "/v1/query", b'{"paths": "a.parquet", "aggregates": [["avg", "id"]]}', 400,
     "bad_aggregates"),
    ("POST", "/v1/query", b'{"paths": "a.parquet", "aggregates": [["sum", "nope"]]}', 400,
     "bad_columns"),
    ("POST", "/v1/query", b'{"paths": "nope-*.parquet", "aggregates": ["count"]}', 404,
     "not_found"),
    ("POST", "/v1/plan", b'{"paths": "a.parquet", "limit": -1}', 400, "bad_request"),
    ("GET", "/v1/plan?columns=id", None, 400, "bad_request"),
    ("GET", "/v1/plan?paths=a.parquet&filters=nope", None, 400, "bad_filters"),
    ("POST", "/v1/append", b'{"k": 1}\n', 503, "ingest_disabled"),
    ("POST", "/v1/nope", b"{}", 404, "no_such_route"),
    ("GET", "/v1/nope", None, 404, "no_such_route"),
]


@pytest.mark.parametrize("method,path,body,status,code", ERRORS, ids=range(len(ERRORS)))
def test_typed_errors_match_the_reference(pair, method, path, body, status, code):
    port, ref, _ = pair
    out = [request(s, method, path, body, {"X-Timeout-Ms": "20000"}) for s in (port, ref)]
    for st, _h, raw in out:
        assert (st, error_code(raw)) == (status, code), raw


def test_bad_timeout_header_is_typed(pair):
    port, ref, _ = pair
    for s in (port, ref):
        st, _h, raw = request(s, "POST", "/v1/scan", {"paths": "a.parquet"},
                              {"X-Timeout-Ms": "soon"})
        assert (st, error_code(raw)) == (400, "bad_request")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_oversized_body_413_before_buffering(corpus, daemons, pkg):
    s = daemons(pkg, root=str(corpus), max_body_bytes=64)
    big = {"paths": "a.parquet", "columns": ["id", "v", "name"] * 20}
    status, _h, raw = request(s, "POST", "/v1/scan", big)
    assert status == 413 and error_code(raw) == "body_too_large"
    assert request(s, "POST", "/v1/scan", {"paths": "a.parquet", "limit": 1})[0] == 200


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_keepalive_survives_error_with_unread_body(corpus, daemons, pkg):
    # a fresh daemon: the shared ones' 5xx answers degrade their /healthz
    for s in (daemons(pkg, root=str(corpus)),):
        conn = http.client.HTTPConnection(s.host, s.port, timeout=WATCHDOG_S)
        try:
            conn.request("POST", "/v1/nope", body=json.dumps({"paths": "a.parquet"}).encode())
            resp = conn.getresponse()
            assert resp.status == 404 and error_code(resp.read()) == "no_such_route"
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["status"] == "ok"
        finally:
            conn.close()


@pytest.fixture(scope="module")
def corrupt(tmp_path_factory):
    """A corpus whose second file has the page headers of its first row
    group stomped (its footer parses)."""
    d = write_corpus(tmp_path_factory.mktemp("serve_http_corrupt"))
    raw = bytearray((d / "b.parquet").read_bytes())
    raw[4:2048] = b"\xde" * 2044
    (d / "b.parquet").write_bytes(bytes(raw))
    return d


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_corrupt_row_group_before_the_first_chunk_is_422(corrupt, daemons, pkg):
    s = daemons(pkg, root=str(corrupt))
    status, _h, raw = request(s, "POST", "/v1/scan", {"paths": "b.parquet"})
    assert (status, error_code(raw)) == (422, "unreadable_file")
    status, _h, raw = request(s, "POST", "/v1/query",
                              {"paths": "b.parquet", "aggregates": [["sum", "id"]]})
    assert (status, error_code(raw)) == (422, "unreadable_file")
    assert request(s, "POST", "/v1/scan", {"paths": "a.parquet", "limit": 1})[0] == 200


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_mid_stream_corruption_tears_the_response(corrupt, daemons, pkg):
    s = daemons(pkg, root=str(corrupt), window=1)
    reset_serve_counts()
    conn = http.client.HTTPConnection(s.host, s.port, timeout=WATCHDOG_S)
    try:
        conn.request("POST", "/v1/scan", body=json.dumps({"paths": "*.parquet"}).encode())
        resp = conn.getresponse()
        assert resp.status == 200
        with pytest.raises(http.client.IncompleteRead) as ei:
            resp.read()
        partial = ei.value.partial
    finally:
        conn.close()
    last = partial.decode().splitlines()[-1]
    assert json.loads(last)["error"]["code"] == "unreadable_file"
    assert partial.count(b"\n") == ROWS_A + 1
    if pkg == "port":
        wait_until("the abort counted",
                   lambda: serve_counts().get('events_total{event="serve_stream_aborted"}') == 1)
    assert request(s, "POST", "/v1/scan", {"paths": "a.parquet", "limit": 1})[0] == 200


# -- admission over HTTP, with gated sources --------------------------------------


class GatedSource:
    """A byte source whose reads wait for the test's gate: the
    deterministic way to hold a request in flight."""

    def __init__(self, inner, gate):
        self._inner = inner
        self._gate = gate

    @property
    def source_id(self):
        return self._inner.source_id

    def size(self):
        return self._inner.size()

    def generation(self):
        return None

    def read_at(self, offset, n):
        assert self._gate.wait(WATCHDOG_S), "test gate never opened"
        return self._inner.read_at(offset, n)

    def read_ranges(self, ranges):
        return [self.read_at(o, n) for o, n in ranges]

    def close(self):
        self._inner.close()


def gated(pkg, gate):
    local = LocalFileSource if pkg == "port" else JaxLocalSource
    return lambda p: GatedSource(local(p), gate)


def hold_one(server, body, out, path="/v1/scan"):
    """Start a request that blocks on the gate; returns its thread once the
    daemon admitted it."""

    def go():
        try:
            out["resp"] = request(server, "POST", path, body)
        except Exception as e:  # noqa: BLE001 - asserted by the caller
            out["error"] = e

    t = threading.Thread(target=go)
    t.start()
    wait_until("the held request admitted", lambda: server.service.admission.in_flight >= 1)
    return t


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_queue_full_429_then_recovers(corpus, daemons, pkg):
    gate = threading.Event()
    s = daemons(pkg, root=str(corpus), cache_mb=0, max_inflight=1,
                source_factory=gated(pkg, gate))
    out: dict = {}
    t = hold_one(s, {"paths": "a.parquet"}, out)
    try:
        status, headers, raw = request(s, "POST", "/v1/scan", {"paths": "a.parquet"})
        assert status == 429 and error_code(raw) == "queue_full"
        assert headers["Retry-After"] == "1"
    finally:
        gate.set()
        t.join(WATCHDOG_S)
    assert not t.is_alive() and "error" not in out and out["resp"][0] == 200
    assert request(s, "POST", "/v1/scan", {"paths": "a.parquet", "limit": 3})[0] == 200


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_tenant_budget_exhaustion_429(corpus, daemons, pkg):
    s = daemons(pkg, root=str(corpus), tenant_budget_mb=1, budget_window_s=3600.0)
    est = json.loads(request(s, "GET", "/v1/plan?paths=a.parquet")[2])["estimated_bytes"]
    assert est > 0
    for _ in range((1 << 20) // est + 2):
        status, _h, raw = request(s, "POST", "/v1/scan", {"paths": "a.parquet", "limit": 1},
                                  {"X-Tenant": "alice"})
        if status != 200:
            break
    assert status == 429 and error_code(raw) == "tenant_over_budget"
    assert request(s, "POST", "/v1/scan", {"paths": "a.parquet", "limit": 1},
                   {"X-Tenant": "bob"})[0] == 200


def test_port_budget_counts_the_query_estimate(corpus, daemons):
    s = daemons("port", root=str(corpus), tenant_budget_mb=1, budget_window_s=3600.0)
    body = {"paths": "*.parquet", "aggregates": AGGS}
    est = json.loads(request(s, "POST", "/v1/plan", {"paths": "*.parquet",
                                                     "columns": ["id", "opt", "k"]})[2])
    n = (1 << 20) // est["estimated_bytes"] + 2
    statuses = [request(s, "POST", "/v1/query", body, {"X-Tenant": "t"})[0] for _ in range(n)]
    assert statuses[0] == 200 and statuses[-1] == 429


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_deadline_expiry_mid_scan_leaves_daemon_healthy(corpus, daemons, pkg):
    gate = threading.Event()
    s = daemons(pkg, root=str(corpus), cache_mb=0, source_factory=gated(pkg, gate))
    try:
        # the gate stays shut: the unit cannot finish before the deadline
        status, _h, raw = request(s, "POST", "/v1/scan", {"paths": "*.parquet"},
                                  {"X-Timeout-Ms": "150"})
        assert status == 504 and error_code(raw) == "deadline_exceeded"
        status, _h, raw = request(s, "POST", "/v1/query", {"paths": "*.parquet",
                                                          "aggregates": [["sum", "id"]]},
                                  {"X-Timeout-Ms": "150"})
        assert status == 504 and error_code(raw) == "deadline_exceeded"
        assert request(s, "GET", "/healthz")[0] == 200
    finally:
        gate.set()
    status, _h, raw = request(s, "POST", "/v1/scan", {"paths": "a.parquet", "limit": 2})
    assert status == 200 and raw.count(b"\n") == 2


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_drain_completes_the_request_in_flight(corpus, daemons, pkg):
    gate = threading.Event()
    s = daemons(pkg, root=str(corpus), cache_mb=0, source_factory=gated(pkg, gate))
    want = request(daemons(pkg, root=str(corpus)), "POST", "/v1/scan",
                   {"paths": "a.parquet"})[2]
    out: dict = {}
    t = hold_one(s, {"paths": "a.parquet"}, out)
    drained: dict = {}
    d = threading.Thread(target=lambda: drained.setdefault("ok", s.drain(WATCHDOG_S)))
    try:
        d.start()
        wait_until("draining", lambda: s.service.admission.draining)
        status, _h, raw = request(s, "POST", "/v1/scan", {"paths": "a.parquet"})
        assert status == 503 and error_code(raw) == "draining"
        status, headers, raw = request(s, "GET", "/healthz")
        doc = json.loads(raw)
        assert status == 503 and doc["status"] == "draining"
        assert doc["retry_after_s"] == 2 and headers["Retry-After"] == "2"
    finally:
        gate.set()
        t.join(WATCHDOG_S)
        d.join(WATCHDOG_S)
    assert not t.is_alive() and not d.is_alive() and "error" not in out
    assert out["resp"][0] == 200 and out["resp"][2] == want
    assert drained["ok"] is True
    if pkg == "port":
        assert serve_counts().get('serve_drains_total{drained="true"}', 0) >= 1


def test_concurrent_clients_get_identical_bodies(pair):
    port, ref, _ = pair
    scan = {"paths": "*.parquet", "columns": ["id", "opt"], "filters": [["k", "<", 4]]}
    query = QUERIES[2]
    want = {"/v1/scan": request(ref, "POST", "/v1/scan", scan)[2],
            "/v1/query": request(ref, "POST", "/v1/query", query)[2]}
    results: list = []
    errors: list = []
    lock = threading.Lock()

    def client(i):
        try:
            for path, body in (("/v1/scan", scan), ("/v1/query", query)):
                st, _h, raw = request(port, "POST", path, body, {"X-Tenant": f"t{i % 4}"})
                with lock:
                    results.append((path, st, raw))
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WATCHDOG_S)
        assert not t.is_alive(), "a client thread hung"
    assert not errors and len(results) == 16
    for path, st, raw in results:
        assert st == 200 and raw == want[path]


# -- /v1/append ------------------------------------------------------------------


@pytest.fixture()
def lakes(tmp_path, daemons):
    """(port, reference) daemons, each over a lake table of its own."""
    out = []
    for pkg in ("port", "jax"):
        root = tmp_path / pkg
        root.mkdir()
        out.append(daemons(pkg, root=str(root), lake_root=str(root / "tbl"),
                           lake_schema=LAKE_SCHEMA, lake_sort_key="k", max_append_bytes=4096))
    return out


def append(server, body, *, content_type="application/x-ndjson", flush=False):
    status, _h, raw = request(server, "POST", "/v1/append" + ("?flush=1" if flush else ""),
                              body, {"Content-Type": content_type})
    return status, json.loads(raw)


def test_append_acks_equal_the_reference(lakes):
    steps = [(b'{"k": 1, "v": "a"}\n{"k": 2, "v": "b"}\n', False), (b'{"k": 3}\n', True),
             (b'{"k": 0, "v": null}\n', False), (b'\n{"k": 9, "v": "z"}\n\n', True)]
    acks = [[append(s, body, flush=flush) for body, flush in steps] for s in lakes]
    assert acks[0] == acks[1]
    assert [a[1]["generation"] for a in acks[0]] == [None, 1, 1, 2]
    assert acks[0][1][1]["flushed"] is True and acks[0][0][1]["flushed"] is False


def test_append_typed_errors_equal_the_reference(lakes):
    cases = [
        (b"k,v\n1,a\n", "text/csv", 415, "unsupported_format"),
        (b"not json\n", "application/x-ndjson", 400, "bad_payload"),
        (b"[1, 2]\n", "application/x-ndjson", 400, "bad_payload"),
        (b"", "application/x-ndjson", 400, "bad_request"),
        (b'{"k": "not-an-int"}\n', "application/x-ndjson", 422, "bad_rows"),
        (b'{"k": 1}\n' * 1000, "application/x-ndjson", 413, "body_too_large"),
    ]
    for body, ct, want_status, want_code in cases:
        got = [append(s, body, content_type=ct, flush=True) for s in lakes]
        for status, doc in got:
            assert (status, doc["error"]["code"]) == (want_status, want_code), (body, doc)


def test_daemon_query_of_the_table_equals_the_reference(lakes):
    lines = b"".join(json.dumps({"k": i, "v": f"v{i}"}).encode() + b"\n"
                     for i in (5, 3, 1, 4, 2, 40, -7))
    for s in lakes:
        assert append(s, lines, flush=True)[0] == 200
    body = {"paths": ["tbl"], "aggregates": ["count", ["sum", "k"], ["min", "k"], ["max", "k"],
                                             ["count", "v"]]}
    status, raw = same(lakes, "POST", "/v1/query", body)
    assert status == 200 and json.loads(raw)["result"]["sum(k)"] == 48
    status, raw = same(lakes, "POST", "/v1/scan", {"paths": ["tbl"]})
    assert [json.loads(ln)["k"] for ln in raw.splitlines()] == [-7, 1, 2, 3, 4, 5, 40]


def test_arrow_ipc_append_is_a_415(lakes):
    """Once the port's cut (a 415), now parity: an arrow-ipc append body
    (pyarrow's stream, and the port's writer's) commits the reference's
    ack and rows on both daemons."""
    from parquet_tpu_torch.core import arrow_format as paf
    from parquet_tpu_torch.core import arrow_ipc

    table = pa.table({"k": [7, 8], "v": ["x", None]})
    import io as _io

    buf = _io.BytesIO()
    with pa.ipc.new_stream(buf, table.schema) as wr:
        wr.write_table(table)
    ct = "application/vnd.apache.arrow.stream"
    assert same(lakes, "POST", "/v1/append?flush=1", buf.getvalue(),
                {"Content-Type": ct})[0] == 200
    ours = paf.table({"k": paf.array(np.array([1, 9])),
                      "v": paf.array([b"p", None], paf.binary(1))})
    status, raw = same(lakes, "POST", "/v1/append?flush=1", arrow_ipc.serialize_table(ours),
                       {"Content-Type": ct})
    assert status == 200 and json.loads(raw)["generation"] == 2
    status, raw = same(lakes, "POST", "/v1/scan", {"paths": ["tbl"]})
    assert [json.loads(ln) for ln in raw.splitlines()] == [
        {"k": 7, "v": "x"}, {"k": 8, "v": None}, {"k": 1, "v": "p"}, {"k": 9, "v": None}]
    for s in lakes:  # the message is each parser's own
        status, _h, raw = request(s, "POST", "/v1/append", b"\xff\xff\xff\xff\x10\x00",
                                  {"Content-Type": ct})
        assert (status, error_code(raw)) == (400, "bad_payload")


def test_close_commits_the_ingest_tail(tmp_path):
    from parquet_tpu_torch.lake.manifest import LakeTable

    cfg = ServeConfig(port=0, root=str(tmp_path), lake_root=str(tmp_path / "tbl"),
                      lake_schema=LAKE_SCHEMA, lake_sort_key="k", device="cpu")
    with ScanServer(cfg) as s:
        s.start_background()
        status, ack = append(s, b'{"k": 1}\n')
        assert status == 200 and ack["flushed"] is False
        wait_until("in flight back to 0", lambda: s.service.admission.in_flight == 0)
    assert LakeTable.open(str(tmp_path / "tbl")).manifest.open_snapshot().total_rows == 1


# -- the port's own answers --------------------------------------------------------


def test_arrow_ipc_scan_is_refused_before_admission(corpus, daemons):
    """Once the port's cut (a 501 before admission), now parity: an
    arrow-ipc scan goes through admission like a jsonl one (a draining
    daemon answers both daemons' 503), then answers 200 with the
    reference's Content-Type and a body that parses equal to the
    reference's."""
    servers = [daemons("port", root=str(corpus)), daemons("jax", root=str(corpus))]
    body = {"paths": "a.parquet", "format": "arrow-ipc"}
    got = [request(s, "POST", "/v1/scan", body) for s in servers]
    assert [g[0] for g in got] == [200, 200]
    assert {g[1]["Content-Type"] for g in got} == {"application/vnd.apache.arrow.stream"}
    tables = [pa.ipc.open_stream(g[2]).read_all() for g in got]
    assert tables[0].equals(tables[1]) and tables[0].num_rows == ROWS_A
    reset_serve_counts()
    for s in servers:
        s.service.admission.begin_drain()
    out = [request(s, "POST", "/v1/scan", body) for s in servers]
    assert [(o[0], error_code(o[2])) for o in out] == [(503, "draining")] * 2


@pytest.mark.parametrize("route,module", [
    ("/v1/debug/requests", "obs.recorder"),
    ("/v1/debug/requests/abc", "obs.recorder"),
    ("/v1/debug/requests/abc/trace", "obs.recorder"),
    ("/v1/debug/profile?seconds=1", "obs.prof"),
    ("/v1/debug/tenants", "obs.cost"),
    ("/v1/debug/fleet?peers=127.0.0.1:1", "obs.fleet"),
])
def test_cut_debug_routes_are_501(pair, route, module):
    """Each debug route the reference serves answers as the reference's
    does (the obs `module` behind it): the same status and content type,
    and for JSON the same keys (an error's code too). The profile route
    runs one window at a time, so the two daemons take it in turn."""
    got = request(pair[0], "GET", route)
    want = request(pair[1], "GET", route)
    assert got[0] == want[0] and got[0] != 501, (module, got[0], got[2][:200])
    assert got[1]["Content-Type"] == want[1]["Content-Type"]
    if got[1]["Content-Type"].startswith("application/json"):
        a, b = json.loads(got[2]), json.loads(want[2])
        assert set(a) == set(b)
        if "error" in a:
            assert error_code(got[2]) == error_code(want[2])
            assert set(a["error"]) == set(b["error"])
        elif "requests" in a:
            assert all(set(r) == set(want_r) for r in a["requests"]
                       for want_r in b["requests"][:1])
        else:
            assert set(a["totals"]) == set(b["totals"])
    else:
        assert route.startswith("/v1/debug/profile") and got[0] == 200


def test_metrics_are_counters_in_the_classic_text_format(corpus, daemons):
    """/metrics is the process registry's exposition: the serve counters
    among its counter families, gauges and histograms beside them, and the
    OpenMetrics variant (exemplars, # EOF) for a scraper that asks. The
    registry is the process's, so each counter is read as its growth over
    the three requests, in both formats."""
    s = daemons("port", root=str(corpus))
    reset_serve_counts()
    reset_query_device_counts()
    formats = (None, "application/openmetrics-text; version=1.0.0")

    def scrape(accept):
        status, headers, raw = request(s, "GET", "/metrics",
                                       headers={"Accept": accept} if accept else None)
        assert status == 200
        lines = raw.decode().splitlines()
        samples = dict(ln.split(" # ")[0].rsplit(" ", 1) for ln in lines if not ln.startswith("#"))
        return headers, lines, samples

    before = {accept: scrape(accept)[2] for accept in formats}
    assert request(s, "POST", "/v1/scan", {"paths": "a.parquet", "limit": 3})[0] == 200
    assert request(s, "POST", "/v1/query", {"paths": "a.parquet",
                                            "aggregates": [["sum", "id"]]})[0] == 200
    # the device declines a string sum and the host engine refuses it: a
    # 400 bad_aggregates, its unit counted host_fallback
    assert request(s, "POST", "/v1/query", {"paths": "a.parquet",
                                            "aggregates": [["sum", "name"]]})[0] == 400
    wait_until("the requests counted", lambda: sum(
        v for k, v in serve_counts().items() if k.startswith("serve_requests_total")) == 3)
    for accept in formats:
        headers, lines, samples = scrape(accept)

        def grew(key):
            key = "parquet_tpu_" + key
            return int(samples[key]) - int(before[accept].get(key, "0"))

        assert grew('serve_requests_total{status="200",tenant="default"}') == 2
        assert grew('serve_requests_total{status="400",tenant="default"}') == 1
        assert grew("serve_scan_bytes_total") > 0
        assert grew("serve_aggregate_requests_total") == 1
        assert grew('query_device_units_total{engine="device"}') == 3
        assert grew('query_device_units_total{engine="host_fallback"}') >= 1
        types = {ln.split()[2]: ln.split()[-1] for ln in lines if ln.startswith("# TYPE")}
        assert {"counter", "gauge", "histogram"} <= set(types.values())
        if accept is None:
            assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
            assert types["parquet_tpu_serve_requests_total"] == "counter"
            assert "# EOF" not in lines and any("_bucket" in ln for ln in lines)
        else:
            assert headers["Content-Type"].startswith("application/openmetrics-text")
            assert types["parquet_tpu_serve_requests"] == "counter"
            assert lines[-1] == "# EOF"
            assert any('# {request_id="' in ln for ln in lines
                       if ln.startswith("parquet_tpu_serve_request_seconds_bucket"))


def test_tenant_labels_are_escaped(corpus, daemons):
    s = daemons("port", root=str(corpus))
    reset_serve_counts()
    request(s, "GET", "/v1/plan?paths=a.parquet", headers={"X-Tenant": 'a"b\\c'})
    wait_until("counted", lambda: serve_counts())
    assert 'serve_requests_total{status="200",tenant="a\\"b\\\\c"}' in serve_counts()


def test_debug_vars_keys_are_the_reference_without_obs_and_process(pair, monkeypatch):
    port, ref, _ = pair
    # the port lists only the pool variables it reads; PQT_IO_THREADS and
    # PQT_SERVE_THREADS size nothing in it, so they are never listed
    monkeypatch.setenv("PQT_HOST_THREADS", "3")
    monkeypatch.setenv("PQT_IO_THREADS", "5")
    monkeypatch.setenv("PQT_SERVE_THREADS", "2")
    monkeypatch.delenv("PQT_DATA_THREADS", raising=False)
    got = json.loads(request(port, "GET", "/v1/debug/vars")[2])
    want = json.loads(request(ref, "GET", "/v1/debug/vars")[2])
    assert set(got) == set(want)
    assert got["obs"] == want["obs"]
    assert set(got["process"]) == set(want["process"])
    assert got["version"] == "0.1.0"
    assert set(got["serve"]) == set(want["serve"])
    assert set(got["pools"]) == set(want["pools"]) | {"sizes"}
    assert got["pools"]["env"] == {"PQT_HOST_THREADS": "3"}
    assert got["pools"]["sizes"] == {
        "pqt-serve": min(8, os.cpu_count() or 4),
        "pqt-host": 3,
        "pqt-io": min(os.cpu_count() or 1, 8),
    }
    assert pexecutor.serve_pool()._max_workers == got["pools"]["sizes"]["pqt-serve"]
    assert pplanner.io_pool()._max_workers == got["pools"]["sizes"]["pqt-io"]
    assert got["resilience"] == want["resilience"]
    assert got["pools"]["depths"]["pqt-serve"] == {"queued": 0, "active": 0}


def test_healthz_and_slo_bodies_match_the_reference(corpus, daemons):
    port, ref = daemons("port", root=str(corpus)), daemons("jax", root=str(corpus))
    for path in ("/healthz", "/v1/debug/slo"):
        got = request(port, "GET", path)
        want = request(ref, "GET", path)
        assert got[0] == want[0] == 200
        a, b = json.loads(got[2]), json.loads(want[2])
        if path == "/healthz":
            assert set(a) == set(b) and a["status"] == "ok"
        else:
            assert set(a) == set(b) and a["objective"] == b["objective"]


def test_request_ids_are_echoed_and_minted(pair):
    port = pair[0]
    status, headers, raw = request(port, "POST", "/v1/scan", {"paths": "nope.parquet"},
                                   {"X-Request-Id": "abc def/1"})
    assert status == 404 and headers["X-Request-Id"] == "abc_def_1"
    assert json.loads(raw)["error"]["request_id"] == "abc_def_1"
    # no inbound traceparent: a fresh one, echoed, its trace id in the body
    tp = headers["traceparent"]
    assert re.fullmatch(r"00-[0-9a-f]{32}-[0-9a-f]{16}-01", tp)
    assert json.loads(raw)["error"]["trace_id"] == tp.split("-")[1]
    inbound = "00-" + "1" * 32 + "-" + "2" * 16 + "-01"
    status, headers, _raw = request(port, "POST", "/v1/plan", {"paths": "a.parquet"},
                                    {"traceparent": inbound})
    assert status == 200 and len(headers["X-Request-Id"]) == 16
    # adopted: the caller's trace id, the daemon's own span id
    echoed = headers["traceparent"].split("-")
    assert echoed[1] == "1" * 32 and echoed[2] != "2" * 16 and echoed[3] == "01"
    assert "X-Request-Id" not in request(port, "GET", "/healthz")[1]


def test_internal_bugs_render_typed_500(corpus, daemons):
    s = daemons("port", root=str(corpus))
    reset_serve_counts()

    def boom(request):
        raise RuntimeError("wat")

    s.service.session.plan = boom
    status, _h, raw = request(s, "POST", "/v1/scan", {"paths": "a.parquet"})
    assert status == 500 and error_code(raw) == "internal" and b"Traceback" not in raw
    key = 'serve_requests_total{status="500",tenant="default"}'
    wait_until("counted", lambda: serve_counts().get(key) == 1)
    assert [k for k in serve_counts() if k.startswith("serve_requests_total")] == [key]


def test_slow_requests_are_counted(corpus, daemons):
    s = daemons("port", root=str(corpus), slow_ms=1e-6)
    reset_serve_counts()
    assert request(s, "POST", "/v1/plan", {"paths": "a.parquet"})[0] == 200
    key = 'serve_slow_requests_total{endpoint="/v1/plan"}'
    wait_until("counted", lambda: serve_counts().get(key) == 1)
