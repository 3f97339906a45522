"""The port's trace propagation and fleet federation (obs/propagate.py,
obs/fleet.py) against the reference's, the counterpart of the propagation
classes of tests/test_mesh.py (TestTraceparent, TestTraceMerge,
TestFederationExactness, TestServePropagation, TestServeFleet,
TestRoutedTraceMerge, TestLaneCoverage, TestScopeAcrossPools).

Pinned on the CPU:

  * traceparent: the same headers parse (or are refused) alike, the wire
    format and the inbound outcomes (accepted / minted / invalid) are the
    reference's, an outbound header exists only inside a scope;
  * merges: merge_chrome_traces and merge_expositions of the same
    documents are equal, refusals included; expositions rendered by each
    package's registry from the same calls parse and merge alike;
  * daemons: a port daemon reading through a remote map sends the
    client's trace id on every range GET to the stub (a fresh span each),
    echoes it, and keeps it in its flight record; an error body carries
    it; an invalid header is replaced, never echoed;
  * the router: a client trace id rides every router-to-replica hop (the
    FlakyReplica wire tap records them), lands in the router's and the
    replica's records, and `trace-merge` stitches both documents;
  * /v1/debug/fleet and `debug --fleet` over two port daemons sum each
    counter to the replicas' own;
  * every pqt-* thread name the port's package spawns maps to a named
    profiler lane; the propagation scope rides a pqt-io hop.

Every daemon binds port 0 and closes in a finally. Tolerance: exact.
"""

from __future__ import annotations

import http.client
import json
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

from parquet_tpu.obs import fleet as jfleet  # noqa: E402
from parquet_tpu.obs import propagate as jprop  # noqa: E402
from parquet_tpu.utils import metrics as jmetrics  # noqa: E402

from parquet_tpu_torch.obs import fleet as pfleet  # noqa: E402
from parquet_tpu_torch.obs import propagate as pprop  # noqa: E402
from parquet_tpu_torch.obs.prof import lane_of  # noqa: E402
from parquet_tpu_torch.serve import ScanServer, ServeConfig  # noqa: E402
from parquet_tpu_torch.testing.httpstub import RangeHttpStub  # noqa: E402
from parquet_tpu_torch.tools.parquet_tool import main as tool_main  # noqa: E402
from parquet_tpu_torch.utils import metrics as pmetrics  # noqa: E402

CLIENT_TID = "ab" * 16
CLIENT_TP = "00-" + CLIENT_TID + "-" + "cd" * 8 + "-01"
TIMEOUT_S = 60


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("propagate_corpus")
    n = 3000
    pq.write_table(pa.table({"id": np.arange(n, dtype=np.int64),
                             "v": np.arange(n, dtype=np.float64)}),
                   str(d / "a.parquet"), row_group_size=1000)
    return d


def request(server, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=TIMEOUT_S)
    try:
        data = json.dumps(body).encode() if isinstance(body, dict) else body
        hdrs = dict(headers or {})
        if data is not None:
            hdrs.setdefault("Content-Type", "application/json")
        conn.request(method, path, body=data, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


# -- traceparent ---------------------------------------------------------------------

HEADERS = [
    None, "", "not-a-header", CLIENT_TP,
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "A" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "01-" + "a" * 32 + "-" + "b" * 16 + "-00",
    "  " + CLIENT_TP + "  ",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01-extra" + "x" * 200,
]


@pytest.mark.parametrize("raw", HEADERS)
def test_traceparents_parse_alike(raw):
    got, want = pprop.parse_traceparent(raw), jprop.parse_traceparent(raw)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id, got.flags, got.header()) == (
            want.trace_id, want.span_id, want.flags, want.header())
    a, ra = pprop.resolve_inbound(raw)
    b, rb = jprop.resolve_inbound(raw)
    assert ra == rb
    assert re.fullmatch(r"00-[0-9a-f]{32}-[0-9a-f]{16}-[0-9a-f]{2}", a.header())
    if ra == "accepted":
        assert a.trace_id == b.trace_id == got.trace_id and a.span_id != got.span_id


def test_outbound_needs_a_scope_and_a_child_each_call():
    for prop in (pprop, jprop):
        assert prop.outbound_traceparent("get") is None
        ctx = prop.mint()
        with prop.propagation_scope(ctx):
            sent = [prop.parse_traceparent(prop.outbound_traceparent("get")) for _ in range(3)]
            assert prop.current_context() is ctx
        assert {s.trace_id for s in sent} == {ctx.trace_id}
        assert len({s.span_id for s in sent} | {ctx.span_id}) == 4
        assert prop.outbound_traceparent("get") is None


def test_the_scope_rides_a_pqt_io_hop():
    from parquet_tpu_torch.io.planner import io_pool
    from parquet_tpu_torch.obs.pool import instrumented_submit

    ctx = pprop.mint()
    with pprop.propagation_scope(ctx):
        sent = instrumented_submit(io_pool(), pprop.outbound_traceparent, "get",
                                   pool="pqt-io").result(TIMEOUT_S)
    assert pprop.parse_traceparent(sent).trace_id == ctx.trace_id


# -- merges --------------------------------------------------------------------------


def _doc(trace_id, endpoint, pid=9, n=1):
    other = {"request": {"endpoint": endpoint}}
    if trace_id is not None:
        other["propagation"] = {"trace_id": trace_id}
    return {"traceEvents": [{"ph": "X", "name": f"s{i}", "pid": pid, "tid": 1, "ts": i,
                             "dur": 2} for i in range(n)],
            "otherData": other}


MERGES = {
    "shared_id": ([_doc(CLIENT_TID, "scan"), _doc(CLIENT_TID, "put", n=3)], None),
    "labels": ([_doc(CLIENT_TID, "scan"), _doc(None, "remote")], ["router", "replica"]),
    "no_endpoint": ([{"traceEvents": [], "otherData": {}}, _doc(None, "x")], None),
    "distinct_ids": ([_doc("ab" * 16, "a"), _doc("cd" * 16, "b")], None),
    "not_a_document": ([{"events": []}], None),
    "empty": ([], None),
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_chrome_merges_equal(case):
    docs, labels = MERGES[case]
    out = []
    for prop in (pprop, jprop):
        try:
            out.append(("ok", prop.merge_chrome_traces(json.loads(json.dumps(docs)), labels)))
        except ValueError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]


REP_A = """\
# HELP parquet_tpu_demo_total demo counter
# TYPE parquet_tpu_demo_total counter
parquet_tpu_demo_total{op="read"} 3
parquet_tpu_demo_total{op="write"} 10
# TYPE parquet_tpu_up gauge
parquet_tpu_up 1
# TYPE parquet_tpu_lat_seconds histogram
parquet_tpu_lat_seconds_bucket{le="0.1"} 2
parquet_tpu_lat_seconds_bucket{le="+Inf"} 3
parquet_tpu_lat_seconds_sum 0.5
parquet_tpu_lat_seconds_count 3
"""

REP_B = """\
# TYPE parquet_tpu_demo_total counter
parquet_tpu_demo_total{op="read"} 4
# TYPE parquet_tpu_up gauge
parquet_tpu_up 1
# TYPE parquet_tpu_lat_seconds histogram
parquet_tpu_lat_seconds_bucket{le="0.1"} 5
parquet_tpu_lat_seconds_bucket{le="+Inf"} 6
parquet_tpu_lat_seconds_sum 1.25
parquet_tpu_lat_seconds_count 6
"""


def registry_text(mod, seed: int, openmetrics: bool) -> str:
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(seed)
    for i in range(30):
        reg.inc("serve_requests_total", int(rng.integers(1, 4)), status=str(200 + i % 3),
                tenant="t")
        reg.observe("serve_request_seconds", float(rng.random()),
                    {"request_id": f"r{i}"} if i % 4 == 0 else None, endpoint="/v1/scan")
        reg.set("io_cache_bytes", int(rng.integers(0, 1000)))
    return reg.render_openmetrics() if openmetrics else reg.render_prometheus()


EXPOSITIONS = {
    "handwritten": lambda mod: [REP_A, REP_B],
    "skew": lambda mod: [REP_A, REP_B.replace("# TYPE parquet_tpu_up gauge",
                                              "# TYPE parquet_tpu_up counter")],
    "registries": lambda mod: [registry_text(mod, s, False) for s in (1, 2, 3)],
    "openmetrics": lambda mod: [registry_text(mod, s, True) for s in (4, 5)],
    "self_merge": lambda mod: [registry_text(mod, 9, False)] * 2,
}


@pytest.mark.parametrize("case", sorted(EXPOSITIONS))
def test_exposition_merges_equal(case, monkeypatch):
    monkeypatch.setattr(pmetrics.time, "time", lambda: 1_750_000_000.5)
    monkeypatch.setattr(jmetrics.time, "time", lambda: 1_750_000_000.5)
    out = []
    for fleet, mod in ((pfleet, pmetrics), (jfleet, jmetrics)):
        texts = EXPOSITIONS[case](mod)
        replicas = [f"r{i}" for i in range(len(texts))]
        try:
            parsed = {k: (f.kind, f.help, f.samples)
                      for k, f in fleet.parse_exposition(texts[0]).items()}
            out.append(("ok", parsed, fleet.merge_expositions(texts, replicas)))
        except ValueError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]


@pytest.mark.parametrize("peer", ["127.0.0.1:8080", "http://h:1/metrics", "https://h:1/",
                                  "h:2/other"])
def test_peers_normalize_alike(peer):
    assert pfleet.normalize_peer(peer) == jfleet.normalize_peer(peer)


# -- daemons -------------------------------------------------------------------------


def remote_server(stub, corpus):
    return ScanServer(ServeConfig(port=0, root=str(corpus), remote_map={"warm": stub.base_url},
                                  trace_sample_rate=1.0, device="cpu"))


def test_traceparent_rides_remote_gets_and_the_response(corpus):
    data = (corpus / "a.parquet").read_bytes()
    with RangeHttpStub(files={"a.parquet": data}) as stub:
        server = remote_server(stub, corpus).start_background()
        try:
            status, headers, body = request(server, "POST", "/v1/scan",
                                            {"paths": "warm/a.parquet", "columns": ["id"]},
                                            {"traceparent": CLIENT_TP})
            assert status == 200, body
            echoed = pprop.parse_traceparent(headers["traceparent"])
            assert echoed.trace_id == CLIENT_TID and echoed.span_id != "cd" * 8
            assert stub.traceparents
            sent = [pprop.parse_traceparent(raw) for raw in stub.traceparents]
            assert {s.trace_id for s in sent} == {CLIENT_TID}
            assert len({s.span_id for s in sent}) == len(sent)
            rid = headers["X-Request-Id"]
            record = json.loads(request(server, "GET", f"/v1/debug/requests/{rid}")[2])
            assert record["trace_id"] == CLIENT_TID
            doc = json.loads(request(server, "GET", f"/v1/debug/requests/{rid}/trace")[2])
            assert doc["otherData"]["propagation"]["trace_id"] == CLIENT_TID
            assert "remote.get" in {e.get("name") for e in doc["traceEvents"]}
        finally:
            server.close()


def test_error_bodies_carry_the_trace_id_and_bad_headers_are_replaced(corpus):
    server = ScanServer(ServeConfig(port=0, root=str(corpus), device="cpu")).start_background()
    try:
        status, _h, body = request(server, "POST", "/v1/scan", {"paths": "../escape.parquet"},
                                   {"traceparent": CLIENT_TP})
        assert status == 403 and json.loads(body)["error"]["trace_id"] == CLIENT_TID
        evil = "00-" + "zz" * 16 + "-" + "ab" * 8 + "-01 X-Inject: 1"
        status, headers, _ = request(server, "POST", "/v1/scan",
                                     {"paths": "a.parquet", "limit": 1}, {"traceparent": evil})
        minted = pprop.parse_traceparent(headers["traceparent"])
        assert status == 200 and minted.trace_id != "zz" * 16 and "X-Inject" not in headers
    finally:
        server.close()


def test_fleet_view_sums_the_replicas(corpus):
    servers = [ScanServer(ServeConfig(port=0, root=str(corpus), device="cpu")).start_background()
               for _ in range(2)]
    try:
        for s in servers:
            assert request(s, "POST", "/v1/scan", {"paths": "a.parquet", "limit": 2})[0] == 200
        peers = ",".join(f"{s.host}:{s.port}" for s in servers)
        status, headers, body = request(servers[0], "GET", f"/v1/debug/fleet?peers={peers}")
        assert status == 200 and headers["Content-Type"].startswith("text/plain")
        merged = body.decode()
        assert merged.startswith("# fleet: merged 2 replica(s)")
        fams = pfleet.parse_exposition(merged)
        key = ("parquet_tpu_serve_requests_total", (("status", "200"), ("tenant", "default")))
        # one process: both daemons render the same registry, so the merge
        # is the sample doubled at least (later scrapes see more requests)
        own = pfleet.parse_exposition(request(servers[1], "GET", "/metrics")[2].decode())
        assert fams[key[0]].samples[key] >= own[key[0]].samples[key] > 0
        uptimes = re.findall(r'parquet_tpu_process_uptime_seconds\{replica="([^"]+)"\}', merged)
        assert len(set(uptimes)) == 2
        status, _h, body = request(servers[0], "GET", "/v1/debug/fleet")
        assert status == 400 and json.loads(body)["error"]["code"] == "bad_request"
        status, _h, body = request(servers[0], "GET", "/v1/debug/fleet?peers=127.0.0.1:1")
        assert status == 502 and json.loads(body)["error"]["code"] == "fleet_unreachable"
    finally:
        for s in servers:
            s.close()
    assert tool_main(["debug", "--fleet", "127.0.0.1:1"]) == 1


def test_router_hops_stitch_into_one_timeline(corpus, tmp_path):
    from parquet_tpu_torch.serve.mesh import MeshConfig, MeshRouter
    from parquet_tpu_torch.testing.flaky_replica import FlakyReplica

    # both replicas behind a clean wire tap: the ring may send every unit
    # to one of them
    backends = [ScanServer(ServeConfig(port=0, root=str(corpus), device="cpu")).start_background()
                for _ in range(2)]
    proxies = [FlakyReplica(b.url, seed=0).start() for b in backends]
    router = MeshRouter(MeshConfig(port=0, replicas=tuple(p.url for p in proxies),
                                   trace_sample_rate=1.0)).start_background()
    try:
        status, headers, body = request(router, "POST", "/v1/scan", {"paths": "a.parquet"},
                                        {"traceparent": CLIENT_TP})
        assert status == 200, body
        assert pprop.parse_traceparent(headers["traceparent"]).trace_id == CLIENT_TID
        rid_router = headers["X-Request-Id"]
        hops = [pprop.parse_traceparent(raw) for p in proxies for raw in p.traceparents]
        assert hops
        assert {h.trace_id for h in hops} == {CLIENT_TID}
        assert len({h.span_id for h in hops}) == len(hops)
        listed = json.loads(request(router, "GET", "/v1/debug/requests")[2])["requests"]
        rids = [r["id"] for r in listed if r.get("trace_id") == CLIENT_TID]
        rid_replica = next(r for r in rids if r != rid_router)
        paths = []
        for rid in (rid_router, rid_replica):
            doc = json.loads(request(router, "GET", f"/v1/debug/requests/{rid}/trace")[2])
            assert doc["otherData"]["propagation"]["trace_id"] == CLIENT_TID
            paths.append(tmp_path / f"{rid}.json")
            paths[-1].write_text(json.dumps(doc))
        out = tmp_path / "merged.json"
        assert tool_main(["trace-merge", *map(str, paths), "-o", str(out)]) == 0
        merged = json.loads(out.read_text())
        assert merged["otherData"]["propagation"]["trace_id"] == CLIENT_TID
        assert {e["pid"] for e in merged["traceEvents"]} == {0, 1}
    finally:
        for s in (router, *proxies, *backends):
            s.close()


def test_every_pool_of_the_port_has_a_named_lane():
    pkg = Path(__file__).resolve().parent.parent / "parquet_tpu_torch"
    pat = re.compile(r"(?:thread_)?name(?:_prefix)?=f?\"(pqt-[a-z-]+)")
    prefixes = set()
    for path in pkg.rglob("*.py"):
        prefixes.update(pat.findall(path.read_text()))
    assert {"pqt-host", "pqt-dispatch", "pqt-io", "pqt-serve", "pqt-mesh"} <= prefixes
    for prefix in sorted(prefixes):
        assert lane_of(f"{prefix}_0") != "other", prefix
        assert lane_of(prefix) != "other", prefix
