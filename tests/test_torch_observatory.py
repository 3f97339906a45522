"""The port's daemon observability against the reference's daemon, the
counterpart of tests/test_observatory.py: the flight recorder, tenant
cost, the live profiler, exemplars and the daemon's log lines, over
loopback HTTP. One port daemon (device="cpu") and one reference daemon
serve the same corpus; before each exchange both packages' process-wide
recorders and ledgers are emptied, and then both take the same requests.

Pinned on the CPU:

  * /v1/debug/requests: the listings hold the same records (endpoint,
    status, tenant, bytes, why a trace was kept, the trace id) with the
    same keys; one record in full has the reference's keys, plan summary
    included; a sampled record's span tree holds the daemon's serve.*
    stages under the inbound trace id;
  * /v1/debug/tenants: fixed request counts a tenant (sequential, no
    hammer) give equal tables apart from CPU seconds (positive on both),
    and the port's decoded bytes reconcile with its registry's
    bytes_uncompressed_total delta;
  * /v1/debug/profile: the reference's typed 400s and 409; a window taken
    while scans run shows pqt-serve lanes;
  * /metrics in OpenMetrics: a request id rides serve_request_seconds as
    an exemplar and resolves in the flight recorder;
  * the daemon's JSON log lines (slow_request, drain_begin /
    drain_complete, admission_rejected) equal the reference's except
    their times and ids.

No wall time is pinned; requests are sequential. Tolerance: exact.
"""

from __future__ import annotations

import http.client
import importlib
import io
import json
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
from parquet_tpu.obs import log as jlog  # noqa: E402
from parquet_tpu.obs.cost import LEDGER as JLEDGER  # noqa: E402
from parquet_tpu.serve import ScanServer as JaxServer  # noqa: E402
from parquet_tpu.serve import ServeConfig as JaxConfig  # noqa: E402

from parquet_tpu_torch.obs import log as plog  # noqa: E402
from parquet_tpu_torch.obs.cost import LEDGER as PLEDGER  # noqa: E402
from parquet_tpu_torch.serve import ScanServer, ServeConfig  # noqa: E402
from parquet_tpu_torch.utils import metrics as pmetrics  # noqa: E402

JREC = importlib.import_module("parquet_tpu.obs.recorder").RECORDER
PREC = importlib.import_module("parquet_tpu_torch.obs.recorder").RECORDER

ROWS = 4000
ROW_GROUP = 1000
TIMEOUT_S = 60
TP = "00-" + "be" * 16 + "-" + "ef" * 8 + "-01"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("observatory_corpus")
    rng = np.random.default_rng(11)
    pq.write_table(pa.table({
        "id": np.arange(ROWS, dtype=np.int64),
        "v": rng.integers(0, 1000, ROWS).astype(np.int64),
        "name": [f"n{i % 13}" for i in range(ROWS)],
    }), str(d / "a.parquet"), row_group_size=ROW_GROUP, compression="snappy")
    return d


@pytest.fixture()
def pair(corpus, request):
    """(port, reference) daemons under the same obs knobs (an indirect
    parametrization passes them as request.param)."""
    kw = getattr(request, "param", {})
    servers = [ScanServer(ServeConfig(port=0, root=str(corpus), cache_mb=16, device="cpu",
                                      **kw)).start_background(),
               JaxServer(JaxConfig(port=0, root=str(corpus), cache_mb=16, **kw)).start_background()]
    try:
        yield servers
    finally:
        for s in servers:
            s.close()


def wait_until(cond, timeout_s: float = TIMEOUT_S) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached in time")
        time.sleep(0.01)


def fresh() -> None:
    for rec in (PREC, JREC):
        rec.__init__(rec.config)
    PLEDGER.reset()
    JLEDGER.reset()


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


EXCHANGES = [
    ("POST", "/v1/scan", {"paths": "a.parquet", "columns": ["id", "name"]}, "t1", "s1"),
    ("POST", "/v1/query", {"paths": "a.parquet", "aggregates": [["count"], ["sum", "v"]]},
     "t2", "q1"),
    ("GET", "/v1/plan?paths=a.parquet", None, "t1", "p1"),
    ("POST", "/v1/scan", {"paths": "missing.parquet"}, "t3", "e1"),
    ("POST", "/v1/scan", {"paths": "a.parquet", "limit": 7}, "t2", None),
]


def run_exchanges(server) -> list:
    out = []
    for method, path, body, tenant, rid in EXCHANGES:
        hdrs = {"X-Tenant": tenant, "traceparent": TP}
        if rid:
            hdrs["X-Request-Id"] = rid
        out.append(request(server, method, path, body, hdrs)[0])
    return out


SUMMARY_FIELDS = ("endpoint", "tenant", "status", "bytes", "trace_kind", "trace_id", "open",
                  "has_trace")


@pytest.mark.parametrize("pair", [{"trace_sample_rate": 1.0}, {"trace_sample_rate": 0.0}],
                         indirect=True, ids=["sample_all", "sample_none"])
def test_debug_request_listings_equal(pair):
    fresh()
    statuses = [run_exchanges(s) for s in pair]
    assert statuses[0] == statuses[1] == [200, 200, 200, 404, 200]
    got, want = (json.loads(request(s, "GET", "/v1/debug/requests")[2]) for s in pair)
    assert set(got) == set(want) == {"requests"}
    assert [set(r) for r in got["requests"]] == [set(r) for r in want["requests"]]
    pick = lambda doc: [tuple(r[k] for k in SUMMARY_FIELDS) for r in doc["requests"]]  # noqa: E731
    assert pick(got) == pick(want)
    for rid in ("s1", "q1", "p1", "e1"):
        a = json.loads(request(pair[0], "GET", f"/v1/debug/requests/{rid}")[2])
        b = json.loads(request(pair[1], "GET", f"/v1/debug/requests/{rid}")[2])
        assert set(a) == set(b) and a["trace_id"] == b["trace_id"] == TP.split("-")[1]
        if isinstance(b["plan"], dict):
            assert set(a["plan"]) == set(b["plan"])
        for key in ("stages",):
            assert {n for n in a[key] if n.startswith("serve.")} == {
                n for n in b[key] if n.startswith("serve.")}
    for rid in ("s1", "q1"):
        got_t, want_t = (request(s, "GET", f"/v1/debug/requests/{rid}/trace") for s in pair)
        assert got_t[0] == want_t[0]
        if got_t[0] == 200:
            a, b = json.loads(got_t[2]), json.loads(want_t[2])
            assert a["otherData"]["propagation"] == b["otherData"]["propagation"]
            assert a["otherData"]["request"] == b["otherData"]["request"]
            names = lambda d: {e["name"] for e in d["traceEvents"]  # noqa: E731
                               if e["name"].startswith("serve.")}
            assert names(a) == names(b) and names(a)
        else:
            assert json.loads(got_t[2])["error"]["code"] == json.loads(want_t[2])["error"]["code"]


def test_tenant_tables_equal_on_fixed_counts(pair):
    fresh()
    before = pmetrics.snapshot()
    for s in pair:
        for tenant, n in (("alice", 3), ("bob", 2), ("carol", 1)):
            for _ in range(n):
                assert request(s, "POST", "/v1/scan", {"paths": "a.parquet"},
                               {"X-Tenant": tenant})[0] == 200
    # a daemon charges a request just after its client has the body: wait
    # (bounded) until both ledgers hold all six
    for s in pair:
        wait_until(lambda s=s: json.loads(request(s, "GET", "/v1/debug/tenants")[2])[
            "totals"]["requests"] == 6)
    d = pmetrics.delta(before)
    got, want = (json.loads(request(s, "GET", "/v1/debug/tenants")[2]) for s in pair)
    assert set(got) == set(want) == {"tenants", "totals"}
    strip = lambda rows: sorted(({k: v for k, v in r.items() if k != "cpu_seconds"}  # noqa: E731
                                 for r in rows), key=lambda r: r["tenant"])
    assert strip(got["tenants"]) == strip(want["tenants"])
    rows = {r["tenant"]: r for r in got["tenants"]}
    assert [rows[t]["units"] for t in ("alice", "bob", "carol")] == [
        n * (ROWS // ROW_GROUP) for n in (3, 2, 1)]
    assert all(r["cpu_seconds"] > 0 for r in got["tenants"] + want["tenants"])
    uncompressed = sum(v for k, v in d.items() if k.startswith("bytes_uncompressed_total"))
    assert got["totals"]["decoded_bytes"] == uncompressed > 0
    for tenant in ("alice", "bob", "carol"):
        assert pmetrics.get("serve_tenant_decoded_bytes_total", tenant=tenant) >= \
            rows[tenant]["decoded_bytes"]


@pytest.mark.parametrize("qs", ["seconds=0", "seconds=61", "seconds=nope",
                                "seconds=1&interval_ms=0.1", "seconds=1&format=svg"])
def test_profile_refusals_equal(pair, qs):
    got, want = (request(s, "GET", f"/v1/debug/profile?{qs}") for s in pair)
    assert got[0] == want[0] == 400
    assert json.loads(got[2])["error"]["message"] == json.loads(want[2])["error"]["message"]


def test_a_profile_window_under_scans_shows_serve_lanes(pair):
    port = pair[0]
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            request(port, "POST", "/v1/scan", {"paths": "a.parquet"}, {"X-Tenant": "prof"})

    th = threading.Thread(target=hammer)
    th.start()
    try:
        status, _h, body = request(port, "GET", "/v1/debug/profile?seconds=0.8&interval_ms=5")
        busy = request(port, "GET", "/v1/debug/profile?seconds=0.1&format=json")
    finally:
        stop.set()
        th.join(TIMEOUT_S)
    assert status == 200
    lanes = {line.split(";", 1)[0] for line in body.decode().splitlines()}
    assert any(lane.startswith("pqt-serve") for lane in lanes), lanes
    assert busy[0] in (200, 409)


def test_exemplars_name_fetchable_records(pair):
    fresh()
    for s in pair:
        assert request(s, "POST", "/v1/scan", {"paths": "a.parquet", "limit": 3},
                       {"X-Request-Id": "exemplar-1"})[0] == 200
        # the daemon records a request's latency as it finishes the
        # request, which can be just after the client has its answer
        end = time.monotonic() + 30
        while True:
            status, headers, body = request(s, "GET", "/metrics",
                                            headers={"Accept": "application/openmetrics-text"})
            assert status == 200 and headers["Content-Type"].startswith("application/openmetrics")
            lines = [ln for ln in body.decode().splitlines()
                     if "serve_request_seconds_bucket" in ln and 'request_id="exemplar-1"' in ln]
            if lines or time.monotonic() > end:
                break
            time.sleep(0.005)
        assert lines
        rec = json.loads(request(s, "GET", "/v1/debug/requests/exemplar-1")[2])
        assert rec["id"] == "exemplar-1" and rec["status"] == 200


def log_lines(log, script, buf=None) -> list:
    """The JSON log lines `script()` makes, their run-dependent keys
    dropped; `buf` is the stream the log writes to (a new one if None)."""
    buf = io.StringIO() if buf is None else buf
    handler = log.configure_logging(buf)
    try:
        script()
    finally:
        log._logger.removeHandler(handler)
    out = []
    for line in buf.getvalue().splitlines():
        doc = json.loads(line)
        for k in ("ts", "duration_ms", "request_id", "trace_id", "in_flight"):
            doc.pop(k, None)
        out.append(doc)
    return out


def test_daemon_log_lines_equal(corpus):
    out = []
    for log, server_cls, config_cls, extra in ((plog, ScanServer, ServeConfig, {"device": "cpu"}),
                                              (jlog, JaxServer, JaxConfig, {})):
        server = server_cls(config_cls(port=0, root=str(corpus), slow_ms=0.0001, max_inflight=1,
                                       **extra)).start_background()

        buf = io.StringIO()

        def script(server=server, buf=buf):
            request(server, "POST", "/v1/scan", {"paths": "a.parquet", "limit": 2},
                    {"X-Tenant": "t"})
            # the daemon logs a request's slow_request line as it finishes
            # the request, which can be just after the client has its
            # answer: the drain starts once the line is there
            end = time.monotonic() + 30
            while '"slow_request"' not in buf.getvalue():
                assert time.monotonic() < end, "no slow_request line in 30 s"
                time.sleep(0.002)
            server.drain(timeout=30)

        try:
            lines = log_lines(log, script, buf)
        finally:
            server.close()
        out.append([ln for ln in lines if ln["event"] in ("slow_request", "drain_begin",
                                                          "drain_complete")])
    assert out[0] == out[1] and [ln["event"] for ln in out[0]] == [
        "slow_request", "drain_begin", "drain_complete"]


def test_admission_rejections_log_alike():
    from parquet_tpu.serve.admission import AdmissionController as JaxAdmission
    from parquet_tpu.serve.protocol import ServeError as JaxServeError

    from parquet_tpu_torch.serve.admission import AdmissionController
    from parquet_tpu_torch.serve.protocol import ServeError

    out = []
    for log, cls, err in ((plog, AdmissionController, ServeError),
                          (jlog, JaxAdmission, JaxServeError)):
        def script(cls=cls, err=err):
            adm = cls(max_inflight=1, tenant_concurrent=1)
            ticket = adm.admit("a")
            for tenant in ("a", "b"):
                with pytest.raises(err):
                    adm.admit(tenant)
            ticket.release()
            adm.begin_drain()
            with pytest.raises(err):
                adm.admit("c")

        out.append(log_lines(log, script))
    assert out[0] == out[1] and len(out[0]) == 3
