"""The port's observability package (parquet_tpu_torch/obs: log, pool,
recorder, cost) against the reference's, the counterpart of
tests/test_obs.py.

Pinned on the CPU, the same calls into both packages:

  * log: JSON lines equal except `ts`, with the request context
    (log_context) on them and the token bucket's admissions and
    suppression counts on one fake clock; silent until configured;
  * pool: instrumented_submit feeds the same gauge and histogram samples
    (queue depth back at 0, one wait and task observation a task, a
    cancelled task released) and carries the caller's context;
  * recorder: begin / finish / record sequences give the same listings
    (ids, endpoints, statuses, kinds) and stats, the same sampler
    schedule, the same ring and trace eviction, the same sanitized ids;
  * cost: fixed charges (no thread hammer) give equal tenant tables and
    totals, the overflow bucket included; unit_clock bills only inside a
    cost_context; a request trace's rollup is charged alike.

Tolerance: exact, clocks injected.
"""

from __future__ import annotations

import importlib
import io
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

pytest.importorskip("jax")

from parquet_tpu.obs import cost as jcost  # noqa: E402
from parquet_tpu.obs import log as jlog  # noqa: E402
from parquet_tpu.obs import pool as jpool  # noqa: E402
from parquet_tpu.utils import metrics as jmetrics  # noqa: E402
from parquet_tpu.utils import trace as jtrace  # noqa: E402

from parquet_tpu_torch.obs import cost as pcost  # noqa: E402
from parquet_tpu_torch.obs import log as plog  # noqa: E402
from parquet_tpu_torch.obs import pool as ppool  # noqa: E402
from parquet_tpu_torch.utils import metrics as pmetrics  # noqa: E402
from parquet_tpu_torch.utils import trace as ptrace  # noqa: E402

# obs/__init__ exports a `recorder` function that shadows the module name
jrec = importlib.import_module("parquet_tpu.obs.recorder")
prec = importlib.import_module("parquet_tpu_torch.obs.recorder")

PKGS = {
    "port": (plog, ppool, prec, pcost, pmetrics, ptrace),
    "jax": (jlog, jpool, jrec, jcost, jmetrics, jtrace),
}


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- log ------------------------------------------------------------------------------


def log_lines(pkg: str, script) -> list:
    """Run `script(log, clock)` with a JSON handler on a StringIO and a
    fresh limiter on a fake clock; the lines without their `ts`."""
    log = PKGS[pkg][0]
    clock = Clock()
    buf = io.StringIO()
    prev = log.set_limiter(log.TokenBucketLimiter(rate=2.0, burst=3, clock=clock))
    handler = log.configure_logging(buf)
    try:
        script(log, clock)
    finally:
        log.set_limiter(prev)
        log._logger.removeHandler(handler)
    out = []
    for line in buf.getvalue().splitlines():
        doc = json.loads(line)
        assert doc.pop("ts").endswith("Z")
        out.append(doc)
    return out


SCRIPTS = {
    "plain": lambda log, clock: [log.log_event("unit_quarantined", level="warning",
                                               file="a.parquet", group=3)],
    "context": lambda log, clock: _in_context(log),
    "burst_then_refill": lambda log, clock: _burst(log, clock),
    "reserved_keys_win": lambda log, clock: [log.log_event("e", level="error", ts="z",
                                                            tenant="spoof")],
    "unserializable": lambda log, clock: [log.log_event("e", obj=object.__new__(Clock))],
}


def _in_context(log):
    with log.log_context(request_id="r1", tenant="t1", trace_id="ab" * 16):
        log.log_event("slow_request", level="warning", endpoint="/v1/scan", status=200)
    log.log_event("drain_begin", in_flight=0)


def _burst(log, clock):
    for _ in range(6):
        log.log_event("source_retry", reason="transport")
    clock.t += 1.0
    for _ in range(3):
        log.log_event("source_retry", reason="transport")


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_log_lines_equal_except_ts(name):
    got, want = log_lines("port", SCRIPTS[name]), log_lines("jax", SCRIPTS[name])
    if name == "unserializable":
        for doc in got + want:
            doc["obj"] = doc["obj"].split(" object at ")[0].rsplit(".", 1)[-1]
    assert got == want and got


def test_limiter_admissions_on_one_clock():
    out = []
    for log in (plog, jlog):
        clock = Clock()
        lim = log.TokenBucketLimiter(rate=5.0, burst=2, clock=clock)
        seq = []
        for step in range(12):
            clock.t = step * 0.07
            seq.append(lim.admit("k" if step % 3 else "other"))
        out.append(seq)
        with pytest.raises(ValueError):
            log.TokenBucketLimiter(rate=0)
    assert out[0] == out[1]


def test_logging_is_silent_until_configured(capsys):
    plog.log_event("nobody_listens")
    cap = capsys.readouterr()
    assert cap.out == cap.err == ""
    assert plog._logger.propagate is False


# -- pool -----------------------------------------------------------------------------


def pool_samples(pkg: str) -> dict:
    _log, pool, _rec, _cost, metrics, trace = PKGS[pkg]
    name = "pqt-parity"
    before = metrics.snapshot()
    gate = threading.Event()
    with ThreadPoolExecutor(1, thread_name_prefix=name) as ex:
        with trace.decode_trace() as t:
            first = pool.instrumented_submit(ex, gate.wait, 30.0, pool=name)
            second = pool.instrumented_submit(ex, trace.current, pool=name)
            third = pool.instrumented_submit(ex, lambda: 8, pool=name)
            assert third.cancel()
            queued = pool.pool_depths()[name]["queued"]
            gate.set()
            assert first.result(30) is True and second.result(30) is t
    d = metrics.delta(before)
    keys = {k: v for k, v in d.items() if "pqt-parity" in k and "_sum{" not in k}
    return {"delta": keys, "depths": pool.pool_depths()[name], "queued": queued,
            "gauge": metrics.get("pool_queue_depth", pool=name),
            "pool.wait": t.counters().get("pool.wait")}


def test_instrumented_submit_feeds_the_same_samples():
    got, want = pool_samples("port"), pool_samples("jax")
    assert got == want
    assert got["depths"] == {"queued": 0, "active": 0} and got["queued"] >= 1
    assert got["delta"]['pool_queue_wait_seconds_count{pool="pqt-parity"}'] == 2
    assert got["pool.wait"] == 2


def test_instrumented_submit_has_the_references_signature():
    import inspect
    assert (inspect.signature(ppool.instrumented_submit)
            == inspect.signature(jpool.instrumented_submit))


# -- recorder -------------------------------------------------------------------------


def recorder_run(pkg: str, config_kw: dict, steps: list):
    _log, _pool, rec_mod, _cost, _metrics, trace = PKGS[pkg]
    rec = rec_mod.FlightRecorder(rec_mod.ObsConfig(**config_kw))
    records = []
    for kind, arg in steps:
        if kind == "request":
            endpoint, status, rid, slow = arg
            r = rec.begin(endpoint, "tenant-a", request_id=rid)
            with trace.decode_trace() as t:
                with trace.stage("serve.execute"):
                    pass
            rec.finish(r, status, nbytes=10, trace=t, duration_s=2.0 if slow else 0.001,
                       error="boom" if status >= 500 else None)
            records.append(r)
        else:
            rec.record("dataset.unit", duration_s=0.01, nbytes=5, detail={"group": arg})
    listing = [{k: v for k, v in s.items() if k not in ("start", "id")}
               for s in rec.list(limit=1000)]
    return listing, rec.stats(), [r.trace_kind for r in records], \
        [rec.get(r.id) is not None for r in records]


RECORDER_CASES = {
    "sample_every_fourth": ({"trace_sample_rate": 0.25, "ring_size": 64},
                            [("request", ("/v1/scan", 200, None, False))] * 9),
    "errors_and_slow_always": ({"trace_sample_rate": 0.0, "slow_ms": 100.0},
                               [("request", ("/v1/scan", 500, "e1", False)),
                                ("request", ("/v1/query", 200, "s1", True)),
                                ("request", ("/v1/plan", 404, None, False)),
                                ("request", ("/v1/plan", 200, None, False))]),
    "ring_evicts": ({"ring_size": 3, "trace_sample_rate": 1.0, "max_traces": 2},
                    [("request", ("/v1/scan", 200, f"r{i}", False)) for i in range(6)]),
    "library_ring_apart": ({"ring_size": 2},
                           [("request", ("/v1/scan", 200, "keep", False))]
                           + [("unit", g) for g in range(5)]),
    "hostile_ids": ({"ring_size": 8},
                    [("request", ("/v1/scan", 200, "a b/c\nd" + "x" * 100, False)),
                     ("request", ("/v1/scan", 200, "   ", False))]),
}


@pytest.mark.parametrize("case", sorted(RECORDER_CASES))
def test_recorder_sequences_equal(case):
    kw, steps = RECORDER_CASES[case]
    got, want = recorder_run("port", kw, steps), recorder_run("jax", kw, steps)
    gl, wl = got[0], want[0]
    for a in gl + wl:
        a["duration_ms"] = None if a["duration_ms"] is None else round(a["duration_ms"])
    assert (gl, got[1], got[2], got[3]) == (wl, want[1], want[2], want[3])


@pytest.mark.parametrize("raw", [None, "", "  ", "ok-1.2:3", "bad id/é", "x" * 200])
def test_sanitized_request_ids_equal(raw):
    assert prec.sanitize_request_id(raw) == jrec.sanitize_request_id(raw)


@pytest.mark.parametrize("kw", [{"ring_size": 0}, {"trace_sample_rate": 1.5},
                                {"slow_ms": 0}, {"max_traces": -1}])
def test_obs_config_refusals_equal(kw):
    msgs = []
    for mod in (prec, jrec):
        with pytest.raises(ValueError) as ei:
            mod.ObsConfig(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_trace_documents_carry_the_request():
    rec = prec.FlightRecorder(prec.ObsConfig(trace_sample_rate=1.0))
    r = rec.begin("/v1/query", "t", request_id="q1")
    r.trace_id = "cd" * 16
    with ptrace.decode_trace() as t:
        pass
    rec.finish(r, 200, trace=t)
    doc = rec.get("q1")._trace
    assert doc["otherData"]["request"] == {"id": "q1", "endpoint": "/v1/query",
                                           "tenant": "t", "trace_id": "cd" * 16}


# -- cost -----------------------------------------------------------------------------


def ledger_run(pkg: str) -> tuple:
    cost, metrics = PKGS[pkg][3], PKGS[pkg][4]
    reg = metrics.MetricsRegistry()
    ledger = cost.CostLedger(max_tenants=3, registry=reg)
    # fixed unit counts: each tenant's units charged in a fixed order
    for tenant, units, sec in (("a", 4, 0.5), ("b", 2, 0.25), ("c", 1, 1.0),
                               ("d", 3, 0.125), ("e", 1, 2.0), (None, 1, 0.5)):
        for _ in range(units):
            ledger.charge_cpu(tenant, sec)
        ledger.charge_request(tenant, decoded_bytes=100 * units, source_bytes=10,
                              payload_bytes=7, cache_hits=units, cache_misses=1)
    ledger.charge_cpu("a", -1.0)  # a negative delta charges 0
    return ledger.table(), ledger.totals(), reg.snapshot()


def test_fixed_charges_give_equal_tables():
    got, want = ledger_run("port"), ledger_run("jax")
    assert got == want
    assert [row["tenant"] for row in got[0]][-1] == "default" or "__overflow__" in {
        row["tenant"] for row in got[0]}
    assert got[1]["units"] == 13 and got[1]["requests"] == 6


def test_unit_clock_bills_only_inside_a_cost_context():
    out = []
    for cost in (pcost, jcost):
        ledger = cost.CostLedger()
        with cost.unit_clock(ledger):
            sum(range(1000))
        assert ledger.table() == []
        with cost.cost_context("t1"):
            assert cost.charged_tenant() == "t1"
            for _ in range(3):
                with cost.unit_clock(ledger):
                    sum(range(1000))
        assert cost.charged_tenant() is None
        row = ledger.table()[0]
        out.append((row["tenant"], row["units"], row["requests"], row["cpu_seconds"] >= 0))
    assert out[0] == out[1] == ("t1", 3, 0, True)


def test_a_request_trace_is_charged_alike():
    out = []
    for _log, _pool, _rec, cost, _metrics, trace in (PKGS["port"], PKGS["jax"]):
        ledger = cost.CostLedger()
        with trace.decode_trace() as t:
            trace.add_bytes("decode.bytes", 4096)
            with trace.stage("io.read", 1000):
                pass
            trace.count("io_cache_hit", 3)
            trace.count("io_cache_miss")
        cost.charge_request_from_trace("t", t, nbytes=12, ledger=ledger)
        cost.charge_request_from_trace(None, t, ledger=ledger)  # no tenant: nothing
        out.append(ledger.table())
    assert out[0] == out[1]
    assert out[0][0]["decoded_bytes"] == 4096 and out[0][0]["cache_hits"] == 3
