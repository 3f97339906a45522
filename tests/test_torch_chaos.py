"""The port's chaos harness, its schedules and the serve brownout against the
JAX package's, on the CPU.

Pinned here:

  * FaultSchedule: equal phase lookups of both packages under fake time
    (before, inside and past the timeline), the same knob validation and
    standard_schedule shape;
  * scheduled FlakySources of both packages, one seed, one fake clock:
    the same reads, faults and spike sleeps in the same order; the
    FlakySink schedule hook and its latency-spike preset;
  * ChaosHarness: installs the port's resilience policy only inside its
    block (breakers reset on exit), seeds each wrapper as the reference
    does (seed, source id, open ordinal);
  * percentile equal to the reference's;
  * run_dataset_chaos: a fast schedule over a small dataset on the CPU
    completes under a watchdog with the reference's report keys, injects
    faults, quarantines units typed-only, and leaves no policy behind;
  * the brownout cases of tests/test_chaos.py on both AdmissionControllers
    (the reference fed through a registry, the port through pool_stats):
    the same verdicts; ServeConfig plumbs the knobs;
  * the serve path's typed fast-fails: a breaker-dark source is a 503
    source_unavailable (counted as a breaker shed), a raw transport fault
    a 503 source_error, on both packages' ScanServices.

The slow sweep (the full standard schedule with hedging, breakers, retries
and the controller, under a watchdog) is marked slow, as the reference's.
Tolerance: exact (phases, draws, verdicts and report keys compare equal).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
from parquet_tpu.io import source as jsource  # noqa: E402
from parquet_tpu.serve import admission as jadm  # noqa: E402
from parquet_tpu.testing import chaos as jchaos  # noqa: E402
from parquet_tpu.testing import flaky as jflaky  # noqa: E402
from parquet_tpu.utils import metrics as jmetrics  # noqa: E402

from parquet_tpu_torch.io import source as psource  # noqa: E402
from parquet_tpu_torch.io.hedge import resilience_config  # noqa: E402
from parquet_tpu_torch.serve import admission as padm  # noqa: E402
from parquet_tpu_torch.serve import counts as pcounts  # noqa: E402
from parquet_tpu_torch.serve.protocol import ServeError  # noqa: E402
from parquet_tpu_torch.testing import chaos as pchaos  # noqa: E402
from parquet_tpu_torch.testing import flaky as pflaky  # noqa: E402

WATCHDOG_SECONDS = 120.0


def with_watchdog(fn, timeout: float = WATCHDOG_SECONDS):
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
        pytest.fail(f"watchdog: chaos still running after {timeout}s (hang)")
    if err:
        raise err[0]
    return out[0]


# -- schedules ---------------------------------------------------------------------


def three_phases(mod):
    return mod.FaultSchedule([
        mod.Phase("a", 1.0, {}),
        mod.Phase("b", 2.0, {"error_rate": 0.5}),
        mod.Phase("c", 1.0, {"permanent": True}),
    ])


@pytest.mark.parametrize("make", [
    three_phases,
    lambda mod: mod.standard_schedule(phase_s=0.5, warmup_s=0.25, base={"latency_s": 0.002}),
    lambda mod: mod.standard_schedule(phase_s=1.0, spike_p=0.6, spike_ms=12.5, error_rate=0.7),
], ids=["three", "standard_warmup", "standard"])
def test_phase_lookups_match_under_fake_time(make):
    ours, theirs = make(pchaos), make(jchaos)
    assert ours.total_s == theirs.total_s and not ours.started
    ours.start(100.0)
    theirs.start(100.0)
    for t in np.concatenate([np.arange(99.0, 106.0, 0.0625), [100.0 + ours.total_s, 1e9]]):
        t = float(t)
        assert (ours.phase_at(t).name, ours.params_at(t), ours.elapsed(t), ours.done(t)) == (
            theirs.phase_at(t).name, theirs.params_at(t), theirs.elapsed(t), theirs.done(t))


def test_schedule_arms_on_first_query_and_holds_the_last_phase():
    for mod in (pchaos, jchaos):
        s = mod.FaultSchedule([mod.Phase("only", 1.0, {})])
        assert not s.started
        s.phase_at(50.0)
        assert s.started and s.elapsed(50.5) == pytest.approx(0.5)
        s = three_phases(mod)
        s.start(0.0)
        assert s.phase_at(1e9).name == "c" and s.done(4.0) and not s.done(3.9)


@pytest.mark.parametrize("args", [("typo", 1.0, {"eror_rate": 0.5}), ("p", 0.0, {}),
                                  ("p", -1.0, {}), ("p", 1.0, {"drop_rate": 0.1})],
                         ids=["typo", "zero", "negative", "replica_knob"])
def test_phase_validation_matches(args):
    msgs = []
    for mod in (pchaos, jchaos):
        with pytest.raises(ValueError) as ei:
            mod.Phase(*args)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    for mod in (pchaos, jchaos):
        with pytest.raises(ValueError, match="at least one phase"):
            mod.FaultSchedule([])


def test_standard_schedule_shape_matches():
    a = pchaos.standard_schedule(phase_s=1.0, base={"latency_s": 0.002})
    b = jchaos.standard_schedule(phase_s=1.0, base={"latency_s": 0.002})
    assert [(p.name, p.duration_s, p.params) for p in a.phases] == [
        (p.name, p.duration_s, p.params) for p in b.phases]
    assert [p.name for p in a.phases] == ["warmup", "latency_spike", "error_burst", "blackout",
                                          "recovery"]
    assert a.phases[3].params["permanent"] is True


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_percentile_matches(q):
    rng = np.random.default_rng(int(q * 100))
    vals = list(rng.random(257))
    assert pchaos.percentile(vals, q) == jchaos.percentile(vals, q)
    assert pchaos.percentile([], q) is None and pchaos.percentile([3.0], q) == 3.0


# -- scheduled flaky sources and sinks ------------------------------------------------


def scheduled_draws(flaky_mod, chaos_mod, source_mod, seed, times, **sched_kw):
    """One scheduled FlakySource read at each fake time: the outcomes, the
    spike sleeps and the counters."""
    t = [0.0]
    sleeps = []
    fs = flaky_mod.FlakySource(
        source_mod.MemorySource(bytes(range(256)) * 4), seed=seed,
        schedule=chaos_mod.standard_schedule(**sched_kw), clock=lambda: t[0], sleep=sleeps.append)
    out = []
    for k, now in enumerate(times):
        t[0] = now
        off = (k * 37) % 900
        try:
            out.append(("ok", fs.read_at(off, 64)))
        except OSError as e:
            out.append((type(e).__name__, str(e)))
    return out, sleeps, (fs.faults_injected, fs.spikes_injected, fs.reads)


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_scheduled_flaky_sources_draw_alike(seed):
    times = [float(x) for x in np.linspace(0.0, 5.5, 120)]
    kw = dict(phase_s=1.0, spike_p=0.5, spike_ms=40.0, error_rate=0.4,
              base={"short_rate": 0.2, "latency_s": 0.001})
    got = scheduled_draws(pflaky, pchaos, psource, seed, times, **kw)
    want = scheduled_draws(jflaky, jchaos, jsource, seed, times, **kw)
    assert got == want
    assert got[2][0] > 0 and got[2][1] > 0


def test_source_phases_deterministic_under_fake_time():
    t = [0.0]
    sleeps = []
    s = pchaos.standard_schedule(phase_s=1.0, spike_p=1.0, spike_ms=40.0, error_rate=1.0)
    fs = pflaky.FlakySource(psource.MemorySource(b"x" * 256), seed=3, schedule=s,
                            clock=lambda: t[0], sleep=sleeps.append)
    fs.read_at(0, 16)  # warmup: clean
    assert fs.faults_injected == 0 and fs.spikes_injected == 0
    t[0] = 1.5  # the latency spike: every read stalls 40 ms
    fs.read_at(0, 16)
    assert fs.spikes_injected == 1 and sleeps == [0.04]
    for now in (2.5, 3.5):  # the error burst, the blackout
        t[0] = now
        with pytest.raises(OSError):
            fs.read_at(0, 16)
    t[0] = 4.5  # recovery
    assert fs.read_at(0, 16) == b"x" * 16


class _NullSink:
    sink_id = "null"

    def __init__(self):
        self._n = 0

    def write(self, data):
        self._n += len(data)
        return len(data)

    def tell(self):
        return self._n

    def flush(self):
        pass

    def close(self):
        pass

    def abort(self):
        pass


def sink_script(flaky_mod, chaos_mod):
    t = [0.0]
    s = chaos_mod.FaultSchedule([
        chaos_mod.Phase("ok", 1.0, {}),
        chaos_mod.Phase("dark", 1.0, {"permanent": True}),
        chaos_mod.Phase("flushy", 1.0, {"flush_error_rate": 1.0}),
    ])
    sink = flaky_mod.FlakySink(_NullSink(), seed=2, schedule=s, clock=lambda: t[0],
                               sleep=lambda x: None)
    out = []
    for now, op in ((0.2, "write"), (0.4, "flush"), (1.5, "write"), (2.5, "write"),
                    (2.6, "flush")):
        t[0] = now
        try:
            out.append(("ok", sink.write(b"abc") if op == "write" else sink.flush()))
        except OSError as e:
            out.append((type(e).__name__, str(e)))
    sleeps = []
    spiky = flaky_mod.FlakySink.latency_spike(_NullSink(), seed=1, p=1.0, ms=25.0,
                                              sleep=sleeps.append)
    spiky.write(b"abc")
    return out, sleeps, spiky.spikes_injected, sink.faults_injected


def test_sink_schedule_hook_and_spike_match():
    got = sink_script(pflaky, pchaos)
    assert got == sink_script(jflaky, jchaos)
    assert [o[0] for o in got[0]] == ["ok", "ok", "OSError", "ok", "OSError"]
    assert got[1] == [0.025] and got[2] == 1


# -- the harness --------------------------------------------------------------------


def test_harness_policy_scoped_to_block():
    assert not resilience_config().active
    sched = pchaos.FaultSchedule([pchaos.Phase("p", 1.0, {})])
    with pchaos.ChaosHarness(sched, seed=1, retry=True, breaker=True,
                             breaker_kw={"failure_threshold": 2}) as chaos:
        cfg = resilience_config()
        assert cfg.active and cfg.retry and cfg.breaker
        assert cfg.chaos_wrapper == chaos.wrap and cfg.registry is not None
        cfg.registry.breaker_for("src")
        assert cfg.registry.states() == {"src": "closed"}
    assert not resilience_config().active
    assert cfg.registry.states() == {}  # the harness reset its breakers


def test_harness_seeds_match_the_reference():
    """Each wrapper's seed mixes the harness seed, the source id and its
    open ordinal, as the reference's do: the same ids give the same
    seeds, and one id opened twice gets two."""
    sched_p = pchaos.FaultSchedule([pchaos.Phase("p", 1.0, {"error_rate": 0.5})])
    sched_j = jchaos.FaultSchedule([jchaos.Phase("p", 1.0, {"error_rate": 0.5})])
    ids = ["m:1", "m:1", "m:2", "file:/x/y.parquet", "m:1"]
    with pchaos.ChaosHarness(sched_p, seed=7) as pc:
        ours = [pc.wrap(psource.MemorySource(b"x" * 64, source_id=i)) for i in ids]
    with jchaos.ChaosHarness(sched_j, seed=7) as jc:
        theirs = [jc.wrap(jsource.MemorySource(b"x" * 64, source_id=i)) for i in ids]
    seeds = [fs._rng.bit_generator.seed_seq.entropy for fs in ours]
    assert seeds == [fs._rng.bit_generator.seed_seq.entropy for fs in theirs]
    assert len(set(seeds)) == len(ids)
    assert len(pc.sources) == len(ids) and pc.faults_injected() == 0


# -- run_dataset_chaos ----------------------------------------------------------------

N_FILES = 3
ROWS = 1200
ROW_GROUP = 200


@pytest.fixture(scope="module")
def pattern(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_chaos_shards")
    rng = np.random.default_rng(5)
    for i in range(N_FILES):
        t = pa.table({"x": pa.array(rng.integers(0, 1 << 40, ROWS).astype(np.int64))})
        pq.write_table(t, str(d / f"s-{i:02d}.parquet"), row_group_size=ROW_GROUP)
    return str(d / "s-*.parquet")


def fast_chaos(mod, pattern, **extra):
    sched = mod.standard_schedule(phase_s=0.25, error_rate=0.5)
    with mod.ChaosHarness(
        sched, seed=11, breaker=True, retry=True,
        retry_kw={"attempts": 2, "base_delay_s": 0.0005, "max_delay_s": 0.002},
        breaker_kw={"failure_threshold": 4, "open_s": 0.2},
    ) as chaos:
        return mod.run_dataset_chaos(pattern, chaos=chaos, batch_size=256, slo_wait_ms=500.0,
                                     prefetch=2, **extra)


def test_fast_schedule_smoke(pattern):
    """A compressed schedule against a real dataset on the CPU: completes
    under the watchdog with the reference's report keys, injects real
    faults, quarantines typed-only, delivers every batch whole on the
    requested device, and leaves no policy behind."""
    rep = with_watchdog(lambda: fast_chaos(pchaos, pattern, device="cpu"), 60.0)
    ref = with_watchdog(lambda: fast_chaos(jchaos, pattern), 60.0)
    assert set(rep) == set(ref) | {"devices"}
    assert set(rep["phases"]) == set(ref["phases"]) == {
        "warmup", "latency_spike", "error_burst", "blackout", "recovery"}
    for name, row in rep["phases"].items():
        assert set(row) == set(ref["phases"][name])
        assert row["violations"] == 0 or row["violation_share"] > 0
    assert rep["batches"] > 0 and rep["rows"] > 0 and rep["devices"] == ["cpu"]
    assert rep["faults_injected"] > 0 and rep["retries"] > 0
    assert rep["units_skipped"] > 0  # the blackout quarantined, typed-only
    assert rep["controller"] is not None and rep["controller"]["ticks"] > 0
    assert set(rep["controller"]) == set(ref["controller"])
    assert not resilience_config().active


def test_controller_detached_keeps_the_slo_for_reporting(pattern):
    sched = pchaos.standard_schedule(phase_s=0.1, error_rate=0.0)

    def run():
        with pchaos.ChaosHarness(sched, seed=3) as chaos:
            return pchaos.run_dataset_chaos(pattern, chaos=chaos, batch_size=300,
                                            slo_wait_ms=1e-6, enable_controller=False,
                                            device="cpu", max_batches=40)

    rep = with_watchdog(run, 60.0)
    assert rep["controller"] is None and rep["slo_wait_ms"] == 1e-6
    waits = sum(p["waits"] for p in rep["phases"].values())
    assert waits == rep["batches"] <= 40
    assert sum(p["violations"] for p in rep["phases"].values()) == waits
    assert rep["slo_violations_total"] == 0  # no controller counted any


# -- brownout (tests/test_chaos.py's TestBrownout, on both controllers) ----------------


class FakePool:
    """Equal queue-wait numbers for both controllers: the reference reads
    them through a registry (hist_stats / get), the port through
    pool_stats()."""

    def __init__(self):
        self.reg = jmetrics.MetricsRegistry()

    def observe(self, seconds, pool="pqt-serve"):
        self.reg.observe("pool_queue_wait_seconds", seconds, pool=pool)

    def set_depth(self, n, pool="pqt-serve"):
        self.reg.set("pool_queue_depth", n, pool=pool)

    def stats(self):
        h = self.reg.hist_stats("pool_queue_wait_seconds", pool="pqt-serve")
        return {"queued": self.reg.get("pool_queue_depth", pool="pqt-serve"),
                "wait_count": h["count"], "wait_sum": h["sum"]}


def brownout_run(mod, script, **kw):
    t = [0.0]
    pool = FakePool()
    kw.setdefault("brownout_wait_s", 0.05)
    kw.setdefault("brownout_window_s", 1.0)
    extra = {"registry": pool.reg} if mod is jadm else {"pool_stats": pool.stats}
    adm = mod.AdmissionController(clock=lambda: t[0], **kw, **extra)
    out = []
    for step in script:
        op = step[0]
        if op == "admit":
            try:
                adm.admit("a").release()
                out.append("ok")
            except (ServeError, jadm.ServeError) as e:
                out.append((e.status, e.code, e.retry_after_s))
        elif op == "wait":
            for _ in range(step[2]):
                pool.observe(step[1], *step[3:])
        elif op == "depth":
            pool.set_depth(step[1])
        elif op == "at":
            t[0] = step[1]
    return out


BROWNOUTS = {
    "sheds_on_queue_wait_and_recovers": (
        {}, [("admit",), ("wait", 0.2, 10), ("at", 1.5), ("admit",), ("admit",),
             ("wait", 0.001, 50), ("at", 3.0), ("admit",)]),
    "wait_in_other_pools_never_sheds": (
        {}, [("admit",), ("wait", 5.0, 10, "pqt-data"), ("at", 1.5), ("admit",)]),
    "depth_trigger_catches_wedged_pool": (
        dict(brownout_depth=4), [("admit",), ("depth", 9), ("admit",), ("depth", 0), ("admit",)]),
    "disabled_by_default": (
        dict(brownout_wait_s=None, brownout_window_s=2.0),
        [("wait", 9.0, 10), ("admit",), ("at", 5.0), ("admit",)]),
}


@pytest.mark.parametrize("name", sorted(BROWNOUTS))
def test_brownout_matches_the_reference(name):
    kw, script = BROWNOUTS[name]
    pcounts.reset_serve_counts()
    got = brownout_run(padm, script, **kw)
    assert got == brownout_run(jadm, script, **kw)
    sheds = sum(1 for r in got if r != "ok")
    assert pcounts.serve_counts().get('serve_shed_total{reason="queue_wait"}', 0) == sheds
    if name.startswith(("sheds", "depth")):
        assert sheds >= 1 and got[-1] == "ok"


@pytest.mark.parametrize("kw", [dict(brownout_wait_s=0), dict(brownout_depth=-1),
                                dict(brownout_window_s=0)], ids=["wait", "depth", "window"])
def test_brownout_validation_matches(kw):
    msgs = []
    for mod in (padm, jadm):
        with pytest.raises(ValueError) as ei:
            mod.AdmissionController(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_serve_config_plumbs_brownout():
    from parquet_tpu_torch.serve.server import ScanService, ServeConfig

    with pytest.raises(ValueError):
        ServeConfig(brownout_wait_ms=-5)
    svc = ScanService(ServeConfig(port=0, brownout_wait_ms=250.0, brownout_depth=7, device="cpu"))
    assert svc.admission.brownout_wait_s == pytest.approx(0.25)
    assert svc.admission.brownout_depth == 7


# -- the serve path's typed fast-fails -------------------------------------------------


def scan_error(pkg, pattern, factory):
    import glob as _glob

    if pkg == "port":
        from parquet_tpu_torch.serve.protocol import parse_scan_request
        from parquet_tpu_torch.serve.server import ScanService, ServeConfig

        extra = {"device": "cpu"}
    else:
        from parquet_tpu.serve.protocol import parse_scan_request
        from parquet_tpu.serve.server import ScanService, ServeConfig

        extra = {}
    root = str(_glob.glob(pattern)[0]).rsplit("/", 1)[0]
    svc = ScanService(ServeConfig(port=0, root=root, cache_mb=0, source_factory=factory, **extra))
    req = parse_scan_request(b'{"paths": ["s-00.parquet"], "format": "jsonl"}')
    t0 = time.perf_counter()
    ticket, _ct, chunks = svc.scan(req, "t")
    with ticket:
        try:
            next(chunks)
        except (ServeError, jadm.ServeError) as e:
            return (e.status, e.code, bool(e.retry_after_s)), time.perf_counter() - t0
        finally:
            chunks.close()
    raise AssertionError(f"{pkg}: the scan answered")


def test_dark_source_scan_is_typed_503(pattern):
    """A scan whose source's breaker is OPEN fails fast with a typed 503
    source_unavailable, counted as a breaker shed: not a 500, not a
    deadline burn."""
    from parquet_tpu.io import BreakerSource as JaxBreakerSource
    from parquet_tpu.io import CircuitBreaker as JaxBreaker

    from parquet_tpu_torch.io.hedge import BreakerSource, CircuitBreaker

    out = []
    for pkg, breaker_cls, source_cls, local in (
            ("port", CircuitBreaker, BreakerSource, psource.LocalFileSource),
            ("jax", JaxBreaker, JaxBreakerSource, jsource.LocalFileSource)):
        breaker = breaker_cls("dark", failure_threshold=1, open_s=600.0)
        breaker.record_failure()  # pre-tripped: the source is KNOWN dark
        pcounts.reset_serve_counts()
        verdict, secs = scan_error(pkg, pattern, lambda p: source_cls(local(p), breaker))
        out.append(verdict)
        assert secs < 2.0  # a fast fail
        if pkg == "port":
            assert pcounts.serve_counts()['serve_shed_total{reason="breaker_open"}'] == 1
    assert out[0] == out[1] == (503, "source_unavailable", True)


def test_raw_transport_fault_is_typed_503(pattern):
    """An un-breakered EIO from the source is a typed 503 source_error
    (the daemon's environment, not a server bug)."""
    got = scan_error("port", pattern, lambda p: pflaky.FlakySource(
        psource.LocalFileSource(p), seed=1, permanent=True))[0]
    want = scan_error("jax", pattern, lambda p: jflaky.FlakySource(
        jsource.LocalFileSource(p), seed=1, permanent=True))[0]
    assert got == want == (503, "source_error", True)


# -- the slow sweep ---------------------------------------------------------------------


@pytest.mark.slow
def test_full_schedule_no_hang_no_torn_stream_typed_only(pattern):
    """The extended sweep: a full-severity standard schedule, real sleeps,
    hedging + breakers + retries + controller all on, under a watchdog:
    the loop completes (typed errors only), every batch whole, the
    controller moved, and real faults were injected and absorbed."""
    sched = pchaos.standard_schedule(phase_s=1.0, spike_p=0.5, spike_ms=60.0, error_rate=0.4,
                                     base={"latency_s": 0.001})

    def run():
        with pchaos.ChaosHarness(
            sched, seed=29, breaker=True, retry=True, hedge=True,
            retry_kw={"attempts": 3, "base_delay_s": 0.001, "max_delay_s": 0.01},
            breaker_kw={"failure_threshold": 5, "open_s": 0.5},
            hedge_kw={"min_delay_s": 0.005, "initial_delay_s": 0.02},
        ) as chaos:
            return pchaos.run_dataset_chaos(pattern, chaos=chaos, batch_size=200,
                                            slo_wait_ms=200.0, prefetch=1, step_s=0.002,
                                            device="cpu")

    rep = with_watchdog(run, WATCHDOG_SECONDS)
    assert rep["faults_injected"] > 0 and rep["spikes_injected"] > 0
    assert rep["units_skipped"] > 0 and rep["batches"] > 0
    assert rep["rows"] >= rep["batches"]
    assert rep["controller"]["ticks"] > 0
