"""The port's SLO controller and its dataset wiring against the JAX package's.

Pinned here, on the CPU:

  * the control law: both packages' AIMDControllers, each with a store of
    its own (the reference's MetricsRegistry, the port's Instruments) fed
    the same wait observations under one fake clock, give equal tick()
    verdicts, state(), targets and store values after every step (the
    counterparts of tests/test_controller.py's TestControlLaw);
  * validation: the same ValueErrors for the same bad settings;
  * the store: Instruments.hist_stats equal to MetricsRegistry.hist_stats
    after the same observations, bucket boundaries included (the bounds
    decide which waits are violations);
  * dataset wiring: slo_wait_ms attaches a controller (controller= wins);
    the stream is the same with and without one and equal to the JAX
    dataset's; a checkpoint taken mid-adaptation resumes byte-identical,
    without a controller and with other settings; the pqt-data pool
    really grows to the worker target; the dataset's waits and the
    pqt-data queue waits reach the store, and dataset_counts() shows the
    violations an attached controller counted.

The reference's TestScanSloGate drives `parquet-tool scan --slo-ms`, whose
counterpart comes with the port of tools/; it has none here yet.

Tolerance: exact (states, targets, counts and batch bytes compare equal).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
from parquet_tpu.data import AIMDController as JaxController  # noqa: E402
from parquet_tpu.data import ParquetDataset as JaxDataset  # noqa: E402
from parquet_tpu.utils import metrics as jmetrics  # noqa: E402

from parquet_tpu_torch.data import (  # noqa: E402
    AIMDController,
    ParquetDataset,
    dataset_counts,
    reset_dataset_counts,
)
from parquet_tpu_torch.utils.instruments import (  # noqa: E402
    DEFAULT_BUCKETS,
    INSTRUMENTS,
    Instruments,
)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def make(pkg, **kw):
    clock = FakeClock()
    store = Instruments() if pkg == "port" else jmetrics.MetricsRegistry()
    kw.setdefault("slo_wait_ms", 10.0)
    kw.setdefault("window_s", 1.0)
    kw.setdefault("initial_depth", 2)
    kw.setdefault("max_workers", 8)
    cls = AIMDController if pkg == "port" else JaxController
    return cls(clock=clock, registry=store, **kw), clock, store


def run_law(pkg, kw, script):
    """Drive one package's controller: ("obs", seconds, times) observes
    waits, ("pool", seconds, times) pqt-data queue waits, ("tick", dt)
    advances the clock and ticks, ("poke",) ticks without advancing. Each
    step records what a caller can read."""
    ctl, clock, store = make(pkg, **kw)
    out = [("init", ctl.state(), store.get("dataset_prefetch_target"))]
    for step in script:
        op = step[0]
        if op == "obs":
            for _ in range(step[2]):
                store.observe("dataset_wait_seconds", step[1])
            continue
        if op == "pool":
            for _ in range(step[2]):
                store.observe("pool_queue_wait_seconds", step[1], pool="pqt-data")
            continue
        if op == "tick":
            clock.t += step[1]
        evaluated = ctl.tick()
        # the reference counts violations in its registry, the port on the controller
        violations = ctl.violations if pkg == "port" else store.get("dataset_slo_violations_total")
        out.append((evaluated, ctl.state(), ctl.prefetch_target, ctl.worker_target,
                    ctl.readahead_budget, violations,
                    store.get("dataset_prefetch_target"), ctl.ticks, ctl.increases,
                    ctl.decreases))
    return out


def spike(k, value=0.05, n=20):
    return [s for _ in range(k) for s in (("obs", value, n), ("tick", 1.0))]


LAWS = {
    "arms_then_evaluates_per_window": ({}, [("poke",), ("poke",), ("tick", 0.5), ("tick", 0.6)]),
    "spike_grows_depth_within_k_ticks": (dict(initial_depth=1), [("poke",)] + spike(4)),
    "depth_caps_at_max": (dict(initial_depth=1, max_depth=3), [("poke",)] + spike(6, n=10)),
    "idle_decays_multiplicatively_after_streak": (
        dict(initial_depth=8, idle_windows=3, decrease_factor=0.5),
        [("poke",)] + spike(3, value=0.0001)),
    "depth_floors_at_min": (dict(initial_depth=2, min_depth=1, idle_windows=1),
                            [("poke",)] + spike(6, value=0.0001, n=5)),
    "slo_below_smallest_bucket_drives_on_mean_only": (
        dict(slo_wait_ms=0.4, initial_depth=2, idle_windows=1),
        [("poke",)] + spike(3, value=0.00001) + spike(1, value=0.005)),
    "no_traffic_holds": (dict(initial_depth=4, idle_windows=1), [("poke",)] + [("tick", 1.0)] * 5),
    "moderate_traffic_holds_and_resets_idle_streak": (
        dict(initial_depth=4, idle_windows=2, idle_fraction=0.1),
        [("poke",)] + spike(4, value=0.005, n=10)),
    "violations_counted": (
        {}, [("poke",), ("obs", 0.05, 7), ("obs", 0.0001, 3), ("tick", 1.0)]),
    "worker_target_clamped": (dict(initial_depth=2, max_workers=4),
                              [("poke",)] + spike(8, n=10)),
    "readahead_budget_scales": (dict(initial_depth=3, readahead_unit_bytes=1 << 20),
                                [("poke",)] + spike(2)),
    "bucket_boundary_waits": (
        dict(slo_wait_ms=5.0, violation_share=0.2),
        [("poke",), ("obs", 0.005, 8), ("obs", 0.0050001, 2), ("tick", 1.0), ("obs", 0.005, 7),
         ("obs", 0.0051, 3), ("tick", 1.0)]),
    "pool_waits_do_not_steer": (
        dict(initial_depth=3, idle_windows=1),
        [("poke",), ("pool", 2.0, 50), ("obs", 0.0001, 10), ("tick", 1.0), ("pool", 2.0, 50),
         ("tick", 1.0)]),
    "mixed_then_recovery": (
        dict(initial_depth=2, idle_windows=2, max_depth=6),
        [("poke",)] + spike(5) + spike(3, value=0.0002) + spike(2, value=0.02, n=3)
        + spike(4, value=0.0001)),
    "late_ticks_span_several_windows": (
        dict(initial_depth=2),
        [("poke",), ("obs", 0.05, 5), ("tick", 7.5), ("obs", 0.05, 5), ("tick", 0.99),
         ("tick", 0.02)]),
}


@pytest.mark.parametrize("name", sorted(LAWS))
def test_control_law_matches_the_reference(name):
    kw, script = LAWS[name]
    got = run_law("port", kw, script)
    want = run_law("jax", kw, script)
    assert got == want
    assert len(got) > 1


def test_the_law_moves_as_the_reference_pins():
    """The headline numbers of the reference's TestControlLaw, read off the
    port's run."""
    last = run_law("port", *LAWS["spike_grows_depth_within_k_ticks"])[-1]
    assert last[2] == 1 + 4 and last[8] == 4
    last = run_law("port", *LAWS["idle_decays_multiplicatively_after_streak"])[-1]
    assert last[2] == 4 and last[9] == 1
    last = run_law("port", *LAWS["slo_below_smallest_bucket_drives_on_mean_only"])
    assert last[3][5] == 0 and last[3][8] == 0 and last[-1][8] == 1
    last = run_law("port", *LAWS["violations_counted"])[-1]
    assert last[5] == 7
    last = run_law("port", *LAWS["worker_target_clamped"])[-1]
    assert last[2] == 10 and last[3] == 4


BAD = [
    dict(slo_wait_ms=0), dict(slo_wait_ms=-1.0), dict(slo_wait_ms=5, min_depth=0),
    dict(slo_wait_ms=5, min_depth=4, max_depth=3), dict(slo_wait_ms=5, window_s=0),
    dict(slo_wait_ms=5, increase_step=0), dict(slo_wait_ms=5, decrease_factor=1.5),
    dict(slo_wait_ms=5, decrease_factor=0.0),
]


@pytest.mark.parametrize("kw", BAD, ids=range(len(BAD)))
def test_validation_matches_the_reference(kw):
    msgs = []
    for cls in (AIMDController, JaxController):
        with pytest.raises(ValueError) as ei:
            cls(registry=Instruments() if cls is AIMDController else jmetrics.MetricsRegistry(),
                **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_defaults_match_the_reference(monkeypatch):
    monkeypatch.setenv("PQT_DATA_THREADS", "3")
    a = AIMDController(slo_wait_ms=5, registry=Instruments())
    b = JaxController(slo_wait_ms=5, registry=jmetrics.MetricsRegistry())
    for attr in ("slo_wait_ms", "slo_s", "min_depth", "max_depth", "max_workers",
                 "readahead_unit_bytes", "window_s", "violation_share", "increase_step",
                 "decrease_factor", "idle_fraction", "idle_windows"):
        assert getattr(a, attr) == getattr(b, attr), attr
    assert a.state() == b.state() and a.max_workers == 3


def test_store_histograms_match_the_registry():
    ours, theirs = Instruments(), jmetrics.MetricsRegistry()
    assert ours.hist_stats("dataset_wait_seconds") == theirs.hist_stats("dataset_wait_seconds")
    values = list(DEFAULT_BUCKETS) + [0.0, 1e-9, 0.00051, 0.0099, 4.9, 5.0001, 60.0]
    for v in values:
        ours.observe("dataset_wait_seconds", v)
        theirs.observe("dataset_wait_seconds", v)
        ours.observe("pool_queue_wait_seconds", v * 2, pool="pqt-data")
        theirs.observe("pool_queue_wait_seconds", v * 2, pool="pqt-data")
    for name, labels in (("dataset_wait_seconds", {}),
                         ("pool_queue_wait_seconds", {"pool": "pqt-data"}),
                         ("pool_queue_wait_seconds", {"pool": "pqt-serve"})):
        a, b = ours.hist_stats(name, **labels), theirs.hist_stats(name, **labels)
        assert (a["count"], a["sum"], tuple(a["buckets"]), a["bucket_counts"]) == (
            b["count"], b["sum"], tuple(b["buckets"]), b["bucket_counts"])
    ours.set("g", 7)
    theirs.set("g", 7)
    ours.set("g", 3, k="x")
    theirs.set("g", 3, k="x")
    assert (ours.get("g"), ours.get("g", k="x"), ours.get("nope")) == (
        theirs.get("g"), theirs.get("g", k="x"), theirs.get("nope"))


# -- dataset wiring ---------------------------------------------------------------

N_FILES = 4
ROWS = 900
ROW_GROUP = 150


@pytest.fixture(scope="module")
def pattern(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ctl_shards")
    rng = np.random.default_rng(3)
    for i in range(N_FILES):
        t = pa.table({"x": pa.array(rng.integers(0, 1 << 40, ROWS).astype(np.int64))})
        pq.write_table(t, str(d / f"s-{i:02d}.parquet"), row_group_size=ROW_GROUP)
    return str(d / "s-*.parquet")


def drain(it):
    return [{k: np.asarray(v) for k, v in b.items()} for b in it]


def batches_equal(a, b):
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        assert ba.keys() == bb.keys()
        for k in ba:
            assert ba[k].dtype == bb[k].dtype and np.array_equal(ba[k], bb[k]), k


def test_slo_attaches_a_controller(pattern):
    ds = ParquetDataset(pattern, batch_size=128, slo_wait_ms=5.0, prefetch=3, device="cpu")
    ref = JaxDataset(pattern, batch_size=128, slo_wait_ms=5.0, prefetch=3)
    assert isinstance(ds._controller, AIMDController)
    assert ds._controller.state() == ref._controller.state()
    assert (ds._controller.slo_wait_ms, ds._controller.max_depth) == (5.0, 32)
    assert ParquetDataset(pattern, batch_size=128, device="cpu")._controller is None
    ctl = AIMDController(slo_wait_ms=1.0, registry=Instruments())
    assert ParquetDataset(pattern, batch_size=128, slo_wait_ms=5.0, controller=ctl,
                          device="cpu")._controller is ctl


def test_stream_identical_with_and_without_controller(pattern):
    """The advisory contract: the controller changes speed, never the
    stream; and the stream is the reference's."""
    kw = dict(batch_size=128, shuffle=True, seed=11, remainder="keep")
    with ParquetDataset(pattern, device="cpu", **kw) as plain:
        ref = drain(iter(plain))
    with ParquetDataset(pattern, slo_wait_ms=1.0, device="cpu", **kw) as elastic:
        got = drain(iter(elastic))
    batches_equal(ref, got)
    with JaxDataset(pattern, slo_wait_ms=1.0, **kw) as jds:
        batches_equal(drain(iter(jds)), got)


def test_resume_byte_identical_with_controller_mid_adaptation(pattern):
    """A checkpoint taken while the controller is live (and has moved the
    depth) resumes byte-identical on a dataset without a controller, and
    on one with other settings: controller state is not checkpoint state."""
    kw = dict(batch_size=100, shuffle=True, seed=7, remainder="keep")
    clock = FakeClock()
    store = Instruments()
    ctl = AIMDController(slo_wait_ms=0.001, initial_depth=1, window_s=0.001, clock=clock,
                         registry=store)
    with ParquetDataset(pattern, controller=ctl, device="cpu", **kw) as ds:
        it = iter(ds)
        first = [next(it) for _ in range(9)]
        for _ in range(3):
            # a window elapses with a wait far over the SLO in it (the
            # controller reads its own store, not the dataset's)
            store.observe("dataset_wait_seconds", 1.0)
            clock.t += 10
            first.append(next(it))
        assert ctl.increases >= 1 and ctl.prefetch_target > 1  # moved mid-stream
        state = it.state_dict()
        rest_live = drain(it)
    assert "controller" not in state and "prefetch" not in state
    with ParquetDataset(pattern, device="cpu", **kw) as ds2:
        rest_resumed = drain(ds2.iterator(state))
    batches_equal(rest_live, rest_resumed)
    with ParquetDataset(pattern, slo_wait_ms=5000.0, device="cpu", **kw) as ds3:
        full = drain(iter(ds3))
    batches_equal(drain(first) + rest_live, full)
    with JaxDataset(pattern, **kw) as jds:
        batches_equal(drain(jds.iterator(state)), rest_resumed)


def test_pool_grows_with_target(pattern):
    clock = FakeClock()
    store = Instruments()
    ctl = AIMDController(slo_wait_ms=10.0, initial_depth=1, window_s=1.0, max_workers=4,
                         clock=clock, registry=store)
    with ParquetDataset(pattern, batch_size=128, controller=ctl, device="cpu") as ds:
        pool = ds._worker_pool()
        assert pool._max_workers == 1
        ctl.tick()
        for _ in range(3):
            for _ in range(10):
                store.observe("dataset_wait_seconds", 0.05)
            clock.t += 1.0
            ctl.tick()
        ds._apply_controller_targets()
        assert pool._max_workers == ctl.worker_target == 4
        # the grown pool runs the stream: as many pqt-data threads as tasks
        # overlap, never more than the target
        drain(iter(ds))
        assert 1 <= len(pool._threads) <= 4


def test_controller_targets_reach_the_readahead(pattern):
    store = Instruments()
    ctl = AIMDController(slo_wait_ms=10.0, initial_depth=3, readahead_unit_bytes=1 << 20,
                         registry=store)
    with ParquetDataset(pattern, batch_size=128, controller=ctl, cache_bytes=8 << 20,
                        device="cpu") as ds:
        assert ds._readahead.budget_bytes == 2 << 20
        ds._apply_controller_targets()
        assert ds._readahead.budget_bytes == ctl.readahead_budget == 3 << 20


def test_waits_reach_the_store_and_the_counts(pattern):
    """The dataset observes each consumer wait and each pqt-data task's
    queue wait into INSTRUMENTS (what a default controller reads), and
    dataset_counts() shows the violations a controller counted there."""
    reset_dataset_counts()
    waits0 = INSTRUMENTS.hist_stats("dataset_wait_seconds")["count"]
    pool0 = INSTRUMENTS.hist_stats("pool_queue_wait_seconds", pool="pqt-data")["count"]
    ticks = iter(range(10**6))
    ctl = AIMDController(slo_wait_ms=5.0, initial_depth=2, window_s=0.5,
                         clock=lambda: next(ticks))  # every tick() after the first a window
    with ParquetDataset(pattern, batch_size=128, controller=ctl, device="cpu") as ds:
        it = iter(ds)
        got = drain([next(it)])
        INSTRUMENTS.observe("dataset_wait_seconds", 1.0)  # one wait far over the SLO
        got += drain(it)
    units = N_FILES * ROWS // ROW_GROUP
    c = dataset_counts()
    assert c["batches"] == len(got) and c["wait_seconds_count"] == units
    assert INSTRUMENTS.hist_stats("dataset_wait_seconds")["count"] - waits0 == units + 1
    assert INSTRUMENTS.hist_stats("pool_queue_wait_seconds", pool="pqt-data")["count"] - pool0 == units
    assert ctl.ticks == units - 1
    assert c["dataset_slo_violations_total"] >= 1
    reset_dataset_counts()
    assert "dataset_slo_violations_total" not in dataset_counts()
