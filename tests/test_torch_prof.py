"""The port's sampling profiler (parquet_tpu_torch/obs/prof.py) against the
reference's (parquet_tpu/obs/prof.py), the counterpart of tests/test_prof.py.

Pinned on the CPU:

  * lanes: every thread name of the port's pools (pqt-host, pqt-dispatch,
    pqt-io, pqt-hedge, pqt-data, pqt-encode, pqt-serve, pqt-mesh and their
    accept loops) maps to the reference's lane;
  * the same synchronous schedule over the same real frames (injected
    frames_fn / threads_fn / clock, no thread, no timing) gives equal
    snapshots, collapsed stacks and top tables, the depth and stack bounds
    and the overflow fold included;
  * one capture window a process: a second is ProfilerBusy, and the
    capture leaves its caller out;
  * the overhead pin without wall time: a profiler sampling while a scan
    runs allocates no span (span_allocations() does not move) and counts
    one sample a thread a tick; obs_profile_samples_total{lane=} moves by
    the samples taken.

Tolerance: exact.
"""

from __future__ import annotations

import importlib
import sys
import threading

import numpy as np
import pytest

pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

jprof = importlib.import_module("parquet_tpu.obs.prof")
pprof = importlib.import_module("parquet_tpu_torch.obs.prof")

from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.utils import metrics as pmetrics  # noqa: E402
from parquet_tpu_torch.utils import trace as ptrace  # noqa: E402

THREAD_NAMES = [
    "pqt-host_0", "pqt-dispatch_0", "pqt-io_3", "pqt-hedge_1", "pqt-data_2",
    "pqt-encode_0", "pqt-serve_5", "pqt-serve-http", "pqt-serve-drain", "pqt-mesh_4",
    "pqt-mesh-http", "pqt-flush", "pqt-prof", "pqt-httpstub", "pqt-flaky-replica",
    "pqt-compact", "MainThread", "Thread-12", "", "pqt-bogus",
]


@pytest.mark.parametrize("name", THREAD_NAMES)
def test_lanes_equal_the_references(name):
    assert pprof.lane_of(name) == jprof.lane_of(name)


def test_lane_vocabularies_are_equal():
    assert pprof.POOL_LANES == jprof.POOL_LANES


def _leaf_frame(depth: int = 0):
    """A real frame `depth` calls below two known ones."""

    def inner(k):
        return sys._getframe() if k == 0 else inner(k - 1)

    def outer():
        return inner(depth)

    return outer()


def schedule(mod, frames: dict, names: dict, ticks: int, **kw) -> dict:
    clock_ticks = iter([10.0, 10.0] + [10.0 + 0.5 * i for i in range(1, ticks + 3)])
    prof = mod.SamplingProfiler(0.01, frames_fn=lambda: dict(frames),
                                threads_fn=lambda: dict(names),
                                clock=lambda: next(clock_ticks), **kw)
    prof._t_start = prof._clock()
    for _ in range(ticks):
        prof.sample_once(exclude=set())
    prof._duration = prof._clock() - prof._t_start
    prof._t_start = None
    return {"snapshot": prof.snapshot(), "collapsed": prof.collapsed(),
            "top": prof.top(10), "render": prof.render_top(5)}


CASES = {
    "one_pool": ({1: 0}, {1: "pqt-data_0"}, 7, {}),
    "mixed_lanes": ({1: 0, 2: 3, 3: 1}, {1: "pqt-serve_1", 2: "MainThread", 3: "x"}, 5, {}),
    "depth_bound": ({1: 12}, {1: "pqt-io_0"}, 3, {"max_depth": 4}),
    "stack_overflow": ({1: 0, 2: 1, 3: 2, 4: 3}, {1: "a", 2: "b", 3: "c", 4: "d"}, 4,
                       {"max_stacks": 2}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixed_schedules_give_equal_profiles(case):
    depths, names, ticks, kw = CASES[case]
    frames = {tid: _leaf_frame(d) for tid, d in depths.items()}
    got = schedule(pprof, frames, names, ticks, **kw)
    want = schedule(jprof, frames, names, ticks, **kw)
    # frame ids carry the module file stem: the two test helpers are one
    assert got == want
    assert got["snapshot"]["samples"] == ticks * len(frames)


@pytest.mark.parametrize("kw", [{"interval_s": 0}, {"max_stacks": 0}, {"max_depth": 0}])
def test_refusals_equal(kw):
    msgs = []
    for mod in (pprof, jprof):
        args = dict(kw)
        interval = args.pop("interval_s", 0.01)
        with pytest.raises(ValueError) as ei:
            mod.SamplingProfiler(interval, **args)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_one_capture_window_a_process():
    started = threading.Event()
    release = threading.Event()

    def hold(_seconds):
        started.set()
        release.wait(30)

    t = threading.Thread(target=pprof.capture, args=(0.5,), kwargs={"sleep": hold})
    t.start()
    try:
        assert started.wait(30)
        with pytest.raises(pprof.ProfilerBusy):
            pprof.capture(0.1)
    finally:
        release.set()
        t.join(30)
    # the window is free again, and a capture leaves its caller out
    prof = pprof.capture(0.05, 0.005)
    me = threading.get_ident()
    assert all(not any(f"{__name__.rsplit('.', 1)[-1]}:test_one_capture" in fr
                       for fr in s["stack"]) or s["lane"] != "main"
               for s in prof.snapshot()["stacks"])
    assert me in prof._exclude


@pytest.fixture(scope="module")
def scan_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("prof") / "scan.parquet")
    n = 200_000
    pq.write_table(pa.table({"a": np.arange(n, dtype=np.int64),
                             "b": np.arange(n, dtype=np.float64)}),
                   path, row_group_size=50_000)
    return path


def test_sampling_a_scan_allocates_no_span_and_counts_its_samples(scan_file):
    """The overhead pin, counted: a profiler ticking through a scan takes
    one sample a live thread a tick, reports each into
    obs_profile_samples_total, and leaves the span allocator alone (the
    sampler never touches the trace)."""
    before_spans = ptrace.span_allocations()
    before = pmetrics.snapshot()
    prof = pprof.SamplingProfiler(0.01)
    with FileReader(scan_file, device="cpu") as r:
        for i in range(r.num_row_groups):
            r.read_row_group(i)
            prof.sample_once(exclude=set())
    snap = prof.snapshot()
    assert snap["samples"] >= r.num_row_groups
    assert sum(snap["lanes"].values()) == snap["samples"]
    d = pmetrics.delta(before)
    counted = sum(v for k, v in d.items() if k.startswith("obs_profile_samples_total"))
    assert counted == snap["samples"]
    assert ptrace.span_allocations() == before_spans
