"""parquet_tpu_torch.sink and testing.flaky.FlakySink against the JAX
package's: the seeded write-fault injector on MemorySink and LocalFileSink
(the same faults at the same writes, the same bytes kept, the same commit),
FileWriter's typed failure and auto-abort under it, SinkError's `code`, and
the sinks' byte and call counts (sink_counts(), the reference's
sink_bytes_written_total / sink_write_calls_total)."""

import errno
import os
import types

import numpy as np
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema as j_parse_schema  # noqa: E402
from parquet_tpu.sink.sink import LocalFileSink as JLocalFileSink  # noqa: E402
from parquet_tpu.sink.sink import MemorySink as JMemorySink  # noqa: E402
from parquet_tpu.sink.sink import SinkError as JSinkError  # noqa: E402
from parquet_tpu.testing.chaos import FaultSchedule, Phase  # noqa: E402
from parquet_tpu.testing.flaky import FlakySink as JFlakySink  # noqa: E402
from parquet_tpu.utils import metrics  # noqa: E402

from parquet_tpu_torch.core.writer import FileWriter  # noqa: E402
from parquet_tpu_torch.schema.dsl import parse_schema  # noqa: E402
from parquet_tpu_torch.sink import (  # noqa: E402
    BufferedSink,
    LocalFileSink,
    MemorySink,
    SinkError,
)
from parquet_tpu_torch.sink.counts import reset_sink_counts, sink_counts  # noqa: E402
from parquet_tpu_torch.testing.flaky import FlakySink  # noqa: E402

JAX = types.SimpleNamespace(
    name="jax", Flaky=JFlakySink, Memory=JMemorySink, Local=JLocalFileSink,
    SinkError=JSinkError, FileWriter=JWriter,
    schema=j_parse_schema,
)
PORT = types.SimpleNamespace(
    name="torch", Flaky=FlakySink, Memory=MemorySink, Local=LocalFileSink,
    SinkError=SinkError, FileWriter=FileWriter,
    schema=parse_schema,
)
PACKAGES = (JAX, PORT)
DSL = "message m { required int64 a; optional binary b (STRING); }"

FAULTS = [
    {"error_rate": 0.3},
    {"error_rate": 0.5, "flush_error_rate": 0.5},
    {"fail_after_bytes": 3000},
    {"permanent": True},
    {"spike_rate": 0.4, "spike_s": 0.25, "latency_s": 0.01},
]


def chunks(seed=11, n=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(1, 300))).astype(np.uint8).tobytes()
            for _ in range(n)]


def drive(flaky, data):
    """Write each chunk (and flush every fifth), recording each operation's
    outcome: the trace of which writes faulted, and how."""
    trace = []
    for i, c in enumerate(data):
        try:
            trace.append(("w", flaky.write(c)))
        except OSError as e:
            trace.append(("w!", e.errno, str(e)))
        if i % 5 == 4:
            try:
                flaky.flush()
                trace.append(("f",))
            except OSError as e:
                trace.append(("f!", e.errno, str(e)))
    return trace


def numbers(flaky):
    return (flaky.writes, flaky.bytes_written, flaky.faults_injected,
            flaky.spikes_injected, flaky.tell())


@pytest.mark.parametrize("faults", FAULTS, ids=lambda f: ",".join(f))
@pytest.mark.parametrize("seed", [0, 7])
def test_flaky_sink_on_memory_sink_matches(faults, seed):
    got = {}
    for pkg in PACKAGES:
        slept = []
        inner = pkg.Memory()
        flaky = pkg.Flaky(inner, seed=seed, sleep=slept.append, **faults)
        trace = drive(flaky, chunks())
        flaky.close()
        got[pkg.name] = (trace, numbers(flaky), inner.getvalue(), slept)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("commit_error", [False, True])
@pytest.mark.parametrize("faults", FAULTS[:3], ids=lambda f: ",".join(f))
def test_flaky_sink_on_local_file_sink_matches(tmp_path, faults, commit_error):
    got = {}
    for pkg in PACKAGES:
        path = tmp_path / pkg.name / "out.bin"
        path.parent.mkdir()
        flaky = pkg.Flaky(pkg.Local(str(path)), seed=3, commit_error=commit_error,
                          sleep=lambda s: None, **faults)
        trace = drive(flaky, chunks())
        try:
            flaky.close()
            closed = "committed"
        except OSError as e:
            closed = (e.errno, str(e))
        body = path.read_bytes() if path.exists() else None
        # the commit fault aborts the inner sink: no temp file is left
        left = sorted(os.listdir(path.parent))
        got[pkg.name] = (trace, numbers(flaky), closed, body, left)
    assert got["torch"] == got["jax"]
    if commit_error:
        assert got["torch"][2][0] == errno.EIO and got["torch"][3] is None
        assert got["torch"][4] == []


def test_latency_spike_preset_matches():
    got = {}
    for pkg in PACKAGES:
        slept = []
        flaky = pkg.Flaky.latency_spike(pkg.Memory(), seed=5, p=0.3, ms=40.0,
                                        sleep=slept.append)
        drive(flaky, chunks(n=60))
        got[pkg.name] = (slept, numbers(flaky))
    assert got["torch"] == got["jax"]
    assert got["torch"][1][3] > 0 and set(got["torch"][0]) == {0.04}


def test_schedule_overlay_matches():
    # a FaultSchedule's phase overrides the knobs per operation, on a fake
    # clock each write advances
    got = {}
    for pkg in PACKAGES:
        t = [0.0]
        sched = FaultSchedule([Phase("calm", 1.0), Phase("burst", 1.0, {"error_rate": 1.0}),
                               Phase("recovery", 5.0)])
        flaky = pkg.Flaky(pkg.Memory(), seed=1, schedule=sched, clock=lambda t=t: t[0])
        trace = []
        for c in chunks(n=30):
            t[0] += 0.1
            try:
                trace.append(flaky.write(c))
            except OSError as e:
                trace.append(str(e))
        got[pkg.name] = (trace, numbers(flaky))
    assert got["torch"] == got["jax"]
    assert 9 <= got["torch"][1][2] <= 10  # the burst's writes, and no other


@pytest.mark.parametrize("faults", [{"error_rate": 0.5}, {"fail_after_bytes": 2000},
                                    {"commit_error": True}], ids=lambda f: ",".join(f))
def test_writer_over_a_flaky_local_sink_leaves_no_file(tmp_path, faults):
    """The FlakySink docstring's pin, in both packages: a write fault
    surfaces as WriterError, a commit fault as the sink's OSError, and the
    destination never appears."""
    rows = [{"a": i, "b": None if i % 7 == 0 else f"s{i % 13}"} for i in range(5000)]
    got = {}
    for pkg in PACKAGES:
        path = tmp_path / pkg.name / "t.parquet"
        path.parent.mkdir()
        sink = pkg.Flaky(pkg.Local(str(path)), seed=7, **faults)
        try:
            # the caller owns a sink it passes in: it commits it itself
            with pkg.FileWriter(sink, pkg.schema(DSL), row_group_size=500) as w:
                w.write_rows(rows)
            sink.close()
            verdict = "committed"
        except Exception as e:  # noqa: BLE001 — compared below
            verdict = (type(e).__name__, str(e), type(e.__cause__).__name__)
        got[pkg.name] = (verdict, path.exists(), sorted(os.listdir(path.parent)),
                         sink.faults_injected)
    assert got["torch"] == got["jax"]
    want = "OSError" if "commit_error" in faults else "WriterError"
    assert got["torch"][0][0] == want and not got["torch"][1]
    assert got["torch"][2] == []


@pytest.mark.parametrize("args,code", [
    (("sink closed: x",), None),
    (("put x: HTTP 403 Forbidden",), "http_403"),
    (("gave up",), "put_retry_exhausted"),
    ((), "breaker_open"),
])
def test_sink_error_code(args, code):
    e, je = SinkError(*args, code=code), JSinkError(*args, code=code)
    assert isinstance(e, OSError)
    assert (e.code, str(e), e.args) == (je.code, str(je), je.args)
    assert SinkError(*args).code is None


def test_closed_sinks_raise_sink_error_like_jax(tmp_path):
    got = {}
    for pkg in PACKAGES:
        texts = []
        path = tmp_path / f"{pkg.name}.bin"
        for sink in (pkg.Memory(), pkg.Local(str(path))):
            sink.close()
            with pytest.raises(pkg.SinkError) as ei:
                sink.write(b"x")
            texts.append((str(ei.value).replace(pkg.name, "<p>"), ei.value.code))
        got[pkg.name] = texts
    assert got["torch"] == got["jax"]


def test_sink_counts_match_the_reference_metrics(tmp_path):
    """Every concrete sink counts its bytes and calls; a wrapper
    (BufferedSink, FlakySink) does not count them twice."""
    data = chunks()
    before = metrics.snapshot()
    jsinks = [JMemorySink(), JLocalFileSink(str(tmp_path / "j.bin"))]
    for s in jsinks:
        for c in data:
            s.write(c)
        s.close()
    jf = JFlakySink(JMemorySink(), seed=2, error_rate=0.3)
    drive(jf, data)
    d = metrics.delta(before)
    want = {k: d.get(k, 0) for k in ("sink_bytes_written_total", "sink_write_calls_total")}
    reset_sink_counts()
    for s in (MemorySink(), LocalFileSink(str(tmp_path / "t.bin"))):
        for c in data:
            s.write(c)
        s.close()
    tf = FlakySink(MemorySink(), seed=2, error_rate=0.3)
    drive(tf, data)
    assert sink_counts() == want
    # a BufferedSink spills into one counted write of its inner sink
    reset_sink_counts()
    inner = MemorySink()
    buffered = BufferedSink(inner, spill_bytes=1 << 20)
    for c in data:
        buffered.write(c)
    buffered.close()
    assert sink_counts() == {"sink_bytes_written_total": sum(map(len, data)),
                             "sink_write_calls_total": 1}
