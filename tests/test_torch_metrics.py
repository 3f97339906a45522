"""The port's metrics registry (parquet_tpu_torch/utils/metrics.py) against
the reference's (parquet_tpu/utils/metrics.py), the counterpart of
tests/test_metrics.py.

Pinned on the CPU:

  * the same calls (a seeded random mix of inc / set / observe with and
    without exemplars, labels drawn from a small set with the characters
    the text format escapes) into a fresh registry of each package give
    byte-equal Prometheus and OpenMetrics expositions, equal snapshots,
    deltas, get() and hist_stats() values, and an empty state after
    reset();
  * the module-level vocabulary (event, page_decoded, io_bytes,
    codec_name, encoding_name, report, summarize_columns) and the
    family HELP texts equal the reference's;
  * a plain read with no trace active moves the same always-on families
    on both packages (pages by encoding, byte volumes, the chunk decode
    histogram);
  * the layer count stores are views of the one registry: a count is one
    registry sample, a reset acts on the view only, and a trace event
    counted through a view is a count of the active trace too.

Exemplar timestamps are the one clock the renders read: both modules'
time.time is pinned while a document renders. Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("pyarrow")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
from parquet_tpu.core.reader import FileReader as JaxReader  # noqa: E402
from parquet_tpu.utils import metrics as jmetrics  # noqa: E402

from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.core.writer import FileWriter  # noqa: E402
from parquet_tpu_torch.meta.file_meta import read_file_metadata  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Type  # noqa: E402
from parquet_tpu_torch.schema.builder import message, required, string  # noqa: E402
from parquet_tpu_torch.utils import metrics as pmetrics  # noqa: E402
from parquet_tpu_torch.utils import trace as ptrace  # noqa: E402
from parquet_tpu_torch.utils.counters import LabelledCounts, event_alias  # noqa: E402

NAMES = ("pages_decoded_total", "serve_requests_total", "events_total",
         "undocumented_total", "io_cache_bytes", "pool_queue_depth")
HISTS = ("serve_request_seconds", "chunk_decode_seconds", "custom_seconds")
LABEL_VALUES = ("a", 'q"uote', "back\\slash", "new\nline", "PLAIN", "200")
VALUES = (0.0, 0.0004, 0.0005, 0.001, 0.02, 0.5, 1.0, 4.9, 5.0, 7.5)


def random_calls(seed: int, n: int = 200) -> list:
    """A seeded mix of registry calls: (method, name, value, labels,
    exemplar)."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        labels = {}
        for key in ("endpoint", "status", "le_like")[: int(rng.integers(0, 3))]:
            labels[key] = LABEL_VALUES[int(rng.integers(0, len(LABEL_VALUES)))]
        if k == 0:
            calls.append(("inc", NAMES[int(rng.integers(0, 4))], int(rng.integers(1, 5)),
                          labels, None))
        elif k == 1:
            calls.append(("set", NAMES[4 + int(rng.integers(0, 2))],
                          int(rng.integers(0, 100)), labels, None))
        else:
            ex = ({"request_id": f"r{int(rng.integers(0, 9))}"}
                  if rng.random() < 0.4 else None)
            calls.append(("observe", HISTS[int(rng.integers(0, 3))],
                          VALUES[int(rng.integers(0, len(VALUES)))], labels, ex))
    return calls


def apply(reg, calls) -> None:
    for method, name, value, labels, ex in calls:
        if method == "inc":
            reg.inc(name, value, **labels)
        elif method == "set":
            reg.set(name, value, **labels)
        else:
            reg.observe(name, value, ex, **labels)


@pytest.fixture()
def pinned_clock(monkeypatch):
    """Both modules' time.time at one instant (the exemplar timestamp)."""
    monkeypatch.setattr(jmetrics.time, "time", lambda: 1_750_000_000.25)
    monkeypatch.setattr(pmetrics.time, "time", lambda: 1_750_000_000.25)


@pytest.mark.parametrize("seed", range(8))
def test_expositions_are_byte_equal(seed, pinned_clock):
    calls = random_calls(seed)
    a, b = pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    apply(a, calls)
    apply(b, calls)
    assert a.render_prometheus() == b.render_prometheus()
    assert a.render_openmetrics() == b.render_openmetrics()


@pytest.mark.parametrize("seed", range(8))
def test_snapshot_delta_get_and_hist_stats_equal(seed, pinned_clock):
    calls = random_calls(seed)
    half = len(calls) // 2
    a, b = pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    apply(a, calls[:half])
    apply(b, calls[:half])
    sa, sb = a.snapshot(), b.snapshot()
    assert sa == sb
    apply(a, calls[half:])
    apply(b, calls[half:])
    assert a.snapshot() == b.snapshot()
    assert a.delta(sa) == b.delta(sb)
    for method, name, _v, labels, _ex in calls:
        if method == "observe":
            assert a.hist_stats(name, **labels) == b.hist_stats(name, **labels)
        else:
            assert a.get(name, **labels) == b.get(name, **labels)
    assert a.hist_stats("never_observed") == b.hist_stats("never_observed")
    a.reset()
    b.reset()
    assert a.snapshot() == b.snapshot() == {}
    assert a.render_prometheus() == b.render_prometheus() == "\n"


def test_help_texts_are_the_references():
    port_only = {"admission_rejected_total", "serve_drains_total",
                 "mesh_replica_state_total", "lake_compact_skipped_total",
                 "lake_compact_errors_total"}
    assert {k: v for k, v in pmetrics._HELP.items() if k not in port_only} == jmetrics._HELP
    assert pmetrics._PREFIX == jmetrics._PREFIX
    assert pmetrics._DEFAULT_BUCKETS == jmetrics._DEFAULT_BUCKETS


@pytest.mark.parametrize("le", [0.0005, 1.0, 5.0, 1e-7, 123456.789, 0.1 + 0.2, 0])
def test_le_bounds_render_alike(le):
    assert pmetrics._format_le(le) == jmetrics._format_le(le)


@pytest.mark.parametrize("codec", [0, 1, 2, 3, 4, 5, 6, 7, "SNAPPY", 99])
def test_codec_and_encoding_names(codec):
    assert pmetrics.codec_name(codec) == jmetrics.codec_name(codec)
    if not isinstance(codec, str):
        assert pmetrics.encoding_name(codec) == jmetrics.encoding_name(codec)


def test_module_vocabulary_reports_alike(monkeypatch):
    """event / page_decoded / io_bytes into a fresh process registry of
    each package, then report() of the snapshot."""
    a, b = pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    monkeypatch.setattr(pmetrics, "REGISTRY", a)
    monkeypatch.setattr(jmetrics, "REGISTRY", b)
    for mod in (pmetrics, jmetrics):
        mod.event("prepare_fused_engaged", 3)
        mod.page_decoded("PLAIN", 2, nbytes=4096)
        mod.page_decoded("RLE_DICTIONARY", 1, nbytes=512)
        mod.io_bytes(1000, 4608, 1)
        mod.observe("chunk_decode_seconds", 0.25)
    assert a.snapshot() == b.snapshot()
    assert pmetrics.report() == jmetrics.report()
    assert pmetrics.report(a.snapshot()) == jmetrics.report(b.snapshot())


def test_process_stats_keys_match():
    assert set(pmetrics.process_stats()) == set(jmetrics.process_stats())
    assert pmetrics.process_stats()["threads"] >= 1


def test_module_render_refreshes_the_process_gauges():
    text = pmetrics.render_prometheus()
    assert "# TYPE parquet_tpu_process_uptime_seconds gauge" in text
    assert "# TYPE parquet_tpu_process_threads_total gauge" in text
    assert pmetrics.render_openmetrics().endswith("# EOF\n")


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("metrics") / "m.parquet")
    schema = message(required("id", Type.INT64), required("name", string()))
    with FileWriter(path, schema, codec="snappy") as w:
        w.write_column("id", np.arange(3000, dtype=np.int64))
        w.write_column("name", [f"n{i % 41}" for i in range(3000)])
    return path


def always_on_delta(mod, read):
    snap = mod.snapshot()
    read()
    d = mod.delta(snap)
    return {k: v for k, v in d.items()
            if k.startswith(("pages_decoded_total", "page_bytes_total",
                             "bytes_compressed_total", "bytes_uncompressed_total",
                             "chunk_decode_seconds_count"))}


@pytest.mark.parametrize("mode", ["host", "device"])
def test_a_plain_read_moves_the_same_families(sample, mode):
    """No trace active: pages by encoding, page and codec byte volumes and
    one chunk_decode_seconds observation a chunk, on both packages (the
    reference's device read is its tpu_roundtrip on the CPU)."""
    assert not ptrace.active()

    def port_read():
        with FileReader(sample, device="cpu") as r:
            for i in range(r.num_row_groups):
                if mode == "host":
                    r.read_row_group(i)
                else:
                    r.read_row_group_device(i)

    def jax_read():
        backend = "host" if mode == "host" else "tpu_roundtrip"
        with JaxReader(sample, backend=backend) as r:
            for i in range(r.num_row_groups):
                if mode == "host":
                    r.read_row_group(i)
                else:
                    r.read_row_group_device(i)

    got, want = always_on_delta(pmetrics, port_read), always_on_delta(jmetrics, jax_read)
    assert got == want and got


def test_summarize_columns_matches(sample):
    from parquet_tpu.meta.file_meta import read_file_metadata as jread

    with open(sample, "rb") as f:
        pm = read_file_metadata(f)
    with open(sample, "rb") as f:
        jm = jread(f)
    assert pmetrics.summarize_columns(pm) == jmetrics.summarize_columns(jm)


# -- the layer views -----------------------------------------------------------------


def test_a_view_count_is_one_registry_sample():
    reg = pmetrics.MetricsRegistry()
    view = LabelledCounts(reg)
    view.count("io_bytes_read_total", 10)
    view.count("io_retries_total", reason="short_read")
    view.count("io_retries_total", 2, reason="short_read")
    assert view.snapshot() == {"io_bytes_read_total": 10,
                               'io_retries_total{reason="short_read"}': 3}
    assert reg.snapshot() == view.snapshot()


def test_a_view_reset_leaves_the_registry_monotonic():
    reg = pmetrics.MetricsRegistry()
    a, b = LabelledCounts(reg), LabelledCounts(reg)
    a.count("shared_total", 4)
    b.count("shared_total", 1)
    a.reset()
    assert a.snapshot() == {} and reg.get("shared_total") == 5
    a.count("shared_total", 2)
    assert a.snapshot() == {"shared_total": 2}
    # b reads the sample from its own first count on, every writer included
    assert b.snapshot() == {"shared_total": 7 - 4}
    reg.reset()  # a registry reset (tests only): views rebase
    assert a.snapshot() == {"shared_total": 0} and b.snapshot() == {"shared_total": 0}


def test_event_alias_counts_the_active_trace():
    reg = pmetrics.MetricsRegistry()
    view = LabelledCounts(reg, alias=event_alias(("engaged",)))
    with ptrace.decode_trace() as t:
        view.count("engaged", 2)
        view.count("not_an_event")
    assert reg.snapshot() == {'events_total{event="engaged"}': 2, "not_an_event": 1}
    assert view.snapshot() == {"engaged": 2, "not_an_event": 1}
    assert t.counters() == {"engaged": 2}


def test_instruments_are_the_registry():
    from parquet_tpu_torch.utils.instruments import INSTRUMENTS, Instruments

    assert INSTRUMENTS is pmetrics.REGISTRY and Instruments is pmetrics.MetricsRegistry
