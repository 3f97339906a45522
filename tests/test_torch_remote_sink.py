"""parquet_tpu_torch.io.remote_sink against the JAX package's
parquet_tpu.io.remote_sink, as tests/test_remote_sink.py pins the reference:
HttpSink's multipart protocol over loopback HTTP (each package's
testing/httpstub.py in writable mode), the LocalFileSink atomicity contract
carried to object stores, the typed write-failure taxonomy, request signing,
FileWriter / merge_files to a URL, and the seeded fault sweep.

Each case runs once per package, the port's sink against the port's stub and
the reference's against the reference's, on the same blob and stub settings,
and the two runs must agree: the committed object's bytes, SinkError.code,
the error text (with each stub's address masked), and the stub's counters.
Where faults are drawn per request the sinks run with max_in_flight=1, so
both packages send the same requests in the same order; the fast chaos subset
also runs with parts in flight, held to the same verdict class and the
zero-torn pin only. No test sleeps: every backoff is an injected no-op."""

import types

import numpy as np
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.merge import merge_files as j_merge_files  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.core.writer import WriterError as JWriterError  # noqa: E402
from parquet_tpu.io import HttpSink as JHttpSink  # noqa: E402
from parquet_tpu.io import ObjectStoreSink as JObjectStoreSink  # noqa: E402
from parquet_tpu.io import SigV4Signer as JSigner  # noqa: E402
from parquet_tpu.io import TransientSourceError as JTransient  # noqa: E402
from parquet_tpu.io import clear_signers as j_clear_signers  # noqa: E402
from parquet_tpu.io import configure_signer as j_configure_signer  # noqa: E402
from parquet_tpu.io.source import SourceError as JSourceError  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema as j_parse_schema  # noqa: E402
from parquet_tpu.sink.sink import SinkError as JSinkError  # noqa: E402
from parquet_tpu.sink.sink import open_sink as j_open_sink  # noqa: E402
from parquet_tpu.testing.chaos import FaultSchedule, Phase  # noqa: E402
from parquet_tpu.testing.flaky import FlakySink as JFlakySink  # noqa: E402
from parquet_tpu.testing.httpstub import RangeHttpStub as JStub  # noqa: E402
from parquet_tpu.utils import metrics  # noqa: E402

import torch  # noqa: E402

from parquet_tpu_torch.core.merge import merge_files  # noqa: E402
from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.core.writer import FileWriter, WriterError  # noqa: E402
from parquet_tpu_torch.io import (  # noqa: E402
    HttpSink,
    ObjectStoreSink,
    SigV4Signer,
    TransientSourceError,
    clear_signers,
    configure_signer,
    io_counts,
    reset_io_counts,
)
from parquet_tpu_torch.io.source import SourceError  # noqa: E402
from parquet_tpu_torch.schema.dsl import parse_schema  # noqa: E402
from parquet_tpu_torch.sink.counts import reset_sink_counts, sink_counts  # noqa: E402
from parquet_tpu_torch.sink.sink import SinkError, open_sink  # noqa: E402
from parquet_tpu_torch.testing.flaky import FlakySink  # noqa: E402
from parquet_tpu_torch.testing.httpstub import RangeHttpStub  # noqa: E402

NOSLEEP = lambda s: None  # noqa: E731
PART = 1 << 15  # 32 KiB parts force real multipart on the 128 KiB blob
CREDS = {"AK-test": "s3cr3t"}
DSL = ("message m { required int64 id; optional binary name (STRING); "
       "optional double score; }")
ROWS = [
    {"id": i, "name": f"n{i % 97}", "score": float(i) * 0.5}
    for i in range(20_000)
]

JAX = types.SimpleNamespace(
    name="jax", Stub=JStub, HttpSink=JHttpSink, ObjectStoreSink=JObjectStoreSink,
    Signer=JSigner, SinkError=JSinkError, SourceError=JSourceError, Transient=JTransient,
    open_sink=j_open_sink, configure_signer=j_configure_signer,
    clear_signers=j_clear_signers, FileWriter=JWriter, WriterError=JWriterError,
    merge_files=j_merge_files, FlakySink=JFlakySink, schema=lambda: j_parse_schema(DSL),
)
PORT = types.SimpleNamespace(
    name="torch", Stub=RangeHttpStub, HttpSink=HttpSink, ObjectStoreSink=ObjectStoreSink,
    Signer=SigV4Signer, SinkError=SinkError, SourceError=SourceError,
    Transient=TransientSourceError, open_sink=open_sink, configure_signer=configure_signer,
    clear_signers=clear_signers, FileWriter=FileWriter, WriterError=WriterError,
    merge_files=merge_files, FlakySink=FlakySink, schema=lambda: parse_schema(DSL),
)
PACKAGES = (JAX, PORT)

# the counts the remote sink keeps, under the reference's metric names
SINK_COUNTS = ("io_put_", "sink_multipart_")


@pytest.fixture(scope="module")
def blob():
    return (
        np.random.default_rng(29)
        .integers(0, 256, 1 << 17)
        .astype(np.uint8)
        .tobytes()
    )


@pytest.fixture(autouse=True)
def _no_signer_leak():
    yield
    clear_signers()
    j_clear_signers()


def stream(sink, data, chunk=1 << 14):
    for i in range(0, len(data), chunk):
        sink.write(data[i : i + chunk])


def masked(text: str, stub) -> str:
    """An error text with the stub's address masked (each package's stub
    listens on a port of its own)."""
    return str(text).replace(stub.base_url, "<stub>").replace(
        stub.base_url[len("http://"):], "<stub>"
    )


def stub_numbers(stub) -> dict:
    return {k: getattr(stub, k) for k in (
        "requests", "faults_injected", "put_requests", "objects_put",
        "uploads_started", "uploads_completed", "uploads_aborted", "auth_rejects")}


def outcome(pkg, stub, name, fn):
    """fn() once: the verdict, the error's class, code and masked text, and
    what the stub holds of `name` afterwards."""
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 — compared, then re-judged
        out = {"verdict": "raised", "error": type(e).__name__,
               "code": getattr(e, "code", None), "text": masked(e, stub)}
        cause = e.__cause__
        if cause is not None:
            out["cause"] = (type(cause).__name__, getattr(cause, "code", None),
                            masked(cause, stub))
    else:
        out = {"verdict": "ok"}
    out["object"] = stub.object_bytes(name)
    out["live_uploads"] = stub.live_uploads()
    return out


def both(case, **stub_kw):
    """case(pkg, stub) under each package's own writable stub; returns
    {package name: (case's result, stub numbers)}."""
    got = {}
    for pkg in PACKAGES:
        with pkg.Stub(writable=True, **stub_kw) as stub:
            got[pkg.name] = (case(pkg, stub), stub_numbers(stub))
    return got


def same(got):
    """The two packages' results, which must be equal."""
    assert got["torch"] == got["jax"]
    return got["torch"]


class TestAtomicityContract:
    def test_single_shot_put_byte_identical(self, blob):
        def case(pkg, stub):
            with pkg.HttpSink(stub.url_for("one.bin"), sleep=NOSLEEP) as s:
                stream(s, blob)
                visible = stub.has_object("one.bin")
            return visible, stub.object_bytes("one.bin") == blob

        (res, numbers) = same(both(case))
        assert res == (False, True) and numbers["objects_put"] == 1

    def test_multipart_byte_identical_and_invisible_until_commit(self, blob):
        def case(pkg, stub):
            with pkg.HttpSink(stub.url_for("mp.bin"), part_bytes=PART, sleep=NOSLEEP) as s:
                stream(s, blob)
                told, visible = s.tell(), stub.has_object("mp.bin")
            return told, visible, stub.object_bytes("mp.bin"), stub.live_uploads()

        (res, numbers) = same(both(case))
        assert res == (len(blob), False, blob, 0)
        assert numbers["uploads_completed"] == 1 and numbers["put_requests"] == 4

    def test_abort_leaves_nothing_and_is_idempotent(self, blob):
        def case(pkg, stub):
            s = pkg.HttpSink(stub.url_for("ab.bin"), part_bytes=PART, sleep=NOSLEEP)
            stream(s, blob)
            s.abort()
            s.abort()
            return outcome(pkg, stub, "ab.bin", lambda: s.write(b"more"))

        (res, numbers) = same(both(case))
        assert res["code"] == "sink_closed" and res["object"] is None
        assert res["live_uploads"] == 0 and numbers["uploads_aborted"] == 1

    def test_context_manager_exception_aborts(self, blob):
        def case(pkg, stub):
            def body():
                with pkg.HttpSink(stub.url_for("cm.bin"), part_bytes=PART,
                                  sleep=NOSLEEP) as s:
                    stream(s, blob)
                    raise RuntimeError("caller blew up mid-write")

            return outcome(pkg, stub, "cm.bin", body)

        (res, _) = same(both(case))
        assert res["error"] == "RuntimeError" and res["object"] is None
        assert res["live_uploads"] == 0

    def test_abort_after_close_never_destroys_committed_output(self, blob):
        def case(pkg, stub):
            s = pkg.HttpSink(stub.url_for("keep.bin"), part_bytes=PART, sleep=NOSLEEP)
            stream(s, blob)
            s.close()
            s.abort()
            return stub.object_bytes("keep.bin") == blob

        assert same(both(case))[0] is True

    def test_flush_is_a_no_op_not_a_part_seal(self):
        def case(pkg, stub):
            with pkg.HttpSink(stub.url_for("f.bin"), sleep=NOSLEEP) as s:
                s.write(b"abc")
                s.flush()
                sent = stub.put_requests
            return sent, stub.object_bytes("f.bin")

        assert same(both(case))[0] == (0, b"abc")

    def test_url_coercion_through_open_sink(self, blob):
        def case(pkg, stub):
            sink, owned = pkg.open_sink(stub.url_for("oc.bin"))
            with sink:
                sink.write(blob)
            return type(sink).__name__, owned, stub.object_bytes("oc.bin") == blob

        assert same(both(case))[0] == ("HttpSink", True, True)

    @pytest.mark.parametrize("url,kw", [
        ("ftp://x/y", {}),
        ("http://h/k?versionId=7", {}),  # the query is protocol-reserved
        ("http://h/k", {"part_bytes": 16}),  # below the part floor
        ("http://h/k", {"max_in_flight": 0}),
        ("http://h/k", {"attempts": 0}),
        ("http:///k", {}),
    ])
    def test_constructor_rejects_bad_urls(self, url, kw):
        texts = {}
        for pkg in PACKAGES:
            with pytest.raises(ValueError) as ei:
                pkg.HttpSink(url, **kw)
            texts[pkg.name] = str(ei.value)
        assert texts["torch"] == texts["jax"]

    def test_sink_id_matches(self):
        for url in ("http://h:80/a/b.parquet", "https://h:8443/k", "http://h:9/k"):
            assert HttpSink(url).sink_id == JHttpSink(url).sink_id


class TestFailureTaxonomy:
    def test_transient_burst_is_absorbed(self, blob):
        def case(pkg, stub):
            return outcome(pkg, stub, "e.bin", lambda: _write(
                pkg.HttpSink(stub.url_for("e.bin"), part_bytes=PART, attempts=6,
                             max_in_flight=1, sleep=NOSLEEP), blob))

        (res, numbers) = same(both(case, seed=5, error_rate=0.3))
        assert res["verdict"] == "ok" and res["object"] == blob
        assert numbers["faults_injected"] > 0

    def test_terminal_4xx_latches_and_aborts(self):
        # a read-only stub answers every write 405: terminal on attempt 1
        got = {}
        for pkg in PACKAGES:
            with pkg.Stub(writable=False, files={"x": b"r"}) as stub:
                s = pkg.HttpSink(stub.url_for("t.bin"), sleep=NOSLEEP)
                s.write(b"data")
                got[pkg.name] = outcome(pkg, stub, "t.bin", s.close)
        res = same(got)
        assert res["code"] == "http_405" and res["object"] is None

    def test_blackout_exhausts_the_ladder_typed(self, blob):
        def case(pkg, stub):
            s = pkg.HttpSink(stub.url_for("b.bin"), part_bytes=PART, attempts=3,
                             max_in_flight=1, sleep=NOSLEEP)
            res = outcome(pkg, stub, "b.bin", lambda: _write(s, blob))
            s.abort()
            return res, stub.has_object("b.bin")

        ((res, visible), numbers) = same(both(case, permanent=True))
        assert res["code"] == "put_retry_exhausted" and not visible
        assert numbers["requests"] == 3  # the initiate, three times

    def test_commit_500_is_retried_to_success(self, blob):
        def case(pkg, stub):
            def heal(_):  # the sink's backoff sleep flips the fault off
                stub.complete_error_rate = 0.0

            return outcome(pkg, stub, "c.bin", lambda: _write(
                pkg.HttpSink(stub.url_for("c.bin"), part_bytes=PART, sleep=heal), blob))

        (res, numbers) = same(both(case, seed=1, complete_error_rate=1.0))
        assert res["verdict"] == "ok" and res["object"] == blob
        assert numbers["faults_injected"] == 1

    def test_permanent_commit_fault_leaves_no_object(self, blob):
        def case(pkg, stub):
            s = pkg.HttpSink(stub.url_for("pc.bin"), part_bytes=PART, attempts=3,
                             sleep=NOSLEEP)
            stream(s, blob)
            return outcome(pkg, stub, "pc.bin", s.close)

        (res, numbers) = same(both(case, seed=2, complete_error_rate=1.0))
        assert res["code"] == "put_retry_exhausted"
        assert res["object"] is None and res["live_uploads"] == 0
        assert numbers["uploads_aborted"] == 1

    def test_ambiguous_acks_are_idempotent(self, blob):
        def case(pkg, stub):
            return outcome(pkg, stub, "aa.bin", lambda: _write(
                pkg.HttpSink(stub.url_for("aa.bin"), part_bytes=PART, attempts=8,
                             max_in_flight=1, sleep=NOSLEEP), blob))

        (res, numbers) = same(both(case, seed=3, ack_drop_rate=0.4))
        assert res["verdict"] == "ok" and res["object"] == blob
        assert numbers["faults_injected"] > 0

    def test_corrupt_part_etag_is_never_trusted(self, blob):
        def case(pkg, stub):
            s = pkg.HttpSink(stub.url_for("ce.bin"), part_bytes=PART, attempts=2,
                             max_in_flight=1, sleep=NOSLEEP)
            res = outcome(pkg, stub, "ce.bin", lambda: _write(s, blob))
            s.abort()
            return res, stub.has_object("ce.bin")

        ((res, visible), _) = same(both(case, corrupt_part_etag=True))
        assert res["code"] == "put_retry_exhausted" and not visible
        assert "torn transfer acknowledged as success" in res["text"]

    def test_single_shot_etag_mismatch_is_typed(self):
        def case(pkg, stub):
            s = pkg.HttpSink(stub.url_for("se.bin"), sleep=NOSLEEP)
            s.write(b"small")
            return outcome(pkg, stub, "se.bin", s.close)

        (res, _) = same(both(case, corrupt_part_etag=True))
        assert res["code"] == "put_etag_mismatch"


def _write(sink, data):
    with sink:
        stream(sink, data)


class TestSignedMode:
    def test_unsigned_write_is_rejected_with_403(self):
        def case(pkg, stub):
            s = pkg.HttpSink(stub.url_for("u.bin"), sleep=NOSLEEP)
            s.write(b"data")
            return outcome(pkg, stub, "u.bin", s.close)

        (res, numbers) = same(both(case, credentials=CREDS))
        assert res["code"] == "http_403" and res["object"] is None
        assert numbers["auth_rejects"] == 1

    def test_signed_multipart_roundtrip_zero_rejects(self, blob):
        def case(pkg, stub):
            return outcome(pkg, stub, "s.bin", lambda: _write(
                pkg.HttpSink(stub.url_for("s.bin"), part_bytes=PART,
                             signer=pkg.Signer("AK-test", CREDS["AK-test"]), sleep=NOSLEEP),
                blob))

        (res, numbers) = same(both(case, credentials=CREDS))
        assert res["object"] == blob and numbers["auth_rejects"] == 0

    def test_object_store_sink_requires_a_signer(self):
        texts = {}
        for pkg in PACKAGES:
            with pytest.raises(ValueError) as ei:
                pkg.ObjectStoreSink("http://h/k")
            texts[pkg.name] = str(ei.value)
            pkg.configure_signer(pkg.Signer("AK-test", CREDS["AK-test"]), prefix="http://h/")
            pkg.ObjectStoreSink("http://h/k")  # the registry satisfies it
            pkg.clear_signers()
        assert texts["torch"] == texts["jax"]

    def test_registry_signs_bare_open_sink_coercion(self, blob):
        def case(pkg, stub):
            pkg.configure_signer(pkg.Signer("AK-test", CREDS["AK-test"]),
                                 prefix=stub.base_url)
            try:
                sink, _ = pkg.open_sink(stub.url_for("r.bin"))
                return outcome(pkg, stub, "r.bin", lambda: _write(sink, blob))
            finally:
                pkg.clear_signers()

        (res, numbers) = same(both(case, credentials=CREDS))
        assert res["object"] == blob and numbers["auth_rejects"] == 0


def _write_rows(pkg, dest, **kw):
    with pkg.FileWriter(dest, pkg.schema(), row_group_size=4096, **kw) as w:
        w.write_rows(ROWS)


class TestWriterIntegration:
    @pytest.mark.parametrize("parallel", [False, True], ids=["serial", "pipeline"])
    def test_filewriter_url_roundtrip(self, tmp_path, parallel):
        # FileWriter straight at a URL (the encode pipeline's commits go
        # into the HttpSink when parallel): the object equals the reference
        # writer's and the port's path write, and reads back
        def case(pkg, stub):
            url = stub.url_for("t.parquet")
            _write_rows(pkg, url, parallel=parallel)
            return stub.object_bytes("t.parquet")

        (data, numbers) = same(both(case))
        path = tmp_path / "t.parquet"
        _write_rows(PORT, str(path), parallel=parallel)
        assert data == path.read_bytes()
        assert numbers["objects_put"] == 1  # 20,000 rows fit one part
        with RangeHttpStub(files={"t.parquet": data}) as stub:
            with FileReader(stub.url_for("t.parquet"), device="cpu") as r:
                assert list(r.iter_rows()) == ROWS

    def test_multipart_filewriter_matches(self, tmp_path):
        # parts small enough that the file spans several: the writer's
        # commits cross part seals on the pqt-io pool
        def case(pkg, stub):
            sink = pkg.HttpSink(stub.url_for("mp.parquet"), part_bytes=PART, sleep=NOSLEEP)
            _write_rows(pkg, sink, parallel=True)
            sink.close()
            return stub.object_bytes("mp.parquet")

        (data, numbers) = same(both(case))
        path = tmp_path / "mp.parquet"
        _write_rows(PORT, str(path))
        assert data == path.read_bytes()
        assert numbers["uploads_completed"] == 1
        assert numbers["put_requests"] == -(-len(data) // PART)

    def test_device_columns_to_a_url(self, tmp_path):
        # write_device_column of CPU tensors (the kernels' plain versions)
        # into a URL: the object equals the path write and the reference's
        # write_column of the same values
        rng = np.random.default_rng(3)
        cols = {"a": rng.integers(0, 50, 30_000).astype(np.int64),
                "b": rng.integers(-(2**40), 2**40, 30_000).astype(np.int64)}
        dsl = "message m { required int64 a; required int64 b; }"

        def write(writer, schema, dest, device):
            with writer(dest, schema, codec="snappy",
                        column_encodings={"b": "DELTA_BINARY_PACKED"}) as w:
                for name, v in cols.items():
                    if device:
                        w.write_device_column(name, torch.from_numpy(v))
                    else:
                        w.write_column(name, v)

        with RangeHttpStub(writable=True) as stub:
            write(FileWriter, parse_schema(dsl), stub.url_for("d.parquet"), True)
            got = stub.object_bytes("d.parquet")
        path = tmp_path / "d.parquet"
        write(FileWriter, parse_schema(dsl), str(path), True)
        jpath = tmp_path / "j.parquet"
        write(JWriter, j_parse_schema(dsl), str(jpath), False)
        assert got == path.read_bytes() == jpath.read_bytes()

    def test_signed_filewriter_roundtrip(self):
        def case(pkg, stub):
            pkg.configure_signer(pkg.Signer("AK-test", CREDS["AK-test"]),
                                 prefix=stub.base_url)
            try:
                _write_rows(pkg, stub.url_for("signed.parquet"))
            finally:
                pkg.clear_signers()
            return stub.object_bytes("signed.parquet")

        (data, numbers) = same(both(case, credentials=CREDS))
        assert numbers["auth_rejects"] == 0
        configure_signer(SigV4Signer("AK-test", CREDS["AK-test"]), prefix="http://127.0.0.1")
        with RangeHttpStub(files={"s.parquet": data}, credentials=CREDS) as stub:
            with FileReader(stub.url_for("s.parquet"), device="cpu") as r:
                assert list(r.iter_rows()) == ROWS

    def test_writer_blackout_auto_aborts_no_torn_object(self):
        def case(pkg, stub):
            w = pkg.FileWriter(
                pkg.HttpSink(stub.url_for("dead.parquet"), part_bytes=PART, attempts=2,
                             max_in_flight=1, sleep=NOSLEEP),
                pkg.schema(), row_group_size=2048,
            )
            stub.permanent = True  # the store goes dark mid-write

            def body():
                w.write_rows(ROWS)
                w.close()

            return outcome(pkg, stub, "dead.parquet", body)

        (res, _) = same(both(case))
        assert res["error"] == "WriterError" and res["object"] is None
        assert res["cause"][1] == "put_retry_exhausted"

    @pytest.mark.parametrize("faults", [{"fail_after_bytes": 3 * PART}, {"permanent": True}],
                             ids=["mid-group", "at-open"])
    def test_sink_oserror_auto_aborts_the_writer(self, faults):
        # the writer's own ladder: a sink OSError at the leading magic or
        # mid-group poisons the writer, which aborts the sink; the remote
        # upload under it never commits
        def case(pkg, stub):
            inner = pkg.HttpSink(stub.url_for("f.parquet"), part_bytes=PART, sleep=NOSLEEP)
            flaky = pkg.FlakySink(inner, **faults)

            def body():
                w = pkg.FileWriter(flaky, pkg.schema(), row_group_size=2048)
                w.write_rows(ROWS)
                w.close()

            res = outcome(pkg, stub, "f.parquet", body)
            inner.abort()
            return res, stub.live_uploads()

        ((res, live), numbers) = same(both(case))
        assert res["error"] == "WriterError" and res["object"] is None
        assert res["cause"][0] == "OSError" and live == 0
        assert numbers["uploads_started"] == (1 if "fail_after_bytes" in faults else 0)

    def test_merge_to_url_and_abort_on_failure(self, tmp_path):
        a, b = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
        for path, lo in ((a, 0), (b, 1000)):
            with FileWriter(path, parse_schema(DSL)) as w:
                w.write_rows(ROWS[lo : lo + 1000])
        b2 = str(tmp_path / "b2.parquet")
        with FileWriter(b2, parse_schema("message m { required int32 other; }")) as w:
            w.write_rows([{"other": 1}])
        merged = str(tmp_path / "m.parquet")
        merge_files(merged, [a, b])

        def case(pkg, stub):
            pkg.merge_files(stub.url_for("m.parquet"), [a, b])
            # a failing merge aborts the remote upload: b2's schema differs
            bad = outcome(pkg, stub, "bad.parquet",
                          lambda: pkg.merge_files(stub.url_for("bad.parquet"), [a, b2]))
            return stub.object_bytes("m.parquet"), bad

        ((data, bad), _) = same(both(case))
        assert data == open(merged, "rb").read()
        assert bad["verdict"] == "raised" and bad["object"] is None
        assert bad["live_uploads"] == 0
        with RangeHttpStub(files={"m.parquet": data}) as stub:
            with FileReader(stub.url_for("m.parquet"), device="cpu") as r:
                assert list(r.iter_rows()) == ROWS[:2000]
        with JReader(merged) as r:
            assert list(r.iter_rows()) == ROWS[:2000]


class TestScheduleOverlay:
    def test_error_burst_then_recovery_commits_identical(self, blob):
        # a FaultSchedule drives the stub: every write op 503s during the
        # burst; the sink's backoff advances the same fake clock, so the
        # retries walk into recovery and commit
        got = {}
        for pkg in PACKAGES:
            t = [0.0]
            sched = FaultSchedule(
                [Phase("burst", 0.5, {"error_rate": 1.0}), Phase("recovery", 1.0)]
            )

            def advance(s, t=t):
                t[0] += s

            with pkg.Stub(writable=True, schedule=sched, clock=lambda t=t: t[0]) as stub:
                res = outcome(pkg, stub, "sch.bin", lambda: _write(
                    pkg.HttpSink(stub.url_for("sch.bin"), part_bytes=PART, attempts=8,
                                 max_in_flight=1, sleep=advance), blob))
                got[pkg.name] = (res, stub_numbers(stub), t[0])
        (res, numbers, _) = same(got)
        assert res["object"] == blob and numbers["faults_injected"] > 0

    def test_flaky_sink_overlay_composes(self, blob):
        # FlakySink wraps the remote sink like a local one: its EIO comes
        # before bytes reach the store, and the abort propagates
        def case(pkg, stub):
            inner = pkg.HttpSink(stub.url_for("fk.bin"), part_bytes=PART, sleep=NOSLEEP)
            flaky = pkg.FlakySink(inner, seed=7, error_rate=1.0)
            res = outcome(pkg, stub, "fk.bin", lambda: flaky.write(blob[:PART]))
            flaky.abort()
            return res, flaky.faults_injected, stub.has_object("fk.bin")

        ((res, faults, visible), numbers) = same(both(case))
        assert res["error"] == "OSError" and faults == 1 and not visible
        assert numbers["requests"] == 0


class TestCounts:
    @pytest.mark.parametrize("stub_kw", [
        {},
        {"seed": 5, "error_rate": 0.3},
        {"corrupt_part_etag": True},
    ], ids=["clean", "transient", "etag"])
    def test_counts_match_the_reference_metrics(self, blob, stub_kw):
        """io_counts() (and sink_counts()) move as the reference's metric
        registry does over the same write: the put requests by status, the
        put bytes, the retries by reason and the multipart steps."""
        got = {}
        for pkg in PACKAGES:
            before = metrics.snapshot()
            reset_io_counts()
            reset_sink_counts()
            with pkg.Stub(writable=True, **stub_kw) as stub:
                outcome(pkg, stub, "c.bin", lambda: _write(
                    pkg.HttpSink(stub.url_for("c.bin"), part_bytes=PART, attempts=6,
                                 max_in_flight=1, sleep=NOSLEEP), blob))
            if pkg is JAX:
                counts = metrics.delta(before)
            else:
                counts = {**io_counts(), **sink_counts()}
            got[pkg.name] = {k: v for k, v in counts.items()
                             if k.startswith(SINK_COUNTS + ("sink_bytes", "sink_write"))}
        assert got["torch"] == got["jax"]
        if not stub_kw.get("corrupt_part_etag"):
            assert got["torch"]["sink_bytes_written_total"] == len(blob)
            assert got["torch"]["sink_multipart_completed_total"] == 1


class TestChaosWriteSweep:
    """The seeded write sweep of tests/test_remote_sink.py: every write of
    a faulty remote either commits byte-identical or raises a typed error,
    and in both cases no torn object exists. Both packages must give the
    same verdict class; with one part in flight they send the same requests
    and must also agree on the stub's counters."""

    FAST = [
        (1, {"error_rate": 0.3}),
        (2, {"ack_drop_rate": 0.3}),
        (3, {"error_rate": 0.2, "drop_rate": 0.2, "complete_error_rate": 0.3}),
    ]
    SLOW = [
        (seed, faults)
        for seed in (7, 11, 13, 17)
        for faults in (
            {"error_rate": 0.4},
            {"drop_rate": 0.4},
            {"ack_drop_rate": 0.5},
            {"complete_error_rate": 0.6},
            {
                "error_rate": 0.25,
                "drop_rate": 0.15,
                "ack_drop_rate": 0.25,
                "complete_error_rate": 0.25,
            },
            {"permanent": True},
        )
    ]

    def _sweep_one(self, pkg, blob, seed, faults, in_flight):
        with pkg.Stub(writable=True, seed=seed, **faults) as stub:
            sink = pkg.HttpSink(stub.url_for("out.bin"), part_bytes=PART, attempts=6,
                                max_in_flight=in_flight, sleep=NOSLEEP)
            try:
                _write(sink, blob)
            except (pkg.SinkError, pkg.SourceError, pkg.Transient):
                verdict = "typed"
            else:
                verdict = "identical"
                assert stub.object_bytes("out.bin") == blob
            # the zero-torn pin: an object is absent or the whole blob
            if stub.has_object("out.bin"):
                assert stub.object_bytes("out.bin") == blob
            return verdict, stub_numbers(stub)

    def _sweep(self, blob, seed, faults, in_flight):
        got = {pkg.name: self._sweep_one(pkg, blob, seed, faults, in_flight)
               for pkg in PACKAGES}
        if in_flight == 1:
            assert got["torch"] == got["jax"]
        else:
            assert got["torch"][0] == got["jax"][0]
        return got["torch"][0]

    @pytest.mark.parametrize("in_flight", [1, 4])
    @pytest.mark.parametrize("seed,faults", FAST)
    def test_fast_subset(self, blob, seed, faults, in_flight):
        assert self._sweep(blob, seed, faults, in_flight) in ("typed", "identical")

    @pytest.mark.slow
    @pytest.mark.parametrize("seed,faults", SLOW)
    def test_extended_sweep(self, blob, seed, faults):
        verdict = self._sweep(blob, seed, faults, 1)
        if faults.get("permanent"):
            assert verdict == "typed"
        else:
            assert verdict in ("typed", "identical")
