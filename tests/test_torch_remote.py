"""parquet_tpu_torch.io.remote / sign / hedge against the JAX package's.

Both packages' sources run against both packages' RangeHttpStub (each
stub a loopback server started in a fixture and shut down in its
finalizer), on the same seeded blobs and faults; everything must agree
exactly:

  * HttpSource and ObjectStoreSource: bytes, stat fallbacks, the
    multi-range and per-range paths, the typed failure taxonomy (class and
    code), the (size, ETag) generation, re-signing, and the io counts;
  * sign_headers with a fixed clock, byte for byte, and verify_request
    across the packages (a signature one computes, the other verifies);
  * the signed stub: reads with the registered signer, a typed 403
    without it;
  * CircuitBreaker / BreakerRegistry / BreakerSource / HedgedSource state
    under scripted failures (a fake clock, events for the races; no
    wall-clock ratio is pinned), and the resilience policy open_source
    applies;
  * the fast seed x fault subset: typed-or-identical, and the same verdict
    as the reference;
  * FileReader(url) host columns, and ParquetDataset over a URL with the
    tiered cache, equal to the JAX package's.

The extended sweep (`slow`) is the counterpart of tests/test_remote.py's.
"""

from __future__ import annotations

import io
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from parquet_tpu import io as jio  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.data import ParquetDataset as JDataset  # noqa: E402
from parquet_tpu.io import hedge as jhedge  # noqa: E402
from parquet_tpu.io import sign as jsign  # noqa: E402
from parquet_tpu.testing.httpstub import RangeHttpStub as JStub  # noqa: E402
from parquet_tpu.utils import metrics as jmetrics  # noqa: E402

from parquet_tpu_torch import io as pio  # noqa: E402
from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.data import ParquetDataset  # noqa: E402
from parquet_tpu_torch.io import hedge as phedge  # noqa: E402
from parquet_tpu_torch.io import sign as psign  # noqa: E402
from parquet_tpu_torch.testing.flaky import FlakySource  # noqa: E402
from parquet_tpu_torch.testing.httpstub import RangeHttpStub  # noqa: E402

NOSLEEP = lambda s: None  # noqa: E731
WATCHDOG_SECONDS = 60.0
STUBS = {"port": RangeHttpStub, "jax": JStub}
PKGS = {"port": pio, "jax": jio}


def _jax_counts(before: dict) -> dict:
    out = {}
    for k, v in jmetrics.snapshot().items():
        name = k.split("{", 1)[0]
        if name.endswith("_total") and name.startswith(("io_", "cache_tier_")):
            if isinstance(v, (int, float)) and v - before.get(k, 0):
                out[k] = v - before.get(k, 0)
    return out


def _port_counts() -> dict:
    return {
        k: v for k, v in pio.io_counts().items()
        if v and k.split("{", 1)[0].startswith(("io_", "cache_tier_"))
    }


def outcome(fn):
    try:
        v = fn()
    except Exception as e:  # noqa: BLE001 — the outcome is what is compared
        return (type(e).__name__, getattr(e, "code", None), str(e))
    if isinstance(v, (memoryview, bytearray)):
        v = bytes(v)
    if isinstance(v, list):
        v = [bytes(x) for x in v]
    return ("ok", v)


def _norm_port(o, a, b):
    """An outcome's text with one stub's port swapped for the other's."""
    if len(o) == 3 and isinstance(o[2], str):
        return (o[0], o[1], o[2].replace(a, b))
    return o


@pytest.fixture
def make_stub(request):
    made = []

    def make(cls, **kw):
        s = cls(**kw).start()
        made.append(s)
        return s

    yield make
    for s in made:
        s.close()


@pytest.fixture(autouse=True)
def _clean_registries():
    yield
    psign.clear_signers()
    jsign.clear_signers()
    phedge.configure_resilience(None)
    jhedge.configure_resilience(None)


@pytest.fixture(scope="module")
def blob():
    return np.random.default_rng(11).integers(0, 256, 1 << 17, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    n = 6000
    t = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(rng.standard_normal(n)),
        "s": pa.array([f"k{i % 97}" for i in range(n)]),
        "m": pa.array(rng.integers(0, 50, n).astype(np.int32), mask=rng.random(n) < 0.2),
    })
    buf = io.BytesIO()
    pq.write_table(t, buf, row_group_size=2000, compression="snappy")
    return buf.getvalue()


def _digest(groups) -> list:
    out = []
    for g in groups:
        d = {}
        for path, cd in g.items():
            v = cd.values
            if hasattr(v, "offsets") and hasattr(v, "data"):
                vals = (np.asarray(v.offsets).tobytes(), bytes(v.data))
            else:
                vals = np.ascontiguousarray(np.asarray(v)).tobytes()
            dl = None if cd.def_levels is None else np.asarray(cd.def_levels).tobytes()
            d[path] = (cd.num_values, vals, dl)
        out.append(d)
    return out


def _read_all_via(src, n):
    try:
        return b"".join(src.read_at(off, min(8192, n - off)) for off in range(0, n, 8192))
    finally:
        src.close()


# -- HttpSource ----------------------------------------------------------------


SERVERS = {
    "plain": {},
    "ignore_range": dict(ignore_range=True),
    "reject_multirange": dict(reject_multirange=True),
    "reject_head": dict(reject_head=True),
    "no_etag": dict(send_etag=False),
}


@pytest.mark.parametrize("server", list(SERVERS))
@pytest.mark.parametrize("stub_pkg", ["port", "jax"])
def test_http_source_against_both_stubs(make_stub, blob, server, stub_pkg):
    """The port's HttpSource against either stub, and the reference's
    against the same stub: the same bytes, identity, generation and
    counts."""
    rng = np.random.default_rng(5)
    ranges = [(int(o), int(n)) for o, n in zip(rng.integers(0, len(blob) - 5000, 6),
                                                rng.integers(1, 5000, 6))]
    results = {}
    counts = {}
    for pkg in ("port", "jax"):
        stub = make_stub(STUBS[stub_pkg], files={"a.bin": blob}, **SERVERS[server])
        m = PKGS[pkg]
        before = jmetrics.snapshot()
        pio.reset_io_counts()
        src = m.HttpSource(stub.url_for("a.bin"))
        out = [src.size(), src.generation(), src.source_id.replace(str(stub.port), "P")]
        out += [outcome(lambda o=o, n=n: src.read_at(o, n)) for o, n in ranges]
        out.append(outcome(lambda: src.read_ranges(ranges)))
        out.append(outcome(lambda: src.read_ranges(ranges[:1])))
        out.append(outcome(lambda: src.read_at(len(blob) - 2, 5)))
        out.append(outcome(lambda: src.read_at(-1, 5)))
        out.append(outcome(lambda: src.read_ranges([(0, 4), (len(blob), 1)])))
        out = [_norm_port(o, str(stub.port), "P") if isinstance(o, tuple) else o for o in out]
        results[pkg] = out
        counts[pkg] = _port_counts() if pkg == "port" else _jax_counts(before)
        stub.close()
    assert results["port"] == results["jax"]
    for o, n in ranges:
        assert results["port"][3 + ranges.index((o, n))] == ("ok", blob[o:o + n])
    # connection reuse depends on how the concurrent per-range GETs
    # interleave: compare the connections checked out, not new vs reused
    conns = {}
    for pkg, c in counts.items():
        conns[pkg] = sum(c.pop(k, 0) for k in list(c) if k.startswith("io_http_connections"))
    assert conns["port"] == conns["jax"]
    assert counts["port"] == counts["jax"]


@pytest.mark.parametrize("stub_pkg", ["port", "jax"])
def test_typed_failure_taxonomy(make_stub, blob, stub_pkg):
    def run(m):
        out = []
        stub = make_stub(STUBS[stub_pkg], files={"a.bin": blob})
        url = stub.url_for("a.bin")
        out.append(outcome(lambda: m.HttpSource(stub.url_for("missing.bin"))))
        src = m.HttpSource(url)
        # the object is rewritten: ETag drift, or If-Range downgrade
        stub.set_file("a.bin", blob[::-1])
        out.append(outcome(lambda: src.read_at(0, 16)))
        out.append(outcome(lambda: src.read_ranges([(0, 4), (100, 4)])))
        stub.set_file("a.bin", blob)
        # a pinned size that lies: 416
        lying = m.HttpSource(url, size=len(blob) + 100, etag=None)
        out.append(outcome(lambda: lying.read_at(len(blob) + 10, 10)))
        stub.permanent = True
        out.append(outcome(lambda: src.read_at(0, 16)))
        ladder = m.RetryingSource(m.HttpSource(url, size=len(blob), etag=src.generation()[1]),
                                  attempts=3, sleep=NOSLEEP, seed=1)
        out.append(outcome(lambda: ladder.read_at(0, 16)))
        stub.permanent = False
        out.append(outcome(lambda: m.HttpSource("ftp://x/y")))
        out.append(outcome(lambda: m.HttpSource("http:///nohost")))
        return [_norm_port(o, str(stub.port), "P") for o in out]

    assert run(pio) == run(jio)


@pytest.mark.parametrize("stub_pkg", ["port", "jax"])
def test_object_store_source_resigns(make_stub, blob, stub_pkg):
    def run(m):
        stub = make_stub(STUBS[stub_pkg], files={"a.bin": blob}, require_token="T1")
        now = [1000.0]
        signs = []

        def sign():
            signs.append(1)
            return stub.url_for("a.bin") + f"?token=T{len(signs)}", now[0] + 100.0

        out = []
        src = m.ObjectStoreSource(sign, refresh_margin_s=30.0, clock=lambda: now[0])
        out.append(outcome(lambda: src.read_at(0, 16)))
        out.append("token=" in src.source_id)
        now[0] += 75.0  # inside the refresh margin: a proactive re-sign
        stub.require_token = "T2"
        out.append(outcome(lambda: src.read_at(16, 16)))
        stub.require_token = "T3"  # the store rotates: a reactive re-sign
        out.append(outcome(lambda: src.read_ranges([(0, 8), (64, 8)])))
        stub.require_token = "NEVER"
        out.append(outcome(lambda: src.read_at(0, 8)))
        out.append(len(signs))
        out.append(outcome(lambda: m.ObjectStoreSource("not callable")))
        return [_norm_port(o, str(stub.port), "P") if isinstance(o, tuple) else o for o in out]

    before = jmetrics.snapshot()
    want = run(jio)
    jcounts = _jax_counts(before)
    pio.reset_io_counts()
    got = run(pio)
    assert got == want
    # proactive, reactive, and the reactive retry of the never-valid token
    assert _port_counts().get("io_resigns_total") == jcounts.get("io_resigns_total") == 3


def test_open_source_url_and_policy(make_stub, blob):
    stub = make_stub(RangeHttpStub, files={"a.bin": blob})
    url = stub.url_for("a.bin")

    def chain(m, hedge_mod):
        out = []
        src, owns = m.open_source(url)
        out.append((type(src).__name__, owns))
        hedge_mod.configure_resilience(hedge_mod.ResilienceConfig(
            breaker=True, retry=True, retry_kw=dict(sleep=NOSLEEP), hedge=True))
        src, owns = m.open_source(url)
        names = []
        s = src
        while s is not None:
            names.append(type(s).__name__)
            s = getattr(s, "inner", None)
        out.append((names, owns, src.read_at(10, 5)))
        prev = hedge_mod.configure_resilience(None)
        out.append(prev.active)
        return out

    assert chain(pio, phedge) == chain(jio, jhedge)


# -- signing -------------------------------------------------------------------


SIGN_CASES = [
    ("GET", "http://127.0.0.1:9000/bucket/a.parquet", b""),
    ("HEAD", "https://store.example:443/b/o?x=1&a=2", b""),
    ("PUT", "http://h/o?partNumber=3&uploadId=u-1", b"payload bytes"),
    ("post", "http://h/", bytes(range(256))),
]


@pytest.mark.parametrize("case", range(len(SIGN_CASES)))
@pytest.mark.parametrize("clock", [0.0, 1_700_000_000.5])
def test_sign_headers_byte_for_byte(case, clock):
    method, url, payload = SIGN_CASES[case]
    kw = dict(access_key="AK", secret_key="s3cr3t", region="r1", service="pqt",
              clock=lambda: clock)
    got = psign.sign_headers(method, url, payload, **kw)
    assert got == jsign.sign_headers(method, url, payload, **kw)
    signer = psign.SigV4Signer("AK", "s3cr3t", region="r1", clock=lambda: clock)
    jsigner = jsign.SigV4Signer("AK", "s3cr3t", region="r1", clock=lambda: clock)
    assert signer.headers(method, url, payload) == jsigner.headers(method, url, payload)
    assert repr(signer) == repr(jsigner) and "s3cr3t" not in repr(signer)


def test_verify_request_across_packages():
    from urllib.parse import urlsplit

    t = 1_700_000_000.0
    secrets = {"AK": "s3cr3t"}.get
    for method, url, payload in SIGN_CASES:
        split = urlsplit(url)
        target = split.path + (f"?{split.query}" if split.query else "")
        for signer_mod, verifier_mod in ((psign, jsign), (jsign, psign)):
            h = signer_mod.sign_headers(method, url, payload, access_key="AK",
                                        secret_key="s3cr3t", clock=lambda: t)
            hdrs = dict(h, Host=split.netloc)
            for m in (psign, jsign):
                assert m.verify_request(method, target, hdrs, payload, secrets,
                                        clock=lambda: t) is None
            # the same tampering gives the same reason in both
            for bad_hdrs, bad_payload, bad_target, skew in (
                (dict(hdrs, Authorization=""), payload, target, 0),
                (hdrs, payload + b"!", target, 0),
                (hdrs, payload, target + "&z=1" if "?" in target else target + "?z=1", 0),
                (hdrs, payload, target, 10_000),
                (dict(hdrs, Authorization=hdrs["Authorization"].replace("AK/", "ZZ/")),
                 payload, target, 0),
                (dict(hdrs, **{"x-pqt-date": "garbage"}), payload, target, 0),
            ):
                reasons = [
                    vm.verify_request(method, bad_target, bad_hdrs, bad_payload, secrets,
                                      clock=lambda: t + skew)
                    for vm in (psign, jsign)
                ]
                assert reasons[0] == reasons[1] and reasons[0] is not None


def test_signer_registry():
    def run(m):
        a = m.SigV4Signer("A", "x")
        b = m.SigV4Signer("B", "y")
        m.configure_signer(a, prefix="http://h/")
        m.configure_signer(b, prefix="http://h/deep/")
        out = [m.signer_for(u) for u in ("http://h/x", "http://h/deep/x", "http://other/")]
        m.configure_signer(None, prefix="http://h/deep/")
        out.append(m.signer_for("http://h/deep/x"))
        m.clear_signers()
        out.append(m.signer_for("http://h/x"))
        out.append(outcome(lambda: m.SigV4Signer("", "x")))
        return [getattr(s, "access_key", s) for s in out]

    assert run(psign) == run(jsign)


@pytest.mark.parametrize("stub_pkg", ["port", "jax"])
def test_signed_stub(make_stub, blob, corpus, stub_pkg):
    """Signed mode: the registered signer's reads verify (and a reader over
    the URL gives the local read's columns); unsigned, a typed 403."""
    stub = make_stub(STUBS[stub_pkg], files={"a.bin": blob, "c.parquet": corpus},
                     credentials={"AK": "s3cr3t"})
    url = stub.url_for("a.bin")
    got = {}
    for name, m, smod in (("port", pio, psign), ("jax", jio, jsign)):
        unsigned = outcome(lambda m=m: m.HttpSource(url))
        smod.configure_signer(smod.SigV4Signer("AK", "s3cr3t"), prefix=stub.base_url)
        src = m.HttpSource(url)
        got[name] = (_norm_port(unsigned, str(stub.port), "P"),
                     outcome(lambda: src.read_ranges([(0, 10), (500, 10)])),
                     outcome(lambda: src.read_at(77, 3)))
        smod.clear_signers()
    assert got["port"] == got["jax"]
    assert got["port"][0][:2] == ("SourceError", "http_403")
    assert got["port"][2] == ("ok", blob[77:80])
    psign.configure_signer(psign.SigV4Signer("AK", "s3cr3t"), prefix=stub.base_url)
    rows = _digest(_read_url(FileReader, stub.url_for("c.parquet")))
    assert rows == _digest(_read_url(JReader, io.BytesIO(corpus)))


def _read_url(cls, src, **kw):
    if cls is FileReader:
        kw.setdefault("device", "cpu")
    with cls(src, **kw) as r:
        return [r.read_row_group(i) for i in range(r.num_row_groups)]


# -- breakers and hedges -------------------------------------------------------


class _Scripted:
    """Successive read_at calls follow a script: bytes (return), an
    Exception (raise), or a threading.Event (block until set, then return
    the data)."""

    def __init__(self, base, script, data=b"x" * 64):
        self._base = base
        self._script = list(script)
        self._data = data
        self._lock = threading.Lock()
        self.calls = 0

    def make(self):
        outer = self

        class S(self._base):
            source_id = "scripted:1"

            def size(self):
                return len(outer._data)

            def read_at(self, offset, n):
                with outer._lock:
                    step = outer._script[min(outer.calls, len(outer._script) - 1)]
                    outer.calls += 1
                if isinstance(step, threading.Event):
                    step.wait(WATCHDOG_SECONDS)
                    return outer._data[offset:offset + n]
                if isinstance(step, Exception):
                    raise step
                return step[offset:offset + n]

        return S()


def test_circuit_breaker_states():
    def run(m):
        now = [0.0]
        b = m.CircuitBreaker("src", failure_threshold=3, open_s=5.0, clock=lambda: now[0])
        out = []
        for event in ["f", "f", "s", "f", "f", "f", "r", "t4", "r", "r", "f", "t5", "r", "a",
                      "r", "s", "r", "f"]:
            if event == "f":
                b.record_failure()
            elif event == "s":
                b.record_success()
            elif event == "a":
                b.abort_probe()
            elif event.startswith("t"):
                now[0] += float(event[1:])
            else:
                out.append(outcome(b.before_read))
            out.append(b.state)
        out.append(outcome(lambda: m.CircuitBreaker("x", failure_threshold=0)))
        out.append(outcome(lambda: m.CircuitBreaker("x", open_s=0)))
        return out

    assert run(phedge) == run(jhedge)


def test_breaker_registry_and_source(tmp_path):
    p = tmp_path / "b.bin"
    p.write_bytes(bytes(range(200)))

    def run(m, srcmod, flaky_cls):
        reg = m.BreakerRegistry(max_sources=2, failure_threshold=2, open_s=1.0,
                                clock=lambda: 0.0)
        out = []
        for sid in ("a", "b", "c"):
            out.append(reg.breaker_for(sid).source_id)
        out.append(sorted(reg.states().items()))
        for sid in ("d", "e"):
            b = reg.breaker_for(sid)
            b.record_failure()
            b.record_failure()
        out.append(sorted(reg.states().items()))
        out.append(reg.breaker_for("f").source_id)  # everything open: overflow
        reg.reset()
        out.append(reg.states())
        # a blacked-out source trips its breaker; the fast-fail is terminal
        # to a retry ladder above it
        fl = flaky_cls(srcmod.LocalFileSource(str(p)), permanent=True, sleep=NOSLEEP)
        bs = m.BreakerSource(fl, m.CircuitBreaker("p", failure_threshold=2, open_s=60.0))
        ladder = srcmod.RetryingSource(bs, attempts=5, sleep=NOSLEEP, seed=0)
        out.append(outcome(lambda: ladder.read_at(0, 10)))
        out.append((bs.breaker.state, fl.reads))
        out.append(outcome(lambda: bs.read_at(-1, 2)))
        return [o if not isinstance(o, tuple) or len(o) != 3 else (o[0], o[1])
                for o in out]

    from parquet_tpu.io import source as jsource
    from parquet_tpu.testing.flaky import FlakySource as JFlaky
    from parquet_tpu_torch.io import source as psource

    assert run(phedge, psource, FlakySource) == run(jhedge, jsource, JFlaky)


@pytest.mark.parametrize("race", ["fast_primary", "hedge_wins", "primary_wins_late",
                                  "both_fail", "primary_fails_fast"])
def test_hedged_source_races(race):
    """Scripted races, no wall-clock ratio: an Event holds the primary until
    the hedge has answered (or the reverse), so each outcome is forced."""

    def run(m, srcmod):
        data = bytes(range(64))
        ev = threading.Event()
        err = OSError(5, "boom")
        script = {
            "fast_primary": [data],
            "hedge_wins": [ev, data],
            "primary_wins_late": [ev, ev],
            "both_fail": [OSError(5, "p"), OSError(5, "h")],
            "primary_fails_fast": [err],
        }[race]
        sc = _Scripted(srcmod.ByteSource, script, data)
        h = m.HedgedSource(sc.make(), min_delay_s=0.0, max_delay_s=0.0 if race != "fast_primary"
                           else 1.0, initial_delay_s=0.0 if race != "fast_primary" else 1.0)
        if race == "primary_wins_late":
            threading.Timer(0.05, ev.set).start()
        try:
            res = outcome(lambda: h.read_at(0, 8))
        finally:
            ev.set()
        if race == "both_fail":
            # the primary may fail before the hedge bar: then no hedge runs
            res = (res[0],)
        return res, min(h.hedges_launched, 1) if race != "both_fail" else None

    from parquet_tpu.io import source as jsource
    from parquet_tpu_torch.io import source as psource

    got = run(phedge, psource)
    assert got == run(jhedge, jsource)
    if race == "hedge_wins":
        assert got[0] == ("ok", bytes(range(8)))


def test_hedged_source_validation_and_delay():
    def run(m, srcmod):
        out = [outcome(lambda: m.HedgedSource(srcmod.MemorySource(b"x"), delay_quantile=1.0)),
               outcome(lambda: m.HedgedSource(srcmod.MemorySource(b"x"), min_delay_s=2,
                                              max_delay_s=1))]
        h = m.HedgedSource(srcmod.MemorySource(b"x" * 100), min_delay_s=0.01, max_delay_s=0.5,
                           initial_delay_s=0.05)
        out.append(h.hedge_delay())
        for lat in np.linspace(0.001, 0.2, 40):
            h._window.record(float(lat))
        out.append(round(h.hedge_delay(), 9))
        return out

    from parquet_tpu.io import source as jsource
    from parquet_tpu_torch.io import source as psource

    assert run(phedge, psource) == run(jhedge, jsource)


# -- the chaos sweep -----------------------------------------------------------


FAST = [
    (1, {"error_rate": 0.3}),
    (2, {"short_rate": 0.3}),
    (3, {"error_rate": 0.2, "drop_rate": 0.2, "short_rate": 0.2}),
    (4, {"permanent": True}),
]
SLOW = [
    (seed, faults)
    for seed in (7, 11, 13, 17)
    for faults in (
        {"error_rate": 0.4},
        {"drop_rate": 0.4},
        {"short_rate": 0.5},
        {"error_rate": 0.25, "drop_rate": 0.15, "short_rate": 0.25},
        {"permanent": True},
    )
]


def _sweep_one(make_stub, blob, seed, faults, stub_cls, m):
    stub = make_stub(stub_cls, files={"a.bin": blob}, seed=seed)
    base = m.HttpSource(stub.url_for("a.bin"))  # stat before the faults start
    for k, v in faults.items():
        setattr(stub, k, v)
    ladder = m.RetryingSource(base, attempts=6, sleep=NOSLEEP, seed=seed)
    try:
        got = _read_all_via(ladder, len(blob))
    except m.SourceError as e:
        return ("typed", e.code)
    finally:
        stub.close()
    assert got == blob
    return ("identical",)


@pytest.mark.parametrize("seed,faults", FAST)
def test_fast_subset(make_stub, blob, seed, faults):
    got = _sweep_one(make_stub, blob, seed, faults, RangeHttpStub, pio)
    assert got == _sweep_one(make_stub, blob, seed, faults, JStub, jio)
    if faults.get("permanent"):
        assert got == ("typed", "retry_exhausted")


@pytest.mark.slow
@pytest.mark.parametrize("seed,faults", SLOW)
def test_extended_sweep(make_stub, blob, seed, faults):
    got = _sweep_one(make_stub, blob, seed, faults, RangeHttpStub, pio)
    assert got == _sweep_one(make_stub, blob, seed, faults, JStub, jio)
    if faults.get("permanent"):
        assert got[0] == "typed"


# -- the reader and the dataset over URLs --------------------------------------


@pytest.mark.parametrize("gap", [None, "auto"])
@pytest.mark.parametrize("stub_kw", [{}, dict(reject_multirange=True), dict(latency_s=0.002)])
def test_filereader_over_url(make_stub, corpus, gap, stub_kw):
    stub = make_stub(RangeHttpStub, files={"c.parquet": corpus}, **stub_kw)
    jstub = make_stub(JStub, files={"c.parquet": corpus}, **stub_kw)
    got = _read_url(FileReader, stub.url_for("c.parquet"), coalesce_gap=gap)
    want = _read_url(JReader, jstub.url_for("c.parquet"), coalesce_gap=gap)
    assert _digest(got) == _digest(want)
    assert _digest(got) == _digest(_read_url(FileReader, corpus))
    # the device path over the URL (the plain versions on the CPU)
    with FileReader(stub.url_for("c.parquet"), device="cpu") as r:
        dev = r.read_row_groups_device()
        assert isinstance(r._source, pio.HttpSource)
    assert [sorted(g) for g in dev] == [sorted(g) for g in got]
    assert torch.equal(dev[1][("id",)].values.cpu(),
                       torch.from_numpy(np.asarray(got[1][("id",)].values)))


def test_warm_tiered_scan_reads_zero_source_bytes(make_stub, corpus, tmp_path):
    stub = make_stub(RangeHttpStub, files={"c.parquet": corpus})
    url = stub.url_for("c.parquet")
    fc = pio.FooterCache()
    with pio.TieredCache(ram_bytes=1 << 15, disk_bytes=32 << 20,
                         cache_dir=str(tmp_path / "tier")) as tc:
        cold = _read_url(FileReader, url, footer_cache=fc, block_cache=tc, coalesce_gap="auto")
        pio.reset_io_counts()
        warm = _read_url(FileReader, url, footer_cache=fc, block_cache=tc, coalesce_gap="auto")
        c = pio.io_counts()
    assert c.get("io_bytes_read_total", 0) == 0
    assert c.get('cache_tier_hits_total{tier="disk"}', 0) > 0
    assert _digest(warm) == _digest(cold)


@pytest.mark.parametrize("opts", [
    dict(cache_bytes=256 << 10),
    dict(cache_bytes=64 << 10, cache_disk_bytes=8 << 20),
    dict(cache_bytes=1 << 20, io_autotune=True, readahead_bytes=64 << 10),
])
def test_dataset_over_urls(make_stub, corpus, tmp_path, opts):
    """Two epochs over URLs: the batches equal the reference's dataset over
    its own stub, and the second epoch reads no source byte."""
    stub = make_stub(RangeHttpStub, files={"s0.parquet": corpus, "s1.parquet": corpus})
    jstub = make_stub(JStub, files={"s0.parquet": corpus, "s1.parquet": corpus})
    kw = dict(batch_size=1500, columns=["id", "v", "m"], nullable="zero", num_epochs=1,
              remainder="keep", **opts)
    if "cache_disk_bytes" in opts:
        kw["cache_dir"] = str(tmp_path / "port-tier")
    with ParquetDataset([stub.url_for("s0.parquet"), stub.url_for("s1.parquet")],
                        device="cpu", prefetch=2, **kw) as ds:
        epoch0 = [{p: a.numpy() for p, a in b.items()} for b in ds]
        ds._readahead.drain()
        pio.reset_io_counts()
        epoch1 = [{p: a.numpy() for p, a in b.items()} for b in ds]
        warm = pio.io_counts()
    if "cache_disk_bytes" in kw:
        kw["cache_dir"] = str(tmp_path / "jax-tier")
    with JDataset([jstub.url_for("s0.parquet"), jstub.url_for("s1.parquet")], **kw) as jds:
        want = list(jds)
    assert len(epoch0) == len(want) == len(epoch1)
    for a, b, w in zip(epoch0, epoch1, want):
        assert a.keys() == w.keys()
        for p in w:
            assert np.array_equal(a[p], np.asarray(w[p]))
            assert np.array_equal(b[p], a[p])
    assert warm.get("io_bytes_read_total", 0) == 0
    assert warm.get("io_cache_hits_total", 0) > 0
