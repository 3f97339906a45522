"""RangeHttpStub: a loopback range-GET HTTP server with injectable faults.

The chaos substrate for parquet_tpu.io.remote — what FlakySource is to a
local ByteSource, this is to a real HTTP transport: a stdlib
ThreadingHTTPServer on 127.0.0.1:<ephemeral> serving a dict of named
blobs (or files from a directory) with honest range semantics — 206 +
Content-Range for `Range: bytes=a-b`, 200 for full GETs, HEAD, strong
ETags, 404/416 where HTTP says so — and SEEDED transport faults layered
on top:

    stub = RangeHttpStub(files={"corpus.parquet": data}, seed=7,
                         error_rate=0.2, latency_s=0.005)
    with stub:
        src = HttpSource(stub.url_for("corpus.parquet"))
        ...

Fault knobs (each draw from ONE seeded numpy rng stream, so a failing
test replays exactly; knobs are plain attributes, mutable mid-test):

  error_rate       probability a request answers 503 (the transient
                   server-fault shape RetryingSource must absorb)
  drop_rate        probability the connection closes with NO response
                   (the reset/LB-kill shape -> client-side transport
                   fault)
  short_rate       probability a response body is TRUNCATED below its
                   declared Content-Length (the torn-transfer shape ->
                   typed truncated_body)
  latency_s (+latency_jitter_s)  per-request injected RTT (the remote
                   profile the IO auto-tuner keys on)
  spike_rate/spike_s  occasional EXTRA stall (tail-latency shape)
  permanent        every request 503s (blackout)

`schedule=` accepts the same testing.chaos.FaultSchedule the FlakySource
machinery uses: the current phase's params overlay the knobs per request
(under the injectable `clock`), so one scripted spike -> errors ->
blackout -> recovery timeline drives local sources AND this stub from a
single object. Fault draws and the request counters are lock-serialized;
payload writes are not (requests stream concurrently).

`writable=True` grows the stub the WRITE side of an object store — the
multipart protocol io.remote_sink speaks (initiate/part/complete/abort
plus single-shot PUT), with the zero-torn-object semantics a real store
guarantees baked in as assertable state: an object becomes visible ONLY
at complete (atomically, under the lock), an aborted upload vanishes, and
`has_object()`/`live_uploads()` let tests prove both. Write-side faults
draw from the SAME seeded rng stream: the shared knobs above apply to
every write request, plus

  complete_error_rate  probability complete-multipart answers 500 BEFORE
                       publishing (the commit-time transient the sink's
                       ladder must absorb)
  ack_drop_rate        probability a write op is APPLIED but its ack is
                       dropped (the ambiguous-ack / truncated-ack shape:
                       the client must retry idempotently)
  corrupt_part_etag    every part PUT acks with a WRONG CRC ETag (the
                       torn-transfer-acknowledged-as-success shape)

`credentials={access_key: secret}` arms signed mode: EVERY request (reads
included) must carry a valid PQT4-HMAC-SHA256 signature — verified with
the same io.sign code the client signs with — or it answers a typed 403
(counted in `auth_rejects`).

The port's copy of parquet_tpu.testing.httpstub, without the traceparent
record (the port sends none). `python -m parquet_tpu_torch.testing.httpstub
--root DIR [--writable]` serves a directory (and, writable, the multipart
write side) from a process of its own (main() below) and prints its port.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["RangeHttpStub"]

# the knobs a FaultSchedule phase may override here (drop_rate and the
# write-side rates are stub-local and settable only via the
# constructor/attribute)
_STUB_KNOBS = (
    "error_rate", "short_rate", "latency_s", "latency_jitter_s",
    "spike_rate", "spike_s", "permanent", "drop_rate",
    "complete_error_rate", "ack_drop_rate",
)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: the connection-pool shape
    stub: "RangeHttpStub" = None  # set per served stub via type()

    # -- plumbing --------------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet: tests read assertions,
        pass  # not access logs

    def _fail_503(self) -> None:
        body = b'{"error": "injected fault"}'
        self.send_response(503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status: int, obj, *, etag: str | None = None) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        if etag is not None:
            self.send_header("ETag", etag)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n > 0 else b""

    def _query(self) -> dict:
        out = {}
        for kv in self.path.partition("?")[2].split("&"):
            if kv:
                k, _, v = kv.partition("=")
                out[k] = v
        return out

    def _drop(self) -> None:
        # no status line at all: the client sees the connection die
        # (RemoteDisconnected), the transport-fault shape. shutdown, not
        # close — the framework's post-handler wfile.flush() must stay a
        # no-op instead of raising into the server thread
        import socket

        self.close_connection = True
        try:
            self.connection.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    # -- request handling ------------------------------------------------------

    def _serve(self, head_only: bool) -> None:
        stub = self.stub
        p = stub._draw_and_wait()
        if p is None:  # drop was drawn
            self._drop()
            return
        if p["permanent"] or p["__error"]:
            stub._count_fault()
            self._fail_503()
            return
        if stub.credentials is not None:
            # signed mode: reads must verify like writes — symmetric auth
            reason = stub._verify(self, "HEAD" if head_only else "GET", b"")
            if reason is not None:
                body = json.dumps({"error": reason}).encode("utf-8")
                self.send_response(403)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if not head_only:
                    self.wfile.write(body)
                return
        if stub.require_token is not None:
            # the presigned-URL shape: a `token` query param must match
            # the currently-valid signature or the store answers 403 —
            # the ObjectStoreSource reactive re-sign adversary
            query = self.path.partition("?")[2]
            tokens = [
                kv.partition("=")[2]
                for kv in query.split("&")
                if kv.startswith("token=")
            ]
            if stub.require_token not in tokens:
                body = b'{"error": "signature rejected"}'
                self.send_response(403)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if not head_only:
                    self.wfile.write(body)
                return
        name = self.path.lstrip("/").split("?", 1)[0]
        entry = stub._entry(name)
        if entry is None:
            body = b'{"error": "no such object"}'
            self.send_response(404)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if not head_only:
                self.wfile.write(body)
            return
        data, etag = entry
        size = len(data)
        rng_header = self.headers.get("Range")
        if_range = self.headers.get("If-Range")
        if rng_header is not None and if_range is not None and if_range != etag:
            # RFC 7233 If-Range: a stale validator downgrades the ranged
            # GET to 200 + the FULL current body — the rewrite-mid-scan
            # shape HttpSource must surface as typed source_changed
            rng_header = None
        if rng_header is None or stub.ignore_range:
            status, start, end = 200, 0, size - 1
        elif "," in rng_header and not head_only:
            # multi-range: served as multipart/byteranges, or — with
            # reject_multirange — refused with the 416 a single-range
            # server answers (pins HttpSource's per-range fallback)
            spans = (
                None
                if stub.reject_multirange
                else stub._parse_ranges(rng_header, size)
            )
            if spans is None:
                self.send_response(416)
                self.send_header("Content-Range", f"bytes */{size}")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            with stub._lock:
                stub.multirange_requests += 1
            self._send_multipart(data, spans, etag)
            return
        else:
            span = stub._parse_range(rng_header, size)
            if span is None:
                self.send_response(416)
                self.send_header("Content-Range", f"bytes */{size}")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            status, (start, end) = 206, span
        payload = data[start : end + 1] if size else b""
        declared = len(payload)
        truncate_to = stub._maybe_truncate(declared) if not head_only else None
        self.send_response(status)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Accept-Ranges", "bytes")
        if stub.send_etag:
            self.send_header("ETag", etag)
        if status == 206:
            self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
        self.send_header("Content-Length", str(declared))
        if truncate_to is not None:
            # a torn transfer: promise `declared`, deliver less, slam the
            # connection — the client's read raises IncompleteRead
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        if head_only:
            return
        sent = payload if truncate_to is None else payload[:truncate_to]
        try:
            self.wfile.write(sent)
            stub._count_sent(len(sent))
        except OSError:
            self.close_connection = True
        if truncate_to is not None:
            # flush + FIN below the declared length: the client's read
            # comes up short (IncompleteRead), the torn-transfer shape
            import socket

            try:
                self.wfile.flush()
                self.connection.shutdown(socket.SHUT_RDWR)
            except (OSError, ValueError):
                pass

    _MR_BOUNDARY = "pqt_stub_byteranges"

    def _send_multipart(self, data: bytes, spans, etag: str) -> None:
        """One 206 multipart/byteranges response: a part per span, each
        with its own Content-Range — exactly the RFC 7233 shape
        HttpSource._read_multirange parses."""
        size = len(data)
        b = self._MR_BOUNDARY
        chunks = []
        for start, end in spans:
            chunks.append(
                (
                    f"--{b}\r\n"
                    "Content-Type: application/octet-stream\r\n"
                    f"Content-Range: bytes {start}-{end}/{size}\r\n\r\n"
                ).encode()
                + data[start : end + 1]
                + b"\r\n"
            )
        chunks.append(f"--{b}--\r\n".encode())
        body = b"".join(chunks)
        self.send_response(206)
        self.send_header(
            "Content-Type", f"multipart/byteranges; boundary={b}"
        )
        self.send_header("Accept-Ranges", "bytes")
        if self.stub.send_etag:
            self.send_header("ETag", etag)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
            self.stub._count_sent(len(body))
        except OSError:
            self.close_connection = True

    def do_GET(self):
        self._serve(head_only=False)

    def do_HEAD(self):
        if self.stub.reject_head:
            body = b""
            self.send_response(405)
            self.send_header("Content-Length", "0")
            self.send_header("Allow", "GET")
            self.end_headers()
            self.wfile.write(body)
            return
        self._serve(head_only=True)

    # -- the write side (multipart object-store mode) --------------------------

    def do_PUT(self):
        self._write_op("PUT")

    def do_POST(self):
        self._write_op("POST")

    def do_DELETE(self):
        self._write_op("DELETE")

    def _write_op(self, method: str) -> None:
        stub = self.stub
        # the body is read BEFORE the fault draw: a dropped connection
        # must model an ack lost in flight, not a request never sent
        body = self._read_body()
        p = stub._draw_and_wait()
        if p is None:
            self._drop()
            return
        if p["permanent"] or p["__error"]:
            stub._count_fault()
            self._fail_503()
            return
        if not stub.writable:
            self._json(405, {"error": "read-only stub"})
            return
        if stub.credentials is not None:
            reason = stub._verify(self, method, body)
            if reason is not None:
                self._json(403, {"error": reason})
                return
        name = self.path.lstrip("/").split("?", 1)[0]
        q = self._query()
        if method == "POST" and "uploads" in q:
            self._mp_initiate(name)
        elif method == "PUT" and "partNumber" in q and "uploadId" in q:
            self._mp_part(name, q, body)
        elif method == "POST" and "uploadId" in q:
            self._mp_complete(name, q, body)
        elif method == "DELETE" and "uploadId" in q:
            self._mp_abort(q)
        elif method == "PUT" and not q:
            self._put_object(name, body)
        else:
            self._json(400, {"error": f"unsupported write operation {method} {self.path}"})

    @staticmethod
    def _crc_etag(data: bytes) -> str:
        return f'"crc32-{zlib.crc32(data) & 0xFFFFFFFF:08x}"'

    def _mp_initiate(self, name: str) -> None:
        stub = self.stub
        with stub._lock:
            uid = f"upload-{next(stub._upload_seq):06d}"
            stub._uploads[uid] = {"name": name, "parts": {}}
            stub.uploads_started += 1
        if stub._draw_rate("ack_drop_rate"):
            # the upload EXISTS but the client never learns its id — the
            # orphan a real store reaps by lifecycle rule, never a torn
            # object
            self._drop()
            return
        self._json(200, {"upload_id": uid})

    def _mp_part(self, name: str, q: dict, body: bytes) -> None:
        stub = self.stub
        try:
            pn = int(q.get("partNumber", ""))
        except ValueError:
            self._json(400, {"error": "malformed partNumber"})
            return
        with stub._lock:
            up = stub._uploads.get(q.get("uploadId", ""))
            if up is None or up["name"] != name:
                self._json(404, {"error": "no such upload"})
                return
            # storing by part number makes the retry of an ambiguous ack
            # idempotent: same part, same slot
            up["parts"][pn] = bytes(body)
            stub.put_requests += 1
        etag = (
            '"crc32-deadbeef"'
            if stub.corrupt_part_etag
            else self._crc_etag(body)
        )
        if stub._draw_rate("ack_drop_rate"):
            self._drop()  # part stored, ack lost: the truncated-ack shape
            return
        self._json(200, {"part_number": pn}, etag=etag)

    def _mp_complete(self, name: str, q: dict, body: bytes) -> None:
        stub = self.stub
        uid = q.get("uploadId", "")
        with stub._lock:
            done = stub._completed.get(uid)
        if done is not None:
            # idempotent replay of a commit whose ack was lost — answering
            # anything else would turn one ambiguous ack into a client
            # that can never learn its object committed
            self._json(200, {"etag": done})
            return
        with stub._lock:
            up = stub._uploads.get(uid)
            parts = dict(up["parts"]) if up is not None else None
        if up is None or up["name"] != name:
            self._json(404, {"error": "no such upload"})
            return
        try:
            listed = [
                (int(p["part_number"]), str(p["etag"]), int(p["size"]))
                for p in json.loads(body.decode("utf-8"))["parts"]
            ]
        except (ValueError, KeyError, TypeError):
            self._json(400, {"error": "malformed manifest"})
            return
        if not listed:
            self._json(400, {"error": "empty manifest"})
            return
        for pn, etag, size in listed:
            data = parts.get(pn)
            if (
                data is None
                or len(data) != size
                or self._crc_etag(data) != etag
            ):
                self._json(400, {"error": f"part {pn} mismatch"})
                return
        if stub._draw_rate("complete_error_rate"):
            # the commit-time transient: 500 BEFORE publishing — nothing
            # became visible, the retry ladder gets another shot
            body500 = b'{"error": "injected commit fault"}'
            self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body500)))
            self.end_headers()
            self.wfile.write(body500)
            return
        data = b"".join(parts[pn] for pn, _, _ in sorted(listed))
        obj_etag = self._crc_etag(data)
        with stub._lock:
            # the ATOMIC publish: the object flips visible in one step,
            # full bytes or nothing — there is no code path that installs
            # a prefix
            stub._files[name] = data
            stub._entries.pop(name, None)
            stub._completed[uid] = obj_etag
            stub._uploads.pop(uid, None)
            stub.uploads_completed += 1
        if stub._draw_rate("ack_drop_rate"):
            self._drop()  # committed, ack lost: the replay above answers
            return
        self._json(200, {"etag": obj_etag})

    def _mp_abort(self, q: dict) -> None:
        stub = self.stub
        with stub._lock:
            if q.get("uploadId", "") in stub._uploads:
                del stub._uploads[q["uploadId"]]
                stub.uploads_aborted += 1
        # idempotent: aborting an unknown/done upload is still a 204 (and
        # NEVER touches a published object)
        if stub._draw_rate("ack_drop_rate"):
            self._drop()
            return
        self.send_response(204)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _put_object(self, name: str, body: bytes) -> None:
        stub = self.stub
        etag = (
            '"crc32-deadbeef"'
            if stub.corrupt_part_etag
            else self._crc_etag(body)
        )
        with stub._lock:
            stub._files[name] = bytes(body)
            stub._entries.pop(name, None)
            stub.put_requests += 1
            stub.objects_put += 1
        if stub._draw_rate("ack_drop_rate"):
            self._drop()  # published, ack lost: the retry re-PUTs the
            return  # same bytes (idempotent), never a torn object
        self._json(200, {"etag": etag}, etag=etag)


class RangeHttpStub:
    """See module docstring. Construct, `start()` (or use as a context
    manager), point HttpSource at `url_for(name)`.

    files         {name: bytes} served from memory
    root          a directory; files load (and cache) on first request
    seed          the fault rng seed (one stream across all draws)
    ignore_range  serve 200 + the FULL object even for ranged GETs (the
                  misbehaving-server shape HttpSource must slice through)
    reject_multirange  416 every comma-form Range header (the
                  single-range-only server shape: HttpSource must latch
                  its per-range fallback); default False serves RFC 7233
                  multipart/byteranges (counted in multirange_requests)
    reject_head   405 every HEAD (forces HttpSource's range-GET stat
                  fallback)
    send_etag     False omits the ETag header entirely (the validator-less
                  server shape: only Content-Length can betray a rewrite)
    writable      enable the multipart write protocol (PUT/POST/DELETE)
    credentials   {access_key: secret} arms signed mode on EVERY request
    schedule      a chaos.FaultSchedule overlaying the knobs per request
    """

    def __init__(
        self,
        *,
        files: dict | None = None,
        root=None,
        seed: int = 0,
        error_rate: float = 0.0,
        drop_rate: float = 0.0,
        short_rate: float = 0.0,
        latency_s: float = 0.0,
        latency_jitter_s: float = 0.0,
        spike_rate: float = 0.0,
        spike_s: float = 0.0,
        permanent: bool = False,
        ignore_range: bool = False,
        reject_multirange: bool = False,
        reject_head: bool = False,
        send_etag: bool = True,
        require_token: str | None = None,
        writable: bool = False,
        credentials: dict | None = None,
        complete_error_rate: float = 0.0,
        ack_drop_rate: float = 0.0,
        corrupt_part_etag: bool = False,
        schedule=None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        self._files = {str(k): bytes(v) for k, v in (files or {}).items()}
        self.root = os.fspath(root) if root is not None else None
        if not self._files and self.root is None and not writable:
            raise ValueError(
                "RangeHttpStub: need files= and/or root= (or writable=True)"
            )
        self._rng = np.random.default_rng(seed)
        self.error_rate = float(error_rate)
        self.drop_rate = float(drop_rate)
        self.short_rate = float(short_rate)
        self.latency_s = float(latency_s)
        self.latency_jitter_s = float(latency_jitter_s)
        self.spike_rate = float(spike_rate)
        self.spike_s = float(spike_s)
        self.permanent = bool(permanent)
        self.ignore_range = bool(ignore_range)
        self.reject_multirange = bool(reject_multirange)
        self.reject_head = bool(reject_head)
        self.send_etag = bool(send_etag)
        self.require_token = require_token
        self.writable = bool(writable)
        self.credentials = dict(credentials) if credentials else None
        self.complete_error_rate = float(complete_error_rate)
        self.ack_drop_rate = float(ack_drop_rate)
        self.corrupt_part_etag = bool(corrupt_part_etag)
        self.schedule = schedule
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._entries: dict[str, tuple] = {}  # name -> (bytes, etag)
        self._uploads: dict[str, dict] = {}  # id -> {name, parts{pn: bytes}}
        self._completed: dict[str, str] = {}  # id -> object etag (replays)
        self._upload_seq = itertools.count(1)
        self.requests = 0
        self.faults_injected = 0
        self.bytes_served = 0
        self.multirange_requests = 0  # comma-form Range GETs served multipart
        self.put_requests = 0
        self.objects_put = 0
        self.auth_rejects = 0
        self.uploads_started = 0
        self.uploads_completed = 0
        self.uploads_aborted = 0
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "RangeHttpStub":
        if self._server is not None:
            return self
        handler = type("_StubHandler", (_Handler,), {"stub": self})
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="pqt-httpstub",
            daemon=True,
        )
        self._thread.start()
        return self

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None

    stop = close

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- addressing ------------------------------------------------------------

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("RangeHttpStub: not started")
        return self._server.server_address[1]

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def url_for(self, name: str) -> str:
        return f"{self.base_url}/{name}"

    def set_file(self, name: str, data: bytes) -> None:
        """Publish (or REWRITE — new ETag, the source_changed shape) one
        in-memory object."""
        with self._lock:
            self._files[str(name)] = bytes(data)
            self._entries.pop(str(name), None)

    # -- the zero-torn-object assertion surface --------------------------------

    def has_object(self, name: str) -> bool:
        """Is `name` VISIBLE (published via complete/PUT/set_file)? The
        write-path acceptance pins: False until the writer commits, False
        forever after an abort."""
        with self._lock:
            return str(name) in self._files

    def object_bytes(self, name: str):
        """The published bytes of `name`, or None — byte-identity is the
        other half of the zero-torn contract."""
        with self._lock:
            data = self._files.get(str(name))
            return None if data is None else bytes(data)

    def live_uploads(self) -> int:
        """Uploads initiated but neither completed nor aborted. Zero after
        a clean commit or abort; ambiguous-ack chaos may legitimately
        orphan some (a real store reaps those by lifecycle rule)."""
        with self._lock:
            return len(self._uploads)

    def _verify(self, handler, method: str, payload: bytes):
        """Signed-mode check: same io.sign code path the client signs
        with. Returns None (ok) or the 403 reason."""
        from ..io.sign import verify_request

        reason = verify_request(
            method, handler.path, handler.headers, payload,
            self.credentials.get,
        )
        if reason is not None:
            with self._lock:
                self.auth_rejects += 1
        return reason

    def _draw_rate(self, name: str) -> bool:
        """One seeded draw against the named write-fault rate (same rng
        stream as every other fault — a failing chaos run replays)."""
        with self._lock:
            rate = self._params().get(name) or 0.0
            if rate and float(self._rng.random()) < rate:
                self.faults_injected += 1
                return True
        return False

    # -- handler callbacks -----------------------------------------------------

    @staticmethod
    def _parse_range(header: str, size: int):
        """`bytes=a-b` / `bytes=a-` / `bytes=-n` -> (start, end) clamped
        inclusive, or None for unsatisfiable/malformed (-> 416)."""
        if not header.startswith("bytes=") or "," in header:
            return None  # multi-range is _parse_ranges' job
        spec = header[len("bytes="):].strip()
        first, _, last = spec.partition("-")
        try:
            if first == "":  # suffix form: the last N bytes
                n = int(last)
                if n <= 0 or size == 0:
                    return None
                return (max(0, size - n), size - 1)
            start = int(first)
            end = int(last) if last else size - 1
        except ValueError:
            return None
        if start >= size or end < start:
            return None
        return (start, min(end, size - 1))

    @classmethod
    def _parse_ranges(cls, header: str, size: int):
        """`bytes=a-b,c-d,...` -> [(start, end), ...] in request order,
        or None when any piece is unsatisfiable (-> 416)."""
        if not header.startswith("bytes="):
            return None
        spans = []
        for piece in header[len("bytes="):].split(","):
            span = cls._parse_range(f"bytes={piece.strip()}", size)
            if span is None:
                return None
            spans.append(span)
        return spans or None

    def _entry(self, name: str):
        with self._lock:
            hit = self._entries.get(name)
            if hit is not None:
                return hit
            data = self._files.get(name)
        if data is None and self.root is not None and name:
            realroot = os.path.realpath(self.root)
            path = os.path.normpath(os.path.join(realroot, name))
            # stay inside the root (the stub is a test double, but an
            # escape-serving double invites escape-shaped tests)
            if path.startswith(realroot + os.sep):
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    data = None
        if data is None:
            return None
        etag = f'"{hashlib.sha1(data).hexdigest()[:16]}"'
        with self._lock:
            self._entries[name] = (data, etag)
            return self._entries[name]

    def _params(self) -> dict:
        p = {k: getattr(self, k) for k in _STUB_KNOBS}
        if self.schedule is not None:
            p.update(
                (k, v)
                for k, v in self.schedule.params_at(self._clock()).items()
                if k in p
            )
        return p

    def _draw_and_wait(self):
        """Latency + the per-request fault draw (seeded, lock-serialized).
        Returns the effective params with "__error" resolved, or None when
        the connection should drop."""
        with self._lock:
            self.requests += 1
            p = self._params()
            extra = (
                float(self._rng.uniform(0, p["latency_jitter_s"]))
                if p["latency_jitter_s"]
                else 0.0
            )
            spike = 0.0
            if p["spike_rate"] and float(self._rng.random()) < p["spike_rate"]:
                spike = p["spike_s"]
            roll = (
                float(self._rng.random())
                if (p["error_rate"] or p["drop_rate"])
                else 1.0
            )
            p["__error"] = roll < p["error_rate"]
            dropped = not p["__error"] and roll < p["error_rate"] + p["drop_rate"]
            if p["__error"] or dropped:
                self.faults_injected += 1
        # sleep OUTSIDE the lock: injected latency must overlap across
        # concurrent requests or it models a single-threaded store
        if p["latency_s"] or extra or spike:
            self._sleep(p["latency_s"] + extra + spike)
        return None if dropped else p

    def _maybe_truncate(self, declared: int):
        if declared <= 1:
            return None
        with self._lock:
            rate = self._params()["short_rate"]
            if rate and float(self._rng.random()) < rate:
                self.faults_injected += 1
                return int(self._rng.integers(0, declared))
        return None

    def _count_fault(self) -> None:
        pass  # counted at draw time (one lock acquisition per request)

    def _count_sent(self, n: int) -> None:
        with self._lock:
            self.bytes_served += n


def main(argv=None) -> int:
    """Serve `--root` from this process until its standard input closes:
    the parent holds the pipe, so the stub ends with it. Prints
    "PORT <n>" once it listens. `--writable` arms the multipart write
    side; a committed object is served back by GET."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--latency-s", type=float, default=0.0)
    ap.add_argument("--writable", action="store_true")
    ap.add_argument(
        "--credentials", default=None,
        help="ACCESS:SECRET arms signed mode",
    )
    args = ap.parse_args(argv)
    creds = None
    if args.credentials:
        key, _, secret = args.credentials.partition(":")
        creds = {key: secret}
    with RangeHttpStub(
        root=args.root, seed=args.seed, latency_s=args.latency_s,
        credentials=creds, writable=args.writable,
    ) as stub:
        print(f"PORT {stub.port}", flush=True)
        sys.stdin.read()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
