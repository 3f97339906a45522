"""FlakyReplica: a seeded fault-injecting proxy in front of a LIVE replica.

Where RangeHttpStub fakes an object store, this wraps a real ScanServer
(or any HTTP daemon) and misbehaves at the TRANSPORT layer between the
mesh router and the replica — the layer the MeshClient failover ladder
must absorb. Point a router's --replica at `proxy.url` instead of the
daemon and the daemon's answers stay real; only the wire gets hostile:

    replica = ScanServer(ServeConfig(port=0, root=d)).start_background()
    proxy = FlakyReplica(replica.url, seed=7, error_rate=0.2)
    with proxy:
        router = MeshRouter(MeshConfig(port=0, replicas=(proxy.url, ...)))

Fault knobs (plain attributes, mutable mid-test; every draw comes from
ONE seeded numpy rng stream under a lock, so a failing chaos run replays
exactly — the httpstub discipline):

  error_rate   probability a request answers an injected 503 (code
               "injected_fault") WITHOUT reaching the replica — the
               residual-5xx shape that must feed the breaker
  drop_rate    probability the connection dies with NO status line
               (RemoteDisconnected at the client: the reset/LB-kill
               shape -> typed transport failover)
  short_rate   probability a proxied response body is TRUNCATED below
               its declared Content-Length and the socket slammed — the
               TORN REPLICA STREAM shape: the router must fail over and
               re-fetch, never splice the prefix into its merge
  latency_s    per-request injected RTT (feeds the client's p95 window,
               so hedging tests can arm deterministically)
  spike_rate/spike_s  occasional EXTRA stall (the tail the hedge
               duplicates past)
  permanent    every request 503s (blackout; flip mid-test to model a
               replica dying and recovering without restarting anything)

The proxy reads each backend response FULLY before answering, so every
proxied response is Content-Length framed — which is exactly what makes
`short_rate` a clean torn-transfer: declared N, delivered < N, FIN.

Counters: `requests`, `faults_injected`, `proxied`, and `traceparents`
(every traceparent header seen, in arrival order — the replica-side half
of a propagation pin when tests want the hop recorded at the wire).

The port's copy of parquet_tpu.testing.flaky_replica. The port's mesh
client sends no traceparent, so in front of a port router `traceparents`
stays empty.
"""

from __future__ import annotations

import http.client
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

import numpy as np

__all__ = ["FlakyReplica"]

# headers the proxy must not blindly forward: it re-frames the body with
# Content-Length, and hop-by-hop headers never cross a proxy (RFC 7230)
_HOP_HEADERS = frozenset(
    (
        "connection",
        "content-length",
        "keep-alive",
        "proxy-authenticate",
        "proxy-authorization",
        "te",
        "trailer",
        "transfer-encoding",
        "upgrade",
    )
)


class _ProxyHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    proxy: "FlakyReplica" = None  # set per served proxy via type()

    def log_message(self, fmt, *args):  # quiet: tests read assertions,
        pass  # not access logs

    def _drop(self) -> None:
        # no status line at all: the client sees the connection die
        self.close_connection = True
        try:
            self.connection.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _fail_503(self) -> None:
        body = b'{"error": {"code": "injected_fault", "message": "chaos"}}'
        self.send_response(503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n > 0 else b""

    def _relay(self, method: str) -> None:
        proxy = self.proxy
        proxy._record_traceparent(self.headers.get("traceparent"))
        body = self._read_body()
        verdict = proxy._draw_and_wait()
        if verdict == "drop":
            self._drop()
            return
        if verdict == "error":
            self._fail_503()
            return
        try:
            status, reason, headers, payload = proxy._roundtrip(
                method, self.path, self.headers, body
            )
        except OSError:
            # the REAL replica is down/gone: surface it as the same
            # transport fault a dead host shows — never a fake answer
            self._drop()
            return
        truncate_to = proxy._maybe_truncate(len(payload))
        self.send_response(status, reason)
        for k, v in headers:
            if k.lower() not in _HOP_HEADERS:
                self.send_header(k, v)
        self.send_header("Content-Length", str(len(payload)))
        if truncate_to is not None:
            self.close_connection = True
        self.end_headers()
        if method == "HEAD":
            return
        sent = payload if truncate_to is None else payload[:truncate_to]
        try:
            self.wfile.write(sent)
        except OSError:
            self.close_connection = True
            return
        if truncate_to is not None:
            # promise len(payload), deliver less, FIN: the client's read
            # raises IncompleteRead — the torn replica stream
            try:
                self.wfile.flush()
                self.connection.shutdown(socket.SHUT_RDWR)
            except (OSError, ValueError):
                pass

    def do_GET(self):
        self._relay("GET")

    def do_HEAD(self):
        self._relay("HEAD")

    def do_POST(self):
        self._relay("POST")

    def do_PUT(self):
        self._relay("PUT")

    def do_DELETE(self):
        self._relay("DELETE")


class FlakyReplica:
    """See module docstring. Construct with the live replica's base URL,
    `start()` (or use as a context manager), route traffic at `url`."""

    def __init__(
        self,
        backend_url: str,
        *,
        seed: int = 0,
        error_rate: float = 0.0,
        drop_rate: float = 0.0,
        short_rate: float = 0.0,
        latency_s: float = 0.0,
        spike_rate: float = 0.0,
        spike_s: float = 0.0,
        permanent: bool = False,
        backend_timeout_s: float = 30.0,
        sleep=time.sleep,
    ):
        parts = urlsplit(backend_url)
        if parts.scheme != "http" or not parts.hostname:
            raise ValueError(
                f"FlakyReplica: need an http://host:port backend, "
                f"got {backend_url!r}"
            )
        self.backend_host = parts.hostname
        self.backend_port = parts.port or 80
        self._rng = np.random.default_rng(seed)
        self.error_rate = float(error_rate)
        self.drop_rate = float(drop_rate)
        self.short_rate = float(short_rate)
        self.latency_s = float(latency_s)
        self.spike_rate = float(spike_rate)
        self.spike_s = float(spike_s)
        self.permanent = bool(permanent)
        self.backend_timeout_s = float(backend_timeout_s)
        self._sleep = sleep
        self._lock = threading.Lock()
        self.requests = 0
        self.faults_injected = 0
        self.proxied = 0
        self.traceparents: list = []
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "FlakyReplica":
        if self._server is not None:
            return self
        handler = type("_FlakyHandler", (_ProxyHandler,), {"proxy": self})
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="pqt-flaky-replica",
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

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("FlakyReplica: not started")
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- the backend hop -------------------------------------------------------

    def _roundtrip(self, method, path, headers, body):
        """One fresh-connection round trip to the real replica; the whole
        body is read here so the proxy re-frames with Content-Length."""
        conn = http.client.HTTPConnection(
            self.backend_host, self.backend_port,
            timeout=self.backend_timeout_s,
        )
        try:
            fwd = {
                k: v
                for k, v in headers.items()
                if k.lower() not in _HOP_HEADERS and k.lower() != "host"
            }
            conn.request(method, path, body=body or None, headers=fwd)
            resp = conn.getresponse()
            payload = b"" if method == "HEAD" else resp.read()
            out = (resp.status, resp.reason, resp.getheaders(), payload)
        finally:
            conn.close()
        with self._lock:
            self.proxied += 1
        return out

    # -- seeded fault draws ----------------------------------------------------

    def _draw_and_wait(self) -> str:
        """Latency + the per-request fault draw (seeded, lock-serialized).
        Returns "ok", "error", or "drop"."""
        with self._lock:
            self.requests += 1
            spike = 0.0
            if self.spike_rate and float(self._rng.random()) < self.spike_rate:
                spike = self.spike_s
            verdict = "ok"
            if self.permanent:
                verdict = "error"
            elif self.error_rate or self.drop_rate:
                roll = float(self._rng.random())
                if roll < self.error_rate:
                    verdict = "error"
                elif roll < self.error_rate + self.drop_rate:
                    verdict = "drop"
            if verdict != "ok":
                self.faults_injected += 1
        # sleep OUTSIDE the lock: injected latency must overlap across
        # concurrent requests or it models a single-threaded replica
        if self.latency_s or spike:
            self._sleep(self.latency_s + spike)
        return verdict

    def _maybe_truncate(self, declared: int):
        if declared <= 1:
            return None
        with self._lock:
            if self.short_rate and float(self._rng.random()) < self.short_rate:
                self.faults_injected += 1
                return int(self._rng.integers(0, declared))
        return None

    def _record_traceparent(self, raw) -> None:
        if raw is not None:
            with self._lock:
                self.traceparents.append(str(raw))
