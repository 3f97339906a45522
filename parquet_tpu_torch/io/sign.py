"""Request signing: SigV4-style header auth for remote reads AND writes.

io.remote.ObjectStoreSource covers the *presigned URL* shape — the store
hands out a rotating `?token=...` query and judges it server-side. This
module adds the other half of real object-store auth: HEADER signing,
where the client holds long-lived credentials and signs every request
itself (the AWS SigV4 family). The scheme here, `PQT4-HMAC-SHA256`, is a
faithful structural clone of SigV4 — canonical request -> string-to-sign
-> derived-key HMAC chain — with its own prefix so nothing ever mistakes
it for a real AWS signature:

    x-pqt-date            YYYYMMDDTHHMMSSZ (the signer's injectable clock)
    x-pqt-content-sha256  hex SHA-256 of the request payload (b"" for
                          GET/HEAD) — the body is IN the signature, so a
                          tampered part PUT fails verification
    Authorization         PQT4-HMAC-SHA256 Credential=<key>/<scope>,
                          SignedHeaders=host;x-pqt-content-sha256;
                          x-pqt-date, Signature=<hex>

Symmetry is the point: `SigV4Signer.headers()` (the client) and
`verify_request()` (the server — testing/httpstub.py's signed mode) share
ONE canonicalization, so a signature the stub accepts is bit-identical to
what the client computed — signed GETs and signed PUTs are provable
hermetically in the same test.

Wiring: `configure_signer(signer, prefix=...)` registers a signer for a
URL prefix (longest prefix wins); `signer_for(url)` is consulted by
HttpSource and HttpSink at construction when no explicit signer is
passed — so `open_source("https://...")` / `open_sink` coercion pick up
signing with zero per-callsite plumbing. Every signed request counts
io_sign_requests_total{method=} (io.counts).

The port's copy of parquet_tpu.io.sign: the same canonicalization, so a
signature either package computes verifies in the other.
"""

from __future__ import annotations

import calendar as _calendar
import hashlib
import hmac
import threading
import time
from urllib.parse import urlsplit

from .counts import count as _count

__all__ = [
    "SigV4Signer",
    "sign_headers",
    "verify_request",
    "configure_signer",
    "signer_for",
    "clear_signers",
]

_SCHEME = "PQT4-HMAC-SHA256"
_TERMINATOR = "pqt4_request"
# the headers every PQT4 signature covers, in canonical (sorted) order
_SIGNED_HEADERS = "host;x-pqt-content-sha256;x-pqt-date"
_DEFAULT_SKEW_S = 300.0


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


def _canonical_query(query: str) -> str:
    """Sorted `k=v` pairs — the pair ORDER must not change the signature
    (clients build query strings in whatever order), but the pair CONTENT
    must (swapping partNumber between two uploads is an attack). Values
    are taken as transmitted: both sides canonicalize the same raw string,
    so no re-encoding pass is needed (or wanted — it would have to agree
    byte-for-byte with every client's encoder)."""
    if not query:
        return ""
    return "&".join(sorted(query.split("&")))


def _canonical_request(
    method: str, path: str, query: str, host: str, date: str, payload_hash: str
) -> str:
    canonical_headers = (
        f"host:{host.strip()}\n"
        f"x-pqt-content-sha256:{payload_hash}\n"
        f"x-pqt-date:{date}\n"
    )
    return "\n".join(
        (
            method.upper(),
            path or "/",
            _canonical_query(query),
            canonical_headers,
            _SIGNED_HEADERS,
            payload_hash,
        )
    )


def _scope(datestamp: str, region: str, service: str) -> str:
    return f"{datestamp}/{region}/{service}/{_TERMINATOR}"


def _signing_key(
    secret_key: str, datestamp: str, region: str, service: str
) -> bytes:
    """The SigV4 key-derivation chain: the long-lived secret never signs a
    request directly — a per-(day, region, service) key does, so a leaked
    derived key expires with its scope."""
    k = _hmac(("PQT4" + secret_key).encode("utf-8"), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, _TERMINATOR)


def _signature(
    secret_key: str,
    method: str,
    path: str,
    query: str,
    host: str,
    date: str,
    payload_hash: str,
    region: str,
    service: str,
) -> str:
    datestamp = date[:8]
    creq = _canonical_request(method, path, query, host, date, payload_hash)
    string_to_sign = "\n".join(
        (
            _SCHEME,
            date,
            _scope(datestamp, region, service),
            _sha256_hex(creq.encode("utf-8")),
        )
    )
    key = _signing_key(secret_key, datestamp, region, service)
    return hmac.new(
        key, string_to_sign.encode("utf-8"), hashlib.sha256
    ).hexdigest()


def sign_headers(
    method: str,
    url: str,
    payload: bytes = b"",
    *,
    access_key: str,
    secret_key: str,
    region: str = "local",
    service: str = "pqt",
    clock=time.time,
) -> dict:
    """The headers that make one request verifiable: x-pqt-date,
    x-pqt-content-sha256, Authorization. Pure function of (request,
    credentials, clock) — the functional core SigV4Signer wraps."""
    split = urlsplit(url)
    host = split.netloc
    date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(clock()))
    payload_hash = _sha256_hex(bytes(payload))
    sig = _signature(
        secret_key,
        method,
        split.path or "/",
        split.query,
        host,
        date,
        payload_hash,
        region,
        service,
    )
    credential = f"{access_key}/{_scope(date[:8], region, service)}"
    return {
        "x-pqt-date": date,
        "x-pqt-content-sha256": payload_hash,
        "Authorization": (
            f"{_SCHEME} Credential={credential}, "
            f"SignedHeaders={_SIGNED_HEADERS}, Signature={sig}"
        ),
    }


class SigV4Signer:
    """A bound (credentials, region/service scope, clock) that signs
    requests. Thread-safe (stateless past construction); the clock is
    injectable so tests pin the date and replay exact signatures."""

    def __init__(
        self,
        access_key: str,
        secret_key: str,
        *,
        region: str = "local",
        service: str = "pqt",
        clock=time.time,
    ):
        if not access_key or not secret_key:
            raise ValueError("SigV4Signer: access_key and secret_key required")
        self.access_key = str(access_key)
        self._secret_key = str(secret_key)
        self.region = str(region)
        self.service = str(service)
        self._clock = clock

    def headers(self, method: str, url: str, payload: bytes = b"") -> dict:
        """Headers to merge into one outgoing request (counted per sign)."""
        _count("io_sign_requests_total", method=str(method).upper())
        return sign_headers(
            method,
            url,
            payload,
            access_key=self.access_key,
            secret_key=self._secret_key,
            region=self.region,
            service=self.service,
            clock=self._clock,
        )

    def __repr__(self) -> str:  # never leak the secret into logs
        return (
            f"SigV4Signer(access_key={self.access_key!r}, "
            f"region={self.region!r}, service={self.service!r})"
        )


def _parse_authorization(value: str):
    """-> (access_key, scope, signed_headers, signature) or None."""
    if not value or not value.startswith(_SCHEME + " "):
        return None
    fields = {}
    for part in value[len(_SCHEME) + 1 :].split(","):
        k, sep, v = part.strip().partition("=")
        if sep:
            fields[k] = v
    credential = fields.get("Credential", "")
    key, sep, scope = credential.partition("/")
    if not sep or not key:
        return None
    return (
        key,
        scope,
        fields.get("SignedHeaders", ""),
        fields.get("Signature", ""),
    )


def verify_request(
    method: str,
    target: str,
    headers,
    payload: bytes,
    secret_for,
    *,
    host: str | None = None,
    clock=time.time,
    max_skew_s: float = _DEFAULT_SKEW_S,
) -> str | None:
    """Server-side verification (httpstub's signed mode): returns None when
    the request verifies, else a short reason string for the 403 body.

    `headers` is any Mapping with case-insensitive .get (http.client's
    HTTPMessage qualifies); `secret_for(access_key)` returns the secret or
    None for an unknown key; `host` overrides the received Host header
    (proxies). Constant-time signature compare; the payload hash is
    checked FIRST so a tampered body fails even before key lookup."""
    auth = _parse_authorization(headers.get("Authorization") or "")
    if auth is None:
        return "missing_or_malformed_authorization"
    access_key, scope, signed_headers, signature = auth
    if signed_headers != _SIGNED_HEADERS:
        return "unexpected_signed_headers"
    date = headers.get("x-pqt-date") or ""
    if len(date) != 16 or not date.endswith("Z"):
        return "missing_or_malformed_date"
    try:
        then = _calendar.timegm(time.strptime(date, "%Y%m%dT%H%M%SZ"))
    except ValueError:
        return "missing_or_malformed_date"
    if abs(clock() - then) > max_skew_s:
        return "date_skew"
    declared_hash = headers.get("x-pqt-content-sha256") or ""
    if not hmac.compare_digest(declared_hash, _sha256_hex(bytes(payload))):
        return "payload_hash_mismatch"
    secret = secret_for(access_key)
    if secret is None:
        return "unknown_access_key"
    scope_parts = scope.split("/")
    if (
        len(scope_parts) != 4
        or scope_parts[0] != date[:8]
        or scope_parts[3] != _TERMINATOR
    ):
        return "malformed_scope"
    _, region, service, _ = scope_parts
    path, _, query = target.partition("?")
    expected = _signature(
        secret,
        method,
        path or "/",
        query,
        host if host is not None else (headers.get("Host") or ""),
        date,
        declared_hash,
        region,
        service,
    )
    if not hmac.compare_digest(expected, signature):
        return "signature_mismatch"
    return None


# -- the signer registry (what open_source/open_sink coercion consults) --------

_registry_lock = threading.Lock()
_registry: list[tuple[str, object]] = []  # (url prefix, signer)


def configure_signer(signer, *, prefix: str = "") -> None:
    """Register `signer` for URLs starting with `prefix` ("" = every URL).
    Longest matching prefix wins at lookup; passing signer=None removes
    the prefix's entry. Consulted at SOURCE/SINK CONSTRUCTION — sources
    already open keep the signer they resolved."""
    with _registry_lock:
        _registry[:] = [(p, s) for p, s in _registry if p != prefix]
        if signer is not None:
            _registry.append((prefix, signer))
            _registry.sort(key=lambda ps: len(ps[0]), reverse=True)


def signer_for(url: str):
    """The registered signer whose prefix matches `url` (longest wins), or
    None — the default header-auth resolution for HttpSource/HttpSink."""
    with _registry_lock:
        for prefix, signer in _registry:
            if url.startswith(prefix):
                return signer
    return None


def clear_signers() -> None:
    """Drop every registered signer (test teardown)."""
    with _registry_lock:
        _registry.clear()
