"""Cross-process trace propagation: the W3C-traceparent-shaped header.

Every telemetry primitive so far stops at the process boundary: a
DecodeTrace's span tree covers one daemon, the flight recorder one ring,
and a request that fans out to a remote object store (or, soon, across a
router to N sharded daemons) fractures into disconnected traces with no
shared key. This module is the Dapper-style joint: one context —
trace-id / span-id / flags, wire-shaped exactly like a W3C `traceparent`
header (`00-<32 hex>-<16 hex>-<2 hex>`) — minted (or adopted) per request
scope and injected into EVERY outbound HTTP call the request makes:

  * `HttpSource` / `ObjectStoreSource` range GETs (io/remote.py),
    including the serve daemon's `--remote-map` fetches, which resolve to
    the same transport;
  * `HttpSink` multipart initiate / part PUTs / complete (io/remote_sink);

so a store-side access log (or the loopback httpstub, which records the
headers it receives) lines up with the daemon's flight record on one
trace-id, and `parquet-tool trace-merge` can stitch the per-process
Perfetto documents into one timeline.

Discipline, in order of importance:

  * propagation is CONTEXT, not globals: the binding rides a contextvar,
    so instrumented_submit carries it across pqt-* pool hops exactly like
    the decode trace and log context — and library reads outside any
    request scope propagate NOTHING (no header, no counter bump);
  * inbound values are hostile until proven hex: `resolve_inbound()`
    sanitizes like X-Request-Id — a malformed, all-zero or oversized
    header is counted (`io_traceparent_inbound_total{result="invalid"}`)
    and REPLACED by a freshly minted context, never echoed back raw;
  * every outbound call gets its OWN child span-id under the bound
    trace-id (a retry storm is distinguishable per attempt in the store's
    log), and every injection counts
    `io_traceparent_injected_total{transport="get"|"put"}`.

`merge_chrome_traces()` is the offline half: given N Chrome-trace
documents whose `otherData.propagation.trace_id` agree, it re-lanes each
document onto its own pid (with a process_name metadata event) and emits
ONE Perfetto-loadable document — the daemon's spans and the remote
client's spans side by side under the shared trace-id.
"""

from __future__ import annotations

import os
import re
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass

from ..utils import metrics as _metrics

__all__ = [
    "TraceContext",
    "mint",
    "parse_traceparent",
    "format_traceparent",
    "current_context",
    "propagation_scope",
    "outbound_traceparent",
    "resolve_inbound",
    "merge_chrome_traces",
]

_VERSION = "00"
# strict wire shape: version-traceid-spanid-flags, lowercase hex only.
# Version "ff" is forbidden by the spec; all-zero ids are "absent".
_TRACEPARENT_RE = re.compile(
    r"\A([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})\Z"
)
_MAX_HEADER = 128  # sanitization bound, like request ids: hostile input
#                    is length-capped before the regex ever runs


@dataclass(frozen=True)
class TraceContext:
    """One propagation binding: the request's trace-id plus the span-id
    of the CURRENT hop (the daemon's own span when inbound, a per-call
    child span when outbound)."""

    trace_id: str  # 32 lowercase hex, never all-zero
    span_id: str  # 16 lowercase hex, never all-zero
    flags: str = "01"  # 01 = sampled (we always record; flags pass through)

    def header(self) -> str:
        return f"{_VERSION}-{self.trace_id}-{self.span_id}-{self.flags}"

    def child(self) -> "TraceContext":
        """A fresh span under the same trace — one per outbound call, so
        each attempt/part/range is individually addressable."""
        return TraceContext(self.trace_id, _rand_hex(8), self.flags)


def _rand_hex(nbytes: int) -> str:
    """`nbytes` of os.urandom as lowercase hex, re-drawn on the (2^-64 at
    worst) all-zero value the spec reserves for "absent"."""
    while True:
        h = os.urandom(nbytes).hex()
        if int(h, 16):
            return h


def mint(flags: str = "01") -> TraceContext:
    """A brand-new context: fresh trace-id, fresh span-id."""
    return TraceContext(_rand_hex(16), _rand_hex(8), flags)


def parse_traceparent(raw) -> TraceContext | None:
    """Strict parse of one traceparent header value: None unless it is
    exactly version-traceid-spanid-flags lowercase hex with non-zero ids
    and a known-parseable version (ff is reserved)."""
    if raw is None:
        return None
    s = str(raw).strip()
    if len(s) > _MAX_HEADER:
        return None
    m = _TRACEPARENT_RE.match(s)
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff":
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return TraceContext(trace_id, span_id, flags)


def format_traceparent(ctx: TraceContext) -> str:
    return ctx.header()


_ctx_var: ContextVar = ContextVar("pqt_trace_context", default=None)


def current_context() -> TraceContext | None:
    """The propagation context bound in this execution context, or None
    (library use outside any request scope)."""
    return _ctx_var.get()


@contextmanager
def propagation_scope(ctx: TraceContext | None):
    """Bind `ctx` for the enclosed block — including pool work submitted
    through instrumented_submit (contextvars carry, exactly like the
    decode trace and the log context). None binds nothing-propagates."""
    token = _ctx_var.set(ctx)
    try:
        yield ctx
    finally:
        _ctx_var.reset(token)


def outbound_traceparent(transport: str | None = None) -> str | None:
    """The header value for ONE outbound HTTP call: a fresh child span-id
    under the bound trace, or None when no scope is bound (reads outside
    a request propagate nothing). `transport` ("get"/"put") counts the
    injection; None skips the counter (the caller counts)."""
    ctx = _ctx_var.get()
    if ctx is None:
        return None
    if transport is not None:
        _metrics.inc("io_traceparent_injected_total", transport=transport)
    return ctx.child().header()


def resolve_inbound(raw) -> tuple[TraceContext, str]:
    """Resolve a client-supplied traceparent header into the context this
    request runs under — the X-Request-Id discipline applied to trace
    context. Returns (context, result):

      accepted   valid header: ADOPT the trace-id, mint a fresh span-id
                 for this hop (never reuse the caller's span-id as ours)
      minted     no header: a brand-new context
      invalid    malformed/all-zero/oversized: counted, replaced by mint

    Every outcome counts io_traceparent_inbound_total{result=}."""
    if raw is None:
        ctx, result = mint(), "minted"
    else:
        parsed = parse_traceparent(raw)
        if parsed is None:
            ctx, result = mint(), "invalid"
        else:
            ctx = TraceContext(parsed.trace_id, _rand_hex(8), parsed.flags)
            result = "accepted"
    _metrics.inc("io_traceparent_inbound_total", result=result)
    return ctx, result


# -- offline stitching ---------------------------------------------------------


def merge_chrome_traces(docs, labels=None) -> dict:
    """Stitch N Chrome-trace documents into one on their shared trace-id.

    Each input keeps its events verbatim but moves to its OWN pid lane
    (input order), with a process_name metadata event naming the lane
    (`labels[i]`, else the document's recorded request endpoint, else
    "process-<i>"). Documents that carry `otherData.propagation.trace_id`
    must all agree — mixing trace-ids is a caller error (you are merging
    two unrelated requests), raised as ValueError. Timebases are NOT
    aligned: each process's ts values are relative to its own trace
    start, which is what per-process lanes in Perfetto present anyway.
    """
    docs = list(docs)
    if not docs:
        raise ValueError("trace-merge: no input documents")
    trace_ids = []
    for i, doc in enumerate(docs):
        if not isinstance(doc, dict) or "traceEvents" not in doc:
            raise ValueError(
                f"trace-merge: input {i} is not a Chrome-trace document "
                "(no traceEvents)"
            )
        tid = (doc.get("otherData") or {}).get("propagation", {}).get(
            "trace_id"
        )
        if tid is not None:
            trace_ids.append(tid)
    if len(set(trace_ids)) > 1:
        raise ValueError(
            "trace-merge: inputs span "
            f"{len(set(trace_ids))} distinct trace ids "
            f"({sorted(set(trace_ids))}) — merge stitches ONE request's "
            "processes, not unrelated traces"
        )
    merged_events = []
    sources = []
    for i, doc in enumerate(docs):
        other = doc.get("otherData") or {}
        label = None
        if labels is not None and i < len(labels):
            label = labels[i]
        if label is None:
            label = (other.get("request") or {}).get("endpoint")
        if label is None:
            label = f"process-{i}"
        merged_events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": i,
                "tid": 0,
                "ts": 0,
                "dur": 0,
                "args": {"name": str(label)},
            }
        )
        for ev in doc["traceEvents"]:
            ev = dict(ev)
            ev["pid"] = i
            merged_events.append(ev)
        sources.append(
            {
                "label": str(label),
                "events": len(doc["traceEvents"]),
                "request": other.get("request"),
            }
        )
    out = {
        "traceEvents": merged_events,
        "displayTimeUnit": "ms",
        "otherData": {"merged_from": sources},
    }
    if trace_ids:
        out["otherData"]["propagation"] = {"trace_id": trace_ids[0]}
    return out
