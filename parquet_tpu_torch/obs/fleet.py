"""Fleet metrics federation: N replica expositions merged into one view.

The ROADMAP's multi-host serve puts N daemons behind a router, and the
first operational question is "what is the FLEET doing" — total request
rate, total bytes, the latency distribution across every replica — not N
browser tabs of per-process `/metrics`. This module is the scatter-gather
seed: scrape each replica's exposition (concurrently, on the pqt-io pool,
with the request's traceparent injected like any other outbound call),
parse the classic Prometheus text format, and merge families EXACTLY:

  counters     arithmetic sum per identical label set — the merged line is
               byte-for-byte the sum of the replica lines (integer counters
               stay integers; the render is the registry's own `f"{v}"`);
  histograms   bucket counts, `_sum` and `_count` add per label set —
               cumulative buckets stay cumulative, quantile math done on
               the merged distribution is done on the true fleet data;
  gauges       NOT summed (a sum of uptimes is meaningless): each replica
               keeps its sample, tagged with a `replica="host:port"` label
               so one exposition carries every replica's value.

Merging is strict where it must be (a family typed counter on one replica
and gauge on another is a deploy skew bug — ValueError, not a guess) and
forgiving where it can be (a replica that fails to scrape is reported in
`errors` and excluded; the merge covers the replicas that answered).

Served two ways, same engine: `parquet-tool debug --fleet URL...` for the
operator's terminal, and `GET /v1/debug/fleet?peers=host:port,...` on any
daemon — meaning any replica can present the fleet view, which is exactly
the shape the future router inherits.

Families: fleet_scrapes_total{outcome=}, fleet_replicas (last merge).
"""

from __future__ import annotations

import re
import urllib.parse
import urllib.request
from dataclasses import dataclass

from ..utils import metrics as _metrics
from . import propagate as _propagate

__all__ = [
    "ReplicaScrape",
    "normalize_peer",
    "parse_exposition",
    "merge_expositions",
    "scrape_fleet",
    "federate",
]


def normalize_peer(peer: str) -> str:
    """A fleet peer spec as a scrape URL: bare `host:port` gains http://
    and a path-less URL gains /metrics — so `127.0.0.1:8081` and a full
    URL both work, on the server's `?peers=` and the CLI's `--fleet`."""
    url = peer if "://" in peer else f"http://{peer}"
    if urllib.parse.urlsplit(url).path in ("", "/"):
        url = url.rstrip("/") + "/metrics"
    return url

# one sample line: name, optional {labels} block (label values are quoted
# strings with backslash escapes — the only place '}' or ' ' may legally
# appear), the value, and an optional OpenMetrics exemplar we discard
_SAMPLE_RE = re.compile(
    r"\A([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\",?)*)\})?"
    r"\s+(\S+)"
    r"(?:\s+#\s.*)?\Z"
)
_LABEL_RE = re.compile(r"([a-zA-Z_][a-zA-Z0-9_]*)=\"((?:[^\"\\]|\\.)*)\"")


def _num(s: str):
    """int when the text is an int — so summed integer counters render
    back as integers, byte-for-byte with a native registry render."""
    try:
        return int(s)
    except ValueError:
        return float(s)


@dataclass
class _Family:
    name: str
    kind: str
    help: str | None
    # insertion-ordered: (sample_name, ((label, raw_value), ...)) -> number
    samples: dict


@dataclass
class ReplicaScrape:
    """One replica's scrape outcome: exactly one of text/error is set."""

    replica: str
    url: str
    text: str | None
    error: str | None


def parse_exposition(text: str) -> dict:
    """Parse one classic (or OpenMetrics) text exposition into an ordered
    {family_name: _Family} dict. Samples are grouped under the most recent
    `# TYPE` header, which is how both of the registry's renderers emit
    them; a sample with no preceding header gets an `untyped` family of
    its own name."""
    families: dict = {}
    current: _Family | None = None
    for line in text.splitlines():
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                name, kind = parts[2], parts[3] if len(parts) > 3 else "untyped"
                current = families.get(name)
                if current is None:
                    current = _Family(name, kind, None, {})
                    families[name] = current
                elif current.kind == "untyped":
                    # a # HELP line preceded its # TYPE (the classic
                    # render order) — adopt the type now it's declared
                    current.kind = kind
                elif current.kind != kind:
                    raise ValueError(
                        f"fleet: family {name} re-typed {current.kind} -> "
                        f"{kind} within one exposition"
                    )
            elif len(parts) >= 3 and parts[1] == "HELP":
                fam = families.get(parts[2])
                doc = parts[3] if len(parts) > 3 else ""
                if fam is not None and fam.help is None:
                    fam.help = doc
                elif fam is None:
                    current = _Family(parts[2], "untyped", doc, {})
                    families[parts[2]] = current
            # any other comment (# EOF, exemplarish noise): skipped
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"fleet: unparseable sample line: {line!r}")
        sname, labels_raw, value = m.group(1), m.group(2), m.group(3)
        labels = tuple(sorted(_LABEL_RE.findall(labels_raw or "")))
        fam = current
        # classic format guarantees samples follow their header; guard the
        # case where they don't (or the header named a different family —
        # OpenMetrics counters drop _total in TYPE but not in samples)
        if fam is None or not sname.startswith(fam.name):
            fam = families.get(sname)
            if fam is None:
                fam = _Family(sname, "untyped", None, {})
                families[sname] = fam
        fam.samples[(sname, labels)] = _num(value)
    return families


def _render_sample(sname: str, labels: tuple, value) -> str:
    if labels:
        inner = ",".join(f'{k}="{v}"' for k, v in labels)
        return f"{sname}{{{inner}}} {value}"
    return f"{sname} {value}"


def merge_expositions(texts, replicas) -> str:
    """Merge per-replica exposition texts into one classic exposition.

    `replicas` labels each text (same order) — it becomes the `replica=`
    label on gauge samples. Counter and histogram samples with identical
    label sets sum exactly; family order and within-family sample order
    follow first appearance across the inputs, so two merges of the same
    fleet render identically."""
    texts = list(texts)
    replicas = list(replicas)
    if len(texts) != len(replicas):
        raise ValueError("fleet: one replica label per exposition required")
    docs = [parse_exposition(t) for t in texts]

    order: list = []
    kinds: dict = {}
    helps: dict = {}
    for doc in docs:
        for name, fam in doc.items():
            if name not in kinds:
                order.append(name)
                kinds[name] = fam.kind
                helps[name] = fam.help
            else:
                if fam.kind != kinds[name] and "untyped" not in (
                    fam.kind,
                    kinds[name],
                ):
                    raise ValueError(
                        f"fleet: family {name} is {kinds[name]} on one "
                        f"replica and {fam.kind} on another — refusing to "
                        "merge mismatched types (deploy skew?)"
                    )
                if helps[name] is None:
                    helps[name] = fam.help

    lines: list = []
    for name in order:
        if helps[name]:
            lines.append(f"# HELP {name} {helps[name]}")
        lines.append(f"# TYPE {name} {kinds[name]}")
        if kinds[name] == "gauge":
            # per-replica samples, replica label folded into sorted order
            seen_keys: list = []
            for doc in docs:
                fam = doc.get(name)
                if fam is None:
                    continue
                for key in fam.samples:
                    if key not in seen_keys:
                        seen_keys.append(key)
            for sname, labels in seen_keys:
                for replica, doc in zip(replicas, docs):
                    fam = doc.get(name)
                    if fam is None or (sname, labels) not in fam.samples:
                        continue
                    tagged = tuple(
                        sorted(
                            labels
                            + (
                                (
                                    "replica",
                                    _metrics._escape_label_value(replica),
                                ),
                            )
                        )
                    )
                    lines.append(
                        _render_sample(
                            sname, tagged, fam.samples[(sname, labels)]
                        )
                    )
        else:
            sums: dict = {}
            for doc in docs:
                fam = doc.get(name)
                if fam is None:
                    continue
                for key, value in fam.samples.items():
                    sums[key] = sums.get(key, 0) + value
            for (sname, labels), value in sums.items():
                lines.append(_render_sample(sname, labels, value))
    return "\n".join(lines) + "\n"


def _replica_labels(urls) -> list:
    """host:port per url, uniquified (two urls on one netloc get #i)."""
    labels: list = []
    seen: set = set()
    for i, url in enumerate(urls):
        label = urllib.parse.urlsplit(url).netloc or url
        if label in seen:
            label = f"{label}#{i}"
        seen.add(label)
        labels.append(label)
    return labels


def _default_fetch(url: str, timeout_s: float) -> str:
    req = urllib.request.Request(url)
    tp = _propagate.outbound_traceparent("get")
    if tp is not None:
        req.add_header("traceparent", tp)
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8", "replace")


def scrape_fleet(urls, *, timeout_s: float = 5.0, fetch=None) -> list:
    """Scrape every url concurrently on pqt-io. Never raises per-replica:
    each failure becomes a ReplicaScrape with `error` set (and an
    outcome="error" tick), so a down replica degrades the fleet view
    instead of destroying it."""
    urls = list(urls)
    fetch = fetch if fetch is not None else _default_fetch
    labels = _replica_labels(urls)
    # lazy imports: obs is imported BY the io layer, so the reverse edge
    # must not exist at module-load time
    from ..io.planner import io_pool
    from .pool import instrumented_submit

    futures = [
        instrumented_submit(io_pool(), fetch, url, timeout_s, pool="pqt-io")
        for url in urls
    ]
    out: list = []
    for label, url, fut in zip(labels, urls, futures):
        try:
            text = fut.result(timeout=timeout_s + 10.0)
            out.append(ReplicaScrape(label, url, text, None))
            _metrics.inc("fleet_scrapes_total", outcome="ok")
        except Exception as exc:  # noqa: BLE001 — per-replica containment
            out.append(
                ReplicaScrape(label, url, None, f"{type(exc).__name__}: {exc}")
            )
            _metrics.inc("fleet_scrapes_total", outcome="error")
    return out


def federate(urls, *, timeout_s: float = 5.0, fetch=None) -> dict:
    """Scrape + merge: the full fleet view. Returns {"text": merged
    exposition, "replicas": [labels merged], "errors": {label: why}}.
    Raises ValueError when no urls are given or NO replica answered (the
    server endpoint maps that to a typed 502)."""
    urls = list(urls)
    if not urls:
        raise ValueError("fleet: at least one peer url required")
    scrapes = scrape_fleet(urls, timeout_s=timeout_s, fetch=fetch)
    ok = [s for s in scrapes if s.text is not None]
    errors = {s.replica: s.error for s in scrapes if s.error is not None}
    _metrics.set_gauge("fleet_replicas", len(ok))
    if not ok:
        raise ValueError(
            "fleet: no replica answered: "
            + "; ".join(f"{r}: {e}" for r, e in errors.items())
        )
    merged = merge_expositions(
        [s.text for s in ok], [s.replica for s in ok]
    )
    return {
        "text": merged,
        "replicas": [s.replica for s in ok],
        "errors": errors,
    }
