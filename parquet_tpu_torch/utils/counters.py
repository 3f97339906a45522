"""One layer's counts, kept as samples of the process metrics registry.

The registry (utils/metrics.REGISTRY) holds every sample once; a
LabelledCounts is a view of it: the samples one layer (io, lake, serve,
the prepare walk, ...) wrote since its last reset, read back under the
layer's own keys. A count is keyed as the registry keys a sample,
name{label="value",...}: labels sorted by name, each value escaped as the
Prometheus text format escapes it (backslash, double quote, newline).

`alias(name, labels) -> (family, labels)` names the registry sample a
count goes to where the layer's key is not the family: a trace event such
as `prepare_fused_engaged` is the registry's events_total{event=...}
(see `event_alias`), and such a count is also a count of the active
decode trace (utils.trace.count). reset() acts on the view only: the registry stays
monotonic (what /metrics shows), and the view reads each sample against
its value when the view first counted it after the reset."""

from __future__ import annotations

import threading

from . import trace as _trace
from .metrics import REGISTRY

__all__ = ["LabelledCounts", "event_alias", "key"]


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def key(name: str, labels: dict) -> str:
    """The count key of `name` with its labels (sorted, escaped)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def event_alias(events=None):
    """An alias sending each count `name` (or each of `events` only) to
    events_total{event=name}, where the reference's trace.bump() puts it."""

    def alias(name, labels):
        if labels or (events is not None and name not in events):
            return name, labels
        return "events_total", {"event": name}

    return alias


class LabelledCounts:
    """The counts one layer wrote into `registry` since its last reset."""

    def __init__(self, registry=None, alias=None, traced=None):
        self._registry = registry if registry is not None else REGISTRY
        self._alias = alias
        # which event counts are also counts of the active trace (all)
        self._traced = traced
        # count key -> (family, labels, the sample's value when first counted)
        self._keys: dict = {}
        self._lock = threading.Lock()

    def count(self, name: str, n: int = 1, **labels) -> None:
        """Add n to the count `name` (with its labels)."""
        fam, lab = self._alias(name, labels) if self._alias else (name, labels)
        k = key(name, labels)
        with self._lock:
            if k not in self._keys:
                self._keys[k] = (fam, lab, self._registry.get(fam, **lab))
        self._registry.inc(fam, n, **lab)
        if "event" in lab and fam == "events_total" and not labels and (
                self._traced is None or self._traced(name)):
            _trace.count(lab["event"], n)  # a trace event, as trace.bump() counts it

    def snapshot(self) -> dict:
        with self._lock:
            keys = list(self._keys.items())
        out = {}
        for k, (fam, lab, base) in keys:
            v = self._registry.get(fam, **lab)
            out[k] = v - base if v >= base else v  # registry reset: rebased
        return out

    def reset(self) -> None:
        with self._lock:
            self._keys.clear()
