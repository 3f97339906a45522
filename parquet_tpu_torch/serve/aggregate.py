"""Aggregation push-down: per-unit partials, exact merge, canonical body.

The query half of parquet_tpu/serve/aggregate.py, without pyarrow. Each
unit (one row group of one file) computes a PARTIAL aggregate on the device
(serve/query_device.device_unit_partial), partials merge with exact
semantics, and the response is kilobytes however many rows matched.

The reference merges two partials with the pyarrow kernel of the partial's
arrow type. Device partials are only 64-bit integers, so the port's merge
(_merge_value) is that kernel written out: counts add, sums wrap in 64-bit
two's complement in the int64 or uint64 domain their type tag names, min
and max compare, and None (no matching rows) passes the other side
through. The tests pin it against the pyarrow merge, wrap-around included.

run_local_query is the daemon-free runner: units are the row groups each
file's statistics and bloom filters admit, file by file in sorted order
(data/plan.build_plan), striped over shards with `shard=`. A count(*)-only query
without filters answers from the footer; every other unit runs on the
device. A unit outside the device envelope raises a typed ServeError
(device_declined): the reference reruns it on its host engine, which is
pyarrow (to_arrow) and is not ported. query_device_counts() reads how many
units each engine took.

The canonical JSON rendering (render_query_body) is the reference's, so
the bodies are its bytes for the same corpus and spec.
"""

from __future__ import annotations

import json
import threading
from collections import Counter
from contextlib import ExitStack

from .protocol import QueryRequest, ServeError, agg_name, json_default
from .query_device import DeviceQueryError, device_unit_partial

__all__ = [
    "QueryState",
    "query_columns",
    "unit_count_partial",
    "result_dict",
    "render_query_body",
    "run_local_query",
    "query_device_counts",
    "reset_query_device_counts",
]

_M64 = (1 << 64) - 1

# Units by engine, as the reference counts query_device_units_total{engine=}:
# "device" (device_unit_partial answered) and "declined" (DeviceQueryError).
_COUNTS: Counter = Counter()
_COUNTS_LOCK = threading.Lock()


def query_device_counts() -> dict:
    """A snapshot of the query units' engine counts."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_query_device_counts() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()


def _bump(engine: str) -> None:
    with _COUNTS_LOCK:
        _COUNTS[engine] += 1


def query_columns(query: QueryRequest) -> list:
    """The column projection a query's units must decode: group-by keys
    plus aggregate inputs, order-stable. Empty + no filters means NO decode
    at all (pure count(*) answers from footer-promised row counts); empty
    WITH filters borrows the first filter column so the filtered row count
    is still observable."""
    cols: list = []
    for c in query.group_by:
        if c not in cols:
            cols.append(c)
    for a in query.aggregates:
        if a.column is not None and a.column not in cols:
            cols.append(a.column)
    if not cols and query.filters is not None:
        first = query.filters[0]
        if isinstance(first, (list, tuple)) and first and isinstance(
            first[0], (list, tuple)
        ):
            first = first[0]  # DNF: first conjunction's first triple
        cols.append(first[0])
    return cols


def unit_count_partial(query: QueryRequest, num_rows: int):
    """The zero-decode partial: every aggregate is count(*) (query_columns
    returned empty with no filters), so the footer-promised row count IS
    the answer and the unit never opens its file."""
    return {(): [num_rows for _ in query.aggregates]}, [None] * len(
        query.aggregates
    )


def _merge_value(op: str, a, b, typ):
    """Merge two partial values of one aggregate: counts add; sums wrap in
    64-bit two's complement in the domain of `typ` ("int64" or "uint64");
    min/max compare; None (no matching rows) passes the other through."""
    if op == "count":
        return int(a) + int(b)
    if a is None:
        return b
    if b is None:
        return a
    if op == "sum":
        if typ not in ("int64", "uint64"):
            raise ServeError(500, "internal", f"sum partials of type {typ!r}")
        s = (int(a) + int(b)) & _M64
        return s - (1 << 64) if typ == "int64" and s >> 63 else s
    return min(a, b) if op == "min" else max(a, b)


class QueryState:
    """The merged aggregate state one request accumulates unit by unit."""

    __slots__ = ("query", "groups", "types", "rows_scanned", "rows_matched")

    def __init__(self, query: QueryRequest):
        self.query = query
        self.types: list = [None] * len(query.aggregates)
        self.rows_scanned = 0
        self.rows_matched = 0
        if query.group_by:
            self.groups: dict = {}
        else:
            # the global row exists even over zero units: count 0, sum/min/
            # max null — matching pyarrow kernels over an empty column
            self.groups = {
                (): [0 if a.column is None or a.op == "count" else None
                     for a in query.aggregates]
            }

    def absorb(self, part) -> None:
        """Merge one unit's ((groups, types), scanned, matched) partial."""
        (groups, types), scanned, matched = part
        self.rows_scanned += scanned
        self.rows_matched += matched
        for j, t in enumerate(types):
            if self.types[j] is None:
                self.types[j] = t
        q = self.query
        for key, vals in groups.items():
            cur = self.groups.get(key)
            if cur is None:
                if len(self.groups) >= q.max_groups:
                    raise ServeError(
                        413, "group_overflow",
                        f"group-by cardinality exceeded max_groups="
                        f"{q.max_groups}; narrow the filter or raise "
                        "max_groups",
                    )
                self.groups[key] = list(vals)
                continue
            for j, a in enumerate(q.aggregates):
                op = "count" if a.column is None else a.op
                cur[j] = _merge_value(op, cur[j], vals[j], self.types[j])


def _key_order(key: tuple) -> str:
    # deterministic total order over arbitrary (possibly None/mixed) keys:
    # their canonical JSON encoding — the same bytes the body renders
    return json.dumps(list(key), default=json_default)


def result_dict(query: QueryRequest, state: QueryState, *, units: int) -> dict:
    """The response body, deterministically ordered (groups sort by their
    canonical key encoding) so daemon bytes == CLI bytes."""
    names = [agg_name(a) for a in query.aggregates]
    body: dict = {
        "group_by": list(query.group_by),
        "aggregates": names,
        "units": units,
        "rows_scanned": state.rows_scanned,
        "rows_matched": state.rows_matched,
    }
    if query.group_by:
        body["group_count"] = len(state.groups)
        body["groups"] = [
            {
                "key": list(key),
                "aggregates": dict(zip(names, state.groups[key])),
            }
            for key in sorted(state.groups, key=_key_order)
        ]
    else:
        body["result"] = dict(zip(names, state.groups[()]))
    return body


def render_query_body(body: dict) -> bytes:
    """ONE canonical serialization (shared with `parquet-tool scan
    --aggregate`), so a daemon response is byte-identical to the CLI's."""
    return (json.dumps(body, default=json_default) + "\n").encode()


def run_local_query(paths, query: QueryRequest, *, device=None) -> dict:
    """The daemon-free twin of POST /v1/query over local files: plan the
    units (data/plan.build_plan: row groups admitted by statistics and
    bloom filters, files in sorted order), take this shard's stripe of them
    when `query.shard` is (index, count) (epoch 0's unshuffled order, as
    the reference stripes it), run each on the device (`device`, default
    CUDA), merge. A count(*)-only query without filters reads footers only.
    Raises a typed ServeError for a unit outside the device envelope
    (device_declined)."""
    from ..core.reader import FileReader, resolve_device
    from ..data.plan import build_plan, expand_paths

    device = resolve_device(device)  # no CUDA and no device=: raise, even for footers only
    files: list = []
    for p in paths:
        files.extend(expand_paths(p))
    files = sorted(set(files))
    plan = build_plan(files, filters=query.filters)
    if query.shard is not None:
        order = plan.epoch_order(0, shard_index=query.shard[0], shard_count=query.shard[1])
        units = [plan.units[k] for k in order]
    else:
        units = list(plan.units)
    cols = query_columns(query)
    decode = bool(cols) or query.filters is not None
    state = QueryState(query)
    # one reader per file, opened at its first unit and kept for the rest
    # (footer and schema parsed once), units absorbed in plan order
    readers: dict = {}
    with ExitStack() as stack:
        for u in units:
            if not decode:
                state.absorb((unit_count_partial(query, u.num_rows), u.num_rows, u.num_rows))
                continue
            r = readers.get(u.file_index)
            if r is None:
                r = readers[u.file_index] = stack.enter_context(
                    FileReader(u.path, device=device, metadata=plan.metas[u.file_index])
                )
            try:
                part = device_unit_partial(r, u.row_group, query, query.filters)
            except DeviceQueryError as e:
                _bump("declined")
                raise ServeError(400, "device_declined", str(e)) from None
            _bump("device")
            state.absorb(part)
    return result_dict(query, state, units=len(units))
