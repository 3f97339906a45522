"""Typed request parsing and validation for the scan and query service.

The port of parquet_tpu/serve/protocol.py: everything that crosses the HTTP
boundary is validated HERE, into plain typed objects, before any planning
or IO happens: a malformed request costs one JSON parse and raises a typed
ServeError, never a traceback and never a half-planned scan. The JSON
filter-spec parser (`filters_from_spec`), the scan request
(`parse_scan_request` for POST bodies, `scan_request_from_query` for GET
/v1/plan query parameters) and the aggregate-spec parser
(`aggregates_from_spec` / `parse_query_request`) accept the exact language
of the reference, and `json_default` is its canonical JSON fallback, so the
rendered bodies are the reference's bytes. `format="arrow-ipc"` parses as
in the reference (the daemon streams it with core/arrow_ipc.py).

ServeError carries an HTTP status and a stable machine-readable `code`, and
renders as `{"error": {"code", "message", "status"}}`.
"""

from __future__ import annotations

import json
from typing import NamedTuple

__all__ = [
    "ServeError",
    "ScanRequest",
    "QueryRequest",
    "AggregateSpec",
    "FORMATS",
    "CONTENT_TYPES",
    "AGG_OPS",
    "filters_from_spec",
    "aggregates_from_spec",
    "parse_scan_request",
    "parse_query_request",
    "scan_request_from_query",
    "json_default",
    "agg_name",
]

FORMATS = ("jsonl", "arrow-ipc")
# the Content-Type a scan's answer carries, by format
CONTENT_TYPES = {
    "jsonl": "application/x-ndjson",
    "arrow-ipc": "application/vnd.apache.arrow.stream",
}

# ops accepted by the filter spec; mirrors core/filter._OPS (validated
# again, against the actual schema, at normalize time — this early check
# exists so a typo'd op fails the REQUEST, not the first file's plan)
_OPS = (
    "==", "!=", "<", "<=", ">", ">=", "is_null", "not_null", "in", "not_in",
    "contains",
)

# aggregate ops accepted by /v1/query and `parquet-tool scan --aggregate`
AGG_OPS = ("count", "sum", "min", "max")

# group-by cardinality is BOUNDED: past max_groups the query fails with a
# typed overflow error instead of buffering an unbounded result (the whole
# point of push-down is that results are kilobytes)
DEFAULT_MAX_GROUPS = 10_000
MAX_MAX_GROUPS = 1_000_000

_SCAN_KEYS = {
    "paths", "columns", "filters", "limit", "format", "shard", "timeout_ms",
}

_QUERY_KEYS = {
    "paths", "filters", "aggregates", "group_by", "max_groups", "shard",
    "timeout_ms",
}


class ServeError(ValueError):
    """A typed, HTTP-renderable service error (subclass of ValueError so
    CLI callers sharing the parsers get ordinary `parquet-tool: <msg>`
    handling). `status` is the HTTP status to send, `code` a stable
    machine-readable discriminator clients can branch on."""

    def __init__(self, status: int, code: str, message: str, *, retry_after_s=None):
        super().__init__(message)
        self.status = int(status)
        self.code = str(code)
        self.message = str(message)
        self.retry_after_s = retry_after_s

    def to_body(self) -> dict:
        return {
            "error": {
                "code": self.code,
                "message": self.message,
                "status": self.status,
            }
        }


class AggregateSpec(NamedTuple):
    """One validated aggregate: op in AGG_OPS; column None only for the
    row-count form of count (count(*))."""

    op: str
    column: str | None


def filter_not_ported(err) -> ServeError:
    """The typed 501 for a residual filter the host mask declines (a
    core.filter_vec.VecFilterError), which the reference evaluates with
    pyarrow compute: the host query engine's and the arrow-ipc scan's."""
    return ServeError(
        501, "not_ported",
        f"filter needs pyarrow compute, which parquet_tpu_torch does not use: {err}",
    )


def agg_name(a: AggregateSpec) -> str:
    """The stable result key of one aggregate — shared by the daemon body
    and the CLI output so the rendered bytes match."""
    return a.op if a.column is None else f"{a.op}({a.column})"


class QueryRequest(NamedTuple):
    """One validated aggregation push-down request (POST /v1/query)."""

    paths: list  # file paths and/or glob patterns, server-root relative
    filters: list | None  # normalized triples/DNF, core/filter convention
    aggregates: tuple  # AggregateSpec, >= 1
    group_by: tuple  # column names (empty = one global row)
    max_groups: int  # typed overflow past this many distinct groups
    shard: tuple | None  # (index, count) unit striping for this request
    timeout_ms: int | None  # per-request deadline override


class ScanRequest(NamedTuple):
    """One validated scan (or plan dry-run) request."""

    paths: list  # file paths and/or glob patterns, server-root relative
    columns: list | None  # column projection (dotted paths)
    filters: list | None  # normalized triples/DNF, core/filter convention
    limit: int | None  # max rows streamed back
    format: str  # "jsonl" | "arrow-ipc"
    shard: tuple | None  # (index, count) unit striping for this request
    timeout_ms: int | None  # per-request deadline override


def json_default(v):
    """The canonical JSON fallback shared by parquet-tool cat/head and the
    scan service — one definition, so daemon bytes match CLI bytes."""
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    return str(v)


def _bad(message: str) -> ServeError:
    return ServeError(400, "bad_request", message)


def _check_triple(t):
    if not isinstance(t, (list, tuple)) or len(t) not in (2, 3):
        raise ServeError(
            400, "bad_filters",
            f"filter entry must be [column, op] or [column, op, value], got {t!r}",
        )
    if not isinstance(t[0], str) or not t[0]:
        raise ServeError(
            400, "bad_filters", f"filter column must be a string, got {t[0]!r}"
        )
    if t[1] not in _OPS:
        raise ServeError(
            400, "bad_filters",
            f"unknown filter op {t[1]!r} (use one of {', '.join(_OPS)})",
        )
    return tuple(t)


def filters_from_spec(spec):
    """Validate a JSON-decoded filter spec into the (column, op, value)
    triple convention of core/filter.normalize_dnf.

    Accepts the pyarrow shapes: a flat list of triples (one conjunction) or
    a list of LISTS of triples (an OR of conjunctions). The disambiguation
    matches normalize_dnf: an element whose head is a string is a triple.
    Column existence / value coercion is checked later against each file's
    schema; this parser only pins the SHAPE, so a bad spec fails the
    request with a typed 400 before any file is touched."""
    if spec is None:
        return None
    if not isinstance(spec, (list, tuple)):
        raise ServeError(
            400, "bad_filters",
            f"filters must be a list of [column, op, value] triples "
            f"(or a list of such lists), got {type(spec).__name__}",
        )
    if not spec:
        return None
    if all(
        isinstance(c, (list, tuple)) and c and not isinstance(c[0], str)
        for c in spec
    ):
        return [[_check_triple(t) for t in conj] for conj in spec]
    return [_check_triple(t) for t in spec]


def _parse_shard(v):
    if v is None:
        return None
    if isinstance(v, str):
        sep = "/" if "/" in v else ","
        parts = v.split(sep)
    else:
        parts = list(v) if isinstance(v, (list, tuple)) else None
    try:
        i, n = (int(x) for x in parts)
    except (TypeError, ValueError):
        raise ServeError(
            400, "bad_request",
            f"shard must be [index, count] (or 'i/n'), got {v!r}",
        ) from None
    if n <= 0 or not 0 <= i < n:
        raise ServeError(
            400, "bad_request", f"shard index {i} out of range for count {n}"
        )
    return (i, n)


def _build_request(obj: dict) -> ScanRequest:
    unknown = set(obj) - _SCAN_KEYS
    if unknown:
        raise _bad(
            f"unknown request field(s) {sorted(unknown)} "
            f"(accepted: {sorted(_SCAN_KEYS)})"
        )
    paths = obj.get("paths")
    if isinstance(paths, str):
        paths = [paths]
    if (
        not isinstance(paths, list)
        or not paths
        or not all(isinstance(p, str) and p for p in paths)
    ):
        raise _bad("'paths' must be a non-empty string or list of strings")
    columns = obj.get("columns")
    if columns is not None:
        if isinstance(columns, str):
            columns = [c for c in columns.split(",") if c]
        if not isinstance(columns, list) or not all(
            isinstance(c, str) and c for c in columns
        ):
            raise _bad("'columns' must be a list of column names")
        if not columns:
            columns = None
    limit = obj.get("limit")
    if limit is not None:
        if not isinstance(limit, int) or isinstance(limit, bool) or limit < 0:
            raise _bad(f"'limit' must be a non-negative integer, got {limit!r}")
    fmt = obj.get("format", "jsonl")
    if fmt not in FORMATS:
        raise _bad(f"unknown format {fmt!r} (use one of {', '.join(FORMATS)})")
    timeout_ms = obj.get("timeout_ms")
    if timeout_ms is not None:
        if not isinstance(timeout_ms, int) or isinstance(timeout_ms, bool) or timeout_ms <= 0:
            raise _bad(f"'timeout_ms' must be a positive integer, got {timeout_ms!r}")
    return ScanRequest(
        paths=paths,
        columns=columns,
        filters=filters_from_spec(obj.get("filters")),
        limit=limit,
        format=fmt,
        shard=_parse_shard(obj.get("shard")),
        timeout_ms=timeout_ms,
    )


def aggregates_from_spec(spec):
    """Validate a JSON-decoded aggregate spec into AggregateSpec tuples.

    Accepts a list whose entries are "count" (count(*)), [op] / [op,
    column] pairs, or {"op": ..., "column": ...} objects. Column existence
    is checked later against each file's schema — like filters_from_spec,
    this pins the SHAPE so a bad spec fails the request typed before any
    file is touched."""
    if not isinstance(spec, (list, tuple)) or not spec:
        raise ServeError(
            400, "bad_aggregates",
            "'aggregates' must be a non-empty list of [op, column] pairs "
            f"(ops: {', '.join(AGG_OPS)}; count may omit the column)",
        )
    out = []
    for a in spec:
        if isinstance(a, str):
            op, column = a, None
        elif isinstance(a, dict):
            unknown = set(a) - {"op", "column"}
            if unknown:
                raise ServeError(
                    400, "bad_aggregates",
                    f"unknown aggregate field(s) {sorted(unknown)}",
                )
            op, column = a.get("op"), a.get("column")
        elif isinstance(a, (list, tuple)) and 1 <= len(a) <= 2:
            op = a[0]
            column = a[1] if len(a) == 2 else None
        else:
            raise ServeError(
                400, "bad_aggregates", f"bad aggregate entry {a!r}"
            )
        if op not in AGG_OPS:
            raise ServeError(
                400, "bad_aggregates",
                f"unknown aggregate op {op!r} (use one of {', '.join(AGG_OPS)})",
            )
        if column is not None and (not isinstance(column, str) or not column):
            raise ServeError(
                400, "bad_aggregates",
                f"aggregate column must be a non-empty string, got {column!r}",
            )
        if column is None and op != "count":
            raise ServeError(
                400, "bad_aggregates", f"aggregate {op!r} needs a column"
            )
        out.append(AggregateSpec(op=op, column=column))
    return tuple(out)


def _build_query_request(obj: dict) -> QueryRequest:
    unknown = set(obj) - _QUERY_KEYS
    if unknown:
        raise _bad(
            f"unknown request field(s) {sorted(unknown)} "
            f"(accepted: {sorted(_QUERY_KEYS)})"
        )
    paths = obj.get("paths")
    if isinstance(paths, str):
        paths = [paths]
    if (
        not isinstance(paths, list)
        or not paths
        or not all(isinstance(p, str) and p for p in paths)
    ):
        raise _bad("'paths' must be a non-empty string or list of strings")
    group_by = obj.get("group_by") or []
    if isinstance(group_by, str):
        group_by = [c for c in group_by.split(",") if c]
    if not isinstance(group_by, list) or not all(
        isinstance(c, str) and c for c in group_by
    ):
        raise _bad("'group_by' must be a list of column names")
    max_groups = obj.get("max_groups", DEFAULT_MAX_GROUPS)
    if (
        not isinstance(max_groups, int)
        or isinstance(max_groups, bool)
        or not 1 <= max_groups <= MAX_MAX_GROUPS
    ):
        raise _bad(
            f"'max_groups' must be an integer in [1, {MAX_MAX_GROUPS}], "
            f"got {max_groups!r}"
        )
    timeout_ms = obj.get("timeout_ms")
    if timeout_ms is not None:
        if not isinstance(timeout_ms, int) or isinstance(timeout_ms, bool) or timeout_ms <= 0:
            raise _bad(f"'timeout_ms' must be a positive integer, got {timeout_ms!r}")
    return QueryRequest(
        paths=paths,
        filters=filters_from_spec(obj.get("filters")),
        aggregates=aggregates_from_spec(obj.get("aggregates")),
        group_by=tuple(group_by),
        max_groups=max_groups,
        shard=_parse_shard(obj.get("shard")),
        timeout_ms=timeout_ms,
    )


def _parse_body(raw: bytes) -> dict:
    if not raw:
        raise _bad("empty request body (expected a JSON object)")
    try:
        obj = json.loads(raw)
    except (ValueError, UnicodeDecodeError) as e:
        raise _bad(f"request body is not valid JSON: {e}") from None
    if not isinstance(obj, dict):
        raise _bad(f"request body must be a JSON object, got {type(obj).__name__}")
    return obj


def parse_scan_request(raw: bytes) -> ScanRequest:
    """Parse + validate a POST /v1/scan (or /v1/plan) JSON body."""
    return _build_request(_parse_body(raw))


def parse_query_request(raw: bytes) -> QueryRequest:
    """Parse + validate a POST /v1/query JSON body."""
    return _build_query_request(_parse_body(raw))


def scan_request_from_query(qs: dict) -> ScanRequest:
    """Build a request from GET /v1/plan query parameters (urllib parse_qs
    shape: {key: [values]}). `paths` repeats or comma-separates; `columns`
    comma-separates; `filters` is the same JSON spec as the POST body."""
    obj: dict = {}
    paths: list = []
    for v in qs.get("paths", []):
        paths.extend(p for p in v.split(",") if p)
    if paths:
        obj["paths"] = paths
    if "columns" in qs:
        obj["columns"] = ",".join(qs["columns"])
    if "filters" in qs:
        try:
            obj["filters"] = json.loads(qs["filters"][-1])
        except ValueError as e:
            raise ServeError(
                400, "bad_filters", f"'filters' is not valid JSON: {e}"
            ) from None
    for key in ("limit", "timeout_ms"):
        if key in qs:
            try:
                obj[key] = int(qs[key][-1])
            except ValueError:
                raise _bad(f"'{key}' must be an integer") from None
    if "shard" in qs:
        obj["shard"] = qs["shard"][-1]
    if "format" in qs:
        obj["format"] = qs["format"][-1]
    if "paths" not in obj:
        raise _bad("missing 'paths' query parameter")
    return _build_request(obj)
