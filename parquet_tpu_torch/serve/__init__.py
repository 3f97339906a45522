"""parquet_tpu_torch.serve — the concurrent scan/query service.

The long-running request layer over everything the library already does:
warm-cache planning (io.cache), projection/predicate push-down
(data.plan + core.filter), bounded streaming execution (executor on the
pqt-serve pool), aggregation push-down on the card (query_device +
aggregate), admission control (queue depth, per-tenant budgets, deadlines,
graceful drain), all behind a stdlib HTTP daemon (ScanServer). See each
module's docstring; serve/server.py lists what the reference's
observability hooks became.
"""

from .admission import AdmissionController, Deadline  # noqa: F401
from .aggregate import (  # noqa: F401
    QueryState,
    query_device_counts,
    render_query_body,
    reset_query_device_counts,
    run_local_query,
)
from .counts import reset_serve_counts, serve_counts  # noqa: F401
from .executor import execute_query, execute_stream, serve_pool  # noqa: F401
from .protocol import (  # noqa: F401
    AggregateSpec,
    QueryRequest,
    ScanRequest,
    ServeError,
    aggregates_from_spec,
    filters_from_spec,
    json_default,
    parse_query_request,
    parse_scan_request,
    scan_request_from_query,
)
from .query_device import DeviceQueryError, device_unit_partial  # noqa: F401
from .server import ScanServer, ScanService, ServeConfig  # noqa: F401
from .session import PlannedScan, ScanSession  # noqa: F401

__all__ = [
    "ServeError",
    "ScanRequest",
    "QueryRequest",
    "AggregateSpec",
    "parse_scan_request",
    "parse_query_request",
    "scan_request_from_query",
    "filters_from_spec",
    "aggregates_from_spec",
    "json_default",
    "render_query_body",
    "run_local_query",
    "QueryState",
    "query_device_counts",
    "reset_query_device_counts",
    "DeviceQueryError",
    "device_unit_partial",
    "serve_counts",
    "reset_serve_counts",
    "ScanSession",
    "PlannedScan",
    "AdmissionController",
    "Deadline",
    "execute_stream",
    "execute_query",
    "serve_pool",
    "ServeConfig",
    "ScanServer",
    "ScanService",
]
