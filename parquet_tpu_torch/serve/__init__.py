"""Aggregation push-down: query parsing, device units, the exact merge and
the local runner (the query half of parquet_tpu/serve)."""

from .aggregate import (  # noqa: F401
    QueryState,
    query_device_counts,
    render_query_body,
    reset_query_device_counts,
    run_local_query,
)
from .protocol import AggregateSpec, QueryRequest, ServeError, parse_query_request  # noqa: F401
from .query_device import DeviceQueryError, device_unit_partial  # noqa: F401
