"""parquet_tpu_torch.obs — the operator-facing observability layer.

The substrate is per-read span tracing (utils/trace.py) and the always-on
metrics registry (utils/metrics.py); this package turns it into something an operator of a
long-running daemon can actually use at 14:02 when request X was slow:

  recorder  request-correlated flight recorder: a bounded ring of
            per-request records (id, tenant, status, plan summary, bytes,
            queue-wait, stage rollup, sampled span trees), process-wide —
            the serve daemon, ParquetDataset units and EncodePipeline
            groups all record into the same ring. Served at
            /v1/debug/requests by `parquet-tool serve`, queried by
            `parquet-tool debug`.
  log       structured JSON-lines logging (stdlib logging underneath):
            request-id/tenant context injection, token-bucket rate
            limiting per event key, silent until configure_logging().
  pool      the one instrumented submit the pqt-* pools route
            through (pqt-io, pqt-hedge, pqt-data, pqt-encode, pqt-serve,
            pqt-mesh; the device read's pqt-host and pqt-dispatch hops
            are plain traced_submit): queue-depth/active gauges +
            queue-wait/task-time histograms per pool.
  prof      continuous sampling profiler over sys._current_frames():
            bounded, lane-attributed (the named pqt-* pools), rendered
            as flamegraph-compatible collapsed stacks and a top-N
            self-time table. Served live at /v1/debug/profile, fetched
            by `parquet-tool profile --live`.
  cost      per-tenant cost accounting: CPU seconds (thread-time deltas
            around executor units), decoded/source bytes and cache
            outcomes (from the request trace), charged to the
            admission-resolved tenant. Served at /v1/debug/tenants.
  propagate cross-process trace propagation: a W3C-traceparent-shaped
            context minted/adopted per request scope, injected into every
            outbound HTTP call, and merge_chrome_traces() — the
            `parquet-tool trace-merge` engine that stitches per-process
            Perfetto documents on the shared trace-id.
  fleet     metrics federation: scrape N replicas' /metrics and merge
            families exactly (counters sum, histogram buckets add, gauges
            keep a replica= label). Served at /v1/debug/fleet and
            `parquet-tool debug --fleet`.
  slo       multi-window burn-rate health engine over the daemon's own
            request outcomes; verdict at /v1/debug/slo, folded into
            /healthz as "degraded".

See each module's docstring for the contracts and bounds.
"""

from .cost import (  # noqa: F401
    LEDGER,
    CostLedger,
    charged_tenant,
    cost_context,
    unit_clock,
)
from .fleet import (  # noqa: F401
    federate,
    merge_expositions,
    parse_exposition,
    scrape_fleet,
)
from .log import (  # noqa: F401
    JsonLinesFormatter,
    TokenBucketLimiter,
    configure_logging,
    log_context,
    log_event,
)
from .pool import instrumented_submit, pool_depths  # noqa: F401
from .prof import (  # noqa: F401
    ProfilerBusy,
    SamplingProfiler,
    capture,
    lane_of,
)
from .propagate import (  # noqa: F401
    TraceContext,
    current_context,
    merge_chrome_traces,
    mint,
    outbound_traceparent,
    parse_traceparent,
    propagation_scope,
    resolve_inbound,
)
from .recorder import (  # noqa: F401
    RECORDER,
    FlightRecorder,
    ObsConfig,
    RequestRecord,
    configure,
    recorder,
    sanitize_request_id,
)
from .slo import (  # noqa: F401
    BurnRateEngine,
    SLOObjective,
)

__all__ = [
    "ObsConfig",
    "FlightRecorder",
    "RequestRecord",
    "RECORDER",
    "recorder",
    "configure",
    "sanitize_request_id",
    "log_event",
    "log_context",
    "configure_logging",
    "JsonLinesFormatter",
    "TokenBucketLimiter",
    "instrumented_submit",
    "pool_depths",
    "SamplingProfiler",
    "ProfilerBusy",
    "capture",
    "lane_of",
    "CostLedger",
    "LEDGER",
    "cost_context",
    "charged_tenant",
    "unit_clock",
    "TraceContext",
    "mint",
    "parse_traceparent",
    "current_context",
    "propagation_scope",
    "outbound_traceparent",
    "resolve_inbound",
    "merge_chrome_traces",
    "federate",
    "merge_expositions",
    "parse_exposition",
    "scrape_fleet",
    "BurnRateEngine",
    "SLOObjective",
]
