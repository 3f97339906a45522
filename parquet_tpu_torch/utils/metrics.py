"""Process-wide, always-on metrics registry.

The port's copy of the reference's registry: the same API, family names,
HELP texts and expositions (byte for byte), plus the HELP texts of the
port's own families; every layer's `*_counts()` function is a view of
REGISTRY (utils/counters.py).

The decode trace (utils/trace.py) answers "where did THIS read spend its
time" — it only exists inside a `with decode_trace()` block. This registry
answers "what has this PROCESS decoded since it started": counters and
histograms that every read feeds unconditionally, cheap enough to stay on in
production (one small lock around a dict update per page/chunk, not per
value). The Go library this project was modelled on has neither (SURVEY §5);
serving heavy traffic needs both.

    from parquet_tpu_torch.utils import metrics

    before = metrics.snapshot()
    reader.read_row_group(0)                  # no trace needed
    print(metrics.delta(before))              # what that read added
    print(metrics.render_prometheus())        # text exposition for scrapes
    print(metrics.report())                   # human summary (ratio, MB/s)

Key families (all under the `parquet_tpu_` prefix in exposition):
  pages_decoded_total{encoding=}    pages decoded, per wire encoding
  page_bytes_total{encoding=}       uncompressed page bytes, per encoding
  bytes_compressed_total{codec=}    wire bytes entering decompression
  bytes_uncompressed_total{codec=}  bytes leaving decompression
  chunk_decode_seconds              histogram of per-chunk decode wall time
  events_total{event=}              every trace.bump() event, always-on —
                                    prepare_fused_engaged/_declined,
                                    prepare_fallback_recovered,
                                    encode_fused_engaged/_declined (the
                                    write-side ladder: one per chunk the
                                    fused native ptq_chunk_encode walk
                                    produced / stood down from),
                                    encode_fused_fault_<stage> (native
                                    encode aborts by stage: split/levels/
                                    values/compress/frame),
                                    encode_fallback_recovered (chunks the
                                    staged Python rung salvaged after a
                                    native abort),
                                    chunks_quarantined, ... dual-report here
  io_bytes_read_total               bytes actually read from byte sources
  io_read_calls_total               source read calls (coalescing shrinks it)
  io_retries_total{reason=}         failed source attempts absorbed by the
                                    RetryingSource ladder
  io_cache_hits/misses_total        block-cache outcomes; io_cache_bytes is
                                    the resident-bytes gauge
  io_footer_cache_hits/misses_total footer/metadata cache outcomes
  io_readahead_fetched/dropped_total  pqt-io readahead accepted vs shed
                                      (budget full); _errors_total swallowed
  pages_written_total{encoding=}    pages ENCODED by the write side, per
                                    wire encoding (dict pages count PLAIN);
                                    fed by BOTH encode rungs and by the
                                    device batch-materialization path
                                    (kernels/pipeline.encode_device_column),
                                    so page accounting is rung-independent
  write_bytes_total{codec=}         encoded row-group bytes committed to
                                    byte sinks, per codec
  encode_seconds                    histogram of per-chunk encode wall time
                                    (the write-side chunk_decode_seconds)
  sink_bytes_written_total          bytes actually written to byte sinks
  sink_write_calls_total            sink write calls (BufferedSink's
                                    write-combining shrinks it)
  assembly_rows_total{engine=}      rows materialized by record assembly,
                                    per engine: "vec" = the vectorized
                                    level-scan engine (core/assembly_vec),
                                    "scalar" = the cursor-walk fallback
                                    (PQT_VEC_ASSEMBLY=0 or unprovable
                                    shapes)
  assembly_seconds                  histogram of row-materialization wall
                                    time (one observation per assembly
                                    window / scalar group; same clock as
                                    the assembly.rows trace stage)
  serve_requests_total{status=,tenant=}  scan-service requests finished,
                                    by HTTP status and X-Tenant key (499 =
                                    client disconnected mid-stream)
  serve_queue_depth                 gauge: requests currently admitted and
                                    in flight in the serve daemon
  serve_request_seconds{endpoint=}  histogram of request wall time, entry
                                    to last byte (plan + queue + execute +
                                    stream), per endpoint
  serve_scan_bytes_total            response payload bytes streamed back
                                    by /v1/scan (jsonl or arrow-ipc)
  events_total{event="serve_stream_aborted"}  responses torn mid-stream
                                    (typed terminal record, no 0-chunk)
  events_total{event="plan_units_pruned_stats"|"plan_units_pruned_bloom"}
                                    row groups excluded at plan time, also
                                    on every ScanPlan.pruning_summary()
  serve_slow_requests_total{endpoint=}  requests at/over the daemon's
                                    slow_ms threshold (the flight
                                    recorder always keeps their traces);
                                    serve_request_seconds is labeled by
                                    the same bounded endpoint set, so
                                    /v1/plan and /v1/scan latencies are
                                    separable
  pool_queue_depth{pool=}           gauge: tasks submitted to a pqt-*
                                    pool and not yet running
  pool_active_workers{pool=}        gauge: tasks currently running on a
                                    pqt-* pool
  pool_queue_wait_seconds{pool=}    histogram: submit-to-start wait per
                                    pool — the elastic-SLO controller's
                                    primary input (also credited to the
                                    submitting request's trace as the
                                    pool.wait stage)
  pool_task_seconds{pool=}          histogram: task wall time per pool
  obs_requests_recorded_total{endpoint=}  flight-recorder records opened
                                    (serve endpoints + dataset.unit /
                                    encode.group library records)
  obs_ring_evictions_total          records evicted from the bounded
                                    flight-recorder ring
  obs_traces_retained_total         span trees kept by the recorder
                                    (sampled, slow or errored requests);
                                    obs_ring_records is the occupancy
                                    gauge
  log_events_total{event=}          structured log events emitted by
                                    obs.log (counted even with no
                                    handler attached)
  log_suppressed_total{event=}      events the per-key token-bucket rate
                                    limiter absorbed
  dataset_prefetch_target           gauge: the elastic-SLO controller's
                                    current prefetch-depth target (the
                                    dataset_prefetch_depth gauge shows
                                    what is actually in flight)
  dataset_slo_violations_total      consumer-wait observations that
                                    exceeded the dataset's configured
                                    slo_wait_ms
  io_hedges_total{outcome=}         hedged duplicate reads: "launched"
                                    when a read outlives the latency-
                                    quantile bar, then "win_primary" /
                                    "win_hedge" / "failed" for how the
                                    race resolved
  io_breaker_state{source=}         gauge: circuit-breaker state per
                                    source (0 closed, 1 open, 2 half-
                                    open); the label set is bounded by
                                    BreakerRegistry.max_sources
  serve_shed_total{reason=}         requests the daemon shed before
                                    spending execution on them
                                    ("queue_wait" = brownout on pqt-serve
                                    queue pressure, "breaker_open" = a
                                    blacked-out source fast-failed)
  process_uptime_seconds            gauge: seconds since process start
                                    (refreshed at every exposition
                                    render; /v1/debug/vars reports its
                                    own service-relative uptime_s)
  serve_tenant_cpu_seconds_total{tenant=}  executor CPU seconds (thread-
                                    time deltas around row-group units)
                                    charged to the admission-resolved
                                    tenant key — the "who is spending the
                                    machine" counter; bounded by the same
                                    sanitized-tenant table as
                                    serve_requests_total
  serve_tenant_decoded_bytes_total{tenant=}  uncompressed bytes decoded
                                    on behalf of each tenant (charged
                                    from the request's trace rollup at
                                    finish); /v1/debug/tenants carries
                                    the full usage table (source-read
                                    bytes, cache hits/misses, payload)
  obs_profile_samples_total{lane=}  continuous-profiler stack samples
                                    per pool lane (pqt-io/pqt-data/
                                    pqt-serve/pqt-encode/pqt-hedge/
                                    pqt-dispatch/other) —
                                    obs_profile_windows_total counts
                                    completed capture windows
  io_http_requests_total{status=}   HTTP round trips issued by remote
                                    sources (io.remote), per response
                                    status code
  io_http_connections_total{event=} pooled-connection lifecycle: "new"
                                    sockets opened vs "reused" checkouts
                                    from the per-host persistent pool
  io_resigns_total                  presigned-URL refreshes by
                                    ObjectStoreSource (proactive expiry
                                    refresh + reactive 401/403 re-signs)
  io_put_requests_total{status=}    HTTP round trips issued by remote
                                    SINKS (io.remote_sink: part PUTs,
                                    initiate/complete/abort), per status
  io_put_bytes_total                payload bytes acknowledged by the
                                    remote store (CRC-verified parts +
                                    single-shot PUTs — retries of a part
                                    count its bytes once)
  io_put_retries_total{reason=}     per-part/commit retry ladder steps,
                                    by fault shape ("http_503",
                                    "transport", "part_etag_mismatch")
  io_sign_requests_total{method=}   requests signed by the SigV4-style
                                    header signer (io.sign), per HTTP
                                    method — symmetric GET/PUT auth
  sink_multipart_initiated_total    multipart uploads initiated by
                                    HttpSink; _parts_total counts
                                    acknowledged part PUTs,
                                    _completed_total commits (the object
                                    became visible), _aborted_total
                                    abort-upload teardowns (nothing
                                    became visible)
  cache_tier_hits_total{tier=}      tiered-cache hits per tier (ram /
                                    disk); cache_tier_misses_total
                                    counts full misses (both tiers)
  cache_tier_evictions_total{tier=} blocks evicted per tier (ram
                                    evictions SPILL to disk; disk
                                    evictions drop whole oldest
                                    segments)
  cache_tier_spills_total           blocks spilled RAM -> disk
                                    (cache_tier_spill_bytes_total is
                                    the payload byte volume)
  cache_tier_promotions_total       disk hits promoted back to RAM
  cache_tier_restored_blocks_total  intact spilled blocks re-indexed
                                    from a persistent cache_dir at
                                    startup (restart survival)
  cache_tier_torn_segments_total    spill segments found torn at replay
                                    — the rest of the segment is
                                    DISCARDED, never served
  cache_tier_bytes{tier=}           gauge: resident bytes per tier
  io_autotune_gap_bytes{profile=}   gauge: the IO tuner's current
                                    coalesce-gap verdict per transport
                                    profile ("local", "http://host:port")
  io_autotune_latency_ms{profile=}  gauge: the EWMA per-request read
                                    latency behind that verdict
  events_total{event="device_filter_engaged"|"device_filter_declined"}
                                    the device row-filter engine ladder,
                                    one per row-group mask: "engaged" =
                                    the mask reduced in device memory
                                    (core/filter_device), "declined" = a
                                    typed DeviceFilterError re-derived it
                                    on the host vec engine — output
                                    identical either way
  events_total{event="device_write_engaged"|"device_write_declined"}
                                    the device write ladder, one per
                                    write_device_column chunk at flush:
                                    "engaged" = pages encoded by
                                    encode_device_column, "declined" = a
                                    typed shape refusal (dict byte
                                    arrays, BYTE_STREAM_SPLIT, width
                                    mismatches, ...) re-encoded host-side
                                    — bytes identical either way
  events_total{event="dataset_units_row_filtered"}
                                    dataset units whose delivered batch
                                    rows were masked by
                                    ParquetDataset(filter_rows=True)
  query_device_units_total{engine=} /v1/query row-group units by
                                    engine: "device" = partial aggregate
                                    reduced in device memory
                                    (serve/query_device),
                                    "host_fallback" = a shape outside the
                                    device envelope (group_by, float,
                                    decimal, bool, string and temporal
                                    aggregates) answered by the host
                                    engine (serve.aggregate.
                                    query_device_counts() is its view)
  mesh_requests_total{endpoint=,mode=}  requests the mesh router routed,
                                    "scatter" = fanned out per plan unit,
                                    "passthrough" = forwarded whole to
                                    one replica (limit/shard-pinned and
                                    0/1-unit requests)
  mesh_backend_requests_total{status=}  router->replica HTTP round trips,
                                    per response status (the router-side
                                    twin of io_http_requests_total)
  mesh_retries_total{reason=}       backend attempts the mesh client
                                    failed over: "transport" (reset/
                                    truncated/refused), "5xx", "draining"
                                    (clean shed, breaker untouched),
                                    "shed" (brownout/queue_full/429),
                                    "breaker_open" (fast-fail, no
                                    transport touch)
  mesh_hedges_total{outcome=}       hedged duplicates to a second
                                    replica: "launched" when the first
                                    attempt outlives its replica's p95,
                                    then "won_primary"/"won_hedge"
  mesh_replica_state{replica=}      gauge: composite routing state per
                                    replica (0 up, 1 degraded, 2
                                    draining, 3 open-breaker, 4 down);
                                    label set bounded by the static
                                    --replica list
  mesh_scatter_units_total{endpoint=}  plan units fanned out by
                                    scatter-gather execution
  mesh_partial_failures_total{target=}  requests that exhausted EVERY
                                    replica and surfaced the typed
                                    partial_failure error
  lake_manifest_commits_total       generations committed to a lake
                                    manifest (ingest flushes + compactor
                                    rewrites)
  lake_generation                   gauge: the current generation number
                                    of the last-touched lake table
  lake_files / lake_rows            gauges: file and row counts of the
                                    current snapshot after a commit
  lake_files_unlinked_total         data files deleted once no retained
                                    generation referenced them
  lake_orphans_reaped_total         crash leftovers (unreferenced tmp/
                                    parquet past the grace window)
                                    removed by reap_orphans
  lake_append_rows_total            rows accepted by ingest append
  lake_append_bytes_total           request payload bytes accepted by
                                    ingest append
  lake_flushes_total                ingest buffer flushes (each publishes
                                    exactly one generation)
  lake_flush_seconds                histogram: sort+encode+commit latency
                                    of one ingest flush
  lake_compactions_total            background compaction passes that
                                    committed a rewrite
  lake_compact_files_total          small input files folded away by
                                    compaction
  lake_compact_rows_total           rows rewritten into sort-keyed row
                                    groups by compaction
  lake_compact_seconds              histogram: wall time of one
                                    merge+rewrite+commit pass
  io_multirange_requests_total{outcome=}  coalesced multi-range HTTP
                                    attempts: "ok" (one multipart round
                                    trip served every range),
                                    "full_body" (200 — sliced locally),
                                    "unsupported" (server collapsed the
                                    set; per-range latched on),
                                    "transport_fallback" /
                                    "parse_fallback" (this call fell
                                    back, next call tries again)
  io_multirange_parts_total         byterange parts parsed out of
                                    multipart/byteranges responses

Exposition variants: render_prometheus() is the classic text format every
scraper understands; render_openmetrics() is the content-negotiated
OpenMetrics 1.0 document (`Accept: application/openmetrics-text` on
GET /metrics) that additionally carries EXEMPLARS — request-ids attached
to serve_request_seconds buckets via observe(exemplar=...) — and ends
with `# EOF`. The classic output is byte-for-byte unaffected by
exemplars.

Snapshot keys are flat strings in Prometheus sample syntax without the
prefix: `pages_decoded_total{encoding="PLAIN"}`. Histograms snapshot as
`<name>_count` / `<name>_sum` / `<name>_min` / `<name>_max`; min/max are
not monotonic, so `delta()` skips them.

Three kinds: counters (`inc`, monotonic), histograms (`observe`), and gauges
(`set` / module-level `set_gauge` — a last-written level such as the
dataset prefetch queue depth). Gauges snapshot at their current value and
expose as `# TYPE ... gauge`; like histogram min/max they are not
monotonic, so `delta()` skips them.
"""

from __future__ import annotations

import os
import re
import threading
import time

__all__ = [
    "MetricsRegistry",
    "REGISTRY",
    "inc",
    "observe",
    "set_gauge",
    "get",
    "snapshot",
    "delta",
    "render_prometheus",
    "render_openmetrics",
    "process_stats",
    "report",
    "event",
    "page_decoded",
    "io_bytes",
    "encoding_name",
    "codec_name",
    "summarize_columns",
]

_PREFIX = "parquet_tpu_"

# log-ish spacing covering sub-ms page decodes through multi-second chunks
_DEFAULT_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


def _escape_label_value(v) -> str:
    # the Prometheus text-format escapes: backslash, double-quote, newline
    # (in that order — escaping the escape character first)
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return f"{name}{{{inner}}}"


def _format_le(le) -> str:
    """A histogram bound as a plain decimal (never repr()'s scientific
    notation): 0.0005 -> "0.0005", 1.0 -> "1" — what Prometheus tooling
    and humans both read without surprises."""
    s = f"{float(le):.12f}".rstrip("0").rstrip(".")
    return s or "0"


# one-line family descriptions, rendered as `# HELP` in the exposition —
# the prose lives in the module docstring; this is the scrape-visible form
_HELP = {
    "pages_decoded_total": "pages decoded, per wire encoding",
    "page_bytes_total": "uncompressed page bytes, per encoding",
    "bytes_compressed_total": "wire bytes entering decompression, per codec",
    "bytes_uncompressed_total": "bytes leaving decompression, per codec",
    "chunk_decode_seconds": "per-chunk decode wall time",
    "events_total": "every trace.bump() event, always-on",
    "io_bytes_read_total": "bytes actually read from byte sources",
    "io_read_calls_total": "source read calls (coalescing shrinks it)",
    "io_retries_total": "failed source attempts absorbed by the retry ladder",
    "io_cache_hits_total": "block-cache hits",
    "io_cache_misses_total": "block-cache misses",
    "io_cache_bytes": "block-cache resident bytes",
    "io_footer_cache_hits_total": "footer/metadata cache hits",
    "io_footer_cache_misses_total": "footer/metadata cache misses",
    "pages_written_total": "pages encoded by the write side, per encoding",
    "write_bytes_total": "encoded row-group bytes committed to sinks, per codec",
    "encode_seconds": "per-chunk encode wall time",
    "sink_bytes_written_total": "bytes actually written to byte sinks",
    "sink_write_calls_total": "sink write calls",
    "assembly_rows_total": "rows materialized by record assembly, per engine",
    "assembly_seconds": "row-materialization wall time",
    "dataset_batches_total": "batches delivered by ParquetDataset",
    "dataset_rows_total": "rows delivered by ParquetDataset",
    "dataset_wait_seconds": "consumer wait for the next decoded unit",
    "dataset_prefetch_depth": "dataset units currently in flight",
    "serve_requests_total": "scan-service requests finished, by status and tenant",
    "serve_queue_depth": "requests admitted and in flight in the serve daemon",
    "serve_request_seconds": "request wall time entry to last byte, per endpoint",
    "serve_scan_bytes_total": "response payload bytes streamed by /v1/scan",
    "serve_slow_requests_total": "requests at/over the slow_ms threshold, per endpoint",
    "pool_queue_depth": "tasks submitted to a pqt-* pool and not yet running",
    "pool_active_workers": "tasks currently running on a pqt-* pool",
    "pool_queue_wait_seconds": "submit-to-start wait per pool",
    "pool_task_seconds": "task wall time per pool",
    "obs_requests_recorded_total": "flight-recorder records opened, per endpoint",
    "obs_ring_evictions_total": "records evicted from the flight-recorder ring",
    "obs_traces_retained_total": "span trees retained by the flight recorder",
    "obs_ring_records": "flight-recorder ring occupancy",
    "log_events_total": "structured log events emitted, per event key",
    "log_suppressed_total": "log events absorbed by the rate limiter, per event key",
    "dataset_prefetch_target": "the SLO controller's current prefetch-depth target",
    "dataset_slo_violations_total": "consumer waits that exceeded the configured SLO",
    "io_hedges_total": "hedged-read outcomes (launched, win_primary, win_hedge, failed)",
    "io_breaker_state": "circuit-breaker state per source (0 closed, 1 open, 2 half-open)",
    "serve_shed_total": "requests shed before execution, per reason",
    "process_uptime_seconds": "seconds since process start, refreshed at each exposition render",
    "serve_tenant_cpu_seconds_total": "executor CPU seconds charged per tenant",
    "serve_tenant_decoded_bytes_total": "decoded (uncompressed) bytes charged per tenant",
    "obs_profile_samples_total": "sampling-profiler stack samples, per pool lane",
    "obs_profile_windows_total": "sampling-profiler capture windows completed",
    # query push-down: residual filtering + aggregation
    "query_rows_filtered_total": (
        "rows removed by residual predicate evaluation, per engine "
        "(vec: the chunk-level mask pipeline; arrow: pyarrow-compute "
        "fallback masks; scalar: the per-row walk)"
    ),
    "filter_mask_seconds": "vectorized residual mask build wall time",
    "serve_aggregate_requests_total": (
        "aggregation push-down queries executed (/v1/query and the CLI twin)"
    ),
    # remote IO + tiered cache + auto-tuning
    "io_http_requests_total": "HTTP round trips by remote sources, per status",
    "io_http_connections_total": (
        "pooled HTTP connections: new sockets vs reused checkouts"
    ),
    "io_resigns_total": "presigned-URL refreshes by ObjectStoreSource",
    # remote writes + request signing
    "io_put_requests_total": "HTTP round trips by remote sinks, per status",
    "io_put_bytes_total": "payload bytes acknowledged by the remote store",
    "io_put_retries_total": "remote-write retry ladder steps, per fault shape",
    "io_sign_requests_total": "requests header-signed by io.sign, per method",
    "sink_multipart_initiated_total": "multipart uploads initiated",
    "sink_multipart_parts_total": "multipart part PUTs acknowledged",
    "sink_multipart_completed_total": "multipart uploads committed",
    "sink_multipart_aborted_total": "multipart uploads aborted (torn-free)",
    "cache_tier_hits_total": "tiered-cache hits, per tier (ram/disk)",
    "cache_tier_misses_total": "tiered-cache full misses (both tiers)",
    "cache_tier_evictions_total": "tiered-cache blocks evicted, per tier",
    "cache_tier_spills_total": "blocks spilled RAM -> disk",
    "cache_tier_spill_bytes_total": "payload bytes spilled RAM -> disk",
    "cache_tier_promotions_total": "disk hits promoted back to RAM",
    "cache_tier_restored_blocks_total": (
        "spilled blocks re-indexed from a persistent cache dir at startup"
    ),
    "cache_tier_torn_segments_total": (
        "spill segments found torn at replay (their tails are discarded)"
    ),
    "cache_tier_bytes": "tiered-cache resident bytes, per tier",
    "io_autotune_gap_bytes": (
        "the IO tuner's current coalesce-gap verdict, per transport profile"
    ),
    "io_autotune_latency_ms": (
        "EWMA per-request read latency, per transport profile"
    ),
    # mesh telemetry plane: propagation + federation + SLO
    "io_traceparent_injected_total": (
        "traceparent headers injected into outbound HTTP calls, per "
        "transport (get/put)"
    ),
    "io_traceparent_inbound_total": (
        "inbound traceparent resolution outcomes "
        "(accepted/minted/invalid)"
    ),
    "fleet_scrapes_total": "fleet federation peer scrapes, per outcome",
    "fleet_replicas": "replicas merged into the last fleet view",
    "slo_burn_rate": (
        "error-budget burn rate per SLI and window (1.0 spends the "
        "budget exactly at sustainable speed)"
    ),
    "slo_error_budget_remaining": (
        "fraction of the error budget left in the slow window, per SLI"
    ),
    "slo_verdict": "SLO health verdict (0 ok, 1 warn, 2 burning)",
    # mesh routing plane: the sharded-serve router + mesh client
    "mesh_requests_total": (
        "requests routed by the mesh router, per endpoint and mode "
        "(scatter/passthrough)"
    ),
    "mesh_backend_requests_total": (
        "router->replica HTTP round trips, per response status"
    ),
    "mesh_retries_total": (
        "backend attempts the mesh client failed over, per reason "
        "(transport/5xx/draining/shed/breaker_open)"
    ),
    "mesh_hedges_total": (
        "hedged backend duplicates: launched past the replica p95, then "
        "won_primary/won_hedge for how the race resolved"
    ),
    "mesh_replica_state": (
        "gauge: composite replica routing state (0 up, 1 degraded, "
        "2 draining, 3 open-breaker, 4 down); one series per --replica"
    ),
    "mesh_scatter_units_total": (
        "plan units fanned out by scatter-gather, per endpoint"
    ),
    "mesh_partial_failures_total": (
        "requests that exhausted every replica (typed partial_failure), "
        "per target route"
    ),
    # the lake write path: streaming ingest, snapshot manifest,
    # background compaction
    "lake_manifest_commits_total": (
        "generations committed to a lake manifest (ingest flushes + "
        "compactor rewrites)"
    ),
    "lake_generation": (
        "gauge: current generation number of the last-touched lake table"
    ),
    "lake_files": "gauge: file count of the current snapshot after a commit",
    "lake_rows": "gauge: row count of the current snapshot after a commit",
    "lake_files_unlinked_total": (
        "data files deleted once no retained generation referenced them"
    ),
    "lake_orphans_reaped_total": (
        "crash leftovers (unreferenced tmp/parquet past the grace window) "
        "removed by reap_orphans"
    ),
    "lake_append_rows_total": "rows accepted by ingest append",
    "lake_append_bytes_total": (
        "request payload bytes accepted by ingest append"
    ),
    "lake_flushes_total": (
        "ingest buffer flushes; each publishes exactly one generation"
    ),
    "lake_flush_seconds": (
        "sort+encode+commit latency of one ingest flush"
    ),
    "lake_compactions_total": (
        "background compaction passes that committed a rewrite"
    ),
    "lake_compact_files_total": (
        "small input files folded away by compaction"
    ),
    "lake_compact_rows_total": (
        "rows rewritten into sort-keyed row groups by compaction"
    ),
    "lake_compact_seconds": (
        "wall time of one merge+rewrite+commit compaction pass"
    ),
    "io_multirange_requests_total": (
        "coalesced multi-range HTTP attempts, per outcome "
        "(ok/full_body/unsupported/transport_fallback/parse_fallback)"
    ),
    "io_multirange_parts_total": (
        "byterange parts parsed out of multipart/byteranges responses"
    ),
    # process self-metrics, refreshed at exposition render (stdlib /proc
    # reads; absent on platforms without procfs)
    "process_resident_memory_bytes": "resident set size of this process",
    "process_open_fds": "open file descriptors held by this process",
    "process_threads_total": "OS threads in this process",
    # the port's own families (counts the reference keeps in its log or in
    # a gauge only)
    "admission_rejected_total": "typed admission rejections, per code",
    "serve_drains_total": "graceful drains, by whether they drained in time",
    "mesh_replica_state_total": (
        "passive replica notes, per replica and the composite routing "
        "state after each (up, degraded, draining, open-breaker, down)"
    ),
    "lake_compact_skipped_total": "compaction passes skipped, per lake error code",
    "lake_compact_errors_total": "compaction loop passes that failed",
}


class _Hist:
    __slots__ = (
        "count", "total", "vmin", "vmax", "buckets", "bucket_counts",
        "exemplars",
    )

    def __init__(self, buckets=_DEFAULT_BUCKETS):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.buckets = buckets
        self.bucket_counts = [0] * len(buckets)
        # per-bucket last exemplar (index len(buckets) = the +Inf bucket):
        # (labels dict, observed value, unix ts) — allocated on first use
        # so histograms nobody attaches exemplars to pay one None
        self.exemplars: list | None = None

    def observe(self, v: float, exemplar: dict | None = None) -> None:
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        slot = len(self.buckets)  # +Inf unless a finite bound admits v
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.bucket_counts[i] += 1
                slot = min(slot, i)
        if exemplar is not None:
            # last-write-wins in the value's CANONICAL (first admitting)
            # bucket: one recent trace reference per latency band, bounded
            # by the bucket count — never by traffic
            if self.exemplars is None:
                self.exemplars = [None] * (len(self.buckets) + 1)
            self.exemplars[slot] = (dict(exemplar), v, time.time())


class MetricsRegistry:
    """Lock-cheap counters + histograms with snapshot/delta and Prometheus
    text exposition. One instance (REGISTRY) serves the whole process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], int | float] = {}
        self._hists: dict[tuple[str, tuple], _Hist] = {}
        self._gauges: dict[tuple[str, tuple], int | float] = {}
        # family names that are gauges: delta() must skip them (a gauge
        # difference is as meaningless as a histogram min/max difference)
        self._gauge_names: set[str] = set()

    # -- write side ------------------------------------------------------------

    def inc(self, name: str, n=1, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def set(self, name: str, value, **labels) -> None:
        """Set a gauge to its current level (last write wins) — for
        non-monotonic quantities like queue depths or in-flight counts."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = value
            self._gauge_names.add(name)

    def observe(
        self, name: str, value: float, exemplar: dict | None = None, **labels
    ) -> None:
        """Record one histogram observation. `exemplar` (a small dict such
        as {"request_id": ...}) attaches a metric→trace reference to the
        value's bucket, rendered only by the OpenMetrics exposition — the
        classic text format ignores it entirely."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist()
            h.observe(value, exemplar)

    def hist_stats(self, name: str, **labels) -> dict:
        """One histogram's running totals — {"count", "sum", "buckets",
        "bucket_counts"} — without paying for a full snapshot(). The cheap
        windowed-delta feed for feedback controllers (the SLO controller
        polls this every control window); a never-observed histogram
        returns zeros over the default buckets."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                return {
                    "count": 0,
                    "sum": 0.0,
                    "buckets": tuple(_DEFAULT_BUCKETS),
                    "bucket_counts": [0] * len(_DEFAULT_BUCKETS),
                }
            return {
                "count": h.count,
                "sum": h.total,
                "buckets": tuple(h.buckets),
                "bucket_counts": list(h.bucket_counts),
            }

    # -- read side -------------------------------------------------------------

    def get(self, name: str, **labels):
        """Current value of one counter or gauge (0 when never written)."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            if key in self._gauges:
                return self._gauges[key]
            return self._counters.get(key, 0)

    def snapshot(self) -> dict:
        """Flat {sample key: value} of every counter, gauge and histogram."""
        out = {}
        with self._lock:
            for (name, labels), v in self._counters.items():
                out[_key(name, dict(labels))] = v
            for (name, labels), v in self._gauges.items():
                out[_key(name, dict(labels))] = v
            for (name, labels), h in self._hists.items():
                ld = dict(labels)
                out[_key(name + "_count", ld)] = h.count
                out[_key(name + "_sum", ld)] = h.total
                if h.count:
                    out[_key(name + "_min", ld)] = h.vmin
                    out[_key(name + "_max", ld)] = h.vmax
        return out

    def delta(self, previous: dict) -> dict:
        """What changed since `previous` (a snapshot()): {key: now - then},
        zero-diff keys omitted. Histogram _min/_max and gauges are skipped —
        they are not monotonic, so their difference is meaningless."""
        now = self.snapshot()
        with self._lock:
            gauge_names = set(self._gauge_names)
        out = {}
        for k, v in now.items():
            base = k.split("{", 1)[0]
            if base.endswith("_min") or base.endswith("_max"):
                continue
            if base in gauge_names:
                continue
            d = v - previous.get(k, 0)
            if d:
                out[k] = d
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (families prefixed parquet_tpu_)."""
        lines = []
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._hists.items())
        seen_types = set()

        def family_header(name: str, kind: str) -> None:
            if name in seen_types:
                return
            seen_types.add(name)
            doc = _HELP.get(name)
            if doc:
                lines.append(f"# HELP {_PREFIX}{name} {doc}")
            lines.append(f"# TYPE {_PREFIX}{name} {kind}")

        for (name, labels), v in counters:
            family_header(name, "counter")
            lines.append(f"{_PREFIX}{_key(name, dict(labels))} {v}")
        for (name, labels), v in gauges:
            family_header(name, "gauge")
            lines.append(f"{_PREFIX}{_key(name, dict(labels))} {v}")
        for (name, labels), h in hists:
            family_header(name, "histogram")
            ld = dict(labels)
            # bucket_counts are cumulative already (observe() increments
            # every bucket whose bound admits the value)
            for le, c in zip(h.buckets, h.bucket_counts):
                lines.append(
                    f"{_PREFIX}{_key(name + '_bucket', {**ld, 'le': _format_le(le)})} {c}"
                )
            lines.append(
                f"{_PREFIX}{_key(name + '_bucket', {**ld, 'le': '+Inf'})} {h.count}"
            )
            lines.append(f"{_PREFIX}{_key(name + '_sum', ld)} {h.total}")
            lines.append(f"{_PREFIX}{_key(name + '_count', ld)} {h.count}")
        return "\n".join(lines) + "\n"

    def render_openmetrics(self) -> str:
        """OpenMetrics 1.0 text exposition — the content-negotiated
        variant of render_prometheus() (Accept: application/openmetrics-
        text). Differences from the classic format, per the spec:

          * counter FAMILIES drop their `_total` suffix in # TYPE/# HELP
            while samples keep it (`# TYPE ..._requests counter` +
            `..._requests_total{...} 3`);
          * histogram bucket samples may carry an EXEMPLAR — ` # {labels}
            value timestamp` — here the request-id attached via
            observe(exemplar=...), which is the dashboard→flight-recorder
            link: a latency bucket names the exact request an operator can
            fetch from /v1/debug/requests/<id>;
          * the document terminates with `# EOF`.

        Scrapers that never ask for OpenMetrics see the classic format
        unchanged (exemplars are invisible there)."""
        lines = []
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = [
                (k, h, list(h.exemplars) if h.exemplars else None)
                for k, h in sorted(self._hists.items())
            ]
        seen_types = set()

        def family_header(name: str, kind: str, family=None) -> None:
            if name in seen_types:
                return
            seen_types.add(name)
            fam = family if family is not None else name
            doc = _HELP.get(name)
            lines.append(f"# TYPE {_PREFIX}{fam} {kind}")
            if doc:
                lines.append(f"# HELP {_PREFIX}{fam} {doc}")

        def exemplar_suffix(ex) -> str:
            if ex is None:
                return ""
            labels, value, ts = ex
            inner = ",".join(
                f'{k}="{_escape_label_value(v)}"'
                for k, v in sorted(labels.items())
            )
            return f" # {{{inner}}} {value:g} {ts:.3f}"

        for (name, labels), v in counters:
            fam = name[: -len("_total")] if name.endswith("_total") else name
            family_header(name, "counter", family=fam)
            lines.append(f"{_PREFIX}{_key(name, dict(labels))} {v}")
        for (name, labels), v in gauges:
            family_header(name, "gauge")
            lines.append(f"{_PREFIX}{_key(name, dict(labels))} {v}")
        for ((name, labels), h, exemplars) in hists:
            family_header(name, "histogram")
            ld = dict(labels)
            for i, (le, c) in enumerate(zip(h.buckets, h.bucket_counts)):
                ex = exemplars[i] if exemplars else None
                lines.append(
                    f"{_PREFIX}{_key(name + '_bucket', {**ld, 'le': _format_le(le)})}"
                    f" {c}{exemplar_suffix(ex)}"
                )
            ex = exemplars[len(h.buckets)] if exemplars else None
            lines.append(
                f"{_PREFIX}{_key(name + '_bucket', {**ld, 'le': '+Inf'})}"
                f" {h.count}{exemplar_suffix(ex)}"
            )
            lines.append(f"{_PREFIX}{_key(name + '_sum', ld)} {h.total}")
            lines.append(f"{_PREFIX}{_key(name + '_count', ld)} {h.count}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every metric (tests only — production counters are
        monotonic for the life of the process)."""
        with self._lock:
            self._counters.clear()
            self._hists.clear()
            self._gauges.clear()
            self._gauge_names.clear()


REGISTRY = MetricsRegistry()

# Process start, for the process_uptime_seconds gauge the expositions
# refresh on every render (a scrape always sees current uptime).
_PROCESS_START = time.time()


def _refresh_uptime(registry: MetricsRegistry) -> None:
    registry.set(
        "process_uptime_seconds", round(time.time() - _PROCESS_START, 3)
    )


def process_stats() -> dict:
    """Best-effort process self-stats from /proc (stdlib only): rss bytes,
    open fd count, OS thread count. Keys are present only when their
    source is readable — on platforms without procfs the dict is simply
    empty, and the gauges never appear in the exposition."""
    out: dict = {}
    try:
        with open("/proc/self/statm", "rb") as f:
            rss_pages = int(f.read().split()[1])
        out["rss_bytes"] = rss_pages * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, ValueError, IndexError):
        pass
    try:
        out["open_fds"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    try:
        with open("/proc/self/status", "rb") as f:
            for line in f:
                if line.startswith(b"Threads:"):
                    out["threads"] = int(line.split()[1])
                    break
    except (OSError, ValueError, IndexError):
        pass
    if "threads" not in out:
        # portable fallback: Python-visible threads (misses non-Python
        # OS threads, but beats absence on non-procfs platforms)
        out["threads"] = threading.active_count()
    return out


def _refresh_process_metrics(registry: MetricsRegistry) -> None:
    """Refresh the process self-gauges at exposition render, so every
    scrape sees current values without a background sampler thread."""
    stats = process_stats()
    if "rss_bytes" in stats:
        registry.set("process_resident_memory_bytes", stats["rss_bytes"])
    if "open_fds" in stats:
        registry.set("process_open_fds", stats["open_fds"])
    if "threads" in stats:
        registry.set("process_threads_total", stats["threads"])


# -- module-level convenience (the registry everyone means) --------------------


def inc(name: str, n=1, **labels) -> None:
    REGISTRY.inc(name, n, **labels)


def observe(
    name: str, value: float, exemplar: dict | None = None, **labels
) -> None:
    REGISTRY.observe(name, value, exemplar, **labels)


def set_gauge(name: str, value, **labels) -> None:
    REGISTRY.set(name, value, **labels)


def get(name: str, **labels):
    return REGISTRY.get(name, **labels)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def delta(previous: dict) -> dict:
    return REGISTRY.delta(previous)


def render_prometheus() -> str:
    _refresh_uptime(REGISTRY)
    _refresh_process_metrics(REGISTRY)
    return REGISTRY.render_prometheus()


def render_openmetrics() -> str:
    _refresh_uptime(REGISTRY)
    _refresh_process_metrics(REGISTRY)
    return REGISTRY.render_openmetrics()


# -- the decode plumbing's vocabulary ------------------------------------------


def event(name: str, n: int = 1) -> None:
    """Always-on counterpart of trace.bump(): every bump dual-reports here
    so fused/fallback/quarantine counts survive outside any trace."""
    REGISTRY.inc("events_total", n, event=name)


def page_decoded(encoding: str, n: int = 1, nbytes: int = 0) -> None:
    REGISTRY.inc("pages_decoded_total", n, encoding=encoding)
    if nbytes:
        REGISTRY.inc("page_bytes_total", nbytes, encoding=encoding)


def io_bytes(compressed: int, uncompressed: int, codec) -> None:
    c = codec_name(codec)
    REGISTRY.inc("bytes_compressed_total", compressed, codec=c)
    REGISTRY.inc("bytes_uncompressed_total", uncompressed, codec=c)


def encoding_name(enc) -> str:
    try:
        from ..meta.parquet_types import Encoding

        return Encoding(int(enc)).name
    except Exception:
        return str(enc)


def codec_name(codec) -> str:
    if isinstance(codec, str):
        return codec
    try:
        from ..meta.parquet_types import CompressionCodec

        return CompressionCodec(int(codec)).name
    except Exception:
        return str(codec)


_LABEL_RE = re.compile(r'^(?P<name>[^{]+)(?:\{(?P<labels>.*)\})?$')


def _sum_family(snap: dict, family: str) -> int:
    total = 0
    for k, v in snap.items():
        m = _LABEL_RE.match(k)
        if m and m.group("name") == family:
            total += v
    return total


def report(snap: dict | None = None) -> str:
    """Human summary of the process counters (or of a snapshot/delta dict):
    page counts per encoding, byte volumes, compression ratio, decode MB/s."""
    if snap is None:
        snap = REGISTRY.snapshot()
    pages = {}
    events = {}
    for k, v in snap.items():
        m = _LABEL_RE.match(k)
        if not m:
            continue
        name, labels = m.group("name"), m.group("labels") or ""
        if name == "pages_decoded_total":
            pages[labels.split('"')[1] if '"' in labels else labels] = v
        elif name == "events_total" and '"' in labels:
            events[labels.split('"')[1]] = v
    comp = _sum_family(snap, "bytes_compressed_total")
    uncomp = _sum_family(snap, "bytes_uncompressed_total")
    secs = _sum_family(snap, "chunk_decode_seconds_sum")
    lines = []
    enc_part = ", ".join(f"{e}={n}" for e, n in sorted(pages.items()))
    lines.append(f"pages decoded:      {sum(pages.values()):>12,}  ({enc_part})")
    lines.append(f"bytes compressed:   {comp:>12,}")
    lines.append(f"bytes uncompressed: {uncomp:>12,}")
    ratio = f"{uncomp / comp:.2f}x" if comp else "n/a"
    lines.append(f"compression ratio:  {ratio:>12}")
    if secs:
        lines.append(
            f"chunk decode wall:  {secs:>12.4f} s  "
            f"(~{uncomp / secs / 1e6:.0f} MB/s uncompressed)"
        )
    if events:
        ev = ", ".join(f"{k}={v}" for k, v in sorted(events.items()))
        lines.append(f"events:             {ev}")
    return "\n".join(lines)


def summarize_columns(metadata) -> dict:
    """Per-column totals across every row group of a FileMetaData:
    {dotted path: {encodings, compressed, uncompressed, ratio}} — the
    metadata-sourced feed for `parquet-tool meta`'s summary lines (the same
    shape the live registry accumulates per encoding during decode)."""
    out: dict[str, dict] = {}
    for rg in metadata.row_groups or []:
        for cc in rg.columns or []:
            md = cc.meta_data
            if md is None:
                continue
            name = ".".join(md.path_in_schema or [])
            s = out.setdefault(
                name, {"encodings": [], "compressed": 0, "uncompressed": 0}
            )
            for e in md.encodings or []:
                en = encoding_name(e)
                if en not in s["encodings"]:
                    s["encodings"].append(en)
            s["compressed"] += md.total_compressed_size or 0
            s["uncompressed"] += md.total_uncompressed_size or 0
    for s in out.values():
        s["encodings"] = sorted(s["encodings"])
        s["ratio"] = (
            s["uncompressed"] / s["compressed"] if s["compressed"] else None
        )
    return out
