"""Push-down execution of planned scans and queries on the pqt-serve pool.

The port of parquet_tpu/serve/executor.py. The executor turns a PlannedScan
into an incremental byte stream (execute_stream) or one query body
(execute_query):

  * every unit (one row group of one file) runs as an independent task on
    the process-wide bounded `pqt-serve` pool (SERVE_THREADS workers) —
    separate from the pqt-host, pqt-dispatch, pqt-data and pqt-io pools, so
    a unit never blocks on a pool that it needs, and serve traffic can
    never deadlock a dataset loader (and vice versa);
  * results stream back IN PLAN ORDER with a bounded lookahead `window`:
    at most `window` units are in flight or buffered per request, and the
    generator only advances when the consumer (the chunked HTTP write)
    drains — backpressure is the pull itself;
  * predicate push-down continues below the plan's group pruning: a jsonl
    unit reads through FileReader.iter_rows(row_groups=, filters=) (exact
    residual filtering, projection applied at the source through the
    shared BlockCache); a query unit runs serve/query_device.
    device_unit_partial on the daemon's torch.device, or the host engine
    where the device declines it;
  * cancellation is cooperative: the deadline and the abort flag are
    checked between units and every few thousand rows inside one, and
    result waits are bounded by the deadline — an expired or disconnected
    request frees its slot promptly instead of scanning to the end. A
    device unit in mid-read runs to its end; its tensors are freed when
    its task returns.

Output formats: "jsonl" (rows exactly as a FileReader.iter_rows() dump with
json_default prints them, one chunk per unit) and "arrow-ipc" (one Arrow
IPC stream for the whole response: each unit decodes to an Arrow table with
FileReader.to_arrow on the host, as the reference's units do, and ONE
stream writer, core/arrow_ipc.py, frames the units' batches in plan order;
an empty result is the schema and the end of the stream). A residual
filter the host mask declines is a typed 501 not_ported on an arrow unit,
as on the host query engine (the reference evaluates it with pyarrow
compute).

Every unit task goes through obs.pool.instrumented_submit (serve.counts.
submit: the request's trace, log and cost context ride along), runs under
obs.cost.unit_clock (its thread CPU billed to the tenant) and a
serve.execute / serve.aggregate trace stage; the merge and each streamed
chunk are serve.merge / serve.stream stages. A query unit runs on the
reference's engine ladder (serve/aggregate.run_unit): the device first, and
a unit outside the device envelope on the host engine (the unit table and
unit_partial), counted in serve.aggregate.query_device_counts() as
run_local_query counts it ("device", "host_fallback").
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout

from ..core import arrow_ipc
from ..core.arrow_format import ArrowInvalid
from ..core.filter_vec import VecFilterError
from ..core.reader import PARQUET_ERRORS, FileReader
from ..io.source import SourceError
from ..obs.cost import unit_clock
from ..utils.trace import stage
from . import counts as _counts
from .protocol import ServeError, filter_not_ported, json_default

__all__ = ["SERVE_THREADS", "serve_pool", "execute_stream", "execute_query"]

_ROW_CHECK_EVERY = 4096  # rows between cooperative cancellation checks
_WAIT_SLICE_S = 0.1  # result-wait poll granularity (bounds deadline latency)

# the pqt-serve pool's worker count
SERVE_THREADS = min(8, os.cpu_count() or 4)

_pool = None
_pool_lock = threading.Lock()


def serve_pool() -> ThreadPoolExecutor:
    """The process-wide scan-execution pool (SERVE_THREADS workers,
    min(8, cpus)); dedicated so nested pools (chunk prepare, dispatch,
    pqt-io readahead) can never self-deadlock against serve traffic."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=SERVE_THREADS, thread_name_prefix="pqt-serve"
            )
        return _pool


class _Check:
    """The cooperative cancellation point: deadline + abort flag in one
    callable, shared by the request generator and its unit tasks."""

    __slots__ = ("deadline", "abort")

    def __init__(self, deadline=None):
        self.deadline = deadline
        self.abort = threading.Event()

    def __call__(self) -> None:
        if self.abort.is_set():
            raise ServeError(
                499, "cancelled", "request cancelled (client gone or drained)"
            )
        if self.deadline is not None:
            self.deadline.check()

    def wait_slice(self) -> float:
        if self.deadline is None:
            return _WAIT_SLICE_S
        rem = self.deadline.remaining()
        if rem is None:
            return _WAIT_SLICE_S
        return max(0.0, min(_WAIT_SLICE_S, rem))


def _open_reader(session, planned, unit, device) -> FileReader:
    meta = planned.plan.metas[unit.file_index]
    return FileReader(
        session.open_source(unit.path),
        columns=planned.request.columns,
        device=device,
        metadata=meta,
        block_cache=session.block_cache,
        coalesce_gap=getattr(session, "coalesce_gap", None),
    )


def _close_unit_reader(session, reader) -> None:
    # factory-built sources (chaos/remote seam) are caller-owned per the
    # ByteSource contract: the reader won't close them, so we must
    reader.close()
    if session.source_factory is not None:
        reader._source.close()


def _run_jsonl_unit(session, planned, unit, max_rows, check, device):
    """Decode + serialize one unit; returns (payload bytes, rows).
    unit_clock bills the unit's thread time (exact per-thread CPU) to the
    request's tenant through the cost context the submit carried."""
    check()
    with unit_clock(), stage("serve.execute"):
        reader = _open_reader(session, planned, unit, device)
        try:
            lines = []
            n = 0
            for row in reader.iter_rows(
                row_groups=[unit.row_group], filters=planned.request.filters
            ):
                lines.append(json.dumps(row, default=json_default))
                n += 1
                if n % _ROW_CHECK_EVERY == 0:
                    check()
                if max_rows is not None and n >= max_rows:
                    break
            payload = ("\n".join(lines) + "\n").encode() if lines else b""
            return payload, n
        finally:
            _close_unit_reader(session, reader)


def _run_arrow_unit(session, planned, unit, max_rows, check, device):
    """Decode one unit to an Arrow table on the host (serialized by the
    stream side, which owns the single IPC writer). unit_clock: see
    _run_jsonl_unit."""
    check()
    with unit_clock(), stage("serve.execute"):
        reader = _open_reader(session, planned, unit, device)
        try:
            try:
                t = reader.to_arrow(
                    row_groups=[unit.row_group], filters=planned.request.filters
                )
            except VecFilterError as e:
                raise filter_not_ported(e) from None
            if max_rows is not None and t.num_rows > max_rows:
                t = t.slice(0, max_rows)
            return t
        finally:
            _close_unit_reader(session, reader)


def _wait(fut, check: "_Check"):
    """fut's result, polled in deadline-bounded slices so an expired
    request raises its typed 504 even while a unit is stuck."""
    while True:
        check()
        try:
            return fut.result(timeout=check.wait_slice())
        except _FutTimeout:
            continue


def _pipelined(units, run_one, window: int, check: "_Check"):
    """Bounded in-order unit pipeline: submit up to `window` ahead, yield
    results in plan order."""
    pending: deque = deque()
    idx = 0
    try:
        while pending or idx < len(units):
            while idx < len(units) and len(pending) < window:
                pending.append(_counts.submit(serve_pool(), run_one, units[idx]))
                idx += 1
            yield _wait(pending.popleft(), check)
    finally:
        # abort first so already-running tasks exit at their next check,
        # then drop anything still queued
        check.abort.set()
        for f in pending:
            f.cancel()


def _wrap_decode_errors(gen):
    """Typed-error discipline at the execution boundary: a corrupt file
    surfaces as a ServeError (422) the server renders structurally, never
    a raw decode exception unwinding the handler. A circuit breaker's
    fast-fail (SourceError code="breaker_open" — the source is KNOWN dark)
    becomes a 503 with Retry-After instead: the file is fine, the
    transport is down, and the client should back off rather than re-ask.
    Counted serve_shed_total{reason="breaker_open"}."""
    try:
        yield from gen
    except ServeError:
        raise
    except SourceError as e:
        code = getattr(e, "code", None)
        if code == "breaker_open":
            _counts.count("serve_shed_total", reason="breaker_open")
            raise ServeError(
                503, "source_unavailable",
                f"source circuit breaker open: {e}", retry_after_s=1,
            ) from None
        if code == "retry_exhausted":
            # the ladder gave up on a TRANSIENT fault storm: the file is
            # not wrong, the transport is — same 503 + Retry-After shape
            # the raw OSError below gets, not a permanent-looking 422
            raise ServeError(
                503, "source_error", f"{type(e).__name__}: {e}",
                retry_after_s=1,
            ) from None
        raise ServeError(
            422, "unreadable_file", f"{type(e).__name__}: {e}"
        ) from None
    except PARQUET_ERRORS as e:
        raise ServeError(
            422, "unreadable_file", f"{type(e).__name__}: {e}"
        ) from None
    except OSError as e:
        # a raw transport fault (EIO from a flaky store, a vanished mount)
        # is the DAEMON's environment failing, not the request: 503 +
        # Retry-After, not a 500 that reads as a server bug
        raise ServeError(
            503, "source_error", f"{type(e).__name__}: {e}", retry_after_s=1
        ) from None


def _count_bytes(payload: bytes) -> None:
    _counts.count("serve_scan_bytes_total", len(payload))


def _stream_jsonl(planned, session, check, window, device):
    remaining = planned.request.limit
    units = planned.units

    def run(u, cap=None):
        return _run_jsonl_unit(session, planned, u, cap, check, device)

    if remaining is None:
        for payload, _n in _pipelined(units, run, window, check):
            if payload:
                _count_bytes(payload)
                yield payload
        return
    # limited scans run sequentially: each unit's cap is what's left, and
    # lookahead past a satisfied limit would be wasted decode work
    for u in units:
        if remaining <= 0:
            break
        check()
        payload, n = _wait(_counts.submit(serve_pool(), run, u, remaining), check)
        remaining -= n
        if payload:
            _count_bytes(payload)
            yield payload


def _empty_table(planned, session):
    """A zero-row table carrying the scan's schema (so an empty result is
    still a VALID Arrow IPC stream: schema header + EOS)."""
    for fi, meta in enumerate(planned.plan.metas):
        if meta is None:
            continue
        reader = FileReader(
            session.open_source(planned.plan.files[fi]),
            columns=planned.request.columns,
            device="cpu",
            metadata=meta,
        )
        try:
            return reader.to_arrow(row_groups=[])
        finally:
            _close_unit_reader(session, reader)
    raise ServeError(422, "unreadable_file", "no readable file to derive a schema")


def _stream_arrow(planned, session, check, window, device):
    out = arrow_ipc.ChunkedStreamWriter()
    remaining = planned.request.limit
    units = planned.units

    def run(u):
        return _run_arrow_unit(session, planned, u, None, check, device)

    def limited():
        # limited scans run sequentially, each unit capped at what the
        # limit STILL needs (`remaining` shrinks as the loop consumes) —
        # lookahead past a satisfied limit would be wasted decode work
        for u in units:
            if remaining <= 0:
                return
            check()
            yield _wait(
                _counts.submit(
                    serve_pool(), _run_arrow_unit, session, planned, u,
                    remaining, check, device,
                ),
                check,
            )

    try:
        source = (
            _pipelined(units, run, window, check)
            if remaining is None
            else limited()
        )
        for table in source:
            if remaining is not None:
                table = table.slice(0, remaining)
                remaining -= table.num_rows
            try:
                payload = out.write_table(table)
            except ArrowInvalid as e:
                raise ServeError(
                    422, "schema_mismatch",
                    f"files in one scan must share a schema: {e}",
                ) from None
            if payload:
                _count_bytes(payload)
                yield payload
            if remaining is not None and remaining <= 0:
                break
        if not out.opened:
            out.open(_empty_table(planned, session).schema)
        payload = out.close()
        if payload:
            _count_bytes(payload)
            yield payload
    finally:
        check.abort.set()


def execute_query(
    planned, query, session, *, deadline=None, window: int = 2, device=None
):
    """Aggregation push-down over the planned units (POST /v1/query).

    Each unit decodes + filters + partially aggregates on the card as one
    pqt-serve pool task (serve/query_device.device_unit_partial: decode
    into device memory, resident residual mask, one masked_agg launch per
    aggregate); partials merge on the caller's thread with exact semantics
    (serve/aggregate.QueryState), bounded by the request's max_groups. Pure
    count(*) with no filters never opens a file — the footer-promised unit
    row counts ARE the answer. Returns the response body dict; every
    failure mode is a typed ServeError, and the deadline/abort checks run
    between units exactly like streamed scans.

    `device` is the torch.device the units decode to (the daemon's
    ServeConfig.device, resolved; None: CUDA). Each unit tries the device
    first (counted "device" in query_device_counts()); a unit outside the
    device envelope falls back, typed and counted "host_fallback", to the
    host engine (serve/aggregate.host_unit_partial), as the reference's
    executor does."""
    from .aggregate import (
        QueryState,
        query_columns,
        result_dict,
        run_unit,
        unit_count_partial,
    )

    check = _Check(deadline)
    if window < 1:
        raise ValueError("executor: window must be >= 1")
    cols = query_columns(query)
    decode = bool(cols) or query.filters is not None
    state = QueryState(query)
    units = planned.units
    # a streamed scan's window bounds BUFFERED payload; a query's unit
    # results are kilobyte partials, so the lookahead widens to the pool —
    # merge order doesn't matter and idle workers are pure waste
    window = max(window, min(SERVE_THREADS, len(units) or 1))

    def run(u):
        check()
        if not decode:
            return (
                unit_count_partial(query, u.num_rows), u.num_rows, u.num_rows
            )
        with unit_clock(), stage("serve.aggregate"):
            reader = _open_reader(session, planned, u, device)
            try:
                return run_unit(reader, u.row_group, query, planned.request.filters)
            finally:
                _close_unit_reader(session, reader)

    gen = _pipelined(units, run, window, check)
    try:
        for part in _wrap_decode_errors(gen):
            with stage("serve.merge"):
                state.absorb(part)
    finally:
        gen.close()
    _counts.count("serve_aggregate_requests_total")
    return result_dict(query, state, units=len(units))


def execute_stream(planned, session, *, deadline=None, window: int = 2, device=None):
    """The request's payload-chunk generator. Pull-driven: nothing decodes
    beyond `window` units ahead of what the consumer has taken, and closing
    the generator (client disconnect) aborts in-flight unit tasks at their
    next cooperative check. Raises ServeError (typed) for every failure
    mode — deadline, cancellation, corrupt data, schema drift. Rows and
    Arrow tables decode on the host (iter_rows, to_arrow); `device` is the
    readers' device (None: CUDA), which neither read touches."""
    check = _Check(deadline)
    if window < 1:
        raise ValueError("executor: window must be >= 1")
    if planned.request.format == "arrow-ipc":
        gen = _stream_arrow(planned, session, check, window, device)
    else:
        gen = _stream_jsonl(planned, session, check, window, device)

    def outer():
        try:
            for payload in _wrap_decode_errors(gen):
                # the stage brackets the YIELD: its wall time is how long
                # the consumer (the chunked HTTP write) took to drain this
                # chunk, the backpressure measurement
                with stage("serve.stream", nbytes=len(payload)):
                    yield payload
        finally:
            check.abort.set()
            gen.close()

    return outer()

