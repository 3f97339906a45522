"""Range planning for Parquet reads: exact ranges, coalescing, readahead.

A Parquet footer names the exact byte extent of everything a projected +
filtered read will touch — column-chunk page runs, page-index structures,
bloom filters. Production readers (pyarrow's dataset scanner, parquet-mr's
Hadoop input streams) exploit that: plan the ranges up front, merge
near-neighbors into one transport request, fetch batches ahead of decode.
This module is that layer:

  plan_ranges()    FileMetaData + (row groups, column paths) -> the exact
                   (offset, length) list the read needs; nothing else is
                   ever fetched (projection efficiency is measurable:
                   io_bytes_read_total vs the file size)
  coalesce()       sorted ranges whose gap is under a threshold merge into
                   one run (default 64 KiB — around the point where a
                   second ~ms-latency range GET costs more than re-reading
                   the gap bytes); runs are capped so one merge never
                   becomes an unbounded single read
  fetch_ranges()   the one choke point reads go through: block-cache
                   lookup, coalesce, batched source.read_ranges under the
                   io.read trace stage, member slicing, cache fill
  Readahead        a bounded scheduler on the dedicated pqt-io pool:
                   fetches planned ranges into a BlockCache ahead of
                   decode, with a budget on in-flight bytes; over-budget
                   schedules are DROPPED, not queued (readahead is
                   advisory — decode stays correct reading through the
                   cache-missing path). The pool is distinct from the
                   prepare ("pqt-host") and dataset ("pqt-data") pools so
                   no layer can deadlock waiting on its own executor.

Counts in io.counts; the pqt-io pool goes through obs.pool.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..obs.pool import instrumented_submit
from ..utils.trace import stage
from .counts import count as _count
from .autotune import io_tuner, profile_key

__all__ = [
    "DEFAULT_COALESCE_GAP",
    "DEFAULT_MAX_RUN",
    "plan_ranges",
    "coalesce",
    "fetch_ranges",
    "Readahead",
    "io_pool",
]

# Merge ranges separated by less than this many bytes (64 KiB: past it, on
# a ~1 GB/s local disk the wasted gap read costs about what a fresh syscall
# does; on a ~ms-latency object store the break-even gap is far LARGER —
# tune up via coalesce_gap for remote sources).
DEFAULT_COALESCE_GAP = 64 << 10

# Never merge into a single read larger than this: one run must not hold
# the whole transport (or the readahead budget) hostage.
DEFAULT_MAX_RUN = 16 << 20


def plan_ranges(
    meta,
    *,
    row_groups=None,
    columns=None,
    page_index: bool = False,
    blooms: bool = False,
) -> list[tuple[int, int]]:
    """The exact (offset, length) byte ranges a read of `meta` needs.

    `row_groups` is an iterable of group indices (None = all); `columns` a
    set/collection of leaf path TUPLES (None = all). `page_index` adds each
    selected chunk's ColumnIndex/OffsetIndex extents, `blooms` its bloom
    filter (when the footer records a length — headers-only blooms have no
    planned extent and fall back to the reader's peek path). Chunks with
    unusable metadata are skipped here; the decode path reports the precise
    typed error."""
    from ..core.chunk import ChunkError, chunk_byte_range

    groups = meta.row_groups or []
    indices = range(len(groups)) if row_groups is None else row_groups
    selected = None if columns is None else {tuple(p) for p in columns}
    out: list[tuple[int, int]] = []
    for gi in indices:
        if not 0 <= gi < len(groups):
            continue
        for cc in groups[gi].columns or []:
            md = cc.meta_data
            if md is None:
                continue
            path = tuple(md.path_in_schema or [])
            if selected is not None and path not in selected:
                continue
            try:
                off, total = chunk_byte_range(cc)
            except ChunkError:
                continue
            out.append((off, total))
            if page_index:
                if cc.column_index_offset and cc.column_index_length:
                    out.append((cc.column_index_offset, cc.column_index_length))
                if cc.offset_index_offset and cc.offset_index_length:
                    out.append((cc.offset_index_offset, cc.offset_index_length))
            if blooms and md.bloom_filter_offset and md.bloom_filter_length:
                out.append((md.bloom_filter_offset, md.bloom_filter_length))
    return out


def coalesce(
    ranges,
    gap: int = DEFAULT_COALESCE_GAP,
    max_run: int = DEFAULT_MAX_RUN,
) -> list[tuple[int, int, list[tuple[int, int]]]]:
    """Merge (offset, length) ranges into batched read runs.

    Returns [(run_offset, run_length, [member ranges...])], sorted; members
    keep their original identity so fetch_ranges can slice each requested
    range back out of its run. Ranges merge when the gap between them is
    <= `gap` bytes AND the merged run stays <= `max_run` (overlapping or
    duplicate ranges always merge — reading the same bytes twice in one
    batch is pure waste)."""
    if not ranges:
        return []
    ordered = sorted(set((int(o), int(n)) for o, n in ranges if n > 0))
    if not ordered:
        return []
    runs: list[tuple[int, int, list]] = []
    run_off, run_len = ordered[0]
    members = [ordered[0]]
    for off, n in ordered[1:]:
        end = run_off + run_len
        new_end = max(end, off + n)
        # overlapping ranges ALWAYS merge (fetching shared bytes twice in
        # one batch is pure waste, whatever the run cap says)
        if off < end or (off - end <= gap and new_end - run_off <= max_run):
            run_len = new_end - run_off
            members.append((off, n))
        else:
            runs.append((run_off, run_len, members))
            run_off, run_len, members = off, n, [(off, n)]
    runs.append((run_off, run_len, members))
    _count("io_coalesce_ranges_total", len(ordered))
    _count("io_coalesce_runs_total", len(runs))
    return runs


def fetch_ranges(
    source,
    ranges,
    *,
    cache=None,
    gap: int = DEFAULT_COALESCE_GAP,
    max_run: int = DEFAULT_MAX_RUN,
) -> dict:
    """Fetch every (offset, length) range; returns {(offset, length): buf}.

    The read choke point: cache-satisfied ranges never touch the source;
    the rest coalesce (io.coalesce stage) into batched read_ranges calls
    (io.read stage, byte volume billed) and fill the cache. Buffers for
    members of one run are zero-copy memoryview slices of the run buffer;
    cached entries are bytes.

    `gap="auto"` resolves through the process IOTuner's profile for this
    source's transport (io/autotune.py) — 64 KiB until the transport has
    demonstrably remote latency, MiB-scale after. Every batched read here
    also FEEDS that tuner (latency + achieved bandwidth), whichever gap
    was used, so opting into "auto" anywhere benefits from observations
    made everywhere."""
    if gap == "auto":
        gap = io_tuner().gap_for(source.source_id)
    out: dict = {}
    missing = []
    sid = source.source_id if cache is not None else None
    for off, n in ranges:
        key = (int(off), int(n))
        if key in out:
            continue
        if cache is not None:
            hit = cache.get(sid, key[0], key[1])
            if hit is not None:
                out[key] = hit
                continue
        missing.append(key)
    if not missing:
        return out
    with stage("io.coalesce"):
        runs = coalesce(missing, gap=gap, max_run=max_run)
    run_spans = [(off, n) for off, n, _m in runs]
    total = sum(n for _o, n in run_spans)
    t0 = time.perf_counter()
    with stage("io.read", total):
        bufs = source.read_ranges(run_spans)
    # wall/runs is only an honest per-request latency when the runs were
    # SEQUENTIAL — remote sources fan read_ranges out concurrently and
    # feed the tuner per request themselves (HttpSource._observe), so
    # only local-profiled transports are observed from here
    if profile_key(source.source_id) == "local":
        io_tuner().observe(
            source.source_id, total, time.perf_counter() - t0, len(run_spans)
        )
    for (run_off, _run_len, members), buf in zip(runs, bufs):
        mv = memoryview(buf)
        for off, n in members:
            piece = mv[off - run_off : off - run_off + n]
            out[(off, n)] = piece
            if cache is not None:
                cache.put(sid, off, n, piece)
    return out


# -- the dedicated IO pool ----------------------------------------------------

# the pqt-io pool's worker count
IO_THREADS = min(os.cpu_count() or 1, 8)

_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def io_pool() -> ThreadPoolExecutor:
    """The process-wide readahead executor ("pqt-io", IO_THREADS
    workers). Deliberately its OWN pool: readahead tasks block
    on source latency, and parking them in the prepare or dataset pools
    would let slow IO starve decode (or deadlock a pool waiting on work it
    must itself run)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=IO_THREADS, thread_name_prefix="pqt-io"
            )
        return _pool


class Readahead:
    """Bounded readahead: fetch planned ranges into a BlockCache ahead of
    decode on the pqt-io pool, holding at most `budget_bytes` in flight.

    schedule() is fire-and-forget and advisory: when the budget is full the
    request is dropped (counted io_readahead_dropped_total) rather than
    queued — decode reads through fetch_ranges either way, so a dropped
    readahead costs latency, never correctness. Fetch failures are likewise
    swallowed (counted io_readahead_errors_total): the decode path will hit
    the same fault with its full typed-error context."""

    def __init__(self, cache, *, budget_bytes: int = 64 << 20,
                 gap: int = DEFAULT_COALESCE_GAP, autotune: bool = False):
        if cache is None:
            raise ValueError("Readahead needs a BlockCache to fetch into")
        self.cache = cache
        self.budget_bytes = int(budget_bytes)
        self.gap = gap
        # autotune=True consults the IOTuner per schedule(): the in-flight
        # budget GROWS to the transport's recommended readahead (deep for
        # high-latency stores, the configured budget otherwise), and
        # fetches coalesce at the tuned gap. The configured budget_bytes
        # stays the floor — autotune only ever deepens readahead.
        self.autotune = bool(autotune)
        if autotune and gap == DEFAULT_COALESCE_GAP:
            self.gap = "auto"
        self._lock = threading.Lock()
        self._inflight = 0
        self._futures: list = []
        self._closed = False

    def _budget_for(self, source_or_path) -> int:
        if not self.autotune:
            return self.budget_bytes
        key = (
            source_or_path
            if isinstance(source_or_path, (str, os.PathLike))
            else source_or_path.source_id
        )
        return max(
            self.budget_bytes, io_tuner().readahead_for(os.fspath(key))
        )

    def schedule(self, source_or_path, ranges) -> bool:
        """Queue a background fetch of `ranges` from a ByteSource or a local
        path (opened and closed inside the task). True when accepted."""
        total = sum(int(n) for _o, n in ranges)
        if total <= 0:
            return False
        budget = self._budget_for(source_or_path)
        with self._lock:
            if self._closed:
                return False
            if self._inflight + total > budget:
                _count("io_readahead_dropped_total")
                return False
            self._inflight += total
            self._futures = [f for f in self._futures if not f.done()]
            self._futures.append(
                instrumented_submit(io_pool(), self._fetch, source_or_path,
                                    list(ranges), total, pool="pqt-io")
            )
        return True

    def _fetch(self, source_or_path, ranges, total) -> None:
        from .source import open_source

        try:
            # paths open through open_source so readahead reads inherit the
            # same resilience policy (breaker/retry/hedge) decode does — a
            # blacked-out source must not keep burning pqt-io on fetches
            # decode would fast-fail
            if isinstance(source_or_path, (str, os.PathLike)):
                src, owned = open_source(os.fspath(source_or_path))
            else:
                src, owned = source_or_path, False
            try:
                fetch_ranges(src, ranges, cache=self.cache, gap=self.gap)
                _count("io_readahead_fetched_total")
            finally:
                if owned:
                    src.close()
        except Exception:  # noqa: BLE001 — advisory path, decode re-raises
            _count("io_readahead_errors_total")
        finally:
            with self._lock:
                self._inflight -= total

    def drain(self) -> None:
        """Block until every accepted fetch has finished (tests/benches)."""
        with self._lock:
            futs = list(self._futures)
        for f in futs:
            if not f.cancelled():
                f.exception()  # wait; errors were already counted in-task

    def close(self, wait: bool = False) -> None:
        """Stop accepting schedules and cancel not-yet-started fetches.
        Running fetches finish on their own (they hold no dataset state);
        wait=True blocks for them too."""
        with self._lock:
            self._closed = True
            futs = list(self._futures)
        for f in futs:
            f.cancel()
        if wait:
            self.drain()
