"""ParquetDataset: sharded, prefetching, checkpointable streaming batches.

The port of parquet_tpu/data/dataset.py: the layer a training or
bulk-inference loop consumes, over many files and hosts:

    ds = ParquetDataset("shard-*.parquet", columns=["x", "y"],
                        batch_size=4096, shuffle=True, seed=7, prefetch=2)
    for batch in ds:                      # {leaf path: torch.Tensor[4096]}
        step(batch)

In the order the pipeline applies them:

  plan      footers parse once a file generation (plan.build_plan, through
            the process-wide io.cache.shared_footer_cache); one work unit per
            (file, row group); `filters` prune units by statistics and
            bloom filters before any data page is read. `filter_rows=True`
            also masks single rows inside surviving groups with the host
            vec engine (null mode "row"), reading the filter columns too
            and dropping them before delivery unless projected.
  shard     each epoch's unit order is a pure function of (seed, epoch),
            striped over `shard_count * worker_count` slots: every unit is
            visited by exactly one (process, worker) per epoch.
  prefetch  a bounded pool of the dataset's own ("pqt-data" threads)
            decodes units k+1..k+depth on the host while the consumer works
            on k's batches; depth 0 is synchronous. With a block cache
            (`cache_bytes`, `cache_disk_bytes`: a RAM -> disk TieredCache in
            `cache_dir`, or a caller's `block_cache`), unit reads go through
            it and the "pqt-io" readahead (io.planner.Readahead, in-flight
            bytes bounded by `readahead_bytes`) fetches the next units'
            planned ranges into it while pqt-data decodes; `io_autotune`
            tunes the coalesce gap and readahead depth per transport. Paths
            may be http(s):// URLs.
  errors    `on_error="skip"` / `"null"` quarantine a unit whose footer,
            chunks or transport fail (the reader's policies; skipped units
            count in dataset_counts() as units_skipped).
  rebatch   decoded row groups re-slice into fixed `batch_size` batches,
            remainders carrying across unit boundaries; the epoch tail
            follows `remainder=` ("drop" | "keep" | "pad").
  deliver   the port's device rule: `device=None` means CUDA (and raises
            without it), and the batches go up through
            kernels.pipeline.device_put_pipelined(depth=2) on the dispatch
            thread, pinned and double-buffered, so batch k+1's upload
            overlaps the consumer's step on k; `device="cpu"` yields CPU
            tensors, the counterpart of the reference's host NumPy batches.
  resume    iter(ds) -> DatasetIterator with state_dict() /
            load_state_dict(): (epoch, unit cursor, row offset in the unit);
            a resumed iterator reproduces the rest of the stream byte for
            byte, mid-epoch, under sharding and shuffling.
  SLO       `slo_wait_ms` attaches an AIMD controller (data/controller.py;
            `controller=` passes a pre-built one) that moves the prefetch
            depth, the pqt-data worker count and the readahead budget to
            keep consumer waits under the SLO. It changes speed, never the
            stream: nothing state_dict() holds depends on it.

Cut, raising plan.NotPortedError (a ValueError) that names the layer: a
placement over several devices of one process (the reference's Sharding).
dataset_counts() reads the counters the reference keeps in utils.metrics;
the waits the controller steers on (dataset_wait_seconds and the pqt-data
pool's pool_queue_wait_seconds) are observed into
utils.instruments.INSTRUMENTS, the histograms it reads.
"""

from __future__ import annotations

import os
import threading
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.arrays import ByteArrayData
from ..core.reader import PARQUET_ERRORS, FileReader, resolve_device
from ..io.cache import BlockCache, shared_footer_cache
from ..io.planner import Readahead, plan_ranges
from ..io.tiercache import TieredCache
from ..kernels.pipeline import device_put_pipelined, to_device
from ..meta.file_meta import ParquetFileError
from ..utils.instruments import INSTRUMENTS
from .plan import ScanPlan, build_plan, not_ported

__all__ = ["ParquetDataset", "DatasetIterator", "dataset_counts", "reset_dataset_counts"]

_STATE_VERSION = 1

# The counters the reference keeps in utils.metrics (dataset_batches_total,
# dataset_rows_total, the dataset_wait_seconds histogram's count and sum,
# dataset_units_row_filtered, dataset_slo_violations_total: the waits an
# attached controller counted over its SLO) and its prefetch-depth gauge
# (the units in flight over every iterator). Process-wide: read with dataset_counts(),
# zero with reset_dataset_counts().
_COUNTS: Counter = Counter()
_COUNTS_LOCK = threading.Lock()


def _bump(name: str, n=1) -> None:
    with _COUNTS_LOCK:
        _COUNTS[name] += n


def dataset_counts() -> dict:
    """A snapshot of the dataset counters, with dataset_slo_violations_total
    (the consumer waits an attached SLO controller counted over its SLO)
    once there is one."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_dataset_counts() -> None:
    """Zero the counters. The prefetch-depth gauge stays: it counts units
    still in flight, which their iterators give back later."""
    with _COUNTS_LOCK:
        depth = _COUNTS.get("prefetch_depth", 0)
        _COUNTS.clear()
        if depth:
            _COUNTS["prefetch_depth"] = depth


def _observe_wait(seconds: float) -> None:
    with _COUNTS_LOCK:
        _COUNTS["wait_seconds_count"] += 1
        _COUNTS["wait_seconds_sum"] += seconds
    INSTRUMENTS.observe("dataset_wait_seconds", seconds)


def _inflight_add(n: int) -> None:
    """Move the prefetch-depth gauge (the units in flight over every
    iterator) by n."""
    _bump("prefetch_depth", n)


def _queued_task(t_submit: float, fn, args):
    """A pqt-data task: its submit-to-start wait goes into
    pool_queue_wait_seconds{pool="pqt-data"}, the controller's
    scale-workers signal."""
    INSTRUMENTS.observe(
        "pool_queue_wait_seconds", time.perf_counter() - t_submit, pool="pqt-data"
    )
    return fn(*args)


def _resolve_delivery(device) -> torch.device:
    """One device of this process (None means CUDA, and raises without it).
    A placement over several devices is the reference's Sharding."""
    if device is not None and not isinstance(device, (str, int, torch.device)):
        raise not_ported(
            f"a placement over several devices of one process ({type(device).__name__})",
            "the reference's Sharding; pass one device",
        )
    return resolve_device(device)


class ParquetDataset:
    """A multi-file Parquet scan shaped for training loops.

    Construction is cheap: footers parse on first use (iteration, or any
    plan-derived property). Iterating yields {leaf path tuple:
    torch.Tensor} batches of exactly `batch_size` rows (tail per
    `remainder=`) on `device`.
    """

    def __init__(
        self,
        paths_or_glob,
        *,
        batch_size: int,
        columns=None,
        filters=None,
        filter_rows: bool = False,
        shuffle: bool = False,
        seed: int = 0,
        num_epochs: int | None = 1,
        prefetch: int = 2,
        remainder: str = "drop",
        shard=None,
        worker=None,
        on_error: str = "raise",
        nullable: str = "error",
        validate_crc: bool = False,
        device=None,
        cache_bytes: int = 0,
        cache_disk_bytes: int = 0,
        cache_dir=None,
        block_cache=None,
        readahead_bytes: int | None = None,
        io_autotune: bool = False,
        slo_wait_ms: float | None = None,
        controller=None,
    ):
        if batch_size <= 0:
            raise ValueError("dataset: batch_size must be positive")
        if remainder not in ("drop", "keep", "pad"):
            raise ValueError(
                f'dataset: remainder must be "drop", "keep" or "pad", got {remainder!r}'
            )
        if on_error not in ("raise", "skip", "null"):
            raise ValueError(
                f'dataset: on_error must be "raise", "skip" or "null", got {on_error!r}'
            )
        if nullable not in ("error", "zero"):
            raise ValueError(f'dataset: nullable must be "error" or "zero", got {nullable!r}')
        if filter_rows and filters is None:
            raise ValueError("dataset: filter_rows=True requires filters")
        if num_epochs is not None and num_epochs < 0:
            raise ValueError("dataset: num_epochs must be >= 0 or None")
        if prefetch < 0:
            raise ValueError("dataset: prefetch depth must be >= 0")
        if cache_bytes < 0:
            raise ValueError("dataset: cache_bytes must be >= 0")
        if cache_disk_bytes < 0:
            raise ValueError("dataset: cache_disk_bytes must be >= 0")
        self.paths_or_glob = paths_or_glob
        self.batch_size = int(batch_size)
        self.columns = list(columns) if columns is not None else None
        self.filters = filters
        self.filter_rows = bool(filter_rows)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.num_epochs = num_epochs
        self.prefetch = int(prefetch)
        self.remainder = remainder
        self.on_error = on_error
        self.nullable = nullable
        self.validate_crc = bool(validate_crc)
        self.device = _resolve_delivery(device)
        si, sc = self._resolve_split(shard, "shard")
        wi, wc = self._resolve_split(worker, "worker")
        # one flat slot space, process-major and worker-minor: host p's
        # worker w owns stripe p*wc + w of sc*wc
        self.shard_index = si * wc + wi
        self.shard_count = sc * wc
        self._plan: ScanPlan | None = None
        self._plan_lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None
        self._closed = False
        # each plan file's parsed Schema: units open one reader a row group
        self._schemas: dict[int, object] = {}
        # the io layer: footers cache process-wide (validated by (size,
        # mtime) for paths and (size, ETag) for URLs); cache_bytes adds a
        # shared block cache the unit reads go through and the readahead
        # fills (its in-flight budget readahead_bytes, default cache_bytes
        # / 4), cache_disk_bytes grows it into a RAM -> disk TieredCache in
        # cache_dir (a private temp dir when None), and block_cache= passes
        # a caller's cache (BlockCache or TieredCache, caller-owned)
        self._footer_cache = shared_footer_cache()
        self.io_autotune = bool(io_autotune)
        self._owns_cache = block_cache is None
        if block_cache is not None:
            self._block_cache = block_cache
        elif cache_disk_bytes:
            self._block_cache = TieredCache(
                ram_bytes=cache_bytes or (64 << 20),
                disk_bytes=cache_disk_bytes,
                cache_dir=cache_dir,
            )
        elif cache_bytes:
            self._block_cache = BlockCache(cache_bytes)
        else:
            self._block_cache = None
        self._readahead = (
            Readahead(
                self._block_cache,
                budget_bytes=(
                    readahead_bytes
                    if readahead_bytes is not None
                    else max(cache_bytes // 4, 1 << 20)
                ),
                autotune=self.io_autotune,
            )
            if self._block_cache is not None
            else None
        )
        # the elastic SLO: slo_wait_ms attaches an AIMD controller that
        # scales the prefetch depth, the pqt-data workers and the readahead
        # budget to keep consumer waits under the SLO. Advisory only: it
        # never touches anything state_dict() depends on, so resume stays
        # byte-identical. A pre-built AIMDController (controller=) wins,
        # which lets tests inject clocks and stores.
        if controller is not None:
            self._controller = controller
        elif slo_wait_ms is not None:
            from .controller import AIMDController

            self._controller = AIMDController(
                slo_wait_ms=slo_wait_ms,
                initial_depth=max(1, self.prefetch),
                max_depth=max(32, self.prefetch),
            )
        else:
            self._controller = None

    @staticmethod
    def _resolve_split(spec, what: str) -> tuple[int, int]:
        if spec is None:
            return 0, 1
        if spec == "torch":
            if what != "shard":
                # worker="torch" would square the process stripe into a
                # diagonal: (P-1)/P of all units visited by nobody
                raise ValueError(
                    'dataset: only shard= accepts "torch"; worker= is the per-host '
                    "sub-split and needs an explicit (index, count)"
                )
            import torch.distributed as dist

            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    'dataset: shard="torch" needs an initialised default torch.distributed '
                    "process group (init_process_group)"
                )
            return dist.get_rank(), dist.get_world_size()
        i, n = spec
        i, n = int(i), int(n)
        if n <= 0 or not 0 <= i < n:
            raise ValueError(f"dataset: bad {what} split ({i}, {n})")
        return i, n

    # -- plan ------------------------------------------------------------------

    @property
    def plan(self) -> ScanPlan:
        """The global unit plan (footers parse on first access). The
        projection is checked once against the first readable schema,
        outside the skip policy: a misspelled columns= entry would otherwise
        quarantine every unit."""
        with self._plan_lock:
            if self._plan is None:
                plan = build_plan(
                    self.paths_or_glob,
                    filters=self.filters,
                    on_error=self.on_error,
                    footer_cache=self._footer_cache,
                )
                if self.columns is not None:
                    for fi, meta in enumerate(plan.metas):
                        if meta is not None:
                            with FileReader(
                                plan.files[fi], columns=self.columns, metadata=meta,
                                device="cpu",
                            ):
                                pass
                            break
                self._plan = plan
            return self._plan

    def _selected_leaf_paths(self, file_index: int):
        """The projection as leaf path tuples for one plan file (None = all
        columns): what the io planner needs for a unit's byte ranges. A
        resolution failure returns None (readahead fetches everything; the
        decode still raises the precise error)."""
        if self.columns is None:
            return None
        try:
            schema = self._file_schema(file_index)
        except Exception:  # noqa: BLE001 — advisory path only
            return None
        selected = set()
        for c in self.columns:
            path = tuple(c.split(".")) if isinstance(c, str) else tuple(c)
            selected.update(leaf.path for leaf in schema.leaves if leaf.path[: len(path)] == path)
        return selected or None

    def _unit_ranges(self, unit) -> list:
        """The planned (offset, length) byte ranges of one unit under the
        dataset's projection (readahead's shopping list)."""
        meta = self.plan.metas[unit.file_index]
        if meta is None:
            return []
        return plan_ranges(
            meta, row_groups=[unit.row_group], columns=self._selected_leaf_paths(unit.file_index)
        )

    def _file_schema(self, file_index: int):
        """The parsed Schema of one plan file, built once however many row
        groups stream from it (a race builds it twice, equal)."""
        s = self._schemas.get(file_index)
        if s is None:
            from ..core.schema import Schema

            s = Schema.from_thrift(self.plan.metas[file_index].schema)
            self._schemas[file_index] = s
        return s

    @property
    def total_rows(self) -> int:
        """Rows the footers promise across all shards."""
        return self.plan.total_rows

    def epoch_order(self, epoch: int) -> list[int]:
        """This shard's unit visit order for `epoch` (plan unit indices)."""
        return self.plan.epoch_order(
            epoch,
            seed=self.seed,
            shuffle=self.shuffle,
            shard_index=self.shard_index,
            shard_count=self.shard_count,
        )

    # -- prefetch pool ---------------------------------------------------------

    def _worker_pool(self) -> ThreadPoolExecutor:
        """The dataset's own bounded decode pool ("pqt-data", sized
        min(prefetch, PQT_DATA_THREADS or the cpu count), or the SLO
        controller's worker target). Kept apart from the reader's
        "pqt-host" prepare pool: unit tasks that fanned out into the pool
        they run in would deadlock once it saturates."""
        with self._plan_lock:
            if self._closed:
                raise RuntimeError("dataset: closed")
            if self._pool is None:
                env = os.environ.get("PQT_DATA_THREADS")
                cap = int(env) if env else (os.cpu_count() or 1)
                if self._controller is not None:
                    workers = self._controller.worker_target
                else:
                    workers = max(1, min(self.prefetch, cap))
                self._pool = ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="pqt-data"
                )
            return self._pool

    def _apply_controller_targets(self) -> None:
        """Push the SLO controller's current targets onto the pool and the
        readahead (called from the fetch loop after each control tick).
        Growth takes effect on the next submit (the executor spawns threads
        lazily up to _max_workers); a shrink is lazy: extra idle workers
        park, and concurrency is already bounded by the prefetch window."""
        ctl = self._controller
        if ctl is None:
            return
        pool = self._pool
        if pool is not None:
            w = ctl.worker_target
            # _max_workers is the executor's sizing knob in use; the
            # standard library has no public resize
            if w != pool._max_workers:
                pool._max_workers = w
        if self._readahead is not None:
            self._readahead.budget_bytes = ctl.readahead_budget

    def io_stats(self) -> "dict | None":
        """The block cache's stats() (a TieredCache's carry its "ram" and
        "disk" tiers), once every readahead fetch already accepted has
        finished, so that counts read after it are settled. None when the
        dataset reads through no cache."""
        if self._block_cache is None:
            return None
        if self._readahead is not None:
            self._readahead.drain()
        return self._block_cache.stats()

    def close(self) -> None:
        """Shut the prefetch pool down (idempotent). The dataset and its
        iterators stop being usable: further iteration raises. The readahead
        stops taking work and cancels queued fetches (running ones finish:
        they touch only the cache). A cache the dataset built is closed (a
        TieredCache's private spill directory goes); a block_cache= passed
        in stays the caller's."""
        with self._plan_lock:
            self._closed = True
            pool, self._pool = self._pool, None
        if self._readahead is not None:
            self._readahead.close()
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        if self._owns_cache and hasattr(self._block_cache, "close"):
            self._block_cache.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- iteration -------------------------------------------------------------

    def __iter__(self) -> "DatasetIterator":
        if self._closed:
            raise RuntimeError("dataset: closed")
        return DatasetIterator(self)

    def iterator(self, state: dict | None = None) -> "DatasetIterator":
        """A fresh iterator, optionally resumed from a state_dict()."""
        it = iter(self)
        if state is not None:
            it.load_state_dict(state)
        return it


class DatasetIterator:
    """One pass (or N epochs) over a ParquetDataset's shard of the plan.

    Checkpointable: state_dict() captures (epoch, unit cursor, row offset in
    the unit) as of the batches already delivered; load_state_dict() on a
    fresh iterator reproduces the rest of the stream byte for byte.
    """

    def __init__(self, dataset: ParquetDataset):
        self._ds = dataset
        self._epoch = 0
        self._pos = 0  # epoch-order position of the next row to deliver
        self._off = 0  # row offset within that unit
        self._exhausted = False
        self._started = False
        self._dtypes: dict | None = None  # cross-file schema consistency
        self._gen = None

    # -- checkpointing ---------------------------------------------------------

    def state_dict(self) -> dict:
        """Resume point covering every batch already delivered."""
        ds = self._ds
        return {
            "version": _STATE_VERSION,
            "epoch": self._epoch,
            "unit_pos": self._pos,
            "row_offset": self._off,
            "exhausted": self._exhausted,
            "seed": ds.seed,
            "shuffle": ds.shuffle,
            "batch_size": ds.batch_size,
            "remainder": ds.remainder,
            "shard": [ds.shard_index, ds.shard_count],
            "plan": ds.plan.fingerprint(),
        }

    def load_state_dict(self, state: dict) -> None:
        """Position this (not yet started) iterator at a checkpoint. What
        the cursor's meaning depends on must match: the permutation
        (seed, shuffle), the stripe (shard), the batch grid (batch_size,
        remainder) and the plan. Prefetch depth and device may differ."""
        if self._started:
            raise RuntimeError("dataset: load_state_dict on a started iterator (make a fresh one)")
        if state.get("version") != _STATE_VERSION:
            raise ValueError(f"dataset: unknown checkpoint version {state.get('version')!r}")
        ds = self._ds
        for key, ours in (
            ("seed", ds.seed),
            ("shuffle", ds.shuffle),
            ("batch_size", ds.batch_size),
            ("remainder", ds.remainder),
            ("shard", [ds.shard_index, ds.shard_count]),
            ("plan", ds.plan.fingerprint()),
        ):
            if state.get(key) != ours:
                raise ValueError(
                    f"dataset: checkpoint {key} mismatch ({state.get(key)!r} != {ours!r}); "
                    "the cursor would not mean the same stream"
                )
        self._epoch = int(state["epoch"])
        self._pos = int(state["unit_pos"])
        self._off = int(state["row_offset"])
        self._exhausted = bool(state.get("exhausted", False))

    # -- iteration -------------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        if self._gen is None:
            self._started = True
            self._gen = self._stream()
        try:
            batch, state = next(self._gen)
        except StopIteration:
            self._exhausted = True
            raise
        # commit only at delivery: uploads ahead of the consumer are in
        # flight, and a checkpoint must not cover them
        self._epoch, self._pos, self._off = state
        return batch

    def close(self) -> None:
        """Abandon the iterator: queued prefetch work is cancelled; running
        unit decodes finish and are dropped."""
        gen, self._gen = self._gen, None
        self._exhausted = True
        if gen is not None:
            gen.close()

    # -- internals -------------------------------------------------------------

    def _stream(self):
        """(batch, state after the batch) pairs on the dataset's device:
        device_put_pipelined on a CUDA device, CPU tensors on the CPU."""
        gen = self._batches()
        dev = self._ds.device
        if dev.type != "cuda":
            for b, s in gen:
                yield {p: to_device(a, dev) for p, a in b.items()}, s
            return
        states: deque = deque()

        def host_side():
            for b, s in gen:
                states.append(s)  # appended before the yield: stays aligned
                yield b

        for db in device_put_pipelined(host_side(), dev, depth=2):
            yield db, states.popleft()

    def _batches(self):
        ds = self._ds
        B = ds.batch_size
        epoch, pos, off = self._epoch, self._pos, self._off
        while ds.num_epochs is None or epoch < ds.num_epochs:
            order = ds.epoch_order(epoch)
            pending: deque = deque()  # [upos, base, cols, consumed, n]
            buffered = 0
            fetch = self._fetch_units(order, pos, off)
            try:
                for upos, base, cols, n in fetch:
                    self._check_template(cols)
                    pending.append([upos, base, cols, 0, n])
                    buffered += n
                    while buffered >= B:
                        batch, buffered, resume_pos, resume_off = self._emit(pending, buffered, B)
                        yield batch, (epoch, resume_pos, resume_off)
            finally:
                # closing mid-epoch releases the fetch pipeline's in-flight
                # accounting now, not at some later collection
                fetch.close()
            if buffered and ds.remainder != "drop":
                batch, _, _, _ = self._emit(pending, buffered, buffered)
                if ds.remainder == "pad" and buffered < B:
                    batch = {p: _pad_rows(a, B) for p, a in batch.items()}
                yield batch, (epoch + 1, 0, 0)
            epoch += 1
            pos = 0
            off = 0

    def _emit(self, pending: deque, buffered: int, take: int):
        """Assemble one `take`-row batch from the buffered spans; returns
        (batch, rows still buffered, cursor pos, cursor off)."""
        parts: dict[tuple, list] = {}
        need = take
        last_upos = -1
        while need:
            e = pending[0]
            upos, base, cols, consumed, n = e
            chunk = min(need, n - consumed)
            for p, a in cols.items():
                parts.setdefault(p, []).append(a[consumed : consumed + chunk])
            e[3] = consumed + chunk
            need -= chunk
            last_upos = upos
            if e[3] == n:
                pending.popleft()
        batch = {p: (ps[0] if len(ps) == 1 else np.concatenate(ps)) for p, ps in parts.items()}
        if pending:
            head = pending[0]
            cursor = (head[0], head[1] + head[3])
        else:
            cursor = (last_upos + 1, 0)
        _bump("batches")
        _bump("rows", take)
        return batch, buffered - take, cursor[0], cursor[1]

    def _check_template(self, cols: dict) -> None:
        """Every unit must deliver the same columns with the same dtype and
        trailing shape, or concatenation would upcast (or fail with no file
        context)."""
        tmpl = {p: (a.dtype, a.shape[1:]) for p, a in cols.items()}
        if self._dtypes is None:
            self._dtypes = tmpl
            return
        if tmpl != self._dtypes:
            raise ParquetFileError(
                f"dataset: unit schema mismatch: {tmpl} != {self._dtypes} "
                "(files in one dataset must agree on columns and types)"
            )

    # -- unit fetch (the bounded prefetch pipeline) ----------------------------

    def _fetch_units(self, order: list[int], start_pos: int, start_off: int):
        """Yield (order position, base row offset, column arrays, rows) for
        every unit from start_pos on that delivers rows, in order, decoding
        up to `prefetch` units ahead on the pqt-data pool."""
        ds = self._ds
        units = ds.plan.units
        ctl = ds._controller
        depth = ds.prefetch if ctl is None else ctl.prefetch_target
        if depth <= 0:
            for k in range(start_pos, len(order)):
                off = start_off if k == start_pos else 0
                # the synchronous path waits for the whole decode: record it
                t = time.perf_counter()
                cols, n = self._load_unit(units[order[k]], off)
                _observe_wait(time.perf_counter() - t)
                if cols is not None and n > 0:
                    yield k, off, cols, n
            return
        pool = ds._worker_pool()
        pending: deque = deque()
        nxt = start_pos
        ra_scheduled: set[int] = set()

        def readahead():
            # one io stage ahead of decode: while pqt-data decodes the
            # window, pqt-io fetches the NEXT units' planned byte ranges
            # into the block cache (advisory: an over-budget schedule is
            # dropped, and the decode reads through either way)
            if ds._readahead is None:
                return
            for j in range(nxt, min(nxt + max(depth, 1), len(order))):
                if j in ra_scheduled:
                    continue
                ra_scheduled.add(j)
                unit = units[order[j]]
                ranges = ds._unit_ranges(unit)
                if ranges:
                    ds._readahead.schedule(unit.path, ranges)

        def fill():
            nonlocal nxt, depth
            if ctl is not None:
                # re-read the target each refill: the controller moves it
                # between batches, and the window follows it at once
                depth = ctl.prefetch_target
            added = 0
            while nxt < len(order) and len(pending) < depth:
                off = start_off if nxt == start_pos else 0
                unit = (units[order[nxt]], off)
                fut = pool.submit(_queued_task, time.perf_counter(), self._load_unit, unit)
                pending.append((nxt, off, fut))
                nxt += 1
                added += 1
            if added:
                _inflight_add(added)
            readahead()

        fill()
        try:
            while pending:
                k, off, fut = pending.popleft()
                t = time.perf_counter()
                try:
                    cols, n = fut.result()
                finally:
                    _inflight_add(-1)  # a popped unit always leaves the gauge
                _observe_wait(time.perf_counter() - t)
                if ctl is not None:
                    seen = ctl.violations
                    if ctl.tick():
                        if ctl.violations > seen:
                            _bump("dataset_slo_violations_total", ctl.violations - seen)
                        ds._apply_controller_targets()
                fill()
                if cols is not None and n > 0:
                    yield k, off, cols, n
        finally:
            if pending:
                _inflight_add(-len(pending))
            for _k, _o, fut in pending:
                fut.cancel()

    def _load_unit(self, unit, row_offset: int):
        """Decode one (file, row group) on the host into batchable arrays,
        sliced from `row_offset` (a pqt-data worker's task). The reader
        touches no device: delivery uploads the batches. Returns (None, 0)
        for a unit the on_error policy dropped."""
        ds = self._ds
        try:
            reader = FileReader(
                unit.path,
                columns=ds.columns,
                metadata=ds.plan.metas[unit.file_index],
                schema=ds._file_schema(unit.file_index),
                validate_crc=ds.validate_crc,
                device="cpu",
                on_error=ds.on_error,
                block_cache=ds._block_cache,
                coalesce_gap="auto" if ds.io_autotune else None,
            )
        except PARQUET_ERRORS + (OSError,):
            if ds.on_error == "raise":
                raise
            _bump("units_skipped")
            return None, 0
        try:
            read_cols = None
            normalized = None
            if ds.filter_rows:
                # the read set covers the filter leaves; the projection
                # (reader._selected) prunes them back out below
                from ..core.filter import normalize_dnf

                normalized = normalize_dnf(reader.schema, ds.filters)
                read_cols = reader._columns_with_filters(ds.columns, normalized)
            chunks = reader._read_row_group(unit.row_group, read_cols, pack=False)
            if not chunks:
                # quarantined by on_error (or an empty selection)
                _bump("units_skipped")
                return None, 0
            mask = None
            if normalized is not None:
                # a VecFilterError is a deterministic shape decline (it would
                # quarantine every unit): it raises, whatever on_error says
                from ..core.filter_vec import dnf_mask

                nrows = int(reader.row_group(unit.row_group).num_rows or 0)
                mask = dnf_mask(chunks, normalized, nrows)
            keep = reader._selected
            cols = {
                p: self._batch_array(p, cd, reader.schema.column(p))
                for p, cd in chunks.items()
                if keep is None or p in keep
            }
        except OSError:
            # a transport failure mid-decode (a retry ladder exhausted, a
            # breaker fast-failing): under "skip" / "null" the unit is
            # quarantined like a corrupt one
            if ds.on_error == "raise":
                raise
            _bump("units_skipped")
            return None, 0
        finally:
            reader.close()
        if not cols:
            return None, 0
        lens = {a.shape[0] for a in cols.values()}
        if len(lens) != 1:
            raise ParquetFileError(
                f"dataset: columns disagree on row count in {unit.path} group "
                f"{unit.row_group}: {sorted(lens)}"
            )
        n = lens.pop()
        if mask is not None and not mask.all():
            # row filtering comes before the resume offset: row_offset counts
            # positions in the filtered stream
            _bump("units_row_filtered")
            cols = {p: a[mask] for p, a in cols.items()}
            n = int(mask.sum())
            if not n:
                return None, 0
        if row_offset:
            if row_offset >= n:
                return None, 0
            cols = {p: a[row_offset:] for p, a in cols.items()}
            n -= row_offset
        return cols, n

    def _batch_array(self, path, cd, leaf) -> np.ndarray:
        """One decoded chunk -> a row-aligned NumPy array (the host-side
        analogue of iter_device_batches' _array_of)."""
        name = ".".join(path)
        if cd.rep_levels is not None or leaf.max_rep > 0:
            raise ParquetFileError(
                f"dataset: column {name} is repeated; its leaf slots are not rows, so it "
                "cannot batch (project it out)"
            )
        values = cd.values
        if isinstance(values, ByteArrayData):
            raise ParquetFileError(
                f"dataset: column {name} is a raw byte array with no fixed-width batch form "
                "(project it out, or encode it as a fixed-size or integer feature upstream)"
            )
        arr = np.asarray(values)
        n = cd.num_values
        if arr.shape[0] != n:  # nulls: values are the dense non-null cells
            if self._ds.nullable != "zero":
                raise ParquetFileError(
                    f'dataset: column {name} contains nulls; pass nullable="zero" to '
                    "zero-fill them (or filter upstream)"
                )
            valid = np.asarray(cd.def_levels) == leaf.max_def
            out = np.zeros((n,) + arr.shape[1:], dtype=arr.dtype)
            out[valid] = arr
            arr = out
        return arr


def _pad_rows(a, target: int):
    """Zero-pad the leading axis to `target` rows (remainder="pad")."""
    if a.shape[0] >= target:
        return a
    pad = np.zeros((target - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad])
