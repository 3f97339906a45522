"""Per-request planning against the daemon's process-shared caches.

A ScanSession is the state every request of one daemon plans against: the
shared FooterCache (a warm repeat plan parses zero footers and performs
ZERO source reads), the shared BlockCache (data/page-index/bloom ranges
survive across requests, so a warm repeat SCAN can serve entirely from
memory), an optional root directory every requested path is confined to,
and an optional daemon-level shard assignment so N daemons split one
logical corpus via the existing `shard=(i, n)` striping.

plan() is pure metadata work: expand paths, build the unit list through
data/plan.build_plan (projection/predicate push-down — statistics and
bloom pruning happen HERE, so excluded row groups never reach the
executor), stripe the units for the effective shard, and estimate the
byte volume the scan will touch (the admission layer charges tenant
budgets with this number before a single data byte is read).

A plan is a serve.plan span of the request's trace, and each path mapped
to a remote URL a remote.mapped count of it; a breaker shed counts serve_shed_total{reason=
"breaker_open"} in serve.counts.serve_counts()."""

from __future__ import annotations

import os
from typing import NamedTuple

from ..core.reader import PARQUET_ERRORS, resolve_column_prefixes
from ..core.schema import Schema
from ..data.plan import ScanPlan, build_plan, expand_paths
from ..io.cache import BlockCache, FooterCache
from ..io.source import SourceError
from ..utils.trace import count as _trace_count
from ..utils.trace import span
from . import counts as _counts
from .protocol import ScanRequest, ServeError

__all__ = ["ScanSession", "PlannedScan"]


class PlannedScan(NamedTuple):
    """A request bound to its pruned, sharded unit list."""

    request: ScanRequest
    plan: ScanPlan  # the global (pre-shard) plan, pruning summary attached
    units: list  # this daemon's/request's units, plan order striped by shard
    shard: tuple | None  # the effective (index, count), None = whole corpus
    estimated_bytes: int  # compressed bytes of the selected columns, sharded
    rows_planned: int  # footer-promised rows across the sharded units

    def summary(self) -> dict:
        """The /v1/plan (and `scan --json`) pruning/dry-run report."""
        return {
            "files": len(self.plan.files),
            "units_total": self.plan.units_total,
            "units_pruned_stats": self.plan.units_pruned_stats,
            "units_pruned_bloom": self.plan.units_pruned_bloom,
            "units_admitted": self.plan.num_units,
            "units": len(self.units),
            "rows": self.rows_planned,
            "estimated_bytes": self.estimated_bytes,
            "shard": list(self.shard) if self.shard else None,
        }


def _selected_bytes(meta, group_index: int, columns) -> int:
    """Compressed bytes of the projected chunks of one row group. The
    projection matches the reader's prefix convention ('a' selects every
    leaf under 'a') without needing the parsed schema tree."""
    rg = (meta.row_groups or [])[group_index]
    prefixes = (
        None
        if columns is None
        else [tuple(c.split(".")) for c in columns]
    )
    total = 0
    for cc in rg.columns or []:
        md = cc.meta_data
        if md is None:
            continue
        path = tuple(md.path_in_schema or [])
        if prefixes is not None and not any(
            path[: len(p)] == p for p in prefixes
        ):
            continue
        total += md.total_compressed_size or 0
    return total


class ScanSession:
    """Process-shared planning state for one daemon (thread-safe: the
    caches lock internally, everything else is immutable after init)."""

    def __init__(
        self,
        *,
        root=None,
        footer_cache: FooterCache | None = None,
        block_cache: BlockCache | None = None,
        source_factory=None,
        shard: tuple | None = None,
        coalesce_gap=None,
        remote_map: dict | None = None,
    ):
        self.root = os.path.realpath(os.fspath(root)) if root is not None else None
        # {path prefix -> object-store base URL}: requested paths under a
        # mapped prefix resolve to URLs (longest prefix wins) and flow
        # through the ordinary URL read path — shared TieredCache, footer
        # cache, resilience policy — while everything else stays
        # root-confined exactly as before
        self.remote_map = {
            prefix.strip("/"): url.rstrip("/")
            for prefix, url in (remote_map or {}).items()
        }
        self.footer_cache = footer_cache if footer_cache is not None else FooterCache()
        self.block_cache = block_cache
        # source_factory(path) -> ByteSource: the chaos/remote seam — when
        # set, the EXECUTOR opens data reads through it (planning stays on
        # local footer reads, which the footer cache already absorbs)
        self.source_factory = source_factory
        self.shard = shard
        # what executor readers coalesce with: None (the 64 KiB default),
        # an explicit gap, or "auto" (per-transport profile — the
        # ServeConfig.io_autotune wire)
        self.coalesce_gap = coalesce_gap

    # -- path confinement ------------------------------------------------------

    def _map_remote(self, p: str):
        """Resolve `p` to an object-store URL when it sits under a mapped
        prefix (longest prefix wins), else None. The path is normpath-
        collapsed FIRST, so `remote/../../etc` cannot ride a mapping out
        of its prefix — a collapsed path that no longer starts with the
        prefix simply falls through to local handling (and its 403)."""
        if not self.remote_map or os.path.isabs(p):
            return None
        norm = os.path.normpath(p).replace(os.sep, "/")
        for prefix in sorted(self.remote_map, key=len, reverse=True):
            if norm == prefix or norm.startswith(prefix + "/"):
                rest = norm[len(prefix):].lstrip("/")
                base = self.remote_map[prefix]
                return f"{base}/{rest}" if rest else base
        return None

    def resolve_paths(self, paths: list) -> list:
        """Expand the request's paths/globs into a concrete file list,
        confined to the session root when one is set. Paths under a
        remote_map prefix resolve to object-store URLs instead; relative
        paths are rooted at the session root; anything resolving outside
        it (.. tricks, absolute paths, symlink escapes) is refused with a
        typed 403."""
        specs = []
        for p in paths:
            mapped = self._map_remote(p)
            if mapped is not None:
                # per-request attribution: the trace shows how many paths
                # went remote (their GETs then carry the request's
                # traceparent: the sources read under the request scope)
                _trace_count("remote.mapped")
                specs.append(mapped)
                continue
            if self.root is not None and not os.path.isabs(p):
                p = os.path.join(self.root, p)
            if self.root is not None:
                # refuse escapes BEFORE touching the filesystem: a 404 for
                # root/../../etc/… would leak what exists outside the root
                norm = os.path.normpath(p)
                if not (
                    norm == self.root or norm.startswith(self.root + os.sep)
                ):
                    raise ServeError(
                        403, "path_outside_root",
                        f"path {p!r} resolves outside the serving root",
                    )
            specs.append(p)
        try:
            files: list = []
            for spec in specs:
                files.extend(expand_paths(spec))
        except FileNotFoundError as e:
            raise ServeError(404, "not_found", str(e)) from None
        files = sorted(set(files))
        if self.root is not None:
            for f in files:
                if f.startswith(("http://", "https://")):
                    continue  # mapped object-store URLs are not root paths
                real = os.path.realpath(f)
                if not (real == self.root or real.startswith(self.root + os.sep)):
                    raise ServeError(
                        403, "path_outside_root",
                        f"path {f!r} resolves outside the serving root",
                    )
        return files

    # -- planning --------------------------------------------------------------

    def plan(self, request: ScanRequest) -> PlannedScan:
        """Plan one request: prune, stripe, estimate. Zero source reads
        when the footer cache is warm (and bloom/page-index consultation
        hits the block cache)."""
        with span("serve.plan", {"paths": ",".join(request.paths)}):
            return self._plan(request)

    def _plan(self, request: ScanRequest) -> PlannedScan:
        files = self.resolve_paths(request.paths)
        try:
            plan = build_plan(
                files,
                filters=request.filters,
                footer_cache=self.footer_cache,
                block_cache=self.block_cache,
            )
        except ServeError:
            raise
        except PARQUET_ERRORS as e:
            raise ServeError(
                422, "unreadable_file", f"{type(e).__name__}: {e}"
            ) from None
        except SourceError as e:
            # a breaker fast-fail during (cold) footer reads: the file
            # is not wrong, the transport is dark — 503 + Retry-After,
            # and the plan failed in microseconds instead of spinning
            # a retry ladder per footer
            code = getattr(e, "code", None)
            if code == "breaker_open":
                _counts.count("serve_shed_total", reason="breaker_open")
                raise ServeError(
                    503, "source_unavailable",
                    f"source circuit breaker open: {e}",
                    retry_after_s=1,
                ) from None
            if code == "retry_exhausted":
                raise ServeError(
                    503, "source_error", f"{type(e).__name__}: {e}",
                    retry_after_s=1,
                ) from None
            raise ServeError(
                422, "unreadable_file", f"{type(e).__name__}: {e}"
            ) from None
        except (ValueError, OSError) as e:
            # FilterError (unknown column, bad value coercion) and
            # vanished-file races land here: the request is wrong or
            # stale, the daemon is fine
            raise ServeError(400, "bad_request", str(e)) from None
        # Validate the projection ONCE against the first readable
        # schema (pure metadata — no file handle, so a file vanishing
        # after build_plan can't surface an untyped OSError here): a
        # misspelled column must fail the REQUEST with a 400, not each
        # unit task with a 422.
        if request.columns is not None:
            for meta in plan.metas:
                if meta is None:
                    continue
                try:
                    resolve_column_prefixes(
                        Schema.from_thrift(meta.schema), request.columns
                    )
                except ValueError as e:
                    # ParquetFileError (unknown column) and SchemaError
                    # are both ValueErrors
                    raise ServeError(400, "bad_columns", str(e)) from None
                break
        shard = request.shard or self.shard
        if shard is not None:
            order = plan.epoch_order(
                0, shard_index=shard[0], shard_count=shard[1]
            )
            units = [plan.units[k] for k in order]
        else:
            units = list(plan.units)
        est = sum(
            _selected_bytes(
                plan.metas[u.file_index], u.row_group, request.columns
            )
            for u in units
            if plan.metas[u.file_index] is not None
        )
        return PlannedScan(
            request=request,
            plan=plan,
            units=units,
            shard=shard,
            estimated_bytes=est,
            rows_planned=sum(u.num_rows for u in units),
        )

    # -- the executor's reader seam -------------------------------------------

    def open_source(self, path: str):
        """The byte source the executor reads `path` through: the chaos/
        remote factory when configured, else the path itself (FileReader
        opens a lock-free local pread source)."""
        if self.source_factory is not None:
            return self.source_factory(path)
        return path
