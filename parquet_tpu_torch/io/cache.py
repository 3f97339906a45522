"""Byte-budgeted block cache + footer/metadata cache for the IO layer.

Two caches, two lifetimes:

  BlockCache    (source_id, offset, len) -> bytes, LRU under a byte budget.
                Holds COMPRESSED chunk/page-index ranges, so a re-read (a
                second epoch, a retried unit, two readers over one file)
                skips the source entirely. Keyed on the source's content
                identity (LocalFileSource folds size+mtime+inode in), so a
                rewritten file can never serve another generation's bytes.

  FooterCache   path -> parsed FileMetaData, validated against the file's
                (size, mtime_ns) on every hit. Parsing a footer is pure CPU
                (thrift walk) plus one tail read; a dataset re-planning a
                thousand-file glob every epoch — or open_many across jobs
                in one process — pays it once here.

Both count in io.counts: io_cache_hits_total / io_cache_misses_total /
io_cache_evictions_total for blocks, io_footer_cache_hits_total /
io_footer_cache_misses_total for footers (the port's copy of
parquet_tpu.io.cache; the io_cache_bytes gauge is stats()["bytes"]).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from .counts import count as _count

__all__ = ["BlockCache", "FooterCache", "shared_footer_cache"]


class BlockCache:
    """LRU byte-range cache under a byte budget (thread-safe)."""

    def __init__(self, capacity_bytes: int = 64 << 20):
        if capacity_bytes <= 0:
            raise ValueError("BlockCache capacity must be positive")
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        self._blocks: OrderedDict[tuple, bytes] = OrderedDict()
        self._bytes = 0

    def get(self, source_id: str, offset: int, length: int):
        """The cached bytes for one exact range, or None (counted)."""
        key = (source_id, offset, length)
        with self._lock:
            buf = self._blocks.get(key)
            if buf is not None:
                self._blocks.move_to_end(key)
                _count("io_cache_hits_total")
                return buf
        _count("io_cache_misses_total")
        return None

    def put(self, source_id: str, offset: int, length: int, data) -> None:
        data = bytes(data)
        if len(data) > self.capacity_bytes:
            return  # a block bigger than the whole budget would just thrash
        key = (source_id, offset, length)
        with self._lock:
            old = self._blocks.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._blocks[key] = data
            self._bytes += len(data)
            while self._bytes > self.capacity_bytes:
                _k, evicted = self._blocks.popitem(last=False)
                self._bytes -= len(evicted)
                _count("io_cache_evictions_total")

    def invalidate(self, source_id: str) -> None:
        """Drop every block of one source (a file known to be rewritten)."""
        with self._lock:
            for key in [k for k in self._blocks if k[0] == source_id]:
                self._bytes -= len(self._blocks.pop(key))

    def clear(self) -> None:
        with self._lock:
            self._blocks.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "blocks": len(self._blocks),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
            }


class FooterCache:
    """Parsed-footer cache validated by (size, mtime_ns) per hit.

    A hit returns the SAME FileMetaData object; footers are treated as
    immutable by every consumer (the reader only walks them). max_entries
    bounds the footprint LRU-style — footers are small (KBs) but a service
    scanning rolling datasets should not grow without bound."""

    def __init__(self, max_entries: int = 4096):
        if max_entries <= 0:
            raise ValueError("FooterCache max_entries must be positive")
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        # path -> ((st_size, st_mtime_ns), FileMetaData)
        self._entries: OrderedDict[str, tuple] = OrderedDict()

    @staticmethod
    def _sig(path: str):
        st = os.stat(path)
        return (st.st_size, st.st_mtime_ns)

    def get(self, path, sig=None):
        """The cached FileMetaData for `path` when the file on disk still
        matches the cached generation; None (counted as a miss) otherwise.
        A stat failure — vanished file — is a miss too: the caller's open
        will raise the real error with its real context.

        `sig` overrides the stat-derived signature for keys that are not
        stat-able paths: a URL-keyed footer validates against the remote
        source's generation() — (size, ETag) — instead of (size, mtime)."""
        path = os.fspath(path)
        if sig is None:
            try:
                sig = self._sig(path)
            except OSError:
                sig = None
        with self._lock:
            hit = self._entries.get(path)
            if hit is not None and sig is not None and hit[0] == sig:
                self._entries.move_to_end(path)
                _count("io_footer_cache_hits_total")
                return hit[1]
            if hit is not None:
                del self._entries[path]  # stale generation
        _count("io_footer_cache_misses_total")
        return None

    def put(self, path, meta, sig=None) -> None:
        path = os.fspath(path)
        if sig is None:
            try:
                sig = self._sig(path)
            except OSError:
                return  # can't pin a generation: don't cache
        with self._lock:
            self._entries[path] = (sig, meta)
            self._entries.move_to_end(path)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_shared_footer: FooterCache | None = None
_shared_lock = threading.Lock()


def shared_footer_cache() -> FooterCache:
    """The process-wide footer cache (what ScanPlan/ParquetDataset use by
    default, so footers parse once per file generation per process no
    matter how many plans, epochs or dataset objects touch them)."""
    global _shared_footer
    with _shared_lock:
        if _shared_footer is None:
            _shared_footer = FooterCache()
        return _shared_footer
