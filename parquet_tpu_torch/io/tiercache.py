"""TieredCache: BlockCache grown into a RAM-LRU -> local-disk spill cache.

The "millions of users hammering the same hot shards" story needs more
cache than RAM: a 64 MiB BlockCache in front of a 200 GB remote corpus
thrashes, but a local NVMe holds tens of GBs of the compressed hot set at
~100x less latency than the store. TieredCache keeps the BlockCache
contract (get/put/invalidate/stats keyed (source_id, offset, len) — every
fetch_ranges call site works unchanged) and adds a disk tier underneath:

  RAM tier     the same byte-budgeted LRU as BlockCache. Eviction does
               not discard — it SPILLS the block to the disk tier.
  disk tier    append-only segment files under cache_dir + an in-memory
               offset index. Spills append to the active segment (rolled
               at segment_bytes); sealed segments are mmap'd for readback;
               a disk hit copies the block out and PROMOTES it back to
               RAM. The tier is byte-budgeted too: over budget, the
               OLDEST WHOLE SEGMENT is dropped (one unlink reclaims real
               bytes — per-block hole-punching in an append-only file
               reclaims nothing).

Crash safety: every record carries magic + lengths + a CRC over key and
payload. A restart against an existing cache_dir replays the segments and
re-serves every intact record; the first torn/corrupt record ABANDONS the
rest of its segment (counted cache_tier_torn_segments_total) — a torn
block is discarded, never served. The key rides in the record (source_id
embeds content generation — size/mtime/inode for files, ETag for HTTP),
so a rewritten source can never hit a stale restart-loaded block.

Sharing: one TieredCache instance is safe under concurrent readers and
writers (single lock; disk reads copy out under it), so co-resident
dataset workers can pool one spill directory. Its counts are
tier-labelled (cache_tier_* in io.counts); the io_cache_* block-cache
counts keep counting too, so a hit rate reads the same over either cache.

The port's copy of parquet_tpu.io.tiercache (gauges dropped: stats()
holds the bytes of each tier).
"""

from __future__ import annotations

import mmap
import os
import shutil
import struct
import tempfile
import threading
import zlib
from collections import OrderedDict

from .counts import count as _count

__all__ = ["TieredCache"]

_MAGIC = b"PQTC"
# record: magic(4) key_len(u16) data_len(u32) crc32(u32) key data
_HEADER = struct.Struct("<4sHII")


def _record_key(source_id: str, offset: int, length: int) -> bytes:
    return f"{source_id}\x00{offset}\x00{length}".encode()


def _parse_key(raw: bytes):
    sid, off, length = raw.decode().rsplit("\x00", 2)
    return (sid, int(off), int(length))


class _Segment:
    """One append-only spill file. Active: appended via fd, read via
    pread. Sealed: read-only through one shared mmap."""

    __slots__ = ("seg_id", "path", "fd", "mm", "size", "keys", "live_bytes")

    def __init__(self, seg_id: int, path: str, *, size: int = 0):
        self.seg_id = seg_id
        self.path = path
        self.fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        self.mm: mmap.mmap | None = None
        self.size = size  # valid (replayed or written) bytes
        self.keys: list[tuple] = []  # index keys living in this segment
        self.live_bytes = 0  # payload bytes still indexed (diagnostics)

    def append(self, blob: bytes) -> int:
        """Append one full record; returns its start offset."""
        off = self.size
        os.pwrite(self.fd, blob, off)
        self.size += len(blob)
        return off

    def seal(self) -> None:
        if self.mm is None and self.size > 0:
            # map exactly the VALID prefix: a torn tail replayed past it
            # is unreachable by construction
            self.mm = mmap.mmap(
                self.fd, self.size, prot=mmap.PROT_READ
            )

    def read(self, offset: int, length: int) -> bytes:
        if self.mm is not None:
            return bytes(self.mm[offset : offset + length])
        return os.pread(self.fd, length, offset)

    def close(self, *, unlink: bool) -> None:
        if self.mm is not None:
            self.mm.close()
            self.mm = None
        os.close(self.fd)
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class TieredCache:
    """RAM-LRU -> disk-spill block cache (see module docstring).

    ram_bytes      RAM tier budget (> 0)
    disk_bytes     disk tier budget (> 0; use BlockCache for RAM-only)
    cache_dir      spill directory. None = a private temp dir removed on
                   close(); a given path is created, REUSED across
                   restarts (intact records re-serve) and left in place.
    segment_bytes  roll the active segment past this many bytes
    """

    def __init__(
        self,
        ram_bytes: int = 64 << 20,
        disk_bytes: int = 256 << 20,
        cache_dir=None,
        *,
        segment_bytes: int = 32 << 20,
    ):
        if ram_bytes <= 0:
            raise ValueError("TieredCache: ram_bytes must be positive")
        if disk_bytes <= 0:
            raise ValueError("TieredCache: disk_bytes must be positive")
        if segment_bytes <= 0:
            raise ValueError("TieredCache: segment_bytes must be positive")
        self.ram_bytes = int(ram_bytes)
        self.disk_bytes = int(disk_bytes)
        self.segment_bytes = int(segment_bytes)
        self._owns_dir = cache_dir is None
        if cache_dir is None:
            self.cache_dir = tempfile.mkdtemp(prefix="pqt-tiercache-")
        else:
            self.cache_dir = os.fspath(cache_dir)
            os.makedirs(self.cache_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._ram: OrderedDict[tuple, bytes] = OrderedDict()
        self._ram_used = 0
        # disk index: key -> (segment, payload offset, payload length)
        self._disk: dict[tuple, tuple] = {}
        self._disk_used = 0  # file bytes on disk (records, not payloads)
        self._segments: OrderedDict[int, _Segment] = OrderedDict()
        self._active: _Segment | None = None
        self._next_seg = 0
        self._closed = False
        self._load_existing()

    # -- restart replay --------------------------------------------------------

    def _load_existing(self) -> None:
        names = sorted(
            n for n in os.listdir(self.cache_dir)
            if n.startswith("seg-") and n.endswith(".dat")
        )
        for name in names:
            path = os.path.join(self.cache_dir, name)
            try:
                seg_id = int(name[4:-4])
            except ValueError:
                continue
            self._next_seg = max(self._next_seg, seg_id + 1)
            seg = _Segment(seg_id, path)
            file_size = os.fstat(seg.fd).st_size
            restored = self._replay(seg, file_size)
            if seg.size < file_size:
                # a torn tail (crash mid-append): everything past the last
                # intact record is DISCARDED, never served
                _count("cache_tier_torn_segments_total")
            if restored == 0:
                seg.close(unlink=True)
                continue
            seg.seal()
            self._segments[seg_id] = seg
            self._disk_used += seg.size
            _count("cache_tier_restored_blocks_total", restored)
        self._enforce_disk_budget()

    def _replay(self, seg: _Segment, file_size: int) -> int:
        """Walk records from offset 0; index every intact one. Stops (and
        pins seg.size) at the first corrupt/short record."""
        pos = 0
        restored = 0
        while pos + _HEADER.size <= file_size:
            hdr = os.pread(seg.fd, _HEADER.size, pos)
            if len(hdr) < _HEADER.size:
                break
            magic, key_len, data_len, crc = _HEADER.unpack(hdr)
            if magic != _MAGIC:
                break
            body_end = pos + _HEADER.size + key_len + data_len
            if body_end > file_size:
                break  # torn mid-payload
            body = os.pread(seg.fd, key_len + data_len, pos + _HEADER.size)
            if len(body) < key_len + data_len or zlib.crc32(body) != crc:
                break
            try:
                key = _parse_key(body[:key_len])
            except (ValueError, UnicodeDecodeError):
                break
            if key not in self._disk:  # first writer wins within a replay
                self._disk[key] = (seg, pos + _HEADER.size + key_len, data_len)
                seg.keys.append(key)
                seg.live_bytes += data_len
                restored += 1
            pos = body_end
        seg.size = pos
        return restored

    # -- the BlockCache contract -----------------------------------------------

    def get(self, source_id: str, offset: int, length: int):
        key = (source_id, int(offset), int(length))
        with self._lock:
            buf = self._ram.get(key)
            if buf is not None:
                self._ram.move_to_end(key)
                self._count_hit("ram")
                return buf
            loc = self._disk.get(key)
            if loc is not None:
                seg, data_off, data_len = loc
                buf = seg.read(data_off, data_len)
                self._count_hit("disk")
                _count("cache_tier_promotions_total")
                # promote: the block is hot again — next hit is a RAM hit.
                # It stays indexed on disk too, so re-evicting it later
                # never re-spills the same bytes.
                self._ram_put(key, buf, spill_on_evict=True)
                return buf
        _count("cache_tier_misses_total")
        _count("io_cache_misses_total")
        return None

    def put(self, source_id: str, offset: int, length: int, data) -> None:
        data = bytes(data)
        key = (source_id, int(offset), int(length))
        with self._lock:
            if self._closed:
                return
            if len(data) > self.ram_bytes:
                # too big for the whole RAM tier: straight to disk (a
                # block past the DISK budget too is simply not cacheable)
                if len(data) <= self.disk_bytes and key not in self._disk:
                    self._spill(key, data)
                    self._enforce_disk_budget()
                return
            self._ram_put(key, data, spill_on_evict=True)

    def _count_hit(self, tier: str) -> None:
        _count("cache_tier_hits_total", tier=tier)
        _count("io_cache_hits_total")

    def _ram_put(self, key, data: bytes, *, spill_on_evict: bool) -> None:
        # lock held
        old = self._ram.pop(key, None)
        if old is not None:
            self._ram_used -= len(old)
        self._ram[key] = data
        self._ram_used += len(data)
        while self._ram_used > self.ram_bytes:
            k, evicted = self._ram.popitem(last=False)
            self._ram_used -= len(evicted)
            _count("cache_tier_evictions_total", tier="ram")
            if spill_on_evict and k not in self._disk:
                self._spill(k, evicted)
        self._enforce_disk_budget()

    # -- disk tier -------------------------------------------------------------

    def _spill(self, key, data: bytes) -> None:
        # lock held
        key_raw = _record_key(*key)
        blob = (
            _HEADER.pack(
                _MAGIC, len(key_raw), len(data), zlib.crc32(key_raw + data)
            )
            + key_raw
            + data
        )
        if len(blob) > self.disk_bytes:
            return
        seg = self._active
        if seg is not None and seg.size + len(blob) > self.segment_bytes:
            seg.seal()
            self._active = seg = None
        if seg is None:
            seg_id = self._next_seg
            self._next_seg += 1
            seg = _Segment(
                seg_id, os.path.join(self.cache_dir, f"seg-{seg_id:08d}.dat")
            )
            self._segments[seg_id] = seg
            self._active = seg
        off = seg.append(blob)
        self._disk_used += len(blob)
        self._disk[key] = (seg, off + _HEADER.size + len(key_raw), len(data))
        seg.keys.append(key)
        seg.live_bytes += len(data)
        _count("cache_tier_spills_total")
        _count("cache_tier_spill_bytes_total", len(data))

    def _enforce_disk_budget(self) -> None:
        # lock held; oldest-first whole-segment eviction
        while self._disk_used > self.disk_bytes and self._segments:
            seg_id, seg = next(iter(self._segments.items()))
            if seg is self._active:
                self._active = None
            del self._segments[seg_id]
            self._disk_used -= seg.size
            dropped = 0
            for key in seg.keys:
                loc = self._disk.get(key)
                if loc is not None and loc[0] is seg:
                    del self._disk[key]
                    dropped += 1
            if dropped:
                _count(
                    "cache_tier_evictions_total", dropped, tier="disk"
                )
            seg.close(unlink=True)

    # -- management ------------------------------------------------------------

    def invalidate(self, source_id: str) -> None:
        """Drop every block of one source from BOTH tiers (the disk bytes
        stay dead in their segments until segment eviction reclaims them)."""
        with self._lock:
            for key in [k for k in self._ram if k[0] == source_id]:
                self._ram_used -= len(self._ram.pop(key))
            for key in [k for k in self._disk if k[0] == source_id]:
                seg, _off, data_len = self._disk.pop(key)
                seg.live_bytes -= data_len

    def clear(self) -> None:
        with self._lock:
            self._ram.clear()
            self._ram_used = 0
            self._disk.clear()
            self._drop_segments()

    def _drop_segments(self) -> None:
        # lock held
        for seg in self._segments.values():
            seg.close(unlink=True)
        self._segments.clear()
        self._active = None
        self._disk_used = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                # BlockCache-shaped top level (existing surfaces read these)
                "blocks": len(self._ram) + len(self._disk),
                "bytes": self._ram_used + self._disk_used,
                "capacity_bytes": self.ram_bytes + self.disk_bytes,
                "ram": {
                    "blocks": len(self._ram),
                    "bytes": self._ram_used,
                    "capacity_bytes": self.ram_bytes,
                },
                "disk": {
                    "blocks": len(self._disk),
                    "bytes": self._disk_used,
                    "capacity_bytes": self.disk_bytes,
                    "segments": len(self._segments),
                    "dir": self.cache_dir,
                },
            }

    def close(self) -> None:
        """Release fds/mmaps. A PRIVATE temp dir is deleted; a caller-
        provided cache_dir keeps its segments for the next process (the
        restart-replay path re-serves them)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for seg in self._segments.values():
                seg.close(unlink=self._owns_dir)
            self._segments.clear()
            self._active = None
            self._ram.clear()
            self._ram_used = 0
            self._disk.clear()
            self._disk_used = 0
        if self._owns_dir:
            shutil.rmtree(self.cache_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
