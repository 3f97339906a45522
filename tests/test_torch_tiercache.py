"""parquet_tpu_torch.io.tiercache against the JAX package's TieredCache.

One sequence of puts and gets, made from a seed with numpy, goes through
both packages' caches, each in a directory of its own under tmp_path:

  * spill: RAM evictions spill into CRC'd segment files, byte for byte
    the reference's segment files; the hits by tier, the promotions, the
    whole-segment disk evictions and stats() agree after every step;
  * readback: a disk hit reads through the sealed segment's mmap (or the
    active segment's pread) and promotes back to RAM;
  * restart and torn-tail replay: a cache reopened on a kept directory
    re-serves every intact record, and a segment torn mid-record (or with
    a rotten CRC) is cut at its last intact record, counted, and never
    served.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parquet_tpu.io.tiercache import TieredCache as JTiered  # noqa: E402
from parquet_tpu.utils import metrics as jmetrics  # noqa: E402

from parquet_tpu_torch.io import io_counts, reset_io_counts  # noqa: E402
from parquet_tpu_torch.io.tiercache import TieredCache  # noqa: E402


def _jax_counts(before: dict) -> dict:
    out = {}
    for k, v in jmetrics.snapshot().items():
        name = k.split("{", 1)[0]
        if name.endswith("_total") and name.startswith(("io_cache", "cache_tier_")):
            if isinstance(v, (int, float)) and v - before.get(k, 0):
                out[k] = v - before.get(k, 0)
    return out


def _port_counts() -> dict:
    return {
        k: v for k, v in io_counts().items()
        if v and k.split("{", 1)[0].startswith(("io_cache", "cache_tier_"))
    }


def _stats(cache) -> dict:
    s = cache.stats()
    s["disk"] = {k: v for k, v in s["disk"].items() if k != "dir"}
    return s


def _ops(seed: int, n: int = 160):
    """A seeded sequence of ("put", key, data) / ("get", key)."""
    rng = np.random.default_rng(seed)
    keys = [(f"file:/d/x{k % 3}.parquet:1:2:3", int(k * 4096), int(rng.integers(16, 9000)))
            for k in range(24)]
    ops = []
    for _ in range(n):
        k = keys[int(rng.integers(0, len(keys)))]
        if rng.random() < 0.55:
            data = rng.integers(0, 256, k[2], dtype=np.uint8).tobytes()
            ops.append(("put", k, data))
        else:
            ops.append(("get", k))
    # a block bigger than the RAM tier goes straight to disk
    big = ("mem:big", 0, 40_000)
    ops.append(("put", big, bytes(range(256)) * (40_000 // 256) + bytes(40_000 % 256)))
    ops.append(("get", big))
    return ops


def _drive(cache, ops) -> list:
    out = []
    for op in ops:
        if op[0] == "put":
            cache.put(*op[1], op[2])
        else:
            got = cache.get(*op[1])
            out.append(None if got is None else bytes(got))
        out.append(_stats(cache))
    return out


def _segments(d) -> dict:
    return {
        n: open(os.path.join(d, n), "rb").read()
        for n in sorted(os.listdir(d)) if n.startswith("seg-")
    }


KW = dict(ram_bytes=32 << 10, disk_bytes=96 << 10, segment_bytes=24 << 10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spill_and_readback(tmp_path, seed):
    ops = _ops(seed)
    before = jmetrics.snapshot()
    with JTiered(cache_dir=str(tmp_path / "jax"), **KW) as jc:
        want = _drive(jc, ops)
        want_segs = _segments(jc.cache_dir)
    jcounts = _jax_counts(before)
    reset_io_counts()
    with TieredCache(cache_dir=str(tmp_path / "port"), **KW) as pc:
        got = _drive(pc, ops)
        got_segs = _segments(pc.cache_dir)
    assert got == want
    assert got_segs == want_segs
    assert _port_counts() == jcounts
    # the sequence reached every tier path
    for key in ('cache_tier_hits_total{tier="disk"}', 'cache_tier_hits_total{tier="ram"}',
                "cache_tier_spills_total", "cache_tier_promotions_total",
                'cache_tier_evictions_total{tier="disk"}'):
        assert jcounts.get(key, 0) > 0, key


def test_invalidate_clear_and_private_dir(tmp_path):
    def run(cls):
        c = cls(**KW)
        d = c.cache_dir
        for k in range(12):
            c.put("s1" if k % 2 else "s2", k * 100, 5000, bytes([k]) * 5000)
        c.invalidate("s1")
        out = [_stats(c), c.get("s1", 100, 5000), c.get("s2", 0, 5000)]
        c.clear()
        out.append(_stats(c))
        c.put("s3", 0, 1, b"z")
        c.close()
        c.close()
        out.append(os.path.exists(d))
        c.put("s3", 1, 1, b"y")  # a closed cache takes nothing
        for bad in (dict(ram_bytes=0), dict(disk_bytes=0), dict(segment_bytes=0)):
            try:
                cls(**bad)
            except ValueError as e:
                out.append(str(e))
        return out

    assert run(TieredCache) == run(JTiered)


@pytest.mark.parametrize("cut", ["mid_payload", "mid_header", "bad_crc", "bad_magic"])
def test_restart_and_torn_tail_replay(tmp_path, cut):
    ops = _ops(7, n=90)

    def run(cls, d):
        with cls(cache_dir=str(d), **KW) as c:
            _drive(c, ops)
        segs = sorted(n for n in os.listdir(d) if n.startswith("seg-"))
        last = os.path.join(d, segs[-1])
        raw = bytearray(open(last, "rb").read())
        # tear the last record of the last segment
        if cut == "mid_payload":
            raw = raw[:-7]
        elif cut == "mid_header":
            raw += b"PQTC\x01"
        elif cut == "bad_crc":
            raw[-1] ^= 0xFF
        else:
            raw += b"XXXX" + bytes(10)
        open(last, "wb").write(bytes(raw))
        with cls(cache_dir=str(d), **KW) as c:
            restored = _stats(c)
            keys = sorted({op[1] for op in ops})
            return restored, [None if (v := c.get(*k)) is None else bytes(v) for k in keys]

    before = jmetrics.snapshot()
    want = run(JTiered, tmp_path / "jax")
    jcounts = _jax_counts(before)
    reset_io_counts()
    got = run(TieredCache, tmp_path / "port")
    assert got == want
    assert _port_counts() == jcounts
    assert jcounts.get("cache_tier_restored_blocks_total", 0) > 0
    if cut != "bad_magic":
        assert jcounts.get("cache_tier_torn_segments_total", 0) == 1


def test_blocks_carry_their_source_generation(tmp_path):
    """A key embeds the source's content generation: a block cached for one
    generation never serves another, across a restart too."""
    d = tmp_path / "gen"
    with TieredCache(cache_dir=str(d), **KW) as c:
        c.put("file:/x:1:10:100", 0, 4, b"old!")
        for k in range(40):
            c.put("pad", k * 10, 2000, bytes(2000))  # spill the old block
    with TieredCache(cache_dir=str(d), **KW) as c:
        assert c.get("file:/x:1:10:100", 0, 4) == b"old!"
        assert c.get("file:/x:1:10:200", 0, 4) is None
