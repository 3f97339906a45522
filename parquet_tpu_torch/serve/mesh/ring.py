"""Consistent hashing for the mesh router.

Why a ring and not `hash(key) % n`: the router's whole value is cache
affinity — unit k of a hot corpus should land on the SAME replica request
after request, so that replica's footer/block caches absorb it. Modulo
hashing reshuffles nearly every key when n changes by one; a ring with
virtual nodes moves only the leaving/joining replica's share (~1/n of the
keyspace) and leaves everything else pinned.

Hashing is blake2b over the key bytes — deterministic across processes
and interpreter runs (python's builtin hash() is salted per process, and
a router restart must not cold every replica cache).

`preference(key)` returns ALL nodes in ring order starting at the key's
point: the mesh client's failover order. It is deterministic per key, so
a retry after a replica death lands on the same fallback every time —
which is what makes "byte-identical merged results on retry" testable.

The port's copy of parquet_tpu.serve.mesh.ring: the same _point hash and
vnode layout, so one (nodes, vnodes, key) gives the reference's lookup and
preference.
"""

from __future__ import annotations

import bisect
import hashlib

__all__ = ["HashRing"]


def _point(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """An immutable consistent-hash ring over opaque node strings."""

    __slots__ = ("nodes", "_points", "_owners")

    def __init__(self, nodes, *, vnodes: int = 64):
        uniq = list(dict.fromkeys(nodes))
        if not uniq:
            raise ValueError("ring: at least one node required")
        if vnodes < 1:
            raise ValueError("ring: vnodes must be >= 1")
        self.nodes = tuple(uniq)
        marks = []
        for node in self.nodes:
            for v in range(vnodes):
                marks.append((_point(f"{node}#{v}"), node))
        # ties (astronomically unlikely at 64-bit points) break on the
        # node string so the ring is still a deterministic total order
        marks.sort()
        self._points = [m[0] for m in marks]
        self._owners = [m[1] for m in marks]

    def lookup(self, key: str) -> str:
        """The node owning `key`: the first vnode at or past its point,
        wrapping at the top of the ring."""
        i = bisect.bisect_left(self._points, _point(key))
        if i == len(self._points):
            i = 0
        return self._owners[i]

    def preference(self, key: str) -> list:
        """Every node exactly once, in ring order from `key`'s point —
        the deterministic failover sequence (owner first)."""
        start = bisect.bisect_left(self._points, _point(key))
        seen: dict = {}
        n = len(self._points)
        for off in range(n):
            node = self._owners[(start + off) % n]
            if node not in seen:
                seen[node] = None
                if len(seen) == len(self.nodes):
                    break
        return list(seen)
