"""parquet_tpu_torch.serve.mesh — the multi-host sharded serve layer.

Four modules over the single-daemon stack:

- ring.py    consistent hashing over plan units / shard keys, so repeated
             requests keep landing the same unit on the same replica (its
             footer/block caches stay warm) and adding or removing one
             replica only moves that replica's share of the keyspace.
- table.py   the router's replica table: static `--replica URL` list, one
             circuit breaker + latency window per replica, passive state
             (up/degraded/draining/down/open-breaker), counted in
             serve.counts.mesh_counts() and shown by GET /v1/debug/mesh.
- client.py  the resilient mesh client: breaker-gated attempts in ring
             preference order, Retry-After/brownout-aware retry, drain-
             aware failover, hedged duplicates past the observed p95.
- router.py  the HTTP front door: the same /v1/scan, /v1/query, /v1/plan,
             /metrics, /healthz surface as one daemon, scatter-gathering a
             request's plan units across the fleet and merging /v1/query
             partials unit by unit — responses are byte-identical to a
             single daemon serving the whole corpus (the differential
             tests pin it). The replicas run the query units on their
             devices; the router holds none.

The port of parquet_tpu.serve.mesh; each module's docstring says what
differs from the reference.
"""

from .client import MeshClient, MeshError
from .ring import HashRing
from .router import MeshConfig, MeshRouter, MeshService
from .table import Replica, ReplicaTable

__all__ = [
    "HashRing",
    "MeshClient",
    "MeshConfig",
    "MeshError",
    "MeshRouter",
    "MeshService",
    "Replica",
    "ReplicaTable",
]
