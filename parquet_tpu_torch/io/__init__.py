"""parquet_tpu_torch.io — pluggable byte sources, range planning, and caching.

The read side of parquet_tpu.io, copied: ByteSource implementations
(lock-free local pread, in-memory, HTTP(S) range-GET remote sources with
presigned-URL object-store variants, retrying/breaker/hedged wrappers),
SigV4-style request signing, a planner
that derives the exact byte ranges a projected read needs from the footer
and coalesces them into batched reads, a bounded pqt-io readahead
scheduler, byte-budgeted block + footer caches with a RAM -> local-disk
TieredCache for remote corpora, and a latency-aware auto-tuner that picks
coalesce/readahead knobs per transport, and the write side: HttpSink and
ObjectStoreSink, atomic multipart object-store writes. See each module's
docstring. Every count lands in io_counts() (io/counts.py).
"""

from .autotune import IOParams, IOTuner, io_tuner, profile_key  # noqa: F401
from .counts import io_counts, reset_io_counts  # noqa: F401
from .cache import BlockCache, FooterCache, shared_footer_cache  # noqa: F401
from .hedge import (  # noqa: F401
    BreakerRegistry,
    BreakerSource,
    CircuitBreaker,
    HedgedSource,
    ResilienceConfig,
    breaker_registry,
    configure_resilience,
    resilience_config,
    wrap_resilient,
)
from .planner import (  # noqa: F401
    DEFAULT_COALESCE_GAP,
    Readahead,
    coalesce,
    fetch_ranges,
    io_pool,
    plan_ranges,
)
from .remote import (  # noqa: F401
    HttpSource,
    ObjectStoreSource,
    TransientSourceError,
)
from .remote_sink import HttpSink, ObjectStoreSink  # noqa: F401
from .sign import (  # noqa: F401
    SigV4Signer,
    clear_signers,
    configure_signer,
    signer_for,
    verify_request,
)
from .source import (  # noqa: F401
    ByteSource,
    FileObjectSource,
    LocalFileSource,
    MemorySource,
    RetryingSource,
    SourceError,
    SourceFile,
    open_source,
)
from .tiercache import TieredCache  # noqa: F401

__all__ = [
    "ByteSource",
    "SourceError",
    "LocalFileSource",
    "MemorySource",
    "FileObjectSource",
    "RetryingSource",
    "SourceFile",
    "open_source",
    "BlockCache",
    "FooterCache",
    "shared_footer_cache",
    "plan_ranges",
    "coalesce",
    "fetch_ranges",
    "Readahead",
    "io_pool",
    "DEFAULT_COALESCE_GAP",
    "HedgedSource",
    "CircuitBreaker",
    "BreakerRegistry",
    "BreakerSource",
    "breaker_registry",
    "ResilienceConfig",
    "configure_resilience",
    "resilience_config",
    "wrap_resilient",
    "HttpSource",
    "ObjectStoreSource",
    "TransientSourceError",
    "HttpSink",
    "ObjectStoreSink",
    "SigV4Signer",
    "configure_signer",
    "signer_for",
    "clear_signers",
    "verify_request",
    "TieredCache",
    "IOParams",
    "IOTuner",
    "io_tuner",
    "profile_key",
    "io_counts",
    "reset_io_counts",
]
