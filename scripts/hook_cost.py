#!/usr/bin/env python3
"""Split the always-on observability hooks' cost on the device read of
`taxi`, in one process, by switching hooks off in turn.

    python3 scripts/hook_cost.py [--rounds N]

Variants, run round-robin N times (default 15) after two warm-ups each:
"as is"; "no pool hooks" (the read's pqt-host and pqt-dispatch hops
submit through a plain context-carrying submit instead of
obs.pool.instrumented_submit: no pool gauges or histograms); "no registry
writes" (MetricsRegistry.inc / set / observe do nothing); "neither".
Each read is `read_row_groups_device()` of chip_smoke.py's cached `taxi`
(built if missing) ending in `torch.cuda.synchronize()`. Prints each
variant's median and minimum seconds, then the single-thread cost of a
registry inc, set and observe and of a submit-and-run through a
one-thread pool, plain and instrumented. The switches are for measuring
only: the process's registry is left as it was found. Needs CUDA."""

from __future__ import annotations

import argparse
import statistics
import sys
import time
import timeit
from concurrent.futures import ThreadPoolExecutor
from contextvars import copy_context
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("as is", "no pool hooks", "no registry writes", "neither")


def plain_submit(ex, fn, *args, pool=None, ctx=None, credit_wait=True):
    """The context carry alone, as a plain traced submit does it."""
    return ex.submit(copy_context().run, fn, *args)


def noop(*args, **kwargs) -> None:
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=15)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    import parquet_tpu_torch.core.reader as reader
    import parquet_tpu_torch.kernels.pipeline as pipeline
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.utils import metrics

    path = str(cs.smoke_file(cs.taxi_columns(cs.SEED)))
    reg = metrics.REGISTRY
    orig = {"pipeline": pipeline.instrumented_submit, "reader": reader.instrumented_submit,
            "inc": reg.inc, "set": reg.set, "observe": reg.observe}

    def apply(v):
        pool_off = v in ("no pool hooks", "neither")
        reg_off = v in ("no registry writes", "neither")
        pipeline.instrumented_submit = plain_submit if pool_off else orig["pipeline"]
        reader.instrumented_submit = plain_submit if pool_off else orig["reader"]
        for m in ("inc", "set", "observe"):
            setattr(reg, m, noop if reg_off else orig[m])

    def read():
        FileReader(path).read_row_groups_device()
        torch.cuda.synchronize()

    try:
        for v in VARIANTS:
            apply(v)
            read()
            read()
        secs = {v: [] for v in VARIANTS}
        for _ in range(a.rounds):
            for v in VARIANTS:
                apply(v)
                t = time.perf_counter()
                read()
                secs[v].append(time.perf_counter() - t)
    finally:
        apply("as is")
    for v in VARIANTS:
        print(f"{v}: median {statistics.median(secs[v])} s, min {min(secs[v])} s")
    n = 20000
    for label, fn in (("inc", lambda: reg.inc("bytes_compressed_total", 5)),
                      ("set", lambda: reg.set("pool_queue_depth", 3, pool="p")),
                      ("observe", lambda: reg.observe("pool_task_seconds", 0.001, pool="p"))):
        print(f"registry {label}: {timeit.timeit(fn, number=n) / n * 1e6} us")
    ex = ThreadPoolExecutor(1)
    for label, sub in (("plain", lambda: plain_submit(ex, noop)),
                       ("instrumented", lambda: orig["pipeline"](ex, noop, pool="p",
                                                                 credit_wait=False))):
        t = time.perf_counter()
        futs = [sub() for _ in range(n)]
        for f in futs:
            f.result()
        print(f"{label} submit and run: {(time.perf_counter() - t) / n * 1e6} us")
    ex.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
