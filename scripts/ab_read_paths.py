#!/usr/bin/env python3
"""Time the read paths of two checkouts of the port in alternating pairs.

    python3 scripts/ab_read_paths.py PARENT_ROOT [--pairs N] [--file PATH] [--out OUT.json]

PARENT_ROOT holds another checkout's `parquet_tpu_torch/` (for example one
unpacked with `git archive`); the other side is the checkout holding this
script. Each side runs in a process of its own, N pairs in the order
parent, tree, tree, parent, parent, tree, ... on the file: by default
chip_smoke.py's cached `taxi` (8 row groups of 2**20 rows), built if
missing. A process times `read_row_groups_device()` (median of 5),
`read_row_group_device` of each group (median of 5), the host decode of
every group (median of 3) and `iter_rows` of group 0 (median of 3), each
after one warm-up and ending in `torch.cuda.synchronize()` where it
touches the card. Each side loads the kernels and host library of its own
checkout: the parent's are built once, before the first timed process,
by the parent's own package into its own `build/`, as any run of that
checkout builds them; this script writes nothing there itself.
Needs CUDA. Prints each process's medians, then for each path the median
of each side's process medians, each side's spread (max / min of its
process medians) and tree / parent of the two medians, and writes the
processes' numbers to OUT.json when given."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATHS = ("device read", "device groups", "host decode", "rows group 0")


def worker(path: str) -> None:
    """One side's medians on `path`, printed as a JSON line."""
    import torch

    import parquet_tpu_torch
    from parquet_tpu_torch.core.reader import FileReader

    def med(fn, reps):
        fn()
        secs = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t)
        return {"median_s": statistics.median(secs), "secs": secs}

    def dev_read():
        FileReader(path).read_row_groups_device()
        torch.cuda.synchronize()

    def dev_groups():
        with FileReader(path) as r:
            for i in range(r.num_row_groups):
                r.read_row_group_device(i)
        torch.cuda.synchronize()

    def host_read():
        with FileReader(path, device="cpu") as r:
            for i in range(r.num_row_groups):
                r.read_row_group(i)

    def rows():
        with FileReader(path, device="cpu") as r:
            for _row in r.iter_rows(row_groups=[0]):
                pass

    out = {"package": parquet_tpu_torch.__file__}
    for label, fn, reps in zip(PATHS, (dev_read, dev_groups, host_read, rows), (5, 5, 3, 3)):
        out[label] = med(fn, reps)
    print(json.dumps(out))


def build() -> None:
    """Build (or load) this process's checkout's kernels and host library."""
    from parquet_tpu_torch.kernels import build as kbuild
    from parquet_tpu_torch.utils.native import get_native

    kbuild.load()
    get_native()


def run_side(root: Path, args: list) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(root))
    # this file runs as a script on either side: the parent's checkout need
    # not hold it
    return subprocess.run([sys.executable, __file__, *args], env=env, cwd=str(root),
                          capture_output=True, text=True, timeout=900)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["worker"]:
        worker(argv[1])
        return 0
    if argv[:1] == ["build"]:
        build()
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--file")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    parent = Path(a.parent).resolve()
    path = a.file
    if path is None:
        sys.path.insert(0, str(ROOT))
        import chip_smoke as cs

        path = str(cs.smoke_file(cs.taxi_columns(cs.SEED)))
    for root in (parent, ROOT):
        p = run_side(root, ["build"])
        if p.returncode:
            print(p.stdout[-2000:], p.stderr[-4000:])
            raise SystemExit(f"the build in {root} failed")
    res = []
    for i in range(a.pairs):
        for side in (("parent", "tree") if i % 2 == 0 else ("tree", "parent")):
            p = run_side(parent if side == "parent" else ROOT, ["worker", path])
            if p.returncode:
                print(p.stdout[-2000:], p.stderr[-4000:])
                raise SystemExit(f"the {side} side failed")
            doc = json.loads(p.stdout.strip().splitlines()[-1])
            doc["side"] = side
            res.append(doc)
            print(side, doc["package"], {k: doc[k]["median_s"] for k in PATHS}, flush=True)
    summary = {}
    for label in PATHS:
        side = {s: [d[label]["median_s"] for d in res if d["side"] == s]
                for s in ("parent", "tree")}
        med = {s: statistics.median(v) for s, v in side.items()}
        spread = {s: max(v) / min(v) for s, v in side.items()}
        summary[label] = {"median_s": med, "spread": spread,
                          "tree_over_parent": med["tree"] / med["parent"]}
        print(f"{label}: median parent {med['parent']} s, tree {med['tree']} s; "
              f"spread parent {spread['parent']}, tree {spread['tree']}; "
              f"tree/parent {med['tree'] / med['parent']}")
    if a.out:
        Path(a.out).write_text(json.dumps({"summary": summary, "runs": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
