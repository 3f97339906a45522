"""The analytics stack on one file: page index + bloom filters + selective
page decode + device-batch filter pushdown, on the card.

The PyTorch port's counterpart of examples/analytics_pruning.py. Writes a
2M-row file (8 row groups, SNAPPY, page index, a bloom filter on
trip_id, sorted by ts, no dictionary) into the working directory, then
shows each layer at work:
  1. bloom filters prove an absent ID is in NO row group (min/max can't);
  2. the page index narrows a range predicate to row ranges;
  3. a filtered scan decodes ONLY the admitted pages (selective page decode);
  4. iter_device_batches(filters=...) skips excluded groups before any
     upload to the card.

    python examples_torch/analytics_pruning.py          # needs CUDA
    python examples_torch/analytics_pruning.py --cpu    # the kernels' plain versions

Without --cpu it needs CUDA, and exits 1 without it.
"""

import argparse
import datetime as dt
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import parquet_tpu_torch as ptq

PATH = "example_analytics.parquet"
N = 2_000_000
GROUP = N // 8


def write(path: str) -> None:
    rng = np.random.default_rng(0)
    schema = ptq.parse_schema(
        "message trips { required int64 trip_id; required int64 ts "
        "(TIMESTAMP_MICROS); required double fare; }"
    )
    with ptq.FileWriter(
        path,
        schema,
        codec="snappy",
        write_page_index=True,
        bloom_filters=["trip_id"],
        sorting_columns=["ts"],
        use_dictionary=False,
    ) as w:
        for base in range(0, N, GROUP):  # 8 row groups (columnar flush per group)
            w.write_column("trip_id", rng.integers(0, 1 << 40, GROUP))
            w.write_column(
                "ts",
                1_700_000_000_000_000 + np.arange(base, base + GROUP, dtype=np.int64),
            )
            w.write_column("fare", rng.uniform(2, 80, GROUP))
            w.flush_row_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("analytics_pruning: CUDA is not available; pass --cpu", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cpu" if args.cpu else "cuda")

    write(PATH)
    with ptq.FileReader(PATH, device=dev) as r:
        # 1. bloom: equality on a value inside every [min, max] but never written
        ghost = (1 << 41) + 7
        print("groups admitting ghost trip_id:", r.prune_row_groups([("trip_id", "==", ghost)]))

        # 2. page index: a time band maps to row ranges, not whole groups
        # (filters use the ergonomic domain iter_rows yields: datetimes)
        cutoff = dt.datetime.fromtimestamp(
            (1_700_000_000_000_000 + N - 5_000) / 1e6, tz=dt.timezone.utc
        ).replace(tzinfo=None)
        band = [("ts", ">=", cutoff)]
        print("admitted row ranges:", r.prune_pages(r.num_row_groups - 1, band))

        # 3. selective page decode: only admitted pages are read + decompressed
        t0 = time.perf_counter()
        rows = list(r.iter_rows(filters=band))
        print(f"filtered scan: {len(rows)} rows in {(time.perf_counter()-t0)*1e3:.0f} ms")

        # 4. device batches with pushdown: excluded groups never reach the card
        batches = delivered = 0
        for batch in r.iter_device_batches(65_536, filters=band, drop_remainder=False):
            batches += 1
            delivered += len(batch[("ts",)])
        print(f"device batches after pushdown: {batches} ({delivered} rows)")
    print(f"on {dev.type}")


if __name__ == "__main__":
    main()
