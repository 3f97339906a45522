"""Sharded columnar scan: row groups decode straight onto the card and
per-column statistics reduce there (masked_agg) and over torch.distributed
ranks.

The PyTorch port's counterpart of examples/distributed_stats.py: 500,000
rows of `x` (int64) and `f` (double) in row groups of 50,000, PLAIN,
written with the port's FileWriter into the working directory. In a
multi-rank program each rank touches only its own slice of the file
(process_row_groups); here, with no process group initialised, the scan
runs over this process's device and distributed_column_stats is the local
fold.

    python examples_torch/distributed_stats.py          # needs CUDA
    python examples_torch/distributed_stats.py --cpu    # the kernels' plain versions

Without --cpu it needs CUDA, and exits 1 without it.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import parquet_tpu_torch as ptq
from parquet_tpu_torch.parallel.scan import column_stats, distributed_column_stats

PATH = "example_dstats.parquet"
ROWS = 500_000
GROUP = 50_000


def write(path: str) -> None:
    schema = ptq.parse_schema("message m { required int64 x; required double f; }")
    x = np.arange(ROWS, dtype=np.int64)
    f = np.linspace(-1, 1, ROWS)
    with ptq.FileWriter(path, schema, codec="snappy", use_dictionary=False) as w:
        for s in range(0, ROWS, GROUP):
            w.write_column("x", x[s : s + GROUP])
            w.write_column("f", f[s : s + GROUP])
            w.flush_row_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("distributed_stats: CUDA is not available; pass --cpu", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cpu" if args.cpu else "cuda")

    write(PATH)
    with ptq.FileReader(PATH, device=dev) as r:
        print("devices:", [str(dev)])
        print("mesh scan:", column_stats(r, [dev]))
        print("multi-host shape:", distributed_column_stats(r))
    print(f"on {dev.type}")


if __name__ == "__main__":
    main()
