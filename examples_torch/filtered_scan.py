"""Statistics-driven filtered scan: row groups provably outside the
predicate never load or decode; surviving rows are checked exactly.

The PyTorch port's counterpart of examples/filtered_scan.py: 1,000,000
rows in row groups of 100,000, SNAPPY with dictionaries (pyarrow's
defaults, where the reference writes with pyarrow), written with the
port's FileWriter into the working directory.

    python examples_torch/filtered_scan.py          # needs CUDA
    python examples_torch/filtered_scan.py --cpu

The row scan decodes on the host; the reader is opened on CUDA without
--cpu, and the example exits 1 without it.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import parquet_tpu_torch as ptq

PATH = "example_filtered.parquet"
ROWS = 1_000_000
GROUP = 100_000


def write(path: str) -> None:
    schema = ptq.parse_schema("message m { required int64 ts; required double fare; }")
    ts = np.arange(ROWS, dtype=np.int64)
    fare = np.random.default_rng(0).uniform(2, 80, ROWS)
    with ptq.FileWriter(path, schema, codec="snappy", use_dictionary=True) as w:
        for s in range(0, ROWS, GROUP):
            w.write_column("ts", ts[s : s + GROUP])
            w.write_column("fare", fare[s : s + GROUP])
            w.flush_row_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("filtered_scan: CUDA is not available; pass --cpu", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cpu" if args.cpu else "cuda")

    write(PATH)
    with ptq.FileReader(PATH, device=dev) as r:
        keep = r.prune_row_groups([("ts", ">=", 850_000)])
        print(f"row groups: {r.num_row_groups}, surviving pruning: {keep}")
        n = 0
        total = 0.0
        for row in r.iter_rows(filters=[("ts", ">=", 850_000), ("fare", ">", 75.0)]):
            n += 1
            total += row["fare"]
        print(f"{n} matching rows, mean fare {total / max(n, 1):.2f}")
    print(f"on {dev.type}")


if __name__ == "__main__":
    main()
