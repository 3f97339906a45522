"""Low-level columnar read (the analogue of the reference's
examples/read-low-level): open a file, walk row groups, get typed arrays.

The PyTorch port's counterpart of examples/read_low_level.py: the host
read_row_group walk over a file (default: example.parquet in the working
directory, as write_low_level.py writes it).

    python examples_torch/read_low_level.py [PATH]          # needs CUDA
    python examples_torch/read_low_level.py [PATH] --cpu

The walk decodes on the host (read_row_group_device decodes on the card:
cuda_columnar_scan.py); the reader is opened on CUDA without --cpu, and
the example exits 1 without it.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

import parquet_tpu_torch as pq


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="example.parquet")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("read_low_level: CUDA is not available; pass --cpu", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cpu" if args.cpu else "cuda")

    with pq.FileReader(args.path, device=dev) as r:
        print(f"{r.num_rows} rows, {r.num_row_groups} row groups")
        for i in range(r.num_row_groups):
            chunks = r.read_row_group(i)
            for col_path, chunk in chunks.items():
                print(f"  rg{i} {'.'.join(col_path)}: {len(chunk.values)} values, "
                      f"{type(chunk.values).__name__}")
    print(f"on {dev.type}")


if __name__ == "__main__":
    main()
