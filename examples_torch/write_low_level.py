"""Low-level write with the schema DSL (the analogue of the reference's
examples/write-low-level).

The PyTorch port's counterpart of examples/write_low_level.py: the same
schema and the same two rows, written to example.parquet in the working
directory (read_low_level.py and cuda_columnar_scan.py read it back).

    python examples_torch/write_low_level.py          # needs CUDA
    python examples_torch/write_low_level.py --cpu

The write itself is a host path; like every example of the port it needs
CUDA without --cpu, and exits 1 without it.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

import parquet_tpu_torch as pq


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("write_low_level: CUDA is not available; pass --cpu", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cpu" if args.cpu else "cuda")

    schema = pq.parse_schema("""
    message example {
      required int64 id;
      optional binary name (STRING);
      optional group scores (LIST) {
        repeated group list {
          optional double element;
        }
      }
    }
    """)

    with pq.FileWriter("example.parquet", schema, codec="snappy") as w:
        w.write_row({"id": 1, "name": "alice", "scores": [9.5, 8.0]})
        w.write_row({"id": 2, "name": None, "scores": []})
    print("wrote example.parquet")
    print(f"on {dev.type}")


if __name__ == "__main__":
    main()
