"""High-level dataclass mapping (the analogue of the reference's floor
examples).

The PyTorch port's counterpart of examples/dataclass_floor.py: two Trip
records written with floor.Writer to trips.parquet in the working
directory and read back with floor.Reader, whose `device=` goes on to
the FileReader.

    python examples_torch/dataclass_floor.py          # needs CUDA
    python examples_torch/dataclass_floor.py --cpu

Without --cpu it needs CUDA, and exits 1 without it.
"""

import argparse
import datetime as dt
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

from parquet_tpu_torch import floor


@dataclass
class Trip:
    id: int
    vendor: Optional[str]
    ts: dt.datetime
    tags: list[str]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("dataclass_floor: CUDA is not available; pass --cpu", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cpu" if args.cpu else "cuda")

    with floor.Writer("trips.parquet", Trip, codec="snappy") as w:
        w.write(Trip(1, "CMT", dt.datetime.now(dt.timezone.utc), ["fast"]))
        w.write(Trip(2, None, dt.datetime.now(dt.timezone.utc), []))

    for trip in floor.Reader("trips.parquet", Trip, device=dev):
        print(trip)
    print(f"on {dev.type}")


if __name__ == "__main__":
    main()
