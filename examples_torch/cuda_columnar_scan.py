"""CUDA columnar scan: decode on the card, check against the host.

The PyTorch port's counterpart of examples/tpu_columnar_scan.py. Every
row group of a file (default: example.parquet in the working directory,
as write_low_level.py writes it) is decoded with read_row_group_device:
the hybrid RLE expansion, the dictionary gather and the DELTA decode run
as the port's CUDA kernels. Each column's value count and dtype are
printed, and its values are held equal to the host read_row_group's.

    python examples_torch/cuda_columnar_scan.py [PATH]          # needs CUDA
    python examples_torch/cuda_columnar_scan.py [PATH] --cpu    # plain versions

Without --cpu it needs CUDA, and exits 1 without it.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import parquet_tpu_torch as pq


def device_values(col) -> tuple[int, str, np.ndarray | list]:
    """(count, dtype, values on the host) of one DeviceColumn: numeric
    values, a byte array's rows, or a dictionary chunk's rows."""
    if col.values is not None:
        v = col.values.cpu().numpy()
        return len(v), str(v.dtype), v
    if col.data is not None:
        data, off = bytes(col.data.cpu().numpy()), col.offsets.cpu().tolist()
        return len(off) - 1, "bytes", [data[a:b] for a, b in zip(off[:-1], off[1:])]
    idx = col.indices.cpu().numpy()
    d = col.dictionary
    rows = [d[int(k)] for k in idx] if not isinstance(d, np.ndarray) else d[idx]
    return len(idx), "bytes", rows


def host_values(chunk) -> np.ndarray | list:
    v = chunk.values
    return v if isinstance(v, np.ndarray) else v.to_list()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="example.parquet")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("cuda_columnar_scan: CUDA is not available; pass --cpu", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cpu" if args.cpu else "cuda")

    with pq.FileReader(args.path, device=dev) as r:
        for i in range(r.num_row_groups):
            host = r.read_row_group(i)
            for col_path, col in r.read_row_group_device(i).items():
                n, dtype, got = device_values(col)
                want = host_values(host[col_path])
                if isinstance(got, np.ndarray):
                    assert np.array_equal(got.view(np.uint8), np.asarray(want).view(np.uint8))
                else:
                    assert list(got) == list(want)
                print(f"rg{i} {'.'.join(col_path)}: n={n} dtype={dtype}")
    print("device columns equal the host read")
    print(f"on {dev.type}")


if __name__ == "__main__":
    main()
