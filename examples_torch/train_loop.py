"""Training loop on the card: parquet -> device batches -> torch SGD.

The PyTorch counterpart of examples/train_loop.py. The consumption pattern
the decode pipeline is built for: encoded pages ship to the device, decode
there (the port's CUDA kernels), and every fixed-shape batch feeds the
train step WITHOUT the decoded values ever visiting host memory.

    python examples_torch/train_loop.py          # on CUDA
    python examples_torch/train_loop.py --cpu    # the kernels' plain versions

Without --cpu it needs CUDA, and exits 1 without it. Under
torch.distributed (torchrun sets WORLD_SIZE > 1) each rank takes its slice
of every batch (iter_device_batches(sharding=)) and the gradients are
averaged (DistributedDataParallel); a single process is one rank and
reads whole batches.
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from parquet_tpu_torch import FileReader, FileWriter, parse_schema

BATCH = 4096
STEPS_PER_EPOCH = 16


def make_dataset(path: str, rows: int = BATCH * STEPS_PER_EPOCH) -> None:
    """A linearly-separable-ish dataset: y = x @ w_true + noise > 0."""
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal(rows).astype(np.float32)
    x2 = rng.standard_normal(rows).astype(np.float32)
    y = (1.5 * x1 - 2.0 * x2 + 0.1 * rng.standard_normal(rows)) > 0
    schema = parse_schema("""
    message samples {
      required float x1;
      required float x2;
      required boolean label;
    }""")
    with FileWriter(path, schema, codec="snappy") as w:
        w.write_column("x1", x1)
        w.write_column("x2", x2)
        w.write_column("label", y)


def pick_device(cpu: bool) -> torch.device:
    """The CPU with --cpu, else CUDA, which must be there."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("train_loop: CUDA is not available; pass --cpu", file=sys.stderr)
        sys.exit(1)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    dev = pick_device(args.cpu)
    group = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # launched by torchrun
        import torch.distributed as dist

        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        group = dist.group.WORLD

    path = os.path.join(tempfile.mkdtemp(), "train.parquet")
    make_dataset(path)

    torch.manual_seed(0)
    model = torch.nn.Linear(2, 1).to(dev)
    torch.nn.init.zeros_(model.weight)
    torch.nn.init.zeros_(model.bias)
    if group is not None:
        model = torch.nn.parallel.DistributedDataParallel(model)
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    loss_fn = torch.nn.BCEWithLogitsLoss()

    first = last = None
    for epoch in range(3):
        with FileReader(path, device=dev) as r:
            # decoded batches land in device memory (a rank's slice under
            # torch.distributed); the step's shapes never change
            for batch in r.iter_device_batches(BATCH, sharding=group):
                x = torch.stack([batch[("x1",)], batch[("x2",)]], dim=1)
                y = batch[("label",)].to(torch.float32)
                opt.zero_grad()
                loss = loss_fn(model(x).squeeze(1), y)
                loss.backward()
                opt.step()
                last = loss.item()
                if first is None:
                    first = last
        w = model.module.weight if group is not None else model.weight
        print(f"epoch {epoch}: loss {last:.4f}  w={w.detach().cpu().numpy().round(3)[0]} "
              f"on {dev}")
    assert last < first, "loss should decrease"
    w = w.detach().cpu().numpy()[0]
    assert w[0] > 0 > w[1], "learned signs should match the generator"
    print("learned w matches the generating weights' signs — training works")
    if group is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
