"""Streaming training over a multi-file dataset, with mid-epoch resume.

The PyTorch counterpart of examples/streaming_train_loop.py. The
production input-pipeline shape: a glob of Parquet shards streams through
ParquetDataset — footers planned once, units shuffled per epoch, decode
prefetched on background threads, rows rebatched to a fixed shape,
batches uploaded to the device through pinned memory — and an nn.Module
trains on them with torch.optim.SGD. Halfway through, the job "crashes":
we snapshot the iterator's state_dict, build a fresh dataset, resume, and
verify the resumed stream is byte-identical to the one the uninterrupted
job saw.

    python examples_torch/streaming_train_loop.py          # on CUDA
    python examples_torch/streaming_train_loop.py --cpu    # on the CPU

Without --cpu it needs CUDA, and exits 1 without it.
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from parquet_tpu_torch import FileWriter, parse_schema
from parquet_tpu_torch.data import ParquetDataset

BATCH = 2048
SHARDS = 6
ROWS_PER_SHARD = 8192


def write_shards(d: str) -> str:
    """y = sign(1.5*x1 - 2*x2 + noise), split over SHARDS files."""
    rng = np.random.default_rng(0)
    schema = parse_schema("""
    message samples {
      required float x1;
      required float x2;
      required float label;
    }""")
    for i in range(SHARDS):
        x1 = rng.standard_normal(ROWS_PER_SHARD).astype(np.float32)
        x2 = rng.standard_normal(ROWS_PER_SHARD).astype(np.float32)
        y = (
            (1.5 * x1 - 2.0 * x2 + 0.1 * rng.standard_normal(ROWS_PER_SHARD)) > 0
        ).astype(np.float32)
        with FileWriter(
            os.path.join(d, f"shard-{i:03d}.parquet"), schema, codec="snappy"
        ) as w:
            w.write_column("x1", x1)
            w.write_column("x2", x2)
            w.write_column("label", y)
    return os.path.join(d, "shard-*.parquet")


def make_dataset(pattern: str, device) -> ParquetDataset:
    # In a multi-process job, shard="torch" stripes units over the
    # torch.distributed group; worker=(w, W) sub-shards per process.
    return ParquetDataset(
        pattern,
        batch_size=BATCH,
        shuffle=True,
        seed=42,
        num_epochs=2,
        prefetch=2,       # decode 2 units ahead on pqt-data threads
        device=device,    # pinned uploads, one batch ahead
        on_error="skip",  # a corrupt shard degrades the epoch, not the job
    )


def pick_device(cpu: bool) -> torch.device:
    """The CPU with --cpu, else CUDA, which must be there."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("streaming_train_loop: CUDA is not available; pass --cpu", file=sys.stderr)
        sys.exit(1)
    return torch.device("cuda")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    pattern = write_shards(tempfile.mkdtemp())
    model = torch.nn.Linear(2, 1).to(device)
    torch.nn.init.zeros_(model.weight)
    torch.nn.init.zeros_(model.bias)
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    loss_fn = torch.nn.BCEWithLogitsLoss()

    def step_on(batch) -> float:
        x = torch.stack([batch[("x1",)], batch[("x2",)]], dim=1)
        opt.zero_grad()
        loss = loss_fn(model(x).squeeze(1), batch[("label",)])
        loss.backward()
        opt.step()
        return loss.item()

    # -- the uninterrupted job, remembering every batch after the cut -------
    ds = make_dataset(pattern, device)
    it = iter(ds)
    cut = 9
    first = last = None
    checkpoint = None
    seen_after_cut = []
    for step, batch in enumerate(it):
        assert batch[("x1",)].device.type == device.type, batch[("x1",)].device
        last = step_on(batch)
        if first is None:
            first = last
        if step + 1 == cut:
            checkpoint = it.state_dict()  # covers batches 0..cut-1
        if checkpoint is not None and step + 1 > cut:
            seen_after_cut.append(batch[("x1",)].cpu().numpy())
    ds.close()
    print(
        f"trained {step + 1} steps over {SHARDS} shards on {device}: "
        f"loss {first:.4f} -> {last:.4f}"
    )
    assert last < first, "loss should decrease"

    # -- the "restarted" job: fresh dataset, resume from the checkpoint -----
    ds2 = make_dataset(pattern, device)
    resumed = [b[("x1",)].cpu().numpy() for b in ds2.iterator(state=checkpoint)]
    ds2.close()
    assert len(resumed) == len(seen_after_cut), (
        len(resumed), len(seen_after_cut),
    )
    for a, b in zip(seen_after_cut, resumed):
        assert a.tobytes() == b.tobytes()
    print(
        f"resume from step {cut} replayed {len(resumed)} remaining batches "
        "byte-identically (shuffled, mid-epoch)"
    )


if __name__ == "__main__":
    main()
