#!/usr/bin/env python3
"""Drive parquet_tpu_torch's decode path on one CUDA card.

Run from the repository root, on a machine with one NVIDIA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. device   the card's name and power limit (nvidia-smi);
  2. build    the CUDA kernels from kernels/csrc/, timed;
  3. kernels  each kernel against its plain PyTorch version on the card,
              bit-exact, at the main path's shapes;
  4. main     an 8,388,608-row NYC-taxi-like file (8 row groups of 2**20
              rows, ~1 MiB pages, built from a seed with testing/synth.py)
              decoded by FileReader(path).read_row_groups_device() and held
              against the generator's arrays; every kernel must have been
              launched, no page may fall back to host decode, and one row
              group through backend="device_roundtrip" must equal the host
              decode;
  5. times    rows/s of the device read and of host decode + upload, and
              each kernel's CUDA-event time beside its bound.

The last two lines of standard output are the `kernels` JSON line and the
`{"ok": true, ...}` line. Without CUDA, or without the package beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20261017
ROW_GROUPS = 8
RG_ROWS = 1 << 20
HYBRID_WIDTHS = (0, 1, 3, 8, 17, 32)
HYBRID_N = 1 << 20
GATHER_D = 100_000
DELTA_PAGES = 8
DELTA_PAGE_ROWS = 1 << 17
# Non-tensor peak of an H100 SXM (67 T/s in float32, from NVIDIA's H100
# datasheet): the operations bound of these integer kernels.
OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def mem_bandwidth(name: str) -> float:
    """Device memory rate (bytes/s) of the card, from its name."""
    n = name.upper()
    if "H100" in n:
        if "PCIE" in n:
            return 2.0e12
        if "NVL" in n:
            return 3.9e12
        return 3.35e12
    if "H200" in n:
        return 4.8e12
    raise RuntimeError(f"no memory bandwidth on record for {name!r}")


def device_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per call of `fn`: `reps` calls captured in one CUDA graph
    and replayed, timed with CUDA events. A graph replay launches the
    captured kernels back to back, so the host's per-call overhead (the
    Python wrapper, ctypes, the allocator) drops out. The inputs stay in
    the 50 MB L2 from one call to the next, as a chunk's freshly uploaded
    buffers are on the main path."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def eager_ms(fn, reps: int = 20) -> float:
    """Wall time per eager call, synchronized: what a caller sees per launch,
    host overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def bits_equal(a, b) -> tuple[bool, float]:
    """(exactly equal?, max abs difference of the values as float64)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if torch.equal(a, b):
        return True, 0.0
    return False, float((a.double() - b.double()).abs().max())


# -- phase 3: kernel inputs at the main path's shapes ---------------------------


def hybrid_batch(rng, width: int, n: int):
    """A frozen hybrid batch of two pages from real encode_hybrid streams that
    hold both RLE and bit-packed runs, and the values it must expand to."""
    from parquet_tpu_torch.kernels.pipeline import _HybridBatch
    from parquet_tpu_torch.ops.rle_hybrid import encode_hybrid, prescan_hybrid

    hi = 1 << width
    vals = rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)
    # long repeated stretches become RLE runs
    for start in rng.integers(0, n - 4096, size=64):
        vals[start : start + int(rng.integers(16, 4096))] = vals[start]
    batch = _HybridBatch(width)
    half = n // 2
    for page in (vals[:half], vals[half:]):
        stream = encode_hybrid(page, width)
        batch.add_page(prescan_hybrid(stream, len(page), width), len(page))
    return batch.freeze(), vals


def delta_batch(rng, nbits: int):
    """A frozen delta batch of DELTA_PAGES pages: full-range random values
    (miniblock widths up to nbits, wrapping deltas), monotone timestamps with
    negative jitter, and constants; and the values it must decode to."""
    from parquet_tpu_torch.kernels.pipeline import _DeltaBatch
    from parquet_tpu_torch.ops.delta import encode_delta, prescan_delta_packed

    dt = np.int32 if nbits == 32 else np.int64
    info = np.iinfo(dt)
    batch = _DeltaBatch(nbits)
    pages = []
    for k in range(DELTA_PAGES):
        n = DELTA_PAGE_ROWS - 37 * k
        kind = k % 3
        if kind == 0:
            v = rng.integers(info.min, info.max, size=n, dtype=dt, endpoint=True)
        elif kind == 1:
            v = (np.cumsum(rng.integers(-50, 1000, size=n)) + int(info.max) - 10_000_000)
            v = v.astype(np.int64).astype(dt)  # wraps past the type's max
        else:
            v = np.full(n, -7, dtype=dt)
        stream = encode_delta(v, nbits)
        batch.add_page(prescan_delta_packed(stream, nbits, max_total=n), stream)
        pages.append(v)
    return batch.freeze(), np.concatenate(pages)


def check_kernels(dev, rows: dict) -> None:
    """Each kernel against its plain version (and the generator) on the card."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import to_device

    rng = np.random.default_rng(SEED)
    errs = {"expand_hybrid": 0.0, "dict_gather": 0.0, "delta_packed_decode": 0.0}
    for width in HYBRID_WIDTHS:
        frozen, want = hybrid_batch(rng, width, HYBRID_N)
        buf = to_device(frozen.buf.view(np.int32), dev)
        got = ops.expand_hybrid(buf, width, frozen.run_pad, frozen.total)
        plain = ops.expand_hybrid_plain(buf, width, frozen.run_pad, frozen.total)
        torch.cuda.synchronize()
        ok, err = bits_equal(got, plain)
        truth = np.array_equal(got.cpu().numpy().view(np.uint32), want)
        log(f"  expand_hybrid width={width:2d} n={frozen.total} runs<={frozen.run_pad}: "
            f"equal={ok} matches_generator={truth}")
        if not (ok and truth):
            raise AssertionError(f"expand_hybrid width {width} disagrees (max abs {err})")
        errs["expand_hybrid"] = max(errs["expand_hybrid"], err)
    for dt in (np.int32, np.int64):
        info = np.iinfo(dt)
        dictionary = to_device(
            rng.integers(info.min, info.max, size=GATHER_D, dtype=dt, endpoint=True), dev
        )
        idx_np = rng.integers(0, GATHER_D, size=RG_ROWS, dtype=np.int32)
        idx_np[:4] = (-1, GATHER_D, 2**31 - 1, -GATHER_D - 5)  # jnp's clamp rules
        idx = to_device(idx_np, dev)
        got = ops.dict_gather(dictionary, idx)
        plain = ops.dict_gather_plain(dictionary, idx)
        torch.cuda.synchronize()
        ok, err = bits_equal(got, plain)
        log(f"  dict_gather {np.dtype(dt).itemsize}-byte D={GATHER_D} n={RG_ROWS}: equal={ok}")
        if not ok:
            raise AssertionError(f"dict_gather disagrees (max abs {err})")
        errs["dict_gather"] = max(errs["dict_gather"], err)
    for nbits in (32, 64):
        frozen, want = delta_batch(rng, nbits)
        meta32 = to_device(frozen.meta32.view(np.int32), dev)
        wide = to_device(frozen.wide.view(np.int32 if nbits == 32 else np.int64), dev)
        args = (meta32, wide, nbits, frozen.m_pad, frozen.p_pad, frozen.total)
        got = ops.delta_packed_decode(*args)
        plain = ops.delta_packed_decode_plain(*args)
        torch.cuda.synchronize()
        ok, err = bits_equal(got, plain)
        truth = np.array_equal(got.cpu().numpy(), want)
        widths = frozen.meta32[: frozen.m_pad]
        log(f"  delta_packed_decode {nbits}-bit pages={DELTA_PAGES} n={frozen.total} "
            f"max_width={int(widths.max())}: equal={ok} matches_generator={truth}")
        if not (ok and truth):
            raise AssertionError(f"delta_packed_decode {nbits} disagrees (max abs {err})")
        errs["delta_packed_decode"] = max(errs["delta_packed_decode"], err)
    for name, err in errs.items():
        rows[name]["max_abs_err"] = err


# -- phase 4: the main path ----------------------------------------------------


def taxi_columns(seed: int):
    """The generator's columns: a NYC-yellow-taxi-like month and a half of
    trips (ROW_GROUPS * RG_ROWS rows), as synth ColumnSpecs."""
    from parquet_tpu_torch.core.arrays import ByteArrayData
    from parquet_tpu_torch.meta.parquet_types import CompressionCodec as C
    from parquet_tpu_torch.meta.parquet_types import Encoding as E
    from parquet_tpu_torch.meta.parquet_types import Type as T
    from parquet_tpu_torch.testing.synth import ColumnSpec

    n = ROW_GROUPS * RG_ROWS
    rng = np.random.default_rng(seed)
    runs = rng.integers(200, 5000, size=n // 200 + 2)
    vendor = np.repeat(rng.integers(0, 8, size=len(runs)).astype(np.int32), runs)[:n]
    valid = rng.random(n) >= 0.05
    passengers = rng.choice(7, size=int(valid.sum()), p=(0.02, 0.7, 0.14, 0.05, 0.03, 0.04, 0.02))
    pickup = 1_700_000_000_000_000 + np.cumsum(rng.integers(-2_000_000, 60_000_000, size=n))
    fare = rng.gamma(2.0, 900.0, size=n).astype(np.int32) + 250
    dist_dict = np.round(rng.gamma(1.5, 2.5, size=4096), 2)
    zones = ByteArrayData.from_list(
        [f"zone-{i:06d}-{'abcdefgh'[i % 8] * (i % 11)}".encode() for i in range(100_000)]
    )
    return [
        ColumnSpec("trip_id", T.INT64, values=np.arange(n, dtype=np.int64) + 10**9),
        ColumnSpec("vendor_id", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.GZIP,
                   page_version=2, dictionary=np.arange(1, 9, dtype=np.int32), indices=vendor),
        ColumnSpec("passenger_count", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.GZIP,
                   valid=valid, dictionary=np.arange(7, dtype=np.int32),
                   indices=passengers.astype(np.int32)),
        ColumnSpec("pickup_us", T.INT64, values=pickup.astype(np.int64),
                   encoding=E.DELTA_BINARY_PACKED, codec=C.GZIP, page_version=2),
        ColumnSpec("fare_cents", T.INT32, values=fare, encoding=E.DELTA_BINARY_PACKED,
                   page_version=2),
        ColumnSpec("trip_distance", T.DOUBLE, encoding=E.RLE_DICTIONARY, codec=C.GZIP,
                   dictionary=dist_dict,
                   indices=rng.integers(0, 4096, size=n, dtype=np.int32)),
        ColumnSpec("zone", T.BYTE_ARRAY, encoding=E.RLE_DICTIONARY, codec=C.GZIP,
                   dictionary=zones, utf8=True,
                   indices=rng.integers(0, 100_000, size=n, dtype=np.int32)),
    ]


def smoke_file(specs) -> Path:
    """The main-path file, built once per seed under the build directory."""
    from parquet_tpu_torch.kernels.build import BUILD_ROOT
    from parquet_tpu_torch.testing.synth import write_file

    path = BUILD_ROOT / "smoke" / f"taxi-{SEED}-{ROW_GROUPS}x{RG_ROWS}.parquet"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        write_file(tmp, specs, row_group_rows=RG_ROWS)
        tmp.replace(path)
    return path


def check_main_path(groups, specs, stats) -> None:
    """Every delivered column equals the generator's arrays."""
    from parquet_tpu_torch.testing.synth import column_values

    for s in specs:
        path = (s.name,)
        cols = [g[path] for g in groups]
        if s.valid is not None:
            defs = np.concatenate([c.def_levels for c in cols])
            if not np.array_equal(defs.astype(bool), s.valid):
                raise AssertionError(f"{s.name}: null positions differ")
        if s.name == "zone":
            idx = np.concatenate([c.indices.cpu().numpy() for c in cols])
            if not np.array_equal(idx, s.indices):
                raise AssertionError("zone: indices differ")
            d = cols[0]
            if not (np.array_equal(d.dict_data.cpu().numpy(),
                                   np.frombuffer(s.dictionary.data, np.uint8))
                    and np.array_equal(d.dict_offsets.cpu().numpy(), s.dictionary.offsets)):
                raise AssertionError("zone: device dictionary differs")
            if d.dictionary.take(idx) != column_values(s):
                raise AssertionError("zone: strings rebuilt from indices differ")
            continue
        got = np.concatenate([c.values.cpu().numpy() for c in cols])
        want = np.asarray(column_values(s))
        if got.dtype != want.dtype or got.tobytes() != want.tobytes():
            raise AssertionError(f"{s.name}: values differ")
    if stats.host_fallback_pages != 0:
        raise AssertionError(f"host_fallback_pages = {stats.host_fallback_pages}")


def chunks_equal(a, b) -> bool:
    from parquet_tpu_torch.core.arrays import ByteArrayData

    def same(x, y):
        if x is None or y is None:
            return x is None and y is None
        if isinstance(x, ByteArrayData):
            return x == y
        x, y = np.asarray(x), np.asarray(y)
        return x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()

    return a.num_values == b.num_values and all(
        same(getattr(a, f), getattr(b, f))
        for f in ("values", "def_levels", "rep_levels", "dictionary")
    )


# -- phase 5: kernel times at the main path's shapes ----------------------------


def time_kernels(path, dev, rows: dict, bw: float) -> None:
    """Device times of each kernel on one main-path chunk's inputs, of its
    plain version, and of the one PyTorch call computing the same function
    where there is one; the bound from the bytes the function must move
    (each input read once, each output written once) and its operations."""
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import prepare_chunk_plan, to_device

    with FileReader(path, device=dev) as r:
        plans = {
            p[0]: prepare_chunk_plan(r._window(cc), cc, column)
            for p, cc, column in r._selected_chunks(0, ["trip_distance", "pickup_us"])
        }

    def record(name, fn, plain, nbytes, ops_count, library=None):
        entry = {
            "ms": device_ms(fn),
            "plain_ms": device_ms(plain),
            "library_ms": device_ms(library) if library is not None else None,
            "eager_ms": eager_ms(fn),
        }
        bytes_ms = nbytes / bw * 1e3
        ops_ms = ops_count / OPS_PER_S * 1e3
        entry["bound_ms"] = max(bytes_ms, ops_ms)
        entry["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        rows[name].update(entry)
        log(f"  {name}: {entry['ms']:.4f} ms on the device (eager call "
            f"{entry['eager_ms']:.4f} ms), plain {entry['plain_ms']:.4f} ms"
            + (f", library {entry['library_ms']:.4f} ms" if library is not None else "")
            + f"; bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, {nbytes} B, "
            f"{ops_count} ops); {nbytes / entry['ms'] / 1e6:.1f} GB/s")

    fh = plans["trip_distance"].frozen_hybrid[0]
    runs = int(np.count_nonzero(fh.buf[fh.run_pad : 2 * fh.run_pad] != fh.n_pad + 1))
    starts = fh.buf[fh.run_pad : fh.run_pad + runs].astype(np.int64)
    counts = np.diff(np.append(starts, fh.total))
    bp_values = int(counts[fh.buf[:runs] == 0].sum())
    buf = to_device(fh.buf.view(np.int32), dev)
    hargs = (buf, fh.width, fh.run_pad, fh.total)
    # bytes: 16 B of run table per run, the packed payload, int32 outputs;
    # ops: 3 per step of the run search plus ~12 for the two-word extract
    record("expand_hybrid",
           lambda: ops.expand_hybrid(*hargs), lambda: ops.expand_hybrid_plain(*hargs),
           16 * runs + (bp_values * fh.width + 7) // 8 + 4 * fh.total,
           fh.total * (3 * max(runs, 1).bit_length() + 12))
    idx = ops.expand_hybrid(*hargs)
    dictionary = to_device(plans["trip_distance"].dictionary.view(np.int64), dev)
    n = idx.numel()
    # bytes: indices and the dictionary read once, 8-byte outputs; ops: wrap,
    # clamp and address, ~4 per output
    record("dict_gather",
           lambda: ops.dict_gather(dictionary, idx), lambda: ops.dict_gather_plain(dictionary, idx),
           4 * n + 8 * dictionary.numel() + 8 * n, 4 * n,
           library=lambda: dictionary[idx])
    fd = plans["pickup_us"].frozen_delta[0]
    sentinel = fd.n_pad + 1
    m = int(np.count_nonzero(fd.meta32[2 * fd.m_pad : 3 * fd.m_pad] != sentinel))
    p = int(np.count_nonzero(fd.meta32[3 * fd.m_pad : 3 * fd.m_pad + fd.p_pad] != sentinel))
    last = m - 1
    wire_bits = int(fd.meta32[fd.m_pad + last]) + 32 * int(fd.meta32[last])
    meta32 = to_device(fd.meta32.view(np.int32), dev)
    wide = to_device(fd.wide.view(np.int64), dev)
    dargs = (meta32, wide, 64, fd.m_pad, fd.p_pad, fd.total)
    # bytes: per miniblock width, bit start, out start and min (20 B), per
    # page start and first value (12 B), the wire payload, int64 outputs;
    # ops: two searches, the extract, the scan and the rebase, ~60 per output
    record("delta_packed_decode",
           lambda: ops.delta_packed_decode(*dargs), lambda: ops.delta_packed_decode_plain(*dargs),
           20 * m + 12 * p + (wire_bits + 7) // 8 + 8 * fd.total, 60 * fd.total)


def profile_device_read(path) -> None:
    """torch.profiler over one device read: device time by kernel and copy,
    and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parquet_tpu_torch.core.reader import FileReader

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        FileReader(path).read_row_groups_device()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device-side events only (kernels, copies): a host op such as
    # aten::copy_ also carries the device time of the copy it issued
    events = [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    events.sort(key=lambda e: -e[1])
    busy_us = sum(e[1] for e in events)
    if not events:
        log("  profiler: no device time recorded (not measured)")
        return
    log(f"  profiler: device busy {busy_us / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall "
        f"({100 * busy_us / wall_us:.2f} %)")
    for key, us, count in events[:8]:
        log(f"    {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels import build
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import to_device

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    bw = mem_bandwidth(name)
    log(f"[device] {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    build.load()
    log(f"[build] kernels built and loaded in {build.build_seconds():.2f} s")

    sources = {
        "expand_hybrid": ("parquet_tpu_torch/kernels/csrc/expand_hybrid.cu",
                          "parquet_tpu/kernels/device_ops.py:108"),
        "dict_gather": ("parquet_tpu_torch/kernels/csrc/dict_gather.cu",
                        "parquet_tpu/kernels/device_ops.py:256"),
        "delta_packed_decode": ("parquet_tpu_torch/kernels/csrc/delta_packed_decode.cu",
                                "parquet_tpu/kernels/device_ops.py:152"),
    }
    rows = {
        k: {"name": k, "route": "cuda", "source": src, "replaces": rep}
        for k, (src, rep) in sources.items()
    }

    log("[kernels] each kernel against its plain version on the card (bit-exact)")
    check_kernels(dev, rows)

    log("[main] building the main-path file")
    t = time.perf_counter()
    specs = taxi_columns(SEED)
    path = smoke_file(specs)
    n_rows = ROW_GROUPS * RG_ROWS
    log(f"[main] {path.name}: {n_rows} rows, {path.stat().st_size / 2**20:.1f} MiB, "
        f"ready in {time.perf_counter() - t:.1f} s")
    ops.reset_launch_counts()
    t = time.perf_counter()
    reader = FileReader(path)
    groups = reader.read_row_groups_device()
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t
    for k, fn in ops.KERNELS.items():
        rows[k]["launches"] = fn.launches
    log(f"[main] read_row_groups_device: {t_main:.2f} s, launches "
        + ", ".join(f"{k}={fn.launches}" for k, fn in ops.KERNELS.items())
        + f", stats {reader.stats}")
    check_main_path(groups, specs, reader.stats)
    for k, fn in ops.KERNELS.items():
        if rows[k]["launches"] <= 0:
            raise AssertionError(f"{k} was not launched on the main path")
    del groups
    rt = FileReader(path, backend="device_roundtrip")
    host = FileReader(path, backend="host")
    a, b = rt.read_row_group(0), host.read_row_group(0)
    if a.keys() != b.keys() or not all(chunks_equal(a[p], b[p]) for p in a):
        raise AssertionError("device_roundtrip row group 0 differs from host decode")
    log("[main] columns equal the generator; host_fallback_pages=0; "
        "device_roundtrip row group 0 equals host decode")

    log(f"[times] {name} | {smi}")

    def device_read():
        out = FileReader(path).read_row_groups_device()
        torch.cuda.synchronize()
        return out

    def host_read_upload():
        out = []
        with FileReader(path, backend="host") as r:
            for i in range(r.num_row_groups):
                g = {}
                for p, cd in r.read_row_group(i).items():
                    v = cd.values
                    if hasattr(v, "offsets"):
                        g[p] = (to_device(np.frombuffer(v.data, np.uint8), dev),
                                to_device(v.offsets, dev))
                    else:
                        g[p] = to_device(v, dev)
                out.append(g)
        torch.cuda.synchronize()
        return out

    rates = {}
    for label, fn in (("device", device_read), ("host+upload", host_read_upload)):
        fn()
        secs = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t)
        rates[label] = n_rows / statistics.median(secs)
        log(f"  {label}: {rates[label]:,.0f} rows/s (median of {[round(s, 3) for s in secs]} s)")
    from parquet_tpu_torch.kernels.pipeline import prepare_chunk_plan

    def prepare_only():
        with FileReader(path) as r:
            for i in range(r.num_row_groups):
                for _p, cc, column in r._selected_chunks(i):
                    prepare_chunk_plan(r._window(cc), cc, column)

    secs = []
    for _ in range(3):
        t = time.perf_counter()
        prepare_only()
        secs.append(time.perf_counter() - t)
    log(f"  host prepare alone: {n_rows / statistics.median(secs):,.0f} rows/s "
        f"(median of {[round(s, 3) for s in secs]} s)")
    profile_device_read(path)
    time_kernels(path, dev, rows, bw)

    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"rows_per_s": rates, "card": smi}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
