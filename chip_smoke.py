#!/usr/bin/env python3
"""Drive parquet_tpu_torch's decode, batch, filter, write, query, scan, row, io, remote
write, lake, serve and mesh paths on one CUDA card.

Run from the repository root, on a machine with one NVIDIA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. device   the card's name and power limit (nvidia-smi);
  2. build    the CUDA kernels from kernels/csrc/ and the host library
              from native/, timed;
  3. kernels  each kernel against its plain PyTorch version on the card,
              bit-exact, at the main paths' shapes and at edge shapes (one
              page, empty pages, all-dict and all-PLAIN chunks; the DELTA
              decode also on testing/synth.delta_edge_batches at 32 and 64
              bits: miniblocks of 8-128 values, widths 0 and nbits, one-value
              pages, hundreds of short pages, one page of 2**20 + 3 values,
              totals around the kernel's tile; expand_hybrid also on
              testing/synth.hybrid_edge_batches at widths 0, 1, 31 and 32:
              RLE runs of 1-17 values, one RLE run over five tiles,
              bit-packed last runs cut short, alternating 8-value runs
              that outnumber the kernel's staging, totals of 1 and around
              its tile, each line naming the route its tiles took;
              merge_mixed_bytes also on
              testing/synth.mixed_bytes_edge_cases: PLAIN rows of 100 KiB
              and more, all-empty rows and an all-empty tile, row counts
              around its tile, out-of-range indices across a tile
              boundary, lengths around multiples of 16; for the
              batch path's kernels n = 0, 1 and 2**20 + 3, no values,
              all-null and no-null masks, leading non-boundary entries,
              max_len 1, rows longer than a scan tile, every byte width
              (pad_ragged also on testing/synth.pad_ragged_edge_cases:
              rows around its tile, negative lengths at a tile's first and
              last row, int32 offsets that wrap and clip, lengths past
              int32, nv 0 and over, max_len 0, 1, 16 and 2,500, rows
              written in spans, 1-, 4- and 8-byte elements, int32 and
              int64 lengths; and on one row and on 17 rows of max_len
              2**27 uint8, a 128 MiB row, held a block of rows at a time,
              and on one row of max_len 2**31 + 4096;
              record_starts also on testing/synth.record_starts_edge_cases:
              sizes around its tile, leading non-starts longer than a
              tile, a tile without a start and one of starts only, and
              over 4,097 tiles; expand_nullable also on
              testing/synth.expand_nullable_edge_cases: sizes around its
              tile and past one and two groups of tiles, all-valid,
              all-null and random masks, nv exact, short, zero and long,
              1-, 4- and 8-byte values, views off 16 bytes);
              for the filter path's kernels every value dtype and op at
              n = 0, 1, 15-17, one block's work +-1 and 2**20 + 3 and at
              starts 1-15 elements off the 16-byte alignment,
              inexact and NaN brackets, unsigned patterns above 2**31 and
              2**63, in-lists of up to 64 members, FLBA rows, out-of-range
              dictionary indices, LIST streams opening mid-record, nv = 0,
              compaction past out_pad, 2-D and misaligned rows (mask_take
              also on testing/synth.mask_take_edge_cases, fused and as a
              scan and a row gather: sizes around its tile, two tiles a
              chunk, masks 1-15 bytes off 16, all-false and all-true
              masks, out_pad below, at and past the count, 1- to 64-byte
              rows, misaligned rows); for the
              write path's kernels n = 0, 1, 7, 8, 9, 127-129, every
              bit-pack width 0-32 and DELTA width 1-64, runs straddling the
              8-alignment, adjacent RLE windows, dictionary keys -1, INT_MIN
              and NaN payloads, more than 32,767 uniques, empty strings
              (bitpack_encode also on testing/synth.bitpack_edge_cases:
              sizes around its tile at widths 0-32, unmasked values, views
              off 16 bytes; rle_hybrid_encode also on
              testing/synth.rle_plan_edge_cases:
              sizes around its tile, a run over whole tiles, a run ending
              at a tile's edge, windows straddling and meeting at a tile's
              edge, alternating and all-equal values, a tile's packed range
              starting and ending mid-word, an all-RLE tile between two
              tiles that share a packed word, every value packed over
              2**22 + 777 values, widths 1, 3, 7, 12, 17, 31 and
              32, and on pages of 2**20, 2**22 + 777 and 2**26 + 777
              values, 4, 17 and 257 groups of its tiles; dict_indices also on testing/synth.dict_indices_edge_cases:
              sizes around its tile, one key over 2**20 rows, two keys
              across warp and tile boundaries, first rows in the last tile,
              32 keys a warp, at 32 and 64 bits; plain_bytearray_encode
              also on testing/synth.bytearray_frame_edge_cases: values
              of 5,000 and 70,000 bytes, tiles of headers only, offsets
              past 0 into data off 16 bytes, out_len past, inside and off
              16 of the stream, n = 1, no data, no values);
              for masked_agg every dtype (int32, int64, float32, float64,
              bool), op (count, sum, min, max) and view (signed, unsigned,
              UINT_8 and UINT_16 sub-widths) at n = 0, 1 and 2**20 + 3
              under random, all-false, all-true and no masks, with the
              signed extremes, patterns above 2**31 and 2**63, NaN, +-0.0
              and +-inf; for expand_page_grid widths 0, 1, 3, 12, 17 and 32
              with a single-run page, ragged counts, an all-padding page
              and out-of-range dictionary indices, and
              testing/synth.page_grid_edge_cases: n_out off its tile, runs
              shorter than a thread's outputs, more runs a tile than it
              stages, a page ending inside a tile, bit starts that wrap or
              are negative, a first start above 0, is_rle 2); every check
              of this phase runs on the pqt-dispatch thread, under its own
              stream, where the main paths launch the decode kernels;
  4. main     three 8,388,608-row files (8 row groups of 2**20 rows, ~1 MiB
              pages, chunk statistics, built from a seed with
              testing/synth.py), each decoded
              by FileReader(path).read_row_groups_device() and held against
              the generator's arrays, with the launch counts set to 0 just
              before each path and read just after:
              - "taxi": GZIP and uncompressed, dictionary, DELTA and PLAIN
                columns; expand_hybrid, dict_gather and delta_packed_decode
                must launch and no page may fall back to host decode;
              - "taxi_mixed": pyarrow's default writer shape, SNAPPY, data
                page V1, every dictionary falling back to PLAIN pages past
                1 MiB; the mixed numeric, mixed bytes and BYTE_STREAM_SPLIT
                routes must run (merge_mixed_numeric, merge_mixed_bytes,
                bss_transpose, one launch a BYTE_STREAM_SPLIT chunk) and
                the DOUBLE column takes the host merge;
              - "sessions": a recommender's item histories, SNAPPY, data
                page V2: an int64 DELTA session_id and an optional LIST of
                required int32 item ids (RLE_DICTIONARY over 65,536 keys;
                2 % null, 3 % empty, else 1..15 items a row); after the
                read, DeviceColumn.list_layout(0, 2) and record_starts on
                every items group must give the generator's per-row
                offsets, null mask and row ids (list_layout and
                record_starts must launch);
              on each the fused native prepare walk must take every chunk
              (no decline, fault or recovery), and one row group through
              backend="device_roundtrip" must equal the host decode;
     batches  FileReader(path).iter_device_batches(100_000, ...) over
              "taxi" (nullable="mask": passenger_count as a MaskedColumn,
              zone as its int32 indices; expand_nullable must launch) and
              "sessions" (lists="pad", max_list_len=16: items as a padded
              RaggedColumn; pad_ragged must launch), each batch feeding a
              small step on the card (masked sums and row counts) whose
              totals must equal the generator's exactly;
     filter   the same two streams with a predicate pushed down
              (filters=, filter_rows=True): "taxi" under F_taxi, a DNF of
              two conjunctions over pickup_us, fare_cents, passenger_count
              and a 12-string zone in-list; "sessions" under items
              contains its most frequent item and session_id below row
              group 6's first. Statistics must prune groups 6 and 7, the
              device engine must take every admitted group (no decline),
              predicate_mask, leaf_verdict (taxi), list_contains_mask
              (sessions) and mask_take must launch, and the steps' totals
              must equal NumPy's over the generator's arrays under the same
              predicate; then read_row_group_device(i, ["fare_cents"],
              filters=F_taxi) on every taxi group, mask_take of fare_cents
              under the mask summed on the card, held against NumPy;
     write    the taxi generator's columns uploaded to the card (numeric
              tensors, zone as uint8 data and int64 offsets per group) and
              written with FileWriter.write_device_column (SNAPPY, data
              page V1, 1 MiB pages, a dictionary probed on five columns,
              DELTA on pickup_us and fare_cents; passenger_count, OPTIONAL,
              through write_column): all six device columns of all groups
              must engage the device encoder (device_write_engaged 48,
              declined 0), the four write kernels must launch and
              bitpack_encode must not (rle_hybrid_encode packs), the file
              must equal the host write_column's of the same NumPy values
              byte for byte, and read_row_groups_device() of it must give
              the generator's columns;
     write-options  the same groups, the schema from the port's
              parse_schema (TAXI_DSL): (a) write_device_column with
              bloom_filters= on trip_id, vendor_id, trip_distance, zone and
              fare_cents equal to the host write with the same options,
              byte for byte, every device column engaged; (b) a fare_cents
              key in one row group only and one in none, both inside every
              group's min/max, through iter_device_batches(filters=,
              filter_rows=True) and read_row_group_device(i, filters=):
              bloom filters (filter_counts()) must prune exactly the groups
              the written filters rule out, statistics none, and the rows
              on the card must equal NumPy's; (c) the host write with
              write_page_index=True and GZIP serial (the fused walk must
              decline every chunk), serial with PQT_FUSED_ENCODE=0 and
              parallel=True, byte-equal, and prune_pages on 1,000-row
              trip_id ranges keeping the matches and dropping pages; (d)
              split_row_groups of the device-written file into two parts
              and merge_files back, read on the card equal to the
              generator; (e) timings: the device write with blooms
              against without (medians of 3), the GZIP host write without
              the page index fused against staged and parallel against
              serial (one timed run each, the first write of its file; the
              fused walk must take every chunk, the three files
              byte-equal), the SNAPPY and UNCOMPRESSED host
              writes fused against staged (medians of 3), the bloom and
              page-index bytes, and xxh64_fixed, xxh64_offsets,
              bloom_insert and chunk_encode against their Python oracles on
              write group 0;
     query    run_local_query over "taxi", unfiltered and under F_taxi:
              count(*), count(passenger_count) and sum/min/max of
              fare_cents (int32 DELTA, widened), pickup_us (int64),
              vendor_id (dictionary) and passenger_count (nullable: under
              the filter its validity aligns the mask); the body (units,
              rows scanned and matched, every value) must equal NumPy's
              over the generator, groups 6 and 7 pruned under the filter,
              masked_agg, dict_gather and (filtered) mask_take launched;
              group_by vendor_id and sum(trip_distance) must decline typed
              and counted; the unfiltered query over shard=(k, 4), k =
              0..3, must equal NumPy's over groups k and k + 4;
     scan     in an NCCL group of one rank (a file store): column_stats
              and distributed_column_stats over taxi's six numeric leaves
              (one stats scan's 18 one-element all_reduces timed alone and
              inside mesh_reduce_stats, by CUDA events),
              sharded_decode_step over trip_distance's real index pages (all
              8 groups, width 12, its 4,096-key double dictionary), and the
              entry point's three steps (decode_step with an int64
              dictionary, the pages x cols step on a 1 x 1 DeviceMesh,
              train_step over iter_device_batches(sharding=the group)), all
              equal to NumPy;
     dataset  data.ParquetDataset over taxi without zone (batch 100,000,
              nullable="zero"): CUDA delivery (device_put_pipelined on the
              dispatch thread) equal to CPU delivery batch for batch and to
              the generator, a resume from state_dict() after 13 batches
              (mid-unit) equal to the uninterrupted stream, shard=(k, 4) for
              k = 0..3 covering every unit and row once, and both
              deliveries' rows/s (medians of 3 after a warm-up);
     rows     the host row path against the card's decode: (a) taxi row
              group 0 through FileReader(path).iter_rows(row_groups=[0])
              equal value for value to read_row_group_device(0) of the
              same group brought to the CPU (zone a str, passenger_count
              None exactly where its device mask, expanded by
              expand_nullable, is false); (b) sessions row group 0 through
              iter_rows, each row's items equal to the generator's list
              (None for a null list, [] for an empty one); (c) taxi
              through iter_rows(filters=F_taxi) over all 8 groups, the row
              count, trip_id and fare_cents sums equal NumPy's and the
              device filtered read's, with row_counts() showing the
              vectorized engines on all 6 admitted groups; (d) (a)'s rows
              written through floor.Writer (TaxiTrip, a dataclass of the 7
              fields, default options) and read with
              read_row_groups_device() equal to the source, expand_hybrid
              and dict_gather launched, and floor.Reader's first 10,000
              objects equal to the written ones. The host row reads must
              launch no kernel; each step's rows/s and the phase's
              seconds are printed beside the card's name and power limit;
     io       the io layer (check_io): taxi and sessions served by
              testing/httpstub.RangeHttpStub from a process of its own;
              FileReader(url).read_row_groups_device() bit-equal to the
              path read (fused walk on every prepare); the same behind 5 ms
              of latency with the default gap and coalesce_gap="auto", and
              the host read of three columns both ways; iter_device_batches
              over the URL equal to taxi_totals; ParquetDataset over the URL
              for two epochs through a 256 MiB RAM + disk TieredCache and
              through a 32 MiB RAM tier that spills, each warm epoch
              reading 0 source bytes and equal to the cold one;
              the signed stub read with the registered SigV4Signer, and a
              typed SourceError (http_403) without it; a small CRC'd file
              with a corrupt chunk (a flipped byte; a lying footer size)
              under on_error "skip" / "null" (groups and quarantine counts;
              read_row_group_device raises),
              max_memory raising AllocError on the host and device reads,
              testing/faults' seed-7 cases on both rungs; compact_levels=True on
              sessions, widened equal to the unpacked reads. Range GETs,
              source bytes, cache hits and rows/s of each step are printed
              beside the path read and the card's name and power limit;
     remote   remote writes and the lake (check_remote_lake): (a) taxi's
              device columns through FileWriter(stub URL) to a writable
              RangeHttpStub in a process of its own, with the device
              write's schema and options: the object, read back by one
              GET, equal to the path write's file, one multipart initiate,
              ceil(size / 8 MiB) parts and one commit in io_counts(),
              FileReader(url).read_row_groups_device() equal to the
              generator, and rows/s of the URL write against the path
              write in turns; (b) the same write through ObjectStoreSink
              with a SigV4Signer to a signed stub, committing the same
              bytes, and an unsigned write there refused with
              SinkError(code="http_403"), no object left; (c) a LakeTable
              with taxi's DSL schema and sort key pickup_us, the first
              524,288 rows in 32 interleaved appends through IngestWriter's
              defaults, Compactor.compact_once(): pruned_ratio of a
              pickup_us range and of the compactor's probe must rise; a
              device epoch of ParquetDataset(table) holding the rows'
              multiset, equal to the CPU epoch batch for batch, and an
              epoch pinned to the last generation before compaction
              holding the same multiset (the dataset decodes on the host:
              no kernel launches there); read_row_groups_device() of the
              compacted file holding the rows' values, expand_hybrid and
              dict_gather launched; each step's rows/s beside the card's
              name and power limit;
     serve    the scan daemon (check_serve): the port's
              ScanServer(ServeConfig(root=the smoke directory, port=0,
              device="cuda")) in this process, over loopback HTTP. (a)
              POST /v1/query with the query phase's aggregates, unfiltered
              and under F_taxi, each body byte-equal to render_query_body
              of run_local_query of the same request and equal to NumPy's,
              2 units pruned by statistics, masked_agg, dict_gather and
              (filtered) mask_take launched; shard=[k, 4], k = 0..3, equal
              to NumPy's over groups k and k + 4; group_by vendor_id a
              typed 400 device_declined, counted; (b) 8 client threads x 4
              filtered queries under 4 X-Tenant values, every body equal
              to (a)'s, serve_requests_total with status 200 up by exactly
              32, 0 in flight after; requests/s, median and largest
              latency and input rows/s against one client's sequential
              queries and run_local_query in the same call, and a profiler
              window over one round of 8; (c) POST /v1/scan jsonl of
              trip_id, fare_cents and zone under F_taxi, limit 200,000,
              equal to the first rows of iter_rows(filters=F_taxi) dumped
              with json_default, its chunked stream ended by the 0-chunk,
              no kernel launched; GET /v1/plan equal to POST, groups 6 and
              7 pruned; (d) a daemon with a lake table (TAXI_DSL, sort key
              pickup_us): 8 jsonl appends of 8,192 taxi rows, the last
              with ?flush=1, each ack taking its rows, the last flushed at
              the table's generation; the table's /v1/query on the card
              equal to NumPy's; an arrow-ipc append a typed 415; (e) a
              daemon with tenant_budget_mb=1: one tenant's second full
              query a typed 429 tenant_over_budget, another tenant's
              answered; drain() with a query held in flight by a gated
              source: a new query 503 draining, /healthz 503 with
              retry_after_s, the held query's body equal to (a)'s. Each
              step's figures and the phase's seconds are printed beside
              the card's name and power limit;
     mesh     the serve mesh and the chaos harness (check_mesh): three
              replica ScanServers(device="cuda"), a direct daemon and a
              MeshRouter over the replicas, in this process. (a) /v1/query
              of the query phase's aggregates, unfiltered and under
              F_taxi, scattered over taxi's units, each body byte-equal to
              the direct daemon's and to NumPy's, masked_agg, dict_gather
              and (filtered) mask_take launched by the replicas,
              mesh_counts() in scatter mode; /v1/scan jsonl of trip_id,
              fare_cents and zone under F_taxi narrowed to the trip ids
              around group 1's start (2 units) byte-equal to the direct
              daemon's; /v1/plan equal; (b) a FlakyReplica with
              error_rate=0.2, then one with short_rate=0.5, in front of one
              replica: every body byte-equal to (a)'s, faults injected,
              failovers counted; (c) 8 client threads x 3 filtered queries
              through a router whose replicas sit behind fault-free
              FlakyReplicas, the replica owning most of the query's keys
              closed under them: every answer (a)'s body or a typed 503,
              the dead path's breaker open, /healthz counting it; (d) the
              clients' requests/s, latencies and input rows/s against the
              direct daemon's; (e) run_dataset_chaos over taxi with CUDA
              delivery under standard_schedule(phase_s=1.0) with breakers,
              retries and hedges, the SLO controller attached and detached:
              every batch on the card, each phase's p50, p99 and violation
              share, the controller's state(), units skipped, hedges and
              retries. Every daemon, proxy and router ends with 0 in flight
              and is closed;
  5. times    rows/s of the device reads and of the batch streams, filtered
              and not (the same call, both files), of the filtered read, of
              host decode + upload, of the device write against the host
              write (tensors on the card to a closed file), of host prepare
              alone on the fused and the staged walk, of the query
              (filtered and not) and of column_stats, and each kernel's
              CUDA-event time beside its bound; expand_hybrid also at
              every distinct main-path shape (taxi group 0's four index
              batches, sessions' items group 0) and the six synthetic
              widths, under `shapes` in its kernels entry with the main
              paths' launches at each width; pad_ragged also at a wide edge
              shape (PAD_WIDE: 4,096 rows, max_len 2,500) under `wide`;
              dict_indices also over vendor_id (8 keys) and trip_id (all
              unique), with the main paths' launches by key width;
              mask_take_rows alone at sessions' items padded to [rows, 16]
              int32 under the sessions filter, under `wide`;
              expand_nullable also at 2**22 + 777 rows (past one group of
              its tiles), expand_page_grid also on a grid of many runs
              a page (grid_case at width 3, 16 pages x 2**19),
              rle_hybrid_encode also at trip_distance's page 0 (width 12)
              and bss_transpose also over taxi_mixed fare_amount's whole
              chunk of group 0 (its pages in one launch), each under
              `shapes`; and an A/B of the host library's value functions
              against their Python oracles on row group 0 of the real
              columns, each side's seconds printed and the outputs held
              equal: the PLAIN byte-array gather on taxi's zone dictionary
              page and taxi_mixed's zone PLAIN pages, the page-header parse
              of taxi's row group 0, the hybrid prescan and decode of
              vendor_id, the DELTA decode of pickup_us, the byte-array take
              of zone's dictionary by the group's indices, and on write
              group 0 zone's min/max, dictionary probe (whole and its first
              20,000 rows) and PLAIN encode, trip_distance's numeric probe,
              fare_cents' DELTA encode, passenger_count's def-level hybrid
              encode and XXH64 of 20,000 zone keys; then the one-call A/B of
              the overlap layer ([overlap] lines, OVERLAP_VARIANTS: serial
              prepare with PQT_HOST_THREADS=1, and the pqt-host pool):
              read_row_groups_device of the
              three files and the taxi batch stream, a warm-up and 3 rounds
              each in rotating order, every read bit-equal to the
              generator's columns, host prepare alone on one thread and on
              the pool, os.cpu_count(); and a profiler window of one
              pipelined taxi read (its Chrome trace: each H2D copy's kind
              and stream, which must be Pinned and, for the plans' buffers,
              the dispatch stream; the busy share; the copy time that
              overlaps a kernel).

`python3 chip_smoke.py --ranks N` (N cards) runs only the multi-rank check:
N NCCL ranks spawned through parquet_tpu_torch.testing.dist, one card a
rank, each holding mesh_reduce_stats (per-rank partials, a NaN among
them), distributed_column_stats over taxi's numeric leaves and
sharded_decode_step over trip_distance's real index pages against NumPy;
at N = 4 also the entry point's three steps over a 2 x 2 DeviceMesh and
distributed_column_stats over it. Its last line is the `{"ok": true, ...}`
line with the card count.

The last three lines of standard output are a JSON line of the end-to-end
rates, the host value functions' A/B seconds, the collectives' times, the
overlap A/B, profile and dataset rates, the write-options phase's numbers,
the rows phase's rates and seconds, the io phase's steps, the remote and
lake phase's steps, the serve and mesh phases' numbers, and the card's
name and power limit, the
`kernels` JSON line (21
kernels) and the
`{"ok": true, ...}` line. Without CUDA, or without the package beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

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
# pyarrow's default dictionary_pagesize_limit
DICT_LIMIT = 1 << 20
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


def events_ms(fn, reps: int = 20) -> float:
    """Time per call of `fn` between CUDA events around `reps` eager calls:
    for functions that synchronize inside (no graph can capture them), so
    the host's share is included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def delta_payload(out: tuple) -> tuple:
    """delta_block_encode's (mins, widths, words) cut to what it defines:
    the first sum(widths) words (the kernel leaves the rest unwritten)."""
    mins, widths, words = out
    return mins, widths, words[: int(widths.long().sum())]


# kernels whose outputs are compared on a defined prefix, not whole
HELD_PREFIX = {"delta_block_encode": delta_payload}


def shifted(a: np.ndarray, off: int, dev):
    """`a` on the card as a view `off` elements past the start of its
    allocation (16-byte aligned), so a kernel takes its unaligned path at
    off * itemsize % 16 != 0."""
    import torch

    buf = np.zeros(len(a) + off, dtype=a.dtype)
    buf[off:] = a
    return torch.from_numpy(buf).to(dev)[off:]


# views of (rep, dfl) at these element offsets: list_layout's vector loads
# need both 16-byte aligned
LAYOUT_VIEW_OFFSETS = ((0, 0), (1, 1), (2, 2), (3, 3), (1, 0), (0, 3))


def kernel_counts() -> dict:
    """Launches of each kernel since the last reset_launch_counts,
    expand_hybrid's by bit width (`expand_hybrid_by_width`),
    dict_indices' by key width (`dict_indices_by_width`) and leaf_verdict's
    by kind, gather or validity scan (`leaf_verdict_by_kind`)."""
    from parquet_tpu_torch.kernels import device_ops as ops

    counts = {k: fn.launches for k, fn in ops.KERNELS.items()}
    counts["expand_hybrid_by_width"] = dict(ops.expand_hybrid.launches_by_width)
    counts["dict_indices_by_width"] = dict(ops.dict_indices.launches_by_width)
    counts["leaf_verdict_by_kind"] = dict(ops.leaf_verdict.launches_by_kind)
    return counts


def hold_plain(rows: dict, name: str, label: str, got, plain) -> None:
    """A kernel's outputs against its plain version's on the same inputs, bit
    for bit (bools as bytes): raises on any difference, and folds the max
    abs difference into the kernel's row."""
    import torch

    torch.cuda.synchronize()
    if name in HELD_PREFIX:
        got, plain = HELD_PREFIX[name](got), HELD_PREFIX[name](plain)
    got = got if isinstance(got, tuple) else (got,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    for g, p in zip(got, plain, strict=True):
        if g.dtype == torch.bool:
            g, p = g.view(torch.uint8), p.view(torch.uint8)
        elif g.dtype.is_floating_point and g.dtype == p.dtype:
            # bit patterns: a NaN equals itself, -0.0 differs from +0.0
            bits = {4: torch.int32, 8: torch.int64}[g.element_size()]
            g, p = g.view(bits), p.view(bits)
        ok, err = bits_equal(g, p)
        if not ok:
            log(f"  {name} {label}: equal=False")
            raise AssertionError(f"{name} {label} disagrees with its plain version (max abs {err})")
        rows[name]["max_abs_err"] = max(rows[name].get("max_abs_err", 0.0), err)


def measure_kernel(rows: dict, name: str, fn, plain, nbytes: int, ops_count: int, bw: float,
                   lib=None, lib_events: bool = False, plain_events: bool = False,
                   shape: str = "") -> dict:
    """One kernel at one shape: held against its plain version on the inputs
    it is timed on, then its device time beside its bound, its plain
    version's and the one PyTorch call computing the same function where
    there is one (`lib_events`, `plain_events`: a call that synchronizes
    inside, timed with events)."""
    hold_plain(rows, name, f"[{shape}]", fn(), plain())
    entry = {"ms": device_ms(fn), "plain_ms": events_ms(plain) if plain_events else device_ms(plain),
             "library_ms": None if lib is None else
             (events_ms(lib) if lib_events else device_ms(lib)),
             "eager_ms": eager_ms(fn), "shape": shape}
    bytes_ms = nbytes / bw * 1e3
    ops_ms = ops_count / OPS_PER_S * 1e3
    entry["bound_ms"] = max(bytes_ms, ops_ms)
    entry["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  {name} [{shape}]: equal to its plain version; {entry['ms']:.4f} ms on the device "
        f"(eager call {entry['eager_ms']:.4f} ms), plain {entry['plain_ms']:.4f} ms"
        + (f", library {entry['library_ms']:.4f} ms" if lib is not None else "")
        + f"; bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, {nbytes} B, "
        f"{ops_count} ops); {nbytes / entry['ms'] / 1e6:.1f} GB/s")
    return entry


def record_kernel(rows: dict, name: str, fn, plain, nbytes: int, ops_count: int, bw: float,
                  **kw) -> None:
    """measure_kernel at a main path's shape, into the kernel's row."""
    rows[name].update(measure_kernel(rows, name, fn, plain, nbytes, ops_count, bw, **kw))


def record_shape(rows: dict, name: str, fn, plain, nbytes: int, ops_count: int, bw: float,
                 **kw) -> None:
    """measure_kernel at a shape beside the main one, into the row's `shapes`."""
    rows[name].setdefault("shapes", []).append(
        measure_kernel(rows, name, fn, plain, nbytes, ops_count, bw, **kw))


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
    from parquet_tpu_torch.testing.synth import (
        HYBRID_EDGE_WIDTHS,
        delta_edge_batches,
        hybrid_edge_batches,
        most_runs_a_tile,
    )

    rng = np.random.default_rng(SEED)
    errs = {"expand_hybrid": 0.0, "dict_gather": 0.0, "delta_packed_decode": 0.0}
    for width in HYBRID_EDGE_WIDTHS:
        labels = []
        for label, frozen, want in hybrid_edge_batches(width, ops.HYBRID_TILE, SEED):
            buf = to_device(frozen.buf.view(np.int32), dev)
            got = ops.expand_hybrid(buf, width, frozen.run_pad, frozen.total)
            plain = ops.expand_hybrid_plain(buf, width, frozen.run_pad, frozen.total)
            torch.cuda.synchronize()
            ok, err = bits_equal(got, plain)
            if not (ok and np.array_equal(got.cpu().numpy().view(np.uint32), want * (width > 0))):
                raise AssertionError(f"expand_hybrid width {width} {label} disagrees "
                                     f"(max abs {err})")
            most = most_runs_a_tile(frozen, ops.HYBRID_TILE)
            route = ("table staged whole" if frozen.run_pad <= ops.HYBRID_STAGE_RUNS
                     else "tables in place" if most > ops.HYBRID_STAGE_RUNS
                     else "tile's runs staged")
            labels.append(f"{label} (n={frozen.total}, {frozen.run_pad} run slots, up to {most} "
                          f"runs a tile: {route})")
        log(f"  expand_hybrid width={width:2d} edge batches equal to the plain version and the "
            f"generator: {'; '.join(labels)}")
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
    for nbits in (32, 64):
        labels = []
        for label, frozen, want in delta_edge_batches(nbits, ops.DELTA_TILE, SEED):
            meta32 = to_device(frozen.meta32.view(np.int32), dev)
            wide = to_device(frozen.wide.view(np.int32 if nbits == 32 else np.int64), dev)
            args = (meta32, wide, nbits, frozen.m_pad, frozen.p_pad, frozen.total)
            got = ops.delta_packed_decode(*args)
            plain = ops.delta_packed_decode_plain(*args)
            torch.cuda.synchronize()
            ok, err = bits_equal(got, plain)
            if not (ok and np.array_equal(got.cpu().numpy(), want)):
                raise AssertionError(f"delta_packed_decode {nbits}-bit {label} disagrees "
                                     f"(max abs {err})")
            labels.append(f"{label} (n={frozen.total})")
        log(f"  delta_packed_decode {nbits}-bit edge batches equal to the plain version and "
            f"the generator: {'; '.join(labels)}")
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


def smoke_file(specs, name: str = "taxi") -> Path:
    """A main-path file, built once per seed under the build directory."""
    from parquet_tpu_torch.kernels.build import BUILD_ROOT
    from parquet_tpu_torch.testing.synth import write_file

    # "stats": the files carry chunk statistics (a cached file from before
    # them would prune nothing)
    path = BUILD_ROOT / "smoke" / f"{name}-{SEED}-{ROW_GROUPS}x{RG_ROWS}-stats.parquet"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        write_file(tmp, specs, row_group_rows=RG_ROWS)
        tmp.replace(path)
    return path


def check_main_path(groups, specs, stats, no_host_fallback: bool = True) -> None:
    """Every delivered column equals the generator's arrays."""
    from parquet_tpu_torch.testing.synth import column_values

    for s in specs:
        path = (s.name,)
        cols = [g[path] for g in groups]
        if s.valid is not None:
            defs = np.concatenate([c.def_levels for c in cols])
            if not np.array_equal(defs.astype(bool), s.valid):
                raise AssertionError(f"{s.name}: null positions differ")
        if cols[0].data is not None:
            # a merged byte-array column: (data, offsets) per row group
            want = column_values(s)
            lens = np.concatenate([np.diff(c.offsets.cpu().numpy()) for c in cols])
            data = b"".join(
                c.data[: int(c.offsets[-1])].cpu().numpy().tobytes() for c in cols
            )
            if not (np.array_equal(lens, np.diff(want.offsets)) and data == bytes(want.data)):
                raise AssertionError(f"{s.name}: merged strings differ")
            continue
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
    if no_host_fallback and stats.host_fallback_pages != 0:
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


# -- the third main path: LIST item histories, and the batch path -------------

SESSIONS_VOCAB = 1 << 16
BATCH = 100_000
MAX_LIST_LEN = 16
# pad_ragged's wide edge shape, timed beside the sessions batch's: rows and
# max_len (the width of the edge cases' long rows)
PAD_WIDE = (4096, 2500)


def wide_pad_inputs(dev):
    """(values, lengths) of pad_ragged's wide edge shape: PAD_WIDE[0] rows of
    int32 values, int64 lengths uniform in 0..max_len, from the seed."""
    import torch

    rows, max_len = PAD_WIDE
    rng = np.random.default_rng(SEED + 9)
    lengths = rng.integers(0, max_len + 1, rows)
    values = rng.integers(-(2**31), 2**31, int(lengths.sum()), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(values).to(dev), torch.from_numpy(lengths).to(dev)


def sessions_columns(seed: int):
    """The "sessions" file's columns: ROW_GROUPS * RG_ROWS user sessions,
    each an int64 session id (DELTA) and an optional LIST of required int32
    item ids (RLE_DICTIONARY over a 65,536-key vocabulary): 2 % null lists,
    3 % empty lists, the rest 1..15 items (mean 8), SNAPPY, data page V2."""
    from parquet_tpu_torch.meta.parquet_types import CompressionCodec as C
    from parquet_tpu_torch.meta.parquet_types import Encoding as E
    from parquet_tpu_torch.meta.parquet_types import Type as T
    from parquet_tpu_torch.testing.synth import ColumnSpec

    n = ROW_GROUPS * RG_ROWS
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    valid = u >= 0.02
    lengths = rng.integers(1, 16, size=n)
    lengths[u < 0.05] = 0
    # distinct item ids spread over int32 (a bijection mod the prime 2^31 - 1)
    vocab = (np.arange(SESSIONS_VOCAB, dtype=np.int64) * 2654435761 % (2**31 - 1)).astype(np.int32)
    items = rng.integers(0, SESSIONS_VOCAB, size=int(lengths.sum()), dtype=np.int32)
    sid = 10**9 + np.cumsum(rng.integers(1, 5000, size=n))
    common = dict(codec=C.SNAPPY, page_version=2)
    return [
        ColumnSpec("session_id", T.INT64, values=sid.astype(np.int64),
                   encoding=E.DELTA_BINARY_PACKED, **common),
        ColumnSpec("items", T.INT32, encoding=E.RLE_DICTIONARY, valid=valid, list_lengths=lengths,
                   dictionary=vocab, indices=items, **common),
    ]


def check_sessions(groups, specs, stats, no_host_fallback: bool = True) -> None:
    """The sessions file's columns equal the generator's: session ids, the
    items' values, and their def and rep levels."""
    from parquet_tpu_torch.testing.synth import column_levels, column_values

    sid, items = specs
    got = np.concatenate([g[sid.path].values.cpu().numpy() for g in groups])
    if not np.array_equal(got, sid.values):
        raise AssertionError("session_id: values differ")
    cols = [g[items.path] for g in groups]
    want = column_values(items)
    got = np.concatenate([c.values.cpu().numpy() for c in cols])
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise AssertionError("items: values differ")
    want_def, want_rep = column_levels(items)
    defs = np.concatenate([c.def_levels for c in cols])
    reps = np.concatenate([c.rep_levels for c in cols])
    if not (np.array_equal(defs, want_def) and np.array_equal(reps, want_rep)):
        raise AssertionError("items: levels differ")
    if no_host_fallback and stats.host_fallback_pages != 0:
        raise AssertionError(f"host_fallback_pages = {stats.host_fallback_pages}")


def check_layouts(groups, specs) -> None:
    """DeviceColumn.list_layout(0, 2) and record_starts on every items group
    against the generator: per-row offsets, each row's def level (0 null,
    1 empty, 2 items), the row count and each level entry's row id."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops

    items = specs[1]
    lengths = np.asarray(items.list_lengths, dtype=np.int64)
    first_def = np.where(lengths > 0, 2, np.where(items.valid, 1, 0))
    for g, group in enumerate(groups):
        dc = group[items.path]
        offsets, fdef, n_slots = dc.list_layout(0, 2)
        row_of, n_rows = ops.record_starts(dc._dev_rep)
        torch.cuda.synchronize()
        r0, r1 = g * RG_ROWS, min((g + 1) * RG_ROWS, len(lengths))
        rows = r1 - r0
        want_off = np.zeros(rows + 1, dtype=np.int64)
        np.cumsum(lengths[r0:r1], out=want_off[1:])
        n = dc.num_values
        off = offsets.cpu().numpy()
        if not (int(n_slots) == rows == int(n_rows) and np.array_equal(off[: rows + 1], want_off)
                and (off[rows + 1 :] == want_off[-1]).all()):
            raise AssertionError(f"items group {g}: list_layout offsets differ")
        fd = fdef.cpu().numpy()
        if not (np.array_equal(fd[:rows], first_def[r0:r1]) and not fd[rows:].any()):
            raise AssertionError(f"items group {g}: list_layout first_def differs")
        want_rows = np.repeat(np.arange(rows, dtype=np.int32), np.maximum(lengths[r0:r1], 1))
        if len(want_rows) != n or not np.array_equal(row_of.cpu().numpy(), want_rows):
            raise AssertionError(f"items group {g}: record_starts row ids differ")


def taxi_step(batch, acc) -> None:
    """The taxi batch step on the card: masked sums and row counts, kept on
    the device (no sync per batch)."""
    import torch

    from parquet_tpu_torch.core.reader import MaskedColumn

    pc = batch[("passenger_count",)]
    if not isinstance(pc, MaskedColumn) or batch[("zone",)].dtype != torch.int32:
        raise AssertionError("taxi batch: passenger_count is not a MaskedColumn or zone "
                             "not int32 indices")
    acc["rows"] += batch[("trip_id",)].shape[0]
    acc["trip_id"] += batch[("trip_id",)].sum()
    acc["fare_cents"] += batch[("fare_cents",)].sum(dtype=torch.int64)
    acc["passengers"] += torch.where(pc.mask, pc.values, 0).sum(dtype=torch.int64)
    acc["valid"] += pc.mask.sum()
    acc["zone"] += batch[("zone",)].sum(dtype=torch.int64)


def taxi_totals(specs) -> dict:
    s = {sp.name: sp for sp in specs}
    return {
        "rows": len(s["trip_id"].values),
        "trip_id": int(s["trip_id"].values.sum()),
        "fare_cents": int(s["fare_cents"].values.astype(np.int64).sum()),
        "passengers": int(s["passenger_count"].indices.astype(np.int64).sum()),
        "valid": int(s["passenger_count"].valid.sum()),
        "zone": int(s["zone"].indices.astype(np.int64).sum()),
    }


def sessions_step(batch, acc) -> None:
    """The sessions batch step on the card: the masked sum of the padded
    items, the sum of every padded slot (zero past each row's length), the
    element and row counts."""
    import torch

    from parquet_tpu_torch.core.reader import RaggedColumn

    col = batch[("items", "list", "element")]
    if not isinstance(col, RaggedColumn) or col.values.shape[1] != MAX_LIST_LEN:
        raise AssertionError("sessions batch: items is not a padded RaggedColumn")
    width = col.values.shape[1]
    mask = torch.arange(width, device=col.values.device)[None, :] < col.lengths[:, None]
    acc["rows"] += col.values.shape[0]
    acc["items"] += torch.where(mask, col.values, 0).sum(dtype=torch.int64)
    acc["padded"] += col.values.sum(dtype=torch.int64)
    acc["elements"] += col.lengths.sum()
    acc["session_id"] += batch[("session_id",)].sum()


def sessions_totals(specs) -> dict:
    from parquet_tpu_torch.testing.synth import column_values

    sid, items = specs
    total = int(column_values(items).astype(np.int64).sum())
    return {"rows": len(sid.values), "items": total, "padded": total,
            "elements": int(np.asarray(items.list_lengths).sum()),
            "session_id": int(sid.values.sum())}


def run_batches(path, kwargs, step) -> tuple[dict, int]:
    """Stream a file through iter_device_batches and the step; returns the
    step's totals (synchronized) and the batch count."""
    import torch

    from parquet_tpu_torch.core.reader import FileReader

    acc: dict = collections.defaultdict(int)
    n = 0
    with FileReader(path) as r:
        for batch in r.iter_device_batches(BATCH, drop_remainder=False, **kwargs):
            step(batch, acc)
            n += 1
    torch.cuda.synchronize()
    return {k: int(v) for k, v in acc.items()}, n


# -- the second main path: pyarrow's default writer shape ----------------------


def mixed_columns(seed: int):
    """The "taxi_mixed" file's columns, as pyarrow's default writer would
    lay them out: SNAPPY, data page V1, every dictionary falling back to
    PLAIN pages once its page passes DICT_LIMIT (dictionary_pagesize_limit).
    trip_id and pickup_us (unique and near-unique int64) and zone (100,000
    strings) become mixed chunks; trip_distance is a mixed DOUBLE chunk (the
    host merge); fare_amount is FLOAT BYTE_STREAM_SPLIT; vendor_id and
    passenger_count stay pure dictionary chunks."""
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
    pickup_dict, pickup_idx = np.unique(pickup.astype(np.int64), return_inverse=True)
    fare = np.round(rng.gamma(2.0, 9.0, size=n), 2).astype(np.float32)
    dist = np.round(rng.gamma(1.5, 2.5, size=n), 6)
    dist_dict, dist_idx = np.unique(dist, return_inverse=True)
    zones = ByteArrayData.from_list(
        [f"zone-{i:06d}-{'abcdefgh'[i % 8] * (i % 11)}".encode() for i in range(100_000)]
    )
    common = dict(codec=C.SNAPPY, page_version=1, dict_fallback_bytes=DICT_LIMIT)
    dict_enc = dict(encoding=E.RLE_DICTIONARY, **common)
    return [
        ColumnSpec("trip_id", T.INT64, dictionary=np.arange(n, dtype=np.int64) + 10**9,
                   indices=np.arange(n, dtype=np.int32), **dict_enc),
        ColumnSpec("vendor_id", T.INT32, dictionary=np.arange(1, 9, dtype=np.int32),
                   indices=vendor, **dict_enc),
        ColumnSpec("passenger_count", T.INT32, valid=valid, dictionary=np.arange(7, dtype=np.int32),
                   indices=passengers.astype(np.int32), **dict_enc),
        ColumnSpec("pickup_us", T.INT64, dictionary=pickup_dict,
                   indices=pickup_idx.astype(np.int32), **dict_enc),
        ColumnSpec("fare_amount", T.FLOAT, values=fare, encoding=E.BYTE_STREAM_SPLIT,
                   codec=C.SNAPPY),
        ColumnSpec("trip_distance", T.DOUBLE, dictionary=dist_dict,
                   indices=dist_idx.astype(np.int32), **dict_enc),
        ColumnSpec("zone", T.BYTE_ARRAY, dictionary=zones, utf8=True,
                   indices=rng.integers(0, 100_000, size=n, dtype=np.int32), **dict_enc),
    ]


def row_group_plans(path, dev, group: int, columns):
    """Dispatched plans of one row group's chunks, by column name."""
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels.pipeline import prepare_chunk_plan

    with FileReader(path, device=dev) as r:
        return {
            p[0]: prepare_chunk_plan(r._window(cc), cc, column).dispatch_device(dev)
            for p, cc, column in r._selected_chunks(group, columns)
        }


def numeric_case(rng, dev, layout, n_dict, itemsize):
    """merge_mixed_numeric arguments for a page layout, a list of ("dict" |
    "plain", rows); out-of-range indices in the first dict page."""
    import torch

    from parquet_tpu_torch.kernels.pipeline import _page_merge_tables

    it = np.int32 if itemsize == 4 else np.int64
    infos, idx, plain = [], [], []
    for kind, r in layout:
        if kind == "dict":
            v = rng.integers(0, n_dict, r).astype(np.int32)
            if not idx and r:
                v[:4] = (-1, n_dict, n_dict + 1, 2**31 - 1)[:r]
            idx.append(v)
            infos.append((r, None, None, "dict", r))
        else:
            pv = rng.integers(-(2**62), 2**62, r).astype(it)
            plain.append(pv)
            infos.append((r, None, None, "values", pv))
    kind, prs, aux, n_rows = _page_merge_tables(infos, lambda p: (len(p), len(p)))
    host = (
        np.concatenate(idx) if idx else np.zeros(0, np.int32),
        rng.integers(-(2**62), 2**62, n_dict).astype(it),
        np.concatenate(plain) if plain else np.zeros(0, it),
        kind, prs, aux,
    )
    return tuple(torch.from_numpy(h).to(dev) for h in host) + (n_rows,)


def bytes_case(rng, dev, layout, n_dict):
    """merge_mixed_bytes arguments for a page layout (as numeric_case)."""
    import torch

    from parquet_tpu_torch.core.arrays import ByteArrayData
    from parquet_tpu_torch.testing.synth import (
        MixedBytesCase,
        mixed_bytes_args,
        out_of_range_indices,
    )

    d = ByteArrayData.from_list([b"z" * int(k) for k in rng.integers(0, 20, n_dict)])
    pages, first = [], True
    for kind, r in layout:
        if kind == "dict":
            v = rng.integers(0, n_dict, r).astype(np.int32)
            if first and r:
                v[:4] = out_of_range_indices(n_dict)[:r]
            first = False
            pages.append(("dict", v))
        else:
            vals = [b"Q" * int(k) for k in rng.integers(0, 40, r)]
            pages.append(("plain", ByteArrayData.from_list(vals)))
    *host, n_rows, bound = mixed_bytes_args(MixedBytesCase("", d, pages))
    return tuple(torch.from_numpy(h).to(dev) for h in host) + (n_rows, bound)


# page layouts of the edge cases: one page, empty pages, one-row pages,
# all-dict and all-PLAIN chunks, and a long mixed chunk
D, P = "dict", "plain"
EDGE_LAYOUTS = {
    "one_page": [(D, 70_000)],
    "empty_pages": [(D, 0), (P, 900), (D, 0), (D, 64), (P, 0)],
    "one_row_pages": [(D, 1), (P, 1), (D, 1), (P, 1)],
    "all_dict": [(D, 3000), (D, 1), (D, 700)],
    "all_plain": [(P, 1500), (P, 1)],
    "mixed": [(D, 3000), (P, 2500), (D, 1), (P, 1), (D, 0), (D, 70_000), (P, 300_000),
              (D, 700_000)],
}


def merged_equal(got, plain) -> tuple[bool, float]:
    """(equal?, max abs err) of merge_mixed_bytes results: offsets, and the
    data up to the last offset (the rest of `data` is unspecified)."""
    (gd, go), (pd, po) = got, plain
    ok_off, err = bits_equal(go, po)
    total = int(po[-1])
    ok_data, err_d = bits_equal(gd[:total], pd[:total])
    return ok_off and ok_data, max(err, err_d)


def check_new_kernels(dev, rows: dict, mixed_path) -> None:
    """bss_transpose, merge_mixed_numeric and merge_mixed_bytes against their
    plain versions on the card: at the taxi_mixed file's first row group's
    shapes and at the edge shapes."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.testing.synth import mixed_bytes_args, mixed_bytes_edge_cases

    errs = {"bss_transpose": 0.0, "merge_mixed_numeric": 0.0, "merge_mixed_bytes": 0.0}

    def hold(name, what, got, plain):
        torch.cuda.synchronize()
        ok, err = merged_equal(got, plain) if isinstance(got, tuple) else bits_equal(got, plain)
        log(f"  {name} {what}: equal={ok}")
        if not ok:
            raise AssertionError(f"{name} {what} disagrees with its plain version (max abs {err})")
        errs[name] = max(errs[name], err)

    plans = row_group_plans(mixed_path, dev, 0, ["fare_amount", "trip_id", "pickup_us", "zone"])
    fare = plans["fare_amount"].dev_bss
    for k, (streams, nv) in enumerate(fare):
        hold("bss_transpose", f"fare_amount page {k} n={nv}",
             ops.bss_transpose(streams, nv), ops.bss_transpose_plain(streams, nv))
    hold("bss_transpose", f"fare_amount chunk, {len(fare)} pages in one launch",
         ops.bss_transpose_pages(fare), ops.bss_transpose_pages_plain(fare))
    check_bss_pages(dev, hold)
    for name in ("trip_id", "pickup_us"):
        args = plans[name]._merge_numeric_args()
        hold("merge_mixed_numeric", f"{name} rows={args[-1]} dict={args[1].numel()} "
             f"plain={args[2].numel()}",
             ops.merge_mixed_numeric(*args), ops.merge_mixed_numeric_plain(*args))
    args = plans["zone"]._merge_bytes_args()
    hold("merge_mixed_bytes", f"zone rows={args[-2]} dict={args[1].numel() - 1} "
         f"pool={args[2].numel()}",
         ops.merge_mixed_bytes(*args), ops.merge_mixed_bytes_plain(*args))
    rng = np.random.default_rng(SEED)
    for n in (0, 1, 1000):
        streams = torch.from_numpy(
            rng.integers(0, 256, (4, max(1024, n)), dtype=np.uint8)).to(dev)
        hold("bss_transpose", f"edge n={n}",
             ops.bss_transpose(streams, n), ops.bss_transpose_plain(streams, n))
    for label, layout in EDGE_LAYOUTS.items():
        for n_dict in (5, 1024, 100_000):
            for itemsize in (4, 8):
                args = numeric_case(rng, dev, layout, n_dict, itemsize)
                hold("merge_mixed_numeric", f"edge {label} dict={n_dict} {itemsize}-byte",
                     ops.merge_mixed_numeric(*args), ops.merge_mixed_numeric_plain(*args))
            args = bytes_case(rng, dev, layout, n_dict)
            hold("merge_mixed_bytes", f"edge {label} dict={n_dict}",
                 ops.merge_mixed_bytes(*args), ops.merge_mixed_bytes_plain(*args))
    for case in mixed_bytes_edge_cases(ops.MERGE_BYTES_TILE, SEED):
        *host, n_rows, bound = mixed_bytes_args(case)
        args = tuple(torch.from_numpy(h).to(dev) for h in host) + (n_rows, bound)
        hold("merge_mixed_bytes", f"edge {case.label} rows={n_rows} bytes<={bound}",
             ops.merge_mixed_bytes(*args), ops.merge_mixed_bytes_plain(*args))
    for name, err in errs.items():
        rows[name]["max_abs_err"] = err


def check_bss_pages(dev, hold) -> None:
    """bss_transpose_pages against its plain version on
    testing/synth.bss_pages_cases (one-page chunks of 0-17 and 1,023-1,025
    values, chunks whose pages start off 4 values, 150 pages: three
    launches' page tables, an unpadded page), each page alone through
    bss_transpose, and one chunk whose streams start 1-3 bytes past a
    4-byte boundary."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.testing.synth import bss_pages_cases

    labels = []
    for label, pages in bss_pages_cases(SEED):
        tp = [(torch.from_numpy(st).to(dev), nv) for st, nv in pages]
        hold("bss_transpose", f"pages: {label}", ops.bss_transpose_pages(tp),
             ops.bss_transpose_pages_plain(tp))
        for st, nv in tp[:8]:
            hold("bss_transpose", f"page of {label}", ops.bss_transpose(st, nv),
                 ops.bss_transpose_plain(st, nv))
        labels.append(label)
    rng = np.random.default_rng(SEED + 15)
    off = []
    for shift, nv in ((1, 1029), (2, 4093), (3, 2)):
        buf = torch.from_numpy(rng.integers(0, 256, 4 * 4096 + shift, dtype=np.uint8)).to(dev)
        off.append((buf[shift:].view(4, 4096), nv))
    hold("bss_transpose", "pages whose streams start 1-3 bytes off 4",
         ops.bss_transpose_pages(off), ops.bss_transpose_pages_plain(off))
    log(f"  bss_transpose_pages equal to the plain version: {'; '.join(labels)}; streams "
        "1-3 bytes off 4")


def batch_kernel_cases(rng, dev):
    """(name, label, args) of the batch path's kernels at edge shapes: n = 0,
    1 and 2**20 + 3; leading non-boundary entries; a stream with no
    boundary; no values; all-null and no-null masks; fewer values than valid
    rows; max_len 1; rows longer than a scan tile; every byte width; int32
    and int64 lengths."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    big = (1 << 20) + 3
    for n, lead in ((0, 0), (1, 0), (1, 1), (1000, 3), (big, 0), (big, 29)):
        rep = rng.integers(0, 3, n).astype(np.int32)
        if n > lead:
            rep[lead] = 0
        rep[:lead] = 1
        dfl = rng.integers(0, 4, n).astype(np.int32)
        yield "record_starts", f"n={n} lead={lead}", (t(rep),)
        for parent_rep, elem_def in ((0, 2), (0, 1), (1, 3)):
            yield ("list_layout", f"n={n} lead={lead} parent_rep={parent_rep} elem_def={elem_def}",
                   (t(rep), t(dfl), parent_rep, elem_def))
    yield ("list_layout", "no boundary, saturated def",
           (t(np.ones(5000, np.int32)), t(np.full(5000, 2**31 - 1, np.int32)), 0, 2))
    dtypes = (np.bool_, np.uint8, np.int32, np.float32, np.int64, np.float64)

    def vals(nv, dt):
        if dt is np.bool_:
            return rng.random(nv) > 0.5
        if np.dtype(dt).kind == "f":
            return rng.standard_normal(nv).astype(dt)
        return rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, nv, dtype=dt, endpoint=True)

    for dt in dtypes:
        name = np.dtype(dt).name
        for rows, max_len, nv_rule in ((0, 4, "fit"), (1, 1, "fit"), (5000, 1, "fit"),
                                       (big, MAX_LIST_LEN, "fit"), (3, 2500, "fit"),
                                       (4000, 8, "over"), (3000, 6, "none")):
            lengths = rng.integers(0, max_len + 1, rows)
            if rows > 10:
                lengths[rows // 2] = -3  # a later row's offset below its elements
            nv = {"fit": max(int(lengths.sum()), 0), "over": rows, "none": 0}[nv_rule]
            for ldt in (np.int32, np.int64):
                yield ("pad_ragged", f"{name} rows={rows} max_len={max_len} nv={nv} "
                       f"lengths {np.dtype(ldt).name}",
                       (t(vals(nv, dt)), t(lengths.astype(ldt)), max_len))
        for n, p, short in ((0, 0.5, 0), (1, 1.0, 0), (1, 0.0, 0), (big, 0.95, 0),
                            (big, 0.0, 0), (big, 1.0, 0), (5000, 0.7, 40), (5000, 0.7, None)):
            mask = rng.random(n) < p
            nv = 0 if short is None else max(int(mask.sum()) - short, 0)
            yield ("expand_nullable", f"{name} n={n} valid={p} nv={nv}", (t(vals(nv, dt)), t(mask)))


def check_batch_kernels(dev, rows: dict) -> None:
    """record_starts, list_layout, pad_ragged and expand_nullable against
    their plain versions on the card, bit for bit, at the edge shapes; then
    pad_ragged on testing/synth.pad_ragged_edge_cases, each with its rows
    and the kernel's tile or span, record_starts on
    testing/synth.record_starts_edge_cases and over 4,097 tiles,
    list_layout on testing/synth.list_layout_edge_cases with rep and dfl
    also as views 1-3 entries off 16 bytes, expand_nullable on
    testing/synth.expand_nullable_edge_cases, and pad_ragged on rows of
    2**27 and 2**31 + 4096 columns."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.testing.synth import (
        expand_nullable_edge_cases,
        list_layout_edge_cases,
        nullable_args,
        pad_ragged_edge_cases,
        pad_ragged_tile_rows,
        pad_ragged_wide,
        record_starts_edge_cases,
    )

    counts = dict.fromkeys(("record_starts", "list_layout", "pad_ragged", "expand_nullable"), 0)
    for name, label, args in batch_kernel_cases(np.random.default_rng(SEED), dev):
        hold_plain(rows, name, label, ops.KERNELS[name](*args),
                   getattr(ops, name + "_plain")(*args))
        counts[name] += 1
    log("  " + ", ".join(f"{k}: {v} shapes equal" for k, v in counts.items()))
    cases = expand_nullable_edge_cases(ops.EXPAND_NULLABLE_TILE, SEED,
                                       ops.EXPAND_NULLABLE_GROUP)
    for case in cases:
        args = nullable_args(case, lambda a: torch.from_numpy(a).to(dev))
        hold_plain(rows, "expand_nullable", case.label, ops.expand_nullable(*args),
                   ops.expand_nullable_plain(*args))
    log(f"  expand_nullable: {len(cases)} edge cases equal to the plain version (sizes around "
        f"its {ops.EXPAND_NULLABLE_TILE}-row tile and {ops.EXPAND_NULLABLE_GROUP}-tile group, "
        "all-valid, all-null and random masks, nv exact, short, zero and long, 1-, 4- and "
        "8-byte values, views off 16 bytes)")
    labels = []
    for case in pad_ragged_edge_cases(SEED):
        args = (torch.from_numpy(case.values).to(dev), torch.from_numpy(case.lengths).to(dev),
                case.max_len)
        hold_plain(rows, "pad_ragged", case.label, ops.pad_ragged(*args),
                   ops.pad_ragged_plain(*args))
        e = case.values.itemsize
        labels.append(f"{case.label} ({len(case.lengths)} rows, "
                      + (f"spans of {ops.PAD_RAGGED_TILE_BYTES} bytes)"
                         if pad_ragged_wide(case.max_len, e) else
                         f"tiles of {pad_ragged_tile_rows(max(case.max_len, 1), e)})"))
    log(f"  pad_ragged edge cases equal to the plain version: {'; '.join(labels)}")
    labels = []
    for label, rep in record_starts_edge_cases(ops.RECORD_STARTS_TILE, SEED):
        r = torch.from_numpy(rep).to(dev)
        hold_plain(rows, "record_starts", label, ops.record_starts(r), ops.record_starts_plain(r))
        labels.append(f"{label} (n={len(rep)})")
    # a look-back over 4,097 tiles
    n = 4097 * ops.RECORD_STARTS_TILE + 5
    r = torch.from_numpy(np.random.default_rng(SEED + 11).integers(0, 3, n, dtype=np.int32)).to(dev)
    hold_plain(rows, "record_starts", "4,097 tiles", ops.record_starts(r),
               ops.record_starts_plain(r))
    labels.append(f"4,097 tiles (n={n})")
    del r
    log(f"  record_starts edge cases equal to the plain version: {'; '.join(labels)}")
    labels = []
    for label, rep, dfl, parent_rep, elem_def in list_layout_edge_cases(ops.LIST_LAYOUT_TILE, SEED):
        for off_r, off_d in LAYOUT_VIEW_OFFSETS:
            r, d = shifted(rep, off_r, dev), shifted(dfl, off_d, dev)
            hold_plain(rows, "list_layout", f"{label}, views at +{off_r}/+{off_d}",
                       ops.list_layout(r, d, parent_rep, elem_def),
                       ops.list_layout_plain(r, d, parent_rep, elem_def))
        labels.append(f"{label} (n={len(rep)})")
    log(f"  list_layout edge cases equal to the plain version, rep/dfl also at +1-+3 entries: "
        f"{'; '.join(labels)}")
    check_pad_giant(dev, rows)


# pad_ragged's rows of 2^27 columns: one row of 128 MiB (uint8), and 17
# rows, one of them full, whose 16-row tile would pass 2^31 elements
PAD_GIANT = 1 << 27


def hold_pad_blocks(rows: dict, label: str, got, values, lengths, max_len: int,
                    block: int = 4) -> None:
    """pad_ragged's output held against pad_ragged_plain block of rows by
    block: each block padded by the plain version behind one leading row
    whose length is the int32 sum of the earlier rows (the plain version's
    offsets then wrap as over the whole), so its index matrix stays small."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops

    n = lengths.numel()
    before = torch.cumsum(lengths, 0, dtype=torch.int32)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        part = lengths[r0:r1]
        if r0:
            part = torch.cat([before[r0 - 1 : r0].to(lengths.dtype), part])
        plain = ops.pad_ragged_plain(values, part, max_len)[1 if r0 else 0 :]
        hold_plain(rows, "pad_ragged", f"{label}, rows {r0}-{r1 - 1}", got[r0:r1], plain)
        del plain


def check_pad_giant(dev, rows: dict) -> None:
    """pad_ragged on rows of PAD_GIANT columns and on one row of 2**31 +
    4096 (its span kernel), held against the plain version, and the one-row
    case of PAD_GIANT timed beside its bound."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    one = torch.tensor([PAD_GIANT - 5], dtype=torch.int64, device=dev)
    values = torch.randint(0, 256, (PAD_GIANT - 5,), dtype=torch.uint8, device=dev, generator=gen)
    got = ops.pad_ragged(values, one, PAD_GIANT)
    hold_pad_blocks(rows, "one row of 2**27 uint8", got, values, one, PAD_GIANT)
    del got
    # bytes: the length, the values read and the row written
    g_bytes = 8 + values.numel() + PAD_GIANT
    giant = {"shape": f"one row, max_len={PAD_GIANT} uint8, nv={values.numel()}",
             "ms": device_ms(lambda: ops.pad_ragged(values, one, PAD_GIANT), reps=5),
             "bound_ms": max(g_bytes / mem_bandwidth(torch.cuda.get_device_name(0)),
                             10 * PAD_GIANT / OPS_PER_S) * 1e3}
    rows["pad_ragged"]["giant"] = giant
    lengths = np.random.default_rng(SEED + 13).integers(0, 1000, 17).astype(np.int32)
    lengths[7] = PAD_GIANT
    lengths = torch.from_numpy(lengths).to(dev)
    values = torch.randint(0, 256, (int(lengths.sum()),), dtype=torch.uint8, device=dev,
                           generator=gen)
    got = ops.pad_ragged(values, lengths, PAD_GIANT)
    hold_pad_blocks(rows, "17 rows of 2**27 uint8, one full", got, values, lengths, PAD_GIANT)
    del got, values
    torch.cuda.empty_cache()
    # one row of 2**31 + 4096 columns (an int64 length): max_len reaches the
    # kernel whole, and the columns past 2**31 - 1 enter as the reference's
    # int32 arange gives them, wrapping (kept, reading values[0]); the plain
    # version's index matrices take about 42 GiB of the card
    huge = (1 << 31) + 4096
    one = torch.tensor([huge - 3], dtype=torch.int64, device=dev)
    values = torch.randint(0, 256, (1 << 20,), dtype=torch.uint8, device=dev, generator=gen)
    got = ops.pad_ragged(values, one, huge)
    hold_pad_blocks(rows, "one row of 2**31 + 4096 uint8", got, values, one, huge)
    del got, values
    torch.cuda.empty_cache()
    log(f"  pad_ragged at max_len 2**27 equal to the plain version (one row; 17 rows, one "
        f"full), and at max_len 2**31 + 4096 (one row); one row of 2**27 {giant['ms']:.4f} ms, "
        f"bound {giant['bound_ms']:.4f} ms")


# expand_nullable's timed shape past one group of its tiles
NULLABLE_BIG = (1 << 22) + 777


def time_batch_kernels(sessions_path, taxi_path, dev, rows: dict, bw: float) -> None:
    """Device times of the batch path's kernels at the main path's shapes:
    record_starts and list_layout on the sessions file's first items group,
    pad_ragged on that group's values and lengths (as iter_device_batches
    calls it), expand_nullable on the taxi file's first passenger_count
    group; each held against its plain version on the inputs it is timed
    on, then timed beside its bound, its plain version and the one PyTorch
    call computing the same function where there is one; expand_nullable
    also at NULLABLE_BIG rows, past one group of its tiles."""
    import torch

    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import to_device

    with FileReader(sessions_path) as r:
        dc = r.read_row_group_device(0, ["items"])[("items", "list", "element")]
    with FileReader(taxi_path) as r:
        pc = r.read_row_group_device(0, ["passenger_count"])[("passenger_count",)]
    rep = to_device(np.asarray(dc.rep_levels, np.int32), dev)
    dfl = to_device(np.asarray(dc.def_levels, np.int32), dev)
    n = rep.numel()
    rl = np.asarray(dc.rep_levels)
    present = (np.asarray(dc.def_levels) == 2).astype(np.int32)
    lengths_np = np.add.reduceat(present, np.nonzero(rl == 0)[0])
    lengths = to_device(lengths_np, dev)
    values = dc.values
    n_rows = lengths.numel()
    mask = to_device(np.asarray(pc.def_levels) == 1, dev)
    pvals = pc.values

    def record(name, fn, plain, nbytes, ops_count, lib=None, shape=""):
        record_kernel(rows, name, fn, plain, nbytes, ops_count, bw, lib=lib, shape=shape)

    # bytes: rep read, row_of written (4 B each) and the 8-byte count; ops:
    # compare, scan and subtract, ~6 per entry
    record("record_starts", lambda: ops.record_starts(rep), lambda: ops.record_starts_plain(rep),
           8 * n + 8, 6 * n, lib=lambda: torch.cumsum(rep == 0, 0, dtype=torch.int32),
           shape=f"sessions items group 0, n={n}")
    # bytes: rep and dfl read, offsets and first_def written; ops: two
    # compares, the packed scan and the scatter, ~20 per entry
    record("list_layout", lambda: ops.list_layout(rep, dfl, 0, 2),
           lambda: ops.list_layout_plain(rep, dfl, 0, 2),
           8 * n + 4 * (n + 1) + 4 * n + 8, 20 * n, shape=f"sessions items group 0, n={n}")
    nv = values.numel()
    offs = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    offs[1:] = torch.from_numpy(np.cumsum(lengths_np)).to(dev)
    nested = torch.nested.nested_tensor_from_jagged(values, offsets=offs)
    # bytes: lengths and the elements read once, the padded matrix written;
    # ops: index, compare, clamp and address, ~10 per output slot
    record("pad_ragged", lambda: ops.pad_ragged(values, lengths, MAX_LIST_LEN),
           lambda: ops.pad_ragged_plain(values, lengths, MAX_LIST_LEN),
           lengths.element_size() * n_rows + 4 * nv + 4 * n_rows * MAX_LIST_LEN,
           10 * n_rows * MAX_LIST_LEN,
           lib=lambda: nested.to_padded_tensor(0, output_size=(n_rows, MAX_LIST_LEN)),
           shape=f"sessions items group 0, rows={n_rows} nv={nv} max_len={MAX_LIST_LEN}")
    # the wide edge shape: the same bytes and operations, beside the same
    # library call
    wv, wl = wide_pad_inputs(dev)
    w_rows, w_len = PAD_WIDE
    w_nv = wv.numel()
    w_offs = torch.zeros(w_rows + 1, dtype=torch.int64, device=dev)
    w_offs[1:] = torch.cumsum(wl, 0)
    w_nested = torch.nested.nested_tensor_from_jagged(wv, offsets=w_offs)
    w_shape = f"wide edge, rows={w_rows} nv={w_nv} max_len={w_len}, int64 lengths"
    hold_plain(rows, "pad_ragged", f"[{w_shape}]", ops.pad_ragged(wv, wl, w_len),
               ops.pad_ragged_plain(wv, wl, w_len))
    w_bytes = 8 * w_rows + 4 * w_nv + 4 * w_rows * w_len
    wide = {"shape": w_shape, "ms": device_ms(lambda: ops.pad_ragged(wv, wl, w_len)),
            "plain_ms": device_ms(lambda: ops.pad_ragged_plain(wv, wl, w_len)),
            "library_ms": device_ms(
                lambda: w_nested.to_padded_tensor(0, output_size=(w_rows, w_len))),
            "bound_ms": max(w_bytes / bw, 10 * w_rows * w_len / OPS_PER_S) * 1e3,
            "bound_by": "bytes" if w_bytes / bw >= 10 * w_rows * w_len / OPS_PER_S
            else "operations"}
    rows["pad_ragged"]["wide"] = wide
    log(f"  pad_ragged [{w_shape}]: equal to its plain version; {wide['ms']:.4f} ms on the "
        f"device, plain {wide['plain_ms']:.4f} ms, library {wide['library_ms']:.4f} ms; bound "
        f"{wide['bound_ms']:.4f} ms ({wide['bound_by']}, {w_bytes} B)")
    m = mask.numel()
    # bytes: the mask, the non-null values and the output; ops: scan,
    # clamp, select, ~8 per row
    record("expand_nullable", lambda: ops.expand_nullable(pvals, mask),
           lambda: ops.expand_nullable_plain(pvals, mask),
           m + 4 * pvals.numel() + 4 * m, 8 * m,
           lib=lambda: torch.zeros(m, dtype=pvals.dtype, device=dev).masked_scatter_(mask, pvals),
           shape=f"taxi passenger_count group 0, n={m} nv={pvals.numel()}")
    # past one group of tiles: the counts of groups between the two launches
    rng = np.random.default_rng(SEED + 14)
    bm = to_device(rng.random(NULLABLE_BIG) < 0.95, dev)
    bv = to_device(rng.integers(0, 7, int(bm.sum()), dtype=np.int32), dev)
    record_shape(rows, "expand_nullable", lambda: ops.expand_nullable(bv, bm),
                 lambda: ops.expand_nullable_plain(bv, bm),
                 NULLABLE_BIG + 4 * bv.numel() + 4 * NULLABLE_BIG, 8 * NULLABLE_BIG, bw,
                 lib=lambda: torch.zeros(NULLABLE_BIG, dtype=bv.dtype, device=dev)
                 .masked_scatter_(bm, bv),
                 shape=f"random 95 % valid, n={NULLABLE_BIG} nv={bv.numel()} int32")


# -- the filter path: predicates, LIST contains, verdicts, compaction ----------

FILTER_KERNELS = ("predicate_mask", "leaf_verdict", "list_contains_mask", "mask_take")
PRED_DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint32, np.uint64, np.float32,
               np.float64, np.bool_)


def pred_values(rng, dt, n: int):
    """n values of a predicate_mask column: bools, normal floats with a NaN
    every 97th, or integers over the dtype's whole range."""
    if dt is np.bool_:
        return rng.random(n) > 0.5
    if np.dtype(dt).kind == "f":
        v = rng.standard_normal(n).astype(dt)
        v[::97] = np.nan
        return v
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


def filter_kernel_cases(rng, dev):
    """(name, label, args, kwargs) of the filter kernels at edge shapes: every
    value dtype and op, exact and inexact brackets, NaN brackets, unsigned
    patterns above 2**31 / 2**63 and sub-width masks, bools, in-lists up to
    64 members, at n = 0, 1, 15, 16, 17, one block's work (predicate_block)
    - 1 and + 1 and 2**20 + 3, and every dtype at starts 1-15 elements off
    the kernel's 16-byte loads; FIXED_LEN_BYTE_ARRAY rows (==, != and
    in-lists, width 0, patterns of another width, no members); verdicts
    with and without indices (out-of-range ones) and validity, nd = 0; LIST
    streams opening mid-record, nv = 0, null and empty lists; compaction
    with count above out_pad, n = 0, 2-D and misaligned rows; n = 0, 1 and
    2**20 + 3."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    big = (1 << 20) + 3
    for dt in PRED_DTYPES:
        name = np.dtype(dt).name
        block = ops.predicate_block(np.dtype(np.int8 if dt is np.bool_ else dt).itemsize)
        unsigned = np.dtype(dt).kind == "u"
        kw = {"unsigned": True} if unsigned else {}

        def upload(v):
            return t(v.view({np.uint32: np.int32, np.uint64: np.int64}[dt]) if unsigned else v)

        for n in (0, 1, 15, 16, 17, block - 1, block + 1, big):
            v = pred_values(rng, dt, n)
            tv = upload(v)
            if dt is np.bool_:
                brackets = ((0, 0, True), (1, 1, True), (0, 1, False))
            elif np.dtype(dt).kind == "f":
                x = float(v[0]) if n else 0.25
                x32 = float(np.float32(x))
                brackets = ((x, x, True), (x32, float(np.nextafter(np.float32(x32), np.float32(1))),
                                           False), (float("nan"), float("nan"), False))
            else:
                info = np.iinfo(dt)
                x = int(v[0]) if n else 0
                brackets = ((x, x, True), (x, min(x + 1, int(info.max)), False),
                            (int(info.max), int(info.max), True))
                if unsigned:
                    top = 1 << (8 * np.dtype(dt).itemsize - 1)
                    brackets += ((top + 3, top + 3, True),)
            for lo, hi, exact in brackets:
                for op in ("==", "!=", "<", "<=", ">", ">="):
                    yield ("predicate_mask", f"{name} n={n} {op} ({lo}, {hi}, {exact})",
                           (tv, op, lo, hi, exact), kw)
            mem = [b[0] for b in brackets] + ([int(x) for x in v[1:62]] if n > 62 and
                                              np.dtype(dt).kind in "iu" else [])
            for op in ("in", "not_in"):
                yield ("predicate_mask", f"{name} n={n} {op} {len(mem)} members",
                       (tv, op), dict(kw, members=mem[:64]))
            if dt is np.uint32:
                yield ("predicate_mask", f"uint32 n={n} < 2**15, 16-bit view",
                       (tv, "<", 1 << 15, 1 << 15), dict(kw, bits=16))
        # starts 1-15 elements into a column: loads off the 16-byte alignment
        # (the element path; even offsets of 8-byte values stay aligned)
        v = pred_values(rng, dt, block + 16)
        tb = upload(v)
        for off in range(1, 16):
            x = v[off].item()
            x = float(x) if np.dtype(dt).kind == "f" else int(x)
            for n in (17, block + 1):
                tv = tb[off : off + n]
                label = f"{name} n={n} at element offset {off}"
                yield "predicate_mask", f"{label} >= {x}", (tv, ">=", x, x), kw
                yield "predicate_mask", f"{label} == {x}", (tv, "==", x, x, True), kw
                yield "predicate_mask", f"{label} in", (tv, "in"), dict(kw, members=[x, 0, 1])
    for dt in (np.int8, np.int32, np.int64, np.float64):
        base = t(rng.integers(-9, 9, 4099).astype(dt))
        for off in (1, 2, 3):  # values off the kernel's 16-byte loads
            label = f"{np.dtype(dt).name} values at element offset {off}"
            yield "predicate_mask", f"{label} >= 0", (base[off:], ">=", 0, 0), {}
            yield "predicate_mask", f"{label} in", (base[off:], "in"), {"members": [1, -3, 7]}
    for n, w in ((0, 4), (1, 16), (big, 12), (5000, 1), (7, 0)):
        rows = rng.integers(0, 2, (n, w), dtype=np.uint8)
        pat = bytes(rows[0]) if n else bytes(w)
        for op in ("==", "!="):
            yield "predicate_mask", f"FLBA n={n} w={w} {op}", (t(rows), op, pat), {}
            yield ("predicate_mask", f"FLBA n={n} w={w} {op} a pattern of width {w + 1}",
                   (t(rows), op, bytes(w + 1)), {})
        # in-lists up to 64 members, one of another width; and none
        mem = [bytes(r) for r in rows[1:64]] + [bytes(w + 1)] if n > 1 else [pat, bytes(w + 1)]
        for op in ("in", "not_in"):
            for m in (mem, []):
                yield ("predicate_mask", f"FLBA n={n} w={w} {op} {len(m)} members",
                       (t(rows), op), {"members": m})
    for n, p, n_dict in ((0, 0.5, 5), (1, 1.0, 1), (1, 0.0, 3), (big, 0.95, 100_000),
                         (big, 1.0, 7), (big, 0.0, 9), (5000, 0.5, 0)):
        valid = rng.random(n) < p
        nd = int(valid.sum())
        if n_dict == 0:  # a dense verdict
            verdict, idx = t(rng.random(nd) > 0.5), None
        else:
            ix = rng.integers(0, n_dict, nd).astype(np.int32)
            if nd >= 3:
                ix[:3] = (-1, n_dict + 4, -n_dict - 9)
            verdict, idx = t((rng.random(n_dict) > 0.5).view(np.uint8)), t(ix)
        for fill in (False, True):
            yield ("leaf_verdict", f"n={n} valid={p} n_dict={n_dict} fill={fill}",
                   (verdict, idx, t(valid), fill), {})
        if idx is not None:
            yield "leaf_verdict", f"nd={nd} n_dict={n_dict} no validity", (verdict, idx), {}
    for n, lead, nv_rule in ((1, 0, "fit"), (7, 0, "none"), (1000, 3, "fit"), (big, 0, "fit"),
                             (big, 17, "over"), (5000, 0, "none")):
        rep = rng.integers(0, 2, n).astype(np.int32)
        rep[lead:][:1] = 0
        rep[:lead] = 1
        dfl = rng.integers(0, 3, n).astype(np.int32)  # 0 null list, 1 empty list
        nv = {"fit": int((dfl == 2).sum()), "over": int((dfl == 2).sum()) + 50, "none": 0}[nv_rule]
        yield ("list_contains_mask", f"n={n} lead={lead} nv={nv}",
               (t(rep), t(dfl), t(rng.random(nv) > 0.7), 2), {})
    yield ("list_contains_mask", "no def stream (saturated)",
           (t(np.zeros(3000, np.int32)), t(np.full(3000, 2**31 - 1, np.int32)),
            t(rng.random(3000) > 0.5), 2**31 - 1), {})
    for n, p, out_pad in ((0, 0.5, 4), (1, 1.0, 1), (1, 0.0, 3), (big, 0.3, big),
                          (big, 0.9, 1000), (big, 0.0, 16), (5000, 1.0, 5000)):
        mask = t(rng.random(n) < p)
        for label, vals in (("int32", t(rng.integers(-9, 9, n).astype(np.int32))),
                            ("int64", t(rng.integers(-9, 9, n).astype(np.int64))),
                            ("bool", t(rng.random(n) > 0.5)),
                            ("int32[n, 16]", t(rng.integers(0, 99, (n, 16)).astype(np.int32)))):
            yield "mask_take", f"{label} n={n} p={p} out_pad={out_pad}", (vals, mask, out_pad), {}
    odd = t(rng.integers(0, 99, 4097).astype(np.int32))[1:]  # 4-byte aligned, not 8
    yield ("mask_take", "misaligned int32 rows", (odd.view(-1, 2), t(rng.random(2048) > 0.5), 2048),
           {})


def check_filter_kernels(dev, rows: dict) -> None:
    """The filter kernels against their plain versions on the card, bit for
    bit, at the edge shapes, list_contains_mask and leaf_verdict also on
    views whose start is off 16 bytes."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import to_device
    from parquet_tpu_torch.testing.synth import (
        leaf_verdict_edge_cases,
        list_contains_edge_cases,
        mask_take_args,
        mask_take_edge_cases,
    )

    counts = dict.fromkeys(FILTER_KERNELS, 0)
    for name, label, args, kw in filter_kernel_cases(np.random.default_rng(SEED + 4), dev):
        hold_plain(rows, name, label, ops.KERNELS[name](*args, **kw),
                   getattr(ops, name + "_plain")(*args, **kw))
        counts[name] += 1
    log("  " + ", ".join(f"{k}: {v} shapes equal" for k, v in counts.items()))
    labels = []
    for case in mask_take_edge_cases(ops.MASK_TAKE_TILE, ops.MASK_TAKE_BLOCKS, SEED):
        v, m, out_pad = mask_take_args(case, lambda a: to_device(a, dev))
        plain = ops.mask_take_plain(v, m, out_pad)
        hold_plain(rows, "mask_take", case.label, ops.mask_take(v, m, out_pad), plain)
        src, count = ops.mask_take_scan(m, out_pad)
        hold_plain(rows, "mask_take", f"{case.label} (scan + rows)",
                   (ops.mask_take_rows(v, src, count, out_pad), count), plain)
        labels.append(f"{case.label} (n={len(m)}, out_pad={out_pad})")
    log(f"  mask_take edge cases equal to the plain version, fused and in two calls: "
        f"{'; '.join(labels)}")
    labels = []
    for label, rep, dfl, dm, elem_def in list_contains_edge_cases(ops.LIST_CONTAINS_TILE, SEED):
        m = torch.from_numpy(dm).to(dev)
        for off_r, off_d in LAYOUT_VIEW_OFFSETS:
            r, d = shifted(rep, off_r, dev), shifted(dfl, off_d, dev)
            hold_plain(rows, "list_contains_mask", f"{label}, views at +{off_r}/+{off_d}",
                       ops.list_contains_mask(r, d, m, elem_def),
                       ops.list_contains_mask_plain(r, d, m, elem_def))
        labels.append(f"{label} (n={len(rep)}, nv={len(dm)})")
    log(f"  list_contains_mask edge cases equal to the plain version, rep/dfl also at +1-+3 "
        f"entries: {'; '.join(labels)}")
    labels = []
    for label, verdict, idx, valid, fill in leaf_verdict_edge_cases(
            ops.LEAF_VERDICT_TILE, SEED, ops.LEAF_VERDICT_GROUP):
        # the indices 1-3 elements and the validity 1-15 bytes off 16 bytes
        for off_i, off_v in ((0, 0), (1, 1), (2, 7), (3, 15)):
            v = shifted(verdict, off_i, dev) if idx is None else torch.from_numpy(verdict).to(dev)
            ix = None if idx is None else shifted(idx, off_i, dev)
            va = None if valid is None else shifted(valid, off_v, dev)
            hold_plain(rows, "leaf_verdict", f"{label}, views at +{off_i}/+{off_v}",
                       ops.leaf_verdict(v, ix, va, fill), ops.leaf_verdict_plain(v, ix, va, fill))
        labels.append(label)
    log(f"  leaf_verdict edge cases equal to the plain version, indices (or a dense verdict) "
        f"at +1-+3 entries, validity at +1-+15 bytes: {'; '.join(labels)}")


def taxi_filter(specs):
    """F_taxi, a DNF of two conjunctions over the taxi file, and the
    generator's row mask under it. T is the smallest pickup_us of row group
    6, so statistics prune groups 6 and 7 under both conjunctions."""
    s = {sp.name: sp for sp in specs}
    pickup = s["pickup_us"].values
    t_cut = int(pickup[6 * RG_ROWS : 7 * RG_ROWS].min())
    zone_ids = [(k * 8191) % 100_000 for k in range(12)]
    zones = [s["zone"].dictionary[k].decode() for k in zone_ids]
    filters = [
        [("pickup_us", "<", t_cut), ("fare_cents", ">=", 1500), ("passenger_count", ">=", 2)],
        [("zone", "in", zones), ("pickup_us", "<", t_cut)],
    ]
    valid = s["passenger_count"].valid
    pc = np.zeros(len(valid), np.int64)
    pc[valid] = s["passenger_count"].indices  # the dictionary is 0..6
    early = pickup < t_cut
    keep = (early & (s["fare_cents"].values >= 1500) & valid & (pc >= 2)) | (
        early & np.isin(s["zone"].indices, zone_ids))
    return filters, keep


def taxi_filtered_totals(specs, keep) -> dict:
    s = {sp.name: sp for sp in specs}
    valid = s["passenger_count"].valid
    pc = np.zeros(len(valid), np.int64)
    pc[valid] = s["passenger_count"].indices
    return {
        "rows": int(keep.sum()),
        "trip_id": int(s["trip_id"].values[keep].sum()),
        "fare_cents": int(s["fare_cents"].values[keep].astype(np.int64).sum()),
        "passengers": int(pc[keep].sum()),
        "valid": int((keep & valid).sum()),
        "zone": int(s["zone"].indices[keep].astype(np.int64).sum()),
    }


def sessions_filter(specs):
    """The sessions filter (contains the most frequent item K, and a session
    id below S, the smallest of row group 6: the ids rise strictly, so
    statistics prune groups 6 and 7), the generator's row mask under it,
    and its step totals."""
    from parquet_tpu_torch.testing.synth import column_values

    sid, items = specs
    vals = np.asarray(column_values(items))
    k_item = int(items.dictionary[np.bincount(items.indices).argmax()])
    s_cut = int(sid.values[6 * RG_ROWS])
    lengths = np.asarray(items.list_lengths, dtype=np.int64)
    row_of = np.repeat(np.arange(len(lengths)), lengths)
    keep = np.zeros(len(lengths), bool)
    keep[row_of[vals == k_item]] = True
    keep &= sid.values < s_cut
    elem_keep = keep[row_of]
    total = int(vals[elem_keep].astype(np.int64).sum())
    totals = {"rows": int(keep.sum()), "items": total, "padded": total,
              "elements": int(lengths[keep].sum()),
              "session_id": int(sid.values[keep].sum())}
    return [("items", "contains", k_item), ("session_id", "<", s_cut)], keep, totals


def filtered_read(path, filters, dev) -> tuple[int, int]:
    """read_row_group_device(i, ["fare_cents"], filters=) on every group,
    then mask_take of fare_cents under the mask, summed on the card:
    (kept rows, fare sum)."""
    import torch

    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels import device_ops as ops

    kept = torch.zeros((), dtype=torch.int64, device=dev)
    fare = torch.zeros((), dtype=torch.int64, device=dev)
    with FileReader(path) as r:
        for i in range(r.num_row_groups):
            cols, mask = r.read_row_group_device(i, ["fare_cents"], filters=filters)
            n = mask.numel()
            taken, count = ops.mask_take(cols[("fare_cents",)].values, mask, n)
            live = torch.arange(n, device=dev) < count
            fare += torch.where(live, taken, 0).sum(dtype=torch.int64)
            kept += count
    return int(kept), int(fare)


def time_filter_kernels(taxi_path, sessions_path, taxi_filters, sessions_filters, dev,
                        rows: dict, bw: float) -> None:
    """Device times of the filter kernels at the main paths' shapes:
    predicate_mask on taxi's first fare_cents group, leaf_verdict on its zone
    indices (an in-list verdict over the 100,000-entry dictionary) and on
    its passenger_count validity, list_contains_mask on sessions' first
    items group, mask_take of taxi's first fare_cents group under F_taxi's
    mask, and mask_take_rows alone of sessions' first items group padded to
    [rows, 16] int32 under the sessions filter's mask (under `wide`); each
    held against its plain version on the inputs it is timed on,
    then timed beside its bound, its plain version and the one PyTorch call
    computing the same function where there is one."""
    import torch

    from parquet_tpu_torch.core.filter_vec import _member_mask
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import to_device

    with FileReader(taxi_path) as r:
        _cols, fmask = r.read_row_group_device(0, ["fare_cents", "zone", "passenger_count"],
                                               filters=taxi_filters)
        leaf = r.schema.column(("zone",))
    fare = _cols[("fare_cents",)].values
    zone = _cols[("zone",)]
    pc = _cols[("passenger_count",)]
    with FileReader(sessions_path) as r:
        dc = r.read_row_group_device(0, ["items"])[("items", "list", "element")]
        _scols, smask = r.read_row_group_device(0, ["items", "session_id"],
                                                filters=sessions_filters)
    k_item = sessions_filters[0][2]
    rep, dfl = dc.level_tensors()
    members = [z.encode() for z in taxi_filters[1][0][2]]
    zverdict = to_device(_member_mask(zone.dictionary, leaf, members, (("zone",), {}))
                         .view(np.uint8), dev)
    zverdict_b = zverdict.view(torch.bool)
    zidx = zone.indices
    valid = to_device(np.asarray(pc.def_levels) == 1, dev)
    pverdict = ops.predicate_mask(pc.values, ">=", 2, 2)
    dm = ops.predicate_mask(dc.values, "==", k_item, k_item)
    n_f, n_z, n_v, n_l = fare.numel(), zidx.numel(), valid.numel(), rep.numel()
    kept = int(fmask.sum())

    def record(name, fn, plain, nbytes, ops_count, lib=None, lib_events=False, shape=""):
        record_kernel(rows, name, fn, plain, nbytes, ops_count, bw, lib=lib,
                      lib_events=lib_events, shape=shape)

    # bytes: the values read, the mask written; ops: load, compare, store, ~3
    record("predicate_mask", lambda: ops.predicate_mask(fare, ">=", 1500, 1500),
           lambda: ops.predicate_mask_plain(fare, ">=", 1500, 1500), 5 * n_f, 3 * n_f,
           lib=lambda: fare >= 1500, shape=f"taxi fare_cents group 0, n={n_f} int32")
    # bytes: indices and the verdict read, the mask written; ops: wrap,
    # clamp, gather, ~6 per row
    record("leaf_verdict", lambda: ops.leaf_verdict(zverdict, zidx),
           lambda: ops.leaf_verdict_plain(zverdict, zidx), 4 * n_z + zverdict.numel() + n_z,
           6 * n_z, lib=lambda: zverdict_b[zidx],
           shape=f"taxi zone group 0, n={n_z} indices, {zverdict.numel()}-entry verdict")
    v_shape = f"taxi passenger_count group 0, validity of {n_v} rows, {pverdict.numel()} dense"
    hold_plain(rows, "leaf_verdict", f"[{v_shape}]", ops.leaf_verdict(pverdict, None, valid),
               ops.leaf_verdict_plain(pverdict, None, valid))
    t_v = {"ms": device_ms(lambda: ops.leaf_verdict(pverdict, None, valid)),
           "plain_ms": device_ms(lambda: ops.leaf_verdict_plain(pverdict, None, valid)),
           "library_ms": device_ms(lambda: torch.zeros(n_v, dtype=torch.bool, device=dev)
                                   .masked_scatter_(valid, pverdict)),
           "bound_ms": (2 * n_v + pverdict.numel()) / bw * 1e3}
    rows["leaf_verdict"]["validity"] = t_v
    log(f"  leaf_verdict [{v_shape}]: equal to its plain version; {t_v['ms']:.4f} ms, "
        f"plain {t_v['plain_ms']:.4f} ms, "
        f"library {t_v['library_ms']:.4f} ms; bound {t_v['bound_ms']:.4f} ms (bytes)")
    # bytes: rep and dfl read, the dense mask read, rows written, the count;
    # ops: two compares, the packed scan, two clamps and the store, ~20 per entry
    record("list_contains_mask", lambda: ops.list_contains_mask(rep, dfl, dm, 2),
           lambda: ops.list_contains_mask_plain(rep, dfl, dm, 2),
           8 * n_l + dm.numel() + n_l + 8, 20 * n_l,
           shape=f"sessions items group 0, n={n_l}, nv={dm.numel()}")
    # bytes: the mask read, the kept values read and written, the count;
    # ops: the scan and the placement, ~8 per entry, and ~4 per kept row
    record("mask_take", lambda: ops.mask_take(fare, fmask, kept),
           lambda: ops.mask_take_plain(fare, fmask, kept), n_f + 8 * kept + 8,
           8 * n_f + 4 * kept, lib=lambda: fare[fmask], lib_events=True,
           shape=f"taxi fare_cents group 0 under F_taxi, n={n_f} kept={kept}")
    # the row gather alone at the filtered batch stream's widest leaf, as
    # the reader's _device_filter_rows calls it after one scan of the group:
    # bytes: the kept positions read, the kept 64-byte rows read and
    # written, the count; the library call gathers by the same positions
    rl = np.asarray(dc.rep_levels)
    present = (np.asarray(dc.def_levels) == 2).astype(np.int32)
    lengths = to_device(np.add.reduceat(present, np.nonzero(rl == 0)[0]), dev)
    wide = ops.pad_ragged(dc.values, lengths, MAX_LIST_LEN)
    src, count = ops.mask_take_scan(smask, smask.numel())
    s_kept = int(count)
    w_shape = (f"sessions items group 0 padded to [{wide.shape[0]}, {MAX_LIST_LEN}] int32 under "
               f"the sessions filter, kept={s_kept}, mask_take_rows alone")
    hold_plain(rows, "mask_take", f"[{w_shape}]", ops.mask_take_rows(wide, src, count, s_kept),
               ops.mask_take_rows_plain(wide, src, count, s_kept))
    w_bytes = 4 * s_kept + 2 * wide[0].nbytes * s_kept + 8
    t_w = {"shape": w_shape, "ms": device_ms(lambda: ops.mask_take_rows(wide, src, count, s_kept)),
           "plain_ms": device_ms(lambda: ops.mask_take_rows_plain(wide, src, count, s_kept)),
           "library_ms": device_ms(lambda: torch.index_select(wide, 0, src[:s_kept])),
           "bound_ms": w_bytes / bw * 1e3, "bound_by": "bytes"}
    rows["mask_take"]["wide"] = t_w
    log(f"  mask_take [{w_shape}]: equal to its plain version; {t_w['ms']:.4f} ms, plain "
        f"{t_w['plain_ms']:.4f} ms, library {t_w['library_ms']:.4f} ms (index_select); bound "
        f"{t_w['bound_ms']:.5f} ms (bytes, {w_bytes} B)")


# -- the write path: FileWriter.write_device_column ------------------------------

WRITE_KERNELS = ("bitpack_encode", "rle_hybrid_encode", "dict_indices", "delta_block_encode",
                 "plain_bytearray_encode")
# the write phase's options: pyarrow's default shape (SNAPPY, data page V1,
# 1 MiB pages), a dictionary probed on five columns, DELTA on two
WRITE_DICT = ("trip_id", "vendor_id", "passenger_count", "pickup_us", "trip_distance")
WRITE_DELTA = ("pickup_us", "fare_cents")
EDGE_N = (0, 1, 7, 8, 9, 127, 128, 129, 1000)


def write_kernel_cases(rng, dev):
    """(name, label, args) of the write kernels at edge shapes: n = 0, 1, 7,
    8, 9, 127-129; every bit-pack width 0-32 and DELTA width 1-64; runs
    straddling the 8-alignment and adjacent RLE windows of different runs;
    dictionary keys -1, INT_MIN, NaN payloads and more than 32,767 uniques;
    empty strings and offsets that do not start at 0."""
    from parquet_tpu_torch.kernels.pipeline import to_device

    def t(a):
        return to_device(np.ascontiguousarray(a), dev)

    for n in EDGE_N:
        for w in range(33):
            v = rng.integers(0, 1 << w, n, dtype=np.uint64).astype(np.uint32)
            yield "bitpack_encode", f"n={n} width={w}", (t(v.view(np.int32)), w)
    patterns = {
        "straddling runs": [3, 13, 8, 8, 9, 20, 1, 16, 7, 9, 15, 17],
        "adjacent windows": [16, 16, 8, 24, 8, 8],
        "one run": [1000],
        "short runs": [7] * 40,
    }
    for label, lens in patterns.items():
        v = np.repeat((np.arange(len(lens)) * 3) % 8, lens).astype(np.int32)
        for w in (3, 8, 32):
            yield "rle_hybrid_encode", f"{label} width={w}", (t(v), w)
    for n in EDGE_N + (15, 16, 17, 5000):
        for w in (1, 3, 8, 17, 32):
            v = rng.integers(0, 1 << w, n, dtype=np.uint64).astype(np.uint32)
            yield "rle_hybrid_encode", f"random n={n} width={w}", (t(v.view(np.int32)), w)
        m = n // 5 + 1
        v = np.repeat(rng.integers(0, 4, m), rng.integers(1, 30, m))[:n].astype(np.int32)
        yield "rle_hybrid_encode", f"random runs n={len(v)} width=2", (t(v), 2)
    for n in EDGE_N:
        for dt in (np.int32, np.int64):
            yield "dict_indices", f"n={n} {np.dtype(dt)}", (t(rng.integers(-3, 40, n).astype(dt)),)
    for dt in (np.int32, np.int64):
        info = np.iinfo(dt)
        keys = np.array([-1, info.min, 0, info.max, 1, -2], dtype=dt)
        yield "dict_indices", f"-1 and INT_MIN {np.dtype(dt)}", (t(rng.choice(keys, 5000)),)
    nan64 = np.array([0x7FF8000000000000, 0x7FF8000000000001, 0xFFF8000000000000,
                      0x7FF0000000000001, 0x3FF0000000000000], dtype=np.uint64)
    nan32 = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001, 0x3F800000],
                     dtype=np.uint32)
    yield "dict_indices", "NaN payloads float64", (t(rng.choice(nan64, 5000).view(np.int64)),)
    yield "dict_indices", "NaN payloads float32", (t(rng.choice(nan32, 5000).view(np.int32)),)
    yield "dict_indices", "50,000 uniques of 100,000", (
        t(rng.integers(0, 50_000, 100_000).astype(np.int64)),)
    yield "dict_indices", "2**20 uniques", (t(rng.permutation(1 << 20).astype(np.int64)),)
    for n in EDGE_N + (2, 130, 257):
        for dt in (np.int32, np.int64):
            info = np.iinfo(dt)
            for label, v in (
                ("full range", rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)),
                ("rising", np.cumsum(rng.integers(0, 7, n)).astype(dt)),
                ("constant", np.full(n, 5, dtype=dt)),
            ):
                yield "delta_block_encode", f"{label} n={n} {np.dtype(dt)}", (t(v),)
    for bits, udt, sdt in ((32, np.uint32, np.int32), (64, np.uint64, np.int64)):
        for w in range(1, bits + 1):
            d = rng.integers(0, (1 << w) - 1, 300, dtype=np.uint64, endpoint=True).astype(udt)
            d[5], d[6] = 0, (1 << w) - 1
            v = np.cumsum(d, dtype=udt).view(sdt)
            yield "delta_block_encode", f"width {w} {np.dtype(sdt)}", (t(v),)
    for n in EDGE_N:
        lens = rng.integers(0, 40, n)
        lens[::3] = 0
        off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        data = rng.integers(0, 256, int(off[-1]), dtype=np.uint8)
        yield "plain_bytearray_encode", f"n={n}", (t(data), t(off), 4 * n + int(off[-1]))
        if n > 3:
            sub = off[3:]
            yield "plain_bytearray_encode", f"n={n - 3} from offset {sub[0]}", (
                t(data), t(sub), 4 * (n - 3) + int(sub[-1] - sub[0]))
    long = np.array([0, 5000, 5000, 5003], dtype=np.int64)
    yield "plain_bytearray_encode", "a 5,000-byte value", (
        t(rng.integers(0, 256, 5003, dtype=np.uint8)), t(long), 12 + 5003)


def check_write_kernels(dev, rows: dict) -> None:
    """The write kernels against their plain versions on the card, bit for
    bit, at the edge shapes; dict_indices, plain_bytearray_encode,
    rle_hybrid_encode and delta_block_encode also on testing/synth's
    dict_indices_edge_cases, bytearray_frame_edge_cases,
    rle_plan_edge_cases and delta_encode_edge_cases (the values also as
    views 1-3 elements past an aligned start)."""
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import to_device
    from parquet_tpu_torch.testing.synth import (
        bitpack_edge_cases,
        bytearray_frame_edge_cases,
        delta_encode_edge_cases,
        dict_indices_edge_cases,
        frame_args,
        rle_plan_edge_cases,
    )

    counts = dict.fromkeys(WRITE_KERNELS, 0)
    for name, label, args in write_kernel_cases(np.random.default_rng(SEED + 5), dev):
        hold_plain(rows, name, label, ops.KERNELS[name](*args),
                   getattr(ops, name + "_plain")(*args))
        counts[name] += 1
    log("  " + ", ".join(f"{k}: {v} shapes equal" for k, v in counts.items()))
    labels = []
    for label, values, width in bitpack_edge_cases(ops.BITPACK_TILE, SEED):
        for off in range(4):
            v = shifted(values.view(np.int32), off, dev)
            hold_plain(rows, "bitpack_encode", f"{label}, view at +{off}",
                       ops.bitpack_encode(v, width), ops.bitpack_encode_plain(v, width))
        labels.append(label)
    log(f"  bitpack_encode edge cases equal to the plain version, also at +1-+3 values: "
        f"{'; '.join(labels)}")
    labels = []
    for label, bits in dict_indices_edge_cases(ops.DICT_INDICES_TILE, SEED):
        b = to_device(bits, dev)
        hold_plain(rows, "dict_indices", label, ops.dict_indices(b), ops.dict_indices_plain(b))
        labels.append(f"{label} (n={len(bits)})")
    log(f"  dict_indices edge cases equal to the plain version: {'; '.join(labels)}")
    labels = []
    for case in bytearray_frame_edge_cases(ops.FRAME_TILE, SEED):
        args = frame_args(case, lambda a: to_device(a, dev))
        hold_plain(rows, "plain_bytearray_encode", case.label, ops.plain_bytearray_encode(*args),
                   ops.plain_bytearray_encode_plain(*args))
        labels.append(f"{case.label} (n={len(case.offsets) - 1}, out_len={case.out_len})")
    log(f"  plain_bytearray_encode edge cases equal to the plain version: {'; '.join(labels)}")
    labels = []
    for label, values, width in rle_plan_edge_cases(ops.RLE_PLAN_TILE, SEED):
        v = to_device(values.view(np.int32), dev)
        hold_plain(rows, "rle_hybrid_encode", label, ops.rle_hybrid_encode(v, width),
                   ops.rle_hybrid_encode_plain(v, width))
        labels.append(f"{label} (n={len(values)})")
    log(f"  rle_hybrid_encode edge cases equal to the plain version: {'; '.join(labels)}")
    labels = []
    for label, values in delta_encode_edge_cases(ops.DELTA_ENCODE_TILE, SEED):
        for off in range(4):
            v = shifted(values, off, dev)
            hold_plain(rows, "delta_block_encode", f"{label}, view at +{off}",
                       ops.delta_block_encode(v), ops.delta_block_encode_plain(v))
        labels.append(f"{label} (n={len(values)})")
    log(f"  delta_block_encode edge cases equal to the plain version, also at +1-+3 values: "
        f"{'; '.join(labels)}")
    check_rle_rounds(dev, rows)


def rle_round_pages(n: int, seed: int) -> list:
    """(label, uint32 values < 8) pages of n values for rle_hybrid_encode's
    record walks: all bit-packed (runs of 3), run-heavy (runs of 1-3,000 and
    one of 600,000, which covers whole groups of tiles) and short mixed runs
    (1-30)."""
    rng = np.random.default_rng(seed)
    heavy = np.repeat(rng.integers(0, 8, n // 1000), rng.integers(1, 3000, n // 1000))
    heavy = np.concatenate([heavy[: n // 3], np.full(600_000, 5), heavy[n // 3 :]])
    mixed = np.repeat(rng.integers(0, 8, n // 10), rng.integers(1, 30, n // 10))
    return [("all bit-packed", (np.arange(n) // 3) % 8),
            ("run-heavy", heavy[:n]), ("mixed runs", mixed[:n])]


def check_rle_rounds(dev, rows: dict) -> None:
    """rle_hybrid_encode against its plain version on pages of several groups
    of RLE_PLAN_GROUP tiles (group_plans sums each group's tile records, and
    place walks the group records, then its group's tiles): 2**20 values (4
    groups), 2**22 + 777 (17, the last partial) and 2**26 + 777 (257: two
    rounds of the walk over group records); each size's pages twice in
    turns, so each call reuses the last call's buffers, which held another
    page's plan."""
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import to_device

    for n in (1 << 20, (1 << 22) + 777, (1 << 26) + 777):
        pages = []
        for label, values in rle_round_pages(n, SEED + 17):
            assert len(values) == n
            v = to_device(values.astype(np.int32), dev)
            pages.append((label, v, ops.rle_hybrid_encode_plain(v, 3)))
        for turn in range(2):
            for label, v, plain in pages:
                hold_plain(rows, "rle_hybrid_encode", f"{label}, n={n}, turn {turn}",
                           ops.rle_hybrid_encode(v, 3), plain)
        kept = ", ".join(f"{label} n_bp={int(plain[3])}" for label, _, plain in pages)
        groups = -(-n // (ops.RLE_PLAN_TILE * ops.RLE_PLAN_GROUP))
        log(f"  rle_hybrid_encode equal to the plain version at n={n} ({groups} groups of "
            f"tiles; {kept}), two turns")
        del pages


def write_groups(specs) -> list[dict]:
    """The generator's columns cut into row groups as the write phase takes
    them: {name: ndarray | ByteArrayData}, passenger_count as (non-null
    values, def levels)."""
    from parquet_tpu_torch.core.arrays import ByteArrayData
    from parquet_tpu_torch.testing.synth import column_values

    vals = {s.name: column_values(s) for s in specs}
    valid = next(s for s in specs if s.name == "passenger_count").valid
    cells = np.concatenate([[0], np.cumsum(valid)])
    groups = []
    for g in range(ROW_GROUPS):
        r0, r1 = g * RG_ROWS, (g + 1) * RG_ROWS
        grp = {}
        for s in specs:
            v = vals[s.name]
            if s.name == "passenger_count":
                grp[s.name] = (v[cells[r0] : cells[r1]], valid[r0:r1].astype(np.uint16))
            elif isinstance(v, ByteArrayData):
                o = v.offsets[r0 : r1 + 1]
                grp[s.name] = ByteArrayData(offsets=o - o[0], data=v.data[o[0] : o[-1]])
            else:
                grp[s.name] = v[r0:r1]
        groups.append(grp)
    return groups


def upload_groups(groups: list[dict], dev) -> list[dict]:
    """The row groups on the card: numeric columns as tensors, byte arrays as
    (uint8 data, int64 offsets); passenger_count stays on the host (an
    OPTIONAL column: device columns carry no levels)."""
    from parquet_tpu_torch.core.arrays import ByteArrayData
    from parquet_tpu_torch.kernels.pipeline import to_device

    out = []
    for grp in groups:
        d = {}
        for name, v in grp.items():
            if name == "passenger_count":
                d[name] = v
            elif isinstance(v, ByteArrayData):
                d[name] = (to_device(np.frombuffer(v.data, np.uint8), dev),
                           to_device(v.offsets, dev))
            else:
                d[name] = to_device(v, dev)
        out.append(d)
    return out


def write_taxi(path, schema, groups: list[dict], device: bool, **options) -> None:
    """Write the groups with the port's FileWriter: device columns through
    write_device_column (device=True) or every column through write_column
    from NumPy; passenger_count through write_column either way. `options`
    override or extend the write phase's FileWriter options."""
    from parquet_tpu_torch import FileWriter

    opts = dict(codec="snappy", data_page_version=1, max_page_size=1 << 20,
                use_dictionary=list(WRITE_DICT),
                column_encodings=dict.fromkeys(WRITE_DELTA, "DELTA_BINARY_PACKED"))
    opts.update(options)
    with FileWriter(path, schema, **opts) as w:
        for grp in groups:
            for name, v in grp.items():
                if name == "passenger_count":
                    w.write_column(name, v[0], def_levels=v[1])
                elif device:
                    w.write_device_column(name, v)
                else:
                    w.write_column(name, v)
            w.flush_row_group()


# -- the write options: blooms, the page index, the fused and parallel encode --

# The taxi schema in the port's DSL (zone annotated STRING where the
# generator's footer has the legacy UTF8 only).
TAXI_DSL = """message schema {
  required int64 trip_id;
  required int32 vendor_id;
  optional int32 passenger_count;
  required int64 pickup_us;
  required int32 fare_cents;
  required double trip_distance;
  required binary zone (STRING);
}"""
# trip_id, vendor_id, trip_distance and zone, and fare_cents: the one leaf
# with keys in one row group only that lie inside every group's min/max
# (trip_id's and pickup_us' groups are disjoint ranges; the others' keys are
# in every group)
WRITE_BLOOMS = ("trip_id", "vendor_id", "trip_distance", "zone", "fare_cents")


def median_s(fn, reps: int = 3) -> tuple[float, list]:
    """The median of `reps` timed runs of fn() (s), and the runs; the caller
    has run it once already as the warm-up."""
    secs = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t)
    return statistics.median(secs), secs


def index_bytes(path) -> tuple[int, int]:
    """(bloom bytes, page-index bytes) a file's footer points at."""
    from parquet_tpu_torch.core.reader import FileReader

    bloom = index = 0
    with FileReader(path) as r:
        for i in range(r.num_row_groups):
            for cc in r.row_group(i).columns:
                bloom += cc.meta_data.bloom_filter_length or 0
                index += (cc.column_index_length or 0) + (cc.offset_index_length or 0)
    return bloom, index


def bloom_keys(specs, path) -> tuple[int, int, int, int, int]:
    """fare_cents keys for the bloom read, both inside every group's [min,
    max]: (key, group, absent, pruned_key, pruned_absent), a key in one row
    group only, that group, a key in none, and how many groups the filters
    written in `path` rule out for each."""
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.meta.parquet_types import Type as T

    fare = next(sp for sp in specs if sp.name == "fare_cents").values.reshape(ROW_GROUPS, RG_ROWS)
    lo, hi = int(fare.min(axis=1).max()), int(fare.max(axis=1).min())
    groups_of = collections.defaultdict(set)
    tail = fare >= lo + (hi - lo) // 2  # the sparse tail holds one-group keys
    for g, v in zip(*np.nonzero(tail)):
        groups_of[int(fare[g, v])].add(int(g))
    key = next((v for v in range(hi, lo, -1) if len(groups_of.get(v, ())) == 1), None)
    absent = next((v for v in range(hi, lo, -1) if v not in groups_of), None)
    found = key is not None and absent is not None
    if not found or np.isin([key, absent], fare.ravel()).tolist() != [True, False]:
        raise AssertionError(f"fare_cents: no one-group key or absent key in [{lo}, {hi}]")
    group = groups_of[key].pop()
    with FileReader(path) as r:
        blooms = [r.read_bloom_filter(g, "fare_cents") for g in range(ROW_GROUPS)]
    if blooms[group] is None or not blooms[group].might_contain(T.INT32, key):
        raise AssertionError("fare_cents: the key's own group's bloom filter misses it")
    pruned_key = sum(not b.might_contain(T.INT32, key) for b in blooms)
    pruned_absent = sum(not b.might_contain(T.INT32, absent) for b in blooms)
    return key, group, absent, pruned_key, pruned_absent


def bloom_read(path, filters, dev) -> tuple[list, dict]:
    """The bloom-pruned read: iter_device_batches(filters=, filter_rows=True)
    over trip_id and fare_cents (the kept rows' trip ids, from the card),
    and read_row_group_device(i, filters=) + mask_take on every group
    prune_row_groups admits (their trip ids too); returns (the two id
    lists, sorted, and the filter counts of the batch stream)."""
    import torch

    from parquet_tpu_torch.core.reader import FileReader, filter_counts, reset_filter_counts
    from parquet_tpu_torch.kernels import device_ops as ops

    reset_filter_counts()
    ids = []
    with FileReader(path) as r:
        for batch in r.iter_device_batches(BATCH, columns=["trip_id", "fare_cents"],
                                           drop_remainder=False, filters=filters,
                                           filter_rows=True):
            ids.append(batch[("trip_id",)].cpu().numpy())
        fc = filter_counts()
        per_group = []
        for i in r.prune_row_groups(filters):
            cols, mask = r.read_row_group_device(i, ["trip_id"], filters=filters)
            n = mask.numel()
            taken, count = ops.mask_take(cols[("trip_id",)].values, mask, n)
            per_group.append(taken[: int(count)].cpu().numpy())
    torch.cuda.synchronize()

    def ordered(parts):
        return sorted(np.concatenate(parts).tolist()) if parts else []

    return [ordered(ids), ordered(per_group)], fc


def ab_write_natives(host_group: dict, schema) -> dict:
    """The bloom and encode natives against their Python oracles on write
    group 0's columns: XXH64 batches of trip_id and zone, the bloom insert,
    and the fused chunk encode against the staged encoder on every column
    chunk (GZIP, no page index); each side's median of 3 after a warm-up,
    outputs held equal."""
    from parquet_tpu_torch.core.arrays import ByteArrayData
    from parquet_tpu_torch.core.bloom import BloomFilter, bloom_hash_values, bloom_hash_values_plain
    from parquet_tpu_torch.core.column_store import ColumnChunkBuilder
    from parquet_tpu_torch.meta.parquet_types import Encoding
    from parquet_tpu_torch.meta.parquet_types import Type as T
    from parquet_tpu_torch.sink import encoder

    out = {}
    few = 20_000
    trip = host_group["trip_id"][:few]
    ab_native(out, "xxh64_fixed, 20,000 trip_id values",
              lambda: bloom_hash_values(T.INT64, trip),
              lambda: bloom_hash_values_plain(T.INT64, trip), np.array_equal, reps=3)
    zone = host_group["zone"]
    zfew = ByteArrayData(offsets=zone.offsets[: few + 1], data=zone.data)
    ab_native(out, "xxh64_offsets, 20,000 zone values",
              lambda: bloom_hash_values(T.BYTE_ARRAY, zfew),
              lambda: bloom_hash_values_plain(T.BYTE_ARRAY, zfew), np.array_equal, reps=3)
    hashes = bloom_hash_values(T.INT64, trip)

    def inserted(plain):
        bf = BloomFilter.sized_for(few, 0.01)
        (bf.insert_hashes_plain if plain else bf.insert_hashes)(hashes)
        return bf.blocks

    ab_native(out, "bloom_insert, 20,000 trip_id hashes", lambda: inserted(False),
              lambda: inserted(True), np.array_equal, reps=3)
    cfg = encoder.EncoderConfig(
        codec=2, data_page_version=1, max_page_size=1 << 20, with_crc=False,
        column_encodings={(k,): Encoding.DELTA_BINARY_PACKED for k in WRITE_DELTA})
    for name, v in host_group.items():
        leaf = schema.column(name)
        b = ColumnChunkBuilder(leaf, name in WRITE_DICT)
        b.set_columnar(*(v if name == "passenger_count" else (v,)))
        plan = encoder._plan_chunk(cfg, b)
        ab_native(out, f"chunk_encode, {name} of write group 0 (gzip)",
                  lambda: encoder._fused_encode_chunk(cfg, b, None, plan),
                  lambda: encoder._staged_encode_chunk(cfg, b, None, plan),
                  lambda f, st: (isinstance(f, encoder.EncodedChunk)
                                 and b"".join(bytes(x) for x in f.parts)
                                 == b"".join(bytes(x) for x in st.parts)
                                 and f.chunk.dumps() == st.chunk.dumps()),
                  reps=3)
    return out


def check_write_options(taxi_specs, host_groups, dev_groups, dev, launches: dict) -> dict:
    """The write options phase over the write phase's groups: (a) the device
    write with bloom filters, byte-equal to the host write with the same
    options; (b) bloom pruning on the card by a one-group key and an absent
    one; (c) the host write with the page index and GZIP serial and fused,
    serial and staged (PQT_FUSED_ENCODE=0) and parallel, byte-equal, the
    fused walk declining the page-index chunks; prune_pages on trip_id
    ranges; (d) split and merge of the device-written file, read back on
    the card; (e) the timings: the page-index-free GZIP host write three
    ways (the fused walk on every chunk, the files byte-equal), one timed
    first write each, and SNAPPY and UNCOMPRESSED host writes fused and
    staged (byte-equal). Returns the phase's numbers."""
    import torch

    from parquet_tpu_torch import (
        merge_files,
        parse_schema,
        reset_write_counts,
        split_row_groups,
        write_counts,
    )
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.build import BUILD_ROOT

    out: dict = {}
    schema = parse_schema(TAXI_DSL)
    d = BUILD_ROOT / "smoke"
    blooms = list(WRITE_BLOOMS)
    n_rows = ROW_GROUPS * RG_ROWS
    chunks = ROW_GROUPS * len(taxi_specs)
    # (a) the device write with bloom filters
    dev_file, host_file = d / "opts-device-bloom.parquet", d / "opts-host-bloom.parquet"
    ops.reset_launch_counts()
    reset_write_counts()
    write_taxi(dev_file, schema, dev_groups, device=True, bloom_filters=blooms)
    torch.cuda.synchronize()
    counts = kernel_counts()
    wc = write_counts()
    launches["taxi write with blooms"] = counts
    log(f"[write-options:a] write_device_column, bloom_filters={blooms}: write counts {wc}; "
        "launches " + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
    if (wc["device_write_engaged"], wc["device_write_declined"]) != (6 * ROW_GROUPS, 0):
        raise AssertionError(f"write counts {wc}: every numeric device column must engage")
    for k in ("dict_indices", "rle_hybrid_encode", "delta_block_encode", "plain_bytearray_encode"):
        if counts[k] <= 0:
            raise AssertionError(f"{k} was not launched on the write with blooms")
    write_taxi(host_file, schema, host_groups, device=False, bloom_filters=blooms)
    if dev_file.read_bytes() != host_file.read_bytes():
        raise AssertionError("the device write with blooms differs from the host write's")
    with FileReader(dev_file) as r:
        if [c.path for c in r.schema.leaves] != [(sp.name,) for sp in taxi_specs]:
            raise AssertionError("the DSL taxi schema's leaves differ from the generator's")
        for g in range(ROW_GROUPS):
            for name in WRITE_BLOOMS:
                if r.read_bloom_filter(g, name) is None:
                    raise AssertionError(f"group {g} {name}: no bloom filter written")
    out["bytes"] = {"device bloom file": dict(zip(("bloom", "page_index"), index_bytes(dev_file)))}
    log(f"[write-options:a] the device write's file equals the host write's, byte for byte; "
        f"bloom bytes {out['bytes']['device bloom file']['bloom']:,}")
    # (b) bloom pruning on the card
    key, group, absent, pruned_key, pruned_absent = bloom_keys(taxi_specs, dev_file)
    fare = next(sp for sp in taxi_specs if sp.name == "fare_cents").values
    trip = next(sp for sp in taxi_specs if sp.name == "trip_id").values
    for label, value, pruned in (("one-group key", key, pruned_key),
                                 ("absent key", absent, pruned_absent)):
        filters = [("fare_cents", "==", value)]
        ops.reset_launch_counts()
        got, fc = bloom_read(dev_file, filters, dev)
        counts = kernel_counts()
        launches[f"taxi bloom-pruned read, {label}"] = counts
        want = sorted(trip[fare == value].tolist())
        where = f"group {group}" if value == key else "no group"
        log(f"[write-options:b] fare_cents == {value} ({label}, {where}): {len(want)} rows; "
            f"filter counts {fc}; launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
        if fc.get("groups_pruned_stats") or fc.get("groups_pruned_bloom") != pruned:
            raise AssertionError(f"{label}: filter counts {fc}; the written filters prune "
                                 f"{pruned} groups and statistics none")
        if pruned < ROW_GROUPS - 2 - (value == key):
            raise AssertionError(f"{label}: only {pruned} groups pruned by bloom")
        if got != [want, want]:
            raise AssertionError(f"{label}: the rows read on the card differ from NumPy's")
        if pruned < ROW_GROUPS and (counts["predicate_mask"] <= 0 or counts["mask_take"] <= 0):
            raise AssertionError(f"{label}: predicate_mask / mask_take were not launched on "
                                 "the groups the filters admit")
    out["bloom_read"] = {"key": key, "group": group, "absent": absent,
                         "pruned_key": pruned_key, "pruned_absent": pruned_absent}
    log("[write-options:b] bloom pruning as the written filters predict; rows equal NumPy's")
    # (c) the host write variants: page index + GZIP, three ways
    files = {}
    variants = (("serial fused", {}, {}), ("serial staged", {"PQT_FUSED_ENCODE": "0"}, {}),
                ("parallel", {}, {"parallel": True}))
    for label, env, opts in variants:
        f = d / f"opts-index-{label.replace(' ', '-')}.parquet"
        reset_write_counts()
        t = time.perf_counter()
        with env_set(**env):
            write_taxi(f, schema, host_groups, device=False, codec="gzip",
                       write_page_index=True, **opts)
        wc = write_counts()
        log(f"[write-options:c] page index + gzip, {label}: {time.perf_counter() - t:.2f} s, "
            f"write counts {wc}")
        files[label] = f
        fused = (wc["encode_fused_declined"], wc["encode_fused_engaged"])
        if label != "serial staged" and fused != (chunks, 0):
            raise AssertionError(f"{label}: the fused walk must decline all {chunks} page-index "
                                 f"chunks ({wc})")
        if label == "serial staged" and (wc["encode_fused_declined"] or wc["encode_fused_engaged"]):
            raise AssertionError(f"PQT_FUSED_ENCODE=0 still counted fused work ({wc})")
    raw = {label: f.read_bytes() for label, f in files.items()}
    if len(set(raw.values())) != 1:
        raise AssertionError("the page-index files of the three host writes differ")
    out["bytes"]["page index file"] = dict(zip(("bloom", "page_index"),
                                               index_bytes(files["serial fused"])))
    log("[write-options:c] serial fused, serial staged and parallel page-index files are equal")
    ranges = {}
    with FileReader(files["serial fused"]) as r:
        for g in range(ROW_GROUPS):
            lo = int(trip[g * RG_ROWS]) + RG_ROWS // 3
            flt = [("trip_id", ">=", lo), ("trip_id", "<", lo + 1000)]
            kept = r.prune_pages(g, flt)
            rows = sum(b - a for a, b in kept)
            seg = trip[g * RG_ROWS:(g + 1) * RG_ROWS]
            match = np.nonzero((seg >= lo) & (seg < lo + 1000))[0]
            inside = np.zeros(RG_ROWS, dtype=bool)
            for a, b in kept:
                inside[a:b] = True
            if rows >= RG_ROWS or not inside[match].all() or len(match) != 1000:
                raise AssertionError(f"prune_pages group {g}: kept {kept} for {len(match)} rows")
            ranges[g] = rows
    out["prune_pages_rows_kept"] = ranges
    log(f"[write-options:c] prune_pages on trip_id ranges of 1,000 rows keeps "
        f"{sorted(set(ranges.values()))} of {RG_ROWS} rows a group; every match inside")
    # (d) split and merge
    parts = split_row_groups(dev_file, str(d / "opts-part-%d.parquet"), ROW_GROUPS // 2)
    merged = d / "opts-merged.parquet"
    merge_files(merged, parts)
    reader = FileReader(merged)
    groups = reader.read_row_groups_device()
    torch.cuda.synchronize()
    check_main_path(groups, taxi_specs, reader.stats, no_host_fallback=False)
    del groups
    log(f"[write-options:d] split into {len(parts)} parts and merged back: read on the card, "
        "the columns equal the generator's")
    # (e) timings: the writes of (a) and (c) were the warm-ups, and for
    # SNAPPY and UNCOMPRESSED the fused and staged writes here, held
    # byte-equal; medians of 3, but one timed run for each GZIP host write
    # (about 19 s a serial write), the first write of its file: the
    # page-index-free GZIP files of the three ways, each checked on its
    # walk's counts and the three held byte-equal
    plain = {}
    rates = {}
    gzip_ways = {"serial fused": "host write gzip, serial fused",
                 "serial staged": "host write gzip, serial staged",
                 "parallel": "host write gzip, parallel fused"}
    for label, env, opts in variants:
        f = d / f"opts-gzip-{label.replace(' ', '-')}.parquet"
        reset_write_counts()
        with env_set(**env):
            med, secs = median_s(lambda: (write_taxi(f, schema, host_groups, device=False,
                                                     codec="gzip", **opts),
                                          torch.cuda.synchronize()), reps=1)
        wc = write_counts()
        plain[label] = f
        rates[gzip_ways[label]] = n_rows / med
        log(f"  {gzip_ways[label]}: {rates[gzip_ways[label]]:,.0f} rows/s (one run, the file's "
            f"first write, {[round(x, 3) for x in secs]} s); write counts {wc}")
        if label != "serial staged" and (wc["encode_fused_engaged"], wc["encode_fused_declined"],
                                         wc["encode_fallback_recovered"]) != (chunks, 0, 0):
            raise AssertionError(f"{label}: the fused walk must take all {chunks} chunks ({wc})")
        if label == "serial staged" and (wc["encode_fused_declined"] or wc["encode_fused_engaged"]):
            raise AssertionError(f"PQT_FUSED_ENCODE=0 still counted fused work ({wc})")
    if len({f.read_bytes() for f in plain.values()}) != 1:
        raise AssertionError("the page-index-free gzip files of the three host writes differ")
    log(f"[write-options:e] page-index-free gzip: the fused walk took all {chunks} chunks; "
        "serial fused, serial staged and parallel files are equal")
    for codec in ("snappy", "uncompressed"):
        for label, env in (("fused", {}), ("staged", {"PQT_FUSED_ENCODE": "0"})):
            f = d / f"opts-{codec}-{label}.parquet"
            reset_write_counts()
            with env_set(**env):
                write_taxi(f, schema, host_groups, device=False, codec=codec)
            wc = write_counts()
            got = (wc["encode_fused_engaged"], wc["encode_fused_declined"],
                   wc["encode_fallback_recovered"])
            if got != ((chunks, 0, 0) if label == "fused" else (0, 0, 0)):
                raise AssertionError(f"{codec} {label}: write counts {wc}")
            plain[f"{codec} {label}"] = f
        if plain[f"{codec} fused"].read_bytes() != plain[f"{codec} staged"].read_bytes():
            raise AssertionError(f"the {codec} files of the fused and staged writes differ")
    log(f"[write-options:e] snappy and uncompressed: the fused walk took all {chunks} chunks; "
        "the fused and staged files are equal")
    for label, fn in (
        ("device write, blooms", lambda: write_taxi(dev_file, schema, dev_groups, True,
                                                   bloom_filters=blooms)),
        ("device write, no blooms", lambda: write_taxi(dev_file, schema, dev_groups, True)),
        *((f"host write {codec}, serial {way}",
           lambda codec=codec, way=way: write_taxi(plain[f"{codec} {way}"], schema,
                                                   host_groups, False, codec=codec))
          for codec in ("snappy", "uncompressed") for way in ("fused", "staged")),
    ):
        env = {"PQT_FUSED_ENCODE": "0"} if "staged" in label else {}
        with env_set(**env):
            med, secs = median_s(lambda: (fn(), torch.cuda.synchronize()))
        rates[label] = n_rows / med
        log(f"  {label}: {rates[label]:,.0f} rows/s (median of {[round(x, 3) for x in secs]} s)")
    out["rows_per_s"] = rates
    blooms_ratio = rates["device write, blooms"] / rates["device write, no blooms"]
    fused_ratio = rates["host write gzip, serial fused"] / rates["host write gzip, serial staged"]
    par_ratio = rates["host write gzip, parallel fused"] / rates["host write gzip, serial fused"]
    codec_ratios = {codec: rates[f"host write {codec}, serial fused"]
                    / rates[f"host write {codec}, serial staged"]
                    for codec in ("snappy", "uncompressed")}
    out["fused_over_staged"] = {"gzip": fused_ratio, **codec_ratios}
    log(f"[write-options:e] device write blooms / none {blooms_ratio:.3f}; host fused / staged "
        f"gzip {fused_ratio:.3f}, snappy {codec_ratios['snappy']:.3f}, uncompressed "
        f"{codec_ratios['uncompressed']:.3f}; parallel / serial {par_ratio:.3f}; "
        f"os.cpu_count() {os.cpu_count()}")
    for label, b in out["bytes"].items():
        size = (dev_file if "device" in label else files["serial fused"]).stat().st_size
        log(f"  {label}: bloom {b['bloom']:,} bytes, page index {b['page_index']:,} bytes, "
            f"file {size:,} bytes")
    log("[write-options:e] the new natives against their Python oracles, write group 0:")
    out["native_ab_s"] = ab_write_natives(host_groups[0], schema)
    for f in [dev_file, host_file, merged, *files.values(), *plain.values()]:
        f.unlink()
    for f in parts:
        Path(f).unlink()
    return out


def time_write_kernels(dev_groups: list[dict], dev, rows: dict, bw: float) -> None:
    """Device times of the write kernels at the write phase's shapes (row
    group 0): dict_indices on trip_distance's bit patterns, rle_hybrid_encode
    on vendor_id's first page of indices, bitpack_encode on
    trip_distance's first page of indices, delta_block_encode on pickup_us's
    first page, plain_bytearray_encode on zone; each held against its plain
    version on the inputs it is timed on, then timed beside its bound, its
    plain version and the one PyTorch call computing the same function
    where there is one."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops

    g = dev_groups[0]
    dist_bits = g["trip_distance"].view(torch.int64)
    n = dist_bits.numel()

    def record(name, fn, plain, nbytes, ops_count, lib=None, lib_events=False,
               plain_events=False, shape=""):
        record_kernel(rows, name, fn, plain, nbytes, ops_count, bw, lib=lib,
                      lib_events=lib_events, plain_events=plain_events, shape=shape)

    # bytes: keys read, indices and firsts written; ops: the hash, the probe
    # and compare, the scan and the rank gather, ~30 per row. The library
    # call (torch.unique) gives sorted groups, not the first-occurrence order.
    record("dict_indices", lambda: ops.dict_indices(dist_bits),
           lambda: ops.dict_indices_plain(dist_bits), 8 * n + 8 * n + 4, 30 * n,
           lib=lambda: torch.unique(dist_bits, return_inverse=True), lib_events=True,
           plain_events=True, shape=f"taxi trip_distance group 0, n={n} int64 bit patterns")
    rows["dict_indices"]["key_bits"] = 64
    # the same probe over a low-cardinality column: 8 keys, every row a
    # repeat of one of them (the case that makes the hash's atomics queue)
    vendor = g["vendor_id"]
    nv = vendor.numel()
    v_shape = f"taxi vendor_id group 0, n={nv} int32, 8 keys"
    hold_plain(rows, "dict_indices", f"[{v_shape}]", ops.dict_indices(vendor),
               ops.dict_indices_plain(vendor))
    t_v = {"ms": device_ms(lambda: ops.dict_indices(vendor)),
           "plain_ms": events_ms(lambda: ops.dict_indices_plain(vendor)),
           "library_ms": events_ms(lambda: torch.unique(vendor, return_inverse=True)),
           "bound_ms": (4 * nv + 8 * nv + 4) / bw * 1e3, "bound_by": "bytes", "shape": v_shape,
           "key_bits": 32}
    rows["dict_indices"]["low_cardinality"] = t_v
    log(f"  dict_indices [{v_shape}]: equal to its plain version; {t_v['ms']:.4f} ms, "
        f"plain {t_v['plain_ms']:.4f} ms, library {t_v['library_ms']:.4f} ms; "
        f"bound {t_v['bound_ms']:.4f} ms (bytes)")
    # and over an all-unique column (trip_id; pickup_us is nearly the same
    # shape): every row a first row, every probe a claim
    tid = g["trip_id"]
    nt = tid.numel()
    u_shape = f"taxi trip_id group 0, n={nt} int64, all unique"
    hold_plain(rows, "dict_indices", f"[{u_shape}]", ops.dict_indices(tid),
               ops.dict_indices_plain(tid))
    t_u = {"ms": device_ms(lambda: ops.dict_indices(tid)),
           "plain_ms": events_ms(lambda: ops.dict_indices_plain(tid)),
           "library_ms": events_ms(lambda: torch.unique(tid, return_inverse=True)),
           "bound_ms": (8 * nt + 8 * nt + 4) / bw * 1e3, "bound_by": "bytes", "shape": u_shape,
           "key_bits": 64}
    rows["dict_indices"]["all_unique"] = t_u
    log(f"  dict_indices [{u_shape}]: equal to its plain version; {t_u['ms']:.4f} ms, "
        f"plain {t_u['plain_ms']:.4f} ms, library {t_u['library_ms']:.4f} ms; "
        f"bound {t_u['bound_ms']:.4f} ms (bytes)")
    page = (1 << 20) // 4
    vendor_idx = ops.dict_indices(vendor)[0][:page]
    dist_idx = ops.dict_indices(dist_bits)[0][:page]
    torch.cuda.synchronize()
    m = vendor_idx.numel()
    n_bp = int(ops.rle_hybrid_encode(vendor_idx, 3)[3])
    # bytes: the values read, both masks, the bit-packed groups this page
    # has and n_bp written; ops: two compares, two scans, the window
    # arithmetic and the pack, ~40 per value
    record("rle_hybrid_encode", lambda: ops.rle_hybrid_encode(vendor_idx, 3),
           lambda: ops.rle_hybrid_encode_plain(vendor_idx, 3),
           4 * m + 2 * m + (n_bp + 7) // 8 * 3 + 4, 40 * m,
           shape=f"taxi vendor_id group 0 page 0, n={m} indices ({n_bp} bit-packed), width 3")
    # trip_distance's pages take the same kernel at width 12, nearly all
    # bit-packed
    d_bp = int(ops.rle_hybrid_encode(dist_idx, 12)[3])
    record_shape(rows, "rle_hybrid_encode", lambda: ops.rle_hybrid_encode(dist_idx, 12),
                 lambda: ops.rle_hybrid_encode_plain(dist_idx, 12),
                 4 * m + 2 * m + (d_bp + 7) // 8 * 12 + 4, 40 * m, bw,
                 shape=f"taxi trip_distance group 0 page 0, n={m} indices ({d_bp} bit-packed), "
                 "width 12")
    k = dist_idx.numel()
    words = (k * 12 + 31) // 32 + 1
    # bytes: the values read, the words written; ops: ~3 per value gathered
    record("bitpack_encode", lambda: ops.bitpack_encode(dist_idx, 12),
           lambda: ops.bitpack_encode_plain(dist_idx, 12), 4 * k + 4 * words, 6 * k,
           shape=f"taxi trip_distance group 0 page 0, n={k} indices, width 12")
    pickup = g["pickup_us"][: (1 << 20) // 8]
    p = pickup.numel()
    nb = (p - 1 + 127) // 128
    payload = 4 * int(ops.delta_block_encode(pickup)[1].long().sum())
    # bytes: the values read, mins and widths written, and the payload this
    # page's widths give (the words past it are not written); ops: subtract,
    # two reductions, clz, the scan and the pack, ~25 per value
    record("delta_block_encode", lambda: ops.delta_block_encode(pickup),
           lambda: ops.delta_block_encode_plain(pickup),
           8 * p + 8 * nb + 16 * nb + payload, 25 * p,
           shape=f"taxi pickup_us group 0 page 0, n={p} int64, {payload} payload bytes")
    # fare_cents's pages take the int32 instance of the same kernel: held,
    # not timed
    fare = g["fare_cents"][: (1 << 20) // 4]
    hold_plain(rows, "delta_block_encode", f"[taxi fare_cents group 0 page 0, n={fare.numel()} int32]",
               ops.delta_block_encode(fare), ops.delta_block_encode_plain(fare))
    data, offsets = g["zone"]
    nz = offsets.numel() - 1
    total = data.numel()
    # bytes: offsets and data read, the framed stream written; ops: ~2 per byte
    record("plain_bytearray_encode",
           lambda: ops.plain_bytearray_encode(data, offsets, 4 * nz + total),
           lambda: ops.plain_bytearray_encode_plain(data, offsets, 4 * nz + total),
           8 * (nz + 1) + total + 4 * nz + total, 2 * (total + 4 * nz),
           shape=f"taxi zone group 0, n={nz} values, {total} bytes")


def time_new_kernels(mixed_path, dev, rows: dict, bw: float) -> None:
    """Device times of the three kernels of the mixed path on the taxi_mixed
    file's first row group, beside their bounds, plain versions and (for
    bss_transpose) the one PyTorch call computing the same function."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops

    plans = row_group_plans(mixed_path, dev, 0, ["fare_amount", "trip_id", "zone"])

    def record(name, fn, plain, nbytes, ops_count, library=None, plain_graph=True):
        entry = {
            "ms": device_ms(fn),
            "plain_ms": device_ms(plain) if plain_graph else events_ms(plain),
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

    streams, nv = plans["fare_amount"].dev_bss[0]
    # bytes: four stream bytes read and one word written per value; ops:
    # three shifts, three ors and the addressing, ~8 per value
    record("bss_transpose",
           lambda: ops.bss_transpose(streams, nv), lambda: ops.bss_transpose_plain(streams, nv),
           8 * nv, 8 * nv,
           library=lambda: streams[:, :nv].t().contiguous().view(torch.int32))
    # the chunk as _ChunkPlan.device_column builds it: every page in one
    # launch; the library call is one cat over the transposed views
    pages = plans["fare_amount"].dev_bss
    total = sum(n for _, n in pages)
    record_shape(rows, "bss_transpose", lambda: ops.bss_transpose_pages(pages),
                 lambda: ops.bss_transpose_pages_plain(pages), 8 * total, 8 * total, bw,
                 lib=lambda: torch.cat([s[:, :n].t() for s, n in pages]).view(torch.int32),
                 shape=f"taxi_mixed fare_amount group 0, the chunk: {len(pages)} pages, "
                 f"{total} values, one launch")
    args = plans["trip_id"]._merge_numeric_args()
    idx, dictionary, plain = args[0], args[1], args[2]
    n_rows = args[-1]
    e = dictionary.element_size()
    p_pad = args[3].numel()
    # bytes: the dict rows' indices, the dictionary, the PLAIN values and the
    # output, each once; ops: the page search (~3 per step) and ~12 for the
    # clamps and the select, per row
    record("merge_mixed_numeric",
           lambda: ops.merge_mixed_numeric(*args), lambda: ops.merge_mixed_numeric_plain(*args),
           4 * idx.numel() + e * dictionary.numel() + e * plain.numel() + e * n_rows,
           n_rows * (3 * p_pad.bit_length() + 12))
    bargs = plans["zone"]._merge_bytes_args()
    b_rows = bargs[-2]
    probe = ops.merge_mixed_bytes(*bargs)
    total = int(probe[1][-1])
    # bytes: indices, dictionary offsets, the pool (dictionary payload and
    # PLAIN bytes), the PLAIN offsets, the output bytes and offsets, each
    # once; ops: per row the page search and ~30 for the source, the scan
    # and the copy loop, plus ~2 per output byte
    record("merge_mixed_bytes",
           lambda: ops.merge_mixed_bytes(*bargs), lambda: ops.merge_mixed_bytes_plain(*bargs),
           4 * bargs[0].numel() + 8 * bargs[1].numel() + bargs[2].numel()
           + 4 * bargs[3].numel() + total + 8 * (b_rows + 1),
           b_rows * (3 * bargs[4].numel().bit_length() + 30) + 2 * total,
           plain_graph=False)


def prepare_alone(path, fused: bool, by_column: dict | None = None) -> float:
    """Seconds of host prepare alone over a whole file, on the fused native
    walk or the staged per-page walk (PQT_FUSED_PREPARE). `by_column`, when
    given, accumulates each column's seconds."""
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels.pipeline import prepare_chunk_plan

    old = os.environ.get("PQT_FUSED_PREPARE")
    os.environ["PQT_FUSED_PREPARE"] = "1" if fused else "0"
    try:
        t = time.perf_counter()
        with FileReader(path, device="cpu") as r:  # prepare touches no device
            for i in range(r.num_row_groups):
                for p, cc, column in r._selected_chunks(i):
                    t_chunk = time.perf_counter()
                    prepare_chunk_plan(r._window(cc), cc, column)
                    if by_column is not None:
                        by_column[p[0]] = (
                            by_column.get(p[0], 0.0) + time.perf_counter() - t_chunk
                        )
        return time.perf_counter() - t
    finally:
        if old is None:
            os.environ.pop("PQT_FUSED_PREPARE", None)
        else:
            os.environ["PQT_FUSED_PREPARE"] = old


def value_pages(path, column: str):
    """Row group 0's pages of one required column: (kind, header, value
    stream, n) with kind "dict" or "data", the value stream decompressed and
    past the levels (a required flat column has none)."""
    from parquet_tpu_torch.core.chunk import iter_chunk_pages
    from parquet_tpu_torch.core.compress import decompress_block
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.meta.parquet_types import PageType

    out = []
    with FileReader(path, device="cpu") as r:
        cc = next(c for c in r.row_group(0).columns
                  if c.meta_data.path_in_schema == [column])
        codec = cc.meta_data.codec or 0
        for raw in iter_chunk_pages(r._window(cc), cc):
            h = raw.header
            if h.type == int(PageType.DATA_PAGE_V2):
                v2 = h.data_page_header_v2
                skip = (v2.repetition_levels_byte_length or 0) + (
                    v2.definition_levels_byte_length or 0)
                block = raw.payload[skip:]
                if v2.is_compressed is None or v2.is_compressed:
                    block = decompress_block(block, codec, h.uncompressed_page_size - skip)
                out.append(("data", h, bytes(block), v2.num_values))
                continue
            block = bytes(decompress_block(raw.payload, codec, h.uncompressed_page_size))
            if h.type == int(PageType.DICTIONARY_PAGE):
                out.append(("dict", h, block, h.dictionary_page_header.num_values))
            else:
                out.append(("data", h, block, h.data_page_header.num_values))
    return out


def header_walk(path, read) -> list:
    """Every page header of row group 0's chunks, read with `read` (the
    native `_read_page_header` or its oracle), statistics dropped as the
    native parser drops them."""
    from parquet_tpu_torch.core.chunk import chunk_byte_range
    from parquet_tpu_torch.core.reader import FileReader

    headers = []
    with FileReader(path, device="cpu") as r:
        for cc in r.row_group(0).columns:
            f = r._window(cc)
            off, total = chunk_byte_range(cc)
            f.seek(off)
            while f.tell() < off + total:
                h = read(f)
                for part in (h.data_page_header, h.data_page_header_v2):
                    if part is not None:
                        part.statistics = None
                headers.append(repr(h))
                f.seek(f.tell() + h.compressed_page_size)
    return headers


def ab_native(out: dict, label: str, native, oracle, same, reps: int = 0) -> None:
    """One native function against its Python oracle, the outputs held equal
    by `same` (an inequality fails the run). With reps=0 each side is timed
    once, cold; else that first call is the warm-up and each side's time is
    the median of `reps` more runs. The seconds are logged and kept in
    out[label]."""
    t = time.perf_counter()
    got = native()
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    want = oracle()
    oracle_s = time.perf_counter() - t
    if not same(got, want):
        raise AssertionError(f"A/B {label}: the native function differs from its oracle")
    out[label] = {"native_s": native_s, "oracle_s": oracle_s}
    runs = ""
    if reps:
        native_s, native_runs = median_s(native, reps)
        oracle_s, oracle_runs = median_s(oracle, reps)
        out[label] = {"native_s": native_s, "oracle_s": oracle_s,
                      "native_runs": native_runs, "oracle_runs": oracle_runs}
        runs = (f" (medians of {[round(x, 4) for x in native_runs]} and "
                f"{[round(x, 4) for x in oracle_runs]} s)")
    log(f"  A/B {label}: native {native_s:.4f} s, Python oracle {oracle_s:.4f} s "
        f"({oracle_s / max(native_s, 1e-9):.1f}x), equal{runs}")


def ab_native_values(paths: dict, host_group: dict, taxi_specs) -> dict:
    """Phase 5's A/B of the host value functions on row group 0 of the real
    columns: each function of the port's host library (native/values.cc and
    the parsers of native/prepare.cc) against its Python oracle, the seconds
    of each side, the outputs held equal (an inequality fails the run)."""
    from parquet_tpu_torch.core import chunk as tchunk
    from parquet_tpu_torch.core.arrays import ByteArrayData
    from parquet_tpu_torch.core.bloom import xxh64
    from parquet_tpu_torch.core.column_store import (
        DICT_MAX_UNIQUES,
        _bytes_first_occurrence_dictionary,
        _first_occurrence_dictionary,
    )
    from parquet_tpu_torch.core.stats import bytes_minmax_plain
    from parquet_tpu_torch.meta.parquet_types import Encoding
    from parquet_tpu_torch.meta.parquet_types import Type as T
    from parquet_tpu_torch.ops import delta as tdelta
    from parquet_tpu_torch.ops import plain as tplain
    from parquet_tpu_torch.ops import rle_hybrid as thybrid
    from parquet_tpu_torch.utils.native import get_native

    lib = get_native()
    out = {}

    def same(a, b) -> bool:
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if a is None or b is None:
            return a is None and b is None
        if isinstance(a, ByteArrayData):
            return same(a.offsets, b.offsets) and bytes(a.data) == bytes(b.data)
        if isinstance(a, (bytes, memoryview)):
            return bytes(a) == bytes(b)
        if isinstance(a, (int, str)):
            return a == b
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()

    def ab(label, native, oracle):
        ab_native(out, label, native, oracle, same)

    def gathered(pages):
        return [tplain.decode_plain(b, n, T.BYTE_ARRAY) for _k, _h, b, n in pages]

    def gathered_plain(pages):
        return [tplain.byte_array_gather_plain(memoryview(b), n) for _k, _h, b, n in pages]

    taxi, mixed = paths["taxi"][0], paths["taxi_mixed"][0]
    zone_dict = [pg for pg in value_pages(taxi, "zone") if pg[0] == "dict"]
    ab("byte_array_gather, taxi zone dictionary page", lambda: gathered(zone_dict),
       lambda: gathered_plain(zone_dict))
    mixed_plain = [pg for pg in value_pages(mixed, "zone")
                   if pg[0] == "data" and pg[1].data_page_header.encoding == Encoding.PLAIN]
    if not mixed_plain:
        raise AssertionError("taxi_mixed zone: row group 0 has no PLAIN fallback page")
    ab(f"byte_array_gather, taxi_mixed zone {len(mixed_plain)} PLAIN pages",
       lambda: gathered(mixed_plain), lambda: gathered_plain(mixed_plain))
    ab("parse_page_header, taxi row group 0", lambda: header_walk(taxi, tchunk._read_page_header),
       lambda: header_walk(taxi, tchunk.read_page_header_plain))
    vendor = [(b[1:], n, b[0]) for k, _h, b, n in value_pages(taxi, "vendor_id") if k == "data"]
    ab("prescan_hybrid, taxi vendor_id pages",
       lambda: [vars(thybrid.prescan_hybrid(b, n, w)) for b, n, w in vendor],
       lambda: [vars(thybrid.prescan_hybrid_plain(b, n, w)) for b, n, w in vendor])
    ab("hybrid_decode, taxi vendor_id pages",
       lambda: [thybrid.decode_hybrid(b, n, w) for b, n, w in vendor],
       lambda: [thybrid.decode_hybrid_plain(b, n, w) for b, n, w in vendor])
    pickup = [(b, n) for k, _h, b, n in value_pages(taxi, "pickup_us") if k == "data"]
    ab("delta_decode, taxi pickup_us pages",
       lambda: [tdelta.decode_delta(b, 64, max_total=n) for b, n in pickup],
       lambda: [tdelta.decode_delta_plain(b, 64, max_total=n) for b, n in pickup])
    zspec = next(sp for sp in taxi_specs if sp.name == "zone")
    idx = zspec.indices[:RG_ROWS].astype(np.int64)
    ab("bytearray_take, zone dictionary by row group 0's indices",
       lambda: zspec.dictionary.take(idx), lambda: zspec.dictionary.take_plain(idx))
    zone = host_group["zone"]
    ab("bytes_minmax, zone of write group 0", lambda: lib.bytes_minmax(zone.data, zone.offsets),
       lambda: bytes_minmax_plain(zone))
    ab("bytes_dict_indices, zone of write group 0",
       lambda: lib.bytes_dict_indices(zone.data, zone.offsets, DICT_MAX_UNIQUES),
       lambda: _bytes_first_occurrence_dictionary(zone))
    few = ByteArrayData(offsets=zone.offsets[:20_001], data=zone.data)  # under the cutoff
    ab("bytes_dict_indices, its first 20,000 rows",
       lambda: lib.bytes_dict_indices(few.data, few.offsets, DICT_MAX_UNIQUES),
       lambda: _bytes_first_occurrence_dictionary(few))
    ab("plain_encode_bytearray, zone of write group 0",
       lambda: tplain.encode_plain(zone, T.BYTE_ARRAY),
       lambda: tplain.plain_encode_bytearray_plain(zone))
    bits = host_group["trip_distance"].view(np.uint64)

    def u64_probe():  # the oracle's first rows are int64 (np.unique's)
        firsts, indices = lib.u64_dict_indices(bits, DICT_MAX_UNIQUES)
        return firsts.astype(np.int64), indices

    ab("u64_dict_indices, trip_distance of write group 0", u64_probe,
       lambda: _first_occurrence_dictionary(bits))
    fare = host_group["fare_cents"]
    ab("delta_encode, fare_cents of write group 0", lambda: tdelta.encode_delta(fare, 32),
       lambda: tdelta.encode_delta_plain(fare, 32))
    levels = host_group["passenger_count"][1]
    ab("hybrid_encode, passenger_count def levels of write group 0",
       lambda: thybrid.encode_hybrid(levels, 1), lambda: thybrid.encode_hybrid_plain(levels, 1))
    keys = zspec.dictionary.to_list()[:20_000]
    ab("xxh64, 20,000 zone keys", lambda: [lib.xxh64(k) for k in keys],
       lambda: [xxh64(k) for k in keys])
    return out


# -- phase 5: kernel times at the main path's shapes ----------------------------


def hybrid_bytes(frozen) -> tuple[int, int]:
    """(runs, bytes the expansion must move) of a frozen hybrid batch: 16 B
    of run table a run, the packed payload of its bit-packed outputs and the
    int32 outputs."""
    runs = int(np.count_nonzero(frozen.buf[frozen.run_pad : 2 * frozen.run_pad]
                                != frozen.n_pad + 1))
    starts = frozen.buf[frozen.run_pad : frozen.run_pad + runs].astype(np.int64)
    counts = np.diff(np.append(starts, frozen.total))
    bp_values = int(counts[frozen.buf[:runs] == 0].sum())
    return runs, 16 * runs + (bp_values * frozen.width + 7) // 8 + 4 * frozen.total


def time_hybrid_shapes(taxi_path, sessions_path, dev, rows: dict, bw: float,
                       by_width: dict) -> None:
    """expand_hybrid's device time at every distinct main-path shape (taxi
    group 0's four dictionary-index batches, sessions' items group 0) and at
    the kernel check's six synthetic batches, each held bit for bit against
    the plain version first; with the bound and the main paths' launches at
    the shape's width (vendor_id and passenger_count share width 3)."""
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import prepare_chunk_plan, to_device

    batches = []
    for path, columns in ((taxi_path, ["vendor_id", "passenger_count", "trip_distance", "zone"]),
                          (sessions_path, ["items"])):
        with FileReader(path, device="cpu") as r:  # prepare touches no device
            for p, cc, column in r._selected_chunks(0, columns):
                plan = prepare_chunk_plan(r._window(cc), cc, column)
                batches.append((f"{path.name.split('-')[0]} {p[0]}", plan.frozen_hybrid[0], True))
    rng = np.random.default_rng(SEED + 8)
    for width in HYBRID_WIDTHS:
        batches.append((f"synthetic width {width}", hybrid_batch(rng, width, HYBRID_N)[0], False))
    shapes = []
    for label, fh, main in batches:
        buf = to_device(fh.buf.view(np.int32), dev)
        args = (buf, fh.width, fh.run_pad, fh.total)
        hold_plain(rows, "expand_hybrid", f"[{label}]", ops.expand_hybrid(*args),
                   ops.expand_hybrid_plain(*args))
        runs, nbytes = hybrid_bytes(fh)
        entry = {"shape": label, "width": fh.width, "total": fh.total, "runs": runs,
                 "ms": device_ms(lambda a=args: ops.expand_hybrid(*a)),
                 "bound_ms": nbytes / bw * 1e3,
                 "launches": by_width.get(fh.width, 0) if main else None}
        shapes.append(entry)
        log(f"  expand_hybrid [{label}] width {fh.width}, n={fh.total}, {runs} runs: "
            f"{entry['ms']:.5f} ms on the device, bound {entry['bound_ms']:.5f} ms "
            f"({nbytes} B); launches at width {fh.width} on the main paths: {entry['launches']}")
    rows["expand_hybrid"]["shapes"] = shapes


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
    runs, nbytes = hybrid_bytes(fh)
    buf = to_device(fh.buf.view(np.int32), dev)
    hargs = (buf, fh.width, fh.run_pad, fh.total)
    # ops: 3 per step of the run search plus ~12 for the two-word extract
    record("expand_hybrid",
           lambda: ops.expand_hybrid(*hargs), lambda: ops.expand_hybrid_plain(*hargs),
           nbytes, fh.total * (3 * max(runs, 1).bit_length() + 12))
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
    from parquet_tpu_torch.core.reader import FileReader

    profile_device(lambda: FileReader(path).read_row_groups_device())


def profile_device(fn) -> None:
    """torch.profiler over one call of `fn`: device time by kernel and copy,
    and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
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


# -- the query and multi-device paths --------------------------------------------

AGG_DTYPES = ("int32", "int64", "float32", "float64", "bool")
AGG_N = (0, 1, (1 << 20) + 3)
GRID_WIDTHS = (0, 1, 3, 12, 17, 32)


def agg_values(rng, dtype: str, n: int):
    """Values of one dtype with the payloads the kernel must carry: the
    signed extremes, patterns at and above 2**31 and 2**63 (the unsigned
    views), NaN, +-0.0 and +-inf; float sums on multiples of 1/4, exact in
    any order."""
    if dtype == "bool":
        return rng.random(n) < 0.5
    if dtype.startswith("float"):
        v = (rng.integers(-4000, 4000, n) / 4).astype(dtype)
        specials = [np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan]
        return v if n < 64 else np.concatenate([v[:-6], np.array(specials, dtype=dtype)])
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    if n >= 8:
        v[:6] = (info.min, info.max, -1, 0, info.min + 1, 1 << (info.bits - 2))
    return v


def agg_cases(rng, dev):
    """(label, values, mask, op, unsigned, bits) over every dtype, op and
    view at n = 0, 1 and 2**20 + 3, under a random, an all-false, an
    all-true and no mask. Float min/max run once on values with no NaN too,
    so the signed zeros decide."""
    import torch

    from parquet_tpu_torch.kernels.pipeline import to_device

    for dtype in AGG_DTYPES:
        views = [(False, None)]
        if dtype.startswith("int"):
            views += [(True, None), (True, 8), (True, 16)]
        for n in AGG_N:
            v = to_device(agg_values(rng, dtype, n), dev)
            masks = {"random": to_device(rng.random(n) < 0.6, dev),
                     "all-false": torch.zeros(n, dtype=torch.bool, device=dev),
                     "all-true": torch.ones(n, dtype=torch.bool, device=dev), "none": None}
            vals = [("", v)]
            if dtype.startswith("float") and n > 64:
                vals.append((" no-NaN", v[:-6].contiguous()))
            for tag, vv in vals:
                for mname, m in masks.items():
                    if m is not None and m.numel() != vv.numel():
                        m = m[: vv.numel()].contiguous()
                    for op in ("count", "sum", "min", "max"):
                        for uns, bits in views:
                            view = f" unsigned{'' if bits is None else bits}" if uns else ""
                            yield (f"{dtype}{tag}{view} n={vv.numel()} {mname} {op}",
                                   vv, m, op, uns, bits)


def grid_case(rng, width: int, n_out: int = 4096, pages: int = 6):
    """A page grid of `pages` hybrid pages at `width` (a single-run RLE page,
    ragged counts, real RLE runs between bit-packed ones) with one all-zero
    padding page, and a dictionary shorter than the index range (the clamp);
    at width 32 indices at and above 2**31 too."""
    from parquet_tpu_torch.ops.rle_hybrid import encode_hybrid, prescan_hybrid
    from parquet_tpu_torch.parallel.mesh import build_page_grid

    tables, takes = [], []
    for p in range(pages):
        n = n_out - 97 * p
        hi = 1 << width
        idx = (rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32) if width
               else np.zeros(n, np.uint32))
        if p == 0:
            idx[:] = idx[0]  # one RLE run
        else:
            for start in rng.integers(0, n - 64, size=4):
                idx[start : start + 40] = idx[start]
        tables.append(prescan_hybrid(encode_hybrid(idx, width), n, width))
        takes.append(n)
    g = build_page_grid(tables, takes, width, n_out)
    arrs = [np.pad(a, [(0, 1), (0, 0)]) for a in (g.words, g.starts, g.is_rle, g.values,
                                                     g.bit_starts)]
    return arrs, max(2, (1 << min(width, 20)) // 3)


def check_query_kernels(dev, rows: dict) -> None:
    """masked_agg and expand_page_grid against their plain versions
    (expand_page_grid also on testing/synth.page_grid_edge_cases)."""
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import to_device

    rng = np.random.default_rng(SEED + 6)
    count = 0
    for label, v, m, op, uns, bits in agg_cases(rng, dev):
        hold_plain(rows, "masked_agg", f"[{label}]",
                   ops.masked_agg(v, m, op, unsigned=uns, bits=bits),
                   ops.masked_agg_plain(v, m, op, unsigned=uns, bits=bits))
        count += 1
    log(f"  masked_agg: {count} cases (5 dtypes, 4 ops, unsigned and UINT_8/16 views, "
        f"n in {AGG_N}, random/all-false/all-true/no masks) equal to the plain version")
    for width in GRID_WIDTHS:
        arrs, d_len = grid_case(rng, width)
        grid = [to_device(a.view(np.int32), dev) for a in arrs]
        for dt in (np.int64, np.int32):
            d = to_device(rng.integers(-(2**30), 2**30, d_len).astype(dt), dev)
            hold_plain(rows, "expand_page_grid", f"[width {width}, {np.dtype(dt).name} D={d_len}]",
                       ops.expand_page_grid(*grid, d, width, 4096),
                       ops.expand_page_grid_plain(*grid, d, width, 4096))
        log(f"  expand_page_grid width={width:2d}: 7 pages (one RLE-only, ragged counts, one "
            f"all-padding) x 4096, dictionaries of {d_len} int64 and int32 keys: equal")
    from parquet_tpu_torch.testing.synth import page_grid_edge_cases

    cases = page_grid_edge_cases(ops.PAGE_GRID_TILE, ops.PAGE_GRID_ITEMS,
                                 ops.PAGE_GRID_STAGE_RUNS, SEED)
    for case in cases:
        grid = [to_device(a, dev) for a in case.grid]
        d = to_device(case.dictionary, dev)
        hold_plain(rows, "expand_page_grid", f"[{case.label}]",
                   ops.expand_page_grid(*grid, d, case.width, case.n_out),
                   ops.expand_page_grid_plain(*grid, d, case.width, case.n_out))
    log(f"  expand_page_grid: {len(cases)} edge cases equal to the plain version (widths 0, 1, "
        f"3, 12, 17 and 32: n_out off its {ops.PAGE_GRID_TILE}-output tile, runs shorter than "
        f"a thread's {ops.PAGE_GRID_ITEMS} outputs, more than {ops.PAGE_GRID_STAGE_RUNS} runs a "
        "tile, a page ending inside a tile, a padding page, bit starts that wrap or are "
        "negative, a first start above 0, is_rle 2, short int32 and int64 dictionaries)")


def query_aggregates():
    from parquet_tpu_torch.serve.protocol import aggregates_from_spec

    spec = ["count", ["count", "passenger_count"]]
    for c in QUERY_COLUMNS:
        spec += [["sum", c], ["min", c], ["max", c]]
    return aggregates_from_spec(spec)


QUERY_COLUMNS = ("fare_cents", "pickup_us", "vendor_id", "passenger_count")


def query_request(path, filters, aggregates=None, group_by=(), shard=None):
    from parquet_tpu_torch.serve.protocol import QueryRequest

    return QueryRequest(paths=[str(path)], filters=filters,
                        aggregates=query_aggregates() if aggregates is None else aggregates,
                        group_by=tuple(group_by), max_groups=10_000, shard=shard,
                        timeout_ms=None)


def query_want(specs, keep, groups: int) -> dict:
    """The query body NumPy gives over the generator's columns: int64 sums
    wrap as the device's do; min/max of no row are None."""
    s = {sp.name: sp for sp in specs}
    valid = s["passenger_count"].valid
    pc = np.zeros(len(valid), np.int64)
    pc[valid] = s["passenger_count"].indices
    cols = {"fare_cents": s["fare_cents"].values, "pickup_us": s["pickup_us"].values,
            "vendor_id": s["vendor_id"].dictionary[s["vendor_id"].indices], "passenger_count": pc}
    result = {"count": int(keep.sum()), "count(passenger_count)": int((keep & valid).sum())}
    for c in QUERY_COLUMNS:
        sel = keep & valid if c == "passenger_count" else keep
        x = cols[c][sel].astype(np.int64)
        result[f"sum({c})"] = int(x.sum()) if len(x) else None
        result[f"min({c})"] = int(x.min()) if len(x) else None
        result[f"max({c})"] = int(x.max()) if len(x) else None
    return {"group_by": [], "aggregates": list(result), "units": groups,
            "rows_scanned": groups * RG_ROWS, "rows_matched": int(keep.sum()), "result": result}


def run_query(path, filters, device=None, shard=None):
    from parquet_tpu_torch.serve.aggregate import run_local_query

    q = query_request(path, filters, shard=shard)
    return run_local_query(q.paths, q, device=device)


def check_query_declines(path, device=None) -> None:
    """group_by and a float sum decline, typed and counted."""
    from parquet_tpu_torch.serve.aggregate import (
        query_device_counts,
        reset_query_device_counts,
        run_local_query,
    )
    from parquet_tpu_torch.serve.protocol import ServeError, aggregates_from_spec

    for label, q in (("group_by vendor_id", query_request(path, None, group_by=("vendor_id",))),
                     ("sum(trip_distance)", query_request(
                         path, None, aggregates_from_spec([["sum", "trip_distance"]])))):
        reset_query_device_counts()
        try:
            run_local_query(q.paths, q, device=device)
        except ServeError as e:
            if e.code != "device_declined":
                raise
            got = query_device_counts()
            if got != {"declined": 1}:
                raise AssertionError(f"{label}: query counts {got}") from None
            log(f"[query:taxi] {label}: declined, typed ({e.status} {e.code}) and counted {got}")
            continue
        raise AssertionError(f"{label} did not decline")


def index_page_grid(path, column: str):
    """The PageGrid of a required dictionary-encoded column's V1 data pages
    (every row group): each page decompressed, its bit-width byte read, its
    hybrid stream prescanned. Returns (grid, per-page value counts, the
    host dictionary)."""
    from parquet_tpu_torch.core.chunk import iter_chunk_pages
    from parquet_tpu_torch.core.compress import decompress_block
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.meta.parquet_types import PageType
    from parquet_tpu_torch.ops.rle_hybrid import prescan_hybrid
    from parquet_tpu_torch.parallel.mesh import build_page_grid

    tables, takes, widths = [], [], set()
    with FileReader(path, device="cpu") as r:  # host work only: the footer and pages
        for i in range(r.num_row_groups):
            for _path, cc, _col in r._selected_chunks(i, [column]):
                for page in iter_chunk_pages(r._window(cc), cc):
                    if page.header.type != PageType.DATA_PAGE:
                        continue
                    block = decompress_block(page.payload, cc.meta_data.codec,
                                             page.header.uncompressed_page_size)
                    n = page.header.data_page_header.num_values
                    width = block[0]
                    widths.add(width)
                    tables.append(prescan_hybrid(bytes(block[1:]), n, width))
                    takes.append(n)
    if len(widths) != 1:
        raise AssertionError(f"{column}: index pages of widths {sorted(widths)}")
    return build_page_grid(tables, takes, widths.pop(), max(takes)), takes


SCAN_COLUMNS = ("trip_id", "vendor_id", "passenger_count", "pickup_us", "fare_cents",
                "trip_distance")


def scan_want(specs) -> dict:
    """column_stats' answer over the generator's columns: NumPy scalars of the
    leaf's dtype, counts of non-null values."""
    s = {sp.name: sp for sp in specs}
    vals = {"trip_id": s["trip_id"].values, "pickup_us": s["pickup_us"].values,
            "fare_cents": s["fare_cents"].values,
            "vendor_id": s["vendor_id"].dictionary[s["vendor_id"].indices],
            "passenger_count": np.arange(7, dtype=np.int32)[s["passenger_count"].indices],
            "trip_distance": s["trip_distance"].dictionary[s["trip_distance"].indices]}
    return {(c,): {"min": vals[c].min(), "max": vals[c].max(), "count": len(vals[c])}
            for c in SCAN_COLUMNS}


def stats_equal(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        type(got[k][f]) is type(want[k][f]) and got[k][f] == want[k][f]
        for k in want for f in ("min", "max", "count"))


def check_scans(taxi_path, specs, dev, launches: dict) -> dict:
    """The scan phase at world size 1, in an NCCL group of one rank opened
    through a file store: column_stats and distributed_column_stats over the
    numeric leaves, sharded_decode_step over trip_distance's real index
    pages, and the three steps of the entry point's check. Every answer is
    held against NumPy over the generator's columns. Returns what the
    times phase reuses."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.parallel.mesh import sharded_decode_step
    from parquet_tpu_torch.parallel.scan import column_stats, distributed_column_stats
    from parquet_tpu_torch.testing.dist import decode_step, mesh_step, train_step

    def counted(label, fn):
        ops.reset_launch_counts()
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches[label] = kernel_counts()
        return out, time.perf_counter() - t

    want = scan_want(specs)
    s = {sp.name: sp for sp in specs}
    store = tempfile.mkdtemp(prefix="pqt-store-")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        with FileReader(taxi_path, device=dev) as r:
            got, secs = counted("scan column_stats",
                                lambda: column_stats(r, [dev], columns=list(SCAN_COLUMNS)))
            if not stats_equal(got, want):
                raise AssertionError(f"column_stats {got} != NumPy's {want}")
            if dev.type == "cuda" and launches["scan column_stats"]["masked_agg"] <= 0:
                raise AssertionError("masked_agg was not launched by column_stats")
            log(f"[scan:taxi] column_stats(reader, [{dev}]) over {len(want)} numeric leaves: "
                f"{secs:.2f} s, equal to NumPy; masked_agg launches "
                f"{launches['scan column_stats']['masked_agg']}")
            got, secs = counted("scan distributed", lambda: distributed_column_stats(
                r, columns=list(SCAN_COLUMNS), group=group))
            if not stats_equal(got, want):
                raise AssertionError(f"distributed_column_stats {got} != NumPy's {want}")
            log(f"[scan:taxi] distributed_column_stats(group=NCCL world 1): {secs:.2f} s, "
                "equal to NumPy")
            collectives = time_collectives(got, group, dev)
        grid, takes = index_page_grid(taxi_path, "trip_distance")
        dist_dict = s["trip_distance"].dictionary
        idx_all = s["trip_distance"].indices
        n_out = max(takes)
        (decoded, st), secs = counted("sharded decode", lambda: sharded_decode_step(
            group, grid, dist_dict, n_out, device=dev))
        dec = decoded.cpu().numpy()
        col = dist_dict[idx_all]
        off = np.concatenate([[0], np.cumsum(takes)])
        for p, k in enumerate(takes):
            if not np.array_equal(dec[p, :k], col[off[p] : off[p + 1]]):
                raise AssertionError(f"sharded_decode_step page {p} differs from the generator")
        if dev.type == "cuda" and not all(launches["sharded decode"][k] > 0
                                          for k in ("expand_page_grid", "masked_agg")):
            raise AssertionError("sharded_decode_step did not launch its kernels")
        sw = {"min": col.min(), "max": col.max(), "count": len(col)}
        sg = {k: v.cpu().numpy()[()] for k, v in st.items()}
        if any(sg[k] != sw[k] for k in sw):
            raise AssertionError(f"sharded_decode_step stats {sg} != NumPy's {sw}")
        log(f"[scan:taxi] sharded_decode_step over trip_distance's {grid.num_pages} index pages "
            f"(width {grid.width}, up to {n_out} values, {len(dist_dict)} double keys): "
            f"{secs:.2f} s; every page's prefix equals the generator's, stats {sg} equal "
            "NumPy's; launches expand_page_grid "
            f"{launches['sharded decode']['expand_page_grid']}, masked_agg "
            f"{launches['sharded decode']['masked_agg']}")
        # the entry point's check at world size 1: decode_step over the same
        # pages with an int64 dictionary (an exact checksum), the pages x
        # cols step on a 1 x 1 mesh, train_step over sharded batches
        rng = np.random.default_rng(SEED + 24)
        int_dict = rng.integers(-(2**40), 2**40, len(dist_dict)).astype(np.int64)
        mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("pages", "cols"))

        def steps():
            d_out, d_st = decode_step(grid, int_dict, n_out, device=dev)
            stacked = [a[None] for a in (grid.words, grid.starts, grid.is_rle, grid.values,
                                         grid.bit_starts, grid.counts)]
            m_out = mesh_step(mesh, *stacked, int_dict[None], grid.width, n_out, device=dev)
            total = torch.zeros(2, dtype=torch.int64, device=dev)
            with FileReader(taxi_path, device=dev) as r:
                for b in r.iter_device_batches(BATCH, ["passenger_count", "fare_cents"],
                                               nullable="mask", drop_remainder=False,
                                               sharding=group):
                    total += train_step(b, group, x=("passenger_count",), a=("fare_cents",))
            return d_out, d_st, m_out, total

        (d_out, d_st, (m_dec, m_cnt, m_sums), total), secs = counted("entry steps", steps)
        checksum = int(int_dict[idx_all].sum())
        valid = s["passenger_count"].valid
        want_train = [int(s["passenger_count"].indices.astype(np.int64).sum())
                      + int(s["fare_cents"].values.astype(np.int64).sum()), int(valid.sum())]
        got_steps = (int(d_st["count"]), int(d_st["checksum"]), int(m_cnt),
                     m_sums.cpu().tolist(), total.cpu().tolist())
        want_steps = (len(idx_all), checksum, len(idx_all), [checksum], want_train)
        if got_steps != want_steps or not torch.equal(d_out, m_dec):
            raise AssertionError(f"entry steps {got_steps} != NumPy's {want_steps}")
        log(f"[scan:taxi] the entry's steps at world size 1 ({secs:.2f} s): decode_step count "
            f"{got_steps[0]} checksum {got_steps[1]}, the 1 x 1 pages x cols step equal, "
            f"train_step over iter_device_batches(sharding=NCCL world 1) {got_steps[4]}: "
            "equal to NumPy")
    finally:
        dist.destroy_process_group()
    check_gloo_on_card(dev)
    return {"grid": grid, "n_out": n_out, "dist_dict": dist_dict, "collectives": collectives}


# NVLink's rate each way between two cards of one host (H100 SXM data sheet)
NVLINK_BYTES_PER_S = 450e9


def time_collectives(stats: dict, group, dev) -> dict:
    """The collectives of one stats scan (mesh_reduce_stats: MIN, MAX and SUM
    of one element per numeric leaf), timed with CUDA events around eager
    calls: the bare all_reduces alone, and mesh_reduce_stats with its
    per-value copies. The bound is their bytes at NVLink's rate each way."""
    import torch
    import torch.distributed as dist

    from parquet_tpu_torch.parallel.scan import mesh_reduce_stats

    parts = {p: {k: torch.from_numpy(np.asarray(v[k])).to(dev) for k in ("min", "max", "count")}
             for p, v in stats.items()}
    flat = [(t, op) for v in parts.values()
            for t, op in ((v["min"], dist.ReduceOp.MIN), (v["max"], dist.ReduceOp.MAX),
                          (v["count"], dist.ReduceOp.SUM))]
    bufs = [t.reshape(1).clone() for t, _ in flat]

    def bare():
        for b, (_, op) in zip(bufs, flat):
            dist.all_reduce(b, op=op, group=group)

    nbytes = sum(b.element_size() for b in bufs)
    out = {"count": len(flat), "bytes": nbytes, "all_reduce_ms": events_ms(bare),
           "mesh_reduce_stats_ms": events_ms(lambda: mesh_reduce_stats(parts, group)),
           "bound_ms": nbytes / NVLINK_BYTES_PER_S * 1e3, "bound_by": "bytes (latency-bound)",
           "world_size": dist.get_world_size(group)}
    log(f"[scan:taxi] one stats scan's {out['count']} one-element all_reduces "
        f"({dist.get_backend(group)}, world {out['world_size']}): {out['all_reduce_ms']:.4f} ms "
        "a scan by CUDA events; "
        f"mesh_reduce_stats {out['mesh_reduce_stats_ms']:.4f} ms; bound {nbytes} B at 450 GB/s "
        f"= {out['bound_ms']:.2e} ms: latency-bound")
    return out


def check_gloo_on_card(dev) -> None:
    """mesh_reduce_stats over two ranks spawned on this machine (gloo, both
    on the one card), each with its own partials, a NaN among them: the
    reduction must skip the NaN and equal NumPy's."""
    from parquet_tpu_torch.testing.dist import run_checks, spawn

    partials = [
        {("f",): {"min": np.float64(-1.5), "max": np.float64(2.0), "count": np.int64(3)},
         ("x",): {"min": np.int64(-7), "max": np.int64(2**40), "count": np.int64(5)}},
        {("f",): {"min": np.float64(np.nan), "max": np.float64(np.nan), "count": np.int64(4)},
         ("x",): {"min": np.int64(-(2**62)), "max": np.int64(9), "count": np.int64(6)}},
    ]
    want = {("f",): {"min": -1.5, "max": 2.0, "count": 7},
            ("x",): {"min": -(2**62), "max": 2**40, "count": 11}}
    t = time.perf_counter()
    out = spawn(run_checks, 2, {"reduce": [(partials, 1)], "device": str(dev)}, timeout=300.0)
    got = [o["reduce"][0] for o in out]
    if any({k: {f: v.item() for f, v in s.items()} for k, s in g.items()} != want for g in got):
        raise AssertionError(f"gloo mesh_reduce_stats on the card: {got} != {want}")
    log(f"[scan] mesh_reduce_stats over 2 spawned gloo ranks on {dev}: {time.perf_counter() - t:.1f} s "
        "(the spawns included), the NaN partial skipped, equal to NumPy on both ranks")


def time_query_kernels(taxi_path, f_taxi, scan, dev, rows: dict, bw: float) -> None:
    """Device times of masked_agg on the query's shape (pickup_us of row
    group 0 under F_taxi's mask: 2**20 int64 and a bool mask) and of
    expand_page_grid on trip_distance's real index pages and on a grid of
    many runs a page (grid_case at width 3, 16 pages x GRID_MULTI_OUT),
    each held against its plain version on the inputs it is timed on."""
    import torch

    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import to_device

    with FileReader(taxi_path) as r:
        cols, mask = r.read_row_group_device(0, ["pickup_us"], filters=f_taxi)
    v = cols[("pickup_us",)].values
    n = v.numel()
    # bytes: the values and the mask read once, 8 written; ops: a compare
    # and an add a row
    record_kernel(rows, "masked_agg", lambda: ops.masked_agg(v, mask, "sum"),
                  lambda: ops.masked_agg_plain(v, mask, "sum"), 9 * n + 8, 2 * n, bw,
                  lib=lambda: torch.where(mask, v, 0).sum(),
                  shape=f"taxi pickup_us group 0 under F_taxi, n={n} int64 + bool mask, sum")
    imax = torch.iinfo(torch.int64).max
    t_min = {"ms": device_ms(lambda: ops.masked_agg(v, mask, "min")),
             "library_ms": device_ms(lambda: torch.where(mask, v, imax).min())}
    hold_plain(rows, "masked_agg", "[min, the same inputs]", ops.masked_agg(v, mask, "min"),
               ops.masked_agg_plain(v, mask, "min"))
    rows["masked_agg"]["min"] = t_min
    log(f"  masked_agg min on the same inputs: {t_min['ms']:.4f} ms, library "
        f"(torch.where(mask, v, INT64_MAX).min()) {t_min['library_ms']:.4f} ms")
    grid, n_out = scan["grid"], scan["n_out"]
    args = [to_device(a.view(np.int32), dev) for a in (grid.words, grid.starts, grid.is_rle,
                                                       grid.values, grid.bit_starts)]
    d = to_device(scan["dist_dict"].view(np.int64), dev)
    out_bytes = grid.num_pages * n_out * 8
    in_bytes = sum(a.numel() * 4 for a in args) + d.numel() * 8
    # bytes: the grid's words and run tables and the dictionary read once,
    # the decoded values written; ops: a binary search over the page's runs
    # and ~15 for the extract and the gather, per output
    runs = grid.starts.shape[1]
    record_kernel(rows, "expand_page_grid",
                  lambda: ops.expand_page_grid(*args, d, grid.width, n_out),
                  lambda: ops.expand_page_grid_plain(*args, d, grid.width, n_out),
                  in_bytes + out_bytes, grid.num_pages * n_out * (15 + 2 * runs.bit_length()),
                  bw, shape=f"taxi trip_distance index pages: {grid.num_pages} x {n_out}, "
                  f"{runs} runs, {grid.words.shape[1]} words, width {grid.width}")
    # a grid of many runs a page: width 3, RLE runs between bit-packed ones
    arrs, d_len = grid_case(np.random.default_rng(SEED + 14), 3, n_out=GRID_MULTI_OUT, pages=16)
    margs = [to_device(a.view(np.int32), dev) for a in arrs]
    md = to_device(np.random.default_rng(SEED + 15).integers(-(2**40), 2**40, d_len), dev)
    m_pages, m_runs = arrs[0].shape[0], arrs[1].shape[1]
    record_shape(rows, "expand_page_grid",
                 lambda: ops.expand_page_grid(*margs, md, 3, GRID_MULTI_OUT),
                 lambda: ops.expand_page_grid_plain(*margs, md, 3, GRID_MULTI_OUT),
                 sum(a.numel() * 4 for a in margs) + md.numel() * 8
                 + m_pages * GRID_MULTI_OUT * 8,
                 m_pages * GRID_MULTI_OUT * (15 + 2 * m_runs.bit_length()), bw,
                 shape=f"grid_case width 3: {m_pages} x {GRID_MULTI_OUT} (16 pages and a "
                 f"padding page), {m_runs} runs, {arrs[0].shape[1]} words, {d_len} int64 keys")


# expand_page_grid's multi-run timed shape: outputs a page
GRID_MULTI_OUT = 1 << 19


# -- the multi-rank check (python3 chip_smoke.py --ranks N, one card a rank) ----


def entry_grid(rng, n_pages: int, out_per_page: int, dict_size: int):
    """The entry point's padded page grid (slightly ragged pages of random
    dictionary indices, hybrid-encoded) from the port's encoder, its int64
    dictionary and each page's indices."""
    from parquet_tpu_torch.ops.rle_hybrid import encode_hybrid, prescan_hybrid
    from parquet_tpu_torch.parallel.mesh import build_page_grid

    width = max((dict_size - 1).bit_length(), 1)
    tables, takes, idx = [], [], []
    for p in range(n_pages):
        n = out_per_page - (p % 5)
        i = rng.integers(0, dict_size, n, dtype=np.uint32)
        tables.append(prescan_hybrid(encode_hybrid(i, width), n, width))
        takes.append(n)
        idx.append(i)
    grid = build_page_grid(tables, takes, width, out_per_page)
    return grid, rng.integers(0, 1 << 40, dict_size).astype(np.int64), idx


def stacked_grids(grids, dicts, out_per_page: int):
    """(cols, pages, ...) arrays of one grid a column, padded to a common run
    and word count as the reference's dry run pads them (starts with
    out_per_page + 1)."""
    def stack(attr, fill=0):
        arrs = [getattr(g, attr) for g in grids]
        if arrs[0].ndim == 1:
            return np.stack(arrs)
        dim = max(a.shape[-1] for a in arrs)
        return np.stack([np.pad(a, [(0, 0), (0, dim - a.shape[-1])], constant_values=fill)
                         for a in arrs])

    return (stack("words"), stack("starts", out_per_page + 1), stack("is_rle"),
            stack("values"), stack("bit_starts"), stack("counts"), np.stack(dicts),
            grids[0].width, out_per_page)


def dry_file(path) -> dict:
    """The entry point's dry-run file: int64 a (50 values), int64 ts (DELTA,
    rising), optional int64 x (every fifth row null), 4 groups of 2,048 rows;
    returns its columns."""
    from parquet_tpu_torch.meta.parquet_types import CompressionCodec as C
    from parquet_tpu_torch.meta.parquet_types import Encoding as E
    from parquet_tpu_torch.meta.parquet_types import Type as T
    from parquet_tpu_torch.testing.synth import ColumnSpec, write_file

    n = 8_192
    rng = np.random.default_rng(7)
    cols = {"a": rng.integers(0, 50, n).astype(np.int64),
            "ts": (10_000 + np.cumsum(rng.integers(0, 9, n))).astype(np.int64),
            "x": rng.integers(0, 99, n).astype(np.int64), "valid": np.arange(n) % 5 != 0}
    write_file(path, [
        ColumnSpec("a", T.INT64, values=cols["a"], codec=C.SNAPPY),
        ColumnSpec("ts", T.INT64, values=cols["ts"], encoding=E.DELTA_BINARY_PACKED,
                   codec=C.SNAPPY),
        ColumnSpec("x", T.INT64, values=cols["x"][cols["valid"]], valid=cols["valid"],
                   codec=C.SNAPPY),
    ], row_group_rows=2048)
    return cols


def check_ranks(world: int, backend: str = "nccl", device: str = "cuda") -> None:
    """The multi-rank paths over `world` ranks, one card a rank (rank k on
    card k), against NumPy: mesh_reduce_stats of per-rank partials (a NaN
    among them), distributed_column_stats over taxi's numeric leaves,
    sharded_decode_step over trip_distance's real index pages, and, at 4
    ranks, the entry point's three steps over a 2 x 2 DeviceMesh and
    distributed_column_stats over it."""
    from parquet_tpu_torch.testing.dist import run_checks, spawn

    specs = taxi_columns(SEED)
    taxi_path = smoke_file(specs, "taxi")
    s = {sp.name: sp for sp in specs}
    grid, takes = index_page_grid(taxi_path, "trip_distance")
    dist_dict = s["trip_distance"].dictionary
    partials = [{("f",): {"min": np.float64(np.nan if k == 1 else -k - 0.5),
                          "max": np.float64(np.nan if k == 1 else 2.0 * k),
                          "count": np.int64(k + 1)},
                 ("x",): {"min": np.int64(-(2**62) + k), "max": np.int64(2**40 * k),
                          "count": np.int64(3)}} for k in range(world)]
    fin = [k for k in range(world) if k != 1]
    want_reduce = {("f",): {"min": min(-k - 0.5 for k in fin), "max": max(2.0 * k for k in fin),
                            "count": sum(k + 1 for k in range(world))},
                   ("x",): {"min": -(2**62), "max": 2**40 * (world - 1), "count": 3 * world}}
    spec = {"device": device, "reduce": [(partials, 1)],
            "stats": [(str(taxi_path), list(SCAN_COLUMNS), None)],
            "decode": [(grid, dist_dict, max(takes))]}
    rng = np.random.default_rng(SEED + 4)
    if world == 4:
        eg, ed, eidx = entry_grid(rng, 4, 2048, 100)
        cgrids = [entry_grid(np.random.default_rng(SEED + 40 + c), 4, 512, 64) for c in range(2)]
        dry = dry_file(smoke_dir() / "dry.parquet")
        spec["steps"] = (eg, ed, 2048, stacked_grids([g for g, _, _ in cgrids],
                                                     [d for _, d, _ in cgrids], 512),
                         str(smoke_dir() / "dry.parquet"))
    t = time.perf_counter()
    out = spawn(run_checks, world, spec, backend=backend, timeout=900.0)
    log(f"[ranks] {world} {backend} ranks on {device}: {time.perf_counter() - t:.1f} s, the "
        "spawns included")
    for k, o in enumerate(out):
        got = {p: {f: v.item() for f, v in st.items()} for p, st in o["reduce"][0].items()}
        if got != want_reduce:
            raise AssertionError(f"rank {k}: mesh_reduce_stats {got} != {want_reduce}")
        if not stats_equal(o["stats"][0], scan_want(specs)):
            raise AssertionError(f"rank {k}: distributed_column_stats {o['stats'][0]}")
    log(f"[ranks] mesh_reduce_stats (a NaN partial skipped) and distributed_column_stats over "
        f"taxi's {len(SCAN_COLUMNS)} numeric leaves equal NumPy's on every rank")
    decoded = np.concatenate([o["decode"][0][0] for o in out])
    col = dist_dict[s["trip_distance"].indices]
    off = np.concatenate([[0], np.cumsum(takes)])
    for p, k in enumerate(takes):
        if not np.array_equal(decoded[p, :k], col[off[p] : off[p + 1]]):
            raise AssertionError(f"sharded_decode_step page {p} differs from the generator")
    sw = {"min": col.min(), "max": col.max(), "count": len(col)}
    for k, o in enumerate(out):
        if any(o["decode"][0][1][f] != sw[f] for f in sw):
            raise AssertionError(f"rank {k}: sharded_decode_step stats {o['decode'][0][1]}")
    log(f"[ranks] sharded_decode_step over trip_distance's {grid.num_pages} pages, "
        f"{decoded.shape[0] // world} a rank: every page equals the generator's, stats equal "
        "NumPy's on every rank")
    if world != 4:
        return
    checksum = int(sum(int(ed[i].sum()) for i in eidx))
    col_sums = [int(sum(int(d[i].sum()) for i in idx)) for _, d, idx in cgrids]
    col_counts = [sum(len(i) for i in idx) for _, _, idx in cgrids]
    x, valid = dry["x"], dry["valid"]
    want_train = [int(x[valid].sum()) + int(dry["a"].sum()), int(valid.sum())]
    want_dry = {("a",): {"min": dry["a"].min(), "max": dry["a"].max(), "count": 8192},
                ("ts",): {"min": dry["ts"].min(), "max": dry["ts"].max(), "count": 8192}}
    for k, o in enumerate(out):
        st = o["steps"]
        pi, ci = divmod(k, 2)
        got = (int(st["decode"][1]["count"]), int(st["decode"][1]["checksum"]),
               int(st["mesh"][1]), st["mesh"][2].tolist(), st["train"].tolist())
        want = (sum(len(i) for i in eidx), checksum, col_counts[ci], col_sums, want_train)
        if got != want or not stats_equal(st["stats"], want_dry):
            raise AssertionError(f"rank {k}: entry steps {got} != {want} or stats {st['stats']}")
    log("[ranks] the entry's three steps over a 2 x 2 (pages, cols) DeviceMesh (decode_step, "
        "psum over pages + all_gather over cols, train_step over sharded batches) and "
        "distributed_column_stats over the mesh equal NumPy's on every rank")


# -- the overlap layer: serial against pipelined, in one call --------------------

# (label, environment): prepare serially on the calling thread (dispatch
# still on its thread), and prepare on the pqt-host pool
OVERLAP_VARIANTS = (("serial", {"PQT_HOST_THREADS": "1"}), ("pipelined", {}))


class env_set:
    """Set (or, with None, unset) environment variables for a block."""

    def __init__(self, **values):
        self.values = values
        self.saved: dict = {}

    def __enter__(self):
        for k, v in self.values.items():
            self.saved[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def variant_env(env: dict) -> env_set:
    """A variant's environment, the other variants' knobs unset."""
    knobs = {k: None for _, e in OVERLAP_VARIANTS for k in e}
    knobs.update(env)
    return env_set(**knobs)


def groups_equal(a, b) -> bool:
    """Two reads' [{path: DeviceColumn}] equal field by field, on the card."""
    import torch

    if len(a) != len(b):
        return False
    for ga, gb in zip(a, b):
        if ga.keys() != gb.keys():
            return False
        for p in ga:
            x, y = ga[p], gb[p]
            if x.num_values != y.num_values:
                return False
            for f in ("values", "indices", "data", "offsets", "dict_data", "dict_offsets"):
                u, v = getattr(x, f), getattr(y, f)
                if (u is None) != (v is None):
                    return False
                if u is not None and f == "data" and x.offsets is not None:
                    # a merged byte column's payload is sized to its bound:
                    # the bytes past the last offset are unspecified
                    end = int(x.offsets[-1])
                    u, v = u[:end], v[:end]
                if u is not None and not (u.dtype == v.dtype and u.shape == v.shape
                                          and torch.equal(u, v)):
                    return False
            for f in ("def_levels", "rep_levels"):
                u, v = getattr(x, f), getattr(y, f)
                if (u is None) != (v is None) or (u is not None and not np.array_equal(u, v)):
                    return False
    return True


def prepare_pooled(path) -> float:
    """Seconds of host prepare alone over a whole file on the pqt-host pool
    (every chunk submitted at once, nothing dispatched): the fused walk's
    thread scaling, beside prepare_alone's one thread."""
    from parquet_tpu_torch.core.reader import FileReader, _host_pool
    from parquet_tpu_torch.kernels.pipeline import prepare_chunk_plan

    pool = _host_pool()
    t = time.perf_counter()
    with FileReader(path, device="cpu") as r:
        futs = [pool.submit(prepare_chunk_plan, r._window(cc), cc, column)
                for i in range(r.num_row_groups) for _p, cc, column in r._selected_chunks(i)]
        for f in futs:
            f.result(timeout=600)
    return time.perf_counter() - t


def ratios(rates: dict) -> str:
    """Each variant's rate over the serial one's."""
    return ", ".join(f"{v} / serial {r / rates['serial']:.3f}" for v, r in rates.items()
                     if v != "serial")


def ab_overlap(paths: dict, taxi_batches, dev) -> dict:
    """The one-call A/B of the overlap layer: read_row_groups_device of taxi,
    taxi_mixed and sessions and the taxi batch stream under each of
    OVERLAP_VARIANTS, a warm-up each, then 3 rounds in rotating order, each
    read ending in torch.cuda.synchronize(). Every warm-up read is held
    against the generator's columns and every timed read bit-equal to it on
    the card; every batch stream's step totals equal the generator's. Also
    host prepare alone, one thread against the pool, per file. Returns
    {target: {variant: rows/s}} and the seconds behind them."""
    import torch

    from parquet_tpu_torch.core.reader import FileReader, _host_pool

    n_rows = ROW_GROUPS * RG_ROWS
    checks = {"taxi": (check_main_path, True), "taxi_mixed": (check_main_path, False),
              "sessions": (check_sessions, True)}
    out: dict = {"cpu_count": os.cpu_count(),
                 "host_threads": getattr(_host_pool(), "_max_workers", 1)}
    log(f"[overlap] host: os.cpu_count() = {os.cpu_count()}, pqt-host pool of "
        f"{out['host_threads']} threads; variants: "
        + "; ".join(f"{label} {env or '(defaults)'}" for label, env in OVERLAP_VARIANTS))
    for label, (path, specs) in paths.items():
        check, no_fallback = checks[label]
        ref = None
        secs: dict = {v: [] for v, _ in OVERLAP_VARIANTS}

        def read():
            r = FileReader(path)
            groups = r.read_row_groups_device()
            torch.cuda.synchronize()
            return groups, r.stats

        for v, env in OVERLAP_VARIANTS:
            with variant_env(env):
                groups, stats = read()
            check(groups, specs, stats, no_fallback)
            if ref is None:
                ref = groups
            elif not groups_equal(groups, ref):
                raise AssertionError(f"[overlap] {label}, {v}: the read differs from the serial one")
            del groups
        for rnd in range(3):
            k = rnd % len(OVERLAP_VARIANTS)
            order = OVERLAP_VARIANTS[k:] + OVERLAP_VARIANTS[:k]
            for v, env in order:
                with variant_env(env):
                    t = time.perf_counter()
                    groups, _stats = read()
                    secs[v].append(time.perf_counter() - t)
                if not groups_equal(groups, ref):
                    raise AssertionError(f"[overlap] {label}, {v}: a timed read differs")
                del groups
        del ref
        rates = {v: n_rows / statistics.median(x) for v, x in secs.items()}
        out[f"{label} read"] = {"rows_per_s": rates, "seconds": secs}
        log(f"[overlap] {label} read_row_groups_device: " + ", ".join(
            f"{v} {rates[v]:,.0f} rows/s (median of {[round(x, 3) for x in secs[v]]} s)"
            for v in secs)
            + "; " + ratios(rates) + "; every read bit-equal to the generator's columns")
    path, kwargs, step, want = taxi_batches
    secs = {v: [] for v, _ in OVERLAP_VARIANTS}
    for rnd in range(4):
        k = rnd % len(OVERLAP_VARIANTS)
        order = OVERLAP_VARIANTS[k:] + OVERLAP_VARIANTS[:k]
        for v, env in order:
            with variant_env(env):
                t = time.perf_counter()
                got, _n = run_batches(path, kwargs, step)
                dt = time.perf_counter() - t
            if got != want:
                raise AssertionError(f"[overlap] taxi batches, {v}: totals {got} != {want}")
            if rnd:  # round 0 is the warm-up
                secs[v].append(dt)
    rates = {v: n_rows / statistics.median(x) for v, x in secs.items()}
    out["taxi batches"] = {"rows_per_s": rates, "seconds": secs}
    log("[overlap] taxi iter_device_batches: " + ", ".join(
        f"{v} {rates[v]:,.0f} rows/s (median of {[round(x, 3) for x in secs[v]]} s)"
        for v in secs) + "; " + ratios(rates) + "; every stream's step totals equal the "
        "generator's")
    for label, (path, _specs) in paths.items():
        prepare_pooled(path)
        one = statistics.median(prepare_alone(path, True) for _ in range(3))
        pooled = statistics.median(prepare_pooled(path) for _ in range(3))
        out[f"{label} prepare"] = {"one_thread_s": one, "pool_s": pooled}
        log(f"[overlap] {label} host prepare alone (fused walk): one thread {one:.3f} s, "
            f"pool {pooled:.3f} s (medians of 3), scaling {one / pooled:.2f}x on "
            f"{out['host_threads']} threads")
    return out


def profile_overlap(path, dev) -> dict:
    """torch.profiler over one pipelined read of `path`, read from its
    Chrome trace: each H2D copy's kind (Pinned or Pageable -> Device) and
    stream, the streams of the kernels (expand_hybrid and the DELTA decode
    launch on the dispatch stream, dict_gather from device_column on the
    caller's), the device's busy share of the wall time, and the copy time
    that overlaps a kernel. Fails when the profiler recorded no kernel or
    no H2D copy (the read makes both, so nothing would have been checked),
    on an H2D copy that is not from pinned memory, when no H2D copy ran on
    the dispatch stream, or when the dispatched kernels share the caller's
    stream. Returns the summary."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from parquet_tpu_torch.core.reader import FileReader

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        FileReader(path).read_row_groups_device()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    with tempfile.TemporaryDirectory() as d:
        trace = Path(d) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text()).get("traceEvents", [])
    dev_ev = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]

    def stream(e):
        return (e.get("args") or {}).get("stream")

    def union(spans):
        total = 0.0
        end = None
        for a, b in sorted(spans):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    def intersect(xs, ys):
        # total length of the union of xs that lies inside the union of ys
        ys = sorted(ys)
        merged = []
        for a, b in ys:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        total = 0.0
        for a, b in xs:
            for c, d in merged:
                if d <= a:
                    continue
                if c >= b:
                    break
                total += min(b, d) - max(a, c)
        return total

    spans = [(e["ts"], e["ts"] + e["dur"]) for e in dev_ev]
    h2d = [e for e in dev_ev if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    kernels = [e for e in dev_ev if e["cat"] == "kernel"]
    if not kernels or not h2d:
        raise AssertionError(
            f"[overlap] the profiler recorded {len(kernels)} kernels and {len(h2d)} H2D copies "
            f"in a read that makes both: the copies' kind and stream cannot be checked")
    kinds = collections.Counter(e["name"] for e in h2d)
    copy_streams = collections.Counter(stream(e) for e in h2d)
    def short(name):
        # "void (anonymous namespace)::expand<12>(unsigned int const*, ...)" -> "expand"
        name = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
        return re.split(r"[<(]", name, maxsplit=1)[0][:40]

    kernel_streams: dict = collections.defaultdict(collections.Counter)
    for e in kernels:
        kernel_streams[stream(e)][short(e["name"])] += 1
    # expand_hybrid.cu's `expand` and delta_packed_decode.cu's `decode`
    # (anonymous namespaces) launch from dispatch_device
    dispatch_streams = {stream(e) for e in kernels
                        if re.search(r"::(expand|decode)\b", e["name"])}
    caller_streams = {stream(e) for e in kernels if "dict_gather" in e["name"]}
    busy = union(spans)
    copy_us = union([(e["ts"], e["ts"] + e["dur"]) for e in h2d])
    overlap_us = intersect([(e["ts"], e["ts"] + e["dur"]) for e in h2d],
                           [(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    on_dispatch = sum(c for s_, c in copy_streams.items() if s_ in dispatch_streams)
    summary = {
        "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "busy_share": busy / wall_us,
        "h2d_copies": len(h2d), "h2d_kinds": dict(kinds), "h2d_ms": copy_us / 1e3,
        "h2d_by_stream": {str(k): v for k, v in copy_streams.items()},
        "h2d_on_dispatch_stream": on_dispatch,
        "dispatch_streams": sorted(map(str, dispatch_streams)),
        "caller_streams": sorted(map(str, caller_streams)),
        "h2d_overlapping_kernels_ms": overlap_us / 1e3,
    }
    log(f"[overlap] profiler, pipelined read of {path.name}: device busy {busy / 1e3:.1f} ms of "
        f"{wall_us / 1e3:.1f} ms wall ({100 * busy / wall_us:.2f} %); {len(h2d)} H2D copies "
        f"({dict(kinds)}), {copy_us / 1e3:.1f} ms, by stream {dict(copy_streams)}, "
        f"{on_dispatch} on the dispatch stream {sorted(map(str, dispatch_streams))} (the "
        f"caller's: {sorted(map(str, caller_streams))}); H2D time overlapping a kernel "
        f"{overlap_us / 1e3:.2f} ms")
    for s_, names in sorted(kernel_streams.items(), key=lambda kv: str(kv[0])):
        log(f"    stream {s_}: kernels {dict(names)}")
    unpinned = [k for k in kinds if "Pinned" not in k]
    if unpinned:
        raise AssertionError(f"[overlap] H2D copies not from pinned memory on the pipelined "
                             f"read: {unpinned}")
    if not on_dispatch:
        raise AssertionError(f"[overlap] no H2D copy on the dispatch stream "
                             f"{sorted(map(str, dispatch_streams))}: copies by stream "
                             f"{dict(copy_streams)}")
    if not dispatch_streams or dispatch_streams & caller_streams:
        raise AssertionError(f"[overlap] dispatched kernels on streams {dispatch_streams}, "
                             f"device_column's on {caller_streams}: no stream of their own")
    return summary


DATASET_COLUMNS = ("trip_id", "vendor_id", "passenger_count", "pickup_us", "fare_cents",
                   "trip_distance")


def dataset_want(specs) -> dict:
    """The generator's taxi columns without zone as the dataset delivers
    them (nullable="zero": a null passenger_count reads 0)."""
    from parquet_tpu_torch.testing.synth import column_values

    s = {sp.name: sp for sp in specs}
    out = {}
    for c in DATASET_COLUMNS:
        if s[c].valid is not None:
            v = np.zeros(len(s[c].valid), np.int32)
            v[s[c].valid] = s[c].dictionary[s[c].indices]
            out[c] = v
        else:
            out[c] = np.asarray(column_values(s[c]))
    return out


def check_dataset(taxi_path, specs, dev, card: str) -> dict:
    """The dataset phase over taxi without zone, nullable="zero": CUDA
    delivery (device_put_pipelined on the dispatch thread) equals CPU
    delivery batch for batch and the generator's columns; a resume from
    state_dict() mid-epoch, mid-unit equals the uninterrupted stream;
    shard=(k, 4) for k = 0..3 partitions the units and delivers every row
    once; rows/s of both deliveries, medians of 3 after a warm-up, printed
    beside `card` (nvidia-smi's name and power limit)."""
    import torch

    from parquet_tpu_torch.data import ParquetDataset

    n_rows = ROW_GROUPS * RG_ROWS
    kw = dict(batch_size=BATCH, columns=list(DATASET_COLUMNS), nullable="zero",
              remainder="keep")
    want = dataset_want(specs)

    def drain(device, **more):
        return list(ParquetDataset(str(taxi_path), device=device, **kw, **more))

    cuda = drain(None)
    cpu = drain("cpu")
    if len(cuda) != len(cpu) or len(cuda) != -(-n_rows // BATCH):
        raise AssertionError(f"[dataset] {len(cuda)} CUDA batches, {len(cpu)} CPU batches")
    for k, (g, w) in enumerate(zip(cuda, cpu)):
        if g.keys() != w.keys() or not all(
                g[p].is_cuda and g[p].dtype == w[p].dtype and torch.equal(g[p].cpu(), w[p])
                for p in g):
            raise AssertionError(f"[dataset] CUDA batch {k} differs from the CPU batch")
    for c in DATASET_COLUMNS:
        got = np.concatenate([b[(c,)].numpy() for b in cpu])
        if got.tobytes() != want[c].tobytes():
            raise AssertionError(f"[dataset] {c}: delivered rows differ from the generator's")
    log(f"[dataset] ParquetDataset(taxi, {len(DATASET_COLUMNS)} columns, batch {BATCH}, "
        f"nullable='zero'): {len(cuda)} CUDA batches equal the CPU batches and the generator")
    # resume mid-epoch, mid-unit (a unit is 1,048,576 rows, a batch 100,000)
    it = iter(ParquetDataset(str(taxi_path), device=None, **kw))
    for _ in range(13):
        next(it)
    state = it.state_dict()
    rest = list(it)
    resumed = list(ParquetDataset(str(taxi_path), device=None, prefetch=0, **kw)
                   .iterator(state=state))
    if len(rest) != len(resumed) or not all(
            all(torch.equal(a[p], b[p]) for p in a) for a, b in zip(rest, resumed)):
        raise AssertionError("[dataset] the resumed stream differs from the uninterrupted one")
    if not all(all(torch.equal(a[p].cpu(), b[p]) for p in a) for a, b in zip(rest, cpu[13:])):
        raise AssertionError("[dataset] the stream after the checkpoint differs")
    log(f"[dataset] resume from state_dict() after 13 batches ({state['unit_pos']}, "
        f"row {state['row_offset']} of its unit): {len(resumed)} batches equal the "
        "uninterrupted stream")
    units: list = []
    rows = 0
    for k in range(4):
        ds = ParquetDataset(str(taxi_path), device=None, shard=(k, 4), **kw)
        units.extend(ds.epoch_order(0))
        rows += sum(b[("trip_id",)].shape[0] for b in ds)
    if sorted(units) != list(range(ROW_GROUPS)) or rows != n_rows:
        raise AssertionError(f"[dataset] shards cover units {sorted(units)}, {rows} rows")
    log(f"[dataset] shard=(k, 4), k = 0..3: the units {sorted(units)} once each, {rows} rows")
    del cuda, cpu, rest, resumed
    rates = {}
    for label, device in (("CUDA delivery", None), ("CPU delivery", "cpu")):
        def run():
            n = 0
            for b in ParquetDataset(str(taxi_path), device=device, **kw):
                n += b[("trip_id",)].shape[0]
            if device is None:
                torch.cuda.synchronize()
            return n

        run()
        secs = []
        for _ in range(3):
            t = time.perf_counter()
            if run() != n_rows:
                raise AssertionError(f"[dataset] {label}: rows lost")
            secs.append(time.perf_counter() - t)
        rates[label] = n_rows / statistics.median(secs)
        log(f"[dataset] {label}: {rates[label]:,.0f} rows/s (median of "
            f"{[round(x, 3) for x in secs]} s) | {card}")
    return rates


# -- the row path: host rows against the card's decode ---------------------------


@dataclasses.dataclass
class TaxiTrip:
    """One taxi row as a floor record (the file's seven columns)."""

    trip_id: int
    vendor_id: np.int32
    passenger_count: Optional[np.int32]
    pickup_us: int
    fare_cents: np.int32
    trip_distance: float
    zone: str


ROWS_FLOOR_CHECK = 10_000


def device_group_values(group: dict, dev) -> dict:
    """{column: row-aligned Python values} of one row group decoded on the
    card, brought to the CPU: strings decoded, and a nullable column's
    values expanded to rows under its device mask (expand_nullable), None
    where the mask is false."""
    import torch

    from parquet_tpu_torch.kernels import device_ops as ops

    out = {}
    for (name,), col in group.items():
        if col.indices is not None:
            vals = [v.decode() for v in col.dictionary.take(col.indices.cpu().numpy()).to_list()]
        elif col.data is not None:
            offs = col.offsets.cpu().numpy().tolist()
            data = col.data.cpu().numpy().tobytes()
            vals = [data[a:b].decode() for a, b in zip(offs[:-1], offs[1:])]
        elif col.def_levels is not None:
            mask = torch.from_numpy(np.asarray(col.def_levels) == 1).to(dev)
            expanded = ops.expand_nullable(col.values, mask)
            keep = mask.cpu().numpy()
            full = np.empty(len(keep), dtype=object)
            full[keep] = expanded.cpu().numpy()[keep].tolist()
            vals = full.tolist()
        else:
            vals = col.values.cpu().numpy().tolist()
        out[name] = vals
    return out


def rows_equal_columns(rows: list, columns: dict, label: str) -> None:
    """Raise unless every row's value of every column equals the column's."""
    for name, want in columns.items():
        got = [row[name] for row in rows]
        if len(got) != len(want):
            raise AssertionError(f"[rows] {label}: {len(got)} rows, {len(want)} expected")
        if got != want:
            k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(f"[rows] {label}: {name} differs at row {k} "
                                 f"({got[k]!r} against {want[k]!r})")


def check_rows(taxi_path, sessions_path, sessions_specs, taxi_specs, f_taxi, taxi_keep,
               device_filtered, dev, launches: dict, card: str) -> dict:
    """The row phase: (a) taxi row group 0 through iter_rows against
    read_row_group_device(0) of the same group; (b) sessions row group 0
    through iter_rows against the generator's lists; (c) taxi through
    iter_rows(filters=F_taxi) against NumPy's totals and the device filtered
    read, on the vectorized engines; (d) (a)'s rows written through
    floor.Writer with default options, decoded on the card equal to the
    source (expand_hybrid and dict_gather launched) and read back through
    floor.Reader. The host row reads must launch no kernel. Returns each
    step's rows/s and the phase's seconds."""
    import torch

    from parquet_tpu_torch import floor, reset_row_counts, row_counts
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels import build
    from parquet_tpu_torch.kernels import device_ops as ops

    t_phase = time.perf_counter()
    rates = {}

    def no_launches(step: str) -> None:
        counts = kernel_counts()
        if any(v for v in counts.values() if isinstance(v, int)):
            raise AssertionError(f"[rows] {step} launched kernels: {counts}")

    # (a) taxi row group 0
    ops.reset_launch_counts()
    reset_row_counts()
    t = time.perf_counter()
    with FileReader(taxi_path) as r:
        rows_a = list(r.iter_rows(row_groups=[0]))
    secs = time.perf_counter() - t
    rates["taxi iter_rows, group 0"] = len(rows_a) / secs
    no_launches("iter_rows(row_groups=[0])")
    t = time.perf_counter()
    with FileReader(taxi_path) as r:
        r.read_row_group(0)
    decode_a = time.perf_counter() - t
    if len(rows_a) != RG_ROWS or row_counts().get("assemble_vec") != 1:
        raise AssertionError(f"[rows:a] {len(rows_a)} rows, row counts {row_counts()}")
    ops.reset_launch_counts()
    with FileReader(taxi_path) as r:
        group = r.read_row_group_device(0)
        torch.cuda.synchronize()
        # read before the check's own expand_nullable launches
        launches["rows taxi group 0 on the card"] = kernel_counts()
        want = device_group_values(group, dev)
    del group
    rows_equal_columns(rows_a, want, "taxi group 0")
    if not all(type(row["zone"]) is str for row in rows_a[:1000]):
        raise AssertionError("[rows:a] zone is not a str")
    nulls = sum(v is None for v in want["passenger_count"])
    log(f"[rows:a] taxi group 0: {len(rows_a):,} rows through iter_rows in {secs:.2f} s "
        f"({rates['taxi iter_rows, group 0']:,.0f} rows/s | {card}; the group's host decode "
        f"alone {decode_a:.2f} s) equal read_row_group_device(0) value for value; zone a str, "
        f"passenger_count None on the {nulls:,} rows its device mask leaves out")
    # (b) sessions row group 0
    sid, items = sessions_specs
    lengths = np.asarray(items.list_lengths[:RG_ROWS], dtype=np.int64)
    off = np.zeros(RG_ROWS + 1, dtype=np.int64)
    np.cumsum(lengths, out=off[1:])
    elems = items.dictionary[items.indices[: off[-1]]].tolist()
    want_items = [elems[a:b] if ok else None for ok, a, b in
                  zip(items.valid[:RG_ROWS].tolist(), off[:-1].tolist(), off[1:].tolist())]
    ops.reset_launch_counts()
    t = time.perf_counter()
    with FileReader(sessions_path) as r:
        rows_b = list(r.iter_rows(row_groups=[0]))
    secs = time.perf_counter() - t
    rates["sessions iter_rows, group 0"] = len(rows_b) / secs
    no_launches("sessions iter_rows")
    rows_equal_columns(rows_b, {"session_id": sid.values[:RG_ROWS].tolist(), "items": want_items},
                       "sessions group 0")
    log(f"[rows:b] sessions group 0: {len(rows_b):,} rows through iter_rows in {secs:.2f} s "
        f"({rates['sessions iter_rows, group 0']:,.0f} rows/s | {card}); each row's items equal "
        f"the generator's list ({sum(v is None for v in want_items):,} null, "
        f"{sum(v == [] for v in want_items):,} empty)")
    del rows_b, want_items, elems
    # (c) taxi under F_taxi
    ops.reset_launch_counts()
    reset_row_counts()
    n = trip = fare = 0
    t = time.perf_counter()
    with FileReader(taxi_path) as r:
        for row in r.iter_rows(filters=f_taxi):
            n += 1
            trip += row["trip_id"]
            fare += row["fare_cents"]
    secs = time.perf_counter() - t
    rates["taxi iter_rows(filters=F_taxi), over input rows"] = ROW_GROUPS * RG_ROWS / secs
    no_launches("iter_rows(filters=F_taxi)")
    rc = row_counts()
    t = time.perf_counter()
    with FileReader(taxi_path) as r:
        for i in r.prune_row_groups(f_taxi):
            r.read_row_group(i)
    decode_c = time.perf_counter() - t
    totals = taxi_filtered_totals(taxi_specs, taxi_keep)
    if (n, trip, fare) != (totals["rows"], totals["trip_id"], totals["fare_cents"]):
        raise AssertionError(f"[rows:c] (rows, trip_id, fare) {(n, trip, fare)} != NumPy's "
                             f"{(totals['rows'], totals['trip_id'], totals['fare_cents'])}")
    if (n, fare) != device_filtered:
        raise AssertionError(f"[rows:c] (rows, fare) {(n, fare)} != the device filtered read's "
                             f"{device_filtered}")
    admitted = ROW_GROUPS - 2
    if (rc.get("assemble_vec") != admitted or rc.get("assemble_cursor")
            or rc.get("rows_filtered_scalar")
            or rc.get("rows_filtered_vec") != admitted * RG_ROWS - n):
        raise AssertionError(f"[rows:c] row counts {rc}: the vectorized engines must take all "
                             f"{admitted} admitted groups")
    log(f"[rows:c] taxi iter_rows(filters=F_taxi): {n:,} rows, trip_id sum {trip}, in "
        f"{secs:.2f} s ({rates['taxi iter_rows(filters=F_taxi), over input rows']:,.0f} input "
        f"rows/s | {card}; the admitted groups' host decode alone {decode_c:.2f} s); equal "
        f"NumPy's totals and the device filtered read; row counts {rc}")
    # (d) write the rows through floor.Writer, decode on the card, read back
    objs = [TaxiTrip(**row) for row in rows_a]
    del rows_a
    path = build.BUILD_ROOT / "smoke" / "rows-floor.parquet"
    t = time.perf_counter()
    with floor.Writer(path, TaxiTrip) as w:
        w.write_all(objs)
    secs = time.perf_counter() - t
    rates["floor.Writer"] = len(objs) / secs
    ops.reset_launch_counts()
    t = time.perf_counter()
    reader = FileReader(path)
    groups = reader.read_row_groups_device()
    torch.cuda.synchronize()
    read_secs = time.perf_counter() - t
    counts = kernel_counts()
    launches["rows floor file on the card"] = counts
    for k in ("expand_hybrid", "dict_gather"):
        if counts[k] <= 0:
            raise AssertionError(f"[rows:d] {k} was not launched reading the row-written file")
    got = {}
    for g in groups:
        for name, vals in device_group_values(g, dev).items():
            got.setdefault(name, []).extend(vals)
    del groups
    want = {f.name: [getattr(o, f.name) for o in objs] for f in dataclasses.fields(TaxiTrip)}
    if got != want:
        bad = [k for k in want if got.get(k) != want[k]]
        raise AssertionError(f"[rows:d] the row-written file decoded on the card differs in {bad}")
    t = time.perf_counter()
    with floor.Reader(path, TaxiTrip) as r:
        back = list(itertools.islice(iter(r), ROWS_FLOOR_CHECK))
    back_secs = time.perf_counter() - t
    if back != objs[:ROWS_FLOOR_CHECK]:
        raise AssertionError("[rows:d] floor.Reader's objects differ from the written ones")
    rates["read_row_groups_device of the row-written file"] = len(objs) / read_secs
    rates["floor.Reader, first 10,000 rows"] = ROWS_FLOOR_CHECK / back_secs
    log(f"[rows:d] floor.Writer(TaxiTrip), default options: {len(objs):,} rows in {secs:.2f} s "
        f"({rates['floor.Writer']:,.0f} rows/s | {card}), {path.stat().st_size / 2**20:.1f} MiB, "
        f"{reader.num_row_groups} row group(s); read_row_groups_device equals the source "
        f"({read_secs:.2f} s), launches "
        + ", ".join(f"{k}={v}" for k, v in counts.items() if v and not isinstance(v, dict))
        + f"; floor.Reader's first {ROWS_FLOOR_CHECK:,} objects equal ({back_secs:.2f} s)")
    path.unlink()
    seconds = time.perf_counter() - t_phase
    log(f"[rows] the phase took {seconds:.1f} s | {card}")
    return {"rows_per_s": rates, "seconds": seconds,
            "host_decode_s": {"taxi group 0": decode_a, "taxi admitted groups": decode_c}}


# -- the io layer: URL reads, caches, signing, faults ---------------------------

IO_CREDENTIALS = ("smoke-key", "smoke-secret")
IO_PROJECTION = ("trip_id", "fare_cents", "zone")
# the dataset step's RAM tiers: one that holds taxi's projection (125 MB),
# one that spills most of it to the disk tier
IO_TIER_RAM = (256 << 20, 32 << 20)


def start_stub(root, latency_s: float = 0.0, credentials=None, writable: bool = False):
    """A RangeHttpStub serving `root` from a process of its own (its
    serving shares no GIL with the reader or writer); `writable` arms its
    multipart write side. Returns (process, base URL); a stub that does
    not report its port within 60 s fails the run."""
    import select

    cmd = [sys.executable, "-m", "parquet_tpu_torch.testing.httpstub", "--root", str(root),
           "--latency-s", str(latency_s)]
    if credentials is not None:
        cmd += ["--credentials", ":".join(credentials)]
    if writable:
        cmd.append("--writable")
    proc = subprocess.Popen(cmd, cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    ready, _, _ = select.select([proc.stdout], [], [], 60)
    line = proc.stdout.readline() if ready else ""
    if not line.startswith("PORT "):
        stop_stub(proc)
        raise AssertionError(f"[io] the stub did not start: {line!r}, exit {proc.returncode}")
    return proc, f"http://127.0.0.1:{int(line.split()[1])}"


def stop_stub(proc) -> None:
    """End a stub: its standard input closes, and a stub that does not
    exit within 30 s is killed."""
    try:
        proc.stdin.close()
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    finally:
        if proc.stdout is not None:
            proc.stdout.close()


def io_numbers() -> dict:
    """The io counts a step moved: range GETs (206 answers), whole-object
    answers, HEADs and multi-range answers, source bytes, cache hits."""
    from parquet_tpu_torch.io import io_counts

    c = io_counts()
    return {
        "range_gets": c.get('io_http_requests_total{status="206"}', 0),
        "multirange": c.get('io_multirange_requests_total{outcome="ok"}', 0),
        "http_200": c.get('io_http_requests_total{status="200"}', 0),
        "source_bytes": c.get("io_bytes_read_total", 0),
        "cache_hits": c.get("io_cache_hits_total", 0),
        "disk_hits": c.get('cache_tier_hits_total{tier="disk"}', 0),
        "cache_misses": c.get("io_cache_misses_total", 0),
    }


def io_small_file(path) -> bytes:
    """The fault step's file: 3 row groups x 2,000 rows, page CRCs, an
    optional int64 column a, a string column b, a required int32 column c
    (written with the port's writer)."""
    from parquet_tpu_torch import FileWriter, parse_schema

    schema = parse_schema("message m { optional int64 a; required binary b (STRING); "
                          "required int32 c; }")
    rng = np.random.default_rng(SEED)
    with FileWriter(str(path), schema, codec="snappy", with_crc=True,
                    row_group_size=1 << 40) as w:
        for g in range(3):
            n = 2000
            valid = rng.random(n) >= 0.25
            w.write_column("a", rng.integers(0, 1000, int(valid.sum())).astype(np.int64),
                           def_levels=valid.astype(np.uint16))
            w.write_column("b", [f"s{i % 50}".encode() for i in range(n)])
            w.write_column("c", np.arange(g * n, (g + 1) * n, dtype=np.int32))
            w.flush_row_group()
    return open(path, "rb").read()


def check_io(paths: dict, dev, launches: dict, card: str) -> dict:
    """The io phase: the taxi and sessions files served by a
    RangeHttpStub in a process of its own. (a) FileReader(url)
    .read_row_groups_device() of taxi and sessions (twice: the stub loads
    the file at its first request), bit-equal to the path read, every
    prepare on the fused walk; (b) taxi behind a stub with 5 ms
    of latency, the device read and the host read of IO_PROJECTION, each
    with the default coalesce gap and with "auto"; (c) iter_device_batches
    over the taxi URL, its totals equal to taxi_totals; (d) ParquetDataset
    over the taxi URL for two epochs with a 256 MiB RAM cache and a disk
    tier, then with a 32 MiB RAM tier that spills: each second epoch reads
    no source byte (the spilled one from the disk tier) and its batches
    equal the first's; (e) the read from a signed stub with the signer registered,
    equal to the path read, and a typed SourceError without it; (f) a
    small file with a corrupt chunk (a flipped byte, and a footer that
    lies about the chunk's size) under on_error "skip" and "null" (the
    groups and quarantine counts), read_row_group_device raising under
    both, max_memory below a group raising AllocError on the host and
    device reads, and testing/faults' seed-7 cases on the host read and the
    device round trip; (g) sessions with compact_levels=True, the packed
    levels widened equal to the unpacked read's. Prints the range GETs,
    source bytes, cache hits and rows/s of each step beside the path read
    and `card`; returns the numbers."""
    import shutil

    import torch

    from parquet_tpu_torch import AllocError, PackedLevels, SourceError
    from parquet_tpu_torch.core.reader import PARQUET_ERRORS, FileReader
    from parquet_tpu_torch.data import ParquetDataset
    from parquet_tpu_torch.io import clear_signers, configure_signer, io_tuner, reset_io_counts
    from parquet_tpu_torch.io.sign import SigV4Signer
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import prepare_counts, reset_prepare_counts
    from parquet_tpu_torch.testing import faults

    t_phase = time.perf_counter()
    root = smoke_dir()
    n_rows = ROW_GROUPS * RG_ROWS
    out: dict = {"steps": {}}
    stubs = []

    def step(label, rows, secs, numbers):
        out["steps"][label] = dict(numbers, rows_per_s=rows / secs, seconds=secs)
        log(f"[io] {label}: {rows / secs:,.0f} rows/s ({secs:.3f} s), "
            + ", ".join(f"{k} {v:,}" for k, v in numbers.items()) + f" | {card}")

    def device_read(src, **kw):
        reset_io_counts()
        ops.reset_launch_counts()
        reset_prepare_counts()
        t = time.perf_counter()
        with FileReader(src, **kw) as r:
            groups = r.read_row_groups_device()
            torch.cuda.synchronize()
        return groups, time.perf_counter() - t, kernel_counts(), prepare_counts(), io_numbers()

    try:
        proc, base = start_stub(root)
        stubs.append(proc)
        # (a) the URL reads against the path reads
        for label in ("taxi", "sessions"):
            path, specs = paths[label]
            want, secs, _c, _p, numbers = device_read(path)
            step(f"{label} path read", n_rows, secs, numbers)
            url = f"{base}/{path.name}"
            got, secs, counts, prep, numbers = device_read(url)
            launches[f"io {label} url"] = counts
            # the stub loads the file at its first request: a second read
            # times the transport alone
            step(f"{label} url read, first", n_rows, secs, numbers)
            again, secs, _c, _p, again_numbers = device_read(url)
            step(f"{label} url read, again", n_rows, secs, again_numbers)
            if not groups_equal(again, want):
                raise AssertionError(f"[io:a] {label}: the second URL read differs")
            del again
            if not groups_equal(got, want):
                raise AssertionError(f"[io:a] {label}: the URL read differs from the path read")
            chunks = ROW_GROUPS * len(specs)
            if prep.get("prepare_fused_engaged") != chunks or prep.get("prepare_fused_declined"):
                raise AssertionError(f"[io:a] {label}: prepare counts {prep} for {chunks} chunks")
            if numbers["range_gets"] < chunks or numbers["source_bytes"] <= 0:
                raise AssertionError(f"[io:a] {label}: io numbers {numbers}")
            log(f"[io:a] {label}: FileReader(url).read_row_groups_device() bit-equal to the path "
                f"read, fused walk on all {chunks} prepares, launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items() if isinstance(v, int) and v))
            del got, want
        taxi_path, taxi_specs = paths["taxi"]
        taxi_url = f"{base}/{taxi_path.name}"
        # (b) 5 ms of latency a request: the default gap and "auto"
        slow_proc, slow_base = start_stub(root, latency_s=0.005)
        stubs.append(slow_proc)
        slow_url = f"{slow_base}/{taxi_path.name}"
        want, _s, _c, _p, _n = device_read(taxi_path)
        io_tuner().reset()
        for gap in (None, "auto"):
            got, secs, counts, prep, numbers = device_read(slow_url, coalesce_gap=gap)
            step(f"taxi url read, 5 ms, gap {gap or 'default'}", n_rows, secs, numbers)
            if not groups_equal(got, want):
                raise AssertionError(f"[io:b] the 5 ms read (gap {gap}) differs")
            del got
        del want
        want = None
        for gap in (None, "auto"):
            reset_io_counts()
            t = time.perf_counter()
            with FileReader(slow_url, columns=list(IO_PROJECTION), coalesce_gap=gap) as r:
                got = [r.read_row_group(i) for i in range(r.num_row_groups)]
            secs = time.perf_counter() - t
            step(f"taxi url host read of {len(IO_PROJECTION)} columns, 5 ms, gap "
                 f"{gap or 'default'}", n_rows, secs, io_numbers())
            if want is None:
                with FileReader(taxi_path, columns=list(IO_PROJECTION)) as r:
                    want = [r.read_row_group(i) for i in range(r.num_row_groups)]
            if not all(a.keys() == b.keys() and all(chunks_equal(a[p], b[p]) for p in a)
                       for a, b in zip(got, want)):
                raise AssertionError(f"[io:b] the 5 ms host read (gap {gap}) differs")
        out["autotune"] = io_tuner().stats()
        log(f"[io:b] the tuner's verdicts: {out['autotune']}")
        del got, want
        stop_stub(slow_proc)
        stubs.remove(slow_proc)
        # (c) the batch stream over the URL
        ops.reset_launch_counts()
        reset_io_counts()
        t = time.perf_counter()
        totals, n_batches = run_batches(taxi_url, dict(nullable="mask"), taxi_step)
        secs = time.perf_counter() - t
        launches["io taxi url batches"] = kernel_counts()
        step("taxi url batches", n_rows, secs, io_numbers())
        if totals != taxi_totals(taxi_specs):
            raise AssertionError(f"[io:c] batch totals {totals} != {taxi_totals(taxi_specs)}")
        log(f"[io:c] iter_device_batches over the URL: {n_batches} batches, totals equal the "
            "generator's")
        # (d) the dataset over the URL, two epochs through the tiered cache:
        # a RAM tier that holds the projection, then one that spills it
        tier = root / "io-tier"
        out["tier"] = {}
        for ram in IO_TIER_RAM:
            shutil.rmtree(tier, ignore_errors=True)
            mib = ram >> 20
            try:
                kw = dict(batch_size=BATCH, columns=list(DATASET_COLUMNS), nullable="zero",
                          remainder="keep", cache_bytes=ram, cache_disk_bytes=4 << 30,
                          cache_dir=str(tier))
                with ParquetDataset(taxi_url, **kw) as ds:
                    epochs = []
                    for e in range(2):
                        reset_io_counts()
                        t = time.perf_counter()
                        batches = list(ds)
                        torch.cuda.synchronize()
                        secs = time.perf_counter() - t
                        ds.io_stats()  # settles the readahead's fetches
                        numbers = io_numbers()
                        step(f"dataset, {mib} MiB RAM tier, epoch {e} "
                             f"({'cold' if e == 0 else 'warm'})", n_rows, secs, numbers)
                        epochs.append((batches, numbers))
                    stats = ds.io_stats()
                    out["tier"][f"{mib} MiB"] = {
                        t: {k: v for k, v in stats[t].items() if k != "dir"}
                        for t in ("ram", "disk")}
                (cold, _), (warm, warm_numbers) = epochs
                if warm_numbers["source_bytes"] != 0 or warm_numbers["cache_hits"] <= 0:
                    raise AssertionError(f"[io:d] the warm epoch read the source: {warm_numbers}")
                spilled = out["tier"][f"{mib} MiB"]["disk"]["blocks"]
                if spilled and warm_numbers["disk_hits"] <= 0:
                    raise AssertionError(f"[io:d] {mib} MiB: {spilled} blocks spilled, no disk "
                                         f"tier hit: {warm_numbers}")
                if len(cold) != len(warm) or len(cold) != -(-n_rows // BATCH) or not all(
                        a.keys() == b.keys() and all(torch.equal(a[p], b[p]) for p in a)
                        for a, b in zip(cold, warm)):
                    raise AssertionError("[io:d] the two epochs' batches differ")
                log(f"[io:d] ParquetDataset(url, cache_bytes={mib} MiB, cache_disk_bytes=4 GiB): "
                    f"{len(cold)} batches twice, equal; the warm epoch read 0 source bytes, "
                    f"{warm_numbers['cache_hits']} cache hits ({warm_numbers['disk_hits']} from "
                    f"the disk tier); tiers {out['tier'][f'{mib} MiB']}")
                del cold, warm, epochs
            finally:
                shutil.rmtree(tier, ignore_errors=True)
        # (e) the signed stub
        signed_proc, signed_base = start_stub(root, credentials=IO_CREDENTIALS)
        stubs.append(signed_proc)
        signed_url = f"{signed_base}/{taxi_path.name}"
        configure_signer(SigV4Signer(*IO_CREDENTIALS), prefix=signed_base)
        try:
            want, _s, _c, _p, _n = device_read(taxi_path)
            got, secs, counts, _p, numbers = device_read(signed_url)
            launches["io taxi signed url"] = counts
            step("taxi signed url read", n_rows, secs, numbers)
            if not groups_equal(got, want):
                raise AssertionError("[io:e] the signed read differs from the path read")
            del got, want
        finally:
            clear_signers()
        try:
            FileReader(signed_url)
        except SourceError as e:
            if getattr(e, "code", None) != "http_403":
                raise AssertionError(f"[io:e] unsigned: code {getattr(e, 'code', None)}") from e
            log(f"[io:e] the signed read equals the path read; unsigned: SourceError "
                f"code={e.code}: {e}")
        else:
            raise AssertionError("[io:e] the unsigned read of the signed stub did not raise")
        stop_stub(signed_proc)
        stubs.remove(signed_proc)
    finally:
        for proc in stubs:
            stop_stub(proc)
    # (f) faults, quarantine and the memory ceiling on a small file
    small = root / "io-small.parquet"
    try:
        data = io_small_file(small)
        from parquet_tpu_torch.core.chunk import chunk_byte_range

        with FileReader(small) as r:
            off, total = chunk_byte_range(r.row_group(1).columns[0])
        flipped = bytearray(data)
        flipped[off + total // 2] ^= 0xFF
        # the same chunk behind a footer that lies about its size: an
        # unusable range is a corrupt chunk like a flipped byte
        from parquet_tpu_torch.meta.file_meta import serialize_footer

        meta = FileReader.open_metadata(small)
        meta.row_groups[1].columns[0].meta_data.total_compressed_size = -1
        lying = data[:len(data) - 8 - int.from_bytes(data[-8:-4], "little")]
        lying += serialize_footer(meta)
        fault_numbers = {}
        for (name, bad), (policy, want_groups, want_counts) in itertools.product(
                (("flipped", bytes(flipped)), ("lying footer", lying)), (
                ("skip", [3, 0, 3], {"chunks_quarantined": 1, "row_groups_quarantined": 1}),
                ("null", [3, 3, 3], {"chunks_quarantined": 1, "chunks_nulled": 1}))):
            reset_io_counts()
            with FileReader(bad, validate_crc=True, on_error=policy) as r:
                groups = [r.read_row_group(i) for i in range(r.num_row_groups)]
                try:
                    r.read_row_group_device(1)
                except PARQUET_ERRORS as e:
                    device_error = f"{type(e).__name__}: {e}"
                else:
                    raise AssertionError(f"[io:f] {name}, {policy}: the device read did not "
                                         "raise")
            from parquet_tpu_torch.io import io_counts

            counts = {k: v for k, v in io_counts().items()
                      if k in ("chunks_quarantined", "chunks_nulled", "row_groups_quarantined")}
            if [len(g) for g in groups] != want_groups or counts != want_counts:
                raise AssertionError(f"[io:f] {name}, {policy}: groups "
                                     f"{[len(g) for g in groups]}, counts {counts}")
            if policy == "null" and (groups[1][("a",)].values.size != 0
                                     or np.asarray(groups[1][("a",)].def_levels).any()):
                raise AssertionError(f"[io:f] {name}, null: group 1's a is not all-null")
            fault_numbers[f"{name}, {policy}"] = counts
            log(f"[io:f] {name}, on_error={policy!r}: groups of {[len(g) for g in groups]} "
                f"columns, {counts}; read_row_group_device(1) raised {device_error}")
        for kw in (dict(), dict(backend="device_roundtrip")):
            try:
                with FileReader(data, max_memory=20_000, **kw) as r:
                    r.read_row_group(0)
            except AllocError as e:
                log(f"[io:f] max_memory=20,000 {kw}: read_row_group raised AllocError: {e}")
            else:
                raise AssertionError(f"[io:f] max_memory {kw}: the host read did not raise")
        try:
            with FileReader(data, max_memory=20_000) as r:
                r.read_row_group_device(0)
        except AllocError as e:
            log(f"[io:f] max_memory=20,000: read_row_group_device raised AllocError: {e}")
        else:
            raise AssertionError("[io:f] max_memory: the device read did not raise")
        with FileReader(data, max_memory=1 << 30) as r:
            if sum(r.read_row_group_device(i)[("c",)].num_values for i in range(3)) != 6000:
                raise AssertionError("[io:f] max_memory 1 GiB: rows lost")
        verdicts = collections.Counter()
        pristine = {b: faults.read_all(data, True, b, "cuda")
                    for b in ("host", "device_roundtrip")}
        for case in faults.iter_fault_cases(data, seed=7):
            for backend in ("host", "device_roundtrip"):
                verdicts[(backend, faults.run_case(case, pristine=pristine[backend],
                                                   backend=backend, device="cuda"))] += 1
        fault_numbers["cases"] = {f"{b} {v}": n for (b, v), n in sorted(verdicts.items())}
        log(f"[io:f] testing/faults cases (seed 7) typed or identical on both rungs: "
            f"{fault_numbers['cases']}")
        out["faults"] = fault_numbers
    finally:
        small.unlink(missing_ok=True)
    # (g) compact_levels on sessions
    sessions_path = paths["sessions"][0]
    with FileReader(sessions_path) as r:
        plain_host = r.read_row_group(0)
        plain_dev = r.read_row_group_device(0)
    with FileReader(sessions_path, compact_levels=True) as r:
        packed_host = r.read_row_group(0)
        packed_dev = r.read_row_group_device(0)
    packed_bytes = plain_bytes = 0
    for p, cd in plain_host.items():
        for f in ("def_levels", "rep_levels"):
            for got, want in ((getattr(packed_host[p], f), getattr(cd, f)),
                              (getattr(packed_dev[p], f), getattr(plain_dev[p], f))):
                if want is None:
                    if got is not None:
                        raise AssertionError(f"[io:g] {p} {f}: levels appeared")
                    continue
                if not isinstance(got, PackedLevels) or not np.array_equal(got.widen(), want):
                    raise AssertionError(f"[io:g] {p} {f}: packed levels differ")
                packed_bytes += got.nbytes
                plain_bytes += np.asarray(want).nbytes
    out["compact_levels_bytes"] = {"packed": packed_bytes, "plain": plain_bytes}
    log(f"[io:g] compact_levels=True on sessions group 0: levels packed, {packed_bytes:,} "
        f"bytes against {plain_bytes:,}, widened equal to the unpacked reads (host and device)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[io] the phase took {out['seconds']:.1f} s | {card}")
    return out


# -- remote writes and the lake ---------------------------------------------------

# the lake loop: the first LAKE_ROWS rows of taxi in LAKE_APPENDS appends
LAKE_ROWS = 1 << 19
LAKE_APPENDS = 32


def http_get(url: str, signer=None) -> tuple[int, bytes]:
    """(status, body) of one GET of the whole object at `url` (signed when
    `signer` is given)."""
    import http.client
    from urllib.parse import urlsplit

    split = urlsplit(url)
    headers = signer.headers("GET", url, b"") if signer is not None else {}
    conn = http.client.HTTPConnection(split.hostname, split.port, timeout=120)
    try:
        conn.request("GET", split.path, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def taxi_rows(specs, n: int) -> list:
    """The generator's first n taxi rows as row dicts (zone a str,
    passenger_count None where it is null), and the columns they hold."""
    s = {sp.name: sp for sp in specs}
    cols = {}
    for name, sp in s.items():
        if name == "passenger_count":
            valid = sp.valid[:n]
            full = np.zeros(n, np.int32)
            full[valid] = sp.dictionary[sp.indices[:int(valid.sum())]]
            cols[name] = [int(v) if ok else None for v, ok in zip(full.tolist(), valid)]
        elif name == "zone":
            cols[name] = [v.decode() for v in sp.dictionary.take(sp.indices[:n]).to_list()]
        elif sp.dict_encoded:
            cols[name] = np.asarray(sp.dictionary)[sp.indices[:n]].tolist()
        else:
            cols[name] = np.asarray(sp.values[:n]).tolist()
    names = list(cols)
    return [dict(zip(names, vals)) for vals in zip(*(cols[c] for c in names))]


def check_remote_lake(paths, taxi_schema, dev_groups, dev_file, dev, launches: dict,
                      card: str) -> dict:
    """The remote-write and lake phase. (a) taxi's device columns written
    with FileWriter(stub URL) to a writable RangeHttpStub in a process of
    its own, with the device write's schema and options: the object, read
    back by one GET, equals the path write's file byte for byte; one
    multipart initiate, ceil(size / 8 MiB) parts and one commit in
    io_counts(); FileReader(url).read_row_groups_device() equals the
    generator; rows/s of the URL write against the path write (turns: path,
    URL, URL, path). (b) the same write through ObjectStoreSink with a
    SigV4Signer to a stub started with --credentials commits the same
    bytes; an unsigned write there raises SinkError(code="http_403") and
    leaves no object. (c) the lake loop: a LakeTable with taxi's schema
    (DSL) and sort key pickup_us; the first LAKE_ROWS rows in LAKE_APPENDS
    appends through IngestWriter's defaults (append k takes rows k, k + 32,
    ...: interleaved producers); Compactor.compact_once() with its
    defaults; pruned_ratio of a pickup_us range and of the compactor's own
    probe must rise; one device epoch of ParquetDataset(table) holds the
    rows' multiset column by column and equals the CPU epoch batch for
    batch; an epoch pinned to the last generation before compaction holds
    the same multiset (the dataset decodes on the host and uploads, so its
    epochs launch no decode kernel); read_row_groups_device() of the
    compacted file holds the rows' values column by column, with
    expand_hybrid and dict_gather launched. Prints each step's rows/s and
    seconds beside `card`; returns the numbers."""
    import shutil

    import torch

    from parquet_tpu_torch import WriterError, reset_write_counts, write_counts
    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.data import ParquetDataset
    from parquet_tpu_torch.io import ObjectStoreSink, io_counts, reset_io_counts
    from parquet_tpu_torch.io.sign import SigV4Signer
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.lake import Compactor, IngestWriter, LakeTable, pruned_ratio
    from parquet_tpu_torch.sink import SinkError

    t_phase = time.perf_counter()
    root = smoke_dir()
    taxi_specs = paths["taxi"][1]
    n_rows = ROW_GROUPS * RG_ROWS
    out: dict = {"steps": {}}

    def step(label, rows, secs, **numbers):
        out["steps"][label] = dict(numbers, rows_per_s=rows / secs, seconds=secs)
        log(f"[remote] {label}: {rows / secs:,.0f} rows/s ({secs:.3f} s)"
            + "".join(f", {k} {v:,}" for k, v in numbers.items()) + f" | {card}")

    def timed_write(dest):
        t = time.perf_counter()
        write_taxi(dest, taxi_schema, dev_groups, device=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    want = dev_file.read_bytes()
    part = 8 << 20
    stubs = []
    try:
        # (a) the device write to a URL
        proc, base = start_stub(root, writable=True)
        stubs.append(proc)
        url = f"{base}/remote-taxi.parquet"
        reset_io_counts()
        reset_write_counts()
        ops.reset_launch_counts()
        secs = timed_write(url)
        counts = kernel_counts()
        launches["remote taxi url write"] = counts
        io, wc = io_counts(), write_counts()
        status, got = http_get(url)
        n_parts = -(-len(want) // part)
        mp = {k: io.get(f"sink_multipart_{k}_total", 0)
              for k in ("initiated", "parts", "completed", "aborted")}
        step("taxi url write, first", n_rows, secs, bytes=len(got), parts=mp["parts"],
             put_bytes=io.get("io_put_bytes_total", 0))
        if status != 200 or got != want:
            raise AssertionError(f"[remote:a] GET {status}: the URL object ({len(got):,} bytes) "
                                 f"differs from the path write's file ({len(want):,} bytes)")
        # an object under one part goes up in one single-shot PUT
        want_mp = ({"initiated": 1, "parts": n_parts, "completed": 1, "aborted": 0}
                   if len(want) >= part else dict.fromkeys(mp, 0))
        if mp != want_mp:
            raise AssertionError(f"[remote:a] multipart counts {mp}, expected {want_mp}")
        if io.get("io_put_bytes_total") != len(want):
            raise AssertionError(f"[remote:a] {io.get('io_put_bytes_total')} bytes put")
        if (wc["device_write_engaged"], wc["device_write_declined"]) != (6 * ROW_GROUPS, 0):
            raise AssertionError(f"[remote:a] write counts {wc}")
        for k in WRITE_KERNELS:
            if k != "bitpack_encode" and counts[k] <= 0:
                raise AssertionError(f"{k} was not launched on the URL write")
        out["multipart"] = dict(mp, bytes=len(got), part_bytes=part)
        log(f"[remote:a] FileWriter(url) of taxi's device columns: the object equals the path "
            f"write's file ({len(got):,} bytes, ceil(size / 8 MiB) = {n_parts}), counts {mp}; "
            "launches " + ", ".join(f"{k}={v}" for k, v in counts.items()
                                    if isinstance(v, int) and v))
        ops.reset_launch_counts()
        t = time.perf_counter()
        with FileReader(url, device=dev) as r:
            groups = r.read_row_groups_device()
            torch.cuda.synchronize()
            stats = r.stats
        step("taxi url read-back", n_rows, time.perf_counter() - t)
        launches["remote taxi url read"] = kernel_counts()
        check_main_path(groups, taxi_specs, stats, no_host_fallback=False)
        del groups
        log("[remote:a] FileReader(url).read_row_groups_device(): the columns equal the "
            "generator's")
        tmp = root / "remote-path-write.parquet"
        turns = {"path": [], "url": []}
        for k, way in enumerate(("path", "url", "url", "path")):
            dest = tmp if way == "path" else f"{base}/remote-taxi-{k}.parquet"
            turns[way].append(timed_write(dest))
        if tmp.read_bytes() != want:
            raise AssertionError("[remote:a] the path write's file changed between writes")
        tmp.unlink()
        rates = {way: n_rows / statistics.median(s) for way, s in turns.items()}
        out["write_rows_per_s"] = rates
        out["url_over_path"] = rates["url"] / rates["path"]
        log(f"[remote:a] device write rows/s: path {rates['path']:,.0f} "
            f"({[round(x, 3) for x in turns['path']]} s), url {rates['url']:,.0f} "
            f"({[round(x, 3) for x in turns['url']]} s), url / path "
            f"{out['url_over_path']:.3f} | {card}")
        stop_stub(proc)
        stubs.remove(proc)
        # (b) signed and refused writes
        sproc, sbase = start_stub(root, credentials=IO_CREDENTIALS, writable=True)
        stubs.append(sproc)
        signer = SigV4Signer(*IO_CREDENTIALS)
        surl = f"{sbase}/remote-taxi-signed.parquet"
        reset_io_counts()
        ops.reset_launch_counts()
        sink = ObjectStoreSink(surl, signer=signer)
        t = time.perf_counter()
        try:
            write_taxi(sink, taxi_schema, dev_groups, device=True)
            sink.close()  # the caller owns a sink it passes in: it commits
        finally:
            sink.abort()
        torch.cuda.synchronize()
        step("taxi signed url write", n_rows, time.perf_counter() - t)
        launches["remote taxi signed write"] = kernel_counts()
        if http_get(surl, signer) != (200, want):
            raise AssertionError("[remote:b] the signed write's object differs")
        uurl = f"{sbase}/remote-taxi-unsigned.parquet"
        try:
            write_taxi(uurl, taxi_schema, dev_groups[:1], device=True)
        except WriterError as e:
            cause = e.__cause__
            if not isinstance(cause, SinkError) or cause.code != "http_403":
                raise AssertionError(f"[remote:b] unsigned: {e!r} from {cause!r}") from e
            refused = f"WriterError from SinkError code={cause.code}: {cause}"
        else:
            raise AssertionError("[remote:b] the unsigned write to the signed stub committed")
        status = http_get(uurl, signer)[0]
        if status != 404:
            raise AssertionError(f"[remote:b] after the refused write, GET answers {status}")
        out["signed"] = {"refused": refused, "get_after_refusal": status}
        log(f"[remote:b] ObjectStoreSink(SigV4Signer) committed the path write's bytes; "
            f"unsigned: {refused}; GET then answers {status}")
        stop_stub(sproc)
        stubs.remove(sproc)
    finally:
        for proc in stubs:
            stop_stub(proc)
    # (c) the lake loop
    table_dir = root / "lake-taxi"
    shutil.rmtree(table_dir, ignore_errors=True)
    t_lake = time.perf_counter()
    try:
        t = time.perf_counter()
        rows = taxi_rows(taxi_specs, LAKE_ROWS)
        log(f"[lake] {LAKE_ROWS:,} taxi rows as dicts in {time.perf_counter() - t:.2f} s")
        table = LakeTable.create(str(table_dir), TAXI_DSL, sort_key="pickup_us")
        writer = IngestWriter(table)
        t = time.perf_counter()
        for k in range(LAKE_APPENDS):
            writer.append(rows[k::LAKE_APPENDS])
        writer.close()
        secs = time.perf_counter() - t
        before = table.manifest.open_snapshot()
        step("lake ingest", LAKE_ROWS, secs, files=len(before.files),
             generation=before.generation, bytes=before.total_bytes)
        if before.total_rows != LAKE_ROWS:
            raise AssertionError(f"[lake] {before.total_rows} rows committed")
        keys = sorted(r["pickup_us"] for r in rows)
        # a window of 512 trips' pickups (a few minutes): narrower than a row group
        lo, hi = keys[LAKE_ROWS // 2], keys[LAKE_ROWS // 2 + LAKE_ROWS // 1024]
        probe = [("pickup_us", ">=", lo), ("pickup_us", "<", hi)]
        ratio_before = pruned_ratio(table.snapshot_paths(), probe)
        t = time.perf_counter()
        result = Compactor(table).compact_once()
        secs = time.perf_counter() - t
        if result is None:
            raise AssertionError("[lake] the compactor found nothing to fold")
        after = table.manifest.open_snapshot()
        ratio_after = pruned_ratio(table.snapshot_paths(), probe)
        step("lake compaction", LAKE_ROWS, secs, files_in=result.files_in,
             generation=result.generation, bytes_out=result.bytes_out)
        out["pruned_ratio"] = {
            "range": [ratio_before, ratio_after],
            "probe": [result.pruned_ratio_before, result.pruned_ratio_after]}
        log(f"[lake] compact_once: {result.files_in} files -> 1, generation "
            f"{result.generation}; pruned_ratio of pickup_us in [{lo}, {hi}) "
            f"{ratio_before:.4f} -> {ratio_after:.4f}, of the compactor's point probe "
            f"{result.pruned_ratio_before:.4f} -> {result.pruned_ratio_after:.4f}")
        if (after.total_rows != LAKE_ROWS or len(after.files) != 1
                or not ratio_after > ratio_before
                or not result.pruned_ratio_after > result.pruned_ratio_before):
            raise AssertionError(f"[lake] after compaction: {after.total_rows} rows in "
                                 f"{len(after.files)} files; pruned ratios {out['pruned_ratio']}")
        kw = dict(batch_size=BATCH, columns=list(DATASET_COLUMNS), nullable="zero",
                  remainder="keep")
        want_cols = {c: sorted(0 if r[c] is None else r[c] for r in rows)
                     for c in DATASET_COLUMNS}

        def epoch(ref, device, label=None):
            # the dataset decodes its units on the host (as the reference's
            # does) and uploads the batches: no decode kernel launches here
            t = time.perf_counter()
            batches = list(ParquetDataset(str(ref), device=device, **kw))
            torch.cuda.synchronize()
            if label is not None:
                step(label, LAKE_ROWS, time.perf_counter() - t, batches=len(batches))
            return batches

        def multiset(batches, label):
            for c in DATASET_COLUMNS:
                got = sorted(torch.cat([b[(c,)] for b in batches]).cpu().tolist())
                if got != want_cols[c]:
                    raise AssertionError(f"[lake] {label}: {c} does not hold the rows' values")

        cuda = epoch(table_dir, dev, "lake device epoch")
        cpu = epoch(table_dir, "cpu")
        if len(cuda) != len(cpu) or not all(
                g.keys() == w.keys() and all(
                    g[p].device.type == dev.type and g[p].dtype == w[p].dtype
                    and torch.equal(g[p].cpu(), w[p])
                    for p in g)
                for g, w in zip(cuda, cpu)):
            raise AssertionError("[lake] the device epoch's batches differ from the CPU epoch's")
        multiset(cuda, "device epoch")
        del cpu
        # the table's files decoded on the card: the lake's kernel path
        ops.reset_launch_counts()
        t = time.perf_counter()
        decoded = []
        for path in table.snapshot_paths():
            with FileReader(path, device=dev) as r:
                decoded += r.read_row_groups_device()
        torch.cuda.synchronize()
        step("lake device read", LAKE_ROWS, time.perf_counter() - t,
             row_groups=len(decoded))
        launches["lake device read"] = counts = kernel_counts()
        for k in ("expand_hybrid", "dict_gather"):
            if counts[k] <= 0:
                raise AssertionError(f"{k} was not launched on the lake device read")
        values = [device_group_values(g, dev) for g in decoded]
        for c in DATASET_COLUMNS + ("zone",):
            got = sorted(0 if v is None else v for g in values for v in g[c])
            want = (want_cols[c] if c != "zone" else sorted(r["zone"] for r in rows))
            if got != want:
                raise AssertionError(f"[lake] device read: {c} does not hold the rows' values")
        log(f"[lake] read_row_groups_device of the table's file: {len(decoded)} row groups hold "
            "the rows' values column by column; launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if isinstance(v, int) and v))
        del decoded, values
        pinned = table_dir / "_lake" / f"gen-{before.generation:08d}.json"
        travel = epoch(pinned, dev, "lake device epoch, time travel")
        multiset(travel, "time travel")
        log(f"[lake] ParquetDataset(table, device={dev.type!r}): {len(cuda)} batches equal the CPU "
            f"epoch's and hold the rows' multiset; pinned to {pinned.name} (before "
            f"compaction, {len(before.files)} files): the same multiset, {len(travel)} batches")
        del cuda, travel, rows
    finally:
        shutil.rmtree(table_dir, ignore_errors=True)
    out["lake_seconds"] = time.perf_counter() - t_lake
    log(f"[lake] the loop took {out['lake_seconds']:.1f} s")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[remote] the phase took {out['seconds']:.1f} s | {card}")
    return out


SERVE_CLIENTS = 8
SERVE_PER_CLIENT = 4
SERVE_TENANTS = 4
SERVE_SCAN_LIMIT = 200_000
SERVE_APPENDS = 8
SERVE_APPEND_ROWS = 8192
SERVE_WATCHDOG_S = 600.0  # bounds every socket read and every wait of the phase


def serve_request(server, method: str, path: str, body=None, headers=None):
    """(status, headers, body) of one HTTP exchange with a daemon; `body` a
    dict (sent as JSON) or bytes."""
    import http.client

    if isinstance(body, dict):
        body = json.dumps(body).encode()
    conn = http.client.HTTPConnection(server.host, server.port, timeout=SERVE_WATCHDOG_S)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def serve_scan_raw(server, body: dict) -> tuple[int, bytes, bytes]:
    """POST /v1/scan over a raw socket: (status, decoded body, the bytes
    after the last data chunk). The framing is parsed here, so a stream
    torn before its 0-chunk shows as a tail other than b"0\\r\\n\\r\\n"."""
    import socket

    payload = json.dumps(body).encode()
    with socket.create_connection((server.host, server.port), timeout=SERVE_WATCHDOG_S) as s:
        s.sendall(b"POST /v1/scan HTTP/1.1\r\nHost: smoke\r\nConnection: close\r\n"
                  b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n"
                  % len(payload) + payload)
        parts = []
        while True:
            b = s.recv(1 << 20)
            if not b:
                break
            parts.append(b)
    raw = b"".join(parts)
    head, _, rest = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    if b"transfer-encoding: chunked" not in head.lower():
        return status, rest, b""
    out = []
    pos = 0
    while True:
        eol = rest.index(b"\r\n", pos)
        size = int(rest[pos:eol], 16)
        if size == 0:
            return status, b"".join(out), rest[pos:]
        out.append(rest[eol + 2 : eol + 2 + size])
        pos = eol + 2 + size + 2


class GatedSource:
    """A byte source whose reads wait for `gate` (a threading.Event): how
    the drain step holds a query in flight without a sleep."""

    def __init__(self, path, gate):
        from parquet_tpu_torch.io.source import LocalFileSource

        self._inner = LocalFileSource(path)
        self._gate = gate

    @property
    def source_id(self):
        return self._inner.source_id

    def size(self):
        return self._inner.size()

    def generation(self):
        return None

    def read_at(self, offset, n):
        if not self._gate.wait(SERVE_WATCHDOG_S):
            raise AssertionError("the drain step's gate never opened")
        return self._inner.read_at(offset, n)

    def read_ranges(self, ranges):
        return [self.read_at(o, n) for o, n in ranges]

    def close(self):
        self._inner.close()


def serve_wait(what: str, cond) -> None:
    """Wait until cond() holds (a bounded poll: the daemon finishes a
    request's counts and its ticket just after the client has its body)."""
    end = time.monotonic() + SERVE_WATCHDOG_S
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"[serve] {what}: not reached in {SERVE_WATCHDOG_S} s")
        time.sleep(0.005)


def ok_count(counts: dict) -> int:
    return sum(v for k, v in counts.items()
               if k.startswith("serve_requests_total{") and 'status="200"' in k)


def check_serve(taxi_path, taxi_specs, f_taxi, taxi_keep, dev, launches: dict, card: str) -> dict:
    """The serve phase: the port's ScanServer(ServeConfig(root=the smoke
    directory, port=0, device=dev)) in this process, driven over HTTP on
    loopback. (a) POST /v1/query with query_aggregates(), unfiltered and
    under F_taxi: each body byte-equal to render_query_body of
    run_local_query of the same request and equal to NumPy's (query_want),
    POST /v1/plan of the filtered request pruning 2 units by statistics,
    masked_agg, dict_gather and (filtered) mask_take launched; shard=[k, 4]
    for k = 0..3 equal to NumPy's over groups k and k + 4; group_by
    vendor_id a typed 400 device_declined, counted. (b) SERVE_CLIENTS
    threads send SERVE_PER_CLIENT filtered queries each under
    SERVE_TENANTS X-Tenant values: every body byte-equal to (a)'s,
    serve_requests_total with status 200 up by exactly their number, the
    admission back at 0 in flight; requests/s, median and largest latency
    and input rows/s against one client's sequential queries and
    run_local_query's rate. (c) POST /v1/scan jsonl of trip_id, fare_cents
    and zone under F_taxi, limit SERVE_SCAN_LIMIT: the lines equal the
    first rows of FileReader(path, columns=...).iter_rows(filters=F_taxi)
    dumped with json_default, and the chunked stream ends with its
    0-chunk; GET /v1/plan equal to POST /v1/plan, units of row groups 0-5
    (6 and 7 pruned). (d) a second daemon with lake_root under the root,
    TAXI_DSL and sort key pickup_us: SERVE_APPENDS jsonl bodies of
    SERVE_APPEND_ROWS taxi rows to /v1/append, the last with ?flush=1:
    each ack takes its rows, the last one flushed at the table's current
    generation; a /v1/query of the table on the card equal to NumPy's over
    those rows; an arrow-ipc append a typed 415. (e) a daemon with
    tenant_budget_mb=1: one tenant's first full query answered, its second
    a typed 429 tenant_over_budget, another tenant's answered; then a
    daemon reading through a gate: a full query held in flight, drain() on
    a thread, a new query a typed 503 draining and /healthz a 503 with
    retry_after_s, the gate opened, the held query's body equal to (a)'s,
    the drain complete. Every daemon ends with 0 in flight and is closed.
    Prints each step's figures beside `card`; returns the numbers."""
    import shutil
    import threading

    import torch

    from parquet_tpu_torch.core.reader import FileReader
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.lake.manifest import LakeTable
    from parquet_tpu_torch.serve import (
        ScanServer,
        ServeConfig,
        query_device_counts,
        render_query_body,
        reset_query_device_counts,
        run_local_query,
        serve_counts,
    )
    from parquet_tpu_torch.serve.executor import SERVE_THREADS
    from parquet_tpu_torch.serve.protocol import json_default

    t_phase = time.perf_counter()
    root = taxi_path.parent
    name = taxi_path.name
    n_rows = ROW_GROUPS * RG_ROWS
    out: dict = {}
    flt = [[list(t) for t in conj] for conj in f_taxi]
    spec = ["count", ["count", "passenger_count"]]
    for c in QUERY_COLUMNS:
        spec += [["sum", c], ["min", c], ["max", c]]

    def qbody(filters=None, **extra):
        b = {"paths": [name], "aggregates": spec, **extra}
        if filters is not None:
            b["filters"] = filters
        return b

    def query_ok(server, body, headers=None):
        status, _h, raw = serve_request(server, "POST", "/v1/query", body, headers)
        if status != 200:
            raise AssertionError(f"[serve] /v1/query {body}: {status} {raw[:300]!r}")
        return raw

    def idle(server, label):
        serve_wait(f"{label}: in flight back to 0", lambda: server.service.admission.in_flight == 0)

    servers = []
    try:
        server = ScanServer(ServeConfig(root=str(root), port=0, device=dev)).start_background()
        servers.append(server)
        log(f"[serve] ScanServer(ServeConfig(root={root.name}, port=0, device={dev.type!r})) at "
            f"{server.url}; the pqt-serve pool has {SERVE_THREADS} threads; {card}")
        # (a) queries over HTTP, each held against run_local_query and NumPy
        bodies = {}
        for label, filters, keep, units in (("query", None, np.ones(n_rows, bool), ROW_GROUPS),
                                            ("query filtered", flt, taxi_keep, ROW_GROUPS - 2)):
            local = render_query_body(run_local_query(
                [str(taxi_path)], query_request(taxi_path, f_taxi if filters else None), device=dev))
            ops.reset_launch_counts()
            reset_query_device_counts()
            t = time.perf_counter()
            raw = query_ok(server, qbody(filters))
            secs = time.perf_counter() - t
            launches[f"serve {label}"] = counts = kernel_counts()
            qc = query_device_counts()
            want = query_want(taxi_specs, keep, units)
            if raw != local:
                raise AssertionError(f"[serve:a] {label}: the daemon's body differs from "
                                     f"run_local_query's: {raw[:300]!r} vs {local[:300]!r}")
            if json.loads(raw) != want:
                raise AssertionError(f"[serve:a] {label}: body {raw!r} != NumPy's {want}")
            if qc != {"device": units}:
                raise AssertionError(f"[serve:a] {label}: query counts {qc}")
            need = ("masked_agg", "dict_gather") + (("mask_take",) if filters else ())
            for k in need:
                if counts[k] <= 0:
                    raise AssertionError(f"[serve:a] {k} was not launched by {label}")
            bodies[label] = raw
            out[f"{label} s"] = secs
            log(f"[serve:a] POST /v1/query ({label}): {secs:.3f} s, {n_rows / secs:,.0f} input "
                f"rows/s, byte-equal to run_local_query's body and equal to NumPy's; units {qc}; "
                "launches " + ", ".join(f"{k}={v}" for k, v in counts.items()
                                        if isinstance(v, int) and v))
        status, _h, raw = serve_request(server, "POST", "/v1/plan",
                                        {"paths": [name], "filters": flt})
        plan = json.loads(raw)
        if status != 200 or plan["units_pruned_stats"] != 2 or plan["units"] != ROW_GROUPS - 2:
            raise AssertionError(f"[serve:a] plan of the filtered query: {status} {plan}")
        ops.reset_launch_counts()
        reset_query_device_counts()
        group_of = np.repeat(np.arange(ROW_GROUPS), RG_ROWS)
        for k in range(4):
            got = json.loads(query_ok(server, qbody(shard=[k, 4])))
            want = query_want(taxi_specs, (group_of % 4) == k, 2)
            if got != want:
                raise AssertionError(f"[serve:a] shard [{k}, 4]: body {got} != NumPy's {want}")
        launches["serve query shards"] = counts = kernel_counts()
        if query_device_counts() != {"device": ROW_GROUPS} or counts["masked_agg"] <= 0:
            raise AssertionError(f"[serve:a] shards: query counts {query_device_counts()}, "
                                 f"masked_agg {counts['masked_agg']}")
        reset_query_device_counts()
        status, _h, raw = serve_request(server, "POST", "/v1/query", {
            "paths": [name], "aggregates": ["count"], "group_by": ["vendor_id"]})
        qc = query_device_counts()
        code = json.loads(raw)["error"]["code"] if status != 200 else None
        if (status, code) != (400, "device_declined") or qc.get("declined", 0) < 1 or qc.get(
                "device"):
            raise AssertionError(f"[serve:a] group_by vendor_id: {status} {raw[:200]!r}, {qc}")
        log(f"[serve:a] /v1/plan of the filtered query prunes {plan['units_pruned_stats']} units by "
            f"statistics; shard [k, 4], k = 0..3, equal NumPy's over groups k and k + 4; "
            f"group_by vendor_id: {status} {code}, counted {qc}")
        idle(server, "(a)")
        # (b) concurrent clients, against one client and run_local_query
        want_raw = bodies["query filtered"]
        seq = []
        for _ in range(SERVE_PER_CLIENT):
            t = time.perf_counter()
            if query_ok(server, qbody(flt)) != want_raw:
                raise AssertionError("[serve:b] a sequential body differs from (a)'s")
            seq.append(time.perf_counter() - t)
        local = []
        for _ in range(3):
            t = time.perf_counter()
            run_local_query([str(taxi_path)], query_request(taxi_path, f_taxi), device=dev)
            local.append(time.perf_counter() - t)
        idle(server, "(b) sequential")
        before = ok_count(serve_counts())
        ops.reset_launch_counts()
        lat: list = []
        errors: list = []
        lock = threading.Lock()

        def client(i):
            try:
                for _ in range(SERVE_PER_CLIENT):
                    t = time.perf_counter()
                    raw = query_ok(server, qbody(flt), {"X-Tenant": f"tenant-{i % SERVE_TENANTS}"})
                    dt = time.perf_counter() - t
                    if raw != want_raw:
                        raise AssertionError(f"[serve:b] client {i}: body differs from (a)'s")
                    with lock:
                        lat.append(dt)
            except BaseException as e:  # noqa: BLE001 - raised below, in the phase's thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_WATCHDOG_S)
            if th.is_alive():
                raise AssertionError("[serve:b] a client thread hung")
        wall = time.perf_counter() - t
        if errors:
            raise errors[0]
        n_req = SERVE_CLIENTS * SERVE_PER_CLIENT
        serve_wait("(b) the 200s counted", lambda: ok_count(serve_counts()) - before >= n_req)
        idle(server, "(b)")
        launches["serve concurrent"] = counts = kernel_counts()
        rise = ok_count(serve_counts()) - before
        if rise != n_req or len(lat) != n_req:
            raise AssertionError(f"[serve:b] serve_requests_total status 200 rose by {rise}, "
                                 f"{len(lat)} bodies, for {n_req} requests")
        for k in ("masked_agg", "dict_gather", "mask_take"):
            if counts[k] <= 0:
                raise AssertionError(f"[serve:b] {k} was not launched by the concurrent queries")
        out["concurrent"] = {
            "clients": SERVE_CLIENTS, "requests": n_req, "seconds": wall,
            "requests_per_s": n_req / wall, "median_latency_s": statistics.median(lat),
            "max_latency_s": max(lat), "input_rows_per_s": n_req * n_rows / wall,
            "sequential_input_rows_per_s": n_rows / statistics.median(seq),
            "sequential_latency_s": seq,
            "run_local_query_input_rows_per_s": n_rows / statistics.median(local),
            "run_local_query_s": local,
        }
        c = out["concurrent"]
        log(f"[serve:b] {SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} filtered queries under "
            f"{SERVE_TENANTS} tenants: {n_req} bodies byte-equal to (a)'s in {wall:.2f} s, "
            f"{c['requests_per_s']:.2f} requests/s, latency median {c['median_latency_s']:.3f} s, "
            f"largest {c['max_latency_s']:.3f} s, {c['input_rows_per_s']:,.0f} input rows/s; one "
            f"client sequential {c['sequential_input_rows_per_s']:,.0f} input rows/s (latencies "
            f"{[round(x, 3) for x in seq]} s); run_local_query {c['run_local_query_input_rows_per_s']:,.0f} "
            f"(median of {[round(x, 3) for x in local]} s); serve_requests_total 200 +{rise}; "
            f"in flight 0 | {card}")
        log(f"[serve:b] profiler, one round of {SERVE_CLIENTS} concurrent filtered queries:")

        def one_round():
            ths = [threading.Thread(target=query_ok, args=(server, qbody(flt)))
                   for _ in range(SERVE_CLIENTS)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(SERVE_WATCHDOG_S)

        profile_device(one_round)
        idle(server, "(b) profiler")
        # (c) a scan and its plan
        cols = list(IO_PROJECTION)
        scan_body = {"paths": [name], "columns": cols, "filters": flt, "limit": SERVE_SCAN_LIMIT}
        ops.reset_launch_counts()
        t = time.perf_counter()
        status, got, tail = serve_scan_raw(server, scan_body)
        secs = time.perf_counter() - t
        if status != 200 or tail != b"0\r\n\r\n":
            raise AssertionError(f"[serve:c] scan: status {status}, stream tail {tail[:40]!r}")
        with FileReader(taxi_path, columns=cols, device=dev) as r:
            want = "".join(json.dumps(row, default=json_default) + "\n" for row in
                           itertools.islice(r.iter_rows(filters=f_taxi), SERVE_SCAN_LIMIT)).encode()
        if got != want:
            raise AssertionError(f"[serve:c] the scan's lines differ from iter_rows': "
                                 f"{got.count(b'\n')} lines, want {want.count(b'\n')}")
        counts = kernel_counts()
        if any(v for v in counts.values() if isinstance(v, int)):
            raise AssertionError(f"[serve:c] the row scan launched kernels: {counts}")
        out["scan"] = {"rows": SERVE_SCAN_LIMIT, "seconds": secs, "rows_per_s": SERVE_SCAN_LIMIT / secs,
                       "bytes": len(got)}
        qs = ("/v1/plan?paths=" + name + "&columns=" + ",".join(cols) + "&filters="
              + json.dumps(flt, separators=(",", ":")).replace(" ", "%20"))
        s1, _h, via_get = serve_request(server, "GET", qs)
        s2, _h, via_post = serve_request(server, "POST", "/v1/plan",
                                         {"paths": [name], "columns": cols, "filters": flt})
        plan = json.loads(via_post)
        from parquet_tpu_torch.serve.protocol import parse_scan_request

        units = server.service.session.plan(parse_scan_request(json.dumps(
            {"paths": [name], "filters": flt}).encode())).units
        if (s1, s2) != (200, 200) or via_get != via_post or plan["units_pruned_stats"] != 2 or [
                u.row_group for u in units] != list(range(ROW_GROUPS - 2)):
            raise AssertionError(f"[serve:c] plan: GET {s1} {via_get!r}, POST {s2} {via_post!r}")
        log(f"[serve:c] POST /v1/scan jsonl ({', '.join(cols)}; F_taxi; limit {SERVE_SCAN_LIMIT:,}): "
            f"{SERVE_SCAN_LIMIT:,} lines equal to iter_rows', {len(got):,} bytes in {secs:.2f} s, "
            f"{SERVE_SCAN_LIMIT / secs:,.0f} rows/s, ended by its 0-chunk, no kernel launched; "
            f"GET /v1/plan equals POST: {plan} (units of groups 0-5: 6 and 7 pruned) | {card}")
        idle(server, "(c)")
        # (d) appends into a lake table, queried on the card
        lake_dir = root / "serve-lake"
        shutil.rmtree(lake_dir, ignore_errors=True)
        lake = ScanServer(ServeConfig(root=str(root), port=0, device=dev, lake_root=str(lake_dir),
                                      lake_schema=TAXI_DSL, lake_sort_key="pickup_us"))
        servers.append(lake.start_background())
        n_app = SERVE_APPENDS * SERVE_APPEND_ROWS
        rows = taxi_rows(taxi_specs, n_app)
        payloads = [b"".join(json.dumps(r).encode() + b"\n"
                             for r in rows[k * SERVE_APPEND_ROWS:(k + 1) * SERVE_APPEND_ROWS])
                    for k in range(SERVE_APPENDS)]
        del rows
        acks = []
        t = time.perf_counter()
        for k, p in enumerate(payloads):
            last = k == SERVE_APPENDS - 1
            status, _h, raw = serve_request(lake, "POST", "/v1/append" + ("?flush=1" if last else ""),
                                            p, {"Content-Type": "application/x-ndjson"})
            if status != 200:
                raise AssertionError(f"[serve:d] append {k}: {status} {raw[:300]!r}")
            acks.append(json.loads(raw))
        secs = time.perf_counter() - t
        gen = LakeTable.open(str(lake_dir)).manifest.current_generation()
        if any(a["rows"] != SERVE_APPEND_ROWS for a in acks) or not acks[-1]["flushed"] or acks[
                -1]["generation"] != gen:
            raise AssertionError(f"[serve:d] acks {acks}, table generation {gen}")
        flushed = sum(a["flushed"] for a in acks)
        ops.reset_launch_counts()
        reset_query_device_counts()
        got = json.loads(query_ok(lake, {"paths": ["serve-lake"], "aggregates": spec}))
        launches["serve lake query"] = counts = kernel_counts()
        keep = np.zeros(n_rows, bool)
        keep[:n_app] = True
        want = query_want(taxi_specs, keep, 1)
        if (got["result"] != want["result"] or got["rows_scanned"] != n_app
                or got["rows_matched"] != n_app):
            raise AssertionError(f"[serve:d] the table's query {got} != NumPy's {want['result']}")
        if query_device_counts() != {"device": got["units"]} or counts["masked_agg"] <= 0:
            raise AssertionError(f"[serve:d] query counts {query_device_counts()}, "
                                 f"masked_agg {counts['masked_agg']}")
        status, _h, raw = serve_request(lake, "POST", "/v1/append", b"\xff\xff",
                                        {"Content-Type": "application/vnd.apache.arrow.stream"})
        code = json.loads(raw)["error"]["code"]
        if (status, code) != (415, "unsupported_format"):
            raise AssertionError(f"[serve:d] arrow-ipc append: {status} {raw!r}")
        out["append"] = {"rows": n_app, "seconds": secs, "rows_per_s": n_app / secs,
                         "generations": gen, "flushes": flushed, "query_units": got["units"]}
        log(f"[serve:d] {SERVE_APPENDS} jsonl appends of {SERVE_APPEND_ROWS:,} taxi rows, the last "
            f"with ?flush=1: {secs:.2f} s, {n_app / secs:,.0f} rows/s; {flushed} acks flushed, the "
            f"table at generation {gen}; /v1/query of the table on the card over {got['units']} "
            f"units equals NumPy's over the {n_app:,} rows; launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if isinstance(v, int) and v)
            + f"; an arrow-ipc append: {status} {code} | {card}")
        idle(lake, "(d)")
        lake.close()
        servers.remove(lake)
        shutil.rmtree(lake_dir, ignore_errors=True)
        # (e) the byte budget, then a drain with a query held in flight
        budget = ScanServer(ServeConfig(root=str(root), port=0, device=dev, tenant_budget_mb=1,
                                        budget_window_s=3600.0)).start_background()
        servers.append(budget)
        first = query_ok(budget, qbody(), {"X-Tenant": "alice"})
        status, _h, raw = serve_request(budget, "POST", "/v1/query", qbody(), {"X-Tenant": "alice"})
        code = json.loads(raw)["error"]["code"] if status != 200 else None
        other = query_ok(budget, qbody(), {"X-Tenant": "bob"})
        est = json.loads(serve_request(budget, "POST", "/v1/plan", {
            "paths": [name], "columns": list(QUERY_COLUMNS)})[2])["estimated_bytes"]
        if first != bodies["query"] or other != bodies["query"] or (status, code) != (
                429, "tenant_over_budget"):
            raise AssertionError(f"[serve:e] budget: alice's second {status} {raw[:200]!r}")
        idle(budget, "(e) budget")
        budget.close()
        servers.remove(budget)
        gate = threading.Event()
        held = ScanServer(ServeConfig(root=str(root), port=0, device=dev, cache_mb=0,
                                      source_factory=lambda p: GatedSource(p, gate)))
        servers.append(held.start_background())
        res: dict = {}

        def hold():
            try:
                res["resp"] = serve_request(held, "POST", "/v1/query", qbody())
            except BaseException as e:  # noqa: BLE001 - raised below
                res["error"] = e

        th = threading.Thread(target=hold)
        th.start()
        serve_wait("(e) the held query admitted", lambda: held.service.admission.in_flight == 1)
        drained: dict = {}
        dr = threading.Thread(target=lambda: drained.setdefault("ok", held.drain(SERVE_WATCHDOG_S)))
        dr.start()
        serve_wait("(e) draining", lambda: held.service.admission.draining)
        s_new, _h, raw_new = serve_request(held, "POST", "/v1/query", qbody())
        s_h, h_h, raw_h = serve_request(held, "GET", "/healthz")
        health = json.loads(raw_h)
        gate.set()
        th.join(SERVE_WATCHDOG_S)
        dr.join(SERVE_WATCHDOG_S)
        if th.is_alive() or dr.is_alive() or "error" in res:
            raise AssertionError(f"[serve:e] the held query or the drain hung: {res}")
        if (s_new, json.loads(raw_new)["error"]["code"]) != (503, "draining"):
            raise AssertionError(f"[serve:e] a new query while draining: {s_new} {raw_new!r}")
        if s_h != 503 or health["status"] != "draining" or "retry_after_s" not in health:
            raise AssertionError(f"[serve:e] /healthz while draining: {s_h} {health}")
        if res["resp"][0] != 200 or res["resp"][2] != bodies["query"] or drained.get("ok") is not True:
            raise AssertionError(f"[serve:e] the held query: {res['resp'][0]}, drained {drained}")
        if held.service.admission.in_flight:
            raise AssertionError("[serve:e] a ticket outlived the drain")
        held.close()
        servers.remove(held)
        log(f"[serve:e] tenant_budget_mb=1 (a full query's estimate {est:,} bytes): alice's first "
            f"query answered (a full bucket admits it), her second {status} {code}, bob's answered; "
            f"drain() with a query held in flight: a new query 503 draining, /healthz {s_h} "
            f"{health}, the held query's body equal to (a)'s, drained {drained['ok']}")
        idle(server, "(e)")
    finally:
        for s in servers:
            s.close()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[serve] the phase took {out['seconds']:.1f} s | {card}")
    torch.cuda.synchronize()
    return out


MESH_CLIENTS = 8
MESH_PER_CLIENT = 3
MESH_FAULT_REQUESTS = 12  # backend requests each flaky proxy must see in (b)
MESH_FAULT_QUERIES = 16  # at most this many queries in each of (b)'s two runs
MESH_SCAN_SPAN = 100_000  # trip ids either side of the group 0 / group 1 boundary
CHAOS_SLO_MS = 100.0
CHAOS_BATCH = 1 << 18


def mesh_kill_order(router, urls, sig: str, units: int) -> list:
    """The router's replica URLs, the one that owns the most of a request's
    keys (its plan probe and its unit keys) first: killing it makes every
    later request of that signature attempt a dead replica."""
    ring = router.service.client.ring
    keys = [sig] + [f"{sig}#{k}" for k in range(units)]
    owned = collections.Counter(ring.lookup(k) for k in keys)
    return sorted(urls, key=lambda u: -owned[u])


def check_mesh(taxi_path, taxi_specs, f_taxi, taxi_keep, dev, launches: dict, card: str) -> dict:
    """The mesh-and-chaos phase, in this process over loopback. (a) Three
    replica ScanServers(device=dev) over the smoke directory, a direct
    daemon, and a MeshRouter over the replicas: /v1/query of
    query_aggregates(), unfiltered and under F_taxi, scattered over taxi's
    units, each body byte-equal to the direct daemon's and to NumPy's
    (query_want); /v1/scan jsonl of IO_PROJECTION under F_taxi narrowed to
    MESH_SCAN_SPAN trip ids either side of group 1's start (2 units)
    byte-equal to the direct daemon's, its lines NumPy's count; /v1/plan
    equal; mesh_counts() in scatter mode; masked_agg, dict_gather and
    (filtered) mask_take launched by the replicas. (b) A FlakyReplica with
    error_rate=0.2, then one with short_rate=0.5, in front of one replica:
    queries until the proxy has relayed MESH_FAULT_REQUESTS backend
    requests, every body byte-equal to (a)'s, faults injected and
    failovers counted. (c) Every replica behind a fault-free FlakyReplica
    (the network path), a router with breaker_failures=2: MESH_CLIENTS
    threads x MESH_PER_CLIENT filtered queries, and the replica owning most
    of the query's keys closed while they run: every answer byte-equal to
    (a)'s or a typed 503, none torn; the dead path's breaker opens and
    /healthz counts it. (d) (c)'s requests/s, median and largest latency
    and input rows/s against the same clients on the direct daemon.
    (e) run_dataset_chaos over taxi (DATASET_COLUMNS, nullable="zero")
    with CUDA delivery under standard_schedule(phase_s=1.0) and the
    harness's breaker, retry and hedge layers, with the SLO controller
    attached and detached: no raise, every batch on the card, each phase's
    p50, p99 and violation share, the controller's state(), units skipped,
    hedges and retries. Every daemon, proxy and router ends with 0 in
    flight and is closed. Prints each step's figures beside `card`;
    returns the numbers."""
    import threading

    import torch

    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.serve import (
        MeshConfig,
        MeshRouter,
        ScanServer,
        ServeConfig,
        mesh_counts,
        query_device_counts,
        reset_mesh_counts,
        reset_query_device_counts,
    )
    from parquet_tpu_torch.testing.chaos import ChaosHarness, run_dataset_chaos, standard_schedule
    from parquet_tpu_torch.testing.flaky_replica import FlakyReplica

    t_phase = time.perf_counter()
    root = taxi_path.parent
    name = taxi_path.name
    n_rows = ROW_GROUPS * RG_ROWS
    out: dict = {}
    flt = [[list(t) for t in conj] for conj in f_taxi]
    spec = ["count", ["count", "passenger_count"]]
    for c in QUERY_COLUMNS:
        spec += [["sum", c], ["min", c], ["max", c]]

    def qbody(filters=None):
        b = {"paths": [name], "aggregates": spec}
        if filters is not None:
            b["filters"] = filters
        return b

    def post(server, path, body):
        status, _h, raw = serve_request(server, "POST", path, body)
        if status != 200:
            raise AssertionError(f"[mesh] {path} {body}: {status} {raw[:300]!r}")
        return raw

    def retries() -> int:
        return sum(v for k, v in mesh_counts().items() if k.startswith("mesh_retries_total"))

    closed: set = set()
    made = []  # every daemon, proxy and router, closed in the finally

    def start(thing):
        made.append(thing)
        return thing.start_background() if hasattr(thing, "start_background") else thing.start()

    def close(thing):
        if hasattr(thing, "service"):
            serve_wait(f"{thing.url}: in flight back to 0",
                       lambda: thing.service.admission.in_flight == 0)
        thing.close()
        closed.add(id(thing))

    try:
        replicas = [start(ScanServer(ServeConfig(root=str(root), port=0, device=dev)))
                    for _ in range(3)]
        direct = start(ScanServer(ServeConfig(root=str(root), port=0, device=dev)))
        router = start(MeshRouter(MeshConfig(port=0, replicas=tuple(r.url for r in replicas))))
        log(f"[mesh] 3 replica ScanServers and a direct daemon (device={dev.type!r}), a MeshRouter "
            f"over the replicas at {router.url} | {card}")
        # (a) routed equals direct
        bodies = {}
        for label, filters, keep, units in (("query", None, np.ones(n_rows, bool), ROW_GROUPS),
                                            ("query filtered", flt, taxi_keep, ROW_GROUPS - 2)):
            want_raw = post(direct, "/v1/query", qbody(filters))
            ops.reset_launch_counts()
            reset_query_device_counts()
            reset_mesh_counts()
            t = time.perf_counter()
            raw = post(router, "/v1/query", qbody(filters))
            secs = time.perf_counter() - t
            launches[f"mesh {label}"] = counts = kernel_counts()
            qc = query_device_counts()
            mc = mesh_counts()
            want = query_want(taxi_specs, keep, units)
            if raw != want_raw:
                raise AssertionError(f"[mesh:a] {label}: the router's body differs from the direct "
                                     f"daemon's: {raw[:300]!r} vs {want_raw[:300]!r}")
            if json.loads(raw) != want:
                raise AssertionError(f"[mesh:a] {label}: body {raw!r} != NumPy's {want}")
            if (qc != {"device": units}
                    or mc.get('mesh_requests_total{endpoint="/v1/query",mode="scatter"}') != 1
                    or mc.get('mesh_scatter_units_total{endpoint="/v1/query"}') != units):
                raise AssertionError(f"[mesh:a] {label}: query counts {qc}, mesh counts {mc}")
            need = ("masked_agg", "dict_gather") + (("mask_take",) if filters else ())
            for k in need:
                if counts[k] <= 0:
                    raise AssertionError(f"[mesh:a] {k} was not launched by the routed {label}")
            bodies[label] = raw
            out[f"{label} s"] = secs
            log(f"[mesh:a] routed /v1/query ({label}): {secs:.3f} s, {n_rows / secs:,.0f} input "
                f"rows/s, {units} units scattered, byte-equal to the direct daemon's body and equal "
                f"to NumPy's; units {qc}; launches "
                + ", ".join(f"{k}={v}" for k, v in counts.items() if isinstance(v, int) and v))
        lo = 10**9 + RG_ROWS - MESH_SCAN_SPAN
        hi = 10**9 + RG_ROWS + MESH_SCAN_SPAN
        scan_flt = [conj + [["trip_id", ">=", lo], ["trip_id", "<", hi]] for conj in flt]
        scan_body = {"paths": [name], "columns": list(IO_PROJECTION), "filters": scan_flt}
        plan_body = {"paths": [name], "columns": list(IO_PROJECTION), "filters": scan_flt}
        plan_r, plan_d = post(router, "/v1/plan", plan_body), post(direct, "/v1/plan", plan_body)
        if plan_r != plan_d or json.loads(plan_r)["units"] != 2:
            raise AssertionError(f"[mesh:a] plan: router {plan_r!r}, direct {plan_d!r}")
        ops.reset_launch_counts()
        reset_mesh_counts()
        t = time.perf_counter()
        scan_r = post(router, "/v1/scan", scan_body)
        secs = time.perf_counter() - t
        scan_d = post(direct, "/v1/scan", scan_body)
        trip = np.arange(n_rows, dtype=np.int64) + 10**9
        lines = int((taxi_keep & (trip >= lo) & (trip < hi)).sum())
        mc = mesh_counts()
        if scan_r != scan_d or scan_r.count(b"\n") != lines:
            raise AssertionError(f"[mesh:a] scan: router {scan_r.count(b'\n')} lines, direct "
                                 f"{scan_d.count(b'\n')}, NumPy {lines}; equal {scan_r == scan_d}")
        if mc.get('mesh_requests_total{endpoint="/v1/scan",mode="scatter"}') != 1:
            raise AssertionError(f"[mesh:a] scan: mesh counts {mc}")
        out["scan"] = {"lines": lines, "bytes": len(scan_r), "seconds": secs}
        log(f"[mesh:a] routed /v1/scan jsonl ({', '.join(IO_PROJECTION)}; F_taxi and trip_id in "
            f"[{lo}, {hi})): 2 units scattered, {lines:,} lines byte-equal to the direct daemon's "
            f"({len(scan_r):,} bytes) in {secs:.2f} s; /v1/plan equal: {json.loads(plan_r)} | {card}")
        # (b) wire faults between the router and one replica
        ops.reset_launch_counts()
        out["faults"] = {}
        for label, knobs in (("error_rate=0.2", dict(error_rate=0.2)),
                             ("short_rate=0.5", dict(short_rate=0.5))):
            proxy = start(FlakyReplica(replicas[0].url, seed=11, **knobs))
            flaky = start(MeshRouter(MeshConfig(port=0, replicas=(
                proxy.url, replicas[1].url, replicas[2].url))))
            reset_mesh_counts()
            n_queries = 0
            t = time.perf_counter()
            while proxy.requests < MESH_FAULT_REQUESTS and n_queries < MESH_FAULT_QUERIES:
                for lbl in ("query", "query filtered"):
                    raw = post(flaky, "/v1/query", qbody(flt if "filtered" in lbl else None))
                    n_queries += 1
                    if raw != bodies[lbl]:
                        raise AssertionError(f"[mesh:b] {label}: a {lbl} body differs from (a)'s")
            secs = time.perf_counter() - t
            fails = {k: v for k, v in mesh_counts().items() if k.startswith("mesh_retries_total")}
            if proxy.faults_injected <= 0 or retries() <= 0:
                raise AssertionError(f"[mesh:b] {label}: {proxy.faults_injected} faults injected "
                                     f"in {proxy.requests} requests, failovers {fails}")
            out["faults"][label] = {"queries": n_queries, "seconds": secs,
                                    "proxy_requests": proxy.requests,
                                    "faults_injected": proxy.faults_injected, "failovers": fails}
            log(f"[mesh:b] FlakyReplica({label}) in front of one replica: {n_queries} queries in "
                f"{secs:.2f} s, every body byte-equal to (a)'s; the proxy relayed {proxy.requests} "
                f"requests, injected {proxy.faults_injected} faults; failovers {fails} | {card}")
            close(flaky)
            close(proxy)
        # (c) a dead replica under 8 clients
        paths = [start(FlakyReplica(r.url, seed=k)) for k, r in enumerate(replicas)]
        fleet = start(MeshRouter(MeshConfig(port=0, replicas=tuple(p.url for p in paths),
                                            breaker_failures=2,
                                            breaker_open_s=SERVE_WATCHDOG_S)))
        order = mesh_kill_order(fleet, [p.url for p in paths], name, ROW_GROUPS - 2)
        victim = replicas[[p.url for p in paths].index(order[0])]
        want_raw = bodies["query filtered"]

        def hammer(server):
            lat: list = []
            results: list = []
            errors: list = []
            lock = threading.Lock()

            def client():
                try:
                    for _ in range(MESH_PER_CLIENT):
                        t = time.perf_counter()
                        status, _h, raw = serve_request(server, "POST", "/v1/query", qbody(flt))
                        dt = time.perf_counter() - t
                        if status == 200 and raw == want_raw:
                            kind = "ok"
                        elif status == 503 and json.loads(raw)["error"]["code"] in (
                                "partial_failure", "no_replicas"):
                            kind = "typed 503"
                        else:
                            raise AssertionError(f"[mesh:c] an answer neither (a)'s nor a typed "
                                                 f"503: {status} {raw[:300]!r}")
                        with lock:
                            results.append(kind)
                            lat.append(dt)
                except BaseException as e:  # noqa: BLE001 - raised below, in the phase's thread
                    errors.append(e)

            threads = [threading.Thread(target=client) for _ in range(MESH_CLIENTS)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            return threads, t, lat, results, errors

        def join(threads, t0, errors):
            for th in threads:
                th.join(SERVE_WATCHDOG_S)
                if th.is_alive():
                    raise AssertionError("[mesh] a client thread hung")
            if errors:
                raise errors[0]
            return time.perf_counter() - t0

        reset_mesh_counts()
        threads, t0, lat, results, errors = hammer(fleet)
        serve_wait("(c) the first answers", lambda: len(results) >= MESH_CLIENTS or errors)
        victim.close()  # a hard close: requests may be in flight on it
        closed.add(id(victim))
        wall = join(threads, t0, errors)
        serve_wait("(c) the closed replica's in flight back to 0",
                   lambda: victim.service.admission.in_flight == 0)
        dead = fleet.service.table.by_url[order[0]]
        extra = 0
        while dead.breaker.state != "open" and extra < 8:
            status, _h, raw = serve_request(fleet, "POST", "/v1/query", qbody(flt))
            if status != 200 or raw != want_raw:
                raise AssertionError(f"[mesh:c] a query after the kill: {status} {raw[:300]!r}")
            extra += 1
        status, _h, raw = serve_request(fleet, "GET", "/healthz")
        health = json.loads(raw)
        mc = mesh_counts()
        if dead.breaker.state != "open" or dead.state() != "open-breaker" or status != 200 or (
                health["replicas"]["open-breaker"] != 1):
            raise AssertionError(f"[mesh:c] the dead replica: breaker {dead.breaker.state}, "
                                 f"/healthz {status} {health}")
        kinds = collections.Counter(results)
        n_req = MESH_CLIENTS * MESH_PER_CLIENT
        if sum(kinds.values()) != n_req or not kinds["ok"]:
            raise AssertionError(f"[mesh:c] answers {dict(kinds)} for {n_req} requests")
        fails = {k: v for k, v in mc.items() if k.startswith("mesh_retries_total")}
        log(f"[mesh:c] {MESH_CLIENTS} clients x {MESH_PER_CLIENT} filtered queries, the replica "
            f"owning most of the query's keys closed under them: answers {dict(kinds)}, none torn; "
            f"{extra} more queries until its breaker opened; failovers {fails}; /healthz {health}")
        # (b) and (c) reached the card only through the routers' replicas
        launches["mesh faults and clients"] = kernel_counts()
        # (d) (c)'s clients against the direct daemon
        okl = [dt for dt, k in zip(lat, results) if k == "ok"]
        ops.reset_launch_counts()
        threads, t0, dlat, dres, derr = hammer(direct)
        dwall = join(threads, t0, derr)
        launches["serve direct clients (mesh phase)"] = kernel_counts()
        if set(dres) != {"ok"}:
            raise AssertionError(f"[mesh:d] the direct daemon's answers {collections.Counter(dres)}")
        out["clients"] = {
            "clients": MESH_CLIENTS, "requests": n_req, "answers": dict(kinds),
            "router": {"seconds": wall, "requests_per_s": n_req / wall,
                       "median_latency_s": statistics.median(okl), "max_latency_s": max(lat),
                       "input_rows_per_s": kinds["ok"] * n_rows / wall},
            "direct": {"seconds": dwall, "requests_per_s": n_req / dwall,
                       "median_latency_s": statistics.median(dlat), "max_latency_s": max(dlat),
                       "input_rows_per_s": n_req * n_rows / dwall},
        }
        for who in ("router", "direct"):
            c = out["clients"][who]
            log(f"[mesh:d] {who}: {n_req} filtered queries from {MESH_CLIENTS} clients in "
                f"{c['seconds']:.2f} s, {c['requests_per_s']:.2f} requests/s, latency median "
                f"{c['median_latency_s']:.3f} s, largest {c['max_latency_s']:.3f} s, "
                f"{c['input_rows_per_s']:,.0f} input rows/s | {card}")
        for thing in reversed(made):
            if id(thing) not in closed:
                close(thing)
        # (e) chaos on the dataset, CUDA delivery
        out["chaos"] = {}
        for label, attached in (("controller", True), ("detached", False)):
            sched = standard_schedule(phase_s=1.0)
            with ChaosHarness(sched, seed=29, breaker=True, retry=True, hedge=True,
                              retry_kw={"attempts": 3, "base_delay_s": 0.001,
                                        "max_delay_s": 0.01},
                              breaker_kw={"failure_threshold": 5, "open_s": 0.5},
                              hedge_kw={"min_delay_s": 0.005, "initial_delay_s": 0.02}) as chaos:
                rep = run_dataset_chaos(str(taxi_path), chaos=chaos, batch_size=CHAOS_BATCH,
                                        columns=list(DATASET_COLUMNS), slo_wait_ms=CHAOS_SLO_MS,
                                        enable_controller=attached, device=dev,
                                        dataset_kw={"nullable": "zero"})
            if rep["devices"] != [dev.type] or rep["batches"] <= 0:
                raise AssertionError(f"[mesh:e] {label}: {rep['batches']} batches on "
                                     f"{rep['devices']}")
            if any(not rep["phases"][p]["waits"] for p in ("warmup", "latency_spike", "recovery")):
                raise AssertionError(f"[mesh:e] {label}: a phase saw no batch: {rep['phases']}")
            out["chaos"][label] = rep
            log(f"[mesh:e] run_dataset_chaos(taxi, batch {CHAOS_BATCH}, slo_wait_ms={CHAOS_SLO_MS}, "
                f"controller {'attached' if attached else 'detached'}), {dev.type} delivery: "
                f"{rep['batches']} batches, {rep['rows']:,} rows in {rep['wall_s']:.2f} s, every one "
                f"on the card; faults {rep['faults_injected']}, spikes {rep['spikes_injected']}, "
                f"units skipped {rep['units_skipped']}, hedges {rep['hedge']}, retries "
                f"{rep['retries']}, violations counted {rep['slo_violations_total']}; controller "
                f"{rep['controller']} | {card}")
            for p, row in rep["phases"].items():
                log(f"[mesh:e]   {label} {p}: {row['waits']} waits, p50 {row['p50_ms']} ms, p99 "
                    f"{row['p99_ms']} ms, max {row['max_ms']} ms, violation share "
                    f"{row['violation_share']}")
    finally:
        for thing in made:
            if id(thing) not in closed:
                thing.close()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] the phase took {out['seconds']:.1f} s | {card}")
    torch.cuda.synchronize()
    return out


def smoke_dir() -> Path:
    """The directory of the cached main-path files."""
    from parquet_tpu_torch.kernels.build import BUILD_ROOT

    (BUILD_ROOT / "smoke").mkdir(parents=True, exist_ok=True)
    return BUILD_ROOT / "smoke"


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=0,
                    help="run only the multi-rank check, over this many ranks, one card each")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.ranks and torch.cuda.device_count() < args.ranks:
        print(f"chip_smoke: --ranks {args.ranks} needs {args.ranks} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from parquet_tpu_torch import reset_write_counts, write_counts
    from parquet_tpu_torch.core.reader import FileReader, filter_counts, reset_filter_counts
    from parquet_tpu_torch.kernels import build
    from parquet_tpu_torch.kernels import device_ops as ops
    from parquet_tpu_torch.kernels.pipeline import (
        dispatch,
        prepare_counts,
        reset_prepare_counts,
        to_device,
    )
    from parquet_tpu_torch.utils.native import get_native

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    smi = cards[0]
    bw = mem_bandwidth(name)
    log(f"[device] {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    for card in cards:
        log(card)

    build.load()
    log(f"[build] kernels built and loaded in {build.build_seconds():.2f} s")
    t = time.perf_counter()
    get_native()
    log(f"[build] host library built and loaded in {time.perf_counter() - t:.2f} s")
    if args.ranks:
        check_ranks(args.ranks)
        log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0

    csrc = "parquet_tpu_torch/kernels/csrc/"
    sources = {
        "expand_hybrid": (csrc + "expand_hybrid.cu", "parquet_tpu/kernels/device_ops.py:108"),
        "dict_gather": (csrc + "dict_gather.cu", "parquet_tpu/kernels/device_ops.py:256"),
        "delta_packed_decode": (csrc + "delta_packed_decode.cu",
                                "parquet_tpu/kernels/device_ops.py:152"),
        "bss_transpose": (csrc + "bss_transpose.cu", "parquet_tpu/kernels/device_ops.py:245"),
        "merge_mixed_numeric": (csrc + "merge_mixed_numeric.cu",
                                "parquet_tpu/kernels/device_ops.py:689"),
        "merge_mixed_bytes": (csrc + "merge_mixed_bytes.cu",
                              "parquet_tpu/kernels/device_ops.py:718"),
        "record_starts": (csrc + "record_starts.cu", "parquet_tpu/kernels/device_ops.py:262"),
        "list_layout": (csrc + "list_layout.cu", "parquet_tpu/kernels/device_ops.py:275"),
        "pad_ragged": (csrc + "pad_ragged.cu", "parquet_tpu/core/reader.py:242"),
        "expand_nullable": (csrc + "expand_nullable.cu", "parquet_tpu/core/reader.py:286"),
        "predicate_mask": (csrc + "predicate_mask.cu", "parquet_tpu/kernels/device_ops.py:327"),
        "leaf_verdict": (csrc + "leaf_verdict.cu", "parquet_tpu/core/filter_device.py:169"),
        "list_contains_mask": (csrc + "list_contains_mask.cu",
                               "parquet_tpu/kernels/device_ops.py:355"),
        "mask_take": (csrc + "mask_take.cu", "parquet_tpu/kernels/device_ops.py:388"),
        "bitpack_encode": (csrc + "bitpack_encode.cu", "parquet_tpu/kernels/device_ops.py:411"),
        "rle_hybrid_encode": (csrc + "rle_hybrid_encode.cu",
                              "parquet_tpu/kernels/device_ops.py:445"),
        "dict_indices": (csrc + "dict_indices.cu", "parquet_tpu/kernels/device_ops.py:512"),
        "delta_block_encode": (csrc + "delta_block_encode.cu",
                               "parquet_tpu/kernels/device_ops.py:553"),
        "plain_bytearray_encode": (csrc + "plain_bytearray_encode.cu",
                                   "parquet_tpu/kernels/device_ops.py:630"),
        "masked_agg": (csrc + "masked_agg.cu", "parquet_tpu/kernels/device_ops.py:664"),
        "expand_page_grid": (csrc + "expand_page_grid.cu", "parquet_tpu/parallel/mesh.py:91"),
    }
    rows = {
        k: {"name": k, "route": "cuda", "source": src, "replaces": rep}
        for k, (src, rep) in sources.items()
    }

    def on_dispatch(fn, *args):
        """fn(*args) on the pqt-dispatch thread, under its own stream: the
        kernels are held against their plain versions where the main paths
        launch them."""
        return dispatch(fn, dev, *args).result(timeout=1200)

    log(f"[kernels] the checks run on the pqt-dispatch thread, on its stream "
        f"{on_dispatch(lambda: torch.cuda.current_stream())} (the caller's is "
        f"{torch.cuda.current_stream()})")
    log("[kernels] each kernel against its plain version on the card (bit-exact)")
    on_dispatch(check_kernels, dev, rows)
    log("[kernels] the batch path's kernels at edge shapes")
    on_dispatch(check_batch_kernels, dev, rows)
    log("[kernels] the filter path's kernels at edge shapes")
    on_dispatch(check_filter_kernels, dev, rows)
    log("[kernels] the write path's kernels at edge shapes")
    on_dispatch(check_write_kernels, dev, rows)
    log("[kernels] the query and multi-device paths' kernels at edge shapes")
    on_dispatch(check_query_kernels, dev, rows)

    launches: dict[str, dict] = {}

    def drive(label, path, specs, need, no_host_fallback, check=check_main_path, then=None):
        """One main-path read (and `then(groups)`, the path's use of what it
        read) with the launch and prepare counts zeroed just before and read
        just after; checks the columns and the counts."""
        ops.reset_launch_counts()
        reset_prepare_counts()
        t = time.perf_counter()
        reader = FileReader(path)
        groups = reader.read_row_groups_device()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        if then is not None:
            then(groups)
        counts = kernel_counts()
        prep = prepare_counts()
        launches[label] = counts
        log(f"[main:{label}] read_row_groups_device: {secs:.2f} s, launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items())
            + f", stats {reader.stats}, prepare {prep}")
        check(groups, specs, reader.stats, no_host_fallback)
        for k in need:
            if counts[k] <= 0:
                raise AssertionError(f"{k} was not launched on the {label} path")
        chunks = ROW_GROUPS * len(specs)
        bad = {k: v for k, v in prep.items()
               if k.startswith("prepare_fused_fault_")
               or k in ("prepare_fused_declined", "prepare_fallback_recovered")}
        if prep.get("prepare_fused_engaged") != chunks or bad:
            raise AssertionError(
                f"{label}: fused walk engaged {prep.get('prepare_fused_engaged')} of "
                f"{chunks} chunks; declines/faults/recoveries {bad}")
        del groups
        rt = FileReader(path, backend="device_roundtrip")
        host = FileReader(path, backend="host")
        a, b = rt.read_row_group(0), host.read_row_group(0)
        if a.keys() != b.keys() or not all(chunks_equal(a[p], b[p]) for p in a):
            raise AssertionError(f"{label}: device_roundtrip row group 0 differs from host decode")
        log(f"[main:{label}] columns equal the generator; fused walk on all {chunks} chunks; "
            "device_roundtrip row group 0 equals host decode")
        return prep

    paths = {}
    for label, make in (("taxi", taxi_columns), ("taxi_mixed", mixed_columns),
                        ("sessions", sessions_columns)):
        t = time.perf_counter()
        specs = make(SEED)
        path = smoke_file(specs, label.replace("_", "-"))
        paths[label] = (path, specs)
        log(f"[main:{label}] {path.name}: {ROW_GROUPS * RG_ROWS} rows, "
            f"{path.stat().st_size / 2**20:.1f} MiB, ready in {time.perf_counter() - t:.1f} s")
    n_rows = ROW_GROUPS * RG_ROWS
    mixed_path = paths["taxi_mixed"][0]

    log("[kernels] the mixed path's kernels at its shapes and at edge shapes")
    on_dispatch(check_new_kernels, dev, rows, mixed_path)

    drive("taxi", *paths["taxi"],
          need=("expand_hybrid", "dict_gather", "delta_packed_decode"), no_host_fallback=True)
    prep = drive("taxi_mixed", *paths["taxi_mixed"],
                 need=("expand_hybrid", "dict_gather", "bss_transpose",
                       "merge_mixed_numeric", "merge_mixed_bytes"),
                 no_host_fallback=False)
    for route in ("route_merge_numeric", "route_merge_bytes", "route_bss", "route_host_merge"):
        if prep.get(route, 0) <= 0:
            raise AssertionError(f"taxi_mixed: {route} never taken ({prep})")
    # fare_amount is the one BYTE_STREAM_SPLIT column: one launch a chunk
    if launches["taxi_mixed"]["bss_transpose"] != ROW_GROUPS:
        raise AssertionError(f"taxi_mixed: {launches['taxi_mixed']['bss_transpose']} "
                             f"bss_transpose launches for {ROW_GROUPS} chunks")
    sessions_path, sessions_specs = paths["sessions"]
    drive("sessions", sessions_path, sessions_specs,
          need=("expand_hybrid", "dict_gather", "delta_packed_decode", "list_layout",
                "record_starts"),
          no_host_fallback=True, check=check_sessions,
          then=lambda groups: check_layouts(groups, sessions_specs))
    log("[main:sessions] list_layout(0, 2) and record_starts on every items group equal "
        "the generator's offsets, null mask and row ids")

    batch_paths = {
        "taxi batches": (paths["taxi"][0], dict(nullable="mask"), taxi_step,
                         taxi_totals(paths["taxi"][1]),
                         ("expand_hybrid", "dict_gather", "delta_packed_decode",
                          "expand_nullable")),
        "sessions batches": (sessions_path, dict(lists="pad", max_list_len=MAX_LIST_LEN),
                             sessions_step, sessions_totals(sessions_specs),
                             ("expand_hybrid", "dict_gather", "delta_packed_decode",
                              "pad_ragged")),
    }
    for label, (path, kwargs, step, want, need) in batch_paths.items():
        ops.reset_launch_counts()
        t = time.perf_counter()
        got, n_batches = run_batches(path, kwargs, step)
        secs = time.perf_counter() - t
        counts = kernel_counts()
        launches[label] = counts
        log(f"[batches:{label}] iter_device_batches({BATCH}, {kwargs}): {n_batches} batches in "
            f"{secs:.2f} s, launches " + ", ".join(f"{k}={v}" for k, v in counts.items()))
        if got != want:
            raise AssertionError(f"{label}: step totals {got} differ from the generator's {want}")
        if n_batches != -(-n_rows // BATCH):
            raise AssertionError(f"{label}: {n_batches} batches for {n_rows} rows")
        for k in need:
            if counts[k] <= 0:
                raise AssertionError(f"{k} was not launched on the {label} path")
        log(f"[batches:{label}] step totals equal the generator's: {got}")
    # the filtered paths: two batch streams compacted on the card, and a
    # filtered read per group; statistics prune groups 6 and 7 of both files
    taxi_path, taxi_specs = paths["taxi"]
    f_taxi, taxi_keep = taxi_filter(taxi_specs)
    f_sessions, _sessions_keep, sessions_want = sessions_filter(sessions_specs)
    filtered_paths = {
        "taxi filtered batches": (taxi_path, dict(nullable="mask", filters=f_taxi,
                                                  filter_rows=True), taxi_step,
                                  taxi_filtered_totals(taxi_specs, taxi_keep)),
        "sessions filtered batches": (sessions_path, dict(lists="pad", max_list_len=MAX_LIST_LEN,
                                                          filters=f_sessions, filter_rows=True),
                                      sessions_step, sessions_want),
    }
    filter_need = ("predicate_mask", "mask_take")
    for label, (path, kwargs, step, want) in filtered_paths.items():
        ops.reset_launch_counts()
        reset_filter_counts()
        t = time.perf_counter()
        got, n_batches = run_batches(path, kwargs, step)
        secs = time.perf_counter() - t
        counts = kernel_counts()
        fc = filter_counts()
        launches[label] = counts
        log(f"[filter:{label}] {n_batches} batches, {got.get('rows', 0)} of {n_rows} rows kept "
            f"in {secs:.2f} s; filter counts {fc}; launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items()))
        if got != want:
            raise AssertionError(f"{label}: step totals {got} differ from NumPy's {want}")
        admitted = ROW_GROUPS - 2
        if (fc.get("groups_pruned_stats") != 2 or fc.get("groups_pruned_bloom")
                or fc.get("device_filter_engaged") != admitted
                or fc.get("device_filter_declined")):
            raise AssertionError(f"{label}: filter counts {fc}, expected 2 groups pruned by "
                                 f"statistics and the device engine on all {admitted} others")
        more = ("list_contains_mask", "pad_ragged") if "sessions" in label else (
            "leaf_verdict", "expand_nullable")
        for k in filter_need + more:
            if counts[k] <= 0:
                raise AssertionError(f"{k} was not launched on the {label} path")
        log(f"[filter:{label}] step totals equal NumPy's under the filter: {got}")
    ops.reset_launch_counts()
    reset_filter_counts()
    kept, fare = filtered_read(taxi_path, f_taxi, dev)
    device_filtered = (kept, fare)
    counts = kernel_counts()
    fc = filter_counts()
    launches["taxi filtered read"] = counts
    want = (int(taxi_keep.sum()),
            int(next(sp for sp in taxi_specs if sp.name == "fare_cents").values[taxi_keep]
                .astype(np.int64).sum()))
    log(f"[filter:taxi filtered read] read_row_group_device(i, ['fare_cents'], filters=F_taxi) "
        f"+ mask_take on {ROW_GROUPS} groups: kept {kept}, fare sum {fare}; filter counts {fc}")
    if (kept, fare) != want:
        raise AssertionError(f"filtered read: (kept, fare sum) {(kept, fare)} != NumPy's {want}")
    if fc.get("device_filter_engaged") != ROW_GROUPS or fc.get("device_filter_declined"):
        raise AssertionError(f"filtered read: filter counts {fc}")
    for k in ("predicate_mask", "leaf_verdict", "mask_take"):
        if counts[k] <= 0:
            raise AssertionError(f"{k} was not launched on the filtered read")
    # the write path: the taxi generator's columns on the card, written back
    # through write_device_column; the file must equal the host write's
    with FileReader(taxi_path) as r:
        taxi_schema = r.schema
    host_groups = write_groups(taxi_specs)
    dev_groups = upload_groups(host_groups, dev)
    torch.cuda.synchronize()
    dev_file = build.BUILD_ROOT / "smoke" / "write-device.parquet"
    host_file = build.BUILD_ROOT / "smoke" / "write-host.parquet"
    ops.reset_launch_counts()
    reset_write_counts()
    t = time.perf_counter()
    write_taxi(dev_file, taxi_schema, dev_groups, device=True)
    secs = time.perf_counter() - t
    counts = kernel_counts()
    wc = write_counts()
    launches["taxi write"] = counts
    log(f"[write:taxi] write_device_column, {ROW_GROUPS} groups: {secs:.2f} s, "
        f"{dev_file.stat().st_size / 2**20:.1f} MiB, write counts {wc}, launches "
        + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
    want_wc = {"device_write_engaged": 6 * ROW_GROUPS, "device_write_declined": 0}
    if {k: wc[k] for k in want_wc} != want_wc:
        raise AssertionError(f"write counts {wc}, expected {want_wc}")
    for k in WRITE_KERNELS:
        if k != "bitpack_encode" and counts[k] <= 0:
            raise AssertionError(f"{k} was not launched on the write path")
    if counts["bitpack_encode"]:
        raise AssertionError("bitpack_encode was launched on the write path: rle_hybrid_encode "
                             "packs inside its own kernel")
    t = time.perf_counter()
    write_taxi(host_file, taxi_schema, host_groups, device=False)
    log(f"[write:taxi] write_column from NumPy: {time.perf_counter() - t:.2f} s")
    if dev_file.read_bytes() != host_file.read_bytes():
        raise AssertionError("the device write's file differs from the host write's")
    log("[write:taxi] the device write's file equals the host write's, byte for byte")
    reader = FileReader(dev_file)
    groups = reader.read_row_groups_device()
    torch.cuda.synchronize()
    check_main_path(groups, taxi_specs, reader.stats, no_host_fallback=False)
    del groups
    log(f"[write:taxi] read back with read_row_groups_device: columns equal the generator "
        f"({reader.stats})")
    write_options = check_write_options(taxi_specs, host_groups, dev_groups, dev, launches)
    # the query path: run_local_query over taxi, unfiltered and under F_taxi
    from parquet_tpu_torch.serve.aggregate import query_device_counts, reset_query_device_counts

    query_runs = {"taxi query": (None, np.ones(n_rows, dtype=bool), ROW_GROUPS),
                  "taxi query filtered": (f_taxi, taxi_keep, ROW_GROUPS - 2)}
    for label, (filters, keep, units) in query_runs.items():
        ops.reset_launch_counts()
        reset_query_device_counts()
        t = time.perf_counter()
        body = run_query(taxi_path, filters)
        secs = time.perf_counter() - t
        counts = kernel_counts()
        launches[label] = counts
        want = query_want(taxi_specs, keep, units)
        qc = query_device_counts()
        log(f"[query:{label}] run_local_query, {len(query_aggregates())} aggregates: {secs:.2f} s, "
            f"units {body['units']}, rows scanned {body['rows_scanned']}, matched "
            f"{body['rows_matched']}; query counts {qc}; launches "
            + ", ".join(f"{k}={v}" for k, v in counts.items() if v))
        if body != want:
            raise AssertionError(f"{label}: body {body} != NumPy's {want}")
        if qc != {"device": units}:
            raise AssertionError(f"{label}: query counts {qc}, expected {units} device units")
        need = ("masked_agg", "dict_gather") + (("mask_take",) if filters else ())
        for k in need:
            if counts[k] <= 0:
                raise AssertionError(f"{k} was not launched on the {label} path")
        log(f"[query:{label}] the body equals NumPy's: {body['result']}")
    # run_local_query(shard=): each of 4 shards answers over its stripe of
    # the plan's units (groups k and k + 4), equal to NumPy's over them
    ops.reset_launch_counts()
    reset_query_device_counts()
    group_of = np.repeat(np.arange(ROW_GROUPS), RG_ROWS)
    for k in range(4):
        body = run_query(taxi_path, None, shard=(k, 4))
        keep = (group_of % 4) == k
        want = query_want(taxi_specs, keep, 2)
        if body != want:
            raise AssertionError(f"query shard ({k}, 4): body {body} != NumPy's {want}")
    counts = kernel_counts()
    launches["taxi query shards"] = counts
    if query_device_counts() != {"device": ROW_GROUPS}:
        raise AssertionError(f"query shards: query counts {query_device_counts()}")
    for k in ("masked_agg", "dict_gather"):
        if counts[k] <= 0:
            raise AssertionError(f"{k} was not launched on the query shards path")
    log(f"[query:taxi shards] run_local_query(shard=(k, 4)), k = 0..3: each body equals NumPy's "
        f"over groups k and k + 4; launches "
        + ", ".join(f"{k}={v}" for k, v in counts.items() if v and not isinstance(v, dict)))
    check_query_declines(taxi_path)
    scan = check_scans(taxi_path, taxi_specs, dev, launches)
    dataset_rates = check_dataset(taxi_path, taxi_specs, dev, smi)
    rows_phase = check_rows(taxi_path, sessions_path, sessions_specs, taxi_specs, f_taxi,
                            taxi_keep, device_filtered, dev, launches, smi)
    io_phase = check_io(paths, dev, launches, smi)
    remote_phase = check_remote_lake(paths, taxi_schema, dev_groups, dev_file, dev, launches, smi)
    serve_phase = check_serve(taxi_path, taxi_specs, f_taxi, taxi_keep, dev, launches, smi)
    mesh_phase = check_mesh(taxi_path, taxi_specs, f_taxi, taxi_keep, dev, launches, smi)
    for k in rows:
        rows[k]["launches"] = sum(c[k] for c in launches.values())
        rows[k]["launches_by_path"] = {label: c[k] for label, c in launches.items()}
    rows["bitpack_encode"]["main_paths"] = (
        "none: the write path packs inside rle_hybrid_encode's kernel, on the same word "
        "assembly (kernels/csrc/bitpack.cuh)")
    hybrid_by_width = collections.Counter()
    for c in launches.values():
        hybrid_by_width.update(c["expand_hybrid_by_width"])
    if sum(hybrid_by_width.values()) != rows["expand_hybrid"]["launches"]:
        raise AssertionError(f"expand_hybrid launches by width {hybrid_by_width} do not add up "
                             f"to its {rows['expand_hybrid']['launches']} launches")
    log(f"[main] expand_hybrid launches by width: {dict(sorted(hybrid_by_width.items()))}")
    dict_by_width = collections.Counter()
    for c in launches.values():
        dict_by_width.update(c["dict_indices_by_width"])
    if sum(dict_by_width.values()) != rows["dict_indices"]["launches"]:
        raise AssertionError(f"dict_indices launches by key width {dict_by_width} do not add "
                             f"up to its {rows['dict_indices']['launches']} launches")
    rows["dict_indices"]["launches_by_width"] = dict(sorted(dict_by_width.items()))
    log(f"[main] dict_indices launches by key width: {dict(sorted(dict_by_width.items()))}")
    verdict_by_kind = collections.Counter()
    for c in launches.values():
        verdict_by_kind.update(c["leaf_verdict_by_kind"])
    if sum(verdict_by_kind.values()) != rows["leaf_verdict"]["launches"]:
        raise AssertionError(f"leaf_verdict launches by kind {verdict_by_kind} do not add up "
                             f"to its {rows['leaf_verdict']['launches']} launches")
    rows["leaf_verdict"]["launches_by_kind"] = dict(sorted(verdict_by_kind.items()))
    log(f"[main] leaf_verdict launches by kind: {dict(sorted(verdict_by_kind.items()))}")

    log(f"[times] {name} | {smi}")

    def device_read(path):
        out = FileReader(path).read_row_groups_device()
        torch.cuda.synchronize()
        return out

    def host_read_upload(path):
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
    def batch_stream(label):
        path, kwargs, step, _want, _need = batch_paths[label]
        return run_batches(path, kwargs, step)

    def filtered_stream(label):
        path, kwargs, step, _want = filtered_paths[label]
        return run_batches(path, kwargs, step)

    runs = [("taxi device", lambda: device_read(paths["taxi"][0])),
            ("taxi batches", lambda: batch_stream("taxi batches")),
            ("taxi filtered batches", lambda: filtered_stream("taxi filtered batches")),
            ("taxi filtered read", lambda: filtered_read(taxi_path, f_taxi, dev)),
            ("taxi host+upload", lambda: host_read_upload(paths["taxi"][0])),
            ("taxi_mixed device", lambda: device_read(mixed_path)),
            ("sessions device", lambda: device_read(sessions_path)),
            ("sessions batches", lambda: batch_stream("sessions batches")),
            ("sessions filtered batches", lambda: filtered_stream("sessions filtered batches"))]
    for label, fn in runs:
        fn()
        med, secs = median_s(fn)
        rates[label] = n_rows / med
        extra = ""
        if "filtered" in label:
            keep = taxi_keep if label.startswith("taxi") else _sessions_keep
            extra = f"; over input rows, {int(keep.sum())} kept, 2 groups pruned"
        log(f"  {label}: {rates[label]:,.0f} rows/s (median of {[round(x, 3) for x in secs]} s)"
            + extra)
    from parquet_tpu_torch.parallel.scan import column_stats

    def stats_scan():
        with FileReader(taxi_path) as r:
            return column_stats(r, [dev], columns=list(SCAN_COLUMNS))

    for label, fn in (("taxi query", lambda: run_query(taxi_path, None)),
                      ("taxi query filtered", lambda: run_query(taxi_path, f_taxi)),
                      ("taxi column_stats", stats_scan)):
        med, secs = median_s(fn)  # the phase's own run above was the warm-up
        rates[label] = n_rows / med
        log(f"  {label}: {rates[label]:,.0f} rows/s (median of {[round(x, 3) for x in secs]} s)"
            + ("; over input rows, 2 groups pruned" if "filtered" in label else ""))
    log("  profiler, taxi query filtered:")
    profile_device(lambda: run_query(taxi_path, f_taxi))
    for label, fn in (("taxi device write",
                       lambda: write_taxi(dev_file, taxi_schema, dev_groups, device=True)),
                      ("taxi host write",
                       lambda: write_taxi(host_file, taxi_schema, host_groups, device=False))):
        # the phase's own writes above were the warm-up
        med, secs = median_s(fn)
        rates[label] = n_rows / med
        log(f"  {label}: {rates[label]:,.0f} rows/s (median of {[round(x, 3) for x in secs]} s)")
    log(f"[write] rows/s: device write {rates['taxi device write']:,.0f}, host write "
        f"{rates['taxi host write']:,.0f}, ratio "
        f"{rates['taxi device write'] / rates['taxi host write']:.3f}")
    log("  profiler, taxi device write:")
    profile_device(lambda: write_taxi(dev_file, taxi_schema, dev_groups, device=True))
    prepare = {}
    for label in paths:
        # the staged walk is the fallback: timed on the two taxi files only
        walks = (("fused", True),) if label == "sessions" else (("fused", True), ("staged", False))
        for walk, fused in walks:
            prepare_alone(paths[label][0], fused)
            med, secs = median_s(lambda: prepare_alone(paths[label][0], fused))
            prepare[f"{label} {walk}"] = med
            log(f"  host prepare alone, {label}, {walk} walk: {n_rows / med:,.0f} rows/s "
                f"(median of {[round(x, 3) for x in secs]} s)")
            if not fused:
                continue  # the per-column split is taken on the fused walk only
            split: dict = {}
            prepare_alone(paths[label][0], fused, split)
            prepare[f"{label} {walk} by column"] = split
            log("    by column (one more pass): " + ", ".join(
                f"{c} {v:.3f} s" for c, v in sorted(split.items(), key=lambda kv: -kv[1])))
    log("[native] the host value functions against their Python oracles, row group 0:")
    native_ab = ab_native_values(paths, host_groups[0], taxi_specs)
    log(f"[overlap] {name} | {smi}")
    overlap = ab_overlap(paths, batch_paths["taxi batches"][:4], dev)
    overlap["profile"] = profile_overlap(paths["taxi"][0], dev)
    overlap["dataset_rows_per_s"] = dataset_rates
    for label in paths:
        log(f"  profiler, {label}:")
        profile_device_read(paths[label][0])
    time_kernels(paths["taxi"][0], dev, rows, bw)
    time_hybrid_shapes(paths["taxi"][0], sessions_path, dev, rows, bw, hybrid_by_width)
    time_new_kernels(mixed_path, dev, rows, bw)
    time_batch_kernels(sessions_path, paths["taxi"][0], dev, rows, bw)
    time_filter_kernels(taxi_path, sessions_path, f_taxi, f_sessions, dev, rows, bw)
    time_write_kernels(dev_groups, dev, rows, bw)
    time_query_kernels(taxi_path, f_taxi, scan, dev, rows, bw)
    del dev_groups
    dev_file.unlink()
    host_file.unlink()

    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"rows_per_s": rates, "prepare_s": prepare, "native_ab_s": native_ab,
                      "collectives": scan["collectives"], "overlap": overlap,
                      "write_options": write_options, "rows": rows_phase, "io": io_phase,
                      "remote": remote_phase, "serve": serve_phase, "mesh": mesh_phase,
                      "card": smi}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
