"""parquet-tool: cat / head / meta / schema / rowcount / split / verify / salvage / profile / scan / serve / debug.

The port of parquet_tpu/tools/parquet_tool.py. Equivalent of the
reference's cobra CLI (reference: cmd/parquet-tool/cmds — cat.go:14,
head.go:17, meta.go:14, schema.go:16, rowcount.go:16, split.go:31), plus
corruption triage beyond the reference: `verify` walks every page of every
chunk and reports each corrupt one with its byte offset, failing stage and
error type; `salvage` copies the readable row groups of a damaged file into
a fresh one (verbatim chunk bytes, rewritten footer); `profile` decodes the
whole file under torch.profiler and writes Chrome trace-event JSON (load it
in ui.perfetto.dev or chrome://tracing) plus the per-operator report.

    python -m parquet_tpu_torch.tools.parquet_tool cat file.parquet
    python -m parquet_tpu_torch.tools.parquet_tool head -n 5 file.parquet
    python -m parquet_tpu_torch.tools.parquet_tool meta file.parquet
    python -m parquet_tpu_torch.tools.parquet_tool schema file.parquet
    python -m parquet_tpu_torch.tools.parquet_tool rowcount file.parquet
    python -m parquet_tpu_torch.tools.parquet_tool split -n 100000 src.parquet out_%d.parquet
    python -m parquet_tpu_torch.tools.parquet_tool verify damaged.parquet
    python -m parquet_tpu_torch.tools.parquet_tool salvage damaged.parquet -o saved.parquet
    python -m parquet_tpu_torch.tools.parquet_tool profile file.parquet -o trace.json --metrics
    python -m parquet_tpu_torch.tools.parquet_tool scan 'shard-*.parquet' --batch-size 8192

The device rule. The subcommands that reach a device run on CUDA, or on
the CPU (the kernels' plain versions) with `--cpu`: `profile` in its device
modes (the default device decode and `--device`), `scan` (CUDA
delivery of every batch; `--aggregate` runs each unit on the device) and
`serve`. Without `--cpu` on a host without CUDA each exits 1 with
`parquet-tool: CUDA is not available; pass --cpu`; none carries on on the
CPU. `route` (the mesh router) holds no device and refuses `--cpu`: its
replicas take it. The host subcommands launch nothing and take no `--cpu`:
`cat`, `head`, `meta`, `pages`, `schema`, `rowcount`, `verify`,
`salvage`, `split`, `merge`, `lake`, and `profile --host/--rows/--write`
open their readers with device="cpu" (footers, page walks, iter_rows and
write_rows on the host).

`scan` drives the streaming dataset layer (parquet_tpu_torch.data) over a
glob and reports end-to-end loader throughput: rows/s, batches, and the
wait-time share (how much of the wall the consumer spent starved for the
next unit — the number prefetch depth tuning moves).

`serve` runs the long-running scan/query daemon (parquet_tpu_torch.serve):
POST /v1/scan streams filtered, projected rows as jsonl with warm-cache
planning and admission control; POST /v1/query aggregates on the device;
GET /v1/plan dry-runs the same request; /metrics and /healthz feed
scrapers and load balancers.

    python -m parquet_tpu_torch.tools.parquet_tool serve --root /data --port 8080

`debug` reads a running daemon's flight recorder (its newest requests;
`--id` one record, `--trace -o` its span tree as a Perfetto document,
`--tenants` the per-tenant cost table, `--vars` its configuration) and
`debug --fleet URL...` merges several replicas' /metrics into one
exposition. `trace-merge` stitches the span trees of one request's
processes (a router's and its replicas') into one timeline on their shared
trace id. `profile --live URL` takes a sampling-profiler window of a
running daemon; `profile FILE` decodes under a span trace and prints its
per-stage report beside the metrics report. The daemon logs structured
JSON lines on stderr (obs.log), with request ids and trace ids.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..core.reader import FileReader, MaskedColumn
from ..core.writer import FileWriter
from ..meta.parquet_types import CompressionCodec, Encoding, Type
from ..schema.dsl import schema_to_string
from ..utils import metrics as _metrics
from ..utils.trace import decode_trace, span

__all__ = ["main"]

# the host subcommands' readers: footers, page walks and rows never touch
# a device
HOST = "cpu"


class NoCudaError(ValueError):
    """A device subcommand without --cpu on a host without CUDA: main()
    prints `parquet-tool: <message>` and exits 1."""


def _device(args) -> str:
    """The device a device subcommand runs on: "cpu" with --cpu, else
    CUDA, which must be there (the port never falls back to the CPU)."""
    if args.cpu:
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise NoCudaError("CUDA is not available; pass --cpu")
    return "cuda"


def _json_default(v):
    # THE definition lives in serve/protocol.py (shared so daemon bytes
    # match cat/head bytes); imported lazily per call — only reached for
    # non-JSON-native values — so `parquet-tool cat` never pays the serve
    # package import
    from ..serve.protocol import json_default

    return json_default(v)


def _coerce(raw: str):
    raw = raw.strip()
    if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in "'\"":
        return raw[1:-1]  # quoted: force string ('7' stays "7")
    try:
        return int(raw)
    except ValueError:
        try:
            return float(raw)
        except ValueError:
            return raw


def _split_members(inner: str):
    """Split a set-literal body on commas OUTSIDE quotes, so quoted members
    may themselves contain commas ('a,b' stays one member)."""
    parts = []
    cur = []
    quote = None
    for ch in inner:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur.append(ch)
        elif ch == ",":
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if quote:
        raise ValueError(f"unterminated quote in set literal {inner!r}")
    if cur or parts:
        parts.append("".join(cur))
    return parts


def _parse_filters(specs):
    """['col >= 10', 'name == x', 'id in (1,2,3)'] -> [(col, op, value)]
    triples; values try int, then float, then stay strings. Set membership
    ('in'/'not_in' with a parenthesized list) rides the full pruning stack,
    including bloom-filter consultation for 'in'. Comparison ops parse
    FIRST so a quoted value containing the word 'in' stays a value."""
    if not specs:
        return None

    def find_outside_quotes(spec: str, token: str) -> int:
        quote = None
        i = 0
        while i < len(spec):
            ch = spec[i]
            if quote:
                if ch == quote:
                    quote = None
            elif ch in "'\"":
                quote = ch
            elif spec.startswith(token, i):
                return i
            i += 1
        return -1

    out = []
    for spec in specs:
        for op in ("==", "!=", "<=", ">=", "<", ">"):
            k = find_outside_quotes(spec, f" {op} ")
            if k >= 0:
                col = spec[:k]
                raw = spec[k + len(op) + 2 :]
                out.append((col.strip(), op, _coerce(raw)))
                break
        else:
            for op in ("not_in", "in"):
                head, sep, tail = spec.partition(f" {op} ")
                if sep and head.strip() and "(" not in head:
                    raw = tail.strip()
                    if not (raw.startswith("(") and raw.endswith(")")):
                        raise ValueError(
                            f"bad --filter {spec!r} ({op} needs a "
                            "parenthesized list: 'col in (1,2,3)')"
                        )
                    inner = raw[1:-1].strip()
                    values = [_coerce(x) for x in _split_members(inner)]
                    out.append((head.strip(), op, values))
                    break
            else:
                raise ValueError(
                    f"bad --filter {spec!r} (expected 'column OP value', "
                    "OP one of == != < <= > >= in not_in)"
                )
    return out


def cmd_cat(args) -> int:
    cols = args.columns.split(",") if args.columns else None
    filters = _parse_filters(args.filter)
    with FileReader(args.file, columns=cols, device=HOST) as r:
        for row in r.iter_rows(raw=args.raw, filters=filters):
            print(json.dumps(row, default=_json_default))
    return 0


def cmd_head(args) -> int:
    n = args.n
    cols = args.columns.split(",") if args.columns else None
    filters = _parse_filters(args.filter)
    with FileReader(args.file, columns=cols, device=HOST) as r:
        for i, row in enumerate(r.iter_rows(raw=args.raw, filters=filters)):
            if i >= n:
                break
            print(json.dumps(row, default=_json_default))
    return 0


def cmd_rowcount(args) -> int:
    with FileReader(args.file, device=HOST) as r:
        print(r.num_rows)
    return 0


def cmd_schema(args) -> int:
    with FileReader(args.file, device=HOST) as r:
        print(schema_to_string(r.schema))
    return 0


def cmd_meta(args) -> int:
    """Flat per-column metadata incl. max R/D levels
    (reference: cmds/readfile.go:110-142 printFlatSchema)."""
    with FileReader(args.file, device=HOST) as r:
        m = r.metadata
        print(f"version: {m.version}")
        print(f"created by: {m.created_by}")
        print(f"rows: {m.num_rows}")
        print(f"row groups: {len(m.row_groups or [])}")
        for kv in m.key_value_metadata or []:
            print(f"kv: {kv.key} = {kv.value}")
        for gi, rg in enumerate(m.row_groups or []):
            print(f"row group {gi}: rows={rg.num_rows} bytes={rg.total_byte_size}")
            for cc in rg.columns or []:
                md = cc.meta_data
                leaf = r.schema.column(tuple(md.path_in_schema))
                try:
                    codec = CompressionCodec(md.codec).name
                except ValueError:
                    codec = str(md.codec)
                encs = ",".join(
                    Encoding(e).name if e in set(Encoding) else str(e)
                    for e in (md.encodings or [])
                )
                stats = ""
                if md.statistics is not None and md.statistics.null_count is not None:
                    stats = f" nulls={md.statistics.null_count}"
                extras = []
                if cc.column_index_offset:
                    extras.append("page-index")
                if md.bloom_filter_offset:
                    extras.append("bloom")
                extra = f" [{','.join(extras)}]" if extras else ""
                print(
                    f"  {'.'.join(md.path_in_schema)}: {Type(md.type).name} "
                    f"maxR={leaf.max_rep} maxD={leaf.max_def} values={md.num_values} "
                    f"codec={codec} encodings=[{encs}]{stats}{extra}"
                )
        # per-column totals across every row group, from the footer
        from ..utils.metrics import summarize_columns

        for name, s in summarize_columns(m).items():
            ratio = f"{s['ratio']:.2f}x" if s["ratio"] else "n/a"
            print(
                f"column {name}: encodings=[{','.join(s['encodings'])}] "
                f"compressed={s['compressed']:,} B "
                f"uncompressed={s['uncompressed']:,} B ratio={ratio}"
            )
    return 0


def cmd_pages(args) -> int:
    """Per-page layout + statistics from the page index (beyond the
    reference: it has no page-index support)."""
    from ..core.filter import _decode_stat

    with FileReader(args.file, device=HOST) as r:
        any_index = False
        for gi in range(r.num_row_groups):
            num_rows = r.row_group(gi).num_rows or 0
            for path, (ci, oi) in r.read_page_index(gi).items():
                if oi is None or not oi.page_locations:
                    continue
                any_index = True
                name = ".".join(path)
                leaf = r.schema.column(path)
                locs = oi.page_locations
                for k, loc in enumerate(locs):
                    stop = (
                        locs[k + 1].first_row_index if k + 1 < len(locs) else num_rows
                    )
                    line = (
                        f"rg{gi} {name} page {k}: rows [{loc.first_row_index}, "
                        f"{stop}) offset={loc.offset} "
                        f"bytes={loc.compressed_page_size}"
                    )
                    if (
                        ci is not None
                        and ci.min_values is not None
                        and k < len(ci.min_values)
                    ):
                        if ci.null_pages and k < len(ci.null_pages) and ci.null_pages[k]:
                            line += " ALL-NULL"
                        else:
                            # decode PLAIN-packed bounds to typed values
                            # (raw bytes for ints/floats are unreadable)
                            mn = _decode_stat(leaf, ci.min_values[k], legacy=False)
                            mx = _decode_stat(leaf, ci.max_values[k], legacy=False)
                            if isinstance(mn, bytes):
                                mn = _json_default(mn)
                            if isinstance(mx, bytes):
                                mx = _json_default(mx)
                            line += f" min={mn!r} max={mx!r}"
                        if ci.null_counts and k < len(ci.null_counts):
                            line += f" nulls={ci.null_counts[k]}"
                    print(line)
        if not any_index:
            print("(file carries no page index)")
    return 0


def _parse_size(s: str) -> int:
    """'10M', '512K', '1G', or plain bytes; rejects malformed/non-positive."""
    raw = s.strip().upper()
    mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}.get(raw[-1:], 1)
    try:
        n = int(raw[:-1] if mult != 1 else raw) * mult
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid size {s!r} (use bytes or K/M/G)")
    if n <= 0:
        raise argparse.ArgumentTypeError(f"size must be positive, got {s!r}")
    return n


def cmd_split(args) -> int:
    """Re-shard into parts bounded by rows (-n) or by target file size
    (--size, the reference's unit: cmds/split.go:31-117 rolls to the next
    part once the current file reaches the target)."""
    pattern = args.out
    if "%d" not in pattern:
        print("split: output pattern must contain %d", file=sys.stderr)
        return 2
    if getattr(args, "groups", None) is not None:
        if args.n is not None or args.size is not None:
            print("split: --groups excludes -n/--size", file=sys.stderr)
            return 2
        if args.codec is not None:
            print(
                "split: --groups copies chunk bytes verbatim; --codec has "
                "no effect there (use -n/--size to re-encode)",
                file=sys.stderr,
            )
            return 2
        from ..core.merge import split_row_groups

        parts = split_row_groups(args.file, pattern, args.groups)
        print(f"wrote {len(parts)} parts (row-group copy, no re-encoding)")
        return 0
    if (args.n is None) == (args.size is None):
        print("split: pass exactly one of -n or --size", file=sys.stderr)
        return 2
    target_size = args.size
    with FileReader(args.file, device=HOST) as r:
        schema = r.schema
        codec = args.codec or "snappy"
        part = 0
        rows_in_part = 0
        writer = None
        for row in r.iter_rows(raw=True):
            if writer is None:
                writer = FileWriter(pattern % part, schema, codec=codec)
            writer.write_row(row)
            rows_in_part += 1
            if target_size is None:
                full = rows_in_part >= args.n
            else:
                # flushed bytes + the buffered row group's estimate, so a
                # part rolls over without waiting for an auto-flush; sampled
                # every 64 rows like the writer's own auto-flush throttle
                full = rows_in_part % 64 == 0 and (
                    writer.current_file_size + writer.estimated_buffered_size()
                    >= target_size
                )
            if full:
                writer.close()
                writer = None
                part += 1
                rows_in_part = 0
        if writer is not None:
            writer.close()
    print(f"wrote {part + (1 if rows_in_part else 0)} parts")
    return 0


def cmd_merge(args) -> int:
    """Concatenate files at row-group granularity WITHOUT re-encoding:
    chunk bytes copy verbatim, only footer offsets rewrite (compaction —
    the parquet-mr `parquet-tools merge` primitive; beyond the reference).
    Schemas must match exactly; page indexes/blooms are not carried.
    The output goes through the atomic ByteSink (tmp+rename): an
    interrupted merge never leaves a torn output file.

    Canonical form matches parquet-mr's argument order (inputs first):
        merge <inputs...> -o <output>
    The legacy output-first positional form (`merge <output> <inputs...>`)
    still parses, with a deprecation note on stderr. BOTH forms now refuse
    to overwrite an existing output unless --force is given — legacy
    invocations that relied on silent overwrite must add --force."""
    import os

    from ..core.merge import merge_files

    inputs = list(args.files)
    out = args.out
    if out is None:
        if len(inputs) < 2:
            raise ValueError("merge: need -o/--out OUTPUT and at least one input")
        out, inputs = inputs[0], inputs[1:]
        print(
            "parquet-tool: merge with a positional output is deprecated; "
            "use 'merge <inputs...> -o <output>' (note: overwriting an "
            "existing output now requires --force in both forms)",
            file=sys.stderr,
        )
    is_url = out.startswith(("http://", "https://"))
    if not is_url and os.path.exists(out) and not args.force:
        # URL outputs skip the existence probe: multipart commit replaces
        # the object atomically (last-commit-wins, like --force locally),
        # and a HEAD here would need credentials the sink already owns
        raise ValueError(
            f"merge: output {out!r} already exists (pass --force to overwrite)"
        )
    meta = merge_files(out, inputs)
    print(
        f"merged {len(inputs)} files -> {out}: "
        f"{meta.num_rows} rows, {len(meta.row_groups or [])} row groups"
    )
    return 0


def cmd_lake(args) -> int:
    """Operate on a lake table from the shell — the offline twins of the
    daemon's ingest/compaction loop, all through the same manifest commit
    protocol (a shell append and a daemon append are indistinguishable in
    the generation log):

        lake init     create the table (schema DSL + optional sort key)
        lake append   buffer rows from a jsonl file (or stdin) and commit
                      them as ONE generation
        lake compact  run one compaction pass (and optionally reap
                      crash-orphaned files)
        lake manifest print the snapshot a scan of this table would pin
                      (--gen N time-travels; --json for machines)
    """
    from ..lake import Compactor, IngestWriter, LakeError, LakeTable
    from ..lake.ingest import rows_from_payload

    try:
        if args.lake_cmd == "init":
            table = LakeTable.create(
                args.table,
                args.schema,
                sort_key=args.sort_key,
                retain=args.retain,
            )
            print(
                f"lake: created {table.root} "
                f"(sort_key={table.sort_key or '-'}, retain={args.retain})"
            )
            return 0
        table = LakeTable.open(args.table)
        if args.lake_cmd == "append":
            if args.file == "-":
                body = sys.stdin.buffer.read()
            else:
                with open(args.file, "rb") as f:
                    body = f.read()
            rows = rows_from_payload(body, "application/x-ndjson")
            if not rows:
                raise LakeError("lake: no rows in input", code="bad_payload")
            writer = IngestWriter(table)
            try:
                ack = writer.append(rows, flush=True)
            finally:
                writer.close()
            print(json.dumps(ack, sort_keys=True))
            return 0
        if args.lake_cmd == "compact":
            compactor = Compactor(
                table,
                min_files=args.min_files,
                max_files=args.max_files,
                small_file_bytes=args.small_file_mb << 20,
            )
            result = compactor.compact_once()
            if args.reap:
                reaped = table.manifest.reap_orphans(
                    grace_s=args.reap_grace_s
                )
                if reaped:
                    print(f"lake: reaped {reaped} orphan file(s)")
            if result is None:
                print("lake: nothing to compact")
                return 0
            print(json.dumps(result.to_dict(), sort_keys=True))
            return 0
        # manifest: the snapshot view (current or pinned)
        snap = table.manifest.open_snapshot(args.gen)
        if args.json:
            doc = snap.to_dict()
            doc["retained"] = table.manifest.generations()
            print(json.dumps(doc, sort_keys=True))
            return 0
        gens = table.manifest.generations()
        span = f"[{gens[0]}..{gens[-1]}]" if gens else "[]"
        print(f"table: {table.root} (sort_key={table.sort_key or '-'})")
        print(f"generation: {snap.generation} (retained {span})")
        print(
            f"files: {len(snap.files)}  rows: {snap.total_rows}  "
            f"bytes: {snap.total_bytes}"
        )
        for entry in snap.files:
            key = (
                f"  key=[{entry.min_key!r}..{entry.max_key!r}]"
                if entry.min_key is not None
                else ""
            )
            print(
                f"  {entry.path}  rows={entry.rows} bytes={entry.bytes}{key}"
            )
        return 0
    except LakeError as e:
        print(f"parquet-tool: lake: {e}", file=sys.stderr)
        return 1


def verify_file(path, validate_crc: bool = True) -> list[dict]:
    """Scan every page of every column chunk; return one report dict per
    problem found: {group, column, page, offset, stage, error, message}.

    Stages mirror the decode ladder (PTQ_STAGE_* taxonomy of the native
    walk): "footer" (metadata unreadable), "header" (Thrift page header),
    "crc" (stored checksum mismatch), "decompress" (codec-level), "decode"
    (levels/values), "layout" (page sizes exceed the chunk), "chunk"
    (cross-page invariants: value counts vs metadata). A header/layout
    failure ends that chunk's walk — subsequent page boundaries are
    unknowable — but every other stage continues to the next page, so one
    rotten page does not hide its neighbors; data pages that fail ONLY
    because an earlier dictionary page failed are not re-reported (one
    rotten dict page is one problem, not hundreds of phantom ones)."""
    from ..core.chunk import _check_crc, chunk_byte_range, iter_page_sites
    from ..core.compress import decompress_block
    from ..core.page import (
        decode_data_page_v1,
        decode_data_page_v2,
        decode_dict_page,
    )
    from ..core.reader import PARQUET_ERRORS, FileReader
    from ..meta.parquet_types import PageType

    problems: list[dict] = []

    def report(gi, col, page, offset, stage, err, note=None):
        problems.append(
            {
                "group": gi,
                "column": col,
                "page": page,
                "offset": offset,
                "stage": stage,
                "error": type(err).__name__ if err is not None else "ChunkError",
                "message": note if note is not None else str(err),
            }
        )

    try:
        reader = FileReader(path, device=HOST)
    except PARQUET_ERRORS as e:
        return [
            {
                "group": -1,
                "column": "",
                "page": -1,
                "offset": -1,
                "stage": "footer",
                "error": type(e).__name__,
                "message": str(e),
            }
        ]
    with reader as r:
        f = r._f
        for gi in range(r.num_row_groups):
            for tpath, cc, col in r._selected_chunks(gi):
                name = ".".join(tpath)
                md = cc.meta_data
                codec = md.codec or 0
                try:
                    offset, total = chunk_byte_range(cc)
                except PARQUET_ERRORS as e:
                    report(gi, name, -1, -1, "layout", e)
                    continue
                sites = iter_page_sites(f, cc)
                next_pos = offset
                page_idx = 0
                dictionary = None
                dict_failed = False
                seen_values = 0
                walk_complete = False
                while True:
                    try:
                        pos, header, hlen, plen = next(sites)
                    except StopIteration:
                        walk_complete = True
                        break
                    except PARQUET_ERRORS as e:
                        report(
                            gi, name, page_idx, next_pos,
                            getattr(e, "stage", "header"), e,
                        )
                        break  # page boundaries unknowable past this point
                    next_pos = pos + hlen + plen
                    f.seek(pos + hlen)
                    payload = bytes(f.read(plen))
                    if len(payload) != plen:
                        report(
                            gi, name, page_idx, pos, "layout", None,
                            "truncated page payload",
                        )
                        break
                    pt = header.type
                    failed = False
                    if validate_crc and header.crc is not None:
                        try:
                            _check_crc(header, payload)
                        except PARQUET_ERRORS as e:
                            report(gi, name, page_idx, pos, "crc", e)
                            failed = True
                    if not failed:
                        dict_size = (
                            len(dictionary) if dictionary is not None else None
                        )
                        try:
                            if pt == int(PageType.DICTIONARY_PAGE):
                                block = decompress_block(
                                    payload, codec,
                                    header.uncompressed_page_size or 0,
                                )
                                dictionary = decode_dict_page(header, block, col)
                            elif pt == int(PageType.DATA_PAGE):
                                block = decompress_block(
                                    payload, codec,
                                    header.uncompressed_page_size or 0,
                                )
                                page = decode_data_page_v1(
                                    header, block, col, dict_size
                                )
                                page.materialize(dictionary)
                                seen_values += page.num_values
                            elif pt == int(PageType.DATA_PAGE_V2):
                                page = decode_data_page_v2(
                                    header, payload, col, dict_size, codec
                                )
                                page.materialize(dictionary)
                                seen_values += page.num_values
                            # INDEX_PAGE and unknown types: skipped, like read
                        except PARQUET_ERRORS as e:
                            # a data page failing ONLY for want of the (already
                            # reported) broken dictionary is a dependent
                            # failure, not independent corruption
                            from ..core.page import MissingDictionaryError

                            dependent = dict_failed and isinstance(
                                e, MissingDictionaryError
                            )
                            if not dependent:
                                from ..core.compress import CompressionError

                                stage = (
                                    "decompress"
                                    if isinstance(e, CompressionError)
                                    else "decode"
                                )
                                report(gi, name, page_idx, pos, stage, e)
                            failed = True
                    if failed and pt == int(PageType.DICTIONARY_PAGE):
                        dict_failed = True
                    page_idx += 1
                if walk_complete:
                    expected = md.num_values or 0
                    if seen_values != expected and not any(
                        p["group"] == gi and p["column"] == name
                        for p in problems
                    ):
                        report(
                            gi, name, -1, offset, "chunk", None,
                            f"pages hold {seen_values} values, "
                            f"metadata says {expected}",
                        )
    return problems


def cmd_verify(args) -> int:
    problems = verify_file(args.file, validate_crc=not args.no_crc)
    for p in problems:
        where = (
            "footer"
            if p["stage"] == "footer"
            else f"rg{p['group']} {p['column']} page {p['page']} @byte {p['offset']}"
        )
        print(f"{where}: stage={p['stage']} {p['error']}: {p['message']}")
    if problems:
        groups = {p["group"] for p in problems}
        print(
            f"CORRUPT: {len(problems)} problem(s) in "
            f"{len(groups)} row group(s)"
        )
        return 1
    print("OK: every page decodes cleanly")
    return 0


def cmd_salvage(args) -> int:
    """Copy the readable row groups of a damaged file into a fresh one.

    A group is readable when EVERY selected column chunk decodes end to end
    (CRCs verified when present). Readable groups copy verbatim — chunk
    bytes untouched, footer offsets rewritten — via the merge/split
    machinery, so salvage never re-encodes surviving data."""
    import os

    from ..core.merge import _copy_groups
    from ..core.reader import PARQUET_ERRORS, FileReader

    out = args.out
    if os.path.exists(out) and not args.force:
        raise ValueError(
            f"salvage: output {out!r} already exists (pass --force to overwrite)"
        )
    good: list[int] = []
    bad: list[tuple[int, str]] = []
    rows_good = rows_total = 0
    with FileReader(args.file, validate_crc=not args.no_crc, device=HOST) as r:
        meta = r.metadata
        for gi in range(r.num_row_groups):
            rows = r.row_group(gi).num_rows or 0
            rows_total += rows
            try:
                r._read_row_group(gi, None, pack=False)
            except PARQUET_ERRORS as e:
                bad.append((gi, f"{type(e).__name__}: {e}"))
                continue
            good.append(gi)
            rows_good += rows
    _copy_groups(out, args.file, meta, good, "parquet_tpu salvage")
    for gi, why in bad:
        print(f"dropped rg{gi}: {why}", file=sys.stderr)
    print(
        f"salvaged {len(good)}/{len(good) + len(bad)} row groups "
        f"({rows_good}/{rows_total} rows) -> {out}"
    )
    return 0


def _counts_snapshot() -> dict:
    """The port's count registries and every kernel wrapper's launches as
    one flat {"<registry>.<key>": number} dict: what `profile --metrics`
    takes the delta of (the reference's process metrics registry is cut)."""
    from ..core.reader import filter_counts, row_counts
    from ..io import io_counts
    from ..kernels.device_ops import launch_counts
    from ..kernels.pipeline import prepare_counts
    from ..serve.aggregate import query_device_counts
    from ..sink.counts import sink_counts, write_counts

    snap = {}
    for name, counts in (
        ("io", io_counts()),
        ("filter", filter_counts()),
        ("row", row_counts()),
        ("write", write_counts()),
        ("sink", sink_counts()),
        ("prepare", prepare_counts()),
        ("query_device", query_device_counts()),
        ("launches", launch_counts()),
    ):
        for k, v in counts.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                snap[f"{name}.{k}"] = v
    return snap


def _counts_delta(before: dict) -> dict:
    """The nonzero changes since `before` (a _counts_snapshot())."""
    out = {}
    for k, v in _counts_snapshot().items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


def _profiler(dev: str):
    """torch.profiler over the CPU, and over CUDA when the run is on the
    card; with the sort key of its report (device time on the card, CPU
    time with --cpu)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts), (
        "self_device_time_total" if dev == "cuda" else "cpu_time_total"
    )


# the pid of the span trace's events in a profile document: apart from the
# profiler's process and device lanes
SPAN_PID = 1 << 30


def _trace_out(prof, sort_by: str, out: str, mdelta: dict, trace=None,
               registry_delta=None) -> dict:
    """Write the profile's Chrome trace to `out` (the counts delta under
    otherData, and the registry's delta as the reference writes its
    metrics delta there), with `trace`'s span events beside the
    profiler's under pid SPAN_PID; print the key_averages report, and
    return the trace document."""
    prof.export_chrome_trace(out)
    with open(out) as f:
        doc = json.load(f)
    other = doc.setdefault("otherData", {})
    other["counts_delta"] = mdelta
    if registry_delta is not None:
        other["metrics_delta"] = registry_delta
    if trace is not None:
        spans = trace.to_chrome_trace()
        events = doc.setdefault("traceEvents", [])
        events.append({"ph": "M", "name": "process_name", "pid": SPAN_PID, "tid": 0,
                       "args": {"name": "parquet_tpu_torch spans"}})
        events.extend({**ev, "pid": SPAN_PID} for ev in spans["traceEvents"])
        other["stages"] = spans["otherData"]["stages"]
        other["counters"] = spans["otherData"]["counters"]
    with open(out, "w") as f:
        json.dump(doc, f)
    try:
        table = prof.key_averages().table(sort_by=sort_by, row_limit=25)
    except (AttributeError, KeyError):  # a profiler without device time keys
        table = prof.key_averages().table(sort_by="cpu_time_total", row_limit=25)
    print(table)
    return doc


def _print_counts(mdelta: dict) -> None:
    print()
    print("metrics delta (this profile run):")
    for k, v in sorted(mdelta.items()):
        print(f"  {k} = {v}")
    launched = {
        k.split(".", 1)[1]: v for k, v in mdelta.items() if k.startswith("launches.")
    }
    print()
    print(
        "kernel launches: "
        + (", ".join(f"{k}={v}" for k, v in sorted(launched.items())) or "none")
    )


def _synchronize(dev: str) -> None:
    """Wait for the card's work (a no-op on the CPU), so a range's wall
    holds its kernels."""
    if dev == "cuda":
        import torch

        torch.cuda.synchronize()


def _rows_decoded(r, group: dict, i: int) -> int:
    """Rows in one decoded group: the level entries of its first flat leaf
    (the footer's count when every selected leaf is repeated)."""
    for path, cd in group.items():
        if r.schema.column(path).max_rep == 0:
            return int(cd.num_values)
    return int(r.row_group(i).num_rows or 0)


def cmd_profile(args) -> int:
    """Decode the whole file under torch.profiler; write its Chrome
    trace-event JSON (the tool's own ranges `file` and `row_group <i>`, the
    host operators, and on the card every kernel and copy) and print the
    key_averages report, by device time on the card and by CPU time with
    --cpu, then the summary lines.

    The default path is the device-decode pipeline (backend="device":
    read_row_group_device of every group, synchronized at the end of its
    range), which exercises the pqt-host prepare pool, the fused native
    walk, the dispatch thread and every decode kernel: the hybrid
    expansion, the DELTA decode, the dictionary gather, BYTE_STREAM_SPLIT
    and the mixed merges. (The reference profiles its round trip, whose
    port, backend="device_roundtrip", materializes dictionaries and merges
    mixed chunks on the host after the copy back: it launches neither
    the gather nor the merges.)
    --host profiles the pure host decode instead (no device touched);
    --cpu runs the device modes on the CPU (the kernels' plain versions);
    --rows profiles an ASSEMBLED read (iter_rows) instead of the column
    decode, on the host; --write re-encodes the file's rows to a memory
    sink, on the host. --metrics prints the delta of the port's count
    registries and of every kernel's launches.

    The decode also runs under a span trace (utils.trace.decode_trace):
    its per-stage report prints after the profiler's table, then the
    metrics registry's report of the run, and the -o document holds the
    trace's span events beside the profiler's, in the same traceEvents
    list under a pid of their own (named by a process_name event).

    --live <url> asks a RUNNING daemon for GET /v1/debug/profile (the
    sampling profiler)."""
    import os

    if args.live:
        # flags that shape the FILE decode have no meaning against a
        # remote daemon — refuse rather than silently drop them
        ignored = [
            name
            for name, v in (
                ("--columns", args.columns),
                ("--rows", args.rows),
                ("--write", args.write),
                ("--host", args.host),
                ("--cpu", args.cpu),
                ("--metrics", args.metrics),
                ("--device", args.device),
                ("--filter", args.filter),
            )
            if v
        ]
        if ignored or args.file:
            what = ", ".join(ignored + (["FILE"] if args.file else []))
            print(
                f"profile: {what} applies to file mode, not --live",
                file=sys.stderr,
            )
            return 2
        return _profile_live(args)
    if args.top or args.seconds != 2.0 or args.interval_ms != 10.0:
        print(
            "profile: --top/--seconds/--interval-ms apply to --live mode "
            "only",
            file=sys.stderr,
        )
        return 2
    if not args.file or not args.out:
        print(
            "profile: FILE and -o are required (or use --live URL)",
            file=sys.stderr,
        )
        return 2
    if args.write and args.rows:
        print("profile: --write and --rows are mutually exclusive", file=sys.stderr)
        return 2
    if args.filter and not args.device:
        print("profile: --filter applies to --device mode", file=sys.stderr)
        return 2
    if args.device:
        if args.host or args.rows or args.write:
            print(
                "profile: --device is exclusive with --host/--rows/--write",
                file=sys.stderr,
            )
            return 2
        return _profile_device_query(args, _device(args))
    from torch.profiler import record_function

    host = args.host or args.rows or args.write
    backend = "host" if host else "device"
    dev = HOST if host else _device(args)
    cols = args.columns.split(",") if args.columns else None
    prof, sort_by = _profiler(dev)
    snap0 = _counts_snapshot()
    msnap0 = _metrics.snapshot()
    with FileReader(args.file, columns=cols, backend=backend, device=dev) as r:
        rows = r.num_rows
        if args.write:
            # profile the ENCODE: decode rows OUTSIDE the trace window, then
            # re-encode them (same schema, same codec) to a memory sink —
            # the trace carries only the write and the encode_fused_*
            # ladder counts
            from ..sink.sink import MemorySink

            all_rows = list(r.iter_rows())
            md0 = r.metadata.row_groups[0].columns[0].meta_data if (
                r.metadata.row_groups
            ) else None
            codec = CompressionCodec(md0.codec) if md0 is not None else (
                CompressionCodec.UNCOMPRESSED
            )
            snap0 = _counts_snapshot()  # exclude the decode from the delta
            msnap0 = _metrics.snapshot()
            with prof, record_function("file"), decode_trace() as t, span(
                "file", {"path": str(args.file), "mode": "write-encode"}
            ):
                w = FileWriter(MemorySink(), r.schema, codec=codec)
                for row in all_rows:
                    w.write_row(row)
                w.close()
        else:
            with prof, record_function("file"), decode_trace() as t, span(
                "file", {"path": str(args.file), "backend": backend}
            ):
                if args.rows:
                    rows = 0
                    for _row in r.iter_rows():
                        rows += 1
                else:
                    rows = 0
                    for i in range(r.num_row_groups):
                        with record_function(f"row_group {i}"):
                            if host:
                                group = r.read_row_group(i)
                            else:
                                group = r.read_row_group_device(i)
                                _synchronize(dev)
                            rows += _rows_decoded(r, group, i)
    # computed once: the registries are live process state, so a re-read
    # could disagree with what the file artifact recorded
    mdelta = _counts_delta(snap0)
    registry_delta = _metrics.delta(msnap0)
    doc = _trace_out(prof, sort_by, args.out, mdelta, trace=t, registry_delta=registry_delta)
    print(t.report())
    print()
    print(_metrics.report(registry_delta))
    print()
    mode = "write-encode" if args.write else f"backend={backend}"
    print(
        f"profile: {rows:,} rows via {mode}, "
        f"{len(doc['traceEvents'])} trace events -> {args.out} "
        "(load in ui.perfetto.dev or chrome://tracing)"
    )
    if args.write:
        engaged = mdelta.get("write.encode_fused_engaged", 0)
        declined = mdelta.get("write.encode_fused_declined", 0)
        written = mdelta.get("sink.sink_bytes_written_total", 0)
        print(
            f"profile: encode ladder fused={engaged} staged={declined}, "
            f"{written:,} B written"
        )
    else:
        # projection efficiency: the planner fetches only the projected
        # chunks' exact byte ranges, so bytes-read vs bytes-in-file shows
        # what a columns= projection actually saves at the source
        bytes_read = mdelta.get("io.io_bytes_read_total", 0)
        fsize = os.path.getsize(args.file)
        print(
            f"profile: io {bytes_read:,} B read / {fsize:,} B in file "
            f"({bytes_read / fsize:.1%} of file bytes)"
            if fsize
            else f"profile: io {bytes_read:,} B read"
        )
    if args.metrics:
        _print_counts(mdelta)
    return 0


def _profile_device_query(args, dev: str) -> int:
    """The `profile --device` body: the device QUERY path under
    torch.profiler — a per-row-group device partial aggregate (the
    `query.aggregate` range) and filtered device batches compacted on the
    device (`query.batches`). On the card the trace shows the predicate ->
    mask -> gather -> reduce kernels; with --cpu their plain versions.
    Nullable leaves batch as MaskedColumns (nullable="mask"), where the
    reference's default raises on a leaf with nulls."""
    from torch.profiler import record_function

    from ..core.filter_vec import VecFilterError
    from ..serve.protocol import parse_query_request
    from ..serve.query_device import DeviceQueryError, device_unit_partial

    import numpy as np

    with FileReader(args.file, device=dev) as r:
        numeric = next(
            (
                leaf
                for leaf in r.schema.leaves
                if leaf.max_rep == 0
                and leaf.type in (Type.INT32, Type.INT64, Type.FLOAT, Type.DOUBLE)
            ),
            None,
        )
        if args.filter:
            filt = json.loads(args.filter)
        elif numeric is not None:
            # midpoint of the first group: a predicate that actually splits
            # rows, so the mask/take kernels carry real work
            chunk = r.read_row_group(0, [numeric.path_str]).get(numeric.path)
            vals = np.asarray(chunk.values) if chunk is not None else None
            if vals is not None and len(vals):
                filt = [[[numeric.path_str, ">=", float(np.median(vals))]]]
            else:
                filt = [[[numeric.path_str, "not_null"]]]
        else:
            print(
                "profile: --device needs a numeric column or --filter",
                file=sys.stderr,
            )
            return 2
        aggs = ["count"]
        if numeric is not None and numeric.type in (Type.INT32, Type.INT64):
            aggs.append({"op": "sum", "column": numeric.path_str})
        q = parse_query_request(
            json.dumps(
                {"paths": [args.file], "aggregates": aggs, "filters": filt}
            ).encode()
        )
        cols = args.columns.split(",") if args.columns else None
        prof, sort_by = _profiler(dev)
        snap0 = _counts_snapshot()
        scanned = matched = kept = 0
        agg_engine = "device"
        with prof, record_function("file"):
            with record_function("query.aggregate"):
                try:
                    for i in range(r.num_row_groups):
                        _part, n_scan, n_match = device_unit_partial(
                            r, i, q, filt
                        )
                        scanned += n_scan
                        matched += n_match
                except DeviceQueryError:
                    agg_engine = "host (device declined)"
            with record_function("query.batches"):
                try:
                    for b in r.iter_device_batches(
                        1 << 15,
                        columns=cols,
                        drop_remainder=False,
                        nullable="mask",
                        filters=filt,
                        filter_rows=True,
                    ):
                        first = next(iter(b.values()))
                        if isinstance(first, MaskedColumn):
                            first = first.values
                        kept += int(first.shape[0])
                except VecFilterError as e:
                    print(f"profile: filter declined by every engine: {e}")
    mdelta = _counts_delta(snap0)
    doc = _trace_out(prof, sort_by, args.out, mdelta)
    print()
    print(
        f"profile: device query over {scanned:,} rows -> {matched:,} matched "
        f"(aggregate lane: {agg_engine}), {kept:,} rows compacted into "
        f"filtered batches, {len(doc['traceEvents'])} trace events -> "
        f"{args.out} (load in ui.perfetto.dev or chrome://tracing)"
    )
    engaged = mdelta.get("filter.device_filter_engaged", 0)
    declined = mdelta.get("filter.device_filter_declined", 0)
    print(f"profile: mask engine device={engaged} host_fallback={declined}")
    if args.metrics:
        _print_counts(mdelta)
    return 0


def _profile_live(args) -> int:
    """The `profile --live <url>` body: one /v1/debug/profile window."""
    import urllib.error
    import urllib.request

    base = args.live.rstrip("/")
    if not base.startswith(("http://", "https://")):
        base = "http://" + base
    fmt = "top" if args.top else "collapsed"
    url = (
        f"{base}/v1/debug/profile?seconds={args.seconds:g}"
        f"&interval_ms={args.interval_ms:g}&format={fmt}"
    )
    try:
        with urllib.request.urlopen(url, timeout=args.seconds + 30) as resp:
            text = resp.read().decode()
    except urllib.error.HTTPError as e:
        try:
            err = json.loads(e.read()).get("error", {})
            msg = f"{err.get('code', e.code)}: {err.get('message', '')}"
        except ValueError:
            msg = f"HTTP {e.code}"
        print(f"profile: {msg}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"profile: cannot reach {base}: {e}", file=sys.stderr)
        return 1
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        n = len(text.splitlines())
        print(
            f"profile: wrote {n} {fmt} lines to {args.out}"
            + (
                " (feed to flamegraph.pl / speedscope)"
                if fmt == "collapsed"
                else ""
            )
        )
    else:
        sys.stdout.write(text)
    return 0


def cmd_scan(args) -> int:
    """Stream a glob through ParquetDataset and report loader throughput.

    The consumer is a minimal touch of every batch (shape check only), so
    the headline is the LOADER's rows/s — decode + rebatch + delivery —
    and the wait share shows whether prefetch is keeping up: near 0% the
    consumer never starves, near 100% the loop is decode-bound (raise
    --prefetch, add workers, or shard wider).

    The port's dataset delivers every batch to the device it runs on
    (CUDA, or the CPU with --cpu), so on the card the rows/s is CUDA
    delivery: host decode on the pqt-data pool, then pinned uploads."""
    import os
    import time

    from ..data import ParquetDataset, dataset_counts
    from ..io import io_counts

    dev = _device(args)
    cols = args.columns.split(",") if args.columns else None
    if args.filters and args.filter:
        raise ValueError(
            "use either --filter (repeatable 'col OP value') or --filters "
            "(one JSON spec), not both"
        )
    if args.filters:
        # the same spec language POST /v1/scan accepts, via the same parser
        from ..serve.protocol import filters_from_spec

        try:
            spec = json.loads(args.filters)
        except ValueError as e:
            raise ValueError(f"--filters is not valid JSON: {e}") from None
        filters = filters_from_spec(spec)
    else:
        filters = _parse_filters(args.filter)
    if args.aggregate:
        return _scan_aggregate(args, filters, dev)
    ds = ParquetDataset(
        args.glob,
        batch_size=args.batch_size,
        columns=cols,
        filters=filters,
        shuffle=args.shuffle,
        seed=args.seed,
        num_epochs=args.epochs,
        prefetch=args.prefetch,
        remainder="keep",
        on_error=args.on_error,
        nullable=args.nullable,
        cache_bytes=args.cache_mb << 20,
        cache_disk_bytes=args.cache_disk_mb << 20,
        cache_dir=args.cache_dir,
        io_autotune=args.io_autotune,
        # --slo-ms doubles as the controller opt-in: the gate measures the
        # ADAPTIVE pipeline, the same thing production would run
        slo_wait_ms=args.slo_ms,
        device=dev,
    )
    plan = ds.plan
    for path, why in plan.skipped_files:
        print(f"scan: skipped {path}: {why}", file=sys.stderr)
    print(
        f"scan: {len(plan.files)} files, {plan.num_units} units, "
        f"{plan.total_rows:,} rows planned (shard "
        f"{ds.shard_index}/{ds.shard_count}, prefetch {ds.prefetch})"
    )
    if filters is not None:
        ps = plan.pruning_summary()
        print(
            f"scan: pruning {ps['units_admitted']}/{ps['units_total']} row "
            f"groups admitted ({ps['units_pruned_stats']} pruned by stats, "
            f"{ps['units_pruned_bloom']} by bloom)"
        )
    snap0 = {**io_counts(), **dataset_counts()}
    rows = batches = 0
    waits = []  # per-batch next() wall: the --slo-ms gate's percentiles
    t0 = time.perf_counter()
    with ds:
        it = iter(ds)
        while True:
            tb = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            waits.append(time.perf_counter() - tb)
            first = next(iter(batch.values()))
            if isinstance(first, MaskedColumn):
                first = first.values
            rows += int(first.shape[0])
            batches += 1
        # snapshot BEFORE close(): an owned tiered cache tears down (and
        # zeroes its stats) when the dataset does
        cache_stats = (
            ds._block_cache.stats() if ds._block_cache is not None else None
        )
    wall = time.perf_counter() - t0
    d = {
        k: v - snap0.get(k, 0)
        for k, v in {**io_counts(), **dataset_counts()}.items()
        if isinstance(v, (int, float))
    }
    wait = d.get("wait_seconds_sum", 0.0)
    skipped = d.get("units_skipped", 0)
    share = wait / wall if wall > 0 else 0.0
    print(
        f"scan: {rows:,} rows in {batches} batches over {wall:.3f}s "
        f"= {rows / wall:,.0f} rows/s"
    )
    print(
        f"scan: wait {wait:.3f}s ({share:.1%} of wall)"
        + (f", {skipped} unit(s) skipped" if skipped else "")
    )
    # projection efficiency + cache effect: what the io layer actually
    # fetched vs what lives on disk, and how much of it came from memory
    bytes_read = d.get("io_bytes_read_total", 0)
    file_bytes = sum(
        os.path.getsize(p) for p in plan.files if os.path.exists(p)
    )
    hits = d.get("io_cache_hits_total", 0)
    misses = d.get("io_cache_misses_total", 0)
    hit_rate = hits / (hits + misses) if (hits + misses) else None
    io_line = f"scan: io {bytes_read:,} B read"
    if file_bytes:
        io_line += (
            f" / {file_bytes:,} B in files "
            f"({bytes_read / file_bytes:.1%} of file bytes)"
        )
    if hit_rate is not None:
        io_line += f", cache hit rate {hit_rate:.1%}"
    print(io_line)
    if cache_stats and "disk" in cache_stats:
        spills = d.get("cache_tier_spills_total", 0)
        print(
            f"scan: cache tiers ram {cache_stats['ram']['bytes']:,} B "
            f"({cache_stats['ram']['blocks']} blocks) / disk "
            f"{cache_stats['disk']['bytes']:,} B "
            f"({cache_stats['disk']['blocks']} blocks, "
            f"{cache_stats['disk']['segments']} segments, {spills} spills)"
        )
    slo = None
    if args.slo_ms is not None:
        from ..testing.chaos import percentile

        p50 = (percentile(waits, 0.50) or 0.0) * 1e3
        p99 = (percentile(waits, 0.99) or 0.0) * 1e3
        slo = {
            "slo_ms": args.slo_ms,
            "p50_wait_ms": round(p50, 3),
            "p99_wait_ms": round(p99, 3),
            "held": p99 <= args.slo_ms,
        }
    if args.json:
        print(
            json.dumps(
                {
                    "files": len(plan.files),
                    "units": plan.num_units,
                    "rows": rows,
                    "batches": batches,
                    "wall_s": round(wall, 5),
                    "rows_s": round(rows / wall, 1) if wall > 0 else None,
                    "wait_s": round(wait, 5),
                    "wait_share": round(share, 4),
                    "units_skipped": skipped,
                    "prefetch": ds.prefetch,
                    "io_bytes_read": bytes_read,
                    "file_bytes": file_bytes,
                    "io_cache_hit_rate": (
                        round(hit_rate, 4) if hit_rate is not None else None
                    ),
                    "pruning": plan.pruning_summary(),
                    **({"slo": slo} if slo is not None else {}),
                }
            )
        )
    if slo is not None:
        # the CI gate: ONE line either way, non-zero exit on a violation
        verdict = "held" if slo["held"] else "VIOLATED"
        print(
            f"scan: slo {verdict}: p99 wait {slo['p99_wait_ms']:.2f} ms "
            f"(p50 {slo['p50_wait_ms']:.2f} ms) vs slo {args.slo_ms:.2f} ms "
            f"over {batches} batches"
        )
        if not slo["held"]:
            return 1
    return 0


def _scan_aggregate(args, filters, dev: str) -> int:
    """`scan --aggregate`: aggregation push-down over the glob, printing
    the CANONICAL query body — the exact bytes POST /v1/query would return
    for the same corpus and spec (serve/aggregate.py owns both). Each unit
    runs on `dev`."""
    from ..serve.aggregate import render_query_body, run_local_query
    from ..serve.protocol import (
        DEFAULT_MAX_GROUPS,
        MAX_MAX_GROUPS,
        QueryRequest,
        ServeError,
        aggregates_from_spec,
    )

    try:
        spec = json.loads(args.aggregate)
    except ValueError as e:
        raise ValueError(f"--aggregate is not valid JSON: {e}") from None
    max_groups = (
        args.max_groups if args.max_groups is not None else DEFAULT_MAX_GROUPS
    )
    if not 1 <= max_groups <= MAX_MAX_GROUPS:
        # the same bound the daemon's request parser enforces with a 400
        raise ValueError(
            f"--max-groups must be in [1, {MAX_MAX_GROUPS}], got {max_groups}"
        )
    try:
        aggs = aggregates_from_spec(spec)
        query = QueryRequest(
            paths=[args.glob],
            filters=filters,
            aggregates=aggs,
            group_by=tuple(
                c for c in (args.group_by or "").split(",") if c
            ),
            max_groups=max_groups,
            shard=None,
            timeout_ms=None,
        )
        body = run_local_query(query.paths, query, device=dev)
    except ServeError as e:
        # same typed-message discipline as the daemon, CLI-rendered
        raise ValueError(f"{e.code}: {e.message}") from None
    sys.stdout.write(render_query_body(body).decode())
    return 0


def cmd_serve(args) -> int:
    """Run the scan/query daemon (parquet_tpu_torch.serve) in the
    foreground: its /v1/query units run on CUDA (the CPU with --cpu). As
    `route` (or `serve --mesh`), the mesh router over --replica daemons,
    which holds no device.

    SIGTERM/SIGINT drain gracefully: in-flight requests complete, new ones
    get typed 503s, then the listener stops."""
    from ..obs.log import configure_logging
    from ..serve import ScanServer, ServeConfig
    from ..serve.protocol import _parse_shard

    # the daemon is the one place the library's silent-by-default logging
    # opts in: structured JSON lines on stderr, request ids injected
    configure_logging()
    remote_map = {}
    for spec in args.remote_map or ():
        prefix, sep, url = spec.partition("=")
        if not sep or not prefix or not url.startswith(("http://", "https://")):
            print(
                f"error: --remote-map {spec!r}: expected PREFIX=http(s)://...",
                file=sys.stderr,
            )
            return 2
        remote_map[prefix] = url
    mesh = getattr(args, "mesh", False)
    if mesh and args.cpu:
        print(
            "error: --cpu belongs on the replica daemons, not the router "
            "(the router holds no device)",
            file=sys.stderr,
        )
        return 2
    # the knobs both roles share: admission, deadlines, obs, SLO
    common = dict(
        host=args.host,
        port=args.port,
        max_inflight=args.max_inflight,
        tenant_concurrent=args.tenant_concurrent,
        tenant_budget_mb=args.tenant_budget_mb,
        budget_window_s=args.budget_window_s,
        default_timeout_s=(None if args.timeout_s == 0 else args.timeout_s),
        max_timeout_s=args.max_timeout_s,
        brownout_wait_ms=args.brownout_wait_ms,
        brownout_depth=args.brownout_depth,
        socket_timeout_s=args.socket_timeout_s,
        slo_availability=args.slo_availability,
        slo_p99_ms=args.slo_p99_ms,
        # obs flags default to None so ObsConfig (through ServeConfig)
        # stays the single owner of the numbers
        **{
            k: v
            for k, v in {
                "trace_sample_rate": args.trace_sample_rate,
                "slow_ms": args.slow_ms,
                "debug_ring_size": args.debug_ring,
                "debug_max_traces": args.debug_max_traces,
            }.items()
            if v is not None
        },
    )
    if mesh:
        from ..serve.mesh import MeshConfig, MeshRouter

        if not args.replica:
            print(
                "error: mesh mode needs at least one --replica URL",
                file=sys.stderr,
            )
            return 2
        for val, name in (
            (args.root, "--root"),
            (args.shard, "--shard"),
            (remote_map, "--remote-map"),
            (args.lake, "--lake"),
        ):
            if val:
                print(
                    f"error: {name} belongs on the replica daemons, not "
                    "the router (the router owns no corpus)",
                    file=sys.stderr,
                )
                return 2
        config = MeshConfig(
            replicas=tuple(args.replica),
            vnodes=args.vnodes,
            scatter=not args.no_scatter,
            scatter_window=args.scatter_window,
            backend_timeout_s=args.backend_timeout_s,
            hedge=not args.no_hedge,
            breaker_failures=args.breaker_failures,
            breaker_open_s=args.breaker_open_s,
            **common,
        )
        server = MeshRouter(config, verbose=args.verbose)
    else:
        dev = _device(args)
        config = ServeConfig(
            root=args.root,
            remote_map=remote_map or None,
            cache_mb=args.cache_mb,
            cache_disk_mb=args.cache_disk_mb,
            cache_dir=args.cache_dir,
            io_autotune=args.io_autotune,
            window=args.window,
            shard=_parse_shard(args.shard),
            lake_root=args.lake,
            lake_schema=args.lake_schema,
            lake_sort_key=args.lake_sort_key,
            lake_flush_mb=args.lake_flush_mb,
            device=dev,
            **common,
        )
        server = ScanServer(config, verbose=args.verbose)
    server.install_signal_handlers()
    # the exact line tests/scripts parse for the ephemeral --port 0 case
    print(f"serve: listening on {server.url}", flush=True)
    if mesh:
        print(
            f"serve: mesh router over {len(config.replicas)} replica(s)",
            flush=True,
        )
    elif server.config.root:
        print(f"serve: root {server.config.root}", flush=True)
    if not mesh and server.config.lake_root:
        print(f"serve: lake {server.config.lake_root}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.close()
    print("serve: drained, bye", flush=True)
    return 0


def _debug_fetch(url: str):
    """GET one debug endpoint; returns (status, parsed JSON). Typed error
    bodies come back as JSON too — the caller renders, never a traceback."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except ValueError:
            return e.code, {"error": {"code": "bad_response",
                                      "message": f"HTTP {e.code}"}}


def cmd_debug(args) -> int:
    """Query a running daemon's flight recorder (/v1/debug/requests).

    Without --id: list recent requests (newest first; --slow filters to
    the ones at/over the daemon's slow_ms). With --id: one record in full.
    With --id + --trace: the Perfetto-loadable Chrome-trace JSON, written
    to -o (or stdout) for ui.perfetto.dev / chrome://tracing. --vars
    snapshots the daemon's configuration (/v1/debug/vars); --tenants
    prints the per-tenant cost table (/v1/debug/tenants); --fleet scrapes
    every listed replica's /metrics and prints ONE merged exposition
    (counters summed, histogram buckets added, gauges kept per replica)."""
    if args.fleet:
        from ..obs import fleet as _fleet

        urls = [_fleet.normalize_peer(p) for p in args.fleet]
        view = _fleet.federate(urls)  # ValueError -> main()'s exit-1 path
        print(
            f"# fleet: merged {len(view['replicas'])} replica(s): "
            + ", ".join(view["replicas"])
        )
        for replica, why in sorted(view["errors"].items()):
            print(f"# fleet: {replica} failed: {why}")
        sys.stdout.write(view["text"])
        return 1 if view["errors"] else 0
    if not args.url:
        raise ValueError("debug: a daemon URL (or --fleet URL...) is required")
    base = args.url.rstrip("/")
    if not base.startswith(("http://", "https://")):
        base = "http://" + base
    if args.trace and not args.id:
        raise ValueError("debug: --trace requires --id REQUEST_ID")
    if args.vars:
        status, body = _debug_fetch(f"{base}/v1/debug/vars")
        if status != 200:
            err = body.get("error", {})
            print(
                f"debug: {err.get('code', status)}: {err.get('message', '')}",
                file=sys.stderr,
            )
            return 1
        print(json.dumps(body, indent=2))
        return 0
    if args.tenants:
        status, body = _debug_fetch(f"{base}/v1/debug/tenants")
        if status != 200:
            err = body.get("error", {})
            print(
                f"debug: {err.get('code', status)}: {err.get('message', '')}",
                file=sys.stderr,
            )
            return 1
        rows = body.get("tenants", [])
        if not rows:
            print("debug: no tenant usage recorded")
            return 0
        print(
            f"{'TENANT':<18} {'CPU_S':>9} {'DECODED_B':>13} {'SOURCE_B':>12} "
            f"{'PAYLOAD_B':>12} {'HIT':>6} {'MISS':>6} {'REQS':>6} {'UNITS':>6}"
        )
        for r in rows:
            print(
                f"{r['tenant']:<18} {r['cpu_seconds']:>9.3f} "
                f"{r['decoded_bytes']:>13,} {r['source_bytes']:>12,} "
                f"{r['payload_bytes']:>12,} {r['cache_hits']:>6} "
                f"{r['cache_misses']:>6} {r['requests']:>6} {r['units']:>6}"
            )
        t = body.get("totals")
        if t:
            print(
                f"{'TOTAL':<18} {t['cpu_seconds']:>9.3f} "
                f"{t['decoded_bytes']:>13,} {t['source_bytes']:>12,} "
                f"{t['payload_bytes']:>12,} {t['cache_hits']:>6} "
                f"{t['cache_misses']:>6} {t['requests']:>6} {t['units']:>6}"
            )
        return 0
    if args.id:
        path = f"{base}/v1/debug/requests/{args.id}"
        if args.trace:
            path += "/trace"
        status, body = _debug_fetch(path)
        if status != 200:
            err = body.get("error", {})
            print(
                f"debug: {err.get('code', status)}: {err.get('message', '')}",
                file=sys.stderr,
            )
            return 1
        text = json.dumps(body, indent=None if args.trace else 2)
        if args.trace and args.output:
            with open(args.output, "w") as f:
                f.write(text)
            n = len(body.get("traceEvents", []))
            print(f"debug: wrote {n} trace events to {args.output}")
        else:
            print(text)
        return 0
    qs = f"?limit={args.limit}" + ("&slow=1" if args.slow else "")
    status, body = _debug_fetch(f"{base}/v1/debug/requests{qs}")
    if status != 200:
        err = body.get("error", {})
        print(
            f"debug: {err.get('code', status)}: {err.get('message', '')}",
            file=sys.stderr,
        )
        return 1
    reqs = body.get("requests", [])
    if not reqs:
        print("debug: no recorded requests" + (" at/over slow_ms" if args.slow else ""))
        return 0
    print(
        f"{'ID':<18} {'ENDPOINT':<14} {'TENANT':<10} {'STATUS':<7} "
        f"{'MS':>9} {'BYTES':>12} {'WAIT_MS':>8} TRACE"
    )
    for r in reqs:
        dur = r.get("duration_ms")
        print(
            f"{r['id']:<18} {r['endpoint']:<14} {str(r['tenant']):<10} "
            f"{str(r['status']):<7} "
            f"{dur if dur is not None else '-':>9} {r['bytes']:>12} "
            f"{r['queue_wait_ms']:>8} "
            f"{r.get('trace_kind') or '-'}{' (open)' if r.get('open') else ''}"
        )
    return 0


def cmd_trace_merge(args) -> int:
    """Stitch per-process Chrome-trace documents (each exported by
    `debug --id X --trace -o`) into ONE Perfetto document on their shared
    trace id: every input becomes its own named process lane, so a
    router's spans and its replicas' spans of one request sit on one
    timeline."""
    from ..obs.propagate import merge_chrome_traces

    docs = []
    for path in args.files:
        with open(path) as f:
            try:
                docs.append(json.load(f))
            except json.JSONDecodeError as e:
                raise ValueError(f"trace-merge: {path}: {e}") from None
    if args.label and len(args.label) != len(args.files):
        raise ValueError(
            "trace-merge: one --label per input file "
            f"(got {len(args.label)} labels for {len(args.files)} files)"
        )
    merged = merge_chrome_traces(docs, labels=args.label)
    text = json.dumps(merged)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        trace_id = merged["otherData"]["propagation"]["trace_id"]
        print(
            f"trace-merge: stitched {len(docs)} process(es), "
            f"{len(merged['traceEvents'])} events on trace {trace_id} "
            f"-> {args.out}"
        )
    else:
        print(text)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="parquet-tool", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    filter_help = (
        "predicate 'column OP value' (repeatable, ANDed; OP: == != < <= > >= "
        "in not_in — set ops take a list: 'id in (1,2,3)'); row groups and "
        "pages excluded by statistics/bloom/page-index never load"
    )
    pc = sub.add_parser("cat", help="print all rows as JSON lines")
    pc.add_argument("file")
    pc.add_argument("--raw", action="store_true", help="raw nested-map row shape")
    pc.add_argument("--columns", help="comma-separated column projection")
    pc.add_argument("--filter", action="append", help=filter_help)
    pc.set_defaults(fn=cmd_cat)

    ph = sub.add_parser("head", help="print the first N rows")
    ph.add_argument("-n", type=int, default=5)
    ph.add_argument("file")
    ph.add_argument("--raw", action="store_true")
    ph.add_argument("--columns", help="comma-separated column projection")
    ph.add_argument("--filter", action="append", help=filter_help)
    ph.set_defaults(fn=cmd_head)

    pm = sub.add_parser("meta", help="print file + column metadata")
    pm.add_argument("file")
    pm.set_defaults(fn=cmd_meta)

    pg = sub.add_parser("pages", help="per-page layout from the page index")
    pg.add_argument("file")
    pg.set_defaults(fn=cmd_pages)

    ps = sub.add_parser("schema", help="print the schema DSL")
    ps.add_argument("file")
    ps.set_defaults(fn=cmd_schema)

    pr = sub.add_parser("rowcount", help="print the number of rows")
    pr.add_argument("file")
    pr.set_defaults(fn=cmd_rowcount)

    pv = sub.add_parser(
        "verify",
        help="scan every page; report corrupt ones with offset, stage and "
        "error (exit 1 when any found)",
    )
    pv.add_argument("file")
    pv.add_argument(
        "--no-crc",
        action="store_true",
        help="skip stored-CRC verification (decode checks still run)",
    )
    pv.set_defaults(fn=cmd_verify)

    pz = sub.add_parser(
        "salvage",
        help="copy the readable row groups of a damaged file into a fresh "
        "one (verbatim chunk bytes, no re-encoding)",
    )
    pz.add_argument("file")
    pz.add_argument("-o", "--out", required=True, help="output file")
    pz.add_argument(
        "--force", action="store_true", help="overwrite an existing output"
    )
    pz.add_argument(
        "--no-crc",
        action="store_true",
        help="treat CRC-mismatched pages as readable (decode checks still run)",
    )
    pz.set_defaults(fn=cmd_salvage)

    pf = sub.add_parser(
        "profile",
        help="decode the file under torch.profiler; write Chrome "
        "trace-event JSON (Perfetto/chrome://tracing) + per-operator report",
    )
    pf.add_argument("file", nargs="?", help="file to profile (omit with --live)")
    pf.add_argument(
        "-o", "--out",
        help="trace JSON output path (file mode, required there); "
        "collapsed/top text output path (--live mode, optional)",
    )
    pf.add_argument(
        "--columns",
        help="comma-separated column projection (the io line then shows the "
        "projection's bytes-read vs bytes-in-file efficiency)",
    )
    pf.add_argument(
        "--metrics",
        action="store_true",
        help="also print the process metrics delta + summary for the run",
    )
    pf.add_argument(
        "--rows",
        action="store_true",
        help="profile an assembled read (iter_rows) instead of the column "
        "decode: the assemble/assembly.rows stages show where record "
        "assembly spends its time (host path)",
    )
    pf.add_argument(
        "--write",
        action="store_true",
        help="profile an ENCODE instead of a decode: read the file's rows, "
        "then re-encode them (same schema + codec) to a memory sink under "
        "the tracer — the write.encode / encode.* stages show where the "
        "write path spends its time, fused-vs-staged counters included",
    )
    pf.add_argument(
        "--host",
        action="store_true",
        help="profile the pure host decode path (no device) instead of the "
        "device-decode pipeline",
    )
    pf.add_argument(
        "--device",
        action="store_true",
        help="profile the device QUERY path instead: filtered device "
        "batches and per-row-group device partial aggregates — the "
        "query.mask / query.take / query.aggregate lanes show where the "
        "predicate -> mask -> gather -> reduce pipeline spends its time",
    )
    pf.add_argument(
        "--filter",
        help="DNF predicate as JSON for --device mode (e.g. "
        "'[[[\"id\", \">\", 100]]]'); default: first numeric leaf >= its "
        "first-group median",
    )
    pf.add_argument(
        "--cpu",
        action="store_true",
        help="run the device modes on the CPU (the kernels' plain "
        "versions); without it they run on CUDA, which must be there",
    )
    pf.add_argument(
        "--live",
        metavar="URL",
        help="profile a RUNNING daemon via GET /v1/debug/profile instead "
        "of decoding a file: prints flamegraph-compatible collapsed "
        "stacks attributed to the pqt-* pool lanes",
    )
    pf.add_argument(
        "--seconds",
        type=float,
        default=2.0,
        help="live capture window length (default 2)",
    )
    pf.add_argument(
        "--interval-ms",
        type=float,
        default=10.0,
        help="live sampling interval (default 10 ms)",
    )
    pf.add_argument(
        "--top",
        action="store_true",
        help="with --live: print the top self-time table instead of "
        "collapsed stacks",
    )
    pf.set_defaults(fn=cmd_profile)

    pn = sub.add_parser(
        "scan",
        help="stream a glob through the dataset layer; report rows/s and "
        "wait-time share",
    )
    pn.add_argument("glob", help="glob pattern or single file")
    pn.add_argument("--columns", help="comma-separated column projection")
    pn.add_argument("--filter", action="append", help=filter_help)
    pn.add_argument(
        "--filters",
        help="JSON filter spec — a list of [column, op, value] triples "
        "(ANDed) or a list of such lists (ORed), exactly what POST "
        "/v1/scan accepts; mutually exclusive with --filter",
    )
    pn.add_argument("--batch-size", type=int, default=8192)
    pn.add_argument("--prefetch", type=int, default=2, help="units decoded ahead")
    pn.add_argument(
        "--cache-mb",
        type=int,
        default=0,
        help="shared block-cache budget in MiB (0 = off); enables pqt-io "
        "readahead of upcoming units' byte ranges",
    )
    pn.add_argument(
        "--cache-disk-mb",
        type=int,
        default=0,
        help="grow the block cache into a RAM->disk TieredCache with this "
        "many MiB of local-disk spill (the remote-corpus shape; 0 = RAM "
        "only)",
    )
    pn.add_argument(
        "--cache-dir",
        help="tiered-cache spill directory (default: a private temp dir "
        "removed on exit; a given dir is reused across runs — intact "
        "spilled blocks survive restarts)",
    )
    pn.add_argument(
        "--io-autotune",
        action="store_true",
        help="resolve the read coalesce gap + readahead depth per fetch "
        "from the observed per-transport latency profile (remote sources "
        "coalesce MiB-scale; local corpora keep the 64 KiB default)",
    )
    pn.add_argument("--epochs", type=int, default=1)
    pn.add_argument("--shuffle", action="store_true")
    pn.add_argument("--seed", type=int, default=0)
    pn.add_argument(
        "--on-error",
        choices=("raise", "skip", "null"),
        default="raise",
        help="per-unit corruption policy (skip: a corrupt shard degrades "
        "the scan instead of killing it)",
    )
    pn.add_argument(
        "--nullable",
        choices=("zero", "error"),
        default="zero",
        help="null handling: zero-fill (default — a throughput scan should "
        "not die on nullable data) or error",
    )
    pn.add_argument(
        "--aggregate",
        metavar="JSON",
        help="aggregation push-down instead of a throughput scan: a JSON "
        'list of aggregates — e.g. \'["count", ["sum", "v"]]\' — exactly '
        "what POST /v1/query accepts; prints the canonical query body "
        "(byte-identical to the daemon's response for the same corpus)",
    )
    pn.add_argument(
        "--group-by",
        help="comma-separated group-by columns (with --aggregate)",
    )
    pn.add_argument(
        "--max-groups",
        type=int,
        default=None,
        help="typed overflow past this many distinct groups "
        "(default: the protocol's bound)",
    )
    pn.add_argument(
        "--json", action="store_true", help="also print a JSON result line"
    )
    pn.add_argument(
        "--slo-ms",
        type=float,
        default=None,
        help="latency gate: attach the elastic-SLO controller, then exit "
        "non-zero (one-line report) when the p99 per-batch consumer wait "
        "exceeds this many milliseconds — CI-able",
    )
    pn.add_argument(
        "--cpu",
        action="store_true",
        help="deliver batches (and run --aggregate's units) on the CPU; "
        "without it on CUDA, which must be there",
    )
    pn.set_defaults(fn=cmd_scan)

    # serve and route share one flag set: `route` IS `serve --mesh`, so a
    # parent parser keeps the two surfaces from drifting apart
    pe = argparse.ArgumentParser(add_help=False)
    pe.add_argument("--host", default="127.0.0.1")
    pe.add_argument(
        "--port", type=int, default=8080, help="0 binds an ephemeral port"
    )
    pe.add_argument(
        "--root",
        help="confine requested paths to this directory (strongly "
        "recommended; escapes get typed 403s)",
    )
    pe.add_argument(
        "--lake",
        help="serve a lake table rooted at this directory: POST /v1/append "
        "ingests rows into it (flushes publish manifest generations); "
        "pair with --root so scans can read the table back",
    )
    pe.add_argument(
        "--lake-schema",
        help="schema DSL used to CREATE the lake table when --lake does "
        "not exist yet (an existing table ignores this and keeps its own)",
    )
    pe.add_argument(
        "--lake-sort-key",
        help="leaf column new tables sort/cluster by (with --lake-schema)",
    )
    pe.add_argument(
        "--lake-flush-mb",
        type=int,
        default=4,
        help="ingest buffer size in MiB; reaching it (or ?flush=1) "
        "commits the buffered rows as one generation",
    )
    pe.add_argument(
        "--cache-mb",
        type=int,
        default=64,
        help="shared block-cache budget in MiB (0 = off); footers always "
        "cache, so warm repeat plans do zero source reads",
    )
    pe.add_argument(
        "--cache-disk-mb",
        type=int,
        default=0,
        help="grow the block cache into a RAM->disk TieredCache with this "
        "many MiB of local-disk spill (tier stats ride /v1/debug/vars; "
        "0 = RAM only)",
    )
    pe.add_argument(
        "--cache-dir",
        help="tiered-cache spill directory (default: a private temp dir "
        "removed on close; a given dir is reused across restarts — "
        "intact spilled blocks re-serve after a crash)",
    )
    pe.add_argument(
        "--io-autotune",
        action="store_true",
        help="resolve executor read coalescing + readahead from observed "
        "per-transport latency profiles (matters with a remote "
        "source-factory; local roots keep the defaults)",
    )
    pe.add_argument(
        "--max-inflight",
        type=int,
        default=32,
        help="global concurrent-request cap (excess gets typed 429s)",
    )
    pe.add_argument(
        "--tenant-concurrent",
        type=int,
        default=8,
        help="per-tenant concurrent-request cap (X-Tenant header)",
    )
    pe.add_argument(
        "--tenant-budget-mb",
        type=int,
        default=None,
        help="per-tenant scanned-byte budget per window (charged with the "
        "plan estimate; exhaustion gets typed 429s with Retry-After)",
    )
    pe.add_argument(
        "--budget-window-s",
        type=float,
        default=60.0,
        help="token-bucket refill window for --tenant-budget-mb",
    )
    pe.add_argument(
        "--timeout-s",
        type=float,
        default=30.0,
        help="default per-request deadline (0 = none; X-Timeout-Ms / "
        "body timeout_ms override, clamped to --max-timeout-s)",
    )
    pe.add_argument("--max-timeout-s", type=float, default=300.0)
    pe.add_argument(
        "--brownout-wait-ms",
        type=float,
        default=None,
        help="shed NEW scans with typed 503s (+Retry-After) once the scan "
        "pool's windowed mean queue wait crosses this — degrade early and "
        "loudly instead of mass-504ing later (default: disabled)",
    )
    pe.add_argument(
        "--brownout-depth",
        type=int,
        default=None,
        help="also shed when the scan pool's queue depth crosses this "
        "(catches a fully wedged pool that produces no new wait samples)",
    )
    pe.add_argument(
        "--socket-timeout-s",
        type=float,
        default=60.0,
        help="per-socket-op timeout: a stalled client (stops sending or "
        "stops reading) frees its thread and admission slot after this",
    )
    pe.add_argument(
        "--window",
        type=int,
        default=2,
        help="per-request unit decode lookahead (the backpressure bound)",
    )
    pe.add_argument(
        "--shard",
        help="this daemon's corpus stripe as 'i/n' — run n daemons with "
        "i=0..n-1 over the same files to split one logical corpus",
    )
    pe.add_argument(
        "--remote-map",
        action="append",
        metavar="PREFIX=URL",
        help="map requested paths under PREFIX to an object-store base "
        "URL (repeatable; longest prefix wins) — e.g. "
        "--remote-map warm=https://store/bucket; mapped reads flow "
        "through the shared cache tiers, everything else stays "
        "root-confined",
    )
    pe.add_argument(
        "--verbose", action="store_true", help="log every request line"
    )
    pe.add_argument(
        "--cpu",
        action="store_true",
        help="run /v1/query units on the CPU (the kernels' plain versions); "
        "without it on CUDA, which must be there (refused by the router, "
        "which holds no device)",
    )
    pe.add_argument(
        "--trace-sample-rate",
        type=float,
        default=None,
        help="share of ok-and-fast requests whose full span tree the "
        "flight recorder keeps (errored/slow requests always keep "
        "theirs; default from ObsConfig: 1%%)",
    )
    pe.add_argument(
        "--slow-ms",
        type=float,
        default=None,
        help="requests at/over this wall time count as slow: "
        "serve_slow_requests_total, a warning log line, and an "
        "always-retained trace (default from ObsConfig: 1s)",
    )
    pe.add_argument(
        "--debug-ring",
        type=int,
        default=None,
        help="flight-recorder retention: how many recent requests "
        "/v1/debug/requests can list (default from ObsConfig)",
    )
    pe.add_argument(
        "--debug-max-traces",
        type=int,
        default=None,
        help="how many full span trees the flight recorder retains "
        "(each can be MBs; sampled/slow/errored requests compete for "
        "these slots, newest win; default from ObsConfig)",
    )
    pe.add_argument(
        "--slo-availability",
        type=float,
        default=0.999,
        help="the availability objective the burn-rate engine evaluates "
        "(share of requests that must not 5xx; /healthz reports "
        "'degraded' while the error budget burns at page rate on both "
        "the 5m and 1h windows; full math at /v1/debug/slo)",
    )
    pe.add_argument(
        "--slo-p99-ms",
        type=float,
        default=None,
        help="optional p99 latency objective (ms): enables the latency "
        "SLI — at most 1%% of requests may run over this bar",
    )
    pe.add_argument(
        "--replica",
        action="append",
        metavar="URL",
        help="a backend daemon's base URL (repeatable; mesh mode needs "
        "at least one) — the router consistent-hashes plan units over "
        "these and merges answers byte-identically",
    )
    pe.add_argument(
        "--vnodes",
        type=int,
        default=64,
        help="virtual nodes per replica on the hash ring (more = "
        "smoother unit spread, slower table rebuilds)",
    )
    pe.add_argument(
        "--no-scatter",
        action="store_true",
        help="mesh: forward each request whole to its owning replica "
        "instead of scattering per plan unit",
    )
    pe.add_argument(
        "--scatter-window",
        type=int,
        default=8,
        help="mesh: per-request bound on in-flight unit fetches (the "
        "scatter backpressure window)",
    )
    pe.add_argument(
        "--backend-timeout-s",
        type=float,
        default=30.0,
        help="mesh: per-hop timeout for one router->replica round trip "
        "(the request deadline still bounds the whole fan-out)",
    )
    pe.add_argument(
        "--no-hedge",
        action="store_true",
        help="mesh: disable the p95-armed duplicate attempt on the "
        "next-preference replica",
    )
    pe.add_argument(
        "--breaker-failures",
        type=int,
        default=3,
        help="mesh: consecutive failures before a replica's circuit "
        "breaker opens",
    )
    pe.add_argument(
        "--breaker-open-s",
        type=float,
        default=2.0,
        help="mesh: how long an open replica breaker rejects before "
        "half-opening one probe",
    )
    ps = sub.add_parser(
        "serve",
        parents=[pe],
        help="run the concurrent scan/query daemon (POST /v1/scan, "
        "GET /v1/plan, /metrics, /healthz); SIGTERM drains gracefully; "
        "--mesh turns it into the fleet router",
    )
    ps.add_argument(
        "--mesh",
        action="store_true",
        help="serve as the mesh router over --replica daemons instead "
        "of scanning locally (same as the `route` subcommand)",
    )
    ps.set_defaults(fn=cmd_serve)
    pr = sub.add_parser(
        "route",
        parents=[pe],
        help="run the mesh router over --replica daemons (alias for "
        "`serve --mesh`): consistent-hash scatter/gather for /v1/scan "
        "and /v1/query with byte-identical merged results",
    )
    pr.set_defaults(fn=cmd_serve, mesh=True)

    pd = sub.add_parser(
        "debug",
        help="query a running daemon's flight recorder: list recent "
        "requests, fetch one by id, or export its Perfetto trace",
    )
    pd.add_argument(
        "url",
        nargs="?",
        default=None,
        help="daemon base URL, e.g. http://127.0.0.1:8080 "
        "(not needed with --fleet)",
    )
    pd.add_argument("--id", help="one request id (the X-Request-Id echo)")
    pd.add_argument(
        "--trace",
        action="store_true",
        help="with --id: fetch the Chrome-trace JSON (ui.perfetto.dev)",
    )
    pd.add_argument(
        "-o", "--output", help="with --trace: write the trace document here"
    )
    pd.add_argument(
        "--slow",
        action="store_true",
        help="list only requests at/over the daemon's slow_ms",
    )
    pd.add_argument(
        "--limit", type=int, default=100, help="max requests to list"
    )
    pd.add_argument(
        "--vars",
        action="store_true",
        help="snapshot the daemon's /v1/debug/vars (uptime, pid, version, "
        "pool sizes, resilience policy, cache/admission budgets)",
    )
    pd.add_argument(
        "--tenants",
        action="store_true",
        help="print the per-tenant cost table (/v1/debug/tenants): CPU "
        "seconds, decoded/source bytes, cache outcomes, hottest first",
    )
    pd.add_argument(
        "--fleet",
        nargs="+",
        metavar="URL",
        help="scrape these replicas' /metrics (bare host:port works) and "
        "print one merged exposition: counters summed, histogram buckets "
        "added, gauges kept per replica under a replica= label",
    )
    pd.set_defaults(fn=cmd_debug)

    pt = sub.add_parser(
        "trace-merge",
        help="stitch per-process Chrome traces of ONE request (shared "
        "traceparent trace-id) into a single Perfetto document",
    )
    pt.add_argument(
        "files",
        nargs="+",
        help="input Chrome-trace JSON documents (from debug --trace -o); "
        "all must carry the same propagation trace-id",
    )
    pt.add_argument(
        "-o", "--out", default=None, help="merged output file (default: stdout)"
    )
    pt.add_argument(
        "--label",
        action="append",
        help="process lane name, one per input in order (default: each "
        "document's recorded endpoint)",
    )
    pt.set_defaults(fn=cmd_trace_merge)

    pp = sub.add_parser("split", help="split into parts by rows or file size")
    pp.add_argument("-n", type=int, help="rows per part")
    pp.add_argument(
        "--size",
        type=_parse_size,
        help="target bytes per part (suffixes K/M/G), like the reference",
    )
    pp.add_argument("--codec", default=None, help="re-encode codec (default snappy; invalid with --groups)")
    pp.add_argument(
        "--groups",
        type=int,
        help="row GROUPS per part: verbatim chunk-byte copy, no re-encoding "
        "(fast lane; -n/--size re-encode rows)",
    )
    pp.add_argument("file")
    pp.add_argument("out", help="output pattern containing %%d")
    pp.set_defaults(fn=cmd_split)

    pm = sub.add_parser(
        "merge", help="concatenate files at row-group level (no re-encoding)"
    )
    pm.add_argument(
        "-o",
        "--out",
        default=None,
        help="output file (canonical, parquet-mr argument order: "
        "merge <inputs...> -o <output>)",
    )
    pm.add_argument(
        "--force",
        action="store_true",
        help="overwrite the output file if it already exists",
    )
    pm.add_argument(
        "files",
        nargs="+",
        help="input files, order preserved (without -o the FIRST positional "
        "is taken as the output — deprecated legacy form)",
    )
    pm.set_defaults(fn=cmd_merge)

    pl = sub.add_parser(
        "lake",
        help="operate on a lake table: init, append rows, compact small "
        "files, or print the snapshot manifest (time travel with --gen)",
    )
    lsub = pl.add_subparsers(dest="lake_cmd", required=True)
    li = lsub.add_parser(
        "init", help="create a lake table (schema DSL + optional sort key)"
    )
    li.add_argument("table", help="table directory (created if missing)")
    li.add_argument(
        "--schema",
        required=True,
        help="schema DSL, e.g. 'message m { required int64 k; "
        "optional binary v (STRING); }'",
    )
    li.add_argument(
        "--sort-key", help="leaf column ingest/compaction cluster by"
    )
    li.add_argument(
        "--retain",
        type=int,
        default=64,
        help="generations kept for time travel before files are unlinked",
    )
    li.set_defaults(fn=cmd_lake)
    la = lsub.add_parser(
        "append",
        help="append jsonl rows from FILE (or stdin with '-') and commit "
        "them as one manifest generation",
    )
    la.add_argument("table", help="lake table directory")
    la.add_argument(
        "file",
        nargs="?",
        default="-",
        help="jsonl input file; '-' (default) reads stdin",
    )
    la.set_defaults(fn=cmd_lake)
    lc = lsub.add_parser(
        "compact",
        help="fold the snapshot's small files into sort-keyed row groups "
        "and commit the rewrite as one generation",
    )
    lc.add_argument("table", help="lake table directory")
    lc.add_argument("--min-files", type=int, default=2)
    lc.add_argument("--max-files", type=int, default=32)
    lc.add_argument(
        "--small-file-mb",
        type=int,
        default=64,
        help="files under this size are compaction candidates",
    )
    lc.add_argument(
        "--reap",
        action="store_true",
        help="also remove crash-orphaned tmp/data files past --reap-grace-s",
    )
    lc.add_argument(
        "--reap-grace-s",
        type=float,
        default=300.0,
        help="minimum age before an unreferenced file counts as an orphan",
    )
    lc.set_defaults(fn=cmd_lake)
    lm = lsub.add_parser(
        "manifest",
        help="print the snapshot a scan of this table pins "
        "(--gen N time-travels to a retained generation)",
    )
    lm.add_argument("table", help="lake table directory")
    lm.add_argument(
        "--gen", type=int, default=None, help="pin this generation"
    )
    lm.add_argument("--json", action="store_true", help="machine output")
    lm.set_defaults(fn=cmd_lake)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, OSError) as e:
        print(f"parquet-tool: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
