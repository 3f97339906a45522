"""csv2parquet: CSV -> Parquet with optional per-column type hints.

The port of parquet_tpu/tools/csv2parquet.py: a host path (rows shredded
and encoded by core/writer, nothing on the card); the same CSV and hints
give the reference's file byte for byte.

Equivalent of the reference's cmd/csv2parquet (reference:
cmd/csv2parquet/main.go:25-32 flags, parseTypeHints/writeParquetData): derives
an all-optional-string schema from the header by default; -typehints overrides
per column with one of: string, byte_array, boolean, int8/16/32/64,
uint8/16/32/64, float, double, int, json.

    python -m parquet_tpu_torch.tools.csv2parquet -o out.parquet \
        -typehints "age=int64,score=double" in.csv
"""

from __future__ import annotations

import argparse
import csv
import sys

from ..core.writer import FileWriter
from ..meta.parquet_types import Type
from ..meta.parquet_types import ConvertedType, JsonType, LogicalType
from ..schema.builder import _TypeSpec, int_type, message, optional, string

__all__ = ["main", "parse_type_hints"]

_HINTS = {
    "string": string,
    "byte_array": lambda: Type.BYTE_ARRAY,
    "boolean": lambda: Type.BOOLEAN,
    "int8": lambda: int_type(8),
    "int16": lambda: int_type(16),
    "int32": lambda: Type.INT32,
    "int64": lambda: Type.INT64,
    "int": lambda: Type.INT64,
    "uint8": lambda: int_type(8, signed=False),
    "uint16": lambda: int_type(16, signed=False),
    "uint32": lambda: int_type(32, signed=False),
    "uint64": lambda: int_type(64, signed=False),
    "float": lambda: Type.FLOAT,
    "double": lambda: Type.DOUBLE,
    "json": lambda: _TypeSpec(
        Type.BYTE_ARRAY,
        converted=ConvertedType.JSON,
        logical=LogicalType(JSON=JsonType()),
    ),
}

_BOOL_TRUE = {"true", "1", "t", "yes", "y"}
_BOOL_FALSE = {"false", "0", "f", "no", "n"}


def parse_type_hints(text: str) -> dict[str, str]:
    hints = {}
    if not text:
        return hints
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"csv2parquet: bad type hint {part!r} (want col=type)")
        col, typ = part.split("=", 1)
        typ = typ.strip().lower()
        if typ not in _HINTS:
            raise ValueError(
                f"csv2parquet: unknown type {typ!r} (valid: {', '.join(sorted(_HINTS))})"
            )
        hints[col.strip()] = typ
    return hints


def _convert(value: str, typ: str, col: str, line: int):
    if value == "":
        return None
    try:
        if typ in ("string", "json"):
            return value
        if typ == "byte_array":
            return value.encode("utf-8")
        if typ == "boolean":
            lv = value.lower()
            if lv in _BOOL_TRUE:
                return True
            if lv in _BOOL_FALSE:
                return False
            raise ValueError(f"not a boolean: {value!r}")
        if typ in ("float", "double"):
            return float(value)
        return int(value)
    except ValueError as e:
        raise ValueError(f"csv2parquet: line {line}, column {col!r}: {e}") from e


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="csv2parquet", description=__doc__)
    p.add_argument("-o", "--output", required=True, help="output parquet file")
    p.add_argument("-typehints", "--typehints", default="", help="col=type,...")
    p.add_argument("--codec", default="snappy")
    p.add_argument("--row-group-size", type=int, default=1_000_000, help="rows per row group")
    p.add_argument("--delimiter", default=",")
    p.add_argument(
        "--page-index", action="store_true",
        help="write the Parquet page index (per-page min/max for pruning)",
    )
    p.add_argument(
        "--bloom", default="",
        help="comma-separated columns to build bloom filters for",
    )
    p.add_argument(
        "--sort", default="",
        help="comma-separated columns recorded as the row ordering "
        "(metadata only; data is written as-is)",
    )
    p.add_argument(
        "--parallel", type=int, default=0, metavar="N",
        help="encode row groups on N pqt-encode workers (0 = serial; "
        "output bytes are identical either way, and the file commits "
        "atomically at close)",
    )
    p.add_argument("csv", help="input CSV file with header row")
    args = p.parse_args(argv)

    try:
        hints = parse_type_hints(args.typehints)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2

    with open(args.csv, newline="") as f:
        reader = csv.reader(f, delimiter=args.delimiter)
        try:
            header = next(reader)
        except StopIteration:
            print("csv2parquet: empty input", file=sys.stderr)
            return 1
        unknown = set(hints) - set(header)
        if unknown:
            print(f"csv2parquet: type hints for unknown columns {sorted(unknown)}", file=sys.stderr)
            return 2
        col_types = {c: hints.get(c, "string") for c in header}
        fields = [optional(c, _HINTS[col_types[c]]()) for c in header]
        schema = message(*fields, name="csv")
        n = 0
        wkw = {}
        if args.page_index:
            wkw["write_page_index"] = True
        if args.bloom:
            wkw["bloom_filters"] = [c.strip() for c in args.bloom.split(",") if c.strip()]
        if args.sort:
            wkw["sorting_columns"] = [c.strip() for c in args.sort.split(",") if c.strip()]
        if args.parallel:
            wkw["parallel"] = args.parallel
        try:
            with FileWriter(args.output, schema, codec=args.codec, **wkw) as w:
                for i, rec in enumerate(reader, start=2):
                    if len(rec) != len(header):
                        print(
                            f"csv2parquet: line {i}: {len(rec)} fields, expected {len(header)}",
                            file=sys.stderr,
                        )
                        return 1
                    row = {
                        c: _convert(v, col_types[c], c, i)
                        for c, v in zip(header, rec)
                    }
                    w.write_row(row)
                    n += 1
                    if n % args.row_group_size == 0:
                        w.flush_row_group()
        except ValueError as e:
            print(e, file=sys.stderr)
            return 1
    print(f"wrote {n} rows to {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
