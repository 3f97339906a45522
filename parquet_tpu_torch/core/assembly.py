"""Dremel record assembly: the scalar cursor walk and shared value plumbing.

A copy of parquet_tpu/core/assembly.py. Host-side equivalent of the
reference's record-assembly stack (reference: schema.go:216-312
getData/getNextData, data_store.go:262-309 ColumnStore.get): walks the schema
tree with one cursor per leaf and rebuilds each row's nested structure from
the level streams. Rows are Python values built on the host: nothing here
touches a device.

The DEFAULT assembly engine lives in core/assembly_vec.py: whole-column
prefix scans over the level streams build an offsets/validity intermediate
and materialize rows by batched slicing. The cursor walk here remains as the
PQT_VEC_ASSEMBLY=0 fallback, the engine for shapes the scans cannot prove,
and the differential-test oracle (RecordAssembler iterates through the
vectorized engine by default; pass engine="scalar" to force the walk).

Two output modes:
  raw=True   reference-style nested maps: LIST/MAP annotations are not
             unwrapped ({"list": [{"element": v}]}), byte arrays stay bytes —
             matches what goparquet's NextRow returns.
  raw=False  ergonomic rows: LIST -> Python list, MAP -> dict, UTF8 -> str,
             matching pyarrow's to_pylist() for conformance testing.

convert_logical (storage -> Python value by logical type) and
convert_to_storage (its inverse, for the row writer) share logical_kind's
dispatch table with core/filter.py's value coercion.
"""

from __future__ import annotations

import numpy as np

from ..meta.parquet_types import ConvertedType, FieldRepetitionType, Type
from .arrays import ByteArrayData
from .chunk import ChunkData
from .schema import Column, Schema

__all__ = [
    "AssemblyError",
    "RecordAssembler",
    "convert_logical",
    "convert_to_storage",
    "logical_kind",
]


class AssemblyError(ValueError):
    pass


class _LeafCursor:
    __slots__ = (
        "chunk", "pos", "vpos", "max_def", "max_rep", "n", "nvals", "defs", "reps",
    )

    def __init__(self, chunk: ChunkData):
        self.chunk = chunk
        self.pos = 0  # index into level entries
        self.vpos = 0  # index into non-null values
        self.max_def = chunk.column.max_def
        self.max_rep = chunk.column.max_rep
        self.n = chunk.num_values
        try:
            self.nvals = len(chunk.values)
        except TypeError:
            self.nvals = chunk.num_values
        # pre-convert the level arrays ONCE per chunk: a per-entry
        # `int(levels[pos])` pays numpy scalar extraction + int() in the
        # walk's innermost loop; a plain-int list indexes at C speed
        # (~2-3x on the whole walk) and keeps the oracle usable in tests
        d = chunk.def_levels
        r = chunk.rep_levels
        self.defs = np.asarray(d).tolist() if d is not None else None
        self.reps = np.asarray(r).tolist() if r is not None else None

    def peek_def(self) -> int:
        d = self.defs
        return d[self.pos] if d is not None else self.max_def

    def peek_rep(self) -> int:
        r = self.reps
        return r[self.pos] if r is not None else 0

    def exhausted(self) -> bool:
        return self.pos >= self.n

    def advance_null(self) -> None:
        self.pos += 1

    def pop_value(self):
        i = self.vpos
        if i >= self.nvals:
            # fewer values than the def levels promise: typed, not IndexError
            raise AssemblyError(
                f"assembly: {self.chunk.column.path_str}: value stream "
                f"exhausted at {i} (levels promise more)"
            )
        self.vpos += 1
        self.pos += 1
        return self.chunk.values[i]


def _leaf_python_values(node: Column, chunk: ChunkData, raw: bool) -> list:
    """The chunk's non-null values as a Python list (C-speed tolist, string
    decode, logical conversion)."""
    v = chunk.values
    if isinstance(v, ByteArrayData):
        vals = v.to_list()
        if not raw and node.is_string():
            vals = [b.decode("utf-8", errors="replace") for b in vals]
    else:
        arr = np.asarray(v)
        if arr.ndim == 2:  # int96 / fixed rows -> bytes
            vals = [r.tobytes() for r in arr]
        else:
            vals = arr.tolist()
    if not raw and logical_kind(node) is not None:
        conv = convert_logical
        vals = [conv(node, x) for x in vals]
    return vals


def logical_kind(node: Column):
    """The single dispatch point for value-level logical conversions.

    Returns one of None | 'int96' | 'decimal' | 'date' | ('timestamp', unit,
    utc) | ('time', unit, utc). Both convert_logical and the flat fast path
    consult this, so a new conversion cannot silently diverge between the two
    paths.
    """
    ct = node.converted_type
    lt = node.logical_type
    if node.type == Type.INT96:
        return "int96"
    if lt is not None and lt.INTEGER is not None and not lt.INTEGER.isSigned:
        if node.type == Type.INT32:
            return ("uint", 32)
        if node.type == Type.INT64:
            return ("uint", 64)
    if ct in (ConvertedType.UINT_32, ConvertedType.UINT_64):
        return ("uint", 32 if node.type == Type.INT32 else 64)
    if ct == ConvertedType.DECIMAL or (lt is not None and lt.DECIMAL is not None):
        return "decimal"
    if ct == ConvertedType.DATE or (lt is not None and lt.DATE is not None):
        return "date"
    if lt is not None and lt.TIMESTAMP is not None:
        u = lt.TIMESTAMP.unit
        return ("timestamp", u.unit_name() if u is not None else "MICROS",
                bool(lt.TIMESTAMP.isAdjustedToUTC))
    if ct == ConvertedType.TIMESTAMP_MILLIS:
        return ("timestamp", "MILLIS", True)
    if ct == ConvertedType.TIMESTAMP_MICROS:
        return ("timestamp", "MICROS", True)
    if lt is not None and lt.TIME is not None:
        u = lt.TIME.unit
        return ("time", u.unit_name() if u is not None else "MICROS",
                bool(lt.TIME.isAdjustedToUTC))
    if ct == ConvertedType.TIME_MILLIS:
        return ("time", "MILLIS", True)
    if ct == ConvertedType.TIME_MICROS:
        return ("time", "MICROS", True)
    return None


class RecordAssembler:
    """Assembles rows from the leaf chunks of one row group.

    `engine` selects how iteration assembles:
      "auto"    (default) the vectorized engine (core/assembly_vec.py) when
                PQT_VEC_ASSEMBLY != 0 and the level scans can prove the
                shape; the scalar cursor walk otherwise
      "vec"     force the vectorized engine (raises AssemblyError when the
                scans cannot prove the shape)
      "scalar"  force the cursor walk — the differential-test oracle
    """

    def __init__(
        self,
        schema: Schema,
        chunks: dict[tuple, ChunkData],
        raw: bool = False,
        engine: str = "auto",
    ):
        self.schema = schema
        self.raw = raw
        self.engine = engine
        self.chunks = chunks
        # Cursor construction is LAZY: each _LeafCursor tolist()s the full
        # level arrays, which the default (vectorized) iteration path never
        # touches — only the scalar walk pays for its own state.
        self.cursors: dict[tuple, _LeafCursor] | None = None
        self._covered_cache: dict[tuple, bool] = {}
        self._first_leaf_cache: dict[tuple, _LeafCursor] = {}
        self.selected_roots: list[Column] | None = None

    def _ensure_cursors(self) -> None:
        """Build the per-leaf cursors and the static per-node caches (hot
        path: consulted per field per row) on first scalar use."""
        if self.cursors is not None:
            return
        self.cursors = {path: _LeafCursor(c) for path, c in self.chunks.items()}
        self._build_caches(self.schema.root)
        # Only assemble the subtree covered by the provided chunks (projection).
        self.selected_roots = [
            child for child in self.schema.root.children if self._covered(child)
        ]

    def _build_caches(self, node: Column) -> None:
        if node.is_leaf:
            covered = node.path in self.cursors
            if covered:
                self._first_leaf_cache[node.path] = self.cursors[node.path]
        else:
            covered = False
            for c in node.children:
                self._build_caches(c)
                if self._covered_cache[c.path] and not covered:
                    covered = True
                    self._first_leaf_cache[node.path] = self._first_leaf_cache[c.path]
        self._covered_cache[node.path] = covered

    def _covered(self, node: Column) -> bool:
        return self._covered_cache[node.path]

    def _first_leaf(self, node: Column) -> _LeafCursor:
        cur = self._first_leaf_cache.get(node.path)
        if cur is None:
            raise AssemblyError(f"assembly: no selected leaf under {node.path_str}")
        return cur

    def _advance_subtree_null(self, node: Column) -> None:
        if node.is_leaf:
            self.cursors[node.path].advance_null()
            return
        for c in node.children:
            if self._covered(c):
                self._advance_subtree_null(c)

    # -- row iteration ---------------------------------------------------------

    def __iter__(self):
        if self.engine != "scalar":
            from . import assembly_vec

            if self.engine == "vec" or assembly_vec.vec_enabled():
                rc = assembly_vec.assemble_row_columns(
                    self.schema, self.chunks, self.raw
                )
                if rc is not None:
                    # materialize in bounded windows (the scalar walk's
                    # constant-memory streaming contract: only one window
                    # of row dicts is forced live at a time — the column
                    # values themselves are already materialized either way)
                    names, columns, n = rc
                    if not names:
                        return
                    step = 1 << 16
                    for s in range(0, n, step):
                        e = min(s + step, n)
                        yield from assembly_vec._zip_dict_rows(
                            names,
                            [assembly_vec.slice_column(c, s, e) for c in columns],
                        )
                    return
                if self.engine == "vec":
                    raise AssemblyError(
                        "assembly: vectorized engine cannot prove this shape"
                    )
        yield from self._iter_scalar()

    def _iter_scalar(self):
        self._ensure_cursors()
        while True:
            lead = None
            for child in self.selected_roots:
                lead = self._first_leaf(child)
                break
            if lead is None or lead.exhausted():
                return
            yield self.assemble_row()

    def assemble_row(self) -> dict:
        self._ensure_cursors()
        row = {}
        for child in self.selected_roots:
            value = self._read_field(child)
            if value is not _ABSENT:
                row[child.name] = value
        return row

    # -- field assembly --------------------------------------------------------

    def _read_field(self, node: Column):
        """Read one instance of `node` (ancestors known present)."""
        rep = node.repetition
        if rep == FieldRepetitionType.REPEATED:
            return self._read_repeated(node)
        lead = self._first_leaf(node)
        if lead.exhausted():
            raise AssemblyError(f"assembly: leaf exhausted at {node.path_str}")
        d = lead.peek_def()
        if rep == FieldRepetitionType.OPTIONAL and d < node.max_def:
            self._advance_subtree_null(node)
            return None
        return self._read_present(node)

    def _read_present(self, node: Column):
        if node.is_leaf:
            cur = self.cursors[node.path]
            if cur.peek_def() != cur.max_def:
                # present at this node but null deeper — impossible for a leaf
                raise AssemblyError(
                    f"assembly: def level {cur.peek_def()} below leaf max "
                    f"{cur.max_def} at {node.path_str}"
                )
            return self._convert(node, cur.pop_value())
        if not self.raw:
            unwrapped = self._try_unwrap(node)
            if unwrapped is not _ABSENT:
                return unwrapped
        out = {}
        for child in node.children:
            if not self._covered(child):
                continue
            v = self._read_field(child)
            if v is not _ABSENT:
                out[child.name] = v
        return out

    def _read_repeated(self, node: Column):
        """A REPEATED node: zero or more instances -> list."""
        lead = self._first_leaf(node)
        if lead.exhausted():
            raise AssemblyError(f"assembly: leaf exhausted at {node.path_str}")
        d = lead.peek_def()
        if d < node.max_def:
            # zero elements (or null ancestor list wrapper)
            self._advance_subtree_null(node)
            return []
        items = [self._read_present(node)]
        while True:
            if lead.exhausted():
                break
            r = lead.peek_rep()
            if r != node.max_rep:
                break
            items.append(self._read_present(node))
        return items

    # -- ergonomic unwrapping --------------------------------------------------

    def _try_unwrap(self, node: Column):
        ct = node.converted_type
        lt = node.logical_type
        is_list = ct == ConvertedType.LIST or (lt is not None and lt.LIST is not None)
        is_map = ct in (ConvertedType.MAP, ConvertedType.MAP_KEY_VALUE) or (
            lt is not None and lt.MAP is not None
        )
        if is_list and len(node.children) == 1:
            mid = node.children[0]
            if mid.repetition == FieldRepetitionType.REPEATED and self._covered(mid):
                if mid.is_leaf or len(mid.children) != 1:
                    # 2-level legacy list: repeated element directly
                    return self._read_repeated_unwrapped(mid, unwrap_child=False)
                return self._read_repeated_unwrapped(mid, unwrap_child=True)
        if is_map and len(node.children) == 1:
            kv = node.children[0]
            if (
                kv.repetition == FieldRepetitionType.REPEATED
                and not kv.is_leaf
                and len(kv.children) == 2
                and self._covered(kv)
            ):
                pairs = self._read_repeated(kv)
                try:
                    return {p.get(kv.children[0].name): p.get(kv.children[1].name) for p in pairs}
                except TypeError:
                    # unhashable key (e.g. nested) — fall back to pair list
                    return pairs
        return _ABSENT

    def _read_repeated_unwrapped(self, mid: Column, unwrap_child: bool):
        """LIST middle group: return element values directly."""
        lead = self._first_leaf(mid)
        if lead.exhausted():
            raise AssemblyError("assembly: leaf exhausted in list")
        d = lead.peek_def()
        if d < mid.max_def:
            self._advance_subtree_null(mid)
            return []
        items = []
        while True:
            v = self._read_present(mid)
            if unwrap_child:
                elem = mid.children[0]
                v = v.get(elem.name) if isinstance(v, dict) else v
            items.append(v)
            if lead.exhausted() or lead.peek_rep() != mid.max_rep:
                break
        return items

    # -- value conversion ------------------------------------------------------

    def _convert(self, node: Column, v):
        if self.raw:
            if isinstance(v, np.generic):
                return v.item()
            if isinstance(v, np.ndarray):  # int96 / fixed rows
                return v.tobytes()
            return v
        return convert_logical(node, v)


_NANOTIME_CTOR = None


def _nanotime():
    """floor.Time.from_nanos, imported once (core cannot import floor at
    module load — floor imports core — and a per-value import would sit in
    the decode hot loop)."""
    global _NANOTIME_CTOR
    if _NANOTIME_CTOR is None:
        from ..floor.time import Time

        _NANOTIME_CTOR = Time.from_nanos
    return _NANOTIME_CTOR


def _to_micros(v: int, unit: str) -> int:
    if unit == "MILLIS":
        return v * 1000
    if unit == "NANOS":
        return v // 1000
    return v


_KIND_UNSET = object()


def convert_to_storage(node: Column, v, kind=_KIND_UNSET):
    """Ergonomic Python value -> storage value (the INVERSE of
    convert_logical, same logical_kind dispatch table): datetime ->
    epoch int at the declared unit (exact integer arithmetic — float
    total_seconds() drifts microseconds past ~270 years from epoch),
    date -> days, time -> unit int, Decimal -> unscaled int (or
    big-endian bytes for FLBA/BYTE_ARRAY storage, exact-scale and
    width-fit enforced as ValueError). Raw ints/floats/bytes pass
    through. `kind` takes a precomputed logical_kind(node) so per-chunk
    callers dispatch once. Closes the write_row side of the iter_rows
    round-trip."""
    import datetime as dt
    import decimal

    if kind is _KIND_UNSET:
        kind = logical_kind(node)
    if v is None or isinstance(v, (int, float, np.integer, np.floating)):
        if (
            isinstance(v, (int, np.integer))
            and kind is not None
            and kind[0] == "uint"
        ):
            bits = kind[1]
            u = int(v) & ((1 << bits) - 1)
            return u - (1 << bits) if u >= (1 << (bits - 1)) else u
        return v
    if kind == "decimal" and isinstance(v, decimal.Decimal):
        lt = node.logical_type
        scale = node.element.scale
        if scale is None and lt is not None and lt.DECIMAL is not None:
            scale = lt.DECIMAL.scale
        scale = scale or 0
        scaled = v.scaleb(scale)
        unscaled = int(scaled)
        if scaled != unscaled:
            raise ValueError(
                f"decimal {v} does not fit scale {scale} of "
                f"{node.path_str} exactly"
            )
        try:
            if node.type == Type.FIXED_LEN_BYTE_ARRAY:
                w = node.type_length or 0
                if w <= 0:
                    raise ValueError(
                        f"fixed column {node.path_str} lacks type_length"
                    )
                return unscaled.to_bytes(w, "big", signed=True)
            if node.type == Type.BYTE_ARRAY:
                n = max((unscaled.bit_length() + 8) // 8, 1)
                return unscaled.to_bytes(n, "big", signed=True)
        except OverflowError as e:
            raise ValueError(
                f"decimal {v} does not fit {node.type_length}-byte storage "
                f"of {node.path_str}"
            ) from e
        return unscaled
    if kind == "date" and isinstance(v, dt.date) and not isinstance(v, dt.datetime):
        return (v - dt.date(1970, 1, 1)).days
    if kind is not None and kind[0] == "timestamp":
        unit = kind[1]
        if isinstance(v, np.datetime64):
            ns = int(v.astype("datetime64[ns]").astype(np.int64))
            return ns // {"NANOS": 1, "MICROS": 1_000, "MILLIS": 1_000_000}[unit]
        if isinstance(v, dt.datetime):
            epoch = dt.datetime(
                1970, 1, 1, tzinfo=dt.timezone.utc if v.tzinfo else None
            )
            delta = v - epoch
            micros = (
                delta.days * 86_400_000_000
                + delta.seconds * 1_000_000
                + delta.microseconds
            )
            return {
                "MILLIS": micros // 1_000,
                "MICROS": micros,
                "NANOS": micros * 1_000,
            }[unit]
    if kind is not None and kind[0] == "time":
        nanos = None
        if isinstance(v, dt.time):
            nanos = (
                (v.hour * 3600 + v.minute * 60 + v.second) * 10**9
                + v.microsecond * 1_000
            )
        elif hasattr(v, "nanos"):  # floor.Time
            nanos = int(v.nanos)
        if nanos is not None:
            return nanos // {"NANOS": 1, "MICROS": 1_000, "MILLIS": 1_000_000}[
                kind[1]
            ]
    return v


def convert_logical(node: Column, v):
    """Storage value -> ergonomic Python value by logical type, matching
    pyarrow's to_pylist() conventions (DATE -> date, TIMESTAMP -> datetime,
    TIME -> time, DECIMAL -> Decimal, INT96 -> datetime, UTF8 -> str).
    Dispatch comes from logical_kind() — the shared table with the flat path."""
    import datetime as dt
    import decimal

    if isinstance(v, bytes) and node.is_string():
        return v.decode("utf-8", errors="replace")
    kind = logical_kind(node)
    if kind == "int96" and isinstance(v, (np.ndarray, bytes)):
        from ..utils.int96 import int96_to_datetime

        return int96_to_datetime(bytes(v))
    if isinstance(v, np.ndarray):
        v = v.tobytes()
    if isinstance(v, np.generic):
        v = v.item()
    if kind is None:
        return v
    if kind[0] == "uint":
        # UINT(32/64) logical annotation on a signed physical type: the bit
        # pattern reinterprets unsigned (pyarrow to_pylist parity)
        return int(v) & ((1 << kind[1]) - 1)
    if kind == "decimal":
        lt = node.logical_type
        scale = node.element.scale
        if scale is None and lt is not None and lt.DECIMAL is not None:
            scale = lt.DECIMAL.scale
        scale = scale or 0
        if isinstance(v, bytes):
            unscaled = int.from_bytes(v, "big", signed=True) if v else 0
        else:
            unscaled = int(v)
        return decimal.Decimal(unscaled).scaleb(-scale)
    if kind == "date":
        return dt.date(1970, 1, 1) + dt.timedelta(days=int(v))
    if kind[0] == "timestamp":
        _, unit, utc = kind
        if unit == "NANOS":
            # datetime caps at microseconds; numpy datetime64[ns] carries the
            # full precision (the reference's time.Time is nanosecond-native)
            return np.datetime64(int(v), "ns")
        tz = dt.timezone.utc if utc else None
        return dt.datetime(1970, 1, 1, tzinfo=tz) + dt.timedelta(
            microseconds=_to_micros(int(v), unit)
        )
    if kind[0] == "time":
        if kind[1] == "NANOS":
            # datetime.time cannot hold nanoseconds; the floor Time type
            # keeps them (reference: floor/time.go:10-13)
            return _nanotime()(int(v), utc=kind[2])
        micros = _to_micros(int(v), kind[1])
        return dt.time(
            hour=micros // 3_600_000_000,
            minute=(micros // 60_000_000) % 60,
            second=(micros // 1_000_000) % 60,
            microsecond=micros % 1_000_000,
        )
    return v


class _Absent:
    __slots__ = ()

    def __repr__(self):
        return "<absent>"


_ABSENT = _Absent()
