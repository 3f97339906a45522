"""Thrift compact-protocol reader/writer, hand-rolled for the Parquet metadata model.

The reference uses ~12.5k lines of generated Thrift Go (reference: parquet/parquet.go,
regenerated by parquet/generate.sh). We instead drive a generic compact-protocol
(de)serializer from declarative per-struct field tables (see parquet_types.py) — ~100x
less code, and the decoder works on memoryviews with no intermediate allocation, since
page headers sit on the hot metadata path (reference: chunk_reader.go:191-194, SURVEY §7.3).

Only the compact protocol is implemented: Parquet footers and page headers are always
compact-encoded (TCompactProtocol), per the parquet-format spec.
"""

from __future__ import annotations

import struct as _struct

# Compact-protocol wire types.
CT_STOP = 0x00
CT_BOOLEAN_TRUE = 0x01
CT_BOOLEAN_FALSE = 0x02
CT_BYTE = 0x03
CT_I16 = 0x04
CT_I32 = 0x05
CT_I64 = 0x06
CT_DOUBLE = 0x07
CT_BINARY = 0x08
CT_LIST = 0x09
CT_SET = 0x0A
CT_MAP = 0x0B
CT_STRUCT = 0x0C

# Logical field types used in field tables (map 1:1 onto wire types, except BOOL).
T_BOOL = "bool"
T_BYTE = "byte"
T_I16 = "i16"
T_I32 = "i32"
T_I64 = "i64"
T_DOUBLE = "double"
T_BINARY = "binary"  # bytes
T_STRING = "string"  # utf-8 str
T_LIST = "list"
T_STRUCT = "struct"

_DOUBLE_LE = _struct.Struct("<d")


class ThriftError(ValueError):
    pass


class CompactReader:
    """Cursor over a bytes/memoryview buffer decoding compact-protocol values.

    `pos` tracks consumption so callers (e.g. the page-header walker) know how many
    bytes the header occupied without a counting wrapper (reference: helpers.go:39-64
    solves the same problem with an offsetReader).
    """

    __slots__ = ("buf", "pos", "end", "depth")

    # Max struct/list nesting: parquet metadata is ~6 levels deep; 64 bounds
    # adversarial footers (e.g. b"\x1c"*N) without recursing past Python's limit.
    MAX_DEPTH = 64

    def __init__(self, buf, pos: int = 0, end: int | None = None):
        if isinstance(buf, (bytes, bytearray)):
            buf = memoryview(buf)
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end
        self.depth = 0

    def _enter(self) -> None:
        self.depth += 1
        if self.depth > self.MAX_DEPTH:
            raise ThriftError("thrift: structure nested too deeply")

    # -- primitives ------------------------------------------------------------

    def read_byte(self) -> int:
        p = self.pos
        if p >= self.end:
            raise ThriftError("thrift: unexpected end of buffer")
        self.pos = p + 1
        return self.buf[p]

    def read_uvarint(self) -> int:
        result = 0
        shift = 0
        buf = self.buf
        p = self.pos
        end = self.end
        while True:
            if p >= end:
                raise ThriftError("thrift: truncated varint")
            b = buf[p]
            p += 1
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 63:
                raise ThriftError("thrift: varint too long")
        self.pos = p
        return result

    def read_zigzag(self) -> int:
        n = self.read_uvarint()
        return (n >> 1) ^ -(n & 1)

    def read_binary(self) -> bytes:
        n = self.read_uvarint()
        if n < 0 or self.pos + n > self.end:
            raise ThriftError(f"thrift: binary length {n} exceeds buffer")
        out = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return out

    def read_double(self) -> float:
        if self.pos + 8 > self.end:
            raise ThriftError("thrift: truncated double")
        (v,) = _DOUBLE_LE.unpack_from(self.buf, self.pos)
        self.pos += 8
        return v

    # -- skipping unknown fields ----------------------------------------------

    def skip(self, ctype: int) -> None:
        if ctype in (CT_BOOLEAN_TRUE, CT_BOOLEAN_FALSE):
            return
        if ctype == CT_BYTE:
            self.read_byte()
        elif ctype in (CT_I16, CT_I32, CT_I64):
            self.read_uvarint()
        elif ctype == CT_DOUBLE:
            self.pos += 8
        elif ctype == CT_BINARY:
            n = self.read_uvarint()
            self.pos += n
            if self.pos > self.end:
                raise ThriftError("thrift: truncated binary during skip")
        elif ctype in (CT_LIST, CT_SET):
            self._enter()
            size, elem = self.read_list_header()
            if elem in (CT_BOOLEAN_TRUE, CT_BOOLEAN_FALSE):
                # bool LIST elements occupy one byte each (unlike bool
                # struct fields, whose value lives in the field header)
                self.pos += size
                if self.pos > self.end:
                    raise ThriftError("thrift: truncated bool list during skip")
            else:
                for _ in range(size):
                    self.skip(elem)
            self.depth -= 1
        elif ctype == CT_MAP:
            self._enter()
            size = self.read_uvarint()
            if size:
                # Preflight: every kv pair occupies >= 2 wire bytes, and a
                # bool key/value skips as one byte below — an adversarial
                # count must be rejected against the remaining buffer BEFORE
                # the loop, or a lying footer spins for up to 2^63 iterations.
                if size > self.end - self.pos:
                    raise ThriftError(
                        f"thrift: map size {size} exceeds remaining buffer"
                    )
                kv = self.read_byte()
                kt, vt = kv >> 4, kv & 0x0F
                for _ in range(size):
                    # map bool keys/values occupy one byte each on the wire
                    # (unlike bool STRUCT fields, whose value rides the
                    # field header and skips as zero bytes)
                    if kt in (CT_BOOLEAN_TRUE, CT_BOOLEAN_FALSE):
                        self.read_byte()
                    else:
                        self.skip(kt)
                    if vt in (CT_BOOLEAN_TRUE, CT_BOOLEAN_FALSE):
                        self.read_byte()
                    else:
                        self.skip(vt)
            self.depth -= 1
        elif ctype == CT_STRUCT:
            self._enter()
            last_fid = 0
            while True:
                fh = self.read_byte()
                if fh == CT_STOP:
                    self.depth -= 1
                    return
                delta = fh >> 4
                ft = fh & 0x0F
                if delta:
                    last_fid += delta
                else:
                    last_fid = self.read_zigzag()
                self.skip(ft)
        else:
            raise ThriftError(f"thrift: cannot skip unknown type {ctype}")

    def read_list_header(self) -> tuple[int, int]:
        b = self.read_byte()
        size = b >> 4
        elem = b & 0x0F
        if size == 15:
            size = self.read_uvarint()
        if size < 0:
            raise ThriftError("thrift: negative list size")
        # Preflight size guard (validation-before-allocation): every element
        # occupies >= 1 wire byte, so a length claim beyond the remaining
        # buffer is corrupt — reject it here, before any caller sizes an
        # allocation or enters a decode loop on it.
        if size > self.end - self.pos:
            raise ThriftError(
                f"thrift: list size {size} exceeds remaining buffer"
            )
        return size, elem


class CompactWriter:
    __slots__ = ("out",)

    def __init__(self):
        self.out = bytearray()

    def write_byte(self, v: int) -> None:
        self.out.append(v & 0xFF)

    def write_uvarint(self, v: int) -> None:
        out = self.out
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                return

    def write_zigzag(self, v: int) -> None:
        # Arbitrary-precision-safe zigzag: correct for the full int64 range.
        self.write_uvarint((v << 1) ^ (v >> 63))

    def write_binary(self, v: bytes) -> None:
        self.write_uvarint(len(v))
        self.out += v

    def write_double(self, v: float) -> None:
        self.out += _DOUBLE_LE.pack(v)

    def getvalue(self) -> bytes:
        return bytes(self.out)


# -- declarative struct model --------------------------------------------------

_WIRE_OF = {
    T_BYTE: CT_BYTE,
    T_I16: CT_I16,
    T_I32: CT_I32,
    T_I64: CT_I64,
    T_DOUBLE: CT_DOUBLE,
    T_BINARY: CT_BINARY,
    T_STRING: CT_BINARY,
    T_LIST: CT_LIST,
    T_STRUCT: CT_STRUCT,
}


class TStruct:
    """Base for declarative Thrift structs.

    Subclasses define FIELDS: dict[fid] = (attr_name, ftype, spec) where spec is:
      - for T_LIST: (elem_ftype, elem_spec)
      - for T_STRUCT: the struct subclass
      - otherwise None.
    Unknown fields on the wire are skipped (forward compat); absent attrs are None.
    """

    FIELDS: dict = {}
    __slots__ = ()

    def __init__(self, **kw):
        for name, _ft, _spec in self.FIELDS.values():
            setattr(self, name, kw.pop(name, None))
        if kw:
            raise TypeError(f"{type(self).__name__}: unknown fields {sorted(kw)}")

    def __repr__(self):
        parts = []
        for name, _ft, _spec in self.FIELDS.values():
            v = getattr(self, name)
            if v is not None:
                parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return all(
            getattr(self, name) == getattr(other, name)
            for name, _ft, _spec in self.FIELDS.values()
        )

    # Mutable value object: explicitly unhashable.
    __hash__ = None

    # -- decode ----------------------------------------------------------------

    @classmethod
    def read(cls, r: CompactReader):
        self = cls()
        fields = cls.FIELDS
        r._enter()
        last_fid = 0
        while True:
            fh = r.read_byte()
            if fh == CT_STOP:
                r.depth -= 1
                return self
            delta = fh >> 4
            wire = fh & 0x0F
            if delta:
                last_fid += delta
            else:
                last_fid = r.read_zigzag()
            spec = fields.get(last_fid)
            if spec is None or not _wire_matches(wire, spec[1]):
                # Unknown id, or known id with mismatched wire type: skip by the
                # wire type (the only safe way to stay in sync), like generated
                # Thrift readers do.
                r.skip(wire)
                continue
            name, ft, extra = spec
            setattr(self, name, _read_value(r, wire, ft, extra))


    # -- encode ----------------------------------------------------------------

    def write(self, w: CompactWriter) -> None:
        last_fid = 0
        for fid in sorted(self.FIELDS):
            name, ft, extra = self.FIELDS[fid]
            v = getattr(self, name)
            if v is None:
                continue
            if ft == T_BOOL:
                wire = CT_BOOLEAN_TRUE if v else CT_BOOLEAN_FALSE
            else:
                wire = _WIRE_OF[ft]
            delta = fid - last_fid
            if 0 < delta <= 15:
                w.write_byte((delta << 4) | wire)
            else:
                w.write_byte(wire)
                w.write_zigzag(fid)
            last_fid = fid
            if ft != T_BOOL:
                _write_value(w, ft, extra, v)
        w.write_byte(CT_STOP)

    def dumps(self) -> bytes:
        w = CompactWriter()
        self.write(w)
        return w.getvalue()

    @classmethod
    def loads(cls, buf) -> "TStruct":
        return cls.read(CompactReader(buf))


def _wire_matches(wire: int, ft: str) -> bool:
    if ft == T_BOOL:
        return wire in (CT_BOOLEAN_TRUE, CT_BOOLEAN_FALSE)
    if ft == T_LIST:
        return wire in (CT_LIST, CT_SET)
    return wire == _WIRE_OF[ft]


def _read_value(r: CompactReader, wire: int, ft: str, extra):
    if ft == T_BOOL:
        if wire == CT_BOOLEAN_TRUE:
            return True
        if wire == CT_BOOLEAN_FALSE:
            return False
        # bool inside a list is encoded as a full byte
        return r.read_byte() == CT_BOOLEAN_TRUE
    if ft in (T_I16, T_I32, T_I64):
        return r.read_zigzag()
    if ft == T_BYTE:
        b = r.read_byte()
        return b - 256 if b >= 128 else b
    if ft == T_DOUBLE:
        return r.read_double()
    if ft == T_BINARY:
        return r.read_binary()
    if ft == T_STRING:
        return r.read_binary().decode("utf-8", errors="replace")
    if ft == T_LIST:
        size, elem_wire = r.read_list_header()
        elem_ft, elem_spec = extra
        if elem_ft == T_BOOL:
            # compact protocol: bool LIST elements are one byte each
            # (01 true / 02 false), unlike bool struct fields where the
            # value lives in the field header
            return [r.read_byte() == CT_BOOLEAN_TRUE for _ in range(size)]
        return [_read_value(r, elem_wire, elem_ft, elem_spec) for _ in range(size)]
    if ft == T_STRUCT:
        return extra.read(r)
    raise ThriftError(f"thrift: unhandled field type {ft}")


def _write_value(w: CompactWriter, ft: str, extra, v) -> None:
    if ft in (T_I16, T_I32, T_I64):
        w.write_zigzag(v)
    elif ft == T_BYTE:
        # Compact protocol BYTE is one raw byte, not a varint.
        w.write_byte(v)
    elif ft == T_DOUBLE:
        w.write_double(v)
    elif ft == T_BINARY:
        w.write_binary(bytes(v))
    elif ft == T_STRING:
        w.write_binary(v.encode("utf-8"))
    elif ft == T_LIST:
        elem_ft, elem_spec = extra
        # canonical element type for bool lists is BOOLEAN_TRUE (0x01) —
        # generated thrift readers type-check it (elements are still 1 byte)
        elem_wire = CT_BOOLEAN_TRUE if elem_ft == T_BOOL else _WIRE_OF[elem_ft]
        n = len(v)
        if n < 15:
            w.write_byte((n << 4) | elem_wire)
        else:
            w.write_byte(0xF0 | elem_wire)
            w.write_uvarint(n)
        if elem_ft == T_BOOL:
            for item in v:
                w.write_byte(CT_BOOLEAN_TRUE if item else CT_BOOLEAN_FALSE)
        else:
            for item in v:
                _write_value(w, elem_ft, elem_spec, item)
    elif ft == T_STRUCT:
        v.write(w)
    else:
        raise ThriftError(f"thrift: unhandled field type {ft}")
