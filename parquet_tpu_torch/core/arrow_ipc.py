"""The Arrow IPC stream format without pyarrow.

The port's stand-in for pyarrow.ipc's stream half: `new_stream(sink,
schema)` writes, `open_stream(buf)` reads. Both speak the published
format: each message is the continuation token 0xFFFFFFFF, an int32
metadata length, a flatbuffer Message (metadata version V5, padded so the
body starts 8-byte aligned) and the body, whose buffers are each padded to
8 bytes; the stream is Schema, then per batch the DictionaryBatch messages
its dictionaries need and the RecordBatch, then the end-of-stream marker
0xFFFFFFFF 0x00000000. Flatbuffers are built and read here with `struct`
alone (_Builder, _Table).

The writer sends each buffer as pyarrow's stream writer does (the same
truncation of sliced arrays, zero-length validity where a column has no
null, the same body bytes), one RecordBatch a row range of the table's
chunks, a dictionary only where its values changed since the last one sent
under its id (a replacement, never a delta), and refuses a table whose
schema is not the stream's (SchemaMismatch). Its flatbuffers encode the
same metadata as pyarrow's, laid out by this builder.

The reader takes every type the writer emits (core/arrow_format.py's), the
32-bit-offset string, binary and list layouts, null, dictionary-encoded
fields with replacement and delta batches, offsets that do not start at 0,
the legacy framing without a continuation token, and bodies compressed
with ZSTD (the port's native codec) or LZ4_FRAME (a frame parser over the
native LZ4 block decoder). A big-endian stream, another type, or a stream
that is malformed in any way (truncated, a bad token, a buffer past its
body) raises ArrowInvalid, never a bare struct or index error.
"""

from __future__ import annotations

import struct

import numpy as np

from . import arrow_format as af
from .arrow_format import ArrowInvalid, Array, RecordBatch, Schema, Table

__all__ = [
    "ArrowInvalid",
    "SchemaMismatch",
    "StreamWriter",
    "StreamReader",
    "ChunkedStreamWriter",
    "new_stream",
    "open_stream",
    "serialize_table",
]

CONTINUATION = 0xFFFFFFFF
EOS = struct.pack("<II", CONTINUATION, 0)
_V5 = 4  # MetadataVersion.V5
_HDR_SCHEMA, _HDR_DICT, _HDR_BATCH = 1, 2, 3
_LZ4_FRAME, _ZSTD = 0, 1
# the most output one compressed byte can stand for: an LZ4 sequence's
# length bytes add at most 255 each; a 4-byte ZSTD RLE block spells a whole
# 128 KiB block. A declared length past ratio x payload is refused before
# any buffer is allocated for it.
_MAX_RATIO = {_LZ4_FRAME: 255, _ZSTD: 128 * 1024 // 4}

# the Type union's members
_T_NULL, _T_INT, _T_FLOAT, _T_BINARY, _T_UTF8, _T_BOOL, _T_DECIMAL = 1, 2, 3, 4, 5, 6, 7
_T_DATE, _T_TIME, _T_TIMESTAMP, _T_LIST, _T_STRUCT = 8, 9, 10, 12, 13
_T_FSB, _T_MAP, _T_LARGE_BINARY, _T_LARGE_UTF8, _T_LARGE_LIST = 15, 17, 19, 20, 21
_UNITS = ("s", "ms", "us", "ns")  # TimeUnit: SECOND .. NANOSECOND
_PRECISION = {16: 0, 32: 1, 64: 2}  # FloatingPoint.precision: HALF, SINGLE, DOUBLE


class SchemaMismatch(ArrowInvalid):
    """A table written to a stream whose schema is another."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _padded64(n: int) -> int:
    return (n + 63) & ~63


# -- flatbuffers: building --------------------------------------------------------


class _Builder:
    """A flatbuffer builder: the buffer grows from its end towards its
    start, as flatbuffers' own builders lay it out (children before the
    tables that point at them, vtables deduplicated)."""

    def __init__(self):
        self.buf = bytearray(256)
        self.head = len(self.buf)
        self.minalign = 1
        self.vtable = None
        self.object_end = 0
        self.vtables = {}

    def offset(self) -> int:
        return len(self.buf) - self.head

    def _grow(self, need: int) -> None:
        while self.head < need:
            old = len(self.buf)
            new = bytearray(old * 2)
            new[old:] = self.buf
            self.buf = new
            self.head += old

    def prep(self, size: int, additional: int) -> None:
        self.minalign = max(self.minalign, size)
        align = (-(self.offset() + additional)) % size
        self._grow(align + size + additional)
        self.head -= align
        self.buf[self.head : self.head + align] = bytes(align)

    def _place(self, fmt: str, x) -> None:
        n = struct.calcsize(fmt)
        self.head -= n
        struct.pack_into("<" + fmt, self.buf, self.head, x)

    def prepend(self, fmt: str, x) -> None:
        self.prep(struct.calcsize(fmt), 0)
        self._place(fmt, x)

    def prepend_uoffset(self, off: int) -> None:
        self.prep(4, 0)
        self._place("I", self.offset() - off + 4)

    def string(self, s: str) -> int:
        b = s.encode("utf-8")
        self.prep(4, len(b) + 1)
        self._place("B", 0)
        self.head -= len(b)
        self.buf[self.head : self.head + len(b)] = b
        self._place("I", len(b))
        return self.offset()

    def vector_offsets(self, offs: list) -> int:
        self.prep(4, 4 * len(offs))
        for o in reversed(offs):
            self.prepend_uoffset(o)
        self._place("I", len(offs))
        return self.offset()

    def vector_structs16(self, pairs: list) -> int:
        """A vector of 16-byte structs of two int64 (FieldNode, Buffer)."""
        self.prep(4, 16 * len(pairs))
        self.prep(8, 16 * len(pairs))
        for a, b in reversed(pairs):
            self.prep(8, 16)
            self._place("q", b)
            self._place("q", a)
        self._place("I", len(pairs))
        return self.offset()

    def start(self, n_fields: int) -> None:
        self.vtable = [0] * n_fields
        self.fields = []

    def add(self, slot: int, fmt: str, x, default=None) -> None:
        """A scalar field; one equal to its default is left out."""
        if x != default:
            self.fields.append((struct.calcsize(fmt), slot, fmt, x))

    def add_offset(self, slot: int, off) -> None:
        if off is not None:
            self.fields.append((4, slot, None, off))

    def end(self) -> int:
        """Write the table's fields (largest first, then from the last
        slot, the order flatc's generated builders add them) and its
        vtable."""
        self.object_end = self.offset()
        for _size, slot, fmt, x in sorted(self.fields, key=lambda f: (-f[0], -f[1])):
            if fmt is None:
                self.prepend_uoffset(x)
            else:
                self.prepend(fmt, x)
            self.vtable[slot] = self.offset()
        self.prepend("i", 0)
        obj = self.offset()
        fields = self.vtable
        while fields and fields[-1] == 0:
            fields = fields[:-1]
        entries = tuple(obj - f if f else 0 for f in fields)
        key = (obj - self.object_end, entries)
        vt = self.vtables.get(key)
        if vt is None:
            for e in reversed(entries):
                self.prepend("H", e)
            self.prepend("H", obj - self.object_end)
            self.prepend("H", 4 + 2 * len(entries))
            vt = self.offset()
            self.vtables[key] = vt
        struct.pack_into("<i", self.buf, len(self.buf) - obj, vt - obj)
        self.vtable = None
        return obj

    def finish(self, root: int) -> bytes:
        self.prep(self.minalign, 4)
        self.prepend_uoffset(root)
        return bytes(self.buf[self.head :])


def _int_table(b: _Builder, bits: int, signed: bool) -> int:
    b.start(2)
    b.add(0, "i", bits, 0)
    b.add(1, "B", int(signed), 0)
    return b.end()


def _type_table(b: _Builder, t) -> tuple:
    """(the Type union's member, the offset of its table)."""
    k = t.kind
    if k == "int":
        return _T_INT, _int_table(b, t.bit_width, t.signed)
    if k == "float":
        b.start(1)
        b.add(0, "h", _PRECISION[t.bit_width], 0)
        return _T_FLOAT, b.end()
    if k == "decimal128":
        b.start(3)
        b.add(0, "i", t.precision, 0)
        b.add(1, "i", t.scale, 0)
        b.add(2, "i", 128, 128)
        return _T_DECIMAL, b.end()
    if k == "date32":
        b.start(1)
        b.add(0, "h", 0, 1)  # DateUnit.DAY; MILLISECOND is the default
        return _T_DATE, b.end()
    if k in ("time32", "time64"):
        b.start(2)
        b.add(0, "h", _UNITS.index(t.unit), 1)
        b.add(1, "i", 32 if k == "time32" else 64, 32)
        return _T_TIME, b.end()
    if k == "timestamp":
        tz = None if t.tz is None else b.string(t.tz)
        b.start(2)
        b.add(0, "h", _UNITS.index(t.unit), 0)
        b.add_offset(1, tz)
        return _T_TIMESTAMP, b.end()
    if k == "fixed_size_binary":
        b.start(1)
        b.add(0, "i", t.byte_width, 0)
        return _T_FSB, b.end()
    if k == "map":
        b.start(1)
        b.add(0, "B", int(t.keys_sorted), 0)
        return _T_MAP, b.end()
    simple = {"null": _T_NULL, "bool": _T_BOOL, "binary": _T_BINARY,
              "string": _T_UTF8, "large_binary": _T_LARGE_BINARY,
              "large_string": _T_LARGE_UTF8, "list": _T_LIST,
              "large_list": _T_LARGE_LIST, "struct": _T_STRUCT}
    if k not in simple:
        raise ArrowInvalid(f"arrow-ipc: no IPC type for {t}")
    b.start(0)
    return simple[k], b.end()


def _children_of(t) -> list:
    if t.kind == "struct":
        return list(t.fields)
    if t.kind in ("list", "large_list", "map"):
        return [t.value_field]
    return []


def _field_table(b: _Builder, f, dict_ids: dict) -> int:
    """One Field table, its parts built in the order Arrow's C++ writer
    builds them: the children, the type, the dictionary encoding, the
    name, the children vector."""
    t = f.type.value_type if f.type.kind == "dictionary" else f.type
    children = [_field_table(b, c, dict_ids) for c in _children_of(t)]
    member, type_off = _type_table(b, t)
    dict_off = None
    if f.type.kind == "dictionary":
        it = f.type.index_type
        index = _int_table(b, it.bit_width, it.signed)
        b.start(4)
        b.add(0, "q", dict_ids[id(f)], 0)
        b.add_offset(1, index)
        b.add(2, "B", int(f.type.ordered), 0)
        dict_off = b.end()
    name = b.string(f.name)
    kids = b.vector_offsets(children)
    b.start(7)
    b.add_offset(0, name)
    b.add(1, "B", int(f.nullable), 0)
    b.add(2, "B", member, 0)
    b.add_offset(3, type_off)
    b.add_offset(4, dict_off)
    b.add_offset(5, kids)
    return b.end()


def _message(b: _Builder, header_type: int, header: int, body_len: int) -> bytes:
    b.start(5)
    b.add(0, "h", _V5, 0)
    b.add(1, "B", header_type, 0)
    b.add_offset(2, header)
    b.add(3, "q", body_len, 0)
    return b.finish(b.end())


def _dictionary_ids(sch: Schema) -> tuple:
    """{id(field): dictionary id} in depth-first order (pyarrow's
    DictionaryFieldMapper), and the (id, field) list."""
    ids, order = {}, []

    def walk(f):
        if f.type.kind == "dictionary":
            ids[id(f)] = len(order)
            order.append(f)
            inner = f.type.value_type
        else:
            inner = f.type
        for c in _children_of(inner):
            walk(c)

    for f in sch.fields:
        walk(f)
    return ids, order


def _schema_message(sch: Schema, dict_ids: dict) -> bytes:
    b = _Builder()
    fields = [_field_table(b, f, dict_ids) for f in sch.fields]
    vec = b.vector_offsets(fields)
    b.start(4)
    b.add_offset(1, vec)
    return _message(b, _HDR_SCHEMA, b.end(), 0)


def _batch_table(b: _Builder, length: int, nodes: list, spans: list) -> int:
    nds = b.vector_structs16(nodes)
    bufs = b.vector_structs16(spans)
    b.start(5)
    b.add(0, "q", length, 0)
    b.add_offset(1, nds)
    b.add_offset(2, bufs)
    return b.end()


def _frame(metadata: bytes, body: list) -> list:
    pad = _pad8(len(metadata) + 8) - 8 - len(metadata)
    return [struct.pack("<Ii", CONTINUATION, len(metadata) + pad),
            metadata, bytes(pad)] + body


# -- the record batch body (pyarrow's RecordBatchSerializer) ---------------------------


def _bitmap(buf, offset: int, length: int):
    """A validity or bool buffer as pyarrow sends it: whole when it starts
    at bit 0 and is no longer than its 64-byte padded need, else the bits
    of the window copied to a buffer of their own."""
    if buf is None:
        return None
    need = (length + 7) >> 3
    if offset != 0 or _padded64(need) < len(buf):
        bits = af._bits(buf, offset, length)
        return np.packbits(bits, bitorder="little")
    return buf


def _offsets_zero_based(a: Array, dt):
    w = np.dtype(dt).itemsize
    raw = a._buffers[1]
    if raw is None:
        return None, 0, 0
    need = w * (a.length + 1)
    window = raw[a.offset * w : a.offset * w + need].view(dt)
    first = int(window[0]) if len(window) else 0
    last = int(window[a.length]) if len(window) > a.length else first
    if a.length == 0:
        return raw, first, first  # pyarrow sends an empty array's offsets whole
    if a.offset != 0 or first != 0:
        out = (window.astype(np.int64) - first).astype(dt)
        return out.view(np.uint8), first, last
    if len(raw) > need:
        return raw[:need], first, last
    return raw, first, last


def _visit(a: Array, nodes: list, bufs: list) -> None:
    t = a.type
    k = t.kind
    nodes.append((a.length, a.null_count))
    if k == "null":
        return
    bufs.append(_bitmap(a._buffers[0], a.offset, a.length) if a.null_count else None)
    if k == "bool":
        bufs.append(_bitmap(a._buffers[1], a.offset, a.length))
        return
    w = af.byte_width(t)
    if w:
        data = a._buffers[1]
        if data is not None and (a.offset != 0 or _padded64(a.length * w) < len(data)):
            lo = a.offset * w
            data = data[lo : lo + min(_pad8(a.length * w), len(data) - lo)]
        bufs.append(data)
        return
    if k in af._VAR or k in af._LIST_OFFSETS:
        dt = af._VAR.get(k) or af._LIST_OFFSETS[k]
        offs, first, last = _offsets_zero_based(a, dt)
        bufs.append(offs)
        if k in af._VAR:
            data = a._buffers[2]
            total = last - first if a.length else 0
            if data is not None and (a.offset != 0 or total < len(data)):
                data = data[first : first + min(_padded64(total), len(data) - first)]
            bufs.append(data)
            return
        child = a.children[0]
        n = last - first
        if a.offset != 0 or n < len(child):
            child = child.slice(first, n)
        _visit(child, nodes, bufs)
        return
    if k == "struct":
        for i in range(len(a.children)):
            _visit(a.field(i), nodes, bufs)
        return
    raise ArrowInvalid(f"arrow-ipc: cannot write {t}")


def _batch_message(length: int, columns: list, dict_id=None) -> list:
    nodes, bufs = [], []
    for c in columns:
        _visit(c, nodes, bufs)
    spans, body, pos = [], [], 0
    for buf in bufs:
        size = 0 if buf is None else len(buf)
        spans.append((pos, size))
        if size:
            body.append(buf.tobytes() if isinstance(buf, np.ndarray) else bytes(buf))
            pad = _pad8(size) - size
            if pad:
                body.append(bytes(pad))
        pos += _pad8(size)
    b = _Builder()
    rb = _batch_table(b, length, nodes, spans)
    if dict_id is None:
        meta = _message(b, _HDR_BATCH, rb, pos)
    else:
        b.start(3)
        b.add(0, "q", dict_id, 0)
        b.add_offset(1, rb)
        meta = _message(b, _HDR_DICT, b.end(), pos)
    return _frame(meta, body)


class StreamWriter:
    """pyarrow.ipc.new_stream's writer over any object with write()."""

    def __init__(self, sink, schema: Schema):
        self._sink = sink
        self.schema = schema
        self._ids, self._dict_fields = _dictionary_ids(schema)
        self._last = {}
        self._started = False
        self._closed = False

    def _emit(self, parts: list) -> None:
        for p in parts:
            if len(p):
                self._sink.write(p)

    def _start(self) -> None:
        if not self._started:
            self._started = True
            self._emit(_frame(_schema_message(self.schema, self._ids), []))

    def _dictionaries(self, columns: list) -> list:
        """The dictionaries a batch's columns carry, by id."""
        found = {}

        def walk(a: Array, f):
            t = f.type
            if t.kind == "dictionary":
                found[self._ids[id(f)]] = a.dictionary
                t = t.value_type
            if t.kind == "struct":
                for i, cf in enumerate(t.fields):
                    walk(a.field(i), cf)
            elif t.kind in ("list", "large_list", "map") and a.children:
                walk(a.children[0], t.value_field)

        for a, f in zip(columns, self.schema.fields):
            walk(a, f)
        return sorted(found.items())

    def write_batch(self, batch: RecordBatch) -> None:
        if self._closed:
            raise ArrowInvalid("arrow-ipc: write to a closed stream")
        if batch.schema != self.schema:
            raise SchemaMismatch(
                "Tried to write record batch with different schema"
            )
        self._start()
        for did, d in self._dictionaries(batch.columns):
            last = self._last.get(did)
            if last is not None and (last is d or (
                len(last) == len(d) and last.equals(d)
            )):
                continue
            self._last[did] = d
            self._emit(_batch_message(len(d), [d], dict_id=did))
        self._emit(_batch_message(batch.num_rows, batch.columns))

    def write_table(self, table: Table) -> None:
        if table.schema != self.schema:
            raise SchemaMismatch(
                f"Table schema does not match schema used to create file: \n"
                f"table:\n{table.schema} vs. \nfile:\n{self.schema}"
            )
        for batch in table.to_batches():
            self.write_batch(batch)

    def write(self, obj) -> None:
        if isinstance(obj, Table):
            self.write_table(obj)
        else:
            self.write_batch(obj)

    def close(self) -> None:
        if self._closed:
            return
        self._start()
        self._sink.write(EOS)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def new_stream(sink, schema: Schema) -> StreamWriter:
    return StreamWriter(sink, schema)


class ChunkedStreamWriter:
    """One stream writer whose bytes are handed out as they are framed:
    each call returns the bytes it added, so an HTTP answer can send them
    as chunks. The first schema opens the stream. The daemon's arrow-ipc
    scans and the router's re-framing of them write through this."""

    def __init__(self):
        self._parts: list[bytes] = []
        self._writer = None

    def write(self, data) -> int:  # the inner writer's sink
        b = bytes(data)
        self._parts.append(b)
        return len(b)

    def _take(self) -> bytes:
        out = b"".join(self._parts)
        self._parts.clear()
        return out

    @property
    def opened(self) -> bool:
        return self._writer is not None

    def open(self, schema: Schema) -> bytes:
        """Opens the stream on `schema` unless it is open: the Schema
        message's bytes, else b""."""
        if self._writer is None:
            self._writer = new_stream(self, schema)
        return self._take()

    def write_table(self, table: Table) -> bytes:
        """SchemaMismatch where `table`'s schema is not the stream's."""
        head = self.open(table.schema)
        self._writer.write_table(table)
        return head + self._take()

    def write_batch(self, batch: RecordBatch) -> bytes:
        head = self.open(batch.schema)
        self._writer.write_batch(batch)
        return head + self._take()

    def close(self) -> bytes:
        """The end of the stream (with the Schema message if nothing was
        written after `open`)."""
        self._writer.close()
        return self._take()


def serialize_table(table: Table) -> bytes:
    """One whole stream (schema, batches, end) of a table, as bytes."""
    out = ChunkedStreamWriter()
    return out.write_table(table) + out.close()


# -- flatbuffers: reading ---------------------------------------------------------------


class _Table:
    """One flatbuffer table: its fields read through its vtable, every
    access bounds-checked (a bad offset raises ArrowInvalid)."""

    __slots__ = ("buf", "pos", "vt", "vt_len")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        vt = pos - _unpack("<i", buf, pos)
        self.vt = vt
        self.vt_len = _unpack("<H", buf, vt)
        if self.vt_len < 4 or self.vt_len & 1:
            raise ArrowInvalid("arrow-ipc: malformed flatbuffer vtable")

    def _field(self, slot: int) -> int:
        o = 4 + 2 * slot
        if o + 2 > self.vt_len:
            return 0
        return _unpack("<H", self.buf, self.vt + o)

    def scalar(self, slot: int, fmt: str, default=0):
        o = self._field(slot)
        return default if not o else _unpack("<" + fmt, self.buf, self.pos + o)

    def _target(self, slot: int):
        o = self._field(slot)
        if not o:
            return None
        at = self.pos + o
        return at + _unpack("<I", self.buf, at)

    def table(self, slot: int):
        p = self._target(slot)
        return None if p is None else _Table(self.buf, p)

    def string(self, slot: int):
        p = self._target(slot)
        if p is None:
            return None
        n = _unpack("<I", self.buf, p)
        raw = _span(self.buf, p + 4, n)
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ArrowInvalid(f"arrow-ipc: field name is not UTF-8: {e}") from None

    def tables(self, slot: int) -> list:
        p = self._target(slot)
        if p is None:
            return []
        n = _unpack("<I", self.buf, p)
        _span(self.buf, p + 4, 4 * n)
        out = []
        for i in range(n):
            at = p + 4 + 4 * i
            out.append(_Table(self.buf, at + _unpack("<I", self.buf, at)))
        return out

    def structs16(self, slot: int) -> list:
        p = self._target(slot)
        if p is None:
            return []
        n = _unpack("<I", self.buf, p)
        raw = _span(self.buf, p + 4, 16 * n)
        return [struct.unpack_from("<qq", raw, 16 * i) for i in range(n)]


def _unpack(fmt: str, buf, pos: int):
    if pos < 0 or pos + struct.calcsize(fmt) > len(buf):
        raise ArrowInvalid("arrow-ipc: flatbuffer offset out of bounds")
    return struct.unpack_from(fmt, buf, pos)[0]


def _span(buf, pos: int, n: int) -> bytes:
    if pos < 0 or n < 0 or pos + n > len(buf):
        raise ArrowInvalid("arrow-ipc: flatbuffer vector out of bounds")
    return bytes(buf[pos : pos + n])


def _root(meta: bytes) -> _Table:
    return _Table(meta, _unpack("<I", meta, 0))


_MAX_DEPTH = 64  # nesting a schema may have (a deeper one is malformed here)


def _read_type(ft: _Table, depth: int):
    member = ft.scalar(2, "B")
    tt = ft.table(3)
    children = [_read_field(c, depth + 1) for c in ft.tables(5)]

    def need_table():
        if tt is None:
            raise ArrowInvalid("arrow-ipc: a field's type table is missing")
        return tt

    if member == _T_NULL:
        return af.null()
    if member == _T_INT:
        t = need_table()
        bits, signed = t.scalar(0, "i"), bool(t.scalar(1, "B"))
        if bits not in (8, 16, 32, 64):
            raise ArrowInvalid(f"arrow-ipc: integer of {bits} bits")
        return af._int(bits, signed)
    if member == _T_FLOAT:
        prec = need_table().scalar(0, "h")
        if prec not in (0, 1, 2):
            raise ArrowInvalid(f"arrow-ipc: floating-point precision {prec}")
        return af.DataType("float", bit_width=(16, 32, 64)[prec])
    if member == _T_BOOL:
        return af.bool_()
    if member in (_T_BINARY, _T_UTF8, _T_LARGE_BINARY, _T_LARGE_UTF8):
        return af.DataType({_T_BINARY: "binary", _T_UTF8: "string",
                            _T_LARGE_BINARY: "large_binary",
                            _T_LARGE_UTF8: "large_string"}[member])
    if member == _T_DECIMAL:
        t = need_table()
        if t.scalar(2, "i", 128) != 128:
            raise ArrowInvalid("arrow-ipc: only decimal128 is read")
        return af.decimal128(t.scalar(0, "i"), t.scalar(1, "i"))
    if member == _T_DATE:
        if need_table().scalar(0, "h", 1) != 0:
            raise ArrowInvalid("arrow-ipc: date64 is not read")
        return af.date32()
    if member == _T_TIME:
        t = need_table()
        unit, bits = t.scalar(0, "h", 1), t.scalar(1, "i", 32)
        if unit not in range(4) or (bits, _UNITS[unit]) not in (
            (32, "s"), (32, "ms"), (64, "us"), (64, "ns")
        ):
            raise ArrowInvalid(f"arrow-ipc: time of {bits} bits in unit {unit}")
        return (af.time32 if bits == 32 else af.time64)(_UNITS[unit])
    if member == _T_TIMESTAMP:
        t = need_table()
        unit = t.scalar(0, "h")
        if unit not in range(4):
            raise ArrowInvalid(f"arrow-ipc: timestamp unit {unit}")
        return af.timestamp(_UNITS[unit], t.string(1))
    if member == _T_FSB:
        w = need_table().scalar(0, "i")
        if w < 0:
            raise ArrowInvalid("arrow-ipc: negative fixed-size binary width")
        return af.binary(w)
    if member in (_T_LIST, _T_LARGE_LIST):
        if len(children) != 1:
            raise ArrowInvalid("arrow-ipc: a list needs one child field")
        return af.DataType("list" if member == _T_LIST else "large_list",
                           value_field=children[0])
    if member == _T_STRUCT:
        return af.DataType("struct", fields=tuple(children))
    if member == _T_MAP:
        if (len(children) != 1 or children[0].type.kind != "struct"
                or len(children[0].type.fields) != 2):
            raise ArrowInvalid("arrow-ipc: a map needs one struct child of two fields")
        return af.DataType("map", value_field=children[0],
                           keys_sorted=bool(need_table().scalar(0, "B")))
    raise ArrowInvalid(f"arrow-ipc: type {member} of the Type union is not read")


def _read_field(ft: _Table, depth: int = 0):
    if depth > _MAX_DEPTH:
        raise ArrowInvalid(f"arrow-ipc: a schema nested past {_MAX_DEPTH} levels")
    name = ft.string(0) or ""
    nullable = bool(ft.scalar(1, "B"))
    t = _read_type(ft, depth)
    enc = ft.table(4)
    f = af.Field(name, t, nullable)
    if enc is not None:
        it = enc.table(1)
        index = af.int32() if it is None else af._int(it.scalar(0, "i"), bool(it.scalar(1, "B")))
        if index.bit_width not in (8, 16, 32, 64):
            raise ArrowInvalid("arrow-ipc: bad dictionary index width")
        f = _DictField(name, af.dictionary(index, t, bool(enc.scalar(2, "B"))),
                       nullable, enc.scalar(0, "q"))
    return f


class _DictField(af.Field):
    """A dictionary-encoded field as read, with its dictionary id."""

    __slots__ = ("dict_id",)

    def __init__(self, name, type, nullable, dict_id):
        super().__init__(name, type, nullable)
        self.dict_id = dict_id


# -- the body --------------------------------------------------------------------------------


def _lz4_frame(data: bytes, expect: int) -> bytes:
    """One LZ4 frame (the format's magic, descriptor, blocks, end mark),
    its blocks through the native raw block decoder; linked blocks decode
    into one output so a match may reach back into earlier blocks."""
    from ..utils.native import get_native

    if len(data) < 7 or struct.unpack_from("<I", data, 0)[0] != 0x184D2204:
        raise ArrowInvalid("arrow-ipc: LZ4 frame magic missing")
    flg, _bd = data[4], data[5]
    if flg >> 6 != 1:
        raise ArrowInvalid("arrow-ipc: unsupported LZ4 frame version")
    block_sum, content_size, content_sum, dict_id = (
        flg & 0x10, flg & 0x08, flg & 0x04, flg & 0x01
    )
    pos = 6 + (8 if content_size else 0) + (4 if dict_id else 0) + 1
    if dict_id:
        raise ArrowInvalid("arrow-ipc: LZ4 frames with a dictionary are not read")
    out = np.empty(max(expect, 1), dtype=np.uint8)
    n = 0
    lib = get_native()
    while True:
        if pos + 4 > len(data):
            raise ArrowInvalid("arrow-ipc: truncated LZ4 frame")
        size = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        if size == 0:
            break
        raw, size = size & 0x80000000, size & 0x7FFFFFFF
        if pos + size > len(data):
            raise ArrowInvalid("arrow-ipc: truncated LZ4 block")
        if raw:
            if n + size > expect:
                raise ArrowInvalid("arrow-ipc: LZ4 frame larger than its buffer")
            out[n : n + size] = np.frombuffer(data, np.uint8, size, pos)
            n += size
        else:
            got = lib.lz4_decompress_into(data[pos : pos + size], out, n, expect)
            if got < 0:
                raise ArrowInvalid("arrow-ipc: corrupt LZ4 block")
            n = got
        pos += size + (4 if block_sum else 0)
    if content_sum and pos + 4 > len(data):
        raise ArrowInvalid("arrow-ipc: truncated LZ4 frame checksum")
    if n != expect:
        raise ArrowInvalid(f"arrow-ipc: LZ4 frame holds {n} bytes, expected {expect}")
    return out[:n].tobytes()


def _decompress(codec: int, raw: bytes) -> np.ndarray:
    if len(raw) < 8:
        raise ArrowInvalid("arrow-ipc: compressed buffer shorter than its length prefix")
    n = struct.unpack_from("<q", raw, 0)[0]
    payload = raw[8:]
    if n == -1:
        return np.frombuffer(payload, dtype=np.uint8)
    if n < 0:
        raise ArrowInvalid("arrow-ipc: negative uncompressed length")
    if n > _MAX_RATIO[codec] * len(payload):
        raise ArrowInvalid(f"arrow-ipc: a compressed buffer of {len(payload)} bytes declares "
                           f"{n} bytes, more than its codec can expand to")
    payload = bytes(payload)
    if codec == _LZ4_FRAME:
        out = _lz4_frame(payload, n)
    else:
        from .compress import CompressionError, decompress_block
        from ..meta.parquet_types import CompressionCodec

        try:
            out = bytes(decompress_block(payload, CompressionCodec.ZSTD, n))
        except CompressionError as e:
            raise ArrowInvalid(f"arrow-ipc: ZSTD buffer: {e}") from None
        if len(out) != n:
            raise ArrowInvalid("arrow-ipc: ZSTD buffer decompressed to another size")
    return np.frombuffer(out, dtype=np.uint8)


class _Body:
    """A message body's buffers and field nodes, consumed in order."""

    def __init__(self, body: bytes, nodes: list, spans: list, codec):
        self.body = body
        self.nodes = nodes
        self.spans = spans
        self.codec = codec
        self.ni = 0
        self.bi = 0

    def node(self):
        if self.ni >= len(self.nodes):
            raise ArrowInvalid("arrow-ipc: fewer field nodes than the schema needs")
        length, nulls = self.nodes[self.ni]
        self.ni += 1
        if length < 0 or nulls < 0 or nulls > length:
            raise ArrowInvalid("arrow-ipc: bad field node")
        return length, nulls

    def buffer(self):
        if self.bi >= len(self.spans):
            raise ArrowInvalid("arrow-ipc: fewer buffers than the schema needs")
        off, size = self.spans[self.bi]
        self.bi += 1
        if off < 0 or size < 0 or off + size > len(self.body):
            raise ArrowInvalid("arrow-ipc: a buffer lies past the message body")
        if size == 0:
            return None
        raw = self.body[off : off + size]
        if self.codec is not None:
            return _decompress(self.codec, raw)
        return np.frombuffer(raw, dtype=np.uint8)


def _need(buf, nbytes: int, what: str):
    have = 0 if buf is None else len(buf)
    if have < nbytes:
        raise ArrowInvalid(f"arrow-ipc: {what} buffer holds {have} bytes, needs {nbytes}")
    return buf if buf is not None else np.zeros(0, np.uint8)


def _read_array(f, body: _Body, dicts: dict) -> Array:
    t = f.type
    length, nulls = body.node()
    k = t.kind
    if k == "null":
        return Array(t, length, [None])
    validity = body.buffer()
    if nulls:
        _need(validity, (length + 7) >> 3, "validity")
    else:
        validity = None
    if k == "dictionary":
        idx = _need(body.buffer(), length * af.byte_width(t.index_type), "index")
        d = dicts.get(f.dict_id)
        if d is None:
            raise ArrowInvalid(f"arrow-ipc: no dictionary with id {f.dict_id}")
        a = Array(t, length, [validity, idx], nulls, 0, (), d)
        live = a.values_np() if not nulls else a.values_np()[a.is_valid_np()]
        if len(live) and (int(live.min()) < 0 or int(live.max()) >= len(d)):
            raise ArrowInvalid("arrow-ipc: dictionary index out of range")
        return a
    if k == "bool":
        data = _need(body.buffer(), (length + 7) >> 3, "bool")
        return Array(t, length, [validity, data], nulls)
    w = af.byte_width(t)
    if w:
        data = _need(body.buffer(), length * w, "value")
        return Array(t, length, [validity, data], nulls)
    if k in af._VAR or k in af._LIST_OFFSETS:
        dt = af._VAR.get(k) or af._LIST_OFFSETS[k]
        raw = body.buffer()
        if raw is None and length == 0:
            raw = np.zeros(np.dtype(dt).itemsize, np.uint8)
        raw = _need(raw, (length + 1) * np.dtype(dt).itemsize, "offsets")
        offs = raw[: (length + 1) * np.dtype(dt).itemsize].view(dt)
        if len(offs) > 1 and (np.diff(offs.astype(np.int64)) < 0).any() or (
            len(offs) and offs[0] < 0
        ):
            raise ArrowInvalid("arrow-ipc: offsets are not ascending")
        end = int(offs[-1]) if len(offs) else 0
        if k in af._VAR:
            data = _need(body.buffer(), end, "data")
            return Array(t, length, [validity, raw, data], nulls)
        child = _read_array(t.value_field, body, dicts)
        if len(child) < end:
            raise ArrowInvalid("arrow-ipc: list offsets past the child's length")
        return Array(t, length, [validity, raw], nulls, 0, [child])
    if k == "struct":
        children = [_read_array(cf, body, dicts) for cf in t.fields]
        for c in children:
            if len(c) < length:
                raise ArrowInvalid("arrow-ipc: struct child shorter than the struct")
        return Array(t, length, [validity], nulls, 0, children)
    raise ArrowInvalid(f"arrow-ipc: cannot read {t}")


class _Message:
    __slots__ = ("header_type", "header", "body")

    def __init__(self, header_type, header, body):
        self.header_type = header_type
        self.header = header
        self.body = body


def _messages(buf):
    """(header type, header table, body) of each message up to the end
    of the stream; both framings. `buf` is bytes or a memoryview; each
    body is a view of it, not a copy."""
    pos = 0
    n = len(buf)
    while True:
        if pos == n:
            return  # a stream may end without its end marker
        if pos + 4 > n:
            raise ArrowInvalid("arrow-ipc: truncated message length")
        word = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        if word == CONTINUATION:
            if pos + 4 > n:
                raise ArrowInvalid("arrow-ipc: truncated message length")
            size = struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        else:
            size = struct.unpack_from("<i", buf, pos - 4)[0]  # legacy framing
        if size == 0:
            return
        if size < 0 or pos + size > n:
            raise ArrowInvalid("arrow-ipc: message metadata past the end of the stream")
        meta = bytes(buf[pos : pos + size])
        pos += size
        msg = _root(meta)
        version = msg.scalar(0, "h")
        if version < 3:
            raise ArrowInvalid(f"arrow-ipc: metadata version {version} is too old")
        body_len = msg.scalar(3, "q")
        if body_len < 0 or pos + body_len > n:
            raise ArrowInvalid("arrow-ipc: message body past the end of the stream")
        body = buf[pos : pos + body_len]
        pos += body_len
        header = msg.table(2)
        if header is None:
            raise ArrowInvalid("arrow-ipc: message without a header")
        yield _Message(msg.scalar(1, "B"), header, body)


def _read_schema(header: _Table) -> Schema:
    if header.scalar(0, "h") != 0:
        raise ArrowInvalid("arrow-ipc: big-endian streams are not read")
    return Schema([_read_field(f) for f in header.tables(1)])


def _dict_fields(sch: Schema) -> dict:
    out = {}

    def walk(f):
        t = f.type
        if t.kind == "dictionary":
            out[f.dict_id] = f
            t = t.value_type
        for c in _children_of(t):
            walk(c)

    for f in sch.fields:
        walk(f)
    return out


def _batch_body(rb: _Table, body: bytes) -> _Body:
    comp = rb.table(3)
    codec = None
    if comp is not None:
        codec = comp.scalar(0, "b")
        if codec not in (_LZ4_FRAME, _ZSTD) or comp.scalar(1, "b") != 0:
            raise ArrowInvalid(f"arrow-ipc: body compression {codec} is not read")
    return _Body(body, rb.structs16(1), rb.structs16(2), codec)


class StreamReader:
    """pyarrow.ipc.open_stream's reader: `schema`, iteration over the
    record batches, read_all()."""

    def __init__(self, source):
        if hasattr(source, "read"):
            source = source.read()
        self._it = _messages(memoryview(source).cast("B"))
        first = next(self._it, None)
        if first is None:
            raise ArrowInvalid("arrow-ipc: empty stream, expected a Schema message")
        if first.header_type != _HDR_SCHEMA:
            raise ArrowInvalid("arrow-ipc: the stream does not start with a Schema")
        self.schema = _read_schema(first.header)
        self._dict_fields = _dict_fields(self.schema)
        self._dicts = {}

    def _dictionary(self, msg: _Message) -> None:
        did = msg.header.scalar(0, "q")
        f = self._dict_fields.get(did)
        if f is None:
            raise ArrowInvalid(f"arrow-ipc: dictionary batch for unknown id {did}")
        rb = msg.header.table(1)
        if rb is None:
            raise ArrowInvalid("arrow-ipc: dictionary batch without data")
        vf = af.Field("dictionary", f.type.value_type)
        body = _batch_body(rb, msg.body)
        values = _read_array(vf, body, self._dicts)
        if len(values) != rb.scalar(0, "q"):
            raise ArrowInvalid("arrow-ipc: dictionary length differs from its batch")
        if msg.header.scalar(2, "B") and did in self._dicts:
            values = af.concat_arrays([self._dicts[did], values])
        self._dicts[did] = values

    def read_next_batch(self) -> RecordBatch:
        for msg in self._it:
            if msg.header_type == _HDR_DICT:
                self._dictionary(msg)
                continue
            if msg.header_type != _HDR_BATCH:
                raise ArrowInvalid(f"arrow-ipc: unexpected message type {msg.header_type}")
            rb = msg.header
            length = rb.scalar(0, "q")
            body = _batch_body(rb, msg.body)
            cols = [_read_array(f, body, self._dicts) for f in self.schema.fields]
            for c in cols:
                if len(c) != length:
                    raise ArrowInvalid("arrow-ipc: a column's length differs from its batch")
            return RecordBatch(self.schema, cols, length)
        raise StopIteration

    def __iter__(self):
        while True:
            try:
                yield self.read_next_batch()
            except StopIteration:
                return

    def read_all(self) -> Table:
        return Table.from_batches(list(self), self.schema)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def open_stream(source) -> StreamReader:
    return StreamReader(source)
