"""Deterministic fault-injection harness for the decode ladder.

Production ingest meets truncated objects, bit-rotted blocks and lying
metadata from foreign writers; this module turns a WELL-FORMED parquet byte
string into a seeded, reproducible stream of corrupted variants — truncations
at arbitrary offsets, bit flips in page payloads, scrambled page headers,
wrong stored CRCs, lying `num_values`/`uncompressed_size`, mangled level
runs — and checks one contract over each:

    a corrupt file may only ever surface as a typed Parquet error
    (ParquetFileError / ChunkError / PageError / ThriftError family) or as a
    byte-identical successful read — never a raw struct.error / zlib.error /
    IndexError / OverflowError, never a hang, never silently wrong data.

Everything is derived from an integer seed (numpy default_rng), so a failing
case replays exactly.

    from parquet_tpu_torch.testing.faults import iter_fault_cases, run_case
    for case in iter_fault_cases(pristine_bytes, seed=7):
        run_case(case)           # raises FaultViolation on a contract breach

The port's copy of parquet_tpu.testing.faults, over the port's reader: the
ladder rungs are the port's backends ("host", the staged host decode;
"device_roundtrip", the fused native prepare, the device decode and a
fetch), and `device` is the reader's (the pages are mapped on
the CPU: mapping decodes nothing).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

__all__ = [
    "FaultCase",
    "FaultViolation",
    "PageSite",
    "iter_fault_cases",
    "map_pages",
    "read_all",
    "run_case",
]


class FaultViolation(AssertionError):
    """A mutation broke the corruption contract: a raw (untyped) exception
    escaped, a must-fail case read "successfully", or a nominally-benign
    mutation silently changed the decoded data."""


@dataclass(frozen=True)
class PageSite:
    """One page's location inside the file, for surgical mutations."""

    group: int
    column: str
    page_index: int
    kind: int  # PageType value (0 data v1, 2 dict, 3 data v2)
    header_offset: int  # absolute byte offset of the Thrift page header
    header_len: int
    payload_offset: int  # absolute byte offset of the stored payload
    payload_len: int


@dataclass(frozen=True)
class FaultCase:
    """One corrupted variant of a pristine file.

    must_fail=True: every read of `data` MUST raise a typed Parquet error
    (the mutation provably breaks an invariant a reader checks). With
    must_fail=False the mutation may be benign (e.g. a flipped bit inside a
    skipped statistics field) — then the read must either raise typed or
    return data byte-identical to the pristine decode (check_data=True).
    check_data=False marks mutations that legitimately alter decoded values
    without ANY detectable trace: a flipped bit in an uncompressed PLAIN
    payload of a CRC-less file is indistinguishable from real data — no
    format on earth detects it, so the harness only asserts typed-or-ok
    there (the case FOR writing page checksums, see README)."""

    name: str
    data: bytes
    must_fail: bool
    validate_crc: bool
    description: str = ""
    check_data: bool = True


def map_pages(data: bytes) -> list[PageSite]:
    """Walk every chunk's pages and return their exact byte locations
    (well-formed input only; the walk itself is core.chunk.iter_page_sites,
    shared with parquet-tool verify so the two agree on page boundaries)."""
    from ..core.chunk import iter_page_sites
    from ..core.reader import FileReader

    sites: list[PageSite] = []
    with FileReader(io.BytesIO(data), device="cpu") as r:
        for gi in range(r.num_row_groups):
            for path, cc, _col in r._selected_chunks(gi):
                for page_index, (pos, header, hlen, plen) in enumerate(
                    iter_page_sites(r._f, cc)
                ):
                    sites.append(
                        PageSite(
                            group=gi,
                            column=".".join(path),
                            page_index=page_index,
                            kind=header.type or 0,
                            header_offset=pos,
                            header_len=hlen,
                            payload_offset=pos + hlen,
                            payload_len=plen,
                        )
                    )
    return sites


def _parse_header(data: bytes, site: PageSite):
    """The Python-parsed PageHeader at `site`, or None when our declarative
    reader cannot round-trip the writer's exact bytes (then length-preserving
    patches are impossible and patch-based cases are skipped)."""
    from ..meta.parquet_types import PageHeader
    from ..meta.thrift import CompactReader, ThriftError

    window = data[site.header_offset : site.header_offset + site.header_len]
    try:
        header = PageHeader.read(CompactReader(window))
    except ThriftError:
        return None
    if header.dumps() != bytes(window):
        return None  # foreign field order: cannot patch in place
    return header


def _patched(data: bytes, site: PageSite, mutate) -> bytes | None:
    """Re-serialize `site`'s header after `mutate(header)`; splice it back
    in place when (and only when) the byte length is preserved — page and
    footer offsets must not move, the lie is the point."""
    header = _parse_header(data, site)
    if header is None:
        return None
    mutate(header)
    blob = header.dumps()
    if len(blob) != site.header_len:
        return None
    return (
        data[: site.header_offset]
        + blob
        + data[site.header_offset + site.header_len :]
    )


def _first_data_site(sites: list[PageSite]) -> PageSite | None:
    for s in sites:
        if s.kind in (0, 3):
            return s
    return None


def iter_fault_cases(
    data: bytes,
    seed: int,
    truncations: int = 4,
    bit_flips: int = 4,
    header_flips: int = 3,
    validate_crc: bool = True,
):
    """Yield seeded FaultCases over a pristine file's bytes.

    `validate_crc` should be True when the file carries stored page CRCs
    (then payload bit flips are PROVABLY detectable and marked must_fail);
    pass False for CRC-less files — payload flips become may-be-benign
    cases checked for silent wrong data instead."""
    data = bytes(data)
    rng = np.random.default_rng(seed)
    sites = map_pages(data)
    data_sites = [s for s in sites if s.kind in (0, 3) and s.payload_len > 0]

    # -- truncation at arbitrary offsets (always fatal: the footer and the
    #    trailing magic live at the end of the file) ---------------------------
    n = len(data)
    cut_points = [n - 1, n - 4, max(n - 13, 1)]  # magic, footer-len, mid-footer
    cut_points += [int(x) for x in rng.integers(4, max(n - 1, 5), truncations)]
    for off in cut_points:
        yield FaultCase(
            name=f"truncate@{off}",
            data=data[:off],
            must_fail=True,
            validate_crc=validate_crc,
            description=f"file cut to {off}/{n} bytes",
        )

    # -- bit flips inside page payloads ---------------------------------------
    for k in range(bit_flips):
        if not data_sites:
            break
        s = data_sites[int(rng.integers(0, len(data_sites)))]
        off = s.payload_offset + int(rng.integers(0, s.payload_len))
        bit = int(rng.integers(0, 8))
        mutated = bytearray(data)
        mutated[off] ^= 1 << bit
        yield FaultCase(
            name=f"bitflip@{off}.{bit}",
            data=bytes(mutated),
            # a stored CRC covers the whole payload, so under validate_crc
            # the flip is provably detected; without CRCs it may be benign
            # or silent — run_case then checks data identity on success
            must_fail=validate_crc,
            validate_crc=validate_crc,
            description=(
                f"bit {bit} of byte {off} flipped in {s.column} rg{s.group} "
                f"page {s.page_index}"
            ),
            check_data=validate_crc,
        )

    # -- scrambled page headers (may parse to something harmless: skipped
    #    statistics bytes — so not must_fail; wrong data is still checked) -----
    for k in range(header_flips):
        if not sites:
            break
        s = sites[int(rng.integers(0, len(sites)))]
        off = s.header_offset + int(rng.integers(0, s.header_len))
        mutated = bytearray(data)
        mutated[off] ^= 0xFF
        yield FaultCase(
            name=f"hdrflip@{off}",
            data=bytes(mutated),
            must_fail=False,
            validate_crc=validate_crc,
            description=f"header byte {off} xor 0xff in {s.column} rg{s.group}",
        )

    # -- wrong stored CRC (length-preserving header patch) --------------------
    site = _first_data_site(sites)
    if site is not None and validate_crc:
        for delta in (1, 2, 16, 255):
            def bump_crc(h, delta=delta):
                if h.crc is None:
                    raise _Unpatchable
                v = (h.crc ^ delta) & 0xFFFFFFFF
                h.crc = v - (1 << 32) if v >= (1 << 31) else v

            patched = _try_patch(data, site, bump_crc)
            if patched is not None:
                yield FaultCase(
                    name=f"wrong_crc^{delta}",
                    data=patched,
                    must_fail=True,
                    validate_crc=True,
                    description=f"stored CRC xor {delta} on {site.column}",
                )
                break

    # -- lying num_values (the chunk-level count cross-check must trip) -------
    if site is not None:
        for delta in (1, -1, 7):
            def bump_nv(h, delta=delta):
                hh = h.data_page_header or h.data_page_header_v2
                if hh is None or hh.num_values is None or hh.num_values + delta < 0:
                    raise _Unpatchable
                hh.num_values += delta

            patched = _try_patch(data, site, bump_nv)
            if patched is not None:
                yield FaultCase(
                    name=f"lying_num_values{delta:+d}",
                    data=patched,
                    must_fail=True,
                    validate_crc=validate_crc,
                    description=f"num_values {delta:+d} on {site.column}",
                )
                break

    # -- lying uncompressed_size ----------------------------------------------
    if site is not None:
        for delta in (1, -1, 64):
            def bump_us(h, delta=delta):
                if h.uncompressed_page_size is None:
                    raise _Unpatchable
                v = h.uncompressed_page_size + delta
                if v < 0:
                    raise _Unpatchable
                h.uncompressed_page_size = v

            patched = _try_patch(data, site, bump_us)
            if patched is not None:
                yield FaultCase(
                    name=f"lying_uncompressed_size{delta:+d}",
                    data=patched,
                    # an uncompressed chunk's fused walk never consults the
                    # claimed size for V2 raw values, so the read may succeed
                    # with correct bytes; compressed chunks always trip the
                    # size cross-check — either way, typed-or-identical
                    must_fail=False,
                    validate_crc=validate_crc,
                    description=f"uncompressed_page_size {delta:+d} on {site.column}",
                )
                break

    # -- mangled level runs: stomp the first bytes of a data page payload
    #    (V1: the 4-byte level-stream length prefix + first run headers) ------
    if data_sites:
        s = data_sites[0]
        stomp = min(6, s.payload_len)
        mutated = bytearray(data)
        for j in range(stomp):
            mutated[s.payload_offset + j] = int(rng.integers(0, 256))
        yield FaultCase(
            name="bad_level_runs",
            data=bytes(mutated),
            must_fail=validate_crc,  # CRC provably catches the stomp
            validate_crc=validate_crc,
            description=f"first {stomp} payload bytes randomized on {s.column}",
            check_data=validate_crc,
        )

    # -- adversarial footer: giant thrift list length in the schema ----------
    # (preflight size guards must reject it without a multi-GB allocation)
    mutated = bytearray(data)
    # footer layout: [footer bytes][4B len LE][PAR1]; poison the first bytes
    # of the footer with a huge-list header (0xf9 = size-15 marker, list of
    # i64) followed by a maximal varint count
    footer_len = int.from_bytes(data[-8:-4], "little")
    fstart = n - 8 - footer_len
    if footer_len > 12:
        mutated[fstart : fstart + 7] = bytes([0x19, 0xF6]) + b"\xff\xff\xff\xff\x7f"
        yield FaultCase(
            name="footer_giant_list",
            data=bytes(mutated),
            must_fail=True,
            validate_crc=validate_crc,
            description="footer poisoned with an adversarial list length",
        )


class _Unpatchable(Exception):
    pass


def _try_patch(data: bytes, site: PageSite, mutate) -> bytes | None:
    try:
        return _patched(data, site, mutate)
    except _Unpatchable:
        return None


def read_all(data: bytes, validate_crc: bool, backend: str, device):
    """Full decode of every row group; returns {path: (num_values, digest)}
    summaries so successful reads can be compared for silent corruption."""
    import hashlib

    from ..core.arrays import ByteArrayData
    from ..core.reader import FileReader

    out = {}
    with FileReader(
        io.BytesIO(data), validate_crc=validate_crc, backend=backend,
        device=device,
    ) as r:
        for gi in range(r.num_row_groups):
            for path, cd in r.read_row_group(gi).items():
                v = cd.values
                h = hashlib.sha256()
                if isinstance(v, ByteArrayData):
                    h.update(np.ascontiguousarray(v.offsets).tobytes())
                    h.update(bytes(v.data))
                elif v is not None:
                    h.update(np.ascontiguousarray(np.asarray(v)).tobytes())
                for lv in (cd.def_levels, cd.rep_levels):
                    if lv is not None:
                        h.update(np.ascontiguousarray(np.asarray(lv)).tobytes())
                key = (gi, path)
                out[key] = (cd.num_values, h.hexdigest())
    return out


def run_case(
    case: FaultCase,
    pristine: dict | None = None,
    backend: str = "host",
    device="cpu",
) -> str:
    """Read a mutated file end-to-end and enforce the corruption contract.

    Returns "error" (a typed Parquet error was raised — the expected outcome
    for real corruption) or "ok" (the mutation was benign). Raises
    FaultViolation when a raw exception escapes, a must_fail case succeeds,
    or a successful read returns data differing from `pristine` (the
    pristine file's read_all summary — pass it to catch silent corruption).
    `backend` picks the decode ladder rung: "host" is the host decode,
    "device_roundtrip" drives the fused native prepare and the device
    decode on `device`."""
    from ..core.reader import PARQUET_ERRORS

    try:
        got = read_all(case.data, case.validate_crc, backend, device)
    except PARQUET_ERRORS:
        return "error"
    except Exception as e:  # noqa: BLE001 — the whole point of the harness
        raise FaultViolation(
            f"{case.name}: raw {type(e).__name__} escaped the decode ladder "
            f"({case.description}): {e!r}"
        ) from e
    if case.must_fail:
        raise FaultViolation(
            f"{case.name}: mutation must raise a typed Parquet error, but the "
            f"read succeeded ({case.description})"
        )
    if case.check_data and pristine is not None and got != pristine:
        raise FaultViolation(
            f"{case.name}: benign-looking mutation silently changed decoded "
            f"data ({case.description})"
        )
    return "ok"
