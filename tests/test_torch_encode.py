"""The write path's device programs: the port's plain versions against JAX.

The same seeded NumPy inputs go through the JAX package's encode programs
(parquet_tpu/kernels/device_ops.py: bitpack_encode_device,
rle_hybrid_encode_device, dict_indices_device, delta_block_encode_device,
plain_bytearray_encode_device, on CPU jax) and through the port's wrappers
on CPU tensors, which run the kernels' plain versions. Every comparison is
exact (tolerance 0). Where the JAX program pads to a bucket, the port's
exact outputs are held against the real prefix of the padded tables, and
the framed streams (assemble_hybrid_device_stream,
assemble_delta_device_stream, the PLAIN framing) against the host encoders
of both packages. The CUDA kernels themselves run only on the card
(chip_smoke.py holds them against these plain versions).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops as J  # noqa: E402  (turns x64 on first)
from parquet_tpu.core.arrays import ByteArrayData as JByteArrayData  # noqa: E402
from parquet_tpu.kernels.pipeline import _bucket, _pad_device  # noqa: E402
from parquet_tpu.ops.delta import encode_delta as j_encode_delta  # noqa: E402
from parquet_tpu.ops.plain import encode_plain as j_encode_plain  # noqa: E402
from parquet_tpu.ops.rle_hybrid import encode_hybrid as j_encode_hybrid  # noqa: E402

from parquet_tpu_torch.core.arrays import ByteArrayData  # noqa: E402
from parquet_tpu_torch.kernels import device_ops as P  # noqa: E402
from parquet_tpu_torch.kernels.pipeline import (  # noqa: E402
    assemble_delta_device_stream,
    assemble_hybrid_device_stream,
    host_byte_array,
    hybrid_segments,
)
from parquet_tpu_torch.meta.parquet_types import Type  # noqa: E402
from parquet_tpu_torch.ops.delta import encode_delta  # noqa: E402
from parquet_tpu_torch.ops.plain import encode_plain  # noqa: E402
from parquet_tpu_torch.ops.rle_hybrid import encode_hybrid  # noqa: E402
from parquet_tpu_torch.testing.synth import (  # noqa: E402
    bitpack_edge_cases,
    bytearray_frame_edge_cases,
    delta_encode_edge_cases,
    dict_indices_edge_cases,
    frame_args,
    rle_plan_edge_cases,
)

jnp = pytest.importorskip("jax").numpy

EDGE_N = (0, 1, 7, 8, 9, 127, 128, 129, 1000)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _u32(values: np.ndarray, width: int) -> np.ndarray:
    return (np.asarray(values, dtype=np.uint64) & np.uint64((1 << width) - 1)).astype(np.uint32)


# -- bitpack_encode ------------------------------------------------------------


@pytest.mark.parametrize("width", range(33))
def test_bitpack_encode_matches_jax(width):
    rng = np.random.default_rng(width)
    for n in EDGE_N:
        v = _u32(rng.integers(0, 1 << 32, n, dtype=np.uint64), width)
        want = np.asarray(J.bitpack_encode_device(jnp.asarray(v), width)).view(np.int32)
        got = P.bitpack_encode(_t(v.view(np.int32)), width).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")


BITPACK_EDGE = bitpack_edge_cases(P.BITPACK_TILE, seed=15)


@pytest.mark.parametrize("label,values,width", BITPACK_EDGE, ids=[c[0] for c in BITPACK_EDGE])
def test_bitpack_edge_cases_match_jax(label, values, width):
    """Sizes around the pack's tile at widths 0-32, the values unmasked
    (2**width - 1, 2**width and random over 32 bits): the port masks them,
    and equals the JAX program on the masked values bit for bit."""
    want = np.asarray(J.bitpack_encode_device(jnp.asarray(_u32(values, width)), width))
    got = P.bitpack_encode(_t(values.view(np.int32)), width).numpy()
    np.testing.assert_array_equal(got, want.view(np.int32))


def test_bitpack_tile_pinned_to_the_kernel():
    """BITPACK_TILE, around which the edge cases put their sizes, is the
    kernel's tile (kTile = 4 * kThreads of bitpack_encode.cu), and the
    shared word assembly is a header both packing kernels include."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "bitpack_encode.cu").read_text()
    k = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert "constexpr int kTile = 4 * kThreads;" in src and 4 * k["kThreads"] == P.BITPACK_TILE
    for name in ("bitpack_encode.cu", "rle_hybrid_encode.cu"):
        assert '#include "bitpack.cuh"' in (build.CSRC / name).read_text()


def test_bitpack_encode_refuses_bad_widths():
    v = torch.zeros(8, dtype=torch.int32)
    for width in (-1, 33):
        with pytest.raises(ValueError, match="width"):
            P.bitpack_encode(v, width)
    with pytest.raises(TypeError, match="dtype"):
        P.bitpack_encode(torch.zeros(8, dtype=torch.int64), 3)


# -- rle_hybrid_encode -----------------------------------------------------------


def _hybrid_cases():
    rng = np.random.default_rng(11)
    patterns = {
        "straddling": [3, 13, 8, 8, 9, 20, 1, 16, 7, 9, 15, 17],
        "adjacent": [16, 16, 8, 24, 8, 8],
        "one_run": [1000],
        "short_runs": [7] * 40,
    }
    for label, lens in patterns.items():
        yield label, np.repeat((np.arange(len(lens)) * 3) % 8, lens).astype(np.uint32), 3
    for n in EDGE_N + (15, 16, 17):
        yield f"random{n}", rng.integers(0, 8, n).astype(np.uint32), 3
        m = n // 5 + 1
        runs = np.repeat(rng.integers(0, 4, m), rng.integers(1, 30, m))[:n]
        yield f"runs{n}", runs.astype(np.uint32), 2
    for width in (1, 8, 17, 32):
        v = np.repeat(rng.integers(0, 1 << 32, 60, dtype=np.uint64), rng.integers(1, 25, 60))
        yield f"wide{width}", _u32(v, width), width


HYBRID_CASES = list(_hybrid_cases())


@pytest.mark.parametrize("label,values,width", HYBRID_CASES, ids=[c[0] for c in HYBRID_CASES])
def test_rle_hybrid_encode_matches_jax(label, values, width):
    j_in, j_brk, j_packed, j_nbp = J.rle_hybrid_encode_device(jnp.asarray(values), width)
    in_rle, rle_break, packed, n_bp = P.rle_hybrid_encode(_t(values.view(np.int32)), width)
    np.testing.assert_array_equal(in_rle.numpy(), np.asarray(j_in))
    np.testing.assert_array_equal(rle_break.numpy(), np.asarray(j_brk))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_packed).view(np.int32))
    assert n_bp.dtype == torch.int32 and int(n_bp) == int(j_nbp)


@pytest.mark.parametrize("label,values,width", HYBRID_CASES, ids=[c[0] for c in HYBRID_CASES])
def test_rle_hybrid_stream_equals_encode_hybrid(label, values, width):
    t = _t(values.view(np.int32))
    in_rle, rle_break, packed, _ = P.rle_hybrid_encode(t, width)
    in_rle, rle_break = in_rle.numpy(), rle_break.numpy()
    starts = hybrid_segments(in_rle, rle_break)
    rle_values = values[starts[in_rle[starts]]]
    got = assemble_hybrid_device_stream(in_rle, starts, packed.numpy(), width, rle_values)
    assert got == encode_hybrid(values, width) == j_encode_hybrid(values, width)


@pytest.mark.parametrize("label,values,width", HYBRID_CASES, ids=[c[0] for c in HYBRID_CASES])
def test_rle_hybrid_stream_from_the_packed_prefix(label, values, width):
    """The writer downloads only the words that hold the bit-packed groups:
    ceil(ceil(n_bp / 8) * width / 4) of them frame the same stream."""
    in_rle, rle_break, packed, n_bp = P.rle_hybrid_encode(_t(values.view(np.int32)), width)
    in_rle = in_rle.numpy()
    assert int(n_bp) == len(in_rle) - int(in_rle.sum())
    starts = hybrid_segments(in_rle, rle_break.numpy())
    prefix = packed.numpy()[: ((int(n_bp) + 7) // 8 * width + 3) // 4]
    got = assemble_hybrid_device_stream(in_rle, starts, prefix, width,
                                        values[starts[in_rle[starts]]])
    assert got == encode_hybrid(values, width)


@pytest.mark.parametrize("n,width", [(9, 32), (17, 12), (1025, 31), (4097, 17)])
def test_rle_hybrid_stream_pads_the_last_group(n, width):
    """Every value bit-packed and n not a multiple of 8: the last group's
    zero padding runs past the packed words (ceil(n * width / 32) + 1 of
    them), and the framed stream still equals encode_hybrid's. The JAX
    package's assembly cuts such a stream short (ROADMAP §3)."""
    values = np.arange(n, dtype=np.uint32) & np.uint32((1 << width) - 1)
    in_rle, rle_break, packed, n_bp = P.rle_hybrid_encode(_t(values.view(np.int32)), width)
    assert int(n_bp) == n and (n + 7) // 8 * width > 4 * packed.numel()
    in_rle = in_rle.numpy()
    starts = hybrid_segments(in_rle, rle_break.numpy())
    got = assemble_hybrid_device_stream(in_rle, starts, packed.numpy(), width, ())
    assert got == encode_hybrid(values, width) == j_encode_hybrid(values, width)


RLE_EDGE = rle_plan_edge_cases(P.RLE_PLAN_TILE, seed=31)


@pytest.mark.parametrize("label,values,width", RLE_EDGE, ids=[c[0] for c in RLE_EDGE])
def test_rle_plan_edge_cases_match_jax(label, values, width):
    """The run plan's edge cases (sizes around its tile, a run over whole
    tiles, a run ending at a tile's edge, windows straddling and meeting
    at a tile's edge, alternating and all-equal values): the plain version
    equals the JAX program bit for bit, and the framed stream equals
    encode_hybrid's."""
    j_in, j_brk, j_packed, j_nbp = J.rle_hybrid_encode_device(jnp.asarray(values), width)
    in_rle, rle_break, packed, n_bp = P.rle_hybrid_encode(_t(values.view(np.int32)), width)
    np.testing.assert_array_equal(in_rle.numpy(), np.asarray(j_in))
    np.testing.assert_array_equal(rle_break.numpy(), np.asarray(j_brk))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_packed).view(np.int32))
    assert n_bp.dtype == torch.int32 and int(n_bp) == int(j_nbp)
    in_rle, rle_break = in_rle.numpy(), rle_break.numpy()
    starts = hybrid_segments(in_rle, rle_break)
    got = assemble_hybrid_device_stream(in_rle, starts, packed.numpy(), width,
                                        values[starts[in_rle[starts]]])
    assert got == encode_hybrid(values, width)


def test_rle_plan_edge_cases_cover_the_tile():
    """Windows that straddle a tile's edge and that meet at one, and a run
    over more than one whole tile, are among the edge cases."""
    t = P.RLE_PLAN_TILE
    straddle = meet = whole = False
    for _, values, width in RLE_EDGE:
        in_rle, rle_break, _, _ = P.rle_hybrid_encode(_t(values.view(np.int32)), width)
        in_rle, rle_break = in_rle.numpy(), rle_break.numpy()
        for edge in range(t, len(values), t):
            straddle |= bool(in_rle[edge - 1] and in_rle[edge] and not rle_break[edge])
            meet |= bool(in_rle[edge - 1] and rle_break[edge])
        change = np.flatnonzero(np.diff(values.astype(np.int64))) + 1
        bounds = np.concatenate([[0], change, [len(values)]])
        whole |= bool((np.diff(bounds) > 2 * t).any())
    assert straddle and meet and whole


def test_rle_plan_tile_pinned_to_the_kernel():
    """RLE_PLAN_TILE, around which the edge cases put their sizes and the
    wrapper sizes its tile records, is the kernel's tile (kThreads *
    kItems of rle_hybrid_encode.cu), and RLE_PLAN_GROUP, by which it sizes
    the group records, the kernel's kGroup (kThreads tiles)."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "rle_hybrid_encode.cu").read_text()
    k = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert k["kThreads"] * k["kItems"] == P.RLE_PLAN_TILE
    assert "constexpr int kGroup = kThreads;" in src and k["kThreads"] == P.RLE_PLAN_GROUP


# -- dict_indices ------------------------------------------------------------------


def _dict_cases():
    rng = np.random.default_rng(5)
    for n in EDGE_N:
        for dt in (np.int32, np.int64):
            yield f"small{n}_{np.dtype(dt)}", rng.integers(-3, 40, n).astype(dt)
    for dt in (np.int32, np.int64):
        info = np.iinfo(dt)
        keys = np.array([-1, info.min, 0, info.max, 1, -2], dtype=dt)
        yield f"minus1_intmin_{np.dtype(dt)}", rng.choice(keys, 3000)
    nan64 = np.array([0x7FF8000000000000, 0x7FF8000000000001, 0xFFF8000000000000,
                      0x7FF0000000000001, 0x3FF0000000000000], dtype=np.uint64)
    nan32 = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001, 0x3F800000],
                     dtype=np.uint32)
    yield "nan_payloads_f64", rng.choice(nan64, 3000).view(np.int64)
    yield "nan_payloads_f32", rng.choice(nan32, 3000).view(np.int32)
    yield "uniques_over_cutoff", rng.integers(0, 40_000, 100_000).astype(np.int64)


DICT_CASES = list(_dict_cases())


@pytest.mark.parametrize("label,bits", DICT_CASES, ids=[c[0] for c in DICT_CASES])
def test_dict_indices_matches_jax(label, bits):
    unsigned = bits.view(np.uint32 if bits.itemsize == 4 else np.uint64)
    want = J.dict_indices_device(jnp.asarray(unsigned))
    got = P.dict_indices(_t(bits))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if label == "uniques_over_cutoff":
        assert int(got[2]) > 32_767  # counted in full, no cut-off


DICT_EDGE = dict_indices_edge_cases(P.DICT_INDICES_TILE, seed=23)


@pytest.mark.parametrize("label,bits", DICT_EDGE, ids=[c[0] for c in DICT_EDGE])
def test_dict_indices_edge_cases_match_jax(label, bits):
    """The probe kernel's edge cases (sizes around its tile, one key over
    2**20 rows, two keys across warp and tile boundaries, first rows in the
    last tile, 32 keys a warp, -1, INT_MIN and NaN payloads): the plain
    version equals the JAX program bit for bit."""
    unsigned = bits.view(np.uint32 if bits.itemsize == 4 else np.uint64)
    want = J.dict_indices_device(jnp.asarray(unsigned))
    got = P.dict_indices(_t(bits))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dict_indices_tile_pinned_to_the_kernel():
    """DICT_INDICES_TILE, around which the edge cases put their sizes, is
    the kernel's tile (kThreads * kItems of dict_indices.cu)."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "dict_indices.cu").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    items = int(re.search(r"kItems = (\d+);", src).group(1))
    assert threads * items == P.DICT_INDICES_TILE


def test_dict_indices_launches_by_width_cleared_with_the_counts():
    """The tally of launches by key width goes with reset_launch_counts, and
    CPU tensors (the plain version) add nothing to it."""
    P.dict_indices.launches_by_width[64] = 3
    P.reset_launch_counts()
    assert P.dict_indices.launches_by_width == {}
    P.dict_indices(_t(np.arange(5, dtype=np.int64)))
    assert P.dict_indices.launches_by_width == {} and P.dict_indices.launches == 0


def test_dict_indices_gives_first_occurrence_order():
    bits = _t(np.array([7, 3, 7, -1, 3, 9], dtype=np.int64))
    indices, firsts, nu = P.dict_indices(bits)
    assert indices.tolist() == [0, 1, 0, 2, 1, 3]
    assert firsts.tolist() == [0, 1, 3, 5, 6, 6]
    assert int(nu) == 4


# -- delta_block_encode ----------------------------------------------------------


def _delta_cases():
    rng = np.random.default_rng(9)
    for n in EDGE_N + (2, 130, 257):
        for dt in (np.int32, np.int64):
            info = np.iinfo(dt)
            yield f"full{n}_{np.dtype(dt)}", rng.integers(
                info.min, info.max, n, dtype=dt, endpoint=True)
            yield f"rising{n}_{np.dtype(dt)}", np.cumsum(rng.integers(0, 7, n)).astype(dt)
            yield f"constant{n}_{np.dtype(dt)}", np.full(n, 5, dtype=dt)
    for bits, udt, sdt in ((32, np.uint32, np.int32), (64, np.uint64, np.int64)):
        for w in range(1, bits + 1):
            d = rng.integers(0, (1 << w) - 1, 300, dtype=np.uint64, endpoint=True).astype(udt)
            d[5], d[6] = 0, (1 << w) - 1
            yield f"width{w}_{np.dtype(sdt)}", np.cumsum(d, dtype=udt).view(sdt)


DELTA_CASES = list(_delta_cases())


def _delta_matches_jax(values):
    n = len(values)
    nbits = values.itemsize * 8
    padded = np.zeros(_bucket(max(n, 1)), dtype=values.dtype)
    padded[:n] = values
    j_mins, j_widths, j_words = J.delta_block_encode_device(jnp.asarray(padded), n, nbits)
    mins, widths, words = P.delta_block_encode(_t(values))
    nb = (max(n - 1, 0) + 127) // 128
    assert mins.numel() == nb and widths.numel() == 4 * nb
    assert words.numel() == 4 * nb * nbits
    np.testing.assert_array_equal(mins.numpy(), np.asarray(j_mins)[:nb])
    np.testing.assert_array_equal(widths.numpy(), np.asarray(j_widths)[: 4 * nb])
    payload = int(4 * widths.numpy().astype(np.int64).sum())
    got_bytes = words.numpy().view(np.uint8)
    assert got_bytes[:payload].tobytes() == np.asarray(j_words).view(np.uint8)[:payload].tobytes()
    assert not got_bytes[payload:].any()


@pytest.mark.parametrize("label,values", DELTA_CASES, ids=[c[0] for c in DELTA_CASES])
def test_delta_block_encode_matches_jax(label, values):
    _delta_matches_jax(values)


DELTA_EDGE = delta_encode_edge_cases(P.DELTA_ENCODE_TILE, seed=37)


@pytest.mark.parametrize("label,values", DELTA_EDGE, ids=[c[0] for c in DELTA_EDGE])
def test_delta_encode_edge_cases_match_jax(label, values):
    """The encode kernel's edge cases (block counts around its tile, a
    payload-free tile between wide ones, widths 32 and 64 in one tile, the
    write path's page sizes, 2**20 + 3 values, a page past one group of
    256 tiles): the plain version equals the JAX program bit for bit on the
    real prefix."""
    _delta_matches_jax(values)


def test_delta_encode_edge_cases_cover_the_tile():
    """Block counts G k - 1, G k and G k + 1 (G blocks a tile), n = 2, an
    n - 1 off the block size, a tile of width 0 between tiles with payload,
    a tile holding widths 32 and 64, the write pages' sizes, 2**20 + 3
    values and more than one group of tiles."""
    t = P.DELTA_ENCODE_TILE
    g = t // 128
    nbs = {(len(v) - 1) // 128 for _, v in DELTA_EDGE if (len(v) - 1) % 128 == 0}
    assert {2 * g - 1, 2 * g, 2 * g + 1} <= nbs
    sizes = {(len(v), v.dtype.itemsize) for _, v in DELTA_EDGE}
    assert {(2, 4), (2, 8), (1 << 17, 8), (1 << 18, 4), ((1 << 20) + 3, 8)} <= sizes
    assert any((len(v) - 1) % 128 and len(v) > t for _, v in DELTA_EDGE)
    assert any(-(-(len(v) - 1) // t) > P.DELTA_ENCODE_GROUP for _, v in DELTA_EDGE)
    quiet = mixed = False
    for _, v in DELTA_EDGE:
        widths = P.delta_block_encode(_t(v))[1].numpy()
        tiles = [widths[k : k + 4 * g] for k in range(0, len(widths), 4 * g)]
        for a, b, c in zip(tiles, tiles[1:], tiles[2:]):
            quiet |= bool(a.any() and not b.any() and c.any())
        mixed |= any({32, 64} <= set(x.tolist()) for x in tiles)
    assert quiet and mixed


def test_delta_encode_tile_pinned_to_the_kernel():
    """DELTA_ENCODE_TILE, around which the edge cases put their sizes and
    the wrapper sizes its scratch, is the kernel's tile (kG delta blocks of
    kBlock = 128 deltas in delta_block_encode.cu, one warp a block), and
    DELTA_ENCODE_GROUP, by which it sizes the group sums, the kernel's
    kGroup (kThreads tiles)."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "delta_block_encode.cu").read_text()
    k = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert k["kBlock"] == 128 and k["kG"] * k["kBlock"] == P.DELTA_ENCODE_TILE
    assert "constexpr int kThreads = 32 * kG;" in src
    assert "constexpr int kGroup = kThreads;" in src and 32 * k["kG"] == P.DELTA_ENCODE_GROUP


@pytest.mark.parametrize("label,values", DELTA_CASES, ids=[c[0] for c in DELTA_CASES])
def test_delta_stream_equals_encode_delta(label, values):
    nbits = values.itemsize * 8
    mins, widths, words = P.delta_block_encode(_t(values))
    first = int(values.view(np.uint32 if nbits == 32 else np.uint64)[0]) if len(values) else 0
    got = assemble_delta_device_stream(nbits, len(values), first, mins.numpy(),
                                       widths.numpy(), words.numpy().tobytes())
    assert got == encode_delta(values, nbits) == j_encode_delta(values, nbits)


# -- plain_bytearray_encode -----------------------------------------------------


def _bytes_cases():
    rng = np.random.default_rng(13)
    for n in EDGE_N:
        lens = rng.integers(0, 40, n)
        lens[::3] = 0  # empty strings
        yield f"n{n}", [bytes(rng.integers(0, 256, k, dtype=np.uint8)) for k in lens]
    yield "long", [b"x" * 5000, b"", b"abc"]


BYTES_CASES = list(_bytes_cases())


@pytest.mark.parametrize("label,items", BYTES_CASES, ids=[c[0] for c in BYTES_CASES])
def test_plain_bytearray_encode_matches_jax_and_encode_plain(label, items):
    n = len(items)
    data = np.frombuffer(b"".join(items), dtype=np.uint8)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(x) for x in items], out=off[1:])
    out_len = 4 * n + int(off[-1])
    want = np.asarray(J.plain_bytearray_encode_device(
        _pad_device(jnp.asarray(data)), _pad_device(jnp.asarray(off)), n,
        _bucket(max(out_len, 1))))
    got = P.plain_bytearray_encode(_t(data), _t(off), out_len).numpy()
    assert got.tobytes() == want[:out_len].tobytes()
    assert got.tobytes() == encode_plain(ByteArrayData.from_list(items), Type.BYTE_ARRAY)
    assert got.tobytes() == j_encode_plain(JByteArrayData.from_list(items), Type.BYTE_ARRAY)


def test_plain_bytearray_encode_of_a_slice():
    """Offsets that start past 0 (a page of a larger column) frame the slice."""
    items = [b"ab", b"", b"cde", b"f", b"ghij"]
    data = np.frombuffer(b"".join(items), dtype=np.uint8)
    off = np.array([0, 2, 2, 5, 6, 10], dtype=np.int64)
    sub = off[2:]
    got = P.plain_bytearray_encode(_t(data), _t(sub), 4 * 3 + 8).numpy().tobytes()
    assert got == encode_plain(ByteArrayData.from_list(items[2:]), Type.BYTE_ARRAY)


@pytest.mark.parametrize("lo", [0, 2, 5])
def test_host_byte_array_rebases_the_slice(lo):
    """A (data, offsets) pair downloads as the ByteArrayData of the values
    its offsets span, offsets rebased to 0."""
    items = [b"ab", b"", b"cde", b"f", b"ghij"]
    data = np.frombuffer(b"".join(items), dtype=np.uint8)
    off = np.array([0, 2, 2, 5, 6, 10], dtype=np.int64)
    got = host_byte_array(_t(data), _t(off[lo:]))
    assert got.to_list() == items[lo:]
    assert got.offsets[0] == 0 and len(got.data) == off[-1] - off[lo]


FRAME_EDGE = bytearray_frame_edge_cases(P.FRAME_TILE, seed=29)


@pytest.mark.parametrize("case", FRAME_EDGE, ids=[c.label for c in FRAME_EDGE])
def test_bytearray_frame_edge_cases_match_jax(case):
    """The framing kernel's edge cases (values longer than a tile, tiles of
    headers only, offsets past 0 into data off 16 bytes, out_len past or
    inside the stream and off 16, n = 1, no data, no values): the plain
    version equals the JAX program on the rebased slice, its zeros past the
    stream included, bit for bit."""
    data, off, out_len = frame_args(case)
    n = len(off) - 1
    rel = off - off[0]
    sub = data[off[0] : off[-1]]
    want = np.asarray(J.plain_bytearray_encode_device(
        _pad_device(jnp.asarray(sub)), _pad_device(jnp.asarray(rel)), n,
        _bucket(max(out_len, 1))))[:out_len]
    got = P.plain_bytearray_encode(*frame_args(case, _t))
    assert got.dtype == torch.uint8 and got.shape == (out_len,)
    assert got.numpy().tobytes() == want.tobytes()


def test_frame_tile_pinned_to_the_kernel():
    """FRAME_TILE, around which the edge cases put their frames, is the
    kernel's tile (kTileBytes = 16 * kThreads of
    plain_bytearray_encode.cu)."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "plain_bytearray_encode.cu").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    assert re.search(r"kTileBytes = 16 \* kThreads;", src)
    assert P.FRAME_TILE == 16 * threads


def test_plain_bytearray_encode_refuses_short_output():
    with pytest.raises(ValueError, match="output bytes"):
        P.plain_bytearray_encode(torch.zeros(4, dtype=torch.uint8),
                                 torch.tensor([0, 2, 4]), 7)


def test_write_kernels_are_registered():
    names = ("bitpack_encode", "rle_hybrid_encode", "dict_indices", "delta_block_encode",
             "plain_bytearray_encode")
    for name in names:
        fn = P.KERNELS[name]
        assert fn.launches == 0  # CPU tensors run the plain versions: no launch
        assert name in P.__all__ and name + "_plain" in P.__all__
