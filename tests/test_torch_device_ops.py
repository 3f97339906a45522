"""Port kernels' plain versions against the JAX device programs, on the CPU.

The same frozen upload buffer (built by the JAX package's batch freezer and
carried over with testing.parity.frozen_from_numpy) goes through the JAX
function and through the port's wrapper, which takes the plain PyTorch
version for CPU tensors. Every comparison is of integer bit patterns and
must be exact. The CUDA kernels themselves run in chip_smoke.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops as jops  # noqa: E402  (turns x64 on first)
import jax.numpy as jnp  # noqa: E402
from parquet_tpu.kernels import pipeline as jpipe  # noqa: E402
from parquet_tpu.ops.delta import encode_delta as j_encode_delta  # noqa: E402
from parquet_tpu.ops.delta import prescan_delta_packed as j_prescan_delta  # noqa: E402
from parquet_tpu.ops.rle_hybrid import encode_hybrid as j_encode_hybrid  # noqa: E402
from parquet_tpu.ops.rle_hybrid import prescan_hybrid as j_prescan_hybrid  # noqa: E402

from parquet_tpu_torch.kernels import build, device_ops as ops  # noqa: E402
from parquet_tpu_torch.kernels import pipeline as tpipe  # noqa: E402
from parquet_tpu_torch.ops.rle_hybrid import prescan_hybrid as t_prescan_hybrid  # noqa: E402
from parquet_tpu_torch.testing.parity import frozen_from_numpy  # noqa: E402
from parquet_tpu_torch.testing.synth import (  # noqa: E402
    HYBRID_EDGE_WIDTHS,
    delta_edge_cases,
    freeze_delta_case,
    freeze_hybrid_case,
    hybrid_edge_cases,
    most_runs_a_tile,
)


def _hybrid_pages(width, seed, sizes=(1500, 2221)):
    rng = np.random.default_rng(seed)
    pages = []
    for n in sizes:
        v = rng.integers(0, 1 << width, size=n, dtype=np.uint64) if width else np.zeros(n, np.uint64)
        for s in rng.integers(0, n - 64, size=6):  # RLE stretches
            v[s : s + int(rng.integers(8, 64))] = v[s]
        pages.append(v.astype(np.uint32) if width <= 32 else v)
    return pages


def _freeze_hybrid(batch_cls, prescan, width, pages):
    b = batch_cls(width)
    for v in pages:
        stream = j_encode_hybrid(v, width)
        b.add_page(prescan(stream, len(v), width), len(v))
    return b.freeze()


@pytest.mark.parametrize("width", range(33))
def test_expand_hybrid_plain_matches_jax(width):
    pages = _hybrid_pages(width, seed=width)
    jf = _freeze_hybrid(jpipe._HybridBatch, j_prescan_hybrid, width, pages)
    tf = _freeze_hybrid(tpipe._HybridBatch, t_prescan_hybrid, width, pages)
    # the port's prescan tables freeze into the same upload buffer
    assert tf._asdict().keys() == jf._asdict().keys()
    assert tf.buf.tobytes() == jf.buf.tobytes()
    assert (tf.width, tf.n_pad, tf.run_pad, tf.total) == (jf.width, jf.n_pad, jf.run_pad, jf.total)
    want = np.asarray(jpipe._HybridBatch.dispatch_frozen(jf))
    got = frozen_from_numpy(jf._asdict(), "cpu").run()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, np.concatenate(pages) if width else 0 * want)


@functools.lru_cache(maxsize=4)
def _hybrid_cases(width):
    return hybrid_edge_cases(width, ops.HYBRID_TILE)


@pytest.mark.parametrize("width", HYBRID_EDGE_WIDTHS)
@pytest.mark.parametrize("case", range(len(_hybrid_cases(1))),
                         ids=[c.label for c in _hybrid_cases(1)])
def test_expand_hybrid_edge_batches_match_jax(width, case):
    """The generator's edge batches (RLE runs of 1-17 values, one RLE run over
    five tiles, bit-packed last runs cut short, alternating 8-value runs that
    outnumber the kernel's staging, totals around the kernel's tile): the
    port's prescan and freeze give the JAX package's upload buffer byte for
    byte, and the port's plain version expands it as the JAX program does,
    to the generator's values (zeros at width 0)."""
    c = _hybrid_cases(width)[case]
    frozen, values = freeze_hybrid_case(c)
    jb = jpipe._HybridBatch(width)
    for stream, v in c.pages:
        jb.add_page(j_prescan_hybrid(stream, len(v), width), len(v))
    jf = jb.freeze()
    assert frozen.buf.tobytes() == np.asarray(jf.buf).tobytes()
    assert (frozen.run_pad, frozen.total) == (jf.run_pad, jf.total)
    want = np.asarray(jpipe._HybridBatch.dispatch_frozen(jf))
    got = frozen_from_numpy(frozen._asdict(), "cpu").run()
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, values if width else 0 * values)


def test_hybrid_edge_batches_reach_every_route():
    """The edge batches take each of the kernel's three routes: a run table
    staged whole (run_pad within the staging), the window of a tile's runs
    staged (the RLE runs of 1-17 values), and the tables read in place (the
    alternating case, whose tiles span more runs than the staging)."""
    def route(frozen):
        if frozen.run_pad <= ops.HYBRID_STAGE_RUNS:
            return "whole"
        most = most_runs_a_tile(frozen, ops.HYBRID_TILE)
        return "global" if most > ops.HYBRID_STAGE_RUNS else "window"

    routes = {c.label: route(freeze_hybrid_case(c)[0]) for c in _hybrid_cases(1)}
    assert routes.pop("8-value RLE and bit-packed runs alternating") == "global"
    assert routes.pop("RLE runs of 1-17 values") == "window"
    assert set(routes.values()) == {"whole"}


def _kernel_constants(source):
    import re

    src = (build.CSRC / source).read_text()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}


def test_hybrid_tile_pinned_to_the_kernel():
    """HYBRID_TILE and HYBRID_STAGE_RUNS, around which the edge batches put
    their totals and runs, are the kernel's (kThreads * kItems and kStageRuns
    of expand_hybrid.cu)."""
    k = _kernel_constants("expand_hybrid.cu")
    assert k["kThreads"] * k["kItems"] == ops.HYBRID_TILE
    assert k["kStageRuns"] == ops.HYBRID_STAGE_RUNS


def _delta_pages(nbits, seed):
    rng = np.random.default_rng(seed)
    dt = np.int32 if nbits == 32 else np.int64
    info = np.iinfo(dt)
    full = rng.integers(info.min, info.max, size=900, dtype=dt, endpoint=True)
    mono = (np.cumsum(rng.integers(-40, 900, size=1300)) + int(info.max) - 20_000).astype(np.int64)
    return [
        full,  # full-range values: miniblock widths up to nbits, wrapping deltas
        mono.astype(dt),  # monotone with negative jitter, wrapping past max
        np.full(257, -3, dtype=dt),  # zero-width miniblocks
        np.array([42], dtype=dt),  # a page holding only its first value
        rng.integers(-1000, 1000, size=333).astype(dt),
    ]


@pytest.mark.parametrize("nbits", [32, 64])
@pytest.mark.parametrize("split", [False, True])
def test_delta_packed_decode_plain_matches_jax(nbits, split, monkeypatch):
    pages = _delta_pages(nbits, seed=nbits + split)
    if split:
        # a small cap forces several batches, as the pipeline splits them
        monkeypatch.setattr(jpipe, "_BATCH_BITS_CAP", 8 * 3000)
    batches = []
    for v in pages:
        stream = j_encode_delta(v, nbits)
        table = j_prescan_delta(stream, nbits, max_total=len(v))
        if not batches or not batches[-1].fits(table):
            batches.append(jpipe._DeltaBatch(nbits))
        batches[-1].add_page(table, stream)
    assert (len(batches) > 1) == split
    got_all = []
    for b in batches:
        jf = b.freeze()
        want = np.asarray(jpipe._DeltaBatch.dispatch_frozen(jf))
        got = frozen_from_numpy(jf._asdict(), "cpu").run()
        assert got.dtype == (torch.int32 if nbits == 32 else torch.int64)
        np.testing.assert_array_equal(got.numpy(), want)
        got_all.append(got.numpy())
    np.testing.assert_array_equal(np.concatenate(got_all), np.concatenate(pages))
    widths = np.concatenate([w for b in batches for w in b.widths])
    assert int(widths.max()) == nbits


@functools.lru_cache(maxsize=2)
def _edge_cases(nbits):
    return delta_edge_cases(nbits, ops.DELTA_TILE)


@pytest.mark.parametrize("nbits", [32, 64])
@pytest.mark.parametrize("case", range(len(_edge_cases(32))),
                         ids=[c.label for c in _edge_cases(32)])
def test_delta_packed_decode_edge_batches_match_jax(nbits, case):
    """The generator's edge batches (miniblocks of 8-128 values, widths 0
    and nbits, one-value pages, many short pages, one page of 2**20 + 3
    values, totals around a multiple of the kernel's tile): the port's
    encoder, prescan and freeze give the JAX package's upload buffers byte
    for byte, and the port's plain version decodes them as the JAX program
    does, to the generator's values."""
    c = _edge_cases(nbits)[case]
    frozen, values = freeze_delta_case(c, nbits)
    jb = jpipe._DeltaBatch(nbits)
    for v in c.pages:
        stream = j_encode_delta(v, nbits, block_size=c.block_size, mini_count=c.mini_count)
        jb.add_page(j_prescan_delta(stream, nbits, max_total=len(v)), stream)
    jf = jb.freeze()
    assert frozen.meta32.tobytes() == np.asarray(jf.meta32).tobytes()
    assert frozen.wide.tobytes() == np.asarray(jf.wide).tobytes()
    assert (frozen.m_pad, frozen.p_pad, frozen.total) == (jf.m_pad, jf.p_pad, jf.total)
    want = np.asarray(jpipe._DeltaBatch.dispatch_frozen(jf))
    got = frozen_from_numpy(frozen._asdict(), "cpu").run()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, values)


def test_delta_tile_pinned_to_the_kernel():
    """DELTA_TILE, around which the edge batches put their totals, is the
    kernel's tile (kThreads * kItems of delta_packed_decode.cu)."""
    import re

    src = (build.CSRC / "delta_packed_decode.cu").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    items = int(re.search(r"kItems = (\d+);", src).group(1))
    assert threads * items == ops.DELTA_TILE


_GATHER_TYPES = {
    "i32": (np.int32, np.int32),
    "i64": (np.int64, np.int64),
    "u32": (np.uint32, np.int32),
    "u64": (np.uint64, np.int64),
}


@pytest.mark.parametrize("kind", sorted(_GATHER_TYPES))
def test_dict_gather_plain_matches_jax(kind):
    jdt, tdt = _GATHER_TYPES[kind]
    rng = np.random.default_rng(7)
    d = 1000
    info = np.iinfo(jdt)
    dictionary = rng.integers(info.min, info.max, size=d, dtype=jdt, endpoint=True)
    idx = rng.integers(0, d, size=5000).astype(np.int32)
    want = np.asarray(jops.dict_gather_device(jnp.asarray(dictionary), jnp.asarray(idx)))
    got = ops.dict_gather(torch.from_numpy(dictionary.view(tdt)), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(jdt), want)


@pytest.mark.parametrize("bad", [-1, -7, 1000, 2**31 - 1, -(2**31)])
def test_dict_gather_out_of_range_matches_jnp(bad):
    dictionary = np.arange(1000, dtype=np.int64) * 3 + 1
    idx = np.array([5, bad, 17], dtype=np.int32)
    want = np.asarray(jops.dict_gather_device(jnp.asarray(dictionary), jnp.asarray(idx)))
    got = ops.dict_gather_plain(torch.from_numpy(dictionary), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def _cpu_calls():
    buf = np.zeros(4 * 64 + 1024, dtype=np.int32)
    buf[65:128] = 4097  # one run at out_start 0, then sentinels
    frozen = tpipe._DeltaBatch(64)
    v = np.arange(100, dtype=np.int64)
    from parquet_tpu_torch.ops.delta import encode_delta, prescan_delta_packed

    s = encode_delta(v, 64)
    frozen.add_page(prescan_delta_packed(s, 64, max_total=100), s)
    fd = frozen.freeze()
    return {
        "expand_hybrid": (torch.from_numpy(buf), 3, 64, 10),
        "dict_gather": (torch.arange(5, dtype=torch.int64), torch.zeros(9, dtype=torch.int32)),
        "delta_packed_decode": (
            torch.from_numpy(fd.meta32.view(np.int32)),
            torch.from_numpy(fd.wide.view(np.int64)),
            64, fd.m_pad, fd.p_pad, fd.total,
        ),
        "bss_transpose": (torch.arange(4 * 1024, dtype=torch.int64).to(torch.uint8).view(4, 1024), 7),
        "merge_mixed_numeric": (
            torch.tensor([2, 0, 1], dtype=torch.int32), torch.tensor([10, 20, 30], dtype=torch.int64),
            torch.tensor([7, 8], dtype=torch.int64), torch.tensor([1, 0, 0, 0], dtype=torch.int32),
            torch.tensor([0, 3, 5, 5, 5], dtype=torch.int32), torch.tensor([0, 0, 0, 0], dtype=torch.int32),
            5,
        ),
        "merge_mixed_bytes": (
            torch.tensor([1, 0], dtype=torch.int32), torch.tensor([0, 2, 5], dtype=torch.int64),
            torch.frombuffer(bytearray(b"abcdeXYZ"), dtype=torch.uint8),
            torch.tensor([0, 1, 3], dtype=torch.int32), torch.tensor([1, 0], dtype=torch.int32),
            torch.tensor([0, 2, 4], dtype=torch.int32), torch.tensor([0, 0], dtype=torch.int32),
            torch.tensor([0, 5], dtype=torch.int64), 4, 16,
        ),
        "record_starts": (torch.tensor([1, 0, 1, 0, 0], dtype=torch.int32),),
        "list_layout": (
            torch.tensor([1, 0, 1, 0, 0], dtype=torch.int32),
            torch.tensor([2, 2, 1, 0, 2], dtype=torch.int32), 0, 2,
        ),
        "pad_ragged": (
            torch.arange(7, dtype=torch.float32), torch.tensor([2, 0, 4, 3], dtype=torch.int64), 3,
        ),
        "expand_nullable": (
            torch.arange(3, dtype=torch.int64), torch.tensor([True, False, True, True, False]),
        ),
        "predicate_mask": (torch.tensor([3, -1, 7, 2], dtype=torch.int32), "<=", 3, 3),
        "leaf_verdict": (
            torch.tensor([1, 0, 1], dtype=torch.uint8), torch.tensor([2, 1, 0], dtype=torch.int32),
            torch.tensor([True, False, True, True, False]),
        ),
        "list_contains_mask": (
            torch.tensor([0, 1, 0, 0, 1], dtype=torch.int32),
            torch.tensor([2, 2, 0, 2, 2], dtype=torch.int32),
            torch.tensor([False, True, True, False]), 2,
        ),
        "mask_take": (
            torch.arange(5, dtype=torch.int64), torch.tensor([True, False, True, True, False]), 4,
        ),
        "bitpack_encode": (torch.tensor([1, 5, 2, 7, 0], dtype=torch.int32), 3),
        "rle_hybrid_encode": (torch.tensor([1] * 9 + [2, 3], dtype=torch.int32), 2),
        "dict_indices": (torch.tensor([5, -1, 5, 3], dtype=torch.int64),),
        "delta_block_encode": (torch.tensor([3, 9, 1, 4, 4], dtype=torch.int64),),
        "plain_bytearray_encode": (
            torch.frombuffer(bytearray(b"abcde"), dtype=torch.uint8),
            torch.tensor([0, 2, 2, 5], dtype=torch.int64), 17,
        ),
        "masked_agg": (
            torch.tensor([3, -9, 7, 1], dtype=torch.int64),
            torch.tensor([True, False, True, True]), "min",
        ),
        "expand_page_grid": (
            torch.tensor([[0x1234567, 0x89ABCDEF, 0]], dtype=torch.int64).to(torch.int32),
            torch.tensor([[0, 4, 9]], dtype=torch.int32), torch.tensor([[1, 0, 0]], dtype=torch.int32),
            torch.tensor([[5, 0, 0]], dtype=torch.int32), torch.tensor([[0, 0, 0]], dtype=torch.int32),
            torch.arange(10, dtype=torch.int64) * 7, 3, 8,
        ),
    }


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_wrapper_takes_plain_version_for_cpu_tensors(name):
    args = _cpu_calls()[name]
    fn = ops.KERNELS[name]
    before = fn.launches
    out = fn(*args)
    plain = getattr(ops, name + "_plain")(*args)
    outs = out if isinstance(out, tuple) else (out,)
    plains = plain if isinstance(plain, tuple) else (plain,)
    assert all(o.device.type == "cpu" for o in outs)
    assert len(outs) == len(plains) and all(map(torch.equal, outs, plains))
    assert fn.launches == before  # no kernel launched, so no count


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_wrapper_raises_for_non_cuda_devices(name):
    args = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in _cpu_calls()[name])
    with pytest.raises(ValueError, match="not supported"):
        ops.KERNELS[name](*args)
    assert ops.KERNELS[name].launches == 0


def test_wrapper_input_checks():
    with pytest.raises(TypeError):
        ops.expand_hybrid(torch.zeros(2000, dtype=torch.int64), 3, 64, 10)
    with pytest.raises(ValueError, match="1-D"):
        ops.dict_gather(torch.zeros(4, 2, dtype=torch.int32), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.dict_gather(torch.zeros(8, dtype=torch.int32)[::2], torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="width"):
        ops.expand_hybrid(torch.zeros(2000, dtype=torch.int32), 33, 64, 10)
    with pytest.raises(ValueError, match="too short"):
        ops.expand_hybrid(torch.zeros(100, dtype=torch.int32), 3, 64, 10)
    with pytest.raises(ValueError, match="different devices"):
        ops.dict_gather(torch.zeros(8, dtype=torch.int32), torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="empty dictionary"):
        ops.dict_gather(torch.zeros(0, dtype=torch.int32), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="nbits"):
        ops.delta_packed_decode(torch.zeros(9, dtype=torch.int32), torch.zeros(0, dtype=torch.int32), 16, 1, 1, 1)


def test_reset_launch_counts():
    ops.expand_hybrid.launches = 5
    ops.expand_hybrid.launches_by_width = {12: 5}
    ops.reset_launch_counts()
    assert all(fn.launches == 0 for fn in ops.KERNELS.values())
    assert ops.expand_hybrid.launches_by_width == {}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build._nvcc()


def test_signatures_match_the_sources():
    """Every C entry point ctypes binds is defined in a kernel source with the
    same number of arguments, and every one defined there is bound."""
    import re

    declared = {}
    for src in build._sources() + build._headers():
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            args = m.group(2).strip()
            declared[m.group(1)] = 0 if args in ("", "void") else args.count(",") + 1
    assert declared == {k: len(v) for k, v in build.SIGNATURES.items()}


def test_signature_types_match_the_sources():
    """Every argument ctypes passes has its C parameter's width: a Python int
    bound as c_int where the source takes long long would be cut to 32 bits
    without an error."""
    import ctypes
    import re

    c_types = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
               "unsigned long long": ctypes.c_ulonglong, "double": ctypes.c_double}
    for src in build._sources() + build._headers():
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            params = [a.strip() for a in m.group(2).split(",") if a.strip() not in ("", "void")]
            want = [ctypes.c_void_p if "*" in a else c_types[re.sub(r"\s+\w+$", "", a)]
                    for a in params]
            assert list(build.SIGNATURES[m.group(1)]) == want, m.group(1)


def test_build_key_tracks_sources(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("// one")
    k1 = build._key([a])
    a.write_text("// two")
    assert build._key([a]) != k1
    assert sorted(build.SIGNATURES) == sorted(
        ["pqt_expand_hybrid", "pqt_dict_gather4", "pqt_dict_gather8",
         "pqt_delta_scratch_words", "pqt_delta_packed_decode", "pqt_bss_transpose_pages",
         "pqt_merge_mixed_numeric4", "pqt_merge_mixed_numeric8",
         "pqt_merge_bytes_scratch_words", "pqt_merge_mixed_bytes",
         "pqt_record_starts", "pqt_list_layout", "pqt_pad_ragged_scratch_words",
         "pqt_pad_ragged", "pqt_expand_nullable",
         "pqt_predicate_mask", "pqt_fixed_members",
         "pqt_leaf_verdict", "pqt_list_contains_mask", "pqt_mask_scan", "pqt_mask_take",
         "pqt_take_rows",
         "pqt_bitpack_encode", "pqt_rle_hybrid_encode", "pqt_dict_indices_scratch_words",
         "pqt_dict_indices",
         "pqt_delta_block_encode", "pqt_plain_bytearray_encode",
         "pqt_masked_agg", "pqt_expand_page_grid"]
    )
    # the header compiles into its includers: editing it changes the key
    h = tmp_path / "scan.cuh"
    h.write_text("// one")
    k3 = build._key([a, h])
    h.write_text("// two")
    assert build._key([a, h]) != k3
    assert [p.name for p in build._headers()] == [
        "bitpack.cuh", "hybrid.cuh", "scan.cuh", "validity.cuh"]
