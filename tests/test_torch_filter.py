"""Device filtering: the port's masks, kernels and pruning against JAX.

The same inputs (numpy seeds, the type zoo of tests/test_filter_vec.py,
files written by pyarrow, by the JAX package's FileWriter and by the
port's synth writer) go through the JAX package on CPU jax and through
parquet_tpu_torch on the CPU (`device="cpu"`: each wrapper runs its
kernel's plain version). Every comparison is exact: masks bit for bit,
normalized brackets by value, pruned group sets by index. Where the JAX
host engine declines a predicate with VecFilterError, the port raises it
too. The CUDA kernels themselves run only on the card (chip_smoke.py).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops as J  # noqa: E402  (turns x64 on first)
from parquet_tpu.core.filter import normalize_dnf as j_normalize_dnf  # noqa: E402
from parquet_tpu.core.filter_vec import VecFilterError as JVecFilterError  # noqa: E402
from parquet_tpu.core.filter_vec import dnf_mask as j_dnf_mask  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema  # noqa: E402
from tests.test_filter_vec import ZOO_FILTERS, zoo  # noqa: E402,F401

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileReader  # noqa: E402
from parquet_tpu_torch.core.filter import normalize_dnf  # noqa: E402
from parquet_tpu_torch.core.filter_vec import VecFilterError  # noqa: E402
from parquet_tpu_torch.kernels import device_ops as P  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import CompressionCodec as C  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Encoding as E  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Type as T  # noqa: E402
from parquet_tpu_torch.testing.synth import (  # noqa: E402
    ColumnSpec,
    leaf_verdict_edge_cases,
    list_contains_edge_cases,
    mask_take_args,
    mask_take_edge_cases,
    write_file,
)

jnp = pytest.importorskip("jax").numpy
CPU = torch.device("cpu")
ZOO_IDS = [str(f) for f in ZOO_FILTERS]


def _key(x):
    """A bracket in a comparable form: NaN equal to NaN, lists element-wise."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, (list, tuple)):
        return [_key(e) for e in x]
    return x


def _entries(dnf):
    return [[(e[0], e[2], _key(e[4]), _key(e[5])) for e in conj] for conj in dnf]


@pytest.mark.parametrize("filt", ZOO_FILTERS, ids=ZOO_IDS)
def test_normalize_dnf_matches_jax(zoo, filt):  # noqa: F811
    with JReader(zoo) as jr, FileReader(zoo, device="cpu") as r:
        assert _entries(normalize_dnf(r.schema, filt)) == _entries(
            j_normalize_dnf(jr.schema, filt)
        )


# -- each kernel's plain version against its JAX program -------------------------


def _values(rng, dt, n):
    if dt == np.bool_:
        return rng.random(n) > 0.5
    if np.dtype(dt).kind == "f":
        v = rng.standard_normal(n).astype(dt)
        v[::7] = np.nan
        v[1], v[2] = 0.0, -0.0
        return v
    info = np.iinfo(dt)
    v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    v[:3] = (info.min, info.max, 0)
    if np.dtype(dt).kind == "u":  # values above 2^31 / 2^63 and below
        v[3:6] = (1 << (8 * v.itemsize - 1), (1 << (8 * v.itemsize - 1)) + 5, 7)
    return v


def _bracket(v, dt, exact):
    """(lo, hi) from the data: an exact bracket, or the neighbouring pair an
    inexact coercion gives."""
    if dt == np.bool_:
        return (0, 0) if exact else (0, 1)
    if np.dtype(dt).kind == "f":
        lo = float(v[4])
        return lo, lo if exact else float(np.nextafter(dt(lo), dt(np.inf)))
    lo = int(v[4])
    return lo, lo if exact else min(lo + 1, int(np.iinfo(dt).max))


PRED_DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint32, np.uint64,
               np.float32, np.float64, np.bool_)


def _pred_sizes(dt):
    """The kernel's edge sizes for a dtype: around one 16-element step, one
    block's work, and 2**20 + 3."""
    block = P.predicate_block(np.dtype(np.int8 if dt == np.bool_ else dt).itemsize)
    return (1, 15, 16, 17, block - 1, block + 1, (1 << 20) + 3)


_PRED_CASES = (
    [pytest.param(dt, 300, 0, id=np.dtype(dt).name) for dt in PRED_DTYPES]
    + [pytest.param(dt, n, 0, id=f"{np.dtype(dt).name}-n{n}")
       for dt in PRED_DTYPES for n in _pred_sizes(dt)]
    # starts off the kernel's 16-byte loads
    + [pytest.param(dt, _pred_sizes(dt)[5], off,
                    id=f"{np.dtype(dt).name}-n{_pred_sizes(dt)[5]}-offset{off}")
       for dt in PRED_DTYPES for off in range(1, 16)]
)


@pytest.mark.parametrize("dt, n, offset", _PRED_CASES)
def test_predicate_mask_plain_matches_jax(dt, n, offset):
    """n values starting `offset` elements into a larger column (a view),
    under every op, exact and inexact brackets taken from the column."""
    rng = np.random.default_rng(11)
    base = _values(rng, dt, max(n + offset, 300))
    v = base[offset : offset + n]
    signed_view = {np.uint32: np.int32, np.uint64: np.int64}.get(dt)
    tv = torch.from_numpy(base.view(signed_view).copy() if signed_view else base.copy())
    tv = tv[offset : offset + n]
    jv = jnp.asarray(v.astype(np.int8) if dt == np.bool_ else v)
    jt = np.int8 if dt == np.bool_ else dt
    for op in ("==", "!=", "<", "<=", ">", ">="):
        for exact in (True, False):
            lo, hi = _bracket(base, dt, exact)
            want = np.asarray(J.predicate_mask_device(jv, op, jt(lo), jt(hi), exact))
            got = P.predicate_mask(tv, op, lo, hi, exact, unsigned=signed_view is not None)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{op} {exact}")


def test_predicate_mask_nan_bracket_and_members():
    v = np.array([1.0, np.nan, 2.0, -0.0, 0.0])
    nan = float("nan")
    for op in ("==", "!=", "<", "<=", ">", ">="):
        want = np.asarray(J.predicate_mask_device(jnp.asarray(v), op, nan, nan, False))
        got = P.predicate_mask(torch.from_numpy(v), op, nan, nan, False)
        np.testing.assert_array_equal(got.numpy(), want)
    # in / not_in: the OR of the members' equality masks (NaN never equal)
    members = [2.0, 0.0, nan]
    jm = np.zeros(len(v), bool)
    for m in members:
        jm |= np.asarray(J.predicate_mask_device(jnp.asarray(v), "==", m, m, True))
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(P.predicate_mask(t, "in", members=members).numpy(), jm)
    np.testing.assert_array_equal(P.predicate_mask(t, "not_in", members=members).numpy(), ~jm)
    assert not P.predicate_mask(t, "in", members=[]).any()


def test_predicate_mask_unsigned_sub_width_and_range():
    """The unsigned view of row 22 (bitcast, then the sub-width mask), and
    brackets coerced to the column's dtype (float32 rounding; an integer
    outside the range raises)."""
    rng = np.random.default_rng(3)
    u = rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)
    for bits in (8, 16, 32):
        jv = jnp.asarray(u) & np.uint32((1 << bits) - 1)
        for op in ("<", ">=", "=="):
            lo = int(u[7]) & ((1 << bits) - 1)
            want = np.asarray(J.predicate_mask_device(jv, op, np.uint32(lo), np.uint32(lo), True))
            got = P.predicate_mask(torch.from_numpy(u.view(np.int32).copy()), op, lo, lo,
                                   unsigned=True, bits=bits)
            np.testing.assert_array_equal(got.numpy(), want)
    f = rng.standard_normal(100).astype(np.float32)
    got = P.predicate_mask(torch.from_numpy(f), "<", 0.1, 0.1)
    np.testing.assert_array_equal(got.numpy(), f < np.float32(0.1))
    with pytest.raises(ValueError):
        P.predicate_mask(torch.zeros(4, dtype=torch.int32), "<", 1 << 31, 1 << 31)
    with pytest.raises(TypeError):
        P.predicate_mask(torch.zeros(4, dtype=torch.int32), "<", 0.5, 0.5)


def test_predicate_mask_fixed_width_rows():
    """_fixed_compare of row 22: all(arr == pattern, axis=1), == and !=,
    a width mismatch and width 0."""
    from parquet_tpu.core.filter_device import _fixed_compare

    rng = np.random.default_rng(5)
    rows = rng.integers(0, 3, (200, 4), dtype=np.uint8)
    for pat in (bytes(rows[9]), b"\x00\x01\x02\x00", b"\x01\x02", b""):
        for op in ("==", "!="):
            want = np.asarray(_fixed_compare(jnp.asarray(rows), op, pat))
            got = P.predicate_mask(torch.from_numpy(rows), op, pat)
            np.testing.assert_array_equal(got.numpy(), want)
    empty = np.zeros((5, 0), np.uint8)
    np.testing.assert_array_equal(
        P.predicate_mask(torch.from_numpy(empty), "==", b"").numpy(),
        np.asarray(_fixed_compare(jnp.asarray(empty), "==", b"")),
    )
    with pytest.raises(ValueError):
        P.predicate_mask(torch.from_numpy(rows), "<", b"ab")


@pytest.mark.parametrize("op", ["in", "not_in"])
def test_predicate_mask_fixed_width_members(op):
    """An FLBA in-list: the reference ORs one _fixed_compare(==) per member
    (_member_mask) and negates for not_in; the port compares the rows with
    every member in one call. Members of another width, no members, 64
    members, width-0 rows; more than 64 members are refused."""
    from parquet_tpu.core.filter_device import _fixed_compare

    rng = np.random.default_rng(6)
    for rows in (rng.integers(0, 3, (300, 4), dtype=np.uint8), np.zeros((5, 0), np.uint8)):
        w = rows.shape[1]
        firsts = [bytes(r) for r in rows[:64]]
        for members in (firsts[3:9] + [bytes(w + 1)], [bytes(w), b"\x01\x02"], [], firsts):
            hit = np.zeros(len(rows), bool)
            for m in members:
                hit |= np.asarray(_fixed_compare(jnp.asarray(rows), "==", m))
            got = P.predicate_mask(torch.from_numpy(rows), op, members=members)
            np.testing.assert_array_equal(got.numpy(), hit if op == "in" else ~hit,
                                          err_msg=f"w={w} {len(members)} members")
    with pytest.raises(ValueError):
        P.predicate_mask(torch.from_numpy(rows), op, members=[b""] * (P.MAX_MEMBERS + 1))


def test_member_cap_stated_once():
    """The in-list cap is device_ops.MAX_MEMBERS, the member table of
    predicate_mask.cu has that many slots, and filter_device declines a
    longer list to the host engine at the same count."""
    import re
    from pathlib import Path

    from parquet_tpu_torch.core import filter_device

    src = (Path(P.__file__).parent / "csrc" / "predicate_mask.cu").read_text()
    assert int(re.search(r"kMaxMembers = (\d+);", src).group(1)) == P.MAX_MEMBERS
    assert filter_device.MAX_MEMBERS is P.MAX_MEMBERS
    vals = torch.arange(200, dtype=torch.int32)
    assert int(P.predicate_mask(vals, "in", members=list(range(P.MAX_MEMBERS))).sum()) == 64
    with pytest.raises(ValueError):
        P.predicate_mask(vals, "in", members=list(range(P.MAX_MEMBERS + 1)))


def test_predicate_block_pinned_to_the_kernel():
    """predicate_block, around which the edge sizes sit, is what one block of
    predicate_mask.cu takes from aligned values (kThreads *
    max(kStepBytes / itemsize, kMinPer))."""
    import re
    from pathlib import Path

    src = (Path(P.__file__).parent / "csrc" / "predicate_mask.cu").read_text()
    threads, step, least = (int(re.search(rf"{name} = (\d+);", src).group(1))
                            for name in ("kThreads", "kStepBytes", "kMinPer"))
    for itemsize in (1, 2, 4, 8):
        assert P.predicate_block(itemsize) == threads * max(step // itemsize, least)


def _levels(rng, n, lead=0):
    rep = rng.integers(0, 2, n).astype(np.int32)
    rep[lead:][:1] = 0
    dfl = rng.integers(0, 3, n).astype(np.int32)
    return rep, dfl


@pytest.mark.parametrize("n,nv,lead", [(1, 1, 0), (7, 3, 0), (1000, 300, 0), (50, 20, 4),
                                       (40, 0, 0), (1, 0, 0), (2000, 900, 1)])
def test_list_contains_mask_plain_matches_jax(n, nv, lead):
    """Seeded streams, one opening mid-record (rep[0] != 0, clipped into
    row 0), nv == 0, null (def 0) and empty (def 1) lists."""
    rng = np.random.default_rng(n + nv + lead)
    rep, dfl = _levels(rng, n, lead)
    if lead:
        rep[:lead] = 1
    dm = rng.random(nv) > 0.5
    wr, wn = J.list_contains_mask_device(jnp.asarray(rep), jnp.asarray(dfl), jnp.asarray(dm), 2)
    gr, gn = P.list_contains_mask(torch.from_numpy(rep), torch.from_numpy(dfl),
                                  torch.from_numpy(dm), 2)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    assert int(gn) == int(wn) and gn.dtype == torch.int64 and gn.dim() == 0


def _kernel_constants(source: str) -> dict:
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / source).read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}


CONTAINS_EDGE = list_contains_edge_cases(P.LIST_CONTAINS_TILE, seed=37)


@pytest.mark.parametrize("label,rep,dfl,dm,elem_def", CONTAINS_EDGE,
                         ids=[c[0] for c in CONTAINS_EDGE])
def test_list_contains_edge_cases_match_jax(label, rep, dfl, dm, elem_def):
    """The LIST-contains kernel's edge cases (sizes around its tile, record
    starts at tile and vector edges, a record over two tiles, matches
    before the first start, no start, starts only, nv = 0 and past the
    element count, one element, the saturated def level): the plain
    version equals the JAX program bit for bit, rows past n_rows false."""
    wr, wn = J.list_contains_mask_device(jnp.asarray(rep), jnp.asarray(dfl), jnp.asarray(dm),
                                         elem_def)
    gr, gn = P.list_contains_mask(torch.from_numpy(rep), torch.from_numpy(dfl),
                                  torch.from_numpy(dm), elem_def)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    assert int(gn) == int(wn) == int((rep == 0).sum()) and gn.dtype == torch.int64
    assert not gr[int(gn):].any() or int(gn) == 0


def test_list_contains_edge_cases_cover_the_tile():
    """Sizes 0, 1, tile - 1, tile and tile + 1; starts at a tile's and a
    vector's first and last entry; a record longer than a tile whose only
    match lies past its first tile; matches before the first start; no
    start past a tile; starts only with a warp's 128 rows all matching; nv
    = 0, nv past the element count, one element; the saturated def level."""
    t = P.LIST_CONTAINS_TILE
    assert {0, 1, t - 1, t, t + 1} <= {len(c[1]) for c in CONTAINS_EDGE}
    seen = set()
    for _, rep, dfl, dm, elem_def in CONTAINS_EDGE:
        n = len(rep)
        s = np.flatnonzero(rep == 0)
        inner = s[s > 0]
        elem = dfl == elem_def
        nv = int(elem.sum())
        didx = np.clip(np.cumsum(elem) - 1, 0, max(len(dm) - 1, 0))
        match = elem & (dm[didx] if len(dm) else False)
        row_of = np.cumsum(rep == 0) - 1
        seen |= {("tile first", bool((inner % t == 0).any())),
                 ("tile last", bool((s % t == t - 1).any())),
                 ("vector first", bool((inner % 4 == 0).any())),
                 ("vector last", bool((s % 4 == 3).any())),
                 ("nv 0", len(dm) == 0 and nv > 0),
                 ("nv past", len(dm) > nv > 0),
                 ("one element", nv == 1),
                 ("saturated", elem_def == 2**31 - 1),
                 ("before the first start", bool(match[: s[0] if len(s) else n].any()))}
        if n > t:
            seen.add(("no start", len(s) == 0))
            seen.add(("starts only, 128 matching rows a warp",
                      len(s) == n and bool(match[:128].all())))
            ends = np.append(s[1:], n) if len(s) else s
            long = [(a, b) for a, b in zip(s, ends, strict=True) if b - a > t]
            seen.add(("long record matching past its first tile only", any(
                match[a:b].any() and not match[a : (a // t + 1) * t].any()
                and not match[b:][row_of[b:] == row_of[a]].any() for a, b in long)))
    assert {k for k, v in seen if v} == {k for k, _ in seen}


def test_list_contains_tile_pinned_to_the_kernel():
    """LIST_CONTAINS_TILE, around which the edge cases put their sizes and
    the wrapper sizes its look-back descriptors, is the kernel's tile
    (kThreads * kItems of list_contains_mask.cu), whole 4-entry vectors."""
    k = _kernel_constants("list_contains_mask.cu")
    assert k["kThreads"] * k["kItems"] == P.LIST_CONTAINS_TILE
    assert k["kItems"] % 4 == 0


LV_EDGE = leaf_verdict_edge_cases(P.LEAF_VERDICT_TILE, seed=41, group=P.LEAF_VERDICT_GROUP)


def _leaf_verdict_jax(verdict, idx, valid, fill):
    """Row 22's inline ops as parquet_tpu/core/filter_device.py writes them:
    the gather `dcmp[indices]`, then `v & cmp[didx]` or, for arrow's
    not_in, `(~v) | (v & cmp[didx])` (zeros or ~valid when nd == 0)."""
    from parquet_tpu.core.filter_device import _valid_expand

    dcmp = jnp.asarray(verdict != 0)
    cmp_j = dcmp if idx is None else dcmp[jnp.asarray(idx)]
    if valid is None:
        return np.asarray(cmp_j)
    nd = int(valid.sum())
    if nd == 0:
        return np.asarray(jnp.asarray(~valid)) if fill else np.zeros(len(valid), bool)
    v, didx = _valid_expand(valid, nd, {}, ("c",))
    return np.asarray((~v) | (v & cmp_j[didx]) if fill else v & cmp_j[didx])


@pytest.mark.parametrize("label,verdict,idx,valid,fill", LV_EDGE, ids=[c[0] for c in LV_EDGE])
def test_leaf_verdict_edge_cases_match_jax(label, verdict, idx, valid, fill):
    """The leaf-verdict kernel's edge cases (sizes around its 16-row
    threads and its tile, all-true, all-false and random validities, nd =
    0, both fills, out-of-range indices around a tile boundary, dense and
    dictionary verdicts, verdict bytes other than 0 and 1): the plain
    version equals the JAX package's inline ops bit for bit."""
    got = P.leaf_verdict(torch.from_numpy(verdict),
                         None if idx is None else torch.from_numpy(idx),
                         None if valid is None else torch.from_numpy(valid), fill)
    np.testing.assert_array_equal(got.numpy(), _leaf_verdict_jax(verdict, idx, valid, fill))


def test_leaf_verdict_edge_cases_cover_the_tile():
    """Sizes 0, 1, 15-17, tile - 1, tile and tile + 1, with and without a
    validity; with a validity, one whole group of tiles, a tile past it and
    a size past two groups; all-true, all-false and random validities; both fills; the
    out-of-range indices -1, n_dict and -n_dict - 4 at dense positions on
    both sides of a tile boundary; dense and dictionary verdicts; verdict
    bytes past 1."""
    t = P.LEAF_VERDICT_TILE
    sizes = {(len(c[3]) if c[3] is not None else len(c[2] if c[2] is not None else c[1]),
              c[3] is None) for c in LV_EDGE}
    assert {(n, w) for n in (0, 1, 15, 16, 17, t - 1, t, t + 1) for w in (True, False)} <= sizes
    g = P.LEAF_VERDICT_GROUP * t
    assert {(g, False), (g + 1, False), (2 * g + t + 3, False)} <= sizes
    seen = set()
    for _, verdict, idx, valid, fill in LV_EDGE:
        seen.add(("fill", fill))
        seen.add(("dense", idx is None))
        seen.add(("bytes past 1", bool((verdict > 1).any())))
        if valid is not None and len(valid) > 1:
            seen.add(("validity", "all" if valid.all() else "none" if not valid.any() else "some"))
        if idx is not None and len(idx):
            bad = np.flatnonzero((idx < 0) | (idx >= len(verdict)))
            seen.add(("out of range below a tile boundary", bool((bad % t >= t - 3).any())))
            seen.add(("out of range above a tile boundary",
                      bool(((bad % t < 3) & (bad >= t)).any())))
            seen.add(("wrapped", bool((idx == -1).any() and (idx < -len(verdict)).any()
                                      and (idx == len(verdict)).any())))
    assert {k for k in seen if k[1] is not False} | {("fill", False), ("dense", False)} == {
        ("fill", False), ("fill", True), ("dense", True), ("dense", False), ("bytes past 1", True),
        ("validity", "all"), ("validity", "none"), ("validity", "some"),
        ("out of range below a tile boundary", True), ("out of range above a tile boundary", True),
        ("wrapped", True)}
    assert ("fill", False) in seen and ("dense", False) in seen


def test_leaf_verdict_launches_by_kind_cleared_with_the_counts():
    """The tally of launches by kind (gather, validity) goes with
    reset_launch_counts, and CPU tensors (the plain version) add nothing."""
    P.leaf_verdict.launches_by_kind["validity"] = 3
    P.reset_launch_counts()
    assert P.leaf_verdict.launches_by_kind == {}
    v = torch.ones(4, dtype=torch.bool)
    P.leaf_verdict(v, torch.arange(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool))
    assert P.leaf_verdict.launches_by_kind == {} and P.leaf_verdict.launches == 0


def test_leaf_verdict_tile_pinned_to_the_kernel():
    """LEAF_VERDICT_TILE and LEAF_VERDICT_GROUP, around which the edge
    cases put their sizes and the wrapper sizes the validity path's tile
    and group counts, are the kernel's tile (kThreads * kItems of
    leaf_verdict.cu, whole 16-row vectors) and its tiles a group."""
    import re

    from parquet_tpu_torch.kernels import build

    k = _kernel_constants("leaf_verdict.cu")
    assert k["kThreads"] * k["kItems"] == P.LEAF_VERDICT_TILE
    vec = _kernel_constants("validity.cuh")["kVec"]
    assert vec == 16 and k["kItems"] % vec == 0
    src = (build.CSRC / "leaf_verdict.cu").read_text()
    assert re.search(r"constexpr int kGroup = kThreads;", src)
    assert k["kThreads"] == P.LEAF_VERDICT_GROUP


@pytest.mark.parametrize("n,out_pad,p", [(10, 16, 0.5), (300, 40, 0.5), (1, 4, 1.0),
                                         (64, 64, 1.0), (100, 8, 0.0), (0, 4, 0.5),
                                         (1000, 1024, 0.3)])
def test_mask_take_plain_matches_jax(n, out_pad, p):
    """count > out_pad keeps the first out_pad rows and the full count;
    past the count values[0]; n == 0 gives zeros; 2-D rows too."""
    rng = np.random.default_rng(n * 7 + out_pad)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    m = rng.random(n) < p
    wt, wc = J.mask_take_device(jnp.asarray(v), jnp.asarray(m), out_pad)
    gt, gc = P.mask_take(torch.from_numpy(v), torch.from_numpy(m), out_pad)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    assert int(gc) == int(wc) and gc.dtype == torch.int64
    v2 = rng.integers(0, 9, (n, 3)).astype(np.int32)
    wt2, _ = J.mask_take_device(jnp.asarray(v2), jnp.asarray(m), out_pad)
    gt2, _ = P.mask_take(torch.from_numpy(v2), torch.from_numpy(m), out_pad)
    if n:
        np.testing.assert_array_equal(gt2.numpy(), np.asarray(wt2))
    else:  # the reference's zeros drop the row shape; the port keeps it
        assert gt2.shape == (out_pad, 3) and not gt2.any() and not np.asarray(wt2).any()


MASK_TAKE_EDGE = mask_take_edge_cases(P.MASK_TAKE_TILE, P.MASK_TAKE_BLOCKS, seed=31)


@pytest.mark.parametrize("case", MASK_TAKE_EDGE, ids=[c.label for c in MASK_TAKE_EDGE])
def test_mask_take_edge_cases_match_jax(case):
    """The compaction kernel's edge cases (sizes around its tile, two tiles a
    chunk, masks off 16 bytes, all-false and all-true masks, out_pad below,
    at and past the count, every row width, misaligned rows): the plain
    version of mask_take, and of its scan and row gather in turn, equals the
    JAX program bit for bit."""
    v, m, out_pad = mask_take_args(case)
    wt, wc = J.mask_take_device(jnp.asarray(v), jnp.asarray(m), out_pad)
    tv, tm, _ = mask_take_args(case, torch.from_numpy)
    gt, gc = P.mask_take(tv, tm, out_pad)
    src, count = P.mask_take_scan(tm, out_pad)
    rows = P.mask_take_rows(tv, src, count, out_pad)
    assert int(gc) == int(wc) == int(count) and gc.dtype == torch.int64
    if len(v):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(wt))
    else:  # the reference's zeros drop the row shape; the port keeps it
        assert gt.shape == (out_pad,) + v.shape[1:] and not gt.any() and not rows.any()


def test_mask_take_constants_pinned_to_the_kernel():
    """MASK_TAKE_TILE and MASK_TAKE_BLOCKS, around which the edge cases put
    their sizes, are mask_take.cu's tile (16 entries a thread) and grid cap."""
    import re

    from parquet_tpu_torch.kernels import build

    src = (build.CSRC / "mask_take.cu").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    assert re.search(r"kTileVecs = kThreads;", src) and re.search(r"kTile = 16 \* kTileVecs;", src)
    assert P.MASK_TAKE_TILE == 16 * threads
    assert P.MASK_TAKE_BLOCKS == int(re.search(r"kMaxBlocks = (\d+);", src).group(1))


def test_mask_take_refuses_values_of_another_length():
    with pytest.raises(ValueError, match="values under a mask"):
        P.mask_take(torch.arange(4), torch.ones(5, dtype=torch.bool), 5)


@pytest.mark.parametrize("n_dict,n,p", [(50, 400, 0.8), (1, 10, 1.0), (7, 30, 0.0),
                                        (100, 1000, 0.5), (3, 1, 1.0)])
def test_leaf_verdict_plain_matches_jax_inline_ops(n_dict, n, p):
    """Row 22's verdict gather `dcmp[indices]` (jnp's wrap-and-clamp rule for
    out-of-range indices), validity scan and expansions `v & cmp[didx]` and
    `(~v) | (v & cmp[didx])`, as parquet_tpu/core/filter_device.py writes
    them."""
    from parquet_tpu.core.filter_device import _valid_expand

    rng = np.random.default_rng(n_dict * 31 + n)
    valid = rng.random(n) < p
    nd = int(valid.sum())
    dcmp = rng.random(n_dict) > 0.5
    idx = rng.integers(0, n_dict, nd).astype(np.int32)
    if nd >= 3:
        idx[:3] = (-1, n_dict, -n_dict - 4)
    cmp_j = jnp.asarray(dcmp)[jnp.asarray(idx)]
    verdict = torch.from_numpy(dcmp.view(np.uint8).copy())
    tidx = torch.from_numpy(idx)
    np.testing.assert_array_equal(P.leaf_verdict(verdict, tidx).numpy(), np.asarray(cmp_j))
    tvalid = torch.from_numpy(valid)
    if nd:
        v, didx = _valid_expand(valid, nd, {}, ("c",))
        row = np.asarray(v & cmp_j[didx])
        arrow = np.asarray((~v) | (v & cmp_j[didx]))
    else:
        row, arrow = np.zeros(n, bool), ~valid
    np.testing.assert_array_equal(P.leaf_verdict(verdict, tidx, tvalid).numpy(), row)
    np.testing.assert_array_equal(P.leaf_verdict(verdict, tidx, tvalid, True).numpy(), arrow)
    # a dense verdict (no indices) through the same expansion
    dense = torch.from_numpy(np.asarray(cmp_j).copy())
    np.testing.assert_array_equal(P.leaf_verdict(dense, None, tvalid).numpy(), row)


# -- resident masks on the type zoo -----------------------------------------------


@pytest.fixture(scope="module")
def zoo_groups(zoo):  # noqa: F811
    """The zoo's row groups, decoded once by each package: (JAX host chunks,
    port device columns on the CPU, row counts)."""
    with JReader(zoo) as jr, FileReader(zoo, device="cpu") as r:
        host = [jr._read_row_group(i, None, pack=False) for i in range(jr.num_row_groups)]
        dev = [r.read_row_group_device(i) for i in range(r.num_row_groups)]
        rows = [int(r.row_group(i).num_rows) for i in range(r.num_row_groups)]
    return host, dev, rows


def _port_mask(r, cols, nd, i, n, null_mode="row"):
    return r._device_group_mask(i, cols, nd, n, CPU, null_mode=null_mode).numpy()


@pytest.mark.parametrize("filt", ZOO_FILTERS, ids=ZOO_IDS)
def test_zoo_masks_match_jax(zoo, filt):  # noqa: F811
    """read_row_group_device(i, filters=f) on the port equals the JAX
    package's mask for every group; where the JAX host engine declines with
    VecFilterError, the port raises it too."""
    with JReader(zoo) as jr, FileReader(zoo, device="cpu") as r:
        for i in range(r.num_row_groups):
            try:
                _jc, jmask = jr.read_row_group_device(i, filters=filt)
            except JVecFilterError:
                with pytest.raises(VecFilterError):
                    r.read_row_group_device(i, filters=filt)
                continue
            cols, mask = r.read_row_group_device(i, filters=filt)
            assert mask.dtype == torch.bool and mask.device.type == "cpu"
            np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask), err_msg=str(filt))


@pytest.mark.parametrize("filt", ZOO_FILTERS, ids=ZOO_IDS)
def test_zoo_arrow_null_mode_matches_jax_host(zoo, zoo_groups, filt):  # noqa: F811
    """null_mode="arrow" (not_in keeps nulls; the float32 in-list decline)
    against the JAX host engine's dnf_mask(..., null_mode="arrow")."""
    host, dev, rows = zoo_groups
    with JReader(zoo) as jr, FileReader(zoo, device="cpu") as r:
        jnd, nd = j_normalize_dnf(jr.schema, filt), normalize_dnf(r.schema, filt)
        for i, n in enumerate(rows):
            try:
                want = j_dnf_mask(host[i], jnd, n, null_mode="arrow")
            except JVecFilterError:
                with pytest.raises(VecFilterError):
                    _port_mask(r, dev[i], nd, i, n, "arrow")
                continue
            np.testing.assert_array_equal(_port_mask(r, dev[i], nd, i, n, "arrow"), want)


def test_randomized_sweep_matches_jax(zoo, zoo_groups):  # noqa: F811
    """The 60-predicate sweep of test_device_query's TestExtendedSweep, the
    port's ladder against the JAX host engine per group."""
    host, dev, rows = zoo_groups
    rng = np.random.default_rng(77)
    ops = ["==", "!=", "<", "<=", ">", ">="]
    cols = [
        ("i32", lambda: int(rng.integers(-10, 810))),
        ("i64", lambda: int(rng.integers(-500, 500))),
        ("u32", lambda: (1 << 31) + int(rng.integers(0, 800))),
        ("f", lambda: float(rng.standard_normal())),
        ("s", lambda: f"v{int(rng.integers(0, 25))}"),
    ]
    checked = 0
    with JReader(zoo) as jr, FileReader(zoo, device="cpu") as r:
        for _ in range(60):
            conj = []
            for _ in range(int(rng.integers(1, 4))):
                name, gen = cols[int(rng.integers(0, len(cols)))]
                conj.append((name, ops[int(rng.integers(0, len(ops)))], gen()))
            filt = [conj]
            jnd, nd = j_normalize_dnf(jr.schema, filt), normalize_dnf(r.schema, filt)
            for i, n in enumerate(rows):
                try:
                    want = j_dnf_mask(host[i], jnd, n)
                except JVecFilterError:
                    continue
                np.testing.assert_array_equal(
                    _port_mask(r, dev[i], nd, i, n), want, err_msg=str(filt)
                )
                checked += 1
    assert checked >= 200


def test_counters_read_engaged_and_declined(zoo, tmp_path):  # noqa: F811
    import pyarrow as pa
    import pyarrow.parquet as pq

    parquet_tpu_torch.reset_filter_counts()
    with FileReader(zoo, device="cpu") as r:
        _cols, mask = r.read_row_group_device(0, filters=[("i32", ">", 100)])
        assert int(mask.sum()) > 0
    c = parquet_tpu_torch.filter_counts()
    assert c.get("device_filter_engaged") == 1 and not c.get("device_filter_declined")
    # PLAIN byte arrays have no resident ordering: declined, counted, and
    # the host mask (uploaded) is bit-equal
    vals = [f"row{i:04d}" for i in range(500)]
    p = str(tmp_path / "plainba.parquet")
    pq.write_table(pa.table({"s": pa.array(vals)}), p, use_dictionary=False)
    with FileReader(p, device="cpu") as r:
        _cols, mask = r.read_row_group_device(0, filters=[("s", ">=", "row0250")])
    np.testing.assert_array_equal(mask.numpy(), np.arange(500) >= 250)
    assert parquet_tpu_torch.filter_counts().get("device_filter_declined") == 1


def test_flba_filters_match_jax(tmp_path):
    """FIXED_LEN_BYTE_ARRAY columns written PLAIN reach the device as (n, w)
    uint8 rows: ==, !=, in (a member of another width included) and
    not_in masks equal the JAX package's in the row null mode, and its host
    engine's in the arrow mode; the device engine takes every group, and an
    in-list longer than MAX_MEMBERS declines to the host engine."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(13)
    pool = [bytes(rng.integers(0, 4, 4, dtype=np.uint8)) for _ in range(30)]
    req = [pool[int(k)] for k in rng.integers(0, 30, 2000)]
    opt = [None if rng.random() < 0.15 else v for v in req[::-1]]
    p = str(tmp_path / "flba.parquet")
    pq.write_table(pa.table({"f": pa.array(opt, pa.binary(4)), "r": pa.array(req, pa.binary(4))}),
                   p, use_dictionary=False, row_group_size=700)
    filters = [
        [("f", "==", pool[0])], [("r", "!=", pool[1])], [("f", "!=", pool[2])],
        [("f", "in", pool[:5] + [b"xy"])], [("f", "not_in", pool[3:9])],
        [("r", "in", pool[::3])], [("r", "not_in", [pool[7]])],
        [[("f", "in", pool[4:8]), ("r", "!=", pool[4])], [("r", "==", pool[9])]],
    ]
    parquet_tpu_torch.reset_filter_counts()
    with JReader(p) as jr, FileReader(p, device="cpu") as r:
        groups = r.num_row_groups
        assert groups == 3
        for filt in filters:
            jnd, nd = j_normalize_dnf(jr.schema, filt), normalize_dnf(r.schema, filt)
            for i in range(groups):
                _jc, jmask = jr.read_row_group_device(i, filters=filt)
                cols, mask = r.read_row_group_device(i, filters=filt)
                assert cols[("f",)].values.shape[1] == 4
                np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask), err_msg=str(filt))
                n = int(r.row_group(i).num_rows)
                host = jr._read_row_group(i, None, pack=False)
                np.testing.assert_array_equal(
                    _port_mask(r, cols, nd, i, n, "arrow"),
                    j_dnf_mask(host, jnd, n, null_mode="arrow"), err_msg=str(filt))
        c = parquet_tpu_torch.filter_counts()
        assert c.get("device_filter_engaged") == 2 * groups * len(filters)
        assert not c.get("device_filter_declined")
        many = [bytes([k, 0, 0, 0]) for k in range(P.MAX_MEMBERS)] + [pool[0]]
        _jc, jmask = jr.read_row_group_device(0, filters=[("r", "in", many)])
        _cols, mask = r.read_row_group_device(0, filters=[("r", "in", many)])
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert parquet_tpu_torch.filter_counts().get("device_filter_declined") == 1


def test_filter_columns_delivered_beyond_projection(zoo):  # noqa: F811
    with FileReader(zoo, device="cpu") as r:
        cols, mask = r.read_row_group_device(0, ["i64"], filters=[("i32", "<", 100)])
        n = int(r.row_group(0).num_rows)
        assert set(cols) == {("i64",), ("i32",)}
        assert mask.shape == (n,) and cols[("i64",)].num_values == n  # not compacted
        np.testing.assert_array_equal(mask.numpy(), np.arange(n) < 100)


# -- row-group pruning: statistics (synth) and bloom filters (JAX writer) -----------


def _synth_stats_file(path):
    n = 6000
    rng = np.random.default_rng(9)
    words = parquet_tpu_torch.ByteArrayData.from_list(
        [f"k{i:03d}".encode() for i in range(40)])
    valid = rng.random(n) > 0.2
    valid[2000:3000] = False  # an all-null group for is_null / not_null
    lengths = rng.integers(0, 4, n)
    specs = [
        ColumnSpec("id", T.INT64, values=np.arange(n, dtype=np.int64) * 3,
                   encoding=E.DELTA_BINARY_PACKED, codec=C.SNAPPY, page_version=2),
        ColumnSpec("g", T.INT32, encoding=E.RLE_DICTIONARY, valid=valid,
                   dictionary=np.arange(100, dtype=np.int32) - 50,
                   indices=(np.arange(int(valid.sum())) // 60 % 100).astype(np.int32)),
        ColumnSpec("x", T.DOUBLE, values=np.round(rng.standard_normal(n), 3)),
        ColumnSpec("s", T.BYTE_ARRAY, encoding=E.RLE_DICTIONARY, utf8=True, dictionary=words,
                   indices=(np.arange(n) // 150 % 40).astype(np.int32)),
        ColumnSpec("tags", T.INT32, encoding=E.RLE_DICTIONARY, list_lengths=lengths,
                   dictionary=np.arange(10, dtype=np.int32) * 11,
                   indices=(np.repeat(np.arange(n) // 1000, lengths) % 10).astype(np.int32)),
    ]
    write_file(path, specs, row_group_rows=1000, page_bytes=2048)
    return path


SYNTH_PREDICATES = [
    [("id", "<", 3000)],
    [("id", ">=", 14000), ("id", "<=", 15000)],
    [("id", "==", 7)],  # inside group 0's range, held by no row: statistics keep it
    [("g", "==", -50)],
    [("g", "is_null")],
    [("g", "not_null")],
    [("x", ">", 2.5)],
    [("s", "==", "k005")],
    [("s", "in", ["k001", "k039"])],
    [("s", ">=", "k030")],
    [("tags", "contains", 33)],
    [[("id", "<", 100)], [("s", "==", "k038")]],
]


def test_synth_statistics_prune_as_in_jax(tmp_path):
    """The synth writer's chunk statistics (compute_statistics) prune the
    same groups in both packages, and the port's counted walk attributes
    them to statistics."""
    path = _synth_stats_file(str(tmp_path / "stats.parquet"))
    with JReader(path) as jr, FileReader(path, device="cpu") as r:
        assert r.num_row_groups == 6
        st = r.row_group(0).columns[0].meta_data.statistics
        assert st is not None and st.min_value is not None and st.min == st.min_value
        pruned_any = False
        for filt in SYNTH_PREDICATES:
            got = r.prune_row_groups_counted(filt)
            want = jr.prune_row_groups_counted(filt)
            assert got == want, filt
            pruned_any |= got[1] > 0
        assert pruned_any


def test_bloom_pruning_matches_jax(tmp_path):
    """A file the JAX FileWriter writes with bloom filters: a value inside
    every group's [min, max] but present nowhere is pruned by the bloom
    rung in both packages; a present one survives."""
    schema = parse_schema("message m { required int64 id; required binary s (UTF8); }")
    path = str(tmp_path / "bloom.parquet")
    with JWriter(path, schema, row_group_size=1 << 30, bloom_filters=True,
                 use_dictionary=False) as w:
        for base in range(0, 4000, 1000):
            w.write_column("id", np.arange(base, base + 1000, dtype=np.int64) * 1_000_003)
            w.write_column("s", [f"name-{i}" for i in range(base, base + 1000)])
            w.flush_row_group()
    ghost = 17 * 1_000_003 + 1
    cases = [[("id", "==", 2123 * 1_000_003)], [("id", "==", ghost)],
             [("id", "in", [ghost, ghost + 1])], [("s", "==", "name-3999")],
             [("s", "==", "name-17x")]]
    with JReader(path) as jr, FileReader(path, device="cpu") as r:
        assert r.read_bloom_filter(0, "id") is not None
        for filt in cases:
            assert r.prune_row_groups_counted(filt) == jr.prune_row_groups_counted(filt), filt
        assert r.prune_row_groups([("id", "==", ghost)]) == []
        # inside group 0's [min, max] only: statistics prune three groups,
        # the bloom filter the fourth
        assert r.prune_row_groups_counted([("id", "==", ghost)]) == ([], 3, 1)
        assert r.prune_row_groups([("s", "==", "name-3999")]) == [3]
