"""ops/cull.py against the JAX package: the culled fusion's level-1 cull
(`row_activity`, on CPU tensors its plain version) against
psgradientsdf_tpu.core.volume._row_activity, the level-2 compaction
(`compact_active`, `compact_padded`) against jnp.nonzero(size=,
fill_value=) with _fuse_culled_slab's duplicate-first padding, and the two
in one call (`cull_compact`: K frames' gated culls ORed as
fuse_frames_culled ORs them, `allow` as resident_alloc ANDs its free rows
in, both padding contracts, capacity 0); then a numpy emulation of the one
kernel's plan (csrc/cull.cu cull_compact_kernel) against the plain
versions: the range table read with bit_length - 1 in place of the float
log2, the per-entry arithmetic in the kernel's order, each block's run of
mask words, the warps' counts, the offsets after the second grid barrier
and the ranked writes from the words.

Inputs are numpy scenes handed to both sides.  Every comparison is exact:
a mask entry that is wrongly culled silently drops an update, and an index
out of place moves the wrong row."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from psgradientsdf_tpu.core import volume as jvolume
from psgradientsdf_tpu_torch.ops import cull

from helpers_torch import geoms, intrinsics, se3_exp_np, wavy_frame

torch.set_num_threads(1)

ZKW = dict(zmin=0.1, zmax=5.0)


def _rot_y(deg):
    a = np.deg2rad(deg)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    return R


def _pose(R=None, t=(0.0, 0.0, 0.0)):
    T = np.eye(4)
    if R is not None:
        T[:3, :3] = R
    T[:3, 3] = t
    return T.astype(np.float32)


POSES = {
    "front": _pose(),
    "moved": se3_exp_np([0.03, -0.05, 0.02, 0.08, -0.06, 0.1]),
    # the volume entirely behind the camera
    "behind": _pose(np.diag([1.0, -1.0, -1.0])),
    # the camera inside the grid: rows cross the camera plane ("mixed")
    "mixed": _pose(t=(0.0, 0.0, 1.2)),
    # looking along the X-rows from beside the grid: rows graze the image
    "grazing": _pose(_rot_y(90.0), t=(-1.5, 0.0, 1.8)),
}


def _scene(kind):
    if kind == "32":
        H, W = 48, 64
        K = intrinsics(H, W, 50.0)
        jg, tg = geoms((32, 32, 32), 0.04, (0.013, -0.021, 1.2))
        return dict(jg=jg, tg=tg, K=K, depth=wavy_frame(H, W, K)["depth"], T=0.2)
    H, W = 96, 96
    K = intrinsics(H, W, 80.0)
    jg, tg = geoms((128, 16, 40), 0.01, (0.013, -0.021, 1.25))
    return dict(jg=jg, tg=tg, K=K, depth=wavy_frame(H, W, K)["depth"], T=0.05)


def _depth(depth, kind):
    d = depth.copy()
    if kind == "holes":
        d[:5, :7] = 0.0
        d[20:23, :] = 0.0
    elif kind == "nan":
        d[3:9, 10:30] = np.nan
        d[-2:, :] = np.nan
    elif kind == "none":
        d[:] = 0.0
    elif kind == "far":
        d[:] = 9.0                      # past zmax: nothing valid
    return d


def _slabs(jg, mode, n=4):
    """[(z0, z_rows, z_idx)] of a grid's slabs: the whole grid, n
    contiguous slabs or n interleaved ones."""
    Z = jg.dims[2]
    if mode == "whole":
        return [(None, None, None)]
    Zl = Z // n
    if mode == "z0":
        return [(k * Zl, Zl, None) for k in range(n)]
    return [(None, Zl, np.arange(k, Z, n, dtype=np.int32)) for k in range(n)]


def _both(sc, depth, pose, *, seg_x=None, z0=None, z_rows=None, z_idx=None,
          margin_px=0.0, margin_t=0.0):
    kw = dict(truncation=sc["T"], seg_x=seg_x, z_rows=z_rows,
              margin_px=margin_px, margin_t=margin_t, **ZKW)
    want = np.asarray(jvolume._row_activity(
        sc["jg"], jnp.asarray(depth), jnp.asarray(sc["K"]), jnp.asarray(pose),
        z0=None if z0 is None else jnp.asarray(z0, jnp.int32),
        z_idx=None if z_idx is None else jnp.asarray(z_idx), **kw))
    got = cull.row_activity(
        sc["tg"], torch.from_numpy(depth), torch.from_numpy(sc["K"]),
        torch.from_numpy(pose), z0=z0,
        z_idx=None if z_idx is None else torch.from_numpy(z_idx), **kw)
    return got, want


CULL_CASES = [
    # (scene, pose, depth, seg_x, slabs, margins)
    (s, p, "holes", None, "whole", (0.0, 0.0)) for s in ("32", "128") for p in POSES
] + [
    ("32", p, "holes", 8, "whole", (0.0, 0.0)) for p in POSES
] + [
    ("32", p, "holes", seg, slabs, (0.0, 0.0))
    for p in ("moved", "mixed") for seg in (None, 8) for slabs in ("z0", "interleaved")
] + [
    ("32", p, "holes", seg, "whole", (16.0, 0.05))
    for p in ("moved", "mixed", "grazing") for seg in (None, 8)
] + [
    ("32", p, d, None, "whole", (0.0, 0.0))
    for p in ("front", "mixed") for d in ("nan", "none", "far")
] + [
    ("128", "moved", "nan", 8, "interleaved", (3.0, 0.02)),
]


@pytest.mark.parametrize("scene,pose,depth,seg_x,slabs,margins", CULL_CASES)
def test_row_activity_matches_jax(scene, pose, depth, seg_x, slabs, margins):
    sc = _scene(scene)
    d = _depth(sc["depth"], depth)
    for z0, z_rows, z_idx in _slabs(sc["jg"], slabs):
        got, want = _both(sc, d, POSES[pose], seg_x=seg_x, z0=z0,
                          z_rows=z_rows, z_idx=z_idx, margin_px=margins[0],
                          margin_t=margins[1])
        assert got.dtype == torch.bool and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        if depth in ("none", "far") and pose == "front":
            assert not want.any()


def test_the_cases_cull_and_keep_rows():
    """The poses do what their names say on the 32^3 scene: some rows kept,
    some culled; all culled behind the camera; along the rows, every row
    seen end on is kept."""
    sc = _scene("32")
    d = _depth(sc["depth"], "holes")
    kept = {p: int(_both(sc, d, POSES[p])[1].sum()) for p in POSES}
    n = 32 * 32
    assert kept["behind"] == 0
    for p in ("front", "moved", "mixed"):
        assert 0 < kept[p] < n, (p, kept)
    assert kept["grazing"] > 0


@pytest.mark.parametrize("gate", [True, False])
def test_the_gate_and_the_union_on_the_cpu(gate):
    """gate is ANDed into the mask; union receives the OR in place."""
    sc = _scene("32")
    d = torch.from_numpy(_depth(sc["depth"], "holes"))
    K = torch.from_numpy(sc["K"])
    kw = dict(truncation=sc["T"], **ZKW)
    a = cull.row_activity(sc["tg"], d, K, torch.from_numpy(POSES["front"]), **kw)
    b = cull.row_activity(sc["tg"], d, K, torch.from_numpy(POSES["mixed"]), **kw)
    g = torch.tensor(gate)
    gated = cull.row_activity(sc["tg"], d, K, torch.from_numpy(POSES["front"]),
                              gate=g, **kw)
    assert torch.equal(gated, a & g)
    union = a.clone()
    out = cull.row_activity(sc["tg"], d, K, torch.from_numpy(POSES["mixed"]),
                            gate=g, union=union, **kw)
    assert out is union
    assert torch.equal(union, a | (b & g))


# ------------------------------------------------------------ compaction


def _flags(kind, n, cap):
    f = np.zeros(n, bool)
    rng = np.random.default_rng(n + cap)
    if kind == "one":
        f[n // 3] = True
    elif kind == "exact":
        f[rng.choice(n, cap, replace=False)] = True
    elif kind == "over":
        f[rng.choice(n, cap + 1, replace=False)] = True
    elif kind == "all":
        f[:] = True
    elif kind == "last":
        f[-1] = True
    elif kind == "random":
        f = rng.random(n) < 0.3
    return f


def _jax_compaction(flags, cap):
    """jnp.nonzero(size=, fill_value=NSEG) and _fuse_culled_slab's
    duplicate-first padding (psgradientsdf_tpu/core/volume.py:513-525)."""
    nseg = flags.shape[0]
    af = jnp.asarray(flags)
    n_active = jnp.sum(af.astype(jnp.int32))
    overflow = n_active > cap
    (rows_idx,) = jnp.nonzero(af, size=cap, fill_value=nseg)
    slot_ok = rows_idx < nseg
    first = jnp.minimum(rows_idx[0], nseg - 1)
    safe_rows = jnp.where(slot_ok, jnp.minimum(rows_idx, nseg - 1), first)
    return (np.asarray(rows_idx), int(n_active), np.asarray(safe_rows),
            bool(overflow))


COMPACT_CASES = [(k, n, cap) for k in ("none", "one", "exact", "over", "all",
                                       "last", "random")
                 for n, cap in ((1024, 64), (1000, 1), (40 * 16, 320), (97, 97))]


@pytest.mark.parametrize("kind,n,cap", COMPACT_CASES)
def test_compaction_matches_jax_nonzero(kind, n, cap):
    if kind == "over" and cap + 1 > n:
        cap = n - 1
    flags = _flags(kind, n, cap)
    idx, n_active, safe, overflow = _jax_compaction(flags, cap)
    t = torch.from_numpy(flags)
    got_idx, got_n = cull.compact_active(t, cap)
    assert got_idx.dtype == torch.int64 and got_n.dtype == torch.int64
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    assert int(got_n) == n_active == int(flags.sum())
    p_idx, live, over = cull.compact_padded(t, cap)
    assert p_idx.dtype == torch.int32
    np.testing.assert_array_equal(p_idx.numpy(), safe)
    assert int(live) == max(n_active, 1)
    assert bool(over) == overflow == (n_active > cap)


def test_capacity_zero_counts_only():
    flags = _flags("random", 500, 0)
    idx, n = cull.compact_active(torch.from_numpy(flags), 0)
    assert idx.shape == (0,) and int(n) == int(flags.sum())


# ------------------------------------ the cull and the compaction in one call


def _jax_cull_compact(sc, depths, poses, cap, *, gates=None, allow=None, z0=None,
                      z_rows=None, z_idx=None, seg_x=None, margins=(0.0, 0.0)):
    """The JAX package's culls of K frames, each ANDed with its gate, ORed
    as fuse_frames_culled ORs them (psgradientsdf_tpu/core/volume.py
    :714-723), allow ANDed in, then jnp.nonzero(size=, fill_value=NSEG) and
    the duplicate-first padding (_jax_compaction) -> (mask, rows_idx,
    n_active, safe_rows, overflow); no slot at capacity 0."""
    acts = []
    for k in range(depths.shape[0]):
        a = jvolume._row_activity(
            sc["jg"], jnp.asarray(depths[k]), jnp.asarray(sc["K"]),
            jnp.asarray(poses[k]), truncation=sc["T"], seg_x=seg_x, z_rows=z_rows,
            z0=None if z0 is None else jnp.asarray(z0, jnp.int32),
            z_idx=None if z_idx is None else jnp.asarray(z_idx),
            margin_px=margins[0], margin_t=margins[1], **ZKW)
        acts.append(a & jnp.asarray(gates[k]) if gates is not None else a)
    active = jnp.any(jnp.stack(acts), axis=0)
    flat = active.reshape(-1)
    if allow is not None:
        flat = flat & jnp.asarray(allow)
    mask = np.asarray(flat).reshape(active.shape)
    if cap == 0:
        return mask, None, int(jnp.sum(flat.astype(jnp.int32))), None, None
    rows_idx, n_active, safe, overflow = _jax_compaction(np.asarray(flat), cap)
    return mask, rows_idx, n_active, safe, overflow


JAX_CASES = {
    "rows": dict(frames=[("moved", "holes")]),
    "segments": dict(frames=[("moved", "holes")], seg_x=8),
    "contiguous slabs": dict(frames=[("mixed", "holes")], slabs="z0"),
    "interleaved slabs, segments": dict(frames=[("moved", "holes")],
                                        slabs="interleaved", seg_x=8),
    "margins": dict(frames=[("grazing", "holes")], margins=(16.0, 0.05)),
    "a False gate": dict(frames=[("front", "holes")], gates=(False,)),
    "NaN depths": dict(frames=[("mixed", "nan")]),
    "capacity 0": dict(frames=[("front", "holes")], cap=0),
    "exact capacity": dict(frames=[("moved", "holes")], cap="active"),
    "over capacity": dict(frames=[("mixed", "holes")], cap="over"),
    "K-frame union": dict(frames=[("front", "holes"), ("moved", "nan"),
                                  ("mixed", "holes")], gates=(True, False, True)),
    "K-frame union, no gates, 128": dict(
        scene="128", frames=[("front", "holes"), ("moved", "holes"),
                             ("grazing", "nan"), ("mixed", "holes")], cap="over"),
    "K-frame union, capacity 0": dict(frames=[(p, "holes") for p in POSES], cap=0),
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_cull_compact_matches_jax(name):
    """cull_compact on CPU tensors (cull_compact_plain) against the JAX
    package's cull, union and compaction: the mask, both padding contracts
    and the scalars, exactly."""
    case = JAX_CASES[name]
    sc = _scene(case.get("scene", "32"))
    depths = np.stack([_depth(sc["depth"], d) for _, d in case["frames"]])
    poses = np.stack([POSES[p] for p, _ in case["frames"]])
    gates = case.get("gates")
    margins = case.get("margins", (0.0, 0.0))
    for z0, z_rows, z_idx in _slabs(sc["jg"], case.get("slabs", "whole")):
        kw = dict(seg_x=case.get("seg_x"), z0=z0, z_rows=z_rows, z_idx=z_idx)
        mask, *_ = _jax_cull_compact(sc, depths, poses, 0, gates=gates,
                                     margins=margins, **kw)
        active = int(mask.sum())
        cap = case.get("cap", 64)
        cap = {"active": active, "over": max(active - 1, 0)}.get(cap, cap)
        want_mask, idx, n_active, safe, overflow = _jax_cull_compact(
            sc, depths, poses, cap, gates=gates, margins=margins, **kw)
        assert n_active == active
        for padded in (True, False):
            got = cull.cull_compact(
                sc["tg"], torch.from_numpy(depths), torch.from_numpy(sc["K"]),
                torch.from_numpy(poses), capacity=cap, padded=padded,
                truncation=sc["T"], margin_px=margins[0], margin_t=margins[1],
                gates=None if gates is None else torch.tensor(gates), mask=True,
                **dict(kw, z_idx=None if z_idx is None else torch.from_numpy(z_idx)),
                **ZKW)
            np.testing.assert_array_equal(got.mask.numpy(), want_mask)
            assert got.idx.dtype == (torch.int32 if padded else torch.int64)
            assert got.idx.shape == (cap,)
            if cap:
                np.testing.assert_array_equal(got.idx.numpy(), safe if padded else idx)
            assert int(got.n_active) == n_active
            assert int(got.live) == max(n_active, 1)
            assert bool(got.overflow) == (n_active > cap)
        if gates is not None and not any(gates):
            assert active == 0


@pytest.mark.parametrize("seg_x,margins", [(None, (0.0, 0.0)), (8, (16.0, 0.05))])
def test_allow_is_resident_allocs_new_rows(seg_x, margins):
    """cull_compact(allow=row_slot >= CAPR, padded=False) is the JAX
    package's resident_alloc: its cull ANDed with the rows that hold no
    slot, then jnp.nonzero(size=delta_capacity, fill_value=NSEG)
    (psgradientsdf_tpu/core/resident.py :264-268)."""
    from psgradientsdf_tpu.core import resident as jresident

    sc = _scene("32")
    d = _depth(sc["depth"], "holes")
    X = sc["jg"].dims[0]
    S = X if seg_x is None else seg_x
    nseg = 32 * 32 * (X // S)
    capr = nseg // 4
    rng = np.random.default_rng(nseg)
    row_slot = np.full(nseg, capr, np.int32)
    row_slot[rng.choice(nseg, capr, replace=False)] = np.arange(capr, dtype=np.int32)
    act = jresident._act_flat(
        sc["jg"], jnp.asarray(d), jnp.asarray(sc["K"]), jnp.asarray(POSES["moved"]),
        truncation=sc["T"], S=S, margin_px=margins[0], margin_t=margins[1], **ZKW)
    new_mask = act & (jnp.asarray(row_slot) >= capr)
    n_new = int(jnp.sum(new_mask.astype(jnp.int32)))
    assert 0 < n_new < int(jnp.sum(act.astype(jnp.int32)))
    for delta in (nseg // 8, n_new, n_new - 1, 0):
        (didx,) = jnp.nonzero(new_mask, size=delta, fill_value=nseg)
        got = cull.cull_compact(
            sc["tg"], torch.from_numpy(d), torch.from_numpy(sc["K"]),
            torch.from_numpy(POSES["moved"]), capacity=delta, padded=False,
            truncation=sc["T"], seg_x=seg_x, margin_px=margins[0],
            margin_t=margins[1], allow=torch.from_numpy(row_slot) >= capr, **ZKW)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(didx))
        assert int(got.n_active) == n_new
        assert got.mask is None
        assert bool(got.overflow) == (n_new > delta)


# ------------------------------------------- the kernels' plans, emulated


def _table(row_max):
    """The plain version's sparse table of range maxima, [levels, H]."""
    H = row_max.shape[0]
    levels = cull.table_levels(H)
    st = [row_max]
    for lv in range(1, levels):
        half = 1 << (lv - 1)
        st.append(np.maximum(st[-1], st[-1][np.minimum(np.arange(H) + half, H - 1)]))
    return np.stack(st)


def _query(st, v_lo, v_hi, k):
    return np.maximum(st[k, v_lo], st[k, np.maximum(v_hi - (1 << k) + 1, 0)])


def test_bit_length_equals_the_float_log2_for_every_span():
    """k = floor(log2(float32(span)) + 1e-6) (the plain version, in numpy and
    in torch float32) is bit_length(span) - 1 = 31 - clz(span) (the kernel)
    for every span 1..8192."""
    span = np.arange(1, 8193, dtype=np.int64)
    want = np.array([int(s).bit_length() - 1 for s in span])
    k_np = np.floor(np.log2(span.astype(np.float32)) + np.float32(1e-6))
    np.testing.assert_array_equal(k_np.astype(np.int64), want)
    k_t = torch.floor(torch.log2(torch.from_numpy(span).to(torch.int32).to(torch.float32))
                      + 1e-6).to(torch.int64)
    np.testing.assert_array_equal(k_t.numpy(), want)


@pytest.mark.parametrize("H", [1, 2, 3, 7, 8, 9, 48, 96, 480])
def test_the_range_table_gives_the_range_maximum(H):
    """Read at level bit_length(span) - 1 (clamped to the table's levels),
    the table gives max(row_max[v_lo..v_hi]) for every range of the image,
    as the plain version's float-log2 reading does."""
    rng = np.random.default_rng(H)
    row_max = rng.uniform(0.5, 3.0, H).astype(np.float32)
    row_max[rng.random(H) < 0.3] = -np.inf
    st = _table(row_max)
    levels = st.shape[0]
    pairs = [(a, b) for a in range(H) for b in range(a, H)]
    if len(pairs) > 20000:
        pairs = [pairs[i] for i in rng.choice(len(pairs), 20000, replace=False)]
    lo = np.array([a for a, _ in pairs])
    hi = np.array([b for _, b in pairs])
    span = hi - lo + 1
    k_bits = np.minimum(np.array([int(s).bit_length() - 1 for s in span]), levels - 1)
    k_log = np.clip(np.floor(np.log2(span.astype(np.float32)) + np.float32(1e-6)),
                    0, levels - 1).astype(np.int64)
    np.testing.assert_array_equal(k_bits, k_log)
    got = _query(st, lo, hi, k_bits)
    want = np.array([row_max[a:b + 1].max() for a, b in pairs])
    np.testing.assert_array_equal(got, want)
    # the image's maximum, as the kernel reads it: two windows of the top level
    assert row_max.max() == max(st[-1, 0], st[-1, H - (1 << (levels - 1))])


def _grouped_table(row_max):
    """csrc/cull.cu build_levels' table: three levels a block barrier, level
    b + j the max of 2^j windows of level b (st[b][min(i + t 2^b, H-1)], t <
    2^j), all eight windows read at once."""
    H = row_max.shape[0]
    levels = cull.table_levels(H)
    st = np.full((levels, H), np.nan, np.float32)
    st[0] = row_max
    r = np.arange(H)
    for b in range(0, levels - 1, 3):
        q, top = 1 << b, min(3, levels - 1 - b)
        v = [st[b][np.minimum(r + t * q, H - 1)] for t in range(8)]
        m1 = np.maximum(v[0], v[1])
        m2 = np.maximum(m1, np.maximum(v[2], v[3]))
        m3 = np.maximum(m2, np.maximum(np.maximum(v[4], v[5]), np.maximum(v[6], v[7])))
        for j, m in ((1, m1), (2, m2), (3, m3)):
            if j <= top:
                st[b + j] = m
    return st


@pytest.mark.parametrize("H", [1, 2, 3, 4, 5, 9, 17, 48, 96, 257, 480, 960])
def test_the_kernels_table_build_gives_the_plain_table(H):
    """Three levels a barrier build the plain version's level-by-level table
    bit for bit (max is exact), every level, the image's maximum included."""
    rng = np.random.default_rng(H + 1)
    row_max = rng.uniform(0.5, 3.0, H).astype(np.float32)
    row_max[rng.random(H) < 0.3] = -np.inf
    got = _grouped_table(row_max)
    np.testing.assert_array_equal(got, _table(row_max))
    levels = got.shape[0]
    assert row_max.max() == max(got[-1, 0], got[-1, H - (1 << (levels - 1))])


def _f(x):
    return np.float32(x)


def _entry_acts(sc, depth, pose, *, seg_x=None, z0=None, z_rows=None,
                z_idx=None, margin_px=0.0, margin_t=0.0):
    """One frame's cull as cull_compact_kernel computes it, in numpy
    float32, entry by entry (a thread an entry, each operation rounded
    once): the row maxima, the range table read with bit_length - 1, the
    image's maximum for the mixed rows -> (flat mask [n], its shape)."""
    g = sc["tg"]
    X, Y, Zd = g.dims
    zr = Zd if z_rows is None else z_rows
    S = X if seg_x is None else seg_x
    NS = X // S
    H, W = depth.shape
    K = sc["K"]
    P = pose.astype(np.float32)
    zmin, zmax = _f(ZKW["zmin"]), _f(ZKW["zmax"])
    with np.errstate(invalid="ignore"):
        valid = (depth > zmin) & (depth < zmax)
    row_max = np.where(valid, depth, -np.inf).max(axis=1).astype(np.float32)
    st = _table(row_max)
    levels = st.shape[0]
    image_max = row_max.max()
    # the kernel reads it off the table's top level: two windows cover the image
    assert image_max == max(st[-1, 0], st[-1, H - (1 << (levels - 1))])
    ox, oy, oz = (_f(o) for o in g.origin)
    h, T = _f(g.voxel_size), _f(sc["T"])
    fx, cx, fy, cy = K[0, 0], K[0, 2], K[1, 1], K[1, 2]
    n = zr * Y * NS
    e = np.arange(n)
    zl = e // (Y * NS)
    rest = e - zl * (Y * NS)
    y = rest // NS
    s = rest - y * NS
    if z_idx is not None:
        zi = z_idx.astype(np.float32)[zl]
    else:
        zi = zl.astype(np.float32)
        if z0 is not None:
            zi = zi + _f(z0)
    dy = (oy + h * y.astype(np.float32)) - P[1, 3]
    dz = (oz + h * zi) - P[2, 3]
    x0 = s.astype(np.float32) * _f(S)
    x1 = x0 + _f(S - 1)

    def cam(xw):
        dx = (ox + h * xw) - P[0, 3]
        col = [((P[0, c] * dx + P[1, c] * dy) + P[2, c] * dz) for c in range(3)]
        return col

    p0x, p0y, pz0 = cam(x0)
    p1x, p1y, pz1 = cam(x1)
    eps = (np.abs(pz0) + np.abs(pz1)) * _f(1e-5) + _f(1e-6)
    behind = eps - _f(margin_t)
    both_behind = (pz0 <= behind) & (pz1 <= behind)
    both_front = (pz0 > eps) & (pz1 > eps)
    mixed = ~both_behind & ~both_front
    sz0 = np.where(pz0 > 0, pz0, _f(1.0))
    sz1 = np.where(pz1 > 0, pz1, _f(1.0))
    u0, u1 = cx + (fx * p0x) / sz0, cx + (fx * p1x) / sz1
    v0, v1 = cy + (fy * p0y) / sz0, cy + (fy * p1y) / sz1
    mu = ((np.abs(u0) + np.abs(u1)) * _f(1e-5) + _f(0.01)) + _f(margin_px)
    mv = ((np.abs(v0) + np.abs(v1)) * _f(1e-5) + _f(0.01)) + _f(margin_px)
    u_min, u_max = np.minimum(u0, u1) - mu, np.maximum(u0, u1) + mu
    v_min, v_max = np.minimum(v0, v1) - mv, np.maximum(v0, v1) + mv
    img = ((u_max > _f(-1.5)) & (u_min < _f(W - 0.5)) & (v_max > _f(-1.5))
           & (v_min < _f(H - 0.5)))
    v_lo = np.clip(np.floor(v_min - _f(1.0)), 0, H - 1).astype(np.int64)
    v_hi = np.clip(np.ceil(v_max + _f(1.0)), 0, H - 1).astype(np.int64)
    span = np.maximum(v_hi - v_lo + 1, 1)
    k = np.minimum(np.array([int(q).bit_length() - 1 for q in span]), levels - 1)
    z_fp = np.where(mixed, image_max, _query(st, v_lo, v_hi, k))
    pz_min = np.minimum(pz0, pz1) - eps
    carve = ((pz_min - T) - _f(margin_t)) <= z_fp
    act = ~both_behind & (img | mixed) & carve
    for a in (eps, u0, v0, mu, pz_min):
        assert a.dtype == np.float32
    shape = (zr, Y) if seg_x is None else (zr, Y, NS)
    return act, shape


def _emulate_plan(n, sms, cap, padded, *, acts=None, gates=None, flags=None,
                  allow=None, H=0):
    """cull_compact_kernel's plan in numpy: each block's contiguous run of
    32-entry groups (cull_compact_blocks, cull_compact_run), its mask words
    (the gated frames' culls ORed, or a caller's flags; allow ANDed in), the
    warps' contiguous shares of the words with their counts and first set
    entries, the blocks' exclusive offsets after grid barrier 2, each warp's
    ranked writes from its words, the padding and the scalars -> (mask [n],
    idx [cap], n_active, live, overflow)."""
    frames = 0 if acts is None else len(acts)
    blocks = cull.cull_compact_blocks(H, frames, n, sms)
    run = cull.cull_compact_run(n, blocks)
    assert run % 32 == 0 and blocks * run >= n
    mask = np.zeros(n, bool)
    runs = []                          # (begin, words [groups, 32], warp spans)
    counts, firsts = [], []
    for b in range(blocks):
        begin = min(b * run, n)
        end = min(begin + run, n)
        groups = -(-(end - begin) // 32)
        e = begin + np.arange(groups * 32)
        inside = e < end
        at = np.minimum(e, n - 1)
        if flags is not None:
            bits = inside & flags[at]
        else:
            bits = np.zeros(groups * 32, bool)
            for k in range(frames):
                if gates is None or gates[k]:      # a False gate skips the frame
                    bits |= inside & acts[k][at]
        if allow is not None:
            bits &= inside & allow[at]
        mask[begin:end] = bits[:end - begin]
        words = bits.reshape(groups, 32)
        per_warp = -(-groups // cull.WARPS)
        spans = []
        for w in range(cull.WARPS):
            wb = min(w * per_warp, groups)
            spans.append((wb, min(wb + per_warp, groups)))
        w_counts = [int(words[a:z].sum()) for a, z in spans]
        w_firsts = [begin + a * 32 + int(np.argmax(words[a:z].reshape(-1)))
                    if words[a:z].any() else n for a, z in spans]
        counts.append(sum(w_counts))
        firsts.append(min(w_firsts))
        runs.append((begin, words, spans, w_counts))
    total = sum(counts)
    first = min(firsts)
    idx = np.full(cap, -1, np.int64)
    for b, (begin, words, spans, w_counts) in enumerate(runs):
        for w, (a, z) in enumerate(spans):
            base = sum(counts[:b]) + sum(w_counts[:w])
            bits = words[a:z].reshape(-1)
            ranks = base + np.cumsum(bits) - bits
            put = bits & (ranks < cap)
            idx[ranks[put]] = begin + a * 32 + np.flatnonzero(put)
    fill = (first if total > 0 else n - 1) if padded else n
    idx[min(total, cap):] = fill
    assert (idx >= 0).all()
    return mask, idx, total, max(total, 1), total > cap


def _check_plan_against_plain(plain, emulated):
    np.testing.assert_array_equal(emulated[0], plain.mask.reshape(-1).numpy())
    np.testing.assert_array_equal(emulated[1], plain.idx.numpy())
    assert emulated[2:] == (int(plain.n_active), int(plain.live), bool(plain.overflow))


EMULATED = [dict(scene="32", frames=[(p, "holes")]) for p in POSES] + [
    dict(scene="32", frames=[("moved", "nan")], seg_x=8, slabs="z0"),
    dict(scene="32", frames=[("mixed", "holes")], seg_x=8, slabs="interleaved",
         margins=(16.0, 0.05)),
    dict(scene="32", frames=[("grazing", "none")]),
    dict(scene="128", frames=[("moved", "holes")]),
    dict(scene="128", frames=[("mixed", "holes")], seg_x=8, slabs="z0",
         margins=(3.0, 0.02)),
    # the K-frame union (gated), an allow array, a False gate; few SMs
    dict(scene="32", frames=[("front", "holes"), ("moved", "nan"), ("mixed", "holes")],
         gates=(True, False, True), sms=3),
    dict(scene="32", frames=[(p, "holes") for p in POSES], seg_x=8, sms=1),
    dict(scene="128", frames=[("moved", "holes"), ("mixed", "nan")], allow=0.6),
    dict(scene="32", frames=[("front", "holes")], gates=(False,)),
    dict(scene="128", frames=[("front", "holes"), ("grazing", "holes")], seg_x=8,
         slabs="interleaved", allow=0.3, sms=7),
]


def _case_id(c):
    parts = [c["scene"], "+".join(f"{p}/{d}" for p, d in c["frames"])]
    for k in ("seg_x", "slabs", "margins", "gates", "allow", "sms"):
        if k in c:
            parts.append(f"{k}={c[k]}")
    return "-".join(str(p) for p in parts)


@pytest.mark.parametrize("case", EMULATED, ids=[_case_id(c) for c in EMULATED])
def test_the_cull_compact_plan_culls_as_the_plain_version(case):
    """The merged kernel's plan with its cull (cull_compact_kernel<true>):
    the K frames' entries as the kernel computes them, ORed into the runs'
    words, and the compaction from the words, against cull_compact_plain
    (mask, both padding contracts, scalars) at the active count, one below
    it (an overflow), a fixed capacity and 0."""
    sc = _scene(case["scene"])
    sms = case.get("sms", 132)
    margins = case.get("margins", (0.0, 0.0))
    gates = case.get("gates")
    depths = np.stack([_depth(sc["depth"], d) for _, d in case["frames"]])
    poses = np.stack([POSES[p] for p, _ in case["frames"]])
    for z0, z_rows, z_idx in _slabs(sc["jg"], case.get("slabs", "whole")):
        kw = dict(seg_x=case.get("seg_x"), z0=z0, z_rows=z_rows,
                  margin_px=margins[0], margin_t=margins[1])
        acts = []
        for k in range(len(depths)):
            act, shape = _entry_acts(sc, depths[k], poses[k], z_idx=z_idx, **kw)
            acts.append(act)
        n = acts[0].shape[0]
        allow = None
        if "allow" in case:
            allow = np.random.default_rng(n).random(n) < case["allow"]
        union = np.zeros(n, bool)
        for k, act in enumerate(acts):
            union |= act & (gates is None or gates[k])
        active = int((union & (True if allow is None else allow)).sum())
        for cap in sorted({active, max(active - 1, 0), 37, 0}):
            for padded in (True, False):
                plain = cull.cull_compact_plain(
                    sc["tg"], torch.from_numpy(depths), torch.from_numpy(sc["K"]),
                    torch.from_numpy(poses), capacity=cap, padded=padded,
                    truncation=sc["T"], mask=True,
                    z_idx=None if z_idx is None else torch.from_numpy(z_idx),
                    gates=None if gates is None else torch.tensor(gates),
                    allow=None if allow is None else torch.from_numpy(allow),
                    **kw, **ZKW)
                assert tuple(plain.mask.shape) == shape
                _check_plan_against_plain(plain, _emulate_plan(
                    n, sms, cap, padded, acts=acts, gates=gates, allow=allow,
                    H=depths.shape[1]))


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("kind,n,cap", [
    ("random", 16384, 8192), ("random", 16384, 3000), ("none", 4096, 128),
    ("one", 4096, 128), ("all", 2000, 2000), ("last", 1001, 10),
    ("exact", 640, 320), ("over", 640, 320), ("random", 100003, 50000)])
def test_the_cull_compact_plan_compacts_as_the_plain_version(sms, kind, n, cap):
    """The merged kernel's plan without its cull (cull_compact_kernel<false>,
    compact_active and compact_padded alone): a caller's flags into the
    runs' words, against the plain compactions."""
    flags = _flags(kind, n, cap)
    t = torch.from_numpy(flags)
    idx, n_act = cull.compact_active_plain(t, cap)
    safe, live, over = cull.compact_padded_plain(t, cap)
    e_mask, e_idx, e_total, e_live, e_over = _emulate_plan(n, sms, cap, False,
                                                           flags=flags)
    np.testing.assert_array_equal(e_mask, flags)
    np.testing.assert_array_equal(e_idx, idx.numpy())
    assert e_total == int(n_act)
    _, p_idx, _, p_live, p_over = _emulate_plan(n, sms, cap, True, flags=flags)
    np.testing.assert_array_equal(p_idx, safe.numpy())
    assert p_live == int(live) == e_live and p_over == bool(over) == e_over


def test_launch_plans_stay_within_one_block_an_sm():
    """One block an SM at most, no more than give each warp a group or an
    image row, and the shared memory (a frame's table and a run's words) of
    every shape the port culls within the limit on 132 SMs."""
    for n in (1, 31, 32, 33, 16384, 262144, 2097152):
        b = cull.cull_compact_blocks(0, 0, n, 132)
        assert 1 <= b <= 132
        groups = -(-n // 32)
        assert b <= max(1, -(-groups // cull.WARPS))
        assert cull.cull_compact_run(n, b) * b >= n
    # 640x480 into 16384 rows: 32 blocks, as PR 21's two plans gave
    assert cull.cull_compact_blocks(480, 1, 16384, 132) == 32
    assert cull.cull_compact_blocks(960, 1, 262144, 132) == 132
    assert cull.cull_compact_blocks(48, 1, 1, 132) == 3
    assert cull.cull_compact_blocks(480, 8, 16384, 132) == 132
    for H, K, n in ((480, 1, 16384), (960, 1, 16384), (480, 1, 262144),
                    (480, 1, 2097152), (480, 8, 16384), (960, 8, 16384), (48, 40, 1024)):
        blocks = cull.cull_compact_blocks(H, K, n, 132)
        kp = cull.cull_compact_pass(H, K, n, blocks)
        assert 1 <= kp <= min(K, cull.MAX_PASS)
        assert cull.cull_compact_smem(H, K, n, blocks) <= cull.MAX_SHARED_BYTES
    # the 8 frames of a K-batch at 640x480 in one pass, at 1280x960 in two
    assert cull.cull_compact_pass(480, 8, 16384, 132) == 8
    assert cull.cull_compact_pass(960, 8, 16384, 132) == 5
    assert cull.cull_compact_pass(0, 0, 16384, 132) == 0
    # 512^3 rows: 63 words a block
    assert cull.cull_compact_run(262144, 132) // 32 == 63


# --------------------------------------------------- no fallback off the CPU


def test_wrappers_raise_off_the_cpu_instead_of_falling_back(monkeypatch):
    """A tensor that does not lie on the CPU goes to the kernel: here (meta
    tensors, no card, no library) the launch raises; no plain version runs
    and no launch is counted."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran for a tensor off the CPU")

    def no_library():
        raise RuntimeError("no kernel library here")

    for name in ("row_activity_plain", "compact_active_plain", "compact_padded_plain",
                 "cull_compact_plain"):
        monkeypatch.setattr(cull, name, refuse)
    monkeypatch.setattr(cull, "_library", no_library)
    cull.reset_launch_counts()
    sc = _scene("32")
    m = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device="meta")
    with pytest.raises(RuntimeError, match="no kernel library"):
        cull.row_activity(sc["tg"], m(48, 64), m(3, 3), m(4, 4), truncation=0.2,
                          gate=m(dtype=torch.bool), **ZKW)
    with pytest.raises(RuntimeError, match="no kernel library"):
        cull.cull_compact(sc["tg"], m(8, 48, 64), m(3, 3), m(8, 4, 4), capacity=64,
                          padded=True, truncation=0.2, gates=m(8, dtype=torch.bool),
                          allow=m(1024, dtype=torch.bool), mask=True, **ZKW)
    flags = m(1024, dtype=torch.bool)
    for fn in (cull.compact_active, cull.compact_padded):
        with pytest.raises(RuntimeError, match="no kernel library"):
            fn(flags, 64)
    assert cull.launch_counts == {"cull_compact": 0}
    with pytest.raises(TypeError):
        cull.compact_active(m(1024, dtype=torch.int32), 64)
