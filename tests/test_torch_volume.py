"""core/volume.py of the PyTorch package against the JAX package: full-grid
fusion, the conservative row cull and its compaction, the row-culled fusion
with both row-movement engines, the queries and the visibility helpers.

Inputs are numpy scenes handed to both sides.  Tolerances:
  * masks, compacted indices, overflow flags and visibility words: exact;
  * dist after a fused frame: within 4 float32 ULPs of the scene's depth per
    fused frame; weight, colour and grad within the same bound divided by the
    truncation (helpers_torch.field_tolerances says why) — the two compilers
    contract multiply-adds differently, nothing else differs.  The scenes
    keep the principal point and the grid off the pixel lattice, so that no
    voxel projects within an ULP of a pixel boundary, where the reference's
    int-cast rounding would pick different pixels on the two sides;
  * the JAX side's rows_impl="pallas" reaches the Pallas row-copy kernels
    only when a state row is a multiple of 128 floats, hence the
    (128, 16, 40) grid; on the 32^3 grid the JAX side runs rows_impl="xla".
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from psgradientsdf_tpu.core import volume as jvolume
from psgradientsdf_tpu_torch import convert
from psgradientsdf_tpu_torch.core import volume as tvolume

from helpers_torch import (
    CPU, FIELDS, assert_vol_close, fuse_both, geoms, intrinsics, se3_exp_np,
    field_tolerances, to_torch_vol, vol_to_numpy_j, wavy_frame,
)

torch.set_num_threads(1)

ULPS_PER_FRAME = 4
DEPTH = 1.5            # the scenes' depths lie in [1, 2): one ULP is 2^-23
ZKW = dict(zmin=0.1, zmax=5.0)


def _poses():
    rng = np.random.default_rng(7)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(3):
        xi = rng.uniform(-1, 1, 6) * np.array([0.1, 0.1, 0.1, 0.2, 0.2, 0.2])
        poses.append(se3_exp_np(xi))
    flip = np.eye(4, dtype=np.float32)          # volume behind the camera
    flip[:3, :3] = np.diag([1, -1, -1]).astype(np.float32)
    poses.append(flip)
    inside = np.eye(4, dtype=np.float32)        # rows cross the camera plane
    inside[:3, 3] = [0.0, 0.0, 1.2]
    poses.append(inside)
    return poses


def _scene32():
    H, W = 48, 64
    K = intrinsics(H, W, 50.0)
    jg, tg = geoms((32, 32, 32), 0.04, (0.013, -0.021, 1.2))
    return dict(jg=jg, tg=tg, K=K, fr=wavy_frame(H, W, K), T=5 * 0.04)


def _scene128():
    """X = 128 voxels per row: the JAX side's Pallas kernels take the rows."""
    H, W = 48, 64
    K = intrinsics(H, W, 50.0)
    jg, tg = geoms((128, 16, 40), 0.01, (0.013, -0.021, 1.25))
    return dict(jg=jg, tg=tg, K=K, fr=wavy_frame(H, W, K), T=0.05)


def _tol(sc, frames):
    return field_tolerances(DEPTH, sc["T"], ULPS_PER_FRAME * frames)


def _fresh(sc, frame_cap=64):
    jv = jvolume.make_volume(sc["jg"], sc["T"], frame_cap=frame_cap)
    tv = tvolume.make_volume(sc["tg"], sc["T"], frame_cap=frame_cap, device=CPU)
    return jv, tv


def test_make_volume_and_convert_roundtrip():
    sc = _scene32()
    jv, tv = _fresh(sc, frame_cap=70)
    assert_vol_close(tv, jv, _tol(sc, 0))
    assert tv.vis.shape == (3, 32, 32, 32) and tv.vis.dtype == torch.int32
    # a volume with bit 31 set survives the uint32 <-> int32 boundary
    a = vol_to_numpy_j(jv)
    a["vis"][1, 3, 4, 5] = np.uint32(0x80000001)
    back = convert.volume_to_numpy(convert.volume_from_numpy(
        a["dist"], a["grad"], a["weight"], a["color"], a["vis"], device=CPU))
    assert back["vis"].dtype == np.uint32
    np.testing.assert_array_equal(back["vis"], a["vis"])


def test_fusion_weight():
    sdf = np.linspace(-0.5, 0.5, 1001).astype(np.float32)
    np.testing.assert_array_equal(
        tvolume.fusion_weight(torch.from_numpy(sdf), 0.2).numpy(),
        np.asarray(jvolume.fusion_weight(jnp.asarray(sdf), 0.2)))


def test_fuse_frame_matches_jax_over_poses():
    sc = _scene32()
    jv, tv = _fresh(sc)
    for n, pose in enumerate(_poses(), start=1):
        # frame ids 29.. cross a word boundary and set the sign bit (31)
        jv, tv, _, _ = fuse_both(jv, tv, sc["jg"], sc["tg"], sc["fr"], sc["K"],
                                 pose, 28 + n, sc["T"])
        assert_vol_close(tv, jv, _tol(sc, n), where=f"frame {n}")
    assert int(np.asarray(jv.weight).astype(bool).sum()) > 1000
    assert np.any(vol_to_numpy_j(jv)["vis"][0] >> 31)        # bit 31 was used


def test_fuse_frame_gate_false_is_noop_and_functional():
    sc = _scene32()
    jv, tv = _fresh(sc)
    jv, tv, _, _ = fuse_both(jv, tv, sc["jg"], sc["tg"], sc["fr"], sc["K"],
                             np.eye(4, dtype=np.float32), 0, sc["T"])
    before = convert.volume_to_numpy(tv)
    _, tv2, _, _ = fuse_both(jv, tv, sc["jg"], sc["tg"], sc["fr"], sc["K"],
                             np.eye(4, dtype=np.float32), 1, sc["T"], gate=False)
    after_in = convert.volume_to_numpy(tv)
    after_out = convert.volume_to_numpy(tv2)
    for k in FIELDS + ("vis",):
        np.testing.assert_array_equal(after_out[k], before[k])
        np.testing.assert_array_equal(after_in[k], before[k])


@pytest.mark.parametrize("scene", ["32", "128"])
@pytest.mark.parametrize("seg_x", [None, 8])
def test_row_activity_and_compaction_exact(scene, seg_x):
    """The cull mask and the static-capacity compaction, element for element:
    a mask that is too small silently drops updates."""
    sc = _scene32() if scene == "32" else _scene128()
    jg, tg, K, T = sc["jg"], sc["tg"], sc["K"], sc["T"]
    depth = sc["fr"]["depth"].copy()
    depth[:5, :7] = 0.0                              # invalid-depth corner
    n_seen = 0
    for pose in _poses():
        jact = np.asarray(jvolume._row_activity(
            jg, jnp.asarray(depth), jnp.asarray(K), jnp.asarray(pose),
            truncation=T, seg_x=seg_x, **ZKW))
        tact = tvolume._row_activity(
            tg, torch.from_numpy(depth), torch.from_numpy(K),
            torch.from_numpy(pose), truncation=T, seg_x=seg_x, **ZKW)
        np.testing.assert_array_equal(tact.numpy(), jact)
        n_act = int(jact.sum())
        n_seen += n_act
        assert int(tvolume.count_active_rows(
            tg, depth, K, pose, truncation=T, seg_x=seg_x, device=CPU,
            **ZKW)) == n_act
        nseg = jact.size
        for cap in {max(1, n_act // 2), n_act, n_act + 3, nseg} - {0}:
            (jidx,) = jnp.nonzero(jnp.asarray(jact.reshape(-1)), size=cap,
                                  fill_value=nseg)
            tidx, tn = tvolume.compact_active(tact.reshape(-1), cap)
            np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
            assert int(tn) == n_act
    assert n_seen > 0


CULLED = [
    # (scene, seg_x, JAX engine, torch engine)
    ("128", None, "pallas", "dma"),
    ("128", None, "pallas", "staged"),
    ("128", None, "pallas", "plain"),
    ("32", None, "xla", "dma"),
    ("32", None, "xla", "staged"),
    ("32", 8, "xla", "dma"),
]


@pytest.mark.parametrize("scene,seg_x,j_impl,t_impl", CULLED)
def test_fuse_frame_culled_matches_jax(scene, seg_x, j_impl, t_impl):
    sc = _scene32() if scene == "32" else _scene128()
    ns = 1 if seg_x is None else sc["jg"].dims[0] // seg_x
    nseg = sc["jg"].dims[2] * sc["jg"].dims[1] * ns
    culled = dict(row_capacity=nseg, seg_x=seg_x, j_impl=j_impl, t_impl=t_impl)
    jv, tv = _fresh(sc)
    for n, pose in enumerate(_poses(), start=1):
        tv_before = tv
        before = convert.volume_to_numpy(tv)
        jv, tv, jov, tov = fuse_both(jv, tv, sc["jg"], sc["tg"], sc["fr"],
                                     sc["K"], pose, 28 + n, sc["T"], culled=culled)
        assert jov is False and tov is False
        assert_vol_close(tv, jv, _tol(sc, n), where=f"frame {n}")
        # functional by default: the volume handed in is left as it was
        still = convert.volume_to_numpy(tv_before)
        for k in FIELDS + ("vis",):
            np.testing.assert_array_equal(still[k], before[k])
    assert int(np.asarray(jv.weight).astype(bool).sum()) > 300


def test_fuse_frame_culled_engines_bit_identical_and_equal_full_grid():
    """dma / staged / plain row movement give one volume bit for bit, and it
    is the full-grid fuse_frame's (the cull is a superset; the per-voxel
    update is shared)."""
    sc = _scene128()
    nseg = 16 * 40
    _, tv0 = _fresh(sc)
    vols = {k: tv0 for k in ("dma", "staged", "plain", "full")}
    for n, pose in enumerate(_poses(), start=1):
        args = [sc["fr"][k] for k in ("color", "depth", "normals", "n_sq_inv")]
        kw = dict(truncation=sc["T"], device=CPU, **ZKW)
        for impl in ("dma", "staged", "plain"):
            vols[impl], ov = tvolume.fuse_frame_culled(
                vols[impl], sc["tg"], *args, sc["K"], pose, n,
                row_capacity=nseg, rows_impl=impl, **kw)
            assert not bool(ov)
        vols["full"] = tvolume.fuse_frame(
            vols["full"], sc["tg"], *args, sc["K"], pose, n, **kw)
        for impl in ("dma", "staged", "plain"):
            for a, b in zip(vols[impl], vols["full"]):
                assert torch.equal(a, b), (impl, n)


@pytest.mark.parametrize("t_impl", ["dma", "staged", "plain"])
def test_fuse_frame_culled_scatters_five_tables_in_one_call(t_impl, monkeypatch):
    """A culled fusion gathers its five tables with ONE gather call and writes
    them back with ONE scatter call over all five; whichever engine moves the
    rows the volume is the same bit for bit, and it is the JAX package's
    within the file's tolerance."""
    sc = _scene128()
    calls, depth = [], [0]
    wrappers = ("gather_tables_dma", "gather_tables", "gather_tables_plain",
                "gather_rows_dma", "gather_rows", "gather_rows_plain",
                "scatter_tables_dma", "scatter_tables", "scatter_tables_dma_plain",
                "scatter_rows_dma", "scatter_rows", "scatter_rows_dma_plain")

    def counted(name):
        fn = getattr(tvolume.rowcopy, name)

        def wrapper(tables, idx, *rows, **kw):
            if depth[0] == 0:      # a call made by the fusion, not by a wrapper
                calls.append((name, len(tables) if isinstance(tables, (list, tuple))
                              else None, idx.shape[0]))
            depth[0] += 1
            try:
                return fn(tables, idx, *rows, **kw)
            finally:
                depth[0] -= 1
        return wrapper

    for name in wrappers:
        monkeypatch.setattr(tvolume.rowcopy, name, counted(name))
    gather = {"dma": "gather_tables_dma", "staged": "gather_tables",
              "plain": "gather_tables_plain"}[t_impl]
    scatter = {"dma": "scatter_tables_dma", "staged": "scatter_tables",
               "plain": "scatter_tables_dma_plain"}[t_impl]
    culled = dict(row_capacity=640, j_impl="pallas", t_impl=t_impl)
    jv, tv = _fresh(sc)
    _, tv_plain = _fresh(sc)
    args = [sc["fr"][k] for k in ("color", "depth", "normals", "n_sq_inv")]
    for n, pose in enumerate(_poses()[:3], start=1):
        del calls[:]
        jv, tv, _, _ = fuse_both(jv, tv, sc["jg"], sc["tg"], sc["fr"], sc["K"],
                                 pose, 28 + n, sc["T"], culled=culled)
        # a fusion that still moved its rows table by table would show five
        # calls where there is one
        assert calls == [(gather, 5, 640), (scatter, 5, 640)], calls
        assert_vol_close(tv, jv, _tol(sc, n), where=f"frame {n}")
        tv_plain, _ = tvolume.fuse_frame_culled(
            tv_plain, sc["tg"], *args, sc["K"], pose, 28 + n, truncation=sc["T"],
            row_capacity=640, rows_impl="plain", device=CPU, **ZKW)
        for a, b in zip(tv, tv_plain):
            assert torch.equal(a, b), (t_impl, n)


def test_fuse_frame_culled_inplace_updates_the_argument():
    sc = _scene128()
    _, tv = _fresh(sc)
    args = [sc["fr"][k] for k in ("color", "depth", "normals", "n_sq_inv")]
    kw = dict(truncation=sc["T"], row_capacity=640, device=CPU, **ZKW)
    eye = np.eye(4, dtype=np.float32)
    want, _ = tvolume.fuse_frame_culled(tv, sc["tg"], *args, sc["K"], eye, 0, **kw)
    got, _ = tvolume.fuse_frame_culled(tv, sc["tg"], *args, sc["K"], eye, 0,
                                       inplace=True, **kw)
    assert got.dist.data_ptr() == tv.dist.data_ptr()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t_impl", ["dma", "staged"])
def test_fuse_frame_culled_overflow_flag_and_gate(t_impl):
    sc = _scene128()
    jv, tv = _fresh(sc)
    eye = np.eye(4, dtype=np.float32)
    n_act = int(tvolume.count_active_rows(
        sc["tg"], sc["fr"]["depth"], sc["K"], eye, truncation=sc["T"],
        device=CPU, **ZKW))
    assert 8 < n_act < 640
    # capacity one short of the active count: both sides raise the flag
    culled = dict(row_capacity=n_act - 1, j_impl="pallas", t_impl=t_impl)
    _, _, jov, tov = fuse_both(jv, tv, sc["jg"], sc["tg"], sc["fr"], sc["K"],
                               eye, 0, sc["T"], culled=culled)
    assert jov is True and tov is True
    # exactly enough: no flag, and equal to the JAX volume
    culled["row_capacity"] = n_act
    jv1, tv1, jov, tov = fuse_both(jv, tv, sc["jg"], sc["tg"], sc["fr"], sc["K"],
                                   eye, 0, sc["T"], culled=culled)
    assert jov is False and tov is False
    assert_vol_close(tv1, jv1, _tol(sc, 1))
    # gate=False: a no-op on both sides, no flag even at a tiny capacity
    culled["row_capacity"] = 4
    jv2, tv2, jov, tov = fuse_both(jv1, tv1, sc["jg"], sc["tg"], sc["fr"],
                                   sc["K"], eye, 1, sc["T"], culled=culled,
                                   gate=False)
    assert jov is False and tov is False
    for a, b in zip(tv2, tv1):
        assert torch.equal(a, b)
    assert_vol_close(tv2, jv2, _tol(sc, 1))


def test_fuse_frame_culled_rejects_unknown_engine():
    sc = _scene128()
    _, tv = _fresh(sc)
    args = [sc["fr"][k] for k in ("color", "depth", "normals", "n_sq_inv")]
    with pytest.raises(ValueError):
        tvolume.fuse_frame_culled(
            tv, sc["tg"], *args, sc["K"], np.eye(4, dtype=np.float32), 0,
            truncation=sc["T"], row_capacity=8, rows_impl="xla", device=CPU,
            **ZKW)


def _fused_pair():
    sc = _scene32()
    jv, tv = _fresh(sc)
    for n, pose in enumerate(_poses()[:3]):
        jv, _, _, _ = fuse_both(jv, tv, sc["jg"], sc["tg"], sc["fr"], sc["K"],
                                pose, 30 + n, sc["T"])
    return sc, jv, to_torch_vol(jv)       # identical state on both sides


def test_queries_on_identical_state():
    sc, jv, tv = _fused_pair()
    rng = np.random.default_rng(3)
    pts = (np.array([0, 0, 1.2]) + rng.uniform(-0.7, 0.7, (5000, 3))).astype(np.float32)
    jq = jvolume.sdf_query(jv, sc["jg"], jnp.asarray(pts), sc["T"])
    tq = tvolume.sdf_query(tv, sc["tg"], torch.from_numpy(pts), sc["T"])
    jp = jvolume.sdf_query_packed(jvolume.pack_tracking_payload(jv), sc["jg"],
                                  jnp.asarray(pts), sc["T"])
    tp = tvolume.sdf_query_packed(tvolume.pack_tracking_payload(tv), sc["tg"],
                                  torch.from_numpy(pts), sc["T"])
    np.testing.assert_array_equal(
        tvolume.pack_tracking_payload(tv).numpy(),
        np.asarray(jvolume.pack_tracking_payload(jv)))
    for got, want in ((tq, jq), (tp, jp)):
        psi, ghat, w, valid = (x.numpy() for x in got)
        np.testing.assert_array_equal(valid, np.asarray(want[3]))
        np.testing.assert_array_equal(w, np.asarray(want[2]))
        # a normalisation and a 3-term dot product: a few ULPs at magnitude 1
        np.testing.assert_allclose(ghat, np.asarray(want[1]), rtol=0, atol=5e-7)
        np.testing.assert_allclose(psi, np.asarray(want[0]), rtol=0, atol=5e-7)
    assert 100 < int(np.asarray(jq[3]).sum()) < 5000


def test_visibility_helpers_on_identical_state():
    sc, jv, tv = _fused_pair()
    np.testing.assert_array_equal(
        tvolume.vis_count(tv.vis).numpy(), np.asarray(jvolume.vis_count(jv.vis)))
    for f in (30, 31, 32, 5):
        np.testing.assert_array_equal(
            tvolume.vis_bit(tv.vis, f).numpy(),
            np.asarray(jvolume.vis_bit(jv.vis, f)))
    np.testing.assert_array_equal(
        tvolume.surface_band_mask(tv, 0.04).numpy(),
        np.asarray(jvolume.surface_band_mask(jv, 0.04)))
    # every bit pattern, sign bit included
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (2, 4, 4, 4), dtype=np.uint64).astype(np.uint32)
    words[0, 0, 0, :4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    np.testing.assert_array_equal(
        tvolume.vis_count(torch.from_numpy(words.view(np.int32))).numpy(),
        np.asarray(jvolume.vis_count(jnp.asarray(words))))


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    sc = _scene32()
    with pytest.raises(RuntimeError, match="CUDA"):
        tvolume.make_volume(sc["tg"], sc["T"])
    _, tv = _fresh(sc)
    args = [sc["fr"][k] for k in ("color", "depth", "normals", "n_sq_inv")]
    for fn, extra in ((tvolume.fuse_frame, {}),
                      (tvolume.fuse_frame_culled, dict(row_capacity=8))):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(tv, sc["tg"], *args, sc["K"], np.eye(4, dtype=np.float32), 0,
               truncation=sc["T"], **extra, **ZKW)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvolume.count_active_rows(sc["tg"], sc["fr"]["depth"], sc["K"],
                                  np.eye(4, dtype=np.float32), truncation=sc["T"],
                                  **ZKW)
    # the cull's and the compaction's wrappers (ops/cull.py) run where their
    # tensors lie: CPU tensors, as asked for here, take the plain versions
    # and launch nothing
    from psgradientsdf_tpu_torch.ops import cull

    cull.reset_launch_counts()
    act = cull.row_activity(sc["tg"], torch.from_numpy(sc["fr"]["depth"]),
                            torch.from_numpy(sc["K"]), torch.eye(4),
                            truncation=sc["T"], gate=torch.tensor(True), **ZKW)
    idx, n_act = cull.compact_active(act.reshape(-1), 8)
    safe, live, _ = cull.compact_padded(act.reshape(-1), 8)
    assert idx.device.type == safe.device.type == "cpu"
    assert int(n_act) == int(live) == int(tvolume.count_active_rows(
        sc["tg"], sc["fr"]["depth"], sc["K"], np.eye(4, dtype=np.float32),
        truncation=sc["T"], device=CPU, **ZKW)) > 0
    assert cull.launch_counts == {"cull_compact": 0}
