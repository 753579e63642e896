"""The packed volume state and the K-batched fusion of core/volume.py in the
PyTorch package against the JAX package: PackedVolume, the packed culled
fusion over the three row-movement engines, the tracker on packed state,
and fuse_frames_culled.

Inputs are numpy scenes handed to both sides (the shapes of the JAX tests:
a 32^3 grid of 4 cm voxels, 48x64 frames).  Tolerances, as in
tests/test_torch_volume.py: masks, overflow flags and visibility words
exact; float fields within helpers_torch.field_tolerances at 4 float32 ULPs
of the scene's depth per fused frame.  Within the PyTorch package the
packed fusion equals the SoA fusion, the packed tracker the SoA tracker,
and the batched fusion K sequential fusions, bit for bit.  The JAX side runs
rows_impl "xla", "xla2d" and "pallas" (the Pallas kernels in interpret mode,
for rows of a multiple of 128 floats; 8-voxel segments fall back to
"xla2d" there).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from psgradientsdf_tpu.core import volume as jvolume
from psgradientsdf_tpu.tracking import tracker as jtracker
from psgradientsdf_tpu_torch import convert
from psgradientsdf_tpu_torch.core import volume as tvolume
from psgradientsdf_tpu_torch.tracking import tracker as ttracker

from helpers_torch import (
    CPU, assert_vol_close, field_tolerances, fuse_both, se3_exp_np,
    to_torch_vol,
)
from test_torch_volume import _poses, _scene32

torch.set_num_threads(1)

ULPS_PER_FRAME = 4
DEPTH = 1.5
ZKW = dict(zmin=0.1, zmax=5.0)
IMAGES = ("color", "depth", "normals", "n_sq_inv")


def _tol(sc, frames):
    return field_tolerances(DEPTH, sc["T"], ULPS_PER_FRAME * frames)


def _nseg(sc, seg_x=None):
    g = sc["jg"].dims
    return g[2] * g[1] * (1 if seg_x is None else g[0] // seg_x)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _fused_jax(sc, frames=3, frame_cap=64):
    jv = jvolume.make_volume(sc["jg"], sc["T"], frame_cap=frame_cap)
    for n, pose in enumerate(_poses()[:frames]):
        jv, _, _, _ = fuse_both(jv, None, sc["jg"], sc["tg"], sc["fr"], sc["K"],
                                pose, 30 + n, sc["T"])
    return jv


def test_packed_volume_round_trip():
    sc = _scene32()
    jv = _fused_jax(sc)
    tv = to_torch_vol(jv)
    jp = jvolume.PackedVolume.from_volume(jv)
    tp = tvolume.PackedVolume.from_volume(tv)
    got = convert.packed_volume_to_numpy(tp)
    np.testing.assert_array_equal(got["payload"], np.asarray(jp.payload))
    np.testing.assert_array_equal(got["vis"], np.asarray(jp.vis))
    assert got["vis"].dtype == np.uint32 and tp.payload.shape == (32, 32, 32, 8)
    back = tp.to_volume()
    assert _equal(back, tv) and all(t.is_contiguous() for t in back)
    # the conversions copy: the two states never share storage
    assert tp.vis.data_ptr() != tv.vis.data_ptr()
    assert back.vis.data_ptr() != tp.vis.data_ptr()
    c = tp.clone()
    c.payload.zero_()
    assert torch.equal(tp.payload, convert.packed_volume_from_numpy(
        got["payload"], got["vis"], device=CPU).payload)
    # a word with bit 31 set survives the uint32 <-> int32 boundary
    got["vis"][1, 3, 4, 5] = np.uint32(0x80000001)
    again = convert.packed_volume_to_numpy(convert.packed_volume_from_numpy(
        got["payload"], got["vis"], device=CPU))
    np.testing.assert_array_equal(again["vis"], got["vis"])


@pytest.mark.parametrize("seg_x", [None, 8])
def test_row_activity_margins_match_jax(seg_x):
    """_row_activity's margins, as the resident allocator passes them: the
    JAX package's mask exactly; zero margins give the mask of no margins;
    a margin only adds rows."""
    sc = _scene32()
    depth = sc["fr"]["depth"].copy()
    depth[:5, :7] = 0.0
    kw = dict(truncation=sc["T"], seg_x=seg_x, **ZKW)
    for pose in _poses():
        args = (torch.from_numpy(depth), torch.from_numpy(sc["K"]),
                torch.from_numpy(pose))
        plain = tvolume._row_activity(sc["tg"], *args, **kw)
        zero = tvolume._row_activity(sc["tg"], *args, margin_px=0.0,
                                     margin_t=0.0, **kw)
        assert torch.equal(plain, zero)
        for m_px, m_t in ((6.0, 0.05), (16.0, 0.0), (0.0, 0.2)):
            got = tvolume._row_activity(sc["tg"], *args, margin_px=m_px,
                                        margin_t=m_t, **kw)
            want = jvolume._row_activity(
                sc["jg"], jnp.asarray(depth), jnp.asarray(sc["K"]),
                jnp.asarray(pose), margin_px=m_px, margin_t=m_t, **kw)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert bool((got | ~plain).all())


def test_gather_zyx_matches_jax():
    from psgradientsdf_tpu.core import grid as jgrid
    from psgradientsdf_tpu_torch.core import grid as tgrid

    rng = np.random.default_rng(5)
    vol = rng.standard_normal((6, 5, 4, 3)).astype(np.float32)
    idx = np.stack([rng.integers(0, 4, 50), rng.integers(0, 5, 50),
                    rng.integers(0, 6, 50)], -1).astype(np.int32).reshape(5, 10, 3)
    got = tgrid.gather_zyx(torch.from_numpy(vol), torch.from_numpy(idx))
    want = jgrid.gather_zyx(jnp.asarray(vol), jnp.asarray(idx))
    assert got.shape == (5, 10, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (seg_x, torch engine, JAX engine)
PACKED = [
    (None, "dma", "pallas"),
    (None, "staged", "xla2d"),
    (None, "plain", "xla"),
    (8, "dma", "xla"),
    (8, "staged", "xla2d"),
    (8, "plain", "pallas"),
]


@pytest.mark.parametrize("seg_x,t_impl,j_impl", PACKED)
def test_fuse_frame_culled_packed_matches_jax_and_soa(seg_x, t_impl, j_impl):
    """Over generic, rotated, behind-the-camera and inside-the-volume poses
    (frame ids 29.. cross a word boundary and set bit 31): the packed fusion
    is the JAX package's within the file's tolerance, and the SoA fusion's
    bit for bit; the volume handed in is left as it was."""
    sc = _scene32()
    cap = _nseg(sc, seg_x)
    kw = dict(truncation=sc["T"], row_capacity=cap, seg_x=seg_x, **ZKW)
    jp = jvolume.PackedVolume.from_volume(
        jvolume.make_volume(sc["jg"], sc["T"], frame_cap=64))
    tvol = tvolume.make_volume(sc["tg"], sc["T"], frame_cap=64, device=CPU)
    tp = tvolume.PackedVolume.from_volume(tvol)
    jargs = [jnp.asarray(sc["fr"][k]) for k in IMAGES]
    targs = [sc["fr"][k] for k in IMAGES]
    for n, pose in enumerate(_poses(), start=1):
        jp, jov = jvolume.fuse_frame_culled_packed(
            jp, sc["jg"], *jargs, jnp.asarray(sc["K"]), jnp.asarray(pose),
            jnp.int32(28 + n), rows_impl=j_impl, **kw)
        before = tp.clone()
        tp2, tov = tvolume.fuse_frame_culled_packed(
            tp, sc["tg"], *targs, sc["K"], pose, 28 + n, rows_impl=t_impl,
            device=CPU, **kw)
        assert _equal(tp, before)                  # functional by default
        tp = tp2
        tvol, sov = tvolume.fuse_frame_culled(
            tvol, sc["tg"], *targs, sc["K"], pose, 28 + n, rows_impl=t_impl,
            device=CPU, **kw)
        assert not bool(jov) and not bool(tov) and not bool(sov)
        assert _equal(tp.to_volume(), tvol), f"frame {n}: packed != SoA"
        assert_vol_close(tp.to_volume(), jp.to_volume(), _tol(sc, n),
                         where=f"frame {n}")
    assert int((tvol.weight > 0).sum()) > 300


@pytest.mark.parametrize("t_impl", ["dma", "staged"])
def test_fuse_frame_culled_packed_two_tables_one_call(t_impl, monkeypatch):
    """One gather call and one scatter call a frame, over the payload's rows
    and the frame's visibility word; the scatter is told the live count."""
    sc = _scene32()
    calls = []
    names = {"dma": ("gather_tables_dma", "scatter_tables_dma"),
             "staged": ("gather_tables", "scatter_tables")}[t_impl]
    for name in names:
        fn = getattr(tvolume.rowcopy, name)

        def wrapper(tables, idx, *rows, _fn=fn, _name=name, **kw):
            calls.append((_name, [tuple(t.shape) for t in tables],
                          idx.shape[0], kw.get("live") is not None))
            return _fn(tables, idx, *rows, **kw)
        monkeypatch.setattr(tvolume.rowcopy, name, wrapper)
    tp = tvolume.PackedVolume.from_volume(
        tvolume.make_volume(sc["tg"], sc["T"], frame_cap=64, device=CPU))
    targs = [sc["fr"][k] for k in IMAGES]
    tvolume.fuse_frame_culled_packed(
        tp, sc["tg"], *targs, sc["K"], np.eye(4, dtype=np.float32), 5,
        truncation=sc["T"], row_capacity=700, rows_impl=t_impl, device=CPU,
        **ZKW)
    shapes = [(1024, 256), (1024, 32)]
    assert calls == [(names[0], shapes, 700, False),
                     (names[1], shapes, 700, True)], calls


def test_fuse_frame_culled_packed_overflow_and_gate():
    sc = _scene32()
    eye = np.eye(4, dtype=np.float32)
    n_act = int(tvolume.count_active_rows(
        sc["tg"], sc["fr"]["depth"], sc["K"], eye, truncation=sc["T"],
        device=CPU, **ZKW))
    assert 8 < n_act < 1024
    jargs = [jnp.asarray(sc["fr"][k]) for k in IMAGES]
    targs = [sc["fr"][k] for k in IMAGES]
    jp = jvolume.PackedVolume.from_volume(
        jvolume.make_volume(sc["jg"], sc["T"], frame_cap=64))
    tp = tvolume.PackedVolume.from_volume(
        tvolume.make_volume(sc["tg"], sc["T"], frame_cap=64, device=CPU))
    for cap, gate, want in ((n_act - 1, None, True), (n_act, None, False),
                            (4, False, False)):
        jgate = None if gate is None else jnp.bool_(gate)
        jq, jov = jvolume.fuse_frame_culled_packed(
            jp, sc["jg"], *jargs, jnp.asarray(sc["K"]), jnp.asarray(eye),
            jnp.int32(0), jgate, truncation=sc["T"], row_capacity=cap, **ZKW)
        tq, tov = tvolume.fuse_frame_culled_packed(
            tp, sc["tg"], *targs, sc["K"], eye, 0, gate, truncation=sc["T"],
            row_capacity=cap, device=CPU, **ZKW)
        assert bool(jov) is want and bool(tov) is want, cap
        if gate is False:
            assert _equal(tq, tp)                   # a no-op
        if not want:
            assert_vol_close(tq.to_volume(), jq.to_volume(), _tol(sc, 1))


@pytest.mark.parametrize("early_exit,regather", [(False, 4), (True, 1)])
def test_track_frame_packed(early_exit, regather):
    """track_frame on a PackedVolume is track_frame on the GradSdfVolume of
    the same state, exactly (the payload's slots 0:5 feed the same gather),
    and the JAX package's packed tracker within tests/test_torch_tracker.py's
    tolerances: iterations, converged and valid pixels equal, the pose to
    atol 1e-5, the mean energy to rtol 1e-4."""
    sc = _scene32()
    jv = _fused_jax(sc)
    tv = to_torch_vol(jv)
    seed = se3_exp_np([0.01, -0.008, 0.012, 0.004, -0.003, 0.005])
    tkw = dict(truncation=sc["T"], num_iterations=8, conv_threshold_sq=1e-8,
               damping=1.0, early_exit=early_exit, regather_every=regather,
               **ZKW)
    depth = sc["fr"]["depth"]
    r_soa = ttracker.track_frame(tv, sc["tg"], depth, sc["K"], seed,
                                 device=CPU, **tkw)
    r_pkd = ttracker.track_frame(tvolume.PackedVolume.from_volume(tv), sc["tg"],
                                 depth, sc["K"], seed, device=CPU, **tkw)
    for a, b in zip(r_soa, r_pkd):
        assert torch.equal(a, b)
    j = jtracker.track_frame(jvolume.PackedVolume.from_volume(jv), sc["jg"],
                             jnp.asarray(depth), jnp.asarray(sc["K"]),
                             jnp.asarray(seed), **tkw)
    assert int(j.iterations) == int(r_pkd.iterations)
    assert bool(j.converged) == bool(r_pkd.converged)
    assert int(j.num_valid) == int(r_pkd.num_valid)
    np.testing.assert_allclose(r_pkd.pose.numpy(), np.asarray(j.pose),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(r_pkd.energy), float(j.energy), rtol=1e-4)
    assert int(r_pkd.num_valid) > 500


def _batch(sc, poses):
    KF = len(poses)
    stack = {k: np.stack([sc["fr"][k]] * KF) for k in IMAGES}
    return stack, np.stack(poses).astype(np.float32)


def _fuse_batch_both(sc, jv, tv, ids, gates, cap, t_impl, poses=None):
    poses = _poses() if poses is None else poses
    stack, P = _batch(sc, poses)
    jq, jov = jvolume.fuse_frames_culled(
        jv, sc["jg"], *(jnp.asarray(stack[k]) for k in IMAGES),
        jnp.asarray(sc["K"]), jnp.asarray(P), jnp.asarray(np.array(ids, np.int32)),
        None if gates is None else jnp.asarray(gates), truncation=sc["T"],
        row_capacity=cap, **ZKW)
    tq, tov = tvolume.fuse_frames_culled(
        tv, sc["tg"], *(stack[k] for k in IMAGES), sc["K"], P, ids, gates,
        truncation=sc["T"], row_capacity=cap, rows_impl=t_impl, device=CPU,
        **ZKW)
    return jq, tq, bool(jov), bool(tov)


@pytest.mark.parametrize("t_impl", ["dma", "staged", "plain"])
def test_fuse_frames_culled_matches_jax_and_sequential(t_impl, monkeypatch):
    """K=6 frames with one gated off, ids 30..35 across the word boundary:
    the JAX package's batched fusion within the tolerance, K sequential
    fuse_frame_culled calls of this package bit for bit, with ONE gather and
    ONE scatter call over six tables for the batch."""
    sc = _scene32()
    poses = _poses()
    ids = list(range(30, 36))
    gates = np.ones(len(poses), bool)
    gates[2] = False
    jv = jvolume.make_volume(sc["jg"], sc["T"], frame_cap=64)
    tv = tvolume.make_volume(sc["tg"], sc["T"], frame_cap=64, device=CPU)
    seq = tv
    targs = [sc["fr"][k] for k in IMAGES]
    for pose, fid, g in zip(poses, ids, gates):
        seq, ov = tvolume.fuse_frame_culled(
            seq, sc["tg"], *targs, sc["K"], pose, fid, bool(g),
            truncation=sc["T"], row_capacity=_nseg(sc), rows_impl=t_impl,
            device=CPU, **ZKW)
        assert not bool(ov)

    calls = []
    gather, scatter = {"dma": ("gather_tables_dma", "scatter_tables_dma"),
                       "staged": ("gather_tables", "scatter_tables"),
                       "plain": ("gather_tables_plain",
                                 "scatter_tables_dma_plain")}[t_impl]
    for name in (gather, scatter):
        fn = getattr(tvolume.rowcopy, name)

        def wrapper(tables, idx, *rows, _fn=fn, _name=name, **kw):
            calls.append((_name, len(tables)))
            return _fn(tables, idx, *rows, **kw)
        monkeypatch.setattr(tvolume.rowcopy, name, wrapper)
    jq, tq, jov, tov = _fuse_batch_both(sc, jv, tv, ids, gates, _nseg(sc), t_impl)
    assert calls == [(gather, 6), (scatter, 6)], calls
    assert not jov and not tov
    assert _equal(tq, seq), "batched != sequential"
    assert_vol_close(tq, jq, _tol(sc, len(poses)))
    assert int((tv.weight > 0).sum()) == 0          # functional by default
    assert int((tq.weight > 0).sum()) > 300


def test_fuse_frames_culled_flags_and_words():
    """The flag at an undersized capacity and for ids spanning more than two
    words (both sides put the stray bits in the second word), a batch whose
    first word is the volume's last (the bits of the next word are dropped,
    one plane moved), and batches with no active row (all gated off, and all
    behind the camera: slot 0 itself is padding) — each against the JAX
    package, visibility words exact."""
    sc = _scene32()
    poses = _poses()
    flip = poses[4]
    jv = _fused_jax(sc, frames=2)
    tv = to_torch_vol(jv)
    cases = [
        ("capacity 64", list(range(30, 36)), None, 64, poses, True),
        ("ids over three words", [0, 32, 64, 65, 66, 67], None, _nseg(sc),
         poses, True),
        ("last word first", [62, 63, 64, 65, 66, 67], None, _nseg(sc), poses,
         False),
        ("all gated off", list(range(40, 46)), np.zeros(6, bool), 4, poses,
         False),
        ("all behind", list(range(40, 46)), None, 4, [flip] * 6, False),
    ]
    for what, ids, gates, cap, ps, want in cases:
        jq, tq, jov, tov = _fuse_batch_both(sc, jv, tv, ids, gates, cap, "dma",
                                            poses=ps)
        assert jov is want and tov is want, what
        if want and what == "capacity 64":
            continue                   # an incomplete update: no contract
        assert_vol_close(tq, jq, _tol(sc, 8), where=what)
        if gates is not None or what == "all behind":
            assert _equal(tq, tv), what  # nothing to fuse: unchanged
        if what == "last word first":
            # bits of 62 and 63 set in word 1, word 0 untouched
            assert torch.equal(tq.vis[0], tv.vis[0])
            assert bool(((tq.vis[1] >> 30) & 3).any())


def test_batched_fusion_rejects_frames_past_capacity():
    sc = _scene32()
    tv = tvolume.make_volume(sc["tg"], sc["T"], frame_cap=32, device=CPU)
    stack, P = _batch(sc, _poses()[:2])
    with pytest.raises(ValueError, match="visibility"):
        tvolume.fuse_frames_culled(
            tv, sc["tg"], *(stack[k] for k in IMAGES), sc["K"], P, [32, 33],
            truncation=sc["T"], row_capacity=16, device=CPU, **ZKW)
