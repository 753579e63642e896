"""core/resident.py of the PyTorch package against the JAX package's, and
against the canonical packed path of its own package.

The five tests of tests/test_resident.py, with the same scene shapes (a
32^3 grid of 4 cm voxels, 48x64 frames) and the same seven cases, on numpy
inputs handed to both sides.  Every resident step of a stream is also run
by the JAX package on the SAME state (the JAX state carried across through
convert.resident_from_numpy / packed_volume_from_numpy) and held against
it: masks, indices, visibility words, flags, n_used, row_slot, slot_rows
and fused_ever exact; the float rows within helpers_torch.field_tolerances
at 4 float32 ULPs of the scene's depth per fused frame; tracked poses
within tests/test_torch_tracker.py's tolerances.  Within the PyTorch
package a fusion-only resident stream equals the canonical packed stream
bit for bit, and so does the resident tracker on the canonical tracker's
state.
"""

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from psgradientsdf_tpu.core import resident as JR
from psgradientsdf_tpu.core import volume as jvolume
from psgradientsdf_tpu_torch import convert
from psgradientsdf_tpu_torch.core import resident as TR
from psgradientsdf_tpu_torch.core import volume as tvolume
from psgradientsdf_tpu_torch.tracking import tracker as ttracker

from helpers_torch import CPU, field_tolerances, fuse_both, se3_exp_np
from test_torch_volume import _scene32

torch.set_num_threads(1)

ULPS_PER_FRAME = 4
DEPTH = 1.5
IMAGES = ("color", "depth", "normals", "n_sq_inv")
EYE = np.eye(4, dtype=np.float32)
FLIP = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)   # looking away
# the tracker tests' tolerances
POSE_ATOL, ENERGY_RTOL = 1e-5, 1e-4

# the JAX package's resident functions compiled whole (its streaming
# executors call them inside one program), not dispatched op by op
_ZKW = ("geom", "truncation", "zmin", "zmax")


def _jit(fn, *static):
    return jax.jit(fn, static_argnames=_ZKW + static)


J_REFRESH = _jit(JR.resident_refresh, "capacity", "seg_x", "margin_px",
                 "margin_t")
J_ALLOC = _jit(JR.resident_alloc, "delta_capacity", "margin_px", "margin_t")
J_FUSE = _jit(JR.fuse_frame_resident)
J_FLUSH = jax.jit(JR.resident_flush)
J_TRACK = _jit(JR.track_frame_resident, "num_iterations", "conv_threshold_sq",
               "damping", "early_exit", "regather_every")


def _orbit_poses(n, scale=0.01):
    rng = np.random.default_rng(11)
    pose = np.eye(4, dtype=np.float32)
    out = []
    for _ in range(n):
        pose = se3_exp_np(rng.uniform(-1, 1, 6) * scale) @ pose
        out.append(pose.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def sc():
    s = _scene32()
    s["zkw"] = dict(truncation=s["T"], zmin=0.1, zmax=5.0)
    s["tkw"] = dict(s["zkw"], num_iterations=8, conv_threshold_sq=1e-6,
                    damping=1.0, early_exit=False, regather_every=4)
    s["jargs"] = [jnp.asarray(s["fr"][k]) for k in IMAGES]
    s["targs"] = [s["fr"][k] for k in IMAGES]
    s["jK"] = jnp.asarray(s["K"])
    return s


def _nseg(sc, seg=None):
    g = sc["jg"].dims
    return g[2] * g[1] * (g[0] // (seg or g[0]))


def _start(sc):
    """Frame 0 fused at the identity by the JAX package: the packed state
    both sides start from -> (JAX PackedVolume, torch PackedVolume)."""
    jv = jvolume.make_volume(sc["jg"], sc["T"], frame_cap=64)
    jv, _, _, _ = fuse_both(jv, None, sc["jg"], sc["tg"], sc["fr"], sc["K"],
                            EYE, 0, sc["T"])
    jp = jvolume.PackedVolume.from_volume(jv)
    return jp, _tp(jp)


def _tp(jp):
    return convert.packed_volume_from_numpy(
        np.array(jp.payload), np.array(jp.vis), device=CPU)


def _tr(jres):
    return convert.resident_from_numpy(
        *(np.array(getattr(jres, k)) for k in JR.ResidentVolume._fields),
        device=CPU)


def _tol(sc, frames):
    return field_tolerances(DEPTH, sc["T"], ULPS_PER_FRAME * frames)


def _assert_rows_close(got, want, tol, where):
    """[..., S*8] payload rows: bit for bit (tol None), or per channel
    within tol, dist and colour weighed by min(weight, 1) as
    helpers_torch.assert_vol_close does."""
    if tol is None:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=where)
        return
    g = got.reshape(-1, 8).astype(np.float64)
    w = want.reshape(-1, 8).astype(np.float64)
    err = np.abs(g - w)
    scale = np.minimum(w[:, 4:5], 1.0)
    for name, sl, weigh in (("dist", slice(0, 1), True),
                            ("grad", slice(1, 4), False),
                            ("weight", slice(4, 5), False),
                            ("color", slice(5, 8), True)):
        e = err[:, sl] * (scale if weigh else 1.0)
        assert float(e.max(initial=0.0)) <= tol[name], (where, name, float(e.max()))


def _assert_res_close(tres, jres, tol, where):
    """Every integer and boolean field exact; the rows by _assert_rows_close."""
    t = convert.resident_to_numpy(tres)
    for k in JR.ResidentVolume._fields:
        j = np.array(getattr(jres, k))
        assert t[k].shape == j.shape, (where, k, t[k].shape, j.shape)
        assert t[k].dtype == j.dtype, (where, k, t[k].dtype, j.dtype)
        if k == "rows":
            _assert_rows_close(t[k], j, tol, f"{where} rows")
        else:
            np.testing.assert_array_equal(t[k], j, err_msg=f"{where} {k}")


def _assert_packed_close(tp, jp, tol, where):
    t = convert.packed_volume_to_numpy(tp)
    np.testing.assert_array_equal(t["vis"], np.array(jp.vis), err_msg=where)
    _assert_rows_close(t["payload"], np.array(jp.payload), tol, where)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


class Streams:
    """The JAX package's resident stream and this package's, side by side.
    Every step runs on both streams, and this package's step is also run on
    the JAX stream's state and held against the JAX step: moves and
    bookkeeping exact, a fused frame's rows within one frame's tolerance."""

    def __init__(self, sc, jp, tp, rows_impl):
        self.sc, self.jp, self.tp, self.kw = sc, jp, tp, dict(rows_impl=rows_impl)
        self.jres = self.tres = None

    def refresh(self, pose, **kw):
        sc, zkw = self.sc, self.sc["zkw"]
        self.jres = J_REFRESH(
            self.jp, sc["jg"], sc["jargs"][1], sc["jK"], jnp.asarray(pose),
            **zkw, **kw)
        got = TR.resident_refresh(_tp(self.jp), sc["tg"], sc["fr"]["depth"],
                                  sc["K"], pose, **zkw, **kw, **self.kw,
                                  device=CPU)
        _assert_res_close(got, self.jres, None, "refresh")
        self.tres = TR.resident_refresh(self.tp, sc["tg"], sc["fr"]["depth"],
                                        sc["K"], pose, **zkw, **kw, **self.kw,
                                        device=CPU)

    def alloc(self, pose, **kw):
        sc, zkw = self.sc, self.sc["zkw"]
        targs = (sc["tg"], sc["fr"]["depth"], sc["K"], pose)
        got = TR.resident_alloc(_tr(self.jres), _tp(self.jp), *targs, **zkw,
                                **kw, **self.kw, device=CPU)
        self.jres = J_ALLOC(
            self.jres, self.jp, sc["jg"], sc["jargs"][1], sc["jK"],
            jnp.asarray(pose), **zkw, **kw)
        _assert_res_close(got, self.jres, None, "alloc")
        self.tres = TR.resident_alloc(self.tres, self.tp, *targs, **zkw, **kw,
                                      **self.kw, device=CPU)

    def fuse(self, pose, fid):
        sc, zkw = self.sc, self.sc["zkw"]
        targs = (sc["tg"], *sc["targs"], sc["K"], pose, fid)
        got = TR.fuse_frame_resident(_tr(self.jres), *targs, **zkw, device=CPU)
        self.jres = J_FUSE(
            self.jres, sc["jg"], *sc["jargs"], sc["jK"], jnp.asarray(pose),
            jnp.int32(fid), **zkw)
        _assert_res_close(got, self.jres, _tol(sc, 1), f"fuse {fid}")
        self.tres = TR.fuse_frame_resident(self.tres, *targs, **zkw, device=CPU)

    def track(self, seed):
        sc, tkw = self.sc, self.sc["tkw"]
        targs = (sc["tg"], sc["fr"]["depth"], sc["K"], seed)
        got, gmiss = TR.track_frame_resident(_tr(self.jres), *targs, **tkw,
                                             device=CPU)
        jr, jmiss = J_TRACK(
            self.jres, sc["jg"], sc["jargs"][1], sc["jK"], jnp.asarray(seed),
            **tkw)
        assert bool(gmiss) == bool(jmiss)
        _assert_track_close(got, jr)
        tr, miss = TR.track_frame_resident(self.tres, *targs, **tkw, device=CPU)
        return tr, bool(miss), bool(jmiss)

    def flush(self):
        got = TR.resident_flush(_tr(self.jres), _tp(self.jp), **self.kw)
        self.jp = J_FLUSH(self.jres, self.jp)
        _assert_packed_close(got, self.jp, None, "flush")
        self.tp = TR.resident_flush(self.tres, self.tp, **self.kw)


def _assert_track_close(t, j):
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    assert int(t.num_valid) == int(j.num_valid)
    np.testing.assert_allclose(t.pose.numpy(), np.asarray(j.pose), rtol=0,
                               atol=POSE_ATOL)
    np.testing.assert_allclose(float(t.energy), float(j.energy),
                               rtol=ENERGY_RTOL)


@pytest.mark.parametrize("seg,t_impl", [(None, "dma"), (8, "staged"),
                                        (8, "plain")])
def test_resident_fusion_bit_identical_fixed_poses(sc, seg, t_impl):
    """A fusion-only resident stream at GIVEN poses (refresh, mid-chunk
    delta admission as the orbit moves the active set, flush, a second
    epoch) equals the canonical packed stream of this package bit for bit,
    and every resident step agrees with the JAX package's on the same
    state; seg=8 runs the slots at X-segment granularity."""
    g, zkw, targs = sc["tg"], sc["zkw"], sc["targs"]
    poses = _orbit_poses(6, scale=0.04)
    jp0, tp0 = _start(sc)

    ref = tp0
    for fi, pose in enumerate(poses):
        ref, ov = tvolume.fuse_frame_culled_packed(
            ref, g, *targs, sc["K"], pose, fi + 1, row_capacity=_nseg(sc),
            device=CPU, **zkw)
        assert not bool(ov)

    st = Streams(sc, jp0, tp0, t_impl)
    fi = 0
    for chunk in range(2):
        st.refresh(poses[fi], capacity=_nseg(sc, seg), seg_x=seg)
        for _ in range(3):
            st.alloc(poses[fi], delta_capacity=1024)
            st.fuse(poses[fi], fi + 1)
            fi += 1
        assert int(st.tres.flags) == 0 and int(st.jres.flags) == 0
        st.flush()

    assert _equal(st.tp, ref), "resident stream != canonical packed stream"
    _assert_packed_close(st.tp, st.jp, _tol(sc, 7), "the streams")
    assert int((st.tp.payload[..., 4] > 0).sum()) > 300


def test_resident_tracker_matches_canonical_same_state(sc):
    """track_frame_resident on state refreshed with motion margins: the
    canonical tracker's solve bit for bit in this package, no miss, and the
    JAX package's resident tracker on the same state within the tracker
    tests' tolerances."""
    jp, tp = _start(sc)
    seed = _orbit_poses(1, scale=0.02)[0]
    ref = ttracker.track_frame(tp, sc["tg"], sc["fr"]["depth"], sc["K"], seed,
                               device=CPU, **sc["tkw"])
    st = Streams(sc, jp, tp, "dma")
    # margins sized to the seed's offset from the map alignment (~0.02 m,
    # ~3 px of reprojection at f=50, z=1.2)
    st.refresh(seed, capacity=_nseg(sc), margin_px=6.0, margin_t=0.05)
    got, miss, jmiss = st.track(seed)
    assert not miss and not jmiss
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seg", [None, 8])
def test_resident_tracked_stream_close(sc, seg):
    """A tracked resident stream (2 chunks x 3 frames: admission with motion
    margins, track, admission at the tracked pose, fuse) against the
    canonical tracked stream of this package — the same poses and volume
    bit for bit, since every queried row is resident — and every step
    against the JAX package's on the same state."""
    g, zkw, targs = sc["tg"], sc["zkw"], sc["targs"]
    poses = _orbit_poses(6)
    jp0, tp0 = _start(sc)

    ref_poses, ref, pose = [], tp0, EYE
    for fi, gtp in enumerate(poses):
        tr = ttracker.track_frame(ref, g, sc["fr"]["depth"], sc["K"], gtp @ pose,
                                  device=CPU, **sc["tkw"])
        pose = tr.pose.numpy()
        ref_poses.append(pose)
        ref, ov = tvolume.fuse_frame_culled_packed(
            ref, g, *targs, sc["K"], pose, fi + 1, row_capacity=_nseg(sc, seg),
            seg_x=seg, device=CPU, **zkw)
        assert not bool(ov)

    st = Streams(sc, jp0, tp0, "dma")
    pose, fi = EYE, 0
    for chunk in range(2):
        st.refresh(pose, capacity=_nseg(sc, seg), seg_x=seg)
        for _ in range(3):
            seed = poses[fi] @ pose
            st.alloc(seed, delta_capacity=1024, margin_px=6.0, margin_t=0.05)
            tr, miss, jmiss = st.track(seed)
            assert not miss and not jmiss
            pose = tr.pose.numpy()
            np.testing.assert_array_equal(pose, ref_poses[fi])
            st.alloc(pose, delta_capacity=1024)
            st.fuse(pose, fi + 1)
            fi += 1
        assert int(st.tres.flags) == 0
        st.flush()
    assert _equal(st.tp, ref)


def test_resident_tracker_miss_ledger(sc):
    """Fuse at the identity, refresh the residency from a pose looking AWAY
    (empty active set) and track the original frame: every queried fused
    row is not resident -> the miss flag, on both sides."""
    jp, tp = _start(sc)
    st = Streams(sc, jp, tp, "dma")
    st.refresh(FLIP, capacity=_nseg(sc))
    assert int(st.tres.n_used) == 0
    sc_tkw = sc["tkw"]
    sc["tkw"] = dict(sc_tkw, num_iterations=4)
    try:
        _, miss, jmiss = st.track(EYE)
    finally:
        sc["tkw"] = sc_tkw
    assert miss and jmiss
    st.flush()                              # nothing live: nothing written
    assert _equal(st.tp, tp)


def test_resident_flags(sc):
    """FLAG_CAPACITY at an undersized refresh, FLAG_DELTA at an undersized
    admission, FLAG_COVERAGE when an active row is not resident; the same
    flags (and states) as the JAX package's."""
    jv = jvolume.make_volume(sc["jg"], sc["T"], frame_cap=64)
    jp = jvolume.PackedVolume.from_volume(jv)
    st = Streams(sc, jp, _tp(jp), "dma")
    st.refresh(EYE, capacity=8)
    assert int(st.tres.flags) & TR.FLAG_CAPACITY

    st.refresh(FLIP, capacity=_nseg(sc))
    empty_t, empty_j = st.tres, st.jres
    st.alloc(EYE, delta_capacity=8)
    assert int(st.tres.flags) & TR.FLAG_DELTA
    assert int(st.tres.n_used) == 8

    st.tres, st.jres = empty_t, empty_j
    st.fuse(EYE, 1)
    assert int(st.tres.flags) & TR.FLAG_COVERAGE
    assert (TR.FLAG_CAPACITY, TR.FLAG_DELTA, TR.FLAG_COVERAGE,
            TR.FLAG_TRACK_MISS) == (JR.FLAG_CAPACITY, JR.FLAG_DELTA,
                                    JR.FLAG_COVERAGE, JR.FLAG_TRACK_MISS)


def test_streaming_views_and_ledger(sc):
    """to_streaming / from_streaming are views of the canonical storage, and
    fused_ever_from_vis is the JAX package's."""
    jp, tp = _start(sc)
    for seg in (None, 8):
        s = TR.to_streaming(tp, seg)
        js = JR.to_streaming(jp, seg)
        assert tuple(s.payload.shape) == tuple(js.payload.shape)
        assert s.payload.data_ptr() == tp.payload.data_ptr()
        np.testing.assert_array_equal(
            TR.fused_ever_from_vis(s).numpy(),
            np.asarray(JR.fused_ever_from_vis(js)))
        back = TR.from_streaming(s, sc["tg"].dims)
        assert _equal(back, tp)
