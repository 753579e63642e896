"""The scan programs' two kernel modules of the PyTorch package, on the CPU,
where their wrappers run the plain versions: ops/fuse.py (the fusion update
in place on rows of state, through per-field strides) and ops/gn.py (a
frame's whole Gauss-Newton solve on a device carry, and the Gram of frozen
records).

Against the JAX package, on the same numpy inputs: fuse_rows on SoA row
blocks, on packed [CAP,S,8] rows, on the whole grid and on Z-slabs against
the JAX package's _fuse_voxel_update on _row_world_coords and its
fuse_frame; track_frame (through ops/gn.gn_solve) against the JAX package's
track_frame for the four named tracker configurations.  Tolerances are
those of tests/test_torch_volume.py (visibility exact, float fields within
helpers_torch.field_tolerances at 4 float32 ULPs of the scene's depth per
fused frame) and of tests/test_torch_tracker.py (iterations, converged and
valid pixels equal, pose atol 1e-5, energy rtol 1e-4).  Within the PyTorch
package: track_frame equals run_gn_rounds_plain and the mesh trackers'
round loop (run_gn_rounds over the plain records and Gram) bit for bit,
slots at or past `live` and slots with a false gate keep their state, the
carry buffer holds its values exactly, and no CPU call launches a kernel.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgradientsdf_tpu.core import volume as jvolume
from psgradientsdf_tpu.tracking import configs as jconfigs
from psgradientsdf_tpu.tracking import tracker as jtracker
from psgradientsdf_tpu_torch.core import volume as tvolume
from psgradientsdf_tpu_torch.ops import fuse as tfuse
from psgradientsdf_tpu_torch.ops import gn as tgn
from psgradientsdf_tpu_torch.tracking import configs as tconfigs
from psgradientsdf_tpu_torch.tracking import tracker as ttracker

from helpers_torch import (
    CPU, field_tolerances, fuse_both, gn_rounds_over_plain_callables,
    se3_exp_np, to_torch_vol, vol_to_numpy_j,
)
from test_torch_tracker import INITS, ZKW as TRACK_ZKW, _assert_same
from test_torch_tracker import scene as track_scene  # noqa: F401 (fixture)
from test_torch_volume import _poses, _scene32

torch.set_num_threads(1)

DEPTH = 1.5
ZKW = dict(zmin=0.1, zmax=5.0)
COS_SQ = 0.25 * 0.25
IMAGES = ("color", "depth", "normals", "n_sq_inv")
CONFIGS = ("REFERENCE", "STREAMING", "PARITY", "STREAMING_FAST")


# --------------------------------------------------------------- the update


@functools.lru_cache(maxsize=None)
def _state():
    """The 32^3 scene after two frames fused by the JAX package (numpy),
    the next frame's pose and pixel payload, and a row set: 150 distinct
    grid rows in random order, then 50 padding slots that repeat slot 0."""
    sc = _scene32()
    jv = jvolume.make_volume(sc["jg"], sc["T"], frame_cap=64)
    for n, pose in enumerate(_poses()[:2]):
        jv, _, _, _ = fuse_both(jv, None, sc["jg"], sc["tg"], sc["fr"], sc["K"],
                                pose, 30 + n, sc["T"])
    rng = np.random.default_rng(3)
    X, Y, Z = sc["jg"].dims
    live = 150
    # slot 0 (which the padding repeats) is the row of the most weight
    weight = np.asarray(jv.weight).reshape(Z * Y, X).sum(-1)
    first = int(np.argmax(weight))
    rows = rng.permutation(np.delete(np.arange(Z * Y), first))[:live - 1]
    rows = np.concatenate([[first], rows, np.full(50, first)]).astype(np.int32)
    pix = np.concatenate([sc["fr"]["depth"][..., None], sc["fr"]["normals"],
                          sc["fr"]["color"], sc["fr"]["n_sq_inv"][..., None]],
                         -1).reshape(-1, 8).astype(np.float32)
    return sc, vol_to_numpy_j(jv), _poses()[2], pix, rows, live


def _jax_rows_update(sc, state, pose, pix, rows, fid, z0=None):
    """The JAX package's per-voxel update on the rows (numpy in and out):
    (dist, grad, weight, color, vis word after the OR)."""
    X, Y, Z = sc["jg"].dims
    n = rows.shape[0]
    p_w = jvolume._row_world_coords(sc["jg"], jnp.asarray(rows),
                                    None if z0 is None else jnp.int32(z0),
                                    X, 1, n)
    word, bit = fid // 32, np.uint32(1 << (fid % 32))
    take = {k: state[k].reshape(Z * Y, X, -1)[rows] for k in ("grad", "color")}
    take.update({k: state[k].reshape(Z * Y, X)[rows] for k in ("dist", "weight")})
    vis = state["vis"][word].reshape(Z * Y, X)[rows]
    fn = jax.jit(functools.partial(
        jvolume._fuse_voxel_update, img_hw=sc["fr"]["depth"].shape,
        truncation=sc["T"], cos_thresh_sq=COS_SQ, **ZKW))
    nd, ng, nw, nc, vis_or = fn(p_w, take["dist"], take["grad"], take["weight"],
                                take["color"], jnp.asarray(pix),
                                jnp.asarray(sc["K"]), jnp.asarray(pose),
                                bit=jnp.uint32(bit), gate=None)
    return (np.asarray(nd), np.asarray(ng), np.asarray(nw), np.asarray(nc),
            vis | np.asarray(vis_or))


def _bit(fid):
    return tvolume._vis_word_bit(fid)[1]


def _tol(sc, frames):
    return field_tolerances(DEPTH, sc["T"], 4 * frames)


def _rows_fields(state, rows, layout, sc, word):
    """Gathered [CAP, ...] rows of the state as torch tensors -> (tensors
    to keep, the five field views fuse_rows takes)."""
    X, Y, Z = sc["jg"].dims
    d = torch.from_numpy(state["dist"].reshape(Z * Y, X)[rows].copy())
    g = torch.from_numpy(state["grad"].reshape(Z * Y, X, 3)[rows].copy())
    w = torch.from_numpy(state["weight"].reshape(Z * Y, X)[rows].copy())
    c = torch.from_numpy(state["color"].reshape(Z * Y, X, 3)[rows].copy())
    v = torch.from_numpy(
        state["vis"][word].reshape(Z * Y, X)[rows].view(np.int32).copy())
    if layout == "soa":
        return [d, g, w, c, v], (d, g, w, c, v)
    r8 = torch.cat([d[..., None], g, w[..., None], c], -1).contiguous()
    return [r8, v], (r8[..., 0], r8[..., 1:4], r8[..., 4], r8[..., 5:8], v)


def _check_rows(sc, fields, want, n, where):
    """The first n slots against the JAX rows: vis exact, floats within the
    fused-frame tolerance (dist and colour in their accumulated form)."""
    tol = _tol(sc, 1)
    d, g, w, c, v = (f[:n].numpy() for f in fields)
    jd, jg, jw, jc, jv = (a[:n] for a in want)
    np.testing.assert_array_equal(v.view(np.uint32), jv, err_msg=where)
    wm = np.minimum(jw, 1.0)
    assert np.abs(w - jw).max() <= tol["weight"], where
    assert np.abs(g - jg).max() <= tol["grad"], where
    assert (np.abs(d - jd) * wm).max() <= tol["dist"], where
    assert (np.abs(c - jc).max(-1) * wm).max() <= tol["color"], where


@pytest.mark.parametrize("layout", ["soa", "packed"])
def test_fuse_rows_on_gathered_rows_matches_jax_update(layout):
    """SoA row blocks and packed [CAP,S,8] rows (stride-8 field views): the
    live slots get the JAX package's update; the padding slots past `live`
    are left as they were gathered."""
    sc, state, pose, pix, rows, live = _state()
    fid = 33
    _, fields = _rows_fields(state, rows, layout, sc, fid // 32)
    before = [f.clone() for f in fields]
    tfuse.fuse_rows(*fields, torch.from_numpy(pix), torch.from_numpy(sc["K"]),
                    torch.from_numpy(pose), sc["fr"]["depth"].shape, _bit(fid),
                    None, geom=sc["tg"], S=32, rows=torch.from_numpy(rows),
                    live=torch.tensor(live), truncation=sc["T"],
                    cos_thresh_sq=COS_SQ, **ZKW)
    want = _jax_rows_update(sc, state, pose, pix, rows[:live], fid)
    _check_rows(sc, fields, want, live, layout)
    assert int((fields[4][:live] & _bit(fid) != 0).sum()) > 200
    # slot 0 moved, and the padding slots that repeat it did not
    assert not torch.equal(fields[2][0], before[2][0])
    for a, b in zip(fields, before):
        assert torch.equal(a[live:], b[live:])


def test_fuse_rows_packed_equals_soa_bit_for_bit():
    sc, state, pose, pix, rows, live = _state()
    out = {}
    for layout in ("soa", "packed"):
        _, fields = _rows_fields(state, rows, layout, sc, 1)
        tfuse.fuse_rows(*fields, torch.from_numpy(pix), torch.from_numpy(sc["K"]),
                        torch.from_numpy(pose), sc["fr"]["depth"].shape, _bit(40),
                        None, geom=sc["tg"], S=32, rows=torch.from_numpy(rows),
                        live=torch.tensor(live), truncation=sc["T"],
                        cos_thresh_sq=COS_SQ, **ZKW)
        out[layout] = [f.clone() for f in fields]
    for a, b in zip(out["soa"], out["packed"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("planes", ["whole", "z0", "z_map"])
def test_fuse_rows_on_the_grid_in_place_matches_jax_fuse_frame(planes):
    """The whole grid a row a slot (rows None), or a Z-slab of it named by
    z0 (contiguous) or z_map (interleaved planes), updated in place: the
    JAX package's full-grid fuse_frame on those planes."""
    sc, state, pose, pix, _, _ = _state()
    X, Y, Z = sc["jg"].dims
    fid = 35
    jv = jvolume.GradSdfVolume(*(jnp.asarray(state[k]) for k in
                                 ("dist", "grad", "weight", "color", "vis")))
    jv, _, _, _ = fuse_both(jv, None, sc["jg"], sc["tg"], sc["fr"], sc["K"],
                            pose, fid, sc["T"])
    want = vol_to_numpy_j(jv)
    planes_idx = {"whole": np.arange(Z), "z0": np.arange(8, 20),
                  "z_map": np.arange(3, Z, 4)}[planes]
    tv = to_torch_vol(jvolume.GradSdfVolume(
        *(jnp.asarray(state[k]) for k in ("dist", "grad", "weight", "color", "vis"))))
    sel = torch.from_numpy(planes_idx)
    slab = [t[sel].contiguous() for t in (tv.dist, tv.grad, tv.weight, tv.color)]
    vis = tv.vis[fid // 32][sel].contiguous()
    n = len(planes_idx) * Y
    kw = dict(z0=8 if planes == "z0" else None,
              z_map=sel.to(torch.int32) if planes == "z_map" else None)
    tfuse.fuse_rows(slab[0].view(n, X), slab[1].view(n, X, 3), slab[2].view(n, X),
                    slab[3].view(n, X, 3), vis.view(n, X), torch.from_numpy(pix),
                    torch.from_numpy(sc["K"]), torch.from_numpy(pose),
                    sc["fr"]["depth"].shape, _bit(fid), None, geom=sc["tg"],
                    S=X, truncation=sc["T"], cos_thresh_sq=COS_SQ, **ZKW, **kw)
    rows_want = [want[k][planes_idx].reshape((n, X) + want[k].shape[3:])
                 for k in ("dist", "grad", "weight", "color")]
    rows_want.append(want["vis"][fid // 32][planes_idx].reshape(n, X))
    fields = [slab[0].view(n, X), slab[1].view(n, X, 3), slab[2].view(n, X),
              slab[3].view(n, X, 3), vis.view(n, X)]
    _check_rows(sc, fields, rows_want, n, planes)


def test_fuse_rows_false_gate_is_a_no_op_and_a_slot_gate_selects():
    """gate False: no slot changes.  One gate a slot: the slots it opens get
    the ungated update, the others keep their state."""
    sc, state, pose, pix, rows, live = _state()
    args = (torch.from_numpy(pix), torch.from_numpy(sc["K"]),
            torch.from_numpy(pose), sc["fr"]["depth"].shape, _bit(34))
    kw = dict(geom=sc["tg"], S=32, rows=torch.from_numpy(rows),
              live=torch.tensor(live), truncation=sc["T"],
              cos_thresh_sq=COS_SQ, **ZKW)
    _, base = _rows_fields(state, rows, "soa", sc, 1)
    _, off = _rows_fields(state, rows, "soa", sc, 1)
    tfuse.fuse_rows(*off, *args, torch.tensor(False), **kw)
    for a, b in zip(off, base):
        assert torch.equal(a, b)
    _, full = _rows_fields(state, rows, "soa", sc, 1)
    tfuse.fuse_rows(*full, *args, None, **kw)
    _, half = _rows_fields(state, rows, "soa", sc, 1)
    open_ = torch.arange(rows.shape[0]) % 2 == 0
    tfuse.fuse_rows(*half, *args, open_[:, None], **kw)
    for a, b, f in zip(half, base, full):
        assert torch.equal(a[open_], f[open_])
        assert torch.equal(a[~open_], b[~open_])
    assert not torch.equal(full[2], base[2])          # the update did move weight


def test_fuse_rows_checks_its_arguments():
    sc, state, pose, pix, rows, live = _state()
    _, (d, g, w, c, v) = _rows_fields(state, rows, "soa", sc, 1)
    args = (torch.from_numpy(pix), torch.from_numpy(sc["K"]),
            torch.from_numpy(pose), sc["fr"]["depth"].shape, _bit(34), None)
    kw = dict(geom=sc["tg"], S=32, truncation=sc["T"], cos_thresh_sq=COS_SQ, **ZKW)
    with pytest.raises(ValueError, match="grad"):
        tfuse.fuse_rows(d, g[:, :, :2], w, c, v, *args, **kw)
    with pytest.raises(TypeError, match="rows"):
        tfuse.fuse_rows(d, g, w, c, v, *args, rows=torch.from_numpy(rows).long(), **kw)
    with pytest.raises(ValueError, match="pix_payload"):
        tfuse.fuse_rows(d, g, w, c, v, args[0][:-1], *args[1:], **kw)


# ------------------------------------------------------------ the GN solve


def _track_kw(config):
    return dict(getattr(tconfigs, config))


@pytest.mark.parametrize("config", CONFIGS)
def test_track_frame_through_gn_step_equals_run_gn_rounds_bit_for_bit(
        track_scene, config):
    sc = track_scene
    for init in ("near", "far"):
        seed = se3_exp_np(INITS[init])
        kw = dict(device=CPU, **TRACK_ZKW, **_track_kw(config))
        a = ttracker.track_frame(sc["tv"], sc["tg"], sc["depth"], sc["K"], seed, **kw)
        b = ttracker.run_gn_rounds_plain(sc["tv"], sc["tg"], sc["depth"], sc["K"],
                                         seed, **kw)
        c = gn_rounds_over_plain_callables(sc["tv"], sc["tg"], sc["depth"],
                                           sc["K"], seed, **kw)
        for x, y, z in zip(a, b, c):
            assert x.dtype == y.dtype and torch.equal(x, y), (config, init)
            assert x.dtype == z.dtype and torch.equal(x, z), (config, init)


@pytest.mark.parametrize("config", CONFIGS)
def test_track_frame_matches_jax_for_the_named_configs(track_scene, config):
    sc = track_scene
    kw = _track_kw(config)
    init = se3_exp_np(INITS["near"])
    a = jtracker.track_frame(sc["jv"], sc["jg"], jnp.asarray(sc["depth"]),
                             jnp.asarray(sc["K"]), jnp.asarray(init),
                             **TRACK_ZKW, **getattr(jconfigs, config))
    b = ttracker.track_frame(sc["tv"], sc["tg"], sc["depth"], sc["K"], init,
                             device=CPU, **TRACK_ZKW, **kw)
    _assert_same(a, b)


def test_carry_buffer_packs_and_unpacks_exactly():
    rng = np.random.default_rng(5)
    pose = torch.from_numpy(se3_exp_np(rng.normal(size=6) * 0.1))
    carry = tgn.new_carry(pose)
    assert carry.shape == (tgn.CARRY_SIZE,) and carry.dtype == torch.float32
    p, conv, fail, stalled, e, count, iters, S = tgn.unpack_carry(carry)
    assert torch.equal(p, pose)
    assert not bool(conv | fail | stalled)
    assert float(e) == 0.0 and int(count) == 0 and int(iters) == 0
    assert count.dtype == iters.dtype == torch.int32
    vals = (pose * 2, torch.tensor(True), torch.tensor(False), torch.tensor(True),
            torch.tensor(0.123456789, dtype=torch.float32),
            torch.tensor(307199, dtype=torch.int32), torch.tensor(17, dtype=torch.int32),
            torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32)))
    tgn.pack_carry(carry, *vals)
    back = tgn.unpack_carry(carry)
    for a, b in zip(back, vals):
        assert torch.equal(a, b.to(a.dtype)), (a, b)
    # unpacking gives new tensors: the buffer may be written again
    carry.zero_()
    assert torch.equal(back[0], pose * 2)


def test_records_round_trip_and_the_gram_of_frozen_records(track_scene):
    """gram() on the [N,8] records equals the plain Gram on the records'
    tuple; a fresh step that keeps its records and a frozen step on them
    equal gn_update on those Grams."""
    sc = track_scene
    frame = tgn.GnFrame(sc["tg"], torch.from_numpy(sc["depth"]),
                        torch.from_numpy(sc["K"]), stride=1, vol=sc["tv"],
                        zmin=TRACK_ZKW["zmin"], zmax=TRACK_ZKW["zmax"])
    pose = torch.from_numpy(se3_exp_np(INITS["near"]))
    rec = tgn.frame_records(frame, pose)
    packed = tgn.pack_records(*rec)
    for a, b in zip(tgn.unpack_records(packed), rec):
        assert torch.equal(a, b)
    S = tgn.gram_plain(frame.points()[0], pose, rec)
    assert torch.equal(tgn.gram(frame, pose, packed), S)
    assert int(S[7, 7]) == int(rec[3].sum()) > 1000

    kw = dict(conv_threshold_sq=1e-12, damping=1.0)
    # a fresh step that keeps its records (the plain step)
    records = torch.empty((frame.n, 8))
    tgn.gn_step_plain(frame, tgn.new_carry(pose), records, fresh=True,
                      num_iterations=10, **kw)
    assert torch.equal(records, packed)
    # one step: gn_solve(num_iterations=1)
    carry = tgn.new_carry(pose)
    tgn.gn_solve(frame, carry, num_iterations=1, **kw)
    zero_b = torch.tensor(False)
    want = tgn.gn_update(
        (pose, zero_b, zero_b, zero_b, torch.tensor(0.0),
         torch.tensor(0, dtype=torch.int32), torch.tensor(0, dtype=torch.int32)),
        *tgn.split_gram(S), fresh=True, lever=tgn.trust_lever(sc["tg"]),
        voxel_size=sc["tg"].voxel_size, num_iterations=1, **kw)
    got = tgn.unpack_carry(carry)
    for a, b in zip(got[:7], want):
        assert torch.equal(a, b)
    assert torch.equal(got[7], S)
    assert int(got[6]) == 1
    pose1 = got[0]
    # a fresh and a frozen step on its records: the frozen step's S
    carry = tgn.new_carry(pose)
    tgn.gn_solve(frame, carry, num_iterations=2, regather_every=2,
                 early_exit=False, **kw)
    S1 = tgn.gram_plain(frame.points()[0], pose1, rec)
    assert torch.equal(tgn.unpack_carry(carry)[7], S1)
    with pytest.raises(ValueError, match="fresh"):
        tgn.gn_solve(frame, carry, num_iterations=2, regather_every=0, **kw)


def test_cpu_calls_launch_nothing(track_scene):
    sc = track_scene
    tfuse.reset_launch_counts()
    tgn.reset_launch_counts()
    ttracker.steps_run["track_frame"] = 0
    ttracker.track_frame(sc["tv"], sc["tg"], sc["depth"], sc["K"],
                         se3_exp_np(INITS["near"]), device=CPU, **TRACK_ZKW,
                         **_track_kw("STREAMING"))
    # one solve a frame (STREAMING: two rounds of four steps, fixed-trip)
    assert ttracker.steps_run["track_frame"] == 1
    s2, state, pose, pix, rows, live = _state()
    _, fields = _rows_fields(state, rows, "packed", s2, 1)
    tfuse.fuse_rows(*fields, torch.from_numpy(pix), torch.from_numpy(s2["K"]),
                    torch.from_numpy(pose), s2["fr"]["depth"].shape, _bit(34),
                    None, geom=s2["tg"], S=32, rows=torch.from_numpy(rows),
                    live=torch.tensor(live), truncation=s2["T"],
                    cos_thresh_sq=COS_SQ, **ZKW)
    assert tfuse.launch_counts == {"fuse_rows": 0}
    assert tgn.launch_counts == {"gn_solve": 0, "gn_gram": 0}


def test_culled_fusion_launch_pattern_goes_through_fuse_rows(monkeypatch):
    """A culled fusion runs its update as ONE fuse_rows call on the gathered
    rows (SoA and packed), with the live count; a K-batched fusion one a
    frame; fuse_frame one on the whole grid."""
    sc = _scene32()
    calls = []
    real = tfuse.fuse_rows

    def counted(*a, **kw):
        calls.append((a[0].shape, kw.get("live") is not None))
        return real(*a, **kw)

    monkeypatch.setattr(tfuse, "fuse_rows", counted)
    args = [sc["fr"][k] for k in IMAGES]
    kw = dict(truncation=sc["T"], device=CPU, **ZKW)
    tv = tvolume.make_volume(sc["tg"], sc["T"], frame_cap=64, device=CPU)
    tv = tvolume.fuse_frame(tv, sc["tg"], *args, sc["K"], np.eye(4), 0, **kw)
    assert calls == [((32 * 32, 32), False)]
    tvolume.fuse_frame_culled(tv, sc["tg"], *args, sc["K"], _poses()[1], 1,
                              row_capacity=512, **kw)
    tvolume.fuse_frame_culled_packed(tvolume.PackedVolume.from_volume(tv), sc["tg"],
                                     *args, sc["K"], _poses()[1], 1,
                                     row_capacity=512, **kw)
    assert calls[1:] == [((512, 32), True)] * 2
    del calls[:]
    stack = {k: np.stack([sc["fr"][k]] * 3) for k in IMAGES}
    tvolume.fuse_frames_culled(tv, sc["tg"], *(stack[k] for k in IMAGES), sc["K"],
                               np.stack(_poses()[1:4]), [1, 2, 3],
                               row_capacity=1024, **kw)
    assert calls == [((1024, 32), True)] * 3


def test_the_first_cuda_library_asked_for_builds_the_others_beside_it(
        tmp_path, monkeypatch):
    """kernels.load_library starts one compiler a source for every library of
    CUDA_LIBRARIES at once (here two host sources stand in for the CUDA
    ones: this machine has no nvcc) and loads the one asked for."""
    from psgradientsdf_tpu_torch import kernels

    cu = sorted(f[:-3] for f in os.listdir(kernels.CSRC_DIR) if f.endswith(".cu"))
    assert sorted(kernels.CUDA_LIBRARIES) == cu == ["albedo", "cull", "distcg", "distreg",
                                                    "energy", "fuse", "gn", "normaleq",
                                                    "preprocess", "residual",
                                                    "rowcopy", "smallsolve"]
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("one", "two"):
        (src / f"{name}.cpp").write_text(f'extern "C" int {name}() {{ return 7; }}\n')
    monkeypatch.setattr(kernels, "CSRC_DIR", str(src))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "CUDA_LIBRARIES", ("one", "two"))
    monkeypatch.setattr(kernels, "_libs", {})
    assert kernels.load_library("one").one() == 7
    assert os.path.isfile(kernels.library_path("two"))
    assert set(kernels._libs) == {"one"}
    assert kernels.load_library("two").two() == 7
