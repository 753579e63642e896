"""io/checkpoint.py of the PyTorch package, the scan and refinement resume
built on it, and its files against the JAX package's.

Checkpoint files are the JAX package's format: the same arrays under the same
names in the same dtypes and shapes, and the same sidecar, so a checkpoint
written by either package loads in the other — integers and masks equal,
floats bit for bit.  Resume within the port is exact: an interrupted and
resumed scan, or refinement (before and after the iteration-5 upsample),
ends bit-identical to the uninterrupted run.  A port scan resumed from a JAX
checkpoint continues from state the two packages computed each in their own
arithmetic, so it is held to the tracker's convergence ball (atol 1e-3 on
the poses, as tests/test_torch_stream_pipeline.py holds the two command
lines).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgradientsdf_tpu.config import OptimizerConfig as JOptimizerConfig
from psgradientsdf_tpu.config import parse_config as jparse_config
from psgradientsdf_tpu.io import checkpoint as jckpt
from psgradientsdf_tpu.pipeline import ReconstructionPipeline as JPipeline
from psgradientsdf_tpu.refine.optimizer import PhotometricRefiner as JRefiner
from psgradientsdf_tpu.utils import se3 as jse3
from psgradientsdf_tpu_torch import convert
from psgradientsdf_tpu_torch.config import OptimizerConfig, parse_config
from psgradientsdf_tpu_torch.io import checkpoint as ckpt
from psgradientsdf_tpu_torch.io.trajectory import read_trajectory
from psgradientsdf_tpu_torch.pipeline import ReconstructionPipeline
from psgradientsdf_tpu_torch.refine.optimizer import PhotometricRefiner
from psgradientsdf_tpu_torch.utils import robust
from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

from helpers import shaded_images, wavy_scene
from helpers_torch import CPU, FIELDS, to_torch_vol, vol_to_numpy_j, t2n
from test_e2e_tum_tracking import make_tum_dataset

torch.set_num_threads(1)

STATE = ("dist", "albedo", "grad_stored", "poses", "lights")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def _layout(path):
    """{name: (dtype, shape)} of an .npz file."""
    with np.load(path) as data:
        return {k: (str(data[k].dtype), data[k].shape) for k in data.files}


# ------------------------------------------------------------- the volume


def test_volume_roundtrip_exact(tmp_path):
    sc = wavy_scene(dim=32, h=0.04, H=48, W=48, f=45.0)
    vol = to_torch_vol(sc["vol"])
    vis = vol.vis.clone()
    vis[0, 3, 4, 5] = -2 ** 31                  # bit 31 of a word
    vol = vol._replace(vis=vis)
    geom = convert.geometry(sc["geom"].dims, sc["geom"].voxel_size, sc["geom"].shift)
    path = str(tmp_path / "vol.npz")
    ckpt.save_volume(path, vol, geom, meta={"frame": 7})
    vol2, geom2, meta = ckpt.load_volume(path, device=CPU)
    assert meta == {"frame": 7} and geom2 == geom
    for name, a, b in zip(vol._fields, vol, vol2):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert _layout(path)["vis"][0] == "uint32"
    if not torch.cuda.is_available():           # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            ckpt.load_volume(path)


def test_volume_files_cross_between_the_packages(tmp_path):
    sc = wavy_scene(dim=32, h=0.04, H=48, W=48, f=45.0)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_volume(jpath, sc["vol"], sc["geom"], meta={"next_frame": 3})
    tvol, tgeom, meta = ckpt.load_volume(jpath, device=CPU)
    assert meta == {"next_frame": 3}
    assert (tgeom.dims, tgeom.voxel_size, tgeom.shift) == (
        tuple(sc["geom"].dims), sc["geom"].voxel_size, tuple(sc["geom"].shift))
    want = vol_to_numpy_j(sc["vol"])
    got = convert.volume_to_numpy(tvol)
    for k in FIELDS + ("vis",):
        _assert_bits_equal(got[k], want[k], k)

    ckpt.save_volume(tpath, tvol, tgeom, meta={"next_frame": 3})
    assert _layout(tpath) == _layout(jpath)
    with open(jpath + ".json") as fj, open(tpath + ".json") as ft:
        assert json.load(fj) == json.load(ft)
    jvol, jgeom, _ = jckpt.load_volume(tpath)
    assert jgeom == sc["geom"]
    for k in FIELDS + ("vis",):
        _assert_bits_equal(np.asarray(getattr(jvol, k)), want[k], k)


def test_scan_state_files_cross_between_the_packages(tmp_path):
    sc = wavy_scene(dim=32, h=0.04, H=48, W=48, f=45.0)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (48, 48, 3), dtype=np.uint8) for _ in range(3)]
    poses = [np.eye(4, dtype=np.float32)] + [
        (np.eye(4) + 0.01 * rng.standard_normal((4, 4))).astype(np.float32)
        for _ in range(2)]
    kw = dict(next_frame=9, cur_pose=poses[-1], pose_lines=["a 1", "b 2"],
              key_indices=[0, 3, 7], key_stamps=["0.0", "0.3", "0.7"],
              key_poses=poses, dist_to_last_kf=1)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_scan_state(jpath, sc["vol"], sc["geom"], jckpt.ScanState(**kw), images)
    tvol, tgeom, state, timages = ckpt.load_scan_state(jpath, device=CPU)
    for k, v in kw.items():
        got = getattr(state, k)
        if k in ("cur_pose", "key_poses"):
            _assert_bits_equal(np.stack(got) if k == "key_poses" else got,
                               np.stack(v) if k == "key_poses" else v, k)
        else:
            assert got == v, k
    _assert_bits_equal(np.stack(timages), np.stack(images), "key_images")

    ckpt.save_scan_state(tpath, tvol, tgeom, state, timages)
    assert _layout(tpath + ".scan") == _layout(jpath + ".scan")
    jvol, jgeom, jstate, jimages = jckpt.load_scan_state(tpath)
    assert jstate.pose_lines == kw["pose_lines"] and jstate.next_frame == 9
    assert jstate.key_indices == kw["key_indices"]
    _assert_bits_equal(np.stack(jstate.key_poses), np.stack(poses), "key_poses")
    _assert_bits_equal(np.stack(jimages), np.stack(images), "key_images")
    for k in FIELDS + ("vis",):
        _assert_bits_equal(np.asarray(getattr(jvol, k)),
                           vol_to_numpy_j(sc["vol"])[k], k)


# ------------------------------------------------------------- the refinement


def _refine_scene(dim=32, h=0.04, H=48, W=48, f=45.0):
    """The two-view shaded scene of the JAX package's refinement checkpoint
    tests (test_checkpoint_prefetch.py)."""
    poses = [jnp.eye(4, dtype=jnp.float32),
             jse3.se3_exp(0.02 * jnp.asarray(
                 np.random.RandomState(1).randn(6).astype(np.float32)))]
    sc = wavy_scene(dim=dim, h=h, H=H, W=W, f=f, poses=poses)
    light = jnp.array([0.1, 0.2, -0.15, 0.85], dtype=jnp.float32)
    sc["images"] = np.asarray(shaded_images(sc["frames"], light, order=1))
    sc["poses"] = np.stack([np.asarray(p) for p in poses])
    return sc


CFG = dict(max_it=4, conv_threshold=1e-9, damping=1.0, lam=0.2,
           reg_weight_n=1.0, reg_weight_l=0.0, reg_weight_rho=0.0,
           order=1, model="SH1", loss=robust.CAUCHY)


def _torch_refiner(sc, **cfg_kw):
    geom = convert.geometry(sc["geom"].dims, sc["geom"].voxel_size, sc["geom"].shift)
    ref = PhotometricRefiner(to_torch_vol(sc["vol"]), geom,
                             OptimizerConfig(**dict(CFG, **cfg_kw)),
                             np.array(sc["K"]), truncation=sc["truncation"],
                             metrics=MetricsLogger(None, echo=False))
    ref.set_keyframes(sc["images"], sc["poses"], [0, 1], ["000", "001"])
    ref.init()
    return ref


def _jax_refiner(sc, **cfg_kw):
    ref = JRefiner(sc["vol"], sc["geom"], JOptimizerConfig(**dict(CFG, **cfg_kw)),
                   np.array(sc["K"]), truncation=sc["truncation"])
    ref.set_keyframes(sc["images"], sc["poses"], [0, 1], ["000", "001"])
    ref.init()
    return ref


def _empty_refiner(sc, **cfg_kw):
    """What a refinement resume builds before any volume exists: the
    intrinsics and the truncation come from the recipe, the rest from the
    checkpoint."""
    return PhotometricRefiner(None, None, OptimizerConfig(**dict(CFG, **cfg_kw)),
                              np.array(sc["K"]), truncation=sc["truncation"],
                              device=CPU, metrics=MetricsLogger(None, echo=False))


@pytest.fixture(scope="module")
def refine_scene():
    return _refine_scene()


def _assert_refiners_equal(t, j):
    """A torch refiner against a JAX one: every problem field, the state, the
    images, the loop state and the bookkeeping, bit for bit."""
    assert t.keyframe_indices == [int(v) for v in j.keyframe_indices]
    assert t.timestamps == list(j.timestamps)
    assert tuple(t.geom.dims) == tuple(j.geom.dims)
    tp = convert.problem_to_numpy(t.prob)
    for k, v in zip(j.prob._fields, j.prob):
        assert tp[k].dtype == np.asarray(v).dtype, k
        _assert_bits_equal(tp[k], np.asarray(v), "prob." + k)
    for name in STATE + ("images",):
        _assert_bits_equal(t2n(getattr(t, name)), np.asarray(getattr(j, name)), name)
    got = convert.volume_to_numpy(t.vol)
    for k in FIELDS + ("vis",):
        _assert_bits_equal(got[k], np.asarray(getattr(j.vol, k)), "vol." + k)


def test_refine_state_files_cross_between_the_packages(tmp_path, refine_scene):
    sc = refine_scene
    jref = _jax_refiner(sc)
    jref.init_albedo()
    jref.lights = jref.lights + 0.01
    jref.loop_state = {"it": 3, "w_n": 0.25, "w_l": 0.0, "w_rho": 0.0,
                       "normal_reg": True, "albedo_reg": False,
                       "laplacian_reg": False, "E": 1.5, "E_n": 0.25,
                       "E_l": 0.0, "E_r": 0.0, "E_vec": [3.0, 2.0, 1.75]}
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_refine_state(jpath, jref)

    tref = _empty_refiner(sc)
    ckpt.load_refine_state(jpath, tref)
    _assert_refiners_equal(tref, jref)
    assert tref.loop_state == jref.loop_state
    np.testing.assert_allclose(tref.energies(), [float(e) for e in jref.energies()],
                               rtol=1e-4)

    ckpt.save_refine_state(tpath, tref)
    for suffix in ("", ".refine", ".images"):
        assert _layout(tpath + suffix) == _layout(jpath + suffix), suffix
    with open(jpath + ".json") as fj, open(tpath + ".json") as ft:
        assert json.load(fj) == json.load(ft)
    jref2 = _jax_refiner(sc)
    jckpt.load_refine_state(tpath, jref2)
    _assert_refiners_equal(tref, jref2)
    assert jref2.loop_state == jref.loop_state


@pytest.mark.parametrize("fused", [True, False])
def test_refine_midrun_checkpoint_resume_exact(tmp_path, refine_scene, fused):
    """A run resumed from a mid-loop checkpoint ends bit-identical to the
    uninterrupted run, with the same trace, iteration count and stop reason."""
    rA = _torch_refiner(refine_scene, fused_iterations=fused)
    rA.alternating_optimize(True, True, True, True)

    rB = _torch_refiner(refine_scene, fused_iterations=fused)
    rB.checkpoint_every = 3
    rB.checkpoint_path = str(tmp_path / "refine_checkpoint.npz")
    rB.alternating_optimize(True, True, True, True)
    assert os.path.exists(rB.checkpoint_path)
    assert rB.loop_state is None                # cleared when the loop ends

    rC = _empty_refiner(refine_scene, fused_iterations=fused)
    ckpt.load_refine_state(rB.checkpoint_path, rC)
    assert rC.loop_state["it"] == 3
    assert len(rC.loop_state["energy_trace"]) == 1 + 3 * 4   # init + 3 x 4 blocks
    rC.alternating_optimize(True, True, True, True)
    for name in STATE:
        assert torch.equal(getattr(rA, name), getattr(rC, name)), name
    assert rC.energy_trace == rA.energy_trace
    assert (rC.iterations_run, rC.stop_reason) == (rA.iterations_run, rA.stop_reason)
    assert rA.iterations_run == 4           # the resumed part ran and stopped


def test_refine_checkpoint_after_upsample_resumes_exact(tmp_path):
    """A checkpoint after the iteration-5 upsample (8x the voxels, new
    capacities, doubled grid) restores the post-upsample shapes verbatim and
    resumes bit-exactly (mirrors the JAX package's test: the upsample and the
    loop state are planted, since alternating GN rarely survives to iteration
    6 on this scene)."""
    sc = _refine_scene(dim=24, h=0.05, H=40, W=40, f=38.0)
    kw = dict(max_it=7, conv_threshold=1e-12, upsample=True)
    rB = _torch_refiner(sc, **kw)
    rB.init_albedo()
    rB._upsample()
    assert rB.geom.dims == (48, 48, 48)
    E, E_n, E_l, E_r = rB.energies()
    rB.loop_state = {
        "it": 6, "w_n": 1.0, "w_l": 0.5, "w_rho": 0.0,
        "normal_reg": True, "albedo_reg": False, "laplacian_reg": True,
        "E": E, "E_n": E_n, "E_l": E_l, "E_r": E_r,
        "E_vec": [1e9, E + E_n + 0.5 * E_l]}    # huge first entry: no abort
    path = str(tmp_path / "refine_checkpoint.npz")
    ckpt.save_refine_state(path, rB)

    rC = _empty_refiner(sc, **kw)
    ckpt.load_refine_state(path, rC)
    assert rC.loop_state["it"] == 6 and rC.geom.dims == (48, 48, 48)
    assert rC.dist.shape == rB.dist.shape
    for name in STATE:
        assert torch.equal(getattr(rB, name), getattr(rC, name)), name
    assert rB.alternating_optimize(True, True, True, True) == \
        rC.alternating_optimize(True, True, True, True)
    for name in STATE:
        assert torch.equal(getattr(rB, name), getattr(rC, name)), name
    assert rB.energy_trace == rC.energy_trace
    assert rB.iterations_run == rC.iterations_run == 7


# ------------------------------------------------------------------ the scan


def _scan_cfg(data, out, last, jax=False, **kw):
    d = {"input": data, "output": out, "datatype": "tum",
         "pose filename": "no_such_pose_file.txt", "first": 0, "last": last,
         "voxel size": 0.015, "truncation factor": 5, "zmin": 0.3,
         "zmax": 3.5, "sharpness threshold": 0.0, "model type": "SH1",
         "grid dim": 48, "chunk size": 3, "fuse rows": 0.9}
    d.update(kw)
    return (jparse_config if jax else parse_config)(d, save_copy=False)


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    """The scene of test_pipeline_resume.py and the port's uninterrupted
    scan of it."""
    root = tmp_path_factory.mktemp("tum")
    data = str(root / "data") + "/"
    make_tum_dataset(data, n_frames=8, H=64, W=80)
    out = str(root / "a") + "/"
    pipe = ReconstructionPipeline(_scan_cfg(data, out, 7), device=CPU)
    pipe.run(refine=False)
    with open(out + "tracking_poses.txt") as fh:
        return dict(data=data, pipe=pipe, poses=fh.read())


def test_scan_resume_matches_uninterrupted(tmp_path, tum):
    out_b = str(tmp_path / "b") + "/"
    pb = ReconstructionPipeline(_scan_cfg(tum["data"], out_b, 4), device=CPU,
                                checkpoint_every=2)
    pb.run(refine=False)
    ck = out_b + "scan_checkpoint.npz"
    events = [json.loads(l) for l in open(out_b + "metrics.jsonl")]
    saved = [e for e in events if e["event"] == "checkpoint"]
    assert saved and all(e["bytes"] > 0 and e["seconds"] > 0 for e in saved)

    out_c = str(tmp_path / "c") + "/"
    pc = ReconstructionPipeline(_scan_cfg(tum["data"], out_c, 7), device=CPU,
                                resume=ck)
    summary = pc.run(refine=False)
    with open(out_c + "tracking_poses.txt") as fh:
        assert fh.read() == tum["poses"]
    for name, a, b in zip(pc.vol._fields, pc.vol, tum["pipe"].vol):
        assert torch.equal(a, b), name
    assert pc.geom == tum["pipe"].geom
    assert pc.key_indices == tum["pipe"].key_indices
    assert summary["frames"] == 8
    # the resumed part fused only the frames after the checkpoint (the cull
    # capacity has room: no overflow redo)
    state = ckpt.load_scan_state(ck, device=CPU)[2]
    assert pc.overflow_redos == 0
    assert pc.fuse_culled_calls == 8 - state.next_frame
    resumed = [json.loads(l) for l in open(out_c + "metrics.jsonl")
               if '"resume"' in l]
    assert resumed and resumed[0]["next_frame"] == state.next_frame
    # the keyframe images of the checkpoint are on the host only: the
    # refinement would upload them
    assert len(pc.key_images_dev) < len(pc.key_images) == len(pc.key_indices)


def test_scan_resume_needs_the_visibility_words_of_its_frame_range(tmp_path, tum):
    """A checkpoint of a 32-frame capacity resumed by a run whose range needs
    64 is refused at the resume: frames past the file's words have no bit."""
    out_b = str(tmp_path / "b") + "/"
    stopped = ReconstructionPipeline(_scan_cfg(tum["data"], out_b, 4), device=CPU,
                                     checkpoint_every=2)
    stopped.run(refine=False)
    stopped.close()
    ck = out_b + "scan_checkpoint.npz"
    assert ckpt.load_scan_state(ck, device=CPU)[0].vis.shape[0] == 1
    pipe = ReconstructionPipeline(_scan_cfg(tum["data"], str(tmp_path / "c") + "/", 7,
                                            **{"frame cap": 64}),
                                  device=CPU, resume=ck)
    with pytest.raises(ValueError, match="visibility bits for 32 frames"):
        pipe.run(refine=False)
    pipe.close()


def test_scan_resumes_from_a_jax_checkpoint(tmp_path):
    """The JAX package's scan stopped at frame 4 with a checkpoint, the port
    goes on from it to frame 7, on the sequence and grid of the two command
    lines in test_torch_stream_pipeline.py (on the smaller scene above the
    two packages' uninterrupted scans are already 7 mm apart)."""
    data = str(tmp_path / "data") + "/"
    make_tum_dataset(data)
    kw = {"voxel size": 0.02, "grid dim": 64, "fuse rows": 0.5}
    out_a, out_b, out_c = (str(tmp_path / n) + "/" for n in "abc")
    JPipeline(_scan_cfg(data, out_a, 7, jax=True, **kw)).run(refine=False)
    JPipeline(_scan_cfg(data, out_b, 4, jax=True, **kw),
              checkpoint_every=2).run(refine=False)
    pc = ReconstructionPipeline(_scan_cfg(data, out_c, 7, **kw), device=CPU,
                                resume=out_b + "scan_checkpoint.npz")
    pc.run(refine=False)
    stamps_c, est_c = read_trajectory(out_c + "tracking_poses.txt")
    stamps_a, est_a = read_trajectory(out_a + "tracking_poses.txt")
    assert stamps_c == stamps_a and len(est_c) == 8
    np.testing.assert_allclose(np.stack(est_c), np.stack(est_a), rtol=0, atol=1e-3)


# ------------------------------------------------- the older file layouts


def _rewrite(path, kind, drop=(), add=None, suffix=".npz"):
    """Rewrite companion <path>.<kind> as an older writer left it: under
    <path>.<kind><suffix>, without the arrays in `drop`, with those in
    `add` — with numpy, as the JAX package's older writers wrote it."""
    with np.load(path + "." + kind) as data:
        arrays = {k: data[k] for k in data.files if k not in drop}
    arrays.update(add or {})
    os.remove(path + "." + kind)
    np.savez_compressed(path + "." + kind + suffix, **arrays)


LEGACY_REFINE = ["npz_suffix", "images_inline", "no_prob", "no_loop_state"]


@pytest.mark.parametrize("layout", LEGACY_REFINE)
def test_refine_state_loads_from_the_older_layouts(tmp_path, refine_scene, layout):
    """Every older refinement layout the JAX loader reads, the port reads to
    the state the JAX loader gives, and — where the layout keeps it — to
    the state of the current layout: `.npz`-suffixed companions, the images
    inline in .refine, no prob_* arrays (extracted again from the saved
    volume), no loop state (None: the loop starts afresh)."""
    sc = refine_scene
    jref = _jax_refiner(sc)
    jref.init_albedo()
    jref.lights = jref.lights + 0.01
    jref.loop_state = {"it": 3, "w_n": 0.25, "w_l": 0.0, "w_rho": 0.0,
                       "normal_reg": True, "albedo_reg": False,
                       "laplacian_reg": False, "E": 1.5, "E_n": 0.25,
                       "E_l": 0.0, "E_r": 0.0, "E_vec": [3.0, 2.0, 1.75]}
    path = str(tmp_path / "refine_checkpoint.npz")
    jckpt.save_refine_state(path, jref)
    current = _empty_refiner(sc)
    ckpt.load_refine_state(path, current)

    if layout == "npz_suffix":
        _rewrite(path, "refine")
        _rewrite(path, "images")
    elif layout == "images_inline":
        with np.load(path + ".images") as im:
            images = im["images"]
        os.remove(path + ".images")
        _rewrite(path, "refine", add={"images": images}, suffix="")
    elif layout == "no_prob":
        with np.load(path + ".refine") as data:
            prob = [k for k in data.files if k.startswith("prob_")]
        _rewrite(path, "refine", drop=prob, suffix="")
    else:
        _rewrite(path, "refine", drop=("loop_state",), suffix="")
    from psgradientsdf_tpu_torch import cli

    assert cli._complete(path)
    tref, jref2 = _empty_refiner(sc), _jax_refiner(sc)
    ckpt.load_refine_state(path, tref)
    jckpt.load_refine_state(path, jref2)
    _assert_refiners_equal(tref, jref2)
    assert tref.loop_state == jref2.loop_state
    for name in STATE + ("images",):
        assert torch.equal(getattr(tref, name), getattr(current, name)), name
    if layout == "no_loop_state":
        assert tref.loop_state is None
    else:
        assert tref.loop_state == current.loop_state
    if layout != "no_prob":
        for k, a, b in zip(tref.prob._fields, tref.prob, current.prob):
            assert (a == b) if k == "n_surface" else torch.equal(a, b), k


def test_scan_resumes_from_the_older_layout(tmp_path, tum):
    """A scan checkpoint whose companion an older writer saved as
    <path>.scan.npz resumes, in the port and in the command line's choice of
    a complete checkpoint, to the uninterrupted scan bit for bit."""
    from psgradientsdf_tpu_torch import cli

    out_b = str(tmp_path / "b") + "/"
    ReconstructionPipeline(_scan_cfg(tum["data"], out_b, 4), device=CPU,
                           checkpoint_every=2).run(refine=False)
    ck = out_b + "scan_checkpoint.npz"
    _rewrite(ck, "scan")
    assert not os.path.exists(ck + ".scan") and cli._complete(ck)
    state = ckpt.load_scan_state(ck, device=CPU)[2]
    assert state.next_frame == jckpt.load_scan_state(ck)[2].next_frame
    out_c = str(tmp_path / "c") + "/"
    pc = ReconstructionPipeline(_scan_cfg(tum["data"], out_c, 7), device=CPU,
                                resume=ck)
    pc.run(refine=False)
    with open(out_c + "tracking_poses.txt") as fh:
        assert fh.read() == tum["poses"]
    for name, a, b in zip(pc.vol._fields, pc.vol, tum["pipe"].vol):
        assert torch.equal(a, b), name
