"""The refiner: set-up, each block, the two forms of an iteration, the loop's
stop rules, and whole runs against the JAX refiner from identical state
(SH1, SH2, LED, the joint distance+pose step, the iteration-5 upsample)."""

import json
import os

import numpy as np
import pytest
import torch

import helpers_torch as ht
from psgradientsdf_tpu.utils import robust
from psgradientsdf_tpu.utils.metrics import MetricsLogger as JLogger
from psgradientsdf_tpu_torch.ops import normaleq
from psgradientsdf_tpu_torch.refine import optimizer as topt
from psgradientsdf_tpu_torch.refine import render as trender

BASE = dict(max_it=4, conv_threshold=1e-6, damping=1.0, lam=0.2, reg_weight_n=1.0,
            reg_weight_l=0.0, reg_weight_rho=0.0, order=1, upsample=False,
            model="SH1", loss=robust.CAUCHY)


def _cfg(**kw):
    return dict(BASE, **kw)


@pytest.fixture(scope="module")
def sh1_scene():
    return ht.refine_scene(n_poses=2)


def _torch_refiner(sc, **kw):
    from psgradientsdf_tpu_torch.config import OptimizerConfig
    from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

    ref = topt.PhotometricRefiner(
        sc["tvol"], sc["tg"], OptimizerConfig(**_cfg(**kw)), sc["K"],
        truncation=sc["truncation"], metrics=MetricsLogger(None, echo=False))
    ref.set_keyframes(sc["images"], sc["poses"], sc["frame_ids"])
    ref.init()
    return ref


@pytest.mark.parametrize("model,order", [("SH1", 1), ("SH2", 2), ("LED", 1)])
def test_init_matches_jax(model, order):
    sc = ht.refine_scene(model=model, order=order, n_poses=2, dim=32, h=0.04,
                         H=48, W=48, f=45.0)
    jref, tref = ht.refiner_pair(sc, **_cfg(model=model, order=order))
    ht.assert_problem_equal(tref.prob, jref.prob)
    assert tref.lights.shape == tuple(jref.lights.shape)
    # SH: the basis of R (0,0,-1) with the ambient term set; LED: a ratio of
    # two sums over every visible pair
    np.testing.assert_allclose(ht.t2n(tref.lights), np.asarray(jref.lights),
                               rtol=1e-5, atol=1e-6)
    jref.init_albedo()
    tref.init_albedo()
    np.testing.assert_allclose(ht.t2n(tref.albedo), np.asarray(jref.albedo), atol=1e-6)
    np.testing.assert_allclose(tref.energies(), jref.energies(), rtol=2e-5)
    assert tref.images.dtype == torch.float32 and tref.K.shape == (3, 3)


def test_uint8_keyframes_are_scaled_on_set(sh1_scene):
    ref = _torch_refiner(sh1_scene)
    raw = np.clip(np.abs(sh1_scene["images"]) * 255, 0, 255).astype(np.uint8)
    ref.set_keyframes(torch.from_numpy(raw), sh1_scene["poses"], sh1_scene["frame_ids"])
    np.testing.assert_allclose(ht.t2n(ref.images), raw.astype(np.float32) / 255.0, atol=1e-7)
    assert ref.timestamps == ["0", "1"]


def _block(ref, name, rd=None, **weights):
    kw = dict(reg_weight_n=0.5, reg_weight_l=0.0, reg_weight_rho=0.0, damping=1.0,
              laplacian_diag_only=False)
    kw.update(weights)
    rd = ref._rd() if rd is None else rd
    ref._set_state(topt._run_block(
        name, ref.prob, ref.geom, rd, *ref._state()[:4], ref.K, ref.lights,
        kw=ref._static_kwargs(), stencil=ref.stencil, **kw))


def _gt_albedo(ref):
    pts = trender.surface_points_world(ref.prob, ref.geom, ref.dist, ref.grad_stored)
    x, y = pts[:, 0], pts[:, 1]
    return torch.stack([0.5 + 0.2 * torch.sin(10 * x), 0.5 + 0.2 * torch.cos(8 * y),
                        0.5 + 0.15 * torch.sin(6 * (x + y))], dim=-1)


def test_each_block_lowers_its_energy(sh1_scene):
    light_gt = torch.from_numpy(sh1_scene["light"])
    # albedo, with the light at its true value
    ref = _torch_refiner(sh1_scene)
    ref.init_albedo()
    ref.lights = light_gt.expand(ref.lights.shape).clone()
    E0 = ref.energies()[0]
    for _ in range(3):
        _block(ref, "albedo")
    assert ref.energies()[0] < E0
    # light, with the albedo at its true value: lands near the true light
    ref = _torch_refiner(sh1_scene)
    ref.albedo = _gt_albedo(ref)
    E0 = ref.energies()[0]
    for _ in range(2):
        _block(ref, "light")
    assert ref.energies()[0] < E0
    np.testing.assert_allclose(ht.t2n(ref.lights)[0], sh1_scene["light"], atol=0.15)
    # distance, from perturbed distances
    ref = _torch_refiner(sh1_scene)
    ref.init_albedo()
    ref.lights = light_gt.expand(ref.lights.shape).clone()
    gen = torch.Generator().manual_seed(0)
    noise = 0.2 * ref.geom.voxel_size * torch.randn(ref.dist.shape, generator=gen)
    ref.dist = ref.dist + noise * ref.prob.valid
    E0 = ref.energies()[0]
    for _ in range(2):
        _block(ref, "distance")
    assert ref.energies()[0] < E0
    # pose, from a perturbed pose
    ref = _torch_refiner(sh1_scene)
    ref.init_albedo()
    for _ in range(2):
        _block(ref, "albedo")
        _block(ref, "light")
    good = ref.poses.clone()
    ref.poses = good.clone()
    ref.poses[1, :3, 3] += torch.tensor([0.004, -0.003, 0.002])
    E0 = ref.energies()[0]
    for _ in range(3):
        _block(ref, "pose")
    assert ref.energies()[0] < E0
    assert float((ref.poses[1, :3, 3] - good[1, :3, 3]).norm()) < 0.0054
    # joint distance+pose from the same start
    ref.poses = good.clone()
    ref.poses[1, :3, 3] += torch.tensor([0.004, -0.003, 0.002])
    e0 = ref.energies()
    _block(ref, "joint_dp")
    e1 = ref.energies()
    assert e1[0] + 0.5 * e1[1] < e0[0] + 0.5 * e0[1]
    with pytest.raises(ValueError):
        _block(ref, "shadow")


@pytest.mark.parametrize("model,joint", [("SH1", False), ("LED", False), ("SH1", True)])
def test_fused_iteration_matches_blocks(model, joint):
    """_iteration_core and the per-block path are the same arithmetic in eager
    PyTorch: same states, same energy trace, same verdict, exactly."""
    sc = ht.refine_scene(model=model, n_poses=2, dim=32, h=0.04, H=48, W=48, f=45.0)
    out = {}
    for fused in (False, True):
        ref = _torch_refiner(sc, model=model, joint_dp=joint, max_it=3, conv_threshold=0.0,
                             fused_iterations=fused)
        assert ref.fused_iterations is fused
        ok = ref.alternating_optimize(True, True, True, True)
        out[fused] = (ok, ref.stop_reason, ref.iterations_run, ref._state(), ref.energy_trace)
    b, f = out[False], out[True]
    assert b[:3] == f[:3] and b[2] >= 2
    for x, y in zip(b[3], f[3]):
        assert torch.equal(x, y)
    assert [r["block"] for r in b[4]] == [r["block"] for r in f[4]]
    assert [r["total"] for r in b[4]] == [r["total"] for r in f[4]]
    blocks = [r["block"] for r in f[4] if r["iter"] == 0]
    assert blocks == (["albedo", "light", "joint_dp"] if joint
                      else ["albedo", "light", "distance", "pose"])


def test_pose_block_chunked_matches_full(sh1_scene, monkeypatch):
    ref = _torch_refiner(sh1_scene)
    ref.init_albedo()
    rd = ref._rd()
    N = ref.dist.shape[0]
    args = (ref.prob, ref.geom, rd, ref.dist, ref.albedo, ref.grad_stored, ref.poses,
            ref.K, ref.lights)
    monkeypatch.setattr(normaleq, "_POSE_CHUNK", 1 << 30)      # the full path
    full = topt._pose_core(*args, **ref._static_kwargs(), damping=1.0)
    monkeypatch.setattr(normaleq, "_POSE_CHUNK", N // 4)       # four chunks
    assert N % normaleq._POSE_CHUNK == 0 and N > normaleq._POSE_CHUNK
    chunked = topt._pose_core(*args, **ref._static_kwargs(), damping=1.0)
    assert not torch.equal(full, ref.poses)
    np.testing.assert_allclose(ht.t2n(chunked), ht.t2n(full), atol=1e-6)


def test_all_flags_off_converges_at_iteration_0(sh1_scene):
    ref = _torch_refiner(sh1_scene)
    d0, p0, l0 = ref.dist.clone(), ref.poses.clone(), ref.lights.clone()
    assert ref.alternating_optimize(False, False, False, False)
    assert ref.stop_reason == "converged" and ref.iterations_run == 1
    assert torch.equal(ref.dist, d0) and torch.equal(ref.poses, p0)
    assert torch.equal(ref.lights, l0)


def test_single_block_ablation_touches_only_its_block(sh1_scene):
    ref = _torch_refiner(sh1_scene, max_it=2)
    d0, p0, l0, a0 = (t.clone() for t in (ref.dist, ref.poses, ref.lights, ref.albedo))
    ref.alternating_optimize(light=False, albedo=True, distance=False, pose=False)
    assert torch.equal(ref.dist, d0) and torch.equal(ref.poses, p0)
    assert torch.equal(ref.lights, l0) and not torch.equal(ref.albedo, a0)
    assert {r["block"] for r in ref.energy_trace} == {"init", "albedo"}


def test_what_is_not_ported_raises(sh1_scene):
    from psgradientsdf_tpu_torch.config import OptimizerConfig
    from psgradientsdf_tpu_torch.parallel import refine as prefine
    from psgradientsdf_tpu_torch.parallel.mesh import make_mesh

    # the refinement on a mesh is ported (tests/test_torch_refine_mesh.py):
    # its mesh must start on the volume's device, and a refiner for a resume
    # runs on the mesh's first device
    with pytest.raises(ValueError, match="first device"):
        topt.PhotometricRefiner(sh1_scene["tvol"], sh1_scene["tg"], OptimizerConfig(),
                                sh1_scene["K"], mesh=make_mesh(2, 1, devices=["meta"] * 2))
    on_mesh = topt.PhotometricRefiner(None, None, OptimizerConfig(), sh1_scene["K"],
                                      mesh=make_mesh(4, 2, device="cpu"))
    assert on_mesh.device.type == "cpu" and on_mesh.ops is prefine.OPS
    # checkpoints and resume are ported (tests/test_torch_checkpoint.py): a
    # refiner for a resume is made before any volume exists, on the device
    # it is given, "cuda" unless asked for another
    ref = topt.PhotometricRefiner(None, None, OptimizerConfig(), sh1_scene["K"],
                                  device="cpu")
    assert ref.device.type == "cpu" and ref.K.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            topt.PhotometricRefiner(None, None, OptimizerConfig(), sh1_scene["K"])
        with pytest.raises(ValueError, match="volume is on cpu"):
            topt.PhotometricRefiner(sh1_scene["tvol"], sh1_scene["tg"],
                                    OptimizerConfig(), sh1_scene["K"], device="cuda")


# ---- whole runs against the JAX refiner

def _j_trace(path):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    return ([(r["ps"], r["total"]) for r in recs if r["event"] == "energy"],
            [r["event"] for r in recs if r["event"] in
             ("converged", "diverged", "budget_exhausted")])


RUNS = {
    "SH1": dict(model="SH1", max_it=4),
    "SH1_albedo_reg": dict(model="SH1", max_it=3, reg_weight_rho=0.1),
    "SH2": dict(model="SH2", order=2, max_it=3),
    "LED": dict(model="LED", max_it=3, damping=3.0, reg_weight_n=0.1),
    "joint_dp": dict(model="SH1", max_it=3, joint_dp=True),
    "per_block": dict(model="SH1", max_it=3, fused_iterations=False),
    # the LED recipe's weights: the run gets past iteration 5, where the
    # grid is doubled, and the iteration after it
    "upsample": dict(model="LED", max_it=8, upsample=True, damping=3.0,
                     reg_weight_n=0.1, reg_weight_l=5.0, conv_threshold=0.0),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_runs_follow_the_jax_refiner(name, tmp_path):
    """Both refiners from identical state.  The energies after every block
    agree within 1e-3, or 1e-5 of the initial total, (float32 sums over voxels and frames in another order,
    through up to four CG solves an iteration); the loop stops at the same
    iteration for the same reason wherever the quantity its rule tests clears
    the rule by more than that tolerance; the final state agrees to the
    tolerances below."""
    kw = RUNS[name]
    small = dict(dim=32, h=0.04, H=48, W=48, f=45.0)
    sc = ht.refine_scene(model=kw["model"], order=kw.get("order", 1), n_poses=2, **small)
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jref, tref = ht.refiner_pair(sc, save_paths=(jout, tout), **_cfg(**kw))
    jref.metrics = JLogger(str(tmp_path / "j.jsonl"), echo=False)
    jok = jref.alternating_optimize(True, True, True, True)
    tok = tref.alternating_optimize(True, True, True, True)
    jtrace, jstop = _j_trace(str(tmp_path / "j.jsonl"))
    ttrace = [(r["ps"], r["total"]) for r in tref.energy_trace]
    n = min(len(jtrace), len(ttrace))
    assert n >= 1 + len(topt.block_names(True, True, True, True, kw.get("joint_dp", False)))
    # (a light solve can fit this scene to a PS energy 1e-4 of the start:
    # there the floor is absolute, 1e-5 of the initial total)
    np.testing.assert_allclose(ttrace[:n], jtrace[:n], rtol=1e-3,
                               atol=1e-5 * jtrace[0][1])

    # the stop: compare where the rule's margin is clear of the tolerance
    per_it = [r["total"] for r in tref.energy_trace if r["block"] in ("init", "pose", "joint_dp", "upsample")]
    rel = [abs(a - b) / abs(a) for a, b in zip(per_it, per_it[1:])]
    thr = _cfg(**kw)["conv_threshold"]
    clear = all(abs(r - thr) > 2e-3 * max(r, thr) + 1e-6 for r in rel) and \
        all(abs(a - b) > 2e-3 * abs(a) for a, b in zip(per_it, per_it[1:]))
    if clear:
        assert len(ttrace) == len(jtrace)
        assert tok == jok and [tref.stop_reason] == jstop
    assert np.isfinite(ttrace).all()

    if len(ttrace) == len(jtrace):
        # order 2: the light's Gram matrices are badly conditioned on this
        # scene (test_torch_solvers) and one eigenvalue of a frame's sits at
        # the clip of the eigen-solve, 1e-6 of the largest: one package keeps
        # that direction, the other drops it.  The residuals do not see it,
        # so the energies above agree; the coefficients are not compared, and
        # the poses, which follow the light, more loosely
        sh2 = kw["model"] == "SH2"
        tol = dict(dist=2e-4, albedo=2e-3, grad_stored=2e-2,
                   poses=2e-4 if sh2 else 2e-5)
        if not sh2:
            tol["lights"] = 2e-3
        assert tref.dist.shape == tuple(jref.dist.shape)
        for k, atol in tol.items():
            np.testing.assert_allclose(ht.t2n(getattr(tref, k)), np.asarray(getattr(jref, k)),
                                       atol=atol, err_msg=k)
        np.testing.assert_allclose(tref.energies(), jref.energies(), rtol=1e-3,
                                   atol=1e-5 * jtrace[0][1])
    # the same artifacts under the same names
    tfiles = sorted(f for f in os.listdir(tout))
    jfiles = sorted(f for f in os.listdir(jout))
    if len(ttrace) == len(jtrace):
        assert tfiles == jfiles
    assert "final_refined_mesh.ply" in tfiles and "final_refined_pointcloud.ply" in tfiles
    if name == "upsample":
        assert tref.geom.dims == jref.geom.dims == (64, 64, 64)
        assert tref.prob.n_surface == int(jref.prob.n_surface)
        assert "upsample_after_5_mesh.ply" in tfiles
        assert "after_poses_opt_3.txt" in tfiles and "after_iter_6_pointcloud.ply" in tfiles


def test_exports_parse(sh1_scene, tmp_path):
    from psgradientsdf_tpu_torch.io.ply import read_ply_header
    from psgradientsdf_tpu_torch.io.sdf_io import read_sdf
    from psgradientsdf_tpu_torch.io.trajectory import read_trajectory

    ref = _torch_refiner(sh1_scene, max_it=1)
    ref.save_path = str(tmp_path)
    vol0 = ref.vol
    ref.alternating_optimize(True, True, True, True)
    assert ref.vol is not vol0 and not torch.equal(ref.vol.dist, vol0.dist)
    assert ref.save_sdf("refined.sdf") and ref.save_poses("refined_poses")
    sdf, _, h = read_sdf(str(tmp_path / "refined.sdf"))
    assert sdf.size > 100 and abs(h - ref.geom.voxel_size) < 1e-9
    stamps, poses = read_trajectory(str(tmp_path / "refined_poses.txt"))
    assert len(poses) == 2
    np.testing.assert_allclose(np.stack(poses), ht.t2n(ref.poses), atol=1e-5)
    pts, normals, cols = ref.surface_points()
    assert pts.shape == normals.shape == cols.shape == (ref.prob.n_surface, 3)
    head = read_ply_header(str(tmp_path / "final_refined_pointcloud.ply"))
    assert ref.prob.n_surface in (head if isinstance(head, (tuple, list)) else
                                  list(head.values()) if isinstance(head, dict) else [head])
