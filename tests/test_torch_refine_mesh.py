"""The photometric refinement on a device mesh (parallel/refine.py), on the
CPU, where every shard lives on the one CPU device (make_mesh(device="cpu")).

  * shard_refine_arrays splits N over "z" and the keyframes over "frames",
    replicates an axis the mesh does not divide (the JAX package's n_spec),
    and gathers back to the problem bit for bit;
  * each block (albedo, light, distance, pose, joint distance+pose) x model
    (SH1, SH2, LED) on a 4x2 mesh with F = 4 keyframes, and the JAX
    package's own sharded cases (tests/test_parallel.py:226-282, 377-400:
    SH1 and LED distance and pose, the SH1 joint step, F = 1) on 4x1, match
    the JAX package's SINGLE-device block within that test's tolerances: 2e-4
    on the state and the poses, rtol 1e-3 on the energies after the block
    (the light block, which takes E_ps near zero, to 1e-5 absolute there,
    and its SH lights along each frame's well-determined directions).
    The JAX package's sharded functions are never called here: its sharded
    programs abort in XLA's CPU rendezvous when the test runner spreads
    tests over processes;
  * the same blocks match the port's own single-device blocks;
  * one sharded iteration moves no tensor with both an N and an F axis,
    none larger than 3 N, and a fixed number of reductions a CG step.
"""

import functools

import numpy as np
import pytest
import torch

import helpers_torch as ht
from psgradientsdf_tpu.refine import optimizer as jopt
from psgradientsdf_tpu.utils import robust
from psgradientsdf_tpu_torch.parallel import mesh as pm
from psgradientsdf_tpu_torch.parallel import refine as prefine
from psgradientsdf_tpu_torch.parallel import shard
from psgradientsdf_tpu_torch.refine import optimizer as topt

torch.set_num_threads(1)

SMALL = dict(dim=32, h=0.04, H=48, W=48, f=45.0)
MODELS = {"SH1": ("SH1", 1), "SH2": ("SH2", 2), "LED": ("LED", 1)}
BLOCKS = ("albedo", "light", "distance", "pose", "joint_dp")
# the 4x2 cases exercise every regularizer; the JAX anchors use their own
WEIGHTS = dict(reg_weight_n=0.5, reg_weight_l=0.3, reg_weight_rho=0.1,
               damping=1.0, laplacian_diag_only=False)
ANCHOR_WEIGHTS = dict(WEIGHTS, reg_weight_l=0.0, reg_weight_rho=0.0)
CASES = ([(m, b, 4, (4, 2)) for m in MODELS for b in BLOCKS]
         + [("SH1", "distance", 1, (4, 1)), ("SH1", "pose", 1, (4, 1)),
            ("SH1", "joint_dp", 1, (4, 1)), ("LED", "distance", 1, (4, 1)),
            ("LED", "pose", 1, (4, 1))])


def _cfg(model, weights):
    name, order = MODELS[model]
    return dict(model=name, order=order, max_it=4, conv_threshold=1e-6,
                damping=1.0, lam=0.2, loss=robust.CAUCHY, upsample=False,
                reg_weight_n=weights["reg_weight_n"],
                reg_weight_l=weights["reg_weight_l"],
                reg_weight_rho=weights["reg_weight_rho"])


@functools.lru_cache(maxsize=None)
def _scene(model, F):
    name, order = MODELS[model]
    return ht.refine_scene(model=name, order=order, n_poses=F, **SMALL)


@functools.lru_cache(maxsize=None)
def _pair(model, F, weights_key):
    """Both packages' refiners after init() and the albedo init (cached per
    process: each JAX block is a CPU compile)."""
    weights = dict(weights_key)
    jref, tref = ht.refiner_pair(_scene(model, F), **_cfg(model, weights))
    jref.init_albedo()
    tref.init_albedo()
    return jref, tref


def _weights(F):
    return WEIGHTS if F > 1 else ANCHOR_WEIGHTS


@functools.lru_cache(maxsize=None)
def _jax_block(model, block, F):
    """The JAX package's single-device block from the init state ->
    (dist, albedo, grad_stored, poses, lights, energies)."""
    weights = _weights(F)
    jref, _ = _pair(model, F, tuple(sorted(weights.items())))
    name, order = MODELS[model]
    kw = dict(model=name, order=order, loss=robust.CAUCHY, lam=0.2,
              voxel_size=jref.geom.voxel_size)
    args = (jref.prob, jref.geom, jref.dist, jref.albedo, jref.grad_stored,
            jref.poses, jref.images, jref.K, jref.lights)
    dw = {k: weights[k] for k in ("reg_weight_n", "reg_weight_l", "damping",
                                  "laplacian_diag_only")}
    state = dict(dist=jref.dist, albedo=jref.albedo, grad_stored=jref.grad_stored,
                 poses=jref.poses, lights=jref.lights)
    if block == "albedo":
        state["albedo"] = jopt._albedo_block(
            *args, **kw, reg_weight_rho=weights["reg_weight_rho"],
            damping=weights["damping"])
    elif block == "light":
        state["lights"] = jopt._light_block(*args, **kw, damping=weights["damping"])
    elif block == "distance":
        state["dist"], state["grad_stored"] = jopt._dist_block(*args, **kw, **dw)
    elif block == "pose":
        state["poses"] = jopt._pose_block(*args, **kw, damping=weights["damping"])
    else:
        state["dist"], state["grad_stored"], state["poses"], _ = \
            jopt._joint_dp_step(*args, **kw, **dw)
    saved = {k: getattr(jref, k) for k in state}
    for k, v in state.items():
        setattr(jref, k, v)
    energies = jref.energies()
    for k, v in saved.items():
        setattr(jref, k, v)
    return {k: np.asarray(v) for k, v in state.items()}, np.asarray(energies)


def _torch_block(model, block, F, mesh_shape):
    """The port's block from the init state, on a mesh (mesh_shape) or on
    one device (None) -> (state as numpy, energies, refiner)."""
    weights = _weights(F)
    _, tref = _pair(model, F, tuple(sorted(weights.items())))
    sc = _scene(model, F)
    ref = topt.PhotometricRefiner(
        tref.vol, tref.geom, tref.cfg, sc["K"], truncation=sc["truncation"],
        metrics=tref.metrics,
        mesh=None if mesh_shape is None else pm.make_mesh(*mesh_shape, device="cpu"))
    ref.images, ref.poses = tref.images, tref.poses
    ref.keyframe_indices, ref.timestamps = tref.keyframe_indices, tref.timestamps
    ref.prob, ref.lights = tref.prob, tref.lights
    ref.dist, ref.albedo, ref.grad_stored = tref.dist, tref.albedo, tref.grad_stored
    ref.place_on_mesh()
    ref.rebuild_stencil()
    rd = ref._rd()
    ref._set_state(ref.ops.run_block(
        block, ref.prob, ref.geom, rd, *ref._state()[:4], ref.K, ref.lights,
        kw=ref._static_kwargs(), stencil=ref.stencil, **weights))
    _, dist, albedo, grad, _ = ref.gathered(False, False)
    state = dict(dist=dist, albedo=albedo, grad_stored=grad, poses=ref.poses,
                 lights=ref.lights)
    return {k: ht.t2n(v) for k, v in state.items()}, np.asarray(ref.energies()), ref


@functools.lru_cache(maxsize=None)
def _light_gram_eigh(model):
    """(eigenvalues, eigenvectors) of each frame's light Gram matrix at the
    init state, where the light block starts (float64, numpy)."""
    from psgradientsdf_tpu_torch.refine import jacobians, solvers

    _, tref = _pair(model, 4, tuple(sorted(WEIGHTS.items())))
    J = jacobians.light_jacobian_sh(tref.prob, tref.albedo, tref.grad_stored,
                                    MODELS[model][1])
    H, _ = solvers.light_normal_eqs_sh(tref._rd(), J)
    return np.linalg.eigh(ht.t2n(H).astype(np.float64))


def _assert_block_close(got, want, block, model):
    """State and poses within 2e-4 and each energy after the block within
    rtol 1e-3 (the JAX anchors' tolerances), lights within 2e-3 (SH1, LED).

    The light block takes E_ps from 0.12 to 4.1e-4 (SH1 on this scene),
    where rtol 1e-3 is below the gap the two packages' single-device blocks
    already show (3.1e-6; the mesh against JAX 2.5e-6, the mesh against the
    port's one device 5.6e-7).  So its E_ps is held to 1e-5 absolute (about
    three times that gap).  The SH light solve drops each frame's Gram
    directions at eigenvalue <= 1e-6 lambda_max and leaves those just above
    ill-determined in float32 (SH2 has eigenvalues at 5e-6 and 1.3e-5
    lambda_max on every frame here, and its coefficients differ by 2.6e-3
    along them between the two single devices), so the lights are also
    held to 2e-4 along every direction of eigenvalue >= 1e-3 lambda_max,
    where the two single devices differ by 8.1e-5 (SH2) and 3.1e-6 (SH1)."""
    (gs, ge), (ws, we) = got, want
    for k in ("dist", "albedo", "grad_stored", "poses"):
        np.testing.assert_allclose(gs[k], ws[k], rtol=0, atol=2e-4, err_msg=k)
    if model != "SH2":
        np.testing.assert_allclose(gs["lights"], ws["lights"], rtol=0, atol=2e-3,
                                   err_msg="lights")
    if block == "light" and model != "LED":
        vals, vecs = _light_gram_eigh(model)
        proj = np.einsum("fbd,fb->fd", vecs, (gs["lights"] - ws["lights"]))
        firm = vals >= 1e-3 * vals[:, -1:]
        assert firm.sum() >= 3 * len(vals)
        assert np.abs(proj[firm]).max() <= 2e-4, (proj, vals)
    if block == "light":
        assert abs(ge[0] - we[0]) <= 1e-5, (ge, we)
        ge, we = ge[1:], we[1:]
    np.testing.assert_allclose(ge, we, rtol=1e-3, atol=0, err_msg="energies")


# ------------------------------------------------------------- placement

@pytest.mark.parametrize("shape,F,split_n,split_f", [
    ((4, 2), 4, True, True),     # both axes divide
    ((3, 2), 4, False, True),    # N = 1024 is not a multiple of 3: replicated
    ((4, 2), 3, True, False),    # 3 keyframes over 2: replicated
    ((8, 1), 4, True, False),    # a "frames" axis of 1 splits nothing
])
def test_shard_refine_arrays_splits_replicates_and_gathers(shape, F, split_n, split_f):
    _, tref = _pair("SH1", 4, tuple(sorted(WEIGHTS.items())))
    prob, images = tref.prob, tref.images[:F]
    prob = prob._replace(vis=prob.vis[:, :F])
    m = pm.make_mesh(*shape, device="cpu")
    sp, si = shard.shard_refine_arrays(m, prob, images)
    N = int(prob.valid.shape[0])
    lay = sp.layout
    assert sp.capacity == N and sp.n_surface == prob.n_surface
    assert len(sp.rows) == (shape[0] if split_n else 1)
    assert len(lay.frames) - 1 == (shape[1] if split_f else 1)
    assert lay.rows == tuple(np.linspace(0, N, len(sp.rows) + 1).astype(int))
    for k, row in enumerate(sp.blocks):
        for j, p in enumerate(row):
            assert p.vis.shape == (N // len(sp.rows), lay.frames[j + 1] - lay.frames[j])
            assert torch.equal(si.blocks[k][j], images[lay.frames[j]:lay.frames[j + 1]])
            assert torch.equal(p.nbr_idx, sp.rows[k].nbr_idx)       # global indices
    back = shard.gather_problem(sp, "cpu")
    for name, a, b in zip(prob._fields, back, prob):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name
    assert torch.equal(shard.gather_images(si, "cpu"), images)
    # copies: no chunk shares storage with the problem it came from
    assert sp.rows[0].dist.data_ptr() != prob.dist.data_ptr()
    chunks = shard.shard_rows(prob.dist, lay)
    assert torch.equal(shard.gather_rows(chunks, "cpu"), prob.dist)


# ---------------------------------------------------------------- blocks

@pytest.mark.parametrize("model,block,F,shape", CASES)
def test_sharded_block_matches_the_jax_single_device_block(model, block, F, shape):
    got = _torch_block(model, block, F, shape)
    _assert_block_close(got[:2], _jax_block(model, block, F), block, model)
    ref = got[2]
    # the problem's N lies in n_z shard tensors on the mesh's row devices
    assert len(ref.prob.rows) == shape[0] and len(ref.dist) == shape[0]
    assert sum(int(p.valid.shape[0]) for p in ref.prob.rows) == ref.prob.capacity


@pytest.mark.parametrize("model,block,F,shape", CASES)
def test_sharded_block_matches_the_port_single_device_block(model, block, F, shape):
    got = _torch_block(model, block, F, shape)
    want = _torch_block(model, block, F, None)
    _assert_block_close(got[:2], want[:2], block, model)


@pytest.mark.parametrize("fixed", [False, True])
def test_mesh_cg_takes_the_single_device_steps(fixed):
    """The one CG (refine/solvers.cg_chunks) on four row chunks with the
    mesh's reduced dot product, against refine/solvers.cg (the polled stop
    rule, through parallel/refine._solve_cg) and solvers.pcg_fixed (a fixed
    trip count) on one chunk."""
    from psgradientsdf_tpu_torch.refine import solvers

    rng = np.random.RandomState(0)
    n = 64
    A = rng.randn(n, n)
    A = torch.tensor(A @ A.T + n * np.eye(n), dtype=torch.float32)
    b = torch.tensor(rng.randn(n), dtype=torch.float32)
    d = torch.diagonal(A).clone()

    def chunks(v):
        return [v[i * 16:(i + 1) * 16] for i in range(4)]

    def matvec(xs):
        return chunks(A @ torch.cat(xs))

    one, mesh = [], []
    if fixed:
        want = solvers.pcg_fixed(lambda x: A @ x, b, lambda v: v / d, 30, 1e-6)
        got = solvers.cg_chunks(matvec, chunks(b),
                                lambda rs: [r / dk for r, dk in zip(rs, chunks(d))],
                                30, 1e-6, fixed=True, dot=prefine._dot)
    else:
        want = solvers.cg(lambda x: A @ x, b, lambda v: v / d, 100, 1e-6, steps_out=one)
        got = prefine._solve_cg(matvec, chunks(b), chunks(d), mesh)
    np.testing.assert_allclose(ht.t2n(torch.cat(got)), ht.t2n(want), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    if not fixed:
        assert int(mesh[0]) == int(one[0]) > 3


# ------------------------------------------------------- what crosses

def test_an_iteration_moves_no_tensor_with_an_n_and_an_f_axis(monkeypatch):
    """One joint iteration on 4x2 with F = 10 keyframes (chunks of 5, a
    length no other small axis has): every moved tensor is recorded."""
    from psgradientsdf_tpu_torch.config import OptimizerConfig
    from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

    F = 10
    sc = _scene("SH1", F)
    ref = topt.PhotometricRefiner(
        sc["tvol"], sc["tg"], OptimizerConfig(**_cfg("SH1", WEIGHTS)), sc["K"],
        truncation=sc["truncation"], metrics=MetricsLogger(None, echo=False),
        mesh=pm.make_mesh(4, 2, device="cpu"))
    ref.set_keyframes(sc["images"], sc["poses"], sc["frame_ids"])
    ref.init()
    ref.init_albedo()
    N = ref.prob.capacity
    sizes_n, sizes_f = (N, N // 4), (F, F // 2)
    moved = []
    for name in ("reduce_to_first", "all_gather", "reduce_scatter"):
        fn = getattr(pm, name)

        def wrap(tensors, *a, _fn=fn, **k):
            moved.extend(tuple(t.shape) for t in tensors)
            return _fn(tensors, *a, **k)

        monkeypatch.setattr(pm, name, wrap)
    pm.reset_reduce_counts()
    steps = []
    topt._iteration_core(
        *ref._args(), **ref._static_kwargs(), **WEIGHTS, do_light=True,
        do_albedo=True, do_distance=True, do_pose=True, joint_dp=True,
        steps_out=steps, ops=ref.ops)
    c = dict(pm.reduce_counts)
    assert c["calls"] > 0 and len(moved) >= c["calls"]
    assert len(steps) == 2 and all(int(s) > 0 for s in steps)
    assert any(s[0] in sizes_n for s in moved) and any(sizes_f[1] in s for s in moved)
    for shape in moved:
        assert not (any(d in sizes_n for d in shape)
                    and any(d in sizes_f for d in shape)), shape
    assert c["largest"] <= 3 * N


@pytest.mark.parametrize("block,per_step", [
    ("distance", dict(reduces=3, all_gathers=1, reduce_scatters=1)),
    ("joint_dp", dict(reduces=4, all_gathers=1, reduce_scatters=1)),
    ("albedo", dict(reduces=3, all_gathers=1, reduce_scatters=1)),
])
def test_a_cg_step_makes_a_fixed_set_of_moves(block, per_step, monkeypatch):
    """Every CG step: the three dot products reduced over the shards, one
    all-gather and one reduce-scatter of the matvec's N-vector, and for the
    joint step one reduction of H_pd x ([F,6])."""
    counts = {}
    solve = prefine._solve_cg
    for iters in (3, 5):
        monkeypatch.setattr(prefine, "_solve_cg", lambda mv, b, d, so, _i=iters:
                            solve(mv, b, d, so, maxiter=_i, tol=0.0))
        pm.reset_reduce_counts()
        _torch_block("SH1", block, 4, (4, 2))
        counts[iters] = dict(pm.reduce_counts)
    for kind, n in per_step.items():
        assert (counts[5][kind] - counts[3][kind]) == 2 * n, kind
