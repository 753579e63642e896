"""The distance block's eager tail and the LED light's normal equations in
the PyTorch package, ops/distreg.py and ops/normaleq.light_normal_eqs_led,
on the CPU, where their wrappers run the plain versions.

Against the JAX package (refine/solvers.py `eikonal_operator`,
`laplacian_operator`, `update_distance` and `solve_light_led` over
refine/jacobians.py `light_jacobian_led`), on the same numpy problem and
state (tests/helpers_torch.py's refinement scene, the residual pass
computed by the JAX package), on an SH1 and an LED problem and after the
upsample, at the tolerances tests/test_torch_solvers.py holds the
operators and the update to: 2e-6 of the largest magnitude (the update's
distances 1e-7), the light's normal equations and step 1e-5.  The accept
threshold: the port compares |delta| with sqrt(3) h rounded once to float,
the JAX package with float(sqrt(3)) h in float; where the two differ by an
ulp, a step between them is a knife edge (accepted here, refused there).

Within the port: the wrappers on CPU tensors are the plain versions and
launch nothing, their launch arguments (captured on meta tensors) carry
the threshold and the voxel size, they refuse mismatched inputs, the C
argument blocks have csrc/distreg.cu's and csrc/normaleq.cu's layouts, the
refiner's distance, joint and LED light blocks and the mesh's go through
them, and a numpy float32 emulation of each kernel's per-row (per-pair)
arithmetic, every operation rounded once and no fused multiply-add, equals
the plain version bit for bit (at a voxel size whose reciprocal is exact,
so that the CPU's division by h and the card's product with 1/h agree).
The kernels are held against the plain versions on the card by
chip_smoke.py (phase dist_tail_kernels).
"""

import ctypes
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch as ht
from psgradientsdf_tpu.refine import geometry as jgeometry
from psgradientsdf_tpu.refine import jacobians as jjac
from psgradientsdf_tpu.refine import problem as jproblem
from psgradientsdf_tpu.refine import render as jrender
from psgradientsdf_tpu.refine import solvers as jsolvers
from psgradientsdf_tpu.refine import upsample as jupsample
from psgradientsdf_tpu.utils import robust
from psgradientsdf_tpu_torch import convert, kernels
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.ops import distreg, normaleq
from psgradientsdf_tpu_torch.parallel import mesh as pm
from psgradientsdf_tpu_torch.refine import geometry as tgeometry
from psgradientsdf_tpu_torch.refine import jacobians as tjac
from psgradientsdf_tpu_torch.refine import optimizer as topt
from psgradientsdf_tpu_torch.refine import solvers as tsolvers
from psgradientsdf_tpu_torch.refine.render import ResidualData

torch.set_num_threads(1)

H_VOX = 0.03125          # 1/32: its reciprocal and its square are exact
MODELS = {"SH1": ("SH1", 1), "LED": ("LED", 1)}
OPERATOR_TOL = 2e-6
DIST_TOL = 1e-7
LIGHT_TOL = 1e-5
DAMPING = 3.0


@functools.lru_cache(maxsize=None)
def _case(model, upsampled=False):
    """(JAX problem, its geometry, the port's problem and geometry, dist,
    albedo, poses, the JAX residual pass, its numpy fields, h)."""
    name, order = MODELS[model]
    sc = ht.refine_scene(model=name, order=order, n_poses=3, dim=24, h=H_VOX,
                         H=40, W=40, f=36.0)
    vol, geom, kf, h = sc["jvol"], sc["jg"], sc["frame_ids"], H_VOX
    tg = sc["tg"]
    if upsampled:
        vol, geom, kf = jupsample.upsample_volume(vol, geom, kf, sc["truncation"])
        h = geom.voxel_size
        tg = GridGeometry(dims=tuple(geom.dims), voxel_size=geom.voxel_size,
                          shift=tuple(geom.shift))
    jp = jproblem.extract_problem(vol, geom, kf)
    rng = np.random.default_rng(5)
    N = jp.dist.shape[0]
    # a state off the fused one: gradients far from unit length
    dist = (np.asarray(jp.dist) + 0.2 * h * rng.standard_normal(N)).astype(np.float32)
    albedo = np.clip(np.asarray(jp.albedo) + 0.1 * rng.standard_normal((N, 3)),
                     0.05, 0.95).astype(np.float32)
    if name == "LED":
        lights = np.asarray([0.9, 1.1, 1.0], np.float32)
    else:
        lights = np.tile(sc["light"], (3, 1)).astype(np.float32)
    poses = sc["poses"]
    jrd = jrender.compute_residuals(
        jp, geom, jnp.asarray(dist), jnp.asarray(albedo), jp.grad_stored,
        jnp.asarray(poses), jnp.asarray(sc["images"]), jnp.asarray(sc["K"]),
        jnp.asarray(lights), model=name, order=order, loss=robust.CAUCHY, lam=0.2,
        voxel_size=h)
    tp = convert.problem_from_numpy(ht.problem_j_to_numpy(jp), device=ht.CPU)
    rd = {k: np.asarray(v) for k, v in zip(jrd._fields, jrd)}
    return jp, geom, tp, tg, dist, albedo, poses, jrd, rd, h


def _t_rd(rd):
    return ResidualData(*(torch.from_numpy(np.array(rd[k])) for k in ResidualData._fields))


def _close(t, j, rel):
    """Within `rel` of the JAX result's largest magnitude."""
    t, j = ht.t2n(t), np.asarray(j)
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-20)
    err = float(np.abs(t - j).max())
    assert err <= rel * scale, (err, scale)


CASES = [("SH1", False), ("LED", False), ("LED", True)]
IDS = ["SH1", "LED", "LED-upsampled"]


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,upsampled", CASES, ids=IDS)
def test_operators_match_jax(model, upsampled):
    jp, _, tp, _, dist, _, _, _, _, h = _case(model, upsampled)
    distreg.reset_launch_counts()
    td, jd = torch.from_numpy(dist), jnp.asarray(dist)
    eik, lap = distreg.reg_operators(tp, td, h, eikonal=True, laplacian=True,
                                     diag_only=False)
    je = jsolvers.eikonal_operator(jp, jd, h)
    for name in ("r", "J0", "Ji"):
        _close(getattr(eik, name), getattr(je, name), OPERATOR_TOL)
    assert eik.nbr_idx is tp.nbr_idx
    for diag_only in (False, True):
        _, tl = distreg.reg_operators(tp, td, h, eikonal=False, laplacian=True,
                                      diag_only=diag_only)
        jl = jsolvers.laplacian_operator(jp, jd, h, diag_only)
        assert tl.diag_coef == jl.diag_coef and tl.nbr_coef == jl.nbr_coef
        assert tl.lap_idx is tp.lap_idx
        _close(tl.r, jl.r, OPERATOR_TOL)
        assert torch.equal(tl.r, lap.r)
    # through refine/solvers.py, each operator where its weight is on
    e2, l2 = tsolvers.reg_operators(tp, td, h, reg_weight_n=0.5, reg_weight_l=0.0,
                                    laplacian_diag_only=False)
    assert l2 is None and torch.equal(e2.J0, eik.J0) and torch.equal(e2.Ji, eik.Ji)
    assert tsolvers.reg_operators(tp, td, h, reg_weight_n=0.0, reg_weight_l=0.0,
                                  laplacian_diag_only=False) == (None, None)
    assert distreg.launch_counts == {"reg_operators": 0, "dist_update": 0}
    # the case covers what it claims: invalid rows, frozen and live
    # neighbours, gradients of every length
    valid = np.asarray(jp.valid)
    assert (~valid).sum() > 10 and (ht.t2n(eik.r)[~valid] == 0).all()
    for idx in (np.asarray(jp.nbr_idx)[valid], np.asarray(jp.lap_idx)[valid]):
        assert (idx < 0).sum() > 0 and (idx >= 0).sum() > 100


def _steps(h, N, seed):
    """Steps of every kind: small, rejected (over sqrt(3) h), NaN, and at
    the port's threshold and one ulp either side."""
    rng = np.random.default_rng(seed)
    step = (0.5 * h * rng.standard_normal(N)).astype(np.float32)
    step[rng.random(N) < 0.1] = np.float32(3.0 * h)
    thr = np.float32(distreg.accept_threshold(h))
    edge = [np.nextafter(thr, np.float32(0)), thr, np.nextafter(thr, np.float32(1))]
    step[:6] = np.asarray(edge + [-e for e in edge], np.float32)
    step[6] = np.nan
    return step


def _jax_threshold(h):
    return np.float32(np.float32(math.sqrt(3.0)) * np.float32(h))


@pytest.mark.parametrize("model,upsampled", CASES, ids=IDS)
def test_update_matches_jax(model, upsampled):
    jp, _, tp, _, dist, _, _, _, _, h = _case(model, upsampled)
    N = dist.shape[0]
    step = _steps(h, N, seed=N)
    td = torch.from_numpy(dist)
    distreg.reset_launch_counts()
    tn, tg = tsolvers.update_distance(tp, td, torch.from_numpy(step), h)
    assert distreg.launch_counts == {"reg_operators": 0, "dist_update": 0}
    # the knife edge: steps between the two thresholds are accepted here and
    # refused by the JAX package; elsewhere the rules agree
    thr, jthr = np.float32(distreg.accept_threshold(h)), _jax_threshold(h)
    assert abs(float(thr) - float(jthr)) <= float(np.spacing(thr))
    knife = (np.abs(step) >= min(thr, jthr)) & (np.abs(step) < max(thr, jthr))
    same = np.where(knife, np.float32(0), step)
    jn, jg = jsolvers.update_distance(jp, jnp.asarray(dist), jnp.asarray(same), h)
    tn2, tg2 = tsolvers.update_distance(tp, td, torch.from_numpy(same), h)
    _close(tn2, jn, DIST_TOL)
    _close(tg2, jg, OPERATOR_TOL)
    # the port's own rule, row by row: the edge steps around its threshold
    valid = np.asarray(jp.valid)
    ok = (np.abs(step) < thr) & valid
    np.testing.assert_array_equal(ht.t2n(tn), np.where(ok, dist - step, dist))
    edge_ok = [bool(abs(s) < thr) for s in step[:6]]
    assert edge_ok == [True, False, False, True, False, False]
    assert torch.equal(tg, tgeometry.fd_grad(tp, tn, h))


@pytest.mark.parametrize("model", MODELS)
def test_update_without_a_step_is_the_gradient(model):
    jp, _, tp, _, dist, _, _, _, _, h = _case(model)
    td = torch.from_numpy(dist)
    tn, tg = distreg.dist_update(tp, td, None, h)
    assert tn is td
    assert torch.equal(tg, tgeometry.fd_grad(tp, td, h))
    _close(tg, jgeometry.fd_grad(jp, jnp.asarray(dist), h), OPERATOR_TOL)
    # a step of zeros and a step nowhere accepted leave the same gradient
    for step in (torch.zeros_like(td), torch.full_like(td, 1.0)):
        n2, g2 = distreg.dist_update(tp, td, step, h)
        assert torch.equal(n2, td) and torch.equal(g2, tg)


@pytest.mark.parametrize("model,upsampled", CASES, ids=IDS)
def test_led_light_normal_equations_match_jax(model, upsampled):
    jp, jg, tp, tg, dist, albedo, poses, jrd, rd, h = _case(model, upsampled)
    grad = np.array(jp.grad_stored)
    normaleq.reset_launch_counts()
    H, g = normaleq.light_normal_eqs_led(
        _t_rd(rd), tp, tg, torch.from_numpy(dist), torch.from_numpy(grad),
        torch.from_numpy(albedo), torch.from_numpy(poses))
    assert normaleq.launch_counts["light_normal_eqs_led"] == 0
    assert H.shape == (3,) and g.shape == (3,)
    J = jjac.light_jacobian_led(jp, jg, jnp.asarray(dist), jp.grad_stored,
                                jnp.asarray(albedo), jnp.asarray(poses))
    jH = jnp.einsum("nfc,nfc->c", jrd.w * J, J)
    jgv = jnp.einsum("nfc,nfc->c", jrd.w * J, jrd.r)
    _close(H, jH, LIGHT_TOL)
    _close(g, jgv, LIGHT_TOL)
    step = tsolvers.solve_light_led_from_normal_eqs(H, g, DAMPING)
    _close(step, jsolvers.solve_light_led(jrd, J, DAMPING), LIGHT_TOL)
    assert float(H.min()) > 0 and float(step.abs().max()) > 1e-6
    # the plain chain of the port is the same sums of the same Jacobian
    Jt = tjac.light_jacobian_led(tp, tg, torch.from_numpy(dist), torch.from_numpy(grad),
                                 torch.from_numpy(albedo), torch.from_numpy(poses))
    H2, g2 = tsolvers.light_normal_eqs_led(_t_rd(rd), Jt)
    assert torch.equal(H, H2) and torch.equal(g, g2)


def test_led_light_with_no_counted_pair_is_zero():
    jp, jg, tp, tg, dist, albedo, poses, jrd, rd, h = _case("LED")
    rd0 = dict(rd, w=np.zeros_like(rd["w"]))
    H, g = normaleq.light_normal_eqs_led(
        _t_rd(rd0), tp, tg, torch.from_numpy(dist), tp.grad_stored,
        torch.from_numpy(albedo), torch.from_numpy(poses))
    assert (H.numpy() == 0).all() and (g.numpy() == 0).all()


# ---------------------------------------------------------------------------
# the wrappers and the C interface
# ---------------------------------------------------------------------------


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_meta(t) for t in x))
    return x


def test_the_wrappers_launch_off_the_cpu_with_the_hosts_constants(monkeypatch):
    """Off the CPU a wrapper goes to its kernel (the launch captured on meta
    tensors, so that no card is needed) with the threshold as the float
    the plain rule compares with, and the grid of row_blocks."""
    jp, jg, tp, tg, dist, albedo, poses, jrd, rd, h = _case("LED")
    seen = {}
    monkeypatch.setattr(kernels, "sm_count", lambda dev: 132)
    monkeypatch.setattr(distreg, "_launch", lambda name, a, dev: seen.update({name: a}))
    monkeypatch.setattr(normaleq, "_launch", lambda name, a, dev: seen.update({name: a}))
    monkeypatch.setattr(normaleq, "_tickets_for", lambda dev, need: torch.zeros(
        need, dtype=torch.int32, device="meta"))
    mp, md = _meta(tp), torch.from_numpy(dist).to("meta")
    N = dist.shape[0]
    eik, lap = distreg.reg_operators(mp, md, h, eikonal=True, laplacian=True, diag_only=True)
    a = seen["reg_operators"]
    assert (a.N, a.eikonal, a.laplacian, a.voxel) == (N, 1, 1, h)
    assert a.blocks == distreg.row_blocks(N, 132) == -(-N // distreg.THREADS)
    assert eik.r.device.type == "meta" and lap.nbr_coef == 0.0
    assert lap.diag_coef == -6.0 / (h * h)
    new, grad = distreg.dist_update(mp, md, md, h)
    a = seen["dist_update"]
    assert a.accept == float(np.float32(math.sqrt(3.0) * h)) and a.voxel == h
    assert new is not md and new.shape == (N,) and grad.shape == (N, 3)
    new, _ = distreg.dist_update(mp, md, None, h)
    assert new is md
    H, g = normaleq.light_normal_eqs_led(
        _meta(_t_rd(rd)), mp, tg, md, _meta(tp.grad_stored),
        torch.from_numpy(albedo).to("meta"), torch.from_numpy(poses).to("meta"))
    a = seen["light_normal_eqs_led"]
    F = poses.shape[0]
    assert (a.n, a.f, a.grid_voxel) == (N, F, tg.voxel_size)
    assert (a.origin_x, a.origin_y, a.origin_z) == tg.origin
    plan = normaleq.led_plan(N, F, 132)
    assert H.shape == g.shape == (3,)
    assert (a.blocks, a.unit_voxels, a.smem) == tuple(plan)
    assert distreg.launch_counts == {"reg_operators": 0, "dist_update": 0}


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    jp, jg, tp, tg, dist, albedo, poses, jrd, rd, h = _case("SH1")
    md = torch.from_numpy(dist).to("meta")
    with pytest.raises(ValueError, match="valid"):
        distreg.reg_operators(tp, md, h, eikonal=True, laplacian=False, diag_only=False)
    with pytest.raises(ValueError, match="delta"):
        distreg.dist_update(_meta(tp), md, md[:-1], h)
    with pytest.raises(ValueError, match="neither"):
        distreg.reg_operators(tp, torch.from_numpy(dist), h, eikonal=False,
                              laplacian=False, diag_only=False)
    with pytest.raises(ValueError, match="idx_xyz"):
        normaleq.light_normal_eqs_led(
            _meta(_t_rd(rd)), tp._replace(idx_xyz=tp.idx_xyz.long().to("meta")), tg, md,
            _meta(tp.grad_stored), torch.from_numpy(albedo).to("meta"),
            torch.from_numpy(poses).to("meta"))


@pytest.mark.parametrize("struct,fields,size", [
    (distreg._RegArgs, ("valid", "voxel"), 8 * 16),
    (distreg._UpdateArgs, ("valid", "accept"), 8 * 12),
    (normaleq._LightLedArgs, ("w", "smem"), 8 * 20)])
def test_the_argument_blocks_have_the_c_layout(struct, fields, size):
    assert ctypes.sizeof(struct) == size
    names = [f[0] for f in struct._fields_]
    assert (names[0], names[-1]) == fields
    assert all(ctypes.sizeof(t) == 8 for _, t in struct._fields_)


@pytest.mark.parametrize("N,sms", [(0, 132), (1, 132), (255, 1), (49152, 132),
                                   (393216, 132), (393216, 16)])
def test_the_grids(N, sms):
    b = distreg.row_blocks(N, sms)
    assert 1 <= b <= max(1, distreg.BLOCKS_PER_SM * sms)
    assert (b - 1) * distreg.THREADS < max(N, 1)
    for F in (1, 8, 40):
        lb = normaleq.led_plan(N, F, sms).blocks
        assert 1 <= lb <= max(1, normaleq.LED_BLOCKS_PER_SM * sms)
        units = -(-N // normaleq.led_unit_voxels(F))
        assert (lb - 1) * normaleq.LED_WARPS < max(units, 1)


def _led_lanes(plan, N, F):
    """csrc/normaleq.cu light_led_kernel's walk: for each warp of the grid,
    its units in order, and in each unit its steps, each step's active lanes
    as (lane, voxel n, keyframe f) -> {warp: [[(lane, n, f), ...] a step]}."""
    uv, warps = plan.unit_voxels, plan.blocks * normaleq.LED_WARPS
    out = {}
    for gw in range(warps):
        steps = []
        for u in range(gw, -(-N // uv), warps):
            n0 = u * uv
            nv = min(uv, N - n0)
            if F <= 32:
                V = 32 // F
                for v0 in range(0, nv, V):
                    steps.append([(l, n0 + v0 + l // F, l % F) for l in range(V * F)
                                  if v0 + l // F < nv])
            else:
                for q0 in range(0, nv * F, 32):
                    steps.append([(l, n0 + (q0 + l) // F, (q0 + l) % F) for l in range(32)
                                  if q0 + l < nv * F])
        out[gw] = steps
    return out


@pytest.mark.parametrize("N,F", [(1, 1), (1, 8), (1, 33), (7, 32), (100, 1), (100, 5),
                                 (33, 32), (65, 33), (49, 40), (3, 257), (2000, 8),
                                 (49152 // 64, 8)])
@pytest.mark.parametrize("sms", [1, 2, 132])
def test_the_led_plan_covers_every_pair_once(N, F, sms):
    """Every pair (voxel, keyframe) in one lane of one step of one warp, a
    step's lanes on consecutive pairs of at most 32 voxels' unit, one wave,
    the poses [12][F] and the warps' sums in a block's shared memory."""
    plan = normaleq.led_plan(N, F, sms)
    uv = plan.unit_voxels
    assert 1 <= uv <= 32 and (F > 32 or uv % (32 // F) == 0)
    assert plan.smem == 48 * F + 8 * 6 * normaleq.LED_WARPS + 16 <= normaleq.SMEM_BLOCK
    assert 1 <= plan.blocks <= normaleq.LED_BLOCKS_PER_SM * sms
    seen = np.zeros((N, F), np.int32)
    for steps in _led_lanes(plan, N, F).values():
        for lanes in steps:
            q = [n * F + f for _, n, f in lanes]
            assert q == list(range(q[0], q[0] + len(q)))      # consecutive pairs
            assert [l for l, _, _ in lanes] == list(range(len(lanes)))
            for _, n, f in lanes:
                seen[n, f] += 1
    assert (seen == 1).all()



@pytest.mark.parametrize("F", [1015, 1016, normaleq.LED_MAX_F])
def test_the_led_plan_takes_the_poses_a_block_holds(F):
    """Up to LED_MAX_F keyframes the poses fit a block's shared memory (past
    1015 beyond the 48 KB a launch gets without asking); one more is
    refused."""
    plan = normaleq.led_plan(49152, F, 132)
    assert plan.smem <= normaleq.SMEM_BLOCK
    assert (plan.smem > 48 * 1024) == (F > 1015)
    with pytest.raises(ValueError, match="keyframes"):
        normaleq.led_plan(49152, normaleq.LED_MAX_F + 1, 132)

# ---------------------------------------------------------------------------
# the paths that reach the wrappers
# ---------------------------------------------------------------------------


def _refiner(model, mesh=None, **cfg):
    from psgradientsdf_tpu_torch import config as tconfig
    from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

    name, order = MODELS[model]
    sc = ht.refine_scene(model=name, order=order, n_poses=4, dim=24, h=H_VOX,
                         H=40, W=40, f=36.0)
    ocfg = tconfig.OptimizerConfig(model=name, order=order, lam=0.2, loss=robust.CAUCHY,
                                   reg_weight_n=0.5, reg_weight_l=0.3, **cfg)
    ref = topt.PhotometricRefiner(
        sc["tvol"], sc["tg"], ocfg, sc["K"], truncation=sc["truncation"],
        metrics=MetricsLogger(None, echo=False),
        mesh=None if mesh is None else pm.make_mesh(*mesh, device="cpu"))
    ref.set_keyframes(sc["images"], sc["poses"], sc["frame_ids"],
                      [f"{i:03d}" for i in range(len(sc["frame_ids"]))])
    ref.init()
    ref.init_albedo()
    return ref


@pytest.mark.parametrize("mesh", [None, (4, 2)], ids=["one-device", "mesh-4x2"])
@pytest.mark.parametrize("joint", [False, True], ids=["distance", "joint"])
def test_the_blocks_go_through_the_wrappers(mesh, joint, monkeypatch):
    """One iteration of the LED light and the distance (or the joint) block:
    on one device the distance block is one fused distance step
    (solvers.distance_step: its regularizers and update stages of
    ops/distcg.py's two launches) and calls neither standalone wrapper, the
    joint block one call of each; on a 4x2 mesh one operators call and one
    gradient call (delta=None) a row of the Z-split and no fused step; one
    light call a block."""
    calls = {"reg_operators": [], "dist_update": [], "light_normal_eqs_led": 0,
             "distance_step": 0}
    real = (distreg.reg_operators, distreg.dist_update, normaleq.light_normal_eqs_led,
            tsolvers.distance_step)

    def reg(*a, **kw):
        calls["reg_operators"].append((kw["eikonal"], kw["laplacian"]))
        return real[0](*a, **kw)

    def upd(*a, **kw):
        calls["dist_update"].append(a[2] is None)
        return real[1](*a, **kw)

    def led(*a, **kw):
        calls["light_normal_eqs_led"] += 1
        return real[2](*a, **kw)

    def step(*a, **kw):
        calls["distance_step"] += 1
        return real[3](*a, **kw)

    monkeypatch.setattr(distreg, "reg_operators", reg)
    monkeypatch.setattr(distreg, "dist_update", upd)
    monkeypatch.setattr(normaleq, "light_normal_eqs_led", led)
    monkeypatch.setattr(tsolvers, "distance_step", step)
    ref = _refiner("LED", mesh)
    cfg = ref.cfg
    before = [t if not isinstance(t, tuple) else tuple(t) for t in ref._state()]
    out = topt._iteration_core(
        *ref._args(), **ref._static_kwargs(), reg_weight_n=cfg.reg_weight_n,
        reg_weight_l=cfg.reg_weight_l, reg_weight_rho=cfg.reg_weight_rho,
        damping=cfg.damping, laplacian_diag_only=False, do_light=True,
        do_albedo=False, do_distance=True, do_pose=joint, joint_dp=joint,
        ops=ref.ops, stencil=ref.stencil)
    rows = 1 if mesh is None else mesh[0]
    blocks = 1 if mesh is None else mesh[0] * mesh[1]
    fused = mesh is None and not joint
    assert calls["distance_step"] == int(fused)
    assert calls["reg_operators"] == ([] if fused else [(True, True)] * rows)
    assert calls["dist_update"] == ([] if fused else [mesh is not None] * rows)
    assert calls["light_normal_eqs_led"] == blocks
    assert out[4] is not before[4]             # the light moved
    d0 = before[0] if mesh is None else torch.cat(before[0])
    d1 = out[0] if mesh is None else torch.cat(out[0])
    assert float((d1 - d0).abs().max()) > 0   # a distance step was taken


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated in numpy float32
# ---------------------------------------------------------------------------

f32 = np.float32


def _norm3(v):
    """geometry.norm3 / stencil.cuh norm3: the fma chain in double, each
    step rounded once to float, the root in double rounded once."""
    s = (v[..., 0] * v[..., 0]).astype(f32)
    s = (v[..., 1].astype(np.float64) ** 2 + s.astype(np.float64)).astype(f32)
    s = (v[..., 2].astype(np.float64) ** 2 + s.astype(np.float64)).astype(f32)
    return np.sqrt(s.astype(np.float64)).astype(f32)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _nbr(x, idx, const):
    return np.where(idx >= 0, x[np.maximum(idx, 0)], const)


def _emulated_operators(p, dist, h):
    """csrc/distreg.cu reg_operators_kernel's rows."""
    inv_h_div = f32(1) / f32(h)
    inv_h, neg_inv_h = f32(1.0 / h), f32(-(1.0 / h))
    inv_h2 = f32(1) / f32(h * h)
    valid, dirs = p["valid"], p["nbr_dir"]
    g = (dirs * (_nbr(dist, p["nbr_idx"], p["nbr_dist_const"]) - dist[:, None])) * inv_h_div
    gnorm = _norm3(g)
    with np.errstate(divide="ignore"):
        scale = np.where(gnorm > 0, f32(1) / np.maximum(gnorm, f32(1e-12)), f32(1))
    J0 = _dot3(g, dirs * neg_inv_h) * scale
    Ji = ((g * dirs) * inv_h) * scale[:, None]
    d_l = _nbr(dist, p["lap_idx"], p["lap_dist_const"])
    s = d_l[:, 0]
    for k in range(1, 6):
        s = s + d_l[:, k]
    lap = (s - f32(6) * dist) * inv_h2
    z = f32(0)
    return (np.where(valid, gnorm - f32(1), z), np.where(valid, J0, z),
            np.where(valid[:, None], Ji, z), np.where(valid, lap, z))


def _emulated_update(p, dist, delta, h):
    """csrc/distreg.cu dist_update_kernel's rows: each neighbour's
    acceptance recomputed from dist and delta."""
    thr = f32(distreg.accept_threshold(h))
    ok = (np.abs(delta) < thr) & p["valid"]
    acc = np.where(ok, dist - delta, dist)
    idx = p["nbr_idx"]
    dn = np.where(idx >= 0, acc[np.maximum(idx, 0)], p["nbr_dist_const"])
    return acc, (p["nbr_dir"] * (dn - acc[:, None])) * (f32(1) / f32(h))


def _bits(a, b):
    a, b = np.asarray(a, f32), np.asarray(b, f32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("model,upsampled", CASES, ids=IDS)
def test_the_kernels_arithmetic_emulated_equals_the_plain_versions(model, upsampled):
    jp, jg, tp, tg, dist, albedo, poses, jrd, rd, h = _case(model, upsampled)
    assert f32(1) / f32(h) == f32(1.0 / h)        # the exact reciprocal
    p = ht.problem_j_to_numpy(jp)
    td = torch.from_numpy(dist)
    eik, lap = distreg.reg_operators(tp, td, h, eikonal=True, laplacian=True,
                                     diag_only=False)
    r, J0, Ji, lr = _emulated_operators(p, dist, h)
    assert _bits(r, eik.r) and _bits(J0, eik.J0) and _bits(Ji, eik.Ji) and _bits(lr, lap.r)
    step = _steps(h, dist.shape[0], seed=3)
    new, grad = distreg.dist_update(tp, td, torch.from_numpy(step), h)
    e_new, e_grad = _emulated_update(p, dist, step, h)
    assert _bits(e_new, new) and _bits(e_grad, grad)
    # the LED light: each voxel's terms once (ghat, the surface point), then
    # each pair's Jacobian row from them, as light_led_kernel forms them
    grad_s = p["grad_stored"]
    ghat = grad_s / np.maximum(_norm3(grad_s), f32(1e-12))[:, None]
    c = (np.asarray(tg.origin, f32) + f32(tg.voxel_size) * p["idx_xyz"].astype(f32))
    x = c - dist[:, None] * ghat
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    dx = x[:, None, :] - t[None]
    pc = np.stack([_dot3(R[None, :, :, i], dx) for i in range(3)], -1)     # R^T dx
    Rp = np.stack([_dot3(R[None, :, i, :], pc) for i in range(3)], -1)     # R p
    pn = np.maximum(_norm3(pc), f32(1e-12))
    refl = _dot3(ghat[:, None, :], Rp) / ((pn * pn) * pn)
    J = refl[..., None] * albedo[:, None, :]
    Jt = tjac.light_jacobian_led(tp, tg, td, tp.grad_stored, torch.from_numpy(albedo),
                                 torch.from_numpy(poses))
    assert _bits(J, Jt)
    wJ = rd["w"] * J
    Hp, gp = normaleq.light_normal_eqs_led(_t_rd(rd), tp, tg, td, tp.grad_stored,
                                           torch.from_numpy(albedo), torch.from_numpy(poses))
    g_scale = float(np.abs(wJ * rd["r"]).sum())
    for sms in (1, 3, 132):
        H, g = _emulated_led_sums(wJ * J, wJ * rd["r"], sms)
        np.testing.assert_allclose(H, Hp.numpy(), rtol=LIGHT_TOL)
        np.testing.assert_allclose(g, gp.numpy(), rtol=LIGHT_TOL, atol=LIGHT_TOL * g_scale)


def _emulated_led_sums(hh, gg, sms):
    """light_led_kernel's sums of the pairs' float32 products hh = w J J and
    gg = w J r [N,F,3] in double: each lane's pairs in its walk's order
    (_led_lanes), each warp's xor butterfly, the warps of a block in order,
    then the last block's lanes over the blocks and the butterfly -> (H [3],
    g [3]) float32."""
    N, F = hh.shape[:2]
    plan = normaleq.led_plan(N, F, sms)
    terms = np.concatenate([hh, gg], axis=-1).astype(np.float64)      # [N,F,6]
    lanes_of = _led_lanes(plan, N, F)
    partial = np.zeros((6, plan.blocks))
    for b in range(plan.blocks):
        total = np.zeros(6)
        for w in range(normaleq.LED_WARPS):
            acc = np.zeros((32, 6))
            for step in lanes_of[b * normaleq.LED_WARPS + w]:
                for lane, n, f in step:
                    acc[lane] += terms[n, f]
            total = total + _warp_butterfly(acc.T)
        partial[:, b] = total
    lanes = np.zeros((6, 32))
    for b in range(plan.blocks):
        lanes[:, b % 32] += partial[:, b]
    out = _warp_butterfly(lanes).astype(f32)
    return out[:3], out[3:]


def _warp_butterfly(v):
    """An xor butterfly over the last axis of v [..., 32] in double."""
    idx = np.arange(32)
    for s in (16, 8, 4, 2, 1):
        v = v + v[..., idx ^ s]
    return v[..., 0]
