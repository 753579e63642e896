"""The one-device distance block's step with its tail as stages, on the CPU:
refine/solvers.distance_step over ops/distcg.dist_system_reg (the Eikonal
row and the Laplacian's residual a stage of the assembly) and
ops/distcg.dist_cg_update (the accept rule and the new gradient a stage of
the CG), where the wrappers run their plain chains.

Within the port: the step equals solve_distance then update_distance bit
for bit and launches nothing on the CPU; the refiner's distance block
(optimizer._dist_core) goes through it.  Against the JAX package
(refine/solvers.py `solve_distance`, `update_distance` and
refine/optimizer.py `_dist_core`) on the same numpy problem, state and
residual pass (tests/helpers_torch.py's refinement scene), SH1 and LED, the
Eikonal operator alone and both operators, both stop rules, at the
tolerances tests/test_torch_solvers.py states: the step within 2e-4 of its
largest magnitude (a float32 CG whose sums run in another order), the
update on the port's step within 1e-7 (distances) and 2e-6 (gradient).
The C argument blocks have csrc/distcg.cu's layout, the fused wrappers
launch off the CPU with the host's constants (captured on meta tensors),
and a numpy float32 emulation of each stage in its kernel's order (the
producer lanes' rows of each tile; each block's rows after the update
barrier, its own rows' steps from x) equals the plain versions bit for bit
(at a voxel size whose reciprocal is exact).  The kernels are held against
the plain chains on the card by chip_smoke.py (phase dist_tail_kernels).
"""

import ctypes
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch as ht
from psgradientsdf_tpu.refine import jacobians as jjac
from psgradientsdf_tpu.refine import optimizer as jopt
from psgradientsdf_tpu.refine import problem as jproblem
from psgradientsdf_tpu.refine import render as jrender
from psgradientsdf_tpu.refine import solvers as jsolvers
from psgradientsdf_tpu.utils import robust
from psgradientsdf_tpu_torch import convert, kernels
from psgradientsdf_tpu_torch.ops import distcg, distreg, residual
from psgradientsdf_tpu_torch.refine import geometry as tgeometry
from psgradientsdf_tpu_torch.refine import optimizer as topt
from psgradientsdf_tpu_torch.refine import solvers as tsolvers
from psgradientsdf_tpu_torch.refine.render import ResidualData

torch.set_num_threads(1)

H_VOX = 0.03125          # 1/32: its reciprocal and its square are exact
MODELS = {"SH1": ("SH1", 1), "LED": ("LED", 1)}
DAMPING = 1.0
STEP_TOL = 2e-4
DIST_TOL = 1e-7
GRAD_TOL = 2e-6
# (reg_weight_n, reg_weight_l, laplacian_diag_only)
WEIGHTS = [(0.5, 0.0, False), (0.5, 2e-7, False), (0.5, 2e-7, True), (0.0, 0.0, False)]
WEIGHT_IDS = ["eikonal", "both", "both-diag", "none"]
JAX_WEIGHTS, JAX_IDS = WEIGHTS[:2], WEIGHT_IDS[:2]
f32 = np.float32


@functools.lru_cache(maxsize=None)
def _case(model):
    """Both packages' problem and state and the JAX residual pass (the
    port's rd its numpy copy): dict."""
    name, order = MODELS[model]
    sc = ht.refine_scene(model=name, order=order, n_poses=3, dim=24, h=H_VOX,
                         H=40, W=40, f=36.0)
    jp = jproblem.extract_problem(sc["jvol"], sc["jg"], sc["frame_ids"])
    rng = np.random.default_rng(17)
    N = jp.dist.shape[0]
    valid = np.asarray(jp.valid)
    dist = (np.asarray(jp.dist) + valid * 0.1 * H_VOX * rng.standard_normal(N)
            ).astype(np.float32)
    albedo = np.clip(np.asarray(jp.albedo) + 0.1 * rng.standard_normal((N, 3)),
                     0.05, 0.95).astype(np.float32)
    if name == "LED":
        lights = np.asarray([0.9, 1.1, 1.0], np.float32)
    else:
        lights = np.tile(sc["light"] * 0.9, (3, 1)).astype(np.float32)
    kw = dict(model=name, order=order, loss=robust.CAUCHY, lam=0.2, voxel_size=H_VOX)
    J = dict(p=jp, g=sc["jg"], dist=jnp.asarray(dist), albedo=jnp.asarray(albedo),
             grad=jp.grad_stored, poses=jnp.asarray(sc["poses"]), K=jnp.asarray(sc["K"]),
             lights=jnp.asarray(lights))
    J["rd"] = jrender.compute_residuals(
        jp, sc["jg"], J["dist"], J["albedo"], J["grad"], J["poses"],
        jnp.asarray(sc["images"]), J["K"], J["lights"], **kw)
    G = jjac.image_pi_grad(None, J["rd"], J["K"])
    jmake = jjac.dist_jacobian_led if name == "LED" else jjac.dist_jacobian_sh
    J["DJ"] = (jmake(jp, sc["jg"], J["dist"], J["albedo"], J["grad"], J["lights"], G,
                     J["poses"], H_VOX) if name == "LED" else
               jmake(jp, sc["jg"], J["dist"], J["albedo"], J["grad"], J["lights"], G,
                     J["poses"], H_VOX, order))
    tp = convert.problem_from_numpy(ht.problem_j_to_numpy(jp), device=ht.CPU)
    rd = ResidualData(*(torch.from_numpy(np.array(v)) for v in J["rd"]))
    T = dict(p=tp, g=sc["tg"], dist=torch.from_numpy(dist),
             albedo=torch.from_numpy(albedo), grad=tp.grad_stored,
             poses=torch.from_numpy(sc["poses"]), K=torch.from_numpy(sc["K"]),
             lights=torch.from_numpy(lights), rd=rd)
    _, T["DJ"] = residual.dist_jacobian(
        tp, sc["tg"], rd, T["dist"], T["albedo"], T["grad"], T["poses"], T["K"],
        T["lights"], model=name, order=order, voxel_size=H_VOX)
    T["stencil"] = distcg.stencil_reverse(tp)
    return dict(J=J, T=T, kw=kw, dist=dist)


def _close(t, j, rel):
    """Within `rel` of the JAX result's largest magnitude."""
    t = ht.t2n(t) if isinstance(t, torch.Tensor) else t
    j = np.asarray(j)
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-20)
    err = float(np.abs(t - j).max())
    assert err <= rel * scale, (err, scale)


def _bits(a, b):
    a, b = np.asarray(a, f32), np.asarray(b, f32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _weights(w):
    w_n, w_l, diag_only = w
    return dict(reg_weight_n=w_n, reg_weight_l=w_l, damping=DAMPING,
                laplacian_diag_only=diag_only)


def _reset():
    distcg.reset_launch_counts()
    distreg.reset_launch_counts()


def _no_launch():
    assert distcg.launch_counts == {"dist_system": 0, "dist_cg": 0}
    assert distreg.launch_counts == {"reg_operators": 0, "dist_update": 0}


# ---------------------------------------------------------------------------
# the step against the unfused chain and against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("static", [False, True], ids=["scipy", "static"])
@pytest.mark.parametrize("w", WEIGHTS, ids=WEIGHT_IDS)
@pytest.mark.parametrize("model", MODELS)
def test_the_step_is_solve_then_update_bit_for_bit(model, w, static):
    T = _case(model)["T"]
    kw = dict(_weights(w), cg_static=static, stencil=T["stencil"])
    args = (T["p"], T["rd"], T["DJ"], T["dist"], H_VOX)
    _reset()
    s1, s2 = [], []
    new, grad = tsolvers.distance_step(*args, steps_out=s1, **kw)
    delta = tsolvers.solve_distance(*args, steps_out=s2, **kw)
    want = tsolvers.update_distance(T["p"], T["dist"], delta, H_VOX)
    _no_launch()
    assert torch.equal(new, want[0]) and torch.equal(grad, want[1])
    assert int(s1[0]) == int(s2[0]) >= 1
    assert float((new - T["dist"]).abs().max()) > 0    # a step was accepted
    # the stages' wrappers give the chain's intermediate results too
    A, t, lap = distcg.dist_system_reg(
        T["rd"], T["DJ"], T["p"], T["dist"], T["stencil"], H_VOX,
        reg_weight_n=w[0], reg_weight_l=w[1], diag_only=w[2])
    eik, lap2 = tsolvers.reg_operators(T["p"], T["dist"], H_VOX, reg_weight_n=w[0],
                                       reg_weight_l=w[1], laplacian_diag_only=w[2])
    A2, t2 = distcg.dist_system(T["rd"], T["DJ"], eik, reg_weight_n=w[0])
    assert torch.equal(A, A2) and torch.equal(t, t2)
    assert (lap is None) == (lap2 is None) == (w[1] == 0.0)
    if lap is not None:
        assert torch.equal(lap.r, lap2.r)
        assert (lap.diag_coef, lap.nbr_coef) == (lap2.diag_coef, lap2.nbr_coef)
    d3, n3, g3 = distcg.dist_cg_update(
        A, t, T["p"], T["dist"], T["stencil"], lap, H_VOX, reg_weight_l=w[1],
        damping=DAMPING, cg_iters=100, cg_tol=1e-6, cg_static=static)
    assert torch.equal(d3, delta) and torch.equal(n3, new) and torch.equal(g3, grad)


def _knife(step, jstep_thr):
    """Rows whose |step| lies between the port's threshold and the JAX
    package's (ulps apart): the rules part there by design."""
    thr = f32(distreg.accept_threshold(H_VOX))
    a = np.abs(step)
    return (a >= min(thr, jstep_thr)) & (a < max(thr, jstep_thr))


@pytest.mark.parametrize("static", [False, True], ids=["scipy", "static"])
@pytest.mark.parametrize("w", JAX_WEIGHTS, ids=JAX_IDS)
@pytest.mark.parametrize("model", MODELS)
def test_the_stages_match_jax(model, w, static):
    """The fused chain's delta against the JAX package's solve, and the
    update on that delta against the JAX package's update_distance."""
    c = _case(model)
    J, T = c["J"], c["T"]
    w_n, w_l, diag_only = w
    A, t, lap = distcg.dist_system_reg(T["rd"], T["DJ"], T["p"], T["dist"], T["stencil"],
                                       H_VOX, reg_weight_n=w_n, reg_weight_l=w_l,
                                       diag_only=diag_only)
    delta, new, grad = distcg.dist_cg_update(
        A, t, T["p"], T["dist"], T["stencil"], lap, H_VOX, reg_weight_l=w_l,
        damping=DAMPING, cg_iters=100, cg_tol=1e-6, cg_static=static)
    jd = jsolvers.solve_distance(J["p"], J["rd"], J["DJ"], J["dist"], H_VOX,
                                 reg_weight_n=w_n, reg_weight_l=w_l, damping=DAMPING,
                                 laplacian_diag_only=diag_only, cg_static=static)
    assert float(delta.abs().max()) > 1e-4
    _close(delta, jd, STEP_TOL)
    step = ht.t2n(delta)
    jthr = f32(f32(math.sqrt(3.0)) * f32(H_VOX))
    assert not _knife(step, jthr).any()
    jn, jg = jsolvers.update_distance(J["p"], J["dist"], jnp.asarray(step), H_VOX)
    _close(new, jn, DIST_TOL)
    _close(grad, jg, GRAD_TOL)
    assert torch.equal(grad, tgeometry.fd_grad(T["p"], new, H_VOX))


@pytest.mark.parametrize("w", JAX_WEIGHTS, ids=JAX_IDS)
@pytest.mark.parametrize("model", MODELS)
def test_the_distance_block_matches_jax(model, w):
    """optimizer._dist_core (the Jacobian, then the fused step) against the
    JAX package's `_dist_core` from the same state and residual pass: the
    accepted step within STEP_TOL of the JAX one's largest magnitude, the
    same rows moved, the gradient within what that step's error allows (two
    neighbours' errors over h, the directions +-1) plus GRAD_TOL."""
    c = _case(model)
    J, T, kw = c["J"], c["T"], c["kw"]
    wk = _weights(w)
    _reset()
    steps = []
    tn, tg = topt._dist_core(T["p"], T["g"], T["rd"], T["dist"], T["albedo"], T["grad"],
                             T["poses"], T["K"], T["lights"], **kw, **wk,
                             stencil=T["stencil"], steps_out=steps)
    _no_launch()
    jn, jg = jopt._dist_core(J["p"], J["g"], J["rd"], J["dist"], J["albedo"], J["grad"],
                             J["poses"], J["K"], J["lights"], **kw, **wk)
    dist = c["dist"]
    t_step, j_step = dist - ht.t2n(tn), dist - np.asarray(jn)
    assert ((t_step != 0) == (j_step != 0)).all()
    _close(t_step, j_step, STEP_TOL)
    err = float(np.abs(t_step - j_step).max())
    scale = float(np.abs(np.asarray(jg)).max())
    assert float(np.abs(ht.t2n(tg) - np.asarray(jg)).max()) <= (
        2.0 * err / H_VOX + GRAD_TOL * scale)
    assert 1 <= int(steps[0]) <= 100


def test_the_stages_refuse_another_problems_table():
    T = _case("SH1")["T"]
    other = distcg.stencil_reverse(T["p"]._replace(nbr_idx=T["p"].nbr_idx.clone()))
    for table in (None, other):
        with pytest.raises(ValueError, match="another problem"):
            distcg.dist_system_reg(T["rd"], T["DJ"], T["p"], T["dist"], table, H_VOX,
                                   reg_weight_n=0.5, reg_weight_l=0.0, diag_only=False)
        with pytest.raises(ValueError, match="another problem"):
            tsolvers.distance_step(T["p"], T["rd"], T["DJ"], T["dist"], H_VOX,
                                   reg_weight_n=0.5, reg_weight_l=0.0, damping=1.0,
                                   stencil=table)


# ---------------------------------------------------------------------------
# the wrappers and the C interface
# ---------------------------------------------------------------------------


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_meta(t) for t in x))
    return x


def _values(struct):
    return tuple(getattr(struct, name) for name, _ in struct._fields_)


@pytest.mark.parametrize("struct,fields,size,tail", [
    (distcg._SystemArgs, ("w", "voxel"), 8 * 13 + 48 + 8 * 11, "valid"),
    (distcg._CgArgs, ("A", "accept"), 8 * 24 + 96 + 8 * 8, "dist"),
    (distcg._CgPlan, ("blocks", "tail"), 8 * 12, "tail")])
def test_the_argument_blocks_have_the_c_layout(struct, fields, size, tail):
    """Every field 8 bytes (the plans nested whole), the stages' fields
    appended past the plan, so that an earlier build reads the prefix."""
    assert ctypes.sizeof(struct) == size
    names = [f[0] for f in struct._fields_]
    assert (names[0], names[-1]) == fields
    plan_end = (getattr(struct, "plan").offset + ctypes.sizeof(
        dict(struct._fields_)["plan"]) if "plan" in names else 8 * 11)
    assert getattr(struct, tail).offset == plan_end
    for name, t in struct._fields_:
        assert ctypes.sizeof(t) == 8 or name == "plan"


@pytest.mark.parametrize("w", WEIGHTS, ids=WEIGHT_IDS)
def test_the_fused_wrappers_launch_off_the_cpu_with_the_hosts_constants(w, monkeypatch):
    """Off the CPU the two stages' wrappers go to their kernels (the launch
    captured on meta tensors, no card needed): dist_system with the
    regularizer stage where a weight is on (the Eikonal row and the
    Laplacian as asked, the voxel size, the problem's int32 tables),
    dist_cg with the update stage (its plan's one barrier after the last
    step, the threshold the plain rule compares with)."""
    T = _case("LED")["T"]
    w_n, w_l, diag_only = w
    seen = []
    monkeypatch.setattr(kernels, "sm_count", lambda dev: 132)
    monkeypatch.setattr(distcg, "_launch", lambda name, a, dev: seen.append((name, a)))
    monkeypatch.setattr(distcg, "cg_plan", lambda dev, N, **kw: distcg._cg_plan(
        N, sms=132, **kw))
    mp = _meta(T["p"])
    st = distcg.StencilReverse(*(_meta(x) for x in T["stencil"][:3]), mp.nbr_idx)
    md = _meta(T["dist"])
    rd, DJ = _meta(T["rd"]), _meta(T["DJ"])
    N = T["dist"].shape[0]
    A, t, lap = distcg.dist_system_reg(rd, DJ, mp, md, st, H_VOX, reg_weight_n=w_n,
                                       reg_weight_l=w_l, diag_only=diag_only)
    name, a = seen[-1]
    assert name == "dist_system" and A.shape == (N, 10) and t.shape == (N, 4)
    if w_n == 0.0 and w_l == 0.0:
        assert (a.reg, a.eik, a.laplacian) == (0, 0, 0) and lap is None
    else:
        assert (a.reg, a.eik, a.laplacian) == (1, int(w_n != 0.0), int(w_l != 0.0))
        assert (a.voxel, a.reg_weight_n, a.n, a.pairs) == (H_VOX, w_n, N,
                                                            3 * T["rd"].w.shape[1])
    assert _values(a.plan) == tuple(distcg._system_plan(N, 3 * T["rd"].w.shape[1], sms=132))
    assert (lap is None) == (w_l == 0.0)
    if lap is not None:
        assert lap.r.shape == (N,) and lap.r.device.type == "meta"
        assert lap.diag_coef == -6.0 / (H_VOX * H_VOX)
        assert lap.nbr_coef == (0.0 if diag_only else 1.0 / (H_VOX * H_VOX))
    delta, new, grad = distcg.dist_cg_update(
        A, t, mp, md, st, lap, H_VOX, reg_weight_l=w_l, damping=DAMPING, cg_iters=100,
        cg_tol=1e-6, cg_static=False)
    name, a = seen[-1]
    plan = distcg._cg_plan(N, use_lap=lap is not None,
                           lap_nbr=lap is not None and lap.nbr_coef != 0.0, sms=132,
                           update=True)
    assert name == "dist_cg" and _values(a.plan) == tuple(plan) and plan.tail == 1
    assert (a.update, a.voxel) == (1, H_VOX)
    assert a.accept == float(np.float32(math.sqrt(3.0) * H_VOX))
    assert delta.shape == new.shape == (N,) and grad.shape == (N, 3)
    distcg.dist_cg(A, t, mp.valid, st, lap, reg_weight_l=w_l, damping=DAMPING,
                   cg_iters=100, cg_tol=1e-6, cg_static=False)
    name, a = seen[-1]
    assert a.update == 0 and a.plan.tail == 0
    assert distcg.launch_counts == {"dist_system": 0, "dist_cg": 0}


# ---------------------------------------------------------------------------
# the stages' arithmetic, emulated in numpy float32 in the kernels' order
# ---------------------------------------------------------------------------


def _norm3(v):
    """stencil.cuh norm3: the fma chain in double, each step rounded once
    to float, the root in double rounded once."""
    s = (v[..., 0] * v[..., 0]).astype(f32)
    s = (v[..., 1].astype(np.float64) ** 2 + s.astype(np.float64)).astype(f32)
    s = (v[..., 2].astype(np.float64) ** 2 + s.astype(np.float64)).astype(f32)
    return np.sqrt(s.astype(np.float64)).astype(f32)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _emulated_reg_stage(p, st, dist, h, plan):
    """dist_system_kernel's regularizer stage as its producer lanes run it:
    for each tile of the plan, lane l's rows l, l + 32, ... of the tile,
    each formed from the int32 tables (stencil.cuh eikonal_row,
    laplacian_row) -> (r, J0, Ji, lap_r, how often each row was formed)."""
    c = (f32(1) / f32(h), f32(1.0 / h), f32(-(1.0 / h)), f32(1) / f32(h * h))
    N = dist.shape[0]
    out = (np.zeros(N, f32), np.zeros(N, f32), np.zeros((N, 3), f32), np.zeros(N, f32))
    formed = np.zeros(N, np.int64)
    nbr, lap = ht.t2n(st.nbr), ht.t2n(st.lap)
    assert nbr.dtype == lap.dtype == np.int32
    for tile in range(-(-N // plan.tile)):
        n0 = tile * plan.tile
        rows = min(plan.tile, N - n0)
        for lane in range(32):
            n = n0 + np.arange(lane, rows, 32)
            formed[n] += 1
            d, valid = dist[n], p["valid"][n]
            dirs = p["nbr_dir"][n]
            dn = np.where(nbr[n] >= 0, dist[np.maximum(nbr[n], 0)], p["nbr_dist_const"][n])
            g = (dirs * (dn - d[:, None])) * c[0]
            gnorm = _norm3(g)
            with np.errstate(divide="ignore"):
                scale = np.where(gnorm > 0, f32(1) / np.maximum(gnorm, f32(1e-12)), f32(1))
            J0 = _dot3(g, dirs * c[2]) * scale
            Ji = ((g * dirs) * c[1]) * scale[:, None]
            dl = np.where(lap[n] >= 0, dist[np.maximum(lap[n], 0)], p["lap_dist_const"][n])
            s = dl[:, 0]
            for k in range(1, 6):
                s = s + dl[:, k]
            lr = (s - f32(6) * d) * c[3]
            z = f32(0)
            out[0][n] = np.where(valid, gnorm - f32(1), z)
            out[1][n] = np.where(valid, J0, z)
            out[2][n] = np.where(valid[:, None], Ji, z)
            out[3][n] = np.where(valid, lr, z)
    return out + (formed,)


def _emulated_update_stage(p, st, dist, delta, x, h, plan):
    """dist_cg_kernel's update stage after its barrier: each block's rows,
    a row's own and its tile's steps taken from x (the block's vector: delta
    on a valid row, anything on an invalid one), another tile's from delta
    -> (new_dist, new_grad, how often each row was written)."""
    thr = f32(distreg.accept_threshold(h))
    inv_h = f32(1) / f32(h)
    N = dist.shape[0]
    new, grad = np.zeros(N, f32), np.zeros((N, 3), f32)
    written = np.zeros(N, np.int64)
    nbr, valid = ht.t2n(st.nbr), p["valid"]

    def acc(j, step):
        return np.where((np.abs(step) < thr) & valid[j], dist[j] - step, dist[j])

    for b in range(plan.blocks):
        lo, hi = b * plan.tile, min(N, (b + 1) * plan.tile)
        m = np.arange(lo, hi)
        written[m] += 1
        d = acc(m, x[m])
        j = np.maximum(nbr[m], 0)
        own = (j >= lo) & (j < hi)
        dn = np.where(nbr[m] >= 0, acc(j, np.where(own, x[j], delta[j])),
                      p["nbr_dist_const"][m])
        new[m] = d
        grad[m] = (p["nbr_dir"][m] * (dn - d[:, None])) * inv_h
    return new, grad, written


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("model", MODELS)
def test_the_stages_emulated_equal_the_plain_versions(model, sms):
    c = _case(model)
    J, T = c["J"], c["T"]
    p = ht.problem_j_to_numpy(J["p"])
    dist = c["dist"]
    N = dist.shape[0]
    assert f32(1) / f32(H_VOX) == f32(1.0 / H_VOX)          # the exact reciprocal
    eik, lap = distreg.reg_operators_plain(T["p"], T["dist"], H_VOX, eikonal=True,
                                           laplacian=True, diag_only=False)
    splan = distcg._system_plan(N, 3 * T["rd"].w.shape[1], sms=sms)
    r, J0, Ji, lr, formed = _emulated_reg_stage(p, T["stencil"], dist, H_VOX, splan)
    assert (formed == 1).all()
    assert _bits(r, eik.r) and _bits(J0, eik.J0) and _bits(Ji, eik.Ji) and _bits(lr, lap.r)
    # the update on a solve's step, with steps at the threshold, a refused
    # one and a NaN; x differs from delta on every invalid row
    A, t, lapo = distcg.dist_system_reg(T["rd"], T["DJ"], T["p"], T["dist"], T["stencil"],
                                        H_VOX, reg_weight_n=0.5, reg_weight_l=2e-7,
                                        diag_only=False)
    delta = ht.t2n(distcg.dist_cg_plain(A, t, T["p"].valid, T["stencil"], lapo,
                                        reg_weight_l=2e-7, damping=DAMPING, cg_iters=100,
                                        cg_tol=1e-6, cg_static=False)).copy()
    thr = f32(distreg.accept_threshold(H_VOX))
    rows = np.flatnonzero(p["valid"])
    delta[rows[:5]] = [np.nextafter(thr, f32(0)), thr, -thr, f32(3.0 * H_VOX), np.nan]
    x = np.where(p["valid"], delta, f32(0.25 * H_VOX)).astype(f32)
    assert (~p["valid"]).any() and (x[~p["valid"]] != delta[~p["valid"]]).all()
    cplan = distcg._cg_plan(N, use_lap=True, lap_nbr=True, sms=sms, update=True)
    new, grad, written = _emulated_update_stage(p, T["stencil"], dist, delta, x, H_VOX,
                                                cplan)
    assert (written == 1).all()
    want = distreg.dist_update_plain(T["p"], T["dist"], torch.from_numpy(delta), H_VOX)
    assert _bits(new, want[0]) and _bits(grad, want[1])
    moved = new != dist
    assert moved[rows[0]] and not moved[rows[1:5]].any()
