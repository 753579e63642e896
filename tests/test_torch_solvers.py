"""The block solvers: the two CGs against scipy and JAX, the stencil
operators as matrices, every solve_* / update_* against the JAX package on
the same float32 state, the Schur solve against the dense joint system, and
the clipped eigen-solve of the light on a rank-deficient and a full-rank
scene."""

import numpy as np
import pytest
import scipy.sparse.linalg
import jax
import jax.numpy as jnp
import torch

import helpers_torch as ht
from psgradientsdf_tpu.refine import jacobians as jjac
from psgradientsdf_tpu.refine import problem as jproblem
from psgradientsdf_tpu.refine import render as jrender
from psgradientsdf_tpu.refine import solvers as jsolvers
from psgradientsdf_tpu.utils import robust
from psgradientsdf_tpu_torch.ops.distcg import stencil_reverse
from psgradientsdf_tpu_torch.refine import jacobians as tjac
from psgradientsdf_tpu_torch.refine import problem as tproblem
from psgradientsdf_tpu_torch.refine import render as trender
from psgradientsdf_tpu_torch.refine import solvers as tsolvers

H_VOX = 0.04


def _spd(n, seed, cond_shift):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    A = A @ A.T + cond_shift * np.eye(n, dtype=np.float32)
    return A, rng.normal(size=(n,)).astype(np.float32)


@pytest.mark.parametrize("n,shift,maxiter,tol", [(64, 64.0, 200, 1e-8), (64, 64.0, 7, 1e-8),
                                                 (200, 5.0, 100, 1e-6), (30, 30.0, 13, 1e-3)])
def test_cg_follows_the_scipy_stop_rule(n, shift, maxiter, tol):
    """Same steps as jax.scipy.sparse.linalg.cg (x0 = 0, stop when
    r.r <= max(tol^2 b.b, atol^2) tested before each step, at most maxiter
    steps, Jacobi M), whatever the polling interval, and scipy's answer."""
    A, b = _spd(n, 0, shift)
    d = np.diag(A).copy()
    tA, tb, td = torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(d)
    x_j, _ = jax.scipy.sparse.linalg.cg(
        lambda x: jnp.asarray(A) @ x, jnp.asarray(b), maxiter=maxiter, tol=tol,
        M=lambda x: x / jnp.asarray(d))
    xs, counts = [], []
    for poll in (1, 3, 10, 1000):
        old = tsolvers.CG_POLL_EVERY
        tsolvers.CG_POLL_EVERY = poll
        try:
            steps = []
            xs.append(tsolvers.cg(lambda x: tA @ x, tb, lambda x: x / td, maxiter, tol,
                                  steps_out=steps))
            counts.append(int(steps[0]))
        finally:
            tsolvers.CG_POLL_EVERY = old
    for x in xs[1:]:
        assert torch.equal(x, xs[0])          # polling never changes the result
    assert len(set(counts)) == 1 and 0 < counts[0] <= maxiter
    np.testing.assert_allclose(ht.t2n(xs[0]), np.asarray(x_j), atol=2e-5)
    # count the steps the rule allows, in float64
    x64, r, k = np.zeros(n), b.astype(np.float64), 0
    p = r / d
    gamma = r @ p
    while r @ r > tol * tol * (b.astype(np.float64) @ b) and k < maxiter:
        Ap = A.astype(np.float64) @ p
        alpha = gamma / (p @ Ap)
        x64, r = x64 + alpha * p, r - alpha * Ap
        z = r / d
        gamma, old_gamma = r @ z, gamma
        p = z + gamma / old_gamma * p
        k += 1
    # float32 rounding costs the long, worse conditioned solve a few steps
    assert abs(counts[0] - k) <= (1 if k < 20 else 3)
    if maxiter >= 100:
        x_s, info = scipy.sparse.linalg.cg(
            A.astype(np.float64), b.astype(np.float64), rtol=tol, atol=0.0,
            maxiter=1000, M=np.diag(1.0 / d))
        assert info == 0
        np.testing.assert_allclose(ht.t2n(xs[0]), x_s, atol=1e-4)


def test_cg_of_zero_rhs_takes_no_step():
    steps = []
    x = tsolvers.cg(lambda v: 2 * v, torch.zeros(8), lambda v: v, 50, 1e-6, steps_out=steps)
    assert torch.equal(x, torch.zeros(8)) and int(steps[0]) == 0


def test_pcg_fixed_matches_scipy_and_jax():
    A, b = _spd(64, 0, 64.0)
    d = np.diag(A).copy()
    tA, tb, td = torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(d)
    x = tsolvers.pcg_fixed(lambda v: tA @ v, tb, lambda v: v / td, 200, 1e-8)
    x_j = jsolvers.pcg_fixed(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                             lambda v: v / jnp.asarray(d), 200, 1e-8)
    x_s, info = scipy.sparse.linalg.cg(A.astype(np.float64), b.astype(np.float64),
                                       rtol=1e-10, atol=0.0, M=np.diag(1.0 / d))
    assert info == 0
    np.testing.assert_allclose(ht.t2n(x), np.asarray(x_j), atol=2e-5)
    np.testing.assert_allclose(ht.t2n(x), x_s, atol=1e-4)
    np.testing.assert_allclose(A @ ht.t2n(x), b, atol=1e-3)
    # the frozen iterate: more trips change nothing
    x2 = tsolvers.pcg_fixed(lambda v: tA @ v, tb, lambda v: v / td, 260, 1e-8)
    assert torch.equal(x, x2)


CASES = [("SH1", 1), ("SH2", 2), ("LED", 1)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def lin(request):
    """A linearization point on both sides: problem, residual pass, all
    Jacobian blocks, with a perturbed state so that every block has work."""
    model, order = request.param
    sc = ht.refine_scene(model=model, order=order, n_poses=2, dim=32, h=H_VOX,
                         H=48, W=48, f=45.0)
    jp = jproblem.extract_problem(sc["jvol"], sc["jg"], sc["frame_ids"])
    tp = tproblem.extract_problem(sc["tvol"], sc["tg"], sc["frame_ids"])
    rng = np.random.default_rng(11)
    valid = np.asarray(jp.valid)
    dist = (np.asarray(jp.dist) + valid * rng.normal(0, 0.1 * H_VOX, valid.shape)
            ).astype(np.float32)
    albedo = np.clip(np.abs(np.asarray(jp.albedo)) * 1.1 + 0.05, 0.05, 0.95).astype(np.float32)
    if model == "LED":
        lights = np.asarray([0.8, 1.0, 1.1], np.float32)
    else:
        lights = np.tile(sc["light"] * 0.9, (2, 1)).astype(np.float32)
    kw = dict(model=model, order=order, loss=robust.CAUCHY, lam=0.2, voxel_size=H_VOX)
    J = dict(p=jp, g=sc["jg"], dist=jnp.asarray(dist), albedo=jnp.asarray(albedo),
             grad=jp.grad_stored, poses=jnp.asarray(sc["poses"]), K=jnp.asarray(sc["K"]),
             lights=jnp.asarray(lights), images=jnp.asarray(sc["images"]))
    T = dict(p=tp, g=sc["tg"], dist=torch.from_numpy(dist), albedo=torch.from_numpy(albedo),
             grad=tp.grad_stored, poses=torch.from_numpy(sc["poses"]),
             K=torch.from_numpy(sc["K"]), lights=torch.from_numpy(lights),
             images=torch.from_numpy(sc["images"]))
    for S, rmod, jmod in ((J, jrender, jjac), (T, trender, tjac)):
        S["rd"] = rmod.compute_residuals(
            S["p"], S["g"], S["dist"], S["albedo"], S["grad"], S["poses"], S["images"],
            S["K"], S["lights"], **kw)
        S["G"] = (jmod.image_pi_grad(None, S["rd"], S["K"]) if jmod is jjac
                  else jmod.image_pi_grad(S["rd"], S["K"]))
        if model == "LED":
            S["DJ"] = jmod.dist_jacobian_led(S["p"], S["g"], S["dist"], S["albedo"], S["grad"],
                                             S["lights"], S["G"], S["poses"], H_VOX)
            S["Jc"] = jmod.pose_jacobian_led(S["G"], S["rd"], S["poses"], S["albedo"],
                                             S["grad"], S["lights"])
            S["Jrho"] = jmod.albedo_jacobian_led(S["p"], S["g"], S["dist"], S["grad"],
                                                 S["poses"], S["lights"])
            S["Jl"] = jmod.light_jacobian_led(S["p"], S["g"], S["dist"], S["grad"],
                                              S["albedo"], S["poses"])
        else:
            S["DJ"] = jmod.dist_jacobian_sh(S["p"], S["g"], S["dist"], S["albedo"], S["grad"],
                                            S["lights"], S["G"], S["poses"], H_VOX, order)
            S["Jc"] = jmod.pose_jacobian_sh(S["G"], S["rd"], S["poses"])
            S["Jrho"] = jmod.albedo_jacobian_sh(S["p"], S["grad"], S["lights"], order)
            S["Jl"] = jmod.light_jacobian_sh(S["p"], S["albedo"], S["grad"], order)
    return dict(J=J, T=T, model=model, order=order)


def _close(t, j, rel):
    """Within `rel` of the JAX result's largest magnitude."""
    t, j = ht.t2n(t), np.asarray(j)
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-20)
    err = float(np.abs(t - j).max())
    assert err <= rel * scale, (err, scale)


def test_stencil_operators_match_jax_and_are_transposes(lin):
    J, T = lin["J"], lin["T"]
    rng = np.random.default_rng(1)
    N = T["dist"].shape[0]
    x = rng.normal(size=N).astype(np.float32)
    y = rng.normal(size=T["rd"].r.shape).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tJ0, tJi, tn = T["DJ"].J0, T["DJ"].Ji, T["p"].nbr_idx
    jJ0, jJi, jn = J["DJ"].J0, J["DJ"].Ji, J["p"].nbr_idx
    _close(tsolvers.stencil_apply(tx, tJ0, tJi, tn),
           jsolvers.stencil_apply(jnp.asarray(x), jJ0, jJi, jn), 1e-5)
    _close(tsolvers.stencil_apply_T(ty, tJ0, tJi, tn),
           jsolvers.stencil_apply_T(jnp.asarray(y), jJ0, jJi, jn), 1e-5)
    _close(tsolvers.stencil_diag(T["rd"].w, tJ0, tJi, tn),
           jsolvers.stencil_diag(J["rd"].w, jJ0, jJi, jn), 1e-5)
    # <J x, y> == <x, J^T y> in float64
    d0, di = tJ0.double(), tJi.double()
    lhs = (tsolvers.stencil_apply(tx.double(), d0, di, tn) * ty.double()).sum()
    rhs = (tx.double() * tsolvers.stencil_apply_T(ty.double(), d0, di, tn)).sum()
    assert abs(float(lhs - rhs)) <= 1e-9 * abs(float(lhs))
    # the diagonal is the diagonal: probe a few unit vectors
    w64 = T["rd"].w.double()
    diag = tsolvers.stencil_diag(w64, d0, di, tn)
    for i in rng.integers(0, T["p"].n_surface, 5):
        e = torch.zeros(N, dtype=torch.float64)
        e[i] = 1.0
        col = tsolvers.stencil_apply_T(w64 * tsolvers.stencil_apply(e, d0, di, tn), d0, di, tn)
        assert abs(float(col[i] - diag[i])) <= 1e-9 * max(abs(float(diag[i])), 1e-30)


def test_regularizer_operators(lin):
    J, T = lin["J"], lin["T"]
    rng = np.random.default_rng(2)
    N = T["dist"].shape[0]
    x = rng.normal(size=N).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    te = tsolvers.eikonal_operator(T["p"], T["dist"], H_VOX)
    je = jsolvers.eikonal_operator(J["p"], J["dist"], H_VOX)
    for name in ("r", "J0", "Ji"):
        _close(getattr(te, name), getattr(je, name), 2e-6)
    for diag_only in (False, True):
        tl = tsolvers.laplacian_operator(T["p"], T["dist"], H_VOX, diag_only)
        jl = jsolvers.laplacian_operator(J["p"], J["dist"], H_VOX, diag_only)
        assert tl.diag_coef == jl.diag_coef and tl.nbr_coef == jl.nbr_coef
        _close(tl.r, jl.r, 2e-6)
        _close(tsolvers.lap_apply(tx, tl, T["p"].valid), jsolvers.lap_apply(jx, jl, J["p"].valid), 2e-6)
        _close(tsolvers.lap_apply_T(tx, tl, T["p"].valid),
               jsolvers.lap_apply_T(jx, jl, J["p"].valid), 2e-6)
        _close(tsolvers.lap_diag(tl, T["p"].valid), jsolvers.lap_diag(jl, J["p"].valid), 1e-6)
        y = torch.from_numpy(rng.normal(size=N)).double()
        tl64 = tl._replace(r=tl.r.double())
        lhs = (tsolvers.lap_apply(tx.double(), tl64, T["p"].valid) * y).sum()
        rhs = (tx.double() * tsolvers.lap_apply_T(y, tl64, T["p"].valid)).sum()
        assert abs(float(lhs - rhs)) <= 1e-9 * abs(float(lhs))


@pytest.mark.parametrize("w_n,w_l", [(0.5, 0.0), (0.5, 2e-7), (0.0, 0.0)])
@pytest.mark.parametrize("static", [False, True])
def test_solve_and_update_distance(lin, w_n, w_l, static):
    J, T = lin["J"], lin["T"]
    kw = dict(reg_weight_n=w_n, reg_weight_l=w_l, damping=1.0, cg_static=static)
    steps = []
    td = tsolvers.solve_distance(T["p"], T["rd"], T["DJ"], T["dist"], H_VOX, steps_out=steps,
                                 stencil=stencil_reverse(T["p"]), **kw)
    jd = jsolvers.solve_distance(J["p"], J["rd"], J["DJ"], J["dist"], H_VOX, **kw)
    assert float(td.abs().max()) > 1e-4               # a real step
    assert (ht.t2n(td)[~ht.t2n(T["p"].valid)] == 0).all()
    _close(td, jd, 2e-4)                                   # CG in float32, other sum orders
    assert static or 1 <= int(steps[0]) <= 100
    # the update rule on the same step: exact
    step = np.asarray(jd).copy()
    step[:5] = 2.0 * H_VOX                                 # rejected: over sqrt(3) h
    tn, tg = tsolvers.update_distance(T["p"], T["dist"], torch.from_numpy(step), H_VOX)
    jn, jg = jsolvers.update_distance(J["p"], J["dist"], jnp.asarray(step), H_VOX)
    _close(tn, jn, 1e-7)
    _close(tg, jg, 2e-6)
    assert torch.equal(tn[:5], T["dist"][:5])


@pytest.mark.parametrize("w_rho", [0.0, 0.05])
def test_solve_and_update_albedo(lin, w_rho):
    J, T = lin["J"], lin["T"]
    kw = dict(reg_weight_rho=w_rho, damping=1.0)
    ta, _ = tsolvers.solve_albedo(T["p"], T["rd"], T["albedo"], T["grad"], T["lights"],
                                  T["poses"], H_VOX, model=lin["model"], order=lin["order"],
                                  stencil=stencil_reverse(T["p"]), **kw)
    ja = jsolvers.solve_albedo(J["p"], J["rd"], J["Jrho"], J["albedo"], H_VOX, **kw)
    assert ta.shape == T["albedo"].shape and float(ta.abs().max()) > 1e-3
    _close(ta, ja, 2e-4)
    step = np.asarray(ja).copy()
    step[:5] = 5.0                                         # rejected: leaves (0, 1)
    tn = tsolvers.update_albedo(T["p"], T["albedo"], torch.from_numpy(step))
    jn = jsolvers.update_albedo(J["p"], J["albedo"], jnp.asarray(step))
    np.testing.assert_array_equal(ht.t2n(tn), np.asarray(jn))
    assert torch.equal(tn[:5], T["albedo"][:5])


def test_solve_light(lin):
    J, T = lin["J"], lin["T"]
    if lin["model"] == "LED":
        tl = tsolvers.solve_light_led(T["rd"], T["Jl"], 3.0)
        jl = jsolvers.solve_light_led(J["rd"], J["Jl"], 3.0)
        assert tl.shape == (3,)
        _close(tl, jl, 1e-5)
    else:
        tl = tsolvers.solve_light_sh(T["rd"], T["Jl"])
        jl = jsolvers.solve_light_sh(J["rd"], J["Jl"])
        assert tl.shape == T["lights"].shape
        # the wavy scene's normals span the basis: full rank, but the
        # normals cluster round the viewing axis, so the Gram matrices are
        # badly conditioned (order 2: eigenvalues over 5 decades) and the
        # two float32 eigen-solves part in the weak directions
        _close(tl, jl, 1e-3 if lin["order"] == 1 else 2e-2)


def test_solve_pose_and_update(lin):
    J, T = lin["J"], lin["T"]
    tH, tg = tsolvers.pose_normal_eqs(T["rd"], T["Jc"])
    jH = jnp.einsum("nfc,nfcb,nfcd->fbd", J["rd"].w, J["Jc"], J["Jc"])
    jg = jnp.einsum("nfc,nfcb,nfc->fb", J["rd"].w, J["Jc"], J["rd"].r)
    _close(tH, jH, 1e-5)
    _close(tg, jg, 1e-5)
    txi = tsolvers.solve_pose_from_normal_eqs(tH, tg, 1.0)
    jxi = jsolvers.solve_pose_from_normal_eqs(jH, jg, 1.0)
    _close(txi, jxi, 1e-3)                                 # 6x6 LU in float32
    before = T["poses"].clone()
    tn = tsolvers.update_poses(T["poses"], torch.from_numpy(np.array(jxi)))
    jn = jsolvers.update_poses(J["poses"], jxi)
    np.testing.assert_allclose(ht.t2n(tn), np.asarray(jn), atol=1e-6)
    assert torch.equal(T["poses"], before) and tn.data_ptr() != T["poses"].data_ptr()
    R = ht.t2n(tn)[:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (2, 1, 1)), atol=1e-6)


def test_joint_solve_matches_jax(lin):
    J, T = lin["J"], lin["T"]
    kw = dict(reg_weight_n=0.5, reg_weight_l=0.0, damping=1.0)
    td, txi = tsolvers.solve_joint_dist_pose(T["p"], T["rd"], T["DJ"], T["Jc"], T["dist"], H_VOX, **kw)
    jd, jxi = jsolvers.solve_joint_dist_pose(J["p"], J["rd"], J["DJ"], J["Jc"], J["dist"], H_VOX, **kw)
    _close(td, jd, 5e-4)
    _close(txi, jxi, 2e-3)


def test_joint_solve_raises_when_a_pose_block_is_not_positive_definite(lin):
    T = lin["T"]
    bad = T["Jc"] * float("nan")
    with pytest.raises(torch.linalg.LinAlgError):
        tsolvers.solve_joint_dist_pose(T["p"], T["rd"], T["DJ"], bad, T["dist"], H_VOX,
                                       reg_weight_n=0.5, reg_weight_l=0.0, damping=1.0)


def test_joint_dist_pose_schur_matches_dense():
    """Schur-complement elimination == a dense solve of the joint system,
    materialised by probing the port's own operators in float64, on a real
    (small-N) refinement problem."""
    sc = ht.refine_scene(n_poses=2, dim=24, h=0.05, H=40, W=40, f=36.0)
    tp = tproblem.extract_problem(sc["tvol"], sc["tg"], sc["frame_ids"])
    h = 0.05
    dd_ = lambda a: a.double() if torch.is_tensor(a) and a.dtype == torch.float32 else a
    p = tp._replace(**{k: dd_(v) for k, v in tp._asdict().items()})
    poses = torch.from_numpy(sc["poses"]).double()
    K = torch.from_numpy(sc["K"]).double()
    lights = torch.from_numpy(np.tile(sc["light"], (2, 1))).double()
    rd = trender.compute_residuals(
        p, sc["tg"], p.dist, p.albedo, p.grad_stored, poses,
        torch.from_numpy(sc["images"]).double(), K, lights, model="SH1", order=1,
        loss=robust.CAUCHY, lam=0.2, voxel_size=h)
    G = tjac.image_pi_grad(rd, K)
    DJ = tjac.dist_jacobian_sh(p, sc["tg"], p.dist, p.albedo, p.grad_stored, lights, G,
                               poses, h, 1)
    J_c = tjac.pose_jacobian_sh(G, rd, poses)
    skw = dict(reg_weight_n=0.5, reg_weight_l=0.0, damping=1.0)
    dd, dxi = tsolvers.solve_joint_dist_pose(p, rd, DJ, J_c, p.dist, h, cg_iters=600,
                                             cg_tol=1e-12, **skw)

    vi = torch.nonzero(p.valid)[:, 0]
    n_v, F, N = len(vi), 2, p.valid.shape[0]
    w = torch.where(p.valid[:, None, None], rd.w, 0.0)
    b_d, _, hdd_mv = tsolvers._distance_system(p, rd, DJ, p.dist, h,
                                               laplacian_diag_only=False, **skw)
    H = np.zeros((n_v + 6 * F, n_v + 6 * F))
    for k, i in enumerate(vi.tolist()):
        e = torch.zeros(N, dtype=torch.float64)
        e[i] = 1.0
        H[:n_v, k] = hdd_mv(e)[vi].numpy()
        Jdx = tsolvers.stencil_apply(e, DJ.J0, DJ.Ji, p.nbr_idx)
        H[n_v:, k] = torch.einsum("nfc,nfcb->fb", w * Jdx, J_c).reshape(-1).numpy()
    H[:n_v, n_v:] = H[n_v:, :n_v].T
    H_pp = torch.einsum("nfcb,nfcd->fbd", w[..., None] * J_c, J_c).numpy()
    for f in range(F):
        H[n_v + 6 * f:n_v + 6 * f + 6, n_v + 6 * f:n_v + 6 * f + 6] = (
            H_pp[f] + np.diag(np.diag(H_pp[f])) + 1e-8 * np.eye(6))
    g = np.concatenate([b_d[vi].numpy(),
                        torch.einsum("nfcb,nfc->fb", J_c, w * rd.r).reshape(-1).numpy()])
    sol = np.linalg.solve(H, g)
    np.testing.assert_allclose(dd[vi].numpy(), sol[:n_v], atol=1e-7)
    np.testing.assert_allclose(dxi.reshape(-1).numpy(), sol[n_v:], atol=1e-7)


def _light_system(normals, F=2, seed=0):
    rng = np.random.default_rng(seed)
    N = normals.shape[0]
    albedo = rng.uniform(0.3, 0.8, (N, 3)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, (N, F, 3)).astype(np.float32)
    r = rng.normal(0, 0.05, (N, F, 3)).astype(np.float32)
    return albedo, w, r


@pytest.mark.parametrize("flat", [True, False])
def test_light_solve_on_rank_deficient_and_full_rank_scenes(flat):
    """Order 2 on a flat scene: every normal is (0, 0, -1), every voxel has
    the same basis vector and the Gram matrix has rank 1.
    The clipped eigen-solve must give the finite minimum-norm step, equal to
    the pseudo-inverse's, whatever order the library lists the null space in;
    on a scene whose normals span the basis it is the plain solve."""
    from psgradientsdf_tpu.utils import sh as jsh
    from psgradientsdf_tpu_torch.refine.render import ResidualData

    rng = np.random.default_rng(3)
    N = 400
    if flat:
        n = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (N, 1))
    else:
        n = rng.normal(size=(N, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
    albedo, w, r = _light_system(n)
    basis = np.asarray(jsh.sh_basis(jnp.asarray(n), 2))
    J_l = -albedo[..., None] * basis[:, None, :]                     # [N,3,9]
    z = torch.zeros(1)
    trd = ResidualData(r=torch.from_numpy(r), w=torch.from_numpy(w), mask=z, p_cam=z, uv=z, g_img=z)
    got = ht.t2n(tsolvers.solve_light_sh(trd, torch.from_numpy(J_l)))
    assert np.isfinite(got).all()

    class JRd:
        pass
    jrd = JRd()
    jrd.w, jrd.r = jnp.asarray(w), jnp.asarray(r)
    want_j = np.asarray(jsolvers.solve_light_sh(jrd, jnp.asarray(J_l)))
    H = np.einsum("nfc,ncb,ncd->fbd", w.astype(np.float64), J_l, J_l)
    g = np.einsum("nfc,ncb,nfc->fb", w.astype(np.float64), J_l, r)
    rank = [int(np.linalg.matrix_rank(Hf, tol=1e-6 * np.linalg.norm(Hf, 2))) for Hf in H]
    assert rank == ([1, 1] if flat else [9, 9])
    want = np.stack([np.linalg.pinv(Hf, rcond=1e-6, hermitian=True) @ gf for Hf, gf in zip(H, g)])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-3 * scale
    assert np.abs(got - want_j).max() <= 2e-3 * scale
