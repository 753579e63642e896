"""The distance block's solve in gather form (ops/distcg.py): the reverse
stencil table against nbr_idx / nbr_dir and lap_idx's symmetry, the
assembled rows against the normal equations, the assembled operator, b and
diag against the JAX package's `_distance_system` (also at each of
dist_system's lane counts), the kernel's one-phase
H p (hp_gather_plain) against the assembled operator bit for bit,
solve_distance through the new path against the JAX package's and against the scatter-add CG's
steps, bit-identical plain runs, the solve's edge cases, the plain PCG
loop it shares with the albedo block against solvers.cg, and the refiner's
table rebuilt with every problem.  On the CPU the wrappers run their plain
versions; the kernels are held against them on the card by chip_smoke.py
(phase dist_cg_kernels)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import helpers_torch as ht
from psgradientsdf_tpu.refine import jacobians as jjac
from psgradientsdf_tpu.refine import problem as jproblem
from psgradientsdf_tpu.refine import render as jrender
from psgradientsdf_tpu.refine import solvers as jsolvers
from psgradientsdf_tpu.utils import robust
from psgradientsdf_tpu_torch import convert
from psgradientsdf_tpu_torch.config import OptimizerConfig
from psgradientsdf_tpu_torch.core.volume import make_volume
from psgradientsdf_tpu_torch.io import checkpoint as ckpt
from psgradientsdf_tpu_torch.ops import distcg
from psgradientsdf_tpu_torch.refine import jacobians as tjac
from psgradientsdf_tpu_torch.refine import problem as tproblem
from psgradientsdf_tpu_torch.refine import render as trender
from psgradientsdf_tpu_torch.refine import solvers as tsolvers
from psgradientsdf_tpu_torch.refine.optimizer import PhotometricRefiner
from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

H_VOX = 0.04
WEIGHTS = [(0.5, 0.0), (0.5, 2e-7), (0.0, 0.0)]


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", params=[("SH1", 1), ("LED", 1)], ids=["SH1", "LED"])
def lin(request):
    """A distance block's linearization point on both sides: the problem,
    the residual pass and the distance Jacobian at a perturbed state."""
    torch.set_num_threads(1)
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
        G = (jmod.image_pi_grad(None, S["rd"], S["K"]) if jmod is jjac
             else jmod.image_pi_grad(S["rd"], S["K"]))
        if model == "LED":
            S["DJ"] = jmod.dist_jacobian_led(S["p"], S["g"], S["dist"], S["albedo"], S["grad"],
                                             S["lights"], G, S["poses"], H_VOX)
        else:
            S["DJ"] = jmod.dist_jacobian_sh(S["p"], S["g"], S["dist"], S["albedo"], S["grad"],
                                            S["lights"], G, S["poses"], H_VOX, order)
    T["stencil"] = distcg.stencil_reverse(tp)
    return dict(J=J, T=T, model=model)


def _close(t, j, rel):
    """Within `rel` of the JAX result's largest magnitude."""
    t, j = ht.t2n(t), np.asarray(j)
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-20)
    err = float(np.abs(t - j).max())
    assert err <= rel * scale, (err, scale)


def _system(T, w_n, w_l):
    """(A, t, lap) of the port's assembled distance system at the state."""
    eik, lap = tsolvers.reg_operators(T["p"], T["dist"], H_VOX, reg_weight_n=w_n,
                                      reg_weight_l=w_l, laplacian_diag_only=False)
    A, t = distcg.dist_system(T["rd"], T["DJ"], eik, reg_weight_n=w_n)
    return A, t, lap


# ------------------------------------------------------------ the tables


def _check_reverse(prob, st):
    """rev names exactly the (row, axis) pairs of nbr_idx, on the side
    nbr_dir says (a clipped border's self-reference below)."""
    nbr, rev = ht.t2n(prob.nbr_idx), ht.t2n(st.rev)
    ndir, xyz = ht.t2n(prob.nbr_dir), ht.t2n(prob.idx_xyz)
    want = np.full(rev.shape, -1, np.int64)
    for n, ax in zip(*np.nonzero(nbr >= 0)):
        m = nbr[n, ax]
        side = 0 if (m == n or ndir[n, ax] > 0) else 1
        assert m == n or xyz[n, ax] + int(ndir[n, ax]) == xyz[m, ax]
        assert want[m, 2 * ax + side] == -1            # named once a side
        want[m, 2 * ax + side] = n
    np.testing.assert_array_equal(rev, want)
    np.testing.assert_array_equal(ht.t2n(st.nbr), nbr)
    np.testing.assert_array_equal(ht.t2n(st.lap), ht.t2n(prob.lap_idx))
    assert st.source is prob.nbr_idx
    lap = ht.t2n(prob.lap_idx)
    for m, k in zip(*np.nonzero(lap >= 0)):           # symmetric between rows
        n = lap[m, k]
        assert n == m or lap[n, k ^ 1] == m
    return int((rev >= 0).sum())


def test_reverse_table_against_nbr_idx_and_nbr_dir(lin):
    assert _check_reverse(lin["T"]["p"], lin["T"]["stencil"]) > 100


def _speckled_problem(seed, dims=(7, 6, 5)):
    """A problem whose surface set is a seeded 60 % of a small grid's voxels:
    frozen neighbours, rows named from both sides, and rows at the grid's
    low border whose forward neighbour is out of the set (the clipped
    stencil names the row itself)."""
    rng = np.random.default_rng(seed)
    geom = convert.geometry(dims, H_VOX, (0.0, 0.0, 1.0))
    vol = make_volume(geom, 5 * H_VOX, frame_cap=32, device="cpu")
    X, Y, Z = dims
    inset = rng.random((Z, Y, X)) < 0.6
    dist = torch.from_numpy(np.where(inset, rng.uniform(-H_VOX, H_VOX, inset.shape),
                                     5 * H_VOX).astype(np.float32))
    vis = torch.from_numpy(np.where(inset, 1, 0).astype(np.int32))[None]
    vol = vol._replace(dist=dist, vis=vis, weight=torch.ones_like(dist))
    return tproblem.extract_problem(vol, geom, [0], capacity=160)


@pytest.mark.parametrize("seed", [0, 1])
def test_reverse_table_at_the_clipped_border(seed):
    prob = _speckled_problem(seed)
    st = distcg.stencil_reverse(prob)
    nbr = ht.t2n(prob.nbr_idx)
    selfs = (nbr == np.arange(nbr.shape[0])[:, None]).sum()
    assert selfs > 0                                   # the border case is there
    assert _check_reverse(prob, st) == int((nbr >= 0).sum())
    # the gather-form transposes equal the scatter-adds (float64)
    N = nbr.shape[0]
    rng = np.random.default_rng(seed + 5)
    J0 = torch.from_numpy(rng.normal(size=(N, 3, 3)))
    Ji = torch.from_numpy(rng.normal(size=(N, 3, 3, 3)))
    w = torch.from_numpy(rng.uniform(0, 1, (N, 3, 3)))
    valid = prob.valid
    w, J0, Ji = (torch.where(valid.reshape((N,) + (1,) * (a.ndim - 1)), a, 0.0)
                 for a in (w, J0, Ji))
    x = torch.from_numpy(rng.normal(size=N))
    rd = type("RD", (), dict(w=w, r=torch.zeros_like(w)))
    DJ = tjac.DistJacobian(J0, Ji)
    A, _ = distcg.dist_system_plain(rd, DJ, None, reg_weight_n=0.0)
    lap = tsolvers.LapOperator(r=torch.zeros(N, dtype=torch.float64),
                               lap_idx=prob.lap_idx, diag_coef=-2.0, nbr_coef=0.5)
    got = distcg.operator_apply(A, x, valid, st, lap, reg_weight_l=0.3)
    want = (tsolvers.stencil_apply_T(w * tsolvers.stencil_apply(x, J0, Ji, prob.nbr_idx),
                                     J0, Ji, prob.nbr_idx)
            + 0.3 * tsolvers.lap_apply_T(tsolvers.lap_apply(x, lap, valid), lap, valid))
    np.testing.assert_allclose(ht.t2n(got), ht.t2n(want), rtol=1e-12, atol=1e-12)
    _, diag = distcg.distance_rhs_plain(A, torch.zeros((N, 4), dtype=torch.float64),
                                        valid, st, lap, reg_weight_l=0.3)
    want_d = (tsolvers.stencil_diag(w, J0, Ji, prob.nbr_idx)
              + 0.3 * tsolvers.lap_diag(lap, valid).double())
    np.testing.assert_allclose(ht.t2n(diag), ht.t2n(want_d), rtol=1e-6, atol=1e-12)


def test_reverse_table_refuses_a_stencil_named_twice():
    prob = _speckled_problem(0)
    nbr = prob.nbr_idx.clone()
    rows = torch.nonzero(nbr[:, 0] >= 0)[:2, 0]
    nbr[rows[1], 0] = nbr[rows[0], 0]                  # two rows name one
    nbr[rows[1], :] = nbr[rows[0], :]
    xyz = prob.idx_xyz.clone()
    xyz[rows[1]] = xyz[rows[0]]
    with pytest.raises(ValueError, match="named twice"):
        distcg.stencil_reverse(prob._replace(nbr_idx=nbr, idx_xyz=xyz))
    lap = prob.lap_idx.clone()
    m = int(torch.nonzero((lap[:, 0] >= 0) & (lap[:, 0] != torch.arange(lap.shape[0])))[0, 0])
    lap[int(lap[m, 0]), 1] = -1                        # the way back is cut
    with pytest.raises(ValueError, match="symmetric"):
        distcg.stencil_reverse(prob._replace(lap_idx=lap))


# -------------------------------------------------------- the assembled rows


@pytest.mark.parametrize("w_n", [0.5, 0.0])
def test_dist_system_is_the_normal_equations(lin, w_n):
    """A_n = sum w a a^T + w_n e e^T and t_n = sum w r a + w_n r_e e, in
    float64 by einsum, within float32 rounding; the wrapper on the CPU is
    the plain version."""
    T = lin["T"]
    A, t, _ = _system(T, w_n, 0.0)
    eik, _ = tsolvers.reg_operators(T["p"], T["dist"], H_VOX, reg_weight_n=w_n,
                                    reg_weight_l=0.0, laplacian_diag_only=False)
    rd, DJ = T["rd"], T["DJ"]
    N = A.shape[0]
    a = torch.stack([DJ.J0.reshape(N, -1), *DJ.Ji.reshape(N, 3, -1).unbind(1)], -1).double()
    w, r = rd.w.reshape(N, -1).double(), rd.r.reshape(N, -1).double()
    full = torch.einsum("nj,nji,njk->nik", w, a, a)
    g = torch.einsum("nj,nji->ni", w * r, a)
    if eik is not None:
        e = torch.cat([eik.J0[:, None], eik.Ji], -1).double()
        full = full + w_n * e[:, :, None] * e[:, None, :]
        g = g + w_n * eik.r.double()[:, None] * e
    want = full[:, [i for i, _ in distcg.A_IDX], [k for _, k in distcg.A_IDX]]
    _close(A, ht.t2n(want), 2e-6)
    _close(t, ht.t2n(g), 2e-6)
    A2, t2 = distcg.dist_system_plain(rd, DJ, eik, reg_weight_n=w_n)
    assert torch.equal(A, A2) and torch.equal(t, t2)


@pytest.mark.parametrize("w_n,w_l", WEIGHTS)
def test_assembled_operator_matches_jax(lin, w_n, w_l):
    """A_n P_n x and the gather-form transpose, plus the regularizers,
    against the JAX package's matrix-free products on a random x."""
    J, T = lin["J"], lin["T"]
    A, _, lap = _system(T, w_n, w_l)
    N = A.shape[0]
    x = np.random.default_rng(3).normal(size=N).astype(np.float32)
    got = distcg.operator_apply(A, torch.from_numpy(x), T["p"].valid, T["stencil"],
                                lap, reg_weight_l=w_l)
    jx, jp, DJ = jnp.asarray(x), J["p"], J["DJ"]
    want = jsolvers.stencil_apply_T(J["rd"].w * jsolvers.stencil_apply(jx, DJ.J0, DJ.Ji, jp.nbr_idx),
                                    DJ.J0, DJ.Ji, jp.nbr_idx)
    if w_n:
        e = jsolvers.eikonal_operator(jp, J["dist"], H_VOX)
        want = want + w_n * jsolvers.stencil_apply_T(
            jsolvers.stencil_apply(jx, e.J0, e.Ji, e.nbr_idx), e.J0, e.Ji, e.nbr_idx)
    if w_l:
        lo = jsolvers.laplacian_operator(jp, J["dist"], H_VOX)
        want = want + w_l * jsolvers.lap_apply_T(jsolvers.lap_apply(jx, lo, jp.valid), lo, jp.valid)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("diag_only", [False, True], ids=["lap", "lap-diag"])
@pytest.mark.parametrize("w_n,w_l", WEIGHTS)
def test_one_phase_hp_is_operator_apply_bit_for_bit(lin, w_n, w_l, diag_only):
    """H p as dist_cg's kernel forms it in one phase (each row recomputing
    s_n[1 + ax] of the rows naming it, hp_gather_plain) equals
    operator_apply bit for bit in float32."""
    T = lin["T"]
    eik, lap = tsolvers.reg_operators(T["p"], T["dist"], H_VOX, reg_weight_n=w_n,
                                      reg_weight_l=w_l, laplacian_diag_only=diag_only)
    A, _ = distcg.dist_system(T["rd"], T["DJ"], eik, reg_weight_n=w_n)
    if w_l and not diag_only:
        assert lap.nbr_coef != 0.0
    x = torch.from_numpy(np.random.default_rng(5).normal(size=A.shape[0]).astype(np.float32))
    kw = dict(reg_weight_l=w_l)
    got = distcg.hp_gather_plain(A, x, T["p"].valid, T["stencil"], lap, **kw)
    want = distcg.operator_apply(A, x, T["p"].valid, T["stencil"], lap, **kw)
    assert bool(want.abs().max() > 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_one_phase_hp_at_the_clipped_border(seed):
    """The same on a speckled surface set (rows naming themselves at the
    grid's low border, frozen neighbours), random float32 rows and the
    Laplacian's neighbour term."""
    prob = _speckled_problem(seed)
    st = distcg.stencil_reverse(prob)
    N = prob.valid.shape[0]
    rng = np.random.default_rng(seed + 9)
    A = torch.from_numpy(rng.normal(size=(N, 10)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    lap = tsolvers.LapOperator(r=torch.zeros(N), lap_idx=prob.lap_idx,
                               diag_coef=-2.5, nbr_coef=0.4)
    got = distcg.hp_gather_plain(A, x, prob.valid, st, lap, reg_weight_l=0.3)
    want = distcg.operator_apply(A, x, prob.valid, st, lap, reg_weight_l=0.3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("w_n,w_l", WEIGHTS)
def test_rhs_and_diag_match_jax_distance_system(lin, w_n, w_l):
    J, T = lin["J"], lin["T"]
    A, t, lap = _system(T, w_n, w_l)
    b, diag = distcg.distance_rhs_plain(A, t, T["p"].valid, T["stencil"], lap,
                                        reg_weight_l=w_l)
    jb, jdiag, _ = jsolvers._distance_system(
        J["p"], J["rd"], J["DJ"], J["dist"], H_VOX, reg_weight_n=w_n,
        reg_weight_l=w_l, damping=1.0, laplacian_diag_only=False)
    _close(b, jb, 1e-5)
    _close(diag, jdiag, 1e-5)


@pytest.mark.parametrize("F", [1, 8, 22, 43, 86])
def test_rows_at_each_lane_count_match_jax_distance_system(lin, F):
    """dist_system_plain at each lane count (system_lanes: 4, 4, 8, 16, 32)
    on random pairs of F keyframes over the problem's stencil: b, diag and
    H x from the assembled rows against the JAX package's
    _distance_system on the same arrays."""
    J, T = lin["J"], lin["T"]
    p = T["p"]
    N = p.valid.shape[0]
    rng = np.random.default_rng(F)
    w = (rng.random((N, F, 3)) * (rng.random((N, F, 1)) > 0.2)).astype(np.float32)
    r = (0.1 * rng.standard_normal((N, F, 3))).astype(np.float32)
    J0 = rng.standard_normal((N, F, 3)).astype(np.float32)
    Ji = (0.5 * rng.standard_normal((N, 3, F, 3))).astype(np.float32)
    x = rng.standard_normal(N).astype(np.float32)
    rd = T["rd"]._replace(w=torch.from_numpy(w), r=torch.from_numpy(r))
    DJ = T["DJ"]._replace(J0=torch.from_numpy(J0), Ji=torch.from_numpy(Ji))
    w_n = 0.5
    eik, _ = tsolvers.reg_operators(p, T["dist"], H_VOX, reg_weight_n=w_n, reg_weight_l=0.0,
                                    laplacian_diag_only=False)
    A, t = distcg.dist_system_plain(rd, DJ, eik, reg_weight_n=w_n)
    b, diag = distcg.distance_rhs_plain(A, t, p.valid, T["stencil"], None, reg_weight_l=0.0)
    hx = distcg.operator_apply(A, torch.from_numpy(x), p.valid, T["stencil"], None,
                               reg_weight_l=0.0)
    jrd = J["rd"]._replace(w=jnp.asarray(w), r=jnp.asarray(r))
    jDJ = J["DJ"]._replace(J0=jnp.asarray(J0), Ji=jnp.asarray(Ji))
    jb, jdiag, hdd = jsolvers._distance_system(
        J["p"], jrd, jDJ, J["dist"], H_VOX, reg_weight_n=w_n, reg_weight_l=0.0,
        damping=0.0, laplacian_diag_only=False)
    _close(b, jb, 1e-5)
    _close(diag, jdiag, 1e-5)
    _close(hx, hdd(jnp.asarray(x)), 1e-5)


# ------------------------------------------------------------------ the solve


def _scatter_cg_steps(T, w_n, w_l):
    """The steps of the scatter-add CG (solvers.cg_chunks over
    _distance_system's matvec, solve_distance's path before the gather
    form) on the same state."""
    p = T["p"]
    b, diag, hdd = tsolvers._distance_system(
        p, T["rd"], T["DJ"], T["dist"], H_VOX, reg_weight_n=w_n, reg_weight_l=w_l,
        damping=1.0, laplacian_diag_only=False)
    d_safe = tsolvers.jacobi_diag(p.valid, diag, 1.0)
    steps = []
    x = tsolvers.cg(lambda v: torch.where(p.valid, hdd(v), v),
                    torch.where(p.valid, b, 0.0), lambda v: v / d_safe, 100, 1e-6,
                    steps_out=steps)
    return int(steps[0]), x


@pytest.mark.parametrize("w_n,w_l", WEIGHTS)
@pytest.mark.parametrize("static", [False, True])
def test_solve_distance_matches_jax(lin, w_n, w_l, static):
    J, T = lin["J"], lin["T"]
    kw = dict(reg_weight_n=w_n, reg_weight_l=w_l, damping=1.0, cg_static=static)
    steps = []
    td = tsolvers.solve_distance(T["p"], T["rd"], T["DJ"], T["dist"], H_VOX,
                                 steps_out=steps, stencil=T["stencil"], **kw)
    jd = jsolvers.solve_distance(J["p"], J["rd"], J["DJ"], J["dist"], H_VOX, **kw)
    assert float(td.abs().max()) > 1e-4
    assert (ht.t2n(td)[~ht.t2n(T["p"].valid)] == 0).all()
    _close(td, jd, 2e-4)
    want_steps, xs = _scatter_cg_steps(T, w_n, w_l)
    assert int(steps[0]) == want_steps and 1 <= want_steps <= 100
    if not static:
        _close(td, ht.t2n(xs), 2e-4)
    # a missing table and another problem's are refused
    other = distcg.stencil_reverse(T["p"]._replace(nbr_idx=T["p"].nbr_idx.clone()))
    for table in (None, other):
        with pytest.raises(ValueError, match="another problem"):
            tsolvers.solve_distance(T["p"], T["rd"], T["DJ"], T["dist"], H_VOX,
                                    stencil=table, **kw)


def test_two_plain_runs_are_bit_identical(lin):
    T = lin["T"]
    A, t, lap = _system(T, 0.5, 2e-7)
    runs = []
    for _ in range(2):
        steps = []
        d = distcg.dist_cg(A.clone(), t.clone(), T["p"].valid, T["stencil"], lap,
                           reg_weight_l=2e-7, damping=1.0, cg_iters=100, cg_tol=1e-6,
                           cg_static=False, steps_out=steps)
        runs.append((d, int(steps[0])))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    A2, t2 = distcg.dist_system(T["rd"], T["DJ"], tsolvers.eikonal_operator(
        T["p"], T["dist"], H_VOX), reg_weight_n=0.5)
    assert torch.equal(A, A2) and torch.equal(t, t2)


def test_stop_rules_and_trace(lin):
    """cg_static runs the same steps to the same threshold without atol;
    the trace holds each test's (r.r, thr), the last one failed; a cap of
    cg_iters steps; atol above b.b stops before the first step."""
    T = lin["T"]
    A, t, lap = _system(T, 0.5, 0.0)
    common = dict(reg_weight_l=0.0, damping=1.0, cg_tol=1e-6)
    trace, s1 = [], []
    d1 = distcg.dist_cg_plain(A, t, T["p"].valid, T["stencil"], None, cg_iters=100,
                              cg_static=False, steps_out=s1, trace=trace, **common)
    s2 = []
    d2 = distcg.dist_cg_plain(A, t, T["p"].valid, T["stencil"], None, cg_iters=100,
                              cg_static=True, steps_out=s2, **common)
    assert int(s1[0]) == int(s2[0]) == len(trace) - 1
    assert all(rr > thr for rr, thr in trace[:-1]) and not trace[-1][0] > trace[-1][1]
    _close(d2, ht.t2n(d1), 1e-5)
    s3 = []
    distcg.dist_cg_plain(A, t, T["p"].valid, T["stencil"], None, cg_iters=3,
                         cg_static=False, steps_out=s3, **common)
    assert int(s3[0]) == 3
    s4 = []
    d4 = distcg.dist_cg_plain(A, t, T["p"].valid, T["stencil"], None, cg_iters=100,
                              cg_static=False, atol=1e3 * trace[0][0] ** 0.5,
                              steps_out=s4, **common)
    assert int(s4[0]) == 0 and not bool(d4.any())


def test_edge_cases_one_row_frozen_neighbours_and_no_valid_row(lin):
    """One row alone (its neighbours frozen: a 1x1 system, solved in one
    step), a row whose three neighbours are all frozen inside a problem, and
    a problem with every row invalid (delta 0, no step)."""
    T = lin["T"]
    p = T["p"]
    A, t, _ = _system(T, 0.5, 0.0)
    row = int(torch.nonzero(p.valid)[0, 0])
    one = p._replace(**{k: getattr(p, k)[row:row + 1] for k in
                        ("valid", "idx_xyz", "nbr_dir")},
                     nbr_idx=torch.full((1, 3), -1, dtype=torch.int64),
                     lap_idx=torch.full((1, 6), -1, dtype=torch.int64))
    st1 = distcg.stencil_reverse(one)
    steps = []
    d = distcg.dist_cg(A[row:row + 1], t[row:row + 1], one.valid, st1, None,
                       reg_weight_l=0.0, damping=1.0, cg_iters=100, cg_tol=1e-6,
                       cg_static=False, steps_out=steps)
    want = float(t[row, 0]) / (2.0 * float(A[row, 0]))      # (1 + damping) a_00
    assert int(steps[0]) == 1
    np.testing.assert_allclose(float(d[0]), want, rtol=1e-5)
    # a row cut from its neighbours: its column only holds its own A_00
    cut = p._replace(nbr_idx=p.nbr_idx.clone())
    cut.nbr_idx[row] = -1
    stc = distcg.stencil_reverse(cut)
    assert not bool((stc.rev == row).any())
    dc = distcg.dist_cg(A, t, p.valid, stc, None, reg_weight_l=0.0, damping=1.0,
                        cg_iters=100, cg_tol=1e-6, cg_static=True)
    assert bool(torch.isfinite(dc).all()) and float(dc.abs().max()) > 0
    none = torch.zeros_like(p.valid)
    for static in (False, True):
        steps = []
        d0 = distcg.dist_cg(A, t, none, T["stencil"], None, reg_weight_l=0.0,
                            damping=1.0, cg_iters=100, cg_tol=1e-6,
                            cg_static=static, steps_out=steps)
        assert int(steps[0]) == 0 and not bool(d0.any())


@pytest.mark.parametrize("static", [False, True], ids=["scipy", "static"])
def test_pcg_plain_is_cg_chunks_on_a_dense_system(static):
    """The plain PCG loop that dist_cg_plain and albedo_cg_plain share
    (distcg.pcg_plain) on a dense SPD system: solvers.cg's steps (scipy's
    rule) and solvers.cg / pcg_fixed's iterate within 1e-6 of its largest
    entry, the solution within 1e-4 of a float64 solve."""
    rng = np.random.default_rng(7)
    n = 24
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    b = rng.standard_normal(n)
    At, bt = torch.tensor(A, dtype=torch.float32), torch.tensor(b, dtype=torch.float32)
    d = torch.diagonal(At).clone()
    matvec = lambda p: At @ p
    steps = []
    x = distcg.pcg_plain(matvec, bt, d, cg_iters=100, cg_tol=1e-4, cg_static=static,
                         steps_out=steps)
    if static:
        ref = tsolvers.pcg_fixed(matvec, bt, lambda v: v / d, 100, 1e-4)
    else:
        ref_steps = []
        ref = tsolvers.cg(matvec, bt, lambda v: v / d, 100, 1e-4, steps_out=ref_steps)
        assert int(steps[0]) == int(ref_steps[0]) > 1
    want = np.linalg.solve(A, b)
    np.testing.assert_allclose(x.numpy(), ref.numpy(), rtol=0,
                               atol=1e-6 * float(ref.abs().max()))
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


# ------------------------------------------------------------ the refiner


def test_refiner_rebuilds_the_table_with_every_problem(tmp_path):
    """init builds the table, the upsample rebuilds it for the new problem,
    a checkpoint loads without it (the file is the JAX package's format)
    and the loader rebuilds it; the distance block uses the refiner's."""
    sc = ht.refine_scene(model="SH1", order=1, n_poses=2, dim=24, h=0.05, H=40,
                         W=40, f=38.0)
    cfg = OptimizerConfig(max_it=7, conv_threshold=1e-12, damping=1.0, lam=0.2,
                          reg_weight_n=1.0, reg_weight_l=0.0, reg_weight_rho=0.0,
                          order=1, model="SH1", loss=robust.CAUCHY, upsample=True)
    ref = PhotometricRefiner(sc["tvol"], sc["tg"], cfg, np.array(sc["K"]),
                             truncation=sc["truncation"],
                             metrics=MetricsLogger(None, echo=False))
    ref.set_keyframes(sc["images"], sc["poses"], sc["frame_ids"])
    ref.init()
    first = ref.stencil
    assert first.source is ref.prob.nbr_idx
    _check_reverse(ref.prob, first)
    ref.init_albedo()
    ref._upsample()
    assert ref.stencil is not first and ref.stencil.source is ref.prob.nbr_idx
    assert ref.stencil.rev.shape[0] == ref.prob.valid.shape[0] > first.rev.shape[0]
    _check_reverse(ref.prob, ref.stencil)
    path = str(tmp_path / "refine_checkpoint.npz")
    ckpt.save_refine_state(path, ref)
    loaded = PhotometricRefiner(None, None, cfg, np.array(sc["K"]),
                                truncation=sc["truncation"], device="cpu",
                                metrics=MetricsLogger(None, echo=False))
    ckpt.load_refine_state(path, loaded)
    assert loaded.stencil.source is loaded.prob.nbr_idx
    for name in ("nbr", "rev", "lap"):
        assert torch.equal(getattr(loaded.stencil, name), getattr(ref.stencil, name))
    # one iteration of the loaded refiner and of the saved one, each on its table
    from psgradientsdf_tpu_torch.refine.optimizer import _iteration_core

    kw = dict(model="SH1", order=1, loss=robust.CAUCHY, lam=0.2,
              voxel_size=loaded.geom.voxel_size, reg_weight_n=1.0,
              reg_weight_l=0.5, reg_weight_rho=0.0, damping=1.0,
              laplacian_diag_only=False, do_light=False, do_albedo=False,
              do_distance=True, do_pose=False, joint_dp=False)
    with_table = _iteration_core(*loaded._args(), **kw, stencil=loaded.stencil)
    saved = _iteration_core(*ref._args(), **kw, stencil=ref.stencil)
    assert torch.equal(with_table[0], saved[0])
