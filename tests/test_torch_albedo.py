"""The albedo block's solve (ops/albedo.py): the system formed per pair and
row against the JAX package's Jacobians, einsums and regularizer and
against the port's eager chain, the CG and its accept rule against the JAX
package's solve_albedo / update_albedo and the scatter-add CG's steps under
both stop rules, albedo_block and the whole new _albedo_core against the
JAX package's, the edges (no valid row, one row, a row with every frame
masked, a row cut from its neighbours, candidates at 0 and 1), the launch
plan's tiles, the wrapper's CPU path and its refusal to fall back off the
CPU.  The stage plan is tests/test_torch_albedo_block.py's; the kernel is
held against the plain versions on the card by chip_smoke.py (phase
albedo_kernels)."""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import helpers_torch as ht
from psgradientsdf_tpu.refine import geometry as jgeometry
from psgradientsdf_tpu.refine import jacobians as jjac
from psgradientsdf_tpu.refine import optimizer as joptimizer
from psgradientsdf_tpu.refine import problem as jproblem
from psgradientsdf_tpu.refine import render as jrender
from psgradientsdf_tpu.refine import solvers as jsolvers
from psgradientsdf_tpu.utils import robust
from psgradientsdf_tpu_torch import kernels
from psgradientsdf_tpu_torch.config import LED
from psgradientsdf_tpu_torch.ops import albedo as AL
from psgradientsdf_tpu_torch.ops import distcg
from psgradientsdf_tpu_torch.refine import jacobians as tjac
from psgradientsdf_tpu_torch.refine import optimizer as toptimizer
from psgradientsdf_tpu_torch.refine import problem as tproblem
from psgradientsdf_tpu_torch.refine import render as trender
from psgradientsdf_tpu_torch.refine import solvers as tsolvers

H_VOX = 0.04
DAMPING = 1.0
RHOS = [0.0, 0.05]


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", params=[("SH1", 1), ("SH2", 2), ("LED", 1)],
                ids=["SH1", "SH2", "LED"])
def lin(request):
    """An albedo block's linearization point on both sides: the problem, the
    residual pass, the JAX package's J_rho, at a perturbed state."""
    torch.set_num_threads(1)
    name, order = request.param
    model = LED if name == "LED" else "SH"
    sc = ht.refine_scene(model=name, order=order, n_poses=2, dim=32, h=H_VOX,
                         H=48, W=48, f=45.0)
    jp = jproblem.extract_problem(sc["jvol"], sc["jg"], sc["frame_ids"])
    tp = tproblem.extract_problem(sc["tvol"], sc["tg"], sc["frame_ids"])
    rng = np.random.default_rng(7)
    valid = np.asarray(jp.valid)
    dist = (np.asarray(jp.dist) + valid * rng.normal(0, 0.1 * H_VOX, valid.shape)
            ).astype(np.float32)
    albedo = np.clip(np.abs(np.asarray(jp.albedo)) * 1.1 + 0.05, 0.05, 0.95).astype(np.float32)
    albedo = (albedo + valid[:, None] * rng.normal(0, 0.05, albedo.shape)).astype(np.float32)
    if name == "LED":
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
    for S, rmod in ((J, jrender), (T, trender)):
        S["rd"] = rmod.compute_residuals(
            S["p"], S["g"], S["dist"], S["albedo"], S["grad"], S["poses"], S["images"],
            S["K"], S["lights"], **kw)
    if model == LED:
        J["Jrho"] = jjac.albedo_jacobian_led(jp, sc["jg"], J["dist"], J["grad"], J["poses"],
                                             J["lights"])
    else:
        J["Jrho"] = jjac.albedo_jacobian_sh(jp, J["grad"], J["lights"], order)
    T["st"] = distcg.stencil_reverse(tp)
    return dict(J=J, T=T, model=model, order=order, kw=kw)


def _close(t, j, rel):
    """Within `rel` of the reference's largest magnitude."""
    t, j = ht.t2n(t), np.asarray(j)
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-20)
    err = float(np.abs(t - j).max())
    assert err <= rel * scale, (err, scale)


def _system(lin, rho, prob=None, rd=None, st=None):
    T = lin["T"]
    prob = T["p"] if prob is None else prob
    return AL.albedo_system_plain(
        prob, T["rd"] if rd is None else rd, T["albedo"], T["grad"], T["lights"], T["poses"],
        T["st"] if st is None else st, model=lin["model"], order=lin["order"],
        voxel_size=H_VOX, reg_weight_rho=rho)


def _cg_kw(rho, static=False):
    return dict(reg_weight_rho=rho, damping=DAMPING, cg_iters=100, cg_tol=1e-6,
                cg_static=static)


def _jax_system(lin, rho):
    """(b, diag_ps, diag) as refine/solvers.py solve_albedo forms them
    (:437-478), b not yet masked."""
    J, p = lin["J"], lin["J"]["p"]
    Jr = J["Jrho"]
    Jm = Jr[..., None] * jnp.ones((1, 1, 3), dtype=Jr.dtype) if Jr.ndim == 2 else Jr
    w = J["rd"].w
    b = jnp.einsum("nfc,nfc->nc", Jm, w * J["rd"].r)
    diag_ps = jnp.einsum("nfc,nfc->nc", Jm * Jm, w)
    diag = diag_ps
    if rho != 0.0:
        ag = jgeometry.fd_albedo_grad(p, J["albedo"], H_VOX)
        norms = jnp.linalg.norm(ag, axis=1)
        r_reg = jnp.where(p.valid[:, None], norms, 0.0)
        inv_h = 1.0 / H_VOX
        scale = jnp.where(norms != 0.0, 1.0 / jnp.maximum(norms, 1e-12), 1.0)
        J0r = jnp.einsum("nac,na->nc", ag, -inv_h * p.nbr_dir) * scale
        Jir = ag * (p.nbr_dir * inv_h)[..., None] * scale[:, None, :]
        J0r = jnp.where(p.valid[:, None], J0r, 0.0)
        Jir = jnp.where(p.valid[:, None, None], Jir, 0.0)
        bt, dreg = J0r * r_reg, J0r * J0r
        for ax in range(3):
            ok = (p.nbr_idx[:, ax] >= 0)[:, None]
            at = jnp.maximum(p.nbr_idx[:, ax], 0)
            bt = bt.at[at].add(jnp.where(ok, Jir[:, ax] * r_reg, 0.0))
            dreg = dreg.at[at].add(jnp.where(ok, Jir[:, ax] ** 2, 0.0))
        b = b + rho * bt
        diag = diag + rho * dreg
    return b, diag_ps, diag


def _eager_solve(lin, rho, static, prob=None, rd=None):
    """The albedo solve of the port's eager operators (albedo_data_terms,
    albedo_reg_*, index_add_ transposes) through solvers.cg_chunks ->
    (delta, steps or None)."""
    T = lin["T"]
    prob = T["p"] if prob is None else prob
    rd = T["rd"] if rd is None else rd
    if lin["model"] == LED:
        Jr = tjac.albedo_jacobian_led(prob, T["g"], T["dist"], T["grad"], T["poses"],
                                      T["lights"])
    else:
        Jr = tjac.albedo_jacobian_sh(prob, T["grad"], T["lights"], lin["order"])
    valid_c = prob.valid[:, None]
    b, diag_ps = tsolvers.albedo_data_terms(rd, Jr)
    diag = diag_ps
    if rho:
        reg = tsolvers.albedo_reg_operator(prob, T["albedo"], H_VOX)
        b = b + rho * tsolvers.albedo_reg_apply_T(reg.r, reg)
        diag = diag + rho * tsolvers.albedo_reg_diag(reg)

    def matvec(x):
        out = diag_ps * x
        if rho:
            out = out + rho * tsolvers.albedo_reg_apply_T(tsolvers.albedo_reg_apply(x, reg), reg)
        out = out + DAMPING * diag * x
        return torch.where(valid_c, out, x)

    d_safe = tsolvers.jacobi_diag(valid_c, diag, DAMPING)
    steps = []
    delta = tsolvers._solve_cg(matvec, torch.where(valid_c, b, 0.0), d_safe, 100, 1e-6,
                               static, steps)
    return torch.where(valid_c, delta, 0.0), (int(steps[0]) if steps else None)


# ------------------------------------------------------------------ system


@pytest.mark.parametrize("rho", RHOS)
def test_system_matches_jax(lin, rho):
    """b, diag_ps and diag of the plain version against the JAX package's
    J_rho, einsums and regularizer (.at[].add scatters), within 1e-5 of
    each tensor's largest magnitude (another order of addition; LED: J_rho
    from the residual pass's p_cam)."""
    sys = _system(lin, rho)
    jb, jdp, jd = _jax_system(lin, rho)
    _close(sys.b, jb, 1e-5)
    _close(sys.diag_ps, jdp, 1e-5)
    _close(sys.diag, jd, 1e-5)
    assert float(sys.b.abs().max()) > 0.0 and float(sys.diag_ps.max()) > 0.0
    if rho == 0.0:
        assert sys.diag is sys.diag_ps and sys.J0r is None and sys.Jir is None
    else:
        assert sys.J0r.shape == (sys.b.shape[0], 3) and sys.Jir.shape == (sys.b.shape[0], 3, 3)


@pytest.mark.parametrize("rho", RHOS)
def test_system_matches_the_eager_chain(lin, rho):
    """The same terms from the port's eager operators (albedo_data_terms,
    albedo_reg_operator, index_add_ transposes), and the regularizer's rows
    against albedo_reg_operator's."""
    T = lin["T"]
    prob = T["p"]
    sys = _system(lin, rho)
    if lin["model"] == LED:
        Jr = tjac.albedo_jacobian_led(prob, T["g"], T["dist"], T["grad"], T["poses"],
                                      T["lights"])
    else:
        Jr = tjac.albedo_jacobian_sh(prob, T["grad"], T["lights"], lin["order"])
    b, diag = tsolvers.albedo_data_terms(T["rd"], Jr)
    if rho:
        reg = tsolvers.albedo_reg_operator(prob, T["albedo"], H_VOX)
        _close(sys.r_reg, ht.t2n(reg.r), 1e-6)
        _close(sys.J0r, ht.t2n(reg.J0), 1e-6)
        _close(sys.Jir, ht.t2n(reg.Ji), 1e-6)
        b = b + rho * tsolvers.albedo_reg_apply_T(reg.r, reg)
        diag = diag + rho * tsolvers.albedo_reg_diag(reg)
    _close(sys.b, ht.t2n(b), 1e-5)
    _close(sys.diag, ht.t2n(diag), 1e-5)


def test_pair_jacobian_matches_jax(lin):
    """J_rho of every pair (the kernel's operations) against the JAX
    package's albedo_jacobian_sh / _led, within 1e-6 of max|J|."""
    T = lin["T"]
    J = AL.pair_jacobian(T["rd"], T["grad"], T["lights"], T["poses"], model=lin["model"],
                         order=lin["order"])
    want = np.asarray(lin["J"]["Jrho"])
    if want.ndim == 2:
        want = np.repeat(want[..., None], 3, axis=-1)
    _close(J, want, 1e-6)


def test_system_sums_in_the_lane_order():
    """The plain version adds a row's frames as the kernel's group of lanes
    does: frame f in lane f % GROUP, each lane's frames in order, the lanes
    pairwise; with F = 70 (a partial last turn) it equals that order
    written out in float32 bit for bit, and a torch.sum of the same terms
    to 1e-6."""
    rng = np.random.default_rng(3)
    N, F = 5, 70
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    from psgradientsdf_tpu_torch.refine.render import ResidualData

    w = torch.from_numpy(rng.uniform(0, 1, (N, F, 3)).astype(np.float32))
    rd = ResidualData(r=t(N, F, 3), w=w, mask=torch.ones(N, F, dtype=torch.bool),
                      p_cam=t(N, F, 3), uv=t(N, F, 2), g_img=t(N, F, 3, 2))
    grad, lights = t(N, 3), t(F, 4)
    prob = type("P", (), {})()
    sys = AL.albedo_system_plain(prob, rd, None, grad, lights, None, None, model="SH",
                                 order=1, voxel_size=H_VOX, reg_weight_rho=0.0)
    J = AL.pair_jacobian(rd, grad, lights, None, model="SH", order=1)
    terms = (J * (rd.w * rd.r)).numpy()
    G = AL.GROUP
    assert G == 8 and F % G != 0
    for n in range(N):
        lanes = np.zeros((G, 3), np.float32)
        for f in range(F):
            lanes[f % G] = lanes[f % G] + terms[n, f]
        s = G // 2
        while s >= 1:
            lanes[:s] = lanes[:s] + lanes[s:2 * s]
            s //= 2
        assert np.array_equal(lanes[0], sys.b[n].numpy())
    _close(sys.b, torch.sum(J * (rd.w * rd.r), dim=1), 1e-6)


# ---------------------------------------------------------------------- CG


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("rho", RHOS)
def test_cg_matches_jax_and_the_eager_steps(lin, rho, static):
    """albedo_cg_plain's delta against the JAX package's solve_albedo within
    2e-4 of max|delta| (the tolerance of test_solve_and_update_albedo), its
    steps equal to cg_chunks' on the eager operators (scipy's rule), its new
    albedo equal to update_albedo on its own delta, on both packages, bit
    for bit."""
    J, T = lin["J"], lin["T"]
    sys = _system(lin, rho)
    steps, trace = [], []
    delta, new = AL.albedo_cg_plain(sys, T["p"].valid, T["albedo"], T["st"],
                                    **_cg_kw(rho, static), steps_out=steps, trace=trace)
    ja = jsolvers.solve_albedo(J["p"], J["rd"], J["Jrho"], J["albedo"], H_VOX,
                               reg_weight_rho=rho, damping=DAMPING, cg_static=static)
    assert float(delta.abs().max()) > 1e-3
    _close(delta, ja, 2e-4)
    k = int(steps[0])
    assert len(trace) == k + (k < 100)
    eager, eager_steps = _eager_solve(lin, rho, static)
    _close(delta, ht.t2n(eager), 2e-4)
    if not static:
        assert k == eager_steps
    if rho == 0.0:
        assert k == 1                       # a diagonal system: one step
    else:
        assert k > 3
    assert torch.equal(new, tsolvers.update_albedo(T["p"], T["albedo"], delta))
    jn = jsolvers.update_albedo(J["p"], J["albedo"], jnp.asarray(ht.t2n(delta)))
    np.testing.assert_array_equal(ht.t2n(new), np.asarray(jn))
    assert not torch.equal(new, T["albedo"])


@pytest.mark.parametrize("rho", RHOS)
def test_albedo_core_matches_jax(lin, rho):
    """The refiner's new albedo block (optimizer._albedo_core: no J_rho
    tensor, the problem's stencil table) against the JAX package's
    _albedo_core: the new albedo within 2e-4 of max|delta| of the JAX
    package's, the same accept decision on every voxel-channel, and equal
    to update_albedo on solve_albedo's own delta bit for bit."""
    J, T = lin["J"], lin["T"]
    kw = dict(lin["kw"], reg_weight_rho=rho, damping=DAMPING)
    targs = (T["p"], T["g"], T["rd"], T["dist"], T["albedo"], T["grad"], T["poses"], T["K"],
             T["lights"])
    jargs = (J["p"], J["g"], J["rd"], J["dist"], J["albedo"], J["grad"], J["poses"], J["K"],
             J["lights"])
    steps = []
    tn = toptimizer._albedo_core(*targs, **kw, stencil=T["st"], steps_out=steps)
    jn = joptimizer._albedo_core(*jargs, **kw)
    delta, again = tsolvers.solve_albedo(T["p"], T["rd"], T["albedo"], T["grad"], T["lights"],
                                         T["poses"], H_VOX, model=lin["model"],
                                         order=lin["order"], reg_weight_rho=rho,
                                         damping=DAMPING, stencil=T["st"])
    assert torch.equal(tn, again) and len(steps) == 1
    assert torch.equal(tn, tsolvers.update_albedo(T["p"], T["albedo"], delta))
    jn = np.asarray(jn)
    scale = float(delta.abs().max())
    assert float(np.abs(ht.t2n(tn) - jn).max()) <= 2e-4 * scale
    moved_t = ht.t2n(tn) != ht.t2n(T["albedo"])
    moved_j = jn != np.asarray(J["albedo"])
    np.testing.assert_array_equal(moved_t, moved_j)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("rho", RHOS)
def test_albedo_block_matches_jax(lin, rho, static):
    """albedo_block (the one launch's CPU path) against the JAX package:
    delta within 2e-4 of max|delta| of solve_albedo's under the same stop
    rule, the new albedo equal to the JAX package's update_albedo on that
    delta bit for bit, and (scipy's rule, the refiner's) within 2e-4 of
    max|delta| of _albedo_core's with the same accept decisions; one step
    and two grid barriers without the regularizer."""
    J, T = lin["J"], lin["T"]
    steps, bars = [], []
    delta, new = AL.albedo_block(T["p"], T["rd"], T["albedo"], T["grad"], T["lights"],
                                 T["poses"], T["st"], model=lin["model"], order=lin["order"],
                                 voxel_size=H_VOX, reg_weight_rho=rho, damping=DAMPING,
                                 cg_iters=100, cg_tol=1e-6, cg_static=static,
                                 steps_out=steps, barriers_out=bars)
    ja = jsolvers.solve_albedo(J["p"], J["rd"], J["Jrho"], J["albedo"], H_VOX,
                               reg_weight_rho=rho, damping=DAMPING, cg_static=static)
    scale = float(delta.abs().max())
    assert scale > 1e-3
    _close(delta, ja, 2e-4)
    jn = jsolvers.update_albedo(J["p"], J["albedo"], jnp.asarray(ht.t2n(delta)))
    np.testing.assert_array_equal(ht.t2n(new), np.asarray(jn))
    if rho == 0.0:
        assert int(steps[0]) == 1 and int(bars[0]) == 2
    else:
        assert int(steps[0]) > 3 and int(bars[0]) == 2 + 4 * int(steps[0])
    if not static:
        kw = dict(lin["kw"], reg_weight_rho=rho, damping=DAMPING)
        jcore = np.asarray(joptimizer._albedo_core(
            J["p"], J["g"], J["rd"], J["dist"], J["albedo"], J["grad"], J["poses"], J["K"],
            J["lights"], **kw))
        assert float(np.abs(ht.t2n(new) - jcore).max()) <= 2e-4 * scale
        np.testing.assert_array_equal(ht.t2n(new) != ht.t2n(T["albedo"]),
                                      jcore != np.asarray(J["albedo"]))


def test_the_regularizer_needs_the_problems_table(lin):
    T = lin["T"]
    args = (T["p"], T["rd"], T["albedo"], T["grad"], T["lights"], T["poses"], H_VOX)
    kw = dict(model=lin["model"], order=lin["order"], reg_weight_rho=0.05, damping=DAMPING)
    with pytest.raises(ValueError, match="stencil"):
        tsolvers.solve_albedo(*args, **kw)
    other = T["p"]._replace(nbr_idx=T["p"].nbr_idx.clone())
    with pytest.raises(ValueError, match="stencil"):
        tsolvers.solve_albedo(*args, **kw, stencil=distcg.stencil_reverse(other))
    # without the regularizer no table is read
    tsolvers.solve_albedo(*args, **dict(kw, reg_weight_rho=0.0))


def test_two_plain_runs_are_bit_identical(lin):
    sys = _system(lin, 0.05)
    T = lin["T"]
    a = AL.albedo_cg_plain(sys, T["p"].valid, T["albedo"], T["st"], **_cg_kw(0.05))
    b = AL.albedo_cg_plain(_system(lin, 0.05), T["p"].valid, T["albedo"], T["st"],
                           **_cg_kw(0.05))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------------------------- edges


@pytest.mark.parametrize("static", [False, True])
def test_no_valid_row(lin, static):
    """Every row invalid: b = 0, no step, delta 0, the albedo unchanged."""
    T = lin["T"]
    none = T["p"]._replace(valid=torch.zeros_like(T["p"].valid))
    for rho in RHOS:
        sys = _system(lin, rho, prob=none)
        steps = []
        delta, new = AL.albedo_cg_plain(sys, none.valid, T["albedo"], T["st"],
                                        **_cg_kw(rho, static), steps_out=steps)
        assert int(steps[0]) == 0
        assert not delta.any() and torch.equal(new, T["albedo"])


def _rows_alone(lin, rows):
    """Rows `rows` of the linearization point alone, every stencil link cut
    (their neighbours frozen) -> (prob, rd, stencil)."""
    p = lin["T"]["p"]
    cut = lambda t: torch.full_like(t[rows], -1)
    prob = p._replace(valid=p.valid[rows], idx_xyz=p.idx_xyz[rows],
                      nbr_idx=cut(p.nbr_idx), lap_idx=cut(p.lap_idx),
                      nbr_dir=p.nbr_dir[rows], nbr_albedo_const=p.nbr_albedo_const[rows])
    rd = type(lin["T"]["rd"])(*(t[rows].contiguous() for t in lin["T"]["rd"]))
    return prob, rd, distcg.stencil_reverse(prob)


@pytest.mark.parametrize("rho", RHOS)
def test_one_row(lin, rho):
    """One valid row alone: b, diag and delta against the eager chain, one
    step without the regularizer."""
    T = lin["T"]
    row = int(torch.nonzero(T["p"].valid)[len(torch.nonzero(T["p"].valid)) // 2, 0])
    rows = torch.tensor([row])
    prob, rd, st = _rows_alone(lin, rows)
    sub = dict(lin, T=dict(T, p=prob, rd=rd, st=st, albedo=T["albedo"][rows],
                           grad=T["grad"][rows], dist=T["dist"][rows]))
    sys = _system(sub, rho)
    steps = []
    delta, new = AL.albedo_cg_plain(sys, prob.valid, sub["T"]["albedo"], st, **_cg_kw(rho),
                                    steps_out=steps)
    eager, eager_steps = _eager_solve(sub, rho, False, prob=prob, rd=rd)
    assert int(steps[0]) == eager_steps
    if rho == 0.0:
        assert int(steps[0]) == 1
    _close(delta, ht.t2n(eager), 2e-4)
    assert torch.equal(new, tsolvers.update_albedo(prob, sub["T"]["albedo"], delta))


def test_a_row_with_every_frame_masked(lin):
    """A valid row whose pairs all have weight 0: its data terms are 0
    (diag 0, so the safe diagonal is 1); without the regularizer its delta
    is 0 and its albedo stays; the other rows' results do not move."""
    T = lin["T"]
    valid = torch.nonzero(T["p"].valid)[:, 0]
    row = int(valid[len(valid) // 3])
    w = T["rd"].w.clone()
    w[row] = 0.0
    rd = T["rd"]._replace(w=w)
    base = _system(lin, 0.0)
    sys = _system(lin, 0.0, rd=rd)
    assert not sys.b[row].any() and not sys.diag[row].any()
    keep = torch.ones(sys.b.shape[0], dtype=torch.bool)
    keep[row] = False
    assert torch.equal(sys.b[keep], base.b[keep]) and torch.equal(sys.diag[keep], base.diag[keep])
    delta, new = AL.albedo_cg_plain(sys, T["p"].valid, T["albedo"], T["st"], **_cg_kw(0.0))
    assert not delta[row].any() and torch.equal(new[row], T["albedo"][row])
    # under the regularizer the row is held by its neighbours alone
    sys = _system(lin, 0.05, rd=rd)
    delta, _ = AL.albedo_cg_plain(sys, T["p"].valid, T["albedo"], T["st"], **_cg_kw(0.05))
    eager, _ = _eager_solve(lin, 0.05, False, rd=rd)
    _close(delta, ht.t2n(eager), 2e-4)
    assert torch.isfinite(delta).all()


def test_a_row_cut_from_its_neighbours(lin):
    """A row whose three stencil neighbours are frozen (nbr_idx -1): it
    names no row, its regularizer reads the frozen albedo, and the system
    and the solve agree with the eager chain on the cut problem."""
    T = lin["T"]
    p = T["p"]
    valid = torch.nonzero(p.valid)[:, 0]
    row = int(valid[len(valid) // 2])
    nbr = p.nbr_idx.clone()
    nbr[row] = -1
    cut = p._replace(nbr_idx=nbr)
    st = distcg.stencil_reverse(cut)
    assert bool((st.nbr[row] == -1).all())
    sub = dict(lin, T=dict(T, p=cut, st=st))
    sys = _system(sub, 0.05)
    reg = tsolvers.albedo_reg_operator(cut, T["albedo"], H_VOX)
    _close(sys.J0r, ht.t2n(reg.J0), 1e-6)
    _close(sys.Jir, ht.t2n(reg.Ji), 1e-6)
    delta, _ = AL.albedo_cg_plain(sys, cut.valid, T["albedo"], st, **_cg_kw(0.05))
    eager, _ = _eager_solve(sub, 0.05, False, prob=cut)
    _close(delta, ht.t2n(eager), 2e-4)


@pytest.mark.parametrize("static", [False, True])
def test_candidates_at_zero_and_one(static):
    """A unit diagonal system whose CG step is b itself: candidates that
    land exactly on 0 and on 1 are refused, those strictly inside are kept,
    an invalid row never moves; the rule equals solvers.update_albedo and
    the JAX package's update_albedo on the same delta bit for bit."""
    N = 6
    b = torch.tensor([[0.25, -0.25, 0.125], [0.5, 0.5, 0.0], [0.75, -0.25, 0.5],
                      [-0.5, 0.25, 0.25], [0.125, 0.125, 0.125], [0.25, 0.25, 0.25]])
    albedo = torch.tensor([[0.25, 0.75, 0.5], [0.5, 0.75, 0.5], [0.75, 0.75, 0.625],
                           [0.5, 0.5, 0.25], [0.5, 0.5, 0.5], [0.5, 0.5, 0.5]])
    valid = torch.tensor([True, True, True, True, True, False])
    ones = torch.ones(N, 3)
    sys = AL.AlbedoSystem(b, ones, ones, None, None, None)
    steps = []
    delta, new = AL.albedo_cg_plain(sys, valid, albedo, None, reg_weight_rho=0.0,
                                    damping=0.0, cg_iters=100, cg_tol=1e-6,
                                    cg_static=static, steps_out=steps)
    assert int(steps[0]) == 1
    want = torch.where(valid[:, None], b, 0.0)
    assert torch.equal(delta, want)
    cand = albedo - delta
    assert bool((cand == 0.0).any()) and bool((cand == 1.0).any())
    kept = (cand > 0.0) & (cand < 1.0) & valid[:, None]
    assert torch.equal(new, torch.where(kept, cand, albedo))
    assert torch.equal(new[(cand == 0.0) | (cand == 1.0)], albedo[(cand == 0.0) | (cand == 1.0)])
    prob = type("P", (), {"valid": valid})()
    assert torch.equal(new, tsolvers.update_albedo(prob, albedo, delta))
    jprob = type("P", (), {"valid": jnp.asarray(valid.numpy())})()
    jn = jsolvers.update_albedo(jprob, jnp.asarray(albedo.numpy()), jnp.asarray(delta.numpy()))
    np.testing.assert_array_equal(new.numpy(), np.asarray(jn))


# -------------------------------------------------------------------- plan


@pytest.mark.parametrize("N", [1, 15, 16, 17, 132 * 16, 132 * 16 + 1, 49152, 4 * 49152,
                               "limit", "limit+1", 2_000_000])
def test_cg_plan_tiles_every_row_once(N):
    """The block's plan on 132 SMs at the main run's 40 keyframes:
    distcg._cg_plan's tiles over voxels, every voxel in one block's tile,
    the vectors in shared memory (after the warps' rings) up to
    shared_tile_limit rows a block and in device memory past it."""
    F = 40
    lim = AL.shared_tile_limit(F, led=False)
    if N == "limit":
        N = 132 * lim
    elif N == "limit+1":
        N = 132 * lim + 1
    plan = AL._albedo_plan(N, F, led=False, sms=132)
    tiles = distcg._cg_plan(N, use_lap=False, lap_nbr=False, sms=132)
    assert (plan.blocks, plan.tile) == (tiles.blocks, tiles.tile)
    assert plan.tile % 16 == 0 and plan.blocks <= 132
    assert (plan.blocks - 1) * plan.tile < N <= plan.blocks * plan.tile
    assert plan.shared == (plan.tile <= lim)
    rings = plan.ring + AL.WARPS * plan.depth * plan.stage_bytes
    assert plan.smem_bytes == rings + (96 * plan.tile if plan.shared else 0)
    assert plan.vec == (rings if plan.shared else 0)
    assert plan.smem_bytes <= distcg.SMEM_PER_BLOCK and plan.depth >= 1
    if N == 132 * lim:
        assert plan.shared and plan.tile == lim
    if N == 132 * lim + 1:
        assert not plan.shared and plan.depth == AL.DEPTH
    assert AL._work_floats(plan, N, True) == 21 * N + (0 if plan.shared else 24 * N)
    assert AL._work_floats(plan, N, False) == (0 if plan.shared else 24 * N)


# ---------------------------------------------------------------- wrappers


def test_wrappers_take_the_plain_path_on_the_cpu(lin):
    """On CPU tensors albedo_block is albedo_cg_plain on
    albedo_system_plain, bit for bit (system_out the plain system, the
    steps the plain ones, barriers_out the count the kernel would cross),
    and counts no launch."""
    T = lin["T"]
    AL.reset_launch_counts()
    for rho in RHOS:
        args = (T["p"], T["rd"], T["albedo"], T["grad"], T["lights"], T["poses"], T["st"])
        skw = dict(model=lin["model"], order=lin["order"], voxel_size=H_VOX,
                   reg_weight_rho=rho)
        want = AL.albedo_system_plain(*args, **skw)
        s1, s2, got, bars = [], [], [], []
        cg = {k: v for k, v in _cg_kw(rho).items() if k != "reg_weight_rho"}
        d1, n1 = AL.albedo_block(*args, **skw, **cg, steps_out=s1, system_out=got,
                                 barriers_out=bars)
        d2, n2 = AL.albedo_cg_plain(want, T["p"].valid, T["albedo"], T["st"], **_cg_kw(rho),
                                    steps_out=s2)
        for g, w in zip(got[0], want):
            assert (g is None and w is None) or torch.equal(g, w)
        assert torch.equal(d1, d2) and torch.equal(n1, n2) and int(s1[0]) == int(s2[0])
        assert int(bars[0]) == AL.grid_barriers(rho != 0.0, int(s1[0]))
    assert AL.launch_counts == {"albedo_block": 0}


def test_wrappers_raise_off_the_cpu_instead_of_falling_back(monkeypatch):
    """A tensor that does not lie on the CPU goes to the kernel: here (meta
    tensors, no card, no library) the launch raises; neither plain version
    runs and no launch is counted."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran for a tensor off the CPU")

    def no_library():
        raise RuntimeError("no kernel library here")

    monkeypatch.setattr(AL, "albedo_system_plain", refuse)
    monkeypatch.setattr(AL, "albedo_cg_plain", refuse)
    monkeypatch.setattr(AL, "_library", no_library)
    monkeypatch.setattr(AL, "block_plan", lambda dev, N, F, led, reg: AL._albedo_plan(
        N, F, led=led, sms=132))
    AL.reset_launch_counts()
    N, F = 40, 3
    m = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device="meta")
    from psgradientsdf_tpu_torch.refine.render import ResidualData

    rd = ResidualData(r=m(N, F, 3), w=m(N, F, 3), mask=m(N, F, dtype=torch.bool),
                      p_cam=m(N, F, 3), uv=m(N, F, 2), g_img=m(N, F, 3, 2))
    prob = type("P", (), {"valid": m(N, dtype=torch.bool)})()
    for model, lights in (("SH", m(F, 4)), (LED, m(3))):
        with pytest.raises((RuntimeError, ValueError)):
            AL.albedo_block(prob, rd, m(N, 3), m(N, 3), lights, m(F, 4, 4), None, model=model,
                            order=1, voxel_size=H_VOX, reg_weight_rho=0.0, damping=DAMPING,
                            cg_iters=100, cg_tol=1e-6, cg_static=False)
    assert AL.launch_counts == {"albedo_block": 0}


def test_the_library_name_covers_the_shared_header(tmp_path, monkeypatch):
    """A CUDA library's name hashes the csrc/*.cuh headers too: an edited
    header (csrc/cg_sync.cuh, shared by distcg.cu and albedo.cu;
    csrc/async_copy.cuh, the mbarrier and bulk-copy helpers of normaleq.cu
    and albedo.cu, defined there alone) rebuilds every CUDA library, a host
    library's name does not move."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "one.cu").write_text("// one\n")
    (src / "two.cpp").write_text("// two\n")
    (src / "sync.cuh").write_text("// a\n")
    monkeypatch.setattr(kernels, "CSRC_DIR", str(src))
    monkeypatch.setattr(kernels, "_compiler", lambda path: ("cc", ["-O3"]))
    monkeypatch.setattr(kernels, "_compiler_version", lambda c: b"1")
    cu, cpp = kernels.library_path("one"), kernels.library_path("two")
    (src / "sync.cuh").write_text("// b\n")
    assert kernels.library_path("one") != cu
    assert kernels.library_path("two") == cpp
    assert os.path.basename(kernels.cuda_headers()[0]) == "sync.cuh"
    real = os.path.join(os.path.dirname(kernels.__file__), "csrc")
    assert {"cg_sync.cuh", "async_copy.cuh"} <= set(os.listdir(real))
    for header, users in (("cg_sync.cuh", ("distcg.cu", "albedo.cu")),
                          ("async_copy.cuh", ("normaleq.cu", "albedo.cu"))):
        for name in users:
            with open(os.path.join(real, name)) as fh:
                src = fh.read()
            assert f'#include "{header}"' in src
            if header == "async_copy.cuh":
                assert "void mbar_init(" not in src and "void bulk_load(" not in src


@pytest.mark.parametrize("struct", ["BlockArgs", "BlockPlan"])
def test_c_argument_blocks_have_the_kernels_layout(struct):
    """ops/albedo.py's ctypes blocks name csrc/albedo.cu's struct fields in
    the same order, every field 8 bytes but BlockArgs' nested plan (a
    BlockPlan last): a field dropped or added on one side only would shift
    every field after it."""
    import ctypes
    import re

    with open(os.path.join(os.path.dirname(kernels.__file__), "csrc", "albedo.cu")) as fh:
        src = fh.read()
    body = re.search(r"^struct %s \{[^\n]*\n(.*?)^\};" % struct, src, re.S | re.M).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            first, *rest = decl.split(",")
            names += [re.split(r"[\s*]+", first)[-1]] + [n.strip() for n in rest]
    ours = getattr(AL, "_" + struct)
    assert [f[0] for f in ours._fields_] == names
    sizes = [ctypes.sizeof(t) for _, t in ours._fields_]
    if struct == "BlockArgs":
        assert ours._fields_[-1][1] is AL._BlockPlan and "BlockPlan plan;" in body
        sizes = sizes[:-1]
    else:
        assert names == list(AL.AlbedoPlan._fields)
    assert sizes == [8] * len(sizes)
    assert ctypes.sizeof(ours) == sum(ctypes.sizeof(t) for _, t in ours._fields_)
