"""The SH light block's clipped eigen-solve (ops/smallsolve.py): its plain
version against the JAX package's solve_light_sh and against numpy's
float64 pseudo-inverse, on H and g formed from seeded numpy inputs; the
kernel's round-robin Jacobi schedule (jacobi_rounds), and a numpy float64
emulation of the kernel's algorithm (csrc/smallsolve.cu) against numpy's
eigh clipped solve."""

import math

import mpmath
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psgradientsdf_tpu.refine import solvers as jsolvers
from psgradientsdf_tpu.utils import sh as jsh
from psgradientsdf_tpu_torch.ops import smallsolve
from psgradientsdf_tpu_torch.refine import solvers as tsolvers
from psgradientsdf_tpu_torch.refine.render import ResidualData

torch.set_num_threads(1)

N = 300
# test_torch_solvers.py's tolerances for the light block, of max|delta|
TOL = {1: 1e-3, 2: 2e-2}


class _JRd:
    """The JAX solve reads rd.w and rd.r only."""

    def __init__(self, w, r):
        self.w, self.r = jnp.asarray(w), jnp.asarray(r)


def _system(order, F, kind, seed):
    """(w, r [N,F,3], J_l [N,3,B]) of a light block: `kind` "flat" (every
    normal (0, 0, -1): the Gram matrix has rank 1), "full" (normals over
    the sphere) or "zero" (no counted pair: w = 0)."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        n = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (N, 1))
    else:
        n = rng.normal(size=(N, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
    albedo = rng.uniform(0.2, 0.9, (N, 3)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (N, F, 3)).astype(np.float32)
    w *= rng.uniform(size=(N, F, 1)) < 0.7
    if kind == "zero":
        w[:] = 0.0
    r = rng.normal(0, 0.05, (N, F, 3)).astype(np.float32)
    basis = np.asarray(jsh.sh_basis(jnp.asarray(n), order))
    J_l = (-albedo[..., None] * basis[:, None, :]).astype(np.float32)
    return w, r, J_l


def _normal_eqs(w, r, J_l):
    z = torch.zeros(1)
    rd = ResidualData(r=torch.from_numpy(r), w=torch.from_numpy(w), mask=z, p_cam=z,
                      uv=z, g_img=z)
    return tsolvers.light_normal_eqs_sh(rd, torch.from_numpy(J_l))


@pytest.mark.parametrize("kind", ["flat", "full"])
@pytest.mark.parametrize("F", [1, 8, 40])
@pytest.mark.parametrize("order", [1, 2])
def test_plain_solve_matches_jax(order, F, kind):
    w, r, J_l = _system(order, F, kind, seed=10 * F + order)
    H, g = _normal_eqs(w, r, J_l)
    got = smallsolve.light_solve(H, g).numpy()
    want = np.asarray(jsolvers.solve_light_sh(_JRd(w, r), jnp.asarray(J_l)))
    assert got.shape == want.shape == (F, 4 if order == 1 else 9)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL[order] * scale


@pytest.mark.parametrize("order", [1, 2])
def test_all_zero_system_gives_zero_step(order):
    w, r, J_l = _system(order, 8, "zero", seed=order)
    H, g = _normal_eqs(w, r, J_l)
    assert not H.any() and not g.any()
    got = smallsolve.light_solve(H, g)
    want = np.asarray(jsolvers.solve_light_sh(_JRd(w, r), jnp.asarray(J_l)))
    assert torch.equal(got, torch.zeros_like(got))
    np.testing.assert_array_equal(want, np.zeros_like(want))


@pytest.mark.parametrize("F", [1, 8, 40])
@pytest.mark.parametrize("order", [1, 2])
def test_plain_solve_is_the_float64_pseudo_inverse(order, F):
    """Well-conditioned (normals over the sphere): the arithmetic in
    float64 within 1e-9 of max|delta| of numpy's pinv(rcond=1e-6,
    hermitian=True); the float32 step within float32 rounding of it."""
    w, r, J_l = _system(order, F, "full", seed=100 + 10 * F + order)
    H, g = _normal_eqs(w, r, J_l)
    H64, g64 = H.double().numpy(), g.double().numpy()
    assert max(np.linalg.cond(h) for h in H64) < 1e3
    want = np.stack([np.linalg.pinv(h, rcond=1e-6, hermitian=True) @ v
                     for h, v in zip(H64, g64)])
    scale = np.abs(want).max()
    got64 = smallsolve.light_solve_plain(H.double(), g.double()).numpy()
    assert got64.dtype == np.float64
    assert np.abs(got64 - want).max() <= 1e-9 * scale
    got32 = smallsolve.light_solve(H, g).numpy()
    assert np.abs(got32 - want).max() <= 1e-6 * scale


def test_clip_drops_the_directions_at_and_below_it():
    """An eigenvalue at half the clip is dropped, one at twice it kept."""
    rng = np.random.default_rng(7)
    Q, _ = np.linalg.qr(rng.normal(size=(4, 4)))
    lam = np.array([1.0, 0.3, 2e-6, 0.5e-6])
    H = torch.from_numpy((Q * lam) @ Q.T).float()[None]
    g = torch.from_numpy(rng.normal(size=(1, 4))).float()
    Hd = H[0].double().numpy()
    vals, vecs = np.linalg.eigh(Hd)
    inv = np.where(vals > 1e-6 * vals.max(), 1.0 / vals, 0.0)
    assert (inv == 0).sum() == 1
    want = vecs @ (inv * (vecs.T @ g[0].double().numpy()))
    got = smallsolve.light_solve(H, g)[0].double().numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_light_block_goes_through_the_wrapper(monkeypatch):
    """solvers.solve_light_from_normal_eqs (the SH light block's solve, the
    one card's and the mesh's) is ops/smallsolve.light_solve; on the CPU
    the wrapper is its plain version, bit for bit, and launches nothing."""
    w, r, J_l = _system(2, 8, "full", seed=3)
    H, g = _normal_eqs(w, r, J_l)
    seen = []
    real = smallsolve.light_solve
    monkeypatch.setattr(smallsolve, "light_solve",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    before = dict(smallsolve.launch_counts)
    got = tsolvers.solve_light_from_normal_eqs(H, g)
    assert seen == [1]
    assert torch.equal(got, smallsolve.light_solve_plain(H, g))
    assert smallsolve.launch_counts == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        smallsolve.light_solve(torch.zeros(2, 4, 3), torch.zeros(2, 4))
    with pytest.raises(ValueError):
        smallsolve.light_solve(torch.zeros(2, 10, 10), torch.zeros(2, 10))
    with pytest.raises(ValueError):
        smallsolve.light_solve(torch.zeros(2, 4, 4), torch.zeros(3, 4))


# ---------------------------------------------------------------------------
# the kernel's schedule and algorithm (csrc/smallsolve.cu), emulated
# ---------------------------------------------------------------------------

K_MAX_SWEEPS = 32          # csrc/smallsolve.cu kMaxSweeps
EPS = np.finfo(np.float64).eps
# the emulation's step within this of max|delta| of the float64 clipped solve
EMU_TOL = 1e-10


@pytest.mark.parametrize("B", range(1, 10))
def test_jacobi_rounds_hold_every_pair_once_in_disjoint_rounds(B):
    """B padded to an even n: n - 1 rounds of B // 2 disjoint real pairs,
    every pair (p, q), p < q < B, once a sweep."""
    rounds = smallsolve.jacobi_rounds(B)
    n = B + B % 2
    assert len(rounds) == n - 1
    seen = []
    for pairs in rounds:
        assert len(pairs) == B // 2
        flat = [k for pq in pairs for k in pq]
        assert len(set(flat)) == len(flat)
        assert all(0 <= p < q < B for p, q in pairs)
        seen += pairs
    assert sorted(seen) == [(p, q) for p in range(B) for q in range(p + 1, B)]


@pytest.mark.parametrize("B", range(1, 10))
def test_jacobi_plan_lays_out_every_entry_once(B):
    """The kernel's plan: every entry of the packed upper triangle held by
    one lane and every entry of V by one lane's rows; round r's pair lanes
    are jacobi_rounds(B)[r] in order, each index's rotation lane and p-bit
    point at its pair, and the partner offsets are its pair's."""
    plan = smallsolve.jacobi_plan(B)
    rounds = smallsolve.jacobi_rounds(B)
    pk = lambda x, y: smallsolve.packed_index(B, x, y)
    assert plan.shape == (len(rounds) + 1, smallsolve.LANES, 4)
    tri, vee = [], []
    for lane in range(smallsolve.LANES):
        i, j0, j1, vr, vc = smallsolve.lane_entries(B, lane)
        tri += [(i, j) for j in (j0, j1) if i is not None and j is not None]
        if vr is not None:
            L = smallsolve.LANES // B
            vee += [(vr + L * k, vc) for k in range(smallsolve.V_ROWS_PER_LANE)
                    if vr + L * k < B]
    assert sorted(tri) == [(i, j) for i in range(B) for j in range(i, B)]
    assert sorted(vee) == [(i, j) for i in range(B) for j in range(B)]
    assert sorted(pk(i, j) for i, j in tri) == list(range(B * (B + 1) // 2))
    for r, pairs in enumerate(rounds, start=1):
        partner = list(range(B))
        for p, q in pairs:
            partner[p], partner[q] = q, p
        for lane, (p, q) in enumerate(pairs):
            w = int(plan[r, lane, 3])
            assert w >> 24 == 1
            assert [w >> 8 * k & 0xFF for k in range(3)] == [pk(p, p), pk(q, q), pk(p, q)]
        for lane in range(smallsolve.LANES):
            i, j0, j1, vr, vc = smallsolve.lane_entries(B, lane)
            if i is None:
                continue
            z = int(plan[r, lane, 2])
            for k, x in enumerate((i, j0, j1 if j1 is not None else i, vc)):
                code = z >> 4 * k & 0xF
                if partner[x] != x:
                    assert sorted(pairs[code & 7]) == sorted((x, partner[x]))
                    assert code >> 3 == (x < partner[x])
                else:
                    assert int(plan[r, code & 7, 3]) >> 24 == 2
            for k, j in enumerate((j0, j1)):
                if j is None:
                    continue
                t = int(plan[r, lane, k])
                pi, pj = partner[i], partner[j]
                assert [t >> 8 * b & 0xFF for b in range(4)] == [
                    pk(i, pj), pk(pi, j), pk(pi, pj), int(i != j and pi == j)]


def _negligible(apq, app, aqq):
    """csrc/smallsolve.cu negligible(), elementwise."""
    e = np.abs(apq)
    return (np.abs(app) + e == np.abs(app)) & (np.abs(aqq) + e == np.abs(aqq))


def _emulate(H, g):
    """csrc/smallsolve.cu for one keyframe, lane by lane, in numpy float64:
    H [B,B] (its lower triangle read), g [B] -> (delta [B], rotations,
    rounds that rotated, sweeps begun, the final packed triangle).  The
    lanes read the plan of ops/smallsolve.jacobi_plan; a shuffle is an
    index into the lanes' registers.  Each sweep starts with the test of
    every off-diagonal entry; a round is the pair lanes' rule and rotation
    (c = w rr, s = sgn |e| rr, t = 2 h rr s; c = 1, s = t = 0 for a pair
    that does not rotate), then every lane's entries of J^T A J and V J."""
    B = g.shape[0]
    plan = smallsolve.jacobi_plan(B).astype(np.int64)
    lanes = np.arange(smallsolve.LANES)
    head = plan[0]
    byte = lambda w, k: w >> 8 * k & 0xFF
    own = [byte(head[:, 0], 0), byte(head[:, 0], 1)]
    ti, tj = byte(head[:, 0], 2), [byte(head[:, 0], 3), byte(head[:, 1], 0)]
    vr, vc, L = byte(head[:, 1], 1), byte(head[:, 1], 2), byte(head[:, 1], 3)
    none = smallsolve.NONE
    A = np.zeros(B * (B + 1) // 2)
    aij = np.zeros((smallsolve.LANES, 2))
    for k in range(2):
        ok = own[k] != none
        aij[ok, k] = H[tj[k][ok], ti[ok]]
        A[own[k][ok]] = aij[ok, k]
    v = np.stack([(vr != none) & (vr + L * k == vc)
                  for k in range(smallsolve.V_ROWS_PER_LANE)], 1).astype(np.float64)
    rotations = rounds = sweeps = 0
    for _ in range(K_MAX_SWEEPS):
        live = False
        for k in range(2):
            off = (own[k] != none) & (tj[k] != ti)
            dii, djj = (np.where(off, byte(head[:, 2], b), 0) for b in (0, k + 1))
            live |= (off & ~_negligible(aij[:, k], A[dii], A[djj])).any()
        if not live:
            for k in range(2):
                aij[tj[k] != ti, k] = 0.0
            break
        sweeps += 1
        for row in plan[1:]:
            x_, y_, z, w = row.T
            kind = w >> 24
            app, aqq, apq = (A[byte(w, k)] for k in range(3))
            rot = (kind == 1) & ~_negligible(apq, app, aqq)
            c, s, d = np.ones(smallsolve.LANES), np.zeros(smallsolve.LANES), np.zeros(
                smallsolve.LANES)
            for ln in np.flatnonzero(rot):
                dd, e = aqq[ln] - app[ln], 2.0 * apq[ln]
                if max(abs(dd), abs(e)) < 2.0 ** -450:
                    dd, e = dd * 2.0 ** 500, e * 2.0 ** 500
                h = math.sqrt(dd * dd + e * e)
                wv = abs(dd) + h
                rr = 1.0 / math.sqrt(2.0 * h * wv)
                s[ln] = -abs(e) * rr if (dd < 0.0) != (e < 0.0) and dd != 0.0 else abs(e) * rr
                c[ln] = wv * rr
                d[ln] = (2.0 * h * rr) * s[ln] * apq[ln]
            rotations += int(rot.sum())
            rounds += int(rot.any())

            def coef(code):
                sl = code & 7
                return c[sl], np.where(code & 8, -s[sl], s[sl])

            ai, bi = coef(z)
            shift = np.where(z & 8, -d[z & 7], d[z & 7])
            x = np.empty_like(aij)
            for k, t in enumerate((x_, y_)):
                aj, bj = coef(z >> 4 * (k + 1))
                rowi = aj * aij[:, k] + bj * A[byte(t, 0)]
                rowp = aj * A[byte(t, 1)] + bj * A[byte(t, 2)]
                x[:, k] = np.where(ti == tj[k], aij[:, k] + shift,
                                   np.where(t >> 24, 0.0, ai * rowi + bi * rowp))
            av, bv = coef(z >> 12)
            v = av[:, None] * v + bv[:, None] * v[(z >> 16) & 31]
            aij = x
            for k in range(2):
                ok = own[k] != none
                A[own[k][ok]] = aij[ok, k]
    for k in range(2):
        ok = own[k] != none
        A[own[k][ok]] = aij[ok, k]
    V = np.zeros((B, B))
    for k in range(smallsolve.V_ROWS_PER_LANE):
        ok = (vr != none) & (vr + L * k < B)
        V[(vr + L * k)[ok], vc[ok]] = v[ok, k]
    lam = np.array([A[smallsolve.packed_index(B, k, k)] for k in range(B)])
    thr = max(lam.max(), 0.0) * 1e-6
    inv = np.array([1.0 / x if x > thr else 0.0 for x in lam])
    return V @ (inv * (V.T @ g)), rotations, rounds, sweeps, A


def _reference(H, g):
    """The clipped solve the emulation is held to, with its tolerance of
    max|delta|: numpy's eigh within EMU_TOL where the kept spectrum's
    condition number kappa lets a float64 solve reach it (B eps kappa <=
    EMU_TOL); else the exact clipped solve (mpmath at 40 digits) within
    B eps kappa, the float64 floor (eigh's own error there reaches 7.7e-9 at
    kappa = 5e5)."""
    B = g.shape[0]
    vals, vecs = np.linalg.eigh(H)
    thr = max(vals.max(), 0.0) * 1e-6
    kept = vals > thr
    kappa = vals.max() / vals[kept].min() if kept.any() else 1.0
    if B * EPS * kappa <= EMU_TOL:
        inv = np.where(kept, 1.0 / np.where(kept, vals, 1.0), 0.0)
        return vecs @ (inv * (vecs.T @ g)), EMU_TOL
    with mpmath.workdps(40):
        E, Q = mpmath.eigsy(mpmath.matrix(H.tolist()))
        cut = max(max(E), 0) * mpmath.mpf("1e-6")
        x = [mpmath.mpf(0)] * B
        for k in range(B):
            if E[k] > cut:
                gv = mpmath.fsum(Q[d, k] * g[d] for d in range(B)) / E[k]
                x = [x[i] + Q[i, k] * gv for i in range(B)]
        return np.array([float(v) for v in x]), B * EPS * kappa


def _hold_emulation(H, g, rotations=None):
    """Every keyframe's emulated step against _reference; the solve ended
    by a sweep that would rotate nothing, within K_MAX_SWEEPS, every
    off-diagonal entry 0."""
    for h, v in zip(H, g):
        got, rot, rounds, sweeps, A = _emulate(h, v)
        want, tol = _reference(h, v)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= tol * scale
        assert sweeps < K_MAX_SWEEPS and rounds <= rot
        B = len(v)
        assert not A[[smallsolve.packed_index(B, i, j)
                      for i in range(B) for j in range(i + 1, B)]].any()
        if rotations is not None:
            assert rot == rotations


@pytest.mark.parametrize("kind", ["flat", "full"])
@pytest.mark.parametrize("order", [1, 2])
def test_emulated_kernel_matches_eigh_on_the_light_block(order, kind):
    """The light block's normal equations under the JAX package's SH basis
    (SH1 and SH2; a flat scene's rank-1 Gram and normals over the sphere)."""
    w, r, J_l = _system(order, 8, kind, seed=40 + order)
    H, g = _normal_eqs(w, r, J_l)
    _hold_emulation(H.double().numpy(), g.double().numpy())


def _edge_gram(kind, B, F, seed):
    """(H [F,B,B], g [F,B]) rounded to float32, in float64: random SPD, a
    rank-1 Gram, H = 0, a diagonal H, eigenvalues repeated in threes,
    eigenvalues geometric from 1 to 1.5e-6 (a spread of 6.7e5, all above the
    clip), or eigenvalues at 2 and 0.5 x the clip beside 1 (B = 2: 0.5 x
    only; B = 1: -1, dropped)."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(F, B, B)))[0]
    if kind == "spd":
        M = rng.normal(size=(F, B, B))
        H = M @ np.swapaxes(M, 1, 2) / B + 0.1 * np.eye(B)
    elif kind == "rank-1":
        b = rng.normal(size=(F, B, 1))
        H = 37.0 * b @ np.swapaxes(b, 1, 2)
    elif kind == "zero":
        H = np.zeros((F, B, B))
    elif kind == "diagonal":
        H = rng.uniform(0.5, 2.0, (F, B))[:, :, None] * np.eye(B)
    else:
        if kind == "repeated":
            lam = 1.0 + np.arange(B) // 3
        elif kind == "spread":
            lam = np.geomspace(1.0, 1.5e-6, B)
        else:
            lam = np.logspace(0, -3, B)
            lam[-1] = 0.5e-6 if B > 1 else -1.0
            if B > 2:
                lam[-2] = 2e-6
        H = (Q * lam) @ np.swapaxes(Q, 1, 2)
    g = rng.normal(size=(F, B))
    return (H.astype(np.float32).astype(np.float64),
            g.astype(np.float32).astype(np.float64))


@pytest.mark.parametrize("kind", ["spd", "rank-1", "zero", "diagonal", "repeated",
                                  "spread", "straddle"])
@pytest.mark.parametrize("B", range(1, 10))
def test_emulated_kernel_on_edge_grams(B, kind):
    """Every basis size the kernel takes, on the edges: H = 0 and a
    diagonal H apply no rotation (H = 0 gives delta = 0 exactly)."""
    H, g = _edge_gram(kind, B, 3, seed=100 * B + len(kind))
    _hold_emulation(H, g, rotations=0 if kind in ("zero", "diagonal") else None)
    if kind == "zero":
        assert not any(_emulate(h, v)[0].any() for h, v in zip(H, g))
