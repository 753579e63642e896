"""The SH light block's clipped eigen-solve (ops/smallsolve.py): its plain
version against the JAX package's solve_light_sh and against numpy's
float64 pseudo-inverse, on H and g formed from seeded numpy inputs."""

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
