"""The pose and light normal equations (ops/normaleq.py) on CPU tensors,
where the wrappers run their plain versions, against the JAX package on the
same numpy inputs: the pose block's H and g (SH and LED, whole and in
N-chunks) against psgradientsdf_tpu.refine.optimizer._pose_normal_eqs, the
SH light block's for B = 4 and 9 against the einsums of the JAX package's
solve_light_sh (refine/solvers.py:526-527) on its own light_jacobian_sh,
and the light step against its solve_light_sh.  H is held within 1e-5 of
each frame's max|H|, g within 1e-5 of each frame's sum of |w r J|.  The
block cores give the same bits as the eager chains they ran before the
kernels, and no launch is counted on the CPU.  The kernels themselves run
only on the card (chip_smoke.py, phase normal_eq_kernels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch as ht
from psgradientsdf_tpu.refine import jacobians as jjac
from psgradientsdf_tpu.refine import optimizer as jopt
from psgradientsdf_tpu.refine import solvers as jsolvers
from psgradientsdf_tpu.refine.render import ResidualData as JResidualData
from psgradientsdf_tpu_torch.ops import normaleq
from psgradientsdf_tpu_torch.refine import jacobians as tjac
from psgradientsdf_tpu_torch.refine import optimizer as topt
from psgradientsdf_tpu_torch.refine import solvers as tsolvers
from psgradientsdf_tpu_torch.refine.render import ResidualData

TOL = 1e-5


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _inputs(N, F, seed, masked_frame=None, valid_rows=None):
    """numpy inputs of one linearization point: the residual pass's g_img,
    p_cam, w, r (a fifth of the pairs masked: w = r = 0), poses, K and the
    LED's albedo, stored gradient and light."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    poses = np.tile(np.eye(4, dtype=f32), (F, 1, 1))
    for f in range(F):
        poses[f, :3, :3] = _rotation(rng)
        poses[f, :3, 3] = rng.normal(scale=0.3, size=3)
    p_cam = np.stack([rng.uniform(-0.4, 0.4, (N, F)), rng.uniform(-0.3, 0.3, (N, F)),
                      rng.uniform(0.6, 1.8, (N, F))], axis=-1).astype(f32)
    mask = rng.uniform(size=(N, F)) > 0.2
    if masked_frame is not None:
        mask[:, masked_frame] = False
    if valid_rows is not None:
        mask[~np.isin(np.arange(N), valid_rows)] = False
    w = np.where(mask[..., None], rng.uniform(0.1, 1.0, (N, F, 3)), 0.0).astype(f32)
    r = np.where(mask[..., None], rng.normal(scale=0.1, size=(N, F, 3)), 0.0).astype(f32)
    return dict(
        g_img=rng.normal(scale=2.0, size=(N, F, 3, 2)).astype(f32), p_cam=p_cam,
        w=w, r=r, mask=mask, uv=rng.uniform(0, 40, (N, F, 2)).astype(f32),
        poses=poses, K=np.array([[45.0, 0, 23.7], [0, 46.0, 24.2], [0, 0, 1]], f32),
        albedo=rng.uniform(0.2, 0.9, (N, 3)).astype(f32),
        grad=rng.normal(size=(N, 3)).astype(f32),
        light=np.array([1.2, 1.1, 0.9], f32))


def _trd(x):
    t = {k: torch.from_numpy(x[k]) for k in ("r", "w", "mask", "p_cam", "uv", "g_img")}
    return ResidualData(**t)


def _jrd(x):
    return JResidualData(**{k: jnp.asarray(x[k])
                            for k in ("r", "w", "mask", "p_cam", "uv", "g_img")})


def _t(x, k):
    return torch.from_numpy(x[k])


def _hold(H, g, H_want, g_want, g_scale):
    """H within TOL of each frame's max|H|, g within TOL of each frame's
    sum of |w r J| (g_scale [F])."""
    H, g = ht.t2n(H), ht.t2n(g)
    H_want, g_want = np.asarray(H_want), np.asarray(g_want)
    assert H.shape == H_want.shape and g.shape == g_want.shape
    h_scale = np.abs(H_want).max(axis=(1, 2))
    assert (np.abs(H - H_want).max(axis=(1, 2)) <= TOL * h_scale).all()
    assert (np.abs(g - g_want).max(axis=1) <= TOL * np.asarray(g_scale)).all()


def _pose_args(x, model):
    lights = x["light"] if model == "LED" else np.zeros((x["w"].shape[1], 4), np.float32)
    return x["K"], x["poses"], x["albedo"], x["grad"], lights


def _pose_want(x, model):
    """The JAX package's (H, g) and each frame's sum of |w r J|."""
    K, poses, albedo, grad, lights = (jnp.asarray(a) for a in _pose_args(x, model))
    jrd = _jrd(x)
    H, g = jopt._pose_normal_eqs(jrd, K, poses, albedo, grad, lights, model)
    G = jjac.image_pi_grad(None, jrd, K)
    J = (jjac.pose_jacobian_led(G, jrd, poses, albedo, grad, lights) if model == "LED"
         else jjac.pose_jacobian_sh(G, jrd, poses))
    scale = jnp.einsum("nfc,nfcb->f", jnp.abs(jrd.w * jrd.r), jnp.abs(J))
    return H, g, scale


def _pose_got(x, model):
    K, poses, albedo, grad, lights = (torch.from_numpy(a) for a in _pose_args(x, model))
    return normaleq.pose_normal_eqs(_trd(x), K, poses, albedo, grad, lights, model)


@pytest.mark.parametrize("model", ["SH1", "LED"])
@pytest.mark.parametrize("N,F", [(300, 5), (97, 1), (64, 3)])
def test_pose_normal_eqs_match_the_jax_package(model, N, F):
    x = _inputs(N, F, seed=N + F)
    normaleq.reset_launch_counts()
    H, g = _pose_got(x, model)
    _hold(H, g, *_pose_want(x, model))
    assert H.shape == (F, 6, 6) and g.shape == (F, 6)
    assert normaleq.launch_counts == {"pose_normal_eqs": 0, "light_normal_eqs_sh": 0,
                                      "light_normal_eqs_led": 0}


@pytest.mark.parametrize("model", ["SH1", "LED"])
def test_pose_normal_eqs_chunked_match_the_jax_package_whole(model, monkeypatch):
    """The plain version's N-chunks (here 4 of 64 voxels) against the JAX
    package's unchunked sums."""
    x = _inputs(256, 4, seed=7)
    monkeypatch.setattr(normaleq, "_POSE_CHUNK", 64)
    H, g = _pose_got(x, model)
    _hold(H, g, *_pose_want(x, model))
    monkeypatch.setattr(normaleq, "_POSE_CHUNK", 1 << 30)
    H1, g1 = _pose_got(x, model)
    assert not torch.equal(H, H1)                 # another order of the sums
    _hold(H, g, H1, g1, _pose_want(x, model)[2])


@pytest.mark.parametrize("case", ["masked frame", "one valid row", "no valid pair"])
def test_pose_normal_eqs_of_masked_pairs(case):
    """Pairs with w = 0 add nothing: a keyframe with every pair masked has
    H = 0 and g = 0, as has every keyframe where no pair counts."""
    N, F = 120, 4
    x = _inputs(N, F, seed=3, masked_frame=2 if case == "masked frame" else None,
                valid_rows={"one valid row": [37], "no valid pair": []}.get(case))
    for model in ("SH1", "LED"):
        H, g = _pose_got(x, model)
        _hold(H, g, *_pose_want(x, model))
        dead = {"masked frame": [2], "no valid pair": list(range(F)),
                "one valid row": [f for f in range(F) if not x["mask"][37, f]]}[case]
        assert all(not H[f].any() and not g[f].any() for f in dead)
        assert len(dead) < F or case == "no valid pair"


def _light_want(x, order):
    """J_l from the JAX package's light_jacobian_sh, then the einsums of its
    solve_light_sh (solvers.py:526-527) with jnp, and each frame's sum of
    |w r J|."""
    J = jjac.light_jacobian_sh(None, jnp.asarray(x["albedo"]), jnp.asarray(x["grad"]), order)
    w, r = jnp.asarray(x["w"]), jnp.asarray(x["r"])
    H = jnp.einsum("nfc,ncb,ncd->fbd", w, J, J)
    g = jnp.einsum("nfc,ncb,nfc->fb", w, J, r)
    return H, g, jnp.einsum("nfc,ncb->f", jnp.abs(w * r), jnp.abs(J))


def _light_J(x, order):
    return tjac.light_jacobian_sh(None, _t(x, "albedo"), _t(x, "grad"), order)


@pytest.mark.parametrize("order,B", [(1, 4), (2, 9)])
@pytest.mark.parametrize("N,F", [(300, 5), (97, 1), (64, 3)])
def test_light_normal_eqs_match_the_jax_package(order, B, N, F):
    x = _inputs(N, F, seed=2 * N + F)
    normaleq.reset_launch_counts()
    J = _light_J(x, order)
    assert J.shape == (N, 3, B)
    H, g = normaleq.light_normal_eqs_sh(_trd(x), J)
    assert H.shape == (F, B, B) and g.shape == (F, B)
    _hold(H, g, *_light_want(x, order))
    assert normaleq.launch_counts == {"pose_normal_eqs": 0, "light_normal_eqs_sh": 0,
                                      "light_normal_eqs_led": 0}


@pytest.mark.parametrize("order", [1, 2])
def test_light_normal_eqs_of_a_masked_frame(order):
    x = _inputs(150, 3, seed=11, masked_frame=1)
    H, g = normaleq.light_normal_eqs_sh(_trd(x), _light_J(x, order))
    _hold(H, g, *_light_want(x, order))
    assert not H[1].any() and not g[1].any()


def _conditioned(order):
    """Normals spread over the sphere and residuals of a known light: every
    frame's light Gram matrix is full rank and well conditioned."""
    x = _inputs(400, 3, seed=5)
    H, _, _ = _light_want(x, order)
    vals = np.linalg.eigvalsh(np.asarray(H, np.float64))
    assert (vals[:, 0] > 1e-3 * vals[:, -1]).all()
    return x


@pytest.mark.parametrize("order", [1, 2])
def test_light_step_matches_solve_light_sh(order):
    """The light block's step as _light_core takes it (the wrapper's H and g,
    then solvers.solve_light_from_normal_eqs) against the JAX package's
    solve_light_sh."""
    x = _conditioned(order)
    J = _light_J(x, order)
    got = tsolvers.solve_light_from_normal_eqs(*normaleq.light_normal_eqs_sh(_trd(x), J))
    jJ = jjac.light_jacobian_sh(None, jnp.asarray(x["albedo"]), jnp.asarray(x["grad"]), order)
    want = np.asarray(jsolvers.solve_light_sh(_jrd(x), jJ))
    np.testing.assert_allclose(ht.t2n(got), want, atol=1e-4 * np.abs(want).max())


def _old_pose_eqs(x, model, chunk):
    """The eager chain _pose_core ran before the kernels: image_pi_grad, the
    pose Jacobian and its weighted Gram product, over N-chunks of `chunk`."""
    K, poses, albedo, grad, lights = (torch.from_numpy(a) for a in _pose_args(x, model))
    rd = _trd(x)
    H = g = None
    for lo in range(0, rd.w.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        part = ResidualData(*(a[sl] for a in rd))
        G = tjac.image_pi_grad(part, K)
        J = (tjac.pose_jacobian_led(G, part, poses, albedo[sl], grad[sl], lights)
             if model == "LED" else tjac.pose_jacobian_sh(G, part, poses))
        Hc = torch.einsum("nfcb,nfcd->fbd", part.w[..., None] * J, J)
        gc = torch.einsum("nfcb,nfc->fb", J, part.w * part.r)
        H = Hc if H is None else H + Hc
        g = gc if g is None else g + gc
    return H, g


@pytest.mark.parametrize("model", ["SH1", "LED"])
@pytest.mark.parametrize("chunked", [False, True])
def test_pose_core_keeps_its_bits(model, chunked, monkeypatch):
    x = _inputs(256, 3, seed=13)
    chunk = 64 if chunked else 256
    monkeypatch.setattr(normaleq, "_POSE_CHUNK", chunk if chunked else 1 << 30)
    K, poses, albedo, grad, lights = (torch.from_numpy(a) for a in _pose_args(x, model))
    kw = dict(model=model, order=1, loss=0, lam=0.0, voxel_size=0.04, damping=1.0)
    got = topt._pose_core(None, None, _trd(x), None, albedo, grad, poses, K, lights, **kw)
    H, g = _old_pose_eqs(x, model, chunk)
    want = tsolvers.update_poses(poses, tsolvers.solve_pose_from_normal_eqs(H, g, 1.0))
    assert torch.equal(got, want)


@pytest.mark.parametrize("order", [1, 2])
def test_light_core_keeps_its_bits(order):
    x = _conditioned(order)
    F, B = x["w"].shape[1], 4 if order == 1 else 9
    lights = torch.from_numpy(np.random.default_rng(order).normal(size=(F, B)).astype(np.float32))
    kw = dict(model=f"SH{order}", order=order, loss=0, lam=0.0, voxel_size=0.04,
              damping=1.0)
    got = topt._light_core(None, None, _trd(x), None, _t(x, "albedo"), _t(x, "grad"),
                           None, None, lights, **kw)
    J = _light_J(x, order)
    w = _t(x, "w")
    N = w.shape[0]
    wf = w.permute(1, 0, 2).reshape(F, N * 3)
    H = (wf @ (J[..., :, None] * J[..., None, :]).reshape(N * 3, B * B)).reshape(F, B, B)
    g = (w * _t(x, "r")).permute(1, 0, 2).reshape(F, N * 3) @ J.reshape(N * 3, B)
    assert torch.equal(got, lights - tsolvers.solve_light_from_normal_eqs(H, g))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = _inputs(16, 2, seed=1)
    J = torch.zeros((16, 3, 5))
    rd = _trd(x)
    with pytest.raises(ValueError):
        normaleq.pose_normal_eqs(rd._replace(w=rd.w.to("meta")), *(
            torch.from_numpy(a) for a in _pose_args(x, "SH1")), "SH1")
    with pytest.raises(ValueError):
        normaleq.light_normal_eqs_sh(rd._replace(w=rd.w.to("meta")), J)
