"""The refinement's kernel module of the PyTorch package, ops/residual.py, on
the CPU, where its wrappers run the plain versions: the residual pass and
the distance block's Jacobian.

Against the JAX package, on the same numpy inputs (tests/helpers_torch.py's
refinement scene, with one pose turned so that projections leave the image
and one moved past the surface so that points lie behind the camera, and
the problem's padded rows): residual_pass_plain against
refine/render.compute_residuals under all five losses (SH1) and Cauchy and
Tukey (SH2, LED), the mask exact and r 2e-6, w 2e-5, p_cam 1e-6, uv 2e-4,
g_img 2e-6 absolute (tests/test_torch_patches_render.py's tolerances; uv
of a point within NEAR_PLANE of the camera plane within p_cam's 1e-6 carried
through the projection, |u| 1e-6 / |z| more, as u = fx x / z divides by
z);
dist_jacobian_plain's J0, Ji and G against refine/jacobians.image_pi_grad +
dist_jacobian_sh / _led within 1e-5 of each tensor's largest entry
(tests/test_torch_jacobians.py's).  Within the PyTorch package: the
fixed-order plain functions against the library reductions they replaced
(einsum, matrix products, vector_norm, sum over an axis) within float32
rounding; the wrappers on CPU tensors are the plain versions and launch
nothing; and a residual pass on a 2x2 mesh of CPU "devices" equals the
one-device pass on the same rows and frames bit for bit (the property the
kernel is held to on the card).  The kernels' tile plan (`_tile_plan`, the
host half of the card's design): for every keyframe count and voxel count
of the edge cases, the tiles cover every (voxel, frame) pair once, each
tile's pairs are one contiguous span of the [N, F] layout, and a block's
shared-memory regions are aligned, disjoint, large enough and within an
H100 block's 232,448 bytes; the ctypes argument blocks have the C side's
layout.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch as ht
from psgradientsdf_tpu.refine import jacobians as jjac
from psgradientsdf_tpu.refine import problem as jproblem
from psgradientsdf_tpu.refine import render as jrender
from psgradientsdf_tpu.utils import robust
from psgradientsdf_tpu_torch.ops import residual as tres
from psgradientsdf_tpu_torch.parallel import mesh as pm
from psgradientsdf_tpu_torch.refine import geometry as tgeometry
from psgradientsdf_tpu_torch.refine import jacobians as tjac
from psgradientsdf_tpu_torch.refine import optimizer as topt
from psgradientsdf_tpu_torch.refine import problem as tproblem
from psgradientsdf_tpu_torch.refine import render as trender
from psgradientsdf_tpu_torch.utils import sh as tsh

torch.set_num_threads(1)

H_VOX = 0.04
HW = 48
MODELS = {"SH1": ("SH1", 1), "SH2": ("SH2", 2), "LED": ("LED", 1)}
LOSSES = {"l2": robust.L2, "cauchy": robust.CAUCHY, "huber": robust.HUBER,
          "tukey": robust.TUKEY, "trunc_l2": robust.TRUNC_L2}
RESIDUAL_CASES = ([("SH1", loss) for loss in LOSSES]
                  + [(m, loss) for m in ("SH2", "LED") for loss in ("cauchy", "tukey")])
TOL = {"r": 2e-6, "w": 2e-5, "p_cam": 1e-6, "uv": 2e-4, "g_img": 2e-6}
NEAR_PLANE = 0.05     # metres
# the robust losses' lambda: about the median |r| of each model's counted
# pairs, so that residuals lie on both sides of it
LAM = {"SH1": 0.7, "SH2": 0.5, "LED": 0.1}


@functools.lru_cache(maxsize=None)
def _state(model):
    """The scene, both problems, lights and the four poses: 0 and 1 near the
    generating ones, 2 turned (projections leave the image), 3 moved 1.25 m
    forward, past the surface (points behind the camera)."""
    name, order = MODELS[model]
    sc = ht.refine_scene(model=name, order=order, n_poses=4, dim=32, h=H_VOX,
                         H=HW, W=HW, f=45.0)
    jp = jproblem.extract_problem(sc["jvol"], sc["jg"], sc["frame_ids"])
    tp = tproblem.extract_problem(sc["tvol"], sc["tg"], sc["frame_ids"])
    rng = np.random.default_rng(11)
    if name == "LED":
        lights = np.asarray([0.4, 1.9, 1.0], np.float32)
    else:
        lights = rng.normal(0, 0.3, (4, 4 if order == 1 else 9)).astype(np.float32)
        lights[:, 3] -= 0.8
    poses = sc["poses"].copy()
    poses[2] = poses[2] @ ht.se3_exp_np([0.3, 0, 0, 0, 0.2, 0])
    poses[3] = poses[3] @ ht.se3_exp_np([0, 0, 1.25, 0, 0, 0])
    return dict(sc=sc, jp=jp, tp=tp, model=model, name=name, order=order,
                lights=lights, poses=poses)


def _kw(st, loss=robust.CAUCHY):
    return dict(model=st["name"], order=st["order"], loss=loss,
                lam=LAM[st["model"]], voxel_size=H_VOX)


def _t_args(st):
    sc, tp = st["sc"], st["tp"]
    return (tp, sc["tg"], tp.dist, tp.albedo, tp.grad_stored,
            torch.from_numpy(st["poses"]), torch.from_numpy(sc["images"]),
            torch.from_numpy(sc["K"]), torch.from_numpy(st["lights"]))


def _j_args(st):
    sc, jp = st["sc"], st["jp"]
    return (jp, sc["jg"], jp.dist, jp.albedo, jp.grad_stored,
            jnp.asarray(st["poses"]), jnp.asarray(sc["images"]),
            jnp.asarray(sc["K"]), jnp.asarray(st["lights"]))


@pytest.mark.parametrize("model,loss", RESIDUAL_CASES,
                         ids=[f"{m}-{l}" for m, l in RESIDUAL_CASES])
def test_residual_pass_plain_matches_jax(model, loss):
    st = _state(model)
    kw = _kw(st, LOSSES[loss])
    trd = tres.residual_pass_plain(*_t_args(st), **kw)
    jrd = jrender.compute_residuals(*_j_args(st), **kw)
    np.testing.assert_array_equal(ht.t2n(trd.mask), np.asarray(jrd.mask))
    for name, atol in TOL.items():
        if name != "uv":
            np.testing.assert_allclose(
                ht.t2n(getattr(trd, name)), np.asarray(getattr(jrd, name)),
                atol=atol, err_msg=name)
    z = np.asarray(jrd.p_cam)[..., 2]
    near = np.abs(z) < NEAR_PLANE
    tuv, juv = ht.t2n(trd.uv), np.asarray(jrd.uv)
    np.testing.assert_allclose(tuv[~near], juv[~near], atol=TOL["uv"], err_msg="uv")
    bound = TOL["uv"] + np.abs(juv[near]) * TOL["p_cam"] / np.abs(z[near])[:, None]
    assert (np.abs(tuv[near] - juv[near]) <= bound).all()
    m = ht.t2n(trd.mask)
    assert (ht.t2n(trd.r)[~m] == 0).all() and (ht.t2n(trd.w)[~m] == 0).all()
    # the case covers what it claims: counted pairs, pairs off the image,
    # pairs behind the camera, padded rows
    valid = ht.t2n(st["tp"].valid)
    assert m.sum() > 1000
    assert (~m[valid][:, 2]).sum() > 100
    assert (z[valid][:, 3] <= 0).sum() > 100
    assert (~valid).sum() > 100
    r = np.abs(ht.t2n(trd.r))[m]
    assert (r < kw["lam"]).sum() > 100 and (r > kw["lam"]).sum() > 100


@pytest.mark.parametrize("model", list(MODELS))
def test_dist_jacobian_plain_matches_jax(model):
    """J0, Ji and G within 1e-5 of each tensor's largest entry."""
    st = _state(model)
    kw = _kw(st)
    trd = tres.residual_pass_plain(*_t_args(st), **kw)
    jrd = jrender.compute_residuals(*_j_args(st), **kw)
    tp, tg, dist, albedo, grad, poses, _, K, lights = _t_args(st)
    tG, tD = tres.dist_jacobian_plain(
        tp, tg, trd, dist, albedo, grad, poses, K, lights, model=st["name"],
        order=st["order"], voxel_size=H_VOX, with_G=True)
    jp, sc = st["jp"], st["sc"]
    jposes, jK, jl = (jnp.asarray(st["poses"]), jnp.asarray(sc["K"]),
                      jnp.asarray(st["lights"]))
    jG = jjac.image_pi_grad(None, jrd, jK)
    if st["name"] == "LED":
        jD = jjac.dist_jacobian_led(jp, sc["jg"], jp.dist, jp.albedo, jp.grad_stored,
                                    jl, jG, jposes, H_VOX)
    else:
        jD = jjac.dist_jacobian_sh(jp, sc["jg"], jp.dist, jp.albedo, jp.grad_stored,
                                   jl, jG, jposes, H_VOX, st["order"])
    # the pairs near the camera plane have |G| ~ 1/z^2: compare the pairs a
    # block uses (the residual's mask) and, unmasked, the rows in front
    m = ht.t2n(trd.mask)
    for t, j in ((tG, jG), (tD.J0, jD.J0)):
        t, j = ht.t2n(t)[m], np.asarray(j)[m]
        assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max()
    t = np.moveaxis(ht.t2n(tD.Ji), 1, 2)[m]
    j = np.moveaxis(np.asarray(jD.Ji), 1, 2)[m]
    assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max()
    assert tD.J0.shape == trd.r.shape
    assert tD.Ji.shape == (trd.r.shape[0], 3) + trd.r.shape[1:]
    assert tG.shape == trd.r.shape + (3,)


# ------------------------------------------- fixed order against the library


def _close(got, want, rel=2e-6):
    got, want = ht.t2n(got), ht.t2n(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, (
        float(np.abs(got - want).max()), scale)


def _world_to_cam_einsum(pts_w, poses):
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    return torch.einsum("fji,nfj->nfi", R, pts_w[:, None, :] - t[None, :, :])


def _normalize_library(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def _normal_jacobian_library(grad, direction, h):
    n_d = -direction / h
    N_inv = 1.0 / torch.clamp(torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-3)
    dN = (N_inv ** 3) * torch.sum(n_d * grad, dim=-1, keepdim=True)
    return N_inv * n_d - dN * grad


def test_fixed_order_geometry_equals_the_library_reductions():
    st = _state("SH2")
    tp = st["tp"]
    g = tgeometry.fd_grad(tp, tp.dist, H_VOX)
    _close(tgeometry.normalize(tp.grad_stored), _normalize_library(tp.grad_stored))
    _close(tgeometry.norm3(g), torch.linalg.vector_norm(g, dim=-1))
    dn0, dni = tgeometry.dn_stencil(tp, g, H_VOX)
    _close(dn0, _normal_jacobian_library(g, tp.nbr_dir, H_VOX))
    eye = torch.eye(3)
    dirs = -tp.nbr_dir[..., None] * eye[None]
    _close(dni, _normal_jacobian_library(g[:, None, :], dirs, H_VOX))
    poses = torch.from_numpy(st["poses"])
    x = trender.surface_points_world(tp, st["sc"]["tg"], tp.dist, tp.grad_stored)
    _close(trender.world_to_cam(x, poses), _world_to_cam_einsum(x, poses))
    p = trender.world_to_cam(x, poses)
    _close(trender.rotate(poses, p, transpose=False),
           torch.einsum("fij,nfj->nfi", poses[:, :3, :3], p))


@pytest.mark.parametrize("model", list(MODELS))
def test_fixed_order_shading_equals_the_library_reductions(model):
    st = _state(model)
    tp, sc = st["tp"], st["sc"]
    poses, lights = torch.from_numpy(st["poses"]), torch.from_numpy(st["lights"])
    n = _normalize_library(tgeometry.fd_grad(tp, tp.dist, H_VOX))
    if st["name"] == "LED":
        got = trender.rendered_intensity_led(tp, sc["tg"], tp.dist, tp.albedo,
                                             tp.grad_stored, lights, poses, H_VOX)
        p = _world_to_cam_einsum(
            trender.surface_points_world(tp, sc["tg"], tp.dist, tp.grad_stored), poses)
        Rp = torch.einsum("fij,nfj->nfi", poses[:, :3, :3], p)
        num = -torch.einsum("ni,nfi->nf", n, Rp)
        irr = num / torch.clamp(torch.linalg.vector_norm(p, dim=-1), min=1e-12) ** 3
        want = tp.albedo[:, None, :] * lights[None, None, :] * irr[..., None]
        # |p| ~ 0 on the pairs past the surface: compare the rows in front
        front = (p[..., 2] > 0.05)[..., None]
        got, want = got * front, want * front
    else:
        basis = tsh.sh_basis(n, st["order"])
        _close(tsh.irradiance(basis, lights), basis @ lights.T)
        got = trender.rendered_intensity_sh(tp, tp.dist, tp.albedo, lights, H_VOX,
                                            st["order"])
        want = tp.albedo[:, None, :] * (basis @ lights.T)[..., None]
    _close(got, want, rel=5e-6)


@pytest.mark.parametrize("model", list(MODELS))
def test_fixed_order_dist_jacobian_equals_the_einsum_chains(model):
    """dist_jacobian_plain against the einsum form of refine/jacobians.py
    that it replaced (on the pairs in front of the camera)."""
    st = _state(model)
    tp, sc = st["tp"], st["sc"]
    args = _t_args(st)
    poses, K, lights = args[5], args[7], args[8]
    rd = tres.residual_pass_plain(*args, **_kw(st))
    G, DJ = tres.dist_jacobian_plain(tp, sc["tg"], rd, tp.dist, tp.albedo,
                                     tp.grad_stored, poses, K, lights,
                                     model=st["name"], order=st["order"],
                                     voxel_size=H_VOX, with_G=True)
    g = tgeometry.fd_grad(tp, tp.dist, H_VOX)
    dn0 = _normal_jacobian_library(g, tp.nbr_dir, H_VOX)
    dni = _normal_jacobian_library(g[:, None, :], -tp.nbr_dir[..., None] * torch.eye(3),
                                   H_VOX)
    ghat = _normalize_library(tp.grad_stored)
    R = poses[:, :3, :3]
    GRt = torch.einsum("nfcx,fyx->nfcy", G, R)
    dx0 = -ghat - tp.dist[:, None] * dn0
    dxi = -tp.dist[:, None, None] * dni
    dI0 = torch.einsum("nfcy,ny->nfc", GRt, dx0)
    dIi = torch.einsum("nfcy,nay->nafc", GRt, dxi)
    n_fd = _normalize_library(g)
    if st["name"] == "LED":
        p = rd.p_cam
        Rp = torch.einsum("fij,nfj->nfi", R, p)
        pn = torch.clamp(torch.linalg.vector_norm(p, dim=-1), min=1e-12)
        m_val = torch.einsum("ni,nfi->nf", n_fd, Rp)

        def m_terms(dn, dx):
            num = torch.einsum("ny,nfy->nf", dn, Rp) + torch.sum(n_fd * dx, -1)[:, None]
            rad = -3.0 * torch.einsum("nfi,ni->nf", Rp, dx) / pn ** 5
            return num / pn ** 3 + rad * m_val

        dR = tp.albedo * lights[None, :]
        J0 = dI0 + dR[:, None, :] * m_terms(dn0, dx0)[..., None]
        Ji = torch.stack([dIi[:, a] + dR[:, None, :] * m_terms(dni[:, a], dxi[:, a])[..., None]
                          for a in range(3)], 1)
    else:
        if st["order"] == 1:
            dS0 = dn0 @ lights[:, 1:4].T
            dSi = torch.einsum("nay,fy->naf", dni, lights[:, 1:4])
        else:
            dsh = tsh.dsh_dn(n_fd, 2)
            dS0 = torch.einsum("nyb,ny->nb", dsh, dn0) @ lights.T
            dSi = torch.einsum("nab,fb->naf", torch.einsum("nyb,nay->nab", dsh, dni), lights)
        J0 = dI0 - tp.albedo[:, None, :] * dS0[..., None]
        Ji = dIi - tp.albedo[:, None, None, :] * dSi[..., None]
    front = rd.p_cam[..., 2] > 0.05
    _close(DJ.J0[front], J0[front], rel=5e-6)
    _close(DJ.Ji.permute(0, 2, 1, 3)[front], Ji.permute(0, 2, 1, 3)[front], rel=5e-6)


# ---------------------------------------------------- wrappers and layouts


@pytest.mark.parametrize("model", list(MODELS))
def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing(model):
    st = _state(model)
    tp, sc = st["tp"], st["sc"]
    args = _t_args(st)
    tres.reset_launch_counts()
    got = trender.compute_residuals(*args, **_kw(st))
    want = tres.residual_pass_plain(*args, **_kw(st))
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    jkw = dict(model=st["name"], order=st["order"], voxel_size=H_VOX)
    G0, DJ0 = tres.dist_jacobian(tp, sc["tg"], got, tp.dist, tp.albedo,
                                 tp.grad_stored, args[5], args[7], args[8], **jkw)
    G1, DJ1 = tres.dist_jacobian(tp, sc["tg"], got, tp.dist, tp.albedo,
                                 tp.grad_stored, args[5], args[7], args[8],
                                 **jkw, with_G=True)
    G2, DJ2 = tres.dist_jacobian_plain(tp, sc["tg"], got, tp.dist, tp.albedo,
                                       tp.grad_stored, args[5], args[7], args[8],
                                       **jkw, with_G=True)
    assert G0 is None
    assert torch.equal(G1, G2) and torch.equal(G1, tjac.image_pi_grad(got, args[7]))
    for D in (DJ0, DJ1):
        assert torch.equal(D.J0, DJ2.J0) and torch.equal(D.Ji, DJ2.Ji)
    assert tres.launch_counts == {"residual_pass": 0, "dist_jacobian": 0}


@pytest.mark.parametrize("model", list(MODELS))
def test_mesh_residual_pass_equals_the_one_device_pass_bit_for_bit(model):
    """The residual pass of a 2x2 mesh's blocks (N in two row chunks, the
    keyframes in two, every stencil neighbour's value frozen into a block's
    view) against the one-device pass on the same rows and frames, and each
    block's distance Jacobian against the one-device one."""
    st = _state(model)
    tp, sc = st["tp"], st["sc"]
    args = _t_args(st)
    one = tres.residual_pass_plain(*args, **_kw(st))
    _, DJ = tres.dist_jacobian_plain(tp, sc["tg"], one, tp.dist, tp.albedo,
                                     tp.grad_stored, args[5], args[7], args[8],
                                     model=st["name"], order=st["order"],
                                     voxel_size=H_VOX)
    cfg = topt.OptimizerConfig(model=st["name"], order=st["order"], lam=LAM[model],
                               loss=robust.CAUCHY)
    ref = topt.PhotometricRefiner(
        sc["tvol"], sc["tg"], cfg, sc["K"], mesh=pm.make_mesh(2, 2, device="cpu"),
        device="cpu")
    ref.images, ref.poses, ref.K = args[6], args[5], args[7]
    ref.keyframe_indices = list(sc["frame_ids"])
    ref.prob, ref.lights = tp, args[8]
    ref.dist, ref.albedo, ref.grad_stored = tp.dist, tp.albedo, tp.grad_stored
    ref.place_on_mesh()
    mrd = ref._rd()
    from psgradientsdf_tpu_torch.parallel import refine as prefine

    mDJ = prefine._dist_jacobians(ref.geom, mrd, st["name"], st["order"], H_VOX)
    n_blocks = 0
    for k, row in enumerate(mrd.blocks):
        for j, b in enumerate(row):
            rows = slice(b.rows[0], b.rows[0] + b.prob.valid.shape[0])
            frames = slice(b.frames[0], b.frames[0] + b.poses.shape[0])
            for name, a, w in zip(one._fields, mrd.rd[k][j], one):
                assert torch.equal(a, w[rows, frames]), (k, j, name)
            _, D = mDJ[k][j]
            assert torch.equal(D.J0, DJ.J0[rows, frames]), (k, j)
            assert torch.equal(D.Ji, DJ.Ji[rows, :, frames]), (k, j)
            n_blocks += 1
    assert n_blocks == 4


# ------------------------------------------------------------ the tile plan

PLAN_F = (1, 3, 8, 34, 40, 300, 5000)
PLAN_N = (1, 7, 49152)


def _tile_bounds(plan, N, F, t):
    """(n0, nv, f0, nf) of tiles t as csrc/residual.cu's tile_at decodes
    them: voxel group t // ceil(F / FT), frame range t mod it."""
    frame_tiles = -(-F // plan.frames)
    g, ft = np.divmod(np.asarray(t, dtype=np.int64), frame_tiles)
    n0, f0 = g * plan.voxels, ft * plan.frames
    return n0, np.minimum(plan.voxels, N - n0), f0, np.minimum(plan.frames, F - f0)


def _regions(plan, kernel):
    """[(offset, bytes needed)] of a block's shared memory under the plan:
    the mbarriers; every buffer of the voxel terms, both of the frame terms
    and, in the pass, of the staged outputs (each output its largest span
    and 15 bytes of alignment shift)."""
    cap = plan.voxels * plan.frames
    out = [(0, 64)]
    for b in range(tres._VOX_BUFFERS):
        out.append((plan.vox + b * plan.vox_bytes,
                    tres._VOX_FLOATS[kernel] * 4 * plan.voxels))
    for b in range(2):
        out.append((plan.frm + b * plan.frm_bytes, tres._FRAME_FLOATS * 4 * plan.frames))
        if kernel == "residual":
            for k, per_pair in enumerate(tres._OUT_BYTES):
                out.append((plan.stage + b * plan.stage_bytes + plan.outputs[k],
                            cap * per_pair + 15))
    return out


@pytest.mark.parametrize("N", PLAN_N)
@pytest.mark.parametrize("F", PLAN_F)
def test_tile_plan_covers_every_pair_once_in_contiguous_spans(F, N):
    for kernel in ("residual", "jacobian"):
        plan = tres._tile_plan(N, F, kernel=kernel)
        assert plan.voxels * plan.frames <= tres.PAIRS_PER_TILE[kernel]
        assert plan.frames == F or plan.voxels == 1
        n0, nv, f0, nf = _tile_bounds(plan, N, F, np.arange(plan.tiles))
        assert (nv >= 1).all() and (nf >= 1).all()
        assert (nv <= plan.voxels).all() and (nf <= plan.frames).all()
        # a tile's pairs are one span: whole voxels, or one voxel's frames
        assert ((nf == F) | (nv == 1)).all()
        start, length = n0 * F + f0, nv * nf
        # the spans follow each other from pair 0 to pair N F - 1: every
        # pair in exactly one tile
        assert start[0] == 0
        assert (start[1:] == start[:-1] + length[:-1]).all()
        assert int(length.sum()) == N * F
        # shared memory: aligned, disjoint regions within the block's limit;
        # the carveout holds the blocks an SM asked for
        assert plan.smem_bytes <= tres.SMEM_PER_BLOCK
        blocks = tres.BLOCKS_PER_SM[kernel]
        assert (plan.carveout * tres.SMEM_PER_SM / 100
                >= min(blocks * (plan.smem_bytes + 1024), tres.SMEM_PER_SM))
        regions = sorted(_regions(plan, kernel))
        for (off, need), (nxt, _) in zip(regions, regions[1:] + [(plan.smem_bytes, 0)]):
            assert off % 16 == 0 and off + need <= nxt, (kernel, off, need, nxt)
        assert max(length) <= plan.voxels * plan.frames


@pytest.mark.parametrize("kernel", ["residual", "jacobian"])
def test_c_argument_blocks_have_the_kernels_layout(kernel):
    """Every field 8 bytes, the plan last but for the pass's grid voxel
    size after it (csrc/residual.cu's structs), and the plan passed field
    for field."""
    import ctypes

    assert ctypes.sizeof(tres._TilePlan) == 17 * 8
    assert ctypes.sizeof(tres._ResidualArgs) == (19 + 7 + 5) * 8 + 17 * 8 + 8
    assert ctypes.sizeof(tres._JacobianArgs) == (14 + 4 + 1) * 8 + 17 * 8
    assert tres._ResidualArgs.plan.offset == (19 + 7 + 5) * 8
    assert tres._ResidualArgs.grid_voxel.offset == (19 + 7 + 5) * 8 + 17 * 8
    assert tres._JacobianArgs.plan.offset == (14 + 4 + 1) * 8
    plan = tres._tile_plan(7, 5000, kernel=kernel)
    c = tres._c_plan(plan)
    P = tres.PAIRS_PER_TILE[kernel]
    assert (c.voxels, c.frames, c.tiles) == (1, P, 7 * -(-5000 // P))
    assert (c.smem_bytes, c.vox, c.vox_bytes, c.frm, c.frm_bytes) == (
        plan.smem_bytes, plan.vox, plan.vox_bytes, plan.frm, plan.frm_bytes)
    assert (c.stage, c.stage_bytes) == (plan.stage, plan.stage_bytes)
    assert tuple(c.outputs) == plan.outputs
    assert c.carveout == plan.carveout and 0 < plan.carveout <= 100
    # only the pass stages its outputs
    assert (plan.stage_bytes > 0) == (kernel == "residual")


def test_voxel_centres_follow_the_grid_and_differences_the_step(monkeypatch):
    """The refinement's loop passes the step it started with after the
    upsample halves the grid (as the JAX package's does): the pass places
    the voxel centres on the grid's spacing (geom.voxel2world) whatever the
    step, and only the finite differences take the step.  The plain
    version's p_cam and uv do not move with the step; the wrapper hands the
    kernel both sizes (the launch captured on meta tensors, no card
    here)."""
    st = _state("LED")
    args, kw = _t_args(st), _kw(st)
    a = tres.residual_pass_plain(*args, **kw)
    b = tres.residual_pass_plain(*args, **dict(kw, voxel_size=2 * H_VOX))
    assert torch.equal(a.p_cam, b.p_cam) and torch.equal(a.uv, b.uv)

    seen = {}
    monkeypatch.setattr(tres, "_library", lambda: type("L", (), {"residual_pass": None}))
    monkeypatch.setattr(tres, "_launch", lambda fn, args, dev, name: seen.update(a=args))
    meta = lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t
    prob = type(args[0])(*(meta(t) for t in args[0]))
    margs = (prob, args[1]) + tuple(meta(t) for t in args[2:])
    tres.residual_pass(*margs, **dict(kw, voxel_size=2 * H_VOX))
    geom = args[1]
    assert seen["a"].grid_voxel == geom.voxel_size == H_VOX
    assert seen["a"].voxel == 2 * H_VOX
    assert (seen["a"].origin_x, seen["a"].origin_y, seen["a"].origin_z) == geom.origin
