"""Shared builders for the tests that hold the PyTorch package against the
JAX package: scenes are made with numpy from fixed parameters or a seed and
handed to both sides as numpy arrays; state crosses through
psgradientsdf_tpu_torch.convert."""

import numpy as np
import jax.numpy as jnp
import torch

from psgradientsdf_tpu.core import grid as jgrid
from psgradientsdf_tpu.core import volume as jvolume
from psgradientsdf_tpu.ops import normals as jnormals
from psgradientsdf_tpu_torch import convert
from psgradientsdf_tpu_torch.core import volume as tvolume

# one thread per test process: the suite runs several workers beside JAX's
# eight virtual CPU devices
torch.set_num_threads(1)

CPU = "cpu"
FIELDS = ("dist", "grad", "weight", "color")


def intrinsics(H, W, f):
    """Pinhole intrinsics with the principal point off the pixel lattice, so
    that voxel centres do not project onto pixel boundaries by symmetry."""
    return np.array([[f, 0, W / 2 - 0.37], [0, 1.03 * f, H / 2 + 0.21],
                     [0, 0, 1]], np.float32)


def se3_exp_np(xi):
    """Rodrigues SE(3) exponential in float64 numpy -> float32 [4,4]."""
    xi = np.asarray(xi, np.float64)
    rho, om = xi[:3], xi[3:]
    th = np.linalg.norm(om)
    Kx = np.array([[0, -om[2], om[1]], [om[2], 0, -om[0]], [-om[1], om[0], 0]])
    if th < 1e-8:
        R = np.eye(3) + Kx
        V = np.eye(3) + 0.5 * Kx
    else:
        a, b = np.sin(th) / th, (1 - np.cos(th)) / th ** 2
        c = (th - np.sin(th)) / th ** 3
        R = np.eye(3) + a * Kx + b * Kx @ Kx
        V = np.eye(3) + b * Kx + c * Kx @ Kx
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T.astype(np.float32)


def wavy_frame(H, W, K, pose=None, z_mid=1.2):
    """One view of a wavy textured heightfield z = g(x, y) (generic enough
    to constrain all six degrees of freedom): depth [H,W], color [H,W,3],
    analytic inward camera-frame normals [H,W,3], n_sq_inv [H,W], float32."""
    pose = np.eye(4) if pose is None else np.asarray(pose, np.float64)
    R, t = pose[:3, :3], pose[:3, 3]
    cols = np.arange(W, dtype=np.float64)[None, :]
    rows = np.arange(H, dtype=np.float64)[:, None]
    K = np.asarray(K, np.float64)
    x0 = np.broadcast_to((cols - K[0, 2]) / K[0, 0], (H, W))
    y0 = np.broadcast_to((rows - K[1, 2]) / K[1, 1], (H, W))

    def g(x, y):
        return (z_mid + 0.08 * np.sin(6 * x) * np.cos(5 * y)
                + 0.05 * np.sin(3 * (x + y)))

    z = np.full((H, W), z_mid)
    for _ in range(30):
        pw = np.stack([x0 * z, y0 * z, z], -1) @ R.T + t
        z = z + 0.9 * (g(pw[..., 0], pw[..., 1]) - pw[..., 2])
    pw = np.stack([x0 * z, y0 * z, z], -1) @ R.T + t
    x, y = pw[..., 0], pw[..., 1]
    dgx = 0.48 * np.cos(6 * x) * np.cos(5 * y) + 0.15 * np.cos(3 * (x + y))
    dgy = -0.40 * np.sin(6 * x) * np.sin(5 * y) + 0.15 * np.cos(3 * (x + y))
    n_w = np.stack([-dgx, -dgy, np.ones_like(dgx)], -1)
    n_w /= np.linalg.norm(n_w, axis=-1, keepdims=True)
    color = np.stack([0.5 + 0.2 * np.sin(10 * x), 0.5 + 0.2 * np.cos(8 * y),
                      0.5 + 0.15 * np.sin(6 * (x + y))], -1)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    return dict(depth=f32(z), color=f32(color), normals=f32(n_w @ R),
                n_sq_inv=f32(1.0 / (1.0 + x0 ** 2 + y0 ** 2)))


def geoms(dims, h, shift):
    """(JAX GridGeometry, torch GridGeometry) of the same grid."""
    shift = tuple(float(s) for s in shift)
    return (jgrid.GridGeometry(dims=tuple(dims), voxel_size=h, shift=shift),
            convert.geometry(dims, h, shift))


def vol_to_numpy_j(vol):
    """A JAX GradSdfVolume as writable numpy arrays (vis uint32)."""
    return {k: np.array(getattr(vol, k)) for k in FIELDS + ("vis",)}


def to_torch_vol(jvol):
    """State carried across: a JAX volume continued on the torch side."""
    a = vol_to_numpy_j(jvol)
    return convert.volume_from_numpy(
        a["dist"], a["grad"], a["weight"], a["color"], a["vis"], device=CPU)


def to_jax_vol(tvol):
    a = convert.volume_to_numpy(tvol)
    return jvolume.GradSdfVolume(*(jnp.asarray(a[k]) for k in FIELDS + ("vis",)))


def fals_pair(H, W, K):
    """(JAX FalsCache, torch FalsCache) from the same float64 host cache."""
    jf = jnormals.build_fals_cache(H, W, K, window=11)
    tf = convert.fals_from_numpy(*(np.array(a) for a in jf), device=CPU)
    return jf, tf


def field_tolerances(depth_scale, truncation, ulps):
    """Absolute tolerances for the float fields of a volume after fusion.

    The unit is one float32 ULP at the scene's camera-space depth: the
    signed distance is sdf = z - pz, a difference of two numbers of that
    magnitude, and the two packages round pz differently (one compiler
    contracts the rotation's multiply-adds, the other does not).  dist
    inherits that error as it is; the fusion weight w = 1 + sdf/T divides it
    by the truncation T, and weight, colour and grad inherit the weight's.
    dist and colour are running means sum(w x) / W: where the accumulated
    weight W is under 1 the division magnifies the weights' error by 1/W, so
    assert_vol_close holds those two fields in their accumulated form W x."""
    unit = float(np.spacing(np.float32(depth_scale))) * ulps
    return dict(dist=unit, weight=unit / truncation, color=unit / truncation,
                grad=unit / truncation)


def assert_vol_close(tvol, jvol, tol, where="", edge_fraction=0.0):
    """Visibility words exact; float fields within tol[field] (absolute) on
    every voxel, except at most `edge_fraction` of the voxels: those whose
    projection u + 0.5 falls within an ULP of an integer pick a neighbouring
    pixel on one side (the reference's int-cast rounding is a knife edge)."""
    t = convert.volume_to_numpy(tvol)
    j = vol_to_numpy_j(jvol)
    np.testing.assert_array_equal(t["vis"], j["vis"], err_msg=f"vis {where}")
    for k in FIELDS:
        err = np.abs(t[k].astype(np.float64) - j[k].astype(np.float64))
        if err.ndim == 4:
            err = err.max(-1)
        if k in ("dist", "color"):
            err = err * np.minimum(j["weight"], 1.0)
        bad = float(np.mean(err > tol[k]))
        assert bad <= edge_fraction, (where, k, bad, float(err.max()), tol[k])


def fuse_both(jvol, tvol, jg, tg, fr, K, pose, fid, T, culled=None, **kw):
    """Fuse one frame on both sides; culled=dict(row_capacity=, seg_x=,
    j_impl=, t_impl=) takes the culled kernels; tvol=None fuses on the JAX
    side only.  Returns (jvol, tvol, jov, tov)."""
    zkw = dict(truncation=T, zmin=0.1, zmax=5.0)
    jargs = [jnp.asarray(fr[k]) for k in ("color", "depth", "normals", "n_sq_inv")]
    targs = [fr[k] for k in ("color", "depth", "normals", "n_sq_inv")]
    gate = kw.get("gate")
    jgate = None if gate is None else jnp.bool_(gate)
    if culled is None:
        jv = jvolume.fuse_frame(jvol, jg, *jargs, jnp.asarray(K),
                                jnp.asarray(pose), jnp.int32(fid), jgate, **zkw)
        tv = None if tvol is None else tvolume.fuse_frame(
            tvol, tg, *targs, K, pose, fid, gate, device=CPU, **zkw)
        return jv, tv, False, False
    jv, jov = jvolume.fuse_frame_culled(
        jvol, jg, *jargs, jnp.asarray(K), jnp.asarray(pose), jnp.int32(fid),
        jgate, row_capacity=culled["row_capacity"], seg_x=culled.get("seg_x"),
        rows_impl=culled["j_impl"], **zkw)
    tv, tov = tvolume.fuse_frame_culled(
        tvol, tg, *targs, K, pose, fid, gate,
        row_capacity=culled["row_capacity"], seg_x=culled.get("seg_x"),
        rows_impl=culled["t_impl"], device=CPU, **zkw)
    return jv, tv, bool(jov), bool(tov)


# ----------------------------------------------------------- the refinement

def sh_basis_np(n, order):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    cols = [np.ones_like(nx), nx, ny, nz]
    if order == 2:
        cols += [nx * ny, nx * nz, ny * nz, nx * nx - ny * ny, nx * nx - nz * nz]
    return np.stack(cols, -1)


def shaded_image(fr, pose, K, model, light, order=1):
    """A frame of wavy_frame re-coloured by a Lambertian rendering of its
    texture (the albedo) with the OUTWARD normal, the convention of the
    refinement's shading normal: SH irradiance l . SH(n_out) (mirrors
    tests/helpers.shaded_images), or for "LED" a near point light at the
    camera centre, -(n_out . (X - c)) / |X - c|^3 per channel (mirrors
    test_refine_led_upsample.led_images)."""
    R = np.asarray(pose, np.float64)[:3, :3]
    n_out = -(fr["normals"].astype(np.float64) @ R.T)     # world, outward
    albedo = fr["color"].astype(np.float64)
    if model != "LED":
        irr = sh_basis_np(n_out, order) @ np.asarray(light, np.float64)
        return (albedo * irr[..., None]).astype(np.float32)
    H, W = fr["depth"].shape
    z = fr["depth"].astype(np.float64)
    x0 = (np.arange(W)[None, :] - K[0, 2]) / K[0, 0]
    y0 = (np.arange(H)[:, None] - K[1, 2]) / K[1, 1]
    p_cam = np.stack([x0 * z, y0 * z, z], -1)
    irr = -np.einsum("hwi,hwi->hw", n_out, p_cam @ R.T)
    irr = irr / np.maximum(np.linalg.norm(p_cam, axis=-1), 1e-9) ** 3
    return (albedo * np.asarray(light)[None, None, :] * irr[..., None]
            ).astype(np.float32)


SH1_LIGHT = (0.1, 0.2, -0.15, 0.85)
SH2_LIGHT = (0.1, 0.2, -0.15, 0.85, 0.05, -0.04, 0.03, 0.06, -0.05)
LED_LIGHT = (0.9, 1.1, 1.0)


def refine_scene(model="SH1", order=1, n_poses=2, dim=48, h=0.03, H=64, W=64,
                 f=60.0, frame_ids=None):
    """A shaded wavy heightfield seen from n_poses nearby cameras, fused by
    the JAX package into a volume that both packages then refine: dict with
    the volume on both sides, both geometries, K, poses [F,4,4], shaded
    keyframe images [F,H,W,3], the keyframes' frame counters, truncation."""
    K = intrinsics(H, W, f)
    poses = [np.eye(4, dtype=np.float32)]
    for i in range(1, n_poses):
        poses.append(se3_exp_np(0.02 * np.random.RandomState(i).randn(6)))
    frame_ids = list(frame_ids or range(n_poses))
    jg, tg = geoms((dim, dim, dim), h, (0.013, -0.007, 1.2))
    T = 5 * h
    jvol = jvolume.make_volume(jg, truncation=T, frame_cap=32 * (max(frame_ids) // 32 + 1))
    light = {"SH1": SH1_LIGHT, "SH2": SH2_LIGHT, "LED": LED_LIGHT}[model]
    images = []
    for pose, fid in zip(poses, frame_ids):
        fr = wavy_frame(H, W, K, pose)
        jvol, _, _, _ = fuse_both(jvol, None, jg, tg, fr, K, pose, fid, T)
        images.append(shaded_image(fr, pose, K, model, light, order))
    return dict(jvol=jvol, tvol=to_torch_vol(jvol), jg=jg, tg=tg, K=K,
                poses=np.stack(poses), images=np.stack(images),
                frame_ids=frame_ids, truncation=T, light=np.asarray(light, np.float32))


def optimizer_configs(**kw):
    """(JAX OptimizerConfig, torch OptimizerConfig) with the same fields."""
    from psgradientsdf_tpu import config as jconfig
    from psgradientsdf_tpu_torch import config as tconfig

    return jconfig.OptimizerConfig(**kw), tconfig.OptimizerConfig(**kw)


def refiner_pair(sc, save_paths=("", ""), **cfg_kw):
    """Both packages' refiners on the scene, keyframes set and init() run."""
    from psgradientsdf_tpu.refine.optimizer import PhotometricRefiner as JRefiner
    from psgradientsdf_tpu.utils.metrics import MetricsLogger as JLogger
    from psgradientsdf_tpu_torch.refine.optimizer import PhotometricRefiner as TRefiner
    from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger as TLogger

    jcfg, tcfg = optimizer_configs(**cfg_kw)
    stamps = [f"{i:03d}" for i in range(len(sc["frame_ids"]))]
    jref = JRefiner(sc["jvol"], sc["jg"], jcfg, sc["K"], save_path=save_paths[0],
                    truncation=sc["truncation"], metrics=JLogger(None, echo=False))
    jref.set_keyframes(sc["images"], sc["poses"], sc["frame_ids"], stamps)
    jref.init()
    tref = TRefiner(sc["tvol"], sc["tg"], tcfg, sc["K"], save_path=save_paths[1],
                    truncation=sc["truncation"], metrics=TLogger(None, echo=False))
    tref.set_keyframes(sc["images"], sc["poses"], sc["frame_ids"], stamps)
    tref.init()
    return jref, tref


def problem_j_to_numpy(jprob):
    return {k: np.array(v) for k, v in zip(jprob._fields, jprob)}


def assert_problem_equal(tprob, jprob):
    """Integers, masks and the surface count exactly; floats bit for bit."""
    t = convert.problem_to_numpy(tprob)
    j = problem_j_to_numpy(jprob)
    for k in j:
        assert t[k].shape == j[k].shape, (k, t[k].shape, j[k].shape)
        if np.issubdtype(j[k].dtype, np.floating):
            np.testing.assert_array_equal(
                t[k].view(np.int32), j[k].view(np.int32), err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def t2n(x):
    return x.detach().cpu().numpy()


def gn_rounds_over_plain_callables(vol, geom, depth, K, init_pose, *, zmin,
                                   zmax, stride=1, device=None, truncation=None,
                                   **solve_kw):
    """A frame's plain tracking solve through tracking/tracker.run_gn_rounds,
    the round loop of the summed-Gram mesh tracker and the resident tracker,
    over ops/gn's plain records and Gram -> TrackResult."""
    from psgradientsdf_tpu_torch.ops import gn as tgn
    from psgradientsdf_tpu_torch.tracking import tracker as ttracker

    frame = tgn.GnFrame(geom, torch.as_tensor(depth, dtype=torch.float32,
                                              device=device)[::stride, ::stride],
                        torch.as_tensor(K, dtype=torch.float32, device=device),
                        stride=stride, zmin=zmin, zmax=zmax, vol=vol)
    pose, conv, fail, E_mean, count, iters, _ = ttracker.run_gn_rounds(
        geom, lambda pose: tgn.frame_records(frame, pose),
        lambda pose, rec: tgn.split_gram(
            tgn.gram_plain(frame.points()[0], pose, rec)),
        torch.as_tensor(init_pose, dtype=torch.float32, device=device),
        **solve_kw)
    return ttracker.TrackResult(pose=pose, converged=conv & (~fail),
                                iterations=iters, energy=E_mean, num_valid=count)
