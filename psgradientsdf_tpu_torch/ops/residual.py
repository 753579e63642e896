"""The refinement's residual pass and the distance block's Jacobian: one
launch each of the hand-written Hopper kernels in csrc/residual.cu, or their
plain PyTorch versions for CPU tensors.

  residual_pass(prob, geom, dist, albedo, grad_stored, poses, images, K,
                lights, *, model, order, loss, lam, voxel_size)
      -> ResidualData(r, w, mask, p_cam, uv, g_img)
  dist_jacobian(prob, geom, rd, dist, albedo, grad_stored, poses, K, lights,
                *, model, order, voxel_size, with_G=False)
      -> (G [N,F,3,3] or None, DistJacobian(J0, Ji))

residual_pass replaces the JAX package's psgradientsdf_tpu/refine/
optimizer.py `_residuals` (:52) -> refine/render.py `compute_residuals`
(:127) with its 3x3 patch fetch (refine/patches.py `sample_patch_all`
:135); dist_jacobian replaces refine/jacobians.py `image_pi_grad` (:44) with
`dist_jacobian_sh` (:193) / `dist_jacobian_led` (:238) as optimizer.py's
`_dist_block` (:186) and `_joint_dp_core` (:276) run them.  The kernel reads
the keyframe images [F,H,W,3] directly: no span table is built on the card.
The plain versions are the port of those functions (refine/render.py,
patches.py, jacobians.py) with every sum written out in a fixed order, and
the kernels equal them on the card bit for bit: the same operations in the
same order, each rounded once.  dist_jacobian reads rd's p_cam and g_img,
which must be the residual pass at the same state (as in the refiner's
loop); G, the image gradient composed with the projection, is computed on
the way and returned only when asked for (the joint step's pose Jacobian).

On the card the work is cut into tiles planned here (`_tile_plan`): V
consecutive voxels x all F keyframes, or one voxel x a range of keyframes
where F is large, so that a tile's pairs are one contiguous span of each
output; the residual pass stages a tile's outputs in shared memory and
writes each span with one bulk copy.  It reads the keyframe images as they
are, [F,H,W,3].

A wrapper takes the plain version ONLY for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  `launch_counts` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from psgradientsdf_tpu_torch.config import LED
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.refine import jacobians, patches, render
from psgradientsdf_tpu_torch.refine.jacobians import DistJacobian
from psgradientsdf_tpu_torch.refine.problem import RefineProblem
from psgradientsdf_tpu_torch.refine.render import ResidualData
from psgradientsdf_tpu_torch.utils import robust

_LIB_NAME = "residual"
launch_counts: Dict[str, int] = {"residual_pass": 0, "dist_jacobian": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# the plain PyTorch versions
# ---------------------------------------------------------------------------


def residual_pass_plain(prob: RefineProblem, geom: GridGeometry, dist, albedo,
                        grad_stored, poses, images, K, lights, *, model: str,
                        order: int, loss: int, lam: float,
                        voxel_size: float) -> ResidualData:
    """The residual pass with eager PyTorch ops (PsOptimizerJa.cpp:567-626):
    projection, the fused 3x3 patch fetch (intensity and image gradients),
    the shading, the mask, the residual and its IRLS weight."""
    H, W = images.shape[1], images.shape[2]
    pts_w = render.surface_points_world(prob, geom, dist, grad_stored)
    p_cam, uv, in_img = render.project_to_frames(pts_w, poses, K, (H, W))
    I, g_img = patches.sample_patch_all(images, uv)
    if model == LED:
        rendered = render.rendered_intensity_led(
            prob, geom, dist, albedo, grad_stored, lights, poses, voxel_size)
    else:
        rendered = render.rendered_intensity_sh(prob, dist, albedo, lights,
                                                voxel_size, order)
    mask = prob.vis & in_img & prob.valid[:, None]
    r = torch.where(mask[..., None], I - rendered, 0.0)
    w = torch.where(mask[..., None], robust.irls_weight(r, loss, lam), 0.0)
    return ResidualData(r=r, w=w, mask=mask, p_cam=p_cam, uv=uv, g_img=g_img)


def dist_jacobian_plain(prob: RefineProblem, geom: GridGeometry,
                        rd: ResidualData, dist, albedo, grad_stored, poses, K,
                        lights, *, model: str, order: int, voxel_size: float,
                        with_G: bool = False
                        ) -> Tuple[Optional[torch.Tensor], DistJacobian]:
    """The distance block's Jacobian with eager PyTorch ops: image_pi_grad,
    then dist_jacobian_sh / dist_jacobian_led."""
    G = jacobians.image_pi_grad(rd, K)
    if model == LED:
        DJ = jacobians.dist_jacobian_led(prob, geom, dist, albedo, grad_stored,
                                         lights, G, poses, voxel_size)
    else:
        DJ = jacobians.dist_jacobian_sh(prob, geom, dist, albedo, grad_stored,
                                        lights, G, poses, voxel_size, order)
    return (G if with_G else None), DJ


# ---------------------------------------------------------------------------
# the tile plan
# ---------------------------------------------------------------------------

# pairs a tile, at most (P), and voxels a tile, at most.  A block is 8
# consumer warps (256 threads) and 2 service warps; its shared memory holds
# four buffers of the voxel terms and two of the frame terms (and of the
# pass's staged outputs), so that a service warp fills one tile's while the
# consumers run the other.  The plan asks for the shared-memory carveout
# that holds BLOCKS_PER_SM blocks and leaves the rest of the SM's 256 KB to
# the L1 cache, which the pass's pixel reads hit: the pass takes P = 256 (a
# pair a consumer thread, 33 KB of staging) at three blocks an SM, the
# Jacobian P = 512 (it stages nothing, reads no pixel, and its service
# warps' per-voxel terms are the longer) at two, the best of both on an H100
# (PERF.md).  Every plan fits a block: at most 78,912 bytes for the pass and
# 86,976 for the Jacobian (frame-range tiles).
PAIRS_PER_TILE = {"residual": 256, "jacobian": 512}
BLOCKS_PER_SM = {"residual": 3, "jacobian": 2}
BLOCK_THREADS = 320              # csrc/residual.cu kThreads
MAX_TILE_VOXELS = 64
SMEM_PER_BLOCK = 232448          # an H100 block's shared memory, at most
SMEM_PER_SM = 233472             # an H100 SM's shared memory, at most
_SMEM_RESERVED = 1024            # the system's shared memory a block
_BARRIER_BYTES = 64              # the four mbarriers (32 bytes), at offset 0
# floats a voxel's terms take in shared memory (an odd stride: no bank
# conflicts when a warp spans several voxels), and a frame's (R, t and an
# SH light of up to 9 coefficients; odd too)
_VOX_FLOATS = {"residual": 17, "jacobian": 53}
_VOX_BUFFERS = 4                 # csrc/residual.cu kVoxBuffers
_FRAME_FLOATS = 21
# bytes a pair of each of the pass's staged outputs, in the kernel's order:
# r, w, mask, p_cam, uv, g_img
_OUT_BYTES = (12, 12, 1, 12, 8, 24)


class TilePlan(NamedTuple):
    """csrc/residual.cu TilePlan: the tiles, and the byte offsets of a
    block's shared-memory regions (every region 16-byte aligned; a span is
    staged at its global address modulo 16, so a staged output's region
    holds its pairs and 16 bytes more)."""
    voxels: int            # V: voxels a tile (1 for a frame-range tile)
    frames: int            # FT: frames a tile (F, or a range when V = 1)
    tiles: int
    smem_bytes: int
    vox: int               # the voxel terms (_VOX_BUFFERS buffers: a service
                           # warp writes a tile's while its last tile's are read)
    vox_bytes: int
    frm: int               # the frame terms (two buffers)
    frm_bytes: int
    stage: int             # the pass's staged outputs (two buffers; the
    stage_bytes: int       # Jacobian: 0, 0)
    outputs: Tuple[int, ...]           # six regions in a staging buffer
    carveout: int          # shared memory asked of the SM, percent of SMEM_PER_SM


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def _tile_plan(N: int, F: int, *, kernel: str = "residual") -> TilePlan:
    """The tiles of N voxels x F keyframes for `kernel` ("residual" or
    "jacobian") and a block's shared memory.  A tile is V = min(P // F,
    MAX_TILE_VOXELS, N) whole voxels x all F frames when F <= P, else one
    voxel x P frames (the last range shorter): in both cases a tile's pairs
    are one contiguous span of the [N, F] layout."""
    P = PAIRS_PER_TILE[kernel]
    if F <= P:
        V, FT = max(1, min(MAX_TILE_VOXELS, P // F, N)), F
    else:
        V, FT = 1, P
    off = _BARRIER_BYTES
    vox, vox_bytes = off, _up16(V * _VOX_FLOATS[kernel] * 4)
    off += _VOX_BUFFERS * vox_bytes
    frm, frm_bytes = off, _up16(FT * _FRAME_FLOATS * 4)
    off += 2 * frm_bytes
    stage, stage_bytes, outputs = 0, 0, [0] * len(_OUT_BYTES)
    if kernel == "residual":
        stage = off
        for k, per_pair in enumerate(_OUT_BYTES):
            outputs[k] = stage_bytes
            stage_bytes += _up16(V * FT * per_pair + 16)
        off += 2 * stage_bytes
    need = min(BLOCKS_PER_SM[kernel] * (off + _SMEM_RESERVED), SMEM_PER_SM)
    return TilePlan(V, FT, -(-N // V) * -(-F // FT), off, vox, vox_bytes, frm,
                    frm_bytes, stage, stage_bytes, tuple(outputs),
                    -(-100 * need // SMEM_PER_SM))


# ---------------------------------------------------------------------------
# argument checks and the library binding
# ---------------------------------------------------------------------------


class _TilePlan(ctypes.Structure):
    """csrc/residual.cu TilePlan, field for field."""
    _fields_ = ([(n, ctypes.c_int64) for n in TilePlan._fields[:10]]
                + [("outputs", ctypes.c_int64 * 6), ("carveout", ctypes.c_int64)])


def _c_plan(plan: TilePlan) -> _TilePlan:
    return _TilePlan(*plan[:10], tuple(plan.outputs), plan.carveout)


class _ResidualArgs(ctypes.Structure):
    """csrc/residual.cu ResidualArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("idx_xyz", "dist", "albedo", "grad", "nbr_idx", "nbr_dist_const",
          "nbr_dir", "valid", "vis", "poses", "lights", "images", "K", "r", "w",
          "mask", "p_cam", "uv", "g_img")]
        + [(n, ctypes.c_int64) for n in ("N", "F", "H", "W", "led", "basis", "loss")]
        + [(n, ctypes.c_double) for n in
           ("origin_x", "origin_y", "origin_z", "voxel", "lam")]
        + [("plan", _TilePlan), ("grid_voxel", ctypes.c_double)])


class _JacobianArgs(ctypes.Structure):
    """csrc/residual.cu JacobianArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("dist", "albedo", "grad", "nbr_idx", "nbr_dist_const", "nbr_dir",
          "p_cam", "g_img", "poses", "lights", "K", "J0", "Ji", "G")]
        + [(n, ctypes.c_int64) for n in ("N", "F", "led", "basis")]
        + [("voxel", ctypes.c_double), ("plan", _TilePlan)])


def _check(what: str, dev, tensors) -> None:
    """tensors: {name: (tensor, shape, dtype)}; all on `dev`."""
    for name, (t, shape, dtype) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, dist on {dev}")


def _voxel_inputs(prob: RefineProblem, dist, albedo, grad_stored):
    N = dist.shape[0]
    f32 = torch.float32
    return {"dist": (dist, (N,), f32), "albedo": (albedo, (N, 3), f32),
            "grad_stored": (grad_stored, (N, 3), f32),
            "nbr_idx": (prob.nbr_idx, (N, 3), torch.int64),
            "nbr_dist_const": (prob.nbr_dist_const, (N, 3), f32),
            "nbr_dir": (prob.nbr_dir, (N, 3), f32)}


def _lights_shape(model: str, order: int, F: int):
    """(shape of lights, number of SH coefficients; 0 for the LED)."""
    if model == LED:
        return (3,), 0
    if order not in (1, 2):
        raise ValueError(f"unsupported SH order {order}")
    B = 4 if order == 1 else 9
    return (F, B), B


_bound = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C interface's argument types on a library built from
    csrc/residual.cu."""
    lib.residual_pass.argtypes = [ctypes.POINTER(_ResidualArgs), ctypes.c_void_p]
    lib.residual_pass.restype = ctypes.c_int
    lib.dist_jacobian.argtypes = [ctypes.POINTER(_JacobianArgs), ctypes.c_void_p]
    lib.dist_jacobian.restype = ctypes.c_int
    lib.residual_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                           ctypes.POINTER(ctypes.c_int)]
    lib.residual_blocks_per_sm.restype = ctypes.c_int
    return lib


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        _bound = _bind(load_library(_LIB_NAME))
    return _bound


def blocks_per_sm(kernel: str, plan: TilePlan, device) -> int:
    """The blocks of `kernel` ("residual" or "jacobian") an SM of `device`
    holds at the plan's shared memory and carveout."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _library().residual_blocks_per_sm(int(kernel == "jacobian"),
                                               plan.smem_bytes, plan.carveout,
                                               ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"{kernel}: {plan.smem_bytes} bytes of shared memory "
                           f"refused, CUDA error {rc}")
    return out.value


def _launch(fn, args, dev, name: str) -> None:
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    launch_counts[name] += 1


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def residual_pass(prob: RefineProblem, geom: GridGeometry, dist, albedo,
                  grad_stored, poses, images, K, lights, *, model: str,
                  order: int, loss: int, lam: float,
                  voxel_size: float) -> ResidualData:
    """The residual pass of every (surface voxel, keyframe) pair (see the
    module docstring): one kernel launch on CUDA tensors, the plain version
    on CPU tensors."""
    kw = dict(model=model, order=order, loss=loss, lam=lam, voxel_size=voxel_size)
    if dist.device.type == "cpu":
        return residual_pass_plain(prob, geom, dist, albedo, grad_stored, poses,
                                   images, K, lights, **kw)
    N = dist.shape[0]
    F, H, W = images.shape[0], images.shape[1], images.shape[2]
    lshape, B = _lights_shape(model, order, F)
    want = _voxel_inputs(prob, dist, albedo, grad_stored)
    want.update({
        "idx_xyz": (prob.idx_xyz, (N, 3), torch.int32),
        "valid": (prob.valid, (N,), torch.bool),
        "vis": (prob.vis, (N, F), torch.bool),
        "poses": (poses, (F, 4, 4), torch.float32),
        "images": (images, (F, H, W, 3), torch.float32),
        "K": (K, (3, 3), torch.float32),
        "lights": (lights, lshape, torch.float32)})
    dev = dist.device
    _check("residual_pass", dev, want)
    if loss not in (robust.L2, robust.CAUCHY, robust.HUBER, robust.TUKEY,
                    robust.TRUNC_L2):
        raise ValueError(f"residual_pass: unknown loss id {loss}")
    ins = {k: t.contiguous() for k, (t, _, _) in want.items()}
    out = ResidualData(
        r=torch.empty((N, F, 3), dtype=torch.float32, device=dev),
        w=torch.empty((N, F, 3), dtype=torch.float32, device=dev),
        mask=torch.empty((N, F), dtype=torch.bool, device=dev),
        p_cam=torch.empty((N, F, 3), dtype=torch.float32, device=dev),
        uv=torch.empty((N, F, 2), dtype=torch.float32, device=dev),
        g_img=torch.empty((N, F, 3, 2), dtype=torch.float32, device=dev))
    a = _ResidualArgs()
    for name in ("idx_xyz", "dist", "albedo", "nbr_idx", "nbr_dist_const",
                 "nbr_dir", "valid", "vis", "poses", "lights", "images", "K"):
        setattr(a, name, ins[name].data_ptr())
    a.grad = ins["grad_stored"].data_ptr()
    for name, t in zip(out._fields, out):
        setattr(a, name, t.data_ptr())
    a.N, a.F, a.H, a.W = N, F, H, W
    a.led, a.basis, a.loss = int(model == LED), B, int(loss)
    a.origin_x, a.origin_y, a.origin_z = geom.origin
    # the voxel centres on the grid's spacing, the finite differences on the
    # caller's voxel_size (they part after the loop's upsample), as the
    # plain version computes them
    a.grid_voxel = float(geom.voxel_size)
    a.voxel, a.lam = float(voxel_size), float(lam)
    a.plan = _c_plan(_tile_plan(N, F, kernel="residual"))
    _launch(_library().residual_pass, a, dev, "residual_pass")
    return out


def dist_jacobian(prob: RefineProblem, geom: GridGeometry, rd: ResidualData,
                  dist, albedo, grad_stored, poses, K, lights, *, model: str,
                  order: int, voxel_size: float, with_G: bool = False
                  ) -> Tuple[Optional[torch.Tensor], DistJacobian]:
    """The distance block's Jacobian of every pair from the residual pass
    `rd` at the same state (see the module docstring): one kernel launch on
    CUDA tensors, the plain version on CPU tensors."""
    if dist.device.type == "cpu":
        return dist_jacobian_plain(prob, geom, rd, dist, albedo, grad_stored,
                                   poses, K, lights, model=model, order=order,
                                   voxel_size=voxel_size, with_G=with_G)
    N, F = rd.p_cam.shape[0], rd.p_cam.shape[1]
    lshape, B = _lights_shape(model, order, F)
    want = _voxel_inputs(prob, dist, albedo, grad_stored)
    want.update({
        "p_cam": (rd.p_cam, (N, F, 3), torch.float32),
        "g_img": (rd.g_img, (N, F, 3, 2), torch.float32),
        "poses": (poses, (F, 4, 4), torch.float32),
        "K": (K, (3, 3), torch.float32),
        "lights": (lights, lshape, torch.float32)})
    dev = dist.device
    _check("dist_jacobian", dev, want)
    ins = {k: t.contiguous() for k, (t, _, _) in want.items()}
    J0 = torch.empty((N, F, 3), dtype=torch.float32, device=dev)
    Ji = torch.empty((N, 3, F, 3), dtype=torch.float32, device=dev)
    G = torch.empty((N, F, 3, 3), dtype=torch.float32, device=dev) if with_G else None
    a = _JacobianArgs()
    for name in ("dist", "albedo", "nbr_idx", "nbr_dist_const", "nbr_dir",
                 "p_cam", "g_img", "poses", "lights", "K"):
        setattr(a, name, ins[name].data_ptr())
    a.grad = ins["grad_stored"].data_ptr()
    a.J0, a.Ji = J0.data_ptr(), Ji.data_ptr()
    a.G = None if G is None else G.data_ptr()
    a.N, a.F, a.led, a.basis = N, F, int(model == LED), B
    a.voxel = float(voxel_size)
    a.plan = _c_plan(_tile_plan(N, F, kernel="jacobian"))
    _launch(_library().dist_jacobian, a, dev, "dist_jacobian")
    return G, DistJacobian(J0=J0, Ji=Ji)
