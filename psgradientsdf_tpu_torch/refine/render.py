"""Shading models + fused residual pass for the photometric refinement.

One batched pass computes, for every (surface voxel n, keyframe f):
surface-point projection, bilinear image intensity, rendered intensity
(SH order-1/2 per-keyframe light, PsOptimizerJa.cpp:30-40; or global LED
point light, LedOptimizerJa.cpp:15-29), the residual r = I - render, the
IRLS weight, and the validity mask — the shared structure of
PsOptimizer::computeResidual (PsOptimizerJa.cpp:567-626).

Conventions carried over from the reference:
  * surface point x(v) = c_v - d * normalize(v.grad)  — the *stored*
    volume gradient, not the FD gradient (OptimizerAux.cpp:215);
  * shading normal n(v) = FD gradient of dist, normalized at use
    (renderedIntensity, PsOptimizerJa.cpp:33-35);
  * a voxel-frame pair contributes iff its visibility bit is set AND the
    projection lands inside the image.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.ops.fuse import rot_apply
from psgradientsdf_tpu_torch.ops.image import bilinear_rgb, image_gradient_rgb
from psgradientsdf_tpu_torch.refine import geometry
from psgradientsdf_tpu_torch.refine.problem import RefineProblem
from psgradientsdf_tpu_torch.utils import robust, sh


class ResidualData(NamedTuple):
    r: torch.Tensor          # [N,F,3] residuals (0 where invalid)
    w: torch.Tensor          # [N,F,3] IRLS weights (0 where invalid)
    mask: torch.Tensor       # [N,F] bool contribution mask
    p_cam: torch.Tensor      # [N,F,3] camera-frame surface points
    uv: torch.Tensor         # [N,F,2] float pixel coords (col, row)
    g_img: torch.Tensor      # [N,F,3,2] image gradients (d/du, d/dv) at uv —
                             # computed alongside I by the fused patch fetch
                             # so the Jacobian blocks need no second gather


def surface_points_world(prob: RefineProblem, geom: GridGeometry, dist: torch.Tensor,
                         grad_stored: torch.Tensor) -> torch.Tensor:
    """x(v) = c_v - d * ghat_stored  -> [N,3]."""
    c_v = geom.voxel2world(prob.idx_xyz)
    ghat = geometry.normalize(grad_stored)
    return c_v - dist[:, None] * ghat


def rotate(poses: torch.Tensor, p: torch.Tensor, transpose: bool) -> torch.Tensor:
    """R_f p (or R_f^T p) for every (point, frame): p [N,F,3] -> [N,F,3],
    as ops/fuse.rot_apply's multiply-adds in its fixed order."""
    R = poses[:, :3, :3].permute(1, 2, 0)         # R[i, j] -> [F]
    return torch.stack(rot_apply(R, p[..., 0], p[..., 1], p[..., 2], transpose),
                       dim=-1)


def world_to_cam(pts_w: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """R_f^T (x_n - t_f) for every (point, frame) -> [N,F,3]."""
    return rotate(poses, pts_w[:, None, :] - poses[None, :, :3, 3], transpose=True)


def project_to_frames(
    pts_w: torch.Tensor,    # [N,3]
    poses: torch.Tensor,    # [F,4,4]
    K: torch.Tensor,
    img_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (p_cam [N,F,3], uv [N,F,2] (col,row), in_img [N,F])."""
    H, W = img_hw
    p_cam = world_to_cam(pts_w, poses)
    z = p_cam[..., 2]
    safe_z = torch.where(z.abs() > 1e-12, z, 1e-12)
    u = K[0, 0] * p_cam[..., 0] / safe_z + K[0, 2]
    v = K[1, 1] * p_cam[..., 1] / safe_z + K[1, 2]
    in_img = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return p_cam, torch.stack([u, v], dim=-1), in_img


def sample_intensity(images: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample [F,H,W,3] at uv [N,F,2] -> [N,F,3]."""
    return torch.stack(
        [bilinear_rgb(images[f], uv[:, f, 1], uv[:, f, 0])
         for f in range(images.shape[0])], dim=1)


def sample_image_gradients(images: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Image gradients [N,F,3,2]: last dim = (d/du, d/dv)."""
    out = []
    for f in range(images.shape[0]):
        gu = image_gradient_rgb(images[f], uv[:, f, 1], uv[:, f, 0], axis=0)
        gv = image_gradient_rgb(images[f], uv[:, f, 1], uv[:, f, 0], axis=1)
        out.append(torch.stack([gu, gv], dim=-1))
    return torch.stack(out, dim=1)


def rendered_intensity_sh(
    prob: RefineProblem,
    dist: torch.Tensor,
    albedo: torch.Tensor,
    lights: torch.Tensor,    # [F,B]
    voxel_size: float,
    order: int,
) -> torch.Tensor:
    """rho_c * (l_f . SH(n_hat)) -> [N,F,3] (PsOptimizerJa.cpp:30-40)."""
    n = geometry.normalize(geometry.fd_grad(prob, dist, voxel_size))
    irr = sh.irradiance(sh.sh_basis(n, order), lights)   # [N,F]
    return albedo[:, None, :] * irr[..., None]


def led_reflectance(n: torch.Tensor, p_cam: torch.Tensor,
                    poses: torch.Tensor) -> torch.Tensor:
    """(n^T R p) / max(|p|, 1e-12)^3 -> [N,F] for normals n [N,3] and
    camera points p [N,F,3] (LedOptimizerJa.cpp:15-29, 93-95)."""
    num = geometry.dot3(n[:, None, :], rotate(poses, p_cam, transpose=False))
    pn = torch.clamp(geometry.norm3(p_cam), min=1e-12)
    return num / (pn * pn * pn)


def rendered_intensity_led(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: torch.Tensor,
    albedo: torch.Tensor,
    grad_stored: torch.Tensor,
    light: torch.Tensor,     # [3]
    poses: torch.Tensor,     # [F,4,4]
    voxel_size: float,
) -> torch.Tensor:
    """rho_c * l_c * (-n^T R p / |p|^3) -> [N,F,3] (LedOptimizerJa.cpp:15-29)."""
    p_cam = world_to_cam(surface_points_world(prob, geom, dist, grad_stored), poses)
    n = geometry.normalize(geometry.fd_grad(prob, dist, voxel_size))
    irr = -led_reflectance(n, p_cam, poses)
    return albedo[:, None, :] * light[None, None, :] * irr[..., None]


def compute_residuals(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: torch.Tensor,
    albedo: torch.Tensor,
    grad_stored: torch.Tensor,
    poses: torch.Tensor,
    images: torch.Tensor,     # [F,H,W,3]
    K: torch.Tensor,
    lights,                   # [F,B] (SH) or [3] (LED)
    *,
    model: str,
    order: int,
    loss: int,
    lam: float,
    voxel_size: float,
) -> ResidualData:
    """The fused residual/weight/mask pass (PsOptimizerJa.cpp:567-626): one
    launch of ops/residual.py's kernel on the card, its plain version on the
    CPU."""
    from psgradientsdf_tpu_torch.ops import residual

    return residual.residual_pass(
        prob, geom, dist, albedo, grad_stored, poses, images, K, lights,
        model=model, order=order, loss=loss, lam=lam, voxel_size=voxel_size)


def _per_surface(prob: RefineProblem, total: torch.Tensor) -> torch.Tensor:
    return total / max(float(prob.n_surface), 1.0)


# Each energy is a sum over the surface set divided by the GLOBAL surface
# count; the *_sum forms are the sums alone, which a mesh adds over its
# shards before the one division (parallel/refine.py).

def ps_energy_sum(rd: ResidualData, *, loss: int, lam: float) -> torch.Tensor:
    per = torch.sum(robust.loss_value(rd.r, loss, lam), dim=-1)  # [N,F]
    return torch.sum(torch.where(rd.mask, per, 0.0))


def ps_energy(
    prob: RefineProblem, rd: ResidualData, *, loss: int, lam: float
) -> torch.Tensor:
    """sum of robust losses over visible pairs / n_surface
    (PsOptimizer.cpp:47-78)."""
    return _per_surface(prob, ps_energy_sum(rd, loss=loss, lam=lam))


def normal_energy_sum(prob: RefineProblem, dist: torch.Tensor,
                      voxel_size: float) -> torch.Tensor:
    g = geometry.fd_grad(prob, dist, voxel_size)
    e = (torch.linalg.vector_norm(g, dim=-1) - 1.0) ** 2
    return torch.sum(torch.where(prob.valid, e, 0.0))


def normal_energy(prob: RefineProblem, dist: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """mean (||grad d|| - 1)^2 (Optimizer.cpp:86-103)."""
    return _per_surface(prob, normal_energy_sum(prob, dist, voxel_size))


def laplacian_energy_sum(prob: RefineProblem, dist: torch.Tensor,
                         voxel_size: float) -> torch.Tensor:
    l = geometry.fd_laplacian(prob, dist, voxel_size)
    return torch.sum(torch.where(prob.valid, l * l, 0.0))


def laplacian_energy(prob: RefineProblem, dist: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """mean (lap d)^2 (Optimizer.cpp:106-119)."""
    return _per_surface(prob, laplacian_energy_sum(prob, dist, voxel_size))


def albedo_reg_energy_sum(prob: RefineProblem, albedo: torch.Tensor,
                          voxel_size: float) -> torch.Tensor:
    g = geometry.fd_albedo_grad(prob, albedo, voxel_size)   # [N,3(axis),3(chan)]
    # reference: row-wise norms of the 3x3 (channel-major) gradient,
    # i.e. per-channel norm over axes
    per_chan = torch.linalg.vector_norm(g, dim=1)           # [N,3(chan)]
    e = torch.sum(per_chan, dim=-1)
    return torch.sum(torch.where(prob.valid, e, 0.0))


def albedo_reg_energy(prob: RefineProblem, albedo: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """mean over voxels of sum of per-channel grad norms (Optimizer.cpp:122-136)."""
    return _per_surface(prob, albedo_reg_energy_sum(prob, albedo, voxel_size))
