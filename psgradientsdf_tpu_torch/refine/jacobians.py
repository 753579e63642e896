"""Analytic Jacobian blocks for the photometric refinement (SH + LED).

Dense batched re-derivations of the reference's per-(voxel,frame) sparse
Jacobian assembly (cpp/include/ps_optimizer/PsOptimizerJa.cpp:61-289 for SH,
LedOptimizerJa.cpp:32-218 for LED).  Instead of triplet lists + O(N)
std::find column lookups, every block is a dense [N,F,...] tensor whose
sparse structure (self + <=3 stencil neighbors for distance) is realized by
precomputed compact neighbor indices — the scatter/gather work of applying
J^T is in solvers.py.

Shared pieces:
  image_pi_grad [N,F,3,3]: dI/dx = (image gradient at the reprojection) o
  (projection Jacobian) — PsOptimizerJa.cpp:78-90.

The distance block's Jacobian (dist_jacobian_sh / _led, over
_reprojection_terms) writes every sum out in a fixed order (geometry.dot3,
sh.irradiance), so that csrc/residual.cu's dist_jacobian_kernel equals it on
the card bit for bit; ops/residual.dist_jacobian is the call that picks the
kernel on the card and these functions on the CPU.

Deviations from the reference (documented, deliberate):
  * LED distance Jacobian: the reference flips the sign of the neighbor
    normal-perturbation directions vs the SH path (LedOptimizerJa.cpp:
    157-167 uses += where PsOptimizerJa.cpp:200-210 uses -=); the SH
    convention is the mathematically correct derivative of the one-sided FD
    normal, so both models use it here (held against automatic
    differentiation of the residual in the tests).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.refine import geometry
from psgradientsdf_tpu_torch.refine.problem import RefineProblem
from psgradientsdf_tpu_torch.refine.render import (
    ResidualData,
    led_reflectance,
    rotate,
    surface_points_world,
    world_to_cam,
)
from psgradientsdf_tpu_torch.utils import se3, sh


def image_pi_grad(rd: ResidualData, K: torch.Tensor) -> torch.Tensor:
    """dI/dx_cam [N,F,3,3]: image gradient composed with projection gradient
    (PsOptimizerJa.cpp:78-90).  The image gradients ride the residual pass
    (rd.g_img)."""
    g_img = rd.g_img                                  # [N,F,3,2] (du, dv)
    fx, fy = K[0, 0], K[1, 1]
    z = rd.p_cam[..., 2]
    z_inv = 1.0 / torch.where(z.abs() > 1e-12, z, 1e-12)
    z_inv_sq = z_inv * z_inv
    # G[...,c,:] = gu*row_u + gv*row_v with row_u = [fx/z, 0, -fx*px/z^2],
    # row_v = [0, fy/z, -fy*py/z^2] — expanded directly
    gu = g_img[..., 0]                                # [N,F,3]
    gv = g_img[..., 1]
    gx = gu * (fx * z_inv)[..., None]
    gy = gv * (fy * z_inv)[..., None]
    gz = -(
        gu * (fx * rd.p_cam[..., 0] * z_inv_sq)[..., None]
        + gv * (fy * rd.p_cam[..., 1] * z_inv_sq)[..., None]
    )
    return torch.stack([gx, gy, gz], dim=-1)


def pose_jacobian_sh(
    G: torch.Tensor,        # [N,F,3,3] image_pi_grad
    rd: ResidualData,
    poses: torch.Tensor,    # [F,4,4]
) -> torch.Tensor:
    """J_c [N,F,3,6] = [-G R^T | G skew(p_cam)] (PsOptimizerJa.cpp:109-110)."""
    R = poses[:, :3, :3]
    left = -torch.einsum("nfcx,fyx->nfcy", G, R)   # -G R^T
    right = G @ se3.hat(rd.p_cam)
    return torch.cat([left, right], dim=-1)


def pose_jacobian_led(
    G: torch.Tensor,
    rd: ResidualData,
    poses: torch.Tensor,
    albedo: torch.Tensor,        # [N,3]
    grad_stored: torch.Tensor,   # [N,3]
    light: torch.Tensor,         # [3]
) -> torch.Tensor:
    """LED pose Jacobian with the near-field extra terms
    (LedOptimizerJa.cpp:63-78), in the corrected form (documented
    deviation — see module docstring):

    The irradiance m = -n^T R p / |p|^3 depends on the pose only through
    the world ray x - t = R p_cam (|p_cam| = |x - t|), so
      * translation: d(rendered)/dxi_t = rho l (-n/L^3 + 3 (n.d) d / L^5)
        with d = R p_cam — the reference carries only the first term and
        parks the radius-falloff in a rotation expression;
      * rotation: m is INVARIANT (R p_cam independent of the R update) —
        the reference's extra rotation term hat(p) p is identically the
        zero vector (p x p), so dropping it changes nothing numerically.
    As everywhere in the refinement, n is the normalized stored gradient,
    which the reference's updateGrad keeps equal to the FD shading normal
    after every distance update."""
    R = poses[:, :3, :3]
    base_left = -torch.einsum("nfcx,fyx->nfcy", G, R)
    base_right = G @ se3.hat(rd.p_cam)

    normal = geometry.normalize(grad_stored)          # [N,3]
    pn = torch.clamp(torch.linalg.vector_norm(rd.p_cam, dim=-1), min=1e-12)
    l3 = pn ** 3
    l5 = pn ** 5
    rho_l = albedo * light[None, :]                   # [N,3]
    Rp = torch.einsum("fij,nfj->nfi", R, rd.p_cam)    # world ray x - t
    nRp = torch.einsum("ni,nfi->nf", normal, Rp)
    term_vec = (
        -normal[:, None, :] / l3[..., None]
        + 3.0 * nRp[..., None] * Rp / l5[..., None]
    )                                                 # [N,F,3vec]
    led_t = rho_l[:, None, :, None] * term_vec[:, :, None, :]
    return torch.cat([base_left + led_t, base_right], dim=-1)


def albedo_jacobian_sh(
    prob: RefineProblem, grad_stored: torch.Tensor, lights: torch.Tensor, order: int
) -> torch.Tensor:
    """J_rho [N,F] scalar (same for all channels): -l_f . SH(ghat_stored)
    (PsOptimizerJa.cpp:118-122)."""
    n = geometry.normalize(grad_stored)
    return -sh.irradiance(sh.sh_basis(n, order), lights)


def albedo_jacobian_led(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: torch.Tensor,
    grad_stored: torch.Tensor,
    poses: torch.Tensor,
    light: torch.Tensor,
) -> torch.Tensor:
    """LED J_rho [N,F,3]: +(n^T R p / |p|^3) * l (LedOptimizerJa.cpp:85-99)."""
    refl = _led_reflectance(prob, geom, dist, grad_stored, poses)   # [N,F]
    return refl[..., None] * light[None, None, :]


def light_jacobian_sh(
    prob: RefineProblem, albedo: torch.Tensor, grad_stored: torch.Tensor, order: int
) -> torch.Tensor:
    """J_l [N,3,B], frame-independent: channel c row = -rho_c SH(ghat_stored)
    (PsOptimizerJa.cpp:132-143)."""
    n = geometry.normalize(grad_stored)
    basis = sh.sh_basis(n, order)               # [N,B]
    return -albedo[..., None] * basis[:, None, :]


def light_jacobian_led(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: torch.Tensor,
    grad_stored: torch.Tensor,
    albedo: torch.Tensor,
    poses: torch.Tensor,
) -> torch.Tensor:
    """LED J_light [N,F,3]: +(n^T R p / |p|^3) * rho_c
    (LedOptimizerJa.cpp:101-115)."""
    refl = _led_reflectance(prob, geom, dist, grad_stored, poses)
    return refl[..., None] * albedo[:, None, :]


def _led_reflectance(prob, geom, dist, grad_stored, poses):
    """(n^T R p) / |p|^3 with n = ghat_stored (LedOptimizerJa.cpp:93-95)."""
    pts_w = surface_points_world(prob, geom, dist, grad_stored)
    return led_reflectance(geometry.normalize(grad_stored),
                           world_to_cam(pts_w, poses), poses)


class DistJacobian(NamedTuple):
    J0: torch.Tensor    # [N,F,3] d r / d d_self
    Ji: torch.Tensor    # [N,3,F,3] d r / d d_neighbor(axis)


def _reprojection_terms(prob, dist, grad_stored, G, poses, voxel_size):
    """The part both shading models share: how the reprojected intensity
    moves with the stencil's distances -> (grad_fd, dn_d0, dn_di, dx_d0,
    dx_di, dI0 [N,F,3], dIi [N,3,F,3]).  G R^T is formed first, then each
    dI is its product with dx, every sum over the last axis in dot3's
    order."""
    grad_fd = geometry.fd_grad(prob, dist, voxel_size)        # [N,3]
    dn_d0, dn_di = geometry.dn_stencil(prob, grad_fd, voxel_size)  # [N,3], [N,3,3]
    ghat_stored = geometry.normalize(grad_stored)
    # (G R^T)[c, y] = G[c, :] . R[y, :]
    GRt = geometry.dot3(G[..., :, None, :], poses[None, :, None, :3, :3])

    dx_d0 = -ghat_stored - dist[:, None] * dn_d0              # [N,3]
    dI0 = geometry.dot3(GRt, dx_d0[:, None, None, :])         # [N,F,3]
    dx_di = -dist[:, None, None] * dn_di                      # [N,3(axis),3]
    dIi = geometry.dot3(GRt[:, None], dx_di[:, :, None, None, :])   # [N,3,F,3]
    return grad_fd, dn_d0, dn_di, dx_d0, dx_di, dI0, dIi


def dist_jacobian_sh(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: torch.Tensor,
    albedo: torch.Tensor,
    grad_stored: torch.Tensor,
    lights: torch.Tensor,
    G: torch.Tensor,          # [N,F,3,3] image_pi_grad
    poses: torch.Tensor,
    voxel_size: float,
    order: int,
) -> DistJacobian:
    """SH distance Jacobian: reprojection-shift + shading-normal coupling
    over the 4-voxel stencil (PsOptimizerJa.cpp:160-289)."""
    grad_fd, dn_d0, dn_di, _, _, dI0, dIi = _reprojection_terms(
        prob, dist, grad_stored, G, poses, voxel_size)

    if order == 1:
        # d(l . SH1(n)) = l[1:4] . dn, times rho_c
        l13 = lights[:, 1:4]
        dS0 = geometry.dot3(dn_d0[:, None, :], l13)                   # [N,F]
        dSi = geometry.dot3(dn_di[:, :, None, :], l13)                # [N,3,F]
    else:
        # dSH = dsh^T dn (over y), then l . dSH (over b)
        dshT = sh.dsh_dn(geometry.normalize(grad_fd), 2).transpose(-1, -2)  # [N,9,3]
        dSH0 = geometry.dot3(dshT, dn_d0[:, None, :])                 # [N,9]
        dSHi = geometry.dot3(dshT[:, None], dn_di[:, :, None, :])     # [N,3,9]
        dS0 = sh.irradiance(dSH0, lights)                             # [N,F]
        dSi = sh.irradiance(dSHi, lights)                             # [N,3,F]
    shade0 = albedo[:, None, :] * dS0[..., None]               # [N,F,3]
    shadei = albedo[:, None, None, :] * dSi[..., None]         # [N,3,F,3]

    return DistJacobian(J0=dI0 - shade0, Ji=dIi - shadei)


def dist_jacobian_led(
    prob: RefineProblem,
    geom: GridGeometry,
    dist: torch.Tensor,
    albedo: torch.Tensor,
    grad_stored: torch.Tensor,
    light: torch.Tensor,
    G: torch.Tensor,
    poses: torch.Tensor,
    voxel_size: float,
) -> DistJacobian:
    """LED distance Jacobian with attenuation chain rule
    (LedOptimizerJa.cpp:117-218; neighbor-direction sign corrected, see
    module docstring)."""
    grad_fd, dn_d0, dn_di, dx_d0, dx_di, dI0, dIi = _reprojection_terms(
        prob, dist, grad_stored, G, poses, voxel_size)
    n_fd = geometry.normalize(grad_fd)

    p_cam = world_to_cam(surface_points_world(prob, geom, dist, grad_stored), poses)
    Rp = rotate(poses, p_cam, transpose=False)                # [N,F,3]
    pn = torch.clamp(geometry.norm3(p_cam), min=1e-12)
    radius = pn * pn * pn
    pn5 = radius * pn * pn
    m_val = geometry.dot3(n_fd[:, None, :], Rp)               # n_fd^T R p

    def m_terms(dn, dx):
        # dn [N,3], dx [N,3] -> dm [N,F]
        t1 = geometry.dot3(dn[:, None, :], Rp)
        t2 = geometry.dot3(n_fd, dx)[:, None]
        num = t1 + t2
        # radius part: -3 (p^T R^T dx)/|p|^5 = -3 (Rp . dx)/|p|^5
        rad = -3.0 * geometry.dot3(Rp, dx[:, None, :]) / pn5
        return num / radius + rad * m_val

    dm0 = m_terms(dn_d0, dx_d0)
    dR_vec = albedo * light[None, :]                          # [N,3]
    J0 = dI0 + dR_vec[:, None, :] * dm0[..., None]

    Ji_list = []
    for ax in range(3):
        dmi = m_terms(dn_di[:, ax], dx_di[:, ax])
        Ji_list.append(dIi[:, ax] + dR_vec[:, None, :] * dmi[..., None])
    return DistJacobian(J0=J0, Ji=torch.stack(Ji_list, dim=1))
