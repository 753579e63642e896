"""Finite-difference stencil geometry on the compacted surface set.

The shared building blocks of the refinement energies/Jacobians:
one-sided distance/albedo gradients (Optimizer.cpp computeDistGrad:287-364,
computeAlbedoGrad:396-460), the 6-point Laplacian (computeDistLaplacian:
368-393), and the normal-from-distance Jacobians (normalJacobian:251-284).

All functions are dense over [N] compacted surface voxels; frozen
(non-surface) stencil neighbors come from precomputed constants in
RefineProblem — no searches, no scatter, pure gathers.

Every sum over the three axes is written out as (a0 b0 + a1 b1) + a2 b2
(dot3; a norm's as a fused multiply-add chain, norm3), and the Laplacian's
six neighbours left to right, never a library reduction, so that every
device rounds it alike and the kernels (csrc/residual.cu, csrc/distreg.cu)
can equal these functions on the card bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from psgradientsdf_tpu_torch.refine.problem import RefineProblem


def gather_nbr(x: torch.Tensor, nbr_idx: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """x[nbr] with frozen fallback: nbr_idx [N,K] (-1 -> const), x [N] or [N,C].

    Returns [N,K] (or [N,K,C])."""
    safe = torch.clamp(nbr_idx, min=0)
    g = x[safe]
    if x.ndim == 2:
        return torch.where((nbr_idx >= 0)[..., None], g, const)
    return torch.where(nbr_idx >= 0, g, const)


def fd_grad(prob: RefineProblem, dist: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """One-sided FD gradient n_i = dir_i * (d_nbr_i - d0) / h -> [N,3]."""
    d_nbr = gather_nbr(dist, prob.nbr_idx, prob.nbr_dist_const)   # [N,3]
    return prob.nbr_dir * (d_nbr - dist[:, None]) / voxel_size


def fd_albedo_grad(prob: RefineProblem, albedo: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """One-sided FD albedo gradient -> [N,3,3] = [voxel, axis, channel]."""
    a_nbr = gather_nbr(albedo, prob.nbr_idx, prob.nbr_albedo_const)  # [N,3,3]
    return prob.nbr_dir[..., None] * (a_nbr - albedo[:, None, :]) / voxel_size


def fd_laplacian(prob: RefineProblem, dist: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """(d_x+ + d_x- + d_y+ + d_y- + d_z+ + d_z- - 6 d) / h^2 -> [N], the six
    neighbours summed left to right."""
    d_nbr = gather_nbr(dist, prob.lap_idx, prob.lap_dist_const)   # [N,6]
    s = d_nbr[:, 0]
    for k in range(1, 6):
        s = s + d_nbr[:, k]
    return (s - 6.0 * dist) / (voxel_size * voxel_size)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over a last axis of 3 (broadcast): (a0 b0 + a1 b1) + a2 b2."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(v: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm over a last axis of 3 as the CPU's vector_norm
    (and XLA's) evaluates it: the squares summed as the fused multiply-add
    chain s = fma(v2, v2, fma(v1, v1, v0 v0)), then the correctly rounded
    root.  Each fma is the exact product plus s in float64 and the root is
    taken in float64, each rounded once to v's type (the CPU's float32
    torch.sqrt is not correctly rounded), so that every device rounds it
    alike."""
    w = v.double()
    s = v[..., 0] * v[..., 0]
    s = (w[..., 1] * w[..., 1] + s.double()).to(v.dtype)
    s = (w[..., 2] * w[..., 2] + s.double()).to(v.dtype)
    return torch.sqrt(s.double()).to(v.dtype)


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(norm3(v), min=eps)[..., None]


def normal_jacobian(
    grad: torch.Tensor, direction: torch.Tensor, voxel_size: float, lag: bool = False
) -> torch.Tensor:
    """d(normalized FD grad)/d(dist entry) for a perturbation `direction`.

    Mirrors Optimizer::normalJacobian (Optimizer.cpp:269-284):
      n_d   = -direction / h
      N_inv = 1 / max(||grad||, 1e-3)
      J     = N_inv * n_d - N_inv^3 (n_d . grad) grad     (lag=False)

    grad, direction: [...,3].
    """
    n_d = -direction / voxel_size
    N_inv = 1.0 / torch.clamp(norm3(grad), min=1e-3)[..., None]
    if lag:
        return N_inv * n_d
    dN = (N_inv * N_inv * N_inv) * dot3(n_d, grad)[..., None]
    return N_inv * n_d - dN * grad


def dn_stencil(
    prob: RefineProblem, grad: torch.Tensor, voxel_size: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normal Jacobians for the 4-entry FD stencil.

    Returns (dn_d0 [N,3], dn_di [N,3,3]) where dn_d0 is d n_hat/d d0
    (direction = +pos, PsOptimizerJa.cpp:198) and dn_di[:,i] is d n_hat/d d_i
    (direction = -pos_i e_i, PsOptimizerJa.cpp:200-210).
    """
    pos = prob.nbr_dir                       # [N,3]
    dn_d0 = normal_jacobian(grad, pos, voxel_size)
    eye = torch.eye(3, dtype=grad.dtype, device=grad.device)
    # direction for neighbor i: -pos_i * e_i
    dirs = -pos[..., None] * eye[None, :, :]      # [N,3(axis i),3(vec)]
    dn_di = normal_jacobian(grad[:, None, :], dirs, voxel_size)
    return dn_d0, dn_di
