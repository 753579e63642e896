"""Spherical-harmonics shading basis (orders 1 and 2).

Replicates the reference basis layout exactly
(cpp/include/ps_optimizer/PsOptimizerJa.cpp:17-28):
  order 1 (4 coeffs):  [1, nx, ny, nz]
  order 2 (9 coeffs):  [1, nx, ny, nz, nx*ny, nx*nz, ny*nz,
                        nx^2 - ny^2, nx^2 - nz^2]
and the order-2 basis derivative dSH/dn
(cpp/include/ps_optimizer/PsOptimizerJa.cpp:244-250).

Both are elementwise in a fixed order, and `irradiance` writes the
basis-light product out as a sum in coefficient order: the residual kernels
(csrc/residual.cu) evaluate the same operations, so that they equal these
functions on the card bit for bit.
"""

from __future__ import annotations

import torch


def n_basis(order: int) -> int:
    return 4 if order == 1 else 9


def sh_basis(n: torch.Tensor, order: int) -> torch.Tensor:
    """SH basis of a (possibly batched) direction n (...,3) -> (...,B)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    one = torch.ones_like(nx)
    if order == 1:
        return torch.stack([one, nx, ny, nz], dim=-1)
    if order == 2:
        return torch.stack(
            [
                one,
                nx,
                ny,
                nz,
                nx * ny,
                nx * nz,
                ny * nz,
                nx * nx - ny * ny,
                nx * nx - nz * nz,
            ],
            dim=-1,
        )
    raise ValueError(f"unsupported SH order {order}")


def irradiance(basis: torch.Tensor, lights: torch.Tensor) -> torch.Tensor:
    """l_f . SH for every (row, frame): basis [...,B], lights [F,B] ->
    [...,F], summed from coefficient 0 up (no library matrix product)."""
    out = basis[..., 0:1] * lights[:, 0]
    for b in range(1, basis.shape[-1]):
        out = out + basis[..., b:b + 1] * lights[:, b]
    return out


def dsh_dn(n: torch.Tensor, order: int) -> torch.Tensor:
    """Jacobian of sh_basis w.r.t. n: (...,3) -> (...,3,B).

    Row i = d(basis)/d(n_i); matches dSH_dnhat in
    cpp/include/ps_optimizer/PsOptimizerJa.cpp:248-250 (a 3x9 matrix whose
    transpose maps dn -> dSH).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    zero = torch.zeros_like(nx)
    one = torch.ones_like(nx)
    if order == 1:
        rows = [
            torch.stack([zero, one, zero, zero], dim=-1),
            torch.stack([zero, zero, one, zero], dim=-1),
            torch.stack([zero, zero, zero, one], dim=-1),
        ]
        return torch.stack(rows, dim=-2)
    if order == 2:
        rows = [
            torch.stack([zero, one, zero, zero, ny, nz, zero, 2 * nx, 2 * nx], dim=-1),
            torch.stack([zero, zero, one, zero, nx, zero, nz, -2 * ny, zero], dim=-1),
            torch.stack([zero, zero, zero, one, zero, nx, ny, zero, -2 * nz], dim=-1),
        ]
        return torch.stack(rows, dim=-2)
    raise ValueError(f"unsupported SH order {order}")
