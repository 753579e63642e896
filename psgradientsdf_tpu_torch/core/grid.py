"""Voxel grid geometry: coordinate transforms, indexing, interpolation.

Semantics match cpp/include/sdf_tracker/VoxelGrid.h:38-113 and VoxelGrid.cpp:
  * voxel index (i,j,k) = (x,y,z); arrays are stored [Z,Y,X] so the C-order
    linearization equals the reference's i + j*dimx + k*dimx*dimy.
  * origin = shift - 0.5 * voxel_size * dims  (volume centered at `shift`,
    VoxelGrid.h:123)
  * nearest_info rejects the 1-voxel border (VoxelGrid.cpp:57-72).

GridGeometry is a frozen (hashable) dataclass of Python numbers; its
tensor-valued methods work on the device of the tensor they are given.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from psgradientsdf_tpu_torch import device_constant


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    dims: Tuple[int, int, int]          # (dimx, dimy, dimz)
    voxel_size: float
    shift: Tuple[float, float, float]   # world position of the grid center

    @property
    def origin(self) -> Tuple[float, float, float]:
        h = self.voxel_size
        return (
            self.shift[0] - 0.5 * h * self.dims[0],
            self.shift[1] - 0.5 * h * self.dims[1],
            self.shift[2] - 0.5 * h * self.dims[2],
        )

    @property
    def num_voxels(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    @property
    def shape_zyx(self) -> Tuple[int, int, int]:
        return (self.dims[2], self.dims[1], self.dims[0])

    def subdivided(self) -> "GridGeometry":
        """2x upsampled geometry (VoxelGrid.h:143-149): half voxel size,
        double dims, origin shifted by an extra half new-voxel so that the
        eight children of voxel v tile v's cube."""
        h = self.voxel_size * 0.5
        dims = (2 * self.dims[0], 2 * self.dims[1], 2 * self.dims[2])
        # reference: origin = shift - 0.5*h*dims - 0.5*h; encode the extra
        # -0.5*h by shifting the center.
        shift = (self.shift[0] - 0.5 * h, self.shift[1] - 0.5 * h, self.shift[2] - 0.5 * h)
        return GridGeometry(dims=dims, voxel_size=h, shift=shift)

    def origin_tensor(self, device) -> torch.Tensor:
        """The origin rounded to float32 (the value every transform uses)."""
        return device_constant(self.origin, torch.float32, torch.device(device))

    def voxel2world(self, idx_xyz: torch.Tensor) -> torch.Tensor:
        """(...,3) int/float voxel index -> world point."""
        origin = self.origin_tensor(idx_xyz.device)
        return origin + self.voxel_size * idx_xyz.to(torch.float32)

    def world2voxelf(self, pts: torch.Tensor) -> torch.Tensor:
        return (pts - self.origin_tensor(pts.device)) / self.voxel_size

    def world2voxel(self, pts: torch.Tensor) -> torch.Tensor:
        """Rounded voxel index (VoxelGrid.h:63-66)."""
        return torch.floor(self.world2voxelf(pts) + 0.5).to(torch.int32)

    def nearest_info(self, pts: torch.Tensor):
        """(idx_xyz int32 (...,3), valid bool (...,)) with the reference's
        border rejection: float index must lie strictly inside
        (0, dim-1) on every axis (VoxelGrid.cpp:63)."""
        f = self.world2voxelf(pts)
        dims_f = device_constant(self.dims, torch.float32, pts.device)
        valid = torch.all((f > 0.0) & (f < dims_f - 1.0), dim=-1)
        idx = torch.floor(f + 0.5).to(torch.int32)
        dims_i = device_constant(self.dims, torch.int32, pts.device)
        idx = torch.minimum(torch.clamp(idx, min=0), dims_i - 1)
        return idx, valid

    def world_coords(self, device, z_planes=None) -> torch.Tensor:
        """Dense world coordinates of every voxel center, shape [Z,Y,X,3];
        with `z_planes` (float32 global plane indices [Zl]) those of a
        Z-slab, [Zl,Y,X,3]."""
        dz, dy, dx = self.shape_zyx
        if z_planes is None:
            z_planes = torch.arange(dz, dtype=torch.float32, device=device)
        dz = z_planes.shape[0]
        k = z_planes[:, None, None]
        j = torch.arange(dy, dtype=torch.float32, device=device)[None, :, None]
        i = torch.arange(dx, dtype=torch.float32, device=device)[None, None, :]
        idx = torch.stack(
            [i.expand(dz, dy, dx), j.expand(dz, dy, dx), k.expand(dz, dy, dx)],
            dim=-1)
        return self.voxel2world(idx)


def gather_zyx(vol: torch.Tensor, idx_xyz: torch.Tensor) -> torch.Tensor:
    """Gather from a [Z,Y,X,...] tensor at (...,3) (x,y,z) integer indices."""
    return vol[idx_xyz[..., 2].long(), idx_xyz[..., 1].long(),
               idx_xyz[..., 0].long()]


def trilinear(vol: torch.Tensor, geom: GridGeometry, pts: torch.Tensor,
              extrap: float) -> torch.Tensor:
    """Trilinear interpolation of a scalar [Z,Y,X] grid at world points,
    with the reference's border rejection (VoxelGrid.cpp:11-55)."""
    f = geom.world2voxelf(pts)
    dims_f = device_constant(geom.dims, torch.float32, pts.device)
    valid = torch.all((f > 0.0) & (f < dims_f - 1.0), dim=-1)
    i0 = torch.floor(f)
    frac = f - i0
    dims_i = device_constant(geom.dims, torch.int64, pts.device)
    i0 = torch.minimum(torch.clamp(i0.long(), min=0), dims_i - 2)

    def corner(dx, dy, dz):
        return vol[i0[..., 2] + dz, i0[..., 1] + dy, i0[..., 0] + dx]

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c00 = corner(0, 0, 0) * (1 - fz) + corner(0, 0, 1) * fz
    c01 = corner(0, 1, 0) * (1 - fz) + corner(0, 1, 1) * fz
    c10 = corner(1, 0, 0) * (1 - fz) + corner(1, 0, 1) * fz
    c11 = corner(1, 1, 0) * (1 - fz) + corner(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    out = c0 * (1 - fx) + c1 * fx
    return torch.where(valid, out, torch.full_like(out, extrap))
