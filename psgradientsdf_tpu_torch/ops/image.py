"""Bilinear image sampling and finite-difference image gradients.

Port-of-semantics (not code) of cpp/include/ps_optimizer/Auxilary.h:41-123:
  * bilinear_rgb(img, r, c): bilinear interpolation with the reference's
    border behavior — when the +1 neighbor row/column falls outside the
    image, interpolation degrades to 1-D (or nearest).  Images here are
    RGB float32 in [0,1] (the BGR->RGB swap of Auxilary.h:59 happens at
    load time in io/loaders.py instead).
  * image_gradient_rgb(img, r, c, axis): bilinearly-blended forward
    differences, axis=0 -> d/d(col) (u-direction), axis=1 -> d/d(row)
    (v-direction), matching computeImageGradient's direction convention
    as called from the Jacobians (PsOptimizerJa.cpp:79-80).

All functions take arbitrarily batched (r, c) on the device of `img`.
"""

from __future__ import annotations

import torch


def rgb_float(images: torch.Tensor) -> torch.Tensor:
    """RGB images as float32 in [0,1], on their own device: raw-wire uint8
    images divided by 255, float ones cast."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images.to(torch.float32)


def _gather_rc(img: torch.Tensor, ri: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """img[(ri, ci)] with clipped integer indices; img is (H, W, C)."""
    H, W = img.shape[0], img.shape[1]
    ri = torch.clamp(ri, 0, H - 1)
    ci = torch.clamp(ci, 0, W - 1)
    return img[ri, ci]


def _base(r: torch.Tensor, c: torch.Tensor):
    # floor BEFORE the integer cast: coordinates outside the image are
    # negative, and a cast alone would round them towards zero
    r0 = torch.floor(r).long()
    c0 = torch.floor(c).long()
    fr = (r - r0.to(r.dtype))[..., None]
    fc = (c - c0.to(c.dtype))[..., None]
    return r0, c0, fr, fc


def bilinear_rgb(img: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Sample (H,W,3) image at float (row, col) -> (...,3).

    Matches interpolateImage (Auxilary.h:41-61): four explicit cases for
    the +1 neighbors being out of range.
    """
    H, W = img.shape[0], img.shape[1]
    r0, c0, fr, fc = _base(r, c)

    v00 = _gather_rc(img, r0, c0)
    v01 = _gather_rc(img, r0, c0 + 1)
    v10 = _gather_rc(img, r0 + 1, c0)
    v11 = _gather_rc(img, r0 + 1, c0 + 1)

    full = (1 - fc) * (fr * v10 + (1 - fr) * v00) + fc * (fr * v11 + (1 - fr) * v01)
    col_only = (1 - fc) * v00 + fc * v01          # row+1 out of range
    row_only = fr * v10 + (1 - fr) * v00          # col+1 out of range
    nearest = v00

    row_ok = (r0 + 1 < H)[..., None]
    col_ok = (c0 + 1 < W)[..., None]
    return torch.where(
        row_ok & col_ok,
        full,
        torch.where(col_ok, col_only, torch.where(row_ok, row_only, nearest)),
    )


def image_gradient_rgb(img: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                       axis: int) -> torch.Tensor:
    """Finite-difference gradient of an (H,W,3) image at float (row,col).

    axis=0: d/d(col) (horizontal / u);  axis=1: d/d(row) (vertical / v).
    Matches computeImageGradient (Auxilary.h:64-123) including its border
    fallbacks (backward difference at the far edge, unweighted single
    difference when the other axis' +1 neighbor is out of range).
    """
    H, W = img.shape[0], img.shape[1]
    r0, c0, fr, fc = _base(r, c)
    row_ok = (r0 + 1 < H)[..., None]
    col_ok = (c0 + 1 < W)[..., None]

    if axis == 0:
        # column-direction difference, blended across rows
        d_r0 = _gather_rc(img, r0, c0 + 1) - _gather_rc(img, r0, c0)
        d_r1 = _gather_rc(img, r0 + 1, c0 + 1) - _gather_rc(img, r0 + 1, c0)
        # far-column fallback: backward difference
        b_r0 = _gather_rc(img, r0, c0) - _gather_rc(img, r0, c0 - 1)
        b_r1 = _gather_rc(img, r0 + 1, c0) - _gather_rc(img, r0 + 1, c0 - 1)
        blended = (1 - fr) * d_r0 + fr * d_r1
        blended_back = (1 - fr) * b_r0 + fr * b_r1
        return torch.where(
            row_ok & col_ok,
            blended,
            torch.where(~row_ok, d_r0, blended_back),
        )
    # row-direction difference, blended across columns
    d_c0 = _gather_rc(img, r0 + 1, c0) - _gather_rc(img, r0, c0)
    d_c1 = _gather_rc(img, r0 + 1, c0 + 1) - _gather_rc(img, r0, c0 + 1)
    b_c0 = _gather_rc(img, r0, c0) - _gather_rc(img, r0 - 1, c0)
    b_c1 = _gather_rc(img, r0, c0 + 1) - _gather_rc(img, r0 - 1, c0 + 1)
    blended = (1 - fc) * d_c0 + fc * d_c1
    blended_back = (1 - fc) * b_c0 + fc * b_c1
    return torch.where(
        row_ok & col_ok,
        blended,
        torch.where(~col_ok, d_c0, blended_back),
    )


def backproject_grid(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Backproject an (H,W) depth map to camera-frame points (H,W,3)."""
    H, W = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    cols = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    rows = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    x0 = (cols - cx) / fx
    y0 = (rows - cy) / fy
    return torch.stack([x0 * depth, y0 * depth, depth], dim=-1)
