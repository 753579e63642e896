"""Fused 3x3-patch image sampling for the refinement hot path.

The per-(surface voxel, keyframe) residual/Jacobian computations need, at
each reprojection (u, v): the bilinear intensity and both finite-difference
image gradients (ops/image.py, mirroring Auxilary.h:41-123).  Evaluated
naively that is ~16 separate indexed reads per pair, each of 12 bytes.

This module fetches everything in THREE row gathers per pair, each of one
36-byte row, from a column-span table built on the fly:

    span[f, r*W + c] = concat(img[f, r, clip(c-1)], img[f, r, c],
                              img[f, r, clip(c+1)])          # [F, H*W, 9]

For pixel base (r0, c0) = (floor(v), floor(u)), gathering span rows
clip(r0+dr)*W + clip(c0) for dr in {-1, 0, 1} yields the full 3x3x3 patch

    P[..., i, j, :] = img[clip(r0-1+i), clip(c0-1+j)]

with BOTH axes edge-replicated exactly like ops/image.py's per-index clip
(row clip via the gather index, column clip via the span's edge padding).

`sample_patch_all` evaluates the identical arithmetic as ops/image.py
`bilinear_rgb` / `image_gradient_rgb` on the patch (same border fallbacks,
same operation order) — held to exact equality in the tests.

Memory: when the all-frames span table would be large (megapixel keyframe
sets), `sample_patch_all` walks the frames one at a time, keeping exactly
ONE [H*W, 9] span table live and emitting only the small [N,3]-shaped
per-frame results.

This module is the plain version's patch fetch (ops/residual.py
residual_pass_plain), which serves the CPU.  On the card the residual pass
is csrc/residual.cu's kernel: it reads the patches from the [F,H,W,3]
images directly, with the same edge replication and arithmetic, and builds
no span table; `_SPAN_BYTES_LIMIT`'s per-frame walk concerns the plain
version alone.
"""

from __future__ import annotations

from typing import Tuple

import torch

# all-frames span tables above this size take the per-frame path
_SPAN_BYTES_LIMIT = 512 * 1024 * 1024


def build_span(images: torch.Tensor) -> torch.Tensor:
    """images [F,H,W,3] -> column-span table [F, H*W, 9] (edge-replicated)."""
    F, H, W = images.shape[0], images.shape[1], images.shape[2]
    pad = torch.cat([images[:, :, :1], images, images[:, :, -1:]], dim=2)
    parts = [pad[:, :, dc:dc + W] for dc in (0, 1, 2)]
    return torch.cat(parts, dim=-1).reshape(F, H * W, 9)


def fetch_patches(images: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """3x3 RGB patches at uv [N,F,2] (col,row) -> P [N,F,3(row),3(col),3(ch)]
    with P[..., i, j, :] = img[clip(r0-1+i), clip(c0-1+j)]."""
    F, H, W = images.shape[0], images.shape[1], images.shape[2]
    span = build_span(images).reshape(F * H * W, 9)
    # floor before the integer cast: uv outside the image is negative
    r0 = torch.floor(uv[..., 1]).long()
    c0 = torch.clamp(torch.floor(uv[..., 0]).long(), 0, W - 1)
    frame0 = torch.arange(F, device=uv.device)[None, :] * (H * W)    # [1,F]
    rows = []
    for dr in (-1, 0, 1):
        lin = frame0 + torch.clamp(r0 + dr, 0, H - 1) * W + c0
        rows.append(span[lin])                                       # [N,F,9]
    P = torch.stack(rows, dim=2)                                     # [N,F,3,9]
    return P.reshape(P.shape[:-1] + (3, 3))                          # [N,F,3,3,3]


def _patch_math(P: torch.Tensor, uv: torch.Tensor, H: int, W: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear intensity + image gradients from a 3x3 patch.

    P [..., 3(row), 3(col), 3(ch)], uv [..., 2] -> (I [..., 3],
    g [..., 3, 2]).  Bitwise-identical to ops.image.bilinear_rgb /
    image_gradient_rgb at every in-image coordinate."""
    r0f = torch.floor(uv[..., 1])
    c0f = torch.floor(uv[..., 0])
    fr = (uv[..., 1] - r0f)[..., None]
    fc = (uv[..., 0] - c0f)[..., None]
    # raw (unclipped) border flags — identical to ops/image.py
    row_ok = (r0f.long() + 1 < H)[..., None]
    col_ok = (c0f.long() + 1 < W)[..., None]

    def v(dr: int, dc: int) -> torch.Tensor:
        return P[..., dr + 1, dc + 1, :]

    v00, v01, v10, v11 = v(0, 0), v(0, 1), v(1, 0), v(1, 1)

    # --- bilinear (ops/image.py bilinear_rgb) ---
    full = (1 - fc) * (fr * v10 + (1 - fr) * v00) + fc * (fr * v11 + (1 - fr) * v01)
    col_only = (1 - fc) * v00 + fc * v01
    row_only = fr * v10 + (1 - fr) * v00
    both = row_ok & col_ok
    I = torch.where(
        both,
        full,
        torch.where(col_ok, col_only, torch.where(row_ok, row_only, v00)),
    )

    # --- axis 0 gradient (d/d col) ---
    d_r0 = v01 - v00
    d_r1 = v11 - v10
    b_r0 = v00 - v(0, -1)
    b_r1 = v10 - v(1, -1)
    blended = (1 - fr) * d_r0 + fr * d_r1
    blended_back = (1 - fr) * b_r0 + fr * b_r1
    gu = torch.where(both, blended, torch.where(~row_ok, d_r0, blended_back))

    # --- axis 1 gradient (d/d row) ---
    d_c0 = v10 - v00
    d_c1 = v11 - v01
    b_c0 = v00 - v(-1, 0)
    b_c1 = v01 - v(-1, 1)
    blended_v = (1 - fc) * d_c0 + fc * d_c1
    blended_back_v = (1 - fc) * b_c0 + fc * b_c1
    gv = torch.where(both, blended_v, torch.where(~col_ok, d_c0, blended_back_v))

    return I, torch.stack([gu, gv], dim=-1)


def sample_patch_all(
    images: torch.Tensor,     # [F,H,W,3]
    uv: torch.Tensor,         # [N,F,2] (col,row)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused fetch -> (intensity [N,F,3], image gradients [N,F,3,2])."""
    F, H, W = images.shape[0], images.shape[1], images.shape[2]
    if F * H * W * 9 * 4 <= _SPAN_BYTES_LIMIT:
        P = fetch_patches(images, uv)
        return _patch_math(P, uv, H, W)

    # memory-bounded path: frame by frame — one span table live at a time,
    # and only the SMALL per-frame results are kept
    Is, gs = [], []
    for f in range(F):
        uv_f = uv[:, f]                                            # [N,2]
        P_f = fetch_patches(images[f:f + 1], uv_f[:, None, :])[:, 0]   # [N,3,3,3]
        I_f, g_f = _patch_math(P_f, uv_f, H, W)                    # [N,3], [N,3,2]
        Is.append(I_f)
        gs.append(g_f)
    return torch.stack(Is, dim=1), torch.stack(gs, dim=1)
