"""FALS surface-normal estimation (Badino et al.).

Port-of-semantics of cv::NormalEstimator (cpp/include/normals/
NormalEstimator.h:23-184): per-pixel ray grids and the inverse 3x3 Gram
matrices Q are cached once per intrinsics (in float64 on the host, like the
reference's double-precision cache()); per frame, normals come from three
box filters of 1/z-weighted ray components followed by the cached
closed-form 3x3 solve and normalization.

The per-frame part is ops/preprocess.py's `fals_normals`: a kernel on the
card, and on the CPU its plain version, whose box filters are unnormalized
window sums with REFLECT_101 borders (OpenCV boxFilter defaults) written as
separable shifted-slice sums in float32 — the same additions in the same
order as the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from psgradientsdf_tpu_torch import resolve_device
from psgradientsdf_tpu_torch.ops import preprocess
from psgradientsdf_tpu_torch.ops.preprocess import _box_filter  # noqa: F401 (the plain filter)


class FalsCache(NamedTuple):
    """Per-intrinsics precomputation (NormalEstimator.h cache(), :52-125)."""
    x0_n_sq_inv: torch.Tensor   # [H,W]
    y0_n_sq_inv: torch.Tensor   # [H,W]
    n_sq_inv: torch.Tensor      # [H,W]
    Q: torch.Tensor             # [H,W,6] packed symmetric (Q11,Q12,Q13,Q22,Q23,Q33)


def fals_cache_arrays(height: int, width: int, K, window: int = 11):
    """The cache as float32 numpy arrays (x0n, y0n, n_sq_inv, Q), computed in
    float64 on the host (matches the reference's double cache)."""
    K = np.asarray(K, dtype=np.float64)
    fx_inv, fy_inv = 1.0 / K[0, 0], 1.0 / K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    cols = np.arange(width, dtype=np.float64)[None, :] - cx
    rows = np.arange(height, dtype=np.float64)[:, None] - cy
    x0 = np.broadcast_to(fx_inv * cols, (height, width))
    y0 = np.broadcast_to(fy_inv * rows, (height, width))

    n_sq = 1.0 + x0 * x0 + y0 * y0
    n_sq_inv = 1.0 / n_sq
    x0n = x0 * n_sq_inv
    y0n = y0 * n_sq_inv

    def box(a: np.ndarray) -> np.ndarray:
        r = window // 2
        p = np.pad(a, r, mode="reflect")
        c = np.cumsum(np.cumsum(p, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0)))
        H, W = a.shape
        out = (
            c[window : window + H, window : window + W]
            - c[0:H, window : window + W]
            - c[window : window + H, 0:W]
            + c[0:H, 0:W]
        )
        return out

    M11 = box(x0 * x0 * n_sq_inv)
    M12 = box(x0 * y0 * n_sq_inv)
    M13 = box(x0n)
    M22 = box(y0 * y0 * n_sq_inv)
    M23 = box(y0n)
    M33 = box(n_sq_inv)

    det = (
        M11 * M22 * M33
        + 2.0 * M12 * M23 * M13
        - (M13 * M13 * M22 + M12 * M12 * M33 + M23 * M23 * M11)
    )
    det_inv = 1.0 / det
    Q11 = det_inv * (M22 * M33 - M23 * M23)
    Q12 = det_inv * (M13 * M23 - M12 * M33)
    Q13 = det_inv * (M12 * M23 - M13 * M22)
    Q22 = det_inv * (M11 * M33 - M13 * M13)
    Q23 = det_inv * (M12 * M13 - M11 * M23)
    Q33 = det_inv * (M11 * M22 - M12 * M12)
    Q = np.stack([Q11, Q12, Q13, Q22, Q23, Q33], axis=-1)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    return f32(x0n), f32(y0n), f32(n_sq_inv), f32(Q)


def build_fals_cache(height: int, width: int, K, window: int = 11,
                     device=None) -> FalsCache:
    dev = resolve_device(device)
    K = K.detach().cpu().numpy() if isinstance(K, torch.Tensor) else K
    return FalsCache(*(torch.from_numpy(a).to(dev)
                       for a in fals_cache_arrays(height, width, K, window)))


def compute_normals(depth: torch.Tensor, cache: FalsCache,
                    window: int = 11) -> torch.Tensor:
    """Per-frame FALS normals (NormalEstimator.h compute(), :150-176) for a
    [H,W] depth map or a [C,H,W] batch, on the cache's device: ops/
    preprocess.py's fals_normals (one kernel launch on the card).

    Returns [...,H,W,3] unit normals (inward-pointing, like the reference).
    Pixels with zero depth contribute 0 to the window sums.
    """
    return preprocess.fals_normals(depth, cache, window)
