"""Image-sharpness focus measures for keyframe selection.

Port-of-semantics of cpp/include/ps_optimizer/SharpDetector.h:12-73. The
keyframe gate uses the modified-Laplacian (LAPM) measure; LAPV / TENG / GLVN
are also provided for parity (the reference ships but does not use them).

Note: the reference calls cv::mean on a 3-channel image and keeps .val[0],
i.e. only the FIRST (blue) channel of the BGR image enters the decision
(SharpDetector.h:35).  We replicate that: for RGB inputs the measure is
computed on channel 2 (blue).

Every measure takes one image ([H,W] or [H,W,3]) or a batch ([C,H,W,3]) and
returns a scalar or a [C] tensor.  LAPM is ops/preprocess.py's `lapm` (the
scan's kernel on the card); the other three are plain PyTorch, as the gate
does not use them.
"""

from __future__ import annotations

import torch

from psgradientsdf_tpu_torch.ops import preprocess
from psgradientsdf_tpu_torch.ops.preprocess import _pad1, _sep_filter
from psgradientsdf_tpu_torch.ops.preprocess import measure_channel as _to_measure_channel


def modified_laplacian(img: torch.Tensor) -> torch.Tensor:
    """LAPM (Nayar89): mean(|Lx| + |Ly|) (SharpDetector.h:22-37), through
    ops/preprocess.py's lapm (one kernel launch on the card)."""
    return preprocess.lapm(img)


def variance_of_laplacian(img: torch.Tensor) -> torch.Tensor:
    """LAPV (Pech2000) (SharpDetector.h:40-50)."""
    src = _to_measure_channel(img)
    # cv::Laplacian 3x3 kernel [[0,1,0],[1,-4,1],[0,1,0]]
    x = _pad1(src)
    lap = (
        x[..., :-2, 1:-1] + x[..., 2:, 1:-1] + x[..., 1:-1, :-2]
        + x[..., 1:-1, 2:] - 4.0 * x[..., 1:-1, 1:-1]
    )
    return torch.var(lap, dim=(-2, -1), unbiased=False)


def tenengrad(img: torch.Tensor) -> torch.Tensor:
    """TENG (Krotkov86): mean(Gx^2 + Gy^2) with 3x3 Sobel (SharpDetector.h:53-63)."""
    src = _to_measure_channel(img)
    smooth = (1.0, 2.0, 1.0)
    diff = (-1.0, 0.0, 1.0)
    gx = _sep_filter(src, diff, smooth)
    gy = _sep_filter(src, smooth, diff)
    return torch.mean(gx * gx + gy * gy, dim=(-2, -1))


def normalized_graylevel_variance(img: torch.Tensor) -> torch.Tensor:
    """GLVN (Santos97) (SharpDetector.h:66-73)."""
    src = _to_measure_channel(img)
    return (torch.var(src, dim=(-2, -1), unbiased=False)
            / torch.mean(src, dim=(-2, -1)))


def is_sharp(img: torch.Tensor, threshold: float) -> bool:
    """Keyframe gate (SharpDetector.h:12-18)."""
    return bool(modified_laplacian(img) >= threshold)
