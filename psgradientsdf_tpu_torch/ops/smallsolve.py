"""The SH light block's clipped eigen-solve: one launch of the hand-written
Hopper kernel in csrc/smallsolve.cu, or its plain PyTorch version for CPU
tensors.

  light_solve(H, g) -> delta [F, B]
      H [F, B, B] (its lower triangle is read), g [F, B], float32, B = 4 or
      9: per keyframe delta = V inv V^T g from the eigen-decomposition
      H = V diag(lambda) V^T in float64, an eigenvalue lambda <=
      1e-6 max(lambda_max, 0) given 1 / lambda = 0, rounded to float32.

It replaces the tail of the JAX package's psgradientsdf_tpu/refine/
solvers.py `solve_light_sh` (:512; jnp.linalg.eigh and the clipped products
:531-535), which runs inside the JAX package's one-dispatch iteration.  The
kernel (one warp a keyframe, cyclic Jacobi in double) waits for nothing, so
a CUDA graph of the refinement iteration holds it (refine/graph.py); a
batched torch.linalg.eigh on the card waits for the host.  The plain
version is torch.linalg.eigh on the float64 casts with the same clip and
products; the two agree to double rounding where no eigenvalue sits at the
clip.

A wrapper takes the plain version ONLY for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  `launch_counts` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch

_LIB_NAME = "smallsolve"
launch_counts: Dict[str, int] = {"light_solve": 0}

MAX_BASIS = 9
CLIP = 1e-6


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def light_solve_plain(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta [F,B] = V inv V^T g from torch.linalg.eigh of H in float64,
    eigenvalues <= CLIP * max(lambda_max, 0) dropped, rounded to g's type
    (float32 on the refinement's path; float64 inputs keep every digit)."""
    vals, vecs = torch.linalg.eigh(H.double())            # [F,B], [F,B,B]
    vmax = torch.amax(vals, dim=-1, keepdim=True)
    inv = torch.where(vals > torch.clamp(vmax, min=0.0) * CLIP, 1.0 / vals, 0.0)
    gv = torch.einsum("fdb,fd->fb", vecs, g.double())     # V^T g
    return torch.einsum("fbd,fd->fb", vecs, inv * gv).to(g.dtype)


# ---------------------------------------------------------------------------
# the C interface and the library
# ---------------------------------------------------------------------------


class _SolveArgs(ctypes.Structure):
    """csrc/smallsolve.cu SolveArgs, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("H", "g", "delta", "rotations")]
                + [(n, ctypes.c_int64) for n in ("F", "B")])


_bound = None


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        for name in ("light_solve", "light_solve_floor"):
            getattr(lib, name).argtypes = [ctypes.POINTER(_SolveArgs), ctypes.c_void_p]
            getattr(lib, name).restype = ctypes.c_int
        _bound = lib
    return _bound


def _call(name: str, a: _SolveArgs, dev) -> None:
    with torch.cuda.device(dev):
        rc = getattr(_library(), name)(ctypes.byref(a),
                                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")


def _shape(H: torch.Tensor, g: torch.Tensor):
    if H.dim() != 3 or H.shape[1] != H.shape[2] or tuple(g.shape) != tuple(H.shape[:2]):
        raise ValueError(f"light_solve: H must be [F,B,B] and g [F,B], got "
                         f"{tuple(H.shape)} and {tuple(g.shape)}")
    F, B = H.shape[0], H.shape[1]
    if not 1 <= B <= MAX_BASIS:
        raise ValueError(f"light_solve: {B} coefficients, at most {MAX_BASIS}")
    return F, B


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def light_solve(H: torch.Tensor, g: torch.Tensor, *,
                rotations_out: Optional[List] = None) -> torch.Tensor:
    """delta [F,B] (see the module docstring): one kernel launch on CUDA
    tensors, light_solve_plain on CPU tensors.  `rotations_out` receives the
    Jacobi rotations each keyframe applied ([F] int32 on the card; the
    plain version applies none and gives nothing)."""
    F, B = _shape(H, g)
    if H.device.type == "cpu":
        return light_solve_plain(H, g)
    dev = H.device
    for name, t in (("H", H), ("g", g)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"light_solve: {name} must be float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    H, g = H.contiguous(), g.contiguous()
    delta = torch.empty((F, B), dtype=torch.float32, device=dev)
    rotations = (torch.empty((F,), dtype=torch.int32, device=dev)
                 if rotations_out is not None else None)
    a = _SolveArgs(H.data_ptr(), g.data_ptr(), delta.data_ptr(),
                   None if rotations is None else rotations.data_ptr(), F, B)
    if F:
        _call("light_solve", a, dev)
        launch_counts["light_solve"] += 1
    if rotations_out is not None:
        rotations_out.append(rotations)
    return delta


def light_solve_floor(F: int, B: int, dev) -> None:
    """An empty kernel launched on light_solve's grid for F keyframes: the
    launch's floor, timed beside it and counted nowhere."""
    _call("light_solve_floor", _SolveArgs(None, None, None, None, F, B), dev)
