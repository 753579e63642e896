"""The distance block's eager tail: its regularizer operators and its
update, one launch each of the hand-written Hopper kernels in
csrc/distreg.cu, or their plain PyTorch versions for CPU tensors.

  reg_operators(prob, dist, voxel_size, *, eikonal, laplacian, diag_only)
      -> (RegOperator or None, LapOperator or None)
  dist_update(prob, dist, delta, voxel_size) -> (new_dist [N], new_grad [N,3])

reg_operators replaces the JAX package's psgradientsdf_tpu/refine/
solvers.py `eikonal_operator` (:135) and `laplacian_operator` (:157) in one
launch; dist_update replaces its `update_distance` (:307): the accept rule
(|delta| < sqrt(3) h on a valid row) and the new stored gradient
(geometry.fd_grad of the new distances).  With delta=None dist_update gives
the gradient of dist alone (the mesh accepts each row's step itself and
asks for the gradient after gathering its neighbours).  The plain versions
are refine/solvers.py's `eikonal_operator`, `laplacian_operator` and
`accept_distance` with geometry.fd_grad, whose every sum is written out in
a fixed order (geometry.dot3, norm3, fd_laplacian's left-to-right
neighbour sum), so that the kernels equal them on the card bit for bit.

On the one-card refinement neither launches: the operators are a stage of
ops/distcg.py's dist_system (dist_system_reg) and the update one of its
dist_cg (dist_cg_update), on the same row arithmetic (csrc/stencil.cuh).
These launches serve the joint step and the mesh.

A wrapper takes the plain version ONLY for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  `launch_counts` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from psgradientsdf_tpu_torch.refine import geometry
from psgradientsdf_tpu_torch.refine.problem import RefineProblem

_LIB_NAME = "distreg"
launch_counts: Dict[str, int] = {"reg_operators": 0, "dist_update": 0}

THREADS = 256
BLOCKS_PER_SM = 4


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _solvers():
    # refine/solvers.py calls this module's wrappers and holds the plain
    # operators and their named tuples
    from psgradientsdf_tpu_torch.refine import solvers

    return solvers


# ---------------------------------------------------------------------------
# the plain PyTorch versions
# ---------------------------------------------------------------------------


def reg_operators_plain(prob: RefineProblem, dist: torch.Tensor, voxel_size: float, *,
                        eikonal: bool, laplacian: bool, diag_only: bool):
    """(the Eikonal operator or None, the Laplacian operator or None) of
    refine/solvers.py."""
    s = _solvers()
    return (s.eikonal_operator(prob, dist, voxel_size) if eikonal else None,
            s.laplacian_operator(prob, dist, voxel_size, diag_only) if laplacian else None)


def accept_threshold(voxel_size: float) -> float:
    """The float |delta| is compared with: sqrt(3) h rounded once, as a
    float32 tensor is compared with a Python number."""
    return float(np.float32(math.sqrt(3.0) * voxel_size))


def dist_update_plain(prob: RefineProblem, dist: torch.Tensor,
                      delta: Optional[torch.Tensor], voxel_size: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new_dist, new_grad): refine/solvers.py's accept rule, then the FD
    gradient of the new distances (of dist itself without delta)."""
    new_dist = dist if delta is None else _solvers().accept_distance(
        prob, dist, delta, voxel_size)
    return new_dist, geometry.fd_grad(prob, new_dist, voxel_size)


def lap_operator(prob: RefineProblem, r: torch.Tensor, voxel_size: float, diag_only: bool):
    """refine/solvers.py's LapOperator of the residual r a kernel wrote: its
    coefficients host floats, as laplacian_operator gives them."""
    inv_h2 = 1.0 / (voxel_size * voxel_size)
    return _solvers().LapOperator(r=r, lap_idx=prob.lap_idx, diag_coef=-6.0 * inv_h2,
                                  nbr_coef=0.0 if diag_only else inv_h2)


# ---------------------------------------------------------------------------
# the host plan, the C interface and the library
# ---------------------------------------------------------------------------


def row_blocks(N: int, sms: int) -> int:
    """The kernels' grid: a thread a row, at most BLOCKS_PER_SM blocks an
    SM striding over them."""
    return max(1, min(BLOCKS_PER_SM * sms, -(-N // THREADS)))


class _RegArgs(ctypes.Structure):
    """csrc/distreg.cu RegArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("valid", "dist", "nbr_dir", "nbr_idx", "nbr_dist_const", "lap_idx",
          "lap_dist_const", "r", "J0", "Ji", "lap_r")]
        + [(n, ctypes.c_int64) for n in ("N", "eikonal", "laplacian", "blocks")]
        + [("voxel", ctypes.c_double)])


class _UpdateArgs(ctypes.Structure):
    """csrc/distreg.cu UpdateArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("valid", "dist", "delta", "nbr_dir", "nbr_idx", "nbr_dist_const",
          "new_dist", "new_grad")]
        + [(n, ctypes.c_int64) for n in ("N", "blocks")]
        + [(n, ctypes.c_double) for n in ("voxel", "accept")])


_bound = None


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        lib.reg_operators.argtypes = [ctypes.POINTER(_RegArgs), ctypes.c_void_p]
        lib.reg_operators.restype = ctypes.c_int
        lib.dist_update.argtypes = [ctypes.POINTER(_UpdateArgs), ctypes.c_void_p]
        lib.dist_update.restype = ctypes.c_int
        _bound = lib
    return _bound


def _inputs(what: str, want, dev):
    """The named tensors, checked and contiguous."""
    out = {}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        out[name] = t.contiguous()
    return out


def _launch(name: str, args, dev) -> None:
    with torch.cuda.device(dev):
        rc = getattr(_library(), name)(ctypes.byref(args),
                                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    launch_counts[name] += 1


def _stencil(prob: RefineProblem, dist: torch.Tensor, N: int):
    return {"valid": (prob.valid, torch.bool, (N,)),
            "dist": (dist, torch.float32, (N,)),
            "nbr_dir": (prob.nbr_dir, torch.float32, (N, 3)),
            "nbr_idx": (prob.nbr_idx, torch.int64, (N, 3)),
            "nbr_dist_const": (prob.nbr_dist_const, torch.float32, (N, 3))}


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def reg_operators(prob: RefineProblem, dist: torch.Tensor, voxel_size: float, *,
                  eikonal: bool, laplacian: bool, diag_only: bool):
    """(RegOperator or None, LapOperator or None) of refine/solvers.py at
    `dist`: one kernel launch on CUDA tensors, reg_operators_plain on CPU
    tensors.  The Laplacian's coefficients stay host floats."""
    if not (eikonal or laplacian):
        raise ValueError("reg_operators: neither operator asked for")
    if dist.device.type == "cpu":
        return reg_operators_plain(prob, dist, voxel_size, eikonal=eikonal,
                                   laplacian=laplacian, diag_only=diag_only)
    N, dev = dist.shape[0], dist.device
    want = _stencil(prob, dist, N)
    if laplacian:
        want.update(lap_idx=(prob.lap_idx, torch.int64, (N, 6)),
                    lap_dist_const=(prob.lap_dist_const, torch.float32, (N, 6)))
    ins = _inputs("reg_operators", want, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    r, J0, Ji = ((torch.empty(N, **f32), torch.empty(N, **f32), torch.empty((N, 3), **f32))
                 if eikonal else (None, None, None))
    lap_r = torch.empty(N, **f32) if laplacian else None
    from psgradientsdf_tpu_torch.kernels import sm_count

    a = _RegArgs()
    for name, t in ins.items():
        setattr(a, name, t.data_ptr())
    for name, t in (("r", r), ("J0", J0), ("Ji", Ji), ("lap_r", lap_r)):
        setattr(a, name, None if t is None else t.data_ptr())
    a.N, a.eikonal, a.laplacian = N, int(eikonal), int(laplacian)
    a.blocks, a.voxel = row_blocks(N, sm_count(dev)), float(voxel_size)
    _launch("reg_operators", a, dev)
    eik = (_solvers().RegOperator(r=r, J0=J0, Ji=Ji, nbr_idx=prob.nbr_idx) if eikonal
           else None)
    lap = lap_operator(prob, lap_r, voxel_size, diag_only) if laplacian else None
    return eik, lap


def dist_update(prob: RefineProblem, dist: torch.Tensor, delta: Optional[torch.Tensor],
                voxel_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new_dist [N], new_grad [N,3]): the accept rule on every row and the
    FD gradient of the new distances (delta=None: dist itself and its
    gradient): one kernel launch on CUDA tensors, dist_update_plain on CPU
    tensors."""
    if dist.device.type == "cpu":
        return dist_update_plain(prob, dist, delta, voxel_size)
    N, dev = dist.shape[0], dist.device
    want = _stencil(prob, dist, N)
    if delta is not None:
        want["delta"] = (delta, torch.float32, (N,))
    ins = _inputs("dist_update", want, dev)
    new_dist = dist if delta is None else torch.empty(N, dtype=torch.float32, device=dev)
    new_grad = torch.empty((N, 3), dtype=torch.float32, device=dev)
    from psgradientsdf_tpu_torch.kernels import sm_count

    a = _UpdateArgs()
    for name, t in ins.items():
        setattr(a, name, t.data_ptr())
    a.new_dist = None if delta is None else new_dist.data_ptr()
    a.new_grad = new_grad.data_ptr()
    a.N, a.blocks = N, row_blocks(N, sm_count(dev))
    a.voxel, a.accept = float(voxel_size), accept_threshold(voxel_size)
    _launch("dist_update", a, dev)
    return new_dist, new_grad
