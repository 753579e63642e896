"""The refinement's four energies: one launch of the hand-written Hopper
kernel in csrc/energy.cu, or its plain PyTorch version for CPU tensors.

  energy_sums(prob, rd, dist, albedo, *, loss, lam, voxel_size,
              terms=ALL_TERMS, n_surface=None)
      -> sums [4] (PS, normal, Laplacian, albedo), or with n_surface
         (sums [4], energies [4]): each sum over max(n_surface, 1)

It replaces the JAX package's psgradientsdf_tpu/refine/optimizer.py
`_energy_from_rd` (:60-73), one device program over refine/render.py
`ps_energy`, `normal_energy`, `laplacian_energy` and `albedo_reg_energy`.
The plain version is the port's chain of refine/render.py's *_sum terms
(refine/geometry.py's gather_nbr, fd_grad, fd_laplacian and fd_albedo_grad,
utils/robust.py's loss_value, four torch reductions).  `terms` (a mask of
PS, NORMAL, LAPLACIAN, ALBEDO) selects the sums: the mesh asks for a
(voxel chunk, keyframe chunk) block's PS sum alone, or for a chunk's four;
a term left out sums to 0 and its inputs are not read (albedo may then be
None).

The kernel is a persistent grid (`energy_blocks`): its pair warps stream
the pairs in groups of GROUP (pair thread q of Q: groups q, q + Q, ...),
its row warps take the voxel rows.  It sums each term in double in a
fixed order (a thread's groups or its rows in turn, each warp's xor
butterfly, the warps in order, then the blocks' partials by a fixed
stride and the same tree), the plain version in float in torch's order,
so the two agree to float32 rounding; two launches give the same bits.
The order depends on the shapes and the block count alone: where r or the
mask is off the vector loads' alignment (a row slice), the kernel reads
the same groups by scalar loads.

A wrapper takes the plain version ONLY for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  `launch_counts` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from psgradientsdf_tpu_torch.refine import render
from psgradientsdf_tpu_torch.utils import robust

_LIB_NAME = "energy"
launch_counts: Dict[str, int] = {"energy_sums": 0}

PS, NORMAL, LAPLACIAN, ALBEDO = 1, 2, 4, 8
ALL_TERMS = PS | NORMAL | LAPLACIAN | ALBEDO
REGULARIZERS = NORMAL | LAPLACIAN | ALBEDO
# the robust losses in the order of the kernel's template kinds
# (csrc/energy.cu `Loss`)
LOSS_KINDS = (robust.L2, robust.CAUCHY, robust.HUBER, robust.TUKEY, robust.TRUNC_L2)

# the kernel's block: PAIR_THREADS stream the pairs in groups of GROUP,
# ROW_THREADS take the rows (csrc/energy.cu)
THREADS = 512
PAIR_THREADS = 256
ROW_THREADS = THREADS - PAIR_THREADS
GROUP = 4
BLOCKS_PER_SM = 2


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def energy_sums_plain(prob, rd, dist, albedo, *, loss: int, lam: float,
                      voxel_size: float, terms: int = ALL_TERMS) -> torch.Tensor:
    """The four sums [4] as refine/render.py's *_sum terms compute them;
    a term left out of `terms` is 0."""
    zero = rd.r.new_zeros(())
    return torch.stack([
        render.ps_energy_sum(rd, loss=loss, lam=lam) if terms & PS else zero,
        render.normal_energy_sum(prob, dist, voxel_size) if terms & NORMAL else zero,
        render.laplacian_energy_sum(prob, dist, voxel_size)
        if terms & LAPLACIAN else zero,
        render.albedo_reg_energy_sum(prob, albedo, voxel_size)
        if terms & ALBEDO else zero,
    ])


# ---------------------------------------------------------------------------
# the host plan, the C interface and the library
# ---------------------------------------------------------------------------


def energy_blocks(N: int, F: int, sms: int) -> int:
    """The kernel's persistent grid: at most BLOCKS_PER_SM blocks an SM,
    and no more than give each pair thread a group of GROUP pairs or each
    row thread a row.  A function of the shapes and the card alone, so a
    call's order of addition, and its bits, are too."""
    groups = -(-N * F // GROUP)
    need = max(-(-groups // PAIR_THREADS), -(-N // ROW_THREADS), 1)
    return min(BLOCKS_PER_SM * sms, need)


class _EnergyArgs(ctypes.Structure):
    """csrc/energy.cu EnergyArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("r", "mask", "valid", "dist", "albedo", "nbr_dir", "nbr_idx",
          "nbr_dist_const", "nbr_albedo_const", "lap_idx", "lap_dist_const",
          "part", "ticket", "out")]
        + [(n, ctypes.c_int64) for n in
           ("N", "F", "terms", "loss", "has_count", "blocks")]
        + [(n, ctypes.c_double) for n in ("lam", "voxel", "count")])


_bound = None


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        lib.energy_sums.argtypes = [ctypes.POINTER(_EnergyArgs), ctypes.c_void_p]
        lib.energy_sums.restype = ctypes.c_int
        _bound = lib
    return _bound


# the ticket of the last block, one a device and stream: zeroed once when
# made, each launch's last block leaves it at 0 again
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket(dev) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def _inputs(prob, rd, dist, albedo, terms: int, dev):
    """The kernel's inputs by C name, checked and contiguous; those of a
    term left out are None."""
    N = prob.valid.shape[0]
    F = rd.mask.shape[1] if rd.mask.dim() == 2 else -1
    want = {}
    if terms & PS:
        want.update(r=(rd.r, torch.float32, (N, F, 3)),
                    mask=(rd.mask, torch.bool, (N, F)))
    if terms & REGULARIZERS:
        want.update(valid=(prob.valid, torch.bool, (N,)),
                    dist=(dist, torch.float32, (N,)),
                    nbr_dir=(prob.nbr_dir, torch.float32, (N, 3)),
                    nbr_idx=(prob.nbr_idx, torch.int64, (N, 3)))
    if terms & NORMAL:
        want.update(nbr_dist_const=(prob.nbr_dist_const, torch.float32, (N, 3)))
    if terms & LAPLACIAN:
        want.update(lap_idx=(prob.lap_idx, torch.int64, (N, 6)),
                    lap_dist_const=(prob.lap_dist_const, torch.float32, (N, 6)))
    if terms & ALBEDO:
        if albedo is None:
            raise ValueError("energy_sums: the albedo term needs the albedo")
        want.update(albedo=(albedo, torch.float32, (N, 3)),
                    nbr_albedo_const=(prob.nbr_albedo_const, torch.float32, (N, 3, 3)))
    out = {}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"energy_sums: {name} must be {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        out[name] = t.contiguous()
    return N, max(F, 0), out


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def energy_sums(prob, rd, dist, albedo, *, loss: int, lam: float,
                voxel_size: float, terms: int = ALL_TERMS,
                n_surface: Optional[int] = None):
    """The four sums [4] (and with `n_surface` the four energies [4] too,
    as (sums, energies)): one kernel launch on the card, energy_sums_plain
    on the CPU."""
    if not 0 < terms <= ALL_TERMS:
        raise ValueError(f"energy_sums: terms {terms!r} is not a mask of "
                         f"PS | NORMAL | LAPLACIAN | ALBEDO")
    if loss not in LOSS_KINDS:
        raise ValueError(f"energy_sums: unknown loss {loss!r}")
    r = rd.r
    if r.device.type == "cpu":
        sums = energy_sums_plain(prob, rd, dist, albedo, loss=loss, lam=lam,
                                 voxel_size=voxel_size, terms=terms)
        return sums if n_surface is None else (sums, sums / max(float(n_surface), 1.0))
    dev = r.device
    N, F, ins = _inputs(prob, rd, dist, albedo, terms, dev)
    from psgradientsdf_tpu_torch.kernels import sm_count

    blocks = energy_blocks(N, F, sm_count(dev))
    out = torch.empty(8, dtype=torch.float32, device=dev)
    part = torch.empty(4 * blocks, dtype=torch.float64, device=dev)
    a = _EnergyArgs()
    for name, t in ins.items():
        setattr(a, name, t.data_ptr())
    a.part, a.ticket, a.out = part.data_ptr(), _ticket(dev).data_ptr(), out.data_ptr()
    a.N, a.F, a.terms, a.loss = N, F, terms, LOSS_KINDS.index(loss)
    a.has_count, a.blocks = int(n_surface is not None), blocks
    a.lam, a.voxel = float(lam), float(voxel_size)
    a.count = max(float(n_surface or 0), 1.0)
    with torch.cuda.device(dev):
        rc = _library().energy_sums(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"energy_sums: kernel launch failed, CUDA error {rc}")
    launch_counts["energy_sums"] += 1
    return out[:4] if n_surface is None else (out[:4], out[4:])
