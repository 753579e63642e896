"""The albedo block's solve: its data terms formed per (voxel, keyframe)
pair (and the regularizer's rows), and the whole Jacobi-preconditioned CG
with the (0, 1) accept rule, one launch each of the hand-written Hopper
kernels in csrc/albedo.cu, or their plain PyTorch versions for CPU tensors.

  albedo_system(prob, rd, albedo, grad_stored, lights, poses, stencil, *,
                model, order, voxel_size, reg_weight_rho) -> AlbedoSystem
  albedo_cg(system, valid, albedo, stencil, *, reg_weight_rho, damping,
            cg_iters, cg_tol, cg_static, steps_out=None)
      -> (delta [N,3], new albedo [N,3])

Together they replace the JAX package's albedo block as
psgradientsdf_tpu/refine/optimizer.py `_albedo_core` (:77) runs it:
refine/jacobians.py `albedo_jacobian_sh` (:128) / `albedo_jacobian_led`
(:138), refine/solvers.py `solve_albedo` (:424: the einsums :443-444, the
regularizer :446-478, jax.scipy.sparse.linalg.cg :496 or `pcg_fixed` :39)
and `update_albedo` (:502), which XLA keeps in one device program.

The system.  A photometric residual (n, f, c) touches x[n, c] alone, so the
data term is the diagonal diag_ps[n, c] = sum_f J^2 w and the gradient
b[n, c] = sum_f J w r, with J[n, f, c] = -(l_f . SH(ghat_n)) (SH, the same
for every channel) or refl(n, f) l_c (LED, refl = (ghat . R_f p) / |p|^3 of
the residual pass's p_cam), formed per pair and never stored on the card.
Under the regularizer (reg_weight_rho != 0) the rows r_reg [N,3], J0r [N,3]
and Jir [N,3ax,3ch] of solvers.albedo_reg_operator are formed per row, and
b += rho J^T r_reg, diag = diag_ps + rho diag(J^T J) gather the rows that
name a row through the reverse stencil table (distcg.stencil_reverse):
no index_add_, every sum in one fixed order.

albedo_system sums a row's frames as its group of GROUP = 8 lanes does on
the card (four rows a warp): lane k adds frames k, k + 8, ... in order,
then the 8 lane sums are added pairwise; every product and sum is rounded
once, and the kernel (_rn intrinsics) equals the plain version bit for
bit.  albedo_cg runs
`solvers.cg_chunks`' preconditioned CG with both stop rules (scipy's, and
cg_static's fixed trip count), decided on the device, then update_albedo's
rule on its delta; the kernel sums its dots from per-block partials in one
fixed order, the plain version with torch.sum, so the two agree to float32
rounding (the accept rule equals update_albedo on the kernel's own delta
bit for bit).

albedo_cg widens dist_cg's row: a row is a voxel with its three channels,
on distcg._cg_plan's tiles (one block an SM, contiguous tiles on 16-row
starts); the block's own vectors sit in shared memory where the tile fits
(shared_tile_limit), else in device memory.  Without the regularizer (both
recipes) the operator is diagonal and a step crosses two grid barriers,
those of its dots; under it four (p and J p are published between them).

A wrapper takes the plain version ONLY for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  `launch_counts` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from psgradientsdf_tpu_torch.config import LED
from psgradientsdf_tpu_torch.ops import distcg
from psgradientsdf_tpu_torch.ops.distcg import StencilReverse
from psgradientsdf_tpu_torch.refine import geometry, jacobians, render
from psgradientsdf_tpu_torch.refine.problem import RefineProblem
from psgradientsdf_tpu_torch.utils import sh

_LIB_NAME = "albedo"
launch_counts: Dict[str, int] = {"albedo_system": 0, "albedo_cg": 0}

# albedo_system's lanes a row (csrc/albedo.cu kGroup): lane k adds frames
# k, k + GROUP, ...
GROUP = 8


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class AlbedoSystem(NamedTuple):
    """The albedo block's system, [N,3] a tensor (b not yet masked by
    valid); the regularizer's rows None when its weight is 0 (then diag is
    diag_ps)."""
    b: torch.Tensor
    diag_ps: torch.Tensor
    diag: torch.Tensor
    r_reg: Optional[torch.Tensor]
    J0r: Optional[torch.Tensor]
    Jir: Optional[torch.Tensor]      # [N,3ax,3ch]


def inv_voxel(voxel_size: float) -> float:
    """1 / h as the kernels take it: the float32 quotient, correctly
    rounded."""
    return float(np.float32(1.0) / np.float32(voxel_size))


# ---------------------------------------------------------------------------
# the plain PyTorch versions
# ---------------------------------------------------------------------------


def _gather_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[idx] (v [N,3]) where idx >= 0, else 0."""
    return torch.where((idx >= 0)[:, None], v[idx.clamp(min=0).long()], 0.0)


def pair_jacobian(rd, grad_stored, lights, poses, *, model: str, order: int
                  ) -> torch.Tensor:
    """J_rho [N,F,3] of every pair with the kernel's operations:
    jacobians.albedo_jacobian_sh under SH (the same for every channel), and
    under LED jacobians.albedo_jacobian_led's refl l_c with refl from the
    residual pass's p_cam."""
    if model == LED:
        refl = render.led_reflectance(geometry.normalize(grad_stored), rd.p_cam, poses)
        return refl[..., None] * lights[None, None, :]
    J = jacobians.albedo_jacobian_sh(None, grad_stored, lights, order)
    return J[..., None].expand(-1, -1, 3)


def reg_rows(prob: RefineProblem, albedo: torch.Tensor, st: StencilReverse,
             voxel_size: float):
    """(r_reg [N,3], J0r [N,3], Jir [N,3ax,3ch]) of the albedo regularizer
    (solvers.albedo_reg_operator) with the kernel's operations: the FD
    gradient (dir (a_nbr - a)) / h as a product with inv_voxel(h), its
    per-channel norm as geometry.norm3, every sum over the axes in dot3's
    order."""
    inv_h = inv_voxel(voxel_size)
    dirs = prob.nbr_dir
    nbr = st.nbr
    a_nbr = torch.where((nbr >= 0)[..., None], albedo[nbr.clamp(min=0).long()],
                        prob.nbr_albedo_const)                     # [N,3ax,3ch]
    g = (dirs[..., None] * (a_nbr - albedo[:, None, :])) * inv_h
    gc = g.transpose(1, 2)                                         # [N,3ch,3ax]
    nrm = geometry.norm3(gc)
    valid_c = prob.valid[:, None]
    scale = torch.where(nrm != 0.0, torch.reciprocal(torch.clamp(nrm, min=1e-12)), 1.0)
    e = (-inv_h) * dirs                                            # [N,3ax]
    J0 = geometry.dot3(gc, e[:, None, :]) * scale
    Ji = (g * (dirs * inv_h)[..., None]) * scale[:, None, :]
    return (torch.where(valid_c, nrm, 0.0), torch.where(valid_c, J0, 0.0),
            torch.where(prob.valid[:, None, None], Ji, 0.0))


def albedo_system_plain(prob: RefineProblem, rd, albedo, grad_stored, lights, poses,
                        stencil: Optional[StencilReverse], *, model: str, order: int,
                        voxel_size: float, reg_weight_rho: float) -> AlbedoSystem:
    """The albedo block's system with eager PyTorch ops, in the kernel's
    order: each pair's J (w r) and (J J) w summed over the frames of each of
    a row's GROUP lanes, the lanes pairwise (lane k and k ^ 4, then ^ 2,
    ^ 1); then the regularizer's own columns and the columns of the rows
    naming a row, in the reverse table's order."""
    J = pair_jacobian(rd, grad_stored, lights, poses, model=model, order=order)
    w = rd.w
    N, F = w.shape[0], w.shape[1]
    terms = torch.cat([J * (w * rd.r), (J * J) * w], dim=-1)      # [N,F,6]
    Q = -(-F // GROUP)
    lanes = w.new_zeros((N, Q * GROUP, 6))
    lanes[:, :F] = terms
    lanes = lanes.view(N, Q, GROUP, 6)                              # frame q GROUP + k
    acc = w.new_zeros((N, GROUP, 6))
    for q in range(Q):
        acc = acc + lanes[:, q]
    s = GROUP // 2
    while s >= 1:                                                   # the group's butterfly
        acc = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    b, diag_ps = acc[:, 0, :3].contiguous(), acc[:, 0, 3:].contiguous()
    if reg_weight_rho == 0.0:
        return AlbedoSystem(b, diag_ps, diag_ps, None, None, None)
    r_reg, J0r, Jir = reg_rows(prob, albedo, stencil, voxel_size)
    ub, ud = J0r * r_reg, J0r * J0r
    for col in range(6):
        ji = Jir[:, col // 2]
        ub = ub + _gather_rows(ji * r_reg, stencil.rev[:, col])
        ud = ud + _gather_rows(ji * ji, stencil.rev[:, col])
    return AlbedoSystem(b + reg_weight_rho * ub, diag_ps, diag_ps + reg_weight_rho * ud,
                        r_reg, J0r, Jir)


def reg_apply(x: torch.Tensor, sys: AlbedoSystem, st: StencilReverse) -> torch.Tensor:
    """J x [N,3] of the regularizer: the row's own column, then its
    neighbours' along x, y, z."""
    y = sys.J0r * x
    for ax in range(3):
        y = y + sys.Jir[:, ax] * _gather_rows(x, st.nbr[:, ax])
    return y


def reg_apply_T(y: torch.Tensor, sys: AlbedoSystem, st: StencilReverse) -> torch.Tensor:
    """J^T y [N,3] in gather form: the row's own column, then the column of
    each row naming it, in the reverse table's order."""
    out = sys.J0r * y
    for col in range(6):
        out = out + _gather_rows(sys.Jir[:, col // 2] * y, st.rev[:, col])
    return out


def accept(valid: torch.Tensor, albedo: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """albedo - delta where it lies strictly in (0, 1) on a valid row, else
    albedo: the albedo update rule (solvers.update_albedo), which the
    kernel's epilogue repeats."""
    cand = albedo - delta
    ok = (cand > 0.0) & (cand < 1.0) & valid[:, None]
    return torch.where(ok, cand, albedo)


def albedo_cg_plain(sys: AlbedoSystem, valid: torch.Tensor, albedo: torch.Tensor,
                    stencil: Optional[StencilReverse], *, reg_weight_rho: float,
                    damping: float, cg_iters: int, cg_tol: float, cg_static: bool,
                    steps_out: Optional[List] = None,
                    trace: Optional[List] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The albedo block's Jacobi-PCG (distcg.pcg_plain at atol 0, as the
    JAX package's solve_albedo calls its cg), then the accept rule ->
    (delta, new albedo).  The operator is where(valid, diag_ps x + rho J^T
    J x + damping diag x, x)."""
    valid_c = valid[:, None]
    reg = reg_weight_rho != 0.0
    d_safe = distcg.jacobi_diag(valid_c, sys.diag, damping)
    dd = damping * sys.diag

    def matvec(p):
        out = sys.diag_ps * p
        if reg:
            out = out + reg_weight_rho * reg_apply_T(reg_apply(p, sys, stencil), sys, stencil)
        out = out + dd * p
        return torch.where(valid_c, out, p)

    x = distcg.pcg_plain(matvec, torch.where(valid_c, sys.b, 0.0), d_safe,
                         cg_iters=cg_iters, cg_tol=cg_tol, cg_static=cg_static,
                         steps_out=steps_out, trace=trace)
    delta = torch.where(valid_c, x, 0.0)
    return delta, accept(valid, albedo, delta)


# ---------------------------------------------------------------------------
# the CG's launch plan
# ---------------------------------------------------------------------------

# the block's own vectors, 3 floats a row each: x, r, z, A p, p, the safe
# diagonal, damping diag, diag_ps (csrc/albedo.cu kVectors)
_VECTORS = 8
# shared memory before the vectors: the warps' sums [warps][2] and the
# grid's (16 bytes) (csrc/albedo.cu kHeader)
_HEADER = (distcg.CG_THREADS // 32) * 2 * 4 + 16


class AlbedoPlan(NamedTuple):
    """albedo_cg's launch for N voxels: distcg._cg_plan's blocks and tile,
    the block's dynamic shared memory and whether its own vectors are
    there."""
    blocks: int
    tile: int
    smem_bytes: int
    shared: bool


def shared_tile_limit() -> int:
    """The most voxels a block's tile may hold with its vectors in shared
    memory (a multiple of distcg.TILE_ROWS)."""
    per = distcg.TILE_ROWS * 4 * 3 * _VECTORS
    return (distcg.SMEM_PER_BLOCK - _HEADER) // per * distcg.TILE_ROWS


def _albedo_plan(N: int, *, sms: int) -> AlbedoPlan:
    """albedo_cg's launch for N voxels on a card of `sms` SMs: the tiles of
    distcg._cg_plan (rows = voxels), the vectors in shared memory where the
    tile fits shared_tile_limit."""
    tiles = distcg._cg_plan(N, use_lap=False, lap_nbr=False, sms=sms)
    shared = tiles.tile <= shared_tile_limit()
    smem = _HEADER + (4 * 3 * _VECTORS * tiles.tile if shared else 0)
    return AlbedoPlan(tiles.blocks, tiles.tile, smem, shared)


_bound = None
_plans: Dict[tuple, AlbedoPlan] = {}
_occupancy: Dict[tuple, int] = {}


def cg_plan(dev: torch.device, N: int, *, reg: bool) -> AlbedoPlan:
    """_albedo_plan on `dev`'s SMs, found once; its cooperative occupancy at
    its shared memory checked once per (device, instance, bytes): a plan the
    card cannot run raises."""
    key = (dev.index, N)
    plan = _plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _plans[key] = _albedo_plan(N, sms=sms)
    okey = (dev.index, bool(reg), plan.smem_bytes)
    if okey not in _occupancy:
        per_sm = ctypes.c_int64()
        with torch.cuda.device(dev):
            rc = _library().albedo_cg_occupancy(int(reg), plan.smem_bytes,
                                                ctypes.byref(per_sm))
        if rc != 0 or per_sm.value < 1:
            raise RuntimeError(
                f"albedo_cg: {plan.smem_bytes} bytes of shared memory do not run "
                f"cooperatively on {dev} (CUDA error {rc}, {per_sm.value} blocks an SM)")
        _occupancy[okey] = per_sm.value
    return plan


def _work_floats(plan: AlbedoPlan, N: int, reg: bool) -> int:
    """albedo_cg's work buffer: the published p and y (regularizer), then
    the own vectors where they are not in shared memory."""
    return (6 * N if reg else 0) + (0 if plan.shared else 3 * _VECTORS * N)


# ---------------------------------------------------------------------------
# argument checks and the library binding
# ---------------------------------------------------------------------------


class _SystemArgs(ctypes.Structure):
    """csrc/albedo.cu SystemArgs, field for field (every field 8 bytes)."""
    _p, _i, _d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    _fields_ = [("w", _p), ("r", _p), ("p_cam", _p), ("grad", _p), ("lights", _p),
                ("poses", _p), ("valid", _p), ("albedo", _p), ("nbr", _p), ("rev", _p),
                ("nbr_dir", _p), ("nbr_const", _p), ("b", _p), ("diag_ps", _p),
                ("diag", _p), ("r_reg", _p), ("J0r", _p), ("Jir", _p), ("n", _i),
                ("f", _i), ("basis", _i), ("led", _i), ("reg", _i), ("inv_h", _d),
                ("reg_weight_rho", _d)]


class _CgArgs(ctypes.Structure):
    """csrc/albedo.cu CgArgs, field for field (every field 8 bytes)."""
    _p, _i, _d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    _fields_ = [("b", _p), ("diag_ps", _p), ("diag", _p), ("J0r", _p), ("Jir", _p),
                ("nbr", _p), ("rev", _p), ("valid", _p), ("albedo", _p), ("delta", _p),
                ("albedo_out", _p), ("steps", _p), ("work", _p), ("sync", _p),
                ("n", _i), ("maxiter", _i), ("fixed", _i), ("reg", _i), ("blocks", _i),
                ("tile", _i), ("smem_bytes", _i), ("shared", _i),
                ("reg_weight_rho", _d), ("damping", _d), ("tol_sq", _d)]


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        lib.albedo_system.argtypes = [ctypes.POINTER(_SystemArgs), ctypes.c_void_p]
        lib.albedo_system.restype = ctypes.c_int
        lib.albedo_cg.argtypes = [ctypes.POINTER(_CgArgs), ctypes.c_void_p]
        lib.albedo_cg.restype = ctypes.c_int
        lib.albedo_cg_occupancy.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                            ctypes.POINTER(ctypes.c_int64)]
        lib.albedo_cg_occupancy.restype = ctypes.c_int
        _bound = lib
    return _bound


def _launch(name: str, args, dev) -> None:
    with torch.cuda.device(dev):
        rc = getattr(_library(), name)(ctypes.byref(args),
                                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    launch_counts[name] += 1


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def albedo_system(prob: RefineProblem, rd, albedo: torch.Tensor,
                  grad_stored: torch.Tensor, lights: torch.Tensor,
                  poses: torch.Tensor, stencil: Optional[StencilReverse], *,
                  model: str, order: int, voxel_size: float,
                  reg_weight_rho: float) -> AlbedoSystem:
    """The albedo block's system from the residual pass rd (w, r and, under
    LED, p_cam [N,F,3]), the stored gradient [N,3], the lights ([F,B] SH,
    [3] LED) and the poses [F,4,4] (LED); under the regularizer the albedo
    [N,3] and the problem's reverse stencil table: one kernel launch on the
    card, albedo_system_plain on the CPU."""
    kw = dict(model=model, order=order, voxel_size=voxel_size,
              reg_weight_rho=reg_weight_rho)
    w = rd.w
    if w.device.type == "cpu":
        return albedo_system_plain(prob, rd, albedo, grad_stored, lights, poses,
                                   stencil, **kw)
    N, F = w.shape[0], w.shape[1]
    led, reg = model == LED, reg_weight_rho != 0.0
    B = sh.n_basis(order)
    f32, i32 = torch.float32, torch.int32
    named = [("rd.w", w, (N, F, 3), f32), ("rd.r", rd.r, (N, F, 3), f32),
             ("grad_stored", grad_stored, (N, 3), f32),
             ("valid", prob.valid, (N,), torch.bool)]
    if led:
        named += [("rd.p_cam", rd.p_cam, (N, F, 3), f32), ("lights", lights, (3,), f32),
                  ("poses", poses, (F, 4, 4), f32)]
    else:
        named.append(("lights", lights, (F, B), f32))
    if reg:
        named += [("albedo", albedo, (N, 3), f32), ("stencil.nbr", stencil.nbr, (N, 3), i32),
                  ("stencil.rev", stencil.rev, (N, 6), i32),
                  ("prob.nbr_dir", prob.nbr_dir, (N, 3), f32),
                  ("prob.nbr_albedo_const", prob.nbr_albedo_const, (N, 3, 3), f32)]
    distcg._check("albedo_system", w.device, named)
    out = lambda *shape: torch.empty((N,) + shape, dtype=f32, device=w.device)
    b, diag_ps = out(3), out(3)
    if reg:
        diag, r_reg, J0r, Jir = out(3), out(3), out(3), out(3, 3)
    else:
        diag, r_reg, J0r, Jir = diag_ps, None, None, None
    a = _SystemArgs()
    a.w, a.r, a.grad = w.data_ptr(), rd.r.data_ptr(), grad_stored.data_ptr()
    a.lights, a.valid = lights.data_ptr(), prob.valid.data_ptr()
    if led:
        a.p_cam, a.poses = rd.p_cam.data_ptr(), poses.data_ptr()
    if reg:
        a.albedo = albedo.data_ptr()
        a.nbr, a.rev = stencil.nbr.data_ptr(), stencil.rev.data_ptr()
        a.nbr_dir, a.nbr_const = prob.nbr_dir.data_ptr(), prob.nbr_albedo_const.data_ptr()
        a.diag, a.r_reg, a.J0r, a.Jir = (diag.data_ptr(), r_reg.data_ptr(), J0r.data_ptr(),
                                         Jir.data_ptr())
    a.b, a.diag_ps = b.data_ptr(), diag_ps.data_ptr()
    a.n, a.f, a.basis, a.led, a.reg = N, F, B, int(led), int(reg)
    a.inv_h, a.reg_weight_rho = inv_voxel(voxel_size), float(reg_weight_rho)
    _launch("albedo_system", a, w.device)
    return AlbedoSystem(b, diag_ps, diag, r_reg, J0r, Jir)


def albedo_cg(sys: AlbedoSystem, valid: torch.Tensor, albedo: torch.Tensor,
              stencil: Optional[StencilReverse], *, reg_weight_rho: float,
              damping: float, cg_iters: int, cg_tol: float, cg_static: bool,
              steps_out: Optional[List] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The albedo step delta [N,3] (0 on invalid rows) and the new albedo
    [N,3] (albedo - delta where it lies in (0, 1) on a valid row): the
    whole Jacobi-PCG and the accept rule in ONE cooperative launch on the
    card, its stop decided there (nothing read back; `steps_out` receives
    the step count as a 0-dim int64 tensor on the card), albedo_cg_plain on
    the CPU.  `stencil` (the reverse table) is read under the regularizer
    only."""
    kw = dict(reg_weight_rho=reg_weight_rho, damping=damping, cg_iters=cg_iters,
              cg_tol=cg_tol, cg_static=cg_static, steps_out=steps_out)
    b = sys.b
    if b.device.type == "cpu":
        return albedo_cg_plain(sys, valid, albedo, stencil, **kw)
    N = b.shape[0]
    reg = reg_weight_rho != 0.0
    f32, i32 = torch.float32, torch.int32
    named = [("b", b, (N, 3), f32), ("diag_ps", sys.diag_ps, (N, 3), f32),
             ("diag", sys.diag, (N, 3), f32), ("valid", valid, (N,), torch.bool),
             ("albedo", albedo, (N, 3), f32)]
    if reg:
        named += [("J0r", sys.J0r, (N, 3), f32), ("Jir", sys.Jir, (N, 3, 3), f32),
                  ("stencil.nbr", stencil.nbr, (N, 3), i32),
                  ("stencil.rev", stencil.rev, (N, 6), i32)]
    dev = b.device
    distcg._check("albedo_cg", dev, named)
    if cg_iters < 0:
        raise ValueError(f"albedo_cg: cg_iters must be >= 0, got {cg_iters}")
    plan = cg_plan(dev, N, reg=reg)
    delta = torch.empty((N, 3), dtype=f32, device=dev)
    new = torch.empty((N, 3), dtype=f32, device=dev)
    steps = torch.empty((1,), dtype=torch.int64, device=dev)
    work = torch.empty((max(_work_floats(plan, N, reg), 1),), dtype=f32, device=dev)
    sync = distcg._sync_words(plan, dev)
    a = _CgArgs()
    a.b, a.diag_ps, a.diag = b.data_ptr(), sys.diag_ps.data_ptr(), sys.diag.data_ptr()
    if reg:
        a.J0r, a.Jir = sys.J0r.data_ptr(), sys.Jir.data_ptr()
        a.nbr, a.rev = stencil.nbr.data_ptr(), stencil.rev.data_ptr()
    a.valid, a.albedo = valid.data_ptr(), albedo.data_ptr()
    a.delta, a.albedo_out, a.steps = delta.data_ptr(), new.data_ptr(), steps.data_ptr()
    a.work, a.sync = work.data_ptr(), sync.data_ptr()
    a.n, a.maxiter, a.fixed, a.reg = N, cg_iters, int(cg_static), int(reg)
    a.blocks, a.tile, a.smem_bytes, a.shared = (plan.blocks, plan.tile, plan.smem_bytes,
                                                int(plan.shared))
    a.reg_weight_rho, a.damping = float(reg_weight_rho), float(damping)
    a.tol_sq = cg_tol * cg_tol
    _launch("albedo_cg", a, dev)
    if steps_out is not None:
        steps_out.append(steps.view(()))
    return delta, new
