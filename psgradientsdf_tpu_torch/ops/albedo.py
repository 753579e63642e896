"""The albedo block's solve: its data terms formed per (voxel, keyframe)
pair (and the regularizer's rows), then the whole Jacobi-preconditioned CG
with the (0, 1) accept rule, in ONE launch of the hand-written Hopper
kernel in csrc/albedo.cu, or the plain PyTorch versions for CPU tensors.

  albedo_block(prob, rd, albedo, grad_stored, lights, poses, stencil, *,
               model, order, voxel_size, reg_weight_rho, damping, cg_iters,
               cg_tol, cg_static, steps_out=None, system_out=None,
               barriers_out=None) -> (delta [N,3], new albedo [N,3])

It replaces the JAX package's albedo block as
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

albedo_system_plain sums a row's frames as its group of GROUP = 8 lanes
does on the card (four rows a warp): lane k adds frames k, k + 8, ... in
order, then the 8 lane sums are added pairwise; every product and sum is
rounded once, and the kernel (_rn intrinsics) equals the plain version bit
for bit.  albedo_cg_plain runs `solvers.cg_chunks`' preconditioned CG with
both stop rules (scipy's, and cg_static's fixed trip count), then
update_albedo's rule on its delta; the kernel decides both rules on the
device and sums its dots from per-block partials in one fixed order, the
plain version with torch.sum, so the two agree to float32 rounding (the
accept rule equals update_albedo on the kernel's own delta bit for bit).

The launch (_albedo_plan) runs on distcg._cg_plan's tiles (one block an SM,
contiguous tiles of voxels on 16-row starts).  Each warp streams stages of
STAGE_ROWS voxel rows of w, r (and p_cam) and of the stored gradient
through its own ring of `depth` stages in shared memory by bulk copies
(stage_list is the order), forms
the rows' b and diag_ps straight into the block's CG vectors (in shared
memory up to shared_tile_limit voxels a block, else in device memory), and
runs the CG there.  Without the regularizer (both recipes) the operator is
diagonal: step 0's p.Ap rides on the prologue's barrier and a later step
crosses two, so the recipes' one-step solve crosses two grid barriers in
all; under the regularizer a step crosses four (p and J p are published
between them).

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
launch_counts: Dict[str, int] = {"albedo_block": 0}

# the kernel's lanes a row (csrc/albedo.cu kGroup): lane k adds frames k,
# k + GROUP, ...
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


def grid_barriers(reg: bool, steps: int) -> int:
    """The grid barriers albedo_block's kernel crosses in a solve of `steps`
    steps: without the regularizer the prologue's grid.sync (carrying step
    0's p.Ap too), then two a step but one at step 0; under it the grid.sync
    before the transposes, the prologue's barrier and four a step."""
    if reg:
        return 2 + 4 * steps
    return 2 * steps if steps else 1


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

WARPS = distcg.CG_THREADS // 32
# voxel rows a stage (csrc/albedo.cu kStageRows): a warp's four groups of
# GROUP lanes, one row each
STAGE_ROWS = 32 // GROUP
# the most stages a warp's ring holds
DEPTH = 2
# floats each block publishes a barrier (csrc/albedo.cu kSlots): the
# prologue's b.b, r.z and p.Ap
SLOTS = 4
# shared memory before the warps' mbarriers: the warps' sums [warps][SLOTS]
# and the grid's (16 bytes) (csrc/albedo.cu kHeader)
_HEADER = WARPS * SLOTS * 4 + 16
# the block's own vectors, 3 floats a row each: x, r, z, A p, p, the safe
# diagonal, damping diag, diag_ps (csrc/albedo.cu kVectors)
_VECTORS = 8
_ROW_BYTES = 4 * 3 * _VECTORS


class AlbedoPlan(NamedTuple):
    """albedo_block's launch for N voxels at F keyframes (csrc/albedo.cu
    BlockPlan): distcg._cg_plan's blocks and tile; whether the CG's vectors
    sit in shared memory; the stages a warp's ring holds (0: the pairs read
    from device memory) and a stage's bytes; the rings' and the vectors'
    offsets and the block's dynamic shared memory."""
    blocks: int
    tile: int
    shared: bool
    depth: int
    stage_bytes: int
    ring: int
    vec: int
    smem_bytes: int


def _stage_bytes(F: int, led: bool) -> int:
    """A stage: STAGE_ROWS rows of w and r (LED: and p_cam), F x 3 floats
    each, then their stored gradients, 3 floats each; always a multiple of
    16 bytes."""
    return STAGE_ROWS * (F * 12 * (3 if led else 2) + 12)


def _rings(depth: int, F: int, led: bool) -> Tuple[int, int]:
    """(the rings' offset, their end) at `depth` stages a warp: the warps'
    mbarriers after the header, the rings from the next 16-byte
    boundary."""
    ring = distcg._up16(_HEADER + 8 * WARPS * depth)
    return ring, ring + WARPS * depth * _stage_bytes(F, led)


def shared_tile_limit(F: int, *, led: bool) -> int:
    """The most voxels a block's tile may hold with the CG's vectors in
    shared memory, a multiple of distcg.TILE_ROWS, beside rings of one
    stage a warp where such rings fit at all."""
    _, end = _rings(1, F, led)
    if end > distcg.SMEM_PER_BLOCK:
        _, end = _rings(0, F, led)
    per = distcg.TILE_ROWS * _ROW_BYTES
    return (distcg.SMEM_PER_BLOCK - end) // per * distcg.TILE_ROWS


def _albedo_plan(N: int, F: int, *, led: bool, sms: int) -> AlbedoPlan:
    """albedo_block's launch for N voxels at F keyframes on a card of `sms`
    SMs: the tiles of distcg._cg_plan (rows = voxels), the vectors in
    shared memory where the tile fits shared_tile_limit, and the deepest
    ring, up to DEPTH stages a warp, that fits beside them."""
    if F < 1:
        raise ValueError(f"albedo_block: no plan for {F} keyframes")
    tiles = distcg._cg_plan(N, use_lap=False, lap_nbr=False, sms=sms)
    shared = tiles.tile <= shared_tile_limit(F, led=led)
    vec_bytes = _ROW_BYTES * tiles.tile if shared else 0
    depth = next((d for d in range(DEPTH, 0, -1)
                  if _rings(d, F, led)[1] + vec_bytes <= distcg.SMEM_PER_BLOCK), 0)
    ring, end = _rings(depth, F, led)
    return AlbedoPlan(tiles.blocks, tiles.tile, shared, depth, _stage_bytes(F, led), ring,
                      end if shared else 0, end + vec_bytes)


def stage_list(plan: AlbedoPlan, N: int, F: int, *, led: bool, base: int = 0
               ) -> Dict[str, np.ndarray]:
    """Every stage the kernel reads on `plan`, as its warps take them: block
    b's tile [b tile, ...) in stages of STAGE_ROWS voxel rows, stage s to
    warp s % WARPS as its turn j = s // WARPS, into slot j % depth of that
    warp's ring.  A stage is one bulk copy a span (its rows of each pair
    tensor, F x 12 bytes a row, and of the stored gradient, 12 bytes a row)
    where every span is 16-byte aligned and sized, the tensors' bases lying
    `base` bytes past a 16-byte boundary; else the warp's lanes load it (so
    at depth 0, where the pairs are read from device memory).  `offset` and
    `bytes` are a pair tensor's span -> {field: array}."""
    blocks = np.arange(plan.blocks, dtype=np.int64)
    rows = np.minimum(N - blocks * plan.tile, plan.tile)
    stages = -(-rows // STAGE_ROWS)
    block = np.repeat(blocks, stages)
    s = np.arange(int(stages.sum()), dtype=np.int64) - np.repeat(np.cumsum(stages) - stages,
                                                                 stages)
    row0 = block * plan.tile + STAGE_ROWS * s
    nrows = np.minimum(STAGE_ROWS, N - row0)
    offset = row0 * F * 12 + base
    nbytes = nrows * F * 12
    j = s // WARPS
    staged = plan.depth > 0
    return dict(block=block, warp=s % WARPS, turn=j,
                slot=j % plan.depth if staged else np.full_like(j, -1),
                row0=row0, rows=nrows, offset=offset, bytes=nbytes,
                bulk=((offset % 16 == 0) & (nbytes % 16 == 0) & ((row0 * 12 + base) % 16 == 0)
                      & (nrows * 12 % 16 == 0)) & staged)


_bound = None
_plans: Dict[tuple, AlbedoPlan] = {}
_occupancy: Dict[tuple, int] = {}


def block_plan(dev: torch.device, N: int, F: int, *, led: bool, reg: bool) -> AlbedoPlan:
    """_albedo_plan on `dev`'s SMs, found once; its cooperative occupancy at
    its shared memory checked once per (device, instance, bytes): a plan the
    card cannot run raises."""
    key = (dev.index, N, F, bool(led))
    plan = _plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _plans[key] = _albedo_plan(N, F, led=led, sms=sms)
    okey = (dev.index, bool(led), bool(reg), plan.smem_bytes)
    if okey not in _occupancy:
        per_sm = ctypes.c_int64()
        with torch.cuda.device(dev):
            rc = _library().albedo_block_occupancy(int(led), int(reg), plan.smem_bytes,
                                                   ctypes.byref(per_sm))
        if rc != 0 or per_sm.value < 1:
            raise RuntimeError(
                f"albedo_block: {plan.smem_bytes} bytes of shared memory do not run "
                f"cooperatively on {dev} (CUDA error {rc}, {per_sm.value} blocks an SM)")
        _occupancy[okey] = per_sm.value
    return plan


def _work_floats(plan: AlbedoPlan, N: int, reg: bool) -> int:
    """albedo_block's work buffer: the published p and y and the rows r_reg,
    J0r (3 N each) and Jir (9 N) under the regularizer, then the own vectors
    where they are not in shared memory."""
    return (21 * N if reg else 0) + (0 if plan.shared else 3 * _VECTORS * N)


def _sync_words(plan: AlbedoPlan, dev) -> torch.Tensor:
    """The barriers' counter (4 words, set to 0 by the kernel) and the
    blocks' partials [2][blocks][SLOTS] floats, in one buffer."""
    return torch.empty((4 + 2 * SLOTS * plan.blocks,), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# argument checks, the library binding and the launch
# ---------------------------------------------------------------------------


class _BlockPlan(ctypes.Structure):
    """csrc/albedo.cu BlockPlan, field for field."""
    _fields_ = [(n, ctypes.c_int64) for n in AlbedoPlan._fields]


class _BlockArgs(ctypes.Structure):
    """csrc/albedo.cu BlockArgs, field for field (every field 8 bytes but
    the plan)."""
    _p, _i, _d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    _fields_ = [("w", _p), ("r", _p), ("p_cam", _p), ("grad", _p), ("lights", _p),
                ("poses", _p), ("valid", _p), ("albedo", _p), ("nbr", _p), ("rev", _p),
                ("nbr_dir", _p), ("nbr_const", _p), ("delta", _p), ("albedo_out", _p),
                ("steps", _p), ("work", _p), ("sync", _p), ("b_out", _p),
                ("diag_ps_out", _p), ("diag_out", _p), ("b_in", _p), ("diag_ps_in", _p),
                ("n", _i), ("f", _i), ("basis", _i), ("led", _i), ("reg", _i),
                ("maxiter", _i), ("fixed", _i), ("phases", _i), ("inv_h", _d),
                ("reg_weight_rho", _d), ("damping", _d), ("tol_sq", _d),
                ("plan", _BlockPlan)]


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        lib.albedo_block.argtypes = [ctypes.POINTER(_BlockArgs), ctypes.c_void_p]
        lib.albedo_block.restype = ctypes.c_int
        lib.albedo_block_occupancy.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                               ctypes.POINTER(ctypes.c_int64)]
        lib.albedo_block_occupancy.restype = ctypes.c_int
        _bound = lib
    return _bound


def _launch_block(prob: RefineProblem, rd, albedo: torch.Tensor, grad_stored: torch.Tensor,
                  lights: torch.Tensor, poses: torch.Tensor,
                  stencil: Optional[StencilReverse], *, model: str, order: int,
                  voxel_size: float, reg_weight_rho: float, damping: float, cg_iters: int,
                  cg_tol: float, cg_static: bool, want_system: bool = False,
                  phases: int = 3, system_in: Optional[AlbedoSystem] = None):
    """One launch of albedo_block's kernel on the card -> (delta, new
    albedo, steps [2] int64: the steps and the grid barriers crossed, the
    system written out with `want_system` else None).  `phases` 3 is the
    block; without the regularizer 1 forms the system alone (written out)
    and 2 solves `system_in`, the two-launch form that
    tools/albedo_block_ab.py times."""
    w = rd.w
    N, F = w.shape[0], w.shape[1]
    led, reg = model == LED, reg_weight_rho != 0.0
    if phases not in (1, 2, 3) or (reg and phases != 3):
        raise ValueError(f"albedo_block: phases {phases} (regularizer {reg})")
    B = sh.n_basis(order)
    f32, i32 = torch.float32, torch.int32
    named = [("valid", prob.valid, (N,), torch.bool), ("albedo", albedo, (N, 3), f32)]
    if phases & 1:
        named += [("rd.w", w, (N, F, 3), f32), ("rd.r", rd.r, (N, F, 3), f32),
                  ("grad_stored", grad_stored, (N, 3), f32)]
        if led:
            named += [("rd.p_cam", rd.p_cam, (N, F, 3), f32), ("lights", lights, (3,), f32),
                      ("poses", poses, (F, 4, 4), f32)]
        else:
            named.append(("lights", lights, (F, B), f32))
    else:
        named += [("system_in.b", system_in.b, (N, 3), f32),
                  ("system_in.diag_ps", system_in.diag_ps, (N, 3), f32)]
    if reg:
        named += [("stencil.nbr", stencil.nbr, (N, 3), i32),
                  ("stencil.rev", stencil.rev, (N, 6), i32),
                  ("prob.nbr_dir", prob.nbr_dir, (N, 3), f32),
                  ("prob.nbr_albedo_const", prob.nbr_albedo_const, (N, 3, 3), f32)]
    dev = w.device
    distcg._check("albedo_block", dev, named)
    if cg_iters < 0:
        raise ValueError(f"albedo_block: cg_iters must be >= 0, got {cg_iters}")
    plan = block_plan(dev, N, F, led=led, reg=reg)
    out = lambda *shape: torch.empty((N,) + shape, dtype=f32, device=dev)
    delta, new = out(3), out(3)
    steps = torch.empty((2,), dtype=torch.int64, device=dev)
    work = torch.empty((max(_work_floats(plan, N, reg), 1),), dtype=f32, device=dev)
    sync = _sync_words(plan, dev)
    a = _BlockArgs()
    if phases & 1:
        a.w, a.r, a.grad = w.data_ptr(), rd.r.data_ptr(), grad_stored.data_ptr()
        a.lights = lights.data_ptr()
        if led:
            a.p_cam, a.poses = rd.p_cam.data_ptr(), poses.data_ptr()
    else:
        a.b_in, a.diag_ps_in = system_in.b.data_ptr(), system_in.diag_ps.data_ptr()
    a.valid, a.albedo = prob.valid.data_ptr(), albedo.data_ptr()
    if reg:
        a.nbr, a.rev = stencil.nbr.data_ptr(), stencil.rev.data_ptr()
        a.nbr_dir, a.nbr_const = prob.nbr_dir.data_ptr(), prob.nbr_albedo_const.data_ptr()
    a.delta, a.albedo_out, a.steps = delta.data_ptr(), new.data_ptr(), steps.data_ptr()
    a.work, a.sync = work.data_ptr(), sync.data_ptr()
    system = None
    if want_system or phases == 1:
        b, diag_ps = out(3), out(3)
        diag = out(3) if reg else diag_ps
        a.b_out, a.diag_ps_out, a.diag_out = b.data_ptr(), diag_ps.data_ptr(), diag.data_ptr()
        # the regularizer's rows stay in the work buffer: views of them
        rows = ((work[6 * N:9 * N].view(N, 3), work[9 * N:12 * N].view(N, 3),
                 work[12 * N:21 * N].view(N, 3, 3)) if reg else (None, None, None))
        system = AlbedoSystem(b, diag_ps, diag, *rows)
    a.n, a.f, a.basis, a.led, a.reg = N, F, B, int(led), int(reg)
    a.maxiter, a.fixed, a.phases = cg_iters, int(cg_static), phases
    a.inv_h, a.reg_weight_rho = inv_voxel(voxel_size), float(reg_weight_rho)
    a.damping, a.tol_sq = float(damping), cg_tol * cg_tol
    a.plan = _BlockPlan(*plan)
    with torch.cuda.device(dev):
        rc = _library().albedo_block(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"albedo_block: kernel launch failed, CUDA error {rc}")
    launch_counts["albedo_block"] += 1
    return delta, new, steps, system


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def albedo_block(prob: RefineProblem, rd, albedo: torch.Tensor, grad_stored: torch.Tensor,
                 lights: torch.Tensor, poses: torch.Tensor,
                 stencil: Optional[StencilReverse], *, model: str, order: int,
                 voxel_size: float, reg_weight_rho: float, damping: float, cg_iters: int,
                 cg_tol: float, cg_static: bool, steps_out: Optional[List] = None,
                 system_out: Optional[List] = None,
                 barriers_out: Optional[List] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The albedo block from the residual pass rd (w, r and, under LED,
    p_cam [N,F,3]), the albedo [N,3], the stored gradient [N,3], the lights
    ([F,B] SH, [3] LED), the poses [F,4,4] (LED) and, under the regularizer,
    the problem's reverse stencil table: the step delta [N,3] (0 on invalid
    rows) and the new albedo [N,3] (albedo - delta where it lies in (0, 1)
    on a valid row).  On the card ONE cooperative launch forms the system
    and runs the whole Jacobi-PCG and the accept rule, its stop decided
    there (nothing read back); on the CPU albedo_cg_plain on
    albedo_system_plain.  `steps_out` receives the step count as a 0-dim
    int64 tensor, `barriers_out` the grid barriers the kernel crossed (on
    the CPU the count it would cross, grid_barriers), `system_out` the
    AlbedoSystem (on the card written out by the kernel too: a check's
    view of what the main path keeps in shared memory)."""
    skw = dict(model=model, order=order, voxel_size=voxel_size, reg_weight_rho=reg_weight_rho)
    ckw = dict(damping=damping, cg_iters=cg_iters, cg_tol=cg_tol, cg_static=cg_static)
    w = rd.w
    if w.device.type == "cpu":
        sys = albedo_system_plain(prob, rd, albedo, grad_stored, lights, poses, stencil, **skw)
        steps = []
        delta, new = albedo_cg_plain(sys, prob.valid, albedo, stencil,
                                     reg_weight_rho=reg_weight_rho, **ckw, steps_out=steps)
        count = steps[0]
        if system_out is not None:
            system_out.append(sys)
        if barriers_out is not None:
            barriers_out.append(torch.tensor(grid_barriers(reg_weight_rho != 0.0, int(count))))
        if steps_out is not None:
            steps_out.append(count)
        return delta, new
    delta, new, steps, sys = _launch_block(prob, rd, albedo, grad_stored, lights, poses,
                                           stencil, **skw, **ckw,
                                           want_system=system_out is not None)
    if system_out is not None:
        system_out.append(sys)
    if steps_out is not None:
        steps_out.append(steps[0])
    if barriers_out is not None:
        barriers_out.append(steps[1])
    return delta, new
