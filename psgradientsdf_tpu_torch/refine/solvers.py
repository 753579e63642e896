"""Matrix-free block Gauss-Newton solves for the alternating refinement.

Replaces the reference's Eigen sparse-triplet assembly + ConjugateGradient
(PsOptimizer.cpp:85-234) with dense batched linear algebra:

  * light / pose blocks: the normal equations are exactly block-diagonal
    (each residual touches one frame), so the "CG solve on the full sparse
    system" of the reference reduces to per-frame BxB / 6x6 dense solves
    — mathematically identical;
  * albedo / distance blocks: matrix-free CG where H.x is computed by a
    forward J.x (gathers over the 4-voxel stencil) followed by J^T.(W.J.x)
    (scatter-adds at the same indices) — no sparse matrix is ever built,
    and the reference's O(N) std::find per nonzero disappears;
  * damping is the reference's multiplicative diag scaling
    H.diag += damping * H.diag (PsOptimizer.cpp:103-105).

The scatter-adds are `index_add_`.  On a CUDA device it adds with atomics in
no fixed order, so two runs there agree to rounding, not bit for bit, and
the device is held against the CPU by tolerance.  The distance and albedo
blocks' solves on one device have none: `solve_distance` assembles the
normal equations per row and runs the whole CG through ops/distcg.py
(`distance_step`, the one-device block's, with its regularizers and update
as stages of those two launches), and
`solve_albedo` forms its system and runs its CG and update through
ops/albedo.py (one kernel launch on the card), with the transposes in
gather form.  The albedo block's eager operators below (albedo_data_terms,
albedo_reg_*) are the mesh's (parallel/refine.py) and the references the
tests hold ops/albedo.py to.

On a device mesh (parallel/refine.py) every operator runs on one shard's
rows: `src=` names the full N-vector that neighbours are read from (the
shard's own entries come from the argument), and `rows=(lo, N)` makes a
transpose or a diagonal return a full-length partial — the shard's own
entries at lo, its scatter-adds into neighbours at their global indices —
for the mesh to sum and split back (mesh.reduce_scatter).  Without them
every operator is the single-device one.

Update rules mirror OptimizerAux.cpp:108-205: clamped albedo updates,
distance-step rejection at sqrt(3)*h, split translation/rotation pose
update t -= xi_t, R <- R exp(-xi_w).  Every update returns new tensors and
leaves its inputs untouched.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from psgradientsdf_tpu_torch.ops import albedo as albedo_ops
from psgradientsdf_tpu_torch.ops import distcg, distreg, smallsolve
from psgradientsdf_tpu_torch.ops.distcg import jacobi_diag
from psgradientsdf_tpu_torch.refine import geometry
from psgradientsdf_tpu_torch.refine.jacobians import DistJacobian
from psgradientsdf_tpu_torch.refine.problem import RefineProblem
from psgradientsdf_tpu_torch.refine.render import ResidualData
from psgradientsdf_tpu_torch.utils import se3

# CG steps between two reads of the stop flag (one host sync each)
CG_POLL_EVERY = 10


# ------------------------------------------------------------------------ CG

def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def _one(fn):
    return lambda xs: [fn(xs[0])]


def cg_chunks(matvec, b: Sequence[torch.Tensor], M_inv, maxiter: int, tol: float,
              atol: float = 0.0, steps_out: Optional[List] = None, *,
              fixed: bool = False, dot=None, spread=None) -> List[torch.Tensor]:
    """Jacobi-preconditioned CG from x0 = 0 over a vector held in chunks
    (a list of tensors; one chunk on one device, or a mesh's row chunks).
    `matvec` and `M_inv` map chunk lists to chunk lists; `dot(xs, ys)` is
    the dot product as a 0-dim tensor (by default that of a single chunk)
    and `spread(s)` puts a 0-dim tensor beside each chunk (by default the
    same tensor for every chunk).

    fixed=False is the stop rule of scipy.sparse.linalg.cg: before each
    step, stop when r.r <= max(tol^2 b.b, atol^2); at most `maxiter` steps.
    The test runs on the device every step and freezes the iterate with
    masked updates; the host reads the flag only every CG_POLL_EVERY steps
    to leave the loop, so the result equals the step-by-step rule exactly.
    `steps_out`, if given, receives the number of steps taken as a 0-dim
    tensor (not read back here).  fixed=True runs all `maxiter` steps with
    the same masked exit at r.r <= tol^2 b.b and reads nothing back."""
    if dot is None:
        dot = lambda xs, ys: _vdot(xs[0], ys[0])
    if spread is None:
        spread = lambda s: [s] * len(b)

    bb = dot(b, b)
    thr = (tol * tol) * bb if fixed else torch.clamp((tol * tol) * bb, min=atol * atol)
    x = [torch.zeros_like(c) for c in b]
    r = list(b)
    p = M_inv(r)
    gamma = dot(r, p)
    steps = torch.zeros((), dtype=torch.int64, device=bb.device)
    for k in range(maxiter):
        active = dot(r, r) > thr
        if not fixed and k % CG_POLL_EVERY == 0 and not bool(active):
            break
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = spread(gamma / (torch.clamp(pAp, min=1e-30) if fixed else pAp))
        x_n = [xi + a * pi for xi, a, pi in zip(x, alpha, p)]
        r_n = [ri - a * api for ri, a, api in zip(r, alpha, Ap)]
        z_n = M_inv(r_n)
        gamma_n = dot(r_n, z_n)
        beta = spread(gamma_n / (torch.clamp(gamma, min=1e-30) if fixed else gamma))
        p_n = [zi + bt * pi for zi, bt, pi in zip(z_n, beta, p)]
        act = spread(active)
        x = [torch.where(a, n, o) for a, n, o in zip(act, x_n, x)]
        r = [torch.where(a, n, o) for a, n, o in zip(act, r_n, r)]
        p = [torch.where(a, n, o) for a, n, o in zip(act, p_n, p)]
        gamma = torch.where(active, gamma_n, gamma)
        if not fixed:
            steps = steps + active
    if steps_out is not None and not fixed:
        steps_out.append(steps)
    return x


def pcg_fixed(matvec, b: torch.Tensor, M_inv, iters: int, tol: float) -> torch.Tensor:
    """Jacobi-preconditioned CG with a FIXED trip count and masked early
    exit (cg_chunks, fixed=True): no value is read back to the host.
    Mathematically the same preconditioned CG as `cg` below and as Eigen's
    ConjugateGradient."""
    return cg_chunks(_one(matvec), [b], _one(M_inv), iters, tol, fixed=True)[0]


def cg(matvec, b: torch.Tensor, M_inv, maxiter: int, tol: float,
       atol: float = 0.0, steps_out: Optional[List] = None) -> torch.Tensor:
    """Preconditioned CG from x0 = 0 with scipy.sparse.linalg.cg's stop
    rule, polled every CG_POLL_EVERY steps (cg_chunks on one chunk)."""
    return cg_chunks(_one(matvec), [b], _one(M_inv), maxiter, tol, atol,
                     steps_out)[0]


def _solve_cg(matvec, b, d_safe, cg_iters, cg_tol, cg_static, steps_out):
    M_inv = lambda v: v / d_safe     # Jacobi — Eigen's ConjugateGradient default
    if cg_static:
        return pcg_fixed(matvec, b, M_inv, cg_iters, cg_tol)
    return cg(matvec, b, M_inv, cg_iters, cg_tol, steps_out=steps_out)


# ---------------------------------------------------------------- stencil ops

def _over_residual_dims(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def _sum_tail(a: torch.Tensor) -> torch.Tensor:
    return a if a.ndim == 1 else a.flatten(1).sum(dim=1)


def _place(v: torch.Tensor, rows) -> torch.Tensor:
    """v itself, or with rows=(lo, N) v as rows lo.. of a length-N zero
    vector."""
    if rows is None:
        return v
    lo, n = rows
    out = v.new_zeros((n,) + tuple(v.shape[1:]))
    out[lo:lo + v.shape[0]] = v
    return out


def _scatter_add_nbr(out: torch.Tensor, idx_col: torch.Tensor,
                     contrib: torch.Tensor) -> torch.Tensor:
    """out[idx] += contrib where idx >= 0 (frozen neighbours have no column)."""
    ok = idx_col >= 0
    contrib = torch.where(_over_residual_dims(ok, contrib), contrib, 0.0)
    return out.index_add(0, torch.clamp(idx_col, min=0), contrib)


def stencil_apply(x: torch.Tensor, J0: torch.Tensor, Ji: torch.Tensor,
                  nbr_idx: torch.Tensor, src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward J.x for a 4-point stencil operator.

    x [N] variables; J0 [N,...] self coefficients; Ji [N,3,...] neighbor
    coefficients; nbr_idx [N,3] compact neighbor indices (-1 = frozen, no
    column).  Returns [N,...]."""
    src = x if src is None else src
    x_nbr = torch.where(nbr_idx >= 0, src[torch.clamp(nbr_idx, min=0)], 0.0)  # [N,3]
    out = J0 * _over_residual_dims(x, J0)
    for ax in range(3):
        out = out + Ji[:, ax] * _over_residual_dims(x_nbr[:, ax], J0)
    return out


def stencil_apply_T(y: torch.Tensor, J0: torch.Tensor, Ji: torch.Tensor,
                    nbr_idx: torch.Tensor, rows=None) -> torch.Tensor:
    """Transpose J^T.y: reduce over residual dims, scatter-add at neighbors."""
    out = _place(_sum_tail(J0 * y), rows)
    for ax in range(3):
        out = _scatter_add_nbr(out, nbr_idx[:, ax], _sum_tail(Ji[:, ax] * y))
    return out


def stencil_diag(w: torch.Tensor, J0: torch.Tensor, Ji: torch.Tensor,
                 nbr_idx: torch.Tensor, rows=None) -> torch.Tensor:
    """diag(J^T W J) for the stencil operator (needed for damping)."""
    diag = _place(_sum_tail(w * J0 * J0), rows)
    for ax in range(3):
        diag = _scatter_add_nbr(
            diag, nbr_idx[:, ax], _sum_tail(w * Ji[:, ax] * Ji[:, ax]))
    return diag


# -------------------------------------------------------------- regularizers

class RegOperator(NamedTuple):
    """Linearized regularizer: residual r plus stencil Jacobian (J0, Ji)."""
    r: torch.Tensor      # [N]
    J0: torch.Tensor     # [N]
    Ji: torch.Tensor     # [N,3]
    nbr_idx: torch.Tensor


def eikonal_operator(prob: RefineProblem, dist: torch.Tensor, voxel_size: float) -> RegOperator:
    """(||grad d|| - 1) residual + Jacobian (Optimizer.cpp:196-218,477-537):
    the plain version of ops/distreg.py's kernel, every sum in a fixed
    order."""
    grad = geometry.fd_grad(prob, dist, voxel_size)           # [N,3]
    gnorm = geometry.norm3(grad)
    r = torch.where(prob.valid, gnorm - 1.0, 0.0)
    inv_h = 1.0 / voxel_size
    n_d0 = -inv_h * prob.nbr_dir                              # [N,3]
    J0 = geometry.dot3(grad, n_d0)
    Ji = grad * prob.nbr_dir * inv_h                          # [N,3]
    scale = torch.where(gnorm > 0.0, 1.0 / torch.clamp(gnorm, min=1e-12), 1.0)
    J0 = torch.where(prob.valid, J0 * scale, 0.0)
    Ji = torch.where(prob.valid[:, None], Ji * scale[:, None], 0.0)
    return RegOperator(r=r, J0=J0, Ji=Ji, nbr_idx=prob.nbr_idx)


class LapOperator(NamedTuple):
    r: torch.Tensor      # [N]
    lap_idx: torch.Tensor
    diag_coef: float
    nbr_coef: float


def laplacian_operator(prob: RefineProblem, dist: torch.Tensor, voxel_size: float,
                       diag_only: bool = False) -> LapOperator:
    """Laplacian residual + Jacobian (Optimizer.cpp:540-590).

    diag_only=True reproduces the reference verbatim: its neighbor triplets
    are constructed but never pushed (Optimizer.cpp:569,578), leaving only
    the -6/h^2 diagonal.  Default False uses the correct stencil."""
    inv_h2 = 1.0 / (voxel_size * voxel_size)
    lap = geometry.fd_laplacian(prob, dist, voxel_size)
    r = torch.where(prob.valid, lap, 0.0)
    return LapOperator(
        r=r,
        lap_idx=prob.lap_idx,
        diag_coef=-6.0 * inv_h2,
        nbr_coef=0.0 if diag_only else inv_h2,
    )


def lap_apply(x: torch.Tensor, op: LapOperator, valid: torch.Tensor,
              src: Optional[torch.Tensor] = None) -> torch.Tensor:
    src = x if src is None else src
    out = op.diag_coef * x
    if op.nbr_coef != 0.0:
        x_nbr = torch.where(
            op.lap_idx >= 0, src[torch.clamp(op.lap_idx, min=0)], 0.0)   # [N,6]
        out = out + op.nbr_coef * torch.sum(x_nbr, dim=-1)
    return torch.where(valid, out, 0.0)


def lap_apply_T(y: torch.Tensor, op: LapOperator, valid: torch.Tensor,
                rows=None) -> torch.Tensor:
    y = torch.where(valid, y, 0.0)
    out = _place(op.diag_coef * y, rows)
    if op.nbr_coef != 0.0:
        for k in range(6):
            out = _scatter_add_nbr(out, op.lap_idx[:, k], op.nbr_coef * y)
    return out


def lap_diag(op: LapOperator, valid: torch.Tensor, rows=None) -> torch.Tensor:
    diag = _place(torch.where(valid, op.diag_coef ** 2, 0.0).to(op.r.dtype), rows)
    if op.nbr_coef != 0.0:
        contrib = torch.where(valid, op.nbr_coef ** 2, 0.0).to(op.r.dtype)
        for k in range(6):
            diag = _scatter_add_nbr(diag, op.lap_idx[:, k], contrib)
    return diag


# ------------------------------------------------------------ distance solve

def reg_operators(prob: RefineProblem, dist: torch.Tensor, voxel_size: float,
                  *, reg_weight_n: float, reg_weight_l: float,
                  laplacian_diag_only: bool):
    """(eik, lap) regularizer operators of the distance block, None where
    the weight is 0: both in one call of ops/distreg.reg_operators (one
    kernel launch on the card)."""
    if reg_weight_n == 0.0 and reg_weight_l == 0.0:
        return None, None
    return distreg.reg_operators(prob, dist, voxel_size, eikonal=reg_weight_n != 0.0,
                                 laplacian=reg_weight_l != 0.0,
                                 diag_only=laplacian_diag_only)


def distance_rhs(prob: RefineProblem, rd: ResidualData, DJ: DistJacobian,
                 eik: Optional[RegOperator], lap: Optional[LapOperator], *,
                 reg_weight_n: float, reg_weight_l: float, rows=None):
    """(b, diag) of the distance block: b = J^T W r plus the regularizer
    terms, diag = diag(J^T W J) plus theirs."""
    w = rd.w                                           # [N,F,3]
    b = stencil_apply_T(w * rd.r, DJ.J0, DJ.Ji, prob.nbr_idx, rows)
    diag = stencil_diag(w, DJ.J0, DJ.Ji, prob.nbr_idx, rows)
    if eik is not None:
        b = b + reg_weight_n * stencil_apply_T(eik.r, eik.J0, eik.Ji, eik.nbr_idx, rows)
        diag = diag + reg_weight_n * stencil_diag(
            torch.ones_like(eik.J0), eik.J0, eik.Ji, eik.nbr_idx, rows
        )
    if lap is not None:
        b = b + reg_weight_l * lap_apply_T(lap.r, lap, prob.valid, rows)
        diag = diag + reg_weight_l * lap_diag(lap, prob.valid, rows)
    return b, diag


def distance_hx(x: torch.Tensor, prob: RefineProblem, w: torch.Tensor,
                DJ: DistJacobian, eik: Optional[RegOperator],
                lap: Optional[LapOperator], *, reg_weight_n: float,
                reg_weight_l: float, src=None, rows=None) -> torch.Tensor:
    """(J^T W J + regularizers) x, the damping term left out."""
    out = stencil_apply_T(
        w * stencil_apply(x, DJ.J0, DJ.Ji, prob.nbr_idx, src),
        DJ.J0, DJ.Ji, prob.nbr_idx, rows,
    )
    if eik is not None:
        out = out + reg_weight_n * stencil_apply_T(
            stencil_apply(x, eik.J0, eik.Ji, eik.nbr_idx, src),
            eik.J0, eik.Ji, eik.nbr_idx, rows,
        )
    if lap is not None:
        out = out + reg_weight_l * lap_apply_T(
            lap_apply(x, lap, prob.valid, src), lap, prob.valid, rows
        )
    return out


def _distance_system(
    prob: RefineProblem,
    rd: ResidualData,
    DJ: DistJacobian,
    dist: torch.Tensor,
    voxel_size: float,
    *,
    reg_weight_n: float,
    reg_weight_l: float,
    damping: float,
    laplacian_diag_only: bool,
):
    """Assemble the distance-block normal equations as (b, diag, H_dd·x).

    b = J^T W r (+ regularizer terms); H_dd·x includes the photometric
    stencil operator, the Eikonal/Laplacian regularizers, and the
    reference's multiplicative damping.  Shared by the alternating
    distance solve and the joint Schur solve."""
    rw = dict(reg_weight_n=reg_weight_n, reg_weight_l=reg_weight_l)
    eik, lap = reg_operators(prob, dist, voxel_size, **rw,
                             laplacian_diag_only=laplacian_diag_only)
    b, diag = distance_rhs(prob, rd, DJ, eik, lap, **rw)

    def hdd_mv(x):
        return distance_hx(x, prob, rd.w, DJ, eik, lap, **rw) + damping * diag * x

    return b, diag, hdd_mv


def solve_distance(
    prob: RefineProblem,
    rd: ResidualData,
    DJ: DistJacobian,
    dist: torch.Tensor,
    voxel_size: float,
    *,
    reg_weight_n: float,
    reg_weight_l: float,
    damping: float,
    laplacian_diag_only: bool = False,
    cg_iters: int = 100,
    cg_tol: float = 1e-6,
    cg_static: bool = False,
    steps_out: Optional[List] = None,
    stencil: distcg.StencilReverse,
) -> torch.Tensor:
    """CG on (J^T W J + reg + damping diag) dd = J^T W r + reg terms
    (PsOptimizer.cpp:124-172). Returns the GN step delta_d [N].

    The system is assembled per row (distcg.dist_system) and solved by
    distcg.dist_cg with the stop rule of `cg` (cg_static: `pcg_fixed`'s);
    `stencil` is the problem's distcg.stencil_reverse table, which the
    refiner builds with the problem.  `steps_out` receives the steps taken,
    under either rule."""
    if stencil is None or stencil.source is not prob.nbr_idx:
        raise ValueError("solve_distance: the stencil table is missing or "
                         "was built for another problem")
    eik, lap = reg_operators(prob, dist, voxel_size, reg_weight_n=reg_weight_n,
                             reg_weight_l=reg_weight_l,
                             laplacian_diag_only=laplacian_diag_only)
    A, t = distcg.dist_system(rd, DJ, eik, reg_weight_n=reg_weight_n)
    return distcg.dist_cg(A, t, prob.valid, stencil, lap,
                          reg_weight_l=reg_weight_l, damping=damping,
                          cg_iters=cg_iters, cg_tol=cg_tol,
                          cg_static=cg_static, steps_out=steps_out)


def distance_step(
    prob: RefineProblem,
    rd: ResidualData,
    DJ: DistJacobian,
    dist: torch.Tensor,
    voxel_size: float,
    *,
    reg_weight_n: float,
    reg_weight_l: float,
    damping: float,
    laplacian_diag_only: bool = False,
    cg_iters: int = 100,
    cg_tol: float = 1e-6,
    cg_static: bool = False,
    steps_out: Optional[List] = None,
    stencil: distcg.StencilReverse,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distance block's step and update in one: solve_distance, then
    update_distance -> (new_dist, new_grad_stored).  Two launches on the
    card: distcg.dist_system_reg (the regularizer operators a stage of the
    assembly) and distcg.dist_cg_update (the update a stage of the CG); on
    the CPU the same plain chain as solve_distance + update_distance, bit for
    bit.  `stencil` as solve_distance's; `steps_out` receives the steps."""
    A, t, lap = distcg.dist_system_reg(rd, DJ, prob, dist, stencil, voxel_size,
                                       reg_weight_n=reg_weight_n, reg_weight_l=reg_weight_l,
                                       diag_only=laplacian_diag_only)
    _, new_dist, new_grad = distcg.dist_cg_update(
        A, t, prob, dist, stencil, lap, voxel_size, reg_weight_l=reg_weight_l,
        damping=damping, cg_iters=cg_iters, cg_tol=cg_tol, cg_static=cg_static,
        steps_out=steps_out)
    return new_dist, new_grad


def accept_distance(prob: RefineProblem, dist: torch.Tensor,
                    delta: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """d - delta where |delta| < sqrt(3) h on a valid row, else d."""
    ok = (delta.abs() < math.sqrt(3.0) * voxel_size) & prob.valid
    return torch.where(ok, dist - delta, dist)


def update_distance(
    prob: RefineProblem, dist: torch.Tensor, delta: Optional[torch.Tensor],
    voxel_size: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """d -= delta where |delta| < sqrt(3) h (OptimizerAux.cpp:162-188), then
    refresh the stored gradient (updateGrad: grad := FD grad); delta=None
    leaves d as it is.  Returns (new_dist, new_grad_stored): one call of
    ops/distreg.dist_update (one kernel launch on the card; its plain
    version accept_distance, then geometry.fd_grad)."""
    return distreg.dist_update(prob, dist, delta, voxel_size)


# --------------------------------------------- joint distance+pose (Schur)

def _weighted_gram(w: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """sum_{n,c} w[n,f,c] J[n,f,c,:]^T J[n,f,c,:] -> [F,D,D], as (w J)^T J
    batched over frames (a three-operand einsum would contract pairwise and
    materialise an [N,F,3,D,D] tensor)."""
    return torch.einsum("nfcb,nfcd->fbd", w[..., None] * J, J)


def joint_pose_terms(prob: RefineProblem, rd: ResidualData, J_c: torch.Tensor):
    """(wm [N,F,3], H_pp [F,6,6], g_p [F,6]) of the joint step: the weights
    with padded rows zeroed, the pose blocks' Gram matrices and gradients."""
    wm = torch.where(prob.valid[:, None, None], rd.w, 0.0)
    return wm, _weighted_gram(wm, J_c), torch.einsum("nfcb,nfc->fb", J_c, wm * rd.r)


def pose_factor(H_pp: torch.Tensor, damping: float) -> torch.Tensor:
    """Cholesky factor of the damped pose blocks [F,6,6] (a block that is
    not positive definite raises)."""
    dpp = torch.diagonal(H_pp, dim1=-2, dim2=-1)
    H_pp = H_pp + torch.diag_embed(damping * dpp)
    H_pp = H_pp + 1e-8 * torch.eye(6, dtype=H_pp.dtype, device=H_pp.device)
    return torch.linalg.cholesky(H_pp)


def hpd_apply(x: torch.Tensor, prob: RefineProblem, DJ: DistJacobian,
              J_c: torch.Tensor, wm: torch.Tensor, src=None) -> torch.Tensor:
    """H_pd x: [N] -> [F,6]."""
    Jdx = stencil_apply(x, DJ.J0, DJ.Ji, prob.nbr_idx, src)   # [N,F,3]
    return torch.einsum("nfc,nfcb->fb", wm * Jdx, J_c)


def hdp_apply(y: torch.Tensor, prob: RefineProblem, DJ: DistJacobian,
              J_c: torch.Tensor, wm: torch.Tensor, rows=None) -> torch.Tensor:
    """H_dp y: [F,6] -> [N]."""
    Jcy = torch.einsum("nfcb,fb->nfc", J_c, y)
    return stencil_apply_T(wm * Jcy, DJ.J0, DJ.Ji, prob.nbr_idx, rows)


def solve_joint_dist_pose(
    prob: RefineProblem,
    rd: ResidualData,
    DJ: DistJacobian,
    J_c: torch.Tensor,        # [N,F,3,6] pose Jacobian
    dist: torch.Tensor,
    voxel_size: float,
    *,
    reg_weight_n: float,
    reg_weight_l: float,
    damping: float,
    laplacian_diag_only: bool = False,
    cg_iters: int = 100,
    cg_tol: float = 1e-6,
    cg_static: bool = False,
    steps_out: Optional[List] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE Gauss-Newton step over (distance, poses) jointly, with
    Schur-complement elimination of the block-diagonal pose blocks.

    The joint normal equations are

        [ H_dd  H_dp ] [dd]   [g_d]
        [ H_pd  H_pp ] [xi] = [g_p]

    where H_pp is block-diagonal 6x6 per keyframe (each residual touches
    exactly one pose).  Eliminating the pose blocks gives the reduced SPD
    system (H_dd - H_dp H_pp^-1 H_pd) dd = g_d - H_dp H_pp^-1 g_p, solved
    matrix-free by CG; poses back-substitute as
    xi = H_pp^-1 (g_p - H_pd dd).

    This is an extension beyond the reference's alternating block scheme
    (PsOptimizer.cpp:239-428) — one step captures the pose/geometry
    cross-coupling the alternation ignores.

    Returns (delta_d [N], delta_xi [F,6]); both blocks use the reference's
    subtract-delta update convention.  The solve holds the full [N,F,3,6]
    pose Jacobian across the CG loop.  A pose block that is not positive
    definite raises (torch.linalg.cholesky)."""
    # pose blocks (small): H_pp [F,6,6], g_p [F,6]
    wm, H_pp, g_p = joint_pose_terms(prob, rd, J_c)

    # factor the constant SPD pose blocks ONCE (hpp_solve runs inside every
    # CG matvec)
    chol_pp = pose_factor(H_pp, damping)

    def hpp_solve(y):                                    # [F,6] -> [F,6]
        return torch.cholesky_solve(y[..., None], chol_pp)[..., 0]

    def hpd_mv(x):                                       # [N] -> [F,6]
        return hpd_apply(x, prob, DJ, J_c, wm)

    def hdp_mv(y):                                       # [F,6] -> [N]
        return hdp_apply(y, prob, DJ, J_c, wm)

    b_d, diag, hdd_mv = _distance_system(
        prob, rd, DJ, dist, voxel_size,
        reg_weight_n=reg_weight_n, reg_weight_l=reg_weight_l, damping=damping,
        laplacian_diag_only=laplacian_diag_only,
    )
    b_red = b_d - hdp_mv(hpp_solve(g_p))
    b_red = torch.where(prob.valid, b_red, 0.0)

    def matvec(x):
        out = hdd_mv(x) - hdp_mv(hpp_solve(hpd_mv(x)))
        return torch.where(prob.valid, out, x)

    # Jacobi preconditioner from the (dominant) H_dd diagonal
    d_safe = jacobi_diag(prob.valid, diag, damping)
    delta_d = _solve_cg(matvec, b_red, d_safe, cg_iters, cg_tol, cg_static,
                        steps_out)
    delta_d = torch.where(prob.valid, delta_d, 0.0)
    delta_xi = hpp_solve(g_p - hpd_mv(delta_d))
    return delta_d, delta_xi


# -------------------------------------------------------------- albedo solve

def albedo_data_terms(rd: ResidualData, J_rho: torch.Tensor):
    """(b [N,3], diag [N,3]) of the albedo block's photometric term: sums
    over the frames.  J_rho [N,F] (SH, channel-shared) or [N,F,3] (LED)."""
    J = J_rho[..., None] if J_rho.ndim == 2 else J_rho    # broadcasts over channels
    w = rd.w
    return torch.sum(J * (w * rd.r), dim=1), torch.sum((J * J) * w, dim=1)


# The albedo regularizer in scatter form (index_add_ transposes).  Only the
# mesh's albedo block (parallel/refine.py `_albedo`) runs it; one device
# runs the gather form of ops/albedo.py (reg_rows, reg_apply, reg_apply_T),
# which tests/test_torch_albedo.py::test_system_matches_the_eager_chain
# holds to these operators.
class AlbedoReg(NamedTuple):
    """Linearized albedo smoothness: per-channel residual [N,3] and its
    stencil Jacobian (J0 [N,3], Ji [N,3ax,3ch])."""
    r: torch.Tensor
    J0: torch.Tensor
    Ji: torch.Tensor
    nbr_idx: torch.Tensor
    safe: torch.Tensor       # nbr_idx clamped to >= 0


def albedo_reg_operator(prob: RefineProblem, albedo: torch.Tensor,
                        voxel_size: float) -> AlbedoReg:
    valid_c = prob.valid[:, None]
    nbr_idx = prob.nbr_idx
    ag = geometry.fd_albedo_grad(prob, albedo, voxel_size)   # [N,3ax,3ch]
    norms = torch.linalg.vector_norm(ag, dim=1)              # [N,3ch]
    r_reg = torch.where(valid_c, norms, 0.0)
    inv_h = 1.0 / voxel_size
    scale = torch.where(norms != 0.0, 1.0 / torch.clamp(norms, min=1e-12), 1.0)
    # J0[c] = (sum_ax ag[ax,c] * -dir_ax/h) / norm_c ; Ji[ax,c] = ag[ax,c]*dir_ax/h / norm_c
    J0r = torch.einsum("nac,na->nc", ag, -inv_h * prob.nbr_dir) * scale
    Jir = ag * (prob.nbr_dir * inv_h)[..., None] * scale[:, None, :]
    J0r = torch.where(valid_c, J0r, 0.0)
    Jir = torch.where(prob.valid[:, None, None], Jir, 0.0)
    return AlbedoReg(r=r_reg, J0=J0r, Ji=Jir, nbr_idx=nbr_idx,
                     safe=torch.clamp(nbr_idx, min=0))


def albedo_reg_apply(x: torch.Tensor, op: AlbedoReg, src=None) -> torch.Tensor:
    """x [N,3] -> J x [N,3]."""
    src = x if src is None else src
    x_nbr = torch.where((op.nbr_idx >= 0)[..., None], src[op.safe], 0.0)  # [N,3ax,3ch]
    return op.J0 * x + torch.sum(op.Ji * x_nbr, dim=1)


def albedo_reg_apply_T(y: torch.Tensor, op: AlbedoReg, rows=None) -> torch.Tensor:
    """y [N,3] -> J^T y [N,3]."""
    out = _place(op.J0 * y, rows)
    for ax in range(3):
        out = _scatter_add_nbr(out, op.nbr_idx[:, ax], op.Ji[:, ax] * y)
    return out


def albedo_reg_diag(op: AlbedoReg, rows=None) -> torch.Tensor:
    dreg = _place(op.J0 * op.J0, rows)
    for ax in range(3):
        dreg = _scatter_add_nbr(dreg, op.nbr_idx[:, ax], op.Ji[:, ax] ** 2)
    return dreg


def solve_albedo(
    prob: RefineProblem,
    rd: ResidualData,
    albedo: torch.Tensor,
    grad_stored: torch.Tensor,
    lights: torch.Tensor,    # [F,B] (SH) or [3] (LED)
    poses: torch.Tensor,     # [F,4,4]
    voxel_size: float,
    *,
    model: str,
    order: int,
    reg_weight_rho: float,
    damping: float,
    cg_iters: int = 100,
    cg_tol: float = 1e-6,
    cg_static: bool = False,
    steps_out: Optional[List] = None,
    stencil: Optional[distcg.StencilReverse] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Albedo GN step (PsOptimizer.cpp:85-121) and its update: -> (delta
    [N,3], the new albedo [N,3] of update_albedo).

    ONE call of ops/albedo.albedo_block, one kernel launch on the card: the
    system formed per pair and row (J_rho of albedo_jacobian_sh / _led,
    albedo_data_terms, and under reg_weight_rho the regularizer of
    albedo_reg_operator with its transposes), then its CG with the stop
    rule of `cg` (cg_static: `pcg_fixed`'s) and the accept rule.  `stencil`
    is the problem's distcg.stencil_reverse table, read under the
    regularizer only (a missing table or another problem's then raises).
    `steps_out` receives the steps taken, under either rule."""
    if reg_weight_rho != 0.0 and (stencil is None or stencil.source is not prob.nbr_idx):
        raise ValueError("solve_albedo: the stencil table is missing or was "
                         "built for another problem")
    return albedo_ops.albedo_block(prob, rd, albedo, grad_stored, lights, poses, stencil,
                                   model=model, order=order, voxel_size=voxel_size,
                                   reg_weight_rho=reg_weight_rho, damping=damping,
                                   cg_iters=cg_iters, cg_tol=cg_tol, cg_static=cg_static,
                                   steps_out=steps_out)


def update_albedo(prob: RefineProblem, albedo: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """rho -= delta per channel, accepted only if the result lies strictly in
    (0,1) (OptimizerAux.cpp:120-150): ops/albedo.accept, the rule albedo_block
    applies to its own delta."""
    return albedo_ops.accept(prob.valid, albedo, delta)


# --------------------------------------------------------------- light solve

def solve_light_sh(rd: ResidualData, J_l: torch.Tensor) -> torch.Tensor:
    """Per-frame BxB normal equations (lightJacobian + CG,
    PsOptimizer.cpp:175-203; block-diagonal -> exact per-frame solves).
    J_l [N,3,B] frame-independent; returns delta_l [F,B]. No damping
    (faithful to the reference).

    Rank-safe: on near-constant-normal frames the order-2 basis Gram is
    rank-deficient (the quadratic columns are collinear) and a jittered
    dense solve explodes along the null space.  The reference's Eigen CG
    never injects null-space components — from x0=0 it converges to the
    MIN-NORM solution — so the dense equivalent is a clipped eigen-solve:
    directions with eigenvalue <= 1e-6 * lambda_max contribute zero."""
    return solve_light_from_normal_eqs(*light_normal_eqs_sh(rd, J_l))


def light_normal_eqs_sh(rd: ResidualData, J_l: torch.Tensor):
    """(H [F,B,B], g [F,B]) of the SH light block: the weighted Gram product
    (wJ)^T J and the gradient, per frame."""
    w = rd.w                                              # [N,F,3]
    N, F = w.shape[0], w.shape[1]
    B = J_l.shape[-1]
    # H[f] = sum_{n,c} w[n,f,c] J[n,c,:] J[n,c,:]^T as ONE [F, 3N] x [3N, B*B]
    # product (the outer products do not depend on the frame)
    wf = w.permute(1, 0, 2).reshape(F, N * 3)
    JJ = (J_l[..., :, None] * J_l[..., None, :]).reshape(N * 3, B * B)
    H = (wf @ JJ).reshape(F, B, B)
    g = (w * rd.r).permute(1, 0, 2).reshape(F, N * 3) @ J_l.reshape(N * 3, B)
    return H, g


def solve_light_from_normal_eqs(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta_l [F,B] = V inv V^T g from the eigen-decomposition of H in
    float64, directions of eigenvalue <= 1e-6 * lambda_max dropped
    (solve_light_sh): ops/smallsolve.light_solve, one launch on the card
    that waits for nothing."""
    return smallsolve.light_solve(H, g)


def solve_light_led(rd: ResidualData, J_l: torch.Tensor, damping: float) -> torch.Tensor:
    """Global RGB LED intensity: 3 independent scalars
    (LedOptimizer.cpp:134-160, with damping). J_l [N,F,3]."""
    return solve_light_led_from_normal_eqs(*light_normal_eqs_led(rd, J_l), damping)


def light_normal_eqs_led(rd: ResidualData, J_l: torch.Tensor):
    """(H [3], g [3]) of the LED light block: sums over voxels and frames."""
    wJ = rd.w * J_l
    return torch.sum(wJ * J_l, dim=(0, 1)), torch.sum(wJ * rd.r, dim=(0, 1))


def solve_light_led_from_normal_eqs(H: torch.Tensor, g: torch.Tensor,
                                    damping: float) -> torch.Tensor:
    H = H * (1.0 + damping)
    return g / torch.clamp(H, min=1e-12)


# ---------------------------------------------------------------- pose solve

def pose_normal_eqs(rd: ResidualData, J_c: torch.Tensor):
    """(H [F,6,6], g [F,6]) of the pose block from its Jacobian [N,F,3,6]."""
    H = _weighted_gram(rd.w, J_c)
    g = torch.einsum("nfcb,nfc->fb", J_c, rd.w * rd.r)
    return H, g


def solve_pose_from_normal_eqs(H: torch.Tensor, g: torch.Tensor, damping: float,
                               info_out: Optional[List] = None) -> torch.Tensor:
    """Per-frame 6x6 solves given assembled normal equations H [F,6,6],
    g [F,6] (poseJacobian + CG, PsOptimizer.cpp:207-234; block-diagonal ->
    exact). Returns delta_xi [F,6].  A singular block raises
    torch.linalg.LinAlgError: here, or, with `info_out`, where the caller
    reads the factorisation's status [F] int32, which `info_out` receives
    (torch.linalg.solve_ex: nothing waits for the host here)."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    # multiplicative damping on the diagonal (PsOptimizer.cpp:103-105)
    H = H + torch.diag_embed(damping * diag)
    jitter = 1e-8 * torch.eye(6, dtype=H.dtype, device=H.device)
    x, info = torch.linalg.solve_ex(H + jitter, g[..., None])
    if info_out is None:
        check_pose_info(info.tolist())
    else:
        info_out.append(info)
    return x[..., 0]


def check_pose_info(info: Sequence[int]) -> None:
    """Raise as torch.linalg.solve does for the first singular block of a
    pose solve's status (solve_pose_from_normal_eqs)."""
    for f, v in enumerate(info):
        if v:
            raise torch.linalg.LinAlgError(
                f"torch.linalg.solve: (Batch element {f}): The solver failed because "
                "the input matrix is singular.")


def update_poses(poses: torch.Tensor, delta_xi: torch.Tensor) -> torch.Tensor:
    """t -= xi_t;  R <- R exp(-xi_w)  (OptimizerAux.cpp:190-205)."""
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    out = poses.clone()
    out[:, :3, :3] = R @ se3.so3_exp(-delta_xi[:, 3:])
    out[:, :3, 3] = t - delta_xi[:, :3]
    return out
