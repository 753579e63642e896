"""The photometric refinement on a device mesh.

Counterpart of the JAX package's refinement under GSPMD (its
parallel/shard.shard_refine_arrays places the arrays and the compiler
inserts the collectives).  Here every cross-device move is written out, and
one process runs the shards of each step in turn (the scan's model,
parallel/shard.py).  The layout (parallel/shard.RefineLayout):

  * the surface set's N rows are split into n_z chunks; chunk k's problem
    and state (dist, albedo, grad_stored) live on mesh row k;
  * the keyframes are split into n_frames chunks; chunk j's images live on
    mesh column j;
  * a residual pass runs one block per device [k, j], over N-chunk k x
    keyframe chunk j.  The [N, F, ...] tensors (residuals, Jacobians) are
    made and used where they are, and never cross devices;
  * poses, lights and K live on the first device and are replicated where
    a block reads them (parallel/shard.replicate).

What crosses devices, all through parallel/mesh.py, added in shard order:

  1. sums over N into per-frame or global quantities (the light and pose
     normal equations, the joint step's pose blocks, the LED light init,
     the four energies): one reduce_to_first onto the first device, where
     the small per-frame solves run;
  2. sums over F into per-voxel quantities (the albedo block's data term,
     the albedo init): one reduce_to_first a mesh row;
  3. finite-difference neighbour reads by global compact index: the
     N-vector is all-gathered and each shard reads from the full copy.  The
     state's reads are made once a residual pass: each block's `view` is
     its problem with every stencil neighbour's current value written in
     as a frozen constant (nbr_idx = lap_idx = -1), so the refine/ value
     functions (fd_grad, fd_laplacian, fd_albedo_grad and all that calls
     them) run on it unchanged and read the same numbers as on one device;
  4. scatter-adds into neighbours: each shard adds into a full-length
     partial (refine/solvers.py's `rows=`), and the partials are
     reduce-scattered back to the chunks;
  5. the CG's dot products: a sum of per-shard dots, so that the stop rule
     reads the reduced value and every shard takes the same steps.

A CG step moves: 3 scalar reductions (the dots); the distance and albedo
(with its smoothness term) matvecs 1 all-gather and 1 reduce-scatter; the
joint distance+pose matvec also one [F,6] reduction.  The functions below
have the signatures of refine/optimizer.py's RefineOps over a ShardedProblem,
ShardedImages, row-chunked N-vectors (tuples, chunk k on row device k) and
MeshResiduals; OPS bundles them for the refiner.

On a mesh over processes (parallel/distributed.py) each process holds its
mesh rows' chunks and blocks, and the others' are their Remote entries, in
place in every tuple; every function visits every block on every process
(local_map, _each) so that the moves are called alike everywhere.  The
sums of kinds 1 and 5 reach every process with the same bits: each runs
the small solves itself, and the CG stops at the same step everywhere.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from psgradientsdf_tpu_torch.config import LED
from psgradientsdf_tpu_torch.ops import energy, normaleq, residual
from psgradientsdf_tpu_torch.parallel import mesh as pm
from psgradientsdf_tpu_torch.parallel.mesh import is_remote, local_map
from psgradientsdf_tpu_torch.parallel.shard import (
    ShardedImages,
    ShardedProblem,
    replicate,
)
from psgradientsdf_tpu_torch.refine import geometry, jacobians, render, solvers
from psgradientsdf_tpu_torch.refine import optimizer as opt
from psgradientsdf_tpu_torch.refine.problem import RefineProblem
from psgradientsdf_tpu_torch.refine.render import ResidualData

Rows = Tuple[torch.Tensor, ...]


class Block(NamedTuple):
    """Block [k, j]: everything its shard-local functions read, on its
    device."""
    prob: RefineProblem              # N-chunk k, frame chunk j's visibility
    view: Optional[RefineProblem]    # prob with the neighbours' values frozen in
    rows: Tuple[int, int]            # (first row, N)
    frames: Tuple[int, int]          # (first frame, F)
    dist: torch.Tensor
    albedo: Optional[torch.Tensor]
    grad: torch.Tensor
    poses: torch.Tensor              # frame chunk j's
    lights: torch.Tensor             # frame chunk j's (SH) or all three (LED)
    images: torch.Tensor
    K: torch.Tensor


class MeshResiduals(NamedTuple):
    """A residual pass on the mesh: rd[k][j] of block [k][j]."""
    rd: Tuple[Tuple[ResidualData, ...], ...]
    blocks: Tuple[Tuple[Block, ...], ...]


# ------------------------------------------------------------------ blocks

def _dist_view(p: RefineProblem, d_full: torch.Tensor) -> RefineProblem:
    """p with the stencil neighbours' distances of `d_full` as constants."""
    return p._replace(
        nbr_idx=torch.full_like(p.nbr_idx, -1),
        nbr_dist_const=geometry.gather_nbr(d_full, p.nbr_idx, p.nbr_dist_const),
        lap_idx=torch.full_like(p.lap_idx, -1),
        lap_dist_const=geometry.gather_nbr(d_full, p.lap_idx, p.lap_dist_const))


def _view(p: RefineProblem, d_full: torch.Tensor, a_full: torch.Tensor) -> RefineProblem:
    """p with the stencil neighbours' distances and albedos as constants."""
    return _dist_view(p, d_full)._replace(nbr_albedo_const=geometry.gather_nbr(
        a_full, p.nbr_idx, p.nbr_albedo_const))


def _blocks(sp: ShardedProblem, images: Optional[ShardedImages], dist: Rows,
            albedo: Optional[Rows], grad: Rows, poses, K, lights=None,
            views: bool = True):
    """Every block's inputs.  views=True all-gathers dist and albedo (move
    kind 3) and makes each block's view."""
    lay = sp.layout
    devs = lay.block_devices
    N, F = lay.rows[-1], lay.frames[-1]
    d_full = pm.all_gather(dist, devs) if views else None
    a_full = pm.all_gather(albedo, devs) if views else None
    rep = {name: replicate(x, devs) for name, x in
           (("poses", poses), ("K", K), ("lights", lights)) if x is not None}
    out = []
    for k, row in enumerate(lay.devices):
        if is_remote(row[0]):                # a row of another process
            out.append(row)
            continue
        lo, hi = lay.rows[k], lay.rows[k + 1]
        grads = replicate(grad[k], row)
        if not views:
            dists = replicate(dist[k], row)
        row_views = {}
        blocks = []
        for j, dev in enumerate(row):
            f0, f1 = lay.frames[j], lay.frames[j + 1]
            p = sp.blocks[k][j]
            view = None
            a = None
            if views:
                if dev not in row_views:
                    row_views[dev] = _view(p, d_full[dev], a_full[dev])
                view = row_views[dev]._replace(vis=p.vis)
                d, a = d_full[dev][lo:hi], a_full[dev][lo:hi]
            else:
                d = dists[dev]
            lt = rep.get("lights", {}).get(dev)
            if lt is not None and lt.ndim == 2:      # SH: a light per keyframe
                lt = lt[f0:f1]
            blocks.append(Block(
                prob=p, view=view, rows=(lo, N), frames=(f0, F), dist=d,
                albedo=a, grad=grads[dev], poses=rep["poses"][dev][f0:f1],
                lights=lt, images=None if images is None else images.blocks[k][j],
                K=rep["K"][dev]))
        out.append(tuple(blocks))
    return tuple(out)


def _flat(blocks):
    return [(k, j, b) for k, row in enumerate(blocks) for j, b in enumerate(row)]


def _each(blocks, fn) -> list:
    """fn(k, j, block) of every block in mesh order; a block of another
    process gives its Remote."""
    return [b if is_remote(b) else fn(k, j, b) for k, j, b in _flat(blocks)]


def _frame_sum(parts: Sequence[Tuple[Block, torch.Tensor]]) -> torch.Tensor:
    """Per-frame partials [F_j, ...] of every block, summed over N into
    [F, ...] on the first device (move kind 1): each block's frames placed
    at their offset, one reduction."""
    return pm.reduce_to_first(local_map(
        lambda p: solvers._place(p[1], p[0].frames), parts))


def _row_sum(lay, blocks, fn) -> List[torch.Tensor]:
    """fn(k, j, block) summed over the blocks of each mesh row (over
    "frames"), on the row device (move kind 2)."""
    return [pm.reduce_to_first([b if is_remote(b) else fn(k, j, b)
                                for j, b in enumerate(row)], dest=lay.devices[k][0])
            for k, row in enumerate(blocks)]


# ------------------------------------------------------------ residual pass

def compute_residuals(sp: ShardedProblem, geom, dist: Rows, albedo: Rows,
                      grad_stored: Rows, poses, images: ShardedImages, K,
                      lights, *, model, order, loss, lam, voxel_size) -> MeshResiduals:
    blocks = _blocks(sp, images, dist, albedo, grad_stored, poses, K, lights)
    rd = tuple(tuple(
        b if is_remote(b) else render.compute_residuals(
            b.view, geom, b.dist, b.albedo, b.grad, b.poses, b.images, b.K,
            b.lights, model=model, order=order, loss=loss, lam=lam,
            voxel_size=voxel_size)
        for b in row) for row in blocks)
    return MeshResiduals(rd, blocks)


def energy_from_rd(sp: ShardedProblem, rd: MeshResiduals, dist, albedo, *,
                   loss, lam, voxel_size) -> torch.Tensor:
    """(E_ps, E_normal, E_laplacian, E_rho) [4] on the first device: every
    block's sums (ops/energy.py, one launch a block on the card), the
    per-voxel ones on the row's first block only, in one reduction, over the
    GLOBAL surface count."""
    def part(k, j, b):
        return energy.energy_sums(
            b.view, rd.rd[k][j], b.dist, b.albedo, loss=loss, lam=lam,
            voxel_size=voxel_size,
            terms=energy.ALL_TERMS if j == 0 else energy.PS)

    return pm.reduce_to_first(_each(rd.blocks, part)) / max(float(sp.n_surface), 1.0)


# ---------------------------------------------------------------------- CG

def _dot(xs: Rows, ys: Rows) -> torch.Tensor:
    """The dot product of two row-chunked vectors, on the first device."""
    return pm.reduce_to_first(local_map(solvers._vdot, xs, ys))


def _solve_cg(matvec, b, d_safe, steps_out, maxiter: int = 100, tol: float = 1e-6):
    """The blocks' CG: refine/solvers.cg_chunks over the row chunks, with
    refine/solvers.solve_*'s defaults (100 steps at most, tol 1e-6, the
    polled stop rule) and every dot product reduced over the shards (move
    kind 5), so that the stop rule reads the reduced value and the shards
    stop together.  cg_chunks works on this process's chunks; the matvec
    and the dots see them in mesh order, with the others' Remote entries."""
    mine = [k for k, c in enumerate(b) if not is_remote(c)]

    def full(xs):
        out = list(b)
        for k, x in zip(mine, xs):
            out[k] = x
        return out

    def local(xs):
        return [xs[k] for k in mine]

    devs = [b[k].device for k in mine]
    d_loc = local(d_safe)

    def spread(s):
        rep = replicate(s, devs)
        return [rep[d] for d in devs]

    x = solvers.cg_chunks(lambda xs: local(matvec(full(xs))), local(b),
                          lambda rs: [r / d for r, d in zip(rs, d_loc)],
                          maxiter, tol, steps_out=steps_out,
                          dot=lambda xs, ys: _dot(full(xs), full(ys)),
                          spread=spread)
    return full(x)


# ------------------------------------------------------------ albedo block

def _albedo(sp, geom, rd: MeshResiduals, dist, albedo, grad, poses, K, lights,
            *, model, order, voxel_size, reg_weight_rho, damping, steps_out,
            **_):
    lay = sp.layout
    rdev = lay.row_devices
    N = lay.rows[-1]

    def data(k, j, b):
        if model == LED:
            J = jacobians.albedo_jacobian_led(b.view, geom, b.dist, b.grad,
                                              b.poses, b.lights)
        else:
            J = jacobians.albedo_jacobian_sh(b.view, b.grad, b.lights, order)
        return torch.stack(solvers.albedo_data_terms(rd.rd[k][j], J))

    terms = _row_sum(lay, rd.blocks, data)           # [2, n_k, 3] a row
    b = local_map(lambda t: t[0], terms)
    diag_ps = local_map(lambda t: t[1], terms)
    diag = list(diag_ps)
    use_reg = reg_weight_rho != 0.0
    if use_reg:
        regs = local_map(
            lambda p, bl: solvers.albedo_reg_operator(bl.view, bl.albedo, voxel_size)
            ._replace(nbr_idx=p.nbr_idx, safe=torch.clamp(p.nbr_idx, min=0)),
            sp.rows, [row[0] for row in rd.blocks])
        rows = [(lay.rows[k], N) for k in range(len(regs))]
        rhs = pm.reduce_scatter(local_map(
            lambda op, rw: torch.stack([solvers.albedo_reg_apply_T(op.r, op, rw),
                                        solvers.albedo_reg_diag(op, rw)])
            .permute(1, 0, 2), regs, rows), lay.rows, rdev)
        b = local_map(lambda bk, t: bk + reg_weight_rho * t[:, 0], b, rhs)
        diag = local_map(lambda dk, t: dk + reg_weight_rho * t[:, 1], diag, rhs)
    valid_c = local_map(lambda p: p.valid[:, None], sp.rows)

    def matvec(xs):
        reg_x = xs
        if use_reg:
            full = pm.all_gather(xs, rdev)
            reg_x = pm.reduce_scatter(local_map(
                lambda x, op, rw: solvers.albedo_reg_apply_T(
                    solvers.albedo_reg_apply(x, op, src=full[x.device]), op, rw),
                xs, regs, rows), lay.rows, rdev)

        def one(x, dp, d, v, rx):
            o = dp * x
            if use_reg:
                o = o + reg_weight_rho * rx
            o = o + damping * d * x
            return torch.where(v, o, x)

        return local_map(one, xs, diag_ps, diag, valid_c, reg_x)

    d_safe = local_map(lambda v, d: solvers.jacobi_diag(v, d, damping), valid_c, diag)
    b = local_map(lambda v, bk: torch.where(v, bk, 0.0), valid_c, b)
    delta = _solve_cg(matvec, b, d_safe, steps_out)
    return tuple(local_map(
        lambda p, a, v, dl: solvers.update_albedo(p, a, torch.where(v, dl, 0.0)),
        sp.rows, albedo, valid_c, delta))


# ------------------------------------------------------------- light block

def _light(sp, geom, rd: MeshResiduals, dist, albedo, grad, poses, K, lights,
           *, model, order, damping, **_):
    def part(k, j, b):
        r = rd.rd[k][j]
        if model == LED:
            return torch.stack(normaleq.light_normal_eqs_led(
                r, b.view, geom, b.dist, b.grad, b.albedo, b.poses))
        J = jacobians.light_jacobian_sh(b.view, b.albedo, b.grad, order)
        H, g = normaleq.light_normal_eqs_sh(r, J)
        return b, torch.cat([H, g[..., None]], dim=-1)               # [F_j,B,B+1]

    parts = _each(rd.blocks, part)
    if model == LED:
        H, g = pm.reduce_to_first(parts)
        return lights - solvers.solve_light_led_from_normal_eqs(H, g, damping)
    Hg = _frame_sum(parts)
    return lights - solvers.solve_light_from_normal_eqs(Hg[..., :-1], Hg[..., -1])


# -------------------------------------------------------------- pose block

def _pose(sp, geom, rd: MeshResiduals, dist, albedo, grad, poses, K, lights,
          *, model, damping, **_):
    def part(k, j, b):
        H, g = normaleq.pose_normal_eqs(rd.rd[k][j], b.K, b.poses, b.albedo,
                                        b.grad, b.lights, model)
        return b, torch.cat([H, g[..., None]], dim=-1)                 # [F_j,6,7]

    Hg = _frame_sum(_each(rd.blocks, part))
    delta = solvers.solve_pose_from_normal_eqs(Hg[..., :-1], Hg[..., -1], damping)
    return solvers.update_poses(poses, delta)


# ---------------------------------------------------------- distance blocks

def _dist_jacobians(geom, rd: MeshResiduals, model, order, voxel_size,
                    with_G=False):
    """Each local block's (G or None, DistJacobian): one kernel launch a
    block on the card."""
    return [[b if is_remote(b) else residual.dist_jacobian(
        b.view, geom, rd.rd[k][j], b.dist, b.albedo, b.grad, b.poses, b.K,
        b.lights, model=model, order=order, voxel_size=voxel_size, with_G=with_G)
        for j, b in enumerate(row)]
        for k, row in enumerate(rd.blocks)]


def _reg_ops(sp, rd: MeshResiduals, voxel_size, rw, laplacian_diag_only):
    """Each row's Eikonal / Laplacian operator: values from the row's view,
    stencil columns from its problem."""
    def one(p, bl):
        eik, lap = solvers.reg_operators(bl.view, bl.dist, voxel_size, **rw,
                                         laplacian_diag_only=laplacian_diag_only)
        return (None if eik is None else eik._replace(nbr_idx=p.nbr_idx),
                None if lap is None else lap._replace(lap_idx=p.lap_idx))

    return local_map(one, sp.rows, [row[0] for row in rd.blocks])


def _distance_system(sp, rd: MeshResiduals, DJ, regs, rw, damping, minus=None):
    """(b, diag, matvec) of the distance system on the mesh.  `minus`, if
    given, is fn(k, j, block, x_full) -> a full-length partial subtracted in
    the matvec (the joint step's Schur term), fn(None, ...) called once a
    matvec before the blocks."""
    lay = sp.layout
    rdev = lay.row_devices

    def reg(k, j):
        return regs[k] if j == 0 else (None, None)

    bd = pm.reduce_scatter(_each(rd.blocks, lambda k, j, b: torch.stack(
        solvers.distance_rhs(b.prob, rd.rd[k][j], DJ[k][j][1], *reg(k, j), **rw,
                             rows=b.rows), -1)), lay.rows, rdev)
    b_d = local_map(lambda t: t[:, 0], bd)
    diag = local_map(lambda t: t[:, 1], bd)

    def matvec(xs):
        full = pm.all_gather(xs, lay.block_devices)
        pre = None if minus is None else minus(None, None, None, full)

        def part(k, j, b):
            lo, hi = b.rows[0], b.rows[0] + b.prob.valid.shape[0]
            src = full[b.dist.device]
            out = solvers.distance_hx(
                src[lo:hi], b.prob, rd.rd[k][j].w, DJ[k][j][1], *reg(k, j),
                **rw, src=src, rows=b.rows)
            return out if minus is None else out - minus(k, j, b, pre)

        hx = pm.reduce_scatter(_each(rd.blocks, part), lay.rows, rdev)
        return local_map(lambda p, h, d, x: torch.where(p.valid, h + damping * d * x, x),
                         sp.rows, hx, diag, xs)

    return b_d, diag, matvec


def _accept(sp, geom, dist, delta, voxel_size):
    """d -= delta where accepted, each row's own rule, then the FD gradient
    of the new distances on each row's view (their neighbours
    all-gathered): one update kernel launch a row on the card."""
    lay = sp.layout
    new = tuple(local_map(lambda p, d, dl: solvers.accept_distance(
        p, d, torch.where(p.valid, dl, 0.0), voxel_size), sp.rows, dist, delta))
    full = pm.all_gather(new, lay.row_devices)
    grad = tuple(local_map(lambda p, d: solvers.update_distance(
        _dist_view(p, full[d.device]), d, None, voxel_size)[1], sp.rows, new))
    return new, grad


def _distance(sp, geom, rd: MeshResiduals, dist, albedo, grad, poses, K, lights,
              *, model, order, voxel_size, reg_weight_n, reg_weight_l, damping,
              laplacian_diag_only, steps_out, **_):
    rw = dict(reg_weight_n=reg_weight_n, reg_weight_l=reg_weight_l)
    DJ = _dist_jacobians(geom, rd, model, order, voxel_size)
    regs = _reg_ops(sp, rd, voxel_size, rw, laplacian_diag_only)
    b, diag, matvec = _distance_system(sp, rd, DJ, regs, rw, damping)
    d_safe = local_map(lambda p, d: solvers.jacobi_diag(p.valid, d, damping),
                       sp.rows, diag)
    b = local_map(lambda p, bk: torch.where(p.valid, bk, 0.0), sp.rows, b)
    delta = _solve_cg(matvec, b, d_safe, steps_out)
    return _accept(sp, geom, dist, delta, voxel_size)


def _joint_dp(sp, geom, rd: MeshResiduals, dist, albedo, grad, poses, K, lights,
              *, model, order, voxel_size, reg_weight_n, reg_weight_l, damping,
              laplacian_diag_only, steps_out, **_):
    """The joint distance+pose step (solvers.solve_joint_dist_pose): the
    pose blocks summed over N onto the first device and factored there;
    each matvec reduces H_pd x over N ([F,6]) and scatters H_dp y back."""
    lay = sp.layout
    rdev = lay.row_devices
    rw = dict(reg_weight_n=reg_weight_n, reg_weight_l=reg_weight_l)
    DJ = _dist_jacobians(geom, rd, model, order, voxel_size, with_G=True)
    Jc, wm = {}, {}

    def pose_part(k, j, b):
        Jc[k, j] = normaleq.pose_jacobian(DJ[k][j][0], rd.rd[k][j], b.poses,
                                          b.albedo, b.grad, b.lights, model)
        wm[k, j], H, g = solvers.joint_pose_terms(b.prob, rd.rd[k][j], Jc[k, j])
        return b, torch.cat([H, g[..., None]], dim=-1)

    Hg = _frame_sum(_each(rd.blocks, pose_part))
    g_p = Hg[..., -1]
    chol = solvers.pose_factor(Hg[..., :-1], damping)

    def hpp_solve(y):                                    # [F,6] on the first device
        return torch.cholesky_solve(y[..., None], chol)[..., 0]

    def hpd(full):                                       # -> [F,6], first device
        return _frame_sum(_each(rd.blocks, lambda k, j, b: (b, solvers.hpd_apply(
            full[b.dist.device][b.rows[0]:b.rows[0] + b.prob.valid.shape[0]],
            b.prob, DJ[k][j][1], Jc[k, j], wm[k, j], src=full[b.dist.device]))))

    def hdp(k, j, b, y):                                 # y: {device: [F,6]}
        return solvers.hdp_apply(y[b.dist.device][b.frames[0]:b.frames[0] + b.poses.shape[0]],
                                 b.prob, DJ[k][j][1], Jc[k, j], wm[k, j], rows=b.rows)

    def schur(k, j, b, arg):
        if k is None:                                    # once a matvec
            return replicate(hpp_solve(hpd(arg)), lay.block_devices)
        return hdp(k, j, b, arg)

    regs = _reg_ops(sp, rd, voxel_size, rw, laplacian_diag_only)
    b_d, diag, matvec = _distance_system(sp, rd, DJ, regs, rw, damping, minus=schur)
    y0 = replicate(hpp_solve(g_p), lay.block_devices)
    hdp0 = pm.reduce_scatter(_each(rd.blocks, lambda k, j, b: hdp(k, j, b, y0)),
                             lay.rows, rdev)
    b_red = local_map(lambda p, bk, h: torch.where(p.valid, bk - h, 0.0),
                      sp.rows, b_d, hdp0)
    d_safe = local_map(lambda p, d: solvers.jacobi_diag(p.valid, d, damping),
                       sp.rows, diag)
    delta_d = _solve_cg(matvec, b_red, d_safe, steps_out)
    delta_d = local_map(lambda p, d: torch.where(p.valid, d, 0.0), sp.rows, delta_d)
    delta_xi = hpp_solve(g_p - hpd(pm.all_gather(delta_d, lay.block_devices)))
    new_dist, new_grad = _accept(sp, geom, dist, delta_d, voxel_size)
    return new_dist, new_grad, solvers.update_poses(poses, delta_xi)


def run_block(name, prob: ShardedProblem, geom, rd: MeshResiduals, dist, albedo,
              grad_stored, poses, K, lights, *, kw, reg_weight_n, reg_weight_l,
              reg_weight_rho, damping, laplacian_diag_only, steps_out=None,
              stencil=None):
    """refine/optimizer._run_block on the mesh -> (dist, albedo,
    grad_stored, poses, lights).  `stencil` is None: the mesh's distance
    CG keeps its scatter-add transposes (refine/solvers.py)."""
    args = (prob, geom, rd, dist, albedo, grad_stored, poses, K, lights)
    bkw = dict(kw, reg_weight_n=reg_weight_n, reg_weight_l=reg_weight_l,
               reg_weight_rho=reg_weight_rho, damping=damping,
               laplacian_diag_only=laplacian_diag_only, steps_out=steps_out)
    if name == "albedo":
        albedo = _albedo(*args, **bkw)
    elif name == "light":
        lights = _light(*args, **bkw)
    elif name == "joint_dp":
        dist, grad_stored, poses = _joint_dp(*args, **bkw)
    elif name == "distance":
        dist, grad_stored = _distance(*args, **bkw)
    elif name == "pose":
        poses = _pose(*args, **bkw)
    else:
        raise ValueError(f"unknown block {name!r}")
    return dist, albedo, grad_stored, poses, lights


# -------------------------------------------------------------------- inits

def init_albedo(sp: ShardedProblem, geom, dist: Rows, grad_stored: Rows, poses,
                images: ShardedImages, K, voxel_size) -> Rows:
    """The mean observed intensity: each block's sums over its keyframes,
    summed over a mesh row."""
    blocks = _blocks(sp, images, dist, None, grad_stored, poses, K, views=False)

    def sums(k, j, b):
        s, cnt = opt.albedo_sums(b.prob, geom, b.dist, b.grad, b.poses, b.images, b.K)
        return torch.cat([s, cnt[:, None]], dim=-1)            # [n_k, 4]

    return tuple(local_map(lambda t: opt.albedo_mean(t[:, :3], t[:, 3]),
                           _row_sum(sp.layout, blocks, sums)))


def led_light_sums(sp: ShardedProblem, geom, rd: MeshResiduals, dist, albedo,
                   grad_stored, poses, lights, voxel_size):
    obs, ren = pm.reduce_to_first(_each(rd.blocks, lambda k, j, b: torch.stack(
        opt.led_light_sums(b.view, geom, rd.rd[k][j], b.dist, b.albedo, b.grad,
                           b.poses, b.lights, voxel_size))))
    return obs, ren


OPS = opt.RefineOps(compute_residuals, energy_from_rd, run_block, init_albedo,
                    led_light_sums)
