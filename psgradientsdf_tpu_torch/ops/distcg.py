"""The distance block's solve: its normal equations assembled per row in
gather form, and the whole Jacobi-preconditioned CG, one launch each of the
hand-written Hopper kernels in csrc/distcg.cu, or their plain PyTorch
versions for CPU tensors.

  stencil_reverse(prob) -> StencilReverse(nbr, rev, lap, source)
  dist_system(rd, DJ, eik, *, reg_weight_n) -> (A [N,10], t [N,4])
  dist_cg(A, t, valid, stencil, lap, *, reg_weight_l, damping, cg_iters,
          cg_tol, cg_static, atol=0.0, steps_out=None) -> delta [N]

and the same two launches with the distance block's tail as their stages
(the one-card refinement's path, refine/solvers.distance_step):

  dist_system_reg(rd, DJ, prob, dist, stencil, voxel_size, *, reg_weight_n,
                  reg_weight_l, diag_only) -> (A, t, lap)
  dist_cg_update(A, t, prob, dist, stencil, lap, voxel_size, *, ...)
      -> (delta, new_dist [N], new_grad [N,3])

Together they replace the JAX package's distance solve as
psgradientsdf_tpu/refine/optimizer.py `_dist_block` (:186) runs it:
refine/solvers.py `solve_distance` (:265) with jax.scipy.sparse.linalg.cg
(:301) or `pcg_fixed` (:39) over `_distance_system` (:207), which XLA keeps
in one device program; that system is built from `stencil_apply` /
`stencil_apply_T` / `stencil_diag` (:84, :100, :113), `eikonal_operator`
(:135), `laplacian_operator` (:157) and `lap_apply` / `lap_apply_T` /
`lap_diag` (:175, :184, :194).

The assembled form.  A photometric residual (n, f, c) touches x[n] and x at
n's three stencil neighbours nbr_idx[n, :], so J^T W J is the sum over rows
of P_n^T A_n P_n: P_n picks (x[n], x[nbr0], x[nbr1], x[nbr2]) (a frozen
neighbour, -1, gives a zero column) and

  A_n = sum_{f,c} w a a^T + reg_weight_n e e^T,   t_n = sum w r a + reg_weight_n r_e e,

with a = (J0, Ji_0, Ji_1, Ji_2)[n, f, c] and e the Eikonal row
(eik.J0[n], eik.Ji[n, :]), which uses the same stencil.  A_n is symmetric:
10 floats a row in the order of A_IDX; t_n holds the row's four partial
gradients.  Then, with s_n = A_n P_n x,

  (H x)[m] = s_m[0]  + s_n[1 + ax] over the rows n that name m along ax,
  b[m]     = t_m[0]  + t_n[1 + ax] over the same rows,
  diag[m]  = A_m[00] + A_n[(1+ax)(1+ax)] over them.

The rows that name m come from the reverse table (stencil_reverse): along an
axis a row is named by at most two rows, the one below it and the one above
it (a row at the grid's low border whose forward neighbour is not in the set
names itself: the stencil's clipped border), column 2 ax + (0 below or
itself, 1 above), -1 where none.  The Laplacian's lap_idx (x+, x-, y+, y-,
z+, z-) is symmetric between compact rows: lap_idx[m, k] = n names m back
through column k ^ 1, or n = m at a clipped border, so its transpose gathers
through lap_idx itself.  stencil_reverse checks both properties and raises
where either fails.  No scatter-add is left: every sum runs in one fixed
order, and a solve gives the same bits on every run.

dist_system sums a row's J = F*3 pairs in a group of G lanes, G =
system_lanes(J) (4, 8, 16 or 32: the fewest that give a lane at most
SYSTEM_PAIRS pairs): lane l adds the pairs j = l, l + G, ... in order, then
the G lane sums are added pairwise (lane l and l ^ G/2, then ^ G/4, ...,
^ 1); every product and sum is rounded once, and the kernel (_rn
intrinsics) equals the plain version bit for bit.  Its launch follows a host
plan (_system_plan, system_plan): a persistent grid over tiles of
consecutive rows, each tile's w, r, J0, Ji and Eikonal rows bulk-copied
into a ring of shared-memory stages.

dist_cg runs `solvers.cg_chunks`' preconditioned CG on the assembled
operator with both of its stop rules (scipy's, and cg_static's fixed trip
count), decided on the device; the kernel sums its dots from per-block
partials in one fixed order, the plain version with torch.sum, so the two
agree to float32 rounding.

dist_cg's launch follows a host plan (_cg_plan, cg_plan): one block an SM,
a contiguous tile of rows a block on 16-row starts, and the tile's layout:
TILE (the tile's rows, tables and vectors in shared memory), VECTORS (the
vectors alone there) or GLOBAL (nothing there), whichever is the first to
fit a block's shared memory.  A step forms H p with no grid barrier
inside: row m takes s_n[1 + ax] of each row n naming it from n's block
when n is on its tile, and forms it anew from A_n and p at n's stencil
when it is not, which hp_gather_plain emulates (equal to operator_apply bit
for bit); so a step crosses two grid barriers, three under the Laplacian's
neighbour term.

The stages.  dist_system_reg forms the Eikonal row and the Laplacian's
residual from the rows' stencils inside dist_system's launch (the arithmetic
of ops/distreg.reg_operators' kernel), in place of reading them from a
launch of their own; dist_cg_update ends dist_cg's launch with one more grid
barrier and ops/distreg.dist_update's accept rule and gradient.  Their plain
versions are the unfused chains: distreg.reg_operators_plain, then
dist_system_plain; dist_cg_plain, then distreg.dist_update_plain; the kernels
equal them bit for bit (the CG's delta to float32 rounding, as dist_cg's).

A wrapper takes the plain version ONLY for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  `launch_counts` counts
kernel launches and nothing else (a launch with a stage counts as its
kernel's).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from psgradientsdf_tpu_torch.ops import distreg
from psgradientsdf_tpu_torch.refine.problem import RefineProblem

_LIB_NAME = "distcg"
launch_counts: Dict[str, int] = {"dist_system": 0, "dist_cg": 0}

LANES = 32
# dist_system: the pairs a lane sums at most (system_lanes' rule; 16 beat
# 2, 4 and 8 at the main refinement's F = 40 on the H100; at the LED run's
# F = 8, 8 and 16 give one plan)
SYSTEM_PAIRS = 16
# the entries of a row's symmetric 4x4 A_n, as stored [N, 10]
A_IDX = ((0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3), (2, 2),
         (2, 3), (3, 3))
_I = [i for i, _ in A_IDX]
_K = [k for _, k in A_IDX]
_DIAG = [A_IDX.index((i, i)) for i in range(4)]
_FULL = [[A_IDX.index((min(i, k), max(i, k))) for k in range(4)] for i in range(4)]
# lap_idx's columns x+, x-, y+, y-, z+, z-: a column's opposite direction
_OPPOSITE = [1, 0, 3, 2, 5, 4]


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class StencilReverse(NamedTuple):
    """The stencils of a problem as the kernels read them."""
    nbr: torch.Tensor      # [N,3] int32: nbr_idx
    rev: torch.Tensor      # [N,6] int32: the row naming m along ax, column 2 ax + side
    lap: torch.Tensor      # [N,6] int32: lap_idx
    source: torch.Tensor   # the problem's nbr_idx the table was built from


def stencil_reverse(prob: RefineProblem) -> StencilReverse:
    """The reverse table of a (whole, one-device) problem's stencil, and
    int32 copies of nbr_idx and lap_idx.  Raises ValueError where a row
    would be named twice in one column, or where lap_idx is not symmetric
    (one read of the device)."""
    nbr, lap = prob.nbr_idx, prob.lap_idx
    N = nbr.shape[0]
    dev = nbr.device
    xyz = prob.idx_xyz.long()
    rows = torch.arange(N, device=dev)
    axes = torch.arange(3, device=dev).expand(N, 3)
    named = nbr >= 0
    tgt = nbr.clamp(min=0)
    above = xyz > xyz[tgt, axes]                   # source above its target
    key = (tgt * 6 + 2 * axes + above.long())[named]
    src = rows[:, None].expand(N, 3)[named]
    twice = torch.bincount(key, minlength=6 * N) > 1
    back = lap[lap.clamp(min=0), torch.tensor(_OPPOSITE, device=dev).expand(N, 6)]
    asym = (lap >= 0) & (lap != rows[:, None]) & (back != rows[:, None])
    bad = torch.stack([twice.any(), asym.any()]).tolist()
    if bad[0]:
        raise ValueError("stencil_reverse: a row is named twice along one side "
                         "of an axis; nbr_idx is not a one-sided FD stencil")
    if bad[1]:
        raise ValueError("stencil_reverse: lap_idx is not symmetric between "
                         "compact rows")
    rev = torch.full((6 * N,), -1, dtype=torch.int32, device=dev)
    rev[key] = src.to(torch.int32)
    return StencilReverse(nbr.to(torch.int32), rev.view(N, 6),
                          lap.to(torch.int32), nbr)


# ---------------------------------------------------------------------------
# the plain PyTorch versions
# ---------------------------------------------------------------------------


def system_lanes(J: int) -> int:
    """The lanes G that sum one row's J pairs in dist_system: the smallest
    power of two from 4 to LANES that gives each lane at most SYSTEM_PAIRS
    pairs (LANES where none does); LANES // G rows share a warp."""
    G = 4
    while G < LANES and G * SYSTEM_PAIRS < J:
        G *= 2
    return G


def _lane_sum(acc: torch.Tensor) -> torch.Tensor:
    """[N, G, k] lane sums -> [N, k], added as the row's xor butterfly."""
    s = acc.shape[1] // 2
    while s >= 1:
        acc = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    return acc[:, 0]


def _by_lane(x: torch.Tensor, N: int, J: int, G: int) -> torch.Tensor:
    """[N, J, ...] -> [N, ceil(J/G), G, ...], zero-padded past J."""
    Q = -(-J // G)
    out = x.new_zeros((N, Q * G) + tuple(x.shape[2:]))
    out[:, :J] = x
    return out.view((N, Q, G) + tuple(x.shape[2:]))


def dist_system_plain(rd, DJ, eik, *, reg_weight_n: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A [N,10], t [N,4]) with eager PyTorch ops, in the kernel's order:
    a row's pairs summed lane by lane over system_lanes(F*3) lanes, the
    lanes pairwise, then the Eikonal row added (eik None: none)."""
    w, r, J0, Ji = rd.w, rd.r, DJ.J0, DJ.Ji
    N = w.shape[0]
    J = w[0].numel()
    G = system_lanes(J)
    a = torch.stack([J0.reshape(N, J), *Ji.reshape(N, 3, J).unbind(1)], dim=-1)
    a, wv, rv = (_by_lane(a, N, J, G), _by_lane(w.reshape(N, J), N, J, G),
                 _by_lane(r.reshape(N, J), N, J, G))
    accA = w.new_zeros((N, G, 10))
    acct = w.new_zeros((N, G, 4))
    for q in range(a.shape[1]):
        aq, wq = a[:, q], wv[:, q]
        wa = wq[..., None] * aq
        accA = accA + wa[..., _I] * aq[..., _K]
        acct = acct + (wq * rv[:, q])[..., None] * aq
    A, t = _lane_sum(accA), _lane_sum(acct)
    if eik is not None:
        lam = torch.full((), reg_weight_n, dtype=torch.float32, device=w.device)
        e = torch.cat([eik.J0[:, None], eik.Ji], dim=-1)            # [N,4]
        we = lam * e
        A = A + we[:, _I] * e[:, _K]
        t = t + (lam * eik.r)[:, None] * e
    return A, t


def _gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[idx] where idx >= 0, else 0."""
    return torch.where(idx >= 0, v[idx.clamp(min=0).long()], 0.0)


def _transpose(u: torch.Tensor, st: StencilReverse) -> torch.Tensor:
    """Per row m: u[m, 0] plus u[n, 1 + ax] over the rows n naming m, in
    the table's column order (u [N,4])."""
    out = u[:, 0]
    for col in range(6):
        out = out + _gather(u[:, 1 + col // 2], st.rev[:, col])
    return out


def _lap_apply(v: torch.Tensor, valid: torch.Tensor, st: StencilReverse, lap) -> torch.Tensor:
    """solvers.lap_apply in gather order; on a vector that is 0 on invalid
    rows it is lap_apply_T too (lap_idx symmetric)."""
    out = lap.diag_coef * v
    if lap.nbr_coef != 0.0:
        nb = _gather(v, st.lap[:, 0])
        for k in range(1, 6):
            nb = nb + _gather(v, st.lap[:, k])
        out = out + lap.nbr_coef * nb
    return torch.where(valid, out, 0.0)


def _lap_diag(valid: torch.Tensor, st: StencilReverse, lap) -> torch.Tensor:
    """solvers.lap_diag in gather order."""
    diag = torch.where(valid, lap.diag_coef ** 2, 0.0).to(torch.float32)
    if lap.nbr_coef != 0.0:
        contrib = torch.where(valid, lap.nbr_coef ** 2, 0.0).to(torch.float32)
        for k in range(6):
            diag = diag + _gather(contrib, st.lap[:, k])
    return diag


def distance_rhs_plain(A, t, valid, st: StencilReverse, lap, *,
                       reg_weight_l: float):
    """(b, diag) of the distance system from the assembled rows, as
    solvers.distance_rhs gives them (b not yet masked)."""
    b = _transpose(t, st)
    diag = _transpose(A[:, _DIAG], st)
    if lap is not None:
        r = torch.where(valid, lap.r, 0.0)
        b = b + reg_weight_l * _lap_apply(r, valid, st, lap)
        diag = diag + reg_weight_l * _lap_diag(valid, st, lap)
    return b, diag


def operator_apply(A, x, valid, st: StencilReverse, lap, *,
                   reg_weight_l: float) -> torch.Tensor:
    """(J^T W J + regularizers) x from the assembled rows, the damping term
    left out (solvers.distance_hx): s_n = A_n P_n x, then the gather-form
    transpose, then the Laplacian's L^T L x."""
    v = [x] + [_gather(x, st.nbr[:, ax]) for ax in range(3)]
    s = []
    for i in range(4):
        si = A[:, _FULL[i][0]] * v[0]
        for k in range(1, 4):
            si = si + A[:, _FULL[i][k]] * v[k]
        s.append(si)
    out = _transpose(torch.stack(s, dim=-1), st)
    if lap is not None:
        out = out + reg_weight_l * _lap_apply(_lap_apply(x, valid, st, lap),
                                              valid, st, lap)
    return out


def hp_gather_plain(A, x, valid, st: StencilReverse, lap, *,
                    reg_weight_l: float) -> torch.Tensor:
    """operator_apply as dist_cg's kernel forms it for a row of another
    tile: row m takes s_m[0] from A_m and x at its stencil, and forms
    s_n[1 + ax] of each row n that names m along ax (column 2 ax + side of
    the reverse table) anew from A_n and x at n's stencil, whose neighbour
    along ax is m itself; the terms are added in the table's column order.
    Every term is formed with the same products and sums in the same order
    as operator_apply's (and as n's own block forms s_n), so the two are
    equal bit for bit: used by the tests only, to pin the kernel's
    arithmetic."""
    v = [x] + [_gather(x, st.nbr[:, ax]) for ax in range(3)]
    out = A[:, _FULL[0][0]] * v[0]
    for k in range(1, 4):
        out = out + A[:, _FULL[0][k]] * v[k]
    for col in range(6):
        ax = col // 2
        n = st.rev[:, col]
        nn = n.clamp(min=0).long()
        An = A[nn]
        w = [x[nn]] + [x if a == ax else _gather(x, st.nbr[nn, a]) for a in range(3)]
        s = An[:, _FULL[1 + ax][0]] * w[0]
        for k in range(1, 4):
            s = s + An[:, _FULL[1 + ax][k]] * w[k]
        out = out + torch.where(n >= 0, s, 0.0)
    if lap is not None:
        out = out + reg_weight_l * _lap_apply(_lap_apply(x, valid, st, lap),
                                              valid, st, lap)
    return out


def jacobi_diag(valid: torch.Tensor, diag: torch.Tensor, damping: float) -> torch.Tensor:
    """The Jacobi preconditioner's safe diagonal (refine/solvers.jacobi_diag)."""
    d_total = (1.0 + damping) * diag
    return torch.where(valid & (d_total > 0.0), d_total, 1.0)


def pcg_plain(matvec, b: torch.Tensor, d_safe: torch.Tensor, *, cg_iters: int,
              cg_tol: float, cg_static: bool, atol: float = 0.0,
              steps_out: Optional[List] = None,
              trace: Optional[List] = None) -> torch.Tensor:
    """The Jacobi-PCG from x0 = 0 with eager PyTorch ops, the plain version
    of dist_cg's and albedo_block's loops: `matvec` the operator, b the masked
    right-hand side, d_safe the preconditioner's safe diagonal; the stop
    test r.r > thr is read back before every step.  cg_static=False: thr =
    max(tol^2 b.b, atol^2), at most cg_iters steps (scipy's rule); True:
    thr = tol^2 b.b and the clamped divisions of solvers.pcg_fixed (the
    iterate stays frozen once the test fails, so stopping there gives its
    result).  `steps_out` receives the steps taken (a 0-dim int64 tensor),
    `trace` each test's (r.r, thr)."""
    bb = torch.sum(b * b)
    thr = ((cg_tol * cg_tol) * bb if cg_static
           else torch.clamp((cg_tol * cg_tol) * bb, min=atol * atol))
    x = torch.zeros_like(b)
    r = b
    z = r / d_safe
    p = z
    gamma = torch.sum(r * z)
    rr = bb
    steps = 0
    for _ in range(cg_iters):
        if trace is not None:
            trace.append((float(rr), float(thr)))
        if not bool(rr > thr):
            break
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = gamma / (torch.clamp(pAp, min=1e-30) if cg_static else pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r / d_safe
        gamma_n = torch.sum(r * z)
        rr = torch.sum(r * r)
        beta = gamma_n / (torch.clamp(gamma, min=1e-30) if cg_static else gamma)
        gamma = gamma_n
        p = z + beta * p
        steps += 1
    if steps_out is not None:
        steps_out.append(torch.tensor(steps, dtype=torch.int64, device=b.device))
    return x


def dist_cg_plain(A, t, valid, stencil: StencilReverse, lap, *,
                  reg_weight_l: float, damping: float, cg_iters: int,
                  cg_tol: float, cg_static: bool, atol: float = 0.0,
                  steps_out: Optional[List] = None,
                  trace: Optional[List] = None) -> torch.Tensor:
    """The distance block's Jacobi-PCG (pcg_plain) on the assembled rows,
    its operator where(valid, H p + damping diag p, p)."""
    st = stencil
    b, diag = distance_rhs_plain(A, t, valid, st, lap, reg_weight_l=reg_weight_l)
    d_safe = jacobi_diag(valid, diag, damping)

    def matvec(p):
        hp = operator_apply(A, p, valid, st, lap, reg_weight_l=reg_weight_l)
        return torch.where(valid, hp + damping * diag * p, p)

    x = pcg_plain(matvec, torch.where(valid, b, 0.0), d_safe, cg_iters=cg_iters,
                  cg_tol=cg_tol, cg_static=cg_static, atol=atol, steps_out=steps_out,
                  trace=trace)
    return torch.where(valid, x, 0.0)


# ---------------------------------------------------------------------------
# argument checks and the library binding
# ---------------------------------------------------------------------------


# dist_system's launch: consumer warps a block (and one producer and one
# regularizer warp), blocks an SM (csrc/distcg.cu kSysBlocks), the stages at
# most, the shared memory of an SM the blocks share; the stages' mbarriers
# (full, empty and reg, 8 bytes each) ahead of the rows' staged outputs
# (csrc/distcg.cu kSys*)
SYSTEM_WARPS = 8
SYSTEM_BLOCKS = 2
SYSTEM_DEPTH = 4
SYSTEM_SM_SMEM = 220 * 1024
_SYSTEM_BARRIERS = 3 * SYSTEM_DEPTH * 8
# bytes a pair (w, r, J0, Ji), a row's Eikonal row (r, J0, Ji) and its
# outputs (A's 10, t's 4)
_PAIR_BYTES = 24
_EIK_BYTES = 20
_OUT_BYTES = 56


class SystemPlan(NamedTuple):
    """dist_system's launch for N rows of J pairs: csrc/distcg.cu
    SystemPlan, field for field."""
    lanes: int             # G, the lanes that sum a row (system_lanes)
    tile: int              # rows a tile: SYSTEM_WARPS x LANES // G (a row group a lane)
    depth: int             # the ring's stages; 0: the lanes read device memory
    blocks: int            # a persistent grid over the tiles
    smem_bytes: int        # a block's dynamic shared memory
    ring: int              # the ring's byte offset in it


def _up128(x: int) -> int:
    return -(-x // 128) * 128


@functools.lru_cache(maxsize=None)
def _system_plan(N: int, J: int, *, sms: int, staged: bool = True) -> SystemPlan:
    """dist_system's launch for N rows of J pairs on a card of `sms` SMs:
    G = system_lanes(J); a tile of SYSTEM_WARPS x LANES // G consecutive
    rows (each warp one row group a lane); tiles over a persistent grid of
    SYSTEM_BLOCKS blocks an SM, each with a ring of up to SYSTEM_DEPTH
    stages in its share of SYSTEM_SM_SMEM (one block an SM where fewer than
    two stages fit; depth 0, the lanes reading device memory at
    SYSTEM_BLOCKS blocks an SM, where two do not fit one block either or
    `staged` is False: an input not 16-byte aligned)."""
    if N < 1 or J < 1 or sms < 1:
        raise ValueError(f"dist_system: no plan for {N} rows of {J} pairs on {sms} SMs")
    G = system_lanes(J)
    tile = SYSTEM_WARPS * (LANES // G)
    stage = tile * (_PAIR_BYTES * J + _EIK_BYTES)
    ring = _up128(_SYSTEM_BARRIERS + tile * _OUT_BYTES)
    per_sm = SYSTEM_BLOCKS
    depth = min(SYSTEM_DEPTH, (SYSTEM_SM_SMEM // per_sm - ring) // stage)
    if depth < 2:
        per_sm = 1
        depth = min(SYSTEM_DEPTH, (SYSTEM_SM_SMEM - ring) // stage)
    if depth < 2 or not staged:
        depth, per_sm = 0, SYSTEM_BLOCKS
    blocks = min(-(-N // tile), per_sm * sms)
    return SystemPlan(G, tile, depth, blocks, ring + depth * stage, ring)


class _SystemPlan(ctypes.Structure):
    """csrc/distcg.cu SystemPlan, field for field."""
    _fields_ = [(n, ctypes.c_int64) for n in SystemPlan._fields]


class _SystemArgs(ctypes.Structure):
    """csrc/distcg.cu SystemArgs, field for field (every field 8 bytes); the
    regularizer stage's fields after the plan."""
    _p, _i, _d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    _fields_ = [("w", _p), ("r", _p), ("J0", _p), ("Ji", _p), ("eik_r", _p),
                ("eik_J0", _p), ("eik_Ji", _p), ("A", _p), ("t", _p),
                ("n", _i), ("pairs", _i), ("eik", _i), ("reg_weight_n", _d),
                ("plan", _SystemPlan),
                ("valid", _p), ("dist", _p), ("nbr", _p), ("nbr_dir", _p),
                ("nbr_const", _p), ("lap", _p), ("lap_const", _p), ("lap_r", _p),
                ("reg", _i), ("laplacian", _i), ("voxel", _d)]


# dist_cg's launch: threads a block, the three layouts of a block's tile,
# its rows on multiples of TILE_ROWS (16-byte aligned for the bulk copies)
CG_THREADS = 512
TILE, VECTORS, GLOBAL = 0, 1, 2
MODES = ("tile", "vectors", "global")
TILE_ROWS = 16
SMEM_PER_BLOCK = 232448          # an H100 block's shared memory, at most
# shared memory before the regions: the mbarrier (16 bytes), the warps'
# sums [warps][2] and the grid's (16 bytes) (csrc/distcg.cu kHeader)
_HEADER = 16 + (CG_THREADS // 32) * 2 * 4 + 16
# bytes a row of the tile's read-only arrays: A, nbr, rev, valid; lap_idx
# under the Laplacian's neighbour term
_ROW_BYTES = {"A": 40, "nbr": 12, "rev": 24, "valid": 1}
_LAP_BYTES = 24
# the floats a row of the block's own: s = A P p (4), x, r, z, A p, p, the
# safe diagonal, damping diag (the Laplacian row under its neighbour term);
# the floats a row other blocks read: two (z, p_old) pairs and the Laplacian
# row, and under TILE A's rows 1-3 and each one's neighbours along the other
# two axes (12 + 6)
_OWN_VECTORS = 4 + 7
_PUBLISHED = 5
_TABLES = 12 + 6
_OWN_MAX = 4 + 8


class CgPlan(NamedTuple):
    """dist_cg's launch for N rows: csrc/distcg.cu CgPlan, field for field."""
    blocks: int
    tile: int              # rows a block (the last block's fewer), a multiple of 16
    mode: int              # TILE, VECTORS or GLOBAL
    smem_bytes: int        # a block's dynamic shared memory
    barriers: int          # grid barriers a CG step
    A: int                 # byte offsets of the tile's regions in shared
    nbr: int               # memory, 0 where the layout keeps it in global
    rev: int               # memory
    lap: int
    valid: int
    vec: int
    tail: int = 0          # grid barriers after the last step: 1 with the update stage


def grid_barriers(plan: CgPlan, steps: int) -> int:
    """The grid barriers a dist_cg launch on `plan` crosses in `steps`
    steps: the prologue's grid.sync, the plan's barriers a step and its
    tail (the update stage's)."""
    return 1 + plan.barriers * steps + plan.tail


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def _own_vectors(lap_nbr: bool) -> int:
    return _OWN_VECTORS + int(lap_nbr)


def _row_bytes(lap_nbr: bool) -> int:
    """Shared memory a row of a TILE layout takes."""
    return (sum(_ROW_BYTES.values()) + (_LAP_BYTES if lap_nbr else 0)
            + 4 * _own_vectors(lap_nbr))


def resident_tile_limit(lap_nbr: bool) -> int:
    """The most rows a block's tile may hold in the TILE layout (a
    multiple of TILE_ROWS; every region of such a tile is a multiple of 16
    bytes)."""
    per = TILE_ROWS * _row_bytes(lap_nbr)
    return (SMEM_PER_BLOCK - _HEADER) // per * TILE_ROWS


def vector_tile_limit(lap_nbr: bool) -> int:
    """The most rows a block's tile may hold in the VECTORS layout."""
    per = TILE_ROWS * 4 * _own_vectors(lap_nbr)
    return (SMEM_PER_BLOCK - _HEADER) // per * TILE_ROWS


def _cg_plan(N: int, *, use_lap: bool, lap_nbr: bool, sms: int,
             update: bool = False) -> CgPlan:
    """dist_cg's launch for N rows on a card of `sms` SMs: one block an SM
    at most, contiguous tiles on multiples of TILE_ROWS rows (the last
    shorter), every block at least one row; the first layout whose shared
    memory fits a block (TILE, then VECTORS, then GLOBAL) and its regions;
    the grid barriers a step (2, 3 under the Laplacian's neighbour term)
    and after the last (1 with the update stage, which needs no more shared
    memory: its rows' steps are in the vectors already)."""
    if N < 1 or sms < 1:
        raise ValueError(f"dist_cg: no plan for {N} rows on {sms} SMs")
    nbr_term = bool(use_lap and lap_nbr)
    blocks = min(sms, -(-N // TILE_ROWS))
    per_block = -(-N // blocks)
    tile = -(-per_block // TILE_ROWS) * TILE_ROWS
    blocks = -(-N // tile)
    barriers = 2 + int(nbr_term)
    vec_bytes = 4 * _own_vectors(nbr_term) * tile
    regions = dict(A=0, nbr=0, rev=0, lap=0, valid=0, vec=0)
    if tile <= resident_tile_limit(nbr_term):
        mode, off = TILE, _HEADER
        sizes = dict(_ROW_BYTES, lap=_LAP_BYTES if nbr_term else 0)
        for name in ("A", "nbr", "rev", "lap", "valid"):
            if sizes[name]:
                regions[name] = off
                off += _up16(sizes[name] * tile)
        regions["vec"] = off
        off += vec_bytes
    elif tile <= vector_tile_limit(nbr_term):
        mode, off = VECTORS, _HEADER
        regions["vec"] = off
        off += vec_bytes
    else:
        mode, off = GLOBAL, _HEADER
    return CgPlan(blocks, tile, mode, off, barriers, **regions, tail=int(update))


_bound = None
_plans: Dict[tuple, CgPlan] = {}
_occupancy: Dict[tuple, int] = {}


class _CgPlan(ctypes.Structure):
    """csrc/distcg.cu CgPlan, field for field."""
    _fields_ = [(n, ctypes.c_int64) for n in CgPlan._fields]


class _CgArgs(ctypes.Structure):
    """csrc/distcg.cu CgArgs, field for field (every field 8 bytes)."""
    _p, _i, _d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    _fields_ = [("A", _p), ("t", _p), ("nbr", _p), ("rev", _p), ("lap", _p),
                ("valid", _p), ("lap_r", _p), ("delta", _p), ("steps", _p),
                ("work", _p), ("sync", _p), ("n", _i), ("maxiter", _i),
                ("fixed", _i), ("use_lap", _i), ("lap_nbr", _i),
                ("reg_weight_l", _d), ("diag_coef", _d), ("nbr_coef", _d),
                ("diag_coef_sq", _d), ("nbr_coef_sq", _d), ("damping", _d),
                ("tol_sq", _d), ("atol_sq", _d), ("plan", _CgPlan),
                ("dist", _p), ("nbr_dir", _p), ("nbr_const", _p), ("new_dist", _p),
                ("new_grad", _p), ("update", _i), ("voxel", _d), ("accept", _d)]


def _check(what: str, dev, named) -> None:
    for name, t, shape, dtype in named:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, expected {dev}")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _bind(lib):
    """The C entry points' argument and result types set on `lib`."""
    lib.dist_system.argtypes = [ctypes.POINTER(_SystemArgs), ctypes.c_void_p]
    lib.dist_system.restype = ctypes.c_int
    lib.dist_cg.argtypes = [ctypes.POINTER(_CgArgs), ctypes.c_void_p]
    lib.dist_cg.restype = ctypes.c_int
    lib.dist_cg_occupancy.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int64)]
    lib.dist_cg_occupancy.restype = ctypes.c_int
    lib.dist_barriers.argtypes = [ctypes.POINTER(_CgPlan), ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.dist_barriers.restype = ctypes.c_int
    return lib


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        _bound = _bind(load_library(_LIB_NAME))
    return _bound


def cg_plan(dev: torch.device, N: int, *, use_lap: bool, lap_nbr: bool,
            update: bool = False) -> CgPlan:
    """_cg_plan on `dev`'s SMs, found once; its layout's cooperative
    occupancy at its shared memory checked once per (device, mode, bytes):
    a layout the card cannot run raises."""
    key = (dev.index, N, bool(use_lap), bool(use_lap and lap_nbr), bool(update))
    plan = _plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _cg_plan(N, use_lap=use_lap, lap_nbr=lap_nbr, sms=sms, update=update)
        okey = (dev.index, plan.mode, plan.smem_bytes)
        if okey not in _occupancy:
            per_sm = ctypes.c_int64()
            with torch.cuda.device(dev):
                rc = _library().dist_cg_occupancy(plan.mode, plan.smem_bytes,
                                                  ctypes.byref(per_sm))
            if rc != 0 or per_sm.value < 1:
                raise RuntimeError(
                    f"dist_cg: the {MODES[plan.mode]} layout of {plan.smem_bytes} "
                    f"bytes does not run cooperatively on {dev} (CUDA error {rc}, "
                    f"{per_sm.value} blocks an SM)")
            _occupancy[okey] = per_sm.value
        _plans[key] = plan
    return plan


def system_plan(dev: torch.device, N: int, J: int, *, staged: bool = True) -> SystemPlan:
    """_system_plan on `dev`'s SMs (read once a device)."""
    from psgradientsdf_tpu_torch.kernels import sm_count

    return _system_plan(N, J, sms=sm_count(dev), staged=staged)


def _work_floats(plan: CgPlan, N: int) -> int:
    """dist_cg's work buffer (csrc/distcg.cu kPublished): the published
    rows, then TILE's tables from a 16-byte boundary, or GLOBAL's own
    rows."""
    if plan.mode == TILE:
        return -(-_PUBLISHED * N // 4) * 4 + _TABLES * N
    return (_PUBLISHED + (_OWN_MAX if plan.mode == GLOBAL else 0)) * N


def _sync_words(plan: CgPlan, dev) -> torch.Tensor:
    """The barriers' counter (4 words, set to 0 by the kernel) and the
    blocks' partials [2][blocks][2] floats, in one buffer."""
    return torch.empty((4 + 4 * plan.blocks,), dtype=torch.int32, device=dev)


def barrier_floor(dev: torch.device, plan: CgPlan, barriers: int, kind: int = 1) -> None:
    """Launch an empty cooperative kernel on `plan`'s grid that crosses
    `barriers` barriers: kind 1 one grid.sync and then dist_cg's counter
    barriers with their sums (the solve's latency floor), kind 0
    grid.syncs alone (not a kernel of any path, so not counted)."""
    sync = _sync_words(plan, dev)
    with torch.cuda.device(dev):
        rc = _library().dist_barriers(ctypes.byref(_CgPlan(*plan)), barriers, kind,
                                      sync.data_ptr(),
                                      torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dist_barriers: launch failed, CUDA error {rc}")


def _launch(name: str, args, dev) -> None:
    with torch.cuda.device(dev):
        rc = getattr(_library(), name)(ctypes.byref(args),
                                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    launch_counts[name] += 1


def _system_inputs(rd, DJ, N: int, F: int):
    f32 = torch.float32
    return [("rd.w", rd.w, (N, F, 3), f32), ("rd.r", rd.r, (N, F, 3), f32),
            ("DJ.J0", DJ.J0, (N, F, 3), f32), ("DJ.Ji", DJ.Ji, (N, 3, F, 3), f32)]


def _system_launch(rd, DJ, a: _SystemArgs, staged_inputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """dist_system's launch with the argument block `a` (its inputs set
    beside the pairs'): A and t allocated, the pairs' pointers and the plan
    set (bulk-copied where every input of `staged_inputs` starts on a
    16-byte boundary)."""
    w = rd.w
    N, F = w.shape[0], w.shape[1]
    A = torch.empty((N, 10), dtype=torch.float32, device=w.device)
    t = torch.empty((N, 4), dtype=torch.float32, device=w.device)
    a.w, a.r, a.J0, a.Ji = (w.data_ptr(), rd.r.data_ptr(), DJ.J0.data_ptr(),
                            DJ.Ji.data_ptr())
    a.A, a.t = A.data_ptr(), t.data_ptr()
    a.n, a.pairs = N, F * 3
    aligned = all(x.data_ptr() % 16 == 0 for x in [w, rd.r, DJ.J0, DJ.Ji] + staged_inputs)
    a.plan = _SystemPlan(*system_plan(w.device, N, F * 3, staged=aligned))
    _launch("dist_system", a, w.device)
    return A, t


def _same_problem(what: str, prob: RefineProblem, stencil: StencilReverse) -> None:
    if stencil is None or stencil.source is not prob.nbr_idx:
        raise ValueError(f"{what}: the stencil table is missing or was built for "
                         "another problem")


def _cg_launch(A, t, valid, stencil: StencilReverse, lap, *, reg_weight_l: float,
               damping: float, cg_iters: int, cg_tol: float, cg_static: bool,
               atol: float, steps_out: Optional[List], update=None) -> torch.Tensor:
    """dist_cg's launch -> delta; `update` (prob, dist, voxel_size, new_dist,
    new_grad) adds the update stage, which writes the last two."""
    N = A.shape[0]
    f32, i32 = torch.float32, torch.int32
    named = [("A", A, (N, 10), f32), ("t", t, (N, 4), f32),
             ("valid", valid, (N,), torch.bool),
             ("stencil.nbr", stencil.nbr, (N, 3), i32),
             ("stencil.rev", stencil.rev, (N, 6), i32),
             ("stencil.lap", stencil.lap, (N, 6), i32)]
    if lap is not None:
        named.append(("lap.r", lap.r, (N,), f32))
    if update is not None:
        prob, dist = update[0], update[1]
        named += [("dist", dist, (N,), f32), ("nbr_dir", prob.nbr_dir, (N, 3), f32),
                  ("nbr_dist_const", prob.nbr_dist_const, (N, 3), f32)]
    _check("dist_cg", A.device, named)
    if cg_iters < 0:
        raise ValueError(f"dist_cg: cg_iters must be >= 0, got {cg_iters}")
    dev = A.device
    lap_nbr = lap is not None and lap.nbr_coef != 0.0
    plan = cg_plan(dev, N, use_lap=lap is not None, lap_nbr=lap_nbr,
                   update=update is not None)
    if plan.mode == TILE:
        staged = [("A", A), ("valid", valid), ("stencil.nbr", stencil.nbr),
                  ("stencil.rev", stencil.rev)] + ([("stencil.lap", stencil.lap)]
                                                   if lap_nbr else [])
        for name, x in staged:
            if x.data_ptr() % 16:
                raise ValueError(f"dist_cg: {name} must start on a 16-byte "
                                 "boundary (its tiles are bulk-copied)")
    delta = torch.empty((N,), dtype=f32, device=dev)
    steps = torch.empty((1,), dtype=torch.int64, device=dev)
    work = torch.empty((_work_floats(plan, N),), dtype=f32, device=dev)
    sync = _sync_words(plan, dev)
    a = _CgArgs()
    a.A, a.t, a.valid = A.data_ptr(), t.data_ptr(), valid.data_ptr()
    a.nbr, a.rev, a.lap = (stencil.nbr.data_ptr(), stencil.rev.data_ptr(),
                           stencil.lap.data_ptr())
    a.delta, a.steps = delta.data_ptr(), steps.data_ptr()
    a.work, a.sync = work.data_ptr(), sync.data_ptr()
    a.n, a.maxiter, a.fixed = N, cg_iters, int(cg_static)
    a.plan = _CgPlan(*plan)
    if lap is not None:
        a.lap_r, a.use_lap, a.lap_nbr = lap.r.data_ptr(), 1, int(lap_nbr)
        a.reg_weight_l = float(reg_weight_l)
        a.diag_coef, a.nbr_coef = float(lap.diag_coef), float(lap.nbr_coef)
        a.diag_coef_sq, a.nbr_coef_sq = lap.diag_coef ** 2, lap.nbr_coef ** 2
    a.damping = float(damping)
    a.tol_sq, a.atol_sq = cg_tol * cg_tol, atol * atol
    if update is not None:
        prob, dist, voxel_size, new_dist, new_grad = update
        a.update, a.dist = 1, dist.data_ptr()
        a.nbr_dir, a.nbr_const = prob.nbr_dir.data_ptr(), prob.nbr_dist_const.data_ptr()
        a.new_dist, a.new_grad = new_dist.data_ptr(), new_grad.data_ptr()
        a.voxel, a.accept = float(voxel_size), distreg.accept_threshold(voxel_size)
    _launch("dist_cg", a, dev)
    if steps_out is not None:
        steps_out.append(steps.view(()))
    return delta


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def dist_system(rd, DJ, eik, *, reg_weight_n: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distance block's rows (A [N,10], t [N,4]) from the residual pass
    rd (w, r [N,F,3]), the distance Jacobian DJ (J0 [N,F,3], Ji [N,3,F,3])
    and the Eikonal operator (r, J0 [N], Ji [N,3]; None when its weight is
    0): one kernel launch on the card, dist_system_plain on the CPU.  The
    tiles are bulk-copied where every input starts on a 16-byte boundary,
    else the lanes read device memory; the same bits either way."""
    w = rd.w
    if w.device.type == "cpu":
        return dist_system_plain(rd, DJ, eik, reg_weight_n=reg_weight_n)
    N, F = w.shape[0], w.shape[1]
    f32 = torch.float32
    named = _system_inputs(rd, DJ, N, F)
    if eik is not None:
        named += [("eik.r", eik.r, (N,), f32), ("eik.J0", eik.J0, (N,), f32),
                  ("eik.Ji", eik.Ji, (N, 3), f32)]
    _check("dist_system", w.device, named)
    a = _SystemArgs()
    if eik is not None:
        a.eik_r, a.eik_J0, a.eik_Ji = (eik.r.data_ptr(), eik.J0.data_ptr(),
                                       eik.Ji.data_ptr())
    a.eik = int(eik is not None)
    a.reg_weight_n = float(reg_weight_n)
    return _system_launch(rd, DJ, a, [] if eik is None else [eik.r, eik.J0, eik.Ji])


def dist_system_reg(rd, DJ, prob: RefineProblem, dist: torch.Tensor,
                    stencil: StencilReverse, voxel_size: float, *, reg_weight_n: float,
                    reg_weight_l: float, diag_only: bool):
    """dist_system with its regularizer stage -> (A [N,10], t [N,4], lap):
    the Eikonal row (where reg_weight_n is not 0) formed from dist and the
    problem's one-sided stencil, and the Laplacian operator (where
    reg_weight_l is not 0; else None) whose residual r [N] the same launch
    writes from the six-neighbour stencil.  One kernel launch on the card
    (the stencils as `stencil`'s int32 tables, which must be this problem's),
    reg_operators_plain then dist_system_plain on the CPU."""
    _same_problem("dist_system_reg", prob, stencil)
    eikonal, laplacian = reg_weight_n != 0.0, reg_weight_l != 0.0
    w = rd.w
    if w.device.type == "cpu":
        eik, lap = distreg.reg_operators_plain(prob, dist, voxel_size, eikonal=eikonal,
                                               laplacian=laplacian, diag_only=diag_only)
        return (*dist_system_plain(rd, DJ, eik, reg_weight_n=reg_weight_n), lap)
    N, F = w.shape[0], w.shape[1]
    f32, i32 = torch.float32, torch.int32
    named = _system_inputs(rd, DJ, N, F)
    if eikonal or laplacian:
        named += [("valid", prob.valid, (N,), torch.bool), ("dist", dist, (N,), f32),
                  ("stencil.nbr", stencil.nbr, (N, 3), i32),
                  ("nbr_dir", prob.nbr_dir, (N, 3), f32),
                  ("nbr_dist_const", prob.nbr_dist_const, (N, 3), f32)]
    if laplacian:
        named += [("stencil.lap", stencil.lap, (N, 6), i32),
                  ("lap_dist_const", prob.lap_dist_const, (N, 6), f32)]
    _check("dist_system_reg", w.device, named)
    lap_r = torch.empty((N,), dtype=f32, device=w.device) if laplacian else None
    a = _SystemArgs()
    a.reg_weight_n = float(reg_weight_n)
    if eikonal or laplacian:                  # else the rows alone, no stage
        a.eik, a.reg, a.laplacian = int(eikonal), 1, int(laplacian)
        a.voxel = float(voxel_size)
        a.valid, a.dist = prob.valid.data_ptr(), dist.data_ptr()
        a.nbr, a.nbr_dir = stencil.nbr.data_ptr(), prob.nbr_dir.data_ptr()
        a.nbr_const = prob.nbr_dist_const.data_ptr()
    if laplacian:
        a.lap, a.lap_const = stencil.lap.data_ptr(), prob.lap_dist_const.data_ptr()
        a.lap_r = lap_r.data_ptr()
    A, t = _system_launch(rd, DJ, a, [])
    lap = (distreg.lap_operator(prob, lap_r, voxel_size, diag_only) if laplacian
           else None)
    return A, t, lap


def dist_cg(A: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
            stencil: StencilReverse, lap, *, reg_weight_l: float,
            damping: float, cg_iters: int, cg_tol: float, cg_static: bool,
            atol: float = 0.0, steps_out: Optional[List] = None) -> torch.Tensor:
    """The distance step delta [N] (0 on invalid rows) from the assembled
    rows: the whole Jacobi-PCG in ONE cooperative launch on the card, its
    stop decided there (nothing read back; `steps_out` receives the step
    count as a 0-dim int64 tensor on the card), dist_cg_plain on the CPU.
    `lap` is the Laplacian operator (r [N], diag_coef, nbr_coef), None when
    its weight is 0."""
    kw = dict(reg_weight_l=reg_weight_l, damping=damping, cg_iters=cg_iters,
              cg_tol=cg_tol, cg_static=cg_static, atol=atol, steps_out=steps_out)
    if A.device.type == "cpu":
        return dist_cg_plain(A, t, valid, stencil, lap, **kw)
    return _cg_launch(A, t, valid, stencil, lap, **kw)


def dist_cg_update(A: torch.Tensor, t: torch.Tensor, prob: RefineProblem,
                   dist: torch.Tensor, stencil: StencilReverse, lap, voxel_size: float, *,
                   reg_weight_l: float, damping: float, cg_iters: int, cg_tol: float,
                   cg_static: bool, atol: float = 0.0, steps_out: Optional[List] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dist_cg with its update stage -> (delta, new_dist [N], new_grad
    [N,3]): the solve as dist_cg on the problem's rows (prob.valid), then the
    accept rule (|delta| < sqrt(3) h on a valid row) and the one-sided
    gradient of the accepted distances, as ops/distreg.dist_update gives
    them.  One cooperative launch on the card (the stencil must be this
    problem's), dist_cg_plain then dist_update_plain on the CPU."""
    _same_problem("dist_cg_update", prob, stencil)
    kw = dict(reg_weight_l=reg_weight_l, damping=damping, cg_iters=cg_iters,
              cg_tol=cg_tol, cg_static=cg_static, atol=atol, steps_out=steps_out)
    if A.device.type == "cpu":
        delta = dist_cg_plain(A, t, prob.valid, stencil, lap, **kw)
        return (delta, *distreg.dist_update_plain(prob, dist, delta, voxel_size))
    N = A.shape[0]
    new_dist = torch.empty((N,), dtype=torch.float32, device=A.device)
    new_grad = torch.empty((N, 3), dtype=torch.float32, device=A.device)
    delta = _cg_launch(A, t, prob.valid, stencil, lap, **kw,
                       update=(prob, dist, voxel_size, new_dist, new_grad))
    return delta, new_dist, new_grad
