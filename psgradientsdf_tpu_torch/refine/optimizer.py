"""Alternating photometric refinement: the host-side outer loop.

Counterpart of PsOptimizer::alternatingOptimize (PsOptimizer.cpp:239-428) and
LedOptimizer::alternatingOptimize (LedOptimizer.cpp:279-478).  The
data-dependent control flow (convergence / divergence aborts, reg-weight
auto-normalization, the iteration-5 upsample, periodic artifact dumps) stays
in Python exactly as in the reference; each block solve (albedo / light /
distance / pose) is a function on tensors over the compacted surface set, on
the device of the volume it was given.

Reference behaviors carried over:
  * SH light init: l = SH(R (0,0,-1)), l[0]=0.02 (PsOptimizer.cpp:25-42)
  * LED light init: intensity-ratio matching (LedOptimizer.cpp:76-112)
  * albedo init: mean observed intensity (Optimizer.cpp:50-81)
  * reg-weight normalization by E/E_reg before the loop (PsOptimizer.cpp:274-288)
  * convergence: rel dE < conv_threshold; divergence: dE > 0 -> abort with
    artifact save (PsOptimizer.cpp:368-384)
  * upsample at iter 5 with temporary Laplacian smoothing, disabled after
    iter 15 (PsOptimizer.cpp:386-413)
  * artifact dumps every 3 iterations (PsOptimizer.cpp:419-423)

Host reads: the fused loop (the default) reads the device ONCE an
iteration: every block's energies and CG steps and the pose solve's status
in one small copy (iteration_readout, _fused_step), as the JAX package
reads its one-dispatch iteration; the per-block loop reads each block's
energies.  The CG stop flag is read every few steps on a mesh
(refine/solvers.py; the distance and albedo blocks' CGs on one device
decide their stop on the card, ops/distcg.py and ops/albedo.py).  On one
card the fused iteration is ONE CUDA graph, captured once per problem and
static arguments and replayed once an iteration (refine/graph.py; the
upsample captures anew); `capture=False` runs it eagerly, and the mesh's
loop, the joint block and the CPU run it eagerly too (`loop_kind`, logged
as `refine_loop`).  The periodic
every-3-iteration dumps (PsOptimizer.cpp:419-423) run on a writer thread
(utils/writer.py): the loop starts the device->host copies of what the
dump reads and goes on, the thread runs marching cubes and writes the PLY
files; the next dump,
the end of the loop and a failure join it, and a failed dump is logged as
`artifact_dump_error` without stopping the refinement.  The upsample and
terminal dumps are synchronous.

Mid-run checkpoints: the loop records its scalar state (`loop_state`) at
every iteration boundary and, with `checkpoint_every` and `checkpoint_path`
set, writes io/checkpoint.save_refine_state every N iterations; a refiner
whose `loop_state` was restored (io/checkpoint.load_refine_state) continues
the loop exactly where the checkpoint left it.

On a device mesh (`mesh=`, parallel/mesh.make_mesh) the problem, the state
and the keyframe images are placed after every extraction (place_on_mesh:
N over "z", keyframes over "frames") and each step runs through
parallel/refine.py's functions, which have the single-device ones'
signatures (RefineOps); the exports, the upsample and the checkpoints work
on the gathered arrays, on the mesh's first device.  On a mesh over
processes (parallel/distributed.py) every process runs this loop on its own
device: each stop decision reads energies and CG dots that reach every
process with the same bits, the gathers of the exports and of the mid-run
checkpoints are all-gathers in which every process joins, and only process
0 writes files (`writes`) and logs the `refine_checkpoint` event.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from psgradientsdf_tpu_torch import resolve_device
from psgradientsdf_tpu_torch.config import LED, OptimizerConfig
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.core.volume import GradSdfVolume
from psgradientsdf_tpu_torch.io import ply, sdf_io, trajectory
from psgradientsdf_tpu_torch.ops import distcg, energy, normaleq, residual
from psgradientsdf_tpu_torch.ops.image import rgb_float
from psgradientsdf_tpu_torch.ops.marching_cubes import extract_mesh_from_volume
from psgradientsdf_tpu_torch.parallel import distributed
from psgradientsdf_tpu_torch.refine import geometry, graph, jacobians, render, solvers
from psgradientsdf_tpu_torch.refine.problem import RefineProblem, extract_problem, writeback
from psgradientsdf_tpu_torch.refine.upsample import upsample_volume
from psgradientsdf_tpu_torch.utils import sh as sh_mod
from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger
from psgradientsdf_tpu_torch.utils.timer import Timer
from psgradientsdf_tpu_torch.utils.writer import HostCopies, Writer


# ------------------------------------------------------------------- blocks

def _energy_from_rd(prob, rd, dist, albedo, *, loss, lam, voxel_size):
    """(E_ps, E_normal, E_laplacian, E_rho) as one [4] tensor, from an
    existing residual pass: the alternating loop evaluates energies from the
    SAME ResidualData it hands the next block as its linearization point.
    One launch of ops/energy.py's kernel on the card."""
    return energy.energy_sums(prob, rd, dist, albedo, loss=loss, lam=lam,
                              voxel_size=voxel_size, n_surface=prob.n_surface)[1]


def _albedo_core(prob, geom, rd, dist, albedo, grad_stored, poses, K, lights,
                 *, model, order, loss, lam, voxel_size, reg_weight_rho,
                 damping, stencil=None, steps_out=None):
    """Albedo GN update from an existing residual pass (its linearization
    point must be the current state): the system formed per pair and the
    CG with its accept rule (ops/albedo.py through solvers.solve_albedo;
    J_rho is never formed as a tensor), the problem's reverse stencil table
    `stencil` read under the regularizer."""
    _, new_albedo = solvers.solve_albedo(
        prob, rd, albedo, grad_stored, lights, poses, voxel_size, model=model,
        order=order, reg_weight_rho=reg_weight_rho, damping=damping,
        steps_out=steps_out, stencil=stencil,
    )
    return new_albedo


def _light_core(prob, geom, rd, dist, albedo, grad_stored, poses, K, lights,
                *, model, order, loss, lam, voxel_size, damping):
    if model == LED:
        H, g = normaleq.light_normal_eqs_led(rd, prob, geom, dist, grad_stored, albedo, poses)
        delta = solvers.solve_light_led_from_normal_eqs(H, g, damping)
    else:
        J = jacobians.light_jacobian_sh(prob, albedo, grad_stored, order)
        delta = solvers.solve_light_from_normal_eqs(*normaleq.light_normal_eqs_sh(rd, J))
    return lights - delta


def _dist_core(prob, geom, rd, dist, albedo, grad_stored, poses, K, lights,
               *, model, order, loss, lam, voxel_size, reg_weight_n,
               reg_weight_l, damping, laplacian_diag_only, stencil,
               steps_out=None):
    """Distance GN update: the Jacobian, then the assembled system, its CG
    and the update (ops/distcg.py through solvers.distance_step: three
    launches a block on the card with the Jacobian's) over the problem's
    reverse stencil table `stencil`."""
    _, DJ = residual.dist_jacobian(prob, geom, rd, dist, albedo, grad_stored,
                                   poses, K, lights, model=model, order=order,
                                   voxel_size=voxel_size)
    return solvers.distance_step(
        prob, rd, DJ, dist, voxel_size,
        reg_weight_n=reg_weight_n, reg_weight_l=reg_weight_l, damping=damping,
        laplacian_diag_only=laplacian_diag_only, steps_out=steps_out,
        stencil=stencil,
    )


def _pose_core(prob, geom, rd, dist, albedo, grad_stored, poses, K, lights,
               *, model, order, loss, lam, voxel_size, damping, info_out=None):
    """Pose GN update; with `info_out` the per-keyframe solve's status goes
    there for the caller's one read (solvers.solve_pose_from_normal_eqs)."""
    H, g = normaleq.pose_normal_eqs(rd, K, poses, albedo, grad_stored, lights, model)
    delta = solvers.solve_pose_from_normal_eqs(H, g, damping, info_out=info_out)
    return solvers.update_poses(poses, delta)


def _joint_dp_core(prob, geom, rd, dist, albedo, grad_stored, poses, K, lights,
                   *, model, order, loss, lam, voxel_size, reg_weight_n,
                   reg_weight_l, damping, laplacian_diag_only, steps_out=None):
    """Joint distance+pose GN update with Schur-complement pose elimination
    (solvers.solve_joint_dist_pose) — an extension over the reference's
    alternating distance-then-pose blocks."""
    G, DJ = residual.dist_jacobian(prob, geom, rd, dist, albedo, grad_stored,
                                   poses, K, lights, model=model, order=order,
                                   voxel_size=voxel_size, with_G=True)
    J_c = normaleq.pose_jacobian(G, rd, poses, albedo, grad_stored, lights, model)
    delta_d, delta_xi = solvers.solve_joint_dist_pose(
        prob, rd, DJ, J_c, dist, voxel_size,
        reg_weight_n=reg_weight_n, reg_weight_l=reg_weight_l, damping=damping,
        laplacian_diag_only=laplacian_diag_only, steps_out=steps_out,
    )
    new_dist, new_grad = solvers.update_distance(prob, dist, delta_d, voxel_size)
    new_poses = solvers.update_poses(poses, delta_xi)
    return new_dist, new_grad, new_poses


# the blocks whose solve is a CG (the others are dense per-frame solves)
_CG_BLOCKS = ("albedo", "distance", "joint_dp")


def block_names(light, albedo, distance, pose, joint_dp) -> List[str]:
    """The enabled blocks in the order an iteration runs them
    (PsOptimizer.cpp:303-366)."""
    names = []
    if albedo:
        names.append("albedo")
    if light:
        names.append("light")
    if distance and pose and joint_dp:
        names.append("joint_dp")
    else:
        if distance:
            names.append("distance")
        if pose:
            names.append("pose")
    return names


def _run_block(name, prob, geom, rd, dist, albedo, grad_stored, poses, K, lights,
               *, kw, reg_weight_n, reg_weight_l, reg_weight_rho, damping,
               laplacian_diag_only, steps_out=None, stencil=None, info_out=None):
    """One block's update from the residual pass `rd` at the current state
    -> (dist, albedo, grad_stored, poses, lights); `stencil` is the
    problem's reverse stencil table for the distance and albedo blocks;
    `info_out` takes the pose solve's status (_pose_core)."""
    args = (prob, geom, rd, dist, albedo, grad_stored, poses, K, lights)
    dkw = dict(reg_weight_n=reg_weight_n, reg_weight_l=reg_weight_l,
               damping=damping, laplacian_diag_only=laplacian_diag_only,
               steps_out=steps_out)
    if name == "albedo":
        albedo = _albedo_core(*args, **kw, reg_weight_rho=reg_weight_rho,
                              damping=damping, stencil=stencil, steps_out=steps_out)
    elif name == "light":
        lights = _light_core(*args, **kw, damping=damping)
    elif name == "joint_dp":
        dist, grad_stored, poses = _joint_dp_core(*args, **kw, **dkw)
    elif name == "distance":
        dist, grad_stored = _dist_core(*args, **kw, **dkw, stencil=stencil)
    elif name == "pose":
        poses = _pose_core(*args, **kw, damping=damping, info_out=info_out)
    else:
        raise ValueError(f"unknown block {name!r}")
    return dist, albedo, grad_stored, poses, lights


def _iteration_core(prob, geom, dist, albedo, grad_stored, poses, images, K,
                    lights, *, model, order, loss, lam, voxel_size,
                    reg_weight_n, reg_weight_l, reg_weight_rho, damping,
                    laplacian_diag_only, do_light, do_albedo, do_distance,
                    do_pose, joint_dp, steps_out=None,
                    block_done: Optional[Callable] = None, ops=None,
                    stencil=None, info_out=None):
    """ONE full alternating iteration — every enabled block plus its
    residual refresh and post-block energies — from the state alone: it
    makes its own leading residual pass, where the per-block path of the
    loop reuses the one it already holds.  Block and energy semantics are
    IDENTICAL (same cores, same refresh points — PsOptimizer.cpp:303-366
    order).

    Returns (dist, albedo, grad_stored, poses, lights, energies) with
    `energies` a tuple of [4] tensors (E, E_n, E_l, E_r) after each enabled
    block, in block order.  `block_done(name, energies)` is called after each
    block's refresh (the loop times blocks with it); `steps_out` collects the
    CG step counts.  `ops` (RefineOps) are the functions it is made of: the
    single-device ones by default, a mesh's from parallel/refine.py;
    `stencil` is the problem's reverse stencil table (ops/distcg.py), which
    a distance block (and an albedo block under its regularizer) on one
    device needs; a mesh's ops take none.  `info_out` (single-device ops
    only) collects the pose solve's status, read by the caller: a singular
    block then raises there, not here.
    """
    ops = SINGLE if ops is None else ops
    extra = {} if info_out is None else {"info_out": info_out}
    kw = dict(model=model, order=order, loss=loss, lam=lam,
              voxel_size=voxel_size)

    def refresh():
        rd = ops.residuals(prob, geom, dist, albedo, grad_stored,
                           poses, images, K, lights, **kw)
        return rd, ops.energies(prob, rd, dist, albedo, loss=loss, lam=lam,
                                voxel_size=voxel_size)

    rd, _ = refresh()
    energies = []
    for name in block_names(do_light, do_albedo, do_distance, do_pose, joint_dp):
        dist, albedo, grad_stored, poses, lights = ops.run_block(
            name, prob, geom, rd, dist, albedo, grad_stored, poses, K, lights,
            kw=kw, reg_weight_n=reg_weight_n, reg_weight_l=reg_weight_l,
            reg_weight_rho=reg_weight_rho, damping=damping,
            laplacian_diag_only=laplacian_diag_only, steps_out=steps_out,
            stencil=stencil, **extra)
        rd, e = refresh()
        energies.append(e)
        if block_done is not None:
            block_done(name, e)
    return dist, albedo, grad_stored, poses, lights, tuple(energies)


def iteration_readout(prob, geom, dist, albedo, grad_stored, poses, images, K,
                      lights, *, ops=None, stencil=None, **kw):
    """_iteration_core with what the loop reads of it packed into ONE
    device tensor -> (the new state (dist, albedo, grad_stored, poses,
    lights), graph.pack's readout [n] float64: each block's energies and CG
    steps, then the pose solve's status, ok: a 0-dim bool, whether no pose
    block was singular, or None without a pose solve's status).  The eager
    fused loop and the graph's capture (refine/graph.py) both run this, so
    the card's graph and the CPU read the device the same way."""
    ops = SINGLE if ops is None else ops
    steps: List = []
    info: Optional[List] = [] if ops is SINGLE else None
    blocks, seen = [], [0]

    def done(name, e):
        # with the CG step count this block appended, if any
        blocks.append((e, steps[-1] if len(steps) > seen[0] else None))
        seen[0] = len(steps)

    out = _iteration_core(prob, geom, dist, albedo, grad_stored, poses, images, K,
                          lights, **kw, steps_out=steps, block_done=done, ops=ops,
                          stencil=stencil, info_out=info)
    status = info[-1] if info else None
    readout = graph.pack([b[0] for b in blocks], [b[1] for b in blocks], status)
    return out[:5], readout, None if status is None else torch.all(status == 0)


def _fused_step(ref, runner, kw):
    """ONE fused iteration of the refiner `ref` and its ONE read of the
    device: a replay of `runner` (a refine/graph.IterationGraph) or, with
    none, iteration_readout run eagerly -> (each block's four energies, each
    block's CG steps or None), host numbers.  A singular pose block raises
    torch.linalg.LinAlgError after the read, and the state stays as it was
    (on the card the graph commits nothing; eagerly nothing is set)."""
    new = None
    if runner is not None:
        ref._set_state(runner.load(ref._state()))
        values = runner.replay()
    else:
        new, readout, _ = iteration_readout(*ref._args(), **kw, ops=ref.ops,
                                            stencil=ref.stencil)
        values = readout.tolist()
    energies, steps, info = graph.unpack(values, len(block_names(
        kw["do_light"], kw["do_albedo"], kw["do_distance"], kw["do_pose"], kw["joint_dp"])))
    solvers.check_pose_info(info)
    if new is not None:
        ref._set_state(new)
    return energies, steps


def albedo_sums(prob, geom, dist, grad_stored, poses, images, K):
    """(sum of observed intensities [N,3], count of observations [N]) over
    the visible keyframes."""
    H, W = images.shape[1], images.shape[2]
    pts_w = render.surface_points_world(prob, geom, dist, grad_stored)
    _, uv, in_img = render.project_to_frames(pts_w, poses, K, (H, W))
    I = render.sample_intensity(images, uv)
    m = (prob.vis & in_img & prob.valid[:, None]).to(I.dtype)
    return torch.einsum("nfc,nf->nc", I, m), torch.sum(m, dim=1)


def albedo_mean(s, cnt):
    mean = s / torch.clamp(cnt[:, None], min=1.0)
    return torch.where((cnt > 0)[:, None], mean, 0.0)


def _init_albedo(prob, geom, dist, grad_stored, poses, images, K, voxel_size):
    """Mean observed intensity over visible keyframes (Optimizer.cpp:50-81)."""
    return albedo_mean(*albedo_sums(prob, geom, dist, grad_stored, poses, images, K))


def led_light_sums(prob, geom, rd, dist, albedo, grad_stored, poses, lights,
                   voxel_size):
    """(observed [3], rendered [3]) intensity sums over the visible pairs at
    the residual pass `rd`, made with `lights`."""
    rendered = render.rendered_intensity_led(
        prob, geom, dist, albedo, grad_stored, lights, poses, voxel_size)
    m = rd.mask[..., None]
    # rd.r = I - rendered  =>  I = r + rendered
    obs = torch.sum(torch.where(m, rd.r + rendered, 0.0), dim=(0, 1))
    ren = torch.sum(torch.where(m, rendered, 0.0), dim=(0, 1))
    return obs, ren


class RefineOps(NamedTuple):
    """The functions the refiner's loop is made of.  SINGLE holds the
    single-device ones above; parallel/refine.OPS the mesh's, with the same
    signatures over sharded problems, states and residual passes."""
    residuals: Callable
    energies: Callable
    run_block: Callable
    init_albedo: Callable
    led_light_sums: Callable


SINGLE = RefineOps(render.compute_residuals, _energy_from_rd, _run_block,
                   _init_albedo, led_light_sums)


# ------------------------------------------------------------------ refiner

class PhotometricRefiner:
    """Joint light/albedo/distance/pose refinement over keyframes.

    Owns the dense volume + the compacted problem; sync_to_volume() writes
    the refined values into the volume for export.  Runs on the device of the
    volume it is given; a refiner made without a volume, to be filled by
    io/checkpoint.load_refine_state, runs on `device` ("cuda" unless the
    caller asks for another).
    """

    def __init__(
        self,
        vol: GradSdfVolume,
        geom: GridGeometry,
        cfg: OptimizerConfig,
        K: np.ndarray,
        save_path: str = "",
        truncation: float = None,
        metrics: Optional[MetricsLogger] = None,
        laplacian_diag_only: bool = False,
        mesh=None,
        device=None,
        capture: bool = True,
    ):
        self.mesh = mesh
        if mesh is not None:
            from psgradientsdf_tpu_torch.parallel import refine as mesh_refine

            self.ops = mesh_refine.OPS
            if vol is None and device is None:
                device = mesh.first_device
        else:
            self.ops = SINGLE
        self.vol = vol
        self.geom = geom
        self.cfg = cfg
        if vol is None:
            self.device = resolve_device(device)
        else:
            self.device = vol.dist.device
            if device is not None and torch.device(device) != self.device:
                raise ValueError(f"device {device} but the volume is on "
                                 f"{self.device}")
        if mesh is not None and mesh.first_device != self.device:
            raise ValueError(f"the refinement runs on {self.device} but the "
                             f"mesh's first device is {mesh.first_device}")
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32).to(self.device)
        self.save_path = save_path
        # in a process group only process 0 writes files; every process
        # joins the gathers that come before a write
        self.writes = distributed.rank() == 0
        self._dump_writer: Optional[Writer] = None   # the periodic dump's thread
        self._dump_tag = ""
        self.truncation = truncation
        self.metrics = metrics or MetricsLogger(None, echo=True)
        self.laplacian_diag_only = laplacian_diag_only
        # True: each iteration walks _iteration_core; False: the per-block
        # path, which reuses the residual pass it holds.  Same arithmetic.
        self.fused_iterations = bool(getattr(cfg, "fused_iterations", True))
        # on one card the fused loop replays one CUDA graph an iteration
        # (refine/graph.py); False runs it eagerly (the checks' loop)
        self.capture = bool(capture)
        self._graph: Optional[graph.IterationGraph] = None
        self.graph_captures: int = 0         # graphs captured by this refiner
        self.images = None
        self.poses = None
        self.keyframe_indices: List[int] = []
        self.timestamps: List[str] = []
        self.prob: Optional[RefineProblem] = None
        # the problem's reverse stencil table (ops/distcg.py), rebuilt with
        # every problem on one device (None on a mesh)
        self.stencil: Optional[distcg.StencilReverse] = None
        self.lights = None
        self.dist = None
        self.albedo = None
        self.grad_stored = None
        # the loop's scalar state at the last iteration boundary, for an
        # exact mid-run checkpoint and resume (None outside the loop and
        # after it ends); restored by io/checkpoint.load_refine_state
        self.loop_state: Optional[dict] = None
        # write a resumable checkpoint every N iterations; needs BOTH set
        self.checkpoint_every: int = 0
        self.checkpoint_path: str = ""
        self.energy_trace: List[dict] = []    # one record per energy evaluation
        self.stop_reason: str = ""
        self.iterations_run: int = 0

    # ------------------------------------------------------------ setup

    def set_keyframes(
        self,
        images,                      # [F,H,W,3] RGB, float or uint8, numpy or tensor
        poses,                       # [F,4,4]
        keyframe_indices: Sequence[int],
        timestamps: Sequence[str] = (),
    ) -> None:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        # raw-wire keyframes are converted on the device.  On a mesh the
        # images stay where they are until place_on_mesh copies each
        # keyframe chunk to this process's blocks and converts it there
        self.images = (images if self.mesh is not None
                       else rgb_float(images.to(self.device)))
        self.poses = torch.as_tensor(
            np.asarray(poses, dtype=np.float32)).to(self.device)
        self.keyframe_indices = list(keyframe_indices)
        self.timestamps = list(timestamps) or [str(i) for i in keyframe_indices]

    def init(self) -> None:
        """select_vis + surface extraction + light init
        (PsOptimizer.cpp:25-42 / LedOptimizer.cpp:25-36)."""
        t0 = time.perf_counter()
        self.prob = extract_problem(self.vol, self.geom, self.keyframe_indices)
        t_extract = time.perf_counter() - t0
        self.dist = self.prob.dist
        self.albedo = self.prob.albedo
        self.grad_stored = self.prob.grad_stored
        self.metrics.log("refine_init", surface_voxels=self.prob.n_surface,
                         capacity=int(self.prob.valid.shape[0]),
                         keyframes=len(self.keyframe_indices),
                         extract_seconds=t_extract)
        self.place_on_mesh()
        self.rebuild_stencil()

        if self.cfg.model == LED:
            self.lights = torch.ones(3, dtype=torch.float32, device=self.device)
            self._init_led_light()
        else:
            s = torch.tensor([0.0, 0.0, -1.0], device=self.device)
            dirs = self.poses[:, :3, :3] @ s
            basis = sh_mod.sh_basis(dirs, self.cfg.order)     # [F,B]
            basis[:, 0] = 0.02
            self.lights = basis

    def place_on_mesh(self) -> None:
        """Place the problem, the state and the keyframe images on the mesh
        (no-op without one, or before init): N split over "z", keyframes over
        "frames" (parallel/shard.shard_refine_arrays); poses, lights and K
        stay on the first device.  Called after every extraction and after a
        checkpoint is loaded, as in the JAX package."""
        from psgradientsdf_tpu_torch.parallel import shard

        if self.mesh is None or self.prob is None or self._sharded():
            return
        images = self.images
        if isinstance(images, shard.ShardedImages):
            images = shard.gather_images(images, self.device)
        self.prob, self.images = shard.shard_refine_arrays(
            self.mesh, self.prob, images)
        for name in ("dist", "albedo", "grad_stored"):
            setattr(self, name, shard.shard_rows(getattr(self, name),
                                                 self.prob.layout))

    def rebuild_stencil(self) -> None:
        """The reverse stencil table of the refiner's problem, for the
        distance and albedo blocks on one device: called wherever the
        problem is set (init, the upsample,
        io/checkpoint.load_refine_state)."""
        self.stencil = (None if self.mesh is not None or self.prob is None
                        else distcg.stencil_reverse(self.prob))

    def _sharded(self) -> bool:
        return not isinstance(self.prob, (RefineProblem, type(None)))

    def gathered(self, with_problem: bool = True, with_images: bool = True):
        """(prob, dist, albedo, grad_stored, images), each whole on the
        refiner's device: gathered from the mesh when placed on one (a field
        not asked for is None)."""
        if not self._sharded():
            return (self.prob, self.dist, self.albedo, self.grad_stored,
                    self.images)
        from psgradientsdf_tpu_torch.parallel import shard

        dev = self.device
        return (shard.gather_problem(self.prob, dev) if with_problem else None,
                *(shard.gather_rows(getattr(self, n), dev)
                  for n in ("dist", "albedo", "grad_stored")),
                shard.gather_images(self.images, dev) if with_images else None)

    def _init_led_light(self) -> None:
        """Intensity-ratio light init (LedOptimizer.cpp:76-112)."""
        rd = self._rd()
        obs, ren = self.ops.led_light_sums(
            self.prob, self.geom, rd, self.dist, self.albedo, self.grad_stored,
            self.poses, self.lights, self.geom.voxel_size)
        self.lights = obs / torch.where(ren.abs() > 1e-12, ren, 1e-12)

    def init_albedo(self) -> None:
        self.albedo = self.ops.init_albedo(
            self.prob, self.geom, self.dist, self.grad_stored, self.poses,
            self.images, self.K, self.geom.voxel_size,
        )

    # ------------------------------------------------------------ internals

    def _static_kwargs(self):
        return dict(
            model=self.cfg.model,
            order=self.cfg.order,
            loss=self.cfg.loss,
            lam=float(self.cfg.lam),
            voxel_size=self.geom.voxel_size,
        )

    def _args(self):
        return (
            self.prob, self.geom, self.dist, self.albedo, self.grad_stored,
            self.poses, self.images, self.K, self.lights,
        )

    def _state(self):
        return (self.dist, self.albedo, self.grad_stored, self.poses, self.lights)

    def _set_state(self, state) -> None:
        (self.dist, self.albedo, self.grad_stored, self.poses,
         self.lights) = state

    def _rd(self):
        return self.ops.residuals(*self._args(), **self._static_kwargs())

    def _energy_kwargs(self):
        skw = self._static_kwargs()
        return dict(loss=skw["loss"], lam=skw["lam"],
                    voxel_size=skw["voxel_size"])

    def _energies_rd(self):
        """(rd, (E, E_n, E_l, E_r)) at the current state — the rd doubles
        as the next block's linearization point (see _energy_from_rd)."""
        rd = self._rd()
        e = self.ops.energies(self.prob, rd, self.dist, self.albedo,
                              **self._energy_kwargs())
        return rd, tuple(e.tolist())

    def energies(self):
        return self._energies_rd()[1]

    def _total_energy(self, E, E_n, E_l, E_r, w_n, w_l, w_rho, **tags) -> float:
        total = E + w_n * E_n + w_l * E_l + w_rho * E_r
        rec = dict(ps=E, normal_reg=w_n * E_n, laplacian_reg=w_l * E_l,
                   rho_reg=w_rho * E_r, total=total)
        self.energy_trace.append(dict(rec, **tags))
        self.metrics.log("energy", **rec)
        return total

    # ------------------------------------------------------------ main loop

    def alternating_optimize(
        self, light: bool, albedo: bool, distance: bool, pose: bool
    ) -> bool:
        try:
            return self._optimize(light, albedo, distance, pose)
        finally:
            # a failure between a periodic dump and the terminal one must not
            # leave the dump thread running; what it raised is logged
            self._join_dump()
            self._release_graph()

    def loop_kind(self):
        """("graph" or "eager", why): the loop this refiner runs.  The
        graph needs the fused iteration on one card; the mesh's loop and
        the joint block keep the eager one."""
        if not self.fused_iterations:
            return "eager", "fused_iterations is off: the per-block loop"
        if self.device.type != "cuda":
            return "eager", f"the state is on {self.device}: no graph off the card"
        if self.mesh is not None:
            return "eager", "a device mesh runs the eager loop"
        if self.cfg.joint_dp:
            return "eager", "the joint block runs the eager loop"
        if not self.capture:
            return "eager", "capture=False"
        return "graph", "one CUDA graph replayed an iteration"

    def _graph_for(self, kw) -> graph.IterationGraph:
        """The graph of the fused iteration under `kw` on the current
        problem: the one held if it was captured for the same problem and
        static arguments, else a new warm-up and capture (the old graph and
        its memory pool released first)."""
        key = (id(self.prob), id(self.images), id(self.K), id(self.stencil),
               tuple(sorted(kw.items())))
        if self._graph is not None and self._graph.key == key:
            return self._graph
        self._release_graph()
        prob, geom, images, K, stencil = (self.prob, self.geom, self.images,
                                          self.K, self.stencil)

        def step(state):
            dist, albedo, grad_stored, poses, lights = state
            return iteration_readout(prob, geom, dist, albedo, grad_stored, poses,
                                     images, K, lights, **kw, ops=SINGLE,
                                     stencil=stencil)

        t0 = time.perf_counter()
        self._graph = graph.IterationGraph(step, self._state(), key)
        self._set_state(self._graph.state)
        self.graph_captures += 1
        self.metrics.log("refine_graph", captures=self.graph_captures,
                         surface_voxels=self.prob.n_surface,
                         seconds=time.perf_counter() - t0,
                         warmup_seconds=self._graph.warmup_seconds)
        return self._graph

    def _release_graph(self) -> None:
        if self._graph is not None:
            self._graph.release()
            self._graph = None

    def _optimize(self, light, albedo, distance, pose) -> bool:
        cfg = self.cfg
        if self.loop_state:
            # exact resume from a checkpoint: the albedo init and the weight
            # normalisation are part of the restored state, so both are
            # skipped and the loop goes on at the restored iteration
            ls = self.loop_state
            E_vec = [float(v) for v in ls["E_vec"]]
            self.energy_trace = [dict(r) for r in ls.get("energy_trace", [])]
            self.metrics.log("refine_resume", iter=int(ls["it"]))
            return self._alternating_loop(
                light, albedo, distance, pose, cfg.damping, ls["E"], ls["E_n"],
                ls["E_l"], ls["E_r"], E_vec[-1], ls["w_n"], ls["w_l"],
                ls["w_rho"], ls["normal_reg"], ls["albedo_reg"],
                ls["laplacian_reg"], rd=None, it=int(ls["it"]), E_vec=E_vec)
        w_n, w_l, w_rho = (cfg.reg_weight_n, cfg.reg_weight_l,
                           cfg.reg_weight_rho)
        normal_reg = w_n != 0.0
        albedo_reg = w_rho != 0.0
        laplacian_reg = w_l != 0.0

        self.init_albedo()

        rd0, (E, E_n, E_l, E_r) = self._energies_rd()
        if normal_reg and E_n > 0:
            w_n *= E / E_n                     # weight normalization
        if laplacian_reg:
            if E_l > 0:
                w_l *= E / E_l
            if cfg.upsample:
                laplacian_reg = False
        self.energy_trace = []
        E_total = self._total_energy(E, E_n, E_l, E_r, w_n, w_l, w_rho,
                                     iter=-1, block="init")
        return self._alternating_loop(
            light, albedo, distance, pose, cfg.damping, E, E_n, E_l, E_r,
            E_total, w_n, w_l, w_rho, normal_reg, albedo_reg, laplacian_reg,
            rd=rd0)

    def _alternating_loop(self, light, albedo, distance, pose, damping,
                          E, E_n, E_l, E_r, E_total, w_n, w_l, w_rho,
                          normal_reg, albedo_reg, laplacian_reg, rd, it=0,
                          E_vec=None) -> bool:
        # Per block: the update from the residual pass at hand, then the
        # residual pass at the updated state — consumed twice, as the energy
        # input AND as the next block's linearization point.  Same
        # block/energy semantics as the reference (PsOptimizer.cpp:263-350).
        cfg = self.cfg
        skw = self._static_kwargs()
        ekw = self._energy_kwargs()
        T = Timer(verbose=False)
        names = block_names(light, albedo, distance, pose, cfg.joint_dp)
        E_vec = [E_total] if E_vec is None else E_vec
        self.iterations_run = it

        def refresh():
            rd = self._rd()
            return rd, self.ops.energies(self.prob, rd, self.dist, self.albedo,
                                         **ekw)

        def weights():
            return dict(
                reg_weight_n=w_n if normal_reg else 0.0,
                reg_weight_l=w_l if laplacian_reg else 0.0,
                reg_weight_rho=w_rho, damping=damping,
                laplacian_diag_only=self.laplacian_diag_only)

        def book(name, e, steps, dt):
            """Energy bookkeeping after a block, from its energies `e` and
            CG steps read off the device.  The reference refreshes each
            reg energy ONLY while its regularizer is active
            (PsOptimizer.cpp:311,338-339): with upsample the pre-iter-5
            Laplacian term is a frozen constant in the total — refreshing it
            would wiggle the convergence metric and fire spurious divergence
            aborts."""
            nonlocal E, E_n, E_l, E_r, E_total
            E = e[0]
            if name == "albedo" and albedo_reg:
                E_r = e[3]
            if name in ("distance", "joint_dp"):
                if normal_reg:
                    E_n = e[1]
                if laplacian_reg:
                    E_l = e[2]
            E_total = self._total_energy(E, E_n, E_l, E_r, w_n, w_l, w_rho,
                                         iter=it, block=name)
            rec = dict(iter=it, block=name, seconds=dt)
            if name in _CG_BLOCKS and steps is not None:
                rec["cg_steps"] = steps
            self.metrics.log("block", **rec)

        loop, why = self.loop_kind()
        self.metrics.log("refine_loop", loop=loop, reason=why)
        while it < cfg.max_it:
            if self.fused_iterations:
                kw = dict(skw, **weights(), do_light=light, do_albedo=albedo,
                          do_distance=distance, do_pose=pose, joint_dp=cfg.joint_dp)
                # a new problem or new weights are captured before the timer
                runner = self._graph_for(kw) if loop == "graph" else None
                T.tic()
                energies, steps = _fused_step(self, runner, kw)   # ONE read
                dt = T.toc("iteration")
                # the JAX package's bookkeeping: the iteration's time split
                # evenly over its blocks
                for name, e, s in zip(names, energies, steps):
                    book(name, e, s, dt / max(len(names), 1))
                rd = None   # stale; the per-block path recomputes on demand
            else:
                if rd is None:
                    rd = self._rd()
                dt = 0.0
                for name in names:
                    steps = []
                    T.tic()
                    self._set_state(self.ops.run_block(
                        name, self.prob, self.geom, rd, *self._state()[:4],
                        self.K, self.lights, kw=skw, **weights(),
                        steps_out=steps, stencil=self.stencil))
                    rd, e_dev = refresh()
                    e = e_dev.tolist()      # the block's one read of the device
                    block_dt = T.toc(name)
                    dt += block_dt
                    book(name, e, int(steps[-1]) if steps else None, block_dt)

            self.iterations_run = it + 1
            E_vec.append(E_total)
            rel_diff = abs(E_vec[-2] - E_total) / max(abs(E_vec[-2]), 1e-12)
            self.metrics.log("iteration", iter=it, rel_diff=rel_diff, total=E_total,
                             seconds=dt)

            if rel_diff < cfg.conv_threshold:
                self.metrics.log("converged", iter=it)
                self._stop("converged")
                return True
            if E_vec[-2] < E_total:
                self.metrics.log("diverged", iter=it)
                self._stop("diverged")
                return False

            if it == 5 and cfg.upsample:
                if w_l == 0.0:
                    w_l = 1.0
                laplacian_reg = True
                T.tic()
                self._upsample()
                self.metrics.log("upsample_seconds",
                                 seconds=T.toc("upsample", self.poses))
                self._save_artifacts(f"upsample_after_{it}")
                # the problem arrays changed shape: rd is stale — recompute
                # (this is also the energy eval at the upsampled state)
                rd, e_up = refresh()
                E_l = e_up.tolist()[2]
                if E_l > 0:
                    w_l *= E / E_l
                E_total = self._total_energy(E, E_n, E_l, E_r, w_n, w_l, w_rho,
                                             iter=it, block="upsample")
                E_vec.append(E_total)

            if it > 15 and cfg.upsample:
                w_l = 0.0
                laplacian_reg = False

            it += 1
            # the scalar state at this iteration boundary: a checkpoint taken
            # here resumes exactly, the iteration-indexed upsample and
            # Laplacian branches included
            self.loop_state = {
                "it": it, "w_n": float(w_n), "w_l": float(w_l),
                "w_rho": float(w_rho), "normal_reg": bool(normal_reg),
                "albedo_reg": bool(albedo_reg),
                "laplacian_reg": bool(laplacian_reg),
                "E": float(E), "E_n": float(E_n), "E_l": float(E_l),
                "E_r": float(E_r), "E_vec": [float(v) for v in E_vec],
                "energy_trace": list(self.energy_trace),
            }
            if (self.checkpoint_every and self.checkpoint_path
                    and it % self.checkpoint_every == 0):
                from psgradientsdf_tpu_torch.io import checkpoint as ckpt

                # every process joins the save's gathers; process 0 writes
                T.tic()
                ckpt.save_refine_state(self.checkpoint_path, self)
                seconds = T.toc("refine_checkpoint")
                if self.writes:
                    self.metrics.log(
                        "refine_checkpoint", iter=it, path=self.checkpoint_path,
                        seconds=seconds,
                        bytes=ckpt.checkpoint_bytes(self.checkpoint_path))
            if it % 3 == 0:
                self.save_poses(f"after_poses_opt_{it}")
                self._save_artifacts(f"after_iter_{it}", asynchronous=True)

        # budget exhausted: the reference ends WITHOUT a final save here
        # (PsOptimizer.cpp:425-427 — only the every-3-iteration dumps
        # survive); we save the final state anyway so a capped run always
        # leaves usable artifacts.
        self.metrics.log("budget_exhausted", iter=it)
        self._stop("budget_exhausted")
        return False

    def _stop(self, reason: str) -> None:
        self.stop_reason = reason
        self.loop_state = None
        self._save_artifacts("final_refined")

    # ------------------------------------------------------------ upsample

    def _upsample(self) -> None:
        """Write back, double the grid and re-extract on the refiner's
        device (the mesh's first), then place the new problem on the mesh
        again (the JAX package's optimizer.py:1058)."""
        self.sync_to_volume()
        self.vol, self.geom, self.keyframe_indices = upsample_volume(
            self.vol, self.geom, self.keyframe_indices, self.truncation
        )
        self.prob = extract_problem(self.vol, self.geom, self.keyframe_indices)
        self.dist = self.prob.dist
        self.albedo = self.prob.albedo
        self.grad_stored = self.prob.grad_stored
        self.metrics.log(
            "upsample", voxel_size=self.geom.voxel_size,
            dims=list(self.geom.dims), surface_voxels=self.prob.n_surface,
            capacity=int(self.prob.valid.shape[0]),
        )
        self.place_on_mesh()
        self.rebuild_stencil()

    # ------------------------------------------------------------ exports

    def sync_to_volume(self) -> None:
        prob, dist, albedo, grad, _ = self.gathered(with_images=False)
        self.vol = writeback(self.vol, prob, dist, albedo, grad)

    def _join_dump(self) -> None:
        """Join the dump thread; a failed dump is logged as
        `artifact_dump_error` (a torn periodic dump must not pass for
        written, but it does not stop the refinement: the terminal dump
        writes fresh files)."""
        writer, self._dump_writer = self._dump_writer, None
        if writer is None:
            return
        exc = writer.join()
        if exc is not None:
            self.metrics.log("artifact_dump_error", tag=self._dump_tag,
                             error=repr(exc))
        else:
            self.metrics.log("artifact_dump_written", tag=self._dump_tag,
                             seconds=writer.seconds)

    def _save_artifacts(self, tag: str, asynchronous: bool = False) -> None:
        """Mesh + point cloud dump.  asynchronous=True hands the host work to
        a writer thread (see the module docstring); `artifact_dump` logs the
        seconds the loop itself spent."""
        if not self.save_path:
            return
        t0 = time.perf_counter()
        self._join_dump()
        if self.writes:
            os.makedirs(self.save_path, exist_ok=True)
        if not asynchronous:
            self.extract_mesh(tag)
            self.save_pointcloud(tag)
            if self.writes:
                self.metrics.log("artifact_dump", tag=tag,
                                 seconds=time.perf_counter() - t0)
            return
        self.sync_to_volume()
        pts, ghat, albedo = self._surface_points_dev()
        if not self.writes:
            return
        staged = HostCopies(dict(
            dist=self.vol.dist, weight=self.vol.weight, color=self.vol.color,
            pts=pts, ghat=ghat, albedo=albedo))
        geom, path = self.geom, self.save_path

        def work():
            a = staged.arrays()
            mesh = extract_mesh_from_volume(
                a["dist"], a["weight"], a["color"], geom.voxel_size, geom.origin)
            ply.write_mesh_ply(os.path.join(path, f"{tag}_mesh.ply"),
                               mesh.vertices, mesh.faces, mesh.colors)
            ply.write_pointcloud_ply(os.path.join(path, f"{tag}_pointcloud.ply"),
                                     a["pts"], a["ghat"], a["albedo"])

        self._dump_tag = tag
        self._dump_writer = Writer(work, name=f"dump-{tag}")
        self.metrics.log("artifact_dump", tag=tag, asynchronous=True,
                         seconds=time.perf_counter() - t0)

    def extract_mesh(self, tag: str) -> bool:
        self.sync_to_volume()
        if not self.writes:
            return False
        mesh = extract_mesh_from_volume(
            self.vol.dist.cpu().numpy(), self.vol.weight.cpu().numpy(),
            self.vol.color.cpu().numpy(), self.geom.voxel_size, self.geom.origin,
        )
        return ply.write_mesh_ply(
            os.path.join(self.save_path, f"{tag}_mesh.ply"),
            mesh.vertices, mesh.faces, mesh.colors,
        )

    def _surface_points_dev(self):
        """(points x = c_v - d ghat [n,3], normals ghat [n,3], albedo [n,3])
        of the true surface voxels, on the device (OptimizerAux.cpp:456-511)."""
        prob, dist, albedo, grad, _ = self.gathered(with_images=False)
        n = prob.n_surface
        ghat = geometry.normalize(grad)[:n]
        c_v = self.geom.voxel2world(prob.idx_xyz[:n])
        pts = c_v - dist[:n, None] * ghat
        return pts, ghat, albedo[:n]

    def surface_points(self):
        """_surface_points_dev as numpy."""
        return tuple(t.cpu().numpy() for t in self._surface_points_dev())

    def save_pointcloud(self, tag: str) -> bool:
        pts, ghat, cols = self.surface_points()
        if not self.writes:
            return False
        return ply.write_pointcloud_ply(
            os.path.join(self.save_path, f"{tag}_pointcloud.ply"), pts, ghat, cols
        )

    def save_poses(self, tag: str) -> bool:
        if not self.save_path or not self.writes:
            return False
        os.makedirs(self.save_path, exist_ok=True)
        return trajectory.write_trajectory(
            os.path.join(self.save_path, f"{tag}.txt"),
            self.timestamps,
            list(self.poses.cpu().numpy()),
        )

    def save_sdf(self, tag: str) -> bool:
        self.sync_to_volume()
        if not self.writes:
            return False
        dist = self.vol.dist.cpu().numpy()
        band = np.abs(dist) <= np.sqrt(3.0) * self.geom.voxel_size
        if not band.any():
            return False
        zz, yy, xx = np.nonzero(band)
        sl = (
            slice(zz.min(), zz.max() + 1),
            slice(yy.min(), yy.max() + 1),
            slice(xx.min(), xx.max() + 1),
        )
        bottom = (
            xx.min() * self.geom.voxel_size,
            yy.min() * self.geom.voxel_size,
            zz.min() * self.geom.voxel_size,
        )
        return sdf_io.write_sdf(
            os.path.join(self.save_path, tag), dist[sl], bottom, self.geom.voxel_size
        )
