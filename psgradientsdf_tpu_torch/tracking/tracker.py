"""Rigid camera tracking: per-frame Gauss-Newton on the point-to-SDF objective.

Redesign of RigidPointOptimizer (cpp/include/sdf_tracker/
RigidPointOptimizer.cpp:12-124).  The reference's serial per-pixel loop
becomes one pass over the pixels per GN step:

    per pixel: backproject -> world -> Gradient-SDF query psi, ghat
               J_xi = [ghat; p x ghat]
    reduce:    E = sum psi^2, g = sum psi*J, H = sum J J^T   (one masked
               8x8 Gram product)
    solve:     6x6 Cholesky, the step rules, pose <- exp(-xi) pose

with the reference's early exit (||xi||^2 < conv_threshold^2 checked *after*
the solve, *before* the pose update — RigidPointOptimizer.cpp:66-74).

track_frame runs a frame's whole solve through ops/gn.gn_solve: ONE kernel
launch a frame on the card, which runs every round and step and ends the
loop on the device, the carry (pose, flags, energy, counts) in a small
device buffer that the host does not read; on the CPU the plain round loop
(gn.gn_solve_plain, which run_gn_rounds_plain runs on any device: the
plain version track_frame is held against).  run_gn_rounds is the same
loop over callables in eager PyTorch: the loop of the summed-Gram mesh
tracker and of the resident tracker, whose Gram goes through ops/gn.gram
and whose sums across shards sit outside any one launch.

Early exit in run_gn_rounds: every GN step is masked once the solve has
converged, failed or run out of budget, so extra rounds change nothing.
That loop therefore runs without reading anything back and only POLLS the
done flag every few rounds (one host read each); the results are the ones
an exit right at the flag would give.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from psgradientsdf_tpu_torch import resolve_device
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.core.volume import GradSdfVolume, sdf_query
from psgradientsdf_tpu_torch.ops import gn

# rounds between two polls of the done flag under early_exit
POLL_EVERY = 4

# frames track_frame has solved since the last reset: on the card each is
# one ops/gn.gn_solve launch, so a run can hold the two counts against each
# other
steps_run = {"track_frame": 0}


class TrackResult(NamedTuple):
    pose: torch.Tensor        # [4,4] refined camera-to-world pose
    converged: torch.Tensor   # bool
    iterations: torch.Tensor  # int32 — GN iterations executed
    energy: torch.Tensor      # mean psi^2 at the last evaluated iterate
    num_valid: torch.Tensor   # int32 — pixels contributing to the last solve


def gn_terms(
    vol: GradSdfVolume,
    geom: GridGeometry,
    pts_cam: torch.Tensor,    # [N,3] valid-depth camera-frame points
    valid_z: torch.Tensor,    # [N] bool depth-range mask
    pose: torch.Tensor,       # [4,4]
    truncation: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-pixel residual/Jacobian terms reduced to (E, g[6], H[6,6], count).

    Mirrors the hot loop of RigidPointOptimizer.cpp:38-60.
    """
    R = pose[:3, :3]
    t = pose[:3, 3]
    p_w = pts_cam @ R.T + t
    psi, ghat, w, valid = sdf_query(vol, geom, p_w, truncation)
    m = valid_z & (w > 0.0) & valid
    mf = m.to(psi.dtype)

    J = torch.cat([ghat, torch.linalg.cross(p_w, ghat)], dim=-1)  # [N,6]
    psi_m = psi * mf
    E = torch.sum(psi_m * psi)
    g = J.T @ psi_m
    H = (J * mf[:, None]).T @ J
    count = torch.sum(m)
    return E, g, H, count


def run_gn_rounds(
    geom: GridGeometry,
    gather_records,
    masked_gram,
    init_pose: torch.Tensor,
    *,
    num_iterations: int,
    conv_threshold_sq: float,
    damping: float,
    regather_every: int = 1,
    early_exit: bool = True,
    records_flagged: bool = False,
):
    """The frozen-correspondence GN loop.

    gather_records(pose) -> rec (opaque tuple of frozen correspondences);
    masked_gram(pose, rec) -> (E, g[6], H[6,6], count).

    With records_flagged=True, gather_records returns (rec, flag) and the
    loop ORs the flag of every round it runs into the returned `flag` (the
    resident tracker's exactness bit, core/resident.py): under early_exit
    the rounds after the exit are run masked and their flags left out, as
    the JAX package's while loop never runs them.

    Returns (pose, converged, failed, E_mean, count, iters, flag).  See
    track_frame for the semantics of rounds / freshness / trust region.
    """
    dev = init_pose.device
    consts = dict(num_iterations=num_iterations,
                  conv_threshold_sq=conv_threshold_sq, damping=damping,
                  lever=gn.trust_lever(geom), voxel_size=geom.voxel_size)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    carry = (
        init_pose,
        false,   # converged
        false,   # failed
        false,   # stalled (round-local)
        torch.zeros((), dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
    )
    flag = false

    def run_round():
        """One gather + `regather_every` GN steps (gn.gn_update), then the
        round-local stall flag cleared."""
        nonlocal carry, flag
        if records_flagged:
            rec, rflag = gather_records(carry[0])
            if early_exit:
                rflag = rflag & ((carry[6] < num_iterations) & ~carry[1] & ~carry[2])
            flag = flag | rflag
        else:
            rec = gather_records(carry[0])
        for k in range(regather_every):
            carry = gn.gn_update(carry, *masked_gram(carry[0], rec),
                                 fresh=k == 0, **consts)
        carry = carry[:3] + (false,) + carry[4:]

    def done():
        return bool((carry[6] >= num_iterations) | carry[1] | carry[2])

    drive_rounds(run_round, done, num_iterations=num_iterations,
                 regather_every=regather_every, early_exit=early_exit)
    pose, conv, fail, _, E_mean, count, iters = carry
    return pose, conv, fail, E_mean, count, iters, flag


def drive_rounds(run_round, done, *, num_iterations: int, regather_every: int,
                 early_exit: bool) -> None:
    """The round loop of run_gn_rounds (the plain tracker, the summed-Gram
    mesh tracker and the resident tracker).  early_exit: up to num_iterations
    rounds (every active round consumes at least its fresh iteration, so
    that many always exhaust the budget), `done()` — the one host read —
    polled every POLL_EVERY rounds.  Otherwise fixed-trip: ceil(num/R)
    rounds exhaust the budget when no round stalls (always true at
    conv_threshold_sq=0); with a nonzero threshold a stalled round
    under-consumes budget and the solve finishes early at the stalled
    iterate.  Nothing is read back."""
    rounds = gn.solve_rounds(num_iterations, regather_every, early_exit)
    for r in range(rounds):
        run_round()
        if (early_exit and (r + 1) % POLL_EVERY == 0 and r + 1 < rounds
                and done()):
            break


def track_frame(
    vol,                  # GradSdfVolume or PackedVolume
    geom: GridGeometry,
    depth,                # [H,W]
    K,                    # [3,3]
    init_pose,            # [4,4]
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    num_iterations: int = 50,
    conv_threshold_sq: float = 1e-6,
    damping: float = 1.0,
    stride: int = 1,
    early_exit: bool = True,
    regather_every: int = 1,
    device=None,
) -> TrackResult:
    """Full GN tracking solve for one frame (optimize_sampled, cpp:12-79).

    `early_exit=True` (default) stops at the reference's ||xi||^2 < eps exit
    (RigidPointOptimizer.cpp:68-71), tested on the device before every
    round as the JAX while_loop tests it; `early_exit=False` runs a fixed
    number of masked rounds.  Both give identical results.

    `regather_every=R` (frozen-correspondence GN): the per-pixel voxel
    payload gather runs once per R iterations; the R-1 intermediate
    iterations re-linearize against the *frozen* nearest-voxel records
    (d, ghat, c_v).  Because the reference's psi(p) = d + ghat.(c_v - p) is
    itself piecewise-linear in p with pieces = nearest-voxel cells
    (VolumetricGradSdf.h:76-87), a frozen iteration is EXACT whenever no
    pixel's nearest voxel changes within the round.  R=1 reproduces the
    reference's semantics.

    `vol` is a GradSdfVolume or a PackedVolume; the solve is the same bit
    for bit.  The solve is one ops/gn.gn_solve (one kernel launch on the
    card, which reads either layout's fields in place); the carry stays in
    a device buffer and nothing is read back."""
    frame, init_pose = _frame(vol, geom, depth, K, init_pose, stride=stride,
                              zmin=zmin, zmax=zmax, device=device)
    carry = gn.new_carry(init_pose)
    gn.gn_solve(frame, carry, num_iterations=num_iterations,
                conv_threshold_sq=conv_threshold_sq, damping=damping,
                regather_every=regather_every, early_exit=early_exit)
    steps_run["track_frame"] += 1
    return _result(carry)


def _result(carry) -> TrackResult:
    pose, conv, fail, _, E_mean, count, iters, _ = gn.unpack_carry(carry)
    return TrackResult(pose=pose, converged=conv & (~fail), iterations=iters,
                       energy=E_mean, num_valid=count)


def _frame(vol, geom, depth, K, init_pose, *, stride, zmin, zmax, device):
    """The frame's inputs on the device -> (GnFrame, init_pose)."""
    dev = resolve_device(device)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    init_pose = torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
    # pixel sub-sampling (optimize_sampled's `sampling` knob): a strided
    # view; the original pixel coordinates are reconstructed via `* stride`
    frame = gn.GnFrame(geom, depth[::stride, ::stride], K, stride=stride,
                       zmin=zmin, zmax=zmax, vol=vol)
    return frame, init_pose


def run_gn_rounds_plain(
    vol,
    geom: GridGeometry,
    depth,
    K,
    init_pose,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    num_iterations: int = 50,
    conv_threshold_sq: float = 1e-6,
    damping: float = 1.0,
    stride: int = 1,
    early_exit: bool = True,
    regather_every: int = 1,
    device=None,
    on_gram=None,
) -> TrackResult:
    """track_frame's solve in eager PyTorch on any device: gn.gn_solve_plain
    on a fresh carry, the plain version track_frame's kernel is held
    against.  `on_gram(S)`, when given, sees every step's 8x8 Gram."""
    frame, init_pose = _frame(vol, geom, depth, K, init_pose, stride=stride,
                              zmin=zmin, zmax=zmax, device=device)
    carry = gn.new_carry(init_pose)
    gn.gn_solve_plain(frame, carry, num_iterations=num_iterations,
                      conv_threshold_sq=conv_threshold_sq, damping=damping,
                      regather_every=regather_every, early_exit=early_exit,
                      on_gram=on_gram)
    return _result(carry)


def energy(
    vol: GradSdfVolume,
    geom: GridGeometry,
    depth,
    K,
    pose,
    *,
    truncation: float,
    device=None,
) -> torch.Tensor:
    """0.5 * sum psi^2 over valid pixels at a *given* pose
    (RigidPointOptimizer.cpp:81-124; note it inverts the pose convention)."""
    dev = resolve_device(device)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    Himg, Wimg = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    cols = torch.arange(Wimg, dtype=torch.float32, device=dev)[None, :]
    rows = torch.arange(Himg, dtype=torch.float32, device=dev)[:, None]
    pts_cam = torch.stack(
        [((cols - cx) / fx) * depth, ((rows - cy) / fy) * depth, depth], dim=-1
    ).reshape(-1, 3)
    valid_z = (depth > 0.0).reshape(-1)
    R = pose[:3, :3]
    t = pose[:3, 3]
    p_w = (pts_cam - t) @ R  # R^T (p - t)
    psi, _, w, valid = sdf_query(vol, geom, p_w, truncation)
    m = (valid_z & (w > 0.0) & valid).to(psi.dtype)
    return 0.5 * torch.sum(psi * psi * m)
