"""Rigid camera tracking: per-frame Gauss-Newton on the point-to-SDF objective.

Redesign of RigidPointOptimizer (cpp/include/sdf_tracker/
RigidPointOptimizer.cpp:12-124).  The reference's serial per-pixel loop
becomes dense tensor passes per GN iteration:

    per pixel: backproject -> world -> Gradient-SDF query psi, ghat
               J_xi = [ghat; p x ghat]
    reduce:    E = sum psi^2, g = sum psi*J, H = sum J J^T   (one masked
               8x8 Gram product)

with the reference's early exit (||xi||^2 < conv_threshold^2 checked *after*
the solve, *before* the pose update — RigidPointOptimizer.cpp:66-74).

Early exit in eager PyTorch: every GN step is masked once the solve has
converged, failed or run out of budget, so extra rounds change nothing.  The
loop therefore runs on the device without reading anything back and only
POLLS the done flag every few rounds (one host read each); the results are
the ones an exit right at the flag would give.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from psgradientsdf_tpu_torch import resolve_device
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.core.volume import (
    GradSdfVolume,
    PackedVolume,
    pack_tracking_payload,
    sdf_query,
    sdf_records_packed,
)
from psgradientsdf_tpu_torch.utils import se3

# rounds between two polls of the done flag under early_exit
POLL_EVERY = 4


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
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    # trust region for frozen correspondences: a frozen step is only applied
    # while it moves every point by well under a voxel (displacement bound
    # ||v|| + lever * ||w||); larger steps end the round so the next gather
    # refreshes the correspondences.  Valid points lie inside the grid, so
    # the grid bounding sphere is the rotation lever.
    lever = (
        sum(s * s for s in geom.shift) ** 0.5
        + 0.867 * max(geom.dims) * geom.voxel_size
    )
    false = torch.zeros((), dtype=torch.bool, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)

    # GN step: updates are MASKED once converged/failed/out-of-budget (pose
    # frozen at the first converged iterate, step not applied — matching the
    # reference's return-before-update, RigidPointOptimizer.cpp:66-74).
    #
    # `fresh` marks the iteration right after a correspondence gather.
    # GLOBAL convergence may only be declared on fresh iterations: a frozen
    # round solves its piecewise-linear subproblem exactly, so a non-fresh
    # ||xi|| ~ 0 merely says the *subproblem* is done ("stalled") — the next
    # round regathers and re-checks against fresh correspondences.
    def gn_step(carry, rec, fresh):
        pose, conv, fail, stalled, E_mean, count, iters = carry
        active = (~conv) & (~fail) & (~stalled) & (iters < num_iterations)
        E, g, Hm, cnt = masked_gram(pose, rec)
        fail_now = cnt < 0.5
        # Gauss-Newton step via Cholesky (cpp:66); relative jitter guards
        # PD-ness on degenerate scenes (the reference's bare llt would
        # silently produce garbage there).
        Hj = Hm + (1e-6 * torch.trace(Hm) / 6.0 + 1e-12) * eye6
        chol, _ = torch.linalg.cholesky_ex(Hj)      # no error read-back
        xi = damping * torch.cholesky_solve(g[:, None], chol)[:, 0]
        small = torch.sum(xi * xi) < conv_threshold_sq
        if fresh:
            conv_now = small
            stall_now = false
            trust = true
        else:
            disp = (torch.linalg.vector_norm(xi[:3])
                    + lever * torch.linalg.vector_norm(xi[3:]))
            trust = disp < 0.25 * geom.voxel_size
            conv_now = false
            stall_now = small | ~trust
        # converged -> keep pose (reference returns before applying the step)
        step_ok = active & trust & ~(small | fail_now)
        new_pose = torch.where(step_ok, se3.se3_exp(-xi) @ pose, pose)
        # a stalling frozen iteration performs no reference-visible work:
        # it does not consume GN budget
        counted = active & ~stall_now
        return (
            new_pose,
            torch.where(active, conv_now, conv),
            torch.where(active, fail_now, fail),
            torch.where(active, stall_now, stalled),
            torch.where(counted, E / torch.clamp(cnt, min=1.0), E_mean),
            torch.where(counted, cnt.to(torch.int32), count),
            iters + counted.to(torch.int32),
        )

    def round_body(carry, flag):
        """One gather + `regather_every` frozen GN steps."""
        if records_flagged:
            rec, rflag = gather_records(carry[0])
            if early_exit:
                rflag = rflag & ((carry[6] < num_iterations) & ~carry[1] & ~carry[2])
            flag = flag | rflag
        else:
            rec = gather_records(carry[0])
        carry = gn_step(carry, rec, fresh=True)
        for _ in range(regather_every - 1):
            carry = gn_step(carry, rec, fresh=False)
        # clear the round-local stall flag
        return carry[:3] + (false,) + carry[4:], flag

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
    if early_exit:
        # every active round consumes at least its fresh iteration, so
        # num_iterations rounds always exhaust the budget
        for r in range(num_iterations):
            carry, flag = round_body(carry, flag)
            if (r + 1) % POLL_EVERY == 0 and r + 1 < num_iterations:
                done = (carry[6] >= num_iterations) | carry[1] | carry[2]
                if bool(done):          # the one host read per poll
                    break
    else:
        # fixed-trip: ceil(num/R) rounds exhaust the budget when no round
        # stalls (always true at conv_threshold_sq=0); with a nonzero
        # threshold a stalled round under-consumes budget and the solve
        # finishes early at the stalled iterate.  Nothing is read back.
        n_rounds = -(-num_iterations // regather_every)
        for _ in range(n_rounds):
            carry, flag = round_body(carry, flag)
    pose, conv, fail, _, E_mean, count, iters = carry
    return pose, conv, fail, E_mean, count, iters, flag


def camera_points(depth: torch.Tensor, K: torch.Tensor, stride: int,
                  zmin: float, zmax: float):
    """Back-projected pixels of a (sub-sampled) depth map -> (pts_cam [N,3],
    valid_z [N] depth-range mask); `stride` restores the original pixel
    coordinates of a map sub-sampled by it."""
    dev = depth.device
    H_img, W_img = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    cols = (torch.arange(W_img, dtype=torch.float32, device=dev) * stride)[None, :]
    rows = (torch.arange(H_img, dtype=torch.float32, device=dev) * stride)[:, None]
    x0 = (cols - cx) / fx
    y0 = (rows - cy) / fy
    z = depth
    pts_cam = torch.stack([x0 * z, y0 * z, z], dim=-1).reshape(-1, 3)
    valid_z = ((z > zmin) & (z < zmax)).reshape(-1)
    return pts_cam, valid_z


def gram(pts_cam: torch.Tensor, pose: torch.Tensor, rec) -> torch.Tensor:
    """The masked 8x8 Gram product of frozen records (d, ghat, c_v, ok) at
    `pose`: G rows = mask * [ghat(3), p x ghat(3), psi, 1]; S = G^T G packs
    H = S[:6,:6], g = S[:6,6], E = S[6,6], count = S[7,7]."""
    d, ghat, c_v, ok = rec
    R = pose[:3, :3]
    t = pose[:3, 3]
    p_w = pts_cam @ R.T + t
    psi = d + torch.sum(ghat * (c_v - p_w), dim=-1)
    mf = ok.to(psi.dtype)
    G = torch.cat(
        [ghat, torch.linalg.cross(p_w, ghat), psi[:, None],
         torch.ones_like(psi)[:, None]],
        dim=-1,
    ) * mf[:, None]
    return G.T @ G


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
    (RigidPointOptimizer.cpp:68-71), polled as the module docstring says;
    `early_exit=False` runs a fixed number of masked rounds and reads
    nothing back.  Both give identical results.

    `regather_every=R` (frozen-correspondence GN): the per-pixel voxel
    payload gather runs once per R iterations; the R-1 intermediate
    iterations re-linearize against the *frozen* nearest-voxel records
    (d, ghat, c_v).  Because the reference's psi(p) = d + ghat.(c_v - p) is
    itself piecewise-linear in p with pieces = nearest-voxel cells
    (VolumetricGradSdf.h:76-87), a frozen iteration is EXACT whenever no
    pixel's nearest voxel changes within the round.  R=1 reproduces the
    reference's semantics.

    `vol` is a GradSdfVolume or a PackedVolume; the solve is the same bit
    for bit, but a PackedVolume's payload IS the tracker's [V,8] record
    table, where a GradSdfVolume has one built (pack_tracking_payload)."""
    dev = resolve_device(device)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    init_pose = torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
    if stride > 1:
        # pixel sub-sampling (optimize_sampled's `sampling` knob); the
        # original pixel coordinates are reconstructed via `* stride`
        depth = depth[::stride, ::stride]
    pts_cam, valid_z = camera_points(depth, K, stride, zmin, zmax)

    # one row-gatherable [V,8] (dist, grad, weight) table: a PackedVolume
    # stores its float state in exactly this layout (slots 5:8, its colour,
    # are never read), a GradSdfVolume pays one concatenation per call
    if isinstance(vol, PackedVolume):
        payload = vol.payload.view(-1, 8)
    else:
        payload = pack_tracking_payload(vol)

    def gather_records(pose):
        """The hot gather: per-pixel nearest-voxel records at `pose`.

        Returns (d, ghat, c_v, ok) — everything psi/J need; ok folds the
        grid-validity and w>0 gates (RigidPointOptimizer.cpp:47-50)."""
        R = pose[:3, :3]
        t = pose[:3, 3]
        p_w = pts_cam @ R.T + t
        d, ghat, c_v, w, valid = sdf_records_packed(payload, geom, p_w)
        ok = valid & (w > 0.0) & valid_z
        return d, ghat, c_v, ok

    def masked_gram(pose, rec):
        S = gram(pts_cam, pose, rec)
        return S[6, 6], S[:6, 6], S[:6, :6], S[7, 7]

    pose, conv, fail, E_mean, count, iters, _ = run_gn_rounds(
        geom, gather_records, masked_gram, init_pose,
        num_iterations=num_iterations, conv_threshold_sq=conv_threshold_sq,
        damping=damping, regather_every=regather_every, early_exit=early_exit,
    )
    return TrackResult(
        pose=pose,
        converged=conv & (~fail),
        iterations=iters,
        energy=E_mean,
        num_valid=count,
    )


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
