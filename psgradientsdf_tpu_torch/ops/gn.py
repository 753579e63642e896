"""The camera tracker's Gauss-Newton solve: a frame's whole GN loop in ONE
launch of the hand-written Hopper kernel in csrc/gn.cu, or its plain
PyTorch version for CPU tensors; and the masked Gram of frozen records in
one launch.

  gn_solve(frame, carry, num_iterations=, regather_every=, early_exit=, ...)
                                                the solve, IN PLACE on carry
  gram(frame, pose, records) -> S [8,8]         the Gram alone (gram_plan)

A GnFrame holds one frame's tracking inputs: the (strided) depth map, the
intrinsics, the depth range and, for gn_solve, the volume's record fields
(the dist, grad and weight of a GradSdfVolume, or the slots 0, 1:4 and 4 of
a PackedVolume's payload, read in place).  The carry is one float32 device
buffer of CARRY_SIZE (new_carry / unpack_carry): the pose, the converged,
failed and stalled flags, the mean energy, the pixel count, the iteration
count, and the 8x8 Gram S of the last step that was still active.  The
host reads nothing of it during the solve.

gn_solve replaces the JAX package's tracking program
(psgradientsdf_tpu/tracking/tracker.py run_gn_rounds :76-207: gn_step
:112-157 over gather_records :274-284 and masked_gram :286-301,
core/volume.py sdf_records_packed :1007, inside the while_loop :183 or the
fori_loop :197).  Each round gathers each pixel's nearest-voxel record in
its fresh step and keeps it (d, ghat, c_v, ok) for the regather_every - 1
frozen steps that follow.  A single step is gn_solve(num_iterations=1).
gram() is the pass without the solve, for trackers that keep their own
(parallel/shard.py, core/resident.py).

The plain versions are the tracker's eager PyTorch ops (camera_points,
frame_records, gram_plain, gn_update): gn_solve_plain runs the round loop
over gn_step_plain and reads the done flag back as the JAX while_loop
tests it (tracking/tracker.run_gn_rounds, the loop of the mesh and
resident trackers, gives the same bits over the same plain records and
Gram).  On the card the kernel's sums and its 6x6 solve run in another order than the
plain matrix products, so S agrees to float32 rounding (chip_smoke.py holds
it within 1e-5 of max|S|).  gram's launch follows gram_plan(n, SMs): about
one block an SM in clusters of GRAM_CLUSTER, a contiguous tile of pixels a
block; the blocks' sums are added in each cluster, then the clusters' by
the last cluster, in one fixed order (two runs give the same bits).

A wrapper takes the plain version ONLY for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises (a refused cooperative launch
too: nothing falls back to steps).  `launch_counts` counts kernel launches
and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from psgradientsdf_tpu_torch import device_constant
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.core.volume import (
    PackedVolume,
    pack_tracking_payload,
    sdf_records_packed,
)
from psgradientsdf_tpu_torch.utils import se3

_LIB_NAME = "gn"
launch_counts: Dict[str, int] = {"gn_solve": 0, "gn_gram": 0}

# the carry buffer: pose [0:16] row-major, then these slots, then S [24:88]
CONV, FAIL, STALLED, E_MEAN, COUNT, ITERS, S0 = 16, 17, 18, 19, 20, 21, 24
CARRY_SIZE = S0 + 64

# gram's launch (csrc/gn.cu kGram*): threads a block, pixels a thread reads
# together, blocks a cluster
GRAM_THREADS = 256
GRAM_PIX = 4
GRAM_CLUSTER = 8


class GramPlan(NamedTuple):
    """gram's launch for n pixels."""
    cluster: int           # blocks a cluster
    clusters: int          # the rows of the partials buffer (36 floats each)
    blocks: int            # clusters x cluster
    tile: int              # pixels a block (the last blocks' fewer, or none)


@functools.lru_cache(maxsize=None)
def gram_plan(n: int, sms: int) -> GramPlan:
    """gram's launch for n pixels on a card of `sms` SMs, a function of the
    two alone: sms // GRAM_CLUSTER clusters (at most one block an SM; 16 on
    an H100), fewer where n gives a cluster's threads fewer than GRAM_PIX
    pixels each, at least one; a contiguous tile of ceil(n / blocks) pixels
    a block."""
    if n < 1 or sms < 1:
        raise ValueError(f"gram: no plan for {n} pixels on {sms} SMs")
    per_cluster = GRAM_CLUSTER * GRAM_THREADS * GRAM_PIX
    clusters = max(1, min(sms // GRAM_CLUSTER, -(-n // per_cluster)))
    blocks = clusters * GRAM_CLUSTER
    return GramPlan(GRAM_CLUSTER, clusters, blocks, -(-n // blocks))


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# the frame, the carry and the records
# ---------------------------------------------------------------------------


class GnFrame:
    """One frame's tracking inputs on one device.

    depth: [h,w] (a strided view is read in place: depth[::s, ::s]);
    stride: the factor that gives a pixel's coordinates in the full image;
    vol: a GradSdfVolume or a PackedVolume (gn_solve), or None (gram)."""

    def __init__(self, geom: Optional[GridGeometry], depth: torch.Tensor,
                 K: torch.Tensor, *, stride: int, zmin: float, zmax: float,
                 vol=None):
        self.geom, self.depth, self.K = geom, depth, K.contiguous()
        self.stride, self.zmin, self.zmax = stride, zmin, zmax
        self.vol = vol
        self.n = depth.shape[0] * depth.shape[1]
        self._points = None
        self._payload = None
        self._scratch = None
        self._records = None

    @property
    def device(self) -> torch.device:
        return self.depth.device

    def points(self):
        """(pts_cam [N,3], valid_z [N]): camera_points, made once."""
        if self._points is None:
            self._points = camera_points(self.depth, self.K, self.stride,
                                         self.zmin, self.zmax)
        return self._points

    def payload(self) -> torch.Tensor:
        """The [V,8] record table of the plain version: a PackedVolume's own
        payload, or the one pack_tracking_payload builds (once a frame)."""
        if self._payload is None:
            if isinstance(self.vol, PackedVolume):
                self._payload = self.vol.payload.view(-1, 8)
            else:
                self._payload = pack_tracking_payload(self.vol)
        return self._payload

    def fields(self):
        """(dist [V], grad [V,3], weight [V]) of the volume, views in place."""
        if isinstance(self.vol, PackedVolume):
            p = self.vol.payload.view(-1, 8)
            return p[:, 0], p[:, 1:4], p[:, 4]
        v = self.vol
        return v.dist.view(-1), v.grad.view(-1, 3), v.weight.view(-1)

    def records(self) -> torch.Tensor:
        """gn_solve's [N,8] record buffer in device memory, for a frame whose
        records do not fit on chip (made once a frame)."""
        if self._records is None:
            self._records = torch.empty((self.n, 8), dtype=torch.float32,
                                        device=self.device)
        return self._records

    def scratch(self, rows: int):
        """The kernels' partial sums (`rows` of 36) and gn_gram's ticket
        (zero between launches: its last cluster resets it)."""
        if self._scratch is None or self._scratch[0].numel() < rows * 36:
            self._scratch = (
                torch.empty((rows * 36,), dtype=torch.float32, device=self.device),
                torch.zeros((1,), dtype=torch.int32, device=self.device))
        return self._scratch


def new_carry(init_pose: torch.Tensor) -> torch.Tensor:
    """A fresh carry at init_pose: not converged, failed or stalled, no
    iteration yet."""
    carry = torch.zeros((CARRY_SIZE,), dtype=torch.float32, device=init_pose.device)
    carry[:16] = init_pose.reshape(16)
    return carry


def unpack_carry(carry: torch.Tensor):
    """(pose [4,4], converged, failed, stalled, E_mean, count int32,
    iterations int32, S [8,8]) — new tensors, read from the buffer on its
    device."""
    c = carry.clone()
    return (c[:16].view(4, 4), c[CONV] != 0, c[FAIL] != 0, c[STALLED] != 0,
            c[E_MEAN], c[COUNT].to(torch.int32), c[ITERS].to(torch.int32),
            c[S0:].view(8, 8))


def pack_carry(carry: torch.Tensor, pose, conv, fail, stalled, E_mean, count,
               iters, S) -> None:
    """Write the carry's values into the buffer (in place)."""
    f32 = torch.float32
    carry.copy_(torch.cat([
        pose.reshape(16),
        torch.stack([conv.to(f32), fail.to(f32), stalled.to(f32),
                     E_mean.to(f32), count.to(f32), iters.to(f32)]),
        carry.new_zeros(S0 - ITERS - 1), S.reshape(64).to(f32)]))


def pack_records(d, ghat, c_v, ok) -> torch.Tensor:
    """Frozen records (d [N], ghat [N,3], c_v [N,3], ok [N]) -> [N,8]."""
    return torch.cat([d[:, None], ghat, c_v, ok.to(d.dtype)[:, None]], dim=-1)


def unpack_records(records: torch.Tensor):
    return records[:, 0], records[:, 1:4], records[:, 4:7], records[:, 7] != 0


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


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


def frame_records(frame: GnFrame, pose: torch.Tensor):
    """The hot gather: per-pixel nearest-voxel records at `pose` ->
    (d, ghat, c_v, ok); ok folds the grid-validity and w > 0 gates
    (RigidPointOptimizer.cpp:47-50) and the depth range."""
    pts_cam, valid_z = frame.points()
    R = pose[:3, :3]
    t = pose[:3, 3]
    p_w = pts_cam @ R.T + t
    d, ghat, c_v, w, valid = sdf_records_packed(frame.payload(), frame.geom, p_w)
    ok = valid & (w > 0.0) & valid_z
    return d, ghat, c_v, ok


def gram_plain(pts_cam: torch.Tensor, pose: torch.Tensor, rec) -> torch.Tensor:
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


def split_gram(S: torch.Tensor):
    """S -> (E, g[6], H[6,6], count)."""
    return S[6, 6], S[:6, 6], S[:6, :6], S[7, 7]


def trust_lever(geom: GridGeometry) -> float:
    """The rotation lever of the frozen-step trust region: valid points lie
    inside the grid, so the grid's bounding sphere bounds a point's arm."""
    return (sum(s * s for s in geom.shift) ** 0.5
            + 0.867 * max(geom.dims) * geom.voxel_size)


def gn_update(carry, E, g, Hm, cnt, *, fresh: bool, num_iterations: int,
              conv_threshold_sq: float, damping: float, lever: float,
              voxel_size: float):
    """The solve and the masked carry update of one GN step, from the Gram's
    pieces; carry = (pose, conv, fail, stalled, E_mean, count, iters).

    Updates are MASKED once converged/failed/out-of-budget (pose frozen at
    the first converged iterate, step not applied — matching the
    reference's return-before-update, RigidPointOptimizer.cpp:66-74).
    `fresh` marks the step right after a correspondence gather: GLOBAL
    convergence may only be declared on fresh steps.  A frozen round solves
    its piecewise-linear subproblem exactly, so a non-fresh ||xi|| ~ 0
    merely says the subproblem is done ("stalled"), and so does a frozen
    step that leaves the trust region (it moves some point by a quarter
    voxel or more): the next round regathers and re-checks."""
    pose, conv, fail, stalled, E_mean, count, iters = carry
    dev = pose.device
    active = (~conv) & (~fail) & (~stalled) & (iters < num_iterations)
    fail_now = cnt < 0.5
    # Gauss-Newton step via Cholesky (cpp:66); relative jitter guards
    # PD-ness on degenerate scenes (the reference's bare llt would
    # silently produce garbage there).
    eye6 = device_constant(tuple(float(i == j) for i in range(6) for j in range(6)),
                           torch.float32, dev).view(6, 6)
    Hj = Hm + (1e-6 * torch.trace(Hm) / 6.0 + 1e-12) * eye6
    chol, _ = torch.linalg.cholesky_ex(Hj)      # no error read-back
    xi = damping * torch.cholesky_solve(g[:, None], chol)[:, 0]
    small = torch.sum(xi * xi) < conv_threshold_sq
    false = torch.zeros((), dtype=torch.bool, device=dev)
    if fresh:
        conv_now = small
        stall_now = false
        trust = ~false
    else:
        disp = (torch.linalg.vector_norm(xi[:3])
                + lever * torch.linalg.vector_norm(xi[3:]))
        trust = disp < 0.25 * voxel_size
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


def gn_step_plain(frame: GnFrame, carry: torch.Tensor,
                  records: Optional[torch.Tensor], *, fresh: bool,
                  num_iterations: int, conv_threshold_sq: float,
                  damping: float, on_gram=None) -> None:
    """One GN step with eager PyTorch ops (frame_records, gram_plain,
    gn_update), in place on the carry and, in a fresh step that is given
    them, the records; a frozen step reads the round's records.
    `on_gram(S)`, when given, sees the step's 8x8 Gram."""
    pose, conv, fail, stalled, E_mean, count, iters, S_old = unpack_carry(carry)
    if fresh:
        stalled = torch.zeros_like(stalled)       # the round-local flag
        rec = frame_records(frame, pose)
        if records is not None:
            records.copy_(pack_records(*rec))
    else:
        rec = unpack_records(records)
    S = gram_plain(frame.points()[0], pose, rec)
    if on_gram is not None:
        on_gram(S)
    new = gn_update(
        (pose, conv, fail, stalled, E_mean, count, iters), *split_gram(S),
        fresh=fresh, num_iterations=num_iterations,
        conv_threshold_sq=conv_threshold_sq, damping=damping,
        lever=trust_lever(frame.geom), voxel_size=frame.geom.voxel_size)
    active = (~conv) & (~fail) & (~stalled) & (iters < num_iterations)
    pack_carry(carry, *new, torch.where(active, S, S_old))


def solve_rounds(num_iterations: int, regather_every: int,
                 early_exit: bool) -> int:
    """The rounds of a solve: up to num_iterations under early_exit (every
    active round consumes at least its fresh iteration, so that many always
    exhaust the budget), else ceil(num_iterations / regather_every)."""
    return num_iterations if early_exit else -(-num_iterations // regather_every)


def gn_solve_plain(frame: GnFrame, carry: torch.Tensor, *, num_iterations: int,
                   conv_threshold_sq: float, damping: float,
                   regather_every: int = 1, early_exit: bool = True,
                   on_gram=None) -> None:
    """gn_solve with eager PyTorch ops: the rounds of gn_step_plain, one
    fresh step and regather_every - 1 frozen ones each; under early_exit
    the done flag is read back before every round, as the JAX while_loop
    tests it.  `on_gram(S)`, when given, sees every step's 8x8 Gram."""
    records = None
    if regather_every > 1:
        records = torch.empty((frame.n, 8), dtype=torch.float32, device=frame.device)
    kw = dict(num_iterations=num_iterations,
              conv_threshold_sq=conv_threshold_sq, damping=damping,
              on_gram=on_gram)
    for _ in range(solve_rounds(num_iterations, regather_every, early_exit)):
        if early_exit:
            conv, fail, iters = carry[[CONV, FAIL, ITERS]].tolist()
            if iters >= num_iterations or conv != 0 or fail != 0:
                break
        for k in range(regather_every):
            gn_step_plain(frame, carry, records, fresh=k == 0, **kw)


# ---------------------------------------------------------------------------
# argument checks and the library binding
# ---------------------------------------------------------------------------


class _GnArgs(ctypes.Structure):
    """csrc/gn.cu GnArgs, field for field (every field 8 bytes)."""
    _p, _i, _d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    _fields_ = [
        ("depth", _p), ("h", _i), ("w", _i), ("depth_rs", _i), ("depth_cs", _i),
        ("coord_stride", _d), ("K", _p), ("zmin", _d), ("zmax", _d),
        ("dist", _p), ("dist_vs", _i), ("grad", _p), ("grad_vs", _i),
        ("weight", _p), ("weight_vs", _i), ("X", _i), ("Y", _i), ("Z", _i),
        ("origin_x", _d), ("origin_y", _d), ("origin_z", _d), ("voxel", _d),
        ("records", _p), ("carry", _p), ("pose", _p), ("gram_out", _p),
        ("partials", _p), ("ticket", _p), ("num_iterations", _i),
        ("regather_every", _i), ("early_exit", _i), ("blocks", _i),
        ("on_chip", _i), ("conv_threshold_sq", _d), ("damping", _d),
        ("lever", _d), ("cluster", _i), ("tile", _i)]


def _check(frame: GnFrame, records: Optional[torch.Tensor], *tensors) -> None:
    dev = frame.device
    if frame.depth.dim() != 2 or frame.depth.dtype != torch.float32:
        raise ValueError(f"gn: depth must be a float32 [h,w], got "
                         f"{frame.depth.dtype} {tuple(frame.depth.shape)}")
    if tuple(frame.K.shape) != (3, 3) or frame.K.dtype != torch.float32:
        raise ValueError("gn: K must be a float32 [3,3]")
    if records is not None and (tuple(records.shape) != (frame.n, 8)
                                or records.dtype != torch.float32
                                or not records.is_contiguous()):
        raise ValueError(f"gn: records must be a contiguous float32 "
                         f"[{frame.n}, 8], got {tuple(records.shape)}")
    for t in (frame.K, records) + tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"gn: a tensor on {t.device}, depth on {dev}")


_bound = None
_plans: Dict[tuple, tuple] = {}


def _bind(lib):
    """The C entry points' argument and result types set on `lib`."""
    for fn in (lib.gn_solve, lib.gn_gram, lib.gn_gram_floor):
        fn.argtypes = [ctypes.POINTER(_GnArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.gn_solve_plan.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.gn_solve_plan.restype = ctypes.c_int
    lib.gn_barriers.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.gn_barriers.restype = ctypes.c_int
    return lib


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        _bound = _bind(load_library(_LIB_NAME))
    return _bound


def solve_plan(dev: torch.device, n: int, regather_every: int):
    """gn_solve's grid for n pixels on `dev`, found once: (blocks, whether
    the tiles' depth and records stay in shared memory)."""
    key = (dev.index, n, regather_every > 1)
    if key not in _plans:
        blocks, on_chip = ctypes.c_int64(), ctypes.c_int64()
        with torch.cuda.device(dev):
            rc = _library().gn_solve_plan(n, regather_every, ctypes.byref(blocks),
                                          ctypes.byref(on_chip))
        if rc != 0:
            raise RuntimeError(f"gn_solve: no cooperative grid for {n} pixels "
                               f"on {dev}, CUDA error {rc}")
        _plans[key] = (blocks.value, bool(on_chip.value))
    return _plans[key]


def barrier_floor(frame: GnFrame, regather_every: int, barriers: int) -> None:
    """Launch an empty cooperative kernel on gn_solve's grid for the frame
    that crosses `barriers` grid barriers (the solve's latency floor; not a
    kernel of any path, so not counted)."""
    blocks, _ = solve_plan(frame.device, frame.n, regather_every)
    dev = frame.device
    with torch.cuda.device(dev):
        rc = _library().gn_barriers(blocks, barriers,
                                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gn_barriers: launch failed, CUDA error {rc}")


def _gram_plan_on(dev: torch.device, n: int) -> GramPlan:
    from psgradientsdf_tpu_torch.kernels import sm_count

    return gram_plan(n, sm_count(dev))


def gram_floor(frame: GnFrame, records: torch.Tensor) -> None:
    """Launch an empty kernel of gram's grid and clusters for the frame
    (the Gram's latency floor; not a kernel of any path, so not counted)."""
    plan = _gram_plan_on(frame.device, frame.n)
    _launch("gn_gram_floor", frame, records, plan.clusters, counted=False,
            blocks=plan.blocks, cluster=plan.cluster, tile=plan.tile)


def _launch(name: str, frame: GnFrame, records, partial_rows: int, *,
            counted: bool = True, **fields) -> None:
    lib = _library()
    a = _GnArgs()
    d = frame.depth
    a.depth, a.h, a.w = d.data_ptr(), d.shape[0], d.shape[1]
    a.depth_rs, a.depth_cs = d.stride(0), d.stride(1)
    a.coord_stride, a.K, a.zmin, a.zmax = (
        float(frame.stride), frame.K.data_ptr(), frame.zmin, frame.zmax)
    a.records = None if records is None else records.data_ptr()
    partials, ticket = frame.scratch(partial_rows)
    a.partials, a.ticket = partials.data_ptr(), ticket.data_ptr()
    for k, v in fields.items():
        setattr(a, k, v)
    dev = frame.device
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(ctypes.byref(a),
                                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    if counted:
        launch_counts[name] += 1


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def gn_solve(frame: GnFrame, carry: torch.Tensor, *, num_iterations: int,
             conv_threshold_sq: float, damping: float, regather_every: int = 1,
             early_exit: bool = True) -> None:
    """A frame's whole GN solve IN PLACE on `carry`: one cooperative kernel
    launch on the card, gn_solve_plain on the CPU.  Rounds of one fresh
    step and regather_every - 1 frozen steps on its records; under
    early_exit up to num_iterations rounds, ending once the carry is done,
    else ceil(num_iterations / regather_every)."""
    if tuple(carry.shape) != (CARRY_SIZE,) or carry.dtype != torch.float32:
        raise ValueError(f"gn_solve: carry must be a float32 [{CARRY_SIZE}]")
    if not carry.is_contiguous():
        raise ValueError("gn_solve: carry must be contiguous")
    if regather_every < 1:
        raise ValueError("gn_solve: every round starts with a fresh step "
                         f"(regather_every >= 1, got {regather_every})")
    if num_iterations < 1:
        raise ValueError(f"gn_solve: num_iterations must be >= 1, got {num_iterations}")
    _check(frame, None, carry)
    kw = dict(num_iterations=num_iterations, conv_threshold_sq=conv_threshold_sq,
              damping=damping, regather_every=regather_every,
              early_exit=early_exit)
    if frame.device.type == "cpu":
        return gn_solve_plain(frame, carry, **kw)
    dist, grad, weight = frame.fields()
    g = frame.geom
    if grad.stride(-1) != 1:
        raise ValueError("gn_solve: grad's three components must be adjacent")
    blocks, on_chip = solve_plan(frame.device, frame.n, regather_every)
    records = None
    if regather_every > 1 and not on_chip:
        records = frame.records()
    _launch(
        "gn_solve", frame, records, 2 * blocks, dist=dist.data_ptr(),
        dist_vs=dist.stride(0), grad=grad.data_ptr(), grad_vs=grad.stride(0),
        weight=weight.data_ptr(), weight_vs=weight.stride(0), X=g.dims[0],
        Y=g.dims[1], Z=g.dims[2], origin_x=g.origin[0], origin_y=g.origin[1],
        origin_z=g.origin[2], voxel=g.voxel_size, carry=carry.data_ptr(),
        lever=trust_lever(g), blocks=blocks, on_chip=int(on_chip),
        num_iterations=num_iterations, conv_threshold_sq=conv_threshold_sq,
        damping=damping, regather_every=regather_every,
        early_exit=int(early_exit))


def gram(frame: GnFrame, pose: torch.Tensor, records: torch.Tensor) -> torch.Tensor:
    """The masked 8x8 Gram of frozen records [N,8] at `pose` (one kernel
    launch on the card on gram_plan, gram_plain on the CPU)."""
    _check(frame, records, pose)
    if frame.device.type == "cpu":
        return gram_plain(frame.points()[0], pose, unpack_records(records))
    if records.data_ptr() % 16:
        raise ValueError("gram: records must start on a 16-byte boundary (bulk-copied)")
    pose = pose.to(torch.float32).contiguous()
    out = torch.empty((8, 8), dtype=torch.float32, device=frame.device)
    plan = _gram_plan_on(frame.device, frame.n)
    _launch("gn_gram", frame, records, plan.clusters, pose=pose.data_ptr(),
            gram_out=out.data_ptr(), blocks=plan.blocks, cluster=plan.cluster,
            tile=plan.tile)
    return out
