"""The refinement's pose and light normal equations: per keyframe, the
weighted Gram matrix of a block's Jacobian rows and its gradient, summed over
the surface voxels and their three channels.  One call each of the
hand-written Hopper kernels in csrc/normaleq.cu, or their plain PyTorch
versions for CPU tensors.

  pose_normal_eqs(rd, K, poses, albedo, grad_stored, lights, model)
      -> (H [F,6,6], g [F,6])
  light_normal_eqs_sh(rd, J_l) -> (H [F,B,B], g [F,B])   (B = 4 or 9)
  light_normal_eqs_led(rd, prob, geom, dist, grad_stored, albedo, poses)
      -> (H [3], g [3])

pose_normal_eqs replaces the JAX package's psgradientsdf_tpu/refine/
optimizer.py `_pose_normal_eqs` (:208) and its chunk loop in `_pose_core`
(:222): refine/jacobians.py `image_pi_grad` (:44), `pose_jacobian_sh` (:72)
or `pose_jacobian_led` (:84), and the einsums nfc,nfcb,nfcd->fbd and
nfc,nfcb,nfc->fb.  light_normal_eqs_sh replaces refine/solvers.py
`solve_light_sh`'s (:512) einsums nfc,ncb,ncd->fbd and nfc,ncb,nfc->fb
(:526-527); the eigen-solve after it (solvers.
solve_light_from_normal_eqs) is ops/smallsolve.py's kernel.  light_normal_eqs_led
replaces refine/solvers.py `solve_light_led`'s (:538) two einsums over
refine/jacobians.py `light_jacobian_led` (:161); its damped 3-element solve
(solvers.solve_light_led_from_normal_eqs) stays in PyTorch.  Its kernel
never forms the [N,F,3] Jacobian: a warp takes units of voxels (`led_plan`),
lane v forms voxel v's normalized gradient, surface point and albedo once
and the pairs' lanes take them by shuffles; each pair forms its reflectance
in registers, as the plain chain does, and adds w J J and w J r in double;
a warp's lanes by a butterfly, the warps and the blocks in a fixed order
(the last block by an integer ticket), so two runs give the same bits and
the plain sums (float, torch's order) agree to float32 rounding.

The plain versions are the port's eager chains: pose_normal_eqs_plain forms
the pose Jacobian [n,F,3,6] of N-chunks of at most _POSE_CHUNK voxels and
sums their products (solvers.pose_normal_eqs); the light's is
solvers.light_normal_eqs_sh, one [F,3N] x [3N,B*B] product.  The kernels
stage their inputs into shared memory by bulk copies, form each pair's
Jacobian row in registers and store no [N,F,...] tensor; they sum the
products in a fixed order (a thread's runs of at most LANE_VOXELS voxels in
float, then in double its runs, its tile's lanes, a cluster's tiles and the
clusters; the plan of tiles, stages and clusters made here by
_reduce_plan), so they agree with the plain versions to float32 rounding of
the sums and give the same bits on every run.

A call on the card is ONE launch: the last blocks of the launch, elected by
integer tickets (one buffer a device and stream, left at 0 by each call),
add the tiles' partials.  A wrapper takes the plain version ONLY for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises.  `launch_counts` counts the calls that launched it, and nothing
else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from psgradientsdf_tpu_torch.config import LED
from psgradientsdf_tpu_torch.refine import jacobians, solvers
from psgradientsdf_tpu_torch.refine.render import ResidualData

_LIB_NAME = "normaleq"
launch_counts: Dict[str, int] = {"pose_normal_eqs": 0, "light_normal_eqs_sh": 0,
                                 "light_normal_eqs_led": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# the plain PyTorch versions
# ---------------------------------------------------------------------------

# above this many surface voxels the plain pose normal equations accumulate
# over N-chunks, which bounds the [N,F,3,3] / [N,F,3,6] intermediates of the
# pose Jacobian to the chunk size
_POSE_CHUNK = 32768


def pose_jacobian(G, rd, poses, albedo, grad_stored, lights, model):
    """J_c [N,F,3,6] of the pose block under `model`."""
    if model == LED:
        return jacobians.pose_jacobian_led(G, rd, poses, albedo, grad_stored, lights)
    return jacobians.pose_jacobian_sh(G, rd, poses)


def _pose_chunk(rd_chunk, K, poses, albedo_c, grad_c, lights, model):
    """(H [F,6,6], g [F,6]) partial sums for one N-chunk."""
    G = jacobians.image_pi_grad(rd_chunk, K)
    J_c = pose_jacobian(G, rd_chunk, poses, albedo_c, grad_c, lights, model)
    return solvers.pose_normal_eqs(rd_chunk, J_c)


def pose_normal_eqs_plain(rd, K, poses, albedo, grad_stored, lights, model):
    """(H [F,6,6], g [F,6]) of the pose block with eager ops, summed over
    N-chunks of at most _POSE_CHUNK rows where N is larger."""
    N = rd.r.shape[0]
    # largest power-of-two chunk <= _POSE_CHUNK dividing N (capacities are
    # 2^k or 3*2^(k-1), so a pow2 divisor >= N/3 always exists)
    chunk = _POSE_CHUNK
    while chunk > 1 and N % chunk != 0:
        chunk //= 2
    if N > _POSE_CHUNK and chunk > 1:
        H = g = None
        for lo in range(0, N, chunk):
            sl = slice(lo, lo + chunk)
            Hc, gc = _pose_chunk(type(rd)(*(a[sl] for a in rd)), K, poses,
                                 albedo[sl], grad_stored[sl], lights, model)
            H = Hc if H is None else H + Hc
            g = gc if g is None else g + gc
    else:
        H, g = _pose_chunk(rd, K, poses, albedo, grad_stored, lights, model)
    return H, g


def light_normal_eqs_led_plain(rd: ResidualData, prob, geom, dist, grad_stored,
                               albedo, poses) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H [3], g [3]) of the LED light block: the eager Jacobian
    (jacobians.light_jacobian_led) and its two sums
    (solvers.light_normal_eqs_led)."""
    J = jacobians.light_jacobian_led(prob, geom, dist, grad_stored, albedo, poses)
    return solvers.light_normal_eqs_led(rd, J)


# ---------------------------------------------------------------------------
# the host plan
# ---------------------------------------------------------------------------

THREADS = 256            # csrc/normaleq.cu kConsumers: the column x lane threads
POSE_TERMS = 27          # csrc/normaleq.cu kPoseTerms: a pose system's sums (H 21, g 6)
# voxels a thread's float run holds at most: a thread sums its 3 x
# LANE_VOXELS products of an entry in float, then adds the run in double
LANE_VOXELS = 32
# a thread keeps its double sums in registers where a block's system has at
# most this many (the pose's, the B = 4 light's), else in shared memory
REGISTER_TERMS = 27
# tiles and stages are multiples of this many voxels: 4 rows of a [N,F,3]
# float array are 48 F bytes, so an aligned base gives 16-byte-aligned spans
UNIT_VOXELS = 4
CLUSTER = 8              # blocks a cluster at most (csrc kMaxCluster, the portable limit)
# the ring: a stage holds at most THREAD_VOXELS voxels a lane (fewer make
# the consumers wait at more stage boundaries), a tile at least
# MIN_TILE_STAGES stages (a short tile's first stage comes sooner), where
# the unit allows; at most STAGES buffers, at least 2 (measured on an H100:
# PERF.md, tools/normaleq_ab.py)
THREAD_VOXELS = 6
MIN_TILE_STAGES = 6
STAGES = 4
SMEM_BLOCK = 232448      # an H100 block's shared memory, at most
ALIGN = 16               # a bulk copy's alignment of address and size
# csrc/normaleq.cu normaleq_active_clusters: the kernel of each block
KERNEL_IDS = {(6, False): 0, (6, True): 1, (4, False): 2, (9, False): 3}


# the LED light's kernel (csrc/normaleq.cu light_led_kernel): LED_WARPS
# warps a block, at most LED_BLOCKS_PER_SM blocks an SM in one wave; a warp's
# unit holds about LED_UNIT_PAIRS pairs of at most 32 voxels; the poses
# [12][F] in shared memory, so at most LED_MAX_F keyframes
LED_WARPS = 8
LED_BLOCKS_PER_SM = 2
LED_UNIT_PAIRS = 256
_LED_SUMS = 8 * 6 * LED_WARPS + 16     # the warps' six sums, the flag
LED_MAX_F = (SMEM_BLOCK - _LED_SUMS) // 48


class LedPlan(NamedTuple):
    blocks: int         # the grid
    unit_voxels: int    # voxels a warp's unit (lane v forms voxel v's terms)
    smem: int           # dynamic shared memory a block


def led_unit_voxels(F: int) -> int:
    """Voxels a warp's unit: for F <= 32 a whole number of the steps (32 //
    F voxels a step), past that any number (a step takes the unit's next 32
    pairs), in about LED_UNIT_PAIRS pairs, at most 32 (a lane a voxel's
    terms), at least 1."""
    F = max(F, 1)
    if F <= 32:
        V = 32 // F
        return V * max(1, min(32 // V, LED_UNIT_PAIRS // (V * F)))
    return max(1, min(32, LED_UNIT_PAIRS // F))


def led_plan(N: int, F: int, sms: int) -> LedPlan:
    """The LED light kernel's plan, a function of the shapes and the card
    alone (so a call's bits are too): units of led_unit_voxels(F) voxels,
    warp gw of the grid the units gw, gw + LED_WARPS blocks, ...; one wave
    of at most LED_BLOCKS_PER_SM blocks an SM.  Refuses more than LED_MAX_F
    keyframes (their poses would not fit a block's shared memory)."""
    if F > LED_MAX_F:
        raise ValueError(f"light_normal_eqs_led: {F} keyframes, at most {LED_MAX_F} "
                         "(the poses are staged in a block's shared memory)")
    uv = led_unit_voxels(F)
    units = -(-N // uv) if N > 0 and F > 0 else 0
    # the poses, the warps' six sums, the flag
    smem = 48 * F + _LED_SUMS
    per_sm = max(1, min(LED_BLOCKS_PER_SM, SMEM_BLOCK // smem))
    blocks = max(1, min(per_sm * sms, -(-units // LED_WARPS)))
    return LedPlan(blocks, uv, smem)


def terms(dim: int) -> int:
    """Sums a keyframe of a dim x dim system: H's upper triangle and g."""
    return dim * (dim + 1) // 2 + dim


def columns(F: int) -> Tuple[int, int, int]:
    """(FB, R, chunks): a block's keyframe columns, its voxel lanes and the
    keyframe chunks.  Under 32 keyframes the columns are the next power of
    two (a warp then holds 32 / FB whole lanes, added by shuffles; the
    columns past F idle), else min(F, THREADS)."""
    if F < 1:
        raise ValueError(f"no plan for F = {F}")
    FB = 1 << (F - 1).bit_length() if F < 32 else min(F, THREADS)
    return FB, THREADS // FB, -(-F // FB)


def staged_arrays(dim: int, led: bool) -> Tuple[Tuple[int, bool], ...]:
    """(bytes a pair, or a voxel; is a pair array) of each staged input in
    the kernel's order: the pose's g_img, p_cam, w, r (and the LED's albedo
    and stored gradient); the light's w, r and J_l [N,3,B]."""
    if dim == 6:
        return ((24, True), (12, True), (12, True), (12, True)) + (
            ((12, False), (12, False)) if led else ())
    return ((12, True), (12, True), (12 * dim, False))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _region(eb: int, pair: bool, F: int, FB: int, SV: int, rows: bool) -> Tuple[int, int]:
    """(bytes, pitch) of an array's region in a buffer of SV voxels: a span
    sits at its address modulo 16, so a region holds ALIGN bytes more than
    its span; a voxel row of the chunk's pairs a span (rows) has its own
    16-byte-aligned row of the region."""
    if pair and rows:
        pitch = _round_up(FB * eb, ALIGN) + ALIGN
        return SV * pitch, pitch
    pitch = F * eb if pair else eb
    return _round_up(SV * pitch, ALIGN) + ALIGN, pitch


class NormalEqPlan(NamedTuple):
    """csrc/normaleq.cu NormalEqPlan.  Block (tile, chunk) takes voxels
    [tile V, (tile + 1) V) x keyframes [chunk FB, (chunk + 1) FB), FB
    keyframe columns x R voxel lanes of threads; its producer warp stages
    the tile's inputs `stage_voxels` at a time into a ring of `stages`
    buffers of `stage_bytes` (each array's region at `offset`, its voxel
    rows `pitch` apart); blocks are grouped in clusters of `cluster` along
    the tiles.  Dynamic shared memory: the sums [S][THREADS] in double at 0,
    the ring at `ring` (0 where the threads keep their sums in registers:
    the sums take the ring's place after the loop), two barriers a buffer
    and a flag at `barriers`; `smem` in all."""
    frames: int          # FB
    lanes: int           # R
    chunks: int          # ceil(F / FB)
    voxels: int          # V, a multiple of lcm(UNIT_VOXELS, R)
    tiles: int           # a multiple of cluster
    cluster: int         # a power of two, at most CLUSTER
    stage_voxels: int    # a multiple of lcm(UNIT_VOXELS, R)
    stages: int
    rows: int            # 1 where F is cut into chunks
    stage_bytes: int
    ring: int
    barriers: int
    smem: int
    offset: Tuple[int, ...]   # 6 (unused: 0)
    pitch: Tuple[int, ...]


def _layout(F: int, dim: int, led: bool, SV: int) -> Tuple[int, list, list]:
    """(bytes, offsets, pitches) of a buffer of SV voxels: the staged arrays'
    regions one after the other."""
    FB, _, C = columns(F)
    offsets, pitches, at = [], [], 0
    for eb, pair in staged_arrays(dim, led):
        size, pitch = _region(eb, pair, F, FB, SV, C > 1)
        offsets.append(at)
        pitches.append(pitch)
        at += size
    return at, offsets, pitches


def _reduce_plan(N: int, F: int, dim: int, led: bool, clusters: int) -> NormalEqPlan:
    """The plan for N voxels x F keyframes of a dim x dim system on a card
    that holds `clusters` clusters of CLUSTER blocks at once: tiles of an
    equal share of the voxels (a multiple of the unit lcm(UNIT_VOXELS, R),
    at least one) for one wave of those clusters, the chunks sharing them;
    clusters of the largest power of two of blocks within CLUSTER and the
    tiles; the largest stage (a multiple of the unit) within the ring's
    limits and half its room, and as many buffers as fit, at most STAGES."""
    if N < 0 or clusters < 1:
        raise ValueError(f"no plan for N = {N} on {clusters} clusters")
    FB, R, C = columns(F)
    unit = math.lcm(UNIT_VOXELS, R)
    slots = max(1, clusters // C) * CLUSTER
    V = max(unit, _round_up(-(-N // slots), unit))
    tiles = max(1, -(-N // V))
    Q = 1 << (min(CLUSTER, tiles).bit_length() - 1)
    sums = 8 * terms(dim) * THREADS
    ring = 0 if terms(dim) <= REGISTER_TERMS else sums
    room = SMEM_BLOCK - ring - 16 * STAGES - ALIGN
    cap = max(unit, min(V // MIN_TILE_STAGES, R * THREAD_VOXELS) // unit * unit)
    SV = unit
    while SV + unit <= cap and _layout(F, dim, led, SV + unit)[0] <= room // 2:
        SV += unit
    stage_bytes, offsets, pitches = _layout(F, dim, led, SV)
    D = min(STAGES, room // stage_bytes)
    if D < 2:
        raise ValueError(f"no ring of two stages for F = {F}, dim = {dim}")
    pad = (0,) * (6 - len(offsets))
    barriers = max(ring + D * stage_bytes, sums)
    return NormalEqPlan(FB, R, C, V, _round_up(tiles, Q), Q, SV, D, int(C > 1),
                        stage_bytes, ring, barriers, barriers + 16 * D + ALIGN,
                        tuple(offsets) + pad, tuple(pitches) + pad)


_clusters: Dict[Tuple[int, int], int] = {}


def reduce_plan(dev: torch.device, N: int, F: int, dim: int, led: bool) -> NormalEqPlan:
    """_reduce_plan on `dev`: the clusters of the block's kernel that fit at
    once with a block's whole shared memory (one block an SM; a plan's
    smaller blocks fit as many), asked of the runtime once a kernel."""
    kernel = KERNEL_IDS[dim, led]
    key = (dev.index, kernel)
    if key not in _clusters:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = _library().normaleq_active_clusters(kernel, SMEM_BLOCK, CLUSTER,
                                                     ctypes.byref(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(f"normaleq: no cluster of {CLUSTER} blocks fits "
                               f"(CUDA error {rc})")
        _clusters[key] = out.value
    return _reduce_plan(N, F, dim, led, _clusters[key])


# ---------------------------------------------------------------------------
# argument checks and the library binding
# ---------------------------------------------------------------------------


class _Plan(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int64) for n in NormalEqPlan._fields[:-2]]
                + [("offset", ctypes.c_int64 * 6), ("pitch", ctypes.c_int64 * 6)])


def _c_plan(plan: NormalEqPlan) -> _Plan:
    six = ctypes.c_int64 * 6
    return _Plan(*plan[:-2], six(*plan.offset), six(*plan.pitch))


class _PoseArgs(ctypes.Structure):
    """csrc/normaleq.cu PoseArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("g_img", "p_cam", "w", "r", "poses", "K", "albedo", "grad", "light",
          "partial", "tickets", "H", "g")]
        + [(n, ctypes.c_int64) for n in ("n", "f", "led")]
        + [("plan", _Plan)])


class _LightArgs(ctypes.Structure):
    """csrc/normaleq.cu LightArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("w", "r", "J", "partial", "tickets", "H", "g")]
        + [(n, ctypes.c_int64) for n in ("n", "f", "basis")]
        + [("plan", _Plan)])


class _LightLedArgs(ctypes.Structure):
    """csrc/normaleq.cu LightLedArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("w", "r", "idx_xyz", "dist", "grad", "albedo", "poses", "partial", "ticket",
          "H", "g")]
        + [(n, ctypes.c_int64) for n in ("n", "f", "blocks")]
        + [(n, ctypes.c_double) for n in ("origin_x", "origin_y", "origin_z",
                                          "grid_voxel")]
        + [(n, ctypes.c_int64) for n in ("unit_voxels", "smem")])


def _check(what: str, dev, named) -> None:
    for name, t, shape, dtype in named:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, expected {dev}")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


_bound = None


def _bind(lib):
    """The C entry points' argument and result types set on `lib`."""
    lib.pose_normal_eqs.argtypes = [ctypes.POINTER(_PoseArgs), ctypes.c_void_p]
    lib.pose_normal_eqs.restype = ctypes.c_int
    lib.light_normal_eqs_sh.argtypes = [ctypes.POINTER(_LightArgs), ctypes.c_void_p]
    lib.light_normal_eqs_sh.restype = ctypes.c_int
    for name in ("light_normal_eqs_led", "light_led_floor"):
        getattr(lib, name).argtypes = [ctypes.POINTER(_LightLedArgs), ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    lib.normaleq_active_clusters.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.normaleq_active_clusters.restype = ctypes.c_int
    return lib


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        _bound = _bind(load_library(_LIB_NAME))
    return _bound


def _launch(name: str, args, dev) -> None:
    with torch.cuda.device(dev):
        rc = getattr(_library(), name)(ctypes.byref(args),
                                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    launch_counts[name] += 1


# the tickets of the last blocks, one buffer a device and stream: zeroed
# once when made, each call's last blocks leave theirs at 0 again
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets_for(dev, need: int) -> torch.Tensor:
    """At least `need` tickets of the device's current stream (a call's
    kernel leaves them at 0; the calls of one stream run in turn)."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < need:
        t = _tickets[key] = torch.zeros(max(64, need), dtype=torch.int32, device=dev)
    return t


def _outputs(dev, F, dim, plan):
    """(partials [chunks, clusters, S, FB] float64, tickets, H [F,dim,dim],
    g [F,dim])."""
    partial = torch.empty(
        plan.chunks * (plan.tiles // plan.cluster) * terms(dim) * plan.frames,
        dtype=torch.float64, device=dev)
    H = torch.empty((F, dim, dim), dtype=torch.float32, device=dev)
    g = torch.empty((F, dim), dtype=torch.float32, device=dev)
    return partial, _tickets_for(dev, plan.chunks * plan.cluster), H, g


def _led_plan_args(a: _LightLedArgs, N: int, F: int, plan: LedPlan) -> None:
    a.n, a.f, a.blocks = N, F, plan.blocks
    a.unit_voxels, a.smem = plan.unit_voxels, plan.smem


def light_led_floor(N: int, F: int, dev) -> None:
    """An empty kernel launched on light_normal_eqs_led's grid, block and
    shared memory for N voxels and F keyframes: the launch's floor, timed
    beside it and counted nowhere."""
    from psgradientsdf_tpu_torch.kernels import sm_count

    a = _LightLedArgs()
    _led_plan_args(a, N, F, led_plan(N, F, sm_count(dev)))
    with torch.cuda.device(dev):
        rc = _library().light_led_floor(ctypes.byref(a),
                                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"light_led_floor: kernel launch failed, CUDA error {rc}")



# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def pose_normal_eqs(rd: ResidualData, K, poses, albedo, grad_stored, lights,
                    model: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H [F,6,6], g [F,6]) of the pose block from the residual pass rd
    (g_img, p_cam, w, r) at the state (poses; under the LED also albedo,
    grad_stored and the light [3]): one launch of the kernel on CUDA
    tensors, pose_normal_eqs_plain on CPU tensors."""
    w = rd.w
    if w.device.type == "cpu":
        return pose_normal_eqs_plain(rd, K, poses, albedo, grad_stored, lights, model)
    N, F = w.shape[0], w.shape[1]
    dev = w.device
    f32 = torch.float32
    led = model == LED
    ins = {"rd.g_img": (rd.g_img, (N, F, 3, 2)), "rd.p_cam": (rd.p_cam, (N, F, 3)),
           "rd.w": (w, (N, F, 3)), "rd.r": (rd.r, (N, F, 3)),
           "poses": (poses.contiguous(), (F, 4, 4)), "K": (K.contiguous(), (3, 3))}
    if led:
        ins.update({"albedo": (albedo.contiguous(), (N, 3)),
                    "grad_stored": (grad_stored.contiguous(), (N, 3)),
                    "lights": (lights.contiguous(), (3,))})
    _check("pose_normal_eqs", dev,
           [(name, t, shape, f32) for name, (t, shape) in ins.items()])
    # the kernel reads g_img's (u, v) pairs as 8-byte words; the other
    # arrays' bases may lie anywhere (the producer loads the ragged ends)
    if rd.g_img.data_ptr() % 8:
        raise ValueError("pose_normal_eqs: rd.g_img must start on an 8-byte boundary")
    plan = reduce_plan(dev, N, F, 6, led)
    partial, tickets, H, g = _outputs(dev, F, 6, plan)
    a = _PoseArgs()
    a.g_img, a.p_cam, a.w, a.r = (rd.g_img.data_ptr(), rd.p_cam.data_ptr(),
                                  w.data_ptr(), rd.r.data_ptr())
    a.poses, a.K = ins["poses"][0].data_ptr(), ins["K"][0].data_ptr()
    if led:
        a.albedo = ins["albedo"][0].data_ptr()
        a.grad = ins["grad_stored"][0].data_ptr()
        a.light = ins["lights"][0].data_ptr()
    a.partial, a.tickets = partial.data_ptr(), tickets.data_ptr()
    a.H, a.g = H.data_ptr(), g.data_ptr()
    a.n, a.f, a.led = N, F, int(led)
    a.plan = _c_plan(plan)
    _launch("pose_normal_eqs", a, dev)
    return H, g


def light_normal_eqs_sh(rd: ResidualData, J_l: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H [F,B,B], g [F,B]) of the SH light block from the residual pass rd
    (w, r) and the frame-independent light Jacobian J_l [N,3,B]: one launch
    of the kernel on CUDA tensors, solvers.light_normal_eqs_sh on CPU
    tensors."""
    w = rd.w
    if w.device.type == "cpu":
        return solvers.light_normal_eqs_sh(rd, J_l)
    N, F = w.shape[0], w.shape[1]
    B = J_l.shape[-1]
    if B not in (4, 9):
        raise ValueError(f"light_normal_eqs_sh: {B} SH coefficients, expected 4 or 9")
    dev = w.device
    f32 = torch.float32
    _check("light_normal_eqs_sh", dev,
           [("rd.w", w, (N, F, 3), f32), ("rd.r", rd.r, (N, F, 3), f32),
            ("J_l", J_l, (N, 3, B), f32)])
    plan = reduce_plan(dev, N, F, B, False)
    partial, tickets, H, g = _outputs(dev, F, B, plan)
    a = _LightArgs()
    a.w, a.r, a.J = w.data_ptr(), rd.r.data_ptr(), J_l.data_ptr()
    a.partial, a.tickets = partial.data_ptr(), tickets.data_ptr()
    a.H, a.g = H.data_ptr(), g.data_ptr()
    a.n, a.f, a.basis = N, F, B
    a.plan = _c_plan(plan)
    _launch("light_normal_eqs_sh", a, dev)
    return H, g


def light_normal_eqs_led(rd: ResidualData, prob, geom, dist, grad_stored, albedo,
                         poses) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H [3], g [3]) of the LED light block from the residual pass rd (w,
    r) at the state (the problem's voxel coordinates on the grid `geom`,
    dist, grad_stored, albedo, poses): one launch of the kernel on CUDA
    tensors, light_normal_eqs_led_plain on CPU tensors."""
    w = rd.w
    if w.device.type == "cpu":
        return light_normal_eqs_led_plain(rd, prob, geom, dist, grad_stored, albedo, poses)
    N, F = w.shape[0], w.shape[1]
    dev = w.device
    f32 = torch.float32
    ins = {"rd.w": (w, (N, F, 3), f32), "rd.r": (rd.r, (N, F, 3), f32),
           "idx_xyz": (prob.idx_xyz.contiguous(), (N, 3), torch.int32),
           "dist": (dist.contiguous(), (N,), f32),
           "grad_stored": (grad_stored.contiguous(), (N, 3), f32),
           "albedo": (albedo.contiguous(), (N, 3), f32),
           "poses": (poses.contiguous(), (F, 4, 4), f32)}
    _check("light_normal_eqs_led", dev,
           [(name, t, shape, dtype) for name, (t, shape, dtype) in ins.items()])
    from psgradientsdf_tpu_torch.kernels import sm_count

    plan = led_plan(N, F, sm_count(dev))
    partial = torch.empty(6 * plan.blocks, dtype=torch.float64, device=dev)
    Hg = torch.empty(6, dtype=f32, device=dev)
    a = _LightLedArgs()
    for field, name in (("w", "rd.w"), ("r", "rd.r"), ("idx_xyz", "idx_xyz"),
                        ("dist", "dist"), ("grad", "grad_stored"), ("albedo", "albedo"),
                        ("poses", "poses")):
        setattr(a, field, ins[name][0].data_ptr())
    a.partial, a.ticket = partial.data_ptr(), _tickets_for(dev, 1).data_ptr()
    a.H, a.g = Hg.data_ptr(), Hg[3:].data_ptr()
    _led_plan_args(a, N, F, plan)
    a.origin_x, a.origin_y, a.origin_z = (float(v) for v in geom.origin)
    a.grid_voxel = float(geom.voxel_size)
    _launch("light_normal_eqs_led", a, dev)
    return Hg[:3], Hg[3:]
