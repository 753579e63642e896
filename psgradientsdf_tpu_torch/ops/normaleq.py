"""The refinement's pose and light normal equations: per keyframe, the
weighted Gram matrix of a block's Jacobian rows and its gradient, summed over
the surface voxels and their three channels.  One call each of the
hand-written Hopper kernels in csrc/normaleq.cu, or their plain PyTorch
versions for CPU tensors.

  pose_normal_eqs(rd, K, poses, albedo, grad_stored, lights, model)
      -> (H [F,6,6], g [F,6])
  light_normal_eqs_sh(rd, J_l) -> (H [F,B,B], g [F,B])   (B = 4 or 9)

pose_normal_eqs replaces the JAX package's psgradientsdf_tpu/refine/
optimizer.py `_pose_normal_eqs` (:208) and its chunk loop in `_pose_core`
(:222): refine/jacobians.py `image_pi_grad` (:44), `pose_jacobian_sh` (:72)
or `pose_jacobian_led` (:84), and the einsums nfc,nfcb,nfcd->fbd and
nfc,nfcb,nfc->fb.  light_normal_eqs_sh replaces refine/solvers.py
`solve_light_sh`'s (:512) einsums nfc,ncb,ncd->fbd and nfc,ncb,nfc->fb
(:526-527); the batched eigen-solve after it (solvers.
solve_light_from_normal_eqs) stays in PyTorch.

The plain versions are the port's eager chains: pose_normal_eqs_plain forms
the pose Jacobian [n,F,3,6] of N-chunks of at most _POSE_CHUNK voxels and
sums their products (solvers.pose_normal_eqs); the light's is
solvers.light_normal_eqs_sh, one [F,3N] x [3N,B*B] product.  The kernels
form each pair's Jacobian row in registers and store no [N,F,...] tensor;
they sum the plain versions' float products in a fixed order (a thread's
run of at most LANE_VOXELS voxels in float, then its tile's lanes and the
tiles' partials in double; the tiles of consecutive voxels x keyframes
planned here by _reduce_plan), so they agree with the plain versions to
float32 rounding of the sums and give the same bits on every run.

A call on the card is two launches: the tile pass and the reduction of its
partials.  A wrapper takes the plain version ONLY for tensors that lie on
the CPU; for CUDA tensors it launches the kernels or raises.
`launch_counts` counts the calls that launched them, and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from psgradientsdf_tpu_torch.config import LED
from psgradientsdf_tpu_torch.refine import jacobians, solvers
from psgradientsdf_tpu_torch.refine.render import ResidualData

_LIB_NAME = "normaleq"
launch_counts: Dict[str, int] = {"pose_normal_eqs": 0, "light_normal_eqs_sh": 0}


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


# ---------------------------------------------------------------------------
# the plan of the tile pass
# ---------------------------------------------------------------------------

THREADS = 256            # csrc/normaleq.cu kThreads
REDUCE_THREADS = 1024    # csrc/normaleq.cu kReduceThreads
POSE_TERMS = 27          # csrc/normaleq.cu kPoseTerms: H's 21 upper entries, g's 6
# tiles a card's SM takes at once: two blocks of 256 threads fit an SM (55
# KB of the pose's shared memory and at most 128 registers a thread each),
# so the tile pass of the main path is one wave
BLOCKS_PER_SM = 2
# voxels a lane adds at most: a thread sums its 3 x LANE_VOXELS products of
# an entry in float before its lanes' sums are added in double
LANE_VOXELS = 32


def terms(dim: int) -> int:
    """Sums a keyframe of a dim x dim system: H's upper triangle and g."""
    return dim * (dim + 1) // 2 + dim


class ReducePlan(NamedTuple):
    """csrc/normaleq.cu ReducePlan: block (tile, chunk) takes voxels [tile V,
    (tile + 1) V) x keyframes [chunk FB, (chunk + 1) FB), FB keyframe columns
    x R voxel lanes of threads; a lane adds the voxels lane, lane + R, ...
    of its tile."""
    frames: int          # FB
    lanes: int           # R
    chunks: int          # ceil(F / FB)
    voxels: int          # V, a multiple of R
    tiles: int           # ceil(N / V), at least 1


def _reduce_plan(N: int, F: int, sms: int) -> ReducePlan:
    """The tile pass's plan for N voxels x F keyframes on a card of `sms`
    SMs: all F keyframes a block where F <= THREADS (else chunks of THREADS,
    one lane), as many voxel lanes as the block's threads hold, and tiles of
    an equal share of the voxels for BLOCKS_PER_SM blocks an SM (at least a
    voxel a lane, at most LANE_VOXELS)."""
    if N < 0 or F < 1 or sms < 1:
        raise ValueError(f"no plan for N = {N}, F = {F}, {sms} SMs")
    FB = min(F, THREADS)
    R = THREADS // FB
    C = -(-F // FB)
    want = max(1, -(-BLOCKS_PER_SM * sms // C))
    V = min(max(R, -(-N // want)), R * LANE_VOXELS)
    V = -(-V // R) * R
    return ReducePlan(FB, R, C, V, max(1, -(-N // V)))


_sms: Dict[int, int] = {}


def reduce_plan(dev: torch.device, N: int, F: int) -> ReducePlan:
    """_reduce_plan on `dev`'s SMs."""
    sms = _sms.get(dev.index)
    if sms is None:
        sms = _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _reduce_plan(N, F, sms)


# ---------------------------------------------------------------------------
# argument checks and the library binding
# ---------------------------------------------------------------------------


class _ReducePlan(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in ReducePlan._fields]


class _PoseArgs(ctypes.Structure):
    """csrc/normaleq.cu PoseArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("g_img", "p_cam", "w", "r", "poses", "K", "albedo", "grad", "light",
          "partial", "H", "g")]
        + [(n, ctypes.c_int64) for n in ("n", "f", "led")]
        + [("plan", _ReducePlan)])


class _LightArgs(ctypes.Structure):
    """csrc/normaleq.cu LightArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("w", "r", "J", "partial", "H", "g")]
        + [(n, ctypes.c_int64) for n in ("n", "f", "basis")]
        + [("plan", _ReducePlan)])


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


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        lib.pose_normal_eqs.argtypes = [ctypes.POINTER(_PoseArgs), ctypes.c_void_p]
        lib.pose_normal_eqs.restype = ctypes.c_int
        lib.light_normal_eqs_sh.argtypes = [ctypes.POINTER(_LightArgs), ctypes.c_void_p]
        lib.light_normal_eqs_sh.restype = ctypes.c_int
        _bound = lib
    return _bound


def _launch(name: str, args, dev) -> None:
    with torch.cuda.device(dev):
        rc = getattr(_library(), name)(ctypes.byref(args),
                                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    launch_counts[name] += 1


def _outputs(dev, F, dim, plan):
    """(partials [tiles, F, S] float64, H [F,dim,dim], g [F,dim])."""
    partial = torch.empty((plan.tiles, F, terms(dim)), dtype=torch.float64, device=dev)
    H = torch.empty((F, dim, dim), dtype=torch.float32, device=dev)
    g = torch.empty((F, dim), dtype=torch.float32, device=dev)
    return partial, H, g


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def pose_normal_eqs(rd: ResidualData, K, poses, albedo, grad_stored, lights,
                    model: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H [F,6,6], g [F,6]) of the pose block from the residual pass rd
    (g_img, p_cam, w, r) at the state (poses; under the LED also albedo,
    grad_stored and the light [3]): one call of the kernels on CUDA
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
    plan = reduce_plan(dev, N, F)
    partial, H, g = _outputs(dev, F, 6, plan)
    a = _PoseArgs()
    a.g_img, a.p_cam, a.w, a.r = (rd.g_img.data_ptr(), rd.p_cam.data_ptr(),
                                  w.data_ptr(), rd.r.data_ptr())
    a.poses, a.K = ins["poses"][0].data_ptr(), ins["K"][0].data_ptr()
    if led:
        a.albedo = ins["albedo"][0].data_ptr()
        a.grad = ins["grad_stored"][0].data_ptr()
        a.light = ins["lights"][0].data_ptr()
    a.partial, a.H, a.g = partial.data_ptr(), H.data_ptr(), g.data_ptr()
    a.n, a.f, a.led = N, F, int(led)
    a.plan = _ReducePlan(*plan)
    _launch("pose_normal_eqs", a, dev)
    return H, g


def light_normal_eqs_sh(rd: ResidualData, J_l: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H [F,B,B], g [F,B]) of the SH light block from the residual pass rd
    (w, r) and the frame-independent light Jacobian J_l [N,3,B]: one call of
    the kernels on CUDA tensors, solvers.light_normal_eqs_sh on CPU
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
    plan = reduce_plan(dev, N, F)
    partial, H, g = _outputs(dev, F, B, plan)
    a = _LightArgs()
    a.w, a.r, a.J = w.data_ptr(), rd.r.data_ptr(), J_l.data_ptr()
    a.partial, a.H, a.g = partial.data_ptr(), H.data_ptr(), g.data_ptr()
    a.n, a.f, a.basis = N, F, B
    a.plan = _ReducePlan(*plan)
    _launch("light_normal_eqs_sh", a, dev)
    return H, g
