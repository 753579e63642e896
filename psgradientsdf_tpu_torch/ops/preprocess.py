"""The scan's preprocessing: FALS normals and the LAPM sharpness of a chunk
of frames, one launch each of the hand-written Hopper kernels in
csrc/preprocess.cu, or their plain PyTorch versions for CPU tensors.

  fals_normals(depth [C,H,W] or [H,W], cache, window) -> [...,H,W,3]
  lapm(colors [C,H,W,3] or [H,W,3], or grey [C,H,W] / [H,W]) -> [C] or a scalar

They replace the JAX package's psgradientsdf_tpu/tracking/stream.py
`_preprocess` (:74-80), one device program a chunk over ops/normals.py
`compute_normals` (:112) and ops/sharpness.py `modified_laplacian` (:47).
The plain versions are the port's eager chains (formerly in ops/normals.py
and ops/sharpness.py, which now call the wrappers): three box filters of
shifted-slice sums, the closed-form 3x3 solve and the normalisation; two
separable 3-tap filters and a mean.

The normals kernel computes every product, sum and quotient of the plain
version in the same order, each rounded once, so the two agree on the card
bit for bit.  It is a persistent grid (`fals_grid`) over (32 x 32 tile,
frame) units, a block walking over the frames of its tile with the cache
planes loaded once a tile and each frame's depth halo copied in while the
units before it compute; a thread's window sums share the values they read
(`window_sums` in csrc/preprocess.cu), which changes who adds, not the
order of any sum.  LAPM's kernel stages each row's span into shared memory
by bulk copies and computes each row's x passes once (`lapm_plan`: bands
of rows, strips of columns, a ring of row buffers); its filtered values
follow the plain arithmetic too, and its mean over the image is summed in
double in a fixed order (and the plain torch.mean in float in its own), so
the two agree to float32 rounding and two launches give the same bits.

A wrapper takes the plain version ONLY for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  `launch_counts` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

_LIB_NAME = "preprocess"
launch_counts: Dict[str, int] = {"fals_normals": 0, "lapm": 0}

# the odd box-filter windows the normals kernel takes, 1 .. MAX_WINDOW: its
# shared memory holds a TILE x TILE output tile with a halo of window // 2
# on each side (csrc/preprocess.cu fals_normals_kernel)
MAX_WINDOW = 31
TILE = 32
H_COLS = 8            # horizontal window sums a thread: neighbouring columns
V_ROWS = 4            # vertical window sums a thread: neighbouring rows
HS_PITCH = TILE + 1   # the horizontal sums' row pitch, in floats

# cv::getGaussianKernel(3) and the second difference of cv::Laplacian
GAUSS3 = (0.25, 0.5, 0.25)
LAP3 = (-1.0, 2.0, -1.0)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# the plain PyTorch versions
# ---------------------------------------------------------------------------


def _box_filter(img: torch.Tensor, window: int) -> torch.Tensor:
    """Unnormalized window-sum box filter with reflect-101 borders over the
    last two dims of a [...,H,W] tensor (OpenCV boxFilter's defaults), as
    separable shifted-slice sums in float32: the same additions in the same
    order as the JAX package, and no convolution library (cuDNN would run
    a float32 convolution in TF32 by default)."""
    r = window // 2
    lead = img.shape[:-2]
    H, W = img.shape[-2], img.shape[-1]
    x = F.pad(img.reshape(-1, 1, H, W), (r, r, r, r), mode="reflect")[:, 0]
    acc = x[..., 0:W]
    for j in range(1, window):
        acc = acc + x[..., j:W + j]
    out = acc[..., 0:H, :]
    for i in range(1, window):
        out = out + acc[..., i:H + i, :]
    return out.reshape(lead + (H, W))


def fals_normals_plain(depth: torch.Tensor, cache, window: int = 11) -> torch.Tensor:
    """FALS normals (NormalEstimator.h compute(), :150-176) of a [H,W] depth
    map or a [C,H,W] batch on the cache's device -> [...,H,W,3] unit
    normals (inward-pointing, like the reference).  Pixels with zero depth
    contribute 0 to the window sums."""
    zero = depth == 0.0
    z_inv = torch.where(
        zero, torch.zeros_like(depth),
        1.0 / torch.where(zero, torch.ones_like(depth), depth))
    b1 = _box_filter(cache.x0_n_sq_inv * z_inv, window)
    b2 = _box_filter(cache.y0_n_sq_inv * z_inv, window)
    b3 = _box_filter(cache.n_sq_inv * z_inv, window)

    Q = cache.Q
    nx = b1 * Q[..., 0] + b2 * Q[..., 1] + b3 * Q[..., 2]
    ny = b1 * Q[..., 1] + b2 * Q[..., 3] + b3 * Q[..., 4]
    nz = b1 * Q[..., 2] + b2 * Q[..., 4] + b3 * Q[..., 5]

    n = torch.stack([nx, ny, nz], dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.clamp(norm, min=1e-20)


def _pad1(src: torch.Tensor) -> torch.Tensor:
    """[...,H,W] -> [...,H+2,W+2] with reflect-101 borders."""
    lead = src.shape[:-2]
    H, W = src.shape[-2], src.shape[-1]
    x = F.pad(src.reshape(-1, 1, H, W), (1, 1, 1, 1), mode="reflect")[:, 0]
    return x.reshape(lead + (H + 2, W + 2))


def _sep_filter(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 3-tap filter: kx along columns (x), ky along rows (y),
    reflect-101 borders (cv::sepFilter2D defaults), as shifted-slice sums."""
    x = _pad1(img)
    W = img.shape[-1]
    H = img.shape[-2]
    x = kx[0] * x[..., 0:W] + kx[1] * x[..., 1:W + 1] + kx[2] * x[..., 2:W + 2]
    x = ky[0] * x[..., 0:H, :] + ky[1] * x[..., 1:H + 1, :] + ky[2] * x[..., 2:H + 2, :]
    return x


def is_rgb(img: torch.Tensor) -> bool:
    """The measures' rule: a last dim of 3 on a tensor of 3 dims or more is
    a colour image, measured on its channel 2 (blue, BGR channel 0)."""
    return img.dim() >= 3 and img.shape[-1] == 3


def measure_channel(img: torch.Tensor) -> torch.Tensor:
    return img[..., 2] if is_rgb(img) else img


def lapm_plain(img: torch.Tensor) -> torch.Tensor:
    """LAPM (Nayar89): mean(|Lx| + |Ly|) (SharpDetector.h:22-37) of one image
    or a batch -> a scalar or [C]."""
    src = measure_channel(img)
    Lx = _sep_filter(src, LAP3, GAUSS3)
    Ly = _sep_filter(src, GAUSS3, LAP3)
    return torch.mean(Lx.abs() + Ly.abs(), dim=(-2, -1))


# ---------------------------------------------------------------------------
# host plans, the C interface and the library
# ---------------------------------------------------------------------------


def check_window(window: int, H: int, W: int) -> None:
    """Raise unless the normals take `window` on an H x W image: odd, 1 ..
    MAX_WINDOW, and its half-width under both sides (the reflect-101 pad's
    rule)."""
    if (not isinstance(window, int) or window < 1 or window % 2 == 0
            or window > MAX_WINDOW):
        raise ValueError(f"fals_normals: the window must be odd, 1 .. {MAX_WINDOW}, "
                         f"got {window!r}")
    if window // 2 >= min(H, W):
        raise ValueError(f"fals_normals: a window of {window} does not fit a "
                         f"{H} x {W} image")


def fals_grid(C: int, H: int, W: int, slots: int) -> Tuple[int, int, int, int]:
    """The normals kernel's persistent grid -> (tiles across, tiles down,
    units, blocks): a unit is (TILE x TILE output tile, frame), tile-major
    with the frame fastest, and `slots` (the SMs times the blocks an SM
    holds at the window's shared memory) bounds the blocks.  Block b takes
    the units fals_units(b, blocks, units)."""
    tx, ty = -(-W // TILE), -(-H // TILE)
    units = tx * ty * C
    return tx, ty, units, max(1, min(units, slots))


def fals_units(b: int, blocks: int, units: int) -> range:
    """Block b's units, as the kernel cuts them: [b U / B, (b + 1) U / B)."""
    return range(b * units // blocks, (b + 1) * units // blocks)


def fals_smem(window: int) -> int:
    """The normals kernel's shared memory in bytes: the three cache planes
    and the three weighted components of a tile's halo (an odd row pitch),
    their horizontal sums, two depth halos and the halo's source rows and
    columns."""
    r = window // 2
    P = TILE + 2 * r
    return 4 * (6 * P * (P | 1) + 3 * P * HS_PITCH + 2 * P * P + 2 * P)


# LAPM's host plan (csrc/preprocess.cu lapm_kernel): a consumer thread owns
# at most LAPM_COLS columns of its block's strip, a strip at most
# LAPM_MAX_STRIP columns; at most LAPM_BLOCKS_PER_SM blocks an SM, each with a
# ring of at most LAPM_DEPTH row buffers (measured on an H100: PERF.md §6)
LAPM_COLS = 4
LAPM_MAX_STRIP = 1024
LAPM_BLOCKS_PER_SM = 2
LAPM_DEPTH = 3


class LapmPlan(NamedTuple):
    bands: int          # bands of rows a frame
    rows: int           # rows a band (the last band may have fewer)
    strips: int         # strips of columns a row
    strip_cols: int     # columns a strip (the last strip may have fewer)
    threads: int        # consumer threads a block (the producer warp besides)
    depth: int          # row buffers of a block's ring
    pitch: int          # bytes a buffer
    smem: int           # dynamic shared memory a block


def lapm_plan(C: int, H: int, W: int, S: int, sms: int) -> LapmPlan:
    """LAPM's grid, a function of the shapes and the SM count alone: strips
    of at most LAPM_MAX_STRIP columns, bands of whole rows of one frame
    giving at most LAPM_BLOCKS_PER_SM blocks an SM over the C frames (at
    least a band a frame and strip), and a block's ring of row buffers (a
    buffer holds the strip's span of a row, its columns and one neighbour on
    each side, at the span's address modulo 16).  Block (band b, strip s,
    frame c) sums rows [b rows, (b + 1) rows) and columns [s strip_cols,
    (s + 1) strip_cols), cut at H and W."""
    strips = -(-W // LAPM_MAX_STRIP)
    cols = -(-W // strips)
    threads = 32 * -(-cols // (32 * LAPM_COLS))
    want = max(1, min(H, LAPM_BLOCKS_PER_SM * sms // (C * strips)))
    rows = -(-H // want)
    depth = min(LAPM_DEPTH, rows + 2)
    pitch = 16 * -(-((cols + 2) * S * 4 + 12) // 16)
    # the ring, a full and an empty barrier a buffer, 32 warps' sums, the flag
    smem = depth * pitch + 16 * depth + 8 * 32 + 16
    return LapmPlan(-(-H // rows), rows, strips, cols, threads, depth, pitch, smem)


class _FalsArgs(ctypes.Structure):
    """csrc/preprocess.cu FalsArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("depth", "x0n", "y0n", "nsi", "Q", "out")]
        + [(n, ctypes.c_int64) for n in ("C", "H", "W", "window", "blocks")])


class _LapmArgs(ctypes.Structure):
    """csrc/preprocess.cu LapmArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("img", "out", "part", "ticket")]
        + [(n, ctypes.c_int64) for n in
           ("C", "H", "W", "S", "chan", "frame", "bands", "rows_per_band", "strips",
            "strip_cols", "threads", "depth", "pitch", "smem")])


_bound = None


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        lib.fals_normals.argtypes = [ctypes.POINTER(_FalsArgs), ctypes.c_void_p]
        lib.fals_normals.restype = ctypes.c_int
        lib.fals_normals_occupancy.argtypes = [ctypes.c_int64,
                                               ctypes.POINTER(ctypes.c_int64)]
        lib.fals_normals_occupancy.restype = ctypes.c_int
        for name in ("lapm", "lapm_floor"):
            getattr(lib, name).argtypes = [ctypes.POINTER(_LapmArgs), ctypes.c_void_p]
            getattr(lib, name).restype = ctypes.c_int
        _bound = lib
    return _bound


def _launch(name: str, args, dev) -> None:
    with torch.cuda.device(dev):
        rc = getattr(_library(), name)(ctypes.byref(args),
                                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    launch_counts[name] += 1


# the normals kernel's blocks an SM at a window's shared memory, asked once
# a device and window
_per_sm: Dict[Tuple[int, int], int] = {}


def fals_blocks_per_sm(dev, window: int) -> int:
    key = (dev.index, window)
    n = _per_sm.get(key)
    if n is None:
        out = ctypes.c_int64()
        with torch.cuda.device(dev):
            rc = _library().fals_normals_occupancy(window, ctypes.byref(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(f"fals_normals: no block of window {window} fits an SM "
                               f"(CUDA error {rc})")
        n = _per_sm[key] = int(out.value)
    return n


# the ticket of LAPM's last block, one a device and stream: zeroed once when
# made, each launch's last block leaves it at 0 again
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket(dev) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def _lapm_shape(img: torch.Tensor):
    """(C, H, W, S, chan, lead) of an RGB or grey image or batch, raising on
    what the kernel does not take."""
    if img.dtype != torch.float32:
        raise TypeError(f"lapm: the image must be float32 on the card, got {img.dtype}")
    rgb = is_rgb(img)
    if img.dim() < 2 or (rgb and img.dim() < 3):
        raise ValueError(f"lapm: not an image: {tuple(img.shape)}")
    S, chan = (3, 2) if rgb else (1, 0)
    lead = img.shape[:-3] if rgb else img.shape[:-2]
    H, W = (img.shape[-3], img.shape[-2]) if rgb else (img.shape[-2], img.shape[-1])
    if H < 2 or W < 2:
        raise ValueError(f"lapm: a {H} x {W} image has no reflect-101 border")
    return math.prod(lead), H, W, S, chan, lead


def _lapm_args(C, H, W, S, chan, plan: LapmPlan) -> _LapmArgs:
    a = _LapmArgs()
    a.C, a.H, a.W, a.S, a.chan, a.frame = C, H, W, S, chan, H * W * S
    a.bands, a.rows_per_band, a.strips, a.strip_cols = (plan.bands, plan.rows, plan.strips,
                                                        plan.strip_cols)
    a.threads, a.depth, a.pitch, a.smem = plan.threads, plan.depth, plan.pitch, plan.smem
    return a


def lapm_floor(img: torch.Tensor) -> None:
    """An empty kernel launched on lapm's grid, block and shared memory for
    `img` on the card: the launch's floor, timed beside it and counted
    nowhere."""
    C, H, W, S, chan, _ = _lapm_shape(img)
    from psgradientsdf_tpu_torch.kernels import sm_count

    dev = img.device
    a = _lapm_args(C, H, W, S, chan, lapm_plan(C, H, W, S, sm_count(dev)))
    with torch.cuda.device(dev):
        rc = _library().lapm_floor(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lapm_floor: kernel launch failed, CUDA error {rc}")



# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def fals_normals(depth, cache, window: int = 11) -> torch.Tensor:
    """fals_normals_plain's contract, on the cache's device: one kernel
    launch on the card, the plain version on the CPU."""
    depth = torch.as_tensor(depth, dtype=torch.float32, device=cache.Q.device)
    if depth.dim() not in (2, 3):
        raise ValueError(f"fals_normals: depth must be [H, W] or [C, H, W], "
                         f"got {tuple(depth.shape)}")
    H, W = depth.shape[-2], depth.shape[-1]
    check_window(window, H, W)
    if depth.device.type == "cpu":
        return fals_normals_plain(depth, cache, window)
    dev = depth.device
    planes = {"x0_n_sq_inv": (H, W), "y0_n_sq_inv": (H, W), "n_sq_inv": (H, W),
              "Q": (H, W, 6)}
    for name, shape in planes.items():
        t = getattr(cache, name)
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"fals_normals: cache.{name} must be float32 "
                             f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    d = depth.contiguous()
    C = 1 if d.dim() == 2 else d.shape[0]
    out = torch.empty(tuple(d.shape) + (3,), dtype=torch.float32, device=dev)
    if C == 0:
        return out
    x0n, y0n, nsi, Q = (getattr(cache, n).contiguous() for n in planes)
    a = _FalsArgs()
    a.depth, a.x0n, a.y0n, a.nsi, a.Q, a.out = (
        d.data_ptr(), x0n.data_ptr(), y0n.data_ptr(), nsi.data_ptr(),
        Q.data_ptr(), out.data_ptr())
    from psgradientsdf_tpu_torch.kernels import sm_count

    a.C, a.H, a.W, a.window = C, H, W, window
    a.blocks = fals_grid(C, H, W, sm_count(dev) * fals_blocks_per_sm(dev, window))[3]
    _launch("fals_normals", a, dev)
    return out


def lapm(img: torch.Tensor) -> torch.Tensor:
    """lapm_plain's contract: one kernel launch on the card (float32
    images), the plain version on the CPU."""
    if img.device.type == "cpu":
        return lapm_plain(img)
    C, H, W, S, chan, lead = _lapm_shape(img)
    dev = img.device
    out = torch.empty(C, dtype=torch.float32, device=dev)
    if C == 0:
        return out.reshape(lead)
    x = img.contiguous()
    from psgradientsdf_tpu_torch.kernels import sm_count

    plan = lapm_plan(C, H, W, S, sm_count(dev))
    part = torch.empty(C * plan.bands * plan.strips, dtype=torch.float64, device=dev)
    a = _lapm_args(C, H, W, S, chan, plan)
    a.img, a.out, a.part, a.ticket = (x.data_ptr(), out.data_ptr(), part.data_ptr(),
                                      _ticket(dev).data_ptr())
    _launch("lapm", a, dev)
    return out.reshape(lead)
