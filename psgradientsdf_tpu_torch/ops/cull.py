"""The culled fusion's level-1 cull and level-2 compaction: one launch each
of the hand-written Hopper kernels in csrc/cull.cu, or their plain PyTorch
versions for CPU tensors.

  row_activity(geom, depth, K, pose, *, truncation, zmin, zmax, z0=,
               z_rows=, z_idx=, seg_x=, margin_px=, margin_t=, gate=,
               union=) -> bool [z_rows, Y] (rows) or [z_rows, Y, X/seg_x]
  compact_active(active_flat, capacity) -> (idx int64 [capacity],
                                            n_active int64 scalar)
  compact_padded(active_flat, capacity) -> (idx int32 [capacity],
                                            live int64 scalar,
                                            overflow bool scalar)

They replace the JAX package's psgradientsdf_tpu/core/volume.py
`_row_activity` (:252) and the `jnp.nonzero(active_flat, size=row_capacity,
fill_value=NSEG)` compaction with its duplicate-first padding inside
`_fuse_culled_slab` (:513-528), both parts of the one device program
`fuse_frame_culled` (:396).  The plain versions are the port's eager
chains (formerly in core/volume.py), where the card runs one launch each.

row_activity ANDs `gate` (a bool scalar on the device) into the mask, and
ORs the mask into `union` (a mask of the same shape, in place) when one is
given: fuse_frames_culled culls its K frames into one union that way, one
launch a frame.  The kernel equals the plain version mask element for mask
element on the card: the same float operations in the same order, each
rounded once.  The compaction's kernel writes the same indices and
scalars as its plain version.

A wrapper takes the plain version ONLY for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  `launch_counts` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.ops.fuse import rot_apply

_LIB_NAME = "cull"
launch_counts: Dict[str, int] = {"row_activity": 0, "compact_rows": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# the plain PyTorch versions
# ---------------------------------------------------------------------------


def _slab_planes(z_rows: int, z0: Optional[int], z_map: Optional[torch.Tensor],
                 dev) -> Optional[torch.Tensor]:
    """The global plane index of each of a slab's z_rows planes, as float32:
    z_map (interleaved slabs), or z0 + local (contiguous ones), added as
    floats, as the JAX package does; None for the whole grid."""
    if z_map is not None:
        return z_map.to(dev, torch.float32)
    if z0 is None:
        return None
    return torch.arange(z_rows, dtype=torch.float32, device=dev) + float(z0)


def table_levels(H: int) -> int:
    """The levels of the range-maximum table over H image rows."""
    return max(1, (H - 1).bit_length())


def row_activity_plain(
    geom: GridGeometry,
    depth: torch.Tensor,
    K: torch.Tensor,
    pose: torch.Tensor,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    z0: Optional[int] = None,         # slab z-offset (sharded slabs)
    z_rows: Optional[int] = None,     # slab z extent (default: whole grid)
    z_idx: Optional[torch.Tensor] = None,  # [z_rows] global z per local
                                           # plane (interleaved slabs;
                                           # overrides z0)
    seg_x: Optional[int] = None,      # X-segment length (None = whole row)
    margin_px: float = 0.0,           # extra pixel margin on the image test
    margin_t: float = 0.0,            # extra meters on the carve/behind tests
) -> torch.Tensor:
    """Level-1 cull of fuse_frame_culled: conservative activity mask at
    X-row granularity ([Z, Y], seg_x=None) or X-SEGMENT granularity
    ([Z, Y, X//seg_x]) — the endpoint bounds are exact for any x interval
    (u, v are Moebius in x with constant derivative sign where pz > 0), so
    segments just evaluate them at the segment ends.  With (z0, z_rows) or
    (z_idx, z_rows) the mask covers a Z-slab: the per-shard form of
    parallel/shard.py.

    A row is culled if (a) it lies entirely behind the camera, (b) its
    projected interval misses the image, or (c) it lies more than the
    truncation behind every observable depth in its v-footprint (a
    per-image-row max table with a sparse table for O(1) range maxima).  All
    tests carry float-safety margins, so the mask is a strict SUPERSET of
    the active set.  Same arithmetic, in the same order, as the JAX package's
    _row_activity: the two masks are compared exactly in the tests.

    margin_px / margin_t widen the image-footprint and depth-band tests, so
    the mask stays a superset of the active set while the pose moves by up
    to about margin_px pixels of reprojection and margin_t meters of
    camera depth: the resident allocator (core/resident.py) admits with them
    the rows a tracking solve may query as it moves the pose from its seed.
    Zero margins give the exact-frame cull, bit for bit."""
    dev = depth.device
    H, W = depth.shape
    X, Y, Zd = geom.dims
    if z_rows is None:
        z_rows = Zd
    S = X if seg_x is None else seg_x
    assert X % S == 0, f"seg_x={S} must divide X={X}"
    NS = X // S
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    R = pose[:3, :3]
    t = pose[:3, 3]
    origin = geom.origin_tensor(dev)
    h = geom.voxel_size
    f32 = dict(dtype=torch.float32, device=dev)
    zi = _slab_planes(z_rows, z0, z_idx, dev)
    if zi is None:
        zi = torch.arange(z_rows, **f32)
    zi = zi[:, None, None]                                 # [Zl,1,1]
    yi = torch.arange(Y, **f32)[None, :, None]             # [1,Y,1]

    def endpoint_cam(x_idx):                               # [1,1,NS]
        px = (origin[0] + h * x_idx).expand(z_rows, Y, NS)
        py = (origin[1] + h * yi).expand(z_rows, Y, NS)
        pz_w = (origin[2] + h * zi).expand(z_rows, Y, NS)
        return rot_apply(R, px - t[0], py - t[1], pz_w - t[2], transpose=True)

    sx = torch.arange(NS, **f32)[None, None, :] * S
    p0x, p0y, pz0 = endpoint_cam(sx)
    p1x, p1y, pz1 = endpoint_cam(sx + (S - 1))
    eps_z = 1e-5 * (pz0.abs() + pz1.abs()) + 1e-6
    both_behind = (pz0 <= eps_z - margin_t) & (pz1 <= eps_z - margin_t)
    both_front = (pz0 > eps_z) & (pz1 > eps_z)
    mixed = ~both_behind & ~both_front

    one = torch.ones_like(pz0)
    sz0 = torch.where(pz0 > 0, pz0, one)
    sz1 = torch.where(pz1 > 0, pz1, one)
    u0 = cx + fx * p0x / sz0
    u1 = cx + fx * p1x / sz1
    v0 = cy + fy * p0y / sz0
    v1 = cy + fy * p1y / sz1
    mu = 0.01 + 1e-5 * (u0.abs() + u1.abs()) + margin_px
    mv_ = 0.01 + 1e-5 * (v0.abs() + v1.abs()) + margin_px
    u_min = torch.minimum(u0, u1) - mu
    u_max = torch.maximum(u0, u1) + mu
    v_min = torch.minimum(v0, v1) - mv_
    v_max = torch.maximum(v0, v1) + mv_
    # exact in_img (after +0.5 int-cast rounding): -1.5 < u_f < W - 0.5
    img_possible = (
        (u_max > -1.5) & (u_min < W - 0.5) & (v_max > -1.5) & (v_min < H - 0.5)
    )

    # per-image-row max VALID depth + sparse table for range maxima
    neg_inf = torch.full_like(depth, -math.inf)
    z_valid = torch.where((depth > zmin) & (depth < zmax), depth, neg_inf)
    row_max = torch.max(z_valid, dim=1).values             # [H]
    levels = table_levels(H)
    st = [row_max]
    ar = torch.arange(H, device=dev)
    for l in range(1, levels):
        half = 1 << (l - 1)
        idx = torch.clamp(ar + half, max=H - 1)
        st.append(torch.maximum(st[-1], st[-1][idx]))
    flat = torch.stack(st).reshape(-1)                      # [L*H]

    v_lo = torch.clamp(torch.floor(v_min - 1.0), 0, H - 1).to(torch.int32)
    v_hi = torch.clamp(torch.ceil(v_max + 1.0), 0, H - 1).to(torch.int32)
    span = torch.clamp(v_hi - v_lo + 1, min=1)
    k = torch.clamp(
        torch.floor(torch.log2(span.to(torch.float32)) + 1e-6), 0, levels - 1
    ).to(torch.int32)
    pow_k = torch.bitwise_left_shift(torch.ones_like(k), k)
    q1 = flat[(k * H + v_lo).long()]
    q2 = flat[(k * H + torch.clamp(v_hi - pow_k + 1, min=0)).long()]
    z_fp_max = torch.maximum(q1, q2)
    z_fp_max = torch.where(mixed, torch.max(row_max), z_fp_max)

    pz_min = torch.minimum(pz0, pz1) - eps_z
    carve_ok = pz_min - truncation - margin_t <= z_fp_max   # -inf -> cull

    act = ~both_behind & (img_possible | mixed) & carve_ok
    if seg_x is None:
        return act[..., 0]            # [Zl, Y] — the row form
    return act                        # [Zl, Y, NS]


def compact_active_plain(active_flat: torch.Tensor, capacity: int):
    """Static-capacity compaction with no host sync: the indices of the first
    `capacity` True entries of active_flat [NSEG], ascending, padded with the
    fill value NSEG -> (rows_idx int64 [capacity], n_active int64 scalar).

    The same indices as a size-limited nonzero with a fill value: each active
    entry's rank (an exclusive prefix count) is its slot; entries ranked past
    the capacity, and inactive ones, all land in one spill slot beyond the
    end, which is cut off."""
    nseg = active_flat.shape[0]
    dev = active_flat.device
    csum = torch.cumsum(active_flat.to(torch.int64), dim=0)
    rank = csum - 1
    keep = active_flat & (rank < capacity)
    dest = torch.where(keep, rank, torch.full_like(rank, capacity))
    buf = torch.full((capacity + 1,), nseg, dtype=torch.int64, device=dev)
    buf.scatter_(0, dest, torch.arange(nseg, dtype=torch.int64, device=dev))
    return buf[:capacity], csum[-1]


def compact_padded_plain(active_flat: torch.Tensor, capacity: int):
    """Level-2 compaction with duplicate-first padding -> (safe_rows int32
    [capacity], live int64 scalar, overflow bool scalar).

    The capacity slots past the active rows repeat the FIRST compacted row:
    they gather it again, compute its update again (identical bytes) and
    may write it again, so the movement stays a pure indexed row copy and
    write order cannot matter.  `live` is the count of slots the scatter
    must write (the kernels skip the rest); with no active row at all, slot
    0 itself is padding (the grid's last row, whose update is the identity)
    and stays live."""
    nseg = active_flat.shape[0]
    rows_idx, n_active = compact_active_plain(active_flat, capacity)
    first = torch.clamp(rows_idx[0], max=nseg - 1)
    safe_rows = torch.where(rows_idx < nseg,
                            torch.clamp(rows_idx, max=nseg - 1), first)
    return (safe_rows.to(torch.int32).contiguous(),
            torch.clamp(n_active, min=1), n_active > capacity)


# ---------------------------------------------------------------------------
# argument checks and the library binding
# ---------------------------------------------------------------------------


class _CullArgs(ctypes.Structure):
    """csrc/cull.cu CullArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("depth", "K", "pose", "z_map", "gate", "out", "row_max")]
        + [(n, ctypes.c_int64) for n in
           ("H", "W", "levels", "z_rows", "Y", "S", "NS", "has_z0",
            "accumulate")]
        + [(n, ctypes.c_double) for n in
           ("z0", "origin_x", "origin_y", "origin_z", "voxel", "truncation",
            "zmin", "zmax", "margin_px", "margin_t")])


class _CompactArgs(ctypes.Structure):
    """csrc/cull.cu CompactArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("flags", "idx", "scalars", "overflow", "part")]
        + [(n, ctypes.c_int64) for n in
           ("n", "capacity", "idx64", "padded", "blocks")])


# the compaction's block: COMPACT_WARPS warps, a warp walking groups of 32
# flags (one ballot each)
COMPACT_WARPS = 16
CULL_THREADS = 512
# the shared-memory range-maximum table of levels x H floats, at most
MAX_TABLE_BYTES = 200 * 1024


def compact_blocks(n: int, sms: int) -> int:
    """Blocks of the compaction over n flags on `sms` SMs: one an SM at most
    (a cooperative launch), and no more than give each warp a group of 32
    flags."""
    groups = -(-n // 32)
    return max(1, min(sms, -(-groups // COMPACT_WARPS)))


def cull_blocks(H: int, nseg: int, sms: int) -> int:
    """Blocks of the cull: one an SM at most (a cooperative launch), enough
    for a warp an image row in the row maxima and a thread an entry of the
    mask where the SMs allow."""
    warps = CULL_THREADS // 32
    return max(1, min(sms, max(-(-H // warps), -(-nseg // CULL_THREADS))))


_bound = None


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        lib.row_activity.argtypes = [ctypes.POINTER(_CullArgs), ctypes.c_int,
                                     ctypes.c_void_p]
        lib.row_activity.restype = ctypes.c_int
        lib.compact_rows.argtypes = [ctypes.POINTER(_CompactArgs), ctypes.c_void_p]
        lib.compact_rows.restype = ctypes.c_int
        lib.barrier_floor.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.barrier_floor.restype = ctypes.c_int
        _bound = lib
    return _bound


def _sms(dev) -> int:
    from psgradientsdf_tpu_torch.kernels import sm_count

    return sm_count(dev)


def barrier_floor(dev, blocks: int, smem: int = 0) -> None:
    """An empty cooperative kernel of `blocks` blocks of the kernels' threads
    (and `smem` bytes of dynamic shared memory) crossing one grid barrier on
    `dev`: the latency floor of a cull or a compaction launch.  Timed by
    chip_smoke.py; counted nowhere, on no path."""
    rc = _library().barrier_floor(blocks, smem, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"barrier_floor: kernel launch failed, CUDA error {rc}")


def _launch(fn, args, *extra, dev, what):
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(args), *extra, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed, CUDA error {rc}")


def _check_flags(active_flat: torch.Tensor, capacity: int) -> None:
    if active_flat.dim() != 1 or active_flat.dtype != torch.bool:
        raise TypeError(f"compaction: flags must be a 1-D bool tensor, got "
                        f"{active_flat.dtype} {tuple(active_flat.shape)}")
    if active_flat.shape[0] < 1 or capacity < 0:
        raise ValueError(f"compaction: {active_flat.shape[0]} flags, capacity {capacity}")


def _compact_launch(active_flat: torch.Tensor, capacity: int, padded: bool):
    """One compact_rows launch -> (idx, scalars [n_active, live] int64,
    overflow bool scalar)."""
    dev = active_flat.device
    n = active_flat.shape[0]
    if n >= 2 ** 31 - 1 or capacity >= 2 ** 31 - 1:
        raise ValueError(f"compaction: {n} flags or capacity {capacity} past int32")
    lib = _library()
    flags = active_flat.contiguous()
    blocks = compact_blocks(n, _sms(dev))
    idx = torch.empty(capacity, dtype=torch.int32 if padded else torch.int64,
                      device=dev)
    scalars = torch.empty(2, dtype=torch.int64, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    part = torch.empty(2 * blocks, dtype=torch.int32, device=dev)
    a = _CompactArgs()
    a.flags, a.idx, a.scalars, a.overflow, a.part = (
        flags.data_ptr(), idx.data_ptr(), scalars.data_ptr(),
        overflow.data_ptr(), part.data_ptr())
    a.n, a.capacity, a.idx64, a.padded, a.blocks = (
        n, capacity, int(not padded), int(padded), blocks)
    _launch(lib.compact_rows, a, dev=dev, what="compact_rows")
    launch_counts["compact_rows"] += 1
    return idx, scalars, overflow


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def row_activity(
    geom: GridGeometry,
    depth: torch.Tensor,
    K: torch.Tensor,
    pose: torch.Tensor,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    z0: Optional[int] = None,
    z_rows: Optional[int] = None,
    z_idx: Optional[torch.Tensor] = None,
    seg_x: Optional[int] = None,
    margin_px: float = 0.0,
    margin_t: float = 0.0,
    gate: Optional[torch.Tensor] = None,
    union: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The level-1 cull (row_activity_plain), ANDed with `gate` and ORed
    into `union` in place when given: one kernel launch on CUDA tensors, the
    plain version on CPU tensors."""
    kw = dict(truncation=truncation, zmin=zmin, zmax=zmax, z0=z0,
              z_rows=z_rows, z_idx=z_idx, seg_x=seg_x, margin_px=margin_px,
              margin_t=margin_t)
    if depth.device.type == "cpu":
        act = row_activity_plain(geom, depth, K, pose, **kw)
        if gate is not None:
            act = act & gate
        if union is not None:
            union |= act
            return union
        return act
    dev = depth.device
    H, W = depth.shape
    X, Y, Zd = geom.dims
    zr = Zd if z_rows is None else z_rows
    S = X if seg_x is None else seg_x
    if X % S != 0:
        raise ValueError(f"row_activity: seg_x={S} must divide X={X}")
    NS = X // S
    shape = (zr, Y) if seg_x is None else (zr, Y, NS)
    levels = table_levels(H)
    if levels * H * 4 > MAX_TABLE_BYTES:
        raise ValueError(f"row_activity: a {H}-row image's range table "
                         f"({levels} x {H} floats) does not fit shared memory")
    for name, t, dt in (("depth", depth, torch.float32), ("K", K, torch.float32),
                        ("pose", pose, torch.float32)):
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"row_activity: {name} must be {dt} on {dev}")
    if tuple(K.shape) != (3, 3) or tuple(pose.shape) != (4, 4):
        raise ValueError("row_activity: K must be [3, 3] and pose [4, 4]")
    if gate is not None and (gate.dtype != torch.bool or gate.numel() != 1
                             or gate.device != dev):
        raise TypeError(f"row_activity: gate must be one bool on {dev}")
    if union is not None:
        if (tuple(union.shape) != shape or union.dtype != torch.bool
                or union.device != dev or not union.is_contiguous()):
            raise ValueError(f"row_activity: union must be a contiguous bool "
                             f"{shape} on {dev}")
        out = union
    else:
        out = torch.empty(shape, dtype=torch.bool, device=dev)
    z_map = None
    if z_idx is not None:
        if z_idx.shape[0] != zr:
            raise ValueError(f"row_activity: z_idx has {z_idx.shape[0]} planes, "
                             f"z_rows {zr}")
        z_map = z_idx.to(dev, torch.float32).contiguous()
    depth, K, pose = depth.contiguous(), K.contiguous(), pose.contiguous()
    row_max = torch.empty(H, dtype=torch.float32, device=dev)
    lib = _library()
    a = _CullArgs()
    a.depth, a.K, a.pose, a.out, a.row_max = (
        depth.data_ptr(), K.data_ptr(), pose.data_ptr(), out.data_ptr(),
        row_max.data_ptr())
    a.z_map = None if z_map is None else z_map.data_ptr()
    a.gate = None if gate is None else gate.data_ptr()
    a.H, a.W, a.levels, a.z_rows, a.Y, a.S, a.NS = H, W, levels, zr, Y, S, NS
    a.has_z0, a.z0 = int(z0 is not None), float(z0 or 0)
    a.accumulate = int(union is not None)
    a.origin_x, a.origin_y, a.origin_z = geom.origin
    a.voxel, a.truncation, a.zmin, a.zmax, a.margin_px, a.margin_t = (
        geom.voxel_size, truncation, zmin, zmax, margin_px, margin_t)
    blocks = cull_blocks(H, out.numel(), _sms(dev))
    _launch(lib.row_activity, a, blocks, dev=dev, what="row_activity")
    launch_counts["row_activity"] += 1
    return out


def compact_active(active_flat: torch.Tensor, capacity: int):
    """compact_active_plain's contract (fill value NSEG, int64 indices):
    one kernel launch on CUDA tensors, the plain version on CPU tensors."""
    _check_flags(active_flat, capacity)
    if active_flat.device.type == "cpu":
        return compact_active_plain(active_flat, capacity)
    idx, scalars, _ = _compact_launch(active_flat, capacity, padded=False)
    return idx, scalars[0]


def compact_padded(active_flat: torch.Tensor, capacity: int):
    """compact_padded_plain's contract (duplicate-first padding, int32
    indices, live and overflow): one kernel launch on CUDA tensors, the
    plain version on CPU tensors."""
    _check_flags(active_flat, capacity)
    if active_flat.device.type == "cpu":
        return compact_padded_plain(active_flat, capacity)
    idx, scalars, overflow = _compact_launch(active_flat, capacity, padded=True)
    return idx, scalars[1], overflow
