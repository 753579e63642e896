"""The culled fusion's level-1 cull and level-2 compaction: ONE launch of
the hand-written Hopper kernel in csrc/cull.cu (`cull_compact_kernel`), or
their plain PyTorch versions for CPU tensors.

  cull_compact(geom, depths, K, poses, *, capacity, padded, truncation,
               zmin, zmax, z0=, z_rows=, z_idx=, seg_x=, margin_px=,
               margin_t=, gates=, allow=, mask=)
      -> Culled(idx, n_active, live, overflow, mask)
  row_activity(geom, depth, K, pose, *, truncation, zmin, zmax, z0=,
               z_rows=, z_idx=, seg_x=, margin_px=, margin_t=, gate=,
               union=) -> bool [z_rows, Y] (rows) or [z_rows, Y, X/seg_x]
  compact_active(active_flat, capacity) -> (idx int64 [capacity],
                                            n_active int64 scalar)
  compact_padded(active_flat, capacity) -> (idx int32 [capacity],
                                            live int64 scalar,
                                            overflow bool scalar)

They replace the JAX package's psgradientsdf_tpu/core/volume.py
`_row_activity` (:252), the `jnp.nonzero(active_flat, size=row_capacity,
fill_value=NSEG)` compaction with its duplicate-first padding inside
`_fuse_culled_slab` (:513-528), both parts of the one device program
`fuse_frame_culled` (:396), and the K-frame union of `fuse_frames_culled`
(:679-728).

cull_compact culls K frames (depths [K, H, W] and poses [K, 4, 4], or one
frame: [H, W] and [4, 4]), ANDs each frame's mask with its gate (`gates`:
bools on the device, one a frame), ORs the frames' masks, ANDs `allow` (a
bool [n] on the device, n the mask's entries) in, and compacts the result
to `capacity` slots: padded=True gives compact_padded's contract (int32,
duplicate-first padding), padded=False compact_active's (int64, fill value
n).  The mask leaves the kernel only with mask=True; a capacity of 0 counts
only.  row_activity is the cull alone (its mask ORed into `union` in place
when one is given), compact_active / compact_padded the compaction of a
caller's flags: each is one launch of the same kernel on the card.  The
kernel equals the plain versions bit for bit on the card: the same float
operations in the same order, each rounded once, and the same indices and
scalars.

A wrapper takes the plain version ONLY for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  `launch_counts` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional

import torch

from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.ops.fuse import rot_apply

_LIB_NAME = "cull"
launch_counts: Dict[str, int] = {"cull_compact": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class Culled(NamedTuple):
    """What a cull and compaction leaves on the device."""

    idx: torch.Tensor        # [capacity] int32 (padded) or int64 (fill n)
    n_active: torch.Tensor   # int64 scalar: the set entries
    live: torch.Tensor       # int64 scalar: max(n_active, 1)
    overflow: torch.Tensor   # bool scalar: n_active > capacity
    mask: Optional[torch.Tensor]   # the mask's shape, with mask=True


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


def _frames(depths: torch.Tensor, poses: torch.Tensor, gates):
    """One frame or K: depths [K, H, W], poses [K, 4, 4], gates [K] or
    None."""
    if depths.dim() == 2:
        depths = depths[None]
    if poses.dim() == 2:
        poses = poses[None]
    if depths.dim() != 3 or tuple(poses.shape) != (depths.shape[0], 4, 4):
        raise ValueError(f"cull: depths {tuple(depths.shape)} and poses "
                         f"{tuple(poses.shape)} are not K frames [K, H, W], [K, 4, 4]")
    if gates is not None:
        gates = gates.reshape(-1)
        if gates.shape[0] != depths.shape[0]:
            raise ValueError(f"cull: {gates.shape[0]} gates for "
                             f"{depths.shape[0]} frames")
    return depths, poses, gates


def _counted_only(flat: torch.Tensor, capacity: int, padded: bool):
    """A compaction of capacity 0: no slot, the scalars only."""
    n_active = torch.sum(flat, dtype=torch.int64)
    idx = torch.empty(0, dtype=torch.int32 if padded else torch.int64,
                      device=flat.device)
    return idx, n_active


def cull_compact_plain(
    geom: GridGeometry,
    depths: torch.Tensor,
    K: torch.Tensor,
    poses: torch.Tensor,
    *,
    capacity: int,
    padded: bool,
    truncation: float,
    zmin: float,
    zmax: float,
    z0: Optional[int] = None,
    z_rows: Optional[int] = None,
    z_idx: Optional[torch.Tensor] = None,
    seg_x: Optional[int] = None,
    margin_px: float = 0.0,
    margin_t: float = 0.0,
    gates: Optional[torch.Tensor] = None,
    allow: Optional[torch.Tensor] = None,
    mask: bool = False,
) -> Culled:
    """cull_compact's plain version: the K frames' plain culls, each ANDed
    with its gate, ORed; `allow` ANDed in; then compact_padded_plain or
    compact_active_plain (a capacity of 0 counts only)."""
    depths, poses, gates = _frames(depths, poses, gates)
    act = None
    for k in range(depths.shape[0]):
        a = row_activity_plain(
            geom, depths[k], K, poses[k], truncation=truncation, zmin=zmin,
            zmax=zmax, z0=z0, z_rows=z_rows, z_idx=z_idx, seg_x=seg_x,
            margin_px=margin_px, margin_t=margin_t)
        if gates is not None:
            a = a & gates[k]
        act = a if act is None else act | a
    flat = act.reshape(-1)
    if allow is not None:
        flat = flat & allow.reshape(-1)
    if capacity == 0:
        idx, n_active = _counted_only(flat, capacity, padded)
    elif padded:
        idx, _, _ = compact_padded_plain(flat, capacity)
        n_active = torch.sum(flat, dtype=torch.int64)
    else:
        idx, n_active = compact_active_plain(flat, capacity)
    return Culled(idx, n_active, torch.clamp(n_active, min=1), n_active > capacity,
                  flat.view(act.shape) if mask else None)


# ---------------------------------------------------------------------------
# the launch plan, argument checks and the library binding
# ---------------------------------------------------------------------------


class _CullCompactArgs(ctypes.Structure):
    """csrc/cull.cu CullCompactArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("depth", "K", "pose", "z_map", "gates", "flags", "allow", "mask",
          "idx", "scalars", "scratch")]
        + [(n, ctypes.c_int64) for n in
           ("cull", "frames", "H", "W", "levels", "n", "Y", "S", "NS", "has_z0",
            "accumulate", "capacity", "idx64", "padded", "blocks",
            "frames_per_pass")]
        + [(n, ctypes.c_double) for n in
           ("z0", "origin_x", "origin_y", "origin_z", "voxel", "truncation",
            "zmin", "zmax", "margin_px", "margin_t")])


# the kernel's block: WARPS warps of 32 threads, a thread an entry, a warp's
# ballot a 32-entry group (one mask word)
WARPS = 16
# a block's dynamic shared memory (the run's mask words, then a pass's range
# tables of levels x H floats each), at most; the frames a pass, at most
MAX_SHARED_BYTES = 200 * 1024
MAX_PASS = 16


def cull_compact_blocks(H: int, K: int, n: int, sms: int) -> int:
    """Blocks of the launch over n entries (and, culling, K frames of H image
    rows; H = K = 0 for the compaction alone) on `sms` SMs: one an SM at most
    (a cooperative launch), and no more than give each warp a 32-entry group
    of the mask or an image row of the row maxima."""
    groups = -(-n // 32)
    return max(1, min(sms, max(-(-groups // WARPS), -(-(K * H) // WARPS))))


def cull_compact_run(n: int, blocks: int) -> int:
    """The entries a block owns: its share of n in whole 32-entry groups
    (csrc/cull.cu computes the same)."""
    share = -(-n // blocks)
    return -(-share // 32) * 32


def cull_compact_pass(H: int, K: int, n: int, blocks: int) -> int:
    """The frames a pass of the cull builds the range tables of, side by
    side: as many of the K as shared memory holds beside the run's words
    (at least one, at most MAX_PASS); 0 for the compaction alone (K = 0)."""
    if K == 0:
        return 0
    room = MAX_SHARED_BYTES // 4 - cull_compact_run(n, blocks) // 32
    return max(1, min(K, MAX_PASS, room // (table_levels(H) * H)))


def cull_compact_smem(H: int, K: int, n: int, blocks: int) -> int:
    """A block's dynamic shared memory in bytes: the run's mask words and,
    culling (K frames of H rows), a pass's range tables."""
    tables = cull_compact_pass(H, K, n, blocks) * table_levels(H) * H if K else 0
    return (cull_compact_run(n, blocks) // 32 + tables) * 4


_bound = None


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        lib.cull_compact.argtypes = [ctypes.POINTER(_CullCompactArgs), ctypes.c_void_p]
        lib.cull_compact.restype = ctypes.c_int
        lib.barrier_floor.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
        lib.barrier_floor.restype = ctypes.c_int
        _bound = lib
    return _bound


def _sms(dev) -> int:
    from psgradientsdf_tpu_torch.kernels import sm_count

    return sm_count(dev)


def barrier_floor(dev, blocks: int, smem: int = 0, barriers: int = 1) -> None:
    """An empty cooperative kernel of `blocks` blocks of the kernel's threads
    (and `smem` bytes of dynamic shared memory) crossing `barriers` grid
    barriers on `dev`: the latency floor of a cull_compact launch (two
    barriers; one for the compaction alone).  Timed by chip_smoke.py;
    counted nowhere, on no path."""
    rc = _library().barrier_floor(blocks, smem, barriers,
                                  torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"barrier_floor: kernel launch failed, CUDA error {rc}")


def _check_flags(active_flat: torch.Tensor, capacity: int) -> None:
    if active_flat.dim() != 1 or active_flat.dtype != torch.bool:
        raise TypeError(f"compaction: flags must be a 1-D bool tensor, got "
                        f"{active_flat.dtype} {tuple(active_flat.shape)}")
    if active_flat.shape[0] < 1 or capacity < 0:
        raise ValueError(f"compaction: {active_flat.shape[0]} flags, capacity {capacity}")


def _cull_fields(a, geom, depths, K, poses, gates, *, z0, z_rows, z_idx, seg_x,
                 truncation, zmin, zmax, margin_px, margin_t):
    """The cull's fields of the argument block, checked -> (the mask's
    shape, the tensors the launch reads, kept alive until it is enqueued)."""
    dev = depths.device
    depths, poses, gates = _frames(depths, poses, gates)
    KF, H, W = depths.shape
    X, Y, Zd = geom.dims
    zr = Zd if z_rows is None else z_rows
    S = X if seg_x is None else seg_x
    if X % S != 0:
        raise ValueError(f"cull: seg_x={S} must divide X={X}")
    NS = X // S
    for name, t in (("depths", depths), ("K", K), ("poses", poses)):
        if t.dtype != torch.float32 or t.device != dev:
            raise TypeError(f"cull: {name} must be float32 on {dev}")
    if tuple(K.shape) != (3, 3):
        raise ValueError("cull: K must be [3, 3]")
    if gates is not None and (gates.dtype != torch.bool or gates.device != dev):
        raise TypeError(f"cull: gates must be bools on {dev}")
    z_map = None
    if z_idx is not None:
        if z_idx.shape[0] != zr:
            raise ValueError(f"cull: z_idx has {z_idx.shape[0]} planes, z_rows {zr}")
        z_map = z_idx.to(dev, torch.float32).contiguous()
    keep = [t.contiguous() for t in (depths, K, poses)]
    if gates is not None:
        keep.append(gates.contiguous())
    a.depth, a.K, a.pose = (t.data_ptr() for t in keep[:3])
    a.gates = None if gates is None else keep[3].data_ptr()
    a.z_map = None if z_map is None else z_map.data_ptr()
    a.cull, a.frames, a.H, a.W, a.levels = 1, KF, H, W, table_levels(H)
    a.Y, a.S, a.NS = Y, S, NS
    a.has_z0, a.z0 = int(z0 is not None), float(z0 or 0)
    a.origin_x, a.origin_y, a.origin_z = geom.origin
    a.voxel, a.truncation, a.zmin, a.zmax, a.margin_px, a.margin_t = (
        geom.voxel_size, truncation, zmin, zmax, margin_px, margin_t)
    shape = (zr, Y) if seg_x is None else (zr, Y, NS)
    return shape, keep + [z_map]


def _launch(a, dev, n: int, *, capacity: int, padded: bool,
            allow: Optional[torch.Tensor], mask_out: Optional[torch.Tensor],
            accumulate: bool) -> Culled:
    """The argument block's common fields, the outputs, ONE launch ->
    Culled (its mask: mask_out).  The caller holds the tensors the block
    points at until this returns (the launch is then enqueued)."""
    if n >= 2 ** 31 - 1 or capacity >= 2 ** 31 - 1:
        raise ValueError(f"cull: {n} entries or capacity {capacity} past int32")
    frames, H = a.frames, a.H                  # 0 for the compaction alone
    blocks = cull_compact_blocks(H, frames, n, _sms(dev))
    smem = cull_compact_smem(H, frames, n, blocks)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"cull: a block's table and mask words ({smem} bytes: "
                         f"{H} image rows, {n} entries on {blocks} blocks) do "
                         "not fit shared memory")
    if allow is not None:
        if (allow.dtype != torch.bool or allow.numel() != n or allow.device != dev):
            raise ValueError(f"cull: allow must be {n} bools on {dev}")
        allow = allow.contiguous()
    lib = _library()
    idx = torch.empty(capacity, dtype=torch.int32 if padded else torch.int64, device=dev)
    meta = torch.empty(3, dtype=torch.int64, device=dev)    # n_active, live, overflow
    scratch = torch.empty(frames * H + 2 * blocks, dtype=torch.int32, device=dev)
    a.allow = None if allow is None else allow.data_ptr()
    a.mask = None if mask_out is None else mask_out.data_ptr()
    a.idx, a.scalars, a.scratch = idx.data_ptr(), meta.data_ptr(), scratch.data_ptr()
    a.n, a.capacity, a.idx64, a.padded, a.blocks = (
        n, capacity, int(not padded), int(padded), blocks)
    a.frames_per_pass = cull_compact_pass(H, frames, n, blocks)
    a.accumulate = int(accumulate)
    with torch.cuda.device(dev):
        rc = lib.cull_compact(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cull_compact: kernel launch failed, CUDA error {rc}")
    launch_counts["cull_compact"] += 1
    return Culled(idx, meta[0], meta[1], meta.view(torch.bool)[16], mask_out)


def _compact_launch(active_flat: torch.Tensor, capacity: int, padded: bool) -> Culled:
    """The compaction alone of a flag array: one launch of
    cull_compact_kernel<false>."""
    _library()
    flags = active_flat.contiguous()
    a = _CullCompactArgs()
    a.flags = flags.data_ptr()
    return _launch(a, flags.device, flags.shape[0], capacity=capacity,
                   padded=padded, allow=None, mask_out=None, accumulate=False)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def cull_compact(
    geom: GridGeometry,
    depths: torch.Tensor,
    K: torch.Tensor,
    poses: torch.Tensor,
    *,
    capacity: int,
    padded: bool,
    truncation: float,
    zmin: float,
    zmax: float,
    z0: Optional[int] = None,
    z_rows: Optional[int] = None,
    z_idx: Optional[torch.Tensor] = None,
    seg_x: Optional[int] = None,
    margin_px: float = 0.0,
    margin_t: float = 0.0,
    gates: Optional[torch.Tensor] = None,
    allow: Optional[torch.Tensor] = None,
    mask: bool = False,
) -> Culled:
    """The K frames' gated culls ORed, `allow` ANDed in, compacted to
    `capacity` slots (see the module docstring): ONE kernel launch on CUDA
    tensors, cull_compact_plain on CPU tensors."""
    kw = dict(truncation=truncation, zmin=zmin, zmax=zmax, z0=z0, z_rows=z_rows,
              z_idx=z_idx, seg_x=seg_x, margin_px=margin_px, margin_t=margin_t)
    if capacity < 0:
        raise ValueError(f"cull: capacity {capacity}")
    if depths.device.type == "cpu":
        return cull_compact_plain(geom, depths, K, poses, capacity=capacity,
                                  padded=padded, gates=gates, allow=allow,
                                  mask=mask, **kw)
    _library()                         # built (or refused) before any pointer
    a = _CullCompactArgs()
    shape, keep = _cull_fields(a, geom, depths, K, poses, gates, **kw)
    out = torch.empty(shape, dtype=torch.bool, device=depths.device) if mask else None
    culled = _launch(a, depths.device, math.prod(shape), capacity=capacity,
                     padded=padded, allow=allow, mask_out=out, accumulate=False)
    del keep
    return culled


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
    into `union` in place when given: one kernel launch on CUDA tensors (a
    cull_compact of capacity 0 that writes its mask), the plain version on
    CPU tensors."""
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
    if depth.dim() != 2 or tuple(pose.shape) != (4, 4):
        raise ValueError("row_activity: one frame, depth [H, W] and pose [4, 4]")
    if gate is not None and gate.numel() != 1:
        raise TypeError("row_activity: gate must be one bool")
    _library()
    a = _CullCompactArgs()
    shape, keep = _cull_fields(a, geom, depth, K, pose, gate, **kw)
    dev = depth.device
    if union is not None:
        if (tuple(union.shape) != shape or union.dtype != torch.bool
                or union.device != dev or not union.is_contiguous()):
            raise ValueError(f"row_activity: union must be a contiguous bool "
                             f"{shape} on {dev}")
        out = union
    else:
        out = torch.empty(shape, dtype=torch.bool, device=dev)
    _launch(a, dev, out.numel(), capacity=0, padded=False,
            allow=None, mask_out=out, accumulate=union is not None)
    del keep
    return out


def compact_active(active_flat: torch.Tensor, capacity: int):
    """compact_active_plain's contract (fill value NSEG, int64 indices):
    one kernel launch on CUDA tensors, the plain version on CPU tensors."""
    _check_flags(active_flat, capacity)
    if active_flat.device.type == "cpu":
        return compact_active_plain(active_flat, capacity)
    c = _compact_launch(active_flat, capacity, padded=False)
    return c.idx, c.n_active


def compact_padded(active_flat: torch.Tensor, capacity: int):
    """compact_padded_plain's contract (duplicate-first padding, int32
    indices, live and overflow): one kernel launch on CUDA tensors, the
    plain version on CPU tensors (which cannot take a capacity of 0; the
    kernel can)."""
    _check_flags(active_flat, capacity)
    if active_flat.device.type == "cpu":
        return compact_padded_plain(active_flat, capacity)
    c = _compact_launch(active_flat, capacity, padded=True)
    return c.idx, c.live, c.overflow
