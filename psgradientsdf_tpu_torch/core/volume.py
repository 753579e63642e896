"""Gradient-SDF volume: SoA tensors + the volumetric fusion (scan subset).

Redesign of VolumetricGradSdf (cpp/include/sdf_tracker/
VolumetricGradSdf.{h,cpp}) as five dense tensors, in the JAX package's
layouts:

    dist    [Z,Y,X]     truncated signed distance (negative inside)
    grad    [Z,Y,X,3]   accumulated (unnormalized) Gradient-SDF gradient
    weight  [Z,Y,X]     fusion confidence
    color   [Z,Y,X,3]   running-mean RGB
    vis     [W,Z,Y,X]   bit-packed per-frame visibility, int32 BIT PATTERNS
                        of the JAX package's uint32 words (bit f%32 of word
                        f//32 == "voxel updated in frame f"; frame bit 31 is
                        the sign bit).  torch has little uint32 arithmetic,
                        so the words stay int32 on the device and are viewed
                        as uint32 at the numpy boundary (convert.py).

Fusion (`fuse_frame`) evaluates the reference's per-voxel update
(VolumetricGradSdf.cpp:51-138) for all voxels: transform to camera, project
to the nearest pixel, gate (z-range / fusion weight / normal validity /
viewing angle), then masked running-mean updates.  `fuse_frame_culled` does
the same on the rows that survive a conservative cull, moving their state
rows with the row-copy kernels (ops/rowcopy.py).

Nothing in the fusion functions reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from psgradientsdf_tpu_torch import resolve_device
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.ops import rowcopy

ROWS_IMPLS = ("dma", "staged", "plain")


class GradSdfVolume(NamedTuple):
    dist: torch.Tensor      # [Z,Y,X] f32
    grad: torch.Tensor      # [Z,Y,X,3] f32
    weight: torch.Tensor    # [Z,Y,X] f32
    color: torch.Tensor     # [Z,Y,X,3] f32
    vis: torch.Tensor       # [W,Z,Y,X] int32 bit patterns of uint32 words

    def clone(self) -> "GradSdfVolume":
        return GradSdfVolume(*(t.clone() for t in self))


def make_volume(geom: GridGeometry, truncation: float, frame_cap: int = 256,
                device=None) -> GradSdfVolume:
    """Fresh volume: dist = +T everywhere (VolumetricGradSdf.cpp:14-38)."""
    dev = resolve_device(device)
    zyx = geom.shape_zyx
    n_words = (frame_cap + 31) // 32
    f32 = dict(dtype=torch.float32, device=dev)
    return GradSdfVolume(
        dist=torch.full(zyx, truncation, **f32),
        grad=torch.zeros(zyx + (3,), **f32),
        weight=torch.zeros(zyx, **f32),
        color=torch.zeros(zyx + (3,), **f32),
        vis=torch.zeros((n_words,) + zyx, dtype=torch.int32, device=dev),
    )


def fusion_weight(sdf: torch.Tensor, T: float) -> torch.Tensor:
    """Asymmetric fusion weight (Sdf.h:48-66): 1 in front of the surface
    (sdf >= 0), linear ramp 1 + sdf/T on [-T, 0), 0 behind."""
    one = torch.ones_like(sdf)
    return torch.where(
        sdf >= 0.0, one,
        torch.where(sdf >= -T, 1.0 + sdf / T, torch.zeros_like(sdf)))


def _vis_word_bit(frame_idx: int) -> Tuple[int, int]:
    """(word, bit value as an int32 bit pattern) for a frame's visibility
    bit; bit 31 is the sign bit of the int32 word."""
    frame_idx = int(frame_idx)
    b = frame_idx % 32
    bit = 1 << b
    if b == 31:
        bit -= 1 << 32
    return frame_idx // 32, bit


def _rot_apply(R: torch.Tensor, x, y, z, transpose: bool):
    """(R or R^T) applied to the vector field (x, y, z), written out as
    multiply-adds in a fixed order so every caller and every device rounds
    alike (no library matrix product on the fusion path)."""
    if transpose:
        return (R[0, 0] * x + R[1, 0] * y + R[2, 0] * z,
                R[0, 1] * x + R[1, 1] * y + R[2, 1] * z,
                R[0, 2] * x + R[1, 2] * y + R[2, 2] * z)
    return (R[0, 0] * x + R[0, 1] * y + R[0, 2] * z,
            R[1, 0] * x + R[1, 1] * y + R[1, 2] * z,
            R[2, 0] * x + R[2, 1] * y + R[2, 2] * z)


def _fuse_voxel_update(
    p_w: torch.Tensor,        # [...,3] voxel-center world coords
    dist: torch.Tensor,       # [...] current state (same leading shape)
    grad: torch.Tensor,       # [...,3]
    weight: torch.Tensor,     # [...]
    color_v: torch.Tensor,    # [...,3]
    pix_payload: torch.Tensor,  # [H*W,8] packed (depth, normal, color, nsq)
    K: torch.Tensor,
    pose: torch.Tensor,
    img_hw: Tuple[int, int],
    bit: int,                 # visibility bit value (int32 bit pattern)
    gate: Optional[torch.Tensor],
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float,
):
    """The per-voxel fusion update (VolumetricGradSdf.cpp:78-134) on an
    arbitrary-shaped batch of voxels — shared verbatim by the full-grid
    function (fuse_frame) and the row-culled one (fuse_frame_culled), so the
    two are arithmetically identical by construction.

    Returns (new_dist, new_grad, new_weight, new_color, vis_or [int32])."""
    H, W = img_hw
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    R = pose[:3, :3]
    t = pose[:3, 3]

    d = p_w - t
    pcx, pcy, pz = _rot_apply(R, d[..., 0], d[..., 1], d[..., 2], transpose=True)
    in_front = pz > 0.0

    safe_z = torch.where(in_front, pz, torch.ones_like(pz))
    # nearest-pixel projection with +0.5 rounding via int cast
    # (VolumetricGradSdf.cpp:87-88 static_cast<int> truncates toward zero,
    # which accepts the [-0.5, 0) sliver as pixel 0 — floor would not)
    u = (cx + fx * pcx / safe_z + 0.5).to(torch.int32)
    v = (cy + fy * pcy / safe_z + 0.5).to(torch.int32)
    in_img = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    uc = torch.clamp(u, 0, W - 1)
    vc = torch.clamp(v, 0, H - 1)

    # all eight per-pixel quantities ride ONE row gather of a packed payload
    rows = pix_payload[(vc * W + uc).long()]            # [...,8]
    z = rows[..., 0]
    n_img = rows[..., 1:4]
    col = rows[..., 4:7]
    nsq = rows[..., 7]

    z_ok = (z > zmin) & (z < zmax)

    sdf = z - pz
    w = fusion_weight(sdf, truncation)

    nx, ny, nz = n_img[..., 0], n_img[..., 1], n_img[..., 2]
    n_valid = (nx * nx + ny * ny + nz * nz) >= 0.1

    # viewing-angle gate: cos^2(angle between normal and ray) >= cos_thresh_sq
    # (VolumetricGradSdf.cpp:114-116)
    ndot = nx * (pcx / safe_z) + ny * (pcy / safe_z) + nz * (pz / safe_z)
    angle_ok = ndot * ndot * nsq >= cos_thresh_sq

    mask = in_front & in_img & z_ok & (w > 0.0) & n_valid & angle_ok
    if gate is not None:
        mask = mask & gate
    wm = torch.where(mask, w, torch.zeros_like(w))

    new_weight = weight + wm
    safe_W = torch.clamp(new_weight, min=1e-12)
    tr_sdf = torch.clamp(sdf, -truncation, truncation)
    new_dist = dist + (tr_sdf - dist) * wm / safe_W
    # normals are inward-pointing -> accumulate -w * R * n (cpp:123)
    nwx, nwy, nwz = _rot_apply(R, nx, ny, nz, transpose=False)
    n_world = torch.stack([nwx, nwy, nwz], dim=-1)
    new_grad = grad - wm[..., None] * n_world
    new_color = color_v + (col - color_v) * (wm / safe_W)[..., None]
    vis_or = mask.to(torch.int32) * bit
    return new_dist, new_grad, new_weight, new_color, vis_or


def pack_pixel_payload(color, depth, normals, n_sq_inv) -> torch.Tensor:
    """[H*W,8] packed per-pixel fusion payload (one row-gatherable table)."""
    H, W = depth.shape
    return torch.cat(
        [depth[..., None], normals, color, n_sq_inv[..., None]], dim=-1
    ).reshape(H * W, 8)


def _on(dev, *xs):
    """Inputs as float32 tensors on `dev` (numpy arrays are uploaded)."""
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev) for x in xs)


def _gate_tensor(gate, dev) -> Optional[torch.Tensor]:
    if gate is None:
        return None
    return torch.as_tensor(gate, dtype=torch.bool, device=dev)


def fuse_frame(
    vol: GradSdfVolume,
    geom: GridGeometry,
    color,                 # [H,W,3] RGB in [0,1]
    depth,                 # [H,W] meters
    normals,               # [H,W,3] unit inward normals (FALS)
    n_sq_inv,              # [H,W] cached 1/(1+x0^2+y0^2) from the FALS cache
    K,                     # [3,3]
    pose,                  # [4,4] camera-to-world
    frame_idx: int,        # visibility bit to set (a host integer)
    gate=None,             # scalar bool (tensor) — False => no-op update
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float = 0.25 * 0.25,
    device=None,
) -> GradSdfVolume:
    """One fused depth/color frame (VolumetricGradSdf.cpp:51-138) over the
    whole grid.  Functional: returns a new volume, `vol` is left as it was.

    `gate` makes the whole update a masked no-op when False, without the
    host having to read the flag."""
    dev = resolve_device(device)
    color, depth, normals, n_sq_inv, K, pose = _on(
        dev, color, depth, normals, n_sq_inv, K, pose)
    gate = _gate_tensor(gate, dev)
    H, W = depth.shape
    pix_payload = pack_pixel_payload(color, depth, normals, n_sq_inv)
    p_w = geom.world_coords(dev)                      # [Z,Y,X,3]

    word, bit = _vis_word_bit(frame_idx)
    new_dist, new_grad, new_weight, new_color, vis_or = _fuse_voxel_update(
        p_w, vol.dist, vol.grad, vol.weight, vol.color, pix_payload, K, pose,
        (H, W), bit, gate,
        truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq,
    )
    new_vis = vol.vis.clone()
    new_vis[word] |= vis_or
    return GradSdfVolume(
        dist=new_dist, grad=new_grad, weight=new_weight, color=new_color,
        vis=new_vis)


def _row_activity(
    geom: GridGeometry,
    depth: torch.Tensor,
    K: torch.Tensor,
    pose: torch.Tensor,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    seg_x: Optional[int] = None,      # X-segment length (None = whole row)
) -> torch.Tensor:
    """Level-1 cull of fuse_frame_culled: conservative activity mask at
    X-row granularity ([Z, Y], seg_x=None) or X-SEGMENT granularity
    ([Z, Y, X//seg_x]) — the endpoint bounds are exact for any x interval
    (u, v are Moebius in x with constant derivative sign where pz > 0), so
    segments just evaluate them at the segment ends.

    A row is culled if (a) it lies entirely behind the camera, (b) its
    projected interval misses the image, or (c) it lies more than the
    truncation behind every observable depth in its v-footprint (a
    per-image-row max table with a sparse table for O(1) range maxima).  All
    tests carry float-safety margins, so the mask is a strict SUPERSET of
    the active set.  Same arithmetic, in the same order, as the JAX package's
    _row_activity: the two masks are compared exactly in the tests."""
    dev = depth.device
    H, W = depth.shape
    X, Y, Zd = geom.dims
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
    zi = torch.arange(Zd, **f32)[:, None, None]            # [Z,1,1]
    yi = torch.arange(Y, **f32)[None, :, None]             # [1,Y,1]

    def endpoint_cam(x_idx):                               # [1,1,NS]
        px = (origin[0] + h * x_idx).expand(Zd, Y, NS)
        py = (origin[1] + h * yi).expand(Zd, Y, NS)
        pz_w = (origin[2] + h * zi).expand(Zd, Y, NS)
        return _rot_apply(R, px - t[0], py - t[1], pz_w - t[2], transpose=True)

    sx = torch.arange(NS, **f32)[None, None, :] * S
    p0x, p0y, pz0 = endpoint_cam(sx)
    p1x, p1y, pz1 = endpoint_cam(sx + (S - 1))
    eps_z = 1e-5 * (pz0.abs() + pz1.abs()) + 1e-6
    both_behind = (pz0 <= eps_z) & (pz1 <= eps_z)
    both_front = (pz0 > eps_z) & (pz1 > eps_z)
    mixed = ~both_behind & ~both_front

    one = torch.ones_like(pz0)
    sz0 = torch.where(pz0 > 0, pz0, one)
    sz1 = torch.where(pz1 > 0, pz1, one)
    u0 = cx + fx * p0x / sz0
    u1 = cx + fx * p1x / sz1
    v0 = cy + fy * p0y / sz0
    v1 = cy + fy * p1y / sz1
    mu = 0.01 + 1e-5 * (u0.abs() + u1.abs())
    mv_ = 0.01 + 1e-5 * (v0.abs() + v1.abs())
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
    levels = max(1, (H - 1).bit_length())
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
    carve_ok = pz_min - truncation <= z_fp_max              # -inf -> cull

    act = ~both_behind & (img_possible | mixed) & carve_ok
    if seg_x is None:
        return act[..., 0]            # [Z, Y] — the row form
    return act                        # [Z, Y, NS]


def count_active_rows(
    geom: GridGeometry,
    depth,
    K,
    pose,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    seg_x: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Number of rows (or X-segments, with seg_x) fuse_frame_culled would
    process for this frame — the capacity-sizing probe for callers
    choosing row_capacity."""
    dev = resolve_device(device)
    depth, K, pose = _on(dev, depth, K, pose)
    return torch.sum(_row_activity(
        geom, depth, K, pose, truncation=truncation, zmin=zmin, zmax=zmax,
        seg_x=seg_x).to(torch.int32))


def compact_active(active_flat: torch.Tensor, capacity: int):
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


def _gather(tables2d, idx, impl):
    """One call gathers the rows `idx` of all the tables -> list of [CAP, R]
    row blocks."""
    if impl == "dma":
        return rowcopy.gather_tables_dma(tables2d, idx)
    if impl == "staged":
        return rowcopy.gather_tables(tables2d, idx)
    return rowcopy.gather_tables_plain(tables2d, idx)


def _scatter(tables2d, idx, rows_list, live, impl):
    """One call writes back all the tables that share `idx`; the slots at or
    past `live` repeat slot 0."""
    rows_list = [rows.contiguous() for rows in rows_list]
    if impl == "dma":
        return rowcopy.scatter_tables_dma(tables2d, idx, rows_list, live=live)
    if impl == "staged":
        return rowcopy.scatter_tables(tables2d, idx, rows_list, live=live)
    return rowcopy.scatter_tables_dma_plain(tables2d, idx, rows_list)


def fuse_frame_culled(
    vol: GradSdfVolume,
    geom: GridGeometry,
    color,
    depth,
    normals,
    n_sq_inv,
    K,
    pose,
    frame_idx: int,
    gate=None,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float = 0.25 * 0.25,
    row_capacity: int,
    seg_x: Optional[int] = None,
    rows_impl: str = "dma",
    inplace: bool = False,
    device=None,
) -> Tuple[GradSdfVolume, torch.Tensor]:
    """Two-level-culled fusion: exact fuse_frame semantics on a fraction of
    the voxels.

      1. `_row_activity` culls at X-row (or, with seg_x=S, X-segment)
         granularity: contiguous [1,1,X] lines, so state moves as whole rows.
      2. The surviving rows are compacted to a STATIC row_capacity
         (`compact_active`), their state rows are gathered from the five row
         tables (dist, grad, weight, color and the frame's visibility word)
         by one call, the exact per-voxel update runs on them, and the rows
         of all five tables are scattered back by one call: two row-copy
         launches a frame (three with the ordered scatter's winner pass).

    rows_impl picks the row-movement kernels (ops/rowcopy.py): "dma" (direct
    gather / direct scatter, the default and what the pipeline uses) or
    "staged" (staged gather / ordered scatter).  "plain" moves the rows with
    the plain PyTorch versions instead — the yardstick the kernels are held
    against, not a path the pipeline takes.  All three give the same volume
    bit for bit: capacity padding slots DUPLICATE the first compacted row,
    compute its update again (identical bytes) and may scatter it again (the
    kernels are told the live count and skip them), so the movement stays a
    pure indexed row copy and write order cannot matter.

    The scatter writes IN PLACE.  With inplace=False (default) the update is
    applied to a clone and `vol` is left as it was — the functional contract
    of the JAX package, which callers that keep a pre-state (the pipeline's
    overflow redo) rely on.  inplace=True updates `vol` itself and returns
    it; `process_chunk` clones once per chunk and fuses its frames in place.

    Returns (new_volume, overflowed [bool tensor]): when more rows survive
    the cull than row_capacity the update is INCOMPLETE — the caller must
    retry with a larger capacity (the stream executor surfaces the flag per
    frame; the pipeline re-runs the chunk from its kept pre-chunk volume).
    """
    if rows_impl not in ROWS_IMPLS:
        raise ValueError(f"rows_impl {rows_impl!r} is not one of {ROWS_IMPLS}")
    dev = resolve_device(device)
    color, depth, normals, n_sq_inv, K, pose = _on(
        dev, color, depth, normals, n_sq_inv, K, pose)
    gate = _gate_tensor(gate, dev)

    active = _row_activity(
        geom, depth, K, pose, truncation=truncation, zmin=zmin, zmax=zmax,
        seg_x=seg_x)
    if gate is not None:
        active = active & gate
    pix_payload = pack_pixel_payload(color, depth, normals, n_sq_inv)

    H, W = depth.shape
    X, Y, Zd = geom.dims
    S = X if seg_x is None else seg_x
    NS = X // S
    NSEG = Zd * Y * NS
    origin = geom.origin_tensor(dev)
    h = geom.voxel_size

    rows_idx, n_active = compact_active(active.reshape(-1), row_capacity)
    overflow = n_active > row_capacity
    slot_ok = rows_idx < NSEG
    # duplicate-first-active padding (see the docstring)
    first = torch.clamp(rows_idx[0], max=NSEG - 1)
    safe_rows = torch.where(slot_ok, torch.clamp(rows_idx, max=NSEG - 1), first)
    safe_rows = safe_rows.to(torch.int32).contiguous()

    out = vol if inplace else vol.clone()
    word, bit = _vis_word_bit(frame_idx)
    t_dist = out.dist.view(NSEG, S)
    t_grad = out.grad.view(NSEG, S * 3)
    t_weight = out.weight.view(NSEG, S)
    t_color = out.color.view(NSEG, S * 3)
    t_vis = out.vis[word].view(NSEG, S)

    tables = [t_dist, t_grad, t_weight, t_color, t_vis]
    d_r, g_r, w_r, c_r, vw_r = _gather(tables, safe_rows, rows_impl)
    g_r = g_r.view(row_capacity, S, 3)
    c_r = c_r.view(row_capacity, S, 3)

    rz = torch.div(safe_rows, Y * NS, rounding_mode="floor").to(torch.float32)
    ry = (torch.div(safe_rows, NS, rounding_mode="floor") % Y).to(torch.float32)
    rx0 = (safe_rows % NS).to(torch.float32) * S            # segment x origin
    rx = rx0[:, None] + torch.arange(S, dtype=torch.float32, device=dev)[None, :]
    p_w = torch.stack(
        [origin[0] + h * rx,
         (origin[1] + h * ry)[:, None].expand(row_capacity, S),
         (origin[2] + h * rz)[:, None].expand(row_capacity, S)],
        dim=-1)

    nd, ng, nw, nc, vis_or = _fuse_voxel_update(
        p_w, d_r, g_r, w_r, c_r, pix_payload, K, pose, (H, W), bit, gate,
        truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq,
    )
    nvw = vw_r | vis_or

    # the padding slots repeat slot 0, so the scatter may skip them; with no
    # active row at all, slot 0 itself is padding and stays live
    live = torch.clamp(n_active, min=1)
    _scatter(
        tables, safe_rows,
        [nd, ng.reshape(row_capacity, S * 3), nw,
         nc.reshape(row_capacity, S * 3), nvw], live, rows_impl)
    return out, overflow


def vis_bit(vis: torch.Tensor, frame_idx: int) -> torch.Tensor:
    """Extract boolean visibility of frame `frame_idx` -> [Z,Y,X] bool."""
    word, bit = _vis_word_bit(frame_idx)
    return (vis[word] & bit) != 0


def vis_count(vis: torch.Tensor) -> torch.Tensor:
    """Number of frames each voxel was seen in -> [Z,Y,X] int32."""
    # SWAR population count on the int32 bit patterns.  The right shifts are
    # arithmetic; the masks of the first two steps drop the copies of the
    # sign bit, and after them every nibble holds at most 4, so it is clear
    x = vis
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return torch.sum(x & 0x3F, dim=0).to(torch.int32)


def pack_tracking_payload(vol: GradSdfVolume) -> torch.Tensor:
    """Pack (dist, grad, weight) into one flat [V,8] row-gatherable payload:
    one 32-byte row gather fetches a full voxel record."""
    zyx = vol.dist.shape
    return torch.cat(
        [
            vol.dist[..., None],
            vol.grad,
            vol.weight[..., None],
            torch.zeros(tuple(zyx) + (3,), dtype=vol.dist.dtype,
                        device=vol.dist.device),
        ],
        dim=-1,
    ).reshape(-1, 8)


def sdf_records_packed(
    payload_flat: torch.Tensor, geom: GridGeometry, pts: torch.Tensor
):
    """Nearest-voxel records at pts from a pack_tracking_payload buffer
    (ONE row gather): (d, ghat, c_v, w, valid) — the pieces of the
    Gradient-SDF query (VolumetricGradSdf.h:76-93) before psi evaluation.
    Shared by sdf_query_packed and the tracker's frozen-correspondence
    rounds (tracking/tracker.py)."""
    idx, valid = geom.nearest_info(pts)
    X, Y = geom.dims[0], geom.dims[1]
    lin = (idx[..., 2] * Y + idx[..., 1]) * X + idx[..., 0]
    rows = payload_flat[lin.long()]
    d = rows[..., 0]
    g = rows[..., 1:4]
    w = rows[..., 4]
    gnorm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    ghat = g / torch.clamp(gnorm, min=1e-12)
    c_v = geom.voxel2world(idx)
    return d, ghat, c_v, w, valid


def _finish_query(d, ghat, c_v, w, valid, pts, truncation):
    psi = d + torch.sum(ghat * (c_v - pts), dim=-1)
    psi = torch.where(valid, psi, torch.full_like(psi, truncation))
    ghat = torch.where(valid[..., None], ghat, torch.zeros_like(ghat))
    w = torch.where(valid, w, torch.zeros_like(w))
    return psi, ghat, w, valid


def sdf_query_packed(
    payload_flat: torch.Tensor, geom: GridGeometry, pts: torch.Tensor,
    truncation: float
):
    """sdf_query against a pack_tracking_payload buffer (one gather)."""
    d, ghat, c_v, w, valid = sdf_records_packed(payload_flat, geom, pts)
    return _finish_query(d, ghat, c_v, w, valid, pts, truncation)


def sdf_query(
    vol: GradSdfVolume, geom: GridGeometry, pts: torch.Tensor, truncation: float
):
    """Gradient-SDF point query (VolumetricGradSdf.h:76-93).

    psi(p) = dist[v] + ghat . (c_v - p) for the *nearest* voxel v (no
    trilerp — first-order extrapolation along the stored gradient).
    Returns (psi, ghat, weight, valid)."""
    idx, valid = geom.nearest_info(pts)
    ix, iy, iz = idx[..., 0].long(), idx[..., 1].long(), idx[..., 2].long()
    d = vol.dist[iz, iy, ix]
    g = vol.grad[iz, iy, ix]
    w = vol.weight[iz, iy, ix]
    gnorm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    ghat = g / torch.clamp(gnorm, min=1e-12)
    c_v = geom.voxel2world(idx)
    return _finish_query(d, ghat, c_v, w, valid, pts, truncation)


def surface_band_mask(vol: GradSdfVolume, voxel_size: float) -> torch.Tensor:
    """Surface-band voxels: |dist| <= sqrt(3)*h and seen in >= 1 frame
    (OptimizerAux.cpp:237-257)."""
    # sqrt(3) and the product both rounded to float32, as the distances are
    bound = torch.sqrt(torch.tensor(3.0, device=vol.dist.device)) * voxel_size
    band = vol.dist.abs() <= bound
    seen = vis_count(vol.vis) >= 1
    return band & seen
