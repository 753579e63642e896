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
the same on the rows that survive a conservative cull, compacted to a
static capacity (ops/cull.cull_compact: one launch on the card), moving their
state rows with the row-copy kernels (ops/rowcopy.py); `fuse_frames_culled`
fuses K frames at given poses with one cull launch and one row move for the
batch.  Every path runs
the update itself through ops/fuse.fuse_rows, in place on rows of state: one
kernel launch a frame on the card (csrc/fuse.cu), the plain PyTorch version
on the CPU.

`PackedVolume` holds the same state as one [Z,Y,X,8] payload (dist, grad,
weight, colour) beside the visibility words: the layout the tracker reads
with no copy, fused by `fuse_frame_culled_packed` (and chunk-resident in
core/resident.py).

Nothing in the fusion functions reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from psgradientsdf_tpu_torch import device_constant, resolve_device
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.ops import cull, fuse, rowcopy
# the level-1 cull and the level-2 compaction (ops/cull.py) stay importable
# from here, beside the fusion that runs them
from psgradientsdf_tpu_torch.ops.cull import (  # noqa: F401
    compact_active,
    compact_padded as _compact_padded,
    row_activity as _row_activity,
)
# fusion_weight stays importable from here, beside the volume it weighs
from psgradientsdf_tpu_torch.ops.fuse import fusion_weight  # noqa: F401

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


def _vis_word_bit(frame_idx: int) -> Tuple[int, int]:
    """(word, bit value as an int32 bit pattern) for a frame's visibility
    bit given on the host; bit 31 is the sign bit of the int32 word.  A
    frame id on the device (an int32 scalar tensor: the one-card scan's,
    which a CUDA graph replays) goes to ops/fuse.fuse_rows as it is."""
    frame_idx = int(frame_idx)
    b = frame_idx % 32
    bit = 1 << b
    if b == 31:
        bit -= 1 << 32
    return frame_idx // 32, bit


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
    frame_idx,             # visibility bit to set: a host int, or an int32
                           # scalar on the device
    gate=None,             # scalar bool (tensor) — False => no-op update
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float = 0.25 * 0.25,
    z0: Optional[int] = None,
    z_map: Optional[torch.Tensor] = None,
    device=None,
) -> GradSdfVolume:
    """One fused depth/color frame (VolumetricGradSdf.cpp:51-138) over the
    whole grid, or over a Z-slab of it.  Functional: returns a new volume,
    `vol` is left as it was.

    `gate` makes the whole update a masked no-op when False, without the
    host having to read the flag.  A slab (`vol` of Zl planes, the dense
    path of parallel/shard.sharded_fuse_frame) names the global planes it
    holds: z0 + [0, Zl) for a contiguous slab, `z_map` [Zl] for an
    interleaved one.

    The update runs in place on a clone, a grid row a slot, through the
    fusion kernel (ops/fuse.fuse_rows)."""
    dev = resolve_device(device)
    color, depth, normals, n_sq_inv, K, pose = _on(
        dev, color, depth, normals, n_sq_inv, K, pose)
    gate = _gate_tensor(gate, dev)
    pix_payload = pack_pixel_payload(color, depth, normals, n_sq_inv)
    X, Y = geom.dims[0], geom.dims[1]
    nseg = vol.dist.shape[0] * Y
    new = vol.clone()
    vis, bit, frame = _vis_rows(new.vis, frame_idx, nseg, X)
    fuse.fuse_rows(
        new.dist.view(nseg, X), new.grad.view(nseg, X, 3),
        new.weight.view(nseg, X), new.color.view(nseg, X, 3),
        vis, pix_payload, K, pose, tuple(depth.shape), bit, gate, geom=geom,
        S=X, z0=z0, z_map=z_map, frame=frame, truncation=truncation,
        zmin=zmin, zmax=zmax, cos_thresh_sq=cos_thresh_sq)
    return new


def _vis_rows(vis: torch.Tensor, frame_idx, nseg: int, S: int):
    """fuse_rows' visibility arguments for a frame id -> (vis, bit, frame):
    a host id picks its word here ([nseg, S] rows, its bit); a device id
    hands fuse_rows the whole table [words, nseg, S] and itself."""
    if isinstance(frame_idx, torch.Tensor):
        return vis.view(vis.shape[0], nseg, S), None, frame_idx
    word, bit = _vis_word_bit(frame_idx)
    return vis[word].view(nseg, S), bit, None


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
    choosing row_capacity: the cull and a compaction of capacity 0, one
    launch on the card (an int64 scalar on the device)."""
    dev = resolve_device(device)
    depth, K, pose = _on(dev, depth, K, pose)
    return cull.cull_compact(geom, depth, K, pose, capacity=0, padded=False,
                             truncation=truncation, zmin=zmin, zmax=zmax,
                             seg_x=seg_x).n_active


def _gather(tables2d, idx, impl):
    """One call gathers the rows `idx` of all the tables -> list of [CAP, R]
    row blocks."""
    if impl == "dma":
        return rowcopy.gather_tables_dma(tables2d, idx)
    if impl == "staged":
        return rowcopy.gather_tables(tables2d, idx)
    return rowcopy.gather_tables_plain(tables2d, idx)


def _scatter(tables2d, idx, rows_list, live, impl):
    """One call writes the slots before `live` of all the tables that share
    `idx` (the culled fusion's slots past it repeat slot 0, so writing them
    too would give the same tables)."""
    rows_list = [rows.contiguous() for rows in rows_list]
    if impl == "dma":
        return rowcopy.scatter_tables_dma(tables2d, idx, rows_list, live=live)
    if impl == "staged":
        return rowcopy.scatter_tables(tables2d, idx, rows_list, live=live)
    return rowcopy.scatter_tables_dma_plain(tables2d, idx, rows_list, live)


def _check_rows_impl(rows_impl: str) -> None:
    if rows_impl not in ROWS_IMPLS:
        raise ValueError(f"rows_impl {rows_impl!r} is not one of {ROWS_IMPLS}")


def fuse_frame_culled(
    vol: GradSdfVolume,
    geom: GridGeometry,
    color,
    depth,
    normals,
    n_sq_inv,
    K,
    pose,
    frame_idx,
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

      1. `ops/cull.cull_compact` culls at X-row (or, with seg_x=S,
         X-segment) granularity: contiguous [1,1,X] lines, so state moves as
         whole rows; the gate is ANDed in; and compacts the surviving rows
         to a STATIC row_capacity with duplicate-first padding (one launch
         on the card for both).
      2. `_fuse_culled_slab` gathers
         their state rows from the five row tables (dist, grad, weight,
         color and the frame's visibility word) by one call, runs the exact
         per-voxel update on them, and scatters the rows of all five tables
         back by one call: two row-copy launches a frame (three with the
         ordered scatter's winner pass).  With `frame_idx` an int32 scalar
         on the device (the one-card scan's, which a CUDA graph replays)
         the four float tables move and fuse_rows picks the visibility
         word on the device and ORs the bit into the table's rows in place.

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
    compacted, pix_payload, K, pose, gate, img_hw = _culled_frame(
        geom, color, depth, normals, n_sq_inv, K, pose, gate,
        truncation=truncation, zmin=zmin, zmax=zmax, seg_x=seg_x,
        row_capacity=row_capacity, device=device)
    return _fuse_culled_slab(
        vol if inplace else vol.clone(), geom, None, geom.dims[2], compacted,
        pix_payload, K, pose, img_hw, frame_idx, gate,
        truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq, seg_x=seg_x, rows_impl=rows_impl)


def _culled_frame(geom, color, depth, normals, n_sq_inv, K, pose, gate, *,
                  truncation, zmin, zmax, seg_x, row_capacity, device):
    """A frame's inputs on the device, its level-1 cull (gated) compacted
    to row_capacity slots with duplicate-first padding (ops/cull.cull_compact,
    one launch on the card), and its packed pixel payload ->
    ((safe_rows, live, overflow), pix_payload, K, pose, gate, (H, W))."""
    dev = resolve_device(device)
    color, depth, normals, n_sq_inv, K, pose = _on(
        dev, color, depth, normals, n_sq_inv, K, pose)
    gate = _gate_tensor(gate, dev)
    c = cull.cull_compact(
        geom, depth, K, pose, capacity=row_capacity, padded=True,
        truncation=truncation, zmin=zmin, zmax=zmax, seg_x=seg_x, gates=gate)
    pix_payload = pack_pixel_payload(color, depth, normals, n_sq_inv)
    return ((c.idx, c.live, c.overflow), pix_payload, K, pose, gate,
            tuple(depth.shape))


def _fuse_culled_slab(
    vol: GradSdfVolume,       # slab-shaped fields [Zl,Y,X] (Zl = z_rows)
    geom: GridGeometry,
    z0: Optional[int],        # slab z-offset (None -> 0)
    z_rows: int,
    compacted,                # (safe_rows int32 [CAP], live, overflow) of
                              # ops/cull.cull_compact(padded=True)
    pix_payload: torch.Tensor,
    K: torch.Tensor,
    pose: torch.Tensor,
    img_hw,
    frame_idx: int,
    gate: Optional[torch.Tensor],
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float,
    seg_x: Optional[int] = None,
    rows_impl: str = "dma",
    z_map: Optional[torch.Tensor] = None,  # [z_rows] global z per local
                                           # plane (interleaved; overrides z0)
) -> Tuple[GradSdfVolume, torch.Tensor]:
    """Level 2 of the culled fusion on a Z-slab, IN PLACE on `vol`: given
    the active rows (or S-voxel X-segments) compacted to the static capacity
    (the slab's cull_compact), gather
    their state rows, run the exact per-voxel update on them in place
    (ops/fuse.fuse_rows: one kernel launch on the card, the live slots
    only), scatter them back.
    Shared by the single-device fuse_frame_culled (z0=None, z_rows=Z) and
    the per-slab body of parallel/shard.py.  The slab's tables are views of
    its own contiguous storage, and the row indices are local to it."""
    _check_rows_impl(rows_impl)
    H, W = img_hw
    X, Y = geom.dims[0], geom.dims[1]
    S = X if seg_x is None else seg_x
    NS = X // S
    NSEG = z_rows * Y * NS
    safe_rows, live, overflow = compacted
    row_capacity = safe_rows.shape[0]

    vis, bit, frame = _vis_rows(vol.vis, frame_idx, NSEG, S)
    tables = [vol.dist.view(NSEG, S), vol.grad.view(NSEG, S * 3),
              vol.weight.view(NSEG, S), vol.color.view(NSEG, S * 3)]
    if frame is None:
        tables.append(vis)          # the frame's word moves with the rows
    rows = _gather(tables, safe_rows, rows_impl)
    d_r, g_r, w_r, c_r = rows[:4]
    fuse.fuse_rows(
        d_r, g_r.view(row_capacity, S, 3), w_r, c_r.view(row_capacity, S, 3),
        vis if frame is not None else rows[4], pix_payload, K, pose, (H, W),
        bit, gate, geom=geom, S=S, NS=NS, rows=safe_rows, live=live, z0=z0,
        z_map=z_map, frame=frame, truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq)
    _scatter(tables, safe_rows, rows, live, rows_impl)
    return vol, overflow


class PackedVolume(NamedTuple):
    """The volume state in the gather-native layout of the tracked stream:

        payload [Z,Y,X,8] f32:  dist, grad(3), weight, color(3)
        vis     [W,Z,Y,X] int32: bit-packed per-frame visibility (as
                                 GradSdfVolume.vis)

    Slots 0, 1:4 and 4 line up with pack_tracking_payload's layout, so the
    tracker's plain version reads `payload.view(-1, 8)` as its [V,8] record
    table with no copy, where a GradSdfVolume has one built a frame (the GN
    kernel reads either layout's fields in place); sdf_records_packed reads
    slots 0:5 only, and slots 5:8 carry the running mean colour.  A culled fusion moves one [S*8]-float row a row (or
    segment) in place of four tables.  Convert at phase boundaries (scan
    start, the hand-over to the refinement) with from_volume / to_volume;
    both copy, so the two states never share storage."""

    payload: torch.Tensor   # [Z,Y,X,8] f32
    vis: torch.Tensor       # [W,Z,Y,X] int32 bit patterns of uint32 words

    @classmethod
    def from_volume(cls, vol: GradSdfVolume) -> "PackedVolume":
        payload = torch.cat(
            [vol.dist[..., None], vol.grad, vol.weight[..., None], vol.color],
            dim=-1)
        return cls(payload=payload, vis=vol.vis.clone())

    def to_volume(self) -> GradSdfVolume:
        p = self.payload
        return GradSdfVolume(
            dist=p[..., 0].contiguous(), grad=p[..., 1:4].contiguous(),
            weight=p[..., 4].contiguous(), color=p[..., 5:8].contiguous(),
            vis=self.vis.clone())

    def clone(self) -> "PackedVolume":
        return PackedVolume(self.payload.clone(), self.vis.clone())


def fuse_frame_culled_packed(
    pvol: PackedVolume,
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
) -> Tuple[PackedVolume, torch.Tensor]:
    """fuse_frame_culled on PackedVolume state: the same level-1 cull, the
    same padding and the same per-voxel update (shared ops/cull.cull_compact
    and ops/fuse.fuse_rows), so the volume is
    fuse_frame_culled's bit for bit; but the level-2 move is ONE gather
    call and ONE scatter call over two tables, the payload's [S*8]-float
    rows and the frame's visibility word, the update reads and writes the
    gathered payload rows in place through their stride-8 fields, and the
    tracking payload stays up to date for free (see PackedVolume).

    rows_impl, inplace, seg_x, device and the returned overflow flag are
    fuse_frame_culled's."""
    _check_rows_impl(rows_impl)
    (safe_rows, live, overflow), pix_payload, K, pose, gate, img_hw = _culled_frame(
        geom, color, depth, normals, n_sq_inv, K, pose, gate,
        truncation=truncation, zmin=zmin, zmax=zmax, seg_x=seg_x,
        row_capacity=row_capacity, device=device)
    if not inplace:
        pvol = pvol.clone()
    X, Y, Zd = geom.dims
    S = X if seg_x is None else seg_x
    NS = X // S
    NSEG = Zd * Y * NS
    cap = row_capacity
    word, bit = _vis_word_bit(frame_idx)
    tables = [pvol.payload.view(NSEG, S * 8), pvol.vis[word].view(NSEG, S)]
    rows, vw_r = _gather(tables, safe_rows, rows_impl)
    r8 = rows.view(cap, S, 8)
    fuse.fuse_rows(
        r8[..., 0], r8[..., 1:4], r8[..., 4], r8[..., 5:8], vw_r, pix_payload,
        K, pose, img_hw, bit, gate, geom=geom, S=S, NS=NS, rows=safe_rows,
        live=live, truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq)
    _scatter(tables, safe_rows, [rows, vw_r], live, rows_impl)
    return pvol, overflow


def fuse_frames_culled(
    vol: GradSdfVolume,
    geom: GridGeometry,
    colors,                 # [K,H,W,3]
    depths,                 # [K,H,W]
    normals,                # [K,H,W,3]
    n_sq_invs,              # [K,H,W]
    K,
    poses,                  # [K,4,4]
    frame_ids,              # K host integers, ascending, within two words
    gates=None,             # [K] bool
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float = 0.25 * 0.25,
    row_capacity: int,
    rows_impl: str = "dma",
    inplace: bool = False,
    device=None,
) -> Tuple[GradSdfVolume, torch.Tensor]:
    """K-frame batched row-culled fusion at given poses (the ground-truth
    path, main_ps.cpp:216-220: no tracker between the frames): K sequential
    fuse_frame_culled calls bit for bit, with ONE gather call and ONE
    scatter call for the batch.

    The cull is the UNION of the K frames' row culls (each gated), compacted
    and padded as in fuse_frame_culled, all in one ops/cull.cull_compact
    launch on the card; row_capacity must cover the union.
    The rows of dist, grad, weight, colour and of the two visibility words
    the batch writes are gathered once (six tables), the K per-voxel updates
    are applied IN ORDER on them — a row of the union that a frame does not
    reach passes none of that frame's per-voxel gates (the cull is a
    superset frame by frame), so its update is the identity — and the rows
    are scattered back once.

    Visibility bits go to at most two words: word_lo of frame_ids[0] and
    the next, which takes every frame of another word (as in the JAX
    package; its bits land in the wrong word when the ids span more than two
    words, and the flag says so).  When word_lo is the volume's last word
    the next word does not exist and the bits of other words are dropped;
    the plane is then moved once (five tables), since two tables of one
    call may not alias.  The words are decided on the host from the frame
    ids.

    Returns (new_volume, flag): flag = overflow | ids spanning more than two
    words; either leaves the update incomplete.  rows_impl, inplace and
    device are fuse_frame_culled's."""
    _check_rows_impl(rows_impl)
    dev = resolve_device(device)
    colors, depths, normals, n_sq_invs, K, poses = _on(
        dev, colors, depths, normals, n_sq_invs, K, poses)
    fids = [int(f) for f in frame_ids]
    KF, H, W = depths.shape
    if len(fids) != KF:
        raise ValueError(f"{len(fids)} frame ids for {KF} frames")
    gates = None if gates is None else _gate_tensor(gates, dev)
    X, Y, Zd = geom.dims
    S, NSEG, cap = X, Zd * Y, row_capacity

    n_words = vol.vis.shape[0]
    word_lo = fids[0] // 32
    if not 0 <= word_lo < n_words:
        raise ValueError(f"frame {fids[0]} is past the volume's "
                         f"{32 * n_words} visibility bits")
    w_hi = min(word_lo + 1, n_words - 1)
    bad_words = any(f // 32 not in (word_lo, word_lo + 1) for f in fids)

    # the K frames' gated culls ORed and compacted: one launch
    safe_rows, _, live, overflow, _ = cull.cull_compact(
        geom, depths, K, poses, capacity=cap, padded=True,
        truncation=truncation, zmin=zmin, zmax=zmax, gates=gates)

    if not inplace:
        vol = vol.clone()
    planes = [word_lo] if w_hi == word_lo else [word_lo, w_hi]
    tables = [vol.dist.view(NSEG, S), vol.grad.view(NSEG, S * 3),
              vol.weight.view(NSEG, S), vol.color.view(NSEG, S * 3)]
    tables += [vol.vis[w].view(NSEG, S) for w in planes]
    rows = _gather(tables, safe_rows, rows_impl)
    g, c = rows[1].view(cap, S, 3), rows[3].view(cap, S, 3)
    for k in range(KF):
        word, bit = _vis_word_bit(fids[k])
        pixp = pack_pixel_payload(colors[k], depths[k], normals[k], n_sq_invs[k])
        # frame k's bits go to the first word of the call or to the second
        # (none when the volume has no second word)
        j = 4 if word == word_lo else 5
        fuse.fuse_rows(
            rows[0], g, rows[2], c, rows[j] if j < len(rows) else None, pixp,
            K, poses[k], (H, W), bit, None if gates is None else gates[k],
            geom=geom, S=S, rows=safe_rows, live=live, truncation=truncation,
            zmin=zmin, zmax=zmax, cos_thresh_sq=cos_thresh_sq)
    _scatter(tables, safe_rows, rows, live, rows_impl)
    return vol, overflow | bad_words


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


def subsample_dist(dist: torch.Tensor, grad: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """8-child distance subdivision d +- (h/4)(+-gx +-gy +-gz)
    (VolumetricGradSdf.cpp:469-494). Returns [Z,Y,X,2,2,2] child distances
    ordered child index (dz,dy,dx) in {0,1}."""
    g = grad / torch.clamp(
        torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-12)
    h4 = 0.25 * voxel_size
    signs = device_constant((-1.0, 1.0), torch.float32, dist.device)
    # offsets[dz,dy,dx] = sx*gx + sy*gy + sz*gz
    sx = signs.reshape(1, 1, 2)
    sy = signs.reshape(1, 2, 1)
    sz = signs.reshape(2, 1, 1)
    off = (
        sx * g[..., None, None, None, 0]
        + sy * g[..., None, None, None, 1]
        + sz * g[..., None, None, None, 2]
    )
    return dist[..., None, None, None] + h4 * off
