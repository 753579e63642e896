"""Resident streaming volume: chunk-compact state for the track+fuse loop.

STATUS: no pipeline path uses this module.  It was built to save the culled
fusion's state-row movement by keeping a chunk's active rows compact, and
that premise did not hold on either device: on the TPU the JAX package's
per-frame culled fusion, row movement included, beat every resident variant
(the note atop psgradientsdf_tpu/core/resident.py), and on an H100 the
resident stream is slower than the per-frame culled fusion too, at
ground-truth poses and tracked (PERF.md §6, phase `packed` of
chip_smoke.py): its update runs over every slot of the compact state each
frame, and tracking adds two admissions a frame.  It stays as a tested capability, held to the
canonical packed stream bit for bit, and as the port of the reference's
layout rules for a compact state.

The state keeps the rows (or S-voxel X-segments) that a chunk of frames
touches compact between the canonical PackedVolume's flushes
(re-implementing cpp/include/sdf_tracker/VolumetricGradSdf.cpp:78-134 on a
chunk-resident compact state, with tracking between frames; the K-frame
batched fusion of core/volume.py is for given poses only):

  ResidentVolume
    rows      [CAPR, S*8] f32      compact payload rows (slot-major; slots
                                   0..n_used-1 live, the rest free)
    vis_rows  [Wc, CAPR, S] int32  bit-packed visibility of the slots
    row_slot  [NSEG] int32         slot of grid row r (CAPR = not resident)
    slot_rows [CAPR] int32         grid row of slot s (NSEG = free)
    n_used    int32 scalar
    fused_ever [NSEG] bool         rows that ever stored weight > 0 — the
                                   tracker-exactness ledger (see below)
    flags     int32 scalar         sticky error bits (FLAG_*)

Within a chunk the membership only grows: `resident_alloc` admits the rows
entering the cull's active set (gathering their canonical state within a
fixed DELTA capacity), `fuse_frame_resident` updates the resident rows IN
PLACE with the exact per-voxel update, and at the chunk's end
`resident_flush` writes everything back to the canonical PackedVolume and
`resident_refresh` starts again from the current pose's active set.  The
state rows then move between the canonical volume and the compact rows at
admission and at the flush, not at every frame.

Tracking reads ONLY the compact rows (`track_frame_resident`): a pixel whose
nearest voxel is not resident counts as weight 0.  That equals the
canonical tracker (same masks, same records) unless the row both stored
weight in an earlier epoch and left the resident set, which `fused_ever`
detects: the miss flag (FLAG_TRACK_MISS for the caller) rises iff an
excluded pixel's row is in the ledger, and the caller must redo the chunk
on the canonical path.  The tracker moves the pose away from the pose its
rows were admitted at, so the allocation before tracking passes motion
margins (margin_px / margin_t) to admit the rows the solve may query; the
flag is the net behind the margins.

Every row move goes through the row-copy kernels (ops/rowcopy.py):
refresh and alloc gather the canonical rows of the payload and of its Wc
visibility planes in one call (one call per MAX_TABLES tables: frame caps
past 224 take a second), alloc writes them into the compact rows with the
direct scatter, and flush writes the live slots back with the direct
scatter told `live = n_used`.  The bookkeeping (row_slot, slot_rows,
n_used, fused_ever, flags) is plain PyTorch on the device; nothing is read
back to the host.  Each function is functional unless `inplace=True`, as
core/volume.fuse_frame_culled.  On CPU tensors the row moves take the plain
versions, as everywhere in the package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from psgradientsdf_tpu_torch import resolve_device
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.core.volume import (
    PackedVolume,
    _check_rows_impl,
    _gather,
    _on,
    _gate_tensor,
    _scatter,
    _vis_word_bit,
    pack_pixel_payload,
)
from psgradientsdf_tpu_torch.ops import cull, fuse, rowcopy

FLAG_CAPACITY = 1      # resident row capacity exhausted
FLAG_DELTA = 2         # per-frame delta capacity exhausted
FLAG_COVERAGE = 4      # fusion-active row was not resident at update time
FLAG_TRACK_MISS = 8    # tracker excluded a fused-ever row that is not resident


class ResidentVolume(NamedTuple):
    rows: torch.Tensor        # [CAPR, S*8] f32
    vis_rows: torch.Tensor    # [Wc, CAPR, S] int32 bit patterns
    row_slot: torch.Tensor    # [NSEG] int32 (CAPR = not resident)
    slot_rows: torch.Tensor   # [CAPR] int32 (NSEG = free)
    n_used: torch.Tensor      # int32 scalar
    fused_ever: torch.Tensor  # [NSEG] bool
    flags: torch.Tensor       # int32 scalar, sticky FLAG_* bits

    def clone(self) -> "ResidentVolume":
        return ResidentVolume(*(t.clone() for t in self))


def _shapes(pvol: PackedVolume, seg_x: Optional[int] = None):
    """(vis words, slot count, slot length) at the chosen granularity, of the
    canonical 4-D PackedVolume or of a streaming one (payload [NSEG, S*8],
    vis [Wc, NSEG, S])."""
    if pvol.vis.dim() == 3:
        Wc, NSEG, S = pvol.vis.shape
        if seg_x is not None and seg_x != S:
            raise ValueError(f"seg_x={seg_x}, but the streaming state has S={S}")
        if tuple(pvol.payload.shape) != (NSEG, S * 8):
            raise ValueError(f"payload {tuple(pvol.payload.shape)} does not "
                             f"match vis {tuple(pvol.vis.shape)}")
        return Wc, NSEG, S
    Wc, Z, Y, X = pvol.vis.shape
    S = X if seg_x is None else seg_x
    if X % S != 0:
        raise ValueError(f"seg_x={S} must divide X={X}")
    return Wc, Z * Y * (X // S), S


def to_streaming(pvol: PackedVolume, seg_x: Optional[int] = None) -> PackedVolume:
    """Views of the canonical 4-D state at slot granularity (payload
    [NSEG, S*8], vis [Wc, NSEG, S]); they share its storage."""
    Wc, NSEG, S = _shapes(pvol, seg_x)
    return PackedVolume(payload=pvol.payload.view(NSEG, S * 8),
                        vis=pvol.vis.view(Wc, NSEG, S))


def from_streaming(pvol: PackedVolume, dims) -> PackedVolume:
    """Inverse of to_streaming: views in the canonical [Z,Y,X,8]/[Wc,Z,Y,X]."""
    X, Y, Z = dims
    Wc = pvol.vis.shape[0]
    return PackedVolume(payload=pvol.payload.view(Z, Y, X, 8),
                        vis=pvol.vis.view(Wc, Z, Y, X))


def _tables(pvol: PackedVolume, seg_x: Optional[int] = None):
    """The canonical row tables: payload [NSEG, S*8] and each visibility
    plane [NSEG, S], all views of the volume's storage."""
    Wc, NSEG, S = _shapes(pvol, seg_x)
    vis = pvol.vis.view(Wc, NSEG, S)
    return [pvol.payload.view(NSEG, S * 8)] + [vis[w] for w in range(Wc)]


def _compact_tables(res: ResidentVolume):
    """The compact row tables: rows [CAPR, S*8] and each plane [CAPR, S]."""
    return [res.rows] + [res.vis_rows[w] for w in range(res.vis_rows.shape[0])]


def _groups(items):
    return [items[i:i + rowcopy.MAX_TABLES]
            for i in range(0, len(items), rowcopy.MAX_TABLES)]


def _gather_rows(tables, idx, impl):
    """All the tables' rows at idx, MAX_TABLES tables a call."""
    out = []
    for group in _groups(tables):
        out += _gather(group, idx, impl)
    return out


def _scatter_rows(tables, idx, rows_list, live, impl):
    """Write the slots before `live` of every table, MAX_TABLES tables a
    call.  The slots past `live` are free slots, not copies of slot 0."""
    for tabs, rows in zip(_groups(tables), _groups(list(rows_list))):
        _scatter(tabs, idx, rows, live, impl)


def _culled(geom, depth, K, pose, *, truncation, zmin, zmax, S, capacity,
            margin_px=0.0, margin_t=0.0, gate=None, allow=None, mask=False):
    """The slot-granularity cull (slot length S), gated, ANDed with
    `allow`, compacted to `capacity` slots with the fill value NSEG
    (ops/cull.cull_compact: one launch on the card) -> cull.Culled."""
    seg = None if S == geom.dims[0] else S
    return cull.cull_compact(geom, depth, K, pose, capacity=capacity,
                             padded=False, truncation=truncation, zmin=zmin,
                             zmax=zmax, seg_x=seg, margin_px=margin_px,
                             margin_t=margin_t, gates=gate, allow=allow,
                             mask=mask)


def fused_ever_from_vis(pvol: PackedVolume, seg_x: Optional[int] = None
                        ) -> torch.Tensor:
    """[NSEG] bool: slots that ever stored fusion weight, from the
    visibility words alone — the per-voxel update sets a visibility bit
    exactly when it adds weight (the same mask), so any bit set <=> weight
    ever stored."""
    Wc, NSEG, S = _shapes(pvol, seg_x)
    return (pvol.vis.view(Wc, NSEG, S) != 0).any(dim=0).any(dim=-1)


def resident_refresh(
    pvol: PackedVolume,
    geom: GridGeometry,
    depth,
    K,
    pose,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    capacity: int,
    seg_x: Optional[int] = None,
    margin_px: float = 0.0,
    margin_t: float = 0.0,
    rows_impl: str = "dma",
    device=None,
) -> ResidentVolume:
    """Start a resident epoch: gather the rows (or S-voxel X-segments, with
    seg_x) active at `pose` from the canonical volume, which must be
    CURRENT (freshly flushed).  One gather call moves the payload rows and
    the Wc visibility planes.  The free slots gather the grid's last row (as
    the JAX package's clamped gather does); they are never written back.
    margins: see resident_alloc."""
    _check_rows_impl(rows_impl)
    dev = resolve_device(device)
    depth, K, pose = _on(dev, depth, K, pose)
    Wc, NSEG, S = _shapes(pvol, seg_x)
    ridx, n_act = _culled(geom, depth, K, pose, truncation=truncation,
                          zmin=zmin, zmax=zmax, S=S, capacity=capacity,
                          margin_px=margin_px, margin_t=margin_t)[:2]
    ok = ridx < NSEG
    safe = torch.clamp(ridx, max=NSEG - 1).to(torch.int32).contiguous()
    moved = _gather_rows(_tables(pvol, seg_x), safe, rows_impl)

    i32 = dict(dtype=torch.int32, device=dev)
    slot_ids = torch.arange(capacity, **i32)
    cap_t = torch.full((), capacity, **i32)
    # ridx's fill entries all land on the spill entry NSEG, which is cut off
    row_slot = torch.full((NSEG + 1,), capacity, **i32)
    row_slot.scatter_(0, ridx, torch.where(ok, slot_ids, cap_t))
    return ResidentVolume(
        rows=moved[0], vis_rows=torch.stack(moved[1:]),
        row_slot=row_slot[:NSEG], slot_rows=ridx.to(torch.int32),
        n_used=torch.clamp(n_act, max=capacity).to(torch.int32),
        fused_ever=fused_ever_from_vis(pvol, seg_x),
        flags=torch.where(n_act > capacity, FLAG_CAPACITY, 0).to(torch.int32),
    )


def resident_flush(res: ResidentVolume, pvol: PackedVolume, *,
                   rows_impl: str = "dma", inplace: bool = False) -> PackedVolume:
    """Write the resident rows back into the canonical volume: one direct
    scatter over the payload and the Wc visibility planes, told
    live = n_used (live slots are 0..n_used-1; the free slots past them
    point at the first live slot's row and are skipped)."""
    _check_rows_impl(rows_impl)
    if not inplace:
        pvol = pvol.clone()
    S = res.rows.shape[1] // 8
    NSEG = res.row_slot.shape[0]
    n_used = res.n_used.to(torch.int64)
    slots = torch.arange(res.slot_rows.shape[0], device=n_used.device)
    first = torch.clamp(res.slot_rows[0], max=NSEG - 1)
    idx = torch.where(slots < n_used, res.slot_rows, first).contiguous()
    _scatter_rows(_tables(pvol, S), idx, _compact_tables(res), n_used, rows_impl)
    return pvol


def resident_alloc(
    res: ResidentVolume,
    pvol: PackedVolume,
    geom: GridGeometry,
    depth,
    K,
    pose,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    delta_capacity: int,
    margin_px: float = 0.0,
    margin_t: float = 0.0,
    rows_impl: str = "dma",
    inplace: bool = False,
    device=None,
) -> ResidentVolume:
    """Admit the rows newly active at `pose`, pulling their state from the
    canonical volume (current for the rows that are not resident — the
    resident rows' canonical copies are stale, but those are not gathered):
    one gather call from the canonical tables, one direct scatter into slots
    n_used.. of the compact tables.

    margin_px / margin_t widen the cull (ops/cull.cull_compact) so the
    admitted set also covers the rows a tracking solve may query while it
    moves the pose away from `pose`: the allocation before tracking passes
    the expected inter-frame motion (reprojection pixels / camera-depth
    meters), the one before fusing at the tracked pose passes zero."""
    _check_rows_impl(rows_impl)
    dev = resolve_device(device)
    depth, K, pose = _on(dev, depth, K, pose)
    if not inplace:
        res = res.clone()
    CAPR, S = res.rows.shape[0], res.rows.shape[1] // 8
    NSEG = res.row_slot.shape[0]
    # the active rows that are not resident, compacted (fill value NSEG)
    didx, n_new = _culled(geom, depth, K, pose, truncation=truncation,
                          zmin=zmin, zmax=zmax, S=S, capacity=delta_capacity,
                          margin_px=margin_px, margin_t=margin_t,
                          allow=res.row_slot >= CAPR)[:2]
    n_used = res.n_used.to(torch.int64)
    ar = torch.arange(delta_capacity, dtype=torch.int64, device=dev)
    slots_new = n_used + ar
    # the admitted slots are a prefix: didx is compacted, so the first n_adm
    # entries are rows, and their slots n_used.. fit below CAPR
    n_adm = torch.minimum(n_new, torch.clamp(CAPR - n_used, max=delta_capacity))
    d_ok = ar < n_adm

    safe_d = torch.clamp(didx, max=NSEG - 1).to(torch.int32).contiguous()
    moved = _gather_rows(_tables(pvol, S), safe_d, rows_impl)
    first_slot = torch.clamp(n_used, max=CAPR - 1)
    write_slot = torch.where(d_ok, slots_new, first_slot).contiguous()
    _scatter_rows(_compact_tables(res), write_slot, moved, n_adm, rows_impl)

    # bookkeeping: the rejected entries go to spill entries that are cut off
    row_slot = torch.cat([res.row_slot, res.row_slot.new_full((1,), CAPR)])
    row_slot.scatter_(0, torch.where(d_ok, didx, NSEG),
                      torch.where(d_ok, slots_new, CAPR).to(torch.int32))
    slot_rows = torch.cat([res.slot_rows, res.slot_rows.new_full((1,), NSEG)])
    slot_rows.scatter_(0, torch.where(d_ok, slots_new, CAPR),
                       torch.where(d_ok, didx, NSEG).to(torch.int32))
    flags = (res.flags
             | torch.where(n_new > delta_capacity, FLAG_DELTA, 0)
             | torch.where(n_used + n_new > CAPR, FLAG_CAPACITY, 0))
    return res._replace(row_slot=row_slot[:NSEG], slot_rows=slot_rows[:CAPR],
                        n_used=(n_used + n_adm).to(torch.int32),
                        flags=flags.to(torch.int32))


def fuse_frame_resident(
    res: ResidentVolume,
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
    inplace: bool = False,
    device=None,
) -> ResidentVolume:
    """One frame fused IN PLACE on the resident rows: the exact per-voxel
    update (the shared ops/fuse.fuse_rows over every slot, so it is the
    canonical fusion's bit for bit on the resident rows), gated per slot by
    this frame's level-1 cull.  An active row that is not resident raises
    FLAG_COVERAGE (the update is incomplete; the caller must redo on the
    canonical path).  No row moves; the fused_ever ledger gains the rows
    whose update stored weight."""
    dev = resolve_device(device)
    color, depth, normals, n_sq_inv, K, pose = _on(
        dev, color, depth, normals, n_sq_inv, K, pose)
    gate = _gate_tensor(gate, dev)
    if not inplace:
        res = res.clone()
    X = geom.dims[0]
    CAPR, S = res.rows.shape[0], res.rows.shape[1] // 8
    NSEG = res.row_slot.shape[0]

    act = _culled(geom, depth, K, pose, truncation=truncation, zmin=zmin,
                  zmax=zmax, S=S, capacity=0, gate=gate, mask=True).mask.reshape(-1)
    coverage_bad = (act & (res.row_slot >= CAPR)).any()
    act_pad = torch.cat([act, act.new_zeros(1)])
    slot_rows = res.slot_rows.long()
    slot_act = act_pad[torch.clamp(slot_rows, max=NSEG)]
    row_gate = (slot_act & (slot_rows < NSEG))[:, None]

    pixp = pack_pixel_payload(color, depth, normals, n_sq_inv)
    word, bit = _vis_word_bit(frame_idx)
    rows = res.rows.view(CAPR, S, 8)
    vis_or = torch.zeros((CAPR, S), dtype=torch.int32, device=dev)
    fuse.fuse_rows(
        rows[..., 0], rows[..., 1:4], rows[..., 4], rows[..., 5:8], vis_or,
        pixp, K, pose, tuple(depth.shape), bit, row_gate, geom=geom, S=S,
        NS=X // S, rows=torch.clamp(res.slot_rows, max=NSEG - 1),
        truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq)
    res.vis_rows[word] |= vis_or

    # the exact ledger: rows whose update stored weight this frame
    fused_now = (vis_or != 0).any(dim=-1)
    fe_pad = torch.cat([res.fused_ever, res.fused_ever.new_zeros(1)])
    fe_pad[torch.where(fused_now, slot_rows, NSEG)] = True
    flags = res.flags | torch.where(coverage_bad, FLAG_COVERAGE, 0)
    return res._replace(fused_ever=fe_pad[:NSEG], flags=flags.to(torch.int32))


def resident_records(res: ResidentVolume, geom: GridGeometry,
                     pts: torch.Tensor):
    """Nearest-voxel tracking records from the COMPACT rows only:
    (d, ghat, c_v, w, valid, miss_px).  Rows that are not resident read as
    weight 0; miss_px marks the pixels whose (valid, not resident) row is in
    the fused_ever ledger — the result could then differ from the canonical
    tracker (see the module docstring); callers AND it with their own pixel
    mask and reduce.  The same normalisation as sdf_records_packed, so the
    records equal the canonical tracker's wherever the row is resident."""
    X, Y = geom.dims[0], geom.dims[1]
    CAPR, S = res.rows.shape[0], res.rows.shape[1] // 8
    NS = X // S
    idx, valid = geom.nearest_info(pts)
    ix = idx[..., 0].long()
    lin_row = (idx[..., 2].long() * Y + idx[..., 1].long()) * NS + ix // S
    slot = res.row_slot[lin_row].long()
    resident = slot < CAPR
    cl = torch.clamp(slot, max=CAPR - 1) * S + ix % S
    recs = res.rows.view(CAPR * S, 8)[cl]
    d = recs[..., 0]
    g = recs[..., 1:4]
    w = torch.where(resident, recs[..., 4], torch.zeros_like(d))
    gnorm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    ghat = g / torch.clamp(gnorm, min=1e-12)
    c_v = geom.voxel2world(idx)
    miss_px = valid & ~resident & res.fused_ever[lin_row]
    return d, ghat, c_v, w, valid, miss_px


def track_frame_resident(
    res: ResidentVolume,
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
):
    """track_frame against the resident rows (tracking/tracker.py semantics,
    reads of the compact rows only; the Gram through ops/gn.gram, one
    launch a step on the card).  Returns (TrackResult, miss) — miss is
    the OR over every gather round's exactness flag (a bool tensor)."""
    from psgradientsdf_tpu_torch.ops import gn
    from psgradientsdf_tpu_torch.tracking.tracker import TrackResult, run_gn_rounds

    dev = resolve_device(device)
    depth, K, init_pose = _on(dev, depth, K, init_pose)
    frame = gn.GnFrame(geom, depth[::stride, ::stride], K, stride=stride,
                       zmin=zmin, zmax=zmax)

    def gather_records(pose):
        pts_cam, valid_z = frame.points()
        R = pose[:3, :3]
        t = pose[:3, 3]
        p_w = pts_cam @ R.T + t
        d, ghat, c_v, w, valid, miss_px = resident_records(res, geom, p_w)
        ok = valid & (w > 0.0) & valid_z
        return gn.pack_records(d, ghat, c_v, ok), (miss_px & valid_z).any()

    def masked_gram(pose, rec):
        return gn.split_gram(gn.gram(frame, pose, rec))

    pose, conv, fail, E_mean, count, iters, miss = run_gn_rounds(
        geom, gather_records, masked_gram, init_pose,
        num_iterations=num_iterations, conv_threshold_sq=conv_threshold_sq,
        damping=damping, regather_every=regather_every,
        early_exit=early_exit, records_flagged=True,
    )
    return (
        TrackResult(pose=pose, converged=conv & (~fail), iterations=iters,
                    energy=E_mean, num_valid=count),
        miss,
    )
