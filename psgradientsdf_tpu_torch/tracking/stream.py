"""Chunked frame-stream executor: track -> fuse, one host read per chunk.

The reference processes frames one at a time from a host loop
(cpp/voxel_ps/src/main_ps.cpp:162-277).  Here a chunk of C frames is
uploaded once and worked through on the device:

  * ONE batched preprocessing pass per chunk computes FALS normals
    (NormalEstimator.h:150-176) and the LAPM sharpness measure
    (SharpDetector.h:22-37) for all C frames (on the card two launches,
    ops/preprocess.py);
  * per frame, `_chunk_step` runs the GN tracking solve
    (RigidPointOptimizer.cpp:27-76) seeded from the previous frame's pose
    and a GATED fusion (VolumetricGradSdf.cpp:51-138) that is a masked
    no-op unless tracking converged (main_ps.cpp:239-243) — or fuses at
    the given GT pose in GT mode (main_ps.cpp:216-220);
  * the per-frame results stay on the device until the caller reads them.

Fusion gating is a mask, not a branch on a device value, so `_chunk_step`
reads nothing back (on the card a frame's whole tracking solve is one
launch that ends its loop on the device).  Ragged chunk tails are padded by
the caller and marked in `valid`; a padding frame is skipped: it leaves the
volume and the pose untouched and reports converged=False, fused=False and
zeros.  A chunk's results come back with one readout (`read_result`: one
device-to-host copy).

On one card with the culled fusion, `rotation` (a tracking/graph.
ScanRotation) runs the chunk in static buffers, its frame ids on the
device, and, with `capture` on a card, as ONE CUDA graph a chunk once its
key is captured (tracking/graph.py): the counterpart of JAX's chunk of
jitted programs dispatched with no host read.  capture=False runs the same
buffers eagerly (the A/B of the graph); on the CPU there is no graph.

With `mesh` (parallel/mesh.py) the volume is a ShardedVolume of Z-slabs: the
chunk is preprocessed once on the mesh's first device, each frame's inputs
go to every distinct slab device once, and the frame is tracked by the
summed-Gram tracker and fused by the per-slab culled (or dense) fusion of
parallel/shard.py, the culled capacity split across the Z shards.  On a
mesh over processes (parallel/distributed.py) every process preprocesses
the chunk and tracks each frame on its own device, with the Gram sums of
every slab, and fuses its own slabs: the results are the same on every
process.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from psgradientsdf_tpu_torch import resolve_device
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.core.volume import fuse_frame, fuse_frame_culled
from psgradientsdf_tpu_torch.ops import preprocess
from psgradientsdf_tpu_torch.ops.normals import FalsCache
from psgradientsdf_tpu_torch.parallel import shard
from psgradientsdf_tpu_torch.parallel.mesh import Z_AXIS
from psgradientsdf_tpu_torch.tracking import graph as scan_graph
from psgradientsdf_tpu_torch.tracking.tracker import track_frame


class ChunkResult(NamedTuple):
    poses: torch.Tensor       # [C,4,4] pose after each frame (tracked or GT)
    converged: torch.Tensor   # [C] bool — tracking converged (True in GT mode)
    fused: torch.Tensor       # [C] bool — frame was fused into the volume
    iterations: torch.Tensor  # [C] int32 GN iterations to convergence (0 in GT mode)
    energy: torch.Tensor      # [C] mean psi^2 at the last tracked iterate
    num_valid: torch.Tensor   # [C] int32 pixels in the last GN solve
    sharpness: torch.Tensor   # [C] LAPM focus measure of the color image
    fuse_overflow: torch.Tensor  # [C] bool — row-culled fusion hit capacity;
                                 # the frame's update is incomplete and the
                                 # caller must redo the chunk (pipeline keeps
                                 # the pre-chunk volume)
    readout: Optional[torch.Tensor] = None  # [C, READ_COLS] float64: the
                                 # fields above a frame, read by read_result
    colors: Optional[torch.Tensor] = None   # [C,H,W,3] the chunk's colour
                                 # frames on the device, wire format (in a
                                 # rotation: its staging, reused later)


def pack_readout(poses, conv, fused, iters, energy, nvalid, sharp, overflow):
    """The chunk's results as one [C, READ_COLS] float64 tensor (every
    value exact: float32, int32 and bools all fit a float64)."""
    f64 = torch.float64
    cols = [poses.reshape(poses.shape[0], 16).to(f64)] + [
        t.to(f64)[:, None] for t in (conv, fused, iters, energy, nvalid, sharp, overflow)]
    return torch.cat(cols, dim=1)


def read_result(res: ChunkResult) -> dict:
    """A chunk's results on the host with ONE device-to-host copy of its
    readout -> numpy arrays by field name."""
    v = res.readout.cpu().numpy()
    C = v.shape[0]
    return dict(poses=v[:, :16].reshape(C, 4, 4).astype(np.float32),
                converged=v[:, 16] != 0, fused=v[:, 17] != 0,
                iterations=v[:, 18].astype(np.int32),
                energy=v[:, 19].astype(np.float32),
                num_valid=v[:, 20].astype(np.int32),
                sharpness=v[:, 21].astype(np.float32), fuse_overflow=v[:, 22] != 0)


def upload_frames(arr, device) -> torch.Tensor:
    """A chunk's frames on the device in their wire format
    (tracking/graph.host_frames: uint16 depth widened to int32 on the host
    first; uint8 colour and float arrays go up as they are)."""
    return scan_graph.host_frames(arr).to(device)


def _to_metric(depths: torch.Tensor, colors: torch.Tensor, depth_unit: float):
    """On-device raw->metric conversion: uint8 RGB -> [0,1] f32, integer
    depth -> meters.  Float inputs pass through untouched (depth_unit must
    be 1.0 then).  Identical arithmetic to the host loaders' conversions."""
    if colors.dtype == torch.uint8:
        colors = colors.to(torch.float32) / 255.0
    if not depths.dtype.is_floating_point:
        depths = depths.to(torch.float32) * float(np.float32(depth_unit))
    return depths, colors


def _preprocess(depths: torch.Tensor, colors: torch.Tensor, fals: FalsCache,
                *, window: int, depth_unit: float = 1.0):
    """Metric frames, FALS normals [C,H,W,3] and LAPM sharpness [C]: on the
    card one launch of each of ops/preprocess.py's kernels."""
    depths, colors = _to_metric(depths, colors, depth_unit)
    normals = preprocess.fals_normals(depths, fals, window)
    sharp = preprocess.lapm(colors)
    return depths, colors, normals, sharp


def _chunk_step(vol, pose, gtp, *, use_gt: bool, track, fuse):
    """One (non-padding) frame: GN track + gated fuse.  `track(vol, pose)`
    and `fuse(vol, pose, gate) -> (vol, overflow)` hold the frame's inputs
    (process_chunk makes them, single-device or on the mesh); the culled
    fusion writes IN PLACE into `vol` (process_chunk owns that volume)."""
    dev = pose.device
    if use_gt:
        new_pose = gtp
        conv = torch.ones((), dtype=torch.bool, device=dev)
        iters = torch.zeros((), dtype=torch.int32, device=dev)
        energy = torch.zeros((), dtype=torch.float32, device=dev)
        nvalid = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        res = track(vol, pose)
        # non-converged tracking still advances the pose estimate
        # (the reference's pose_ member retains the last GN iterate)
        new_pose = res.pose
        conv = res.converged
        iters, energy, nvalid = res.iterations, res.energy, res.num_valid

    do_fuse = conv
    vol, overflow = fuse(vol, new_pose, do_fuse)
    return vol, new_pose, conv, do_fuse, iters, energy, nvalid, overflow


def process_chunk(
    vol,                    # GradSdfVolume, or ShardedVolume with `mesh`
    geom: GridGeometry,
    colors,                 # [C,H,W,3] float [0,1] or uint8 (wire format)
    depths,                 # [C,H,W] float meters or integer (wire format)
    K,                      # [3,3]
    init_pose,              # [4,4] tracking seed (pose after previous chunk)
    frame_ids,              # [C] host integers: visibility bit per frame
    valid,                  # [C] host bools — False for ragged-tail padding
    gt_poses,               # [C,4,4] (ignored unless use_gt)
    fals: FalsCache,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    num_iterations: int = 50,
    conv_threshold_sq: float = 1e-6,
    damping: float = 1.0,
    stride: int = 1,
    window: int = 11,
    use_gt: bool = False,
    depth_unit: float = 1.0,
    regather_every: int = 1,
    early_exit: bool = True,
    fuse_row_capacity: int = 0,
    rows_impl: str = "dma",
    mesh=None,
    interleave_z: bool = False,
    rotation: Optional[scan_graph.ScanRotation] = None,
    capture: bool = True,
    device=None,
) -> Tuple[object, ChunkResult]:
    """Track + fuse a chunk of frames.

    Functional at chunk granularity: the volume is cloned ONCE on entry and
    the chunk's frames are fused into the clone in place (the row-copy
    scatters write in place), so `vol` is left as it was — the pipeline's
    overflow redo restarts from it.  `frame_ids` and `valid` are host values
    (the pipeline makes them on the host), so no flag is read back from the
    device here; the returned ChunkResult holds device tensors.

    With `rotation` (one device, fuse_row_capacity > 0) the clone is the
    copy of `vol` into the rotation's next slot, the inputs are copied into
    that slot's buffers, the frame ids go to the fusion as device values,
    and the returned volume and results are that slot's: they hold until
    the rotation writes the slot again, three chunks later.  With
    `capture` on a card a full chunk (no padding) of the direct row copies
    is one replay of a CUDA graph once its key is captured
    (tracking/graph.py); otherwise it runs eagerly, bit for bit the same.

    With `mesh`, `vol` is a ShardedVolume (stored interleaved when
    `interleave_z`) and the work runs on the mesh as the module docstring
    says; `fuse_row_capacity` stays the whole grid's, and each shard gets
    ceil(capacity / n_z).  The results lie on the mesh's first device.
    """
    dev = resolve_device(device) if mesh is None else mesh.first_device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    valid = [bool(v) for v in np.asarray(valid).tolist()]
    kw = dict(geom=geom, fals=fals, truncation=truncation, zmin=zmin, zmax=zmax,
              num_iterations=num_iterations, conv_threshold_sq=conv_threshold_sq,
              damping=damping, stride=stride, window=window, use_gt=use_gt,
              depth_unit=depth_unit, regather_every=regather_every,
              early_exit=early_exit, fuse_row_capacity=fuse_row_capacity,
              rows_impl=rows_impl, mesh=mesh, interleave_z=interleave_z, dev=dev)
    if rotation is None:
        colors = upload_frames(colors, dev)
        depths = upload_frames(depths, dev)
        pose = torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
        gt_poses = torch.as_tensor(gt_poses, dtype=torch.float32, device=dev)
        fids = [int(f) for f in np.asarray(frame_ids).tolist()]
        return _chunk(vol.clone(), colors, depths, K, pose, fids, valid, gt_poses, **kw)

    if mesh is not None or fuse_row_capacity <= 0:
        raise ValueError("process_chunk: a rotation serves the one-device culled "
                         "fusion (fuse_row_capacity > 0, no mesh)")
    if len(valid) != rotation.C:
        raise ValueError(f"process_chunk: a chunk of {len(valid)} frames, the "
                         f"rotation's hold {rotation.C}")
    source = rotation.source_of(vol)
    slot = rotation.slots[rotation.target_of(source)]
    slot.stage(colors, depths, init_pose, frame_ids, gt_poses if use_gt else None)

    def body():
        for t, v in zip(slot.vol, vol):
            t.copy_(v)
        _, res = _chunk(slot.vol, slot.colors, slot.depths, K, slot.seed, slot.fids,
                        valid, slot.gtp, **kw)
        for t, r in zip(slot.results() + (slot.readout,), res):
            t.copy_(r)

    static = (tuple(sorted((k, v) for k, v in kw.items() if k not in ("fals", "mesh"))),
              id(fals), K.data_ptr(), id(K))
    key = scan_graph.ScanKey(source, rotation.target_of(source),
                             fuse_row_capacity, static)
    rotation.run(key, body, graphable=capture and all(valid) and rows_impl == "dma",
                 reads=tuple(vol) if source is None else ())
    return slot.vol, ChunkResult(*slot.results(), readout=slot.readout,
                                 colors=slot.colors)


def _chunk(vol, colors, depths, K, pose, fids, valid, gt_poses, *, geom, fals,
           truncation, zmin, zmax, num_iterations, conv_threshold_sq, damping,
           stride, window, use_gt, depth_unit, regather_every, early_exit,
           fuse_row_capacity, rows_impl, mesh, interleave_z, dev
           ) -> Tuple[object, ChunkResult]:
    """The chunk's work on device tensors -> (volume, results): the
    preprocessing, then a `_chunk_step` a valid frame; the culled fusion
    writes into `vol` in place.  `fids`: host ints, or an int32 [C] tensor
    on the device (each frame's id a device value)."""
    C = int(colors.shape[0])
    depths_m, colors_m, normals, sharp = _preprocess(
        depths, colors, fals, window=window, depth_unit=depth_unit)
    zkw = dict(truncation=truncation, zmin=zmin, zmax=zmax)
    gn = dict(num_iterations=num_iterations, conv_threshold_sq=conv_threshold_sq,
              damping=damping, regather_every=regather_every,
              early_exit=early_exit, stride=stride)
    no_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    n_sq_inv = fals.n_sq_inv

    if mesh is None:
        def frame_fns(color, depth, n_img, fid):
            def track(vol, pose):
                return track_frame(vol, geom, depth, K, pose, device=dev,
                                   **zkw, **gn)

            def fuse(vol, pose, gate):
                args = (color, depth, n_img, n_sq_inv, K, pose, fid, gate)
                if fuse_row_capacity > 0:
                    return fuse_frame_culled(
                        vol, geom, *args, row_capacity=fuse_row_capacity,
                        rows_impl=rows_impl, inplace=True, device=dev, **zkw)
                return fuse_frame(vol, geom, *args, device=dev, **zkw), no_overflow

            return track, fuse
    else:
        devs = mesh.slab_devices
        n_sq_inv, K_rep = shard.replicate(n_sq_inv, devs), shard.replicate(K, devs)
        track_sh = shard.sharded_tracker_fn(
            mesh, geom, tuple(depths_m[0, ::stride, ::stride].shape),
            interleave_z=interleave_z, **zkw, **gn)
        if fuse_row_capacity > 0:
            fuse_sh = shard.sharded_fuse_frame_culled_fn(
                mesh, geom, row_capacity=-(-fuse_row_capacity // mesh.shape[Z_AXIS]),
                interleave_z=interleave_z, rows_impl=rows_impl, **zkw)
        else:
            fuse_sh = shard.sharded_fuse_frame(mesh, geom, **zkw)

        def frame_fns(color, depth, n_img, fid):
            # the frame's inputs go to each distinct slab device once
            color, depth_r, n_img = (shard.replicate(x, devs)
                                     for x in (color, depth, n_img))
            depth_t = (depth_r if stride == 1 else
                       shard.replicate(depth[::stride, ::stride], devs))

            def track(vol, pose):
                return track_sh(vol, depth_t, K_rep, pose)

            def fuse(vol, pose, gate):
                args = (color, depth_r, n_img, n_sq_inv, K_rep, pose, fid, gate)
                if fuse_row_capacity > 0:
                    return fuse_sh(vol, *args, inplace=True)
                return fuse_sh(vol, *args), no_overflow

            return track, fuse

    zero_b = torch.zeros((), dtype=torch.bool, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    outs = []
    for j in range(C):
        if not valid[j]:
            outs.append((pose, zero_b, zero_b, zero_i, zero_f, zero_i, zero_b))
            continue
        track, fuse = frame_fns(colors_m[j], depths_m[j], normals[j], fids[j])
        vol, pose, conv, fused, iters, energy, nvalid, overflow = _chunk_step(
            vol, pose, gt_poses[j], use_gt=use_gt, track=track, fuse=fuse)
        outs.append((pose, conv, fused, iters, energy, nvalid, overflow))

    poses, conv, fused, iters, energy, nvalid, overflow = (
        torch.stack([o[k] for o in outs]) for k in range(7)
    )
    return vol, ChunkResult(
        poses=poses, converged=conv, fused=fused, iterations=iters,
        energy=energy, num_valid=nvalid, sharpness=sharp,
        fuse_overflow=overflow,
        readout=pack_readout(poses, conv, fused, iters, energy, nvalid, sharp, overflow),
        colors=colors,
    )
