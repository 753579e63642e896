"""End-to-end reconstruction pipeline: track -> fuse -> select keyframes ->
export the initial artifacts -> photometric refinement -> export the refined
ones.

Counterpart of the reference application loop (cpp/voxel_ps/src/
main_ps.cpp:41-343): same orchestration, same artifacts (tracking_poses.txt,
init_mesh.ply, init_pointcloud.ply, init_sdf.sdf, then final_refined_mesh.ply,
final_refined_pointcloud.ply, final_refined_sdf.sdf,
final_refined_poses.txt), with the
state on the device from the first frame to the last export.

Crash safety: with `checkpoint_every` N and an output directory the scan
writes scan_checkpoint.npz every N frames (at the first chunk boundary past
them) and the refinement refine_checkpoint.npz every N iterations
(io/checkpoint.py); `resume` continues from either exactly.

The initial export runs on a writer thread (utils/writer.py) while the
refinement sets up; run() joins it and raises what it raised.

A "mesh shape" (or the command line's --mesh) other than 1x1 runs the scan
on a device mesh (parallel/): the volume lives as Z-slabs, one per mesh
device, from placement to the end of the scan; checkpoints, the export and
`self.vol` after the scan are the gathered volume in logical plane order,
so a checkpoint resumes on a mesh or on one device alike.  The refinement
then runs on the same mesh (parallel/refine.py): the problem is extracted
from the gathered volume on the first device, as the JAX package extracts
one global array, and placed on the mesh (PhotometricRefiner.place_on_mesh),
its surface set over "z" and its keyframes over "frames".

Inside a process group of several processes (parallel/distributed.initialize
on every process before the pipeline is made) the mesh spans the processes
(distributed.make_global_mesh): each process holds its own mesh rows, slabs
and refinement blocks, and every cross-process move is a collective.  Every
process reads the frames, joins the volume's all-gather at the scan's end
and extracts the same problem; only process 0 writes the output files and
runs the writer threads.  Checkpoints and resume work there too: give every
process the same `checkpoint_every` and `resume`.  Every process joins a
checkpoint's gathers and process 0 alone writes the file, the one-device
file (io/checkpoint.py); every process resumes from that one file, reads it
on the host and places only its own slabs, rows and keyframes.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from psgradientsdf_tpu_torch import resolve_device
from psgradientsdf_tpu_torch.config import PipelineConfig
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.core.volume import (
    ROWS_IMPLS,
    GradSdfVolume,
    fuse_frame,
    make_volume,
    surface_band_mask,
)
from psgradientsdf_tpu_torch.io import checkpoint as ckpt
from psgradientsdf_tpu_torch.io import ply, sdf_io, trajectory
from psgradientsdf_tpu_torch.io.loaders import ImageLoader, make_loader
from psgradientsdf_tpu_torch.io.prefetch import PrefetchLoader
from psgradientsdf_tpu_torch.ops.marching_cubes import extract_mesh_from_volume
from psgradientsdf_tpu_torch.ops.normals import FalsCache, build_fals_cache, compute_normals
from psgradientsdf_tpu_torch.parallel import distributed
from psgradientsdf_tpu_torch.parallel.mesh import (
    ShardedVolume,
    gather_volume,
    make_mesh,
    shard_volume,
)
from psgradientsdf_tpu_torch.parallel.shard import sharded_fuse_frame
from psgradientsdf_tpu_torch.refine.optimizer import PhotometricRefiner
from psgradientsdf_tpu_torch.tracking.graph import ScanRotation
from psgradientsdf_tpu_torch.tracking.stream import process_chunk, read_result, upload_frames
from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger
from psgradientsdf_tpu_torch.utils.timer import Timer
from psgradientsdf_tpu_torch.utils.writer import HostCopies, Writer


def compute_centroid(K: np.ndarray, depth: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Volume placement: centroid of the first (world-frame) vertex map
    (main_ps.cpp:346-375)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    H, W = depth.shape
    cols = np.arange(W, dtype=np.float32)[None, :]
    rows = np.arange(H, dtype=np.float32)[:, None]
    m = depth > 0
    x0 = (cols - cx) / fx
    y0 = (rows - cy) / fy
    pts = np.stack([x0 * depth, y0 * depth, depth], axis=-1)[m]
    pts = pts @ pose[:3, :3].T + pose[:3, 3]
    return pts.mean(axis=0).astype(np.float32)


def keyframe_sample_positions(n: int, max_num: int) -> List[int]:
    """Positions kept by uniform down-sampling to <= max_num keyframes,
    always keeping the last (sampleKeyFrame, main_ps.cpp:392-421)."""
    if n < max_num:
        return list(range(n))
    max_num -= 1
    step = n / float(max_num)
    # replicate the reference's float accumulation exactly
    pos = []
    idx = 0.0
    for _ in range(max_num):
        pos.append(int(idx))
        idx += step
    pos.append(n - 1)
    return pos


def sample_keyframes(key_indices, key_stamps, key_images, key_poses, max_num: int):
    """Down-sample keyframes (and their timestamps) uniformly to <= max_num,
    always keeping the last (sampleKeyFrame, main_ps.cpp:392-421)."""
    pos = keyframe_sample_positions(len(key_indices), max_num)
    pick = lambda xs: [xs[i] for i in pos]
    return pick(key_indices), pick(key_stamps), pick(key_images), pick(key_poses)


def _copied_frames(frames: torch.Tensor, keep: List[int]) -> List[torch.Tensor]:
    """Frames `keep` of a chunk's device frames, copied out of them (a
    rotation's staging buffer is filled again three chunks later): one copy
    for a contiguous run, else one a frame (no index goes up, so the host
    does not wait for the card)."""
    if keep and keep == list(range(keep[0], keep[-1] + 1)):
        return list(frames[keep[0]:keep[-1] + 1].clone().unbind(0))
    return [frames[j].clone() for j in keep]


class ReconstructionPipeline:
    """The full voxelPS pipeline (main_ps.cpp), with checkpoints and resume.

    `device` is "cuda" unless the caller asks for "cpu"; with no card and no
    such request the constructor raises.  `rows_impl` picks the row-movement
    kernels of the culled fusion (core/volume.fuse_frame_culled).  On one
    device with the culled fusion the scan's chunks run in the static
    buffers of a tracking/graph.ScanRotation and, with `capture` (the
    default) on a card, a full chunk as one replay of a CUDA graph;
    capture=False runs the same buffers eagerly.
    `checkpoint_every` N > 0 writes a scan checkpoint every N frames and a
    refinement checkpoint every N iterations into the output directory;
    `resume` names a scan_checkpoint.npz or refine_checkpoint.npz to go on
    from (a refinement one skips the scan).  With a "mesh shape" other than
    1x1 the scan and the refinement run on a mesh of `mesh_devices` (a list that may name one
    device several times), by default every CUDA device, or on the CPU the
    CPU device for every shard (parallel/mesh.make_mesh); the mesh's first
    device takes the place of `device`.  In a process group of several
    processes the mesh is distributed.make_global_mesh's, and
    `mesh_devices` names this process's entries (by default its device,
    once for each of its share of the mesh's entries: one mesh row a
    process when there are as many processes as rows)."""

    def __init__(self, cfg: PipelineConfig, loader: Optional[ImageLoader] = None,
                 metrics: Optional[MetricsLogger] = None, prefetch: bool = True,
                 checkpoint_every: int = 0, resume: str = "",
                 device=None, rows_impl: str = "dma", mesh_devices=None,
                 capture: bool = True):
        self.device = resolve_device(device)
        self.capture = bool(capture)
        tpu = cfg.tpu
        # in a process group only process 0 writes files
        self.writes = distributed.rank() == 0
        self.mesh = None
        if tpu.mesh_z * tpu.mesh_frames > 1:
            if tpu.grid_dim[2] % tpu.mesh_z != 0:
                raise ValueError(f"grid Z={tpu.grid_dim[2]} not divisible by "
                                 f"mesh z={tpu.mesh_z}")
            if distributed.active():
                share = max(1, tpu.mesh_z * tpu.mesh_frames // distributed.world())
                self.mesh = distributed.make_global_mesh(
                    tpu.mesh_z, tpu.mesh_frames,
                    devices=mesh_devices or [self.device] * share)
            else:
                self.mesh = make_mesh(tpu.mesh_z, tpu.mesh_frames,
                                      devices=mesh_devices, device=self.device)
            self.device = self.mesh.first_device
        if tpu.mesh_interleave_z and (self.mesh is None or tpu.fuse_rows <= 0):
            raise ValueError(
                "mesh interleave requires a z-sharded mesh and the culled "
                "fusion path ('fuse rows' > 0)")
        if rows_impl not in ROWS_IMPLS:
            raise ValueError(f"rows_impl {rows_impl!r} is not one of {ROWS_IMPLS}")
        self.cfg = cfg
        self.rows_impl = rows_impl
        self.checkpoint_every = int(checkpoint_every)
        self.resume = resume
        base = loader or make_loader(cfg.tracking.datatype, cfg.tracking.input)
        # decode-ahead workers hide the image decode behind device compute;
        # raw mode ships uint8/uint16 to the device and converts there
        self.loader = PrefetchLoader(base, raw=True) if prefetch else base
        self._depth_unit = base.unit if getattr(self.loader, "raw", False) else 1.0
        out = cfg.tracking.output
        if out:
            os.makedirs(out, exist_ok=True)
        self._own_metrics = metrics is None
        self.metrics = metrics or MetricsLogger(
            os.path.join(out, "metrics.jsonl") if out and self.writes else None
        )
        self.timer = Timer(verbose=False)
        self.vol: Optional[GradSdfVolume] = None
        self.geom: Optional[GridGeometry] = None
        self.fals: Optional[FalsCache] = None
        self.K: Optional[np.ndarray] = None
        self.track_log: List[Dict] = []
        self.refiner: Optional[PhotometricRefiner] = None
        # keyframes chosen by the scan (what the refinement consumes): frame
        # counters, rgb timestamps, wire-format images on the host and the
        # same images on the device, poses
        self.key_indices: List[int] = []
        self.key_stamps: List[str] = []
        self.key_images: List[np.ndarray] = []
        self.key_images_dev: List[torch.Tensor] = []
        self.key_poses: List[np.ndarray] = []
        self.fuse_culled_calls = 0     # culled fusions of a frame, redos included
        self._export_writer: Optional[Writer] = None   # the initial export
        self.overflow_redos = 0
        self._dist_to_last_kf = 0
        self._last_ckpt_frames = 0
        self._fuse_cap = 0
        self._rotation: Optional[ScanRotation] = None
        self.scan_graph: Optional[Dict] = None    # the rotation's captures and replays
        # visibility capacity: the reference's per-voxel vector<bool> grows
        # with the frame counter without limit (VolumetricGradSdf.cpp:
        # 129-131); the bit-packed volume auto-sizes its static capacity to
        # the config's frame range (word-rounded) unless "frame cap" was set
        # explicitly, and frames past the capacity alias the last bit LOUDLY
        # (metrics warning + summary flag) instead of silently.
        tr, tpu = cfg.tracking, cfg.tpu
        if not tpu.frame_cap_explicit and tr.last < 2 ** 31 - 1:
            need = max(1, tr.last - tr.first + 1)
            self._frame_cap = -(-need // 32) * 32
        else:
            self._frame_cap = max(32, tpu.frame_cap)
        self._vis_overflowed = False

    # ------------------------------------------------------------ stages

    def run(self, refine: bool = True) -> Dict:
        cfg = self.cfg
        tr = cfg.tracking
        dev = self.device
        if not self.loader.load_intrinsics():
            raise FileNotFoundError(f"No intrinsics file found in {tr.input}")
        self.K = self.loader.K

        # a checkpoint written mid-refinement resumes the refinement directly
        # (its scan had completed): it needs only the intrinsics, so this is
        # decided before any frame is decoded
        if self.resume and os.path.exists(self.resume + ".json"):
            with open(self.resume + ".json") as fh:
                phase = json.load(fh).get("meta", {}).get("phase", "")
            if phase == "refine":
                if not refine:
                    raise ValueError(
                        "refine-phase checkpoint given but refinement is off")
                return self._resume_refine()

        first = self.loader.load_next()
        if first is None:
            raise RuntimeError("Frame could not be loaded")
        color0, depth0 = first
        H, W = depth0.shape
        if color0.shape[:2] != depth0.shape:
            raise RuntimeError("depth image and color image sizes don't match")
        self.loader.reset()

        self.timer.tic()
        self.fals = build_fals_cache(H, W, self.K, window=11, device=dev)
        self.timer.toc("init_normal_estimation")

        gt_poses = self.loader.load_pose(tr.pose_file)
        gt = gt_poses is not None
        self.metrics.log("start", gt_poses=gt, frames=f"{tr.first}..{tr.last}",
                         image=f"{H}x{W}", device=str(dev))

        # skip to first frame (no decode — loaders skip by index)
        self.loader.skip(tr.first)

        truncation = cfg.truncation
        pose_lines: List[str] = []
        key_indices, key_stamps = self.key_indices, self.key_stamps
        key_images, key_poses = self.key_images, self.key_poses
        key_indices[:] = [0]
        key_stamps.clear()
        key_images.clear()
        # device-resident copies of the keyframe images (same order): the
        # scan already uploads every frame for fusion, so the refinement
        # reuses those tensors instead of uploading the images again
        self.key_images_dev.clear()
        key_poses[:] = [np.eye(4, dtype=np.float32)]
        self._dist_to_last_kf = 0
        frames_done = 0
        t_scan = time.perf_counter()

        start = tr.first + 1
        if self.resume:
            # exact scan resume: the volume after the last collected chunk,
            # the pose it ended at, the trajectory and keyframes so far.  The
            # keyframe images come back on the host only, so the refinement
            # uploads them (_run_refine_phase).  On a mesh the volume is read
            # on the host and only this process's slabs go to its devices
            vol, self.geom, state, images = ckpt.load_scan_state(
                self.resume, device=dev if self.mesh is None else "cpu")
            held = 32 * vol.vis.shape[0]
            if held < self._frame_cap:
                # a frame past the file's visibility words has no bit to set
                raise ValueError(
                    f"{self.resume}: its volume holds visibility bits for "
                    f"{held} frames, this run's frame range needs "
                    f"{self._frame_cap}; resume with the frame range (or the "
                    "'frame cap') of the run that wrote it")
            self.vol = self._scan_layout(vol)
            cur_pose = np.asarray(state.cur_pose, np.float32)
            pose_lines = list(state.pose_lines)
            key_indices[:] = state.key_indices
            key_stamps[:] = state.key_stamps
            key_poses[:] = [np.asarray(p, np.float32) for p in state.key_poses]
            key_images[:] = images
            self._dist_to_last_kf = state.dist_to_last_kf
            start = state.next_frame
            self.loader.skip(start - tr.first)
            frames_done = len(pose_lines)
            self.metrics.log("resume", path=self.resume, next_frame=start)
        else:
            # ---- first frame: volume placement + initial fuse
            # (main_ps.cpp:178-208)
            first = self.loader.load_next()
            if first is None:
                raise RuntimeError("Frame could not be loaded")
            color, depth = self._to_metric_host(*first)
            base_pose = np.asarray(gt_poses[0] if gt else np.eye(4), np.float32)
            centroid = compute_centroid(self.K, depth, base_pose)
            self.geom = GridGeometry(
                dims=tuple(cfg.tpu.grid_dim), voxel_size=tr.voxel_size,
                shift=tuple(float(v) for v in centroid),
            )
            self.timer.tic()
            self.vol = self._scan_layout(
                make_volume(self.geom, truncation, self._frame_cap, device=dev))
            self.timer.toc("create_sdf", self.fals.n_sq_inv)
            cur_pose = base_pose
            self._fuse(color, depth, base_pose, 0)
            key_stamps.append(self.loader.rgb_timestamp)
            # store the WIRE-format image (raw uint8 under the prefetch
            # loader), matching what the chunk gate stores for every other
            # keyframe — mixing the metric float frame 0 with raw frames would
            # skip the /255 of the refinement's keyframe setup for the others
            key_images.append(first[0])
            self.key_images_dev.append(upload_frames(first[0], dev))
            if gt:
                key_poses[0] = base_pose
            pose_lines.append(
                trajectory.pose_line(self.loader.depth_timestamp, cur_pose))
            frames_done += 1

        # ---- remaining frames: chunked on-device scan (tracking/stream.py)
        C = max(1, cfg.tpu.chunk_size)
        K_dev = torch.as_tensor(self.K, dtype=torch.float32, device=dev)
        buf: List[Tuple] = []   # (frame_idx, color, depth, rgb_ts, depth_ts)

        # row-culled fusion capacity (core/volume.fuse_frame_culled): start
        # at the configured fraction of the Z*Y row count; overflow redoes
        # the chunk from its kept pre-chunk volume at a grown capacity.
        ZY = self.geom.dims[2] * self.geom.dims[1]
        if cfg.tpu.fuse_rows > 0:
            self._fuse_cap = min(ZY, max(256, -(-int(ZY * cfg.tpu.fuse_rows) // 256) * 256))
        else:
            self._fuse_cap = 0
        # on one device the culled fusion's chunks run in the rotation's
        # static buffers (tracking/graph.py), as one CUDA graph a chunk on a
        # card unless capture is off
        self._rotation = (ScanRotation(self.vol, C, capture=self.capture)
                          if self.mesh is None and self._fuse_cap else None)

        # ---- double-buffered chunk pipelining: `stage` uploads a chunk's
        # frames and enqueues its work, chaining the tracking seed off the
        # PREVIOUS chunk's on-device pose output; `collect` reads a chunk's
        # results one stage later — so the host prepares chunk k+1 while the
        # device works on chunk k.
        pending: List[Optional[dict]] = [None]
        cur_pose_dev = torch.as_tensor(cur_pose, dtype=torch.float32, device=dev)

        def make_arrays(data):
            n = len(data)
            pad = C - n
            arrs = dict(
                colors=np.stack([b[1] for b in data] + [data[-1][1]] * pad),
                depths=np.stack([b[2] for b in data] + [data[-1][2]] * pad),
                fids=np.array(
                    [self._vis_frame_id(b[0] - tr.first) for b in data]
                    + [0] * pad, np.int32),
                valid=np.array([True] * n + [False] * pad),
            )
            if gt:
                arrs["gtp"] = np.stack(
                    [np.asarray(gt_poses[min(b[0], len(gt_poses) - 1)],
                                np.float32) for b in data]
                    + [np.eye(4, dtype=np.float32)] * pad)
            else:
                arrs["gtp"] = np.broadcast_to(
                    np.eye(4, dtype=np.float32), (C, 4, 4)).copy()
            return arrs

        def dispatch(vol_in, pose_in, arrs):
            if self._fuse_cap:
                self.fuse_culled_calls += int(arrs["valid"].sum())
            return process_chunk(
                vol_in, self.geom, arrs["colors"], arrs["depths"], K_dev,
                pose_in, arrs["fids"], arrs["valid"], arrs["gtp"], self.fals,
                truncation=truncation, zmin=tr.zmin, zmax=tr.zmax,
                num_iterations=tr.num_iterations,
                conv_threshold_sq=tr.conv_threshold ** 2,
                damping=tr.damping, stride=cfg.tpu.track_stride,
                use_gt=gt, depth_unit=self._depth_unit,
                regather_every=cfg.tpu.track_regather,
                early_exit=not cfg.tpu.track_static,
                fuse_row_capacity=self._fuse_cap,
                rows_impl=self.rows_impl, mesh=self.mesh,
                interleave_z=cfg.tpu.mesh_interleave_z,
                rotation=self._rotation if self._fuse_cap else None,
                capture=self.capture, device=dev,
            )

        def _overflowed(host) -> bool:
            return bool(self._fuse_cap and host["fuse_overflow"].any())

        def grow_capacity() -> None:
            grown = min(ZY, max(self._fuse_cap * 3 // 2, 256))
            self.metrics.log("fuse_cull_overflow",
                             capacity=self._fuse_cap, grown=grown)
            # at the full row count the exact full-grid fusion takes over
            self._fuse_cap = grown if grown < ZY else 0

        def redo_sync(rec):
            """Re-run a chunk from its recorded pre-state, growing the cull
            capacity until it fits (rare; process_chunk leaves the volume it
            is given untouched, so rec still holds the pre-chunk state)."""
            while True:
                self.overflow_redos += 1
                new_vol, res = dispatch(
                    rec["vol_before"], rec["pose_before"], rec["arrs"])
                host = read_result(res)
                if _overflowed(host):
                    grow_capacity()
                    continue
                rec["vol_after"], rec["res"] = new_vol, res
                return new_vol, res, host

        def stage(data) -> None:
            nonlocal cur_pose_dev
            self.timer.tic()
            arrs = make_arrays(data)
            if self._rotation is None:
                # upload the chunk's frames ONCE (a redo reuses the device
                # copy); a rotation copies them into its staging slot
                arrs["colors"] = upload_frames(arrs["colors"], dev)
                arrs["depths"] = upload_frames(arrs["depths"], dev)
            rec = dict(data=data, arrs=arrs,
                       vol_before=self.vol, pose_before=cur_pose_dev,
                       t_stage=time.perf_counter())
            new_vol, res = dispatch(self.vol, cur_pose_dev, arrs)
            # the chunk's own post-chunk volume: process_chunk fuses into a
            # clone, so a later staged chunk never changes it, and it is what
            # a checkpoint taken when this chunk is collected must hold
            rec["vol_after"], rec["res"] = new_vol, res
            self.vol = new_vol
            cur_pose_dev = res.poses[len(data) - 1]
            self.timer.toc("stage")
            prev = pending[0]
            pending[0] = rec
            if prev is not None:
                collect(prev)

        def collect(rec) -> None:
            nonlocal cur_pose, frames_done, cur_pose_dev
            data = rec["data"]
            n = len(data)
            res = rec["res"]
            host = read_result(res)          # the chunk's one readout
            if _overflowed(host):
                # the culled fusion dropped rows: redo this chunk — and any
                # chunk already staged on top of its (incomplete) volume —
                # from the recorded pre-states at a grown capacity
                grow_capacity()
                new_vol, res, host = redo_sync(rec)
                nxt = pending[0]
                if nxt is not None and nxt is not rec:
                    nxt["vol_before"] = new_vol
                    nxt["pose_before"] = res.poses[n - 1]
                    v2, r2, _ = redo_sync(nxt)
                    self.vol = v2
                    cur_pose_dev = r2.poses[len(nxt["data"]) - 1]
                else:
                    self.vol = new_vol
                    cur_pose_dev = res.poses[n - 1]
            rec["vol_before"] = None      # release the pre-chunk volume
            poses, conv, fused = host["poses"], host["converged"], host["fused"]
            iters, energies = host["iterations"], host["energy"]
            nvalid, sharp = host["num_valid"], host["sharpness"]
            dt = time.perf_counter() - rec["t_stage"]
            self.metrics.log("chunk", frames=n, seconds=dt,
                             fps=n / max(dt, 1e-9))
            keys = []
            for j in range(n):
                idx, col_j, _, rgb_ts, depth_ts = data[j]
                cur_pose = poses[j]
                if not gt:
                    self.track_log.append(dict(
                        frame=idx, converged=bool(conv[j]), iters=int(iters[j]),
                        energy=float(energies[j]), valid=int(nvalid[j]),
                        seconds=dt / n,
                    ))
                if fused[j] and self._keyframe_gate(
                        col_j, idx - tr.first, cur_pose, float(sharp[j]), rgb_ts):
                    keys.append(j)
                pose_lines.append(trajectory.pose_line(depth_ts, cur_pose))
                frames_done += 1
            self.key_images_dev.extend(_copied_frames(res.colors, keys))
            if (self.checkpoint_every > 0 and tr.output and frames_done
                    - self._last_ckpt_frames >= self.checkpoint_every):
                # this chunk's own volume, NOT self.vol: a later staged chunk
                # may already be fused into self.vol, and a resume would fuse
                # its frames twice.  In a process group every process joins
                # the gather (the condition reads nothing that differs
                # between them) and process 0 writes
                t0 = time.perf_counter()
                path = os.path.join(tr.output, "scan_checkpoint.npz")
                ckpt.save_scan_state(
                    path, self._gathered(rec["vol_after"]), self.geom,
                    ckpt.ScanState(
                        next_frame=data[-1][0] + 1, cur_pose=cur_pose,
                        pose_lines=pose_lines, key_indices=self.key_indices,
                        key_stamps=self.key_stamps, key_poses=self.key_poses,
                        dist_to_last_kf=self._dist_to_last_kf),
                    self.key_images)
                self._last_ckpt_frames = frames_done
                if self.writes:
                    self.metrics.log("checkpoint", frame=data[-1][0],
                                     seconds=time.perf_counter() - t0,
                                     bytes=ckpt.checkpoint_bytes(path))
            rec["vol_after"] = None       # release the post-chunk volume

        self._last_ckpt_frames = frames_done
        i = start
        while i <= tr.last:
            nxt = self.loader.load_next()
            if nxt is None:
                break
            color, depth = nxt
            buf.append((i, color, depth, self.loader.rgb_timestamp,
                        self.loader.depth_timestamp))
            if len(buf) == C:
                stage(buf[:])
                buf.clear()
            i += 1
        if buf:
            stage(buf[:])
            buf.clear()
        if pending[0] is not None:
            collect(pending[0])
            pending[0] = None

        self.vol = self._gathered(self.vol)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        scan_secs = time.perf_counter() - t_scan
        if self._rotation is not None:
            # the scan's volume stays in its slot; the graphs and the other
            # slots go
            self.scan_graph = self._rotation.stats()
            self.metrics.log("scan_graph", **self.scan_graph)
            self._rotation.release()
            self._rotation = None
        self.metrics.log(
            "scan_done", frames=frames_done, seconds=scan_secs,
            fps=frames_done / max(scan_secs, 1e-9), keyframes=len(key_indices),
        )

        out = tr.output
        if out and self.writes:
            with open(os.path.join(out, "tracking_poses.txt"), "w") as fh:
                fh.write("\n".join(pose_lines) + "\n")
            self._export_initial_async(out)

        summary: Dict = dict(
            frames=frames_done, seconds=scan_secs,
            fps=frames_done / max(scan_secs, 1e-9),
            keyframes=len(key_indices), track_log=self.track_log,
            frame_cap=self._frame_cap, vis_overflow=self._vis_overflowed,
            fuse_capacity=self._fuse_cap, overflow_redos=self.overflow_redos,
            scan_graph=self.scan_graph,
        )
        try:
            if refine and key_images:
                self._run_refine_phase(summary)
        except BaseException:
            # the export thread never outlives run(); its own failure is only
            # logged while another one is on its way out
            self._join_export(swallow=True)
            raise
        self._join_export()
        return summary

    def _run_refine_phase(self, summary: Dict) -> None:
        """Refine over the (down-sampled) keyframes of the scan and export
        the refined artifacts (main_ps.cpp:300-343)."""
        cfg = self.cfg
        out = cfg.tracking.output
        # the keyframe images live on the device from the scan, unless the
        # scan was resumed: the checkpoint holds the host copies, and those
        # are uploaded (on a mesh by place_on_mesh, to this process's blocks
        # only)
        on_device = len(self.key_images_dev) == len(self.key_images)
        key_indices, key_stamps, images, key_poses = sample_keyframes(
            self.key_indices, self.key_stamps,
            self.key_images_dev if on_device else self.key_images,
            self.key_poses, cfg.tpu.keyframe_cap)
        self.refiner = PhotometricRefiner(
            self.vol, self.geom, cfg.optimizer, self.K,
            save_path=out, truncation=cfg.truncation, metrics=self.metrics,
            mesh=self.mesh,
        )
        t_sk = time.perf_counter()
        self.refiner.set_keyframes(
            torch.stack(images) if on_device else np.stack(images),
            np.stack(key_poses), key_indices, key_stamps)
        self.metrics.log("refine_setup", stage="set_keyframes",
                         seconds=time.perf_counter() - t_sk, on_device=on_device)
        self.refiner.init()
        summary.update(self._run_refinement())

    def _run_refinement(self) -> Dict:
        """Run the alternating loop on an initialized refiner, then write the
        refined SDF and poses beside the loop's own mesh and point cloud."""
        opt = self.cfg.optimizer
        out = self.cfg.tracking.output
        self.refiner.checkpoint_every = self.checkpoint_every
        if out:
            self.refiner.checkpoint_path = os.path.join(
                out, "refine_checkpoint.npz")
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        converged = self.refiner.alternating_optimize(
            opt.opt_light, opt.opt_albedo, opt.opt_distance, opt.opt_pose)
        if out:
            self.refiner.save_sdf("final_refined_sdf.sdf")
            self.refiner.save_poses("final_refined_poses")
        self.refiner.sync_to_volume()
        self.vol = self.refiner.vol
        self.geom = self.refiner.geom
        if on_card:
            torch.cuda.synchronize(self.device)
        return {
            # device memory held at the refinement's peak, the volume and
            # the keyframe images included (None off the card)
            "refine_peak_memory_bytes": (
                torch.cuda.max_memory_allocated(self.device) if on_card else None),
            "refine_seconds": time.perf_counter() - t0,
            "refine_converged": converged,
            "refine_iterations": self.refiner.iterations_run,
            "refine_stop": self.refiner.stop_reason,
            "refine_energy_trace": self.refiner.energy_trace,
        }

    def _resume_refine(self) -> Dict:
        """Skip the completed scan and go on mid-refinement from a
        checkpoint written by PhotometricRefiner.checkpoint_every."""
        cfg = self.cfg
        self.refiner = PhotometricRefiner(
            None, None, cfg.optimizer, self.K, save_path=cfg.tracking.output,
            truncation=cfg.truncation, metrics=self.metrics, device=self.device,
            mesh=self.mesh)
        ckpt.load_refine_state(self.resume, self.refiner)
        self.refiner.place_on_mesh()
        self.vol, self.geom = self.refiner.vol, self.refiner.geom
        it = (self.refiner.loop_state or {}).get("it", 0)
        self.metrics.log("resume", path=self.resume, phase="refine", iter=it)
        summary: Dict = dict(resumed_refine_iter=it, frames=0, keyframes=len(
            self.refiner.keyframe_indices), track_log=[])
        summary.update(self._run_refinement())
        return summary

    def close(self) -> None:
        """Stop the decode-ahead workers and close the metrics file this
        pipeline opened (the command line's retry makes a new pipeline)."""
        self._join_export(swallow=True)
        if isinstance(self.loader, PrefetchLoader):
            self.loader.close()
        if self._own_metrics:
            self.metrics.close()

    # ------------------------------------------------------------ helpers

    def _scan_layout(self, vol: GradSdfVolume):
        """The volume as the scan keeps it: `vol` itself on one device; on a
        mesh its Z-slabs, stored interleaved when the config asks for it."""
        if self.mesh is None:
            return vol
        return shard_volume(vol, self.mesh,
                            interleave=self.cfg.tpu.mesh_interleave_z)

    def _gathered(self, vol) -> GradSdfVolume:
        """Inverse of _scan_layout: the whole volume on the pipeline's device
        in logical plane order."""
        if isinstance(vol, ShardedVolume):
            return gather_volume(vol, self.device)
        return vol

    def _vis_frame_id(self, frame_counter: int) -> int:
        """Visibility bit index for a frame counter; frames beyond the
        capacity alias the LAST bit (so fusion math stays exact) but the
        aliasing is surfaced — a metrics warning + the `vis_overflow`
        summary flag — instead of silent."""
        if frame_counter < self._frame_cap:
            return frame_counter
        if not self._vis_overflowed:
            self._vis_overflowed = True
            self.metrics.log(
                "warn_vis_overflow", frame=frame_counter,
                frame_cap=self._frame_cap,
                note="visibility bits alias the last slot from here on; "
                     "set a larger 'frame cap' or a bounded 'last' frame")
            print(f"[pipeline] WARNING: frame {frame_counter} exceeds the "
                  f"visibility capacity {self._frame_cap}; later frames "
                  f"alias the last visibility bit", file=sys.stderr)
        return self._frame_cap - 1

    def _to_metric_host(self, color: np.ndarray, depth: np.ndarray):
        """Host-side raw->metric conversion (mirrors the float loaders)."""
        if color.dtype == np.uint8:
            color = color.astype(np.float32) / 255.0
        if not np.issubdtype(depth.dtype, np.floating):
            depth = depth.astype(np.float32) * self._depth_unit
        return color, depth

    def _fuse(self, color: np.ndarray, depth: np.ndarray, pose: np.ndarray,
              frame_counter: int) -> None:
        tr = self.cfg.tracking
        self.timer.tic()
        depth_d = torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        normals = compute_normals(depth_d, self.fals, window=11)
        zkw = dict(truncation=self.cfg.truncation, zmin=tr.zmin, zmax=tr.zmax)
        frame = (color, depth_d, normals, self.fals.n_sq_inv, self.K, pose,
                 self._vis_frame_id(frame_counter))
        if self.mesh is None:
            self.vol = fuse_frame(self.vol, self.geom, *frame, device=self.device, **zkw)
        else:
            self.vol = sharded_fuse_frame(self.mesh, self.geom, **zkw)(self.vol, *frame)
        self.timer.toc("fuse", depth_d)

    def _keyframe_gate(self, color, frame_counter, pose_np, sharp: float,
                       rgb_ts: str) -> bool:
        """Sharpness-or-gap keyframe gate (main_ps.cpp:222-258); the LAPM
        measure arrives precomputed from the chunk scan.  -> whether the
        frame is a keyframe (the caller keeps its device image)."""
        if sharp >= self.cfg.tracking.sharpness_threshold or self._dist_to_last_kf > 5:
            self.key_indices.append(frame_counter)
            self.key_stamps.append(rgb_ts)
            self.key_images.append(color)
            self.key_poses.append(pose_np)
            self._dist_to_last_kf = 0
            return True
        self._dist_to_last_kf += 1
        return False

    def _join_export(self, swallow: bool = False) -> None:
        """Join the initial export's thread and surface its outcome: what it
        raised is logged as `export_error` and raised here, or with
        swallow=True (another exception is on its way out, or a retry
        discards this pipeline) only logged."""
        writer, self._export_writer = self._export_writer, None
        if writer is None:
            return
        exc = writer.join()
        if exc is None:
            self.metrics.log("export", seconds=writer.seconds)
            return
        self.metrics.log("export_error", error=repr(exc))
        if not swallow:
            raise exc

    def _export_initial_async(self, out: str) -> None:
        """Run _export_initial on a writer thread, so that its host work
        (marching cubes, the PLY and SDF writes) overlaps the refinement's
        set-up: the device->host copies of what it reads start here, and
        the thread waits for them (utils/writer.py).  Joined before run()
        returns."""
        staged, geom = self._export_copies(), self.geom
        self._export_writer = Writer(
            lambda: self._export_initial(out, staged, geom), name="initial-export")

    def _export_copies(self) -> HostCopies:
        vol = self.vol
        return HostCopies(dict(
            dist=vol.dist, grad=vol.grad, weight=vol.weight, color=vol.color,
            band=surface_band_mask(vol, self.geom.voxel_size)))

    def _export_initial(self, out: str, staged: Optional[HostCopies] = None,
                        geom: Optional[GridGeometry] = None) -> None:
        """init_mesh.ply, init_pointcloud.ply and init_sdf.sdf of the volume
        (of the host copies `staged` of a volume on `geom`, when given: the
        refinement may rebind self.vol and self.geom meanwhile)."""
        a = (staged or self._export_copies()).arrays()
        geom = geom or self.geom
        dist, grad, colr = a["dist"], a["grad"], a["color"]
        mesh = extract_mesh_from_volume(
            dist, a["weight"], colr, geom.voxel_size, geom.origin,
        )
        ply.write_mesh_ply(
            os.path.join(out, "init_mesh.ply"), mesh.vertices, mesh.faces, mesh.colors
        )

        # point cloud: x = c_v - d ghat over the surface band
        zz, yy, xx = np.nonzero(a["band"])
        g = grad[zz, yy, xx]
        g = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
        c_v = geom.voxel2world(torch.from_numpy(
            np.stack([xx, yy, zz], axis=-1).astype(np.int32))).numpy()
        pts = c_v - dist[zz, yy, xx][:, None] * g
        ply.write_pointcloud_ply(
            os.path.join(out, "init_pointcloud.ply"), pts, g, colr[zz, yy, xx]
        )

        in_band = np.abs(dist) <= np.sqrt(3.0) * geom.voxel_size
        if in_band.any():
            z2, y2, x2 = np.nonzero(in_band)
            sl = (slice(z2.min(), z2.max() + 1), slice(y2.min(), y2.max() + 1),
                  slice(x2.min(), x2.max() + 1))
            bottom = (x2.min() * geom.voxel_size,
                      y2.min() * geom.voxel_size,
                      z2.min() * geom.voxel_size)
            sdf_io.write_sdf(os.path.join(out, "init_sdf.sdf"), dist[sl], bottom,
                             geom.voxel_size)
