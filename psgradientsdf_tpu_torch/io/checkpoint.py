"""Checkpoint / resume: exact snapshots of the reconstruction state.

Counterpart of the JAX package's io/checkpoint.py, in its file format, so a
checkpoint written by either package resumes in the other:

  * <path>            .npz of the volume: dist, grad, weight, color (float32)
                      and vis (uint32 words);
  * <path>.json       the sidecar: grid geometry and a "meta" dict;
  * <path>.scan       (scan state) cur_pose [4,4], key_poses [K,4,4],
                      key_images [K,H,W,3] in the loader's wire format;
  * <path>.refine     (refinement state) poses, lights, dist, albedo,
                      grad_stored, the loop state as JSON bytes in uint8 and
                      every RefineProblem field as prob_<name> in the JAX
                      package's dtypes (int32 stencil indices, a 0-d int32
                      surface count);
  * <path>.images     (refinement) the keyframe images, float32, written on
                      a run's first refinement checkpoint only (stored,
                      not deflated: np.load reads either).

The arrays cross through convert.py: visibility words are `.view`ed between
the device's int32 and the file's uint32, never cast.  Every file is written
to a temporary name and renamed into place, and the sidecar is written last:
it is what a resume looks at first (its "phase" says scan or refinement), so
a save torn by a crash never shows a valid sidecar over missing arrays.
Nothing is pickled; loads put the tensors on the device the caller names.

In a process group (parallel/distributed.py) every process calls the
savers: all join the gathers of the volume and of the refinement's arrays,
and process 0 alone writes, through distributed.on_process_zero, so that a
failed write raises on every process.  The file is the one-device file
whatever the number of processes, and resumes on any number.  Every
process reads the whole file on the host; a run on a mesh then copies to
its cards only the slabs, rows and keyframes of its own mesh entries.

The loaders also read the older layouts the JAX package's loader reads:
companions saved with an ".npz" suffix (<path>.scan.npz, .refine.npz,
.images.npz), the keyframe images inline in <path>.refine, no prob_* arrays
(the problem is extracted again from the saved volume) and no loop state
(the refinement then starts its loop afresh).

The port adds one key to the refinement's loop-state JSON, "energy_trace"
(PhotometricRefiner.energy_trace, so the trace runs on across a resume); the
JAX package's loader ignores keys it does not read, and a JAX-written loop
state without it resumes with an empty trace.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from psgradientsdf_tpu_torch import convert
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.core.volume import GradSdfVolume
from psgradientsdf_tpu_torch.parallel import distributed
from psgradientsdf_tpu_torch.refine.problem import RefineProblem, extract_problem


def _atomic_savez(path: str, compressed: bool = True, **arrays) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    # np.savez appends ".npz" unless the name already ends with it, so the
    # temporary name carries the suffix for the rename to find the file
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        (np.savez_compressed if compressed else np.savez)(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _atomic_json(path: str, obj) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".",
                               suffix=".tmp.json")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(obj, fh, indent=2)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def checkpoint_bytes(path: str) -> int:
    """Bytes on disk of the checkpoint at `path` with its companion files."""
    d, base = os.path.split(os.path.abspath(path))
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d)
               if n.startswith(base))


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def save_volume(path: str, vol: GradSdfVolume, geom: GridGeometry,
                meta: Optional[Dict[str, Any]] = None) -> None:
    _atomic_savez(path, **convert.volume_to_numpy(vol))
    _atomic_json(path + ".json", {
        "geometry": {
            "dims": [int(d) for d in geom.dims],
            "voxel_size": float(geom.voxel_size),
            "shift": [float(s) for s in geom.shift],
        },
        "meta": meta or {},
    })


def load_volume(path: str, device=None
                ) -> Tuple[GradSdfVolume, GridGeometry, Dict[str, Any]]:
    with open(path + ".json") as fh:
        sidecar = json.load(fh)
    g = sidecar["geometry"]
    geom = convert.geometry(g["dims"], g["voxel_size"], g["shift"])
    with np.load(path) as data:
        vol = convert.volume_from_numpy(
            data["dist"], data["grad"], data["weight"], data["color"],
            data["vis"], device=device)
    return vol, geom, sidecar.get("meta", {})


@dataclasses.dataclass
class ScanState:
    """Resumable scan-loop state (the reference's frame loop has none)."""
    next_frame: int
    cur_pose: np.ndarray                  # [4,4]
    pose_lines: List[str]
    key_indices: List[int]
    key_stamps: List[str]
    key_poses: List[np.ndarray]
    dist_to_last_kf: int


def save_scan_state(path: str, vol: GradSdfVolume, geom: GridGeometry,
                    state: ScanState, key_images: List[np.ndarray]) -> None:
    """Write the scan's state; `vol` is the whole volume.  In a process
    group every process calls this with the same arguments and process 0
    alone writes (parallel/distributed.on_process_zero): every process
    returns, or every process raises what the write raised."""
    def write():
        _atomic_savez(
            path + ".scan",
            cur_pose=np.asarray(state.cur_pose),
            key_poses=(np.stack(state.key_poses) if state.key_poses
                       else np.zeros((0, 4, 4))),
            key_images=(np.stack(key_images) if key_images
                        else np.zeros((0, 1, 1, 3))),
        )
        save_volume(path, vol, geom, meta={
            "next_frame": int(state.next_frame),
            "pose_lines": list(state.pose_lines),
            "key_indices": [int(v) for v in state.key_indices],
            "key_stamps": list(state.key_stamps),
            "dist_to_last_kf": int(state.dist_to_last_kf),
        })

    distributed.on_process_zero(write)


def companion(path: str, kind: str) -> str:
    """The companion file <path>.<kind>, or <path>.<kind>.npz that older
    writers left (np.savez appends the suffix); "" when neither exists."""
    for name in (f"{path}.{kind}.npz", f"{path}.{kind}"):
        if os.path.exists(name):
            return name
    return ""


def _companion(path: str, kind: str) -> str:
    name = companion(path, kind)
    if not name:
        raise FileNotFoundError(f"{path}.{kind}: no such checkpoint companion")
    return name


def load_scan_state(path: str, device=None):
    """-> (volume on `device`, geometry, ScanState, key_images as numpy).
    A scan on a mesh loads onto the host and places its own slabs
    (parallel/mesh.shard_volume)."""
    vol, geom, meta = load_volume(path, device=device)
    with np.load(_companion(path, "scan")) as data:
        cur_pose = data["cur_pose"]
        key_poses = list(data["key_poses"])
        key_images = list(data["key_images"])
    state = ScanState(
        next_frame=int(meta["next_frame"]),
        cur_pose=cur_pose,
        pose_lines=list(meta["pose_lines"]),
        key_indices=[int(v) for v in meta["key_indices"]],
        key_stamps=list(meta["key_stamps"]),
        key_poses=key_poses,
        dist_to_last_kf=int(meta["dist_to_last_kf"]),
    )
    if not len(key_poses) == len(key_images) == len(state.key_indices):
        raise ValueError(
            f"{path}: {len(state.key_indices)} keyframes in the sidecar, "
            f"{len(key_poses)} poses and {len(key_images)} images in "
            f"{path}.scan (a torn checkpoint)")
    return vol, geom, state, key_images


def save_refine_state(path: str, refiner) -> None:
    """Snapshot a PhotometricRefiner mid-optimization (exact resume).

    Saves the compacted RefineProblem verbatim rather than re-extracting on
    load: refinement moves voxel distances, so a fresh extraction could
    select another active set than the run being resumed.  Saves the loop's
    scalar state (refiner.loop_state) so the resumed loop is exact,
    including the iteration-indexed upsample and Laplacian branches.  In a
    process group every process calls this: all join the gathers, in mesh
    order, and process 0 alone writes (distributed.on_process_zero).
    """
    refiner.sync_to_volume()
    # on a mesh: the global arrays, gathered onto the first device, so the
    # file is the one-device file and resumes anywhere
    first = not getattr(refiner, "_ckpt_images_saved", False)
    prob, dist, albedo, grad_stored, images = refiner.gathered(with_images=first)

    def write():
        # the keyframe images do not change during refinement and are the
        # largest array: written on this run's first checkpoint only (always
        # then, so a stale .images of an older run can never pair with this
        # one), and stored, not deflated: zlib takes about 80 ms a MB of these
        # floats and saves two thirds of the bytes (147 MB at F = 40 and
        # 640x480)
        if first:
            _atomic_savez(path + ".images", compressed=False,
                          images=_f32(images))
        arrays = {f"prob_{k}": v
                  for k, v in convert.problem_to_numpy(prob).items()}
        _atomic_savez(
            path + ".refine",
            poses=_f32(refiner.poses),
            lights=_f32(refiner.lights),
            dist=_f32(dist),
            albedo=_f32(albedo),
            grad_stored=_f32(grad_stored),
            loop_state=convert.loop_state_to_numpy(refiner.loop_state),
            **arrays,
        )
        # volume + sidecar LAST: the sidecar's phase=refine marker is what
        # resume selection keys on
        save_volume(path, refiner.vol, refiner.geom, meta={
            "keyframe_indices": [int(v) for v in refiner.keyframe_indices],
            "timestamps": list(refiner.timestamps),
            "model": refiner.cfg.model,
            "phase": "refine",
        })

    distributed.on_process_zero(write)
    refiner._ckpt_images_saved = True


def load_refine_state(path: str, refiner) -> None:
    """Restore a refiner saved by save_refine_state (same config) onto the
    refiner's device (its constructor's `device=`); older layouts as the
    module docstring says.  The arrays come back whole.  A refiner on a mesh
    gets the problem, its state vectors and the keyframe images on the host:
    its place_on_mesh() then copies to each of this process's mesh entries
    only its own share; the volume, the poses and the lights go to the
    refiner's device, as the refinement keeps them there."""
    dev = refiner.device
    # what place_on_mesh shares out stays on the host until it does
    host = torch.device("cpu") if refiner.mesh is not None else dev
    vol, geom, meta = load_volume(path, device=dev)
    refiner.vol = vol
    refiner.geom = geom
    refiner.keyframe_indices = [int(v) for v in meta["keyframe_indices"]]
    refiner.timestamps = list(meta["timestamps"])

    def tensor(a, where=host):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(where)

    with np.load(_companion(path, "refine")) as data:
        if "images" in data:            # an older layout: the images inline
            refiner.images = tensor(data["images"])
        else:
            with np.load(_companion(path, "images")) as im:
                refiner.images = tensor(im["images"])
        refiner.poses = tensor(data["poses"], dev)
        refiner.lights = tensor(data["lights"], dev)
        if "prob_valid" in data:
            refiner.prob = convert.problem_from_numpy(
                {k: data[f"prob_{k}"] for k in RefineProblem._fields},
                device=host)
        else:       # an older layout without the frozen active set
            refiner.prob = extract_problem(vol, geom, refiner.keyframe_indices)
        refiner.rebuild_stencil()
        refiner.dist = tensor(data["dist"])
        refiner.albedo = tensor(data["albedo"])
        refiner.grad_stored = tensor(data["grad_stored"])
        refiner.loop_state = (convert.loop_state_from_numpy(data["loop_state"])
                              if "loop_state" in data else None)
    refiner._ckpt_images_saved = False   # a resumed run saves them once
