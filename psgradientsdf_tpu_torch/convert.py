"""State carried across the numpy boundary.

This system has no learned weights; the volume (in its SoA, packed or
chunk-resident layout), the FALS cache, the poses and the grid geometry are
its state.  These functions build that state from
numpy arrays in the JAX package's layouts and hand it back as numpy, so a
volume made by either package can be continued by the other from identical
values.  The same holds for the refinement: a problem extracted by either
package, and the refiner's state (distances, albedo, stored gradients, poses,
lights, keyframe images, intrinsics), cross as numpy arrays.

Visibility words cross the boundary as uint32 (the JAX package's dtype); on
the device they are the same 32 bits held as int32, and every crossing is a
`.view` of the bits, never a value cast.  The checkpoint files of
io/checkpoint.py are written and read through these functions, so their
arrays carry the JAX package's dtypes: uint32 visibility words, int32 stencil
indices, a 0-d int32 surface count, and the refinement's loop state as JSON
bytes in a uint8 array.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from psgradientsdf_tpu_torch import resolve_device
from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.core.resident import ResidentVolume
from psgradientsdf_tpu_torch.core.volume import GradSdfVolume, PackedVolume
from psgradientsdf_tpu_torch.ops.normals import FalsCache
from psgradientsdf_tpu_torch.refine.problem import RefineProblem


def _f32(a, dev) -> torch.Tensor:
    # np.array copies: a read-only source (a JAX array's buffer) is fine
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(dev)


def _words(vis, dev) -> torch.Tensor:
    """Visibility words (uint32, or their int32 bit patterns) as int32 bit
    patterns on `dev`."""
    vis = np.array(vis, order="C")
    if vis.dtype == np.uint32:
        vis = vis.view(np.int32)
    elif vis.dtype != np.int32:
        raise TypeError(f"visibility words must be uint32 or int32, got {vis.dtype}")
    return torch.from_numpy(vis).to(dev)


def _words_np(vis: torch.Tensor) -> np.ndarray:
    return vis.detach().cpu().numpy().view(np.uint32)


def volume_from_numpy(dist, grad, weight, color, vis, device=None) -> GradSdfVolume:
    """dist [Z,Y,X], grad [Z,Y,X,3], weight [Z,Y,X], color [Z,Y,X,3] float32
    and vis [W,Z,Y,X] uint32 -> a contiguous GradSdfVolume on `device`."""
    dev = resolve_device(device)
    return GradSdfVolume(
        dist=_f32(dist, dev), grad=_f32(grad, dev), weight=_f32(weight, dev),
        color=_f32(color, dev), vis=_words(vis, dev))


def volume_to_numpy(vol: GradSdfVolume) -> Dict[str, np.ndarray]:
    """The volume as numpy arrays; vis as uint32 words."""
    out = {k: getattr(vol, k).detach().cpu().numpy()
           for k in ("dist", "grad", "weight", "color")}
    out["vis"] = _words_np(vol.vis)
    return out


def packed_volume_from_numpy(payload, vis, device=None) -> PackedVolume:
    """payload [Z,Y,X,8] (or a streaming [NSEG, S*8]) float32 and vis
    [W,Z,Y,X] (or [W, NSEG, S]) uint32 -> a PackedVolume on `device`."""
    dev = resolve_device(device)
    return PackedVolume(payload=_f32(payload, dev), vis=_words(vis, dev))


def packed_volume_to_numpy(pvol: PackedVolume) -> Dict[str, np.ndarray]:
    """The packed volume as numpy arrays; vis as uint32 words."""
    return dict(payload=pvol.payload.detach().cpu().numpy(),
                vis=_words_np(pvol.vis))


def resident_from_numpy(rows, vis_rows, row_slot, slot_rows, n_used,
                        fused_ever, flags, device=None) -> ResidentVolume:
    """A ResidentVolume from numpy arrays in the JAX package's dtypes:
    float32 rows, uint32 vis_rows, int32 row_slot / slot_rows and the 0-d
    int32 n_used / flags, bool fused_ever."""
    dev = resolve_device(device)

    def i32(a):
        return torch.from_numpy(np.array(a, dtype=np.int32, order="C")).to(dev)

    return ResidentVolume(
        rows=_f32(rows, dev), vis_rows=_words(vis_rows, dev),
        row_slot=i32(row_slot), slot_rows=i32(slot_rows), n_used=i32(n_used),
        fused_ever=torch.from_numpy(np.array(fused_ever, dtype=np.bool_)).to(dev),
        flags=i32(flags))


def resident_to_numpy(res: ResidentVolume) -> Dict[str, np.ndarray]:
    """The resident state as numpy arrays keyed by its field names, in the
    JAX package's dtypes (vis_rows as uint32 words)."""
    out = {k: getattr(res, k).detach().cpu().numpy() for k in res._fields}
    out["vis_rows"] = _words_np(res.vis_rows)
    return out


def fals_from_numpy(x0_n_sq_inv, y0_n_sq_inv, n_sq_inv, Q, device=None) -> FalsCache:
    dev = resolve_device(device)
    return FalsCache(_f32(x0_n_sq_inv, dev), _f32(y0_n_sq_inv, dev),
                     _f32(n_sq_inv, dev), _f32(Q, dev))


def geometry(dims: Sequence[int], voxel_size: float,
             shift: Sequence[float]) -> GridGeometry:
    return GridGeometry(dims=tuple(int(d) for d in dims),
                        voxel_size=float(voxel_size),
                        shift=tuple(float(s) for s in shift))


_PROBLEM_INT = ("nbr_idx", "lap_idx")


def problem_from_numpy(fields: Dict[str, np.ndarray], device=None) -> RefineProblem:
    """A RefineProblem from numpy arrays keyed by its field names, in the JAX
    package's dtypes (int32 indices, bool masks, float32 values)."""
    dev = resolve_device(device)
    out = {}
    for k in RefineProblem._fields:
        a = np.array(fields[k])
        if k == "n_surface":
            out[k] = int(a)
        elif k in _PROBLEM_INT:
            out[k] = torch.from_numpy(a.astype(np.int64)).to(dev)
        elif k == "idx_xyz":
            out[k] = torch.from_numpy(a.astype(np.int32)).to(dev)
        elif a.dtype == np.bool_:
            out[k] = torch.from_numpy(a).to(dev)
        else:
            out[k] = _f32(a, dev)
    return RefineProblem(**out)


def problem_to_numpy(prob: RefineProblem) -> Dict[str, np.ndarray]:
    """The problem as numpy arrays in the JAX package's dtypes, in its field
    order."""
    out = {}
    for k, v in zip(prob._fields, prob):
        if k == "n_surface":
            out[k] = np.array(v, dtype=np.int32)
        else:
            a = v.detach().cpu().numpy()
            out[k] = a.astype(np.int32) if k in _PROBLEM_INT else a
    return out


def refiner_state_from_numpy(dist, albedo, grad_stored, poses, lights, images,
                             K, device=None) -> Dict[str, torch.Tensor]:
    """The refiner's state as float32 tensors on `device`, keyed by the
    PhotometricRefiner attribute each belongs to."""
    dev = resolve_device(device)
    return dict(dist=_f32(dist, dev), albedo=_f32(albedo, dev),
                grad_stored=_f32(grad_stored, dev), poses=_f32(poses, dev),
                lights=_f32(lights, dev), images=_f32(images, dev),
                K=_f32(K, dev))


def loop_state_to_numpy(loop_state: Optional[dict]) -> np.ndarray:
    """The refinement's loop state as JSON bytes in a uint8 array ({} for
    none); Python floats print with repr, so every number reads back exactly."""
    return np.frombuffer(json.dumps(loop_state or {}).encode(), dtype=np.uint8)


def loop_state_from_numpy(arr: np.ndarray) -> Optional[dict]:
    return json.loads(bytes(np.asarray(arr, dtype=np.uint8)).decode() or "{}") or None
