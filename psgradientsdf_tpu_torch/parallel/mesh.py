"""Device meshes and the Z-slab layout of the volume.

Counterpart of the JAX package's parallel/mesh.py.  The JAX package places
Z-slabs of the voxel grid on a `jax.sharding.Mesh` and lets psum / ppermute
move the few bytes that cross between them.  Here one Python process drives
every device of the mesh: a `ShardedVolume` holds one GradSdfVolume slab per
Z shard, each on its own mesh device, the scan runs each shard's body in
turn (parallel/shard.py), and every cross-device sum goes through
`reduce_to_first`, which adds the shards' tensors onto the first device in
shard order (the refinement adds `all_gather` and `reduce_scatter` of an
N-vector beside it).  Two axes, as in the JAX package:

  "z"       — spatial Z-slab sharding of the dense voxel grid; fusion and
              per-voxel work are slab-local, finite-difference stencils
              need one-plane halos (parallel/halo.py), the tracker's
              Gauss-Newton sums are one reduction per iteration.
  "frames"  — keyframe sharding of the refinement (parallel/refine.py);
              the scan keeps slab k on the mesh's device [k, 0].

A mesh may name one device several times: on the CPU the one CPU device
holds every shard (the counterpart of the JAX tests' eight virtual CPU
devices), and several slabs may share one card.

A mesh may also span processes (parallel/distributed.make_global_mesh):
each process holds its own entries, an entry of another process is a
`Remote`, and so is every slab, block or piece that lives there.  The
callers build their lists in mesh order on every process, with the Remote
entries in place; the moves below are then collectives of the process
group that keep the one-process order of addition and report the same
counts.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from psgradientsdf_tpu_torch import resolve_device
from psgradientsdf_tpu_torch.core.volume import GradSdfVolume
from psgradientsdf_tpu_torch.parallel import distributed as pd
from psgradientsdf_tpu_torch.parallel.distributed import Remote, is_remote

Z_AXIS = "z"
FRAME_AXIS = "frames"
# the CPU's device list: its one device, once for each of the JAX tests'
# eight virtual CPU devices
CPU_SHARDS = 8


def _canonical(device) -> torch.device:
    """A device with its index ("cuda" -> "cuda:<current>"), so that devices
    compare and hash as the tensors on them report theirs (a Remote entry
    stays as it is)."""
    if is_remote(device):
        return device
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An [n_z, n_frames] array of torch devices (entries may repeat), and
    Remote entries where the mesh spans processes; `home` is this
    process's device (by default the first entry)."""

    def __init__(self, devices: np.ndarray, home=None):
        self.devices = devices
        self.shape: Dict[str, int] = {Z_AXIS: devices.shape[0],
                                      FRAME_AXIS: devices.shape[1]}
        self.home = devices[0, 0] if home is None else home

    @property
    def slab_devices(self) -> List[torch.device]:
        """The device of each Z shard's slab, in shard order."""
        return [self.devices[k, 0] for k in range(self.shape[Z_AXIS])]

    @property
    def first_device(self) -> torch.device:
        """Where reductions land and the replicated work runs: the first
        entry's device, or on a mesh over processes each process's own."""
        return self.home

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[Z_AXIS]}x{self.shape[FRAME_AXIS]}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def make_mesh(n_z: int = 0, n_frames: int = 1, devices=None, device=None) -> Mesh:
    """(n_z x n_frames) mesh; n_z=0 -> all remaining devices for z.

    With no `devices`: the CUDA devices cuda:0 ... cuda:{count-1}, or on the
    CPU (device="cpu") the CPU device CPU_SHARDS times.  An explicit list may
    repeat a device (several slabs on one card).  Inside a process group of
    several processes the mesh is distributed.make_global_mesh's."""
    if pd.active():
        raise ValueError("a process group of several processes runs on "
                         "distributed.make_global_mesh, not make_mesh")
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev] * CPU_SHARDS
    devices = [_canonical(d) for d in devices]
    if n_z <= 0:
        n_z = len(devices) // max(n_frames, 1)
    need = n_z * n_frames
    if need > len(devices) or need < 1:
        raise ValueError(
            f"mesh {n_z}x{n_frames} needs {need} devices, have {len(devices)}")
    arr = np.empty((n_z, n_frames), dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i // n_frames, i % n_frames] = d
    return Mesh(arr)


class ShardedVolume(NamedTuple):
    """One GradSdfVolume slab per Z shard, slab k on the mesh's slab device
    k.  dist / grad / weight / color are split on their axis 0, vis on its
    axis 1 (the JAX package's volume_specs).  `interleaved`: slab k holds
    the global planes {k, k + n_z, ...} (interleave_volume) instead of a
    contiguous run of them."""
    slabs: Tuple[GradSdfVolume, ...]
    interleaved: bool

    def clone(self) -> "ShardedVolume":
        return ShardedVolume(tuple(local_map(GradSdfVolume.clone, self.slabs)),
                             self.interleaved)


def _permute_z(vol: GradSdfVolume, n_z: int, inverse: bool) -> GradSdfVolume:
    Z = vol.dist.shape[0]
    if Z % n_z:
        raise ValueError(f"grid Z={Z} not divisible by mesh z={n_z}")
    Zl = Z // n_z

    def one(t, z_axis):
        pre, post = t.shape[:z_axis], t.shape[z_axis + 1:]
        # stored [n_z, Zl] blocks <-> logical z = local * n_z + shard
        blocks = (n_z, Zl) if inverse else (Zl, n_z)
        a = t.reshape(pre + blocks + post).transpose(z_axis, z_axis + 1)
        return a.reshape(t.shape)           # a contiguous copy

    return GradSdfVolume(
        dist=one(vol.dist, 0), grad=one(vol.grad, 0), weight=one(vol.weight, 0),
        color=one(vol.color, 0), vis=one(vol.vis, 1))


def interleave_volume(vol: GradSdfVolume, n_z: int) -> GradSdfVolume:
    """Reorder Z planes into the strided-interleave layout: stored plane
    (k*Zl + i) = logical plane (i*n_z + k), so Z-slab shard k holds the
    strided global planes {k, k+n_z, ...}.  Striding balances the shards'
    active-row counts on frustum scenes (the frustum concentrates in a few
    contiguous slabs but touches every residue class).  A pure relabelling;
    the result is contiguous."""
    return _permute_z(vol, n_z, inverse=False)


def deinterleave_volume(vol: GradSdfVolume, n_z: int) -> GradSdfVolume:
    """Inverse of interleave_volume (back to logical plane order)."""
    return _permute_z(vol, n_z, inverse=True)


def _own(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of `t` on `dev` that shares no storage with it (a
    slab's row tables are views of its own storage)."""
    return t.to(dev, copy=True, memory_format=torch.contiguous_format)


def shard_volume(vol: GradSdfVolume, mesh: Mesh,
                 interleave: bool = False) -> ShardedVolume:
    """Place a volume on the mesh as Z-slabs, copied: `vol` is left as it
    was.  interleave=True stores the strided layout (interleave_volume).
    `vol` may lie on the host (a checkpoint's): only this process's slabs
    are copied to their devices, the others' are their Remote."""
    n_z = mesh.shape[Z_AXIS]
    Z = vol.dist.shape[0]
    if Z % n_z:
        raise ValueError(f"grid Z={Z} not divisible by mesh z={n_z}")
    if interleave:
        vol = interleave_volume(vol, n_z)
    Zl = Z // n_z
    slabs = []
    for k, dev in enumerate(mesh.slab_devices):
        if is_remote(dev):
            slabs.append(dev)
            continue
        sl = slice(k * Zl, (k + 1) * Zl)
        slabs.append(GradSdfVolume(
            dist=_own(vol.dist[sl], dev), grad=_own(vol.grad[sl], dev),
            weight=_own(vol.weight[sl], dev), color=_own(vol.color[sl], dev),
            vis=_own(vol.vis[:, sl], dev)))
    return ShardedVolume(tuple(slabs), interleave)


def gather_volume(svol: ShardedVolume, device) -> GradSdfVolume:
    """The whole volume on one device, in logical plane order (the
    counterpart of np.asarray of a sharded array); over processes an
    all-gather of the slabs, after which every process holds it."""
    dev = _canonical(device)

    def cat(name, axis):
        parts = [s if is_remote(s) else getattr(s, name) for s in svol.slabs]
        if pd.active():
            parts = pd.exchange(parts, dev)
        return torch.cat([p.to(dev) for p in parts], dim=axis)

    vol = GradSdfVolume(dist=cat("dist", 0), grad=cat("grad", 0),
                        weight=cat("weight", 0), color=cat("color", 0),
                        vis=cat("vis", 1))
    if svol.interleaved:
        vol = deinterleave_volume(vol, len(svol.slabs))
    return vol


def local_map(fn, *seqs) -> list:
    """fn over the positions of mesh-ordered lists whose entries are all
    local; a position held by another process keeps its Remote."""
    out = []
    for xs in zip(*seqs):
        far = next((x for x in xs if is_remote(x)), None)
        out.append(far if far is not None else fn(*xs))
    return out


# every cross-device move of the scan and the refinement goes through
# reduce_to_first, all_gather or reduce_scatter; these count what a mesh of
# distinct devices moves for them: every shard's piece, the ones already on
# their destination included (an upper bound).  "calls", "elements" and
# "largest" (the most elements of one moved tensor) add up all three kinds;
# the other keys count each kind's calls.  Over processes every process
# counts every piece, its own and the others', so that each reports what
# the one-process mesh reports
reduce_counts: Dict[str, int] = {"calls": 0, "elements": 0, "largest": 0,
                                 "reduces": 0, "all_gathers": 0,
                                 "reduce_scatters": 0}


def reset_reduce_counts() -> None:
    for k in reduce_counts:
        reduce_counts[k] = 0


def _count(kind: str, sizes: Sequence[int]) -> None:
    """One move of `kind` whose pieces hold `sizes` elements."""
    reduce_counts[kind] += 1
    reduce_counts["calls"] += 1
    reduce_counts["elements"] += sum(sizes)
    reduce_counts["largest"] = max(reduce_counts["largest"], max(sizes))


def _add(pieces: Sequence[torch.Tensor], dev) -> torch.Tensor:
    """The pieces added in order on `dev`."""
    total = pieces[0].to(dev)
    for t in pieces[1:]:
        total = total + t.to(dev)
    return total


def reduce_to_first(tensors: Sequence[torch.Tensor], dest=None) -> torch.Tensor:
    """The sum of the shards' tensors (one shape), on the first one's
    device, added in shard order.

    Over processes the pieces are all-gathered and added in the same order:
    with dest=None on every process (on its own device: the replicated
    work reads it there), else only on the process that holds `dest` (a
    device, or a Remote that the others get back)."""
    if not pd.active():
        _count("reduces", [t.numel() for t in tensors])
        return _add(tensors, tensors[0].device)
    to = pd.home() if dest is None or is_remote(dest) else _canonical(dest)
    pieces = pd.exchange(tensors, to)
    _count("reduces", [t.numel() for t in pieces])
    return dest if is_remote(dest) else _add(pieces, to)


def all_gather(chunks: Sequence[torch.Tensor], devices) -> Dict[torch.device, torch.Tensor]:
    """The shards' chunks of an N-vector joined in shard order, once on each
    distinct device of `devices` (this process's, over processes, where
    the chunks are all-gathered): {device: [N, ...]}.  Counted as a mesh of
    distinct devices moves it: one copy for every entry of `devices`."""
    devices = list(devices)
    if pd.active():
        chunks = pd.exchange(chunks, pd.home())
    out = {d: (chunks[0].to(d) if len(chunks) == 1
               else torch.cat([c.to(d) for c in chunks]))
           for d in dict.fromkeys(devices) if not is_remote(d)}
    _count("all_gathers", [c.numel() for c in chunks] * len(devices))
    return out


def reduce_scatter(partials: Sequence[torch.Tensor], bounds: Sequence[int],
                   devices) -> List[torch.Tensor]:
    """Chunk k (rows bounds[k]:bounds[k+1], on devices[k]) of the sum of
    full-length partials, added in partial order.  Over processes each
    process receives its chunks' slices of the others' partials (one
    all-to-all) and adds them in the same order; a chunk of another process
    is its Remote."""
    n = len(bounds) - 1
    if not pd.active():
        shape = partials[0].shape
        slices = {k: [p[bounds[k]:bounds[k + 1]] for p in partials]
                  for k in range(n)}
    else:
        slices, shape = pd.scatter_slices(
            partials, bounds, [d.rank if is_remote(d) else pd.rank()
                               for d in devices], pd.home())
    tail = math.prod(shape[1:])
    _count("reduce_scatters", [(bounds[k + 1] - bounds[k]) * tail
                               for k in range(n) for _ in partials])
    return [dev if is_remote(dev) else _add(slices[k], dev)
            for k, dev in enumerate(devices)]
