"""The scan on a device mesh: Z-slab fusion, the summed-Gram tracker, and a
dense stencil over halos; and the placement of the refinement's arrays
(shard_refine_arrays; the refinement itself is parallel/refine.py).

Counterpart of the scan half of the JAX package's parallel/shard.py.  There,
shard_map runs a body per Z-slab on its own device and psum / ppermute join
them; here one process runs each slab's body in turn on the slab's device
(parallel/mesh.py) and joins them through mesh.reduce_to_first:

  * fusion is voxel-local, so a slab fuses on its own: the culled fusion
    culls and compacts the slab's own rows (ops/cull.cull_compact with the
    slab's planes, one launch) and runs the shared row-copy gather / update
    / row-copy scatter on them (core/volume._fuse_culled_slab) — one gather
    and one scatter launch per slab a frame — and only the overflow flags
    are summed;
  * the tracker's per-pixel record gather is slab-local (each slab gathers
    for the pixels whose nearest voxel lies in it), and each shard's 8x8
    Gram is summed in shard order, once per Gauss-Newton iteration: the
    iteration's one cross-device sum; the 6x6 solve and the pose update run
    on the first device, through the single-device tracker's own loop
    (tracking/tracker.run_gn_rounds);
  * a dense stencil (the Eikonal energy) reads its neighbours' planes
    through the halo exchange (parallel/halo.py).

`interleave_z` assigns shard k the strided global planes {k, k+n_z, ...}
(the volume stored by mesh.interleave_volume): fusion is per voxel, so any
plane assignment is valid, and striding balances the shards' active rows on
frustum scenes.

Inputs that every shard reads (a frame's images, K, the pose, the gate) go
to each distinct slab device once: `replicate`; the functions take either a
tensor or what replicate returned.

On a mesh over processes (parallel/distributed.py) each process runs the
bodies of its own slabs, and a slab of another process is its Remote: the
loops below visit every shard on every process, so that each calls the
moves of parallel/mesh.py in the same order.  The sums that steer the scan
(the overflow flags, the tracker's Grams) reach every process with the same
bits, so every process redoes the same chunk and takes the same
Gauss-Newton steps.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import torch

from psgradientsdf_tpu_torch.core.grid import GridGeometry
from psgradientsdf_tpu_torch.core.volume import (
    _fuse_culled_slab,
    fuse_frame,
    pack_pixel_payload,
    pack_tracking_payload,
)
from psgradientsdf_tpu_torch.ops import cull
from psgradientsdf_tpu_torch.ops.image import rgb_float
from psgradientsdf_tpu_torch.parallel import distributed as pd
from psgradientsdf_tpu_torch.parallel.halo import padded_slab
from psgradientsdf_tpu_torch.parallel.mesh import (
    FRAME_AXIS,
    Z_AXIS,
    Mesh,
    ShardedVolume,
    _canonical,
    _own,
    is_remote,
    local_map,
    reduce_to_first,
)
from psgradientsdf_tpu_torch.ops import gn
from psgradientsdf_tpu_torch.refine.problem import RefineProblem
from psgradientsdf_tpu_torch.tracking.tracker import TrackResult, run_gn_rounds

Replicated = Dict[torch.device, torch.Tensor]


def replicate(x: Union[torch.Tensor, Replicated], devices) -> Replicated:
    """`x` on each distinct device of `devices` that this process holds,
    moved once per device (a dict passes through: it is already
    replicated)."""
    if isinstance(x, dict):
        return x
    x = torch.as_tensor(x)
    return {d: x.to(d) for d in dict.fromkeys(devices) if not is_remote(d)}


def _slab_shape(mesh: Mesh, geom: GridGeometry) -> Tuple[int, int]:
    """(n_z, planes a slab) of the grid on the mesh."""
    n_z = mesh.shape[Z_AXIS]
    Zg = geom.dims[2]
    if Zg % n_z:
        raise ValueError(f"grid Z={Zg} not divisible by mesh z={n_z}")
    return n_z, Zg // n_z


def _planes(k: int, n_z: int, Zl: int, interleaved: bool, dev):
    """(z0, z_map) of slab k: its first global plane, or the global plane of
    each of its planes when interleaved."""
    if interleaved:
        return None, k + n_z * torch.arange(Zl, dtype=torch.int32, device=dev)
    return k * Zl, None


def _check_layout(svol: ShardedVolume, interleave_z: bool) -> None:
    if svol.interleaved != interleave_z:
        raise ValueError(
            f"the volume is stored {'interleaved' if svol.interleaved else 'contiguous'}"
            f" but interleave_z={interleave_z}")


# ------------------------------------------------------------------ fusion

def sharded_fuse_frame(mesh: Mesh, geom: GridGeometry, **static_kwargs):
    """Dense fusion of every voxel, slab by slab (core/volume.fuse_frame on
    each slab with its planes); no cross-device traffic.

    Returns fn(svol, color, depth, normals, n_sq_inv, K, pose, frame_idx,
    gate=None) -> new ShardedVolume (functional)."""
    n_z, Zl = _slab_shape(mesh, geom)
    devs = mesh.slab_devices

    def step(svol, color, depth, normals, n_sq_inv, K, pose, frame_idx,
             gate=None):
        ins = [replicate(x, devs) for x in (color, depth, normals, n_sq_inv, K, pose)]
        gates = None if gate is None else replicate(gate, devs)
        out = []
        for k, (slab, dev) in enumerate(zip(svol.slabs, devs)):
            if is_remote(slab):
                out.append(slab)
                continue
            z0, z_map = _planes(k, n_z, Zl, svol.interleaved, dev)
            out.append(fuse_frame(
                slab, geom, *(x[dev] for x in ins), frame_idx,
                None if gates is None else gates[dev], z0=z0, z_map=z_map,
                device=dev, **static_kwargs))
        return ShardedVolume(tuple(out), svol.interleaved)

    return step


def sharded_fuse_frame_culled_fn(
    mesh: Mesh,
    geom: GridGeometry,
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    cos_thresh_sq: float = 0.25 * 0.25,
    row_capacity: int,
    interleave_z: bool = False,
    rows_impl: str = "dma",
):
    """Per-slab row-culled fusion.  Each Z-slab culls and compacts its own
    rows (one cull_compact launch a slab) and runs the shared level-2
    gather / update / scatter (one row-copy gather and one scatter call a
    slab); the only
    cross-device traffic is the sum of the overflow flags.  `row_capacity`
    is PER SHARD.

    Returns fn(svol, color, depth, normals, n_sq_inv, K, pose, frame_idx,
    gate=None, inplace=False) -> (svol, overflowed [bool on the first
    device]); inplace=False fuses into a clone (the JAX package's
    functional contract), inplace=True into `svol` itself."""
    n_z, Zl = _slab_shape(mesh, geom)
    devs = mesh.slab_devices

    def fuse(svol, color, depth, normals, n_sq_inv, K, pose, frame_idx,
             gate=None, inplace=False):
        _check_layout(svol, interleave_z)
        if not inplace:
            svol = svol.clone()
        color, depth, normals, n_sq_inv, K, pose = (
            replicate(x, devs) for x in (color, depth, normals, n_sq_inv, K, pose))
        gates = None if gate is None else replicate(gate, devs)
        payload = {}
        flags = []
        for k, (slab, dev) in enumerate(zip(svol.slabs, devs)):
            if is_remote(slab):
                flags.append(slab)
                continue
            z0, z_map = _planes(k, n_z, Zl, interleave_z, dev)
            g = None if gates is None else gates[dev]
            c = cull.cull_compact(
                geom, depth[dev], K[dev], pose[dev], capacity=row_capacity,
                padded=True, truncation=truncation, zmin=zmin, zmax=zmax,
                z0=z0, z_rows=Zl, z_idx=z_map, gates=g)
            if dev not in payload:
                payload[dev] = pack_pixel_payload(
                    color[dev], depth[dev], normals[dev], n_sq_inv[dev])
            _, overflow = _fuse_culled_slab(
                slab, geom, z0, Zl, (c.idx, c.live, c.overflow), payload[dev],
                K[dev], pose[dev], depth[dev].shape, frame_idx, g,
                truncation=truncation, zmin=zmin, zmax=zmax,
                cos_thresh_sq=cos_thresh_sq, rows_impl=rows_impl, z_map=z_map)
            flags.append(overflow.to(torch.int32))
        return svol, reduce_to_first(flags) > 0

    return fuse


# ---------------------------------------------------------------- tracking

def sharded_tracker_fn(
    mesh: Mesh,
    geom: GridGeometry,
    img_shape: Tuple[int, int],
    *,
    truncation: float,
    zmin: float,
    zmax: float,
    num_iterations: int = 50,
    conv_threshold_sq: float = 1e-6,
    damping: float = 1.0,
    regather_every: int = 1,
    early_exit: bool = False,
    stride: int = 1,
    interleave_z: bool = False,
):
    """The Gauss-Newton tracker over Z-slab volume shards.

    Per iteration each shard forms the Gram of the pixels whose nearest
    voxel lies in its slab (the others contribute zero rows), and the
    shards' 8x8 Grams are summed onto the first device in shard order: the
    one cross-device sum of the iteration, 64 numbers a shard.  The loop,
    the solve, the pose update and the meaning of `regather_every`,
    `early_exit` and `stride` are the single-device tracker's
    (tracking/tracker.run_gn_rounds, track_frame).  `depth` arrives
    sub-sampled when stride > 1, as in the JAX package.

    Returns fn(svol, depth, K, init_pose) -> TrackResult on the first
    device."""
    n_z, Zl = _slab_shape(mesh, geom)
    devs = mesh.slab_devices
    first = mesh.first_device
    X, Y = geom.dims[0], geom.dims[1]

    def track(svol: ShardedVolume, depth, K, init_pose) -> TrackResult:
        _check_layout(svol, interleave_z)
        depth, K = replicate(depth, devs), replicate(K, devs)
        for d in depth.values():
            if tuple(d.shape) != tuple(img_shape):
                raise ValueError(f"depth {tuple(d.shape)}, tracker made for "
                                 f"{tuple(img_shape)}")
        frames = {d: gn.GnFrame(geom, depth[d], K[d], stride=stride,
                                zmin=zmin, zmax=zmax) for d in depth}
        payloads = local_map(pack_tracking_payload, svol.slabs)

        def gather_records(pose):
            """Slab-local frozen records [N,8]: shard k fetches records only
            for the pixels whose nearest voxel lies in its slab (`in_slab`
            folds into ok)."""
            recs = []
            for k, dev in enumerate(devs):
                if is_remote(dev):
                    recs.append(dev)
                    continue
                pose_k = pose.to(dev)
                pts_cam, valid_z = frames[dev].points()
                p_w = pts_cam @ pose_k[:3, :3].T + pose_k[:3, 3]
                idx, valid = geom.nearest_info(p_w)
                zi = idx[..., 2]
                if interleave_z:
                    in_slab = (zi % n_z) == k
                    zl = torch.clamp(torch.div(zi, n_z, rounding_mode="floor"),
                                     0, Zl - 1)
                else:
                    in_slab = (zi >= k * Zl) & (zi < (k + 1) * Zl)
                    zl = torch.clamp(zi - k * Zl, 0, Zl - 1)
                rows = payloads[k][((zl * Y + idx[..., 1]) * X + idx[..., 0]).long()]
                g = rows[..., 1:4]
                ghat = g / torch.clamp(
                    torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-12)
                ok = valid & in_slab & (rows[..., 4] > 0.0) & valid_z
                recs.append(gn.pack_records(rows[..., 0], ghat,
                                            geom.voxel2world(idx), ok))
            return recs

        def masked_gram(pose, recs):
            """Each shard's Gram (ops/gn.gram: one launch on a card), summed
            onto the first device in shard order."""
            S = reduce_to_first(local_map(
                lambda dev, rec: gn.gram(frames[dev], pose.to(dev), rec), devs, recs))
            return gn.split_gram(S)

        init_pose = torch.as_tensor(init_pose, dtype=torch.float32, device=first)
        pose, conv, fail, E_mean, count, iters, _ = run_gn_rounds(
            geom, gather_records, masked_gram, init_pose,
            num_iterations=num_iterations, conv_threshold_sq=conv_threshold_sq,
            damping=damping, regather_every=regather_every, early_exit=early_exit)
        return TrackResult(pose=pose, converged=conv & (~fail), iterations=iters,
                           energy=E_mean, num_valid=count)

    return track


# ------------------------------------------------------ dense stencils (halos)

def make_sharded_eikonal_energy(mesh: Mesh, geom: GridGeometry,
                                voxel_size: float, band: float):
    """Mean (||forward-diff grad d|| - 1)^2 over the surface band of a
    Z-slab-sharded dense grid, the z+1 term read across the slab boundary
    through the halo exchange.  The representative dense-stencil pattern:
    every finite-difference or Laplacian op on the sharded grid uses the
    same halo.

    Returns fn(dist_slabs) -> scalar on the first slab's device."""
    _slab_shape(mesh, geom)
    inv_h = 1.0 / voxel_size

    def energy(dist_slabs):
        nums, cnts = [], []
        for d, padded in zip(dist_slabs, padded_slab(dist_slabs, fill=0.0)):
            if is_remote(d):
                nums.append(d)
                cnts.append(d)
                continue
            dz = (padded[2:] - d) * inv_h                 # uses the halo above
            dy = (torch.roll(d, -1, dims=1) - d) * inv_h
            dx = (torch.roll(d, -1, dims=2) - d) * inv_h
            g = torch.stack([dx, dy, dz], dim=-1)
            in_band = d.abs() <= band
            e = (torch.linalg.vector_norm(g, dim=-1) - 1.0) ** 2
            nums.append(torch.sum(torch.where(in_band, e, torch.zeros_like(e))))
            cnts.append(torch.sum(in_band))
        num, cnt = reduce_to_first(nums), reduce_to_first(cnts)
        return num / torch.clamp(cnt.to(num.dtype), min=1.0)

    return energy


# ----------------------------------------------------- refinement placement

class RefineLayout(NamedTuple):
    """Where the refinement runs on a mesh: block [k][j] (N-chunk k x
    keyframe chunk j) on devices[k][j]; row k's N-vectors on devices[k][0].
    `rows` / `frames` are the chunks' bounds.  An axis whose length the
    mesh does not divide (N by "z"; F by "frames", or "frames" of 1) is not
    split, as the JAX package's n_spec replicates such an array.  On a mesh
    over processes the entries of other processes are Remote, and a row
    belongs to one process (distributed.make_global_mesh)."""
    devices: Tuple[Tuple[torch.device, ...], ...]
    rows: Tuple[int, ...]
    frames: Tuple[int, ...]

    @property
    def row_devices(self) -> List[torch.device]:
        return [r[0] for r in self.devices]

    @property
    def block_devices(self) -> List[torch.device]:
        return [d for r in self.devices for d in r]


def refine_layout(mesh: Mesh, n: int, f: int) -> RefineLayout:
    n_z, n_f = mesh.shape[Z_AXIS], mesh.shape[FRAME_AXIS]
    nz = n_z if n % n_z == 0 else 1
    nf = n_f if f % n_f == 0 and n_f > 1 else 1
    return RefineLayout(
        devices=tuple(tuple(mesh.devices[k, j] for j in range(nf))
                      for k in range(nz)),
        rows=tuple(k * (n // nz) for k in range(nz + 1)),
        frames=tuple(j * (f // nf) for j in range(nf + 1)))


class ShardedProblem(NamedTuple):
    """A RefineProblem on a mesh.  rows[k]: N-chunk k (with every keyframe's
    visibility) on row device k; blocks[k][j]: the same chunk with the
    visibility of keyframe chunk j, on block device [k][j].  Each chunk's
    stencil indices stay GLOBAL compact indices, and its `n_surface` is the
    global count."""
    layout: RefineLayout
    rows: Tuple[RefineProblem, ...]
    blocks: Tuple[Tuple[RefineProblem, ...], ...]
    n_surface: int

    @property
    def capacity(self) -> int:
        return self.layout.rows[-1]


class ShardedImages(NamedTuple):
    """Keyframe images on a mesh: blocks[k][j] = keyframe chunk j on block
    device [k][j] (one tensor where a column's devices repeat)."""
    blocks: Tuple[Tuple[torch.Tensor, ...], ...]


def shard_rows(x: torch.Tensor, layout: RefineLayout) -> Tuple[torch.Tensor, ...]:
    """An N-vector's chunks, each copied onto its row device (this
    process's rows; the others' are their Remote)."""
    r = layout.rows
    return tuple(d if is_remote(d) else _own(x[r[k]:r[k + 1]], d)
                 for k, d in enumerate(layout.row_devices))


def gather_rows(chunks: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The whole N-vector on `device` (chunks joined in shard order; over
    processes all-gathered, on every process)."""
    dev = _canonical(device)
    if pd.active():
        chunks = pd.exchange(chunks, dev)
    return torch.cat([c.to(dev) for c in chunks])


def shard_refine_arrays(mesh: Mesh, prob: RefineProblem,
                        images: torch.Tensor) -> Tuple[ShardedProblem, ShardedImages]:
    """Place a RefineProblem and the keyframe images [F,H,W,3] on the mesh:
    the surface-voxel axis N split over "z", the images over "frames" (the
    JAX package's shard_refine_arrays; see RefineLayout for the axes it
    leaves whole).  Every chunk is a copy: the arguments are left as they
    were, and no two shards share storage.  The arguments may lie on the
    host: only this process's chunks are copied to its devices, and each
    keyframe chunk is converted there (ops/image.rgb_float: raw uint8
    images become float32)."""
    layout = refine_layout(mesh, int(prob.valid.shape[0]), int(images.shape[0]))
    r, fb = layout.rows, layout.frames
    rows = []
    for k, dev in enumerate(layout.row_devices):
        rows.append(dev if is_remote(dev) else RefineProblem(*(
            _own(a[r[k]:r[k + 1]], dev) for a in prob[:-1]), prob.n_surface))

    def vis_block(k, j):
        v = rows[k].vis[:, fb[j]:fb[j + 1]]
        dev = layout.devices[k][j]
        return v if dev == layout.devices[k][0] else _own(v, dev)

    blocks = tuple(
        tuple(dev if is_remote(dev) else RefineProblem(*(
            a if dev == layout.devices[k][0] else _own(a, dev)
            for a in rows[k][:-1]), prob.n_surface)._replace(vis=vis_block(k, j))
            for j, dev in enumerate(layout.devices[k]))
        for k in range(len(rows)))
    img = []
    for j in range(len(fb) - 1):
        col = replicate(images[fb[j]:fb[j + 1]],
                        [layout.devices[k][j] for k in range(len(rows))])
        img.append({d: rgb_float(t) for d, t in col.items()})
    img_blocks = tuple(tuple(dev if is_remote(dev) else img[j][dev]
                             for j, dev in enumerate(layout.devices[k]))
                       for k in range(len(rows)))
    return (ShardedProblem(layout, tuple(rows), blocks, prob.n_surface),
            ShardedImages(img_blocks))


def gather_problem(sprob: ShardedProblem, device) -> RefineProblem:
    """The whole RefineProblem on `device`: the rows joined in shard order."""
    fields = range(len(RefineProblem._fields) - 1)
    return RefineProblem(*(gather_rows([p if is_remote(p) else p[f]
                                        for p in sprob.rows], device)
                           for f in fields), sprob.n_surface)


def gather_images(simg: ShardedImages, device) -> torch.Tensor:
    """The keyframe images [F,H,W,3] on `device` (mesh row 0's blocks; over
    processes all-gathered from its process)."""
    dev = _canonical(device)
    blocks = list(simg.blocks[0])
    if pd.active():
        blocks = pd.exchange(blocks, dev)
    return torch.cat([im.to(dev) for im in blocks])
