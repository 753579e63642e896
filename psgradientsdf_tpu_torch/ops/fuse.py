"""The per-voxel fusion update, in place on rows of volume state: one launch
a fused frame of the hand-written Hopper kernel in csrc/fuse.cu, or its
plain PyTorch version for CPU tensors.

  fuse_rows(dist, grad, weight, color, vis, pix_payload, K, pose, img_hw,
            bit, gate, geom=, S=, NS=, rows=, live=, z0=, z_map=, frame=, ...)

updates the [CAP, S] state of CAP rows (or S-voxel X-segments) of a grid in
place: dist [CAP,S], grad [CAP,S,3], weight [CAP,S], color [CAP,S,3] and
the frame's visibility words vis [CAP,S] (int32; None: no bits).  Each is
any strided view whose last (component) stride is 1, so the same call
serves the gathered SoA row blocks of the culled fusion, the packed
[CAP,S,8] rows (views of slots 0, 1:4, 4, 5:8), the whole grid in place
(fuse_frame: rows None, a row a slot) and the resident rows.  Slot s holds
grid row rows[s] (slot s itself when rows is None), whose voxel centres are
row_world_coords'.  `live` (an int64 scalar on the device) says the slots
at and past it are padding: they are left as they are.  `gate`: None, a
bool scalar, or one bool a slot ([CAP] or [CAP,1]); False makes the slot's
update a masked no-op.

The frame's visibility bit comes in one of two forms.  `bit` (a host int,
the int32 bit pattern) with `vis` the frame's word already picked, [CAP,S]
by slot; or `frame`, the frame id as an int32 scalar on the device, with
`vis` the whole table [words, rows, S]: the word frame // 32 (clamped to the
table, as the JAX package's dynamic_index_in_dim clamps a traced index,
psgradientsdf_tpu/core/volume.py:529-531) is picked on the device, slot s
reads and writes its grid row rows[s] (slot s when rows is None) of it in
place, and the bit is 1 << frame % 32.  The second form freezes nothing of
the frame into the launch, so a CUDA graph of the scan replays it
(tracking/graph.py), and it moves the words once: no gathered copy of them
goes through the row-copy kernels.

It replaces the JAX package's psgradientsdf_tpu/core/volume.py
_fuse_voxel_update (:104) on _row_world_coords (:785) as XLA fuses them
inside _fuse_culled_slab (:475).  The plain version is that function's
port, fuse_voxel_update on row_world_coords (formerly in core/volume.py),
and the kernel equals it on the card bit for bit: the same operations in
the same order, each rounded once.

A wrapper takes the plain version ONLY for tensors that lie on the CPU (the
plain version reads `live` back to the host); for CUDA tensors it launches
the kernel or raises.  `launch_counts` counts kernel launches and nothing
else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from psgradientsdf_tpu_torch.core.grid import GridGeometry

_LIB_NAME = "fuse"
launch_counts: Dict[str, int] = {"fuse_rows": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def fusion_weight(sdf: torch.Tensor, T: float) -> torch.Tensor:
    """Asymmetric fusion weight (Sdf.h:48-66): 1 in front of the surface
    (sdf >= 0), linear ramp 1 + sdf/T on [-T, 0), 0 behind."""
    one = torch.ones_like(sdf)
    return torch.where(
        sdf >= 0.0, one,
        torch.where(sdf >= -T, 1.0 + sdf / T, torch.zeros_like(sdf)))


def rot_apply(R: torch.Tensor, x, y, z, transpose: bool):
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


def fuse_voxel_update(
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
    arbitrary-shaped batch of voxels: the plain version of the kernel, and
    the arithmetic every fusion path shares.

    Returns (new_dist, new_grad, new_weight, new_color, vis_or [int32])."""
    H, W = img_hw
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    R = pose[:3, :3]
    t = pose[:3, 3]

    d = p_w - t
    pcx, pcy, pz = rot_apply(R, d[..., 0], d[..., 1], d[..., 2], transpose=True)
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
    nwx, nwy, nwz = rot_apply(R, nx, ny, nz, transpose=False)
    n_world = torch.stack([nwx, nwy, nwz], dim=-1)
    new_grad = grad - wm[..., None] * n_world
    new_color = color_v + (col - color_v) * (wm / safe_W)[..., None]
    vis_or = mask.to(torch.int32) * bit
    return new_dist, new_grad, new_weight, new_color, vis_or


def vis_word_bit(frame: torch.Tensor, words: int):
    """A device frame id (an int32 scalar) -> (word [int64 scalar], bit
    [int32 scalar, the bit pattern]) on its device, with no host read: the
    word frame // 32 clamped to [0, words), the bit 1 << frame % 32 (bit 31
    the sign bit), as the JAX package forms them from a traced id."""
    f = frame.to(torch.int64)
    word = torch.clamp(torch.div(f, 32, rounding_mode="floor"), 0, words - 1)
    b = torch.bitwise_left_shift(torch.ones_like(f), torch.remainder(f, 32))
    bit = torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32)
    return word, bit


def row_world_coords(geom: GridGeometry, safe_rows: torch.Tensor,
                     z0: Optional[int], S: int, NS: int,
                     z_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """World coordinates [CAP,S,3] of the voxels of compacted rows (or
    S-voxel X-segments, NS of them a row): the index arithmetic every fusion
    path shares, so that all of them round the voxel centres alike.  Row r
    of a slab lies on its local plane r // (Y*NS): global plane z0 + local
    (a contiguous slab; z0 None: the whole grid) or z_map[local] (an
    interleaved one)."""
    dev = safe_rows.device
    Y = geom.dims[1]
    cap = safe_rows.shape[0]
    origin = geom.origin_tensor(dev)
    h = geom.voxel_size
    rz_l = torch.div(safe_rows, Y * NS, rounding_mode="floor")   # slab-local z
    if z_map is not None:
        rz = z_map[torch.clamp(rz_l, max=z_map.shape[0] - 1).long()].to(torch.float32)
    else:
        rz = rz_l.to(torch.float32)
        if z0 is not None:
            rz = rz + float(z0)
    ry = (torch.div(safe_rows, NS, rounding_mode="floor") % Y).to(torch.float32)
    rx0 = (safe_rows % NS).to(torch.float32) * S            # segment x origin
    rx = rx0[:, None] + torch.arange(S, dtype=torch.float32, device=dev)[None, :]
    return torch.stack(
        [origin[0] + h * rx,
         (origin[1] + h * ry)[:, None].expand(cap, S),
         (origin[2] + h * rz)[:, None].expand(cap, S)],
        dim=-1)


def fuse_rows_plain(dist, grad, weight, color, vis, pix_payload, K, pose,
                    img_hw, bit, gate, *, geom: GridGeometry, S: int,
                    NS: int = 1, rows=None, live=None, z0=None, z_map=None,
                    frame=None, truncation: float, zmin: float, zmax: float,
                    cos_thresh_sq: float) -> None:
    """fuse_rows with eager PyTorch ops: row_world_coords and
    fuse_voxel_update on the slots before `live` (read back to the host),
    written into the fields in place; with `frame`, the word and the bit
    formed on the device (vis_word_bit) and the table's rows ORed in place."""
    cap = dist.shape[0]
    k = cap if live is None else max(0, min(int(live), cap))
    if rows is None:
        rows = torch.arange(k, dtype=torch.int32, device=dist.device)
    p_w = row_world_coords(geom, rows[:k], z0, S, NS, z_map)
    if gate is not None and gate.dim() > 0:
        gate = gate.reshape(cap, -1)[:k]
    word = None
    if frame is not None:
        word, bit = vis_word_bit(frame, vis.shape[0])
    nd, ng, nw, nc, vis_or = fuse_voxel_update(
        p_w, dist[:k], grad[:k], weight[:k], color[:k], pix_payload, K, pose,
        img_hw, bit, gate, truncation=truncation, zmin=zmin, zmax=zmax,
        cos_thresh_sq=cos_thresh_sq)
    dist[:k] = nd
    grad[:k] = ng
    weight[:k] = nw
    color[:k] = nc
    if vis is None:
        return
    if word is None:
        vis[:k] |= vis_or
        return
    at = (word.expand(k), rows[:k].long())
    vis.index_put_(at, vis[at] | vis_or)


# ---------------------------------------------------------------------------
# argument checks and the library binding
# ---------------------------------------------------------------------------


class _FuseArgs(ctypes.Structure):
    """csrc/fuse.cu FuseArgs, field for field (every field 8 bytes)."""
    _fields_ = (
        [(f"{n}{s}", t) for n in ("dist", "grad", "weight", "color", "vis")
         for s, t in (("", ctypes.c_void_p), ("_rs", ctypes.c_int64),
                      ("_vs", ctypes.c_int64))]
        + [("rows", ctypes.c_void_p), ("live", ctypes.c_void_p),
           ("gate", ctypes.c_void_p), ("gate_stride", ctypes.c_int64),
           ("z_map", ctypes.c_void_p), ("z_map_len", ctypes.c_int64),
           ("pix", ctypes.c_void_p), ("K", ctypes.c_void_p),
           ("pose", ctypes.c_void_p)]
        + [(n, ctypes.c_int64) for n in
           ("cap", "S", "NS", "Y", "H", "W", "bit", "has_z0", "packed")]
        + [(n, ctypes.c_double) for n in
           ("z0", "origin_x", "origin_y", "origin_z", "voxel", "truncation",
            "zmin", "zmax", "cos_thresh_sq")]
        + [("frame", ctypes.c_void_p), ("vis_ws", ctypes.c_int64),
           ("vis_words", ctypes.c_int64)])


def _check(dist, grad, weight, color, vis, pix_payload, K, pose, S, rows,
           live, gate, z_map, frame) -> None:
    cap = dist.shape[0]
    dev = dist.device
    want = {"dist": (dist, (cap, S), torch.float32),
            "grad": (grad, (cap, S, 3), torch.float32),
            "weight": (weight, (cap, S), torch.float32),
            "color": (color, (cap, S, 3), torch.float32),
            "pix_payload": (pix_payload, None, torch.float32),
            "K": (K, (3, 3), torch.float32),
            "pose": (pose, (4, 4), torch.float32)}
    if frame is not None:
        want["frame"] = (frame, (), torch.int32)
        if vis is None or vis.dim() != 3 or vis.shape[2] != S:
            raise ValueError(f"fuse_rows: with a device frame id vis must be the "
                             f"table [words, rows, {S}], got "
                             f"{None if vis is None else tuple(vis.shape)}")
        if vis.stride(2) != 1:
            raise ValueError("fuse_rows: the table's rows must be contiguous")
        want["vis"] = (vis, None, torch.int32)
    elif vis is not None:
        want["vis"] = (vis, (cap, S), torch.int32)
    if rows is not None:
        want["rows"] = (rows, (cap,), torch.int32)
    if live is not None:
        want["live"] = (live, (), torch.int64)
    if z_map is not None:
        want["z_map"] = (z_map, None, None)
    for name, (t, shape, dtype) in want.items():
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"fuse_rows: {name} must be {shape}, got {tuple(t.shape)}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"fuse_rows: {name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"fuse_rows: {name} on {t.device}, dist on {dev}")
    for name in ("grad", "color"):
        if want[name][0].stride(-1) != 1:
            raise ValueError(f"fuse_rows: {name}'s three components must be adjacent")
    if pix_payload.dim() != 2 or pix_payload.shape[1] != 8 or not pix_payload.is_contiguous():
        raise ValueError("fuse_rows: pix_payload must be a contiguous [H*W, 8]")
    if gate is not None:
        if gate.dtype != torch.bool or gate.device != dev:
            raise TypeError(f"fuse_rows: gate must be bool on {dev}")
        if gate.dim() > 0 and gate.numel() != cap:
            raise ValueError(f"fuse_rows: a gate a slot needs {cap} entries, "
                             f"got {tuple(gate.shape)}")


_bound = None


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        lib.fuse_rows.argtypes = [ctypes.POINTER(_FuseArgs), ctypes.c_void_p]
        lib.fuse_rows.restype = ctypes.c_int
        _bound = lib
    return _bound


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _is_packed(dist, grad, weight, color) -> bool:
    """Are the four fields the slots 0, 1:4, 4 and 5:8 of [CAP, S, 8] rows
    (a PackedVolume payload's views), 16-byte aligned: the kernel then moves
    a voxel's 32 bytes as two float4s."""
    base, rs = dist.data_ptr(), dist.stride(0)
    return (base % 16 == 0 and rs % 4 == 0
            and all(t.stride(0) == rs and t.stride(1) == 8
                    for t in (dist, grad, weight, color))
            and [t.data_ptr() - base for t in (grad, weight, color)]
            == [4, 16, 20])


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def fuse_rows(dist, grad, weight, color, vis, pix_payload, K, pose, img_hw,
              bit: Optional[int], gate, *, geom: GridGeometry, S: int, NS: int = 1,
              rows: Optional[torch.Tensor] = None,
              live: Optional[torch.Tensor] = None, z0: Optional[int] = None,
              z_map: Optional[torch.Tensor] = None,
              frame: Optional[torch.Tensor] = None, truncation: float,
              zmin: float, zmax: float, cos_thresh_sq: float) -> None:
    """The fusion update of a frame on CAP rows of state, IN PLACE (see the
    module docstring): one kernel launch on CUDA tensors, the plain version
    on CPU tensors.  `bit` is ignored where `frame` is given."""
    H, W = img_hw
    _check(dist, grad, weight, color, vis, pix_payload, K, pose, S, rows,
           live, gate, z_map, frame)
    if pix_payload.shape[0] != H * W:
        raise ValueError(f"fuse_rows: pix_payload has {pix_payload.shape[0]} "
                         f"rows for a {H}x{W} image")
    kw = dict(geom=geom, S=S, NS=NS, rows=rows, live=live, z0=z0, z_map=z_map,
              frame=frame, truncation=truncation, zmin=zmin, zmax=zmax,
              cos_thresh_sq=cos_thresh_sq)
    if dist.device.type == "cpu":
        return fuse_rows_plain(dist, grad, weight, color, vis, pix_payload, K,
                               pose, img_hw, bit, gate, **kw)
    if pix_payload.data_ptr() % 16:
        raise ValueError("fuse_rows: pix_payload must be 16-byte aligned")
    lib = _library()
    K, pose = K.contiguous(), pose.contiguous()
    if z_map is not None:
        z_map = z_map.to(torch.float32).contiguous()
    a = _FuseArgs()
    for name, t in (("dist", dist), ("grad", grad), ("weight", weight),
                    ("color", color)):
        setattr(a, name, _ptr(t))
        setattr(a, name + "_rs", t.stride(0))
        setattr(a, name + "_vs", t.stride(1))
    a.vis = _ptr(vis)
    if frame is not None:
        # the whole table: its words, rows and voxels
        a.frame, a.vis_ws, a.vis_words = frame.data_ptr(), vis.stride(0), vis.shape[0]
        a.vis_rs, a.vis_vs = vis.stride(1), vis.stride(2)
    elif vis is not None:
        a.vis_rs, a.vis_vs = vis.stride(0), vis.stride(1)
    a.rows, a.live, a.pix, a.K, a.pose = (
        _ptr(rows), _ptr(live), _ptr(pix_payload), _ptr(K), _ptr(pose))
    if gate is not None:
        a.gate = gate.data_ptr()
        a.gate_stride = 0 if gate.dim() == 0 else gate.reshape(-1).stride(0)
    if z_map is not None:
        a.z_map, a.z_map_len = z_map.data_ptr(), z_map.shape[0]
    a.cap, a.S, a.NS, a.Y, a.H, a.W = dist.shape[0], S, NS, geom.dims[1], H, W
    a.bit, a.has_z0, a.z0 = int(bit or 0), int(z0 is not None), float(z0 or 0)
    a.packed = int(_is_packed(dist, grad, weight, color))
    a.origin_x, a.origin_y, a.origin_z = geom.origin
    a.voxel, a.truncation, a.zmin, a.zmax, a.cos_thresh_sq = (
        geom.voxel_size, truncation, zmin, zmax, cos_thresh_sq)
    dev = dist.device
    with torch.cuda.device(dev):
        rc = lib.fuse_rows(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fuse_rows: kernel launch failed, CUDA error {rc}")
    launch_counts["fuse_rows"] += 1
