"""Configuration system: reference-compatible JSON schema + engine extensions.

Parses the exact JSON schema of the reference (cpp/include/ConfigLoader.h:16-169,
defaults from cpp/include/sdf_tracker/TrackingSettings.h:26-38 and
cpp/include/ps_optimizer/OptimizerSettings.h:38-51), so the three shipped demo
recipes (config/config_skorates.json etc.) run unchanged.  Fixes the
reference's `==`-instead-of-`=` bug that made `trunc_l2`/`tukey` unselectable
(ConfigLoader.h:126,130).

Engine extensions (all optional keys; the `tpu` group keeps the JAX
package's field names so one JSON file drives both packages):
  "grid dim"       — voxel grid resolution (reference hardcodes 128, main_ps.cpp:123)
  "mesh shape"     — device mesh axis sizes, e.g. {"z": 4, "frames": 1}
                     (+ "interleave"): the scan runs on the mesh as
                     Z-slabs, the refinement with the surface set over "z"
                     and the keyframes over "frames"
  "frame cap"      — visibility bitmask capacity (frames tracked per voxel)
  "keyframe cap"   — max keyframes used in refinement (reference: 40, main_ps.cpp:312)
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

from psgradientsdf_tpu_torch.parallel import distributed
from psgradientsdf_tpu_torch.utils import robust

SH1 = "SH1"
SH2 = "SH2"
LED = "LED"

DATATYPE_TUM = "tum"
DATATYPE_SYNTH = "synth"
DATATYPE_MULTIVIEW = "multiview"


@dataclasses.dataclass
class TrackingConfig:
    """Mirrors TrackingSettings (TrackingSettings.h:14-40)."""
    input: str = ""
    output: str = ""
    pose_file: str = "pose.txt"
    datatype: str = DATATYPE_TUM
    first: int = 0
    last: int = 2 ** 31 - 1
    voxel_size: float = 0.02
    truncation_factor: float = 5.0
    zmin: float = 0.5
    zmax: float = 3.5
    sharpness_threshold: float = 0.5
    # tracker GN hyper-params (RigidOptimizer.h:42-47)
    num_iterations: int = 50
    conv_threshold: float = 1e-3
    damping: float = 1.0


@dataclasses.dataclass
class OptimizerConfig:
    """Mirrors OptimizerSettings (OptimizerSettings.h:24-51)."""
    max_it: int = 100
    conv_threshold: float = 1e-4
    damping: float = 1.0
    lam: float = 0.5           # robust-loss lambda ("lambda" key)
    reg_weight_rho: float = 0.0
    reg_weight_n: float = 0.0
    reg_weight_l: float = 0.0
    order: int = 1
    upsample: bool = False
    joint_dp: bool = False        # joint distance+pose GN step with Schur
                                  # pose elimination (refinement slice)
    fused_iterations: bool = True # one fused program per alternating
                                  # iteration (refinement slice)
    model: str = SH1
    loss: int = robust.CAUCHY
    # ablation switches (main_ps.cpp:79-82)
    opt_light: bool = True
    opt_albedo: bool = True
    opt_distance: bool = True
    opt_pose: bool = True


@dataclasses.dataclass
class TpuConfig:
    """Engine extensions (no reference counterpart); field names as in the
    JAX package."""
    grid_dim: Tuple[int, int, int] = (128, 128, 128)
    frame_cap: int = 256          # bit-packed visibility capacity; unless
                                  # set explicitly ("frame cap" key) the
                                  # pipeline AUTO-SIZES it to the config's
                                  # frame range (last-first+1, rounded to a
                                  # 32-bit word) so long sequences never
                                  # alias visibility bits — the reference's
                                  # per-voxel vector<bool> grows unbounded
                                  # (VolumetricGradSdf.cpp:129-131)
    frame_cap_explicit: bool = False  # True when "frame cap" was in the JSON
    keyframe_cap: int = 40        # max keyframes in refinement (main_ps.cpp:312)
    mesh_z: int = 1               # voxel-grid Z-slab sharding axis size
    mesh_frames: int = 1          # keyframe sharding axis size
    mesh_interleave_z: bool = False  # strided plane assignment for a
                                  # scan on a mesh (parallel/mesh.py
                                  # interleave_volume)
    track_stride: int = 1         # pixel sub-sampling in tracking
    track_regather: int = 1       # GN iterations per correspondence gather
    track_static: bool = False    # fixed-trip masked GN (no early exit);
                                  # the budget should then be set to the
                                  # typical convergence count
    fuse_rows: float = 0.5        # row-culled fusion: initial capacity as a
                                  # fraction of the Z*Y row count (0 = every
                                  # frame gathers all voxels, the reference
                                  # behavior). Exactness is guaranteed: on
                                  # capacity overflow the pipeline redoes
                                  # the chunk at a grown capacity.
    chunk_size: int = 8           # frames per on-device scan dispatch
    dtype: str = "float32"


@dataclasses.dataclass
class PipelineConfig:
    tracking: TrackingConfig
    optimizer: OptimizerConfig
    tpu: TpuConfig

    @property
    def truncation(self) -> float:
        return self.tracking.truncation_factor * self.tracking.voxel_size


def load_config(path: str, save_copy: bool = True) -> PipelineConfig:
    """Load the reference JSON schema (ConfigLoader.h:16-169)."""
    with open(path) as fh:
        cfg = json.load(fh)
    return parse_config(cfg, save_copy=save_copy)


def parse_config(cfg: dict, save_copy: bool = True) -> PipelineConfig:
    for key in ("input", "output", "datatype"):
        if key not in cfg:
            raise ValueError(
                "missing necessary input arguments (input/output/datatype) in config file"
            )

    datatype = cfg["datatype"]
    if datatype == "tum":
        dt = DATATYPE_TUM
    elif datatype in ("led", "synth"):
        dt = DATATYPE_SYNTH
    elif datatype in ("intrinsic3d", "multiview"):
        dt = DATATYPE_MULTIVIEW
    else:
        raise ValueError(f"dataset type {datatype!r} is not supported")

    trac = TrackingConfig(input=cfg["input"], output=cfg["output"], datatype=dt)
    if "pose filename" in cfg:
        trac.pose_file = cfg["pose filename"]
    for json_key, attr in [
        ("first", "first"),
        ("last", "last"),
        ("voxel size", "voxel_size"),
        ("truncation factor", "truncation_factor"),
        ("sharpness threshold", "sharpness_threshold"),
        ("zmin", "zmin"),
        ("zmax", "zmax"),
    ]:
        if json_key in cfg:
            setattr(trac, attr, cfg[json_key])

    opt = OptimizerConfig()
    if "model type" in cfg:
        mtype = cfg["model type"]
        if mtype == "SH1":
            opt.model, opt.order = SH1, 1
        elif mtype == "SH2":
            opt.model, opt.order = SH2, 2
        elif mtype == "LED":
            opt.model = LED
        else:
            raise ValueError(f"model type {mtype!r} is not supported")
    if "loss function" in cfg:
        opt.loss = robust.loss_from_name(cfg["loss function"])
    for json_key, attr in [
        ("reg albedo", "reg_weight_rho"),
        ("reg norm", "reg_weight_n"),
        ("reg laplacian", "reg_weight_l"),
        ("max iter", "max_it"),
        ("damping", "damping"),
        ("converge threshold", "conv_threshold"),
        ("upsample", "upsample"),
        ("joint distance pose", "joint_dp"),
        ("fused iterations", "fused_iterations"),
        ("lambda", "lam"),
    ]:
        if json_key in cfg:
            setattr(opt, attr, cfg[json_key])
    for flag, attr in [
        ("--light", "opt_light"),
        ("--albedo", "opt_albedo"),
        ("--distance", "opt_distance"),
        ("--pose", "opt_pose"),
    ]:
        if flag in cfg:
            setattr(opt, attr, bool(cfg[flag]))

    tpu = TpuConfig()
    if "track config" in cfg:
        # named tracker configuration (tracking/configs.py): "reference"
        # (the C++ semantics), "streaming" (2 gathers + 8 fixed-trip
        # steps) or "parity" (3 gathers + 12 steps).  Maps onto the
        # explicit knobs below; explicit keys after this one still override.
        from psgradientsdf_tpu_torch.tracking import configs as _tcfg

        name = str(cfg["track config"]).lower()
        named = {"reference": _tcfg.REFERENCE, "streaming": _tcfg.STREAMING,
                 "parity": _tcfg.PARITY}
        if name not in named:
            raise ValueError(
                f"track config {name!r} is not one of {sorted(named)}")
        sel = named[name]
        trac.num_iterations = sel["num_iterations"]
        trac.conv_threshold = float(sel["conv_threshold_sq"]) ** 0.5
        trac.damping = sel["damping"]
        tpu.track_regather = sel["regather_every"]
        tpu.track_static = not sel["early_exit"]
        tpu.track_stride = sel["stride"]
    if "grid dim" in cfg:
        g = cfg["grid dim"]
        tpu.grid_dim = (g, g, g) if isinstance(g, int) else tuple(g)
    if "frame cap" in cfg:
        tpu.frame_cap = int(cfg["frame cap"])
        tpu.frame_cap_explicit = True
    if "keyframe cap" in cfg:
        tpu.keyframe_cap = int(cfg["keyframe cap"])
    if "mesh shape" in cfg:
        ms = cfg["mesh shape"]
        tpu.mesh_z = int(ms.get("z", 1))
        tpu.mesh_frames = int(ms.get("frames", 1))
        tpu.mesh_interleave_z = bool(ms.get("interleave", False))
    if "track stride" in cfg:
        tpu.track_stride = int(cfg["track stride"])
    if "track regather" in cfg:
        tpu.track_regather = max(1, int(cfg["track regather"]))
    if "track static" in cfg:
        tpu.track_static = bool(cfg["track static"])
    if "fuse rows" in cfg:
        tpu.fuse_rows = float(cfg["fuse rows"])
    if "chunk size" in cfg:
        tpu.chunk_size = max(1, int(cfg["chunk size"]))

    pipe = PipelineConfig(tracking=trac, optimizer=opt, tpu=tpu)

    # in a process group only process 0 writes files
    if save_copy and trac.output and distributed.rank() == 0:
        # echo config to the results dir (ConfigLoader.h:161-165)
        try:
            os.makedirs(trac.output, exist_ok=True)
            with open(os.path.join(trac.output, "saved_config.json"), "w") as fh:
                json.dump(cfg, fh, indent=4)
        except OSError:
            pass

    return pipe
