"""psgradientsdf_tpu_torch — the PyTorch/CUDA build of the PSgradientSDF engine.

A second package beside the JAX one, written for one NVIDIA Hopper card.
Same directory layout, same public array layouts (dist [Z,Y,X],
grad [Z,Y,X,3], weight [Z,Y,X], color [Z,Y,X,3], vis [W,Z,Y,X], poses
[4,4] camera-to-world), PyTorch idiom inside: plain functions on tensors,
NamedTuple/dataclass state, an explicit `device` argument.

What is here: the scan — SDF-based Gauss-Newton camera tracking, row-culled
Gradient-SDF fusion, sharpness keyframes, the initial mesh / point-cloud /
SDF / trajectory export — and the four indexed row-copy kernels the culled
fusion moves its state rows with (ops/rowcopy.py, csrc/rowcopy.cu) — and
the photometric refinement of distance, albedo, poses and light over the
keyframes (refine/), with the export of the refined mesh, point cloud, SDF
and poses — and the host runtime around them: checkpoints and exact resume
of the scan and of the refinement in the JAX package's file format
(io/checkpoint.py), the command line's --retries, a PNG decoder that needs
no image library (io/png.py), and C++ marching cubes and PLY writers
(native.py, csrc/*.cpp, built with g++ at first use) — and the scan and
the refinement on a device mesh (parallel/): the volume as Z-slabs, the
refinement's surface set over "z" and its keyframes over "frames", driven
by one process (parallel/mesh.make_mesh) or by one process a mesh row
(parallel/distributed.py: distributed.initialize on every process, then the
pipeline; every cross-process move a torch.distributed collective) — and
the volume state's other layouts: the packed [Z,Y,X,8] state the tracker
reads with no copy (core/volume.PackedVolume, fuse_frame_culled_packed),
K frames fused at given poses with one row move (fuse_frames_culled), and
the chunk-resident compact state of core/resident.py.

Devices: every entry point runs on "cuda" unless the caller passes
device="cpu"; with no card and no such request it raises (resolve_device).

Precision: the 6x6 / 8x8 Gauss-Newton systems and the 3x3 rotations need
full float32, so TF32 is switched off for matrix products and for cuDNN
on import.
"""

__version__ = "0.1.0"

import functools as _functools

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> "_torch.device":
    """The device an entry point runs on: "cuda" unless the caller asks for
    another one.  Never carries on on the CPU by itself."""
    if device is None:
        device = "cuda"
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "psgradientsdf_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' (CLI: --platform cpu) to run the "
            "plain PyTorch path on the CPU")
    return dev


@_functools.lru_cache(maxsize=256)
def device_constant(values: tuple, dtype, device) -> "_torch.Tensor":
    """A few constant numbers (a grid origin, grid dims, a matrix row) as a
    tensor on `device`, made once and reused: building one from Python
    numbers copies from the host, and the tracker would do that several
    times per Gauss-Newton round.  The tensor is shared — never write to it."""
    return _torch.tensor(values, dtype=dtype, device=device)


from psgradientsdf_tpu_torch.config import PipelineConfig, load_config  # noqa: E402,F401
from psgradientsdf_tpu_torch.core.resident import ResidentVolume  # noqa: E402,F401
from psgradientsdf_tpu_torch.core.volume import (  # noqa: E402,F401
    GradSdfVolume, PackedVolume, fuse_frame_culled_packed, fuse_frames_culled,
)
