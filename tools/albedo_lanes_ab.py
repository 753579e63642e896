#!/usr/bin/env python3
"""Times albedo_system's lanes-a-row choice (csrc/albedo.cu kGroupShift:
8 lanes a row, this tree's; 16; 32, a warp a row) in turns on one card.

    python3 tools/albedo_lanes_ab.py

Builds three copies of csrc/albedo.cu with nvcc into a temporary directory,
each with another kGroupShift (3, 4, 5); they share the C interface, so
each is driven through ops/albedo.py's wrapper with the module's library
swapped for it.  Makes random inputs from a fixed seed at the refinement's
shapes (49152 voxel slots x 40 keyframes under SH1 and SH2, a fifth of the
pairs masked; the LED run's 8 keyframes; four times the voxels under SH1),
and for each case runs the builds in the order 8, 32, 16, then 16, 32, 8:
each run's b and diag_ps against albedo_system_plain (8 lanes bit for bit,
the others within 1e-5: they add in another order) and its median time
over chip_smoke.KERNEL_REPS with the L2 flushed.  Prints one JSON object a
case, then the card's name and power limit.  Needs the card; imports
nothing of JAX.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from psgradientsdf_tpu_torch import kernels  # noqa: E402
from psgradientsdf_tpu_torch.ops import albedo as AL  # noqa: E402
from psgradientsdf_tpu_torch.refine.render import ResidualData  # noqa: E402

SHIFTS = (3, 4, 5)                    # 8, 16, 32 lanes a row
CASES = (("SH1 main", 49152, 40, "SH1", 1), ("SH2 main", 49152, 40, "SH2", 2),
         ("LED run", 49152, 8, "LED", 1), ("SH1 four copies", 4 * 49152, 40, "SH1", 1))


def build(tmp):
    """{shift: the library built from csrc/albedo.cu with that kGroupShift}."""
    src = open(kernels.source_path("albedo")).read()
    line = "constexpr int kGroupShift = 3;"
    if line not in src:
        raise SystemExit("csrc/albedo.cu: kGroupShift is not 3 any more")
    procs = {}
    for shift in SHIFTS:
        path = os.path.join(tmp, f"albedo_{shift}.cu")
        with open(path, "w") as fh:
            fh.write(src.replace(line, f"constexpr int kGroupShift = {shift};"))
        out = os.path.join(tmp, f"libalbedo_{shift}.so")
        cmd = [kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR, "-o", out,
               path]
        procs[shift] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for shift, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on kGroupShift {shift}:\n{log}")
        lib = ctypes.CDLL(out)
        lib.albedo_system.argtypes = [ctypes.POINTER(AL._SystemArgs), ctypes.c_void_p]
        lib.albedo_system.restype = ctypes.c_int
        libs[shift] = lib
    return libs


def inputs(gen, N, F, model, order):
    """Random (args, kw) of albedo_system at N voxels x F keyframes."""
    u = lambda *s: torch.rand(s, generator=gen, device="cuda")
    n = lambda *s: torch.randn(s, generator=gen, device="cuda")
    w = u(N, F, 3) * (u(N, F, 1) > 0.2)
    p_cam = torch.stack([0.3 * n(N, F), 0.3 * n(N, F), 1.2 + 0.1 * n(N, F)], -1)
    rd = ResidualData(r=0.1 * n(N, F, 3), w=w, mask=None, p_cam=p_cam.contiguous(),
                      uv=None, g_img=None)
    rot, _ = torch.linalg.qr(n(F, 3, 3))
    poses = torch.eye(4, device="cuda").repeat(F, 1, 1)
    poses[:, :3, :3] = rot
    lights = (torch.tensor([1.2, 1.2, 1.2], device="cuda") if model == "LED"
              else 0.3 * n(F, 4 if order == 1 else 9))
    prob = types.SimpleNamespace(valid=u(N) > 0.17)
    return ((prob, rd, None, n(N, 3), lights, poses.contiguous(), None),
            dict(model=model, order=order, voxel_size=0.014, reg_weight_rho=0.0))


def main():
    if not torch.cuda.is_available():
        print("albedo_lanes_ab: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="albedo_ab_") as tmp:
        libs = build(tmp)
        gen = torch.Generator(device="cuda").manual_seed(5)
        flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device="cuda")
        for name, N, F, model, order in CASES:
            args, kw = inputs(gen, N, F, model, order)
            want = AL.albedo_system_plain(*args, **kw)
            row = dict(case=name, voxels=N, keyframes=F)
            for shift in SHIFTS[::2] + SHIFTS[1:2] + SHIFTS[1:2] + SHIFTS[::-2]:
                AL._bound = libs[shift]
                got = AL.albedo_system(*args, **kw)
                torch.cuda.synchronize()
                err = max(cs._abs_err(got.b, want.b) / float(want.b.abs().max()),
                          cs._abs_err(got.diag_ps, want.diag_ps)
                          / float(want.diag_ps.abs().max()))
                same = cs._bits_same(got.b, want.b) and cs._bits_same(got.diag_ps,
                                                                       want.diag_ps)
                if err > 1e-5 or (shift == 3 and not same):
                    raise SystemExit(f"{name}, {1 << shift} lanes: off the plain "
                                     f"version by {err:.3g}")
                row.setdefault(f"ms, {1 << shift} lanes", []).append(
                    cs._time_ms(lambda: AL.albedo_system(*args, **kw), flush))
            print(json.dumps(row), flush=True)
        AL._bound = None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
