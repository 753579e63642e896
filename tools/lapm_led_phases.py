#!/usr/bin/env python3
"""Where a launch of LAPM (csrc/preprocess.cu lapm_kernel) and of the LED
light's normal equations (csrc/normaleq.cu light_led_kernel) spends its
time, phase by phase, on one card.

    python3 tools/lapm_led_phases.py

Builds copies of the two sources into a temporary directory in which
thread 0 of every block reads %globaltimer at the kernel's phase
boundaries into a __device__ array (read back with cudaMemcpyFromSymbol).
The copies are made by text substitution at fixed anchors of the sources,
and the script stops if one is missing.  The stamps, a block each: its
start, after its set-up barrier, after its first data (LAPM: thread 0's
first wait for a staged row; the LED light: warp 0's first unit of pairs
done), after the block's work (LAPM: thread 0's last row; the LED light:
warp 0's last unit), after the ticket's barrier, and the last block's end.
Runs LAPM on chip_smoke.py's first chunk (8 RGB frames of 640x480) after
the chunk's FALS normals, as the scan runs it, and alone; and the LED light
on random inputs (_led_inputs) of 49152 x 8 pairs (the LED run's width
after its upsample), 12288 x 4 (the mesh's block) and 49152 x 40.  Each
copy's result is held bit for bit against this tree's kernel.  Prints, for each case and stamp, the spread
over the blocks (min, median, max, in microseconds from the first block's
start), the card's name and power limit first.  Needs the card; imports
nothing of JAX.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from psgradientsdf_tpu_torch import kernels  # noqa: E402
from psgradientsdf_tpu_torch.core.grid import GridGeometry  # noqa: E402
from psgradientsdf_tpu_torch.ops import normaleq as NE  # noqa: E402
from psgradientsdf_tpu_torch.ops import preprocess as P  # noqa: E402
from psgradientsdf_tpu_torch.ops.normals import build_fals_cache  # noqa: E402
from psgradientsdf_tpu_torch.refine.render import ResidualData  # noqa: E402
from psgradientsdf_tpu_torch.utils.se3 import se3_exp  # noqa: E402

MAX_BLOCKS = 4096
STAMPS = ("start", "set-up barrier", "first data", "block's work",
          "ticket's barrier", "last block's end")
COUNTERS = r'''
__device__ unsigned long long g_stamps[%d * 8];
extern "C" int read_stamps(unsigned long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, sizeof(unsigned long long) * n));
}
__device__ __forceinline__ void stamp(int k) {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
  g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + k] = t;
}
''' % MAX_BLOCKS
# (anchor, text put in its place) a source; each anchor must occur once
EDITS = {
    "preprocess.cu": (
        ("namespace {\n\nconstexpr int kTile", COUNTERS + "namespace {\n\nconstexpr int kTile"),
        ("  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n\n  // the span of staged row j",
         "  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n  if (t == 0) stamp(0);\n\n"
         "  // the span of staged row j"),
        ("    fence_mbar_init();\n  }\n  __syncthreads();\n\n  double acc = 0.0;",
         "    fence_mbar_init();\n  }\n  __syncthreads();\n  if (t == 0) stamp(1);\n\n"
         "  double acc = 0.0;"),
        ("      mbar_wait(&m.full[buf], (j / D) & 1);\n",
         "      mbar_wait(&m.full[buf], (j / D) & 1);\n      if (t == 0 && j == 0) stamp(2);\n"),
        ("  // the block's partial: each consumer warp's butterfly, the warps in order\n",
         "  if (t == 0) stamp(3);\n"
         "  // the block's partial: each consumer warp's butterfly, the warps in order\n"),
        ("    *m.last = old == parts * static_cast<int>(a.C) - 1;\n  }\n  __syncthreads();\n",
         "    *m.last = old == parts * static_cast<int>(a.C) - 1;\n  }\n  __syncthreads();\n"
         "  if (t == 0) stamp(4);\n"),
        ("    if (lane == 0) a.out[f] = static_cast<float>(s / hw);\n  }\n"
         "  if (t == 0) *a.ticket = 0;",
         "    if (lane == 0) a.out[f] = static_cast<float>(s / hw);\n  }\n  __syncthreads();\n"
         "  if (t == 0) stamp(5);\n  if (t == 0) *a.ticket = 0;"),
    ),
    "normaleq.cu": (
        ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + COUNTERS),
        ("  const float h = static_cast<float>(a.grid_voxel);\n",
         "  const float h = static_cast<float>(a.grid_voxel);\n  if (t == 0) stamp(0);\n"),
        ("  __syncthreads();\n\n  // a NARROW lane's place",
         "  __syncthreads();\n  if (t == 0) stamp(1);\n\n  // a NARROW lane's place"),
        ("    }\n  }\n\n  // the block's partials: each warp's butterfly, then the warps in order\n"
         "  const int B",
         "    }\n    if (t == 0 && u == u0) stamp(2);\n  }\n  if (t == 0) stamp(3);\n\n"
         "  // the block's partials: each warp's butterfly, then the warps in order\n"
         "  const int B"),
        ("    *m.last = ticket_add(a.ticket) == static_cast<unsigned>(B - 1);\n  }\n"
         "  __syncthreads();\n",
         "    *m.last = ticket_add(a.ticket) == static_cast<unsigned>(B - 1);\n  }\n"
         "  __syncthreads();\n  if (t == 0) stamp(4);\n"),
        ("    if (lane == 0) (warp < 3 ? a.H : a.g)[warp % 3] = static_cast<float>(s);\n  }\n"
         "  if (t == 0) *a.ticket = 0;\n}",
         "    if (lane == 0) (warp < 3 ? a.H : a.g)[warp % 3] = static_cast<float>(s);\n  }\n"
         "  __syncthreads();\n  if (t == 0) stamp(5);\n  if (t == 0) *a.ticket = 0;\n}"),
    ),
}


def build(name: str, tmp: str) -> ctypes.CDLL:
    with open(os.path.join(kernels.CSRC_DIR, name)) as fh:
        src = fh.read()
    for anchor, text in EDITS[name]:
        if src.count(anchor) != 1:
            raise SystemExit(f"lapm_led_phases: anchor not found once in {name}: {anchor!r}")
        src = src.replace(anchor, text)
    path = os.path.join(tmp, name.replace(".cu", "_phases.cu"))
    with open(path, "w") as fh:
        fh.write(src)
    lib = os.path.join(tmp, "lib" + name.replace(".cu", "_phases.so"))
    proc = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR,
                           "-o", lib, path],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"lapm_led_phases: nvcc failed on {name}:\n{proc.stdout}")
    out = ctypes.CDLL(lib)
    out.read_stamps.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
    return out


def spread(lib, blocks: int) -> dict:
    """The stamps of the last launch: each stamp's min, median and max over
    the blocks in microseconds from the first block's start (the last
    block's end: the one block that wrote it)."""
    raw = (ctypes.c_uint64 * (8 * blocks))()
    if lib.read_stamps(raw, 8 * blocks) != 0:
        raise SystemExit("lapm_led_phases: reading the stamps failed")
    per = [[raw[8 * b + k] for k in range(8)] for b in range(blocks)]
    t0 = min(p[0] for p in per)
    out = {}
    for k, name in enumerate(STAMPS[:5]):
        us = [(p[k] - t0) / 1e3 for p in per]
        out[name] = dict(min=min(us), median=statistics.median(us), max=max(us))
    ends = [(p[5] - t0) / 1e3 for p in per if p[5] >= t0 and p[5] - t0 < 10 ** 9]
    out[STAMPS[5]] = max(ends) if ends else None
    return out


def _led_inputs(N, F, seed):
    """Random LED light inputs on the card: voxels of a 128^3 grid,
    keyframes 1.2-1.8 m from the grid's centre looking roughly at it, a
    third of the weights 0."""
    rng = np.random.default_rng(seed)
    geom = GridGeometry(dims=(128, 128, 128), voxel_size=1.8 / 128, shift=(0.0, 0.0, 0.0))
    idx = torch.from_numpy(rng.integers(0, 128, (N, 3)).astype(np.int32))
    grad = torch.from_numpy(rng.standard_normal((N, 3)).astype(np.float32))
    dist = torch.from_numpy((0.005 * rng.standard_normal(N)).astype(np.float32))
    albedo = torch.from_numpy(rng.random((N, 3)).astype(np.float32))
    xi = np.concatenate([0.2 * rng.standard_normal((F, 3)),
                         np.array([0.0, 0.0, -1.5]) + 0.3 * rng.standard_normal((F, 3))], 1)
    poses = torch.stack([se3_exp(torch.from_numpy(x.astype(np.float64))) for x in xi]).float()
    w = rng.random((N, F, 3)).astype(np.float32)
    w[rng.random((N, F)) < 0.3] = 0.0
    r = (0.1 * rng.standard_normal((N, F, 3))).astype(np.float32)
    dev = torch.device("cuda")
    rd = ResidualData(r=torch.from_numpy(r).to(dev), w=torch.from_numpy(w).to(dev),
                      mask=None, p_cam=None, uv=None, g_img=None)
    prob = types.SimpleNamespace(idx_xyz=idx.to(dev))
    return (rd, prob, geom, dist.to(dev), grad.to(dev), albedo.to(dev), poses.to(dev))


def main() -> int:
    if not torch.cuda.is_available():
        print("lapm_led_phases: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    seq = cs.make_sequence(cs.CHUNK)
    cache = build_fals_cache(cs.H, cs.W, seq[0], window=11, device="cuda")
    depth, color = cs._prep_frames(seq, range(cs.CHUNK))
    leds = {"49152 x 8": _led_inputs(49152, 8, 1),
            "12288 x 4": _led_inputs(12288, 4, 2),
            "49152 x 40": _led_inputs(49152, 40, 3)}
    with tempfile.TemporaryDirectory(prefix="lapm_led_phases_") as tmp:
        lib = build("preprocess.cu", tmp)
        lib.lapm.argtypes = [ctypes.POINTER(P._LapmArgs), ctypes.c_void_p]
        want = P.lapm(color)
        C, Hh, Ww, S = color.shape[0], cs.H, cs.W, 3
        plan = P.lapm_plan(C, Hh, Ww, S, cs._sm_count())
        blocks = C * plan.bands * plan.strips
        for case, before in (("after the normals", True), ("alone", False)):
            for _ in range(3):
                if before:
                    P.fals_normals(depth, cache, 11)
                got = cs._lapm_launch(lib, color, False)
            torch.cuda.synchronize()
            print(json.dumps(dict(kernel="lapm_kernel", case=f"8 x 640x480 RGB, {case}",
                                  plan=list(plan), blocks=blocks,
                                  bits_as_the_kernel=cs._bits_equal(got, want),
                                  stamps_us=spread(lib, blocks))), flush=True)
        lib = build("normaleq.cu", tmp)
        lib.light_normal_eqs_led.argtypes = [ctypes.POINTER(NE._LightLedArgs), ctypes.c_void_p]
        for case, x in leds.items():
            want = torch.cat(NE.light_normal_eqs_led(*x))
            for _ in range(3):
                got = torch.cat(cs._led_launch(lib, x, False))
            torch.cuda.synchronize()
            plan = NE.led_plan(x[0].w.shape[0], x[0].w.shape[1], cs._sm_count())
            print(json.dumps(dict(kernel="light_led_kernel", case=case, plan=list(plan),
                                  bits_as_the_kernel=cs._bits_equal(got, want),
                                  stamps_us=spread(lib, plan.blocks))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
