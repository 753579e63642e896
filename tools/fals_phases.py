#!/usr/bin/env python3
"""Where a launch of the FALS normals kernel (csrc/preprocess.cu
fals_normals_kernel) spends its time, phase by phase, on one card.

    python3 tools/fals_phases.py

Builds a copy of csrc/preprocess.cu into a temporary directory in which
thread 0 of every block reads clock64() at the kernel's phase boundaries
and adds each phase's cycles into a __device__ array (read back with
cudaMemcpyFromSymbol).  The copy is made by text substitution at fixed
anchors of the source, and the script stops if one is missing.  Runs it
once on chip_smoke.py's first chunk (8 frames of 640x480, window 11, the
pipeline's cache), checks its normals bit for bit against this tree's
kernel, and prints each phase's cycles summed over the blocks and its
share.  The phases are those of a unit (32 x 32 tile, frame) in the
kernel's pipeline: the block's first tile (setup, the first halos, the
first weighted halo), issuing the depth halo two units ahead, the
horizontal window sums, the wait for the next halo and the barrier, the
vertical sums and the solve, and the next unit's weighted halo and its
barrier (or a new tile's setup).  A block's cycles include its waits at
the barriers.  Prints one JSON object a line, the card's name and power
limit first.  Needs the card; imports nothing of JAX.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from psgradientsdf_tpu_torch import kernels  # noqa: E402
from psgradientsdf_tpu_torch.ops import preprocess as P  # noqa: E402
from psgradientsdf_tpu_torch.ops.normals import build_fals_cache  # noqa: E402

# the counters and their reader, put before the kernel's namespace
COUNTERS = r'''
__device__ unsigned long long g_phase_cycles[6];
extern "C" int read_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
}
'''
STAMP = ("#define STAMP(k) if (t == 0) { tq = clock64(); "
         "atomicAdd(&g_phase_cycles[k], tq - tp); tp = tq; }\n")
PHASES = ("first tile", "issue the halo two units ahead", "horizontal sums",
          "wait for the next halo, barrier", "vertical sums and the solve",
          "next weighted halo, barrier (or a new tile)")
# (anchor, text put in its place); each anchor must occur exactly once
EDITS = (
    ("namespace {\n\nconstexpr int kTile", COUNTERS + "namespace {\n\nconstexpr int kTile"),
    ("  start_tile(u0);\n",
     "  unsigned long long tp = clock64(), tq;\n" + STAMP + "  start_tile(u0);\n  STAMP(0)\n"),
    ("    if (ahead) fetch(u + 2);\n", "    if (ahead) fetch(u + 2);\n    STAMP(1)\n"),
    ("    if (same(u, u + 1)) {\n      if (ahead) cp_async_wait<1>();",
     "    STAMP(2)\n    if (same(u, u + 1)) {\n      if (ahead) cp_async_wait<1>();"),
    ("    __syncthreads();\n\n    // 3b. vertical", "    __syncthreads();\n    STAMP(3)\n\n    // 3b. vertical"),
    ("    // the next unit's weighted halo", "    STAMP(4)\n    // the next unit's weighted halo"),
    ("      start_tile(u + 1);\n    }\n  }\n}", "      start_tile(u + 1);\n    }\n    STAMP(5)\n  }\n}"),
)


def stamped_source() -> str:
    with open(os.path.join(kernels.CSRC_DIR, "preprocess.cu")) as fh:
        src = fh.read()
    for anchor, text in EDITS:
        if src.count(anchor) != 1:
            raise SystemExit(f"fals_phases: anchor not found once in preprocess.cu: {anchor!r}")
        src = src.replace(anchor, text)
    return src


def build(src: str, tmp: str) -> ctypes.CDLL:
    path = os.path.join(tmp, "preprocess_phases.cu")
    with open(path, "w") as fh:
        fh.write(src)
    lib = os.path.join(tmp, "libpreprocess_phases.so")
    proc = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR,
                           "-o", lib, path],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"fals_phases: nvcc failed:\n{proc.stdout}")
    out = ctypes.CDLL(lib)
    out.fals_normals.argtypes = [ctypes.POINTER(P._FalsArgs), ctypes.c_void_p]
    out.fals_normals_occupancy.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    out.read_phase_cycles.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("fals_phases: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    seq = cs.make_sequence(cs.CHUNK)
    cache = build_fals_cache(cs.H, cs.W, seq[0], window=11, device="cuda")
    depth, _ = cs._prep_frames(seq, range(cs.CHUNK))
    want = P.fals_normals(depth, cache, 11)
    with tempfile.TemporaryDirectory(prefix="fals_phases_") as tmp:
        lib = build(stamped_source(), tmp)
        per_sm = ctypes.c_int64()
        if lib.fals_normals_occupancy(11, ctypes.byref(per_sm)) != 0:
            raise SystemExit("fals_phases: the occupancy query failed")
        cycles = (ctypes.c_uint64 * 6)()
        lib.read_phase_cycles(cycles)                  # zero the counters
        got = cs._fals_launch(lib, depth, cache, 11, per_sm.value)
        torch.cuda.synchronize()
        if lib.read_phase_cycles(cycles) != 0:
            raise SystemExit("fals_phases: reading the counters failed")
    total = sum(cycles)
    print(json.dumps(dict(
        case=f"{cs.CHUNK} frames of {cs.W}x{cs.H}, window 11", blocks_per_sm=per_sm.value,
        blocks=P.fals_grid(cs.CHUNK, cs.H, cs.W, cs._sm_count() * per_sm.value)[3],
        bits_as_the_kernel=cs._bits_equal(got, want),
        phases={name: dict(cycles=int(c), share=c / total) for name, c in zip(PHASES, cycles)})),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
