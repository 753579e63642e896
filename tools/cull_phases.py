#!/usr/bin/env python3
"""Where a launch of the culled fusion's cull and compaction
(csrc/cull.cu cull_compact_kernel) spends its time, phase by phase, on one
card.

    python3 tools/cull_phases.py

Builds a copy of csrc/cull.cu into a temporary directory in which thread 0
of every block reads %globaltimer (the card's nanosecond clock, the same
on every SM) at the kernel's phase boundaries into a __device__ array
(read back with cudaMemcpyFromSymbol).  The copy is made by text
substitution at fixed anchors of the source, and the script stops if one
is missing.  Runs it on chip_smoke.py's frame 24 at 128^3 (640x480), at
512^3 and on frames 1-8 (one K-frame launch), at the fusion's capacity,
checks its outputs bit for bit against this tree's kernel, and prints for
each boundary the median and the largest time over the blocks since the
first block started, in microseconds, beside the launch's time between
CUDA events.  The boundaries: the block's start, the row maxima done (warp
0's rows), grid barrier 1 crossed, the range tables built, the entries
culled into the words (the tables' level 0 loaded between), the counts written, grid barrier 2 crossed, the
offsets read, the ranked writes and the padding done.  Each launch runs
behind a spin kernel (chip_smoke._path_ms's setting), 20 times; the
medians of the 20 are printed.  Prints one JSON object a line, the card's
name and power limit first.  Needs the card; imports nothing of JAX.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from psgradientsdf_tpu_torch.core.grid import GridGeometry  # noqa: E402
from psgradientsdf_tpu_torch.ops import cull as C  # noqa: E402

MAX_BLOCKS = 132
BOUNDARIES = ("start", "row maxima", "barrier 1", "level 0 loaded", "tables",
              "entries", "counts", "barrier 2", "offsets", "ranked writes and padding")
COUNTERS = r'''
__device__ unsigned long long g_stamps[%d][%d];
extern "C" int read_stamps(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)));
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
  return t;
}
''' % (MAX_BLOCKS, len(BOUNDARIES))


def stamp(k):
    return f"  if (threadIdx.x == 0) g_stamps[blockIdx.x][{k}] = global_ns();\n"


# (anchor, text put in its place); each anchor must occur exactly once
EDITS = (
    ("namespace {\n\nconstexpr int kThreads", COUNTERS + "namespace {\n\nconstexpr int kThreads"),
    ("  const int groups = (end - begin + 31) / 32;\n  // a pass of the block",
     "  const int groups = (end - begin + 31) / 32;\n" + stamp(0) + "  // a pass of the block"),
    ("    for (int g = threadIdx.x; g < groups; g += kThreads) words[g] = 0u;\n    grid",
     stamp(1) + "    for (int g = threadIdx.x; g < groups; g += kThreads) words[g] = 0u;\n    grid"),
    ("    grid.sync();                           // ---- 2. grid barrier 1\n",
     "    grid.sync();                           // ---- 2. grid barrier 1\n" + stamp(2)),
    ("  __syncthreads();\n  build_levels(p, kn, st);\n",
     "  __syncthreads();\n" + stamp(3) + "  build_levels(p, kn, st);\n"),
    ("      build_tables(p, k0, kn, st);         // ends with a block barrier\n",
     "      build_tables(p, k0, kn, st);         // ends with a block barrier\n" + stamp(4)),
    ("          if (lane == 0 && b != 0u) atomicOr(words + g, b);\n        }\n      }\n"
     "    }\n  } else {",
     "          if (lane == 0 && b != 0u) atomicOr(words + g, b);\n        }\n      }\n"
     + stamp(5) + "    }\n  } else {"),
    ("  grid.sync();                             // ---- 4. grid barrier 2\n",
     stamp(6) + "  grid.sync();                             // ---- 4. grid barrier 2\n"
     + stamp(7)),
    ("  __syncthreads();\n  ranked_writes(p, words, begin, w_begin, w_end, tally, grid_facts);\n",
     "  __syncthreads();\n" + stamp(8)
     + "  ranked_writes(p, words, begin, w_begin, w_end, tally, grid_facts);\n"
     + "  __syncthreads();\n" + stamp(9)),
)


def instrumented(tmp):
    with open(os.path.join(os.path.dirname(HERE), "psgradientsdf_tpu_torch", "csrc",
                           "cull.cu")) as fh:
        src = fh.read()
    for anchor, text in EDITS:
        cs.check(src.count(anchor) == 1, f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    path = os.path.join(tmp, "cull_phases.cu")
    with open(path, "w") as fh:
        fh.write(src)
    lib = cs._parent_build(path, tmp, "cull_phases")
    lib.cull_compact.argtypes = [ctypes.POINTER(C._CullCompactArgs), ctypes.c_void_p]
    lib.cull_compact.restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        print("tools/cull_phases.py needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    package = C._library()
    with tempfile.TemporaryDirectory(prefix="cull_phases_") as tmp:
        lib = instrumented(tmp)
        seq = cs.make_sequence(cs.FRAMES)
        st = cs._stream_setup(tmp, seq, cs.FRAMES)
        geom, zkw, K, cap = st["geom"], st["zkw"], st["K"], st["cap"]
        X, Y, _ = geom.dims
        f = 24
        big = GridGeometry(dims=(cs.PACKED_BIG_GRID,) * 3,
                           voxel_size=geom.voxel_size * X / cs.PACKED_BIG_GRID,
                           shift=geom.shift)
        big_kw = dict(zkw, truncation=st["truncation"] * X / cs.PACKED_BIG_GRID)
        union = list(range(1, 1 + cs.PACKED_K))
        true = torch.tensor(True, device="cuda")
        cases = {
            f"frame {f} at {X}^3, 640x480": (geom, st["depths"][f], st["gt"][f], zkw,
                                             cap, true),
            f"frame {f} at {cs.PACKED_BIG_GRID}^3": (
                big, st["depths"][f], st["gt"][f], big_kw,
                cap * cs.PACKED_BIG_GRID ** 2 // (X * Y), true),
            f"frames 1-{cs.PACKED_K} at {X}^3": (
                geom, st["depths"][union], torch.stack([st["gt"][g] for g in union]),
                zkw, cap, None),
        }
        stamps = (ctypes.c_uint64 * (MAX_BLOCKS * len(BOUNDARIES)))()
        for what, (g, d, p, kw, c, gates) in cases.items():
            run = lambda mask=False: C.cull_compact(  # noqa: E731
                g, d, K, p, capacity=c, padded=True, gates=gates, mask=mask, **kw)
            want = run(True)
            C._bound = lib
            try:
                got = run(True)
                torch.cuda.synchronize()
                for field in want._fields:
                    cs.check(torch.equal(getattr(got, field), getattr(want, field)),
                             f"the instrumented copy differs in {field}: {what}")
                blocks = C.cull_compact_blocks(d.shape[-2], 1 if d.dim() == 2
                                               else d.shape[0], want.mask.numel(),
                                               cs._sm_count())
                cs.check(blocks <= MAX_BLOCKS, f"{blocks} blocks")
                marks = [[] for _ in BOUNDARIES]
                spread = [[] for _ in BOUNDARIES]
                events = []
                for _ in range(cs.KERNEL_REPS):
                    torch.cuda.synchronize()
                    torch.cuda._sleep(cs.SPIN_CYCLES)
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    run()
                    e1.record()
                    torch.cuda.synchronize()
                    events.append(e0.elapsed_time(e1) * 1e3)
                    rc = lib.read_stamps(stamps)
                    cs.check(rc == 0, f"read_stamps: CUDA error {rc}")
                    t = [[stamps[b * len(BOUNDARIES) + k] for k in range(len(BOUNDARIES))]
                         for b in range(blocks)]
                    t0 = min(row[0] for row in t)
                    for k in range(len(BOUNDARIES)):
                        col = [(row[k] - t0) * 1e-3 for row in t]
                        marks[k].append(statistics.median(col))
                        spread[k].append(max(col))
            finally:
                C._bound = package
            print(json.dumps({
                "case": what, "blocks": blocks, "launch_us": statistics.median(events),
                "boundaries_us": {b: {"median": statistics.median(m),
                                      "last_block": statistics.median(s)}
                                  for b, m, s in zip(BOUNDARIES, marks, spread)}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
