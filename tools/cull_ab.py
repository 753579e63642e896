#!/usr/bin/env python3
"""The culled fusion's cull and compaction (ops/cull.cull_compact, one
launch) under other launch plans, and as a thread-block cluster, in turns
on one card.

    python3 tools/cull_ab.py [--turns N] [<cull.cu> ...]

The variants, each through the package's wrapper and C interface:
  cooperative        csrc/cull.cu on its host plan (cull_compact_blocks)
  cooperative@SMs    csrc/cull.cu on one block an SM
  cluster16, cluster8
                     tools/cull_cluster.cu (built here with nvcc): the same
                     plan as one cluster of 16 or 8 blocks, cluster.sync()
                     for the grid barriers, the row maxima and the blocks'
                     counts through distributed shared memory
  <name of a cull.cu>
                     an earlier source of the same C interface (built here),
                     on the package's host plan
The cases are chip_smoke.py's: frame 24 of its sequence at 128^3 (640x480),
at 512^3 and at 1280x960, and frames 1-8 as one K-frame launch, at the
fusion's capacity.  Each variant's mask, indices, n_active, live and
overflow are held bit for bit against the package's kernel on its plan;
then every case is timed in turns (A B C D D C B A, N times with --turns)
in the path's order (chip_smoke._path_ms: behind a spin kernel, no flush).
Prints one JSON line with the card's name and power limit.  Needs one CUDA
card; exits 1 without one."""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import torch

    if not torch.cuda.is_available():
        print("tools/cull_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from psgradientsdf_tpu_torch.core.grid import GridGeometry
    from psgradientsdf_tpu_torch.kernels import sm_count
    from psgradientsdf_tpu_torch.ops import cull as C

    turns = int(sys.argv[sys.argv.index("--turns") + 1]) if "--turns" in sys.argv else 1
    sms = sm_count(torch.device("cuda"))
    plan = C.cull_compact_blocks
    package = C._library()
    with tempfile.TemporaryDirectory(prefix="cull_ab_") as tmp:
        cluster = cs._parent_build(os.path.join(HERE, "tools", "cull_cluster.cu"),
                                   tmp, "cull_cluster")
        cluster.cull_compact.argtypes = [ctypes.POINTER(C._CullCompactArgs),
                                         ctypes.c_void_p]
        cluster.cull_compact.restype = ctypes.c_int
        variants = {
            "cooperative": (package, plan),
            "cooperative@SMs": (package, lambda H, K, n, s: s),
            "cluster16": (cluster, lambda H, K, n, s: 16),
            "cluster8": (cluster, lambda H, K, n, s: 8),
        }
        sources = [a for a in sys.argv[1:] if a.endswith(".cu")]
        for i, src in enumerate(sources):
            lib = cs._parent_build(src, tmp, f"cull_source{i}")
            lib.cull_compact.argtypes = [ctypes.POINTER(C._CullCompactArgs),
                                         ctypes.c_void_p]
            lib.cull_compact.restype = ctypes.c_int
            variants[os.path.basename(src)] = (lib, plan)

        seq = cs.make_sequence(cs.FRAMES)
        st = cs._stream_setup(tmp, seq, cs.FRAMES)
        geom, zkw, K, cap = st["geom"], st["zkw"], st["K"], st["cap"]
        X, Y, _ = geom.dims
        f = 24
        depth, pose = st["depths"][f], st["gt"][f]
        big = GridGeometry(dims=(cs.PACKED_BIG_GRID,) * 3,
                           voxel_size=geom.voxel_size * X / cs.PACKED_BIG_GRID,
                           shift=geom.shift)
        big_kw = dict(zkw, truncation=st["truncation"] * X / cs.PACKED_BIG_GRID)
        big_depth = depth.repeat_interleave(2, 0).repeat_interleave(2, 1)
        big_K = K.clone()
        big_K[0, 0], big_K[1, 1] = 2 * K[0, 0], 2 * K[1, 1]
        big_K[0, 2], big_K[1, 2] = 2 * K[0, 2] + 0.5, 2 * K[1, 2] + 0.5
        union = list(range(1, 1 + cs.PACKED_K))
        true = torch.tensor(True, device="cuda")
        cases = {
            f"frame {f} at {X}^3, 640x480": (geom, depth, K, pose, zkw, cap, true),
            f"frame {f} at {cs.PACKED_BIG_GRID}^3": (
                big, depth, K, pose, big_kw, cap * cs.PACKED_BIG_GRID ** 2 // (X * Y),
                true),
            f"frame {f} at 1280x960": (geom, big_depth, big_K, pose, zkw, cap, true),
            f"frames 1-{cs.PACKED_K} at {X}^3": (
                geom, st["depths"][union], K, torch.stack([st["gt"][g] for g in union]),
                zkw, cap, None),
        }

        def call(variant, case, mask=False):
            lib, blocks = variants[variant]
            g, d, k, p, kw, c, gates = cases[case]
            C._bound, C.cull_compact_blocks = lib, blocks
            try:
                return C.cull_compact(g, d, k, p, capacity=c, padded=True, gates=gates,
                                      mask=mask, **kw)
            finally:
                C._bound, C.cull_compact_blocks = package, plan

        out = {}
        for case in cases:
            want = call("cooperative", case, mask=True)
            for v in variants:
                got = call(v, case, mask=True)
                torch.cuda.synchronize()
                for field in want._fields:
                    cs.check(torch.equal(getattr(got, field), getattr(want, field)),
                             f"{v} differs from the package's kernel in {field}: {case}")
            order = list(variants) + list(variants)[::-1]
            times = {v: [] for v in variants}
            for _ in range(turns):
                for v in order:
                    times[v].append(cs._path_ms([lambda: call(v, case)])[0])
            d = cases[case][1]
            frames = 1 if d.dim() == 2 else d.shape[0]
            out[case] = dict(times, entries=want.mask.numel(), blocks={
                v: variants[v][1](d.shape[-2], frames, want.mask.numel(), sms)
                for v in variants})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "bit_identical": True,
                      "cases": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
