#!/usr/bin/env python3
"""Where the distance block's CG (csrc/distcg.cu dist_cg_kernel) spends its
time on the card: the measurements behind its design.

    python3 tools/distcg_tune.py

Drives chip_smoke.py's main run (SH1) and LED upsample run on the card and
takes their final distance blocks at the loops' own weights, then prints one
JSON object a line:
  phases    a copy of csrc/distcg.cu with clock64() stamps at the phases of
            every CG step, thread 0 of each block (built into a temporary
            directory): the mean cycles of each phase over blocks and steps,
            and the mean over steps of the slowest block's;
  ablation  the same copy with the gather phase's loads of other tiles' data
            taken out, some or all (its deltas are wrong; only its times
            are read);
  barriers  tools/distcg_barriers.cu: an empty cooperative kernel on 128
            and 132 blocks crossing 24 and 48 barriers of each kind
            (grid.sync; dist_cg's counter with its sums; grid.sync and the
            same load of the partials; tagged partials polled by every
            block), milliseconds;
  blocks    dist_cg on plans of fewer blocks (larger tiles), against the
            plain solve.
(chip_smoke.py --distcg-parent times the same solves on an earlier source.)
Times are medians of chip_smoke.KERNEL_REPS with the L2 flushed.  Needs the
card; imports nothing of JAX.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402

STEPS_KEPT = 16                    # steps a block stamps
STAMPS = 8                         # stamps a step
# where the instrumented copy stamps: (a line of the source, what goes
# before it, what goes after it); the gather and the update end at a
# __syncthreads of their own, so that a stamp holds the whole block
STAMP_AT = (
    ("    if (!(rr > thr)) break;                       // the same in every block\n", "",
     "    STAMP(0);\n"),
    ("    if (p.lap_nbr) {\n      for (int l = tid; l < rows; l += kCgThreads) {\n",
     "    STAMP(1);\n", ""),
    ("    // Then row m gathers", "    STAMP(2);\n", ""),
    ("    float pAp[1];\n", "    __syncthreads();\n    STAMP(3);\n", ""),
    ("    const float alpha = gamma / (p.fixed ? clamp30(pAp[0]) : pAp[0]);\n", "",
     "    STAMP(4);\n"),
    ("    float gr[2];\n", "    __syncthreads();\n    STAMP(5);\n", ""),
    ("    steps = k + 1;\n", "", "    STAMP(6);\n"),
)
PHASES = ("p", "s (and the Laplacian rows)", "gather", "barrier 1", "update", "barrier 2")
# the gather phase's loads of other tiles' data, taken out by the ablation
LOADS = {
    "A and stencil rows": [
        ("const float4 av = ldcg_if(off[c], p.arow + static_cast<size_t>(ax) * p.n + n);",
         "const float4 av = make_float4(1.0f, 1.0f, 1.0f, 1.0f);"),
        ("const int2 ov = ldcg_if(off[c], p.onbr + static_cast<size_t>(ax) * p.n + n);",
         "const int2 ov = make_int2(-1, -1);")],
    "p at their stencil": [
        ("          const float g = p_at(no[c][i] >= 0 ? no[c][i] : m);\n",
         "          const float g = 0.5f;\n")],
    "p of the rows": [("        const float pv = p_at(n);\n", "        const float pv = p_at(m);\n")],
}


def _stamped(src, out, extra=()):
    """csrc/distcg.cu with the clock64() stamps (and `extra` replacements)
    -> a library built at `out`, with dist_cg_stamps(host, bytes)."""
    s = open(src).read()
    s = s.replace("namespace cg = cooperative_groups;\n",
                  "namespace cg = cooperative_groups;\n"
                  f"__device__ long long g_stamps[1 << 18];\n"
                  "#define STAMP(i) do { if (threadIdx.x == 0 && k < "
                  f"{STEPS_KEPT}) g_stamps[((size_t)blockIdx.x * {STEPS_KEPT} + k) * "
                  f"{STAMPS} + (i)] = clock64(); }} while (0)\n", 1)
    for line in [a for a, _, _ in STAMP_AT] + [a for a, _ in extra]:
        cs.check(s.count(line) == 1, f"the instrumented copy: no single '{line.strip()}'")
    for line, before, after in STAMP_AT:
        s = s.replace(line, before + line + after)
    for a, b in extra:
        s = s.replace(a, b)
    s += ('\nextern "C" int dist_cg_stamps(void* host, int64_t bytes) {\n'
          "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, "
          "static_cast<size_t>(bytes)));\n}\n")
    cu = out + ".cu"
    with open(cu, "w") as fh:
        fh.write(s)
    return cu


def _build(cu, lib):
    from psgradientsdf_tpu_torch import kernels

    proc = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-o", lib, cu],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cs.check(proc.returncode == 0, f"nvcc on {cu} failed:\n{proc.stdout}")
    return lib


def _systems():
    """(name, A, t, valid, stencil, lap, kw) of the main run's and the LED
    run's final distance blocks."""
    from psgradientsdf_tpu_torch.ops import distcg as DC

    out = []
    with tempfile.TemporaryDirectory(prefix="distcg_tune_") as tmp:
        seq = cs.make_sequence(cs.FRAMES)
        main = cs.run_scan(tmp, "scan", seq, cs.FRAMES - 1, "dma", refine=cs.REFINE_SH1)
        led, _, _ = cs.run_led_upsample(tmp)
        for name, run in (("main SH1", main), ("LED after the upsample", led)):
            ref = run["pipe"].refiner
            c = cs._dist_inputs(ref, *cs._loop_weights(ref))
            A, t = DC.dist_system(c["rd"], c["DJ"], c["eik"], reg_weight_n=c["w_n"])
            kw = dict(reg_weight_l=c["w_l"], damping=c["damping"], cg_iters=100,
                      cg_tol=1e-6, cg_static=False)
            out.append((name, A, t, c["prob"].valid, c["stencil"], c["lap"], kw))
    return out


def _with_library(lib, fn):
    """fn() with ops/distcg.py bound to another build of its source."""
    from psgradientsdf_tpu_torch import kernels
    from psgradientsdf_tpu_torch.ops import distcg as DC

    saved = (DC._bound, kernels._libs.get("distcg"), dict(DC._plans), dict(DC._occupancy))
    DC._bound, DC._plans, DC._occupancy = None, {}, {}
    kernels._libs["distcg"] = ctypes.CDLL(lib)
    try:
        return fn(DC._library())
    finally:
        DC._bound, kernels._libs["distcg"] = saved[0], saved[1]
        DC._plans, DC._occupancy = saved[2], saved[3]


def _phases(lib, systems, flush):
    import torch
    from psgradientsdf_tpu_torch.ops import distcg as DC

    def run(L):
        L.dist_cg_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        rows = []
        for name, A, t, valid, st, lap, kw in systems:
            ms = cs._time_ms(lambda: DC.dist_cg(A, t, valid, st, lap, **kw), flush)
            steps = []
            DC.dist_cg(A, t, valid, st, lap, **kw, steps_out=steps)
            torch.cuda.synchronize()
            plan = cs._cg_plan_of(A, lap)
            buf = np.zeros(1 << 18, dtype=np.int64)
            cs.check(L.dist_cg_stamps(buf.ctypes.data, buf.nbytes) == 0, "the stamps")
            k = min(int(steps[0]), STEPS_KEPT)
            # step 0 forms p from the prologue's: steps 1.. are kept
            a = buf[:plan.blocks * STEPS_KEPT * STAMPS].reshape(
                plan.blocks, STEPS_KEPT, STAMPS)[:, 1:k, :7].astype(np.float64)
            d = np.diff(a, axis=2)
            rows.append(dict(case=name, ms=ms, steps=int(steps[0]), blocks=plan.blocks,
                             cycles={p: float(d[..., i].mean()) for i, p in enumerate(PHASES)},
                             slowest_block={p: float(d[..., i].max(axis=0).mean())
                                            for i, p in enumerate(PHASES)},
                             step_cycles=float((a[..., 6] - a[..., 0]).mean())))
        return rows
    return _with_library(lib, run)


def _barriers(flush):
    import torch

    with tempfile.TemporaryDirectory(prefix="distcg_barriers_") as tmp:
        L = ctypes.CDLL(_build(os.path.join(HERE, "distcg_barriers.cu"),
                               os.path.join(tmp, "libbarriers.so")))
        L.run_barriers.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
        kinds = ("grid.sync", "counter and sums (dist_cg's)", "grid.sync and the load",
                 "tagged partials, polled by every block")
        out = []
        for blocks in (128, 132):
            slots = torch.empty(4 * blocks, dtype=torch.int64, device="cuda")
            part = torch.empty(4 * blocks, dtype=torch.float32, device="cuda")
            counter = torch.empty(1, dtype=torch.int32, device="cuda")
            for barriers in (24, 48):
                def run(kind):
                    rc = L.run_barriers(blocks, barriers, kind, slots.data_ptr(),
                                        part.data_ptr(), counter.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
                    cs.check(rc == 0, f"run_barriers: CUDA error {rc}")
                out.append(dict(blocks=blocks, barriers=barriers, ms={
                    name: cs._time_ms(lambda k=k: run(k), flush)
                    for k, name in enumerate(kinds)}))
        return out


def _blocks(systems, flush):
    import torch
    from psgradientsdf_tpu_torch.ops import distcg as DC

    out = []
    real = DC.cg_plan
    try:
        for name, A, t, valid, st, lap, kw in systems:
            sp = []
            dp = DC.dist_cg_plain(A, t, valid, st, lap, **kw, steps_out=sp)
            scale = float(dp.abs().max())
            for sms in (132, 96, 64):
                DC.cg_plan = lambda dev, n, *, sms=sms, **kw: DC._cg_plan(n, sms=sms, **kw)
                s1 = []
                d1 = DC.dist_cg(A, t, valid, st, lap, **kw, steps_out=s1)
                torch.cuda.synchronize()
                cs.check(int(s1[0]) == int(sp[0])
                         and cs._abs_err(d1, dp) <= cs.DIST_CG_TOL * scale,
                         f"{name}: dist_cg on {sms} blocks differs from the plain solve")
                plan = DC.cg_plan(A.device, A.shape[0], use_lap=lap is not None,
                                  lap_nbr=lap is not None and lap.nbr_coef != 0.0)
                out.append(dict(case=name, blocks=plan.blocks, rows_per_block=plan.tile,
                                ms=cs._time_ms(lambda: DC.dist_cg(A, t, valid, st, lap, **kw),
                                               flush)))
    finally:
        DC.cg_plan = real
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("distcg_tune: no CUDA device", file=sys.stderr)
        return 1
    from psgradientsdf_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    systems = _systems()
    src = kernels.source_path("distcg")
    with tempfile.TemporaryDirectory(prefix="distcg_tune_") as tmp:
        variants = {"all loads": ()}
        for name, reps in LOADS.items():
            variants[f"without {name}"] = tuple(reps)
        variants["without any"] = tuple(r for reps in LOADS.values() for r in reps)
        for name, extra in variants.items():
            base = os.path.join(tmp, f"stamped{len(extra)}_{abs(hash(name)) % 10**6}")
            lib = _build(_stamped(src, base, extra), base + ".so")
            print(json.dumps({"phases" if not extra else "ablation": name,
                              "cases": _phases(lib, systems, flush)}), flush=True)
    print(json.dumps({"barriers": _barriers(flush)}), flush=True)
    print(json.dumps({"blocks": _blocks(systems, flush)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
