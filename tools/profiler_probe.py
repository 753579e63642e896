#!/usr/bin/env python3
"""How many of a short traced body's device records a torch.profiler session
keeps, at points of a long run, on one card.

    KINETO_LOG_LEVEL=0 python3 tools/profiler_probe.py [--warmup] [tree]

From the root of a tree (this one, or [tree]: an unpacked earlier commit),
it builds the kernels, then runs chip_smoke.py's kernel checks, its main
scan and refinement (with --profile's first-iteration traces), the short
scans and the scan on a mesh, and after each of these (and at the start)
traces the same body six times: a fill, one direct row gather, a fill, a
synchronize, twice (6 device records).  Each session prints what it kept
(fills, gathers, device records).  With --warmup each session is
chip_smoke._traced (a warm-up of throwaway kernels first; a tree whose
chip_smoke.py has it), otherwise a plain torch.profiler session.
KINETO_LOG_LEVEL=0 makes the profiler log, on stderr, each session's
records "Out-of-range" of its window.  Needs one CUDA card."""

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    args = [a for a in sys.argv[1:] if a != "--warmup"]
    warmup = "--warmup" in sys.argv[1:]
    root = os.path.abspath(args[0]) if args else HERE
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return 1
    sys.argv = ["chip_smoke.py", "--profile"]
    import chip_smoke as cs
    from psgradientsdf_tpu_torch import kernels, native
    from psgradientsdf_tpu_torch.ops import rowcopy

    t_start = time.time()
    started = {n: kernels.start_build(n) for n in cs.LIBRARIES}
    for n, job in started.items():
        kernels.finish_build(n, job)
    for n in kernels.CUDA_LIBRARIES:
        kernels.load_library(n)
    native.library(native.PNG_LIB)
    native.library(native.MC_LIB)
    table = torch.zeros((64, 128), device="cuda")
    idx = torch.zeros(32, dtype=torch.int32, device="cuda")
    mark = torch.empty(1, device="cuda")

    def body():
        mark.fill_(1.0)
        rowcopy.gather_rows_dma(table, idx)
        mark.fill_(2.0)
        torch.cuda.synchronize()

    def session():
        if warmup:
            return cs._traced()
        return profile(activities=[ProfilerActivity.CUDA])

    def probe(tag):
        body()
        kept = []
        for n in range(6):
            print(f"--- probe {tag} session {n}", file=sys.stderr, flush=True)
            with session() as prof:
                body()
                body()
            rows = [(e.count, e.key) for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA") and "spin_kernel" not in e.key]
            kept.append(dict(fills=sum(c for c, k in rows if "FillFunctor" in k),
                             gathers=sum(c for c, k in rows if "gather" in k.lower()),
                             records=sum(c for c, _ in rows)))
        print(json.dumps(dict(probe=tag, seconds=time.time() - t_start, warmup=warmup,
                              expected=dict(fills=4, gathers=2, records=6),
                              sessions=kept)), flush=True)

    probe("start")
    seq = cs.make_sequence(cs.FRAMES)
    cs.check_kernels(rowcopy)
    probe("after kernels")
    with tempfile.TemporaryDirectory(prefix="probe_") as tmp:
        cs.scan_kernels(tmp, seq)
        probe("after scan_kernels")
        with cs._first_iteration_blocks(True) as blocks:
            cs.run_scan(tmp, "scan", seq, cs.FRAMES - 1, "dma", refine=cs.REFINE_SH1)
        print(json.dumps({"first_iteration_blocks": {
            k: v["device_kernels"] for k, v in blocks.items()}}), flush=True)
        probe("after the main run")
        short = 2 * cs.CHUNK + 1
        dma = cs.run_scan(tmp, "short", seq, short - 1, "dma")
        probe("after a short scan")
        cs.mesh_scan(tmp, seq, short, dma)
        probe("after mesh_scan")
    return 0


if __name__ == "__main__":
    sys.exit(main())
