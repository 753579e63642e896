#!/usr/bin/env python3
"""The SH light block's eigen-solve (ops/smallsolve.light_solve, one
launch) of this tree against an earlier smallsolve.cu of the same C
interface, in turns on one card.

    python3 tools/light_solve_ab.py [--turns N] [<smallsolve.cu>]

The earlier source defaults to tools/smallsolve_cyclic.cu (the cyclic-order
design: one rotation at a time in row order); any source whose SolveArgs is
a prefix of this tree's will do, for example a commit's, written out first:

    git show <commit>:psgradientsdf_tpu_torch/csrc/smallsolve.cu > archive_check/smallsolve_earlier.cu
    python3 tools/light_solve_ab.py archive_check/smallsolve_earlier.cu

The problems are chip_smoke.py's main SH1 and SH2 light blocks: its
48-frame scan and SH1 refinement (chip_smoke.run_scan), the light block's
normal equations at the refinement's final state under SH1 lights and under
SH2 lights (chip_smoke._light_system; F = 40, B = 4 and 9).  Both builds
are held to light_solve_plain within chip_smoke.LIGHT_SOLVE_TOL of
max|delta|, then timed in turns (this, earlier, earlier, this; N times with
--turns) in the path's order, after light_normal_eqs_sh
(chip_smoke._solve_ab).  Prints one JSON line with the card's name and
power limit, each build's times, rotations and error, and this build's
rounds that rotated a keyframe.  Needs one CUDA card; exits 1 without one.
Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import torch

    if not torch.cuda.is_available():
        print("tools/light_solve_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from psgradientsdf_tpu_torch.ops import smallsolve as SS

    args = sys.argv[1:]
    turns = int(args[args.index("--turns") + 1]) if "--turns" in args else 1
    sources = [a for a in args if a.endswith(".cu")]
    src = sources[0] if sources else os.path.join(HERE, cs.EARLIER_SOLVE)
    with tempfile.TemporaryDirectory(prefix="light_solve_ab_") as tmp:
        seq = cs.make_sequence(cs.FRAMES)
        run = cs.run_scan(tmp, "scan", seq, cs.FRAMES - 1, "dma", refine=cs.REFINE_SH1)
        ref = run["pipe"].refiner
        systems = {order: cs._light_system(ref, order) for order in (1, 2)}
        out = cs._solve_ab(systems, src, turns)
        for order, (H, g, _, _) in systems.items():
            rounds = []
            SS.light_solve(H, g, rounds_out=rounds)
            facts = out[f"SH{order}"]
            facts.update(keyframes=int(H.shape[0]), basis=int(H.shape[1]),
                         rounds_max=int(rounds[0].max()),
                         this_ms=statistics.median(facts["this"]),
                         earlier_ms=statistics.median(facts["earlier"]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "earlier": os.path.relpath(src, HERE),
                      "turns": turns, "tolerance": cs.LIGHT_SOLVE_TOL, "cases": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
