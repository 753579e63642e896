#!/usr/bin/env python3
"""The scan's device operations and runtime calls a frame, this tree against
an earlier one, in turns, on one card.

    python3 tools/scan_profile_ab.py <earlier tree> [--turns N]

<earlier tree> is an unpacked copy of an earlier commit (`git archive
<commit> | tar -x -C archive_check/parent`: the card machine has no .git).
Each turn is one process on one tree: it imports that tree's chip_smoke.py
and package, builds the kernels, scans the smoke run's first 2 * CHUNK + 1
frames once untraced (the warm-up, and the frames/s), then once more inside
this tree's chip_smoke._traced session, and prints one JSON line: the
device operations and the host's CUDA runtime calls a frame, the card's
busy share, the kernels by device time.  Both trees are traced and counted
by this file's code, the same way.  The trees run as earlier, this, this,
earlier (N pairs with --turns).  Needs one CUDA card; exits 1 without one."""

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_turn(root):
    """This process: the traced scan of the tree at `root` -> one JSON line."""
    import importlib.util

    import torch

    if not torch.cuda.is_available():
        return 1
    # this tree's session and counting helpers, before the measured tree's
    # package takes the import path
    spec = importlib.util.spec_from_file_location("smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    for name in [m for m in sys.modules if m.startswith("psgradientsdf_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from psgradientsdf_tpu_torch import kernels

    assert os.path.dirname(os.path.abspath(kernels.__file__)).startswith(root)
    for name in kernels.CUDA_LIBRARIES:
        kernels.load_library(name)
    seq = cs.make_sequence(cs.FRAMES)
    frames = 2 * cs.CHUNK + 1
    with tempfile.TemporaryDirectory(prefix="scan_profile_") as tmp:
        plain = cs.run_scan(tmp, "plain", seq, frames - 1, "dma")
        with here._traced() as prof:
            traced = cs.run_scan(tmp, "traced", seq, frames - 1, "dma")
    rows = sorted(here._kernel_rows(prof), reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps(dict(
        tree=root, card=smi, frames=frames,
        culled_fusions=traced["pipe"].fuse_culled_calls,
        frames_per_s=plain["summary"]["fps"],
        untraced_scan_seconds=plain["summary"]["seconds"],
        device_busy_seconds=busy,
        device_busy_share=busy / plain["summary"]["seconds"],
        device_ops_per_frame=sum(r[1] for r in rows) / frames,
        runtime_calls_per_frame=here._runtime_calls(prof) / frames,
        eager_cull_kernels=int(sum(r[1] for r in rows if here._is_eager_cull(r[2]))),
        warmup_dropped=prof.warmup_dropped,
        top=[dict(name=k[:80], launches=n, device_ms=us * 1e-3)
             for us, n, k in rows[:12]]), default=float), flush=True)
    return 0


def main():
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        return one_turn(os.path.abspath(args[1]))
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    earlier = os.path.abspath(args[0])
    turns = int(args[args.index("--turns") + 1]) if "--turns" in args else 1
    rc = 0
    for root in [earlier, HERE, HERE, earlier] * turns:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
