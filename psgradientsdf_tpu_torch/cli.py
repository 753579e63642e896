"""Command-line entry point: `python -m psgradientsdf_tpu_torch.cli --config_file x.json`.

The reference's single --config_file interface (cpp/voxel_ps/src/
main_ps.cpp:54-62) with the options of the JAX package's CLI that this port
has: the scan, then the photometric refinement unless --no-refine is given;
checkpoints (--checkpoint-every), resume (--resume), elastic recovery
(--retries), a torch.profiler trace of the run (--profile) and the scan on a
device mesh (--mesh, with --no-refine).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

import numpy as np

from psgradientsdf_tpu_torch.config import load_config
from psgradientsdf_tpu_torch.io import checkpoint as ckpt

# deterministic set-up and configuration errors are never worth retrying
# (NotImplementedError: a loader's missing method)
_NO_RETRY = (FileNotFoundError, ValueError, KeyError, TypeError,
             NotImplementedError)
CHECKPOINTS = ("scan_checkpoint.npz", "refine_checkpoint.npz")


def _complete(path: str) -> bool:
    """A checkpoint whose sidecar and companion files are all on disk (a save
    torn by the failure being recovered from is skipped); companions of the
    older layouts count (io/checkpoint.py)."""
    if not (os.path.exists(path) and os.path.exists(path + ".json")):
        return False
    try:
        with open(path + ".json") as fh:
            phase = json.load(fh).get("meta", {}).get("phase", "")
    except (OSError, json.JSONDecodeError):
        return False
    if phase == "refine":
        refine = ckpt.companion(path, "refine")
        if not refine:
            return False
        if ckpt.companion(path, "images"):
            return True
        with np.load(refine) as data:       # an older layout: images inline
            return "images" in data
    return bool(ckpt.companion(path, "scan"))


def _latest_checkpoint(out_dir: str, since: float) -> str:
    """The newest complete checkpoint this run wrote ("" if none)."""
    cand = [os.path.join(out_dir, name) for name in CHECKPOINTS]
    cand = [p for p in cand if _complete(p) and os.path.getmtime(p) >= since]
    return max(cand, key=os.path.getmtime) if cand else ""


def _profiler(trace_dir: str, device: str):
    """A torch.profiler session over the whole run that writes a Chrome
    trace into trace_dir on exit (a null context without a directory).  On
    the card it opens with utils/profiling.py's warm-up, which takes the
    device records the profiler drops at a session's start."""
    if not trace_dir:
        return contextlib.nullcontext()
    from psgradientsdf_tpu_torch.utils import profiling

    os.makedirs(trace_dir, exist_ok=True)

    def write(prof):
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    return profiling.session(cuda=device == "cuda", on_trace_ready=write)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="psgradientsdf-tpu-torch",
        description="RGB-D reconstruction via Gradient-SDF on a CUDA device "
        "(tracking, fusion, keyframes, photometric refinement, export)",
    )
    ap.add_argument("--config_file", required=True, help="JSON config (reference schema)")
    ap.add_argument("--no-refine", action="store_true",
                    help="stop after tracking+fusion")
    ap.add_argument("--summary-json", default="",
                    help="write the run summary to this JSON file")
    ap.add_argument("--platform", default="gpu", choices=["cpu", "gpu"],
                    help="gpu (default) runs on the CUDA device and fails "
                         "without one; cpu runs the plain PyTorch path")
    ap.add_argument("--mesh", default="", metavar="ZxF",
                    help="device mesh, e.g. 4x2 or 4 (Z-slabs x keyframe "
                         "shards): the scan runs on Z-slabs, the refinement "
                         "with the surface set over Z and the keyframes over "
                         "the second axis; overrides the config's \"mesh "
                         "shape\"")
    ap.add_argument("--mesh-devices", default="", metavar="LIST",
                    help="the mesh's devices in order, comma-separated; a "
                         "device may repeat (cuda:0,cuda:0,cuda:0,cuda:0 puts "
                         "a 2x2 mesh on one card).  Default: every CUDA "
                         "device, or the CPU 8 times with --platform cpu")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="save a resumable checkpoint every N scan frames "
                         "and every N refinement iterations (needs an output "
                         "directory in the config)")
    ap.add_argument("--resume", default="",
                    help="resume from a checkpoint written by "
                         "--checkpoint-every (scan_checkpoint.npz, or "
                         "refine_checkpoint.npz, which skips the completed "
                         "scan); the JAX package's checkpoints resume too")
    ap.add_argument("--retries", type=int, default=0, metavar="N",
                    help="elastic recovery: on a runtime failure retry the "
                         "run up to N times, resuming from the newest complete "
                         "checkpoint this run wrote (PSGSDF_RETRY_BACKOFF "
                         "seconds between attempts, default 30)")
    ap.add_argument("--profile", default="", metavar="DIR",
                    help="write a torch.profiler trace of the whole run "
                         "(Chrome trace format, DIR/trace.json)")
    ap.add_argument("--eval-ate", default="", metavar="GT_FILE",
                    help="after the run, associate the written "
                         "tracking_poses.txt with this TUM-format ground-"
                         "truth trajectory by timestamp and report ATE-RMSE")
    args = ap.parse_args(argv)

    from psgradientsdf_tpu_torch.pipeline import ReconstructionPipeline

    print(f"load the config file from: {args.config_file}")
    cfg = load_config(args.config_file)
    if args.mesh:
        parts = args.mesh.lower().split("x")
        try:
            cfg.tpu.mesh_z = int(parts[0])
            cfg.tpu.mesh_frames = int(parts[1]) if len(parts) > 1 else 1
        except (ValueError, IndexError):
            ap.error(f"--mesh expects ZxF or Z, got {args.mesh!r}")
    device = "cpu" if args.platform == "cpu" else "cuda"
    mesh_devices = ([d.strip() for d in args.mesh_devices.split(",")]
                    if args.mesh_devices else None)

    resume = args.resume
    attempt = 0
    t_start = time.time()
    with _profiler(args.profile, device):
        while True:
            pipe = ReconstructionPipeline(
                cfg, device=device, checkpoint_every=args.checkpoint_every,
                resume=resume, mesh_devices=mesh_devices)
            try:
                summary = pipe.run(refine=not args.no_refine)
                break
            except _NO_RETRY:
                raise
            except Exception as e:  # elastic recovery
                # the failed attempt's initial export must not go on writing
                # into the output directory while the retry runs
                pipe._join_export(swallow=True)
                attempt += 1
                if attempt > args.retries:
                    raise
                failure = f"{type(e).__name__}: {e}"
            # the failed pipeline's volume and keyframe stack must leave the
            # card before the next attempt makes its own (the traceback, which
            # holds them too, ended with the except block).  A sticky CUDA
            # error (an illegal address) is not cleared by this: the next
            # attempt fails as well, and the last one raises.
            pipe.close()
            del pipe
            gc.collect()
            if device == "cuda":
                import torch

                torch.cuda.empty_cache()
            latest = (_latest_checkpoint(cfg.tracking.output, t_start)
                      if args.checkpoint_every > 0 and cfg.tracking.output else "")
            resume = latest or args.resume
            print(f"run failed ({failure}); retry {attempt}/{args.retries}"
                  + (f" resuming from {resume}" if resume else " from scratch"))
            backoff = float(os.environ.get("PSGSDF_RETRY_BACKOFF", "30"))
            time.sleep(min(backoff * attempt, 120.0))
    pipe.close()

    if args.eval_ate:
        from psgradientsdf_tpu_torch.io.trajectory import evaluate_ate

        # the pipeline writes tracking_poses.txt only when an output dir is
        # configured — a missing trajectory must not crash a successful run
        traj = (os.path.join(cfg.tracking.output, "tracking_poses.txt")
                if cfg.tracking.output else "")
        if traj and os.path.exists(traj):
            summary["ate"] = evaluate_ate(traj, args.eval_ate)
        else:
            print("--eval-ate: no tracking_poses.txt (config has no output "
                  "dir or the scan wrote no trajectory); skipping ATE",
                  file=sys.stderr)
            summary["ate"] = None
    summary_small = {k: v for k, v in summary.items()
                     if k not in ("track_log", "refine_energy_trace")}
    print(json.dumps(summary_small, default=float))
    if args.summary_json:
        with open(args.summary_json, "w") as fh:
            json.dump(summary, fh, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
