"""One process of tests/test_torch_distributed_checkpoint.py: joins a gloo
process group through a file:// rendezvous on the CPU and runs, on a 2x2
mesh over the group, the GT-pose recipe of tests/test_torch_distributed.py
with checkpoints and resume:

  stop         the scan of frames 0-2 with a checkpoint every 2 frames;
  resume       the scan of frames 0-5 resumed from stop's checkpoint (the
               one process 0 wrote);
  resume_one   the same from the checkpoint of a one-process 2x2 run;
  resume_jax   the same from the JAX package's single-device checkpoint;
  refine_fail  the scan and the refinement with a checkpoint every frame
               and iteration, an exception injected into iteration 1;
  refine       the refinement resumed from refine_fail's checkpoint;
  save_fails   stop again, process 0's checkpoint write made to fail.

Each run writes into an output directory of its own process, and is resumed
from process 0's files.  The faults are injected by wrapping a module
function (the iteration, process 0's file write); the package has no
switch for them.  Pickles what each run saw for the test to compare.

    python tests/torch_dist_ckpt_worker.py RANK WORLD RENDEZVOUS JOB.json OUT.pkl

Imports the PyTorch package only (no JAX), one torch thread a process.
"""

import json
import os
import pickle
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)

from psgradientsdf_tpu_torch.config import parse_config  # noqa: E402
from psgradientsdf_tpu_torch.io import checkpoint as ckpt  # noqa: E402
from psgradientsdf_tpu_torch.parallel import distributed  # noqa: E402
from psgradientsdf_tpu_torch.parallel import mesh as pm  # noqa: E402
import psgradientsdf_tpu_torch.refine.optimizer as optimizer_mod  # noqa: E402
from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger  # noqa: E402

from torch_dist_worker import Recorded, volume  # noqa: E402

CPU = "cpu"
# the group's timeout in seconds: a process left waiting in a collective
# fails after it
GROUP_SECONDS = 60


def out_dir(job, run, rank):
    """The output directory of `run` on process `rank`."""
    return os.path.join(job["tmp"], f"{run}_rank{rank}") + "/"


def record_checkpoint_writes():
    """The base names of every checkpoint file this process writes (the
    checkpoint module's two writers are wrapped) -> the list."""
    seen = []
    for name in ("_atomic_savez", "_atomic_json"):
        def spy(path, *a, _fn=getattr(ckpt, name), **k):
            seen.append(os.path.basename(path))
            return _fn(path, *a, **k)

        setattr(ckpt, name, spy)
    return seen


class Placed(Recorded):
    """Records the slabs of the scan's first placement (a resume's: the
    volume read from the file) that this process holds."""

    def _scan_layout(self, vol):
        svol = super()._scan_layout(vol)
        if not hasattr(self, "placed"):
            self.placed = [None if pm.is_remote(s) else tuple(s.dist.shape)
                           for s in svol.slabs]
        return svol


def refined(pipe):
    ref = pipe.refiner
    _, dist, albedo, _, _ = ref.gathered(False, False)
    return dict(dist=dist.numpy().copy(), albedo=albedo.numpy().copy(),
                poses=ref.poses.numpy().copy(), lights=ref.lights.numpy().copy(),
                n=ref.prob.n_surface)


def main():
    rank, world, rdv, job_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    with open(job_path) as fh:
        job = json.load(fh)
    distributed.initialize(num_processes=world, process_id=rank,
                           init_method="file://" + rdv, device=CPU,
                           timeout=GROUP_SECONDS)
    writes = record_checkpoint_writes()
    res = {}

    def run(name, raw, refine, **kw):
        """One pipeline run on this process's own output directory -> what
        it saw; an exception it raised is recorded with its seconds."""
        out = out_dir(job, name, rank)
        log = os.path.join(job["tmp"], f"{name}_rank{rank}.jsonl")
        pipe = Placed(parse_config(dict(raw, output=out), save_copy=False),
                      device=CPU, prefetch=False,
                      metrics=MetricsLogger(log, echo=False), **kw)
        writes.clear()
        got = {}
        t0 = time.perf_counter()
        try:
            got["summary"] = pipe.run(refine=refine)
        except Exception as e:
            got["error"] = (type(e).__name__, str(e), time.perf_counter() - t0)
        pipe.close()
        with open(log) as fh:
            got["events"] = [json.loads(line)["event"] for line in fh]
        got["writes"] = list(writes)
        got["files"] = sorted(os.listdir(out))
        if "summary" in got and refine:
            got["refined"] = refined(pipe)
            got["vol"] = volume(pipe.vol)
            got["local_rows"] = sum(not pm.is_remote(r) for r in pipe.refiner.prob.rows)
        elif "summary" in got:
            got["vol"] = volume(pipe.vol)
            got["key_poses"] = np.stack(pipe.key_poses)
            got["placed"] = pipe.placed
        res[name] = got
        return got

    scan = dict(job["raw"], last=2)
    full = job["raw"]
    run("stop", scan, False, checkpoint_every=2)
    stopped = out_dir(job, "stop", 0) + "scan_checkpoint.npz"
    run("resume", full, False, resume=stopped)
    run("resume_one", full, False, resume=job["one_checkpoint"])
    run("resume_jax", full, False, resume=job["jax_checkpoint"])

    # the refinement: iteration 1 fails on every process, after the
    # checkpoint of iteration 0
    real, calls = optimizer_mod._iteration_core, {"n": 0}

    def failing(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected failure in refinement iteration 1")
        return real(*a, **kw)

    optimizer_mod._iteration_core = failing
    try:
        run("refine_fail", job["raw"], True, checkpoint_every=1)
    finally:
        optimizer_mod._iteration_core = real
    run("refine", job["raw"], True, checkpoint_every=1,
        resume=out_dir(job, "refine_fail", 0) + "refine_checkpoint.npz")

    # process 0's write fails: every process raises, none waits for the
    # group's timeout
    if rank == 0:
        real_savez = ckpt._atomic_savez

        def full_disk(path, *a, **k):
            raise OSError(28, "No space left on device (injected)")

        ckpt._atomic_savez = full_disk
    run("save_fails", scan, False, checkpoint_every=2)
    if rank == 0:
        ckpt._atomic_savez = real_savez
    distributed.shutdown()
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)


if __name__ == "__main__":
    main()
