"""One process of tests/test_torch_distributed.py: joins a gloo process group
through a file:// rendezvous on the CPU, runs the mesh moves, the process
information, a GT-pose scan with two refinement
iterations on a 2x2 mesh and a tracked scan on a 2x1 mesh, each over the
group, and pickles what it saw for the test to compare.

    python tests/torch_dist_worker.py RANK WORLD RENDEZVOUS JOB.json OUT.pkl

Imports the PyTorch package only (no JAX), one torch thread a process.
"""

import builtins
import json
import os
import pickle
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from psgradientsdf_tpu_torch.config import parse_config  # noqa: E402
from psgradientsdf_tpu_torch.io import ply, sdf_io, trajectory  # noqa: E402
from psgradientsdf_tpu_torch.io.loaders import ImageLoader  # noqa: E402
from psgradientsdf_tpu_torch.parallel import distributed, halo  # noqa: E402
from psgradientsdf_tpu_torch.parallel import mesh as pm  # noqa: E402
import psgradientsdf_tpu_torch.pipeline as pipeline_mod  # noqa: E402
import psgradientsdf_tpu_torch.refine.optimizer as optimizer_mod  # noqa: E402

CPU = "cpu"


def move_inputs(seed=7):
    """The moves' inputs, the same on every process and in the test: four
    shards (mesh rows of a 4x1 mesh)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return dict(small=[f(5, 3) for _ in range(4)], chunks=[f(6, 2) for _ in range(4)],
                partials=[f(24, 2) for _ in range(4)], slabs=[f(3, 4, 4) for _ in range(4)],
                flags=[torch.tensor(k % 2, dtype=torch.int32) for k in range(4)])


def run_moves(mesh, inp):
    """Every move on `mesh` (4x1) with the pieces this process holds; the
    others' are the mesh's Remote entries -> {name: result}."""
    devs = mesh.slab_devices
    mine = lambda xs: [d if pm.is_remote(d) else x for x, d in zip(xs, devs)]
    bounds = [0, 6, 12, 18, 24]
    out = {}
    out["reduce"] = pm.reduce_to_first(mine(inp["small"]))
    out["reduce_flags"] = pm.reduce_to_first(mine(inp["flags"])) > 0
    out["reduce_to_row2"] = pm.reduce_to_first(mine(inp["small"]), dest=devs[2])
    # pieces on the first two shards only: over processes the second
    # process holds none of them
    out["reduce_first_two"] = pm.reduce_to_first(mine(inp["small"])[:2])
    out["all_gather"] = pm.all_gather(mine(inp["chunks"]), devs)
    out["reduce_scatter"] = pm.reduce_scatter(mine(inp["partials"]), bounds, devs)
    out["reduce_scatter_first_two"] = pm.reduce_scatter(
        mine(inp["partials"])[:2], bounds, devs)
    out["halo"] = halo.exchange_z_halo(mine(inp["slabs"]))
    out["padded"] = halo.padded_slab(mine(inp["slabs"]), fill=-1.0)
    return out


def to_numpy(x):
    if pm.is_remote(x):
        return x
    if isinstance(x, torch.Tensor):
        return x.numpy().copy()
    if isinstance(x, dict):
        return {str(k): to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_numpy(v) for v in x]
    return x


class MemoryLoader(ImageLoader):
    """Frames from an npz in the wire format (colors uint8, depths uint16)."""

    def __init__(self, path):
        super().__init__("")
        z = np.load(path)
        self.K, self.unit = z["K"].astype(np.float32), float(z["unit"])
        self._colors, self._depths = z["colors"], z["depths"]

    def load_intrinsics(self, filename="intrinsics.txt"):
        return True

    def load_pose(self, filename):
        return None

    def reset(self):
        pass

    def frame_paths(self, idx):
        if idx >= len(self._colors):
            return None
        ts = f"{1000.0 + 0.1 * idx:.4f}"
        return "", "", ts, ts

    def read_frame(self, idx, raw=False):
        if idx >= len(self._colors):
            return None
        ts = f"{1000.0 + 0.1 * idx:.4f}"
        color, depth = self._colors[idx], self._depths[idx]
        if not raw:
            color = color.astype(np.float32) / 255.0
            depth = depth.astype(np.float32) * self.unit
        return color, depth, ts, ts


class Recorded(pipeline_mod.ReconstructionPipeline):
    """Keeps the scan's volume: run() replaces it with the refined one."""

    def _run_refine_phase(self, summary):
        self.scan_vol = self.vol.clone()
        super()._run_refine_phase(summary)


def record_writes(out_dir):
    """Every file this process writes under out_dir, and the writer threads
    it starts -> the list they are appended to."""
    seen = []
    real_open = builtins.open

    def spy_open(path, mode="r", *a, **k):
        if any(c in mode for c in "wax") and str(path).startswith(out_dir):
            seen.append(("open", os.path.basename(str(path))))
        return real_open(path, mode, *a, **k)

    builtins.open = spy_open
    for mod, names in ((ply, ("write_mesh_ply", "write_pointcloud_ply")),
                       (sdf_io, ("write_sdf",)), (trajectory, ("write_trajectory",))):
        for name in names:
            fn = getattr(mod, name)

            def spy(path, *a, _fn=fn, _name=name, **k):
                seen.append((_name, os.path.basename(str(path))))
                return _fn(path, *a, **k)

            setattr(mod, name, spy)
    for mod in (pipeline_mod, optimizer_mod):
        real = mod.Writer

        class Spied(real):
            def __init__(self, *a, **k):
                seen.append(("writer_thread", k.get("name", "")))
                super().__init__(*a, **k)

        mod.Writer = Spied
    return seen


def volume(vol):
    return {k: t.numpy().copy() for k, t in zip(vol._fields, vol)}


def main():
    rank, world, rdv, job_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    with open(job_path) as fh:
        job = json.load(fh)
    distributed.initialize(num_processes=world, process_id=rank,
                           init_method="file://" + rdv, device=CPU, timeout=60)
    res = {"backend": distributed.backend()}

    # (d) the process information and the Z rows each process owns
    res["info"] = distributed.process_info()
    m22 = distributed.make_global_mesh(2, 2, devices=[CPU, CPU])
    m41 = distributed.make_global_mesh(4, 1, devices=[CPU, CPU])
    res["slices"] = {"2x2": distributed.host_local_slice(32, m22),
                     "4x1": distributed.host_local_slice(32, m41)}
    res["remote"] = [[pm.is_remote(d) for d in row] for row in m22.devices]

    # (a) the moves on a 4x1 mesh, two shards a process
    pm.reset_reduce_counts()
    res["moves"] = to_numpy(run_moves(m41, move_inputs()))
    res["move_counts"] = dict(pm.reduce_counts)

    # (b) a GT-pose scan and two refinement iterations on a 2x2 mesh
    out = job["refine_out"]
    seen = record_writes(out)
    pipe = Recorded(parse_config(job["refine_raw"], save_copy=False), device=CPU,
                    prefetch=False)
    pm.reset_reduce_counts()
    summary = pipe.run(refine=True)
    ref = pipe.refiner
    _, dist, albedo, _, _ = ref.gathered(False, False)
    res["refine"] = dict(
        scan_vol=volume(pipe.scan_vol), vol=volume(pipe.vol),
        dist=dist.numpy().copy(), albedo=albedo.numpy().copy(),
        poses=ref.poses.numpy().copy(), lights=ref.lights.numpy().copy(),
        n=ref.prob.n_surface, rows=len(ref.prob.rows),
        local_rows=sum(not pm.is_remote(r) for r in ref.prob.rows),
        counts=dict(pm.reduce_counts), writes=list(seen),
        summary={k: v for k, v in summary.items()
                 if k not in ("refine_peak_memory_bytes", "refine_seconds", "seconds",
                              "fps")})
    seen.clear()

    # (c) a tracked scan on a 2x1 mesh
    pipe = pipeline_mod.ReconstructionPipeline(
        parse_config(job["tracked_raw"], save_copy=False), device=CPU,
        loader=MemoryLoader(job["tracked_frames"]))
    summary = pipe.run(refine=False)
    res["tracked"] = dict(vol=volume(pipe.vol), track_log=[
        {k: r[k] for k in ("converged", "iters", "energy", "valid")}
        for r in summary["track_log"]])
    distributed.shutdown()
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)


if __name__ == "__main__":
    main()
