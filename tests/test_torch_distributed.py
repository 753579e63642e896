"""The PyTorch package's mesh over processes (parallel/distributed.py): two
processes joined by gloo on the CPU through a file:// rendezvous, each
holding one half of the mesh, started as subprocesses of
tests/torch_dist_worker.py (as tests/test_distributed.py starts the JAX
package's).  While they run, this process computes the one-process mesh of
the same shape and the JAX package's single-device pipeline on the same
inputs.

  (a) the moves (reduce_to_first onto every process and onto one row,
      all_gather, reduce_scatter, the halos), two shards a process, equal
      the one-process mesh's bit for bit, also where one process holds no
      piece, and count the same;
  (b) a GT-pose scan and two SH1 refinement iterations on a 2x2 mesh, one
      row a process, equal the one-process 2x2 run bit for bit (volume,
      poses, lights, distances, energies), and stay within the JAX
      package's single-device pipeline as tests/test_torch_pipeline_mesh.py
      holds the one-process mesh (volume 1e-5, grad 2e-4 per unit of
      weight, refined distances, poses and lights 2e-4, energies rtol
      1e-3); process 0 alone writes the output files;
  (c) a tracked scan on a 2x1 mesh equals the one-process 2x1 scan bit for
      bit;
  (d) host_local_slice and process_info follow the JAX module's
      definitions for the same layout.

Checkpoints and resume across processes: tests/test_torch_distributed_checkpoint.py.
"""

import json
import os
import pickle
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")      # the dataset builders write PNGs with cv2

from psgradientsdf_tpu.config import parse_config as jparse_config
from psgradientsdf_tpu.parallel import distributed as jdist
from psgradientsdf_tpu.pipeline import ReconstructionPipeline as JPipeline
from psgradientsdf_tpu_torch.config import parse_config
from psgradientsdf_tpu_torch.parallel import distributed
from psgradientsdf_tpu_torch.parallel import mesh as pm
from psgradientsdf_tpu_torch.pipeline import ReconstructionPipeline

from helpers_torch import CPU, t2n
from test_e2e_led_cli import make_led_dataset
import test_torch_pipeline_mesh as tpm
import test_torch_stream_pipeline as tsp
import torch_dist_worker as worker

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
WORKER_SECONDS = 120      # the limit of the workers' wait; they take about 30 s


def _tracked_raw(out):
    """tests/test_torch_pipeline_mesh.py's tracked scan, on a 2x1 mesh."""
    return {"input": "", "output": out, "datatype": "tum", "first": 0,
            "last": 1, "voxel size": 0.02, "truncation factor": 5,
            "zmin": 0.1, "zmax": 5.0, "sharpness threshold": 0.0,
            "grid dim": 64, "chunk size": 2, "fuse rows": 0.5,
            "mesh shape": {"z": 2, "frames": 1}}


def _tracked_frames(path):
    scene = tsp._build_scene()
    K = scene["K"]
    fr0 = tsp.wavy_frame(tsp.H, tsp.W, K)
    colors = np.concatenate([np.clip(fr0["color"][None] * 255, 0, 255).astype(np.uint8),
                             scene["colors"]])[:2]
    depths = np.concatenate([np.clip(fr0["depth"][None] / tsp.UNIT, 0, 65535)
                             .astype(np.uint16), scene["depths"]])[:2]
    np.savez(path, K=K, colors=colors, depths=depths, unit=tsp.UNIT)


def _start_workers(tmp, job, worker="torch_dist_worker.py"):
    """WORLD processes of tests/<worker> on `job`, each logging to
    tmp/rank<r>.log and pickling its results to tmp/rank<r>.pkl."""
    job_path = str(tmp / "job.json")
    with open(job_path, "w") as fh:
        json.dump(job, fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]),
               OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        log = open(str(tmp / f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", worker),
             str(r), str(WORLD), str(tmp / "rendezvous"), job_path,
             str(tmp / f"rank{r}.pkl")],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT), log))
    return procs


def _kill(procs):
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def _join_workers(tmp, procs, t0, seconds=WORKER_SECONDS):
    results = []
    try:
        for r, (p, log) in enumerate(procs):
            rc = p.wait(timeout=max(1.0, seconds - (time.perf_counter() - t0)))
            log.close()
            with open(str(tmp / f"rank{r}.log")) as fh:
                text = fh.read()
            assert rc == 0, f"rank {r} exited {rc}:\n{text[-3000:]}"
            with open(str(tmp / f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    finally:
        _kill(procs)
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two processes' results, and this process's references."""
    tmp = tmp_path_factory.mktemp("dist")
    led = str(tmp / "led") + "/"
    make_led_dataset(led)
    _tracked_frames(str(tmp / "tracked.npz"))
    refine_kw = dict(tpm.REFINE, **{"mesh shape": {"z": 2, "frames": 2}})
    job = dict(tmp=str(tmp), refine_out=str(tmp / "dist_refine") + "/",
               refine_raw=tpm._raw(led, str(tmp / "dist_refine") + "/", **refine_kw),
               tracked_raw=_tracked_raw(str(tmp / "dist_tracked") + "/"),
               tracked_frames=str(tmp / "tracked.npz"))
    t0 = time.perf_counter()
    procs = _start_workers(tmp, job)
    try:
        # the one-process meshes of the same shapes, and the JAX package
        pipe = worker.Recorded(parse_config(tpm._raw(led, str(tmp / "one") + "/", **refine_kw),
                                      save_copy=False), device=CPU, prefetch=False)
        pm.reset_reduce_counts()
        summary = pipe.run(refine=True)
        counts = dict(pm.reduce_counts)
        one = dict(pipe=pipe, summary=summary, counts=counts)
        tpipe = ReconstructionPipeline(
            parse_config(_tracked_raw(str(tmp / "one_tracked") + "/"), save_copy=False),
            device=CPU, loader=worker.MemoryLoader(str(tmp / "tracked.npz")))
        tsummary = tpipe.run(refine=False)
        jscan = JPipeline(jparse_config(tpm._raw(led, str(tmp / "jax_scan") + "/"),
                                        save_copy=False), prefetch=False)
        jscan.run(refine=False)
        jpipe = JPipeline(jparse_config(tpm._raw(led, str(tmp / "jax") + "/", **tpm.REFINE),
                                        save_copy=False), prefetch=False)
        jsummary = jpipe.run(refine=True)
    except BaseException:
        _kill(procs)
        raise
    results = _join_workers(tmp, procs, t0)
    return dict(ranks=results, one=one, tracked=(tpipe, tsummary),
                jax=(jscan, jpipe, jsummary), out=job["refine_out"])


def _assert_same(a, b, what):
    for k in b:
        np.testing.assert_array_equal(a[k], t2n(b[k]), err_msg=f"{what}: {k}")


def test_moves_over_processes_equal_the_one_process_mesh(runs):
    inp = worker.move_inputs()
    pm.reset_reduce_counts()
    want = worker.to_numpy(worker.run_moves(pm.make_mesh(4, 1, device=CPU), inp))
    want_counts = dict(pm.reduce_counts)
    for r, got in enumerate(runs["ranks"]):
        assert got["backend"] == "gloo"
        g = got["moves"]
        own = [2 * r, 2 * r + 1]                 # the shards process r holds
        for name in ("reduce", "reduce_flags", "reduce_first_two"):
            np.testing.assert_array_equal(g[name], want[name], err_msg=name)
        if r == 1:
            np.testing.assert_array_equal(g["reduce_to_row2"], want["reduce_to_row2"])
        else:
            assert g["reduce_to_row2"] == pm.Remote(1)
        np.testing.assert_array_equal(g["all_gather"]["cpu"], want["all_gather"]["cpu"])
        for name in ("reduce_scatter", "reduce_scatter_first_two", "padded"):
            for k in range(4):
                if k in own:
                    np.testing.assert_array_equal(g[name][k], want[name][k],
                                                  err_msg=f"{name}[{k}]")
                else:
                    assert g[name][k] == pm.Remote(1 - r), (name, k)
        for k in own:
            for side in (0, 1):
                np.testing.assert_array_equal(g["halo"][k][side], want["halo"][k][side])
        assert got["move_counts"] == want_counts


def test_scan_and_refinement_over_processes_equal_the_one_process_mesh(runs):
    one = runs["one"]
    pipe, summary = one["pipe"], one["summary"]
    ref = pipe.refiner
    _, dist, albedo, _, _ = ref.gathered(False, False)
    for r, got in enumerate(runs["ranks"]):
        g = got["refine"]
        assert g["rows"] == 2 and g["local_rows"] == 1     # one mesh row a process
        _assert_same(g["scan_vol"], pipe.scan_vol._asdict(), "scan volume")
        _assert_same(g["vol"], pipe.vol._asdict(), "refined volume")
        np.testing.assert_array_equal(g["dist"], t2n(dist))
        np.testing.assert_array_equal(g["albedo"], t2n(albedo))
        np.testing.assert_array_equal(g["poses"], t2n(ref.poses))
        np.testing.assert_array_equal(g["lights"], t2n(ref.lights))
        assert g["n"] == ref.prob.n_surface
        s = g["summary"]
        assert s["refine_iterations"] == summary["refine_iterations"] == 2
        assert s["refine_stop"] == summary["refine_stop"]
        assert s["frames"] == summary["frames"] and s["keyframes"] == summary["keyframes"]
        assert s["refine_energy_trace"] == summary["refine_energy_trace"]
        assert g["counts"] == one["counts"]


def test_scan_and_refinement_over_processes_follow_the_jax_package(runs):
    jscan, jpipe, jsummary = runs["jax"]
    g = runs["ranks"][0]["refine"]
    vol = g["scan_vol"]
    for k in ("dist", "weight", "color"):
        np.testing.assert_allclose(vol[k], np.asarray(getattr(jscan.vol, k)),
                                   rtol=0, atol=1e-5, err_msg=k)
    err = np.abs(vol["grad"] - np.asarray(jscan.vol.grad)).max(-1)
    assert (err <= 2e-4 * np.maximum(vol["weight"], 1e-3)).all()
    jref = jpipe.refiner
    n = int(jref.prob.n_surface)
    assert g["n"] == n
    np.testing.assert_allclose(g["dist"][:n], np.asarray(jref.dist)[:n], rtol=0, atol=2e-4)
    np.testing.assert_allclose(g["poses"], np.asarray(jref.poses), rtol=0, atol=2e-4)
    np.testing.assert_allclose(g["lights"], np.asarray(jref.lights), rtol=0, atol=2e-4)
    # the JAX package logs its energies and iterations to metrics.jsonl
    with open(os.path.join(jpipe.cfg.tracking.output, "metrics.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    s = g["summary"]
    assert s["refine_iterations"] == len(
        [e for e in events if e["event"] == "iteration"]) == 2
    np.testing.assert_allclose([e["total"] for e in s["refine_energy_trace"]],
                               [e["total"] for e in events if e["event"] == "energy"],
                               rtol=1e-3)


def test_process_zero_alone_writes_the_outputs(runs):
    w0 = runs["ranks"][0]["refine"]["writes"]
    w1 = runs["ranks"][1]["refine"]["writes"]
    assert w1 == []
    names = {name for _, name in w0}
    for f in ("tracking_poses.txt", "init_mesh.ply", "init_pointcloud.ply",
              "init_sdf.sdf", "final_refined_mesh.ply", "final_refined_pointcloud.ply",
              "final_refined_poses.txt", "final_refined_sdf.sdf"):
        assert f in names, f
        assert os.path.exists(os.path.join(runs["out"], f)), f
    assert ("writer_thread", "initial-export") in w0


def test_tracked_scan_over_processes_equals_the_one_process_mesh(runs):
    tpipe, tsummary = runs["tracked"]
    want_log = [{k: r[k] for k in ("converged", "iters", "energy", "valid")}
                for r in tsummary["track_log"]]
    assert want_log and all(r["converged"] for r in want_log)
    for got in runs["ranks"]:
        _assert_same(got["tracked"]["vol"], tpipe.vol._asdict(), "tracked volume")
        assert got["tracked"]["track_log"] == want_log


def test_process_layout_follows_the_jax_module(runs, monkeypatch):
    """host_local_slice and process_info against the JAX module's
    definitions, evaluated on the same layout: two processes of two
    entries each, as a JAX mesh of devices tagged with their process."""
    for r, got in enumerate(runs["ranks"]):
        assert got["info"] == dict(process_index=r, process_count=WORLD,
                                   local_devices=1, global_devices=WORLD)
        for shape, (nz, nf) in (("2x2", (2, 2)), ("4x1", (4, 1))):
            devs = np.array([[types.SimpleNamespace(process_index=(i * nf + j) // 2)
                              for j in range(nf)] for i in range(nz)], dtype=object)
            jmesh = types.SimpleNamespace(devices=devs, shape={"z": nz, "frames": nf})
            monkeypatch.setattr(jdist.jax, "process_index", lambda _r=r: _r)
            assert got["slices"][shape] == jdist.host_local_slice(32, jmesh), shape
        assert got["remote"] == [[r != 0, r != 0], [r != 1, r != 1]]
    # one process outside a group: the JAX module's single-process values
    info = distributed.process_info()
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["local_devices"] == info["global_devices"] >= 1
    whole = pm.make_mesh(4, 1, device=CPU)
    assert distributed.host_local_slice(32, whole) == slice(0, 32)
