"""Checkpoints and resume of the PyTorch package across processes: two
processes joined by gloo on the CPU, one row of a 2x2 mesh each, started as
subprocesses of tests/torch_dist_ckpt_worker.py on the GT-pose recipe of
tests/test_torch_distributed.py (tests/test_torch_pipeline_mesh.py's LED
scene, two SH1 iterations).  Before they start, this process writes the
checkpoints they resume from (the one-process 2x2 run's, the JAX package's
single-device run's); while they run, it computes the uninterrupted runs.

  (a) a scan stopped at a chunk boundary with a checkpoint, then resumed
      across the two processes, equals the one-process 2x2 run bit for bit
      (volume, trajectory text, keyframe poses), and each process places
      only its own slab of the file's volume;
  (b) the two-process scan_checkpoint.npz equals, array by array, the one
      the one-process 2x2 run writes at the same frame, and the JAX
      package's loader reads it to the same arrays as the port's;
  (c) a refinement checkpointed every iteration, stopped by an exception
      on both processes in iteration 1 and resumed in new pipelines, equals
      the uninterrupted one-process 2x2 run bit for bit (distances, albedo,
      poses, lights, energies, stop, iterations);
  (d) a one-process checkpoint resumes across two processes, and a
      two-process one in one process, each equal to the uninterrupted run;
  (e) the JAX package's single-device checkpoint resumes across the two
      processes within tests/test_torch_pipeline_mesh.py's limits of the
      JAX package's uninterrupted scan (volume 1e-5, grad 2e-4 per unit of
      weight);
  (f) process 0 alone writes the checkpoint files and logs the
      `checkpoint` / `refine_checkpoint` events;
  (g) a checkpoint write made to fail on process 0 raises an error of its
      type and text on both processes, well before the group's timeout.

The runs are computed once a test session: under pytest-xdist the first
worker to need them computes them and the others read its results.
"""

import fcntl
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")      # the dataset builders write PNGs with cv2

from psgradientsdf_tpu.config import parse_config as jparse_config
from psgradientsdf_tpu.io import checkpoint as jckpt
from psgradientsdf_tpu.pipeline import ReconstructionPipeline as JPipeline
from psgradientsdf_tpu_torch.config import parse_config
from psgradientsdf_tpu_torch.io import checkpoint as ckpt
from psgradientsdf_tpu_torch.pipeline import ReconstructionPipeline

from helpers_torch import CPU, t2n
from test_e2e_led_cli import make_led_dataset
import test_torch_distributed as tdist
import test_torch_pipeline_mesh as tpm
import torch_dist_ckpt_worker as ckpt_worker
import torch_dist_worker as worker

torch.set_num_threads(1)

WORKER_SECONDS = 150      # the limit of the workers' wait; they take about 10 s
MESH = {"mesh shape": {"z": 2, "frames": 2}}
CHECKPOINT_FILES = ("scan_checkpoint.npz", "refine_checkpoint.npz")


def _vol(vol):
    return {k: t2n(t).copy() for k, t in zip(vol._fields, vol)}


def _read(path):
    with open(path) as fh:
        return fh.read()


def _compute(tmp):
    """The workers' runs and this process's references -> numpy and paths."""
    tmp.mkdir(parents=True, exist_ok=True)
    led = str(tmp / "led") + "/"
    make_led_dataset(led)
    raw = tpm._raw(led, "", **dict(tpm.REFINE, **MESH))
    # the checkpoints the workers resume from: the one-process 2x2 run's and
    # the JAX package's, both stopped at frame 2
    one_stop = str(tmp / "one_stop") + "/"
    ReconstructionPipeline(parse_config(dict(raw, output=one_stop, last=2),
                                        save_copy=False), device=CPU, prefetch=False,
                           checkpoint_every=2).run(refine=False)
    jax_stop = str(tmp / "jax_stop") + "/"
    JPipeline(jparse_config(tpm._raw(led, jax_stop, last=2), save_copy=False),
              prefetch=False, checkpoint_every=2).run(refine=False)
    job = dict(tmp=str(tmp), raw=raw,
               one_checkpoint=one_stop + "scan_checkpoint.npz",
               jax_checkpoint=jax_stop + "scan_checkpoint.npz")
    t0 = time.perf_counter()
    procs = tdist._start_workers(tmp, job, worker="torch_dist_ckpt_worker.py")
    try:
        # the uninterrupted runs: the one-process 2x2 mesh, the JAX scan
        one_out = str(tmp / "one") + "/"
        pipe = worker.Recorded(parse_config(dict(raw, output=one_out), save_copy=False),
                               device=CPU, prefetch=False)
        summary = pipe.run(refine=True)
        ref = pipe.refiner
        _, dist, albedo, _, _ = ref.gathered(False, False)
        one = dict(scan_vol=_vol(pipe.scan_vol), vol=_vol(pipe.vol),
                   key_poses=np.stack(pipe.key_poses),
                   poses_text=_read(one_out + "tracking_poses.txt"),
                   refined=dict(dist=t2n(dist), albedo=t2n(albedo), poses=t2n(ref.poses),
                                lights=t2n(ref.lights), n=ref.prob.n_surface),
                   summary={k: summary[k] for k in (
                       "refine_iterations", "refine_stop", "refine_energy_trace",
                       "keyframes")})
        jscan = JPipeline(jparse_config(tpm._raw(led, str(tmp / "jax") + "/"),
                                        save_copy=False), prefetch=False)
        jscan.run(refine=False)
        jax_vol = {k: np.asarray(getattr(jscan.vol, k)) for k in ("dist", "grad",
                                                                   "weight", "color")}
    except BaseException:
        tdist._kill(procs)
        raise
    ranks = tdist._join_workers(tmp, procs, t0, seconds=WORKER_SECONDS)
    # a two-process checkpoint resumed in one process
    back_out = str(tmp / "one_resumed") + "/"
    back = ReconstructionPipeline(
        parse_config(dict(raw, output=back_out), save_copy=False), device=CPU,
        prefetch=False,
        resume=ckpt_worker.out_dir(job, "stop", 0) + "scan_checkpoint.npz")
    back.run(refine=False)
    return dict(ranks=ranks, one=one, jax_vol=jax_vol, job=job,
                one_resumed=dict(vol=_vol(back.vol), key_poses=np.stack(back.key_poses),
                                 poses_text=_read(back_out + "tracking_poses.txt")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runs, computed by the first test process that needs them."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return _compute(tmp_path_factory.mktemp("dist_ckpt"))
    root = tmp_path_factory.getbasetemp().parent
    with open(root / "dist_ckpt.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = root / "dist_ckpt.pkl"
        if not done.exists():
            data = _compute(root / "dist_ckpt")
            with open(done, "wb") as fh:
                pickle.dump(data, fh)
        with open(done, "rb") as fh:
            return pickle.load(fh)


def _assert_same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")


def _assert_scan_equal(got, poses_text, one, what):
    _assert_same(got["vol"], one["scan_vol"], f"{what} volume")
    np.testing.assert_array_equal(got["key_poses"], one["key_poses"],
                                  err_msg=f"{what} keyframe poses")
    assert poses_text == one["poses_text"], f"{what} trajectory"


def test_scan_resumed_across_processes_equals_the_one_process_mesh(runs):
    job, one = runs["job"], runs["one"]
    poses_text = _read(ckpt_worker.out_dir(job, "resume", 0) + "tracking_poses.txt")
    for r, res in enumerate(runs["ranks"]):
        got = res["resume"]
        assert "resume" in got["events"]
        _assert_scan_equal(got, poses_text, one, f"rank {r}")
        # the file's volume placed: this process's slab only
        assert got["placed"] == [(16, 32, 32) if k == r else None for k in range(2)]


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_checkpoint_across_processes_is_the_one_process_file(runs):
    job = runs["job"]
    two = ckpt_worker.out_dir(job, "stop", 0) + "scan_checkpoint.npz"
    one = job["one_checkpoint"]
    for suffix in ("", ".scan"):
        a, b = _arrays(two + suffix), _arrays(one + suffix)
        assert list(a) == list(b), suffix
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (suffix, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{suffix} {k}")
    assert json.loads(_read(two + ".json")) == json.loads(_read(one + ".json"))
    # the JAX package reads the two-process file to the port's arrays
    jvol, jgeom, jstate, jimages = jckpt.load_scan_state(two)
    vol, geom, state, images = ckpt.load_scan_state(two, device=CPU)
    for k, t in zip(vol._fields, vol):
        want = t2n(t)
        got = np.asarray(getattr(jvol, k))
        np.testing.assert_array_equal(got.view(want.dtype) if k == "vis" else got,
                                      want, err_msg=k)
    assert tuple(jgeom.dims) == tuple(geom.dims)
    assert jstate.next_frame == state.next_frame == 3
    assert jstate.pose_lines == state.pose_lines
    assert jstate.key_indices == state.key_indices
    np.testing.assert_array_equal(np.stack(jstate.key_poses), np.stack(state.key_poses))
    np.testing.assert_array_equal(np.stack(jimages), np.stack(images))


def test_refinement_resumed_across_processes_equals_the_one_process_mesh(runs):
    one = runs["one"]
    for r, res in enumerate(runs["ranks"]):
        failed = res["refine_fail"]
        assert failed["error"][0] == "RuntimeError" and "injected" in failed["error"][1]
        got = res["refine"]
        assert got["local_rows"] == 1            # one mesh row a process
        s = got["summary"]
        assert s["resumed_refine_iter"] == 1
        for k in ("refine_iterations", "refine_stop", "refine_energy_trace"):
            assert s[k] == one["summary"][k], k
        assert s["refine_iterations"] == 2
        _assert_same(got["refined"], one["refined"], f"rank {r} refined state")
        _assert_same(got["vol"], one["vol"], f"rank {r} refined volume")


@pytest.mark.parametrize("way", ["one_to_two", "two_to_one"])
def test_checkpoints_cross_between_one_and_two_processes(runs, way):
    job, one = runs["job"], runs["one"]
    if way == "one_to_two":
        text = _read(ckpt_worker.out_dir(job, "resume_one", 0) + "tracking_poses.txt")
        for r, res in enumerate(runs["ranks"]):
            _assert_scan_equal(res["resume_one"], text, one, f"rank {r}")
    else:
        got = runs["one_resumed"]
        _assert_scan_equal(got, got["poses_text"], one, "one process")


def test_jax_checkpoint_resumes_across_processes(runs):
    want = runs["jax_vol"]
    for r, res in enumerate(runs["ranks"]):
        vol = res["resume_jax"]["vol"]
        for k in ("dist", "weight", "color"):
            np.testing.assert_allclose(vol[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
        err = np.abs(vol["grad"] - want["grad"]).max(-1)
        assert (err <= 2e-4 * np.maximum(vol["weight"], 1e-3)).all(), r


def test_process_zero_alone_writes_the_checkpoints(runs):
    job = runs["job"]
    w0, w1 = runs["ranks"][0], runs["ranks"][1]
    stop = w0["stop"]["writes"]
    for name in ("scan_checkpoint.npz", "scan_checkpoint.npz.scan",
                 "scan_checkpoint.npz.json"):
        assert name in stop, name
    refine = w0["refine"]["writes"]
    for name in ("refine_checkpoint.npz", "refine_checkpoint.npz.refine",
                 "refine_checkpoint.npz.images", "refine_checkpoint.npz.json"):
        assert name in refine, name
    assert "checkpoint" in w0["stop"]["events"]
    assert "refine_checkpoint" in w0["refine"]["events"]
    for run in ("stop", "resume", "refine_fail", "refine"):
        assert w1[run]["writes"] == [], run
        assert not [e for e in w1[run]["events"]
                    if e in ("checkpoint", "refine_checkpoint")], run
        assert not [f for f in os.listdir(ckpt_worker.out_dir(job, run, 1))
                    if f.startswith(CHECKPOINT_FILES)], run


def test_failed_save_on_process_zero_raises_on_every_process(runs):
    errors = [res["save_fails"]["error"] for res in runs["ranks"]]
    for kind, text, seconds in errors:
        assert kind == "OSError" and "No space left on device (injected)" in text
        assert seconds < ckpt_worker.GROUP_SECONDS / 2, seconds
    assert errors[0][:2] == errors[1][:2]
