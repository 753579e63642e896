"""The fused refinement loop's one read of the device an iteration
(refine/optimizer.py iteration_readout / _fused_step, the path the card's
CUDA graph replays, refine/graph.py): the read counted on the CPU, the loop
against the per-block loop and the JAX package's fused loop, the pose
solve's deferred status, and the graph's replay arithmetic of launch
counts.  The graph itself needs the card (chip_smoke.py `refine_graph`)."""

import json
import types

import numpy as np
import pytest
import torch

import helpers_torch as ht
from psgradientsdf_tpu.utils import robust
from psgradientsdf_tpu.utils.metrics import MetricsLogger as JLogger
from psgradientsdf_tpu_torch.ops import normaleq, residual, smallsolve
from psgradientsdf_tpu_torch.refine import graph
from psgradientsdf_tpu_torch.refine import optimizer as topt
from psgradientsdf_tpu_torch.refine import solvers as tsolvers

torch.set_num_threads(1)

BASE = dict(max_it=4, conv_threshold=1e-6, damping=1.0, lam=0.2, reg_weight_n=1.0,
            reg_weight_l=0.0, reg_weight_rho=0.0, order=1, upsample=False,
            model="SH1", loss=robust.CAUCHY)
SMALL = dict(dim=32, h=0.04, H=48, W=48, f=45.0)
# SH1, SH2, and the LED recipe's weights over the iteration-5 upsample
RUNS = {
    "SH1": dict(model="SH1", max_it=4),
    "SH2": dict(model="SH2", order=2, max_it=3),
    "LED_upsample": dict(model="LED", max_it=7, upsample=True, damping=3.0,
                         reg_weight_n=0.1, reg_weight_l=5.0, conv_threshold=0.0),
}


def _scene(kw):
    return ht.refine_scene(model=kw["model"], order=kw.get("order", 1), n_poses=2, **SMALL)


def _refiner(sc, **kw):
    from psgradientsdf_tpu_torch.config import OptimizerConfig
    from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

    ref = topt.PhotometricRefiner(
        sc["tvol"], sc["tg"], OptimizerConfig(**dict(BASE, **kw)), sc["K"],
        truncation=sc["truncation"], metrics=MetricsLogger(None, echo=False))
    ref.set_keyframes(sc["images"], sc["poses"], sc["frame_ids"])
    ref.init()
    return ref


class _Recorder:
    """A MetricsLogger that keeps its records."""

    def __init__(self):
        self.records = []

    def log(self, event, **fields):
        self.records.append(dict(event=event, **fields))
        return self.records[-1]


@pytest.mark.parametrize("name", list(RUNS))
def test_fused_loop_reads_the_device_once_an_iteration(name, monkeypatch):
    """Every fused iteration makes exactly one Tensor.tolist / Tensor.item
    call, the readout of iteration_readout, and the loop none besides (the
    upsample's energy read aside)."""
    kw = RUNS[name]
    ref = _refiner(_scene(kw), **kw)
    ref.metrics = _Recorder()
    reads = {"n": 0}
    for meth in ("tolist", "item"):
        real = getattr(torch.Tensor, meth)

        def counted(self, *a, _real=real, **k):
            reads["n"] += 1
            return _real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, meth, counted)
    per_step, real_step = [], topt._fused_step

    def step(*a, **k):
        n0 = reads["n"]
        out = real_step(*a, **k)
        per_step.append(reads["n"] - n0)
        return out

    monkeypatch.setattr(topt, "_fused_step", step)
    real_loop = ref._alternating_loop
    in_loop = {}

    def loop(*a, **k):
        n0 = reads["n"]
        try:
            return real_loop(*a, **k)
        finally:
            in_loop["n"] = reads["n"] - n0
    monkeypatch.setattr(ref, "_alternating_loop", loop)
    # the upsample extracts a new problem, which reads its own sizes
    real_up, up = ref._upsample, {"n": 0}

    def upsample():
        n0 = reads["n"]
        real_up()
        up["n"] += reads["n"] - n0
    monkeypatch.setattr(ref, "_upsample", upsample)
    ref.alternating_optimize(True, True, True, True)
    upsampled = sum(1 for r in ref.energy_trace if r["block"] == "upsample")
    assert per_step == [1] * ref.iterations_run and ref.iterations_run >= 3
    assert in_loop["n"] - up["n"] == ref.iterations_run + upsampled
    loops = [r for r in ref.metrics.records if r["event"] == "refine_loop"]
    assert len(loops) == 1 and loops[0]["loop"] == "eager"
    assert "cpu" in loops[0]["reason"]
    # the JAX package's bookkeeping: an iteration's seconds split evenly
    its = [r for r in ref.metrics.records if r["event"] == "iteration"]
    blocks = [r for r in ref.metrics.records if r["event"] == "block"]
    for it in its:
        mine = [b["seconds"] for b in blocks if b["iter"] == it["iter"]]
        assert len(set(mine)) == 1 and abs(sum(mine) - it["seconds"]) < 1e-9


def _j_trace(path):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    return ([(r["ps"], r["total"]) for r in recs if r["event"] == "energy"],
            [r["event"] for r in recs if r["event"] in
             ("converged", "diverged", "budget_exhausted")])


@pytest.mark.parametrize("name", list(RUNS))
def test_fused_loop_matches_per_block_and_jax_fused_loop(name, tmp_path):
    """The one-read fused loop against the per-block loop: the same energy
    trace, stop and iterations, every state tensor bit for bit; against the
    JAX package's fused loop (its _iteration_update) from identical state:
    the same stop and iterations, energies within 1e-3 (float32 sums in
    another order, as test_torch_refine_optimizer's whole runs)."""
    kw = RUNS[name]
    sc = _scene(kw)
    out = {}
    for fused in (True, False):
        ref = _refiner(sc, **kw, fused_iterations=fused)
        ok = ref.alternating_optimize(True, True, True, True)
        out[fused] = (ok, ref.stop_reason, ref.iterations_run, ref._state(), ref.energy_trace)
    f, b = out[True], out[False]
    assert f[:3] == b[:3]
    for x, y in zip(f[3], b[3]):
        assert torch.equal(x, y)
    assert f[4] == b[4]

    jref, tref = ht.refiner_pair(sc, **dict(BASE, **kw))
    assert jref.fused_iterations and tref.fused_iterations
    jref.metrics = JLogger(str(tmp_path / "j.jsonl"), echo=False)
    jok = jref.alternating_optimize(True, True, True, True)
    tok = tref.alternating_optimize(True, True, True, True)
    jtrace, jstop = _j_trace(str(tmp_path / "j.jsonl"))
    ttrace = [(r["ps"], r["total"]) for r in tref.energy_trace]
    assert tref.energy_trace == f[4]
    assert (tok, [tref.stop_reason]) == (jok, jstop) and len(ttrace) == len(jtrace)
    np.testing.assert_allclose(ttrace, jtrace, rtol=1e-3, atol=1e-5 * jtrace[0][1])


def _singular_pose(monkeypatch, frame):
    """pose_normal_eqs with keyframe `frame`'s H set so that the damped,
    jittered matrix is exactly 0 (damping 1: H = -5e-9 I)."""
    real = normaleq.pose_normal_eqs

    def bad(*a, **k):
        H, g = real(*a, **k)
        H = H.clone()
        H[frame] = -5e-9 * torch.eye(6)
        return H, g
    monkeypatch.setattr(normaleq, "pose_normal_eqs", bad)


def test_pose_solve_ex_gives_solve_bits():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(12, 6, 6)).astype(np.float32)
    H = torch.from_numpy(np.einsum("fij,fkj->fik", A, A))
    g = torch.from_numpy(rng.normal(size=(12, 6)).astype(np.float32))
    got = tsolvers.solve_pose_from_normal_eqs(H, g, 1.0)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    Hd = H + torch.diag_embed(1.0 * diag) + 1e-8 * torch.eye(6)
    want = torch.linalg.solve(Hd, g[..., None])[..., 0]
    assert torch.equal(got, want)
    info = []
    assert torch.equal(tsolvers.solve_pose_from_normal_eqs(H, g, 1.0, info_out=info), want)
    assert info[0].dtype == torch.int32 and not info[0].any()


def test_singular_pose_block_raises_as_solve_does():
    H = torch.eye(6).repeat(3, 1, 1)
    H[1] = -5e-9 * torch.eye(6)
    g = torch.ones(3, 6)
    Hd = H + torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-8 * torch.eye(6)
    with pytest.raises(torch.linalg.LinAlgError) as want:
        torch.linalg.solve(Hd, g[..., None])
    with pytest.raises(torch.linalg.LinAlgError) as got:
        tsolvers.solve_pose_from_normal_eqs(H, g, 1.0)
    assert str(got.value) == str(want.value)
    info = []
    tsolvers.solve_pose_from_normal_eqs(H, g, 1.0, info_out=info)   # deferred
    assert info[0].tolist() == [0, 1, 0]
    with pytest.raises(torch.linalg.LinAlgError) as later:
        tsolvers.check_pose_info(info[0].tolist())
    assert str(later.value) == str(want.value)


@pytest.mark.parametrize("fused", [True, False])
def test_singular_pose_block_in_the_loop_raises_and_commits_nothing(fused, monkeypatch):
    kw = RUNS["SH1"]
    ref = _refiner(_scene(kw), **kw, fused_iterations=fused)
    ref.init_albedo()
    _singular_pose(monkeypatch, 1)
    state = [t.clone() for t in ref._state()]
    with pytest.raises(torch.linalg.LinAlgError, match="Batch element 1"):
        ref._alternating_loop(True, True, True, True, 1.0, 1.0, 0.0, 0.0, 0.0, 1.0,
                              1.0, 0.0, 0.0, True, False, False, rd=None)
    if fused:
        # the read comes first, then the raise: nothing of the iteration is
        # committed or booked
        assert ref.energy_trace == []
        for a, b in zip(ref._state(), state):
            assert torch.equal(a, b)


def test_readout_layout():
    e = [torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.tensor([5.0, 6.0, 7.0, 8.0])]
    steps = [torch.tensor(12, dtype=torch.int64), None]
    info = torch.tensor([0, 0, 3], dtype=torch.int32)
    v = graph.pack(e, steps, info)
    assert v.dtype == torch.float64 and v.shape == (2 * graph.BLOCK_SLOTS + 3,)
    energies, cg, status = graph.unpack(v.tolist(), 2)
    assert energies == [[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]]
    assert cg == [12, None] and status == [0, 0, 3]
    empty = graph.pack([], [], None)
    assert empty.shape == (0,) and graph.unpack([], 0) == ([], [], [])


def test_replay_adds_the_captured_launch_counts():
    """A capture counts each wrapper's launches once (its Python runs once);
    every replay adds that difference to every counter, the kernels' and a
    registered caller's, and the counts as they stood before the capture
    are restored: after k replays each count is k times the iteration's."""
    mine = {"passes": 0}
    residual.reset_launch_counts()
    smallsolve.reset_launch_counts()
    with graph.registered(mine):
        snap = graph._snapshot()
        # what a capture of one SH1 iteration's calls adds
        residual.launch_counts["residual_pass"] += 5
        residual.launch_counts["dist_jacobian"] += 1
        smallsolve.launch_counts["light_solve"] += 1
        mine["passes"] += 5
        diff = graph._difference(snap)
        graph._restore(snap)
        assert residual.launch_counts["residual_pass"] == 0 and mine["passes"] == 0
        g = graph.IterationGraph.__new__(graph.IterationGraph)
        g.device, g.counts, g._after = -1, diff, []
        g.readout = torch.arange(3, dtype=torch.float64)
        replays = []
        g.graph = types.SimpleNamespace(replay=lambda: replays.append(1))
        after = []
        g._after.append(lambda: after.append(len(replays)))
        for _ in range(3):
            assert g.replay() == [0.0, 1.0, 2.0]
    assert replays == [1, 1, 1] and after == [1, 2, 3]
    assert residual.launch_counts == {"residual_pass": 15, "dist_jacobian": 3}
    assert smallsolve.launch_counts["light_solve"] == 3 and mine["passes"] == 15
    assert all(c is not mine for c in graph.counters())
    residual.reset_launch_counts()
    smallsolve.reset_launch_counts()


def test_no_graph_off_the_card():
    kw = RUNS["SH1"]
    ref = _refiner(_scene(kw), **kw)
    with pytest.raises(ValueError, match="needs a card"):
        graph.IterationGraph(lambda s: (s, None, None), ref._state(), key=0)
    assert ref.loop_kind()[0] == "eager" and ref.capture
    off = _refiner(_scene(kw), **kw, fused_iterations=False)
    assert off.loop_kind() == ("eager", "fused_iterations is off: the per-block loop")
    with pytest.raises(RuntimeError, match="no iteration is being captured"):
        graph.after_replay(lambda: None)
    assert not graph.warming()
