"""ops/gn.gn_solve of the PyTorch package on the CPU, where it runs its plain
version (gn_solve_plain: the round loop over gn_step_plain, the done flag
read back before every round as the JAX while_loop tests it).

On the fused 64^3 scene of tests/test_torch_tracker.py (72x96 depth):
  * gn_solve equals tracker.run_gn_rounds_plain, and the mesh trackers'
    round loop (tracker.run_gn_rounds) over the same plain records and
    Gram, bit for bit, on the SoA and the packed volume, for the four named
    tracker configurations;
  * it matches the JAX package's track_frame (run on the CPU) from the far
    initial pose: iterations, converged flag and valid pixels equal, pose
    within 1e-5, energy within rtol 1e-4 (tests/test_torch_tracker.py's
    tolerances: the Gram is reduced in another order);
  * num_iterations=1 is one step: its S is the plain Gram at the initial
    pose, exactly;
  * a malformed carry or a solve with no fresh step raises; a done carry is
    left as it is; a CPU call launches nothing.
"""

import jax.numpy as jnp
import pytest
import torch

from psgradientsdf_tpu.tracking import configs as jconfigs
from psgradientsdf_tpu.tracking import tracker as jtracker
from psgradientsdf_tpu_torch.core import volume as tvolume
from psgradientsdf_tpu_torch.ops import gn as tgn
from psgradientsdf_tpu_torch.tracking import configs as tconfigs
from psgradientsdf_tpu_torch.tracking import tracker as ttracker

from helpers_torch import CPU, gn_rounds_over_plain_callables, se3_exp_np
from test_torch_tracker import INITS, ZKW, _assert_same
from test_torch_tracker import scene  # noqa: F401 (fixture)

torch.set_num_threads(1)

CONFIGS = ("REFERENCE", "STREAMING", "PARITY", "STREAMING_FAST")


def _frame(sc, vol=None):
    return tgn.GnFrame(sc["tg"], torch.from_numpy(sc["depth"]),
                       torch.from_numpy(sc["K"]), stride=1,
                       vol=sc["tv"] if vol is None else vol,
                       zmin=ZKW["zmin"], zmax=ZKW["zmax"])


def _solve_kw(config):
    kw = dict(getattr(tconfigs, config))
    del kw["stride"]
    return kw


def _result(carry):
    pose, conv, fail, _, E_mean, count, iters, _ = tgn.unpack_carry(carry)
    return ttracker.TrackResult(pose=pose, converged=conv & (~fail),
                                iterations=iters, energy=E_mean, num_valid=count)


@pytest.mark.parametrize("layout", ["soa", "packed"])
@pytest.mark.parametrize("config", CONFIGS)
def test_gn_solve_equals_run_gn_rounds_plain_bit_for_bit(scene, config, layout):
    vol = scene["tv"]
    if layout == "packed":
        vol = tvolume.PackedVolume.from_volume(vol)
    init = se3_exp_np(INITS["far"])
    carry = tgn.new_carry(torch.from_numpy(init).to(torch.float32))
    tgn.gn_solve(_frame(scene, vol), carry, **_solve_kw(config))
    kw = dict(device=CPU, **ZKW, **getattr(tconfigs, config))
    want = ttracker.run_gn_rounds_plain(
        scene["tv"], scene["tg"], scene["depth"], scene["K"], init, **kw)
    rounds = gn_rounds_over_plain_callables(
        scene["tv"], scene["tg"], scene["depth"], scene["K"], init, **kw)
    for a, b, c in zip(_result(carry), want, rounds):
        assert a.dtype == b.dtype and torch.equal(a, b), (config, layout)
        assert a.dtype == c.dtype and torch.equal(a, c), (config, layout)


@pytest.mark.parametrize("config", CONFIGS)
def test_gn_solve_matches_jax_track_frame_from_the_far_pose(scene, config):
    init = se3_exp_np(INITS["far"])
    a = jtracker.track_frame(scene["jv"], scene["jg"], jnp.asarray(scene["depth"]),
                             jnp.asarray(scene["K"]), jnp.asarray(init),
                             **ZKW, **getattr(jconfigs, config))
    carry = tgn.new_carry(torch.from_numpy(init).to(torch.float32))
    tgn.gn_solve(_frame(scene), carry, **_solve_kw(config))
    _assert_same(a, _result(carry))


@pytest.mark.parametrize("init", sorted(INITS))
def test_one_iteration_is_one_plain_step(scene, init):
    frame = _frame(scene)
    pose = torch.from_numpy(se3_exp_np(INITS[init])).to(torch.float32)
    carry = tgn.new_carry(pose)
    tgn.gn_solve(frame, carry, num_iterations=1, conv_threshold_sq=0.0, damping=1.0)
    S = tgn.gram_plain(frame.points()[0], pose, tgn.frame_records(frame, pose))
    got = tgn.unpack_carry(carry)
    assert torch.equal(got[7], S)
    assert int(got[6]) == 1 and int(got[5]) == int(S[7, 7]) > 1000
    assert not bool(got[1] | got[2]) and not torch.equal(got[0], pose)


def _bad_calls():
    ok = dict(num_iterations=4, conv_threshold_sq=1e-6, damping=1.0)
    good = tgn.new_carry(torch.eye(4))
    return {
        "short carry": (good[:-1].clone(), ok, "carry"),
        "float64 carry": (good.double(), ok, "carry"),
        "strided carry": (torch.stack([good, good], 1)[:, 0], ok,
                          "contiguous"),
        "no fresh step": (good, dict(ok, regather_every=0), "fresh"),
        "no iteration": (good, dict(ok, num_iterations=0), "num_iterations"),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_gn_solve_refuses_a_malformed_carry_or_a_solve_without_fresh_steps(
        scene, case):
    carry, kw, match = _bad_calls()[case]
    before = carry.clone()
    with pytest.raises(ValueError, match=match):
        tgn.gn_solve(_frame(scene), carry, **kw)
    assert torch.equal(carry, before)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("flag", ["converged", "failed", "budget"])
def test_a_done_carry_is_left_as_it_is(scene, flag, early_exit):
    """A carry that has converged, failed or spent its budget: every step is
    a masked no-op (the JAX package's masked updates), and under early_exit
    no round runs at all."""
    carry = tgn.new_carry(torch.from_numpy(se3_exp_np(INITS["near"])).to(torch.float32))
    slot = {"converged": tgn.CONV, "failed": tgn.FAIL, "budget": tgn.ITERS}[flag]
    carry[slot] = 4.0 if flag == "budget" else 1.0
    carry[tgn.S0:] = 7.0
    before = carry.clone()
    tgn.gn_solve(_frame(scene), carry, num_iterations=4, conv_threshold_sq=1e-6,
                 damping=1.0, regather_every=2, early_exit=early_exit)
    assert torch.equal(carry, before)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("regather_every", [1, 3, 4])
def test_the_rounds_are_the_jax_loops_trip_counts(regather_every, early_exit):
    """Up to num_iterations rounds under early_exit (the while_loop's bound),
    ceil(num_iterations / regather_every) fixed-trip (the fori_loop's)."""
    want = 10 if early_exit else -(-10 // regather_every)
    assert tgn.solve_rounds(10, regather_every, early_exit) == want


def test_a_cpu_solve_launches_nothing(scene):
    tgn.reset_launch_counts()
    carry = tgn.new_carry(torch.eye(4))
    tgn.gn_solve(_frame(scene), carry, **_solve_kw("PARITY"))
    assert int(carry[tgn.ITERS]) > 0
    assert tgn.launch_counts == {"gn_solve": 0, "gn_gram": 0}
