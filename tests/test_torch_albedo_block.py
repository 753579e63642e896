"""The albedo block's one launch (ops/albedo.albedo_block, csrc/albedo.cu
albedo_block_kernel) on the CPU: its host plan's stages (every pair of
every row staged once, bulk copies only of 16-byte spans, the rest by the
lanes' loads, the rings and vectors within a block's shared memory), the
grid barriers it crosses, and its CPU path equal to albedo_cg_plain on
albedo_system_plain bit for bit on a small problem of its own.  The JAX
package is not needed here: tests/test_torch_albedo.py holds the block to
it; chip_smoke.py (phase albedo_kernels) holds the kernel to the plain
versions on the card."""

import types

import numpy as np
import pytest
import torch

from psgradientsdf_tpu_torch.config import LED
from psgradientsdf_tpu_torch.ops import albedo as AL
from psgradientsdf_tpu_torch.ops import distcg
from psgradientsdf_tpu_torch.refine.render import ResidualData

SMS = 132
EDGES = [1, 15, 16, 17, SMS * 16, SMS * 16 + 1, 49152, 4 * 49152, "limit", "limit+1",
         2_000_000]
FRAMES = [1, 2, 7, 8, 40, 64]


def _rows(N, F, led):
    lim = AL.shared_tile_limit(F, led=led)
    return {"limit": SMS * lim, "limit+1": SMS * lim + 1}.get(N, N)


@pytest.mark.parametrize("led", [False, True], ids=["SH", "LED"])
@pytest.mark.parametrize("F", FRAMES)
@pytest.mark.parametrize("N", EDGES)
def test_stage_plan_stages_every_pair_once(N, F, led):
    """stage_list on _albedo_plan's launch (132 SMs): the stages tile every
    row of [0, N) once, in STAGE_ROWS rows, each inside its block's tile
    and partial only at a tile's end, so each of a row's F pairs is read
    once; warp w takes the tile's stages w, w + WARPS, ... into slots
    turn % depth; a stage is a bulk copy exactly where its pair spans and
    its gradient span are 16-byte aligned and sized (every whole stage at
    aligned bases), else the lanes load it (every stage at an unaligned
    base); header, mbarriers, rings and vectors fit the block's shared
    memory."""
    N = _rows(N, F, led)
    plan = AL._albedo_plan(N, F, led=led, sms=SMS)
    st = AL.stage_list(plan, N, F, led=led)
    order = np.argsort(st["row0"], kind="stable")
    row0, rows = st["row0"][order], st["rows"][order]
    assert row0[0] == 0 and row0[-1] + rows[-1] == N
    assert np.array_equal(row0[1:], row0[:-1] + rows[:-1])
    assert rows.min() >= 1 and rows.max() <= AL.STAGE_ROWS
    blk = st["block"]
    end = np.minimum(N, (blk + 1) * plan.tile)
    assert np.all(blk * plan.tile <= st["row0"]) and np.all(st["row0"] + st["rows"] <= end)
    assert np.all((st["rows"] == AL.STAGE_ROWS) | (st["row0"] + st["rows"] == end))
    stage = (st["row0"] - blk * plan.tile) // AL.STAGE_ROWS
    assert np.array_equal(st["warp"] + AL.WARPS * st["turn"], stage)
    assert st["warp"].max() < AL.WARPS
    assert plan.depth >= 1
    assert np.array_equal(st["slot"], st["turn"] % plan.depth)
    assert np.array_equal(st["offset"], st["row0"] * F * 12)
    assert np.array_equal(st["bytes"], st["rows"] * F * 12)
    spans16 = ((st["offset"] % 16 == 0) & (st["bytes"] % 16 == 0)
               & (st["row0"] * 12 % 16 == 0) & (st["rows"] * 12 % 16 == 0))
    assert np.array_equal(st["bulk"], spans16)
    assert st["bulk"][st["rows"] == AL.STAGE_ROWS].all()
    assert not AL.stage_list(plan, N, F, led=led, base=4)["bulk"].any()
    # the shared memory: header, the warps' mbarriers, the rings, the vectors
    assert plan.stage_bytes == AL.STAGE_ROWS * (F * 12 * (3 if led else 2) + 12)
    assert plan.stage_bytes % 16 == 0 and plan.ring % 16 == 0
    assert plan.ring >= AL._HEADER + 8 * AL.WARPS * plan.depth
    rings = plan.ring + AL.WARPS * plan.depth * plan.stage_bytes
    if plan.shared:
        assert plan.vec == rings and plan.smem_bytes == rings + 96 * plan.tile
    else:
        assert plan.smem_bytes == rings
    assert plan.smem_bytes <= distcg.SMEM_PER_BLOCK


@pytest.mark.parametrize("led", [False, True], ids=["SH", "LED"])
def test_plan_takes_the_deepest_ring_that_fits(led):
    """Across F = 1 ... 400 at the main run's voxel count and at four
    times it: the ring is the deepest, up to DEPTH stages a warp, that fits
    beside the vectors; depth 0 (the pairs read from device memory) only
    where one stage a warp does not fit at all; the vectors in shared
    memory exactly up to shared_tile_limit."""
    for N in (49152, 4 * 49152):
        for F in range(1, 401):
            plan = AL._albedo_plan(N, F, led=led, sms=SMS)
            vec = 96 * plan.tile if plan.shared else 0
            fits = [d for d in range(0, AL.DEPTH + 1)
                    if AL._rings(d, F, led)[1] + vec <= distcg.SMEM_PER_BLOCK]
            assert plan.depth == max(fits)
            assert plan.shared == (plan.tile <= AL.shared_tile_limit(F, led=led))
            if plan.depth == 0:
                assert AL._rings(1, F, led)[1] > distcg.SMEM_PER_BLOCK
            assert plan.smem_bytes <= distcg.SMEM_PER_BLOCK


def test_grid_barriers():
    """The barriers the kernel crosses: without the regularizer the
    prologue's grid.sync (carrying step 0's p.Ap) and then two a step but
    one at step 0 (the recipes' one-step solve: 2, where the earlier two
    launches crossed 3); under it the grid.sync before the transposes,
    the prologue's barrier and four a step."""
    assert [AL.grid_barriers(False, k) for k in range(4)] == [1, 2, 4, 6]
    assert [AL.grid_barriers(True, k) for k in range(3)] == [2, 6, 10]


def _problem(model, order, G=6, F=5, seed=3):
    """A G^3 grid of voxels with a one-sided stencil, random pairs (a fifth
    masked) and a sixth of the rows invalid -> (args, keyword args)."""
    gen = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=gen)
    n = lambda *s: torch.randn(s, generator=gen)
    N = G ** 3
    idx = torch.arange(N)
    xyz = torch.stack([idx % G, (idx // G) % G, idx // (G * G)], -1)
    nbr = torch.full((N, 3), -1, dtype=torch.int64)
    for ax, step in enumerate((1, G, G * G)):
        ok = xyz[:, ax] < G - 1
        nbr[ok, ax] = idx[ok] + step
    prob = types.SimpleNamespace(valid=u(N) > 0.17, idx_xyz=xyz, nbr_idx=nbr,
                                 lap_idx=torch.full((N, 6), -1, dtype=torch.int64),
                                 nbr_dir=torch.where(u(N, 3) > 0.5, 1.0, -1.0),
                                 nbr_albedo_const=0.1 + 0.8 * u(N, 3, 3))
    p_cam = torch.stack([0.3 * n(N, F), 0.3 * n(N, F), 1.2 + 0.1 * n(N, F)], -1)
    rd = ResidualData(r=0.1 * n(N, F, 3), w=u(N, F, 3) * (u(N, F, 1) > 0.2), mask=None,
                      p_cam=p_cam.contiguous(), uv=None, g_img=None)
    rot, _ = torch.linalg.qr(n(F, 3, 3))
    poses = torch.eye(4).repeat(F, 1, 1)
    poses[:, :3, :3] = rot
    lights = (torch.tensor([0.8, 1.0, 1.1]) if model == LED
              else 0.3 * n(F, 4 if order == 1 else 9))
    args = (prob, rd, 0.1 + 0.8 * u(N, 3), n(N, 3), lights, poses,
            distcg.stencil_reverse(prob))
    return args, dict(model=model, order=order, voxel_size=0.04)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("rho", [0.0, 0.05])
@pytest.mark.parametrize("model,order", [("SH", 1), ("SH", 2), (LED, 1)],
                         ids=["SH1", "SH2", "LED"])
def test_cpu_path_is_the_plain_pair(model, order, rho, static):
    """On CPU tensors albedo_block returns albedo_cg_plain on
    albedo_system_plain bit for bit: delta, the new albedo, the steps, the
    system (system_out) and the barriers the kernel would cross; two calls
    give the same bits; no launch is counted."""
    args, kw = _problem(model, order)
    cg = dict(damping=1.0, cg_iters=100, cg_tol=1e-6, cg_static=static)
    AL.reset_launch_counts()
    steps, system, bars = [], [], []
    delta, new = AL.albedo_block(*args, **kw, reg_weight_rho=rho, **cg, steps_out=steps,
                                 system_out=system, barriers_out=bars)
    again = AL.albedo_block(*args, **kw, reg_weight_rho=rho, **cg)
    plain = AL.albedo_system_plain(*args, **kw, reg_weight_rho=rho)
    psteps = []
    pdelta, pnew = AL.albedo_cg_plain(plain, args[0].valid, args[2], args[6],
                                      reg_weight_rho=rho, **cg, steps_out=psteps)
    assert torch.equal(delta, pdelta) and torch.equal(new, pnew)
    assert torch.equal(again[0], delta) and torch.equal(again[1], new)
    for got, want in zip(system[0], plain):
        assert (got is None and want is None) or torch.equal(got, want)
    assert int(steps[0]) == int(psteps[0]) and int(steps[0]) >= 1
    assert int(bars[0]) == AL.grid_barriers(rho != 0.0, int(steps[0]))
    if rho == 0.0:
        assert int(steps[0]) == 1 and int(bars[0]) == 2
    assert float(delta.abs().max()) > 0.0
    assert AL.launch_counts == {"albedo_block": 0}
