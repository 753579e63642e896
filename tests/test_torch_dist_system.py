"""The distance block's rows (ops/distcg.dist_system) on the CPU: the lanes
rule (system_lanes), the plain version at each lane count against the
normal equations in float64 and against a lane-by-lane emulation of the
kernel's order, the kernel's reduce-scatter against the butterfly the plain
version adds in (every value's bits, and which lane ends with it), and the
host plan (_system_plan): the tiles, the warps' rows, the ring's stages and
their 16-byte bulk copies.  The plain version against the JAX package's
_distance_system at each lane count is in test_torch_dist_cg.py; the kernel
is held against the plain version on the card by chip_smoke.py (phase
dist_cg_kernels)."""

import numpy as np
import pytest
import torch

from psgradientsdf_tpu_torch.ops import distcg as D
from psgradientsdf_tpu_torch.refine.jacobians import DistJacobian
from psgradientsdf_tpu_torch.refine.render import ResidualData
from psgradientsdf_tpu_torch.refine.solvers import RegOperator

SMS = 132                      # an H100's SMs
SMEM_BLOCK = 232448            # an H100 block's shared memory, at most
# keyframes: the port's shapes (one, two, the LED run's 8, 11, the main 40)
# and the last and first F of each lane count
LANES_AT = {1: 4, 2: 4, 8: 4, 11: 4, 40: 8, 21: 4, 22: 8, 42: 8, 43: 16, 85: 16,
            86: 32}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(N, F, seed, eik=True):
    """Random rows (a fifth of the pairs weighted 0) and an Eikonal row."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    w = torch.from_numpy((rng.random((N, F, 3)) * (rng.random((N, F, 1)) > 0.2))
                         .astype(np.float32))
    rd = ResidualData(r=0.1 * f32(N, F, 3), w=w, mask=None, p_cam=None, uv=None,
                      g_img=None)
    DJ = DistJacobian(J0=f32(N, F, 3), Ji=0.5 * f32(N, 3, F, 3))
    e = RegOperator(r=0.1 * f32(N), J0=f32(N), Ji=f32(N, 3), nbr_idx=None) if eik else None
    return rd, DJ, e


# ------------------------------------------------------------ the lanes rule


@pytest.mark.parametrize("F", sorted(LANES_AT))
def test_lanes_at_the_port_shapes_and_each_threshold(F):
    assert D.system_lanes(3 * F) == LANES_AT[F]


@pytest.mark.parametrize("J", [1, 3, 63, 64, 65, 66, 127, 128, 129, 255, 256, 257, 1000])
def test_lanes_are_the_fewest_giving_a_lane_at_most_its_pairs(J):
    G = D.system_lanes(J)
    assert G in (4, 8, 16, 32)
    assert G == D.LANES or G * D.SYSTEM_PAIRS >= J
    assert G == 4 or (G // 2) * D.SYSTEM_PAIRS < J


# --------------------------------------------------------- the plain version


@pytest.mark.parametrize("eik", [True, False], ids=["eikonal", "none"])
@pytest.mark.parametrize("F", [1, 8, 22, 43, 86])
def test_plain_at_each_lane_count_is_the_normal_equations(F, eik):
    """A_n = sum w a a^T + w_n e e^T, t_n = sum w r a + w_n r_e e, in float64
    by einsum, within float32 rounding of the sums' magnitudes."""
    N, w_n = 37, 0.3
    rd, DJ, e = _inputs(N, F, F, eik)
    A, t = D.dist_system_plain(rd, DJ, e, reg_weight_n=w_n)
    a = torch.stack([DJ.J0.reshape(N, -1), *DJ.Ji.reshape(N, 3, -1).unbind(1)], -1).double()
    w, r = rd.w.reshape(N, -1).double(), rd.r.reshape(N, -1).double()
    full = torch.einsum("nj,nji,njk->nik", w, a, a)
    g = torch.einsum("nj,nji->ni", w * r, a)
    scale_A = torch.einsum("nj,nji,njk->nik", w, a.abs(), a.abs())
    scale_t = torch.einsum("nj,nji->ni", (w * r).abs(), a.abs())
    if e is not None:
        ev = torch.cat([e.J0[:, None], e.Ji], -1).double()
        full = full + w_n * ev[:, :, None] * ev[:, None, :]
        g = g + w_n * e.r.double()[:, None] * ev
        scale_A = scale_A + w_n * ev.abs()[:, :, None] * ev.abs()[:, None, :]
        scale_t = scale_t + w_n * e.r.double().abs()[:, None] * ev.abs()
    I, K = [i for i, _ in D.A_IDX], [k for _, k in D.A_IDX]
    tol = 3 * F * 3 * 2 ** -23
    assert ((A.double() - full[:, I, K]).abs() <= tol * scale_A[:, I, K] + 1e-30).all()
    assert ((t.double() - g).abs() <= tol * scale_t + 1e-30).all()


def _lane_order(rd, DJ, e, w_n):
    """The kernel's order in numpy float32, a row at a time: lane l of G adds
    the pairs l, l + G, ... (each product and sum rounded), the lanes added
    pairwise (l and l + s for s = G/2, ..., 1), then the Eikonal terms."""
    f = np.float32
    N, F = rd.w.shape[:2]
    J = 3 * F
    G = D.system_lanes(J)
    w, r = rd.w.reshape(N, J).numpy(), rd.r.reshape(N, J).numpy()
    Ji = DJ.Ji.reshape(N, 3, J).numpy()
    a = np.stack([DJ.J0.reshape(N, J).numpy(), Ji[:, 0], Ji[:, 1], Ji[:, 2]], -1)
    A = np.zeros((N, 10), np.float32)
    t = np.zeros((N, 4), np.float32)
    for n in range(N):
        acc = np.zeros((G, 14), np.float32)
        for l in range(G):
            for j in range(l, J, G):
                wa = [f(w[n, j] * a[n, j, i]) for i in range(4)]
                for q, (i, k) in enumerate(D.A_IDX):
                    acc[l, q] = f(acc[l, q] + f(wa[i] * a[n, j, k]))
                wr = f(w[n, j] * r[n, j])
                for i in range(4):
                    acc[l, 10 + i] = f(acc[l, 10 + i] + f(wr * a[n, j, i]))
        s = G // 2
        while s >= 1:
            acc = (acc[:s] + acc[s:2 * s]).astype(np.float32)
            s //= 2
        v = acc[0]
        if e is not None:
            ev = [e.J0[n].item(), *e.Ji[n].tolist()]
            lam = f(w_n)
            we = [f(lam * f(x)) for x in ev]
            for q, (i, k) in enumerate(D.A_IDX):
                v[q] = f(v[q] + f(we[i] * f(ev[k])))
            wr = f(lam * f(e.r[n].item()))
            for i in range(4):
                v[10 + i] = f(v[10 + i] + f(wr * f(ev[i])))
        A[n], t[n] = v[:10], v[10:]
    return A, t


@pytest.mark.parametrize("F", [1, 5, 8, 22, 43])
def test_plain_sums_in_the_kernels_lane_order_bit_for_bit(F):
    rd, DJ, e = _inputs(6, F, 100 + F)
    A, t = D.dist_system_plain(rd, DJ, e, reg_weight_n=0.3)
    A2, t2 = _lane_order(rd, DJ, e, 0.3)
    np.testing.assert_array_equal(A.numpy().view(np.int32), A2.view(np.int32))
    np.testing.assert_array_equal(t.numpy().view(np.int32), t2.view(np.int32))


def test_the_wrapper_on_the_cpu_is_the_plain_version():
    rd, DJ, e = _inputs(9, 8, 5)
    for x, y in zip(D.dist_system(rd, DJ, e, reg_weight_n=0.3),
                    D.dist_system_plain(rd, DJ, e, reg_weight_n=0.3)):
        assert torch.equal(x, y)
    assert D.launch_counts["dist_system"] == 0


# ---------------------------------------------------- the kernel's reduction


def _reduce_scatter(v, G):
    """csrc/distcg.cu reduce_scatter over a row group's G lanes, v [G, 16]
    float32: at lanes l and l ^ s (s = G/2, ..., 1) the lane with bit s set
    keeps the upper half of its values, the other the lower, each adding
    (its own + the partner's) in float32; with one value left, the two add
    theirs -> (each lane's value indices, its values): 16 / G of them (one
    where G = 32)."""
    held = [list(range(16)) for _ in range(G)]           # value index of each slot
    vals = [list(v[l]) for l in range(G)]
    s = G // 2
    while s >= 1:
        new_held, new_vals = [], []
        for l in range(G):
            p = l ^ s
            if len(held[l]) > 1:
                h = len(held[l]) // 2
                keep = slice(h, None) if l & s else slice(None, h)
                idx, mine = held[l][keep], vals[l][keep]
                theirs = vals[p][keep]
                assert held[p][keep] == idx                   # the partner sends these
            else:
                idx, mine, theirs = held[l], vals[l], vals[p]
            new_held.append(idx)
            new_vals.append([np.float32(x + y) for x, y in zip(mine, theirs)])
        held, vals = new_held, new_vals
        s //= 2
    return held, vals


@pytest.mark.parametrize("G", [4, 8, 16, 32])
def test_reduce_scatter_keeps_the_butterflys_bits_and_lane_map(G):
    rng = np.random.default_rng(G)
    v = rng.standard_normal((G, 16)).astype(np.float32) * 10.0 ** rng.integers(-3, 4, (G, 16))
    v[:, 14:] = 0.0
    held, vals = _reduce_scatter(v, G)
    tree = v.copy()
    s = G // 2
    while s >= 1:                                          # ops/distcg._lane_sum
        tree = (tree[:s] + tree[s:2 * s]).astype(np.float32)
        s //= 2
    mine = 16 // G if G < 32 else 1
    for l in range(G):
        base = l * mine if G < 32 else l >> 1               # the kernel's base
        assert held[l] == list(range(base, base + mine))
        for q, x in zip(held[l], vals[l]):
            assert np.float32(x).view(np.int32) == tree[0, q].view(np.int32)


# -------------------------------------------------------------- the plan


ROWS = [1, 7, 63, 4099, 49149, 49152, 8 * 49152]
KEYFRAMES = [1, 5, 8, 21, 22, 40, 43, 86, 160, 400]


def _stage_bytes(plan, J):
    return plan.tile * (D._PAIR_BYTES * J + D._EIK_BYTES)


@pytest.mark.parametrize("F", KEYFRAMES)
@pytest.mark.parametrize("N", ROWS)
def test_plan_tiles_warps_and_ring(N, F):
    J = 3 * F
    plan = D._system_plan(N, J, sms=SMS)
    G = D.system_lanes(J)
    assert plan.lanes == G
    assert plan.tile == D.SYSTEM_WARPS * (D.LANES // G)    # a row group a lane
    # a tile's runs are 16-byte sized (the last tile's tails aside) and
    # start on 16-byte boundaries
    assert (plan.tile * J) % 4 == 0 and plan.tile % 4 == 0
    assert plan.ring % 128 == 0
    assert plan.ring >= D._SYSTEM_BARRIERS + D._OUT_BYTES * plan.tile
    assert plan.depth in (0, 2, 3, 4)
    assert plan.smem_bytes == plan.ring + plan.depth * _stage_bytes(plan, J)
    assert plan.smem_bytes <= SMEM_BLOCK
    tiles = -(-N // plan.tile)
    assert 1 <= plan.blocks <= min(tiles, D.SYSTEM_BLOCKS * SMS)
    if plan.blocks > SMS:              # several blocks share an SM's memory
        assert plan.blocks * plan.smem_bytes <= SMS * D.SYSTEM_SM_SMEM


@pytest.mark.parametrize("F", [1, 8, 40])
@pytest.mark.parametrize("N", [7, 4099, 49152])
def test_the_blocks_tiles_and_warps_cover_every_row_once(N, F):
    """The persistent grid's tiles (block b: b, b + blocks, ...) and each
    consumer warp's rows of a tile (a row group a lane) cover the rows
    once."""
    plan = D._system_plan(N, 3 * F, sms=SMS)
    per = D.LANES // plan.lanes
    seen = np.zeros(N, np.int64)
    tiles = -(-N // plan.tile)
    for b in range(plan.blocks):
        for tile in range(b, tiles, plan.blocks):
            n0 = tile * plan.tile
            rows = min(plan.tile, N - n0)
            for warp in range(D.SYSTEM_WARPS):
                r0 = warp * per
                mine = max(0, min(per, rows - r0))
                seen[n0 + r0:n0 + r0 + mine] += 1
    assert (seen == 1).all()


def test_plan_at_the_refinements_shapes():
    led = D._system_plan(49152, 24, sms=SMS)
    main = D._system_plan(49152, 120, sms=SMS)
    assert (led.lanes, led.tile, led.depth, led.blocks) == (4, 64, 2, 2 * SMS)
    assert (main.lanes, main.tile, main.depth, main.blocks) == (8, 32, 2, SMS)


@pytest.mark.parametrize("F", [8, 40])
def test_unstaged_plan_keeps_the_tiles_without_a_ring(F):
    staged = D._system_plan(49152, 3 * F, sms=SMS)
    plain = D._system_plan(49152, 3 * F, sms=SMS, staged=False)
    assert plain.depth == 0 and plain.smem_bytes == plain.ring
    assert plain.blocks == min(-(-49152 // plain.tile), D.SYSTEM_BLOCKS * SMS)
    assert plain._replace(depth=staged.depth, smem_bytes=staged.smem_bytes,
                          blocks=staged.blocks) == staged


@pytest.mark.parametrize("args", [(0, 24), (10, 0), (10, 24, 0)])
def test_plan_refuses_no_rows_pairs_or_sms(args):
    N, J, *sms = args
    with pytest.raises(ValueError):
        D._system_plan(N, J, sms=sms[0] if sms else SMS)
