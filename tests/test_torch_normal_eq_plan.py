"""The normal-equation kernel's host plan (ops/normaleq._reduce_plan): the
blocks and their threads cover every (voxel, keyframe) pair once; tiles and
stages are multiples of 4 voxels (and of the lanes); the grid is one wave of
the card's clusters; the bulk-copied bodies and the ragged ends the
producer loads cover each array's bytes once, wherever its base lies; the
ring fits a block's shared memory; and the sums in the kernel's order (a
thread's float runs, its column's lanes, a cluster's tiles, the clusters)
equal the direct sums whichever block finishes last.  Pure host
arithmetic: the kernel's launches on the card are held by chip_smoke.py
(phase normal_eq_kernels)."""

import math

import numpy as np
import pytest

from psgradientsdf_tpu_torch.ops import normaleq as NE

CLUSTERS = 15                  # clusters of 8 blocks an H100 holds at once
SMEM_PER_BLOCK = 232448        # an H100 block's shared memory, at most
SHAPES = [(0, 40), (1, 1), (1, 40), (193, 40), (7, 33), (49152, 40), (49153, 40),
          (49152, 8), (385, 8), (131072, 8), (1000, 549), (3, 256), (5, 257),
          (300, 257), (524288, 34)]
KINDS = [(6, False), (6, True), (4, False), (9, False)]


def _unit(plan):
    return math.lcm(NE.UNIT_VOXELS, plan.lanes)


def _stages(plan, N, tile):
    """The stages (n0, nv) of a tile, as the kernel walks them."""
    v0 = tile * plan.voxels
    v1 = min(N, v0 + plan.voxels)
    return [(n0, min(plan.stage_voxels, v1 - n0))
            for n0 in range(v0, v1, plan.stage_voxels)]


@pytest.mark.parametrize("N,F", SHAPES)
def test_blocks_cover_every_pair_once(N, F):
    """Tiles x chunks x stages x (lane, column) threads: each pair once."""
    plan = NE._reduce_plan(N, F, 6, False, CLUSTERS)
    seen = np.zeros((N, F), np.int16)
    for c in range(plan.chunks):
        f0 = c * plan.frames
        here = min(plan.frames, F - f0)
        assert here >= 1
        for t in range(plan.tiles):
            for n0, nv in _stages(plan, N, t):
                assert 1 <= nv <= plan.stage_voxels
                seen[n0:n0 + nv, f0:f0 + here] += 1
    assert (seen == 1).all()
    # a stage's voxels lane, lane + R, ... of the R lanes: each once
    for nv in {plan.stage_voxels, max(1, N % plan.stage_voxels)}:
        lanes = np.concatenate([np.arange(lane, nv, plan.lanes)
                                for lane in range(plan.lanes)])
        assert sorted(lanes) == list(range(nv))


@pytest.mark.parametrize("N,F", SHAPES)
def test_threads_hold_the_columns_and_lanes(N, F):
    plan = NE._reduce_plan(N, F, 6, False, CLUSTERS)
    FB, R = plan.frames, plan.lanes
    if F < 32:
        assert FB >= F and FB & (FB - 1) == 0 and FB < 2 * F
        assert R * FB == NE.THREADS            # a warp holds 32 / FB whole lanes
    else:
        assert FB == min(F, NE.THREADS)
        assert R * FB <= NE.THREADS < (R + 1) * FB
    assert plan.chunks * FB >= F > (plan.chunks - 1) * FB
    assert plan.rows == int(plan.chunks > 1)


@pytest.mark.parametrize("dim,led", KINDS)
@pytest.mark.parametrize("N,F", SHAPES)
def test_tiles_and_stages_are_multiples_of_four_voxels(N, F, dim, led):
    """Tiles and stages are whole units of lcm(4, R) voxels, so a stage
    starts on a multiple of 4 voxels and each lane has as many of its
    voxels as the others."""
    plan = NE._reduce_plan(N, F, dim, led, CLUSTERS)
    unit = _unit(plan)
    assert plan.voxels % unit == 0 and plan.stage_voxels % unit == 0
    assert unit % NE.UNIT_VOXELS == 0 and unit % plan.lanes == 0
    for t in range(plan.tiles):
        for n0, _ in _stages(plan, N, t):
            assert n0 % NE.UNIT_VOXELS == 0


@pytest.mark.parametrize("clusters", [1, 3, 16, 33])
@pytest.mark.parametrize("N,F", SHAPES)
def test_the_tile_pass_fills_the_card(N, F, clusters):
    """The grid is one wave of the card's clusters (tiles a multiple of the
    cluster, a power of two of at most CLUSTER blocks); where there are
    enough voxels its tiles fill that wave to within a unit each."""
    plan = NE._reduce_plan(N, F, 6, False, clusters)
    Q = plan.cluster
    assert Q & (Q - 1) == 0 and 1 <= Q <= NE.CLUSTER
    assert plan.tiles % Q == 0
    slots = max(1, clusters // plan.chunks) * NE.CLUSTER
    used = max(1, -(-N // plan.voxels))
    assert plan.tiles == -(-used // Q) * Q <= slots
    assert (used - 1) * plan.voxels < max(N, 1) <= used * plan.voxels
    unit = _unit(plan)
    if N >= slots * unit:
        assert used >= slots / (1 + slots * unit / N) - 1


@pytest.mark.parametrize("N", [1, 49152])
@pytest.mark.parametrize("F", [1, 3, 8, 33, 40, 257, 549])
@pytest.mark.parametrize("dim,led", KINDS)
def test_shared_memory_of_a_block(dim, led, F, N):
    """The sums [S][THREADS] in double, a ring of 2-4 stages (each within
    half the ring's room and THREAD_VOXELS voxels a lane, and a tile of at
    least MIN_TILE_STAGES stages, unless one unit is larger) and the
    barriers fit a block's shared memory; the arrays' regions are 16-byte
    aligned and inside the stage."""
    plan = NE._reduce_plan(N, F, dim, led, CLUSTERS)
    S = NE.terms(dim)
    assert S == {6: NE.POSE_TERMS, 4: 14, 9: 54}[dim]
    sums = 8 * S * NE.THREADS
    # sums in registers during the loop (then in the ring's place), or
    # before the ring in shared memory throughout
    assert plan.ring == (0 if S <= NE.REGISTER_TERMS else sums)
    assert plan.barriers == max(plan.ring + plan.stages * plan.stage_bytes, sums)
    assert 2 <= plan.stages <= NE.STAGES
    assert plan.smem == plan.barriers + 16 * plan.stages + 16
    assert plan.smem <= SMEM_PER_BLOCK
    room = SMEM_PER_BLOCK - plan.ring - 16 * NE.STAGES - 16
    unit = _unit(plan)
    if plan.stage_voxels > unit:
        assert 2 * plan.stage_bytes <= room
        assert plan.stage_voxels * NE.MIN_TILE_STAGES <= plan.voxels
        assert plan.stage_voxels <= plan.lanes * NE.THREAD_VOXELS
    assert plan.stages == min(NE.STAGES, room // plan.stage_bytes)
    arrays = NE.staged_arrays(dim, led)
    ends = [plan.offset[i + 1] for i in range(len(arrays) - 1)] + [plan.stage_bytes]
    for i, (eb, pair) in enumerate(arrays):
        assert plan.offset[i] % 16 == 0 and plan.stage_bytes % 16 == 0
        if pair and plan.rows:
            assert plan.pitch[i] % 16 == 0 and plan.pitch[i] >= plan.frames * eb + 16
            assert ends[i] - plan.offset[i] == plan.stage_voxels * plan.pitch[i]
        else:
            assert plan.pitch[i] == (F * eb if pair else eb)
            assert ends[i] - plan.offset[i] >= plan.stage_voxels * plan.pitch[i] + 12


def _spans(plan, N, F, arrays, bases, chunk, n0, nv):
    """csrc/normaleq.cu span_of / span_parts: each span of a stage ->
    (array, row k, global start, bytes, head, body, its place in the
    buffer)."""
    f0 = chunk * plan.frames
    here = min(plan.frames, F - f0)
    for i, (eb, pair) in enumerate(arrays):
        rows = pair and bool(plan.rows)
        stride = F * eb if pair else eb
        col0 = f0 * eb if rows else 0
        for k in range(nv if rows else 1):
            g = bases[i] + (n0 + k) * stride + col0 if rows else bases[i] + n0 * stride
            nbytes = here * eb if rows else nv * stride
            head = min((16 - g % 16) % 16, nbytes)
            body = (nbytes - head) // 16 * 16
            yield i, k, g, nbytes, head, body, plan.offset[i] + k * plan.pitch[i] + g % 16


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("F", [1, 8, 33, 40, 257])
@pytest.mark.parametrize("dim,led", [(6, True), (9, False)])
def test_bodies_and_ragged_ends_cover_each_array_once(dim, led, F, offset):
    """Each array's base `offset` floats past a 16-byte boundary (g_img's an
    8-byte one): the bulk bodies (16-byte aligned in device and shared
    memory, whole 16-byte chunks) and the ragged heads and tails cover each
    pair array's bytes once over the chunks, and each voxel array's once a
    chunk; every span lies inside its region, and the consumers' row
    address of a pair is where its span put it."""
    N = 301
    plan = NE._reduce_plan(N, F, dim, led, 2)
    arrays = NE.staged_arrays(dim, led)
    bases = [4096 * (i + 1) + (8 * (offset % 2) if eb == 24 else 4 * offset)
             for i, (eb, _) in enumerate(arrays)]
    sizes = [N * (F * eb if pair else eb) for eb, pair in arrays]
    bulk = [np.zeros((plan.chunks, s), np.int16) for s in sizes]
    ragged = [np.zeros((plan.chunks, s), np.int16) for s in sizes]
    ends = [plan.offset[i + 1] for i in range(len(arrays) - 1)] + [plan.stage_bytes]
    for c in range(plan.chunks):
        for t in range(plan.tiles):
            for n0, nv in _stages(plan, N, t):
                for i, k, g, nbytes, head, body, s in _spans(plan, N, F, arrays, bases, c,
                                                             n0, nv):
                    assert (g + head) % 16 == 0 and body % 16 == 0
                    assert (s + head) % 16 == 0
                    assert plan.offset[i] + k * plan.pitch[i] <= s
                    assert s + nbytes <= ends[i] if not plan.rows or not arrays[i][1] \
                        else s + nbytes <= plan.offset[i] + (k + 1) * plan.pitch[i]
                    lo = g - bases[i]
                    bulk[i][c, lo + head:lo + head + body] += 1
                    ragged[i][c, lo:lo + head] += 1
                    ragged[i][c, lo + head + body:lo + nbytes] += 1
                    assert (nbytes - body) <= 24 and (nbytes - body) % 4 == 0
                    # the consumers' row k (csrc row_staged) at this span
                    eb, pair = arrays[i]
                    if pair and not plan.rows:
                        for v in {0, nv - 1}:
                            row = plan.offset[i] + v * plan.pitch[i] + g % 16
                            assert row == s + v * F * eb
    for i, (eb, pair) in enumerate(arrays):
        both = bulk[i] + ragged[i]
        if pair:
            assert (both.sum(axis=0) == 1).all()
        else:
            assert (both == 1).all()
        assert bulk[i].sum() > ragged[i].sum()


def _butterfly(x, FB):
    """A warp's lanes of each column added by the kernel's shuffles (xor
    over offsets FB, 2 FB, ..., 16): x [.., 32] -> the sums at lanes < FB."""
    x = x.copy()
    o = FB
    while o < 32:
        x = x + x[..., np.arange(32) ^ o]
        o <<= 1
    return x


def _kernel_sums(plan, N, F, terms, order):
    """The kernel's order of addition in float64 -> [F, S], the blocks
    finishing in `order` (the last of each chunk's rank-q blocks, by its
    ticket, adds its slice q of the columns over the clusters)."""
    S = terms.shape[-1]
    FB, R, Q = plan.frames, plan.lanes, plan.cluster
    K = plan.tiles // Q
    partial = np.zeros((plan.chunks, K, S, FB))
    col_sums = {}
    for c in range(plan.chunks):
        f0 = c * FB
        here = min(FB, F - f0)
        for t in range(plan.tiles):
            sums = np.zeros((S, NE.THREADS))
            for tid in range(R * FB):
                lane, col = divmod(tid, FB)
                if col >= here:
                    continue
                run, count = np.zeros(S), 0
                for n0, nv in _stages(plan, N, t):
                    for v in range(lane, nv, R):
                        run = run + terms[n0 + v, f0 + col]
                        count += 1
                        if count == NE.LANE_VOXELS:
                            sums[:, tid] += run
                            run, count = np.zeros(S), 0
                sums[:, tid] += run
            if FB < 32:
                warps = _butterfly(sums.reshape(S, NE.THREADS // 32, 32), FB)
                col_sums[c, t] = np.zeros((S, FB))
                for w in range(NE.THREADS // 32):
                    col_sums[c, t] += warps[:, w, :FB]
            else:
                col_sums[c, t] = np.zeros((S, FB))
                for lane in range(R):
                    col_sums[c, t] += sums[:, lane * FB:(lane + 1) * FB]
        for k in range(K):
            for q in range(Q):
                partial[c, k] += col_sums[c, k * Q + q]
    tickets = np.zeros((plan.chunks, Q), np.int64)
    out = np.full((plan.chunks, S, FB), np.nan)
    for c, t in order:
        q = t % Q
        tickets[c, q] += 1
        if tickets[c, q] == K:
            here = min(FB, F - c * FB)
            per = -(-here // Q)
            for col in range(q * per, min(here, (q + 1) * per)):
                for k in range(S):
                    s = 0.0
                    for kc in range(K):
                        s += partial[c, kc, k, col]
                    out[c, k, col] = s
    return np.concatenate([out[c, :, :min(FB, F - c * FB)].T for c in range(plan.chunks)])


@pytest.mark.parametrize("clusters", [1, 2, 16])
@pytest.mark.parametrize("N,F", [(0, 3), (50, 7), (301, 5), (17, 300), (385, 8), (700, 40)])
def test_sums_in_the_plan_order_equal_the_direct_sums(N, F, clusters):
    """The kernel's order of addition, emulated in float64: a thread (lane,
    column) adds its voxels lane, lane + R, ... of each stage in float runs
    of LANE_VOXELS voxels, each run then into its double sum; a column's
    lanes by the warp shuffles and then the warps (FB < 32) or in lane
    order; a cluster's tiles in rank order (rank q's slice of the columns);
    the clusters in order, by the last block of each rank: equal to the
    direct sums, and to the bit the same whichever block finishes last."""
    rng = np.random.default_rng(N + F + clusters)
    terms = rng.normal(size=(N, F, 27))
    plan = NE._reduce_plan(N, F, 6, False, clusters)
    blocks = [(c, t) for c in range(plan.chunks) for t in range(plan.tiles)]
    got = [_kernel_sums(plan, N, F, terms, [blocks[i] for i in rng.permutation(len(blocks))])
           for _ in range(2)]
    assert not np.isnan(got[0]).any()
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], terms.sum(axis=0), rtol=1e-12, atol=1e-12)
