"""The normal-equation kernels' host plan (ops/normaleq._reduce_plan): the
blocks cover every (voxel, keyframe) pair once; a block's threads hold its
keyframe columns and voxel lanes, a lane at most LANE_VOXELS voxels; the
tile pass fills the card's SMs; a
block's shared memory stays within the card's; and the sums in the plan's
order (a thread's voxels, its column's lanes, the tiles) equal the direct
sums.  Pure host arithmetic: the kernels' launches on the card are held by
chip_smoke.py (phase normal_eq_kernels)."""

import numpy as np
import pytest

from psgradientsdf_tpu_torch.ops import normaleq as NE

SMS = 132                      # an H100's SMs
SMEM_PER_BLOCK = 232448        # an H100 block's shared memory, at most
SHAPES = [(0, 40), (1, 1), (1, 40), (193, 40), (7, 33), (49152, 40), (49153, 40),
          (131072, 8), (1000, 549), (3, 256), (5, 257), (524288, 34)]


def _blocks(plan, N, F):
    """Each block's (voxel range, keyframe range, lanes) from the plan."""
    for t in range(plan.tiles):
        for c in range(plan.chunks):
            v0, f0 = t * plan.voxels, c * plan.frames
            yield (v0, min(N, v0 + plan.voxels)), (f0, min(F, f0 + plan.frames))


@pytest.mark.parametrize("N,F", SHAPES)
def test_blocks_cover_every_pair_once(N, F):
    plan = NE._reduce_plan(N, F, SMS)
    seen = np.zeros((N, F), np.int64)
    for (v0, v1), (f0, f1) in _blocks(plan, N, F):
        assert f1 > f0
        seen[v0:v1, f0:f1] += 1
    assert (seen == 1).all()
    assert plan.tiles == max(1, -(-N // plan.voxels))
    if N:
        assert (plan.tiles - 1) * plan.voxels < N <= plan.tiles * plan.voxels


@pytest.mark.parametrize("N,F", SHAPES)
def test_threads_hold_the_columns_and_lanes(N, F):
    plan = NE._reduce_plan(N, F, SMS)
    assert plan.frames == min(F, NE.THREADS)
    assert plan.chunks * plan.frames >= F > (plan.chunks - 1) * plan.frames
    assert plan.lanes >= 1 and plan.lanes * plan.frames <= NE.THREADS
    assert (plan.lanes + 1) * plan.frames > NE.THREADS
    assert plan.voxels % plan.lanes == 0
    assert plan.lanes <= plan.voxels <= plan.lanes * NE.LANE_VOXELS


@pytest.mark.parametrize("N,F", SHAPES)
def test_the_tile_pass_fills_the_card(N, F):
    """Where there are enough voxels, the blocks are BLOCKS_PER_SM an SM
    (one wave), no fewer than one SM's worth short of it; where a lane
    would take more than LANE_VOXELS voxels, more tiles of that many."""
    plan = NE._reduce_plan(N, F, SMS)
    blocks = plan.tiles * plan.chunks
    want = NE.BLOCKS_PER_SM * SMS
    if plan.voxels == plan.lanes * NE.LANE_VOXELS:
        assert blocks >= want - plan.chunks * SMS
    elif N >= want * plan.lanes:
        assert want - plan.chunks * SMS < blocks <= want + plan.chunks
    assert blocks >= 1


@pytest.mark.parametrize("dim", [6, 4, 9])
def test_shared_memory_of_a_block(dim):
    """The tile kernels stage every thread's sums in shared memory, in
    double: within a block's limit, and the pose's leaves room for
    BLOCKS_PER_SM blocks an SM."""
    S = NE.terms(dim)
    assert S == {6: NE.POSE_TERMS, 4: 14, 9: 54}[dim]
    smem = 8 * S * NE.THREADS
    assert smem <= SMEM_PER_BLOCK
    if dim == 6:
        assert NE.BLOCKS_PER_SM * (smem + 1024) <= 233472
    # the reduction's threads hold a keyframe's sums
    assert NE.REDUCE_THREADS // S >= 1


@pytest.mark.parametrize("sms", [1, 2, 66, 132])
@pytest.mark.parametrize("N,F", [(0, 3), (50, 7), (301, 5), (17, 300)])
def test_sums_in_the_plan_order_equal_the_direct_sums(N, F, sms):
    """The kernels' order of addition, emulated in float64: a thread (lane,
    column) adds its voxels lane, lane + R, ... of its tile; the lanes of a
    column are added in order; then the tiles' partials in the reduction's
    order (thread j of `ways` the tiles j, j + ways, ..., then the ways)."""
    rng = np.random.default_rng(N + F + sms)
    terms = rng.normal(size=(N, F, 27))
    plan = NE._reduce_plan(N, F, sms)
    partial = np.zeros((plan.tiles, F, 27))
    for t in range(plan.tiles):
        v0 = t * plan.voxels
        v1 = min(N, v0 + plan.voxels)
        for f in range(F):
            lanes = [terms[v0 + l:v1:plan.lanes, f].sum(axis=0) if v0 + l < v1
                     else np.zeros(27) for l in range(plan.lanes)]
            partial[t, f] = np.sum(lanes, axis=0)
    ways = NE.REDUCE_THREADS // 27
    total = np.sum([partial[j::ways].sum(axis=0) for j in range(ways)], axis=0)
    np.testing.assert_allclose(total, terms.sum(axis=0), rtol=1e-12, atol=1e-12)
