"""dist_cg's host plan (ops/distcg._cg_plan): the tiles cover the rows once,
in order, on 16-row starts; a block's shared memory stays within the card's;
the layout moves from TILE to VECTORS to GLOBAL at the first row count whose
tile does not fit; the grid barriers a step and the update stage's one
after the last; one row, and fewer rows than blocks.  Pure host arithmetic: the kernel's launch on the card is held by
chip_smoke.py (phase dist_cg_kernels)."""

import pytest

from psgradientsdf_tpu_torch.ops import distcg as D

SMS = 132                      # an H100's SMs
ROWS = [1, 15, 16, 17, 100, 2111, 49152, 4 * 49152, 8 * 49152, 1_100_000]
LAPS = [(False, False), (True, False), (True, True)]
REGIONS = ("A", "nbr", "rev", "lap", "valid")


def _plan(N, lap, sms=SMS):
    use_lap, lap_nbr = lap
    return D._cg_plan(N, use_lap=use_lap, lap_nbr=lap_nbr, sms=sms)


@pytest.mark.parametrize("lap", LAPS, ids=["no-lap", "lap-diag", "lap-nbr"])
@pytest.mark.parametrize("N", ROWS)
def test_tiles_cover_the_rows_once_in_order(N, lap):
    plan = _plan(N, lap)
    assert 1 <= plan.blocks <= SMS
    assert plan.tile % D.TILE_ROWS == 0
    starts = [b * plan.tile for b in range(plan.blocks)]
    ends = [min(N, s + plan.tile) for s in starts]
    assert starts[0] == 0 and ends[-1] == N
    assert all(e > s for s, e in zip(starts, ends))            # no empty block
    assert all(a == b for a, b in zip(ends[:-1], starts[1:]))   # contiguous
    assert sum(e - s for s, e in zip(starts, ends)) == N
    # the tile is no larger than the even split needs
    assert plan.tile - D.TILE_ROWS < -(-N // plan.blocks)


@pytest.mark.parametrize("lap", LAPS, ids=["no-lap", "lap-diag", "lap-nbr"])
@pytest.mark.parametrize("N", ROWS)
def test_shared_memory_regions(N, lap):
    """Every region starts on 16 bytes past the header, none overlaps, all
    lie within the block's shared memory, which stays within the card's."""
    plan = _plan(N, lap)
    nbr_term = lap[0] and lap[1]
    assert D._HEADER <= plan.smem_bytes <= D.SMEM_PER_BLOCK
    vec_bytes = 4 * D._own_vectors(nbr_term) * plan.tile
    sizes = dict(D._ROW_BYTES, lap=D._LAP_BYTES if nbr_term else 0)
    spans = []
    if plan.mode == D.TILE:
        for name in REGIONS:
            off = getattr(plan, name)
            if sizes[name]:
                spans.append((off, off + sizes[name] * plan.tile))
            else:
                assert off == 0
        assert plan.smem_bytes == D._HEADER + plan.tile * D._row_bytes(nbr_term)
    else:
        assert all(getattr(plan, name) == 0 for name in REGIONS)
    if plan.mode in (D.TILE, D.VECTORS):
        spans.append((plan.vec, plan.vec + vec_bytes))
    else:
        assert plan.vec == 0 and plan.smem_bytes == D._HEADER
    spans.sort()
    for lo, hi in spans:
        assert lo % 16 == 0 and lo >= D._HEADER and hi <= plan.smem_bytes
    assert all(a[1] <= b[0] for a, b in zip(spans[:-1], spans[1:]))


@pytest.mark.parametrize("sms", [1, 7, SMS])
@pytest.mark.parametrize("lap", LAPS, ids=["no-lap", "lap-diag", "lap-nbr"])
def test_the_layout_switches_at_the_first_tile_that_does_not_fit(lap, sms):
    nbr_term = lap[0] and lap[1]
    tile_max, vec_max = D.resident_tile_limit(nbr_term), D.vector_tile_limit(nbr_term)
    assert tile_max % D.TILE_ROWS == 0 and vec_max % D.TILE_ROWS == 0
    at = _plan(sms * tile_max, lap, sms)
    past = _plan(sms * tile_max + 1, lap, sms)
    assert at.mode == D.TILE and at.tile == tile_max
    assert at.smem_bytes <= D.SMEM_PER_BLOCK
    # one more row of shared memory a row would not fit
    assert at.smem_bytes + D.TILE_ROWS * D._row_bytes(nbr_term) > D.SMEM_PER_BLOCK
    assert past.mode == D.VECTORS and past.tile == tile_max + D.TILE_ROWS
    at = _plan(sms * vec_max, lap, sms)
    past = _plan(sms * vec_max + 1, lap, sms)
    assert at.mode == D.VECTORS and at.smem_bytes <= D.SMEM_PER_BLOCK
    assert past.mode == D.GLOBAL and past.smem_bytes == D._HEADER


def test_the_limits_at_an_h100():
    """The tile's limits: 121 bytes a row (149 under the Laplacian's
    neighbour term) resident, 44 (48) for the s rows and vectors alone; the
    main problem in 128 tiles of 384 rows, four copies of it still
    resident, eight not."""
    assert D._row_bytes(False) == 121 and D._row_bytes(True) == 149
    assert (D.resident_tile_limit(False), D.resident_tile_limit(True)) == (1904, 1552)
    assert (D.vector_tile_limit(False), D.vector_tile_limit(True)) == (5264, 4832)
    main = _plan(49152, (False, False))
    assert (main.blocks, main.tile, main.mode) == (128, 384, D.TILE)
    assert _plan(4 * 49152, (False, False)).mode == D.TILE
    assert _plan(8 * 49152, (False, False)).mode == D.VECTORS


@pytest.mark.parametrize("N", [1, 3, 4, 49152, 49153, 8 * 49152, 700_000])
def test_work_buffer(N):
    """dist_cg's work buffer: 5 floats a row published; TILE's tables
    (18 floats a row) from a 16-byte boundary; GLOBAL's 12 own floats."""
    plan = _plan(N, (False, False))
    want = {D.TILE: -(-5 * N // 4) * 4 + 18 * N, D.VECTORS: 5 * N, D.GLOBAL: 17 * N}
    assert D._work_floats(plan, N) == want[plan.mode]


@pytest.mark.parametrize("lap,want", zip(LAPS + [(False, True)], [2, 2, 3, 2]))
def test_grid_barriers_a_step(lap, want):
    assert _plan(49152, lap).barriers == want


@pytest.mark.parametrize("lap", LAPS, ids=["no-lap", "lap-diag", "lap-nbr"])
@pytest.mark.parametrize("N", ROWS)
def test_the_update_stage_adds_one_barrier_after_the_last_step(N, lap):
    """With the update stage (dist_cg_update) the plan is the same launch
    (grid, tile, layout, shared memory, barriers a step) and one grid
    barrier more after the last step, in every layout."""
    use_lap, lap_nbr = lap
    plain = _plan(N, lap)
    fused = D._cg_plan(N, use_lap=use_lap, lap_nbr=lap_nbr, sms=SMS, update=True)
    assert (plain.tail, fused.tail) == (0, 1)
    assert fused._replace(tail=0) == plain
    for steps in (0, 1, 12, 100):
        assert D.grid_barriers(plain, steps) == 1 + plain.barriers * steps
        assert D.grid_barriers(fused, steps) == D.grid_barriers(plain, steps) + 1


def test_the_rows_reach_every_layout():
    modes = {_plan(N, lap).mode for N in ROWS for lap in LAPS}
    assert modes == {D.TILE, D.VECTORS, D.GLOBAL}


@pytest.mark.parametrize("N", [1, 2, 16, 17, 31, 100, 131 * 16])
def test_one_row_and_fewer_rows_than_blocks(N):
    plan = _plan(N, (False, False))
    assert plan.blocks == min(SMS, -(-N // D.TILE_ROWS))
    assert plan.tile == D.TILE_ROWS and plan.mode == D.TILE
    assert (plan.blocks - 1) * plan.tile < N <= plan.blocks * plan.tile


@pytest.mark.parametrize("N,sms", [(0, SMS), (-3, SMS), (10, 0)])
def test_no_plan_without_rows_or_sms(N, sms):
    with pytest.raises(ValueError):
        D._cg_plan(N, use_lap=False, lap_nbr=False, sms=sms)
