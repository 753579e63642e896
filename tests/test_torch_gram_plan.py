"""The tracker Gram's host plan (ops/gn.gram_plan) on the CPU: a function of
the pixel count and the SM count alone, whole clusters of GRAM_CLUSTER
blocks, at most one block an SM, every pixel in one block's tile and one
chunk of its ring once (the kernel's loops emulated), and the CPU path's
launches.  The kernel is held against gram_plain on the card by
chip_smoke.py (phase scan_kernels)."""

import numpy as np
import pytest
import torch

from psgradientsdf_tpu_torch.ops import gn as G

PIXELS = [1, 100, 8191, 8192, 8193, 19200, 76800, 307200, 1228800]
SMS = [1, 8, 16, 100, 132, 144]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n", PIXELS)
def test_plan_is_whole_clusters_at_most_one_block_an_sm(n, sms):
    plan = G.gram_plan(n, sms)
    assert plan == G.gram_plan(n, sms)
    assert plan.cluster == G.GRAM_CLUSTER
    assert plan.blocks == plan.clusters * plan.cluster
    per_cluster = G.GRAM_CLUSTER * G.GRAM_THREADS * G.GRAM_PIX
    assert plan.clusters == max(1, min(sms // G.GRAM_CLUSTER, -(-n // per_cluster)))
    assert plan.blocks <= max(sms, G.GRAM_CLUSTER)
    assert plan.tile == -(-n // plan.blocks)
    assert plan.blocks * plan.tile >= n > (plan.tile - 1) * plan.blocks


def test_plan_at_640x480_on_an_h100():
    assert G.gram_plan(640 * 480, 132) == G.GramPlan(8, 16, 128, 2400)


@pytest.mark.parametrize("n", [1, 1000, 76800, 307200, 1228800])
def test_the_tiles_and_chunks_cover_every_pixel_once(n):
    """csrc/gn.cu gn_gram_kernel: block b's tile [b tile, (b + 1) tile) cut
    to n, its chunks of GRAM_THREADS x GRAM_PIX pixels, thread k's pixels
    of a chunk k + q GRAM_THREADS, q < GRAM_PIX."""
    plan = G.gram_plan(n, 132)
    chunk = G.GRAM_THREADS * G.GRAM_PIX
    seen = np.zeros(n, np.int64)
    for b in range(plan.blocks):
        begin = b * plan.tile
        count = max(0, min(plan.tile, n - begin))
        for c in range(-(-count // chunk)):
            l = c * chunk + np.arange(chunk)           # every (q, thread) of the chunk
            l = l[l < count]
            np.add.at(seen, begin + l, 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("args", [(0, 132), (10, 0)])
def test_plan_refuses_no_pixels_or_sms(args):
    with pytest.raises(ValueError):
        G.gram_plan(*args)


def test_a_cpu_gram_launches_nothing_and_is_the_plain_gram():
    rng = np.random.default_rng(3)
    depth = torch.from_numpy((0.5 + rng.random((12, 16))).astype(np.float32))
    K = torch.tensor([[20.0, 0.0, 7.5], [0.0, 20.0, 5.5], [0.0, 0.0, 1.0]])
    frame = G.GnFrame(None, depth, K, stride=1, zmin=0.1, zmax=5.0)
    g = rng.standard_normal((frame.n, 3))
    rec = np.concatenate([0.01 * rng.standard_normal((frame.n, 1)),
                          g / np.linalg.norm(g, axis=1, keepdims=True),
                          rng.standard_normal((frame.n, 3)),
                          rng.random((frame.n, 1)) > 0.2], 1).astype(np.float32)
    records = torch.from_numpy(rec)
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([0.01, -0.02, 0.03])
    G.reset_launch_counts()
    S = G.gram(frame, pose, records)
    assert torch.equal(S, G.gram_plain(frame.points()[0], pose, G.unpack_records(records)))
    assert G.launch_counts == {"gn_solve": 0, "gn_gram": 0}
