"""The one-card scan as the CUDA graph replays it (tracking/graph.py), held
against the JAX package on the CPU, where no graph is made and the same
static buffers run eagerly.

  * The frame id on the device: ops/fuse.fuse_rows' plain version with the
    frame as an int32 device scalar picks the visibility word and ORs the
    bit into the table's rows in place, at ids 0, 31 (the sign bit), 32 and
    63, against the JAX package's fuse_frame_culled and fuse_frame with a
    traced frame_idx: visibility words exact, float state within
    test_torch_volume.py's tolerances; and bit for bit against the host-id
    form, which moves the frame's word through the row copies.
  * process_chunk through the rotation of static buffers (no graph) against
    the JAX package's process_chunk over three chunks, a ragged tail and an
    overflow redo, within test_torch_stream_pipeline.py's tolerances; the
    pipeline through the rotation bit for bit against the chunks without it.
  * The capture key (a grown capacity makes a new graph, the same key
    none), the replay arithmetic of the launch counts, and a keyframe's
    device image, which must outlive the staging buffer it came from.
"""

import functools
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from psgradientsdf_tpu.core import volume as jvolume
from psgradientsdf_tpu.tracking import stream as jstream
from psgradientsdf_tpu_torch import convert
from psgradientsdf_tpu_torch.core import volume as tvolume
from psgradientsdf_tpu_torch.ops import cull, fuse, gn, preprocess, rowcopy
from psgradientsdf_tpu_torch.tracking import graph as sgraph
from psgradientsdf_tpu_torch.tracking import stream as tstream
from psgradientsdf_tpu_torch.tracking import tracker
from psgradientsdf_tpu_torch.utils import capture

from helpers_torch import (
    CPU, assert_vol_close, field_tolerances, geoms, intrinsics, se3_exp_np,
    to_torch_vol, wavy_frame,
)

torch.set_num_threads(1)

ZKW = dict(zmin=0.1, zmax=5.0)
DEPTH = 1.5
ULPS_PER_FRAME = 4
FRAME_IDS = (0, 31, 32, 63)


def _scene32():
    H, W = 48, 64
    K = intrinsics(H, W, 50.0)
    jg, tg = geoms((32, 32, 32), 0.04, (0.013, -0.021, 1.2))
    return dict(jg=jg, tg=tg, K=K, fr=wavy_frame(H, W, K), T=5 * 0.04)


def _poses(n):
    rng = np.random.default_rng(11)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        xi = rng.uniform(-1, 1, 6) * np.array([0.05, 0.05, 0.05, 0.1, 0.1, 0.1])
        poses.append(se3_exp_np(xi))
    return poses


@functools.lru_cache(maxsize=None)
def _jax_fusers(jg, T, capacity):
    """JAX's culled and full-grid fusion jitted with frame_idx TRACED (an
    argument of the jitted function, not a constant)."""
    zkw = dict(truncation=T, **ZKW)

    def culled(vol, color, depth, normals, nsq, K, pose, fid):
        return jvolume.fuse_frame_culled(vol, jg, color, depth, normals, nsq, K,
                                         pose, fid, None, row_capacity=capacity, **zkw)

    def full(vol, color, depth, normals, nsq, K, pose, fid):
        return jvolume.fuse_frame(vol, jg, color, depth, normals, nsq, K, pose,
                                  fid, None, **zkw)

    return jax.jit(culled), jax.jit(full)


@pytest.mark.parametrize("fid", FRAME_IDS)
@pytest.mark.parametrize("culled", [True, False])
def test_device_frame_id_matches_jax_traced_frame_idx(fid, culled):
    """Two views fused, the frame id an int32 on the device (the form the
    graph replays) on the torch side and traced on the JAX side."""
    sc = _scene32()
    nseg = 32 * 32
    jculled, jfull = _jax_fusers(sc["jg"], sc["T"], nseg)
    jv = jvolume.make_volume(sc["jg"], sc["T"], frame_cap=64)
    tv = tvolume.make_volume(sc["tg"], sc["T"], frame_cap=64, device=CPU)
    th = tv
    keys = ("color", "depth", "normals", "n_sq_inv")
    args = [sc["fr"][k] for k in keys]
    kw = dict(truncation=sc["T"], device=CPU, **ZKW)
    for n, pose in enumerate(_poses(2)):
        f = (fid + n) % 64
        jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(sc["K"]), jnp.asarray(pose)]
        dev_id = torch.tensor(f, dtype=torch.int32)
        if culled:
            jv, jov = jculled(jv, *jargs, jnp.int32(f))
            tv, tov = tvolume.fuse_frame_culled(
                tv, sc["tg"], *args, sc["K"], pose, dev_id, row_capacity=nseg, **kw)
            th, _ = tvolume.fuse_frame_culled(
                th, sc["tg"], *args, sc["K"], pose, f, row_capacity=nseg, **kw)
            assert bool(tov) is bool(jov) is False
        else:
            jv = jfull(jv, *jargs, jnp.int32(f))
            tv = tvolume.fuse_frame(tv, sc["tg"], *args, sc["K"], pose, dev_id, **kw)
            th = tvolume.fuse_frame(th, sc["tg"], *args, sc["K"], pose, f, **kw)
        assert_vol_close(tv, jv, field_tolerances(DEPTH, sc["T"], ULPS_PER_FRAME * (n + 1)),
                         where=f"frame id {f}")
        for a, b in zip(tv, th):
            assert torch.equal(a, b), f
    words = convert.volume_to_numpy(tv)["vis"]
    assert words[fid // 32].any() and (words[fid // 32] & np.uint32(1 << fid % 32)).any()


def test_fuse_rows_device_frame_moves_the_word_outside_the_row_copies(monkeypatch):
    """With a device frame id the culled fusion's one gather call and one
    scatter call move the four float tables; fuse_rows reads and writes the
    frame's visibility word in the table."""
    sc = _scene32()
    calls = []
    for name in ("gather_tables_dma", "scatter_tables_dma"):
        real = getattr(tvolume.rowcopy, name)

        def wrapper(tables, idx, *a, _real=real, _name=name, **kw):
            calls.append((_name, len(tables)))
            return _real(tables, idx, *a, **kw)
        monkeypatch.setattr(tvolume.rowcopy, name, wrapper)
    tv = tvolume.make_volume(sc["tg"], sc["T"], frame_cap=64, device=CPU)
    args = [sc["fr"][k] for k in ("color", "depth", "normals", "n_sq_inv")]
    tv, _ = tvolume.fuse_frame_culled(
        tv, sc["tg"], *args, sc["K"], np.eye(4, dtype=np.float32),
        torch.tensor(40, dtype=torch.int32), row_capacity=1024, truncation=sc["T"],
        device=CPU, **ZKW)
    assert calls == [("gather_tables_dma", 4), ("scatter_tables_dma", 4)]
    words = convert.volume_to_numpy(tv)["vis"]
    assert words[1].any() and not words[0].any()


def test_vis_word_bit_on_the_device():
    for f in (0, 1, 31, 32, 63, 64, 200):
        word, bit = fuse.vis_word_bit(torch.tensor(f, dtype=torch.int32), 3)
        want_word, want_bit = tvolume._vis_word_bit(f)
        assert int(word) == min(want_word, 2) and int(bit) == want_bit
        assert bit.dtype == torch.int32


# ------------------------------------------------------------ the rotation


from test_torch_stream_pipeline import (  # noqa: E402
    H, TRACK, UNIT, W, MemoryLoader, _assert_results, _build_scene, _xi,
    assert_vol_fraction,
)

ZKW_S = dict(truncation=0.1, zmin=0.1, zmax=5.0)
C = 2
# the chunks' frames (the scene's; the last chunk ragged) and their first
# frame ids.  Tracked straight from frame 2's pose, the scene's frame 3
# sits on the tracker's stop at a step of 1e-3 (some 30-50 steps on both
# sides, which may stop apart, ROADMAP §3); the chain fuses frame 2 again
# first, as a handheld scan passes a view twice, and the ragged chunk
# holds frame 3 once more; frame ids 1-5
CHUNKS = (((1, 2), 1), ((2, 3), 3), ((3,), 5))


@pytest.fixture(scope="module")
def scene():
    return _build_scene()


def _chunk_frames(scene, ids, first_id=None):
    """The scene's frames `ids` (1-based), padded to a chunk of C, their
    frame ids from `first_id` on (by default `ids`)."""
    n = len(ids)
    sel = [i - 1 for i in ids] + [ids[-1] - 1] * (C - n)
    own = list(ids) if first_id is None else list(range(first_id, first_id + n))
    fids = np.array(own + [0] * (C - n), np.int32)
    valid = np.array([True] * n + [False] * (C - n))
    return scene["colors"][sel], scene["depths"][sel], fids, valid


def _torch_chunk(scene, vol, pose, frames, cap, rotation=None):
    colors, depths, fids, valid = frames
    gtp = np.broadcast_to(np.eye(4, dtype=np.float32), (C, 4, 4)).copy()
    return tstream.process_chunk(
        vol, scene["tg"], colors, depths, scene["K"], pose, fids, valid, gtp,
        scene["tf"], depth_unit=UNIT, fuse_row_capacity=cap, rotation=rotation,
        device=CPU, **ZKW_S, **TRACK)


def _jax_chunk(scene, tvol, pose, frames, cap):
    """JAX's process_chunk from the torch side's state and pose."""
    colors, depths, fids, valid = frames
    gtp = np.broadcast_to(np.eye(4, dtype=np.float32), (C, 4, 4)).copy()
    from helpers_torch import to_jax_vol
    return jstream.process_chunk(
        to_jax_vol(tvol), scene["jg"], jnp.asarray(colors), jnp.asarray(depths),
        jnp.asarray(scene["K"]), jnp.asarray(np.asarray(pose, np.float32)),
        jnp.asarray(fids), jnp.asarray(valid), jnp.asarray(gtp), scene["jf"],
        depth_unit=UNIT, fuse_row_capacity=cap, **ZKW_S, **TRACK)


def test_rotation_chunks_match_jax_with_ragged_tail_and_overflow_redo(scene):
    """Three chunks through the rotation's slots (the third ragged), each
    against JAX's process_chunk from the same state.  The second chunk is
    first run at a capacity that overflows and the third staged on top of
    it, as the pipeline stages the next chunk before it reads a chunk's
    flags; both are then redone from the kept pre-chunk volume at a roomy
    capacity, and the redone slots equal a run without the rotation bit for
    bit."""
    eye = np.eye(4, dtype=np.float32)
    frames = [_chunk_frames(scene, ids, first) for ids, first in CHUNKS]
    v0 = to_torch_vol(scene["jv"])
    before = convert.volume_to_numpy(v0)
    rot = sgraph.ScanRotation(v0, C)
    assert not rot.capture            # no graph on the CPU

    v1, r1 = _torch_chunk(scene, v0, eye, frames[0], 2048, rot)
    assert rot.source_of(v1) == 0 and rot.source_of(v0) is None
    (jv1, jr1) = _jax_chunk(scene, v0, eye, frames[0], 2048)
    _assert_results(jr1, r1, 2)
    assert_vol_fraction(v1, jv1)
    # the chunk's volume from outside is left as it was
    for k, a in convert.volume_to_numpy(v0).items():
        np.testing.assert_array_equal(a, before[k])

    # chunk 2 overflows; chunk 3 is staged on top before its flags are read
    tight, r2 = _torch_chunk(scene, v1, r1.poses[1], frames[1], 256, rot)
    assert tstream.read_result(r2)["fuse_overflow"].any()
    _torch_chunk(scene, tight, r2.poses[1], frames[2], 256, rot)
    assert rot.source_of(tight) == 1
    # the redo: from chunk 2's kept pre-chunk volume (slot 0) at room
    v2, r2 = _torch_chunk(scene, v1, r1.poses[1], frames[1], 2048, rot)
    assert v2.dist.data_ptr() == tight.dist.data_ptr()
    jv2, jr2 = _jax_chunk(scene, v1, r1.poses[1].numpy(), frames[1], 2048)
    _assert_results(jr2, r2, 2)
    assert_vol_fraction(v2, jv2)
    v3, r3 = _torch_chunk(scene, v2, r2.poses[1], frames[2], 2048, rot)
    assert rot.source_of(v3) == 2
    jv3, jr3 = _jax_chunk(scene, v2, r2.poses[1].numpy(), frames[2], 2048)
    _assert_results(jr3, r3, 1)
    assert_vol_fraction(v3, jv3)

    # the same three chunks with no rotation, bit for bit
    w, pose = v0, eye
    for f, (v, r) in zip(frames, ((v1, r1), (v2, r2), (v3, r3))):
        w, q = _torch_chunk(scene, w, pose, f, 2048)
        for a, b in zip(w, v):
            assert torch.equal(a, b)
        for a, b in zip(q[:8], r[:8]):
            assert torch.equal(a, b)
        assert torch.equal(q.readout, r.readout)
        pose = q.poses[C - 1]
    host = tstream.read_result(r3)
    np.testing.assert_array_equal(host["poses"], r3.poses.numpy())
    np.testing.assert_array_equal(host["iterations"], r3.iterations.numpy())
    assert rot.stats()["captures"] == 0 and rot.stats()["eager_chunks"] == 5


def test_rotation_rejects_what_it_does_not_serve(scene):
    v0 = to_torch_vol(scene["jv"])
    rot = sgraph.ScanRotation(v0, C)
    eye = np.eye(4, dtype=np.float32)
    with pytest.raises(ValueError, match="one-device culled"):
        _torch_chunk(scene, v0, eye, _chunk_frames(scene, (1, 2)), 0, rot)
    with pytest.raises(ValueError, match="a chunk of 3 frames"):
        tstream.process_chunk(
            v0, scene["tg"], scene["colors"][:3], scene["depths"][:3], scene["K"],
            eye, np.arange(3, dtype=np.int32), np.ones(3, bool),
            np.zeros((3, 4, 4), np.float32), scene["tf"], depth_unit=UNIT,
            fuse_row_capacity=2048, rotation=rot, device=CPU, **ZKW_S)


# ------------------------------------------------------- keys and replays


class _FakeCaptured:
    """Stands in for utils/capture.Captured off the card: records what was
    captured, replayed and released."""
    log = []

    def __init__(self, body, device, stream, dicts):
        self.key = sum(e[0] == "capture" for e in _FakeCaptured.log)
        _FakeCaptured.log.append(("capture", self.key))
        self.capture_seconds = 0.0

    def replay(self):
        _FakeCaptured.log.append(("replay", self.key))

    def release(self):
        _FakeCaptured.log.append(("release", self.key))


def test_capture_keys_and_the_warm_up(monkeypatch):
    """The first chunk runs eagerly (the warm-up); a key is captured once
    and replayed after that; a chunk that is not graphable, a volume from
    outside the rotation or a capacity not yet run eagerly runs eagerly; a
    grown capacity makes new keys and releases the old ones."""
    monkeypatch.setattr(capture, "Captured", _FakeCaptured)
    _FakeCaptured.log = []
    vol = tvolume.make_volume(geoms((8, 8, 8), 0.1, (0, 0, 1))[1], 0.3, device=CPU)
    rot = sgraph.ScanRotation(vol, 2)
    rot.capture = True                # as on a card
    ran = []

    def chunk(source, target, cap, graphable=True):
        rot.run(sgraph.ScanKey(source, target, cap, ("static",)),
                lambda: ran.append((source, target, cap)), graphable)

    chunk(None, 0, 256)               # the warm-up, eager
    chunk(0, 1, 256)                  # captured, replayed
    chunk(1, 2, 256)
    chunk(2, 0, 256)
    chunk(0, 1, 256)                  # replayed only
    chunk(1, 2, 256, graphable=False)  # a ragged chunk: eager
    chunk(0, 1, 384)                  # a grown capacity: eager first (its redo)
    chunk(1, 2, 384)                  # captured; the 256 graphs released
    chunk(1, 2, 384)
    assert ran == [(None, 0, 256), (1, 2, 256), (0, 1, 384)]
    assert _FakeCaptured.log == [
        ("capture", 0), ("replay", 0), ("capture", 1), ("replay", 1),
        ("capture", 2), ("replay", 2), ("replay", 0),
        ("release", 0), ("release", 1), ("release", 2),
        ("capture", 3), ("replay", 3), ("replay", 3)]
    assert rot.stats()["captures"] == 4 and rot.stats()["replays"] == 6
    assert rot.stats()["eager_chunks"] == 3
    assert sorted(k.capacity for k in rot.graphs) == [384]


def test_replay_adds_the_captured_scan_counts():
    """A chunk's capture counts each wrapper's launches once; every replay
    adds that difference to the scan's counters and a registered caller's,
    the counts before the capture restored: after k replays each is k times
    the chunk's (as refine/graph.py's iteration)."""
    mine = {"chunks": 0}
    for m in (gn, fuse, cull, rowcopy, preprocess):
        m.reset_launch_counts()
    tracker.steps_run["track_frame"] = 0
    with capture.registered(mine):
        dicts = sgraph.counters()
        assert mine in dicts and tracker.steps_run in dicts
        snap = capture.snapshot(dicts)
        # what a capture of one chunk of 8 tracked frames adds
        gn.launch_counts["gn_solve"] += 8
        fuse.launch_counts["fuse_rows"] += 8
        cull.launch_counts["cull_compact"] += 8
        rowcopy.launch_counts["gather_rows_dma"] += 8
        rowcopy.launch_counts["scatter_rows_dma"] += 8
        preprocess.launch_counts["fals_normals"] += 1
        preprocess.launch_counts["lapm"] += 1
        tracker.steps_run["track_frame"] += 8
        mine["chunks"] += 1
        diff = capture.difference(snap)
        capture.restore(snap)
        assert gn.launch_counts["gn_solve"] == 0 and mine["chunks"] == 0
        g = capture.Captured.__new__(capture.Captured)
        replays = []
        g.device, g.counts = -1, diff
        g.graph = types.SimpleNamespace(replay=lambda: replays.append(1))
        for _ in range(3):
            g.replay()
    assert replays == [1, 1, 1]
    assert gn.launch_counts["gn_solve"] == 24 and fuse.launch_counts["fuse_rows"] == 24
    assert cull.launch_counts["cull_compact"] == 24
    assert rowcopy.launch_counts["gather_rows_dma"] == 24
    assert preprocess.launch_counts == {"fals_normals": 3, "lapm": 3}
    assert tracker.steps_run["track_frame"] == 24 and mine["chunks"] == 3
    assert all(c is not mine for c in sgraph.counters())
    for m in (gn, fuse, cull, rowcopy, preprocess):
        m.reset_launch_counts()
    tracker.steps_run["track_frame"] = 0


def test_no_graph_off_the_card():
    vol = tvolume.make_volume(geoms((8, 8, 8), 0.1, (0, 0, 1))[1], 0.3, device=CPU)
    with pytest.raises(ValueError, match="needs a card"):
        capture.Captured(lambda: None, torch.device("cpu"), None, [])
    rot = sgraph.ScanRotation(vol, 2, capture=True)
    assert not rot.capture and rot.stream is None


# ------------------------------------------------------------ the pipeline


def test_pipeline_keyframe_images_outlive_the_staging(scene, tmp_path):
    """Nine frames in chunks of two: the rotation's slot 0 stages frames 1-2,
    then 7-8.  Every keyframe's device image still equals its frame after
    its staging slot was filled again, the scan ran in the rotation with no
    graph, and it equals the pipeline with capture off bit for bit."""
    import json
    from psgradientsdf_tpu_torch.config import load_config
    from psgradientsdf_tpu_torch.pipeline import ReconstructionPipeline

    K = scene["K"]
    frames = [wavy_frame(H, W, K)] + [wavy_frame(H, W, K, se3_exp_np(_xi(i)))
                                      for i in range(1, 9)]
    colors = np.stack([np.clip(f["color"] * 255, 0, 255).astype(np.uint8) for f in frames])
    depths = np.stack([np.clip(f["depth"] / UNIT, 0, 65535).astype(np.uint16)
                       for f in frames])
    runs = {}
    for cap in (True, False):
        root = tmp_path / str(cap)
        root.mkdir()
        out = str(root / "out") + "/"
        (root / "cfg.json").write_text(json.dumps({
            "input": "", "output": out, "datatype": "tum", "first": 0, "last": 8,
            "voxel size": 0.02, "truncation factor": 5, "zmin": 0.1, "zmax": 5.0,
            "sharpness threshold": 0.0, "grid dim": 64, "chunk size": C,
            "fuse rows": 0.9}))
        pipe = ReconstructionPipeline(load_config(str(root / "cfg.json")),
                                      loader=MemoryLoader(K, colors, depths, UNIT),
                                      device=CPU, capture=cap)
        summary = pipe.run(refine=False)
        runs[cap] = (pipe, summary, open(out + "tracking_poses.txt").read())
    pipe, summary, poses = runs[True]
    assert summary["scan_graph"]["eager_chunks"] == 4
    assert summary["scan_graph"]["captures"] == 0 and not summary["scan_graph"]["graph"]
    assert len(pipe.key_images_dev) == len(pipe.key_indices)
    # frames 1 and 2 were staged in slot 0, which frames 7 and 8 then filled
    assert {1, 2} <= set(pipe.key_indices)
    for idx, img in zip(pipe.key_indices, pipe.key_images_dev):
        assert torch.equal(img, torch.from_numpy(colors[idx])), idx
    off, _, poses_off = runs[False]
    assert poses == poses_off
    for a, b in zip(pipe.vol, off.vol):
        assert torch.equal(a, b)
