#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA Hopper card.

    python3 chip_smoke.py [--profile | --kernels-only]

Builds the package's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, drives the scan (track -> culled fuse ->
keyframes -> initial export) through ReconstructionPipeline at the
reference's operating point (640x480 frames into a 128^3 grid) on a synthetic
handheld sequence made with numpy from a fixed seed, and checks the result.

Every phase prints one JSON object on a line of its own.  Any failed check,
build error or exception ends the run with a non-zero exit code; there is no
CPU path.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}.

With --profile one more phase traces a short scan with torch.profiler and
prints the card's busy share of it and the kernels that take the most device
time; the run is otherwise the same.

With --kernels-only the run stops after the kernels phase (build, checks
and times of the kernels, about fifteen seconds): a quick look at a changed
kernel.  It drives no path, so it prints no final "ok" line and exits with 3.

Imports numpy, torch and the package; needs no image decoder and no network.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20240611
W, H = 640, 480
GRID = 128
VOXEL = 1.8 / GRID                  # the 128^3 grid spans 1.8 m
FRAMES = 48                         # frame 0 places the volume, 47 are tracked
CHUNK = 8
DEPTH_UNIT = 1.0 / 5000.0           # uint16 depth wire format, as TUM RGB-D
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
KERNEL_REPS = 20

KERNELS = {
    # wrapper in ops/rowcopy.py: the TPU kernel it replaces (file:line of the
    # pallas_call)
    "gather_rows_dma": "psgradientsdf_tpu/ops/rowcopy.py:198",
    "scatter_rows_dma": "psgradientsdf_tpu/ops/rowcopy.py:257",
    "gather_rows": "psgradientsdf_tpu/ops/rowcopy.py:104",
    "scatter_rows": "psgradientsdf_tpu/ops/rowcopy.py:142",
}
SOURCE = "psgradientsdf_tpu_torch/csrc/rowcopy.cu"


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields), default=float), flush=True)


# ---------------------------------------------------------------- the scene


def _g(x, y):
    return 1.2 + 0.08 * np.sin(6 * x) * np.cos(5 * y) + 0.05 * np.sin(3 * (x + y))


def _look_at(pos, target, roll):
    f = target - pos
    f = f / np.linalg.norm(f)
    r = np.cross(np.array([0.0, 1.0, 0.0]), f)
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    cr, sr = np.cos(roll), np.sin(roll)
    T = np.eye(4)
    T[:3, :3] = np.stack([cr * r + sr * d, -sr * r + cr * d, f], axis=1)
    T[:3, 3] = pos
    return T


def handheld_trajectory(n, rng):
    """The first n poses of a slow 120-frame orbit over a desk-sized scene
    with hand tremor and swings of the viewing direction."""
    poses = []
    for f in range(n):
        th = 2 * np.pi * f / 120.0
        pos = np.array([0.25 * np.sin(th), 0.18 * np.sin(th) * np.cos(th),
                        0.10 * np.cos(th) - 0.10])
        target = np.array([0.10 * np.sin(2 * th), 0.10 * np.cos(3 * th), 1.25])
        burst = np.exp(-0.5 * ((np.sin(2 * th) / 0.25) ** 2))
        target = target + burst * np.array(
            [0.10 * np.sin(9 * th), 0.08 * np.cos(7 * th), 0.0])
        roll = 0.06 * np.sin(2 * th) + 0.03 * burst * np.sin(11 * th)
        pos = pos + rng.normal(0.0, 0.0005, 3)
        poses.append(_look_at(pos, target, roll))
    return poses


def render(pose, rng):
    """Ray-march the wavy heightfield z = g(x, y) from `pose` -> (RGB uint8
    [H,W,3], depth uint16 [H,W] in DEPTH_UNIT metres with 1 mm noise)."""
    fx = fy = 0.9 * W
    cx, cy = W / 2.0 - 0.37, H / 2.0 + 0.21
    u = np.arange(W, dtype=np.float64)[None, :]
    v = np.arange(H, dtype=np.float64)[:, None]
    x0 = np.broadcast_to((u - cx) / fx, (H, W))
    y0 = np.broadcast_to((v - cy) / fy, (H, W))
    R, t = pose[:3, :3], pose[:3, 3]
    dir_w = np.stack([x0, y0, np.ones_like(x0)], axis=-1) @ R.T
    s = np.full((H, W), 1.2)
    for _ in range(30):
        p = t + s[..., None] * dir_w
        s = (_g(p[..., 0], p[..., 1]) - t[2]) / dir_w[..., 2]
    p = t + s[..., None] * dir_w
    x, y = p[..., 0], p[..., 1]
    rgb = np.stack([0.5 + 0.3 * np.sin(40 * x) * np.cos(31 * y),
                    0.5 + 0.3 * np.cos(27 * y),
                    0.5 + 0.25 * np.sin(35 * (x + y))], axis=-1)
    depth = s + rng.normal(0.0, 0.001, s.shape)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)
    return (K, np.clip(rgb * 255.0, 0, 255).astype(np.uint8),
            np.clip(depth / DEPTH_UNIT, 0, 65535).astype(np.uint16))


def make_sequence(n):
    rng = np.random.default_rng(SEED)
    gt = handheld_trajectory(n, rng)
    K, colors, depths = None, [], []
    for pose in gt:
        K, c, d = render(pose, rng)
        colors.append(c)
        depths.append(d)
    # the pipeline starts at the identity: ground truth relative to frame 0
    inv0 = np.linalg.inv(gt[0])
    return K, colors, depths, [inv0 @ p for p in gt]


def memory_loader(K, colors, depths):
    """An ImageLoader that holds its frames in memory in the wire format, so
    the run needs no image files and no decoder."""
    from psgradientsdf_tpu_torch.io.loaders import ImageLoader

    class MemoryLoader(ImageLoader):
        unit = DEPTH_UNIT

        def __init__(self):
            super().__init__("")
            self.K = np.asarray(K, np.float32)

        def load_intrinsics(self, filename="intrinsics.txt"):
            return True

        def load_pose(self, filename):
            return None                      # no ground truth: tracking runs

        def reset(self):
            pass

        @staticmethod
        def _stamp(idx):
            return f"{1000.0 + idx / 30.0:.4f}"

        def frame_paths(self, idx):
            if idx >= len(colors):
                return None
            return "", "", self._stamp(idx), self._stamp(idx)

        def read_frame(self, idx, raw=False):
            if idx >= len(colors):
                return None
            color, depth = colors[idx], depths[idx]
            if not raw:
                color = color.astype(np.float32) / 255.0
                depth = depth.astype(np.float32) * np.float32(self.unit)
            return color, depth, self._stamp(idx), self._stamp(idx)

    return MemoryLoader()


# ------------------------------------------------------------- the kernels


def _bits_equal(a, b):
    import torch

    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _abs_err(a, b):
    if a.dtype.is_floating_point:
        return float((a - b).abs().max())
    return float((a.long() - b.long()).abs().max())


def _time_ms(fn, flush):
    """Median device time of one call over KERNEL_REPS repetitions.  Each
    repetition first overwrites a buffer several times the size of the L2
    cache: that leaves the rows cold, as the fusion finds them (hundreds of
    MB pass between two row moves), and it keeps the card busy while the host
    enqueues the start event, the call and the end event, so the interval
    between the two events holds the call's device work and not the host's
    launch latency."""
    import torch

    for _ in range(3):
        fn()
    times = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(KERNEL_REPS):
        torch.cuda.synchronize()
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _case(rowcopy, name, table, idx, rows):
    """Run kernel `name` and its plain version on copies of the same tensors
    -> (kernel result, plain result)."""
    if name in ("gather_rows_dma", "gather_rows"):
        return (getattr(rowcopy, name)(table, idx),
                rowcopy.gather_rows_plain(table, idx))
    plain = (rowcopy.scatter_rows_dma_plain if name == "scatter_rows_dma"
             else rowcopy.scatter_rows_plain)
    return (getattr(rowcopy, name)(table.clone(), idx, rows),
            plain(table.clone(), idx, rows))


def _make(gen, n, r, cap, dtype, idx_dtype, misalign=False):
    """table [n,r], idx [cap] with duplicates, rows [cap,r] on the card.
    `identical` rows (rows[i] = source[idx[i]]) serve the direct scatter,
    whose duplicates must carry identical bytes; `rows` differ per slot."""
    import torch

    def rand(shape):
        if dtype == torch.float32:
            return torch.randn(shape, generator=gen, device="cuda")
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             device="cuda", dtype=torch.int64).to(torch.int32)

    if misalign:     # contiguous, but 4 bytes off the 16-byte alignment
        table = rand((n * r + 1,))[1:].view(n, r)
    else:
        table = rand((n, r))
    idx = torch.randint(0, n, (cap,), generator=gen, device="cuda").to(idx_dtype)
    if cap > 1:
        idx[cap // 2:] = idx[: cap - cap // 2].clone()   # duplicates
    rows = rand((cap, r))
    identical = rand((n, r))[idx.long()].contiguous()
    return table, idx, rows, identical


# one fused frame gathers, and writes back, five row tables with one index
# vector: dist, grad, weight, colour and the frame's visibility word
# (core/volume.py)
FRAME_TABLES = [(128, "float32"), (384, "float32"), (128, "float32"),
                (384, "float32"), (128, "int32")]
GATHERS = {"gather_rows_dma": "gather_tables_dma",
           "gather_rows": "gather_tables"}
SCATTERS = {"scatter_rows_dma": "scatter_tables_dma",
            "scatter_rows": "scatter_tables"}


def _make_tables(gen, n, cap, specs, idx_dtype, misaligned=(), pattern="random"):
    """A list of tables [n, r] of the (r, dtype) in `specs` with one idx
    [cap], per-slot `rows`, `identical` rows (see _make) and the count of
    live slots (None: all).  Tables whose position is in `misaligned` start
    4 bytes off 16-byte alignment.
    pattern "random": random indices, the second half repeats the first.
    pattern "unique": every slot names a row of its own.
    pattern "fusion": what the culled fusion sends, ascending distinct rows,
    then padding slots that all repeat the first, and the count of the
    former as `live`."""
    import torch

    made = [_make(gen, n, r, cap, getattr(torch, dt), idx_dtype,
                  misalign=pos in misaligned)
            for pos, (r, dt) in enumerate(specs)]
    idx, live = made[0][1], None
    if pattern == "unique":
        idx = torch.randperm(n, generator=gen, device="cuda")[:cap].to(idx_dtype)
    if pattern == "fusion":
        n_live = (3 * cap) // 4
        distinct = torch.randperm(n, generator=gen, device="cuda")[:n_live]
        idx = torch.cat([distinct.sort().values,
                         distinct.min().expand(cap - n_live)]).to(idx_dtype)
        live = torch.tensor(n_live, dtype=torch.int64, device="cuda")
    # identical rows follow the shared idx: slot i carries row idx[i] of a pool
    identical = [_make(gen, n, r, 1, getattr(torch, dt), idx_dtype)[0]
                 [idx.long()].contiguous() for r, dt in specs]
    return [m[0] for m in made], idx, [m[2] for m in made], identical, live


def _check_tables_case(rowcopy, what, tables, idx, rows, identical, live):
    """Both multi-table gathers on `tables`, and both multi-table scatters on
    copies of them, against their plain versions, bit for bit -> cases
    checked.  With a count of live slots the scatter kernels must also leave
    out the slots past it: they are then given per-slot rows there, and held
    against the plain version of the live slots alone."""
    import torch

    n = 0
    want = rowcopy.gather_tables_plain(tables, idx)
    for multi in GATHERS.values():
        got = getattr(rowcopy, multi)(tables, idx)
        torch.cuda.synchronize()
        check(len(got) == len(tables), f"{multi}: {len(got)} row blocks")
        for pos, (g, w) in enumerate(zip(got, want)):
            check(g.dtype == w.dtype and g.shape == w.shape
                  and g.is_contiguous() and _bits_equal(g, w),
                  f"{multi} disagrees with its plain version on table "
                  f"{pos} of {what}")
        n += 1
    for name, multi in SCATTERS.items():
        runs = [(identical if name == "scatter_rows_dma" else rows, None, idx)]
        if live is not None:
            k = int(live)
            mixed = [torch.cat([a[:k], b[k:]]) for a, b in zip(identical, rows)]
            runs = [(identical, live, idx), (mixed, live, idx[:k])]
        for src, lv, plain_idx in runs:
            want = getattr(rowcopy, multi + "_plain")(
                [t.clone() for t in tables], plain_idx,
                [r[: plain_idx.shape[0]] for r in src])
            got = getattr(rowcopy, multi)(
                [t.clone() for t in tables], idx, src, live=lv)
            torch.cuda.synchronize()
            for pos, (g, w) in enumerate(zip(got, want)):
                check(_bits_equal(g, w),
                      f"{multi} disagrees with its plain version on table "
                      f"{pos} of {what}")
            n += 1
    return n


def check_kernels(rowcopy):
    """All four kernels against their plain versions on the card, bit for
    bit, at the main path's shapes and at awkward ones; times at the main
    path's shapes."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    n_main, cap_main = GRID * GRID, GRID * GRID // 2
    # the three distinct (width, type) pairs among a frame's five tables
    frame_tables = [(128, torch.float32), (128, torch.int32),
                    (384, torch.float32)]
    cases = [(n_main, r, cap_main, dt, torch.int32, False)
             for r, dt in frame_tables]
    cases += [(40, r, cap, dt, it, False)
              for r in (1, 33, 96) for cap in (1, 7, 513)
              for dt, it in ((torch.float32, torch.int32),
                             (torch.int32, torch.int64))]
    cases += [(40, 8, 513, torch.float32, torch.int32, True)]

    worst = {k: 0.0 for k in KERNELS}
    n_checked = 0
    for n, r, cap, dt, it, mis in cases:
        table, idx, rows, identical = _make(gen, n, r, cap, dt, it, mis)
        for name in KERNELS:
            # the direct scatter's contract: slots sharing an index carry
            # identical rows; the ordered scatter gets different rows and the
            # last slot must win
            src = identical if name == "scatter_rows_dma" else rows
            got, want = _case(rowcopy, name, table, idx, src)
            torch.cuda.synchronize()
            check(_bits_equal(got, want),
                  f"{name} disagrees with its plain version at N={n} R={r} "
                  f"CAP={cap} {dt} idx {it} misaligned={mis}")
            worst[name] = max(worst[name], _abs_err(got, want))
            n_checked += 1

    # the multi-table gathers and scatters
    i32, i64 = torch.int32, torch.int64
    lists = [("the frame's five tables", n_main, cap_main, FRAME_TABLES, i32, ()),
             ("the frame's five tables, fusion's indices", n_main, cap_main,
              FRAME_TABLES, i32, ())]
    for t in (1, 2, 8):
        lists.append((f"T={t}", 300, 513, (FRAME_TABLES * 2)[:t], i64, ()))
    for r in (1, 33, 96):
        for cap in (1, 7, 513):
            spec = [(r, "float32"), (r, "int32"), (r, "float32")]
            lists.append((f"three tables R={r} CAP={cap}", 40, cap, spec,
                          i64 if cap == 7 else i32, ()))
    lists.append(("a misaligned base", 40, 513, [(8, "float32")] * 2, i32, (0, 1)))
    lists.append(("aligned and unaligned tables mixed", 200, 513,
                  [(128, "float32"), (33, "int32"), (96, "float32"),
                   (1, "float32"), (384, "float32")], i32, (2,)))
    lists.append(("rows of 20 KB", 64, 37, [(5120, "float32"), (4, "int32")],
                  i32, ()))
    for k, (what, n, cap, spec, it, mis) in enumerate(lists):
        made = _make_tables(gen, n, cap, spec, it, mis,
                            pattern="fusion" if k == 1 else "random")
        n_checked += _check_tables_case(rowcopy, what, *made)

    # last slot wins, stated outright: every slot names row 3
    specs = [(33, torch.float32), (128, torch.int32), (1, torch.float32),
             (384, torch.float32), (96, torch.int32)]
    idx = torch.full((5,), 3, device="cuda", dtype=torch.int32)
    one = torch.zeros((8, 33), device="cuda")
    rowcopy.scatter_rows(one, idx, torch.arange(
        5, device="cuda", dtype=torch.float32)[:, None].repeat(1, 33))
    tables = [torch.zeros((8, r), device="cuda", dtype=dt) for r, dt in specs]
    rowcopy.scatter_tables(
        tables, idx,
        [torch.arange(5, device="cuda")[:, None].repeat(1, r).to(dt)
         for r, dt in specs])
    torch.cuda.synchronize()
    for t in [one] + tables:
        check(bool((t[3] == 4).all())
              and float(t.abs().sum()) == 4 * t.shape[1],
              "scatter_rows: the last slot did not win")

    # times at the main path's shapes: ONE call on the frame's five tables,
    # per index pattern
    out = {}
    shapes = {k: [] for k in KERNELS}
    row_bytes = 4 * sum(r for r, _ in FRAME_TABLES)
    for pattern in ("random", "unique", "fusion"):
        tables, idx, _, identical, live = _make_tables(
            gen, n_main, cap_main, FRAME_TABLES, torch.int32, pattern=pattern)
        idx64 = idx.long()
        distinct = int(torch.unique(idx64).numel())
        # what this run's data needs, the indices read ONCE.  A gather: each
        # DISTINCT source row read (a second read of a row is served by the
        # L2 cache and need not reach device memory) and every slot's row
        # written.  A scatter: for every distinct destination row one slot's
        # rows read and the row written (the other slots that name it lose,
        # or carry the same bytes).
        bounds = {
            "gather": ((distinct + cap_main) * row_bytes + cap_main * 4)
            / HBM_BYTES_PER_S * 1e3,
            "scatter": (2 * distinct * row_bytes + cap_main * 4)
            / HBM_BYTES_PER_S * 1e3}
        src = torch.cat([r.view(torch.int32).reshape(-1) for r in identical])
        dst = torch.empty_like(src)

        def library_gather():
            for t in tables:
                torch.index_select(t, 0, idx64)

        def library_scatter():
            for t, rows in zip(tables, identical):
                t.index_copy_(0, idx64, rows)

        for name in KERNELS:
            if name in GATHERS:
                multi, kind, library = GATHERS[name], "gather", library_gather
                moved = cap_main
                call = lambda: getattr(rowcopy, multi)(tables, idx)
                plain = lambda: rowcopy.gather_tables_plain(tables, idx)
            else:
                multi, kind, library = SCATTERS[name], "scatter", library_scatter
                moved = (distinct if name == "scatter_rows" or live is not None
                         else cap_main)
                call = lambda: getattr(rowcopy, multi)(
                    tables, idx, identical, live=live)
                plain = lambda: getattr(rowcopy, multi + "_plain")(
                    tables, idx, identical)
            one = dict(
                indices=pattern, distinct_rows=distinct, slots_moved=moved,
                ms=_time_ms(call, flush), plain_ms=_time_ms(plain, flush),
                library_ms=_time_ms(library, flush), bound_ms=bounds[kind],
                # for scale: one contiguous device copy of all slots' bytes
                contiguous_copy_ms=_time_ms(lambda: dst.copy_(src), flush))
            one["share_of_bound"] = one["bound_ms"] / one["ms"]
            shapes[name].append(dict(
                tables=[f"R={r} {dt}" for r, dt in FRAME_TABLES], **one))
            if pattern == "random":    # as in the earlier records
                out[name] = {k: one[k] for k in
                             ("ms", "plain_ms", "library_ms", "bound_ms")}
    return out, shapes, worst, n_checked


# ----------------------------------------------------------------- the scan


def write_config(path, out_dir, last):
    cfg = {
        "input": "", "output": out_dir, "datatype": "tum",
        "pose filename": "",                 # no ground truth: tracking runs
        "first": 0, "last": last, "voxel size": VOXEL, "truncation factor": 5,
        "zmin": 0.5, "zmax": 3.5, "sharpness threshold": 0.0,
        "grid dim": GRID, "chunk size": CHUNK, "fuse rows": 0.5,
        "track config": "reference",
    }
    with open(path, "w") as fh:
        json.dump(cfg, fh)


def run_scan(tmp, tag, seq, last, rows_impl):
    import torch
    from psgradientsdf_tpu_torch.config import load_config
    from psgradientsdf_tpu_torch.ops import rowcopy
    from psgradientsdf_tpu_torch.pipeline import ReconstructionPipeline
    from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

    K, colors, depths, _ = seq
    out_dir = os.path.join(tmp, tag) + "/"
    cfg_path = os.path.join(tmp, tag + ".json")
    write_config(cfg_path, out_dir, last)
    cfg = load_config(cfg_path)
    pipe = ReconstructionPipeline(
        cfg, loader=memory_loader(K, colors[: last + 1], depths[: last + 1]),
        metrics=MetricsLogger(os.path.join(out_dir, "metrics.jsonl"), echo=False),
        device="cuda", rows_impl=rows_impl)
    rowcopy.reset_launch_counts()            # just before the path is driven
    t0 = time.perf_counter()
    summary = pipe.run(refine=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(rowcopy.launch_counts)     # and read just after
    with open(os.path.join(out_dir, "tracking_poses.txt")) as fh:
        pose_text = fh.read()
    return dict(pipe=pipe, summary=summary, counts=counts, seconds=seconds,
                out_dir=out_dir, pose_text=pose_text)


def check_scan(run, seq, n_frames):
    import torch
    from psgradientsdf_tpu_torch.io.trajectory import ate_rmse, read_trajectory

    pipe, summary, counts = run["pipe"], run["summary"], run["counts"]
    gt = seq[3][:n_frames]
    check(summary["frames"] == n_frames, f"frames {summary['frames']} != {n_frames}")
    log = summary["track_log"]
    check(len(log) == n_frames - 1, "one tracker record per tracked frame")
    lost = [r["frame"] for r in log if not r["converged"]]
    check(not lost, f"tracking did not converge on frames {lost}")
    check(all(r["valid"] > 0.5 * W * H for r in log), "too few valid pixels")
    check(not summary["vis_overflow"], "visibility capacity overflowed")
    calls = pipe.fuse_culled_calls
    check(calls >= n_frames - 1, f"{calls} culled fusions for {n_frames - 1} frames")

    vol = pipe.vol
    check(tuple(vol.dist.shape) == (GRID, GRID, GRID), "volume shape")
    for name, t in zip(vol._fields, vol):
        check(t.is_cuda, f"{name} is not on the card")
        if t.dtype.is_floating_point:
            check(bool(torch.isfinite(t).all()), f"{name} has non-finite values")
    observed = float((vol.weight > 0).float().mean())
    check(observed > 0.05, f"only {observed:.3f} of the voxels were observed")
    # every fused frame left its visibility bit somewhere
    from psgradientsdf_tpu_torch.core.volume import vis_bit
    for f in range(n_frames):
        check(bool(vis_bit(vol.vis, f).any()), f"frame {f} left no visibility bit")

    stamps, est = read_trajectory(os.path.join(run["out_dir"], "tracking_poses.txt"))
    check(len(est) == n_frames, "tracking_poses.txt: one pose per frame")
    ate = ate_rmse(est, gt)
    check(ate < 0.5 * VOXEL, f"ATE-RMSE {ate * 1e3:.3f} mm is over half a voxel")
    final = np.abs(np.asarray(est[-1])[:3, 3] - gt[-1][:3, 3]).max()
    check(final < VOXEL, f"last pose is {final * 1e3:.2f} mm off")

    with open(os.path.join(run["out_dir"], "init_mesh.ply"), "rb") as fh:
        head = fh.read(400).decode("ascii", "replace")
    check(head.startswith("ply"), "init_mesh.ply is not a PLY file")
    n_vert = int(head.split("element vertex")[1].split()[0])
    n_face = int(head.split("element face")[1].split()[0])
    check(n_vert > 1000 and n_face > 1000, f"mesh too small: {n_vert}/{n_face}")
    for f in ("init_pointcloud.ply", "init_sdf.sdf"):
        check(os.path.getsize(os.path.join(run["out_dir"], f)) > 0, f + " is empty")
    return dict(ate_mm=ate * 1e3, culled_fusions=calls, observed_fraction=observed,
                mesh_vertices=n_vert, mesh_faces=n_face,
                mean_gn_iterations=float(np.mean([r["iters"] for r in log])))


def profile_scan(tmp, seq, frames, plain_seconds):
    """Trace one more scan of `frames` frames (kernels only, so the host is
    slowed as little as may be) -> the card's busy time in it, its share of
    the untraced run's `plain_seconds`, and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = run_scan(tmp, "traced", seq, frames - 1, "dma")
        torch.cuda.synchronize()

    def device_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    rows = sorted(((device_us(e), e.count, e.key) for e in prof.key_averages()),
                  reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    check(busy > 0.0, "the profiler saw no device time")
    return dict(
        frames=frames, device_busy_seconds=busy,
        untraced_scan_seconds=plain_seconds,
        traced_scan_seconds=traced["summary"]["seconds"],
        device_busy_share=busy / plain_seconds,
        device_kernels=int(sum(r[1] for r in rows)),
        top=[dict(name=k[:80], launches=c, device_ms=us * 1e-3)
             for us, c, k in rows[:12]])


def main():
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1
    from psgradientsdf_tpu_torch import kernels
    from psgradientsdf_tpu_torch.ops import rowcopy

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    card = smi

    # ---- build
    t0 = time.perf_counter()
    kernels.load_library("rowcopy")
    rowcopy.gather_rows_dma(torch.zeros((2, 4), device="cuda"),
                            torch.zeros(1, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    emit("build", source=SOURCE, seconds=time.perf_counter() - t0,
         library=os.path.relpath(kernels.library_path("rowcopy")))

    # ---- kernels against their plain versions
    times, shapes, worst, n_checked = check_kernels(rowcopy)
    emit("kernels", ok=True, cases_checked=n_checked, card=card,
         reps=KERNEL_REPS, times=times, shapes=shapes)
    if "--kernels-only" in sys.argv[1:]:
        return 3

    # ---- the main path
    seq = make_sequence(FRAMES)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        main_run = run_scan(tmp, "scan", seq, FRAMES - 1, "dma")
        facts = check_scan(main_run, seq, FRAMES)
        counts = main_run["counts"]
        calls = main_run["pipe"].fuse_culled_calls
        # a culled fusion gathers its five tables with one call and writes
        # them back with one
        for name in ("gather_rows_dma", "scatter_rows_dma"):
            check(counts[name] == calls,
                  f"{name}: {counts[name]} launches, expected 1 x {calls}")
        for name in ("gather_rows", "scatter_rows"):
            check(counts[name] == 0, f"{name} launched on the default path")
        emit("scan", ok=True, card=card, frames=FRAMES,
             seconds=main_run["summary"]["seconds"],
             frames_per_s=main_run["summary"]["fps"],
             wall_seconds_with_export=main_run["seconds"],
             keyframes=main_run["summary"]["keyframes"],
             overflow_redos=main_run["summary"]["overflow_redos"],
             fuse_capacity=main_run["summary"]["fuse_capacity"],
             launches=counts, **facts)

        # ---- the second pass: staged kernels, and plain row movement
        short = 2 * CHUNK + 1
        runs = {impl: run_scan(tmp, "short_" + impl, seq, short - 1, impl)
                for impl in ("dma", "staged", "plain")}
        staged = runs["staged"]
        calls_s = staged["pipe"].fuse_culled_calls
        for name in ("gather_rows", "scatter_rows"):
            check(staged["counts"][name] == calls_s,
                  f"{name}: {staged['counts'][name]} launches, expected "
                  f"1 x {calls_s}")
        check(all(v == 0 for v in runs["plain"]["counts"].values()),
              "plain row movement launched a kernel")
        for impl in ("staged", "plain"):
            check(runs[impl]["pose_text"] == runs["dma"]["pose_text"],
                  f"{impl}: poses differ from the dma run")
            for name, a, b in zip(staged["pipe"].vol._fields,
                                  runs[impl]["pipe"].vol, runs["dma"]["pipe"].vol):
                check(bool(torch.equal(a, b)), f"{impl}: {name} differs from the dma run")
        check_scan(staged, seq, short)
        emit("scan_staged", ok=True, card=card, frames=short,
             culled_fusions=calls_s, launches=staged["counts"],
             frames_per_s={k: r["summary"]["fps"] for k, r in runs.items()})
        if "--profile" in sys.argv[1:]:
            emit("profile", card=card, **profile_scan(
                tmp, seq, short, runs["dma"]["summary"]["seconds"]))

    launches = dict(counts)
    launches.update({k: staged["counts"][k] for k in ("gather_rows", "scatter_rows")})
    for name in KERNELS:
        check(launches[name] > 0, f"{name} was never launched on its path")
    print(smi, flush=True)
    emit("total", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE, replaces=KERNELS[name],
             launches=launches[name], max_abs_err=worst[name],
             ms=times[name]["ms"], plain_ms=times[name]["plain_ms"],
             bound_ms=times[name]["bound_ms"], bound_by="bytes",
             library_ms=times[name]["library_ms"],
             work="one fused frame: CAP=8192 rows of each of the five state "
                  "tables (3 x R=128, 2 x R=384, 4-byte elements) out of "
                  "N=16384; one call on the five tables, random indices of "
                  "which the second half repeats the first; the bound counts "
                  + ("the distinct rows only" if name in SCATTERS else
                     "the distinct rows read and every slot written"))
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
