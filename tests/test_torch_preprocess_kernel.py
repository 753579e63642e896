"""The scan's preprocessing module of the PyTorch package, ops/preprocess.py,
on the CPU, where its wrappers run the plain versions: FALS normals and the
LAPM sharpness of a chunk of frames.

Against the JAX package on the same numpy frames, at
tests/test_torch_preprocess.py's tolerances (its docstring says why): the
normals rtol 1e-5 / atol 1e-6 against the JAX package run op by op, atol
2e-4 against it compiled (at the pipeline's window and wider), LAPM rtol
1e-5; single frames and batches, zero
depths, every window the wrapper takes, and the stream's `_preprocess` as a
whole against the JAX package's.  Within the port: the wrappers on CPU
tensors are the plain versions and launch nothing, refuse the windows the
kernel does not take, and `_preprocess` / `compute_normals` /
`modified_laplacian` go through them.  The kernels' host side: the normals'
persistent grid covers every pixel of every frame once, the shared memory
fits a block at every window, the LAPM bands cover every row once, the
ctypes argument blocks have the C side's layout, and numpy emulations of
the kernels' loops (the normals' blocks walking their (32 x 32 tile, frame)
units, each tile's clamped reflect-101 halo, the window sums a thread
shares over eight columns and then four rows, each in the plain order; the
LAPM value of each pixel) give the plain version's bits.  The kernels are
held against the plain versions on the card by chip_smoke.py (phase
preprocess_kernels).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgradientsdf_tpu.ops import normals as jnormals
from psgradientsdf_tpu.ops import sharpness as jsharp
from psgradientsdf_tpu.tracking import stream as jstream
from psgradientsdf_tpu_torch import convert
from psgradientsdf_tpu_torch.ops import normals as tnormals
from psgradientsdf_tpu_torch.ops import preprocess as P
from psgradientsdf_tpu_torch.ops import sharpness as tsharp
from psgradientsdf_tpu_torch.tracking import stream as tstream

from helpers_torch import CPU, intrinsics, se3_exp_np, wavy_frame

torch.set_num_threads(1)

H, W = 48, 64
# the windows of the FALS solve (one of 1 leaves its 3x3 Gram matrix singular)
# and of the box filter alone
WINDOWS = [3, 5, 11, 31]
BOX_WINDOWS = [1] + WINDOWS


def _frames(n, seed=0):
    K = intrinsics(H, W, 55.0)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pose = se3_exp_np([0.004 * i, -0.002 * i, 0.003 * i, 0.002 * i, 0.0, 0.001 * i])
        out.append(wavy_frame(H, W, K, pose))
    depths = np.stack([f["depth"] for f in out])
    colors = np.stack([f["color"] for f in out])
    colors = np.clip(colors + 0.05 * rng.standard_normal(colors.shape), 0, 1).astype(np.float32)
    return K, depths, colors


def _caches(K, window):
    jf = jnormals.build_fals_cache(H, W, K, window=window)
    tf = convert.fals_from_numpy(*(np.array(a) for a in jf), device=CPU)
    return jf, tf


@pytest.mark.parametrize("window", WINDOWS)
def test_fals_normals_plain_matches_jax(window):
    K, depths, _ = _frames(3)
    depths[1, 10:14, 20:30] = 0.0             # holes contribute nothing
    depths[2, :, :5] = 0.0                    # a zero band at the border
    jf, tf = _caches(K, window)
    got = P.fals_normals_plain(torch.from_numpy(depths), tf, window).numpy()
    assert got.shape == (3, H, W, 3)
    with jax.disable_jit():
        eager = np.stack([np.asarray(jnormals.compute_normals(
            jnp.asarray(d), jf, window=window)) for d in depths])
    np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-6)
    if window >= 11:
        # XLA's contracted solve lands within 2e-4 where the window is the
        # pipeline's or wider; a narrower window's rays are nearer parallel
        # and its solve cancels more (window 3: 9e-4 apart)
        compiled = np.asarray(jax.vmap(
            lambda d: jnormals.compute_normals(d, jf, window=window))(jnp.asarray(depths)))
        np.testing.assert_allclose(got, compiled, rtol=0, atol=2e-4)
    # the wrapper on CPU tensors is the plain version, a frame or a batch
    P.reset_launch_counts()
    wrapped = P.fals_normals(torch.from_numpy(depths), tf, window)
    assert torch.equal(wrapped, torch.from_numpy(got))
    one = P.fals_normals(depths[1], tf, window)
    assert torch.equal(one, wrapped[1])
    assert P.launch_counts == {"fals_normals": 0, "lapm": 0}


def test_fals_normals_of_an_all_zero_frame_are_zero():
    K, depths, _ = _frames(2)
    depths[0] = 0.0
    jf, tf = _caches(K, 11)
    got = P.fals_normals(torch.from_numpy(depths), tf, 11).numpy()
    want = np.asarray(jax.vmap(
        lambda d: jnormals.compute_normals(d, jf, window=11))(jnp.asarray(depths)))
    assert (got[0] == 0).all() and (want[0] == 0).all()
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-4)


@pytest.mark.parametrize("window", [0, 2, 10, 33, -1])
def test_fals_normals_refuses_the_windows_the_kernel_does_not_take(window):
    K, depths, _ = _frames(1)
    _, tf = _caches(K, 11)
    with pytest.raises(ValueError, match="window"):
        P.fals_normals(torch.from_numpy(depths), tf, window)


def test_fals_normals_refuses_a_window_wider_than_the_image():
    K = intrinsics(8, 40, 30.0)
    jf = jnormals.build_fals_cache(8, 40, K, window=11)
    tf = convert.fals_from_numpy(*(np.array(a) for a in jf), device=CPU)
    with pytest.raises(ValueError, match="does not fit"):
        P.fals_normals(torch.ones(8, 40), tf, 17)
    assert P.fals_normals(torch.ones(8, 40), tf, 15).shape == (8, 40, 3)


def test_lapm_plain_matches_jax():
    _, _, colors = _frames(3)
    want = np.asarray([jsharp.modified_laplacian(jnp.asarray(c)) for c in colors])
    P.reset_launch_counts()
    batched = P.lapm(torch.from_numpy(colors)).numpy()
    assert batched.shape == (3,)
    np.testing.assert_allclose(batched, want, rtol=1e-5)
    np.testing.assert_array_equal(batched, P.lapm_plain(torch.from_numpy(colors)).numpy())
    single = P.lapm(torch.from_numpy(colors[2])).numpy()
    assert single.shape == ()
    np.testing.assert_allclose(single, want[2], rtol=1e-5)
    gray = colors[0, ..., 2].copy()
    np.testing.assert_allclose(P.lapm(torch.from_numpy(gray)).numpy(),
                               np.asarray(jsharp.modified_laplacian(jnp.asarray(gray))),
                               rtol=1e-5)
    assert P.launch_counts == {"fals_normals": 0, "lapm": 0}


def test_stream_preprocess_matches_jax_and_goes_through_the_wrappers(monkeypatch):
    """The chunk's preprocessing as a whole, from the wire format (uint16
    depth as int32, uint8 colour), against the JAX package's `_preprocess`."""
    K, depths, colors = _frames(4, seed=3)
    unit = 1.0 / 5000.0
    raw_d = np.round(depths / unit).astype(np.int32)
    raw_d[2, 5:9, 5:40] = 0
    raw_c = np.round(colors * 255).astype(np.uint8)
    jf, tf = _caches(K, 11)
    jn, js = jstream._preprocess(jnp.asarray(raw_d), jnp.asarray(raw_c), jf,
                                 window=11, depth_unit=unit)
    calls = {"fals_normals": 0, "lapm": 0}

    def counted(name):
        real = getattr(P, name)

        def fn(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return fn

    for name in calls:
        monkeypatch.setattr(P, name, counted(name))
    d, c, n, s = tstream._preprocess(torch.from_numpy(raw_d), torch.from_numpy(raw_c),
                                     tf, window=11, depth_unit=unit)
    assert calls == {"fals_normals": 1, "lapm": 1}
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=0, atol=2e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    # the per-frame callers go through the same wrappers
    tnormals.compute_normals(d[0], tf, window=11)
    tsharp.modified_laplacian(c[0])
    assert calls == {"fals_normals": 2, "lapm": 2}


# ---------------------------------------------------------------------------
# the kernels' host side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 1), (8, 480, 640), (1, 960, 1280), (3, 48, 64),
                                   (2, 9, 33)])
def test_fals_grid_covers_every_pixel_once(shape):
    C, h, w = shape
    for slots in (1, 7, 132 * 3, 10 ** 6):
        gx, gy, units, blocks = P.fals_grid(C, h, w, slots)
        assert gx * P.TILE >= w > (gx - 1) * P.TILE
        assert gy * P.TILE >= h > (gy - 1) * P.TILE
        assert units == gx * gy * C and 1 <= blocks <= min(slots, units)
        seen = [u for b in range(blocks) for u in P.fals_units(b, blocks, units)]
        assert seen == list(range(units))          # each (tile, frame) once, in order
        per = [len(P.fals_units(b, blocks, units)) for b in range(blocks)]
        assert min(per) >= 1 and max(per) - min(per) <= 1


def test_fals_shared_memory_fits_a_block():
    # the cache planes and weighted components (42 x 43 each), the
    # horizontal sums (42 x 33), two depth halos (42 x 42), the sources (84)
    assert P.fals_smem(11) == 4 * (6 * 42 * 43 + 3 * 42 * 33 + 2 * 42 * 42 + 84)
    for window in range(1, P.MAX_WINDOW + 1, 2):
        assert P.fals_smem(window) <= 232448


def _lapm_blocks(plan, C, h, w):
    """LAPM's blocks as csrc/preprocess.cu lapm_kernel cuts them: (frame,
    band, strip, rows [y0, y1), columns [x0, x1))."""
    for c in range(C):
        for b in range(plan.bands):
            for s in range(plan.strips):
                y0, x0 = b * plan.rows, s * plan.strip_cols
                yield c, b, s, y0, min(h, y0 + plan.rows), x0, min(w, x0 + plan.strip_cols)


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("C,h", [(1, 2), (1, 480), (8, 480), (8, 960), (3, 7), (300, 48)])
def test_lapm_bands_cover_every_row_once(C, h, sms):
    """Every pixel of every frame in one block, a consumer thread's columns
    cover its strip, the ring holds a strip's span of a row at any address
    and the shared memory fits a block, at several widths (grey and RGB)."""
    for w, S in ((2, 1), (45, 3), (640, 3), (641, 1), (1280, 3), (2500, 3)):
        plan = P.lapm_plan(C, h, w, S, sms)
        assert plan.bands * plan.rows >= h > (plan.bands - 1) * plan.rows
        assert plan.strips * plan.strip_cols >= w > (plan.strips - 1) * plan.strip_cols
        assert plan.strip_cols <= P.LAPM_MAX_STRIP
        assert plan.threads % 32 == 0 and plan.threads + 32 <= 1024
        assert plan.threads * P.LAPM_COLS >= plan.strip_cols > (plan.threads - 32) * P.LAPM_COLS
        assert plan.pitch % 16 == 0 and plan.pitch >= (plan.strip_cols + 2) * S * 4 + 12
        assert 1 <= plan.depth <= min(P.LAPM_DEPTH, plan.rows + 2)
        assert plan.smem == plan.depth * (plan.pitch + 16) + 8 * 32 + 16 <= 232448
        blocks = C * plan.bands * plan.strips
        assert blocks <= max(C * plan.strips, P.LAPM_BLOCKS_PER_SM * sms + C * plan.strips)
        if C * h * w <= 10 ** 6:
            seen = np.zeros((C, h, w), np.int32)
            for c, _, _, y0, y1, x0, x1 in _lapm_blocks(plan, C, h, w):
                assert y1 > y0 and x1 > x0
                seen[c, y0:y1, x0:x1] += 1
            assert (seen == 1).all()


def test_the_argument_blocks_have_the_c_layout():
    assert ctypes.sizeof(P._FalsArgs) == 8 * 11
    assert ctypes.sizeof(P._LapmArgs) == 8 * 18
    assert [f[0] for f in P._FalsArgs._fields_][-5:] == ["C", "H", "W", "window", "blocks"]
    # an earlier lapm (the first design's LapmArgs) reads the prefix
    assert [f[0] for f in P._LapmArgs._fields_][:12] == [
        "img", "out", "part", "ticket", "C", "H", "W", "S", "chan", "frame", "bands",
        "rows_per_band"]
    assert [f[0] for f in P._LapmArgs._fields_][12:] == list(P.LapmPlan._fields[2:])


def _reflect(i, n):
    i = np.where(i < 0, -i, i)
    return np.where(i >= n, 2 * (n - 1) - i, i)


def _window_sums(v, window, K):
    """csrc/preprocess.cu window_sums<K> over the last axis of v [..., L]:
    acc[k] = v[k] + v[k + 1] + ... + v[k + window - 1], k < K, each value
    read once and added, in float32, to every sum it belongs to (where
    window >= K: the sums' first values, the values all K take, the last
    ones), else each sum on its own; left to right either way -> [..., K]."""
    acc = [None] * K
    if window >= K:
        for m in range(K):
            for k in range(m + 1):
                acc[k] = v[..., m].copy() if k == m else acc[k] + v[..., m]
        for m in range(K, window):
            for k in range(K):
                acc[k] = acc[k] + v[..., m]
        for q in range(K - 1):
            for k in range(q + 1, K):
                acc[k] = acc[k] + v[..., window + q]
    else:
        for k in range(K):
            a = v[..., k].copy()
            for j in range(1, window):
                a = a + v[..., k + j]
            acc[k] = a
    return np.stack(acc, axis=-1)


def _emulated_box_sums(wt, window, slots):
    """csrc/preprocess.cu fals_normals_kernel's steps 0-3 on one weighted
    channel [C, h, w] in float32: each block of fals_grid(C, h, w, slots)
    walks its (32 x 32 tile, frame) units; on a new tile it places the halo
    (rows and columns past the last padded one clamped, then reflected);
    a frame's halo rows are summed over the window eight columns a thread,
    then those sums' columns four rows a thread (_window_sums)."""
    C, h, w = wt.shape
    r, T = window // 2, P.TILE
    tx, _, units, blocks = P.fals_grid(C, h, w, slots)
    out = np.full((C, h, w), np.nan, np.float32)
    for b in range(blocks):
        tile = None
        for u in P.fals_units(b, blocks, units):
            if u // C != tile:
                tile = u // C
                y0, x0 = (tile // tx) * T, (tile % tx) * T
                halo = np.arange(T + 2 * r)
                sy = _reflect(np.minimum(y0 + halo - r, h - 1 + r), h)
                sx = _reflect(np.minimum(x0 + halo - r, w - 1 + r), w)
            frame = wt[u % C][np.ix_(sy, sx)]
            hs = np.concatenate([_window_sums(frame[:, P.H_COLS * g:], window, P.H_COLS)
                                 for g in range(T // P.H_COLS)], axis=1)
            vs = np.concatenate([_window_sums(hs[P.V_ROWS * g:].T, window, P.V_ROWS).T
                                 for g in range(T // P.V_ROWS)], axis=0)
            ys, xs = min(T, h - y0), min(T, w - x0)
            out[u % C, y0:y0 + ys, x0:x0 + xs] = vs[:ys, :xs]
    return out


@pytest.mark.parametrize("window", BOX_WINDOWS)
@pytest.mark.parametrize("hw", [(48, 64), (17, 45), (40, 33)])
def test_the_normals_tiles_give_the_plain_window_sums_bit_for_bit(window, hw):
    h, w = hw
    if window // 2 >= min(h, w):
        pytest.skip("the window does not fit the image")
    rng = np.random.default_rng(window * 100 + h)
    wt = rng.standard_normal((3, h, w)).astype(np.float32)
    want = P._box_filter(torch.from_numpy(wt), window).numpy()
    # five blocks: each walks frames of one tile or of two
    got = _emulated_box_sums(wt, window, 5)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _tap(k, a, b, c):
    f = np.float32
    return (f(k[0]) * a + f(k[1]) * b) + f(k[2]) * c


def _warp_butterfly(v):
    """An xor butterfly over the last axis of v [..., 32] in double: every
    lane ends with the same sum, in the kernel's order."""
    v = v.copy()
    lanes = np.arange(32)
    for s in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ s]
    return v[..., 0]


def _emulated_lapm(img, plan):
    """csrc/preprocess.cu lapm_kernel on a [C, h, w] channel in numpy: each
    block's staged rows (the band and a reflected row on each side) and
    each thread's columns x0 + t + k T, the x passes once a staged row, the
    y pass from the last three; a thread's double sum (rows in order, its
    columns in order), each warp's butterfly, the warps in order, then the
    last block's lanes over a frame's partials and the butterfly -> (the
    pixels' values [C, h, w], the means [C] float32)."""
    C, h, w = img.shape
    T = plan.threads
    parts = np.zeros((C, plan.bands * plan.strips))
    values = np.full((C, h, w), np.nan, np.float32)
    for c, b, s, y0, y1, x0, x1 in _lapm_blocks(plan, C, h, w):
        xs = x0 + np.arange(T)[:, None] + T * np.arange(P.LAPM_COLS)[None]   # [T, K]
        on = xs < x1
        x = np.minimum(xs, w - 1)
        xl, xr = np.where(x == 0, 1, x - 1), np.where(x == w - 1, w - 2, x + 1)
        acc = np.zeros(T)
        lap, gau = [], []
        for j in range(y1 - y0 + 2):
            row = img[c, _reflect(np.asarray(y0 - 1 + j), h)]
            u, v, r = row[xl], row[x], row[xr]
            lap, gau = (lap + [_tap(P.LAP3, u, v, r)])[-3:], (gau + [_tap(P.GAUSS3, u, v, r)])[-3:]
            if j < 2:
                continue
            val = np.abs(_tap(P.GAUSS3, *lap)) + np.abs(_tap(P.LAP3, *gau))
            values[c, y0 + j - 2, x[on]] = val[on]
            for k in range(P.LAPM_COLS):
                acc = np.where(on[:, k], acc + val[:, k].astype(np.float64), acc)
        warps = _warp_butterfly(acc.reshape(T // 32, 32))
        total = 0.0
        for ws in warps:
            total += ws
        parts[c, b * plan.strips + s] = total
    means = np.zeros(C, np.float32)
    for c in range(C):
        lanes = np.zeros(32)
        for k in range(parts.shape[1]):
            lanes[k % 32] += parts[c, k]
        means[c] = np.float32(_warp_butterfly(lanes) / (h * w))
    return values, means


@pytest.mark.parametrize("hw", [(48, 64), (2, 2), (7, 13), (33, 45)])
@pytest.mark.parametrize("sms", [1, 16, 132])
def test_the_lapm_pixels_give_the_plain_values_bit_for_bit(hw, sms, monkeypatch):
    """csrc/preprocess.cu lapm_kernel's value of each pixel, |Lx| + |Ly|
    from its 3 x 3 reflected neighbours in the plain order (each row's x
    passes formed once, the y pass from the last three rows), on several
    bands and strips (the strip's limit cut to 16 columns), and the mean of
    its double sums in the kernel's order within float32 rounding of the
    plain mean."""
    h, w = hw
    monkeypatch.setattr(P, "LAPM_MAX_STRIP", 16)
    rng = np.random.default_rng(h * w + sms)
    img = rng.random((3, h, w)).astype(np.float32)
    plan = P.lapm_plan(3, h, w, 1, sms)
    assert plan.strips == -(-w // 16)
    values, means = _emulated_lapm(img, plan)
    src = torch.from_numpy(img)
    want = (P._sep_filter(src, P.LAP3, P.GAUSS3).abs()
            + P._sep_filter(src, P.GAUSS3, P.LAP3).abs()).numpy()
    np.testing.assert_array_equal(values.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(means, P.lapm_plain(src).numpy(), rtol=1e-6)


def test_the_lapm_wrapper_launches_its_plan_off_the_cpu(monkeypatch):
    """Off the CPU lapm goes to its kernel (the launch captured on meta
    tensors, so that no card is needed) with the plan of lapm_plan: RGB
    reads the blue channel at S = 3, grey S = 1, and a view keeps its
    base (the kernel's producer loads an unaligned span's ragged ends)."""
    from psgradientsdf_tpu_torch import kernels

    seen = []
    monkeypatch.setattr(kernels, "sm_count", lambda dev: 132)
    monkeypatch.setattr(P, "_launch", lambda name, a, dev: seen.append((name, a)))
    monkeypatch.setattr(P, "_ticket", lambda dev: torch.zeros(1, dtype=torch.int32,
                                                             device="meta"))
    rgb = torch.empty((8, 480, 640, 3), device="meta")
    assert P.lapm(rgb).shape == (8,)
    name, a = seen[-1]
    plan = P.lapm_plan(8, 480, 640, 3, 132)
    assert name == "lapm" and (a.S, a.chan, a.frame) == (3, 2, 480 * 640 * 3)
    assert (a.bands, a.rows_per_band, a.strips, a.strip_cols, a.threads, a.depth, a.pitch,
            a.smem) == tuple(plan)
    assert P.lapm(torch.empty((45, 17), device="meta")).shape == ()
    assert (seen[-1][1].S, seen[-1][1].chan, seen[-1][1].C) == (1, 0, 1)
    with pytest.raises(TypeError, match="float32"):
        P.lapm(torch.empty((4, 4), dtype=torch.float64, device="meta"))
    assert P.launch_counts["lapm"] == 0
