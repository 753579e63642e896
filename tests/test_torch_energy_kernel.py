"""The refinement's energy module of the PyTorch package, ops/energy.py, on
the CPU, where its wrapper runs the plain version: the four sums (PS,
normal, Laplacian, albedo) and the four energies of a residual pass.

Against the JAX package's `_energy_from_rd` (refine/optimizer.py), on the
same numpy problem, state and residual pass (tests/helpers_torch.py's
refinement scene, the residual pass computed by the JAX package): under all
five losses on an SH1 and an LED problem, after the upsample, with rows
whose stencil neighbours are frozen (the constant fallback), and with no
valid row; rtol 1e-5 (XLA sums in its own order).  Within the port: the
`terms` mask selects the sums; the wrapper on CPU tensors is the plain
version and launches nothing; the refiner's `_energy_from_rd` and the
mesh's `energy_from_rd` (one call a block) go through it; the kernel's grid
(`energy_blocks`) and argument block; a numpy emulation of the kernel's
arithmetic (each pair's and row's terms in float32 from the raw arrays with
the C side's indexing, summed in double) agrees with the plain version to
float32 rounding; and a numpy emulation of its order of addition (the pair
threads' groups of four, read by vector or by scalar loads, the row
threads' rows two a step, each warp's butterfly, the warps, the blocks'
partials by the last block's fixed stride) agrees with the plain version
and gives the same bits wherever the inputs differ only in what the kernel
does not read or in their alignment.  The kernel is held against the plain
version on the card by chip_smoke.py (phase energy_kernels).
"""

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers_torch as ht
from psgradientsdf_tpu.refine import optimizer as jopt
from psgradientsdf_tpu.refine import problem as jproblem
from psgradientsdf_tpu.refine import render as jrender
from psgradientsdf_tpu.refine import upsample as jupsample
from psgradientsdf_tpu.utils import robust
from psgradientsdf_tpu_torch import convert
from psgradientsdf_tpu_torch.ops import energy as E
from psgradientsdf_tpu_torch.parallel import mesh as pm
from psgradientsdf_tpu_torch.refine import optimizer as topt
from psgradientsdf_tpu_torch.refine.render import ResidualData

torch.set_num_threads(1)

H_VOX = 0.04
LOSSES = {"l2": robust.L2, "cauchy": robust.CAUCHY, "huber": robust.HUBER,
          "tukey": robust.TUKEY, "trunc_l2": robust.TRUNC_L2}
MODELS = {"SH1": ("SH1", 1), "LED": ("LED", 1)}
LAM = {"SH1": 0.7, "LED": 0.1}
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _case(model, upsampled=False):
    """(JAX problem, the port's problem made from its arrays, state arrays,
    the JAX residual pass, its numpy fields, kwargs of the residual pass)."""
    name, order = MODELS[model]
    sc = ht.refine_scene(model=name, order=order, n_poses=3, dim=24, h=H_VOX,
                         H=40, W=40, f=36.0)
    vol, geom, kf, h = sc["jvol"], sc["jg"], sc["frame_ids"], H_VOX
    if upsampled:
        vol, geom, kf = jupsample.upsample_volume(vol, geom, kf, sc["truncation"])
        h = geom.voxel_size
    jp = jproblem.extract_problem(vol, geom, kf)
    rng = np.random.default_rng(7)
    N = jp.dist.shape[0]
    # a state off the fused one, so that every regularizer is far from 0
    dist = (np.asarray(jp.dist) + 0.2 * h * rng.standard_normal(N)).astype(np.float32)
    albedo = np.clip(np.asarray(jp.albedo) + 0.1 * rng.standard_normal((N, 3)),
                     0, 1).astype(np.float32)
    if name == "LED":
        lights = np.asarray([0.4, 1.9, 1.0], np.float32)
    else:
        lights = rng.normal(0, 0.3, (3, 4)).astype(np.float32)
        lights[:, 3] -= 0.8
    kw = dict(model=name, order=order, loss=robust.CAUCHY, lam=LAM[model], voxel_size=h)
    # keyframe 2 turned: its projections leave the image, pairs not counted
    poses = sc["poses"].copy()
    poses[2] = poses[2] @ ht.se3_exp_np([0.3, 0, 0, 0, 0.2, 0])
    jrd = jrender.compute_residuals(
        jp, geom, jnp.asarray(dist), jnp.asarray(albedo), jp.grad_stored,
        jnp.asarray(poses), jnp.asarray(sc["images"]), jnp.asarray(sc["K"]),
        jnp.asarray(lights), **kw)
    tp = convert.problem_from_numpy(ht.problem_j_to_numpy(jp), device=ht.CPU)
    rd = {k: np.asarray(v) for k, v in zip(jrd._fields, jrd)}
    return jp, tp, dist, albedo, jrd, rd, h


def _t_rd(rd):
    return ResidualData(*(torch.from_numpy(np.array(rd[k])) for k in ResidualData._fields))


def _jax_energies(jp, jrd, dist, albedo, loss, lam, h):
    return np.asarray(jopt._energy_from_rd(jp, jrd, jnp.asarray(dist), jnp.asarray(albedo),
                                           loss=loss, lam=lam, voxel_size=h))


def _port(tp, rd, dist, albedo, loss, lam, h, **kw):
    return E.energy_sums(tp, _t_rd(rd), torch.from_numpy(dist), torch.from_numpy(albedo),
                         loss=loss, lam=lam, voxel_size=h, **kw)


CASES = [(m, l, u) for m in MODELS for l in LOSSES for u in (False, True)
         if not u or l in ("cauchy", "tukey")]


@pytest.mark.parametrize("model,loss,upsampled", CASES,
                         ids=[f"{m}-{l}" + ("-upsampled" if u else "") for m, l, u in CASES])
def test_energy_sums_plain_matches_jax(model, loss, upsampled):
    jp, tp, dist, albedo, jrd, rd, h = _case(model, upsampled)
    lam = LAM[model]
    want = _jax_energies(jp, jrd, dist, albedo, LOSSES[loss], lam, h)
    E.reset_launch_counts()
    sums, energies = _port(tp, rd, dist, albedo, LOSSES[loss], lam, h,
                           n_surface=tp.n_surface)
    assert E.launch_counts == {"energy_sums": 0}
    np.testing.assert_allclose(energies.numpy(), want, rtol=RTOL)
    np.testing.assert_array_equal(energies.numpy(),
                                  (sums / float(tp.n_surface)).numpy())
    assert (want > 0).all()
    # the refiner's evaluation is the same call
    got = topt._energy_from_rd(tp, _t_rd(rd), torch.from_numpy(dist),
                               torch.from_numpy(albedo), loss=LOSSES[loss], lam=lam,
                               voxel_size=h)
    assert torch.equal(got, energies)
    # the case covers what it claims: counted and uncounted pairs, padded
    # rows, stencil neighbours frozen (-1) and live
    m, valid = rd["mask"], np.asarray(jp.valid)
    assert m.sum() > 100 and (~m[valid]).sum() > 10 and (~valid).sum() > 10
    for idx in (np.asarray(jp.nbr_idx)[valid], np.asarray(jp.lap_idx)[valid]):
        assert (idx < 0).sum() > 10 and (idx >= 0).sum() > 10
    if upsampled:
        assert tp.n_surface > 4 * _case(model)[1].n_surface


@pytest.mark.parametrize("model", MODELS)
def test_no_valid_row_sums_to_zero(model):
    jp, tp, dist, albedo, jrd, rd, h = _case(model)
    none = np.zeros_like(np.asarray(jp.valid))
    jp0 = jp._replace(valid=jnp.asarray(none))
    jrd0 = jrd._replace(mask=jnp.zeros_like(jrd.mask))
    tp0 = tp._replace(valid=torch.from_numpy(none))
    rd0 = dict(rd, mask=np.zeros_like(rd["mask"]))
    want = _jax_energies(jp0, jrd0, dist, albedo, robust.CAUCHY, LAM[model], h)
    sums, energies = _port(tp0, rd0, dist, albedo, robust.CAUCHY, LAM[model], h,
                           n_surface=tp0.n_surface)
    assert (want == 0).all() and (sums.numpy() == 0).all() and (energies.numpy() == 0).all()


@pytest.mark.parametrize("model", MODELS)
def test_the_terms_mask_selects_the_sums(model):
    jp, tp, dist, albedo, jrd, rd, h = _case(model)
    args = (tp, rd, dist, albedo, robust.TUKEY, LAM[model], h)
    every = _port(*args)
    assert every.shape == (4,) and (every > 0).all()
    for terms, keep in ((E.PS, [0]), (E.REGULARIZERS, [1, 2, 3]), (E.NORMAL, [1]),
                        (E.LAPLACIAN, [2]), (E.ALBEDO, [3]), (E.PS | E.ALBEDO, [0, 3])):
        got = _port(*args, terms=terms).numpy()
        want = np.zeros(4, np.float32)
        want[keep] = every.numpy()[keep]
        np.testing.assert_array_equal(got, want)
    # a term left out reads none of its inputs: the PS sum takes no albedo
    got = E.energy_sums(tp, _t_rd(rd), torch.from_numpy(dist), None, loss=robust.TUKEY,
                        lam=LAM[model], voxel_size=h, terms=E.PS)
    assert float(got[0]) == float(every[0])
    with pytest.raises(ValueError, match="terms"):
        _port(*args, terms=0)
    with pytest.raises(ValueError, match="loss"):
        _port(tp, rd, dist, albedo, 7, LAM[model], h)


def _refiner(model, mesh=None):
    """The port's refiner on the scene, keyframes set, init() run and the
    albedo initialised; on a mesh of CPU "devices" when `mesh` is given."""
    from psgradientsdf_tpu_torch import config as tconfig
    from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

    name, order = MODELS[model]
    sc = ht.refine_scene(model=name, order=order, n_poses=4, dim=24, h=H_VOX,
                         H=40, W=40, f=36.0)
    cfg = tconfig.OptimizerConfig(model=name, order=order, lam=0.2, loss=robust.CAUCHY,
                                  reg_weight_n=0.5, reg_weight_l=0.3, reg_weight_rho=0.1)
    ref = topt.PhotometricRefiner(
        sc["tvol"], sc["tg"], cfg, sc["K"], truncation=sc["truncation"],
        metrics=MetricsLogger(None, echo=False),
        mesh=None if mesh is None else pm.make_mesh(*mesh, device="cpu"))
    ref.set_keyframes(sc["images"], sc["poses"], sc["frame_ids"],
                      [f"{i:03d}" for i in range(len(sc["frame_ids"]))])
    ref.init()
    ref.init_albedo()
    return ref


@pytest.mark.parametrize("model", MODELS)
def test_the_loop_and_the_mesh_evaluate_through_energy_sums(model, monkeypatch):
    calls = []
    real = E.energy_sums

    def counted(*a, **kw):
        calls.append(kw.get("terms", E.ALL_TERMS))
        return real(*a, **kw)

    monkeypatch.setattr(E, "energy_sums", counted)
    one = np.asarray(_refiner(model).energies())
    assert calls == [E.ALL_TERMS]
    calls.clear()
    on_mesh = np.asarray(_refiner(model, mesh=(4, 2)).energies())
    # a call a block: a chunk's first block all four sums, the others PS
    assert sorted(calls) == sorted([E.ALL_TERMS] * 4 + [E.PS] * 4)
    np.testing.assert_allclose(on_mesh, one, rtol=RTOL)


# ---------------------------------------------------------------------------
# the kernel's host side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("N,F", [(0, 0), (1, 1), (1, 40), (1024, 1), (49152, 40),
                                 (393216, 8), (7, 0)])
def test_energy_blocks(N, F, sms):
    b = E.energy_blocks(N, F, sms)
    assert b == E.energy_blocks(N, F, sms) >= 1
    assert b <= E.BLOCKS_PER_SM * sms
    assert E.PAIR_THREADS + E.ROW_THREADS == E.THREADS and E.PAIR_THREADS % 32 == 0
    groups = -(-N * F // E.GROUP)
    # no block without a group of pairs or a row where the work is small
    assert (b - 1) * E.PAIR_THREADS < groups or (b - 1) * E.ROW_THREADS < N or b == 1
    if groups > E.BLOCKS_PER_SM * sms * E.PAIR_THREADS:
        assert b == E.BLOCKS_PER_SM * sms          # a persistent grid fills the SMs


def test_the_argument_block_has_the_c_layout():
    assert ctypes.sizeof(E._EnergyArgs) == 8 * 23
    names = [f[0] for f in E._EnergyArgs._fields_]
    assert names[:2] == ["r", "mask"] and names[-3:] == ["lam", "voxel", "count"]
    assert len(E.LOSS_KINDS) == 5 and sorted(E.LOSS_KINDS) == sorted(LOSSES.values())


def _emulated_sums(p, rd, dist, albedo, loss, lam, h):
    """csrc/energy.cu energy_sums_kernel's terms in float32, read from the
    raw arrays with the C side's indexing, each summed in double."""
    pairs, rows = _emulated_values(p, rd, dist, albedo, loss, lam, h)
    return np.asarray([pairs.astype(np.float64).sum()]
                      + [v.astype(np.float64).sum() for v in rows])


def _emulated_values(p, rd, dist, albedo, loss, lam, h, r=None):
    """The kernel's float32 value of each pair ([N F], 0 where the mask is
    not set; r [N F 3] as the kernel's loads gave it, rd's by default) and
    of each row's three regularizer terms ([3, N], 0 where not valid)."""
    f = np.float32
    r = rd["r"].reshape(-1, 3) if r is None else r
    mask = rd["mask"].reshape(-1)
    lam32, inv = f(lam), f(1) / f(lam)
    lam_sq, half = f(lam * lam), f(0.5 * lam)

    def rho(x):
        if loss == robust.CAUCHY:
            t = x * inv
            return np.log1p(t * t)
        if loss == robust.TUKEY:
            t = x * inv
            u = f(1) - t * t
            return np.where(x * x < lam_sq, f(1) - (u * u) * u, f(1))
        if loss == robust.HUBER:
            return np.where(x * x < lam_sq, f(0.5) * (x * x), lam32 * (np.abs(x) - half))
        if loss == robust.TRUNC_L2:
            c = np.clip(x, -lam32, lam32)
            return c * c
        return x * x

    with np.errstate(all="ignore"):
        per = (rho(r[:, 0]) + rho(r[:, 1])) + rho(r[:, 2])
    pairs = np.where(mask, per, f(0))
    v = p["valid"]
    inv_h, inv_h2 = f(1) / f(h), f(1) / f(h * h)
    nbr, lap = p["nbr_idx"].reshape(-1), p["lap_idx"].reshape(-1)
    n = np.nonzero(v)[0]
    d0 = dist[n]
    dn = np.stack([np.where(nbr[3 * n + i] >= 0, dist[np.maximum(nbr[3 * n + i], 0)],
                            p["nbr_dist_const"].reshape(-1)[3 * n + i]) for i in range(3)])
    g = (p["nbr_dir"].reshape(-1)[3 * n + np.arange(3)[:, None]] * (dn - d0)) * inv_h
    e = np.sqrt((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]) - f(1)
    s = np.zeros(len(n), np.float32)
    for i in range(6):
        s = s + np.where(lap[6 * n + i] >= 0, dist[np.maximum(lap[6 * n + i], 0)],
                         p["lap_dist_const"].reshape(-1)[6 * n + i])
    l = (s - f(6) * d0) * inv_h2
    a, ac = albedo.reshape(-1), p["nbr_albedo_const"].reshape(-1)
    sq = np.zeros((3, len(n)), np.float32)
    for i in range(3):
        m = nbr[3 * n + i]
        for ch in range(3):
            an = np.where(m >= 0, a[3 * np.maximum(m, 0) + ch], ac[9 * n + 3 * i + ch])
            gg = (p["nbr_dir"].reshape(-1)[3 * n + i] * (an - a[3 * n + ch])) * inv_h
            sq[ch] = sq[ch] + gg * gg
    rows = np.zeros((3, len(v)), np.float32)
    rows[0, n] = e * e
    rows[1, n] = l * l
    rows[2, n] = (np.sqrt(sq[0]) + np.sqrt(sq[1])) + np.sqrt(sq[2])
    return pairs, rows


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("loss", LOSSES)
def test_the_kernels_arithmetic_emulated_agrees_with_the_plain_sums(model, loss):
    jp, tp, dist, albedo, jrd, rd, h = _case(model)
    p = ht.problem_j_to_numpy(jp)
    got = _emulated_sums(p, rd, dist, albedo, LOSSES[loss], LAM[model], h)
    want = _port(tp, rd, dist, albedo, LOSSES[loss], LAM[model], h).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _butterfly(v):
    """__shfl_xor_sync's sum over each warp's 32 lanes [..., 32] (every lane
    ends with the same bits; lane 0's)."""
    v = v.copy()
    for s in (16, 8, 4, 2, 1):
        v = v + v[..., np.arange(32) ^ s]
    return v[..., 0]


def _load_r(rd, offset):
    """The floats of r as the kernel reads them, the buffer placed at
    `offset` floats into a larger one: each full group of four pairs as
    three 16-byte loads where r lies on a 16-byte boundary, the rest (and
    every group where it does not) a float at a time -> r [N F, 3] (the
    uncounted pairs' floats too: the values the kernel ignores)."""
    flat = rd["r"].reshape(-1)
    buf = np.full(flat.size + 8, np.nan, np.float32)
    buf[offset:offset + flat.size] = flat
    r = buf[offset:offset + flat.size].copy()
    if offset % 4 == 0:
        full = flat.size // 12
        vec = buf[offset:offset + 12 * full].reshape(full, 3, 4)   # [group, load, float]
        r = np.concatenate([vec.reshape(-1), r[12 * full:]])
    return r.reshape(-1, 3)


def _emulated_kernel_sums(p, rd, dist, albedo, loss, lam, h, blocks, offset=0):
    """csrc/energy.cu energy_sums_kernel's four float sums, in its order of
    addition: pair thread q of Q = blocks * PAIR_THREADS adds the counted
    pairs of groups q, q + Q, ... in double; row thread j of R = blocks *
    ROW_THREADS the valid rows j, j + R, ...; each warp's butterfly; a
    block's 16 warps in order; the last block's thread j of a term adds the
    partials j, j + 128, ..., then its warp's butterfly, then term k's four
    warps in order."""
    f8 = np.float64
    pair_v, row_v = _emulated_values(p, rd, dist, albedo, loss, lam, h,
                                     r=_load_r(rd, offset))
    Q, R = blocks * E.PAIR_THREADS, blocks * E.ROW_THREADS
    groups = -(-pair_v.size // E.GROUP)
    steps = max(1, -(-groups // Q))
    g = np.zeros(steps * Q * E.GROUP, np.float32)
    g[:pair_v.size] = pair_v
    g = g.reshape(steps, Q, E.GROUP)                     # [step, thread, pair]
    acc = np.zeros((4, blocks, E.THREADS))
    pair_acc = np.zeros(Q)
    for s in range(steps):
        for j in range(E.GROUP):
            pair_acc = pair_acc + g[s, :, j].astype(f8)
    acc[0, :, :E.PAIR_THREADS] = pair_acc.reshape(blocks, E.PAIR_THREADS)
    steps = max(1, -(-row_v.shape[1] // R))
    rv = np.zeros((3, steps * R), np.float32)
    rv[:, :row_v.shape[1]] = row_v
    rv = rv.reshape(3, steps, R)
    row_acc = np.zeros((3, R))
    for s in range(steps):
        row_acc = row_acc + rv[:, s].astype(f8)
    acc[1:, :, E.PAIR_THREADS:] = row_acc.reshape(3, blocks, E.ROW_THREADS)
    warps = _butterfly(acc.reshape(4, blocks, E.THREADS // 32, 32))
    part = np.zeros((4, blocks))
    for w in range(E.THREADS // 32):
        part = part + warps[:, :, w]
    last = np.zeros((4, 128))
    for b0 in range(0, blocks, 128):
        chunk = part[:, b0:b0 + 128]
        last[:, :chunk.shape[1]] = last[:, :chunk.shape[1]] + chunk
    wsum = _butterfly(last.reshape(4, 4, 32))
    out = np.zeros(4)
    for w in range(4):
        out = out + wsum[:, w]
    return out.astype(np.float32)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("blocks", [1, 3, 264])
def test_the_kernels_order_of_addition_emulated(model, blocks):
    """The emulated order agrees with the plain sums within RTOL, and gives
    the same bits when the uncounted pairs' r, the invalid rows' stencil
    and the alignment of r change: the values the kernel does not read,
    and its two ways of loading r."""
    jp, tp, dist, albedo, jrd, rd, h = _case(model)
    p = ht.problem_j_to_numpy(jp)
    loss, lam = robust.TUKEY, LAM[model]
    got = _emulated_kernel_sums(p, rd, dist, albedo, loss, lam, h, blocks)
    want = _port(tp, rd, dist, albedo, loss, lam, h).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    m, valid = rd["mask"], p["valid"]
    assert (~m).sum() > 10 and (~valid).sum() > 10
    noisy = dict(rd, r=np.where(m[..., None], rd["r"], np.float32(np.nan)))
    noisy["r"][~m] = np.float32(3e38)
    q = dict(p)
    for name in ("nbr_idx", "lap_idx", "nbr_dir", "nbr_dist_const", "lap_dist_const",
                 "nbr_albedo_const"):
        q[name] = p[name].copy()
        q[name][~valid] = 0 if q[name].dtype.kind == "i" else np.float32(np.nan)
    for args, offset in (((q, noisy), 0), ((p, rd), 1), ((p, rd), 3), ((q, noisy), 2)):
        again = _emulated_kernel_sums(args[0], args[1], dist, albedo, loss, lam, h, blocks,
                                      offset)
        np.testing.assert_array_equal(again.view(np.int32), got.view(np.int32))
