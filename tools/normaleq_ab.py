#!/usr/bin/env python3
"""Times the pose and light normal-equation kernel of this tree
(csrc/normaleq.cu: one launch a call) against the earlier design (a tile
pass, then a reduction launch), in turns on one card.

    git show 50fe611:psgradientsdf_tpu_torch/csrc/normaleq.cu > archive_check/normaleq_earlier.cu
    python3 tools/normaleq_ab.py archive_check/normaleq_earlier.cu

Builds both sources with nvcc into a temporary directory (printing each
kernel's registers and spill stores from -Xptxas -v).  The two have
different C interfaces: this tree's is driven through ops/normaleq.py's
wrappers on its own build, the earlier one through _Earlier below (its
argument structs, its plan _earlier_plan and its [tiles, F, S] partials).
Makes random inputs from a fixed seed at the refinement's main shapes
(49152 voxel slots x 40 keyframes, a fifth of the pairs masked; the LED
pose at 8 keyframes; the SH light at B = 4 and 9), and for each case runs
this tree's build, the earlier, the earlier, this tree's: each run's H and
g against the plain version (ops/normaleq.py, solvers.py) and its median
time over chip_smoke.KERNEL_REPS with the L2 flushed, beside the bytes
bound (chip_smoke's count).  Prints one JSON object a line, the card's
name and power limit first.  Needs the card; imports nothing of JAX.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from psgradientsdf_tpu_torch import kernels  # noqa: E402
from psgradientsdf_tpu_torch.ops import normaleq as NE  # noqa: E402
from psgradientsdf_tpu_torch.refine import solvers  # noqa: E402
from psgradientsdf_tpu_torch.refine.render import ResidualData  # noqa: E402

N, F, F_LED = 49152, 40, 8


def _build(src, out):
    """nvcc on src -> (the library, {kernel: registers and spills})."""
    proc = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", out, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    regs, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif ("registers" in line or "spill" in line) and name:
            part = line.split("info    :", 1)[-1].strip()
            regs[name] = f"{regs[name]}; {part}" if name in regs else part
    return ctypes.CDLL(out), regs


# ---------------------------------------------------------------------------
# the earlier design's C interface and plan
# ---------------------------------------------------------------------------


class _EarlierPlan(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in ("frames", "lanes", "chunks", "voxels", "tiles")]


class _EarlierPoseArgs(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("g_img", "p_cam", "w", "r", "poses", "K", "albedo", "grad", "light",
          "partial", "H", "g")]
        + [(n, ctypes.c_int64) for n in ("n", "f", "led")] + [("plan", _EarlierPlan)])


class _EarlierLightArgs(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("w", "r", "J", "partial", "H", "g")]
        + [(n, ctypes.c_int64) for n in ("n", "f", "basis")] + [("plan", _EarlierPlan)])


def _earlier_plan(n, f, sms):
    """The earlier tile pass's plan: all keyframes a block up to 256, as
    many voxel lanes as 256 threads hold, tiles for two blocks an SM of at
    least a voxel and at most 32 voxels a lane."""
    FB = min(f, 256)
    R = 256 // FB
    C = -(-f // FB)
    want = max(1, -(-2 * sms // C))
    V = min(max(R, -(-n // want)), R * 32)
    V = -(-V // R) * R
    return (FB, R, C, V, max(1, -(-n // V)))


class _Earlier:
    """The earlier build's two entry points on this tree's inputs."""

    def __init__(self, lib):
        lib.pose_normal_eqs.argtypes = [ctypes.POINTER(_EarlierPoseArgs), ctypes.c_void_p]
        lib.light_normal_eqs_sh.argtypes = [ctypes.POINTER(_EarlierLightArgs),
                                            ctypes.c_void_p]
        self.lib = lib
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count

    def _outputs(self, n, f, dim):
        plan = _earlier_plan(n, f, self.sms)
        partial = torch.empty((plan[4], f, NE.terms(dim)), dtype=torch.float64, device="cuda")
        H = torch.empty((f, dim, dim), device="cuda")
        g = torch.empty((f, dim), device="cuda")
        return plan, partial, H, g

    def pose(self, rd, K, poses, albedo, grad, light, model):
        n, f = rd.w.shape[:2]
        plan, partial, H, g = self._outputs(n, f, 6)
        led = model == "LED"
        a = _EarlierPoseArgs(
            rd.g_img.data_ptr(), rd.p_cam.data_ptr(), rd.w.data_ptr(), rd.r.data_ptr(),
            poses.data_ptr(), K.data_ptr(), albedo.data_ptr() if led else None,
            grad.data_ptr() if led else None, light.data_ptr() if led else None,
            partial.data_ptr(), H.data_ptr(), g.data_ptr(), n, f, int(led),
            _EarlierPlan(*plan))
        rc = self.lib.pose_normal_eqs(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier pose_normal_eqs: CUDA error {rc}")
        return H, g

    def light(self, rd, J):
        n, f = rd.w.shape[:2]
        B = J.shape[-1]
        plan, partial, H, g = self._outputs(n, f, B)
        a = _EarlierLightArgs(rd.w.data_ptr(), rd.r.data_ptr(), J.data_ptr(),
                              partial.data_ptr(), H.data_ptr(), g.data_ptr(), n, f, B,
                              _EarlierPlan(*plan))
        rc = self.lib.light_normal_eqs_sh(ctypes.byref(a),
                                          torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier light_normal_eqs_sh: CUDA error {rc}")
        return H, g


# ---------------------------------------------------------------------------
# inputs, cases, turns
# ---------------------------------------------------------------------------


def inputs(gen, n, f, dev):
    """A residual pass's g_img, p_cam, w, r and the poses, K, albedo and
    stored gradient, random from `gen`."""
    rnd = lambda *s: torch.randn(*s, generator=gen)
    mask = torch.rand(n, f, generator=gen) > 0.2
    w = torch.where(mask[..., None], torch.rand(n, f, 3, generator=gen), 0.0)
    r = torch.where(mask[..., None], 0.1 * rnd(n, f, 3), 0.0)
    p = torch.stack([0.4 * rnd(n, f), 0.3 * rnd(n, f),
                     0.6 + 1.2 * torch.rand(n, f, generator=gen)], -1)
    rd = ResidualData(r=r, w=w, mask=mask, p_cam=p, uv=torch.zeros(n, f, 2),
                      g_img=2.0 * rnd(n, f, 3, 2))
    q, _ = torch.linalg.qr(rnd(f, 3, 3))
    poses = torch.eye(4).repeat(f, 1, 1)
    poses[:, :3, :3] = q
    poses[:, :3, 3] = 0.3 * rnd(f, 3)
    K = torch.tensor([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
    return (ResidualData(*(t.to(dev).contiguous() for t in rd)), K.to(dev),
            poses.to(dev), torch.rand(n, 3, generator=gen).to(dev), rnd(n, 3).to(dev))


def rel_errors(got, want):
    """(H's error of each keyframe's max|H|, g's of its max|g|), worst."""
    (H, g), (Hp, gp) = got, want
    return (float(((H - Hp).abs().amax((1, 2)) / Hp.abs().amax((1, 2)).clamp(min=1e-30)).max()),
            float(((g - gp).abs().amax(1) / gp.abs().amax(1).clamp(min=1e-30)).max()))


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="normaleq_ab_") as tmp:
        this, regs = _build(kernels.source_path("normaleq"), os.path.join(tmp, "libthis.so"))
        print(json.dumps({"build": "this", "registers": regs}), flush=True)
        lib, regs = _build(os.path.abspath(sys.argv[1]), os.path.join(tmp, "libearlier.so"))
        earlier = _Earlier(lib)
        print(json.dumps({"build": "earlier", "source": sys.argv[1], "registers": regs}),
              flush=True)
        NE._bound = NE._bind(this)
        NE._clusters.clear()
        gen = torch.Generator().manual_seed(cs.SEED)
        rd, K, poses, albedo, grad = inputs(gen, N, F, dev)
        lrd, lK, lposes, lalbedo, lgrad = inputs(gen, N, F_LED, dev)
        light = torch.tensor([1.2, 1.1, 0.9], device=dev)
        pose_bytes = lambda n, f, led: (n * f * 60 + f * 64 + 36 + (n * 24 + 12 if led else 0)
                                        + f * 42 * 4)
        cases = [
            ("pose SH1", pose_bytes(N, F, False),
             {"this": lambda: NE.pose_normal_eqs(rd, K, poses, albedo, grad, None, "SH1"),
              "earlier": lambda: earlier.pose(rd, K, poses, albedo, grad, None, "SH1")},
             lambda: NE.pose_normal_eqs_plain(rd, K, poses, albedo, grad, None, "SH1"),
             NE.reduce_plan(dev, N, F, 6, False)),
            ("pose LED", pose_bytes(N, F_LED, True),
             {"this": lambda: NE.pose_normal_eqs(lrd, lK, lposes, lalbedo, lgrad, light,
                                                 "LED"),
              "earlier": lambda: earlier.pose(lrd, lK, lposes, lalbedo, lgrad, light, "LED")},
             lambda: NE.pose_normal_eqs_plain(lrd, lK, lposes, lalbedo, lgrad, light, "LED"),
             NE.reduce_plan(dev, N, F_LED, 6, True))]
        for B in (4, 9):
            J = (0.5 * torch.randn(N, 3, B, generator=gen)).to(dev)
            cases.append((f"light B={B}", N * F * 24 + N * 12 * B + F * (B * B + B) * 4,
                          {"this": lambda J=J: NE.light_normal_eqs_sh(rd, J),
                           "earlier": lambda J=J: earlier.light(rd, J)},
                          lambda J=J: solvers.light_normal_eqs_sh(rd, J),
                          NE.reduce_plan(dev, N, F, B, False)))
        flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=dev)
        for name, nbytes, runs, plain, plan in cases:
            want = plain()
            bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
            print(json.dumps({"case": name, "bytes": nbytes, "bound_ms": bound_ms,
                              "plan": plan._asdict()}), flush=True)
            for tag in ("this", "earlier", "earlier", "this"):
                got, again = runs[tag](), runs[tag]()
                torch.cuda.synchronize()
                h_err, g_err = rel_errors(got, want)
                ms = cs._time_ms(runs[tag], flush)
                print(json.dumps(dict(
                    case=name, build=tag, ms=ms, bound_ms=bound_ms,
                    share_of_bound=bound_ms / ms, H_rel_err=h_err, g_rel_err_of_max=g_err,
                    bit_identical_runs=all(bool(torch.equal(x, y))
                                           for x, y in zip(got, again)))), flush=True)
        NE._bound = None
        NE._clusters.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
