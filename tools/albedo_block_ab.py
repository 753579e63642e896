#!/usr/bin/env python3
"""Times the albedo block's one launch (csrc/albedo.cu albedo_block_kernel)
against the earlier design's two launches (albedo_system_kernel, then
albedo_cg_kernel) and against the two-launch form of this tree's kernel
(phases 1, then 2), in turns on one card.

    git show 6b90485:psgradientsdf_tpu_torch/csrc/albedo.cu > archive_check/albedo_parent.cu
    python3 tools/albedo_block_ab.py archive_check/albedo_parent.cu

(In a git checkout a revision may stand in place of the path: the tool then
reads that revision's csrc/albedo.cu with git show itself.)  Builds the
earlier source with nvcc into a temporary directory against this tree's
csrc/ headers (cg_sync.cuh's sums keep their earlier layout by default) and
drives it through _Earlier below (its argument structs, its plan and its
sync words); this tree's kernel runs from the package's own build through
ops/albedo.py.  Prints each build's registers and spill stores (-Xptxas -v).
Makes random inputs from a fixed seed at the refinement's shapes (49152
voxel slots x 40 keyframes under SH1 and SH2, a fifth of the pairs masked
and a sixth of the rows invalid; the LED run's 8 keyframes; four times the
voxels under SH1), the recipes' regularizer weight 0 and damping 1, scipy's
stop rule, and for each case runs the earlier pair, the one launch, the two
launches, then the two launches, the one launch, the earlier pair: each
run's delta, new albedo and steps against the earlier pair's bit for bit
(and its b and diag_ps against the earlier system kernel's and
albedo_system_plain's), and its median time over chip_smoke.KERNEL_REPS
with the L2 flushed; then the system half alone (phases 1) and the one
launch on rings of 1 and 3 stages a warp (the plan takes 2), where they
fit.  Prints the card's name and power limit first, then one JSON object a
case.  Needs the card; imports nothing of JAX.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from psgradientsdf_tpu_torch import kernels  # noqa: E402
from psgradientsdf_tpu_torch.ops import albedo as AL  # noqa: E402
from psgradientsdf_tpu_torch.ops import distcg  # noqa: E402
from psgradientsdf_tpu_torch.refine.render import ResidualData  # noqa: E402

CASES = (("SH1 main", 49152, 40, "SH1", 1), ("SH2 main", 49152, 40, "SH2", 2),
         ("LED run", 49152, 8, "LED", 1), ("SH1 four copies", 4 * 49152, 40, "SH1", 1))
CG = dict(reg_weight_rho=0.0, damping=1.0, cg_iters=100, cg_tol=1e-6, cg_static=False)


def _source(arg):
    """The earlier albedo.cu: the file at `arg`, else `arg` as a revision
    read with git show."""
    if os.path.isfile(arg):
        return open(arg).read()
    return subprocess.run(["git", "show", f"{arg}:psgradientsdf_tpu_torch/csrc/albedo.cu"],
                          cwd=ROOT, capture_output=True, text=True, check=True).stdout


def _build(src, out):
    """nvcc on src (this tree's csrc/ on the include path) -> (the library,
    {kernel: registers and spills})."""
    proc = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
                           "-I", kernels.CSRC_DIR, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    regs, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif ("registers" in line or "spill" in line) and name:
            part = line.split("info    :", 1)[-1].strip()
            regs[name] = f"{regs[name]}; {part}" if name in regs else part
    return ctypes.CDLL(out), regs


# ---------------------------------------------------------------------------
# the earlier design's C interface, plan and sync words
# ---------------------------------------------------------------------------


_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double


class _SystemArgs(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("w", "r", "p_cam", "grad", "lights", "poses", "valid",
                                   "albedo", "nbr", "rev", "nbr_dir", "nbr_const", "b",
                                   "diag_ps", "diag", "r_reg", "J0r", "Jir")]
                + [(n, _I) for n in ("n", "f", "basis", "led", "reg")]
                + [(n, _D) for n in ("inv_h", "reg_weight_rho")])


class _CgArgs(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("b", "diag_ps", "diag", "J0r", "Jir", "nbr", "rev",
                                   "valid", "albedo", "delta", "albedo_out", "steps", "work",
                                   "sync")]
                + [(n, _I) for n in ("n", "maxiter", "fixed", "reg", "blocks", "tile",
                                     "smem_bytes", "shared")]
                + [(n, _D) for n in ("reg_weight_rho", "damping", "tol_sq")])


class _Earlier:
    """The earlier two launches (no regularizer): albedo_system, then
    albedo_cg on distcg._cg_plan's tiles with its vectors in shared memory
    up to its own tile limit."""
    HEADER = (distcg.CG_THREADS // 32) * 2 * 4 + 16

    def __init__(self, lib):
        lib.albedo_system.argtypes = [ctypes.POINTER(_SystemArgs), ctypes.c_void_p]
        lib.albedo_system.restype = ctypes.c_int
        lib.albedo_cg.argtypes = [ctypes.POINTER(_CgArgs), ctypes.c_void_p]
        lib.albedo_cg.restype = ctypes.c_int
        self.lib = lib

    def plan(self, N):
        tiles = distcg._cg_plan(N, use_lap=False, lap_nbr=False, sms=cs._sm_count())
        limit = ((distcg.SMEM_PER_BLOCK - self.HEADER) // (distcg.TILE_ROWS * 96)
                 * distcg.TILE_ROWS)
        shared = tiles.tile <= limit
        return tiles, shared, self.HEADER + (96 * tiles.tile if shared else 0)

    def run(self, c, check=True):
        """-> (delta, new albedo, steps, b, diag_ps)."""
        prob, rd, N, F = c["prob"], c["rd"], c["N"], c["F"]
        led = c["model"] == "LED"
        dev = rd.w.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        e = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        b, diag_ps = e(N, 3), e(N, 3)
        a = _SystemArgs()
        a.w, a.r, a.grad = rd.w.data_ptr(), rd.r.data_ptr(), c["grad"].data_ptr()
        a.lights, a.valid = c["lights"].data_ptr(), prob.valid.data_ptr()
        if led:
            a.p_cam, a.poses = rd.p_cam.data_ptr(), c["poses"].data_ptr()
        a.b, a.diag_ps = b.data_ptr(), diag_ps.data_ptr()
        a.n, a.f, a.basis, a.led, a.reg = N, F, 4 if c["order"] == 1 else 9, int(led), 0
        a.inv_h = AL.inv_voxel(0.014)
        rc = self.lib.albedo_system(ctypes.byref(a), stream)
        if rc:
            raise SystemExit(f"the earlier albedo_system failed: CUDA error {rc}")
        tiles, shared, smem = self.plan(N)
        delta, new = e(N, 3), e(N, 3)
        steps = torch.empty((1,), dtype=torch.int64, device=dev)
        work = e(max(0 if shared else 24 * N, 1))
        sync = torch.empty((4 + 4 * tiles.blocks,), dtype=torch.int32, device=dev)
        g = _CgArgs()
        g.b, g.diag_ps, g.diag = b.data_ptr(), diag_ps.data_ptr(), diag_ps.data_ptr()
        g.valid, g.albedo = prob.valid.data_ptr(), c["albedo"].data_ptr()
        g.delta, g.albedo_out, g.steps = delta.data_ptr(), new.data_ptr(), steps.data_ptr()
        g.work, g.sync = work.data_ptr(), sync.data_ptr()
        g.n, g.maxiter, g.fixed, g.reg = N, CG["cg_iters"], int(CG["cg_static"]), 0
        g.blocks, g.tile, g.smem_bytes, g.shared = tiles.blocks, tiles.tile, smem, int(shared)
        g.damping, g.tol_sq = CG["damping"], CG["cg_tol"] ** 2
        rc = self.lib.albedo_cg(ctypes.byref(g), stream)
        if rc:
            raise SystemExit(f"the earlier albedo_cg failed: CUDA error {rc}")
        return delta, new, steps, b, diag_ps


# ---------------------------------------------------------------------------
# this tree's kernel, one launch and two
# ---------------------------------------------------------------------------


def _args(c):
    return ((c["prob"], c["rd"], c["albedo"], c["grad"], c["lights"], c["poses"], None),
            dict(model=c["model"], order=c["order"], voxel_size=0.014, **CG))


def one_launch(c, check=True):
    """The block as the main path runs it (timed so: without system_out);
    with `check` the system written out too."""
    args, kw = _args(c)
    steps, system = [], []
    delta, new = AL.albedo_block(*args, **kw, steps_out=steps,
                                 system_out=system if check else None)
    return (delta, new, steps[0], system[0].b, system[0].diag_ps) if check else None


def two_launches(c, check=True):
    args, kw = _args(c)
    _, _, _, system = AL._launch_block(*args, **kw, phases=1)
    delta, new, steps, _ = AL._launch_block(*args, **kw, phases=2, system_in=system)
    return delta, new, steps[0], system.b, system.diag_ps


def inputs(gen, N, F, model, order):
    """Random inputs of the albedo block at N voxels x F keyframes."""
    u = lambda *s: torch.rand(s, generator=gen, device="cuda")
    n = lambda *s: torch.randn(s, generator=gen, device="cuda")
    w = u(N, F, 3) * (u(N, F, 1) > 0.2)
    p_cam = torch.stack([0.3 * n(N, F), 0.3 * n(N, F), 1.2 + 0.1 * n(N, F)], -1)
    rd = ResidualData(r=0.1 * n(N, F, 3), w=w, mask=None, p_cam=p_cam.contiguous(),
                      uv=None, g_img=None)
    rot, _ = torch.linalg.qr(n(F, 3, 3))
    poses = torch.eye(4, device="cuda").repeat(F, 1, 1)
    poses[:, :3, :3] = rot
    lights = (torch.tensor([1.2, 1.2, 1.2], device="cuda") if model == "LED"
              else 0.3 * n(F, 4 if order == 1 else 9))
    model = "LED" if model == "LED" else "SH"
    return dict(prob=types.SimpleNamespace(valid=u(N) > 0.17), rd=rd, grad=n(N, 3),
                albedo=0.1 + 0.8 * u(N, 3), lights=lights, poses=poses.contiguous(),
                model=model, order=order, N=N, F=F)


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        print("albedo_block_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="albedo_ab_") as tmp:
        src = os.path.join(tmp, "albedo_earlier.cu")
        with open(src, "w") as fh:
            fh.write(_source(sys.argv[1]))
        lib, regs = _build(src, os.path.join(tmp, "libalbedo_earlier.so"))
        _, ours = _build(kernels.source_path("albedo"), os.path.join(tmp, "libalbedo_tree.so"))
        print(json.dumps(dict(registers_earlier=regs, registers_tree=ours)), flush=True)
        earlier = _Earlier(lib)
        gen = torch.Generator(device="cuda").manual_seed(5)
        flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device="cuda")
        runs = {"earlier two launches": earlier.run, "one launch": one_launch,
                "two launches": two_launches}
        order = list(runs) + list(runs)[::-1]
        for name, N, F, model, order_sh in CASES:
            c = inputs(gen, N, F, model, order_sh)
            args, kw = _args(c)
            plain = AL.albedo_system_plain(*args, **{k: kw[k] for k in (
                "model", "order", "voxel_size", "reg_weight_rho")})
            want = earlier.run(c)
            torch.cuda.synchronize()
            if not (cs._bits_same(want[3], plain.b) and cs._bits_same(want[4], plain.diag_ps)):
                raise SystemExit(f"{name}: the earlier system is off albedo_system_plain")
            plan = AL.block_plan(c["rd"].w.device, N, F, led=model == "LED", reg=False)
            row = dict(case=name, voxels=N, keyframes=F, steps=int(want[2][0]),
                       plan=plan._asdict())
            for run in order:
                got = runs[run](c)
                torch.cuda.synchronize()
                for what, a, b in zip(("delta", "new albedo", "steps", "b", "diag_ps"),
                                      got, want):
                    if not cs._bits_same(a.reshape(-1)[:b.numel()], b.reshape(-1)):
                        raise SystemExit(f"{name}, {run}: {what} differs from the earlier "
                                         f"two launches' by {cs._abs_err(a, b)}")
                row.setdefault(f"ms, {run}", []).append(
                    cs._time_ms(lambda: runs[run](c, check=False), flush))
            row["bit_identical"] = True
            # where the one launch's time goes: its system alone (phases 1,
            # the system written out), and the one launch on rings of
            # other depths than the plan's, where they fit
            row["ms, system alone"] = cs._time_ms(
                lambda: AL._launch_block(*args, **kw, phases=1), flush)
            planned = AL.DEPTH
            for depth in (1, 3):
                AL.DEPTH = depth
                AL._plans.clear()
                got = AL.block_plan(c["rd"].w.device, N, F, led=model == "LED", reg=False)
                if got.depth == depth:
                    row[f"ms, one launch, ring depth {depth}"] = cs._time_ms(
                        lambda: one_launch(c, check=False), flush)
            AL.DEPTH = planned
            AL._plans.clear()
            print(json.dumps(row), flush=True)
            del c
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
