#!/usr/bin/env python3
"""Times the pose and light normal-equation kernels (csrc/normaleq.cu) of
this tree against another source of the same C interface, in turns on one
card.

    python3 tools/normaleq_ab.py <other normaleq.cu>

Builds both sources with nvcc into a temporary directory (printing each
kernel's registers from -Xptxas -v), makes random inputs from a fixed seed
at the refinement's main shapes (49152 voxel slots x 40 keyframes, a fifth
of the pairs masked; the LED pose at 8 keyframes; the SH light at B = 4 and
9), and for each case runs this tree's build, the other, the other, this
tree's: each run's H and g against the plain version (ops/normaleq.py) and
its median time over chip_smoke.KERNEL_REPS with the L2 flushed.  Prints one
JSON object a line, the card's name and power limit first.  Needs the card;
imports nothing of JAX.
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
    """nvcc on src -> (the library, {kernel: registers line})."""
    proc = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", out, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    regs, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line and name:
            regs[name] = line.split(":", 1)[1].strip()
    lib = ctypes.CDLL(out)
    lib.pose_normal_eqs.argtypes = [ctypes.POINTER(NE._PoseArgs), ctypes.c_void_p]
    lib.pose_normal_eqs.restype = ctypes.c_int
    lib.light_normal_eqs_sh.argtypes = [ctypes.POINTER(NE._LightArgs), ctypes.c_void_p]
    lib.light_normal_eqs_sh.restype = ctypes.c_int
    return lib, regs


def _inputs(gen, n, f, dev):
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


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="normaleq_ab_") as tmp:
        libs = {}
        for tag, src in (("this", kernels.source_path("normaleq")),
                         ("other", os.path.abspath(sys.argv[1]))):
            libs[tag], regs = _build(src, os.path.join(tmp, f"lib{tag}.so"))
            print(json.dumps({"build": tag, "source": src, "registers": regs}), flush=True)
        gen = torch.Generator().manual_seed(cs.SEED)
        rd, K, poses, albedo, grad = _inputs(gen, N, F, dev)
        lrd, lK, lposes, lalbedo, lgrad = _inputs(gen, N, F_LED, dev)
        light = torch.tensor([1.2, 1.1, 0.9], device=dev)
        cases = [
            ("pose SH1", lambda: NE.pose_normal_eqs(rd, K, poses, albedo, grad, None, "SH1"),
             lambda: NE.pose_normal_eqs_plain(rd, K, poses, albedo, grad, None, "SH1")),
            ("pose LED", lambda: NE.pose_normal_eqs(lrd, lK, lposes, lalbedo, lgrad, light,
                                                    "LED"),
             lambda: NE.pose_normal_eqs_plain(lrd, lK, lposes, lalbedo, lgrad, light, "LED"))]
        for B in (4, 9):
            J = (0.5 * torch.randn(N, 3, B, generator=gen)).to(dev)
            cases.append((f"light B={B}", lambda J=J: NE.light_normal_eqs_sh(rd, J),
                          lambda J=J: solvers.light_normal_eqs_sh(rd, J)))
        flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=dev)
        for name, kernel, plain in cases:
            Hp, gp = plain()
            for tag in ("this", "other", "other", "this"):
                NE._bound = libs[tag]
                H, g = kernel()
                torch.cuda.synchronize()
                print(json.dumps(dict(
                    case=name, build=tag, ms=cs._time_ms(kernel, flush),
                    H_rel_err=float(((H - Hp).abs().amax((1, 2))
                                     / Hp.abs().amax((1, 2))).max()),
                    g_rel_err_of_max=float(((g - gp).abs().amax(1)
                                            / gp.abs().amax(1)).max()))), flush=True)
        NE._bound = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
