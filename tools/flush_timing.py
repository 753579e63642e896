#!/usr/bin/env python3
"""What chip_smoke.py's timer adds to a kernel's time, on one card.

    python3 tools/flush_timing.py

chip_smoke._time_ms flushes the L2 before each timed call by writing 512 MB,
which leaves dirty lines for the timed call to write back.  This times each
call twice: after that flush, and after a read of the same buffer (a max
over it), which leaves none.  The calls: an empty launch; torch.sum over 32
and 145 MB (about the LED and the main distance block's reads), beside their
byte bounds; this tree's dist_system on N = 49152 random rows at F = 40 (the
main refinement's width) and F = 8 (the LED run's), a fifth of the pairs
masked, an Eikonal row, bit for bit with dist_system_plain; this tree's Gram
(gn.gram) on a random 640x480 frame and records, within chip_smoke.GN_S_TOL
of max|S| of gram_plain, and its empty launch of the same grid and
clusters.  Medians over chip_smoke.KERNEL_REPS.  Prints one JSON object a
line, the card's name and power limit first.  Needs the card; imports
nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from psgradientsdf_tpu_torch.ops import distcg as DC  # noqa: E402
from psgradientsdf_tpu_torch.ops import gn as G  # noqa: E402
from psgradientsdf_tpu_torch.refine.jacobians import DistJacobian  # noqa: E402
from psgradientsdf_tpu_torch.refine.render import ResidualData  # noqa: E402
from psgradientsdf_tpu_torch.refine.solvers import RegOperator  # noqa: E402

N, F_MAIN, F_LED = 49152, 40, 8
W, H = 640, 480


def emit(**fields):
    print(json.dumps(fields), flush=True)


def clean_ms(fn, flush):
    """chip_smoke._time_ms with the L2 flushed by a read of the flush
    buffer (a max over it) in place of its write: the timed call then finds
    no dirty lines of the flush to write back."""
    for _ in range(3):
        fn()
    times = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(cs.KERNEL_REPS):
        torch.cuda.synchronize()
        flush.max()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def both_ms(fn, flush):
    """{"ms": after chip_smoke's flush (a write), "clean_ms": after a read}."""
    return {"ms": cs._time_ms(fn, flush), "clean_ms": clean_ms(fn, flush)}


def flush_costs(dev, flush):
    """An empty launch and plain reads of 32 and 145 MB, timed both ways."""
    emit(case="empty launch", **both_ms(lambda: torch.cuda._sleep(0), flush))
    for mb in (32, 145):
        x = torch.ones(mb * 1000 * 1000 // 4, device=dev)
        emit(case=f"torch.sum over {mb} MB", bound_ms=mb * 1e6 / cs.HBM_BYTES_PER_S * 1e3,
             **both_ms(lambda: x.sum(), flush))
        del x


def system_inputs(gen, n, f, dev):
    """rd (w, r [n,f,3]), DJ (J0 [n,f,3], Ji [n,3,f,3]) and an Eikonal row,
    random from `gen`."""
    rnd = lambda *s: torch.randn(*s, generator=gen)
    mask = torch.rand(n, f, 1, generator=gen) > 0.2
    w = torch.where(mask, torch.rand(n, f, 3, generator=gen), 0.0)
    rd = ResidualData(r=(0.1 * rnd(n, f, 3)).to(dev), w=w.to(dev), mask=None, p_cam=None,
                      uv=None, g_img=None)
    DJ = DistJacobian(J0=rnd(n, f, 3).to(dev), Ji=(0.5 * rnd(n, 3, f, 3)).to(dev))
    eik = RegOperator(r=(0.1 * rnd(n)).to(dev), J0=rnd(n).to(dev), Ji=rnd(n, 3).to(dev),
                      nbr_idx=None)
    return rd, DJ, eik


def system_times(gen, dev, flush):
    for f in (F_MAIN, F_LED):
        rd, DJ, eik = system_inputs(gen, N, f, dev)
        run = lambda: DC.dist_system(rd, DJ, eik, reg_weight_n=0.3)
        got, want = run(), DC.dist_system_plain(rd, DJ, eik, reg_weight_n=0.3)
        torch.cuda.synchronize()
        if not all(bool(torch.equal(x, y)) for x, y in zip(got, want)):
            raise SystemExit(f"dist_system (F = {f}) differs from its plain version")
        nbytes = N * 3 * f * 24 + N * 20 + N * 56
        emit(case="dist_system", keyframes=f, rows=N, bytes=nbytes,
             bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
             plan=DC.system_plan(dev, N, 3 * f)._asdict(), **both_ms(run, flush),
             bit_identical=True)
        del rd, DJ, eik, got, want


def gram_inputs(gen, dev):
    """A 640x480 frame (random depth), random frozen records [N, 8] (a fifth
    masked) and a pose near the identity."""
    n = W * H
    depth = 0.5 + 1.5 * torch.rand(H, W, generator=gen)
    g = torch.randn(n, 3, generator=gen)
    g = g / g.norm(dim=1, keepdim=True)
    rec = torch.cat([0.01 * torch.randn(n, 1, generator=gen), g,
                     torch.randn(n, 3, generator=gen),
                     (torch.rand(n, 1, generator=gen) > 0.2).float()], 1)
    K = torch.tensor([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
    pose = torch.eye(4)
    pose[:3, :3] = torch.linalg.matrix_exp(torch.tensor(
        [[0.0, -0.02, 0.01], [0.02, 0.0, -0.03], [-0.01, 0.03, 0.0]]))
    pose[:3, 3] = torch.tensor([0.01, -0.02, 0.03])
    frame = G.GnFrame(None, depth.to(dev), K.to(dev), stride=1, zmin=0.1, zmax=5.0)
    return frame, pose.to(dev), rec.to(dev).contiguous()


def gram_times(gen, dev, flush):
    frame, pose, records = gram_inputs(gen, dev)
    want = G.gram_plain(frame.points()[0], pose, G.unpack_records(records))
    run = lambda: G.gram(frame, pose, records)
    got = run()
    torch.cuda.synchronize()
    rel = float((got - want).abs().max()) / float(want.abs().max())
    if rel > cs.GN_S_TOL:
        raise SystemExit(f"gn.gram off the plain Gram by {rel} of max|S|")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit(case="gn.gram", pixels=frame.n,
         bound_ms=(frame.n * 36 + 256) / cs.HBM_BYTES_PER_S * 1e3,
         plan=G.gram_plan(frame.n, sms)._asdict(),
         **both_ms(run, flush), rel_err=rel,
         latency_floor=both_ms(lambda: G.gram_floor(frame, records), flush))


def main():
    if len(sys.argv) != 1 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit(card=smi, torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=dev)
    flush_costs(dev, flush)
    system_times(gen, dev, flush)
    gram_times(gen, dev, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
