#!/usr/bin/env python3
"""What a CUDA graph of the refinement iteration can hold, on one card.

    python3 tools/capture_probe.py [--refine]

Prints one JSON object a line, the card's name and power limit first:
  * `launch_capture`: a scratch CUDA source (written under the package's
    ignored build/ directory, built with kernels.NVCC_FLAGS) captures into
    a graph, through the runtime's stream capture, a cooperative kernel
    that crosses grid.sync() launched by cudaLaunchCooperativeKernel, the
    same kernel launched by cudaLaunchKernelEx with
    cudaLaunchAttributeCooperative, and a kernel of 8-block thread block
    clusters launched by cudaLaunchKernelEx; each graph is instantiated and
    launched twice and its result checked.  The error each step returned
    is printed.
  * `torch_capture`: torch.cuda.graph around torch.linalg.solve_ex on
    [40, 6, 6] float32 (the pose solve), around torch.linalg.eigh on
    [40, 4, 4] (the light solve before ops/smallsolve.py), and around
    ops/smallsolve.light_solve; each replayed result against an eager run.
  * with --refine: the smoke run's main scan and SH1 refinement
    (chip_smoke.run_scan at full size) with the graphed loop, its stop,
    iterations and energy trace against the same refinement with
    capture=False, and every host synchronisation of an eager warm
    iteration (torch.cuda.set_sync_debug_mode) with the Python frames that
    made it.
Needs the card; imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import traceback
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from psgradientsdf_tpu_torch import kernels  # noqa: E402

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ int scratch[8 * 128];

__global__ void coop_kernel(int* out, int n) {
  cg::grid_group grid = cg::this_grid();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) scratch[i] = i;
  grid.sync();
  if (i < n) out[i] = scratch[i] + scratch[(i + 1) % n];
}

__global__ void __cluster_dims__(8, 1, 1) cluster_kernel(int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = i + 1;
}

extern "C" int probe(int mode, int* out, int n, int* errors) {
  // errors: begin, launch, end, instantiate, launch 1, launch 2, sync
  cudaStream_t s;
  cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  const int blocks = 8, threads = 128;
  void* args[] = {&out, &n};
  errors[0] = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
  if (mode == 0) {
    errors[1] = cudaLaunchCooperativeKernel((void*)coop_kernel, dim3(blocks), dim3(threads),
                                            args, 0, s);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    if (mode == 1) {
      attr[0].id = cudaLaunchAttributeCooperative;
      attr[0].val.cooperative = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      errors[1] = cudaLaunchKernelEx(&cfg, coop_kernel, out, n);
    } else {
      errors[1] = cudaLaunchKernelEx(&cfg, cluster_kernel, out);
    }
  }
  cudaGraph_t g = nullptr;
  errors[2] = cudaStreamEndCapture(s, &g);
  cudaGraphExec_t ge = nullptr;
  errors[3] = g ? cudaGraphInstantiate(&ge, g, 0) : -1;
  errors[4] = ge ? cudaGraphLaunch(ge, s) : -1;
  errors[5] = ge ? cudaGraphLaunch(ge, s) : -1;
  errors[6] = cudaStreamSynchronize(s);
  if (ge) cudaGraphExecDestroy(ge);
  if (g) cudaGraphDestroy(g);
  cudaStreamDestroy(s);
  cudaGetLastError();
  return 0;
}
"""


def emit(what, **fields):
    print(json.dumps(dict(probe=what, **fields), default=str), flush=True)


def launch_capture():
    import ctypes

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(kernels.BUILD_DIR, "capture_probe.cu")
    lib = os.path.join(kernels.BUILD_DIR, "libcapture_probe.so")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    r = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                       capture_output=True, text=True)
    if r.returncode:
        emit("launch_capture", built=False, log=r.stdout + r.stderr)
        return
    so = ctypes.CDLL(lib)
    so.probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    n = 8 * 128
    for mode, name in enumerate(("cudaLaunchCooperativeKernel",
                                 "cudaLaunchKernelEx cooperative",
                                 "cudaLaunchKernelEx cluster")):
        out = torch.zeros(n, dtype=torch.int32, device="cuda")
        errors = torch.zeros(7, dtype=torch.int32)
        torch.cuda.synchronize()
        so.probe(mode, out.data_ptr(), n, errors.data_ptr())
        torch.cuda.synchronize()
        i = torch.arange(n, dtype=torch.int64, device="cuda")
        if mode < 2:
            # each launch: out = i + (i + 1) % n, read across the grid barrier
            want = (i + (i + 1) % n).to(torch.int32)
        else:
            want = (i + 1).to(torch.int32)
        emit("launch_capture", launch=name, errors=errors.tolist(),
             result_ok=bool(torch.equal(out, want)))


def _captured(fn, *args):
    """fn(*args) eagerly, then captured and replayed -> (equal, error)."""
    want = fn(*args)
    torch.cuda.synchronize()
    try:
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            fn(*args)                        # warm on the capture's stream
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(g, stream=s, capture_error_mode="thread_local"):
            got = fn(*args)
        g.replay()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(
            want if isinstance(want, tuple) else (want,),
            got if isinstance(got, tuple) else (got,)))
        return same, None
    except Exception as e:               # reported, not hidden: the probe's answer
        torch.cuda.synchronize()
        return False, repr(e)[:400]


def torch_capture():
    from psgradientsdf_tpu_torch.ops import smallsolve

    gen = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn(40, 6, 6, device="cuda", generator=gen)
    H = A @ A.mT + torch.eye(6, device="cuda")
    g = torch.randn(40, 6, 1, device="cuda", generator=gen)
    L = torch.randn(40, 30, 4, device="cuda", generator=gen)
    HL = L.mT @ L
    gl = torch.randn(40, 4, device="cuda", generator=gen)
    for name, fn, args in (
            ("torch.linalg.solve_ex [40,6,6]", lambda a, b: torch.linalg.solve_ex(a, b), (H, g)),
            ("torch.linalg.eigh [40,4,4]", lambda a: torch.linalg.eigh(a), (HL,)),
            ("smallsolve.light_solve [40,4,4]", smallsolve.light_solve, (HL, gl))):
        same, err = _captured(fn, *args)
        emit("torch_capture", call=name, captured=err is None, replay_equal=same, error=err)


def light_solve_check():
    from psgradientsdf_tpu_torch.ops import smallsolve

    r = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                        os.path.join(kernels.BUILD_DIR, "libsmallsolve_v.so"),
                        kernels.source_path("smallsolve")], capture_output=True, text=True)
    emit("smallsolve_ptxas", rc=r.returncode,
         log=[l for l in (r.stdout + r.stderr).splitlines() if "registers" in l or "error" in l])
    gen = torch.Generator().manual_seed(1)
    for B in (4, 9):
        for F in (1, 33, 40):
            for kind in ("full", "rank1", "zero"):
                rows = torch.randn(F, 3 * 64, B, generator=gen)
                if kind == "rank1":
                    rows = rows[..., :1] * torch.randn(B, generator=gen)
                H = (rows.mT @ rows).float()
                if kind == "zero":
                    H = torch.zeros_like(H)
                g = torch.randn(F, B, generator=gen)
                want = smallsolve.light_solve_plain(H, g)
                rot = []
                got = smallsolve.light_solve(H.cuda(), g.cuda(), rotations_out=rot)
                again = smallsolve.light_solve(H.cuda(), g.cuda())
                err = float((got.cpu() - want).abs().max() / want.abs().max().clamp(min=1e-30))
                emit("light_solve", B=B, F=F, kind=kind, rel_err=err,
                     twice_bits=bool(torch.equal(got, again)),
                     rotations_max=int(rot[0].max()))


def refine():
    import tempfile

    import chip_smoke as cs
    from psgradientsdf_tpu_torch.refine import optimizer as opt

    seq = cs.make_sequence(cs.FRAMES)
    with tempfile.TemporaryDirectory(prefix="capture_probe_") as tmp:
        # every host synchronisation of an eager warm iteration, with its frames
        syncs = []
        real = opt._iteration_core

        def traced(*a, **kw):
            def show(message, category, filename, lineno, file=None, line=None):
                syncs.append(dict(message=str(message)[:120],
                                  stack=[f"{f.filename.split('/repo/')[-1]}:{f.lineno} {f.name}"
                                         for f in traceback.extract_stack()[-12:-2]]))
            old = warnings.showwarning
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return real(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                warnings.showwarning = old

        runs = {}
        for capture in (False, True):
            kind = opt.PhotometricRefiner.loop_kind
            if not capture:
                opt.PhotometricRefiner.loop_kind = lambda self: ("eager", "capture=False")
                opt._iteration_core = traced
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("always")
                    run = cs.run_scan(tmp, f"scan_{capture}", seq, cs.FRAMES - 1, "dma",
                                      refine=cs.REFINE_SH1)
            except Exception:
                emit("refine", capture=capture, error=traceback.format_exc()[-3000:])
                continue
            finally:
                opt.PhotometricRefiner.loop_kind = kind
                opt._iteration_core = real
            ref = run["pipe"].refiner
            runs[capture] = ref
            emit("refine", capture=capture, stop=ref.stop_reason,
                 iterations=ref.iterations_run, captures=ref.graph_captures,
                 seconds=run["summary"]["refine_seconds"],
                 loops=[e for e in run["events"] if e["event"] in ("refine_loop", "refine_graph")],
                 iteration_seconds=[e.get("seconds") for e in run["events"]
                                    if e["event"] == "iteration"])
        seen = {}
        for s in syncs:
            seen.setdefault(" <- ".join(reversed(s["stack"][-6:])), 0)
            seen[" <- ".join(reversed(s["stack"][-6:]))] += 1
        emit("host_syncs_of_eager_iterations", count=len(syncs),
             sites=[dict(where=k, times=v) for k, v in seen.items()])
        if len(runs) == 2:
            a, b = runs[False], runs[True]
            emit("refine_equal", trace=a.energy_trace == b.energy_trace,
                 state={n: bool(torch.equal(getattr(a, n), getattr(b, n)))
                        for n in ("dist", "albedo", "grad_stored", "poses", "lights")})


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    emit("versions", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0))
    launch_capture()
    light_solve_check()
    torch_capture()
    if "--refine" in sys.argv[1:]:
        refine()


if __name__ == "__main__":
    main()
