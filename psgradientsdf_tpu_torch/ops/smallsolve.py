"""The SH light block's clipped eigen-solve: one launch of the hand-written
Hopper kernel in csrc/smallsolve.cu, or its plain PyTorch version for CPU
tensors.

  light_solve(H, g) -> delta [F, B]
      H [F, B, B] (its lower triangle is read), g [F, B], float32, B = 4 or
      9: per keyframe delta = V inv V^T g from the eigen-decomposition
      H = V diag(lambda) V^T in float64, an eigenvalue lambda <=
      1e-6 max(lambda_max, 0) given 1 / lambda = 0, rounded to float32.

It replaces the tail of the JAX package's psgradientsdf_tpu/refine/
solvers.py `solve_light_sh` (:512; jnp.linalg.eigh and the clipped products
:531-535), which runs inside the JAX package's one-dispatch iteration.  The
kernel (one warp a keyframe, Jacobi in double) waits for nothing, so a CUDA
graph of the refinement iteration holds it (refine/graph.py); a batched
torch.linalg.eigh on the card waits for the host.  Its rotations follow a
parallel (round-robin) ordering, `jacobi_rounds(B)`: the disjoint rotations
of a round run at once, one lane a pair, and the update of every entry they
touch is spread over the warp's lanes.  `jacobi_plan(B)` lays that schedule
out for the kernel's lanes: the kernel reads it and computes no index
itself.  The plain version is torch.linalg.eigh on the float64 casts with
the same clip and products; the two agree to double rounding where no
eigenvalue sits at the clip.

A wrapper takes the plain version ONLY for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.  `launch_counts` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_LIB_NAME = "smallsolve"
launch_counts: Dict[str, int] = {"light_solve": 0}

MAX_BASIS = 9
CLIP = 1e-6
LANES = 32                 # a warp a keyframe
V_ROWS_PER_LANE = 3        # ceil(B / (LANES // B)) for every B <= MAX_BASIS
NONE = 0xFF                # an absent entry in the plan's bytes


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def jacobi_rounds(B: int) -> List[List[Tuple[int, int]]]:
    """The kernel's Jacobi ordering for B coefficients: one sweep as its
    rounds, each a list of disjoint pairs (p, q), p < q.  B is padded to an
    even n (the pairs of the padding index dropped); round r of the n - 1
    pairs slot 0 as (r, n - 1) and slot k as (r + k, r - k) mod n - 1 (the
    circle method), so every pair comes once a sweep."""
    n = B + (B & 1)
    m = n - 1
    rounds = []
    for r in range(m):
        pairs = []
        for slot in range(n // 2):
            a, b = (r, m) if slot == 0 else ((r + slot) % m, (r - slot) % m)
            if max(a, b) < B:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
    return rounds


def packed_index(B: int, x: int, y: int) -> int:
    """Entry (x, y) of a symmetric BxB matrix in its packed upper triangle
    (row by row, the diagonal first)."""
    a, b = min(x, y), max(x, y)
    return a * (2 * B - a + 1) // 2 + b - a


def lane_entries(B: int, lane: int):
    """What lane `lane` owns through the solve: (i, j0, j1), two entries of
    row i of the upper triangle, j1 = j0 + 1 (None past the row's end; i
    None for a lane past the triangle), and (vr, vc): V's column vc at rows
    vr + L k, L = LANES // B (vr None for a lane past V)."""
    start, row = 0, (None, None, None)
    for i in range(B):
        lanes = (B - i + 1) // 2
        if lane < start + lanes:
            j0 = i + 2 * (lane - start)
            row = (i, j0, j0 + 1 if j0 + 1 < B else None)
            break
        start += lanes
    L = LANES // B
    return row + ((lane // B if lane // B < L else None), lane % B)


@functools.lru_cache(maxsize=None)
def jacobi_plan(B: int) -> np.ndarray:
    """The kernel's plan for B coefficients, uint32 [n, LANES, 4] (n - 1
    rounds of jacobi_rounds(B) after a header row), each (row, lane) one
    uint4 that lane of csrc/smallsolve.cu reads:
      header   x: packed offsets of its own entries (i, j0), (i, j1), then i
                  and j0; y: j1, vr, vc, L; z: packed offsets of (i, i),
                  (j0, j0), (j1, j1);
      round r  x, y: for its entry (i, j) (j = j0, j1): the packed offsets
                  of (i, pj), (pi, j) and (pi, pj) (pi: i's partner in the
                  round, i itself if unpaired) and 1 where (i, j) is the
                  round's pair;
               z: the lane holding the rotation of i, j0, j1 and vc (3 bits)
                  with 1 in bit 3 where the index is its pair's p, 4 bits
                  each, and the lane holding V's column partner of vc at the
                  same rows (bits 16-20);
               w: lane k < len(pairs) computes pair k: the packed offsets of
                  (p, p), (q, q), (p, q) and kind 1; where B is odd the next
                  lane stands for the unpaired index (kind 2: no rotation)."""
    if not 1 <= B <= MAX_BASIS:
        raise ValueError(f"jacobi_plan: {B} coefficients, at most {MAX_BASIS}")
    rounds = jacobi_rounds(B)
    plan = np.zeros((len(rounds) + 1, LANES, 4), np.uint32)
    pk = functools.partial(packed_index, B)
    for lane in range(LANES):
        i, j0, j1, vr, vc = lane_entries(B, lane)
        own = [NONE if i is None or j is None else pk(i, j) for j in (j0, j1)]
        byte = [NONE if v is None else v for v in (i, j0, j1, vr)]
        plan[0, lane] = (own[0] | own[1] << 8 | byte[0] << 16 | byte[1] << 24,
                         byte[2] | byte[3] << 8 | vc << 16 | (LANES // B) << 24,
                         sum(NONE << 8 * k if j is None else pk(j, j) << 8 * k
                             for k, j in enumerate((i, j0, j1))), 0)
    for r, pairs in enumerate(rounds, start=1):
        partner = list(range(B))
        slot = [len(pairs)] * B                  # the unpaired index's lane
        for k, (p, q) in enumerate(pairs):
            partner[p], partner[q] = q, p
            slot[p] = slot[q] = k
        code = [slot[x] | (x <= partner[x]) << 3 for x in range(B)]
        for lane in range(LANES):
            i, j0, j1, vr, vc = lane_entries(B, lane)
            i = 0 if i is None else i
            words = []
            for j in (j0, j1):
                j = i if j is None else j
                pi, pj = partner[i], partner[j]
                words.append(pk(i, pj) | pk(pi, j) << 8 | pk(pi, pj) << 16
                             | int(i != j and pi == j) << 24)
            jj = [i if j is None else j for j in (j0, j1)]
            z = (code[i] | code[jj[0]] << 4 | code[jj[1]] << 8 | code[vc] << 12
                 | (lane - vc + partner[vc]) % LANES << 16)
            w = 0
            if lane < len(pairs):
                p, q = pairs[lane]
                w = pk(p, p) | pk(q, q) << 8 | pk(p, q) << 16 | 1 << 24
            elif lane == len(pairs) and B % 2:
                w = 2 << 24
            plan[r, lane] = (words[0], words[1], z, w)
    return plan


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def light_solve_plain(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta [F,B] = V inv V^T g from torch.linalg.eigh of H in float64,
    eigenvalues <= CLIP * max(lambda_max, 0) dropped, rounded to g's type
    (float32 on the refinement's path; float64 inputs keep every digit)."""
    vals, vecs = torch.linalg.eigh(H.double())            # [F,B], [F,B,B]
    vmax = torch.amax(vals, dim=-1, keepdim=True)
    inv = torch.where(vals > torch.clamp(vmax, min=0.0) * CLIP, 1.0 / vals, 0.0)
    gv = torch.einsum("fdb,fd->fb", vecs, g.double())     # V^T g
    return torch.einsum("fbd,fd->fb", vecs, inv * gv).to(g.dtype)


# ---------------------------------------------------------------------------
# the C interface and the library
# ---------------------------------------------------------------------------


class _SolveArgs(ctypes.Structure):
    """csrc/smallsolve.cu SolveArgs, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("H", "g", "delta", "rotations")]
                + [(n, ctypes.c_int64) for n in ("F", "B")]
                + [(n, ctypes.c_void_p) for n in ("rounds", "plan")])


_plans: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _plan_on(dev, B: int) -> torch.Tensor:
    """jacobi_plan(B) on the card, copied once a device (the first call of
    a CUDA graph's warm-up makes it, before the capture)."""
    key = (torch.device(dev), B)
    if key not in _plans:
        _plans[key] = torch.from_numpy(jacobi_plan(B).view(np.int32)).to(dev)
    return _plans[key]


_bound = None


def _library():
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        for name in ("light_solve", "light_solve_floor"):
            getattr(lib, name).argtypes = [ctypes.POINTER(_SolveArgs), ctypes.c_void_p]
            getattr(lib, name).restype = ctypes.c_int
        _bound = lib
    return _bound


def _call(name: str, a: _SolveArgs, dev) -> None:
    with torch.cuda.device(dev):
        rc = getattr(_library(), name)(ctypes.byref(a),
                                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")


def _shape(H: torch.Tensor, g: torch.Tensor):
    if H.dim() != 3 or H.shape[1] != H.shape[2] or tuple(g.shape) != tuple(H.shape[:2]):
        raise ValueError(f"light_solve: H must be [F,B,B] and g [F,B], got "
                         f"{tuple(H.shape)} and {tuple(g.shape)}")
    F, B = H.shape[0], H.shape[1]
    if not 1 <= B <= MAX_BASIS:
        raise ValueError(f"light_solve: {B} coefficients, at most {MAX_BASIS}")
    return F, B


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def light_solve(H: torch.Tensor, g: torch.Tensor, *,
                rotations_out: Optional[List] = None,
                rounds_out: Optional[List] = None) -> torch.Tensor:
    """delta [F,B] (see the module docstring): one kernel launch on CUDA
    tensors, light_solve_plain on CPU tensors.  `rotations_out` receives the
    Jacobi rotations each keyframe applied and `rounds_out` the rounds that
    applied one (the serial chain that sets the kernel's time), each [F]
    int32 on the card; the plain version applies none and gives nothing."""
    F, B = _shape(H, g)
    if H.device.type == "cpu":
        return light_solve_plain(H, g)
    dev = H.device
    for name, t in (("H", H), ("g", g)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"light_solve: {name} must be float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    H, g = H.contiguous(), g.contiguous()
    delta = torch.empty((F, B), dtype=torch.float32, device=dev)
    counts = [torch.empty((F,), dtype=torch.int32, device=dev) if out is not None
              else None for out in (rotations_out, rounds_out)]
    ptr = [None if t is None else t.data_ptr() for t in counts]
    a = _SolveArgs(H.data_ptr(), g.data_ptr(), delta.data_ptr(), ptr[0], F, B, ptr[1],
                   _plan_on(dev, B).data_ptr())
    if F:
        _call("light_solve", a, dev)
        launch_counts["light_solve"] += 1
    for out, t in zip((rotations_out, rounds_out), counts):
        if out is not None:
            out.append(t)
    return delta


def light_solve_floor(F: int, B: int, dev) -> None:
    """An empty kernel launched on light_solve's grid for F keyframes: the
    launch's floor, timed beside it and counted nowhere."""
    _call("light_solve_floor", _SolveArgs(None, None, None, None, F, B, None, None), dev)
