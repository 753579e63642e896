"""One refinement iteration as one CUDA graph, replayed once an iteration.

The port's counterpart of the JAX package's one-dispatch iteration
(psgradientsdf_tpu/refine/optimizer.py `_iteration_core` :340-398, jitted as
`_iteration_update` :400-405 and called once an iteration at :851-862, its
programs warmed by `_warm_block_programs` :584 and `_warm_base_programs`
:655).  On one card the alternating loop (refine/optimizer.py) captures its
fused iteration once per problem and static arguments, the key on which JAX
retraces, and replays it: the host issues one graph launch an iteration in
place of some 150 runtime calls, and reads the device once after it.

  * The state (dist, albedo, grad_stored, poses, lights) lives in static
    buffers that every replay reads and writes in place; the refiner's
    attributes are those buffers, so dumps, checkpoints and the export read
    them.  A state set from outside between replays (a resume) is copied
    into them before the next replay (`IterationGraph.load`).
  * Every replay writes the iteration's readout (`pack`: each block's four
    energies and CG step count, the pose solve's status) into one small
    device tensor, copied to the host once (`replay`).  The new state is
    committed on the card only where the pose solve found no singular
    block; the loop raises on such a block after the read
    (solvers.check_pose_info), so a failed iteration changes nothing.
  * A capture executes nothing, and the kernels' wrappers count their
    launches in Python at capture: `IterationGraph` runs the iteration once
    eagerly on a scratch copy of the state first (the warm-up: every kernel
    library loaded, every host plan, stencil table, ticket and cached
    buffer made on the capture's stream), restores every launch count
    (`counters`) after the warm-up, takes the capture's difference of them
    and adds it again at every replay (utils/capture.py, the machinery the
    scan's graph, tracking/graph.py, shares).  A caller can register its
    own dicts of counts (`registered`) and functions to run after every
    replay of what is being captured (`after_replay`).
  * A capture or a replay that fails raises: nothing falls back to the
    eager loop.  There is no graph on the CPU.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from psgradientsdf_tpu_torch.ops import (albedo, distcg, distreg, energy, normaleq,
                                         residual, smallsolve)
from psgradientsdf_tpu_torch.utils import capture
from psgradientsdf_tpu_torch.utils.capture import registered  # noqa: F401

# readout slots a block: E, E_n, E_l, E_r, then its CG steps (-1: no CG)
BLOCK_SLOTS = 5

_warming = False
_capturing: Optional["IterationGraph"] = None


# ---------------------------------------------------------------- the read


def pack(energies: Sequence[torch.Tensor], steps: Sequence[Optional[torch.Tensor]],
         info: Optional[torch.Tensor]) -> torch.Tensor:
    """The iteration's readout as ONE float64 vector on the first energy's
    device: each block's four energies and its CG step count (-1 where it
    has no CG), in block order, then the pose solve's status [F] where there
    is one.  Every piece is formed on the device (a capture holds it)."""
    if not energies:
        return torch.zeros((0,), dtype=torch.float64)
    dev = energies[0].device
    rows = []
    for e, s in zip(energies, steps):
        rows.append(e.to(dev, torch.float64))
        rows.append(e.new_full((1,), -1.0, dtype=torch.float64) if s is None
                    else s.reshape(1).to(dev, torch.float64))
    if info is not None:
        rows.append(info.to(dev, torch.float64))
    return torch.cat(rows)


def unpack(values: Sequence[float], blocks: int
           ) -> Tuple[List[List[float]], List[Optional[int]], List[int]]:
    """pack's host copy -> (each block's four energies, each block's CG
    steps or None, the pose solve's status)."""
    energies, steps = [], []
    for b in range(blocks):
        row = values[BLOCK_SLOTS * b: BLOCK_SLOTS * (b + 1)]
        energies.append(list(row[:4]))
        steps.append(None if row[4] < 0 else int(row[4]))
    return energies, steps, [int(v) for v in values[BLOCK_SLOTS * blocks:]]


# ------------------------------------------------------------- the counts


def counters() -> List[Dict[str, int]]:
    """The dicts of counts an iteration adds to: the launch counts of the
    kernels it runs, and those a caller registered."""
    return [residual.launch_counts, energy.launch_counts, albedo.launch_counts,
            normaleq.launch_counts, smallsolve.launch_counts, distcg.launch_counts,
            distreg.launch_counts] + capture.registered_counts()


def _snapshot() -> List[Tuple[Dict[str, int], Dict[str, int]]]:
    return capture.snapshot(counters())


_restore = capture.restore
_difference = capture.difference


def warming() -> bool:
    """Whether the running iteration is a graph's warm-up (its results are
    thrown away)."""
    return _warming


def after_replay(fn: Callable[[], None]) -> None:
    """Run `fn()` after every replay of the graph being captured (called
    from inside the capture, e.g. to copy a tensor the graph writes)."""
    if _capturing is None:
        raise RuntimeError("after_replay: no iteration is being captured")
    _capturing._after.append(fn)


# ---------------------------------------------------------------- the graph


class IterationGraph:
    """`step(state) -> (new state, readout [n] float64, ok)` captured as one
    CUDA graph over static copies of `state` (a tuple of tensors on one
    card); `ok` (a 0-dim bool on the card, or None for always) decides on
    the card whether a replay commits its new state.  `key` names what the
    graph was captured for (the loop captures again when it changes)."""

    def __init__(self, step: Callable, state: Sequence[torch.Tensor], key):
        global _warming, _capturing
        dev = state[0].device
        capture.needs_card(dev, "IterationGraph")
        self.key, self.device = key, dev
        self.state = tuple(t.clone() for t in state)
        self._after: List[Callable[[], None]] = []
        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        # the warm-up: one eager iteration on a scratch copy, on the capture's
        # stream, its counts given back
        t0 = time.perf_counter()
        snap = _snapshot()
        _warming = True
        try:
            with torch.cuda.stream(self.stream):
                step(tuple(t.clone() for t in self.state))
            self.stream.synchronize()
        finally:
            _warming = False
            _restore(snap)
        self.warmup_seconds = time.perf_counter() - t0

        def body():
            new, self.readout, ok = step(self.state)
            for s, n in zip(self.state, new):
                if n is not s:
                    s.copy_(n if ok is None else torch.where(ok, n, s))

        _capturing = self
        try:
            self._captured = capture.Captured(body, dev, self.stream, counters())
        finally:
            _capturing = None
        self.graph, self.counts = self._captured.graph, self._captured.counts

    def load(self, tensors: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Copy into the static state each of `tensors` that is not already
        its buffer -> the static state."""
        for s, t in zip(self.state, tensors):
            if t is not s:
                s.copy_(t)
        return self.state

    def replay(self) -> List[float]:
        """One replay and its ONE device-to-host copy -> the readout."""
        with torch.cuda.device(self.device):
            self.graph.replay()
            capture.add(self.counts)
            values = self.readout.tolist()
        for fn in self._after:
            fn()
        return values

    def release(self) -> None:
        """Drop the graph and its memory pool."""
        self._captured.release()
        self.graph = self.readout = self._captured = None
        self._after = []

