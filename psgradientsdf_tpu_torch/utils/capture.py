"""What the port's CUDA graphs share: a body captured once on a card and
replayed, and the launch counts that the kernels' wrappers keep in Python.

A capture executes nothing, and a wrapper counts its launch in Python when
it runs, which it does once, at the capture.  So a graph snapshots the
dicts of counts it is given before the capture, takes the capture's
difference of them, restores them, and adds that difference again at every
replay: after k replays each count stands where k eager runs would have
left it.  A caller can register its own dicts of counts (`registered`) for
a body's duration; every graph captured meanwhile counts them the same
way.

Used by refine/graph.py (one refinement iteration a graph) and
tracking/graph.py (one scan chunk a graph).  A capture or a replay that
fails raises; there is no graph on the CPU.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

Counts = Dict[str, int]
Snapshot = List[Tuple[Counts, Counts]]

_registered: List[Counts] = []


def registered_counts() -> List[Counts]:
    """The dicts of counts callers registered, in order."""
    return list(_registered)


@contextlib.contextmanager
def registered(counts: Counts):
    """For the body's duration, count `counts` (a dict of ints that the
    captured calls add to) as the launch counts are: restored after a
    capture, the capture's difference added at every replay."""
    _registered.append(counts)
    try:
        yield counts
    finally:
        # by identity: two registered dicts may hold equal counts
        del _registered[next(i for i, c in enumerate(_registered) if c is counts)]


def snapshot(dicts: Sequence[Counts]) -> Snapshot:
    return [(c, dict(c)) for c in dicts]


def restore(snap: Snapshot) -> None:
    for c, s in snap:
        for k in c:
            c[k] = s.get(k, 0)


def difference(snap: Snapshot) -> Snapshot:
    """What the dicts gained since `snap`: (dict, {key: gain}) pairs."""
    return [(c, {k: v - s.get(k, 0) for k, v in c.items() if v != s.get(k, 0)})
            for c, s in snap]


def add(diff: Snapshot) -> None:
    """Add a difference once more (a replay's share)."""
    for c, d in diff:
        for k, v in d.items():
            c[k] = c.get(k, 0) + v


def needs_card(device: torch.device, what: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{what}: the state is on {device}; a graph needs a card")


class Captured:
    """`body()` captured as one CUDA graph on `stream` (whose work must
    already be ordered after what the body reads), the gains of `dicts`
    during the capture kept in `counts` and the dicts restored.  `replay()`
    launches it on the current stream and adds `counts`.  Whatever the body
    allocates lives in the graph's own memory pool as long as the graph."""

    def __init__(self, body: Callable[[], None], device: torch.device,
                 stream: torch.cuda.Stream, dicts: Sequence[Counts]):
        needs_card(device, "a CUDA graph")
        self.device = device
        # what the body reads stays alive as long as the graph that reads it
        self._body = body
        snap = snapshot(list(dicts))
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                body()
            self.counts = difference(snap)
        finally:
            restore(snap)
        self.capture_seconds = time.perf_counter() - t0

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()
        add(self.counts)

    def release(self) -> None:
        """Drop the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = self._body = None
