"""The one-card scan chunk as one CUDA graph, replayed once a chunk.

The port's counterpart of the JAX package's chunk dispatch
(psgradientsdf_tpu/tracking/stream.py `process_chunk` :205-269: the
chunk's `_preprocess` :74-80, then C jitted `_chunk_step` programs :83-203,
dispatched with no host read).  On one card, with the culled fusion and the
direct row copies (`rows_impl="dma"`), tracking/stream.process_chunk runs a
chunk in the static buffers of a `ScanRotation` and, once that chunk's key
has been captured, replays it: the host copies the chunk's frames, its pose
seed, frame ids and GT poses into the slot's buffers and makes one graph
launch, where the eager chain makes some 30 runtime calls a frame.  The
pipeline reads the chunk's results once, from one readout (`READ_COLS`
float64 numbers a frame).

  * The rotation holds SLOTS volumes.  A chunk reads the volume of one slot
    (its source) and writes the next slot's (its target): the graph's first
    node copies the source into the target, and the frames fuse into the
    target in place.  The pipeline keeps three volumes alive at once (the
    pending chunk's pre-chunk volume for an overflow redo, its post-chunk
    volume for a checkpoint, the next chunk's), so three slots; a volume
    from outside the rotation (the one frame 0 placed, a resume, any state
    set from outside) is read in place by an eager chunk whose target is
    slot 0.  The slot also holds the chunk's staging frames, pose seed,
    frame ids, GT poses, results and readout; the pipeline copies what must
    outlive the slot (a keyframe's image) out of it.
  * A graph is captured once for each (source, target, row capacity) and
    what else the chunk's program depends on (`ScanKey`), as JAX retraces
    on `fuse_row_capacity`: a grown capacity is a new key, and the graphs
    of the old capacity are released.  The frame ids are read on the device
    (ops/fuse.fuse_rows picks the visibility word and bit), so nothing of a
    frame is frozen into the graph.
  * The warm-up is the rotation's first chunk, run eagerly on the live
    state on the capture's stream: every kernel library, host plan
    (ops/gn.solve_plan, the cull's grid) and cached buffer (LAPM's ticket)
    exists on that stream before any capture.  Every eager chunk of the
    rotation runs there, and a key is captured only at a capacity that has
    run eagerly (a redo at a grown capacity runs eagerly first).  A ragged
    chunk (padding frames), the ordered scatter (`rows_impl="staged"`,
    whose call tag cannot be replayed) and the plain row copies run eagerly
    in the same buffers.
  * A capture executes nothing and the kernels' wrappers count at capture;
    the launch counts (`counters`) are restored after it and the capture's
    difference added at every replay (utils/capture.py, shared with
    refine/graph.py).  A capture or a replay that fails raises: nothing
    falls back.  There is no graph on the CPU, where the rotation runs
    every chunk eagerly.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from psgradientsdf_tpu_torch.core.volume import GradSdfVolume
from psgradientsdf_tpu_torch.ops import cull, fuse, gn, preprocess, rowcopy
from psgradientsdf_tpu_torch.tracking import tracker
from psgradientsdf_tpu_torch.utils import capture

SLOTS = 3
# a frame's readout: its pose (16), converged, fused, iterations, energy,
# pixels counted, sharpness, overflow
READ_COLS = 23


class ScanKey(NamedTuple):
    source: int          # the slot read
    target: int          # the slot written
    capacity: int        # the culled fusion's row capacity
    static: tuple        # what else the chunk's program depends on


def counters() -> List[Dict[str, int]]:
    """The dicts of counts a chunk adds to: the launch counts of the scan's
    kernels, the frames the tracker solved, and those a caller registered."""
    return [gn.launch_counts, fuse.launch_counts, cull.launch_counts,
            rowcopy.launch_counts, preprocess.launch_counts, tracker.steps_run
            ] + capture.registered_counts()


def host_frames(arr) -> torch.Tensor:
    """Frames in their wire format as a tensor where they lie (a numpy
    array on the host; uint16 depth widened to int32: torch has no uint16
    arithmetic on older builds)."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        arr = arr.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr))


class Slot:
    """One slot's static buffers: the volume, the chunk's staging frames
    (made at the first chunk, in its wire format), pose seed [4,4], frame
    ids [C] int32, GT poses [C,4,4], results and readout [C, READ_COLS]."""

    def __init__(self, vol: GradSdfVolume, C: int):
        dev = vol.dist.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.vol = GradSdfVolume(*(torch.empty_like(t) for t in vol))
        self.colors: Optional[torch.Tensor] = None
        self.depths: Optional[torch.Tensor] = None
        self.seed = torch.zeros((4, 4), **f32)
        self.fids = torch.zeros((C,), dtype=torch.int32, device=dev)
        self.gtp = torch.zeros((C, 4, 4), **f32)
        self.poses = torch.zeros((C, 4, 4), **f32)
        self.converged = torch.zeros((C,), dtype=torch.bool, device=dev)
        self.fused = torch.zeros((C,), dtype=torch.bool, device=dev)
        self.iterations = torch.zeros((C,), dtype=torch.int32, device=dev)
        self.energy = torch.zeros((C,), **f32)
        self.num_valid = torch.zeros((C,), dtype=torch.int32, device=dev)
        self.sharpness = torch.zeros((C,), **f32)
        self.fuse_overflow = torch.zeros((C,), dtype=torch.bool, device=dev)
        self.readout = torch.zeros((C, READ_COLS), dtype=torch.float64, device=dev)
        # on a card host inputs go up through page-locked copies, so the
        # host does not wait for the chunk the card is still running
        self._pinned: Dict[str, torch.Tensor] = {}
        self._uploaded = torch.cuda.Event() if dev.type == "cuda" else None

    def stage(self, colors, depths, pose, fids, gtp) -> None:
        """Copy a chunk's inputs in (what is already the slot's buffer
        stays): one copy each, none of which waits for the card."""
        colors, depths = host_frames(colors), host_frames(depths)
        if self.colors is None:
            self.colors = torch.empty(colors.shape, dtype=colors.dtype,
                                      device=self.seed.device)
            self.depths = torch.empty(depths.shape, dtype=depths.dtype,
                                      device=self.seed.device)
        if self._uploaded is not None:
            # the page-locked buffers' last copies out have ended
            self._uploaded.synchronize()
        for name, buf, new in (("colors", self.colors, colors),
                               ("depths", self.depths, depths)):
            if new.shape != buf.shape or new.dtype != buf.dtype:
                raise ValueError(f"scan rotation: frames {tuple(new.shape)} "
                                 f"{new.dtype}, its staging holds "
                                 f"{tuple(buf.shape)} {buf.dtype}")
            if new is not buf:
                self._upload(name, buf, new)
        if pose is not self.seed:
            self._upload("seed", self.seed, torch.as_tensor(pose, dtype=torch.float32))
        self._upload("fids", self.fids, torch.as_tensor(np.asarray(fids, np.int32)))
        if gtp is not None:
            self._upload("gtp", self.gtp, torch.as_tensor(gtp, dtype=torch.float32))
        if self._uploaded is not None:
            self._uploaded.record()

    def _upload(self, name: str, buf: torch.Tensor, new: torch.Tensor) -> None:
        if buf.device.type != "cuda" or new.device.type != "cpu":
            buf.copy_(new)
            return
        pin = self._pinned.get(name)
        if pin is None or pin.shape != new.shape or pin.dtype != new.dtype:
            pin = self._pinned[name] = torch.empty(new.shape, dtype=new.dtype,
                                                   pin_memory=True)
        pin.copy_(new)
        buf.copy_(pin, non_blocking=True)

    def results(self):
        """The result tensors in tracking/stream.ChunkResult's order."""
        return (self.poses, self.converged, self.fused, self.iterations,
                self.energy, self.num_valid, self.sharpness, self.fuse_overflow)


class ScanRotation:
    """SLOTS slots of static buffers shaped like `vol` for chunks of `C`
    frames, and the CUDA graphs captured over them (see the module
    docstring).  capture=False, or a volume off the card, runs every chunk
    eagerly in the same buffers."""

    def __init__(self, vol: GradSdfVolume, C: int, capture: bool = True):
        self.device = vol.dist.device
        self.C = C
        self.capture = bool(capture) and self.device.type == "cuda"
        self.slots = [Slot(vol, C) for _ in range(SLOTS)]
        self.graphs: Dict[ScanKey, capture.Captured] = {}
        self.warm: set = set()           # capacities run eagerly here
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.captures = 0
        self.capture_seconds: List[float] = []
        self.replays = 0
        self.eager_chunks = 0
        self.warmup_seconds: Optional[float] = None

    def source_of(self, vol) -> Optional[int]:
        """The slot whose volume `vol` is, or None for a volume from
        outside the rotation."""
        ptr = vol.dist.data_ptr()
        for i, s in enumerate(self.slots):
            if s.vol.dist.data_ptr() == ptr:
                return i
        return None

    @staticmethod
    def target_of(source: Optional[int]) -> int:
        return 0 if source is None else (source + 1) % SLOTS

    def run(self, key: ScanKey, body: Callable[[], None], graphable: bool,
            reads: Sequence[torch.Tensor] = ()) -> None:
        """The chunk `body` (which reads and writes only static buffers, and
        tensors it holds itself) as one replay of the key's graph, captured
        first where it is new, or eagerly: eagerly where the chunk is not
        graphable, capture is off or the key's capacity has not yet run
        eagerly here.  `reads`: tensors from outside the rotation the body
        reads (kept from reuse until the eager chunk's stream is past them)."""
        if (graphable and self.capture and key.source is not None
                and key.capacity in self.warm):
            g = self.graphs.get(key)
            if g is None:
                g = self._capture(key, body)
            g.replay()
            self.replays += 1
            return
        t0 = time.perf_counter()
        if self.stream is None:
            body()
        else:
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            for t in reads:
                t.record_stream(self.stream)
            with torch.cuda.stream(self.stream):
                body()
            cur.wait_stream(self.stream)
        if self.warmup_seconds is None:
            if self.stream is not None:
                self.stream.synchronize()
            self.warmup_seconds = time.perf_counter() - t0
        self.warm.add(key.capacity)
        self.eager_chunks += 1

    def _capture(self, key: ScanKey, body) -> capture.Captured:
        for k in [k for k in self.graphs if k.capacity != key.capacity]:
            self.graphs.pop(k).release()        # a capacity only grows
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        g = capture.Captured(body, self.device, self.stream, counters())
        self.graphs[key] = g
        self.captures += 1
        self.capture_seconds.append(g.capture_seconds)
        return g

    def stats(self) -> dict:
        return dict(captures=self.captures, capture_seconds=list(self.capture_seconds),
                    replays=self.replays, eager_chunks=self.eager_chunks,
                    warmup_seconds=self.warmup_seconds, graph=self.capture)

    def release(self) -> None:
        """Drop every graph and its memory pool (the slots' volumes stay
        where they are referenced)."""
        for g in self.graphs.values():
            g.release()
        self.graphs.clear()
