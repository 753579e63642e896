"""torch.profiler sessions that keep their device records.

On the card machine a profiler session drops its first device records as
out of its capture window (kineto's "Out-of-range" count: 3 to 14 records,
always the session's first, in sessions after the first minute of a
process), so a short traced body can vanish whole.  A session on the card
therefore opens with WARMUP throwaway spin kernels and a synchronize, which
take those losses; `warmup_kept` says how many of them arrived, and a
session that kept none may have lost its body's first records too.  A
session on the CPU alone opens with no warm-up.

The port captures and replays CUDA graphs (the scan's chunk and the
refinement's iteration), and CUPTI's teardown at a session's end and its
re-initialisation for the next do not work well beside CUDA graphs: torch
turns the teardown off for its own graphs (TEARDOWN_CUPTI=0,
torch/profiler/profiler.py), and a session here does the same unless the
environment already says otherwise.
"""

from __future__ import annotations

import contextlib
import os

import torch

# the throwaway kernels a session on the card opens with
WARMUP = 128


def is_warmup(name: str) -> bool:
    """A profiler row of the warm-up's kernel (torch.cuda._sleep's)."""
    return "spin_kernel" in name


@contextlib.contextmanager
def session(cuda: bool, cpu: bool = True, on_trace_ready=None):
    """A torch.profiler session over the body, tracing the host (`cpu`) and
    the card (`cuda`).  On the card it opens with WARMUP spin kernels and a
    synchronize, and closes after a synchronize, so that the body's device
    activity is complete when the session stops.  `on_trace_ready(prof)`
    runs as the session stops (writing a trace, say).  -> the profile."""
    from torch.profiler import ProfilerActivity, profile

    if cuda:
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA] * cuda
    with profile(activities=acts, on_trace_ready=on_trace_ready) as prof:
        if cuda:
            for _ in range(WARMUP):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        yield prof
        if cuda:
            torch.cuda.synchronize()


def warmup_kept(prof) -> int:
    """The warm-up kernels whose device records the session kept."""
    return int(sum(e.count for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and is_warmup(e.key)))
