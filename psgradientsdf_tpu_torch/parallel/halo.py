"""Halo exchange for Z-slab-sharded dense grids.

The refinement's finite-difference stencils (one-sided gradients, the
6-point Laplacian — Optimizer.cpp:287-393) need the first and last Z-plane
of the neighbouring slab.  The JAX package exchanges them with ppermute
inside shard_map; here the one process that holds every slab copies the
planes, with `.to(device)` when the neighbour lies on another device.  On a
mesh over processes (parallel/distributed.py) every slab's two boundary
planes are all-gathered, and each process takes its slabs' neighbours from
them; a slab of another process is its Remote, in the input and the output.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from psgradientsdf_tpu_torch.parallel import distributed as pd
from psgradientsdf_tpu_torch.parallel.distributed import is_remote


def exchange_z_halo(slabs: Sequence[torch.Tensor]
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """For local [Zl, ...] slabs in shard order -> per slab
    (plane_from_below, plane_from_above):

      plane_from_below: the last plane of the lower neighbour (the plane at
        global index z0-1), zeros on the first shard;
      plane_from_above: the first plane of the upper neighbour (global index
        z0+Zl), zeros on the last shard.
    Shapes are slab[:1] each, on the slab's device, copies of the planes."""
    n = len(slabs)
    if pd.active():
        # (first plane, last plane) of every slab, on each process
        ends = pd.exchange([s if is_remote(s) else torch.cat([s[:1], s[-1:]])
                            for s in slabs], pd.home())
        firsts, lasts = [e[:1] for e in ends], [e[1:] for e in ends]
    else:
        firsts, lasts = [s[:1] for s in slabs], [s[-1:] for s in slabs]
    out = []
    for k, s in enumerate(slabs):
        if is_remote(s):
            out.append(s)
            continue
        below = (lasts[k - 1].to(s.device, copy=True) if k > 0
                 else torch.zeros_like(s[:1]))
        above = (firsts[k + 1].to(s.device, copy=True) if k < n - 1
                 else torch.zeros_like(s[:1]))
        out.append((below, above))
    return out


def padded_slab(slabs: Sequence[torch.Tensor], fill: float = 0.0
                ) -> List[torch.Tensor]:
    """Each slab padded with one halo plane on each Z side: [Zl+2, ...].

    The boundary shards get `fill` planes (the dense grid's border, where
    out-of-grid neighbours are clamped)."""
    n = len(slabs)
    out = []
    for k, (s, halo) in enumerate(zip(slabs, exchange_z_halo(slabs))):
        if is_remote(s):
            out.append(s)
            continue
        below, above = halo
        if k == 0:
            below = torch.full_like(below, fill)
        if k == n - 1:
            above = torch.full_like(above, fill)
        out.append(torch.cat([below, s, above], dim=0))
    return out
