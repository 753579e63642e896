"""Multi-process runtime: torch.distributed set-up, the process-aware mesh,
and the collective moves of a mesh that spans processes.

Counterpart of the JAX package's parallel/distributed.py.  There one
`jax.distributed.initialize` per process makes `jax.devices()` the global
device list, and GSPMD inserts the collectives.  Here one process drives
its own mesh entries (a mesh row or more: its slabs and its refinement
blocks), an entry of another process is a `Remote` holding that process's
rank, and every cross-process move of parallel/mesh.py and
parallel/halo.py is a torch.distributed collective called by every process
in the same order (the loops of parallel/shard.py and parallel/refine.py
visit every mesh entry on every process, local or not).  The sums keep the
one-process mesh's order of addition: the pieces are gathered first and
added in shard order on each process that needs the sum, never by
`all_reduce`, whose order is the library's, so that every process holds
the bits the one-process mesh computes.

    # on every process (a file:// rendezvous, or tcp://host:port):
    from psgradientsdf_tpu_torch.parallel import distributed
    distributed.initialize(num_processes=N, process_id=i,
                           init_method="file:///shared/rendezvous")
    pipe = ReconstructionPipeline(cfg)   # a "mesh shape": one row a process
    pipe.run()

Environment fallbacks follow torch's own conventions (torchrun sets them):
MASTER_ADDR / MASTER_PORT (an env:// rendezvous), WORLD_SIZE, RANK and
LOCAL_RANK.  The backend is NCCL for a CUDA device and gloo for the CPU
unless the caller names one; NCCL takes one card a process.  Several
processes on one card run over gloo, which moves CUDA tensors through host
memory here: every piece is copied to the host before the collective and
back after it.
"""

from __future__ import annotations

import datetime
import math
import os
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from psgradientsdf_tpu_torch import resolve_device


class Remote(NamedTuple):
    """A mesh entry, or a piece of a move, held by process `rank`."""
    rank: int


def is_remote(x) -> bool:
    return isinstance(x, Remote)


_STATE: Optional[dict] = None


def is_initialized() -> bool:
    return _STATE is not None


def active() -> bool:
    """True inside a process group of more than one process: the mesh moves
    are collectives then."""
    return _STATE is not None and _STATE["world"] > 1


def rank() -> int:
    return _STATE["rank"] if _STATE else 0


def world() -> int:
    return _STATE["world"] if _STATE else 1


def home():
    """This process's device: where replicated work runs and the sums that
    every process needs land."""
    return _STATE["device"]


def backend() -> str:
    return _STATE["backend"] if _STATE else ""


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    *,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    device=None,
    timeout: Optional[float] = None,
) -> None:
    """Join the process group (idempotent).

    `coordinator_address` "host:port" is a tcp:// rendezvous; `init_method`
    names any other (file://...); with neither, MASTER_ADDR / MASTER_PORT
    (env://).  `num_processes` / `process_id` default to WORLD_SIZE / RANK.
    The process's device is `device`, else cuda:<local_device_ids[0]>, else
    cuda:<LOCAL_RANK % device_count> (LOCAL_RANK defaults to the rank); with
    no card and no device="cpu" this raises, as resolve_device does.  Its
    mesh entries (make_global_mesh) are the devices of `local_device_ids`,
    else its one device.  `timeout` is the collectives' limit in seconds."""
    global _STATE
    if _STATE is not None:
        return
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs num_processes and process_id "
                         "(or WORLD_SIZE and RANK)")
    if init_method is None:
        if coordinator_address:
            init_method = f"tcp://{coordinator_address}"
        elif env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            init_method = "env://"
        else:
            raise ValueError("initialize needs coordinator_address, "
                             "init_method or MASTER_ADDR/MASTER_PORT")
    if device is None:
        resolve_device("cuda")
        ids = (list(local_device_ids) if local_device_ids is not None else
               [int(env.get("LOCAL_RANK", process_id)) % torch.cuda.device_count()])
        local = [torch.device("cuda", i) for i in ids]
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", process_id))
                               % torch.cuda.device_count())
        local = [dev]
    dev = local[0]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                world_size=num_processes, rank=process_id, **kw)
    counts: List = [None] * num_processes
    dist.all_gather_object(counts, len(local))
    _STATE = dict(rank=process_id, world=num_processes, device=dev, local=local,
                  backend=backend, counts=counts)


def shutdown() -> None:
    global _STATE
    if _STATE is not None:
        dist.destroy_process_group()
        _STATE = None


def process_info() -> dict:
    """(process_index, process_count, local/global device counts)."""
    if _STATE is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        return dict(process_index=0, process_count=1, local_devices=n,
                    global_devices=n)
    return dict(process_index=_STATE["rank"], process_count=_STATE["world"],
                local_devices=len(_STATE["local"]),
                global_devices=sum(_STATE["counts"]))


def make_global_mesh(n_z: int = 0, n_frames: int = 1, devices=None):
    """z x frames mesh over every process's entries, in rank order: this
    process's `devices` (default: its local devices) and the others', each
    entry of another process a Remote.  n_z=0 takes every entry for z.

    With n_frames=1 each process owns a contiguous band of Z, and a halo
    crosses a process boundary once per band edge.  A mesh row must belong
    to one process (its refinement blocks share the row's N-chunk), so a
    process's entries are a whole number of rows.  Outside a process group
    this is parallel/mesh.make_mesh over `devices`."""
    from psgradientsdf_tpu_torch.parallel.mesh import Mesh, _canonical, make_mesh

    if _STATE is None:
        return make_mesh(n_z, n_frames, devices=devices)
    local = [_canonical(d) for d in (devices or _STATE["local"])]
    counts: List = [None] * _STATE["world"]
    dist.all_gather_object(counts, len(local))
    entries = [local[i] if r == _STATE["rank"] else Remote(r)
               for r, c in enumerate(counts) for i in range(c)]
    if n_z <= 0:
        n_z = len(entries) // max(n_frames, 1)
    need = n_z * n_frames
    if need > len(entries) or need < 1:
        raise ValueError(f"mesh {n_z}x{n_frames} needs {need} devices, the "
                         f"processes have {len(entries)}")
    owners = [r for r, c in enumerate(counts) for _ in range(c)][:need]
    for k in range(n_z):
        row = set(owners[k * n_frames:(k + 1) * n_frames])
        if len(row) > 1:
            raise ValueError(
                f"mesh row {k} spans processes {sorted(row)}: give each "
                f"process a multiple of n_frames={n_frames} entries")
    arr = np.empty((n_z, n_frames), dtype=object)
    for i, d in enumerate(entries[:need]):
        arr[i // n_frames, i % n_frames] = d
    return Mesh(arr, home=_STATE["device"])


def host_local_slice(geom_z: int, mesh) -> slice:
    """The Z-row range of the dense grid owned by THIS process under a
    Z-slab sharding of `mesh` (for host-side IO of process-local data)."""
    from psgradientsdf_tpu_torch.parallel.mesh import Z_AXIS

    n_z = mesh.shape[Z_AXIS]
    if geom_z % n_z:
        raise ValueError(f"grid Z={geom_z} not divisible by mesh z={n_z}")
    zl = geom_z // n_z
    mine = [k for k in range(n_z)
            if any(not is_remote(d) for d in mesh.devices[k])]
    if not mine:
        return slice(0, 0)
    return slice(min(mine) * zl, (max(mine) + 1) * zl)


# ------------------------------------------------------------ the moves

def _owners(parts) -> List[int]:
    me = rank()
    return [p.rank if is_remote(p) else me for p in parts]


def _meta(parts, owners):
    """(shape, dtype) of the pieces of one move, which share them: read from
    a local piece, or broadcast by the first piece's owner when some
    process holds none (every process finds that from `owners` alike)."""
    local = next((p for p in parts if not is_remote(p)), None)
    if len(set(owners)) == _STATE["world"]:
        return tuple(local.shape), local.dtype
    obj = [None if local is None else (tuple(local.shape), local.dtype)]
    dist.broadcast_object_list(obj, src=owners[0])
    return obj[0]


def _wire_device():
    return torch.device("cpu") if _STATE["backend"] == "gloo" else _STATE["device"]


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """A piece as the backend takes it: flat, bool as uint8, on the host for
    gloo (staging through host memory)."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.reshape(-1).to(_wire_device())


def _from_wire(t: torch.Tensor, shape, dtype, device) -> torch.Tensor:
    return t.view(shape).to(device=device, dtype=dtype)


def exchange(parts: Sequence, device) -> List[torch.Tensor]:
    """Every piece of a move on `device`, in order: this process's pieces
    as they are, the others' (Remote entries) received from their owners
    by one all-gather.  The pieces share one shape and dtype."""
    owners = _owners(parts)
    shape, dtype = _meta(parts, owners)
    wdtype = torch.uint8 if dtype == torch.bool else dtype
    numel = math.prod(shape)
    me, n_proc = _STATE["rank"], _STATE["world"]
    most = max(owners.count(r) for r in range(n_proc))
    send = torch.zeros(most * numel, dtype=wdtype, device=_wire_device())
    mine = [p for p in parts if not is_remote(p)]
    if mine:
        send[:len(mine) * numel] = torch.cat([_to_wire(p) for p in mine])
    recv = [torch.empty_like(send) for _ in range(n_proc)]
    dist.all_gather(recv, send)
    out, seen = [], [0] * n_proc
    for p, r in zip(parts, owners):
        i = seen[r]
        seen[r] += 1
        out.append(p.to(device) if r == me else _from_wire(
            recv[r][i * numel:(i + 1) * numel], shape, dtype, device))
    return out


def on_process_zero(write: Callable[[], None]) -> None:
    """write() on process 0 only, its outcome shared: every process
    returns, or every process raises an error of the type that write()
    raised, with its text.  A file that only process 0 writes goes through
    here, so that a failed write (a full disk, a torn rename) does not leave
    the other processes waiting in their next collective until the group's
    timeout.  Outside a process group this calls write()."""
    if not active():
        write()
        return
    failure = None
    if _STATE["rank"] == 0:
        try:
            write()
        except Exception as e:      # shared below, then raised on every process
            failure = e
    outcome = [None if failure is None else
               (type(failure).__module__, type(failure).__name__, str(failure))]
    dist.broadcast_object_list(outcome, src=0)
    if failure is not None:
        raise failure
    if outcome[0] is not None:
        module, name, text = outcome[0]
        kind = getattr(sys.modules.get(module), name, None)
        if not (isinstance(kind, type) and issubclass(kind, Exception)):
            kind, text = RuntimeError, f"{module}.{name}: {text}"
        raise kind(text)


def scatter_slices(partials: Sequence, bounds: Sequence[int],
                   chunk_owners: Sequence[int], device):
    """The slices partial[bounds[k]:bounds[k+1]] of every partial, for each
    chunk k this process owns, in partial order, on `device`: one
    all-to-all that sends each owner only its chunks' slices.  The partials
    share one full shape.  -> ({k: [slice of each partial]}, that shape)."""
    owners = _owners(partials)
    shape, dtype = _meta(partials, owners)
    tail = math.prod(shape[1:])
    me, n_proc = _STATE["rank"], _STATE["world"]
    n = len(bounds) - 1
    mine = [p for p in partials if not is_remote(p)]
    send, in_splits = [], []
    for s in range(n_proc):
        pieces = [] if s == me else [
            _to_wire(p[bounds[k]:bounds[k + 1]])
            for k in range(n) if chunk_owners[k] == s for p in mine]
        send += pieces
        in_splits.append(sum(t.numel() for t in pieces))
    my_chunks = [k for k in range(n) if chunk_owners[k] == me]
    my_rows = sum(bounds[k + 1] - bounds[k] for k in my_chunks)
    out_splits = [0 if r == me else owners.count(r) * my_rows * tail
                  for r in range(n_proc)]
    wdtype = torch.uint8 if dtype == torch.bool else dtype
    send_t = (torch.cat(send) if send else
              torch.empty(0, dtype=wdtype, device=_wire_device()))
    recv = torch.empty(sum(out_splits), dtype=wdtype, device=_wire_device())
    dist.all_to_all_single(recv, send_t, output_split_sizes=out_splits,
                           input_split_sizes=in_splits)
    out: Dict[int, List] = {k: [None] * len(partials) for k in my_chunks}
    off = 0
    for r in range(n_proc):
        if r == me:
            continue
        theirs = [i for i, o in enumerate(owners) if o == r]
        for k in my_chunks:
            rows = bounds[k + 1] - bounds[k]
            for i in theirs:
                size = rows * tail
                out[k][i] = _from_wire(recv[off:off + size], (rows,) + shape[1:],
                                       dtype, device)
                off += size
    for k in my_chunks:
        for i, (p, o) in enumerate(zip(partials, owners)):
            if o == me:
                out[k][i] = p[bounds[k]:bounds[k + 1]].to(device)
    return out, shape
