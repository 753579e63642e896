"""Indexed contiguous-row copy: the four row-movement kernels of the culled
fusion (core/volume.py), hand-written for Hopper in csrc/rowcopy.cu.

  gather_rows_dma(table[N,R], idx[CAP])        -> rows[CAP,R]
  scatter_rows_dma(table[N,R], idx[CAP], rows) -> table   (IN PLACE)
  gather_rows(table, idx)                      -> rows[CAP,R]
  scatter_rows(table, idx, rows)               -> table   (IN PLACE, ordered)

  gather_tables_dma(tables, idx)               -> rows_list
  scatter_tables_dma(tables, idx, rows_list)   -> tables  (IN PLACE)
  gather_tables(tables, idx)                   -> rows_list
  scatter_tables(tables, idx, rows_list)       -> tables  (IN PLACE, ordered)

The last four move up to 8 tables that share one `idx` (widths and dtypes may
differ) in one call and compute on each table exactly what the one-table
call computes; the first four are their one-table case.

Each replaces the function of the same name in the JAX package's
ops/rowcopy.py (the Pallas kernels for the TPU):

  gather_rows_dma   HBM->HBM async row copies through a semaphore ring
                    -> ONE launch for all the tables of a call, laid out by
                    slot: a warp owns a slot, reads its index once and moves
                    the slot's segment of every table global->global, all
                    its loads started before the first store (16-byte lanes
                    where a table's width and bases allow, 4-byte lanes
                    otherwise, decided per table).  Default loads (table
                    rows are read again), streaming stores.
  scatter_rows_dma  the same ring writing into the donated table
                    -> the same layout in the other direction, one launch.
                    Duplicate indices race: callers give slots that share an
                    index identical rows.
  gather_rows       scalar-prefetched indices, `group` rows per sequential
                    grid step staged through VMEM
                    -> one launch for all the tables; a warp per slot brings
                    the slot's segment of every table into its own
                    shared-memory buffer with cp.async copies, all in flight
                    at once, and streams it out; wider segments go chunk by
                    chunk through two buffers.  CAP is free.
  scatter_rows      one row per sequential grid step, so duplicates resolve
                    in slot order, LAST slot wins
                    -> blocks run in no order on a GPU, so the order is
                    made explicit: pass 1 atomicMax(winner[idx[i]], i), once
                    per call for the shared index vector; pass 2 is the
                    direct scatter's kernel with a predicate, slot i writes
                    only if it is the winner.  Two launches a call.

Both scatters take `live`, an optional int64 scalar tensor on the tables'
device: only the slots before it are written, the kernels skip the others,
and so do the plain versions when they are given it (they read it back to
the host to cut their slots).  Every slot's index must still lie in [0, N).
The culled fusion pads its index vector by repeating slot 0 (the same index
and the same rows) and passes its count of live rows; the resident state
(core/resident.py) writes back its first n_used slots.  The gathers take no
such count: every slot of their output is written.

Bound on the card, all four: bytes, no arithmetic, over the 3.35 TB/s of an
H100's device memory, the index vector read once.  A gather must read each
DISTINCT source row once (a second read of a row is served by the L2 cache
and need not reach device memory) and write every slot's row:
(distinct + CAP) * sum(R) * 4 + CAP * 4 bytes.  A scatter must move only the
rows that end up in the table: one slot's rows read and one row written for
every distinct index among the live slots, 2 * distinct * sum(R) * 4 + CAP * 4
bytes.  A fused frame's five tables (sum(R) = 1152, CAP = 8192) with every
slot distinct: 22.5 us for either.  The design answer is wide accesses with
many bytes in flight: 16 bytes a thread when R*4 and the base pointers are
16-byte aligned, 4 bytes a thread otherwise.

The Mosaic tiling rule R % 128 == 0 of the TPU kernels is gone: any R >= 1
and any CAP >= 1 work.  `idx` in [0, N) stays the caller's contract.

The gathers and the direct scatter hand their tables to the kernel by value
and keep no state between calls, so they may be captured in a CUDA graph.
The ordered scatter may not (its winner scratch, below).

Beside each kernel stands its plain PyTorch version (`*_plain`).  A wrapper
takes the plain version ONLY for tensors that lie on the CPU; for CUDA
tensors it launches the kernel or raises.  `launch_counts` counts kernel
launches per wrapper (and nothing else; a multi-table call counts one under
its one-table name), so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_LIB_NAME = "rowcopy"
_INDEX_DTYPES = (torch.int32, torch.int64)
MAX_TABLES = 8
launch_counts: Dict[str, int] = {
    "gather_rows_dma": 0,
    "scatter_rows_dma": 0,
    "gather_rows": 0,
    "scatter_rows": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows[i] = table[idx[i]] (duplicates are independent reads)."""
    return table.index_select(0, idx.long())


def gather_tables_plain(tables: Sequence[torch.Tensor],
                        idx: torch.Tensor) -> List[torch.Tensor]:
    """gather_rows_plain on every table of the list."""
    return [gather_rows_plain(t, idx) for t in tables]


def _live_slots(idx, rows, live):
    """The first `live` slots of idx and rows (all of them for None); the
    count is read back to the host."""
    if live is None:
        return idx, rows
    k = max(0, min(int(live), idx.shape[0]))
    return idx[:k], rows[:k]


def scatter_rows_dma_plain(table: torch.Tensor, idx: torch.Tensor,
                           rows: torch.Tensor,
                           live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table[idx[i]] = rows[i] in place for the slots before `live`; slots
    that share an index must carry identical rows (index_copy_ resolves
    duplicates in no fixed order)."""
    idx, rows = _live_slots(idx, rows, live)
    return table.index_copy_(0, idx.long(), rows)


def scatter_rows_plain(table: torch.Tensor, idx: torch.Tensor,
                       rows: torch.Tensor,
                       live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table[idx[i]] = rows[i] in place for the slots before `live`,
    duplicates in slot order: the LAST slot wins.  The winner of every row is
    found first (a max-reduction over slot numbers, which is ordered by
    value, not by execution), then only the winning slots are written — no
    two of them share an index."""
    idx, rows = _live_slots(idx, rows, live)
    cap = idx.shape[0]
    idx = idx.long()
    slots = torch.arange(cap, dtype=torch.int64, device=idx.device)
    winner = torch.full((table.shape[0],), -1, dtype=torch.int64,
                        device=idx.device)
    winner.scatter_reduce_(0, idx, slots, reduce="amax", include_self=True)
    wins = winner[idx] == slots
    # data-dependent count: this reference version may read it back
    return table.index_copy_(0, idx[wins], rows[wins])


def scatter_tables_dma_plain(tables: Sequence[torch.Tensor], idx: torch.Tensor,
                             rows_list: Sequence[torch.Tensor],
                             live: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """scatter_rows_dma_plain on every table of the list."""
    return [scatter_rows_dma_plain(t, idx, r, live)
            for t, r in zip(tables, rows_list)]


def scatter_tables_plain(tables: Sequence[torch.Tensor], idx: torch.Tensor,
                         rows_list: Sequence[torch.Tensor],
                         live: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """scatter_rows_plain on every table of the list."""
    return [scatter_rows_plain(t, idx, r, live) for t, r in zip(tables, rows_list)]


# ---------------------------------------------------------------------------
# argument checks and the library binding
# ---------------------------------------------------------------------------


def _check(name: str, table: torch.Tensor, idx: torch.Tensor,
           rows: Optional[torch.Tensor] = None) -> None:
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(
            f"{name}: table must be [N,R] and idx [CAP], got "
            f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.shape[0] < 1 or table.shape[1] < 1 or idx.shape[0] < 1:
        raise ValueError(f"{name}: N, R and CAP must all be >= 1")
    if table.element_size() != 4 or table.dtype.is_complex:
        raise TypeError(
            f"{name}: 4-byte elements only (float32, int32), got {table.dtype}")
    if idx.dtype not in _INDEX_DTYPES:
        raise TypeError(f"{name}: idx must be int32 or int64, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(
            f"{name}: idx on {idx.device}, table on {table.device}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError(f"{name}: table and idx must be contiguous")
    if rows is not None:
        if rows.shape != (idx.shape[0], table.shape[1]):
            raise ValueError(
                f"{name}: rows must be [CAP,R] = "
                f"{(idx.shape[0], table.shape[1])}, got {tuple(rows.shape)}")
        if rows.dtype != table.dtype:
            raise TypeError(
                f"{name}: rows are {rows.dtype}, table is {table.dtype}")
        if rows.device != table.device:
            raise ValueError(
                f"{name}: rows on {rows.device}, table on {table.device}")
        if not rows.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous")


def _check_tables(name: str, tables, idx: torch.Tensor, rows_list=None,
                  live: Optional[torch.Tensor] = None) -> None:
    """A gather's tables (rows_list None) or a scatter's tables and rows."""
    if rows_list is None:
        rows_list = [None] * len(tables)
    if len(tables) != len(rows_list):
        raise ValueError(
            f"{name}: {len(tables)} tables but {len(rows_list)} row blocks")
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(
            f"{name}: 1 to {MAX_TABLES} tables a call, got {len(tables)}")
    for table, rows in zip(tables, rows_list):
        _check(name, table, idx, rows)
    if live is not None:
        if (not isinstance(live, torch.Tensor) or live.dtype != torch.int64
                or live.numel() != 1):
            raise TypeError(
                f"{name}: live must be a tensor of one int64 element, got "
                f"{live!r}")
        if live.device != idx.device:
            raise ValueError(
                f"{name}: live on {live.device}, idx on {idx.device}")


_bound = None


def _library():
    """The compiled kernels with their C signatures set (pointers and the
    stream as c_void_p — ctypes would cut them to 32 bits otherwise)."""
    global _bound
    if _bound is None:
        from psgradientsdf_tpu_torch.kernels import load_library

        lib = load_library(_LIB_NAME)
        p, i = ctypes.c_void_p, ctypes.c_int
        # tables[], rows[], r[], n_tables, idx, cap, idx64, stream
        for fn in ("rowcopy_gather_tables", "rowcopy_gather_tables_staged"):
            getattr(lib, fn).argtypes = [p, p, p, i, p, i, i, p]
            getattr(lib, fn).restype = i
        # tables[], rows[], r[], n_tables, idx, live, cap, idx64, winner, tag,
        # stream
        lib.rowcopy_scatter_tables.argtypes = [
            p, p, p, i, p, p, i, i, p, ctypes.c_uint, p]
        lib.rowcopy_scatter_tables.restype = i
        _bound = lib
    return _bound


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    launch_counts[name] += 1


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch_gather(name: str, c_name: str, tables,
                   idx: torch.Tensor) -> List[torch.Tensor]:
    lib = _library()
    n, cap, dev = len(tables), idx.shape[0], idx.device
    outs = [torch.empty((cap, t.shape[1]), dtype=t.dtype, device=dev)
            for t in tables]
    widths = (ctypes.c_int * n)(*[t.shape[1] for t in tables])
    with torch.cuda.device(dev):
        _launch(name, getattr(lib, c_name), _pointers(tables), _pointers(outs),
                widths, n, idx.data_ptr(), cap, int(idx.dtype == torch.int64),
                torch.cuda.current_stream(dev).cuda_stream)
    return outs


def gather_tables_dma(tables: Sequence[torch.Tensor],
                      idx: torch.Tensor) -> List[torch.Tensor]:
    """rows[t][i] = tables[t][idx[i]] for every table of the list, in one
    launch of the direct kernel (global->global, a warp per slot); returns
    the list of new contiguous [CAP, R] row blocks, each of its table's
    dtype."""
    _check_tables("gather_rows_dma", tables, idx)
    if idx.device.type == "cpu":
        return gather_tables_plain(tables, idx)
    return _launch_gather("gather_rows_dma", "rowcopy_gather_tables", tables, idx)


def gather_rows_dma(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows[i] = table[idx[i]] by direct global->global row copies."""
    return gather_tables_dma([table], idx)[0]


def _launch_scatter(name: str, tables, idx: torch.Tensor, rows_list,
                    live: Optional[torch.Tensor],
                    winner: Optional[torch.Tensor], tag: int) -> None:
    lib = _library()
    n = len(tables)
    widths = (ctypes.c_int * n)(*[t.shape[1] for t in tables])
    dev = tables[0].device
    with torch.cuda.device(dev):
        _launch(name, lib.rowcopy_scatter_tables, _pointers(tables),
                _pointers(rows_list), widths, n,
                idx.data_ptr(), None if live is None else live.data_ptr(),
                idx.shape[0], int(idx.dtype == torch.int64),
                None if winner is None else winner.data_ptr(), tag,
                torch.cuda.current_stream(dev).cuda_stream)


def scatter_tables_dma(tables: Sequence[torch.Tensor], idx: torch.Tensor,
                       rows_list: Sequence[torch.Tensor], *,
                       live: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """tables[t][idx[i]] = rows_list[t][i] IN PLACE for every table of the
    list, in one kernel launch; returns the tables.  Duplicate indices race:
    slots that share an index must carry identical rows.  `live`: see the
    module docstring."""
    _check_tables("scatter_rows_dma", tables, idx, rows_list, live)
    if idx.device.type == "cpu":
        return scatter_tables_dma_plain(tables, idx, rows_list, live)
    _launch_scatter("scatter_rows_dma", tables, idx, rows_list, live, None, 0)
    return list(tables)


def scatter_rows_dma(table: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """table[idx[i]] = rows[i] IN PLACE; returns `table`.  Duplicate indices
    race: slots that share an index must carry identical rows."""
    return scatter_tables_dma([table], idx, [rows])[0]


def gather_tables(tables: Sequence[torch.Tensor],
                  idx: torch.Tensor) -> List[torch.Tensor]:
    """Same function as gather_tables_dma, in one launch of the staged
    kernel (the rows go through shared memory)."""
    _check_tables("gather_rows", tables, idx)
    if idx.device.type == "cpu":
        return gather_tables_plain(tables, idx)
    return _launch_gather("gather_rows", "rowcopy_gather_tables_staged",
                          tables, idx)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Same function as gather_rows_dma, staged through shared memory."""
    return gather_tables([table], idx)[0]


# The ordered scatter's winner scratch: one uint64 vector per (device, stream),
# zeroed when it is made, never refilled, and made anew only when a call needs
# more than its length (entries past a call's N are not looked at).  It lives
# as long as the process: 8 bytes for each row of the largest table seen on
# that stream.  A call tags its entries with a counter that grows from call to
# call (high 32 bits; the slot sits in the low 32), so an older call's entries
# lose every atomicMax.  That is sound as long as the calls that share a
# scratch run one after the other on the device, which one stream guarantees;
# hence a scratch per stream.  It is NOT sound under CUDA graph capture: a
# replay would reuse the captured tag.
_TAG_LIMIT = 2 ** 32 - 1
_winner_scratch: Dict[Tuple[int, int], list] = {}


def _winner_for(device: torch.device, n: int) -> Tuple[torch.Tensor, int]:
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "scatter_rows: the ordered scatter cannot be captured in a CUDA "
            "graph (its call counter would be replayed)")
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    entry = _winner_scratch.get(key)
    if entry is None or entry[0].numel() < n or entry[1] >= _TAG_LIMIT:
        entry = [torch.zeros((n,), dtype=torch.int64, device=device), 0]
        _winner_scratch[key] = entry
    entry[1] += 1
    return entry[0], entry[1]


def scatter_tables(tables: Sequence[torch.Tensor], idx: torch.Tensor,
                   rows_list: Sequence[torch.Tensor], *,
                   live: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """tables[t][idx[i]] = rows_list[t][i] IN PLACE for every table of the
    list, duplicates in slot order (the last slot wins on every table);
    returns the tables.  Two launches: the winners of the shared index vector,
    then the predicated write of all tables.  `live`: see the module
    docstring."""
    _check_tables("scatter_rows", tables, idx, rows_list, live)
    if idx.device.type == "cpu":
        return scatter_tables_plain(tables, idx, rows_list, live)
    with torch.cuda.device(idx.device):
        winner, tag = _winner_for(idx.device, max(t.shape[0] for t in tables))
    _launch_scatter("scatter_rows", tables, idx, rows_list, live, winner, tag)
    return list(tables)


def scatter_rows(table: torch.Tensor, idx: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """table[idx[i]] = rows[i] IN PLACE, duplicates in slot order (the last
    slot wins); returns `table`."""
    return scatter_tables([table], idx, [rows])[0]
