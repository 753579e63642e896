"""ops/rowcopy.py of the PyTorch package against the four Pallas row-copy
kernels of the JAX package (run in interpret mode on the CPU, as the JAX
package's own tests run them) and against numpy.

A row copy moves bits and computes nothing, so every comparison is exact.
On CPU tensors the wrappers take their plain PyTorch versions; the CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from psgradientsdf_tpu.ops import rowcopy as jrow
from psgradientsdf_tpu_torch.ops import rowcopy as trow

torch.set_num_threads(1)


def _table(rng, n, r, dtype):
    if dtype == np.float32:
        return rng.standard_normal((n, r)).astype(np.float32)
    return rng.integers(-2 ** 31, 2 ** 31 - 1, (n, r), dtype=np.int64).astype(np.int32)


def _idx_with_duplicates(rng, n, cap):
    idx = rng.integers(0, n, cap)
    idx[cap // 2:] = idx[: cap - cap // 2]      # every index of one half twice
    return idx.astype(np.int32)


GATHERS = [
    ("gather_rows_dma", jrow.gather_rows_dma, trow.gather_rows_dma),
    ("gather_rows", jrow.gather_rows, trow.gather_rows),
]


@pytest.mark.parametrize("name,jfn,tfn", GATHERS, ids=[g[0] for g in GATHERS])
@pytest.mark.parametrize("r", [128, 384])
@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
def test_gather_matches_pallas(name, jfn, tfn, r, dtype):
    rng = np.random.default_rng(r + (dtype == np.int32))
    n, cap = 64, 16
    table = _table(rng, n, r, dtype)
    idx = _idx_with_duplicates(rng, n, cap)
    want = np.asarray(jfn(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    got = tfn(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[idx])
    assert got.dtype == dtype


@pytest.mark.parametrize("r", [128, 384])
def test_scatter_dma_matches_pallas_identical_duplicates(r):
    """Direct scatter: slots that share an index carry identical rows (the
    fusion's padding contract), so the order of the writes cannot matter."""
    rng = np.random.default_rng(3 + r)
    n, cap = 64, 16
    table = _table(rng, n, r, np.float32)
    idx = _idx_with_duplicates(rng, n, cap)
    rows = _table(rng, cap, r, np.float32)
    rows[cap // 2:] = rows[: cap - cap // 2]
    want = np.asarray(jrow.scatter_rows_dma(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(rows), interpret=True))
    t = torch.from_numpy(table.copy())
    out = trow.scatter_rows_dma(t, torch.from_numpy(idx), torch.from_numpy(rows))
    assert out is t                                   # in place
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("r", [128, 384])
def test_scatter_ordered_matches_pallas_last_slot_wins(r):
    """Ordered scatter: duplicates carry DIFFERENT rows and the last slot
    that names a row wins, as the TPU kernel's sequential grid has it."""
    rng = np.random.default_rng(5 + r)
    n, cap = 64, 24
    table = _table(rng, n, r, np.float32)
    idx = rng.integers(0, 6, cap).astype(np.int32)     # heavy duplicates
    rows = _table(rng, cap, r, np.float32)
    want = np.asarray(jrow.scatter_rows(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(rows), interpret=True))
    ref = table.copy()
    for i in range(cap):                               # slot order
        ref[idx[i]] = rows[i]
    np.testing.assert_array_equal(want, ref)
    t = torch.from_numpy(table.copy())
    out = trow.scatter_rows(t, torch.from_numpy(idx), torch.from_numpy(rows))
    assert out is t
    np.testing.assert_array_equal(t.numpy(), ref)


@pytest.mark.parametrize("r", [1, 33, 96])
@pytest.mark.parametrize("cap", [1, 7, 513])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64], ids=["i32", "i64"])
def test_any_width_and_capacity_against_numpy(r, cap, idx_dtype):
    """Row widths off the TPU kernels' 128-multiple rule and capacities off
    any group size: all four functions against numpy."""
    rng = np.random.default_rng(1000 * r + cap)
    n = 40
    table = _table(rng, n, r, np.int32)
    idx = rng.integers(0, n, cap).astype(idx_dtype)
    rows = _table(rng, cap, r, np.int32)
    ti = torch.from_numpy(idx)
    for fn in (trow.gather_rows_dma, trow.gather_rows):
        np.testing.assert_array_equal(
            fn(torch.from_numpy(table), ti).numpy(), table[idx])
    ref = table.copy()
    for i in range(cap):
        ref[idx[i]] = rows[i]
    t = torch.from_numpy(table.copy())
    trow.scatter_rows(t, ti, torch.from_numpy(rows))
    np.testing.assert_array_equal(t.numpy(), ref)
    # direct scatter: make duplicates identical first (its contract)
    same = ref[idx]
    t = torch.from_numpy(table.copy())
    trow.scatter_rows_dma(t, ti, torch.from_numpy(same))
    np.testing.assert_array_equal(t.numpy(), ref)


def test_plain_versions_are_what_cpu_wrappers_run():
    rng = np.random.default_rng(9)
    table = _table(rng, 32, 8, np.float32)
    idx = rng.integers(0, 32, 12).astype(np.int32)
    rows = _table(rng, 12, 8, np.float32)
    before = dict(trow.launch_counts)
    a = trow.gather_rows_dma(torch.from_numpy(table), torch.from_numpy(idx))
    b = trow.gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx))
    assert torch.equal(a, b)
    t1, t2 = torch.from_numpy(table.copy()), torch.from_numpy(table.copy())
    trow.scatter_rows(t1, torch.from_numpy(idx), torch.from_numpy(rows))
    trow.scatter_rows_plain(t2, torch.from_numpy(idx), torch.from_numpy(rows))
    assert torch.equal(t1, t2)
    # a CPU call launches no kernel and so counts none
    assert trow.launch_counts == before


BAD = [
    ("float64 table", lambda: (torch.zeros(4, 4, dtype=torch.float64),
                               torch.zeros(2, dtype=torch.int32), None), TypeError),
    ("float16 table", lambda: (torch.zeros(4, 4, dtype=torch.float16),
                               torch.zeros(2, dtype=torch.int32), None), TypeError),
    ("float idx", lambda: (torch.zeros(4, 4), torch.zeros(2), None), TypeError),
    ("int16 idx", lambda: (torch.zeros(4, 4),
                           torch.zeros(2, dtype=torch.int16), None), TypeError),
    ("1-D table", lambda: (torch.zeros(4), torch.zeros(2, dtype=torch.int32),
                           None), ValueError),
    ("2-D idx", lambda: (torch.zeros(4, 4),
                         torch.zeros(2, 1, dtype=torch.int32), None), ValueError),
    ("empty idx", lambda: (torch.zeros(4, 4),
                           torch.zeros(0, dtype=torch.int32), None), ValueError),
    ("strided table", lambda: (torch.zeros(4, 8)[:, ::2],
                               torch.zeros(2, dtype=torch.int32), None), ValueError),
    ("rows shape", lambda: (torch.zeros(4, 4), torch.zeros(2, dtype=torch.int32),
                            torch.zeros(3, 4)), ValueError),
    ("rows dtype", lambda: (torch.zeros(4, 4), torch.zeros(2, dtype=torch.int32),
                            torch.zeros(2, 4, dtype=torch.int32)), TypeError),
    ("strided rows", lambda: (torch.zeros(4, 4), torch.zeros(2, dtype=torch.int32),
                              torch.zeros(2, 8)[:, ::2]), ValueError),
]


@pytest.mark.parametrize("what,make,exc", BAD, ids=[b[0] for b in BAD])
def test_wrappers_reject_bad_arguments(what, make, exc):
    table, idx, rows = make()
    if rows is None:
        for fn in (trow.gather_rows_dma, trow.gather_rows):
            with pytest.raises(exc):
                fn(table, idx)
        rows = torch.zeros((idx.shape[0], 4)) if table.dim() == 2 else torch.zeros(2, 4)
    for fn in (trow.scatter_rows_dma, trow.scatter_rows):
        with pytest.raises(exc):
            fn(table, idx, rows)


# ---------------------------------------------------------------------------
# the multi-table scatters: up to 8 tables that share one idx, one call
# ---------------------------------------------------------------------------

# one fused frame's five tables (dist, grad, weight, colour, visibility word)
FRAME_TABLES = [(128, np.float32), (384, np.float32), (128, np.float32),
                (384, np.float32), (128, np.int32)]


def _lists(rng, n, cap, specs):
    tables = [_table(rng, n, r, dt) for r, dt in specs]
    rows = [_table(rng, cap, r, dt) for r, dt in specs]
    return tables, rows


def _torch_copies(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _slot_order(tables, idx, rows):
    ref = [t.copy() for t in tables]
    for t, r in zip(ref, rows):
        for i in range(len(idx)):
            t[idx[i]] = r[i]
    return ref


def _prefix(t):
    return [(FRAME_TABLES * 2)[k] for k in range(t)]


@pytest.mark.parametrize("specs", [_prefix(t) for t in (1, 2, 5, 8)],
                         ids=["T1", "T2", "T5_the_frame", "T8"])
def test_scatter_tables_dma_matches_pallas_table_by_table(specs):
    """One call on the list against the TPU kernel run on each table; slots
    that share an index carry identical rows."""
    rng = np.random.default_rng(11 + len(specs))
    n, cap = 64, 16
    idx = _idx_with_duplicates(rng, n, cap)
    tables, rows = _lists(rng, n, cap, specs)
    for r in rows:
        r[cap // 2:] = r[: cap - cap // 2]
    want = [np.asarray(jrow.scatter_rows_dma(
        jnp.asarray(t), jnp.asarray(idx), jnp.asarray(r), interpret=True))
        for t, r in zip(tables, rows)]
    tt = _torch_copies(tables)
    out = trow.scatter_tables_dma(tt, torch.from_numpy(idx), _torch_copies(rows))
    assert len(out) == len(tt) and all(a is b for a, b in zip(out, tt))  # in place
    for got, w, (_, dt) in zip(tt, want, specs):
        np.testing.assert_array_equal(got.numpy(), w)
        assert got.numpy().dtype == dt


@pytest.mark.parametrize("specs", [_prefix(t) for t in (1, 2, 5, 8)],
                         ids=["T1", "T2", "T5_the_frame", "T8"])
def test_scatter_tables_ordered_matches_pallas_last_slot_wins(specs):
    """Duplicates carry DIFFERENT rows: the last slot wins on every table, as
    the TPU kernel's sequential grid has it on each."""
    rng = np.random.default_rng(17 + len(specs))
    n, cap = 64, 24
    idx = rng.integers(0, 6, cap).astype(np.int32)     # heavy duplicates
    tables, rows = _lists(rng, n, cap, specs)
    want = [np.asarray(jrow.scatter_rows(
        jnp.asarray(t), jnp.asarray(idx), jnp.asarray(r), interpret=True))
        for t, r in zip(tables, rows)]
    ref = _slot_order(tables, idx, rows)
    tt = _torch_copies(tables)
    out = trow.scatter_tables(tt, torch.from_numpy(idx), _torch_copies(rows))
    assert all(a is b for a, b in zip(out, tt))
    for got, w, r in zip(tt, want, ref):
        np.testing.assert_array_equal(w, r)
        np.testing.assert_array_equal(got.numpy(), r)


@pytest.mark.parametrize("r", [1, 33, 96])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64], ids=["i32", "i64"])
def test_scatter_tables_any_width_against_numpy(r, idx_dtype):
    """Widths off the TPU kernels' 128-multiple rule, mixed in one list with
    a frame-sized one, both dtypes."""
    rng = np.random.default_rng(2000 + r)
    n, cap = 40, 97
    specs = [(r, np.float32), (r, np.int32), (128, np.float32)]
    idx = rng.integers(0, n, cap).astype(idx_dtype)
    tables, rows = _lists(rng, n, cap, specs)
    ref = _slot_order(tables, idx, rows)
    ti = torch.from_numpy(idx)
    tt = _torch_copies(tables)
    trow.scatter_tables(tt, ti, _torch_copies(rows))
    for got, want in zip(tt, ref):
        np.testing.assert_array_equal(got.numpy(), want)
    # direct: duplicates made identical first (its contract)
    tt = _torch_copies(tables)
    trow.scatter_tables_dma(tt, ti, [torch.from_numpy(w[idx]) for w in ref])
    for got, want in zip(tt, ref):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["scatter_rows_dma", "scatter_rows"])
def test_one_table_scatter_is_the_one_table_case(name):
    rng = np.random.default_rng(23)
    table = _table(rng, 32, 8, np.float32)
    idx = rng.permutation(32)[:12].astype(np.int32)
    rows = _table(rng, 12, 8, np.float32)
    multi = {"scatter_rows_dma": trow.scatter_tables_dma,
             "scatter_rows": trow.scatter_tables}[name]
    a, b = torch.from_numpy(table.copy()), torch.from_numpy(table.copy())
    getattr(trow, name)(a, torch.from_numpy(idx), torch.from_numpy(rows))
    multi([b], torch.from_numpy(idx), [torch.from_numpy(rows)])
    assert torch.equal(a, b)
    want = table.copy()
    want[idx] = rows
    np.testing.assert_array_equal(a.numpy(), want)


def test_multi_table_plain_versions_are_what_cpu_wrappers_run():
    rng = np.random.default_rng(29)
    idx = torch.from_numpy(rng.integers(0, 6, 24).astype(np.int32))
    tables, rows = _lists(rng, 64, 24, FRAME_TABLES)
    before = dict(trow.launch_counts)
    got = trow.scatter_tables(_torch_copies(tables), idx, _torch_copies(rows))
    want = trow.scatter_tables_plain(_torch_copies(tables), idx, _torch_copies(rows))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert trow.launch_counts == before and set(before) == {
        "gather_rows_dma", "scatter_rows_dma", "gather_rows", "scatter_rows"}


def _ok_lists(t, cap=4):
    return ([torch.zeros(8, 4) for _ in range(t)],
            torch.zeros(cap, dtype=torch.int32),
            [torch.zeros(cap, 4) for _ in range(t)])


BAD_LISTS = [
    ("nine tables", lambda: _ok_lists(9), ValueError),
    ("empty list", lambda: _ok_lists(0), ValueError),
    ("unequal lengths", lambda: (_ok_lists(3)[0], _ok_lists(3)[1],
                                 _ok_lists(2)[2]), ValueError),
    ("CAP mismatch in one table", lambda: (
        _ok_lists(3)[0], _ok_lists(3)[1],
        [torch.zeros(4, 4), torch.zeros(5, 4), torch.zeros(4, 4)]), ValueError),
    ("width mismatch in one table", lambda: (
        _ok_lists(2)[0], _ok_lists(2)[1],
        [torch.zeros(4, 4), torch.zeros(4, 8)]), ValueError),
    ("dtype mismatch in one table", lambda: (
        _ok_lists(2)[0], _ok_lists(2)[1],
        [torch.zeros(4, 4), torch.zeros(4, 4, dtype=torch.int32)]), TypeError),
    ("float64 table in the list", lambda: (
        [torch.zeros(8, 4), torch.zeros(8, 4, dtype=torch.float64)],
        _ok_lists(2)[1],
        [torch.zeros(4, 4), torch.zeros(4, 4, dtype=torch.float64)]), TypeError),
    ("strided rows in the list", lambda: (
        _ok_lists(2)[0], _ok_lists(2)[1],
        [torch.zeros(4, 4), torch.zeros(4, 8)[:, ::2]]), ValueError),
]


@pytest.mark.parametrize("what,make,exc", BAD_LISTS, ids=[b[0] for b in BAD_LISTS])
def test_multi_table_wrappers_reject_bad_lists(what, make, exc):
    tables, idx, rows = make()
    for fn in (trow.scatter_tables_dma, trow.scatter_tables):
        with pytest.raises(exc):
            fn(tables, idx, rows)


def test_multi_table_wrappers_take_a_live_count():
    """Slots at or past `live` repeat an earlier slot (index and rows), so a
    call that names the count writes the same tables as one that does not."""
    rng = np.random.default_rng(31)
    n, cap, live = 64, 24, 17
    idx = np.sort(rng.permutation(n)[:cap]).astype(np.int32)
    idx[live:] = idx[0]
    tables, rows = _lists(rng, n, cap, FRAME_TABLES)
    for r in rows:
        r[live:] = r[0]
    ref = _slot_order(tables, idx, rows)
    for fn in (trow.scatter_tables_dma, trow.scatter_tables):
        tt = _torch_copies(tables)
        fn(tt, torch.from_numpy(idx), _torch_copies(rows),
           live=torch.tensor(live, dtype=torch.int64))
        for got, want in zip(tt, ref):
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("past_live", ["repeat_slot_0", "free"])
def test_packed_width_with_live_against_pallas_and_numpy(past_live):
    """The packed fusion's two tables (payload rows of 1024 floats beside a
    128-wide int32 visibility word) with its index vector: ascending
    distinct rows, then padding that repeats the first, and `live`.  The
    gathers equal the TPU kernels and numpy; both scatters, and their plain
    versions told `live`, write the live slots alone — whether the slots
    past it repeat slot 0 (the fusion) or hold other rows (the resident
    state's free slots, core/resident.py)."""
    rng = np.random.default_rng(37)
    specs = [(1024, np.float32), (128, np.int32)]
    n, cap, live = 96, 40, 29
    idx = np.sort(rng.permutation(n)[:cap]).astype(np.int32)
    idx[live:] = idx[0]
    tables, rows = _lists(rng, n, cap, specs)
    if past_live == "repeat_slot_0":
        for r in rows:
            r[live:] = r[0]
    ti = torch.from_numpy(idx)
    for name, jfn in (("gather_tables_dma", jrow.gather_rows_dma),
                      ("gather_tables", jrow.gather_rows)):
        got = getattr(trow, name)(_torch_copies(tables), ti)
        for g, t in zip(got, tables):
            np.testing.assert_array_equal(g.numpy(), t[idx])
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(jfn(jnp.asarray(t), jnp.asarray(idx),
                                          interpret=True)))
    ref = _slot_order(tables, idx[:live], [r[:live] for r in rows])
    pallas = [np.asarray(jrow.scatter_rows_dma(
        jnp.asarray(t), jnp.asarray(idx[:live]), jnp.asarray(r[:live]),
        interpret=True)) for t, r in zip(tables, rows)]
    lv = torch.tensor(live, dtype=torch.int64)
    for fn in (trow.scatter_tables_dma, trow.scatter_tables,
               trow.scatter_tables_dma_plain, trow.scatter_tables_plain):
        tt = _torch_copies(tables)
        fn(tt, ti, _torch_copies(rows), live=lv)
        for got, want, p in zip(tt, ref, pallas):
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got.numpy(), p)


@pytest.mark.parametrize("live,exc", [
    (torch.tensor(3, dtype=torch.int32), TypeError),
    (torch.tensor([3, 4], dtype=torch.int64), TypeError),
    (3, TypeError)], ids=["int32", "two_elements", "python_int"])
def test_multi_table_wrappers_reject_bad_live(live, exc):
    tables, idx, rows = _ok_lists(2)
    for fn in (trow.scatter_tables_dma, trow.scatter_tables):
        with pytest.raises(exc):
            fn(tables, idx, rows, live=live)


# ---------------------------------------------------------------------------
# the multi-table gathers: up to 8 tables that share one idx, one call
# ---------------------------------------------------------------------------

MULTI_GATHERS = [
    ("gather_tables_dma", jrow.gather_rows_dma, trow.gather_tables_dma),
    ("gather_tables", jrow.gather_rows, trow.gather_tables),
]


@pytest.mark.parametrize("name,jfn,tfn", MULTI_GATHERS,
                         ids=[g[0] for g in MULTI_GATHERS])
@pytest.mark.parametrize("specs", [_prefix(t) for t in (1, 2, 5, 8)],
                         ids=["T1", "T2", "T5_the_frame", "T8"])
def test_gather_tables_match_pallas_table_by_table(name, jfn, tfn, specs):
    """One call on the list against the TPU kernel run on each table."""
    rng = np.random.default_rng(37 + len(specs))
    n, cap = 64, 16
    idx = _idx_with_duplicates(rng, n, cap)
    tables, _ = _lists(rng, n, cap, specs)
    want = [np.asarray(jfn(jnp.asarray(t), jnp.asarray(idx), interpret=True))
            for t in tables]
    got = tfn(_torch_copies(tables), torch.from_numpy(idx))
    assert isinstance(got, list) and len(got) == len(specs)
    for g, w, t, (r, dt) in zip(got, want, tables, specs):
        assert g.is_contiguous() and tuple(g.shape) == (cap, r)
        assert g.numpy().dtype == dt
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), t[idx])


@pytest.mark.parametrize("name,jfn,tfn", MULTI_GATHERS,
                         ids=[g[0] for g in MULTI_GATHERS])
@pytest.mark.parametrize("r", [1, 33, 96])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64], ids=["i32", "i64"])
def test_gather_tables_any_width_against_numpy(name, jfn, tfn, r, idx_dtype):
    """Widths off the TPU kernels' 128-multiple rule, mixed in one list with
    a frame-sized one, both dtypes; capacities off any group size."""
    rng = np.random.default_rng(3000 + r)
    n = 40
    specs = [(r, np.float32), (r, np.int32), (128, np.float32)]
    for cap in (1, 7, 97):
        idx = rng.integers(0, n, cap).astype(idx_dtype)
        tables, _ = _lists(rng, n, cap, specs)
        got = tfn(_torch_copies(tables), torch.from_numpy(idx))
        for g, t in zip(got, tables):
            np.testing.assert_array_equal(g.numpy(), t[idx])
            assert g.numpy().dtype == t.dtype


@pytest.mark.parametrize("name", ["gather_rows_dma", "gather_rows"])
def test_one_table_gather_is_the_one_table_case(name):
    rng = np.random.default_rng(41)
    table = _table(rng, 32, 8, np.int32)
    idx = rng.integers(0, 32, 12).astype(np.int32)
    multi = {"gather_rows_dma": trow.gather_tables_dma,
             "gather_rows": trow.gather_tables}[name]
    a = getattr(trow, name)(torch.from_numpy(table), torch.from_numpy(idx))
    (b,) = multi([torch.from_numpy(table)], torch.from_numpy(idx))
    assert torch.equal(a, b) and a.dtype == b.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), table[idx])


def test_multi_table_gather_plain_versions_are_what_cpu_wrappers_run():
    rng = np.random.default_rng(43)
    idx = torch.from_numpy(rng.integers(0, 64, 24).astype(np.int32))
    tables, _ = _lists(rng, 64, 24, FRAME_TABLES)
    before = dict(trow.launch_counts)
    want = trow.gather_tables_plain(_torch_copies(tables), idx)
    for fn in (trow.gather_tables_dma, trow.gather_tables):
        got = fn(_torch_copies(tables), idx)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [torch.equal(w, trow.gather_rows_plain(torch.from_numpy(t), idx))
            for w, t in zip(want, tables)] == [True] * 5
    # a CPU call launches no kernel and so counts none
    assert trow.launch_counts == before


BAD_GATHER_LISTS = [
    ("nine tables", lambda: (_ok_lists(9)[0], _ok_lists(9)[1]), ValueError),
    ("empty list", lambda: ([], torch.zeros(4, dtype=torch.int32)), ValueError),
    ("mixed devices", lambda: (
        [torch.zeros(8, 4), torch.zeros(8, 4, device="meta")],
        torch.zeros(4, dtype=torch.int32)), ValueError),
    ("idx on another device", lambda: (
        _ok_lists(2)[0], torch.zeros(4, dtype=torch.int32, device="meta")),
     ValueError),
    ("strided table in the list", lambda: (
        [torch.zeros(8, 4), torch.zeros(8, 8)[:, ::2]],
        torch.zeros(4, dtype=torch.int32)), ValueError),
    ("float64 table in the list", lambda: (
        [torch.zeros(8, 4), torch.zeros(8, 4, dtype=torch.float64)],
        torch.zeros(4, dtype=torch.int32)), TypeError),
    ("float16 table in the list", lambda: (
        [torch.zeros(8, 4, dtype=torch.float16)],
        torch.zeros(4, dtype=torch.int32)), TypeError),
    ("float idx", lambda: (_ok_lists(2)[0], torch.zeros(4)), TypeError),
    ("int16 idx", lambda: (_ok_lists(2)[0],
                           torch.zeros(4, dtype=torch.int16)), TypeError),
    ("1-D table in the list", lambda: (
        [torch.zeros(8, 4), torch.zeros(8)],
        torch.zeros(4, dtype=torch.int32)), ValueError),
    ("empty idx", lambda: (_ok_lists(2)[0],
                           torch.zeros(0, dtype=torch.int32)), ValueError),
]


@pytest.mark.parametrize("what,make,exc", BAD_GATHER_LISTS,
                         ids=[b[0] for b in BAD_GATHER_LISTS])
def test_multi_table_gathers_reject_bad_lists(what, make, exc):
    tables, idx = make()
    for fn in (trow.gather_tables_dma, trow.gather_tables):
        with pytest.raises(exc):
            fn(tables, idx)
