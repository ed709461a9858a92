"""The port's host-side page allocator (`sampler/paged/pages.py`) against
the JAX allocator (`nanorlhf_tpu/sampler/paged/pages.py`): the same op
sequences — allocations, releases, an underflow, a double release — give
equal states after every op (free stack, stack pointer, table) and equal
return values. Integer state: compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from nanorlhf_tpu.sampler.paged import pages as jp
from nanorlhf_tpu_torch.sampler.paged import pages as tp


def _assert_same(t_state, j_state):
    np.testing.assert_array_equal(t_state.free, np.asarray(j_state.free))
    assert t_state.top == int(j_state.top)
    np.testing.assert_array_equal(t_state.table, np.asarray(j_state.table))


def _run(ops, num_pages, rows, nb):
    """Apply ops [("alloc", row, n) | ("release", row)] to both allocators,
    comparing after each; returns the port's return values."""
    ts, js = tp.init_page_state(num_pages, rows, nb), jp.init_page_state(num_pages, rows, nb)
    _assert_same(ts, js)
    results = []
    for op in ops:
        if op[0] == "alloc":
            ts, t_ok = tp.alloc_row(ts, op[1], op[2])
            js, j_ok = jp.alloc_row(js, op[1], jnp.int32(op[2]))
            assert t_ok == bool(j_ok)
            results.append(t_ok)
        else:
            ts, t_m = tp.release_row(ts, op[1])
            js, j_m = jp.release_row(js, op[1])
            assert t_m == int(j_m)
            results.append(t_m)
        _assert_same(ts, js)
    return ts, results


SEQUENCES = {
    "fill_then_churn": (12, 4, 3, [
        ("alloc", 0, 3), ("alloc", 1, 3), ("alloc", 2, 3), ("alloc", 3, 3),
        ("release", 2), ("alloc", 2, 3), ("release", 0), ("release", 1),
        ("alloc", 1, 2), ("alloc", 0, 3)]),
    "underflow_leaves_state": (7, 3, 3, [
        ("alloc", 0, 3), ("alloc", 1, 3), ("alloc", 2, 3), ("release", 1),
        ("alloc", 2, 3), ("alloc", 1, 1)]),
    "double_release_frees_nothing": (8, 2, 4, [
        ("alloc", 0, 4), ("release", 0), ("release", 0), ("alloc", 1, 2),
        ("release", 1), ("release", 1), ("release", 0)]),
    "partial_and_oversized_rows": (10, 3, 4, [
        ("alloc", 0, 1), ("alloc", 1, 9), ("release", 0), ("alloc", 2, 4),
        ("release", 1), ("alloc", 0, 2)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_allocator_op_sequences_match_jax(name):
    num_pages, rows, nb, ops = SEQUENCES[name]
    _run(ops, num_pages, rows, nb)


def test_allocator_invariants():
    N, R, nb = 12, 4, 3
    st = tp.init_page_state(N, R, nb)
    assert st.top == N and (st.table == N).all()
    for r in range(R):
        st, ok = tp.alloc_row(st, r, nb)
        assert ok
    assert st.top == 0 and sorted(st.table.ravel().tolist()) == list(range(N))
    # the stack pops from top - 1 downward: row 0 got pages 11, 10, 9
    assert st.table[0].tolist() == [11, 10, 9]
    # exhausted pool: ok=False and the state is unchanged
    st2, ok = tp.alloc_row(st, 0, 1)
    assert not ok and st2 is st
    # release pushes the row's live pages in table order, resets to sentinel
    st, m = tp.release_row(st, 1)
    assert m == nb and st.top == nb and (st.table[1] == N).all()
    assert st.free[:nb].tolist() == [8, 7, 6]
    st, m = tp.release_row(st, 1)
    assert m == 0 and st.top == nb


def test_blocks_per_row_and_full_table():
    assert tp.blocks_per_row(24, 8) == 3 and tp.blocks_per_row(25, 8) == 4
    np.testing.assert_array_equal(tp.full_table(3, 2), np.asarray(jp.full_table(3, 2)))
