"""The port's length bucketing (`trainer/bucketing.py`) against the JAX
package's: `create_batches` equal over seeded lengths and budgets (ties
included: the stable argsort keeps equal lengths in index order),
`pad_rows` and the menu rounding equal."""

import numpy as np
import pytest

from nanorlhf_tpu.trainer import bucketing as jb
from nanorlhf_tpu_torch.trainer import bucketing as tb


CASES = [(seed, n, budget) for seed in range(4) for n, budget in
         ((1, 10), (7, 40), (32, 200), (64, 9264), (200, 50952))]


@pytest.mark.parametrize("seed,n,budget", CASES)
def test_create_batches_matches_jax(seed, n, budget):
    rng = np.random.default_rng(seed)
    # few distinct lengths: many ties, some rows over the budget alone
    lengths = rng.choice([1, 5, 17, 40, 200, 2316, 8021, 9300], n) if seed % 2 else \
        rng.integers(1, max(2, budget // 3), n)
    got = tb.create_batches(lengths, budget)
    assert got == jb.create_batches(lengths, budget)
    assert sorted(i for b in got for i in b) == list(range(n))
    for b in got:
        assert len(b) == 1 or int(np.max(lengths[b])) * len(b) <= budget
        # equal lengths stay in index order inside a bucket
        for i, j in zip(b, b[1:]):
            assert lengths[i] < lengths[j] or (lengths[i] == lengths[j] and i < j)


@pytest.mark.parametrize("rows", [2, 3, 4, 8])
def test_pad_rows_matches_jax(rows):
    rng = np.random.default_rng(rows)
    arrays = {"qr": rng.integers(0, 50, (2, 5)).astype(np.int32),
              "lp": rng.normal(size=(2, 4)).astype(np.float32),
              "m": rng.random((2, 4)) > 0.5, "adv": np.ones((2, 4), np.float32)}
    fill = {"qr": 0, "lp": 1.0, "m": True}
    got, want = tb.pad_rows(arrays, rows, fill), jb.pad_rows(arrays, rows, fill)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape[0] == rows
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("value", [1, 16, 17, 31, 32, 33, 8021, 9000])
def test_menu_rounding_matches_jax(value):
    menu, jmenu = tb.shape_menu(8021, 32), jb.shape_menu(8021, 32)
    assert menu == jmenu
    assert tb.round_up_to_menu(value, menu) == jb.round_up_to_menu(value, jmenu)
