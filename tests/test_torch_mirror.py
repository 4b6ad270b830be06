"""The port's ``DeviceState`` and dirty-row scatter against the JAX
package's, on the CPU: the padded and clipped layout, refreshes across
every row bucket, copy-not-donate, and the plain scatter against
``_scatter_fn(None)``. Every comparison is exact."""

import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu.tpu import mirror as jmirror
from nomad_tpu_torch.tpu import mirror as tmirror

N_REAL, N_PAD = 6000, 6144


def _planes(seed=0):
    """int64 planes as the committed store holds them, with values the
    device copy has to clip: capacity above int32, used above 2**30 and
    below 0."""
    rng = np.random.default_rng(seed)
    capacity = rng.integers(1000, 40000, (N_REAL, 4)).astype(np.int64)
    capacity[7] = [2**33, -5, 100, 0]
    usable = capacity[:, :2].clip(1, None).astype(np.float32)
    used = rng.integers(0, 3000, (N_REAL, 4)).astype(np.int64)
    used[11] = [2**31 + 9, -3, 2**30, 5]
    return capacity, usable, used


def _jax_arrays(ds):
    return tuple(np.asarray(a) for a in ds.arrays())


def test_layout_matches_jax():
    capacity, usable, used = _planes()
    want = _jax_arrays(jmirror.DeviceState(3, N_PAD, capacity, usable, used))
    ds = tmirror.DeviceState(3, N_PAD, capacity, usable, used, device="cpu")
    got = ds.arrays()
    assert ds.epoch == 3 and ds.n_pad == N_PAD and ds.pending == set()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[2][N_REAL:] == 2**30).all() and (got[1][N_REAL:] == 1.0).all()
    assert int(got[0][7, 0]) == 2**31 - 1 and int(got[2][11, 0]) == 2**30


@pytest.mark.parametrize("n_dirty", [1, 8, 9, 600, 5000])
def test_refresh_matches_jax_across_buckets(n_dirty):
    capacity, usable, used = _planes(1)
    jds = jmirror.DeviceState(0, N_PAD, capacity, usable, used)
    tds = tmirror.DeviceState(0, N_PAD, capacity, usable, used, device="cpu")
    before = tds.arrays()[2]
    kept = before.clone()
    rng = np.random.default_rng(n_dirty)
    rows = rng.choice(N_REAL, n_dirty, replace=False)
    rows[0] = 0 if n_dirty > 1 else rows[0]  # row 0 both real and in the pad lanes
    later = used.copy()
    later[rows] += rng.integers(-500, 500, (n_dirty, 4))
    later[rows[-1]] = [2**31, -1, 7, 2**30 + 1]  # clipped like the upload
    for ds in (jds, tds):
        ds.pending.update(int(r) for r in rows)
        ds.refresh(later)
        assert ds.pending == set()
    np.testing.assert_array_equal(tds.arrays()[2].numpy(), np.asarray(jds.arrays()[2]))
    # copy, not donate: the plane handed out before the refresh is untouched
    assert torch.equal(before, kept)
    assert tds.arrays()[2] is not before
    assert tmirror.DeviceState._row_bucket(n_dirty) == jmirror.DeviceState._row_bucket(n_dirty)


def test_refresh_without_pending_rows_keeps_the_plane():
    capacity, usable, used = _planes(2)
    ds = tmirror.DeviceState(0, N_PAD, capacity, usable, used, device="cpu")
    plane = ds.arrays()[2]
    ds.refresh(used + 1)
    assert ds.arrays()[2] is plane


def test_scatter_ref_matches_jax():
    rng = np.random.default_rng(5)
    used = rng.integers(0, 10**6, (300, 4)).astype(np.int32)
    rows = np.zeros(64, np.int32)  # lanes 40-63 pad with row 0
    rows[:40] = rng.choice(np.arange(1, 300), 40, replace=False)
    rows[5] = 0  # row 0 is also a real dirty row
    vals = rng.integers(0, 10**6, (64, 4)).astype(np.int32)
    vals[40:] = vals[5]
    want = np.asarray(jmirror._scatter_fn(None)(used, rows, vals))
    got = tmirror.scatter_rows(*(torch.from_numpy(a) for a in (used, rows, vals)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_duplicates_keep_the_lowest_lane():
    used = torch.zeros((6, 2), dtype=torch.int32)
    rows = torch.tensor([4, 1, 4, 1, 6, -1], dtype=torch.int32)
    vals = torch.arange(12, dtype=torch.int32).view(6, 2) + 1
    out = tmirror.scatter_rows(used, rows, vals)
    want = torch.zeros((6, 2), dtype=torch.int32)
    want[4], want[1] = vals[0], vals[1]
    assert torch.equal(out, want)
    assert torch.equal(used, torch.zeros((6, 2), dtype=torch.int32))
