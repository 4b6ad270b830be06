"""The port's dense verify against the JAX applier's, on the CPU.

``verify_rows_ref`` against ``_verify_rows_jit`` on random inputs, and a
replay of what the JAX applier hands its device verify: the
``TestDeviceVerifyParity`` setup (tests/test_plan_apply.py) plans seeded
plans through ``Planner._evaluate_plan_device`` with ``verify_rows``
recorded; ``plan_apply.dense_verify`` on the same planes, rows and
aggregated deltas must pad them the same way and give the same verdicts.
Verdicts are exact: no tolerance.
"""

import random

import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

import test_plan_apply as tpa
from nomad_tpu.core.plan_apply import Planner
from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import mirror as jmirror
from nomad_tpu_torch.core import plan_apply as tapply
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import mirror as tmirror


def _verify_case(seed):
    """64 lanes over a 48-row plane: 30 real lanes (duplicates among them,
    row 0 among them, negative deltas, sums landing exactly on capacity),
    the rest pad lanes on row 0 with a delta of 0."""
    rng = np.random.default_rng(seed)
    N, C, R, k = 48, 4, 64, 30
    capacity = rng.integers(1000, 9000, (N, C)).astype(np.int32)
    used = (capacity * rng.uniform(0.2, 1.0, (N, C))).astype(np.int32)
    rows = np.zeros(R, np.int32)
    rows[:k] = rng.integers(0, N, k)
    rows[3] = 0
    rows[7] = rows[8] = 17  # one row, two lanes
    deltas = np.zeros((R, C), np.int32)
    deltas[:k] = rng.integers(-400, 400, (k, C))
    r = rows[11]
    if (rows[:k] == r).sum() == 1:
        deltas[11] = capacity[r] - used[r]  # fits exactly
    return capacity, used, rows, deltas


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_rows_ref_matches_jax(seed):
    capacity, used, rows, deltas = _verify_case(seed)
    want = np.asarray(jk._verify_rows_jit(capacity, used, rows, deltas))
    t = [torch.from_numpy(a) for a in (capacity, used, rows, deltas)]
    kept = t[1].clone()
    got = tk.verify_rows(*t)
    assert got.dtype == torch.bool and got.shape == (64,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    assert torch.equal(t[1], kept)  # used is never written


def _verify_edge(kind):
    """(capacity, used, rows, deltas) at an edge the kernel must take:
    one lane, every lane on one row (the deltas sum to its room exactly),
    pad lanes only."""
    rng = np.random.default_rng(8)
    N, C = 48, 4
    capacity = rng.integers(1000, 9000, (N, C)).astype(np.int32)
    used = (capacity * rng.uniform(0.2, 1.0, (N, C))).astype(np.int32)
    R = 1 if kind == "one_lane" else 64
    rows = rng.integers(0, N, R).astype(np.int32)
    deltas = rng.integers(-400, 400, (R, C)).astype(np.int32)
    if kind == "one_row":
        rows[:] = 9
        deltas[-1] = capacity[9] - used[9] - deltas[:-1].sum(axis=0)
    if kind == "pads_only":
        rows[:], deltas[:] = 0, 0
    return capacity, used, rows, deltas


@pytest.mark.parametrize("kind", ["one_lane", "one_row", "pads_only"])
def test_verify_rows_edges_match_jax(kind):
    capacity, used, rows, deltas = _verify_edge(kind)
    want = np.asarray(jk._verify_rows_jit(capacity, used, rows, deltas))
    got = tk.verify_rows(*(torch.from_numpy(a) for a in (capacity, used, rows, deltas)))
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "one_lane":
        assert want.all()


BAD_VERIFY = ["rows int64", "deltas int64", "deltas width", "deltas length", "rows 2-D",
              "rows strided", "used int64", "used short", "capacity strided",
              "rows elsewhere"]


def _bad_verify(case):
    """The wrapper's arguments with one thing the kernel does not take,
    and the error the wrapper raises for it."""
    capacity, used, rows, deltas = (torch.from_numpy(a) for a in _verify_case(0))
    error = ValueError
    if case == "rows int64":
        rows, error = rows.long(), TypeError
    elif case == "deltas int64":
        deltas, error = deltas.long(), TypeError
    elif case == "deltas width":
        deltas = deltas[:, :3].contiguous()
    elif case == "deltas length":
        deltas = deltas[1:]
    elif case == "rows 2-D":
        rows = rows[:, None]
    elif case == "rows strided":
        rows = torch.stack([rows, rows], 1)[:, 0]
    elif case == "used int64":
        used, error = used.long(), TypeError
    elif case == "used short":
        used = used[1:]
    elif case == "capacity strided":
        capacity = torch.cat([capacity, capacity], 1)[:, :4]
    else:
        assert case == "rows elsewhere"
        rows = rows.to("meta")
    return (capacity, used, rows, deltas), error


@pytest.mark.parametrize("case", BAD_VERIFY)
def test_verify_rows_refuses_what_the_kernel_does_not_take(case):
    """The wrapper checks planes and lanes on the CPU as on the card."""
    args, error = _bad_verify(case)
    with pytest.raises(error):
        tk.verify_rows(*args)


def test_dense_verify_on_device_state_planes():
    """``dense_verify`` on a DeviceState's planes gives the JAX program's
    verdicts, and refuses planes the kernel does not take."""
    rng = np.random.default_rng(6)
    n = 40
    capacity = rng.integers(1000, 9000, (n, 4))
    used = capacity - rng.integers(0, 700, (n, 4))
    rows = rng.choice(n, 25, replace=False)
    deltas = list(rng.integers(-300, 400, (25, 4)))
    ds = tmirror.DeviceState(0, 64, capacity, np.ones((n, 2)), used, device="cpu")
    planes = ds.arrays()
    got = tapply.dense_verify(planes, rows, deltas)
    padded, lanes = tapply.verify_lanes(rows, deltas)
    want = np.asarray(jk._verify_rows_jit(planes[0].numpy(), planes[2].numpy(), padded, lanes))
    np.testing.assert_array_equal(got, want[:25])
    assert got.any() and not got.all()
    with pytest.raises(TypeError):
        tapply.dense_verify((planes[0], planes[1], planes[2].long()), rows, deltas)


def test_dense_verify_flags_exactly_the_rows_over_capacity():
    capacity = torch.full((20, 4), 1000, dtype=torch.int32)
    used = torch.full((20, 4), 400, dtype=torch.int32)
    rows = np.array([0, 3, 9, 12, 19])
    deltas = np.full((5, 4), 600, np.int64)  # used + delta == capacity: fits
    deltas[1, 2] = 601
    deltas[4, 0] = 601
    fits = tapply.dense_verify((capacity, None, used), rows, list(deltas))
    np.testing.assert_array_equal(fits, [True, False, True, True, False])
    assert tapply.dense_verify((capacity, None, used), [], []).shape == (0,)
    with pytest.raises(TypeError):
        tapply.dense_verify((capacity.numpy(), None, used.numpy()), rows, list(deltas))


def _record_applier(monkeypatch):
    """Patch the JAX applier's device verify to record (capacity, used,
    padded rows, padded deltas, real row count, verdicts)."""
    calls, ks = [], []
    orig_verify, orig_bucket = jk.verify_rows, jmirror.DeviceState._row_bucket

    def bucket(n):
        ks.append(n)
        return orig_bucket(n)

    def verify(capacity, used, rows, deltas):
        fits = orig_verify(capacity, used, rows, deltas)
        calls.append(tuple(np.asarray(a) for a in (capacity, used, rows, deltas))
                     + (ks[-1], np.asarray(fits)))
        return fits

    monkeypatch.setattr(jk, "verify_rows", verify)
    monkeypatch.setattr(jmirror.DeviceState, "_row_bucket", staticmethod(bucket))
    return calls


@pytest.mark.parametrize("seed", [20260804, 11])
def test_replay_of_the_applier_verify(seed, monkeypatch):
    calls = _record_applier(monkeypatch)
    setup = tpa.TestDeviceVerifyParity()
    rng = random.Random(seed)
    state, nodes, preloaded = setup._cluster(rng)
    planner = Planner(state)
    mirror = tpa._mirror_for(state)
    planner.mirror_fn = lambda: mirror
    planner.device_verify_min = 1
    snap = state.snapshot()
    try:
        for _ in range(24):
            setup._device_result(planner, snap, setup._seeded_plan(rng, nodes, preloaded))
    finally:
        mirror.close()
    assert len(calls) >= 20

    padded = []
    monkeypatch.setattr(tk, "verify_rows", lambda *a: padded.append(a) or tk.verify_rows_ref(*a))
    n_false = 0
    for capacity, used, rows, deltas, k, want in calls:
        planes = (torch.tensor(capacity), None, torch.tensor(used))
        got = tapply.dense_verify(planes, rows[:k], list(deltas[:k]))
        _, _, prow, pdelta = padded[-1]
        np.testing.assert_array_equal(prow.numpy(), rows)
        np.testing.assert_array_equal(pdelta.numpy(), deltas)
        np.testing.assert_array_equal(got, want[:k])
        n_false += int((~want[:k]).sum())
    assert n_false > 0  # the replay holds failing rows too
