"""The port's device ledger against the JAX package's, on the CPU.

The same call sequence goes through both packages, with inputs from the
port's ``problems.py`` copies: a ``DeviceState`` upload of a 1,000-node
cluster and its refresh scatter, a 4-eval drain batch over those device
planes, a wavefront plan and a paged plan in 1,024-row tiles. The
transfer, tile and round counters must then read the same on both sides.
The compile keys (``compiles``, ``compile_s``) are left out of the
comparison: the JAX package times XLA compiles, the port the first
launch of each plain version, and seconds never agree.
"""

import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu.debug import devprof as jdevprof
from nomad_tpu.state import planes as state_planes
from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import paging as jpaging
from nomad_tpu.tpu import wavefront as jwf
from nomad_tpu_torch.debug import devprof as tdevprof
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import paging as tpaging
from nomad_tpu_torch.tpu import problems
from nomad_tpu_torch.tpu import wavefront as twf
from test_torch_drain import _jax_batch, _port_batch

#: the counters that must agree; the compile keys time different things
COMPILE_KEYS = ("compiles", "compile_s")


@pytest.fixture(autouse=True)
def _ledgers_reset():
    tile_rows = state_planes.TILE_ROWS
    for m in (jwf, twf, jpaging, tpaging, jdevprof, tdevprof):
        m.reset()
    prior = (jdevprof.enable(True), tdevprof.enable(True))
    yield
    jdevprof.enable(prior[0])
    tdevprof.enable(prior[1])
    for m in (jwf, twf, jpaging, tpaging, jdevprof, tdevprof):
        m.reset()
    state_planes.TILE_ROWS = tile_rows


def _drain_case():
    return problems.drain_problem(problems.build_cluster(1000, 1, seed=5), 4, "drain-bench",
                                  seed=5)


def _wavefront_case():
    args, init = problems.wavefront_problem(problems.build_cluster(256, 96, seed=3), n_groups=6)
    return args, init, 256, 80  # n_real, real placements asked for


def _paged_case():
    return problems.paged_case(7, 3000, 400, limit=4)


def _jax_sequence(monkeypatch):
    """The sequence through the JAX package; returns its placements."""
    shared, preps = _drain_case()
    drain = _jax_batch(shared, preps, pad_evals=4, route="device-state")
    args, init, n_real, n_valid = _wavefront_case()
    with jk.deterministic_scope():
        _, wf, _ = jwf.plan_batch_wavefront(
            jk.BatchArgs(*[np.asarray(args[f]) for f in jk.BatchArgs._fields]),
            jk.BatchState(*[np.asarray(init[f]) for f in jk.BatchState._fields]),
            n_real, n_valid=n_valid)
        monkeypatch.setattr(jpaging, "budget_mb", lambda: 0)
        jpaging.configure(enabled=True, tile_nodes=1024)
        paged, _, _ = jpaging.plan_batch_paged(*_paged_case())
    return drain, np.asarray(wf), paged


def _port_sequence(monkeypatch):
    shared, preps = _drain_case()
    drain, _ = _port_batch(shared, preps, pad_evals=4, route="device-state")
    args, init, n_real, n_valid = _wavefront_case()
    _, wf, _ = twf.plan_batch_wavefront(tk.from_numpy(args, "cpu"), tk.from_numpy(init, "cpu"),
                                        n_real, n_valid=n_valid)
    # the budget below two tiles makes the cache evict and upload again
    monkeypatch.setattr(tpaging, "budget_mb", lambda: 0)
    tpaging.configure(enabled=True, tile_nodes=1024)
    paged, _, _ = tpaging.plan_batch_paged(*_paged_case(), device="cpu")
    return drain, wf.numpy(), paged


def _counters(devprof) -> dict:
    return {k: v for k, v in devprof.totals().items() if k not in COMPILE_KEYS}


def test_ledger_counts_as_the_jax_ledger(monkeypatch):
    want = _jax_sequence(monkeypatch)
    got = _port_sequence(monkeypatch)
    # the same placements, so the counts describe the same work
    assert sorted(got[0]) == sorted(want[0])
    for eval_id, (placements, base) in want[0].items():
        np.testing.assert_array_equal(got[0][eval_id][0], placements)
        np.testing.assert_array_equal(got[0][eval_id][1], base)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])

    jt, tt = _counters(jdevprof), _counters(tdevprof)
    assert tt == jt
    assert tt["h2d_bytes"] > 0 and tt["d2h_bytes"] > 0 and tt["pending_rounds"] == 0
    assert tt["paged_tile_uploads"] > tt["paged_tile_reuploads"] > 0
    assert tdevprof.paged_totals() == jdevprof.paged_totals()
    rounds = tdevprof.rounds_snapshot()
    assert rounds == jdevprof.rounds_snapshot()
    assert set(rounds) == {"exact", "wavefront", "paged"}
    # one step per padded lane against the real placements asked for
    assert rounds["exact"]["rounds"] >= rounds["exact"]["placements"] > 0
    for key in ("collective_rounds_per_placement", "rounds_per_placement", "h2d_mb", "d2h_mb",
                "paged_tile_upload_mb", "census_collective_ops", "sharded_dispatches"):
        assert tdevprof.summary()[key] == jdevprof.summary()[key], key
    assert tdevprof.summary()["collective_rounds_per_placement"] is None  # one device

    # the launch ledger: every planner of the sequence, with no cost figures
    snap = tdevprof.snapshot()
    planners = {e["planner"] for e in snap["compile_ledger"]}
    assert planners == {"exact", "wavefront", "paged"}
    for e in snap["compile_ledger"]:
        assert e["flavor"] == "plain" and not e["sharded"] and e["compiles"] == 1
        assert e["flops"] == -1.0 and e["bytes_accessed"] is None
        assert e["collectives"] == {} and e["collective_ops"] == 0
    for planner in planners:
        assert "kernel_flops" not in tdevprof.dispatch_tags(planner)
        assert "kernel_bytes" not in tdevprof.dispatch_tags(planner)
    report = tdevprof.format_report(snap)
    assert "collective_rounds_per_placement: None" in report
    for planner in planners:
        assert f"\n{planner:<12} " in report
    assert f"h2d: {tdevprof.summary()['h2d_mb']} MB" in report


def test_disabled_ledger_counts_nothing(monkeypatch):
    jdevprof.enable(False)
    tdevprof.enable(False)
    _jax_sequence(monkeypatch)
    _port_sequence(monkeypatch)
    for devprof in (jdevprof, tdevprof):
        totals = devprof.totals()
        assert all(v == 0 for v in totals.values()), totals
        assert devprof.rounds_snapshot() == {}
        assert devprof.snapshot()["compile_ledger"] == []
        assert devprof.summary()["enabled"] is False


def test_rounds_on_the_cpu_fold_at_once():
    """A round count handed over on the CPU (an int or a CPU tensor) folds
    in without queueing; with devprof on, the exact scan charges one round
    per lane against its ``n_valid``."""
    tdevprof.count_rounds("runs", torch.tensor(7, dtype=torch.int32), 21, False)
    tdevprof.count_rounds("runs", 3, torch.tensor(9), False)
    assert tdevprof.totals()["pending_rounds"] == 0
    assert tdevprof.rounds_snapshot()["runs"] == dict(
        dispatches=2, rounds=10, placements=30, sharded_dispatches=0, sharded_rounds=0,
        sharded_placements=0)


def test_warm_up_launches_enter_the_ledger_and_move_no_counter():
    args, init, n_real, n_valid = _wavefront_case()
    with tdevprof.warming():
        tk.plan_batch(tk.from_numpy(args, "cpu"), tk.from_numpy(init, "cpu"), n_real,
                      n_valid=n_valid)
    assert tdevprof.rounds_snapshot() == {}
    assert [e["planner"] for e in tdevprof.snapshot()["compile_ledger"]] == ["exact"]
    tk.plan_batch(tk.from_numpy(args, "cpu"), tk.from_numpy(init, "cpu"), n_real,
                  n_valid=n_valid)
    assert tdevprof.rounds_snapshot()["exact"]["placements"] == n_valid
    # the second launch at that shape is no compile event
    assert tdevprof.summary()["compiles"] == 1
    # reset() zeroes the ledger but not what the process has launched
    size = tdevprof.compile_cache_size()
    tdevprof.reset()
    assert tdevprof.compile_cache_size() == size >= 1
