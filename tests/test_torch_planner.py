"""The slice as a whole: real ``tpu-batch`` evals replayed through the port.

The JAX ``tpu-batch`` scheduler plans the shapes of tests/test_tpu_parity.py
(and a device job, whose free instances ride as a 5th resource column)
under the deterministic flavor, with the small-eval oracle gate off so
every eval reaches a planner. Each planner call it makes is recorded and
replayed through the port's wrapper, which must return the same
placements. A second run of the same eval under ``EXACT_ONLY`` records the
unpermuted columnar planes; ``planner.plan_eval`` on those must pick the
planner the scheduler picked and return the same placements.

Each eval also runs with the wavefront stanza on (the exact scan's evals
go to the wavefront planner) and with paging on under a budget below two
tiles (the windowed evals go to the paged planner), in both packages.
"""

import jax
import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

import test_tpu_devices as devices
import test_tpu_parity as parity
from nomad_tpu.structs.model import (
    Affinity,
    Constraint,
    NetworkResource,
    Port,
    Spread,
    SpreadTarget,
)
from nomad_tpu.structs import compute_class
from nomad_tpu.state import planes as state_planes
from nomad_tpu.tpu import batch_sched
from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import paging as jpaging
from nomad_tpu.tpu import wavefront as jwf
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import paging as tpaging
from nomad_tpu_torch.tpu import planner, problems
from nomad_tpu_torch.tpu import wavefront as twf

STANZAS = (jwf, twf, jpaging, tpaging)


@pytest.fixture(autouse=True)
def _stanzas_reset():
    # the JAX paging stanza's tile_nodes also sets the planes' tile rows
    tile_rows = state_planes.TILE_ROWS
    for m in STANZAS:
        m.reset()
    yield
    for m in STANZAS:
        m.reset()
    state_planes.TILE_ROWS = tile_rows


def _route(route, monkeypatch):
    """Turn a stanza on in both packages: ``wavefront``, or ``paged`` with a
    budget below two 64-row tiles, so every windowed eval pages."""
    if route == "wavefront":
        for m in (jwf, twf):
            m.configure(enabled=True)
    elif route == "paged":
        for m in (jpaging, tpaging):
            m.configure(enabled=True, tile_nodes=64)
            monkeypatch.setattr(m, "budget_mb", lambda: 0)


def _dcs_spread(n):
    def mutate(job):
        job.datacenters = [f"dc{i}" for i in range(1, n + 1)]
        job.spreads = [Spread(
            attribute="${node.datacenter}", weight=100,
            spread_target=[SpreadTarget(value=f"dc{i}", percent=100 // n) for i in range(1, n + 1)],
        )]
    return mutate


def _even_spread(n):
    def mutate(job):
        job.datacenters = [f"dc{i}" for i in range(1, n + 1)]
        job.spreads = [Spread(attribute="${node.datacenter}", weight=100)]
    return mutate


def _ssd_affinity(job):
    job.affinities = [Affinity(l_target="${meta.ssd}", r_target="true", operand="=", weight=50)]


def _ssd_nodes(n, first):
    nodes = parity.build_cluster(n)
    for i, node in enumerate(nodes):
        node.meta["ssd"] = "true" if i < first else "false"
    return nodes


def _rack_nodes(n):
    nodes = parity.build_cluster(n)
    for i, node in enumerate(nodes):
        node.attributes["rack_class"] = "a" if i % 2 == 0 else "b"
        compute_class(node)
    return nodes


def _rack_constraint(job):
    job.constraints.append(Constraint(l_target="${attr.rack_class}", r_target="a", operand="="))


def _ports(job):
    job.task_groups[0].tasks[0].resources.networks = [
        NetworkResource(mbits=10, dynamic_ports=[Port(label="http"), Port(label="admin")])
    ]


def _dcs(n):
    return tuple(f"dc{i}" for i in range(1, n + 1))


#: name -> (nodes, job) of one eval
SHAPES = {
    "binpack": lambda: (parity.build_cluster(20), parity.make_job(15)),
    "constraints": lambda: (_rack_nodes(20), parity.make_job(8, _rack_constraint)),
    "affinity": lambda: (_ssd_nodes(16, 4), parity.make_job(10, _ssd_affinity)),
    "spread_targets": lambda: (parity.build_cluster(12, dcs=_dcs(2)), parity.make_job(8, _dcs_spread(2))),
    "even_spread": lambda: (parity.build_cluster(12, dcs=_dcs(3)), parity.make_job(9, _even_spread(3))),
    "exhaustion": lambda: (parity.build_cluster(2), parity.make_job(40)),
    "dynamic_ports": lambda: (parity.build_cluster(24), parity.make_job(40, _ports)),
    "runs_spread": lambda: (parity.build_cluster(40, dcs=_dcs(4)), parity.make_job(120, _dcs_spread(4))),
    "runs_even_spread": lambda: (parity.build_cluster(30, dcs=_dcs(3)), parity.make_job(90, _even_spread(3))),
    "runs_affinity": lambda: (_ssd_nodes(50, 10), parity.make_job(100, _ssd_affinity)),
    "devices": lambda: (devices.build_nodes(16), devices.device_job(12)),
}


def _host(x):
    return np.asarray(x) if hasattr(x, "shape") else x


def _record(monkeypatch, exact_only: bool) -> list:
    """Patch the JAX planner wrappers to record (planner, args, output)."""
    calls = []

    def recorder(name, orig):
        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            calls.append((name, jax.tree_util.tree_map(_host, args), jax.tree_util.tree_map(_host, out)))
            return out
        return wrapper

    for name in ("plan_batch", "plan_batch_runs", "plan_batch_windowed"):
        monkeypatch.setattr(jk, name, recorder(name, getattr(jk, name)))
    monkeypatch.setattr(jwf, "plan_batch_wavefront", recorder("plan_batch_wavefront",
                                                              jwf.plan_batch_wavefront))
    monkeypatch.setattr(jpaging, "plan_batch_paged", recorder("plan_batch_paged",
                                                              jpaging.plan_batch_paged))
    monkeypatch.setattr(batch_sched, "SMALL_EVAL_ORACLE_MAX", 0)
    monkeypatch.setattr(batch_sched, "EXACT_ONLY", exact_only)
    return calls


def _plan(shape, monkeypatch, exact_only: bool, route: str):
    nodes, job = SHAPES[shape]()
    _route(route, monkeypatch)
    calls = _record(monkeypatch, exact_only)
    with jk.deterministic_scope():
        if shape == "devices":
            devices.run("tpu-batch", job, nodes)
        else:
            parity.run(nodes, job, "tpu-batch")
    return calls


def _cpu(obj):
    return tk.from_numpy(obj, "cpu")


MODE_OF = {"plan_batch": "exact-scan", "plan_batch_runs": "runs", "plan_batch_windowed": "windowed",
           "plan_batch_wavefront": "wavefront", "plan_batch_paged": "paged"}
#: the mode each stanza puts in a planner's place
ROUTED = {"flat": {}, "wavefront": {"exact-scan": "wavefront"}, "paged": {"windowed": "paged"}}
#: the planner the scheduler picks for each shape (every planner is covered)
EXPECTED_MODE = {
    "affinity": "exact-scan", "even_spread": "exact-scan", "exhaustion": "exact-scan",
    "spread_targets": "exact-scan", "binpack": "windowed", "constraints": "windowed",
    "devices": "windowed", "dynamic_ports": "windowed", "runs_affinity": "runs",
    "runs_even_spread": "runs", "runs_spread": "runs",
}


@pytest.mark.parametrize("route", sorted(ROUTED))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_recorded_evals_replay_through_the_port(shape, route, monkeypatch):
    calls = _plan(shape, monkeypatch, exact_only=False, route=route)
    assert len(calls) == 1, f"expected one planner call, got {[c[0] for c in calls]}"
    name, args, out = calls[0]
    mode = ROUTED[route].get(EXPECTED_MODE[shape], EXPECTED_MODE[shape])
    assert MODE_OF[name] == mode
    if name == "plan_batch_wavefront":
        bargs, init, n_real = args
        want_state, want, want_rounds = out
        got_state, got, rounds = twf.plan_batch_wavefront(_cpu(bargs), _cpu(init), n_real)
        for g, w in zip(got_state, want_state):
            np.testing.assert_array_equal(g.numpy(), w)
        assert rounds == int(want_rounds)
    elif name == "plan_batch_paged":
        want, want_rounds, want_stats = out
        got, rounds, stats = tpaging.plan_batch_paged(*args, device="cpu")
        got = torch.from_numpy(got)
        assert rounds == want_rounds and stats == want_stats
        assert stats["budget_raised"]
    elif name == "plan_batch":
        bargs, init, n_real = args
        want_state, want = out
        got_state, got = tk.plan_batch(_cpu(bargs), _cpu(init), n_real)
        for g, w in zip(got_state, want_state):
            np.testing.assert_array_equal(g.numpy(), w)
    elif name == "plan_batch_runs":
        rargs, rinit, a_pad, even = args
        want = out
        got, _ = tk.plan_batch_runs(_cpu(rargs), _cpu(rinit), a_pad, even)
    else:
        wargs, used0, coll0, n_real, a_pad = args
        want = out
        got, _ = tk.plan_batch_windowed(_cpu(wargs), *_cpu((used0, coll0)), n_real, a_pad)
    np.testing.assert_array_equal(got.numpy(), want)

    # the same eval's unpermuted planes, through the port's entry point
    monkeypatch.undo()
    exact_calls = _plan(shape, monkeypatch, exact_only=True, route=route)
    (_, (bargs, init, n_real), _), = exact_calls
    planes = problems.eval_planes(bargs._asdict(), init._asdict(), n_real)
    placements, stats = planner.plan_eval(planes, device="cpu")
    assert stats["mode"] == MODE_OF[name]
    assert stats["launches"] == 0
    if name == "plan_batch_paged":
        assert stats["tiles"] == want_stats["tiles"] and stats["tile_nodes"] == 64
    np.testing.assert_array_equal(placements, np.asarray(want)[: planes["a_real"]])


def test_plan_eval_pads_like_the_scheduler():
    c = problems.build_cluster(90, 70, seed=1)
    planes = problems.eval_planes(*problems.exact_problem(c))
    p = planner.pad_planes(planes)
    assert p["capacity"].shape == (128, 4) and p["demands"].shape == (128, 4)
    assert (p["used0"][90:] == 2**30).all() and not p["feasible"][:, 90:].any()
    np.testing.assert_array_equal(p["perm"][0, 90:], np.arange(90, 128))
    assert not p["valid"][70:].any()
    assert planner.choose_mode(p) == "runs"
    planes["spread_active"][:] = False
    planes["limits"][:] = 10
    assert planner.choose_mode(planner.pad_planes(planes)) == "windowed"
    planes["a_real"] = 0
    assert planner.choose_mode(planner.pad_planes(planes)) == "exact-scan"
