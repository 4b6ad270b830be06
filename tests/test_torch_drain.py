"""The port's fused drain batch against the JAX package's, on the CPU.

Inputs are numpy from a seed (``problems.drain_problem``). The JAX side
runs under ``deterministic_scope()``; the port runs with ``device="cpu"``
(its plain versions). Placements and usage bases are integers, so every
comparison is exact.
"""

import dataclasses
import random
import threading
import time

import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

import nomad_tpu.mock as mock
from nomad_tpu.core.overload import DeadlineExceeded as JaxDeadlineExceeded
from nomad_tpu.scheduler import Harness
from nomad_tpu.structs.model import Evaluation
from nomad_tpu.tpu import columnar as jcol
from nomad_tpu.tpu import drain as jdrain
from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import mirror as jmirror
from nomad_tpu.tpu import wavefront as jwf
from nomad_tpu.tpu.batch_sched import TPUBatchScheduler
from nomad_tpu_torch.tpu import drain as tdrain
from nomad_tpu_torch.tpu import mirror as tmirror
from nomad_tpu_torch.tpu import problems
from nomad_tpu_torch.tpu import wavefront as twf
from test_drain import simple_job


@pytest.fixture(autouse=True)
def _wavefront_reset():
    for m in (jwf, twf):
        m.reset()
    yield
    for m in (jwf, twf):
        m.reset()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# K9: the per-eval usage bases
# ---------------------------------------------------------------------------

def _bases_case(E):
    """Random lanes over E evals (eval 1 has none when E > 1), with
    unplaced lanes, lanes on pad nodes and many lanes on one node."""
    rng = np.random.default_rng(40 + E)
    N, n_real, A, C = 64, 50, 96, 4
    used0 = rng.integers(0, 5000, (N, C)).astype(np.int32)
    used0[n_real:] = 2**30
    placements = rng.integers(0, N, A).astype(np.int32)
    placements[::7] = -1
    placements[3:12] = 5  # several lanes on one node
    eval_of = rng.integers(0, E, A).astype(np.int32)
    if E > 1:
        eval_of[eval_of == 1] = 0
    demands = rng.integers(0, 900, (A, C)).astype(np.int32)
    return used0, placements, demands, eval_of, n_real


@pytest.mark.parametrize("E", [1, 4])
def test_used_bases_match_jax(E):
    used0, placements, demands, eval_of, n_real = _bases_case(E)
    assert (placements >= n_real).any() and (placements < 0).any()
    want = np.asarray(jdrain._used_bases_fn()(used0, placements, demands, eval_of, E, n_real))
    got = tdrain.used_bases(*(torch.from_numpy(a) for a in (used0, placements, demands, eval_of)),
                            E, n_real)
    assert got.dtype == torch.int32 and got.shape == (E, 64, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[:, n_real:] == 2**30).all()


def _bases_edge(kind):
    """(used0, placements, demands, eval_of, E, n_real) at an edge the
    kernel must take: C 2 or 5, no lane, every lane on one node, the
    lanes' evals out of order."""
    rng = np.random.default_rng(60)
    E, N, n_real, A, C = 6, 40, 33, 120, 4
    if kind in ("C2", "C5"):
        C = int(kind[1])
    if kind == "A0":
        A = 0
    used0 = rng.integers(0, 5000, (N, C)).astype(np.int32)
    used0[n_real:] = 2**30
    placements = rng.integers(-1, N, A).astype(np.int32)
    eval_of = np.sort(rng.integers(0, E, A)).astype(np.int32)
    if kind == "one_node":
        placements[:] = 7
    if kind == "out_of_order":
        eval_of = eval_of[::-1].copy()
        rng.shuffle(eval_of)
    demands = rng.integers(0, 900, (A, C)).astype(np.int32)
    return used0, placements, demands, eval_of, E, n_real


@pytest.mark.parametrize("kind", ["C2", "C5", "A0", "one_node", "out_of_order"])
def test_used_bases_edges_match_jax(kind):
    used0, placements, demands, eval_of, E, n_real = _bases_edge(kind)
    want = np.asarray(jdrain._used_bases_fn()(used0, placements, demands, eval_of, E, n_real))
    got = tdrain.used_bases(*(torch.from_numpy(a) for a in (used0, placements, demands, eval_of)),
                            E, n_real)
    assert got.dtype == torch.int32 and got.shape == (E,) + used0.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _bad_bases(case):
    """The wrapper's arguments with one thing the kernel does not take,
    and the error the wrapper raises for it."""
    used0, placements, demands, eval_of, n_real = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in _bases_case(4))
    args = dict(used0=used0, placements=placements, demands=demands, eval_of=eval_of, E=4,
                n_real=n_real)
    if case == "eval_of int64":
        return dict(args, eval_of=eval_of.long()), TypeError
    if case == "demands width":
        return dict(args, demands=torch.cat([demands, demands[:, :1]], 1)), ValueError
    if case == "eval_of length":
        return dict(args, eval_of=eval_of[1:]), ValueError
    if case == "used0 flat":
        return dict(args, used0=used0.reshape(-1)), ValueError
    if case == "demands int64":
        return dict(args, demands=demands.long()), TypeError
    if case == "n_real":
        return dict(args, n_real=used0.shape[0] + 1), ValueError
    if case == "placements int64":
        return dict(args, placements=placements.long()), TypeError
    if case == "placements length":
        return dict(args, placements=torch.cat([placements, placements[:1]])), ValueError
    if case == "placements elsewhere":
        return dict(args, placements=placements.to("meta")), ValueError
    assert case == "placements strided"
    return dict(args, placements=torch.stack([placements, placements], 1)[:, 0]), ValueError


BAD_BASES = ["eval_of int64", "demands width", "eval_of length", "used0 flat", "demands int64",
             "n_real", "placements int64", "placements length", "placements elsewhere",
             "placements strided"]


@pytest.mark.parametrize("case", BAD_BASES)
def test_used_bases_refuses_what_the_kernel_does_not_take(case):
    """The wrapper checks what the kernel takes on the CPU as on the card."""
    args, error = _bad_bases(case)
    with pytest.raises(error):
        tdrain.used_bases(**args)


# ---------------------------------------------------------------------------
# the fused batch against the JAX collector
# ---------------------------------------------------------------------------

class _JaxShared:
    """What the JAX collector reads of its shared cluster; ``mirror`` hands
    out a JAX ``DeviceState``'s planes, or is None (the host upload)."""

    def __init__(self, shared, device_state=None):
        self.nodes = list(range(shared["n_real"]))
        self.gen = object()
        self.mirror = None if device_state is None else _JaxMirror(device_state)
        self.capacity = shared["capacity"]
        self.usable = shared["usable"]
        self.used0 = shared["used0"]


class _JaxMirror:
    def __init__(self, device_state):
        self.device_state_ = device_state
        self.calls = 0

    def device_state(self, n_pad, gen, mesh=None):
        assert n_pad == self.device_state_.n_pad and mesh is None
        self.calls += 1
        return self.device_state_.arrays()


def _device_state(module, shared, **kwargs):
    """A ``DeviceState`` of ``module`` (the JAX one or the port's) made at
    the reserved usage alone and brought to ``used0`` by a refresh of the
    rows that differ, as the server keeps it."""
    n = shared["n_real"]
    stale = np.zeros_like(shared["used0"])
    ds = module.DeviceState(0, problems.bucket(n), shared["capacity"], shared["usable"], stale,
                            **kwargs)
    ds.pending.update(int(r) for r in np.flatnonzero((shared["used0"] != stale).any(axis=1)))
    assert ds.pending
    ds.refresh(shared["used0"])
    return ds


def _jax_prep(d):
    return jdrain.DrainPrep(**{**d, "planes_list": [jcol.GroupPlanes(**g) for g in d["planes_list"]]})


#: seconds a collector here waits for its batch, and a drive for all its
#: threads: a healthy batch of these tests takes about 2 s on the CPU, so a
#: stuck one fails in seconds instead of holding the run for minutes
COLLECT_S = 20.0
DRIVE_S = 30.0


def _drive(collector, preps, make, leave=()):
    """One thread per eval: ``submit`` (or ``leave`` for ids in ``leave``);
    returns eval id -> (placements, base) as numpy, or the exception. All
    the threads share one deadline."""
    out = {}

    def one(d):
        if d["eval_id"] in leave:
            collector.leave(d["eval_id"])
            return
        try:
            placements, base = collector.submit(make(d))
            out[d["eval_id"]] = (_np(placements), _np(base))
        except Exception as e:  # compared below: both sides must raise alike
            out[d["eval_id"]] = e

    threads = [threading.Thread(target=one, args=(d,), daemon=True) for d in preps]
    for t in threads:
        t.start()
    deadline = time.monotonic() + DRIVE_S
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), f"a drain batch took over {DRIVE_S} s"
    return out


def _port_batch(shared, preps, pad_evals, leave=(), route="host"):
    ds = _device_state(tmirror, shared, device="cpu") if route == "device-state" else None
    collector = tdrain.KernelBatchCollector(
        tdrain.SharedCluster(shared["capacity"], shared["usable"], shared["used0"], ds),
        expected=len(preps), timeout=COLLECT_S, pad_evals=pad_evals, device="cpu",
    )
    out = _drive(collector, preps, tdrain.DrainPrep.from_dict, leave)
    return out, collector


def _jax_batch(shared, preps, pad_evals, leave=(), route="host"):
    ds = _device_state(jmirror, shared) if route == "device-state" else None
    jshared = _JaxShared(shared, ds)
    collector = jdrain.KernelBatchCollector(jshared, expected=len(preps), timeout=COLLECT_S,
                                            pad_evals=pad_evals)
    with jk.deterministic_scope():
        out = _drive(collector, preps, _jax_prep, leave)
    assert ds is None or jshared.mirror.calls == 1
    return out


#: name -> (nodes, evals, drain shape, seed)
BATCHES = {
    "tenant": (200, 6, "drain-tenant", 1),
    "bench": (120, 5, "drain-bench", 2),
}


@pytest.mark.parametrize("planner", ["exact", "wavefront"])
@pytest.mark.parametrize("route", ["host", "device-state"])
@pytest.mark.parametrize("case", sorted(BATCHES))
def test_fused_batch_matches_jax_collector(case, route, planner):
    n_nodes, n_evals, shape, seed = BATCHES[case]
    # the wavefront stanza, in both packages, puts the wavefront planner in
    # the fused scan's place
    for m in (jwf, twf):
        m.configure(enabled=planner == "wavefront", max_round=8)
    shared, preps = problems.drain_problem(problems.build_cluster(n_nodes, 1, seed=seed),
                                           n_evals, shape, seed=seed)
    # arrival order is not priority order; one eval leaves, one expires
    preps = preps[::-1]
    preps[1]["deadline"] = 1
    leave = {preps[2]["eval_id"]}
    priorities = [d["priority"] for d in preps]
    assert priorities != sorted(priorities, reverse=True)
    if shape == "drain-tenant":
        assert any("node_value" in g for d in preps for g in d["planes_list"])
    pad_evals = 8
    want = _jax_batch(shared, preps, pad_evals, leave, route)
    before = dict(tdrain.DRAIN_COUNTERS)
    got, collector = _port_batch(shared, preps, pad_evals, leave, route)
    assert collector.invocations == 1
    assert tdrain.DRAIN_COUNTERS == dict(batches=before["batches"] + 1,
                                         evals=before["evals"] + n_evals - 2)
    assert tdrain.LAST_DRAIN_STATS["n_evals"] == n_evals - 2
    assert tdrain.LAST_DRAIN_STATS["device_state"] == (route == "device-state")
    assert tdrain.LAST_DRAIN_STATS["planner"] == planner
    E, G, A, N, V = tdrain.LAST_DRAIN_STATS["padded"]
    rounds = int(tdrain.LAST_DRAIN_STATS["rounds"])
    assert rounds == A if planner == "exact" else 0 < rounds < A
    assert N > n_nodes and E == pad_evals > n_evals
    assert sorted(got) == sorted(want) and len(got) == n_evals - 1
    for eval_id, w in want.items():
        g = got[eval_id]
        if isinstance(w, Exception):
            assert isinstance(w, JaxDeadlineExceeded)
            assert isinstance(g, tdrain.DeadlineExceeded) and g.where == "drain"
            continue
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert (g[0] >= 0).any()


def test_fused_batch_equals_solo_scans():
    """Each eval's fused placements are its solo exact scan started from
    its usage base; the bases thread every earlier eval's grants."""
    shared, preps = problems.drain_problem(problems.build_cluster(160, 1, seed=4), 5,
                                           "drain-tenant", seed=4)
    got, _ = _port_batch(shared, preps, pad_evals=5)
    order = sorted(preps, key=lambda d: (-d["priority"], d["create_index"], d["eval_id"]))
    cap, usable, used0 = tdrain.host_planes(tdrain.SharedCluster(
        shared["capacity"], shared["usable"], shared["used0"]), 256)
    np.testing.assert_array_equal(got[order[0]["eval_id"]][1], used0)
    running = used0.astype(np.int64)
    for d in order:
        placements, base = got[d["eval_id"]]
        np.testing.assert_array_equal(base, running)
        prep = tdrain.DrainPrep.from_dict(d)
        solo = tdrain.solo_scan(prep, (cap, usable, base), 160, device="cpu")
        np.testing.assert_array_equal(solo.numpy(), placements)
        placed = placements >= 0
        np.add.at(running, placements[placed], prep.g_demand[prep.gid_real][placed])
    assert (running[:160] <= shared["capacity"]).all()


def test_failed_batch_raises_in_every_thread(monkeypatch):
    shared, preps = problems.drain_problem(problems.build_cluster(40, 1), 3)

    def boom(*args, **kwargs):
        raise RuntimeError("scan failed")

    monkeypatch.setattr(tdrain.kernel, "plan_batch", boom)
    got, _ = _port_batch(shared, preps, pad_evals=3)
    assert all(isinstance(e, RuntimeError) and "scan failed" in str(e) for e in got.values())
    assert len(got) == 3


# ---------------------------------------------------------------------------
# a batch recorded from the real tpu-batch scheduler
# ---------------------------------------------------------------------------

def _scheduler_batch(monkeypatch):
    """The setup of tests/test_drain.py::test_fused_batch_matches_sequential_solo
    through the JAX collector, recording each batch it runs: the parked
    preps, the shared planes and the resulting placements and bases."""
    recorded = []
    orig = jdrain.KernelBatchCollector._run

    def record(self, parked):
        orig(self, parked)
        recorded.append(dict(
            preps=[p.prep for p in parked],
            shared=(self.shared.capacity, self.shared.usable, self.shared.used0),
            n_real=len(self.shared.nodes),
            pad_evals=self.pad_evals,
            out={p.prep.eval_id: (np.asarray(p.placements), np.asarray(p.used0)) for p in parked},
        ))

    monkeypatch.setattr(jdrain.KernelBatchCollector, "_run", record)
    rng = random.Random(17)
    nodes = []
    for _ in range(8):
        n = mock.node()
        n.node_resources.cpu.cpu_shares = rng.choice([2000, 4000])
        n.node_resources.memory.memory_mb = 8192
        n.node_resources.networks = []
        nodes.append(n)
    fused = Harness(seed=5)
    for n in nodes:
        fused.state.upsert_node(fused.next_index(), n)
    evs = []
    for job in (simple_job(count=5), simple_job(count=5)):
        fused.state.upsert_job(fused.next_index(), job)
        ev = Evaluation(
            id=f"ev-{job.id}", namespace=job.namespace, priority=job.priority,
            type="service", triggered_by="job-register", job_id=job.id,
            status="pending", create_index=fused.next_index(),
        )
        fused.state.upsert_evals(fused.next_index(), [ev])
        evs.append(ev)
    snapshot = fused.state.snapshot()
    collector = jdrain.KernelBatchCollector(jdrain.SharedCluster(snapshot), expected=2)

    def run_one(ev):
        sched = TPUBatchScheduler(snapshot, fused, rng=random.Random(5))
        sched.drain_collector = collector
        try:
            sched.process(ev)
        finally:
            if not collector.consumed(ev.id):
                collector.leave(ev.id)

    with jk.deterministic_scope():
        threads = [threading.Thread(target=run_one, args=(ev,)) for ev in evs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return recorded


def test_replay_of_a_tpu_batch_drain(monkeypatch):
    recorded = _scheduler_batch(monkeypatch)
    assert len(recorded) == 1
    batch = recorded[0]
    assert len(batch["preps"]) == 2
    capacity, usable, used0 = batch["shared"]
    shared = dict(capacity=capacity, usable=usable, used0=used0, n_real=batch["n_real"])
    preps = [dataclasses.asdict(p) for p in batch["preps"]]
    got, _ = _port_batch(shared, preps, batch["pad_evals"])
    assert sorted(got) == sorted(batch["out"])
    for eval_id, (placements, base) in batch["out"].items():
        assert (placements >= 0).all()
        np.testing.assert_array_equal(got[eval_id][0], placements)
        np.testing.assert_array_equal(got[eval_id][1], base)
