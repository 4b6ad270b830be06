"""The port's load plane: ``nomad_tpu_torch.loadgen`` and
``nomad_tpu_torch.testing.invariants`` against the JAX package's.

Both packages run on the CPU and data crosses between them as plain
values (documents, report dicts, bytes):

- (a) the compiled op streams are byte-equal for the same scenario and
  seed (smoke, a small soak, the overload storm's three stages), and the
  grammar's node and job builders give equal documents;
- (b) the full invariant sweep, the incremental checker and the
  federation checker report the same violations on stores carried from
  the same documents, clean and with injected faults;
- (c) the grading and the three summary lines agree on the JAX package's
  own report artifacts;
- (d)-(f) the port's smoke storm, a tiny overload storm and a tiny
  in-process fan-out run end to end against a port server on the CPU;
- (g) the CLI prints the JAX CLI's stream bytes and its ``--federation``
  help, and ``operator keygen`` prints a key both packages' keyrings
  take.

Every test that starts a server or a driver stops it in ``finally`` (the
runners do), and a fixture checks after each test that no thread it
started is still alive within ``STOP_S`` (the process-wide timer wheels
of both packages excepted).
"""

import contextlib
import io
import json
import os
import threading
import time

import pytest

from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu import agent as jagent
from nomad_tpu.core import broker as jbroker
from nomad_tpu.loadgen import __main__ as jcli
from nomad_tpu.loadgen import fanout as jfanout
from nomad_tpu.loadgen import grammar as jg
from nomad_tpu.loadgen import overload as joverload
from nomad_tpu.loadgen import scenarios as jsc
from nomad_tpu.loadgen import score as jscore
from nomad_tpu.structs import model as jmodel
from nomad_tpu.testing import invariants as jinv
from nomad_tpu_torch import agent as tagent
from nomad_tpu_torch.core import broker as tbroker
from nomad_tpu_torch.loadgen import __main__ as tcli
from nomad_tpu_torch.loadgen import fanout as tfanout
from nomad_tpu_torch.loadgen import federation as tfederation
from nomad_tpu_torch.loadgen import grammar as tg
from nomad_tpu_torch.loadgen import overload as toverload
from nomad_tpu_torch.loadgen import scenarios as tsc
from nomad_tpu_torch.loadgen import score as tscore
from nomad_tpu_torch.state.carry import carry_state
from nomad_tpu_torch.structs import model as tmodel
from nomad_tpu_torch.testing import invariants as tinv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a stopped storm's threads get to end
STOP_S = 10.0
#: the small soak's knobs (a 64-node fleet, about 2,000 allocs, 5 s of churn)
SMALL_SOAK = {"SOAK_NODES": "64", "SOAK_ALLOCS": "2000", "SOAK_CHURN_S": "5"}


def _wheel_threads() -> set:
    return {w._thread for w in (jbroker.shared_timer_wheel(), tbroker.shared_timer_wheel())}


@pytest.fixture(autouse=True)
def _threads_end():
    """After each test, every thread it started (the process-wide timer
    wheels excepted) has ended within ``STOP_S``."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + STOP_S
    while True:
        left = [t for t in threading.enumerate()
                if t not in before and t not in _wheel_threads() and t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, f"threads still alive {STOP_S} s after the test: {[t.name for t in left]}"


# ---------------------------------------------------------------------------
# (a) the op streams and the spec builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 7, 20260803])
def test_smoke_streams_are_byte_equal(seed):
    want = jg.compile_stream(jsc.smoke(), seed).encode()
    got = tg.compile_stream(tsc.smoke(), seed).encode()
    assert got == want


def test_small_soak_streams_are_byte_equal(monkeypatch):
    for k, v in SMALL_SOAK.items():
        monkeypatch.setenv(k, v)
    jscn, tscn = jsc.soak(), tsc.soak()
    assert tscn.server_config == jscn.server_config and tscn.slos == jscn.slos
    for seed in (1, 7):
        want = jg.compile_stream(jscn, seed)
        got = tg.compile_stream(tscn, seed)
        assert got.encode() == want.encode()
        assert got.counts() == want.counts() and got.counts()["node.register"] >= 64


class _Stop(Exception):
    """Raised by the stand-in agent: the stages are built, nothing starts."""


def _overload_stages(module, agent_module, monkeypatch, **kwargs) -> list:
    """The overload storm's three stage scenarios as ``run_overload`` builds
    them, stopped at the agent's construction."""
    stages = []
    real = module._stage

    def stage(name, phases, server_config):
        scn = real(name, phases, server_config)
        stages.append(scn)
        return scn

    def no_agent(*args, **kw):
        raise _Stop

    monkeypatch.setattr(module, "_stage", stage)
    monkeypatch.setattr(agent_module, "ServerAgent", no_agent)
    with pytest.raises(_Stop):
        module.run_overload(seed=1, **kwargs)
    return stages


def test_overload_stage_streams_are_byte_equal(monkeypatch):
    monkeypatch.setenv("OVERLOAD_NODES", "8")
    want = _overload_stages(joverload, jagent, monkeypatch)
    got = _overload_stages(toverload, tagent, monkeypatch, device="cpu")
    assert [s.name for s in got] == [s.name for s in want] == [
        "overload_capacity", "overload_burst", "overload_recovery"]
    for gs, ws in zip(got, want):
        assert gs.server_config == ws.server_config
        for seed in (1, 7):
            assert tg.compile_stream(gs, seed).encode() == jg.compile_stream(ws, seed).encode()


def _strip(doc):
    """A document without the ids and times each mock call mints afresh."""
    fresh = ("secret_id", "create_time", "modify_time", "status_updated_at", "submit_time")
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in fresh}
    if isinstance(doc, list):
        return [_strip(x) for x in doc]
    return doc


def test_spec_builders_give_equal_documents():
    for slot in (0, 1, 17, 9_999):
        assert _strip(tg.build_node(slot).to_dict()) == _strip(jg.build_node(slot).to_dict())
    assert (tg.build_node(3, ("dc3",), {"cpu": 500, "memory_mb": 256}).to_dict()["node_class"]
            == jg.build_node(3, ("dc3",), {"cpu": 500, "memory_mb": 256}).to_dict()["node_class"])
    stream = jg.compile_stream(jsc.smoke(), 7)
    specs = [op.args for op in stream.ops if op.kind in ("job.submit", "job.dispatch_register")]
    assert {a["category"] for a in specs} == {"svc", "bat", "dsp"}
    # an update rebuilds a job from its slot's args with the version bumped
    specs += [{**a, "version": 3, "priority": 70} for a in specs if a["category"] == "svc"][:2]
    for args in specs:
        want = jg.build_job(dict(args)).to_dict()
        got = tg.build_job(dict(args)).to_dict()
        assert _strip(got) == _strip(want)


# ---------------------------------------------------------------------------
# (b) the invariant checkers
# ---------------------------------------------------------------------------

_JKINDS = {"node": (jmodel.Node, False), "nodes": (jmodel.Node, True),
           "job": (jmodel.Job, False), "allocs": (jmodel.Allocation, True),
           "evals": (jmodel.Evaluation, True)}


def _jax_store(records):
    """The JAX package's store from the same records as ``carry_state``."""
    from nomad_tpu.state import StateStore

    store = StateStore()
    for index, kind, doc in records:
        cls, many = _JKINDS[kind]
        if kind == "nodes":
            store.upsert_nodes(index, [cls.from_dict(d) for d in doc])
        elif kind == "allocs":
            store.upsert_allocs(index, [cls.from_dict(d) for d in doc])
        elif kind == "evals":
            store.upsert_evals(index, [cls.from_dict(d) for d in doc])
        elif kind == "node":
            store.upsert_node(index, cls.from_dict(doc))
        else:
            store.upsert_job(index, cls.from_dict(doc))
    return store


def _alloc_doc(job_doc, node_doc, name, cpu=100, status="running"):
    """A live alloc of ``job_doc`` on ``node_doc`` asking ``cpu`` shares."""
    from nomad_tpu import mock as jmock

    a = jmock.alloc()
    a.job_id, a.namespace, a.node_id, a.name = job_doc["id"], job_doc["namespace"], \
        node_doc["id"], name
    a.job = jmodel.Job.from_dict(job_doc)
    a.task_group = "web"
    res = a.allocated_resources
    res.tasks = {"web": res.tasks["web"]}
    res.tasks["web"].cpu.cpu_shares = cpu
    res.tasks["web"].memory.memory_mb = 64
    res.tasks["web"].networks = []
    res.shared.disk_mb = 10
    res.shared.networks = []
    a.desired_status, a.client_status = "run", status
    return a.to_dict()


def _cluster_records(fault: str):
    """Records of a small cluster (8 nodes, a service job, its allocs and
    evals) with one fault injected: ``clean``, ``over`` (a node over its
    cpu), ``unknown_node`` (an alloc on a node never registered), ``twice``
    (one alloc name live twice), ``stuck`` (a pending eval) or ``stale``
    (handled by the caller: an index past the store's latest)."""
    names = [f"ldgnode-{i:05d}" for i in range(8)]
    nodes = [jg.build_node(i).to_dict() for i in range(8)]
    for n, name in zip(nodes, names):
        n["name"] = name
    job = jg.build_job({"slot": 1, "category": "svc", "count": 6}).to_dict()
    allocs = [_alloc_doc(job, nodes[i % 8], f"{job['id']}.web[{i}]") for i in range(6)]
    if fault == "over":
        cap = nodes[2]["node_resources"]["cpu"]["cpu_shares"]
        allocs.append(_alloc_doc(job, nodes[2], f"{job['id']}.web[90]", cpu=cap))
    elif fault == "unknown_node":
        ghost = jg.build_node(99).to_dict()
        allocs.append(_alloc_doc(job, ghost, f"{job['id']}.web[91]"))
    elif fault == "twice":
        allocs.append(_alloc_doc(job, nodes[5], f"{job['id']}.web[0]"))
    from nomad_tpu import mock as jmock

    ev = jmock.evaluation()
    ev.job_id, ev.status = job["id"], ("pending" if fault == "stuck" else "complete")
    return [(10, "nodes", nodes), (11, "job", job), (12, "allocs", allocs),
            (13, "evals", [ev.to_dict()])]


FAULTS = ("clean", "over", "unknown_node", "twice", "stuck", "stale")


def _stores(fault: str):
    records = _cluster_records(fault)
    jstore, tstore = _jax_store(records), carry_state(records)
    if fault == "stale":
        # an alloc whose modify index runs past the store's latest, and a
        # node whose create index is past its modify index
        for store in (jstore, tstore):
            a = sorted(store.allocs(), key=lambda x: x.id)[0]
            a.modify_index = store.latest_index() + 5
            n = sorted(store.nodes(), key=lambda x: x.id)[0]
            n.create_index = n.modify_index + 1
    return jstore, tstore


@pytest.mark.parametrize("fault", FAULTS)
def test_full_sweep_reports_the_same_violations(fault):
    jstore, tstore = _stores(fault)
    want = jinv.check_cluster_invariants(jstore)
    got = tinv.check_cluster_invariants(tstore)
    assert got == want
    # no invariant of either package looks at an alloc whose node was never
    # registered: the fit sweep walks the registered nodes
    assert bool(want) == (fault not in ("clean", "unknown_node")), want


@pytest.mark.parametrize("fault", FAULTS)
def test_incremental_checker_reports_the_same_violations(fault):
    jstore, tstore = _stores(fault)
    jc = jinv.IncrementalInvariantChecker(jstore, max_fit_nodes=3, seed=5)
    tc = tinv.IncrementalInvariantChecker(tstore, max_fit_nodes=3, seed=5)
    assert tc.check() == jc.check()
    # a later write on both sides, then the quiesced sweep
    extra = _alloc_doc(_cluster_records("clean")[1][2], jg.build_node(4).to_dict(),
                       "ldg-svc-00001.web[40]")
    jstore.upsert_allocs(20, [jmodel.Allocation.from_dict(extra)])
    tstore.upsert_allocs(20, [tmodel.Allocation.from_dict(extra)])
    assert tc.check() == jc.check()
    assert tc.check(quiesced=True) == jc.check(quiesced=True)
    assert tc.violations == jc.violations
    assert tc.stats() == jc.stats()


def test_federation_checker_reports_the_same_violations():
    def regions(stores):
        return {"r1": stores[0], "r2": stores[1]}

    j1, t1 = _stores("clean")
    j2, t2 = _stores("over")
    job_id = _cluster_records("clean")[1][2]["id"]
    oracle = [{"namespace": "default", "job_id": job_id, "region": "r1"},
              {"namespace": "default", "job_id": "ldg-bat-00404", "region": "r2"},
              {"namespace": "default", "job_id": "ldg-bat-00405", "region": "r2",
               "may_complete": True}]
    for store_mod, stores in ((jmodel, (j1, j2)), (tmodel, (t1, t2))):
        policy = store_mod.AclPolicy(name="ops", rules='namespace "default" {}')
        stores[0].upsert_acl_policies(30, [policy])
    want = jinv.check_federation_invariants(regions((j1, j2)), oracle, "r1")
    got = tinv.check_federation_invariants(regions((t1, t2)), oracle, "r1")
    assert got == want
    assert any("double-committed" in v for v in want)
    assert any("lost cross-region submit" in v for v in want)
    assert any("acl policies diverged" in v for v in want)
    assert any(v.startswith("[r2] node") for v in want)
    assert (tinv.check_federation_invariants(regions((t1, t1)))
            == jinv.check_federation_invariants(regions((j1, j1))) == [])


# ---------------------------------------------------------------------------
# (c) grading and the summary lines on the JAX package's artifacts
# ---------------------------------------------------------------------------

def _artifact(name: str) -> dict:
    with open(os.path.join(ROOT, name)) as f:
        return json.JSONDecoder().raw_decode(f.read())[0]


def test_grading_and_summary_lines_agree_on_the_artifacts(monkeypatch):
    soak = _artifact("SOAK_r01.json")
    overload = _artifact("OVERLOAD_r01.json")
    fanout = _artifact("FANOUT_r01.json")
    for k, v in SMALL_SOAK.items():
        monkeypatch.setenv(k, v)
    cases = [(soak, jsc.soak().slos), (soak, jsc.smoke().slos),
             (overload, {k: v["target"] for k, v in overload["slo"]["checks"].items()
                         if k.startswith("max_")}),
             (fanout, {k: v["target"] for k, v in fanout["slo"]["checks"].items()}),
             (soak, {"max_rss_peak_mb": 1.0, "max_eval_e2e_p99_ms": 1e9, "no_such_key": 0})]
    for report, slos in cases:
        assert tscore.grade(report, slos) == jscore.grade(report, slos)
    assert tscore.summary_line(soak) == jscore.summary_line(soak)
    assert toverload.summary_line(overload) == joverload.summary_line(overload)
    assert tfanout.summary_line(fanout) == jfanout.summary_line(fanout)
    # the artifacts' own verdicts grade the same way again
    assert tscore.grade(overload, {k: v["target"] for k, v in overload["slo"]["checks"].items()
                                   if k.startswith("max_")})["failed"] == 0


# ---------------------------------------------------------------------------
# (d)-(f) storms against the port's server on the CPU
# ---------------------------------------------------------------------------

def test_smoke_storm_on_the_port_ends_clean_and_quiesced():
    from nomad_tpu.loadgen.runner import run_scenario as jrun
    from nomad_tpu_torch.loadgen.runner import run_scenario, summary_line

    seen = {}

    def inspect(server, report):
        seen["full"] = tinv.check_cluster_invariants(server.state)
        seen["device"] = server.device.type

    report = run_scenario(tsc.smoke(nodes=16, churn_s=4), seed=7, driver_workers=6,
                          inspect=inspect, device="cpu")
    assert report["quiesced"]
    assert report["invariants"]["violations"] == 0, report["invariants"]["violation_log"]
    assert seen == {"full": [], "device": "cpu"}
    assert report["slo"]["failed"] == 0, report["slo"]
    d = report["driver"]
    assert d["fired"] >= 60 and d["failed"] == 0 and d["shed"] == 0, d["errors"]
    assert report["stream_digest"] == jg.compile_stream(jsc.smoke(nodes=16, churn_s=4),
                                                        7).digest()
    assert summary_line(report).startswith("SOAK_SUMMARY scenario=smoke seed=7 ")
    # the JAX package's report of the same storm (its schedule compressed
    # tenfold: only its keys and check names are compared)
    want = jrun(jsc.smoke(nodes=16, churn_s=4), seed=7, driver_workers=6, time_scale=0.1)
    assert set(report) == set(want)
    assert set(report["slo"]["checks"]) == set(want["slo"]["checks"])
    assert set(report["invariants"]) == set(want["invariants"])


def test_tiny_overload_storm_accounts_for_every_op(monkeypatch):
    for k, v in {"OVERLOAD_NODES": "8", "OVERLOAD_CAP_S": "1", "OVERLOAD_BURST_S": "1",
                 "OVERLOAD_CAP_RATE": "8", "OVERLOAD_QUIESCE_S": "30"}.items():
        monkeypatch.setenv(k, v)
    report = toverload.run_overload(seed=3, driver_workers=4, device="cpu")
    assert report["overload_unaccounted"] == 0 and report["overload_failed"] == 0, \
        report["errors"]
    for stage in report["stages"].values():
        assert stage["unaccounted"] == 0 and stage["driver"]["failed"] == 0, stage
    assert report["stages"]["capacity"]["driver"]["by_kind"]["node.register"]["ok"] == 8
    assert report["quiesced"] and report["invariants"]["violations"] == 0
    assert toverload.summary_line(report).startswith("OVERLOAD_SUMMARY ")


def test_tiny_fanout_has_no_silent_gap():
    report = tfanout.run_fanout(subs=24, storm_s=1.0, seed=7, in_proc=True, nodes=8,
                                settle_s=2.0, heartbeat=2.0, driver_workers=4, device="cpu")
    assert report["fanout_connected"] == 24
    assert report["fanout_silent_gaps"] == 0 and report["fanout_dupes"] == 0, report
    assert report["gap_checked_conns"] == 24 and report["frames_delivered"] > 0
    assert report["fanout_slow_closes"] == 0 and report["stream_errors"] == 0
    assert report["slo"]["failed"] == 0, report["slo"]


# ---------------------------------------------------------------------------
# (g) the CLI, and the refusals without a card
# ---------------------------------------------------------------------------

class _Out(io.StringIO):
    """A text stdout whose ``buffer`` collects the bytes written to it."""

    def __init__(self):
        super().__init__()
        self.buffer = io.BytesIO()


def _cli_bytes(main, argv) -> tuple:
    out = _Out()
    with contextlib.redirect_stdout(out):
        try:
            rc = main(argv)
        except SystemExit as e:  # --help
            rc = e.code
    return rc, out.buffer.getvalue() + out.getvalue().encode()


def _option_lines(text: bytes, option: bytes) -> bytes:
    """The lines of ``option`` in an argparse help text."""
    lines = text.splitlines(keepends=True)
    start = next(i for i, line in enumerate(lines) if line.lstrip().startswith(option))
    end = next(i for i in range(start + 1, len(lines)) if lines[i].lstrip().startswith(b"-"))
    return b"".join(lines[start:end])


@pytest.mark.parametrize("argv", [["--print-stream", "--seed", "7"],
                                  ["--print-stream", "--seed", "3", "--duration", "2"],
                                  ["--list"], ["--help"]])
def test_cli_prints_the_jax_clis_bytes(argv, monkeypatch):
    monkeypatch.setenv("COLUMNS", "80")
    want = _cli_bytes(jcli.main, argv)
    got = _cli_bytes(tcli.main, argv + ["--device", "cpu"])
    if argv == ["--help"]:
        # the port's help has its own prog name and its --device option; the
        # --federation option's lines are the JAX CLI's bytes
        want = want[0], _option_lines(want[1], b"--federation")
        got = got[0], _option_lines(got[1], b"--federation")
        assert b"FED_PROFILE" in got[1]
    assert got == want and want[0] == 0 and want[1]


def test_operator_keygen_prints_a_key_both_keyrings_take(capsys):
    from nomad_tpu.gossip import keyring as jkeyring
    from nomad_tpu_torch.cli import main as tmain
    from nomad_tpu_torch.gossip import keyring as tkeyring

    assert tmain(["operator", "keygen"]) == 0
    key = capsys.readouterr().out.strip()
    t, j = tkeyring.Keyring(key), jkeyring.Keyring(key)
    assert j.open(t.seal(b"ping")) == b"ping" and t.open(j.seal(b"ack")) == b"ack"
    assert t.list_keys() == j.list_keys() == {"PrimaryKey": key, "Keys": [key]}


def test_storms_want_the_card_and_refuse_before_any_thread():
    from nomad_tpu_torch.loadgen.runner import run_scenario

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA-less refusal is not observable")
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(tsc.smoke(nodes=4, churn_s=1), seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        toverload.run_overload(seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfanout.run_fanout(subs=2, storm_s=1.0, in_proc=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--scenario", "smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tfederation.run_federation(tfederation.federation_smoke(), seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--federation"])
    assert set(threading.enumerate()) <= before
