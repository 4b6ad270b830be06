"""The port's federation: ``nomad_tpu_torch.loadgen.federation`` and the
server's gossip, ACL and region forwarding against the JAX package's.

- (a) the per-region op streams (``region_scenario`` then
  ``route_cross_region``) are byte-equal between the packages, for the
  smoke and storm profiles and the storm at chip_smoke.py phase 10's
  fleet, over a few seeds;
- (b) with ``server_settings`` empty, the port's
  ``FederatedCluster._server_config`` equals the JAX one key for key, for
  every region and index; with settings, they are merged in last;
- (c) the slice as a whole: two regions of one server each, ACL on and
  the soak's device settings, booted in each package by its own
  ``FederatedCluster`` (the JAX package's under ``deterministic_scope``),
  get the same scripted sequence over HTTP: bootstrap, a policy and a
  client token, an anonymous submit (denied), the policy replicated to
  west, and two jobs of a few dozen allocs submitted at west's HTTP with
  ``?region=east``. Every status code, the policies and tokens of both
  regions and every alloc's node are equal; the port's two evals went
  through one fused drain batch;
- (d) the port's own smoke storm, with the soak's device settings on the
  CPU, ends clean and quiesced: no violation, nothing lost or double
  committed, forwarded submits, the partition healed, and no eval sent
  off the kernels for a reason outside the by-design gates.

Every server is stopped in ``finally``, and a fixture checks after each
test that no thread it started is still alive within ``STOP_S`` (the
process-wide timer wheels and the node drainer's poll excepted). Every
wait has a deadline.
"""

import importlib.util
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from torch_for_tests import gil_handoff  # noqa: F401

from test_torch_server import _cluster_docs, _job_docs, _wheel_threads
from nomad_tpu.loadgen import federation as jfed
from nomad_tpu.loadgen import grammar as jg
from nomad_tpu.structs import model as jmodel
from nomad_tpu.tpu import batch_sched as jsched
from nomad_tpu.tpu import drain as jdrain
from nomad_tpu.tpu import kernel as jk
from nomad_tpu_torch.loadgen import federation as tfed
from nomad_tpu_torch.loadgen import grammar as tg
from nomad_tpu_torch.structs import model as tmodel
from nomad_tpu_torch.tpu import batch_sched as tsched
from nomad_tpu_torch.tpu import drain as tdrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a stopped cluster's threads get to end
STOP_S = 10.0
#: seconds a replication, a forward or an eval gets to show
WAIT_S = 30.0
#: the soak scenario's device settings (loadgen/scenarios.py's soak
#: server_config), as chip_smoke.py phase 10 gives them to every server
SETTINGS = {"default_scheduler": "tpu-batch", "batch_drain": 8, "plan_apply_batch": 8}
#: the tpu-batch gates that send an eval to the scalar scheduler by design
ROUTED = ("small_eval", "reschedule", "canary", "destructive_update", "no_ready_nodes")


@pytest.fixture(autouse=True)
def _threads_end():
    """After each test, every thread it started has ended within ``STOP_S``
    (the timer wheels excepted, and the node drainer, which ends within
    its 2 s poll)."""
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


def _wait(fn, msg, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if got:
            return got
        assert time.monotonic() < deadline, f"timed out waiting for {msg}"
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# (a) the per-region streams
# ---------------------------------------------------------------------------

def _phase10(fed):
    """chip_smoke.py phase 10's storm: federation_storm() at its ``FED_SIZE``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    size = chip_smoke.FED_SIZE
    cfg = fed.federation_storm()
    cfg.nodes_per_region, cfg.churn_s, cfg.quiesce_timeout = (
        size["nodes"], size["churn_s"], size["quiesce_s"])
    return cfg


@pytest.mark.parametrize("seed", [1, 7, 20260803])
@pytest.mark.parametrize("profile", ["federation_smoke", "federation_storm", "phase10"])
def test_region_streams_are_byte_equal(profile, seed, monkeypatch):
    for k in list(os.environ):
        if k.startswith("FED_"):
            monkeypatch.delenv(k)
    make = {"phase10": _phase10}
    jcfg = make[profile](jfed) if profile in make else getattr(jfed, profile)()
    tcfg = make[profile](tfed) if profile in make else getattr(tfed, profile)()
    regions = jcfg.region_names()
    assert tcfg.region_names() == regions and tcfg.server_settings == {}
    for region in regions:
        others = [r for r in regions if r != region]
        want = jfed.route_cross_region(jg.compile_stream(jfed.region_scenario(region, jcfg), seed),
                                       region, others, seed, jcfg.cross_region_p)
        got = tfed.route_cross_region(tg.compile_stream(tfed.region_scenario(region, tcfg), seed),
                                      region, others, seed, tcfg.cross_region_p)
        assert got.encode() == want.encode() and got.digest() == want.digest()
        assert any(op.args.get("via_region") for op in got.ops)


# ---------------------------------------------------------------------------
# (b) the servers' configs
# ---------------------------------------------------------------------------

def test_server_configs_are_the_jax_ones():
    jc = jfed.FederatedCluster(jfed.federation_storm(), seed=42)
    tc = tfed.FederatedCluster(tfed.federation_storm(), seed=42, device="cpu")
    cfg = tfed.federation_storm()
    cfg.server_settings = dict(SETTINGS)
    ts = tfed.FederatedCluster(cfg, seed=42, device="cpu")
    try:
        for c in (jc, tc, ts):
            c.mgmt_token = "secret-1"
        seeds = [["127.0.0.1", 4648]]
        for region in jc.regions:
            for index in range(3):
                want = jc._server_config(region, index, seeds)
                assert tc._server_config(region, index, seeds) == want
                assert list(tc._server_config(region, index, seeds)) == list(want)
                assert ts._server_config(region, index, seeds) == {**want, **SETTINGS}
        assert "default_scheduler" not in want and "batch_drain" not in want
    finally:
        for c in (jc, tc, ts):
            c.stop()


# ---------------------------------------------------------------------------
# (c) two regions, ACL on, the soak's device settings, one scripted sequence
# ---------------------------------------------------------------------------

class _JCluster(jfed.FederatedCluster):
    """The JAX package's cluster with the soak's device settings merged in
    last, as the port's ``server_settings`` does."""

    def _server_config(self, region, index, seeds):
        return {**super()._server_config(region, index, seeds), **SETTINGS}


def _http(method: str, url: str, token: str = "", body=None) -> tuple:
    """(status, decoded body) of one request."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if token:
        req.add_header("X-Nomad-Token", token)
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, None


def _scripted(port: bool, node_docs: list, job_docs: list) -> dict:
    """One package's run of the scripted sequence; returns what it saw."""
    fed, model = (tfed, tmodel) if port else (jfed, jmodel)
    if port:
        cfg = tfed.FederationConfig(regions=2, servers_per_region=1, n_workers=0,
                                    server_settings=dict(SETTINGS))
        cluster = tfed.FederatedCluster(cfg, seed=42, device="cpu")
    else:
        cluster = _JCluster(jfed.FederationConfig(regions=2, servers_per_region=1, n_workers=0),
                            seed=42)
    modes0 = (tsched if port else jsched).counters_snapshot()
    statuses, out = [], {}
    try:
        east = fed.FedServer(region="east", index=0, name="east-0",
                             data_dir=os.path.join(cluster._tmpdir, "east-0"))
        cluster._boot_server(east, [], wait_leader=True)
        cluster.servers.append(east)
        e_url = east.http.address.rstrip("/")
        # 1. bootstrap over HTTP; the replica region gets the token to pull with
        status, boot = _http("PUT", f"{e_url}/v1/acl/bootstrap")
        statuses.append(status)
        cluster.mgmt_token = mgmt = boot["SecretID"]
        west = fed.FedServer(region="west", index=0, name="west-0",
                             data_dir=os.path.join(cluster._tmpdir, "west-0"))
        cluster._boot_server(west, [list(east.agent.server.gossip.addr)], wait_leader=True)
        cluster.servers.append(west)
        w_url = west.http.address.rstrip("/")
        cluster.wait_ready()
        server = east.agent.server
        for d in node_docs:
            server.node_register(model.Node.from_dict(d))
        # 2. a policy and a client token
        rules = 'namespace "default" { policy = "read" }\nnode { policy = "read" }'
        statuses.append(_http("PUT", f"{e_url}/v1/acl/policy/readonly", mgmt,
                              {"Rules": rules, "Description": "read only"})[0])
        status, tok = _http("PUT", f"{e_url}/v1/acl/token", mgmt,
                            {"Name": "ro", "Type": "client", "Policies": ["readonly"],
                             "Global": True})
        statuses.append(status)
        # 3. an anonymous submit, and the client token's, are denied
        job = {"Job": job_docs[0]}
        statuses.append(_http("PUT", f"{e_url}/v1/jobs", "", job)[0])
        statuses.append(_http("PUT", f"{w_url}/v1/jobs?region=east", tok["SecretID"], job)[0])
        # 4. the policy and the global token replicate to west
        _wait(lambda: west.agent.server.state.acl_policy_by_name("readonly")
              and west.agent.server.state.acl_token_by_accessor(tok["AccessorID"]),
              "the policy and the token in west")
        status, listed = _http("GET", f"{w_url}/v1/acl/policies", mgmt)
        statuses.append(status)
        out["west_policy_names"] = sorted(p["Name"] for p in listed)
        statuses.append(_http("GET", f"{w_url}/v1/jobs", tok["SecretID"])[0])
        # 5. the jobs enter west's HTTP and are forwarded to east
        eval_ids = []
        for d in job_docs:
            status, resp = _http("PUT", f"{w_url}/v1/jobs?region=east", mgmt, {"Job": d})
            statuses.append(status)
            eval_ids.append(resp["EvalID"])
        assert not list(west.agent.server.state.jobs())
        batches0 = dict((tdrain if port else jdrain).DRAIN_COUNTERS)
        server.start_workers(1)  # both evals are in the broker: one fused batch
        _wait(lambda: all((e := server.state.eval_by_id(i)) is not None
                          and e.status == "complete" for i in eval_ids), "the evals complete")
        drain_mod = tdrain if port else jdrain
        out["drained"] = {k: drain_mod.DRAIN_COUNTERS[k] - batches0[k] for k in batches0}
        modes = (tsched if port else jsched).counters_snapshot()
        out["kernel_evals"] = modes["drain_evals"] - modes0["drain_evals"]
        out["statuses"] = statuses
        out["placements"] = {
            (d["id"], a.name): a.node_id for d in job_docs
            for a in server.state.allocs_by_job("default", d["id"])}
        for name, fs in (("east", east), ("west", west)):
            st = fs.agent.server.state
            out[f"{name}_policies"] = {p.name: (p.description, p.rules) for p in st.acl_policies()}
            out[f"{name}_tokens"] = sorted((t.name, t.type, tuple(t.policies), t.global_token)
                                           for t in st.acl_tokens())
        out["west_replication"] = {
            k: west.agent.server.acl_replication_status.get(k)
            for k in ("configured", "authoritative_region")}
    finally:
        cluster.stop()
    return out


def test_two_regions_with_acl_answer_and_place_as_the_jax_ones():
    node_docs, job_docs = _cluster_docs(), _job_docs([24, 30])
    with jk.deterministic_scope():
        want = _scripted(False, node_docs, job_docs)
    got = _scripted(True, node_docs, job_docs)
    assert got == want
    assert got["statuses"] == [200, 200, 200, 403, 403, 200, 200, 200, 200]
    assert len(got["placements"]) == 54
    assert got["west_policy_names"] == ["readonly"]
    assert got["west_tokens"] == got["east_tokens"] == [
        ("Bootstrap Token", "management", (), True), ("ro", "client", ("readonly",), True)]
    assert got["west_replication"] == {"configured": True, "authoritative_region": "east"}
    assert got["drained"] == {"batches": 1, "evals": 2} and got["kernel_evals"] == 2


# ---------------------------------------------------------------------------
# (d) the port's own smoke storm on the CPU
# ---------------------------------------------------------------------------

def test_smoke_storm_on_the_port_ends_clean_and_quiesced():
    cfg = tfed.federation_smoke()
    cfg.server_settings = dict(SETTINGS)
    cfg.n_workers = 2
    before = tsched.counters_snapshot()["fallback_reasons"]
    report = tfed.run_federation(cfg, seed=1, device="cpu")
    after = tsched.counters_snapshot()["fallback_reasons"]
    routed = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    assert report["slo"]["failed"] == 0, report["slo"]
    assert report["quiesced"]
    assert report["fed_invariant_violations"] == 0, report["final_violations"]
    assert report["fed_lost_placements"] == 0 and report["fed_double_placements"] == 0
    assert report["fed_fwd_attempted"] > 0 and report["oracle_forwarded_submits"] > 0
    heals = [e for e in report["chaos"] if e["kind"] == "heal"]
    assert heals and all(e["ok"] for e in heals) and report["fed_heal_times"]
    assert set(routed) <= set(ROUTED), routed
    for region in report["region_names"]:
        assert report["regions"][region]["stream_digest"] == jfed.route_cross_region(
            jg.compile_stream(jfed.region_scenario(region, jfed.federation_smoke()), 1),
            region, [r for r in report["region_names"] if r != region], 1, 0.3).digest()
    assert tfed.summary_line(report).startswith("FED_SUMMARY regions=2 servers=2 seed=1 ")


# ---------------------------------------------------------------------------
# (e) the driver fires each job slot's ops in stream order
# ---------------------------------------------------------------------------

def _slot_firings(driver_cls, monkeypatch, attr):
    """Fire one stream through ``driver_cls`` with four workers and a fake
    op that sleeps: slot 0's submit is slow, its stop and resubmit quick,
    and slot 1's ops fall in between. Returns (seq, slot, start, end) per
    op, in start order."""
    ops = [
        tg.Op(t=0.0, seq=0, kind="job.submit", args={"slot": 0, "category": "svc", "sleep": 0.3}),
        tg.Op(t=0.0, seq=1, kind="job.stop", args={"slot": 0, "sleep": 0.0}),
        tg.Op(t=0.0, seq=2, kind="job.scale", args={"slot": 1, "sleep": 0.1}),
        tg.Op(t=0.0, seq=3, kind="job.submit", args={"slot": 0, "category": "svc", "sleep": 0.0}),
        tg.Op(t=0.0, seq=4, kind="job.update", args={"slot": 1, "sleep": 0.0}),
    ]
    fired, lock = [], threading.Lock()

    def fire(self, op, payload, proxy, http):
        t0 = time.monotonic()
        time.sleep(op.args["sleep"])
        with lock:
            fired.append((op.seq, op.args["slot"], t0, time.monotonic()))

    monkeypatch.setattr(driver_cls, attr, fire)
    kw = dict(region="east", cluster=None, oracle={}, oracle_lock=threading.Lock()) \
        if driver_cls is tfed.FederatedDriver else {}
    driver = driver_cls(tg.OpStream("slots", 1, ops), ["127.0.0.1:1"], "http://127.0.0.1:1",
                        workers=4, **kw)
    report = driver.run()
    assert report.fired == len(ops) and report.ok == len(ops), report.to_dict()
    return sorted(fired, key=lambda f: f[2])


def test_the_federated_driver_fires_a_job_slots_ops_in_stream_order(monkeypatch):
    """The oracle reads a slot's ops in stream order (a stop retires the
    submit before it). The storm driver's pool runs queued ops at once, so
    without the federated driver's per-slot line slot 0's stop and
    resubmit start before its slow submit ends; with it they wait, while
    slot 1's ops still run beside that submit."""
    from nomad_tpu_torch.loadgen.driver import StormDriver

    pooled = _slot_firings(StormDriver, monkeypatch, "_fire")
    slow = next(f for f in pooled if f[0] == 0)
    assert any(f[1] == 0 and f[0] > 0 and f[2] < slow[3] for f in pooled), pooled

    lined = _slot_firings(tfed.FederatedDriver, monkeypatch, "_fire_op")
    for slot in (0, 1):
        mine = [f for f in lined if f[1] == slot]
        assert [f[0] for f in mine] == sorted(f[0] for f in mine), lined
        assert all(a[3] <= b[2] for a, b in zip(mine, mine[1:])), lined
    slow = next(f for f in lined if f[0] == 0)
    assert any(f[1] == 1 and f[2] < slow[3] for f in lined), lined
