"""The port's agent surface against the JAX package's, on the CPU.

The jobspec parser, the agent config, the RPC codec, a networked
``ServerAgent`` with its ``HTTPServer`` (nodes registered over RPC, jobs
planned and run over HTTP and through the CLI) and the ``agent`` entry
point in a subprocess. Both agents run with ``seed`` set and one worker,
the JAX one under its deterministic flavor, so their evals, plans and
placements are equal once the ids (uuids, times, raft indexes of the
agents' own history) are scrubbed. Every agent, listener and pool is
stopped in ``finally`` and no thread of a test outlives it.
"""

import base64
import importlib
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

import test_surface as jsurface
from nomad_tpu import config as jconfig
from nomad_tpu import jobspec as jjobspec
from nomad_tpu import mock as jmock
from nomad_tpu.agent import ServerAgent as JServerAgent
from nomad_tpu.api import ApiClient as JApiClient
from nomad_tpu.api import HTTPServer as JHTTPServer
from nomad_tpu.core import broker as jbroker
from nomad_tpu.debug import devprof as jdevprof
from nomad_tpu.rpc import ConnPool as JConnPool
from nomad_tpu.rpc import codec as jcodec
from nomad_tpu.structs import compute_class
from nomad_tpu.tpu import kernel as jk
from nomad_tpu_torch import config as tconfig
from nomad_tpu_torch import jobspec as tjobspec
from nomad_tpu_torch.agent import DevAgent as TDevAgent
from nomad_tpu_torch.agent import ServerAgent as TServerAgent
from nomad_tpu_torch.api import ApiClient as TApiClient
from nomad_tpu_torch.api import HTTPServer as THTTPServer
from nomad_tpu_torch.core import broker as tbroker
from nomad_tpu_torch.debug import devprof as tdevprof
from nomad_tpu_torch.rpc import ConnPool as TConnPool
from nomad_tpu_torch.rpc import codec as tcodec

# the cli packages export their ``main`` function under the module's name
jcli = importlib.import_module("nomad_tpu.cli.main")
tcli = importlib.import_module("nomad_tpu_torch.cli.main")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds an agent's evals get to complete, and its threads to end
EVALS_S = 60.0
STOP_S = 10.0

#: the jobspec tests/test_connect.py parses
CONNECT_SPEC = """
job "mesh" {
  group "api" {
    task "server" {
      driver = "raw_exec"
      service {
        name = "api"
        port = "http"
        connect {
          sidecar_service {
            proxy {
              upstreams {
                destination_name = "db"
                local_bind_port  = 5432
              }
            }
          }
        }
      }
    }
  }
}
"""

#: a batch job of 200 allocs spread over the four datacenters
BATCH_SPEC = """
job "spread-batch" {
  datacenters = ["dc1", "dc2", "dc3", "dc4"]
  type = "batch"
  group "work" {
    count = 200
    spread {
      attribute = "${node.datacenter}"
      weight = 100
    }
    task "t" {
      driver = "mock_driver"
      config { run_for = "60" }
      resources {
        cpu    = 100
        memory = 64
      }
    }
  }
}
"""

AGENT_HCL = """
name = "agent-1"
region = "global"
log_level = "WARN"
server {
  enabled = true
  num_schedulers = 1
  seed = 42
  batch_drain = 4
  prewarm_kernels = true
  prewarm_drain_nodes = 200
  voters {
    agent-1 = "127.0.0.1:%d"
  }
  rpc_port = %d
}
event_broker {
  enabled = true
}
"""


@pytest.fixture(autouse=True)
def _threads_end():
    """Every thread a test starts has ended within ``STOP_S`` of its end
    (each package's process-wide timer wheel excepted)."""
    before = set(threading.enumerate())
    yield
    wheels = {w._thread for w in (jbroker.shared_timer_wheel(), tbroker.shared_timer_wheel())}
    deadline = time.monotonic() + STOP_S
    left = []
    while time.monotonic() < deadline:
        left = [t for t in threading.enumerate()
                if t not in before and t not in wheels and t.is_alive()]
        if not left:
            break
        time.sleep(0.1)
    assert not left, f"threads still alive {STOP_S} s after the test: {[t.name for t in left]}"


# ---------------------------------------------------------------------------
# the jobspec, the agent config, the RPC codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["example", "test_surface", "connect", "batch"])
def test_jobspec_parses_as_jax(name):
    spec = {"example": jcli.EXAMPLE_JOB, "test_surface": jsurface.TestJobspec.SPEC,
            "connect": CONNECT_SPEC, "batch": BATCH_SPEC}[name]
    assert tcli.EXAMPLE_JOB == jcli.EXAMPLE_JOB
    assert tjobspec.parse_job(spec).to_dict() == jjobspec.parse_job(spec).to_dict()
    assert tjobspec.parse_hcl(spec) == jjobspec.parse_hcl(spec)


def test_agent_config_loads_as_jax(tmp_path):
    path = tmp_path / "agent.hcl"
    path.write_text(AGENT_HCL % (4647, 4647) + 'wavefront {\n  enabled = true\n}\n')
    want = jconfig.load_agent_config([str(path)])
    got = tconfig.load_agent_config([str(path)])
    assert got == want
    assert tconfig.server_config_from_agent(got) == jconfig.server_config_from_agent(want)
    assert tconfig.server_config_from_agent(got)["prewarm_drain_nodes"] == 200


def _frame(codec, obj) -> bytes:
    a, b = socket.socketpair()
    try:
        codec.write_frame(a, obj)
        a.close()
        chunks = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)
    finally:
        a.close()
        b.close()


def test_rpc_frames_are_byte_equal():
    node = jmock.node().to_dict()
    for obj in ([7, "Node.Register", {"node": node}], [7, None, {"index": 12}],
                [8, {"code": "not_leader", "message": "x"}, None], [9, "Status.Ping", {}]):
        frame = _frame(tcodec, obj)
        assert frame == _frame(jcodec, obj)
        a, b = socket.socketpair()
        try:
            a.sendall(frame)
            assert tcodec.read_frame(b) == obj
        finally:
            a.close()
            b.close()
    assert (tcodec.RPC_NOMAD, tcodec.RPC_RAFT, tcodec.RPC_STREAMING) == (
        jcodec.RPC_NOMAD, jcodec.RPC_RAFT, jcodec.RPC_STREAMING)


# ---------------------------------------------------------------------------
# a networked agent in each package
# ---------------------------------------------------------------------------

_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
#: keys whose values are the agent's own history, not the outcome
_VOLATILE = re.compile(r"(?i)(time|index|^id$|_id$|token|^eval_?id$|^evalid$|uuid|"
                       r"previous_eval|next_eval|blocked_eval)")


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: "*" if _VOLATILE.search(str(k)) else _scrub(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    if isinstance(obj, str):
        return _UUID.sub("<id>", obj)
    return obj


def _scrub_text(text: str) -> str:
    text = _UUID.sub("<id>", text)
    return re.sub(r"\b\d{10,}\b", "<n>", re.sub(r"\b[0-9a-f]{8}\b", "<id8>", text))


def _node_docs(n_nodes: int = 50, seed: int = 23) -> list:
    rng = random.Random(seed)
    docs = []
    for i in range(n_nodes):
        n = jmock.node()
        n.node_resources.cpu.cpu_shares = rng.choice([2000, 4000])
        n.node_resources.memory.memory_mb = rng.choice([4096, 8192])
        n.datacenter = f"dc{i % 4 + 1}"
        compute_class(n)
        docs.append(n.to_dict())
    return docs


class _Agent:
    """One package's networked agent: its ``ServerAgent`` (one worker,
    ``seed`` set), ``HTTPServer`` on port 0, an RPC pool and an API client."""

    def __init__(self, port: bool):
        self.port = port
        server_agent, http_server, pool = ((TServerAgent, THTTPServer, TConnPool) if port
                                           else (JServerAgent, JHTTPServer, JConnPool))
        cfg = {"seed": 42, "default_scheduler": "tpu-batch"}
        kwargs = {"device": "cpu"} if port else {}
        self.agent = server_agent("agent-1", config=cfg, **kwargs)
        self.http = self.pool = None
        try:
            self.agent.start(num_workers=1, wait_for_leader=5.0)
            self.http = http_server(self.agent.server, port=0)
            self.http.start()
            self.pool = pool()
        except BaseException:
            self.stop()
            raise
        self.api = (TApiClient if port else JApiClient)(address=self.http.address)
        self.cli = tcli if port else jcli

    def stop(self):
        if self.pool is not None:
            self.pool.close()
        if self.http is not None:
            self.http.stop()
        self.agent.stop()

    def register(self, docs):
        for d in docs:
            self.pool.call(self.agent.address, "Node.Register", {"node": d})

    def wait(self, eval_id: str) -> dict:
        deadline = time.monotonic() + EVALS_S
        while True:
            ev = self.api.get(f"/v1/evaluation/{eval_id}")[0]
            if ev["status"] == "complete":
                return ev
            assert ev["status"] not in ("failed", "canceled"), ev
            assert time.monotonic() < deadline, f"eval {eval_id} not complete: {ev['status']}"
            time.sleep(0.05)

    def placements(self, job_id: str) -> dict:
        allocs = self.api.get(f"/v1/job/{job_id}/allocations")[0]
        return {a["Name"]: a["NodeID"] for a in allocs}

    def run_cli(self, capsys, *argv) -> str:
        capsys.readouterr()
        assert self.cli.main(["-address", self.http.address, *argv]) == 0
        return capsys.readouterr().out


def _drive(agent: _Agent, capsys, tmp_path, docs) -> dict:
    """The same session against one agent; returns what it saw."""
    out = {}
    agent.register(docs)
    example = jjobspec.parse_job(jcli.EXAMPLE_JOB).to_dict()
    out["plan"] = _scrub(agent.api.put("/v1/job/example/plan",
                                       body={"Job": example, "Diff": True})[0])
    spec = tmp_path / f"example-{agent.port}.nomad"
    assert agent.cli.main(["job", "init", str(spec)]) == 0
    out["cli_plan"] = _scrub_text(agent.run_cli(capsys, "job", "plan", str(spec)))
    out["cli_run"] = _scrub_text(agent.run_cli(capsys, "job", "run", str(spec)))
    (ev,) = agent.api.get("/v1/job/example/evaluations")[0]
    out["example_eval"] = _scrub(agent.wait(ev["id"]))
    out["example"] = agent.placements("example")
    batch = jjobspec.parse_job(BATCH_SPEC).to_dict()
    resp = agent.api.register_job(batch)
    out["batch_eval"] = _scrub(agent.wait(resp["EvalID"]))
    out["batch"] = agent.placements("spread-batch")
    out["cli_status"] = _scrub_text(agent.run_cli(capsys, "job", "status"))
    out["cli_status_job"] = _scrub_text(agent.run_cli(capsys, "job", "status", "spread-batch"))
    out["device"] = agent.run_cli(capsys, "operator", "device")
    out["device_json"] = json.loads(agent.run_cli(capsys, "operator", "device", "-json"))
    return out


def test_server_agents_plan_and_place_alike(capsys, tmp_path):
    docs = _node_docs()
    for devprof in (jdevprof, tdevprof):
        devprof.reset()
    seen = {}
    for port in (False, True):
        agent = _Agent(port)
        try:
            if port:
                seen[port] = _drive(agent, capsys, tmp_path, docs)
            else:
                with jk.deterministic_scope():
                    seen[port] = _drive(agent, capsys, tmp_path, docs)
        finally:
            agent.stop()
    want, got = seen[False], seen[True]
    assert len(want["example"]) == 1 and len(want["batch"]) == 200
    assert len(set(want["batch"].values())) > 4
    for key in ("plan", "cli_plan", "cli_run", "example_eval", "example", "batch_eval", "batch",
                "cli_status", "cli_status_job"):
        assert got[key] == want[key], key
    # operator device: the same report, the ledger's own rows aside (the
    # JAX package lists XLA compiles, the port first launches)
    jrep, trep = want["device_json"], got["device_json"]
    assert trep["rounds"] == jrep["rounds"]
    for key in ("h2d_mb", "h2d_calls", "d2h_mb", "d2h_calls", "rounds", "placements",
                "rounds_per_placement", "collective_rounds_per_placement"):
        assert trep["summary"][key] == jrep["summary"][key], key
    head = [re.sub(r"\d+(\.\d+)?", "<n>", ln) for ln in got["device"].splitlines()[:4]]
    assert head == [re.sub(r"\d+(\.\d+)?", "<n>", ln) for ln in want["device"].splitlines()[:4]]
    assert got["device"].splitlines()[-len(trep["rounds"]) - 1:] == \
        want["device"].splitlines()[-len(jrep["rounds"]) - 1:]


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_agent_entry_point_serves_and_stops_on_sigterm(tmp_path):
    rpc = _free_port()
    path = tmp_path / "agent.hcl"
    path.write_text(AGENT_HCL % (rpc, rpc))
    proc = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch", "agent", "-device", "cpu", "-config",
         str(path), "-port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    try:
        line = proc.stdout.readline()
        m = re.search(r"http (\S+) rpc (\S+)", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
        http, rpc_addr = m.groups()
        assert rpc_addr == f"127.0.0.1:{rpc}"
        assert http.startswith("http://127.0.0.1:"), http
        with urllib.request.urlopen(f"{http}/v1/agent/self", timeout=10) as r:
            self_doc = json.loads(r.read())
        assert self_doc["member"]["Name"] == "agent-1" and self_doc["member"]["is_leader"]
        assert self_doc["config"]["prewarm_kernels"] is True
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, (proc.returncode, out, err)
        assert "shutting down" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_dev_agent_with_a_client_names_the_client_item(capsys):
    """The client is ported: ``DevAgent`` with a client, and its default of
    one (the JAX package's), runs its clients, and the CLI's ``agent -dev``
    (one client by default) starts, registers its client's node and stops
    on SIGTERM. (The name is the one this test had while the client and its
    drivers raised naming their ROADMAP item.)"""
    for n, agent in ((2, TDevAgent(num_clients=2, device="cpu")), (1, TDevAgent(device="cpu"))):
        try:
            agent.start()
            assert len(agent.clients) == n
            for c in agent.clients:
                assert agent.state.node_by_id(c.node.id) is not None
                assert c.node.attributes["driver.raw_exec"] == "1"
        finally:
            agent.stop()
    proc = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch", "agent", "-dev", "-device", "cpu", "-port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONUNBUFFERED": "1"},
    )
    try:
        line = proc.stdout.readline()
        m = re.search(r"agent started: (\S+) ", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
        clients = re.findall(r"'([0-9a-f]{8})'", proc.stdout.readline())
        assert len(clients) == 1
        with urllib.request.urlopen(f"{m.group(1)}/v1/nodes", timeout=10) as r:
            assert [n["ID"][:8] for n in json.loads(r.read())] == clients
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, (proc.returncode, out, err)
        assert "shutting down" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    # operator keygen is ported with the gossip keyring: a 32-byte key
    assert tcli.main(["operator", "keygen"]) == 0
    assert len(base64.b64decode(capsys.readouterr().out.strip())) == 32
