"""The port's client against the JAX package's, on the CPU.

Each case runs the same documents through both packages: the same client
nodes (one node document, fingerprinted once, handed to each package's
``Client(..., node=...)``), the same jobs, and servers seeded alike with
one worker, so their placements match one for one. What the clients then
do is compared by alloc name with no tolerance: placements, client
status, the task events (type and message, in order), exit codes and
restarts under a restart policy, the log bytes, the alloc fs, logs and
exec over HTTP (status codes and bodies, with alloc ids and file times
scrubbed), the websocket exec, the client state DB restore, a networked
``ClientAgent`` against a ``ServerAgent`` over RPC, and the ``consul``
stanza's catalog sync. Restart delays are capped with
``max_restart_delay`` as the JAX tests do. Every agent is stopped in
``finally`` and no thread of a test outlives it.
"""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu import agent as jagent
from nomad_tpu import mock as jmock
from nomad_tpu.api import HTTPServer as JHTTPServer
from nomad_tpu.api.client import ApiClient as JApiClient
from nomad_tpu.client import Client as JClient
from nomad_tpu.core import broker as jbroker
from nomad_tpu.structs import model as jmodel
from nomad_tpu.structs.model import RestartPolicy, ReschedulePolicy
from nomad_tpu_torch import agent as tagent
from nomad_tpu_torch.api import HTTPServer as THTTPServer
from nomad_tpu_torch.api.client import ApiClient as TApiClient
from nomad_tpu_torch.client import Client as TClient
from nomad_tpu_torch.core import broker as tbroker
from nomad_tpu_torch.structs import model as tmodel

#: seconds a case's allocs get to finish, and a test's threads to end
WAIT_S = 30.0
STOP_S = 10.0
SERVER_CONFIG = {"seed": 42, "heartbeat_ttl": 600.0}


#: the thread each package's local websocket exec leaves parked on its
#: pipe after the session (ROADMAP C5); the websocket test holds the count
#: equal between the packages
WS_DOWN = "exec-ws-down"


@pytest.fixture(autouse=True)
def _threads_end(request):
    """Every thread a test starts has ended within ``STOP_S`` of its end
    (each package's process-wide timer wheel excepted, and the websocket
    test's ``WS_DOWN`` threads, which it counts itself)."""
    before = set(threading.enumerate())
    yield
    wheels = {w._thread for w in (jbroker.shared_timer_wheel(), tbroker.shared_timer_wheel())}
    parked = WS_DOWN if request.node.name == "test_exec_websocket_as_the_jax_agent" else None
    deadline = time.monotonic() + STOP_S
    left = []
    while time.monotonic() < deadline:
        left = [t for t in threading.enumerate()
                if t not in before and t not in wheels and t.is_alive() and t.name != parked]
        if not left:
            break
        time.sleep(0.05)
    assert not left, f"threads still alive {STOP_S} s after the test: {[t.name for t in left]}"


def _node_docs(tmp_path, n: int = 2) -> list:
    """``n`` client node documents: this host fingerprinted once by the JAX
    client, each copy with its own id, secret and name."""
    base = JClient(None, data_dir=str(tmp_path / "fingerprint"), persist=False).node.to_dict()
    docs = []
    for i in range(n):
        doc = json.loads(json.dumps(base))
        doc.update(id=f"00000000-0000-4000-8000-00000000000{i}",
                   secret_id=f"00000000-0000-4000-9000-00000000000{i}", name=f"client-{i}")
        docs.append(doc)
    return docs


def _batch(job_id: str, driver: str, config: dict, count: int = 1, attempts: int = 0) -> dict:
    """A batch job document: ``count`` allocs of one task "t", restarted up
    to ``attempts`` times in mode fail, never rescheduled."""
    job = jmock.batch_job()
    job.id = job.name = job_id
    tg = job.task_groups[0]
    tg.name, tg.count = job_id, count
    tg.restart_policy = RestartPolicy(attempts=attempts, interval=600 * 10**9,
                                      delay=10**7, mode="fail")
    tg.reschedule_policy = ReschedulePolicy(attempts=0, unlimited=False)
    task = tg.tasks[0]
    task.name, task.driver, task.config = "t", driver, config
    task.resources.cpu, task.resources.memory_mb = 20, 16
    task.services = []
    return job.to_dict()


#: (job document, count) of the client cases
JOBS = (
    (_batch("mock", "mock_driver", {"run_for": "50ms", "exit_code": 0}, count=2), 2),
    (_batch("mock-fails", "mock_driver", {"run_for": "20ms", "exit_code": 7}, attempts=1), 1),
    (_batch("echo", "raw_exec", {"command": "/bin/sh", "args": [
        "-c", "echo out-$NOMAD_ALLOC_INDEX-$NOMAD_TASK_NAME; echo err >&2"]}, count=2), 2),
    (_batch("fails", "raw_exec", {"command": "/bin/sh", "args": ["-c", "echo try; exit 3"]},
            attempts=2), 1),
)


class _Run:
    """One package's in-process cluster: a ``DevAgent`` whose clients get
    the given node documents, with its ``HTTPServer``."""

    def __init__(self, port: bool, node_docs: list, tmp_path):
        pkg = tagent if port else jagent
        self.model = tmodel if port else jmodel
        self.client_cls = TClient if port else JClient
        kwargs = {"device": "cpu"} if port else {}
        self.agent = pkg.DevAgent(num_clients=0, server_config=dict(SERVER_CONFIG),
                                  num_workers=1, **kwargs)
        self.dirs = [str(tmp_path / f"{'port' if port else 'jax'}-client{i}")
                     for i in range(len(node_docs))]
        self.agent.clients = [self._client(d, self.model.Node.from_dict(doc))
                              for d, doc in zip(self.dirs, node_docs)]
        self.http = (THTTPServer if port else JHTTPServer)(self.agent.server, port=0,
                                                           agent=self.agent)
        self.api_cls = TApiClient if port else JApiClient

    def _client(self, data_dir, node=None):
        c = self.client_cls(self.agent.server, data_dir=data_dir, node=node)
        c.max_restart_delay = 0.01
        return c

    def __enter__(self):
        self.agent.start()
        self.http.start()
        self.api = self.api_cls(address=self.http.address)
        return self

    def __exit__(self, *exc):
        self.http.stop()
        self.agent.stop()
        shutil.rmtree(self.agent._tmpdir, ignore_errors=True)

    def run(self, docs) -> None:
        for doc in docs:
            self.agent.server.job_register(self.model.Job.from_dict(doc))

    def allocs(self, job_id: str) -> dict:
        return {a.name: a for a in self.agent.state.allocs_by_job("default", job_id)}

    def wait(self, jobs, done=lambda a: a.client_status in ("complete", "failed")) -> None:
        deadline = time.monotonic() + WAIT_S
        while True:
            got = {j["id"]: self.allocs(j["id"]) for j, _ in jobs}
            if all(len(got[j["id"]]) == n and all(done(a) for a in got[j["id"]].values())
                   for j, n in jobs):
                return
            assert time.monotonic() < deadline, {
                k: {n: a.client_status for n, a in v.items()} for k, v in got.items()}
            time.sleep(0.02)

    def http_get(self, path: str) -> tuple:
        """(status, decoded body) of a GET on the agent's HTTP server."""
        return self._request(urllib.request.Request(self.http.address + path))

    def http_put(self, path: str, body: dict) -> tuple:
        return self._request(urllib.request.Request(
            self.http.address + path, data=json.dumps(body).encode(), method="PUT"))

    @staticmethod
    def _request(req) -> tuple:
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()


def _outcome(run: _Run, jobs) -> dict:
    """alloc name -> what the client did with it, alloc ids left out."""
    out = {}
    for doc, _ in jobs:
        for name, a in run.allocs(doc["id"]).items():
            states = {t: (s.state, s.failed, s.restarts,
                          [(e["type"], e["message"]) for e in s.events])
                      for t, s in a.task_states.items()}
            out[name] = dict(node=a.node_id, client_status=a.client_status, tasks=states)
    return out


def _scrub(body, ids: dict):
    """``body`` with alloc ids replaced by their names and file times
    dropped."""
    text = json.dumps(body, sort_keys=True)
    for alloc_id, name in ids.items():
        text = text.replace(alloc_id, name)
    body = json.loads(text)
    if isinstance(body, list):
        body = [{k: v for k, v in e.items() if k != "ModTime"} if isinstance(e, dict) else e
                for e in body]
    return body


def _http_surface(run: _Run) -> list:
    """Status codes and bodies of the alloc fs, logs and exec routes on the
    echo job's first alloc, the failing job's alloc and an unknown alloc."""
    echo, fails = run.allocs("echo"), run.allocs("fails")
    first = echo["echo.echo[0]"]
    ids = {a.id: name for name, a in (*echo.items(), *fails.items())}
    unknown = "11111111-2222-4333-8444-555555555555"
    calls = [
        ("GET", f"/v1/client/fs/logs/{first.id}?task=t&type=stdout", None),
        ("GET", f"/v1/client/fs/logs/{first.id}?task=t&type=stderr", None),
        ("GET", f"/v1/client/fs/logs/{first.id}?task=t&type=stdout&offset=2&limit=3", None),
        ("GET", f"/v1/client/fs/logs/{first.id}?task=t&type=stdout&origin=end&offset=4", None),
        ("GET", f"/v1/client/fs/logs/{first.id}?type=stdout", None),
        ("GET", f"/v1/client/fs/logs/{fails['fails.fails[0]'].id}?task=t&type=stdout", None),
        ("GET", f"/v1/client/fs/logs/{unknown}?task=t&type=stdout", None),
        ("GET", f"/v1/client/fs/ls/{first.id}?path=/", None),
        ("GET", f"/v1/client/fs/ls/{first.id}?path=t/logs", None),
        ("GET", f"/v1/client/fs/cat/{first.id}?path=t/logs/t.stdout.0", None),
        ("GET", f"/v1/client/fs/cat/{first.id}?path=../../escape", None),
        ("PUT", f"/v1/client/exec/{first.id}",
         {"Task": "t", "Cmd": ["/bin/sh", "-c", "echo $PWD | tail -c 2; echo e >&2; exit 4"]}),
        ("PUT", f"/v1/client/exec/{first.id}", {"Task": "t"}),
    ]
    out = []
    for method, path, body in calls:
        status, got = run.http_get(path) if method == "GET" else run.http_put(path, body)
        out.append((method, _scrub(path, ids), status, _scrub(got, ids)))
    return out


def test_clients_run_jobs_as_the_jax_clients(tmp_path):
    """mock_driver and raw_exec jobs, two of them failing under a restart
    policy: the same placements, client statuses, task events, exit codes,
    restarts and log bytes in both packages; then the alloc fs, logs and
    exec routes over HTTP give the same status codes and bodies."""
    nodes = _node_docs(tmp_path)
    docs = [d for d, _ in JOBS]
    got = {}
    for port in (False, True):
        with _Run(port, nodes, tmp_path) as run:
            run.run(docs)
            run.wait(JOBS)
            logs = {}
            for doc, _ in JOBS:
                if doc["task_groups"][0]["tasks"][0]["driver"] != "raw_exec":
                    continue
                for name, a in run.allocs(doc["id"]).items():
                    d = os.path.join(run.dirs[[n["id"] for n in nodes].index(a.node_id)],
                                     "allocs", a.id, "t", "logs")
                    logs[name] = {f: open(os.path.join(d, f), "rb").read()
                                  for f in sorted(os.listdir(d))}
            got[port] = dict(outcome=_outcome(run, JOBS), logs=logs, http=_http_surface(run))
    want, have = got[False], got[True]
    assert have["outcome"] == want["outcome"]
    # what the cases are meant to show, read from the reference's outcome
    assert {n: o["client_status"] for n, o in want["outcome"].items()} == {
        "mock.mock[0]": "complete", "mock.mock[1]": "complete",
        "mock-fails.mock-fails[0]": "failed", "echo.echo[0]": "complete",
        "echo.echo[1]": "complete", "fails.fails[0]": "failed"}
    fails = want["outcome"]["fails.fails[0]"]["tasks"]["t"]
    assert fails[2] == 2 and fails[3][-1] == ("Terminated", "Exit Code: 3, failed")
    assert have["logs"] == want["logs"]
    assert want["logs"]["echo.echo[1]"]["t.stdout.0"] == b"out-1-t\n"
    assert want["logs"]["fails.fails[0]"]["t.stdout.0"] == b"try\ntry\ntry\n"
    assert have["http"] == want["http"]
    assert [s for *_, s, _ in want["http"]] == [200, 200, 200, 200, 400, 200, 404, 200, 200,
                                                200, 400, 200, 400]


def test_a_restarted_client_restores_as_the_jax_client(tmp_path):
    """A client stopped while its mock task runs (its tasks left running,
    the crash path) and started again on its data dir: the same node, the
    task reattached through the driver's RecoverTask, and the same task
    events and client status in both packages."""
    nodes = _node_docs(tmp_path, 1)
    job = (_batch("long", "mock_driver", {"run_for": "1500ms"}), 1)
    got = {}
    for port in (False, True):
        with _Run(port, nodes, tmp_path) as run:
            run.run([job[0]])
            run.wait([job], done=lambda a: a.client_status == "running")
            old = run.agent.clients[0]
            old.stop(destroy_allocs=False)
            fresh = run._client(old.data_dir)
            run.agent.clients[0] = fresh
            fresh.start()
            restored = sorted(run.allocs("long")["long.long[0]"].id == aid
                              for aid in fresh.alloc_runners)
            run.wait([job])
            got[port] = dict(node=fresh.node.id, restored=restored, outcome=_outcome(run, [job]))
    assert got[True] == got[False]
    assert got[False]["node"] == nodes[0]["id"] and got[False]["restored"] == [True]
    events = [t for t, _ in got[False]["outcome"]["long.long[0]"]["tasks"]["t"][3]]
    assert "Recovered" in events and events[-1] == "Terminated"


def test_exec_websocket_as_the_jax_agent(tmp_path):
    """The websocket exec into a running raw_exec task: stdin echoes back
    and the exit frame arrives, in both packages; each leaves one
    ``WS_DOWN`` thread parked after the session (ROADMAP C5)."""
    nodes = _node_docs(tmp_path, 1)
    doc = _batch("sleeper", "raw_exec", {"command": "/bin/sleep", "args": ["30"]})
    got = {}
    for port in (False, True):
        # an earlier test's session may have left its own parked thread
        before = set(threading.enumerate())
        with _Run(port, nodes, tmp_path) as run:
            run.run([doc])
            run.wait([(doc, 1)], done=lambda a: a.client_status == "running")
            alloc = run.allocs("sleeper")["sleeper.sleeper[0]"]
            session = run.api.alloc_exec_session(alloc.id, "t", ["cat"])
            frames = []
            try:
                session.send_stdin(b"ws echo\n")
                frames.append(session.recv_frame(timeout=15))
                session.close_stdin()
                for _ in range(50):
                    frame = session.recv_frame(timeout=15)
                    frames.append(frame)
                    if frame is None or frame.get("exited"):
                        break
            finally:
                session.close()
        time.sleep(0.5)
        parked = [t for t in set(threading.enumerate()) - before
                  if t.name == WS_DOWN and t.is_alive()]
        got[port] = (frames, len(parked))
    assert got[True] == got[False]
    frames, parked = got[False]
    assert parked == 1
    assert frames[0] == {"stdout": b"ws echo\n"} and frames[-1]["exit_code"] == 0


def test_networked_client_agent_as_the_jax_one(tmp_path):
    """A ``ClientAgent`` connected to a ``ServerAgent`` over RPC runs a
    raw_exec job, and the server's HTTP reads its logs through the client's
    RPC listener, in both packages alike."""
    nodes = _node_docs(tmp_path, 1)
    doc = _batch("net", "raw_exec", {"command": "/bin/echo", "args": ["over rpc"]})
    got = {}
    for port in (False, True):
        pkg, model = (tagent, tmodel) if port else (jagent, jmodel)
        server = pkg.ServerAgent("net-1", config=dict(SERVER_CONFIG),
                                 **({"device": "cpu"} if port else {}))
        client = http = None
        try:
            server.start(num_workers=1, wait_for_leader=5.0)
            client = pkg.ClientAgent([server.address], data_dir=str(tmp_path / f"net-{port}"),
                                     node=model.Node.from_dict(nodes[0]))
            client.client.max_restart_delay = 0.01
            client.start()
            http = (THTTPServer if port else JHTTPServer)(server.server, port=0)
            http.start()
            server.server.job_register(model.Job.from_dict(doc))
            deadline = time.monotonic() + WAIT_S
            while True:
                allocs = server.server.state.allocs_by_job("default", "net")
                if allocs and allocs[0].client_status in ("complete", "failed"):
                    break
                assert time.monotonic() < deadline
                time.sleep(0.02)
            (alloc,) = allocs
            with urllib.request.urlopen(
                    f"{http.address}/v1/client/fs/logs/{alloc.id}?task=t&type=stdout",
                    timeout=30) as r:
                body = json.loads(r.read())
            got[port] = (alloc.node_id, alloc.client_status, body)
        finally:
            if http is not None:
                http.stop()
            if client is not None:
                client.stop()
            server.stop()
    assert got[True] == got[False] == (
        nodes[0]["id"], "complete", {"Data": "over rpc\n", "Offset": 9, "Size": 9})


def test_consul_sync_registers_as_the_jax_one():
    """The ``consul`` stanza's catalog sync (``syncer_from_config``) on the
    same running alloc with a service, in both packages, against
    tests/test_consul_sync.py's fake Consul agent: the same registrations,
    TTL check updates, and deregistration at shutdown."""
    import test_consul_sync as jconsul

    from nomad_tpu.client import consul_sync as jsync
    from nomad_tpu.scheduler.testing import Harness as JHarness
    from nomad_tpu_torch.client import consul_sync as tsync
    from nomad_tpu_torch.scheduler.testing import Harness as THarness

    _, job, alloc = jconsul.snapshot_with_running_alloc()
    got = {}
    for port in (False, True):
        model = tmodel if port else jmodel
        h = THarness(seed=42, device="cpu") if port else JHarness(seed=42)
        h.state.upsert_job(1, model.Job.from_dict(job.to_dict()))
        a = model.Allocation.from_dict(alloc.to_dict())
        a.job = h.state.job_by_id(job.namespace, job.id)
        h.state.upsert_allocs(2, [a])
        consul = jconsul.FakeConsul()
        syncer = (tsync if port else jsync).syncer_from_config(
            {"consul": {"address": consul.address, "sync_interval_s": 0.05}}, h.state.snapshot)
        try:
            deadline = time.monotonic() + 10
            while not consul.check_updates:
                assert time.monotonic() < deadline, "the sync never refreshed its TTL check"
                time.sleep(0.02)
            registered = json.loads(json.dumps(consul.services))
        finally:
            syncer.stop()
            consul.stop()
        got[port] = (registered, consul.check_updates[0], consul.services)
    assert got[True] == got[False]
    registered, update, after = got[False]
    assert [s["Name"] for s in registered.values()] == ["web-frontend"]
    assert update[1] == "passing" and after == {}


def test_client_config_stanzas_as_the_jax_ones(tmp_path):
    """``apply_client_config``'s host volumes, meta and vault land on the
    clients' nodes alike in both packages (the same node document, so the
    computed class matches too)."""
    nodes = _node_docs(tmp_path, 1)
    config = {"client": {"host_volume": {"data": {"path": str(tmp_path), "read_only": True}},
                         "meta": {"rack": "r1", "tier": 2}},
              "vault": {"address": "http://127.0.0.1:8200"}}
    got = {}
    for port in (False, True):
        run = _Run(port, nodes, tmp_path)
        try:
            (tagent if port else jagent).apply_client_config(run.agent, config)
            (client,) = run.agent.clients
            got[port] = (client.node.to_dict(), client.vault_config)
        finally:
            run.agent.stop()
            shutil.rmtree(run.agent._tmpdir, ignore_errors=True)
    assert got[True] == got[False]
    node, vault = got[False]
    assert node["meta"]["rack"] == "r1" and node["host_volumes"]["data"]["read_only"] is True
    assert vault == {"address": "http://127.0.0.1:8200"}
