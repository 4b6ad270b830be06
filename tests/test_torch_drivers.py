"""The port's task drivers and plugin framework against the JAX package's,
on the CPU.

- The exec family (``mock_driver``, ``raw_exec``, ``exec`` through the
  port's own ``nsexec`` build): fingerprint, start, wait, signal and kill,
  with the same exit codes as the JAX drivers.
- The extended drivers (java, qemu, docker) with their binaries absent:
  the same fingerprints, none detected.
- ``plugins/hclspec`` and the plugin config schema on the JAX tests'
  cases (tests/test_hclspec.py), one parametrised test: the same decoded
  config or the same error.
- The external plugin handshake through the port's ``plugins.serve``: a
  ``plugin`` stanza loads a device plugin (the card's, on a fake
  ``nvidia-smi``) and a driver plugin into a port client, as the JAX
  package's stanza does its own.

Exact equality throughout.
"""

import stat
import time

import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu import drivers as jdrivers
from nomad_tpu.client import driver as jdriver
from nomad_tpu.drivers import docker as jdocker
from nomad_tpu.plugins import external as jexternal
from nomad_tpu.plugins import hclspec as jhclspec
from nomad_tpu.structs import model as jmodel
from nomad_tpu_torch import agent as tagent
from nomad_tpu_torch import drivers as tdrivers
from nomad_tpu_torch.client import driver as tdriver
from nomad_tpu_torch.drivers import docker as tdocker
from nomad_tpu_torch.plugins import external as texternal
from nomad_tpu_torch.plugins import hclspec as thclspec
from nomad_tpu_torch.structs import model as tmodel

JAX = dict(driver=jdriver, drivers=jdrivers, docker=jdocker, external=jexternal,
           hclspec=jhclspec, model=jmodel)
PORT = dict(driver=tdriver, drivers=tdrivers, docker=tdocker, external=texternal,
            hclspec=thclspec, model=tmodel)

#: each driver's configs: a task that exits 3 at once, and one that runs
#: until it is signalled or killed
TASKS = {
    "mock_driver": ({"run_for": "10ms", "exit_code": 3},
                    {"run_for": "30s", "exit_on_signal": True}),
    "raw_exec": ({"command": "/bin/sh", "args": ["-c", "echo hi; exit 3"]},
                 {"command": "/bin/sleep", "args": ["30"]}),
    "exec": ({"command": "/bin/sh", "args": ["-c", "echo hi; exit 3"]},
             {"command": "/bin/sleep", "args": ["30"]}),
}


def _drive(pkg: dict, name: str, task_dir: str) -> dict:
    """Fingerprint, then a task that exits 3, one signalled with SIGTERM
    and one killed by stop_task: what each returned or raised."""
    driver = pkg["driver"].BUILTIN_DRIVERS[name]()
    out = {"fingerprint": driver.fingerprint()}
    quick, long_ = TASKS[name]

    def task(cfg, i):
        t = pkg["model"].Task(name=f"t{i}", driver=name, config=dict(cfg))
        t.resources.networks = []
        return t

    try:
        h = driver.start_task(task(quick, 0), task_dir)
        out["exit"] = (h.wait(timeout=10.0), h.exit_code)
        h = driver.start_task(task(long_, 1), task_dir)
        time.sleep(0.05)
        driver.signal_task(h, "SIGTERM")
        out["signal"] = (h.wait(timeout=10.0), h.exit_code)
        h = driver.start_task(task(long_, 2), task_dir)
        time.sleep(0.05)
        driver.stop_task(h, timeout=1.0)
        out["kill"] = (h.wait(timeout=10.0), h.exit_code)
        out["data_keys"] = sorted(driver.handle_data(h))
    except Exception as e:  # a refusal must be the same refusal
        out["error"] = (type(e).__name__, str(e))
    return out


@pytest.mark.parametrize("name", sorted(TASKS))
def test_exec_family_drivers_start_wait_signal_and_kill_as_the_jax_ones(name, tmp_path):
    got = {}
    for label, pkg in (("jax", JAX), ("port", PORT)):
        d = tmp_path / label
        d.mkdir()
        got[label] = _drive(pkg, name, str(d))
    assert got["port"] == got["jax"]
    assert "error" not in got["jax"] or not got["jax"]["fingerprint"]["healthy"]
    if "error" not in got["jax"]:
        assert got["jax"]["exit"] == (True, 3)


def test_extended_drivers_fingerprint_as_the_jax_ones_without_their_binaries(monkeypatch,
                                                                            tmp_path):
    """java, qemu and docker with no binary on PATH: not detected, not
    healthy, the same fingerprint in both packages; ``default_drivers``
    carries the same families."""
    monkeypatch.setenv("PATH", str(tmp_path))
    for name in ("JavaDriver", "QemuDriver", "DockerDriver"):
        fps = [getattr(pkg["drivers"], name)().fingerprint() for pkg in (JAX, PORT)]
        assert fps[1] == fps[0]
        assert (fps[0]["detected"], fps[0]["healthy"]) == (False, False)
    assert sorted(tdriver.default_drivers()) == sorted(jdriver.default_drivers())
    assert sorted(tdrivers.EXTENDED_DRIVERS) == sorted(jdrivers.EXTENDED_DRIVERS) == [
        "docker", "java", "qemu"]


def _docker(pkg):
    return pkg["docker"].DockerDriver.__new__(pkg["docker"].DockerDriver)  # no binary probe


def _blocks(m):
    return {
        "image": m.Attr("string", required=True),
        "auth": m.Block({"username": m.Attr("string"), "password": m.Attr("string")}),
        "mounts": m.BlockList({
            "target": m.Attr("string", required=True),
            "volume_options": m.Block({"labels": m.Attr("map(string)")}),
        }),
    }


#: tests/test_hclspec.py's cases: name -> fn(package) whose value or
#: exception is compared
HCLSPEC_CASES = {
    "primitives": lambda p: p["hclspec"].validate_spec(
        {"name": p["hclspec"].Attr("string"), "count": p["hclspec"].Attr("number"),
         "on": p["hclspec"].Attr("bool")}, {"name": "x", "count": 2.5, "on": True}),
    "bool_is_not_a_number": lambda p: p["hclspec"].validate_spec(
        {"count": p["hclspec"].Attr("number")}, {"count": True}),
    "list_and_map": lambda p: p["hclspec"].validate_spec(
        {"args": p["hclspec"].Attr("list(string)"), "env": p["hclspec"].Attr("map(string)")},
        {"args": ["a", "b"], "env": {"K": "v"}}),
    "list_element_error": lambda p: p["hclspec"].validate_spec(
        {"args": p["hclspec"].Attr("list(string)")}, {"args": ["a", 3]}),
    "map_value_error": lambda p: p["hclspec"].validate_spec(
        {"ports": p["hclspec"].Attr("map(number)")}, {"ports": {"http": "80"}}),
    "nested_decode": lambda p: p["hclspec"].validate_spec(_blocks(p["hclspec"]), {
        "image": "redis:7", "auth": {"username": "u", "password": "p"},
        "mounts": [{"target": "/data", "volume_options": {"labels": {"a": "b"}}}]}),
    "single_block_for_list": lambda p: p["hclspec"].validate_spec(
        _blocks(p["hclspec"]), {"image": "redis:7", "mounts": {"target": "/data"}}),
    "nested_pathed_error": lambda p: p["hclspec"].validate_spec(_blocks(p["hclspec"]), {
        "image": "redis:7", "mounts": [{"target": "/d", "volume_options": {"labels": {"a": 1}}}]}),
    "unknown_nested_key": lambda p: p["hclspec"].validate_spec(
        _blocks(p["hclspec"]), {"image": "x", "auth": {"passwrod": "oops"}}),
    "missing_required_nested": lambda p: p["hclspec"].validate_spec(
        _blocks(p["hclspec"]), {"image": "x", "mounts": [{}]}),
    "block_list_min": lambda p: p["hclspec"].validate_spec(
        {"groups": p["hclspec"].BlockList({"name": p["hclspec"].Attr("string")}, min=1, max=2)},
        {"groups": []}),
    "block_list_max": lambda p: p["hclspec"].validate_spec(
        {"groups": p["hclspec"].BlockList({"name": p["hclspec"].Attr("string")}, min=1, max=2)},
        {"groups": [{}, {}, {}]}),
    "default_absent": lambda p: p["hclspec"].validate_spec(
        {"retries": p["hclspec"].Default(p["hclspec"].Attr("number"), 3)}, {}),
    "default_present": lambda p: p["hclspec"].validate_spec(
        {"retries": p["hclspec"].Default(p["hclspec"].Attr("number"), 3)}, {"retries": 5}),
    "literal": lambda p: p["hclspec"].validate_spec({"version": p["hclspec"].Literal("v1")}, {}),
    "legacy_flat_schema": lambda p: p["external"].validate_plugin_config(
        {"addr": {"type": "string", "required": True},
         "port": {"type": "number", "default": 8080}}, {"addr": "1.2.3.4"}),
    "legacy_required": lambda p: p["external"].validate_plugin_config(
        {"addr": {"type": "string", "required": True}}, {}),
    "legacy_unknown": lambda p: p["external"].validate_plugin_config({}, {"bogus": 1}),
    "docker_full_config": lambda p: _docker(p).validate_task_config({
        "image": "redis:7", "args": ["--maxmemory", "64mb"], "port_map": {"db": 6379},
        "labels": {"team": "infra"}, "auth": {"username": "u", "password": "p"},
        "mounts": [{"type": "volume", "target": "/data", "source": "vol1", "volume_options": {
            "no_copy": True, "driver_config": {"name": "local", "options": {"o": "bind"}}}}],
        "devices": [{"host_path": "/dev/fuse"}]}),
    "docker_bad_nested": lambda p: _docker(p).validate_task_config({
        "image": "redis:7", "mounts": [{"target": "/d", "volume_options": {"no_copy": "yes"}}]}),
    "docker_device_host_path": lambda p: _docker(p).validate_task_config(
        {"image": "x", "devices": [{"container_path": "/dev/x"}]}),
    "docker_namespace_keys": lambda p: _docker(p).validate_task_config({
        "image": "redis:7", "network_mode": "bridge", "ipv4_address": "172.18.0.10",
        "ipv6_address": "2001:db8::10", "pid_mode": "host", "ipc_mode": "host",
        "uts_mode": "host", "userns_mode": "host"}),
    "docker_pid_mode_type": lambda p: _docker(p).validate_task_config(
        {"image": "x", "pid_mode": 1}),
    "docker_typo_key": lambda p: _docker(p).validate_task_config({"imge": "redis:7"}),
    "docker_port_map_number": lambda p: _docker(p).validate_task_config(
        {"image": "x", "port_map": {"db": "6379"}}),
}


#: the cases the reference's own tests expect to be refused
HCLSPEC_REFUSED = {
    "bool_is_not_a_number", "list_element_error", "map_value_error", "nested_pathed_error",
    "unknown_nested_key", "missing_required_nested", "block_list_min", "block_list_max",
    "legacy_required", "legacy_unknown", "docker_bad_nested", "docker_device_host_path",
    "docker_pid_mode_type", "docker_typo_key", "docker_port_map_number"}


def _outcome(fn, pkg):
    try:
        return ("ok", fn(pkg))
    except Exception as e:
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("case", sorted(HCLSPEC_CASES))
def test_hclspec_as_the_jax_one(case):
    want = _outcome(HCLSPEC_CASES[case], JAX)
    assert _outcome(HCLSPEC_CASES[case], PORT) == want
    assert (want[0] == "error") == (case in HCLSPEC_REFUSED)


def _fake_smi(tmp_path) -> str:
    path = tmp_path / "nvidia-smi"
    path.write_text("#!/bin/sh\nprintf 'GPU-0b6f1a2c-1111-2222-3333-444455556666, "
                    "NVIDIA H100 80GB HBM3, 580.159.03, 81559\\n'\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _external_driver_run(driver, model) -> tuple:
    """fingerprint, a task run to its end, a long task stopped mid-run."""
    fp = driver.fingerprint()
    h = driver.start_task(model.Task(name="t1", driver="mock_driver",
                                     config={"run_for": "0.2s", "exit_code": 2}), "")
    done = (h.wait(timeout=10.0), h.exit_code)
    h2 = driver.start_task(model.Task(name="t2", driver="mock_driver",
                                      config={"run_for": "30s"}), "")
    driver.stop_task(h2)
    return fp["detected"], fp["healthy"], done, (h2.wait(timeout=10.0), h2.exit_code)


def test_plugin_stanza_loads_plugins_through_the_port_serve(tmp_path):
    """The agent's ``plugin`` stanza on a port client: a device plugin (the
    card's, pushed a fake nvidia-smi through the handshake's config) and a
    driver plugin, each a ``python -m nomad_tpu_torch.plugins.serve``
    process. The device groups reach the node; reserve answers over the
    socket; the driver plugin runs tasks with the exit codes the JAX
    package's subprocess driver gives."""
    agent = tagent.DevAgent(num_clients=1, device="cpu",
                            server_config={"heartbeat_ttl": 600.0})
    client = agent.clients[0]
    try:
        tagent.apply_client_config(agent, {"plugin": {
            "card-ext": {"type": "device",
                         "spec": "nomad_tpu_torch.client.devices:NvidiaDevicePlugin",
                         "config": {"nvidia_smi": _fake_smi(tmp_path)}},
            "mock-ext": {"type": "driver", "spec": "nomad_tpu_torch.client.driver:MockDriver"},
        }})
        ext = client.device_manager.plugins[-1]
        assert isinstance(ext, texternal.ExternalDevicePlugin) and ext.name == "nvidia"
        (group,) = client.node.node_resources.devices
        assert (group.vendor, group.type, group.name) == ("nvidia", "gpu", "NVIDIA H100 80GB HBM3")
        ids = [d.id for d in group.instances]
        assert client.node.attributes["device.nvidia.gpu.count"] == "1"
        assert client.node.attributes["driver.mock-ext"] == "1"
        assert client.device_manager.reserve_env([tmodel.AllocatedDeviceResource(
            vendor="nvidia", type="gpu", name=group.name, device_ids=ids)]) == {
            "CUDA_VISIBLE_DEVICES": ids[0]}
        got = _external_driver_run(client.drivers["mock-ext"], tmodel)
    finally:
        client.stop()
        agent.server.stop()
    jdrv = jexternal.ExternalDriver("nomad_tpu.client.driver:MockDriver", name="mock_driver")
    try:
        want = _external_driver_run(jdrv, jmodel)
    finally:
        jdrv.shutdown()
    assert got == want == (True, True, (True, 2), (True, 130))
