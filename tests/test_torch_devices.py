"""The port's device plugins against the JAX package's, on the CPU.

The copied ``TPUDevicePlugin`` and ``DeviceManager`` are held equal to
the JAX ones on a fake dev tree (as tests/test_plugins.py builds it). The
card's plugin, ``NvidiaDevicePlugin``, which takes the TPU plugin's place
in the port's default plugin list, runs on a faked device list (a fake
``nvidia-smi`` script) and is held against
the JAX TPU plugin's outputs on the same instance ids: the group's
fields, the node's ``device.<vendor>.<type>.count`` attribute, a shrink
clearing it, and the reserve env, which names the ids in
CUDA_VISIBLE_DEVICES where the TPU plugin names them in
TPU_VISIBLE_DEVICES. Exact equality throughout.
"""

import os
import tempfile
import threading
import time

import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu import mock as jmock
from nomad_tpu.client import Client as JClient
from nomad_tpu.client import devices as jdevices
from nomad_tpu.core import broker as jbroker
from nomad_tpu.core.server import Server as JServer
from nomad_tpu.structs import model as jmodel
from nomad_tpu_torch.client import Client as TClient
from nomad_tpu_torch.client import devices as tdevices
from nomad_tpu_torch.core import broker as tbroker
from nomad_tpu_torch.core.server import Server as TServer
from nomad_tpu_torch.structs import model as tmodel

H100 = "NVIDIA H100 80GB HBM3"
UUIDS = [f"GPU-0b6f1a2c-1111-2222-3333-44445555666{i}" for i in range(4)]


def _fake_dev(tmp, n):
    for i in range(n):
        open(os.path.join(tmp, f"accel{i}"), "w").close()
    return os.path.join(tmp, "accel*")


def _smi(path, cards) -> str:
    """A fake nvidia-smi at ``path`` that lists ``cards`` (uuid, model,
    driver version, memory MiB) as the plugin queries them."""
    rows = "".join(f"{', '.join(map(str, c))}\n" for c in cards)
    path.write_text(f"#!/bin/sh\nprintf '{rows}'\n")
    path.chmod(0o755)
    return str(path)


def _cards(n, name=H100):
    return [(UUIDS[i], name, "580.159.03", 81559) for i in range(n)]


@pytest.mark.parametrize("chips", [0, 1, 4])
def test_copied_tpu_plugin_and_manager_equal_the_jax_ones(chips, tmp_path):
    """Fingerprint, reserve, stats and the manager's node merge and env."""
    glob_pat = _fake_dev(str(tmp_path), chips)
    jp, tp = jdevices.TPUDevicePlugin(dev_glob=glob_pat), tdevices.TPUDevicePlugin(dev_glob=glob_pat)
    assert [g.to_dict() for g in tp.fingerprint()] == [g.to_dict() for g in jp.fingerprint()]
    assert tp.reserve(["1", "3"]) == jp.reserve(["1", "3"])
    assert tp.stats() == jp.stats()
    assert tp.config_schema() == jp.config_schema()
    nodes = []
    for mgr, model, plugin in ((jdevices.DeviceManager([jp]), jmodel, jp),
                               (tdevices.DeviceManager([tp]), tmodel, tp)):
        node = model.Node(node_resources=model.NodeResources())
        found = mgr.fingerprint_node(node)
        ids = [d.id for g in node.node_resources.devices for d in g.instances][:2]
        asked = [model.AllocatedDeviceResource(vendor="google", type="tpu", name="tpu",
                                               device_ids=ids)] if ids else []
        nodes.append((found, node.to_dict(), mgr.reserve_env(asked), mgr.stats()))
    assert nodes[1] == nodes[0]


def test_the_card_plugin_fingerprints_as_the_tpu_plugin_does(tmp_path):
    """On the same instance ids: one group a card model with one instance a
    card, the count attribute, a shrink clearing it, and the reserve env."""
    for n in (1, 2, 4):
        tpu = jdevices.TPUDevicePlugin(dev_glob=_fake_dev(tempfile.mkdtemp(dir=tmp_path), n))
        (jg,) = tpu.fingerprint()
        card = tdevices.NvidiaDevicePlugin(nvidia_smi=_smi(tmp_path / f"smi{n}", _cards(n)))
        (tg,) = card.fingerprint()
        assert (tg.vendor, tg.type, tg.name) == ("nvidia", "gpu", H100)
        assert [d.id for d in tg.instances] == UUIDS[:n]
        assert [d.healthy for d in tg.instances] == [d.healthy for d in jg.instances]
        assert tg.attributes["driver_version"].string_val == "580.159.03"
        assert (tg.attributes["memory"].int_val, tg.attributes["memory"].unit) == (81559, "MiB")
        assert set(tg.attributes) == set(jg.attributes) | {"memory"}
        ids = [d.id for d in tg.instances][: max(1, n // 2)]
        assert card.reserve(ids) == {"env": {"CUDA_VISIBLE_DEVICES": ",".join(ids)}}
        assert tpu.reserve(ids) == {"env": {"TPU_VISIBLE_DEVICES": ",".join(ids)}}
        stats, jstats = card.stats(), tpu.stats()
        assert stats["chip_count"] == jstats["chip_count"] == n
        assert list(stats["chips"]) == UUIDS[:n]
    # two models on one host: one group each, as the reference groups them
    mixed = tdevices.NvidiaDevicePlugin(nvidia_smi=_smi(
        tmp_path / "mixed", _cards(1) + [(UUIDS[3], "NVIDIA A100", "580.159.03", 40960)]))
    assert [(g.name, [d.id for d in g.instances]) for g in mixed.fingerprint()] == [
        (H100, UUIDS[:1]), ("NVIDIA A100", UUIDS[3:])]


def test_the_card_manager_grows_shrinks_and_reserves_as_the_jax_one(tmp_path):
    """The manager over the card plugin and over the TPU plugin, the device
    set going 2 -> 4 -> 0 -> 1: the node's count attribute and devices
    follow, a shrink to none clears both, and the reserve env names the
    allocated ids."""
    fake = str(tmp_path / "dev")
    os.makedirs(fake)
    smi = tmp_path / "nvidia-smi"
    jmgr = jdevices.DeviceManager([jdevices.TPUDevicePlugin(dev_glob=os.path.join(fake, "accel*"))])
    tmgr = tdevices.DeviceManager([tdevices.NvidiaDevicePlugin(nvidia_smi=str(smi))])
    jnode = jmodel.Node(node_resources=jmodel.NodeResources())
    tnode = tmodel.Node(node_resources=tmodel.NodeResources())
    for count in (2, 4, 0, 1):
        for f in os.listdir(fake):
            os.remove(os.path.join(fake, f))
        _fake_dev(fake, count)
        _smi(smi, _cards(count))
        assert tmgr.fingerprint_node(tnode) == jmgr.fingerprint_node(jnode) == (1 if count else 0)
        assert tnode.attributes.get("device.nvidia.gpu.count") == jnode.attributes.get(
            "device.google.tpu.count") == (str(count) if count else None)
        assert len(tnode.node_resources.devices) == len(jnode.node_resources.devices)
        assert [len(g.instances) for g in tnode.node_resources.devices] == [
            len(g.instances) for g in jnode.node_resources.devices]
        if count:
            ids = UUIDS[:count][-1:]
            env = tmgr.reserve_env([tmodel.AllocatedDeviceResource(
                vendor="nvidia", type="gpu", name=H100, device_ids=ids)])
            jenv = jmgr.reserve_env([jmodel.AllocatedDeviceResource(
                vendor="google", type="tpu", name="tpu", device_ids=ids)])
            assert env == {"CUDA_VISIBLE_DEVICES": ids[0]}
            assert jenv == {"TPU_VISIBLE_DEVICES": ids[0]}


def test_the_card_plugin_reads_nvidia_smi(tmp_path, monkeypatch, caplog):
    """Through a fake nvidia-smi: its CSV rows parse into the group; a query
    that fails raises, which the manager logs (no silent skip); without
    nvidia-smi on PATH (no card, as on this machine) nothing is found; the
    default plugin list holds the card's plugin in the TPU plugin's place."""
    ok = tdevices.NvidiaDevicePlugin(nvidia_smi=_smi(tmp_path / "ok", _cards(2)))
    (group,) = ok.fingerprint()
    assert [d.id for d in group.instances] == UUIDS[:2] and group.name == H100
    failing = tmp_path / "failing"
    failing.write_text("#!/bin/sh\necho 'NVIDIA-SMI has failed' >&2; exit 9\n")
    failing.chmod(0o755)
    bad = tdevices.NvidiaDevicePlugin(nvidia_smi=str(failing))
    with pytest.raises(RuntimeError, match="nvidia-smi failed"):
        bad.fingerprint()
    node = tmodel.Node(node_resources=tmodel.NodeResources())
    with caplog.at_level("ERROR", logger="nomad_tpu.client.devices"):
        assert tdevices.DeviceManager([bad]).fingerprint_node(node) == 0
    assert "device plugin nvidia fingerprint failed" in caplog.text
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert [type(p) for p in tdevices.DeviceManager().plugins] == [tdevices.NvidiaDevicePlugin]
    assert tdevices.NvidiaDevicePlugin().fingerprint() == []
    assert tdevices.NvidiaDevicePlugin().stats() == {}
    assert [type(p) for p in jdevices.DeviceManager().plugins] == [jdevices.TPUDevicePlugin]


def _device_job(model, device: str, var: str):
    job = jmock.batch_job()
    job.id = "device-job"
    tg = job.task_groups[0]
    tg.count = 1
    task = tg.tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh", "args": ["-c", f"echo -n ${var} > device_env"]}
    task.resources.networks = []
    task.resources.devices = [jmodel.RequestedDevice(name=device, count=1)]
    return model.Job.from_dict(job.to_dict())


def test_a_device_job_gets_its_reserved_card_as_the_jax_job_its_chip(tmp_path):
    """End to end on one client: the node fingerprints two fake cards (two
    fake TPU chips for the JAX package), a job asks for one, is placed
    through the device checker and allocator, and its task's env holds the
    reserved id in CUDA_VISIBLE_DEVICES (TPU_VISIBLE_DEVICES)."""
    fake = _fake_dev(str(tmp_path), 2)
    before = set(threading.enumerate())
    got = {}
    for port in (False, True):
        if port:
            server = TServer({"seed": 42, "heartbeat_ttl": 600.0}, device="cpu")
            plugin = tdevices.NvidiaDevicePlugin(nvidia_smi=_smi(tmp_path / "smi", _cards(2)))
            job, var = _device_job(tmodel, "nvidia/gpu", "CUDA_VISIBLE_DEVICES"), "CUDA"
            data_dir = str(tmp_path / "port")
            client = TClient(server, data_dir=data_dir, device_plugins=[plugin])
        else:
            server = JServer({"seed": 42, "heartbeat_ttl": 600.0})
            plugin = jdevices.TPUDevicePlugin(dev_glob=fake)
            job, var = _device_job(jmodel, "tpu", "TPU_VISIBLE_DEVICES"), "TPU"
            data_dir = str(tmp_path / "jax")
            client = JClient(server, data_dir=data_dir, device_plugins=[plugin])
        try:
            server.start(num_workers=1, wait_for_leader=5.0)
            client.start()
            server.job_register(job)
            deadline = time.monotonic() + 30
            while True:
                allocs = server.state.allocs_by_job(job.namespace, job.id)
                if allocs and allocs[0].client_status in ("complete", "failed"):
                    break
                assert time.monotonic() < deadline
                time.sleep(0.02)
            (alloc,) = allocs
            (reserved,) = alloc.allocated_resources.tasks["web"].devices
            with open(os.path.join(data_dir, "allocs", alloc.id, "web", "device_env")) as f:
                env = f.read()
            ids = [d.id for g in client.node.node_resources.devices for d in g.instances]
            got[var] = (alloc.client_status, len(reserved.device_ids), env == reserved.device_ids[0],
                        reserved.device_ids[0] in ids, len(ids))
        finally:
            client.stop()
            server.stop()
    assert got["CUDA"] == got["TPU"] == ("complete", 1, True, True, 2)
    wheels = {w._thread for w in (jbroker.shared_timer_wheel(), tbroker.shared_timer_wheel())}
    deadline = time.monotonic() + 10
    while [t for t in set(threading.enumerate()) - before - wheels if t.is_alive()]:
        assert time.monotonic() < deadline, [t.name for t in set(threading.enumerate()) - before]
        time.sleep(0.05)
