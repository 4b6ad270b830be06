"""Import hygiene of the port: it never loads JAX or the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu_torch import resolve_device
from nomad_tpu_torch.core import plan_apply
from nomad_tpu_torch.tpu import drain, mirror, paging, planner, problems

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "nomad_tpu_torch")
MODULES = [
    "nomad_tpu_torch",
    "nomad_tpu_torch.tpu",
    "nomad_tpu_torch.tpu.problems",
    "nomad_tpu_torch.tpu.exact_np",
    "nomad_tpu_torch.tpu.kernel",
    "nomad_tpu_torch.tpu.planner",
    "nomad_tpu_torch.tpu._build",
    "nomad_tpu_torch.tpu.columnar",
    "nomad_tpu_torch.tpu.mirror",
    "nomad_tpu_torch.tpu.drain",
    "nomad_tpu_torch.tpu.wavefront",
    "nomad_tpu_torch.tpu.paging",
    "nomad_tpu_torch.core",
    "nomad_tpu_torch.core.plan_apply",
    "nomad_tpu_torch.structs",
    "nomad_tpu_torch.structs.attribute",
    "nomad_tpu_torch.structs.bitmap",
    "nomad_tpu_torch.structs.model",
    "nomad_tpu_torch.structs.network",
    "nomad_tpu_torch.structs.node_class",
    "nomad_tpu_torch.structs.devices",
    "nomad_tpu_torch.structs.funcs",
    "nomad_tpu_torch.native",
    "nomad_tpu_torch.state",
    "nomad_tpu_torch.state.planes",
    "nomad_tpu_torch.state.store",
    "nomad_tpu_torch.state.carry",
    "nomad_tpu_torch.scheduler",
    "nomad_tpu_torch.scheduler.context",
    "nomad_tpu_torch.scheduler.version",
    "nomad_tpu_torch.scheduler.feasible",
    "nomad_tpu_torch.scheduler.rank",
    "nomad_tpu_torch.scheduler.select",
    "nomad_tpu_torch.scheduler.spread",
    "nomad_tpu_torch.scheduler.propertyset",
    "nomad_tpu_torch.scheduler.preemption",
    "nomad_tpu_torch.scheduler.stack",
    "nomad_tpu_torch.scheduler.util",
    "nomad_tpu_torch.scheduler.reconcile",
    "nomad_tpu_torch.scheduler.device",
    "nomad_tpu_torch.scheduler.generic",
    "nomad_tpu_torch.scheduler.scheduler",
    "nomad_tpu_torch.scheduler.testing",
    "nomad_tpu_torch.mock",
    "nomad_tpu_torch.tpu.batch_sched",
    "nomad_tpu_torch.tpu.system_sched",
    "nomad_tpu_torch.scheduler.system",
    "nomad_tpu_torch.structs.diff",
    "nomad_tpu_torch.metrics",
    "nomad_tpu_torch.testing",
    "nomad_tpu_torch.testing.faults",
    "nomad_tpu_torch.testing.lockdep",
    "nomad_tpu_torch.trace",
    "nomad_tpu_torch.trace.span",
    "nomad_tpu_torch.trace.store",
    "nomad_tpu_torch.trace.critical_path",
    "nomad_tpu_torch.events",
    "nomad_tpu_torch.events.broker",
    "nomad_tpu_torch.raft",
    "nomad_tpu_torch.raft.log",
    "nomad_tpu_torch.raft.transport",
    "nomad_tpu_torch.raft.raft",
    "nomad_tpu_torch.debug",
    "nomad_tpu_torch.debug.flight",
    "nomad_tpu_torch.debug.watchdog",
    "nomad_tpu_torch.debug.bundle",
    "nomad_tpu_torch.debug.profiler",
    "nomad_tpu_torch.core.overload",
    "nomad_tpu_torch.core.broker",
    "nomad_tpu_torch.core.blocked_evals",
    "nomad_tpu_torch.core.worker",
    "nomad_tpu_torch.core.fsm",
    "nomad_tpu_torch.core.core_sched",
    "nomad_tpu_torch.core.deployment_watcher",
    "nomad_tpu_torch.core.drainer",
    "nomad_tpu_torch.core.periodic",
    "nomad_tpu_torch.core.vault",
    "nomad_tpu_torch.core.server",
]


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "nomad_tpu")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"the port loaded {out.stdout.strip()}"


def _python_files():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_import_in_the_port_sources():
    found = []
    for path in _python_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            found += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not found


def test_entry_points_default_to_cuda():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.zeros(1)) == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA-less refusal is not observable")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    c = problems.build_cluster(16, 4)
    planes = problems.eval_planes(*problems.exact_problem(c))
    with pytest.raises(RuntimeError, match="CUDA"):
        planner.plan_eval(planes)
    placements, stats = planner.plan_eval(planes, device="cpu")
    assert stats["mode"] == "exact-scan" and (placements >= 0).all()

    # the paged planner and its tile cache
    case = problems.paged_case(1, 100, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        paging.plan_batch_paged(*case)
    assert (paging.plan_batch_paged(*case, device="cpu")[0] >= 0).all()
    with pytest.raises(RuntimeError, match="CUDA"):
        paging.TileCache(1 << 20, None, None)

    # the server path: the drain collector, the device planes, the verify
    shared = drain.SharedCluster(c["capacity"], c["usable"], c["reserved"])
    with pytest.raises(RuntimeError, match="CUDA"):
        drain.KernelBatchCollector(shared, expected=1)
    assert drain.KernelBatchCollector(shared, expected=1, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        mirror.DeviceState(0, 16, c["capacity"], c["usable"], c["reserved"])
    ds = mirror.DeviceState(0, 16, c["capacity"], c["usable"], c["reserved"], device="cpu")
    # the verify runs where DeviceState put the planes
    rows, deltas = [1, 2], [np.zeros(4, np.int32)] * 2
    assert plan_apply.dense_verify(ds.arrays(), rows, deltas).all()


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_server_and_its_device_tier_default_to_cuda():
    """``Server()``, ``new_scheduler(...)`` and the mirror want the card
    unless given ``device="cpu"``; the stanzas that reach modules not yet
    ported raise an error that names their ROADMAP item."""
    from nomad_tpu_torch.core.server import Server
    from nomad_tpu_torch.scheduler import Harness, new_scheduler
    from nomad_tpu_torch.state import StateStore

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA-less refusal is not observable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Server()
    with pytest.raises(RuntimeError, match="CUDA"):
        mirror.ColumnarMirror(StateStore())
    assert mirror.ColumnarMirror(StateStore(), device="cpu").device.type == "cpu"
    # a kernel-sized tpu-batch eval: its planner wants the card unless the
    # scheduler was given the CPU
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.model import Evaluation

    for dev in (None, "cpu"):
        h = Harness(seed=1, device=dev)
        for _ in range(20):
            h.state.upsert_node(h.next_index(), mock.node())
        job = mock.job()
        job.task_groups[0].count = 16
        h.state.upsert_job(h.next_index(), job)
        ev = Evaluation(id=f"ev-{dev}", namespace=job.namespace, priority=job.priority,
                        type="service", triggered_by="job-register", job_id=job.id,
                        status="pending")
        h.state.upsert_evals(h.next_index(), [ev])
        sched = new_scheduler("tpu-batch", h.snapshot(), h, device=dev)
        if dev is None:
            with pytest.raises(RuntimeError, match="CUDA"):
                sched.process(ev)
        else:
            sched.process(ev)
            assert len(h.plans[0].node_allocation) > 0
    server = Server({"seed": 1}, device="cpu")
    assert server.device.type == "cpu" and server.columnar_mirror.device.type == "cpu"
    for stanza, item in (({"acl": {"enabled": True}}, "ACL"),):
        with pytest.raises(NotImplementedError, match=item):
            Server(stanza, device="cpu")
    for stanza, item in (("shard_devices", "A12"), ("prewarm_kernels", "A9")):
        s = Server({stanza: 1}, device="cpu")
        with pytest.raises(NotImplementedError, match=item):
            s.start(num_workers=0)
        s.stop()
