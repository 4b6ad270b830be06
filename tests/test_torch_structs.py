"""The port's copies of the data model and the state store.

Objects cross between the packages as ``to_dict()`` documents only: a
JAX-package mock object's document, read back by the port's ``from_dict``,
gives the same document again. The computed node class agrees, and a state
carried across (``nomad_tpu_torch.state.carry``) lists the ready nodes of
each datacenter set in the same order, which the scheduler's seeded
shuffle starts from. The committed planes, which the port grows in place
at a node's first registration, equal a cold rebuild and the JAX store's.
"""

import random

import pytest
from torch_for_tests import gil_handoff  # noqa: F401

from nomad_tpu import mock as jmock
from nomad_tpu.state import StateStore as JStore
from nomad_tpu.structs import compute_class as jcompute_class
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.state.carry import carry_state
from nomad_tpu_torch.structs import compute_class as tcompute_class
from nomad_tpu_torch.structs import model as tmodel

#: mock factory -> the port's class of what it makes
OBJECTS = {
    "node": tmodel.Node,
    "tpu_node": tmodel.Node,
    "nvidia_node": tmodel.Node,
    "job": tmodel.Job,
    "batch_job": tmodel.Job,
    "system_job": tmodel.Job,
    "periodic_job": tmodel.Job,
    "evaluation": tmodel.Evaluation,
    "alloc": tmodel.Allocation,
    "batch_alloc": tmodel.Allocation,
    "deployment": tmodel.Deployment,
}


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_documents_cross_without_loss(name):
    doc = getattr(jmock, name)().to_dict()
    assert OBJECTS[name].from_dict(doc).to_dict() == doc


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_the_port_mock_makes_the_same_documents(name):
    """The port's fixtures build what the JAX package's build, up to the
    fresh ids and times each call mints."""
    fresh = ("id", "eval_id", "node_id", "job_id", "deployment_id", "secret_id",
             "create_time", "modify_time", "status_updated_at", "submit_time",
             "name", "previous_alloc", "wait_until")

    def strip(d):
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items() if k not in fresh}
        if isinstance(d, list):
            return [strip(x) for x in d]
        return d

    assert strip(getattr(tmock, name)().to_dict()) == strip(getattr(jmock, name)().to_dict())


def _varied_nodes(n, seed):
    rng = random.Random(seed)
    nodes = []
    for i in range(n):
        node = jmock.tpu_node() if i % 5 == 0 else jmock.node()
        node.attributes["rack"] = rng.choice(["r1", "r2", "r3"])
        node.meta["ssd"] = rng.choice(["true", "false"])
        node.node_resources.cpu.cpu_shares = rng.choice([2000, 4000, 8000])
        node.datacenter = rng.choice(["dc1", "dc2", "dc3"])
        if i % 7 == 0:
            node.status = "down"
        if i % 11 == 0:
            node.scheduling_eligibility = "ineligible"
        nodes.append(node)
    return nodes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_class_agrees(seed):
    for node in _varied_nodes(30, seed):
        jcompute_class(node)
        port = tmodel.Node.from_dict(node.to_dict())
        port.computed_class = ""
        tcompute_class(port)
        assert port.computed_class == node.computed_class


@pytest.mark.parametrize("bulk", [False, True], ids=["node_by_node", "one_transaction"])
@pytest.mark.parametrize("dcs", [["dc1"], ["dc2", "dc3"], ["dc1", "dc2", "dc3"], ["dc9"]])
def test_carried_state_lists_ready_nodes_in_the_same_order(dcs, bulk):
    nodes = _varied_nodes(40, 7)
    store = JStore()
    records = []
    if bulk:  # the nodes in one transaction at one index, in list order
        records.append((len(nodes), "nodes", [node.to_dict() for node in nodes]))
        store.upsert_nodes(len(nodes), nodes)
    for index, node in enumerate([] if bulk else nodes, start=1):
        records.append((index, "node", node.to_dict()))
        store.upsert_node(index, node)
    job = jmock.job()
    records.append((len(nodes) + 1, "job", job.to_dict()))
    store.upsert_job(len(nodes) + 1, job)
    allocs = []
    for node in nodes[:6]:
        a = jmock.alloc()
        a.node_id, a.job_id, a.job = node.id, job.id, job
        allocs.append(a)
    records.append((len(nodes) + 2, "allocs", [a.to_dict() for a in allocs]))
    store.upsert_allocs(len(nodes) + 2, allocs)
    ev = jmock.evaluation()
    records.append((len(nodes) + 3, "evals", [ev.to_dict()]))
    store.upsert_evals(len(nodes) + 3, [ev])

    carried = carry_state(records)
    want_nodes, want_by_dc = store.snapshot().ready_nodes_in_dcs(dcs)
    got_nodes, got_by_dc = carried.snapshot().ready_nodes_in_dcs(dcs)
    assert [n.id for n in got_nodes] == [n.id for n in want_nodes]
    assert got_by_dc == want_by_dc
    assert [n.to_dict() for n in got_nodes] == [n.to_dict() for n in want_nodes]
    assert carried.latest_index() == store.latest_index()
    for a in allocs:
        assert carried.alloc_by_id(a.id).to_dict() == store.alloc_by_id(a.id).to_dict()
    assert carried.eval_by_id(ev.id).to_dict() == store.eval_by_id(ev.id).to_dict()


def test_carry_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        carry_state([(1, "deployment", {})])


def test_planes_grown_in_place_equal_a_rebuild_and_the_jax_store():
    """A node's first registration appends its rows to the committed
    planes instead of rebuilding the node axis: after every write the
    port's live planes equal a cold rebuild of the same generation and
    the JAX store's planes, and the axis epoch moves as the JAX store's
    does, through first registrations (one and several a transaction,
    with allocs already on the new nodes), a re-registration with new
    resources, a status flap and a deletion."""
    from nomad_tpu_torch.state.planes import CommittedPlanes

    jstore, tstore = JStore(), carry_state([])
    index = 0

    def write(method, *args, port_args=None):
        """One write at the next index to both stores; the port's gets
        ``port_args`` (the documents read back by its classes) where given."""
        nonlocal index
        index += 1
        getattr(jstore, method)(index, *args)
        getattr(tstore, method)(index, *(args if port_args is None else port_args))
        gen = tstore.snapshot()._gen
        blob = tstore.planes.persist_for(gen)
        assert blob == CommittedPlanes.build_blob(gen)
        assert blob == jstore.planes.persist_for(jstore.snapshot()._gen)
        assert tstore.planes.epoch == jstore.planes.epoch

    def port(objs, cls=tmodel.Node):
        return [cls.from_dict(o.to_dict()) for o in objs]

    nodes = _varied_nodes(12, 3)
    for node in nodes[:5]:
        write("upsert_node", node, port_args=port([node]))
    job = jmock.job()
    write("upsert_job", job, port_args=port([job], tmodel.Job))
    # allocs on registered nodes and on two nodes that register later
    allocs = []
    for node in nodes[:3] + nodes[5:7]:
        a = jmock.alloc()
        a.node_id, a.job_id, a.job = node.id, job.id, job
        allocs.append(a)
    write("upsert_allocs", allocs, port_args=[port(allocs, tmodel.Allocation)])
    for node in nodes[5:7]:
        write("upsert_node", node, port_args=port([node]))
    write("upsert_nodes", nodes[7:10], port_args=[port(nodes[7:10])])
    write("update_node_status", nodes[1].id, "down", 7)
    write("upsert_node", nodes[10], port_args=port([nodes[10]]))
    changed = nodes[2].copy()
    changed.node_resources.cpu.cpu_shares += 1000
    write("upsert_node", changed, port_args=port([changed]))
    write("delete_node", nodes[4].id)
    write("upsert_node", nodes[11], port_args=port([nodes[11]]))
    assert len(tstore.planes.nodes) == 11
