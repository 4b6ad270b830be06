"""Build a state store from ``to_dict()`` documents.

The scheduler's placements depend on the store's contents and on its
iteration order (``ready_nodes_in_dcs`` lists nodes in insertion order,
and the seeded shuffle starts from that list), so a store carried across
from another process or package must receive the same documents in the
same order at the same raft indexes. ``carry_state`` does that from plain
dicts: it takes no object of another package, only the documents that
``Base.to_dict`` makes.
"""

from __future__ import annotations

from typing import Iterable

from ..structs.model import Allocation, Evaluation, Job, Node
from .store import StateStore

#: record kind -> (model class, whether the record holds a list of documents)
KINDS = {
    "node": (Node, False),
    "nodes": (Node, True),
    "job": (Job, False),
    "allocs": (Allocation, True),
    "evals": (Evaluation, True),
}


def carry_state(records: Iterable[tuple]) -> StateStore:
    """Insert ``records`` in order into a new state store and return it.
    Each record is ``(index, kind, doc)``: ``kind`` ``"node"``
    or ``"job"`` with one document, or ``"nodes"``, ``"allocs"`` or
    ``"evals"`` with a list of documents written in one transaction at
    ``index``, in list order."""
    store = StateStore()
    for index, kind, doc in records:
        if kind not in KINDS:
            raise ValueError(f"unknown record kind {kind!r}")
        cls, many = KINDS[kind]
        if many:
            objs = [cls.from_dict(d) for d in doc]
            if kind == "nodes":
                store.upsert_nodes(index, objs)
            elif kind == "allocs":
                store.upsert_allocs(index, objs)
            else:
                store.upsert_evals(index, objs)
        elif kind == "node":
            store.upsert_node(index, cls.from_dict(doc))
        else:
            store.upsert_job(index, cls.from_dict(doc))
    return store
