"""Deterministic chaos/test harness: the fault-injection plane
(``faults``) and the cluster-invariant checker (``invariants``).

The production seams (rpc, raft transport, worker, plan applier, TPU
kernel dispatch) consult this package through a single module-level
``faults.ACTIVE`` pointer — a ``None`` check when no plane is installed,
so the cost in production is one attribute read per fault point.
"""
