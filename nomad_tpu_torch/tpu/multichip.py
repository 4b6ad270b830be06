"""The mesh dry run: one sharded exact-scan batch equal to the unsharded one.

The port's counterpart of ``__graft_entry__.dryrun_multichip`` (and the
first part of ``nomad_tpu/tpu/multichip.py``): the exact scan's node axis
split over ``n_shards`` shards (``tpu/shard.py``'s ``batch_specs``), one
full batch of 512 placements over 1,024 nodes through the sharded kernel
(``csrc/mesh.cu``; its sharded plain version on the CPU), checked
placement for placement against the unsharded scan on the same inputs.
The JAX module's scored multichip bench, artifact writer and XLA stderr
filter are ROADMAP A12b-2.
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from . import kernel, shard


def example_batch(n_nodes: int = 1024, n_allocs: int = 512, n_groups: int = 1,
                  n_values: int = 4):
    """The dry run's (BatchArgs, BatchState) as numpy arrays: seeded nodes
    of three resource columns, one group spread over ``n_values`` values
    by target, every node feasible (``__graft_entry__._example_batch``)."""
    rng = np.random.default_rng(0)
    capacity = np.stack(
        [
            rng.integers(2000, 8000, n_nodes),
            rng.integers(4096, 16384, n_nodes),
            np.full(n_nodes, 100 * 1024),
        ],
        axis=1,
    ).astype(np.int32)
    reserved = np.tile(np.array([100, 256, 4096], dtype=np.int32), (n_nodes, 1))
    usable = (capacity[:, :2] - reserved[:, :2]).astype(np.float32)

    args = kernel.BatchArgs(
        capacity=capacity,
        usable=usable,
        feasible=np.ones((n_groups, n_nodes), dtype=bool),
        affinity=np.zeros((n_groups, n_nodes), dtype=np.float32),
        affinity_present=np.zeros((n_groups, n_nodes), dtype=bool),
        group_count=np.full(n_groups, n_allocs, dtype=np.int32),
        group_eval=np.zeros(n_groups, dtype=np.int32),
        node_value=np.tile(np.arange(n_nodes, dtype=np.int32) % n_values, (n_groups, 1)),
        spread_desired=np.full((n_groups, n_values), float(n_allocs) / n_values,
                               dtype=np.float32),
        spread_implicit=np.full(n_groups, -1.0, dtype=np.float32),
        spread_weight_frac=np.ones(n_groups, dtype=np.float32),
        spread_even=np.zeros(n_groups, dtype=bool),
        spread_active=np.ones(n_groups, dtype=bool),
        perm=rng.permutation(n_nodes).astype(np.int32)[None, :],
        ring=np.array([n_nodes], dtype=np.int32),
        demands=np.tile(np.array([100, 128, 10], dtype=np.int32), (n_allocs, 1)),
        groups=np.zeros(n_allocs, dtype=np.int32),
        limits=np.full(n_allocs, n_nodes, dtype=np.int32),
        valid=np.ones(n_allocs, dtype=bool),
    )
    init = kernel.BatchState(
        used=reserved.copy(),
        collisions=np.zeros((n_groups, n_nodes), dtype=np.int32),
        spread_counts=np.zeros((n_groups, n_values), dtype=np.int32),
        spread_present=np.zeros((n_groups, n_values), dtype=bool),
        offset=np.zeros(1, dtype=np.int32),
    )
    return args, init


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """Split the exact scan's node axis over ``n_shards`` shards on
    ``device`` (CUDA unless the caller asks for the CPU) and run one full
    batch of 512 allocs over 1,024 nodes (rounded up to a multiple of the
    shards); every alloc must place, on the nodes the unsharded scan picks.
    Returns the run's sizes, counts and placements (numpy); raises
    ``AssertionError`` when the placements diverge."""
    dev = resolve_device(device)
    n_allocs = 512
    n_nodes = max(1024, n_shards)
    if n_nodes % n_shards:
        n_nodes = ((n_nodes // n_shards) + 1) * n_shards
    args, init = example_batch(n_nodes=n_nodes, n_allocs=n_allocs)
    mesh = shard.Mesh(n_shards, dev)
    aspec, sspec = shard.batch_specs()
    _, got = kernel.plan_batch(shard.put(args, aspec, mesh), shard.put(init, sspec, mesh),
                               n_nodes)
    got = got.cpu().numpy()
    placed = int((got >= 0).sum())
    assert placed == n_allocs, f"expected {n_allocs} placements, got {placed}"
    _, want = kernel.plan_batch(kernel.from_numpy(args, dev), kernel.from_numpy(init, dev),
                                n_nodes)
    mismatches = int((want.cpu().numpy() != got).sum())
    assert mismatches == 0, (
        f"sharded placements diverge from unsharded at {mismatches}/{n_allocs} positions"
    )
    return dict(shards=n_shards, nodes=n_nodes, allocs=n_allocs, placed=placed,
                mismatches=mismatches, placements=got)
