"""The port's mesh dry run (``nomad_tpu_torch.tpu.multichip``) on the CPU.

``dryrun_multichip`` is the counterpart of ``__graft_entry__.dryrun_multichip``:
one batch of 512 allocs over 1,024 nodes through the exact scan with its
node axis split over S shards, which must place every alloc on the nodes
the unsharded scan picks. On the CPU the sharded plain version runs (the
card's run is ``chip_smoke.py``'s phase 12); its placements must also be
the JAX package's unsharded scan's on the same example batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

import __graft_entry__ as graft
from nomad_tpu.tpu import kernel as jk
from nomad_tpu_torch.tpu import kernel as tk
from nomad_tpu_torch.tpu import multichip, shard


def test_example_batch_is_the_graft_entry_batch():
    args, init = multichip.example_batch()
    jargs, jinit = graft._example_batch(n_nodes=1024, n_allocs=512)
    for name, got, want in zip(tk.BatchArgs._fields, args, jargs):
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype, name
    for name, got, want in zip(tk.BatchState._fields, init, jinit):
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def jax_placements():
    """The JAX package's unsharded scan on the dry run's batch."""
    args, init = multichip.example_batch()
    with jk.deterministic_scope():
        _, placements = jk.plan_batch(jk.BatchArgs(*[jnp.asarray(a) for a in args]),
                                      jk.BatchState(*[jnp.asarray(x) for x in init]), 1024)
    return np.asarray(placements)


@pytest.mark.parametrize("n_shards", [8, 4])
def test_dryrun_places_every_alloc_as_the_unsharded_scan(n_shards, jax_placements):
    before = dict(tk.LAUNCHES)
    report = multichip.dryrun_multichip(n_shards, device="cpu")
    assert report["shards"] == n_shards and report["nodes"] == 1024
    assert report["placed"] == report["allocs"] == 512 and report["mismatches"] == 0
    np.testing.assert_array_equal(report["placements"], jax_placements)
    assert tk.LAUNCHES == before  # the plain versions launch nothing
    assert shard.active_mesh() is None  # the dry run leaves the process mesh alone


def test_dryrun_rounds_nodes_up_to_a_shard_multiple():
    report = multichip.dryrun_multichip(3, device="cpu")
    assert report["nodes"] == 1026 and report["placed"] == 512
