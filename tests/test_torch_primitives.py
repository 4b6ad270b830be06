"""The score primitives' public wrappers (``kernel.binpack``,
``class_boosts``, ``scores``, ``rot_incl``) on the CPU, against the JAX
package's ``_binpack``, ``_class_boosts``, ``_scores`` and ``_rot_incl``.

On the CPU each wrapper runs its plain version; on the card it launches
``csrc/primitives.cu`` (held against the plain version in
``tests/test_torch_gpu.py``). Float outputs are compared as bits.
"""

import jax
import numpy as np
import pytest
from torch_for_tests import gil_handoff, torch  # noqa: F401

from nomad_tpu.tpu import kernel as jk
from nomad_tpu.tpu import multichip as mc
from nomad_tpu_torch.tpu import kernel as tk


def _det(name, fn, *args):
    with jk.deterministic_scope():
        out, _ = jk._dispatch(name, jax.jit(fn), args, name)
    return np.asarray(out)


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_binpack_wrapper_matches_jax():
    rng = np.random.default_rng(11)
    fc = rng.uniform(-1.5, 1.0, 20_000).astype(np.float32)
    fm = rng.uniform(-1.5, 1.0, 20_000).astype(np.float32)
    want = _det("binpack", jk._binpack, fc, fm)
    got = tk.binpack(torch.from_numpy(fc), torch.from_numpy(fm)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("even,active,V", [(False, True, 4), (True, True, 4), (False, False, 4),
                                           (True, True, 40)])
def test_class_boosts_wrapper_matches_jax(even, active, V):
    rng = np.random.default_rng(V + 2 * even + active)
    counts = rng.integers(0, 9, V).astype(np.int32)
    present = rng.random(V) < 0.7
    desired = np.where(rng.random(V) < 0.8, rng.uniform(1, 20, V), -1.0).astype(np.float32)
    flags = (np.float32(-1.0), np.float32(0.5), np.bool_(even), np.bool_(active))
    want = _det("class_boosts", jk._class_boosts, counts, present, desired, *flags)
    got = tk.class_boosts(*(torch.from_numpy(np.asarray(a)) for a in
                            (counts, present, desired, *flags))).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("g", [0, 2])
def test_scores_wrapper_matches_plain(g):
    args, init = mc.wavefront_problem(mc.build_cluster(300, 64, seed=12), n_groups=4)
    a, s = tk.from_numpy(args, "cpu"), tk.from_numpy(init, "cpu")
    demand = a.demands[g]
    np.testing.assert_array_equal(_bits(tk.scores(a, s, g, demand).numpy()),
                                  _bits(tk._scores(a, s, g, demand).numpy()))


@pytest.mark.parametrize("offset", [0, 1, 777, 9_999])
def test_rot_incl_wrapper_matches_jax(offset):
    rng = np.random.default_rng(offset)
    x = rng.random(10_000) < 0.3
    positions = np.arange(10_000, dtype=np.int32)
    want = np.asarray(jax.jit(jk._rot_incl)(x, offset, int(x.sum()), positions))
    np.testing.assert_array_equal(tk.rot_incl(torch.from_numpy(x), offset).numpy(), want)
