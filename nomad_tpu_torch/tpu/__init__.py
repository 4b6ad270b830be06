"""Placement planners of the port, counterpart of ``nomad_tpu.tpu``.

Float contract: the plain PyTorch versions (``kernel.py``) and the CUDA
kernels (``csrc/``) reproduce the JAX planners' float32 bits, because the
planners break ties by exact float equality among hundreds of identical
nodes and one ulp changes a placement.

- No FMA contraction: every multiply and add rounds on its own. The
  kernels build with ``--fmad=false`` and spell the score path with
  ``__fmul_rn``/``__fadd_rn``/``__fsub_rn``/``__fdiv_rn``.
- IEEE division everywhere, except one rule: XLA rewrites a division by a
  constant as a multiplication by its reciprocal, so ``x / 18.0`` in
  ``_binpack`` is ``x * float32(1/18)`` here too.
- ``jnp.round`` rounds half to even: ``torch.round`` and ``rintf``.
- ``argmin``/``argmax`` take the first index on ties; sorts compare
  floats with -0.0 equal to +0.0, as ``lax.sort`` does.
- Integer planes are int32 (JAX runs with x64 off; torch defaults to
  int64, so every conversion pins the dtype).

Modules: ``problems`` (seeded synthetic clusters and drain batches),
``exact_np`` (the float64 host oracle), ``kernel`` (args, plain versions,
kernel wrappers), ``planner`` (one eval's planner dispatch), ``wavefront``
(the wavefront planner and its stanza), ``paging`` (the paged windowed
planner, its tile cache, stanza and numpy oracle), ``columnar`` (the
columnar cluster and per-group planes built from a state snapshot),
``batch_sched`` (the ``tpu-batch`` scheduler, whose placement loop calls
``planner.launch_eval``), ``mirror`` (device-resident node planes and the
dirty-row scatter), ``drain`` (the fused multi-eval drain batch and the
per-eval usage bases) and ``_build`` (nvcc build of ``csrc/``). The
applier's dense verify is ``nomad_tpu_torch.core.plan_apply``.

The server-path kernels (usage bases, dirty-row scatter, dense verify)
are int32 scatters with a compare or a prefix: integer atomics commute,
so they are bit-identical to their plain versions with no tolerance.
"""
