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

Modules: ``problems`` (seeded synthetic clusters), ``exact_np`` (the
float64 host oracle), ``kernel`` (args, plain versions, kernel wrappers),
``planner`` (one eval's planner dispatch) and ``_build`` (nvcc build of
``csrc/``).
"""
