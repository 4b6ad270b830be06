"""Server-side pieces of the port, counterpart of ``nomad_tpu.core``:
``plan_apply`` (the device part of the plan applier's dense verify)."""
