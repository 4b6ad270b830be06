"""PyTorch/CUDA port of the nomad_tpu device tier.

The JAX package ``nomad_tpu`` stays the reference; this package carries
its own copies of what it needs and imports neither ``jax`` nor anything
of ``nomad_tpu``. Entry points run on the CUDA card unless the caller
asks for the CPU, where the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller passes
    ``"cpu"`` (or a CPU ``torch.device``/tensor). Raises when CUDA is asked
    for and the machine has none; there is no fallback to the CPU."""
    if isinstance(device, torch.Tensor):
        device = device.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nomad_tpu_torch: CUDA was asked for and no CUDA device is "
            "available; pass device='cpu' to run the plain versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"nomad_tpu_torch runs on cuda or cpu, not {dev}")
    return dev
