"""Scheduler factory + Planner protocol (ref scheduler/scheduler.go).

The factory map is where backends register. Alongside the reference's
service/batch/system schedulers, this package registers ``tpu-batch`` —
the batched backend whose placement loop runs on the port's planners and
scores allocations × nodes as dense tensors (nomad_tpu_torch/tpu/) —
``tpu-system``, the plane-batched system scheduler (host numpy over the
group planes, as in the JAX package), and ``oracle-np``, the float64
numpy oracle. ``device`` is the planners' device
(``nomad_tpu_torch.resolve_device``: CUDA unless the caller passes
``"cpu"``); the scalar and system schedulers place on the host and
ignore it.
"""

from __future__ import annotations

import random
from typing import Callable, Optional, Protocol

from ..structs.model import Evaluation, Plan, PlanResult
from .generic import GenericScheduler
from .system import SystemScheduler


class Planner(Protocol):
    """ref scheduler.go:97-130"""

    def submit_plan(self, plan: Plan) -> tuple[PlanResult, Optional[object]]:
        """Submit a plan; returns (result, refreshed-state-or-None)."""
        ...

    def update_eval(self, eval: Evaluation) -> None: ...

    def create_eval(self, eval: Evaluation) -> None: ...

    def reblock_eval(self, eval: Evaluation) -> None: ...


def _service_factory(state, planner, rng=None, device=None):
    return GenericScheduler(state, planner, batch=False, rng=rng)


def _batch_factory(state, planner, rng=None, device=None):
    return GenericScheduler(state, planner, batch=True, rng=rng)


def _system_factory(state, planner, rng=None, device=None):
    return SystemScheduler(state, planner, rng=rng)


def _tpu_batch_factory(state, planner, rng=None, device=None):
    try:
        from ..tpu.batch_sched import TPUBatchScheduler
    except ImportError as e:
        raise ValueError(f"scheduler 'tpu-batch' backend unavailable: {e}") from e

    return TPUBatchScheduler(state, planner, rng=rng, device=device)


def _tpu_system_factory(state, planner, rng=None, device=None):
    try:
        from ..tpu.system_sched import TPUSystemScheduler
    except ImportError as e:
        raise ValueError(f"scheduler 'tpu-system' backend unavailable: {e}") from e

    return TPUSystemScheduler(state, planner, rng=rng)


def _oracle_np_factory(state, planner, rng=None, device=None):
    """The vectorized oracle (tpu/exact_np.py): scalar-chain semantics in
    float64 numpy, one dense pass per placement — used by bench parity
    windows; not a production backend."""
    try:
        from ..tpu.batch_sched import TPUBatchScheduler
    except ImportError as e:
        raise ValueError(f"scheduler 'oracle-np' backend unavailable: {e}") from e

    sched = TPUBatchScheduler(state, planner, rng=rng, device=device)
    sched.exact_numpy = True
    return sched


# ref scheduler.go:23-29 BuiltinSchedulers + the batched backends
BUILTIN_SCHEDULERS: dict[str, Callable] = {
    "service": _service_factory,
    "batch": _batch_factory,
    "system": _system_factory,
    "tpu-batch": _tpu_batch_factory,
    "tpu-system": _tpu_system_factory,
    "oracle-np": _oracle_np_factory,
}


def new_scheduler(
    name: str, state, planner, rng: Optional[random.Random] = None, device=None
):
    """ref scheduler.go:34-44"""
    factory = BUILTIN_SCHEDULERS.get(name)
    if factory is None:
        raise ValueError(f"unknown scheduler '{name}'")
    return factory(state, planner, rng=rng, device=device)
