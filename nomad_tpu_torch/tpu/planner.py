"""Plan one eval's columnar planes: the port's device entry point.

Counterpart of the planner dispatch in
``TPUBatchScheduler._kernel_placements`` (nomad_tpu/tpu/batch_sched.py,
lines 686-960): pad the planes the way the scheduler pads them, pick the
planner with the same predicates (``runs`` for one group with spread or
affinity and an unbounded limit, ``windowed`` for one group with a bounded
limit and neither, the exact scan for everything else), build that
planner's args and launch it. Two config stanzas reroute as the
scheduler's do: a windowed eval whose node planes exceed the paging
budget goes to the paged planner (``paging.should_page``, mode
``paged``), and with the wavefront on the exact scan's place is taken by
the wavefront planner (mode ``wavefront``). There is no fallback: a
kernel failure raises. ``launch_eval`` launches without waiting for the
card, so the port's ``tpu-batch`` scheduler (``batch_sched.py``) builds
its allocation templates while the planner runs; it degrades an eval to
its exact-np oracle only on ``kernel.KernelFault``.

The planes are numpy arrays under the ``BatchArgs`` field names (G groups,
E evals), plus ``used0`` [N,C], ``collisions0`` [G,N], ``counts0`` [G,V],
``present0`` [G,V] and the real node and alloc counts ``n_real`` and
``a_real``; ``problems.eval_planes`` builds them from a synthetic cluster,
the scheduler from a state snapshot. The uploads of each planner's
arg tree and the placements' sync are counted in the device ledger, at
the JAX scheduler's sites.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..debug import devprof as _devprof
from . import kernel, paging, wavefront
from .problems import bucket

# fill value of each node-axis plane's pad rows (the scheduler's: a pad
# node has no capacity, a poisoned usage and is feasible for nothing)
_NODE_PAD = {
    "capacity": 0,
    "usable": 1.0,
    "used0": 2**30,
    "feasible": False,
    "affinity": 0.0,
    "affinity_present": False,
    "node_value": -1,
    "collisions0": 0,
}
# fill value of each alloc-axis array's pad lanes
_ALLOC_PAD = {"demands": 0, "groups": 0, "limits": 0, "valid": False}


def _pad(x: np.ndarray, axis: int, size: int, fill) -> np.ndarray:
    short = size - x.shape[axis]
    if short <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = short
    return np.concatenate([x, np.full(shape, fill, dtype=x.dtype)], axis=axis)


def pad_planes(planes: dict) -> dict:
    """Pad the node axis and the alloc axis up the scheduler's bucket
    ladder; each eval's ring extends with the pad node ids."""
    out = dict(planes)
    n_rows = planes["capacity"].shape[0]
    N = bucket(n_rows)
    A = bucket(planes["demands"].shape[0])
    for name, fill in _NODE_PAD.items():
        axis = 0 if name in ("capacity", "usable", "used0") else 1
        out[name] = _pad(np.asarray(planes[name]), axis, N, fill)
    tail = np.broadcast_to(np.arange(n_rows, N, dtype=np.int32), (planes["perm"].shape[0], N - n_rows))
    out["perm"] = np.concatenate([np.asarray(planes["perm"], dtype=np.int32), tail], axis=1)
    for name, fill in _ALLOC_PAD.items():
        out[name] = _pad(np.asarray(planes[name]), 0, A, fill)
    return out


def choose_mode(planes: dict, exact_only: bool = False) -> str:
    """``runs``, ``windowed``, ``paged``, ``exact-scan`` or ``wavefront``, by
    the scheduler's predicates (batch_sched.py:690, :768, :785 and :917)
    on padded planes; ``exact_only`` (the scheduler's ``EXACT_ONLY``)
    leaves out the runs and windowed planners."""
    G = planes["feasible"].shape[0]
    E = planes["perm"].shape[0]
    exact = "wavefront" if wavefront.enabled() else "exact-scan"
    if exact_only or G != 1 or E != 1:
        return exact
    has_aff_or_spread = bool(planes["affinity_present"][0].any() or planes["spread_active"][0])
    limit, n_real, a_real = int(planes["limits"][0]), planes["n_real"], planes["a_real"]
    if has_aff_or_spread and a_real > 64 and limit >= n_real:
        return "runs"
    if not has_aff_or_spread and a_real > 0 and limit < n_real:
        N, C = planes["capacity"].shape
        return "paged" if paging.should_page(N, C) else "windowed"
    return exact


def exact_inputs(p: dict, device) -> tuple:
    """(BatchArgs, BatchState) of the exact scan over padded planes."""
    args = {f: p[f] for f in kernel.BatchArgs._fields}
    state = dict(
        used=p["used0"],
        collisions=p["collisions0"],
        spread_counts=p["counts0"],
        spread_present=p["present0"],
        offset=np.zeros(p["perm"].shape[0], np.int32),
    )
    _devprof.count_tree_h2d((args, state))
    return kernel.from_numpy(args, device), kernel.from_numpy(state, device)


def runs_inputs(p: dict, device) -> tuple:
    """(RunArgs, init) of the run planner: node planes in rotation order."""
    perm = p["perm"][0]
    args = dict(
        capacity=p["capacity"][perm],
        usable=p["usable"][perm],
        feasible=p["feasible"][0][perm],
        affinity=p["affinity"][0][perm],
        affinity_present=p["affinity_present"][0][perm],
        group_count=p["group_count"][0],
        node_value=p["node_value"][0][perm],
        spread_desired=p["spread_desired"][0],
        spread_implicit=p["spread_implicit"][0],
        spread_weight_frac=p["spread_weight_frac"][0],
        spread_even=p["spread_even"][0],
        spread_active=p["spread_active"][0],
        perm=perm,
        demand=p["demands"][0],
        n_allocs=np.int32(p["a_real"]),
    )
    init = (p["used0"][perm], p["collisions0"][0][perm], p["counts0"][0], p["present0"][0])
    _devprof.count_tree_h2d((args, init))
    return kernel.from_numpy(args, device), kernel.from_numpy(init, device)


def window_inputs(p: dict, device) -> tuple:
    """(WindowArgs, used0, collisions0) of the windowed planner."""
    args = dict(
        capacity=p["capacity"],
        usable=p["usable"],
        feasible=p["feasible"][0],
        perm=p["perm"][0],
        demand=p["demands"][0],
        group_count=p["group_count"][0],
        limit=p["limits"][0],
        n_allocs=np.int32(p["a_real"]),
    )
    _devprof.count_tree_h2d((args, p["used0"], p["collisions0"][0]))
    used0, coll0 = kernel.from_numpy((p["used0"], p["collisions0"][0]), device)
    return kernel.from_numpy(args, device), used0, coll0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event(device: torch.device):
    """A CUDA event recorded now on the current stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@dataclass
class PendingPlan:
    """A launched plan: its mode, padded sizes, kernel launches and the
    paged planner's ``extra`` stats are known at launch; ``wait()`` syncs
    and returns what ``plan_eval`` returns. ``events`` are the CUDA events
    recorded around the launch on the card (None on the CPU)."""

    mode: str
    n_pad: int
    a_pad: int
    launches: int
    extra: dict
    placements: torch.Tensor
    rounds: object  # an int, or a device scalar read at the sync
    a_real: int
    t0: float
    device: torch.device
    events: object = None

    def wait(self):
        _sync(self.device)
        if self.mode != "paged":
            # the placements' device-to-host copy (the paged route's
            # placements are host numpy already)
            _devprof.count_d2h(self.placements.numel() * self.placements.element_size())
        kernel_s = time.perf_counter() - self.t0
        device_s = None
        if self.events is not None:
            start, end = self.events
            device_s = start.elapsed_time(end) / 1e3
        stats = dict(
            mode=self.mode,
            rounds=int(self.rounds),
            kernel_s=kernel_s,
            device_s=device_s,
            launches=self.launches,
            **self.extra,
        )
        return self.placements[: self.a_real].cpu().numpy(), stats


def launch_eval(planes: dict, device=None, exact_only: bool = False) -> PendingPlan:
    """Pad the planes, choose the planner and launch it without waiting for
    the card (the paged planner's host-driven tile stream waits inside).
    A kernel's refusal of its input raises ``kernel.KernelFault`` here,
    before any launch."""
    dev = resolve_device(device)
    p = pad_planes(planes)
    mode = choose_mode(p, exact_only)
    n_real, a_real = p["n_real"], p["a_real"]
    A = p["demands"].shape[0]
    N = p["capacity"].shape[0]
    before = sum(kernel.LAUNCHES.values())
    extra = {}
    if mode == "paged":
        t0, start = time.perf_counter(), _event(dev)
        placements, rounds, pstats = paging.plan_batch_paged(
            p["capacity"], p["usable"], p["feasible"][0], p["perm"][0], p["demands"][0],
            int(p["group_count"][0]), int(p["limits"][0]), a_real, p["used0"],
            p["collisions0"][0], n_real, A, device=dev,
        )
        placements = torch.from_numpy(placements)
        extra = {k: v for k, v in pstats.items() if k != "rounds"}
        N = pstats["n_pad"]
    elif mode == "runs":
        args, init = runs_inputs(p, dev)
        _sync(dev)
        t0, start = time.perf_counter(), _event(dev)
        placements, rounds = kernel.plan_batch_runs(args, init, A, bool(p["spread_even"][0]),
                                                    n_valid=a_real)
    elif mode == "windowed":
        args, used0, coll0 = window_inputs(p, dev)
        _sync(dev)
        t0, start = time.perf_counter(), _event(dev)
        placements, rounds = kernel.plan_batch_windowed(args, used0, coll0, n_real, A,
                                                        n_valid=a_real)
    elif mode == "wavefront":
        args, state = exact_inputs(p, dev)
        _sync(dev)
        t0, start = time.perf_counter(), _event(dev)
        _, placements, rounds = wavefront.plan_batch_wavefront(args, state, n_real, n_valid=a_real)
    else:
        args, state = exact_inputs(p, dev)
        _sync(dev)
        t0, start = time.perf_counter(), _event(dev)
        _, placements = kernel.plan_batch(args, state, n_real, n_valid=a_real)
        rounds = a_real  # one scan step per alloc
    launches = sum(kernel.LAUNCHES.values()) - before
    events = (start, _event(dev)) if start is not None else None
    return PendingPlan(mode, N, A, launches, extra, placements, rounds, a_real, t0, dev, events)


def plan_eval(planes: dict, device=None):
    """Plan one eval; returns (node id per real alloc, -1 = unplaced, as
    numpy int32; stats ``{mode, rounds, kernel_s, device_s, launches}``,
    and for the paged planner its tile cache's stats with ``tiles``,
    ``tile_nodes`` and ``n_pad``). ``kernel_s`` is the planner call on the
    device, from launch to synchronized result (for the paged planner the
    whole host-driven tile stream); ``device_s`` the same span by CUDA
    events on the card (None on the CPU); ``launches`` counts the kernel
    launches it made (0 on the CPU)."""
    return launch_eval(planes, device).wait()
