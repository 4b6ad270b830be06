"""Device-plane observability: the launch ledger, transfer accounting,
and the collective-round counter.

The port's copy of ``nomad_tpu/debug/devprof.py``: the same public
functions and payload keys, so ``/v1/metrics`` ``tpu_devprof``, the debug
bundle's ``device.json``, the flight recorder, the critical path and
``operator device`` read one structure. What differs on one CUDA card:

- **the compile ledger** — the port compiles nothing per shape. Its
  compile events are the kernel library's build or load
  (``tpu/_build.py``), recorded once under planner ``library`` with its
  seconds, and the first launch in the process of each ``(planner, shape
  key, sharded=False, flavor)``: that launch pays the lazy module load,
  the kernel attributes and the scratch allocation, timed by the host
  seconds of the wrapper's call with no added sync. ``flavor`` is
  ``cuda`` for a kernel and ``plain`` for the plain PyTorch version on
  the CPU. No cost analysis exists, so ``flops`` reads -1.0 and
  ``bytes_accessed`` None, and with one device every entry's collective
  census is empty;
- **transfer accounting** — :func:`device_put` is the counted upload
  (``torch`` to a device); the sites that upload arrays leaf by leaf
  count the tree with :func:`count_tree_h2d`, and the consumer sync
  points count device→host bytes, at the JAX package's sites;
- **collective-round counter** — every planner launch records its
  device-loop rounds against the placements it resolved. A round count
  still on the card is copied to pinned host memory behind the kernel
  and folds into the totals once a CUDA event recorded after the copy
  reports complete, so recording and reading never wait on a kernel.

Everything here is stdlib + numpy at import; torch is touched only for
tensors a caller hands in. Enabled by default; ``NOMAD_TPU_DEVPROF=0``
disables every counter.
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import deque

import numpy as np

_ENABLED = os.environ.get("NOMAD_TPU_DEVPROF", "1") != "0"

_lock = threading.Lock()

#: (planner, shape_key, sharded, flavor) -> ledger entry; keyed by the
#: planners' bucketed shape ladder (the reset() eviction path bounds it)
_LEDGER: dict = {}

#: per-planner dispatch/round accounting (planner-name keyed)
_ROUNDS: dict = {}

#: most recent dispatch signature per planner (span-tag lookup)
_LAST: dict = {}

_TRANSFERS = {
    "h2d_bytes": 0, "h2d_calls": 0, "d2h_bytes": 0, "d2h_calls": 0,
}

#: paged-planner tile stream accounting (tpu/paging.py's TileCache):
#: uploads = tiles sent h2d, reuploads = tiles sent AGAIN (dirty dynamic
#: refresh or re-admission after eviction — the h2d_thrash signal)
_PAGED = {
    "tile_uploads": 0, "tile_upload_bytes": 0,
    "tile_reuploads": 0, "tile_reupload_bytes": 0,
}

#: round counts whose device scalar hasn't been read yet: resolved
#: lazily and NON-blockingly (gated on a CUDA event's query) so a
#: /v1/metrics poll can never stall behind an in-flight kernel
_PENDING: deque = deque(maxlen=512)

_COMPILES = {"count": 0, "seconds": 0.0}


# ---------------------------------------------------------------------------
# enablement
# ---------------------------------------------------------------------------


#: per-thread: set while a warm-up launches kernels (tpu/warmup.py)
_LOCAL = threading.local()


def enabled() -> bool:
    return _ENABLED


def _counting() -> bool:
    """Whether this thread's transfers and rounds count: the ledger is on
    and the thread is not warming up. A warm-up's launches enter the
    launch ledger but move no counter (the JAX warm-up compiles without
    dispatching, so its counters see nothing either)."""
    return _ENABLED and not getattr(_LOCAL, "warming", False)


@contextlib.contextmanager
def warming():
    """Mark this thread's launches as warm-up for the block."""
    prior = getattr(_LOCAL, "warming", False)
    _LOCAL.warming = True
    try:
        yield
    finally:
        _LOCAL.warming = prior


def enable(on: bool = True):
    """Flip the device profiler (the bench A/B arms); returns the prior
    state so callers can restore it."""
    global _ENABLED
    prior = _ENABLED
    _ENABLED = bool(on)
    return prior


def reset():
    """Zero every counter (test isolation / bench section boundaries)."""
    with _lock:
        _LEDGER.clear()
        _ROUNDS.clear()
        _LAST.clear()
        _PENDING.clear()
        for k in _TRANSFERS:
            _TRANSFERS[k] = 0
        for k in _PAGED:
            _PAGED[k] = 0
        _COMPILES["count"] = 0
        _COMPILES["seconds"] = 0.0


# ---------------------------------------------------------------------------
# dispatch signatures
# ---------------------------------------------------------------------------


def _leaves(tree):
    if hasattr(tree, "_fields"):  # NamedTuple planner args
        for f in tree:
            yield from _leaves(f)
    elif isinstance(tree, (tuple, list)):
        for el in tree:
            yield from _leaves(el)
    elif isinstance(tree, dict):  # the port's numpy planes by field name
        for el in tree.values():
            yield from _leaves(el)
    else:
        yield tree


# ---------------------------------------------------------------------------
# the compile ledger
# ---------------------------------------------------------------------------


#: every (planner, shape_key, flavor) launched in this process, with
#: "sharded" appended for a launch over a mesh: the port's counterpart of
#: the jit caches, which reset() leaves alone
_LAUNCHED: set = set()


def forget_launches():
    """Forget what this process has launched, so the next launch of each
    ``(planner, shape, flavor)`` is a compile event again: the port's
    counterpart of clearing the JAX jit caches (``jax.clear_caches``).
    ``reset()`` keeps the set, as the JAX reset keeps its caches; a test
    whose ledger must not depend on what ran before it calls both."""
    with _lock:
        _LAUNCHED.clear()


def record_compile(
    planner: str,
    shape_key: str,
    sharded: bool,
    flavor: str,
    seconds: float,
):
    """One compile event: the kernel library's build or load, or the
    first launch of a ``(planner, shape, flavor)``. No cost analysis
    exists for a hand-written kernel, so the entry's ``flops`` reads -1.0
    and ``bytes_accessed`` None (what the JAX ledger writes when its
    analysis gives nothing); its census stays empty (one device)."""
    if not _ENABLED:
        return
    key = (planner, shape_key, bool(sharded), flavor)
    with _lock:
        entry = _LEDGER.get(key)
        if entry is None:
            entry = _LEDGER[key] = {
                "planner": planner,
                "shape": shape_key,
                "sharded": bool(sharded),
                "flavor": flavor,
                "compiles": 0,
                "compile_s": 0.0,
                "flops": -1.0,
                "bytes_accessed": None,
                "collectives": {},
                "collective_ops": 0,
                "collective_bytes": 0,
            }
        entry["compiles"] += 1
        entry["compile_s"] = round(entry["compile_s"] + seconds, 4)
        _COMPILES["count"] += 1
        _COMPILES["seconds"] += seconds


def record_launch(planner: str, shape_key: str, flavor: str,
                  seconds: float, sharded: bool = False):
    """One planner launch: its first in the process is a compile event of
    ``seconds`` (the wrapper's host time, no sync added); every launch
    updates the last-dispatch table. ``sharded``: the launch ran over a
    mesh (tpu/shard.py)."""
    key = (planner, shape_key, flavor) + (("sharded",) if sharded else ())
    with _lock:
        first = key not in _LAUNCHED
        _LAUNCHED.add(key)
    if first:
        record_compile(planner, shape_key, sharded, flavor, seconds)
    record_dispatch(planner, shape_key, sharded, flavor)


def record_dispatch(planner: str, shape_key: str, sharded: bool,
                    flavor: str = "fast"):
    """Note a planner dispatch (warm or cold) so span-tag lookups can
    find the executable's ledger entry without a compile event."""
    if not _ENABLED:
        return
    with _lock:
        _LAST[planner] = (shape_key, bool(sharded), flavor)


def dispatch_tags(planner: str) -> dict:
    """Trace-span tags for ``planner``'s most recent dispatch, from its
    ledger entry: flops / bytes / collective census totals. Empty when
    devprof is off or the executable never recorded a compile."""
    if not _ENABLED:
        return {}
    with _lock:
        last = _LAST.get(planner)
        if last is None:
            return {}
        entry = _LEDGER.get((planner, *last))
        if entry is None:
            return {}
        tags = {}
        if entry["flops"] not in (None, -1.0):
            tags["kernel_flops"] = entry["flops"]
        if entry["bytes_accessed"] is not None:
            tags["kernel_bytes"] = entry["bytes_accessed"]
        if entry["collective_ops"]:
            tags["collectives"] = entry["collective_ops"]
            tags["collective_bytes"] = entry["collective_bytes"]
        return tags


# ---------------------------------------------------------------------------
# transfer accounting
# ---------------------------------------------------------------------------


def _host_nbytes(x) -> int:
    """Bytes an upload of ``x`` moves host→device: numpy arrays and
    scalars transfer; a tensor is already where the planners read it
    (a device plane, or the CPU's own memory for the plain versions)."""
    if hasattr(x, "data_ptr"):
        return 0
    if isinstance(x, (np.ndarray, np.generic)):
        return int(x.nbytes)
    if isinstance(x, (int, float, bool)):
        return 8
    return 0


def count_h2d(nbytes: int, calls: int = 1):
    if not _counting() or nbytes <= 0:
        return
    with _lock:
        _TRANSFERS["h2d_bytes"] += int(nbytes)
        _TRANSFERS["h2d_calls"] += calls


def count_d2h(nbytes: int, calls: int = 1):
    """Device→host materialization, counted at the consumer sync points
    (a drain batch's first consumer, ``PendingPlan.wait``'s placement
    sync, the paged route's sweep results)."""
    if not _counting() or nbytes <= 0:
        return
    with _lock:
        _TRANSFERS["d2h_bytes"] += int(nbytes)
        _TRANSFERS["d2h_calls"] += calls


def count_tree_h2d(tree):
    """Count a whole planner-arg tree's host→device upload (the paths
    where arrays go up leaf by leaf without passing through
    :func:`device_put`). Tensor leaves (mirror planes) count zero."""
    if not _counting():
        return
    total = calls = 0
    for leaf in _leaves(tree):
        n = _host_nbytes(leaf)
        if n:
            total += n
            calls += 1
    count_h2d(total, calls=calls)


def count_tile_upload(nbytes: int, reupload: bool = False):
    """One paged tile crossing host→device (tpu/paging.py's TileCache —
    which already routes the bytes through :func:`count_tree_h2d`; this
    ledger adds the TILE-granular view the
    ``h2d_thrash`` watchdog rule divides by committed placements).
    ``reupload`` marks a tile sent again: a dirty dynamic-plane refresh
    or a re-admission after budget eviction."""
    if not _counting() or nbytes <= 0:
        return
    with _lock:
        _PAGED["tile_uploads"] += 1
        _PAGED["tile_upload_bytes"] += int(nbytes)
        if reupload:
            _PAGED["tile_reuploads"] += 1
            _PAGED["tile_reupload_bytes"] += int(nbytes)


def paged_totals() -> dict:
    """The paged tile-stream counters (flight-sample / bench view)."""
    with _lock:
        return dict(_PAGED)


def device_put(x, device, non_blocking: bool = False):
    """THE counted upload: ``x`` (a numpy array or scalar) as a tensor on
    ``device``, its bytes counted h2d. On the CPU the tensor shares the
    array's memory, as the port's plain versions read it. ``non_blocking``
    copies from pinned host memory on the current stream without waiting
    for it."""
    import torch

    count_h2d(_host_nbytes(x))
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    return torch.from_numpy(a).to(device, non_blocking=non_blocking)


# ---------------------------------------------------------------------------
# the collective-round counter
# ---------------------------------------------------------------------------


def _on_card(x) -> bool:
    return getattr(getattr(x, "device", None), "type", None) == "cuda"


def count_rounds(planner: str, rounds, placements, sharded: bool):
    """One planner launch's device-loop rounds against the placements it
    resolved. ``rounds`` (and ``placements``) may be a host int — the
    exact scan's step count — or a device scalar the runs, windowed and
    wavefront kernels return. A scalar still on the card is copied to
    pinned host memory behind the launch, on its stream, and parks in a
    bounded pending queue with a CUDA event recorded after the copy; it
    folds into the totals once the event reports complete, so recording
    never syncs. The exact scan records rounds == lanes
    (rounds_per_placement 1.0 when every lane is real); the wavefront
    records its measured commit rounds."""
    if not _counting():
        return
    if not (_on_card(rounds) or _on_card(placements)):
        _fold_rounds(planner, int(rounds), int(placements), sharded)
        return
    import torch

    host = []
    for x in (rounds, placements):
        if _on_card(x):
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x, non_blocking=True)
            x = h
        host.append(x)
    ready = torch.cuda.Event()
    ready.record()
    with _lock:
        _PENDING.append((planner, host[0], host[1], bool(sharded), ready))


def _fold_rounds(planner: str, rounds: int, placements: int, sharded: bool):
    with _lock:
        entry = _ROUNDS.setdefault(
            planner,
            {
                "dispatches": 0, "rounds": 0, "placements": 0,
                "sharded_dispatches": 0, "sharded_rounds": 0,
                "sharded_placements": 0,
            },
        )
        entry["dispatches"] += 1
        entry["rounds"] += rounds
        entry["placements"] += placements
        if sharded:
            entry["sharded_dispatches"] += 1
            entry["sharded_rounds"] += rounds
            entry["sharded_placements"] += placements


def _resolve_pending():
    """Fold every READY pending device scalar; in-flight kernels keep
    theirs queued (reads stay non-blocking)."""
    take = []
    with _lock:
        still = deque(maxlen=_PENDING.maxlen)
        while _PENDING:
            item = _PENDING.popleft()
            try:
                ready = bool(item[4].query())
            except Exception:
                ready = True
            (take if ready else still).append(item)
        _PENDING.extend(still)
    for planner, rounds, placements, sharded, _ in take:
        try:
            rounds_i, placements_i = int(rounds), int(placements)
        except Exception:
            continue
        _fold_rounds(planner, rounds_i, placements_i, sharded)


# ---------------------------------------------------------------------------
# read surfaces
# ---------------------------------------------------------------------------


def compile_cache_size(planners=None) -> int:
    """Distinct ``(planner, shape, flavor)`` launched in this process
    (every planner, or those in ``planners``), the port's counterpart of
    the jit caches: the recompile_storm watchdog signal. A drain batch
    diffs it over its launch window leaving the applier's verify out, as
    the JAX drain diffs only its planner caches."""
    with _lock:
        if planners is None:
            return len(_LAUNCHED)
        return sum(1 for key in _LAUNCHED if key[0] in planners)


def totals() -> dict:
    """The flight-sample view: transfer totals + round totals, O(1)
    after pending resolution, jax-free."""
    _resolve_pending()
    with _lock:
        rounds = sum(e["rounds"] for e in _ROUNDS.values())
        placements = sum(e["placements"] for e in _ROUNDS.values())
        return {
            **_TRANSFERS,
            **{f"paged_{k}": v for k, v in _PAGED.items()},
            "compiles": _COMPILES["count"],
            "compile_s": round(_COMPILES["seconds"], 4),
            "rounds": rounds,
            # rounds that actually crossed the mesh (sharded dispatches
            # only) — the flight sample's collective_rounds key
            "collective_rounds": sum(
                e["sharded_rounds"] for e in _ROUNDS.values()
            ),
            "placements": placements,
            "pending_rounds": len(_PENDING),
        }


def rounds_snapshot() -> dict:
    """Per-planner round/placement accounting (deep-copied)."""
    _resolve_pending()
    with _lock:
        return {k: dict(v) for k, v in _ROUNDS.items()}


def summary() -> dict:
    """The distilled numbers: compile totals, transfer totals, and the
    ROADMAP item 2 knee — ``collective_rounds_per_placement`` over
    sharded dispatches (``rounds_per_placement`` covers all flavors; on
    an unsharded box the ratio is the same loop structure without the
    collectives)."""
    _resolve_pending()
    with _lock:
        rounds = sum(e["rounds"] for e in _ROUNDS.values())
        placements = sum(e["placements"] for e in _ROUNDS.values())
        s_rounds = sum(e["sharded_rounds"] for e in _ROUNDS.values())
        s_placements = sum(
            e["sharded_placements"] for e in _ROUNDS.values()
        )
        s_dispatches = sum(
            e["sharded_dispatches"] for e in _ROUNDS.values()
        )
        collective_ops = sum(
            e["collective_ops"] for e in _LEDGER.values() if e["sharded"]
        )
        return {
            "enabled": _ENABLED,
            "compiles": _COMPILES["count"],
            "compile_s_total": round(_COMPILES["seconds"], 4),
            "h2d_mb": round(_TRANSFERS["h2d_bytes"] / 1e6, 3),
            "h2d_calls": _TRANSFERS["h2d_calls"],
            "d2h_mb": round(_TRANSFERS["d2h_bytes"] / 1e6, 3),
            "d2h_calls": _TRANSFERS["d2h_calls"],
            "rounds": rounds,
            "placements": placements,
            "rounds_per_placement": (
                round(rounds / placements, 4) if placements else None
            ),
            "sharded_dispatches": s_dispatches,
            "collective_rounds": s_rounds,
            "collective_rounds_per_placement": (
                round(s_rounds / s_placements, 4) if s_placements else None
            ),
            "census_collective_ops": collective_ops,
            "paged_tile_uploads": _PAGED["tile_uploads"],
            "paged_tile_reuploads": _PAGED["tile_reuploads"],
            "paged_tile_upload_mb": round(
                _PAGED["tile_upload_bytes"] / 1e6, 3
            ),
            "paged_tile_reupload_mb": round(
                _PAGED["tile_reupload_bytes"] / 1e6, 3
            ),
        }


def snapshot() -> dict:
    """The full device-plane payload: summary + ledger (sorted by
    compile seconds, the "what did startup cost" view) + per-planner
    rounds + the last-dispatch table. Serves ``/v1/metrics``
    ``tpu_devprof`` and the debug bundle's ``device.json``."""
    summ = summary()
    with _lock:
        ledger = sorted(
            (dict(e) for e in _LEDGER.values()),
            key=lambda e: -e["compile_s"],
        )
        for e in ledger:
            e["collectives"] = {
                op: dict(c) for op, c in e["collectives"].items()
            }
        dispatch = {
            planner: {"shape": key, "sharded": sharded, "flavor": flavor}
            for planner, (key, sharded, flavor) in _LAST.items()
        }
    return {
        "summary": summ,
        "compile_ledger": ledger,
        "rounds": rounds_snapshot(),
        "last_dispatch": dispatch,
        "compile_cache_size": compile_cache_size(),
    }


def mesh_comm_frac(unsharded_s: float, sharded_s: float):
    """THE one-number knee for a sharded/unsharded arm pair: the
    fraction of the sharded wall clock in EXCESS of the unsharded
    program — communication + partitioning overhead, an upper bound
    that becomes exact when per-shard compute is free (and a tight
    estimate on a virtual single-core mesh, where compute doesn't
    parallelize at all). 0.0 when sharding is winning."""
    if not sharded_s or sharded_s <= 0:
        return None
    return round(max(0.0, 1.0 - unsharded_s / sharded_s), 4)


def format_report(payload: dict, top: int = 8) -> str:
    """Human-readable device-plane table (the ``operator device`` CLI
    surface); ``payload`` is a :func:`snapshot`-shaped dict (possibly
    fetched over the wire)."""
    summ = payload.get("summary") or {}
    lines = [
        f"compiles: {summ.get('compiles', 0)}"
        f" ({summ.get('compile_s_total', 0.0)}s total)"
        f"   compile_cache_size: {payload.get('compile_cache_size', 0)}",
        f"h2d: {summ.get('h2d_mb', 0.0)} MB / {summ.get('h2d_calls', 0)}"
        f" calls   d2h: {summ.get('d2h_mb', 0.0)} MB /"
        f" {summ.get('d2h_calls', 0)} calls",
        "collective_rounds_per_placement: "
        f"{summ.get('collective_rounds_per_placement')}"
        f"   (rounds_per_placement all flavors: "
        f"{summ.get('rounds_per_placement')})",
        "",
        f"{'planner':<12} {'shape':<22} {'shard':>5} {'flavor':>6} "
        f"{'compiles':>8} {'seconds':>8} {'collectives':>11}",
    ]
    for e in (payload.get("compile_ledger") or [])[:top]:
        lines.append(
            f"{e['planner']:<12} {e['shape']:<22} "
            f"{'yes' if e['sharded'] else 'no':>5} {e['flavor']:>6} "
            f"{e['compiles']:>8} {e['compile_s']:>8} "
            f"{e['collective_ops']:>11}"
        )
    rounds = payload.get("rounds") or {}
    if rounds:
        lines.append("")
        lines.append(
            f"{'planner':<12} {'dispatches':>10} {'rounds':>10} "
            f"{'placements':>10} {'rounds/place':>12}"
        )
        for planner, e in sorted(rounds.items()):
            rpp = (
                round(e["rounds"] / e["placements"], 4)
                if e["placements"]
                else None
            )
            lines.append(
                f"{planner:<12} {e['dispatches']:>10} {e['rounds']:>10} "
                f"{e['placements']:>10} {rpp!s:>12}"
            )
    return "\n".join(lines)
