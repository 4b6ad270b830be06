"""Pure-stdlib sampling wall-clock profiler (the Go pprof CPU-profile
role, ref command/agent/http.go:218-222 + `nomad operator debug`'s
pprof captures).

``sys._current_frames()`` is walked at ~100Hz on a dedicated thread;
every live thread's Python stack is folded into flame-graph lines
(``class:thread;file:func;file:func count``) bucketed by the thread's
**name-derived class** — which is why every spawn in the tree carries a
descriptive ``name=`` (enforced by the ``thread-unnamed`` analysis
rule). Because the sampler sees wall-clock, not CPU, it attributes
*blocked* time too: a sample whose innermost Python frame sits inside
``threading.py``/``queue.py`` is a parked thread, and the nearest
application frame below the park is charged as the **blocked site**.

That blocked-site table is the whole-process complement to the trace
plane's per-eval critical path: ROADMAP item 2's worker-scaling knee
shows up here as worker-class threads spending most of their wall time
parked at ``core/plan_apply.py:wait`` (``PendingPlan.wait`` — the
serialized applier's completion future), reported as the single number
``applier_block_frac`` without any span instrumentation in the loop.

Zero third-party deps, no signals, no C extensions: safe to run inside
the live agent behind ``enable_debug``.
"""

from __future__ import annotations

import gc
import queue
import re
import sys
import threading
import time
import traceback

#: thread-name substring -> class, first match wins (names are the
#: contract: see the thread-unnamed analysis rule)
_CLASS_RULES = (
    ("plan-applier", "applier"),
    ("plan-commit", "applier"),
    ("worker", "worker"),
    ("drain-eval", "worker"),
    ("raft", "raft"),
    ("rpc", "rpc"),
    ("mux", "rpc"),
    ("http", "http"),
    ("broker", "broker"),
    ("timer-wheel", "broker"),
    ("mirror", "mirror"),
    ("reaper", "leader"),
    ("core-gc", "leader"),
    ("periodic-dispatch", "leader"),
    ("deployments-watcher", "leader"),
    ("node-drainer", "leader"),
    ("vault", "leader"),
    ("acl-replication", "leader"),
    ("heartbeat", "heartbeat"),
    ("hb-", "heartbeat"),
    ("gossip", "gossip"),
    ("swim", "gossip"),
    ("ldg-", "loadgen"),
    ("debug-", "debug"),
    ("metrics", "metrics"),
    ("MainThread", "main"),
)

#: files whose frames are a *park*, not application code: the
#: blocked-site walk skips them to find the frame that owns the wait.
#: The lockdep witness wrappers (tier-1 default) are park frames too —
#: a thread blocked in a wrapped Lock.acquire has its innermost Python
#: frame in lockdep.py, and missing it would charge convoy wait as
#: on-CPU time (breaking the sampler↔lockdep.contention() agreement)
from ..testing import lockdep as _lockdep

_PARK_FILES = frozenset(
    {threading.__file__, queue.__file__, _lockdep.__file__}
)

#: frames matching (file suffix, function) that mean "this worker is
#: waiting on the serialized plan applier" (PendingPlan.wait)
_APPLIER_WAIT = (("core/plan_apply.py", "wait"),)


def classify_thread(name: str) -> str:
    for needle, cls in _CLASS_RULES:
        if needle in name:
            return cls
    return "other"


#: per-instance id suffixes stripped from fold keys: drain lanes spawn a
#: uniquely-named thread PER EVAL (drain-eval-<hex8>) — folding by raw
#: name would mint O(evals sampled) singleton stacks and overflow
#: max_stacks exactly under the storm the profiler exists for
_FOLD_ID_RE = re.compile(r"-[0-9a-f]{4,}$")


def fold_name(name: str) -> str:
    return _FOLD_ID_RE.sub("", name)


def _short(filename: str) -> str:
    parts = filename.replace("\\", "/").split("/")
    return "/".join(parts[-2:]) if len(parts) >= 2 else filename


class SamplingProfiler:
    """Start/stop sampler; ``report()`` is valid after ``stop()``.

    All accounting happens on the sampler thread; ``report()`` reads it
    after the join, so there is no lock on the sampling path.
    """

    def __init__(self, hz: float = 100.0, max_stacks: int = 8192):
        self.hz = max(float(hz), 1.0)
        self.max_stacks = max_stacks
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # nta: ignore[unbounded-cache] WHY: capped at max_stacks in
        # _tick (overflow counted into _dropped, never silent)
        self._folded: dict[str, int] = {}
        self._dropped = 0
        # nta: ignore[unbounded-cache] WHY: keyed by thread class — a
        # code-fixed vocabulary (_CLASS_RULES + "other")
        self._classes: dict[str, int] = {}
        # nta: ignore[unbounded-cache] WHY: keyed by (class, code site)
        # — cardinality bounded by distinct park sites in the source
        self._blocked: dict[tuple[str, str], int] = {}
        self._applier_blocked = 0
        self._ticks = 0
        self._t0 = 0.0
        self._t1 = 0.0

    # ------------------------------------------------------------------
    def start(self):
        self._t0 = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="debug-profiler"
        )
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._t1 = time.monotonic()
        return self.report()

    # ------------------------------------------------------------------
    def _run(self):
        period = 1.0 / self.hz
        next_t = time.monotonic() + period
        me = threading.get_ident()
        while not self._stop.is_set():
            delay = next_t - time.monotonic()
            if delay > 0 and self._stop.wait(delay):
                break
            # clamp, don't catch up: after a stall (GC pause, slow tick)
            # a burst of back-to-back ticks would over-weight whatever
            # runs right after the stall — skip the missed samples
            next_t = max(next_t + period, time.monotonic())
            try:
                self._tick(me)
            except Exception:
                # a sampler tick must never kill the sampler (frames can
                # disappear mid-walk); one lost tick is one lost sample
                # nta: ignore[unsynchronized-shared-write] WHY: report()
                # is join-ordered after stop() (class docstring) — the
                # "caller" reader cannot run concurrently with the
                # sampler thread
                self._dropped += 1

    def _tick(self, me: int):
        # nta: ignore[unsynchronized-shared-write] WHY: report() is
        # join-ordered after stop() — no concurrent reader
        self._ticks += 1
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            name = names.get(ident, str(ident))
            cls = classify_thread(name)
            self._classes[cls] = self._classes.get(cls, 0) + 1
            # innermost-first frame walk (f_back chain)
            stack = []
            f = frame
            while f is not None:
                stack.append((f.f_code.co_filename, f.f_code.co_name))
                f = f.f_back
            # blocked attribution: an innermost frame inside
            # threading/queue is a park; charge the nearest app frame
            if stack and stack[0][0] in _PARK_FILES:
                site = None
                for fn, func in stack:
                    if fn not in _PARK_FILES and fn != __file__:
                        site = f"{_short(fn)}:{func}"
                        break
                if site is not None:
                    key = (cls, site)
                    self._blocked[key] = self._blocked.get(key, 0) + 1
            if cls == "worker" and any(
                fn.replace("\\", "/").endswith(suffix) and func == name_
                for fn, func in stack
                for suffix, name_ in _APPLIER_WAIT
            ):
                # nta: ignore[unsynchronized-shared-write] WHY: report()
                # is join-ordered after stop() — no concurrent reader
                self._applier_blocked += 1
            folded = f"{cls}:{fold_name(name)};" + ";".join(
                f"{_short(fn)}:{func}" for fn, func in reversed(stack)
            )
            if folded in self._folded:
                self._folded[folded] += 1
            elif len(self._folded) < self.max_stacks:
                self._folded[folded] = 1
            else:
                # nta: ignore[unsynchronized-shared-write] WHY: report()
                # is join-ordered after stop() — no concurrent reader
                self._dropped += 1

    # ------------------------------------------------------------------
    def report(self) -> dict:
        duration = max((self._t1 or time.monotonic()) - self._t0, 1e-9)
        total = sum(self._classes.values())
        worker = self._classes.get("worker", 0)
        rows = [
            {
                "site": site,
                "class": cls,
                "samples": n,
                "seconds": round(n * duration / max(self._ticks, 1), 3),
                "share": round(n / max(total, 1), 4),
            }
            for (cls, site), n in self._blocked.items()
        ]
        rows.sort(key=lambda r: (-r["samples"], r["site"]))
        return {
            "duration_s": round(duration, 3),
            "hz": self.hz,
            "hz_actual": round(self._ticks / duration, 1),
            "ticks": self._ticks,
            "samples": total,
            "dropped": self._dropped,
            "threads": dict(sorted(self._classes.items())),
            "folded": self._folded,
            "blocked_sites": rows[:50],
            "applier_block_frac": round(
                self._applier_blocked / max(worker, 1), 4
            ),
        }

    def top_blocked_site(self, cls: str = "worker"):
        """(site, samples) most-parked site for one thread class — the
        lock/wait table's headline row ('what are the workers waiting
        on'). None when that class was never seen parked."""
        best = None
        for (c, site), n in self._blocked.items():
            if c != cls:
                continue
            if best is None or n > best[1]:
                best = (site, n)
        return best


def profile(seconds: float, hz: float = 100.0) -> dict:
    """Blocking convenience: sample for ``seconds`` and return the
    report (the ``/debug/pprof/profile?seconds=N`` handler body)."""
    prof = SamplingProfiler(hz=hz).start()
    time.sleep(max(float(seconds), 0.0))
    return prof.stop()


def render_folded(report: dict) -> str:
    """Flamegraph-ready folded text (``stack count`` per line), sorted
    for deterministic artifacts."""
    folded = report.get("folded", {})
    return "\n".join(
        f"{stack} {count}"
        for stack, count in sorted(folded.items(), key=lambda e: (-e[1], e[0]))
    )


def thread_dump() -> dict:
    """One-shot thread stacks + gc stats — the original ``/debug/pprof``
    response, shape-stable (``threads``/``thread_count``/``gc``)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for ident, frame in sys._current_frames().items():
        label = names.get(ident, str(ident))
        # shared static names (rpc-conn, connect-proxy-pump, ...) must
        # not clobber each other's stacks — disambiguate duplicates,
        # keeping the bare name for the first so the legacy shape (and
        # name-keyed consumers) are unchanged for unique threads
        if label in stacks:
            n = 2
            while f"{label}#{n}" in stacks:
                n += 1
            label = f"{label}#{n}"
        stacks[label] = traceback.format_stack(frame)
    return {
        "threads": stacks,
        "thread_count": len(stacks),
        "gc": {
            "counts": gc.get_count(),
            "stats": gc.get_stats(),
        },
    }
