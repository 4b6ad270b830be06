"""Runtime lockdep witness: observed lock-order validation.

The static pass (``nomad_tpu/analysis/lockgraph.py``) derives the lock
graph the code CAN take; this witness records the orders threads
ACTUALLY take under tier-1 and flags an inversion the moment both
directions of a pair have been observed — the classic lockdep check,
cross-validating the static graph with ground truth.

Mechanics: ``install()`` replaces ``threading.Lock``/``threading.RLock``
with wrapper factories. Each wrapper is identified by its **allocation
site** (``file:line`` of the ``threading.Lock()`` call) — the same
identity key as a static lock definition, so the two graphs join
exactly. Per thread, the currently-held wrapper stack is tracked; on
each first-acquisition of an instance, an ordered edge
``(held site) -> (acquired site)`` is recorded, and if the REVERSE edge
was ever observed (any thread, any time) a violation is recorded with
both stacks' witness locations.

Scope decisions (documented, deliberate):

- RLock re-entrancy is per-instance counted — re-acquiring a lock you
  hold records nothing;
- ``Condition.wait`` releases and re-acquires through
  ``_release_save``/``_acquire_restore``: the held stack reflects that,
  so a wait correctly drops the lock from the order context;
- same-site pairs (two instances born at the same line, e.g. two
  brokers' ``_lock`` nested) are skipped: with site-keyed identity the
  pair is its own reversal, and the codebase's only same-class nesting
  is scratch-store construction, which is single-threaded;
- violations are RECORDED, never raised from ``acquire`` — raising
  inside arbitrary lock paths can deadlock the code under test. The
  tier-1 conftest asserts ``violations() == []`` after every test.

Enable before the code under test creates its locks (tests/conftest.py
installs it at import time, before jax/nomad_tpu imports).
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
import time
from typing import Optional

#: raw (unwrappable) lock guarding the global edge/violation tables;
#: held only for dict mutation, never across anything blocking
_graph_lock = _thread.allocate_lock()

#: (site_a, site_b) -> "thread/location" witness of first observation
_edges: dict = {}
#: human-readable inversion reports, in observation order
_violations: list = []
#: site -> [blocked-acquire count, total seconds waited] — per-site
#: contention accounting for the debug plane's lock-wait table (the
#: profiler's blocked-site sampling cross-validated by exact timing).
#: Only acquires that actually BLOCK are counted: the wrappers try a
#: non-blocking acquire first, so the uncontended fast path costs one
#: extra C call and no clock reads.
_contention: dict = {}

_tls = threading.local()

_installed = False
_real_lock = threading.Lock
_real_rlock = threading.RLock


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = []
        _tls.held = held
    return held


def _site(depth: int = 2) -> str:
    f = sys._getframe(depth)
    # walk out of this module (factory indirection) AND stdlib threading
    # (Condition()/Semaphore() allocate their inner lock inside
    # threading.py — without this every no-arg Condition in the codebase
    # would collapse to ONE site, manufacturing false cross-subsystem
    # inversions and blinding the witness to real ones)
    while f is not None and f.f_code.co_filename in (
        __file__,
        threading.__file__,
    ):
        f = f.f_back
    if f is None:
        return "<unknown>"
    fn = f.f_code.co_filename
    parts = fn.replace(os.sep, "/").split("/")
    short = "/".join(parts[-3:]) if len(parts) >= 3 else fn
    return f"{short}:{f.f_lineno}"


def _where() -> str:
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename in (
        __file__,
        threading.__file__,
    ):
        f = f.f_back
    if f is None:
        return "<unknown>"
    return (
        f"{threading.current_thread().name} at "
        f"{f.f_code.co_filename.replace(os.sep, '/').rsplit('/', 1)[-1]}"
        f":{f.f_lineno} ({f.f_code.co_name})"
    )


def _note_acquire(wrapper):
    held = _held()
    for entry in held:
        if entry[0] is wrapper:
            entry[1] += 1
            return
    new_site = wrapper._site
    where = None
    for entry in held:
        a = entry[0]._site
        if a == new_site:
            continue  # same-site pair: see module docstring
        pair = (a, new_site)
        if pair in _edges:
            continue
        if where is None:
            where = _where()
        with _graph_lock:
            if pair in _edges:
                continue
            rev = _edges.get((new_site, a))
            _edges[pair] = where
            if rev is not None:
                _violations.append(
                    f"lock order inversion: {a} -> {new_site} ({where}) "
                    f"but previously {new_site} -> {a} ({rev})"
                )
    held.append([wrapper, 1])


def _note_contention(site: str, waited: float):
    with _graph_lock:
        entry = _contention.get(site)
        if entry is None:
            _contention[site] = [1, waited]
        else:
            entry[0] += 1
            entry[1] += waited


def _note_release(wrapper, full: bool = False):
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is wrapper:
            if full:
                held[i][1] = 0
            else:
                held[i][1] -= 1
            if held[i][1] <= 0:
                del held[i]
            return


class _LockdepLock:
    """threading.Lock wrapper with order witnessing."""

    _wrapped_kind = "Lock"

    def __init__(self, inner, site: str):
        self._inner = inner
        self._site = site

    def acquire(self, blocking=True, timeout=-1):
        if not blocking:
            # forward verbatim: the raw lock's ValueError for a
            # non-blocking call with a timeout must survive wrapping —
            # the witness must not hide argument misuse tests exist to
            # catch
            ok = self._inner.acquire(blocking, timeout)
        else:
            # contention accounting: uncontended acquires take the
            # non-blocking fast path (no clock reads); only a REAL
            # block pays two monotonic() calls and a table update
            ok = self._inner.acquire(False)
            if not ok:
                t0 = time.monotonic()
                ok = self._inner.acquire(True, timeout)
                _note_contention(self._site, time.monotonic() - t0)
        if ok:
            _note_acquire(self)
        return ok

    def release(self):
        _note_release(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<lockdep {self._wrapped_kind} {self._site}>"


class _LockdepRLock(_LockdepLock):
    """threading.RLock wrapper; also the Condition lock protocol
    (_release_save / _acquire_restore / _is_owned) so Condition.wait's
    release-and-reacquire keeps the held stack truthful."""

    _wrapped_kind = "RLock"

    def _release_save(self):
        _note_release(self, full=True)
        return self._inner._release_save()

    def _acquire_restore(self, state):
        # Condition.wait's re-acquire after notify: the classic convoy
        # site — timed like any blocked acquire
        t0 = time.monotonic()
        self._inner._acquire_restore(state)
        waited = time.monotonic() - t0
        if waited > 1e-4:
            _note_contention(self._site, waited)
        _note_acquire(self)

    def _is_owned(self):
        return self._inner._is_owned()


def _lock_factory():
    return _LockdepLock(_real_lock(), _site())


def _rlock_factory():
    return _LockdepRLock(_real_rlock(), _site())


def install():
    """Patch threading.Lock/RLock with witnessing factories. Locks
    created BEFORE install (stdlib logging etc.) stay raw — they simply
    don't participate."""
    global _installed
    if _installed:
        return
    _installed = True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory


def uninstall():
    global _installed
    if not _installed:
        return
    _installed = False
    threading.Lock = _real_lock
    threading.RLock = _real_rlock


def installed() -> bool:
    return _installed


def reset():
    """Drop recorded edges, violations, and contention (tests isolate
    scenarios)."""
    with _graph_lock:
        _edges.clear()
        del _violations[:]
        _contention.clear()


def contention() -> dict:
    """Snapshot of per-site blocked-wait totals:
    ``site -> {count, wait_s}`` — the lock-wait table the debug bundle
    and the watchdog's lock_contention rule consume."""
    with _graph_lock:
        return {
            site: {"count": c, "wait_s": round(w, 6)}
            for site, (c, w) in _contention.items()
        }


def held_sites() -> tuple:
    """Allocation sites of the locks THIS thread currently holds,
    innermost last — the lockset the racedep witness (racedep.py)
    intersects per shared-attribute access. Thread-local read: no
    lock, O(held depth), safe on any access path."""
    held = getattr(_tls, "held", None)
    if not held:
        return ()
    return tuple(entry[0]._site for entry in held)


def edges() -> dict:
    """Snapshot of observed (site_a, site_b) -> witness."""
    with _graph_lock:
        return dict(_edges)


def violations() -> list:
    with _graph_lock:
        return list(_violations)


def violation_count() -> int:
    return len(_violations)


def check():
    """Raise AssertionError when any inversion has been observed."""
    v = violations()
    if v:
        raise AssertionError(
            "lockdep observed lock-order inversions:\n" + "\n".join(v)
        )
