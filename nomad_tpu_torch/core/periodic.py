"""Periodic job dispatch: leader-side cron launcher (ref nomad/periodic.go:22
PeriodicDispatch) plus the cron expression evaluator the reference gets from
gorhill/cronexpr.

Periodic jobs never run directly: the leader tracks them in a launch-time
heap, and at each fire time registers a **derived child job**
``<id>/periodic-<unix-ts>`` (periodic.go:326 derivedJob) whose evaluation
flows through the normal scheduler path. Launch times are checkpointed in
the ``periodic_launch`` table so a new leader resumes from the replicated
last-launch (periodic.go:199 restore via FSM; state/schema.go:336).
``prohibit_overlap`` skips a launch while a previous child is live.
"""

from __future__ import annotations

import heapq
import logging
import threading
from datetime import datetime, timedelta, timezone
from typing import Optional

from ..structs.model import (
    EVAL_STATUS_PENDING,
    EVAL_TRIGGER_PERIODIC_JOB,
    JOB_STATUS_DEAD,
    Evaluation,
    Job,
    generate_uuid,
    now_ns,
)

logger = logging.getLogger("nomad_tpu.periodic")

# ---------------------------------------------------------------------------
# Cron evaluation (ref vendored gorhill/cronexpr used by structs.go
# PeriodicConfig.Next). Standard 5-field spec: minute hour day-of-month
# month day-of-week, with * , - / and the common @ shorthands.
# ---------------------------------------------------------------------------

_FIELD_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]
_ALIASES = {
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
    "@monthly": "0 0 1 * *",
    "@weekly": "0 0 * * 0",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@hourly": "0 * * * *",
}
_MONTH_NAMES = {
    name: i + 1
    for i, name in enumerate(
        "jan feb mar apr may jun jul aug sep oct nov dec".split()
    )
}
_DOW_NAMES = {
    name: i for i, name in enumerate("sun mon tue wed thu fri sat".split())
}


def _parse_field(text: str, lo: int, hi: int, names: dict) -> tuple[set, bool]:
    """Returns (allowed values, is_wildcard)."""
    values: set[int] = set()
    wildcard = False

    def atom(tok: str) -> int:
        tok = tok.strip().lower()
        if tok in names:
            return names[tok]
        v = int(tok)
        if tok == "7" and hi == 6:
            return 0  # cron allows 7 for Sunday
        if not (lo <= v <= hi):
            raise ValueError(f"cron value {v} out of range [{lo},{hi}]")
        return v

    for part in text.split(","):
        part = part.strip()
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step <= 0:
                raise ValueError(f"invalid cron step {step_s}")
        if part == "*":
            if step == 1:
                wildcard = True
            values.update(range(lo, hi + 1, step))
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = atom(a), atom(b)
            if end < start:
                raise ValueError(f"inverted cron range {part}")
            values.update(range(start, end + 1, step))
        else:
            v = atom(part)
            if step != 1:
                values.update(range(v, hi + 1, step))
            else:
                values.add(v)
    return values, wildcard


class CronSpec:
    """Parsed cron expression with next-fire-time evaluation."""

    def __init__(self, spec: str):
        spec = _ALIASES.get(spec.strip(), spec.strip())
        fields = spec.split()
        if len(fields) != 5:
            raise ValueError(
                f"cron spec needs 5 fields (minute hour dom month dow): {spec!r}"
            )
        names = [{}, {}, {}, _MONTH_NAMES, _DOW_NAMES]
        parsed = [
            _parse_field(f, lo, hi, nm)
            for f, (lo, hi), nm in zip(fields, _FIELD_RANGES, names)
        ]
        (self.minutes, _) = parsed[0]
        (self.hours, _) = parsed[1]
        (self.dom, self.dom_wild) = parsed[2]
        (self.months, _) = parsed[3]
        (self.dow, self.dow_wild) = parsed[4]

    def _day_matches(self, d: datetime) -> bool:
        dom_ok = d.day in self.dom
        dow_ok = ((d.weekday() + 1) % 7) in self.dow  # python Mon=0 → cron Sun=0
        # standard cron: if both day fields are restricted, either matches
        if not self.dom_wild and not self.dow_wild:
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def next(self, after: datetime) -> Optional[datetime]:
        """First fire time strictly after ``after`` (tz-aware UTC)."""
        t = after.replace(second=0, microsecond=0) + timedelta(minutes=1)
        for _ in range(366 * 5):  # cap: five years of days
            if t.month not in self.months or not self._day_matches(t):
                t = (t + timedelta(days=1)).replace(hour=0, minute=0)
                continue
            day = t.date()
            for h in sorted(self.hours):
                if h < t.hour:
                    continue
                for m in sorted(self.minutes):
                    if h == t.hour and m < t.minute:
                        continue
                    return datetime(
                        day.year, day.month, day.day, h, m, tzinfo=timezone.utc
                    )
            t = (t + timedelta(days=1)).replace(hour=0, minute=0)
        return None


def next_launch(job: Job, after_ns: int) -> Optional[int]:
    """Next launch time in unix ns, per the job's periodic config
    (ref structs.go PeriodicConfig.Next)."""
    p = job.periodic
    if p is None or not p.enabled:
        return None
    after = datetime.fromtimestamp(after_ns / 1e9, tz=timezone.utc)
    if p.spec_type == "cron":
        nxt = CronSpec(p.spec).next(after)
        return int(nxt.timestamp() * 1e9) if nxt is not None else None
    raise ValueError(f"unknown periodic spec type {p.spec_type!r}")


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

class PeriodicDispatch:
    """ref nomad/periodic.go:22"""

    def __init__(self, server):
        self.server = server
        self._tracked: dict[tuple[str, str], Job] = {}
        # generation counter per key: updating a job invalidates its old
        # heap entries (they carry the generation they were pushed under)
        self._gen: dict[tuple[str, str], int] = {}
        self._heap: list[tuple[int, tuple[str, str], int]] = []
        self._enabled = False
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        server.attach_periodic(self)

    def set_enabled(self, enabled: bool):
        with self._cv:
            if enabled == self._enabled:
                return
            self._enabled = enabled
            if enabled:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="periodic-dispatch"
                )
                self._thread.start()
            else:
                self._tracked.clear()
                self._heap = []
                # with the heap gone no stale entry can ever match: the
                # generation map is droppable wholesale
                self._gen.clear()
                self._cv.notify_all()

    def restore(self, state):
        """Track all live periodic jobs on leadership (ref leader.go
        restorePeriodicDispatcher). Future launches are scheduled from *now*
        (see add); for launches missed while there was no leader, force at
        most ONE catch-up dispatch per job — never one per missed interval."""
        now = now_ns()
        catch_up: list[Job] = []
        for job in state.jobs_by_periodic():
            if job.stopped():
                continue
            self.add(job)
            launch = state.periodic_launch_by_id(*job.namespaced_id())
            if launch is None:
                continue
            try:
                nxt = next_launch(job, launch["launch"])
            except ValueError:
                continue
            if nxt is not None and nxt <= now:
                catch_up.append(job)
        for job in catch_up:
            try:
                # launch stamped at *now* (ref periodic.go ForceRun), so the
                # checkpoint advances and a second restore doesn't re-fire
                self.dispatch(job, now_ns())
            except Exception:
                logger.exception("periodic catch-up launch of %s failed", job.id)

    # ------------------------------------------------------------------
    def add(self, job: Job):
        """Called by the FSM as jobs are applied (fsm.go:330). Self-gating
        like the reference's Add (periodic.go:216-248): a non-periodic,
        parameterized, or stopped job untracks instead of tracking — an
        update can flip any of those on a job we were dispatching."""
        if (
            not job.is_periodic()
            or job.parameterized_job is not None
            or job.stopped()
        ):
            self.remove(*job.namespaced_id())
            return
        with self._cv:
            if not self._enabled:
                return
            key = job.namespaced_id()
            # Schedule from *now*, not from the replicated last-launch
            # (ref periodic.go Add → j.Periodic.Next(time.Now())): scheduling
            # from a stale last-launch would enqueue every missed interval
            # and storm the cluster with derived jobs after leader downtime.
            try:
                nxt = next_launch(job, now_ns())
            except ValueError as e:
                logger.error("periodic job %s: bad spec: %s", job.id, e)
                return
            self._tracked[key] = job
            self._gen[key] = self._gen.get(key, 0) + 1
            if nxt is not None:
                heapq.heappush(self._heap, (nxt, key, self._gen[key]))
                self._cv.notify_all()

    def remove(self, namespace: str, job_id: str):
        with self._cv:
            key = (namespace, job_id)
            self._tracked.pop(key, None)
            self._gen[key] = self._gen.get(key, 0) + 1
            # stale heap entries are skipped lazily in _run
            self._compact_gen_locked()

    def _compact_gen_locked(self):
        """Evict generation counters no live state references. The FSM
        routes EVERY job apply through add() — non-periodic jobs fall
        through to remove(), which used to mint a counter per job id and
        keep it forever (the `_bad_http_addrs` unbounded-growth class;
        one entry per job ever registered, surfaced by the churn soak's
        job churn). A key is droppable once it is neither tracked nor
        referenced by any heap entry: no stale entry can then match, and
        a later add() restarting its generation at 1 collides with
        nothing."""
        if len(self._gen) <= 2 * len(self._tracked) + 64:
            return
        live = set(self._tracked)
        live.update(key for _, key, _ in self._heap)
        for key in [k for k in self._gen if k not in live]:
            del self._gen[key]

    def tracked(self) -> list[Job]:
        with self._cv:
            return list(self._tracked.values())

    # ------------------------------------------------------------------
    def _run(self):
        me = threading.current_thread()
        while True:
            with self._cv:
                # exit if disabled OR superseded by a newer loop thread
                # (leadership flap within the wait window)
                if not self._enabled or self._thread is not me:
                    return
                now = now_ns()
                while self._heap and (
                    self._heap[0][1] not in self._tracked
                    or self._heap[0][2] != self._gen.get(self._heap[0][1])
                ):
                    heapq.heappop(self._heap)  # removed or updated job
                if not self._heap:
                    self._cv.wait(1.0)
                    continue
                fire_at, key, gen = self._heap[0]
                if fire_at > now:
                    self._cv.wait(min((fire_at - now) / 1e9, 1.0))
                    continue
                heapq.heappop(self._heap)
                job = self._tracked.get(key)
                if job is None:
                    continue
                # schedule the following launch before dispatching
                nxt = next_launch(job, fire_at)
                if nxt is not None:
                    heapq.heappush(self._heap, (nxt, key, gen))
            try:
                self.dispatch(job, fire_at)
            except Exception:
                logger.exception("periodic launch of %s failed", job.id)

    # ------------------------------------------------------------------
    def dispatch(self, job: Job, launch_ns: int) -> Optional[str]:
        """Launch one periodic instance (ref periodic.go:326 createEval).
        Returns the child job id, or None when prohibit_overlap skips."""
        from . import fsm as fsm_mod

        if job.periodic is not None and job.periodic.prohibit_overlap:
            if self._has_live_child(job):
                logger.info(
                    "periodic job %s skipped launch: child still running", job.id
                )
                return None
        child = derive_periodic_job(job, launch_ns)
        self.server._apply(
            fsm_mod.PERIODIC_LAUNCH,
            {"namespace": job.namespace, "job_id": job.id, "launch": launch_ns},
        )
        self.server._apply(fsm_mod.JOB_REGISTER, {"job": child.to_dict()})
        ev = Evaluation(
            id=generate_uuid(),
            namespace=child.namespace,
            priority=child.priority,
            type=child.type,
            triggered_by=EVAL_TRIGGER_PERIODIC_JOB,
            job_id=child.id,
            status=EVAL_STATUS_PENDING,
            create_time=now_ns(),
            modify_time=now_ns(),
        )
        self.server._apply(fsm_mod.EVAL_UPDATE, {"evals": [ev.to_dict()]})
        logger.info("periodic job %s launched as %s", job.id, child.id)
        return child.id

    def _has_live_child(self, job: Job) -> bool:
        prefix = f"{job.id}/periodic-"
        for j in self.server.state.jobs_by_namespace(job.namespace):
            if j.id.startswith(prefix) and j.status != JOB_STATUS_DEAD:
                return True
        return False

    def force_launch(self, namespace: str, job_id: str) -> str:
        """ref periodic_endpoint.go Force: launch now, regardless of spec."""
        job = self.server.state.job_by_id(namespace, job_id)
        if job is None:
            raise KeyError(f"job not found: {job_id}")
        if not job.is_periodic():
            raise ValueError(f"job {job_id} is not periodic")
        child_id = self.dispatch(job, now_ns())
        if child_id is None:
            raise ValueError(
                f"job {job_id} launch skipped: prohibit_overlap and a "
                "previous launch is still running"
            )
        return child_id


def derived_job_id(job: Job, launch_ns: int) -> str:
    """ref periodic.go derivedJobID: <id>/periodic-<unix seconds>"""
    return f"{job.id}/periodic-{launch_ns // 1_000_000_000}"


def derive_periodic_job(job: Job, launch_ns: int) -> Job:
    child = job.copy()
    child.id = derived_job_id(job, launch_ns)
    child.name = child.id
    child.parent_id = job.id
    child.periodic = None
    child.stable = False
    child.version = 0
    child.status = ""
    child.submit_time = now_ns()
    return child


def derive_dispatch_job(parent: Job, payload: str, meta: dict) -> Job:
    """ref structs.go DispatchedID + job_endpoint.go Dispatch derived job:
    <id>/dispatch-<unix seconds>-<8-char uuid>"""
    ts = now_ns() // 1_000_000_000
    child = parent.copy()
    child.id = f"{parent.id}/dispatch-{ts}-{generate_uuid()[:8]}"
    child.name = child.id
    child.parent_id = parent.id
    child.dispatched = True
    child.payload = payload
    child.meta = {**parent.meta, **meta}
    child.stable = False
    child.version = 0
    child.status = ""
    child.submit_time = now_ns()
    return child
