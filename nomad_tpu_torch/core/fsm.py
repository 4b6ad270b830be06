"""Replicated finite-state machine: applies typed log entries into the
state store (ref nomad/fsm.go:173-1073).

The reference's raft FSM dispatches 31 log message types into the
StateStore and — on the leader, where the eval broker / blocked-evals /
periodic dispatcher are enabled — re-enqueues applied evaluations into the
in-memory brokers (fsm.go:190-252 switch, :1059 Snapshot, :1073 Restore).
This FSM keeps the same shape: every server (leader or follower) applies
the identical log; broker side effects are no-ops on followers because the
brokers are disabled there (eval_broker.go enqueue guards).

All writes in the framework flow through here: the server endpoints build
plain-dict payloads, consensus orders them, and `FSM.apply` mutates state
at the entry's log index, so the state-store index equals the raft index —
the invariant blocking queries and SnapshotMinIndex rely on.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional

from ..state.store import StateStore
from ..testing import faults as _faults
from ..structs.model import (
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_PENDING,
    Allocation,
    Deployment,
    DeploymentStatusUpdate,
    Evaluation,
    Job,
    JobSummary,
    Node,
    Plan,
    PlanResult,
    fast_alloc_clone,
)

logger = logging.getLogger("nomad_tpu.fsm")

# Log message types (ref fsm.go:190-252 / structs.go MessageType consts)
NODE_REGISTER = "node_register"
NODE_DEREGISTER = "node_deregister"
NODE_STATUS_UPDATE = "node_status_update"
NODE_DRAIN_UPDATE = "node_drain_update"
NODE_ELIGIBILITY_UPDATE = "node_eligibility_update"
NODE_EVENTS_UPSERT = "node_events_upsert"
JOB_REGISTER = "job_register"
JOB_DEREGISTER = "job_deregister"
JOB_BATCH_DEREGISTER = "job_batch_deregister"
JOB_STABILITY = "job_stability"
EVAL_UPDATE = "eval_update"
EVAL_DELETE = "eval_delete"
ALLOC_UPDATE = "alloc_update"
ALLOC_CLIENT_UPDATE = "alloc_client_update"
ALLOC_DESIRED_TRANSITION = "alloc_desired_transition"
APPLY_PLAN_RESULTS = "apply_plan_results"
APPLY_PLAN_RESULTS_BATCH = "apply_plan_results_batch"
DEPLOYMENT_STATUS_UPDATE = "deployment_status_update"
DEPLOYMENT_PROMOTE = "deployment_promote"
DEPLOYMENT_ALLOC_HEALTH = "deployment_alloc_health"
DEPLOYMENT_DELETE = "deployment_delete"
PERIODIC_LAUNCH = "periodic_launch"
SCHEDULER_CONFIG = "scheduler_config"
AUTOPILOT_CONFIG = "autopilot_config"
RECONCILE_SUMMARIES = "reconcile_summaries"
ACL_POLICY_UPSERT = "acl_policy_upsert"
ACL_POLICY_DELETE = "acl_policy_delete"
ACL_TOKEN_UPSERT = "acl_token_upsert"
ACL_TOKEN_DELETE = "acl_token_delete"
VAULT_ACCESSOR_UPSERT = "vault_accessor_upsert"
VAULT_ACCESSOR_DELETE = "vault_accessor_delete"
NOOP = "noop"


class FSM:
    """Applies ordered log entries into a StateStore, with leader-side
    broker re-enqueue hooks (ref fsm.go nomadFSM)."""

    def __init__(
        self,
        state: Optional[StateStore] = None,
        eval_broker=None,
        blocked_evals=None,
        periodic_dispatcher=None,
        time_table=None,
        event_broker=None,
    ):
        self.state = state if state is not None else StateStore()
        self.eval_broker = eval_broker
        self.blocked_evals = blocked_evals
        self.periodic_dispatcher = periodic_dispatcher
        self.time_table = time_table
        #: cluster event stream source (events/broker.py): every apply
        #: derives typed events tagged with its raft index — on every
        #: server, so followers serve /v1/event/stream too (ref
        #: nomad/state/events.go eventsFromChanges)
        self.event_broker = event_broker
        self._appliers: dict[str, Callable[[int, dict], Any]] = {
            NODE_REGISTER: self._apply_node_register,
            NODE_DEREGISTER: self._apply_node_deregister,
            NODE_STATUS_UPDATE: self._apply_node_status_update,
            NODE_DRAIN_UPDATE: self._apply_node_drain_update,
            NODE_ELIGIBILITY_UPDATE: self._apply_node_eligibility_update,
            NODE_EVENTS_UPSERT: self._apply_node_events_upsert,
            JOB_REGISTER: self._apply_job_register,
            JOB_DEREGISTER: self._apply_job_deregister,
            JOB_BATCH_DEREGISTER: self._apply_job_batch_deregister,
            JOB_STABILITY: self._apply_job_stability,
            EVAL_UPDATE: self._apply_eval_update,
            EVAL_DELETE: self._apply_eval_delete,
            ALLOC_UPDATE: self._apply_alloc_update,
            ALLOC_CLIENT_UPDATE: self._apply_alloc_client_update,
            ALLOC_DESIRED_TRANSITION: self._apply_alloc_desired_transition,
            APPLY_PLAN_RESULTS: self._apply_plan_results,
            APPLY_PLAN_RESULTS_BATCH: self._apply_plan_results_batch,
            DEPLOYMENT_STATUS_UPDATE: self._apply_deployment_status_update,
            DEPLOYMENT_PROMOTE: self._apply_deployment_promote,
            DEPLOYMENT_ALLOC_HEALTH: self._apply_deployment_alloc_health,
            DEPLOYMENT_DELETE: self._apply_deployment_delete,
            PERIODIC_LAUNCH: self._apply_periodic_launch,
            SCHEDULER_CONFIG: self._apply_scheduler_config,
            AUTOPILOT_CONFIG: self._apply_autopilot_config,
            RECONCILE_SUMMARIES: self._apply_reconcile_summaries,
            ACL_POLICY_UPSERT: self._apply_acl_policy_upsert,
            ACL_POLICY_DELETE: self._apply_acl_policy_delete,
            ACL_TOKEN_UPSERT: self._apply_acl_token_upsert,
            ACL_TOKEN_DELETE: self._apply_acl_token_delete,
            VAULT_ACCESSOR_UPSERT: self._apply_vault_accessor_upsert,
            VAULT_ACCESSOR_DELETE: self._apply_vault_accessor_delete,
            NOOP: lambda index, payload: None,
        }

    # ------------------------------------------------------------------
    def apply(self, index: int, msg_type: str, payload: dict) -> Any:
        """Apply one committed log entry. Returns the applier's response
        (surfaced to the caller that proposed the entry)."""
        applier = self._appliers.get(msg_type)
        if applier is None:
            # Unknown types must not crash replication (fsm.go ignores
            # ignoreUnknownTypeFlag entries); log and skip.
            logger.error("fsm: unknown message type %r at index %d", msg_type, index)
            return None
        if self.time_table is not None and msg_type != NOOP:
            # witness index→time for GC age thresholds (fsm.go:258).
            # Noops are excluded to match the reference, where LogNoop
            # entries never reach fsm.Apply at all — every election
            # appends a term-start noop (the leadership barrier rides
            # its apply), and witnessing it would stamp "now" before any
            # real write (on a fresh cluster that poisons backdated
            # test witnesses; the next real apply witnesses anyway)
            self.time_table.witness(index)
        pre = None
        if self.event_broker is not None and msg_type in (
            DEPLOYMENT_DELETE, EVAL_DELETE,
        ):
            # deletions derive their events from objects that no longer
            # exist post-apply: capture them first so the events carry
            # the real namespace instead of a guessed 'default'
            pre = self._capture_pre_delete(msg_type, payload)
        # chaos crash points (testing/faults.py): a seeded kill before /
        # after the state mutation simulates a server dying mid-apply —
        # the crash-recovery storm restores from snapshot + log replay
        # and must find planes byte-identical to a cold rebuild
        _faults.fault_point("fsm.apply.pre")
        resp = applier(index, payload)
        _faults.fault_point("fsm.apply.post_state")
        if self.event_broker is not None and msg_type in (
            ACL_POLICY_UPSERT, ACL_POLICY_DELETE,
            ACL_TOKEN_UPSERT, ACL_TOKEN_DELETE,
        ):
            # capabilities may have shrunk: token-backed stream
            # subscriptions must re-resolve, not keep old grants
            self.event_broker.acl_changed()
        if self.event_broker is not None:
            # events derive AFTER the applier so lookups see post-apply
            # state; a derivation bug must never stall replication
            try:
                events = derive_events(
                    self.state, index, msg_type, payload, pre=pre
                )
                if events:
                    self.event_broker.publish(index, events)
            except Exception:
                logger.exception(
                    "fsm: event derivation failed for %r at index %d",
                    msg_type, index,
                )
        return resp

    def _capture_pre_delete(self, msg_type: str, payload: dict) -> dict:
        """The soon-to-be-deleted objects, keyed by id (event derivation
        needs their namespace/job after the applier removed them)."""
        if msg_type == DEPLOYMENT_DELETE:
            return {
                did: self.state.deployment_by_id(did)
                for did in payload.get("deployment_ids") or []
            }
        return {
            eid: self.state.eval_by_id(eid)
            for eid in payload.get("eval_ids") or []
        }

    # ------------------------------------------------------------------
    # snapshot / restore (ref fsm.go:1059,1073)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return self.state.persist()

    def restore(self, data: dict):
        self.state.restore(data)
        if self.event_broker is not None:
            # the event ring is re-derivable, never snapshotted: reset it
            # to the restored index so resuming subscribers observe an
            # explicit gap instead of silently missing the history
            self.event_broker.reset(self.state.latest_index())

    # ------------------------------------------------------------------
    # node appliers (ref fsm.go applyUpsertNode / applyDeregisterNode /
    # applyStatusUpdate / applyDrainUpdate / applyEligibilityUpdate)
    # ------------------------------------------------------------------
    def _apply_node_register(self, index: int, payload: dict):
        node = Node.from_dict(payload["node"])
        self.state.upsert_node(index, node)
        # new capacity unblocks class-matching blocked evals
        if self.blocked_evals is not None:
            if node.computed_class:
                self.blocked_evals.unblock(node.computed_class, index)
            self.blocked_evals.unblock_node(node.id, index)
        return index

    def _apply_node_deregister(self, index: int, payload: dict):
        self.state.delete_node(index, payload["node_id"])
        return index

    def _apply_node_status_update(self, index: int, payload: dict):
        self.state.update_node_status(
            index,
            payload["node_id"],
            payload["status"],
            updated_at_ns=payload.get("updated_at", 0),
        )
        if self.blocked_evals is not None and payload["status"] == "ready":
            node = self.state.node_by_id(payload["node_id"])
            if node is not None and node.computed_class:
                self.blocked_evals.unblock(node.computed_class, index)
            self.blocked_evals.unblock_node(payload["node_id"], index)
        return index

    def _apply_node_drain_update(self, index: int, payload: dict):
        from ..structs.model import DrainStrategy

        strategy = payload.get("drain_strategy")
        self.state.update_node_drain(
            index,
            payload["node_id"],
            payload["drain"],
            strategy=DrainStrategy.from_dict(strategy) if strategy else None,
            mark_eligible=payload.get("mark_eligible", False),
            updated_at_ns=payload.get("updated_at", 0),
        )
        return index

    def _apply_node_eligibility_update(self, index: int, payload: dict):
        self.state.update_node_eligibility(
            index,
            payload["node_id"],
            payload["eligibility"],
            updated_at_ns=payload.get("updated_at", 0),
        )
        return index

    def _apply_node_events_upsert(self, index: int, payload: dict):
        """ref fsm.go applyUpsertNodeEvent (NodeEventsUpsertRequestType):
        operational events — driver health flaps, device faults — appended
        to each node's bounded event ring."""
        self.state.upsert_node_events(index, payload["events"])
        return index

    # ------------------------------------------------------------------
    # job appliers (ref fsm.go applyUpsertJob / applyDeregisterJob)
    # ------------------------------------------------------------------
    def _apply_job_register(self, index: int, payload: dict):
        job = Job.from_dict(payload["job"])
        self.state.upsert_job(index, job)
        stored = self.state.job_by_id(job.namespace, job.id)
        if stored.is_periodic() and not stored.stopped():
            # Seed the launch checkpoint at registration (ref fsm.go
            # applyUpsertJob → UpsertPeriodicLaunch when none exists) so a
            # leader restored after downtime knows the job existed before
            # the outage and can catch up its missed first run. Stamped
            # with submit_time, which is deterministic across replicas.
            if self.state.periodic_launch_by_id(stored.namespace, stored.id) is None:
                self.state.upsert_periodic_launch(
                    index, stored.namespace, stored.id, stored.submit_time
                )
        if self.periodic_dispatcher is not None:
            # leader tracks periodic jobs as they are applied (fsm.go:330)
            if stored.is_periodic() and not stored.stopped():
                self.periodic_dispatcher.add(stored)
            else:
                self.periodic_dispatcher.remove(stored.namespace, stored.id)
        return index

    def _apply_job_deregister(self, index: int, payload: dict):
        ns, job_id = payload["namespace"], payload["job_id"]
        if payload.get("purge"):
            self.state.delete_job(index, ns, job_id)
        else:
            job = self.state.job_by_id(ns, job_id)
            if job is not None:
                stopped = job.copy()
                stopped.stop = True
                self.state.upsert_job(index, stopped)
        if self.periodic_dispatcher is not None:
            self.periodic_dispatcher.remove(ns, job_id)
        if self.blocked_evals is not None:
            self.blocked_evals.untrack(ns, job_id)
        return index

    def _apply_job_batch_deregister(self, index: int, payload: dict):
        for item in payload["jobs"]:
            self._apply_job_deregister(
                index,
                {
                    "namespace": item["namespace"],
                    "job_id": item["job_id"],
                    "purge": item.get("purge", False),
                },
            )
        self._apply_eval_update(index, {"evals": payload.get("evals", [])})
        return index

    def _apply_job_stability(self, index: int, payload: dict):
        self.state.update_job_stability(
            index,
            payload["namespace"],
            payload["job_id"],
            payload["version"],
            payload["stable"],
        )
        return index

    # ------------------------------------------------------------------
    # eval appliers (ref fsm.go applyUpdateEval:560-620)
    # ------------------------------------------------------------------
    def _apply_eval_update(self, index: int, payload: dict):
        evals = [Evaluation.from_dict(d) for d in payload["evals"]]
        if not evals:
            return index
        self.state.upsert_evals(index, evals)
        self._handle_upserted_evals(evals)
        return index

    def _handle_upserted_evals(self, evals: list[Evaluation]):
        """Leader-side broker routing of applied evals (fsm.go:585-618):
        pending → broker, blocked → blocked-tracker, others untracked."""
        for ev in evals:
            stored = self.state.eval_by_id(ev.id)
            if stored is None:
                continue
            if stored.should_enqueue():
                if self.eval_broker is not None:
                    self.eval_broker.enqueue(stored)
            elif stored.should_block():
                if self.blocked_evals is not None:
                    self.blocked_evals.block(stored)
            elif (
                self.blocked_evals is not None
                and stored.status == "complete"
                and not stored.failed_tg_allocs
            ):
                # fully-satisfied eval: drop any tracked blocked eval for
                # the job (fsm.go:612-617)
                self.blocked_evals.untrack(stored.namespace, stored.job_id)

    def _apply_eval_delete(self, index: int, payload: dict):
        self.state.delete_evals(
            index, payload.get("eval_ids", []), payload.get("alloc_ids", [])
        )
        return index

    # ------------------------------------------------------------------
    # alloc appliers (ref fsm.go applyAllocUpdate / applyAllocClientUpdate /
    # applyAllocUpdateDesiredTransition)
    # ------------------------------------------------------------------
    def _apply_alloc_update(self, index: int, payload: dict):
        allocs = [Allocation.from_dict(d) for d in payload["allocs"]]
        self.state.upsert_allocs(index, allocs)
        return index

    def _apply_alloc_client_update(self, index: int, payload: dict):
        allocs = [Allocation.from_dict(d) for d in payload["allocs"]]
        self.state.update_allocs_from_client(index, allocs)
        # an alloc turning terminal frees capacity on ITS node: per-node
        # system blocked evals re-enter (ref blocked_evals_system.go;
        # the fsm's applyAllocClientUpdate → UnblockNode)
        if self.blocked_evals is not None:
            for a in allocs:
                if a.node_id and a.terminal_status():
                    self.blocked_evals.unblock_node(a.node_id, index)
        # evals created by the endpoint ride the same log entry
        # (ref node_endpoint.go UpdateAlloc → AllocUpdateRequest.Evals)
        self._apply_eval_update(index, {"evals": payload.get("evals", [])})
        return index

    def _apply_alloc_desired_transition(self, index: int, payload: dict):
        updates = []
        for alloc_id, transition in payload["allocs"].items():
            stored = self.state.alloc_by_id(alloc_id)
            if stored is None:
                continue
            ac = stored.copy()
            if transition.get("migrate") is not None:
                ac.desired_transition.migrate = transition["migrate"]
            if transition.get("reschedule") is not None:
                ac.desired_transition.reschedule = transition["reschedule"]
            if transition.get("force_reschedule") is not None:
                ac.desired_transition.force_reschedule = transition["force_reschedule"]
            updates.append(ac)
        if updates:
            self.state.upsert_allocs(index, updates)
        self._apply_eval_update(index, {"evals": payload.get("evals", [])})
        return index

    # ------------------------------------------------------------------
    # plan apply (ref fsm.go applyPlanResults → UpsertPlanResults)
    # ------------------------------------------------------------------
    def _apply_plan_results_batch(self, index: int, payload: dict):
        """Several independent verified plans committed in ONE raft entry
        (one fsync, one consensus round-trip): the applier batches queued
        plans it has verified against stacked optimistic snapshots, so the
        sequential application here reproduces exactly the world each was
        verified against (ref plan_apply.go:49-180 — the reference keeps
        one commit in flight; batching amortizes the consensus cost the
        same way its async applyPlan pipelining does)."""
        for item in payload.get("plans", []):
            self._apply_plan_results(index, item)
        return index

    def _apply_plan_results(self, index: int, payload: dict):
        from ..trace import tracer

        # raft-entry trace annotation (leader-minted): spans THIS
        # replica's apply and links the committed index to the eval's
        # trace so the ColumnarMirror's patch spans attach later. Popped
        # before use — it never reaches state-store objects. Followers,
        # whose store never opened the leader's trace, skip recording
        # entirely (their spans would only be dropped on arrival)
        trace_ctx = tracer.ctx_from_annotation(payload.get("trace"))
        if trace_ctx is not None and not tracer.store.knows(
            trace_ctx.trace_id
        ):
            trace_ctx = None
        t0 = time.monotonic()
        plan = Plan.from_dict(payload["plan"])
        if payload.get("normalized"):
            result = self._denormalize_plan_result(payload["result"])
        else:
            result = PlanResult.from_dict(payload["result"])
        preemption_evals = [
            Evaluation.from_dict(d) for d in payload.get("preemption_evals", [])
        ]
        if trace_ctx is not None:
            # linked BEFORE the upsert publishes the plan frame: a
            # mirror sync on another thread can consume the frame
            # immediately, and its ctxs_for_index lookup must not race
            # an unlinked index (the mirror.patch hop would be lost)
            tracer.link_index(index, trace_ctx)
        self.state.upsert_plan_results(
            index, plan, result, preemption_evals=preemption_evals
        )
        self._handle_upserted_evals(preemption_evals)
        if trace_ctx is not None:
            tracer.record_span(
                "fsm.apply_plan", trace_ctx, t0, time.monotonic(),
                tags={"index": index},
            )
        return index

    def _denormalize_plan_result(self, doc: dict) -> PlanResult:
        """Rehydrate stop/preemption diffs from this replica's own state
        (ref fsm.go denormalizeAllocationDiffSlice): the full documents are
        already replicated here, the diff carries only what changed."""

        def rehydrate(diff_map: dict) -> dict:
            out: dict = {}
            for node_id, diffs in diff_map.items():
                allocs = []
                for d in diffs:
                    stored = self.state.alloc_by_id(d["id"])
                    if stored is None:
                        logger.warning(
                            "plan diff references unknown alloc %s", d["id"]
                        )
                        continue
                    # shallow clone (bulk stops are the raft hot path) that
                    # keeps stored.job: nulling the job would make the
                    # store re-attach plan.job, which for a PREEMPTION
                    # victim is the preemptor's job, not the victim's
                    a = fast_alloc_clone(stored)
                    a.desired_status = d["desired_status"]
                    a.desired_description = d["desired_description"]
                    if d.get("client_status"):
                        a.client_status = d["client_status"]
                    if d.get("preempted_by_allocation"):
                        a.preempted_by_allocation = d["preempted_by_allocation"]
                    allocs.append(a)
                out[node_id] = allocs
            return out

        # shared job documents ship once per plan; reattach by ref. The
        # parsed Job object is deliberately shared across the plan's
        # placements — the store treats published objects as immutable.
        jobs = {
            jkey: Job.from_dict(jd)
            for jkey, jd in doc.get("jobs", {}).items()
        }

        def placement(x: dict) -> Allocation:
            # get, not pop: the payload dict lives in the raft log and may
            # be re-applied on restore; from_dict ignores unknown keys
            jkey = x.get("job_ref")
            a = Allocation.from_dict(x)
            if jkey is not None:
                a.job = jobs[jkey]
            return a

        return PlanResult(
            node_update=rehydrate(doc.get("node_update", {})),
            node_preemptions=rehydrate(doc.get("node_preemptions", {})),
            node_allocation={
                node_id: [placement(x) for x in allocs]
                for node_id, allocs in doc.get("node_allocation", {}).items()
            },
            deployment=(
                Deployment.from_dict(doc["deployment"])
                if doc.get("deployment")
                else None
            ),
            deployment_updates=[
                DeploymentStatusUpdate.from_dict(u)
                for u in doc.get("deployment_updates", [])
            ],
            refresh_index=doc.get("refresh_index", 0),
        )

    # ------------------------------------------------------------------
    # deployment appliers (ref fsm.go applyDeployment*)
    # ------------------------------------------------------------------
    def _apply_deployment_status_update(self, index: int, payload: dict):
        update = DeploymentStatusUpdate.from_dict(payload["update"])
        self.state.update_deployment_status(index, update)
        if payload.get("job") is not None:
            self.state.upsert_job(index, Job.from_dict(payload["job"]))
        self._apply_eval_update(
            index,
            {"evals": [payload["eval"]] if payload.get("eval") else []},
        )
        return index

    def _apply_deployment_promote(self, index: int, payload: dict):
        self.state.update_deployment_promotion(
            index,
            payload["deployment_id"],
            payload.get("groups", []),
            payload.get("all", False),
        )
        self._apply_eval_update(
            index,
            {"evals": [payload["eval"]] if payload.get("eval") else []},
        )
        return index

    def _apply_deployment_alloc_health(self, index: int, payload: dict):
        self.state.update_deployment_alloc_health(
            index,
            payload["deployment_id"],
            payload.get("healthy_ids", []),
            payload.get("unhealthy_ids", []),
            timestamp_ns=payload.get("timestamp", 0),
        )
        if payload.get("deployment_status_update") is not None:
            self.state.update_deployment_status(
                index,
                DeploymentStatusUpdate.from_dict(
                    payload["deployment_status_update"]
                ),
            )
        if payload.get("job") is not None:
            self.state.upsert_job(index, Job.from_dict(payload["job"]))
        self._apply_eval_update(
            index,
            {"evals": [payload["eval"]] if payload.get("eval") else []},
        )
        return index

    def _apply_deployment_delete(self, index: int, payload: dict):
        self.state.delete_deployment(index, payload["deployment_ids"])
        return index

    # ------------------------------------------------------------------
    def _apply_periodic_launch(self, index: int, payload: dict):
        self.state.upsert_periodic_launch(
            index, payload["namespace"], payload["job_id"], payload["launch"]
        )
        return index

    def _apply_scheduler_config(self, index: int, payload: dict):
        self.state.set_scheduler_config(index, payload["config"])
        return index

    def _apply_autopilot_config(self, index: int, payload: dict):
        self.state.set_autopilot_config(index, payload["config"])
        return index

    def _apply_reconcile_summaries(self, index: int, payload: dict):
        self.state.reconcile_job_summaries(index)
        return index

    # ------------------------------------------------------------------
    # ACL appliers (ref fsm.go applyACL*; store methods land with the ACL
    # subsystem — gated so replication of ACL entries never crashes)
    # ------------------------------------------------------------------
    def _apply_vault_accessor_upsert(self, index: int, payload: dict):
        self.state.upsert_vault_accessors(index, payload["accessors"])
        return index

    def _apply_vault_accessor_delete(self, index: int, payload: dict):
        self.state.delete_vault_accessors(index, payload["accessors"])
        return index

    def _apply_acl_policy_upsert(self, index: int, payload: dict):
        if hasattr(self.state, "upsert_acl_policies"):
            self.state.upsert_acl_policies(index, payload["policies"])
        return index

    def _apply_acl_policy_delete(self, index: int, payload: dict):
        if hasattr(self.state, "delete_acl_policies"):
            self.state.delete_acl_policies(index, payload["names"])
        return index

    def _apply_acl_token_upsert(self, index: int, payload: dict):
        self.state.upsert_acl_tokens(
            index, payload["tokens"], bootstrap=payload.get("bootstrap", False)
        )
        return index

    def _apply_acl_token_delete(self, index: int, payload: dict):
        if hasattr(self.state, "delete_acl_tokens"):
            self.state.delete_acl_tokens(index, payload["accessors"])
        return index


# ----------------------------------------------------------------------
# Event derivation (ref nomad/state/events.go eventsFromChanges: each
# applied message type maps to typed events tagged with its raft index).
# Module-level and pure-ish (reads post-apply state for lookups only) so
# the mapping is testable without a full FSM.
# ----------------------------------------------------------------------

def _alloc_doc(state, alloc_id: str, fallback: Optional[dict] = None) -> dict:
    """Canonical slim alloc doc from post-apply state (client updates
    ship only client-owned fields, so the payload alone can't provide
    job/deployment filter keys); falls back to the payload doc when the
    alloc is already GC'd. Carries the alloc's dense usage vector and
    terminal flag so the columnar mirror (tpu/mirror.py) can patch its
    ``used`` plane from the event alone — derived here, synchronously
    inside the apply, so the vector reflects exactly this raft index."""
    stored = state.alloc_by_id(alloc_id)
    if stored is None:
        # already deleted: whatever it contributed is gone with it
        return dict(fallback or {}, id=alloc_id, _terminal=True)
    from ..state.planes import exotic_flag, usage_vec

    return {
        "id": stored.id,
        "namespace": stored.namespace,
        "job_id": stored.job_id,
        "node_id": stored.node_id,
        "task_group": stored.task_group,
        "desired_status": stored.desired_status,
        "client_status": stored.client_status,
        "eval_id": stored.eval_id,
        "deployment_id": stored.deployment_id,
        "_terminal": stored.terminal_status(),
        "_usage": usage_vec(stored),
        # ports/devices flag: lets the mirror keep per-row exotic counts
        # so the plan applier's dense device verify knows which rows must
        # take the exact host check (core/plan_apply.py)
        "_exotic": exotic_flag(stored),
    }


def _alloc_event(index: int, doc: dict, event_type: str) -> "Event":
    from ..events import TOPIC_ALLOC, Event

    filter_keys = tuple(
        k for k in (
            doc.get("job_id"), doc.get("node_id"),
            doc.get("eval_id"), doc.get("deployment_id"),
        ) if k
    )
    payload = {
        "ID": doc.get("id", ""),
        "JobID": doc.get("job_id", ""),
        "NodeID": doc.get("node_id", ""),
        "TaskGroup": doc.get("task_group", ""),
        "DesiredStatus": doc.get("desired_status", ""),
        "ClientStatus": doc.get("client_status", ""),
        "DeploymentID": doc.get("deployment_id", ""),
    }
    if "_terminal" in doc:
        # mirror-plane fields (tpu/mirror.py): terminality + the alloc's
        # dense (cpu, mem, disk, mbits) contribution at this raft index
        payload["Terminal"] = bool(doc["_terminal"])
        if doc.get("_usage") is not None:
            payload["Resources"] = list(doc["_usage"])
        # missing (GC-fallback doc) reads as True downstream — the mirror
        # defaults unknown allocs to exotic, degrading verify not parity
        if "_exotic" in doc:
            payload["Exotic"] = bool(doc["_exotic"])
    return Event(
        topic=TOPIC_ALLOC,
        type=event_type,
        key=doc.get("id", ""),
        index=index,
        namespace=doc.get("namespace", "default"),
        payload=payload,
        filter_keys=filter_keys,
    )


def _eval_events(index: int, evals: list, event_type: str = "EvalUpdated"):
    from ..events import TOPIC_EVAL, Event

    out = []
    for doc in evals or []:
        out.append(
            Event(
                topic=TOPIC_EVAL,
                type=event_type,
                key=doc.get("id", ""),
                index=index,
                namespace=doc.get("namespace", "default"),
                payload={
                    "ID": doc.get("id", ""),
                    "JobID": doc.get("job_id", ""),
                    "Status": doc.get("status", ""),
                    "Type": doc.get("type", ""),
                    "TriggeredBy": doc.get("triggered_by", ""),
                    "DeploymentID": doc.get("deployment_id", ""),
                },
                filter_keys=tuple(
                    k for k in (doc.get("job_id"), doc.get("deployment_id"))
                    if k
                ),
            )
        )
    return out


def _node_event(index: int, node_id: str, event_type: str, payload: dict):
    from ..events import TOPIC_NODE, Event

    return Event(
        topic=TOPIC_NODE,
        type=event_type,
        key=node_id,
        index=index,
        payload=dict(payload, ID=node_id),
    )


def _deployment_event(
    state, index: int, deployment_id: str, event_type: str, payload: dict,
    deployment=None,
):
    from ..events import TOPIC_DEPLOYMENT, Event

    d = deployment if deployment is not None else state.deployment_by_id(
        deployment_id
    )
    return Event(
        topic=TOPIC_DEPLOYMENT,
        type=event_type,
        key=deployment_id,
        index=index,
        namespace=d.namespace if d is not None else "default",
        payload=dict(
            payload,
            ID=deployment_id,
            JobID=d.job_id if d is not None else "",
            Status=d.status if d is not None else "",
        ),
        filter_keys=(d.job_id,) if d is not None and d.job_id else (),
    )


def _job_event(index: int, namespace: str, job_id: str, event_type: str,
               payload: Optional[dict] = None):
    from ..events import TOPIC_JOB, Event

    return Event(
        topic=TOPIC_JOB,
        type=event_type,
        key=job_id,
        index=index,
        namespace=namespace or "default",
        payload=dict(payload or {}, ID=job_id, Namespace=namespace),
    )


def _job_registered_event(state, index: int, job_doc: dict):
    """The registered-job event, versioned from POST-apply state: the
    store assigns the version during apply (existing.version + 1), so the
    raft payload's own version field is stale on every update."""
    ns = job_doc.get("namespace", "default")
    job_id = job_doc.get("id", "")
    stored = state.job_by_id(ns, job_id)
    return _job_event(
        index, ns, job_id, "JobRegistered",
        {
            "Type": (
                stored.type if stored is not None
                else job_doc.get("type", "")
            ),
            "Version": (
                stored.version if stored is not None
                else job_doc.get("version", 0)
            ),
        },
    )


def _plan_events(state, index: int, payload: dict) -> list:
    from ..events import TOPIC_PLAN_RESULT, Event

    plan = payload.get("plan") or {}
    result = payload.get("result") or {}
    events = []
    n_place = sum(
        len(v) for v in (result.get("node_allocation") or {}).values()
    )
    n_stop = sum(len(v) for v in (result.get("node_update") or {}).values())
    n_preempt = sum(
        len(v) for v in (result.get("node_preemptions") or {}).values()
    )
    events.append(
        Event(
            topic=TOPIC_PLAN_RESULT,
            type="PlanResult",
            key=plan.get("eval_id", ""),
            index=index,
            namespace=(plan.get("job") or {}).get("namespace", "default"),
            payload={
                "EvalID": plan.get("eval_id", ""),
                "JobID": plan.get("job_id", "")
                or (plan.get("job") or {}).get("id", ""),
                "NodeAllocation": n_place,
                "NodeUpdate": n_stop,
                "NodePreemptions": n_preempt,
                "Deployment": (result.get("deployment") or {}).get("id", ""),
            },
            filter_keys=tuple(
                k for k in (
                    plan.get("job_id")
                    or (plan.get("job") or {}).get("id"),
                ) if k
            ),
        )
    )
    for allocs in (result.get("node_allocation") or {}).values():
        for doc in allocs:
            # placements were just upserted: read them back post-apply so
            # the event carries the canonical doc (incl. the usage vector
            # the columnar mirror patches from)
            events.append(
                _alloc_event(
                    index, _alloc_doc(state, doc.get("id", ""), doc),
                    "AllocationUpdated",
                )
            )
    # stops/preemptions travel as id+field diffs when normalized; the
    # full documents live in this replica's (post-apply) state
    for diff_map, etype in (
        (result.get("node_update") or {}, "AllocationStopped"),
        (result.get("node_preemptions") or {}, "AllocationPreempted"),
    ):
        for diffs in diff_map.values():
            for d in diffs:
                events.append(
                    _alloc_event(
                        index, _alloc_doc(state, d.get("id", ""), d), etype
                    )
                )
    deployment = result.get("deployment")
    if deployment:
        events.append(
            _deployment_event(
                state, index, deployment.get("id", ""),
                "DeploymentStatusUpdate", {},
            )
        )
    for update in result.get("deployment_updates") or []:
        events.append(
            _deployment_event(
                state, index, update.get("deployment_id", ""),
                "DeploymentStatusUpdate",
                {"StatusDescription": update.get("status_description", "")},
            )
        )
    events.extend(_eval_events(index, payload.get("preemption_evals")))
    return events


def derive_events(
    state, index: int, msg_type: str, payload: dict, pre: Optional[dict] = None
) -> list:
    """Typed events for one applied log entry (called post-apply; ``pre``
    carries pre-apply snapshots of objects a delete entry removed)."""
    from ..events import TOPIC_NODE_EVENT, Event

    if msg_type == NODE_REGISTER:
        node = payload.get("node") or {}
        return [
            _node_event(
                index, node.get("id", ""), "NodeRegistration",
                {"Name": node.get("name", ""), "Status": node.get("status", "")},
            )
        ]
    if msg_type == NODE_DEREGISTER:
        return [
            _node_event(index, payload.get("node_id", ""),
                        "NodeDeregistration", {})
        ]
    if msg_type == NODE_STATUS_UPDATE:
        return [
            _node_event(
                index, payload.get("node_id", ""), "NodeStatusUpdate",
                {"Status": payload.get("status", "")},
            )
        ]
    if msg_type == NODE_DRAIN_UPDATE:
        return [
            _node_event(
                index, payload.get("node_id", ""), "NodeDrain",
                {"Drain": bool(payload.get("drain"))},
            )
        ]
    if msg_type == NODE_ELIGIBILITY_UPDATE:
        return [
            _node_event(
                index, payload.get("node_id", ""), "NodeEligibility",
                {"Eligibility": payload.get("eligibility", "")},
            )
        ]
    if msg_type == NODE_EVENTS_UPSERT:
        return [
            Event(
                topic=TOPIC_NODE_EVENT,
                type="NodeEvent",
                key=node_id,
                index=index,
                payload={"ID": node_id, "Events": list(node_events)},
            )
            for node_id, node_events in (payload.get("events") or {}).items()
        ]
    if msg_type == JOB_REGISTER:
        return [_job_registered_event(state, index, payload.get("job") or {})]
    if msg_type == JOB_DEREGISTER:
        return [
            _job_event(
                index, payload.get("namespace", "default"),
                payload.get("job_id", ""), "JobDeregistered",
                {"Purge": bool(payload.get("purge"))},
            )
        ]
    if msg_type == JOB_BATCH_DEREGISTER:
        events = [
            _job_event(
                index, item.get("namespace", "default"),
                item.get("job_id", ""), "JobDeregistered",
                {"Purge": bool(item.get("purge"))},
            )
            for item in payload.get("jobs") or []
        ]
        events.extend(_eval_events(index, payload.get("evals")))
        return events
    if msg_type == JOB_STABILITY:
        return [
            _job_event(
                index, payload.get("namespace", "default"),
                payload.get("job_id", ""), "JobStabilityUpdated",
                {
                    "Version": payload.get("version", 0),
                    "Stable": bool(payload.get("stable")),
                },
            )
        ]
    if msg_type == EVAL_UPDATE:
        return _eval_events(index, payload.get("evals"))
    if msg_type == EVAL_DELETE:
        from ..events import TOPIC_EVAL

        events = []
        for eval_id in payload.get("eval_ids") or []:
            stored = (pre or {}).get(eval_id)
            events.append(
                Event(
                    topic=TOPIC_EVAL, type="EvalDeleted", key=eval_id,
                    index=index,
                    namespace=(
                        stored.namespace if stored is not None else "default"
                    ),
                    payload={
                        "ID": eval_id,
                        "JobID": stored.job_id if stored is not None else "",
                    },
                    filter_keys=(
                        (stored.job_id,)
                        if stored is not None and stored.job_id
                        else ()
                    ),
                )
            )
        return events
    if msg_type in (ALLOC_UPDATE, ALLOC_CLIENT_UPDATE):
        etype = (
            "AllocationClientUpdated"
            if msg_type == ALLOC_CLIENT_UPDATE
            else "AllocationUpdated"
        )
        events = [
            _alloc_event(
                index, _alloc_doc(state, doc.get("id", ""), doc), etype
            )
            for doc in payload.get("allocs") or []
        ]
        events.extend(_eval_events(index, payload.get("evals")))
        return events
    if msg_type == ALLOC_DESIRED_TRANSITION:
        events = [
            _alloc_event(
                index, _alloc_doc(state, alloc_id),
                "AllocationDesiredTransition",
            )
            for alloc_id in (payload.get("allocs") or {})
        ]
        events.extend(_eval_events(index, payload.get("evals")))
        return events
    if msg_type == APPLY_PLAN_RESULTS:
        return _plan_events(state, index, payload)
    if msg_type == APPLY_PLAN_RESULTS_BATCH:
        events = []
        for item in payload.get("plans") or []:
            events.extend(_plan_events(state, index, item))
        return events
    if msg_type == DEPLOYMENT_STATUS_UPDATE:
        update = payload.get("update") or {}
        events = [
            _deployment_event(
                state, index, update.get("deployment_id", ""),
                "DeploymentStatusUpdate",
                {"StatusDescription": update.get("status_description", "")},
            )
        ]
        if payload.get("job"):
            events.append(
                _job_registered_event(state, index, payload["job"])
            )
        events.extend(
            _eval_events(index, [payload["eval"]] if payload.get("eval") else [])
        )
        return events
    if msg_type == DEPLOYMENT_PROMOTE:
        events = [
            _deployment_event(
                state, index, payload.get("deployment_id", ""),
                "DeploymentPromotion",
                {"All": bool(payload.get("all")),
                 "Groups": list(payload.get("groups") or [])},
            )
        ]
        events.extend(
            _eval_events(index, [payload["eval"]] if payload.get("eval") else [])
        )
        return events
    if msg_type == DEPLOYMENT_ALLOC_HEALTH:
        events = [
            _deployment_event(
                state, index, payload.get("deployment_id", ""),
                "DeploymentAllocHealth",
                {
                    "Healthy": list(payload.get("healthy_ids") or []),
                    "Unhealthy": list(payload.get("unhealthy_ids") or []),
                },
            )
        ]
        events.extend(
            _eval_events(index, [payload["eval"]] if payload.get("eval") else [])
        )
        return events
    if msg_type == DEPLOYMENT_DELETE:
        return [
            _deployment_event(
                state, index, did, "DeploymentDeleted", {},
                deployment=(pre or {}).get(did),
            )
            for did in payload.get("deployment_ids") or []
        ]
    # config/ACL/vault/periodic-launch entries carry no stream events
    # (ACL/vault payloads are sensitive; the rest are operator plumbing,
    # matching the reference's 7-topic surface)
    return []
