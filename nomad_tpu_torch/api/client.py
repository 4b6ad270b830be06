"""HTTP API client (ref api/ — the Go SDK's typed client surface)."""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional


def _q(segment: str) -> str:
    """Percent-encode one path segment: derived child job IDs embed '/'
    (``<id>/periodic-<ts>``) and must travel as a single segment."""
    return urllib.parse.quote(segment, safe="")


class APIError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class ApiClient:
    """ref api/api.go Client"""

    def __init__(
        self,
        address: Optional[str] = None,
        namespace: str = "default",
        token: Optional[str] = None,
    ):
        self.address = (
            address
            or os.environ.get("NOMAD_TPU_ADDR")
            or "http://127.0.0.1:4646"
        ).rstrip("/")
        self.namespace = namespace
        # bearer secret sent as X-Nomad-Token (ref api.Client SecretID)
        self.token = token or os.environ.get("NOMAD_TPU_TOKEN") or ""

    def alloc_exec_session(
        self, alloc_id: str, task: str, cmd: list, tty: bool = False
    ):
        """Open the interactive exec websocket (ref api/allocations.go
        Exec); returns an ExecWsSession with send_stdin/recv_frame/close."""
        from .ws import WsClient

        params = urllib.parse.urlencode(
            {
                "task": task,
                "command": json.dumps(list(cmd)),
                "tty": "true" if tty else "false",
            }
        )
        address = self.address
        tls = address.startswith("https://")
        for prefix in ("http://", "https://"):
            if address.startswith(prefix):
                address = address[len(prefix):]
        ws = WsClient(
            address,
            f"/v1/client/allocation/{_q(alloc_id)}/exec?{params}",
            token=self.token,
            tls=tls,
        )
        return ExecWsSession(ws)

    def _request(self, method: str, path: str, params=None, body=None,
                 headers=None, raw=False):
        url = self.address + path
        params = dict(params or {})
        # the client's namespace rides every request unless overridden
        # (ref api.Client QueryOptions.Namespace)
        if self.namespace != "default" and "namespace" not in params and "?" not in path:
            params["namespace"] = self.namespace
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        if self.token:
            req.add_header("X-Nomad-Token", self.token)
        try:
            with urllib.request.urlopen(req, timeout=330) as resp:
                content = resp.read()
                index = resp.headers.get("X-Nomad-Index")
                index = int(index) if index else None
                if raw:
                    # binary surfaces (the debug-bundle tarball): bytes
                    # as served, no JSON decode
                    return content, index
                return json.loads(content or b"null"), index
        except urllib.error.HTTPError as e:
            try:
                message = json.loads(e.read()).get("error", str(e))
            except Exception:
                message = str(e)
            raise APIError(e.code, message) from e

    def get(self, url: str, **params):
        return self._request("GET", url, params=params or None)

    def put(self, url: str, body=None, **params):
        return self._request("PUT", url, params=params or None, body=body)

    def delete(self, url: str, **params):
        return self._request("DELETE", url, params=params or None)

    # -- typed helpers ---------------------------------------------------
    def jobs(self, prefix: str = ""):
        return self.get("/v1/jobs", **({"prefix": prefix} if prefix else {}))[0]

    def register_job(self, job_dict: dict) -> dict:
        return self.put("/v1/jobs", body={"Job": job_dict})[0]

    def plan_job(self, job_dict: dict, diff: bool = True) -> dict:
        return self.put(
            f"/v1/job/{_q(job_dict.get('id', ''))}/plan",
            body={"Job": job_dict, "Diff": diff},
        )[0]

    def job(self, job_id: str) -> dict:
        return self.get(f"/v1/job/{_q(job_id)}")[0]

    def deregister_job(self, job_id: str, purge: bool = False) -> dict:
        params = {"purge": "true"} if purge else {}
        return self.delete(f"/v1/job/{_q(job_id)}", **params)[0]

    def job_allocations(self, job_id: str):
        return self.get(f"/v1/job/{_q(job_id)}/allocations")[0]

    def job_evaluations(self, job_id: str):
        return self.get(f"/v1/job/{_q(job_id)}/evaluations")[0]

    def job_summary(self, job_id: str):
        return self.get(f"/v1/job/{_q(job_id)}/summary")[0]

    def nodes(self):
        return self.get("/v1/nodes")[0]

    def node(self, node_id: str):
        return self.get(f"/v1/node/{node_id}")[0]

    def node_allocations(self, node_id: str):
        return self.get(f"/v1/node/{node_id}/allocations")[0]

    def drain_node(
        self,
        node_id: str,
        enable: bool = True,
        deadline_ns: int = 0,
        ignore_system_jobs: bool = False,
    ):
        body = {"DrainSpec": None}
        if enable:
            body["DrainSpec"] = {
                "Deadline": deadline_ns,
                "IgnoreSystemJobs": ignore_system_jobs,
            }
        return self.put(f"/v1/node/{node_id}/drain", body=body)[0]

    def allocations(self, prefix: str = ""):
        return self.get(
            "/v1/allocations", **({"prefix": prefix} if prefix else {})
        )[0]

    def allocation(self, alloc_id: str):
        return self.get(f"/v1/allocation/{alloc_id}")[0]

    def evaluations(self):
        return self.get("/v1/evaluations")[0]

    def evaluation(self, eval_id: str):
        return self.get(f"/v1/evaluation/{eval_id}")[0]

    def deployments(self):
        return self.get("/v1/deployments")[0]

    def deployment(self, deployment_id: str):
        return self.get(f"/v1/deployment/{deployment_id}")[0]

    def deployment_allocations(self, deployment_id: str):
        return self.get(f"/v1/deployment/allocations/{deployment_id}")[0]

    def deployment_promote(self, deployment_id: str, groups=None):
        body = {"Groups": groups} if groups else {"All": True}
        return self.put(f"/v1/deployment/promote/{deployment_id}", body=body)[0]

    def deployment_fail(self, deployment_id: str):
        return self.put(f"/v1/deployment/fail/{deployment_id}")[0]

    def deployment_pause(self, deployment_id: str, pause: bool = True):
        return self.put(
            f"/v1/deployment/pause/{deployment_id}", body={"Pause": pause}
        )[0]

    def job_deployments(self, job_id: str):
        return self.get(f"/v1/job/{_q(job_id)}/deployments")[0]

    def job_revert(self, job_id: str, version: int):
        return self.put(
            f"/v1/job/{_q(job_id)}/revert", body={"JobVersion": version}
        )[0]

    def job_versions(self, job_id: str):
        return self.get(f"/v1/job/{_q(job_id)}/versions")[0]

    def job_dispatch(self, job_id: str, payload: str = "", meta=None):
        import base64 as _b64

        body = {
            "Payload": _b64.b64encode(payload.encode()).decode() if payload else "",
            "Meta": meta or {},
        }
        return self.put(f"/v1/job/{_q(job_id)}/dispatch", body=body)[0]

    def job_periodic_force(self, job_id: str):
        return self.put(f"/v1/job/{_q(job_id)}/periodic/force")[0]

    def agent_self(self):
        return self.get("/v1/agent/self")[0]

    def metrics(self):
        return self.get("/v1/metrics")[0]

    # -- trace plane (OBSERVABILITY.md) ---------------------------------
    def traces(self, limit: int = 50, slowest: bool = False,
               errors: bool = False) -> dict:
        params = {"limit": limit}
        if slowest:
            params["slowest"] = "true"
        if errors:
            params["errors"] = "true"
        return self.get("/v1/trace", **params)[0]

    def trace(self, trace_id: str) -> dict:
        return self.get(f"/v1/trace/{_q(trace_id)}")[0]

    def trace_critical_path(self, tail: float = 0.99) -> dict:
        return self.get("/v1/trace/critical-path", tail=tail)[0]

    def device_stats(self) -> dict:
        """The device plane's ``tpu_devprof`` payload from a live
        server: compile ledger + HLO collective census, transfer
        totals, collective-round counters (the ``operator device`` CLI
        surface; OBSERVABILITY.md "The device plane")."""
        return self.metrics().get("tpu_devprof") or {}

    # -- debug plane (OBSERVABILITY.md: profiler / bundles) --------------
    def debug_pprof(self, profile: str = "", seconds: float = None,
                    hz: float = None) -> dict:
        """``/debug/pprof/<profile>`` (enable_debug-gated): the default
        empty profile returns the one-shot thread-stacks+gc dump;
        ``profile="profile"`` with ``seconds=N`` runs the sampling
        wall-clock profiler and returns its folded-stack report."""
        params = {}
        if seconds is not None:
            params["seconds"] = seconds
        if hz is not None:
            params["hz"] = hz
        return self.get(f"/debug/pprof/{profile}", **params)[0]

    def debug_bundle_json(self, seconds: float = 1.0) -> dict:
        """The bundle's manifest + parsed contents inline (?format=json)."""
        return self.get(
            "/v1/debug/bundle", seconds=seconds, format="json"
        )[0]

    def debug_bundle(self, seconds: float = 1.0,
                     output: Optional[str] = None) -> bytes:
        """Capture a debug bundle tarball from the agent (the `operator
        debug` wire call); returns the gzip bytes and writes them to
        ``output`` when given."""
        data, _ = self._request(
            "GET", "/v1/debug/bundle", params={"seconds": seconds},
            raw=True,
        )
        if output:
            with open(output, "wb") as f:
                f.write(data)
        return data

    def validate_job(self, job_dict: dict) -> dict:
        return self.put("/v1/validate/job", body={"Job": job_dict})[0]

    def agent_members(self) -> dict:
        return self.get("/v1/agent/members")[0]

    def agent_join(self, address: str) -> dict:
        return self.put("/v1/agent/join", address=address)[0]

    def agent_force_leave(self, node: str) -> dict:
        return self.put("/v1/agent/force-leave", node=node)[0]

    def agent_servers(self) -> list:
        return self.get("/v1/agent/servers")[0]

    def agent_health(self) -> dict:
        return self.get("/v1/agent/health")[0]

    def status_peers(self) -> list:
        return self.get("/v1/status/peers")[0]

    def node_purge(self, node_id: str) -> dict:
        return self.put(f"/v1/node/{_q(node_id)}/purge")[0]

    def eval_allocations(self, eval_id: str) -> list:
        return self.get(f"/v1/evaluation/{_q(eval_id)}/allocations")[0]

    def raft_configuration(self) -> dict:
        return self.get("/v1/operator/raft/configuration")[0]

    def raft_remove_peer(self, peer_id: str) -> dict:
        return self.delete("/v1/operator/raft/peer", id=peer_id)[0]

    def autopilot_configuration(self) -> dict:
        return self.get("/v1/operator/autopilot/configuration")[0]

    def autopilot_set_configuration(self, config: dict) -> dict:
        return self.put("/v1/operator/autopilot/configuration", body=config)[0]

    def autopilot_health(self) -> dict:
        return self.get("/v1/operator/autopilot/health")[0]

    def reconcile_summaries(self) -> dict:
        return self.put("/v1/system/reconcile/summaries")[0]

    def system_gc(self) -> dict:
        return self.put("/v1/system/gc")[0]

    def acl_token_self(self) -> dict:
        return self.get("/v1/acl/token/self")[0]

    def alloc_stop(self, alloc_id: str) -> dict:
        return self.put(f"/v1/allocation/{_q(alloc_id)}/stop")[0]

    def alloc_restart(self, alloc_id: str, task: str = "") -> dict:
        return self.put(
            f"/v1/client/allocation/{_q(alloc_id)}/restart",
            body={"TaskName": task},
        )[0]

    def alloc_signal(
        self, alloc_id: str, signal: str = "SIGINT", task: str = ""
    ) -> dict:
        return self.put(
            f"/v1/client/allocation/{_q(alloc_id)}/signal",
            body={"Signal": signal, "TaskName": task},
        )[0]

    def job_evaluate(self, job_id: str, force_reschedule: bool = False) -> dict:
        return self.put(
            f"/v1/job/{_q(job_id)}/evaluate",
            body={"EvalOptions": {"ForceReschedule": force_reschedule}},
        )[0]

    def agent_monitor(self, index: int = 0, log_level: str = "") -> dict:
        params = {"index": index}
        if log_level:
            params["log_level"] = log_level
        return self.get("/v1/agent/monitor", **params)[0]

    def acl_bootstrap(self) -> dict:
        return self.put("/v1/acl/bootstrap")[0]

    def acl_policies(self) -> list:
        return self.get("/v1/acl/policies")[0]

    def acl_policy(self, name: str) -> dict:
        return self.get(f"/v1/acl/policy/{_q(name)}")[0]

    def acl_put_policy(self, name: str, rules: str, description: str = "") -> dict:
        return self.put(
            f"/v1/acl/policy/{_q(name)}",
            body={"Rules": rules, "Description": description},
        )[0]

    def acl_delete_policy(self, name: str) -> dict:
        return self.delete(f"/v1/acl/policy/{_q(name)}")[0]

    def acl_tokens(self) -> list:
        return self.get("/v1/acl/tokens")[0]

    def acl_token(self, accessor: str) -> dict:
        return self.get(f"/v1/acl/token/{_q(accessor)}")[0]

    def acl_create_token(
        self, name: str = "", type: str = "client", policies=None, global_token=False
    ) -> dict:
        return self.put(
            "/v1/acl/token",
            body={
                "Name": name,
                "Type": type,
                "Policies": list(policies or []),
                "Global": global_token,
            },
        )[0]

    def acl_delete_token(self, accessor: str) -> dict:
        return self.delete(f"/v1/acl/token/{_q(accessor)}")[0]

    def client_stats(self, node_id: str = "") -> dict:
        params = {"node_id": node_id} if node_id else {}
        return self.get("/v1/client/stats", **params)[0]

    def event_stream(
        self,
        topics=None,
        index: int = 0,
        namespace: Optional[str] = None,
        heartbeat: Optional[float] = None,
        snapshot: Optional[bool] = None,
    ) -> "EventStream":
        """Subscribe to /v1/event/stream (ref api/event.go EventStream):
        returns an iterator of frame dicts. ``topics`` is a list of
        "Topic" / "Topic:key" specs (default: all topics); ``index=N``
        resumes after raft index N (pass the last index you received).
        ``snapshot`` forces snapshot-on-subscribe on/off (None defers to
        the server's configured default): with it on, a cold subscribe —
        or a resume that fell past the ring's retention — starts with
        {"Snapshot": ...} state batches stamped at raft index N, then a
        {"SnapshotDone": ...} marker, then deltas from N, instead of a
        lost-gap bail. Heartbeat frames are filtered out; snapshot,
        lost-gap and error frames are yielded so callers see the sync
        contract explicitly."""
        params: list = [("topic", t) for t in (topics or [])]
        if index:
            params.append(("index", str(index)))
        if snapshot is not None:
            params.append(("snapshot", "true" if snapshot else "false"))
        # unlike every other endpoint the server-side default here is the
        # wildcard, so "default" must travel explicitly — omitting it
        # would silently widen the stream to every namespace
        ns = namespace if namespace is not None else self.namespace
        if ns:
            params.append(("namespace", ns))
        if heartbeat is not None:
            params.append(("heartbeat", str(heartbeat)))
        url = self.address + "/v1/event/stream"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(url, method="GET")
        if self.token:
            req.add_header("X-Nomad-Token", self.token)
        try:
            resp = urllib.request.urlopen(req, timeout=330)
        except urllib.error.HTTPError as e:
            try:
                message = json.loads(e.read()).get("error", str(e))
            except Exception:
                message = str(e)
            raise APIError(e.code, message) from e
        return EventStream(resp)

    def alloc_stats(self, alloc_id: str) -> dict:
        return self.get(f"/v1/client/allocation/{_q(alloc_id)}/stats")[0]


class EventStream:
    """Iterator over /v1/event/stream frames: yields dicts shaped
    {"Index": N, "Events": [...]}, {"Snapshot": True, "Index": N,
    "Events": [...]}, {"SnapshotDone": True, "Index": N},
    {"LostGap": True, "Index": N}, or {"Error": msg, "ResumeIndex": N};
    heartbeat frames are skipped. Tracks ``last_index`` so a severed
    consumer can reconnect with
    ``client.event_stream(index=stream.last_index)`` for exactly-once
    resumption. Lost-gap and snapshot frames ADVANCE ``last_index`` to
    their carried index: the gap marker's floor is the only index a
    reconnect can make progress from — resuming from the stale local
    index would replay the same gap forever — and a snapshot covers
    state through its stamp by construction."""

    def __init__(self, resp):
        self._resp = resp
        self.last_index = 0
        self.closed = False

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while True:
            try:
                line = self._resp.readline()
            except (OSError, ValueError, AttributeError):
                # AttributeError: close() from another thread mid-read
                # nulls http.client's buffered fp
                self.close()
                raise StopIteration
            if not line:
                self.close()
                raise StopIteration
            line = line.strip()
            if not line:
                continue
            try:
                frame = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not frame:
                continue  # heartbeat
            if frame.get("Index") and (
                (frame.get("Events") and not frame.get("Snapshot"))
                or frame.get("LostGap")
                or frame.get("SnapshotDone")
            ):
                # snapshot BATCHES don't advance the resume point — only
                # the SnapshotDone marker does: a consumer severed
                # mid-snapshot must re-sync, not resume past state it
                # never received
                self.last_index = max(self.last_index, int(frame["Index"]))
            return frame

    def close(self):
        self.closed = True
        try:
            self._resp.close()
        except OSError:
            pass


class ExecWsSession:
    """Typed wrapper over the exec websocket's JSON frames (ref
    api/allocations.go execSession): base64 payloads decoded to bytes."""

    def __init__(self, ws):
        self._ws = ws

    def send_stdin(self, data: bytes):
        import base64

        self._ws.send(
            json.dumps({"stdin": {"data": base64.b64encode(data).decode()}})
        )

    def close_stdin(self):
        self._ws.send(json.dumps({"stdin": {"close": True}}))

    def resize(self, rows: int, cols: int):
        self._ws.send(
            json.dumps({"tty_size": {"height": rows, "width": cols}})
        )

    def recv_frame(self, timeout=None) -> Optional[dict]:
        """Next decoded frame: {"stdout"/"stderr": bytes} or
        {"exited": True, "exit_code": N} or {"error": msg}; None at
        websocket close."""
        import base64

        from .ws import WsClosed

        try:
            payload = self._ws.recv(timeout=timeout)
        except WsClosed:
            return None
        try:
            obj = json.loads(payload.decode())
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None
        out = {}
        for key in ("stdout", "stderr"):
            part = obj.get(key) or {}
            if part.get("data"):
                out[key] = __import__("base64").b64decode(part["data"])
        if obj.get("exited"):
            out["exited"] = True
            out["exit_code"] = (obj.get("result") or {}).get("exit_code", 0)
        if obj.get("error"):
            out["error"] = obj["error"]
        return out

    def close(self):
        self._ws.close()
