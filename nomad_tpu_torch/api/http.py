"""HTTP API server: the /v1/* surface (ref command/agent/http.go:150-222).

Blocking queries are supported via ?index=N&wait=DUR on list endpoints, the
same long-poll contract the reference exposes. JSON in/out; the model's
canonical dict encoding is the wire format.

The port's copy of ``nomad_tpu/api/http.py``, with the port's kernel
launch counts and warm-up count added to ``/v1/metrics``.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlparse

from .. import metrics
from ..core.overload import (
    DeadlineExceeded,
    ErrOverloaded,
    current_deadline,
    deadline_remaining_s,
    deadline_scope,
    mint_deadline,
    retry_budget,
)
from ..jobspec.hcl import parse_duration
from ..raft import NotLeaderError
from ..structs.model import Allocation, Job
from ..testing import faults as _faults

#: total wall budget a cross-region (or leader) forward may spend
#: retrying through an election/partition before surfacing the error
FORWARD_RETRY_DEADLINE_S = float(
    os.environ.get("NOMAD_TPU_FWD_DEADLINE_S", "5.0")
)
#: error substrings that mean "the target cluster is mid-transition"
#: (election in flight, stale routing) rather than "the request is bad" —
#: the retryable class. Every entry is an EXPLICIT handler refusal: the
#: remote answered without executing, so re-sending cannot double-apply
#: a non-idempotent write (dispatch mints a new child job per call).
#: "timed out" is deliberately absent — a hop that answers "my inner
#: forward timed out" has an indeterminate outcome beyond it.
_TRANSIENT_FORWARD_ERRORS = (
    "not the leader",
    # the inner leader-forward loop's terminal wrapper: with ambiguous
    # outcomes surfaced separately as "forward outcome unknown", this
    # message only ever wraps explicit refusals, so another peer may
    # safely re-fire the request
    "leader forward failed after",
    "forwarding loop",
    "no route to it",
    "no path to region",
    "region link",
)


def _transient_forward_error(message: str) -> bool:
    msg = str(message)
    return any(s in msg for s in _TRANSIENT_FORWARD_ERRORS)


def _pre_send_failure(e: Exception) -> bool:
    """True when the transport error provably happened BEFORE the request
    was sent (dial refused / unreachable), so a retry cannot double-apply.
    Ambiguous failures — timeouts, resets mid-exchange — return False and
    must surface: the remote may have executed the write."""
    import urllib.error

    if isinstance(e, ConnectionRefusedError):
        return True
    if isinstance(e, urllib.error.URLError) and not isinstance(
        e, urllib.error.HTTPError
    ):
        return isinstance(e.reason, ConnectionRefusedError)
    return False

def _request_priority(body):
    """Eval priority the submitted work will run at, when the body carries
    one (job register/dispatch payloads), else None — the admission
    controller's priority-aware shedding classifies on it (system >
    service > batch, core/overload.py)."""
    if isinstance(body, dict):
        job = body.get("Job")
        if isinstance(job, dict):
            # the wire format is snake_case (Job.to_dict); "Priority" is
            # accepted too for reference-API-shaped clients
            pri = job.get("priority", job.get("Priority"))
            if pri is not None:
                try:
                    return int(pri)
                except (TypeError, ValueError):
                    pass
    return None


_ROUTES: list[tuple[str, re.Pattern, str, object]] = []

# route ACL specs (ref nomad/acl.go per-endpoint checks; http routes carry
# the capability they require): "anonymous" = open, "ns:<capability>" =
# namespace capability from the request's namespace, "node:read|write",
# "agent:read|write", "operator:read|write"; None = management-only (the
# safe default for unannotated routes when ACLs are enabled)


def _acl_allows(acl, spec, query) -> bool:
    if spec == "anonymous":
        return True
    if acl is None:
        return False
    if acl.management:
        return True
    if spec is None:
        return False
    if callable(spec):
        return bool(spec(acl, query))
    if spec.startswith("ns:"):
        ns = query.get("namespace", "default")
        if ns == "*":
            # wildcard lists: allowed when any namespace grants the
            # capability; handlers filter the results per object
            return acl.allow_capability_any_namespace(spec[3:])
        return acl.allow_namespace_operation(ns, spec[3:])
    domain, _, level = spec.partition(":")
    checks = {
        ("node", "read"): lambda: acl.allow_node_read(),
        ("node", "write"): lambda: acl.allow_node_write(),
        ("agent", "read"): lambda: acl.allow_agent_read(),
        ("agent", "write"): lambda: acl.allow_agent_write(),
        ("operator", "read"): lambda: acl.allow_operator_read(),
        ("operator", "write"): lambda: acl.allow_operator_write(),
    }
    check = checks.get((domain, level))
    return bool(check and check())


class RawResponse:
    """A handler result served verbatim instead of as JSON (the metrics
    endpoint's prometheus exposition, http.go's formatted responses)."""

    def __init__(self, content_type: str, body: bytes):
        self.content_type = content_type
        self.body = body


class _DecodedMatch:
    """Percent-decodes captured path segments so derived child job IDs
    (``<id>/periodic-<ts>``, ``<id>/dispatch-<ts>-<uuid>``) resolve when
    clients encode the embedded '/' (ref http.go uses mux vars similarly)."""

    def __init__(self, match: re.Match):
        self._match = match

    def group(self, *args):
        g = self._match.group(*args)
        if isinstance(g, tuple):
            return tuple(unquote(x) if x else x for x in g)
        return unquote(g) if g else g

    def __getitem__(self, key):
        g = self._match[key]
        return unquote(g) if g else g


def route(method: str, pattern: str, acl=None):
    compiled = re.compile("^" + pattern + "$")

    def deco(fn):
        _ROUTES.append((method, compiled, fn.__name__, acl))
        return fn

    return deco


class HTTPServer:
    """Wraps a Server (and optionally clients) with the HTTP surface."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 4646, agent=None):
        self.server = server
        self.agent = agent
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        #: shared fan-out pump for chunked event streams (events/mux.py);
        #: created on the first stream, stopped with the server. The lock
        #: guards the lazy init: two first-ever streams racing (exactly
        #: the fan-out ramp pattern) must not each build a mux — the
        #: loser's pump thread and adopted sockets would escape stop()
        self._stream_mux = None
        self._stream_mux_lock = threading.Lock()
        #: sockets handed to the stream mux: the per-request teardown
        #: (shutdown_request) must leave them alone — the mux owns their
        #: lifecycle now. Weak so a mux-closed socket drops out by itself.
        import weakref

        self._detached_socks = weakref.WeakSet()

    def _mint_request_deadline(self, headers, query) -> int:
        """Mint the request's wall-clock deadline (unix ns; 0 = none).

        Precedence: an explicit ``X-Nomad-Deadline: <seconds>`` header
        always wins (honored even without an overload stanza — it is an
        explicit per-request opt-in). With the overload plane configured,
        ``?wait=<dur>`` doubles as the deadline (a blocking caller gone
        after its wait is work nobody collects), then the stanza's
        ``default_deadline_s``. Without the stanza those two mint nothing
        — the A/B contract keeps pre-overload behavior byte-identical."""
        hdr = headers.get("X-Nomad-Deadline")
        if hdr:
            try:
                ttl = float(hdr)
                if ttl > 0:
                    return mint_deadline(ttl)
            except ValueError:
                pass
        ov = getattr(self.server, "overload", None) if self.server else None
        if ov is None:
            return 0
        if query.get("wait"):
            try:
                ttl = parse_duration(query["wait"]) / 1e9
                if ttl > 0:
                    return mint_deadline(ttl)
            except (ValueError, TypeError):
                pass
        if ov.default_deadline_s > 0:
            return mint_deadline(ov.default_deadline_s)
        return 0

    def start(self):
        from ..util import LogBuffer

        LogBuffer.install()  # capture logs from agent start for /monitor
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _dispatch(self, method):
                parsed = urlparse(self.path)
                # the web UI (ref command/agent/http.go:211 serving /ui/)
                if method == "GET" and parsed.path in ("/", "/ui", "/ui/"):
                    from ..ui import INDEX_HTML

                    data = INDEX_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                # cluster event stream: long-lived push connection, served
                # outside the request/response route table (ref
                # command/agent/event_endpoint.go). Handles both chunked
                # HTTP and a websocket upgrade on the same path.
                if method == "GET" and parsed.path == "/v1/event/stream":
                    self.close_connection = True
                    try:
                        api._serve_event_stream(self, parsed, query)
                    except OSError:
                        pass
                    except Exception as e:
                        try:
                            self._respond(500, {"error": str(e)}, None)
                        except OSError:
                            pass
                    return
                # websocket upgrade: the interactive exec surface
                # (ref command/agent/alloc_endpoint.go execStream)
                if (
                    method == "GET"
                    and "websocket"
                    in self.headers.get("Upgrade", "").lower()
                ):
                    ws_m = re.match(
                        r"^/v1/client/allocation/([^/]+)/exec$", parsed.path
                    )
                    if ws_m:
                        server = api.server
                        if server is not None and server.acl_enabled():
                            # browsers can't set headers on a ws dial;
                            # accept the token as a query param too
                            secret = self.headers.get(
                                "X-Nomad-Token", ""
                            ) or query.get("token", "")
                            try:
                                acl_obj = server.resolve_token(secret)
                            except PermissionError as e:
                                self._respond(403, {"error": str(e)}, None)
                                return
                            except NotLeaderError as e:
                                # ws dials can't be proxied here; surface
                                # a retryable error, not a false 403
                                self._respond(
                                    500,
                                    {"error": f"not the leader ({e})"},
                                    None,
                                )
                                return
                            if not _acl_allows(
                                acl_obj, "ns:alloc-exec", query
                            ):
                                self._respond(
                                    403, {"error": "Permission denied"}, None
                                )
                                return
                            query["__acl__"] = acl_obj
                        self.close_connection = True
                        try:
                            api._serve_exec_ws(self, ws_m.group(1), query)
                        except KeyError as e:
                            try:
                                self._respond(404, {"error": str(e)}, None)
                            except OSError:
                                pass
                        except ValueError as e:
                            try:
                                self._respond(400, {"error": str(e)}, None)
                            except OSError:
                                pass
                        except PermissionError as e:
                            # the fine-grained per-resource namespace check
                            # (the coarse gate above used caller-chosen
                            # ?namespace=) — still a clean 403
                            try:
                                self._respond(403, {"error": str(e)}, None)
                            except OSError:
                                pass
                        except OSError:
                            pass
                        except Exception as e:
                            # RpcError (hosting node unreachable) and
                            # friends: a diagnosable 502, not a traceback
                            try:
                                self._respond(502, {"error": str(e)}, None)
                            except OSError:
                                pass
                        return
                body = None
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    raw = self.rfile.read(length)
                    try:
                        body = json.loads(raw)
                    except json.JSONDecodeError:
                        body = raw.decode()
                # region forwarding (ref rpc.go forward() + region tables):
                # a request naming another region proxies to a server there
                region = query.get("region")
                if (
                    region
                    and api.server is not None
                    and region != getattr(api.server, "region", region)
                ):
                    self._forward_region(method, region, parsed, query, body)
                    return
                for m, pattern, name, acl_spec in _ROUTES:
                    if m != method:
                        continue
                    match = pattern.match(parsed.path)
                    if match:
                        server = api.server
                        acl_obj = None
                        if server is not None and server.acl_enabled():
                            secret = self.headers.get("X-Nomad-Token", "")
                            try:
                                acl_obj = server.resolve_token(secret)
                            except PermissionError as e:
                                self._respond(403, {"error": str(e)}, None)
                                return
                            except NotLeaderError as e:
                                # a token miss on a follower is not
                                # authoritative (its table may lag a
                                # restart or replication round): the
                                # leader re-resolves and serves
                                self._forward_leader(
                                    method, e, parsed, query, body
                                )
                                return
                            if not _acl_allows(acl_obj, acl_spec, query):
                                self._respond(
                                    403, {"error": "Permission denied"}, None
                                )
                                return
                        # reserved key: handlers needing finer-grained
                        # checks (search's per-context filtering) read it
                        query["__acl__"] = acl_obj
                        query["__secret__"] = self.headers.get(
                            "X-Nomad-Token", ""
                        )
                        # bounded accept (the overload plane): mutating
                        # requests pass priority-aware admission BEFORE
                        # any handler work — reject-early with 429 +
                        # Retry-After keeps queues short instead of
                        # metastable. Reads stay open (they are how
                        # operators see an overloaded cluster).
                        if (
                            method != "GET"
                            and server is not None
                            and getattr(server, "overload", None) is not None
                        ):
                            try:
                                server.overload.admit_request(
                                    _request_priority(body)
                                )
                            except ErrOverloaded as e:
                                self._respond_overloaded(e)
                                return
                        try:
                            dl_ns = api._mint_request_deadline(
                                self.headers, query
                            )
                            if dl_ns and time.time_ns() >= dl_ns:
                                raise DeadlineExceeded(
                                    "request deadline exceeded before "
                                    "dispatch",
                                    where="http",
                                )
                            trace_hdr = self.headers.get("X-Nomad-Trace")
                            # the deadline scope makes the deadline
                            # visible to everything downstream of the
                            # handler — eval creation stamps it, and
                            # ConnPool forwards it on any remote hop
                            with deadline_scope(dl_ns):
                                if trace_hdr:
                                    # forwarded-request propagation: the
                                    # proxying hop's span context rides
                                    # the header so this handler's spans
                                    # join the submitter's tree (cross-
                                    # region critical paths are one
                                    # retained trace)
                                    from ..trace import tracer

                                    ctx = None
                                    try:
                                        ctx = tracer.ctx_from_annotation(
                                            json.loads(trace_hdr)
                                        )
                                    except Exception:
                                        pass
                                    with tracer.activate(ctx):
                                        result, index = getattr(api, name)(
                                            _DecodedMatch(match), query, body
                                        )
                                else:
                                    result, index = getattr(api, name)(
                                        _DecodedMatch(match), query, body
                                    )
                            if isinstance(result, RawResponse):
                                data = result.body
                                self.send_response(200)
                                self.send_header("Content-Type", result.content_type)
                                self.send_header("Content-Length", str(len(data)))
                                self.end_headers()
                                self.wfile.write(data)
                                return
                            self._respond(200, result, index)
                        except ErrOverloaded as e:
                            # an in-process handler (or the RPC tier under
                            # it) shed the work mid-flight
                            self._respond_overloaded(e)
                        except DeadlineExceeded as e:
                            # loud terminal outcome, never a silent drop:
                            # 504 carries the refusing stage in the body
                            self._respond(
                                504,
                                {
                                    "error": str(e),
                                    "code": "deadline_exceeded",
                                    "where": getattr(e, "where", "")
                                    or "http",
                                },
                                None,
                            )
                        except KeyError as e:
                            self._respond(404, {"error": str(e)}, None)
                        except PermissionError as e:
                            self._respond(403, {"error": str(e)}, None)
                        except ValueError as e:
                            self._respond(400, {"error": str(e)}, None)
                        except NotLeaderError as e:
                            # a write landed on a follower: proxy to the
                            # leader's HTTP surface (the reference forwards
                            # the RPC internally, rpc.go forward())
                            self._forward_leader(
                                method, e, parsed, query, body
                            )
                        except Exception as e:
                            self._respond(500, {"error": str(e)}, None)
                        return
                self._respond(404, {"error": f"no handler for {parsed.path}"}, None)

            def _forward_leader(self, method, err, parsed, query, body):
                """Proxy the request to the raft leader's HTTP address (ref
                nomad/rpc.go:280-340 forward()). The address resolves from
                gossip tags or static config when present, else over the
                server RPC tier (Status.HTTPAddr at the leader's raft
                address, which every voter knows) — so forwarding works in
                voters-only topologies with no gossip configured."""
                # bounded hop count: leadership can move while a forward
                # is in flight (old leader forwards onward), but a cycle
                # must terminate (the reference bounds forwardLeader the
                # same way)
                try:
                    ttl = int(self.headers.get("X-Nomad-Forward-TTL") or 2)
                except ValueError:
                    ttl = 0
                if ttl <= 0:
                    self._respond(
                        500,
                        {"error": f"forwarding loop: not the leader ({err})"},
                        None,
                    )
                    return
                from .client import APIError, ApiClient

                path = parsed.path + (
                    "?" + parsed.query if parsed.query else ""
                )
                # retry-with-backoff through the election: the leader
                # hint is only trusted on the first attempt (it may name
                # the peer that just died); later attempts re-resolve
                # from live raft state, so the re-elected leader is found
                # as soon as a quorum knows it. Writes on this surface
                # are idempotent upserts, so a retry after a flushed-but-
                # failed hop cannot double-apply.
                deadline = time.monotonic() + FORWARD_RETRY_DEADLINE_S
                backoff = 0.05
                attempt = 0
                last_err = str(err)
                while True:
                    if attempt == 0:
                        leader_id = getattr(err, "leader_id", None) or getattr(
                            api.server.raft, "leader_id", None
                        )
                        leader_rpc = getattr(err, "leader_addr", None) or (
                            api.server.raft.leader_address()
                        )
                    else:
                        leader_id = getattr(api.server.raft, "leader_id", None)
                        leader_rpc = api.server.raft.leader_address()
                    target = (
                        api.server.resolve_server_http_addr(
                            leader_id, leader_rpc
                        )
                        if leader_rpc or leader_id
                        else None
                    )
                    if target:
                        proxy = ApiClient(
                            address=target,
                            token=self.headers.get("X-Nomad-Token") or "",
                        )
                        try:
                            payload, index = proxy._request(
                                method, path, body=body,
                                headers=self._forward_headers(ttl - 1),
                            )
                            self._respond(200, payload, index)
                            return
                        except APIError as e:
                            if not _transient_forward_error(str(e)):
                                self._respond(e.status, {"error": str(e)}, None)
                                return
                            last_err = str(e)
                        except Exception as e:
                            # a stale address (peer restarted onto a new
                            # HTTP port) must not wedge forwarding forever
                            # — quarantine it so the next resolution
                            # consults the live sources
                            api.server.forget_server_http_addr(
                                leader_rpc, target
                            )
                            if not _pre_send_failure(e):
                                # ambiguous transport failure: the hop may
                                # have executed the write — surfacing is
                                # the only double-apply-safe answer
                                self._respond(
                                    500,
                                    {
                                        "error": "leader forward outcome "
                                        f"unknown: {e}"
                                    },
                                    None,
                                )
                                return
                            last_err = f"{type(e).__name__}: {e}"
                    else:
                        last_err = f"no route to leader ({err})"
                    attempt += 1
                    if time.monotonic() + backoff > deadline:
                        break
                    # forward retries ride the process-wide retry budget
                    # (core/overload.py) with the rpc ladders: when the
                    # bucket is dry, fail fast instead of amplifying
                    if not retry_budget().try_acquire():
                        metrics.incr("http.leader_forward.budget_exhausted")
                        break
                    metrics.incr("http.leader_forward.retry")
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 0.5)
                metrics.incr("http.leader_forward.failed")
                self._respond(
                    500,
                    {
                        "error": "leader forward failed after "
                        f"{attempt + 1} attempts: {last_err}"
                    },
                    None,
                )

            def _forward_headers(self, ttl: int) -> dict:
                """Headers every proxy hop carries: the loop-bounding TTL
                plus the active trace context (when sampled), so the
                remote handler's spans — job.submit included — parent
                under this hop and the cross-region critical path is ONE
                retained tree."""
                headers = {"X-Nomad-Forward-TTL": str(ttl)}
                try:
                    from ..trace import tracer

                    ctx = tracer.current()
                    if ctx is not None and ctx.sampled:
                        headers["X-Nomad-Trace"] = json.dumps(ctx.to_dict())
                except Exception:
                    pass
                # deadline propagation across proxy hops: carry the
                # REMAINING budget (the header's unit is seconds-from-now)
                # so the remote hop re-mints the same absolute deadline
                dl = current_deadline()
                if dl:
                    rem = deadline_remaining_s(dl)
                    if rem is not None and rem > 0:
                        headers["X-Nomad-Deadline"] = f"{rem:.3f}"
                return headers

            def _forward_region(self, method, region, parsed, query, body):
                """Proxy the request to a server in ``region`` (ref
                rpc.go forward() + region tables), retrying with backoff
                through remote elections and stale routing: losing the
                remote leader mid-call must not surface a transient
                error to the submitter. Each attempt re-reads the gossip
                forwarding table and rotates peers; only the recognized
                transient error class retries (writes on this surface
                are idempotent upserts, so a retried hop cannot
                double-apply). The inter-region fault seam
                (testing/faults.py region scope) gates every attempt —
                a partitioned link fails here exactly like a dead WAN."""
                from .client import APIError, ApiClient

                self_region = getattr(api.server, "region", "global")
                path = parsed.path + ("?" + parsed.query if parsed.query else "")
                span_cm = None
                try:
                    from ..trace import tracer

                    # the forward hop is the trace ROOT when the request
                    # arrived untraced (the cross-region submit surface),
                    # a child span when a context is already active
                    opener = (
                        tracer.span if tracer.current() is not None
                        else tracer.root
                    )
                    span_cm = opener(
                        "http.region_forward",
                        tags={"src": self_region, "dst": region},
                    )
                    span_cm.__enter__()
                except Exception:
                    span_cm = None
                try:
                    self._forward_region_inner(
                        method, region, self_region, path, body,
                        ApiClient, APIError,
                    )
                finally:
                    if span_cm is not None:
                        span_cm.__exit__(None, None, None)

            def _forward_region_inner(
                self, method, region, self_region, path, body,
                ApiClient, APIError,
            ):
                deadline = time.monotonic() + FORWARD_RETRY_DEADLINE_S
                backoff = 0.05
                attempt = 0
                last_err = f"no path to region {region!r}"
                while True:
                    severed = _faults.region_link(
                        self_region, region, "http.forward"
                    ) in ("drop", "sever")
                    if severed:
                        last_err = (
                            f"region link {self_region}->{region} severed"
                        )
                        metrics.incr("http.region_forward.severed")
                    else:
                        peers = api.server.region_http_servers(region)
                        if peers:
                            proxy = ApiClient(
                                address=peers[attempt % len(peers)],
                                token=self.headers.get("X-Nomad-Token") or "",
                            )
                            try:
                                payload, index = proxy._request(
                                    method, path, body=body,
                                    headers=self._forward_headers(2),
                                )
                                metrics.incr("http.region_forward.ok")
                                self._respond(200, payload, index)
                                return
                            except APIError as e:
                                if not _transient_forward_error(str(e)):
                                    self._respond(
                                        e.status, {"error": str(e)}, None
                                    )
                                    return
                                last_err = str(e)
                            except Exception as e:
                                if not _pre_send_failure(e):
                                    # ambiguous transport failure: the
                                    # remote may have executed the write
                                    # (dispatch mints a child per call) —
                                    # only a provably-unsent request is
                                    # safe to re-fire
                                    self._respond(
                                        500,
                                        {
                                            "error": "region forward to "
                                            f"{region!r} outcome "
                                            f"unknown: {e}"
                                        },
                                        None,
                                    )
                                    return
                                last_err = f"{type(e).__name__}: {e}"
                        else:
                            last_err = f"no path to region {region!r}"
                    attempt += 1
                    if time.monotonic() + backoff > deadline:
                        break
                    # same shared retry budget as the leader-forward loop
                    # and the rpc client ladders: bounded amplification
                    if not retry_budget().try_acquire():
                        metrics.incr("http.region_forward.budget_exhausted")
                        break
                    metrics.incr("http.region_forward.retry")
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 0.5)
                metrics.incr("http.region_forward.failed")
                self._respond(
                    500,
                    {
                        "error": f"region forward to {region!r} failed "
                        f"after {attempt + 1} attempts: {last_err}"
                    },
                    None,
                )

            def _respond_overloaded(self, e):
                """429 + Retry-After: the shed-work contract. The body
                carries the machine-readable code and the same hint so
                non-header-aware clients can pace themselves too."""
                retry_after = float(getattr(e, "retry_after", 1.0) or 1.0)
                data = json.dumps(
                    {
                        "error": str(e),
                        "code": "overloaded",
                        "retry_after": retry_after,
                    }
                ).encode()
                self.send_response(429)
                self.send_header("Content-Type", "application/json")
                self.send_header(
                    "Retry-After", str(max(1, int(retry_after)))
                )
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _respond(self, code, payload, index):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if index is not None:
                    self.send_header("X-Nomad-Index", str(index))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._dispatch("GET")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_POST(self):
                self._dispatch("PUT")  # POST == PUT (ref http.go)

            def do_DELETE(self):
                self._dispatch("DELETE")

        class _Httpd(ThreadingHTTPServer):
            # production fan-out ramps thousands of stream dials in
            # bursts; the default listen backlog of 5 sheds them
            request_queue_size = 512

            def shutdown_request(self, request):
                # an event-stream socket adopted by the mux outlives its
                # request: the handler thread returns but the connection
                # keeps streaming. One-shot — after the skip the mux is
                # the only owner.
                if request in api._detached_socks:
                    api._detached_socks.discard(request)
                    return
                super().shutdown_request(request)

        self._httpd = _Httpd((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http-serve"
        )
        self._thread.start()
        if self.server is not None and hasattr(self.server, "advertise_http"):
            # publish our HTTP address for cross-region forwarding
            self.server.advertise_http(self.address)

    def stop(self):
        if self._stream_mux is not None:
            self._stream_mux.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        pool = getattr(self, "_fs_pool", None)
        if pool is not None:
            pool.close()

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------------
    def _ns_visible(self, query, obj_ns: str, capability: str) -> bool:
        """List-endpoint namespace scoping: exact match normally, or — for
        ?namespace=* wildcard lists — every namespace the token holds the
        capability in (ref the reference's wildcard namespace handling)."""
        ns = query.get("namespace", "default")
        if ns != "*":
            return obj_ns == ns
        acl = query.get("__acl__")
        return acl is None or acl.allow_namespace_operation(obj_ns, capability)

    # ------------------------------------------------------------------
    def _blocking(self, query, run):
        """Shared blocking-query plumbing (?index=N&wait=D).

        Deadline-aware park: a minted request deadline shorter than
        ``?wait=`` clamps the park so the query un-parks AT the deadline
        with a terminal ``deadline_exceeded (blocking_query)`` instead of
        holding the connection past it. Without an active deadline the
        park is exactly the pre-overload ``?wait=`` behavior."""
        min_index = int(query.get("index", 0))
        if min_index:
            wait = parse_duration(query.get("wait", "5m")) / 1e9
            dl = current_deadline()
            clamped = False
            if dl:
                rem = deadline_remaining_s(dl)
                if rem is not None and rem < wait:
                    wait = max(rem, 0.0)
                    clamped = True
            result, index = self.server.state.blocking_query(
                run, min_index=min_index, timeout=wait
            )
            if clamped and index <= min_index:
                # the park was cut short by the deadline, not woken by
                # data: loud terminal outcome, attributed to this stage
                metrics.incr("overload.deadline_exceeded.blocking_query")
                ov = getattr(self.server, "overload", None)
                if ov is not None:
                    ov.note_deadline_exceeded("blocking_query")
                raise DeadlineExceeded(
                    "deadline expired while blocked on index "
                    f"{min_index}",
                    where="blocking_query",
                )
            return result, index
        snap = self.server.state.snapshot()
        return run(snap), snap.latest_index()

    # -- jobs ----------------------------------------------------------
    @route("GET", r"/v1/jobs", acl="ns:list-jobs")
    def list_jobs(self, m, query, body):
        prefix = query.get("prefix", "")

        def run(snap):
            return [
                {
                    "ID": j.id,
                    "Name": j.name,
                    "Type": j.type,
                    "Priority": j.priority,
                    "Status": j.status,
                    "JobModifyIndex": j.job_modify_index,
                }
                for j in snap.jobs()
                if j.id.startswith(prefix)
                and self._ns_visible(query, j.namespace, "list-jobs")
            ]

        return self._blocking(query, run)

    @route("PUT", r"/v1/jobs", acl="ns:submit-job")
    def register_job(self, m, query, body):
        from ..trace import tracer

        if not isinstance(body, dict) or "Job" not in body:
            raise ValueError("request must contain a Job")
        job = Job.from_dict(body["Job"])
        self._apply_request_ns(query, job)
        self._check_ns(query, job.namespace, "submit-job")
        # mint the trace at HTTP submit: the created eval adopts this
        # context (Server._adopt_eval_trace), so the retained tree runs
        # submit → broker → worker → device → plan → fsm. A
        # request forwarded from another region arrives with an active
        # context (X-Nomad-Trace) — then job.submit is a child span and
        # the cross-region hop stays one tree
        opener = (
            tracer.span if tracer.current() is not None else tracer.root
        )
        with opener("job.submit", tags={"job": job.id}):
            eval_id = self.server.job_register(job)
        return {"EvalID": eval_id, "JobModifyIndex": self.server.state.latest_index()}, None

    @route("GET", r"/v1/job/(?P<job_id>[^/]+)", acl="ns:read-job")
    def get_job(self, m, query, body):
        def run(snap):
            job = snap.job_by_id(query.get("namespace", "default"), m["job_id"])
            if job is None:
                raise KeyError(f"job not found: {m['job_id']}")
            return job.to_dict()

        return self._blocking(query, run)

    @route("DELETE", r"/v1/job/(?P<job_id>[^/]+)", acl="ns:submit-job")
    def deregister_job(self, m, query, body):
        purge = query.get("purge", "false") == "true"
        eval_id = self.server.job_deregister(
            query.get("namespace", "default"), m["job_id"], purge=purge
        )
        return {"EvalID": eval_id}, None

    @route("PUT", r"/v1/job/(?P<job_id>[^/]+)/plan", acl="ns:submit-job")
    def plan_job(self, m, query, body):
        """Dry-run: annotated placement plan + structural diff, no state
        mutation (ref job_endpoint.go Plan, command/job_plan.go)."""
        if not isinstance(body, dict) or "Job" not in body:
            raise ValueError("request must contain a Job")
        job = Job.from_dict(body["Job"])
        self._apply_request_ns(query, job)
        self._check_ns(query, job.namespace, "submit-job")
        result = self.server.job_plan(job, diff=bool(body.get("Diff", True)))
        return {
            "Annotations": result["annotations"],
            "FailedTGAllocs": result["failed_tg_allocs"],
            "Diff": result["diff"],
            "JobModifyIndex": result["job_modify_index"],
        }, None

    @route("GET", r"/v1/job/(?P<job_id>[^/]+)/allocations", acl="ns:read-job")
    def job_allocations(self, m, query, body):
        def run(snap):
            return [
                _alloc_stub(a)
                for a in snap.allocs_by_job(
                    query.get("namespace", "default"), m["job_id"]
                )
            ]

        return self._blocking(query, run)

    @route("GET", r"/v1/job/(?P<job_id>[^/]+)/evaluations", acl="ns:read-job")
    def job_evaluations(self, m, query, body):
        def run(snap):
            return [
                e.to_dict()
                for e in snap.evals_by_job(
                    query.get("namespace", "default"), m["job_id"]
                )
            ]

        return self._blocking(query, run)

    @route("GET", r"/v1/job/(?P<job_id>[^/]+)/summary", acl="ns:read-job")
    def job_summary(self, m, query, body):
        def run(snap):
            s = snap.job_summary_by_id(query.get("namespace", "default"), m["job_id"])
            if s is None:
                raise KeyError(f"job summary not found: {m['job_id']}")
            return s.to_dict()

        return self._blocking(query, run)

    @route("GET", r"/v1/job/(?P<job_id>[^/]+)/deployments", acl="ns:read-job")
    def job_deployments(self, m, query, body):
        def run(snap):
            return [
                d.to_dict()
                for d in snap.deployments_by_job(
                    query.get("namespace", "default"), m["job_id"]
                )
            ]

        return self._blocking(query, run)

    @route("GET", r"/v1/job/(?P<job_id>[^/]+)/versions", acl="ns:read-job")
    def job_versions(self, m, query, body):
        def run(snap):
            return [
                j.to_dict()
                for j in snap.job_versions(
                    query.get("namespace", "default"), m["job_id"]
                )
            ]

        return self._blocking(query, run)

    # -- nodes ----------------------------------------------------------
    @route("GET", r"/v1/nodes", acl="node:read")
    def list_nodes(self, m, query, body):
        def run(snap):
            return [
                {
                    "ID": n.id,
                    "Name": n.name,
                    "Datacenter": n.datacenter,
                    "NodeClass": n.node_class,
                    "Status": n.status,
                    "Drain": n.drain,
                    "SchedulingEligibility": n.scheduling_eligibility,
                }
                for n in snap.nodes()
            ]

        return self._blocking(query, run)

    @route("GET", r"/v1/node/(?P<node_id>[^/]+)", acl="node:read")
    def get_node(self, m, query, body):
        def run(snap):
            node = snap.node_by_id(m["node_id"]) or next(
                iter(snap.node_by_prefix(m["node_id"])), None
            )
            if node is None:
                raise KeyError(f"node not found: {m['node_id']}")
            doc = node.to_dict()
            # the node secret authenticates its client RPC; never serve it
            # (the reference redacts SecretID from API responses)
            doc.pop("secret_id", None)
            return doc

        return self._blocking(query, run)

    @route("GET", r"/v1/node/(?P<node_id>[^/]+)/allocations", acl="node:read")
    def node_allocations(self, m, query, body):
        def run(snap):
            return [_alloc_stub(a) for a in snap.allocs_by_node(m["node_id"])]

        return self._blocking(query, run)

    @route("PUT", r"/v1/node/(?P<node_id>[^/]+)/drain", acl="node:write")
    def node_drain(self, m, query, body):
        body = body or {}
        spec = body.get("DrainSpec")
        # a present-but-empty spec means enable-with-defaults (the
        # reference distinguishes nil vs non-nil DrainSpec)
        if spec is not None:
            self.server.node_drain(
                m["node_id"],
                True,
                deadline_ns=int(spec.get("Deadline", 0)),
                ignore_system_jobs=bool(spec.get("IgnoreSystemJobs", False)),
            )
        else:
            self.server.node_drain(
                m["node_id"], False, mark_eligible=body.get("MarkEligible")
            )
        return {"NodeModifyIndex": self.server.state.latest_index()}, None

    @route("PUT", r"/v1/node/(?P<node_id>[^/]+)/eligibility", acl="node:write")
    def node_eligibility(self, m, query, body):
        elig = (body or {}).get("Eligibility", "eligible")
        self.server.node_update_eligibility(m["node_id"], elig)
        return {"NodeModifyIndex": self.server.state.latest_index()}, None

    # -- allocations -----------------------------------------------------
    @route("GET", r"/v1/allocations", acl="ns:read-job")
    def list_allocations(self, m, query, body):
        prefix = query.get("prefix", "")

        def run(snap):
            return [
                _alloc_stub(a)
                for a in snap.allocs()
                if a.id.startswith(prefix)
                and self._ns_visible(query, a.namespace, "read-job")
            ]

        return self._blocking(query, run)

    @route("GET", r"/v1/allocation/(?P<alloc_id>[^/]+)", acl="ns:read-job")
    def get_allocation(self, m, query, body):
        def run(snap):
            alloc = snap.alloc_by_id(m["alloc_id"])
            if alloc is None:
                matches = [
                    a for a in snap.allocs() if a.id.startswith(m["alloc_id"])
                ]
                alloc = matches[0] if len(matches) == 1 else None
            if alloc is None:
                raise KeyError(f"alloc not found: {m['alloc_id']}")
            self._check_ns(query, alloc.namespace, "read-job")
            return alloc.to_dict()

        return self._blocking(query, run)

    # -- evaluations -----------------------------------------------------
    @route("GET", r"/v1/evaluations", acl="ns:read-job")
    def list_evaluations(self, m, query, body):
        def run(snap):
            return [
                e.to_dict()
                for e in snap.evals()
                if self._ns_visible(query, e.namespace, "read-job")
            ]

        return self._blocking(query, run)

    @route("GET", r"/v1/evaluation/(?P<eval_id>[^/]+)", acl="ns:read-job")
    def get_evaluation(self, m, query, body):
        def run(snap):
            ev = snap.eval_by_id(m["eval_id"])
            if ev is None:
                matches = [
                    e for e in snap.evals() if e.id.startswith(m["eval_id"])
                ]
                ev = matches[0] if len(matches) == 1 else None
            if ev is None:
                raise KeyError(f"eval not found: {m['eval_id']}")
            self._check_ns(query, ev.namespace, "read-job")
            return ev.to_dict()

        return self._blocking(query, run)

    @route("GET", r"/v1/deployments", acl="ns:read-job")
    def list_deployments(self, m, query, body):
        def run(snap):
            return [
                d.to_dict()
                for d in snap.deployments()
                if self._ns_visible(query, d.namespace, "read-job")
            ]

        return self._blocking(query, run)

    @route("GET", r"/v1/deployment/(?P<deploy_id>[^/]+)", acl="ns:read-job")
    def get_deployment(self, m, query, body):
        def run(snap):
            d = snap.deployment_by_id(m["deploy_id"])
            if d is None:
                # prefix match, like the reference's prefix-tolerant lookups
                matches = [
                    x for x in snap.deployments()
                    if x.id.startswith(m["deploy_id"])
                ]
                if len(matches) == 1:
                    d = matches[0]
            if d is None:
                raise KeyError(f"deployment not found: {m['deploy_id']}")
            self._check_ns(query, d.namespace, "read-job")
            return d.to_dict()

        return self._blocking(query, run)

    @route("GET", r"/v1/deployment/allocations/(?P<deploy_id>[^/]+)", acl="ns:read-job")
    def deployment_allocations(self, m, query, body):
        def run(snap):
            d = snap.deployment_by_id(m["deploy_id"])
            if d is not None:
                self._check_ns(query, d.namespace, "read-job")
            return [
                _alloc_stub(a) for a in snap.allocs_by_deployment(m["deploy_id"])
            ]

        return self._blocking(query, run)

    @route("PUT", r"/v1/deployment/promote/(?P<deploy_id>[^/]+)", acl="ns:submit-job")
    def deployment_promote(self, m, query, body):
        body = body or {}
        self._check_deployment_ns(query, m["deploy_id"], "submit-job")
        self.server.deployment_promote(
            m["deploy_id"],
            groups=body.get("Groups"),
            all_groups=body.get("All", not body.get("Groups")),
        )
        return {"DeploymentModifyIndex": self.server.state.latest_index()}, None

    @route("PUT", r"/v1/deployment/fail/(?P<deploy_id>[^/]+)", acl="ns:submit-job")
    def deployment_fail(self, m, query, body):
        self._check_deployment_ns(query, m["deploy_id"], "submit-job")
        self.server.deployment_fail(m["deploy_id"])
        return {"DeploymentModifyIndex": self.server.state.latest_index()}, None

    @route("PUT", r"/v1/deployment/pause/(?P<deploy_id>[^/]+)", acl="ns:submit-job")
    def deployment_pause(self, m, query, body):
        self._check_deployment_ns(query, m["deploy_id"], "submit-job")
        pause = bool((body or {}).get("Pause", True))
        self.server.deployment_pause(m["deploy_id"], pause)
        return {"DeploymentModifyIndex": self.server.state.latest_index()}, None

    @route("PUT", r"/v1/deployment/allocation-health/(?P<deploy_id>[^/]+)", acl="ns:submit-job")
    def deployment_alloc_health(self, m, query, body):
        self._check_deployment_ns(query, m["deploy_id"], "submit-job")
        body = body or {}
        self.server.deployment_set_alloc_health(
            m["deploy_id"],
            healthy_ids=body.get("HealthyAllocationIDs", []),
            unhealthy_ids=body.get("UnhealthyAllocationIDs", []),
        )
        return {"DeploymentModifyIndex": self.server.state.latest_index()}, None

    @route("PUT", r"/v1/job/(?P<job_id>[^/]+)/dispatch", acl="ns:dispatch-job")
    def job_dispatch(self, m, query, body):
        body = body or {}
        import base64 as _b64

        payload = body.get("Payload", "")
        if payload:
            try:
                payload = _b64.b64decode(payload).decode()
            except Exception:
                pass  # accept raw strings too
        out = self.server.job_dispatch(
            query.get("namespace", "default"),
            m["job_id"],
            payload=payload,
            meta=body.get("Meta") or {},
        )
        return out, None

    @route("PUT", r"/v1/job/(?P<job_id>[^/]+)/periodic/force", acl="ns:submit-job")
    def job_periodic_force(self, m, query, body):
        child_id = self.server.periodic_force(
            query.get("namespace", "default"), m["job_id"]
        )
        return {"DispatchedJobID": child_id}, None

    @route("PUT", r"/v1/job/(?P<job_id>[^/]+)/revert", acl="ns:submit-job")
    def job_revert(self, m, query, body):
        body = body or {}
        eval_id = self.server.job_revert(
            query.get("namespace", "default"),
            m["job_id"],
            int(body.get("JobVersion", 0)),
            enforce_prior_version=body.get("EnforcePriorVersion"),
        )
        return {"EvalID": eval_id}, None

    # -- agent / status --------------------------------------------------
    @route("GET", r"/v1/agent/self", acl="agent:read")
    def agent_self(self, m, query, body):
        clients = []
        if self.agent is not None:
            clients = [c.node.id for c in getattr(self.agent, "clients", [])]

        def jsonable(v):
            try:
                json.dumps(v)
                return True
            except (TypeError, ValueError):
                return False

        return (
            {
                # live wiring (raft transport/log-store handles) rides in
                # config in networked mode — serve only the plain values
                "config": {
                    k: v
                    for k, v in self.server.config.items()
                    if k != "raft" and jsonable(v)
                },
                "stats": {
                    "broker": self.server.eval_broker.stats(),
                    "blocked_evals": self.server.blocked_evals.stats(),
                },
                "member": {
                    "Name": self.server.raft.node_id,
                    "Status": "alive",
                    "rpc_addr": self.server.raft.address,
                    "is_leader": self.server.raft.is_leader(),
                },
                "clients": clients,
            },
            None,
        )

    # -- services (a nomad-native service catalog: the reference registers
    # workload services into Consul, command/agent/consul/ — here the same
    # service/check data is served straight from cluster state) ----------
    def _service_entries(self, snap, query, name_filter=None):
        out = []
        for alloc in snap.allocs():
            if alloc.terminal_status() or not self._ns_visible(
                query, alloc.namespace, "read-job"
            ):
                continue
            # Connect sidecar listeners published by the owning client
            for svc_name, ep in (alloc.connect_proxies or {}).items():
                sidecar_name = f"{svc_name}-sidecar-proxy"
                if name_filter and sidecar_name != name_filter:
                    continue
                out.append(
                    {
                        "ServiceName": sidecar_name,
                        "Tags": ["connect-proxy"],
                        "AllocID": alloc.id,
                        "JobID": alloc.job_id,
                        "NodeID": alloc.node_id,
                        "Address": ep.get("ip", ""),
                        "Port": int(ep.get("port", 0)),
                        "Status": "passing",
                        "Checks": {},
                    }
                )
            job = alloc.job
            tg = job.lookup_task_group(alloc.task_group) if job else None
            if tg is None:
                continue
            for task in tg.tasks:
                state = alloc.task_states.get(task.name)
                healthy = state is not None and state.state == "running"
                # check results published by the client's check runner
                # override the coarse is-it-running signal
                checks = dict(state.check_status) if state is not None else {}
                if healthy and any(v != "passing" for v in checks.values()):
                    healthy = False
                for svc in task.services:
                    if name_filter and svc.name != name_filter:
                        continue
                    address, port = "", 0
                    resources = alloc.allocated_resources
                    tr = (
                        resources.tasks.get(task.name)
                        if resources is not None
                        else None
                    )
                    if tr is not None and svc.port_label:
                        for net in tr.networks:
                            for p in list(net.reserved_ports) + list(
                                net.dynamic_ports
                            ):
                                if p.label == svc.port_label:
                                    address, port = net.ip, p.value
                    out.append(
                        {
                            "ServiceName": svc.name,
                            "Tags": list(svc.tags),
                            "AllocID": alloc.id,
                            "JobID": alloc.job_id,
                            "NodeID": alloc.node_id,
                            "Address": address,
                            "Port": port,
                            "Status": "passing" if healthy else "critical",
                            "Checks": checks,
                        }
                    )
        return out

    @route("GET", r"/v1/services", acl="ns:read-job")
    def list_services(self, m, query, body):
        def run(snap):
            return self._service_entries(snap, query)

        return self._blocking(query, run)

    @route("GET", r"/v1/service/(?P<name>[^/]+)", acl="ns:read-job")
    def get_service(self, m, query, body):
        def run(snap):
            entries = self._service_entries(snap, query, name_filter=m["name"])
            if not entries:
                raise KeyError(f"service not found: {m['name']}")
            return entries

        return self._blocking(query, run)

    @route("GET", r"/v1/regions", acl="anonymous")
    def list_regions(self, m, query, body):
        """ref nomad/regions_endpoint.go List"""
        return self.server.regions(), None

    @route("GET", r"/v1/status/leader", acl="anonymous")
    def status_leader(self, m, query, body):
        """ref status_endpoint.go Leader: the raft leader's RPC address
        (NOT this agent's HTTP address — any member answers with the same
        cluster-wide value)."""
        return self.server.leader_address() or "", None

    @route("GET", r"/v1/status/peers", acl="anonymous")
    def status_peers(self, m, query, body):
        """ref status_endpoint.go Peers"""
        return sorted(self.server.raft.voters_snapshot().values()), None

    @route("GET", r"/v1/agent/members", acl="agent:read")
    def agent_members(self, m, query, body):
        """ref agent_endpoint.go AgentMembersRequest"""
        return {
            "ServerName": self.server.raft.node_id,
            "ServerRegion": self.server.region,
            "Members": self.server.members(),
        }, None

    @route("PUT", r"/v1/agent/join", acl="agent:write")
    def agent_join(self, m, query, body):
        """ref agent_endpoint.go AgentJoinRequest"""
        addresses = []
        if query.get("address"):
            addresses.append(query["address"])
        if isinstance(body, dict) and body.get("Addresses"):
            addresses.extend(body["Addresses"])
        if not addresses:
            raise ValueError("missing address to join")
        joined = self.server.gossip_join(addresses)
        return {"num_joined": joined}, None

    @route("PUT", r"/v1/agent/force-leave", acl="agent:write")
    def agent_force_leave(self, m, query, body):
        """ref agent_endpoint.go AgentForceLeaveRequest"""
        node = query.get("node") or (body or {}).get("Node")
        if not node:
            raise ValueError("missing node to force leave")
        if not self.server.gossip_force_leave(node):
            raise KeyError(f"unknown member: {node}")
        return {}, None

    @route("GET", r"/v1/agent/servers", acl="agent:read")
    def agent_servers(self, m, query, body):
        """ref agent_endpoint.go AgentServersRequest"""
        return sorted(self.server.raft.voters_snapshot().values()), None

    @route("PUT", r"/v1/agent/keyring/(?P<op>install|use|remove|list)", acl="agent:write")
    def agent_keyring(self, m, query, body):
        """Gossip keyring management (ref agent keyring API + serf
        keyring): install/use/remove a base64 key, or list the ring."""
        gossip = getattr(self.server, "gossip", None)
        keyring = getattr(gossip, "keyring", None) if gossip else None
        if keyring is None:
            raise ValueError("gossip encryption is not enabled on this agent")
        op = m["op"]
        if op == "list":
            return keyring.list_keys(), None
        key = (body or {}).get("Key", "")
        if not key:
            raise ValueError("missing Key")
        if op == "install":
            keyring.install(key)
        elif op == "use":
            keyring.use(key)
        elif op == "remove":
            keyring.remove(key)
        return keyring.list_keys(), None

    @route("GET", r"/v1/agent/health", acl="anonymous")
    def agent_health(self, m, query, body):
        """ref agent_endpoint.go HealthRequest"""
        out = {}
        if self.server is not None:
            leader = self.server.leader_address() is not None
            out["server"] = {
                "ok": True,
                "message": "leader elected" if leader else "no leader",
            }
        clients = getattr(self.agent, "clients", []) if self.agent else []
        if clients:
            out["client"] = {"ok": True, "message": f"{len(clients)} client(s)"}
        return out, None

    @route("PUT", r"/v1/job/(?P<job_id>[^/]+)/evaluate", acl="ns:read-job")
    def job_evaluate(self, m, query, body):
        """ref job_endpoint.go Evaluate / api PUT /v1/job/:id/evaluate"""
        body = body or {}
        opts = body.get("EvalOptions") or {}
        eval_id = self.server.job_evaluate(
            query.get("namespace", "default"),
            m["job_id"],
            force_reschedule=bool(opts.get("ForceReschedule")),
        )
        return {"EvalID": eval_id}, None

    @route("GET", r"/v1/agent/monitor", acl="agent:read")
    def agent_monitor(self, m, query, body):
        """Recent agent log records after ?index= (poll-follow analog of
        the reference's streaming monitor endpoint)."""
        from ..util import LogBuffer

        buf = LogBuffer.install()
        entries, index = buf.since(int(query.get("index", 0)))
        level = query.get("log_level", "").upper()
        if level:
            order = ["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"]
            if level in order:
                keep = set(order[order.index(level):])
                entries = [e for e in entries if e["level"] in keep]
        return {"Entries": entries, "Index": index}, None

    @route("PUT", r"/v1/jobs/parse", acl="anonymous")
    def jobs_parse(self, m, query, body):
        """HCL jobspec → canonical job document (ref command/agent
        job_endpoint.go JobsParseRequest): lets non-HCL clients submit
        specs they got from users."""
        from ..jobspec import parse_job

        body = body or {}
        hcl = body.get("JobHCL", "")
        if not hcl:
            raise ValueError("request must contain JobHCL")
        return parse_job(hcl).to_dict(), None

    @route("PUT", r"/v1/client/gc", acl="node:write")
    def client_gc(self, m, query, body):
        """Force the local client's alloc-dir GC (ref client_endpoint.go
        GarbageCollect): reclaims every retained terminal alloc dir."""
        clients = []
        if self.agent is not None:
            clients = getattr(self.agent, "clients", None) or [
                getattr(self.agent, "client", None)
            ]
        reclaimed = 0
        for client in clients:
            if client is None:
                continue
            retained, client._terminal_alloc_dirs = (
                client._terminal_alloc_dirs,
                [],
            )
            for alloc_id in retained:
                client._reclaim_alloc_dir(alloc_id)
                reclaimed += 1
        if not clients:
            raise KeyError("this agent runs no client")
        return {"Reclaimed": reclaimed}, None

    def _check_debug_enabled(self):
        if not self.server.config.get("enable_debug"):
            raise PermissionError("debug endpoints are disabled (enable_debug)")

    @route("GET", r"/debug/pprof/(?P<profile>[a-z]*)", acl="agent:read")
    def debug_pprof(self, m, query, body):
        """Runtime introspection (the Go pprof handlers' role,
        http.go:218-222), gated on enable_debug exactly like the
        reference. ``/debug/pprof/`` (and any non-``profile`` name)
        keeps the original one-shot thread-stacks+gc shape;
        ``/debug/pprof/profile?seconds=N`` runs the debug plane's
        sampling wall-clock profiler (Go CPU-profile parity) and
        returns its folded-stack report."""
        self._check_debug_enabled()
        from ..debug import profiler as dbg_profiler

        if m["profile"] == "profile":
            seconds = min(max(float(query.get("seconds", "1")), 0.05), 30.0)
            hz = min(max(float(query.get("hz", "100")), 1.0), 1000.0)
            return dbg_profiler.profile(seconds, hz=hz), None
        return dbg_profiler.thread_dump(), None

    @route("GET", r"/v1/debug/bundle", acl="agent:read")
    def debug_bundle(self, m, query, body):
        """`nomad operator debug` over HTTP: capture a full debug
        bundle (profiles, flight-recorder dump, slowest traces,
        metrics, redacted config, findings) and stream it back as a
        gzip tarball (default) or inline JSON (?format=json). Gated on
        enable_debug like the pprof routes."""
        self._check_debug_enabled()
        import json as json_mod
        import os
        import tempfile

        from ..debug import bundle as bundle_mod

        seconds = min(max(float(query.get("seconds", "1")), 0.0), 30.0)
        with tempfile.TemporaryDirectory(prefix="nomad-tpu-debug-") as tmp:
            dest = os.path.join(tmp, "bundle")
            manifest = bundle_mod.capture_bundle(
                self.server, dest, profile_seconds=seconds, reason="http"
            )
            if query.get("format") == "json":
                files = {}
                for fn in manifest["files"]:
                    with open(os.path.join(dest, fn), encoding="utf-8") as f:
                        raw = f.read()
                    files[fn] = (
                        json_mod.loads(raw) if fn.endswith(".json") else raw
                    )
                return {"manifest": manifest, "files": files}, None
            tar_path = os.path.join(tmp, "bundle.tar.gz")
            bundle_mod.make_tarball(dest, tar_path)
            with open(tar_path, "rb") as f:
                data = f.read()
        return RawResponse("application/gzip", data), None

    @route("PUT", r"/v1/validate/job", acl="ns:submit-job")
    def validate_job(self, m, query, body):
        """Dry validation without registering (ref job_endpoint.go
        Validate / command/agent/job_endpoint.go ValidateJobRequest)."""
        if not isinstance(body, dict) or "Job" not in body:
            raise ValueError("request must contain a Job")
        errors = []
        warnings = []
        try:
            job = Job.from_dict(body["Job"])
            self._apply_request_ns(query, job)
            self.server._validate_job(job)
        except (ValueError, KeyError, TypeError) as e:
            errors.append(str(e))
        return {
            "DriverConfigValidated": True,
            "ValidationErrors": errors,
            "Warnings": "; ".join(warnings),
            "Error": errors[0] if errors else "",
        }, None

    @route("PUT", r"/v1/system/reconcile/summaries", acl="operator:write")
    def system_reconcile_summaries(self, m, query, body):
        """ref system_endpoint.go ReconcileJobSummaries"""
        self.server.reconcile_summaries()
        return {}, None

    @route("PUT", r"/v1/node/(?P<node_id>[^/]+)/purge", acl="node:write")
    def node_purge(self, m, query, body):
        """ref node_endpoint.go Deregister (purge)"""
        eval_ids = self.server.node_purge(m["node_id"])
        return {
            "EvalIDs": eval_ids,
            "NodeModifyIndex": self.server.state.latest_index(),
        }, None

    @route("GET", r"/v1/evaluation/(?P<eval_id>[^/]+)/allocations", acl="ns:read-job")
    def eval_allocations(self, m, query, body):
        """ref eval_endpoint.go Allocations"""
        def run(snap):
            return [
                a.to_dict()
                for a in snap.allocs_by_eval(m["eval_id"])
                if self._ns_visible(query, a.namespace, "read-job")
            ]

        return self._blocking(query, run)

    # -- operator raft / autopilot (ref operator_endpoint.go) ------------
    @route("GET", r"/v1/operator/raft/configuration", acl="operator:read")
    def operator_raft_configuration(self, m, query, body):
        return self.server.raft_configuration(), None

    @route("DELETE", r"/v1/operator/raft/peer", acl="operator:write")
    def operator_raft_remove_peer(self, m, query, body):
        peer = query.get("id") or query.get("address")
        if not peer:
            raise ValueError("missing peer id")
        # accept either a node id or its raft address
        voters = self.server.raft.voters_snapshot()
        if peer not in voters:
            by_addr = [
                nid for nid, addr in voters.items() if addr == peer
            ]
            if len(by_addr) == 1:
                peer = by_addr[0]
        self.server.raft_remove_peer(peer)
        return {}, None

    @route("GET", r"/v1/operator/autopilot/configuration", acl="operator:read")
    def operator_autopilot_get(self, m, query, body):
        return self.server.autopilot_config(), None

    @route("PUT", r"/v1/operator/autopilot/configuration", acl="operator:write")
    def operator_autopilot_set(self, m, query, body):
        overrides = dict(self.server.state.autopilot_config() or {})
        overrides.update(body or {})
        self.server.set_autopilot_config(overrides)
        return {"Updated": True}, None

    @route("GET", r"/v1/operator/autopilot/health", acl="operator:read")
    def operator_autopilot_health(self, m, query, body):
        return self.server.autopilot_health(), None

    # -- trace plane (OBSERVABILITY.md): per-eval span trees + the
    # critical-path attribution of eval.e2e. critical-path registers
    # BEFORE the <trace_id> route — matching is first-registered-wins --
    @route("GET", r"/v1/trace/critical-path", acl="agent:read")
    def trace_critical_path(self, m, query, body):
        from ..trace import attribute, tracer

        tail = float(query.get("tail", "0.99"))
        return attribute(tracer.store.records(), tail_pct=tail), None

    @route("GET", r"/v1/trace", acl="agent:read")
    def trace_list(self, m, query, body):
        from ..trace import tracer

        limit = min(int(query.get("limit", "50")), 500)
        return {
            "traces": tracer.store.list(
                limit=limit,
                slowest=query.get("slowest") in ("1", "true"),
                errors=query.get("errors") in ("1", "true"),
            ),
            "stats": tracer.stats(),
        }, None

    @route("GET", r"/v1/trace/(?P<trace_id>[^/]+)", acl="agent:read")
    def trace_get(self, m, query, body):
        from ..trace import orphan_count, tracer

        record = tracer.store.get(m["trace_id"])
        if record is None:
            raise KeyError(f"trace not found: {m['trace_id']}")
        record["orphans"] = orphan_count(record)
        return record, None

    @route("GET", r"/v1/metrics", acl="agent:read")
    def metrics(self, m, query, body):
        from ..tpu import batch_sched
        from ..tpu import drain as drain_mod
        from ..tpu import kernel as kernel_mod

        from .. import metrics as metrics_mod
        from ..trace import tracer as _tracer

        # job-summary gauges (ref leader.go:602 publishJobSummaryMetrics)
        summaries = {}
        for s in self.server.state.job_summaries():
            rollup = {}
            for tg_name, tg in s.summary.items():
                rollup[tg_name] = {
                    "queued": tg.queued,
                    "running": tg.running,
                    "starting": tg.starting,
                    "complete": tg.complete,
                    "failed": tg.failed,
                    "lost": tg.lost,
                }
            summaries[s.job_id] = rollup

        payload = {
            "broker": self.server.eval_broker.stats(),
            "blocked_evals": self.server.blocked_evals.stats(),
            "event_broker": (
                self.server.event_broker.stats()
                if self.server.event_broker is not None
                else {}
            ),
            "plan_queue_depth": self.server.planner.queue.depth(),
            "state_index": self.server.state.latest_index(),
            # per-stage timers + counters (the go-metrics MeasureSince role)
            "stages": metrics_mod.snapshot(),
            "job_summary": summaries,
            # kernel-vs-oracle routing (VERDICT r1 weak #10): how many
            # evals rode the TPU path, by mode, and why the rest didn't
            "tpu_scheduler": batch_sched.counters_snapshot(),
            "drain": dict(drain_mod.DRAIN_COUNTERS),
            # the port's kernel launches since the process started, by
            # kernel (each wrapper counts where it launches on the card)
            "tpu_launches": dict(kernel_mod.LAUNCHES),
            # committed-plane mirror view (tpu/mirror.py): sync hits and
            # node-axis view refreshes; rebuilds are structurally 0 —
            # the planes are patched by the store's own write commits
            "tpu_mirror": (
                self.server.columnar_mirror.stats()
                if getattr(self.server, "columnar_mirror", None) is not None
                else {}
            ),
            # trace plane retention/sampling state (nomad_tpu/trace)
            "trace": _tracer.stats(),
            # overload control plane (core/overload.py): load signal,
            # admitted/shed by class, deadline_exceeded ledger by stage,
            # brownout level — {} when the stanza is off
            "overload": (
                self.server.overload.stats()
                if getattr(self.server, "overload", None) is not None
                else {}
            ),
        }
        # device plane (debug/devprof.py): launch ledger + transfer
        # totals + round counters. Resolving pending round scalars is
        # gated on CUDA events, so a metrics poll can never stall behind
        # an in-flight kernel.
        try:
            from ..debug import devprof as _devprof

            payload["tpu_devprof"] = _devprof.snapshot()
        except Exception:
            payload["tpu_devprof"] = {}
        # the warm-up's count of programs launched (tpu/warmup.py), None
        # while it runs; absent without the prewarm_kernels stanza
        prewarm = getattr(self.server, "_prewarm_thread", None)
        if prewarm is not None:
            payload["tpu_prewarm"] = {"warmed": prewarm.warmed}
        # debug plane health (nomad_tpu/debug): flight-recorder depth +
        # watchdog trip counts — the operator's "is the tape running"
        recorder = getattr(self.server, "flight_recorder", None)
        watchdog = getattr(self.server, "watchdog", None)
        payload["debug"] = {
            "flight_recorded": (
                recorder.depth() if recorder is not None else 0
            ),
            "watchdog_trips": (
                watchdog.trip_count if watchdog is not None else 0
            ),
        }
        if query.get("format") == "prometheus":
            # text exposition (the reference's prometheus telemetry sink,
            # config.go:500-577 / /v1/metrics?format=prometheus)
            lines = []

            def emit(prefix, value):
                if isinstance(value, dict):
                    for k, v in value.items():
                        key = str(k).replace("-", "_").replace(".", "_")
                        emit(f"{prefix}_{key}", v)
                elif isinstance(value, (int, float)) and not isinstance(value, bool):
                    lines.append(f"# TYPE {prefix} gauge")
                    lines.append(f"{prefix} {value}")

            emit("nomad_tpu", payload)
            return RawResponse(
                "text/plain; version=0.0.4",
                ("\n".join(lines) + "\n").encode(),
            ), None
        return payload, None

    @route("PUT", r"/v1/system/gc", acl="operator:write")
    def system_gc(self, m, query, body):
        """Force-GC all eligible terminal objects
        (ref system_endpoint.go GarbageCollect)."""
        self.server.system_gc()
        return {}, None

    # -- client fs/logs/exec (ref command/agent/fs_endpoint.go +
    # client_fs_endpoint.go; served by the agent holding the alloc — the
    # in-process analog of the server→client streaming-RPC forwarding) ---
    def _alloc_dir(self, alloc_id: str) -> str:
        import os

        clients = []
        if self.agent is not None:
            clients = getattr(self.agent, "clients", None) or [
                getattr(self.agent, "client", None)
            ]
        for client in clients:
            if client is None:
                continue
            d = os.path.join(client.data_dir, "allocs", alloc_id)
            if os.path.isdir(d):
                return d
        raise KeyError(f"alloc dir not found for {alloc_id}")

    @staticmethod
    def _apply_request_ns(query, job):
        """A job spec that doesn't name a namespace registers into the
        request's (?namespace= / CLI -namespace); an explicit spec
        namespace wins and is ACL-re-checked either way."""
        ns = query.get("namespace", "default")
        if job.namespace == "default" and ns not in ("default", "*"):
            job.namespace = ns

    def _check_deployment_ns(self, query, deploy_id: str, capability: str):
        d = self.server.state.deployment_by_id(deploy_id) if self.server else None
        if d is not None:
            self._check_ns(query, d.namespace, capability)

    def _check_ns(self, query, namespace: str, capability: str):
        """Re-check the capability against the RESOURCE's namespace: the
        route gate used the caller-chosen ?namespace=, and trusting it
        would let a token scoped to one namespace act on another's
        resources (the cross-namespace escalation class)."""
        acl = query.get("__acl__")
        if acl is None:
            return
        if not acl.allow_namespace_operation(namespace, capability):
            raise PermissionError("Permission denied")

    def _check_alloc_ns(self, query, alloc_id: str, capability: str):
        alloc = self.server.state.alloc_by_id(alloc_id) if self.server else None
        if alloc is not None:
            self._check_ns(query, alloc.namespace, capability)

    def _forward_client_fs(self, alloc_id: str, method: str, payload: dict):
        """The alloc lives on a remote node: forward over the node's
        advertised client RPC listener (client_fs_endpoint.go's
        server→client path)."""
        server = self.server
        alloc = server.state.alloc_by_id(alloc_id) if server else None
        if alloc is None:
            raise KeyError(f"alloc not found: {alloc_id}")
        node = server.state.node_by_id(alloc.node_id)
        return self._forward_client_node(
            node, method, dict(payload, alloc_id=alloc_id)
        )

    def _forward_client_node(self, node, method: str, payload: dict):
        """Forward an RPC to a specific node's client listener (the
        node-addressed variant used by client stats)."""
        addr = (
            node.attributes.get("unique.advertise.client_rpc")
            if node is not None
            else None
        )
        if not addr:
            raise KeyError(
                "target node has no advertised client RPC address"
            )
        from ..rpc import ConnPool, RpcError

        pool = getattr(self, "_fs_pool", None)
        if pool is None:
            # mTLS rides along when the cluster runs with TLS
            pool = self._fs_pool = ConnPool(
                tls_context=getattr(self.server, "tls_client_context", None)
            )
        # the node secret authenticates us to the client's RPC listener
        payload = dict(payload, secret=node.secret_id)
        # socket timeout must outlast the operation's own timeout
        timeout = float(payload.get("timeout", 0) or 0) + 15.0
        try:
            return pool.call(addr, method, payload, timeout=timeout)
        except RpcError as e:
            # preserve status semantics across the forwarding boundary
            if e.code == "not_found":
                raise KeyError(e.message) from e
            if e.code == "invalid":
                raise ValueError(e.message) from e
            raise

    @route("GET", r"/v1/client/fs/ls/(?P<alloc_id>[^/]+)", acl="ns:read-fs")
    def fs_ls(self, m, query, body):
        from ..client import fs

        self._check_alloc_ns(query, m["alloc_id"], "read-fs")
        path = query.get("path", "/")
        try:
            base = self._alloc_dir(m["alloc_id"])
        except KeyError:
            return self._forward_client_fs(
                m["alloc_id"], "ClientFS.List", {"path": path}
            ), None
        return fs.list_dir(base, path), None

    @route("GET", r"/v1/client/fs/cat/(?P<alloc_id>[^/]+)", acl="ns:read-fs")
    def fs_cat(self, m, query, body):
        from ..client import fs

        self._check_alloc_ns(query, m["alloc_id"], "read-fs")
        params = {
            "path": query.get("path", "/"),
            "offset": int(query.get("offset", 0)),
            "limit": int(query.get("limit", 1 << 20)),
        }
        try:
            base = self._alloc_dir(m["alloc_id"])
        except KeyError:
            return self._forward_client_fs(
                m["alloc_id"], "ClientFS.Cat", params
            ), None
        return fs.cat(base, **params), None

    @route("GET", r"/v1/client/fs/logs/(?P<alloc_id>[^/]+)", acl="ns:read-logs")
    def fs_logs(self, m, query, body):
        """Task log window: ?task=&type=stdout|stderr&offset=&origin=
        (the non-streaming core of fs_endpoint.go Logs; clients follow by
        polling with the returned offset)."""
        from ..client import fs

        task = query.get("task", "")
        if not task:
            raise ValueError("task is required")
        self._check_alloc_ns(query, m["alloc_id"], "read-logs")
        kind = query.get("type", "stdout")
        offset = int(query.get("offset", 0))
        origin = query.get("origin", "start")
        limit = int(query.get("limit", 1 << 20))
        try:
            base = self._alloc_dir(m["alloc_id"])
        except KeyError:
            return self._forward_client_fs(
                m["alloc_id"],
                "ClientFS.Logs",
                {
                    "task": task, "type": kind, "offset": offset,
                    "origin": origin, "limit": limit,
                },
            ), None
        return fs.logs(
            base, task, kind, offset=offset, origin=origin, limit=limit
        ), None

    @route("PUT", r"/v1/client/exec/(?P<alloc_id>[^/]+)", acl="ns:alloc-exec")
    def alloc_exec(self, m, query, body):
        """One-shot command in the task's working directory
        (ref alloc exec; the reference's interactive streaming session is
        served here as a run-to-completion exec with captured output)."""
        from ..client import fs

        body = body or {}
        task = body.get("Task", "")
        cmd = body.get("Cmd") or []
        if not task or not cmd:
            raise ValueError("Task and Cmd are required")
        self._check_alloc_ns(query, m["alloc_id"], "alloc-exec")
        timeout = float(body.get("Timeout", 30.0))
        try:
            base = self._alloc_dir(m["alloc_id"])
        except KeyError:
            return self._forward_client_fs(
                m["alloc_id"],
                "ClientFS.Exec",
                {"task": task, "cmd": cmd, "timeout": timeout},
            ), None
        return fs.exec_in(base, task, cmd, timeout=timeout), None

    def _serve_exec_ws(self, handler, alloc_id: str, query: dict):
        """Interactive exec over a websocket (ref command/agent/
        alloc_endpoint.go execStream; api/allocations.go Exec): JSON
        frames — {"stdin":{"data":b64}} / {"stdin":{"close":true}} /
        {"tty_size":{"height":H,"width":W}} up, {"stdout"/"stderr":
        {"data":b64}} and {"exited":true,"result":{"exit_code":N}} down.
        Local allocs bridge straight to the driver; remote allocs ride the
        server's duplex RPC forward to the hosting node."""
        import base64
        import threading as threading_mod

        from ..rpc.mux import StreamClosed, StreamError, pipe_streams
        from . import ws as ws_mod

        task = query.get("task", "")
        try:
            cmd = json.loads(query.get("command", "[]"))
        except json.JSONDecodeError:
            raise ValueError("command must be a JSON array")
        if not isinstance(cmd, list) or not cmd:
            raise ValueError("command is required")
        tty = str(query.get("tty", "false")).lower() in ("true", "1")
        self._check_alloc_ns(query, alloc_id, "alloc-exec")

        # resolve the exec source BEFORE upgrading, so failures are
        # ordinary HTTP errors rather than a dead websocket
        client = self._local_client_with_alloc(alloc_id)
        if client is not None:
            from ..client.execstream import bridge_exec

            proc = client.exec_session(alloc_id, task, cmd, tty=tty)
            stream, remote = pipe_streams()
            threading_mod.Thread(
                target=bridge_exec, args=(proc, remote), daemon=True,
                name="exec-ws-bridge",
            ).start()
        else:
            stream = self.server.open_client_exec(
                alloc_id, {"task": task, "cmd": cmd, "tty": tty}
            )

        sock = ws_mod.server_handshake(handler)

        def down():
            try:
                for frame in stream:
                    if frame.get("stdout"):
                        ws_mod.send_message(sock, json.dumps({
                            "stdout": {
                                "data": base64.b64encode(
                                    frame["stdout"]
                                ).decode()
                            }
                        }))
                    if frame.get("stderr"):
                        ws_mod.send_message(sock, json.dumps({
                            "stderr": {
                                "data": base64.b64encode(
                                    frame["stderr"]
                                ).decode()
                            }
                        }))
                    if "exit" in frame:
                        ws_mod.send_message(sock, json.dumps({
                            "exited": True,
                            "result": {"exit_code": frame["exit"]},
                        }))
            except StreamError as e:
                try:
                    ws_mod.send_message(
                        sock, json.dumps({"error": str(e)})
                    )
                except OSError:
                    pass
            except OSError:
                pass
            finally:
                ws_mod.send_close(sock)

        dt = threading_mod.Thread(target=down, daemon=True, name="exec-ws-down")
        dt.start()
        try:
            while True:
                try:
                    _, payload = ws_mod.read_message(sock)
                except (ws_mod.WsClosed, OSError):
                    break
                try:
                    obj = json.loads(payload.decode())
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue
                try:
                    stdin = obj.get("stdin") or {}
                    if stdin.get("data"):
                        stream.send(
                            {"stdin": base64.b64decode(stdin["data"])}
                        )
                    if stdin.get("close"):
                        stream.send({"eof": True})
                    size = obj.get("tty_size") or {}
                    if size:
                        stream.send({
                            "resize": [
                                int(size.get("height", 24)),
                                int(size.get("width", 80)),
                            ]
                        })
                except StreamClosed:
                    break
        finally:
            # the websocket is gone (or the session ended): tear the exec
            # down fully — a half-close would leave an orphaned process
            # pumping output nowhere
            if hasattr(stream, "abort"):
                stream.abort()  # local pipe: kills the process via bridge
            else:
                stream.close(
                    {"code": "connection", "message": "websocket closed"}
                )
            dt.join(timeout=5.0)

    # -- alloc lifecycle (ref alloc_endpoint.go Stop +
    # client_alloc_endpoint.go Restart/Signal) ---------------------------
    def _local_client_with_alloc(self, alloc_id: str):
        clients = []
        if self.agent is not None:
            clients = getattr(self.agent, "clients", None) or [
                getattr(self.agent, "client", None)
            ]
        for client in clients:
            if client is not None and alloc_id in getattr(
                client, "alloc_runners", {}
            ):
                return client
        return None

    @route("PUT", r"/v1/allocation/(?P<alloc_id>[^/]+)/stop", acl="ns:alloc-lifecycle")
    def alloc_stop(self, m, query, body):
        self._check_alloc_ns(query, m["alloc_id"], "alloc-lifecycle")
        eval_id = self.server.alloc_stop(m["alloc_id"])
        return {
            "EvalID": eval_id,
            "Index": self.server.state.latest_index(),
        }, None

    @route(
        "PUT",
        r"/v1/client/allocation/(?P<alloc_id>[^/]+)/restart",
        acl="ns:alloc-lifecycle",
    )
    def alloc_restart(self, m, query, body):
        self._check_alloc_ns(query, m["alloc_id"], "alloc-lifecycle")
        task = (body or {}).get("TaskName", "") or query.get("task", "")
        client = self._local_client_with_alloc(m["alloc_id"])
        if client is not None:
            return {"tasks": client.alloc_restart(m["alloc_id"], task)}, None
        return self._forward_client_fs(
            m["alloc_id"], "ClientAllocations.Restart", {"task": task}
        ), None

    @route(
        "PUT",
        r"/v1/client/allocation/(?P<alloc_id>[^/]+)/signal",
        acl="ns:alloc-lifecycle",
    )
    def alloc_signal(self, m, query, body):
        self._check_alloc_ns(query, m["alloc_id"], "alloc-lifecycle")
        body = body or {}
        signal = body.get("Signal", "") or query.get("signal", "SIGINT")
        task = body.get("TaskName", "") or query.get("task", "")
        client = self._local_client_with_alloc(m["alloc_id"])
        if client is not None:
            return {
                "tasks": client.alloc_signal(m["alloc_id"], signal, task)
            }, None
        return self._forward_client_fs(
            m["alloc_id"],
            "ClientAllocations.Signal",
            {"signal": signal, "task": task},
        ), None

    # -- client / alloc stats (ref client_stats_endpoint.go +
    # client_alloc_endpoint.go Stats) ------------------------------------
    @route("GET", r"/v1/client/stats", acl="node:read")
    def client_stats(self, m, query, body):
        """Host stats of the local client, or of ?node_id= via forwarding."""
        node_id = query.get("node_id", "")
        clients = []
        if self.agent is not None:
            clients = getattr(self.agent, "clients", None) or [
                getattr(self.agent, "client", None)
            ]
        for client in clients:
            if client is None:
                continue
            if not node_id or client.node.id.startswith(node_id):
                return client.host_stats(), None
        if not node_id:
            raise KeyError("this agent runs no client")
        nodes = self.server.state.node_by_prefix(node_id)
        if len(nodes) != 1:
            raise KeyError(f"node not found: {node_id}")
        return self._forward_client_node(nodes[0], "ClientStats.Stats", {}), None

    @route(
        "GET",
        r"/v1/client/allocation/(?P<alloc_id>[^/]+)/stats",
        acl="ns:read-job",
    )
    def alloc_stats(self, m, query, body):
        self._check_alloc_ns(query, m["alloc_id"], "read-job")
        client = self._local_client_with_alloc(m["alloc_id"])
        if client is not None:
            return client.alloc_stats(m["alloc_id"]), None
        return self._forward_client_fs(
            m["alloc_id"], "ClientAllocations.Stats", {}
        ), None

    # -- cluster event stream (ref command/agent/event_endpoint.go +
    # nomad/stream/): newline-delimited JSON frames over chunked HTTP or
    # the same frames over a websocket upgrade. Frames:
    #   {"Index": N, "Events": [...]}    — one raft apply's events
    #   {}                               — heartbeat (idle keep-alive)
    #   {"Snapshot": true, "Index": N, "Events": [...]}
    #                                    — snapshot-on-subscribe batch:
    #                                      state objects at raft index N
    #   {"SnapshotDone": true, "Index": N}
    #                                    — snapshot complete; deltas with
    #                                      index > N follow
    #   {"LostGap": true, "Index": N}    — ring overwrote events ≤ N
    #                                      (only when snapshots are off)
    #   {"Error": msg, "ResumeIndex": N} — closed (slow consumer /
    #                                      restore / shutdown); reconnect
    #                                      with index=N
    # Every frame's JSON is encoded exactly once in the broker and shared
    # across subscribers; this layer only moves bytes. Chunked streams are
    # served by the shared StreamMux pump (events/mux.py) — the handler
    # thread detaches the socket and returns; websockets keep a thread
    # (they need a reader for pings) but ride the same wire path.
    # --------------------------------------------------------------------
    EVENT_STREAM_HEARTBEAT = 10.0

    def _serve_event_stream(self, handler, parsed, query):
        from ..events import ALL_TOPICS, BrokerLimitError, required_capability

        broker = getattr(self.server, "event_broker", None)
        if broker is None:
            handler._respond(
                400, {"error": "event broker is disabled on this agent"}, None
            )
            return
        topics: dict[str, set] = {}
        # parse_qs already percent-decoded each spec; a second unquote
        # would corrupt keys legitimately containing %xx sequences
        for spec in parse_qs(parsed.query).get("topic", []) or ["*"]:
            topic, _, key = spec.partition(":")
            if topic != "*" and topic not in ALL_TOPICS:
                handler._respond(
                    400, {"error": f"unknown event topic {topic!r}"}, None
                )
                return
            topics.setdefault(topic, set()).add(key or "*")
        try:
            from_index = int(query.get("index", 0))
        except ValueError:
            handler._respond(400, {"error": "index must be an integer"}, None)
            return
        heartbeat = self.EVENT_STREAM_HEARTBEAT
        if query.get("heartbeat"):
            try:
                heartbeat = float(query["heartbeat"])
            except ValueError:
                try:
                    heartbeat = parse_duration(query["heartbeat"]) / 1e9
                except Exception:
                    handler._respond(
                        400,
                        {"error": f"bad heartbeat {query['heartbeat']!r}"},
                        None,
                    )
                    return
        # a non-positive heartbeat would turn the frame loop into a
        # client-controlled busy-spin on a server thread
        heartbeat = max(heartbeat, 0.1)
        # brownout shed class for this stream: batch hangs up first,
        # service next, system never (core/overload.py ladder). Explicit
        # ?admission_class= wins; a numeric ?priority= maps through the
        # same bands as eval shedding; default is service. Without an
        # overload{} stanza nothing ever sheds — the knob is inert.
        from ..core.overload import CLASSES as _ADM_CLASSES
        from ..core.overload import CLASS_SERVICE, classify_priority

        adm_class = (query.get("admission_class") or "").strip().lower()
        if adm_class and adm_class not in _ADM_CLASSES:
            handler._respond(
                400,
                {"error": f"unknown admission_class {adm_class!r}"},
                None,
            )
            return
        if not adm_class:
            if query.get("priority"):
                try:
                    adm_class = classify_priority(int(query["priority"]))
                except ValueError:
                    handler._respond(
                        400,
                        {"error": "priority must be an integer"},
                        None,
                    )
                    return
            else:
                adm_class = CLASS_SERVICE
        # the stream spans all namespaces the token can read unless the
        # caller narrows it; the subscribe-time gate below must evaluate
        # against the SAME scope the subscription will cover, so the
        # wildcard is the shared default (per-event filtering still
        # re-checks each event's own namespace at delivery)
        namespace = query.get("namespace", "*")
        query["namespace"] = namespace
        acl_obj = None
        if self.server is not None and self.server.acl_enabled():
            # browsers can't set headers on EventSource/ws dials; accept
            # the token as a query param too (same rule as the exec ws)
            secret = handler.headers.get("X-Nomad-Token", "") or query.get(
                "token", ""
            )
            try:
                acl_obj = self.server.resolve_token(secret)
            except PermissionError as e:
                handler._respond(403, {"error": str(e)}, None)
                return
            except NotLeaderError as e:
                # streams aren't proxied; retryable error, not a false 403
                handler._respond(
                    500, {"error": f"not the leader ({e})"}, None
                )
                return
            # subscribe-time gate per requested topic; each delivered
            # event is re-filtered against ITS namespace. The wildcard
            # topic spans node-scoped + namespaced events, so it needs
            # the union of both capabilities.
            for topic in topics:
                wanted = ALL_TOPICS if topic == "*" else (topic,)
                for t in wanted:
                    if not _acl_allows(
                        acl_obj, required_capability(t), query
                    ):
                        handler._respond(
                            403, {"error": "Permission denied"}, None
                        )
                        return
        # snapshot-on-subscribe: explicit ?snapshot= wins; otherwise the
        # broker's configured default (event_broker{snapshot_on_subscribe},
        # on unless disabled). The broker only actually snapshots when it
        # helps — a cold subscribe or a resume past the ring's retention;
        # an in-retention resume stays a plain replay either way.
        snap_q = (query.get("snapshot") or "").strip().lower()
        if snap_q:
            want_snapshot = snap_q in ("1", "true", "yes")
        else:
            want_snapshot = broker.snapshot_on_subscribe
        try:
            sub = broker.subscribe(
                topics,
                from_index=from_index,
                acl=acl_obj,
                namespace=namespace,
                snapshot=want_snapshot,
            )
        except BrokerLimitError as e:
            handler._respond(503, {"error": str(e)}, None)
            return
        if "websocket" in handler.headers.get("Upgrade", "").lower():
            try:
                self._event_stream_ws(handler, sub, heartbeat)
            finally:
                sub.close()
            return
        # chunked tier: write the headers here, then hand the socket to
        # the shared mux and return — ownership (socket AND subscription)
        # transfers; the per-request teardown skips the detached socket
        try:
            wfile = handler.wfile
            handler.send_response(200)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.send_header(
                "X-Nomad-Index", str(self.server.state.latest_index())
            )
            handler.end_headers()
            wfile.flush()
            self._detached_socks.add(handler.connection)
            self._event_mux().serve(
                handler.connection,
                sub,
                heartbeat,
                admission_class=adm_class,
            )
        except Exception:
            self._detached_socks.discard(handler.connection)
            sub.close()
            raise

    def _event_mux(self):
        """The shared chunked-stream pump, created on first use with the
        broker's frame_batch knob."""
        with self._stream_mux_lock:
            mux = self._stream_mux
            if mux is None:
                from ..events.mux import StreamMux

                broker = getattr(self.server, "event_broker", None)
                mux = self._stream_mux = StreamMux(
                    frame_batch=getattr(broker, "frame_batch", 64)
                )
                # hand the mux's shed switch to the server's brownout
                # ladder; registration replays any already-degraded
                # stream levels so a mux created mid-brownout sheds too
                srv = self.server
                if srv is not None and hasattr(
                    srv, "add_stream_shed_hook"
                ):
                    srv.add_stream_shed_hook(mux.set_class_shed)
        return mux

    def _event_stream_ws(self, handler, sub, heartbeat):
        import threading as threading_mod

        from . import ws as ws_mod

        sock = ws_mod.server_handshake(handler)

        def reader():
            # drain client frames (answers pings inside read_message);
            # a close/EOF tears the subscription down so the send loop
            # exits at its next frame instead of writing into a dead pipe
            try:
                while True:
                    ws_mod.read_message(sock)
            except (ws_mod.WsClosed, OSError):
                pass
            finally:
                sub.close()

        threading_mod.Thread(
            target=reader, daemon=True, name="event-stream-ws-reader"
        ).start()
        try:
            while True:
                # encode-once wire lines straight from the broker; one ws
                # message per NDJSON line, batched per wake
                lines, done = sub.next_wires(timeout=heartbeat)
                if not lines and not done:
                    ws_mod.send_message(sock, b"{}")  # heartbeat
                    continue
                for line in lines:
                    ws_mod.send_message(sock, line)
                if done:
                    break
        except OSError:
            pass
        finally:
            ws_mod.send_close(sock)

    # -- acl (ref acl_endpoint.go + command/agent/acl_endpoint.go) -------
    @route("PUT", r"/v1/acl/bootstrap", acl="anonymous")
    def acl_bootstrap(self, m, query, body):
        token = self.server.acl_bootstrap()
        return _acl_token_dict(token), None

    @route("GET", r"/v1/acl/policies")
    def acl_list_policies(self, m, query, body):
        return [
            {"Name": p.name, "Description": p.description}
            for p in self.server.state.acl_policies()
        ], self.server.state.latest_index()

    @route("GET", r"/v1/acl/policy/(?P<name>[^/]+)")
    def acl_get_policy(self, m, query, body):
        p = self.server.state.acl_policy_by_name(m["name"])
        if p is None:
            raise KeyError(f"policy not found: {m['name']}")
        return {
            "Name": p.name,
            "Description": p.description,
            "Rules": p.rules,
        }, None

    @route("PUT", r"/v1/acl/policy/(?P<name>[^/]+)")
    def acl_put_policy(self, m, query, body):
        from ..structs.model import AclPolicy

        body = body or {}
        policy = AclPolicy(
            name=m["name"],
            description=body.get("Description", ""),
            rules=body.get("Rules", ""),
        )
        self.server.acl_upsert_policies([policy])
        return {}, None

    @route("DELETE", r"/v1/acl/policy/(?P<name>[^/]+)")
    def acl_delete_policy(self, m, query, body):
        self.server.acl_delete_policies([m["name"]])
        return {}, None

    @route("GET", r"/v1/acl/tokens")
    def acl_list_tokens(self, m, query, body):
        return [
            {
                "AccessorID": t.accessor_id,
                "Name": t.name,
                "Type": t.type,
                "Policies": list(t.policies),
                "Global": t.global_token,
            }
            for t in self.server.state.acl_tokens()
        ], self.server.state.latest_index()

    @route("PUT", r"/v1/acl/token")
    def acl_create_token(self, m, query, body):
        from ..structs.model import AclToken

        body = body or {}
        token = AclToken(
            name=body.get("Name", ""),
            type=body.get("Type", "client"),
            policies=list(body.get("Policies", [])),
            global_token=bool(body.get("Global", False)),
        )
        token = self.server.acl_create_token(token)
        return _acl_token_dict(token), None

    @route("DELETE", r"/v1/acl/token/(?P<accessor>[^/]+)")
    def acl_delete_token(self, m, query, body):
        self.server.acl_delete_tokens([m["accessor"]])
        return {}, None

    @route("GET", r"/v1/acl/token/self", acl="anonymous")
    def acl_token_self(self, m, query, body):
        """ref acl_endpoint.go GetToken (self); resolves the request's own
        secret, so it needs no management capability."""
        secret = query.get("__secret__", "")
        token = self.server.state.acl_token_by_secret(secret)
        if token is None:
            raise KeyError("token not found for provided secret")
        return _acl_token_dict(token), None

    @route("GET", r"/v1/acl/token/(?P<accessor>[^/]+)")
    def acl_get_token(self, m, query, body):
        token = self.server.state.acl_token_by_accessor(m["accessor"])
        if token is None:
            raise KeyError(f"token not found: {m['accessor']}")
        return _acl_token_dict(token), None

    # -- search (ref search_endpoint.go) ---------------------------------
    @route("PUT", r"/v1/search", acl="ns:read-job")
    def search(self, m, query, body):
        body = body or {}
        acl = query.get("__acl__")
        return self.server.search(
            prefix=body.get("Prefix", ""),
            context=(body.get("Context") or "all"),
            namespace=query.get("namespace", "default"),
            include_nodes=acl is None or acl.allow_node_read(),
        ), self.server.state.latest_index()

    @route("GET", r"/v1/operator/scheduler/configuration", acl="operator:read")
    def get_scheduler_config(self, m, query, body):
        return self.server.state.scheduler_config() or {}, None

    @route("PUT", r"/v1/operator/scheduler/configuration", acl="operator:write")
    def set_scheduler_config(self, m, query, body):
        # Must replicate via raft like every other write (ref
        # operator_endpoint.go SchedulerSetConfiguration → raftApply):
        # a direct state write would exist only on the serving server
        # and vanish on failover.
        from ..core import fsm as fsm_mod

        self.server._apply(fsm_mod.SCHEDULER_CONFIG, {"config": body or {}})
        return {"Updated": True}, None


def _acl_token_dict(t) -> dict:
    return {
        "AccessorID": t.accessor_id,
        "SecretID": t.secret_id,
        "Name": t.name,
        "Type": t.type,
        "Policies": list(t.policies),
        "Global": t.global_token,
    }


def _alloc_stub(a: Allocation) -> dict:
    return {
        "ID": a.id,
        "Name": a.name,
        "NodeID": a.node_id,
        "JobID": a.job_id,
        "TaskGroup": a.task_group,
        "DesiredStatus": a.desired_status,
        "ClientStatus": a.client_status,
        "DeploymentStatus": (
            a.deployment_status.to_dict()
            if a.deployment_status is not None
            else None
        ),
        "CreateIndex": a.create_index,
        "ModifyIndex": a.modify_index,
    }
