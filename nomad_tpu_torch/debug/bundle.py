"""Debug bundle: one directory (or tarball) holding everything an
operator needs to debug an agent after the fact — the ``nomad operator
debug`` role.

Contents (all JSON except the flamegraph-ready ``profile.folded``):

- ``manifest.json``  — capture reason/time, file list, agent identity;
- ``config.json``    — the server config, **secrets redacted**;
- ``metrics.json``   — full metrics registry snapshot;
- ``flight.json``    — the flight-recorder ring (the pre-incident tape);
- ``threads.json``   — one-shot thread stacks + gc (the pprof dump);
- ``profile.json``   — sampling-profiler report (``profile.folded`` is
  the same data as flamegraph input);
- ``traces.json``    — slowest-N + error traces from the trace store;
- ``lockdep.json``   — contention table + violations (when installed);
- ``device.json``    — the device plane (debug/devprof.py): compile
  ledger with per-executable cost + HLO collective census, transfer
  totals, per-planner round counters, last-dispatch table;
- ``findings.json``  — the analysis layer: applier_block_frac, top
  blocked sites, watchdog state, trace critical-path verdict, and the
  distilled devprof summary (collective_rounds_per_placement).

Captured by the watchdog on a rule trip, by ``nomad-tpu operator
debug`` / ``GET /v1/debug/bundle`` on demand, and by scripts/debug.sh.
"""

from __future__ import annotations

import json
import os
import tarfile
import time

#: config keys whose values never leave the process (substring match,
#: case-insensitive: encrypt, vault tokens, tls material, acl secrets)
_SENSITIVE = ("token", "secret", "password", "encrypt", "key", "cert", "ca")

REDACTED = "<redacted>"

#: every file a complete bundle carries (the watchdog test pins this)
BUNDLE_FILES = (
    "manifest.json",
    "config.json",
    "metrics.json",
    "flight.json",
    "threads.json",
    "profile.json",
    "profile.folded",
    "traces.json",
    "lockdep.json",
    "device.json",
    "findings.json",
)


def redact_config(value, key: str = ""):
    """Deep-copy ``value`` with sensitive leaves replaced and
    non-JSON-serializable objects (raft transports, sockets) rendered as
    type placeholders — the bundle must never require pickling live
    machinery or leak credentials."""
    lowered = key.lower()
    if isinstance(value, dict):
        return {
            str(k): redact_config(v, key=str(k)) for k, v in value.items()
        }
    if isinstance(value, (list, tuple)):
        return [redact_config(v, key=key) for v in value]
    if isinstance(value, (str, bytes)) and any(
        s in lowered for s in _SENSITIVE
    ):
        return REDACTED
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return f"<{type(value).__name__}>"


def _write_json(dest: str, name: str, payload):
    with open(os.path.join(dest, name), "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, default=repr)
        f.write("\n")


def capture_bundle(
    server,
    dest: str,
    profile_seconds: float = 1.0,
    hz: float = 100.0,
    reason: str = "manual",
    slowest: int = 16,
) -> dict:
    """Write a full bundle into directory ``dest`` (created); returns
    the manifest (including ``path``). Every section is individually
    exception-guarded: a debug capture that dies on the one broken
    subsystem it exists to debug is worthless — missing sections are
    listed in the manifest's ``errors`` instead."""
    from .. import metrics
    from ..testing import lockdep
    from .profiler import profile, render_folded, thread_dump

    os.makedirs(dest, exist_ok=True)
    errors: dict[str, str] = {}
    t0 = time.time()

    def section(name, fn):
        try:
            return fn()
        except Exception as e:
            errors[name] = repr(e)
            return None

    _write_json(
        dest, "config.json",
        section("config", lambda: redact_config(server.config)) or {},
    )
    _write_json(
        dest, "metrics.json", section("metrics", metrics.snapshot) or {}
    )
    recorder = getattr(server, "flight_recorder", None)
    _write_json(
        dest, "flight.json",
        section("flight", recorder.dump) if recorder is not None else {},
    )
    _write_json(
        dest, "threads.json", section("threads", thread_dump) or {}
    )
    prof = section(
        "profile", lambda: profile(profile_seconds, hz=hz)
    ) or {}
    _write_json(dest, "profile.json", prof)
    with open(
        os.path.join(dest, "profile.folded"), "w", encoding="utf-8"
    ) as f:
        f.write(render_folded(prof) + "\n")

    def traces():
        from ..trace import tracer

        slow = tracer.store.list(limit=slowest, slowest=True)
        errs = tracer.store.list(limit=slowest, errors=True)
        return {
            "stats": tracer.stats(),
            "slowest": [
                r
                for r in (
                    tracer.store.get(row["trace_id"]) for row in slow
                )
                if r is not None
            ],
            "errors": errs,
        }

    _write_json(dest, "traces.json", section("traces", traces) or {})

    def lockdep_dump():
        if not lockdep.installed():
            return {"installed": False}
        table = sorted(
            (
                {"site": site, **entry}
                for site, entry in lockdep.contention().items()
            ),
            key=lambda e: -e["wait_s"],
        )
        return {
            "installed": True,
            "contention": table[:64],
            "violations": lockdep.violations(),
        }

    _write_json(
        dest, "lockdep.json", section("lockdep", lockdep_dump) or {}
    )

    def device():
        # the port has no device profiler yet (ROADMAP A9)
        return None

    _write_json(dest, "device.json", section("device", device) or {})

    def findings():
        out = {
            "applier_block_frac": prof.get("applier_block_frac"),
            "top_blocked_sites": prof.get("blocked_sites", [])[:10],
        }
        # the port has no device profiler yet (ROADMAP A9)
        out["device"] = None
        watchdog = getattr(server, "watchdog", None)
        if watchdog is not None:
            out["watchdog"] = watchdog.stats()
        broker = getattr(server, "event_broker", None)
        if broker is not None:
            # fan-out overload diagnosis without a live shell: who is
            # behind (per-subscriber lag top-N with queue depth and
            # topics) and what the ring looked like when the rule tripped
            out["event_broker"] = {
                "stats": broker.stats(),
                "subscriber_lag": broker.lag_stats(top=10),
            }
        try:
            from ..trace import attribute, tracer

            cp = attribute(tracer.store.records())
            out["critical_path"] = {
                "traces": cp["traces"],
                "bottleneck": cp["bottleneck"],
                "verdict": cp["verdict"],
            }
        except Exception:
            out["critical_path"] = None
        # federation diagnosis (the acl_replication_lag trip's payload):
        # which region this is, who it can reach, how replication and
        # cross-region forwarding are doing, and local raft health
        region = getattr(server, "region", None)
        if region is not None:
            try:
                from .. import metrics as _metrics

                counters = _metrics.snapshot()["counters"]
                fed = {
                    "region": region,
                    "known_regions": server.regions(),
                    "replication": dict(
                        getattr(server, "acl_replication_status", {}) or {}
                    ),
                    "raft": {
                        "leader_id": getattr(server.raft, "leader_id", None),
                        "is_leader": server.is_leader(),
                        "voters": sorted(server.raft.voters),
                    },
                    "forwarding": {
                        k: v
                        for k, v in counters.items()
                        if k.startswith(
                            ("http.region_forward", "http.leader_forward",
                             "rpc.not_leader_retry")
                        )
                    },
                }
                lag_fn = getattr(server, "acl_replication_lag_s", None)
                lag = lag_fn() if lag_fn is not None else None
                if lag is not None:
                    fed["replication"]["lag_s"] = round(lag, 3)
                out["federation"] = fed
            except Exception:
                out["federation"] = None
        return out

    _write_json(dest, "findings.json", section("findings", findings) or {})

    manifest = {
        "reason": reason,
        "created": round(t0, 3),
        "duration_s": round(time.time() - t0, 3),
        "profile_seconds": profile_seconds,
        "path": dest,
        "errors": errors,
        "files": sorted(
            fn for fn in os.listdir(dest) if fn != "manifest.json"
        ) + ["manifest.json"],
    }
    _write_json(dest, "manifest.json", manifest)
    return manifest


def make_tarball(bundle_dir: str, tar_path: str) -> str:
    """gzip tarball of a captured bundle directory (the HTTP/CLI wire
    form); members are rooted at the bundle dir's basename."""
    with tarfile.open(tar_path, "w:gz") as tar:
        tar.add(bundle_dir, arcname=os.path.basename(bundle_dir.rstrip("/")))
    return tar_path
