"""Agent configuration (ref command/agent/config.go + config_parse.go:
HCL config files merged in order, CLI flags overriding, and a SIGHUP
reload path for the reloadable subset)."""

from __future__ import annotations

import logging
from typing import Any

#: defaults (ref config.go DefaultConfig)
DEFAULT_AGENT_CONFIG: dict[str, Any] = {
    "region": "global",
    "datacenter": "dc1",
    "data_dir": "",
    "log_level": "INFO",
    "ports": {"http": 4646},
    "server": {"enabled": False, "bootstrap_expect": 1, "num_schedulers": 2},
    "client": {"enabled": False, "servers": []},
    "acl": {"enabled": False},
    "gossip": {},
    # telemetry-style stanza for the cluster event stream (events/):
    # event_broker { enabled = true  event_buffer_size = 4096
    #                subscriber_buffer = 1024
    #                snapshot_on_subscribe = true  # cold subscribers get
    #                    # a state snapshot stamped at raft index N, then
    #                    # deltas from N (and lost-gap resumes become
    #                    # snapshot+deltas instead of a gap bail)
    #                max_subscribers = 0   # admission cap, 0 = unlimited
    #                frame_batch = 64 }    # frames batched per socket
    #                                      # write on the stream mux
    "event_broker": {},
    # operator debug plane (nomad_tpu/debug; OBSERVABILITY.md):
    # debug { flight_recorder = true   # false: no sampling thread
    #         flight_interval = 1.0  flight_retain = 512
    #         bundle_dir = "/var/lib/nomad-tpu/debug"
    #         watchdog { bundle_keep = 8   # newest auto-bundles kept
    #                    plan_queue_wait_p99 { threshold_ms = 500 } } }
    "debug": {},
    # plan applier pipeline (core/plan_apply.py; OBSERVABILITY.md):
    # plan_pipeline { max_inflight = 2       # concurrent uncommitted
    #                                        # raft entries (1 = classic
    #                                        # join-before-dispatch)
    #                 device_verify = true   # dense verify on the mirror's
    #                                        # device-resident planes
    #                 device_verify_min = 256  # placements below this take
    #                                          # the host paths outright
    #                 ready_shards = 1 }     # eval-broker ready-queue
    #                                        # shards (by job hash)
    "plan_pipeline": {},
    # wavefront placement plane (tpu/wavefront.py; OBSERVABILITY.md):
    # wavefront { enabled = true       # route the exact-scan dispatch
    #                                  # through conflict-free batched
    #                                  # commits (parity-exact)
    #             max_round = 32       # placements attempted per device
    #                                  # round (window width W)
    #             contention_top_m = 1 }  # candidate nodes per lane fed
    #                                     # to the conflict binning (1 =
    #                                     # winner-only, already exact)
    "wavefront": {},
    # paged node axis (tpu/paging.py; OBSERVABILITY.md): stream the
    # planner's dense node planes through device memory in tiles when
    # the cluster exceeds the resident budget
    # paging { enabled = true             # route over-budget windowed
    #                                     # dispatch through the pager
    #          device_node_budget_mb = 256  # device-resident node-plane
    #                                       # byte budget (floored at
    #                                       # two tiles for the double
    #                                       # buffer)
    #          tile_nodes = 65536 }      # node rows per tile (rounded
    #                                    # to a power of two + mesh
    #                                    # multiple by tile_rows())
    "paging": {},
    # overload control plane (core/overload.py; OBSERVABILITY.md):
    # overload { enabled = true        # stanza present+enabled wires the
    #                                  # plane; absent = byte-identical
    #                                  # pre-overload behavior
    #            depth_limit = 4096    # broker ready+unacked depth that
    #                                  # reads as load 1.0
    #            queue_wait_budget_ms = 500  # plan.queue_wait p99 that
    #                                        # reads as load 1.0
    #            shed_batch = 0.8      # load at which batch work sheds
    #            shed_service = 0.95   # ... service work (system + node
    #                                  # heartbeats are never shed)
    #            retry_after_s = 1.0   # client hint on 429/ErrOverloaded
    #            retry_budget = 256    # process-wide retry token bucket
    #            retry_refill_per_s = 64.0
    #            default_deadline_s = 0  # per-request deadline minted for
    #                                    # write endpoints without an
    #                                    # explicit X-Nomad-Deadline
    #                                    # (0 = none)
    #            brownout { enabled = true
    #                       enter = 0.9   exit = 0.6  # load thresholds
    #                       enter_streak = 3          # consecutive samples
    #                       exit_streak = 5 } }       # before a step
    "overload": {},
}


def deep_merge(base: dict, override: dict) -> dict:
    """Later config wins; nested dicts merge recursively (the reference's
    per-struct Merge methods, config.go Merge)."""
    out = dict(base)
    for key, value in override.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def _normalize(value):
    """HCL1 turns repeated blocks into lists of objects; agent config
    semantics merge them (config_parse.go's object-list handling)."""
    if isinstance(value, list) and value and all(
        isinstance(v, dict) for v in value
    ):
        merged: dict = {}
        for v in value:
            merged = deep_merge(merged, _normalize(v))
        return merged
    if isinstance(value, dict):
        return {k: _normalize(v) for k, v in value.items()}
    return value


def load_agent_config(paths: list[str]) -> dict:
    """Parse + merge HCL agent config files in order over the defaults."""
    from .jobspec import parse_hcl

    merged = dict(DEFAULT_AGENT_CONFIG)
    for path in paths:
        with open(path) as f:
            raw = parse_hcl(f.read())
        merged = deep_merge(merged, _normalize(raw))
    return merged


def apply_log_level(config: dict):
    """The SIGHUP-reloadable subset (ref agent.go Reload: log level)."""
    level = str(config.get("log_level", "INFO")).upper()
    numeric = getattr(logging, level, None)
    if not isinstance(numeric, int):
        raise ValueError(f"invalid log_level {level!r}")
    logging.getLogger("nomad_tpu").setLevel(numeric)
    return level


def server_config_from_agent(config: dict) -> dict:
    """The Server(...) config dict derived from an agent config."""
    server = config.get("server", {})
    out = {
        "region": config.get("region", "global"),
        "acl": dict(config.get("acl", {})),
    }
    if config.get("event_broker"):
        out["event_broker"] = dict(config["event_broker"])
    if config.get("gossip"):
        out["gossip"] = dict(config["gossip"])
        out["bootstrap"] = bool(server.get("bootstrap_expect", 1) <= 1)
    # serf encryption: reference agents put `encrypt` in the server stanza
    if server.get("encrypt"):
        out["encrypt"] = server["encrypt"]
    # vault{enabled, address, token}: the server selects the real-Vault
    # HTTP provider when an address is configured (core/vault.py)
    if config.get("vault"):
        out["vault"] = dict(config["vault"])
    # debug plane: the pprof/bundle HTTP gate rides the top-level
    # enable_debug key (ref config.go EnableDebug); the debug{} stanza
    # tunes the flight recorder / watchdog / bundle capture
    if config.get("enable_debug"):
        out["enable_debug"] = True
    if config.get("debug"):
        out["debug"] = dict(config["debug"])
    if config.get("plan_pipeline"):
        out["plan_pipeline"] = dict(config["plan_pipeline"])
    if config.get("wavefront"):
        out["wavefront"] = dict(config["wavefront"])
    if config.get("paging"):
        out["paging"] = dict(config["paging"])
    if config.get("overload"):
        out["overload"] = dict(config["overload"])
    for key in (
        "heartbeat_ttl",
        "eval_gc_interval",
        "job_gc_interval",
        "node_gc_interval",
        "deployment_gc_interval",
        "eval_gc_threshold",
        "job_gc_threshold",
        "node_gc_threshold",
        "deployment_gc_threshold",
        "default_scheduler",
        "batch_drain",
        "plan_apply_batch",
        "prewarm_kernels",
        "prewarm_drain_nodes",
        "seed",
    ):
        if key in server:
            out[key] = server[key]
    return out
