"""ACL policy language (ref acl/policy.go: namespace blocks with
policy/capability grants plus node/agent/operator/quota blocks).

Policies are HCL:

    namespace "default" { policy = "write" }
    namespace "ops-*"   { capabilities = ["read-job", "submit-job"] }
    node     { policy = "read" }
    agent    { policy = "write" }
    operator { policy = "read" }

Coarse policies expand to capability sets exactly as the reference's
expandNamespacePolicy (policy.go:92-118)."""

from __future__ import annotations

from dataclasses import dataclass, field

POLICY_DENY = "deny"
POLICY_READ = "read"
POLICY_WRITE = "write"

# namespace capabilities (policy.go:40-66)
NS_CAP_DENY = "deny"
NS_CAP_LIST_JOBS = "list-jobs"
NS_CAP_READ_JOB = "read-job"
NS_CAP_SUBMIT_JOB = "submit-job"
NS_CAP_DISPATCH_JOB = "dispatch-job"
NS_CAP_READ_LOGS = "read-logs"
NS_CAP_READ_FS = "read-fs"
NS_CAP_ALLOC_EXEC = "alloc-exec"
NS_CAP_ALLOC_LIFECYCLE = "alloc-lifecycle"
NS_CAP_SENTINEL_OVERRIDE = "sentinel-override"

_READ_CAPS = [NS_CAP_LIST_JOBS, NS_CAP_READ_JOB]
_WRITE_CAPS = _READ_CAPS + [
    NS_CAP_SUBMIT_JOB,
    NS_CAP_DISPATCH_JOB,
    NS_CAP_READ_LOGS,
    NS_CAP_READ_FS,
    NS_CAP_ALLOC_EXEC,
    NS_CAP_ALLOC_LIFECYCLE,
]

VALID_COARSE = {POLICY_DENY, POLICY_READ, POLICY_WRITE}


class PolicyError(ValueError):
    pass


@dataclass
class NamespacePolicy:
    name: str  # may contain a glob suffix: "ops-*"
    capabilities: set[str] = field(default_factory=set)
    deny: bool = False


@dataclass
class ParsedPolicy:
    namespaces: list[NamespacePolicy] = field(default_factory=list)
    node: str = ""  # "", deny, read, write
    agent: str = ""
    operator: str = ""


def expand_namespace_policy(policy: str) -> list[str]:
    """ref policy.go:92-118 expandNamespacePolicy"""
    if policy == POLICY_DENY:
        return [NS_CAP_DENY]
    if policy == POLICY_READ:
        return list(_READ_CAPS)
    if policy == POLICY_WRITE:
        return list(_WRITE_CAPS)
    raise PolicyError(f"invalid namespace policy {policy!r}")


def parse_policy(rules: str) -> ParsedPolicy:
    """HCL rules → ParsedPolicy (ref policy.go:170-240 Parse)."""
    from ..jobspec import parse_hcl

    raw = parse_hcl(rules)
    parsed = ParsedPolicy()

    namespaces = raw.get("namespace", {})
    if isinstance(namespaces, dict):
        # {"default": {...}} or a single unlabeled block {"policy": ...}
        if "policy" in namespaces or "capabilities" in namespaces:
            namespaces = {"default": namespaces}
        for name, body in namespaces.items():
            if not isinstance(body, dict):
                raise PolicyError(f"namespace {name!r}: expected a block")
            caps: set[str] = set()
            deny = False
            coarse = body.get("policy")
            if coarse is not None:
                if coarse not in VALID_COARSE:
                    raise PolicyError(
                        f"namespace {name!r}: invalid policy {coarse!r}"
                    )
                expanded = expand_namespace_policy(coarse)
                if NS_CAP_DENY in expanded:
                    deny = True
                caps.update(c for c in expanded if c != NS_CAP_DENY)
            for cap in body.get("capabilities", []) or []:
                if cap == NS_CAP_DENY:
                    deny = True
                else:
                    caps.add(cap)
            parsed.namespaces.append(
                NamespacePolicy(name=name, capabilities=caps, deny=deny)
            )

    for block in ("node", "agent", "operator"):
        body = raw.get(block)
        if body is None:
            continue
        coarse = body.get("policy", "") if isinstance(body, dict) else ""
        if coarse and coarse not in VALID_COARSE:
            raise PolicyError(f"{block}: invalid policy {coarse!r}")
        setattr(parsed, block, coarse)
    return parsed
