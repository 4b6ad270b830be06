"""Compiled ACL evaluation (ref acl/acl.go: capability lookup with
longest-prefix glob matching over namespace rules; management bypasses
everything, anonymous is the empty ACL)."""

from __future__ import annotations

import fnmatch
from typing import Iterable, Optional

from .policy import (
    POLICY_DENY,
    POLICY_READ,
    POLICY_WRITE,
    ParsedPolicy,
)


class ACL:
    """The result of compiling a token's policies."""

    def __init__(self, management: bool = False):
        self.management = management
        # exact and glob namespace rules: name -> (capabilities, deny)
        self._ns_exact: dict[str, tuple[set[str], bool]] = {}
        self._ns_glob: list[tuple[str, set[str], bool]] = []
        self.node = ""
        self.agent = ""
        self.operator = ""

    # ------------------------------------------------------------------
    def _namespace_rule(self, ns: str) -> Optional[tuple[set[str], bool]]:
        rule = self._ns_exact.get(ns)
        if rule is not None:
            return rule
        # longest glob match wins (acl.go: maxPrefix radix lookup)
        best = None
        best_len = -1
        for pattern, caps, deny in self._ns_glob:
            if fnmatch.fnmatchcase(ns, pattern) and len(pattern) > best_len:
                best = (caps, deny)
                best_len = len(pattern)
        return best

    def allow_namespace_operation(self, ns: str, capability: str) -> bool:
        if self.management:
            return True
        rule = self._namespace_rule(ns)
        if rule is None:
            return False
        caps, deny = rule
        if deny:
            return False
        return capability in caps

    def allow_namespace(self, ns: str) -> bool:
        """Any capability at all in the namespace (acl.go AllowNamespace)."""
        if self.management:
            return True
        rule = self._namespace_rule(ns)
        return rule is not None and not rule[1] and bool(rule[0])

    def allow_capability_any_namespace(self, capability: str) -> bool:
        """Whether ANY namespace rule grants the capability — the gate for
        wildcard (?namespace=*) list requests, whose results are then
        filtered per object (ref acl.go AllowNsOpFunc wildcard handling)."""
        if self.management:
            return True
        for caps, deny in self._ns_exact.values():
            if not deny and capability in caps:
                return True
        for _, caps, deny in self._ns_glob:
            if not deny and capability in caps:
                return True
        return False

    # -- coarse domains -------------------------------------------------
    def _coarse_allows(self, granted: str, needed: str) -> bool:
        if self.management:
            return True
        if granted == POLICY_DENY or not granted:
            return False
        if needed == POLICY_READ:
            return granted in (POLICY_READ, POLICY_WRITE)
        return granted == POLICY_WRITE

    def allow_node_read(self) -> bool:
        return self._coarse_allows(self.node, POLICY_READ)

    def allow_node_write(self) -> bool:
        return self._coarse_allows(self.node, POLICY_WRITE)

    def allow_agent_read(self) -> bool:
        return self._coarse_allows(self.agent, POLICY_READ)

    def allow_agent_write(self) -> bool:
        return self._coarse_allows(self.agent, POLICY_WRITE)

    def allow_operator_read(self) -> bool:
        return self._coarse_allows(self.operator, POLICY_READ)

    def allow_operator_write(self) -> bool:
        return self._coarse_allows(self.operator, POLICY_WRITE)


#: the ACL for management tokens — allows everything (acl.go ManagementACL)
ACL_MANAGEMENT = ACL(management=True)

#: the ACL for requests without a token — allows nothing
ACL_ANONYMOUS = ACL()


def compile_acl(policies: Iterable[ParsedPolicy]) -> ACL:
    """Merge parsed policies into one ACL (ref acl.go NewACL: union of
    capabilities per namespace; deny dominates; coarse domains take the
    most permissive grant unless denied)."""
    acl = ACL()
    coarse_rank = {"": 0, POLICY_READ: 1, POLICY_WRITE: 2, POLICY_DENY: 3}
    for policy in policies:
        for ns in policy.namespaces:
            target_exact = "*" not in ns.name and "?" not in ns.name
            if target_exact:
                caps, deny = acl._ns_exact.get(ns.name, (set(), False))
                acl._ns_exact[ns.name] = (caps | ns.capabilities, deny or ns.deny)
            else:
                merged = False
                for i, (pattern, caps, deny) in enumerate(acl._ns_glob):
                    if pattern == ns.name:
                        acl._ns_glob[i] = (
                            pattern, caps | ns.capabilities, deny or ns.deny
                        )
                        merged = True
                        break
                if not merged:
                    acl._ns_glob.append(
                        (ns.name, set(ns.capabilities), ns.deny)
                    )
        for domain in ("node", "agent", "operator"):
            granted = getattr(policy, domain)
            if not granted:
                continue
            current = getattr(acl, domain)
            if granted == POLICY_DENY or coarse_rank[granted] > coarse_rank[current]:
                # deny dominates; otherwise most permissive wins
                if current == POLICY_DENY:
                    continue
                setattr(acl, domain, granted)
    return acl
