"""ACL system (ref acl/policy.go + acl/acl.go + nomad/acl.go):
policy HCL → capability sets, compiled ACL evaluation, token resolution."""

from .acl import ACL, ACL_ANONYMOUS, ACL_MANAGEMENT, compile_acl
from .policy import POLICY_DENY, POLICY_READ, POLICY_WRITE, ParsedPolicy, parse_policy

__all__ = [
    "ACL",
    "ACL_ANONYMOUS",
    "ACL_MANAGEMENT",
    "compile_acl",
    "ParsedPolicy",
    "parse_policy",
    "POLICY_DENY",
    "POLICY_READ",
    "POLICY_WRITE",
]
