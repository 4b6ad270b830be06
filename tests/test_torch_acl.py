"""The port's ACL: ``nomad_tpu_torch.acl`` against the JAX package's.

Both packages parse and compile the same policy texts on the CPU: every
policy of tests/test_acl.py and tests/test_acl_replication.py and a few
more (glob overlaps, capability lists with ``deny``, unlabeled blocks,
coarse domains that deny). For each policy, and for each merge of them,
the compiled ACLs give the same decision on a grid of namespaces and
namespace capabilities, on wildcard listing and on node, agent and
operator read and write. Invalid policies raise the same error type with
the same message. No server runs here.
"""

import itertools

import pytest

from torch_for_tests import gil_handoff  # noqa: F401

from nomad_tpu import acl as jacl
from nomad_tpu.acl import policy as jpolicy
from nomad_tpu_torch import acl as tacl
from nomad_tpu_torch.acl import policy as tpolicy

#: tests/test_acl.py's and tests/test_acl_replication.py's policies, then
#: the port's own
POLICIES = [
    'namespace "default" { policy = "read" }',
    'namespace "default" { policy = "write" }',
    '''
namespace "ops-*" { capabilities = ["read-job", "submit-job"] }
node { policy = "read" }
operator { policy = "write" }
''',
    'namespace "ops-*" { policy = "read" }',
    'namespace "ops-prod-*" { policy = "write" }',
    'namespace "default" { policy = "deny" }',
    'node { policy = "read" }',
    'namespace "dev" { policy = "write" }',
    # the port's own
    'namespace { policy = "write" }',
    'namespace "*" { policy = "read" }',
    'namespace "ops-prod-1" { capabilities = ["deny"] }',
    'namespace "dev" { capabilities = ["alloc-exec", "read-logs"] }',
    'agent { policy = "write" }\nnode { policy = "deny" }',
    'operator { policy = "read" }\nagent { policy = "read" }',
    '',
]

#: rules the parser refuses
INVALID = [
    'namespace "x" { policy = "root" }',
    'node { policy = "admin" }',
    'namespace "x" = 3',
]

NAMESPACES = ("default", "dev", "ops-dev", "ops-prod-1", "ops-prod-2", "other")
CAPABILITIES = ("list-jobs", "read-job", "submit-job", "dispatch-job", "read-logs",
                "read-fs", "alloc-exec", "alloc-lifecycle", "sentinel-override")
COARSE = ("allow_node_read", "allow_node_write", "allow_agent_read", "allow_agent_write",
          "allow_operator_read", "allow_operator_write")


def _decisions(acl) -> dict:
    out = {}
    for ns in NAMESPACES:
        out[ns] = (acl.allow_namespace(ns),
                   tuple(acl.allow_namespace_operation(ns, c) for c in CAPABILITIES))
    out["*"] = tuple(acl.allow_capability_any_namespace(c) for c in CAPABILITIES)
    out["coarse"] = tuple(getattr(acl, name)() for name in COARSE)
    return out


def _parsed(p) -> tuple:
    return ([(n.name, sorted(n.capabilities), n.deny) for n in p.namespaces],
            p.node, p.agent, p.operator)


@pytest.mark.parametrize("rules", POLICIES)
def test_one_policy_parses_and_decides_as_the_jax_one(rules):
    jp, tp = jpolicy.parse_policy(rules), tpolicy.parse_policy(rules)
    assert _parsed(tp) == _parsed(jp)
    assert _decisions(tacl.compile_acl([tp])) == _decisions(jacl.compile_acl([jp]))


@pytest.mark.parametrize("pair", list(itertools.combinations(range(len(POLICIES)), 2)))
def test_merged_policies_decide_as_the_jax_ones(pair):
    rules = [POLICIES[i] for i in pair]
    for order in (rules, rules[::-1]):
        want = jacl.compile_acl([jpolicy.parse_policy(r) for r in order])
        got = tacl.compile_acl([tpolicy.parse_policy(r) for r in order])
        assert _decisions(got) == _decisions(want)


def test_management_and_anonymous_decide_as_the_jax_ones():
    assert _decisions(tacl.ACL_MANAGEMENT) == _decisions(jacl.ACL_MANAGEMENT)
    assert _decisions(tacl.ACL_ANONYMOUS) == _decisions(jacl.ACL_ANONYMOUS)
    assert tacl.ACL_MANAGEMENT.allow_operator_write()
    assert not tacl.ACL_ANONYMOUS.allow_namespace_operation("default", "list-jobs")


@pytest.mark.parametrize("rules", INVALID)
def test_invalid_policies_raise_the_jax_error(rules):
    with pytest.raises(Exception) as want:
        jpolicy.parse_policy(rules)
    with pytest.raises(Exception) as got:
        tpolicy.parse_policy(rules)
    assert type(got.value).__name__ == type(want.value).__name__
    assert type(got.value).__module__.replace("nomad_tpu_torch", "nomad_tpu") == \
        type(want.value).__module__
    assert str(got.value) == str(want.value)
