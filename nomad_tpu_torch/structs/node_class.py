"""Computed node class: a stable hash over a node's non-unique scheduling
attributes, used to memoize feasibility per class (ref
nomad/structs/node_class.go). The hashed projection covers datacenter,
node_class, non-unique attributes/meta, and device groups (vendor/type/name +
non-unique attrs) — exactly the reference's HashInclude whitelist."""

from __future__ import annotations

import hashlib
import json

from .model import Constraint, Node

NODE_UNIQUE_NAMESPACE = "unique."


def is_unique_namespace(key: str) -> bool:
    return key.startswith(NODE_UNIQUE_NAMESPACE)


def compute_class(node: Node) -> str:
    """Set node.computed_class from the class-relevant projection of the node."""
    projection = {
        "datacenter": node.datacenter,
        "node_class": node.node_class,
        "attributes": {
            k: v for k, v in sorted(node.attributes.items()) if not is_unique_namespace(k)
        },
        "meta": {
            k: v for k, v in sorted(node.meta.items()) if not is_unique_namespace(k)
        },
        "devices": [
            {
                "vendor": d.vendor,
                "type": d.type,
                "name": d.name,
                "attributes": {
                    k: (v.to_dict() if hasattr(v, "to_dict") else v)
                    for k, v in sorted(d.attributes.items())
                    if not is_unique_namespace(k)
                },
            }
            for d in (node.node_resources.devices if node.node_resources else [])
        ],
    }
    digest = hashlib.blake2b(
        json.dumps(projection, sort_keys=True).encode(), digest_size=8
    ).hexdigest()
    node.computed_class = f"v1:{digest}"
    return node.computed_class


def constraint_target_escapes(target: str) -> bool:
    """Whether a constraint target escapes computed-class memoization
    (ref node_class.go:121-132)."""
    return (
        target.startswith("${node.unique.")
        or target.startswith("${attr.unique.")
        or target.startswith("${meta.unique.")
    )


def escaped_constraints(constraints: list[Constraint]) -> list[Constraint]:
    """Constraints that escape computed node classes (ref node_class.go:108-117)."""
    return [
        c
        for c in constraints
        if constraint_target_escapes(c.l_target) or constraint_target_escapes(c.r_target)
    ]
