"""Typed plugin-configuration specs (the hclspec role,
ref plugins/shared/hclspec/hcl_spec.proto: Attr, Block, BlockList,
Literal, Default compose into a schema that decodes + validates nested
plugin config with defaults and PATHED errors).

The reference expresses driver/device plugin config schemas as an
hclspec protobuf evaluated against HCL; here the same composition is a
small tree of spec nodes evaluated against the already-parsed dict the
jobspec layer produces. Flat legacy schemas ({key: {"type", "default",
"required"}}) lift into Attr nodes so existing plugins keep working.
"""

from __future__ import annotations

from typing import Any, Optional


class SpecError(ValueError):
    """A config value failed its spec; ``path`` names the exact field
    (e.g. ``mounts[1].volume_options.labels``) the way the reference's
    hclspec decode errors do."""

    def __init__(self, path: str, message: str):
        super().__init__(f"config {path or '<root>'}: {message}")
        self.path = path


_PRIMITIVES = {
    "string": (str,),
    "number": (int, float),
    "bool": (bool,),
    "any": (object,),
}


def _check_primitive(path: str, typ: str, value):
    expected = _PRIMITIVES.get(typ)
    if expected is None:
        raise SpecError(path, f"unknown spec type {typ!r}")
    if typ == "number" and isinstance(value, bool):
        # bool is an int subclass; a number attr must still reject it
        raise SpecError(path, "must be number, got bool")
    if not isinstance(value, expected):
        raise SpecError(
            path, f"must be {typ}, got {type(value).__name__}"
        )
    return value


class Attr:
    """A typed attribute (ref hcl_spec.proto Attr): ``type`` is a
    primitive name, ``list(<prim>)`` or ``map(<prim>)``."""

    def __init__(self, type: str = "string", required: bool = False):
        self.type = type
        self.required = required

    def validate(self, path: str, value):
        t = self.type
        if t.startswith("list(") and t.endswith(")"):
            inner = t[5:-1]
            if not isinstance(value, list):
                raise SpecError(
                    path, f"must be {t}, got {type(value).__name__}"
                )
            return [
                _check_primitive(f"{path}[{i}]", inner, v)
                for i, v in enumerate(value)
            ]
        if t.startswith("map(") and t.endswith(")"):
            inner = t[4:-1]
            if not isinstance(value, dict):
                raise SpecError(
                    path, f"must be {t}, got {type(value).__name__}"
                )
            return {
                str(k): _check_primitive(f"{path}.{k}", inner, v)
                for k, v in value.items()
            }
        return _check_primitive(path, t, value)


class Literal:
    """A fixed value injected into the decoded config
    (ref hcl_spec.proto Literal)."""

    def __init__(self, value):
        self.value = value

    def validate(self, path: str, value):  # pragma: no cover - not called
        return self.value


class Default:
    """Wraps a spec with a default used when the key is absent
    (ref hcl_spec.proto Default)."""

    def __init__(self, primary, default):
        self.primary = primary
        self.default = default

    def validate(self, path: str, value):
        return self.primary.validate(path, value)


class Block:
    """One nested block of named entries (ref hcl_spec.proto Block)."""

    def __init__(self, spec: dict, required: bool = False):
        self.spec = dict(spec)
        self.required = required

    def validate(self, path: str, value):
        if not isinstance(value, dict):
            raise SpecError(
                path, f"must be a block, got {type(value).__name__}"
            )
        return validate_spec(self.spec, value, path=path)


class BlockList:
    """A repeated nested block (ref hcl_spec.proto BlockList); job specs
    hand single blocks through as a bare dict, accepted as [dict]."""

    def __init__(self, spec: dict, min: int = 0, max: int = 0):
        self.spec = dict(spec)
        self.min = min
        self.max = max

    def validate(self, path: str, value):
        if isinstance(value, dict):
            value = [value]
        if not isinstance(value, list):
            raise SpecError(
                path, f"must be a block list, got {type(value).__name__}"
            )
        if len(value) < self.min:
            raise SpecError(path, f"needs at least {self.min} block(s)")
        if self.max and len(value) > self.max:
            raise SpecError(path, f"allows at most {self.max} block(s)")
        return [
            Block(self.spec).validate(f"{path}[{i}]", v)
            for i, v in enumerate(value)
        ]


def _lift(node):
    """Legacy flat entries ({\"type\", \"required\", \"default\"}) lift
    into Attr/Default nodes; real spec nodes pass through."""
    if isinstance(node, (Attr, Block, BlockList, Default, Literal)):
        return node
    if isinstance(node, dict):
        attr = Attr(node.get("type", "string"), bool(node.get("required")))
        if "default" in node:
            return Default(attr, node["default"])
        return attr
    raise SpecError("", f"invalid spec node {node!r}")


def validate_spec(spec: dict, config: dict, path: str = "") -> dict:
    """Decode ``config`` against ``spec``: unknown keys, type mismatches,
    and missing required entries raise SpecError with the field's full
    path; defaults and literals fold into the result."""
    if not isinstance(config, dict):
        raise SpecError(path, f"must be a block, got {type(config).__name__}")
    spec = {k: _lift(v) for k, v in (spec or {}).items()}

    def at(key):
        return f"{path}.{key}" if path else key

    for key in config:
        if key not in spec:
            raise SpecError(at(key), "unknown config key")
    out = {}
    for key, node in spec.items():
        if isinstance(node, Literal):
            out[key] = node.value
            continue
        if key in config:
            out[key] = node.validate(at(key), config[key])
        elif isinstance(node, Default):
            out[key] = node.default
        elif getattr(node, "required", False) or (
            isinstance(node, BlockList) and node.min > 0
        ):
            raise SpecError(at(key), "required but missing")
    return out
