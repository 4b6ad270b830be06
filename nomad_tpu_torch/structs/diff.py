"""Structural job diff for the ``job plan`` dry-run surface
(ref nomad/structs/diff.go: Job.Diff/TaskGroupDiff/TaskDiff producing
Added/Deleted/Edited field and object trees rendered by the CLI).

The reference hand-writes per-struct Diff methods over ~2K lines; here one
recursive differ walks the dataclasses generically, producing the same
shape: {Type, Name, Fields: [...], Objects: [...], TaskGroups/Tasks} with
Type ∈ {Added, Deleted, Edited, None}. Bookkeeping fields that churn on
every write (indexes, status, submit time) are excluded like the
reference's diffable(false) tags."""

from __future__ import annotations

import json

from dataclasses import fields, is_dataclass
from typing import Any, Optional


def _canonical(v: Any) -> str:
    """Key-order-insensitive string form for free-form container values."""
    try:
        return json.dumps(v, sort_keys=True, default=str)
    except (TypeError, ValueError):
        return repr(v)

DIFF_TYPE_NONE = "None"
DIFF_TYPE_ADDED = "Added"
DIFF_TYPE_DELETED = "Deleted"
DIFF_TYPE_EDITED = "Edited"

#: fields never diffed (server bookkeeping; ref structs.go diff tags)
_EXCLUDED = {
    "create_index",
    "modify_index",
    "job_modify_index",
    "submit_time",
    "status",
    "status_description",
    "stable",
    "version",
    "computed_class",
    "status_updated_at",
    "events",
}


def _is_scalar(v: Any) -> bool:
    return isinstance(v, (str, int, float, bool)) or v is None


def _scalar_str(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _field_diff(name: str, old: Any, new: Any) -> Optional[dict]:
    old_s, new_s = _scalar_str(old), _scalar_str(new)
    if old_s == new_s:
        return None
    if old is None or old == "" and new_s:
        kind = DIFF_TYPE_ADDED
    elif new is None or new == "" and old_s:
        kind = DIFF_TYPE_DELETED
    else:
        kind = DIFF_TYPE_EDITED
    return {"Type": kind, "Name": name, "Old": old_s, "New": new_s}


def _object_name(v: Any, default: str) -> str:
    for attr in ("name", "id", "label", "l_target", "attribute"):
        val = getattr(v, attr, None)
        if val:
            return str(val)
    return default


def diff_objects(name: str, old: Any, new: Any) -> Optional[dict]:
    """Recursive diff of two dataclass instances (either may be None)."""
    if old is None and new is None:
        return None
    diff_type = DIFF_TYPE_EDITED
    if old is None:
        diff_type = DIFF_TYPE_ADDED
    elif new is None:
        diff_type = DIFF_TYPE_DELETED

    template = new if new is not None else old
    field_diffs: list[dict] = []
    object_diffs: list[dict] = []

    for f in fields(template):
        if f.name in _EXCLUDED or f.name.startswith("_"):
            continue
        ov = getattr(old, f.name, None) if old is not None else None
        nv = getattr(new, f.name, None) if new is not None else None

        if _is_scalar(ov) and _is_scalar(nv):
            d = _field_diff(f.name, ov, nv)
            if d:
                field_diffs.append(d)
        elif isinstance(ov, dict) or isinstance(nv, dict):
            ov = ov or {}
            nv = nv or {}
            for key in sorted(set(ov) | set(nv), key=str):
                a, b = ov.get(key), nv.get(key)
                if _is_scalar(a) and _is_scalar(b):
                    d = _field_diff(f"{f.name}[{key}]", a, b)
                    if d:
                        field_diffs.append(d)
                elif is_dataclass(a) or is_dataclass(b):
                    d = diff_objects(f"{f.name}[{key}]", a, b)
                    if d:
                        object_diffs.append(d)
                else:
                    # free-form container values (task config's nested
                    # lists/dicts — e.g. args): compare a canonical,
                    # key-order-insensitive serialization; recursing into
                    # fields() would blow up on non-dataclass values and
                    # repr() would flag reordered-but-equal dicts
                    d = _field_diff(
                        f"{f.name}[{key}]",
                        None if a is None else _canonical(a),
                        None if b is None else _canonical(b),
                    )
                    if d:
                        field_diffs.append(d)
        elif isinstance(ov, (list, tuple)) or isinstance(nv, (list, tuple)):
            object_diffs.extend(_diff_lists(f.name, ov or [], nv or []))
        elif is_dataclass(ov) or is_dataclass(nv):
            d = diff_objects(f.name, ov, nv)
            if d:
                object_diffs.append(d)

    if not field_diffs and not object_diffs and diff_type == DIFF_TYPE_EDITED:
        return None
    return {
        "Type": diff_type,
        "Name": name,
        "Fields": field_diffs,
        "Objects": object_diffs,
    }


def _diff_lists(name: str, old: list, new: list) -> list[dict]:
    """Lists pair by object name (constraints, affinities, networks...) or
    by position for scalar lists."""
    out: list[dict] = []
    if all(_is_scalar(v) for v in list(old) + list(new)):
        old_set = [_scalar_str(v) for v in old]
        new_set = [_scalar_str(v) for v in new]
        for v in old_set:
            if v not in new_set:
                out.append(
                    {
                        "Type": DIFF_TYPE_DELETED,
                        "Name": name,
                        "Fields": [
                            {"Type": DIFF_TYPE_DELETED, "Name": name, "Old": v, "New": ""}
                        ],
                        "Objects": [],
                    }
                )
        for v in new_set:
            if v not in old_set:
                out.append(
                    {
                        "Type": DIFF_TYPE_ADDED,
                        "Name": name,
                        "Fields": [
                            {"Type": DIFF_TYPE_ADDED, "Name": name, "Old": "", "New": v}
                        ],
                        "Objects": [],
                    }
                )
        return out

    def keyed(items):
        # duplicate display names (e.g. two constraints on one l_target)
        # get positional suffixes so neither is silently dropped; the
        # suffix order pairs k-th duplicate with k-th duplicate
        out = {}
        for i, v in enumerate(items):
            key = _object_name(v, f"{name}[{i}]")
            base, n = key, 2
            while key in out:
                key = f"{base} #{n}"
                n += 1
            out[key] = v
        return out

    old_by = keyed(old)
    new_by = keyed(new)
    for key in sorted(set(old_by) | set(new_by), key=str):
        d = diff_objects(f"{name} ({key})" if key else name, old_by.get(key), new_by.get(key))
        if d:
            out.append(d)
    return out


def job_diff(old, new) -> dict:
    """Top-level job diff (ref diff.go Job.Diff): job fields plus per-task-
    group diffs with nested task diffs."""
    diff_type = DIFF_TYPE_EDITED
    if old is None:
        diff_type = DIFF_TYPE_ADDED
    elif new is None:
        diff_type = DIFF_TYPE_DELETED

    template = new if new is not None else old
    base = diff_objects(template.id if template else "", old, new) or {
        "Type": DIFF_TYPE_NONE,
        "Name": template.id if template else "",
        "Fields": [],
        "Objects": [],
    }
    # task groups get their own section (the CLI renders them specially)
    base["Objects"] = [
        o for o in base["Objects"] if not o["Name"].startswith("task_groups")
    ]

    old_tgs = {tg.name: tg for tg in (old.task_groups if old else [])}
    new_tgs = {tg.name: tg for tg in (new.task_groups if new else [])}
    tg_diffs = []
    for tg_name in sorted(set(old_tgs) | set(new_tgs)):
        otg, ntg = old_tgs.get(tg_name), new_tgs.get(tg_name)
        d = diff_objects(tg_name, otg, ntg)
        if d is None:
            d = {
                "Type": DIFF_TYPE_NONE,
                "Name": tg_name,
                "Fields": [],
                "Objects": [],
            }
        # task diffs nested one level down, like TaskGroupDiff.Tasks
        d["Objects"] = [
            o for o in d.get("Objects", []) if not o["Name"].startswith("tasks")
        ]
        old_tasks = {t.name: t for t in (otg.tasks if otg else [])}
        new_tasks = {t.name: t for t in (ntg.tasks if ntg else [])}
        task_diffs = []
        for t_name in sorted(set(old_tasks) | set(new_tasks)):
            td = diff_objects(t_name, old_tasks.get(t_name), new_tasks.get(t_name))
            if td:
                task_diffs.append(td)
        d["Tasks"] = task_diffs
        if (
            d["Type"] == DIFF_TYPE_NONE
            and not d["Fields"]
            and not d["Objects"]
            and not task_diffs
        ):
            continue
        tg_diffs.append(d)
    base["TaskGroups"] = tg_diffs
    base["Type"] = (
        diff_type
        if old is None or new is None
        else (
            DIFF_TYPE_EDITED
            if base["Fields"] or base["Objects"] or tg_diffs
            else DIFF_TYPE_NONE
        )
    )
    return base
