"""Shared data model + resource math (ref nomad/structs/)."""

from .attribute import Attribute, parse_attribute
from .bitmap import Bitmap
from .devices import DeviceAccounter, DeviceAccounterInstance
from .funcs import allocs_fit, score_fit
from .model import *  # noqa: F401,F403
from .model import (
    Allocation,
    AllocMetric,
    Evaluation,
    Job,
    Node,
    Plan,
    PlanResult,
    Task,
    TaskGroup,
)
from .network import NetworkIndex, parse_port_ranges
from .node_class import (
    compute_class,
    constraint_target_escapes,
    escaped_constraints,
    is_unique_namespace,
)
