"""Scalar scheduler — the correctness oracle (ref scheduler/)."""

from .context import EvalContext, EvalEligibility
from .generic import GenericScheduler
from .rank import BinPackIterator, RankedNode
from .reconcile import AllocReconciler, ReconcileResults
from .scheduler import BUILTIN_SCHEDULERS, Planner, new_scheduler
from .stack import GenericStack, SelectOptions, SystemStack
from .system import SystemScheduler
from .testing import Harness, RejectPlan
