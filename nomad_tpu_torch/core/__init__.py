"""Server core: broker, plan queue/applier, workers, endpoints (ref nomad/).

The port's copy of ``nomad_tpu.core``: the applier's dense verify
(``plan_apply.dense_verify``) and the drain batch run on the port's
kernels, on the server's device."""

from .blocked_evals import BlockedEvals
from .broker import FAILED_QUEUE, BrokerError, EvalBroker
from .plan_apply import PlanQueue, Planner, evaluate_plan
from .server import Server
from .worker import Worker
