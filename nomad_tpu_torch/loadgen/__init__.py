"""Churn-soak load plane: a sustained production-traffic simulator over
the real server surface (ROADMAP item 3).

Three layers, deliberately separable:

- :mod:`.grammar` — a seeded, deterministic workload grammar: composable
  storm phases (submit/scale/update bursts, rolling deploys, node flaps
  and drains, dispatch fan-out, GC pressure) compile to a byte-stable
  op stream — any run replays byte-identically from its seed;
- :mod:`.driver` — an open-loop driver that fires the compiled ops at
  their scheduled times through the real RPC/HTTP server surface (never
  direct store writes), measuring lateness instead of slowing down when
  the cluster falls behind;
- :mod:`.score` — a continuous scorekeeper: RSS ceiling, eval-latency
  p99 over time, event-stream subscriber lag, committed-plane view
  counters, plan-queue wait, and the cluster invariants checked
  *throughout* the storm (testing/invariants.py incremental mode), all
  folded into a scored ``SOAK_r*.json`` artifact and one
  ``SOAK_SUMMARY`` trailing line.

Run one with ``python -m nomad_tpu_torch.loadgen --scenario smoke --seed 7``
(on the CUDA card; ``--device cpu`` runs the server's plain versions).

The port's copy of ``nomad_tpu/loadgen/`` and its
``testing/invariants.py``: the storms, the grammar and the grading are
the JAX package's, and the server they drive is the port's, the
federated storm's (``federation.py``) six servers in two regions too.
"""

from .grammar import Op, OpStream, Phase, Scenario, compile_stream, named_rng
from .scenarios import get_scenario, list_scenarios

__all__ = [
    "Op",
    "OpStream",
    "Phase",
    "Scenario",
    "compile_stream",
    "named_rng",
    "get_scenario",
    "list_scenarios",
]
