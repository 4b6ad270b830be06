"""Per-group planes of the columnar scheduler state: the port's own copy.

Counterpart of ``GroupPlanes`` in ``nomad_tpu/tpu/columnar.py`` and of
``R_COLS`` in ``nomad_tpu/state/planes.py``. The rest of the JAX module
(``ColumnarCluster``, which reads the state store) comes with the
scheduler front.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

#: dense resource columns: cpu MHz, memory MB, disk MB, network mbits
R_COLS = 4

#: spread sentinel: the node has no value for the spread attribute
NO_VALUE = -1


@dataclass
class GroupPlanes:
    """Per-task-group static planes over the shared node axis."""

    name: str
    feasible: np.ndarray  # bool[N]
    affinity: np.ndarray  # f32[N]
    affinity_present: np.ndarray  # bool[N]
    count: int = 1
    # spread over one attribute
    node_value: Optional[np.ndarray] = None  # i32[N] value ids, NO_VALUE if missing
    desired: Optional[np.ndarray] = None  # f32[V]; -1 = absent
    implicit: float = -1.0
    weight_frac: float = 0.0
    even: bool = False
    values: list[str] = field(default_factory=list)
    counts0: Optional[np.ndarray] = None  # i32[V]
    present0: Optional[np.ndarray] = None  # bool[V]
