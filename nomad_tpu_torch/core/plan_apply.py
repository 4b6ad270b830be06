"""The device part of the plan applier's dense verify.

Counterpart of the device call in ``Planner._evaluate_plan_device``
(``nomad_tpu/core/plan_apply.py``): the applier aggregates a plan's usage
deltas per touched node row on the host, and the device checks each row
against the device-resident planes. The host part around it (node status,
rows with ports or devices, overlay deltas, the oracle that confirms each
failure) reads the scheduler's structs and comes with the scheduler
front; here a row that does not fit only comes back ``False``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tpu import kernel
from ..tpu.columnar import R_COLS
from ..tpu.mirror import DeviceState


def dense_verify(arrays, rows, row_deltas) -> np.ndarray:
    """Fit verdict per touched row, bool[k], for the rows' aggregated
    deltas (one lane per row, i64/i32[k,C]) on top of ``arrays``, the
    (capacity, usable, used) tensors of ``DeviceState.arrays()``; the
    verify runs on the planes' device. The lanes pad to the dirty-row
    bucket with row 0 and a delta of 0, as the JAX applier pads them."""
    capacity, _, used = arrays
    if not isinstance(capacity, torch.Tensor) or not isinstance(used, torch.Tensor):
        raise TypeError("dense_verify takes the planes of DeviceState.arrays() as tensors")
    k = len(rows)
    if k == 0:
        return np.zeros(0, dtype=bool)
    if min(rows) < 0 or max(rows) >= capacity.shape[0]:
        raise ValueError(f"row outside [0, {capacity.shape[0]})")
    padded, deltas = verify_lanes(rows, row_deltas)
    fits = kernel.verify_rows(capacity, used, *kernel.from_numpy((padded, deltas), capacity.device))
    return fits[:k].cpu().numpy()


def verify_lanes(rows, row_deltas) -> tuple:
    """The verify's (rows, deltas) lanes as numpy, padded to the dirty-row
    bucket with row 0 and a delta of 0 (adding 0 to row 0 changes no
    verdict)."""
    k = len(rows)
    b = DeviceState._row_bucket(k)
    padded = np.zeros(b, dtype=np.int32)
    padded[:k] = rows
    deltas = np.zeros((b, R_COLS), dtype=np.int32)
    deltas[:k] = np.stack(row_deltas)
    return padded, deltas
