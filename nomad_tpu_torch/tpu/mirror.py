"""Device-resident node planes kept current by dirty-row scatters.

Counterpart of ``DeviceState`` and ``_scatter_fn`` in
``nomad_tpu/tpu/mirror.py``. The committed-plane adapter around it
(``ColumnarMirror``, ``MirrorCluster``) reads the state store and comes
with the scheduler front; here the caller hands ``DeviceState`` the
committed planes as numpy and adds dirty row ids to ``pending``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import kernel
from .columnar import R_COLS


def scatter_rows_ref(used, rows, vals):
    """Plain version of the dirty-row scatter (JAX ``_scatter_fn(None)``):
    a NEW plane equal to ``used`` with ``out[rows[i]] = vals[i]``. Among
    lanes on one row the lowest lane wins (JAX leaves the order of
    duplicate writes open; its callers' duplicates carry one value). A
    lane whose row lies outside [0, N) writes nothing."""
    N, R = used.shape[0], rows.shape[0]
    out = used.clone()
    ok = (rows >= 0) & (rows < N)
    at = torch.where(ok, rows, 0).long()
    lane = torch.arange(R, device=rows.device)
    first = torch.full((N,), R, dtype=torch.int64, device=rows.device).scatter_reduce(
        0, at[ok], lane[ok], "amin"
    )
    keep = ok & (first[at] == lane)
    out[at[keep]] = vals[keep]
    return out


_SCATTER_SHAPES = dict(used="NC", rows="R", vals="RC")


def scatter_rows(used, rows, vals):
    """``used`` with ``rows`` set to ``vals``, in a new tensor: ``used``,
    which an earlier kernel may still be reading, is never written. On the
    card it is one launch (``csrc/scatter.cu``) and one allocation."""
    device = used.device
    if device.type == "cpu":
        return scatter_rows_ref(used, rows, vals)
    from . import _build

    d = kernel._check_int32(dict(used=used, rows=rows, vals=vals), _SCATTER_SHAPES, device)
    out = torch.empty_like(used)
    kernel._launch(
        "scatter_rows",
        _build.library().ntt_scatter_rows,
        kernel._ptr(used), kernel._ptr(rows), kernel._ptr(vals), kernel._ptr(out),
        d["N"], d["C"], d["R"],
        kernel._stream(device),
    )
    return out


def dirty_lanes(rows, used_host) -> tuple:
    """The scatter's (rows, values) lanes for dirty ``rows`` of the host
    plane ``used_host``, as numpy: padded to the row bucket with row 0 and
    row 0's own value, values clipped to the device plane's [0, 2**30]."""
    rows = np.asarray(rows, dtype=np.int32)
    if rows.min() < 0 or rows.max() >= len(used_host):
        raise ValueError(f"dirty row outside [0, {len(used_host)})")
    padded = np.zeros(DeviceState._row_bucket(len(rows)), dtype=np.int32)
    padded[: len(rows)] = rows
    return padded, np.clip(used_host[padded], 0, 2**30).astype(np.int32)


class DeviceState:
    """The node planes of one (epoch, padded N) on the device: capacity and
    usable uploaded once, and a ``used`` plane kept current by scattering
    just the dirty rows. A refresh COPIES rather than updates in place:
    a drain batch hands ``used`` to kernels that may still be reading it
    when the next refresh comes, so a plane once handed out is never
    written."""

    #: dirty-row counts are bucketed, as the JAX package buckets them to
    #: bound its compiled scatter shapes
    _ROW_BUCKETS = (8, 64, 512, 4096)

    def __init__(self, epoch: int, n_pad: int, capacity, usable, used, device=None):
        dev = resolve_device(device)
        self.epoch = epoch
        self.n_pad = n_pad
        n = capacity.shape[0]
        cap = np.zeros((n_pad, R_COLS), dtype=np.int32)
        cap[:n] = np.clip(capacity, 0, 2**31 - 1)
        usa = np.ones((n_pad, 2), dtype=np.float32)
        usa[:n] = usable
        use = np.full((n_pad, R_COLS), 2**30, dtype=np.int32)
        use[:n] = np.clip(used, 0, 2**30)
        self.capacity, self.usable, self.used = (
            torch.from_numpy(a).to(dev) for a in (cap, usa, use)
        )
        #: dirty rows since the last refresh; the caller adds to it
        self.pending: set[int] = set()

    @property
    def device(self) -> torch.device:
        return self.used.device

    @staticmethod
    def _row_bucket(n: int) -> int:
        for b in DeviceState._ROW_BUCKETS:
            if n <= b:
                return b
        return ((n + 4095) // 4096) * 4096

    def refresh(self, used_host: np.ndarray) -> None:
        """Push the pending dirty rows of ``used_host`` to the device as one
        scatter into a new ``used`` plane."""
        if not self.pending:
            return
        rows = np.fromiter(self.pending, dtype=np.int32, count=len(self.pending))
        padded, vals = dirty_lanes(rows, used_host)
        self.pending.clear()
        dev = self.device
        self.used = scatter_rows(
            self.used, torch.from_numpy(padded).to(dev), torch.from_numpy(vals).to(dev)
        )

    def arrays(self):
        """(capacity, usable, used) on the device. A later refresh makes a
        NEW used plane, so a tensor handed out here never changes."""
        return self.capacity, self.usable, self.used
