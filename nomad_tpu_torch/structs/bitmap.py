"""Fixed-size bitmap for port accounting and alloc name indexes.

Semantics follow the reference bitmap (nomad/structs/bitmap.go), but the
representation is a numpy bool array so the TPU columnar mirror can view the
same buffer as a dense ``bool[N, 65536]`` port plane without conversion.
"""

from __future__ import annotations

import numpy as np


class Bitmap:
    __slots__ = ("bits",)

    def __init__(self, size: int):
        if size == 0:
            raise ValueError("bitmap must be positive size")
        self.bits = np.zeros(size, dtype=bool)

    @property
    def size(self) -> int:
        return self.bits.shape[0]

    def set(self, idx: int):
        self.bits[idx] = True

    def unset(self, idx: int):
        self.bits[idx] = False

    def check(self, idx: int) -> bool:
        return bool(self.bits[idx])

    def clear(self):
        self.bits[:] = False

    def copy(self) -> "Bitmap":
        b = Bitmap(self.size)
        b.bits = self.bits.copy()
        return b

    def indexes_in_range(self, set_value: bool, lo: int, hi: int) -> list[int]:
        """Indexes in [lo, hi] whose value equals set_value
        (ref bitmap.go IndexesInRange)."""
        window = self.bits[lo : hi + 1]
        idx = np.nonzero(window == set_value)[0]
        return (idx + lo).tolist()
