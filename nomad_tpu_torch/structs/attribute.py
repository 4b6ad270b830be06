"""Typed attributes with units, used by device fingerprints and device
constraints (ref plugins/shared/structs/attribute.go, units.go)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# unit name -> (base unit, multiplier, inverse)
# (ref plugins/shared/structs/units.go tables)
_UNITS: dict[str, tuple[str, float, bool]] = {
    # binary bytes
    "KiB": ("byte", 1 << 10, False),
    "MiB": ("byte", 1 << 20, False),
    "GiB": ("byte", 1 << 30, False),
    "TiB": ("byte", 1 << 40, False),
    "PiB": ("byte", 1 << 50, False),
    "EiB": ("byte", 1 << 60, False),
    # decimal bytes
    "kB": ("byte", 1000.0, False),
    "KB": ("byte", 1000.0, False),
    "MB": ("byte", 1000.0**2, False),
    "GB": ("byte", 1000.0**3, False),
    "TB": ("byte", 1000.0**4, False),
    "PB": ("byte", 1000.0**5, False),
    "EB": ("byte", 1000.0**6, False),
    # binary byte rates
    "KiB/s": ("byte_rate", 1 << 10, False),
    "MiB/s": ("byte_rate", 1 << 20, False),
    "GiB/s": ("byte_rate", 1 << 30, False),
    "TiB/s": ("byte_rate", 1 << 40, False),
    "PiB/s": ("byte_rate", 1 << 50, False),
    "EiB/s": ("byte_rate", 1 << 60, False),
    # decimal byte rates
    "kB/s": ("byte_rate", 1000.0, False),
    "KB/s": ("byte_rate", 1000.0, False),
    "MB/s": ("byte_rate", 1000.0**2, False),
    "GB/s": ("byte_rate", 1000.0**3, False),
    "TB/s": ("byte_rate", 1000.0**4, False),
    "PB/s": ("byte_rate", 1000.0**5, False),
    "EB/s": ("byte_rate", 1000.0**6, False),
    # hertz
    "MHz": ("hertz", 1000.0**2, False),
    "GHz": ("hertz", 1000.0**3, False),
    # watts
    "mW": ("watt", 1000.0, True),
    "W": ("watt", 1.0, False),
    "kW": ("watt", 1000.0, False),
    "MW": ("watt", 10.0**6, False),
    "GW": ("watt", 10.0**9, False),
}

_LENGTH_SORTED_UNITS = sorted(_UNITS, key=len, reverse=True)


@dataclass
class Attribute:
    int_val: Optional[int] = None
    float_val: Optional[float] = None
    string_val: Optional[str] = None
    bool_val: Optional[bool] = None
    unit: str = ""

    # -- constructors -----------------------------------------------------
    @classmethod
    def of_string(cls, v: str) -> "Attribute":
        return cls(string_val=v)

    @classmethod
    def of_int(cls, v: int, unit: str = "") -> "Attribute":
        return cls(int_val=v, unit=unit)

    @classmethod
    def of_float(cls, v: float, unit: str = "") -> "Attribute":
        return cls(float_val=v, unit=unit)

    @classmethod
    def of_bool(cls, v: bool) -> "Attribute":
        return cls(bool_val=v)

    # -- accessors --------------------------------------------------------
    def get_string(self) -> tuple[str, bool]:
        return (self.string_val, True) if self.string_val is not None else ("", False)

    def get_int(self) -> tuple[int, bool]:
        return (self.int_val, True) if self.int_val is not None else (0, False)

    def get_float(self) -> tuple[float, bool]:
        return (self.float_val, True) if self.float_val is not None else (0.0, False)

    def get_bool(self) -> tuple[bool, bool]:
        return (self.bool_val, True) if self.bool_val is not None else (False, False)

    # -- comparison (ref attribute.go:282-420) ----------------------------
    def _typed_unit(self) -> Optional[tuple[str, float, bool]]:
        return _UNITS.get(self.unit) if self.unit else None

    def comparable(self, other: "Attribute") -> bool:
        au, bu = self._typed_unit(), other._typed_unit()
        if au is not None and bu is not None:
            return au[0] == bu[0]
        if (au is None) != (bu is None):
            return False
        if self.string_val is not None:
            return other.string_val is not None
        if self.bool_val is not None:
            return other.bool_val is not None
        # Both sides must be numeric (int or float) to compare further.
        self_num = self.int_val is not None or self.float_val is not None
        other_num = other.int_val is not None or other.float_val is not None
        return self_num and other_num

    def _base_value(self) -> float:
        v = self.int_val if self.int_val is not None else (self.float_val or 0.0)
        u = self._typed_unit()
        if u is None:
            return float(v)
        _, mult, inverse = u
        return float(v) / mult if inverse else float(v) * mult

    def compare(self, other: "Attribute") -> tuple[int, bool]:
        """Returns (cmp, ok): cmp is 0/-1/+1; for bools 0 if equal else 1."""
        if not self.comparable(other):
            return 0, False
        if self.bool_val is not None:
            return (0 if self.bool_val == other.bool_val else 1), True
        if self.string_val is not None:
            a, b = self.string_val, other.string_val
            return (0 if a == b else (-1 if a < b else 1)), True
        if (
            self.int_val is not None
            and other.int_val is not None
            and self._typed_unit() is None
            and other._typed_unit() is None
        ):
            a, b = self.int_val, other.int_val
            return (0 if a == b else (-1 if a < b else 1)), True
        a, b = self._base_value(), other._base_value()
        if a == b:
            return 0, True
        return (-1 if a < b else 1), True

    def to_dict(self) -> dict:
        return {
            "int_val": self.int_val,
            "float_val": self.float_val,
            "string_val": self.string_val,
            "bool_val": self.bool_val,
            "unit": self.unit,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Attribute":
        return cls(**d)


def parse_attribute(input_str: str) -> Attribute:
    """Parse a raw string into a typed attribute (ref attribute.go:58-101)."""
    if not input_str:
        return Attribute.of_string(input_str)
    unit = ""
    numeric = input_str
    if input_str[-1].isalpha():
        for u in _LENGTH_SORTED_UNITS:
            if input_str.endswith(u):
                unit = u
                break
        if unit:
            numeric = input_str[: -len(unit)].strip()
    try:
        return Attribute.of_int(int(numeric), unit)
    except ValueError:
        pass
    try:
        return Attribute.of_float(float(numeric), unit)
    except ValueError:
        pass
    low = input_str.strip().lower()
    if low in ("true", "t", "1"):
        return Attribute.of_bool(True)
    if low in ("false", "f", "0"):
        return Attribute.of_bool(False)
    return Attribute.of_string(input_str)
