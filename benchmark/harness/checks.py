"""A number that decides ``correct``, beside its limit."""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class Check:
    """``limit`` None: a reading kept for setting limits, not compared."""

    name: str
    value: float
    limit: float | None

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit

    def line(self) -> str:
        verdict = "ok" if self.ok else "FAIL"
        return f"check {self.name} {self.value!r} limit {self.limit!r} {verdict}"
