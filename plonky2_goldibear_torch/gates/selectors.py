"""Selector layout of a circuit (reference plonky2/src/gates/selectors.rs:
125-209): gates are grouped, and selector polynomial S_i takes the gate's
index on rows of a gate of group i, UNUSED_SELECTOR elsewhere."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class SelectorsInfo:
    selector_indices: List[int]    # gate index -> selector poly index
    groups: List[Tuple[int, int]]  # [start, end) ranges over sorted gates

    @property
    def num_selectors(self) -> int:
        return len(self.groups)
