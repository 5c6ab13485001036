"""Selector layout of a circuit (reference plonky2/src/gates/selectors.rs:
125-209): gates are grouped, and selector polynomial S_i takes the gate's
index on rows of a gate of group i, UNUSED_SELECTOR elsewhere.  The builder
computes the layout with ``selector_polynomials``; a loaded circuit brings
it in its metadata."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .base import UNUSED_SELECTOR


@dataclass
class SelectorsInfo:
    selector_indices: List[int]    # gate index -> selector poly index
    groups: List[Tuple[int, int]]  # [start, end) ranges over sorted gates

    @property
    def num_selectors(self) -> int:
        return len(self.groups)


def selector_polynomials(gates, instances, max_degree: int, p: int):
    """gates: the sorted unique gates; instances: one (gate, constants)
    instance per row.  Returns (selector value arrays, SelectorsInfo):
    gates are grouped greedily in their sorted order so that a group's size
    plus its largest degree stays below ``max_degree``, or all in one group
    when they fit (reference selectors.rs:125-209)."""
    n = len(instances)
    num_gates = len(gates)
    max_gate_degree = gates[-1].degree()
    index = {g.id(): i for i, g in enumerate(gates)}

    if max_gate_degree + num_gates - 1 <= max_degree:
        poly = np.array([index[inst.gate.id()] for inst in instances],
                        dtype=np.uint64)
        return [poly], SelectorsInfo(selector_indices=[0] * num_gates,
                                     groups=[(0, num_gates)])

    assert max_gate_degree < max_degree, (
        f"{gates[-1].id()} has too high degree; "
        "increase max_quotient_degree_factor")

    groups: List[Tuple[int, int]] = []
    start = 0
    while start < num_gates:
        size = 0
        while (start + size < num_gates
               and size + gates[start + size].degree() < max_degree):
            size += 1
        groups.append((start, start + size))
        start += size
    selector_indices = [next(gi for gi, (a, b) in enumerate(groups)
                             if a <= i < b) for i in range(num_gates)]

    unused = UNUSED_SELECTOR % p
    polys = [np.full(n, unused, dtype=np.uint64) for _ in groups]
    for row, inst in enumerate(instances):
        i = index[inst.gate.id()]
        polys[selector_indices[i]][row] = i
    return polys, SelectorsInfo(selector_indices=selector_indices,
                                groups=groups)


# the four shared lookup selectors (reference selectors.rs:36-40): the
# table rows' running-sum transition, the looking rows' transition, the
# row after a table (initial values), the last looking row; then one end
# selector per table
LOOKUP_SEL_TRANS_SRE = 0
LOOKUP_SEL_TRANS_LDC = 1
LOOKUP_SEL_INIT_SRE = 2
LOOKUP_SEL_LAST_LDC = 3
LOOKUP_SEL_START_END = 4


def selectors_lookup(n_rows: int, lookup_rows) -> List[np.ndarray]:
    """The four shared lookup selectors (reference selectors.rs:52-85);
    ``lookup_rows`` holds one (last looking row, last table row, first
    table row) triple a table, its rows laid out upside down."""
    polys = [np.zeros(n_rows, dtype=np.uint64)
             for _ in range(LOOKUP_SEL_START_END)]
    for last_lu, last_lut, first_lut in lookup_rows:
        polys[LOOKUP_SEL_TRANS_SRE][last_lut:first_lut + 1] = 1
        polys[LOOKUP_SEL_TRANS_LDC][last_lu:last_lut] = 1
        polys[LOOKUP_SEL_INIT_SRE][first_lut + 1] = 1
        polys[LOOKUP_SEL_LAST_LDC][last_lu] = 1
    return polys


def selector_ends_lookups(n_rows: int, lookup_rows) -> List[np.ndarray]:
    """One selector a table, 1 at its last table row (reference
    selectors.rs:88-112)."""
    out = []
    for _, last_lut, _ in lookup_rows:
        p = np.zeros(n_rows, dtype=np.uint64)
        p[last_lut] = 1
        out.append(p)
    return out
