"""Witness containers (reference plonky2/src/iop/witness.rs:277-385; the
JAX package's ``iop/witness.py``).

- ``PartialWitness``: the caller's target assignments (a dict).
- ``PartitionWitness``: values keyed by the disjoint-set representative
  index, so copy-constrained targets share one slot (witness.rs:321-385),
  in a dense uint64 value buffer and a filled bitmap: the buffers the
  witness-replay VM (``native/``) runs over.
- ``full_witness``: the dense (num_wires, degree) uint64 matrix (the
  reference's ``MatrixWitness``) that ``plonk/witness_transfer.py`` moves
  to the prover's device, gathered by the VM's ``witgen_gather``.

Values are canonical field elements as python ints.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..native import engine
from . import target as tgt


class PartialWitness:
    def __init__(self):
        self.target_values: Dict[tgt.Target, int] = {}

    def set_target(self, t: tgt.Target, value: int):
        if t in self.target_values:
            assert self.target_values[t] == value, \
                f"contradictory assignment for {t}"
        else:
            self.target_values[t] = value

    def set_targets(self, ts: Sequence[tgt.Target], values: Sequence[int]):
        for t, v in zip(ts, values):
            self.set_target(t, v)


class PartitionWitness:
    """Witness keyed by representative index (copy classes share slots).

    ``rng`` is the random state that ``RandomValueGenerator`` draws from
    (``iop/generator.py``: a ``NonRandomRng`` or a numpy generator).  A
    replay passes its own ``vals``, which holds the VM's temporaries after
    the representatives, and ``filled``, one byte a representative."""

    def __init__(self, num_wires: int, degree: int,
                 representative_map: np.ndarray, rng=None,
                 vals: Optional[np.ndarray] = None,
                 filled: Optional[np.ndarray] = None):
        self.num_wires = num_wires
        self.degree = degree
        self.rep = representative_map  # dense index -> representative index
        n = len(representative_map)
        self.vals = np.zeros(n, np.uint64) if vals is None else vals
        self.filled = np.zeros(n, np.uint8) if filled is None else filled
        self.rng = rng

    def index(self, t: tgt.Target) -> int:
        return tgt.target_index(t, self.num_wires, self.degree)

    def get_target(self, t: tgt.Target) -> int:
        rep = self.rep[self.index(t)]
        assert self.filled[rep], f"target {t} not set"
        return int(self.vals[rep])

    def get_targets(self, ts: Sequence[tgt.Target]) -> List[int]:
        return [self.get_target(t) for t in ts]

    def contains(self, t: tgt.Target) -> bool:
        return bool(self.filled[self.rep[self.index(t)]])

    def contains_all(self, ts: Sequence[tgt.Target]) -> bool:
        return all(self.contains(t) for t in ts)

    def set_target_returning_rep(self, t: tgt.Target,
                                 value: int) -> Optional[int]:
        """Set; returns the representative index if newly populated
        (reference witness.rs set_target_returning_rep semantics)."""
        rep = int(self.rep[self.index(t)])
        return rep if self._set_rep(rep, value, t) else None

    def set_target(self, t: tgt.Target, value: int):
        self.set_target_returning_rep(t, value)

    def set_dense(self, indices: np.ndarray, values: np.ndarray):
        """``set_target`` of each dense index to its value, in bulk: the
        same state, or a contradiction, as one at a time."""
        reps = self.rep[indices]
        old = self.filled[reps].astype(bool)
        bad = np.flatnonzero(old & (self.vals[reps] != values))
        self.vals[reps[~old]] = values[~old]
        self.filled[reps] = 1
        # two indices of one copy class with two values: the later write
        # won, so the earlier one differs now
        bad = np.concatenate([bad, np.flatnonzero(self.vals[reps] != values)])
        if len(bad):
            k = int(bad[0])
            raise AssertionError(
                f"contradictory assignment for dense index "
                f"{int(indices[k])}: {int(self.vals[reps[k]])} vs "
                f"{int(values[k])}")

    def _set_rep(self, rep: int, value: int, what) -> bool:
        """Set an empty slot (True), or check a filled one against
        ``value``."""
        if not self.filled[rep]:
            self.filled[rep] = 1
            self.vals[rep] = value
            return True
        assert int(self.vals[rep]) == value, \
            f"contradictory assignment for {what}: {int(self.vals[rep])} " \
            f"vs {value}"
        return False

    def full_witness(self) -> np.ndarray:
        """Dense (num_wires, degree) uint64 matrix; unset wires are zero
        (reference witness.rs:359: wire_values[column][row])."""
        # dense index = row * num_wires + column
        n = self.degree * self.num_wires
        dense = np.empty(n, np.uint64)
        engine.gather(self.vals, self.filled,
                      np.ascontiguousarray(self.rep[:n], dtype=np.int64),
                      dense)
        return dense.reshape(self.degree, self.num_wires).T.copy()
