"""Gate framework (reference plonky2/src/gates/gate.rs:53-430).

The builder side of a gate (``num_wires``, ``num_constants``, ``degree``,
``generators``, ``extra_constant_wires``, ``complete_wires``; the JAX
package's ``gates/base.py:269-284``) places it in a circuit and fills its
wires.  On the constraint side a gate evaluates its constraints over every
point of the quotient domain at once (the reference's
``eval_unfiltered_base_batch``, batched over the whole domain):
``eval_unfiltered_device(F, wires, constants, pi_hash)``
takes the field module ``F`` (``gl`` or ``bb``), the stacked wires
(num_wires, m), the gate constants (k, m) and the public-input hash (4 or
8 scalar tensors) and returns a (num_constraints, m) tensor.

Selector filtering (reference gate.rs:391-430): filter = prod over the
gate's selector group of (i - s), times (UNUSED - s) when the circuit has
several selector polynomials.
"""

from __future__ import annotations

import torch

from ..field import gl

# Placeholder selector value for rows whose gate is in another group
# (reference gates/selectors.rs:14).
UNUSED_SELECTOR = (1 << 32) - 1


class Gate:
    """Base gate.  Subclasses define id() (the reference's Rust Debug
    string), num_wires(), num_constants(), degree(), num_constraints(),
    eval_unfiltered_device() and, where they fill wires, generators();
    ``num_ops`` is the slot capacity of a slot-packed gate."""

    num_ops = 1

    def id(self) -> str:
        raise NotImplementedError

    def num_wires(self) -> int:
        raise NotImplementedError

    def num_constants(self) -> int:
        raise NotImplementedError

    def degree(self) -> int:
        raise NotImplementedError

    def num_constraints(self) -> int:
        raise NotImplementedError

    def generators(self, row: int, local_constants, spec) -> list:
        """The witness generators of the gate at ``row``."""
        return []

    def extra_constant_wires(self) -> list:
        """(constant_index, wire_index) pairs the builder may use to route
        user constants (reference gate.rs:285)."""
        return []

    def complete_wires(self, builder, gate_idx: int, slot_idx: int) -> bool:
        """Fill a partly used slot gate's remaining ops; True if anything
        was completed (so its generators are kept).  By default zeros
        satisfy the constraints and nothing is done (reference
        gate.rs:78-85)."""
        return False

    def eval_unfiltered_device(self, F, wires: torch.Tensor,
                               constants: torch.Tensor,
                               pi_hash) -> torch.Tensor:
        raise NotImplementedError

    def __eq__(self, other):
        return isinstance(other, Gate) and self.id() == other.id()

    def __hash__(self):
        return hash(self.id())

    def __repr__(self):
        return self.id()


def compute_filter(row: int, group_range, s: torch.Tensor,
                   many_selector: bool, F=gl) -> torch.Tensor:
    """prod_{i in group, i != row} (i - s), times (UNUSED - s) when the
    circuit has several selectors (reference gate.rs:391-431)."""
    consts = [i for i in range(group_range[0], group_range[1]) if i != row]
    if many_selector:
        consts.append(UNUSED_SELECTOR % F.P)
    if not consts:
        return F.ones((), s.device)
    terms = F.sub(F.from_ints(consts, s.device)[:, None], s[None, :])
    return F.batch_prod(terms, axis=0)
