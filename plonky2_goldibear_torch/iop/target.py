"""Wire / virtual targets (reference plonky2/src/iop/target.rs:24-73,
iop/wire.rs).

A target is a hashable tuple — ("w", row, column) for a concrete wire, or
("v", index) for a virtual (routing-only) target.  Tuples keep the host-side
circuit builder light; the dense index layout matches the reference
(`target.rs:55-59`): wires first in row-major order, then virtual targets.
A copy of the JAX package's ``iop/target.py``.
"""

from __future__ import annotations

from typing import Tuple

Target = Tuple  # ("w", row, column) | ("v", index)


def wire(row: int, column: int) -> Target:
    return ("w", row, column)


def virtual_target(index: int) -> Target:
    return ("v", index)


def is_wire(t: Target) -> bool:
    return t[0] == "w"


def is_routable(t: Target, num_routed_wires: int) -> bool:
    """Reference target.rs:44-52: virtual targets are routable; wires only if
    their column is routed."""
    if t[0] == "v":
        return True
    return t[2] < num_routed_wires


def target_index(t: Target, num_wires: int, degree: int) -> int:
    """Dense index (reference target.rs:55-59)."""
    if t[0] == "w":
        return t[1] * num_wires + t[2]
    return degree * num_wires + t[1]
