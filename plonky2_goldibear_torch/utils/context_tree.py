"""Circuit-build gate-count profiler — the counterpart of the reference's
``ContextTree`` (plonky2/src/util/context_tree.rs:12,134; used from
circuit_builder.rs:719-725,1042-1058).

A tree of named scopes; each scope records the builder's gate count at entry
and exit, so ``print_gate_counts(min_delta)`` shows where circuit rows come
from (what dominates the size of a recursive verifier).  A copy
of the JAX package's ``utils/context_tree.py`` ``ContextTree``.
"""

from __future__ import annotations

from typing import List, Optional


class ContextTree:
    def __init__(self, name: str = "root", enter_count: int = 0):
        self.name = name
        self.enter_count = enter_count
        self.exit_count: Optional[int] = None
        self.children: List["ContextTree"] = []

    def _last_open(self) -> "ContextTree":
        node = self
        while node.children and node.children[-1].exit_count is None:
            node = node.children[-1]
        return node

    def push(self, name: str, count: int):
        self._last_open().children.append(ContextTree(name, count))

    def pop(self, count: int):
        node, parent = self, None
        while node.children and node.children[-1].exit_count is None:
            parent = node
            node = node.children[-1]
        assert node is not self, "pop without matching push"
        node.exit_count = count

    def delta(self, final_count: int) -> int:
        end = self.exit_count if self.exit_count is not None else final_count
        return end - self.enter_count

    def filter(self, final_count: int, min_delta: int) -> "ContextTree":
        """Prune subtrees contributing fewer than min_delta gates
        (reference context_tree.rs:60-82)."""
        kept = ContextTree(self.name, self.enter_count)
        kept.exit_count = self.exit_count
        kept.children = [c.filter(final_count, min_delta)
                         for c in self.children
                         if c.delta(final_count) >= min_delta]
        return kept

    def lines(self, final_count: int, depth: int = 0) -> List[str]:
        out = [f"{'  ' * depth}{self.delta(final_count)} gates to {self.name}"]
        for c in self.children:
            out.extend(c.lines(final_count, depth + 1))
        return out

