"""The lookup gates (reference plonky2/src/gates/lookup.rs,
lookup_table.rs; the JAX package's ``gates/lookup_gates.py``).

``LookupGate`` holds (input, output) looking pairs, two routed wires a
slot; ``LookupTableGate`` holds the table's entries and their
multiplicities, three routed wires a slot.  Neither adds a constraint of
its own: the logUp argument is in the lookup polynomials that
``plonk/vanishing.py:check_lookup_constraints`` checks.  A table is a tuple
of (input, output) u16 pairs; its Keccak-256 hash, printed as the
reference's ``Debug`` of ``[u8; 32]``, is part of each gate's id and so of
the circuit digest.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..iop import generator as gen
from ..iop import target as tgt
from ..utils.keccak import keccak256
from .base import Gate

LookupTable = Tuple[Tuple[int, int], ...]   # ((input, output), ...) u16s

_HASHES: Dict[LookupTable, bytes] = {}


def lut_hash(lut: LookupTable) -> bytes:
    """Keccak-256 of the entries as little-endian u16 pairs (cached: a
    2^16-entry table takes seconds on the host)."""
    h = _HASHES.get(lut)
    if h is None:
        h = _HASHES[lut] = keccak256(b"".join(
            inp.to_bytes(2, "little") + out.to_bytes(2, "little")
            for inp, out in lut))
    return h


def _hash_repr(h: bytes) -> str:
    return "[" + ", ".join(str(b) for b in h) + "]"


class _NoConstraints(Gate):
    def num_constants(self):
        return 0

    def degree(self):
        return 0

    def num_constraints(self):
        return 0

    def eval_unfiltered(self, A, vars):
        return []


class LookupGate(_NoConstraints):
    """Looking pairs (reference lookup.rs:33-70)."""

    def __init__(self, num_slots: int, lut: LookupTable):
        self.num_slots = self.num_ops = num_slots
        self.lut = tuple(tuple(e) for e in lut)
        self.lut_hash = lut_hash(self.lut)

    @classmethod
    def from_config(cls, config, lut):
        return cls(cls.num_slots_of(config), lut)

    @staticmethod
    def num_slots_of(config) -> int:
        return config.num_routed_wires // 2

    def id(self):
        return (f"LookupGate {{num_slots: {self.num_slots}, lut_hash: "
                f"{_hash_repr(self.lut_hash)}}}")

    @staticmethod
    def wire_ith_looking_inp(i):
        return 2 * i

    @staticmethod
    def wire_ith_looking_out(i):
        return 2 * i + 1

    def num_wires(self):
        return 2 * self.num_slots

    def generators(self, row, local_constants, spec):
        table = getattr(self, "_table", None)
        if table is None:
            # an input's first entry, as the reference's search finds it
            table = self._table = {}
            for inp, outv in self.lut:
                table.setdefault(inp, outv)
        return [_LookupGenerator(row, table, i)
                for i in range(self.num_slots)]


class _LookupGenerator(gen.SimpleGenerator):
    """The output of a looking pair from its input (reference
    lookup.rs:196-230)."""

    def __init__(self, row, table: Dict[int, int], slot):
        self.row, self.table, self.slot = row, table, slot

    def dependencies(self):
        return [tgt.wire(self.row, LookupGate.wire_ith_looking_inp(self.slot))]

    def run_once(self, witness, out):
        inp = witness.get_target(
            tgt.wire(self.row, LookupGate.wire_ith_looking_inp(self.slot)))
        if inp not in self.table:
            raise AssertionError("Incorrect input value provided")
        out.append((tgt.wire(self.row,
                             LookupGate.wire_ith_looking_out(self.slot)),
                    self.table[inp]))


class LookupTableGate(_NoConstraints):
    """Table entries and multiplicities (reference lookup_table.rs:37-85);
    ``last_lut_row`` is the table's first row in the circuit, its entries
    laid out upside down from the row above the following NoopGate."""

    def __init__(self, num_slots: int, lut: LookupTable, last_lut_row: int):
        self.num_slots = self.num_ops = num_slots
        self.lut = tuple(tuple(e) for e in lut)
        self.lut_hash = lut_hash(self.lut)
        self.last_lut_row = last_lut_row

    @staticmethod
    def num_slots_of(config) -> int:
        return config.num_routed_wires // 3

    def id(self):
        return (f"LookupTableGate {{num_slots: {self.num_slots}, lut_hash: "
                f"{_hash_repr(self.lut_hash)}, last_lut_row: "
                f"{self.last_lut_row}}}")

    @staticmethod
    def wire_ith_looked_inp(i):
        return 3 * i

    @staticmethod
    def wire_ith_looked_out(i):
        return 3 * i + 1

    @staticmethod
    def wire_ith_multiplicity(i):
        return 3 * i + 2

    def num_wires(self):
        return 3 * self.num_slots

    def generators(self, row, local_constants, spec):
        return [_LookupTableGenerator(row, self.lut, i, self.num_slots,
                                      self.last_lut_row)
                for i in range(self.num_slots)]


class _LookupTableGenerator(gen.SimpleGenerator):
    """A table entry's wires, zero past the table's end (reference
    lookup_table.rs:183-236)."""

    def __init__(self, row, lut, slot, num_slots, last_lut_row):
        self.row, self.lut, self.slot = row, lut, slot
        self.num_slots, self.last_lut_row = num_slots, last_lut_row

    def dependencies(self):
        return []

    def run_once(self, witness, out):
        first_row = self.last_lut_row + \
            -(-len(self.lut) // self.num_slots) - 1
        entry = (first_row - self.row) * self.num_slots + self.slot
        inp, outv = self.lut[entry] if entry < len(self.lut) else (0, 0)
        out.append((tgt.wire(self.row,
                             LookupTableGate.wire_ith_looked_inp(self.slot)),
                    inp))
        out.append((tgt.wire(self.row,
                             LookupTableGate.wire_ith_looked_out(self.slot)),
                    outv))
