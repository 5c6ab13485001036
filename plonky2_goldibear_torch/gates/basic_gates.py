"""The four foundation gates: Arithmetic, Constant, PublicInput, Noop
(reference plonky2/src/gates/{arithmetic_base.rs, constant.rs,
public_input.rs, noop.rs}).  ``id()`` strings are the reference's Rust
Debug formatting, as in the JAX package."""

from __future__ import annotations

from ..iop import generator as gen
from ..iop import target as tgt
from .base import Gate


class ArithmeticGate(Gate):
    """``output = const_0 * m0 * m1 + const_1 * addend`` ops; op i uses
    routed wires [4i, 4i + 4) (reference gates/arithmetic_base.rs:28-160)."""

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    @classmethod
    def from_config(cls, config) -> "ArithmeticGate":
        return cls(config.num_routed_wires // 4)

    def id(self):
        return f"ArithmeticGate {{ num_ops: {self.num_ops} }}"

    @staticmethod
    def wires(i: int):
        """(multiplicand 0, multiplicand 1, addend, output) of op i."""
        return 4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3

    def num_wires(self):
        return 4 * self.num_ops

    def num_constants(self):
        return 2

    def degree(self):
        return 3

    def num_constraints(self):
        return self.num_ops

    def generators(self, row, local_constants, spec):
        c0, c1 = int(local_constants[0]), int(local_constants[1])
        return [_ArithmeticOpGenerator(row, c0, c1, i, spec.p)
                for i in range(self.num_ops)]

    def eval_unfiltered(self, A, vars):
        c0, c1 = vars.local_constants[0], vars.local_constants[1]
        out = []
        for i in range(self.num_ops):
            m0, m1, ad, o = (vars.local_wires[w] for w in self.wires(i))
            computed = A.add(A.mul(A.mul(m0, m1), c0), A.mul(ad, c1))
            out.append(A.sub(o, computed))
        return out


class _ArithmeticOpGenerator(gen.SimpleGenerator):
    """output = c0 * m0 * m1 + c1 * addend of one op."""

    def __init__(self, row, c0, c1, i, p):
        self.row, self.c0, self.c1, self.i, self.p = row, c0, c1, i, p

    def dependencies(self):
        w0, w1, wa, _ = ArithmeticGate.wires(self.i)
        return [tgt.wire(self.row, w0), tgt.wire(self.row, w1),
                tgt.wire(self.row, wa)]

    def run_once(self, witness, out):
        w0, w1, wa, wo = ArithmeticGate.wires(self.i)
        m0 = witness.get_target(tgt.wire(self.row, w0))
        m1 = witness.get_target(tgt.wire(self.row, w1))
        ad = witness.get_target(tgt.wire(self.row, wa))
        p = self.p
        out.append((tgt.wire(self.row, wo),
                    (self.c0 * m0 % p * m1 + self.c1 * ad) % p))


class ConstantGate(Gate):
    """Routes ``num_consts`` gate constants to wires
    (reference gates/constant.rs:22-120)."""

    def __init__(self, num_consts: int):
        self.num_consts = num_consts

    def id(self):
        return f"ConstantGate {{ num_consts: {self.num_consts} }}"

    def num_wires(self):
        return self.num_consts

    def num_constants(self):
        return self.num_consts

    def degree(self):
        return 1

    def num_constraints(self):
        return self.num_consts

    # no gate generators: the builder routes constants through the
    # ConstantGenerators it makes in add_gate (reference constant.rs:105)
    def extra_constant_wires(self):
        return [(i, i) for i in range(self.num_consts)]

    def eval_unfiltered(self, A, vars):
        return [A.sub(vars.local_constants[i], vars.local_wires[i])
                for i in range(self.num_consts)]


class PublicInputGate(Gate):
    """Pins wires 0..N to the public-input hash
    (reference gates/public_input.rs:23-100)."""

    def __init__(self, num_hash_out_elts: int):
        self.n = num_hash_out_elts

    def id(self):
        return f"PublicInputGate<{self.n}>"

    def num_wires(self):
        return self.n

    def num_constants(self):
        return 0

    def degree(self):
        return 1

    def num_constraints(self):
        return self.n

    def eval_unfiltered(self, A, vars):
        return [A.sub(vars.local_wires[i], vars.public_inputs_hash[i])
                for i in range(self.n)]


class NoopGate(Gate):
    """Padding (reference gates/noop.rs)."""

    def id(self):
        return "NoopGate"

    def num_wires(self):
        return 0

    def num_constants(self):
        return 0

    def degree(self):
        return 0

    def num_constraints(self):
        return 0

    def eval_unfiltered(self, A, vars):
        return []
