"""The four foundation gates, constraint side: Arithmetic, Constant,
PublicInput, Noop (reference plonky2/src/gates/{arithmetic_base.rs,
constant.rs, public_input.rs, noop.rs}).  ``id()`` strings are the
reference's Rust Debug formatting, as in the JAX package."""

from __future__ import annotations

import torch

from .base import Gate


class ArithmeticGate(Gate):
    """``output = const_0 * m0 * m1 + const_1 * addend`` ops; op i uses
    routed wires [4i, 4i + 4) (reference gates/arithmetic_base.rs:28-160)."""

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    def id(self):
        return f"ArithmeticGate {{ num_ops: {self.num_ops} }}"

    def num_constraints(self):
        return self.num_ops

    def eval_unfiltered_device(self, F, wires, constants, pi_hash):
        w = wires[:4 * self.num_ops].reshape(self.num_ops, 4, -1)
        m0, m1, addend, out = w.unbind(1)
        computed = F.add(F.mul(F.mul(m0, m1), constants[0]),
                         F.mul(addend, constants[1]))
        return F.sub(out, computed)


class ConstantGate(Gate):
    """Routes ``num_consts`` gate constants to wires
    (reference gates/constant.rs:22-120)."""

    def __init__(self, num_consts: int):
        self.num_consts = num_consts

    def id(self):
        return f"ConstantGate {{ num_consts: {self.num_consts} }}"

    def num_constraints(self):
        return self.num_consts

    def eval_unfiltered_device(self, F, wires, constants, pi_hash):
        k = self.num_consts
        return F.sub(constants[:k], wires[:k])


class PublicInputGate(Gate):
    """Pins wires 0..N to the public-input hash
    (reference gates/public_input.rs:23-100)."""

    def __init__(self, num_hash_out_elts: int):
        self.n = num_hash_out_elts

    def id(self):
        return f"PublicInputGate<{self.n}>"

    def num_constraints(self):
        return self.n

    def eval_unfiltered_device(self, F, wires, constants, pi_hash):
        return F.sub(wires[:self.n], torch.stack(list(pi_hash))[:, None])


class NoopGate(Gate):
    """Padding (reference gates/noop.rs)."""

    def id(self):
        return "NoopGate"

    def num_constraints(self):
        return 0

    def eval_unfiltered_device(self, F, wires, constants, pi_hash):
        return F.zeros((0, wires.shape[-1]), wires.device)
