"""The circuits the port's fixtures hold, written once against the builder
API that the port's ``plonk/builder.py:CircuitBuilder`` shares with the JAX
package's, so that the fixture writer (JAX) and the port's tests and
``chip_smoke.py`` build the same circuit.

Each function adds its circuit to a fresh builder and returns the targets
that a witness sets; the caller builds.
"""

from __future__ import annotations

from typing import List


def arith_chain(builder, degree_bits: int):
    """The ArithmeticGate chain of ``bench.py:_build_arith_chain``: one
    public input x, a chain of x*x + x ops filling 2^degree_bits rows less a
    few for the public-input hash, constants and padding, and the chain's
    end as the second public input.  Returns x."""
    config = builder.config
    x = builder.add_virtual_target()
    builder.register_public_input(x)
    cur = x
    ops_per_gate = config.num_routed_wires // 4
    for _ in range(((1 << degree_bits) - 8) * ops_per_gate):
        cur = builder.arithmetic(1, 1, cur, cur, cur)
    builder.register_public_input(cur)
    return x


MIX_FIB_STEPS = 30
MIX_MUL_STEPS = 12


def builder_mix(builder) -> List:
    """A circuit over every base-field gadget of the builder: Fibonacci by
    ``add`` and a ``mul`` chain; ``sub``, ``mul_add``, ``mul_sub``,
    ``square``, ``cube``, ``mul_const`` and ``add_const``; six distinct
    constants (more than one ConstantGate); the special case ``mul(x,
    one())``, which returns x; ``connect`` and ``assert_one``; 12
    public inputs (two absorbs of the Goldilocks sponge, the second of a
    short chunk for BabyBear's rate 8); and a hash of 10 targets in the
    circuit.  Returns the two inputs [a, b]; the witness sets a = 3, b = 5
    (``MIX_INPUTS``)."""
    b = builder
    a, c = b.add_virtual_target(), b.add_virtual_target()
    # Fibonacci by add
    x, y = a, c
    for _ in range(MIX_FIB_STEPS):
        x, y = y, b.add(x, y)
    # a mul chain
    m = a
    for _ in range(MIX_MUL_STEPS):
        m = b.mul(m, c)
    assert b.mul(m, b.one()) == m
    s = b.sub(y, m)
    t = b.mul_add(s, a, c)
    u = b.mul_sub(t, c, a)
    v = b.add(b.square(u), b.cube(a))
    w = b.add_const(b.mul_const(7, v), 11)
    z = b.add(b.mul_const(13, w), b.add_const(x, 1 << 20))
    # a copy constraint between two ways to a + 2, and a - 2 = 1 (a = 3)
    two = b.add_const(a, 2)
    b.connect(two, b.sub(b.add_const(a, 4), b.two()))
    b.assert_one(b.sub(a, b.two()))
    digest = b.hash_n_to_hash_no_pad([a, c, x, y, m, s, t, u, v, w])
    b.register_public_inputs([a, c, x, y, m, s, t, u, v, w,
                              b.add(z, digest[0]), two])
    return [a, c]


MIX_INPUTS = (3, 5)
