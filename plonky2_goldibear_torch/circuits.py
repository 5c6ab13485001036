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


KECCAK_POW31_INPUT = 3


def keccak_pow31(builder):
    """The Keccak config's test circuit (the JAX package's
    ``tests/test_keccak_config.py:55-80``): x^31 by 30 ``mul``s, with x and
    x^31 public.  Built with ``hasher=keccak_hasher`` under
    ``keccak_pow31_config``.  Returns x; the witness sets x = 3
    (``KECCAK_POW31_INPUT``)."""
    x = builder.add_virtual_target()
    cur = x
    for _ in range(30):
        cur = builder.mul(cur, x)
    builder.register_public_input(x)
    builder.register_public_input(cur)
    return x


def keccak_pow31_config(config_cls):
    """``standard_recursion_config_gl()`` with 8 PoW bits, as the JAX test
    sets it; ``config_cls`` is the builder package's ``CircuitConfig``."""
    import dataclasses

    base = config_cls.standard_recursion_config_gl()
    return dataclasses.replace(base, fri_config=dataclasses.replace(
        base.fri_config, proof_of_work_bits=8))


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


def recursive_verifier(builder, inner_common, rv=None,
                       public_inputs: bool = True):
    """The recursive-verifier circuit of ``bench.py:bench_prove_recursive``
    (the reference's plonky2/benches/recursion.rs:154-202): targets of a
    proof of a circuit of ``inner_common`` and of its verifier data, the
    proof verified in the circuit, its public inputs made the outer
    circuit's unless ``public_inputs`` is off (the reference's regression
    outer, recursive_verifier.rs:895-955, has none).  ``rv`` is the
    recursive-verifier module of the builder's package (the port's by
    default).  Returns (proof targets, verifier-data targets); the witness
    sets them with ``rv.set_proof_with_pis_target`` and
    ``rv.set_verifier_data_target``."""
    if rv is None:
        from .recursion import recursive_verifier as rv
    proof_t = rv.add_virtual_proof_with_pis(builder, inner_common)
    vk_t = rv.add_virtual_verifier_data(
        builder, inner_common.config.fri_config.cap_height)
    rv.verify_proof(builder, proof_t, vk_t, inner_common)
    if public_inputs:
        builder.register_public_inputs(proof_t.public_inputs)
    return proof_t, vk_t


R0_HASH_SEED = 14
R0_HASH_LEN = 24


def r0_hash_inputs():
    """The 24 BabyBear values ``r0_hash`` hashes: seeded python
    ``random.Random(14)``, as the reference test's JAX twin draws them."""
    import random

    from .field.host import BABYBEAR

    rng = random.Random(R0_HASH_SEED)
    return [rng.randrange(BABYBEAR.p) for _ in range(R0_HASH_LEN)]


def r0_hash(builder, r0=None):
    """The circuit of the reference's poseidon2_risc0_babybear.rs:344-367
    (JAX ``tests/test_poseidon2_r0.py:73-97``), built under
    ``recursion_config_bb_wide()``: ``hash_or_noop`` of 24 targets with the
    width-24 Poseidon2 hasher ``r0`` (the hasher module of the builder's
    package; the port's by default), each digest element connected to the
    constant of the host hash of ``r0_hash_inputs()``.  Returns the 24
    input targets; the witness sets them to ``r0_hash_inputs()``."""
    if r0 is None:
        from .hash import poseidon2_r0_bb as r0
    ts = builder.add_virtual_targets(R0_HASH_LEN)
    digest = builder.hash_or_noop(ts, hasher=r0)
    for d, e in zip(digest, r0.hash_no_pad_host(r0_hash_inputs())):
        builder.connect(d, builder.constant(e))
    return ts


EXT_MIX_INPUTS = (3, 5, 7, 11, 13, 1, 0, 21)


def ext_mix(builder, gd, coset_gate) -> List:
    """A circuit over every extension-arithmetic op of the builder and
    every recursive-verifier gadget of ``gd`` (the package's
    ``plonk/gadgets.py``), with the 8 gates they place; ``coset_gate`` is
    the package's CosetInterpolationGate of 2^2 points at degree 8.
    Returns the 8 input targets; the witness sets them to
    ``EXT_MIX_INPUTS`` (the sixth and seventh are bits)."""
    b = builder
    ins = b.add_virtual_targets(8)
    a, c, e, f, g, bit1, bit0, wide = ins
    x = (a, c)
    y = b.add_virtual_extension_target()
    b.connect_extension(y, (e, f))
    # the extension arithmetic and its special cases
    s = b.add_extension(x, y)
    d = b.sub_extension(s, b.mul_extension(x, y))
    m = b.mul_add_extension(d, s, x)
    m = b.mul_sub_extension(m, y, d)
    m = b.add_extension(b.square_extension(m), b.cube_extension(x))
    m = b.mul_const_add_extension(9, m, b.mul_const_extension(5, y))
    m = b.add_const_extension(m, 17)
    m = b.scalar_mul_add_extension(g, m, b.scalar_mul_ext(a, y))
    m = b.scalar_mul_sub_extension(c, m, x)
    m = b.mul_extension_with_const(3, m, y)
    assert b.mul_extension(x, b.one_extension()) == x
    assert b.add_extension(b.zero_extension(), y) == y
    k = b.arithmetic_extension(2, 3, b.constant_extension((4, 5)),
                               b.constant_extension(6), b.one_extension())
    m = b.add_many_extension([m, k, x, y])
    p = b.mul_many_extension([m, x, y])
    pows = [b.exp_u64_extension(x, n) for n in (0, 1, 2, 3, 13)]
    q = b.div_extension(p, y)
    r = b.add_extension(b.inverse_extension(x), b.div_add_extension(m, s, q))
    b.connect_extension(b.mul_extension(q, y), p)
    # base-field many
    t = b.add_many([a, c, e, f, g])
    u = b.mul_many([a, c, e])
    # select, bits, exponents
    gd.assert_bool(b, bit1)
    sel = gd.select(b, bit1, t, u)
    sel_ext = gd.select_ext(b, bit0, x, y)
    bits = gd.split_le(b, wide, 6)
    low = gd.low_bits(b, u, 4, True, 64)
    summed = gd.le_sum(b, bits)
    b.connect(summed, wide)
    long_sum = gd.le_sum(b, low + bits + bits + low + bits)
    gd.range_check(b, t, 20)
    gd.assert_leading_zeros(b, t, 40)
    ex = gd.exp_from_bits_const_base(b, 7, bits[:4])
    ex2 = gd.exp_power_of_2(b, e, 4)
    ex3 = gd.exp_power_of_2_extension(b, y, 3)
    # random access
    items = [b.add_const(a, i) for i in range(16)]
    idx = gd.le_sum(b, bits[:4])
    ra = gd.random_access(b, idx, items)
    ra_ext = gd.random_access_extension(b, gd.le_sum(b, [bit1, bit0]),
                                        [x, y, s, d])
    # a coset interpolation at an extension point
    ci = gd.interpolate_coset(b, coset_gate, b.add_const(a, 1),
                              [x, y, s, d], m)
    # reductions: mul_add chains, then Reducing(Extension)Gate rows
    red = gd.ReducingFactorTarget(y)
    short = red.reduce([x, s, d], b)
    red_b = red.reduce_base([a, c, e], b)
    long_e = red.reduce(pows + [m, p, q, r, x, y, s, d] * 5, b)
    long_b = red.reduce_base(items * 4, b)
    shifted = red.shift(long_e, b)
    # a Merkle proof to a cap of two: leaves hashed in the circuit
    leaves = [[b.add_const(items[i], j) for j in range(5)] for i in range(4)]
    digests = [b.hash_or_noop(leaf) for leaf in leaves]
    zero = b.zero()
    width = b.inner_hasher.WIDTH
    cap = [b.permute(digests[i] + digests[i + 1]
                     + [zero] * (width - 8))[:4] for i in (0, 2)]
    gd.verify_merkle_proof_to_cap_with_cap_index(
        b, leaves[2], [bit0], b.one(), cap, [digests[3]])
    gd.verify_merkle_proof_to_cap_with_cap_index(
        b, leaves[1], [bit1], b.zero(), cap, [digests[0]])
    cap_entry = gd.random_access_hash(b, bit1, cap)
    b.register_public_inputs(
        [sel, ex, ex2, ra, long_sum] + list(sel_ext) + list(ra_ext)
        + list(ci) + list(short) + list(red_b) + list(long_b) + list(shifted)
        + list(ex3) + list(r) + cap_entry)
    return ins


ZK_FIB_STEPS = 30
ZK_FIB_INPUTS = (1, 2)


def zk_fib(builder) -> List:
    """The circuit of ``tests/test_zk.py``: two public inputs a, b, 30
    Fibonacci ``add`` steps, and the last as the third public input.  Built
    under ``standard_recursion_zk_config_gl()`` (the blinding rows make
    its degree: 2^8 at one FRI query round, 2^11 at six, 2^14 at 28).
    Returns [a, b]; the witness sets them to ``ZK_FIB_INPUTS``."""
    b = builder
    ia, ib = b.add_virtual_target(), b.add_virtual_target()
    b.register_public_input(ia)
    b.register_public_input(ib)
    x, y = ia, ib
    for _ in range(ZK_FIB_STEPS):
        x, y = y, b.add(x, y)
    b.register_public_input(x)
    return [ia, ib]


REGRESSION_NOOPS = 4000


def regression_inner(builder, noop_gate, poseidon_gate) -> None:
    """The inner circuit of the reference's GL recursive-verifier
    regression (plonky2/src/recursion/recursive_verifier.rs:666-697,
    ``dummy_proof(standard_recursion_zk_config_gl(), 4000)``): 4000
    ``noop_gate`` rows, ``poseidon_gate`` in the gate set without a row,
    and four public inputs, each the zero constant.  Under the zk config
    its blinding rows take it to 2^14 rows; the recursive verifier over it
    (``recursive_verifier``) is the circuit of
    ``tests/data/gl_regression_common.bin``.  The witness sets nothing."""
    for _ in range(REGRESSION_NOOPS):
        builder.add_gate(noop_gate, [])
    builder.add_gate_to_gate_set(poseidon_gate)
    zero = builder.zero()
    for _ in range(builder.spec.num_hash_out_elts):
        builder.register_public_input(zero)


# the first 16 entries of the Tip5 table (reference gadgets/lookup.rs:16)
TIP5_16 = (0, 7, 26, 63, 124, 215, 85, 254, 214, 228, 45, 185, 140, 173,
           33, 240)
TIP5_INPUTS = (1, 9, 14)


def tip5_lookups(builder) -> List:
    """The lookup circuit of ``tests/test_recursion_lookups.py`` (reference
    recursive_verifier.rs:341-413): the 16-entry Tip5 table, three lookups
    into it, the inputs then the outputs as public inputs.  Returns the
    three inputs; the witness sets them to ``TIP5_INPUTS``."""
    b = builder
    lut = b.add_lookup_table_from_table(list(range(16)), list(TIP5_16))
    ins = b.add_virtual_targets(3)
    outs = [b.add_lookup_from_index(t, lut) for t in ins]
    b.register_public_inputs(ins + outs)
    return ins


TWO_TABLE_INPUTS = (3, 7, 15, 0)


def two_table_fn(x: int) -> int:
    """The second table of ``two_tables``: 3x + 1 mod 256."""
    return (x * 3 + 1) % 256


def two_tables(builder) -> List:
    """The two-table circuit of ``tests/test_lookups.py``: Tip5-16 and
    ``two_table_fn`` over 0..15, four lookups alternating between them,
    inputs then outputs as public inputs.  Returns the four inputs; the
    witness sets them to ``TWO_TABLE_INPUTS``."""
    b = builder
    lut0 = b.add_lookup_table_from_table(list(range(16)), list(TIP5_16))
    lut1 = b.add_lookup_table_from_fn(two_table_fn, list(range(16)))
    ins = b.add_virtual_targets(4)
    outs = [b.add_lookup_from_index(t, lut)
            for t, lut in zip(ins, (lut0, lut1, lut0, lut1))]
    b.register_public_inputs(ins + outs)
    return ins


U16_ROTATION = 5
U16_LOOKUPS = 4500
U16_PUBLIC_OUTPUTS = 8


def u16_rotl(x: int) -> int:
    """The table of ``u16_table``: x rotated left by 5 bits as a u16."""
    return ((x << U16_ROTATION) | (x >> (16 - U16_ROTATION))) & 0xFFFF


def u16_inputs() -> List[int]:
    """The inputs the witness gives ``u16_table``'s lookups: spread over
    the whole table."""
    return [(i * 40503 + 12345) % 65536 for i in range(U16_LOOKUPS)]


def u16_table(builder) -> List:
    """One u16 table of all 2^16 inputs (``u16_rotl``), the size of the
    reference's lookup_test.rs ``test_big_lut``, and ``U16_LOOKUPS``
    lookups into it (4500: 113 LookupGate rows of 40 slots beside the
    table's 2521 LookupTableGate rows of 26, so 2^12 rows under
    ``standard_recursion_config_gl()``).  The first and last four outputs
    are the public inputs.  Returns the inputs; the witness sets them to
    ``u16_inputs()``."""
    b = builder
    lut = b.add_lookup_table_from_fn(u16_rotl, list(range(1 << 16)))
    ins = b.add_virtual_targets(U16_LOOKUPS)
    outs = [b.add_lookup_from_index(t, lut) for t in ins]
    half = U16_PUBLIC_OUTPUTS // 2
    b.register_public_inputs(outs[:half] + outs[-half:])
    return ins


FIB_INNER_STEPS = 50
FIB_INNER_INPUTS = (0, 1)


def fib_inner(builder) -> List:
    """The inner circuit of the JAX package's recursion tests
    (``tests/test_recursion.py:14-29`` ``build_inner``): Fibonacci by
    ``FIB_INNER_STEPS`` ``add``s from two public inputs, its end the third
    public input.  Returns the two inputs; the witness sets them to
    ``FIB_INNER_INPUTS``."""
    b = builder
    ia, ib = b.add_virtual_target(), b.add_virtual_target()
    b.register_public_inputs([ia, ib])
    x, y = ia, ib
    for _ in range(FIB_INNER_STEPS):
        x, y = y, b.add(x, y)
    b.register_public_input(x)
    return [ia, ib]


ADD_MANY_COUNTS = (23, 46, 100)
ADD_MANY_INPUTS = tuple((i * 0x9E3779B97F4A7C15 + 7) % 0xFFFFFFFF00000001
                        for i in range(max(ADD_MANY_COUNTS)))


def add_many_sums(builder) -> List:
    """Sums of the first 23, 46 and 100 of 100 targets by ``add_many``,
    the three sums public.  23 addends take one AddManyGate op; 46 and 100
    take two and four (and a short chunk of 8 by ``add``), then the sum of
    the chunk sums by ``add`` (the JAX package's ``plonk/builder.py:
    325-343``): seven ops, so the gate's third row is partly used.
    Goldilocks.  Returns the 100 targets; the witness sets them to
    ``ADD_MANY_INPUTS``."""
    xs = builder.add_virtual_targets(max(ADD_MANY_COUNTS))
    builder.register_public_inputs([builder.add_many(xs[:n])
                                    for n in ADD_MANY_COUNTS])
    return xs


def conditional_outer(builder, inner_common, cond, rv, gd, **dummy):
    """The outer circuit of the JAX package's
    ``tests/test_conditional_recursion.py:17-48``: a boolean condition,
    targets of a proof of a circuit of ``inner_common`` and of its verifier
    data, and ``cond.conditionally_verify_proof_or_dummy`` over them.
    ``cond``, ``rv`` and ``gd`` are the builder's package's
    ``recursion/conditional``, ``recursion/recursive_verifier`` and
    ``plonk/gadgets`` modules; ``dummy`` goes to the dummy proof's call
    (the port's ``device``, ``rng`` and ``timings``).  Returns
    (condition, proof targets, verifier-data targets)."""
    condition = builder.add_virtual_target()
    gd.assert_bool(builder, condition)
    proof_t = rv.add_virtual_proof_with_pis(builder, inner_common)
    vk_t = rv.add_virtual_verifier_data(
        builder, inner_common.config.fri_config.cap_height)
    cond.conditionally_verify_proof_or_dummy(builder, condition, proof_t,
                                             vk_t, inner_common, **dummy)
    return condition, proof_t, vk_t


CYCLIC_INITIAL_HASH = (0, 1, 2, 3)


def cyclic_counter(builder, common, cond, rv, **dummy):
    """The repeated-hash IVC counter of the JAX package's
    ``tests/test_cyclic_recursion.py:27-105`` (the reference's
    cyclic_recursion.rs:281-383).  Public inputs: the initial hash (4), the
    current hash, one Poseidon hash of the previous one (4), the counter,
    then the circuit's own verifier data.  Where the condition is 1 the
    circuit verifies a proof of itself and counts one more; where it is 0
    it verifies a dummy proof and starts from the initial hash at 0.
    ``common`` is ``cond.common_data_for_recursion``'s; its
    ``num_public_inputs`` is set here to the circuit's, as the JAX test
    sets it, and the circuit must build to it.  ``cond`` and ``rv`` are
    the builder's package's ``recursion/conditional`` and
    ``recursion/recursive_verifier``; ``dummy`` goes to the dummy proof's
    call.  Returns (condition, inner proof targets, verifier-data
    targets)."""
    b = builder
    one = b.one()
    initial_hash = b.add_virtual_targets(4)
    b.register_public_inputs(initial_hash)
    current_hash_in = b.add_virtual_targets(4)
    b.register_public_inputs(b.hash_n_to_hash_no_pad(current_hash_in))
    counter = b.add_virtual_target()
    b.register_public_input(counter)

    vk_t = cond.add_verifier_data_public_inputs(b)
    common.num_public_inputs = len(b.public_inputs)

    condition = b.add_virtual_target()
    b.assert_zero(b.mul(condition, b.sub(condition, one)))

    inner = rv.add_virtual_proof_with_pis(b, common)
    inner_pis = inner.public_inputs
    for t, u in zip(initial_hash, inner_pis[0:4]):
        b.connect(t, u)
    actual_in = cond.select_vec(b, condition, inner_pis[4:8], initial_hash)
    for t, u in zip(current_hash_in, actual_in):
        b.connect(t, u)
    b.connect(counter, b.mul_add(condition, inner_pis[8], condition))

    cond.conditionally_verify_cyclic_proof_or_dummy(b, condition, inner,
                                                    common, **dummy)
    return condition, inner, vk_t
