"""The port's native witness replay (``plonky2_goldibear_torch/native/``,
``csrc/witgen.c``) on the CPU, exact (no tolerance: values, filled bits,
error words, wire matrices, rng states and proofs compared with equality).

(a) The VM against the JAX package's VM (``plonky2_goldibear_tpu/native``)
    on numpy-seeded random instruction streams over every opcode, at both
    primes, and on a stream for each error; the gather against numpy.
(b) Each lowered generator class, one gate row at a time: the schedule
    recorded from the fixpoint and replayed on the same presets gives the
    fixpoint's representative values, filled bits and rng state, at D = 2
    and D = 4.
(c) Circuits built by the port: the first witness generation records, the
    second replays; both equal, the rng state too, ``n_native > 0``, and
    only the classes of ``lower.PYTHON_GENERATORS`` (or a lookup whose
    table is not indexed by its input) in Python segments.  The recursive
    outers over the 2^6 chains of both fields, replayed, against the JAX
    witnesses ``data/recursive_{gl,bb}_2e6inner.npz``; the 2^6 chain's
    proof and retry and the ``zk_fib_1q`` proof from a replayed witness
    against the stored JAX proofs.
(d) Bookkeeping (a new set of preset targets records anew; a contradiction
    under replay names its generator), coverage of every generator class,
    and the build: no working C compiler, no library, an error.

Run: ``python -m pytest tests/test_torch_witgen_native.py -q``.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from plonky2_goldibear_torch import circuits  # noqa: E402
from plonky2_goldibear_torch.field import host  # noqa: E402
from plonky2_goldibear_torch.iop import generator as gen  # noqa: E402
from plonky2_goldibear_torch.iop.generator import NonRandomRng  # noqa: E402
from plonky2_goldibear_torch.iop.witness import PartialWitness  # noqa: E402
from plonky2_goldibear_torch.native import engine, lower  # noqa: E402
from plonky2_goldibear_torch.native.schedule import \
    compile_schedule  # noqa: E402
from plonky2_goldibear_torch.ops import _build  # noqa: E402
from plonky2_goldibear_torch.plonk import builder as builder_mod  # noqa: E402
from plonky2_goldibear_torch.plonk import gadgets, prover  # noqa: E402
from plonky2_goldibear_torch.plonk import serialization as ser  # noqa: E402
from plonky2_goldibear_torch.plonk.builder import CircuitBuilder  # noqa: E402
from plonky2_goldibear_torch.plonk.circuit_data import (  # noqa: E402
    DATA_DIR, fixture_path, read_fixture)
from plonky2_goldibear_torch.plonk.config import CircuitConfig  # noqa: E402
from plonky2_goldibear_torch.plonk.proof import (  # noqa: E402
    PROOF_PHASES, flatten_proof)
from plonky2_goldibear_torch.recursion import \
    recursive_verifier as rv  # noqa: E402

torch.set_num_threads(1)
GL, BB = host.GOLDILOCKS, host.BABYBEAR
SPECS = {"goldilocks": GL, "babybear": BB}
PRIMES = [pytest.param(GL.p, id="goldilocks"),
          pytest.param(BB.p, id="babybear")]


def config_of(field):
    return (CircuitConfig.standard_recursion_config_gl() if field ==
            "goldilocks" else CircuitConfig.standard_recursion_config_bb())


def read_bin(name: str) -> bytes:
    with open(os.path.join(DATA_DIR, name), "rb") as f:
        return f.read()


# --------------------------------------------------------------------------
# (a) the VM against the JAX VM
# --------------------------------------------------------------------------

(CONST, COPY, ADD, SUB, MUL, MULC, ADDC, RSUBC, MAC, MACI, INV, POW7, SELECT,
 BIT, SPLITR, SHRM, ASHR0, ABOOL, LUTMAP) = range(19)


def _run_jax(p, code, pool, vals, filled, num_reps) -> int:
    from plonky2_goldibear_tpu.native import engine as je

    u64 = ctypes.POINTER(ctypes.c_uint64)
    return int(je.LIB.witgen_run(
        ctypes.c_uint64(p), je._ptr(code, ctypes.c_uint64),
        ctypes.c_uint64(len(code) // 5), je._ptr(pool, ctypes.c_uint64),
        vals.ctypes.data_as(u64),
        filled.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(num_reps)))


def _both(p, code, pool, vals, filled, num_reps):
    """Run the stream through both VMs on copies; (return words, values,
    filled bits) of each."""
    out = []
    for run in (engine.run_raw, _run_jax):
        v, f = vals.copy(), filled.copy()
        rc = run(p, np.asarray(code, np.uint64), np.asarray(pool, np.uint64),
                 v, f, num_reps)
        out.append((rc, v, f))
    return out


def _assert_both_equal(p, code, pool, vals, filled, num_reps):
    (rc, v, f), (jrc, jv, jf) = _both(p, code, pool, vals, filled, num_reps)
    assert rc == jrc
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    return rc, v, f


class _Stream:
    """A random stream over R representatives (the first half filled) and
    T temporaries."""

    def __init__(self, rng, p, num_reps=64, num_temps=512):
        self.rng, self.p, self.R = rng, p, num_reps
        self.code, self.pool = [], []
        self.vals = np.zeros(num_reps + num_temps, np.uint64)
        self.filled = np.zeros(num_reps, np.uint8)
        half = num_reps // 2
        self.vals[:half] = self.field(half)
        self.filled[:half] = 1
        self.vals[num_reps:] = self.field(num_temps)
        self.free = list(range(half, num_reps))     # unwritten reps
        self.next_temp = num_reps

    def field(self, n):
        return np.array([int(x) % self.p for x in self.rng.integers(
            0, 1 << 63, size=n, dtype=np.int64) * 2 + self.rng.integers(
            0, 2, size=n)], dtype=np.uint64)

    def imm(self):
        return int(self.field(1)[0])

    def src(self):
        return int(self.rng.integers(0, len(self.vals)))

    def dst(self):
        """A temporary, or now and then a representative not yet
        written."""
        if self.free and self.rng.random() < 0.2:
            return self.free.pop(int(self.rng.integers(0, len(self.free))))
        t = self.next_temp
        self.next_temp = self.R + (t + 1 - self.R) % (len(self.vals) - self.R)
        return t

    def emit(self, *w):
        self.code.extend(list(w) + [0] * (5 - len(w)))

    def const(self, v):
        d = self.dst()
        self.emit(CONST, d, v)
        return d

    def random_op(self):
        op = int(self.rng.integers(0, 19))
        s, r = self.src, self.rng
        if op == CONST:
            self.emit(CONST, self.dst(), self.imm())
        elif op in (COPY, POW7):
            self.emit(op, self.dst(), s())
        elif op == INV:
            # a slot may hold 0 by now (a BIT into it): invert a constant
            self.emit(op, self.dst(),
                      self.const(1 + self.imm() % (self.p - 1)))
        elif op in (ADD, SUB, MUL):
            self.emit(op, self.dst(), s(), s())
        elif op in (MULC, ADDC, RSUBC):
            self.emit(op, self.dst(), s(), self.imm())
        elif op == MAC:
            self.emit(op, self.dst(), s(), s(), s())
        elif op == MACI:
            self.emit(op, self.dst(), s(), s(), self.imm())
        elif op == SELECT:
            n = int(r.integers(1, 9))
            off = len(self.pool)
            self.pool.extend(s() for _ in range(n))
            self.emit(SELECT, self.dst(), self.const(int(r.integers(0, n))),
                      off, n)
        elif op in (BIT, SHRM):
            self.emit(op, self.dst(), s(), int(r.integers(0, 70)),
                      1 if op == BIT else int(r.integers(0, 1 << 62)))
        elif op == SPLITR:
            n, base = int(r.integers(1, 6)), int(r.integers(2, 17))
            off = len(self.pool)
            self.pool.extend(self.dst() for _ in range(n))
            x = self.const(int(r.integers(0, base ** n)))
            self.emit(SPLITR, n, x, off, base)
        elif op == ASHR0:
            k = int(r.integers(0, 70))
            self.emit(ASHR0, 0, self.const(int(r.integers(0, 1 << min(k, 62))
                                               )), k)
        elif op == ABOOL:
            self.emit(ABOOL, 0, self.const(int(r.integers(0, 2))))
        else:
            n = int(r.integers(1, 17))
            off = len(self.pool)
            self.pool.extend([n] + [self.imm() for _ in range(n)])
            self.emit(LUTMAP, self.dst(), self.const(int(r.integers(0, n))),
                      off)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("seed", range(6))
def test_random_streams_match_the_jax_vm(p, seed):
    """Every opcode on valid operands: no error, and the same values and
    filled bits."""
    st = _Stream(np.random.default_rng(seed), p)
    for _ in range(3000):
        st.random_op()
    ops = {st.code[i] for i in range(0, len(st.code), 5)}
    assert ops == set(range(19))
    rc, v, f = _assert_both_equal(p, st.code, st.pool, st.vals, st.filled,
                                  st.R)
    assert rc == 0
    assert f.sum() > st.filled.sum()


def _fault_streams(p):
    """(name, expected error code, stream builder) for each error."""
    def contradiction(st):
        st.emit(CONST, 0, (int(st.vals[0]) + 1) % p)

    def inv_zero(st):
        st.emit(INV, st.dst(), st.const(0))

    def select_oob(st):
        off = len(st.pool)
        st.pool.extend([st.R, st.R + 1])
        st.emit(SELECT, st.dst(), st.const(2), off, 2)

    def split_leftover(st):
        off = len(st.pool)
        st.pool.extend([st.dst(), st.dst()])
        st.emit(SPLITR, 2, st.const(9), off, 3)

    def split_contradiction(st):
        off = len(st.pool)
        st.pool.extend([0])
        st.emit(SPLITR, 1, st.const((int(st.vals[0]) + 1) % 2), off, 2)
        st.vals[0] = 0

    def shr_nonzero(st):
        st.emit(ASHR0, 0, st.const(1 << 20), 20)

    def bad_opcode(st):
        st.emit(19, st.dst(), 0)

    def not_bool(st):
        st.emit(ABOOL, 0, st.const(2))

    def lut_miss(st):
        off = len(st.pool)
        st.pool.extend([3, 7, 8, 9])
        st.emit(LUTMAP, st.dst(), st.const(3), off)

    return [("contradiction", 1, contradiction), ("inv_zero", 2, inv_zero),
            ("select_oob", 3, select_oob),
            ("split_leftover", 4, split_leftover),
            ("split_contradiction", 1, split_contradiction),
            ("shr_nonzero", 5, shr_nonzero), ("bad_opcode", 6, bad_opcode),
            ("not_bool", 7, not_bool), ("lut_miss", 8, lut_miss)]


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("case", range(9), ids=[
    c[0] for c in _fault_streams(GL.p)])
def test_each_error_word_matches_the_jax_vm(p, case):
    """Valid random instructions, then the faulty one, then more: both VMs
    stop at it with the same word and leave the same values."""
    name, code, make = _fault_streams(p)[case]
    st = _Stream(np.random.default_rng(100 + case), p)
    for _ in range(200):
        st.random_op()
    make(st)
    at = len(st.code) // 5 - 1
    for _ in range(50):
        st.random_op()
    rc, _, _ = _assert_both_equal(p, st.code, st.pool, st.vals, st.filled,
                                  st.R)
    assert rc == (code << 48) | at, name
    with pytest.raises(engine.WitgenError) as e:
        engine.run(p, np.asarray(st.code, np.uint64),
                   np.asarray(st.pool, np.uint64), st.vals.copy(),
                   st.filled.copy(), st.R)
    assert (e.value.code, e.value.instr) == (code, at)
    assert isinstance(e.value, AssertionError)


@pytest.mark.parametrize("p", PRIMES)
def test_arithmetic_is_exact_at_the_edges(p):
    """Products and sums at the top of the field against python ints."""
    xs = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, 1 << 32, (1 << 32) - 1,
          p - (1 << 32)]
    xs = [x % p for x in xs]
    vals = np.array(xs + [0] * (4 * len(xs) ** 2), np.uint64)
    code, want, d = [], [], len(xs)
    for i, a in enumerate(xs):
        for j, b in enumerate(xs):
            code += [MUL, d, i, j, 0, ADD, d + 1, i, j, 0, SUB, d + 2, i, j, 0,
                     MACI, d + 3, i, j, b]
            want += [a * b % p, (a + b) % p, (a - b) % p, (a * b + b) % p]
            d += 4
    rc, v, _ = _assert_both_equal(p, code, [], vals, np.zeros(0, np.uint8),
                                  0)
    assert rc == 0
    assert [int(x) for x in v[len(xs):]] == want


def test_gather_equals_numpy():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 1 << 63, size=1000, dtype=np.int64).astype(
        np.uint64)
    filled = (rng.random(700) < 0.6).astype(np.uint8)
    rep = rng.integers(0, 700, size=5000, dtype=np.int64)
    out = np.empty(5000, np.uint64)
    engine.gather(vals, filled, rep, out)
    np.testing.assert_array_equal(
        out, np.where(filled[rep].astype(bool), vals[rep], np.uint64(0)))


# --------------------------------------------------------------------------
# (b) each lowered generator class, one gate row
# --------------------------------------------------------------------------


def _rng_state(rng):
    if isinstance(rng, NonRandomRng):
        return ("counter", rng.counter)
    return rng.bit_generator.state


def _prover_data(generators, rep_map, num_wires, degree):
    by_watches = {}
    for i, g in enumerate(generators):
        for t in g.watch_list():
            w = by_watches.setdefault(int(rep_map[
                gen.tgt.target_index(t, num_wires, degree)]), [])
            if i not in w[-1:]:
                w.append(i)
    return SimpleNamespace(generators=generators,
                           generator_indices_by_watches=by_watches,
                           representative_map=rep_map, witgen_schedules={})


def _assert_replay_equal(pw, pd, common, make_rng):
    """Fixpoint and recorded replay of ``pw``: the same representative
    values, filled bits, dense witness and rng state.  Returns the
    schedule."""
    rng1, rng2 = make_rng(), make_rng()
    w1, order = gen._fixpoint_generate(pw, pd, common, rng1)
    sched = compile_schedule(order, pd, common)
    w2 = sched.replay(pw, pd, common, rng2)
    n = sched.num_reps
    np.testing.assert_array_equal(w1.filled, w2.filled)
    np.testing.assert_array_equal(w1.vals[:n], w2.vals[:n])
    np.testing.assert_array_equal(w1.full_witness(), w2.full_witness())
    assert _rng_state(rng1) == _rng_state(rng2)
    return sched


def _gate_cases():
    """(id, spec, gate, local constants, value rule)."""
    from plonky2_goldibear_torch.gates.access_gates import (
        BaseSumGate, ExponentiationGate, RandomAccessGate)
    from plonky2_goldibear_torch.gates.basic_gates import ArithmeticGate
    from plonky2_goldibear_torch.gates.coset_interpolation import \
        CosetInterpolationGate
    from plonky2_goldibear_torch.gates.extension_gates import (
        ArithmeticExtensionGate, MulExtensionGate)
    from plonky2_goldibear_torch.gates.lookup_gates import LookupGate
    from plonky2_goldibear_torch.gates.misc_gates import (
        AddManyGate, ApplyMat4Gate, Poseidon2InternalPermutationGate)
    from plonky2_goldibear_torch.gates.poseidon import PoseidonGate
    from plonky2_goldibear_torch.gates.poseidon2_bb_gate import \
        Poseidon2BabyBearGate
    from plonky2_goldibear_torch.gates.poseidon2_r0_bb_gate import \
        Poseidon2R0BabyBearGate
    from plonky2_goldibear_torch.gates.poseidon_mds import PoseidonMdsGate
    from plonky2_goldibear_torch.gates.reducing import (
        ReducingExtensionGate, ReducingGate)

    tip5 = tuple((i, v) for i, v in enumerate(circuits.TIP5_16))
    sparse = ((5, 1), (7, 2), (9, 3), (5, 4))
    cases = []
    for field, spec in SPECS.items():
        D = spec.ext_degree
        cases += [
            (f"arithmetic-{field}", spec, ArithmeticGate(20), [3, 5], None),
            (f"add_many-{field}", spec, AddManyGate(23, 3), [], None),
            (f"base_sum-{field}", spec,
             BaseSumGate(63 if field == "goldilocks" else 30, 2), [],
             "sum"),
            (f"base_sum_b4-{field}", spec, BaseSumGate(8, 4), [], "sum"),
            (f"exponentiation-{field}", spec, ExponentiationGate(15, spec),
             [], "bits"),
            (f"random_access-{field}", spec, RandomAccessGate(4, 2, 0), [],
             "index"),
            (f"lookup_tip5-{field}", spec, LookupGate(8, tip5), [], "lut"),
            (f"lookup_sparse-{field}", spec, LookupGate(8, sparse), [],
             "lut"),
            (f"arithmetic_ext_d{D}-{field}", spec,
             ArithmeticExtensionGate(4, D), [7, 11], None),
            (f"mul_ext_d{D}-{field}", spec, MulExtensionGate(4, D), [13],
             None),
            (f"reducing_d{D}-{field}", spec, ReducingGate(12, D), [], None),
            (f"reducing_ext_d{D}-{field}", spec,
             ReducingExtensionGate(6, D), [], None),
            (f"interpolation_d{D}-{field}", spec,
             CosetInterpolationGate.with_max_degree(
                 4 if field == "babybear" else 2, 8, spec), [], None),
        ]
    cases += [
        ("poseidon_gl-swap0", GL, PoseidonGate(), [], 0),
        ("poseidon_gl-swap1", GL, PoseidonGate(), [], 1),
        ("poseidon_mds-goldilocks", GL, PoseidonMdsGate(), [], None),
        ("poseidon2_bb-swap0", BB, Poseidon2BabyBearGate(2), [], 0),
        ("poseidon2_bb-swap1", BB, Poseidon2BabyBearGate(2), [], 1),
        ("poseidon2_r0-swap0", BB, Poseidon2R0BabyBearGate(1), [], 0),
        ("poseidon2_r0-swap1", BB, Poseidon2R0BabyBearGate(1), [], 1),
        ("apply_mat4_d4", BB, ApplyMat4Gate(2, 4), [], None),
        ("internal_perm_d4", BB, Poseidon2InternalPermutationGate(4), [],
         None),
    ]
    return cases


GATE_CASES = _gate_cases()


def _preset_values(gate, gens, rule, spec, rng):
    """Column -> value of the gate row's inputs, under the case's rule."""
    deps = sorted({t[2] for g in gens for t in g.dependencies()})
    vals = {c: int(rng.integers(0, spec.p, dtype=np.uint64)) for c in deps}
    name = type(gate).__name__
    if isinstance(rule, int) and not isinstance(rule, bool):   # the swap
        if name == "PoseidonGate":
            vals[gate.WIRE_SWAP] = rule
        else:
            for op in range(gate.num_ops):
                vals[gate.wire_swap(op)] = rule
    elif rule == "sum":
        top = min(gate.base ** gate.num_limbs, spec.p)
        vals[gate.WIRE_SUM] = int(rng.integers(0, top, dtype=np.uint64))
    elif rule == "bits":
        for i in range(gate.num_power_bits):
            vals[gate.wire_power_bit(i)] = int(rng.integers(0, 2))
    elif rule == "index":
        for c in range(gate.num_copies):
            vals[gate.wire_access_index(c)] = int(
                rng.integers(0, gate.vec_size))
    elif rule == "lut":
        keys = sorted({k for k, _ in gate.lut})
        for g in gens:
            (dep,) = g.dependencies()
            vals[dep[2]] = keys[int(rng.integers(0, len(keys)))]
    return vals


@pytest.mark.parametrize("case", range(len(GATE_CASES)),
                         ids=[c[0] for c in GATE_CASES])
def test_each_generator_class_replays_as_its_fixpoint(case):
    name, spec, gate, consts, rule = GATE_CASES[case]
    nw = gate.num_wires()
    gens = gate.generators(0, consts + [0] * 4, spec)
    rep = np.arange(2 * nw, dtype=np.int64)
    pd = _prover_data(gens, rep, nw, 2)
    common = SimpleNamespace(config=SimpleNamespace(num_wires=nw), degree=2,
                             spec=spec)
    pw = PartialWitness()
    for col, v in _preset_values(gate, gens, rule,
                                 spec, np.random.default_rng(case)).items():
        pw.set_target(("w", 0, col), v)
    sched = _assert_replay_equal(pw, pd, common, lambda: NonRandomRng(1))
    py = sched.python_classes(gens)
    if name.startswith(("poseidon_mds", "lookup_sparse")):
        assert sched.n_native == 0 and len(py) == 1
    else:
        assert sched.n_native == len(gens) and not py
        assert sched.n_instr > 0


# --------------------------------------------------------------------------
# (c) circuits: the first witness generation records, the second replays
# --------------------------------------------------------------------------


def _record_and_replay(data, pw, make_rng):
    """Witness ``pw`` twice through ``generate_partial_witness``: the
    first records (fixpoint), the second replays.  Both equal, the rng
    state after each too.  Returns (schedule, replayed witness)."""
    po, common = data.prover_only, data.common
    assert not po.witgen_schedules
    rng1, rng2 = make_rng(), make_rng()
    w1 = gen.generate_partial_witness(pw, po, common, rng1)
    (sched,) = po.witgen_schedules.values()
    w2 = gen.generate_partial_witness(pw, po, common, rng2)
    n = sched.num_reps
    np.testing.assert_array_equal(w1.filled, w2.filled)
    np.testing.assert_array_equal(w1.vals[:n], w2.vals[:n])
    np.testing.assert_array_equal(w1.full_witness(), w2.full_witness())
    assert w1.get_targets(po.public_inputs) == \
        w2.get_targets(po.public_inputs)
    assert _rng_state(rng1) == _rng_state(rng2)
    assert sched.n_native > 0
    for cls in sched.python_classes(po.generators):
        assert cls in lower.PYTHON_GENERATORS or \
            cls.__name__ == "_LookupGenerator", cls
    return sched, w2


def _build_circuit(field, make, config=None):
    b = CircuitBuilder(config or config_of(field), SPECS[field])
    inputs = make(b)
    return b.build(device="cpu"), inputs


def _gadget_chain(b):
    """The JAX package's native-witness case: arithmetic, bit split and
    sum, an extension division and a random access."""
    x = b.add_virtual_target()
    b.register_public_input(x)
    cur = x
    for _ in range(300):
        cur = b.arithmetic(1, 1, cur, cur, cur)
    bits = gadgets.split_le(b, cur, 64)
    s = gadgets.le_sum(b, bits[:10])
    cur2 = b.mul(s, cur)
    e = b.constant_extension((5, 7) + (0,) * (b.spec.ext_degree - 2))
    e2 = b.mul_extension(e, e)
    b.div_extension(e2, e)
    ra = gadgets.random_access(b, b.constant(2),
                               [b.constant(i * 3 + 1) for i in range(4)])
    b.register_public_input(b.mul(ra, cur2))
    return [(x, 3)]


def _poseidon_hash(b):
    x = b.add_virtual_target()
    b.register_public_input(x)
    h = b.hash_n_to_hash_no_pad([x, x, b.one()])
    b.register_public_inputs(list(b.hash_n_to_hash_no_pad(list(h) + [x])))
    cur = x
    for _ in range(50):
        cur = b.arithmetic(1, 1, cur, cur, cur)
    return [(x, 12345)]


def _exponentiation(b):
    x = b.add_virtual_target()
    b.register_public_input(x)
    b.register_public_input(gadgets.exp_u64(b, x, 0x12345))
    return [(x, 3)]


def _sparse_table(b):
    """A table whose inputs are not 0..n-1: its lookups stay Python."""
    lut = b.add_lookup_table_from_pairs([(5, 1), (7, 2), (9, 3)])
    ins = b.add_virtual_targets(2)
    b.register_public_inputs(ins + [b.add_lookup_from_index(t, lut)
                                    for t in ins])
    return list(zip(ins, (7, 9)))


def _inputs(make, values):
    def f(b):
        return list(zip(make(b), values))
    return f


def _ext_mix(b):
    from plonky2_goldibear_torch.gates.coset_interpolation import \
        CosetInterpolationGate
    return list(zip(circuits.ext_mix(
        b, gadgets, CosetInterpolationGate.with_max_degree(2, 8, b.spec)),
        circuits.EXT_MIX_INPUTS))


def _wide_config():
    return CircuitConfig.recursion_config_bb_wide()


CIRCUIT_CASES = {
    "gadget_chain-goldilocks": ("goldilocks", _gadget_chain, None),
    "gadget_chain-babybear": ("babybear", _gadget_chain, None),
    "poseidon_hash-goldilocks": ("goldilocks", _poseidon_hash, None),
    "poseidon2_hash-babybear": ("babybear", _poseidon_hash, None),
    "exponentiation-goldilocks": ("goldilocks", _exponentiation, None),
    "add_many_sums": ("goldilocks", _inputs(circuits.add_many_sums,
                                            circuits.ADD_MANY_INPUTS), None),
    "r0_hash": ("babybear", _inputs(circuits.r0_hash,
                                    circuits.r0_hash_inputs()),
                _wide_config),
    "tip5_lookups": ("goldilocks", _inputs(circuits.tip5_lookups,
                                           circuits.TIP5_INPUTS), None),
    "two_tables-babybear": ("babybear", _inputs(circuits.two_tables,
                                                circuits.TWO_TABLE_INPUTS),
                            None),
    "sparse_table": ("goldilocks", _sparse_table, None),
    "ext_mix": ("goldilocks", _ext_mix, None),
}


@pytest.mark.parametrize("name", list(CIRCUIT_CASES))
def test_circuit_replays_as_its_fixpoint(name):
    field, make, cfg = CIRCUIT_CASES[name]
    data, inputs = _build_circuit(field, make, cfg() if cfg else None)
    pw = PartialWitness()
    for t, v in inputs:
        pw.set_target(t, v)
    sched, _ = _record_and_replay(data, pw, lambda: NonRandomRng(1))
    py = {c.__name__ for c in sched.python_classes(data.prover_only
                                                   .generators)}
    if name == "sparse_table":
        assert "_LookupGenerator" in py
    else:
        assert "_LookupGenerator" not in py


def _zk_config(rounds=1):
    from dataclasses import replace
    c = CircuitConfig.standard_recursion_zk_config_gl()
    return replace(c, fri_config=replace(c.fri_config,
                                         num_query_rounds=rounds))


@pytest.fixture(scope="module")
def zk_fib():
    """The 1-round zk Fibonacci circuit built by the port, with its
    inputs."""
    b = CircuitBuilder(_zk_config())
    ins = circuits.zk_fib(b)
    pw = PartialWitness()
    pw.set_targets(ins, circuits.ZK_FIB_INPUTS)
    return b.build(device="cpu"), pw


@pytest.mark.parametrize("rng", ["nonrandom", "seeded"])
def test_zk_blinding_rows_replay_in_the_fixpoints_draw_order(zk_fib, rng):
    """The random rows and their copies: the same draws, in the same
    order, from either kind of rng."""
    data, pw = zk_fib
    data.prover_only.witgen_schedules.clear()
    make = (lambda: NonRandomRng(1)) if rng == "nonrandom" else \
        (lambda: np.random.default_rng(7))
    sched, _ = _record_and_replay(data, pw, make)
    names = {c.__name__ for c in sched.python_classes(
        data.prover_only.generators)}
    assert "RandomRowGenerator" in names
    assert names <= {"RandomRowGenerator", "RandomValueGenerator"}


def test_zk_proof_from_a_replayed_witness_equals_jax(zk_fib):
    data, pw = zk_fib
    data.prover_only.witgen_schedules.clear()
    data.circuit(pw, NonRandomRng(1))             # records
    assert data.witgen_schedule(pw) is not None
    rng, timings = NonRandomRng(1), {}
    proof = data.prove(pw, rng=rng, timings=timings)
    assert "replay_s" in timings and "record_s" not in timings
    arrays, _ = read_fixture(os.path.join(DATA_DIR, "zk_fib_1q.npz"))
    flat = flatten_proof(proof)
    differ = [k for k in PROOF_PHASES
              if not np.array_equal(flat[k], arrays["proof_" + k])]
    assert not differ, f"proof phases {differ} differ from the JAX proof"
    assert rng.counter == int(arrays["proof_counter"])


@pytest.fixture(scope="module")
def chain():
    """Each field's 2^6 chain built by the port, its witness of x = 3
    recorded."""
    cache = {}

    def get(field):
        if field not in cache:
            data, x = _build_circuit(field,
                                     lambda b: circuits.arith_chain(b, 6))
            pw = PartialWitness()
            pw.set_target(x, 3)
            t = {}
            data.circuit(pw, NonRandomRng(1), t)
            assert set(t) == {"record_s"}
            cache[field] = (data, pw)
        return cache[field]

    return get


def test_chain_proof_from_a_replayed_witness_equals_jax(chain):
    data, pw = chain("goldilocks")
    timings = {}
    proof = data.prove(pw, rng=NonRandomRng(1), timings=timings)
    assert set(timings) >= {"replay_s", "witness_generation"}
    assert "record_s" not in timings
    common = ser.read_common_circuit_data(
        read_bin("arith_chain_2e6_common.bin"))
    want = flatten_proof(ser.read_proof_with_public_inputs(
        read_bin("arith_chain_2e6_proof.bin"), common))
    got = flatten_proof(proof)
    for k in PROOF_PHASES:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_chain_retry_from_a_replayed_witness_equals_jax(chain, field):
    """``CircuitData.prove`` from ``NonRandomRng(1)`` with its first
    attempts made to fail, as the JAX retry fixture's were: the redrawn
    values and the proof."""
    data, pw = chain(field)
    with np.load(fixture_path(6, field, retry=True)) as z:
        arrays = {k: z[k] for k in z.files}
    failures, real, seen = len(arrays["values"]), prover._internal_prove, []

    def internal_prove(circuit, wires, timings, rng):
        row, col = circuit.random_wire
        seen.append(int(circuit.F.to_ints(wires[col, row:row + 1])[0]))
        if len(seen) <= failures:
            raise prover.InvZeroPermArg()
        return real(circuit, wires, timings, rng)

    timings = {}
    prover._internal_prove = internal_prove
    try:
        proof = data.prove(pw, rng=NonRandomRng(1), timings=timings)
    finally:
        prover._internal_prove = real
    assert "replay_s" in timings
    assert seen[1:] == [int(v) for v in arrays["values"]]
    flat = flatten_proof(proof)
    for k in PROOF_PHASES:
        np.testing.assert_array_equal(flat[k], arrays["proof_" + k],
                                      err_msg=k)


@contextlib.contextmanager
def _no_commit():
    """Build without the constants/sigmas commit (a zero cap): the
    generators, the copy classes and so the witness do not depend on it,
    and the commit of a 2^12-row outer is a minute of plain torch on one
    CPU thread."""
    real = builder_mod.PolynomialBatch

    class _Stub:
        @staticmethod
        def from_values(values, rate_bits, cap_height, F, hasher):
            n = 4 if hasher.__name__.endswith("poseidon_gl") else 8
            return SimpleNamespace(
                cap_host=lambda: [[0] * n for _ in range(1 << cap_height)])

    builder_mod.PolynomialBatch = _Stub
    try:
        yield
    finally:
        builder_mod.PolynomialBatch = real


def _inner(field):
    tag = "" if field == "goldilocks" else "bb_"
    spec = SPECS[field]
    common = ser.read_common_circuit_data(
        read_bin(f"arith_chain_{tag}2e6_common.bin"), spec)
    vk = ser.read_verifier_only_circuit_data(
        read_bin(f"arith_chain_{tag}2e6_verifier.bin"), spec)
    proof = ser.read_proof_with_public_inputs(
        read_bin(f"arith_chain_{tag}2e6_proof.bin"), common)
    return common, vk, proof


def _column_digests(wires):
    import hashlib
    return np.stack([np.frombuffer(hashlib.sha256(np.ascontiguousarray(
        col, dtype=np.uint64).tobytes()).digest(), dtype=np.uint8)
        for col in wires])


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_recursive_outer_replay_equals_the_jax_witness(field):
    """The outer over the stored 2^6 chain proof: recorded, replayed, and
    the replayed witness against the JAX witness column by column, with
    the public inputs and the counter after it."""
    common, vk, proof = _inner(field)
    b = CircuitBuilder(config_of(field), SPECS[field])
    proof_t, vk_t = circuits.recursive_verifier(b, common)
    with _no_commit():
        data = b.build(device="cpu")
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, proof)
    rv.set_verifier_data_target(pw, vk_t, vk)
    sched, w = _record_and_replay(data, pw, lambda: NonRandomRng(1))
    tag = "gl" if field == "goldilocks" else "bb"
    with np.load(os.path.join(DATA_DIR,
                              f"recursive_{tag}_2e6inner.npz")) as z:
        want, pis, counter = z["column_sha256"], z["public_inputs"], \
            int(z["counter"])
    got = _column_digests(w.full_witness())
    bad = [c for c in range(len(want)) if not np.array_equal(got[c],
                                                             want[c])]
    assert not bad, f"wire columns {bad} differ from the JAX witness"
    assert w.get_targets(data.prover_only.public_inputs) == \
        [int(v) for v in pis]
    assert w.rng.counter == counter
    names = {c.__name__ for c in sched.python_classes(
        data.prover_only.generators)}
    assert names <= {"RandomValueGenerator", "_MdsGenerator"}
    assert sched.n_native > 1000


# --------------------------------------------------------------------------
# (d) bookkeeping, coverage, the build
# --------------------------------------------------------------------------


def test_another_set_of_presets_records_anew():
    """Presetting the chain's output too changes the set: a second
    schedule, whose witness equals the first's."""
    data, x = _build_circuit("goldilocks",
                             lambda b: circuits.arith_chain(b, 6))
    po = data.prover_only
    pw = PartialWitness()
    pw.set_target(x, 3)
    w1 = gen.generate_partial_witness(pw, po, data.common, NonRandomRng(1))
    out = po.public_inputs[1]
    pw2 = PartialWitness()
    pw2.set_target(x, 3)
    pw2.set_target(out, w1.get_target(out))
    for _ in range(2):
        w2 = gen.generate_partial_witness(pw2, po, data.common,
                                          NonRandomRng(1))
        assert len(po.witgen_schedules) == 2
        np.testing.assert_array_equal(w1.full_witness(), w2.full_witness())
    t = {}
    data.circuit(pw, NonRandomRng(1), t)
    data.circuit(pw2, NonRandomRng(1), t)
    assert set(t) == {"replay_s"}


def test_a_contradiction_under_replay_names_its_generator():
    """The chain's output preset: right, it records; wrong, under the same
    set of presets, the replay stops at the generator that contradicts
    it."""
    data, x = _build_circuit("goldilocks",
                             lambda b: circuits.arith_chain(b, 6))
    out = data.prover_only.public_inputs[1]
    free = PartialWitness()
    free.set_target(x, 3)
    want = data.circuit(free, NonRandomRng(1)).public_inputs[1]
    for value, raises in ((want, False), ((want + 1) % GL.p, True)):
        pw = PartialWitness()
        pw.set_target(x, 3)
        pw.set_target(out, value)
        if not raises:
            data.circuit(pw, NonRandomRng(1))
            continue
        assert data.witgen_schedule(pw) is not None
        with pytest.raises(engine.WitgenError,
                           match=r"contradictory witness assignment at "
                                 r"instruction \d+ \(generator \d+, "
                                 r"_ArithmeticOpGenerator of row \d+: "
                                 r"contradictory assignment") as e:
            data.circuit(pw, NonRandomRng(1))
        assert e.value.code == 1


@pytest.mark.parametrize("p", PRIMES)
def test_seeded_bulk_draws_equal_the_python_formula(p):
    """The seeded draw (124 random bits mod p, in an object array)
    against python ints one at a time."""
    rng = np.random.default_rng(11)
    got = gen.rand_field_elements(p, rng, 5000)
    words = np.random.default_rng(11).integers(
        0, 1 << 62, size=10000, dtype=np.int64).tolist()
    assert got.tolist() == [(h << 62 | lo) % p
                            for h, lo in zip(words[0::2], words[1::2])]


@pytest.mark.parametrize("case", ["distinct", "repeated", "contradiction"])
def test_bulk_store_equals_set_target_in_order(case):
    """``PartitionWitness.set_dense`` (the replay's store of a random
    row) against ``set_target`` one value at a time."""
    from plonky2_goldibear_torch.iop.witness import PartitionWitness

    rng = np.random.default_rng(3)
    nw, rows = 12, 8
    rep = np.arange(nw * rows, dtype=np.int64)
    rep[5] = rep[17] = 17                    # two wires, one copy class
    idx = np.array([i for i in rng.permutation(nw * rows)
                    if i not in (3, 5, 17)][:40])
    if case != "distinct":
        idx = np.concatenate([idx, [5, 17]])
    vals = rng.integers(0, GL.p, size=len(idx), dtype=np.uint64)
    if case == "repeated":
        vals[-2:] = 9
    ws = [PartitionWitness(nw, rows, rep) for _ in range(2)]
    for w in ws:
        w.set_target(("w", 0, 3), 77)
    if case == "contradiction":
        idx[0], vals[0] = 3, 78
    results = []
    for bulk, w in zip((True, False), ws):
        try:
            if bulk:
                w.set_dense(idx, vals)
            else:
                for i, v in zip(idx.tolist(), vals.tolist()):
                    w.set_target(("w", i // nw, i % nw), v)
            results.append(None)
        except AssertionError as e:
            results.append("contradictory assignment" in str(e))
    if case == "distinct" or case == "repeated":
        assert results == [None, None]
        np.testing.assert_array_equal(ws[0].filled, ws[1].filled)
        np.testing.assert_array_equal(ws[0].vals, ws[1].vals)
    else:
        assert results == [True, True]


def _all_generator_classes():
    import importlib
    import pkgutil

    import plonky2_goldibear_torch as pkg
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
    seen, todo = set(), [gen.SimpleGenerator]
    while todo:
        for c in todo.pop().__subclasses__():
            if c not in seen:
                seen.add(c)
                todo.append(c)
    return seen


def test_every_generator_class_is_lowered_or_python():
    classes = _all_generator_classes()
    assert len(classes) == 24
    for c in classes:
        assert (c in lower.LOWERERS) != (c in lower.PYTHON_GENERATORS), c
    assert len(lower.LOWERERS) == 19 and len(lower.PYTHON_GENERATORS) == 5


def test_an_unknown_generator_class_is_refused():
    class Stray(gen.SimpleGenerator):
        def dependencies(self):
            return []

    with pytest.raises(TypeError, match="Stray"):
        lower.lowerer_for(Stray(), {})


@pytest.mark.parametrize("compiler", ["no-such-compiler-x", "false"])
def test_the_build_raises_without_a_working_compiler(compiler, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(_build, "HOST_CC", compiler)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match=compiler):
        _build.build_host("witgen")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


def test_the_library_is_built_from_the_port_source():
    path = _build.build_host("witgen")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libwitgen_")
    assert os.path.exists(os.path.join(_build.CSRC, "witgen.c"))
