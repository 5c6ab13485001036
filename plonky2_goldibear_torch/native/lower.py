"""Lower witness generators to instructions of the replay VM
(``csrc/witgen.c``; the JAX package's ``native/lower.py``).

Each lowered generator class has a lowerer that writes the dataflow of its
``run_once`` as straight-line instructions over the witness's
representative slots.  Where the generator computes through an algebra
function of the port (``hash/poseidon_gl.py``, ``hash/poseidon2_bb.py``,
``hash/poseidon2_r0_bb.py``: the ``*_a`` functions), the lowerer runs that
same function over ``EmitAlgebra``, whose values are slot indices and whose
operations append instructions, so the replayed values are the host values
by construction.  Branches on witness values become branch-free algebra
(the Merkle swap of the Poseidon gates: state = input +/- swap * (b - a))
or the VM's own checked ops (SELECT, SPLITR, LUTMAP).

The generators that draw randomness, or that set values the VM does not
compute, are not lowered: ``PYTHON_GENERATORS`` lists them, and they run
as Python segments of the replay in the recorded order.
"""

from __future__ import annotations

from array import array
from typing import Dict, Optional, Set, Tuple

import numpy as np

from ..field import host
from ..gates.base import _FusedOpsMixin
from ..iop import target as tgt

# the opcodes of csrc/witgen.c
CONST, COPY, ADD, SUB, MUL, MULC, ADDC, RSUBC, MAC, MACI, INV, POW7, \
    SELECT, BIT, SPLITR, SHRM, ASHR0, ABOOL, LUTMAP = range(19)


class Prog:
    """One native segment being written: its code (5 words an
    instruction), its pool of slot lists and tables, its temporaries
    (slots from ``num_reps`` on) and its deduplicated constants."""

    def __init__(self, num_reps: int, p: int):
        self.num_reps = num_reps
        self.p = p
        self.code = array("Q")
        self.pool = array("Q")
        self.n_temps = 0
        self._consts: Dict[int, int] = {}
        self._tables: Dict[int, int] = {}

    def __len__(self) -> int:
        """The instruction count."""
        return len(self.code) // 5

    def emit(self, op, dst, a=0, b=0, c=0) -> None:
        self.code.extend((op, dst, a, b, c))

    def emit_t(self, op, a=0, b=0, c=0) -> int:
        """An instruction into a new temporary; returns its slot."""
        d = self.num_reps + self.n_temps
        self.n_temps += 1
        self.code.extend((op, d, a, b, c))
        return d

    def const(self, v: int) -> int:
        v %= self.p
        t = self._consts.get(v)
        if t is None:
            t = self._consts[v] = self.emit_t(CONST, v)
        return t

    def pool_put(self, values) -> int:
        off = len(self.pool)
        self.pool.extend(int(v) for v in values)
        return off

    def table(self, key: int, values) -> int:
        """The pool offset of a table [len, values...], put once a
        segment."""
        off = self._tables.get(key)
        if off is None:
            values = list(values)
            off = self._tables[key] = self.pool_put([len(values)] + values)
        return off

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return (np.frombuffer(self.code, dtype=np.uint64).copy(),
                np.frombuffer(self.pool, dtype=np.uint64).copy())


class EmitAlgebra(_FusedOpsMixin):
    """The base-field algebra of ``gates/base.py`` whose values are slot
    indices: every operation appends an instruction."""

    def __init__(self, prog: Prog, spec: host.FieldSpec):
        self.prog = prog
        self.spec = spec
        self.p = spec.p

    def from_int(self, c: int):
        return self.prog.const(c)

    def zero(self):
        return self.prog.const(0)

    def one(self):
        return self.prog.const(1)

    def add(self, a, b):
        return self.prog.emit_t(ADD, a, b)

    def sub(self, a, b):
        return self.prog.emit_t(SUB, a, b)

    def neg(self, a):
        return self.prog.emit_t(RSUBC, a, 0)

    def mul(self, a, b):
        return self.prog.emit_t(MUL, a, b)

    def mul_base_const(self, a, c: int):
        return self.prog.emit_t(MULC, a, c % self.p)

    def add_base_const(self, a, c: int):
        return self.prog.emit_t(ADDC, a, c % self.p)

    def mul_scalar(self, a, s: int):
        return self.mul_base_const(a, s)

    def lift_scalar(self, s: int):
        return self.prog.const(s)

    def exp7(self, x):
        return self.prog.emit_t(POW7, x)

    def mul_add(self, a, b, c):
        return self.prog.emit_t(MAC, a, b, c)

    def const_mul_add(self, c: int, x, acc):
        return self.prog.emit_t(MACI, x, acc, c % self.p)

    def const_mul(self, c: int, x):
        return self.mul_base_const(x, c)

    def inv(self, a):
        return self.prog.emit_t(INV, a)


# -- the extension field over tuples of slots ---------------------------------


def e_add(A, a, b):
    return tuple(A.add(x, y) for x, y in zip(a, b))


def e_sub(A, a, b):
    return tuple(A.sub(x, y) for x, y in zip(a, b))


def e_from_base(A, x):
    return (x,) + (A.zero(),) * (A.spec.ext_degree - 1)


def e_scalar_mul_c(A, a, s: int):
    """a times the constant s."""
    return tuple(A.mul_base_const(x, s) for x in a)


def e_scalar_mul(A, a, s):
    """a times the base-field slot s."""
    return tuple(A.mul(x, s) for x in a)


def e_mul(A, a, b):
    """Schoolbook, X^D folded to W (``host.ext_mul``), at any D."""
    d, w = A.spec.ext_degree, A.spec.ext_w
    acc = [None] * (2 * d - 1)
    for i in range(d):
        for j in range(d):
            t = A.mul(a[i], b[j])
            acc[i + j] = t if acc[i + j] is None else A.add(acc[i + j], t)
    out = acc[:d]
    for k in range(d, 2 * d - 1):
        out[k - d] = A.const_mul_add(w, acc[k], out[k - d])
    return tuple(out)


def e_frobenius(A, a, count: int = 1):
    """a^(p^count): coefficient i times z^(count i), z = W^((p - 1) / D)."""
    p, d = A.spec.p, A.spec.ext_degree
    zc = pow(pow(A.spec.ext_w, (p - 1) // d, p), count % d, p)
    out, s = [], 1
    for x in a:
        out.append(A.mul_base_const(x, s))
        s = s * zc % p
    return tuple(out)


def e_inv(A, a):
    """1 / a as conj(a) / N(a), conj(a) the product of the Frobenius images
    a^(p^i), i = 1..D-1 (``host.ext_inv``); the norm's inverse fails on
    zero."""
    d = A.spec.ext_degree
    if d == 1:
        return (A.inv(a[0]),)
    conj = e_frobenius(A, a, 1)
    for i in range(2, d):
        conj = e_mul(A, conj, e_frobenius(A, a, i))
    norm = e_mul(A, a, conj)[0]
    return e_scalar_mul(A, conj, A.inv(norm))


# -- the lowering context -----------------------------------------------------


class Ctx:
    """What a lowerer writes with: the segment, its algebra and the
    representative slot of a target."""

    def __init__(self, prog: Prog, spec: host.FieldSpec,
                 rep_map: np.ndarray, num_wires: int, degree: int):
        self.prog = prog
        self.spec = spec
        self.A = EmitAlgebra(prog, spec)
        self._rep = rep_map
        self._nw = num_wires
        self._deg = degree

    def rep(self, t) -> int:
        return int(self._rep[tgt.target_index(t, self._nw, self._deg)])

    def wire(self, row: int, col: int) -> int:
        return int(self._rep[row * self._nw + col])

    def store(self, t, src: int) -> None:
        """The checked store of slot ``src`` into target ``t``."""
        self.prog.emit(COPY, self.rep(t), src)

    def store_wire(self, row: int, col: int, src: int) -> None:
        self.prog.emit(COPY, self.wire(row, col), src)


# -- row templates ------------------------------------------------------------

# the operands that are value slots, by opcode (1 dst, 2 a, 3 b, 4 c); the
# ops that address the pool have no template
SLOT_FIELDS = {CONST: (1,), COPY: (1, 2), ADD: (1, 2, 3), SUB: (1, 2, 3),
               MUL: (1, 2, 3), MULC: (1, 2), ADDC: (1, 2), RSUBC: (1, 2),
               MAC: (1, 2, 3, 4), MACI: (1, 2, 3), INV: (1, 2),
               POW7: (1, 2), BIT: (1, 2), SHRM: (1, 2), ASHR0: (2,),
               ABOOL: (2,)}
_WIRE_BASE = 1 << 63        # a template's slot of column c: _WIRE_BASE + c
_TEMP_BASE = 1 << 62        # its k-th temporary: _TEMP_BASE + k


class _RowCtx(Ctx):
    """A lowering context whose wires of ``row`` are placeholders."""

    def __init__(self, prog, spec, row):
        super().__init__(prog, spec, None, 0, 0)
        self.row = row

    def rep(self, t):
        if t[0] != "w":
            raise ValueError("a row template reads a virtual target")
        return self.wire(t[1], t[2])

    def wire(self, row, col):
        if row != self.row:
            raise ValueError("a row template reads another row")
        return _WIRE_BASE + col


class RowTemplate:
    """One lowering of a row-local generator, its wires and temporaries
    as placeholders; ``emit`` writes it for another generator of the same
    shape, with that generator's row's slots and the segment's next
    temporaries."""

    def __init__(self, fn, g, spec):
        prog = Prog(_TEMP_BASE, spec.p)
        fn(g, _RowCtx(prog, spec, g.row))
        code = np.frombuffer(prog.code, dtype=np.uint64).copy()
        ops = code[0::5].astype(np.int64)
        if not np.isin(ops, list(SLOT_FIELDS)).all():
            raise ValueError("a row template addresses the pool")
        pos = np.concatenate([np.flatnonzero(ops == op) * 5 + f
                              for op, fields in SLOT_FIELDS.items()
                              for f in fields] + [np.zeros(0, np.int64)])
        slots = code[pos]
        wires = slots >= np.uint64(_WIRE_BASE)
        assert (slots >= np.uint64(_TEMP_BASE)).all()
        self.code = code
        self.wire_pos = pos[wires]
        self.wire_col = (slots[wires] - np.uint64(_WIRE_BASE)).astype(
            np.int64)
        self.temp_pos = pos[~wires]
        self.temp_off = slots[~wires] - np.uint64(_TEMP_BASE)
        self.n_temps = prog.n_temps

    def emit(self, prog: Prog, row_slots: np.ndarray) -> None:
        """Append to ``prog`` with ``row_slots`` (column -> slot of the
        row)."""
        code = self.code.copy()
        code[self.wire_pos] = row_slots[self.wire_col]
        code[self.temp_pos] = self.temp_off + np.uint64(prog.num_reps
                                                        + prog.n_temps)
        prog.n_temps += self.n_temps
        prog.code.frombytes(code.tobytes())


# -- the lowerers -------------------------------------------------------------

LOWERERS: Dict[type, object] = {}
# the generator classes that run as Python segments: randomness, which
# must draw from the witness's rng in the recorded order, and the
# generators that set values the VM does not compute
PYTHON_GENERATORS: Set[type] = set()


def lowers(cls, template=None):
    """Register ``fn`` as the lowerer of ``cls``.  ``template(g)``, where
    given, is a key of the generator's shape: the lowerer then reads and
    writes only the wires of ``g.row`` and no pool, its stream depends on
    nothing else, and ``compile_schedule`` lowers it once a key
    (``RowTemplate``)."""
    def deco(fn):
        fn.template_key = template
        LOWERERS[cls] = fn
        return fn
    return deco


def _register_core():
    from ..gates.access_gates import BaseSumGate
    from ..gates.access_gates import _BaseSplitGenerator as BaseSplit
    from ..gates.access_gates import _ExponentiationGenerator as Exp
    from ..gates.access_gates import _RandomAccessGenerator as RandomAccess
    from ..gates.basic_gates import ArithmeticGate
    from ..gates.basic_gates import _ArithmeticOpGenerator as ArithmeticOp
    from ..gates.coset_interpolation import \
        _InterpolationGenerator as Interpolation
    from ..gates.extension_gates import _ExtensionOpGenerator as ExtOp
    from ..gates.lookup_gates import LookupGate
    from ..gates.lookup_gates import _LookupGenerator as Lookup
    from ..gates.misc_gates import _AddManyGenerator as AddMany
    from ..gates.reducing import _ReducingGenerator as Reducing
    from ..iop.generator import ConstantGenerator, CopyGenerator
    from ..plonk.builder import _ExtInverseGenerator as ExtInverse
    from ..plonk.gadgets import _BaseSumGenerator as BaseSum
    from ..plonk.gadgets import _WireSplitGenerator as WireSplit

    @lowers(ConstantGenerator)
    def _constant(g, ctx):
        ctx.prog.emit(CONST, ctx.wire(g.row, g.wire_index),
                      g.constant % ctx.spec.p)

    @lowers(CopyGenerator)
    def _copy(g, ctx):
        ctx.prog.emit(COPY, ctx.rep(g.dst), ctx.rep(g.src))

    @lowers(ArithmeticOp)
    def _arithmetic(g, ctx):
        # c0 * m0 * m1 + c1 * addend
        w0, w1, wa, wo = (ctx.wire(g.row, w)
                          for w in ArithmeticGate.wires(g.i))
        prog, p = ctx.prog, ctx.spec.p
        t = prog.emit_t(MULC, prog.emit_t(MUL, w0, w1), g.c0 % p)
        prog.emit(MACI, wo, wa, t, g.c1 % p)

    @lowers(AddMany)
    def _add_many(g, ctx):
        ws = [ctx.wire(g.row, w) for w in g.gate.wires_addends(g.op)]
        acc = ws[0] if ws else ctx.prog.const(0)
        for w in ws[1:]:
            acc = ctx.prog.emit_t(ADD, acc, w)
        ctx.store_wire(g.row, g.gate.wire_sum(g.op), acc)

    @lowers(BaseSplit)
    def _base_split(g, ctx):
        dsts = [ctx.wire(g.row, i) for i in g.gate.limbs()]
        ctx.prog.emit(SPLITR, len(dsts), ctx.wire(g.row, BaseSumGate.WIRE_SUM),
                      ctx.prog.pool_put(dsts), g.gate.base)

    @lowers(WireSplit)
    def _wire_split(g, ctx):
        src = ctx.rep(g.integer)
        mask = (1 << g.num_limbs) - 1
        for k, row in enumerate(g.rows):
            ctx.prog.emit(SHRM, ctx.wire(row, BaseSumGate.WIRE_SUM), src,
                          k * g.num_limbs, mask)
        ctx.prog.emit(ASHR0, 0, src, len(g.rows) * g.num_limbs)

    @lowers(BaseSum)
    def _base_sum(g, ctx):
        # sum_i bit_i 2^i by Horner mod p: the integer the generator ORs
        # together, the bits being boolean
        bits = [ctx.rep(t) for t in g.bits]
        acc = bits[-1]
        for b in reversed(bits[:-1]):
            acc = ctx.prog.emit_t(MACI, acc, b, 2)
        ctx.store_wire(g.row, BaseSumGate.WIRE_SUM, acc)

    @lowers(Exp, template=lambda g: g.gate.num_power_bits)
    def _exponentiation(g, ctx):
        gate, prog = g.gate, ctx.prog
        base = ctx.wire(g.row, gate.wire_base())
        nb = gate.num_power_bits
        inter = prog.const(1)
        for i in range(nb):
            prev = inter if i == 0 else prog.emit_t(MUL, inter, inter)
            bit = ctx.wire(g.row, gate.wire_power_bit(nb - i - 1))
            term = prog.emit_t(ADD, prog.emit_t(MUL, bit, base),
                               prog.emit_t(RSUBC, bit, 1))
            inter = prog.emit_t(MUL, prev, term)
            ctx.store_wire(g.row, gate.wire_intermediate_value(i), inter)
        ctx.store_wire(g.row, gate.wire_output(), inter)

    @lowers(RandomAccess)
    def _random_access(g, ctx):
        gate, prog, c = g.gate, ctx.prog, g.copy
        idx = ctx.wire(g.row, gate.wire_access_index(c))
        off = prog.pool_put(ctx.wire(g.row, gate.wire_list_item(i, c))
                            for i in range(gate.vec_size))
        prog.emit(SELECT, ctx.wire(g.row, gate.wire_claimed_element(c)), idx,
                  off, gate.vec_size)
        for i in range(gate.bits):
            prog.emit(BIT, ctx.wire(g.row, gate.wire_bit(i, c)), idx, i)

    @lowers(Lookup)
    def _lookup(g, ctx):
        off = ctx.prog.table(id(g.table),
                             (g.table[v] for v in range(len(g.table))))
        ctx.prog.emit(
            LUTMAP, ctx.wire(g.row, LookupGate.wire_ith_looking_out(g.slot)),
            ctx.wire(g.row, LookupGate.wire_ith_looking_inp(g.slot)), off)

    def _indexed(g, memo):
        # a table whose inputs are 0..n-1 maps by index; another stays
        # Python.  Once a table a compile: a u16 table's 4,500 lookups
        # share one 65,536-entry dict
        hit = memo.get(id(g.table))
        if hit is None:
            hit = memo[id(g.table)] = (g.table, all(
                v in g.table for v in range(len(g.table))))
        return hit[1]

    _lookup.can_lower = _indexed

    @lowers(ExtOp)
    def _ext_op(g, ctx):
        # c0 * m0 * m1 (+ c1 * addend): both ops of the one generator
        A = ctx.A
        ranges = g.gate.wires_op(g.i)
        ins = [tuple(ctx.wire(g.row, w) for w in r) for r in ranges[:-1]]
        res = e_scalar_mul_c(A, e_mul(A, ins[0], ins[1]), g.c0)
        if g.c1 is not None:
            res = e_add(A, res, e_scalar_mul_c(A, ins[2], g.c1))
        for w, v in zip(ranges[-1], res):
            ctx.store_wire(g.row, w, v)

    @lowers(ExtInverse)
    def _ext_inverse(g, ctx):
        inv = e_inv(ctx.A, tuple(ctx.rep(t) for t in g.a))
        for t, v in zip(g.inv_targets, inv):
            ctx.store(t, v)

    @lowers(Reducing, template=lambda g: (type(g.gate), g.gate.num_coeffs,
                                          g.gate.D))
    def _reducing(g, ctx):
        A, gate = ctx.A, g.gate

        def get(wires):
            return tuple(ctx.wire(g.row, w) for w in wires)

        alpha, acc = get(gate.wires_alpha()), get(gate.wires_old_acc())
        for i in range(gate.num_coeffs):
            c = get(gate.wires_coeff(i))
            if len(c) == 1:
                c = e_from_base(A, c[0])
            acc = e_add(A, e_mul(A, acc, alpha), c)
            for w, v in zip(gate.wires_accs(i), acc):
                ctx.store_wire(g.row, w, v)

    @lowers(Interpolation, template=lambda g: (g.gate.subgroup_bits,
                                               g.gate.gate_degree))
    def _interpolation(g, ctx):
        # the generator's own recurrence (coset_interpolation.py)
        A, gate = ctx.A, g.gate

        def get(wires):
            return tuple(ctx.wire(g.row, w) for w in wires)

        def put(wires, vals):
            for w, v in zip(wires, vals):
                ctx.store_wire(g.row, w, v)

        shift_inv = A.inv(ctx.wire(g.row, gate.wire_shift()))
        shifted = e_scalar_mul(A, get(gate.wires_evaluation_point()),
                               shift_inv)
        put(gate.wires_shifted_evaluation_point(), shifted)
        values = [get(gate.wires_value(i)) for i in range(gate.num_points)]

        def interpolate(lo, hi, ev, prod):
            for val, w, x_i in zip(values[lo:hi],
                                   gate.barycentric_weights[lo:hi],
                                   gate.domain[lo:hi]):
                term = e_sub(A, shifted, e_from_base(A, A.from_int(x_i)))
                ev = e_add(A, e_mul(A, ev, term),
                           e_mul(A, e_scalar_mul_c(A, val, w), prod))
                prod = e_mul(A, prod, term)
            return ev, prod

        d = gate.gate_degree
        dd = ctx.spec.ext_degree
        ev, prod = interpolate(0, d, (A.zero(),) * dd,
                               (A.one(),) + (A.zero(),) * (dd - 1))
        for i in range(gate.num_intermediates()):
            put(gate.wires_intermediate_eval(i), ev)
            put(gate.wires_intermediate_prod(i), prod)
            start = 1 + (d - 1) * (i + 1)
            ev, prod = interpolate(start, min(start + d - 1, gate.num_points),
                                   ev, prod)
        put(gate.wires_evaluation_value(), ev)


def _swap_state(ctx, row, width, cap, wire_input, wire_swap, wire_delta):
    """The Merkle-swap prologue of the Poseidon-family generators, branch
    free: delta_i = swap * (b_i - a_i), the state a_i + delta_i and
    b_i - delta_i, the swap checked boolean."""
    prog = ctx.prog
    wv = [ctx.wire(row, wire_input(i)) for i in range(width)]
    swap = ctx.wire(row, wire_swap)
    prog.emit(ABOOL, 0, swap)
    state = list(wv)
    for i in range(cap):
        delta = prog.emit_t(MUL, swap, prog.emit_t(SUB, wv[i + cap], wv[i]))
        ctx.store_wire(row, wire_delta(i), delta)
        state[i] = prog.emit_t(ADD, wv[i], delta)
        state[i + cap] = prog.emit_t(SUB, wv[i + cap], delta)
    return state


def _register_permutations():
    from ..gates import poseidon as pos
    from ..gates import poseidon2_bb_gate as g2
    from ..gates import poseidon2_r0_bb_gate as gr
    from ..gates.misc_gates import W as P2W
    from ..gates.misc_gates import _ApplyMat4Generator as ApplyMat4
    from ..gates.misc_gates import _InternalPermGenerator as InternalPerm
    from ..hash import _poseidon2_bb_constants as C2
    from ..hash import _poseidon_gl_constants as PC
    from ..hash import poseidon2_bb as p2
    from ..hash import poseidon2_r0_bb as r0
    from ..hash import poseidon_gl as pg

    @lowers(pos.PoseidonGenerator, template=lambda g: ())
    def _poseidon_gl(g, ctx):
        # PoseidonGenerator.run_once over the *_a functions
        A, G, row = ctx.A, pos.PoseidonGate, g.row
        state = _swap_state(ctx, row, pos.W, 4, G.wire_input, G.WIRE_SWAP,
                            G.wire_delta)
        round_ctr = 0
        for r in range(pos.HALF):
            state = pg.constant_layer_a(A, state, round_ctr)
            if r != 0:
                for i in range(pos.W):
                    ctx.store_wire(row, G.wire_full_sbox_0(r, i), state[i])
            state = pg.mds_layer_a(A, pg.sbox_layer_a(A, state))
            round_ctr += 1
        state = pg.partial_first_constant_layer_a(A, state)
        state = pg.mds_partial_layer_init_a(A, state)
        for r in range(pos.NP):
            ctx.store_wire(row, G.wire_partial_sbox(r), state[0])
            state[0] = pg.sbox_monomial_a(A, state[0])
            if r < pos.NP - 1:
                state[0] = A.add_base_const(
                    state[0], PC.FAST_PARTIAL_ROUND_CONSTANTS[r])
            state = pg.mds_partial_layer_fast_a(A, state, r)
        round_ctr += pos.NP
        for r in range(pos.HALF):
            state = pg.constant_layer_a(A, state, round_ctr)
            for i in range(pos.W):
                ctx.store_wire(row, G.wire_full_sbox_1(r, i), state[i])
            state = pg.mds_layer_a(A, pg.sbox_layer_a(A, state))
            round_ctr += 1
        for i in range(pos.W):
            ctx.store_wire(row, G.wire_output(i), state[i])

    @lowers(g2._Poseidon2Generator,
            template=lambda g: (g.gate.num_ops, g.op))
    def _poseidon2_bb(g, ctx):
        # _Poseidon2Generator.run_once over the *_a functions
        A, gate, op, row = ctx.A, g.gate, g.op, g.row
        state = _swap_state(ctx, row, g2.W, g2.CAP,
                            lambda i: gate.wire_input(op, i),
                            gate.wire_swap(op),
                            lambda i: gate.wire_delta(op, i))
        state = p2.external_layer_a(A, state)
        for r in range(g2.HALF):
            state = [A.add_base_const(x, c)
                     for x, c in zip(state, C2.EXTERNAL_CONSTANTS[r])]
            if r > 0:
                for i in range(g2.W):
                    ctx.store_wire(row, gate.wire_full_sbox_0(op, r, i),
                                   state[i])
            state = p2.external_layer_a(A, [p2.sbox_a(A, x) for x in state])
        for r in range(g2.NP):
            state[0] = A.add_base_const(state[0], C2.INTERNAL_CONSTANTS[r])
            ctx.store_wire(row, gate.wire_partial_sbox(op, r), state[0])
            state[0] = p2.sbox_a(A, state[0])
            state = p2.internal_layer_a(A, state)
        for r in range(g2.HALF, C2.N_FULL_ROUNDS_TOTAL):
            state = [A.add_base_const(x, c)
                     for x, c in zip(state, C2.EXTERNAL_CONSTANTS[r])]
            for i in range(g2.W):
                ctx.store_wire(row, gate.wire_full_sbox_1(op, r - g2.HALF, i),
                               state[i])
            state = p2.external_layer_a(A, [p2.sbox_a(A, x) for x in state])
        for i in range(g2.W):
            ctx.store_wire(row, gate.wire_output(op, i), state[i])

    @lowers(gr._Poseidon2R0Generator,
            template=lambda g: (g.gate.num_ops, g.op))
    def _poseidon2_r0(g, ctx):
        # permute_a with the generator's at_sbox hook: each stored S-box
        # input is written where the hook sees it
        gate, op, row = g.gate, g.op, g.row
        state = _swap_state(ctx, row, gr.W, gr.CAP,
                            lambda i: gate.wire_input(op, i),
                            gate.wire_swap(op),
                            lambda i: gate.wire_delta(op, i))

        def at_sbox(stage, r, i, x):
            w = gate.wire_sbox(op, stage, r, i)
            if w is not None:
                ctx.store_wire(row, w, x)
            return x

        state = r0.permute_a(ctx.A, state, at_sbox)
        for i in range(gr.W):
            ctx.store_wire(row, gate.wire_output(op, i), state[i])

    @lowers(ApplyMat4)
    def _apply_mat4(g, ctx):
        gate = g.gate
        for d in range(gate.D):
            y = p2.apply_mat4_a(ctx.A, [
                ctx.wire(g.row, gate.wires_input(g.op, i)[d])
                for i in range(4)])
            for i in range(4):
                ctx.store_wire(g.row, gate.wires_output(g.op, i)[d], y[i])

    @lowers(InternalPerm)
    def _internal_perm(g, ctx):
        gate = g.gate
        for d in range(gate.D):
            y = p2.internal_layer_a(ctx.A, [
                ctx.wire(g.row, gate.wires_input(i)[d]) for i in range(P2W)])
            for i in range(P2W):
                ctx.store_wire(g.row, gate.wires_output(i)[d], y[i])


def _register_python():
    from ..gates.lookup_gates import _LookupTableGenerator
    from ..gates.poseidon_mds import _MdsGenerator
    from ..iop.generator import RandomRowGenerator, RandomValueGenerator
    from ..recursion.conditional import _DummyProofGenerator
    PYTHON_GENERATORS.update((RandomValueGenerator, RandomRowGenerator,
                              _LookupTableGenerator, _MdsGenerator,
                              _DummyProofGenerator))


_register_core()
_register_permutations()
_register_python()


def lowerer_for(g, memo: dict) -> Optional[object]:
    """The lowerer of generator ``g``, or None for a Python segment;
    ``memo`` is one compile's cache of table checks.  Raises
    ``TypeError`` for a class on neither list."""
    fn = LOWERERS.get(type(g))
    if fn is not None:
        can = getattr(fn, "can_lower", None)
        return fn if can is None or can(g, memo) else None
    if type(g) in PYTHON_GENERATORS:
        return None
    raise TypeError(f"the witness replay neither lowers nor runs "
                    f"{type(g).__qualname__} in Python (native/lower.py)")
