"""Gate framework (reference plonky2/src/gates/gate.rs:53-430).

The builder side of a gate (``num_wires``, ``num_constants``, ``degree``,
``generators``, ``extra_constant_wires``, ``complete_wires``; the JAX
package's ``gates/base.py:269-284``) places it in a circuit and fills its
wires.  A gate's constraints are written once, ``eval_unfiltered(A,
vars)``, over an algebra ``A`` (the JAX package's ``gates/base.py``):
``HostExtAlgebra`` works on D-tuples of python ints (the verifier at
zeta), ``HostBaseAlgebra`` on python ints (one base-field point),
``DeviceBaseAlgebra`` on field tensors holding every point of the quotient
domain at once (the prover's quotient, the reference's
``eval_unfiltered_base_batch`` batched over the whole domain), and
``gates/circuit_algebra.py:CircuitExtAlgebra`` on extension targets (the
recursive verifier's constraint check, built into a circuit).  An
extension gate's operand is a D-vector of algebra values, multiplied with
``ext_algebra_mul`` in F_D[X]/(X^D - W).

The two Poseidon gates also keep a stacked form for the prover,
``eval_unfiltered_device(F, wires, constants, pi_hash)``: the field module
``F`` (``gl`` or ``bb``), the stacked wires (num_wires, m), the gate
constants (k, m) and the public-input hash (4 or 8 scalar tensors) in, a
(num_constraints, m) tensor out.  It runs a round's S-boxes and MDS over
all 12 or 16 lanes in a few whole-domain ops where the algebra takes one
op per lane; ``plonk/vanishing.py:gate_constraints_device`` prefers it.

Selector filtering (reference gate.rs:391-430): filter = prod over the
gate's selector group of (i - s), times (UNUSED - s) when the circuit has
several selector polynomials.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..field import gl, host

# Placeholder selector value for rows whose gate is in another group
# (reference gates/selectors.rs:14).
UNUSED_SELECTOR = (1 << 32) - 1


class _FusedOpsMixin:
    """The fused operations the gates and the vanishing polynomial are
    written with, composed from the algebra's add / sub / mul (the
    reference's circuit evaluators emit these as single gadgets; here they
    give the same field values)."""

    def mul_add(self, a, b, c):
        return self.add(self.mul(a, b), c)

    def mul_sub(self, a, b, c):
        return self.sub(self.mul(a, b), c)

    def product(self, terms):
        """The product of ``terms`` from the first on (one for none)."""
        out = None
        for t in terms:
            out = t if out is None else self.mul(out, t)
        return out if out is not None else self.one()

    def mul_many(self, terms):
        """The product of ``terms`` (the circuit algebra's starts from
        one, as the reference's mul_many_extension does)."""
        return self.product(terms)

    def leave_one_out_sum(self, terms, weights=None):
        """sum_i w_i * prod_{j != i} terms[j] (w_i = 1 without weights)."""
        terms = list(terms)
        if not terms:
            return self.zero()
        acc = None
        for i in range(len(terms)):
            t = self.product(terms[:i] + terms[i + 1:])
            if weights is not None:
                t = self.mul(weights[i], t)
            acc = t if acc is None else self.add(acc, t)
        return acc

    def add_scaled(self, xs, ys, s):
        """x + s * y for each pair, s a base-field scalar."""
        return [self.add(x, self.mul_scalar(y, s)) for x, y in zip(xs, ys)]

    def horner(self, terms, s):
        """sum_i s^i terms[i] by Horner with ``mul_scalar``, s a
        base-field scalar (reference plonk_common.rs:122-135)."""
        cumul = self.zero()
        for term in reversed(list(terms)):
            cumul = self.add(self.mul_scalar(cumul, s), term)
        return cumul

    def const_mul_add(self, c: int, x, acc):
        """c * x + acc with a constant c known on the host."""
        return self.add(self.mul_base_const(x, c), acc)

    def const_mul(self, c: int, x):
        return self.mul_base_const(x, c)

    def k_const_mul(self, k: int, x):
        """k * x with k a coset shift."""
        return self.mul_base_const(x, k)

    def scalar_mul_add(self, s, b, c):
        """s * b + c with s a base-field challenge."""
        return self.add(self.mul_scalar(b, s), c)

    def exp7(self, x):
        """x^7, the Poseidon S-box, in four multiplications."""
        x2 = self.mul(x, x)
        x3 = self.mul(x2, x)
        x4 = self.mul(x2, x2)
        return self.mul(x3, x4)

    def reduce_with_powers(self, terms, alpha):
        """The vanishing terms combined by ``horner`` (the circuit algebra
        reduces with Reducing gates instead)."""
        return self.horner(terms, alpha)


class HostExtAlgebra(_FusedOpsMixin):
    """The extension field on D-tuples of python ints (the verifier)."""

    def __init__(self, spec: host.FieldSpec):
        self.spec = spec

    def from_int(self, c: int):
        return host.ext_from_base(self.spec, c)

    def zero(self):
        return host.ext_zero(self.spec)

    def one(self):
        return host.ext_one(self.spec)

    def add(self, a, b):
        return host.ext_add(self.spec, a, b)

    def sub(self, a, b):
        return host.ext_sub(self.spec, a, b)

    def mul(self, a, b):
        return host.ext_mul(self.spec, a, b)

    def mul_base_const(self, a, c: int):
        return host.ext_scalar_mul(self.spec, a, c % self.spec.p)

    def add_base_const(self, a, c: int):
        return host.ext_add(self.spec, a, self.from_int(c))

    # a "scalar" is a base-field challenge: an int on the host
    def mul_scalar(self, a, s: int):
        return host.ext_scalar_mul(self.spec, a, s)

    def lift_scalar(self, s: int):
        return host.ext_from_base(self.spec, s)


class HostBaseAlgebra(_FusedOpsMixin):
    """The base field on python ints."""

    def __init__(self, spec: host.FieldSpec):
        self.spec = spec
        self.p = spec.p

    def from_int(self, c: int):
        return c % self.p

    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def mul_base_const(self, a, c: int):
        return a * c % self.p

    def add_base_const(self, a, c: int):
        return (a + c) % self.p

    def mul_scalar(self, a, s: int):
        return a * s % self.p

    def lift_scalar(self, s: int):
        return s % self.p


class DeviceBaseAlgebra(_FusedOpsMixin):
    """The base field on field tensors of the module ``F`` (``gl`` or
    ``bb``) on ``device``: a value is an (m,) tensor over the points of the
    quotient domain, or a 0-d tensor that broadcasts (a constant, a
    challenge).  Each op is a few whole-domain torch ops."""

    def __init__(self, F, device):
        self.F = F
        self.spec = F.SPEC
        self.device = device
        self._consts: Dict[int, torch.Tensor] = {}

    def from_int(self, c: int):
        c %= self.spec.p
        t = self._consts.get(c)
        if t is None:
            t = self._consts[c] = self.F.full((), c, self.device)
        return t

    def zero(self):
        return self.from_int(0)

    def one(self):
        return self.from_int(1)

    def add(self, a, b):
        return self.F.add(a, b)

    def sub(self, a, b):
        return self.F.sub(a, b)

    def mul(self, a, b):
        return self.F.mul(a, b)

    def mul_base_const(self, a, c: int):
        return self.F.mul(a, self.from_int(c))

    def add_base_const(self, a, c: int):
        return self.F.add(a, self.from_int(c))

    # a "scalar" is a base-field challenge: a 0-d tensor
    def mul_scalar(self, a, s):
        return self.F.mul(a, s)

    def lift_scalar(self, s):
        return s

    # the products and sums over many terms run on the stacked terms
    @staticmethod
    def _stack(terms):
        return torch.stack(torch.broadcast_tensors(*terms))

    def product(self, terms):
        """One log-depth ``batch_prod`` over the stacked terms."""
        terms = list(terms)
        if len(terms) < 2:
            return super().product(terms)
        return self.F.batch_prod(self._stack(terms), axis=0)

    def leave_one_out_sum(self, terms, weights=None):
        """From exclusive prefix and suffix products, two scans."""
        terms = list(terms)
        if not terms:
            return self.zero()
        F = self.F
        st = self._stack(terms)
        one = F.ones((1,) + st.shape[1:], st.device)
        pre = torch.cat([one, F.cumprod(st, axis=0)[:-1]])
        suf = torch.cat([one, F.cumprod(st.flip(0), axis=0)[:-1]]).flip(0)
        loo = F.mul(pre, suf)
        if weights is not None:
            loo = F.mul(loo, self._stack(weights))
        return F.batch_sum(loo, axis=0)

    def add_scaled(self, xs, ys, s):
        F = self.F
        return list(F.add(self._stack(xs), F.mul(self._stack(ys), s))
                    .unbind(0))

    def horner(self, terms, s):
        """One power-weighted sum over the stacked terms."""
        terms = list(terms)
        if not terms:
            return self.zero()
        return reduce_with_powers_stacked(self.F, self._stack(terms), s)


def reduce_with_powers_stacked(F, terms: torch.Tensor, alpha) -> torch.Tensor:
    """sum_i alpha^i terms[i] over a (k, m) stack, alpha a 0-d tensor
    (reference plonk_common.rs:122-135)."""
    k = terms.shape[0]
    pows = torch.cat([F.ones((1,), terms.device),
                      F.cumprod(alpha.expand(k - 1), axis=0)])
    shape = (k,) + (1,) * (terms.dim() - 1)
    return F.batch_sum(F.mul(terms, pows.reshape(shape)), axis=0)


class EvaluationVars:
    """The local constants and wires of a row and the public-input hash,
    as algebra values (reference plonk/vars.rs)."""

    def __init__(self, local_constants: Sequence, local_wires: Sequence,
                 public_inputs_hash: Sequence):
        self.local_constants = list(local_constants)
        self.local_wires = list(local_wires)
        self.public_inputs_hash = list(public_inputs_hash)


class Gate:
    """Base gate.  Subclasses define id() (the reference's Rust Debug
    string), num_wires(), num_constants(), degree(), num_constraints(),
    eval_unfiltered() (over an algebra) and, where they fill wires,
    generators(); the two Poseidon gates also define the stacked
    eval_unfiltered_device(); ``num_ops`` is the slot capacity of a
    slot-packed gate."""

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

    def eval_unfiltered(self, A, vars: EvaluationVars) -> List:
        """The constraints at one point, as algebra values."""
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


# -- the host forms --------------------------------------------------------


def ext_algebra_mul(A, spec, a, b):
    """a * b in F_D[X]/(X^D - W), a and b D-vectors of algebra values (the
    reference's ExtensionAlgebra, field/src/extension_algebra.rs:13-128)."""
    d, w = spec.ext_degree, spec.ext_w
    acc = [None] * (2 * d - 1)
    for i in range(d):
        for j in range(d):
            t = A.mul(a[i], b[j])
            k = i + j
            acc[k] = t if acc[k] is None else A.add(acc[k], t)
    out = list(acc[:d])
    for k in range(d, 2 * d - 1):
        out[k - d] = A.add(out[k - d], A.mul_base_const(acc[k], w))
    return out


def ext_algebra_scalar_mul(A, a, s):
    return [A.mul(x, s) for x in a]


def ext_algebra_sub(A, a, b):
    return [A.sub(x, y) for x, y in zip(a, b)]


def ext_algebra_add(A, a, b):
    return [A.add(x, y) for x, y in zip(a, b)]


def compute_filter_a(A, row: int, group_range, s, many_selector: bool):
    """``compute_filter`` at one point, over the algebra ``A``."""
    terms = [A.sub(A.from_int(i), s)
             for i in range(group_range[0], group_range[1]) if i != row]
    if many_selector:
        terms.append(A.sub(A.from_int(UNUSED_SELECTOR % A.spec.p), s))
    return A.mul_many(terms)


def eval_filtered(A, gate: Gate, vars: EvaluationVars, row: int,
                  selector_index: int, group_range, num_selectors: int,
                  num_lookup_selectors: int, constraints_acc: List) -> None:
    """acc_j = filter * c_j + acc_j over the gate's unfiltered constraints
    c_j, whose constants start after the selector columns (reference
    gate.rs:162-243)."""
    filt = compute_filter_a(A, row, group_range,
                            vars.local_constants[selector_index],
                            num_selectors > 1)
    inner = EvaluationVars(
        vars.local_constants[num_selectors + num_lookup_selectors:],
        vars.local_wires, vars.public_inputs_hash)
    for j, c in enumerate(gate.eval_unfiltered(A, inner)):
        constraints_acc[j] = A.mul_add(filt, c, constraints_acc[j])
