"""Vanishing-polynomial evaluation over the quotient domain
(reference plonky2/src/plonk/vanishing_poly.rs:57-180,700-780,
util/partial_products.rs:53-80, plonk/plonk_common.rs:105-135).

Terms are stacked into (k, npoints) tensors so each step is a few whole-
domain torch ops rather than one op per wire or per term: on the card the
plain-torch field arithmetic is bound by launches.  Field arithmetic is
exact, so the stacked order gives the JAX package's values bit for bit.
The challenges are scalar tensors of the field module ``F`` (``gl`` or
``bb``).

The verifier evaluates the same polynomial at one point zeta: the ``*_a``
functions work over an algebra ``A`` (``gates/base.py``), each gate
through its ``eval_unfiltered`` (the JAX package's ``plonk/vanishing.py``,
generic form).  ``HostExtAlgebra`` evaluates it on the host with the
challenges as python ints (``plonk/verifier.py``, with
``eval_l_0_host``); ``CircuitExtAlgebra`` builds the same evaluation into
a circuit, the challenges as targets (``recursion/recursive_verifier.py``).

The logUp terms of a lookup circuit (``check_lookup_constraints_a``) are
written once over an algebra too: the verifier and the circuit call them
at zeta, and the prover over ``DeviceBaseAlgebra`` on the whole quotient
domain, whose ``product``, ``leave_one_out_sum``, ``add_scaled`` and
``horner`` run on the stacked terms of a slot group.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..field import host
from ..gates.base import (DeviceBaseAlgebra, EvaluationVars, compute_filter,
                          eval_filtered, reduce_with_powers_stacked)
from ..gates.lookup_gates import LookupGate, LookupTableGate
from ..gates.selectors import (LOOKUP_SEL_INIT_SRE, LOOKUP_SEL_LAST_LDC,
                               LOOKUP_SEL_START_END, LOOKUP_SEL_TRANS_LDC,
                               LOOKUP_SEL_TRANS_SRE)


def gate_constraints_device(F, gate, wires: torch.Tensor,
                            constants: torch.Tensor, pi_hash: List
                            ) -> torch.Tensor:
    """(num_constraints, m): ``gate``'s unfiltered constraints at every
    point, ``wires`` (num_wires, m), ``constants`` the gate's (k, m).  A
    gate with a stacked form (Poseidon, Poseidon2-BB) runs it; every other
    gate runs its ``eval_unfiltered`` over ``DeviceBaseAlgebra``, one
    whole-domain op per algebra op."""
    stacked = getattr(gate, "eval_unfiltered_device", None)
    if stacked is not None:
        return stacked(F, wires, constants, pi_hash)
    m = wires.shape[-1]
    vals = gate.eval_unfiltered(
        DeviceBaseAlgebra(F, wires.device),
        EvaluationVars(constants.unbind(0), wires.unbind(0), pi_hash))
    if not vals:
        return F.zeros((0, m), wires.device)
    return torch.stack([v.expand(m) for v in vals])


def evaluate_gate_constraints(F, common, wires: torch.Tensor,
                              constants: torch.Tensor, pi_hash: List,
                              m: int) -> torch.Tensor:
    """(num_gate_constraints, m): at each constraint position, the sum over
    gates of filter * constraint (reference vanishing_poly.rs:703-738)."""
    si = common.selectors_info
    ns = si.num_selectors
    gate_constants = constants[ns + common.num_lookup_selectors:]
    acc = F.zeros((common.num_gate_constraints, m), wires.device)
    for i, gate in enumerate(common.gates):
        k = gate.num_constraints()
        if k == 0:
            continue
        sel = si.selector_indices[i]
        filt = compute_filter(i, si.groups[sel], constants[sel], ns > 1, F)
        vals = gate_constraints_device(F, gate, wires, gate_constants,
                                       pi_hash)
        acc[:k] = F.add(acc[:k], F.mul(vals, filt))
    return acc


def check_partial_products(F, numerators, denominators, partials, z_x,
                           z_gx, max_degree: int) -> torch.Tensor:
    """(nchunks, m): prev * prod(numerator chunk) - next * prod(denominator
    chunk) (reference util/partial_products.rs:53-80).  numerators and
    denominators are (n, m); partials (nchunks - 1, m)."""
    n, m = numerators.shape
    nchunks = -(-n // max_degree)
    assert nchunks == partials.shape[0] + 1
    pad = nchunks * max_degree - n
    ones = F.ones((pad, m), numerators.device)
    num = F.batch_prod(torch.cat([numerators, ones]).reshape(
        nchunks, max_degree, m), axis=1)
    den = F.batch_prod(torch.cat([denominators, ones]).reshape(
        nchunks, max_degree, m), axis=1)
    prev = torch.cat([z_x[None], partials])
    nxt = torch.cat([partials, z_gx[None]])
    return F.sub(F.mul(prev, num), F.mul(nxt, den))


def eval_vanishing_poly(F, common, x, l_0_x, wires, constants, pi_hash,
                        local_zs, next_zs, partial_products, s_sigmas,
                        betas, gammas, alphas, deltas=(), local_lookup_zs=None,
                        next_lookup_zs=None, lut_re_evals=()
                        ) -> List[torch.Tensor]:
    """One combined (m,) value per alpha challenge (reference
    vanishing_poly.rs:57-180): the z(1) terms, the partial-product checks,
    a lookup circuit's logUp terms, then the gate constraints, combined
    with powers of alpha.  ``wires`` (num_wires, m), ``constants`` and
    ``s_sigmas`` (k, m), ``local_zs`` / ``next_zs`` (nch, m),
    ``partial_products`` (nch * num_pp, m), ``local_lookup_zs`` /
    ``next_lookup_zs`` (nch * num_lookup_polys, m); ``deltas`` four a
    challenge, ``lut_re_evals`` one list of table values a challenge."""
    max_degree = common.quotient_degree_factor
    num_prods = common.num_partial_products
    num_routed = common.config.num_routed_wires
    m = x.shape[-1]

    constraint_terms = evaluate_gate_constraints(F, common, wires, constants,
                                                 pi_hash, m)
    k_is = F.from_ints(common.k_is, x.device)
    s_ids = F.mul(k_is[:, None], x[None, :])
    routed = wires[:num_routed]

    z_1_terms, pp_terms = [], []
    for i in range(common.config.num_challenges):
        z_x, z_gx = local_zs[i], next_zs[i]
        z_1_terms.append(F.sub(F.mul(l_0_x, z_x), l_0_x))
        wvpg = F.add(routed, gammas[i])
        numerators = F.add(F.mul(s_ids, betas[i]), wvpg)
        denominators = F.add(F.mul(s_sigmas, betas[i]), wvpg)
        pp_terms.append(check_partial_products(
            F, numerators, denominators,
            partial_products[i * num_prods:(i + 1) * num_prods],
            z_x, z_gx, max_degree))

    lookup_terms = []
    if common.num_lookup_polys:
        A = DeviceBaseAlgebra(F, x.device)
        npoly = common.num_lookup_polys
        ns = common.selectors_info.num_selectors
        selectors = constants[ns:ns + common.num_lookup_selectors].unbind(0)
        lw = wires.unbind(0)
        for i in range(common.config.num_challenges):
            lookup_terms += [t.expand(m) for t in check_lookup_constraints_a(
                A, common, lw,
                local_lookup_zs[npoly * i:npoly * (i + 1)].unbind(0),
                next_lookup_zs[npoly * i:npoly * (i + 1)].unbind(0),
                selectors, deltas[4 * i:4 * (i + 1)], lut_re_evals[i])]
    terms = torch.cat([torch.stack(z_1_terms)] + pp_terms
                      + ([torch.stack(lookup_terms)] if lookup_terms else [])
                      + [constraint_terms])
    return [reduce_with_powers_stacked(F, terms, alphas[i])
            for i in range(common.config.num_challenges)]


# -- the lookup terms (reference vanishing_poly.rs:31-52, 370-535) ----------


def get_lut_poly_coeffs(common, lut_index: int, delta_b: int) -> List[int]:
    """The table polynomial's coefficients: inp + B * out a entry, zero
    padded to the table rows' slots, reversed (vanishing_poly.rs:31-52)."""
    p = common.spec.p
    lut = common.luts[lut_index]
    slots = LookupTableGate.num_slots_of(common.config)
    degree = slots * -(-len(lut) // slots)
    coeffs = [(inp + delta_b * out) % p for inp, out in lut]
    coeffs += [0] * (degree - len(coeffs))
    coeffs.reverse()
    return coeffs


def get_lut_re_evals(common, deltas: Sequence[int]) -> List[List[int]]:
    """A challenge's table polynomial of each table at its delta, on the
    host: the value the running sum ends at (reference prover.rs:757-784);
    ``deltas`` four a challenge (A, B, alpha, delta)."""
    p = common.spec.p
    out = []
    for i in range(common.config.num_challenges):
        d_b, d_delta = deltas[4 * i + 1], deltas[4 * i + 3]
        evals = []
        for li in range(len(common.luts)):
            acc = 0
            for c in reversed(get_lut_poly_coeffs(common, li, d_b)):
                acc = (acc * d_delta + c) % p
            evals.append(acc)
        out.append(evals)
    return out


def check_lookup_constraints_a(A, common, lw: Sequence, local_lookup_zs,
                               next_lookup_zs, lookup_selectors, deltas4,
                               lut_re_evals) -> List:
    """The logUp constraints of one challenge (reference
    vanishing_poly.rs:370-535): the running sum ``re`` of the table
    entries reaches each table's polynomial at delta, and the partial sums
    of multiplicity / (alpha - looked) less 1 / (alpha - looking) close to
    zero, group by group.  ``lw`` the local wires, ``deltas4`` (A, B,
    alpha, delta) scalars, ``lut_re_evals`` one scalar a table."""
    num_lu = LookupGate.num_slots_of(common.config)
    num_lut = LookupTableGate.num_slots_of(common.config)
    lu_degree = common.quotient_degree_factor - 1
    num_sldc = len(local_lookup_zs) - 1
    lut_degree = -(-num_lut // num_sldc)
    delta_a, delta_b, delta_alpha, delta_delta = deltas4
    z_re, next_z_re = local_lookup_zs[0], next_lookup_zs[0]
    z_x = list(local_lookup_zs[1:])
    z_gx = list(next_lookup_zs[1:])
    sel = lookup_selectors

    lut_ins = [lw[LookupTableGate.wire_ith_looked_inp(s)]
               for s in range(num_lut)]
    lut_outs = [lw[LookupTableGate.wire_ith_looked_out(s)]
                for s in range(num_lut)]
    looked = A.add_scaled(lut_ins, lut_outs, delta_a)
    looking = A.add_scaled(
        [lw[LookupGate.wire_ith_looking_inp(s)] for s in range(num_lu)],
        [lw[LookupGate.wire_ith_looking_out(s)] for s in range(num_lu)],
        delta_a)
    combos = A.add_scaled(lut_ins, lut_outs, delta_b)
    alpha = A.lift_scalar(delta_alpha)
    m_looked = [A.sub(alpha, c) for c in looked]
    m_looking = [A.sub(alpha, c) for c in looking]

    out = [A.mul(sel[LOOKUP_SEL_LAST_LDC], z_x[num_sldc - 1]),
           A.mul(sel[LOOKUP_SEL_INIT_SRE], z_x[0]),
           A.mul(sel[LOOKUP_SEL_INIT_SRE], z_re)]
    for r in range(LOOKUP_SEL_START_END, common.num_lookup_selectors):
        out.append(A.mul(sel[r], A.sub(z_re, A.lift_scalar(
            lut_re_evals[r - LOOKUP_SEL_START_END]))))
    # the running sum's row step, Horner in delta
    cur_sum = A.horner(list(reversed(combos)) + [next_z_re], delta_delta)
    out.append(A.mul(sel[LOOKUP_SEL_TRANS_SRE], A.sub(z_re, cur_sum)))
    for poly in range(num_sldc):
        lut_rng = range(poly * lut_degree,
                        min((poly + 1) * lut_degree, num_lut))
        lu_rng = range(poly * lu_degree, min((poly + 1) * lu_degree, num_lu))
        lut_prod = A.product([m_looked[i] for i in lut_rng])
        lu_prod = A.product([m_looking[i] for i in lu_rng])
        lu_sum_prods = A.leave_one_out_sum([m_looking[i] for i in lu_rng])
        lut_sum_prods_mul = A.leave_one_out_sum(
            [m_looked[i] for i in lut_rng],
            weights=[lw[LookupTableGate.wire_ith_multiplicity(i)]
                     for i in lut_rng])
        prev = z_gx[num_sldc - 1] if poly == 0 else z_x[poly - 1]
        sum_trans = A.sub(A.mul(lut_prod, A.sub(z_x[poly], prev)),
                          lut_sum_prods_mul)
        out.append(A.mul(sel[LOOKUP_SEL_TRANS_SRE], sum_trans))
        ldc_trans = A.add(A.mul(lu_prod, A.sub(z_x[poly], prev)),
                          lu_sum_prods)
        out.append(A.mul(sel[LOOKUP_SEL_TRANS_LDC], ldc_trans))
    return out


# -- at one point, over an algebra (the verifier) ---------------------------


def evaluate_gate_constraints_a(A, common, vars: EvaluationVars) -> List:
    """At each constraint position, the sum over gates of filter *
    constraint (reference vanishing_poly.rs:703-738)."""
    si = common.selectors_info
    constraints = [A.zero()] * common.num_gate_constraints
    for i, gate in enumerate(common.gates):
        sel = si.selector_indices[i]
        eval_filtered(A, gate, vars, i, sel, si.groups[sel],
                      si.num_selectors, common.num_lookup_selectors,
                      constraints)
    return constraints


def check_partial_products_a(A, numerators: Sequence,
                             denominators: Sequence, partials: Sequence,
                             z_x, z_gx, max_degree: int) -> List:
    """prev * prod(numerator chunk) - next * prod(denominator chunk) per
    chunk (reference util/partial_products.rs:53-80)."""
    n = len(numerators)
    accs = [z_x] + list(partials) + [z_gx]
    out = []
    for chunk, lo in enumerate(range(0, n, max_degree)):
        hi = min(lo + max_degree, n)
        num_prod = A.mul_many(numerators[lo:hi])
        den_prod = A.mul_many(denominators[lo:hi])
        out.append(A.mul_sub(accs[chunk], num_prod,
                             A.mul(accs[chunk + 1], den_prod)))
    assert len(out) == len(partials) + 1
    return out


def eval_vanishing_poly_a(A, common, x, l_0_x, vars: EvaluationVars,
                          local_zs: Sequence, next_zs: Sequence,
                          partial_products: Sequence, s_sigmas: Sequence,
                          betas: Sequence[int], gammas: Sequence[int],
                          alphas: Sequence[int], deltas: Sequence = (),
                          local_lookup_zs: Sequence = (),
                          next_lookup_zs: Sequence = (),
                          lut_re_evals: Sequence = ()) -> List:
    """One combined value per alpha (reference vanishing_poly.rs:57-180),
    the terms in ``eval_vanishing_poly``'s order: the z(1) terms, the
    partial-product checks, the lookup terms, the gate constraints.
    ``l_0_x`` may be a function, called after the gate constraints: the
    circuit algebra then emits its gates where the reference does
    (vanishing_poly.rs:902), a challenge's lookup terms right after its
    z(1) term."""
    max_degree = common.quotient_degree_factor
    num_prods = common.num_partial_products
    num_routed = common.config.num_routed_wires
    npoly = common.num_lookup_polys
    constraint_terms = evaluate_gate_constraints_a(A, common, vars)
    ns = common.selectors_info.num_selectors
    lookup_selectors = vars.local_constants[
        ns:ns + common.num_lookup_selectors]
    if callable(l_0_x):
        l_0_x = l_0_x()
    s_ids = [A.k_const_mul(common.k_is[j], x) for j in range(num_routed)]
    z_1_terms, pp_terms, lookup_terms = [], [], []
    for i in range(common.config.num_challenges):
        z_x, z_gx = local_zs[i], next_zs[i]
        z_1_terms.append(A.mul_sub(l_0_x, z_x, l_0_x))
        if npoly:
            lookup_terms += check_lookup_constraints_a(
                A, common, vars.local_wires,
                local_lookup_zs[npoly * i:npoly * (i + 1)],
                next_lookup_zs[npoly * i:npoly * (i + 1)],
                lookup_selectors, deltas[4 * i:4 * (i + 1)],
                lut_re_evals[i])
        gamma = A.lift_scalar(gammas[i])
        numerators, denominators = [], []
        for j in range(num_routed):
            wvpg = A.add(vars.local_wires[j], gamma)
            numerators.append(A.scalar_mul_add(betas[i], s_ids[j], wvpg))
            denominators.append(A.scalar_mul_add(betas[i], s_sigmas[j],
                                                 wvpg))
        pp_terms += check_partial_products_a(
            A, numerators, denominators,
            partial_products[i * num_prods:(i + 1) * num_prods],
            z_x, z_gx, max_degree)
    terms = z_1_terms + pp_terms + lookup_terms + constraint_terms
    return [A.reduce_with_powers(terms, alphas[i])
            for i in range(common.config.num_challenges)]


def eval_l_0_host(A, n: int, x, x_pow_n):
    """L_0(x) = (x^n - 1) / (n (x - 1)) on the host extension algebra
    (reference plonk_common.rs:59-70)."""
    spec = A.spec
    one = A.one()
    if tuple(x) == tuple(one):
        return one
    denom = A.mul_base_const(A.sub(x, one), n % spec.p)
    return host.ext_mul(spec, A.sub(x_pow_n, one), host.ext_inv(spec, denom))
