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
No lookup terms: lookup circuits are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..field import host
from ..gates.base import (DeviceBaseAlgebra, EvaluationVars, compute_filter,
                          eval_filtered)


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


def reduce_with_powers(F, terms: torch.Tensor, alpha) -> torch.Tensor:
    """sum_i alpha^i terms[i] over a (k, m) stack (reference
    plonk_common.rs:122-135)."""
    k = terms.shape[0]
    pows = torch.cat([F.ones((1,), terms.device),
                      F.cumprod(alpha.expand(k - 1), axis=0)])
    return F.batch_sum(F.mul(terms, pows[:, None]), axis=0)


def eval_vanishing_poly(F, common, x, l_0_x, wires, constants, pi_hash,
                        local_zs, next_zs, partial_products, s_sigmas,
                        betas, gammas, alphas) -> List[torch.Tensor]:
    """One combined (m,) value per alpha challenge (reference
    vanishing_poly.rs:57-180): the z(1) terms, the partial-product checks,
    then the gate constraints, combined with powers of alpha.  ``wires``
    (num_wires, m), ``constants`` and ``s_sigmas`` (k, m), ``local_zs`` /
    ``next_zs`` (nch, m), ``partial_products`` (nch * num_pp, m)."""
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

    terms = torch.cat([torch.stack(z_1_terms)] + pp_terms
                      + [constraint_terms])
    return [reduce_with_powers(F, terms, alphas[i])
            for i in range(common.config.num_challenges)]


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
                          alphas: Sequence[int]) -> List:
    """One combined value per alpha (reference vanishing_poly.rs:57-180),
    the terms in ``eval_vanishing_poly``'s order: the z(1) terms, the
    partial-product checks, the gate constraints.  ``l_0_x`` may be a
    function, called after the gate constraints: the circuit algebra then
    emits its gates where the reference does (vanishing_poly.rs:902)."""
    max_degree = common.quotient_degree_factor
    num_prods = common.num_partial_products
    num_routed = common.config.num_routed_wires
    constraint_terms = evaluate_gate_constraints_a(A, common, vars)
    if callable(l_0_x):
        l_0_x = l_0_x()
    s_ids = [A.k_const_mul(common.k_is[j], x) for j in range(num_routed)]
    z_1_terms, pp_terms = [], []
    for i in range(common.config.num_challenges):
        z_x, z_gx = local_zs[i], next_zs[i]
        z_1_terms.append(A.mul_sub(l_0_x, z_x, l_0_x))
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
    terms = z_1_terms + pp_terms + constraint_terms
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
