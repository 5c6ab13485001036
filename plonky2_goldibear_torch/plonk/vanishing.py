"""Vanishing-polynomial evaluation over the quotient domain
(reference plonky2/src/plonk/vanishing_poly.rs:57-180,700-780,
util/partial_products.rs:53-80, plonk/plonk_common.rs:105-135).

Terms are stacked into (k, npoints) tensors so each step is a few whole-
domain torch ops rather than one op per wire or per term: on the card the
plain-torch field arithmetic is bound by launches.  Field arithmetic is
exact, so the stacked order gives the JAX package's values bit for bit.
The challenges are scalar tensors of the field module ``F`` (``gl`` or
``bb``).  No lookup terms: lookup circuits are
not ported yet.
"""

from __future__ import annotations

from typing import List

import torch

from ..gates.base import compute_filter


def evaluate_gate_constraints(F, common, wires: torch.Tensor,
                              constants: torch.Tensor, pi_hash: List,
                              m: int) -> torch.Tensor:
    """(num_gate_constraints, m): at each constraint position, the sum over
    gates of filter * constraint (reference vanishing_poly.rs:703-738)."""
    si = common.selectors_info
    ns = si.num_selectors
    acc = F.zeros((common.num_gate_constraints, m), wires.device)
    for i, gate in enumerate(common.gates):
        k = gate.num_constraints()
        if k == 0:
            continue
        sel = si.selector_indices[i]
        filt = compute_filter(i, si.groups[sel], constants[sel], ns > 1, F)
        vals = gate.eval_unfiltered_device(F, wires, constants[ns:], pi_hash)
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
