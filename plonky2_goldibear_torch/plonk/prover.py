"""The PLONK prover, sync transcript (reference plonky2/src/plonk/prover.rs:
136-926; the JAX package's ``plonk/prover.py:_internal_prove``).

Phases: wire commitment, partial products and Z, their commitment, the
quotient over the whole quotient domain, its commitment, the openings at
zeta and g*zeta, then FRI.  Fiat-Shamir runs on the host between phases;
every batched phase runs on the circuit's device.  ``prove`` returns the
proof and fills ``timings`` (seconds per phase, each ended by a device
synchronise) when a dict is passed.  The field module ``F`` (``gl`` or
``bb``), its extension ``E`` and the hasher (Poseidon-GL or Poseidon2-BB)
are the circuit's (``circuit_data.load_circuit`` picks them).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import device as devmod
from ..field import fft as fftm
from ..field import host
from ..fri import prover as fri_prover
from ..fri.oracle import PolynomialBatch
from ..hash.challenger import Challenger
from ..iop.generator import Rng, rand_field_element
from . import vanishing
from .proof import OpeningSet, Proof, ProofWithPublicInputs
from .witness_transfer import WitnessTransfer

MAX_PERM_ARG_RETRIES = 3


class InvZeroPermArg(Exception):
    """Permutation-argument division by zero (reference prover.rs:515)."""


@contextmanager
def phase(timings: Optional[Dict[str, float]], name: str, device):
    """Add the seconds of the block, ended by a device synchronise, to
    ``timings[name]`` when ``timings`` is a dict."""
    t0 = time.perf_counter()
    yield
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def prove(circuit, device=None, timings: Optional[Dict[str, float]] = None,
          rng: Optional[Rng] = None) -> ProofWithPublicInputs:
    """Prove ``circuit`` (a ``circuit_data.Circuit``: its wires came either
    as data through ``load_circuit`` or from witness generation through
    ``CircuitData.circuit``) on ``device`` (the card unless the caller asks
    for the CPU).  On a permutation-argument
    division by zero the random wire of the public-input gate is drawn
    again, ``rand_field_element(p, rng)`` (``iop/generator.py``: a
    ``NonRandomRng`` for the reference's deterministic draws, else a numpy
    generator, fresh from the OS when none is given), and the proof
    retried (reference prover.rs:136-230, the anti-#456 loop); the
    circuit's own wires stay as they were."""
    dev = devmod.resolve(device)
    if dev != circuit.device:
        raise ValueError(f"circuit was loaded on {circuit.device}, "
                         f"not {dev}")
    wires = WitnessTransfer(circuit.F, circuit.wires)
    for retry in range(MAX_PERM_ARG_RETRIES):
        if retry:
            assert circuit.random_wire is not None, \
                "perm-arg failure with no random wire"
            if rng is None:
                rng = np.random.default_rng()
            row, col = circuit.random_wire
            wires.set(row, col, rand_field_element(circuit.F.P, rng))
        try:
            return _internal_prove(circuit, wires.device_values(), timings)
        except InvZeroPermArg:
            continue
    raise InvZeroPermArg("too many permutation argument failures")


def _scalars(F, values: List[int], device) -> List[torch.Tensor]:
    arr = F.from_ints([int(v) % F.P for v in values], device)
    return list(arr.unbind(0)) if len(values) else []


def _ext_scalar(F, value, device):
    return tuple(_scalars(F, list(value), device))


def partial_products(F, common, routed, s_id, sigmas, betas, gammas):
    """Z and partial-product columns per challenge (reference
    prover.rs:449-546): batch (nch * (1 + num_pp), n), and whether any
    denominator was zero."""
    qdf = common.quotient_degree_factor
    num_routed, n = routed.shape
    nch = len(betas)
    nchunks = -(-num_routed // qdf)
    dev = routed.device
    beta = torch.stack(list(betas))[:, None, None]
    gamma = torch.stack(list(gammas))[:, None, None]
    # all challenges at once: (nch, num_routed, n)
    numer = F.add(F.add(routed[None], F.mul(s_id[None], beta)), gamma)
    denom = F.add(F.add(routed[None], F.mul(sigmas[None], beta)), gamma)
    any_zero = F.is_zero(denom).any()
    quot = F.mul(numer, F.inv(denom))
    pad = nchunks * qdf - num_routed
    quot = torch.cat([quot, F.ones((nch, pad, n), dev)], dim=1)
    chunk_prods = F.batch_prod(quot.reshape(nch, nchunks, qdf, n), axis=2)
    incl = F.cumprod(F.batch_prod(chunk_prods, axis=1), axis=-1)
    z = torch.cat([F.ones((nch, 1), dev), incl[:, :-1]], dim=1)
    running = F.cumprod(chunk_prods, axis=1)
    pps = F.mul(running[:, :common.num_partial_products], z[:, None])
    return torch.cat([z, pps.reshape(-1, n)]), any_zero


class _QuotientData:
    """Circuit-static tensors of the quotient domain (cached per circuit)."""

    def __init__(self, circuit):
        common = circuit.common
        dev = circuit.device
        F = circuit.F
        spec = common.spec
        p = spec.p
        n = common.degree
        qdb = host.log2_ceil(common.quotient_degree_factor)
        rate_bits = common.config.fri_config.rate_bits
        assert qdb <= rate_bits
        self.step = 1 << (rate_bits - qdb)
        self.next_step = 1 << qdb
        self.m = m = n << qdb
        w = spec.two_adic_generator(common.degree_bits + qdb)
        self.shifted_xs = F.mul_const(fftm.powers(w, m, dev, F),
                                      spec.coset_shift)
        tau = pow(w, n, p)
        gf_n = pow(spec.coset_shift, n, p)
        zh_small = [(gf_n * pow(tau, i, p) - 1) % p for i in range(1 << qdb)]
        self.zh_inv = F.from_ints(host.batch_inv(zh_small, p), dev).repeat(
            m >> qdb)
        zh = F.from_ints(zh_small, dev).repeat(m >> qdb)
        x_minus_1 = F.sub(self.shifted_xs, F.ones((), dev))
        self.l_0 = F.mul(zh, F.inv(F.mul_const(x_minus_1, n % p)))
        xs = fftm.powers(spec.two_adic_generator(common.degree_bits), n, dev,
                         F)
        k_arr = F.from_ints(common.k_is, dev)
        self.s_id = F.mul(k_arr[:, None], xs[None, :])


def _quotient_data(circuit) -> _QuotientData:
    q = circuit.cache.get("quotient_data")
    if q is None:
        q = circuit.cache["quotient_data"] = _QuotientData(circuit)
    return q


def quotient_chunks(circuit, qd: _QuotientData, cs_lde, wires_lde,
                    zs_pp_lde, pi_hash, betas, gammas, alphas):
    """Quotient polynomial chunks (nch * qdf, n): the vanishing polynomial
    over the quotient domain, divided by Z_H, coset-iFFT'd and split
    (reference prover.rs:690-926)."""
    common = circuit.common
    F = circuit.F
    cs = cs_lde[:, ::qd.step]
    wires = wires_lde[:, ::qd.step]
    zs_pp = zs_pp_lde[:, ::qd.step]
    zs_pp_next = torch.roll(zs_pp, -qd.next_step, dims=-1)
    c0, c1 = common.constants_range()
    s0, s1 = common.sigmas_range()
    z0, z1 = common.zs_range()
    pp0, pp1 = common.partial_products_range()
    values = vanishing.eval_vanishing_poly(
        F, common, qd.shifted_xs, qd.l_0, wires, cs[c0:c1], pi_hash,
        zs_pp[z0:z1], zs_pp_next[z0:z1], zs_pp[pp0:pp1], cs[s0:s1],
        betas, gammas, alphas)
    n = common.degree
    # the challenges' quotients in one batched coset iFFT
    q_values = F.mul(torch.stack([v.expand(qd.m) for v in values]),
                     qd.zh_inv)
    q_coeffs = fftm.coset_ifft(q_values, common.spec.coset_shift, F)
    return q_coeffs[:, :common.quotient_degree].reshape(-1, n)


def _ext_powers(E, z, n: int):
    """[1, z, ..., z^(n-1)] as an ext (n,) array (log-doubling)."""
    dev = z[0].device
    pows = E.ones((1,), dev)
    z_pow = z
    length = 1
    while length < n:
        shifted = E.mul(pows, z_pow)
        pows = tuple(torch.cat([a, b]) for a, b in zip(pows, shifted))
        z_pow = E.mul(z_pow, z_pow)
        length *= 2
    return tuple(c[:n] for c in pows)


def eval_at(F, coeffs: torch.Tensor, pows) -> tuple:
    """Every poly of a coefficient batch (P, n) at the point whose powers
    are ``pows``: D arrays of (P,)."""
    return tuple(F.batch_sum(F.mul(coeffs, pw[None, :]), axis=-1)
                 for pw in pows)


def opening_set(F, E, common, zeta, oracles) -> OpeningSet:
    """Openings at zeta and g * zeta (reference proof.rs:347-386)."""
    spec = common.spec
    dev = oracles[0].coeffs.device
    g = spec.two_adic_generator(common.degree_bits)
    zeta_next = host.ext_scalar_mul(spec, zeta, g)
    n = common.degree
    pz = _ext_powers(E, _ext_scalar(F, zeta, dev), n)
    pzn = _ext_powers(E, _ext_scalar(F, zeta_next, dev), n)
    cs, wires, zs_pp, quotient = oracles
    parts = [eval_at(F, cs.coeffs, pz), eval_at(F, wires.coeffs, pz),
             eval_at(F, zs_pp.coeffs, pz), eval_at(F, zs_pp.coeffs, pzn),
             eval_at(F, quotient.coeffs, pz)]
    flat = F.to_ints(torch.cat([torch.stack(p, dim=1) for p in parts]))
    vals = [tuple(int(v) for v in row) for row in flat]
    sizes = [p[0].shape[0] for p in parts]
    out, off = [], 0
    for s in sizes:
        out.append(vals[off:off + s])
        off += s
    cs_eval, wires_eval, zs_pp_eval, zs_pp_next_eval, quotient_eval = out
    c0, c1 = common.constants_range()
    s0, s1 = common.sigmas_range()
    z0, z1 = common.zs_range()
    pp0, pp1 = common.partial_products_range()
    return OpeningSet(
        constants=cs_eval[c0:c1], plonk_sigmas=cs_eval[s0:s1],
        wires=wires_eval, plonk_zs=zs_pp_eval[z0:z1],
        plonk_zs_next=zs_pp_next_eval[z0:z1],
        partial_products=zs_pp_eval[pp0:pp1],
        quotient_polys=quotient_eval)


def _internal_prove(circuit, wires_values, timings) -> ProofWithPublicInputs:
    common = circuit.common
    config = common.config
    dev = circuit.device
    F, hasher = circuit.F, circuit.hasher
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    nch = config.num_challenges
    qd = _quotient_data(circuit)
    public_inputs_hash = hasher.hash_no_pad_host(circuit.public_inputs)

    def commit_values(values):
        return PolynomialBatch.from_values(values, rate_bits, cap_height, F,
                                           hasher)

    with phase(timings, "wires_commit", dev):
        wires_commitment = commit_values(wires_values)
        wires_cap = wires_commitment.cap_host()

    challenger = Challenger(common.spec, hasher)
    challenger.observe_hash(circuit.circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(wires_cap)
    betas = challenger.get_n_challenges(nch)
    gammas = challenger.get_n_challenges(nch)

    with phase(timings, "partial_products", dev):
        zs_pp, any_zero = partial_products(
            F, common, wires_values[:config.num_routed_wires], qd.s_id,
            circuit.sigmas, _scalars(F, betas, dev),
            _scalars(F, gammas, dev))
        if bool(any_zero):
            raise InvZeroPermArg()

    with phase(timings, "zs_pp_commit", dev):
        zs_pp_commitment = commit_values(zs_pp)
        zs_pp_cap = zs_pp_commitment.cap_host()
    challenger.observe_cap(zs_pp_cap)
    alphas = challenger.get_n_challenges(nch)

    with phase(timings, "quotient", dev):
        chunks = quotient_chunks(
            circuit, qd, circuit.constants_sigmas_commitment.lde,
            wires_commitment.lde, zs_pp_commitment.lde,
            _scalars(F, public_inputs_hash, dev), _scalars(F, betas, dev),
            _scalars(F, gammas, dev), _scalars(F, alphas, dev))

    with phase(timings, "quotient_commit", dev):
        quotient_commitment = PolynomialBatch(chunks, rate_bits, cap_height,
                                              F, hasher)
        quotient_cap = quotient_commitment.cap_host()
    challenger.observe_cap(quotient_cap)

    zeta = challenger.get_extension_challenge()
    assert host.ext_pow(common.spec, zeta, common.degree) != \
        host.ext_one(common.spec), "opening point is in the subgroup"
    oracles = [circuit.constants_sigmas_commitment, wires_commitment,
               zs_pp_commitment, quotient_commitment]

    with phase(timings, "openings", dev):
        openings = opening_set(F, circuit.E, common, zeta, oracles)
    fri_openings = openings.to_fri_openings()
    for batch_vals in fri_openings:
        challenger.observe_extension_elements(batch_vals)
    instance = common.get_fri_instance(zeta)
    for batch, vals in zip(instance.batches, fri_openings):
        batch.values = vals

    opening_proof = fri_prover.prove_openings(
        instance, oracles, challenger, common.fri_params, timings, F, hasher)

    proof = Proof(wires_cap=wires_cap,
                  plonk_zs_partial_products_cap=zs_pp_cap,
                  quotient_polys_cap=quotient_cap, openings=openings,
                  opening_proof=opening_proof)
    return ProofWithPublicInputs(proof=proof,
                                 public_inputs=list(circuit.public_inputs))
