"""The PLONK prover, sync transcript (reference plonky2/src/plonk/prover.rs:
136-926; the JAX package's ``plonk/prover.py:_internal_prove``).

Phases: wire commitment, partial products and Z, their commitment, the
quotient over the whole quotient domain, its commitment, the openings at
zeta and g*zeta, then FRI.  Fiat-Shamir runs on the host between phases;
every batched phase runs on the circuit's device.  ``prove`` returns the
proof and fills ``timings`` (seconds per phase, each ended by a device
synchronise) when a dict is passed.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from .. import device as devmod
from ..field import ext as ext_mod
from ..field import fft as fftm
from ..field import gl, host
from ..fri import prover as fri_prover
from ..fri.oracle import PolynomialBatch
from ..hash import poseidon_gl
from ..hash.challenger import Challenger
from . import vanishing
from .proof import OpeningSet, Proof, ProofWithPublicInputs

MAX_PERM_ARG_RETRIES = 3
E = ext_mod.gl2


class InvZeroPermArg(Exception):
    """Permutation-argument division by zero (reference prover.rs:515)."""


@contextmanager
def _phase(timings: Optional[Dict[str, float]], name: str, device):
    t0 = time.perf_counter()
    yield
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def prove(circuit, device=None, timings: Optional[Dict[str, float]] = None,
          generator: Optional[torch.Generator] = None
          ) -> ProofWithPublicInputs:
    """Prove ``circuit`` (a ``circuit_data.Circuit``) on ``device`` (the
    card unless the caller asks for the CPU).  On a permutation-argument
    division by zero the random wire of the public-input gate is drawn
    again from ``generator`` and the proof retried (reference
    prover.rs:136-230, the anti-#456 loop)."""
    dev = devmod.resolve(device)
    if dev != circuit.device:
        raise ValueError(f"circuit was loaded on {circuit.device}, "
                         f"not {dev}")
    wires = circuit.wires
    for retry in range(MAX_PERM_ARG_RETRIES):
        if retry:
            assert circuit.random_wire is not None, \
                "perm-arg failure with no random wire"
            row, col = circuit.random_wire
            wires = wires.clone()
            wires[col, row] = int(torch.randint(
                0, 1 << 62, (), generator=generator)) % gl.P
        try:
            return _internal_prove(circuit, wires, timings)
        except InvZeroPermArg:
            continue
    raise InvZeroPermArg("too many permutation argument failures")


def _scalars(values: List[int], device) -> List[torch.Tensor]:
    arr = gl.from_ints([int(v) % gl.P for v in values], device)
    return list(arr.unbind(0)) if len(values) else []


def _ext_scalar(value, device):
    return tuple(_scalars(list(value), device))


def partial_products(common, routed, s_id, sigmas, betas, gammas):
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
    numer = gl.add(gl.add(routed[None], gl.mul(s_id[None], beta)), gamma)
    denom = gl.add(gl.add(routed[None], gl.mul(sigmas[None], beta)), gamma)
    any_zero = gl.is_zero(denom).any()
    quot = gl.mul(numer, gl.inv(denom))
    pad = nchunks * qdf - num_routed
    quot = torch.cat([quot, gl.ones((nch, pad, n), dev)], dim=1)
    chunk_prods = gl.batch_prod(quot.reshape(nch, nchunks, qdf, n), axis=2)
    incl = gl.cumprod(gl.batch_prod(chunk_prods, axis=1), axis=-1)
    z = torch.cat([gl.ones((nch, 1), dev), incl[:, :-1]], dim=1)
    running = gl.cumprod(chunk_prods, axis=1)
    pps = gl.mul(running[:, :common.num_partial_products], z[:, None])
    return torch.cat([z, pps.reshape(-1, n)]), any_zero


class _QuotientData:
    """Circuit-static tensors of the quotient domain (cached per circuit)."""

    def __init__(self, circuit):
        common = circuit.common
        dev = circuit.device
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
        self.shifted_xs = gl.mul_const(fftm.powers(w, m, dev),
                                       spec.coset_shift)
        tau = pow(w, n, p)
        gf_n = pow(spec.coset_shift, n, p)
        zh_small = [(gf_n * pow(tau, i, p) - 1) % p for i in range(1 << qdb)]
        self.zh_inv = gl.from_ints(host.batch_inv(zh_small, p), dev).repeat(
            m >> qdb)
        zh = gl.from_ints(zh_small, dev).repeat(m >> qdb)
        x_minus_1 = gl.sub(self.shifted_xs, gl.ones((), dev))
        self.l_0 = gl.mul(zh, gl.inv(gl.mul_const(x_minus_1, n % p)))
        xs = fftm.powers(spec.two_adic_generator(common.degree_bits), n, dev)
        k_arr = gl.from_ints(common.k_is, dev)
        self.s_id = gl.mul(k_arr[:, None], xs[None, :])


def _quotient_data(circuit) -> _QuotientData:
    q = getattr(circuit, "_quotient_data", None)
    if q is None:
        q = _QuotientData(circuit)
        circuit._quotient_data = q
    return q


def quotient_chunks(circuit, qd: _QuotientData, cs_lde, wires_lde,
                    zs_pp_lde, pi_hash, betas, gammas, alphas):
    """Quotient polynomial chunks (nch * qdf, n): the vanishing polynomial
    over the quotient domain, divided by Z_H, coset-iFFT'd and split
    (reference prover.rs:690-926)."""
    common = circuit.common
    dev = circuit.device
    cs = cs_lde[:, ::qd.step]
    wires = wires_lde[:, ::qd.step]
    zs_pp = zs_pp_lde[:, ::qd.step]
    zs_pp_next = torch.roll(zs_pp, -qd.next_step, dims=-1)
    c0, c1 = common.constants_range()
    s0, s1 = common.sigmas_range()
    z0, z1 = common.zs_range()
    pp0, pp1 = common.partial_products_range()
    values = vanishing.eval_vanishing_poly(
        common, qd.shifted_xs, qd.l_0, wires, cs[c0:c1], pi_hash,
        zs_pp[z0:z1], zs_pp_next[z0:z1], zs_pp[pp0:pp1], cs[s0:s1],
        betas, gammas, alphas)
    n = common.degree
    qdf = common.quotient_degree_factor
    chunks = []
    for v in values:
        q_values = gl.mul(v.expand(qd.m), qd.zh_inv)
        q_coeffs = fftm.coset_ifft(q_values, common.spec.coset_shift)
        chunks.append(q_coeffs[:common.quotient_degree].reshape(qdf, n))
    return torch.cat(chunks, dim=0)


def _ext_powers(z, n: int):
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


def eval_at(coeffs: torch.Tensor, pows) -> tuple:
    """Every poly of a coefficient batch (P, n) at the point whose powers
    are ``pows``: D arrays of (P,)."""
    return tuple(gl.batch_sum(gl.mul(coeffs, pw[None, :]), axis=-1)
                 for pw in pows)


def opening_set(common, zeta, oracles) -> OpeningSet:
    """Openings at zeta and g * zeta (reference proof.rs:347-386)."""
    spec = common.spec
    dev = oracles[0].coeffs.device
    g = spec.two_adic_generator(common.degree_bits)
    zeta_next = host.ext_scalar_mul(spec, zeta, g)
    n = common.degree
    pz = _ext_powers(_ext_scalar(zeta, dev), n)
    pzn = _ext_powers(_ext_scalar(zeta_next, dev), n)
    cs, wires, zs_pp, quotient = oracles
    parts = [eval_at(cs.coeffs, pz), eval_at(wires.coeffs, pz),
             eval_at(zs_pp.coeffs, pz), eval_at(zs_pp.coeffs, pzn),
             eval_at(quotient.coeffs, pz)]
    flat = gl.to_ints(torch.cat([torch.stack(p, dim=1) for p in parts]))
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
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    nch = config.num_challenges
    qd = _quotient_data(circuit)
    public_inputs_hash = poseidon_gl.hash_no_pad_host(circuit.public_inputs)

    with _phase(timings, "wires_commit", dev):
        wires_commitment = PolynomialBatch.from_values(
            wires_values, rate_bits, cap_height)
        wires_cap = wires_commitment.cap_host()

    challenger = Challenger()
    challenger.observe_hash(circuit.circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(wires_cap)
    betas = challenger.get_n_challenges(nch)
    gammas = challenger.get_n_challenges(nch)

    with _phase(timings, "partial_products", dev):
        zs_pp, any_zero = partial_products(
            common, wires_values[:config.num_routed_wires], qd.s_id,
            circuit.sigmas, _scalars(betas, dev), _scalars(gammas, dev))
        if bool(any_zero):
            raise InvZeroPermArg()

    with _phase(timings, "zs_pp_commit", dev):
        zs_pp_commitment = PolynomialBatch.from_values(zs_pp, rate_bits,
                                                       cap_height)
        zs_pp_cap = zs_pp_commitment.cap_host()
    challenger.observe_cap(zs_pp_cap)
    alphas = challenger.get_n_challenges(nch)

    with _phase(timings, "quotient", dev):
        chunks = quotient_chunks(
            circuit, qd, circuit.constants_sigmas_commitment.lde,
            wires_commitment.lde, zs_pp_commitment.lde,
            _scalars(public_inputs_hash, dev), _scalars(betas, dev),
            _scalars(gammas, dev), _scalars(alphas, dev))

    with _phase(timings, "quotient_commit", dev):
        quotient_commitment = PolynomialBatch(chunks, rate_bits, cap_height)
        quotient_cap = quotient_commitment.cap_host()
    challenger.observe_cap(quotient_cap)

    zeta = challenger.get_extension_challenge()
    assert host.ext_pow(common.spec, zeta, common.degree) != \
        host.ext_one(common.spec), "opening point is in the subgroup"
    oracles = [circuit.constants_sigmas_commitment, wires_commitment,
               zs_pp_commitment, quotient_commitment]

    with _phase(timings, "openings", dev):
        openings = opening_set(common, zeta, oracles)
    fri_openings = openings.to_fri_openings()
    for batch_vals in fri_openings:
        challenger.observe_extension_elements(batch_vals)
    instance = common.get_fri_instance(zeta)
    for batch, vals in zip(instance.batches, fri_openings):
        batch.values = vals

    opening_proof = fri_prover.prove_openings(
        instance, oracles, challenger, common.fri_params, timings)

    proof = Proof(wires_cap=wires_cap,
                  plonk_zs_partial_products_cap=zs_pp_cap,
                  quotient_polys_cap=quotient_cap, openings=openings,
                  opening_proof=opening_proof)
    return ProofWithPublicInputs(proof=proof,
                                 public_inputs=list(circuit.public_inputs))
