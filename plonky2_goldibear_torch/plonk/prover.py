"""The PLONK prover (reference plonky2/src/plonk/prover.rs:136-926; the JAX
package's ``plonk/prover.py``).

Phases: wire commitment, partial products and Z (and a lookup circuit's
lookup polynomials, ``lookup_polys``), their commitment, the quotient over
the whole quotient domain, its commitment, the openings at zeta and
g*zeta, then FRI.  Every batched phase runs on the circuit's device.
``prove`` takes the device-transcript prover (``prover_async.py``: the
transcript on the device too, one blocking fetch a proof) unless
``timings`` are asked for or the hasher has no device permutation
(Keccak); then the sync prover here runs Fiat-Shamir on the host between
the phases (``_internal_prove_sync``).  Both give the same bytes.  A
zero-knowledge circuit's wires, Z/partial-product and quotient
commitments are salted from the prover's rng (``fri/oracle.py``), after
witness generation's draws and before a retry's.  ``prove`` returns the
proof and fills ``timings`` (seconds per phase, each ended by a device
synchronise) when a dict is passed.  The field module ``F`` (``gl`` or
``bb``), its extension ``E``, the hasher of the commitments and the
transcript (Poseidon-GL, Poseidon2-BB or Keccak) and the inner hasher of
the public inputs are the circuit's (``circuit_data.load_circuit`` picks
them).
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
from ..gates.lookup_gates import LookupGate, LookupTableGate
from ..iop import target as tgt
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
    for the CPU), through the device-transcript prover unless ``timings``
    is a dict (then the sync one fills it: seconds per phase) or the
    hasher is Keccak (``_internal_prove``).  On a permutation-argument
    division by zero the random wire of the public-input gate is drawn
    again, ``rand_field_element(p, rng)`` (``iop/generator.py``: a
    ``NonRandomRng`` for the reference's deterministic draws, else a numpy
    generator, fresh from the OS when none is given), and the proof
    retried (reference prover.rs:136-230, the anti-#456 loop); the
    circuit's own wires stay as they were.  A zero-knowledge circuit's
    salts are drawn from the same rng."""
    dev = devmod.resolve(device)
    if dev != circuit.device:
        raise ValueError(f"circuit was loaded on {circuit.device}, "
                         f"not {dev}")
    if rng is None:
        rng = np.random.default_rng()
    wires = WitnessTransfer(circuit.F, circuit.wires)
    for retry in range(MAX_PERM_ARG_RETRIES):
        if retry:
            assert circuit.random_wire is not None, \
                "perm-arg failure with no random wire"
            row, col = circuit.random_wire
            wires.set(row, col, rand_field_element(circuit.F.P, rng))
        try:
            return _internal_prove(circuit, wires.device_values(), timings,
                                   rng)
        except InvZeroPermArg:
            continue
    raise InvZeroPermArg("too many permutation argument failures")


# -- lookups (reference prover.rs:64-134, 555-674) --------------------------


def set_lookup_wires(prover_only, common, witness) -> None:
    """Each table entry's multiplicity, and the unused slots of a table's
    last LookupGate row filled with its first entry (reference
    prover.rs:64-134), in the partition witness."""
    num_lu = LookupGate.num_slots_of(common.config)
    num_lut = LookupTableGate.num_slots_of(common.config)
    for lut_index, (_, last_lut, first_lut) in enumerate(
            prover_only.lookup_rows):
        lut = common.luts[lut_index]
        lookups = prover_only.lut_to_lookups[lut_index]
        multiplicities = [0] * len(lut)
        value_to_idx = {inp: i for i, (inp, _) in enumerate(lut)}
        for inp_t, _ in lookups:
            multiplicities[value_to_idx[witness.get_target(inp_t)]] += 1
        remaining = (num_lu - len(lookups) % num_lu) % num_lu
        first_inp, first_out = lut[0]
        for slot in range(num_lu - remaining, num_lu):
            witness.set_target(tgt.wire(
                last_lut - 1, LookupGate.wire_ith_looking_inp(slot)),
                first_inp)
            witness.set_target(tgt.wire(
                last_lut - 1, LookupGate.wire_ith_looking_out(slot)),
                first_out)
            multiplicities[0] += 1
        for entry, mult in enumerate(multiplicities):
            witness.set_target(tgt.wire(
                first_lut - entry // num_lut,
                LookupTableGate.wire_ith_multiplicity(entry % num_lut)), mult)


def _lookup_shape(common):
    """(looking slots, their group size, partial-sum polys, table slots,
    their group size)."""
    num_lu = LookupGate.num_slots_of(common.config)
    lu_degree = common.config.max_quotient_degree_factor - 1
    num_partial = -(-num_lu // lu_degree)
    num_lut = LookupTableGate.num_slots_of(common.config)
    return (num_lu, lu_degree, num_partial, num_lut,
            -(-num_lut // num_partial))


def compute_lookup_polys_host(common, lookup_rows, witness: np.ndarray,
                              deltas4) -> List[List[int]]:
    """The scalar reference of ``compute_lookup_polys`` (the JAX package's
    ``compute_lookup_polys_host``, reference prover.rs:555-674), one python
    int operation at a time: the running sum ``re`` and the partial sums
    of each table section, rows taken backwards (they are upside down).
    ``witness`` (num_wires, degree) canonical ints; for tests."""
    p = common.spec.p
    degree = common.degree
    num_lu, lu_degree, num_partial, num_lut, lut_degree = \
        _lookup_shape(common)
    d_a, d_b, d_alpha, d_delta = (int(d) % p for d in deltas4)
    polys = [[0] * degree for _ in range(num_partial + 1)]
    wv = witness

    def col(w, row):
        return int(wv[w, row])

    for last_lu, last_lut, first_lut in lookup_rows:
        for row in range(first_lut, last_lut - 1, -1):
            inv = host.batch_inv([
                (d_alpha - col(LookupTableGate.wire_ith_looked_inp(s), row)
                 - d_a * col(LookupTableGate.wire_ith_looked_out(s), row)) % p
                for s in range(num_lut)], p)
            new_re = polys[0][row + 1] if row + 1 < degree else 0
            for s in range(num_lut):
                new_re = (new_re * d_delta
                          + col(LookupTableGate.wire_ith_looked_inp(s), row)
                          + d_b * col(LookupTableGate.wire_ith_looked_out(s),
                                      row)) % p
            polys[0][row] = new_re
            for j in range(num_partial):
                acc = polys[j][row] if j else (
                    polys[num_partial][row + 1] if row + 1 < degree else 0)
                for s in range(j * lut_degree,
                               min((j + 1) * lut_degree, num_lut)):
                    acc = (acc + col(LookupTableGate.wire_ith_multiplicity(s),
                                     row) * inv[s]) % p
                polys[j + 1][row] = acc
        for row in range(last_lut - 1, last_lu - 1, -1):
            inv = host.batch_inv([
                (d_alpha - col(LookupGate.wire_ith_looking_inp(s), row)
                 - d_a * col(LookupGate.wire_ith_looking_out(s), row)) % p
                for s in range(num_lu)], p)
            for j in range(num_partial):
                prev = polys[j][row] if j else polys[num_partial][row + 1]
                polys[j + 1][row] = (prev - sum(inv[j * lu_degree:(
                    j + 1) * lu_degree])) % p
    return polys


def _group_sums(F, vals: torch.Tensor, groups: int, size: int
                ) -> torch.Tensor:
    """(..., S) -> (..., groups): the sums of consecutive slot groups of
    ``size`` (the last short or empty)."""
    pad = groups * size - vals.shape[-1]
    if pad > 0:
        vals = torch.cat([vals, F.zeros(vals.shape[:-1] + (pad,),
                                        vals.device)], dim=-1)
    vals = vals[..., :groups * size]
    return F.batch_sum(vals.reshape(vals.shape[:-1] + (groups, size)),
                       axis=-1)


def _prefix_sum(F, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis (log-depth scan)."""
    n, k = x.shape[-1], 1
    while k < n:
        x = torch.cat([x[..., :k], F.add(x[..., k:], x[..., :n - k])],
                      dim=-1)
        k *= 2
    return x


def _affine_scan(F, mult: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x_k = a * x_{k-1} + b_k from x_{-1} = 0 along the last axis of b,
    ``mult`` holding a broadcast to b's shape (a log-depth scan of the
    affine maps)."""
    n, k = b.shape[-1], 1
    while k < n:
        b = torch.cat([b[..., :k], F.add(F.mul(b[..., :n - k],
                                                mult[..., k:]),
                                          b[..., k:])], dim=-1)
        mult = torch.cat([mult[..., :k], F.mul(mult[..., k:],
                                               mult[..., :n - k])], dim=-1)
        k *= 2
    return b


def compute_lookup_polys(F, common, lookup_rows, wires: torch.Tensor,
                         deltas) -> torch.Tensor:
    """(challenges * (1 + partial sums), degree): for each challenge's
    four deltas in ``deltas`` (host ints, four a challenge), the running
    sum and the partial sums on whole columns (the JAX package's
    ``compute_lookup_polys_batched``).  All challenges at once, per table
    section: one inversion of every denominator, the running sum as an
    affine scan (its per-row step is Horner in delta over the row's
    slots), the partial sums as one prefix sum over (row, group) in row
    order, rows taken backwards.  Equal to ``compute_lookup_polys_host``
    of each challenge."""
    p = common.spec.p
    dev = wires.device
    n = common.degree
    num_lu, lu_degree, num_partial, num_lut, lut_degree = \
        _lookup_shape(common)
    ds = [[int(d) % p for d in deltas[i:i + 4]]
          for i in range(0, len(deltas), 4)]
    nc = len(ds)

    def per_challenge(vals):
        return F.from_ints(vals, dev).reshape(nc, 1, 1)

    da, db, dal = (per_challenge([d[i] for d in ds]) for i in range(3))
    # Horner over a row's slots: sum_s combo_s delta^(S-1-s), and the
    # step's multiplier delta^S
    horner = F.from_ints([[pow(d[3], num_lut - 1 - s, p)
                           for s in range(num_lut)] for d in ds], dev)
    step_mult = per_challenge([pow(d[3], num_lut, p) for d in ds])[:, 0]
    polys = F.zeros((nc, num_partial + 1, n), dev)

    def cols(ws, rows):
        return wires[ws][:, rows].t()[None]

    def wire_index(ws):
        # a device index (a list index would be a blocking copy a call)
        return devmod.upload(np.asarray(ws, dtype=np.int64), dev)

    lut_inp = wire_index([LookupTableGate.wire_ith_looked_inp(s)
                          for s in range(num_lut)])
    lut_out = wire_index([LookupTableGate.wire_ith_looked_out(s)
                          for s in range(num_lut)])
    lut_mul = wire_index([LookupTableGate.wire_ith_multiplicity(s)
                          for s in range(num_lut)])
    lu_inp = wire_index([LookupGate.wire_ith_looking_inp(s)
                         for s in range(num_lu)])
    lu_out = wire_index([LookupGate.wire_ith_looking_out(s)
                         for s in range(num_lu)])
    for last_lu, last_lut, first_lut in lookup_rows:
        rows_lut = torch.arange(first_lut, last_lut - 1, -1, device=dev)
        rows_lu = torch.arange(last_lut - 1, last_lu - 1, -1, device=dev)
        r1, r2 = rows_lut.shape[0], rows_lu.shape[0]
        seeds = polys[:, :, first_lut + 1].clone() if first_lut + 1 < n \
            else F.zeros((nc, num_partial + 1), dev)
        inp, out = cols(lut_inp, rows_lut), cols(lut_out, rows_lut)
        steps = F.batch_sum(F.mul(F.add(inp, F.mul(out, db)),
                                  horner[:, None]), axis=2)   # (nc, r1)
        steps = torch.cat([F.add(F.mul(step_mult, seeds[:, :1]),
                                 steps[:, :1]), steps[:, 1:]], dim=1)
        polys[:, 0, rows_lut] = _affine_scan(
            F, step_mult.expand(nc, r1), steps)
        # every denominator of the section inverted at once
        dens = [F.sub(dal, F.add(inp, F.mul(out, da)))]
        if r2:
            dens.append(F.sub(dal, F.add(cols(lu_inp, rows_lu),
                                         F.mul(cols(lu_out, rows_lu), da))))
        inv = F.inv(torch.cat([d.reshape(nc, -1) for d in dens], dim=1))
        lut_inv = inv[:, :r1 * num_lut].reshape(nc, r1, num_lut)
        inc = [_group_sums(F, F.mul(cols(lut_mul, rows_lut), lut_inv),
                           num_partial, lut_degree)]
        if r2:
            inc.append(F.neg(_group_sums(
                F, inv[:, r1 * num_lut:].reshape(nc, r2, num_lu),
                num_partial, lu_degree)))
        flat = torch.cat([x.reshape(nc, -1) for x in inc], dim=1)
        sums = F.add(_prefix_sum(F, flat), seeds[:, num_partial:]).reshape(
            nc, -1, num_partial)
        polys[:, 1:, rows_lut] = sums[:, :r1].transpose(1, 2)
        polys[:, 1:, rows_lu] = sums[:, r1:].transpose(1, 2)
    return polys.reshape(nc * (num_partial + 1), n)


def _scalars(F, values: List[int], device) -> List[torch.Tensor]:
    arr = F.from_ints([int(v) % F.P for v in values], device)
    return list(arr.unbind(0)) if len(values) else []


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
                    zs_pp_lde, pi_hash, betas, gammas, alphas, deltas=(),
                    lut_re_evals=()):
    """Quotient polynomial chunks (nch * qdf, n): the vanishing polynomial
    over the quotient domain, divided by Z_H, coset-iFFT'd and split
    (reference prover.rs:690-926); a lookup circuit's lookup polys follow
    the Z/partial-product polys in their oracle."""
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
    lk0 = common.num_zs_partial_products_polys()
    lk1 = lk0 + common.num_all_lookup_polys()
    values = vanishing.eval_vanishing_poly(
        F, common, qd.shifted_xs, qd.l_0, wires, cs[c0:c1], pi_hash,
        zs_pp[z0:z1], zs_pp_next[z0:z1], zs_pp[pp0:pp1], cs[s0:s1],
        betas, gammas, alphas, deltas, zs_pp[lk0:lk1], zs_pp_next[lk0:lk1],
        lut_re_evals)
    n = common.degree
    # the challenges' quotients in one batched coset iFFT
    q_values = F.mul(torch.stack([v.expand(qd.m) for v in values]),
                     qd.zh_inv)
    q_coeffs = fftm.coset_ifft(q_values, common.spec.coset_shift, F)
    return q_coeffs[:, :common.quotient_degree].reshape(-1, n)


def eval_at(F, coeffs: torch.Tensor, pows) -> tuple:
    """Every poly of a coefficient batch (P, n) at the point whose powers
    are ``pows``: D arrays of (P,)."""
    return tuple(F.batch_sum(F.mul(coeffs, pw[None, :]), axis=-1)
                 for pw in pows)


def opening_batches(F, E, common, zeta, zeta_next, oracles):
    """The openings at the device ext scalars zeta and g * zeta in FRI
    order (reference proof.rs:347-428), D device tensors a batch: every
    polynomial at zeta (constants and sigmas, wires, Zs and partial
    products, quotient, lookup polys), then the Zs and the lookup polys at
    g * zeta."""
    n = common.degree
    nch = common.config.num_challenges
    pp1 = common.partial_products_range()[1]
    lk0 = common.num_zs_partial_products_polys()
    pz = fri_prover.ext_powers(E, zeta, n)
    cs, wires, zs_pp, quotient = oracles
    at_z = [eval_at(F, o.coeffs, pz) for o in (cs, wires, zs_pp, quotient)]
    cs_ev, wires_ev, zs_pp_ev, quot_ev = at_z
    b0 = tuple(torch.cat([cs_ev[d], wires_ev[d], zs_pp_ev[d][:pp1],
                          quot_ev[d], zs_pp_ev[d][lk0:]])
               for d in range(E.D))
    b1 = eval_at(F, torch.cat([zs_pp.coeffs[:nch], zs_pp.coeffs[lk0:]]),
                 fri_prover.ext_powers(E, zeta_next, n))
    return b0, b1


def opening_set_from(common, b0: List[tuple], b1: List[tuple]) -> OpeningSet:
    """The ``OpeningSet`` of the two FRI batches' host values."""
    c0, c1 = common.constants_range()
    s0, s1 = common.sigmas_range()
    nch = common.config.num_challenges
    o = [0]

    def take(k):
        o[0] += k
        return b0[o[0] - k:o[0]]

    pre = take(common.num_preprocessed_polys())
    wires = take(common.config.num_wires)
    zs_pp = take(common.partial_products_range()[1])
    quotient = take(common.num_quotient_polys())
    return OpeningSet(
        constants=pre[c0:c1], plonk_sigmas=pre[s0:s1], wires=wires,
        plonk_zs=zs_pp[:nch], plonk_zs_next=b1[:nch],
        partial_products=zs_pp[nch:], quotient_polys=quotient,
        lookup_zs=b0[o[0]:], lookup_zs_next=b1[nch:])


def opening_set(F, E, common, zeta, oracles) -> OpeningSet:
    """Openings at the host point zeta and at g * zeta (reference
    proof.rs:347-386), read back."""
    spec = common.spec
    dev = oracles[0].coeffs.device
    g = spec.two_adic_generator(common.degree_bits)
    zeta_next = host.ext_scalar_mul(spec, zeta, g)
    b0, b1 = opening_batches(F, E, common,
                             fri_prover.ext_scalar(zeta, dev, F),
                             fri_prover.ext_scalar(zeta_next, dev, F),
                             oracles)
    flat = F.to_ints(torch.cat([torch.stack(b0, dim=1),
                                torch.stack(b1, dim=1)]))
    rows = [tuple(int(v) for v in row) for row in flat]
    p0 = b0[0].shape[0]
    return opening_set_from(common, rows[:p0], rows[p0:])


def _internal_prove(circuit, wires_values, timings,
                    rng: Rng) -> ProofWithPublicInputs:
    """One attempt at the proof, as the JAX package's ``prove`` picks it
    (its ``plonk/prover.py:75-92``): the device-transcript prover
    (``prover_async.py``, one blocking fetch) when no ``timings`` are
    asked for and the hasher has a device permutation (Poseidon-GL,
    Poseidon2-BB), else the sync prover, whose transcript runs on the host
    between the phases (a byte-digest hasher such as Keccak, or a timed
    prove)."""
    from . import prover_async

    if timings is None and prover_async.available(circuit.hasher):
        return prover_async.internal_prove_async(circuit, wires_values, rng)
    return _internal_prove_sync(circuit, wires_values, timings, rng)


def _internal_prove_sync(circuit, wires_values, timings,
                         rng: Rng) -> ProofWithPublicInputs:
    common = circuit.common
    config = common.config
    dev = circuit.device
    F, hasher = circuit.F, circuit.hasher
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    nch = config.num_challenges
    qd = _quotient_data(circuit)
    # the public inputs' hash is the algebraic inner hasher's (reference
    # prover.rs:157), whatever commits
    public_inputs_hash = circuit.inner_hasher.hash_no_pad_host(
        circuit.public_inputs)
    # the blinded oracles' salts (reference plonk_common.rs:24-40)
    salt_rng = rng if config.zero_knowledge else None

    def commit_values(values):
        return PolynomialBatch.from_values(values, rate_bits, cap_height, F,
                                           hasher, salt_rng)

    with phase(timings, "wires_commit", dev):
        wires_commitment = commit_values(wires_values)
        wires_cap = wires_commitment.cap_host()

    challenger = Challenger(common.spec, hasher)
    challenger.observe_hash(circuit.circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(wires_cap)
    betas = challenger.get_n_challenges(nch)
    gammas = challenger.get_n_challenges(nch)
    deltas, lut_re_evals = [], []
    if common.num_lookup_polys:
        # betas and gammas are the first two deltas a challenge
        # (reference prover.rs:283-299)
        deltas = betas + gammas + challenger.get_n_challenges(2 * nch)

    with phase(timings, "partial_products", dev):
        zs_pp, any_zero = partial_products(
            F, common, wires_values[:config.num_routed_wires], qd.s_id,
            circuit.sigmas, _scalars(F, betas, dev),
            _scalars(F, gammas, dev))
        if bool(any_zero):
            raise InvZeroPermArg()

    if common.num_lookup_polys:
        with phase(timings, "lookup_polys", dev):
            zs_pp = torch.cat([zs_pp, compute_lookup_polys(
                F, common, circuit.lookup_rows, wires_values, deltas)])
        lut_re_evals = [_scalars(F, evs, dev) for evs in
                        vanishing.get_lut_re_evals(common, deltas)]

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
            _scalars(F, gammas, dev), _scalars(F, alphas, dev),
            _scalars(F, deltas, dev), lut_re_evals)

    with phase(timings, "quotient_commit", dev):
        quotient_commitment = PolynomialBatch(chunks, rate_bits, cap_height,
                                              F, hasher, salt_rng)
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
