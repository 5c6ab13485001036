"""The device-transcript prover (the JAX package's ``plonk/prover_async.py``):
the proof algebra and transcript schedule of the sync prover
(``prover.py:_internal_prove_sync``, reference plonky2/src/plonk/
prover.rs:136-446) with the challenger on the device
(``hash/device_challenger.py``).  Every phase, the commits, partial
products, quotient, openings and the whole FRI opening proof with its PoW
grind and query gathers, is queued on the card without a read back, and
the proof is assembled from ONE blocking device-to-host copy at the end
(two for a lookup circuit, whose lookup polynomials need the deltas on the
host).  The proof's bytes are the sync prover's.

The checks the sync prover makes eagerly become device flags read with the
proof: zeta outside the subgroup, the PoW grind's witness found and its
response, and the permutation argument's denominators (a zero raises
``InvZeroPermArg`` after the fetch, and ``prover.prove`` retries the whole
proof, reference prover.rs:64-134).  The rng is drawn in the sync
prover's order (zk salts at each commit; a failed attempt leaves it where
the sync prover's would, after the wires' salts), and every host value
goes to the card without blocking (``device.upload``).
"""

from __future__ import annotations

from typing import List

import torch

from ..fri import prover as fri_prover
from ..fri.oracle import PolynomialBatch
from ..hash.device_challenger import DeviceChallenger, flat_ext
from ..iop.generator import NonRandomRng, Rng
from . import vanishing
from .proof import FriProof, Proof, ProofWithPublicInputs


def available(hasher) -> bool:
    """Whether the transcript can run on the device: a hasher of field
    digests with a batched device permutation (Poseidon-GL, Poseidon2-BB
    width 16), not a byte-digest one (Keccak)."""
    return hasattr(hasher, "permute") and \
        not getattr(hasher, "DIGEST_IS_BYTES", False)


def _zeta_ok(F, E, common, zeta) -> torch.Tensor:
    """(1,) bool: zeta^n != 1, the opening point outside the subgroup
    (reference prover.rs:332)."""
    zz = zeta
    for _ in range(common.degree_bits):
        zz = E.mul(zz, zz)
    one = F.ones((), zeta[0].device)
    in_subgroup = zz[0] == one
    for c in zz[1:]:
        in_subgroup = in_subgroup & (c == 0)
    return (~in_subgroup).reshape(1)


def query_gathers(circuit, trees, fold_trees, query_challenges):
    """Each tree's query leaves and sibling chains on the device, from the
    query challenges (JAX ``_finalize_body``): the index is the
    challenge's canonical value mod the LDE size, shifted right by each
    fold's arity bits for the fold trees."""
    common = circuit.common
    idx = circuit.F.index_low_bits(query_challenges, common.lde_size)
    out = [t.query_gather(idx) for t in trees]
    for t, bits in zip(fold_trees, common.fri_params.reduction_arity_bits):
        idx = idx >> bits
        out.append(t.query_gather(idx))
    return out


def internal_prove_async(circuit, wires_values,
                         rng: Rng) -> ProofWithPublicInputs:
    """One attempt at the proof of ``circuit`` with the wires
    ``wires_values`` (a device tensor), the transcript on the device."""
    from .prover import (InvZeroPermArg, _quotient_data,
                         compute_lookup_polys, opening_batches,
                         partial_products, quotient_chunks)

    common = circuit.common
    config = common.config
    dev = circuit.device
    F, E, hasher = circuit.F, circuit.E, circuit.hasher
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    nch = config.num_challenges
    qd = _quotient_data(circuit)
    public_inputs_hash = circuit.inner_hasher.hash_no_pad_host(
        circuit.public_inputs)
    salt_rng = rng if config.zero_knowledge else None

    def commit_values(values):
        return PolynomialBatch.from_values(values, rate_bits, cap_height, F,
                                           hasher, salt_rng)

    wires_commitment = commit_values(wires_values)
    # where a failed attempt of the sync prover leaves the rng: its later
    # salts are drawn only once the permutation argument holds
    rewind = _rng_state(rng)
    dc = DeviceChallenger(F, hasher, dev)
    dc.observe_host_ints(list(circuit.circuit_digest)
                         + list(public_inputs_hash))
    dc.observe_cap(wires_commitment.tree.cap)
    betas = dc.get_n_challenges(nch)
    gammas = dc.get_n_challenges(nch)
    deltas, lut_re_evals = [], []
    if common.num_lookup_polys:
        # the lookup polys are computed from the deltas on the host:
        # the one fetch before the proof's
        deltas_dev = torch.cat([betas, gammas,
                                dc.get_n_challenges(2 * nch)])
        deltas_host = [int(v) for v in F.to_ints(deltas_dev)]
        deltas = list(deltas_dev.unbind(0))

    zs_pp, any_zero = partial_products(
        F, common, wires_values[:config.num_routed_wires], qd.s_id,
        circuit.sigmas, list(betas.unbind(0)), list(gammas.unbind(0)))
    if common.num_lookup_polys:
        zs_pp = torch.cat([zs_pp, compute_lookup_polys(
            F, common, circuit.lookup_rows, wires_values, deltas_host)])
        lut_re_evals = [list(F.from_ints(evs, dev).unbind(0)) for evs in
                        vanishing.get_lut_re_evals(common, deltas_host)]
    zs_pp_commitment = commit_values(zs_pp)
    dc.observe_cap(zs_pp_commitment.tree.cap)
    alphas = dc.get_n_challenges(nch)

    chunks = quotient_chunks(
        circuit, qd, circuit.constants_sigmas_commitment.lde,
        wires_commitment.lde, zs_pp_commitment.lde,
        list(F.from_ints(public_inputs_hash, dev).unbind(0)),
        list(betas.unbind(0)), list(gammas.unbind(0)),
        list(alphas.unbind(0)), deltas, lut_re_evals)
    quotient_commitment = PolynomialBatch(chunks, rate_bits, cap_height, F,
                                          hasher, salt_rng)
    dc.observe_cap(quotient_commitment.tree.cap)

    zeta = dc.get_extension_challenge(E.D)
    g = common.spec.two_adic_generator(common.degree_bits)
    zeta_next = tuple(F.mul_const(c, g) for c in zeta)
    oracles = [circuit.constants_sigmas_commitment, wires_commitment,
               zs_pp_commitment, quotient_commitment]
    b0, b1 = opening_batches(F, E, common, zeta, zeta_next, oracles)
    b0_flat, b1_flat = flat_ext(b0), flat_ext(b1)
    dc.observe_array(b0_flat)
    dc.observe_array(b1_flat)

    fold_trees, final, pow_witness, pow_ok, query_ch = \
        fri_prover.prove_openings_device(
            fri_prover.batch_polys(common.get_fri_instance((0,) * E.D)),
            oracles, dc, common.fri_params, (b0, b1), (zeta, zeta_next), F,
            hasher)

    # -- the one blocking fetch --------------------------------------------
    trees = [o.tree for o in oracles]
    gathers = query_gathers(circuit, trees, fold_trees, query_ch)
    flat = torch.cat(
        [F.flag(_zeta_ok(F, E, common, zeta)), F.flag(pow_ok),
         F.flag(~any_zero.reshape(1)), pow_witness.reshape(1)]
        + [c.tree.cap.reshape(-1) for c in oracles[1:]]
        + [t.cap.reshape(-1) for t in fold_trees]
        + [b0_flat, b1_flat, flat_ext(final)]
        + [x.reshape(-1) for rows_sibs in gathers for x in rows_sibs])
    try:
        return assemble_proof(circuit, F.to_ints(flat), trees + fold_trees,
                              len(fold_trees), b0[0].shape[0],
                              b1[0].shape[0], final[0].shape[0])
    except InvZeroPermArg:
        _set_rng_state(rng, rewind)
        raise


def _rng_state(rng):
    return rng.counter if isinstance(rng, NonRandomRng) else \
        rng.bit_generator.state


def _set_rng_state(rng, state) -> None:
    if isinstance(rng, NonRandomRng):
        rng.counter = state
    else:
        rng.bit_generator.state = state


class _Reader:
    """Consecutive slices of the fetched values, as python ints."""

    def __init__(self, flat):
        self.flat = flat
        self.pos = 0

    def take(self, n: int, width: int = 1) -> List[list]:
        out = self.flat[self.pos:self.pos + n * width].reshape(n, width)
        self.pos += n * width
        return [[int(x) for x in row] for row in out]


def assemble_proof(circuit, flat, all_trees, n_fold: int, p0: int, p1: int,
                   keep: int) -> ProofWithPublicInputs:
    """The proof from the fetched values (JAX ``_assemble_proof``): the
    flags first (a failed one raises: the permutation argument's
    ``InvZeroPermArg``, for the retry, else ``AssertionError``), then the
    caps, openings, final polynomial, PoW witness and query data in the
    order ``internal_prove_async`` laid them."""
    from .prover import InvZeroPermArg, opening_set_from

    common = circuit.common
    E = circuit.E
    dw = circuit.hasher.NUM_HASH_OUT
    cap_size = 1 << common.config.fri_config.cap_height
    nq = common.fri_params.config.num_query_rounds
    r = _Reader(flat)
    zeta_ok, pow_ok, perm_ok, pow_witness = (v[0] for v in r.take(4))
    if not perm_ok:
        raise InvZeroPermArg()
    assert zeta_ok == 1, "opening point is in the subgroup"
    assert pow_ok == 1, "PoW grind found no witness whose response passes"
    assert perm_ok == 1, "malformed permutation-argument flag"
    caps = [r.take(cap_size, dw) for _ in range(3 + n_fold)]
    b0 = [tuple(v) for v in r.take(p0, E.D)]
    b1 = [tuple(v) for v in r.take(p1, E.D)]
    final_poly = [tuple(v) for v in r.take(keep, E.D)]
    tree_data = []
    for t in all_trees:
        leaves = r.take(nq, t.leaves.shape[1])
        sibs = r.take(nq * t.num_layers, dw)
        tree_data.append((leaves, [sibs[q * t.num_layers:(q + 1)
                                        * t.num_layers] for q in range(nq)]))
    assert r.pos == len(flat), (r.pos, len(flat))
    n_init = len(all_trees) - n_fold
    opening_proof = FriProof(
        commit_phase_merkle_caps=caps[3:],
        query_round_proofs=fri_prover.query_rounds_from(
            tree_data[:n_init], tree_data[n_init:], E),
        final_poly=final_poly, pow_witness=pow_witness)
    proof = Proof(wires_cap=caps[0], plonk_zs_partial_products_cap=caps[1],
                  quotient_polys_cap=caps[2],
                  openings=opening_set_from(common, b0, b1),
                  opening_proof=opening_proof)
    return ProofWithPublicInputs(proof=proof,
                                 public_inputs=list(circuit.public_inputs))
