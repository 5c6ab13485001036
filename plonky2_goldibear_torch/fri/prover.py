"""FRI opening prover, sync transcript (reference plonky2/src/fri/oracle.rs:
185-248, fri/prover.rs:22-255; the JAX package's ``fri/prover.py``).

The combined codeword is built in values form on the whole LDE coset (one
batched pass per opening batch), one extension iFFT recovers its
coefficients, and each fold round is a beta-weighted coefficient reduction,
a coset FFT and a Merkle commit.  The proof-of-work grind searches
candidates in ascending batches and returns the smallest valid witness.
Query rounds gather leaf rows and sibling chains from every tree.  Every
function takes the field module ``F`` and the hasher of the circuit
(Goldilocks and Poseidon-GL by default); the extension is ``ext_ops(F)``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..field import ext as ext_mod
from ..field import fft as fftm
from ..field import gl, host
from ..hash import merkle, poseidon_gl
from ..plonk.proof import (FriInitialTreeProof, FriProof, FriQueryRound,
                           FriQueryStep)

GRIND_BATCH_CUDA = 1 << 17
GRIND_BATCH_CPU = 1 << 12


def _sync_time(timings, name, t0, device):
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def reduce_openings(spec: host.FieldSpec, values: Sequence[Tuple[int, ...]],
                    alpha: Tuple[int, ...]) -> Tuple[int, ...]:
    """sum_i alpha^i v_i on the host."""
    acc = host.ext_zero(spec)
    for v in reversed(list(values)):
        acc = host.ext_add(spec, host.ext_mul(spec, acc, alpha), v)
    return acc


def _ext_scalar(value, device, F=gl):
    arr = F.from_ints([int(v) for v in value], device)
    return tuple(arr.unbind(0))


def combine_and_ifft(instance, oracles, alpha, shift: int, F=gl):
    """The combined codeword sum_b alpha^(...) (sum_j alpha^j f_j - y_b) /
    (x - z_b) on the LDE coset, and its coefficients."""
    spec = F.SPEC
    E = ext_mod.ext_ops(F)
    ldes = [o.lde for o in oracles]
    dev = ldes[0].device
    m = ldes[0].shape[-1]
    w = spec.two_adic_generator(host.log2_strict(m))
    xs_ext = E.from_base(F.mul_const(fftm.powers(w, m, dev, F), shift))
    sum_vals = None
    for batch in instance.batches:
        polys = batch.polynomials
        rows = torch.stack([ldes[p.oracle_index][p.polynomial_index]
                            for p in polys])                 # (P_b, m)
        weights = [host.ext_pow(spec, alpha, j) for j in range(len(polys))]
        reduced = tuple(
            F.batch_sum(F.mul(rows, F.from_ints(
                [wt[d] for wt in weights], dev)[:, None]), axis=0)
            for d in range(E.D))
        red_open = _ext_scalar(reduce_openings(spec, batch.values, alpha),
                               dev, F)
        numerator = E.sub(reduced, red_open)
        denominator = E.sub(xs_ext, _ext_scalar(batch.point, dev, F))
        quotient = E.mul(numerator, E.inv(denominator))
        if sum_vals is None:
            sum_vals = quotient
        else:
            shift_pow = _ext_scalar(host.ext_pow(spec, alpha, len(polys)),
                                    dev, F)
            sum_vals = E.add(E.mul(sum_vals, shift_pow), quotient)
    return sum_vals, fftm.ext_coset_ifft(sum_vals, shift, F)


def fold_round(coeffs, arity: int, beta_pows, shift: int, F=gl):
    """coeffs (m,) ext -> folded (m / arity,) ext and its values on the
    shift coset (reference fri/prover.rs:115-125)."""
    E = ext_mod.ext_ops(F)
    m = coeffs[0].shape[-1]
    chunked = tuple(c.reshape(m // arity, arity) for c in coeffs)
    folded = None
    for r in range(arity):
        term = E.mul(tuple(c[:, r] for c in chunked), beta_pows[r])
        folded = term if folded is None else E.add(folded, term)
    return folded, fftm.ext_coset_fft(folded, shift, F)


def round_commit(values, arity: int, cap_height: int, hasher=poseidon_gl):
    """Bit-reversed ext values -> coset leaves (m / arity, arity * D) and
    the Merkle tree over them (reference fri/prover.rs:104-110)."""
    m = values[0].shape[-1]
    rev = [fftm.reverse_index_bits(c, dim=-1).reshape(m // arity, arity)
           for c in values]
    leaves = torch.stack(rev, dim=-1).reshape(m // arity, arity * len(values))
    return merkle.MerkleTree(leaves.contiguous(), cap_height, hasher)


def _leading_zeros64(x: int) -> int:
    return 64 - x.bit_length() if x else 64


def _min_leading_zeros(config, spec: host.FieldSpec) -> int:
    """Leading zeros of the 64-bit response the grind must reach: the PoW
    bits plus the bits a field narrower than 64 bits never sets (reference
    fri/prover.rs:136-188)."""
    return config.proof_of_work_bits + (64 - spec.bits)


def fri_proof_of_work(challenger, config, device, F=gl,
                      hasher=poseidon_gl) -> int:
    """The smallest w with leading_zeros(H(transcript || w)) >= the bound of
    ``_min_leading_zeros`` (for BabyBear: canonical response < 2^15):
    candidates are tried in ascending batches through the hasher's batched
    permutation (the kernel on the card), and the first hit of the first
    batch with one is the answer."""
    state = list(challenger.sponge_state)
    pos = len(challenger.input_buffer)
    for i, v in enumerate(challenger.input_buffer):
        state[i] = v
    assert pos < hasher.WIDTH
    k = 64 - _min_leading_zeros(config, F.SPEC)
    batch = GRIND_BATCH_CUDA if device.type == "cuda" else GRIND_BATCH_CPU
    base = F.from_ints(state, device)
    start = 0
    while True:
        cands = start + torch.arange(batch, dtype=torch.int64, device=device)
        st = F.grind_set_lane(base.expand(batch, -1), pos, cands)
        resp = hasher.permute(st)[:, hasher.RATE - 1]
        ok = F.grind_response_ok(resp, k)
        hits = torch.nonzero(ok)
        if hits.numel():
            return start + int(hits[0, 0])
        start += batch
        assert start < 1 << 32, "PoW grind exhausted 2^32 candidates"


def _query_rounds(initial_trees, trees, x_indices: List[int],
                  fri_params, E) -> List[FriQueryRound]:
    cur = list(x_indices)
    round_indices = []
    for arity_bits in fri_params.reduction_arity_bits:
        cur = [x >> arity_bits for x in cur]
        round_indices.append(cur)
    init = [(t.tree.leaf_batch(x_indices), t.tree.prove_batch(x_indices))
            for t in initial_trees]
    steps_data = [(t.leaf_batch(ix), t.prove_batch(ix))
                  for t, ix in zip(trees, round_indices)]
    rounds = []
    for q in range(len(x_indices)):
        steps = []
        for leaves, proofs in steps_data:
            leaf = leaves[q]
            evals = [tuple(leaf[j * E.D + d] for d in range(E.D))
                     for j in range(len(leaf) // E.D)]
            steps.append(FriQueryStep(evals=evals, merkle_proof=proofs[q]))
        rounds.append(FriQueryRound(
            initial_trees_proof=FriInitialTreeProof(
                evals_proofs=[(leaves[q], proofs[q])
                              for leaves, proofs in init]),
            steps=steps))
    return rounds


def fri_proof(initial_trees, lde_coeffs, lde_values, challenger,
              fri_params, timings: Optional[Dict[str, float]] = None,
              F=gl, hasher=poseidon_gl) -> FriProof:
    """reference fri/prover.rs:22-77."""
    spec = F.SPEC
    E = ext_mod.ext_ops(F)
    cap_height = fri_params.config.cap_height
    dev = lde_coeffs[0].device

    t0 = time.perf_counter()
    trees: List[merkle.MerkleTree] = []
    coeffs, values = lde_coeffs, lde_values
    shift = spec.coset_shift
    for arity_bits in fri_params.reduction_arity_bits:
        arity = 1 << arity_bits
        tree = round_commit(values, arity, cap_height, hasher)
        challenger.observe_cap(tree.cap_host())
        trees.append(tree)
        beta = challenger.get_extension_challenge()
        beta_pows = [_ext_scalar(host.ext_pow(spec, beta, r), dev, F)
                     for r in range(arity)]
        shift = pow(shift, arity, spec.p)
        coeffs, values = fold_round(coeffs, arity, beta_pows, shift, F)
    keep = coeffs[0].shape[-1] >> fri_params.config.rate_bits
    final = E.to_ints(tuple(c[:keep] for c in coeffs))
    final_poly = [tuple(int(final[d][i]) for d in range(E.D))
                  for i in range(keep)]
    challenger.observe_extension_elements(final_poly)
    _sync_time(timings, "fri_commit_fold", t0, dev)

    t0 = time.perf_counter()
    pow_witness = fri_proof_of_work(challenger, fri_params.config, dev, F,
                                    hasher)
    challenger.observe_element(pow_witness)
    pow_response = challenger.get_challenge()
    assert _leading_zeros64(pow_response) >= \
        _min_leading_zeros(fri_params.config, spec)
    _sync_time(timings, "pow_grind", t0, dev)

    t0 = time.perf_counter()
    n = fri_params.lde_size
    x_indices = [r % n for r in challenger.get_n_challenges(
        fri_params.config.num_query_rounds)]
    query_rounds = _query_rounds(initial_trees, trees, x_indices, fri_params,
                                 E)
    _sync_time(timings, "fri_queries", t0, dev)
    return FriProof(
        commit_phase_merkle_caps=[t.cap_host() for t in trees],
        query_round_proofs=query_rounds, final_poly=final_poly,
        pow_witness=pow_witness)


def prove_openings(instance, oracles, challenger, fri_params,
                   timings: Optional[Dict[str, float]] = None, F=gl,
                   hasher=poseidon_gl) -> FriProof:
    """reference fri/oracle.rs:185-248."""
    alpha = challenger.get_extension_challenge()
    dev = oracles[0].lde.device
    t0 = time.perf_counter()
    values, coeffs = combine_and_ifft(instance, oracles, alpha,
                                      F.SPEC.coset_shift, F)
    _sync_time(timings, "fri_combine", t0, dev)
    return fri_proof(oracles, coeffs, values, challenger, fri_params,
                     timings, F, hasher)
