"""FRI opening prover (reference plonky2/src/fri/oracle.rs:185-248,
fri/prover.rs:22-255; the JAX package's ``fri/prover.py``), with the
transcript on the host (``prove_openings``) or on the device
(``prove_openings_device``, the device-transcript prover's).

The combined codeword is built in values form on the whole LDE coset (one
batched pass per opening batch) from alpha and the claimed openings as
device scalars, one extension iFFT recovers its coefficients, and each
fold round is a coefficient reduction by the powers of a device beta, a
coset FFT and a Merkle commit.  The sync proof-of-work grind searches
candidates in ascending batches and returns the smallest valid witness;
the device one is one kernel (``ops/transcript.py:pow_grind``) that finds
the same witness.  Query rounds gather leaf rows and sibling chains from
every tree.  Every function takes the field module ``F`` and the hasher of
the circuit (Goldilocks and Poseidon-GL by default); the extension is
``ext_ops(F)``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..field import ext as ext_mod
from ..field import fft as fftm
from ..field import gl, host
from ..hash import merkle, poseidon_gl
from ..ops import transcript as T
from ..plonk.proof import (FriInitialTreeProof, FriProof, FriQueryRound,
                           FriQueryStep)


def _sync_time(timings, name, t0, device):
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def reduce_openings(spec: host.FieldSpec, values: Sequence[Tuple[int, ...]],
                    alpha: Tuple[int, ...]) -> Tuple[int, ...]:
    """sum_i alpha^i v_i on the host (the verifier's)."""
    acc = host.ext_zero(spec)
    for v in reversed(list(values)):
        acc = host.ext_add(spec, host.ext_mul(spec, acc, alpha), v)
    return acc


def ext_scalar(value, device, F=gl):
    """A host extension element as a tuple of D device scalars."""
    arr = F.from_ints([int(v) for v in value], device)
    return tuple(arr.unbind(0))


def ext_powers(E, z, n: int):
    """[1, z, ..., z^(n-1)] as an ext (n,) array from a device ext scalar,
    by log-doubling (the JAX package's ``_ext_powers_scalar``)."""
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


def combine_and_ifft(batches, oracles, alpha, shift: int, F=gl):
    """The combined codeword sum_b alpha^(...) (sum_j alpha^j f_j - y_b) /
    (x - z_b) on the LDE coset, and its coefficients.  ``batches``: per
    opening batch (its polynomials as (oracle, index) pairs, its claimed
    values as D device tensors (P_b,), its point as a device ext scalar);
    ``alpha`` a device ext scalar.  The reduced openings sum_j alpha^j v_j
    are taken on the device (JAX ``_combine_and_ifft_async``)."""
    spec = F.SPEC
    E = ext_mod.ext_ops(F)
    ldes = [o.lde for o in oracles]
    dev = ldes[0].device
    m = ldes[0].shape[-1]
    w = spec.two_adic_generator(host.log2_strict(m))
    xs_ext = E.from_base(F.mul_const(fftm.powers(w, m, dev, F), shift))
    sum_vals = None
    for polys, vals, point in batches:
        rows = torch.stack([ldes[o][i] for o, i in polys])   # (P_b, m)
        alpha_pows = ext_powers(E, alpha, len(polys))
        reduced = tuple(F.batch_sum(F.mul(rows, a[:, None]), axis=0)
                        for a in alpha_pows)
        red_open = tuple(F.batch_sum(c, axis=-1)
                         for c in E.mul(alpha_pows, vals))
        numerator = E.sub(reduced, red_open)
        quotient = E.mul(numerator, E.inv(E.sub(xs_ext, point)))
        if sum_vals is None:
            sum_vals = quotient
        else:
            shift_pow = E.mul(tuple(a[-1] for a in alpha_pows), alpha)
            sum_vals = E.add(E.mul(sum_vals, shift_pow), quotient)
    return sum_vals, fftm.ext_coset_ifft(sum_vals, shift, F)


def batch_polys(instance):
    """Each FRI batch's polynomials as (oracle, index) pairs."""
    return [[(p.oracle_index, p.polynomial_index) for p in b.polynomials]
            for b in instance.batches]


def fold_round(coeffs, arity: int, beta, shift: int, F=gl):
    """coeffs (m,) ext -> folded (m / arity,) ext, sum_r beta^r c_r with
    the powers of the device ext scalar ``beta``, and its values on the
    shift coset (reference fri/prover.rs:115-125)."""
    E = ext_mod.ext_ops(F)
    m = coeffs[0].shape[-1]
    chunked = tuple(c.reshape(m // arity, arity) for c in coeffs)
    folded = tuple(c[:, 0] for c in chunked)
    beta_pow = beta
    for r in range(1, arity):
        folded = E.add(folded, E.mul(tuple(c[:, r] for c in chunked),
                                     beta_pow))
        if r + 1 < arity:
            beta_pow = E.mul(beta_pow, beta)
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


def grind_bits(config, spec: host.FieldSpec) -> int:
    """k: a response passes when its canonical value is below 2^k."""
    return 64 - _min_leading_zeros(config, spec)


def fri_proof_of_work(challenger, config, device, F=gl,
                      hasher=poseidon_gl) -> int:
    """The smallest w with leading_zeros(H(transcript || w)) >= the bound of
    ``_min_leading_zeros`` (for BabyBear: canonical response < 2^15):
    candidates are tried in ascending batches through the hasher's batched
    permutation (the kernel on the card), and the first hit of the first
    batch with one is the answer (``ops/transcript.py:pow_grind_plain``)."""
    buf = challenger.input_buffer
    assert len(buf) < hasher.RATE
    w, found = F.to_ints(T.pow_grind_plain(
        F.from_ints(challenger.sponge_state, device),
        F.from_ints(buf, device) if buf else None,
        grind_bits(config, F.SPEC), permute=hasher.permute))
    assert found, "PoW grind exhausted 2^32 candidates"
    return int(w)


def query_rounds_from(init, steps_data, E) -> List[FriQueryRound]:
    """The query rounds from host data: per initial tree and per fold
    tree, (leaf rows, sibling chains), one entry a query."""
    rounds = []
    for q in range(len(init[0][0])):
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
    return query_rounds_from(init, steps_data, E)


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
        beta = ext_scalar(challenger.get_extension_challenge(), dev, F)
        shift = pow(shift, arity, spec.p)
        coeffs, values = fold_round(coeffs, arity, beta, shift, F)
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
    """reference fri/oracle.rs:185-248; the batches' values and points are
    host ints on ``instance``."""
    dev = oracles[0].lde.device
    alpha = ext_scalar(challenger.get_extension_challenge(), dev, F)
    batches = [(polys, tuple(F.from_ints(list(c), dev)
                             for c in zip(*b.values)),
                ext_scalar(b.point, dev, F))
               for polys, b in zip(batch_polys(instance), instance.batches)]
    t0 = time.perf_counter()
    values, coeffs = combine_and_ifft(batches, oracles, alpha,
                                      F.SPEC.coset_shift, F)
    _sync_time(timings, "fri_combine", t0, dev)
    return fri_proof(oracles, coeffs, values, challenger, fri_params,
                     timings, F, hasher)


# -- the device transcript (the JAX package's ``fri_proof_async``) ---------


def fri_proof_device(lde_coeffs, lde_values, dc, fri_params, F=gl,
                     hasher=poseidon_gl):
    """The commit phase and the grind with the transcript on the device
    (``hash/device_challenger.py``; reference fri/prover.rs:22-77): each
    round's cap observed on the device, beta left there, the grind one
    kernel.  Returns the device handles of the proof's final gather:
    (fold trees, final polynomial as D tensors, PoW witness as a field
    scalar, pow_ok flag (1,), query challenges (num_query_rounds,))."""
    spec = F.SPEC
    E = ext_mod.ext_ops(F)
    cap_height = fri_params.config.cap_height
    trees: List[merkle.MerkleTree] = []
    coeffs, values = lde_coeffs, lde_values
    shift = spec.coset_shift
    for arity_bits in fri_params.reduction_arity_bits:
        arity = 1 << arity_bits
        tree = round_commit(values, arity, cap_height, hasher)
        dc.observe_cap(tree.cap)
        trees.append(tree)
        beta = dc.get_extension_challenge(E.D)
        shift = pow(shift, arity, spec.p)
        coeffs, values = fold_round(coeffs, arity, beta, shift, F)
    keep = coeffs[0].shape[-1] >> fri_params.config.rate_bits
    final = tuple(c[:keep] for c in coeffs)
    dc.observe_ext_flat(final)

    k = grind_bits(fri_params.config, spec)
    state, leftover, _ = dc.grind_inputs()
    found, _ = T.pow_grind(state, leftover, k)
    dc.observe_array(found[:1])
    response = dc.get_challenge_scalar()
    pow_ok = F.grind_response_ok(response[None], k) & (found[1:] != 0)
    query_challenges = dc.get_n_challenges(
        fri_params.config.num_query_rounds)
    return trees, final, found[0], pow_ok, query_challenges


def prove_openings_device(batch_polys: Sequence, oracles, dc, fri_params,
                          batch_vals: Sequence, points: Sequence, F=gl,
                          hasher=poseidon_gl):
    """``prove_openings`` with the transcript on the device (JAX
    ``prove_openings_async``): ``batch_polys`` each batch's (oracle,
    index) pairs, ``batch_vals`` its claimed values (D device tensors),
    ``points`` device ext scalars.  Returns what ``fri_proof_device``
    does."""
    alpha = dc.get_extension_challenge(ext_mod.ext_ops(F).D)
    values, coeffs = combine_and_ifft(
        list(zip(batch_polys, batch_vals, points)), oracles, alpha,
        F.SPEC.coset_shift, F)
    return fri_proof_device(coeffs, values, dc, fri_params, F, hasher)
