"""Conditional, dummy-based and cyclic (IVC) recursion (reference
plonky2/src/recursion/{conditional_recursive_verifier.rs, dummy_circuit.rs,
cyclic_recursion.rs}; the JAX package's ``recursion/conditional.py``).

- The selects pick, by a boolean target, one of two proofs given as
  targets (``recursive_verifier.add_virtual_proof_with_pis``), element by
  element in the order of the proof's fields; ``conditionally_verify_proof``
  verifies the selected one.
- A dummy circuit has the shape of given common data and only NoopGate
  rows; its proof stands in for a real one when the condition is false.
  ``dummy_proof_and_vk`` builds and proves it while the outer's gadgets are
  laid out, on the ``device`` the caller names (the card unless it asks
  for the CPU), and hands the proof to the outer's witness through a
  generator with no dependencies.
- Cyclic recursion: a circuit whose public inputs end in its own verifier
  data verifies, when its condition is true, a proof of itself
  (``conditionally_verify_cyclic_proof_or_dummy``).  Its common data is
  fixed in advance (``common_data_for_recursion``) and ``build`` checks
  the circuit against it.

The dummy circuit and proof calls take ``rng`` (the witness generation's
and the prover's draws, ``iop/generator.py``) and ``timings`` (a dict that
gets the seconds of the dummy circuits' builds and proofs under
``dummy_s``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..gates.basic_gates import NoopGate
from ..iop import generator as gen
from ..iop.witness import PartialWitness
from ..plonk import gadgets as gd
from ..plonk.circuit_data import VerifierOnlyCircuitData
from ..plonk.proof import (FriInitialTreeProof, FriProof, FriQueryRound,
                           FriQueryStep, OpeningSet, Proof,
                           ProofWithPublicInputs)
from . import recursive_verifier as rv

# -- the selects (conditional_recursive_verifier.rs:84-135) ------------------


def select_ext(b, cond, x, y):
    return gd.select_ext(b, cond, x, y)


def select_vec(b, cond, v0, v1) -> List:
    return [gd.select(b, cond, x, y) for x, y in zip(v0, v1)]


def select_hash(b, cond, h0, h1) -> List:
    return select_vec(b, cond, h0, h1)


def select_cap(b, cond, c0, c1) -> List[List]:
    return [select_hash(b, cond, h0, h1) for h0, h1 in zip(c0, c1)]


def select_ext_vec(b, cond, v0, v1) -> List:
    return [select_ext(b, cond, x, y) for x, y in zip(v0, v1)]


def _select_opening_set(b, cond, o0: OpeningSet, o1: OpeningSet
                        ) -> OpeningSet:
    """Field by field in the container's order; the lookup openings (none
    for a circuit without lookups) last."""
    return OpeningSet(**{
        name: select_ext_vec(b, cond, getattr(o0, name), getattr(o1, name))
        for name in ("constants", "plonk_sigmas", "wires", "plonk_zs",
                     "plonk_zs_next", "partial_products", "quotient_polys",
                     "lookup_zs", "lookup_zs_next")})


def _select_fri_proof(b, cond, f0: FriProof, f1: FriProof) -> FriProof:
    """The commit-phase caps, then per query round each oracle's leaf and
    siblings and each step's evaluations and siblings, then the final
    polynomial and the PoW witness."""
    caps = [select_cap(b, cond, c0, c1)
            for c0, c1 in zip(f0.commit_phase_merkle_caps,
                              f1.commit_phase_merkle_caps)]
    rounds = []
    for r0, r1 in zip(f0.query_round_proofs, f1.query_round_proofs):
        evals_proofs = [
            (select_vec(b, cond, l0, l1), select_cap(b, cond, s0, s1))
            for (l0, s0), (l1, s1) in zip(
                r0.initial_trees_proof.evals_proofs,
                r1.initial_trees_proof.evals_proofs)]
        steps = [
            FriQueryStep(
                evals=select_ext_vec(b, cond, st0.evals, st1.evals),
                merkle_proof=select_cap(b, cond, st0.merkle_proof,
                                        st1.merkle_proof))
            for st0, st1 in zip(r0.steps, r1.steps)]
        rounds.append(FriQueryRound(FriInitialTreeProof(evals_proofs),
                                    steps))
    return FriProof(
        commit_phase_merkle_caps=caps, query_round_proofs=rounds,
        final_poly=select_ext_vec(b, cond, f0.final_poly, f1.final_poly),
        pow_witness=gd.select(b, cond, f0.pow_witness, f1.pow_witness))


def select_proof_with_pis(b, cond, p0: ProofWithPublicInputs,
                          p1: ProofWithPublicInputs) -> ProofWithPublicInputs:
    """p0 where ``cond`` is 1, p1 where it is 0: the three caps, the
    openings, the FRI proof, then the public inputs."""
    q0, q1 = p0.proof, p1.proof
    proof = Proof(
        wires_cap=select_cap(b, cond, q0.wires_cap, q1.wires_cap),
        plonk_zs_partial_products_cap=select_cap(
            b, cond, q0.plonk_zs_partial_products_cap,
            q1.plonk_zs_partial_products_cap),
        quotient_polys_cap=select_cap(b, cond, q0.quotient_polys_cap,
                                      q1.quotient_polys_cap),
        openings=_select_opening_set(b, cond, q0.openings, q1.openings),
        opening_proof=_select_fri_proof(b, cond, q0.opening_proof,
                                        q1.opening_proof))
    return ProofWithPublicInputs(
        proof=proof,
        public_inputs=select_vec(b, cond, p0.public_inputs,
                                 p1.public_inputs))


# -- conditional verification (conditional_recursive_verifier.rs:26-82) -----


def conditionally_verify_proof(b, condition, proof0, vk0, proof1, vk1,
                               inner_common) -> None:
    """Verify proof0 under vk0 where ``condition`` is 1, else proof1 under
    vk1; both of circuits of ``inner_common``."""
    selected = select_proof_with_pis(b, condition, proof0, proof1)
    selected_vk = VerifierOnlyCircuitData(
        constants_sigmas_cap=select_cap(b, condition,
                                        vk0.constants_sigmas_cap,
                                        vk1.constants_sigmas_cap),
        circuit_digest=select_hash(b, condition, vk0.circuit_digest,
                                   vk1.circuit_digest))
    rv.verify_proof(b, selected, selected_vk, inner_common)


def conditionally_verify_proof_or_dummy(b, condition, proof, vk,
                                        inner_common, device=None,
                                        rng: Optional[gen.Rng] = None,
                                        timings: Optional[Dict] = None
                                        ) -> None:
    """Verify ``proof`` under ``vk`` where ``condition`` is 1, else a
    dummy proof of ``inner_common``'s shape, made now on ``device``."""
    dummy_proof_t, dummy_vk_t = dummy_proof_and_vk(b, inner_common, device,
                                                   rng, timings)
    conditionally_verify_proof(b, condition, proof, vk, dummy_proof_t,
                               dummy_vk_t, inner_common)


# -- dummy circuits (dummy_circuit.rs) ---------------------------------------


def _timed(timings, f, *args):
    t0 = time.perf_counter()
    out = f(*args)
    if timings is not None:
        timings["dummy_s"] = timings.get("dummy_s", 0.0) + \
            time.perf_counter() - t0
    return out


def dummy_circuit(common, device=None):
    """A circuit of NoopGate rows with the shape of ``common``
    (dummy_circuit.rs:92-130): its gate set, its public inputs, and
    degree - ceil(public inputs / 8) - 2 NoopGates, which leaves room for
    the public-input hash's sponge rows, the PublicInputGate and one
    ConstantGate.  Built on ``device`` with ``common`` as its goal: the
    build raises ``ValueError`` unless its common data equals it."""
    from ..plonk.builder import CircuitBuilder

    if common.config.zero_knowledge:
        raise ValueError("a dummy circuit does not hide")
    num_noop = common.degree - -(-common.num_public_inputs // 8) - 2
    builder = CircuitBuilder(common.config, spec=common.spec)
    for _ in range(num_noop):
        builder.add_gate(NoopGate(), [])
    for g in common.gates:
        builder.add_gate_to_gate_set(g)
    for _ in range(common.num_public_inputs):
        builder.register_public_input(builder.add_virtual_target())
    builder.goal_common_data = common
    return builder.build(device)


def dummy_proof(circuit, nonzero_public_inputs: Dict[int, int],
                rng: Optional[gen.Rng] = None) -> ProofWithPublicInputs:
    """A proof of the dummy ``circuit`` with these public inputs, the rest
    zero (dummy_circuit.rs:72-89)."""
    pw = PartialWitness()
    for i, t in enumerate(circuit.prover_only.public_inputs):
        pw.set_target(t, nonzero_public_inputs.get(i, 0))
    return circuit.prove(pw, rng)


class _DummyProofGenerator(gen.SimpleGenerator):
    """Sets the dummy proof's and verifier data's targets; it depends on
    nothing, so witness generation runs it in its first round
    (dummy_circuit.rs:163-240)."""

    def __init__(self, proof_t, proof, vk_t, vk):
        self.proof_t, self.proof = proof_t, proof
        self.vk_t, self.vk = vk_t, vk

    def dependencies(self):
        return []

    def run_once(self, witness, out):
        pw = PartialWitness()
        rv.set_proof_with_pis_target(pw, self.proof_t, self.proof)
        rv.set_verifier_data_target(pw, self.vk_t, self.vk)
        out.extend(pw.target_values.items())


def dummy_proof_and_vk(b, common, device=None,
                       rng: Optional[gen.Rng] = None,
                       timings: Optional[Dict] = None) -> Tuple:
    """Targets of a dummy proof of ``common``'s shape and of its verifier
    data, set at witness time to the dummy circuit's proof, which is built
    and proved here on ``device`` (dummy_circuit.rs:132-159)."""
    circuit = _timed(timings, dummy_circuit, common, device)
    proof = _timed(timings, dummy_proof, circuit, {}, rng)
    proof_t = rv.add_virtual_proof_with_pis(b, common)
    vk_t = rv.add_virtual_verifier_data(b, common.config.fri_config.cap_height)
    b.add_simple_generator(_DummyProofGenerator(
        proof_t, proof, vk_t, circuit.verifier_only))
    return proof_t, vk_t


# -- cyclic recursion (cyclic_recursion.rs) ----------------------------------


def vk_from_public_inputs(public_inputs, common):
    """(circuit digest, constants/sigmas cap) from the tail of a proof's
    public inputs, where ``add_verifier_data_public_inputs`` put them."""
    n = common.spec.num_hash_out_elts
    cap_len = 1 << common.config.fri_config.cap_height
    start = len(public_inputs) - n - n * cap_len
    digest = list(public_inputs[start:start + n])
    cap = [list(public_inputs[start + n * (i + 1):start + n * (i + 2)])
           for i in range(cap_len)]
    return digest, cap


def add_verifier_data_public_inputs(b) -> VerifierOnlyCircuitData:
    """Targets of the circuit's own verifier data, registered as its last
    public inputs: the digest, then the cap (circuit_builder.rs:452-467)."""
    if b.verifier_data_public_input is not None:
        raise ValueError("the verifier data is already among the public "
                         "inputs")
    vk = rv.add_virtual_verifier_data(b, b.config.fri_config.cap_height)
    b.register_public_inputs(vk.circuit_digest)
    for h in vk.constants_sigmas_cap:
        b.register_public_inputs(h)
    b.verifier_data_public_input = vk
    return vk


def conditionally_verify_cyclic_proof_or_dummy(
        b, condition, cyclic_proof_with_pis, common, device=None,
        rng: Optional[gen.Rng] = None,
        timings: Optional[Dict] = None) -> None:
    """Where ``condition`` is 1, verify a proof of this very circuit, whose
    verifier data are the inner proof's last public inputs and this
    circuit's own; else a dummy proof (cyclic_recursion.rs:115-195).  The
    circuit must build to ``common``: it becomes the builder's
    ``goal_common_data``."""
    vk = b.verifier_data_public_input
    if vk is None:
        raise ValueError("call add_verifier_data_public_inputs before "
                         "cyclic recursion")
    if b.goal_common_data is None:
        b.goal_common_data = common
    elif b.goal_common_data != common:
        raise ValueError("the goal common data differs from the cyclic "
                         "proof's")

    inner_digest, inner_cap = vk_from_public_inputs(
        cyclic_proof_with_pis.public_inputs, common)
    for t, u in zip(inner_digest, vk.circuit_digest):
        b.connect(t, u)
    for h_t, h_u in zip(inner_cap, vk.constants_sigmas_cap):
        for t, u in zip(h_t, h_u):
            b.connect(t, u)

    dummy_proof_t, dummy_vk_t = dummy_proof_and_vk(b, common, device, rng,
                                                   timings)
    conditionally_verify_proof(b, condition, cyclic_proof_with_pis, vk,
                               dummy_proof_t, dummy_vk_t, common)
    for g in common.gates:
        b.add_gate_to_gate_set(g)


def cyclic_base_proof(common, verifier_only,
                      nonzero_public_inputs: Optional[Dict[int, int]] = None,
                      device=None, rng: Optional[gen.Rng] = None,
                      timings: Optional[Dict] = None
                      ) -> ProofWithPublicInputs:
    """The base case's inner proof: a dummy proof whose public inputs end
    in the cyclic circuit's verifier data (dummy_circuit.rs:37-68)."""
    pis = dict(nonzero_public_inputs or {})
    n = common.spec.num_hash_out_elts
    start = common.num_public_inputs - n * (
        1 + (1 << common.config.fri_config.cap_height))
    flat = list(verifier_only.circuit_digest) + [
        x for h in verifier_only.constants_sigmas_cap for x in h]
    for j, v in enumerate(flat):
        pis[start + j] = int(v)
    circuit = _timed(timings, dummy_circuit, common, device)
    return _timed(timings, dummy_proof, circuit, pis, rng)


def check_cyclic_proof_verifier_data(proof_with_pis, verifier_only,
                                     common) -> None:
    """Raise ``ValueError`` unless the verifier data at the end of the
    proof's public inputs are ``verifier_only``'s
    (cyclic_recursion.rs:197-230)."""
    digest, cap = vk_from_public_inputs(proof_with_pis.public_inputs, common)
    if digest != list(verifier_only.circuit_digest):
        raise ValueError("the cyclic proof's verifier digest differs")
    if cap != [list(h) for h in verifier_only.constants_sigmas_cap]:
        raise ValueError("the cyclic proof's verifier cap differs")


def common_data_for_recursion(config):
    """Common data that a cyclic circuit can build to (the reference's
    cyclic_recursion.rs test helper ``common_data_for_recursion``): an
    empty circuit wrapped twice in a recursive verifier, the second wrap
    padded with NoopGates to 1 << 12 gates before its layout (with the
    public-input and constant rows that makes 2^13 rows under
    ``standard_recursion_config_gl()``, where the repeated-hash counter's
    5723 gates fit).  The circuits are laid out, not committed.

    The JAX package's version pads only when the first wrap already has
    2^12 rows, which under the standard config it never has (2^11): its
    fixed point is the unpadded one (2^12 rows), which the counter circuit
    does not fit."""
    from ..plonk.builder import CircuitBuilder

    common = CircuitBuilder(config).build_common()
    for wrap in range(2):
        b = CircuitBuilder(config)
        proof_t = rv.add_virtual_proof_with_pis(b, common)
        vk_t = rv.add_virtual_verifier_data(
            b, common.config.fri_config.cap_height)
        rv.verify_proof(b, proof_t, vk_t, common)
        if wrap == 1:
            while b.num_gates() < 1 << 12:
                b.add_gate(NoopGate(), [])
        common = b.build_common()
    return common
