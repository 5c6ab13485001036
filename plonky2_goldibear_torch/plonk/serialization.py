"""Reading the reference's byte format (reference
plonky2/src/util/serialization/mod.rs, gate_serialization.rs; the read side
of the JAX package's ``plonk/serialization.py``).

``read_common_circuit_data``, ``read_verifier_only_circuit_data`` and
``read_proof_with_public_inputs`` take the bytes the reference (or the JAX
package's writers) produce and return the port's containers, so that the
port's verifier checks circuits and proofs made elsewhere, such as the
reference's recursive-verifier proof in ``tests/data/``.  Field elements
are 8-byte little-endian words; digests are 32 bytes (Goldilocks: 4 u64,
BabyBear: 8 u32), or, for a byte hasher (the Keccak config's, passed as
``hasher=``), its HASH_SIZE raw bytes.

A lookup circuit's common data carries its tables; the lookup gates (tags
6 and 7) name theirs by index and hash.  The width-24 Poseidon2 gate has
no tag in the format, so a circuit that hashes with it in the circuit has
no bytes.  Every other gate tag of the reference's serializer reads (tags
0-19).  The writers are ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from ..field import host
from ..gates.access_gates import (BaseSumGate, ExponentiationGate,
                                  RandomAccessGate)
from ..gates.basic_gates import (ArithmeticGate, ConstantGate, NoopGate,
                                 PublicInputGate)
from ..gates.coset_interpolation import CosetInterpolationGate
from ..gates.extension_gates import ArithmeticExtensionGate, MulExtensionGate
from ..gates.lookup_gates import LookupGate, LookupTableGate
from ..gates.misc_gates import (AddManyGate, ApplyMat4Gate,
                                Poseidon2InternalPermutationGate)
from ..gates.poseidon import PoseidonGate
from ..gates.poseidon2_bb_gate import Poseidon2BabyBearGate
from ..gates.poseidon_mds import PoseidonMdsGate
from ..gates.reducing import ReducingExtensionGate, ReducingGate
from ..gates.selectors import SelectorsInfo
from .circuit_data import CommonCircuitData, VerifierOnlyCircuitData
from .config import CircuitConfig, FriConfig, FriParams, FriReductionStrategy
from .proof import (FriInitialTreeProof, FriProof, FriQueryRound,
                    FriQueryStep, OpeningSet, Proof, ProofWithPublicInputs)


class Buffer:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read_exact(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("buffer underrun")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_u8(self) -> int:
        return self.read_exact(1)[0]

    def read_bool(self) -> bool:
        v = self.read_u8()
        if v not in (0, 1):
            raise ValueError(f"bool byte {v}")
        return v == 1

    def read_u16(self) -> int:
        return struct.unpack("<H", self.read_exact(2))[0]

    def read_u32(self) -> int:
        return struct.unpack("<I", self.read_exact(4))[0]

    def read_usize(self) -> int:
        return struct.unpack("<Q", self.read_exact(8))[0]

    def read_usize_vec(self) -> List[int]:
        return [self.read_usize() for _ in range(self.read_usize())]

    def read_field(self, spec=host.GOLDILOCKS) -> int:
        # 8-byte LE words, BabyBear's too (reference hash_types.rs)
        return struct.unpack("<Q", self.read_exact(8))[0] % spec.p

    def read_field_vec(self, n: int, spec=host.GOLDILOCKS) -> List[int]:
        return [self.read_field(spec) for _ in range(n)]

    def read_field_ext(self, spec=host.GOLDILOCKS) -> Tuple[int, ...]:
        return tuple(self.read_field(spec) for _ in range(spec.ext_degree))

    def read_field_ext_vec(self, n: int, spec=host.GOLDILOCKS):
        return [self.read_field_ext(spec) for _ in range(n)]

    def read_hash(self, spec=host.GOLDILOCKS, digest_bytes=None):
        # HASH_SIZE bytes (reference mod.rs:253-262): 4 u64 or 8 u32, or
        # a byte hasher's digest_bytes raw bytes (BytesHash)
        if digest_bytes is not None:
            return bytes(self.read_exact(digest_bytes))
        if spec.bits > 32:
            return [struct.unpack("<Q", self.read_exact(8))[0] % spec.p
                    for _ in range(4)]
        return [struct.unpack("<I", self.read_exact(4))[0] % spec.p
                for _ in range(8)]

    def read_merkle_cap(self, cap_height: int, spec=host.GOLDILOCKS,
                        digest_bytes=None):
        return [self.read_hash(spec, digest_bytes)
                for _ in range(1 << cap_height)]

    def read_merkle_proof(self, spec=host.GOLDILOCKS, digest_bytes=None):
        return [self.read_hash(spec, digest_bytes)
                for _ in range(self.read_u8())]

    def expect_end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{len(self.data) - self.pos} bytes left over")


# -- config and parameters ---------------------------------------------------


def read_fri_reduction_strategy(buf: Buffer) -> FriReductionStrategy:
    variant = buf.read_u8()
    if variant == 0:
        return FriReductionStrategy(kind="fixed",
                                    fixed=tuple(buf.read_usize_vec()))
    if variant == 1:
        return FriReductionStrategy(kind="constant_arity",
                                    arity_bits=buf.read_usize(),
                                    final_poly_bits=buf.read_usize())
    if variant == 2:
        mx = buf.read_usize() if buf.read_u8() else None
        return FriReductionStrategy(kind="min_size", max_arity_bits=mx)
    raise ValueError(f"FRI reduction strategy {variant}")


def read_fri_config(buf: Buffer) -> FriConfig:
    rate_bits = buf.read_usize()
    cap_height = buf.read_usize()
    num_query_rounds = buf.read_usize()
    proof_of_work_bits = buf.read_u32()
    return FriConfig(rate_bits=rate_bits, cap_height=cap_height,
                     proof_of_work_bits=proof_of_work_bits,
                     num_query_rounds=num_query_rounds,
                     reduction_strategy=read_fri_reduction_strategy(buf))


def read_circuit_config(buf: Buffer) -> CircuitConfig:
    num_wires = buf.read_usize()
    num_routed_wires = buf.read_usize()
    num_constants = buf.read_usize()
    security_bits = buf.read_usize()
    num_challenges = buf.read_usize()
    max_qdf = buf.read_usize()
    use_base = buf.read_bool()
    zk = buf.read_bool()
    return CircuitConfig(num_wires=num_wires,
                         num_routed_wires=num_routed_wires,
                         num_constants=num_constants,
                         use_base_arithmetic_gate=use_base,
                         security_bits=security_bits,
                         num_challenges=num_challenges, zero_knowledge=zk,
                         max_quotient_degree_factor=max_qdf,
                         fri_config=read_fri_config(buf))


def read_fri_params(buf: Buffer) -> FriParams:
    config = read_fri_config(buf)
    arity_bits = tuple(buf.read_usize_vec())
    degree_bits = buf.read_usize()
    hiding = buf.read_bool()
    return FriParams(config=config, hiding=hiding, degree_bits=degree_bits,
                     reduction_arity_bits=arity_bits)


def read_selectors_info(buf: Buffer) -> SelectorsInfo:
    indices = buf.read_usize_vec()
    groups = [(buf.read_usize(), buf.read_usize())
              for _ in range(buf.read_usize())]
    return SelectorsInfo(selector_indices=indices, groups=groups)


# -- gates (the DefaultGateSerializer's tags, reference
#    gate_serialization.rs:143-166) ------------------------------------------

def _read_lookup_gate(buf: Buffer, make, luts):
    """A lookup gate: its fields, then the table's index and hash."""
    fields = [buf.read_usize() for _ in range(make.__code__.co_argcount - 1)]
    lut_index = buf.read_usize()
    if lut_index >= len(luts):
        raise ValueError(f"lookup table {lut_index} of {len(luts)}")
    gate = make(luts[lut_index], *fields)
    if gate.lut_hash != buf.read_exact(32):
        raise ValueError("lookup table hash mismatch")
    return gate


def _read_gate(buf: Buffer, spec: host.FieldSpec, config: CircuitConfig,
               luts=()):
    tag = buf.read_u32()
    D = spec.ext_degree
    if tag == 0:
        return ArithmeticGate(buf.read_usize())
    if tag == 1:
        return ArithmeticExtensionGate(buf.read_usize(), D)
    if tag == 2:
        return BaseSumGate(buf.read_usize(), 2)
    if tag == 3:
        return ConstantGate(buf.read_usize())
    if tag == 4:
        subgroup_bits = buf.read_usize()
        degree = buf.read_usize()
        weights = buf.read_field_vec(buf.read_usize(), spec)
        return CosetInterpolationGate(subgroup_bits, degree, weights, spec)
    if tag == 5:
        return ExponentiationGate(buf.read_usize(), spec)
    if tag == 6:
        return _read_lookup_gate(
            buf, lambda lut, slots: LookupGate(slots, lut), luts)
    if tag == 7:
        return _read_lookup_gate(
            buf, lambda lut, slots, last_row: LookupTableGate(
                slots, lut, last_row), luts)
    if tag == 8:
        return MulExtensionGate(buf.read_usize(), D)
    if tag == 9:
        return NoopGate()
    if tag == 10:
        return PoseidonMdsGate(D)
    if tag == 11:
        return PoseidonGate()
    if tag == 12:
        return PublicInputGate(spec.num_hash_out_elts)
    if tag == 13:
        bits = buf.read_usize()
        copies = buf.read_usize()
        return RandomAccessGate(bits, copies, buf.read_usize())
    if tag == 14:
        return ReducingExtensionGate(buf.read_usize(), D)
    if tag == 15:
        return ReducingGate(buf.read_usize(), D)
    if tag == 16:
        return Poseidon2BabyBearGate.from_config(config)
    if tag == 17:
        num_addends = buf.read_usize()
        return AddManyGate(num_addends, buf.read_usize())
    if tag == 18:
        return ApplyMat4Gate(buf.read_usize(), D)
    if tag == 19:
        return Poseidon2InternalPermutationGate(D)
    raise ValueError(f"unknown gate tag {tag}")


# -- the three files --------------------------------------------------------


def read_common_circuit_data(data: bytes,
                             spec: host.FieldSpec = host.GOLDILOCKS
                             ) -> CommonCircuitData:
    """reference serialization/mod.rs:774-860."""
    buf = Buffer(data)
    config = read_circuit_config(buf)
    fri_params = read_fri_params(buf)
    selectors_info = read_selectors_info(buf)
    quotient_degree_factor = buf.read_usize()
    num_gate_constraints = buf.read_usize()
    num_constants = buf.read_usize()
    num_public_inputs = buf.read_usize()
    k_is = buf.read_field_vec(buf.read_usize(), spec)
    num_partial_products = buf.read_usize()
    num_lookup_polys = buf.read_usize()
    num_lookup_selectors = buf.read_usize()
    luts = [tuple((buf.read_u16(), buf.read_u16())
                  for _ in range(buf.read_usize()))
            for _ in range(buf.read_usize())]
    gates = [_read_gate(buf, spec, config, luts)
             for _ in range(buf.read_usize())]
    buf.expect_end()
    return CommonCircuitData(
        config=config, spec=spec, fri_params=fri_params, gates=gates,
        selectors_info=selectors_info,
        quotient_degree_factor=quotient_degree_factor,
        num_gate_constraints=num_gate_constraints,
        num_constants=num_constants, num_public_inputs=num_public_inputs,
        k_is=k_is, num_partial_products=num_partial_products,
        num_lookup_polys=num_lookup_polys,
        num_lookup_selectors=num_lookup_selectors, luts=luts)


def _digest_bytes(hasher):
    """A byte hasher's digest size, else None (field-element digests)."""
    return hasher.HASH_SIZE if getattr(hasher, "DIGEST_IS_BYTES", False) \
        else None


def read_verifier_only_circuit_data(data: bytes,
                                    spec: host.FieldSpec = host.GOLDILOCKS,
                                    hasher=None) -> VerifierOnlyCircuitData:
    """``hasher``: the Merkle hasher (None: the field's own)."""
    db = _digest_bytes(hasher)
    buf = Buffer(data)
    cap = buf.read_merkle_cap(buf.read_usize(), spec, db)
    digest = buf.read_hash(spec, db)
    buf.expect_end()
    return VerifierOnlyCircuitData(constants_sigmas_cap=cap,
                                   circuit_digest=digest)


def read_proof_with_public_inputs(data: bytes, common: CommonCircuitData,
                                  hasher=None) -> ProofWithPublicInputs:
    """reference serialization/mod.rs:1023-1090.  ``hasher``: the Merkle
    hasher (None: the field's own); a byte hasher's digests are its
    HASH_SIZE raw bytes (mod.rs:253-262 is generic over it)."""
    spec = common.spec
    db = _digest_bytes(hasher)
    buf = Buffer(data)
    config = common.config
    ch = config.fri_config.cap_height
    wires_cap = buf.read_merkle_cap(ch, spec, db)
    zs_pp_cap = buf.read_merkle_cap(ch, spec, db)
    quotient_cap = buf.read_merkle_cap(ch, spec, db)

    # the openings (reference mod.rs:343-388: the lookup Zs sit between
    # plonk_zs_next and partial_products)
    def exts(n):
        return buf.read_field_ext_vec(n, spec)

    constants = exts(common.num_constants)
    plonk_sigmas = exts(config.num_routed_wires)
    wires = exts(config.num_wires)
    plonk_zs = exts(config.num_challenges)
    plonk_zs_next = exts(config.num_challenges)
    lookup_zs = exts(common.num_all_lookup_polys())
    lookup_zs_next = exts(common.num_all_lookup_polys())
    partial_products = exts(common.num_partial_products
                            * config.num_challenges)
    quotient_polys = exts(common.num_quotient_polys())
    openings = OpeningSet(
        constants=constants, plonk_sigmas=plonk_sigmas, wires=wires,
        plonk_zs=plonk_zs, plonk_zs_next=plonk_zs_next,
        partial_products=partial_products, quotient_polys=quotient_polys,
        lookup_zs=lookup_zs, lookup_zs_next=lookup_zs_next)

    # the FRI proof (reference mod.rs:575-600), salted leaves included
    params = common.fri_params
    leaf_lens = common.fri_leaf_lens()
    caps = [buf.read_merkle_cap(ch, spec, db)
            for _ in params.reduction_arity_bits]
    query_rounds = []
    for _ in range(config.fri_config.num_query_rounds):
        evals_proofs = [(buf.read_field_vec(n, spec),
                         buf.read_merkle_proof(spec, db)) for n in leaf_lens]
        steps = [FriQueryStep(evals=exts(1 << ar),
                              merkle_proof=buf.read_merkle_proof(spec, db))
                 for ar in params.reduction_arity_bits]
        query_rounds.append(FriQueryRound(
            initial_trees_proof=FriInitialTreeProof(evals_proofs),
            steps=steps))
    final_poly = exts(params.final_poly_len)
    pow_witness = buf.read_field(spec)
    proof = Proof(wires_cap=wires_cap,
                  plonk_zs_partial_products_cap=zs_pp_cap,
                  quotient_polys_cap=quotient_cap, openings=openings,
                  opening_proof=FriProof(
                      commit_phase_merkle_caps=caps,
                      query_round_proofs=query_rounds,
                      final_poly=final_poly, pow_witness=pow_witness))
    public_inputs = buf.read_field_vec(buf.read_usize(), spec)
    buf.expect_end()
    return ProofWithPublicInputs(proof=proof, public_inputs=public_inputs)
