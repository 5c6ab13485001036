"""Circuit data, built or carried across (reference
plonky2/src/plonk/circuit_data.rs:191-740).

A circuit reaches the prover, ``plonk/prover.py:prove``, as a ``Circuit``:
the circuit and its witness on one device.  Two routes make one:

- ``plonk/builder.py:CircuitBuilder.build()`` returns a ``CircuitData``
  (common data, prover-only data with the generators, verifier-only data);
  ``CircuitData.circuit(pw, rng)`` runs witness generation and moves the
  wire matrix to the device, and ``CircuitData.prove(pw, rng)`` proves it.
- ``load_circuit`` takes the constants/sigmas values, the full wire matrix,
  the public inputs and the circuit metadata (field, config, FRI arities,
  gate ids, selector layout, coset shifts, digest, random wire) as data,
  commits the constants/sigmas itself and returns a ``Circuit``.
  ``load_fixture`` reads the same data from a fixture file written by the
  JAX package (``tests/test_torch_prove.py --write-fixtures``).

The field name ("goldilocks", the default, or "babybear") picks the field
module, its extension and its algebraic hasher once: Goldilocks with
Poseidon-GL, or BabyBear (Montgomery form) with Poseidon2-BB.  A circuit
carries two hashers, as the reference's configs do: ``hasher`` commits the
Merkle trees and runs the transcript, ``inner_hasher`` (always the field's
own) hashes in the circuit and hashes the public inputs.  They differ
only under the Keccak config (``hash/keccak_hasher.py``, Goldilocks),
whose digests are ``bytes``.

``CircuitData.verify`` checks a proof with the verifier of
``plonk/verifier.py`` (``Circuit.verifier_data`` gives a loaded circuit's
verifier data); ``plonk/serialization.py`` reads common circuit data,
verifier data and proofs in the reference's byte format.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import device as devmod
from ..field import bb, ext, gl, host
from ..fri.oracle import PolynomialBatch
from ..gates import gate_from_id
from ..gates.selectors import SelectorsInfo
from ..hash import keccak_hasher, poseidon2_bb, poseidon_gl
from ..iop.generator import Rng, generate_partial_witness, schedule_key
from . import prover
from .config import (CircuitConfig, FriConfig, FriParams,
                     FriReductionStrategy)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")

# a digest: field elements, or the bytes of a byte hasher's (Keccak)
Digest = Union[List[int], bytes]


def _digest_copy(d: Digest) -> Digest:
    return d if isinstance(d, bytes) else list(d)


# FRI oracle indices (reference plonk/plonk_common.rs:19-41)
ORACLE_CONSTANTS_SIGMAS = 0
ORACLE_WIRES = 1
ORACLE_ZS_PARTIAL_PRODUCTS = 2
ORACLE_QUOTIENT = 3

# whether each oracle's leaves carry salts when the proof hides (reference
# plonk_common.rs:24-40)
ORACLE_BLINDING = [False, True, True, True]

# field name -> (spec, field module, its algebraic hasher: the inner
# hasher, and the Merkle and transcript hasher unless a circuit names
# another)
FIELDS = {
    "goldilocks": (host.GOLDILOCKS, gl, poseidon_gl),
    "babybear": (host.BABYBEAR, bb, poseidon2_bb),
}


def fixture_path(degree_bits: int, field: str = "goldilocks",
                 retry: bool = False) -> str:
    """The arithmetic-chain fixture of ``field``; with ``retry``, the
    companion file of its permutation-argument retry (the nonrandom
    counter, the redrawn values of the random wire and the JAX retry
    proof)."""
    tag = "" if field == "goldilocks" else "bb_"
    suffix = "_retry" if retry else ""
    return os.path.join(DATA_DIR,
                        f"arith_chain_{tag}2e{degree_bits}{suffix}.npz")


def hasher_of(spec: host.FieldSpec):
    """The algebraic hasher of a field: the inner hasher of every circuit
    over it, and the Merkle and transcript hasher unless it names
    another."""
    for fspec, _, hasher in FIELDS.values():
        if fspec == spec:
            return hasher
    raise ValueError(f"no hasher for the field of p = {spec.p}")


@dataclass
class FriOracleInfo:
    num_polys: int
    blinding: bool


@dataclass
class FriPolynomialInfo:
    oracle_index: int
    polynomial_index: int

    @staticmethod
    def from_range(oracle_index: int, start: int, end: int):
        return [FriPolynomialInfo(oracle_index, i) for i in range(start, end)]


@dataclass
class FriBatchInfo:
    point: Tuple[int, ...]               # extension point
    polynomials: List[FriPolynomialInfo]
    values: Optional[List[Tuple[int, ...]]] = None   # claimed openings


@dataclass
class FriInstanceInfo:
    oracles: List[FriOracleInfo]
    batches: List[FriBatchInfo]


@dataclass
class CommonCircuitData:
    config: CircuitConfig
    fri_params: FriParams
    gates: List                      # sorted unique gates
    selectors_info: SelectorsInfo
    quotient_degree_factor: int
    num_gate_constraints: int
    num_constants: int               # selectors + constants
    num_public_inputs: int
    k_is: List[int]
    num_partial_products: int
    spec: host.FieldSpec = host.GOLDILOCKS
    num_lookup_polys: int = 0
    num_lookup_selectors: int = 0
    luts: List = field(default_factory=list)

    @property
    def degree_bits(self) -> int:
        return self.fri_params.degree_bits

    @property
    def degree(self) -> int:
        return 1 << self.degree_bits

    @property
    def lde_size(self) -> int:
        return self.fri_params.lde_size

    @property
    def quotient_degree(self) -> int:
        return self.quotient_degree_factor * self.degree

    def constants_range(self):
        return (0, self.num_constants)

    def sigmas_range(self):
        return (self.num_constants,
                self.num_constants + self.config.num_routed_wires)

    def zs_range(self):
        return (0, self.config.num_challenges)

    def partial_products_range(self):
        return (self.config.num_challenges,
                (self.num_partial_products + 1) * self.config.num_challenges)

    def num_zs_partial_products_polys(self) -> int:
        return (self.num_partial_products + 1) * self.config.num_challenges

    def num_all_lookup_polys(self) -> int:
        return self.config.num_challenges * self.num_lookup_polys

    def num_preprocessed_polys(self) -> int:
        return self.sigmas_range()[1]

    def num_quotient_polys(self) -> int:
        return self.config.num_challenges * self.quotient_degree_factor

    def fri_oracles(self) -> List[FriOracleInfo]:
        sizes = [self.num_preprocessed_polys(), self.config.num_wires,
                 self.num_zs_partial_products_polys()
                 + self.num_all_lookup_polys(), self.num_quotient_polys()]
        return [FriOracleInfo(n, b) for n, b in zip(sizes, ORACLE_BLINDING)]

    def fri_leaf_lens(self) -> List[int]:
        """Each oracle's leaf width in a FRI query round: a blinded
        oracle's leaves end in 4 salt elements when the proof hides
        (reference fri/oracle.rs:25)."""
        salt = 4 if self.fri_params.hiding else 0
        return [o.num_polys + (salt if o.blinding else 0)
                for o in self.fri_oracles()]

    def get_fri_instance(self, zeta: Tuple[int, ...]) -> FriInstanceInfo:
        """Two opening batches: everything at zeta, then the Zs and the
        lookup polys at g * zeta (reference circuit_data.rs:658-706); the
        lookup polys follow the Z/partial-product polys in their oracle
        and close each batch."""
        lk0 = self.num_zs_partial_products_polys()
        lookup_polys = FriPolynomialInfo.from_range(
            ORACLE_ZS_PARTIAL_PRODUCTS, lk0,
            lk0 + self.num_all_lookup_polys())
        all_polys = (
            FriPolynomialInfo.from_range(ORACLE_CONSTANTS_SIGMAS, 0,
                                         self.num_preprocessed_polys())
            + FriPolynomialInfo.from_range(ORACLE_WIRES, 0,
                                           self.config.num_wires)
            + FriPolynomialInfo.from_range(
                ORACLE_ZS_PARTIAL_PRODUCTS, 0,
                self.num_zs_partial_products_polys())
            + FriPolynomialInfo.from_range(ORACLE_QUOTIENT, 0,
                                           self.num_quotient_polys())
            + lookup_polys)
        g = host.ext_from_base(self.spec,
                               self.spec.two_adic_generator(self.degree_bits))
        zeta_next = host.ext_mul(self.spec, g, zeta)
        next_polys = FriPolynomialInfo.from_range(
            ORACLE_ZS_PARTIAL_PRODUCTS, 0, self.config.num_challenges) + \
            list(lookup_polys)
        return FriInstanceInfo(oracles=self.fri_oracles(), batches=[
            FriBatchInfo(point=tuple(zeta), polynomials=all_polys),
            FriBatchInfo(point=tuple(zeta_next), polynomials=next_polys)])


@dataclass
class Circuit:
    """A circuit with its witness, on one device, with the field module
    ``F``, its extension ``E``, the ``hasher`` of its commitments and
    transcript and the ``inner_hasher`` of its public inputs; ``cache``
    holds the prover's circuit-static tensors (shared by the circuits one
    ``CircuitData`` makes)."""
    common: CommonCircuitData
    constants_sigmas_values: torch.Tensor     # (num_preprocessed, degree)
    constants_sigmas_commitment: PolynomialBatch
    wires: torch.Tensor               # (num_wires, degree) field tensor
    public_inputs: List[int]
    circuit_digest: Digest
    random_wire: Optional[Tuple[int, int]]   # (row, column)
    device: torch.device
    F: object = gl
    hasher: object = poseidon_gl
    inner_hasher: object = poseidon_gl
    cache: Dict = field(default_factory=dict, repr=False, compare=False)
    # each table's (last looking, last table, first table) rows
    lookup_rows: List[Tuple[int, int, int]] = field(default_factory=list)

    @property
    def E(self) -> ext.ExtOps:
        return ext.ext_ops(self.F)

    @property
    def sigmas(self) -> torch.Tensor:
        s0, s1 = self.common.sigmas_range()
        return self.constants_sigmas_values[s0:s1]

    def constants_sigmas_cap(self) -> List[Digest]:
        return self.constants_sigmas_commitment.cap_host()

    def verifier_data(self) -> "VerifierOnlyCircuitData":
        return VerifierOnlyCircuitData(
            constants_sigmas_cap=self.constants_sigmas_cap(),
            circuit_digest=_digest_copy(self.circuit_digest))


def _common_from_meta(meta: Dict, spec: host.FieldSpec
                      ) -> CommonCircuitData:
    cfg = meta["config"]
    fc = meta["fri_config"]
    config = CircuitConfig(
        num_wires=cfg["num_wires"],
        num_routed_wires=cfg["num_routed_wires"],
        num_constants=cfg["num_constants"],
        use_base_arithmetic_gate=cfg["use_base_arithmetic_gate"],
        security_bits=cfg["security_bits"],
        num_challenges=cfg["num_challenges"],
        zero_knowledge=cfg["zero_knowledge"],
        max_quotient_degree_factor=cfg["max_quotient_degree_factor"],
        fri_config=FriConfig(
            rate_bits=fc["rate_bits"], cap_height=fc["cap_height"],
            proof_of_work_bits=fc["proof_of_work_bits"],
            num_query_rounds=fc["num_query_rounds"]))
    # the metadata holds the arities, not the strategy: its arity is theirs
    arities = tuple(meta["reduction_arity_bits"])
    if arities:
        config = replace(config, fri_config=replace(
            config.fri_config,
            reduction_strategy=FriReductionStrategy(arity_bits=arities[0])))
    fri_params = FriParams(config=config.fri_config,
                           hiding=config.zero_knowledge,
                           degree_bits=meta["degree_bits"],
                           reduction_arity_bits=arities)
    luts = [tuple(tuple(int(x) for x in e) for e in lut)
            for lut in meta.get("luts", [])]
    return CommonCircuitData(
        config=config, fri_params=fri_params,
        gates=[gate_from_id(g, spec, luts) for g in meta["gates"]],
        selectors_info=SelectorsInfo(
            selector_indices=list(meta["selector_indices"]),
            groups=[tuple(g) for g in meta["selector_groups"]]),
        quotient_degree_factor=meta["quotient_degree_factor"],
        num_gate_constraints=meta["num_gate_constraints"],
        num_constants=meta["num_constants"],
        num_public_inputs=meta["num_public_inputs"],
        k_is=[int(k) for k in meta["k_is"]],
        num_partial_products=meta["num_partial_products"], spec=spec,
        num_lookup_polys=meta.get("num_lookup_polys", 0),
        num_lookup_selectors=meta.get("num_lookup_selectors", 0), luts=luts)


def load_circuit(arrays: Dict[str, np.ndarray], meta: Dict,
                 device="cuda") -> Circuit:
    """Carry a circuit and its witness across as data.

    ``arrays``: ``constants_sigmas`` (num_constants + num_routed_wires, n)
    values, ``wires`` (num_wires, n; a lookup circuit's with the
    multiplicities and padding of ``prover.set_lookup_wires``) and
    ``public_inputs`` (k,), all canonical uint64.  ``meta``: the
    plain-Python metadata written by the fixture writer (a zk circuit's
    config hides; a lookup circuit's brings its tables and lookup rows).
    Commits the constants/sigmas on ``device``; raises on a
    field, hasher or gate id the port does not have."""
    dev = devmod.resolve(device)
    field = meta.get("field", "goldilocks")
    if field not in FIELDS:
        raise ValueError(f"field {field!r} is not ported")
    spec, F, inner_hasher = FIELDS[field]
    hasher = inner_hasher
    if "hasher" in meta:
        # the only other hasher: Keccak, over Goldilocks
        if (meta["hasher"], field) != ("keccak", "goldilocks"):
            raise ValueError(f"no {meta['hasher']!r} hasher for {field}")
        hasher = keccak_hasher
    common = _common_from_meta(meta, spec)
    n = common.degree
    cs = np.asarray(arrays["constants_sigmas"], dtype=np.uint64)
    wires = np.asarray(arrays["wires"], dtype=np.uint64)
    if cs.shape != (common.num_preprocessed_polys(), n):
        raise ValueError(f"constants_sigmas has shape {cs.shape}")
    if wires.shape != (common.config.num_wires, n):
        raise ValueError(f"wires has shape {wires.shape}")
    fc = common.config.fri_config
    cs_values = F.from_ints(cs, dev)
    commitment = PolynomialBatch.from_values(cs_values, fc.rate_bits,
                                             fc.cap_height, F, hasher)
    return Circuit(
        common=common, constants_sigmas_values=cs_values,
        constants_sigmas_commitment=commitment,
        wires=F.from_ints(wires, dev),
        public_inputs=[int(v) for v in arrays["public_inputs"]],
        circuit_digest=bytes(meta["circuit_digest"])
        if getattr(hasher, "DIGEST_IS_BYTES", False)
        else [int(v) for v in meta["circuit_digest"]],
        random_wire=tuple(meta["random_wire"]) if meta.get("random_wire")
        else None,
        device=dev, F=F, hasher=hasher, inner_hasher=inner_hasher,
        lookup_rows=[tuple(r) for r in meta.get("lookup_rows", [])])


def circuit_meta(data, field: str) -> dict:
    """The metadata ``load_circuit`` reads, of a built ``CircuitData`` of
    ``field``: the port's, or the JAX package's (the fixture writers).  A
    Keccak circuit's names its hasher, and its digest is its bytes."""
    common = data.common
    cfg = common.config
    fc = cfg.fri_config
    po = data.prover_only
    meta = {
        "field": field,
        "config": {
            "num_wires": cfg.num_wires,
            "num_routed_wires": cfg.num_routed_wires,
            "num_constants": cfg.num_constants,
            "use_base_arithmetic_gate": cfg.use_base_arithmetic_gate,
            "security_bits": cfg.security_bits,
            "num_challenges": cfg.num_challenges,
            "zero_knowledge": cfg.zero_knowledge,
            "max_quotient_degree_factor": cfg.max_quotient_degree_factor,
        },
        "fri_config": {
            "rate_bits": fc.rate_bits,
            "cap_height": fc.cap_height,
            "proof_of_work_bits": fc.proof_of_work_bits,
            "num_query_rounds": fc.num_query_rounds,
        },
        "reduction_arity_bits": list(common.fri_params.reduction_arity_bits),
        "degree_bits": common.degree_bits,
        "gates": [g.id() for g in common.gates],
        "selector_indices": list(common.selectors_info.selector_indices),
        "selector_groups": [list(g) for g in common.selectors_info.groups],
        "k_is": [int(k) for k in common.k_is],
        "num_partial_products": common.num_partial_products,
        "quotient_degree_factor": common.quotient_degree_factor,
        "num_gate_constraints": common.num_gate_constraints,
        "num_constants": common.num_constants,
        "num_public_inputs": common.num_public_inputs,
        "circuit_digest": [int(v) for v in po.circuit_digest],
        "random_wire": [int(v) for v in po.random_wire],
    }
    if getattr(data.hasher, "DIGEST_IS_BYTES", False):
        meta["hasher"] = "keccak"
    if common.luts:
        meta.update({
            "num_lookup_polys": common.num_lookup_polys,
            "num_lookup_selectors": common.num_lookup_selectors,
            "luts": [[list(map(int, e)) for e in lut] for lut in common.luts],
            "lookup_rows": [list(map(int, r)) for r in po.lookup_rows],
        })
    return meta


def read_fixture(path: str):
    """(arrays, meta) of a fixture file."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "meta"}
        meta = json.loads(str(z["meta"]))
    return arrays, meta


def load_fixture(degree_bits: int, device="cuda", field: str = "goldilocks"):
    """The committed arithmetic-chain fixture of ``field``: (circuit,
    arrays) where arrays also hold the JAX proof (``proof_<phase>``
    keys)."""
    arrays, meta = read_fixture(fixture_path(degree_bits, field))
    return load_circuit(arrays, meta, device), arrays


# -- built circuits ---------------------------------------------------------


@dataclass
class VerifierOnlyCircuitData:
    constants_sigmas_cap: List[Digest]
    circuit_digest: Digest


@dataclass
class ProverOnlyCircuitData:
    generators: List
    generator_indices_by_watches: Dict[int, List[int]]
    constants_sigmas_values: torch.Tensor    # (num_preprocessed, degree)
    constants_sigmas_commitment: PolynomialBatch
    public_inputs: List                      # targets
    representative_map: np.ndarray
    circuit_digest: Digest
    random_wire: Optional[Tuple[int, int]]   # (row, column)
    # each table's (last looking, last table, first table) rows, and its
    # (input, output) target pairs
    lookup_rows: List[Tuple[int, int, int]] = field(default_factory=list)
    lut_to_lookups: List[List] = field(default_factory=list)
    # the recorded witness schedules, by set of preset targets
    # (iop/generator.py:generate_partial_witness)
    witgen_schedules: Dict = field(default_factory=dict, repr=False,
                                   compare=False)


@dataclass
class CircuitData:
    """A circuit built by ``CircuitBuilder.build`` on ``device`` (reference
    circuit_data.rs:191-260)."""
    common: CommonCircuitData
    prover_only: ProverOnlyCircuitData
    verifier_only: VerifierOnlyCircuitData
    device: torch.device
    F: object = gl
    hasher: object = poseidon_gl
    inner_hasher: object = poseidon_gl
    cache: Dict = field(default_factory=dict, repr=False, compare=False)

    def circuit(self, pw, rng: Rng,
                timings: Optional[Dict[str, float]] = None) -> Circuit:
        """The circuit with the witness of the partial witness ``pw``:
        witness generation on the host, drawing from ``rng`` (and a lookup
        circuit's multiplicities), then the wire matrix on the device.
        The first call for a set of preset targets runs the fixpoint and
        records its schedule, every later one replays it
        (``iop/generator.py``); ``timings`` gets the host seconds of
        either as ``record_s`` or ``replay_s``."""
        po = self.prover_only
        replay = schedule_key(pw, self.common) in po.witgen_schedules
        t0 = time.perf_counter()
        witness = generate_partial_witness(pw, po, self.common, rng)
        prover.set_lookup_wires(po, self.common, witness)
        dense = witness.full_witness()
        if timings is not None:
            name = "replay_s" if replay else "record_s"
            timings[name] = timings.get(name, 0.0) + \
                time.perf_counter() - t0
        return Circuit(
            common=self.common,
            constants_sigmas_values=po.constants_sigmas_values,
            constants_sigmas_commitment=po.constants_sigmas_commitment,
            wires=self.F.from_ints(dense, self.device),
            public_inputs=witness.get_targets(po.public_inputs),
            circuit_digest=po.circuit_digest, random_wire=po.random_wire,
            device=self.device, F=self.F, hasher=self.hasher,
            inner_hasher=self.inner_hasher, cache=self.cache,
            lookup_rows=po.lookup_rows)

    def witgen_schedule(self, pw):
        """The recorded schedule ``pw``'s witness replays, or None."""
        return self.prover_only.witgen_schedules.get(
            schedule_key(pw, self.common))

    def prove(self, pw, rng: Optional[Rng] = None,
              timings: Optional[Dict[str, float]] = None):
        """Witness generation, then the prover (reference
        plonk/prover.rs:136-230).  Both draw from ``rng`` (a
        ``NonRandomRng`` for the reference's deterministic draws, else a
        numpy generator, fresh from the OS when none is given), so the
        permutation-argument retry goes on from where witness generation
        left it.  Without ``timings`` a Poseidon-GL or Poseidon2-BB
        circuit takes the device-transcript prover
        (``plonk/prover_async.py``: one blocking fetch a proof); with
        ``timings`` (a dict), or over Keccak, the sync prover, and
        ``timings`` gets ``witness_generation`` (and its host part,
        ``record_s`` or ``replay_s``) beside the prover's phases.  Both
        provers give the same proof."""
        if rng is None:
            rng = np.random.default_rng()
        with prover.phase(timings, "witness_generation", self.device):
            circuit = self.circuit(pw, rng, timings)
        return prover.prove(circuit, self.device, timings, rng)

    def verify(self, proof_with_pis) -> None:
        """Raise ``VerificationError`` unless the proof is valid for this
        circuit (``plonk/verifier.py``, on the host; reference
        circuit_data.rs:208)."""
        from . import verifier
        verifier.verify(proof_with_pis, self.verifier_only, self.common,
                        self.hasher, self.inner_hasher)
