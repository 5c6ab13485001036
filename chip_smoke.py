"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of plonky2_goldibear_torch/csrc with nvcc (one
   nvcc per source, all at once);
3. holds each kernel against its plain torch version on the card, bit for
   bit, at the shapes of a 2^12-row proof of each field (Goldilocks: NTT,
   Poseidon permutation, leaf sponge, Merkle levels; BabyBear: NTT,
   Poseidon2 permutation, leaf sponge, Merkle levels), with CUDA-event
   times; then every one of these kernels again at each shape that one
   2^12 prove of its field launches it on (recorded from a prove through
   ``ops.calls``), Goldilocks Merkle trees of 2^11 and 2^7 digests to
   a cap of 16 and trees of 2^15 to the root of both fields, the
   BabyBear NTT at the single rows the prover sent before it batched them
   (1 x 2^15, 1 x 2^12), and the BabyBear leaf sponge at each prove shape
   at every group size (threads per state), with each tree's Merkle plan,
   each NTT call's launch plan and each sponge's group printed; the shapes
   of one 2^12 build (``CircuitBuilder.build``, the constants/sigmas
   commit) of each field are recorded and checked the same way; every NTT
   call of a 2^12 prove or build must be one launch;
4. for each field (Goldilocks under standard_recursion_config_gl, then
   BabyBear under standard_recursion_config_bb):
   - builds the 2^6 arithmetic chain (``circuits.arith_chain``) with the
     port's builder on the card and holds its constants/sigmas, cap,
     digest and metadata against the committed JAX fixture; generates the
     witness of x = 3 from ``NonRandomRng(1)`` and holds the wires, the
     public inputs and the counter it leaves (that of the retry fixture)
     against the fixture's; proves it, and proves it again with its first
     attempts made to fail (``InvZeroPermArg``) through
     ``CircuitData.prove`` from ``NonRandomRng(1)``, so that the random
     wire is redrawn where witness generation left the counter: each
     redrawn value and the proof must equal the JAX retry's
     (``arith_chain*_2e6_retry.npz``);
   - loads the 2^6 fixture as data through ``load_fixture`` and proves it,
     and its retry from the recorded counter, the same way;
   - the main path at 2^12: adds the chain with the gadgets
     (``gadgets_s``), builds it on the card (``build_s`` and its phases;
     the kernels' launches counted over the build, the counts set to 0
     just before it) and generates the witness (``witgen_s``),
     ``BUILD_REPS`` times, holds the last against the fixture, then
     proves it 3 times
     warm with ``prove``, every kernel's launches counted over one prove
     (the counts set to 0 just before it), and times one whole
     ``CircuitData.prove(pw)`` (witness generation and prove) beside it.
   Each proof must equal the fixture's stored JAX proof field by field.
   One more warm 2^12 prove of each field runs under torch.profiler (CUDA
   activities): per kernel name its launches and summed device ms, and
   the device-busy share: the summed kernel and copy time over the median
   wall time of the 3 unprofiled proves (the profiled prove's own wall
   time, which the profiler lengthens, is printed beside it).

5. the verifier (``plonk/verifier.py``, on the host; it launches no
   kernel): every proof phase 4 made on the card (2^6 built and loaded,
   each with its retry, and 2^12 timed and whole, both fields) and the
   reference's own 2^14 recursive-verifier proof read from
   ``tests/data/gl_regression_{common,verifier,proof}.bin`` must verify,
   and a copy of each with one wire opening changed must be rejected.
   ``verify_s`` (host seconds, median of 3) of the 2^14 proof and of each
   field's 2^12 proof is printed on its own line.

6. the recursive verifier (``circuits.recursive_verifier``, the reference's
   headline recursion): over the Goldilocks 2^12 chain and its proof from
   phase 4, builds the outer circuit on the card ``BUILD_REPS`` times
   (``gadgets_s``,
   ``build_s`` and its phases, the build's kernel launches) and holds its
   common data, constants/sigmas cap and digest against the JAX build
   (``data/recursive_gl_2e12inner_{common,verifier}.bin``, read by the
   port's reader); sets the inner proof and verifier data as its witness
   and generates it (``witgen_s``, each time); proves it warm 3 times
   (recursive prove latency, phase seconds, every kernel's launches over
   one prove, which each GL kernel must have); profiles one more prove;
   verifies the proof with ``CircuitData.verify`` and rejects a copy with
   one wire opening changed; then holds each kernel against its plain
   version at every shape the outer's build and prove launch it on.  It
   runs before phase 5, which verifies (and times) its proof too.

7. zero knowledge and lookups, before phase 5 too:
   - the CPU tests' circuits built and proved on the card from
     ``NonRandomRng(1)``, each against its JAX fixture (metadata, cap,
     every proof phase, the counter after the proof): the zk Fibonacci
     circuit at one FRI query round (``data/zk_fib_1q.npz``, 2^8), the
     Tip5-16 and two-table lookup circuits (``data/lookup_tip5.npz``,
     ``lookup_two_tables.npz``); each verifies, a tampered output does not;
   - A, the reference's regression recursion, zk, 2^14: the inner
     (``circuits.regression_inner``) built (its cap and digest against the
     JAX build) and proved; the recursive verifier over it built (its
     common data against the port's reading of
     ``tests/data/gl_regression_common.bin`` field by field, its cap and
     digest against the JAX build), witnessed and proved warm
     ``ZK_PROVE_REPS`` times (phases, every kernel's launches over one
     prove, a profiled prove); two proofs (the warm-up's and a timed
     one's, each from a fresh rng) differ in their wires cap and both
     verify, a tampered copy does not;
   - B, one u16 table of all 2^16 inputs and 4500 lookups
     (``circuits.u16_table``, 2^12 rows): built (common data, cap and digest
     against the JAX build), the lookup polys on the card against the
     scalar host reference and profiled alone (launches, device ms),
     proved 3 times (``lookup_polys`` its own phase), verified, a
     tampered output rejected;
   - C, the recursive verifier over the Tip5-16 proof: built and witnessed
     (common data, cap, digest and a SHA-256 of every wire column against
     the JAX build and witness), proved and verified;
   - then every kernel at each new shape A's and B's builds and proves
     launched (the 2^17-row LDEs, the salted 139 / 24 / 20-wide sponges,
     the 2^17-leaf trees), against its plain version with its bounds.

8. BabyBear recursion, before phase 5 too:
   - the recursive verifier over the BabyBear 2^12 chain and its proof
     from phase 4 (the reference's recursive_verifier.rs:317, 2^13 rows,
     bb4, FRI arity 2^3), built once on the card (``gadgets_s``,
     ``build_s`` and its phases, the build's launches), its common data,
     cap and digest against the JAX build
     (``data/recursive_bb_2e12inner_{common,verifier}.bin``), witnessed
     (``witgen_s``), proved warm 3 times (phases, every BB kernel's
     launches over one prove), one more prove profiled, verified and a
     tampered copy rejected;
   - the width-24 hash circuit (``circuits.r0_hash`` under
     ``recursion_config_bb_wide()``) and the Tip5-16 lookups under
     ``standard_recursion_config_bb()``, built and proved from
     ``NonRandomRng(1)``, each against its JAX fixture
     (``data/r0_hash.npz``, ``lookup_tip5_bb.npz``: metadata, cap, every
     proof phase, the counter), verified, a tampered copy rejected;
   - then every kernel at each new shape of these builds and proves (the
     BB NTT at 2^16 rows by its passes among them), against its plain
     version with its bounds.

9. the Keccak config (``hash/keccak_hasher.py``, the reference's
   KeccakGoldilocksConfig), before phase 5 too.  Phase 3 has held the
   Keccak kernels (``csrc/keccak.cu``: rows, Merkle levels and their
   subtree tail, hash-onion) against their plain versions at row lengths
   around the rate's edges (``KECCAK_LENGTHS``), the hash-onion at the
   grind's 2^17 states, and every launch geometry the plans of
   ``ops/keccak.py`` choose between (each group size on rows and on a
   level, each subtree depth for caps 1 and 16, whole trees to caps 1 and
   16); then:
   - the small circuit of the JAX package's Keccak test
     (``circuits.keccak_pow31``, 8 PoW bits) built with
     ``hasher=keccak_hasher`` and proved from ``NonRandomRng(1)``,
     against ``data/keccak_pow31.npz`` and the JAX bytes (metadata,
     common data, constants/sigmas, cap and digest bytes, every proof
     phase, the PoW witness ground by the hash-onion kernel); the port
     verifies its proof and the JAX proof and rejects a tampered copy;
   - the Keccak outer, the top of the reference's multi-hash tower
     (recursive_verifier.rs:623-664): ``circuits.recursive_verifier`` with
     Keccak over phase 6's outer and its proof, built once (common data,
     cap and digest bytes against ``data/recursive_keccak_gl_2e12_
     {common,verifier}.bin``), witnessed, proved warm 3 times (every
     Keccak kernel's launches over one prove), one more prove profiled,
     verified, tampered copies rejected;
   - then every kernel at each new shape of these builds and proves.

10. AddManyGate, conditional and cyclic (IVC) recursion, before phase 5
   too, all under ``standard_recursion_config_gl()``:
   - ``circuits.add_many_sums`` (sums of 23, 46 and 100 addends: three
     AddManyGate rows) built and proved from ``NonRandomRng(1)``, against
     ``data/add_many_sums.npz`` and the JAX bytes (metadata, common data,
     constants/sigmas, cap and digest, every proof phase); one more prove
     profiled and its device events read both by the raw reader that
     every profile here uses and by ``prof.events()``, which must agree;
   - the conditional verifier (``circuits.conditional_outer``) over
     ``circuits.fib_inner`` and its proof (against the JAX proof, and
     the dummy circuit over its common data and the dummy proof against
     the JAX build and proof): the dummy circuit built and
     proved on the card while the gadgets are laid out (``dummy_s``, part
     of ``gadgets_s``), the outer built, then witnessed and proved for
     condition 1 (the proof) and condition 0 (the dummy);
   - the repeated-hash IVC counter (``circuits.cyclic_counter``) over the
     reference's fixed point (``common_data_for_recursion``, 2^13 rows):
     its common data, cap and digest against the JAX build
     (``data/cyclic_counter_{common,verifier}.bin``), the base proof
     (``cyclic_base_proof``), then the base case and two steps proved, each
     proof's verifier data checked and the proof verified; the counters
     read 0, 1, 2 and the current hash is H^3 of the initial one;
   - the GL double recursion: a Poseidon outer over phase 6's outer and its
     proof, proved and verified.
   For each circuit ``gadgets_s``, ``build_s``, ``witgen_s``, its first
   (cold) prove with every kernel's launches counted, and ``verify_s``;
   then ``REPS_10`` warm proves timed (``prove_s``), the launches of the
   last, and the launches, device ms and busy share of one more, profiled
   (for the conditional outer with condition 1, and for the IVC's first
   step); a tampered copy of each proof is rejected; then every kernel at
   each new shape.

11. the device-transcript prover (``plonk/prover_async.py``, which a prove
   without ``timings`` takes over Poseidon-GL and Poseidon2-BB; the timed
   proves above take the sync prover), after phase 10 and before phase 5:
   - on each cell of ``TRANSCRIPT_CELLS`` (the GL and BB 2^12 chains, the
     GL and BB recursive outers, A and B), from rngs of one seed: the
     device-transcript proof equals the sync one (and, for the chains,
     the JAX proof); the host's blocking waits on the card in one prove
     of each path (``torch.cuda.set_sync_debug_mode("warn")``: 1 for the
     device path, 2 with lookups, or the phase fails); ``TRANSCRIPT_REPS``
     warm proves of each path, in turns (prove_s, each hand kernel's
     launches); one more prove of each path profiled (its launches,
     device ms and busy share); each device proof goes to phase 5;
   - ``transcript_flush`` against its plain version at every transcript
     step of the GL and BB chains' device proves, at their real inputs,
     with its data-sheet bound (the step's permutations' products at the
     card's rate) and the latency of its chain of dependent permutations:
     at the kernel's group (the slope of the Merkle tails' CUDA-graph times
     over their layers, ``_group_latency_ms``) and its floor from one-warp
     probe chains (``_latency_floor_ms``);
   - ``pow_grind`` against its plain version at the chains' real grind
     inputs, at their PoW bits and at 8, 16 and 20, with the candidates the
     answer needs (up to the witness, to the end of its chunk), those it
     tried, and its bounds: the needed candidates' permutations at the
     data sheet's rate and at phase 3's permute probe bound a state.

The witness replay, in phases 4 and 6-10: every circuit the script
witnesses is witnessed twice through ``CircuitData.circuit``
(``_witness_twice``): first by the fixpoint, which records the circuit's
schedule for its set of preset targets (unless a call before recorded it:
the conditional outer's second condition, the IVC's later steps), then by
replay from a fresh rng of the same seed.  The dense wire matrix, the
public inputs and the rng state after each must be equal, and each circuit
prints ``record_s``, ``replay_s`` (host seconds, the Python-set inputs and
the lookup multiplicities included), and the schedule's ``n_native``,
``n_python`` and instruction count.  The proves after it, and the small
circuits' proofs against the JAX proofs (the 2^6 chains and their retries,
phase 7's and 8's circuits, the Keccak x^31 circuit, fib_inner), come from
a replayed witness.

Each phase prints the script's seconds when it starts.

Between 3 and 4, the probe phase: each dependent-chain probe kernel
(``ops/probes.py``: GL multiply, squaring, two x^7 S-boxes, u32 multiply,
multiply-and-mask, add, f32 FMA) is held against its plain version at a
ragged size and at the probe runner's two sizes (the script's element
count and a card-filling one) at the script's reps, the card-filling call
timed; where one PyTorch call computes the same chain (u32 add and
multiply), it is held and timed too.  Then the probe runner
(``plonky2_goldibear_torch.probes``, every chain section, launches
counted) measures each operation's rate at both sizes.  The card-filling
rates give every kernel of phase 3 a second bound, the "probe bound": 118
S-boxes per Poseidon-GL permutation at the measured S-box rate, one GL
multiply per NTT butterfly at the measured multiply rate, and 4 u32
multiplies per BabyBear product at the measured u32 multiply rate (each
the larger of it and the byte bound).  At the end it ranks the path
kernels by their excess in one 2^12 prove: the sum, over the prove's own
calls of the kernel, of (ms - probe bound) at each call's shape, with the
same excess over the data-sheet bound beside it.

It prints a JSON line of per-kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
when there is no CUDA device, when the package is missing, or when any
phase fails.  A detailed report goes to chip_smoke_out/chip_smoke_report.json.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
# NVIDIA's CUDA C++ documentation, arithmetic instruction throughput table,
# compute capability 9.0, results per clock per SM: 32-bit integer multiply,
# multiply-add, add, bitwise ops and funnel shifts 64; 32-bit float fma 128
INT32_OPS_PER_SM_CLK = 64
FP32_FMA_PER_SM_CLK = 128
MULS_PER_FIELD_MUL = 4        # GL 64x64 -> 128 from four 32x32 products;
                              # BB Montgomery: 32x32 -> 64 (two), m, m p
FMA_RTOL = 1e-5               # fmaf rounds once, the plain version twice
# 32-bit operations of one Keccak-f[1600] on the lanes' halves, per round,
# with three-input logic ops: theta 20 for the column sums (two a half),
# 10 funnel shifts for the rotated sums, 50 to fold both into the lanes;
# rho 48 funnel shifts (24 lanes); chi 50; iota 2 (csrc/keccak.cu)
KECCAK_F_OPS = 24 * (20 + 10 + 50 + 48 + 50 + 2)
KECCAK_RATE = 136             # bytes a Keccak-256 block absorbs
KECCAK_DIGEST = 25            # bytes of a Keccak-config digest
OUT_DIR = "chip_smoke_out"    # the report, listed in .gitignore
PROFILE_TOP = 25              # kernels printed per profiled prove
MAIN_BITS = 12                # the benchmark circuit: 2^12 rows
PRESETS = {"goldilocks": "standard_recursion_config_gl",
           "babybear": "standard_recursion_config_bb"}
RUST_PROOF = "tests/data/gl_regression_{}.bin"   # the reference's 2^14 proof
SMALL_BITS = 6                # a second fixture: small trees, mostly tail
# the JAX build of the recursive verifier over the GL 2^12 chain
OUTER_BIN = "plonky2_goldibear_torch/data/recursive_gl_2e12inner_{}.bin"
# phase 9: the lengths each Keccak row launch is held at besides the
# prove's (around the rate's edges: a padding block of its own at 136 and
# 272), and the hash-onion's states (the grind's batch)
KECCAK_LENGTHS = (25, 50, 96, 135, 136, 137, 272, 1080)
KECCAK_PERMUTE_STATES = 1 << 17
# phase 7: the JAX builds and fixtures of the zk and lookup circuits
DATA = "plonky2_goldibear_torch/data/{}"
# timed proves of the 2^14 zk outer: one, since the run with three took
# over twice the command time of the script without phase 7
ZK_PROVE_REPS = 1
# builds (and witnesses) of the 2^12 chains and of the recursive outer:
# one, since phase 9 took the script past 560 s with three
BUILD_REPS = 1
# phase 10: warm proves timed per circuit, after its first (cold) prove
REPS_10 = 3

# Merkle trees checked besides the prove's: FRI layers to a cap of 16 and
# a tree to its root (one subtree for the tail)
EXTRA_TREES = ((1 << 11, 7), (1 << 7, 3), (1 << 15, 15))
EXTRA_BB_CALLS = (("p2_merkle_levels", 1 << 15, 15),
                  ("ntt_bb", 1, 1 << 15, 0), ("ntt_bb", 1, 1 << 12, 0))
GL_PERM_MULS = 8 * 12 * 4 + 22 * 4            # field muls per permutation
GL_PERM_SBOXES = 8 * 12 + 22                  # S-boxes per permutation
# BB: the full rounds' S-boxes, then per partial round lane 0's S-box, the
# scaled sum and difference, and each other lane times its scaled diagonal
BB_PERM_MULS = 8 * 16 * 4 + 13 * (4 + 2 + 15)
# the dependent 32-bit multiplies of a BabyBear x^7 (csrc/poseidon2_bb.cuh
# sbox): x^2, then x^3, then x^7, each a product, m = lo PINV and (m p) hi
BB_SBOX_DEPTH_MULS = 3 * 3
LATENCY_THREADS = 32          # one warp: a chain's latency, not its rate
# probe step -> (the operations of one rep its bound counts, their per-SM-
# clock rate, one PyTorch call computing the same chain from x0 and reps, or
# None).  A GL multiply counts its four 32-bit products, as the data-sheet
# bound does; mul16's IMAD and LOP3 run on two pipes at once, so it counts
# the IMAD; a three-input IADD3 adds twice.  The u32 add chain is
# (reps + 1) x0 and the multiply chain x0^(reps + 1), mod 2^32; no single
# call computes the others (a GL power mod p, mul16's x0 s^reps mod 2^16,
# the FMA's geometric sum).  Each step's section and the TPU kernel it
# replaces come from the probe runner's SECTIONS.
PROBES = {
    "gl_mul": (MULS_PER_FIELD_MUL, INT32_OPS_PER_SM_CLK, None),
    "gl_sqr": (MULS_PER_FIELD_MUL, INT32_OPS_PER_SM_CLK, None),
    "gl_sbox": (4 * MULS_PER_FIELD_MUL, INT32_OPS_PER_SM_CLK, None),
    "gl_sbox_serial": (4 * MULS_PER_FIELD_MUL, INT32_OPS_PER_SM_CLK, None),
    "u32_mul": (1, INT32_OPS_PER_SM_CLK, lambda x, reps: x.pow(reps + 1)),
    "u32_mul16": (1, INT32_OPS_PER_SM_CLK, None),
    "u32_add": (0.5, INT32_OPS_PER_SM_CLK, lambda x, reps: x * (reps + 1)),
    "f32_fma": (1, FP32_FMA_PER_SM_CLK, None),
}

# kernel -> (source, the TPU kernel it replaces, its launch counter)
SOURCES = {
    "ntt_gl": ("plonky2_goldibear_torch/csrc/ntt_gl.cu",
               "plonky2_goldibear_tpu/ops/ntt.py:150", "ntt"),
    "poseidon_gl_permute": (
        "plonky2_goldibear_torch/csrc/poseidon_gl.cu",
        "plonky2_goldibear_tpu/ops/poseidon_gl.py:301", "permute"),
    "poseidon_gl_leaf_sponge": (
        "plonky2_goldibear_torch/csrc/poseidon_gl.cu",
        "plonky2_goldibear_tpu/ops/poseidon_gl.py:354", "leaf_sponge"),
    "poseidon_gl_merkle_levels": (
        "plonky2_goldibear_torch/csrc/poseidon_gl.cu",
        "plonky2_goldibear_tpu/ops/poseidon_gl.py:452", "merkle_levels"),
    "ntt_bb": ("plonky2_goldibear_torch/csrc/ntt_bb.cu",
               "plonky2_goldibear_tpu/ops/ntt_bb.py:146", "ntt_bb"),
    "poseidon2_bb_permute": (
        "plonky2_goldibear_torch/csrc/poseidon2_bb.cu",
        "plonky2_goldibear_tpu/ops/poseidon2_bb.py:161", "p2_permute"),
    "poseidon2_bb_leaf_sponge": (
        "plonky2_goldibear_torch/csrc/poseidon2_bb.cu",
        "plonky2_goldibear_tpu/ops/poseidon2_bb.py:161",
        "p2_leaf_sponge"),
    "poseidon2_bb_merkle_levels": (
        "plonky2_goldibear_torch/csrc/poseidon2_bb.cu",
        "plonky2_goldibear_tpu/ops/poseidon2_bb.py:161",
        "p2_merkle_levels"),
    # no Pallas kernel: the JAX package's Keccak is a jnp program
    "keccak_rows": ("plonky2_goldibear_torch/csrc/keccak.cu",
                    "plonky2_goldibear_tpu/hash/keccak_device.py:85",
                    "keccak_rows"),
    "keccak_merkle_levels": (
        "plonky2_goldibear_torch/csrc/keccak.cu",
        "plonky2_goldibear_tpu/hash/keccak_device.py:85",
        "keccak_merkle_levels"),
    # the narrow top levels of the same Merkle trees, one launch
    "keccak_merkle_subtree": (
        "plonky2_goldibear_torch/csrc/keccak.cu",
        "plonky2_goldibear_tpu/hash/keccak_device.py:85",
        "keccak_merkle_subtree"),
    "keccak_permute": ("plonky2_goldibear_torch/csrc/keccak.cu",
                       "plonky2_goldibear_tpu/hash/keccak_device.py:85",
                       "keccak_permute"),
}
KECCAK_COUNTERS = ("keccak_rows", "keccak_merkle_levels",
                   "keccak_merkle_subtree", "keccak_permute")
# phase 11: the device-transcript prover's cells, label -> (a circuit with
# its witness on the card, a maker of equal fresh rngs, the JAX proof's
# arrays or None), filled by phases 4, 6, 7 and 8; its kernels' launch
# counters (held against their plain versions in phase 11 alone); the warm
# proves timed of each path; the PoW bits the grind is also held at
TRANSCRIPT_CELLS = {}
TRANSCRIPT_COUNTERS = ("transcript_flush", "pow_grind")
TRANSCRIPT_REPS = 3
GRIND_POW_BITS = (8, 16, 20)


# a launch counter -> its kernel
KERNEL_OF = {counter: name for name, (_, _, counter) in SOURCES.items()}


def _shape_key(call) -> str:
    """The report key of the check at a recorded call's shape."""
    return "prove_" + "_".join(map(str, call))


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def _timed(fn, reps: int, warm_up: bool = True):
    """(the last output of fn, ms per call of fn over reps calls, after a
    warm-up one unless the caller has made it)."""
    import torch

    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    return _timed(fn, reps, warm_up)[1]


def _compare(a, b):
    """(mismatches, max |a - b|) of two field tensors as canonical u64
    values (a BabyBear tensor is int32, a Goldilocks one int64), or of two
    byte tensors (uint8: Keccak digests) as bytes."""
    import numpy as np
    import torch

    from plonky2_goldibear_torch.field import bb, gl

    if a.dtype == torch.uint8:
        x = a.cpu().numpy().astype(np.uint64)
        y = b.cpu().numpy().astype(np.uint64)
    else:
        F = bb if a.dtype == torch.int32 else gl
        x, y = F.to_ints(a), F.to_ints(b)
    if x.shape != y.shape:
        return -1, float("inf")
    bad = x != y
    if not bad.any():
        return 0, 0.0
    diff = np.where(x > y, x - y, y - x)
    return int(bad.sum()), float(diff.max())


def _compare_probe(a, b):
    """(mismatches, max |a - b|) of two probe chains: GL as field values,
    u32 as unsigned integers, f32 outside a relative FMA_RTOL.  An f32
    chain overflows to inf at large reps: inf is read as the largest float,
    so inf against inf is a match, and inf against a finite value one
    rounding below it is within the tolerance."""
    import numpy as np
    import torch

    if a.dtype == torch.int64:
        return _compare(a, b)
    if a.dtype == torch.int32:
        x = a.cpu().numpy().view(np.uint32).astype(np.int64)
        y = b.cpu().numpy().view(np.uint32).astype(np.int64)
        return int((x != y).sum()), float(np.abs(x - y).max())
    a, b = torch.nan_to_num(a).double(), torch.nan_to_num(b).double()
    bad = ~torch.isclose(a, b, rtol=FMA_RTOL, atol=0)
    return int(bad.sum()), float((a - b).abs().max())


def _device_events(prof) -> dict:
    """Per kernel name of a finished profile, (launches, summed device
    ms), from the profiler's raw events: ``prof.events()`` builds a python
    event tree of the same events, about 100 us an event (some 40 s for
    the ~450k events of a 2^12 outer's prove).  ``_profile_readers``
    holds the two readings equal on the card."""
    import torch

    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n, ms = per.get(e.name(), (0, 0.0))
            per[e.name()] = (n + 1, ms + e.duration_ns() / 1e6)
    return per


def _profile_readers(fn) -> dict:
    """One call of fn profiled and its device events read twice: by
    ``_device_events`` and by ``prof.events()``.  Whether the launches
    and the device ms agree in total (ms within 1e-3) and kernel by
    kernel (the sorted per-kernel launch counts; the names too, which
    ``prof.events()`` may rewrite, are reported beside)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    raw = _device_events(prof)
    tree = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, ms = tree.get(e.name, (0, 0.0))
            tree[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    totals = [tuple(map(sum, zip(*d.values()))) for d in (raw, tree)]
    print("profile readers (launches, device ms): raw "
          f"{totals[0]}, prof.events() {totals[1]}, same names "
          f"{set(raw) == set(tree)}")
    return {"launches": totals[0][0] == totals[1][0] > 0,
            "ms": abs(totals[0][1] - totals[1][1]) <= 1e-3,
            "per_kernel_launches": sorted(n for n, _ in raw.values())
            == sorted(n for n, _ in tree.values())}


def _profile(fn, wall_ms_unprofiled: float):
    """One call of fn under torch.profiler (CUDA activities): per kernel
    name its launches and summed device ms, and the device-busy share, the
    summed kernel and copy time over ``wall_ms_unprofiled`` (the call's
    wall time without the profiler, which lengthens it); the share over
    the profiled wall time beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per = _device_events(prof)
    busy = sum(ms for _, ms in per.values())
    return {"wall_ms": wall_ms_unprofiled, "profiled_wall_ms": wall_ms,
            "device_ms": busy,
            "device_busy_share": busy / wall_ms_unprofiled,
            "device_busy_share_of_profiled_wall": busy / wall_ms,
            "kernels": [{"name": k, "launches": n, "ms": ms}
                        for k, (n, ms) in sorted(per.items(),
                                                 key=lambda kv: -kv[1][1])]}


def _read_bin(name: str) -> bytes:
    with open(os.path.join(ROOT, DATA.format(name)), "rb") as f:
        return f.read()


def _common_equal(common, want) -> dict:
    """Field by field, whether built common data equals ``want``."""
    return {
        "config": common.config == want.config,
        "fri_params": common.fri_params == want.fri_params,
        "gates": [g.id() for g in common.gates]
        == [g.id() for g in want.gates],
        "selectors": common.selectors_info.selector_indices
        == want.selectors_info.selector_indices
        and [tuple(g) for g in common.selectors_info.groups]
        == [tuple(g) for g in want.selectors_info.groups],
        "counts": all(getattr(common, k) == getattr(want, k) for k in (
            "quotient_degree_factor", "num_gate_constraints",
            "num_constants", "num_public_inputs", "k_is",
            "num_partial_products", "num_lookup_polys",
            "num_lookup_selectors", "luts")),
    }


def _expect(rec, failures, label, ok) -> None:
    """Print ``ok`` (check -> bool), keep it in ``rec["equal"]``, and fail
    each check that does not hold."""
    print(f"{label}: " + json.dumps(ok))
    rec.setdefault("equal", {})[label] = ok
    failures.extend(f"{label}: {k} differs" for k, v in ok.items() if not v)


def _rejects(failures, data, proof, label, tamper) -> None:
    """A copy of ``proof`` changed by ``tamper`` must fail
    ``data.verify``."""
    import copy

    from plonky2_goldibear_torch.plonk.verifier import VerificationError

    bad = copy.deepcopy(proof)
    tamper(bad)
    try:
        data.verify(bad)
        failures.append(f"{label}: a tampered copy was accepted")
    except VerificationError:
        print(f"{label}: verified; tampered copy rejected")


def _bump_wire(index: int, p: int):
    """A tamper: one component of one wire opening moved by one."""
    def bump(proof):
        w = proof.proof.openings.wires
        w[index] = ((w[index][0] + 1) % p,) + tuple(w[index][1:])
    return bump


def _timed_proves(prove, reps, label, failures, counters):
    """``reps`` warm proves by ``prove(timings)`` (the caller has made one),
    each timed, every kernel's launches counted over the last; the profile
    of one more.  Returns (proofs, times, median phases, launches,
    profile)."""
    import torch

    from plonky2_goldibear_torch import ops

    proofs, times, phases = [], [], []
    for _ in range(reps):
        ops.reset_launches()
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proofs.append(prove(timings))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        phases.append(timings)
        launches = ops.launch_counts()
    median_phases = {k: statistics.median(p[k] for p in phases)
                     for k in phases[0]}
    print(f"{label} prove on cuda: median {statistics.median(times):.4f} s "
          f"of {[round(t, 4) for t in times]}")
    print(f"{label} phases (s, median of {reps}): " + json.dumps(
        {k: round(v, 4) for k, v in median_phases.items()}))
    print(f"{label} launches in one prove: " + json.dumps(
        {k: v for k, v in launches.items() if v}))
    failures.extend(f"kernel {k} was not launched by the {label} prove"
                    for k in counters if launches.get(k, 0) <= 0)
    prof = _profile(lambda: prove({}), statistics.median(times) * 1e3)
    print(f"{label} profile of one prove: device {prof['device_ms']:.2f} "
          f"ms in {sum(k['launches'] for k in prof['kernels'])} launches; "
          f"busy share {prof['device_busy_share']:.4f} of the median "
          f"unprofiled prove ({prof['wall_ms']:.2f} ms)")
    for k in prof["kernels"][:PROFILE_TOP]:
        print(f"  {k['ms']:10.4f} ms {k['launches']:6d} x {k['name'][:110]}")
    return proofs, times, median_phases, launches, prof


def _recorded(calls, label, fn):
    """fn(), with the kernel calls it makes in ``calls[label]``."""
    from plonky2_goldibear_torch import ops

    ops.calls = []
    try:
        return fn()
    finally:
        calls[label], ops.calls = ops.calls, None


def _rng_state(rng):
    if hasattr(rng, "counter"):
        return rng.counter
    return rng.bit_generator.state


# every circuit's witness replay: label -> record_s, replay_s and the
# schedule's counts
WITNESS = {}


def _witness_twice(data, pw, make_rng, label, failures):
    """The witness of ``pw`` twice through ``data.circuit``: first from
    ``make_rng()`` (the fixpoint, which records the schedule, unless one
    was recorded before), then by replay from a fresh ``make_rng()``.  The
    dense matrix, the public inputs and the rng state after each must be
    equal, and the second must replay.  Returns (the replayed circuit, its
    rng, the first call's host seconds)."""
    import torch

    first, again = {}, {}
    rng1 = make_rng()
    t0 = time.perf_counter()
    c1 = data.circuit(pw, rng1, first)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    rng2 = make_rng()
    c2 = data.circuit(pw, rng2, again)
    torch.cuda.synchronize()
    stats = data.witgen_schedule(pw).stats()
    ok = {"replayed": set(again) == {"replay_s"},
          "wires": bool(torch.equal(c1.wires, c2.wires)),
          "public_inputs": c1.public_inputs == c2.public_inputs,
          "rng": _rng_state(rng1) == _rng_state(rng2)}
    rec = dict(record_s=first.get("record_s"),
               replay_s=again.get("replay_s"), **stats, equal=ok)
    if "record_s" not in first:
        rec["first_replay_s"] = first.get("replay_s")
    WITNESS[label] = rec
    print(f"{label} witness: record_s "
          + (f"{rec['record_s']:.4f}" if rec["record_s"] is not None
             else f"(recorded before; replay {rec['first_replay_s']:.4f})")
          + f", replay_s {rec['replay_s']:.4f}, n_native {stats['n_native']}"
          f", n_python {stats['n_python']}, n_instr {stats['n_instr']}; "
          "replay vs fixpoint: " + json.dumps(ok))
    failures.extend(f"{label}: the replayed witness's {k} differs from the "
                    "fixpoint's" for k, v in ok.items() if not v)
    return c2, rng2, first_s


def _built(make, config, label, calls, timings=None, spec=None,
           hasher=None):
    """(data, inputs, gadgets s, build s, launches): the circuit of ``make``
    built on the card over the field of ``spec`` (Goldilocks by default)
    with ``hasher`` (the field's own by default), the kernel calls of the
    build in ``calls[label]`` and its launches counted (the counts set to
    0 just before it)."""
    import torch

    from plonky2_goldibear_torch import ops
    from plonky2_goldibear_torch.field import host
    from plonky2_goldibear_torch.plonk.builder import CircuitBuilder

    b = CircuitBuilder(config, spec or host.GOLDILOCKS, hasher=hasher)
    t0 = time.perf_counter()
    inputs = make(b)
    gadgets_s = time.perf_counter() - t0
    ops.reset_launches()
    ops.calls = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        data = b.build(device="cuda", timings=timings)
        torch.cuda.synchronize()
    finally:
        calls[label], ops.calls = ops.calls, None
    build_s = time.perf_counter() - t0
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"{label}: 2^{data.common.degree_bits} rows, gadgets "
          f"{gadgets_s:.4f} s, build {build_s:.4f} s "
          + (json.dumps({k: round(v, 4) for k, v in timings.items()})
             if timings else "") + ", launches " + json.dumps(launches))
    return data, inputs, gadgets_s, build_s, launches


def phase_zk_lookups(report, failures, calls, made) -> None:
    """Phase 7 (see the module docstring): zero knowledge and lookups.
    ``calls`` gets the kernel calls of each build and prove of paths A and
    B, ``made`` each (label, proof, verifier data, common data) for phase
    5."""
    from dataclasses import replace

    import numpy as np
    import torch

    from plonky2_goldibear_torch import circuits, ops
    from plonky2_goldibear_torch.field import gl
    from plonky2_goldibear_torch.gates.basic_gates import NoopGate
    from plonky2_goldibear_torch.gates.poseidon import PoseidonGate
    from plonky2_goldibear_torch.iop.generator import NonRandomRng
    from plonky2_goldibear_torch.iop.witness import PartialWitness
    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk import serialization as ser
    from plonky2_goldibear_torch.plonk.circuit_data import (circuit_meta,
                                                            read_fixture)
    from plonky2_goldibear_torch.plonk.config import CircuitConfig
    from plonky2_goldibear_torch.plonk.proof import flatten_proof
    from plonky2_goldibear_torch.recursion import recursive_verifier as rv

    gl_kernels = ("ntt", "permute", "leaf_sponge", "merkle_levels")
    rec = report.setdefault("zk_lookups", {})
    expect = functools.partial(_expect, rec, failures)
    rejects = functools.partial(_rejects, failures)
    bump_wire = _bump_wire(7, gl.P)

    def bump_output(pr):
        pr.public_inputs[-1] = (pr.public_inputs[-1] + 1) % gl.P

    # -- A: the regression recursion, zk, 2^14 ---------------------------
    zk = CircuitConfig.standard_recursion_zk_config_gl()
    std = CircuitConfig.standard_recursion_config_gl()
    inner, _, _, inner_build_s, _ = _built(
        lambda b: circuits.regression_inner(b, NoopGate(), PoseidonGate()),
        zk, "zk_inner_build", calls, {})
    expect("zk regression inner built vs the JAX build", {
        "degree_bits": inner.common.degree_bits == 14,
        "constants_sigmas_cap_and_digest": inner.verifier_only
        == ser.read_verifier_only_circuit_data(
            _read_bin("zk_regression_inner_verifier.bin"))})
    ops.calls = []
    try:
        t0 = time.perf_counter()
        inner_proof = inner.prove(PartialWitness(),
                                  rng=np.random.default_rng(1))
        torch.cuda.synchronize()
        inner_prove_s = time.perf_counter() - t0
    finally:
        calls["zk_inner_prove"], ops.calls = ops.calls, None
    inner.verify(inner_proof)
    print(f"zk regression inner: whole data.prove {inner_prove_s:.4f} s; "
          "verified")
    made.append(("zk_inner_2e14", inner_proof, inner.verifier_only,
                 inner.common))

    build_phases = {}
    holder = {}

    def regression_outer(b):
        holder["t"] = circuits.recursive_verifier(b, inner.common,
                                                  public_inputs=False)

    outer, _, gadgets_s, build_s, build_launches = _built(
        regression_outer, zk, "zk_outer_build", calls, build_phases)
    proof_t, vk_t = holder["t"]
    want = ser.read_common_circuit_data(open(os.path.join(
        ROOT, RUST_PROOF.format("common")), "rb").read())
    ok = _common_equal(outer.common, want)
    ok["degree_bits"] = outer.common.degree_bits == want.degree_bits == 14
    ok["constants_sigmas_cap_and_digest"] = outer.verifier_only == \
        ser.read_verifier_only_circuit_data(
            _read_bin("zk_regression_outer_verifier.bin"))
    expect("zk regression outer built vs the reference's common data and "
           "the JAX cap and digest", ok)
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, inner_proof)
    rv.set_verifier_data_target(pw, vk_t, inner.verifier_only)
    circuit, _, witgen_s = _witness_twice(
        outer, pw, lambda: np.random.default_rng(2), "zk regression outer",
        failures)
    TRANSCRIPT_CELLS["A_zk_2e14"] = (
        circuit, lambda: np.random.default_rng(5), None)
    print(f"zk regression outer: gadgets {gadgets_s:.4f} s, build "
          f"{build_s:.4f} s, witgen {witgen_s:.4f} s")
    ops.calls = []
    try:
        first = prover.prove(circuit, device="cuda")    # also the warm-up
    finally:
        calls["zk_outer_prove"], ops.calls = ops.calls, None
    proofs, times, phases, launches, prof = _timed_proves(
        lambda t: prover.prove(circuit, device="cuda", timings=t),
        ZK_PROVE_REPS, "zk regression outer 2^14", failures, gl_kernels)
    proofs = [first] + proofs
    for i, pr in enumerate(proofs[:2]):
        outer.verify(pr)
        made.append((f"zk_outer_2e14_{i}", pr, outer.verifier_only,
                     outer.common))
    if len(proofs) > 1 and \
            proofs[0].proof.wires_cap == proofs[1].proof.wires_cap:
        failures.append("zk outer: two proofs from two rngs have one "
                        "wires cap")
    else:
        print("zk outer: two proofs from two rngs differ in their wires "
              "cap; both verify")
    rejects(outer, proofs[0], "zk outer 2^14", bump_wire)
    rec["zk_outer"] = dict(
        inner_build_s=inner_build_s, inner_prove_s=inner_prove_s,
        gadgets_s=gadgets_s, build_s=build_s, build_phases=build_phases,
        build_launches=build_launches, witgen_s=witgen_s, prove_s=times,
        phases=phases, launches=launches, profile=prof)

    # -- B: the 2^16-entry table, 2^12 rows -------------------------------
    u16, ins, gadgets_s, build_s, build_launches = _built(
        circuits.u16_table, std, "u16_build", calls, {})
    ok = _common_equal(u16.common, ser.read_common_circuit_data(
        _read_bin("lookup_u16_common.bin")))
    ok["degree_bits"] = u16.common.degree_bits == 12
    ok["constants_sigmas_cap_and_digest"] = u16.verifier_only == \
        ser.read_verifier_only_circuit_data(_read_bin(
            "lookup_u16_verifier.bin"))
    expect("u16 table 2^12 built vs the JAX build", ok)
    pw = PartialWitness()
    pw.set_targets(ins, circuits.u16_inputs())
    circuit, _, witgen_s = _witness_twice(
        u16, pw, lambda: np.random.default_rng(3), "u16 table", failures)
    TRANSCRIPT_CELLS["B_u16_2e12"] = (
        circuit, lambda: np.random.default_rng(6), None)
    print(f"u16 table: gadgets {gadgets_s:.4f} s, build {build_s:.4f} s, "
          f"witgen {witgen_s:.4f} s")
    host_wires = gl.to_ints(circuit.wires)
    # two challenges' deltas at once, as the prover sends them
    deltas = [int(v) % gl.P for v in np.random.default_rng(4).integers(
        0, 1 << 62, 8)]
    dev = gl.to_ints(prover.compute_lookup_polys(
        gl, u16.common, circuit.lookup_rows, circuit.wires, deltas))
    ref = [r for i in (0, 4) for r in prover.compute_lookup_polys_host(
        u16.common, circuit.lookup_rows, host_wires, deltas[i:i + 4])]
    same = bool(np.array_equal(dev, np.asarray(ref, np.uint64)))
    expect("u16 lookup_polys on the card vs the scalar host reference",
           {"lookup_polys": same})
    # the lookup_polys phase alone: its launches and device time
    t0 = time.perf_counter()
    prover.compute_lookup_polys(gl, u16.common, circuit.lookup_rows,
                                circuit.wires, deltas)
    torch.cuda.synchronize()
    lp = _profile(lambda: prover.compute_lookup_polys(
        gl, u16.common, circuit.lookup_rows, circuit.wires, deltas),
        (time.perf_counter() - t0) * 1e3)
    lp_launches = sum(k["launches"] for k in lp["kernels"])
    print(f"u16 lookup_polys (two challenges): {lp['wall_ms']:.2f} ms, "
          f"{lp_launches} launches, device {lp['device_ms']:.2f} ms")
    ops.calls = []
    try:
        prover.prove(circuit, device="cuda")
    finally:
        calls["u16_prove"], ops.calls = ops.calls, None
    proofs, times, phases, launches, prof = _timed_proves(
        lambda t: prover.prove(circuit, device="cuda", timings=t), 3,
        "u16 table 2^12", failures, gl_kernels)
    u16.verify(proofs[0])
    rejects(u16, proofs[0], "u16 table 2^12", bump_output)
    made.append(("u16_2e12", proofs[0], u16.verifier_only, u16.common))
    rec["u16"] = dict(gadgets_s=gadgets_s, build_s=build_s,
                      build_launches=build_launches, witgen_s=witgen_s,
                      prove_s=times, phases=phases, launches=launches,
                      profile=prof, lookup_polys_launches=lp_launches,
                      lookup_polys_profile=lp)

    # the CPU tests' circuits against their JAX fixtures, on the card
    zk1 = CircuitConfig.standard_recursion_zk_config_gl()
    zk1 = replace(zk1, fri_config=replace(zk1.fri_config,
                                          num_query_rounds=1))
    small = {}
    for name, make, config, values in (
            ("zk_fib_1q", circuits.zk_fib, zk1, circuits.ZK_FIB_INPUTS),
            ("lookup_tip5", circuits.tip5_lookups, std, circuits.TIP5_INPUTS),
            ("lookup_two_tables", circuits.two_tables, std,
             circuits.TWO_TABLE_INPUTS)):
        data, ins, *_ = _built(make, config, name, {})
        pw = PartialWitness()
        pw.set_targets(ins, values)
        _witness_twice(data, pw, NonRandomRng, name, failures)
        rng, t = NonRandomRng(1), {}
        proof = data.prove(pw, rng=rng, timings=t)
        arrays, meta = read_fixture(os.path.join(ROOT, DATA.format(
            name + ".npz")))
        flat = flatten_proof(proof)
        ok = {"meta": circuit_meta(data, "goldilocks") == meta,
              "proved_from_a_replay": "replay_s" in t,
              "constants_sigmas_cap": bool(np.array_equal(np.asarray(
                  data.verifier_only.constants_sigmas_cap, np.uint64),
                  arrays["constants_sigmas_cap"])),
              "counter": rng.counter == int(arrays["proof_counter"])}
        ok.update({f"proof_{k}": bool(np.array_equal(v, arrays["proof_" + k]))
                   for k, v in flat.items()})
        expect(f"{name} on the card vs the JAX fixture", ok)
        data.verify(proof)
        rejects(data, proof, name, bump_output)
        made.append((name, proof, data.verifier_only, data.common))
        small[name] = (data, proof)

    # -- C: the recursive verifier over the Tip5-16 lookup proof ----------
    tip5, tip5_proof = small["lookup_tip5"]
    lr, _, gadgets_s, build_s, _ = _built(
        lambda b: holder.update(t=circuits.recursive_verifier(
            b, tip5.common)), std, "lookup_recursive_build", {})
    proof_t, vk_t = holder["t"]
    ok = _common_equal(lr.common, ser.read_common_circuit_data(
        _read_bin("lookup_recursive_common.bin")))
    ok["constants_sigmas_cap_and_digest"] = lr.verifier_only == \
        ser.read_verifier_only_circuit_data(_read_bin(
            "lookup_recursive_verifier.bin"))
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, tip5_proof)
    rv.set_verifier_data_target(pw, vk_t, tip5.verifier_only)
    circuit, rng, witgen_s = _witness_twice(
        lr, pw, NonRandomRng, "lookup recursion (C)", failures)
    import hashlib
    digests = np.stack([np.frombuffer(hashlib.sha256(np.ascontiguousarray(
        col, dtype=np.uint64).tobytes()).digest(), dtype=np.uint8)
        for col in gl.to_ints(circuit.wires)])
    with np.load(os.path.join(ROOT, DATA.format(
            "lookup_recursive.npz"))) as z:
        ok["witness_columns"] = bool(np.array_equal(digests,
                                                    z["column_sha256"]))
        ok["counter"] = rng.counter == int(z["counter"])
    expect("lookup recursion outer built and witnessed vs the JAX build",
           ok)
    t0 = time.perf_counter()
    proof = prover.prove(circuit, device="cuda")
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    lr.verify(proof)
    rejects(lr, proof, f"lookup recursion outer 2^{lr.common.degree_bits}",
            bump_wire)
    print(f"lookup recursion outer 2^{lr.common.degree_bits}: gadgets "
          f"{gadgets_s:.4f} s, build {build_s:.4f} s, witgen "
          f"{witgen_s:.4f} s, prove {prove_s:.4f} s")
    made.append(("lookup_recursive", proof, lr.verifier_only, lr.common))
    rec["lookup_recursive"] = dict(gadgets_s=gadgets_s, build_s=build_s,
                                   witgen_s=witgen_s, prove_s=prove_s)


def phase_bb_recursion(inner, inner_proof, report, failures, calls,
                       made) -> None:
    """Phase 8 (see the module docstring): BabyBear recursion over
    ``inner`` (the BB 2^12 chain's ``CircuitData``) and ``inner_proof``,
    then the width-24 hash and the BB lookup circuits against their JAX
    fixtures.  ``calls`` gets the kernel calls of each build and prove,
    ``made`` each (label, proof, verifier data, common data) for phase
    5."""
    import numpy as np
    import torch

    from plonky2_goldibear_torch import circuits
    from plonky2_goldibear_torch.field import bb, host
    from plonky2_goldibear_torch.iop.generator import NonRandomRng
    from plonky2_goldibear_torch.iop.witness import PartialWitness
    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk import serialization as ser
    from plonky2_goldibear_torch.plonk.circuit_data import (circuit_meta,
                                                            read_fixture)
    from plonky2_goldibear_torch.plonk.config import CircuitConfig
    from plonky2_goldibear_torch.plonk.proof import flatten_proof
    from plonky2_goldibear_torch.recursion import recursive_verifier as rv

    spec = host.BABYBEAR
    bb_kernels = ("ntt_bb", "p2_permute", "p2_leaf_sponge",
                  "p2_merkle_levels")
    rec = report.setdefault("bb_recursive", {})
    expect = functools.partial(_expect, rec, failures)
    rejects = functools.partial(_rejects, failures)

    # -- the BB outer over the 2^12 chain's proof: one build --------------
    holder, timings = {}, {}
    outer, _, gadgets_s, build_s, build_launches = _built(
        lambda b: holder.update(t=circuits.recursive_verifier(
            b, inner.common)), inner.common.config, "build", calls,
        timings, spec)
    failures.extend(f"kernel {k} was not launched by the BB recursive build"
                    for k in ("ntt_bb", "p2_leaf_sponge", "p2_merkle_levels")
                    if build_launches.get(k, 0) <= 0)
    proof_t, vk_t = holder["t"]
    want = ser.read_common_circuit_data(
        _read_bin("recursive_bb_2e12inner_common.bin"), spec)
    ok = {"degree_bits": outer.common.degree_bits == want.degree_bits,
          **_common_equal(outer.common, want),
          "constants_sigmas_cap_and_digest": outer.verifier_only
          == ser.read_verifier_only_circuit_data(
              _read_bin("recursive_bb_2e12inner_verifier.bin"), spec)}
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, inner_proof)
    rv.set_verifier_data_target(pw, vk_t, inner.verifier_only)
    circuit, _, witgen_s = _witness_twice(outer, pw, NonRandomRng,
                                          "BB recursive outer", failures)
    TRANSCRIPT_CELLS[f"bb_recursive_2e{outer.common.degree_bits}"] = (
        circuit, NonRandomRng, None)
    ok["public_inputs"] = circuit.public_inputs == \
        list(inner_proof.public_inputs)
    label = f"BB recursive 2^{outer.common.degree_bits}"
    expect(f"{label} built by the port vs the JAX build", ok)
    print(f"{label}: gadgets_s {gadgets_s:.4f}, build_s {build_s:.4f} "
          + json.dumps({k: round(v, 4) for k, v in timings.items()})
          + f", witgen_s {witgen_s:.4f}")

    # the warm-up prove records the kernel calls; 3 timed, 1 profiled
    _recorded(calls, "prove", lambda: prover.prove(circuit, device="cuda"))
    proofs, times, phases, launches, prof = _timed_proves(
        lambda t: prover.prove(circuit, device="cuda", timings=t), 3,
        label, failures, bb_kernels)
    proof = proofs[-1]
    outer.verify(proof)
    rejects(outer, proof, label, _bump_wire(0, bb.P))
    made.append(("babybear_recursive_2e12", proof, outer.verifier_only,
                 outer.common))
    rec.update(gadgets_s=gadgets_s, build_s=build_s, build_phases=timings,
               build_launches=build_launches, witgen_s=witgen_s,
               prove_s=times, phases=phases, launches=launches,
               profile=prof, degree_bits=outer.common.degree_bits)

    # -- the width-24 hash and the BB Tip5-16 lookups, against JAX --------
    for name, make, config, values in (
            ("r0_hash", circuits.r0_hash,
             CircuitConfig.recursion_config_bb_wide(),
             circuits.r0_hash_inputs()),
            ("lookup_tip5_bb", circuits.tip5_lookups,
             CircuitConfig.standard_recursion_config_bb(),
             circuits.TIP5_INPUTS)):
        data, ins, *_ = _built(make, config, f"{name}_build", calls,
                               spec=spec)
        pw = PartialWitness()
        pw.set_targets(ins, values)
        _witness_twice(data, pw, NonRandomRng, name, failures)
        rng, t = NonRandomRng(1), {}
        proof = _recorded(calls, f"{name}_prove",
                          lambda: data.prove(pw, rng=rng, timings=t))
        arrays, meta = read_fixture(os.path.join(ROOT, DATA.format(
            name + ".npz")))
        ok = {"meta": circuit_meta(data, "babybear") == meta,
              "proved_from_a_replay": "replay_s" in t,
              "constants_sigmas_cap": bool(np.array_equal(np.asarray(
                  data.verifier_only.constants_sigmas_cap, np.uint64),
                  arrays["constants_sigmas_cap"])),
              "counter": rng.counter == int(arrays["proof_counter"])}
        ok.update({f"proof_{k}": bool(np.array_equal(v, arrays["proof_" + k]))
                   for k, v in flatten_proof(proof).items()})
        expect(f"{name} on the card vs the JAX fixture", ok)
        data.verify(proof)
        rejects(data, proof, name, _bump_wire(1, bb.P))
        made.append((name, proof, data.verifier_only, data.common))


def phase_keccak(inner, inner_proof, report, failures, calls,
                 made) -> dict:
    """Phase 9 (see the module docstring): the Keccak config.  The small
    circuit against its JAX fixture, then the Keccak outer over ``inner``
    (phase 6's outer ``CircuitData``) and ``inner_proof``.  ``calls`` gets
    the kernel calls of each build and prove, ``made`` each (label, proof,
    verifier data, common data) for phase 5.  Returns the launches of one
    Keccak outer prove."""
    import numpy as np
    import torch

    from plonky2_goldibear_torch import circuits, ops
    from plonky2_goldibear_torch.field import gl
    from plonky2_goldibear_torch.hash import keccak_hasher
    from plonky2_goldibear_torch.iop.generator import NonRandomRng
    from plonky2_goldibear_torch.iop.witness import PartialWitness
    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk import serialization as ser
    from plonky2_goldibear_torch.plonk.circuit_data import (circuit_meta,
                                                            read_fixture)
    from plonky2_goldibear_torch.plonk.config import CircuitConfig
    from plonky2_goldibear_torch.plonk.proof import (PROOF_PHASES,
                                                     flatten_proof)
    from plonky2_goldibear_torch.recursion import recursive_verifier as rv

    rec = report.setdefault("keccak", {})
    expect = functools.partial(_expect, rec, failures)
    rejects = functools.partial(_rejects, failures)
    kernels = ("ntt",) + KECCAK_COUNTERS

    def flip_cap_byte(proof):
        cap = proof.proof.wires_cap
        cap[0] = bytes([cap[0][0] ^ 1]) + cap[0][1:]

    # -- the small circuit (x^31, 8 PoW bits) against the JAX fixture -----
    data, x, *_ = _built(circuits.keccak_pow31,
                         circuits.keccak_pow31_config(CircuitConfig),
                         "keccak_pow31_build", calls, hasher=keccak_hasher)
    pw = PartialWitness()
    pw.set_target(x, circuits.KECCAK_POW31_INPUT)
    _witness_twice(data, pw, NonRandomRng, "keccak_pow31", failures)
    rng, t = NonRandomRng(1), {}
    ops.reset_launches()
    proof = _recorded(calls, "keccak_pow31_prove",
                      lambda: data.prove(pw, rng=rng, timings=t))
    small_launches = ops.launch_counts()
    arrays, meta = read_fixture(os.path.join(ROOT, DATA.format(
        "keccak_pow31.npz")))
    common_j = ser.read_common_circuit_data(_read_bin(
        "keccak_pow31_common.bin"))
    proof_j = ser.read_proof_with_public_inputs(
        _read_bin("keccak_pow31_proof.bin"), common_j, hasher=keccak_hasher)
    ok = {"meta": circuit_meta(data, "goldilocks") == meta,
          "proved_from_a_replay": "replay_s" in t,
          **_common_equal(data.common, common_j),
          "constants_sigmas": bool(np.array_equal(
              gl.to_ints(data.prover_only.constants_sigmas_values),
              arrays["constants_sigmas"])),
          "cap_and_digest_bytes": data.verifier_only
          == ser.read_verifier_only_circuit_data(
              _read_bin("keccak_pow31_verifier.bin"), hasher=keccak_hasher),
          "counter": rng.counter == int(arrays["proof_counter"]),
          # the smallest PoW witness, ground by the hash-onion kernel
          "pow_grind_on_the_kernel": small_launches["keccak_permute"] > 0}
    got, want = flatten_proof(proof), flatten_proof(proof_j)
    ok.update({f"proof_{k}": bool(np.array_equal(got[k], want[k]))
               for k in PROOF_PHASES})
    expect("keccak_pow31 on the card vs the JAX fixture", ok)
    data.verify(proof)
    data.verify(proof_j)
    rejects(data, proof_j, "keccak_pow31 (the JAX proof)", flip_cap_byte)
    made.append(("keccak_pow31", proof, data.verifier_only, data.common))

    # -- the Keccak outer over phase 6's Poseidon outer: one build --------
    holder, timings = {}, {}
    outer, _, gadgets_s, build_s, build_launches = _built(
        lambda b: holder.update(t=circuits.recursive_verifier(
            b, inner.common)), inner.common.config, "keccak_outer_build",
        calls, timings, hasher=keccak_hasher)
    failures.extend(f"kernel {k} was not launched by the Keccak outer's "
                    "build" for k in ("ntt", "keccak_rows",
                                      "keccak_merkle_levels",
                                      "keccak_merkle_subtree")
                    if build_launches.get(k, 0) <= 0)
    proof_t, vk_t = holder["t"]
    want = ser.read_common_circuit_data(_read_bin(
        "recursive_keccak_gl_2e12_common.bin"))
    ok = {"degree_bits": outer.common.degree_bits == want.degree_bits,
          **_common_equal(outer.common, want),
          "cap_and_digest_bytes": outer.verifier_only
          == ser.read_verifier_only_circuit_data(
              _read_bin("recursive_keccak_gl_2e12_verifier.bin"),
              hasher=keccak_hasher)}
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, inner_proof)
    rv.set_verifier_data_target(pw, vk_t, inner.verifier_only)
    circuit, _, witgen_s = _witness_twice(outer, pw, NonRandomRng,
                                          "Keccak outer", failures)
    ok["public_inputs"] = circuit.public_inputs == \
        list(inner_proof.public_inputs)
    label = f"Keccak outer 2^{outer.common.degree_bits}"
    expect(f"{label} built by the port vs the JAX build", ok)
    print(f"{label}: gadgets_s {gadgets_s:.4f}, build_s {build_s:.4f} "
          + json.dumps({k: round(v, 4) for k, v in timings.items()})
          + f", witgen_s {witgen_s:.4f}")

    # the warm-up prove records the kernel calls; 3 timed, 1 profiled
    _recorded(calls, "keccak_outer_prove",
              lambda: prover.prove(circuit, device="cuda"))
    proofs, times, phases, launches, prof = _timed_proves(
        lambda t: prover.prove(circuit, device="cuda", timings=t), 3,
        label, failures, kernels)
    proof = proofs[-1]
    outer.verify(proof)
    rejects(outer, proof, label, flip_cap_byte)
    rejects(outer, proof, label, _bump_wire(0, gl.P))
    made.append(("goldilocks_keccak_recursive_2e12", proof,
                 outer.verifier_only, outer.common))
    rec.update(gadgets_s=gadgets_s, build_s=build_s, build_phases=timings,
               build_launches=build_launches, witgen_s=witgen_s,
               prove_s=times, phases=phases, launches=launches,
               profile=prof, degree_bits=outer.common.degree_bits)
    return launches


def _witness_and_prove(data, pw, label, failures, calls, kernels, reps=0):
    """Witness generation of ``pw`` (``witgen_s``), then its prove from
    ``NonRandomRng(1)`` on, with its kernel calls in ``calls[label]`` and
    every kernel's launches counted (the counts set to 0 just before it),
    and ``verify_s`` of that proof.  That prove is timed as
    ``first_prove_s``: a circuit's first prove also fills its cache.  With
    ``reps``, ``_timed_proves`` times that many warm proves of the same
    witness (``prove_s``) and profiles one more.  Returns (proof,
    numbers)."""
    import torch

    from plonky2_goldibear_torch import ops
    from plonky2_goldibear_torch.iop.generator import NonRandomRng
    from plonky2_goldibear_torch.plonk import prover

    circuit, rng, witgen_s = _witness_twice(data, pw, NonRandomRng, label,
                                            failures)
    ops.reset_launches()
    timings = {}
    t0 = time.perf_counter()
    proof = _recorded(calls, label, lambda: prover.prove(
        circuit, device="cuda", timings=timings, rng=rng))
    torch.cuda.synchronize()
    first_prove_s = time.perf_counter() - t0
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    failures.extend(f"kernel {k} was not launched by the {label} prove"
                    for k in kernels if launches.get(k, 0) <= 0)
    nums = {"witgen_s": witgen_s, "first_prove_s": first_prove_s,
            "first_phases": timings, "first_launches": launches}
    t0 = time.perf_counter()
    data.verify(proof)
    nums["verify_s"] = time.perf_counter() - t0
    print(f"{label}: witgen_s {witgen_s:.4f}, first prove {first_prove_s:.4f}"
          f" s, verify_s {nums['verify_s']:.4f}; phases " + json.dumps(
              {k: round(v, 4) for k, v in timings.items()})
          + "; launches " + json.dumps(launches))
    if reps:
        _, times, phases, warm_launches, prof = _timed_proves(
            lambda t: prover.prove(circuit, device="cuda", timings=t), reps,
            label, failures, kernels)
        nums.update(prove_s=times, phases=phases, launches=warm_launches,
                    profile=prof)
    return proof, nums


def phase_cyclic(inner, inner_proof, report, failures, calls, made) -> None:
    """Phase 10 (see the module docstring): AddManyGate, conditional
    recursion, the IVC counter and the GL double recursion over ``inner``
    (phase 6's outer ``CircuitData``) and ``inner_proof``.  ``calls`` gets
    the kernel calls of each build and profiled prove, ``made`` each
    (label, proof, verifier data, common data) for phase 5."""
    import copy

    import numpy as np

    from plonky2_goldibear_torch import circuits
    from plonky2_goldibear_torch.field import gl
    from plonky2_goldibear_torch.hash import poseidon_gl
    from plonky2_goldibear_torch.iop.generator import NonRandomRng
    from plonky2_goldibear_torch.iop.witness import PartialWitness
    from plonky2_goldibear_torch.plonk import gadgets as gd
    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk import serialization as ser
    from plonky2_goldibear_torch.plonk.circuit_data import (circuit_meta,
                                                            read_fixture)
    from plonky2_goldibear_torch.plonk.config import CircuitConfig
    from plonky2_goldibear_torch.plonk.proof import (PROOF_PHASES,
                                                     flatten_proof)
    from plonky2_goldibear_torch.recursion import conditional as cc
    from plonky2_goldibear_torch.recursion import recursive_verifier as rv

    rec = report.setdefault("cyclic", {})
    expect = functools.partial(_expect, rec, failures)
    rejects = functools.partial(_rejects, failures)
    kernels = ("ntt", "permute", "leaf_sponge", "merkle_levels")
    config = CircuitConfig.standard_recursion_config_gl()

    def jax_bins(name):
        common = ser.read_common_circuit_data(_read_bin(name + "_common.bin"))
        return common, ser.read_verifier_only_circuit_data(
            _read_bin(name + "_verifier.bin"))

    def built(label, make):
        """(data, targets, numbers) of ``make``'s circuit built on the
        card; ``gadgets_s`` holds the dummy circuits' builds and proofs,
        ``dummy_s`` says how long they took."""
        timings = {}
        data, targets, gadgets_s, build_s, launches = _built(
            lambda b: make(b, timings), config, label + "_build", calls,
            timings)
        return data, targets, {"gadgets_s": gadgets_s,
                               "dummy_s": timings.pop("dummy_s", 0.0),
                               "build_s": build_s, "build_phases": timings,
                               "build_launches": launches}

    # -- add_many_sums against the JAX fixture ------------------------------
    data, xs, nums = built("add_many_sums",
                           lambda b, t: circuits.add_many_sums(b))
    pw = PartialWitness()
    pw.set_targets(xs, circuits.ADD_MANY_INPUTS)
    proof, more = _witness_and_prove(data, pw, "add_many_sums", failures,
                                     calls, kernels, REPS_10)
    ok = _profile_readers(lambda: prover.prove(
        data.circuit(pw, NonRandomRng(1)), device="cuda"))
    expect("add_many_sums profile, raw events vs prof.events()", ok)
    arrays, meta = read_fixture(os.path.join(ROOT, DATA.format(
        "add_many_sums.npz")))
    common_j, vk_j = jax_bins("add_many_sums")
    ok = {"meta": circuit_meta(data, "goldilocks") == meta,
          **_common_equal(data.common, common_j),
          "constants_sigmas": bool(np.array_equal(
              gl.to_ints(data.prover_only.constants_sigmas_values),
              arrays["constants_sigmas"])),
          "cap_and_digest": data.verifier_only == vk_j,
          "sums": proof.public_inputs == [
              sum(circuits.ADD_MANY_INPUTS[:n]) % gl.P
              for n in circuits.ADD_MANY_COUNTS]}
    got = flatten_proof(proof)
    ok.update({f"proof_{k}": bool(np.array_equal(got[k], arrays["proof_" + k]))
               for k in PROOF_PHASES})
    expect("add_many_sums on the card vs the JAX fixture", ok)
    rejects(data, proof, "add_many_sums", _bump_wire(0, gl.P))
    made.append(("add_many_sums", proof, data.verifier_only, data.common))
    rec["add_many_sums"] = dict(nums, **more)

    # -- the conditional verifier over fib_inner, both branches -------------
    fib, fib_in, _ = built("fib_inner", lambda b, t: circuits.fib_inner(b))
    pw = PartialWitness()
    pw.set_targets(fib_in, circuits.FIB_INNER_INPUTS)
    _witness_twice(fib, pw, NonRandomRng, "fib_inner", failures)
    fib_proof = fib.prove(pw, rng=NonRandomRng(1))
    fib.verify(fib_proof)
    got = flatten_proof(fib_proof)
    want = flatten_proof(ser.read_proof_with_public_inputs(
        _read_bin("fib_inner_proof.bin"), fib.common))
    expect("fib_inner on the card vs the JAX proof",
           {f"proof_{k}": bool(np.array_equal(got[k], want[k]))
            for k in PROOF_PHASES})
    dummy = cc.dummy_circuit(fib.common, device="cuda")
    dummy_proof = cc.dummy_proof(dummy, {}, rng=NonRandomRng(1))
    dummy.verify(dummy_proof)
    common_j, vk_j = jax_bins("dummy_fib")
    got = flatten_proof(dummy_proof)
    want = flatten_proof(ser.read_proof_with_public_inputs(
        _read_bin("dummy_fib_proof.bin"), dummy.common))
    expect("the dummy circuit over fib_inner on the card vs the JAX build "
           "and proof", {"common": dummy.common == common_j,
                         "cap_and_digest": dummy.verifier_only == vk_j,
                         **{f"proof_{k}": bool(np.array_equal(got[k],
                                                              want[k]))
                            for k in PROOF_PHASES}})
    outer, (cond, proof_t, vk_t), nums = built(
        "conditional_outer", lambda b, t: circuits.conditional_outer(
            b, fib.common, cc, rv, gd, device="cuda", rng=NonRandomRng(1),
            timings=t))
    label = f"conditional outer 2^{outer.common.degree_bits}"
    rec["conditional"] = dict(nums, degree_bits=outer.common.degree_bits)
    for condition in (1, 0):
        pw = PartialWitness()
        pw.set_target(cond, condition)
        rv.set_proof_with_pis_target(pw, proof_t, fib_proof)
        rv.set_verifier_data_target(pw, vk_t, fib.verifier_only)
        proof, more = _witness_and_prove(
            outer, pw, f"conditional_outer_c{condition}", failures, calls,
            kernels, REPS_10 if condition == 1 else 0)
        rejects(outer, proof, f"{label}, condition {condition}",
                _bump_wire(0, gl.P))
        rec["conditional"][f"condition_{condition}"] = more
    made.append(("conditional_outer_c0", proof, outer.verifier_only,
                 outer.common))
    print(f"{label}: gadgets_s {nums['gadgets_s']:.4f} (dummy circuit "
          f"built and proved: {nums['dummy_s']:.4f}), build_s "
          f"{nums['build_s']:.4f}")

    # -- the IVC counter: base case and two steps ---------------------------
    t0 = time.perf_counter()
    common = cc.common_data_for_recursion(config)
    fixed_point_s = time.perf_counter() - t0
    data, (cond, inner_t, vk_t), nums = built(
        "cyclic_counter", lambda b, t: circuits.cyclic_counter(
            b, common, cc, rv, device="cuda", rng=NonRandomRng(1),
            timings=t))
    common_j, vk_j = jax_bins("cyclic_counter")
    fixed_j = ser.read_common_circuit_data(_read_bin("cyclic_common.bin"))
    fixed_j.num_public_inputs = common.num_public_inputs
    ok = {"fixed_point": common == fixed_j,
          "goal": data.common == common,
          **_common_equal(data.common, common_j),
          "cap_and_digest": data.verifier_only == vk_j}
    label = f"IVC counter 2^{data.common.degree_bits}"
    expect(f"{label} built by the port vs the JAX build", ok)
    base_t = {}
    base = cc.cyclic_base_proof(common, data.verifier_only, dict(
        enumerate(circuits.CYCLIC_INITIAL_HASH)), device="cuda",
        rng=NonRandomRng(1), timings=base_t)
    steps, prev = [], base
    for step, condition in enumerate((0, 1, 1)):
        pw = PartialWitness()
        pw.set_target(cond, condition)
        rv.set_proof_with_pis_target(pw, inner_t, prev)
        rv.set_verifier_data_target(pw, vk_t, data.verifier_only)
        prev, more = _witness_and_prove(data, pw, f"cyclic_step{step}",
                                        failures, calls, kernels,
                                        REPS_10 if step == 1 else 0)
        cc.check_cyclic_proof_verifier_data(prev, data.verifier_only, common)
        steps.append(dict(more, counter=prev.public_inputs[8]))
    made.append(("cyclic_counter_step2", prev, data.verifier_only,
                 data.common))
    h = list(circuits.CYCLIC_INITIAL_HASH)
    for _ in range(3):
        h = poseidon_gl.hash_no_pad_host(h)
    ok = {"counters": [s["counter"] for s in steps] == [0, 1, 2],
          # one set of presets: step 0 recorded, steps 1 and 2 replayed
          "steps_1_2_replayed": all(
              WITNESS[f"cyclic_step{i}"]["record_s"] is None
              for i in (1, 2)),
          "initial_hash": prev.public_inputs[:4]
          == list(circuits.CYCLIC_INITIAL_HASH),
          "hash_chain": prev.public_inputs[4:8] == h}
    bad = copy.deepcopy(prev)
    bad.public_inputs[9] = (bad.public_inputs[9] + 1) % gl.P
    try:
        cc.check_cyclic_proof_verifier_data(bad, data.verifier_only, common)
        ok["tampered_vk_refused"] = False
    except ValueError:
        ok["tampered_vk_refused"] = True
    expect(f"{label}: three proofs", ok)
    rejects(data, prev, label, _bump_wire(0, gl.P))
    print(f"{label}: fixed point {fixed_point_s:.4f} s, gadgets_s "
          f"{nums['gadgets_s']:.4f} (dummy circuit built and proved: "
          f"{nums['dummy_s']:.4f}), build_s {nums['build_s']:.4f}, base "
          f"proof {base_t.get('dummy_s', 0.0):.4f} s")
    rec["cyclic"] = dict(nums, fixed_point_s=fixed_point_s,
                         base_proof_s=base_t.get("dummy_s", 0.0),
                         steps=steps, degree_bits=data.common.degree_bits)

    # -- the GL double recursion: a Poseidon outer over phase 6's outer ----
    outer, (proof_t, vk_t), nums = built(
        "double_recursion", lambda b, t: circuits.recursive_verifier(
            b, inner.common))
    pw = PartialWitness()
    rv.set_proof_with_pis_target(pw, proof_t, inner_proof)
    rv.set_verifier_data_target(pw, vk_t, inner.verifier_only)
    proof, more = _witness_and_prove(outer, pw, "double_recursion", failures,
                                     calls, kernels, REPS_10)
    label = f"GL double recursion 2^{outer.common.degree_bits}"
    expect(label, {"public_inputs": proof.public_inputs
                   == list(inner_proof.public_inputs)})
    rejects(outer, proof, label, _bump_wire(0, gl.P))
    made.append(("double_recursion", proof, outer.verifier_only,
                 outer.common))
    rec["double_recursion"] = dict(nums, **more,
                                   degree_bits=outer.common.degree_bits)


def _blocking_waits(fn):
    """(fn's result, the number of host waits on the card during fn, their
    places): ``torch.cuda.set_sync_debug_mode("warn")`` warns at each
    synchronising call (a copy to the host, a nonzero, a blocking copy to
    the card)."""
    import collections
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "called a synchronizing CUDA operation" in str(w.message))
    return out, sum(where.values()), dict(where.most_common(8))


def _group_latency_ms(dev):
    """Device ms of one permutation held by the transcript kernel's group
    (GL: 12 threads, BB: 16), from the probe runner's CUDA-graph timing of
    the Merkle tails (``probes poseidon_groups`` / ``poseidon2_groups``):
    a tail folds its levels one permutation after another, so the slope
    over its layers is a permutation's latency at that group."""
    import numpy as np

    from plonky2_goldibear_torch import probes as runner
    from plonky2_goldibear_torch.field import bb, gl
    from plonky2_goldibear_torch.ops import poseidon2_bb as P2
    from plonky2_goldibear_torch.ops import poseidon_gl as P

    rng = np.random.default_rng(0)
    out = {}
    for name, F, K, kind, top, group, width in (
            ("goldilocks", gl, P, "tail", P.TAIL_MAX_LAYERS, 16, 4),
            ("babybear", bb, P2, "subtree", P2.SUBTREE_MAX_LAYERS,
             P2.SUBTREE_GROUP, 8)):
        t = {}
        for layers in (1, top):
            d = F.from_ints(rng.integers(0, F.P, size=(16 << layers, width),
                                         dtype=np.uint64), dev)
            step = (kind, 16 << layers, layers, 16, group << (layers - 1))
            t[layers] = runner._graph_ms(lambda: K._levels(d, [step]), dev)
        out[name] = (t[top] - t[1]) / (top - 1)
    return out


def _latency_floor_ms(dev):
    """A floor under one permutation's latency, from the probe chains run
    by one warp (``LATENCY_THREADS``: the time a rep is the latency of one
    dependent operation): each round's S-box waits on the round before, and
    the linear layers and constants are left out.  GL: the rounds times the
    larger of a ``gl_sbox`` and three dependent ``gl_mul``; BB: the rounds
    times ``BB_SBOX_DEPTH_MULS`` dependent ``u32_mul``.  Returns ({field:
    ms a permutation}, {probe step: ns an operation})."""
    from plonky2_goldibear_torch import probes as runner
    from plonky2_goldibear_torch.ops import poseidon2_bb as P2
    from plonky2_goldibear_torch.ops import poseidon_gl as P
    from plonky2_goldibear_torch.ops import probes as K_probe

    ns = {}
    for step in ("gl_mul", "gl_sbox", "u32_mul"):
        x = runner.make_input(step, LATENCY_THREADS, dev)
        m = runner.marginal(lambda r: K_probe.chain(x, step, r),
                            K_probe.unroll(step), dev)
        ns[step] = m["s_per_rep"] * 1e9
    gl_sbox = max(ns["gl_sbox"], 3 * ns["gl_mul"])
    bb_rounds = P2.N_FULL + P2.N_PARTIAL
    return ({"goldilocks": P.N_ROUNDS * gl_sbox * 1e-6,
             "babybear": bb_rounds * BB_SBOX_DEPTH_MULS * ns["u32_mul"]
             * 1e-6}, ns)


def phase_transcript(report, failures, made, probe_lines):
    """Phase 11 (see the module docstring): the device-transcript prover
    against the sync one on every cell of TRANSCRIPT_CELLS, and its two
    kernels against their plain versions at the real inputs of the chains'
    proves.  ``probe_lines``: phase 3's permute checks (their bounds a
    state).  Returns the kernels line's entries of the two kernels."""
    import numpy as np
    import torch

    from plonky2_goldibear_torch import ops
    from plonky2_goldibear_torch.field import bb, gl
    from plonky2_goldibear_torch.ops import transcript as T
    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk.proof import (PROOF_PHASES,
                                                     flatten_proof)

    dev = torch.device("cuda", 0)
    rec = report.setdefault("transcript", {})
    latency = _group_latency_ms(dev)
    floor, chain_ns = _latency_floor_ms(dev)
    rec["permutation_latency_ms"] = latency
    rec["permutation_latency_floor_ms"] = floor
    rec["one_warp_chain_ns"] = chain_ns
    print("permutation latency at the transcript's group (ms): "
          + json.dumps(latency) + "; its floor from one-warp probe chains "
          "(ms): " + json.dumps(floor) + " (ns an operation: "
          + json.dumps(chain_ns) + ")")

    # -- each cell: both paths, same rng -----------------------------------
    steps = {}
    for label, (circuit, make_rng, jax_arrays) in TRANSCRIPT_CELLS.items():
        field = circuit.common.spec.name

        def prove(path):
            return prover.prove(circuit, device="cuda", rng=make_rng(),
                                timings={} if path == "sync" else None)

        times = {"sync": [], "device": []}
        proofs, launches = {}, {}
        for rep in range(TRANSCRIPT_REPS):
            for path in ("sync", "device")[::1 - 2 * (rep % 2)]:
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                proofs[path] = prove(path)
                torch.cuda.synchronize()
                times[path].append(time.perf_counter() - t0)
                launches[path] = {k: v for k, v in
                                  ops.launch_counts().items() if v}
        # the host's waits in one more (warm) prove of each path; the
        # device one keeps, on a chain, the inputs of every transcript step
        # and of the grind
        seen = []
        real_flush, real_grind = T.transcript_flush, T.pow_grind

        def flush_spy(state, out_buf, pieces, n_out, n):
            seen.append(("flush", state.clone(), out_buf.clone(),
                         [p.clone() for p in pieces], n_out, n))
            return real_flush(state, out_buf, pieces, n_out, n)

        def grind_spy(state, leftover, k):
            seen.append(("grind", state.clone(), None if leftover is None
                         else leftover.clone(), k))
            return real_grind(state, leftover, k)

        if field not in steps and label.endswith("chain_2e12"):
            T.transcript_flush, T.pow_grind = flush_spy, grind_spy
            steps[field] = seen
        waits, places = {}, {}
        try:
            _, waits["device"], places["device"] = _blocking_waits(
                lambda: prove("device"))
        finally:
            T.transcript_flush, T.pow_grind = real_flush, real_grind
        _, waits["sync"], places["sync"] = _blocking_waits(
            lambda: prove("sync"))
        profiles = {path: _profile(lambda: prove(path),
                                   statistics.median(times[path]) * 1e3)
                    for path in ("sync", "device")}
        flat = {k: flatten_proof(v) for k, v in proofs.items()}
        equal = {k: bool(np.array_equal(flat["device"][k], flat["sync"][k]))
                 for k in PROOF_PHASES}
        line = {
            "degree_bits": circuit.common.degree_bits,
            "device_equals_sync": all(equal.values()),
            "prove_s": {k: statistics.median(v) for k, v in times.items()},
            "prove_s_all": times, "launches": launches,
            "blocking_waits": waits, "wait_places": places,
            "kernel_launches": {k: sum(x["launches"] for x in p["kernels"])
                                for k, p in profiles.items()},
            "device_ms": {k: p["device_ms"] for k, p in profiles.items()},
            "busy_share": {k: p["device_busy_share"]
                           for k, p in profiles.items()}}
        if jax_arrays is not None:
            line["device_equals_jax"] = all(
                bool(np.array_equal(flat["device"][k],
                                    jax_arrays["proof_" + k]))
                for k in PROOF_PHASES)
        rec[label] = line
        print(f"device transcript {label}: " + json.dumps(line))
        if not line["device_equals_sync"]:
            failures.append(f"{label}: the device-transcript proof differs "
                            "from the sync one in " + ", ".join(
                                k for k, v in equal.items() if not v))
        if line.get("device_equals_jax") is False:
            failures.append(f"{label}: the device-transcript proof differs "
                            "from the JAX proof")
        allowed = 2 if circuit.common.num_lookup_polys else 1
        if waits["device"] != allowed:
            failures.append(f"{label}: {waits['device']} blocking waits in a "
                            f"device-transcript prove, not {allowed}: "
                            + json.dumps(places["device"]))
        for k in TRANSCRIPT_COUNTERS:
            if launches["device"].get(k, 0) <= 0:
                failures.append(f"kernel {k} was not launched by the {label} "
                                "device-transcript prove")
        made.append((f"{label}_device_transcript", proofs["device"],
                     circuit.verifier_data(), circuit.common))

    # -- the two kernels at the chains' real inputs -------------------------
    per_state = {"goldilocks": probe_lines["goldilocks"],
                 "babybear": probe_lines["babybear"]}
    flush_lines, grind_lines = [], []
    for field, seen in steps.items():
        F = gl if field == "goldilocks" else bb
        spec = F.SPEC
        perm_muls = GL_PERM_MULS if F is gl else BB_PERM_MULS
        for i, (kind, state, *rest) in enumerate(seen):
            if kind == "flush":
                out_buf, pieces, n_out, n = rest
                kern = lambda: T.transcript_flush(state, out_buf, pieces,
                                                  n_out, n)     # noqa: E731
                plain = lambda: T.transcript_flush_plain(
                    state, out_buf, pieces, n_out, n)           # noqa: E731
                total = sum(p.shape[0] for p in pieces)
                perms, _ = T.flush_schedule(total, n_out, n)
                ref, plain_ms = _timed(plain, 1, warm_up=False)
                mism, err = _compare(kern(), ref)
                ms = _cuda_ms(kern, 20)
                # the data-sheet bound (the permutations' products at the
                # card's rate), and the latency the dependent chain takes:
                # at the kernel's group, and its floor
                line = dict(field=field, step=i, total=total, n_out=n_out,
                            n=n, permutations=perms, mismatches=mism,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=perms * perm_muls * MULS_PER_FIELD_MUL
                            / report["int32_mul_per_s"] * 1e3,
                            bound_by="operations",
                            latency_bound_ms=perms * latency[field],
                            latency_floor_ms=perms * floor[field])
                flush_lines.append(line)
                print("check transcript_flush " + json.dumps(line))
                continue
            leftover, k_real = rest
            pow_real = spec.bits - k_real
            for pow_bits in sorted({pow_real, *GRIND_POW_BITS}):
                k = spec.bits - pow_bits
                out, scratch = T.pow_grind(state, leftover, k)
                ref, plain_ms = _timed(
                    lambda: T.pow_grind_plain(state, leftover, k), 1,
                    warm_up=False)
                mism, err = _compare(out, ref)
                # the bounds count the candidates the answer needs: every
                # one up to the witness, to the end of its chunk (all 2^32
                # when none passes); the kernel tried ``tried``
                w, found = (int(v) for v in F.to_ints(out))
                needed = -(-(w + 1) // T.GRIND_CHUNK) * T.GRIND_CHUNK \
                    if found else 1 << 32
                tried = int(scratch[3]) * T.GRIND_CHUNK
                ms = _cuda_ms(lambda: T.pow_grind(state, leftover, k), 5)
                b_ms = needed * perm_muls * MULS_PER_FIELD_MUL / \
                    report["int32_mul_per_s"] * 1e3
                line = dict(field=field, pow_bits=pow_bits, real=pow_bits
                            == pow_real, witness=w, found=found,
                            needed=needed, tried=tried, mismatches=mism,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by="operations",
                            probe_bound_ms=needed * per_state[field])
                grind_lines.append(line)
                print("check pow_grind " + json.dumps(line))
    rec["flush_checks"], rec["grind_checks"] = flush_lines, grind_lines
    for what, lines in (("transcript_flush", flush_lines),
                        ("pow_grind", grind_lines)):
        if not lines:
            failures.append(f"{what}: no check at a prove's inputs")
        failures.extend(f"{what} {json.dumps(x)}: mismatches" for x in lines
                        if x["mismatches"])

    # the kernels line: the GL 2^12 chain's device prove, its steps summed
    gl_launches = rec.get("gl_chain_2e12", {}).get("launches", {}).get(
        "device", {})
    gl_flush = [x for x in flush_lines if x["field"] == "goldilocks"]
    gl_grind = [x for x in grind_lines if x["field"] == "goldilocks"
                and x["real"]] or grind_lines
    entries = [{
        "name": "transcript_flush", "route": "cuda",
        "source": "plonky2_goldibear_torch/csrc/transcript.cu",
        "replaces": "plonky2_goldibear_tpu/hash/device_challenger.py:37",
        "launches": gl_launches.get("transcript_flush", 0),
        "max_abs_err": max((x["max_abs_err"] for x in flush_lines),
                           default=float("inf")),
        "ms": sum(x["ms"] for x in gl_flush),
        "plain_ms": sum(x["plain_ms"] for x in gl_flush),
        "bound_ms": sum(x["bound_ms"] for x in gl_flush),
        "bound_by": "operations", "library_ms": None,
        "latency_bound_ms": sum(x["latency_bound_ms"] for x in gl_flush),
        "latency_floor_ms": sum(x["latency_floor_ms"] for x in gl_flush)}, {
        "name": "pow_grind", "route": "cuda",
        "source": "plonky2_goldibear_torch/csrc/transcript.cu",
        "replaces": "plonky2_goldibear_tpu/fri/prover.py:520",
        "launches": gl_launches.get("pow_grind", 0),
        "max_abs_err": max((x["max_abs_err"] for x in grind_lines),
                           default=float("inf")),
        "ms": gl_grind[0]["ms"] if gl_grind else None,
        "plain_ms": gl_grind[0]["plain_ms"] if gl_grind else None,
        "bound_ms": gl_grind[0]["bound_ms"] if gl_grind else None,
        "bound_by": "operations", "library_ms": None,
        "needed": gl_grind[0]["needed"] if gl_grind else None,
        "tried": gl_grind[0]["tried"] if gl_grind else None}]
    print("transcript kernels, the GL 2^12 chain's device prove: "
          + json.dumps(entries))
    return entries


def phase_verify(made, failures) -> dict:
    """Verify each (label, proof, verifier data, common data) of ``made``
    and the reference's 2^14 proof, and reject a copy of each with one
    wire opening changed; ``verify_s`` of the 2^14 proof and of the 2^12
    proofs timed 3 times: {label: {"median": s, "all": [s, ...]}}."""
    import copy

    from plonky2_goldibear_torch.plonk import serialization as ser
    from plonky2_goldibear_torch.plonk.verifier import (VerificationError,
                                                        verify)

    def blob(part):
        with open(os.path.join(ROOT, RUST_PROOF.format(part)), "rb") as f:
            return f.read()

    common = ser.read_common_circuit_data(blob("common"))
    rust = ("rust_gl_2e14", ser.read_proof_with_public_inputs(
        blob("proof"), common), ser.read_verifier_only_circuit_data(
        blob("verifier")), common)
    verify_s, results = {}, {}
    for label, proof, vk, common in made + [rust]:
        timed = label == "rust_gl_2e14" or label.endswith(f"_2e{MAIN_BITS}")
        times = []
        try:
            for _ in range(3 if timed else 1):
                t0 = time.perf_counter()
                verify(proof, vk, common)
                times.append(time.perf_counter() - t0)
        except VerificationError as e:
            failures.append(f"verify {label}: rejected: {e}")
            results[label] = "rejected"
            continue
        bad = copy.deepcopy(proof)
        wires = bad.proof.openings.wires
        wires[0] = ((wires[0][0] + 1) % common.spec.p,) + tuple(wires[0][1:])
        try:
            verify(bad, vk, common)
            failures.append(f"verify {label}: a tampered copy was accepted")
            results[label] = "tampered copy accepted"
        except VerificationError:
            results[label] = "verified; tampered copy rejected"
        if timed:
            verify_s[label] = {"median": statistics.median(times),
                               "all": times}
    for label, result in results.items():
        print(f"verify {label}: {result}")
    return verify_s


def phase_recursion(inner, inner_proof, report, failures, calls,
                    mains) -> list:
    """Phase 6 (see the module docstring): the outer circuit over ``inner``
    (a GL 2^12 ``CircuitData``) and ``inner_proof``; ``calls`` gets the
    kernel calls of one build ("build") and one prove ("prove"), and
    ``mains["recursive"]`` the outer ``CircuitData`` and its proof (the
    inner of phase 9).  Returns [(label, outer proof, verifier data,
    common data)] for phase 5."""
    import copy

    import torch

    from plonky2_goldibear_torch import circuits, ops
    from plonky2_goldibear_torch.iop.generator import NonRandomRng
    from plonky2_goldibear_torch.iop.witness import PartialWitness
    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk import serialization as ser
    from plonky2_goldibear_torch.plonk.builder import CircuitBuilder
    from plonky2_goldibear_torch.plonk.verifier import VerificationError
    from plonky2_goldibear_torch.recursion import recursive_verifier as rv

    rec = {"gadgets_s": [], "build_s": [], "build_phases": [],
           "witgen_s": []}
    for rep in range(BUILD_REPS):
        b = CircuitBuilder(inner.common.config)
        t0 = time.perf_counter()
        proof_t, vk_t = circuits.recursive_verifier(b, inner.common)
        rec["gadgets_s"].append(time.perf_counter() - t0)
        timings = {}
        ops.reset_launches()
        if rep == 0:
            ops.calls = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            outer = b.build(device="cuda", timings=timings)
            torch.cuda.synchronize()
        finally:
            if rep == 0:
                calls["build"], ops.calls = ops.calls, None
        rec["build_s"].append(time.perf_counter() - t0)
        rec["build_phases"].append(timings)
        build_launches = ops.launch_counts()
        pw = PartialWitness()
        rv.set_proof_with_pis_target(pw, proof_t, inner_proof)
        rv.set_verifier_data_target(pw, vk_t, inner.verifier_only)
        circuit, _, witgen_s = _witness_twice(
            outer, pw, NonRandomRng, f"GL recursive outer (build {rep})",
            failures)
        rec["witgen_s"].append(witgen_s)
    TRANSCRIPT_CELLS["gl_recursive_2e12"] = (circuit, NonRandomRng, None)

    def blob(part):
        with open(os.path.join(ROOT, OUTER_BIN.format(part)), "rb") as f:
            return f.read()

    want = ser.read_common_circuit_data(blob("common"))
    common = outer.common
    ok = {
        "degree_bits": common.degree_bits == want.degree_bits == 12,
        **_common_equal(common, want),
        "constants_sigmas_cap_and_digest": outer.verifier_only
        == ser.read_verifier_only_circuit_data(blob("verifier")),
        "public_inputs": circuit.public_inputs
        == list(inner_proof.public_inputs),
    }
    print("recursive 2^12 built by the port vs the JAX build: "
          + json.dumps(ok))
    failures.extend(f"recursive build: {k} differs from the JAX build"
                    for k, v in ok.items() if not v)
    med = {k: statistics.median(rec[k])
           for k in ("gadgets_s", "build_s", "witgen_s")}
    for k, v in med.items():
        print(f"recursive {k} {v:.4f} (median of {BUILD_REPS}: "
              f"{[round(t, 4) for t in rec[k]]})")
    phases = {k: round(statistics.median(p[k] for p in rec["build_phases"]),
                       4) for k in rec["build_phases"][0]}
    print(f"recursive build phases (s, median of {BUILD_REPS}): "
          + json.dumps(phases))
    print("recursive build launches: " + json.dumps(
        {k: v for k, v in build_launches.items() if v}))

    prover.prove(circuit, device="cuda")            # warm-up
    ops.calls = []
    try:
        prover.prove(circuit, device="cuda")
    finally:
        calls["prove"], ops.calls = ops.calls, None
    times, phases = [], []
    for _ in range(3):
        ops.reset_launches()
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = prover.prove(circuit, device="cuda", timings=timings)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        run_counts = ops.launch_counts()
        phases.append(timings)
    median_phases = {k: statistics.median(p[k] for p in phases)
                     for k in phases[0]}
    print(f"recursive prove 2^12 on cuda: median "
          f"{statistics.median(times):.4f} s of "
          f"{[round(t, 4) for t in times]}")
    print("recursive phases (s, median of 3): " + json.dumps(
        {k: round(v, 4) for k, v in median_phases.items()}))
    print("recursive launches in one prove: " + json.dumps(run_counts))
    for k in ("ntt", "permute", "leaf_sponge", "merkle_levels"):
        if run_counts.get(k, 0) <= 0:
            failures.append(f"kernel {k} was not launched by the recursive "
                            "prove")
    prof = _profile(lambda: prover.prove(circuit, device="cuda"),
                    statistics.median(times) * 1e3)
    print(f"recursive profile of one prove: device "
          f"{prof['device_ms']:.2f} ms; busy share "
          f"{prof['device_busy_share']:.4f} of the median unprofiled prove "
          f"({prof['wall_ms']:.2f} ms)")
    for k in prof["kernels"][:PROFILE_TOP]:
        print(f"  {k['ms']:10.4f} ms {k['launches']:6d} x "
              f"{k['name'][:110]}")

    outer.verify(proof)
    bad = copy.deepcopy(proof)
    wires = bad.proof.openings.wires
    wires[0] = ((wires[0][0] + 1) % common.spec.p,) + tuple(wires[0][1:])
    try:
        outer.verify(bad)
        failures.append("recursive: a tampered copy was accepted")
    except VerificationError:
        print("recursive 2^12 proof: verified; tampered copy rejected")
    mains["recursive"] = (outer, proof)
    report["recursive"] = dict(
        rec, equal=ok, prove_s=times, phases=median_phases,
        launches=run_counts, profile=prof,
        build_launches={k: v for k, v in build_launches.items() if v},
        degree_bits=common.degree_bits)
    return [("goldilocks_recursive_2e12", proof, outer.verifier_only,
             outer.common)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from plonky2_goldibear_torch import ops
    from plonky2_goldibear_torch.field import bb, gl
    from plonky2_goldibear_torch.ops import _build
    from plonky2_goldibear_torch.ops import keccak as K_kec
    from plonky2_goldibear_torch.ops import ntt as K_ntt
    from plonky2_goldibear_torch.ops import ntt_bb as K_nttb
    from plonky2_goldibear_torch.ops import poseidon2_bb as K_p2
    from plonky2_goldibear_torch.ops import poseidon_gl as K_pos
    from plonky2_goldibear_torch import circuits
    from plonky2_goldibear_torch.field import host
    from plonky2_goldibear_torch.iop.generator import NonRandomRng
    from plonky2_goldibear_torch.iop.witness import PartialWitness
    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk.builder import CircuitBuilder
    from plonky2_goldibear_torch.plonk.circuit_data import (circuit_meta,
                                                            fixture_path,
                                                            load_fixture,
                                                            read_fixture)
    from plonky2_goldibear_torch.plonk.config import CircuitConfig
    from plonky2_goldibear_torch.plonk.proof import (PROOF_PHASES,
                                                     flatten_proof)

    failures = []
    report = {}
    script_t0 = time.perf_counter()

    def phase_start(name):
        """Print and keep the script's seconds when phase ``name`` starts."""
        t = time.perf_counter() - script_t0
        report.setdefault("phase_start_s", {})[name] = t
        print(f"phase {name} starts at {t:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    card = _smi("name,power.limit")
    print(card)
    clock = _smi("clocks.max.sm").split()
    max_clock_mhz = float(clock[0]) if clock else 1980.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mul_rate = sms * INT32_OPS_PER_SM_CLK * max_clock_mhz * 1e6
    report["card"] = card
    report["int32_mul_per_s"] = mul_rate

    def larger(t_bytes, t_ops):
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def bound(nbytes, field_muls):
        return larger(nbytes / MEM_BYTES_PER_S * 1e3,
                      field_muls * MULS_PER_FIELD_MUL / mul_rate * 1e3)

    # -- phase 2: build ----------------------------------------------------
    phase_start("2")
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + json.dumps({k: round(v, 1) for k, v in secs.items()}))
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- phase 3: each kernel against its plain version ----------------------
    phase_start("3")
    g = torch.Generator().manual_seed(2024)

    def rand(*shape):
        return gl.from_ints(torch.randint(0, 1 << 62, shape, generator=g)
                            .numpy().astype(np.uint64) * 3 % gl.P, dev)

    def rand_bb(*shape):
        return bb.from_ints(torch.randint(0, bb.P, shape, generator=g)
                            .numpy().astype(np.uint64), dev)

    checks = {}

    def check(key, name, kernel_fn, plain_fn, reps, nbytes, field_muls,
              main=False, sboxes=None, int_ops=None):
        """The kernel against its plain version, timed, with its bound:
        the bytes, or the field multiplies (``int_ops``: the 32-bit
        operations) at the card's 32-bit integer rate."""
        ops.reset_launches()
        out = kernel_fn()
        torch.cuda.synchronize()
        launched = sum(ops.launch_counts().values())
        # the compared call is also the plain version's warm-up
        ref = plain_fn()
        torch.cuda.synchronize()
        mism, err = _compare(out, ref) if not isinstance(out, list) else \
            max((_compare(a, b) for a, b in zip(out, ref)),
                key=lambda t: t[0])
        ms = _cuda_ms(kernel_fn, reps)
        plain_ms = _cuda_ms(plain_fn, 1, warm_up=False)
        b_ms, b_by = bound(nbytes, field_muls) if int_ops is None else \
            larger(nbytes / MEM_BYTES_PER_S * 1e3, int_ops / mul_rate * 1e3)
        line = dict(kernel=name, mismatches=mism, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    launches_per_call=launched, bytes=nbytes,
                    field_muls=field_muls, sboxes=sboxes, int_ops=int_ops)
        print(f"check {key}: " + json.dumps(line))
        report.setdefault("checks", {})[key] = line
        if mism != 0:
            failures.append(f"{key}: {mism} mismatches")
        if main:
            checks[name] = line

    try:
        x = rand(135, 1 << 12)
        check("ntt_ifft_135x2^12", "ntt_gl", lambda: K_ntt.fft(x),
              lambda: K_ntt.fft_plain(x), 20,
              2 * x.numel() * 8, 12 * (x.numel() // 2))
        c = torch.nn.functional.pad(rand(135, 1 << 12), (0, 7 << 12))
        check("ntt_lde_135x2^15_r3", "ntt_gl", lambda: K_ntt.fft(c, 3),
              lambda: K_ntt.fft_plain(c, 3), 20,
              (135 << 12) * 8 + c.numel() * 8, 12 * (c.numel() // 2),
              main=True)
        big = rand(1, 1 << 25)
        check("ntt_1x2^25_bitrev_three_passes", "ntt_gl",
              lambda: K_ntt.fft(big), lambda: K_ntt.fft_plain(big), 3,
              2 * big.numel() * 8, 25 * (big.numel() // 2))
        st = rand(1 << 17, 12)
        check("permute_2^17", "poseidon_gl_permute",
              lambda: K_pos.permute(st), lambda: K_pos.permute_plain(st), 20,
              2 * st.numel() * 8, (1 << 17) * GL_PERM_MULS, main=True,
              sboxes=(1 << 17) * GL_PERM_SBOXES)
        rag = rand(1000, 12)
        check("permute_ragged_1000", "poseidon_gl_permute",
              lambda: K_pos.permute(rag),
              lambda: K_pos.permute_plain(rag), 20,
              2 * rag.numel() * 8, 1000 * GL_PERM_MULS,
              sboxes=1000 * GL_PERM_SBOXES)
        leaves = rand(1 << 15, 135)
        check("leaf_sponge_2^15x135", "poseidon_gl_leaf_sponge",
              lambda: K_pos.hash_leaves(leaves),
              lambda: K_pos.hash_leaves_plain(leaves), 10,
              leaves.numel() * 8 + (1 << 15) * 32,
              (1 << 15) * 17 * GL_PERM_MULS, main=True,
              sboxes=(1 << 15) * 17 * GL_PERM_SBOXES)
        d0 = rand(1 << 15, 4)
        check("merkle_levels_2^15_to_cap16", "poseidon_gl_merkle_levels",
              lambda: K_pos.merkle_levels(d0, 11),
              lambda: K_pos.merkle_levels_plain(d0, 11), 10,
              d0.numel() * 8 * 2, ((1 << 15) - 16) * GL_PERM_MULS,
              main=True, sboxes=((1 << 15) - 16) * GL_PERM_SBOXES)
    except Exception as e:       # a build or launch failure is a result too
        failures.append(f"kernel checks: {type(e).__name__}: {e}")

    # the BabyBear kernels at the shapes of the 2^12 BB proof (167 wires)
    try:
        x = rand_bb(167, 1 << 12)
        check("ntt_bb_ifft_167x2^12", "ntt_bb", lambda: K_nttb.fft(x),
              lambda: K_nttb.fft_plain(x), 20,
              2 * x.numel() * 4, 12 * (x.numel() // 2))
        c = torch.nn.functional.pad(rand_bb(167, 1 << 12), (0, 7 << 12))
        check("ntt_bb_lde_167x2^15_r3", "ntt_bb", lambda: K_nttb.fft(c, 3),
              lambda: K_nttb.fft_plain(c, 3), 20,
              (167 << 12) * 4 + c.numel() * 4, 12 * (c.numel() // 2),
              main=True)
        big = rand_bb(1, 1 << 25)
        check("ntt_bb_1x2^25_two_passes", "ntt_bb",
              lambda: K_nttb.fft(big), lambda: K_nttb.fft_plain(big), 3,
              2 * big.numel() * 4, 25 * (big.numel() // 2))
        st = rand_bb(1 << 17, 16)
        check("p2_permute_2^17", "poseidon2_bb_permute",
              lambda: K_p2.permute(st), lambda: K_p2.permute_plain(st), 20,
              2 * st.numel() * 4, (1 << 17) * BB_PERM_MULS, main=True)
        rag = rand_bb(1000, 16)
        check("p2_permute_ragged_1000", "poseidon2_bb_permute",
              lambda: K_p2.permute(rag), lambda: K_p2.permute_plain(rag),
              20, 2 * rag.numel() * 4, 1000 * BB_PERM_MULS)
        leaves = rand_bb(1 << 15, 167)
        check("p2_leaf_sponge_2^15x167", "poseidon2_bb_leaf_sponge",
              lambda: K_p2.hash_leaves(leaves),
              lambda: K_p2.hash_leaves_plain(leaves), 10,
              leaves.numel() * 4 + (1 << 15) * 32,
              (1 << 15) * 21 * BB_PERM_MULS, main=True)
        d0 = rand_bb(1 << 15, 8)
        check("p2_merkle_levels_2^15_to_cap16", "poseidon2_bb_merkle_levels",
              lambda: K_p2.merkle_levels(d0, 11),
              lambda: K_p2.merkle_levels_plain(d0, 11), 10,
              d0.numel() * 4 * 2, ((1 << 15) - 16) * BB_PERM_MULS,
              main=True)
    except Exception as e:
        failures.append(f"BabyBear kernel checks: {type(e).__name__}: {e}")

    # the Keccak kernels: rows at the rate's edges and the prove's lengths,
    # and the bound's counts of each entry point
    def rand_bytes(*shape):
        return torch.randint(0, 256, shape, generator=g,
                             dtype=torch.uint8).to(dev)

    def keccak_rows_check(key, n, length, main=False):
        rows = rand_bytes(n, length)
        blocks = (length + KECCAK_RATE) // KECCAK_RATE
        check(key, "keccak_rows", lambda: K_kec.hash_rows(rows),
              lambda: K_kec.hash_rows_plain(rows), 10,
              n * (length + KECCAK_DIGEST), 0, main=main,
              int_ops=n * blocks * KECCAK_F_OPS)

    def keccak_levels_check(key, n, layers, main=False):
        d0 = rand_bytes(n, KECCAK_DIGEST)
        parents = n - (n >> layers)
        check(key, "keccak_merkle_levels",
              lambda: K_kec.merkle_levels(d0, layers),
              lambda: K_kec.merkle_levels_plain(d0, layers), 10,
              (n + parents) * KECCAK_DIGEST, 0, main=main,
              int_ops=parents * KECCAK_F_OPS)

    def keccak_permute_check(key, n, main=False):
        st = rand(n, 12)
        # three hashes a state: a fourth only after a word >= p, about
        # 12 in 2^32 words
        check(key, "keccak_permute", lambda: K_kec.permute(st),
              lambda: K_kec.permute_plain(st), 10, 2 * st.numel() * 8, 0,
              main=main, int_ops=3 * n * KECCAK_F_OPS)

    def keccak_same(key, got, want):
        """A plan branch's output against its plain version (untimed)."""
        torch.cuda.synchronize()
        if not isinstance(got, list):
            got, want = [got], [want]
        mism = sum(_compare(a, b)[0] for a, b in zip(got, want)) + \
            abs(len(got) - len(want))
        report.setdefault("keccak_branches", {})[key] = mism
        if mism:
            failures.append(f"{key}: {mism} mismatches")

    try:
        for length in KECCAK_LENGTHS:
            keccak_rows_check(f"keccak_rows_1000x{length}", 1000, length)
        keccak_rows_check("keccak_rows_2^15x1080", 1 << 15, 1080, main=True)
        keccak_levels_check("keccak_merkle_levels_2^15_to_cap16", 1 << 15,
                            11, main=True)
        # the tail of that tree alone: its plan's subtree launch
        plan = K_kec.merkle_plan(1 << 15, 11, sms)
        print("keccak merkle plan 2^15 x 11 layers: " + json.dumps(plan))
        tail = plan[-1]
        _, width, layers = tail
        d_tail = rand_bytes(width, KECCAK_DIGEST)
        parents = width - (width >> layers)
        check(f"keccak_merkle_subtree_{width}_x{layers}",
              "keccak_merkle_subtree",
              lambda: K_kec._levels(d_tail, [tail]),
              lambda: K_kec.merkle_levels_plain(d_tail, layers), 10,
              (width + parents) * KECCAK_DIGEST, 0, main=True,
              int_ops=parents * KECCAK_F_OPS)
        keccak_permute_check("keccak_permute_2^17", KECCAK_PERMUTE_STATES,
                             main=True)
        keccak_permute_check("keccak_permute_ragged_1000", 1000)
        # every plan branch, untimed: each group size on rows (ragged n,
        # a start off an 8-byte boundary) and on a level (a start off a
        # 4-byte boundary); each subtree depth for caps 1 and 16; whole
        # trees to caps 1 and 16
        for n, length, off in ((1000, 256, 0), (1 << 11, 256, 0),
                               (1000, 137, 1)):
            raw = rand_bytes(n * length + off)
            rows = raw[off:].view(n, length)
            want = K_kec.hash_rows_plain(rows)
            for gr in K_kec.GROUPS:
                threads = K_kec.block_for(K_kec.threads_for(n, gr), sms)
                keccak_same(f"keccak_rows_{n}x{length}+{off}_g{gr}",
                            K_kec._rows(rows, KECCAK_DIGEST, gr, threads),
                            want)
        for off in (0, 3):
            raw = rand_bytes((1 << 12) * KECCAK_DIGEST + off)
            d_lvl = raw[off:].view(1 << 12, KECCAK_DIGEST)
            want = K_kec.merkle_levels_plain(d_lvl, 1)
            for gr in K_kec.GROUPS:
                step = ("level", 1 << 11, gr, K_kec.block_for(
                    K_kec.threads_for(1 << 11, gr), sms))
                keccak_same(f"keccak_level_2^11+{off}_g{gr}",
                            K_kec._levels(d_lvl, [step]), want)
        for cap in (1, 16):
            for layers in range(1, K_kec.TAIL_LAYERS + 1):
                d_sub = rand_bytes(cap << layers, KECCAK_DIGEST)
                keccak_same(f"keccak_subtree_cap{cap}_x{layers}",
                            K_kec._levels(d_sub, [("subtree", cap << layers,
                                                   layers)]),
                            K_kec.merkle_levels_plain(d_sub, layers))
        for n, layers in ((1 << 15, 15), (1 << 17, 13), (1 << 11, 11),
                          (2, 1)):
            d_tree = rand_bytes(n, KECCAK_DIGEST)
            print(f"keccak merkle plan 2^{n.bit_length() - 1} x {layers} "
                  "layers: " + json.dumps(K_kec.merkle_plan(n, layers, sms)))
            keccak_same(f"keccak_tree_2^{n.bit_length() - 1}_x{layers}",
                        K_kec.merkle_levels(d_tree, layers),
                        K_kec.merkle_levels_plain(d_tree, layers))
        print("keccak plan branches, mismatches: "
              + json.dumps(report.get("keccak_branches")))
    except Exception as e:
        failures.append(f"Keccak kernel checks: {type(e).__name__}: {e}")

    # every path kernel at each shape one 2^12 prove of its field launches
    # it on, recorded from that prove, and the GL Merkle trees of other caps
    def prove_shape_check(call):
        counter, *shape = call
        name, key = KERNEL_OF[counter], _shape_key(call)
        if counter == "keccak_rows":
            return keccak_rows_check(key, *shape)
        if counter == "keccak_merkle_levels":
            return keccak_levels_check(key, *shape)
        if counter == "keccak_permute":
            return keccak_permute_check(key, *shape)
        is_gl = not (counter.startswith("p2_") or counter == "ntt_bb")
        make, es = (rand, 8) if is_gl else (rand_bb, 4)
        if counter in ("ntt", "ntt_bb"):
            b, n, r = shape
            K = K_ntt if is_gl else K_nttb
            print(f"{counter} plan {b} x 2^{n.bit_length() - 1} r {r}: "
                  + json.dumps(K_nttb.plan(b, n.bit_length() - 1, sms, r,
                                           gl if is_gl else bb)._asdict()))
            x = make(b, n)
            x[:, n >> r:] = 0
            check(key, name, lambda: K.fft(x, r), lambda: K.fft_plain(x, r),
                  20, (b * (n >> r) + b * n) * es,
                  (n.bit_length() - 1 - r) * (b * n // 2))
            return
        K = K_pos if is_gl else K_p2
        perm_muls = GL_PERM_MULS if is_gl else BB_PERM_MULS
        if counter in ("permute", "p2_permute"):
            (n,) = shape
            st = make(n, K.WIDTH)
            perms, nbytes = n, 2 * st.numel() * es
            kernel, plain = (lambda: K.permute(st),
                             lambda: K.permute_plain(st))
        elif counter in ("leaf_sponge", "p2_leaf_sponge"):
            n, length, num_out = shape
            leaves = make(n, length)
            perms = n * -(-length // K.RATE)
            nbytes = (leaves.numel() + n * num_out) * es
            kernel, plain = (lambda: K.hash_leaves(leaves, num_out),
                             lambda: K.hash_leaves_plain(leaves, num_out))
            if not is_gl:
                # every group size, beside the planned one
                print(f"p2_leaf_sponge plan {n} x {length}: "
                      + json.dumps(K.sponge_plan(n, sms)))
                for g in K.SPONGE_GROUPS:
                    check(f"{_shape_key(call)}_g{g}", name,
                          lambda: K._sponge(leaves, num_out, g,
                                            K.block_for(n * g, sms)),
                          plain, 10, nbytes, perms * perm_muls)
        else:
            n, layers = shape
            d0 = make(n, K.NUM_HASH_OUT)
            perms = n - (n >> layers)
            nbytes = (n + perms) * K.NUM_HASH_OUT * es
            kernel, plain = (lambda: K.merkle_levels(d0, layers),
                             lambda: K.merkle_levels_plain(d0, layers))
            print(f"{'' if is_gl else 'p2_'}merkle plan 2^{n.bit_length() - 1}"
                  f" x {layers} layers: "
                  + json.dumps(K.merkle_plan(n, layers, sms)))
        check(key, name, kernel, plain, 10,
              nbytes, perms * perm_muls,
              sboxes=perms * GL_PERM_SBOXES if is_gl else None)

    def chain(field, bits):
        """(builder, x, seconds): the arithmetic chain of 2^bits rows added
        to the port's builder by its gadgets, not yet built."""
        spec = host.GOLDILOCKS if field == "goldilocks" else host.BABYBEAR
        b = CircuitBuilder(getattr(CircuitConfig, PRESETS[field])(), spec)
        t0 = time.perf_counter()
        x = circuits.arith_chain(b, bits)
        return b, x, time.perf_counter() - t0

    prove_calls, build_calls = {}, {}
    try:
        for field in ("goldilocks", "babybear"):
            circuit, _ = load_fixture(MAIN_BITS, device="cuda", field=field)
            ops.calls = []
            try:
                prover.prove(circuit, device="cuda")
            finally:
                prove_calls[field], ops.calls = ops.calls, None
            b, _, _ = chain(field, MAIN_BITS)
            ops.calls = []
            try:
                b.build(device="cuda")
            finally:
                build_calls[field], ops.calls = ops.calls, None
        report["prove_calls"] = prove_calls
        report["build_calls"] = build_calls
        print("build calls: " + json.dumps(build_calls))
        shapes = {tuple(c) for calls in (*prove_calls.values(),
                                         *build_calls.values())
                  for c in calls if c[0] not in TRANSCRIPT_COUNTERS}
        shapes |= {("merkle_levels", n, layers) for n, layers in EXTRA_TREES}
        shapes |= set(EXTRA_BB_CALLS)
        for call in sorted(shapes):
            prove_shape_check(call)
            report["checks"][_shape_key(call)]["call"] = list(call)
        # every NTT call of a prove or build is one launch (rows up to 2^15)
        for key, c in report["checks"].items():
            call = c.get("call")
            if call and call[0] in ("ntt", "ntt_bb") and call[2] <= 1 << 15 \
                    and c["launches_per_call"] != 1:
                failures.append(f"{key}: {c['launches_per_call']} launches "
                                "for one NTT call")
    except Exception as e:
        failures.append(f"prove-shape checks: {type(e).__name__}: {e}")

    # -- phase 3b: the probe chains ------------------------------------------
    phase_start("3b")
    from plonky2_goldibear_torch import probes as runner
    from plonky2_goldibear_torch.ops import probes as K_probe

    probe_checks, probe_recs, probe_counts = {}, {}, {}
    probe_rate = {}

    def probe_bound(key, c):
        """Add the probe bound to the check ``c`` (the card-filling rates
        of ``probe_rate``) and print it."""
        if c.get("int_ops") is not None:
            t_ops = c["int_ops"] / probe_rate["add"]
        elif "bb" in c["kernel"]:
            t_ops = c["field_muls"] * MULS_PER_FIELD_MUL / probe_rate["mul"]
        elif c["sboxes"] is not None:
            t_ops = c["sboxes"] / probe_rate["sbox"]
        else:
            t_ops = c["field_muls"] / probe_rate["gl"]
        c["probe_bound_ms"], c["probe_bound_by"] = larger(
            c["bytes"] / MEM_BYTES_PER_S * 1e3, t_ops * 1e3)
        print(f"probe bound {key}: " + json.dumps(
            {k: c[k] for k in ("kernel", "ms", "bound_ms",
                               "probe_bound_ms", "probe_bound_by")}))
    try:
        for step, (ops_per_rep, per_sm_clk, library) in PROBES.items():
            section = next(k for k, v in runner.SECTIONS.items()
                           if v[0] == step)
            _, n_script, reps, _ = runner.SECTIONS[section]
            # a ragged size, one pass of the unrolled loop and a remainder
            x = runner.make_input(step, 1000, dev, seed=3)
            r = K_probe.unroll(step) + 5
            results = [_compare_probe(K_probe.chain(x, step, r),
                                      K_probe.chain_plain(x, step, r))]
            # the runner's two sizes at the script's reps; the card-filling
            # call is the timed one, its output the compared one
            sz = runner.sizes(dev, n_script)
            xs = runner.make_input(step, sz["script"], dev)
            results.append(_compare_probe(K_probe.chain(xs, step, reps),
                                          K_probe.chain_plain(xs, step, reps)))
            xf = runner.make_input(step, sz["fill"], dev)
            out, ms = _timed(lambda: K_probe.chain(xf, step, reps), 20)
            ref, plain_ms = _timed(
                lambda: K_probe.chain_plain(xf, step, reps), 1)
            results.append(_compare_probe(out, ref))
            library_ms = None
            if library is not None:
                lib, library_ms = _timed(lambda: library(xf, reps), 20)
                results.append(_compare_probe(lib, ref))
            mism = sum(m for m, _ in results)
            err = max(e for _, e in results)
            rate = sms * per_sm_clk * max_clock_mhz * 1e6
            b_ms, b_by = larger(
                2 * xf.numel() * xf.element_size() / MEM_BYTES_PER_S * 1e3,
                xf.numel() * reps * ops_per_rep / rate * 1e3)
            line = dict(kernel="probe_" + step, section=section,
                        replaces=runner.SECTIONS[section][3].split()[0],
                        mismatches=mism, max_abs_err=err, n=xf.numel(),
                        reps=reps, ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
            print(f"check probe_{step}: " + json.dumps(line))
            report.setdefault("checks", {})["probe_" + step] = line
            probe_checks[step] = line
            if mism != 0:
                failures.append(f"probe {step}: {mism} mismatches "
                                "(kernel, plain version or library call)")
        # the probe runner, every chain section, launches counted
        ops.reset_launches()
        for section in runner.SECTIONS:
            probe_recs[section] = runner.run_section(section, dev)
            print("probe " + json.dumps(probe_recs[section]))
        probe_counts = ops.launch_counts()
        report["probes"] = probe_recs
        failures.extend(f"probe {step} was not launched by the probe runner"
                        for step in PROBES
                        if probe_counts["probe_" + step] <= 0)
        # the probe bound of every phase-3 check, from the card-filling rates
        probe_rate.update({s: probe_recs[s]["fill"]["G_ops_per_s"] * 1e9
                           for s in ("gl", "sbox", "mul")})
        # the add chain's step is half a three-input add: its instructions
        probe_rate["add"] = probe_recs["add"]["fill"]["G_ops_per_s"] * 1e9 \
            * PROBES["u32_add"][0]
        for key, c in report["checks"].items():
            if not c["kernel"].startswith("probe_"):
                probe_bound(key, c)
    except Exception as e:
        failures.append(f"probe phase: {type(e).__name__}: {e}")

    # -- phase 4: the main path of each field ------------------------------
    phase_start("4")
    def load(field, bits):
        t0 = time.perf_counter()
        circuit, arrays = load_fixture(bits, device="cuda", field=field)
        torch.cuda.synchronize()
        print(f"load_circuit {field} 2^{bits} (commits constants/sigmas): "
              f"{time.perf_counter() - t0:.3f} s")
        if not np.array_equal(
                np.asarray(circuit.constants_sigmas_cap(), dtype=np.uint64),
                arrays["constants_sigmas_cap"]):
            failures.append(f"{field} 2^{bits}: constants_sigmas_cap "
                            "differs from the JAX cap")
        return circuit, arrays

    def check_proof(field, bits, proof, arrays):
        flat = flatten_proof(proof)
        ok = {k: bool(np.array_equal(flat[k], arrays["proof_" + k]))
              for k in PROOF_PHASES}
        print(f"{field} 2^{bits} proof vs JAX proof: " + json.dumps(ok))
        report[f"{field}_proof_2e{bits}_equal"] = ok
        failures.extend(f"{field} 2^{bits}: proof phase {k} differs from "
                        "the JAX proof" for k, v in ok.items() if not v)

    def check_retry(field, bits, label, prove_fn):
        """``prove_fn(counter)`` proves with its first attempts made to
        fail, the random wire redrawn from the nonrandom counter the JAX
        retry recorded; the redrawn values and the proof against the JAX
        retry's."""
        with np.load(fixture_path(bits, field, retry=True)) as z:
            arrays = {k: z[k] for k in z.files}
        want = [int(v) for v in arrays["values"]]
        real, seen = prover._internal_prove, []

        def internal_prove(circuit_, wires, timings, rng):
            row, col = circuit_.random_wire
            seen.append(int(circuit_.F.to_ints(wires[col, row:row + 1])[0]))
            if len(seen) <= len(want):
                raise prover.InvZeroPermArg()
            return real(circuit_, wires, timings, rng)

        prover._internal_prove = internal_prove
        try:
            proof = prove_fn(int(arrays["counter"]))
        finally:
            prover._internal_prove = real
        print(f"{field} 2^{bits} {label} retry: redrawn {seen[1:]}, "
              f"JAX {want}")
        report[f"{field}_{label}_retry_2e{bits}_values"] = seen[1:]
        if seen[1:] != want:
            failures.append(f"{field} 2^{bits} {label} retry: redrawn "
                            f"{seen[1:]}, the JAX retry {want}")
        check_proof(field, f"{bits}_{label}_retry", proof, arrays)
        return proof

    def built(field, bits, reps=1):
        """Build the chain of 2^bits rows on the card ``reps`` times (the
        gadgets and ``build`` timed apart, the kernels' launches counted
        over the build) and generate the witness of x = 3 from
        NonRandomRng(1) after each (timed); hold the last build and
        witness against the fixture: (data, pw, circuit with its witness,
        fixture arrays)."""
        arrays, meta = read_fixture(fixture_path(bits, field))
        with np.load(fixture_path(SMALL_BITS, field, retry=True)) as z:
            # one random wire per public-input gate wire past the hash, at
            # any size: the counter the JAX retry fixture recorded
            counter = int(z["counter"])
        rec = {"gadgets_s": [], "build_s": [], "build_phases": [],
               "witgen_s": []}
        for _ in range(reps):
            b, x, gadgets_s = chain(field, bits)
            timings = {}
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data = b.build(device="cuda", timings=timings)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            launches = ops.launch_counts()
            pw = PartialWitness()
            pw.set_target(x, 3)
            circuit, rng, witgen_s = _witness_twice(
                data, pw, NonRandomRng, f"{field} 2^{bits} chain", failures)
            rec["witgen_s"].append(witgen_s)
            rec["gadgets_s"].append(gadgets_s)
            rec["build_s"].append(build_s)
            rec["build_phases"].append(timings)
        ok = {
            "constants_sigmas": bool(np.array_equal(
                data.F.to_ints(data.prover_only.constants_sigmas_values),
                arrays["constants_sigmas"])),
            "constants_sigmas_cap": bool(np.array_equal(
                np.asarray(data.verifier_only.constants_sigmas_cap,
                           dtype=np.uint64), arrays["constants_sigmas_cap"])),
            "circuit_digest": data.verifier_only.circuit_digest
            == meta["circuit_digest"],
            "meta": circuit_meta(data, field) == dict(meta, field=field),
            "wires": bool(np.array_equal(data.F.to_ints(circuit.wires),
                                         arrays["wires"])),
            "public_inputs": circuit.public_inputs
            == [int(v) for v in arrays["public_inputs"]],
            "counter": rng.counter == counter,
        }
        print(f"{field} 2^{bits} built by the port vs the JAX fixture: "
              + json.dumps(ok))
        failures.extend(f"{field} 2^{bits} build: {k} differs from the "
                        "JAX fixture's" for k, v in ok.items() if not v)
        rec["launches"] = {k: v for k, v in launches.items() if v}
        rec["equal"] = ok
        med = {k: statistics.median(rec[k])
               for k in ("gadgets_s", "build_s", "witgen_s")}
        phases = {k: statistics.median(p[k] for p in rec["build_phases"])
                  for k in rec["build_phases"][0]}
        for k in ("gadgets_s", "build_s", "witgen_s"):
            print(f"{field} 2^{bits} {k} {med[k]:.4f} (median of {reps}: "
                  f"{[round(t, 4) for t in rec[k]]})")
        print(f"{field} 2^{bits} build phases (s, median of {reps}): "
              + json.dumps({k: round(v, 4) for k, v in phases.items()}))
        print(f"{field} 2^{bits} build launches: "
              + json.dumps(rec["launches"]))
        report[f"{field}_build_2e{bits}"] = rec
        return data, pw, circuit, arrays

    # the counters of each path's kernels
    path_kernels = {
        "goldilocks": ("ntt", "permute", "leaf_sponge", "merkle_levels"),
        "babybear": ("ntt_bb", "p2_permute", "p2_leaf_sponge",
                     "p2_merkle_levels"),
    }
    # the kernels of the constants/sigmas commit of a build
    build_kernels = {"goldilocks": ("ntt", "leaf_sponge", "merkle_levels"),
                     "babybear": ("ntt_bb", "p2_leaf_sponge",
                                  "p2_merkle_levels")}
    counts = {}
    # every proof made on the card, for phase 5: (label, proof, verifier
    # data, common data)
    made = []
    # each field's 2^12 chain and its proof, the inner of phase 6
    mains = {}
    for field, counters in path_kernels.items():
        try:
            # the port's own circuit at 2^6, and its retry through
            # CircuitData.prove: the counter goes on from witness generation
            data, pw, circuit, arrays = built(field, SMALL_BITS)
            proof = prover.prove(circuit, device="cuda")
            check_proof(field, f"{SMALL_BITS}_built", proof, arrays)
            retry = check_retry(field, SMALL_BITS, "built",
                                lambda _: data.prove(pw, rng=NonRandomRng(1)))
            made += [(f"{field}_2e{SMALL_BITS}_built", proof,
                      data.verifier_only, data.common),
                     (f"{field}_2e{SMALL_BITS}_built_retry", retry,
                      data.verifier_only, data.common)]
            # the circuit carried across as data, and its retry
            circuit, arrays = load(field, SMALL_BITS)
            proof = prover.prove(circuit, device="cuda")
            check_proof(field, SMALL_BITS, proof, arrays)
            retry = check_retry(field, SMALL_BITS, "loaded",
                                lambda counter: prover.prove(
                                    circuit, device="cuda",
                                    rng=NonRandomRng(counter)))
            made += [(f"{field}_2e{SMALL_BITS}_loaded", proof,
                      circuit.verifier_data(), circuit.common),
                     (f"{field}_2e{SMALL_BITS}_loaded_retry", retry,
                      circuit.verifier_data(), circuit.common)]
            # the main path at the benchmark size: build, witness, warm-up,
            # 3 timed proves of the finished circuit
            data, pw, circuit, arrays = built(field, MAIN_BITS,
                                              reps=BUILD_REPS)
            TRANSCRIPT_CELLS[{"goldilocks": "gl", "babybear": "bb"}[field]
                             + "_chain_2e12"] = (circuit, NonRandomRng,
                                                 arrays)
            for k in build_kernels[field]:
                if report[f"{field}_build_2e{MAIN_BITS}"]["launches"].get(
                        k, 0) <= 0:
                    failures.append(f"kernel {k} was not launched by the "
                                    f"{field} build")
            prover.prove(circuit, device="cuda")
            times, phases = [], []
            for _ in range(3):
                ops.reset_launches()
                timings = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                proof = prover.prove(circuit, device="cuda", timings=timings)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                run_counts = ops.launch_counts()
                phases.append(timings)
            check_proof(field, MAIN_BITS, proof, arrays)
            made.append((f"{field}_2e{MAIN_BITS}", proof, data.verifier_only,
                         data.common))
            mains[field] = (data, proof)
            # one whole CircuitData.prove: witness generation and prove
            whole = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proof = data.prove(pw, rng=NonRandomRng(1), timings=whole)
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
            check_proof(field, f"{MAIN_BITS}_whole", proof, arrays)
            made.append((f"{field}_2e{MAIN_BITS}_whole", proof,
                         data.verifier_only, data.common))
            print(f"{field} whole data.prove(pw) 2^{MAIN_BITS}: "
                  f"{whole_s:.4f} s, of it witness generation "
                  f"{whole['witness_generation']:.4f} s")
            median_phases = {k: statistics.median(p[k] for p in phases)
                             for k in phases[0]}
            print(f"{field} prove 2^{MAIN_BITS} on cuda: median "
                  f"{statistics.median(times):.4f} s of "
                  f"{[round(t, 4) for t in times]}")
            print(f"{field} phases (s, median of 3): " + json.dumps(
                {k: round(v, 4) for k, v in median_phases.items()}))
            print(f"{field} launches in one prove: " + json.dumps(run_counts))
            report[field] = dict(prove_s=times, phases=median_phases,
                                 launches=run_counts, whole_prove_s=whole_s,
                                 whole_phases=whole)
            # one more warm prove under the profiler
            prof = _profile(lambda: prover.prove(circuit, device="cuda"),
                            statistics.median(times) * 1e3)
            report[field]["profile"] = prof
            print(f"{field} profile of one prove: device "
                  f"{prof['device_ms']:.2f} ms; busy share "
                  f"{prof['device_busy_share']:.4f} of the median "
                  f"unprofiled prove ({prof['wall_ms']:.2f} ms), "
                  f"{prof['device_busy_share_of_profiled_wall']:.4f} of the "
                  f"profiled one ({prof['profiled_wall_ms']:.2f} ms)")
            for k in prof["kernels"][:PROFILE_TOP]:
                print(f"  {k['ms']:10.4f} ms {k['launches']:6d} x "
                      f"{k['name'][:110]}")
            for k in counters:
                counts[k] = run_counts[k]
                if run_counts[k] <= 0:
                    failures.append(f"kernel {k} was not launched by the "
                                    f"{field} prove")
        except Exception as e:
            failures.append(f"{field} main path: {type(e).__name__}: {e}")

    checked = {tuple(c) for calls in (*prove_calls.values(),
                                      *build_calls.values()) for c in calls}

    def check_new_shapes(new_calls, label):
        """Every kernel at each shape of ``new_calls`` (label -> recorded
        calls) not checked yet, with its probe bound."""
        report[f"{label}_calls"] = new_calls
        print(f"{label} calls: " + json.dumps(
            {k: sorted(set(map(tuple, v))) for k, v in new_calls.items()}))
        for call in sorted({tuple(c) for calls in new_calls.values()
                            for c in calls
                            if c[0] not in TRANSCRIPT_COUNTERS} - checked):
            prove_shape_check(call)
            key = _shape_key(call)
            report["checks"][key]["call"] = list(call)
            if probe_rate:
                probe_bound(key, report["checks"][key])
            checked.add(call)

    # -- phase 6: the recursive verifier over the GL 2^12 chain -------------
    phase_start("6")
    recursive_calls = {}
    try:
        if "goldilocks" not in mains:
            raise RuntimeError("no GL 2^12 chain proof from phase 4")
        inner, inner_proof = mains["goldilocks"]
        made += phase_recursion(inner, inner_proof, report, failures,
                                recursive_calls, mains)
        check_new_shapes(recursive_calls, "recursive")
    except Exception as e:
        failures.append(f"recursion phase: {type(e).__name__}: {e}")

    # -- phase 7: zero knowledge and lookups ---------------------------------
    phase_start("7")
    zk_calls = {}
    try:
        phase_zk_lookups(report, failures, zk_calls, made)
    except Exception as e:
        failures.append(f"zk and lookups phase: {type(e).__name__}: {e}")
    try:
        check_new_shapes(zk_calls, "zk_lookup")
    except Exception as e:
        failures.append(f"zk and lookup shape checks: {type(e).__name__}: "
                        f"{e}")

    # -- phase 8: BabyBear recursion, the width-24 hash, BB lookups ----------
    phase_start("8")
    bb_calls = {}
    try:
        if "babybear" not in mains:
            raise RuntimeError("no BB 2^12 chain proof from phase 4")
        inner, inner_proof = mains["babybear"]
        phase_bb_recursion(inner, inner_proof, report, failures, bb_calls,
                           made)
    except Exception as e:
        failures.append(f"BB recursion phase: {type(e).__name__}: {e}")
    try:
        check_new_shapes(bb_calls, "bb_recursive")
        big = [k for k, c in report["checks"].items()
               if c.get("call") and c["call"][0] == "ntt_bb"
               and c["call"][2] > 1 << 15]
        print("BB NTT calls above 2^15 rows, checked: " + json.dumps(big))
    except Exception as e:
        failures.append(f"BB recursion shape checks: {type(e).__name__}: "
                        f"{e}")

    # -- phase 9: the Keccak config ------------------------------------------
    phase_start("9")
    keccak_calls = {}
    try:
        if "recursive" not in mains:
            raise RuntimeError("no GL recursive proof from phase 6")
        inner, inner_proof = mains["recursive"]
        keccak_launches = phase_keccak(inner, inner_proof, report, failures,
                                       keccak_calls, made)
        counts.update({k: keccak_launches[k] for k in KECCAK_COUNTERS})
    except Exception as e:
        failures.append(f"Keccak phase: {type(e).__name__}: {e}")
    try:
        check_new_shapes(keccak_calls, "keccak")
    except Exception as e:
        failures.append(f"Keccak shape checks: {type(e).__name__}: {e}")

    # -- phase 10: AddManyGate, conditional and cyclic recursion ------------
    phase_start("10")
    cyclic_calls = {}
    try:
        if "recursive" not in mains:
            raise RuntimeError("no GL recursive proof from phase 6")
        inner, inner_proof = mains["recursive"]
        phase_cyclic(inner, inner_proof, report, failures, cyclic_calls, made)
    except Exception as e:
        failures.append(f"cyclic recursion phase: {type(e).__name__}: {e}")
    try:
        check_new_shapes(cyclic_calls, "cyclic")
    except Exception as e:
        failures.append(f"cyclic recursion shape checks: {type(e).__name__}: "
                        f"{e}")

    # -- phase 11: the device-transcript prover ------------------------------
    phase_start("11")
    transcript_kernels = []
    try:
        per_state = {
            f: report["checks"][key].get(
                "probe_bound_ms", report["checks"][key]["bound_ms"])
            / (1 << 17)
            for f, key in (("goldilocks", "permute_2^17"),
                           ("babybear", "p2_permute_2^17"))}
        transcript_kernels = phase_transcript(report, failures, made,
                                              per_state)
    except Exception as e:
        failures.append(f"device-transcript phase: {type(e).__name__}: {e}")

    # -- phase 5: the verifier, on the host ----------------------------------
    phase_start("5")
    try:
        verify_s = phase_verify(made, failures)
        report["verify_s"] = verify_s
        print("verify_s (host s, median of 3): " + json.dumps(
            {k: round(v["median"], 4) for k, v in verify_s.items()}))
    except Exception as e:
        failures.append(f"verify phase: {type(e).__name__}: {e}")

    # the rule-2 order: each kernel's excess in one 2^12 prove, the sum
    # over its recorded calls of (ms - probe bound) at the call's shape,
    # with the same against the data-sheet bound beside it
    ranking = []
    for name, (_, _, counter) in SOURCES.items():
        lines = [report.get("checks", {}).get(_shape_key(c))
                 for calls in prove_calls.values() for c in calls
                 if c[0] == counter]
        if not lines or not all(x and "probe_bound_ms" in x for x in lines):
            continue
        ms = sum(x["ms"] for x in lines)
        ranking.append({
            "kernel": name, "launches": counts.get(counter, 0),
            "calls": len(lines), "ms": ms,
            "probe_bound_ms": sum(x["probe_bound_ms"] for x in lines),
            "bound_ms": sum(x["bound_ms"] for x in lines),
            "excess_ms": sum(x["ms"] - x["probe_bound_ms"] for x in lines),
            "excess_over_data_sheet_ms": sum(x["ms"] - x["bound_ms"]
                                             for x in lines)})
    ranking.sort(key=lambda r: -r["excess_ms"])
    report["ranking"] = ranking
    print("rule-2 ranking: " + json.dumps(ranking))
    # every witnessed circuit: recorded once, replayed after
    report["witness"] = WITNESS
    print("witness record/replay: " + json.dumps(
        {k: {n: (round(v, 4) if isinstance(v, float) else v)
             for n, v in r.items() if n != "equal"}
         for k, r in WITNESS.items()}))
    phase_start("end")

    os.makedirs(os.path.join(ROOT, OUT_DIR), exist_ok=True)
    with open(os.path.join(ROOT, OUT_DIR, "chip_smoke_report.json"),
              "w") as f:
        json.dump(dict(report, failures=failures), f, indent=1)
    if failures:
        for msg in failures:
            print("FAIL " + msg, file=sys.stderr)
        return 1

    kernels = []
    for name, (src, replaces, counter) in SOURCES.items():
        c = checks[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[counter],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None})
    for step in PROBES:
        c = probe_checks[step]
        kernels.append({
            "name": "probe_" + step, "route": "cuda",
            "source": "plonky2_goldibear_torch/csrc/probes.cu",
            "replaces": c["replaces"],
            "launches": probe_counts["probe_" + step],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    kernels += transcript_kernels
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
