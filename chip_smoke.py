"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of plonky2_goldibear_torch/csrc with nvcc (one
   nvcc per source, all at once);
3. holds each kernel against its plain torch version on the card, bit for
   bit, at the shapes of a 2^12-row proof of each field (Goldilocks: NTT,
   Poseidon permutation, leaf sponge, Merkle levels; BabyBear: NTT,
   Poseidon2 permutation, leaf sponge, Merkle levels), with CUDA-event
   times;
4. for each field (Goldilocks under standard_recursion_config_gl, then
   BabyBear under standard_recursion_config_bb), loads the committed
   arithmetic-chain fixtures (circuit and witness as data) through
   ``load_fixture`` and proves them on the card with ``prove``: the 2^6
   one, then the 2^12 one (that field's main path), timed over 3 warm
   proves, with every kernel's launches counted over one prove (the counts
   are set to 0 just before it).  Each proof must equal the fixture's
   stored JAX proof field by field.

It prints a JSON line of per-kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
when there is no CUDA device, when the package is missing, or when any
phase fails.  A detailed report goes to chip_smoke_out/chip_smoke_report.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT32_MUL_PER_SM_CLK = 64     # 32-bit IMAD per SM per clock, compute 9.0
MULS_PER_FIELD_MUL = 4        # GL 64x64 -> 128 from four 32x32 products;
                              # BB Montgomery: 32x32 -> 64 (two), m, m p
OUT_DIR = "chip_smoke_out"    # the report, listed in .gitignore
MAIN_BITS = 12                # the benchmark circuit: 2^12 rows
SMALL_BITS = 6                # a second fixture: every level in the tail
GL_PERM_MULS = 8 * 12 * 4 + 22 * 4            # field muls per permutation
BB_PERM_MULS = 8 * 16 * 4 + 13 * (4 + 16 + 15)


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _compare(a, b):
    """(mismatches, max |a - b|) of two field tensors as canonical u64
    values (a BabyBear tensor is int32, a Goldilocks one int64)."""
    import numpy as np
    import torch

    from plonky2_goldibear_torch.field import bb, gl

    F = bb if a.dtype == torch.int32 else gl
    x, y = F.to_ints(a), F.to_ints(b)
    if x.shape != y.shape:
        return -1, float("inf")
    bad = x != y
    if not bad.any():
        return 0, 0.0
    diff = np.where(x > y, x - y, y - x)
    return int(bad.sum()), float(diff.max())


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
    from plonky2_goldibear_torch.ops import ntt as K_ntt
    from plonky2_goldibear_torch.ops import ntt_bb as K_nttb
    from plonky2_goldibear_torch.ops import poseidon2_bb as K_p2
    from plonky2_goldibear_torch.ops import poseidon_gl as K_pos
    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk.circuit_data import load_fixture
    from plonky2_goldibear_torch.plonk.proof import (PROOF_PHASES,
                                                     flatten_proof)

    failures = []
    report = {}
    dev = torch.device("cuda", 0)
    card = _smi("name,power.limit")
    print(card)
    clock = _smi("clocks.max.sm").split()
    max_clock_mhz = float(clock[0]) if clock else 1980.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mul_rate = sms * INT32_MUL_PER_SM_CLK * max_clock_mhz * 1e6
    report["card"] = card
    report["int32_mul_per_s"] = mul_rate

    def bound(nbytes, field_muls):
        t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        t_ops = field_muls * MULS_PER_FIELD_MUL / mul_rate * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    # -- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + json.dumps({k: round(v, 1) for k, v in secs.items()}))
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- phase 3: each kernel against its plain version ----------------------
    g = torch.Generator().manual_seed(2024)

    def rand(*shape):
        return gl.from_ints(torch.randint(0, 1 << 62, shape, generator=g)
                            .numpy().astype(np.uint64) * 3 % gl.P, dev)

    def rand_bb(*shape):
        return bb.from_ints(torch.randint(0, bb.P, shape, generator=g)
                            .numpy().astype(np.uint64), dev)

    checks = {}

    def check(key, name, kernel_fn, plain_fn, reps, nbytes, field_muls,
              main=False):
        ops.reset_launches()
        out = kernel_fn()
        torch.cuda.synchronize()
        launched = sum(ops.launch_counts().values())
        ref = plain_fn()
        mism, err = _compare(out, ref) if not isinstance(out, list) else \
            max((_compare(a, b) for a, b in zip(out, ref)),
                key=lambda t: t[0])
        ms = _cuda_ms(kernel_fn, reps)
        plain_ms = _cuda_ms(plain_fn, 1)
        b_ms, b_by = bound(nbytes, field_muls)
        line = dict(kernel=name, mismatches=mism, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    launches_per_call=launched)
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
        check("ntt_1x2^25_three_passes", "ntt_gl", lambda: K_ntt.fft(big),
              lambda: K_ntt.fft_plain(big), 3,
              2 * big.numel() * 8, 25 * (big.numel() // 2))
        st = rand(1 << 17, 12)
        check("permute_2^17", "poseidon_gl_permute",
              lambda: K_pos.permute(st), lambda: K_pos.permute_plain(st), 20,
              2 * st.numel() * 8, (1 << 17) * GL_PERM_MULS, main=True)
        rag = rand(1000, 12)
        check("permute_ragged_1000", "poseidon_gl_permute",
              lambda: K_pos.permute(rag),
              lambda: K_pos.permute_plain(rag), 20,
              2 * rag.numel() * 8, 1000 * GL_PERM_MULS)
        leaves = rand(1 << 15, 135)
        check("leaf_sponge_2^15x135", "poseidon_gl_leaf_sponge",
              lambda: K_pos.hash_leaves(leaves),
              lambda: K_pos.hash_leaves_plain(leaves), 10,
              leaves.numel() * 8 + (1 << 15) * 32,
              (1 << 15) * 17 * GL_PERM_MULS, main=True)
        d0 = rand(1 << 15, 4)
        check("merkle_levels_2^15_to_cap16", "poseidon_gl_merkle_levels",
              lambda: K_pos.merkle_levels(d0, 11),
              lambda: K_pos.merkle_levels_plain(d0, 11), 10,
              d0.numel() * 8 * 2, ((1 << 15) - 16) * GL_PERM_MULS,
              main=True)
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

    # -- phase 4: the main path of each field ------------------------------
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

    # the counters of each path's kernels
    path_kernels = {
        "goldilocks": ("ntt", "permute", "leaf_sponge", "merkle_levels"),
        "babybear": ("ntt_bb", "p2_permute", "p2_leaf_sponge",
                     "p2_merkle_levels"),
    }
    counts = {}
    for field, counters in path_kernels.items():
        try:
            circuit, arrays = load(field, SMALL_BITS)
            check_proof(field, SMALL_BITS,
                        prover.prove(circuit, device="cuda"), arrays)
            # the main path at the benchmark size: warm-up, 3 timed proves
            circuit, arrays = load(field, MAIN_BITS)
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
            median_phases = {k: statistics.median(p[k] for p in phases)
                             for k in phases[0]}
            print(f"{field} prove 2^{MAIN_BITS} on cuda: median "
                  f"{statistics.median(times):.4f} s of "
                  f"{[round(t, 4) for t in times]}")
            print(f"{field} phases (s, median of 3): " + json.dumps(
                {k: round(v, 4) for k, v in median_phases.items()}))
            print(f"{field} launches in one prove: " + json.dumps(run_counts))
            report[field] = dict(prove_s=times, phases=median_phases,
                                 launches=run_counts)
            for k in counters:
                counts[k] = run_counts[k]
                if run_counts[k] <= 0:
                    failures.append(f"kernel {k} was not launched by the "
                                    f"{field} prove")
        except Exception as e:
            failures.append(f"{field} main path: {type(e).__name__}: {e}")

    os.makedirs(os.path.join(ROOT, OUT_DIR), exist_ok=True)
    with open(os.path.join(ROOT, OUT_DIR, "chip_smoke_report.json"),
              "w") as f:
        json.dump(dict(report, failures=failures), f, indent=1)
    if failures:
        for msg in failures:
            print("FAIL " + msg, file=sys.stderr)
        return 1

    sources = {
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
    }
    kernels = []
    for name, (src, replaces, counter) in sources.items():
        c = checks[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[counter],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
