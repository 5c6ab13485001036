"""Device times of one tree's kernels at the shapes of a prove, to hold
two trees' kernels against each other on one card: the NTT, the
Poseidon-GL leaf sponge and Merkle levels (Goldilocks), the NTT, the
Poseidon2 permutation, leaf sponge and Merkle levels (BabyBear), the
device transcript's step and PoW grind (both fields), and the Keccak rows,
Merkle levels and hash-onion (the Keccak config).

    python plonky2_goldibear_torch/kernel_times.py --root DIR \\
        --report chip_smoke_out/chip_smoke_report.json [--out FILE]
    python plonky2_goldibear_torch/kernel_times.py --root DIR --keccak \
        [--graphs]

``--keccak`` times the Keccak kernels alone, at the shapes of one Keccak
outer build and prove (KECCAK_SHAPES, no report needed), each with its
launches a call, and the eleven Keccak calls of one Keccak outer prove
back to back (``keccak_prove``): any tree whose ``ops.keccak`` has
``hash_rows(rows, out_bytes)``, ``merkle_levels(d0, num_layers)`` and
``permute(states)`` with their plain versions and a ``launches`` dict.

It imports ``plonky2_goldibear_torch`` from DIR, a checkout of any tree
whose port has ``ops.ntt.fft(x, zero_prefix_log)``,
``ops.poseidon_gl.hash_leaves(inputs, num_outputs)`` and
``merkle_levels(d0, num_layers)``, ``ops.ntt_bb.fft(x, zero_prefix_log)``
and ``ops.poseidon2_bb.permute(states)``, ``hash_leaves(inputs,
num_outputs)`` and ``merkle_levels(d0, num_layers)``, with their plain
versions, and ``ops.transcript``.  The shapes are those that
``chip_smoke.py`` checked these kernels at, read from its report: every
call of one 2^12 prove of the kernel's field, and the extra shapes it
checks (trees of other caps, the BabyBear NTT's single rows), and EXTRA:
both NTTs at one row of 2^25 and the Poseidon2 permutation at 2^17
states; and the transcript steps and the grind of those proves (the
report's ``prove_calls``: each step's absorbed length, the outputs left
and the challenges; the grind's leftover length and bound), on random
inputs.  For each shape it prints the ms per call
(CUDA events over 10 calls after a warm-up, median of 5 trials; the
wrapper's host time included, as in ``chip_smoke.py``; with ``--graphs``
device time instead: the 10 calls captured as one CUDA graph and
replayed) and whether the output equals the tree's plain version.  One
JSON line; card only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

KINDS = ("ntt", "leaf_sponge", "merkle_levels", "ntt_bb", "p2_permute",
         "p2_leaf_sponge", "p2_merkle_levels")
EXTRA = (("ntt", 1, 1 << 25, 0), ("ntt_bb", 1, 1 << 25, 0),
         ("p2_permute", 1 << 17))
# a Keccak outer's kernel calls (chip_smoke.py phase 9): the prove's leaves
# (2^15 rows of 1080, 160, 128 bytes), the build's (680), the FRI layers'
# (2^11, 2^7 of 256), its trees to a cap of 16 and the grind's hash-onion
KECCAK_SHAPES = (("keccak_rows", 1 << 15, 1080), ("keccak_rows", 1 << 15, 680),
                 ("keccak_rows", 1 << 15, 160), ("keccak_rows", 1 << 15, 128),
                 ("keccak_rows", 1 << 11, 256), ("keccak_rows", 1 << 7, 256),
                 ("keccak_merkle_levels", 1 << 15, 11),
                 ("keccak_merkle_levels", 1 << 11, 7),
                 ("keccak_merkle_levels", 1 << 7, 3),
                 ("keccak_permute", 1 << 17))
# the Keccak calls of one Keccak outer prove, in its order (chip_smoke.py
# report, ``keccak_calls``): leaves and tree of each of its three
# commitments, the FRI layers', then the grind
KECCAK_PROVE = (("keccak_rows", 1 << 15, 1080), ("keccak_merkle_levels",
                                                  1 << 15, 11),
                ("keccak_rows", 1 << 15, 160), ("keccak_merkle_levels",
                                                 1 << 15, 11),
                ("keccak_rows", 1 << 15, 128), ("keccak_merkle_levels",
                                                 1 << 15, 11),
                ("keccak_rows", 1 << 11, 256), ("keccak_merkle_levels",
                                                 1 << 11, 7),
                ("keccak_rows", 1 << 7, 256), ("keccak_merkle_levels",
                                               1 << 7, 3),
                ("keccak_permute", 1 << 17))
TRANSCRIPT_KINDS = ("transcript_flush", "pow_grind")
CALLS_PER_TRIAL = 10
TRIALS = 5
P = 0xFFFFFFFF00000001          # the Goldilocks prime
P_BB = 0x78000001               # the BabyBear prime


def shapes_of(report: dict):
    """The (kind, *shape) of every check of a kernel of KINDS in the
    report's prove-shape phase, in the order checked."""
    return [tuple(c["call"]) for c in report["checks"].values()
            if c.get("call") and c["call"][0] in KINDS] + list(EXTRA)


def transcript_shapes(report: dict):
    """The distinct transcript-kernel calls of the report's proves, as
    (kind, width, *shape) in the order made."""
    out = []
    for calls in report.get("prove_calls", {}).values():
        for c in calls:
            if c[0] in TRANSCRIPT_KINDS and tuple(c) not in out:
                out.append(tuple(c))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="the tree whose plonky2_goldibear_torch is timed")
    ap.add_argument("--report", default=None,
                    help="a chip_smoke.py report holding the shapes")
    ap.add_argument("--keccak", action="store_true",
                    help="the Keccak kernels alone, at KECCAK_SHAPES")
    ap.add_argument("--graphs", action="store_true",
                    help="device time: the calls replayed as a CUDA graph")
    ap.add_argument("--out", default=None, help="also write the line here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path[0:1] = [root]       # not this file's directory
    from plonky2_goldibear_torch.field import bb
    from plonky2_goldibear_torch.ops import ntt as NG
    from plonky2_goldibear_torch.ops import ntt_bb as NB
    from plonky2_goldibear_torch.ops import poseidon2_bb as K2
    from plonky2_goldibear_torch.ops import keccak as KK
    from plonky2_goldibear_torch.ops import poseidon_gl as K
    from plonky2_goldibear_torch.ops import transcript as TR

    if args.keccak:
        shapes = list(KECCAK_SHAPES) + [("keccak_prove",)]
    elif args.report:
        with open(args.report) as f:
            report = json.load(f)
        shapes = shapes_of(report) + transcript_shapes(report)
    else:
        ap.error("give --report, or --keccak")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)

    def rand(*shape):
        return torch.from_numpy(rng.integers(0, P, size=shape, dtype=np.uint64)
                                .view(np.int64)).to(dev)

    def rand_bb(*shape):
        return bb.from_ints(rng.integers(0, P_BB, size=shape,
                                         dtype=np.uint64), dev)

    def ms(fn):
        fn()
        torch.cuda.synchronize(dev)
        if args.graphs:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(CALLS_PER_TRIAL):
                    fn()
            fn = graph.replay
        trials = []
        for _ in range(TRIALS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(1 if args.graphs else CALLS_PER_TRIAL):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            trials.append(start.elapsed_time(end) / CALLS_PER_TRIAL)
        return statistics.median(trials)

    def rand_bytes(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape,
                                             dtype=np.uint8)).to(dev)

    def keccak_call(kind, *shape):
        """(fn, its output equals the plain version's) of one Keccak call"""
        if kind == "keccak_rows":
            x = rand_bytes(*shape)
            fn = lambda: KK.hash_rows(x)                    # noqa: E731
            return fn, torch.equal(fn(), KK.hash_rows_plain(x))
        if kind == "keccak_merkle_levels":
            n, layers = shape
            x = rand_bytes(n, 25)
            fn = lambda: KK.merkle_levels(x, layers)        # noqa: E731
            return fn, all(torch.equal(a, b) for a, b in zip(
                fn(), KK.merkle_levels_plain(x, layers)))
        x = rand(shape[0], 12)
        fn = lambda: KK.permute(x)                          # noqa: E731
        return fn, torch.equal(fn(), KK.permute_plain(x))

    times = []
    for kind, *shape in shapes:
        if kind == "keccak_prove":
            fns, eqs = zip(*(keccak_call(*c) for c in KECCAK_PROVE))
            fn = lambda: [f() for f in fns]                 # noqa: E731
            equal = all(eqs)
        elif kind.startswith("keccak"):
            fn, equal = keccak_call(kind, *shape)
        elif kind in ("leaf_sponge", "p2_leaf_sponge"):
            n, length, num_out = shape
            M = K if kind == "leaf_sponge" else K2
            x = rand(n, length) if M is K else rand_bb(n, length)
            fn = lambda: M.hash_leaves(x, num_out)          # noqa: E731
            equal = torch.equal(fn(), M.hash_leaves_plain(x, num_out))
        elif kind in ("ntt", "ntt_bb"):
            batch, n, r = shape
            M = NG if kind == "ntt" else NB
            x = rand(batch, n) if M is NG else rand_bb(batch, n)
            x[:, n >> r:] = 0
            fn = lambda: M.fft(x, r)                        # noqa: E731
            equal = torch.equal(fn(), M.fft_plain(x, r))
        elif kind == "transcript_flush":
            width, total, n_out, n = shape
            make = rand if width == 12 else rand_bb
            state, out_buf, piece = make(width), make(8), make(total)
            fn = lambda: TR.transcript_flush(                # noqa: E731
                state, out_buf, [piece], n_out, n)
            equal = torch.equal(fn(), TR.transcript_flush_plain(
                state, out_buf, [piece], n_out, n))
        elif kind == "pow_grind":
            width, L, k = shape
            make = rand if width == 12 else rand_bb
            state, left = make(width), make(L) if L else None
            fn = lambda: TR.pow_grind(state, left, k)[0]     # noqa: E731
            equal = torch.equal(fn(), TR.pow_grind_plain(state, left, k))
        elif kind == "p2_permute":
            (n,) = shape
            x = rand_bb(n, 16)
            fn = lambda: K2.permute(x)                      # noqa: E731
            equal = torch.equal(fn(), K2.permute_plain(x))
        else:
            n, layers = shape
            M = K if kind == "merkle_levels" else K2
            x = rand(n, 4) if kind == "merkle_levels" else rand_bb(n, 8)
            fn = lambda: M.merkle_levels(x, layers)         # noqa: E731
            equal = all(torch.equal(a, b) for a, b in zip(
                fn(), M.merkle_levels_plain(x, layers)))
        before = sum(KK.launches.values())
        fn()
        launched = sum(KK.launches.values()) - before
        times.append({"call": [kind, *shape], "ms": ms(fn), "equal": equal,
                      **({"launches": launched} if kind.startswith("keccak")
                         else {})})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    line = json.dumps({"root": root, "card": card, "graphs": args.graphs,
                       "times": times})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if all(t["equal"] for t in times) else 1


if __name__ == "__main__":
    sys.exit(main())
