"""The probe runner: the card's measured rate for one field or integer
operation, from a long dependent chain of it (``ops/probes.py``).

    python -m plonky2_goldibear_torch.probes [section ...] [--device cpu]
    python -m plonky2_goldibear_torch.probes sass [--sass-lib PATH ...]
    python -m plonky2_goldibear_torch.probes poseidon2_groups ntt_bb_clusters \
        ntt_gl_clusters

Sections, named after the TPU probe scripts' own, and the script function
each one replaces:

==============  ==================  =========================================
section         chain step          replaces (``scripts/``)
==============  ==================  =========================================
``gl``          ``gl_mul``          ``profile_poseidon.py:101`` ``bench_mulchain``,
                                    ``profile2.py:156`` ``sec_mul``,
                                    ``hwprobe3.py:80`` ``probe_gl``
``sbox``        ``gl_sbox``         ``hwprobe3.py:111`` ``probe_sbox``,
                                    ``profile_poseidon.py:133`` ``bench_sboxchain``
``sqr``         ``gl_sqr``          ``profile_sbox2.py:58`` ``bench(kp._sqr)``
``serial_x7``   ``gl_sbox_serial``  ``profile_sbox2.py:58`` ``bench(_sbox_serial)``
``classic_x7``  ``gl_sbox``         ``profile_sbox2.py:58`` ``bench(kp._sbox)``
``mul``         ``u32_mul``         ``hwprobe3.py:49`` ``probe_u32`` (mul)
``mul16``       ``u32_mul16``       ``hwprobe3.py:49`` ``probe_u32`` (mul16)
``add``         ``u32_add``         ``hwprobe3.py:49`` ``probe_u32`` (add)
``fma``         ``f32_fma``         ``hwprobe3.py:49`` ``probe_u32`` (fma)
``s8``          ``torch._int_mm``   ``hwprobe3.py:141`` ``probe_mxu_s8``
``bf16``        ``torch.matmul``    ``hwprobe3.py:163`` ``probe_mxu_bf16``
==============  ==================  =========================================

Each chain is timed at two sizes: the script's own element count, and a
card-filling one (SMs x 2048 threads x 4), since a dependent chain reads
latency, not throughput, until enough warps are resident.  The time of
one rep is the marginal (t(2r) - t(r)) / r over single launches timed with
CUDA events, the median of 5, with r doubled from the script's reps until
a launch takes at least 2 ms.  ``s8`` and ``bf16`` time one plain matrix
product of the script's shapes (no kernel of the port).  Each section
prints one JSON line: G ops/s and ns per op per thread at each size, the
latter the time one thread spends on one rep: the time of a rep times the
share of the elements resident at once (SMs x 2048 threads).

``sass`` disassembles the built ``probes``, ``poseidon_gl`` and
``poseidon2_bb`` libraries (``cuobjdump -sass``) and prints, per chain,
the instructions of one step in the main loop (its body over the steps it
holds), and per Poseidon or Poseidon2 kernel its instruction count and,
where its rounds are loops, one thread's instructions through the rounds
of a permutation, split by opcode (``per_permutation``), for this tree's
build and any library given with ``--sass-lib`` (another tree's build);
and per Keccak kernel (``keccak``) its instructions a Keccak-f, the round
loop's 24 trips (``rounds``).

``poseidon_groups``, ``poseidon2_groups``, ``ntt_bb_clusters`` and
``ntt_gl_clusters`` (card only) time the launch geometries the wrappers
choose between, as CUDA-graph replays (device time without the wrappers'
host time): every group size per Merkle level width, the tail per depth
and the leaf sponge per shape of a prove (Poseidon-GL, Poseidon2-BB; the
Poseidon2-BB sponge also without its row loads), and every cluster size
of each field's NTT at each NTT shape of its prove.  ``keccak_groups``
(card only, as they do) times the Keccak rows and one Merkle level at
each group size, the subtree launch at each depth, and the Keccak outer's
trees at each depth of subtree tail.

Runs on the card unless ``--device cpu`` is given (plain torch versions,
host clock, cut sizes: a rehearsal, not a device measurement); without a
card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from .device import resolve
from .field import gl
from .ops import probes as K

# section -> (step, the script's element count, the script's reps, replaces)
SECTIONS = {
    "gl": ("gl_mul", 1 << 16, 64,
           "scripts/profile_poseidon.py:101 bench_mulchain; "
           "scripts/profile2.py:156 sec_mul; scripts/hwprobe3.py:80 probe_gl"),
    "sbox": ("gl_sbox", 1 << 17, 128,
             "scripts/hwprobe3.py:111 probe_sbox; "
             "scripts/profile_poseidon.py:133 bench_sboxchain"),
    "sqr": ("gl_sqr", 1 << 16, 64, "scripts/profile_sbox2.py:58 bench(_sqr)"),
    "serial_x7": ("gl_sbox_serial", 1 << 16, 64,
                  "scripts/profile_sbox2.py:58 bench(_sbox_serial)"),
    "classic_x7": ("gl_sbox", 1 << 16, 64,
                   "scripts/profile_sbox2.py:58 bench(_sbox)"),
    "mul": ("u32_mul", 1 << 17, 512, "scripts/hwprobe3.py:49 probe_u32 mul"),
    "mul16": ("u32_mul16", 1 << 17, 512,
              "scripts/hwprobe3.py:49 probe_u32 mul16"),
    "add": ("u32_add", 1 << 17, 1024, "scripts/hwprobe3.py:49 probe_u32 add"),
    "fma": ("f32_fma", 1 << 17, 512, "scripts/hwprobe3.py:49 probe_u32 fma"),
}
MATMULS = {"s8": "scripts/hwprobe3.py:141 probe_mxu_s8",
           "bf16": "scripts/hwprobe3.py:163 probe_mxu_bf16"}
# the leaf sponges of a GL 2^12 prove (wires, Z and partial products,
# quotient, the two FRI layers), Merkle levels of 2^14 ... 2^4 parents
GROUP_SHAPES = {"sponge": ((1 << 15, 135), (1 << 15, 20), (1 << 15, 16),
                           (1 << 11, 32), (1 << 7, 32)),
                "levels": range(14, 3, -1), "tail_cap": 16}
# the BabyBear trees of a 2^12 prove (2^15, 2^12, 2^9, 2^6 leaves to a cap
# of 16), and its NTT calls (batch, log2 n, zero prefix) with the single
# rows the prover sent before it batched them
BB_TREES = ((1 << 15, 11), (1 << 12, 8), (1 << 9, 5), (1 << 6, 2))
BB_LEVELS = range(17, 3, -1)       # Merkle levels of 2^17 ... 2^4 parents
BB_SUBTREES = (16, 256)            # subtrees a subtree launch folds
BB_NTT_SHAPES = ((167, 12, 0), (167, 15, 3), (36, 12, 0), (36, 15, 3),
                 (6, 15, 0), (48, 15, 3), (4, 15, 0), (4, 12, 0), (4, 9, 0),
                 (4, 6, 0), (1, 15, 0), (1, 12, 0))
# the NTT calls of a Goldilocks 2^12 prove (batch, log2 n, zero prefix)
GL_NTT_SHAPES = ((135, 12, 0), (135, 15, 3), (20, 12, 0), (20, 15, 3),
                 (2, 15, 0), (16, 15, 3), (2, 11, 0), (2, 7, 0), (1, 15, 0))
# the BabyBear leaf sponges of a 2^12 prove: wires, Z and partial products,
# quotient, the three FRI layers (leaves, leaf length)
BB_SPONGES = ((1 << 15, 167), (1 << 15, 36), (1 << 15, 48), (1 << 12, 32),
              (1 << 9, 32), (1 << 6, 32))
# the Keccak outer's rows (leaves, their bytes: the prove's 2^15 leaves,
# the build's, the FRI layers), its Merkle levels' widths (2^14 ... 2^4
# parents) and its trees (leaves, layers to a cap of 16)
KECCAK_ROWS = ((1 << 15, 1080), (1 << 15, 680), (1 << 15, 160),
               (1 << 15, 128), (1 << 11, 256), (1 << 7, 256))
KECCAK_LEVELS = range(14, 3, -1)
KECCAK_TREES = ((1 << 15, 11), (1 << 11, 7), (1 << 7, 3))
MIN_LAUNCH_S = 2e-3        # r doubles until one launch takes this long
MAX_REPS = 1 << 24
TRIALS = 5


def make_input(step: str, n: int, device, seed: int = 0) -> torch.Tensor:
    """The scripts' inputs: GL elements uniform in [0, p), u32 in
    [1, 2^31), f32 in [0.75, 1.25)."""
    rng = np.random.default_rng(seed)
    dtype = K.STEPS[step][0]
    if dtype == torch.int64:
        return gl.from_ints(rng.integers(0, gl.P, size=n, dtype=np.uint64),
                            device)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(1, 1 << 31, size=n,
                                             dtype=np.int32)).to(device)
    return torch.from_numpy(rng.random(n, dtype=np.float32) * 0.5
                            + 0.75).to(device)


def seconds(fn: Callable[[], object], device: torch.device) -> float:
    """Seconds of one call of fn: CUDA events on the card, the host clock
    on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def marginal(fn: Callable[[int], object], reps: int, device: torch.device,
             min_s: float = MIN_LAUNCH_S) -> Dict[str, float]:
    """Seconds per rep of fn(reps): (t(2r) - t(r)) / r, median of TRIALS,
    r doubled from ``reps`` until one call takes ``min_s``."""
    r = max(1, reps)
    fn(r)                                       # build, warm up
    while seconds(lambda: fn(r), device) < min_s and r < MAX_REPS:
        r *= 2
    per_rep = []
    for _ in range(TRIALS):
        t1 = seconds(lambda: fn(r), device)
        t2 = seconds(lambda: fn(2 * r), device)
        per_rep.append((t2 - t1) / r if t2 > t1 else t2 / (2 * r))
    return {"reps": r, "s_per_rep": statistics.median(per_rep)}


def resident(device: torch.device) -> int:
    """Threads the card holds at once (the CPU: 1, it runs one chain at a
    time)."""
    if device.type != "cuda":
        return 1
    prop = torch.cuda.get_device_properties(device)
    return prop.multi_processor_count * prop.max_threads_per_multi_processor


def sizes(device: torch.device, n_script: int) -> Dict[str, int]:
    """The script's element count and a card-filling one; on the CPU both
    cut (a rehearsal of the control flow)."""
    if device.type == "cuda":
        return {"script": n_script, "fill": 4 * resident(device)}
    return {"script": n_script >> 6, "fill": 4096}


def card_name(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index}"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or torch.cuda.get_device_name(device)


def run_section(section: str, device=None) -> Dict:
    """Time one section at both sizes; returns its JSON record."""
    dev = resolve(device)
    if section in MATMULS:
        return run_matmul(section, dev)
    step, n_script, reps, replaces = SECTIONS[section]
    min_s = MIN_LAUNCH_S if dev.type == "cuda" else 0.02
    rec = {"section": section, "step": step, "replaces": replaces,
           "device": dev.type, "card": card_name(dev),
           "route": "cuda" if dev.type == "cuda" else "plain"}
    for label, n in sizes(dev, n_script).items():
        x = make_input(step, n, dev)
        m = marginal(lambda r: K.chain(x, step, r), reps, dev, min_s)
        rec[label] = {"n": n, "reps": m["reps"],
                      "G_ops_per_s": n / m["s_per_rep"] / 1e9,
                      "ns_per_op_per_thread": m["s_per_rep"] * 1e9
                      * min(n, resident(dev)) / n}
    return rec


def _graph_ms(fn: Callable[[], object], dev: torch.device) -> float:
    """Device ms per call of fn: 10 calls replayed as one CUDA graph (the
    wrapper's host time left out), median of TRIALS."""
    fn()                           # build, load the constants
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(10):
            fn()
    return statistics.median(seconds(graph.replay, dev)
                             for _ in range(TRIALS)) * 100


def _needs_card(dev: torch.device, section: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{section} times the kernels' launch geometry: "
                         "it needs the card")


def run_groups(dev: torch.device) -> Dict:
    """Section ``poseidon_groups`` (card only): device ms per launch of the
    Poseidon-GL sponge and Merkle kernels at each group size (threads per
    state): the leaf sponge at each shape of GROUP_SHAPES["sponge"], one
    Merkle level of 2^k parents for each k of GROUP_SHAPES["levels"], and
    the tail from a cap of 16 for 1 to TAIL_MAX_LAYERS layers.  The data the wrappers' geometry rules
    (ops/poseidon_gl.py) are chosen from."""
    from .ops import poseidon_gl as P

    _needs_card(dev, "poseidon_groups")
    ms = lambda fn: _graph_ms(fn, dev)                  # noqa: E731

    rng = np.random.default_rng(0)
    rand = lambda *shape: gl.from_ints(                 # noqa: E731
        rng.integers(0, gl.P, size=shape, dtype=np.uint64), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec = {"section": "poseidon_groups", "device": dev.type,
           "card": card_name(dev), "sponge": {}, "levels": {}, "tail": {}}
    for n, length in GROUP_SHAPES["sponge"]:
        leaves = rand(n, length)
        rec["sponge"][f"{n}x{length}"] = {
            g: ms(lambda: P._sponge(leaves, 4, g)) for g in P.GROUPS}
    for k in GROUP_SHAPES["levels"]:
        parents = 1 << k
        d = rand(2 * parents, 4)
        rec["levels"][parents] = {
            g: ms(lambda: P._levels(d, [
                ("level", parents, g, P.block_for(parents * P.SPAN[g], sms))]))
            for g in P.GROUPS}
    cap = GROUP_SHAPES["tail_cap"]
    for layers in range(1, P.TAIL_MAX_LAYERS + 1):
        d = rand(cap << layers, 4)
        rec["tail"][layers] = ms(lambda: P._levels(d, [
            ("tail", cap << layers, layers, cap, 16 << (layers - 1))]))
    return rec


def run_poseidon2_groups(dev: torch.device) -> Dict:
    """Section ``poseidon2_groups`` (card only): device ms per launch of the
    Poseidon2-BB Merkle kernels: one level of 2^k parents at each group
    size (threads per state) for each k of BB_LEVELS, a subtree launch of 1
    to SUBTREE_MAX_LAYERS levels folding 16 (the tail to a cap of 16) or
    256 subtrees, and each tree of BB_TREES as ``merkle_plan`` launches it.
    The data the geometry rules of ops/poseidon2_bb.py are chosen from."""
    from .field import bb
    from .ops import poseidon2_bb as P

    _needs_card(dev, "poseidon2_groups")
    rng = np.random.default_rng(0)
    rand = lambda *shape: bb.from_ints(                 # noqa: E731
        rng.integers(0, bb.P, size=shape, dtype=np.uint64), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec = {"section": "poseidon2_groups", "device": dev.type,
           "card": card_name(dev), "levels": {}, "subtree": {},
           "trees": {}}
    for k in BB_LEVELS:
        parents = 1 << k
        d = rand(2 * parents, 8)
        rec["levels"][parents] = {
            g: _graph_ms(lambda: P._levels(d, [
                ("level", parents, g, P.block_for(parents * g, sms))]), dev)
            for g in P.GROUPS}
    for subtrees in BB_SUBTREES:
        rec["subtree"][subtrees] = {}
        for layers in range(1, P.SUBTREE_MAX_LAYERS + 1):
            width = subtrees << layers
            d = rand(width, 8)
            rec["subtree"][subtrees][layers] = _graph_ms(
                lambda: P._levels(d, [("subtree", width, layers, subtrees,
                                       P.SUBTREE_GROUP << (layers - 1))]),
                dev)
    for n, layers in BB_TREES:
        d = rand(n, 8)
        rec["trees"][f"{n}x{layers}"] = {
            "plan": P.merkle_plan(n, layers, sms),
            "ms": _graph_ms(lambda: P.merkle_levels(d, layers), dev)}
    # the leaf sponge at each group size, and at the planned one without
    # its row loads
    rec["sponge"], rec["sponge_noload"] = {}, {}
    for n, length in BB_SPONGES:
        leaves = rand(n, length)
        key = f"{n}x{length}"
        rec["sponge"][key] = {
            g: _graph_ms(lambda: P._sponge(leaves, 8, g, P.block_for(
                n * g, sms)), dev) for g in P.SPONGE_GROUPS}
        g, threads = P.sponge_plan(n, sms)
        rec["sponge"][key]["plan"] = g
        rec["sponge_noload"][key] = _graph_ms(
            lambda: P._sponge(leaves, 8, g, threads, loads=False), dev)
    return rec


def run_keccak_groups(dev: torch.device) -> Dict:
    """Section ``keccak_groups`` (card only): device ms per launch of the
    Keccak kernels at each group size (threads a state): rows at each
    shape of KECCAK_ROWS, one Merkle level of 2^k parents for each k of
    KECCAK_LEVELS, a subtree launch of each depth for caps of 16 and 1,
    and each tree of KECCAK_TREES with each depth of subtree tail (0: a
    launch a level), the planned one marked.  The data the plans of
    ops/keccak.py are chosen from (device time only: the tail's gain is
    the launches' host time, which ``kernel_times.py`` includes)."""
    from .ops import keccak as K

    _needs_card(dev, "keccak_groups")
    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randint(               # noqa: E731
        0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ms = lambda fn: _graph_ms(fn, dev)                  # noqa: E731
    rec = {"section": "keccak_groups", "device": dev.type,
           "card": card_name(dev), "rows": {}, "levels": {}, "subtree": {},
           "trees": {}}
    for n, length in KECCAK_ROWS:
        rows = rand(n, length)
        rec["rows"][f"{n}x{length}"] = {
            g: ms(lambda: K._rows(rows, K.DIGEST, g, K.block_for(
                K.threads_for(n, g), sms))) for g in K.GROUPS}
        rec["rows"][f"{n}x{length}"]["plan"] = K.launch_plan(n, sms)
    for k in KECCAK_LEVELS:
        parents = 1 << k
        d = rand(2 * parents, K.DIGEST)
        rec["levels"][parents] = {
            g: ms(lambda: K._levels(d, [("level", parents, g, K.block_for(
                K.threads_for(parents, g), sms))])) for g in K.GROUPS}
    for cap in (16, 1):
        rec["subtree"][cap] = {}
        for layers in range(1, K.TAIL_LAYERS + 1):
            d = rand(cap << layers, K.DIGEST)
            rec["subtree"][cap][layers] = ms(lambda: K._levels(
                d, [("subtree", cap << layers, layers)]))
    for n, layers in KECCAK_TREES:
        d = rand(n, K.DIGEST)
        rec["trees"][f"{n}x{layers}"] = {
            "plan": K.merkle_plan(n, layers, sms), "tails": {}}
        for t in range(min(layers, K.TAIL_LAYERS) + 1):
            plan = [("level", n >> j, *K.launch_plan(n >> j, sms))
                    for j in range(1, layers - t + 1)]
            plan += [("subtree", n >> (layers - t), t)] if t else []
            rec["trees"][f"{n}x{layers}"]["tails"][t] = ms(
                lambda: K._levels(d, plan))
    return rec


def _ntt_clusters(dev: torch.device, section: str, F, shapes) -> Dict:
    """Device ms of the NTT of field module F at each (batch, log2 n, zero
    prefix) of ``shapes`` for every cluster size the row allows, and the
    one ``ops/ntt_bb.py:plan`` picks: the data behind the plan."""
    from .ops import ntt_bb as N

    _needs_card(dev, section)
    rng = np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec = {"section": section, "device": dev.type, "card": card_name(dev),
           "shapes": {}}
    for batch, n_log, r in shapes:
        x = rng.integers(0, F.P, size=(batch, 1 << n_log), dtype=np.uint64)
        x[:, (1 << n_log) >> r:] = 0
        x = F.from_ints(x, dev)
        plans = {c: N.cluster_plan(batch, n_log, c, sms, r, F)
                 for c in N.cluster_logs(n_log, r, F)}
        rec["shapes"][f"{batch}x2^{n_log}_r{r}"] = {
            "plan": N.plan(batch, n_log, sms, r, F).c_log,
            "active_clusters": {c: N.active_clusters(p, F)
                                for c, p in plans.items()},
            "ms": {c: _graph_ms(lambda: N._launch(x, r, p, F), dev)
                   for c, p in plans.items()}}
    return rec


def run_ntt_bb_clusters(dev: torch.device) -> Dict:
    """Section ``ntt_bb_clusters`` (card only): the BabyBear NTT at each
    shape of BB_NTT_SHAPES (``_ntt_clusters``)."""
    from .field import bb

    return _ntt_clusters(dev, "ntt_bb_clusters", bb, BB_NTT_SHAPES)


def run_ntt_gl_clusters(dev: torch.device) -> Dict:
    """Section ``ntt_gl_clusters`` (card only): the Goldilocks NTT at each
    shape of GL_NTT_SHAPES (``_ntt_clusters``)."""
    return _ntt_clusters(dev, "ntt_gl_clusters", gl, GL_NTT_SHAPES)


def run_matmul(section: str, dev: torch.device) -> Dict:
    """One (m, k) x (k, n) product of the script's shapes, median of 5."""
    m, k, n = (1024, 1024, 2048) if dev.type == "cuda" else (128, 128, 256)
    g = torch.Generator().manual_seed(0)
    if section == "s8":
        a = torch.randint(-100, 100, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-100, 100, (k, n), generator=g, dtype=torch.int8)
        a, b = a.to(dev), b.to(dev)
        fn = lambda: torch._int_mm(a, b)          # noqa: E731
    else:
        a = torch.rand((m, k), generator=g).to(dev, torch.bfloat16)
        b = torch.rand((k, n), generator=g).to(dev, torch.bfloat16)
        fn = lambda: torch.matmul(a, b)           # noqa: E731
    fn()
    t = statistics.median(seconds(fn, dev) for _ in range(TRIALS))
    return {"section": section, "replaces": MATMULS[section],
            "device": dev.type, "card": card_name(dev),
            "route": "library", "shape": [m, k, n], "ms": t * 1e3,
            "T_macs_per_s": m * k * n / t / 1e12}


# -- SASS ---------------------------------------------------------------------

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_STRUCTS = {"gl_mul": "GlMul", "gl_sqr": "GlSqr", "gl_sbox": "GlSbox",
            "gl_sbox_serial": "GlSboxSerial", "u32_mul": "U32Mul",
            "u32_mul16": "U32Mul16", "u32_add": "U32Add", "f32_fma": "F32Fma"}


def parse_sass(text: str) -> Dict[str, List]:
    """cuobjdump -sass output -> {function: [(address, instruction)]}."""
    funcs: Dict[str, List] = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _INSN.search(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def _opcode(insn: str) -> str:
    words = insn.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def loops(code: List) -> List[List]:
    """The bodies of the backward branches, largest first: instructions
    from the branch target to the branch."""
    out = []
    for addr, insn in code:
        m = re.search(r"\bBRA\s+(?:`?\(?)(0x[0-9a-f]+)", insn)
        if m and int(m.group(1), 16) <= addr:
            lo = int(m.group(1), 16)
            out.append([(a, i) for a, i in code if lo <= a <= addr])
    return sorted(out, key=len, reverse=True)


def _histogram(code: List) -> Dict[str, int]:
    hist: Dict[str, int] = {}
    for _, insn in code:
        op = _opcode(insn)
        hist[op] = hist.get(op, 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: -kv[1]))


def _cuobjdump(path: str) -> str:
    from .ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout


_SPLIT = ("IMAD.WIDE", "IMAD", "IADD3", "ISETP", "SEL", "LOP3", "SHF",
          "SHFL", "IMNMX", "LDC")
# full, partial, full rounds of a library's permutation loops
ROUND_TRIPS = {"poseidon_gl": (4, 22, 4), "poseidon2_bb": (4, 13, 4)}


def _split(insn: str) -> str:
    """The Poseidon report's opcode class: IMAD.WIDE apart from IMAD, the
    rest by opcode, everything else as "other"."""
    words = insn.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    op = words[0] if words else ""
    if op.startswith("IMAD.WIDE"):
        return "IMAD.WIDE"
    op = op.split(".")[0]
    return op if op in _SPLIT else "other"


def per_permutation(code: List, trips=ROUND_TRIPS["poseidon_gl"]) -> Dict:
    """One thread's instructions through the rounds of a Poseidon-GL or
    Poseidon2-BB kernel, from its SASS: the three innermost loops of 100
    or more instructions, in address order, are the round loops (full,
    partial, full rounds: ``trips``, 4, 22, 4 for Poseidon-GL, 4, 13, 4 for
    Poseidon2-BB), each counted times its trips, and every other
    instruction outside them once (loads, stores, set-up; in a sponge the
    absorb's loads).  None where the kernel has not that shape (a group's
    unrolled rounds)."""
    inner = [b for b in loops(code) if len(b) >= 100 and not any(
        o is not b and len(o) < len(b) and o[0][0] >= b[0][0]
        and o[-1][0] <= b[-1][0] for o in loops(code))]
    if len(inner) != 3:
        return None
    inner.sort(key=lambda b: b[0][0])
    in_loop = {a for b in inner for a, _ in b}
    split = {k: 0 for k in _SPLIT + ("other",)}
    for _, insn in code:
        split[_split(insn)] += 1
    total = len(code)
    for body, n in zip(inner, trips):
        total += (n - 1) * len(body)
        for _, insn in body:
            split[_split(insn)] += n - 1
    return {"instructions": total, "round_loops": [len(b) for b in inner],
            "straight": len(code) - len(in_loop), "split": split}


def _library_of(path: str) -> str:
    """The source library a built library's name says it is."""
    return "poseidon2_bb" if "poseidon2_bb" in os.path.basename(path) \
        else "poseidon_gl"


def keccak_rounds(code: List) -> Dict:
    """One thread's instructions a Keccak-f in a Keccak kernel, from its
    SASS: the round loop (24 trips) is the innermost loop that touches no
    global memory with the most three-input logic ops (LOP3: theta's
    parities and chi), not the block, store or byte-load loops."""
    every = loops(code)
    innermost = [b for b in every if not any(
        o is not b and len(o) < len(b) and o[0][0] >= b[0][0]
        and o[-1][0] <= b[-1][0] for o in every) and not any(
            _opcode(i) in ("LDG", "STG") for _, i in b)]
    rounds = max(innermost, default=None, key=lambda b: sum(
        _opcode(i) == "LOP3" for _, i in b))
    if rounds is None:
        return None
    return {"round_loop": len(rounds), "per_keccak_f": 24 * len(rounds),
            "opcodes": _histogram(rounds)}


def keccak_group_of(func: str) -> int:
    """Threads a state of a Keccak kernel, from its mangled name (the rows
    and level kernels' first template argument; the subtree kernel's is
    25, the hash-onion's 1)."""
    m = re.search(r"(?:rows|level)_kernel\w*?ILi(\d+)E", func)
    if m:
        return int(m.group(1))
    return 25 if "subtree_kernel" in func else 1


def sass_counts(dump_dir: str = None, libs: List[str] = None) -> Dict:
    """Instruction counts of the chain steps, the Poseidon-GL and
    Poseidon2-BB kernels and the Keccak kernels' rounds from the built
    libraries' SASS; the listings go to dump_dir if given.  ``libs`` adds
    other built Poseidon-GL or Poseidon2-BB libraries (another tree's; the
    file name says which)."""
    from .ops import _build

    _build.build_all(("probes", "poseidon_gl", "poseidon2_bb", "keccak"))
    paths = {"probes": _build._lib_path("probes"),
             "poseidon_gl": _build._lib_path("poseidon_gl"),
             "poseidon2_bb": _build._lib_path("poseidon2_bb"),
             "keccak": _build._lib_path("keccak")}
    for path in libs or ():
        paths[path] = path
    out = {"chains": {}}
    for name, path in paths.items():
        text = _cuobjdump(path)
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
            with open(os.path.join(dump_dir, os.path.basename(name)
                                   + ".sass"), "w") as f:
                f.write(text)
        for func, code in parse_sass(text).items():
            if name == "probes":
                step = next((s for s, st in _STRUCTS.items()
                             if f"{len(st)}{st}E" in func), None)
                if step is None:
                    continue
                body = loops(code)[0]
                out["chains"][step] = {
                    "unroll": K.unroll(step), "loop_body": len(body),
                    "per_step": len(body) / K.unroll(step),
                    "opcodes": _histogram(body)}
            elif name == "keccak":
                rounds, g = keccak_rounds(code), keccak_group_of(func)
                out.setdefault(name, {})[func] = {
                    "group": g, "instructions": len(code), "rounds": rounds,
                    "per_state": rounds and g * rounds["per_keccak_f"]}
            else:
                out.setdefault(name, {})[func] = {
                    "instructions": len(code),
                    "loops": [len(b) for b in loops(code)],
                    "per_permutation": per_permutation(
                        code, ROUND_TRIPS[_library_of(path)]),
                    "opcodes": _histogram(code)}
    return out


# the card-only sweeps of the kernels' launch geometry
GEOMETRY = {"poseidon_groups": run_groups,
            "poseidon2_groups": run_poseidon2_groups,
            "keccak_groups": run_keccak_groups,
            "ntt_bb_clusters": run_ntt_bb_clusters,
            "ntt_gl_clusters": run_ntt_gl_clusters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m plonky2_goldibear_torch.probes",
        description="Rates of one field or integer operation on the card.")
    ap.add_argument("sections", nargs="*",
                    help=f"of {list(SECTIONS) + list(MATMULS)} "
                         "sass poseidon_groups poseidon2_groups "
                         "keccak_groups "
                         "ntt_bb_clusters ntt_gl_clusters "
                         "(default: every chain section)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain torch, cut sizes)")
    ap.add_argument("--sass-dir", default=None,
                    help="with sass: write the listings here")
    ap.add_argument("--sass-lib", action="append", default=[],
                    help="with sass: also count this built Poseidon-GL "
                         "or Poseidon2-BB library (repeatable)")
    args = ap.parse_args(argv)
    names = args.sections or list(SECTIONS)
    for name in names:
        if name not in SECTIONS and name not in MATMULS and \
                name not in ("sass", *GEOMETRY):
            ap.error(f"unknown section {name!r}")
    dev = resolve(args.device)
    for name in names:
        if name == "sass":
            rec = sass_counts(args.sass_dir, args.sass_lib)
        elif name in GEOMETRY:
            rec = GEOMETRY[name](dev)
        else:
            rec = run_section(name, dev)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
