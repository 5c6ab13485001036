"""Witness schedules: recorded once, replayed for every later witness (the
JAX package's ``native/schedule.py``).

The fixpoint scheduler (``iop/generator.py``; reference
plonky2/src/iop/generator.rs:25-106) runs a generator once all its inputs
are set.  Its completion order depends only on which targets the caller
presets, not on their values, so one recorded run gives a valid order for
every later witness with the same preset targets.  ``compile_schedule``
lowers that order into segments: runs of lowered generators become one
instruction stream of the VM (``native/lower.py``, ``csrc/witgen.c``),
and the generators that stay in Python run between them, in the recorded
order, so randomness is drawn from the witness's rng exactly as the
fixpoint drew it.
"""

from __future__ import annotations

import bisect
from typing import List, Tuple

import numpy as np

from ..iop.witness import PartialWitness, PartitionWitness
from . import engine
from .lower import COPY, SPLITR, Ctx, Prog, RowTemplate, lowerer_for


class CompiledSchedule:
    """``segments``: ("native", (code, pool, starts, generator indices))
    or ("python", generator indices), in the recorded order; ``starts[k]``
    is the first instruction of the k-th lowered generator."""

    def __init__(self, segments: List[Tuple[str, object]], num_reps: int,
                 max_temps: int, p: int, n_native: int, n_python: int):
        self.segments = segments
        self.num_reps = num_reps
        self.max_temps = max_temps
        self.p = p
        self.n_native = n_native
        self.n_python = n_python
        self.n_instr = sum(len(s[1][0]) // 5 for s in segments
                           if s[0] == "native")

    def stats(self) -> dict:
        return {"n_native": self.n_native, "n_python": self.n_python,
                "n_instr": self.n_instr,
                "n_segments": len(self.segments)}

    def python_classes(self, generators) -> set:
        """The classes of the generators the replay runs in Python."""
        return {type(generators[gi]) for kind, seg in self.segments
                if kind == "python" for gi in seg}

    def replay(self, inputs: PartialWitness, prover_data, common,
               rng) -> PartitionWitness:
        """The witness of ``inputs`` by this schedule, drawing from
        ``rng``; raises ``engine.WitgenError`` (an ``AssertionError``)
        naming the generator where the stream stops."""
        vals = np.zeros(self.num_reps + self.max_temps, dtype=np.uint64)
        filled = np.zeros(self.num_reps, dtype=np.uint8)
        witness = PartitionWitness(
            common.config.num_wires, common.degree,
            prover_data.representative_map, rng, vals=vals, filled=filled)
        for t, v in inputs.target_values.items():
            witness.set_target(t, v)
        generators = prover_data.generators
        buffer: List = []
        for kind, seg in self.segments:
            if kind == "native":
                code, pool, starts, gis = seg
                rc = engine.run_raw(self.p, code, pool, vals, filled,
                                    self.num_reps)
                if rc:
                    raise self._error(rc, starts, gis, generators, code,
                                      pool, vals, filled)
                continue
            for gi in seg:
                g = generators[gi]
                bulk = getattr(g, "replay_values", None)
                if bulk is not None:
                    witness.set_dense(*bulk(witness))
                    continue
                g.run_once(witness, buffer)
                for t, v in buffer:
                    witness.set_target(t, v)
                buffer.clear()
        return witness

    def _error(self, rc, starts, gis, generators, code, pool, vals,
               filled):
        err, instr = rc >> engine.INSTR_BITS, \
            rc & ((1 << engine.INSTR_BITS) - 1)
        k = bisect.bisect_right(starts, instr) - 1
        g = generators[gis[k]]
        where = f"generator {gis[k]}, {type(g).__name__}"
        if hasattr(g, "row"):
            where += f" of row {g.row}"
        if err == 1:
            slot, new = _contradicted(code, pool, vals, filled, instr)
            where += (f": contradictory assignment of representative {slot}"
                      f", which holds {int(vals[slot])}"
                      + (f", not {new}" if new is not None else ""))
        return engine.WitgenError(err, instr, where)


def _contradicted(code, pool, vals, filled, instr):
    """(the slot, the value the stream tried to store there or None) of a
    contradiction at ``instr``."""
    op, dst, a, b, c = (int(w) for w in code[5 * instr:5 * instr + 5])
    if op != SPLITR:
        return dst, int(vals[a]) if op == COPY else None
    x = int(vals[a])
    for j in range(dst):
        slot, digit = int(pool[b + j]), x % c
        if filled[slot] and int(vals[slot]) != digit:
            return slot, digit
        x //= c
    return int(pool[b]), None


def compile_schedule(order: List[int], prover_data,
                     common) -> CompiledSchedule:
    """Lower the recorded completion ``order`` into native and Python
    segments."""
    config, spec = common.config, common.spec
    generators = prover_data.generators
    rep_map = prover_data.representative_map
    num_reps = len(rep_map)

    segments: List[Tuple[str, object]] = []
    max_temps = n_native = n_python = 0
    prog = ctx = None
    templates, memo = {}, {}
    nw = config.num_wires
    starts: List[int] = []
    gis: List[int] = []
    py_run: List[int] = []

    def flush_native():
        nonlocal prog, ctx, max_temps, starts, gis
        if prog is not None and len(prog):
            code, pool = prog.arrays()
            segments.append(("native", (code, pool, starts, gis)))
            max_temps = max(max_temps, prog.n_temps)
        prog = ctx = None
        starts, gis = [], []

    def flush_python():
        nonlocal py_run
        if py_run:
            segments.append(("python", py_run))
            py_run = []

    for gi in order:
        g = generators[gi]
        fn = lowerer_for(g, memo)
        if fn is None:
            flush_native()
            py_run.append(gi)
            n_python += 1
            continue
        flush_python()
        if prog is None:
            prog = Prog(num_reps, spec.p)
            ctx = Ctx(prog, spec, rep_map, config.num_wires, common.degree)
        starts.append(len(prog))
        gis.append(gi)
        if fn.template_key is None:
            fn(g, ctx)
        else:
            key = (fn, fn.template_key(g))
            tmpl = templates.get(key)
            if tmpl is None:
                tmpl = templates[key] = RowTemplate(fn, g, spec)
            tmpl.emit(prog, rep_map[g.row * nw:(g.row + 1) * nw])
        n_native += 1
    flush_native()
    flush_python()
    return CompiledSchedule(segments, num_reps, max_temps, spec.p,
                            n_native, n_python)
