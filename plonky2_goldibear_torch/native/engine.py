"""The ctypes binding of the witness-replay VM ``csrc/witgen.c`` (the JAX
package's ``native/engine.py``).

The library is built with the host C compiler at first use
(``ops/_build.py:host_lib``).  There is no other path: when it cannot be
built, the first call raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

ERR_NAMES = {
    1: "contradictory witness assignment",
    2: "inverse of zero",
    3: "random-access index out of range",
    4: "split leftover (the sum does not fit in limbs)",
    5: "integer too large for bit split",
    6: "bad opcode",
    7: "not boolean",
    8: "lookup input not in table",
}
INSTR_BITS = 48

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
_LIB = None


def lib() -> ctypes.CDLL:
    """The VM's library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        so = _build.host_lib("witgen")
        so.witgen_run.restype = ctypes.c_uint64
        so.witgen_run.argtypes = [ctypes.c_uint64, _U64P, ctypes.c_uint64,
                                  _U64P, _U64P, _U8P, ctypes.c_uint64]
        so.witgen_gather.restype = None
        so.witgen_gather.argtypes = [_U64P, _U8P, _I64P, ctypes.c_uint64,
                                     _U64P]
        _LIB = so
    return _LIB


class WitgenError(AssertionError):
    """A stream stopped: ``code`` (``ERR_NAMES``) at instruction
    ``instr``.  An ``AssertionError``, as the fixpoint's failures are."""

    def __init__(self, code: int, instr: int, where: str = ""):
        self.code = code
        self.instr = instr
        self.where = where
        name = ERR_NAMES.get(code, f"error {code}")
        super().__init__(f"{name} at instruction {instr}"
                         + (f" ({where})" if where else ""))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def _check(a: np.ndarray, dtype, name: str) -> None:
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise TypeError(f"{name} must be a contiguous {np.dtype(dtype)} "
                        f"array")


def run_raw(p: int, code: np.ndarray, pool: np.ndarray, values: np.ndarray,
            filled: np.ndarray, num_reps: int) -> int:
    """Run a stream (code: 5 words an instruction); the VM's return word,
    0 or (code << 48) | instruction."""
    _check(code, np.uint64, "code")
    _check(pool, np.uint64, "pool")
    _check(values, np.uint64, "values")
    _check(filled, np.uint8, "filled")
    if len(code) % 5 or len(filled) < num_reps or len(values) < num_reps:
        raise ValueError("bad stream or buffer sizes")
    return int(lib().witgen_run(
        p, _ptr(code, _U64P), len(code) // 5, _ptr(pool, _U64P),
        _ptr(values, _U64P), _ptr(filled, _U8P), num_reps))


def run(p: int, code: np.ndarray, pool: np.ndarray, values: np.ndarray,
        filled: np.ndarray, num_reps: int) -> None:
    """Run a stream over ``values`` and ``filled`` in place; raises
    ``WitgenError`` where it stops."""
    rc = run_raw(p, code, pool, values, filled, num_reps)
    if rc:
        raise WitgenError(rc >> INSTR_BITS, rc & ((1 << INSTR_BITS) - 1))


def gather(values: np.ndarray, filled: np.ndarray, rep: np.ndarray,
           out: np.ndarray) -> None:
    """out[k] = values[rep[k]] where that slot is filled, else 0."""
    _check(values, np.uint64, "values")
    _check(filled, np.uint8, "filled")
    _check(rep, np.int64, "rep")
    _check(out, np.uint64, "out")
    if out.size != rep.size:
        raise ValueError("out and rep differ in size")
    lib().witgen_gather(_ptr(values, _U64P), _ptr(filled, _U8P),
                        _ptr(rep, _I64P), rep.size, _ptr(out, _U64P))
