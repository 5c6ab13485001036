"""The port's probe chains (``ops/probes.py``) against the TPU probe
kernels of ``scripts/`` and against Python integer arithmetic.

Inputs are made with numpy from a seed: GL (8, 128) elements, u32 in
[1, 2^31), f32 in [0.75, 1.25), as the scripts make them.  The script
kernels run through ``pl.pallas_call(..., interpret=True)`` on the CPU;
``scripts/`` is not a package, so each script is loaded from its path.
The JAX GL chains are lazy (values < 2^64), so GL results are compared
mod p; u32 results exactly; f32 FMA within a relative 1e-5 (the port's
kernel rounds once, ``fmaf``; the plain twin rounds a float64 sum, and XLA
may round twice).
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from plonky2_goldibear_tpu.field import gl as jgl
from plonky2_goldibear_tpu.field.gl import GL
from plonky2_goldibear_tpu.ops import poseidon_gl as kp

from plonky2_goldibear_torch import probes as runner
from plonky2_goldibear_torch.field import gl as tgl
from plonky2_goldibear_torch.ops import probes as K

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = tgl.P
M32 = 0xFFFFFFFF
SHAPE = (8, 128)
FMA_RTOL = 1e-5


def _script(name):
    spec = importlib.util.spec_from_file_location(
        "probe_script_" + name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {n: _script(n) for n in ("profile_poseidon", "profile_sbox2",
                                    "profile2")}


# -- the JAX side -------------------------------------------------------------


def _gl_call(kernel, x):
    """A script's GL chain kernel, (lo, hi) planes in and out, interpreted."""
    xj = jgl.from_ints(x)
    osh = jax.ShapeDtypeStruct(x.shape, jnp.uint32)
    lo, hi = pl.pallas_call(kernel, out_shape=(osh, osh),
                            interpret=True)(xj.lo, xj.hi)
    lo, hi = np.asarray(lo).astype(np.uint64), np.asarray(hi)
    return lo | (hi.astype(np.uint64) << np.uint64(32))


def _fori_gl_kernel(fn, reps):
    """The kernel of hwprobe3.py probe_gl / probe_sbox (built inside those
    functions, so written out here): a fori_loop of fn over (lo, hi)."""
    def kern(lo_ref, hi_ref, o_lo, o_hi):
        x0 = GL(lo_ref[:], hi_ref[:])

        def body(_, st):
            y = fn(GL(st[0], st[1]), x0)
            return (y.lo, y.hi)

        o_lo[:], o_hi[:] = jax.lax.fori_loop(0, reps, body, (x0.lo, x0.hi))
    return kern


# hwprobe3.py:179-188, the body16 of each probe_u32 call
U32_BODIES = {
    "u32_mul": lambda y, x: y * x,
    "u32_mul16": lambda y, x: ((y * (x >> 16)) & jnp.uint32(0xFFFF)),
    "u32_add": lambda y, x: y + x,
    "f32_fma": lambda y, x: y * x + jnp.float32(0.5),
}


def _u32_call(step, x, reps):
    """hwprobe3.py probe_u32's kernel: a fori_loop of body16, interpreted."""
    body = U32_BODIES[step]

    def kern(a_ref, o_ref):
        x0 = a_ref[:]
        o_ref[:] = jax.lax.fori_loop(0, reps, lambda _, y: body(y, x0), x0)

    out = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(x.shape,
                                                              x.dtype),
                         interpret=True)(jnp.asarray(x))
    return np.asarray(out)


# (case id) -> (step, reps, JAX kernel from the loaded scripts)
GL_CASES = {
    "gl_mul-profile_poseidon": (
        "gl_mul", 5, lambda s, r: functools.partial(
            s["profile_poseidon"]._mulchain_kernel, reps=r)),
    "gl_mul-profile2": (
        "gl_mul", 5, lambda s, r: functools.partial(
            s["profile2"]._mulchain_kernel, reps=r)),
    "gl_mul-hwprobe3": (
        "gl_mul", 5, lambda s, r: _fori_gl_kernel(kp._mul, r)),
    "gl_sbox-profile_poseidon": (
        "gl_sbox", 3, lambda s, r: functools.partial(
            s["profile_poseidon"]._sboxchain_kernel, reps=r)),
    "gl_sbox-profile_sbox2": (
        "gl_sbox", 3, lambda s, r: functools.partial(
            s["profile_sbox2"]._chain_kernel, reps=r, fn=kp._sbox)),
    "gl_sbox-hwprobe3": (
        "gl_sbox", 3, lambda s, r: _fori_gl_kernel(
            lambda y, _: kp._sbox(y), r)),
    "gl_sqr-profile_sbox2": (
        "gl_sqr", 5, lambda s, r: functools.partial(
            s["profile_sbox2"]._chain_kernel, reps=r, fn=kp._sqr)),
    "gl_sbox_serial-profile_sbox2": (
        "gl_sbox_serial", 3, lambda s, r: functools.partial(
            s["profile_sbox2"]._chain_kernel, reps=r,
            fn=s["profile_sbox2"]._sbox_serial)),
}

# the exponent of x after r reps
GL_POWER = {"gl_mul": lambda r: r + 1, "gl_sqr": lambda r: 2 ** r,
            "gl_sbox": lambda r: 7 ** r, "gl_sbox_serial": lambda r: 7 ** r}


@pytest.mark.parametrize("case", list(GL_CASES))
def test_gl_chain_matches_jax_probe(scripts, case):
    step, reps, make_kernel = GL_CASES[case]
    x = np.random.default_rng(len(case)).integers(0, P, size=SHAPE,
                                                  dtype=np.uint64)
    ours = tgl.to_ints(K.chain(tgl.from_ints(x), step, reps))
    theirs = _gl_call(make_kernel(scripts, reps), x) % np.uint64(P)
    np.testing.assert_array_equal(ours, theirs)
    e = GL_POWER[step](reps)
    np.testing.assert_array_equal(
        ours, np.array([pow(int(v), e, P) for v in x.ravel()],
                       dtype=np.uint64).reshape(SHAPE))


def _u32_python(step, x, reps):
    """The chain in Python ints (u32) or float64 (f32), elementwise."""
    out = []
    for x0 in x.ravel().tolist():
        y = x0
        for _ in range(reps):
            if step == "u32_mul":
                y = (y * x0) & M32
            elif step == "u32_mul16":
                y = (y * (x0 >> 16)) & 0xFFFF
            elif step == "u32_add":
                y = (y + x0) & M32
            else:
                y = y * x0 + 0.5
        out.append(y)
    return np.array(out).reshape(x.shape)


@pytest.mark.parametrize("step", list(U32_BODIES))
def test_u32_f32_chain_matches_jax_probe(step):
    reps = 5
    rng = np.random.default_rng(7)
    if step == "f32_fma":
        x = rng.random(SHAPE, dtype=np.float32) * 0.5 + 0.75
        ours = K.chain(torch.from_numpy(x), step, reps).numpy()
        np.testing.assert_allclose(ours, _u32_call(step, x, reps),
                                   rtol=FMA_RTOL)
        np.testing.assert_allclose(ours, _u32_python(step, x, reps),
                                   rtol=FMA_RTOL)
        return
    x = rng.integers(1, 1 << 31, size=SHAPE, dtype=np.uint32)
    ours = K.chain(torch.from_numpy(x.view(np.int32)), step, reps).numpy()
    ours = ours.view(np.uint32)
    np.testing.assert_array_equal(ours, _u32_call(step, x, reps))
    np.testing.assert_array_equal(ours, _u32_python(step, x, reps))


# -- the wrapper and the runner -------------------------------------------------


def test_chain_checks_its_arguments():
    x = tgl.from_ints(np.arange(4, dtype=np.uint64))
    assert torch.equal(K.chain(x, "gl_mul", 0), x)
    with pytest.raises(TypeError, match="int32"):
        K.chain(x, "u32_add", 1)
    with pytest.raises(ValueError, match="unknown probe step"):
        K.chain(x, "gl_cube", 1)
    with pytest.raises(ValueError, match="reps"):
        K.chain(x, "gl_mul", -1)


def test_probe_runner_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(["gl"])


def test_probe_runner_on_cpu(capsys):
    assert runner.main(["add", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["step"] == "u32_add" and rec["device"] == "cpu"
    for size in ("script", "fill"):
        assert rec[size]["G_ops_per_s"] > 0 and rec[size]["reps"] >= 1


def test_sass_loop_reader():
    sass = "\n".join([
        "\tFunction : _ZN12_GLOBAL__N_112chain_kernelINS_5GlMulEEEvPKT_PS2_li",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        "        /*0010*/                   IMAD.WIDE.U32 R4, R2, R3, RZ ;",
        "        /*0020*/                   IADD3 R6, P0, R4, R5, RZ ;",
        "        /*0030*/              @!P0 BRA 0x10 ;",
        "        /*0040*/                   EXIT ;",
    ])
    funcs = runner.parse_sass(sass)
    (name, code), = funcs.items()
    assert "5GlMulE" in name and len(code) == 5
    body, = runner.loops(code)
    assert [a for a, _ in body] == [0x10, 0x20, 0x30]
    assert runner._histogram(body) == {"IMAD": 1, "IADD3": 1, "BRA": 1}
