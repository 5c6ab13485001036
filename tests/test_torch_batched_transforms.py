"""The prover's callers hand the NTT whole batches, on the CPU.

- The extension-field transforms (``field/fft.py`` ``ext_*``) stack the D
  component rows into one call; each equals the per-component transforms
  and the JAX package's ``field/fft.py`` ext transforms, for Goldilocks
  (gl2) and BabyBear (bb4).
- The coset power tables are built once per (base, n, device, field) and
  equal ``powers``.
- One BabyBear 2^6 prove on the CPU: every NTT call it makes equals the
  same rows transformed one at a time, ``quotient_chunks`` (one coset iFFT
  over all challenges) equals its per-challenge chunks, the calls are the
  batched list, and the proof still equals the JAX proof.

Tolerance zero throughout: exact field arithmetic.
"""

import jax
import numpy as np
import pytest
import torch

from plonky2_goldibear_tpu.field import bb as jbb
from plonky2_goldibear_tpu.field import ext as jext
from plonky2_goldibear_tpu.field import fft as jfft
from plonky2_goldibear_tpu.field import gl as jgl

from plonky2_goldibear_torch.field import bb as tbb
from plonky2_goldibear_torch.field import fft as tfft
from plonky2_goldibear_torch.field import gl as tgl

torch.set_num_threads(1)

FIELDS = {"goldilocks": (tgl, jgl, jext.gl2, 2),
          "babybear": (tbb, jbb, jext.bb4, 4)}
SHIFT = 7


def _canon(seed, shape, F):
    return np.random.default_rng(seed).integers(0, F.P, size=shape,
                                                dtype=np.uint64)


def _ints(F, t):
    return np.asarray(F.to_ints(t), dtype=np.uint64)


def _jax_ints(JF, a):
    return np.asarray(JF.to_ints(a), dtype=np.uint64)


@pytest.mark.parametrize("op", ["ext_fft", "ext_ifft", "ext_coset_fft",
                                "ext_coset_ifft"])
@pytest.mark.parametrize("field", list(FIELDS))
def test_batched_ext_transforms(field, op):
    F, JF, E, D = FIELDS[field]
    comps = [_canon(10 * D + d, (64,), F) for d in range(D)]
    x = tuple(F.from_ints(c) for c in comps)
    coset = op.startswith("ext_coset")
    args = (SHIFT,) if coset else ()
    got = getattr(tfft, op)(x, *args, F=F)
    base = {"ext_fft": lambda c: tfft.fft(c, F=F),
            "ext_ifft": lambda c: tfft.ifft(c, F),
            "ext_coset_fft": lambda c: tfft.coset_fft(c, SHIFT, F),
            "ext_coset_ifft": lambda c: tfft.coset_ifft(c, SHIFT, F)}[op]
    ref = jax.jit(lambda *cs: getattr(jfft, op)(E, tuple(cs), *args))(
        *(JF.from_ints(c) for c in comps))
    assert len(got) == D
    for g, c, r in zip(got, x, ref):
        assert torch.equal(g, base(c))
        np.testing.assert_array_equal(_ints(F, g), _jax_ints(JF, r))


@pytest.mark.parametrize("field", list(FIELDS))
def test_coset_powers_are_cached(field):
    F = FIELDS[field][0]
    a = tfft.coset_powers(F.SPEC.coset_shift, 256, "cpu", F)
    assert tfft.coset_powers(F.SPEC.coset_shift, 256, torch.device("cpu"),
                             F) is a
    assert torch.equal(a, tfft.powers(F.SPEC.coset_shift, 256, "cpu", F))


def test_bb_prove_sends_whole_batches(monkeypatch):
    from plonky2_goldibear_torch.ops import ntt_bb
    from plonky2_goldibear_torch.plonk import prover
    from plonky2_goldibear_torch.plonk.circuit_data import load_fixture
    from plonky2_goldibear_torch.plonk.proof import flatten_proof

    calls, chunk_checks = [], []
    real_fft = ntt_bb.fft

    def fft(x, r=0):
        out = real_fft(x, r)
        rows = x.reshape(-1, x.shape[-1])
        calls.append((rows.shape[0], x.shape[-1], r))
        assert torch.equal(out.reshape(rows.shape), torch.stack(
            [real_fft(row, r) for row in rows]))
        return out

    real_chunks = prover.quotient_chunks

    def quotient_chunks(circuit, *args):
        seen = []
        real_coset_ifft = tfft.coset_ifft

        def spy(values, shift, F):
            seen.append((values, shift))
            return real_coset_ifft(values, shift, F)

        monkeypatch.setattr(tfft, "coset_ifft", spy)
        chunks = real_chunks(circuit, *args)
        monkeypatch.setattr(tfft, "coset_ifft", real_coset_ifft)
        (values, shift), = seen
        common = circuit.common
        monkeypatch.setattr(ntt_bb, "fft", real_fft)    # not recorded
        per_row = torch.cat([
            real_coset_ifft(v, shift, circuit.F)[:common.quotient_degree]
            .reshape(-1, common.degree) for v in values])
        monkeypatch.setattr(ntt_bb, "fft", fft)
        chunk_checks.append(torch.equal(chunks, per_row))
        return chunks

    monkeypatch.setattr(ntt_bb, "fft", fft)
    monkeypatch.setattr(prover, "quotient_chunks", quotient_chunks)
    circuit, arrays = load_fixture(6, device="cpu", field="babybear")
    calls.clear()
    flat = flatten_proof(prover.prove(circuit, device="cpu"))
    assert chunk_checks == [True]
    # wires, Z and partial products, quotient: iFFT and LDE of each; the
    # quotient's 6 challenges in one coset iFFT; the FRI's bb4 combine in
    # one coset iFFT of 4 rows, its fold round in one coset NTT of 4 rows
    assert calls == [(167, 64, 0), (167, 512, 3), (36, 64, 0), (36, 512, 3),
                     (6, 512, 0), (48, 512, 3), (4, 512, 0), (4, 64, 0)]
    for k, v in flat.items():
        np.testing.assert_array_equal(v, arrays["proof_" + k], err_msg=k)
