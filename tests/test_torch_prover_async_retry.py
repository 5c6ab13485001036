"""The permutation-argument retry through the device-transcript prover, on
the CPU: each field's 2^6 fixture proved from the counter the JAX retry
recorded, its first attempts failing through the device path's own flag
(a zero denominator reported by ``partial_products`` and read back with
the proof), gives the random wire's redrawn values and the retried proof
of the JAX retry (``arith_chain{,_bb}_2e6_retry.npz``, which
``tests/test_torch_retry.py`` holds the sync prover's retry equal to).
A failing attempt's PoW grind is skipped (its witness is never read: the
permutation-argument flag is read first), which keeps a Goldilocks retry
to one grind on the CPU.  Tolerance zero: exact field arithmetic.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from plonky2_goldibear_torch.iop.generator import NonRandomRng
from plonky2_goldibear_torch.ops import transcript as T
from plonky2_goldibear_torch.plonk import prover
from plonky2_goldibear_torch.plonk.circuit_data import (fixture_path,
                                                        load_fixture)
from plonky2_goldibear_torch.plonk.proof import PROOF_PHASES, flatten_proof

torch.set_num_threads(1)
FIELDS = ("goldilocks", "babybear")


@pytest.fixture(scope="module")
def retried():
    """field -> (stored retry arrays, the retried proof flattened, the
    random wire's value at each attempt, the attempts made)."""
    cache = {}

    def get(field):
        if field in cache:
            return cache[field]
        circuit, _ = load_fixture(6, device="cpu", field=field)
        with np.load(fixture_path(6, field, retry=True)) as z:
            arrays = {k: z[k] for k in z.files}
        failures = len(arrays["values"])
        row, col = circuit.random_wire
        reals = prover._internal_prove, prover.partial_products, T.pow_grind
        seen = []

        def attempt(circuit_, wires, timings, rng):
            seen.append(int(circuit_.F.to_ints(wires[col, row:row + 1])[0]))
            return reals[0](circuit_, wires, timings, rng)

        def flagged(*args):
            zs_pp, any_zero = reals[1](*args)
            return zs_pp, any_zero | (len(seen) <= failures)

        def grind(state, leftover, k):
            if len(seen) <= failures:
                return state.new_zeros(2), None
            return reals[2](state, leftover, k)

        prover._internal_prove, prover.partial_products, T.pow_grind = \
            attempt, flagged, grind
        try:
            proof = prover.prove(circuit, device="cpu",
                                 rng=NonRandomRng(int(arrays["counter"])))
        finally:
            prover._internal_prove, prover.partial_products, T.pow_grind = \
                reals
        cache[field] = (arrays, flatten_proof(proof), seen, failures)
        return cache[field]

    return get


@pytest.mark.parametrize("field", FIELDS)
def test_retry_redraws_the_jax_values(retried, field):
    arrays, _, seen, failures = retried(field)
    assert len(seen) == failures + 1
    assert seen[1:] == [int(v) for v in arrays["values"]]


@pytest.mark.parametrize("phase", PROOF_PHASES)
@pytest.mark.parametrize("field", FIELDS)
def test_retry_proof_matches_jax(retried, field, phase):
    arrays, flat, _, _ = retried(field)
    np.testing.assert_array_equal(flat[phase], arrays["proof_" + phase])
