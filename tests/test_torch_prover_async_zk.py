"""The device-transcript prover on the 1-round zk fixture
(``data/zk_fib_1q.npz``), on the CPU: its proof equals the sync prover's
and the JAX proof, salts drawn in the same order from the counter the
witness left; a zero permutation-argument denominator makes an attempt
raise ``InvZeroPermArg`` after the fetch, with the rng put back where the
sync prover's failed attempt leaves it (after the wires' salts), so a
retry draws what the sync prover's does.  Tolerance zero: exact field
arithmetic.
"""

from __future__ import annotations

import os

import pytest
import torch

from plonky2_goldibear_torch.iop.generator import NonRandomRng
from plonky2_goldibear_torch.ops import transcript as T
from plonky2_goldibear_torch.plonk import prover, prover_async
from plonky2_goldibear_torch.plonk.circuit_data import (DATA_DIR,
                                                        load_circuit,
                                                        read_fixture)

from test_torch_prover_async import assert_paths_equal

torch.set_num_threads(1)
NAME = "zk_fib_1q"


def test_zk_device_transcript_equals_sync():
    assert_paths_equal(NAME, "counter")


def test_zero_denominator_raises_and_rewinds_the_rng():
    arrays, meta = read_fixture(os.path.join(DATA_DIR, NAME + ".npz"))
    circuit = load_circuit(arrays, meta, device="cpu")
    want = NonRandomRng(int(arrays["counter"]))
    reals = prover.partial_products, T.pow_grind

    def zero_denominator(*args):
        zs_pp, _ = reals[0](*args)
        return zs_pp, torch.tensor(True)

    def no_grind(state, leftover, k):
        # the attempt fails on its permutation-argument flag, read first:
        # its PoW witness is never looked at
        return state.new_zeros(2), None

    prover.partial_products, T.pow_grind = zero_denominator, no_grind
    try:
        with pytest.raises(prover.InvZeroPermArg):
            prover._internal_prove_sync(circuit, circuit.wires, {}, want)
        rng = NonRandomRng(int(arrays["counter"]))
        with pytest.raises(prover.InvZeroPermArg):
            prover_async.internal_prove_async(circuit, circuit.wires, rng)
    finally:
        prover.partial_products, T.pow_grind = reals
    assert want.counter > int(arrays["counter"])     # the wires' salts
    assert rng.counter == want.counter
