"""The device-transcript prover (``plonk/prover_async.py``) on the CPU, with
the plain torch versions of its kernels.

- ``prove`` without ``timings`` takes it for Poseidon-GL and Poseidon2-BB,
  and its proofs of the committed 2^6 chains (``data/arith_chain{,_bb}_
  2e6.npz``, whose JAX writer held them equal to the JAX device-transcript
  proof) equal the stored JAX proofs, field by field.
- It equals the sync prover (``timings={}``) and the JAX proof on the
  Tip5-16 lookup fixtures of both fields (the deltas' extra fetch).
- A Keccak circuit takes the sync prover, as a timed prove does.
- A forged flag in the fetched values raises.

The zk fixture is in ``tests/test_torch_prover_async_zk.py``, the retries
of the 2^6 fixtures through the device path's flag in
``tests/test_torch_prover_async_retry.py`` (each file a minute at most on
one CPU worker).  Tolerance zero: exact field arithmetic.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from plonky2_goldibear_torch.hash import keccak_hasher, poseidon2_bb
from plonky2_goldibear_torch.hash import poseidon_gl
from plonky2_goldibear_torch.iop.generator import NonRandomRng
from plonky2_goldibear_torch.ops import transcript as T
from plonky2_goldibear_torch.plonk import prover, prover_async
from plonky2_goldibear_torch.plonk.circuit_data import (DATA_DIR,
                                                        load_circuit,
                                                        load_fixture,
                                                        read_fixture)
from plonky2_goldibear_torch.plonk.proof import PROOF_PHASES, flatten_proof

torch.set_num_threads(1)


class _Spy:
    """Counts the calls of a module function while it is installed."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.calls = 0

    def __enter__(self):
        def spy(*args, **kwargs):
            self.calls += 1
            return self.real(*args, **kwargs)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


@pytest.fixture(scope="module")
def chains():
    """field -> (JAX arrays, the port's default proof, how many
    device-transcript attempts it took, the arguments of its
    ``assemble_proof``)."""
    out = {}
    real = prover_async.assemble_proof
    for field in ("goldilocks", "babybear"):
        circuit, arrays = load_fixture(6, device="cpu", field=field)
        kept = []

        def keep(*args):
            kept.append(args)
            return real(*args)

        prover_async.assemble_proof = keep
        try:
            with _Spy(prover_async, "internal_prove_async") as spy:
                proof = prover.prove(circuit, device="cpu")
        finally:
            prover_async.assemble_proof = real
        out[field] = (arrays, proof, spy.calls, kept[-1])
    return out


@pytest.mark.parametrize("phase", PROOF_PHASES)
@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_chain_proof_matches_jax(chains, field, phase):
    arrays, proof, attempts, _ = chains[field]
    assert attempts == 1
    np.testing.assert_array_equal(flatten_proof(proof)[phase],
                                  arrays["proof_" + phase])


def both_paths(name, counter_key=None):
    """((device-transcript proof, rng counter after it), (sync proof, rng
    counter after it)), JAX arrays: a fixture of ``data/`` loaded as data
    and proved by each prover from the counter its witness left (or 1).
    The plain grind, which both provers run on the CPU, is kept by its
    inputs: the second prover's grind, on the same transcript, is the
    first one's result (on another transcript it runs again)."""
    arrays, meta = read_fixture(os.path.join(DATA_DIR, name + ".npz"))
    circuit = load_circuit(arrays, meta, device="cpu")
    counter = int(arrays[counter_key]) if counter_key else 1
    real, kept = T.pow_grind_plain, {}

    def grind(state, leftover, k, batch=None, permute=None, **kw):
        key = (tuple(state.tolist()), None if leftover is None else
               tuple(leftover.tolist()), k)
        if key not in kept:
            kept[key] = real(state, leftover, k, batch, permute, **kw)
        return kept[key]

    out = []
    T.pow_grind_plain = grind
    try:
        for timings in (None, {}):
            rng = NonRandomRng(counter)
            out.append((flatten_proof(prover.prove(
                circuit, device="cpu", rng=rng, timings=timings)),
                rng.counter))
    finally:
        T.pow_grind_plain = real
    return out, arrays


def assert_paths_equal(name, counter_key=None):
    ((device, dev_counter), (sync, sync_counter)), arrays = both_paths(
        name, counter_key)
    for k in PROOF_PHASES:
        np.testing.assert_array_equal(device[k], sync[k], err_msg=k)
        np.testing.assert_array_equal(device[k], arrays["proof_" + k],
                                      err_msg=k)
    assert dev_counter == sync_counter


@pytest.mark.parametrize("name", ["lookup_tip5", "lookup_tip5_bb"])
def test_device_transcript_equals_sync(name):
    assert_paths_equal(name)


def test_dispatch_follows_the_hasher_and_timings():
    """The device transcript for Poseidon-GL and Poseidon2-BB without
    ``timings``; the sync prover for Keccak or a timed prove."""
    assert prover_async.available(poseidon_gl)
    assert prover_async.available(poseidon2_bb)
    assert not prover_async.available(keccak_hasher)

    class Taken(Exception):
        pass

    class Circuit:
        hasher = keccak_hasher

    taken = []

    def device(*_):
        taken.append("device")
        raise Taken

    def sync(*_):
        taken.append("sync")
        raise Taken

    real = prover_async.internal_prove_async, prover._internal_prove_sync
    prover_async.internal_prove_async, prover._internal_prove_sync = \
        device, sync
    try:
        for hasher, timings in ((keccak_hasher, None), (poseidon_gl, {}),
                                (poseidon_gl, None), (poseidon2_bb, None)):
            Circuit.hasher = hasher
            with pytest.raises(Taken):
                prover._internal_prove(Circuit, None, timings, None)
    finally:
        prover_async.internal_prove_async, prover._internal_prove_sync = \
            real
    assert taken == ["sync", "sync", "device", "device"]


@pytest.mark.parametrize("flag,error", [
    (0, AssertionError), (1, AssertionError), (2, prover.InvZeroPermArg)])
def test_forged_flag_raises(chains, flag, error):
    """Flags 0, 1, 2 of the BB chain's fetch: zeta outside the subgroup,
    the PoW witness found and passing, the permutation argument's
    denominators nonzero.  Each at 0 fails the proof, as any value but 0
    and 1 does."""
    _, proof, _, (circuit, flat, *rest) = chains["babybear"]
    again = prover_async.assemble_proof(circuit, flat.copy(), *rest)
    assert flatten_proof(again)["query_rounds"].tolist() == \
        flatten_proof(proof)["query_rounds"].tolist()
    forged = flat.copy()
    forged[flag] = 0
    with pytest.raises(error):
        prover_async.assemble_proof(circuit, forged, *rest)
    forged[flag] = 2                 # not a flag at all
    with pytest.raises(AssertionError):
        prover_async.assemble_proof(circuit, forged, *rest)
