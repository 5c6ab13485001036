"""The port's device transcript against the host transcript and the JAX
package's, on the CPU (the plain torch versions of the kernels).

- ``DeviceChallenger`` (``hash/device_challenger.py``) gives the port's host
  ``Challenger`` and the JAX host challenger's challenges over random
  observe/squeeze interleavings (the JAX test's seeds 0-2, 12 steps each,
  ``tests/test_device_challenger.py``), both fields; a shorter one is held
  against the JAX ``DeviceChallenger`` itself.
- ``grind_inputs`` gives the host sponge state and input buffer.
- ``ops/transcript.py:flush_schedule`` gives the host's count of
  permutations and of buffered outputs over a grid of steps.
- ``transcript_flush_plain`` equals the JAX ``_flush_program`` for static
  schedules that take each branch: full chunks and a partial one, a final
  observe that refills the outputs, squeezes with nothing absorbed, and a
  pure absorb that returns its leftover.
- ``pow_grind_plain`` finds the sync grinder's witness and the JAX
  ``_grind_async_jit``'s, at a small k and a small batch, and reports an
  exhausted search as a flag.

Tolerance zero throughout: exact field arithmetic.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from plonky2_goldibear_tpu.field import bb as jbb
from plonky2_goldibear_tpu.field import gl as jgl
from plonky2_goldibear_tpu.fri import prover as jfri
from plonky2_goldibear_tpu.hash import challenger as jchallenger
from plonky2_goldibear_tpu.hash import device_challenger as jdc
from plonky2_goldibear_tpu.hash import poseidon2_bb as jp2
from plonky2_goldibear_tpu.hash import poseidon_gl as jpgl

from plonky2_goldibear_torch.field import bb, gl, host
from plonky2_goldibear_torch.fri import prover as fri_prover
from plonky2_goldibear_torch.hash import poseidon2_bb, poseidon_gl
from plonky2_goldibear_torch.hash.challenger import Challenger
from plonky2_goldibear_torch.hash.device_challenger import DeviceChallenger
from plonky2_goldibear_torch.ops import transcript as T

torch.set_num_threads(1)

# field -> (port field, port hasher, spec, JAX field, JAX hasher)
FIELDS = {
    "goldilocks": (gl, poseidon_gl, host.GOLDILOCKS, jgl, jpgl),
    "babybear": (bb, poseidon2_bb, host.BABYBEAR, jbb, jp2),
}


def _ints(F, x) -> list:
    return [int(v) for v in F.to_ints(x)]


def _jax_host(field):
    _, H, spec, _, JH = FIELDS[field]
    return jchallenger.Challenger(JH.permute_host, JH.WIDTH, JH.RATE, spec)


def _steps(seed: int, p: int, count: int):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        k = int(rng.integers(0, 23))
        vals = [int(x) for x in rng.integers(0, p, size=k, dtype=np.uint64)]
        yield vals, int(rng.integers(1, 12))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("field", list(FIELDS))
def test_matches_host_challenger(field, seed):
    F, H, spec, _, _ = FIELDS[field]
    host_ch, jax_ch = Challenger(spec, H), _jax_host(field)
    dev_ch = DeviceChallenger(F, H, "cpu")
    for vals, n in _steps(seed, spec.p, 12):
        host_ch.observe_elements(vals)
        jax_ch.observe_elements(vals)
        dev_ch.observe_host_ints(vals)
        want = host_ch.get_n_challenges(n)
        assert jax_ch.get_n_challenges(n) == want
        assert _ints(F, dev_ch.get_n_challenges(n)) == want, (vals, n)
        assert dev_ch.n_out == len(host_ch.output_buffer)


@pytest.mark.parametrize("field", list(FIELDS))
def test_matches_jax_device_challenger(field):
    """A shorter interleaving (each step a JAX compile) against the JAX
    ``DeviceChallenger``, observing device arrays as the provers do."""
    F, H, spec, JF, JH = FIELDS[field]
    jax_dc = jdc.DeviceChallenger(JF, JH)
    dev_ch = DeviceChallenger(F, H, "cpu")
    for vals, n in _steps(5, spec.p, 4):
        jax_dc.observe_host_ints(vals)
        dev_ch.observe_array(F.from_ints(vals, "cpu"))
        want = [int(v) for v in JF.to_ints(jax_dc.get_n_challenges(n))]
        assert _ints(F, dev_ch.get_n_challenges(n)) == want, (vals, n)


@pytest.mark.parametrize("field", list(FIELDS))
def test_grind_inputs_match_host_state(field):
    F, H, spec, _, _ = FIELDS[field]
    rng = np.random.default_rng(3)
    host_ch, dev_ch = Challenger(spec, H), DeviceChallenger(F, H, "cpu")
    for size in (21, 2):      # full chunks and a leftover, then two pieces
        vals = [int(x) for x in rng.integers(0, spec.p, size=size,
                                             dtype=np.uint64)]
        host_ch.observe_elements(vals)
        dev_ch.observe_host_ints(vals)
    state, leftover, L = dev_ch.grind_inputs()
    assert L == len(host_ch.input_buffer) == 7
    assert _ints(F, state) == host_ch.sponge_state
    assert _ints(F, leftover) == host_ch.input_buffer
    # and the transcripts stay in step afterwards
    host_ch.observe_element(7)
    dev_ch.observe_host_ints([7])
    assert _ints(F, dev_ch.get_n_challenges(3)) == \
        host_ch.get_n_challenges(3)


class _CountingPermute:
    """A cheap stand-in permutation that counts its calls: the host
    challenger's buffer counts do not depend on the values."""

    calls = 0

    def __call__(self, state):
        self.calls += 1
        return [(v + 1) % 97 for v in state]


@pytest.mark.parametrize("n_out_before", range(0, 9))
def test_remaining_outputs_match_host_count(n_out_before):
    R = 8

    def fresh():
        ch = Challenger(host.GOLDILOCKS, poseidon_gl)
        ch.permute = _CountingPermute()
        if n_out_before == R:
            ch.observe_elements([1] * R)       # the duplex refills R
        elif n_out_before:
            ch.get_n_challenges(R - n_out_before)
        assert len(ch.output_buffer) == n_out_before and \
            not ch.input_buffer
        return ch

    for absorbed in range(0, 20):
        for n in range(0, 11):
            ch = fresh()
            ch.permute.calls = 0
            ch.observe_elements([2] * absorbed)
            ch.get_n_challenges(n)
            assert T.flush_schedule(absorbed, n_out_before, n) == \
                (ch.permute.calls, len(ch.output_buffer)), (absorbed, n)


# (pending lengths, outputs left before, challenges): full chunks and a
# partial one; a last observe that refills the outputs; squeezes with
# nothing absorbed; a pure absorb with a leftover
FLUSH_KEYS = [((3, 10), 0, 5), ((8,), 0, 2), ((), 5, 7), ((16, 3), 0, 0)]


@pytest.mark.parametrize("key", FLUSH_KEYS, ids=str)
@pytest.mark.parametrize("field", list(FIELDS))
def test_flush_plain_matches_jax_flush_program(field, key):
    F, H, spec, JF, JH = FIELDS[field]
    lens, n_out, n = key
    rng = np.random.default_rng(sum(lens) + n)
    W, R = H.WIDTH, H.RATE
    state = rng.integers(0, spec.p, size=W, dtype=np.uint64)
    out_buf = rng.integers(0, spec.p, size=R, dtype=np.uint64)
    pieces = [rng.integers(0, spec.p, size=k, dtype=np.uint64)
              for k in lens]
    fn = jdc._flush_program(JF, JH, tuple(lens), n_out, n)
    js, jo, jc = fn(JF.from_ints(state), JF.from_ints(out_buf),
                    *[JF.from_ints(p) for p in pieces])
    got = _ints(F, T.transcript_flush(
        F.from_ints(state), F.from_ints(out_buf),
        [F.from_ints(p) for p in pieces], n_out, n))
    want = [int(v) for v in JF.to_ints(js)] + \
        [int(v) for v in JF.to_ints(jo)]
    if jc is not None:
        want += [int(v) for v in JF.to_ints(jc)]
    assert got == want


@pytest.mark.parametrize("field", list(FIELDS))
def test_pow_grind_plain_matches_sync_and_jax(field):
    """k of 6 PoW bits, batches of 64: the witness is the sync grinder's
    (``fri_proof_of_work`` over the host transcript) and the JAX device
    grinder's; a zero bound finds none and says so."""
    F, H, spec, JF, JH = FIELDS[field]
    bits = spec.bits - 6
    rng = np.random.default_rng(11)
    host_ch = Challenger(spec, H)
    host_ch.observe_elements([int(x) for x in rng.integers(
        0, spec.p, size=19, dtype=np.uint64)])
    L = len(host_ch.input_buffer)

    class Config:
        proof_of_work_bits = 6

    want = fri_prover.fri_proof_of_work(host_ch, Config, torch.device("cpu"),
                                        F, H)
    state = F.from_ints(host_ch.sponge_state)
    left = F.from_ints(host_ch.input_buffer)
    got = T.pow_grind_plain(state, left, bits, batch=64)
    assert _ints(F, got) == [want, 1]
    assert _ints(F, T.pow_grind(state, left, bits)[0]) == [want, 1]
    grind = jfri._grind_async_jit(JF, JH, L, JH.RATE, bits, 64)
    assert int(grind(JF.from_ints(np.array(host_ch.sponge_state,
                                           dtype=np.uint64)),
                     JF.from_ints(np.array(host_ch.input_buffer,
                                           dtype=np.uint64)))) == want
    # no witness below the answer: the search ends with the flag at 0
    assert _ints(F, T.pow_grind_plain(state, left, bits, batch=64,
                                      limit=want)) == [0, 0]
