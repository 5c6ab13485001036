"""The port's permutation-argument retry against the JAX package's, on the
CPU.

- ``iop/generator.py:rand_field_element`` draws what the JAX function
  draws: the reference's counter RNG (``set_nonrandom``) against
  ``NonRandomRng``, and ``seed_randomness(seed)`` against
  ``np.random.default_rng(seed)``, for both primes.
- A prove whose first attempts fail with ``InvZeroPermArg`` redraws the
  random wire from the counter the JAX retry recorded, and the retried
  proof equals the stored JAX retry proof in every phase (the fixtures
  ``arith_chain{,_bb}_2e6_retry.npz``, written by
  ``tests/test_torch_prove.py --write-fixtures --retry``).
- ``partial_products`` reports a zero denominator.

Tolerance zero throughout: exact field arithmetic and integer draws.
"""

import numpy as np
import pytest
import torch

from plonky2_goldibear_tpu.iop import generator as jgen

from plonky2_goldibear_torch.field import host
from plonky2_goldibear_torch.iop.generator import (NonRandomRng,
                                                   rand_field_element)
from plonky2_goldibear_torch.plonk import prover
from plonky2_goldibear_torch.plonk.circuit_data import (fixture_path,
                                                        load_fixture)
from plonky2_goldibear_torch.plonk.proof import PROOF_PHASES, flatten_proof

torch.set_num_threads(1)
DRAWS = 1000
PRIMES = [pytest.param(host.GOLDILOCKS.p, id="goldilocks"),
          pytest.param(host.BABYBEAR.p, id="babybear")]
FIELDS = ("goldilocks", "babybear")


@pytest.fixture
def jax_rng_state():
    """Restore the JAX package's module-global RNG state after a test."""
    counter, rng = jgen._NONRANDOM_COUNTER, jgen._RNG
    yield
    jgen._NONRANDOM_COUNTER, jgen._RNG = counter, rng


def _check_range(p, values, above_2_62=False):
    """Every value in [0, p); with ``above_2_62``, Goldilocks draws reach
    above 2^62 (the old torch draw never did)."""
    assert all(0 <= v < p for v in values)
    if above_2_62 and p > 1 << 32:
        assert any(v >= 1 << 62 for v in values)


@pytest.mark.parametrize("p", PRIMES)
def test_counter_draws_match_jax(p, jax_rng_state):
    jgen.set_nonrandom(True)
    want = [jgen.rand_field_element(p) for _ in range(DRAWS)]
    rng = NonRandomRng()
    got = [rand_field_element(p, rng) for _ in range(DRAWS)]
    assert got == want
    assert rng.counter == jgen._NONRANDOM_COUNTER
    _check_range(p, got)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("start", [1, 1 << 20, (1 << 64) - 3])
def test_counter_draws_from_any_start_match_jax(p, start, jax_rng_state):
    """A counter that has moved on (witness generation drew first), also
    across the u64 wrap."""
    jgen.set_nonrandom(True)
    jgen._NONRANDOM_COUNTER = start
    want = [jgen.rand_field_element(p) for _ in range(8)]
    rng = NonRandomRng(start)
    got = [rand_field_element(p, rng) for _ in range(8)]
    assert got == want
    _check_range(p, got, above_2_62=start > 1 << 63)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("seed", [0, 12345])
def test_seeded_draws_match_jax(p, seed, jax_rng_state):
    jgen.set_nonrandom(False)
    jgen.seed_randomness(seed)
    want = [jgen.rand_field_element(p) for _ in range(DRAWS)]
    rng = np.random.default_rng(seed)
    got = [rand_field_element(p, rng) for _ in range(DRAWS)]
    assert got == want
    _check_range(p, got, above_2_62=True)


# -- the retried prove -----------------------------------------------------


@pytest.fixture(scope="module")
def retried():
    """(stored retry arrays, the port's retried proof flattened, the values
    its later attempts found at the random wire) of each field's 2^6
    fixture, its first attempts made to fail as the fixture's were; proved
    on the CPU once per module."""
    cache = {}

    def get(field):
        if field in cache:
            return cache[field]
        circuit, _ = load_fixture(6, device="cpu", field=field)
        with np.load(fixture_path(6, field, retry=True)) as z:
            arrays = {k: z[k] for k in z.files}
        failures = len(arrays["values"])
        real = prover._internal_prove
        seen = []

        def internal_prove(circuit_, wires, timings, rng):
            seen.append(wires)
            if len(seen) <= failures:
                raise prover.InvZeroPermArg()
            return real(circuit_, wires, timings, rng)

        prover._internal_prove = internal_prove
        try:
            proof = prover.prove(circuit, device="cpu",
                                 rng=NonRandomRng(int(arrays["counter"])))
        finally:
            prover._internal_prove = real
        assert len(seen) == failures + 1
        row, col = circuit.random_wire
        for before, after in zip(seen, seen[1:]):
            changed = (before != after).nonzero().tolist()
            assert changed in ([], [[col, row]])
        wire = [int(circuit.F.to_ints(w[col, row:row + 1])[0])
                for w in seen[1:]]
        cache[field] = (arrays, flatten_proof(proof), wire)
        return cache[field]

    return get


@pytest.mark.parametrize("field", FIELDS)
def test_retry_redraws_the_jax_values(retried, field):
    arrays, _, wire = retried(field)
    assert wire == [int(v) for v in arrays["values"]]


@pytest.mark.parametrize("field,phase", [
    pytest.param(f, ph, id=f"{f}-{ph}") for f in FIELDS
    for ph in PROOF_PHASES])
def test_retry_proof_phase_matches_jax(retried, field, phase):
    arrays, flat, _ = retried(field)
    np.testing.assert_array_equal(flat[phase], arrays["proof_" + phase])


def test_retry_draws_no_torch_random():
    """The retry's value comes from ``rand_field_element``, never from
    torch's generator."""
    import plonky2_goldibear_torch.plonk.prover as mod

    assert "randint" not in open(mod.__file__).read()


# -- the zero-denominator report -------------------------------------------


@pytest.mark.parametrize("field", FIELDS)
def test_partial_products_reports_a_zero_denominator(field):
    circuit, _ = load_fixture(6, device="cpu", field=field)
    F, common = circuit.F, circuit.common
    num_routed = common.config.num_routed_wires
    routed = circuit.wires[:num_routed]
    s_id = prover._quotient_data(circuit).s_id
    p = F.P
    beta = 123456789 % p
    # gamma = -(w + sigma beta) at (wire 3, row 5) makes that denominator 0
    w = int(F.to_ints(routed[3, 5:6])[0])
    sigma = int(F.to_ints(circuit.sigmas[3, 5:6])[0])
    zero_gamma = (-(w + sigma * beta)) % p
    for gamma, want in ((zero_gamma, True), ((zero_gamma + 1) % p, False)):
        scal = lambda v: F.from_ints([v], "cpu")[0]     # noqa: E731
        _, any_zero = prover.partial_products(
            F, common, routed, s_id, circuit.sigmas, [scal(beta)],
            [scal(gamma)])
        assert bool(any_zero) == want
