"""The Goldilocks plain-torch arithmetic at its edge values, against python
ints (``field/host.py`` arithmetic, ``hash/poseidon_gl.py``'s host
permutation), on the CPU and on the card.

``field/gl.py:mul`` takes its four 32x32-bit limb products as int64
products that wrap mod 2^64, and ``ops/poseidon_gl.py:_mds`` sums the MDS
products of 32-bit limbs as float64 matrix products (every sum < 2^41).
Every GL kernel's plain version and both provers rest on them, so they are
held here at the values where a carry, a borrow, a wrap or a lost float
bit would show: 0, 1, the limbs' edges, 2^63, p - 1 and the products
near 2^128, every pair of them, and random values.

The card's cases are marked ``gpu`` and skip without one.  Tolerance
zero: exact field arithmetic.
"""

import itertools

import numpy as np
import pytest
import torch

from plonky2_goldibear_torch.field import gl
from plonky2_goldibear_torch.hash import poseidon_gl as H
from plonky2_goldibear_torch.ops import poseidon_gl as K

P = gl.P
M32 = (1 << 32) - 1
EDGES = sorted({0, 1, 2, M32 - 1, M32, M32 + 1, 1 << 33, (1 << 63) - 1,
                1 << 63, (1 << 63) + 1, P - 2, P - 1, (M32 - 1) << 32,
                ((M32 - 1) << 32) | M32, ((M32 - 1) << 32) | 1, 0x7FFFFFFF,
                0x80000000, (1 << 48) - 1, P >> 1, (P >> 1) + 1})

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(name)


def _values(n_random, seed):
    rng = np.random.default_rng(seed)
    return EDGES + [int(v) for v in rng.integers(0, P, size=n_random,
                                                 dtype=np.uint64)]


@pytest.mark.parametrize("device", DEVICES)
def test_int64_products_wrap(device):
    """The property ``gl.mul`` rests on: an int64 product keeps the low 64
    bits of the full product, as a u64 product does."""
    dev = _device(device)
    xs = [M32, M32 - 1, 1 << 31, (1 << 32) - 5]
    a = torch.tensor(xs, dtype=torch.int64, device=dev)
    got = (a[:, None] * a[None, :]).cpu().numpy().view(np.uint64)
    want = np.array([[x * y % (1 << 64) for y in xs] for x in xs],
                    dtype=np.uint64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("device", DEVICES)
def test_mul_at_edges(device):
    dev = _device(device)
    vals = _values(44, seed=1)
    pairs = list(itertools.product(vals, repeat=2))
    a = gl.from_ints([x for x, _ in pairs], dev)
    b = gl.from_ints([y for _, y in pairs], dev)
    got = [int(v) for v in gl.to_ints(gl.mul(a, b))]
    assert got == [x * y % P for x, y in pairs]
    # a product broadcast against a scalar, as mul_const takes it
    got = [int(v) for v in gl.to_ints(gl.mul_const(a, P - 1))]
    assert got == [x * (P - 1) % P for x, _ in pairs]


def _states(seed):
    """Poseidon states at the edges: every lane one edge value, the limbs'
    largest canonical values, alternations, and random states."""
    rng = np.random.default_rng(seed)
    states = [[v] * K.WIDTH for v in EDGES]
    states += [[EDGES[(i + j) % len(EDGES)] for j in range(K.WIDTH)]
               for i in range(len(EDGES))]
    states += [[P - 1 if j % 2 else ((M32 - 1) << 32) | M32
                for j in range(K.WIDTH)]]
    states += [[int(v) for v in row] for row in
               rng.integers(0, P, size=(8, K.WIDTH), dtype=np.uint64)]
    return states


@pytest.mark.parametrize("device", DEVICES)
def test_mds_at_edges(device):
    dev = _device(device)
    states = _states(2)
    _, mt = K._tables(str(dev))
    got = gl.to_ints(K._mds(gl.from_ints(states, dev), mt))
    want = [H.mds_layer_host(s) for s in states]
    assert [[int(v) for v in row] for row in got] == want


@pytest.mark.parametrize("device", DEVICES)
def test_sbox_and_permutation_at_edges(device):
    dev = _device(device)
    vals = _values(12, seed=3)
    got = gl.to_ints(K._sbox(gl.from_ints(vals, dev)))
    assert [int(v) for v in got] == [H.sbox_host(x) for x in vals]
    states = _states(4)
    got = gl.to_ints(K.permute_plain(gl.from_ints(states, dev)))
    assert [[int(v) for v in row] for row in got] == \
        [H.permute_host(s) for s in states]
