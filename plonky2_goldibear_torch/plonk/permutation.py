"""Permutation argument: the disjoint-set forest of copy constraints and the
sigma polynomials (reference plonky2/src/plonk/permutation_argument.rs:
13-158; the JAX package's ``plonk/permutation.py``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..iop import target as tgt


class Forest:
    """Union-find over dense target indices (wires row-major, then virtual
    targets).  ``parents`` is a python list while copies are merged and a
    numpy array after ``compress_paths``."""

    def __init__(self, num_wires: int, num_routed_wires: int, degree: int,
                 num_virtual_targets: int):
        self.num_wires = num_wires
        self.num_routed_wires = num_routed_wires
        self.degree = degree
        self.parents = list(range(num_wires * degree + num_virtual_targets))

    def target_index(self, t: tgt.Target) -> int:
        return tgt.target_index(t, self.num_wires, self.degree)

    def find(self, x: int) -> int:
        parents = self.parents
        rep = x
        while parents[rep] != rep:
            rep = parents[rep]
        while parents[x] != x:
            parents[x], x = rep, parents[x]
        return int(rep)

    def merge(self, ta: tgt.Target, tb: tgt.Target):
        xa = self.find(self.target_index(ta))
        xb = self.find(self.target_index(tb))
        if xa != xb:
            self.parents[xb] = xa

    def compress_paths(self):
        """Point every index at its representative (pointer jumping)."""
        p = np.asarray(self.parents, dtype=np.int64)
        while True:
            pp = p[p]
            if np.array_equal(pp, p):
                break
            p = pp
        self.parents = p

    def wire_partition(self) -> "WirePartition":
        """The routed wires' representatives, in row-major scan order
        (reference permutation_argument.rs:88-106)."""
        reps = np.asarray(self.parents)[: self.degree * self.num_wires]
        return WirePartition(reps.reshape(self.degree, self.num_wires)
                             [:, : self.num_routed_wires])


class WirePartition:
    """The copy classes of the routed wires: ``reps`` (degree,
    num_routed_wires) holds each wire's representative."""

    def __init__(self, reps: np.ndarray):
        self.reps = reps

    def get_sigma_map(self, degree: int, num_routed_wires: int) -> np.ndarray:
        """sigma: [k*n] -> [k*n], wire (col, row) -> index col*degree+row of
        its successor in its copy class, the classes taken in row-major
        scan order and closed into cycles (reference
        permutation_argument.rs:131-157)."""
        r = self.reps.reshape(-1)             # scan index row*k + col
        order = np.argsort(r, kind="stable")  # classes, each in scan order
        rs = r[order]
        starts = np.flatnonzero(np.r_[True, rs[1:] != rs[:-1]])
        first = np.repeat(order[starts], np.diff(np.r_[starts, len(r)]))
        nxt = np.r_[order[1:], order[:1]]
        last = np.r_[rs[1:] != rs[:-1], True]
        succ = np.empty_like(order)
        succ[order] = np.where(last, first, nxt)
        rows, cols = np.divmod(np.arange(len(r)), num_routed_wires)
        nrows, ncols = np.divmod(succ, num_routed_wires)
        sigma = np.empty(len(r), dtype=np.int64)
        sigma[cols * degree + rows] = ncols * degree + nrows
        return sigma

    def get_sigma_polys(self, degree_log: int, k_is: List[int],
                        subgroup: List[int], p: int) -> np.ndarray:
        """(num_routed_wires, degree) uint64 values: sigma poly j at row i is
        k_{col(sigma)} * g^{row(sigma)}, multiplied as python ints."""
        degree = 1 << degree_log
        sigma = self.get_sigma_map(degree, len(k_is))
        k_arr = np.array(k_is, dtype=object)
        sub_arr = np.array(subgroup, dtype=object)
        vals = (k_arr[sigma // degree] * sub_arr[sigma % degree]) % p
        return vals.astype(np.uint64).reshape(len(k_is), degree)
