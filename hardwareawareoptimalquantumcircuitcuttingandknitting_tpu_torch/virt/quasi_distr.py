"""Sparse signed quasi-distribution algebra.

Capability parity with the reference's host-side knitting data structure
(third_party/qvm/qvm/quasi_distr.py:6-86): a signed sparse map from
little-endian outcome keys to quasi-probability weights, with the merge /
split / signed-arithmetic operations the dict-based knit uses.  The TPU
pipeline knits with dense tensors (ops/knit.py); this module exists for
users of the reference API and for differential testing of the tensor path
against the sparse path.

Representation: parallel ``keys`` (int64) / ``vals`` (float64) arrays kept
sorted by key — set-algebra operations become vectorised merges instead of
Python dict loops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Mapping

import numpy as np

PRUNE_TOL = 1e-5  # reference: quasi_distr.py:3 (ACCURACY)


def _normalize(keys: np.ndarray, vals: np.ndarray, prune: float):
    """Sort by key, sum duplicates, drop |v| <= prune."""
    if keys.size == 0:
        return keys.astype(np.int64), vals.astype(np.float64)
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    uniq, start = np.unique(keys, return_index=True)
    sums = np.add.reduceat(vals, start)
    live = np.abs(sums) > prune
    return uniq[live].astype(np.int64), sums[live].astype(np.float64)


@dataclass(frozen=True)
class QuasiDistr:
    """Immutable sparse signed distribution over little-endian bit keys.

    Implements the read side of the mapping protocol (``q[key]``, ``len``,
    iteration over keys, ``get``, ``items``) without subclassing Mapping —
    the ``keys``/``vals`` arrays double as the storage and the API.
    """

    keys: np.ndarray
    vals: np.ndarray

    # -- construction -----------------------------------------------------

    @staticmethod
    def from_pairs(pairs, prune: float = PRUNE_TOL) -> "QuasiDistr":
        items = list(pairs.items() if isinstance(pairs, Mapping) else pairs)
        if not items:
            return QuasiDistr(np.empty(0, np.int64), np.empty(0, np.float64))
        k = np.array([int(k) for k, _ in items], dtype=np.int64)
        v = np.array([float(v) for _, v in items], dtype=np.float64)
        return QuasiDistr(*_normalize(k, v, prune))

    @staticmethod
    def from_counts(counts: Mapping[str, int]) -> "QuasiDistr":
        """Bitstring counts -> normalised distribution (reference:
        quasi_distr.py:13-20; bitstrings are MSB-first, keys little-endian
        over clbits)."""
        shots = sum(counts.values())
        if shots == 0:
            return QuasiDistr.from_pairs({})
        return QuasiDistr.from_pairs(
            {int(bits.replace(" ", ""), 2): n / shots
             for bits, n in counts.items()}
        )

    @staticmethod
    def from_dense(values: np.ndarray, prune: float = PRUNE_TOL):
        values = np.asarray(values, dtype=np.float64)
        keys = np.nonzero(np.abs(values) > prune)[0]
        return QuasiDistr(keys.astype(np.int64), values[keys])

    # -- Mapping protocol -------------------------------------------------

    def __getitem__(self, key: int) -> float:
        i = np.searchsorted(self.keys, key)
        if i < self.keys.size and self.keys[i] == key:
            return float(self.vals[i])
        raise KeyError(key)

    def __iter__(self) -> Iterator[int]:
        return iter(int(k) for k in self.keys)

    def __len__(self) -> int:
        return int(self.keys.size)

    def get(self, key: int, default: float = 0.0) -> float:
        try:
            return self[key]
        except KeyError:
            return default

    def items(self) -> Iterator[tuple[int, float]]:
        return ((int(k), float(v)) for k, v in zip(self.keys, self.vals))

    # -- conversions ------------------------------------------------------

    def to_counts(self, num_clbits: int, shots: int) -> dict[str, int]:
        """Integer counts, reference-exact semantics (quasi_distr.py:22-26):
        keys are MSB-first bitstrings zero-padded to ``num_clbits``, counts
        are ``int(abs(value * shots))`` — negative weights contribute their
        magnitude, matching the reference's drop-in API."""
        out: dict[str, int] = {}
        for k, v in zip(self.keys, self.vals):
            out[format(int(k), "b").zfill(num_clbits)] = int(
                abs(float(v) * shots)
            )
        return out

    def to_dense(self, num_bits: int) -> np.ndarray:
        dense = np.zeros(1 << num_bits, dtype=np.float64)
        dense[self.keys] = self.vals
        return dense

    def to_dict(self) -> dict[int, float]:
        return {int(k): float(v) for k, v in zip(self.keys, self.vals)}

    # -- algebra (reference: quasi_distr.py:45-86) ------------------------

    def __add__(self, other: "QuasiDistr") -> "QuasiDistr":
        return QuasiDistr(*_normalize(
            np.concatenate([self.keys, other.keys]),
            np.concatenate([self.vals, other.vals]),
            PRUNE_TOL,
        ))

    def __sub__(self, other: "QuasiDistr") -> "QuasiDistr":
        return QuasiDistr(*_normalize(
            np.concatenate([self.keys, other.keys]),
            np.concatenate([self.vals, -other.vals]),
            PRUNE_TOL,
        ))

    def __mul__(self, other):
        if isinstance(other, QuasiDistr):
            return self.merge(other)
        return QuasiDistr(self.keys.copy(), self.vals * float(other))

    __rmul__ = __mul__

    def merge(self, other: "QuasiDistr") -> "QuasiDistr":
        """Cartesian product with XOR-combined keys and multiplied values
        (reference: quasi_distr.py:55-60).  Correct when the two operands
        occupy disjoint clbit positions — the invariant the fragmenter
        maintains (qvm/virtual_circuit.py:116-131)."""
        if len(self) == 0 or len(other) == 0:
            return QuasiDistr.from_pairs({})
        kk = np.bitwise_xor.outer(self.keys, other.keys).reshape(-1)
        vv = np.multiply.outer(self.vals, other.vals).reshape(-1)
        return QuasiDistr(*_normalize(kk, vv, PRUNE_TOL))

    def split(self, bit_index: int) -> tuple["QuasiDistr", "QuasiDistr"]:
        """Partition on one clbit, clearing it in both halves (reference:
        quasi_distr.py:45-53).  Returns (bit==0 part, bit==1 part)."""
        mask = np.int64(1) << np.int64(bit_index)
        is_one = (self.keys & mask) != 0
        zeros = QuasiDistr(self.keys[~is_one], self.vals[~is_one])
        ones = QuasiDistr(self.keys[is_one] & ~mask, self.vals[is_one])
        return zeros, ones

    def nearest_probability_distribution(self) -> "QuasiDistr":
        """Project onto the probability simplex, smallest-weight-first
        (Smolin et al.; reference: quasi_distr.py:28-43)."""
        order = np.argsort(self.vals, kind="stable")
        vals = self.vals[order].copy()
        keys = self.keys[order]
        beta = 0.0
        live = vals.size
        out = np.zeros_like(vals)
        for i in range(vals.size):
            share = vals[i] + beta / live
            if share < 0:
                beta += vals[i]
                live -= 1
            else:
                out[i:] = vals[i:] + beta / live
                break
        keep = out > 0
        return QuasiDistr(*_normalize(keys[keep], out[keep], 0.0))
