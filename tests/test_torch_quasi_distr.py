"""The port's sparse quasi-distribution (``virt/quasi_distr.py``) against
the JAX package's: every operation on the same seeded operands gives the
same keys and values."""
import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.quasi_distr import (  # noqa: E501
    QuasiDistr as JQ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.quasi_distr import (  # noqa: E501
    QuasiDistr as TQ,
)


def _pairs(rng, bits, n, lo=0):
    keys = rng.integers(0, 1 << bits, n) << lo
    vals = rng.normal(size=n) * 0.3
    vals[::7] = 1e-7  # below the pruning tolerance
    return list(zip(keys.tolist(), vals.tolist()))


def _eq(t, j):
    assert isinstance(t, TQ)
    np.testing.assert_array_equal(t.keys, j.keys)
    np.testing.assert_array_equal(t.vals, j.vals)


@pytest.mark.parametrize("seed", range(3))
def test_algebra_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pa, pb = _pairs(rng, 4, 12), _pairs(rng, 3, 9, lo=4)
    ja, jb = JQ.from_pairs(pa), JQ.from_pairs(pb)
    ta, tb = TQ.from_pairs(pa), TQ.from_pairs(pb)
    _eq(ta, ja)
    _eq(ta + tb, ja + jb)
    _eq(ta - tb, ja - jb)
    _eq(ta * 2.5, ja * 2.5)
    _eq(0.5 * tb, 0.5 * jb)
    _eq(ta.merge(tb), ja.merge(jb))
    _eq(ta * tb, ja * jb)
    for bit in (0, 2, 5):
        for t, j in zip(ta.split(bit), ja.split(bit)):
            _eq(t, j)
    _eq(ta.nearest_probability_distribution(),
        ja.nearest_probability_distribution())
    assert ta.to_counts(7, 1000) == ja.to_counts(7, 1000)
    np.testing.assert_array_equal(ta.to_dense(7), ja.to_dense(7))
    _eq(TQ.from_dense(ta.to_dense(7)), JQ.from_dense(ja.to_dense(7)))
    assert ta.to_dict() == ja.to_dict() and len(ta) == len(ja)
    assert list(ta) == list(ja) and list(ta.items()) == list(ja.items())
    key = int(ta.keys[0])
    assert ta[key] == ja[key] and ta.get(-1, 3.0) == 3.0


def test_counts_round_trip_matches_jax():
    counts = {"101": 250, "010": 700, "111": 50}
    _eq(TQ.from_counts(counts), JQ.from_counts(counts))
    assert TQ.from_counts(counts).to_counts(3, 1000) == counts
    _eq(TQ.from_counts({}), JQ.from_counts({}))
