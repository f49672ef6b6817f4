"""The port's n-tangle (``utils/entanglement.py``) against the JAX
package's: the sign table, the measure on fixed and random states, and
the end-to-end circuit flow with the statevector on the CPU."""
import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.hwea import (  # noqa: E501
    gen_hwea as j_gen_hwea,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.utils import (
    entanglement as j_ent,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.utils import (  # noqa: E501
    entanglement as t_ent,
)
from torch_port_common import to_port


def _states():
    rng = np.random.default_rng(7)
    out = []
    for n in (2, 4, 6):
        a = np.zeros(1 << n, complex)
        a[0] = a[-1] = 1 / np.sqrt(2)
        out.append(a)
    w = np.zeros(16, complex)
    for q in range(4):
        w[1 << q] = 0.5
    out.append(w)
    r = rng.normal(size=64) + 1j * rng.normal(size=64)
    out.append(r / np.linalg.norm(r))
    p = np.zeros(16, complex)
    p[0], p[-1] = np.cos(0.35), np.sin(0.35)
    out.append(p)
    return out


def test_n_tangle_and_sign_table_match_jax():
    for n in (2, 4, 6, 8):
        i = np.arange(1 << (n - 2))
        np.testing.assert_array_equal(t_ent.sgn_star(n, i),
                                      j_ent.sgn_star(n, i))
    for a in _states():
        n = a.size.bit_length() - 1
        assert t_ent.n_tangle(a, n) == j_ent.n_tangle(a, n)
        rep = np.stack([a.real, a.imag])
        assert t_ent.n_tangle(rep) == j_ent.n_tangle(rep)
    with pytest.raises(ValueError):
        t_ent.n_tangle(np.eye(8)[0], 3)


@pytest.mark.parametrize("n,depth", [(6, 1), (4, 2)])
def test_circuit_n_tangle_matches_jax(n, depth):
    circ = j_gen_hwea(n, depth)
    want = j_ent.circuit_n_tangle(circ)
    got = t_ent.circuit_n_tangle(to_port(circ), device="cpu")
    assert abs(got - want) < 1e-6
