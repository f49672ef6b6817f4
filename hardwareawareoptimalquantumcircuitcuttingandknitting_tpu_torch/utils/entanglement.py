"""Global entanglement measures for circuit statevectors.

TPU-native equivalent of the reference's entanglement-measure scratch
(benchmarks/qcg/utils/testhwea.py:16-45): the *n-tangle* tau_n of an
even-qubit pure state (Wong & Christensen's generalized concurrence),

    tau_n = 2 | sum_i sgn*(i) (a[2i] a[2^n-1-2i] - a[2i+1] a[2^n-2-2i]) |

with the reference's sign convention sgn*(i) = (-1)^popcount(i) on the
first half of the reduced index range and (-1)^(n+popcount(i)) on the
second (testhwea.py:16-31).  The reference evaluates this with a Python
loop over 2^(n-2) terms against an Aer statevector; here the whole sum is
one vectorized contraction over the amplitude vector, so it runs on
device for sharded statevectors just as well as on host numpy.

Port of the JAX package's ``utils/entanglement.py``: the statevector of
:func:`circuit_n_tangle` runs on ``device`` (None = the card) and is
fetched for the numpy sum.
"""
from __future__ import annotations

import numpy as np


def _popcount(i: np.ndarray) -> np.ndarray:
    out = np.zeros_like(i)
    v = i.copy()
    while v.any():
        out += v & 1
        v >>= 1
    return out


def sgn_star(n: int, i: np.ndarray) -> np.ndarray:
    """Vectorized sign table of the n-tangle sum (testhwea.py:16-31).

    Defined for 0 <= i < 2^(n-2); the reference exits on out-of-range i,
    here we raise."""
    i = np.asarray(i)
    if n == 2:
        return np.ones_like(i)
    if np.any(i < 0) or np.any(i >= 1 << (n - 2)):
        raise ValueError("i out of range for sgn*")
    ni = _popcount(i)
    second_half = i >= 1 << (n - 3)
    return np.where(second_half, (-1) ** (n + ni), (-1) ** ni)


def n_tangle(amplitudes, n: int | None = None) -> float:
    """n-tangle of a pure state given its 2^n amplitude vector
    (testhwea.py:34-42 semantics, vectorized).

    ``amplitudes`` may be complex [2^n] or the engine's real-rep
    ``[2, 2^n]`` block (ops/statevector.run_statevector output).  Defined
    for even ``n``.

    Convention note (preserved reference quirk): like testhwea.py:42 this
    returns the UN-squared ``2|sum| = |<psi*| sigma_y^(x)n |psi>|`` (the
    n-concurrence); Wong & Christensen's tau_n is this value squared.
    """
    a = np.asarray(amplitudes)
    if a.ndim == 2 and a.shape[0] == 2:
        a = a[0] + 1j * a[1]
    a = a.reshape(-1)
    size = a.shape[0]
    if n is None:
        n = size.bit_length() - 1
    if 1 << n != size:
        raise ValueError(f"amplitude vector of {size} is not 2^{n}")
    if n % 2:
        raise ValueError("the n-tangle is defined for even n")
    i = np.arange(1 << (n - 2))
    s = sgn_star(n, i)
    total = np.sum(
        s * (a[2 * i] * a[(size - 1) - 2 * i]
             - a[2 * i + 1] * a[(size - 2) - 2 * i])
    )
    return float(2.0 * abs(total))


def circuit_n_tangle(circ, device=None) -> float:
    """n-tangle of a circuit's output state (the reference scratch's
    end-to-end flow: gen_hwea -> statevector -> tau).  ``device``: where
    the statevector runs (None = "cuda", raises without a card)."""
    from ..ops.statevector import compile_circuit, run_statevector

    compiled = compile_circuit(circ)
    state = run_statevector(compiled, device).cpu().numpy()
    return n_tangle(state, compiled.num_sim_qubits)
