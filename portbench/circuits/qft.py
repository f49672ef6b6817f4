"""The quantum Fourier transform on a product phase state (the reference
benchmark's ``genCirc("qft", n, 1)``, qiskit's ``QFT(n, do_swaps=False)``,
after an input preparation): per qubit an ``h`` then an ``rz(u)``, with
``u`` uniform in [0, 2 pi) from ``numpy.random.default_rng(seed)``; then
the transform's gates (:func:`qft_gates`), no swaps.

The angles make the readout stage of phase estimation: the QFT of
|0...0> alone is the uniform distribution.  The gates and their qubits
do not depend on the seed, so one cut plan fits every instance.
``depth`` is the reference's repetition argument and must be 1.
"""
import math

import numpy as np


def qft_gates(num_qubits: int) -> list:
    """qiskit's ``QFT(n, do_swaps=False)`` in its order: for ``j`` from
    ``n - 1`` down to 0 an ``h`` on ``j``, then for ``k`` from ``j - 1``
    down to 0 a ``cp(pi * 2^(k - j))`` on ``(j, k)``."""
    gates = []
    for j in reversed(range(num_qubits)):
        gates.append(("h", (j,), ()))
        for k in reversed(range(j)):
            gates.append(("cp", (j, k), (math.pi * 2.0 ** (k - j),)))
    return gates


def generate(num_qubits: int, depth: int, seed: int):
    if depth != 1:
        raise ValueError(f"the qft family has depth 1, not {depth}")
    rng = np.random.default_rng(seed)
    gates = []
    for q in range(num_qubits):
        gates.append(("h", (q,), ()))
        gates.append(("rz", (q,), (float(rng.uniform(0, 2 * math.pi)),)))
    gates.extend(qft_gates(num_qubits))
    return {"num_qubits": num_qubits, "gates": gates, "measure_all": True}
