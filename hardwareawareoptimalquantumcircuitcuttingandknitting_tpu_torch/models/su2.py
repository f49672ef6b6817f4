"""EfficientSU2 ansatz (qiskit.circuit.library.EfficientSU2 semantics).

Copy of the JAX package's ``models/su2.py``.

Reference usage: generateEfficientSu2 (benchmarks/helper_functions.py:144-152):
linear entanglement, reps=2, parameters bound to randn()/2.
"""
from __future__ import annotations

import numpy as np

from ..circuit.circuit import Circuit, Register


def efficient_su2(
    num_qubits: int,
    entanglement: str = "linear",
    reps: int = 2,
    params=None,
    measure: bool = False,
    regname: str | None = None,
) -> Circuit:
    nq = num_qubits
    n_params = 2 * nq * (reps + 1)
    if params is None:
        params = np.random.randn(n_params) / 2
    params = list(params)
    assert len(params) == n_params

    circ = Circuit([Register(regname or "q", nq)], 0, name="su2")
    p = 0

    def rotation_layer():
        nonlocal p
        for q in range(nq):
            circ.ry(params[p + q], q)
        p += nq
        for q in range(nq):
            circ.rz(params[p + q], q)
        p += nq

    def entangle_layer():
        if entanglement == "linear":
            for q in range(nq - 1):
                circ.cx(q, q + 1)
        elif entanglement == "full":
            for a in range(nq):
                for b in range(a + 1, nq):
                    circ.cx(a, b)
        elif entanglement == "circular":
            circ.cx(nq - 1, 0)
            for q in range(nq - 1):
                circ.cx(q, q + 1)
        else:
            raise ValueError(entanglement)

    rotation_layer()
    for _ in range(reps):
        entangle_layer()
        rotation_layer()
    if measure:
        circ.measure_all()
    return circ
