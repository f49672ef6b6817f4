"""Random circuits (qiskit.circuit.random.random_circuit role).

Copy of the JAX package's ``models/random_circuit.py``.

Reference usage: generateRandomCircuit (benchmarks/helper_functions.py:132-136).
Layered random 1q/2q gates over the engine's native gate set.
"""
from __future__ import annotations

import random as rand

import numpy as np

from ..circuit.circuit import Circuit, Register

_ONE_Q = ["id", "x", "y", "z", "h", "s", "sdg", "t", "tdg", "sx"]
_ONE_Q_P = ["rx", "ry", "rz", "p"]
_TWO_Q = ["cx", "cy", "cz", "swap"]
_TWO_Q_P = ["cp", "rzz", "crz"]


def random_circuit(
    num_qubits: int, depth: int, seed: int | None = None, measure: bool = False
) -> Circuit:
    rng = rand.Random(seed)
    circ = Circuit([Register("q", num_qubits)], 0, name="random")
    for _ in range(depth):
        qubits = list(range(num_qubits))
        rng.shuffle(qubits)
        while qubits:
            if len(qubits) > 1 and rng.random() < 0.5:
                a, b = qubits.pop(), qubits.pop()
                name = rng.choice(_TWO_Q + _TWO_Q_P)
                if name in _TWO_Q_P:
                    circ._g(name, [a, b], [rng.uniform(0, 2 * np.pi)])
                else:
                    circ._g(name, [a, b])
            else:
                q = qubits.pop()
                name = rng.choice(_ONE_Q + _ONE_Q_P)
                if name in _ONE_Q_P:
                    circ._g(name, [q], [rng.uniform(0, 2 * np.pi)])
                else:
                    circ._g(name, [q])
    if measure:
        circ.measure_all()
    return circ
