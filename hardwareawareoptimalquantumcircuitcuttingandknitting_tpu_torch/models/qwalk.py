"""Quantum walk circuit scaffold.

Copy of the JAX package's ``models/qwalk.py``.

Behavioral port of benchmarks/qcg/QWalk/quantum_walk.py — NOTE: the
reference's implementation is a stub (Vc and evolve_T are empty,
quantum_walk.py:151-160) and its gen_circuit returns an empty circuit over
the registers; we reproduce the same structure (4*ceil(log2 N) qubits plus
ancR/anc0 ancilla registers) for API parity.
"""
from __future__ import annotations

import math

from ..circuit.circuit import Circuit, Register


def gen_qwalk(n: int, barriers: bool = True, regname: str | None = None) -> Circuit:
    nq = math.ceil(math.log2(n)) * 4
    circ = Circuit(
        [
            Register(regname or "q", nq),
            Register("ancR", 1),
            Register("anc0", 1),
        ],
        0,
        name="qwalk",
    )
    k = 4
    t = 1

    def vc(c):  # reference Vc is a no-op stub (quantum_walk.py:151-155)
        del c

    def evolve_t(tt):  # reference evolve_T is a no-op stub (157-160)
        del tt

    for c in range(k):
        vc(c)
        evolve_t(t)
        vc(c)
    return circ
