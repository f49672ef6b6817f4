"""Hamiltonian-dynamics simulation circuits.

Copy of the JAX package's ``models/dynamics.py``.

Behavioral port of benchmarks/qcg/Dynamics/quantum_dynamics.py (N&C §4.7):
per Pauli-string term, basis change to Z, CNOT parity ladder onto an ancilla,
rz phase, uncompute.
"""
from __future__ import annotations

from ..circuit.circuit import Circuit, Register


def gen_dynamics(
    H: list[str],
    barriers: bool = False,
    measure: bool = False,
    regname: str | None = None,
) -> Circuit:
    nq = max(len(term) for term in H)
    circ = Circuit(
        [Register(regname or "q", nq), Register("ancQ", 1)], 0,
        name="dynamics",
    )
    anc = nq

    def compute_to_z(pauli_str):
        for i, pauli in enumerate(pauli_str):
            if pauli == "X":
                circ.h(i)
            elif pauli == "Y":
                circ.h(i)
                circ.s(i)

    def uncompute_to_z(pauli_str):
        for i, pauli in enumerate(pauli_str):
            if pauli == "X":
                circ.h(i)
            elif pauli == "Y":
                circ.sdg(i)
                circ.h(i)

    def phase_shift(delta_t):
        for i in range(nq):
            circ.cx(i, anc)
        circ.rz(2 * delta_t, anc)
        for i in range(nq - 1, -1, -1):
            circ.cx(i, anc)

    for term in H:
        compute_to_z(term)
        if barriers:
            circ.barrier()
        phase_shift(1)
        if barriers:
            circ.barrier()
        uncompute_to_z(term)
        if barriers:
            circ.barrier()

    if measure:
        circ.measure_all()
    return circ
