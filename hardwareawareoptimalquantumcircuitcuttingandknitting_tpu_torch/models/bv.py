"""Bernstein–Vazirani circuits (copy of the JAX package's ``models/bv.py``).

Behavioral port of benchmarks/qcg/BernsteinVazirani/bernstein_vazirani.py.
"""
from __future__ import annotations

from ..circuit.circuit import Circuit, Register


def gen_BV(
    secret=None,
    barriers: bool = True,
    measure: bool = False,
    regname: str | None = None,
) -> Circuit:
    if secret is None:
        raise Exception(
            "Provide a secret bitstring for the Bernstein-Vazirani circuit,"
            " example: 001101"
        )
    secret = str(secret)
    nq = len(secret)
    circ = Circuit([Register(regname or "q", nq + 1)], 0, name="bv")
    if measure:
        circ.cregs = [Register("c", nq)]

    circ.x(nq)                      # ancilla (last qubit) to |1>
    for q in range(nq + 1):
        circ.h(q)
    # secret is little endian — index 0 at the top of the circuit
    for i, bit in enumerate(secret[::-1]):
        if bit == "1":
            circ.cx(i, nq)
    if barriers:
        circ.barrier()
    for q in range(nq + 1):
        circ.h(q)
    if measure:
        for q in range(nq):
            circ.measure(q, q)
    return circ
