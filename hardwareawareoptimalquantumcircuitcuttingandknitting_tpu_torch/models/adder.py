"""Cuccaro ripple-carry adder (copy of the JAX package's ``models/adder.py``).

Behavioral port of benchmarks/qcg/Arithmetic/ripple_carry_adder.py
(arXiv:quant-ph/0410184): MAJ/UMA ladders with the decomposed Toffoli by
default.
"""
from __future__ import annotations

from ..circuit.circuit import Circuit, Register


def gen_adder(
    nbits: int | None = None,
    a: int = 0,
    b: int = 0,
    use_toffoli: bool = False,
    barriers: bool = True,
    measure: bool = False,
    regname: str | None = None,
) -> Circuit:
    if nbits is None:
        raise Exception("Number of bits must be specified")
    nq = 1 + 2 * nbits + 1
    if len(f"{a:b}") > nbits or len(f"{b:b}") > nbits:
        raise Exception(
            "Binary representations of a and b must be less than or equal"
            " to nbits"
        )
    circ = Circuit([Register(regname or "q", nq)], 0, name="adder")
    if measure:
        circ.cregs = [Register("c", nq)]

    def toffoli(x, y, z):
        if use_toffoli:
            circ.ccx(x, y, z)
            return
        circ.h(z); circ.cx(y, z); circ.tdg(z); circ.cx(x, z)
        circ.t(z); circ.cx(y, z); circ.t(y); circ.tdg(z)
        circ.cx(x, z); circ.cx(x, y); circ.t(z); circ.h(z)
        circ.t(x); circ.tdg(y); circ.cx(x, y)

    def maj(x, y, z):
        circ.cx(z, y)
        circ.cx(z, x)
        toffoli(x, y, z)

    def uma(x, y, z):
        circ.x(y)
        circ.cx(x, y)
        toffoli(x, y, z)
        circ.x(y)
        circ.cx(z, x)
        circ.cx(z, y)

    high = nq - 1
    a_idx = [2 * i + 2 for i in range(nbits)]
    b_idx = [2 * i + 1 for i in range(nbits)]
    for indices, value in ((a_idx, a), (b_idx, b)):
        for i, bit in enumerate(reversed(f"{value:b}")):
            if bit == "1":
                circ.x(indices[i])

    for ai in a_idx:
        maj(ai - 2, ai - 1, ai)
    circ.cx(a_idx[-1], high)
    for ai in reversed(a_idx):
        uma(ai - 2, ai - 1, ai)

    if measure:
        circ.measure_all()
    return circ
