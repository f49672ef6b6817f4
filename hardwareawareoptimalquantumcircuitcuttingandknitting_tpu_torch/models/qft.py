"""QFT / AQFT circuits (copy of the JAX package's ``models/qft.py``).

Two variants, matching the two paths the reference uses:
  * ``library_qft`` — qiskit.circuit.library.QFT semantics
    (benchmarks/helper_functions.py:84-93): the `approximation_degree`
    drops the smallest-angle controlled-phase rotations; `do_swaps=False`.
  * ``gen_qft`` — the qcg-style generator (benchmarks/qcg/QFT/qft_circ.py)
    whose `approximation_degree` is a *keep* threshold on k−j+1.
"""
from __future__ import annotations

import numpy as np

from ..circuit.circuit import Circuit, Register


def library_qft(
    num_qubits: int,
    approximation_degree: int = 0,
    do_swaps: bool = False,
    measure: bool = False,
    regname: str | None = None,
) -> Circuit:
    circ = Circuit([Register(regname or "q", num_qubits)], 0, name="qft")
    if measure:
        circ.cregs = [Register("c", num_qubits)]
    for j in reversed(range(num_qubits)):
        circ.h(j)
        num_entanglements = max(
            0, j - max(0, approximation_degree - (num_qubits - j - 1))
        )
        for k in reversed(range(j - num_entanglements, j)):
            lam = np.pi * (2.0 ** (k - j))
            circ.cp(lam, j, k)
    if do_swaps:
        for i in range(num_qubits // 2):
            circ.swap(i, num_qubits - i - 1)
    if measure:
        circ.barrier()
        for q in range(num_qubits):
            circ.measure(q, q)
    return circ


def gen_qft(
    width: int,
    approximation_degree: int,
    inverse: bool = False,
    kvals: bool = False,
    barriers: bool = True,
    measure: bool = False,
    regname: str | None = None,
) -> Circuit:
    nq = width
    circ = Circuit([Register(regname or "q", nq)], 0, name="qft")
    if measure:
        circ.cregs = [Register(("c" + regname) if regname else "c", nq)]

    if inverse:
        for j in range(nq - 1, -1, -1):
            for k in range(nq - 1, j, -1):
                ang = (
                    -1 * (k - j + 1)
                    if kvals
                    else -2 * np.pi / (2 ** (k - j + 1))
                )
                circ.cu1(ang, k, j)
            circ.h(j)
            if barriers:
                circ.barrier()
    else:
        for j in range(nq):
            circ.h(j)
            for k in range(j + 1, nq):
                if kvals:
                    circ.cu1(k - j + 1, k, j)
                elif k - j + 1 <= approximation_degree:
                    circ.cu1(2 * np.pi / (2 ** (k - j + 1)), k, j)
            if barriers:
                circ.barrier()

    if measure:
        circ.barrier()
        for q in range(nq):
            circ.measure(q, q)
    return circ
