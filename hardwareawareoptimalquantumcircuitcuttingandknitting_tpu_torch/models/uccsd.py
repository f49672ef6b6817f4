"""UCCSD VQE ansatz (copy of the JAX package's ``models/uccsd.py``).

Behavioral port of benchmarks/qcg/VQE/uccsd_ansatz.py (Whitfield et al 2010,
Table A1): double/single excitation operators with CNOT ladders and basis
changes (H / Rx(±π/2)).
"""
from __future__ import annotations

import math

import numpy as np

from ..circuit.circuit import Circuit, Register


def gen_uccsd(
    width: int,
    parameters: str = "random",
    seed: int | None = None,
    barriers: bool = False,
    regname: str | None = None,
) -> Circuit:
    nq = width
    circ = Circuit([Register(regname or "q", nq)], 0, name="uccsd")

    def m_d(i, p, q, r, s, dagger=False):
        angle = math.pi / 2 if dagger else -math.pi / 2
        kinds = {
            1: "hhhh", 2: "rrrr", 3: "hrhr", 4: "rhrh",
            5: "rrhh", 6: "hhrr", 7: "rhhr", 8: "hrrh",
        }[i]
        for kind, qubit in zip(kinds, (p, q, r, s)):
            if kind == "h":
                circ.h(qubit)
            else:
                circ.rx(angle, qubit)

    def cnot_ladder(start, stop):
        if stop > start:
            delta, index, stop2 = 1, start + 1, stop + 1
        else:
            delta, index, stop2 = -1, start, stop
        while index != stop2:
            circ.cx(index, index - 1)
            index += delta

    def double_excitation(theta, p, q, r, s):
        for i in range(1, 9):
            if barriers:
                circ.barrier()
            m_d(i, p, q, r, s, dagger=False)
            if barriers:
                circ.barrier()
            cnot_ladder(p, q)
            circ.cx(q, r)
            cnot_ladder(r, s)
            circ.rz(theta, s)
            cnot_ladder(s, r)
            circ.cx(q, r)
            cnot_ladder(q, p)
            if barriers:
                circ.barrier()
            m_d(i, p, q, r, s, dagger=True)

    def single_excitation(theta, p, q):
        if barriers:
            circ.barrier()
        circ.h(p)
        circ.h(q)
        cnot_ladder(p, q)
        circ.rz(theta, q)
        cnot_ladder(q, p)
        if barriers:
            circ.barrier()
        circ.h(p)
        circ.h(q)
        circ.rx(-math.pi / 2, p)
        circ.rx(-math.pi / 2, q)
        cnot_ladder(p, q)
        circ.rz(theta, q)
        cnot_ladder(q, p)
        if barriers:
            circ.barrier()
        circ.rx(-math.pi / 2, p)
        circ.rx(-math.pi / 2, q)

    num_dbl = (nq**4 - 6 * nq**3 + 11 * nq**2 - 6 * nq) / 24
    num_sgl = (nq**2 - nq) / 2
    numparam = int(num_dbl + num_sgl)

    if parameters == "random":
        param = np.random.uniform(-np.pi, np.pi, numparam)
    elif parameters == "seeded":
        if seed is None:
            raise Exception("A valid seed must be provided")
        np.random.seed(seed)
        param = np.random.uniform(-np.pi, np.pi, numparam)
    else:
        raise Exception("Unknown parameter option")

    p_i = 0
    for p in range(nq):
        for q in range(p):
            for r in range(q):
                for s in range(r):
                    double_excitation(param[p_i], p, q, r, s)
                    p_i += 1
    for p in range(nq):
        for q in range(p):
            single_excitation(param[p_i], p, q)
            p_i += 1
    return circ
