"""Hardware-efficient ansatz (QAOA RyRz style).

Behavioral port of benchmarks/qcg/QAOA/hw_efficient_ansatz.py: u3(θ,0,0) /
u3(0,0,θ) rotation columns around linear CX entangler blocks, with the
"optimal" community-detection parameter vector by default.
"""
from __future__ import annotations

import math

import numpy as np

from ..circuit.circuit import Circuit, Register


def gen_hwea(
    width: int,
    depth: int,
    parameters: str = "optimal",
    seed: int | None = None,
    barriers: bool = False,
    measure: bool = False,
    regname: str | None = None,
) -> Circuit:
    nq, d = width, depth
    circ = Circuit([Register(regname or "q", nq)], 0, name="hwea")
    if measure:
        circ.cregs = [Register(("c" + regname) if regname else "c", nq)]

    if parameters == "optimal":
        theta = np.zeros(2 * nq * (1 + d))
        theta[0] = np.pi / 2
        theta[2 * nq: 2 * nq + math.floor(nq / 2)] = np.pi
    elif parameters in ("random", "seeded"):
        if parameters == "seeded":
            if seed is None:
                raise Exception("A valid seed must be provided")
            np.random.seed(seed)
        theta = np.random.uniform(-np.pi, np.pi, 4 * nq)
    else:
        raise Exception(f"Unknown parameter option: {parameters}")

    p = 0
    for i in range(nq):
        circ.u(theta[i + p], 0, 0, i)
    p += nq
    for i in range(nq):
        circ.u(0, 0, theta[i + p], i)
    p += nq
    if barriers:
        circ.barrier()

    for _ in range(d):
        for i in range(nq - 1):
            circ.cx(i, i + 1)
        if barriers:
            circ.barrier()
        for i in range(nq):
            circ.u(theta[i + p], 0, 0, i)
        p += nq
        for i in range(nq):
            circ.u(0, 0, theta[i + p], i)
        p += nq

    if measure:
        circ.barrier()
        for q in range(nq):
            circ.measure(q, q)
    return circ
