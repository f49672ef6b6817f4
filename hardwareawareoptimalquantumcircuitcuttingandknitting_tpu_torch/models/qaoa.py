"""QAOA circuits over graphs.

Port of the JAX package's ``models/qaoa.py`` (a behavioral port of the
reference's construct_qaoa_plus, benchmarks/helper_functions.py:34-63).
The graph is any object with ``nodes()`` and ``edges()`` (a networkx
graph, or a small stand-in: this package does not import networkx).
"""
from __future__ import annotations

from ..circuit.circuit import Circuit, ParamRef, Register


def _scaled(p, k: float):
    """``k * p`` that keeps a ParamRef's theta reference alive (plain
    arithmetic on ParamRef deliberately degrades to float)."""
    return p.scaled(k) if isinstance(p, ParamRef) else k * p


def construct_qaoa_plus(
    P: int, G, params, reg_name: str = "q", barriers: bool = False,
    measure: bool = False,
) -> Circuit:
    if len(params) != 2 * P:
        raise ValueError("Number of parameters should be 2P")
    nq = len(G.nodes())
    circ = Circuit([Register(reg_name, nq)], 0, name="qaoa")

    for q in range(nq):
        circ.h(q)

    gammas = [p for i, p in enumerate(params) if i % 2 == 0]
    betas = [p for i, p in enumerate(params) if i % 2 == 1]
    for i in range(P):
        for q_i, q_j in G.edges():
            circ.rz(_scaled(gammas[i], 0.5), q_i)
            circ.rz(_scaled(gammas[i], 0.5), q_j)
            circ.cx(q_i, q_j)
            circ.rz(_scaled(gammas[i], -0.5), q_j)
            circ.cx(q_i, q_j)
            if barriers:
                circ.barrier()
        for q_i in range(nq):
            circ.rx(_scaled(betas[i], -2.0), q_i)

    if measure:
        circ.measure_all()
    return circ
