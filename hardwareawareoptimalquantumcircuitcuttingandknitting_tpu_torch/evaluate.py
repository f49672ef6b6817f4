"""Fidelity / evaluation harness.

Port of the JAX package's ``evaluate.py`` for the exact, noise-free
legs: the Hellinger fidelity and the cut-vs-uncut comparison (reference:
src/HwAwareCutter/Utilities.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .circuit.circuit import Circuit
from .ops.statevector import Distribution, simulate_circuit
from .run import run_virtual_circuit
from .utils.logger import get_logger
from .virt.virtual_circuit import VirtualCircuit


def hellinger_fidelity(p: Distribution | dict, q: Distribution | dict) -> float:
    """(sum_i sqrt(p_i q_i))^2 over the union support, matching qiskit's
    hellinger_fidelity used at Utilities.py:222-224.  Like qiskit, both
    inputs are normalised first.  Negative entries of an unprojected
    quasi-distribution are excluded from both the overlap and the
    normalising mass."""
    pd = p.to_dict() if isinstance(p, Distribution) else dict(p)
    qd = q.to_dict() if isinstance(q, Distribution) else dict(q)
    p_sum = sum(v for v in pd.values() if v > 0)
    q_sum = sum(v for v in qd.values() if v > 0)
    if p_sum <= 0 or q_sum <= 0:
        return 0.0
    total = 0.0
    for key, pv in pd.items():
        qv = qd.get(key, 0.0)
        if pv > 0 and qv > 0:
            total += math.sqrt(pv * qv)
    return (total * total) / (p_sum * q_sum)


@dataclass
class ComparisonResult:
    input_fidelity: float       # uncut: ideal vs noisy
    cut_fidelity: float         # cut+knit: ideal vs noisy
    cut_vs_uncut_fidelity: float  # the self-consistency oracle (~1.0)


def compare_original_with_cut(
    original: Circuit,
    cut: Circuit,
    chunk_size: int = 1024,
    device=None,
) -> ComparisonResult:
    """Reference: compareOriginalCircWithCutCirc (Utilities.py:154-226),
    exact and noise-free: the uncut oracle (:func:`simulate_circuit`)
    against ``run_virtual_circuit(engine="pallas")``, this package's only
    engine (the JAX version calls its default engine).  Without a noise
    model the noisy legs reuse the ideal results, so ``input_fidelity``
    and ``cut_fidelity`` are trivially 1.0 and ``cut_vs_uncut_fidelity``
    is the comparable number.  ``device``: None = "cuda"."""
    log = get_logger(__name__)
    input_ideal = simulate_circuit(original, device=device)
    cut_ideal, _ = run_virtual_circuit(
        VirtualCircuit(cut), chunk_size=chunk_size, engine="pallas",
        device=device,
    )
    res = ComparisonResult(
        hellinger_fidelity(input_ideal, input_ideal),
        hellinger_fidelity(cut_ideal, cut_ideal),
        hellinger_fidelity(input_ideal, cut_ideal),
    )
    log.info(f"cutVsUncutFidelity: {res.cut_vs_uncut_fidelity}")
    return res
