"""Fidelity / evaluation harness.

Port of the JAX package's ``evaluate.py``: the Hellinger fidelity and
the cut-vs-uncut comparison with its noisy legs, on one backend or one
per fragment (reference: src/HwAwareCutter/Utilities.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

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
    normalising mass.  Two distributions over the same clbits are
    compared as arrays (a 2^25-outcome dict costs minutes)."""
    if (isinstance(p, Distribution) and isinstance(q, Distribution)
            and list(p.bit_positions) == list(q.bit_positions)):
        a = np.clip(np.asarray(p.values, np.float64), 0.0, None)
        b = np.clip(np.asarray(q.values, np.float64), 0.0, None)
        p_sum, q_sum = float(a.sum()), float(b.sum())
        if p_sum <= 0 or q_sum <= 0:
            return 0.0
        total = float(np.sqrt(a * b).sum())
        return (total * total) / (p_sum * q_sum)
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
    noise_model=None,
    shots: int | None = None,
    seed: int = 0,
    chunk_size: int = 1024,
    device=None,
) -> ComparisonResult:
    """Reference: compareOriginalCircWithCutCirc (Utilities.py:154-226).

    The ideal legs: the uncut oracle (:func:`simulate_circuit`) and
    ``run_virtual_circuit(engine="pallas")``, this package's default
    engine (the JAX version calls its own default, "auto"); with
    ``shots`` the uncut oracle is sampled with ``seed + 101`` (the
    reference's "ideal" legs are themselves 1000-shot runs) and the cut
    leg draws its shots from the knit (``seed``).  The noisy legs, with
    a ``noise_model`` (e.g. ``ops.noise.fake_kolkata_v2()``):
    ``ops.noise.simulate_noisy_circuit`` (seed ``seed + 211``) and
    ``ops.noise.run_noisy_virtual_circuit`` (seed ``seed + 223``, its
    default engine), independent draws as the reference's separate
    backend jobs are.  Without a noise model the noisy legs reuse the
    ideal results, so ``input_fidelity`` and ``cut_fidelity`` are
    trivially 1.0 and ``cut_vs_uncut_fidelity`` is the comparable number.
    ``device``: None = "cuda"."""
    input_ideal = simulate_circuit(original, device=device)
    if shots is not None:
        from .ops.sampling import sample_distribution

        input_ideal = sample_distribution(input_ideal, shots, seed + 101)
    virt = VirtualCircuit(cut)
    cut_ideal, _ = run_virtual_circuit(
        virt, shots=shots, seed=seed, chunk_size=chunk_size,
        engine="pallas", device=device,
    )
    if noise_model is not None:
        from .ops.noise import (
            run_noisy_virtual_circuit,
            simulate_noisy_circuit,
        )

        input_noisy = simulate_noisy_circuit(
            original, noise_model, shots=shots, seed=seed + 211,
            device=device)
        cut_noisy, _ = run_noisy_virtual_circuit(
            virt, noise_model, shots=shots, seed=seed + 223, device=device)
    else:
        input_noisy, cut_noisy = input_ideal, cut_ideal
    return _report(input_ideal, input_noisy, cut_ideal, cut_noisy)


def compare_original_with_cut_multiple_backends(
    original: Circuit,
    cut: Circuit,
    backends: list,
    reference_backend=None,
    shots: int | None = 1000,
    seed: int = 0,
    chunk_size: int = 1024,
    device=None,
) -> ComparisonResult:
    """Heterogeneous-hardware comparison: fragment i runs on
    ``backends[i]`` (a NoiseModel), the uncut circuit on
    ``reference_backend`` (default ``ops.noise.default_noise_model()``);
    seeds as :func:`compare_original_with_cut`.  Reference:
    compareOriginalCircWithCutCircMultipleBackends (Utilities.py:230-297),
    including the fragment-fits-backend capacity check
    (Utilities.py:123).  ``device``: None = "cuda"."""
    from .ops.noise import (
        default_noise_model,
        run_noisy_virtual_circuit,
        simulate_noisy_circuit,
    )

    if reference_backend is None:
        reference_backend = default_noise_model()
    input_ideal = simulate_circuit(original, device=device)
    if shots is not None:
        from .ops.sampling import sample_distribution

        input_ideal = sample_distribution(input_ideal, shots, seed + 101)
    input_noisy = simulate_noisy_circuit(
        original, reference_backend, shots=shots, seed=seed + 211,
        device=device)
    cut_ideal, _ = run_virtual_circuit(
        VirtualCircuit(cut.copy()), shots=shots, seed=seed,
        chunk_size=chunk_size, engine="pallas", device=device)
    cut_noisy, _ = run_noisy_virtual_circuit(
        VirtualCircuit(cut.copy()), list(backends), shots=shots,
        seed=seed + 223, device=device)
    return _report(input_ideal, input_noisy, cut_ideal, cut_noisy)


def _report(input_ideal, input_noisy, cut_ideal, cut_noisy):
    log = get_logger(__name__)
    res = ComparisonResult(
        hellinger_fidelity(input_ideal, input_noisy),
        hellinger_fidelity(cut_ideal, cut_noisy),
        hellinger_fidelity(input_ideal, cut_ideal),
    )
    log.info(f"inputCircFidelity: {res.input_fidelity}")
    log.info(f"cutCircFidelity: {res.cut_fidelity}")
    log.info(f"cutVsUncutFidelity: {res.cut_vs_uncut_fidelity}")
    return res
