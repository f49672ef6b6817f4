"""Execution runtime: run all fragments and knit.

Port of the JAX package's ``run.run_virtual_circuit`` for two engines.

``engine="pallas"``: the streamed label scan with every fragment's rows
from a hand-written kernel, exact (``shots=None``).  Fragments of up to 20
simulated qubits run the fold-fused variant kernel
(ops/variant_kernel.py), 21..24 qubits the segmented blocked kernel
(ops/blocked_kernel.py); past 24 the call raises naming the sharded
engine's ROADMAP item.  At widths where the full distribution cannot
exist (2^40 outcomes), ask for a marginal (``keep_clbits``) or use
``ops.streamed.streamed_expectation_z``.

``engine="sampled"``: Monte-Carlo QPD sampling (ops/qpd_sampling.py) for
cut plans whose label grid is too large to enumerate; ``shots`` is the
label-sample budget.  Collapse-mode fragments run the collapse kernel
(ops/collapse_kernel.py), ancilla-mode fragments the variant kernel's
full rows.  Observables go through
``ops.qpd_sampling.sampled_expectation_z``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from .ops.statevector import Distribution
from .utils.logger import get_logger
from .virt.virtual_circuit import VirtualCircuit

# engines of the JAX package and the ROADMAP item that ports each
_NOT_PORTED = {
    "auto": "queue A, 'other engines' (variant_engine.make_sim_fn and the "
            "XLA path)",
    "xla": "queue A, 'other engines' (variant_engine.make_sim_fn and the "
           "XLA path)",
    "streamed": "queue A, 'other engines' (streamed without the kernel)",
    "sharded": "queue A, 'other engines' (sharded fragments)",
}
_ITEM = "ROADMAP H100 port, queue A, 'other engines'"


@dataclass
class RunTimeInfo:
    """Phase timings (reference: qvm/run.py:17-20, extended)."""

    run_time: float
    knit_time: float


def _run_sampled(virt, shots, seed, project, head_labels, sample_method,
                 sample_eps, sample_cv, keep_clbits, device):
    """``engine="sampled"``: ``shots`` is the QPD sample budget (default:
    the plan's kappa / 0.05^2 Hoeffding budget, capped at 2M), or with
    ``sample_eps`` the cap of the adaptive budget."""
    from .ops.knit import nearest_probability_distribution
    from .ops.qpd_sampling import (
        sampled_knit,
        sampled_knit_adaptive,
        sampling_overhead,
    )

    log = get_logger(__name__)
    now = time.perf_counter()
    if sample_eps is not None:
        cap = shots if shots is not None else 2_000_000
        dist, _, used = sampled_knit_adaptive(
            virt, sample_eps, seed=seed, head_labels=head_labels,
            method=sample_method, keep_clbits=keep_clbits, max_samples=cap,
            control_variate=sample_cv, device=device,
        )
        log.info(f"sampled engine: eps={sample_eps:g} met with {used} "
                 f"samples (cap {cap})")
    else:
        budget = shots
        if budget is None:
            over = sampling_overhead(virt, eps=0.05)
            # the Hoeffding budget kappa/eps^2 grows as 9^n_cuts — cap the
            # default and report the accuracy actually bought; callers
            # wanting tighter eps pass ``shots`` explicitly
            budget = min(over["shots_for_eps"], 2_000_000)
            if budget < over["shots_for_eps"]:
                log.warning(
                    f"sampled engine: default budget capped at {budget} "
                    f"(kappa={over['kappa']:.3g} wants "
                    f"{over['shots_for_eps']} for eps=0.05; the cap buys "
                    f"eps~{(over['kappa'] / budget) ** 0.5:.3g}); pass "
                    "shots= for a larger budget"
                )
        dist = sampled_knit(
            virt, budget, seed=seed, head_labels=head_labels,
            method=sample_method, keep_clbits=keep_clbits,
            control_variate=sample_cv, device=device,
        )
    if project:
        dist = nearest_probability_distribution(dist)
    return dist, RunTimeInfo(time.perf_counter() - now, 0.0)


def run_virtual_circuit(
    virt: VirtualCircuit,
    shots: int | None = None,
    chunk_size: int = 1024,
    seed: int = 0,
    project: bool = True,
    engine: str = "pallas",
    mesh=None,
    dtype=None,
    head_labels: int = 0,
    sample_method: str = "iid",
    sample_eps: float | None = None,
    sample_cv: bool = False,
    sample_pallas: bool = True,
    keep_clbits=None,
    device=None,
    noise=None,
) -> tuple[Distribution, RunTimeInfo]:
    """Simulate the QPD labels of every fragment, knit and (``project``)
    project onto the simplex.  The JAX package's default engine is
    "auto"; this package has two engines, both kernel-backed.

    ``engine="pallas"`` (the default): the streamed scan over ALL global
    label chunks of ``chunk_size`` (capped by the widest fragment's state
    size), every fragment's rows from its kernel and folded per chunk, so
    sim and knit fuse and ``RunTimeInfo.knit_time`` is 0.  Exact.

    ``engine="sampled"``: Monte-Carlo QPD sampling
    (ops/qpd_sampling.py) — ``shots`` is the label-sample budget;
    unbiased with std ~ gamma/sqrt(shots), for cut counts whose label
    grid is too large to enumerate.  Its knobs, each refused on the other
    engine as in the JAX package: ``seed``; ``head_labels`` (stratified:
    the heaviest labels enumerated, the budget spent on the tail);
    ``sample_method`` ("iid" or "lhs", balanced label sampling);
    ``sample_cv`` (control-variate regression against the signed total
    mass); ``sample_eps`` (grow the budget until the worst per-outcome
    empirical standard error is <= sample_eps; ``shots`` is then the
    cap, default 2M); ``sample_pallas`` (rows from the kernels: True is
    the only ported route, False raises).

    ``keep_clbits``: marginal knit (either engine).  ``device``: None =
    "cuda" (raises without a card); "cpu" runs the kernels' plain PyTorch
    versions.  ``run_time`` ends after the result reached the host.
    ``noise``, ``dtype`` and ``mesh`` are knobs of the JAX package that
    are not ported: anything but None raises NotImplementedError."""
    if engine in _NOT_PORTED:
        raise NotImplementedError(
            f"engine={engine!r} is not ported to the torch package yet: "
            f"ROADMAP H100 port, {_NOT_PORTED[engine]}"
        )
    if engine not in ("pallas", "sampled"):
        raise ValueError(f"unknown engine {engine!r}")
    for name, value, what in (
        ("noise", noise, "noise"), ("dtype", dtype, "bf16"),
        ("mesh", mesh, "mesh"),
    ):
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported to the torch package yet: {_ITEM} "
                f"({what})"
            )
    if head_labels and engine != "sampled":
        raise ValueError(
            "head_labels (stratified estimation) is a sampled-engine "
            f"feature, not engine={engine!r}"
        )
    if sample_method != "iid" and engine != "sampled":
        raise ValueError(
            "sample_method (QPD label sampling) is a sampled-engine "
            f"feature, not engine={engine!r}"
        )
    if sample_eps is not None and engine != "sampled":
        raise ValueError(
            "sample_eps (eps-targeted sampling) is a sampled-engine "
            f"feature, not engine={engine!r}"
        )
    if sample_cv and engine != "sampled":
        raise ValueError(
            "sample_cv (control-variate estimation) is a sampled-engine "
            f"feature, not engine={engine!r}"
        )
    if engine == "sampled":
        if not sample_pallas:
            raise NotImplementedError(
                "sample_pallas=False (rows built without a kernel) is not "
                f"ported to the torch package yet: {_ITEM} (sampled "
                "engine: rows without a kernel)"
            )
        return _run_sampled(virt, shots, seed, project, head_labels,
                            sample_method, sample_eps, sample_cv,
                            keep_clbits, device)
    if shots is not None:
        raise NotImplementedError(
            "shots= is not ported to the torch package yet: ROADMAP H100 "
            "port, queue A, 'other engines' (sampling)"
        )
    from .ops.streamed import run_virtual_circuit_streamed

    log = get_logger(__name__)
    log.info(
        f"Running {len(virt.fragments)} fragments over "
        f"{virt.total_instantiations()} instances (engine='pallas')..."
    )
    now = time.perf_counter()
    dist = run_virtual_circuit_streamed(
        virt, chunk=chunk_size, project=project, keep_clbits=keep_clbits,
        device=device,
    )
    return dist, RunTimeInfo(time.perf_counter() - now, 0.0)
