"""Execution runtime: run all fragments and knit.

Port of the JAX package's ``run.run_virtual_circuit``.

``engine="xla"``: the batched engine.  Every fragment's variants run at
once in plain PyTorch (ops/variant_engine.run_all_fragments), then one
einsum knits them (ops/knit.knit_values).  ``engine="auto"`` takes that
route up to ``AUTO_STREAM_LABELS`` global labels and the streamed scan
above.  In this package that scan is the kernel-backed one of
``engine="pallas"``; it becomes ``engine="streamed"`` once the scan without
a kernel is ported.

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

The whole-fragment kernel (ops/sv_kernel.py) is not an engine here, as in
the JAX package: a caller composes ``run_fragment_kernel`` with
``ops.knit.knit``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from .ops.statevector import Distribution
from .utils.logger import get_logger
from .virt.virtual_circuit import VirtualCircuit

# "auto" switches from the batched engine to the streamed scan above this
# many GLOBAL labels (product over all vgates): the batched path
# materialises every fragment's [V, 2^k] block (the JAX package's
# threshold).
AUTO_STREAM_LABELS = 16384

# engines of the JAX package and the ROADMAP item that ports each
_NOT_PORTED = {
    "streamed": "queue A, 'other engines' (streamed without the kernel)",
    "sharded": "queue A, 'other engines' (sharded fragments)",
}
_ITEM = "ROADMAP H100 port, queue A, 'other engines'"
# keywords of the JAX package that are not ported: (JAX default, the
# ROADMAP item that ports them).  Their defaults give the JAX result.
_NOT_PORTED_KW = {
    "tracer": (None, "ROADMAP H100 port, queue A, item 10 (tracing)"),
    "checkpoint_dir": (None, f"{_ITEM} (fragment-result checkpoint)"),
    "max_local_qubits": (None, f"{_ITEM} (sharded fragments)"),
    "trunc_eps": (0.0, f"{_ITEM} (streamed without the kernel)"),
    "teleport": ("qpd", "ROADMAP H100 port, queue A, item 4 (Teleport "
                        "execution)"),
}


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
    tracer=None,
    checkpoint_dir=None,
    mesh=None,
    max_local_qubits: int | None = None,
    dtype=None,
    trunc_eps: float = 0.0,
    head_labels: int = 0,
    sample_method: str = "iid",
    sample_eps: float | None = None,
    sample_cv: bool = False,
    sample_pallas: bool = True,
    keep_clbits=None,
    device=None,
    noise=None,
    teleport: str = "qpd",
) -> tuple[Distribution, RunTimeInfo]:
    """Simulate the QPD labels of every fragment, knit and (``project``)
    project onto the simplex.  The JAX package's default engine is
    "auto"; this package defaults to the kernel-backed exact engine.

    ``engine="xla"``: the batched engine in plain PyTorch: every
    fragment's variants at once, ``chunk_size`` variants per step (capped
    by bytes), then the einsum knit; ``RunTimeInfo`` carries both phases.
    ``engine="auto"``: that route up to ``AUTO_STREAM_LABELS`` global
    labels, above it the streamed scan, which in this package is the
    kernel-backed one of ``engine="pallas"``.

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

    ``keep_clbits``: marginal knit (any engine).  ``device``: None =
    "cuda" (raises without a card); "cpu" runs the kernels' plain PyTorch
    versions.  ``run_time`` ends after the result reached the host.
    ``noise``, ``dtype`` and ``mesh`` are knobs of the JAX package that
    are not ported: anything but None raises NotImplementedError.  So do
    ``tracer``, ``checkpoint_dir``, ``max_local_qubits``, ``trunc_eps``
    and ``teleport`` at anything but the JAX defaults (None, None, None,
    0.0, "qpd": teleport-flagged cuts run through the QPD route, the JAX
    package's reference-parity mode); a ``teleport`` outside ("qpd",
    "execute") raises ValueError, as in the JAX package."""
    if teleport not in ("qpd", "execute"):
        raise ValueError(f"unknown teleport mode {teleport!r}")
    given = {"tracer": tracer, "checkpoint_dir": checkpoint_dir,
             "max_local_qubits": max_local_qubits, "trunc_eps": trunc_eps,
             "teleport": teleport}
    for name, (default, item) in _NOT_PORTED_KW.items():
        if given[name] != default:
            raise NotImplementedError(
                f"{name}={given[name]!r} is not ported to the torch package "
                f"yet: {item}"
            )
    if engine in _NOT_PORTED:
        raise NotImplementedError(
            f"engine={engine!r} is not ported to the torch package yet: "
            f"ROADMAP H100 port, {_NOT_PORTED[engine]}"
        )
    if engine not in ("auto", "xla", "pallas", "sampled"):
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
    log = get_logger(__name__)
    if engine == "auto":
        labels = 1
        for vg in virt.vgates:
            labels *= vg.spec.num_instantiations
        if labels > AUTO_STREAM_LABELS:
            log.info(f"auto engine: {labels} global labels > "
                     f"{AUTO_STREAM_LABELS} -> streamed scan")
            engine = "pallas"
    if engine == "pallas":
        from .ops.streamed import run_virtual_circuit_streamed

        log.info(
            f"Running {len(virt.fragments)} fragments over "
            f"{virt.total_instantiations()} instances (engine='pallas')..."
        )
        now = time.perf_counter()
        dist = run_virtual_circuit_streamed(
            virt, chunk=chunk_size, project=project,
            keep_clbits=keep_clbits, device=device,
        )
        return dist, RunTimeInfo(time.perf_counter() - now, 0.0)
    return _run_batched(virt, chunk_size, project, keep_clbits, device)


def _run_batched(virt, chunk_size, project, keep_clbits, device):
    """``engine="xla"``: all variants of every fragment, then the knit."""
    import torch

    from .convert import resolve_device
    from .ops.knit import knit_values, smolin_project
    from .ops.variant_engine import run_all_fragments

    dev = resolve_device(device)

    def clock():
        # device work is asynchronous: a phase ends when the card is done
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    log = get_logger(__name__)
    frag_sizes = tuple(p.num_data_qubits for p in virt.programs.values())
    log.info(
        f"Running virtualizer with {len(virt.fragments)} {frag_sizes} "
        f"fragments and {len(virt.vgates)} vgates..."
    )
    log.info(f"Running {virt.total_instantiations()} instances...")
    now = clock()
    results = run_all_fragments(virt, chunk_size, dev)
    run_time = clock() - now

    log.info("Knitting...")
    now = clock()
    values, positions = knit_values(virt, results, keep_clbits)
    knit_time = clock() - now
    log.info(f"Knitted in {knit_time:.2f}s.")

    if project:
        values = smolin_project(values).to(torch.float32)
    dist = Distribution(values.cpu().numpy(), positions, virt.num_clbits)
    return dist, RunTimeInfo(run_time, knit_time)
