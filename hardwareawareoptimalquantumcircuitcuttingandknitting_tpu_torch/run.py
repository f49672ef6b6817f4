"""Execution runtime: run all fragments and knit.

Port of the JAX package's ``run.run_virtual_circuit``.

``engine="xla"``: the batched engine.  Every fragment's variants run at
once in plain PyTorch (ops/variant_engine.run_all_fragments), then one
einsum knits them (ops/knit.knit_values).  ``shots`` samples the variant
rows (ops/sampling.sample_fragment_results); ``checkpoint_dir`` saves the
fragment results and resumes from them (utils/checkpoint.py).

``engine="streamed"``: the streamed label scan without a kernel
(ops/streamed.py, ``pallas_variant=False``): constant memory in the
label count, ancestor banks and staged suffixes (``share_prefix``), bf16
states (``dtype=torch.bfloat16``), certified truncation (``trunc_eps``),
carry checkpoints (``checkpoint_dir``) and ``shots`` drawn from the
knitted distribution.  ``engine="auto"`` takes it for ``trunc_eps``, a
``dtype`` other than float32, or above ``AUTO_STREAM_LABELS`` global
labels, and the batched engine otherwise, as the JAX package does.

``engine="pallas"`` (this package's default): the same scan with every
fragment's rows from a hand-written kernel, float32.  Fragments of up to
20 simulated qubits run the fold-fused variant kernel
(ops/variant_kernel.py), 21..24 qubits the segmented blocked kernel
(ops/blocked_kernel.py); past 24 the call raises naming
``engine="sharded"``.  ``trunc_eps`` raises the JAX package's
ValueError, and a bf16 ``dtype`` a ValueError naming
``engine="streamed"`` (the JAX package would run the route without a
kernel instead).  At widths where the full distribution cannot exist
(2^40 outcomes), ask for a marginal (``keep_clbits``) or use
``ops.streamed.streamed_expectation_z``.

``engine="sampled"``: Monte-Carlo QPD sampling (ops/qpd_sampling.py) for
cut plans whose label grid is too large to enumerate; ``shots`` is the
label-sample budget.  With ``sample_pallas=True`` (the default)
collapse-mode fragments run the collapse kernel (ops/collapse_kernel.py)
and ancilla-mode fragments the variant kernel's full rows, up to 20
qubits; every other fragment, and every fragment with
``sample_pallas=False`` or a bf16 ``dtype``, runs without a kernel
(``variant_engine.make_sim_fn``).  Where the engine computes the
estimate's variance anyway (``sample_cv=True``, or ``sample_eps``),
``RunTimeInfo.stderr`` returns the per-outcome standard error in the
``Distribution``'s order; it is None on every other engine and call.
``sample_probe=k`` returns ``k`` of the scan's trajectory rows, evenly
spaced, with their labels and draws in ``RunTimeInfo.probe``, for a
replay to hold them to.  Observables go through
``ops.qpd_sampling.sampled_expectation_z``, noise through
``ops.noise.run_noisy_virtual_circuit(engine="sampled")``.

``engine="sharded"``: variant x amplitude co-sharding over a process-group
mesh (ops/sharded_fragment.py, parallel/mesh.py): every fragment's rows
on a ``(dp, amp)`` mesh, amplitudes split just far enough that no rank
holds more than ``2^max_local_qubits`` of them, then the batched knit;
plain PyTorch, no kernel (neither package has one on this path).  On
one device without a process group the mesh is ``(1, 1)``, which runs a
fragment past the kernels' 24 qubits.  ``dtype=torch.bfloat16`` keeps
the local blocks and the exchanges bf16.  ``mesh`` also shards the
sampled engine's label blocks over its "dp" axis.

The whole-fragment kernel (ops/sv_kernel.py) is not an engine here, as in
the JAX package: a caller composes ``run_fragment_kernel`` with
``ops.knit.knit``.

``tracer`` (a ``utils.profiling.Tracer``) records the JAX package's
phases with its names and meta: ``qpd_sample_knit`` /
``qpd_sample_knit_adaptive`` (sampled), ``stream_sim_knit`` ("pallas",
"streamed"), and ``load_checkpoint``, ``simulate``, ``save_checkpoint``,
``sample``, ``knit``, ``project`` (the batched engines).  With the
tracer's ``profile_dir`` set, ``stream_sim_knit`` and the batched
engines' ``simulate`` to ``knit`` run inside its device trace.  Each
phase of a tracer waits for the card before it reads its clock; without
a tracer the phases are empty contexts.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np

from .ops.statevector import Distribution
from .utils.logger import get_logger
from .utils.profiling import NO_TRACER, span
from .virt.virtual_circuit import VirtualCircuit

# "auto" switches from the batched engine to the streamed scan above this
# many GLOBAL labels (product over all vgates): the batched path
# materialises every fragment's [V, 2^k] block (the JAX package's
# threshold).
AUTO_STREAM_LABELS = 16384


@dataclass
class RunTimeInfo:
    """Phase timings (reference: qvm/run.py:17-20, extended).
    ``stderr``: the sampled engine's per-outcome standard error of the
    estimate (numpy, in the ``Distribution``'s order, of the values
    before ``project``), where it computes the variance anyway; else
    None.  ``probe``: with ``sample_probe``, the trajectory rows
    ``ops.qpd_sampling.sampled_knit`` describes under ``probe``; else
    None.  ``noise``: ``ops.noise.run_noisy_virtual_circuit(engine=
    "streamed")``'s record of what its scan simulated, the routed op
    streams and the branch indices drawn
    (``ops.streamed.make_streamed_knit``'s ``meta["noise"]``); else
    None."""

    run_time: float
    knit_time: float
    stderr: np.ndarray | None = None
    probe: dict | None = None
    noise: dict | None = None


def _run_sampled(virt, shots, seed, project, head_labels, sample_method,
                 sample_eps, sample_cv, keep_clbits, device, dtype,
                 sample_pallas, mesh, tracer, sample_probe=0):
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
        if sample_probe:
            raise ValueError("sample_probe takes a fixed budget, not "
                             "sample_eps")
        cap = shots if shots is not None else 2_000_000
        with tracer.phase("qpd_sample_knit_adaptive", eps=sample_eps):
            dist, se, used = sampled_knit_adaptive(
                virt, sample_eps, seed=seed, head_labels=head_labels,
                method=sample_method, keep_clbits=keep_clbits,
                max_samples=cap, control_variate=sample_cv, dtype=dtype,
                pallas_variant=sample_pallas, mesh=mesh, device=device,
            )
            log.info("sampled engine: eps=%g met with %s samples (cap %s)",
                     sample_eps, used, cap)
            if project:
                dist = nearest_probability_distribution(dist)
        return dist, RunTimeInfo(time.perf_counter() - now, 0.0, se)
    budget = shots
    if budget is None:
        over = sampling_overhead(virt, eps=0.05)
        # the Hoeffding budget kappa/eps^2 grows as 9^n_cuts — cap the
        # default and report the accuracy actually bought; callers wanting
        # tighter eps pass ``shots`` explicitly
        budget = min(over["shots_for_eps"], 2_000_000)
        if budget < over["shots_for_eps"]:
            log.warning(
                f"sampled engine: default budget capped at {budget} "
                f"(kappa={over['kappa']:.3g} wants "
                f"{over['shots_for_eps']} for eps=0.05; the cap buys "
                f"eps~{(over['kappa'] / budget) ** 0.5:.3g}); pass "
                "shots= for a larger budget"
            )
    probe = {"size": int(sample_probe)} if sample_probe else None
    with tracer.phase("qpd_sample_knit", samples=budget):
        # the control variate computes the variance: its standard error
        # comes with no further work
        out = sampled_knit(
            virt, budget, seed=seed, head_labels=head_labels,
            method=sample_method, keep_clbits=keep_clbits,
            with_stderr=sample_cv, control_variate=sample_cv, dtype=dtype,
            pallas_variant=sample_pallas, mesh=mesh, device=device,
            probe=probe,
        )
        dist, se = out if sample_cv else (out, None)
        if project:
            dist = nearest_probability_distribution(dist)
    return dist, RunTimeInfo(time.perf_counter() - now, 0.0, se, probe)


def _is_f32(dtype) -> bool:
    import torch

    return dtype is None or dtype == torch.float32


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
    teleport: str = "qpd",
    sample_probe: int = 0,
) -> tuple[Distribution, RunTimeInfo]:
    """Simulate the QPD labels of every fragment, knit and (``project``)
    project onto the simplex.  The JAX package's default engine is
    "auto"; this package defaults to the kernel-backed exact engine.

    ``engine="xla"``: the batched engine in plain PyTorch: every
    fragment's variants at once, ``chunk_size`` variants per step (capped
    by bytes), then the einsum knit; ``RunTimeInfo`` carries both phases.
    ``shots`` samples every variant row (``seed``); ``checkpoint_dir``
    saves the fragment results after the simulation and, where a
    checkpoint of the same circuit is there, loads them instead.
    ``engine="auto"``: the streamed scan for ``trunc_eps``, a ``dtype``
    other than float32 or more than ``AUTO_STREAM_LABELS`` global labels,
    the batched engine otherwise (the JAX package's routing).

    ``engine="streamed"``: the scan over ALL global label chunks of
    ``chunk_size`` (capped by the widest fragment's state size), rows in
    plain PyTorch with ancestor banks and staged suffixes, sim and knit
    fused (``RunTimeInfo.knit_time`` is 0).  ``dtype=torch.bfloat16``:
    bf16 states and banks, float32 rows and knit.  ``trunc_eps``:
    certified truncation (the result moves at most the dropped bound in
    L1).  ``checkpoint_dir``: the carry checkpointed a segment at a time
    (resume mid-scan).  ``shots``: counts drawn from the projected knit
    (on the device without a checkpoint, ``seed``).
    ``engine="pallas"`` (the default): the same scan with every
    fragment's rows from its kernel, float32, exact; ``shots`` and
    ``checkpoint_dir`` as there.

    ``engine="sampled"``: Monte-Carlo QPD sampling
    (ops/qpd_sampling.py) — ``shots`` is the label-sample budget;
    unbiased with std ~ gamma/sqrt(shots), for cut counts whose label
    grid is too large to enumerate.  Its knobs, each refused on the other
    engines as in the JAX package: ``seed``; ``head_labels`` (stratified:
    the heaviest labels enumerated, the budget spent on the tail);
    ``sample_method`` ("iid" or "lhs", balanced label sampling);
    ``sample_cv`` (control-variate regression against the signed total
    mass; it computes the variance, so ``RunTimeInfo.stderr`` then holds
    the per-outcome standard error); ``sample_eps`` (grow the budget
    until the worst per-outcome empirical standard error is <=
    sample_eps; ``shots`` is then the cap, default 2M); ``sample_pallas`` (True, this package's default: a
    kernel's rows for every fragment one serves, the others without a
    kernel; False: every fragment without a kernel, the JAX default);
    ``dtype=torch.bfloat16`` (bf16 states without a kernel, float32 rows
    and knit); ``mesh`` (a ``parallel.mesh.Mesh`` with a "dp" axis: each
    rank scans its own label blocks, the estimate summed over "dp");
    ``sample_probe`` (that many of the scan's trajectory rows, evenly
    spaced, in ``RunTimeInfo.probe``, copied to the host once the scan
    ends; a fixed budget only, not with ``sample_eps``).

    ``engine="sharded"``: every fragment's variants co-sharded over a
    ``(dp, amp)`` mesh (ops/sharded_fragment.py): ``mesh`` with those
    axes, or None for each fragment's own split from
    ``fragment_mesh(max_local_qubits=...)`` over the process group's
    ranks (one device: ``(1, 1)``); then the batched knit on every rank.
    ``dtype=torch.bfloat16``: bf16 blocks and exchanges, float32 rows
    and knit.  ``shots`` and ``checkpoint_dir`` apply after the
    fragments, as on "xla" (the checkpoint written by rank 0).
    ``mesh`` and ``max_local_qubits`` are read by these two engines only,
    as in the JAX package.

    ``keep_clbits``: marginal knit (any engine).  ``device``: None =
    "cuda" (raises without a card); "cpu" runs the plain versions.
    ``run_time`` ends after the result reached the host.
    ``RunTimeInfo.stderr``: the sampled engine's per-outcome standard
    error with ``sample_cv=True`` or ``sample_eps`` (equal to
    ``sampled_knit(..., with_stderr=True)``'s at the same arguments),
    None otherwise.

    Refused as in the JAX package, with ValueError: ``trunc_eps`` on an
    engine but "auto" and "streamed", a ``dtype`` other than float32 on
    "xla", an unknown engine or ``teleport`` mode, a sampled-engine knob
    on another engine.  Refused by this package, with ValueError: a
    ``dtype`` other than float32 on "pallas" (the kernels are float32;
    use "streamed").

    ``tracer``: a ``utils.profiling.Tracer`` that records the JAX
    package's phases (names and meta as there), each ending in a
    synchronise of ``device``'s card; with ``profile_dir`` set, the scan's
    phase (``"pallas"``, ``"streamed"``) and the batched engines'
    simulate-to-knit phases run inside a ``torch.profiler`` trace written
    there.  None (the default) records nothing and adds no
    synchronise.

    ``teleport``: "qpd" (the default, the reference's behaviour:
    teleport-flagged cuts execute through the QPD route) or "execute":
    teleport cuts are expanded into the EPR-gadget protocol
    (virt/teleport.py), the fragments they connect merge into one, and
    the result is the run of that circuit on the engine asked for, as in
    the JAX package.  Noisy execution goes
    through ``ops.noise.run_noisy_virtual_circuit``, as in the JAX package
    (no ``noise`` keyword here)."""
    if teleport not in ("qpd", "execute"):
        raise ValueError(f"unknown teleport mode {teleport!r}")
    if engine not in ("auto", "xla", "streamed", "pallas", "sampled",
                      "sharded"):
        raise ValueError(f"unknown engine {engine!r}")
    if teleport == "execute":
        from .virt.teleport import expand_teleport_cuts, has_teleport_cuts

        if has_teleport_cuts(virt._circuit):
            virt = VirtualCircuit(expand_teleport_cuts(virt._circuit))
    if tracer is None:
        tracer = NO_TRACER
    else:
        # a phase waits for this run's card, not the current one
        tracer.device = device
    if trunc_eps and engine not in ("auto", "streamed"):
        raise ValueError(
            "trunc_eps (certified truncation) is a streamed-engine "
            f"feature, not engine={engine!r}"
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
    if sample_probe and engine != "sampled":
        raise ValueError(
            "sample_probe (trajectory rows for a replay) is a "
            f"sampled-engine feature, not engine={engine!r}"
        )
    if engine == "sampled":
        return _run_sampled(virt, shots, seed, project, head_labels,
                            sample_method, sample_eps, sample_cv,
                            keep_clbits, device, dtype, sample_pallas, mesh,
                            tracer, sample_probe)
    log = get_logger(__name__)
    if engine == "auto":
        labels = 1
        for vg in virt.vgates:
            labels *= vg.spec.num_instantiations
        if trunc_eps or not _is_f32(dtype):
            # bf16 serving and certified truncation are streamed
            # capabilities: routed at any size
            log.info("auto engine: dtype/trunc_eps -> streamed scan")
            engine = "streamed"
        elif labels > AUTO_STREAM_LABELS:
            log.info("auto engine: %s global labels > %s -> streamed scan",
                     labels, AUTO_STREAM_LABELS)
            engine = "streamed"
    if engine == "pallas" and not _is_f32(dtype):
        raise ValueError(
            "dtype= (bf16 serving) runs on engine=\"streamed\" (or "
            "\"auto\"); engine=\"pallas\" is the float32 kernels' route"
        )
    if engine == "xla" and not _is_f32(dtype):
        raise ValueError(
            "dtype= (bf16 serving) is supported by the streamed, "
            f"sharded and sampled engines, not engine={engine!r}"
        )
    if engine in ("streamed", "pallas"):
        from .ops.streamed import run_virtual_circuit_streamed

        if log.isEnabledFor(logging.INFO):
            log.info("Running %s fragments over %s instances (engine=%r)...",
                     len(virt.fragments), virt.total_instantiations(),
                     engine)
        now = time.perf_counter()
        tracer.start_device_trace()
        try:
            with tracer.phase("stream_sim_knit",
                              instances=virt.total_instantiations(),
                              chunk=chunk_size):
                dist = run_virtual_circuit_streamed(
                    virt, chunk=chunk_size, project=project, shots=shots,
                    seed=seed, checkpoint_dir=checkpoint_dir, dtype=dtype,
                    trunc_eps=trunc_eps, keep_clbits=keep_clbits,
                    pallas_variant=engine == "pallas", device=device,
                )
        finally:
            tracer.stop_device_trace()
        return dist, RunTimeInfo(time.perf_counter() - now, 0.0)
    return _run_batched(virt, chunk_size, project, keep_clbits, device,
                        shots, seed, checkpoint_dir, engine, mesh,
                        max_local_qubits, dtype, tracer)


def _run_batched(virt, chunk_size, project, keep_clbits, device,
                 shots=None, seed=0, checkpoint_dir=None, engine="xla",
                 mesh=None, max_local_qubits=None, dtype=None,
                 tracer=NO_TRACER):
    """``engine="xla"`` / ``"sharded"``: all variants of every fragment
    (or a checkpoint of them), optionally shot-sampled, then the knit."""
    import torch

    from .ops.knit import knit_values, smolin_project
    from .parallel.mesh import every_rank, mesh_device, world

    if engine == "sharded":
        dev = mesh.device if mesh is not None else mesh_device(device)
    else:
        from .convert import resolve_device

        dev = resolve_device(device)

    def clock():
        # device work is asynchronous: a phase ends when the card is done
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    log = get_logger(__name__)
    if log.isEnabledFor(logging.INFO):
        log.info("Running virtualizer with %s %s fragments and %s vgates...",
                 len(virt.fragments),
                 tuple(p.num_data_qubits for p in virt.programs.values()),
                 len(virt.vgates))
        log.info("Running %s instances...", virt.total_instantiations())
    now = clock()
    results = None
    if checkpoint_dir is not None:
        from .utils.checkpoint import (
            checkpoint_fingerprint,
            has_checkpoint,
            load_fragment_results,
        )

        fingerprint = checkpoint_fingerprint(virt, dtype=dtype)
        found = has_checkpoint(checkpoint_dir)
        if found:
            with tracer.phase("load_checkpoint"):
                results = load_fragment_results(
                    checkpoint_dir, expect_fingerprint=fingerprint)
        if engine == "sharded" and not every_rank(results is not None, dev):
            # resume only where every rank can: a rank that simulates
            # enters collectives that the others would never join
            results = None
        if results is not None:
            log.info("Resumed fragment results from %s.", checkpoint_dir)
            for res in results:
                res.values = torch.as_tensor(res.values, dtype=torch.float32,
                                             device=dev)
        elif found:
            log.warning(
                f"Checkpoint at {checkpoint_dir} belongs to a different "
                "circuit/cut plan, or not every rank could read it; "
                "re-simulating."
            )
    try:
        if results is None:
            tracer.start_device_trace()
            with tracer.phase("simulate",
                              instances=virt.total_instantiations(),
                              engine=engine):
                if engine == "sharded":
                    from .ops.sharded_fragment import (
                        run_all_fragments_sharded,
                    )

                    results = run_all_fragments_sharded(
                        virt, max_local_qubits=max_local_qubits, mesh=mesh,
                        dtype=dtype, device=dev)
                else:
                    from .ops.variant_engine import run_all_fragments

                    results = run_all_fragments(virt, chunk_size, dev)
            if checkpoint_dir is not None:
                with tracer.phase("save_checkpoint"):
                    if world()[1] == 0:
                        # every rank holds the same rows: one writer
                        from .utils.checkpoint import save_fragment_results

                        save_fragment_results(results, checkpoint_dir,
                                              fingerprint=fingerprint)
                if engine == "sharded":
                    # no rank looks for the checkpoint before it is written
                    every_rank(True, dev)
        if shots is not None:
            from .ops.sampling import sample_fragment_results

            with tracer.phase("sample", shots=shots):
                results = sample_fragment_results(results, shots, seed)
        run_time = clock() - now

        log.info("Knitting...")
        now = clock()
        with tracer.phase("knit"):
            values, positions = knit_values(virt, results, keep_clbits)
        knit_time = clock() - now
    finally:
        tracer.stop_device_trace()
    log.info("Knitted in %.2fs.", knit_time)

    if project:
        with tracer.phase("project"):
            values = smolin_project(values).to(torch.float32)
    with span("port.fetch"):
        dist = Distribution(values.cpu().numpy(), positions,
                            virt.num_clbits)
    return dist, RunTimeInfo(run_time, knit_time)
