"""Execution runtime: run all fragments and knit.

Port of the JAX package's ``run.run_virtual_circuit`` for
``engine="pallas"``: the streamed label scan with every fragment's rows
from a hand-written kernel, exact (``shots=None``).  Fragments of up to 20
simulated qubits run the fold-fused variant kernel
(ops/variant_kernel.py), 21..24 qubits the segmented blocked kernel
(ops/blocked_kernel.py); past 24 the call raises naming the sharded
engine's ROADMAP item.  At widths where the full distribution cannot
exist (2^40 outcomes), ask for a marginal (``keep_clbits``) or use
``ops.streamed.streamed_expectation_z``.
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
    "sampled": "queue A, 'other engines' (sampled) and queue B, kernel 3",
}


@dataclass
class RunTimeInfo:
    """Phase timings (reference: qvm/run.py:17-20, extended)."""

    run_time: float
    knit_time: float


def run_virtual_circuit(
    virt: VirtualCircuit,
    shots: int | None = None,
    chunk_size: int = 1024,
    project: bool = True,
    engine: str = "pallas",
    keep_clbits=None,
    device=None,
) -> tuple[Distribution, RunTimeInfo]:
    """Simulate every QPD label of every fragment, knit and (``project``)
    project onto the simplex.  ``engine="pallas"`` is the only engine of
    this package (the JAX package's default is "auto"): the streamed scan
    over global label chunks of ``chunk_size`` (capped by the widest
    fragment's state size), every fragment's rows from its kernel and
    folded per chunk, so sim and knit fuse and ``RunTimeInfo.knit_time``
    is 0.  ``keep_clbits``: marginal knit.  ``device``: None = "cuda"
    (raises without a card); "cpu" runs the kernels' plain PyTorch
    versions.  ``run_time`` ends after the result
    reached the host."""
    if engine in _NOT_PORTED:
        raise NotImplementedError(
            f"engine={engine!r} is not ported to the torch package yet: "
            f"ROADMAP H100 port, {_NOT_PORTED[engine]}"
        )
    if engine != "pallas":
        raise ValueError(f"unknown engine {engine!r}")
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
