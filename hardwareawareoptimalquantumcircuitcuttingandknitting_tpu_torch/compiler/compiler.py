"""Heuristic compile pipelines (capability parity with the vendored qvm
compile loop, third_party/qvm/qvm/compiler/compiler.py).

A pipeline is data: an ordered tuple of virtualization passes followed by
an ordered tuple of distributed-transpiler passes.  Execution is handled
by one free function, :func:`compile_circuit`, which threads a
:class:`PassLedger` through the stages and returns the fragment container
plus the ledger (the auditable compile trace).  The class wrappers at the
bottom keep the reference's entry-point names for drop-in familiarity.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..circuit.circuit import Circuit
from ..utils.logger import get_logger
from ..virt.virtual_circuit import VirtualCircuit
from .qubit_reuser import QubitReuser
from .types import (
    DistributedTranspilerPass,
    PassLedger,
    VirtualizationPass,
    num_virtual_gates,
)


@dataclass(frozen=True)
class Pipeline:
    """A declarative compile recipe."""

    virtualization: tuple[VirtualizationPass, ...] = ()
    transpilation: tuple[DistributedTranspilerPass, ...] = field(
        default_factory=tuple
    )


def compile_circuit(
    pipeline: Pipeline, circuit: Circuit, budget: int
) -> tuple[VirtualCircuit, PassLedger]:
    """Run ``pipeline`` over ``circuit`` under a virtual-gate ``budget``.

    Stops early once the budget is exhausted; raises if a pass oversteps
    it (same guarantee the reference enforces at compiler.py:27-30, but
    checked per stage by the ledger).
    """
    log = get_logger(__name__)
    ledger = PassLedger(budget)
    work = circuit.copy()

    for vpass in pipeline.virtualization:
        if ledger.exhausted:
            log.debug(f"budget exhausted before {vpass.name}; stopping")
            break
        before = num_virtual_gates(work)
        with ledger.timed(vpass.name) as timer:
            work = vpass.run(work, ledger.remaining)
        ledger.charge(vpass.name, num_virtual_gates(work) - before, timer.seconds)

    # Circuit-level transpilers (qubit reuse) must see the flat cut
    # circuit; fragment-level ones get the VirtualCircuit afterwards.
    fragment_level: list[DistributedTranspilerPass] = []
    for tpass in pipeline.transpilation:
        if hasattr(tpass, "run_on_circuit"):
            with ledger.timed(tpass.name) as timer:
                work = tpass.run_on_circuit(work)
            ledger.charge(tpass.name, 0, timer.seconds)
        else:
            fragment_level.append(tpass)

    virt = VirtualCircuit(work)
    for tpass in fragment_level:
        with ledger.timed(tpass.name) as timer:
            tpass.run(virt)
        ledger.charge(tpass.name, 0, timer.seconds)
    return virt, ledger


class QVMCompiler:
    """Name-compatible wrapper over :func:`compile_circuit`."""

    def __init__(self, virt_passes=None, dt_passes=None):
        self.pipeline = Pipeline(
            tuple(virt_passes or ()), tuple(dt_passes or ())
        )

    def run(self, circuit: Circuit, budget: int) -> VirtualCircuit:
        virt, _ledger = compile_circuit(self.pipeline, circuit, budget)
        return virt


def standard_pipeline(size_to_reach: int) -> Pipeline:
    """Gate decomposition + greedy dependency breaking + qubit reuse —
    the reference's StandardQVMCompiler recipe."""
    from .passes import GreedyDependencyBreaker, OptimalDecompositionPass

    return Pipeline(
        (OptimalDecompositionPass(size_to_reach), GreedyDependencyBreaker()),
        (QubitReuser(size_to_reach),),
    )


def cutter_pipeline(size_to_reach: int) -> Pipeline:
    """Gate decomposition only — the reference's CutterCompiler recipe."""
    from .passes import OptimalDecompositionPass

    return Pipeline((OptimalDecompositionPass(size_to_reach),))


class StandardQVMCompiler(QVMCompiler):
    def __init__(self, size_to_reach: int) -> None:
        super().__init__()
        self.pipeline = standard_pipeline(size_to_reach)


class CutterCompiler(QVMCompiler):
    def __init__(self, size_to_reach: int) -> None:
        super().__init__()
        self.pipeline = cutter_pipeline(size_to_reach)
