"""Pass interfaces and pipeline bookkeeping for the heuristic compiler.

Capability parity target: the vendored qvm pass interfaces
(third_party/qvm/qvm/compiler/types.py, util.py).  The design here is
different: passes are cheap stateless objects driven by a
:class:`PassLedger` that records, per stage, how much of the virtual-gate
budget was consumed and what the pass changed — the ledger doubles as the
structured trace the TPU pipeline logs for every compile.
"""
from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # avoid import cycles at runtime
    from ..circuit.circuit import Circuit
    from ..virt.virtual_circuit import VirtualCircuit


def num_virtual_gates(circuit: "Circuit") -> int:
    """Count virtual (QPD) operations currently present in ``circuit``.

    Role of qvm/compiler/util.py:6-7 in the reference inventory.
    """
    total = 0
    for ins in circuit.instructions:
        if ins.name == "vgate":
            total += 1
    return total


class VirtualizationPass(abc.ABC):
    """Circuit -> circuit rewrite that may insert virtual operations.

    Implementations must be budget-aware: ``run`` receives the number of
    additional virtual gates the caller is still willing to pay for and
    must return a circuit that does not exceed it (returning the input
    unchanged is always legal).
    """

    @abc.abstractmethod
    def run(self, circuit: "Circuit", budget: int) -> "Circuit":
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


class DistributedTranspilerPass(abc.ABC):
    """Post-fragmentation transform applied to a :class:`VirtualCircuit`
    (e.g. qubit reuse).  Mutates the virtual circuit in place."""

    @abc.abstractmethod
    def run(self, virt: "VirtualCircuit") -> None:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclass
class StageRecord:
    """One pipeline stage's accounting entry."""

    pass_name: str
    budget_before: int
    vgates_added: int
    seconds: float


@dataclass
class PassLedger:
    """Budget accounting across a pass pipeline.

    The reference's compile loop tracked a single mutable ``budget`` int
    (qvm/compiler/compiler.py:22-35); the ledger keeps the same semantics
    but records every stage so the compile is auditable.
    """

    initial_budget: int
    records: list[StageRecord] = field(default_factory=list)

    @property
    def remaining(self) -> int:
        spent = sum(r.vgates_added for r in self.records)
        return self.initial_budget - spent

    @property
    def exhausted(self) -> bool:
        return self.remaining <= 0

    def charge(self, pass_name: str, vgates_added: int, seconds: float) -> None:
        self.records.append(
            StageRecord(pass_name, self.remaining, vgates_added, seconds)
        )
        if self.remaining < 0:
            raise ValueError(
                f"pass {pass_name!r} exceeded the virtual-gate budget "
                f"({-self.remaining} over)"
            )

    def timed(self, pass_name: str):
        """Context manager: times a stage; caller charges separately."""
        return _StageTimer(self, pass_name)


class _StageTimer:
    def __init__(self, ledger: PassLedger, pass_name: str):
        self._ledger = ledger
        self._pass_name = pass_name
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False
