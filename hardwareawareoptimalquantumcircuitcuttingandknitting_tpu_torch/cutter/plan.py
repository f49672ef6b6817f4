"""CutPlan: the serializable artifact emitted by the cut search.

The reference never serialises its solver state (SURVEY §5 checkpoint/resume
= none); making the plan a JSON artifact enables solve-once / simulate-many
and resume.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field


@dataclass
class CutDecision:
    edge: tuple[int, int]   # vertex pair
    kind: str               # "wire" | "gate"
    teleport: bool = False  # plan-level only (Cutter.py:574 FIXME parity)


@dataclass
class PlanMetrics:
    """Reference: getModelKeyResults (Cutter.py:164-179)."""

    S: int = 1
    A: int = 0
    L: int = 0
    Q: int = 0
    C: int = 0
    Q_p: list[int] = field(default_factory=list)
    C_p: list[int] = field(default_factory=list)
    n_wire_cuts: int = 0
    n_gate_cuts: int = 0


@dataclass
class CutPlan:
    num_partitions: int
    assignment: list[int]            # vertex -> partition
    cuts: list[CutDecision]
    metrics: PlanMetrics
    soft_satisfied: bool = True

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "CutPlan":
        d = json.loads(text)
        return CutPlan(
            d["num_partitions"],
            d["assignment"],
            [
                CutDecision(
                    tuple(c["edge"]), c["kind"], c.get("teleport", False)
                )
                for c in d["cuts"]
            ],
            PlanMetrics(**d["metrics"]),
            d.get("soft_satisfied", True),
        )

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path) -> "CutPlan":
        with open(path) as f:
            return CutPlan.from_json(f.read())
