"""Typed configuration for the whole pipeline.

The reference scatters its configuration over module constants and kwargs
(SURVEY §5: CUT_ONLY benchmark.py:20, nShots benchmark.py:94, Pool size
run.py:64, shots default run.py:24, ACCURACY quasi_distr.py:3, cost tables
inline in Cutter.py:452-471).  Here everything lives in one dataclass tree.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class CostModel:
    """Per-cut cost table (reference: Cutter.py:452-471)."""

    gate_qpd_overhead: int = 6
    gate_qpd_ancilla: int = 0
    wire_qpd_overhead: int = 8
    wire_qpd_ancilla: int = 1
    tele_overhead: int = 1
    tele_ancilla: int = 2
    tele_latency: int = 10


@dataclass
class CutterConfig:
    max_n_partitions: int = 2
    max_n_qubits_per_partition: int | list[int] = 10
    force_n_wire_cuts: int | None = None
    force_n_gate_cuts: int | None = None
    max_n_qpd_cuts: int | None = 5
    max_n_cuts: int | None = 5
    max_cuts_per_partition: int | None = 5
    cost_model: CostModel = field(default_factory=CostModel)


@dataclass
class ExecutionConfig:
    shots: int | None = None         # None = exact path
    engine: str = "auto"             # auto | xla | streamed | sharded | pallas
    chunk_size: int = 1024
    seed: int = 0
    project: bool = True             # Smolin projection on the output
    mesh_dp: int | None = None       # variant-axis devices
    mesh_tp: int | None = None       # knit/amplitude-axis devices


@dataclass
class PipelineConfig:
    cutter: CutterConfig = field(default_factory=CutterConfig)
    execution: ExecutionConfig = field(default_factory=ExecutionConfig)
    cut_only: bool = False           # reference CUT_ONLY (benchmark.py:20)
    results_dir: str = "./benchmark_results"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "PipelineConfig":
        d = json.loads(text)
        cm = CostModel(**d["cutter"].pop("cost_model", {}))
        return PipelineConfig(
            CutterConfig(cost_model=cm, **d["cutter"]),
            ExecutionConfig(**d["execution"]),
            d.get("cut_only", False),
            d.get("results_dir", "./benchmark_results"),
        )


def make_cutter(circ, cfg: CutterConfig):
    from ..cutter.cutter import Cutter

    return Cutter(
        circ,
        maxNPartitions=cfg.max_n_partitions,
        maxNQubitsPerPartition=cfg.max_n_qubits_per_partition,
        forceNWireCuts=cfg.force_n_wire_cuts,
        forceNGateCuts=cfg.force_n_gate_cuts,
        maxNQpdCuts=cfg.max_n_qpd_cuts,
        maxNCuts=cfg.max_n_cuts,
        maxCutsPerPartitions=cfg.max_cuts_per_partition,
        costModel=cfg.cost_model,
    )
