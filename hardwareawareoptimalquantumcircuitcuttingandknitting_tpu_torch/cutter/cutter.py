"""Cutter facade: the reference-compatible entry point.

API parity with src/HwAwareCutter/Cutter.py:40-209 — constructor signature,
``solve() -> bool`` (repeat calls enumerate further solutions),
``getResultCircs()``, ``getModelKeyResults()``, ``logOptimizerResults()`` —
plus ``plan`` / ``save_plan`` for the serialisable cut-plan artifact the
reference lacks (SURVEY §5).
"""
from __future__ import annotations

import logging
from typing import List, Tuple

from ..circuit.circuit import Circuit
from ..utils.logger import get_logger
from ..utils.profiling import spanned
from ..virt.virtual_circuit import VirtualCircuit
from .graph import read_circuit
from .plan import CutPlan
from .rewrite import (
    apply_gate_cuts_and_mark_wire_cuts,
    compute_fragments,
    fragment_circuit,
    replace_wire_cut_marks_with_moves,
)
from .solver import SolverConfig, plan_signature, solve


class Cutter:
    @spanned("port.cutter")
    def __init__(
        self,
        inputCirc: Circuit,
        maxNPartitions: int = 2,
        maxNQubitsPerPartition: int | List[int] = 10,
        forceNWireCuts: int | None = None,
        forceNGateCuts: int | None = None,
        maxNQpdCuts: int | None = None,
        maxNCuts: int | None = None,
        maxCutsPerPartitions: int | None = None,
        costModel=None,
        gammaMode: bool = False,
    ) -> None:
        self.logger = get_logger(__name__)
        self.inputCirc = inputCirc.copy()
        self.maxNPartitions = maxNPartitions

        if isinstance(maxNQubitsPerPartition, int):
            caps = [maxNQubitsPerPartition] * maxNPartitions
        elif isinstance(maxNQubitsPerPartition, list):
            caps = list(maxNQubitsPerPartition)
        else:
            raise RuntimeError("Invalid type")
        # config validation mirrors the reference's asserts (Cutter.py:52-82)
        # but raises ValueError so the checks survive ``python -O``
        if len(caps) != maxNPartitions:
            raise ValueError(
                f"maxNQubitsPerPartition has {len(caps)} entries for "
                f"{maxNPartitions} partitions"
            )
        if inputCirc.num_qubits > sum(caps):
            raise ValueError(
                f"circuit has {inputCirc.num_qubits} qubits but the "
                f"partitions hold only {sum(caps)} in total"
            )
        if forceNWireCuts is not None and forceNWireCuts < 0:
            raise ValueError("forceNWireCuts must be >= 0")
        if forceNGateCuts is not None and forceNGateCuts < 0:
            raise ValueError("forceNGateCuts must be >= 0")
        if maxNCuts is not None:
            if maxNCuts <= 0:
                raise ValueError("maxNCuts must be > 0")
            if maxNCuts < (forceNWireCuts or 0) + (forceNGateCuts or 0):
                raise ValueError("maxNCuts is below the forced cut counts")
        if maxNQpdCuts is not None:
            if maxNQpdCuts < 0:
                raise ValueError("maxNQpdCuts must be >= 0")
            if maxNCuts is not None and maxNQpdCuts > maxNCuts:
                raise ValueError("maxNQpdCuts exceeds maxNCuts")
        if maxCutsPerPartitions is not None and maxCutsPerPartitions <= 0:
            raise ValueError("maxCutsPerPartitions must be > 0")

        self.maxNQubitsPerPartition = caps
        self.decomposedCirc = inputCirc.decompose()
        self.graph = read_circuit(self.decomposedCirc)
        if 0 < self.graph.num_vertices < maxNPartitions:
            # reference asserts mid-solve (Cutter.py:364); fail fast with a
            # clear message instead
            raise ValueError(
                f"maxNPartitions={maxNPartitions} exceeds the circuit's "
                f"{self.graph.num_vertices} cut-graph vertices"
            )
        # angle-aware objective (cutter/gamma.py): the per-cut cost is the
        # TRUE QPD 1-norm (gamma(cp(theta)) -> 1 for small theta) instead
        # of the reference's flat 6/8 multipliers (Cutter.py:452-471) —
        # opt-in; the parity table stays the default
        cost_kwargs = {}
        if costModel is not None:
            # utils.config.CostModel (or duck-typed equivalent): replaces
            # the reference's inline cost tables (Cutter.py:452-471);
            # non-default costs route to the Python solver twin
            cost_kwargs = dict(
                gate_qpd_cost=(
                    costModel.gate_qpd_overhead,
                    costModel.gate_qpd_ancilla, 0,
                ),
                wire_qpd_cost=(
                    costModel.wire_qpd_overhead,
                    costModel.wire_qpd_ancilla, 0,
                ),
                tele_cost=(
                    costModel.tele_overhead, costModel.tele_ancilla,
                    costModel.tele_latency,
                ),
            )
        self.cfg = SolverConfig(
            num_partitions=maxNPartitions,
            caps=caps,
            force_n_wire_cuts=forceNWireCuts,
            force_n_gate_cuts=forceNGateCuts,
            max_n_cuts=maxNCuts,
            max_n_qpd_cuts=maxNQpdCuts,
            max_cuts_per_partition=maxCutsPerPartitions,
            spare_capacity=sum(caps) - inputCirc.num_qubits,
            gamma_mode=gammaMode,
            **cost_kwargs,
        )
        self.plan: CutPlan | None = None
        self.nWireCuts = 0
        self.nGateCuts = 0
        self._seen: set = set()

    # ------------------------------------------------------------------
    @spanned("port.cut")
    def solve(self) -> bool:
        """Find the (next) lexicographically optimal cut.  Repeat calls
        enumerate further solutions (Cutter.py:96-102)."""
        self.cfg.exclude = frozenset(self._seen)
        plan = solve(self.graph, self.cfg)
        if plan is None:
            return False
        self.plan = plan
        self._seen.add(plan_signature(plan))
        self.nWireCuts = plan.metrics.n_wire_cuts
        self.nGateCuts = plan.metrics.n_gate_cuts
        return True

    # ------------------------------------------------------------------
    @spanned("port.cut")
    def getResultCircs(
        self, getInstantiations: bool = False
    ) -> Tuple[Circuit, Circuit, Circuit, Circuit, list]:
        if self.plan is None:
            raise RuntimeError("no model exists")

        copied = self.decomposedCirc.copy()
        graph = read_circuit(copied)  # re-derive V against the copy

        marked = apply_gate_cuts_and_mark_wire_cuts(copied, graph, self.plan)
        marked_with_moves, vmove_to_vidx, move_qubits = (
            replace_wire_cut_marks_with_moves(marked)
        )
        fragments = compute_fragments(
            marked_with_moves, graph, self.plan,
            self.maxNQubitsPerPartition, vmove_to_vidx, move_qubits,
        )
        if self.logger.isEnabledFor(logging.DEBUG):
            for idx, frag in enumerate(fragments):
                names = [
                    "{}{}".format(*marked_with_moves.qubit_info(q))
                    for q in frag
                ]
                self.logger.debug("    %d: %s", idx, names)
        cut_circ, qubit_map = fragment_circuit(marked_with_moves, fragments)

        insts = []
        if getInstantiations:
            insts = generate_instantiation_circuits(VirtualCircuit(cut_circ))
        return (self.decomposedCirc, marked, marked_with_moves, cut_circ, insts)

    # ------------------------------------------------------------------
    def getModelKeyResults(self):
        """Returns (S, A, L, nWireCuts, nGateCuts, Q, Q_pArr, C, C_pArr) —
        reference: Cutter.py:164-179."""
        if self.plan is None:
            raise RuntimeError("no model exists")
        m = self.plan.metrics
        return (
            m.S, m.A, m.L, m.n_wire_cuts, m.n_gate_cuts,
            m.Q, list(m.Q_p), m.C, list(m.C_p),
        )

    def logOptimizerResults(self) -> None:
        if self.plan is None:
            raise RuntimeError("no model exists")
        self.logger.debug("O_vp results: ")
        for v_idx, p_idx in enumerate(self.plan.assignment):
            self.logger.debug(f"    o_{v_idx}_{p_idx} = True")
        qpd, tele = [], []
        for cut in self.plan.cuts:
            if cut.teleport:
                tele.append(cut.edge[0])
            else:
                qpd.append(cut.edge[1])
        self.logger.debug(f"Edges (nVertices = {self.graph.num_vertices}):")
        self.logger.debug(f"    qpdEdgesVIdx: {sorted(qpd)}")
        self.logger.debug(f"    teleportEdgesVIdx: {sorted(tele)}")

    def save_plan(self, path) -> None:
        if self.plan is None:
            raise RuntimeError("no model exists")
        self.plan.save(path)

    @spanned("port.cut")
    def use_plan(self, plan: CutPlan) -> None:
        """Adopt a previously solved plan (solve once / cut many): the
        plan's vertex indices must come from a circuit with the same
        gate structure (e.g. the same ansatz with new parameters)."""
        if len(plan.assignment) != self.graph.num_vertices:
            raise ValueError(
                f"plan covers {len(plan.assignment)} cut-graph vertices, "
                f"this circuit has {self.graph.num_vertices}"
            )
        if plan.num_partitions != self.maxNPartitions:
            raise ValueError(
                f"plan has {plan.num_partitions} partitions, cutter was "
                f"configured for {self.maxNPartitions}"
            )
        for cut in plan.cuts:
            for v in cut.edge:
                if v >= self.graph.num_vertices:
                    raise ValueError(
                        "plan does not match this circuit's cut graph"
                    )
        self.plan = plan
        self.nWireCuts = plan.metrics.n_wire_cuts
        self.nGateCuts = plan.metrics.n_gate_cuts


def generate_instantiation_circuits(virt: VirtualCircuit) -> list[list[Circuit]]:
    """Materialise every variant of every fragment as an explicit circuit
    (artifact/visualisation parity with Cutter._generateInstantiation,
    Cutter.py:702-708; the engine itself never builds these)."""
    from ..circuit.circuit import Instruction, Register

    out: list[list[Circuit]] = []
    for reg in virt.fragments:
        prog = virt.programs[reg.name]
        n_inst = [virt.vgates[g].num_instantiations for g in prog.touching]
        total = 1
        for n in n_inst:
            total *= n
        variants = []
        for flat in range(total):
            # decode flat -> per-vgate variant (last fastest)
            idx = {}
            rem = flat
            for g, n in zip(reversed(prog.touching), reversed(n_inst)):
                idx[g] = rem % n
                rem //= n
            c = Circuit(
                [Register(reg.name, prog.num_data_qubits)],
                virt.num_clbits + len(virt.vgates),
                name=f"{reg.name}_{flat}",
            )
            for kind, payload in prog.source:
                if kind == "ins":
                    c.instructions.append(payload.copy())
                    continue
                g, side, lq = payload
                spec = virt.vgates[g].spec
                ev = spec.endpoints[idx[g]][side]
                c.instructions.append(
                    Instruction("unitary", [lq], op=ev.pre)
                )
                if ev.measure:
                    c.instructions.append(
                        Instruction("measure", [lq], [virt.vgate_clbit(g)])
                    )
                c.instructions.append(
                    Instruction("unitary", [lq], op=ev.post)
                )
            variants.append(c)
        out.append(variants)
    return out
