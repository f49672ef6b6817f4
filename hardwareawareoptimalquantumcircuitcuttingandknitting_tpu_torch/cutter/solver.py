"""Exact lexicographic cut-search solver.

First-party replacement for the z3 ``Optimize`` model of the reference
(src/HwAwareCutter/Cutter.py:292-571).  The optimisation problem is solved
exactly by branch-and-bound over partition assignments (vertices in creation
order; every edge to an earlier vertex is decided on assignment) with leaf
enumeration of the QPD-vs-teleport choice per cut edge.

Semantics replicated 1:1 from the reference model:
  * c_e  <=>  endpoints in different partitions            (Cutter.py:389-390)
  * Q_p  = |I ∩ p| + incoming cut wires + teleport touches (Cutter.py:411-438)
  * C_p  = QPD cuts touching p                             (Cutter.py:441-450)
  * cost tables gate-QPD S*=6 / wire-QPD S*=8,+1 ancilla / teleport S*=1,
    +2 ancilla, +10 latency                                (Cutter.py:452-471)
  * S = prod per-cut overhead, A = ancilla_total * S, L = sum latency
                                                           (Cutter.py:473-509)
  * capacity, forceNWireCuts/forceNGateCuts, maxNCuts, maxCutsPerPartitions
                                                           (Cutter.py:511-533)
  * maxNQpdCuts quirk: any teleport forces #QPD == maxNQpdCuts exactly
                                                           (Cutter.py:535-540)
  * soft constraint ordering QPD target indices before teleport sources,
    ranked before all minimisation objectives              (Cutter.py:542-564)
  * lexicographic objectives min(Q), min(S), min(A), min(L), min(C)
                                                           (Cutter.py:567-571)

Deliberate deviations (documented):
  * endpoints of non-virtualizable 2-qubit gates are constrained to one
    partition; the reference omits them from the model entirely and would
    emit an unrunnable split if the optimiser separated them
    (Cutter.py:351-354).
  * ``spare_capacity``: plans whose wire-cut count exceeds the circuit's
    spare slots (sum(caps) - num_qubits) are rejected in the model; the
    reference's z3 model misses this (its Q_p only counts gated qubits)
    and crashes at fragment time on "not enough available spots"
    (Cutter.py:684) when gate-less qubits no longer fit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .graph import GATE, GATE_UNCUTTABLE, WIRE, CutGraph
from .plan import CutDecision, CutPlan, PlanMetrics

# (sampling-overhead multiplier, ancilla, teleport latency) — Cutter.py:452-471
GATE_QPD_COST = (6, 0, 0)
WIRE_QPD_COST = (8, 1, 0)
TELE_COST = (1, 2, 10)


@dataclass
class SolverConfig:
    num_partitions: int
    caps: list[int]
    force_n_wire_cuts: int | None = None
    force_n_gate_cuts: int | None = None
    max_n_cuts: int | None = None
    max_n_qpd_cuts: int | None = None
    max_cuts_per_partition: int | None = None
    # total slots beyond the circuit's qubit count: sum(caps) - num_qubits.
    # Each wire cut materialises one vmove qubit at rewrite time, so plans
    # with n_wire_cuts > spare_capacity cannot be fragmented (the reference
    # misses this and raises "not enough available spots" at Cutter.py:684
    # — a documented deviation, see PARITY.md)
    spare_capacity: int | None = None
    exclude: frozenset = frozenset()  # previously returned solutions (re-solve)
    # (S-multiplier, ancilla, latency) cost tables; the native solver bakes
    # in the defaults, so custom tables route to the Python solver
    gate_qpd_cost: tuple = GATE_QPD_COST
    wire_qpd_cost: tuple = WIRE_QPD_COST
    tele_cost: tuple = TELE_COST
    # angle-aware objective: minimise the TRUE QPD 1-norm product instead
    # of the parity 6/8 multipliers (cutter/gamma.py; Cutter(gammaMode=...))
    gamma_mode: bool = False

    def has_default_costs(self) -> bool:
        return (
            tuple(self.gate_qpd_cost) == GATE_QPD_COST
            and tuple(self.wire_qpd_cost) == WIRE_QPD_COST
            and tuple(self.tele_cost) == TELE_COST
        )


_INF = (2, math.inf, math.inf, math.inf, math.inf, math.inf)


def _leaf_evaluate(graph, cfg, assignment, cut_edges, best_key):
    """Enumerate teleport choices for the cut set; return (key, plan) best."""
    p_count = cfg.num_partitions
    base_q = [0] * p_count
    for vi in graph.initial:
        base_q[assignment[vi]] += 1

    n_cuts = len(cut_edges)
    n_wire = sum(1 for (_, _, k) in cut_edges if k == WIRE)
    n_gate = n_cuts - n_wire

    if cfg.spare_capacity is not None and n_wire > cfg.spare_capacity:
        return None  # vmove qubits wouldn't fit any partition packing
    if cfg.force_n_wire_cuts is not None and n_wire != cfg.force_n_wire_cuts:
        return None
    if cfg.force_n_gate_cuts is not None and n_gate != cfg.force_n_gate_cuts:
        return None
    if cfg.max_n_cuts is not None and n_cuts > cfg.max_n_cuts:
        return None

    # teleport subsets: any teleport forces #QPD == maxNQpdCuts (Cutter quirk)
    if cfg.max_n_qpd_cuts is not None and n_cuts <= cfg.max_n_qpd_cuts:
        masks = (0,)
    else:
        masks = range(1 << n_cuts)

    best = None
    nv = graph.num_vertices
    for mask in masks:
        n_tele = bin(mask).count("1")
        n_qpd = n_cuts - n_tele
        if cfg.max_n_qpd_cuts is not None:
            if n_qpd > cfg.max_n_qpd_cuts:
                continue
            if n_tele > 0 and n_qpd != cfg.max_n_qpd_cuts:
                continue
        q_p = list(base_q)
        c_p = [0] * p_count
        s_total, anc_total, lat_total = 1, 0, 0
        qpd_max_v1 = -1
        tele_min_v0 = nv
        for i, (u, v, kind) in enumerate(cut_edges):
            tele = (mask >> i) & 1
            if kind == WIRE:
                q_p[assignment[v]] += 1  # second Q_p term, tele or not
            if tele:
                q_p[assignment[u]] += 1
                q_p[assignment[v]] += 1
                s_mult, anc, lat = cfg.tele_cost
                tele_min_v0 = min(tele_min_v0, u)
            else:
                s_mult, anc, lat = (
                    cfg.wire_qpd_cost if kind == WIRE else cfg.gate_qpd_cost
                )
                c_p[assignment[u]] += 1
                c_p[assignment[v]] += 1
                qpd_max_v1 = max(qpd_max_v1, v)
            s_total *= s_mult
            anc_total += anc
            lat_total += lat

        if any(q_p[p] > cfg.caps[p] for p in range(p_count)):
            continue
        if cfg.max_cuts_per_partition is not None and any(
            c > cfg.max_cuts_per_partition for c in c_p
        ):
            continue

        big_q = max(q_p) if q_p else 0
        big_c = max(c_p) if c_p else 0
        a_val = anc_total * s_total
        soft_ok = qpd_max_v1 < tele_min_v0
        key = (0 if soft_ok else 1, big_q, s_total, a_val, lat_total, big_c)
        if key < (best[0] if best else best_key):
            metrics = PlanMetrics(
                S=s_total, A=a_val, L=lat_total, Q=big_q, C=big_c,
                Q_p=q_p, C_p=c_p, n_wire_cuts=n_wire, n_gate_cuts=n_gate,
            )
            cuts = [
                CutDecision(
                    (u, v), "wire" if kind == WIRE else "gate",
                    bool((mask >> i) & 1),
                )
                for i, (u, v, kind) in enumerate(cut_edges)
            ]
            plan = CutPlan(p_count, list(assignment), cuts, metrics, soft_ok)
            if cfg.exclude and plan_signature(plan) in cfg.exclude:
                continue  # already enumerated: try the next mask/candidate
            best = (key, plan)
    return best


def solve_python(graph: CutGraph, cfg: SolverConfig) -> CutPlan | None:
    """Pure-Python exact search (reference implementation; the C++ solver in
    native/cutsolver.cc mirrors this loop)."""
    nv = graph.num_vertices
    if nv == 0:
        # no 2q gates at all (e.g. an edgeless QAOA graph): the trivial
        # cut-free plan — every gate-less qubit is packed by the rewrite's
        # leftover-capacity pass (Cutter.py:677-698 parity)
        if cfg.exclude:
            return None  # enumeration already emitted the only solution
        if (cfg.force_n_wire_cuts or 0) or (cfg.force_n_gate_cuts or 0):
            return None
        return CutPlan(
            cfg.num_partitions, [], [],
            PlanMetrics(
                S=1, A=0, L=0, Q=0, C=0,
                Q_p=[0] * cfg.num_partitions,
                C_p=[0] * cfg.num_partitions,
                n_wire_cuts=0, n_gate_cuts=0,
            ),
            True,  # zero cuts: the soft ordering is trivially satisfied
        )
    assert cfg.num_partitions <= nv  # Cutter.py:364

    # edges to earlier vertices, grouped by the later vertex
    adj_prev: list[list[tuple[int, int, int]]] = [[] for _ in range(nv)]
    for u, v, kind in graph.edges:
        adj_prev[v].append((u, v, kind))

    n_wire_total = sum(1 for e in graph.edges if e[2] == WIRE)
    n_gate_total = sum(1 for e in graph.edges if e[2] == GATE)

    # remaining cuttable edges whose later vertex is >= v (for force pruning)
    rem_wire = [0] * (nv + 1)
    rem_gate = [0] * (nv + 1)
    for v in range(nv - 1, -1, -1):
        rem_wire[v] = rem_wire[v + 1] + sum(
            1 for e in adj_prev[v] if e[2] == WIRE
        )
        rem_gate[v] = rem_gate[v + 1] + sum(
            1 for e in adj_prev[v] if e[2] == GATE
        )

    cut_bound = cfg.max_n_cuts
    if cut_bound is None:
        forced = 0
        if cfg.force_n_wire_cuts is not None and cfg.force_n_gate_cuts is not None:
            cut_bound = cfg.force_n_wire_cuts + cfg.force_n_gate_cuts
        else:
            cut_bound = n_wire_total + n_gate_total  # exact but may be slow

    is_initial = [False] * nv
    for vi in graph.initial:
        is_initial[vi] = True

    symmetric = len(set(cfg.caps)) == 1
    min_qpd_cost = min(cfg.gate_qpd_cost[0], cfg.wire_qpd_cost[0])

    best: list = [_INF, None]
    assignment = [0] * nv
    cut_edges: list[tuple[int, int, int]] = []
    i_count = [0] * cfg.num_partitions
    wire_in = [0] * cfg.num_partitions  # lower-bound incoming wire cuts

    teleports_possible = not (
        cfg.max_n_qpd_cuts is not None
        and cut_bound is not None
        and cut_bound <= cfg.max_n_qpd_cuts
    )

    def dfs(v: int, n_wire: int, n_gate: int, used_max: int):
        if v == nv:
            res = _leaf_evaluate(graph, cfg, assignment, cut_edges, best[0])
            if res is not None and res[0] < best[0]:
                key, plan = res
                best[0] = key
                best[1] = plan
            return

        limit = cfg.num_partitions if not symmetric else min(
            cfg.num_partitions, used_max + 2
        )
        for p in range(limit):
            # decide edges into v
            new_cuts = []
            n_w, n_g = n_wire, n_gate
            ok = True
            for u, vv, kind in adj_prev[v]:
                if assignment[u] != p:
                    if kind == GATE_UNCUTTABLE:
                        ok = False
                        break
                    new_cuts.append((u, vv, kind))
                    if kind == WIRE:
                        n_w += 1
                    else:
                        n_g += 1
            if not ok:
                continue
            if n_w + n_g > cut_bound:
                continue
            if cfg.spare_capacity is not None and n_w > cfg.spare_capacity:
                continue
            if (
                cfg.force_n_wire_cuts is not None
                and (
                    n_w > cfg.force_n_wire_cuts
                    or n_w + rem_wire[v + 1] < cfg.force_n_wire_cuts
                )
            ):
                continue
            if (
                cfg.force_n_gate_cuts is not None
                and (
                    n_g > cfg.force_n_gate_cuts
                    or n_g + rem_gate[v + 1] < cfg.force_n_gate_cuts
                )
            ):
                continue
            if cfg.max_n_qpd_cuts is not None and not teleports_possible:
                if n_w + n_g > cfg.max_n_qpd_cuts:
                    continue

            # partial capacity/objective lower bounds
            d_i = 1 if is_initial[v] else 0
            i_count[p] += d_i
            for u, vv, kind in new_cuts:
                if kind == WIRE:
                    wire_in[p] += 1
            q_lb = max(
                i_count[q] + wire_in[q] for q in range(cfg.num_partitions)
            )
            cap_ok = all(
                i_count[q] + wire_in[q] <= cfg.caps[q]
                for q in range(cfg.num_partitions)
            )
            if cap_ok:
                if teleports_possible:
                    s_lb = 1
                else:
                    s_lb = min_qpd_cost ** (n_w + n_g)
                lb_key = (0, q_lb, s_lb, 0, 0, 0)
                if lb_key < best[0]:
                    assignment[v] = p
                    cut_edges.extend(new_cuts)
                    dfs(v + 1, n_w, n_g, max(used_max, p))
                    del cut_edges[len(cut_edges) - len(new_cuts):]
            i_count[p] -= d_i
            for u, vv, kind in new_cuts:
                if kind == WIRE:
                    wire_in[p] -= 1

    dfs(0, 0, 0, -1)
    return best[1]


def plan_signature(plan: CutPlan) -> tuple:
    """Hashable identity of a solution (for re-solve enumeration, mirroring
    repeated ``solve()`` calls in the reference, Cutter.py:96-102)."""
    return (
        tuple(plan.assignment),
        tuple((c.edge, c.kind, c.teleport) for c in plan.cuts),
    )


def solve(graph: CutGraph, cfg: SolverConfig) -> CutPlan | None:
    """Solve with the native C++ solver (cutter/native_solver.py, built
    at first use), or the pure-Python search where the native one does
    not apply: gamma mode, no vertices, excluded plans or a custom cost
    model.  A failed build of the native solver raises RuntimeError."""
    if cfg.gamma_mode:
        from .gamma import solve_gamma

        return solve_gamma(graph, cfg)
    if graph.num_vertices == 0:
        return solve_python(graph, cfg)  # trivial cut-free plan
    if not cfg.exclude and cfg.has_default_costs():
        from .native_solver import solve_native

        return solve_native(graph, cfg)
    return solve_python(graph, cfg)
