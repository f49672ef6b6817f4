"""Angle-aware cut search: minimise the TRUE sampling 1-norm gamma_total.

Copy of the JAX package's ``cutter/gamma.py`` (pure Python, relative
imports).

The reference's cost model charges every gate cut a flat sampling
multiplier of 6 and every wire cut 8 (src/HwAwareCutter/Cutter.py:452-471)
— angle-blind: the actual QPD 1-norm of a parameterised cut gate depends
on its angle (the reference's qvm/virtual_gates.py:262-291,
cos/sin(theta/2) coefficients), with gamma(cp(theta)) -> 1 as theta -> 0.
On QFT-class circuits the difference is the whole story: qft-16's minimum
cut set is 15 crossing cp gates (S_parity = 6^15 ~ 4.7e11, proved
infeasible at the reference model — qft16_boundary.json), while the true
gamma_total of the same cuts is ~8.5 (kappa = gamma^2 ~ 73), squarely
inside the sampled engine's budget (ops/qpd_sampling.py).

``gamma_mode`` (Cutter(gammaMode=True)) replaces the per-cut parity
multipliers with each candidate edge's true QPD 1-norm
(:func:`gamma_of_edge`, the solver-side twin of
ops/qpd_sampling.cut_gammas — the two share the ``sum_v max_b |coef|``
convention) and minimises the product.  The reference-parity table stays
the default.

SEARCH SPACE (r5: the FULL plan space, exactly).  Every full-space plan
— per-vertex partition assignments, so wire cuts are in play — induces,
per qubit, a segmentation of its timeline into maximal same-partition
runs; conversely a choice of wire-split points plus a per-segment
partition assignment IS a full-space plan.  :func:`solve_gamma`
therefore enumerates wire-split combinations with w ascending (w = 0 is
the classic static search) and runs a seeded group-level
branch-and-bound per combination (:func:`_solve_with_splits`).  The
enumeration STOPS when ``4^w >= best_gamma``: every wire cut multiplies
gamma by exactly 4 (the move QPD's 1-norm), so a plan with w wire cuts
costs at least 4^w and deeper levels cannot improve — this makes the
search exact over ALL plans, usually after w <= 2.  The
full-plan-space differential in tests/test_gamma_mode.py locks this
against independent brute-force enumeration AND against the
vertex-level B&B (:func:`solve_gamma_vertex`, an independent second
implementation kept for cross-checks).

Wire cuts genuinely matter here: a single wire cut (gamma 4) displaces
EVERY gate cut between one qubit-timeline segment and a neighbouring
group — two crossing cx gates already cost 3*3 = 9 > 4, and on qft-16
one wire cut plus the cheap small-angle tail beats the static 15-cut
plan's 8.57 — so the r4 claim that static plans suffice was wrong in
general and is retired (the counterexample is locked as a test).

BUDGET (documented): instances whose incumbent gamma stays above 4^w
for large w (uniform cx-heavy graphs with many wire slots) can make the
combination count explode; :data:`SPLIT_COMBO_BUDGET` bounds the
enumeration and the result is then optimal among plans with <= w_max
wire cuts (logged).  Teleport cuts are never selected: gamma_mode
optimises QPD sampling cost, which teleportation does not incur (the
reference treats teleport cuts as cost-model-only anyway, Cutter.py:574
FIXME).
"""
from __future__ import annotations

import math

from ..virt.tables import VIRTUAL_GATE_NAMES, spec_for
from .graph import GATE, GATE_UNCUTTABLE, WIRE, CutGraph
from .plan import CutDecision, CutPlan, PlanMetrics
from .solver import plan_signature


def gamma_of_spec(spec) -> float:
    """QPD sampling 1-norm ``gamma = sum_v max_b |coef[v, b]|`` — MUST
    match ops/qpd_sampling._variant_magnitudes' convention (the sampled
    engine draws with exactly these magnitudes; the solver objective and
    the runtime budget must be the same number, tested in
    tests/test_gamma_mode.py)."""
    import numpy as np

    coef = np.asarray(spec.coef, np.float64)
    return float(np.maximum(np.abs(coef[:, 0]), np.abs(coef[:, 1])).sum())


def gamma_of_edge(graph: CutGraph, edge_idx: int) -> float:
    """True QPD 1-norm of cutting candidate edge ``edge_idx``: the gate's
    angle-aware gamma for GATE edges (cx/cy/cz = 3, rzz/cp = cos/sin
    table sums), the wire-move gamma 4 for WIRE edges, +inf for
    uncuttable gates."""
    u, v, kind = graph.edges[edge_idx]
    if kind == WIRE:
        return gamma_of_spec(spec_for("move"))
    if kind == GATE_UNCUTTABLE:
        return math.inf
    ins = graph.vertices[u].instr
    assert ins.name in VIRTUAL_GATE_NAMES, ins.name
    return gamma_of_spec(spec_for(ins.name, ins.params))


def solve_gamma_static(graph: CutGraph, cfg) -> CutPlan | None:
    """Phase-1 gamma search over STATIC plans (no wire cuts): the
    ``split_edges=()`` case of :func:`_solve_with_splits`.  Kept as a
    named entry point for seeding and for tests."""
    if cfg.force_n_wire_cuts:
        return None  # static plans have no wire cuts
    return _solve_with_splits(graph, cfg, ())


def _solve_with_splits(
    graph: CutGraph, cfg, split_edges: tuple,
    seed_key=None,
) -> CutPlan | None:
    """Group-level gamma branch-and-bound with the qubit timelines SPLIT
    at the WIRE edges in ``split_edges``: each split starts a new
    timeline *segment*, segments merge into groups via union-find over
    uncuttable gate edges, and the B&B assigns groups to partitions.
    A split edge whose two segments land in different partitions is a
    wire cut (gamma = 4, +1 qubit in the receiving partition — the
    reference's Q_p wire term, Cutter.py:411-438); same partition = no
    cut, no cost.  With ``split_edges=()`` this is exactly the static
    search; :func:`solve_gamma` enumerates split combinations w
    ascending, which covers the FULL plan space (every per-vertex
    assignment induces per-qubit maximal same-partition runs = a split
    set + a segment assignment).

    Lexicographic objective: (gamma_total, Q, C) — sampling cost FIRST
    (deliberately reordered vs the parity mode's Q-first key: when the
    point is minimising kappa = gamma^2, a wider-but-cheaper fragment
    beats a balanced-but-expensive split; capacity still binds Q_p
    hard).  ``seed_key``: prime the bound with an already-found plan's
    key (strict improvement required).
    """
    nv = graph.num_vertices
    if nv == 0:
        if cfg.exclude or cfg.force_n_gate_cuts:
            return None
        return CutPlan(
            cfg.num_partitions, [], [],
            PlanMetrics(
                S=1.0, A=0, L=0, Q=0, C=0,
                Q_p=[0] * cfg.num_partitions,
                C_p=[0] * cfg.num_partitions,
                n_wire_cuts=0, n_gate_cuts=0,
            ),
            True,
        )
    if cfg.num_partitions > nv:
        raise ValueError("more partitions than cut-graph vertices")

    # ---- timeline segments (units) ------------------------------------
    # unit = maximal run of one qubit's vertices between split edges
    split_start = {}  # later-endpoint vertex -> split edge index
    for ei in split_edges:
        u, v, kind = graph.edges[ei]
        assert kind == WIRE, (ei, kind)
        split_start[v] = ei
    unit_of_vertex = [0] * nv
    units = []          # per unit: qubit
    first_unit = {}     # qubit -> unit idx of its first segment
    unit_pred = {}      # unit -> (pred_unit, (u, v)) for later segments
    last_unit_of_qubit = {}
    last_vertex_of_qubit = {}
    for vi, vtx in enumerate(graph.vertices):
        q = vtx.qubit
        if q not in last_unit_of_qubit:
            ui = len(units)
            units.append(q)
            first_unit[q] = ui
        elif vi in split_start:
            ui = len(units)
            units.append(q)
            unit_pred[ui] = (
                last_unit_of_qubit[q],
                (last_vertex_of_qubit[q], vi),
            )
        else:
            ui = last_unit_of_qubit[q]
        last_unit_of_qubit[q] = ui
        last_vertex_of_qubit[q] = vi
        unit_of_vertex[vi] = ui
    nu = len(units)

    # sanity: every requested split must start a unit (the edge's later
    # endpoint is the first vertex of a new segment); a WIRE edge always
    # connects consecutive same-qubit vertices so this holds
    # ---- union-find over uncuttable gate edges (on units) -------------
    parent = list(range(nu))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for (u, v, kind) in graph.edges:
        if kind == GATE_UNCUTTABLE:
            a = find(unit_of_vertex[u])
            b = find(unit_of_vertex[v])
            if a != b:
                parent[max(a, b)] = min(a, b)

    roots = sorted({find(i) for i in range(nu)})
    group_of_unit = [roots.index(find(i)) for i in range(nu)]
    ng = len(roots)
    # base size: first segments carry their qubit unconditionally; later
    # segments only materialise a (vmove) qubit when CUT from their pred
    base_size = [0] * ng
    for q, ui in first_unit.items():
        base_size[group_of_unit[ui]] += 1

    # ---- candidates grouped by the LATER group in dfs order -----------
    # entry: (other_group, gamma, (u, v), kind, qp_group | -1)
    cand: list[list[tuple]] = [[] for _ in range(ng)]
    n_gate_cand = 0
    n_wire_cand = 0
    for ei, (u, v, kind) in enumerate(graph.edges):
        if kind == GATE:
            ga = group_of_unit[unit_of_vertex[u]]
            gb = group_of_unit[unit_of_vertex[v]]
            if ga == gb:
                continue
            g_lo, g_hi = min(ga, gb), max(ga, gb)
            cand[g_hi].append(
                (g_lo, gamma_of_edge(graph, ei), (u, v), GATE, -1)
            )
            n_gate_cand += 1
    vacuous = False
    for ui, (pu, (eu, ev)) in unit_pred.items():
        ga = group_of_unit[pu]
        gb = group_of_unit[ui]
        if ga == gb:
            vacuous = True  # uncuttable merge: this split can never cut
            continue
        g_lo, g_hi = min(ga, gb), max(ga, gb)
        # the receiving partition (later segment, holds the moved wire)
        cand[g_hi].append(
            (g_lo, gamma_of_spec(spec_for("move")), (eu, ev), WIRE, gb)
        )
        n_wire_cand += 1
    if vacuous and split_edges:
        # covered by the smaller-w combination that drops the vacuous
        # split — skip to avoid duplicate plans
        return None

    # remaining wire candidates at group >= g (force pruning)
    rem_wire = [0] * (ng + 1)
    for g in range(ng - 1, -1, -1):
        rem_wire[g] = rem_wire[g + 1] + sum(
            1 for c in cand[g] if c[3] == WIRE
        )

    cut_bound = cfg.max_n_cuts
    if cfg.max_n_qpd_cuts is not None:
        cut_bound = (cfg.max_n_qpd_cuts if cut_bound is None
                     else min(cut_bound, cfg.max_n_qpd_cuts))
    if cut_bound is None:
        cut_bound = n_gate_cand + n_wire_cand
    if cfg.force_n_gate_cuts is not None and \
            cfg.force_n_gate_cuts > cut_bound:
        return None

    P = cfg.num_partitions
    symmetric = len(set(cfg.caps)) == 1
    INF_KEY = (math.inf, math.inf, math.inf)
    best: list = [seed_key if seed_key is not None else INF_KEY, None]

    assign = [0] * ng
    q_p = [0] * P
    # cut entries: (gamma, (u, v), kind, partition_u, partition_v)
    cut_list: list[tuple] = []

    def leaf() -> None:
        n_cuts = len(cut_list)
        n_wire = sum(1 for c in cut_list if c[2] == WIRE)
        n_gate = n_cuts - n_wire
        if cfg.force_n_gate_cuts is not None and \
                n_gate != cfg.force_n_gate_cuts:
            return
        if cfg.force_n_wire_cuts is not None and \
                n_wire != cfg.force_n_wire_cuts:
            return
        c_p = [0] * P
        s_total = 1.0
        for gamma, _e, _k, pu, pv in cut_list:
            s_total *= gamma
            c_p[pu] += 1
            c_p[pv] += 1
        if cfg.max_cuts_per_partition is not None and any(
            c > cfg.max_cuts_per_partition for c in c_p
        ):
            return
        big_q = max(q_p)
        big_c = max(c_p) if c_p else 0
        key = (s_total, big_q, big_c)
        if key >= best[0]:
            return
        assignment = [
            assign[group_of_unit[unit_of_vertex[vi]]] for vi in range(nv)
        ]
        cuts = [
            CutDecision(e, "wire" if k == WIRE else "gate", False)
            for _g, e, k, _pu, _pv in cut_list
        ]
        metrics = PlanMetrics(
            S=s_total, A=n_wire * s_total, L=0, Q=big_q, C=big_c,
            Q_p=list(q_p), C_p=c_p,
            n_wire_cuts=n_wire, n_gate_cuts=n_gate,
        )
        plan = CutPlan(P, assignment, cuts, metrics, True)
        if cfg.exclude and plan_signature(plan) in cfg.exclude:
            return
        best[0] = key
        best[1] = plan

    def dfs(g: int, s_run: float, n_wire: int, used_max: int) -> None:
        if g == ng:
            leaf()
            return
        limit = min(P, used_max + 2) if symmetric else P
        for p in range(limit):
            new_cuts = []
            added_q = [0] * P
            added_q[p] += base_size[g]
            n_w = n_wire
            for (go, gamma, e, kind, gq) in cand[g]:
                po = assign[go]
                if po != p:
                    if kind == WIRE:
                        n_w += 1
                        # the moved wire lands with the later segment
                        added_q[p if gq == g else po] += 1
                    new_cuts.append((gamma, e, kind, po, p))
            if len(cut_list) + len(new_cuts) > cut_bound:
                continue
            if cfg.spare_capacity is not None and \
                    n_w > cfg.spare_capacity:
                continue
            if cfg.force_n_wire_cuts is not None and (
                n_w > cfg.force_n_wire_cuts
                or n_w + rem_wire[g + 1] < cfg.force_n_wire_cuts
            ):
                continue
            if any(q_p[q] + added_q[q] > cfg.caps[q] for q in range(P)):
                continue
            s_new = s_run
            for gamma, _e, _k, _pu, _pv in new_cuts:
                s_new *= gamma
            # gamma >= 1 for every QPD (trace preservation), so the
            # running product is a valid lower bound on the leaf's S
            if (s_new, 0, 0) >= best[0]:
                continue
            assign[g] = p
            for q in range(P):
                q_p[q] += added_q[q]
            cut_list.extend(new_cuts)
            dfs(g + 1, s_new, n_w, max(used_max, p))
            del cut_list[len(cut_list) - len(new_cuts):]
            for q in range(P):
                q_p[q] -= added_q[q]

    dfs(0, 1.0, 0, -1)
    return best[1]


# dfs-node budget for solve_gamma_vertex (the independent full-space
# cross-check implementation; NOT on the production path — solve_gamma's
# split enumeration is the engine).  Module-level so tests can tune it.
VERTEX_NODE_BUDGET = 2_000_000


class _Budget(Exception):
    pass


def solve_gamma_vertex(
    graph: CutGraph, cfg, seed=None, node_budget: int | None = None,
):
    """INDEPENDENT full-plan-space implementation, kept as a
    cross-check witness for :func:`solve_gamma` (tests/test_gamma_mode
    differential) — not on the production path.  Searches per-VERTEX
    partition assignments (solver.solve_python's search tree), so a
    qubit's timeline may split — crossing WIRE edges become wire cuts at
    gamma = 4 alongside angle-aware gate cuts.  All cuts are QPD
    (teleports never win a gamma objective; reference parity keeps them
    in the default mode only).

    ``seed``: an optional feasible plan (the static optimum) whose key
    primes the pruning bound.  Returns ``(plan, completed)``:
    ``completed`` is False when ``node_budget`` dfs nodes were exhausted
    — ``plan`` is then the best found (possibly None), not a proven
    optimum.

    Semantics shared with solver.solve_python (reference model
    Cutter.py:383-571): Q_p = |I ∩ p| + incoming cut wires; C_p = cuts
    touching p; caps bind Q_p; spare_capacity bounds wire cuts (vmove
    qubits must fit); lexicographic key (gamma_total, Q, C) as in the
    static phase.
    """
    nv = graph.num_vertices
    P = cfg.num_partitions
    budget = VERTEX_NODE_BUDGET if node_budget is None else node_budget

    adj_prev: list[list[tuple[int, int, int, float]]] = [
        [] for _ in range(nv)
    ]
    n_wire_total = n_gate_total = 0
    for ei, (u, v, kind) in enumerate(graph.edges):
        g = gamma_of_edge(graph, ei) if kind != GATE_UNCUTTABLE else \
            math.inf
        adj_prev[v].append((u, v, kind, g))
        if kind == WIRE:
            n_wire_total += 1
        elif kind == GATE:
            n_gate_total += 1

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
    if cfg.max_n_qpd_cuts is not None:
        cut_bound = (cfg.max_n_qpd_cuts if cut_bound is None
                     else min(cut_bound, cfg.max_n_qpd_cuts))
    if cut_bound is None:
        cut_bound = n_wire_total + n_gate_total

    is_initial = [False] * nv
    for vi in graph.initial:
        is_initial[vi] = True

    symmetric = len(set(cfg.caps)) == 1
    INF_KEY = (math.inf, math.inf, math.inf)
    best: list = [INF_KEY, None]
    if seed is not None:
        m = seed.metrics
        best[0] = (m.S, m.Q, m.C)
        best[1] = seed

    assignment = [0] * nv
    cut_edges: list[tuple[int, int, int, float]] = []
    i_count = [0] * P
    wire_in = [0] * P
    c_p_run = [0] * P
    nodes = [0]

    def leaf() -> None:
        n_cuts = len(cut_edges)
        n_wire = sum(1 for e in cut_edges if e[2] == WIRE)
        n_gate = n_cuts - n_wire
        if cfg.force_n_wire_cuts is not None and \
                n_wire != cfg.force_n_wire_cuts:
            return
        if cfg.force_n_gate_cuts is not None and \
                n_gate != cfg.force_n_gate_cuts:
            return
        g_total = 1.0
        for (_, _, _, g) in cut_edges:
            g_total *= g
        q_p = [i_count[p] + wire_in[p] for p in range(P)]
        big_q = max(q_p) if q_p else 0
        big_c = max(c_p_run) if c_p_run else 0
        key = (g_total, big_q, big_c)
        if key >= best[0]:
            return
        cuts = [
            CutDecision((u, v), "wire" if kind == WIRE else "gate", False)
            for (u, v, kind, _) in cut_edges
        ]
        metrics = PlanMetrics(
            S=g_total, A=0, L=0, Q=big_q, C=big_c,
            Q_p=q_p, C_p=list(c_p_run),
            n_wire_cuts=n_wire, n_gate_cuts=n_gate,
        )
        plan = CutPlan(P, list(assignment), cuts, metrics, True)
        if cfg.exclude and plan_signature(plan) in cfg.exclude:
            return
        best[0] = key
        best[1] = plan

    def dfs(v: int, g_run: float, n_wire: int, n_gate: int,
            used_max: int) -> None:
        nodes[0] += 1
        if nodes[0] > budget:
            raise _Budget
        if v == nv:
            leaf()
            return
        limit = min(P, used_max + 2) if symmetric else P
        for p in range(limit):
            new_cuts = []
            n_w, n_g = n_wire, n_gate
            ok = True
            for (u, vv, kind, g) in adj_prev[v]:
                if assignment[u] != p:
                    if kind == GATE_UNCUTTABLE:
                        ok = False
                        break
                    new_cuts.append((u, vv, kind, g))
                    if kind == WIRE:
                        n_w += 1
                    else:
                        n_g += 1
            if not ok:
                continue
            if n_w + n_g > cut_bound:
                continue
            if cfg.spare_capacity is not None and \
                    n_w > cfg.spare_capacity:
                continue
            if cfg.force_n_wire_cuts is not None and (
                n_w > cfg.force_n_wire_cuts
                or n_w + rem_wire[v + 1] < cfg.force_n_wire_cuts
            ):
                continue
            if cfg.force_n_gate_cuts is not None and (
                n_g > cfg.force_n_gate_cuts
                or n_g + rem_gate[v + 1] < cfg.force_n_gate_cuts
            ):
                continue
            g_new = g_run
            for (_, _, _, g) in new_cuts:
                g_new *= g
            # every QPD gamma >= 1 (trace preservation): the running
            # product bounds the leaf's total from below
            if (g_new, 0, 0) >= best[0]:
                continue
            d_i = 1 if is_initial[v] else 0
            i_count[p] += d_i
            for (u, vv, kind, _) in new_cuts:
                if kind == WIRE:
                    wire_in[p] += 1
                c_p_run[assignment[u]] += 1
                c_p_run[p] += 1
            cap_ok = all(
                i_count[q] + wire_in[q] <= cfg.caps[q] for q in range(P)
            )
            cpp_ok = cfg.max_cuts_per_partition is None or all(
                c <= cfg.max_cuts_per_partition for c in c_p_run
            )
            if cap_ok and cpp_ok:
                assignment[v] = p
                cut_edges.extend(new_cuts)
                dfs(v + 1, g_new, n_w, n_g, max(used_max, p))
                del cut_edges[len(cut_edges) - len(new_cuts):]
            i_count[p] -= d_i
            for (u, vv, kind, _) in new_cuts:
                if kind == WIRE:
                    wire_in[p] -= 1
                c_p_run[assignment[u]] -= 1
                c_p_run[p] -= 1

    completed = True
    try:
        dfs(0, 1.0, 0, 0, -1)
    except _Budget:
        completed = False
    return best[1], completed


# Budget on the number of split-combination subsearches per solve: the
# w-ascending enumeration is exact whenever it terminates via the
# 4^w >= best cutoff; on instances where even w_max splits stay below
# the incumbent (uniform cx-heavy graphs with many wire slots) the
# enumeration stops BEFORE a level it cannot finish, so the guarantee
# is always a clean "optimal among plans with <= w wire cuts" (logged).
# Module-level so tests/deployments can tune it.
SPLIT_COMBO_BUDGET = 4_000

WIRE_GAMMA = 4.0  # gamma_of_spec(spec_for("move")) — 1-norm of the move QPD


def solve_gamma(graph: CutGraph, cfg) -> CutPlan | None:
    """Gamma-mode search over the FULL plan space (module docstring):
    enumerate wire-split combinations w ascending (w = 0 is the static
    search), each a seeded group-level B&B (:func:`_solve_with_splits`),
    and stop when ``4^w >= best gamma`` — any plan with w wire cuts
    costs at least 4^w, so no deeper w can improve.  Exact on
    termination via that cutoff; the combination budget
    (:data:`SPLIT_COMBO_BUDGET`) bounds pathological instances, where
    the result is then optimal among plans with <= w_max wire cuts (a
    warning says so).  forceNWireCuts pins w to exactly that count."""
    import itertools

    from ..utils.logger import get_logger

    nv = graph.num_vertices
    if nv == 0:
        return _solve_with_splits(graph, cfg, ())

    wire_edges = [
        ei for ei, (_u, _v, kind) in enumerate(graph.edges)
        if kind == WIRE
    ]
    w_cap = len(wire_edges)
    if cfg.spare_capacity is not None:
        w_cap = min(w_cap, cfg.spare_capacity)
    if cfg.max_n_cuts is not None:
        w_cap = min(w_cap, cfg.max_n_cuts)
    if cfg.max_n_qpd_cuts is not None:
        w_cap = min(w_cap, cfg.max_n_qpd_cuts)

    best_plan = None
    best_key = None
    searched = 0
    budget_hit = False

    if cfg.force_n_wire_cuts is not None:
        w_range = [cfg.force_n_wire_cuts] \
            if cfg.force_n_wire_cuts <= w_cap else []
    else:
        w_range = range(w_cap + 1)

    for w in w_range:
        if best_key is not None and WIRE_GAMMA ** w >= best_key[0]:
            break  # no w-wire-cut plan can beat the incumbent
        for combo in itertools.combinations(wire_edges, w):
            searched += 1
            if searched > SPLIT_COMBO_BUDGET:
                budget_hit = True
                break
            plan = _solve_with_splits(graph, cfg, combo,
                                      seed_key=best_key)
            if plan is not None:
                m = plan.metrics
                key = (m.S, m.Q, m.C)
                if best_key is None or key < best_key:
                    best_key = key
                    best_plan = plan
        if budget_hit:
            get_logger(__name__).warning(
                "gamma-mode split enumeration exhausted its budget "
                f"({SPLIT_COMBO_BUDGET} subsearches) at w={w} wire "
                f"cuts; the returned plan is optimal among plans with "
                f"<= {w - 1} wire cuts (raise "
                "cutter.gamma.SPLIT_COMBO_BUDGET for the full proof)"
            )
            break
    return best_plan
