"""Exact/heuristic partition optimisers replacing the reference's clingo/ASP
models (third_party/qvm/qvm/compiler/asp.py and the ASP programs embedded in
gate_decomp.py:59-88 and wire_decomp.py:98-122).

Both models are small combinatorial optimisations; instead of grounding ASP
we solve them directly: exact branch-and-bound when the instance is small,
with a greedy/Kernighan-Lin fallback beyond a node budget.
"""
from __future__ import annotations

import itertools

from ..models.graphs import Graph, kernighan_lin_bisection


def optimal_qubit_partition(
    qcg: Graph,
    num_partitions: int,
    size_to_reach: int,
    node_budget: int = 4_000_000,
) -> list[set]:
    """Partition qubits into ``num_partitions`` sets of size <=
    ``size_to_reach`` minimising (crossing 2q-gate weight, total pairwise
    size imbalance) lexicographically — the ASP model of
    OptimalDecompositionPass (gate_decomp.py:59-88, weights 100000:1).
    Every partition must be non-empty.
    """
    qubits = sorted(qcg.nodes)
    n = len(qubits)
    weight = {
        (u, v): d["weight"] for u, v, d in qcg.edges(data=True)
    }

    # estimate search size; fall back to KL if too big (exact_count: this
    # function's contract is exactly num_partitions non-empty sets)
    if num_partitions**n > node_budget:
        return _kl_partition(
            qcg, num_partitions, size_to_reach, exact_count=True
        )

    best_key = (float("inf"), float("inf"))
    best: list[set] | None = None
    assign: dict = {}
    sizes = [0] * num_partitions

    def crossing(q, p) -> int:
        w = 0
        for other, pp in assign.items():
            if pp != p:
                w += weight.get((q, other), 0) + weight.get((other, q), 0)
        return w

    def dfs(i: int, cross: int, used_max: int):
        nonlocal best, best_key
        if cross > best_key[0]:
            return
        if i == n:
            if any(s == 0 for s in sizes):
                return
            imbalance = sum(
                abs(a - b) for a, b in itertools.combinations(sizes, 2)
            )
            key = (cross, imbalance)
            if key < best_key:
                best_key = key
                best = [
                    {q for q, p in assign.items() if p == pi}
                    for pi in range(num_partitions)
                ]
            return
        q = qubits[i]
        limit = min(num_partitions, used_max + 2)  # symmetry breaking
        for p in range(limit):
            if sizes[p] >= size_to_reach:
                continue
            dc = crossing(q, p)
            assign[q] = p
            sizes[p] += 1
            dfs(i + 1, cross + dc, max(used_max, p))
            sizes[p] -= 1
            del assign[q]

    dfs(0, 0, -1)
    if best is None:
        raise ValueError("no feasible qubit partition")
    return best


def _kl_partition(
    qcg: Graph, num_partitions: int, size_to_reach: int,
    exact_count: bool = False,
) -> list[set]:
    """Recursive KL bisection until every set fits ``size_to_reach``.

    With ``exact_count=False`` (BisectionPass semantics, gate_decomp.py:
    10-41) the number of sets is whatever the bisection tree produces —
    ``num_partitions`` is only the minimum.  ``exact_count=True``
    (optimal_qubit_partition's over-budget fallback) additionally
    reconciles to exactly ``num_partitions`` non-empty sets or raises."""
    partitions: list[set] = [set(qcg.nodes)]
    while len(partitions) < num_partitions or any(
        len(f) > size_to_reach for f in partitions
    ):
        largest = max(partitions, key=len)
        if len(largest) <= 1:
            break
        partitions.remove(largest)
        partitions += [
            set(s) for s in kernighan_lin_bisection(qcg.subgraph(largest))
        ]
    if not exact_count:
        return partitions
    # honour the exact path's contract: exactly num_partitions non-empty
    # sets.  The bisection tree can overshoot when size_to_reach forces
    # deep splits — merge the smallest cap-respecting pairs back.
    while len(partitions) > num_partitions:
        partitions.sort(key=len)
        for i, j in itertools.combinations(range(len(partitions)), 2):
            if len(partitions[i]) + len(partitions[j]) <= size_to_reach:
                partitions[i] |= partitions[j]
                del partitions[j]
                break
        else:
            raise ValueError(
                f"KL fallback cannot pack {len(partitions)} fragments "
                f"into {num_partitions} partitions of <= {size_to_reach} "
                "qubits"
            )
    if len(partitions) < num_partitions:
        raise ValueError("no feasible qubit partition")
    return partitions


def optimal_gate_partition(
    nodes: list[int],
    node_qubits: dict[int, tuple],
    wires: list[tuple[int, int]],
    num_partitions: int,
    size_to_reach: int,
    node_budget: int = 4_000_000,
) -> dict[int, int] | None:
    """Partition gate nodes minimising the number of cut wires subject to a
    per-partition qubit-count cap — the ASP model of OptimalWireCutter
    (wire_decomp.py:98-122).  Returns node -> partition or None (infeasible).
    """
    n = len(nodes)
    order = list(nodes)
    idx = {g: i for i, g in enumerate(order)}
    wire_prev: list[list[int]] = [[] for _ in range(n)]
    for g1, g2 in wires:
        a, b = idx[g1], idx[g2]
        if a > b:
            a, b = b, a
        wire_prev[b].append(a)

    best_cut = [float("inf")]
    best_assign: list[int] | None = None
    assign = [0] * n
    part_qubits: list[set] = [set() for _ in range(num_partitions)]

    def dfs(i: int, cuts: int, used_max: int):
        nonlocal best_assign
        if cuts >= best_cut[0]:
            return
        if i == n:
            if used_max != num_partitions - 1:
                return  # the ASP model requires every partition non-empty
            best_cut[0] = cuts
            best_assign = list(assign)
            return
        g = order[i]
        limit = min(num_partitions, used_max + 2)
        for p in range(limit):
            added = [
                q for q in node_qubits[g] if q not in part_qubits[p]
            ]
            if len(part_qubits[p]) + len(added) > size_to_reach:
                continue
            dc = sum(1 for a in wire_prev[i] if assign[a] != p)
            assign[i] = p
            for q in added:
                part_qubits[p].add(q)
            dfs(i + 1, cuts + dc, max(used_max, p))
            for q in added:
                part_qubits[p].remove(q)

    if num_partitions**n > node_budget:
        # greedy fallback: topological first-fit with local improvement
        return _greedy_gate_partition(
            order, node_qubits, wire_prev, num_partitions, size_to_reach
        )
    import sys

    # dfs recurses n+1 deep; only ever RAISE the limit (lowering could
    # break a host application that set its own deeper limit)
    sys.setrecursionlimit(max(sys.getrecursionlimit(), n + 1000))
    dfs(0, 0, -1)
    if best_assign is None:
        return None
    return {order[i]: best_assign[i] for i in range(n)}


def _greedy_gate_partition(
    order, node_qubits, wire_prev, num_partitions, size_to_reach
):
    assign = [0] * len(order)
    part_qubits: list[set] = [set() for _ in range(num_partitions)]
    for i, g in enumerate(order):
        best_p, best_cost = None, None
        for p in range(num_partitions):
            added = [q for q in node_qubits[g] if q not in part_qubits[p]]
            if len(part_qubits[p]) + len(added) > size_to_reach:
                continue
            cost = sum(1 for a in wire_prev[i] if assign[a] != p)
            if best_cost is None or cost < best_cost:
                best_p, best_cost = p, cost
        if best_p is None:
            return None
        assign[i] = best_p
        for q in node_qubits[g]:
            part_qubits[best_p].add(q)
    return {order[i]: assign[i] for i in range(len(order))}
