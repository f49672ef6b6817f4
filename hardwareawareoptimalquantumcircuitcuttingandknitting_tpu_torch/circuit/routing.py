"""Topology routing: map a program onto a device coupling graph.

The reference never routes explicitly, but every ``backend.run`` in its
noisy experiments implies qiskit transpilation to the fake device's
heavy-hex topology — that is where the recorded CNOT inflation comes from
(BASELINE.md CNOT table: ghz-24 has 23 logical CNOTs, 68 after routing to
FakeKolkataV2, but <=11 per cut fragment).  Cutting's hardware win IS this
routing relief, so the first-party noise pipeline must reproduce it.

This module routes at the op-stream level (FragmentProgram-style entries),
which keeps one router for both the uncut noisy simulator and the
fragment engines:

  * logical data qubits are placed on a BFS-connected set of device nodes
    (one *slot* per node, compacted to 0..d-1 so the statevector size is
    unchanged);
  * a 2q gate on non-adjacent slots inserts SWAP ops along the shortest
    slot path (each counted as 3 CX by the noise model, like qiskit's
    basis decomposition);
  * ancilla-qubit ops (measurement deferral etc.) and slot (vgate
    endpoint) ops pass through unconstrained — they are bookkeeping, not
    physical two-qubit interactions;
  * the returned program carries per-op *device node* axes for
    calibrated-rate lookup, and remapped clbit sources for the final
    marginal.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gates import CX

# IBM Falcon r5.11 (27-qubit heavy-hex) coupling list — the
# Kolkata/Montreal/Mumbai device class the reference benchmarks against.
HEAVY_HEX_27 = [
    (0, 1), (1, 2), (1, 4), (2, 3), (3, 5), (4, 7), (5, 8), (6, 7),
    (7, 10), (8, 9), (8, 11), (10, 12), (11, 14), (12, 13), (12, 15),
    (13, 14), (14, 16), (15, 18), (16, 19), (17, 18), (18, 21), (19, 20),
    (19, 22), (21, 23), (22, 25), (23, 24), (24, 25), (25, 26),
]


def _adjacency(coupling) -> dict[int, set[int]]:
    adj: dict[int, set[int]] = {}
    for a, b in coupling:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    return adj


def bfs_placement(coupling, d: int, start: int = 0) -> list[int]:
    """First ``d`` device nodes in BFS order — a connected placement."""
    adj = _adjacency(coupling)
    seen = [start]
    seen_set = {start}
    i = 0
    while len(seen) < d and i < len(seen):
        for nb in sorted(adj.get(seen[i], ())):
            if nb not in seen_set:
                seen.append(nb)
                seen_set.add(nb)
                if len(seen) == d:
                    break
        i += 1
    if len(seen) < d:
        raise ValueError(f"device has fewer than {d} connected qubits")
    return seen


def snake_placement(coupling, d: int) -> list[int] | None:
    """A simple path of ``d`` device nodes (consecutive placement slots
    adjacent), found by greedy DFS with restarts — chain-shaped circuits
    (GHZ, adders, linear ansatz) route swap-free on it.  None if no path
    of that length is found (large d on heavy-hex: the 27q Falcon graph
    has 6 degree-1 leaves, so long paths run out — exactly the regime
    where real transpilers start paying SWAPs)."""
    adj = _adjacency(coupling)
    best: list[int] = []
    budget = [20000]  # DFS step cap: longest-path is NP-hard in general

    def extend(path, seen):
        nonlocal best
        if len(path) > len(best):
            best = list(path)
        if len(path) >= d:
            return True
        if budget[0] <= 0:
            return False
        budget[0] -= 1
        # prefer low-degree neighbours (leaves first keeps options open)
        nbrs = sorted(
            (n for n in adj.get(path[-1], ()) if n not in seen),
            key=lambda n: len(adj.get(n, ())),
        )
        for n in nbrs:
            path.append(n)
            seen.add(n)
            if extend(path, seen):
                return True
            path.pop()
            seen.remove(n)
        return False

    for start in sorted(adj, key=lambda n: len(adj.get(n, ()))):
        if budget[0] <= 0:
            break
        if extend([start], {start}):
            return best
    if len(best) == d:
        return best
    # partial snake: BFS-attach the remaining nodes to the path
    seen = set(best)
    frontier = list(best)
    while len(best) < d and frontier:
        nxt = []
        for u in frontier:
            for n in sorted(adj.get(u, ()), key=lambda m: len(adj.get(m, ()))):
                if n not in seen:
                    best.append(n)
                    seen.add(n)
                    nxt.append(n)
                    if len(best) == d:
                        return best
        frontier = nxt
    return best if len(best) == d else None


def interaction_order(ops, d: int) -> list[int]:
    """Cuthill–McKee-style ordering of the logical interaction graph (2q
    data ops), so heavily-coupled logical qubits sit close along the
    placement path regardless of their numeric labels (adders interleave
    registers; a chain placement by label would thrash)."""
    import collections

    nbrs: dict[int, collections.Counter] = {
        q: collections.Counter() for q in range(d)
    }
    for entry in ops:
        axes = [q for q in entry[2] if q < d]
        if entry[0] == "u" and len(axes) == 2:
            a, b = axes
            nbrs[a][b] += 1
            nbrs[b][a] += 1

    deg = {q: len(nbrs[q]) for q in range(d)}
    order: list[int] = []
    seen: set[int] = set()
    for start in sorted(range(d), key=lambda q: (deg[q], q)):
        if start in seen:
            continue
        queue = collections.deque([start])
        seen.add(start)
        while queue:
            u = queue.popleft()
            order.append(u)
            for v, _w in sorted(
                nbrs[u].items(), key=lambda kv: (-kv[1], deg[kv[0]], kv[0])
            ):
                if v not in seen:
                    seen.add(v)
                    queue.append(v)
    return order


@dataclass
class RoutedProgram:
    """Routed op stream + metadata for calibrated noise lookup."""

    ops: list                 # same entry format as the input stream
    phys: list                # per-op tuple of device nodes (None for
                              # ancilla/bookkeeping axes)
    clbit_sources: dict       # clbit -> (possibly moved) sim qubit
    slot_device: list[int]    # compact slot -> device node id
    num_swaps: int


def route_stream(
    ops: list,
    num_data_qubits: int,
    clbit_sources: dict[int, int],
    coupling=HEAVY_HEX_27,
    placement: list[int] | None = None,
) -> RoutedProgram:
    """Route a FragmentProgram/CompiledCircuit-style op stream.

    Entries: ``("u"|"u_aux", matrix, axes)`` or ``(slot_kind, sid, axes)``.
    Data qubits (< num_data_qubits) are constrained to ``coupling``;
    ancillas (>= num_data_qubits) are unconstrained bookkeeping.

    With ``placement=None``, both the snake-path and BFS placements are
    routed and the cheaper (fewest swaps) result wins.
    """
    d = num_data_qubits
    if placement is None:
        candidates = [bfs_placement(coupling, d)]
        snake = snake_placement(coupling, d)
        if snake is not None:
            candidates.append(snake)
            # interaction-ordered placement: logical order[k] -> snake[k]
            order = interaction_order(ops, d)
            by_label = [0] * d
            for k, l in enumerate(order):
                by_label[l] = snake[k]
            candidates.append(by_label)
        routed = [
            route_stream(ops, d, clbit_sources, coupling, p)
            for p in candidates
        ]
        return min(routed, key=lambda r: r.num_swaps)
    nodes = placement
    node_slot = {n: s for s, n in enumerate(nodes)}
    node_set = set(nodes)
    adj_full = _adjacency(coupling)
    # induced subgraph over the chosen nodes, in compact slot ids
    adj = {
        node_slot[n]: {
            node_slot[m] for m in adj_full.get(n, ()) if m in node_set
        }
        for n in nodes
    }

    # all-pairs shortest paths over <=27 slots: BFS per slot
    import collections

    def bfs_paths(src):
        prev = {src: None}
        q = collections.deque([src])
        while q:
            u = q.popleft()
            for v in sorted(adj[u]):
                if v not in prev:
                    prev[v] = u
                    q.append(v)
        return prev

    prev_maps = {s: bfs_paths(s) for s in range(d)}
    dist = [[0] * d for _ in range(d)]
    for s in range(d):
        prev = prev_maps[s]
        for t in range(d):
            if t not in prev:
                raise ValueError("placement not connected")
            x, n_hops = t, 0
            while x != s:
                x = prev[x]
                n_hops += 1
            dist[s][t] = n_hops

    def path(a, b):
        prev = prev_maps[a]
        out = [b]
        while out[-1] != a:
            out.append(prev[out[-1]])
        return list(reversed(out))  # a ... b

    cur = list(range(d))      # logical -> slot
    inv = list(range(d))      # slot -> logical
    out_ops: list = []
    out_phys: list = []
    num_swaps = 0

    def emit(entry, phys):
        out_ops.append(entry)
        out_phys.append(phys)

    def do_swap(sa, sb):
        nonlocal num_swaps
        la, lb = inv[sa], inv[sb]
        inv[sa], inv[sb] = lb, la
        cur[la], cur[lb] = sb, sa
        # emit as the 3-CX basis decomposition so downstream noise sites
        # charge the same burden qiskit's transpiled swaps do
        phys = (nodes[sa], nodes[sb])
        emit(("u", CX, (sa, sb)), phys)
        emit(("u", CX, (sb, sa)), (phys[1], phys[0]))
        emit(("u", CX, (sa, sb)), phys)
        num_swaps += 1

    # upcoming 2q data gates per position, for the lookahead cost
    future: list[tuple[int, int] | None] = []
    for entry in ops:
        axes = [q for q in entry[2] if q < d]
        future.append(
            tuple(axes) if entry[0] == "u" and len(axes) == 2 else None
        )
    LOOKAHEAD, DECAY = 12, 0.7

    def lookahead_cost(cur_v, start_i):
        cost, w, seen_n = 0.0, 1.0, 0
        for j in range(start_i, len(future)):
            f = future[j]
            if f is None:
                continue
            cost += w * dist[cur_v[f[0]]][cur_v[f[1]]]
            w *= DECAY
            seen_n += 1
            if seen_n >= LOOKAHEAD:
                break
        return cost

    for i, entry in enumerate(ops):
        kind = entry[0]
        axes = entry[2]
        data_axes = [q for q in axes if q < d]
        if kind == "u" and len(data_axes) > 2:
            raise NotImplementedError(
                "route_stream handles <= 2 data-qubit ops (the noise path "
                "never fuses into wider blocks)"
            )
        if kind == "u" and len(data_axes) == 2:
            a, b = (cur[q] for q in data_axes)
            if b not in adj[a]:
                # meet-in-the-middle with lookahead: try every split of the
                # shortest path between the endpoints, score the resulting
                # layout against the next few 2q gates (mini-SABRE)
                p = path(a, b)
                best = None
                for m in range(len(p) - 1):
                    cur_v, inv_v = list(cur), list(inv)

                    def vswap(sa, sb):
                        la, lb = inv_v[sa], inv_v[sb]
                        inv_v[sa], inv_v[sb] = lb, la
                        cur_v[la], cur_v[lb] = sb, sa

                    swaps = []
                    for x in range(m):             # walk a forward to p[m]
                        swaps.append((p[x], p[x + 1]))
                        vswap(p[x], p[x + 1])
                    for x in range(len(p) - 2, m, -1):  # walk b back
                        swaps.append((p[x + 1], p[x]))
                        vswap(p[x + 1], p[x])
                    cost = lookahead_cost(cur_v, i + 1)
                    if best is None or cost < best[0]:
                        best = (cost, swaps, p[m], p[m + 1])
                _, swaps, a, b = best
                for sa, sb in swaps:
                    do_swap(sa, sb)
            emit((kind, entry[1], (a, b)), (nodes[a], nodes[b]))
            continue
        # 1q data ops, ancilla-involving ops, slot ops: remap data axes
        new_axes = tuple(cur[q] if q < d else q for q in axes)
        phys = tuple(nodes[cur[q]] if q < d else None for q in axes)
        emit((kind, entry[1], new_axes), phys)

    new_sources = {
        c: (cur[q] if q < d else q) for c, q in clbit_sources.items()
    }
    return RoutedProgram(out_ops, out_phys, new_sources, list(nodes),
                         num_swaps)
