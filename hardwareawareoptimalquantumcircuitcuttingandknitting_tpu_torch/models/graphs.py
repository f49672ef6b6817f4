"""Graphs and graph algorithms of networkx, without networkx.

The JAX package draws the ``regular`` and ``erdos`` graphs of
``generate_circ`` with networkx (``random_regular_graph``,
``erdos_renyi_graph``), and its compiler (``compiler/``) builds its
instruction DAG and qubit connectivity graph on networkx containers and
algorithms.  The card's machine has no networkx, so this module carries
what both need, step for step as networkx 3.6.1 does it, so that every
node, edge and draw comes in networkx's order:

* :class:`Graph` and :class:`DiGraph`: dict-of-dict adjacency (``_node``,
  ``_adj``; ``_succ`` / ``_pred``) in insertion order, with networkx's
  ``add_node`` / ``add_edge`` / ``remove_node`` / ``remove_edge`` rules and
  a ``nodes`` view whose ``nodes[n]`` is the node's attribute dict;
  ``Graph.subgraph`` iterates as networkx's filtered views do;
* :func:`topological_generations` / :func:`topological_sort` (Kahn's
  generations, children in adjacency order), :func:`dag_longest_path_length`,
  :func:`connected_components` (BFS from each unseen node in node order),
  :func:`has_path`;
* :func:`kernighan_lin_bisection`, with networkx's ``BinaryHeap`` tie
  order and its seed rule (None draws from the global ``random``
  instance);
* the random graphs: the stub pairing of Steger and Wormald with its
  ``_suitable`` check and retry, and G(n, p) over
  ``itertools.combinations`` with one ``random()`` a pair.

The algorithms follow networkx 3.6.1 (``networkx/classes/graph.py``,
``digraph.py``, ``coreviews.py``, ``algorithms/dag.py``,
``components/connected.py``, ``community/bipartitions.py``,
``utils/heaps.py``, ``generators/random_graphs.py``; networkx is
BSD-3-Clause, Copyright (C) 2004-2025, NetworkX Developers).  A seed
resolves as networkx's ``py_random_state`` resolves it: an int gives
``random.Random(seed)``, None the global ``random`` instance, a
``random.Random`` is used as given.
"""
from __future__ import annotations

import heapq
import itertools
import random
from collections import defaultdict


class NodeView:
    """networkx's ``NodeView``: iterates the nodes in insertion order,
    ``view[n]`` is node ``n``'s attribute dict, and calling it returns the
    view (``G.nodes()``)."""

    def __init__(self, nodes: dict):
        self._nodes = nodes

    def __iter__(self):
        return iter(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def __getitem__(self, n) -> dict:
        return self._nodes[n]

    def __call__(self):
        return self


class Graph:
    """An undirected simple graph: ``_node`` (node -> attributes) and
    ``_adj`` (node -> neighbour -> edge attributes), both in insertion
    order, as networkx keeps them.  ``Graph(n)`` starts with nodes
    ``0..n-1``."""

    def __init__(self, n: int = 0):
        self._node: dict = {}
        self._adj: dict = {}
        self.add_nodes_from(range(n))

    def __iter__(self):
        return iter(self._node)

    def __contains__(self, n) -> bool:
        try:
            return n in self._node
        except TypeError:
            return False

    def __getitem__(self, n) -> dict:
        return self._adj[n]

    @property
    def nodes(self) -> NodeView:
        return NodeView(self._node)

    def number_of_nodes(self) -> int:
        return len(self._node)

    def add_node(self, n, **attr) -> None:
        if n not in self._node:
            self._adj[n] = {}
            self._node[n] = attr
        else:
            self._node[n].update(attr)

    def add_nodes_from(self, nodes) -> None:
        for n in nodes:
            self.add_node(n)

    def add_edge(self, u, v, **attr) -> None:
        for n in (u, v):
            if n not in self._node:
                self._adj[n] = {}
                self._node[n] = {}
        data = self._adj[u].get(v, {})
        data.update(attr)
        self._adj[u][v] = data
        self._adj[v][u] = data

    def add_edges_from(self, edges) -> None:
        for u, v in edges:
            self.add_edge(u, v)

    def has_edge(self, u, v) -> bool:
        return u in self._adj and v in self._adj[u]

    def edges(self, data: bool = False) -> list:
        """Each edge once: a node's neighbours in insertion order, minus
        the nodes already walked (networkx's ``EdgeView`` order)."""
        seen = set()
        out = []
        for u, nbrs in self._adj.items():
            for v, d in nbrs.items():
                if v not in seen:
                    out.append((u, v, d) if data else (u, v))
            seen.add(u)
        return out

    def subgraph(self, nodes) -> "Graph":
        """The subgraph induced by ``nodes``, iterating as networkx's
        ``subgraph`` view does (``FilterAtlas.__iter__``): when twice the
        kept set is smaller than the graph, nodes come in the order of a
        set built from ``nodes``; otherwise in the graph's order.  A
        node's neighbours keep the graph's order.  A copy, not a view."""
        keep = set(n for n in nodes if n in self)
        if 2 * len(keep) < len(self._node):
            order = [n for n in keep if n in self._node]
        else:
            order = [n for n in self._node if n in keep]
        sub = Graph()
        for n in order:
            sub._node[n] = self._node[n]
            sub._adj[n] = {v: d for v, d in self._adj[n].items()
                           if v in keep}
        return sub


class DiGraph:
    """A directed simple graph: ``_node``, ``_succ`` (= ``_adj``) and
    ``_pred`` in insertion order, with networkx's ``DiGraph`` rules
    (an existing edge keeps its place; ``remove_node`` drops the node's
    edges from its neighbours' dicts)."""

    def __init__(self):
        self._node: dict = {}
        self._succ: dict = {}
        self._pred: dict = {}
        self._adj = self._succ

    def __iter__(self):
        return iter(self._node)

    def __contains__(self, n) -> bool:
        try:
            return n in self._node
        except TypeError:
            return False

    @property
    def nodes(self) -> NodeView:
        return NodeView(self._node)

    def add_node(self, n, **attr) -> None:
        if n not in self._succ:
            self._succ[n] = {}
            self._pred[n] = {}
            self._node[n] = attr
        else:
            self._node[n].update(attr)

    def add_edge(self, u, v, **attr) -> None:
        for n in (u, v):
            if n not in self._succ:
                self._succ[n] = {}
                self._pred[n] = {}
                self._node[n] = {}
        data = self._succ[u].get(v, {})
        data.update(attr)
        self._succ[u][v] = data
        self._pred[v][u] = data

    def remove_node(self, n) -> None:
        nbrs = self._succ[n]
        del self._node[n]
        for u in nbrs:
            del self._pred[u][n]
        del self._succ[n]
        for u in self._pred[n]:
            del self._succ[u][n]
        del self._pred[n]

    def remove_edge(self, u, v) -> None:
        del self._succ[u][v]
        del self._pred[v][u]

    def has_edge(self, u, v) -> bool:
        return u in self._succ and v in self._succ[u]

    def successors(self, n):
        return iter(self._succ[n])

    def predecessors(self, n):
        return iter(self._pred[n])

    def edges(self) -> list:
        return [(u, v) for u, nbrs in self._succ.items() for v in nbrs]


def topological_generations(G: DiGraph):
    """Kahn's generations: the nodes without predecessors in node order,
    then each generation's children in adjacency order as their last
    parent is taken (networkx's ``topological_generations``)."""
    indegree = {v: len(G._pred[v]) for v in G._succ if G._pred[v]}
    zero = [v for v in G._succ if not G._pred[v]]
    while zero:
        generation, zero = zero, []
        for node in generation:
            for child in G._succ[node]:
                indegree[child] -= 1
                if indegree[child] == 0:
                    zero.append(child)
                    del indegree[child]
        yield generation
    if indegree:
        raise ValueError("graph contains a cycle")


def topological_sort(G: DiGraph):
    """:func:`topological_generations`, flattened."""
    for generation in topological_generations(G):
        yield from generation


def dag_longest_path_length(G: DiGraph) -> int:
    """Edges on a longest path (every edge of weight 1)."""
    dist: dict = {}
    for v in topological_sort(G):
        best = max((dist[u] + 1 for u in G._pred[v]), default=0)
        dist[v] = best
    return max(dist.values(), default=0)


def connected_components(G: Graph):
    """Each component as a set, in the order of its first node (BFS from
    each unseen node in node order)."""
    seen: set = set()
    for v in G:
        if v not in seen:
            comp = {v}
            level = [v]
            while level:
                nxt = []
                for u in level:
                    for w in G._adj[u]:
                        if w not in comp:
                            comp.add(w)
                            nxt.append(w)
                level = nxt
            seen.update(comp)
            yield comp


def has_path(G: DiGraph, source, target) -> bool:
    """Whether ``target`` is reachable from ``source`` along edges."""
    seen = {source}
    level = [source]
    while level:
        if target in seen:
            return True
        nxt = []
        for u in level:
            for w in G._succ[u]:
                if w not in seen:
                    seen.add(w)
                    nxt.append(w)
        level = nxt
    return target in seen


class _BinaryHeap:
    """networkx's ``BinaryHeap``: ``heapq`` of (value, insertion count,
    key) with stale entries skipped, so equal values pop in insertion
    order."""

    def __init__(self):
        self._dict: dict = {}
        self._heap: list = []
        self._count = itertools.count()

    def __bool__(self) -> bool:
        return bool(self._dict)

    def __contains__(self, key) -> bool:
        return key in self._dict

    def get(self, key, default=None):
        return self._dict.get(key, default)

    def pop(self):
        while True:
            value, _, key = heapq.heappop(self._heap)
            if key in self._dict and value == self._dict[key]:
                break
        del self._dict[key]
        return key, value

    def insert(self, key, value, allow_increase: bool = False) -> None:
        if key in self._dict:
            old = self._dict[key]
            if value < old or (allow_increase and value > old):
                self._dict[key] = value
                heapq.heappush(self._heap, (value, next(self._count), key))
            return
        self._dict[key] = value
        heapq.heappush(self._heap, (value, next(self._count), key))


def _kernighan_lin_sweep(edge_info: dict, side: dict):
    heap0, heap1 = heaps = _BinaryHeap(), _BinaryHeap()
    for u, nbrs in edge_info.items():
        cost_u = sum(wt if side[v] else -wt for v, wt in nbrs.items())
        if side[u]:
            heap1.insert(u, cost_u)
        else:
            heap0.insert(u, -cost_u)

    def update(node):
        side_node = side[node]
        for nbr, wt in edge_info[node].items():
            side_nbr = side[nbr]
            if side_nbr == side_node:
                wt = -wt
            heap = heaps[side_nbr]
            if nbr in heap:
                heap.insert(nbr, heap.get(nbr) + 2 * wt, allow_increase=True)

    i = 0
    total = 0
    while heap0 and heap1:
        u, cost_u = heap0.pop()
        update(u)
        v, cost_v = heap1.pop()
        update(v)
        total += cost_u + cost_v
        i += 1
        yield total, i, (u, v)


def kernighan_lin_bisection(G: Graph, max_iter: int = 10,
                            weight: str = "weight", seed=None):
    """Two sets of nodes from networkx's modified Kernighan-Lin (single
    moves, alternating sides): a random balanced start (``seed``'s
    ``shuffle`` of the node list), then up to ``max_iter`` sweeps."""
    nodes = list(G)
    _rng(seed).shuffle(nodes)
    mid = len(nodes) // 2
    a = nodes[:mid]
    side = {node: (node in a) for node in nodes}
    edge_info = {u: {v: d.get(weight, 1) for v, d in nbrs.items()}
                 for u, nbrs in G._adj.items()}
    for _ in range(max_iter):
        costs = list(_kernighan_lin_sweep(edge_info, side))
        min_cost, min_i, _ = min(costs)
        if min_cost >= 0:
            break
        for _, _, (u, v) in costs[:min_i]:
            side[u] = 1
            side[v] = 0
    part1 = {u for u, s in side.items() if s == 0}
    part2 = {u for u, s in side.items() if s == 1}
    return part1, part2


def _rng(seed) -> random.Random:
    if seed is None:
        return random._inst
    if isinstance(seed, random.Random):
        return seed
    if isinstance(seed, int):
        return random.Random(seed)
    raise ValueError(f"{seed!r} cannot be used to seed a random.Random")


def random_regular_graph(d: int, n: int, seed=None) -> Graph:
    """A random ``d``-regular graph on nodes ``0..n-1`` (networkx's
    ``random_regular_graph``)."""
    if (n * d) % 2 != 0:
        raise ValueError("n * d must be even")
    if not 0 <= d < n:
        raise ValueError("the 0 <= d < n inequality must be satisfied")
    rng = _rng(seed)
    graph = Graph(n)
    if d == 0:
        return graph

    def suitable(edges, potential_edges):
        # whether a pair of the leftover stubs can still become an edge
        if not potential_edges:
            return True
        for s1 in potential_edges:
            for s2 in potential_edges:
                if s1 == s2:
                    break
                if s1 > s2:
                    s1, s2 = s2, s1
                if (s1, s2) not in edges:
                    return True
        return False

    def try_creation():
        edges = set()
        stubs = list(range(n)) * d
        while stubs:
            potential_edges = defaultdict(lambda: 0)
            rng.shuffle(stubs)
            stubiter = iter(stubs)
            for s1, s2 in zip(stubiter, stubiter):
                if s1 > s2:
                    s1, s2 = s2, s1
                if s1 != s2 and ((s1, s2) not in edges):
                    edges.add((s1, s2))
                else:
                    potential_edges[s1] += 1
                    potential_edges[s2] += 1
            if not suitable(edges, potential_edges):
                return None
            stubs = [node for node, potential in potential_edges.items()
                     for _ in range(potential)]
        return edges

    edges = try_creation()
    while edges is None:
        edges = try_creation()
    graph.add_edges_from(edges)
    return graph


def gnp_random_graph(n: int, p: float, seed=None) -> Graph:
    """G(n, p): each pair of ``0..n-1`` an edge with probability ``p``
    (networkx's ``gnp_random_graph`` = ``erdos_renyi_graph``,
    undirected)."""
    graph = Graph(n)
    if p >= 1:
        graph.add_edges_from(itertools.combinations(range(n), 2))
    elif p > 0:
        rng = _rng(seed)
        for e in itertools.combinations(range(n), 2):
            if rng.random() < p:
                graph.add_edge(*e)
    return graph
