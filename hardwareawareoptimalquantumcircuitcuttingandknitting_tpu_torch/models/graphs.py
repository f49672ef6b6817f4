"""Random graphs for the QAOA zoo entries, without networkx.

The JAX package draws the ``regular`` and ``erdos`` graphs of
``generate_circ`` with networkx (``random_regular_graph``,
``erdos_renyi_graph``); the card's machine has no networkx, so this
module draws them itself, draw for draw as networkx 3.6.1 does, and
returns a minimal undirected :class:`Graph` whose ``nodes()`` and
``edges()`` iterate in networkx's order, which
``models.qaoa.construct_qaoa_plus`` consumes.

The algorithms follow networkx 3.6.1
(``networkx/generators/random_graphs.py``; networkx is BSD-3-Clause,
Copyright (C) 2004-2025, NetworkX Developers): the stub pairing of
Steger and Wormald with its ``_suitable`` check and retry, and G(n, p)
over ``itertools.combinations`` with one ``random()`` a pair.  A seed
resolves as networkx's ``py_random_state`` resolves it: an int gives
``random.Random(seed)``, None the global ``random`` instance, a
``random.Random`` is used as given.
"""
from __future__ import annotations

import itertools
import random
from collections import defaultdict


class Graph:
    """An undirected simple graph: nodes in insertion order, each node's
    neighbours in insertion order (networkx's adjacency dicts)."""

    def __init__(self, n: int = 0):
        self._adj: dict = {v: {} for v in range(n)}

    def add_edge(self, u, v) -> None:
        self._adj.setdefault(u, {})[v] = None
        self._adj.setdefault(v, {})[u] = None

    def add_edges_from(self, edges) -> None:
        for u, v in edges:
            self.add_edge(u, v)

    def nodes(self) -> list:
        return list(self._adj)

    def edges(self) -> list:
        """Each edge once: a node's neighbours in insertion order, minus
        the nodes already walked (networkx's ``EdgeView`` order)."""
        seen = set()
        out = []
        for u, nbrs in self._adj.items():
            out.extend((u, v) for v in nbrs if v not in seen)
            seen.add(u)
        return out


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
