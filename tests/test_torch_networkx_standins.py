"""The port's networkx stand-ins (``models/graphs.py``) against networkx.

The compiler places its cuts in node and edge iteration order, so the
stand-ins must give networkx's sequences, not just its sets: on random
DAGs and graphs from a seeded numpy generator, every sequence below
equals networkx 3.6.1's element for element.
"""
import random

import networkx as nx
import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models import (  # noqa: E501
    graphs,
)


def _random_dag(seed, n=14, p=0.25):
    """The same random DAG in both libraries, nodes added in a shuffled
    order and edges in a random order (some added twice)."""
    rng = np.random.default_rng(seed)
    order = [int(v) for v in rng.permutation(n)]
    edges = [(int(u), int(v)) for u in range(n) for v in range(u + 1, n)
             if rng.random() < p]
    edges += [edges[i] for i in rng.integers(0, len(edges), 3)]
    edges = [edges[i] for i in rng.permutation(len(edges))]
    g, h = nx.DiGraph(), graphs.DiGraph()
    for v in order:
        g.add_node(v, tag=v)
        h.add_node(v, tag=v)
    for u, v in edges:
        g.add_edge(u, v)
        h.add_edge(u, v)
    return g, h


def _random_graph(seed, n=16, p=0.2):
    rng = np.random.default_rng(seed)
    order = [int(v) for v in rng.permutation(n)]
    g, h = nx.Graph(), graphs.Graph()
    g.add_nodes_from(order)
    h.add_nodes_from(order)
    for u in range(n):
        for v in range(u + 1, n):
            if rng.random() < p:
                w = int(rng.integers(1, 4))
                a, b = (u, v) if rng.random() < 0.5 else (v, u)
                for graph in (g, h):
                    if not graph.has_edge(a, b):
                        graph.add_edge(a, b, weight=0)
                    graph[a][b]["weight"] += w
    return g, h


@pytest.mark.parametrize("seed", range(4))
def test_digraph_sequences_match_networkx(seed):
    """Node, successor and predecessor order; the generations, the
    topological order, the longest path and reachability; then the same
    after removing nodes and edges."""
    g, h = _random_dag(seed)
    for step in range(3):
        assert list(h.nodes) == list(g.nodes)
        assert [h.nodes[v] for v in h.nodes] == [g.nodes[v] for v in g.nodes]
        assert [list(h.successors(v)) for v in h] == \
            [list(g.successors(v)) for v in g]
        assert [list(h.predecessors(v)) for v in h] == \
            [list(g.predecessors(v)) for v in g]
        assert list(graphs.topological_generations(h)) == \
            list(nx.topological_generations(g))
        assert list(graphs.topological_sort(h)) == \
            list(nx.topological_sort(g))
        assert graphs.dag_longest_path_length(h) == \
            nx.dag_longest_path_length(g)
        nodes = list(g)
        for u in nodes[::3]:
            for v in nodes[1::4]:
                assert graphs.has_path(h, u, v) == nx.has_path(g, u, v)
        victim = nodes[(5 * step + seed) % len(nodes)]
        g.remove_node(victim)
        h.remove_node(victim)
        u, v = next(iter(g.edges()))
        g.remove_edge(u, v)
        h.remove_edge(u, v)
        assert h.has_edge(u, v) == g.has_edge(u, v) is False


@pytest.mark.parametrize("seed", range(4))
def test_graph_views_and_components_match_networkx(seed):
    """Edges with their data, connected components (sets, in order) and
    the order a subgraph iterates in, on both of networkx's branches
    (fewer than half the nodes kept: the kept set's order; else the
    graph's order)."""
    g, h = _random_graph(seed)
    assert h.edges(data=True) == list(g.edges(data=True))
    assert list(h) == list(g) and h.number_of_nodes() == g.number_of_nodes()
    assert [list(c) for c in graphs.connected_components(h)] == \
        [list(c) for c in nx.connected_components(g)]
    rng = np.random.default_rng(seed + 100)
    for size in (3, 6, 9, 12):
        keep = set(int(v) for v in rng.choice(16, size, replace=False))
        gs, hs = g.subgraph(keep), h.subgraph(keep)
        assert list(hs) == list(gs)
        assert [(u, list(nb.items())) for u, nb in hs._adj.items()] == \
            [(u, list(nb.items())) for u, nb in gs._adj.items()]


@pytest.mark.parametrize("seed", range(4))
def test_kernighan_lin_matches_networkx_under_one_seed(seed):
    """``kernighan_lin_bisection(seed=None)`` draws from the global
    ``random`` instance, as networkx's does: the same two sets from the
    same ``random.seed``, on whole graphs and on subgraphs of both
    branches; an int seed as well."""
    from networkx.algorithms.community import kernighan_lin_bisection

    g, h = _random_graph(seed)
    rng = np.random.default_rng(seed)
    for size in (16, 7, 10):
        keep = set(int(v) for v in rng.choice(16, size, replace=False))
        for k in range(3):
            random.seed(k)
            want = kernighan_lin_bisection(g.subgraph(keep))
            random.seed(k)
            got = graphs.kernighan_lin_bisection(h.subgraph(keep))
            assert [list(s) for s in got] == [list(s) for s in want]
    assert graphs.kernighan_lin_bisection(h, seed=seed) == \
        kernighan_lin_bisection(g, seed=seed)
