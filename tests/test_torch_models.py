"""The torch port's benchmark zoo against the JAX package's.

Every ``genCirc`` name and ``generate_circ`` type, and every function of
``models/generators.py`` with its defaults, builds the JAX package's
circuit instruction for instruction (``convert.circuit_to_instructions``)
under the same seeds.  The port draws the QAOA graphs itself
(``models/graphs.py``, no networkx); its graphs equal networkx's, node
and edge order included.
"""
import random

import networkx as nx
import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models import (
    generators as j_generators,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models import (
    zoo as j_zoo,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_to_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models import (  # noqa: E501
    generators as t_generators,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models import (  # noqa: E501
    graphs,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models import (  # noqa: E501
    zoo as t_zoo,
)
import torch_threads  # noqa: F401 (torch's threads: a share of the cores)

GEN_CIRC_NAMES = ["ran", "sup", "su", "ghz", "syc", "hwe", "bv", "qft",
                  "aqft", "add", "erd", "reg"]
# (n, depth, seed): two sizes the supremacy grid can realise
SIZES = [(6, 1, 3), (12, 2, 7)]
TYPES = ["supremacy", "sycamore", "hwea", "qft", "aqft", "bv", "adder",
         "regular", "erdos"]


def _same(jcirc, tcirc):
    if jcirc is None or tcirc is None:
        return jcirc is None and tcirc is None
    return circuit_to_instructions(jcirc) == circuit_to_instructions(tcirc)


@pytest.mark.parametrize("n,depth,seed", SIZES)
@pytest.mark.parametrize("name", GEN_CIRC_NAMES)
def test_gen_circ_matches_jax(name, n, depth, seed):
    assert _same(j_zoo.genCirc(name, n, depth, seed=seed),
                 t_zoo.genCirc(name, n, depth, seed=seed))


@pytest.mark.parametrize("n,depth,seed", SIZES)
@pytest.mark.parametrize("kind", TYPES)
def test_generate_circ_matches_jax(kind, n, depth, seed):
    assert _same(j_zoo.generate_circ(n, depth, kind, seed=seed),
                 t_zoo.generate_circ(n, depth, kind, seed=seed))


@pytest.mark.parametrize("n,seed", [(8, 0), (10, 5), (12, 11)])
@pytest.mark.parametrize("kind", ["regular", "erdos"])
def test_connected_only_retries_as_jax(kind, n, seed):
    """``connected_only=True`` redraws the graph with the seed moved on
    each trial (Erdős–Rényi also raises its density): the same trial
    wins in both packages."""
    want = j_zoo.generate_circ(n, 1, kind, connected_only=True, seed=seed)
    got = t_zoo.generate_circ(n, 1, kind, connected_only=True, seed=seed)
    assert _same(want, got)
    assert got is None or got.num_tensor_factors() == 1


def test_unknown_names_raise_as_jax():
    for zoo in (j_zoo, t_zoo):
        with pytest.raises(RuntimeError, match="not supported"):
            zoo.genCirc("nope", 4, 1)
        with pytest.raises(Exception, match="Illegal circuit type"):
            zoo.generate_circ(4, 1, "nope")


def test_secret_and_factoring_match_jax():
    for n in range(2, 20):
        assert t_zoo.gen_secret(n) == j_zoo.gen_secret(n)
        assert t_zoo.factor_int(n) == j_zoo.factor_int(n)


GENERATOR_CALLS = {
    "gen_supremacy": ((4, 4, 8), {}),
    "gen_sycamore": ((3, 4, 2), {}),
    "gen_hwea": ((6, 2), {}),
    "gen_uccsd": ((4,), {}),
    "gen_qft": ((5, 0), {}),
    "library_qft": ((6,), {}),
    "gen_qwalk": ((8,), {}),
    "gen_dynamics": ((["XYZI", "ZZII", "IXXY"],), {}),
    "gen_BV": (("10110",), {}),
    "gen_adder": ((3,), {"a": 5, "b": 3}),
}


@pytest.mark.parametrize("name", sorted(GENERATOR_CALLS))
def test_generators_match_jax(name):
    """Each generator of ``models/generators.py`` with its defaults; those
    that draw from numpy's global RNG draw after the same seed."""
    assert sorted(t_generators.__all__) == sorted(GENERATOR_CALLS)
    args, kw = GENERATOR_CALLS[name]
    np.random.seed(2)
    random.seed(2)
    want = getattr(j_generators, name)(*args, **kw)
    np.random.seed(2)
    random.seed(2)
    got = getattr(t_generators, name)(*args, **kw)
    assert _same(want, got)


def _order(graph):
    return list(graph.nodes()), list(graph.edges())


@pytest.mark.parametrize("seed", range(20))
def test_graphs_match_networkx_draw_for_draw(seed):
    for d, n in ((3, 10), (3, 16), (2, 7), (4, 9)):
        assert _order(graphs.random_regular_graph(d, n, seed=seed)) == \
            _order(nx.random_regular_graph(d, n, seed=seed))
    for n, p in ((10, 0.001 * (seed + 1)), (12, 0.3), (9, 0.7), (5, 1.0),
                 (6, 0.0)):
        assert _order(graphs.gnp_random_graph(n, p, seed=seed)) == \
            _order(nx.erdos_renyi_graph(n, p, seed=seed))


def test_graphs_without_a_seed_draw_from_the_global_random():
    """``seed=None`` draws from ``random``'s global instance, as networkx
    does: the same graphs under a pinned ``random.seed``, and the global
    stream left at the same place."""
    random.seed(11)
    want = [_order(nx.random_regular_graph(3, 12)),
            _order(nx.erdos_renyi_graph(12, 0.4))]
    after = random.random()
    random.seed(11)
    got = [_order(graphs.random_regular_graph(3, 12)),
           _order(graphs.gnp_random_graph(12, 0.4))]
    assert got == want
    assert random.random() == after


def test_graph_refusals_match_networkx():
    for d, n in ((3, 7), (7, 7)):
        with pytest.raises(nx.NetworkXError):
            nx.random_regular_graph(d, n, seed=0)
        with pytest.raises(ValueError):
            graphs.random_regular_graph(d, n, seed=0)
