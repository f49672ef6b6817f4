"""The port's Hamiltonian energies (ops/hamiltonian.py) and QAOA model
(models/qaoa.py) against the JAX package's.

Sizes and inputs are tests/test_hamiltonian.py's (TFIM on 6 qubits, QAOA
on the 6-path): ansatzes built with the JAX package and carried across
with ``convert`` (ParamRefs included), thetas from seeded numpy.
Tolerances: energies within 1e-5 of JAX, gradients within 2e-5 of
``jax.grad`` (the JAX package's own bound between contraction and
distribution routes, tests/test_hamiltonian.py:161), the oracle bounds
of the JAX tests.  The JAX references run under ``jax.jit``, once per
module.
"""
import networkx as nx
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
    ParamRef as JParamRef,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.qaoa import (  # noqa: E501
    construct_qaoa_plus as j_qaoa,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
    hamiltonian as jh,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
    compile_circuit as j_compile,
    run_statevector_host,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
    ParamRef,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.qaoa import (  # noqa: E501
    construct_qaoa_plus,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    hamiltonian as th,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.parallel.mesh import (  # noqa: E501
    make_mesh,
)
from torch_port_common import to_port

CPU = "cpu"
CUT_KW = dict(maxNPartitions=2, maxNQubitsPerPartition=4,
              maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
N = 6


def tfim_terms(n, j=1.0, h=0.7):
    terms = []
    for i in range(n - 1):
        zz = ["I"] * n
        zz[i] = zz[i + 1] = "Z"
        terms.append((-j, "".join(zz)))
    for i in range(n):
        x = ["I"] * n
        x[i] = "X"
        terms.append((-h, "".join(x)))
    return terms


def _ansatz(thetas, n=N, mark=True):
    c = JCircuit(n, n)
    for q in range(n):
        v = float(thetas[q])
        c.ry(JParamRef(q, v) if mark else v, q)
    for i in range(n - 1):
        c.cx(i, i + 1)
    for q in range(n):
        v = float(thetas[n + q])
        c.ry(JParamRef(n + q, v) if mark else v, q)
    return c


def _oracle(jcirc, terms):
    state = run_statevector_host(j_compile(jcirc))
    psi = state[0].astype(np.complex128) + 1j * state[1]
    h = jh.dense_matrix(terms, jcirc.num_qubits)
    return float(np.real(psi.conj() @ (h @ psi)))


def _value_and_grad(energy, theta):
    t = torch.tensor(np.asarray(theta, np.float32), requires_grad=True)
    e = energy(t)
    e.backward()
    return float(e.detach()), t.grad.numpy()


def _jax_value_and_grad(energy, theta):
    e, g = jax.jit(jax.value_and_grad(energy))(
        jnp.asarray(theta, jnp.float32))
    return float(e), np.asarray(g)


THETA = np.random.default_rng(17).uniform(-2, 2, 2 * N)
TERMS = tfim_terms(N) + [(0.4, "ZIXIYI"), (0.3, "IYIZIX"), (1.5, "I" * N)]
MODES = {"contract": {"contract": True},
         "distribution": {"contract": False},
         "sampled": {"num_samples": 6000, "sample_seed": 3,
                     "sample_method": "lhs"}}


@pytest.fixture(scope="module")
def jax_energies():
    """Per mode: (energy, gradient, info) of the JAX package at THETA."""
    out = {}
    for mode, kw in MODES.items():
        energy, info = jh.make_hamiltonian_energy(_ansatz(THETA), CUT_KW,
                                                  TERMS, **kw)
        out[mode] = _jax_value_and_grad(energy, THETA) + (info,)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_energy_and_gradient_match_jax(jax_energies, mode):
    """Every route (the contraction; the knitted distribution, which
    ``contract=None`` picks at 6 qubits; the stochastic estimate over
    the same LHS label sample) against JAX's."""
    energy, info = th.make_hamiltonian_energy(to_port(_ansatz(THETA)),
                                              CUT_KW, TERMS, device=CPU,
                                              **MODES[mode])
    j_e, j_g, j_info = jax_energies[mode]
    assert info.plan.to_json() == j_info.plan.to_json()
    for key in ("n_params", "n_groups", "constant", "instances_per_step"):
        assert getattr(info, key) == getattr(j_info, key), key
    e, g = _value_and_grad(energy, THETA)
    assert abs(e - j_e) < 1e-5, (e, j_e)
    np.testing.assert_allclose(g, j_g, atol=2e-5)


def test_energy_matches_the_statevector_oracle():
    energy, info = th.make_hamiltonian_energy(to_port(_ansatz(THETA)),
                                              CUT_KW, TERMS, device=CPU)
    assert info.n_params == 2 * N and info.n_groups < len(TERMS)
    want = _oracle(_ansatz(THETA, mark=False), TERMS)
    assert abs(float(energy(THETA)) - want) < 5e-4


def test_contract_and_distribution_routes_agree():
    """tests/test_hamiltonian.py:157-161: energies and gradients of the
    two exact routes within 2e-5."""
    e_dist, _ = th.make_hamiltonian_energy(
        to_port(_ansatz(THETA)), CUT_KW, TERMS, contract=False, device=CPU)
    e_con, _ = th.make_hamiltonian_energy(
        to_port(_ansatz(THETA)), CUT_KW, TERMS, contract=True, device=CPU)
    a, ga = _value_and_grad(e_dist, THETA)
    b, gb = _value_and_grad(e_con, THETA)
    assert abs(a - b) < 2e-5
    np.testing.assert_allclose(ga, gb, atol=2e-5)


def test_stochastic_energy_brackets_the_exact_one():
    e_exact, _ = th.make_hamiltonian_energy(to_port(_ansatz(THETA)),
                                            CUT_KW, TERMS, device=CPU)
    e_samp, info = th.make_hamiltonian_energy(
        to_port(_ansatz(THETA)), CUT_KW, TERMS, num_samples=6000,
        sample_seed=3, sample_method="lhs", device=CPU)
    assert info.instances_per_step > 0
    a, g = _value_and_grad(e_samp, THETA)
    assert abs(a - float(e_exact(THETA))) < 0.5
    assert np.isfinite(g).all() and np.abs(g).max() > 1e-3


def test_refusals_match_jax():
    with pytest.raises(ValueError, match="contract"):
        jh.make_hamiltonian_energy(_ansatz(THETA), CUT_KW, TERMS,
                                   contract=False, num_samples=100)
    with pytest.raises(ValueError, match="contract"):
        th.make_hamiltonian_energy(to_port(_ansatz(THETA)), CUT_KW, TERMS,
                                   contract=False, num_samples=100,
                                   device=CPU)
    measured = JCircuit(2, 2)
    measured.h(0)
    measured.measure(0, 0)
    with pytest.raises(ValueError, match="measure"):
        th.measurement_circuit(to_port(measured), "ZI")
    with pytest.raises(ValueError, match="letters"):
        th.make_hamiltonian_energy(to_port(_ansatz(THETA)), CUT_KW,
                                   [(1.0, "ZZ")], device=CPU)


def test_energy_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        th.make_hamiltonian_energy(to_port(_ansatz(THETA)), CUT_KW, TERMS)


def test_host_helpers_match_jax():
    terms = [(1.0, "ZZII"), (1.0, "IIZZ"), (0.5, "XIXI"), (0.2, "IYII"),
             (-0.3, "YIIZ")]
    assert th.group_qubitwise(terms) == jh.group_qubitwise(terms)
    np.testing.assert_array_equal(th.dense_matrix(terms, 4),
                                  jh.dense_matrix(terms, 4))
    for basis in ("XYZI", "ZZZZ", "IYXX"):
        jc = jh.measurement_circuit(_ansatz(THETA, n=4), basis)
        tc = th.measurement_circuit(to_port(_ansatz(THETA, n=4)), basis)
        assert [(i.name, i.qubits, i.clbits) for i in tc.instructions] == \
            [(i.name, i.qubits, i.clbits) for i in jc.instructions]
        assert [(r.name, r.size) for r in tc.cregs] == \
            [(r.name, r.size) for r in jc.cregs]


def test_mesh_of_one_changes_nothing():
    """``mesh=`` a mesh of one (no process group): the unsharded energy
    and gradient, exactly."""
    kw = dict(device=CPU)
    plain, _ = th.make_hamiltonian_energy(to_port(_ansatz(THETA)), CUT_KW,
                                          TERMS, **kw)
    meshed, _ = th.make_hamiltonian_energy(
        to_port(_ansatz(THETA)), CUT_KW, TERMS,
        mesh=make_mesh(1, device=CPU), **kw)
    a, ga = _value_and_grad(plain, THETA)
    b, gb = _value_and_grad(meshed, THETA)
    assert abs(a - b) <= 1e-6
    np.testing.assert_allclose(ga, gb, atol=1e-6)


def test_vqe_descends_toward_the_tfim_ground_state():
    """tests/test_hamiltonian.py's descent (lr 0.1 from linspace(0.2,
    1.9)), 40 steps: well below the start, never below the ground
    energy."""
    terms = tfim_terms(N)
    e_min = float(np.linalg.eigvalsh(jh.dense_matrix(terms, N))[0])
    th0 = np.linspace(0.2, 1.9, 2 * N)
    energy, _ = th.make_hamiltonian_energy(to_port(_ansatz(th0)), CUT_KW,
                                           terms, device=CPU)
    t = torch.tensor(th0, dtype=torch.float32)
    for step in range(40):
        t.requires_grad_(True)
        e = energy(t)
        (g,) = torch.autograd.grad(e, t)
        if step == 0:
            e0 = float(e.detach())
        t = (t - 0.1 * g).detach()
    e = float(energy(t))
    assert e < e0 - 0.5 * (e0 - e_min), (e0, e, e_min)
    assert e >= e_min - 1e-4


# -- QAOA -------------------------------------------------------------------


class _Ring:
    """A graph without networkx: ``nodes()`` and ``edges()`` only."""

    def __init__(self, n):
        self.n = n

    def nodes(self):
        return list(range(self.n))

    def edges(self):
        # networkx's cycle_graph order: node 0's two edges first
        return [(0, 1), (0, self.n - 1)] + [(i, i + 1)
                                            for i in range(1, self.n - 1)]


def _instructions(circ):
    return [(i.name, list(i.qubits), list(i.clbits),
             [(float(p), getattr(p, "index", None), getattr(p, "scale", None),
               getattr(p, "shift", None)) for p in i.params])
            for i in circ.instructions]


@pytest.mark.parametrize("graph", [nx.path_graph(6), nx.cycle_graph(16)],
                         ids=["path6", "cycle16"])
def test_construct_qaoa_plus_matches_jax(graph):
    jc = j_qaoa(P=2, G=graph, params=[JParamRef(0, 0.7), 0.5,
                                      JParamRef(1, -0.3), 1.1],
                barriers=True, measure=True)
    tc = construct_qaoa_plus(P=2, G=graph, params=[ParamRef(0, 0.7), 0.5,
                                                   ParamRef(1, -0.3), 1.1],
                             barriers=True, measure=True)
    assert _instructions(tc) == _instructions(jc)
    assert tc.num_qubits == jc.num_qubits
    assert tc.num_clbits == jc.num_clbits
    if len(graph) == 16:
        ring = construct_qaoa_plus(P=2, G=_Ring(16), params=[
            ParamRef(0, 0.7), 0.5, ParamRef(1, -0.3), 1.1], barriers=True,
            measure=True)
        assert _instructions(ring) == _instructions(jc)


def test_qaoa_maxcut_energy_and_gradient_match_jax():
    """tests/test_hamiltonian.py's QAOA+ MaxCut on the 6-path (affine
    ParamRefs, one group): JAX's energy and gradient, the oracle within
    2e-3, and a gradient step increases the expected cut."""
    graph = nx.path_graph(6)
    n = 6
    terms = []
    for i, j in graph.edges():
        p = ["I"] * n
        p[i] = p[j] = "Z"
        terms.append((0.5, "".join(p)))
    terms.append((-0.5 * graph.number_of_edges(), "I" * n))
    theta = np.array([0.7, 0.5])
    kw = dict(maxNPartitions=2, maxNQubitsPerPartition=n // 2 + 1,
              maxNQpdCuts=6, maxNCuts=6, maxCutsPerPartitions=6)
    j_energy, j_info = jh.make_hamiltonian_energy(
        j_qaoa(P=1, G=graph, params=[JParamRef(0, theta[0]),
                                     JParamRef(1, theta[1])]), kw, terms)
    energy, info = th.make_hamiltonian_energy(
        construct_qaoa_plus(P=1, G=graph, params=[ParamRef(0, theta[0]),
                                                  ParamRef(1, theta[1])]),
        kw, terms, device=CPU)
    assert (info.n_params, info.n_groups) == (2, 1)
    assert info.instances_per_step == j_info.instances_per_step
    e0, g = _value_and_grad(energy, theta)
    j_e, j_g = _jax_value_and_grad(j_energy, theta)
    assert abs(e0 - j_e) < 1e-5
    np.testing.assert_allclose(g, j_g, atol=2e-5)
    want = _oracle(j_qaoa(P=1, G=graph, params=list(theta)), terms)
    assert abs(e0 - want) < 2e-3
    assert float(energy(theta - 0.1 * g)) < e0
