"""The port's population optimisers (ops/optim.py) against the JAX
package's.

The port draws its directions from a ``torch.Generator``, not
``jax.random``, so the trajectories are held to JAX's by handing the
port's private loops JAX's own draws (``jax.random.split``, then
``bernoulli`` / ``normal`` exactly as JAX ``ops/optim.py`` draws them):
theta within 1e-5 after 20 steps on tests/test_optim.py's quadratic
bowl.  The public optimisers are held by that file's convergence tests,
on the bowl and on a cut TFIM-4 energy.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
    ParamRef as JParamRef,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
    hamiltonian as jh,
    optim as jo,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    hamiltonian as th,
    optim as to,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.parallel.mesh import (  # noqa: E501
    make_mesh,
)
from torch_port_common import to_port

CPU = "cpu"
TARGET = np.array([0.7, -0.3, 1.1], np.float32)
J_TARGET = jnp.asarray(TARGET)
T_TARGET = torch.as_tensor(TARGET)


def j_bowl(theta):
    d = theta - J_TARGET
    return jnp.dot(d, d)


def t_bowl(theta):
    d = theta - T_TARGET
    return torch.dot(d, d)


def test_population_energy_matches_loop():
    thetas = torch.as_tensor(
        np.random.default_rng(0).normal(size=(5, 3)), dtype=torch.float32)
    batched = to.population_energy(t_bowl)(thetas)
    looped = torch.stack([t_bowl(t) for t in thetas])
    np.testing.assert_allclose(batched.numpy(), looped.numpy(), rtol=1e-6)


SPSA = dict(a=0.4, c=0.1, alpha=0.602, gamma=0.101)


def test_spsa_loop_from_jax_draws_matches_jax():
    steps, pairs, n = 20, 4, 3
    key = jax.random.PRNGKey(1)
    want = jo.spsa_minimize(j_bowl, jnp.zeros(3), steps=steps, key=key,
                            pairs=pairs, **SPSA)
    deltas = np.stack([
        np.where(np.asarray(jax.random.bernoulli(k, 0.5, (pairs, n))),
                 1.0, -1.0)
        for k in jax.random.split(key, steps)
    ]).astype(np.float32)
    theta, hist = to._spsa_loop(
        to.population_energy(t_bowl), torch.zeros(3),
        torch.as_tensor(deltas), big_a=0.1 * steps, **SPSA)
    np.testing.assert_allclose(theta.numpy(), want.theta, atol=1e-5)
    np.testing.assert_allclose(hist.numpy(), want.history, atol=1e-5)


@pytest.mark.parametrize("shaping", [True, False],
                         ids=["ranks", "standardised"])
def test_nes_loop_from_jax_draws_matches_jax(shaping):
    steps, pop, n = 20, 8, 3
    key = jax.random.PRNGKey(2)
    kw = dict(sigma=0.2, lr=0.3, fitness_shaping=shaping)
    want = jo.nes_minimize(j_bowl, jnp.zeros(3), steps=steps, key=key,
                           pop=pop, **kw)
    eps_half = np.stack([
        np.asarray(jax.random.normal(k, (pop // 2, n), jnp.float32))
        for k in jax.random.split(key, steps)
    ])
    theta, hist = to._nes_loop(to.population_energy(t_bowl),
                               torch.zeros(3), torch.as_tensor(eps_half),
                               **kw)
    np.testing.assert_allclose(theta.numpy(), want.theta, atol=1e-5)
    np.testing.assert_allclose(hist.numpy(), want.history, atol=1e-5)


def test_spsa_converges_on_quadratic():
    res = to.spsa_minimize(t_bowl, np.zeros(3), steps=200, key=1, pairs=4,
                           a=0.4, c=0.1, device=CPU)
    assert res.energy < 1e-2, (res.energy, res.theta)
    np.testing.assert_allclose(res.theta, TARGET, atol=0.1)
    assert res.evaluations == 2 * 4 * 200 + 1
    assert res.history.shape == (200,)
    assert res.history[-50:].mean() < res.history[:50].mean()


def test_nes_converges_on_quadratic():
    """Rank-shaped NES at a fixed rate ends in a noise ball, not at the
    optimum: over JAX keys 0..19 (tests/test_optim.py's settings) JAX's
    final energy has mean 0.083 and max 0.29, below that file's 5e-2 for
    10 of the 20 keys.  So the port is held to that distribution over
    its seeds 0..19: mean below 0.15, each below 0.4 (the start's energy
    is 1.79)."""
    finals = []
    for seed in range(20):
        res = to.nes_minimize(t_bowl, np.zeros(3), steps=150, key=seed,
                              pop=8, sigma=0.2, lr=0.3, device=CPU)
        assert res.evaluations == 8 * 150 + 1
        assert res.energy < 0.4, (seed, res.energy, res.theta)
        finals.append(res.energy)
    assert np.mean(finals) < 0.15, finals


def test_nes_rejects_odd_population():
    with pytest.raises(ValueError):
        jo.nes_minimize(j_bowl, jnp.zeros(3), steps=1,
                        key=jax.random.PRNGKey(0), pop=5)
    with pytest.raises(ValueError):
        to.nes_minimize(t_bowl, np.zeros(3), steps=1, key=0, pop=5,
                        device=CPU)


def test_key_is_a_generator_or_its_seed():
    """An int key seeds a generator on theta's device: the same run as
    that generator passed in, and another seed gives another run."""
    kw = dict(steps=5, pairs=2, device=CPU)
    by_int = to.spsa_minimize(t_bowl, np.zeros(3), key=7, **kw)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(7)
    by_gen = to.spsa_minimize(t_bowl, np.zeros(3), key=gen, **kw)
    other = to.spsa_minimize(t_bowl, np.zeros(3), key=8, **kw)
    np.testing.assert_array_equal(by_int.theta, by_gen.theta)
    assert not np.array_equal(by_int.theta, other.theta)


def test_optimisers_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        to.spsa_minimize(t_bowl, np.zeros(3), steps=1, key=0)


def _tfim(n=4):
    """tests/test_optim.py's TFIM-4 on a 2-partition cut ansatz, built
    with the JAX package and carried across; its ground energy."""
    rng = np.random.default_rng(11)
    th0 = rng.uniform(-0.5, 0.5, 2 * n)
    c = JCircuit(n, n)
    for q in range(n):
        c.ry(JParamRef(q, float(th0[q])), q)
    for i in range(n - 1):
        c.cx(i, i + 1)
    for q in range(n):
        c.ry(JParamRef(n + q, float(th0[n + q])), q)
    terms = []
    for i in range(n - 1):
        p = ["I"] * n
        p[i] = p[i + 1] = "Z"
        terms.append((-1.0, "".join(p)))
    for i in range(n):
        p = ["I"] * n
        p[i] = "X"
        terms.append((-0.6, "".join(p)))
    kw = dict(maxNPartitions=2, maxNQubitsPerPartition=n // 2 + 1,
              maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    energy, _ = th.make_hamiltonian_energy(to_port(c), kw, terms,
                                           device=CPU)
    e0 = float(np.linalg.eigvalsh(jh.dense_matrix(terms, n)).min())
    return energy, th0.astype(np.float32), e0


@pytest.fixture(scope="module")
def tfim():
    return _tfim()


def test_population_energy_of_a_cut_circuit_is_one_batch(tfim):
    """The population through ``torch.func.vmap`` (one batch of
    population x variants) equals a loop of single energies within
    1e-5; on a mesh of one it is the same function."""
    energy, th0, _ = tfim
    thetas = torch.as_tensor(
        th0 + np.random.default_rng(1).normal(0, 0.3, (5, th0.size)),
        dtype=torch.float32)
    looped = torch.stack([energy(t) for t in thetas])
    batched = to.population_energy(energy)(thetas)
    np.testing.assert_allclose(batched.numpy(), looped.numpy(), atol=1e-5)
    meshed = to.population_energy(energy, make_mesh(1, device=CPU))(thetas)
    np.testing.assert_allclose(meshed.numpy(), batched.numpy(), atol=1e-6)


def test_spsa_on_cut_circuit_descends_toward_ground_state(tfim):
    energy, th0, e0 = tfim
    start = float(energy(th0))
    res = to.spsa_minimize(energy, th0, steps=80, key=3, pairs=4, a=0.6,
                           c=0.15, device=CPU)
    assert res.energy < start - 0.5 * (start - e0), (start, res.energy, e0)
    assert res.energy >= e0 - 1e-4


def test_nes_on_cut_circuit_descends(tfim):
    energy, th0, e0 = tfim
    start = float(energy(th0))
    res = to.nes_minimize(energy, th0, steps=60, key=4, pop=8, sigma=0.2,
                          lr=0.25, device=CPU)
    assert res.energy < start - 0.3 * (start - e0), (start, res.energy, e0)
    assert res.energy >= e0 - 1e-4
