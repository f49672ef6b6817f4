"""The port's parameter sweeps (ops/sweep.py) against the JAX package's.

Inputs are the JAX tests' (tests/test_sweep.py, tests/test_grad_sweep.py):
circuits built and cut with the JAX package and carried across with
``convert`` (ParamRefs included), thetas from seeded numpy.  Tolerances:
sweep values within 1e-6 of JAX and within 3e-6 of the port's
``run_virtual_circuit`` (the JAX test's bound against its engine),
gradients within 2e-5 of ``jax.grad`` (the JAX package's own bound
between its routes), the sampled sweep's full-grid identity within 3e-6.
Every JAX reference is computed once per module under ``jax.jit`` (on
the CPU a cold jitted call of these runners takes ~1 s where the eager
one takes 4-10 s: eager JAX compiles every op apart).
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
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
    fusion as jfusion,
    qpd_sampling as jq,
    sweep as js,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    hellinger_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    fusion as tfusion,
    qpd_sampling as tq,
    sweep as ts,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    Distribution,
    simulate_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from tests.test_qpd_sampling import _full_grid
from torch_port_common import to_port

N = 5
CPU = "cpu"
THETA0 = np.linspace(0.3, 2.1, 2 * N)


def _cut(circ):
    """(JAX VirtualCircuit, port VirtualCircuit) of one JAX cut."""
    cutter = JCutter(circ, maxNPartitions=2, maxNQubitsPerPartition=3,
                     maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    return JVirtualCircuit(cut), TVirtualCircuit(to_port(cut))


def _bind_ansatz(thetas):
    """tests/test_sweep.py's ansatz: plain floats, a parameterised rzz."""
    circ = JCircuit(N, N)
    for q in range(N):
        circ.ry(float(thetas[q]), q)
    for i in range(N - 1):
        circ.cx(i, i + 1)
    circ.rzz(float(thetas[N]), 0, N - 1)
    for q in range(N):
        circ.ry(float(thetas[N + 1 + q]), q)
    for q in range(N):
        circ.measure(q, q)
    return circ


def _grad_ansatz(thetas):
    """tests/test_grad_sweep.py's ansatz: every rotation a ParamRef."""
    c = JCircuit(N, N)
    for q in range(N):
        c.ry(JParamRef(q, float(thetas[q])), q)
    for i in range(N - 1):
        c.cx(i, i + 1)
    for q in range(N):
        c.rx(JParamRef(N + q, float(thetas[N + q])), q)
    for q in range(N):
        c.measure(q, q)
    return c


def _t(theta, grad=False):
    return torch.tensor(np.asarray(theta, np.float32), requires_grad=grad)


# -- make_parameter_sweep ---------------------------------------------------


@pytest.fixture(scope="module")
def bind_case():
    rng = np.random.default_rng(13)
    theta_sets = [rng.standard_normal(2 * N + 1) for _ in range(3)]
    jv0, tv0 = _cut(_bind_ansatz(theta_sets[0]))
    j_runner, j_bind = js.make_parameter_sweep(jv0)
    j_runner = jax.jit(j_runner)
    cases = []
    for thetas in theta_sets:
        circ = _bind_ansatz(thetas)
        jv, tv = _cut(circ)
        cases.append((circ, tv, np.asarray(j_runner(j_bind(jv)))))
    return tv0, cases


def test_parameter_sweep_serves_every_binding_like_jax(bind_case):
    tv0, cases = bind_case
    runner, bind = ts.make_parameter_sweep(tv0, device=CPU)
    template = {k: tuple(v) for k, v in runner.template.items()}
    for circ, tv, want_jax in cases:
        vals = runner(bind(tv)).numpy()
        np.testing.assert_allclose(vals, want_jax, atol=1e-6)
        want, _ = run_virtual_circuit(tv, project=False, device=CPU)
        np.testing.assert_allclose(vals, np.asarray(want.values), atol=3e-6)
        got = Distribution(vals, sorted(range(N)), tv.num_clbits)
        oracle = simulate_circuit(to_port(circ), device=CPU)
        assert hellinger_fidelity(oracle, got) > 1 - 1e-5
    # one template served every binding: bind rebuilt nothing of it
    assert {k: tuple(v) for k, v in runner.template.items()} == template


def test_bind_rejects_structure_mismatch():
    _, tv = _cut(_bind_ansatz(np.zeros(2 * N + 1)))
    _runner, bind = ts.make_parameter_sweep(tv, device=CPU)
    other = JCircuit(N, N)
    other.h(0)
    for i in range(N - 1):
        other.cx(i, i + 1)
    other.cz(0, N - 1)
    for q in range(N):
        other.measure(q, q)
    with pytest.raises(ValueError):
        bind(_cut(other)[1])


def test_sweeps_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    _, tv = _cut(_grad_ansatz(THETA0))
    for build in (ts.make_parameter_sweep, ts.make_differentiable_sweep):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(tv)


# -- make_differentiable_sweep ----------------------------------------------


@pytest.fixture(scope="module")
def grad_case():
    jv, tv = _cut(_grad_ansatz(THETA0))
    j_runner, n = js.make_differentiable_sweep(jv)
    th = jnp.asarray(THETA0, jnp.float32)
    other = np.random.default_rng(3).uniform(-2, 2, 2 * N)
    z_sets = [[0], [0, 4], [1, 2, 3]]
    jz, _ = js.make_differentiable_sweep(jv, z_sets=z_sets)
    jr = jax.jit(j_runner)
    return {
        "jv": jv, "tv": tv, "n": n, "other": other, "z_sets": z_sets,
        "vals": np.asarray(jr(th)),
        "vals_other": np.asarray(jr(jnp.asarray(other, jnp.float32))),
        "grad": np.asarray(jax.jit(jax.grad(
            lambda t: jnp.sum(j_runner(t) ** 2)))(th)),
        "z": np.asarray(jax.jit(jz)(th)),
        "z_grad": np.asarray(jax.jit(jax.grad(lambda t: jz(t)[1]))(th)),
    }


def test_differentiable_sweep_values_match_jax_and_the_engine(grad_case):
    runner, n = ts.make_differentiable_sweep(grad_case["tv"], device=CPU)
    assert n == grad_case["n"] == 2 * N
    vals = runner(THETA0).numpy()
    np.testing.assert_allclose(vals, grad_case["vals"], atol=1e-6)
    want, _ = run_virtual_circuit(grad_case["tv"], project=False,
                                  device=CPU)
    np.testing.assert_allclose(vals, np.asarray(want.values), atol=3e-6)
    # another theta through the same runner: JAX's values, and a fresh
    # cut and run of the circuit built at that theta
    other = grad_case["other"]
    vals = runner(other).numpy()
    np.testing.assert_allclose(vals, grad_case["vals_other"], atol=1e-6)
    fresh, _ = run_virtual_circuit(_cut(_grad_ansatz(other))[1],
                                   project=False, device=CPU)
    np.testing.assert_allclose(vals, np.asarray(fresh.values), atol=5e-6)


def test_differentiable_sweep_gradient_matches_jax_grad(grad_case):
    runner, _ = ts.make_differentiable_sweep(grad_case["tv"], device=CPU)
    th = _t(THETA0, grad=True)
    (runner(th) ** 2).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), grad_case["grad"],
                               atol=2e-5)


def test_observable_sweep_and_its_gradient_match_jax(grad_case):
    runner, _ = ts.make_differentiable_sweep(
        grad_case["tv"], z_sets=grad_case["z_sets"], device=CPU)
    th = _t(THETA0, grad=True)
    z = runner(th)
    np.testing.assert_allclose(z.detach().numpy(), grad_case["z"],
                               atol=1e-6)
    z[1].backward()
    np.testing.assert_allclose(th.grad.numpy(), grad_case["z_grad"],
                               atol=2e-5)


def test_gradient_descent_finds_ground_state(grad_case):
    """tests/test_grad_sweep.py's descent on <prod Z>: -1 within 30
    steps of lr 0.5."""
    runner, _ = ts.make_differentiable_sweep(grad_case["tv"], device=CPU)
    diag = torch.as_tensor(ts.pauli_z_diagonal(sorted(range(N)),
                                               set(range(N))))
    th = _t(THETA0)
    for step in range(30):
        th.requires_grad_(True)
        e = torch.dot(runner(th), diag)
        (g,) = torch.autograd.grad(e, th)
        e = e.detach()
        if step == 0:
            assert float(e) > -0.1
        th = (th - 0.5 * g).detach()
    assert float(e) < -0.95, float(e)


def test_param_ref_on_cut_gate_raises():
    c = JCircuit(4, 4)
    for q in range(4):
        c.h(q)
    c.rzz(JParamRef(0, 0.7), 1, 2)  # the only 2q gate -> must be cut
    for q in range(4):
        c.measure(q, q)
    cutter = JCutter(c, maxNPartitions=2, maxNQubitsPerPartition=2,
                     maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    with pytest.raises(NotImplementedError, match="ParamRef"):
        js.make_differentiable_sweep(JVirtualCircuit(cut))
    tv = TVirtualCircuit(to_port(cut))
    for build in (ts.make_differentiable_sweep,
                  lambda v, **kw: ts.make_sampled_sweep(
                      v, np.zeros((1, len(v.vgates)), np.int32),
                      np.ones(1), **kw)):
        with pytest.raises(NotImplementedError, match="ParamRef"):
            build(tv, device=CPU)


def test_affine_param_refs_match_jax():
    """tests/test_grad_sweep.py's rz(theta/2), rx(-2 theta + pi/4) built
    with scaled/shifted refs, at a theta other than the template's."""

    def build(t0, t1):
        c = JCircuit(2, 2)
        c.ry(0.3, 0)
        c.rz(JParamRef(0, t0).scaled(0.5), 0)
        c.rx(JParamRef(1, t1).scaled(-2.0).shifted(np.pi / 4), 1)
        c.cx(0, 1)
        c.measure(0, 0)
        c.measure(1, 1)
        return c

    cutter = JCutter(build(0.9, -0.4), maxNPartitions=2,
                     maxNQubitsPerPartition=2, maxNQpdCuts=5, maxNCuts=5,
                     maxCutsPerPartitions=5)
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    j_runner, _ = js.make_differentiable_sweep(JVirtualCircuit(cut))
    runner, n = ts.make_differentiable_sweep(TVirtualCircuit(to_port(cut)),
                                             device=CPU)
    assert n == 2
    th = np.array([-0.35, 1.7])
    np.testing.assert_allclose(
        runner(th).numpy(),
        np.asarray(jax.jit(j_runner)(jnp.asarray(th, jnp.float32))),
        atol=1e-6)


GATE_PARAMS = {"rx": 1, "ry": 1, "rz": 1, "p": 1, "u1": 1, "u": 3, "u3": 3,
               "u2": 2, "rzz": 1, "cp": 1, "cu1": 1, "crz": 1, "fsim": 2}


@pytest.mark.parametrize("name", sorted(GATE_PARAMS))
def test_mat_theta_matches_jax_and_its_gradient(name):
    ps = np.random.default_rng(len(name)).uniform(-3, 3, GATE_PARAMS[name])
    want = np.asarray(js._mat_theta(
        name, [jnp.float32(p) for p in ps]))
    t = _t(ps, grad=True)
    got = ts._mat_theta(name, list(t))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    # the real block's gradient: sum of entries against jax.grad
    jg = jax.grad(lambda x: jnp.sum(js._real_block_traceable(
        js._mat_theta(name, list(x)))))(jnp.asarray(ps, jnp.float32))
    ts._real_block_traceable(got).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=2e-5)


def test_fused_stream_on_tensors_matches_jnp():
    """The fuser on complex64 tensors (``xp=torch``) against ``xp=jnp``:
    same skeleton, blocks within 1e-6, over an op stream with 1q, 2q
    (both operand orders), 3q-merging runs and a slot op between."""
    rng = np.random.default_rng(5)

    def unitary(k):
        a = rng.standard_normal((1 << k, 1 << k)) \
            + 1j * rng.standard_normal((1 << k, 1 << k))
        return np.linalg.qr(a)[0].astype(np.complex64)

    axes = [(0,), (1,), (0, 1), (1, 0), (2,), (1, 2), (3,), (2, 3), (0,),
            (0, 3), (3, 1)]
    ops = [("u", unitary(len(a)), a) for a in axes]
    ops.insert(6, ("slot_pre", 0, (2,)))
    j_skel, j_mats = jfusion.fused_stream(
        [(k, jnp.asarray(m), a) if k == "u" else (k, m, a)
         for k, m, a in ops], max_qubits=3, xp=jnp)
    t_skel, t_mats = tfusion.fused_stream(
        [(k, torch.as_tensor(m), a) if k == "u" else (k, m, a)
         for k, m, a in ops], max_qubits=3, xp=torch)
    np_skel, _ = tfusion.fused_stream(ops, max_qubits=3)
    assert t_skel == j_skel == np_skel
    assert len(t_mats) == len(j_mats)
    for tm, jm in zip(t_mats, j_mats):
        assert tm.dtype == torch.complex64
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)


def test_pauli_z_diagonal_matches_jax():
    for bits, z in (([0, 2, 5], {0, 5}), ([1, 3, 4, 7], {3}),
                    ([0, 1, 2], set())):
        np.testing.assert_array_equal(ts.pauli_z_diagonal(bits, z),
                                      js.pauli_z_diagonal(bits, z))


# -- make_sampled_sweep -----------------------------------------------------


@pytest.mark.parametrize("z_sets", [None, [[0], [0, 4], [1, 2, 3]]],
                         ids=["distribution", "observables"])
def test_sampled_sweep_full_grid_identity(grad_case, z_sets):
    """The FULL label grid with exact mass reproduces the exact sweep
    (values 3e-6, gradients 2e-5), as in tests/test_grad_sweep.py."""
    tv = grad_case["tv"]
    grid, mass = _full_grid(grad_case["jv"])
    exact, _ = ts.make_differentiable_sweep(tv, z_sets=z_sets, device=CPU)
    samp, n = ts.make_sampled_sweep(tv, grid, mass, z_sets=z_sets,
                                    device=CPU)
    assert n == 2 * N
    if z_sets is None:
        assert samp.bit_positions == sorted(range(N))
    th = _t(np.random.default_rng(7).uniform(-2, 2, 2 * N))
    np.testing.assert_allclose(samp(th).numpy(), exact(th).numpy(),
                               atol=3e-6)
    grads = []
    for fn in (samp, exact):
        t = _t(THETA0, grad=True)
        (fn(t) ** 2).sum().backward()
        grads.append(t.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], atol=2e-5)


def test_sampled_sweep_matches_jax_on_a_sample(grad_case):
    """A real (sub-grid) label sample: the port draws JAX's labels, and
    its estimate and gradient match JAX's sampled sweep."""
    jv, tv = grad_case["jv"], grad_case["tv"]
    n = 4000
    uniq, counts = tq.sample_label_counts(tv, n, seed=2)
    j_uniq, j_counts = jq.sample_label_counts(jv, n, seed=2)
    np.testing.assert_array_equal(uniq, j_uniq)
    np.testing.assert_array_equal(counts, j_counts)
    mass = counts.astype(np.float64) / n
    z_sets = [[0], [2, 3]]
    j_samp, _ = js.make_sampled_sweep(jv, uniq, mass, z_sets=z_sets)
    samp, _ = ts.make_sampled_sweep(tv, uniq, mass, z_sets=z_sets,
                                    device=CPU)
    th = jnp.asarray(THETA0, jnp.float32)
    t = _t(THETA0, grad=True)
    got = samp(t)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jax.jit(j_samp)(th)), atol=1e-6)
    got[1].backward()
    np.testing.assert_allclose(
        t.grad.numpy(),
        np.asarray(jax.jit(jax.grad(lambda x: j_samp(x)[1]))(th)),
        atol=2e-5)
