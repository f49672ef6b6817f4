"""The sharded engine across processes: ``gloo`` worlds of 4 and 2 CPU
ranks against the JAX package on one CPU device.

Port twins of the JAX package's multi-device tests
(tests/test_sharded_sv.py, tests/test_sharded_fragment.py,
tests/test_multichip.py::test_sampled_scan_dp_sharded,
tests/test_streamed_sharded.py), which run virtual CPU meshes in
subprocesses, and of its dp dry-runs of the variational path
(``__graft_entry__._dryrun_vqe_sharded``, ``_dryrun_population_sharded``),
held against the port without a mesh.  Each world is spawned once per module
(tests/torch_dist_common.spawn_world, a 120 s limit that kills every
rank), runs all of its scenarios (tests/torch_dist_scenarios.py,
importing only the port), and rank 0 writes the results; each test
below holds one scenario against the JAX function run here in process.
Every rank's copy of a result is gathered, so the tests also check that
all ranks hold the same answer.
"""
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
    Instruction as JInstruction,
    ParamRef as JParamRef,
    Register as JRegister,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
    qpd_sampling as jq,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.knit import (  # noqa: E501
    knit as j_knit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
    simulate_circuit as j_simulate,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.variant_engine import (  # noqa: E501
    run_all_fragments as j_run_all,
    run_fragment as j_run_fragment,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_gates import (  # noqa: E501
    VirtualGateOp as JVirtualGateOp,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_to_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    hellinger_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    qpd_sampling as tq,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.hamiltonian import (  # noqa: E501
    make_hamiltonian_energy,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.knit import (  # noqa: E501
    nearest_probability_distribution,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.optim import (  # noqa: E501
    spsa_minimize,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    Distribution,
)
from torch_dist_common import WorldFailed, spawn_world
from torch_port_common import CUT_KW, qft_gamma_pair, to_port

ATOL = 1e-6
SAMPLED_KW = dict(num_samples=3000, seed=3, pallas_variant=False)
KNIT_TOL = dict(atol=5e-5, rtol=1e-3)  # JAX's own, kernel vs XLA route


def _ghz6():
    circ = JCircuit(6, 6)
    circ.h(0)
    for i in range(5):
        circ.cx(i, i + 1)
    circ.t(0)
    circ.cz(0, 5)
    circ.rz(0.3, 1)
    for q in range(6):
        circ.measure(q, q)
    return circ


def _mid_measure():
    """Deferred-measurement ancillas live above the circuit qubits
    (local); gates hit global qubits 0 and 1."""
    circ = JCircuit(3, 4)
    circ.h(0)
    circ.cx(0, 1)
    circ.measure(0, 3)
    circ.h(0)
    circ.ry(0.7, 2)
    circ.cx(1, 2)
    for q in range(3):
        circ.measure(q, q)
    return circ


def _layers():
    """Random 2-qubit layers over 4 amp shards (qubits 0 and 1 global):
    both qubits global, one global in either operand order, both
    local."""
    rng = np.random.default_rng(3)
    circ = JCircuit(5, 5)
    for q in range(5):
        circ.ry(float(rng.standard_normal()), q)
    for a, b in [(0, 1), (2, 3), (1, 2), (3, 4), (0, 4), (1, 3),
                 (3, 0), (4, 1), (1, 0)]:
        circ.cx(a, b)
        circ.rz(float(rng.standard_normal()), b)
    circ.rzz(0.4, 2, 0)
    circ.rzz(0.9, 0, 1)
    for q in range(5):
        circ.measure(q, q)
    return circ


SV_CASES = {"ghz": _ghz6, "mid_measure": _mid_measure, "layers": _layers}


def _big_fragment(nbig=10):
    """tests/test_sharded_fragment.py's asymmetric hand-built cut, at
    ``nbig`` qubits: a CX chain with rz, one cz cut onto a 2-qubit
    fragment."""
    cut = JCircuit([JRegister("frag0", nbig), JRegister("frag1", 2)],
                   nbig + 2)
    cut.h(0)
    for i in range(nbig - 1):
        cut.cx(i, i + 1)
    for q in range(nbig):
        cut.rz(0.1 * (q + 1), q)
    cut.append(JInstruction("vgate", [nbig - 1, nbig],
                            op=JVirtualGateOp("cz")))
    cut.cx(nbig, nbig + 1)
    for q in range(nbig + 2):
        cut.measure(q, q)
    return cut


def _chain(n, cap, cz=False):
    circ = JCircuit(n, n)
    circ.h(0)
    for i in range(n - 1):
        circ.cx(i, i + 1)
    if cz:
        circ.cz(0, n - 1)
    else:
        for q in range(n):
            circ.rz(0.1 * (q + 1), q)
    for q in range(n):
        circ.measure(q, q)
    cutter = JCutter(circ, maxNPartitions=2, maxNQubitsPerPartition=cap,
                     **CUT_KW)
    assert cutter.solve()
    return circ, cutter.getResultCircs()[3]


@pytest.fixture(scope="module")
def cases():
    chain8, cut8 = _chain(8, 5)
    _, cut6 = _chain(6, 4, cz=True)
    big = _big_fragment()
    qj, qt = qft_gamma_pair(7, 6)
    return {"chain8": (chain8, cut8), "cut6": cut6, "big": big,
            "qft7": (qj, qt)}


@pytest.fixture(scope="module")
def world4(cases, tmp_path_factory):
    payload = {
        "sv": {k: circuit_to_instructions(f()) for k, f in SV_CASES.items()},
        "frag": circuit_to_instructions(cases["big"]),
        "chain8": circuit_to_instructions(cases["chain8"][1]),
    }
    return spawn_world(4, "torch_dist_scenarios", "world4",
                       tmp_path_factory.mktemp("world4"), payload)


def _tfim_case(n, seed, low, h, cap):
    """The JAX package's dp dry-run VQE shapes (``__graft_entry__``
    ``_dryrun_vqe_sharded`` at n = 6, ``_dryrun_population_sharded`` at
    n = 4): ry layers as ParamRefs around a cx chain, a TFIM chain,
    ``(ansatz, theta, terms, cut_kw)``."""
    rng = np.random.default_rng(seed)
    layers = 2 if n == 6 else 1
    th = rng.uniform(-low, low, layers * n).astype(np.float32)
    c = JCircuit(n, n)
    for q in range(n):
        c.ry(JParamRef(q, float(th[q])), q)
    for i in range(n - 1):
        c.cx(i, i + 1)
    if layers == 2:
        for q in range(n):
            c.ry(JParamRef(n + q, float(th[n + q])), q)
    terms = []
    for i in range(n - 1):
        p = ["I"] * n
        p[i] = p[i + 1] = "Z"
        terms.append((-1.0, "".join(p)))
    for i in ([*range(n)] if n == 6 else [0, n - 1]):
        p = ["I"] * n
        p[i] = "X"
        terms.append((-h, "".join(p)))
    kw = dict(maxNPartitions=2, maxNQubitsPerPartition=cap, maxNQpdCuts=5,
              maxNCuts=5, maxCutsPerPartitions=5)
    return c, th, terms, kw


VQE = _tfim_case(6, 7, 1.0, 0.7, 4)
POP = _tfim_case(4, 5, 0.5, 0.5, 3)
VQE_MC = dict(num_samples=4000, sample_method="lhs", sample_seed=1)
SPSA = dict(steps=5, key=9, pairs=4, a=0.3, c=0.1)
POP_THETAS = (POP[1] + np.random.default_rng(2).normal(
    0, 0.3, (5, POP[1].size))).astype(np.float32)


def _variational_payload():
    (vc, vth, vterms, vkw), (pc, pth, pterms, pkw) = VQE, POP
    return {
        "vqe": {"ansatz": circuit_to_instructions(vc), "theta": vth,
                "terms": vterms, "cut_kw": vkw, "sampled": VQE_MC},
        "population": {"ansatz": circuit_to_instructions(pc),
                       "theta0": pth, "terms": pterms, "cut_kw": pkw,
                       "thetas": POP_THETAS, "spsa": SPSA},
    }


@pytest.fixture(scope="module")
def world2(cases, tmp_path_factory):
    payload = {
        "qft7": circuit_to_instructions(cases["qft7"][0]._circuit),
        "chain6": circuit_to_instructions(cases["cut6"]),
        "chain8": circuit_to_instructions(cases["chain8"][1]),
        "sampled_kw": SAMPLED_KW,
        "checkpoint_dir": str(tmp_path_factory.mktemp("checkpoint")),
        "variational": _variational_payload(),
    }
    return spawn_world(2, "torch_dist_scenarios", "world2",
                       tmp_path_factory.mktemp("world2"), payload)


@pytest.fixture(scope="module")
def chain8_jax(cases):
    """(oracle, JAX per-fragment results, JAX knit) of the 8-qubit chain."""
    circ, cut = cases["chain8"]
    jv = JVirtualCircuit(cut)
    results = j_run_all(jv)
    return j_simulate(circ), results, j_knit(jv, results)


def _same_on_every_rank(copies):
    for c in copies[1:]:
        np.testing.assert_array_equal(c, copies[0])
    return copies[0]


@pytest.mark.parametrize("name", sorted(SV_CASES))
def test_shard_ctx_on_4_ranks_matches_jax_simulate(world4, name):
    """1 x 4 (amp only, k = 2): local gates, one-hop 1q and mixed 2q
    gates in both operand orders, the two-hop 2q gate on two global
    qubits, mid-circuit measurement; the marginal summed over amp."""
    want = j_simulate(SV_CASES[name]())
    got = _same_on_every_rank(world4[f"sv_{name}"])
    assert list(world4[f"sv_{name}_pos"]) == list(want.bit_positions)
    np.testing.assert_allclose(got, np.asarray(want.values), atol=ATOL)


def test_sharded_fragment_dp2_amp2_matches_jax_run_fragment(world4, cases):
    """An 11-sim-qubit fragment co-sharded dp=2 x amp=2: rows within the
    JAX test's 1e-5 of JAX ``run_fragment``."""
    want = j_run_fragment(JVirtualCircuit(cases["big"]), "frag0")
    got = _same_on_every_rank(world4["frag22"])
    assert list(world4["frag22_pos"]) == list(want.bit_positions)
    assert list(world4["frag22_touch"]) == list(want.touching)
    np.testing.assert_allclose(got, np.asarray(want.values), atol=1e-5)


def test_bf16_sharded_fragment_dp2_amp2_close_to_f32(world4, cases):
    """bf16 blocks and bf16 exchanges over 2 x 2 ranks: within 5e-3 of
    JAX's f32 rows."""
    want = np.asarray(j_run_fragment(JVirtualCircuit(cases["big"]),
                                     "frag0").values)
    err = np.abs(world4["frag22_bf16"] - want).max()
    assert 0 < err < 5e-3, err


def test_sharded_engine_end_to_end_on_4_ranks(world4, chain8_jax):
    """``run_virtual_circuit(engine="sharded", max_local_qubits=biggest -
    2)``: every fragment's amplitudes split over 4 ranks; values within
    1e-6 of JAX ``engine="xla"``, fidelity to the oracle > 1 - 1e-5."""
    oracle, _, want = chain8_jax
    got = _same_on_every_rank(world4["e2e"])
    assert int(world4["e2e_biggest"]) >= 5
    assert list(world4["e2e_pos"]) == list(want.bit_positions)
    np.testing.assert_allclose(got, np.asarray(want.values), atol=ATOL)
    proj = nearest_probability_distribution(
        Distribution(got, list(want.bit_positions), want.num_clbits))
    assert hellinger_fidelity(
        Distribution(np.asarray(oracle.values), list(oracle.bit_positions),
                     oracle.num_clbits), proj) > 1 - 1e-5


def test_ranks_left_out_of_the_mesh_receive_the_rows(world4, chain8_jax):
    """``fragment_mesh`` over ranks 0..2 takes the largest power of two
    (ranks 0 and 1); ranks 2 and 3 get the rows from the mesh."""
    _, results, _ = chain8_jax
    for res in results:
        got = _same_on_every_rank(world4[f"left_out_{res.name}"])
        np.testing.assert_allclose(got, np.asarray(res.values), atol=ATOL)


def test_knit_step_dp2_tp2_matches_jax_knit(world4, chain8_jax):
    """``make_sharded_step`` on dp=2 x tp=2: rows split over both axes,
    gathered, knitted on every rank; JAX's knit within 1e-6."""
    _, _, want = chain8_jax
    got = _same_on_every_rank(world4["step22"])
    np.testing.assert_allclose(got, np.asarray(want.values), atol=ATOL)


@pytest.fixture
def jax_scan(monkeypatch):
    """The JAX estimators on their blocked, jitted scan (the same
    estimator as the unblocked path): one compile instead of every op of
    the unblocked path."""
    monkeypatch.setattr(jq, "_label_budget", lambda: 1 << 12)


def test_sampled_scan_dp_sharded(world2, cases, jax_scan):
    """The label blocks over dp = 2 (each rank scans its own, the block
    count padded to a multiple of dp, the statistics summed):
    distribution, stderr and <Z> within the JAX kernel-route tolerance of
    the JAX estimators with ``mesh=None`` on the same cut, and within
    1e-5 of the port's unsharded estimate (the JAX test's 3000 samples,
    lhs and control variate, on a qft-7 gamma cut: 6 cp cuts, fragments
    of 7 and 12 simulated qubits; the rows without a kernel, the JAX
    default: the kernel's plain version is 8x slower on the CPU)."""
    qj, tv = cases["qft7"]
    args = dict(keep_clbits={0, 1}, with_stderr=True, method="lhs",
                control_variate=True, **SAMPLED_KW)
    z_sets = [{0}, {0, 1, 2}]
    j_est, j_se = jq.sampled_knit(qj, **args)
    j_z = jq.sampled_expectation_z(qj, z_sets, **SAMPLED_KW)
    est, se = tq.sampled_knit(tv, device="cpu", **args)
    z = tq.sampled_expectation_z(tv, z_sets, device="cpu", **SAMPLED_KW)
    got = _same_on_every_rank(world2["sampled"])
    np.testing.assert_allclose(got, np.asarray(j_est.values), **KNIT_TOL)
    np.testing.assert_allclose(world2["sampled_se"], j_se, **KNIT_TOL)
    np.testing.assert_allclose(world2["sampled_z"], np.asarray(j_z),
                               **KNIT_TOL)
    assert np.abs(got - est.values).max() < 1e-5
    assert np.abs(world2["sampled_se"] - se).max() < 1e-5
    assert np.abs(world2["sampled_z"] - np.asarray(z)).max() < 1e-5


@pytest.mark.parametrize("key", ["streamed", "streamed_share",
                                 "streamed_kernel"])
def test_streamed_chunks_over_dp(world2, cases, key):
    """``streamed_values_dp`` over 2 ranks (each its contiguous chunks,
    the carry summed): banks off, banks on (the bank path engages), and
    the kernel route's plain versions; JAX ``knit(run_all_fragments)``
    within 2e-6."""
    jv = JVirtualCircuit(cases["cut6"])
    want = np.asarray(j_knit(jv, j_run_all(jv)).values)
    got = _same_on_every_rank(world2[key])
    assert int(world2[key + "_chunks"]) >= 2
    if key == "streamed_share":
        assert int(world2[key + "_splits"]) > 0
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_knit_step_dp2_matches_jax_knit(world2, cases):
    jv = JVirtualCircuit(cases["cut6"])
    want = np.asarray(j_knit(jv, j_run_all(jv)).values)
    got = _same_on_every_rank(world2["step2"])
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_sharded_engine_default_mesh_on_2_ranks(world2, chain8_jax):
    """``engine="sharded"`` without ``max_local_qubits``: each fragment's
    mesh is dp=2 x amp=1; JAX ``engine="xla"`` within 1e-6."""
    _, _, want = chain8_jax
    got = _same_on_every_rank(world2["e2e_dp2"])
    np.testing.assert_allclose(got, np.asarray(want.values), atol=ATOL)


def test_sharded_checkpoints_on_2_ranks(world2, chain8_jax):
    """``checkpoint_dir`` in a world of 2: rank 0 writes late, yet the
    second call resumes on both ranks (no rank looks before the write
    ends); when one rank cannot read the checkpoint, both simulate again
    (no rank is left in collectives alone).  Every call within 1e-6 of
    JAX ``engine="xla"``."""
    _, _, want = chain8_jax
    simulated = _same_on_every_rank(world2["ckpt_simulated"])
    assert simulated.tolist() == [1, 1, 2]
    first = _same_on_every_rank(world2["ckpt_0"])
    np.testing.assert_allclose(first, np.asarray(want.values), atol=ATOL)
    for call in (1, 2):
        np.testing.assert_array_equal(
            _same_on_every_rank(world2[f"ckpt_{call}"]), first)


def _unsharded_value_and_grad(fn, theta):
    t = torch.tensor(np.asarray(theta, np.float32), requires_grad=True)
    e = fn(t)
    e.sum().backward()
    return e.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("key", ["vqe", "vqe_mc"])
def test_vqe_energy_and_gradient_over_dp(world2, key):
    """``make_hamiltonian_energy(mesh=)`` over dp = 2, exact and
    stochastic (4000 LHS samples): energy, gradient and the energy after
    one step of 0.1 along that gradient are the unsharded ones within
    1e-6 on every rank; the step descends."""
    ansatz, theta, terms, kw = VQE
    energy, info = make_hamiltonian_energy(
        to_port(ansatz), kw, terms, device="cpu",
        **(VQE_MC if key == "vqe_mc" else {}))
    e, g = _unsharded_value_and_grad(energy, theta)
    got = _same_on_every_rank(world2[key])
    grad = _same_on_every_rank(world2[key + "_grad"])
    step = _same_on_every_rank(world2[key + "_step"])
    assert int(world2[key + "_instances"]) == info.instances_per_step
    assert abs(float(got) - float(e)) <= 1e-6
    np.testing.assert_allclose(grad, g, atol=1e-6)
    # the same step (the world's gradient) taken without the mesh
    assert abs(float(step) - float(energy(theta - 0.1 * grad))) <= 1e-6
    assert float(step) < float(got)
    assert np.linalg.norm(grad) > 1e-3


def test_population_over_dp(world2):
    """5 candidates over dp = 2 (3 on rank 0, 2 on rank 1): every rank
    holds all five energies and the unsharded gradient of their weighted
    sum, within 1e-6."""
    ansatz, _theta, terms, kw = POP
    energy, _ = make_hamiltonian_energy(to_port(ansatz), kw, terms,
                                        device="cpu")
    weights = torch.arange(1.0, 6.0)
    looped = torch.stack([energy(t) for t in torch.as_tensor(POP_THETAS)])
    _e, g = _unsharded_value_and_grad(
        lambda t: torch.stack([energy(x) for x in t]) * weights, POP_THETAS)
    np.testing.assert_allclose(_same_on_every_rank(world2["pop"]),
                               looped.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(_same_on_every_rank(world2["pop_grad"]), g,
                               atol=1e-6)


def test_spsa_over_dp_reproduces_the_single_process_trajectory(world2):
    """SPSA with 8 probes a step split over dp = 2 (the same int key on
    every rank): theta, history and final energy of the single-process
    run within 1e-5, identical on both ranks."""
    ansatz, theta0, terms, kw = POP
    energy, _ = make_hamiltonian_energy(to_port(ansatz), kw, terms,
                                        device="cpu")
    want = spsa_minimize(energy, theta0, device="cpu", **SPSA)
    np.testing.assert_allclose(_same_on_every_rank(world2["spsa_theta"]),
                               want.theta, atol=1e-5)
    np.testing.assert_allclose(_same_on_every_rank(world2["spsa_history"]),
                               want.history, atol=1e-5)
    assert abs(float(_same_on_every_rank(world2["spsa_energy"])[0])
               - want.energy) < 1e-5


def test_a_failing_rank_fails_the_world_with_every_rank_quoted(tmp_path):
    with pytest.raises(WorldFailed) as err:
        spawn_world(2, "torch_dist_common", "probe_fail", tmp_path)
    text = str(err.value)
    assert "rank 1 fails on purpose" in text
    assert "--- rank 0" in text and "--- rank 1" in text


def test_a_hung_world_is_killed_at_its_limit(tmp_path):
    with pytest.raises(WorldFailed, match="timed out after 4 s"):
        spawn_world(2, "torch_dist_common", "probe_hang", tmp_path,
                    timeout=4)
