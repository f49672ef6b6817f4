"""The sampled engine's public surface in the port against the JAX
package's, on the CPU: ``run_virtual_circuit(engine="sampled")`` with the
same arguments, the stratified estimator, the adaptive pair, and every
refusal.  Same seeds -> same labels and collapse draws -> same picks, so
estimates agree to the JAX kernel-route tolerance."""
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
    qpd_sampling as jq,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.run import (  # noqa: E501
    run_virtual_circuit as j_run,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    qpd_sampling as tq,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit as t_run,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from torch_port_common import qft_gamma_pair

KNIT_TOL = dict(atol=5e-5, rtol=1e-3)  # JAX's own, kernel vs XLA route


@pytest.fixture(scope="module")
def qft9():
    """qft-9 cut 8|1 in gamma mode (8 cp cuts): (jax virt, port virt)."""
    return qft_gamma_pair(9, 8)


def test_run_virtual_circuit_sampled_matches_jax(qft9):
    """The public route with the same arguments: auto collapse flags
    (both fragments in ancilla mode at this size), lhs, control variate,
    a marginal, projected and not."""
    jv, tv = qft9
    kw = dict(shots=1500, engine="sampled", seed=3, sample_method="lhs",
              sample_cv=True, keep_clbits=[0, 1])
    d0, _ = j_run(jv, sample_pallas=True, project=False, **kw)
    d1, info = t_run(tv, device="cpu", project=False, **kw)
    assert d1.bit_positions == d0.bit_positions == [0, 1]
    np.testing.assert_allclose(d1.values, np.asarray(d0.values), **KNIT_TOL)
    assert info.run_time > 0 and info.knit_time == 0.0
    # project=True is the same estimate through the simplex projection
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.knit import (  # noqa: E501
        nearest_probability_distribution,
    )

    d2, _ = t_run(tv, device="cpu", **kw)
    np.testing.assert_array_equal(
        d2.values, nearest_probability_distribution(d1).values)


def test_sampled_knit_stratified_matches_jax(qft9):
    """head_labels with collapse: replicate-group head variance plus the
    conditional tail (collapse_reps=2: two head groups)."""
    jv, tv = qft9
    args = dict(seed=4, keep_clbits=[0, 1], with_stderr=True, method="lhs",
                control_variate=True, collapse=True, head_labels=4,
                collapse_reps=2)
    e0, s0 = jq.sampled_knit(jv, 500, pallas_variant=True, **args)
    e1, s1 = tq.sampled_knit(tv, 500, device="cpu", **args)
    np.testing.assert_allclose(e1.values, np.asarray(e0.values), **KNIT_TOL)
    np.testing.assert_allclose(s1, s0, **KNIT_TOL)


def test_adaptive_pair_uses_the_same_budget(qft9):
    """eps-targeted estimation grows the budget by the sample's own
    standard error: the same rounds, the same ``samples_used``."""
    jv, tv = qft9
    kw = dict(seed=1, initial=256, max_samples=1024, collapse=True)
    e0, s0, n0 = jq.sampled_knit_adaptive(jv, 0.01, keep_clbits=[0, 1],
                                          pallas_variant=True, **kw)
    e1, s1, n1 = tq.sampled_knit_adaptive(tv, 0.01, keep_clbits=[0, 1],
                                          device="cpu", **kw)
    assert n1 == n0 == 1024
    np.testing.assert_allclose(e1.values, np.asarray(e0.values), **KNIT_TOL)
    np.testing.assert_allclose(s1, s0, **KNIT_TOL)
    zs = [{0}, {1, 2}]
    z0, t0, m0 = jq.sampled_expectation_z_adaptive(
        jv, zs, 0.2, control_variate=True, pallas_variant=True, **kw)
    z1, t1, m1 = tq.sampled_expectation_z_adaptive(
        tv, zs, 0.2, control_variate=True, device="cpu", **kw)
    assert m1 == m0
    np.testing.assert_allclose(z1, z0, **KNIT_TOL)
    np.testing.assert_allclose(t1, t0, **KNIT_TOL)
    with pytest.raises(ValueError, match="eps must be positive"):
        tq.sampled_knit_adaptive(tv, 0.0, device="cpu")
    with pytest.raises(ValueError, match="eps must be positive"):
        tq.sampled_expectation_z_adaptive(tv, zs, -1.0, device="cpu")


def test_run_virtual_circuit_sample_eps_and_default_budget(qft9, monkeypatch):
    """``sample_eps`` routes to the adaptive estimator with ``shots`` as
    the cap; without ``shots`` the budget is the plan's Hoeffding budget
    (kappa / 0.05^2 = 28675 samples here)."""
    _, tv = qft9
    d, _ = t_run(tv, engine="sampled", sample_eps=0.5, shots=512,
                 keep_clbits=[0], project=False, device="cpu")
    want, _, used = tq.sampled_knit_adaptive(
        tv, 0.5, keep_clbits=[0], max_samples=512, device="cpu")
    assert used == 512
    np.testing.assert_array_equal(d.values, want.values)
    assert tq.sampling_overhead(tv, eps=0.05)["shots_for_eps"] == 28675
    seen = {}

    def stub(virt, num_samples, **kw):
        seen.update(kw, num_samples=num_samples)
        # the control variate's variance comes back as the stderr
        return (want, np.full(2, 0.25)) if kw["with_stderr"] else want

    monkeypatch.setattr(tq, "sampled_knit", stub)
    _, info = t_run(tv, engine="sampled", seed=7, sample_cv=True,
                    device="cpu")
    assert seen["num_samples"] == 28675 and seen["seed"] == 7
    assert seen["control_variate"] is True and seen["method"] == "iid"
    assert seen["with_stderr"] is True
    np.testing.assert_array_equal(info.stderr, [0.25, 0.25])


@pytest.fixture
def jax_scan(monkeypatch):
    """The JAX estimators on their blocked, jitted scan at any label
    count (the same estimator as the unblocked path): one compile instead
    of every op of the unblocked path."""
    monkeypatch.setattr(jq, "_label_budget", lambda: 1 << 12)


def _meshes():
    """A mesh of one in each package: (jax, port)."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.parallel.mesh import (  # noqa: E501
        make_mesh as j_make_mesh,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.parallel.mesh import (  # noqa: E501
        make_mesh,
    )

    return j_make_mesh(1), make_mesh(device="cpu")


def _kolkata(traj=2):
    """fake_kolkata_v2 with ``traj`` trajectories: (jax, port)."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
        noise as jn,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
        noise_model_from_other,
    )

    jm = jn.fake_kolkata_v2()
    jm.trajectories = traj
    return jm, noise_model_from_other(jm)


@pytest.mark.parametrize("kw,match", [
    (dict(noise=object()), "noise"),
    (dict(dtype=torch.bfloat16), "bf16"),
    (dict(mesh="one"), "mesh"),
    (dict(sample_pallas=False), "rows without a kernel"),
], ids=["noise", "dtype", "mesh", "sample_pallas"])
def test_sampled_engine_refusals_name_their_roadmap_item(qft9, jax_scan, kw,
                                                         match):
    """Every knob runs and gives the JAX package's result from the same
    arguments: ``mesh`` (a mesh of one in each package: the dp-sharded
    scan on one device, within the kernel-route tolerance), noise through
    ``ops.noise.run_noisy_virtual_circuit(engine="sampled")`` (as in the
    JAX package, ``run_virtual_circuit`` takes no ``noise``), bf16 states
    within the JAX bf16 test's 5e-3 of JAX's bf16, and
    ``sample_pallas=False`` within the kernel-route tolerance."""
    jv, tv = qft9
    if "noise" in kw:
        from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.noise import (  # noqa: E501
            run_noisy_virtual_circuit as j_noisy,
        )
        from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.noise import (  # noqa: E501
            run_noisy_virtual_circuit,
        )

        jm, tm = _kolkata()
        want, _ = j_noisy(jv, jm, shots=40, engine="sampled", seed=1)
        got, _ = run_noisy_virtual_circuit(tv, tm, shots=40, seed=1,
                                           engine="sampled", device="cpu")
        np.testing.assert_allclose(got.values, np.asarray(want.values),
                                   **KNIT_TOL)
        return
    run_kw = dict(shots=300, engine="sampled", seed=3, keep_clbits=[0, 1],
                  project=False)
    if "mesh" in kw:
        jm, tm = _meshes()
        want, _ = j_run(jv, mesh=jm, **run_kw)
        got, _ = t_run(tv, device="cpu", mesh=tm, **run_kw)
        np.testing.assert_allclose(got.values, np.asarray(want.values),
                                   **KNIT_TOL)
        return
    if "dtype" in kw:
        import jax.numpy as jnp

        want, _ = j_run(jv, dtype=jnp.bfloat16, **run_kw)
        got, _ = t_run(tv, device="cpu", **kw, **run_kw)
        assert np.abs(got.values - np.asarray(want.values)).max() < 5e-3
        return
    want, _ = j_run(jv, **run_kw)
    got, _ = t_run(tv, device="cpu", **kw, **run_kw)
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               **KNIT_TOL)


@pytest.mark.parametrize("kw,match", [
    (dict(noise=object()), "noise"),
    (dict(dtype=torch.bfloat16), "bf16"),
    (dict(mesh="one"), "mesh"),
    (dict(pallas_variant=False), "rows without a kernel"),
], ids=["noise", "dtype", "mesh", "pallas_variant"])
def test_sampled_estimators_refuse_unported_knobs(qft9, jax_scan, kw, match):
    """``mesh`` (a mesh of one in each package), noise, bf16 states and
    ``pallas_variant=False`` run in both estimators and give the JAX
    package's estimates from the same seeds."""
    jv, tv = qft9
    zs = [{0}, {1, 2}]
    jkw, tkw, tol = dict(kw), dict(kw), KNIT_TOL
    if "mesh" in kw:
        jkw["mesh"], tkw["mesh"] = _meshes()
    if "noise" in kw:
        jkw["noise"], tkw["noise"] = _kolkata()
        jkw["noise_seed"] = tkw["noise_seed"] = 4
    if "dtype" in kw:
        import jax.numpy as jnp

        jkw["dtype"], tol = jnp.bfloat16, dict(atol=5e-3, rtol=0)
    e0 = jq.sampled_knit(jv, 40, seed=2, keep_clbits=[0, 1], **jkw)
    e1 = tq.sampled_knit(tv, 40, seed=2, keep_clbits=[0, 1], device="cpu",
                         **tkw)
    np.testing.assert_allclose(e1.values, np.asarray(e0.values), **tol)
    z0 = jq.sampled_expectation_z(jv, zs, 40, seed=2, **jkw)
    z1 = tq.sampled_expectation_z(tv, zs, 40, seed=2, device="cpu", **tkw)
    np.testing.assert_allclose(z1, z0, **tol)


@pytest.mark.parametrize("kw,match", [
    (dict(head_labels=4), "head_labels"),
    (dict(sample_method="lhs"), "sample_method"),
    (dict(sample_eps=0.1), "sample_eps"),
    (dict(sample_cv=True), "sample_cv"),
], ids=["head_labels", "sample_method", "sample_eps", "sample_cv"])
def test_sampled_knobs_are_refused_on_the_exact_engine(qft9, kw, match):
    """The argument checks of the JAX ``run_virtual_circuit``: a sampled-
    engine knob on another engine is a ValueError naming the knob."""
    jv, tv = qft9
    with pytest.raises(ValueError, match=match):
        t_run(tv, engine="pallas", device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        j_run(jv, engine="streamed", **kw)


def test_sampled_engine_needs_a_card_by_default(qft9, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tv = qft9
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_run(tv, engine="sampled", shots=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.sampled_expectation_z(tv, [{0}], 10)


def test_wide_fragments_are_refused_by_name(qft9):
    """Past a kernel's gate the scan takes the route without a kernel
    (JAX's XLA builder), and says so: qft-16's 15-qubit fragment in
    ancilla mode simulates 30 qubits, past the variant kernel's 20, while
    the 1-qubit fragment (16 simulated qubits) keeps the kernel.  The
    same circuit in collapse mode runs with ``mesh=`` (refused until the
    sharded engine landed)."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter as TCutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc as t_gen_circ,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.plans import (  # noqa: E501
        load_plan,
    )

    cutter = TCutter(t_gen_circ("qft", 16, 1), maxNPartitions=2,
                     maxNQubitsPerPartition=15, gammaMode=True)
    cutter.use_plan(load_plan("qft16_prepped_p2_q15_gamma"))
    tv = TVirtualCircuit(cutter.getResultCircs()[3])
    assert tq._collapse_flags(tv, "auto") == [True, True]
    sims = [tv.programs[r.name].num_sim_qubits for r in tv.fragments]
    ent = tq._build_scan(tv, [False, False], None, None,
                         torch.device("cpu"))
    assert ent["routes"] == ["ancilla, no kernel" if n > 20
                             else "variant kernel" for n in sims]
    assert sorted(sims) == [16, 30]
    # the mesh of one scans every block on its one rank: the estimate
    # equals the unsharded one (which the tests above hold to JAX)
    _, mesh = _meshes()
    np.testing.assert_array_equal(
        tq.sampled_knit(tv, 10, keep_clbits=[0, 1], mesh=mesh,
                        device="cpu").values,
        tq.sampled_knit(tv, 10, keep_clbits=[0, 1], device="cpu").values)
