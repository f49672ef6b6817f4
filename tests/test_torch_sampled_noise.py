"""The sampled engine's trajectory noise in the port against the JAX
package's, on the CPU: noisy rows, ``_estimate(noise=...)``,
``sampled_knit`` / ``sampled_expectation_z`` with ``noise`` and
``run_noisy_virtual_circuit(engine="sampled")``, on ghz-6 (two 4-qubit
fragments, one cz cut).  The noise model is built in the JAX package and
carried over with ``convert.noise_model_from_other``; the trajectory
draws are numpy from the same seeds, so estimates agree to float
tolerance.  Also the readout-only full-grid identity, the untranspiled
rule and the argument checks."""
import dataclasses

import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (
    noise as jn,
    qpd_sampling as jq,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    noise_model_from_other,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    knit as tk,
    noise as tn,
    qpd_sampling as tq,
)
from torch_port_common import cut_pair, label_table

KNIT_TOL = dict(atol=5e-5, rtol=1e-3)  # JAX's own, kernel vs XLA route
ROWS_TOL = 1e-6
READOUT_TOL = 3e-5  # test_noisy_sampled_readout_only_full_grid_identity


@pytest.fixture(scope="module")
def ghz6():
    """ghz-6 cut into two fragments of at most 4 qubits: (jax virt, port
    virt)."""
    return cut_pair("ghz", 6, 1, 4)[2:]


@pytest.fixture(scope="module")
def models():
    """fake_kolkata_v2 with 3 trajectories: (jax model, port model)."""
    jm = jn.fake_kolkata_v2()
    jm.trajectories = 3
    return jm, noise_model_from_other(jm)


def test_noisy_label_rows_match_jax(ghz6, models):
    """Every label's trajectory-averaged rows with readout, unfolded, from
    the same ``default_rng(seed)`` draws; the port's blocks see the draws
    made for all labels first, so a one-label block gives the same
    rows."""
    jv, tv = ghz6
    jm, tm = models
    uniq, _ = jq.sample_label_counts(jv, 200, 1)
    for fi, reg in enumerate(tv.fragments):
        want, jpos = jq._simulate_label_rows_noisy(jv, reg.name, uniq, jm,
                                                   seed=9 + fi)
        got, tpos = tq._simulate_label_rows_noisy(tv, reg.name, uniq, tm,
                                                  seed=9 + fi, device="cpu")
        assert tpos == jpos
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ROWS_TOL)
        fn = tq._noisy_row_builder(tv, reg.name, tm, "cpu")[0]
        lab = torch.as_tensor(uniq, dtype=torch.int64)
        draws = fn.prepare(len(uniq), 9 + fi)
        one = torch.cat([fn.rows(lab[i:i + 1], draws[i:i + 1])
                         for i in range(len(uniq))])
        np.testing.assert_allclose(one.numpy(), got.numpy(), atol=ROWS_TOL)


def test_noisy_estimate_matches_jax(ghz6, models):
    """``_estimate`` and ``_estimate_z`` with a noise model a fragment,
    second moment and control-variate moments."""
    jv, tv = ghz6
    jm, tm = models
    uniq, counts = jq.sample_label_counts(jv, 400, 2)
    mass = counts / 400.0
    kw = dict(second_moment=True, control_stats=True, noise_seed=4)
    want = jq._estimate(jv, uniq, mass, keep_clbits=[0, 1, 5],
                        noise=[jm, jm], **kw)
    got = tq._estimate(tv, uniq, mass, keep_clbits=[0, 1, 5],
                       noise=[tm, tm], device="cpu", **kw)
    assert got[0].bit_positions == want[0].bit_positions
    np.testing.assert_allclose(got[0].values, np.asarray(want[0].values),
                               **KNIT_TOL)
    np.testing.assert_allclose(got[1], want[1], **KNIT_TOL)
    for k in ("y_mean", "y2", "xy"):
        np.testing.assert_allclose(got[2][k], want[2][k], **KNIT_TOL)
    zs = [{0}, {0, 5}, set(range(6))]
    zw = jq._estimate_z(jv, uniq, mass, zs, noise=[jm, None], noise_seed=4)
    zg = tq._estimate_z(tv, uniq, mass, zs, noise=[tm, None], noise_seed=4,
                        device="cpu")
    np.testing.assert_allclose(zg, zw, **KNIT_TOL)


def test_sampled_knit_and_z_with_noise_match_jax(ghz6, models):
    """The public estimators with ``noise`` and ``noise_seed``: stderr,
    lhs, control variate; and ``run_noisy_virtual_circuit(engine=
    "sampled")`` (``shots`` = the label budget, projected)."""
    jv, tv = ghz6
    jm, tm = models
    kw = dict(seed=3, method="lhs", noise_seed=6, with_stderr=True,
              control_variate=True)
    e0, s0 = jq.sampled_knit(jv, 500, noise=jm, **kw)
    e1, s1 = tq.sampled_knit(tv, 500, noise=tm, device="cpu", **kw)
    assert e1.bit_positions == e0.bit_positions
    np.testing.assert_allclose(e1.values, np.asarray(e0.values), **KNIT_TOL)
    np.testing.assert_allclose(s1, s0, **KNIT_TOL)
    zs = [{0}, {0, 1}, set(range(6))]
    z0, t0 = jq.sampled_expectation_z(jv, zs, 500, noise=jm, **kw)
    z1, t1 = tq.sampled_expectation_z(tv, zs, 500, noise=tm, device="cpu",
                                      **kw)
    np.testing.assert_allclose(z1, z0, **KNIT_TOL)
    np.testing.assert_allclose(t1, t0, **KNIT_TOL)
    d0, _ = jn.run_noisy_virtual_circuit(jv, jm, shots=300, seed=5,
                                         engine="sampled")
    d1, info = tn.run_noisy_virtual_circuit(tv, tm, shots=300, seed=5,
                                            engine="sampled", device="cpu")
    assert d1.bit_positions == d0.bit_positions and info.run_time > 0
    np.testing.assert_allclose(d1.values, np.asarray(d0.values), **KNIT_TOL)
    # the projection moves no mass: it keeps the estimate's, itself an
    # unbiased estimate of 1 (ROADMAP, section C, "On purpose")
    raw = tq.sampled_knit(tv, 300, seed=5, noise=tm, noise_seed=5,
                          device="cpu")
    assert d1.values.min() >= 0.0
    assert abs(float(d1.values.sum()) - float(raw.values.sum())) < 1e-6


def test_readout_only_full_grid_identity(ghz6):
    """Readout-only noise draws nothing: every label with its exact
    sampling mass through ``_estimate(noise=...)`` equals the unprojected
    knit of ``run_fragment_noisy`` (the JAX package's 3e-5)."""
    _, tv = ghz6
    nm = tn.NoiseModel("ro", p1=0.0, p2=0.0, readout01=0.05,
                       readout10=0.02, trajectories=4)
    vidx, total, _ = label_table(tv, 1)
    mass = np.ones(total)
    for g, vg in enumerate(tv.vgates):
        m = tq._variant_magnitudes(vg.spec)
        mass *= (m / m.sum())[vidx[:total, g]]
    est = tq._estimate(tv, vidx[:total], mass,
                       noise=[nm] * len(tv.fragments), device="cpu")
    results = [tn.run_fragment_noisy(tv, reg.name, nm, seed=0, device="cpu")
               for reg in tv.fragments]
    values, positions = tk.knit_values(tv, results)
    assert est.bit_positions == positions
    np.testing.assert_allclose(est.values, values.numpy(), atol=READOUT_TOL)


def test_untranspiled_model_maps_to_none(ghz6, models):
    """An untranspiled model runs its fragments exact (the reference's
    semantics): ``_noise_models`` maps it to None, and a plan with no
    noisy fragment left is the exact estimate."""
    jv, tv = ghz6
    _, tm = models
    un = dataclasses.replace(tm, untranspiled=True)
    assert tq._noise_models(tv, un) is None
    assert tq._noise_models(tv, [un, tm]) == [None, tm]
    assert jq._noise_models(jv, [dataclasses.replace(models[0],
                                                     untranspiled=True),
                                 models[0]])[0] is None
    assert tq._noise_models(tv, None) is None
    with pytest.raises(ValueError, match="noise models for"):
        tq._noise_models(tv, [tm])
    a = tq.sampled_knit(tv, 200, seed=1, noise=un, device="cpu")
    b = tq.sampled_knit(tv, 200, seed=1, device="cpu")
    np.testing.assert_array_equal(a.values, b.values)


@pytest.mark.parametrize("case", ["bf16", "collapse", "mesh"])
def test_noise_argument_errors_match_jax(ghz6, models, case):
    """Noise with a dtype, with a collapse-mode fragment, or with a mesh
    raises the JAX package's ValueError, in both estimators (before the
    port's own mesh refusal)."""
    import jax.numpy as jnp

    jv, tv = ghz6
    jm, tm = models
    jkw, tkw, match = {
        "bf16": (dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16),
                 "noise and bf16 dtype are exclusive"),
        "collapse": (dict(collapse=True), dict(collapse=True),
                     "collapse mode is exact-path only"),
        "mesh": (dict(mesh=object()), dict(mesh=object()),
                 "mesh .* and noise are exclusive"),
    }[case]
    with pytest.raises(ValueError, match=match):
        jq.sampled_knit(jv, 10, noise=jm, **jkw)
    with pytest.raises(ValueError, match=match):
        tq.sampled_knit(tv, 10, noise=tm, device="cpu", **tkw)
    with pytest.raises(ValueError, match=match):
        tq.sampled_expectation_z(tv, [{0}], 10, noise=tm, device="cpu",
                                 **tkw)


def test_pec_names_the_batched_engine(ghz6):
    _, tv = ghz6
    pec = tn.NoiseModel(name="pec", p1=0.004, p2=0.02, readout01=0.01,
                        readout10=0.02, pec=True, trajectories=2)
    with pytest.raises(ValueError, match="PEC.*batched-engine-only"):
        tq.sampled_knit(tv, 10, noise=pec, device="cpu")
