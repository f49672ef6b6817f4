"""The port's noisy execution on the CPU against the JAX package.

Every noise model is built in the JAX package and carried into the port
with ``convert.noise_model_from_other``, so both packages compute with one
model.  The host half (calibrations, insertion sites, balanced samplers,
routing) agrees bit for bit for the same seed; the device half
(``simulate_noisy_circuit``, ``run_fragment_noisy``,
``run_noisy_virtual_circuit`` batched and streamed, the noisy streamed
observable, the noisy ``compare_original_with_cut``) draws the same
branch indices and agrees within 1e-6 (f32 sums in another order), or
2e-5 where the JAX package's own engine-against-engine test uses it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit import (  # noqa: E501
    routing as jrouting,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.evaluate import (  # noqa: E501
    compare_original_with_cut as j_compare,
    compare_original_with_cut_multiple_backends as j_compare_multi,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (
    noise as jn,
    streamed as js,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
    Distribution as JDistribution,
    compile_circuit as j_compile,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit import (  # noqa: E501
    routing as trouting,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    noise_model_from_other,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    compare_original_with_cut,
    compare_original_with_cut_multiple_backends,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    noise as tn,
    streamed as ts,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    Distribution,
    compile_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit,
)
from torch_port_common import cut_pair, to_port

ATOL = 1e-6
CPU = "cpu"

_CUTS = {}


def _cut(key):
    """(jax circ, port circ, jax virt, port virt) of a small cut, built
    once a process."""
    if key not in _CUTS:
        name, n, depth, cap = {
            "ghz6": ("ghz", 6, 1, 4), "aqft6": ("aqft", 6, 1, 4),
            "sup12": ("sup", 12, 1, 7), "hwe8": ("hwe", 8, 1, 5),
        }[key]
        _CUTS[key] = cut_pair(name, n, depth, cap)
    return _CUTS[key]


def _virts(key):
    """Fresh VirtualCircuits of a cached cut (a run may cache plans on
    one)."""
    jc, tc, jv, tv = _cut(key)
    return jc, tc, JVirtualCircuit(jv._circuit), VirtualCircuit(tv._circuit)


def _model(kind, traj=4):
    """A JAX noise model by name, with ``traj`` trajectories."""
    if kind == "kolkata":
        nm = jn.fake_kolkata_v2()
    elif kind == "kolkata_relax":
        nm = jn.fake_kolkata_v2(relaxation=True)
    elif kind == "untranspiled":
        nm = jn.fake_kolkata_v2()
        nm.untranspiled = True
    elif kind == "pec":
        nm = jn.NoiseModel(name="pec", p1=0.004, p2=0.02, readout01=0.01,
                           readout10=0.02, pec=True)
    elif kind == "generic_relax":
        nm = jn.NoiseModel(p1=0.002, p2=0.01, t1=40e-6, t2=50e-6)
    else:
        raise KeyError(kind)
    nm.trajectories = traj
    return nm


def _close(got, want, atol=ATOL):
    assert list(got.bit_positions) == list(want.bit_positions)
    np.testing.assert_allclose(np.asarray(got.values),
                               np.asarray(want.values), atol=atol)


# ---------------------------------------------------------------------------
# host half: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", [
    "fake_kolkata_v2", "fake_kolkata_v2_relax", "fake_athens",
    "fake_open_pulse3", "default",
])
def test_calibrations_match_bit_for_bit(build):
    jm, tm = {
        "fake_kolkata_v2": (jn.fake_kolkata_v2, tn.fake_kolkata_v2),
        "fake_kolkata_v2_relax": (
            lambda: jn.fake_kolkata_v2(relaxation=True),
            lambda: tn.fake_kolkata_v2(relaxation=True)),
        "fake_athens": (jn.fake_athens, tn.fake_athens),
        "fake_open_pulse3": (lambda: jn.fake_open_pulse(3),
                             lambda: tn.fake_open_pulse(3)),
        "default": (jn.default_noise_model, tn.default_noise_model),
    }[build]
    jm, tm = jm(), tm()
    for other in (jm, noise_model_from_other(jm)):
        for f in dataclasses.fields(tm):
            a, b = getattr(other, f.name), getattr(tm, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            elif f.name == "coupling" and b is not None:
                assert [tuple(e) for e in a] == [tuple(e) for e in b]
            else:
                assert a == b, f.name
    for q in range(jm.num_qubits or 5):
        assert jm.rate_1q(q) == tm.rate_1q(q)
        assert jm.rate_2q(q, (q + 1) % 5) == tm.rate_2q(q, (q + 1) % 5)
        assert np.array_equal(jm.readout_matrix(q), tm.readout_matrix(q))
        assert (jm.relax_gamma_lambda(q, 3e-7)
                == tm.relax_gamma_lambda(q, 3e-7))


def test_site_functions_match_bit_for_bit():
    for p in (0.0, 1e-3, 0.05):
        for a, b in zip(jn._depol_site(p), tn._depol_site(p)):
            assert np.array_equal(a, b)
        if p > 0:
            for a, b in zip(jn.pec_inverse_site(p), tn.pec_inverse_site(p)):
                assert np.array_equal(a, b)
    for g, lam in ((0.01, 0.0), (0.003, 0.02), (0.0, 0.1)):
        for a, b in zip(jn._relax_site(g, lam), tn._relax_site(g, lam)):
            assert np.array_equal(a, b)
    for kind in ("kolkata", "kolkata_relax", "pec", "generic_relax"):
        jm = _model(kind)
        tm = noise_model_from_other(jm)
        for axes, dev in (((0,), (3,)), ((1, 2), (4, 7)), ((2, 0), (9, 8))):
            js_, ts_ = (jn.gate_noise_sites(jm, axes, dev),
                        tn.gate_noise_sites(tm, axes, dev))
            assert len(js_) == len(ts_)
            for a, b in zip(js_, ts_):
                assert a[0] == b[0]
                for x, y in zip(a[1:], b[1:]):
                    assert (x is None and y is None) or np.array_equal(x, y)
    jm = _model("untranspiled")
    tm = noise_model_from_other(jm)
    for name, axes in (("sx", (3,)), ("h", (3,)), ("cx", (0, 1)),
                       ("cx", (0, 5)), ("_defer", (2,)), (None, (1,))):
        assert (jn.untranspiled_site_rate(jm, name, axes)
                == tn.untranspiled_site_rate(tm, name, axes))


@pytest.mark.parametrize("balance", [None, 0, 1])
def test_samplers_match_bit_for_bit(balance):
    probs = [0.91, 0.05, 0.03, 0.01]
    shape = (7, 5)
    for jf, tf, args in (
        (jn._site_idx, tn._site_idx, (probs, shape, balance)),
        (jn._pauli_idx, tn._pauli_idx, (0.07, shape, balance)),
    ):
        a = jf(np.random.default_rng(11), *args)
        b = tf(np.random.default_rng(11), *args)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tabs = [jn._depol_site(0.02), jn._relax_site(0.01, 0.02)]
    for a, b in zip(
        jn._sample_site_blocks(np.random.default_rng(3), tabs, shape,
                               balance),
        tn._sample_site_blocks(np.random.default_rng(3), tabs, shape,
                               balance),
    ):
        assert np.array_equal(a, b)
    idx = [np.random.default_rng(5).integers(0, 4, shape) for _ in range(2)]
    w4 = [None, jn.pec_inverse_site(0.03)[2]]
    assert np.array_equal(jn._traj_weights(w4, idx, shape),
                          tn._traj_weights(w4, idx, shape))
    for count, traj, n_sites in ((6, 4, 3), (5, 2, 0)):
        site_tabs = [jn._depol_site(0.01 * (i + 1)) for i in range(n_sites)]
        assert np.array_equal(
            js._sample_pauli_indices(np.random.default_rng(2), site_tabs,
                                     count, traj),
            ts._sample_pauli_indices(np.random.default_rng(2), site_tabs,
                                     count, traj))


@pytest.mark.parametrize("name,n,d", [
    ("ghz", 8, 1), ("sup", 12, 1), ("hwe", 8, 1), ("hwe", 10, 1),
    ("syc", 12, 2), ("ghz", 24, 1), ("aqft", 6, 2),
])
def test_route_stream_matches_instruction_for_instruction(name, n, d):
    """``route_stream`` on the circuits of tests/test_routing.py (their
    adder aside: the port has no adder generator yet): the same ops,
    device nodes, clbit sources, placement and swap count; the compiled
    op names too."""
    jc = j_gen_circ(name, n, d)
    jcomp, tcomp = j_compile(jc), compile_circuit(to_port(jc))
    assert tcomp.op_names == jcomp.op_names
    a = jrouting.route_stream([("u", u, ax) for u, ax in jcomp.ops], n,
                              dict(jcomp.clbit_sources),
                              jrouting.HEAVY_HEX_27)
    b = trouting.route_stream([("u", u, ax) for u, ax in tcomp.ops], n,
                              dict(tcomp.clbit_sources),
                              trouting.HEAVY_HEX_27)
    assert len(a.ops) == len(b.ops) and a.phys == b.phys
    for x, y in zip(a.ops, b.ops):
        assert x[0] == y[0] and x[2] == y[2]
        assert np.array_equal(np.asarray(x[1]), np.asarray(y[1]))
    assert (a.clbit_sources, a.slot_device, a.num_swaps) == (
        b.clbit_sources, b.slot_device, b.num_swaps)
    assert trouting.HEAVY_HEX_27 == jrouting.HEAVY_HEX_27
    for k in (5, 12, 27):
        assert (trouting.bfs_placement(trouting.HEAVY_HEX_27, k)
                == jrouting.bfs_placement(jrouting.HEAVY_HEX_27, k))
        assert (trouting.snake_placement(trouting.HEAVY_HEX_27, k)
                == jrouting.snake_placement(jrouting.HEAVY_HEX_27, k))


def test_fragment_streams_route_as_jax():
    """A fragment's op stream (slot and ancilla ops pass through)."""
    _, _, jv, tv = _cut("sup12")
    for name in jv.programs:
        jp, tp = jv.programs[name], tv.programs[name]
        a = jrouting.route_stream(jp.ops, jp.num_data_qubits,
                                  jp.clbit_sources, jrouting.HEAVY_HEX_27)
        b = trouting.route_stream(tp.ops, tp.num_data_qubits,
                                  tp.clbit_sources, trouting.HEAVY_HEX_27)
        assert [(o[0], o[2]) for o in a.ops] == [(o[0], o[2]) for o in b.ops]
        assert a.phys == b.phys and a.num_swaps == b.num_swaps
        assert a.clbit_sources == b.clbit_sources


# ---------------------------------------------------------------------------
# device half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,key", [
    ("kolkata", "ghz6"), ("untranspiled", "ghz6"), ("kolkata_relax", "ghz6"),
    ("kolkata", "aqft6"), ("pec", "ghz6"),
])
def test_simulate_noisy_circuit_matches(kind, key):
    """The uncut noisy simulator: routed (calibrated), untranspiled (the
    exact first-order mixture), relaxation, PEC."""
    jc, tc, _, _ = _cut(key)
    jm = _model(kind)
    want = jn.simulate_noisy_circuit(jc, jm, seed=5)
    got = tn.simulate_noisy_circuit(tc, noise_model_from_other(jm), seed=5,
                                    device=CPU)
    _close(got, want)


def test_readout_error_matches_and_shots_are_counts():
    jc, tc, _, _ = _cut("ghz6")
    jm = _model("kolkata")
    tm = noise_model_from_other(jm)
    vals = np.random.default_rng(0).dirichlet(np.ones(8)).astype(np.float32)
    for bq in (None, [4, 0, 9]):
        want = jn.apply_readout_error(JDistribution(vals, [0, 2, 5], 6), jm,
                                      bit_qubits=bq)
        got = tn.apply_readout_error(Distribution(vals, [0, 2, 5], 6), tm,
                                     bit_qubits=bq, device=CPU)
        _close(got, want)
    d = tn.simulate_noisy_circuit(tc, tm, shots=1000, seed=3, device=CPU)
    counts = np.asarray(d.values) * 1000
    assert abs(float(d.values.sum()) - 1.0) < 1e-6
    np.testing.assert_allclose(counts, np.round(counts), atol=1e-3)


@pytest.mark.parametrize("kind,key,engine", [
    ("kolkata", "ghz6", "auto"),
    ("kolkata", "ghz6", "streamed"),
    ("kolkata_relax", "ghz6", "streamed"),
    ("pec", "ghz6", "xla"),
    ("kolkata", "aqft6", "streamed"),
    ("kolkata", "sup12", "auto"),
    ("kolkata", "sup12", "streamed"),
    ("generic_relax", "hwe8", "auto"),
    ("untranspiled", "ghz6", "auto"),
])
def test_run_noisy_virtual_circuit_matches(kind, key, engine):
    """Batched (``run_fragment_noisy`` per fragment, seed + i) and
    streamed, projected: within 1e-6 of the JAX call, same seed."""
    _, _, jv, tv = _virts(key)
    jm = _model(kind, traj=2 if key == "sup12" else 4)
    want, _ = jn.run_noisy_virtual_circuit(
        jv, jm, engine=engine, seed=7, chunk_size=64)
    got, info = tn.run_noisy_virtual_circuit(
        tv, noise_model_from_other(jm), engine=engine, seed=7,
        chunk_size=64, device=CPU)
    _close(got, want)
    assert info.run_time > 0


def test_run_fragment_noisy_rows_match():
    """The batched fragment rows themselves (variants x trajectories,
    weighted, averaged, readout), on both fragments."""
    _, _, jv, tv = _virts("ghz6")
    jm = _model("kolkata_relax")
    tm = noise_model_from_other(jm)
    for i, reg in enumerate(jv.fragments):
        want = jn.run_fragment_noisy(jv, reg.name, jm, seed=i, chunk_size=16)
        got = tn.run_fragment_noisy(tv, reg.name, tm, seed=i, chunk_size=16,
                                    device=CPU)
        assert got.bit_positions == want.bit_positions
        np.testing.assert_allclose(got.values.numpy(), want.values,
                                   atol=ATOL)


def test_per_fragment_models_and_set_backend():
    """A list mapping fragment i -> model (the heterogeneous-backend
    path), and the ``virt.set_backend`` mapping (``noise=None``); a
    fragment without a model runs exact."""
    _, _, jv, tv = _virts("ghz6")
    jms = [jn.fake_athens(), jn.fake_open_pulse(5)]
    for m in jms:
        m.trajectories = 3
    tms = [noise_model_from_other(m) for m in jms]
    want, _ = jn.run_noisy_virtual_circuit(jv, jms, seed=2)
    got, _ = tn.run_noisy_virtual_circuit(tv, tms, seed=2, device=CPU)
    _close(got, want)
    _, _, jv, tv = _virts("ghz6")
    jv.set_backend(jv.fragments[0].name, jms[0])
    tv.set_backend(tv.fragments[0].name, tms[0])
    for engine in ("auto", "streamed"):
        want, _ = jn.run_noisy_virtual_circuit(jv, None, seed=4,
                                               engine=engine)
        got, _ = tn.run_noisy_virtual_circuit(tv, None, seed=4,
                                              engine=engine, device=CPU)
        _close(got, want)


def test_batched_vs_streamed_with_routed_calibrated_model():
    """The JAX package's engine-against-engine test, in the port: with
    gate noise zeroed and calibrated readout kept, the batched and
    streamed routes agree within 2e-5 (trajectory draws differ, the
    routing and readout lookups do not)."""
    _, _, _, tv = _virts("ghz6")
    rng = np.random.default_rng(5)
    nm = tn.NoiseModel(
        name="routed-ro", p1=0.0, p2=0.0, trajectories=1,
        ro01_q=rng.uniform(0.0, 0.2, 27), ro10_q=rng.uniform(0.0, 0.2, 27),
        num_qubits=27, coupling=trouting.HEAVY_HEX_27,
    )
    batched, _ = tn.run_noisy_virtual_circuit(tv, nm, device=CPU)
    streamed, _ = tn.run_noisy_virtual_circuit(tv, nm, engine="streamed",
                                               device=CPU)
    _close(batched, streamed, atol=2e-5)


def test_noisy_streamed_expectation_and_checkpoint_match():
    """Noisy ``streamed_expectation_z`` as JAX's; a checkpointed noisy
    scan (segments of one chunk, noise in the fingerprint) as the whole
    run; the fingerprint equals JAX's and moves with the model."""
    _, _, jv, tv = _virts("sup12")
    jm = _model("kolkata", traj=2)
    tm = noise_model_from_other(jm)
    zc = sorted(c for p in tv.programs.values() for c in p.clbit_sources
                if c < tv.num_clbits)[:3]
    want = js.streamed_expectation_z(jv, zc, chunk=64, noise=jm, seed=9)
    got = ts.streamed_expectation_z(tv, zc, chunk=64, noise=tm, seed=9,
                                    device=CPU)
    assert abs(got - want) < ATOL
    models = [tm] * len(tv.fragments)
    fp = ts._stream_fingerprint(tv, 32, 1, 9, models=models)
    assert fp == js._stream_fingerprint(jv, 32, 1, [jm] * 2, None, 9)
    other = dataclasses.replace(tm, ro01_q=tm.ro01_q * 1.01)
    assert fp != ts._stream_fingerprint(tv, 32, 1, 9, models=[other] * 2)
    assert fp != ts._stream_fingerprint(tv, 32, 1, 9, models=models,
                                        trajectories=3)


def test_noisy_streamed_checkpoint_resumes(tmp_path):
    _, _, _, tv = _virts("ghz6")
    tm = noise_model_from_other(_model("kolkata"))
    whole = ts.run_virtual_circuit_streamed(tv, 8, noise=tm, seed=1,
                                            device=CPU)
    seg = ts.run_virtual_circuit_streamed(
        tv, 8, noise=tm, seed=1, checkpoint_dir=tmp_path, segment_chunks=1,
        device=CPU)
    _close(seg, whole)
    again = ts.run_virtual_circuit_streamed(
        tv, 8, noise=tm, seed=1, checkpoint_dir=tmp_path, segment_chunks=1,
        device=CPU)
    _close(again, whole)


def test_noisy_shots_are_counts():
    """Shots through both routes: the streamed scan's are counts of 1000
    of the projected knit; the batched route samples every variant row
    (the reference's per-instantiation counts), so its projected knit is
    non-negative with a mass near 1."""
    _, _, _, tv = _virts("ghz6")
    tm = noise_model_from_other(_model("kolkata"))
    d, _ = tn.run_noisy_virtual_circuit(tv, tm, shots=1000, seed=7,
                                        engine="streamed", device=CPU)
    assert abs(float(np.sum(d.values)) - 1.0) < 1e-5
    assert np.count_nonzero(d.values) <= 1000
    c = np.asarray(d.values) * 1000
    np.testing.assert_allclose(c, np.round(c), atol=1e-3)
    d, _ = tn.run_noisy_virtual_circuit(tv, tm, shots=1000, seed=7,
                                        device=CPU)
    assert float(np.min(d.values)) >= 0.0
    assert abs(float(np.sum(d.values)) - 1.0) < 0.15


@pytest.mark.parametrize("multi", [False, True])
def test_noisy_compare_original_with_cut_matches(multi):
    """The reference's noisy fidelity experiment, exact legs (no shots):
    the three fidelities as JAX's; with 1000 shots, the bands of the JAX
    package's own untranspiled test."""
    jc, tc, jv, tv = _cut("ghz6")
    if multi:
        jms = [jn.fake_athens(), jn.fake_open_pulse(5)]
        ref = jn.fake_kolkata_v2()
        for m in jms + [ref]:
            m.trajectories = 3
        want = j_compare_multi(jc, jv._circuit, jms, ref, shots=None,
                               seed=2)
        got = compare_original_with_cut_multiple_backends(
            tc, tv._circuit, [noise_model_from_other(m) for m in jms],
            noise_model_from_other(ref), shots=None, seed=2, device=CPU)
    else:
        jm = _model("kolkata")
        want = j_compare(jc, jv._circuit, noise_model=jm, seed=3)
        got = compare_original_with_cut(tc, tv._circuit,
                                        noise_model=noise_model_from_other(jm),
                                        seed=3, device=CPU)
    for f in ("input_fidelity", "cut_fidelity", "cut_vs_uncut_fidelity"):
        assert abs(getattr(got, f) - getattr(want, f)) < ATOL, f
    if not multi:
        nm = noise_model_from_other(_model("untranspiled"))
        res = compare_original_with_cut(tc, tv._circuit, noise_model=nm,
                                        shots=1000, seed=3, device=CPU)
        assert 0.80 < res.input_fidelity < 0.999, res
        assert res.cut_fidelity > 0.95 and res.cut_vs_uncut_fidelity > 0.99


def test_noise_refusals():
    """Noise raises where it has no route: the kernels
    (``engine="pallas"``), bf16, truncation and PEC on the streamed scan;
    ``run_virtual_circuit`` takes no ``noise``.  The sampled engine runs
    it since its noisy rows were ported: the JAX package's default budget
    and result."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
        run_virtual_circuit,
    )

    _, _, jv, tv = _virts("ghz6")
    jm = _model("kolkata")
    tm = noise_model_from_other(jm)
    got, _ = tn.run_noisy_virtual_circuit(tv, tm, engine="sampled",
                                          device=CPU)
    want, _ = jn.run_noisy_virtual_circuit(jv, jm, engine="sampled")
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               atol=5e-5, rtol=1e-3)
    with pytest.raises(ValueError, match="not engine='pallas'"):
        tn.run_noisy_virtual_circuit(tv, tm, engine="pallas", device=CPU)
    for kw, match in ((dict(pallas_variant=True), "kernels are exact"),
                      (dict(dtype=torch.bfloat16), "exact-path only"),
                      (dict(trunc_eps=1e-3), "exact-path only")):
        with pytest.raises(ValueError, match=match):
            ts.make_streamed_knit(tv, 8, noise=tm, device=CPU, **kw)
    pec = noise_model_from_other(_model("pec"))
    with pytest.raises(ValueError, match="PEC"):
        tn.run_noisy_virtual_circuit(tv, pec, engine="streamed", device=CPU)
    with pytest.raises(TypeError):
        run_virtual_circuit(tv, noise=tm, device=CPU)


def test_noisy_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc, _, tv = _virts("ghz6")
    tm = noise_model_from_other(_model("kolkata"))
    for call in (lambda: tn.run_noisy_virtual_circuit(tv, tm),
                 lambda: tn.simulate_noisy_circuit(tc, tm),
                 lambda: ts.streamed_expectation_z(tv, [6], noise=tm)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
