"""The sampled engine as the benchmark serves it, on the CPU (kernel 3's
plain version): a 10-qubit QFT on a phase input, cut 9|1 in gamma mode
(the smallest such cut whose fragments both collapse, as qft-16's do),
through ``portbench``'s ``sampled`` entry and held to the plain
reference by the ``sampled_z`` comparison, its probed trajectory rows
to their complex128 replay; ``RunTimeInfo.stderr`` against
``sampled_knit``'s own; the reference's QFT against the DFT; the sampled
path's spans and kernel 3's row counter."""
import math
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.cell import ROOT, Port, named_module  # noqa: E402

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E402,E501
    collapse_kernel,
    qpd_sampling,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.utils import (  # noqa: E402,E501
    profiling,
)

N = 10
KEEP = [0, 1, 2, 3]
SHOTS = 8000
CUTTER = {"maxNPartitions": 2, "maxNQubitsPerPartition": N - 1,
          "gammaMode": True}
RUN = {"engine": "sampled", "shots": SHOTS, "sample_method": "lhs",
       "sample_cv": True, "project": False, "sample_probe": 16}
# above the largest standard error that 8000 samples buy on the
# instances below (1.42e-2 on seed 11, 1.97e-2 on seed 12), below what
# half of them buy on seed 12 (2.82e-2)
STDERR_CAP = 2.2e-2
# the probed rows' distance from their replay: 7.6e-7 (seed 11) on the
# float32 route, 1.6e-2 and more on the bf16 one
REPLAY_TOL = 1e-4
LIMIT = 5.0


def _module(kind, name):
    return named_module(ROOT, kind, name)


@pytest.fixture(scope="module")
def port():
    return Port()


@pytest.fixture(scope="module")
def cell(port):
    """A configuration of the tiny deployment, its plan solved once on
    one instance and adopted by every request, as the cell's is."""
    inst = _module("circuits", "qft").generate(N, 1, 0)
    cutter = port.Cutter(port.circuit(inst), **CUTTER)
    assert cutter.solve()
    config = {"cutter": CUTTER, "keep_clbits": KEEP,
              "stderr_cap": STDERR_CAP, "replay_tol": REPLAY_TOL,
              "limit": LIMIT}
    return SimpleNamespace(config=config, plan_text=cutter.plan.to_json())


def _instance(seed):
    return _module("circuits", "qft").generate(N, 1, seed)


def _serve(port, cell, seed, entry=None, **run):
    """One request of instance ``seed``: (answer, its virtual circuit)."""
    entry = entry or _module("entries", "sampled")
    virt = port.front_end(cell, _instance(seed))
    return entry.answer(port, cell, virt, "cpu", dict(RUN, **run)), virt


@pytest.fixture(scope="module")
def served(port, cell):
    entry = _module("entries", "sampled")
    return {s: _serve(port, cell, s, entry)[0] for s in (11, 12)}


def _reading(cell, seed, answer):
    return _module("reference", "sampled_z").compare(
        cell, _instance(seed), answer, "cpu")


def _terms(cell, seed, answer):
    return _module("reference", "sampled_z").terms(
        cell, _instance(seed), answer, "cpu")


def test_the_plan_cuts_n_minus_one_and_one_in_gamma_mode(port, cell):
    virt = port.front_end(cell, _instance(3))
    assert len(virt.vgates) == N - 1
    assert sorted(virt.programs[r.name].num_data_qubits
                  for r in virt.fragments) == [1, N - 1]
    assert qpd_sampling._collapse_flags(virt, "auto") == [True, True]


def test_sampled_answer_lies_within_its_error_bars(cell, served):
    for seed, answer in served.items():
        assert answer["bit_positions"] == KEEP
        assert answer["stderr"].shape == (1 << len(KEEP),)
        assert 0 < answer["stderr"].max() <= STDERR_CAP
        assert _reading(cell, seed, answer) <= LIMIT


def test_requests_draw_their_own_labels(port, cell, served):
    assert served[11]["seed"] != served[12]["seed"]
    # the same instance again draws new labels; a fresh process draws
    # the same sequence again
    entry = _module("entries", "sampled")
    virt = port.front_end(cell, _instance(11))
    seeds = [entry.sampling_seed(virt) for _ in range(3)]
    assert seeds[0] == served[11]["seed"] and len(set(seeds)) == 3
    again = _module("entries", "sampled")
    assert [again.sampling_seed(virt) for _ in range(3)] == seeds
    assert all(0 <= s < 2**31 for s in seeds)


def test_probed_rows_equal_their_replay(cell, served):
    replay = _module("reference", "cp_trajectories")
    for seed, answer in served.items():
        probe = answer["probe"]
        assert len(probe["index"]) == 16 and len(set(probe["index"])) == 16
        # the probe reaches measuring variants and both fragments
        assert np.isin(probe["labels"], [2, 3, 4, 5]).any()
        assert len(probe["fragments"]) == 2
        err, compared = replay.replay_error(_instance(seed), probe)
        assert compared == 16
        assert err < 1e-5
        assert _terms(cell, seed, answer)["replay"] < 1


def test_sampled_z_refuses_the_bf16_route(port, cell):
    """The route one precision below: its estimate lies within its error
    bars, its rows do not lie within the replay's tolerance."""
    answer, _ = _serve(port, cell, 11, dtype=torch.bfloat16)
    terms = _terms(cell, 11, answer)
    assert terms["z"] <= LIMIT and terms["cap"] <= LIMIT
    assert terms["replay"] > LIMIT


def test_sampled_z_refuses_half_the_budget(port, cell):
    answer, _ = _serve(port, cell, 12, shots=SHOTS // 2)
    terms = _terms(cell, 12, answer)
    assert terms["cap"] > LIMIT


def test_sampled_z_refuses_half_the_rows(port, cell, monkeypatch):
    """Kernel 3's rows of the second half of each block left out and the
    first half doubled (the mean over the half kept)."""
    real = collapse_kernel.collapse_rows

    def half(dp, entries, cscal):
        rows, bits = real(dp, entries, cscal)
        rows, keep = rows.clone(), rows.shape[0] // 2
        rows[keep:] = 0
        rows[:keep] *= 2
        return rows, bits
    half.rows = half.launches = 0
    monkeypatch.setattr(collapse_kernel, "collapse_rows", half)
    answer, _ = _serve(port, cell, 11)
    assert _terms(cell, 11, answer)["replay"] > LIMIT


def test_probe_leaves_the_estimate_unchanged(port, cell):
    virt = port.front_end(cell, _instance(5))
    kw = dict(shots=4000, engine="sampled", seed=9, sample_method="lhs",
              sample_cv=True, keep_clbits=KEEP, project=False, device="cpu")
    dist, info = port.run_virtual_circuit(virt, sample_probe=5, **kw)
    plain, plain_info = port.run_virtual_circuit(virt, **kw)
    np.testing.assert_array_equal(np.asarray(dist.values),
                                  np.asarray(plain.values))
    np.testing.assert_array_equal(info.stderr, plain_info.stderr)
    assert plain_info.probe is None
    assert info.probe["labels"].shape == (5, len(virt.vgates))
    for f in info.probe["fragments"]:
        assert f["rows"].shape == (5, 1 << len(f["positions"]))
        assert f["draws"].shape[0] == 5


@pytest.mark.parametrize("kw", [{"engine": "pallas"},
                                {"engine": "sampled", "sample_eps": 0.05}])
def test_sample_probe_is_refused(port, cell, kw):
    virt = port.front_end(cell, _instance(5))
    with pytest.raises(ValueError, match="sample_probe"):
        port.run_virtual_circuit(virt, sample_probe=4, device="cpu", **kw)


def test_the_replay_knows_its_decomposition():
    """Each cp's variants, weighted by their coefficients and summed
    over the measured branch, give the channel of cp itself."""
    replay = _module("reference", "cp_trajectories")
    sv = _module("reference", "statevector")
    theta = 0.7
    ops, measures, coef, _ = replay.variants(theta)
    cp = np.diag([1, 1, 1, np.exp(1j * theta)])
    rng = np.random.default_rng(0)
    rho = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    rho = rho @ rho.conj().T
    want = cp @ rho @ cp.conj().T
    got = np.zeros((4, 4), complex)
    proj = [np.diag([1.0, 0.0]), np.diag([0.0, 1.0])]
    frame_b = sv.gate_matrix("rz", (theta / 2,))
    for v in range(6):
        for b in range(2):
            pa = ops[v, 0] if not measures[v, 0] else proj[b] @ ops[v, 0]
            pb = ops[v, 1] if not measures[v, 1] else proj[b] @ ops[v, 1]
            if not measures[v].any() and b:
                continue
            k = np.kron(pa, frame_b @ pb)
            got += coef[v, b] * (k @ rho @ k.conj().T)
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("fault", ["inflated", "stale"])
def test_sampled_z_refuses_a_bad_answer(cell, served, fault):
    good = served[11]
    if fault == "inflated":
        bad = dict(good, stderr=4 * good["stderr"])
        assert _reading(cell, 11, bad) > LIMIT
    else:
        # another instance's answer, as a step that returns it unchanged
        assert _reading(cell, 11, served[12]) > LIMIT


def test_sampled_z_refuses_a_wrong_shape(cell, served):
    answer = dict(served[11], bit_positions=[0, 1, 2, 4])
    assert math.isinf(_reading(cell, 11, answer))
    answer = dict(served[11], stderr=served[11]["stderr"][:-1])
    assert math.isinf(_reading(cell, 11, answer))


def test_the_entry_needs_the_standard_error(port, cell):
    class NoStderr:
        def __getattr__(self, name):
            return getattr(port, name)

        def run_virtual_circuit(self, *a, **kw):
            dist, _ = port.run_virtual_circuit(*a, **kw)
            return dist, SimpleNamespace(run_time=0.0, knit_time=0.0)

    virt = port.front_end(cell, _instance(11))
    with pytest.raises(RuntimeError, match="standard error"):
        _module("entries", "sampled").answer(NoStderr(), cell, virt, "cpu",
                                             dict(RUN))


@pytest.mark.parametrize("cv", [True, False])
def test_runtime_stderr_is_sampled_knits(port, cell, cv):
    virt = port.front_end(cell, _instance(5))
    kw = dict(seed=9, keep_clbits=KEEP, device="cpu")
    dist, info = port.run_virtual_circuit(
        virt, shots=4000, engine="sampled", sample_method="lhs",
        sample_cv=cv, project=False, **kw)
    est, se = qpd_sampling.sampled_knit(
        virt, 4000, method="lhs", control_variate=cv, with_stderr=True, **kw)
    plain = qpd_sampling.sampled_knit(
        virt, 4000, method="lhs", control_variate=cv, **kw)
    # the estimate is unchanged by asking for its error
    np.testing.assert_array_equal(np.asarray(dist.values),
                                  np.asarray(plain.values))
    np.testing.assert_array_equal(np.asarray(est.values),
                                  np.asarray(dist.values))
    if cv:
        assert info.stderr.dtype == se.dtype
        np.testing.assert_array_equal(info.stderr, se)
    else:
        assert info.stderr is None


def test_runtime_stderr_of_an_eps_target(port, cell):
    virt = port.front_end(cell, _instance(5))
    _, info = port.run_virtual_circuit(
        virt, shots=8000, engine="sampled", sample_eps=0.05, seed=2,
        keep_clbits=KEEP, project=False, device="cpu")
    _, se, _ = qpd_sampling.sampled_knit_adaptive(
        virt, 0.05, seed=2, keep_clbits=KEEP, max_samples=8000,
        device="cpu")
    np.testing.assert_array_equal(info.stderr, se)


@pytest.mark.parametrize("engine", ["pallas", "streamed", "xla"])
def test_runtime_stderr_is_none_off_the_sampled_engine(port, engine):
    circ = _module("circuits", "hwea").generate(4, 1, 0)
    cutter = port.Cutter(port.circuit(circ), maxNPartitions=2,
                         maxNQubitsPerPartition=3, maxNQpdCuts=5,
                         maxNCuts=5, maxCutsPerPartitions=5)
    assert cutter.solve()
    virt = port.VirtualCircuit(cutter.getResultCircs()[3])
    _, info = port.run_virtual_circuit(virt, engine=engine, device="cpu")
    assert info.stderr is None


def _dft_column(n, x):
    dim = 1 << n
    y = np.arange(dim)
    return np.exp(2j * np.pi * x * y / dim) / math.sqrt(dim)


@pytest.mark.parametrize("x", range(8))
def test_reference_qft3_is_the_dft(x):
    """The reference's QFT of |x> (no swaps: the output's qubits in
    reverse order) is column x of the DFT matrix."""
    ref = _module("reference", "qft_statevector")
    prep = [("x", (q,), ()) for q in range(3) if (x >> q) & 1]
    gates = prep + _module("circuits", "qft").qft_gates(3)
    state = _module("reference", "statevector").simulate(
        3, ref.rewrite(gates)).numpy()
    # axis q of the state is qubit q; output bit q of y sits on qubit 2-q
    got = np.array([state[(y >> 2) & 1, (y >> 1) & 1, y & 1]
                    for y in range(8)])
    np.testing.assert_allclose(got, _dft_column(3, x), atol=1e-14)


def test_family_equals_the_ports_library_qft():
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.qft import (  # noqa: E501
        library_qft,
    )

    inst = _instance(7)
    rng = np.random.default_rng(7)
    want = []
    for q in range(N):
        want += [("h", (q,), ()), ("rz", (q,), (rng.uniform(0, 2 * np.pi),))]
    want += [(i.name, tuple(i.qubits), tuple(float(p) for p in i.params))
             for i in library_qft(N).instructions]
    assert [(g[0], tuple(g[1]), tuple(g[2])) for g in inst["gates"]] == want


def test_reference_equals_the_ports_simulation(port):
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
        simulate_circuit,
    )

    inst = _instance(4)
    probs, clbits = _module("reference", "qft_statevector").distribution(
        inst)
    dist = simulate_circuit(port.circuit(inst), device="cpu")
    assert list(dist.bit_positions) == clbits
    np.testing.assert_allclose(np.asarray(dist.values, np.float64),
                               probs.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the sampled path's spans and kernel 3's row counter
# ---------------------------------------------------------------------------

SPANS = ("port.sample.labels", "port.sample.build", "port.build.prefix",
         "port.sample.scan", "port.sample.rows", "port.sample.knit",
         "port.sample.cv")


def _port_parent(event):
    p = event.cpu_parent
    while p is not None and not p.name.startswith("port."):
        p = p.cpu_parent
    return None if p is None else p.name


def _estimate(port, cell, **kw):
    virt = port.front_end(cell, _instance(11))
    dist, info = port.run_virtual_circuit(
        virt, shots=4000, engine="sampled", seed=3, sample_method="lhs",
        sample_cv=True, keep_clbits=KEEP, project=False, device="cpu", **kw)
    return virt, dist, info


@pytest.fixture(scope="module")
def traced(port, cell):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        virt, dist, info = _estimate(port, cell)
    events = [e for e in prof.events() if e.name in SPANS]
    return virt, dist, info, events


def test_sampled_spans_nest_and_count(traced):
    virt, _, _, events = traced
    names = [e.name for e in events]
    count = {n: names.count(n) for n in SPANS}
    frags = len(virt.fragments)
    blocks = count["port.sample.knit"]
    assert blocks >= 1
    assert count == {"port.sample.labels": 1, "port.sample.build": 1,
                     "port.build.prefix": frags, "port.sample.scan": 1,
                     "port.sample.rows": blocks * frags,
                     "port.sample.knit": blocks, "port.sample.cv": 1}
    parents = {}
    for e in events:
        parents.setdefault(e.name, set()).add(_port_parent(e))
    assert parents == {
        "port.sample.labels": {None}, "port.sample.build": {None},
        "port.build.prefix": {"port.sample.build"},
        "port.sample.scan": {None}, "port.sample.rows": {"port.sample.scan"},
        "port.sample.knit": {"port.sample.scan"}, "port.sample.cv": {None}}


def test_sampled_spans_are_host_only_events(traced):
    events = traced[-1]
    assert not any(e.is_user_annotation for e in events)
    assert {e.device_type for e in events} == {torch.autograd.DeviceType.CPU}


def test_traced_sampled_answer_equals_untraced(port, cell, traced):
    _, dist, info, _ = traced
    _, plain, plain_info = _estimate(port, cell)
    np.testing.assert_array_equal(np.asarray(plain.values),
                                  np.asarray(dist.values))
    np.testing.assert_array_equal(plain_info.stderr, info.stderr)


def test_sampled_spans_off_build_no_record(port, cell, monkeypatch):
    built = []
    real = profiling._Record
    monkeypatch.setattr(profiling, "_Record",
                        lambda name: (built.append(name), real(name))[1])
    _estimate(port, cell)
    assert built == []


def test_collapse_rows_counts_the_expanded_rows(port, cell):
    virt = port.front_end(cell, _instance(11))
    flags = qpd_sampling._collapse_flags(virt, "auto")
    labels, _ = qpd_sampling._draw(virt, 4000, 3, "lhs", flags, None)
    collapse_kernel.collapse_rows.rows = 0
    port.run_virtual_circuit(
        virt, shots=4000, engine="sampled", seed=3, sample_method="lhs",
        sample_cv=True, keep_clbits=KEEP, project=False, device="cpu")
    assert len(labels) > 0
    assert collapse_kernel.collapse_rows.rows == len(labels) * sum(flags)
