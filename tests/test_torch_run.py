"""The torch port end to end on the CPU against the JAX package's
``engine="pallas"`` (its kernel in interpret mode where a fragment fits
it), and the uncut oracles against each other: through the variant
kernel's route, and with every fragment forced through the segmented
blocked kernel's route (unfolded rows, folded in torch).  Distributions
within 1e-6 (f32 sums in another order), fidelity > 1 - 1e-6."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.evaluate import (  # noqa: E501
    hellinger_fidelity as j_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
    simulate_circuit as j_simulate,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.streamed import (  # noqa: E501
    streamed_expectation_z as j_expectation_z,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.solver import (  # noqa: E501
    plan_signature as j_plan_signature,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.run import (
    run_virtual_circuit as j_run,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_to_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
    Cutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.solver import (  # noqa: E501
    plan_signature,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    compare_original_with_cut,
    hellinger_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
    genCirc,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    blocked_kernel as bk,
    variant_kernel as vk,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    Distribution,
    simulate_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
    make_streamed_knit,
    streamed_expectation_z,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.plans import (  # noqa: E501
    load_plan,
    stored_plans,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit,
)
from torch_port_common import cut_pair

CONFIGS = {
    # (genCirc name, n, depth, partition cap, seed, Cutter limits, chunk)
    "ghz10_p2q5": ("ghz", 10, 1, 5, None,
                   dict(maxNQpdCuts=2, maxNCuts=2), 12),
    "sup12_p2q7": ("sup", 12, 1, 7, 1,
                   dict(maxNQpdCuts=3, maxNCuts=3, maxCutsPerPartitions=3),
                   72),
}


def _pair(key):
    name, n, depth, cap, seed, kw, chunk = CONFIGS[key]
    return cut_pair(name, n, depth, cap, seed=seed, **kw) + (chunk,)


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_run_matches_jax_engine_pallas(key):
    jc, tc, jv, tv, chunk = _pair(key)
    want, _ = j_run(jv, engine="pallas", chunk_size=chunk)
    got, info = run_virtual_circuit(tv, engine="pallas", chunk_size=chunk,
                                    device="cpu")
    assert got.bit_positions == want.bit_positions
    np.testing.assert_allclose(got.values, want.values, atol=1e-6)
    assert info.run_time > 0 and info.knit_time == 0.0
    assert hellinger_fidelity(simulate_circuit(tc, device="cpu"), got) \
        > 1 - 1e-6
    assert j_fidelity(j_simulate(jc), got.to_dict()) > 1 - 1e-6


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_simulate_circuit_matches_jax(key):
    jc, tc, _, _, _ = _pair(key)
    want = j_simulate(jc)
    got = simulate_circuit(tc, device="cpu")
    assert got.bit_positions == want.bit_positions
    assert got.num_clbits == want.num_clbits
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               atol=1e-6)


def test_marginal_knit_matches_jax():
    jc, tc, jv, tv, chunk = _pair("sup12_p2q7")
    keep = [0, 3, 5, 10]
    want, _ = j_run(jv, engine="pallas", chunk_size=chunk,
                    keep_clbits=keep, project=False)
    got, _ = run_virtual_circuit(tv, chunk_size=chunk, keep_clbits=keep,
                                 project=False, device="cpu")
    assert got.bit_positions == want.bit_positions == keep
    np.testing.assert_allclose(got.values, want.values, atol=1e-6)


def test_z_contraction_matches_jax():
    """z mode of the in-kernel fold: every data bit contracted, the carry
    a scalar (the JAX streamed_expectation_z with pallas_variant)."""
    jc, tc, jv, tv, chunk = _pair("sup12_p2q7")
    zc = [1, 4, 9]
    want = j_expectation_z(jv, zc, chunk=chunk, pallas_variant=True)
    step, xs, _ = make_streamed_knit(tv, chunk, z_clbits=frozenset(zc),
                                     device="cpu", pallas_variant=True)
    assert abs(float(step(xs).reshape(())) - want) < 1e-6


@pytest.fixture
def narrow_variant_gate(monkeypatch):
    """The variant kernel's width gate lowered to 6 qubits, so the test
    circuits' 8..9-qubit fragments take the unforced blocked route."""
    monkeypatch.setattr(vk, "MAX_QUBITS", 6)
    monkeypatch.setattr(bk, "MAX_QUBITS", 6)


@pytest.mark.parametrize("keep", [None, [0, 3, 5, 10]])
@pytest.mark.parametrize("window", [4, 6])
def test_forced_blocked_route_matches_jax(window, keep):
    """Every fragment through the blocked kernel's route: the full
    distribution and a marginal against the JAX engine="pallas"."""
    jc, tc, jv, tv, chunk = _pair("sup12_p2q7")
    want, _ = j_run(jv, engine="pallas", chunk_size=chunk, keep_clbits=keep,
                    project=False)
    step, xs, meta = make_streamed_knit(tv, chunk, keep_clbits=keep,
                                        device="cpu", blocked_window=window,
                                        pallas_variant=True)
    assert set(meta["fragment_kernels"].values()) == {"blocked"}
    assert all(meta["pallas_fragments"].values())
    assert all(len(dp.plan.segments) >= 2
               for dp in meta["fragment_plans"].values())
    assert meta["positions"] == want.bit_positions
    got = Distribution(step(xs).numpy(), meta["positions"], tv.num_clbits)
    np.testing.assert_allclose(got.values, want.values, atol=1e-6)
    if keep is None:
        assert hellinger_fidelity(simulate_circuit(tc, device="cpu"), got) \
            > 1 - 1e-6
        assert j_fidelity(j_simulate(jc), got.to_dict()) > 1 - 1e-6


def test_width_routing_matches_jax(narrow_variant_gate):
    """Past the variant kernel's gate the entry point routes to the
    blocked kernel by itself and says so."""
    jc, tc, jv, tv, chunk = _pair("sup12_p2q7")
    want, _ = j_run(jv, engine="pallas", chunk_size=chunk)
    got, _ = run_virtual_circuit(tv, engine="pallas", chunk_size=chunk,
                                 device="cpu")
    np.testing.assert_allclose(got.values, want.values, atol=1e-6)
    _, _, meta = make_streamed_knit(tv, chunk, device="cpu",
                                    pallas_variant=True)
    assert set(meta["fragment_kernels"].values()) == {"blocked"}


def test_past_the_blocked_gate_names_the_sharded_engine(
        narrow_variant_gate, monkeypatch):
    monkeypatch.setattr(bk, "MAX_BLOCKED_QUBITS", 7)
    _, _, _, tv, chunk = _pair("sup12_p2q7")
    with pytest.raises(NotImplementedError, match="sharded"):
        run_virtual_circuit(tv, chunk_size=chunk, device="cpu")


@pytest.mark.parametrize("route", ["variant", "blocked"])
def test_streamed_expectation_z_matches_jax(route, request):
    if route == "blocked":
        request.getfixturevalue("narrow_variant_gate")
    jc, tc, jv, tv, chunk = _pair("sup12_p2q7")
    zc = [1, 4, 9]
    want = j_expectation_z(jv, zc, chunk=chunk, pallas_variant=True)
    got = streamed_expectation_z(tv, zc, chunk=chunk, device="cpu",
                                 pallas_variant=True)
    assert abs(got - want) < 1e-6
    # and equal to the observable of the knitted distribution
    dist, _ = run_virtual_circuit(tv, chunk_size=chunk, project=False,
                                  device="cpu")
    sign = np.ones(len(dist.values))
    for c in zc:
        j = dist.bit_positions.index(c)
        sign *= 1 - 2 * ((np.arange(len(sign)) >> j) & 1)
    assert abs(got - float(np.sum(dist.values * sign))) < 1e-6


def test_streamed_expectation_z_rejects_unmeasured_support():
    """ghz's measure_all writes the SECOND clbit register: a support bit
    in the first is never measured (the JAX ValueError)."""
    jc, tc, jv, tv, chunk = _pair("ghz10_p2q5")
    with pytest.raises(ValueError, match="never measured"):
        j_expectation_z(jv, [0, 11], chunk=chunk)
    with pytest.raises(ValueError, match="never measured"):
        streamed_expectation_z(tv, [0, 11], chunk=chunk, device="cpu")
    assert abs(streamed_expectation_z(tv, [10, 19], chunk=chunk,
                                      device="cpu") - 1.0) < 1e-6


@pytest.mark.parametrize("kw", [
    dict(noise="fake_kolkata_v2"), dict(trajectories=4),
    dict(share_prefix=True), dict(dtype=torch.bfloat16),
])
def test_streamed_expectation_z_refusals(kw):
    """Trajectory noise runs since the noise slice landed: the JAX
    package's model carried across, the same seed, within 1e-6 of JAX
    (``trajectories`` overrides the model's; without a model it changes
    nothing).  The scan without a kernel's banks and bf16 states run
    since the streamed engine landed: banks as JAX within 1e-6, bf16
    within 5e-3 of f32."""
    jc, tc, jv, tv, chunk = _pair("sup12_p2q7")
    zc = [1, 4, 9]
    if "noise" in kw or "trajectories" in kw:
        from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.noise import (  # noqa: E501
            fake_kolkata_v2,
        )
        from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
            noise_model_from_other,
        )

        jm = fake_kolkata_v2()
        jkw = dict(noise=jm, trajectories=kw.get("trajectories", 2),
                   seed=5)
        want = j_expectation_z(jv, zc, chunk=chunk, **jkw)
        got = streamed_expectation_z(
            tv, zc, chunk=chunk, device="cpu",
            **dict(jkw, noise=noise_model_from_other(jm)))
        assert abs(got - want) < 1e-6
        return
    want = j_expectation_z(jv, zc, chunk=chunk, share_prefix=True)
    got = streamed_expectation_z(tv, zc, chunk=chunk, device="cpu", **kw)
    assert abs(got - want) < (1e-6 if "share_prefix" in kw else 5e-3)


@pytest.mark.parametrize("name,n,depth", [("hwe", 16, 3), ("hwe", 40, 2),
                                          ("syc", 12, 2), ("syc", 36, 1)])
def test_gen_circ_matches_jax(name, n, depth):
    """The copied generators give the JAX circuits instruction for
    instruction under the same seed."""
    want = circuit_to_instructions(j_gen_circ(name, n, depth, seed=0))
    got = circuit_to_instructions(genCirc(name, n, depth, seed=0))
    assert got[:3] == want[:3]
    assert len(got[3]) == len(want[3])
    for a, b in zip(got[3], want[3]):
        assert a == b


def test_stored_hwe40_plan_is_the_jax_cutters_plan():
    """The plan stored in the package (solved once by the port's solver)
    equals what the JAX cutter returns for the same circuit, and cuts
    hwe-40 into two 22-qubit fragments over 36 labels."""
    assert "hwe40_d2_p2_q21" in stored_plans()
    plan = load_plan("hwe40_d2_p2_q21")
    kw = dict(maxNPartitions=2, maxNQubitsPerPartition=21, maxNQpdCuts=5,
              maxNCuts=5, maxCutsPerPartitions=5)
    jcut = JCutter(j_gen_circ("hwe", 40, 2, seed=0), **kw)
    assert jcut.solve()
    assert plan_signature(plan) == j_plan_signature(jcut.plan)
    cutter = Cutter(genCirc("hwe", 40, 2, seed=0), **kw)
    cutter.use_plan(plan)
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
        VirtualCircuit,
    )

    virt = VirtualCircuit(cutter.getResultCircs()[3])
    assert [virt.programs[r.name].num_sim_qubits
            for r in virt.fragments] == [22, 22]
    assert [vg.spec.num_instantiations for vg in virt.vgates] == [6, 6]
    with pytest.raises(FileNotFoundError, match="stored"):
        load_plan("no_such_plan")


def test_saved_plan_round_trips_through_use_plan(tmp_path):
    """A plan made by the port's own solver, saved and adopted by a fresh
    cutter, cuts the circuit the same way."""
    circ = genCirc("hwe", 12, 2, seed=0)
    kw = dict(maxNPartitions=2, maxNQubitsPerPartition=7, maxNQpdCuts=3,
              maxNCuts=3, maxCutsPerPartitions=3)
    first = Cutter(circ, **kw)
    assert first.solve()
    first.save_plan(tmp_path / "plan.json")
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.plan import (  # noqa: E501
        CutPlan,
    )

    second = Cutter(circ, **kw)
    second.use_plan(CutPlan.load(tmp_path / "plan.json"))
    assert plan_signature(second.plan) == plan_signature(first.plan)
    assert (circuit_to_instructions(second.getResultCircs()[3])
            == circuit_to_instructions(first.getResultCircs()[3]))
    assert (second.nWireCuts, second.nGateCuts) == (first.nWireCuts,
                                                    first.nGateCuts)


def test_compare_original_with_cut():
    jc, tc, jv, tv, chunk = _pair("ghz10_p2q5")
    res = compare_original_with_cut(tc, tv._circuit, chunk_size=chunk,
                                    device="cpu")
    assert res.cut_vs_uncut_fidelity > 1 - 1e-6
    assert res.input_fidelity == pytest.approx(1.0)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device=`` every entry point asks for CUDA, and raises when
    there is none instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc, _, tv, chunk = _pair("ghz10_p2q5")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_virtual_circuit(tv, chunk_size=chunk)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_circuit(tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_streamed_knit(tv, chunk)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streamed_expectation_z(tv, [10], chunk=chunk)


@pytest.mark.parametrize("engine,kw", [
    pytest.param(e, {}, id=e) for e in ("streamed", "sharded")
] + [
    # rows without a kernel (the JAX default) since they were ported
    pytest.param("sampled", dict(sample_pallas=False), id="sampled"),
])
def test_unported_engines_name_their_roadmap_item(engine, kw):
    """Every engine of the JAX package is ported and gives the JAX
    engine's result: "streamed", "sharded" (on one device: each
    fragment's mesh is (1, 1)) and "sampled" with
    ``sample_pallas=False`` (the same labels: agreement to the JAX
    kernel-route tolerance)."""
    _, _, jv, tv, chunk = _pair("ghz10_p2q5")
    if engine == "sampled":
        want, _ = j_run(jv, engine=engine, shots=400, seed=2, **kw)
        got, _ = run_virtual_circuit(tv, engine=engine, shots=400, seed=2,
                                     device="cpu", **kw)
        assert got.bit_positions == want.bit_positions
        np.testing.assert_allclose(got.values, np.asarray(want.values),
                                   atol=5e-5, rtol=1e-3)
        return
    want, _ = j_run(jv, engine=engine, chunk_size=chunk)
    got, _ = run_virtual_circuit(tv, engine=engine, chunk_size=chunk,
                                 device="cpu")
    assert got.bit_positions == want.bit_positions
    np.testing.assert_allclose(got.values, want.values, atol=1e-6)


_JAX_KEYWORDS = {
    # name: (JAX default, a value other than the default)
    "tracer": (None, "a Tracer"),
    "checkpoint_dir": (None, "ckpt"),
    "max_local_qubits": (None, 4),
    "trunc_eps": (0.0, 0.01),
    "teleport": ("qpd", "execute"),
}


# the case "refused" keeps the name it had while the port refused these
# values; each now runs its keyword's other value as a ported case
@pytest.mark.parametrize("name,case", [
    (name, case) for name in sorted(_JAX_KEYWORDS)
    for case in ("default", "refused")
] + [("teleport", "unknown")])
def test_jax_keywords_default_or_refused(name, case, tmp_path):
    """The JAX keywords of ``run_virtual_circuit``: each at its JAX
    default gives JAX's result, and every other value is ported; an
    unknown teleport mode raises ValueError (as in the JAX package).
    Ported since the streamed engine landed: ``checkpoint_dir`` (the
    default engine's carry checkpoint gives JAX's result) and
    ``trunc_eps``, which ``engine="pallas"`` refuses with JAX's
    ValueError; since the sharded engine landed, ``max_local_qubits``
    (``engine="sharded"`` as JAX's); since teleport execution landed,
    ``teleport="execute"``; since the tracer landed, ``tracer`` (JAX's
    phases with JAX's meta, JAX's result)."""
    jc, tc, jv, tv, chunk = _pair("ghz10_p2q5")
    default, other = _JAX_KEYWORDS[name]
    if case == "unknown":
        with pytest.raises(ValueError, match="unknown teleport mode"):
            run_virtual_circuit(tv, device="cpu", teleport="wire")
        return
    if case == "refused" and name == "trunc_eps":
        for run, kw in ((j_run, {}), (run_virtual_circuit,
                                      dict(device="cpu"))):
            with pytest.raises(ValueError, match="not engine='pallas'"):
                run(jv if run is j_run else tv, engine="pallas",
                    chunk_size=chunk, trunc_eps=other, **kw)
        return
    if case == "refused" and name == "max_local_qubits":
        # read by engine="sharded": one device gives each fragment the
        # mesh (1, 1) whatever the cap, as in the JAX package
        want, _ = j_run(jv, engine="sharded", max_local_qubits=other)
        got, _ = run_virtual_circuit(tv, engine="sharded", device="cpu",
                                     max_local_qubits=other)
        np.testing.assert_allclose(got.values, want.values, atol=1e-6)
        return
    if case == "refused" and name == "checkpoint_dir":
        want, _ = j_run(jv, engine="pallas", chunk_size=chunk,
                        checkpoint_dir=tmp_path / "jax")
        got, _ = run_virtual_circuit(tv, engine="pallas", chunk_size=chunk,
                                     device="cpu",
                                     checkpoint_dir=tmp_path / "port")
        assert (tmp_path / "port" / "stream_carry.npz").exists()
        np.testing.assert_allclose(got.values, want.values, atol=1e-6)
        return
    if case == "refused" and name == "teleport":
        want, _ = j_run(jv, engine="pallas", chunk_size=chunk,
                        teleport=other)
        got, _ = run_virtual_circuit(tv, engine="pallas", chunk_size=chunk,
                                     device="cpu", teleport=other)
        assert got.bit_positions == want.bit_positions
        np.testing.assert_allclose(got.values, want.values, atol=1e-6)
        return
    if case == "refused" and name == "tracer":
        from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.utils.profiling import (  # noqa: E501
            Tracer as JTracer,
        )
        from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.utils.profiling import (  # noqa: E501
            Tracer,
        )

        jt, tt = JTracer(), Tracer()
        want, _ = j_run(jv, engine="pallas", chunk_size=chunk, tracer=jt)
        got, _ = run_virtual_circuit(tv, engine="pallas", chunk_size=chunk,
                                     device="cpu", tracer=tt)
        assert [(p.name, p.meta) for p in tt.phases] == \
            [(p.name, p.meta) for p in jt.phases] != []
        np.testing.assert_allclose(got.values, want.values, atol=1e-6)
        return
    want, _ = j_run(jv, engine="pallas", chunk_size=chunk,
                    **{name: default})
    got, _ = run_virtual_circuit(tv, engine="pallas", chunk_size=chunk,
                                 device="cpu", **{name: default})
    assert got.bit_positions == want.bit_positions
    np.testing.assert_allclose(got.values, want.values, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(shots=100), dict(noise="fake_kolkata_v2"), dict(trunc_eps=0.01),
    dict(share_prefix=True), dict(dtype=torch.bfloat16),
])
def test_streamed_refusals(kw):
    """``run_virtual_circuit_streamed``: noise (the JAX package's model
    carried across, 4 trajectories, the same seed) as JAX within 1e-6
    since the noise slice landed; shots, truncation, banks and bf16 run
    since the scan without a kernel landed: truncation and banks as JAX
    within 1e-6, bf16 within 5e-3 of f32, shots on the GHZ support
    summing to 1."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.streamed import (  # noqa: E501
        run_virtual_circuit_streamed as j_streamed,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
        run_virtual_circuit_streamed,
    )

    _, _, jv, tv, chunk = _pair("ghz10_p2q5")
    if "noise" in kw:
        from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.noise import (  # noqa: E501
            fake_kolkata_v2,
        )
        from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
            noise_model_from_other,
        )

        jm = fake_kolkata_v2()
        want = j_streamed(jv, chunk, noise=jm, trajectories=4, seed=3,
                          project=True)
        got = run_virtual_circuit_streamed(
            tv, chunk, noise=noise_model_from_other(jm), trajectories=4,
            seed=3, project=True, device="cpu")
        assert got.bit_positions == want.bit_positions
        np.testing.assert_allclose(got.values, want.values, atol=1e-6)
        return
    got = run_virtual_circuit_streamed(tv, chunk, device="cpu", **kw)
    if "shots" in kw:
        assert abs(float(got.values.sum()) - 1.0) < 1e-6
        assert set(np.nonzero(got.values)[0]) <= {0, len(got.values) - 1}
        return
    want = j_streamed(jv, chunk, **{k: v for k, v in kw.items()
                                    if k != "dtype"})
    np.testing.assert_allclose(got.values, want.values,
                               atol=5e-3 if "dtype" in kw else 1e-6)


def test_chip_smoke_refuses_without_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where there
    is no card, and where it stands alone without the package."""
    import pathlib
    import shutil

    root = pathlib.Path(__file__).resolve().parent.parent
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(root / "chip_smoke.py", alone)
    for script in (root / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
