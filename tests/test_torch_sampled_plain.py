"""The sampled engine's rows without a kernel in the port against the JAX
package's, on the CPU: ``make_sim_fn(collapse=True)``, the blocked scan
and the public estimators with ``pallas_variant=False`` (the JAX
default) in collapse mode (qft-9, 8 cp cuts) and ancilla mode (sup-12, 9
simulated qubits a fragment), bf16 states, and the route past a kernel's
width gate.  Same seeds -> same labels and collapse draws -> same branch
picks, so results agree to float tolerance."""
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
    qpd_sampling as jq,
    variant_engine as jve,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    collapse_kernel as tck,
    qpd_sampling as tq,
    variant_engine as tve,
    variant_kernel as tvk,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit as t_run,
)
from torch_port_common import cut_pair, qft_gamma_pair

SCAN_ATOL = 1e-6
KNIT_TOL = dict(atol=5e-5, rtol=1e-3)  # JAX's own, kernel vs XLA route
BF16_TOL = 5e-3  # tests/test_bf16_serving.py's bf16 sampled-engine bound
Z_SETS = [[0], [0, 1, 2], [4]]


@pytest.fixture(scope="module")
def qft9():
    """qft-9 cut 8|1 in gamma mode (8 cp cuts): (jax virt, port virt)."""
    return qft_gamma_pair(9, 8)


@pytest.fixture(scope="module")
def sup12():
    """sup-12 cut into two fragments of 6 data + 3 ancilla qubits."""
    return cut_pair("sup", 12, 1, 7)[2:]


@pytest.fixture
def jax_scan(monkeypatch):
    """The JAX estimators on their blocked, jitted scan at any label
    count (its docstring: the same estimator as the unblocked path, held
    equal by its own tests): a small block budget, so this file compiles
    one scan instead of dispatching every op of the unblocked path."""
    monkeypatch.setattr(jq, "_label_budget", lambda: 1 << 12)


def _sample(virt, n, seed=5):
    uniq, counts = jq.sample_label_counts(virt, n, seed)
    return uniq, counts.astype(np.float64) / n


def test_collapse_sim_fn_matches_jax(qft9):
    """``make_sim_fn(collapse=True)`` on batched states against the JAX
    closure ``vmap``ped, with the same draws, measure flags and weights
    (within 1e-6); its branch picks equal the collapse kernel's plain
    version's on the same labels and draws."""
    import jax
    import jax.numpy as jnp

    jv, tv = qft9
    specs = [vg.spec for vg in tv.vgates]
    rng = np.random.default_rng(0)
    lab = np.stack([rng.integers(0, s.num_instantiations, 64)
                    for s in specs], axis=1)
    for reg in tv.fragments:
        name = reg.name
        sj, _, pj, _ = jve.make_sim_fn(jv, name, build_matrices=False,
                                       collapse=True)
        st, _, pt, _ = tve.make_sim_fn(tv, name, build_matrices=False,
                                       collapse=True)
        assert pt == pj and st.collapse_slots == sj.collapse_slots
        prog = tv.programs[name]
        mats = [tuple(t[lab[:, s.vgate_idx]] for t in tabs) for s, tabs in
                zip(prog.slots, tve._slot_tables(prog, specs))]
        args = {sid: (rng.random(64).astype(np.float32),
                      rng.integers(0, 2, 64).astype(np.float32),
                      rng.normal(size=64).astype(np.float32),
                      rng.normal(size=64).astype(np.float32))
                for sid in st.collapse_slots}
        want = jax.jit(jax.vmap(sj))(
            [tuple(jnp.asarray(x) for x in m) for m in mats],
            {k: tuple(jnp.asarray(x) for x in v) for k, v in args.items()})
        picks = []
        got = st([tuple(torch.as_tensor(x) for x in m) for m in mats],
                 {k: tuple(torch.as_tensor(x) for x in v)
                  for k, v in args.items()}, "cpu", picks)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SCAN_ATOL)
        # the kernel's plain version from the scan's own scalars
        fn, _, ns, _ = tq._collapse_row_builder(tv, name, device="cpu")
        kfn = tq._collapse_row_builder_pallas(tv, name, device="cpu")[0]
        lab_t = torch.as_tensor(lab, dtype=torch.int64)
        u = torch.as_tensor(rng.random((64, ns)).astype(np.float32))
        picks = []
        rows, _ = fn(lab_t, u, picks)
        krows, _ = kfn(lab_t, u)
        bits, margins = tve.picked_bits(picks)
        agree, near, far = tck.compare_picks(
            bits, kfn.rows_fn.last_bits, margins)
        assert bool(agree.all()) and near == far == 0
        np.testing.assert_allclose(rows.numpy(), krows.numpy(),
                                   atol=SCAN_ATOL)


@pytest.mark.parametrize("mode", ["collapse", "ancilla"])
def test_simulate_label_rows_match_jax(qft9, sup12, mode):
    """The whole-label-set row functions without a kernel:
    ``_simulate_label_rows_collapse`` (folded rows from
    ``default_rng(seed)`` draws) and ``_simulate_label_rows`` (unfolded
    rows with deferral ancillas) against the JAX package's, within 1e-6
    (JAX's row builders jitted: the same functions, compiled once)."""
    import jax

    jv, tv = qft9 if mode == "collapse" else sup12
    uniq, _ = _sample(jv, 40)
    for reg in tv.fragments:
        if mode == "collapse":
            fn, wpos, ns, _ = jq._collapse_row_builder(jv, reg.name)
            u = np.random.default_rng(4).random(
                (len(uniq), max(1, ns))).astype(np.float32)
            want = jax.jit(lambda lab, u: fn(lab, u)[0])(uniq, u)
            got, gpos = tq._simulate_label_rows_collapse(
                tv, reg.name, uniq, seed=4, device="cpu")
        else:
            wpos = jve.make_sim_fn(jv, reg.name, build_matrices=False,
                                   fused_slots=True)[2]
            want = jax.jit(lambda lab: jq._simulate_label_rows(
                jv, reg.name, lab)[0])(uniq)
            got, gpos = tq._simulate_label_rows(tv, reg.name, uniq,
                                                device="cpu")
        assert list(gpos) == list(wpos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SCAN_ATOL)


def _same_stats(got, want, atol):
    (g_est, g_m2, g_st), (w_est, w_m2, w_st) = got, want
    g_vals = getattr(g_est, "values", g_est)
    w_vals = getattr(w_est, "values", w_est)
    np.testing.assert_allclose(np.asarray(g_vals), np.asarray(w_vals),
                               atol=atol)
    np.testing.assert_allclose(g_m2, w_m2, atol=atol * 100, rtol=1e-5)
    assert g_st.keys() == w_st.keys()
    for k in g_st:
        np.testing.assert_allclose(g_st[k], w_st[k], atol=atol * 100,
                                   rtol=1e-5)


@pytest.mark.parametrize("mode", ["collapse", "ancilla"])
@pytest.mark.parametrize("out", ["full", "marginal", "z"])
def test_scan_core_without_kernel_matches_jax(qft9, sup12, mode, out):
    """``_scan_core(pallas_variant=False)``: estimate, second moment and
    control-variate moments against JAX's, the same draws; another block
    size gives the same estimate."""
    jv, tv = qft9 if mode == "collapse" else sup12
    uniq, mass = _sample(jv, 600)
    kw = dict(flags=[mode == "collapse"] * 2, collapse_seed=11,
              second_moment=True, control_stats=True, pallas_variant=False,
              **{"full": {}, "marginal": dict(keep_clbits=[0, 1, 2]),
                 "z": dict(z_sets=Z_SETS)}[out])
    want = jq._scan_core(jv, uniq, mass, block=32, **kw)
    got = tq._scan_core(tv, uniq, mass, device="cpu", **kw)
    if out != "z":
        assert got[0].bit_positions == want[0].bit_positions
    _same_stats(got, want, SCAN_ATOL)
    other = tq._scan_core(tv, uniq, mass, block=45, device="cpu", **kw)
    _same_stats(other, got, SCAN_ATOL)
    # the estimators' entry: the same scan, the same result
    est_kw = {k: v for k, v in kw.items() if k not in ("flags", "z_sets")}
    if out == "z":
        via = tq._estimate_z(tv, uniq, mass, Z_SETS, collapse=kw["flags"],
                             device="cpu", **est_kw)
    else:
        via = tq._estimate(tv, uniq, mass, collapse=kw["flags"],
                           device="cpu", **est_kw)
    _same_stats(via, got, 0.0)
    routes = next(iter(tv._scan_step_cache.values()))["routes"]
    assert all("no kernel" in r for r in routes), routes


def test_estimators_without_kernel_match_jax(qft9, jax_scan):
    """``sampled_knit`` and ``sampled_expectation_z`` with
    ``pallas_variant=False``: stderr, lhs and control variate, and the
    stratified head (exact-mass head labels, each measuring one expanded
    to ``collapse_reps`` draws, plus the conditional tail) as in JAX."""
    jv, tv = qft9
    args = dict(seed=2, method="lhs", collapse=True, pallas_variant=False)
    stats = dict(with_stderr=True, control_variate=True)
    e0, s0 = jq.sampled_knit(jv, 300, keep_clbits=[0, 1, 2], **args, **stats)
    e1, s1 = tq.sampled_knit(tv, 300, keep_clbits=[0, 1, 2], device="cpu",
                             **args, **stats)
    assert e1.bit_positions == e0.bit_positions
    np.testing.assert_allclose(e1.values, np.asarray(e0.values), **KNIT_TOL)
    np.testing.assert_allclose(s1, s0, **KNIT_TOL)
    zs = [{0}, {0, 1, 2}, set(range(9))]
    head = dict(head_labels=4, collapse_reps=2)
    z0 = jq.sampled_expectation_z(jv, zs, 300, **args, **head)
    z1 = tq.sampled_expectation_z(tv, zs, 300, device="cpu", **args, **head)
    np.testing.assert_allclose(z1, z0, **KNIT_TOL)


def test_bf16_states_match_jax_and_f32(sup12, jax_scan):
    """bf16 states (rows and knit f32, no kernel: the kernels are f32)
    against JAX's bf16 estimate and the port's own f32, within JAX's
    5e-3; through ``run_virtual_circuit(engine="sampled", dtype=...)``
    with the default ``sample_pallas=True`` the same estimate."""
    import jax.numpy as jnp

    jv, tv = sup12
    kw = dict(seed=7, keep_clbits=[0, 1, 2, 3])
    j16 = jq.sampled_knit(jv, 2000, dtype=jnp.bfloat16, **kw)
    t16 = tq.sampled_knit(tv, 2000, dtype=torch.bfloat16, device="cpu", **kw)
    t32 = tq.sampled_knit(tv, 2000, device="cpu", **kw)
    assert t16.bit_positions == t32.bit_positions == j16.bit_positions
    assert np.abs(t16.values - np.asarray(j16.values)).max() < BF16_TOL
    assert np.abs(t16.values - t32.values).max() < BF16_TOL
    routes = [e["routes"] for k, e in tv._scan_step_cache.items()
              if "torch.bfloat16" in k]
    assert routes == [["ancilla, no kernel"] * 2], routes
    run16, _ = t_run(tv, shots=2000, engine="sampled", dtype=torch.bfloat16,
                     project=False, device="cpu", **kw)
    np.testing.assert_array_equal(run16.values, t16.values)


def test_width_gate_routes_without_a_kernel(qft9, sup12, monkeypatch):
    """With the kernels' width gates lowered below a fragment, the scan
    under ``pallas_variant=True`` takes the route without a kernel for
    that fragment and the kernel for the other: the estimate equals the
    all-kernel one and the one without any kernel."""
    jv, tv = qft9
    uniq, mass = _sample(jv, 300)
    kw = dict(flags=[True, True], collapse_seed=3, keep_clbits=[0, 1],
              device="cpu")
    ref = tq._scan_core(tv, uniq, mass, **kw)
    plain = tq._scan_core(tv, uniq, mass, pallas_variant=False, **kw)
    monkeypatch.setattr(tck, "MAX_QUBITS", 4)  # qft-9's 8 qubits pass it
    tv.__dict__.pop("_scan_step_cache", None)
    got = tq._scan_core(tv, uniq, mass, **kw)
    routes = next(iter(tv._scan_step_cache.values()))["routes"]
    assert routes == ["collapse, no kernel", "collapse kernel"], routes
    np.testing.assert_allclose(got.values, ref.values, atol=SCAN_ATOL)
    np.testing.assert_allclose(got.values, plain.values, atol=SCAN_ATOL)
    # ancilla mode: the variant kernel's gate
    _, sv = sup12
    uniq, mass = _sample(sup12[0], 300)
    ref = tq._scan_core(sv, uniq, mass, device="cpu")
    monkeypatch.setattr(tvk, "MAX_QUBITS", 8)  # 9 simulated qubits
    sv.__dict__.pop("_scan_step_cache", None)
    got = tq._scan_core(sv, uniq, mass, device="cpu")
    routes = next(iter(sv._scan_step_cache.values()))["routes"]
    assert routes == ["ancilla, no kernel"] * 2, routes
    np.testing.assert_allclose(got.values, ref.values, atol=SCAN_ATOL)


def test_label_block_counts_states_without_a_kernel():
    """A route without a kernel holds whole states and full rows a
    label: on qft-16 (stored plan, both fragments in collapse mode, a
    15-qubit state) its block is far below the in-kernel marginal's 4096
    labels, and its bytes stay inside the budget."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter as TCutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc as t_gen_circ,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.plans import (  # noqa: E501
        load_plan,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
        VirtualCircuit as TVirtualCircuit,
    )

    cutter = TCutter(t_gen_circ("qft", 16, 1), maxNPartitions=2,
                     maxNQubitsPerPartition=15, gammaMode=True)
    cutter.use_plan(load_plan("qft16_prepped_p2_q15_gamma"))
    tv = TVirtualCircuit(cutter.getResultCircs()[3])
    flags = tq._collapse_flags(tv, "auto")
    keep = [0, 1, 2, 3]
    ent = tq._build_scan(tv, flags, keep, None, torch.device("cpu"),
                         pallas_variant=False)
    assert ent["routes"] == ["collapse, no kernel"] * 2
    assert sorted(s[0] for s in ent["states"]) == [1, 15]
    blk = tq._label_block(tv, flags, keep_clbits=keep,
                          states=ent["states"])
    per_label = sum(tq._state_bytes(s) for s in ent["states"])
    assert tq._label_block(tv, flags, keep_clbits=keep) == tq._MAX_BLOCK
    assert 1 <= blk < 1024 and blk * per_label <= tq._CHUNK_BYTES_BUDGET
