"""The port's batched engine and knit on the CPU against the JAX package.

The same cut circuit, built with the JAX package and carried across with
``convert``, goes through both packages' ``run_fragment`` /
``run_all_fragments`` (and ``make_sim_fn`` with ``fused_slots`` both
ways), ``knit``, ``knit_values``, ``expectation_z(_multi)`` and
``knit_scalars_blocked``: rows and knits within 1e-6 (f32, the same plan,
sums in another order).  Rows cross between the packages through
``convert.fragment_result_from_other`` / ``fragment_result_to_numpy``, so
each package's knit also takes the other's rows.  The slice:
``run_virtual_circuit(engine="xla" / "auto", device="cpu")`` against the
JAX call and against the port's ``engine="pallas"``, fidelity > 1 - 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
    Instruction as JInstruction,
    Register as JRegister,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (
    knit as jknit,
    variant_engine as jve,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
    Distribution as JDistribution,
    simulate_circuit as j_simulate,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.evaluate import (  # noqa: E501
    hellinger_fidelity as j_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.run import (
    run_virtual_circuit as j_run,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_gates import (  # noqa: E501
    VirtualGateOp as JVirtualGateOp,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch import (
    run as trun,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    fragment_result_from_other,
    fragment_result_to_numpy,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    hellinger_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    knit as tknit,
    variant_engine as tve,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.bits import (  # noqa: E501
    permute_bits_flat,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    Distribution,
    simulate_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from torch_port_common import chain_cut_pair, cut_pair, to_port

ATOL = 1e-6


def _vgate(name, qubits, params=()):
    return JInstruction("vgate", list(qubits), params=list(params),
                        op=JVirtualGateOp(name, tuple(params)))


def _wire_and_gate():
    """A wire cut and a gate cut between the same two fragments."""
    cut = JCircuit([JRegister("frag0", 3), JRegister("frag1", 3)], 5)
    cut.h(0)
    cut.cx(0, 1)
    cut.ry(0.4, 2)
    cut.append(_vgate("move", [1, 3]))
    cut.cx(3, 4)
    cut.append(_vgate("cz", [2, 5]))
    cut.rx(0.3, 5)
    cut.cx(4, 5)
    cut.measure(0, 0)
    cut.measure(2, 1)
    cut.measure(3, 2)
    cut.measure(4, 3)
    cut.measure(5, 4)
    return cut


def _three_fragments():
    """Three fragments, the middle one touching both cuts, the last with
    an idle measured qubit (a deterministic zero bit) and a free fragment
    no vgate touches."""
    cut = JCircuit([JRegister("frag0", 2), JRegister("frag1", 2),
                    JRegister("frag2", 2), JRegister("frag3", 1)], 7)
    cut.h(0)
    cut.cx(0, 1)
    cut.append(_vgate("cx", [1, 2]))
    cut.ry(0.7, 3)
    cut.cx(2, 3)
    cut.append(_vgate("rzz", [3, 4], (0.6,)))
    cut.h(4)
    cut.ry(1.1, 6)
    for q in range(7):
        cut.measure(q, q)
    return cut


def _chain():
    return chain_cut_pair(5)


def _from_cut(build):
    def make():
        cut = build()
        return JVirtualCircuit(cut), TVirtualCircuit(to_port(cut))
    return make


def _hwe10():
    _, _, jv, tv = cut_pair("hwe", 10, 2, 6, seed=0, maxNQpdCuts=2,
                            maxNCuts=2, maxCutsPerPartitions=2)
    return jv, tv


CASES = {
    "chain5": _chain,
    "wire_and_gate": _from_cut(_wire_and_gate),
    "three_fragments": _from_cut(_three_fragments),
    "hwe10_d2_p2q6": _hwe10,
}
_CACHE: dict = {}


def _case(name):
    """(jax_virt, port_virt, jax results, port results), built once."""
    if name not in _CACHE:
        jv, tv = CASES[name]()
        _CACHE[name] = (jv, tv, jve.run_all_fragments(jv),
                        tve.run_all_fragments(tv, device="cpu"))
    return _CACHE[name]


def _data_clbits(virt):
    return sorted(c for p in virt.programs.values() for c in p.clbit_sources
                  if c < virt.num_clbits)


# ---------------------------------------------------------------------------
# run_fragment / run_all_fragments / make_sim_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_run_all_fragments_matches_jax(name):
    jv, tv, jres, tres = _case(name)
    assert [r.name for r in tres] == [r.name for r in jres]
    for jr, tr in zip(jres, tres):
        assert tr.bit_positions == jr.bit_positions
        assert tr.touching == jr.touching
        assert isinstance(tr.values, torch.Tensor)
        assert tr.values.dtype == torch.float32
        assert tuple(tr.values.shape) == jr.values.shape
        np.testing.assert_allclose(tr.values.numpy(), jr.values, atol=ATOL,
                                   err_msg=jr.name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_make_sim_fn_matches_jax(name, fused):
    jv, tv, _, _ = _case(name)
    for reg in jv.fragments:
        j_one, j_mats, j_pos, j_count = jve.make_sim_fn(
            jv, reg.name, fused_slots=fused)
        t_fn, t_mats, t_pos, t_count = tve.make_sim_fn(
            tv, reg.name, fused_slots=fused)
        assert (t_pos, t_count) == (j_pos, j_count)
        assert t_fn.prefix_width == j_one.prefix_width
        assert t_fn.active_final == j_one.active_final
        assert t_fn.sources == j_one.sources
        assert ([(s[0], s[2]) for s in t_fn.run_plan]
                == [(s[0], s[2]) for s in j_one.run_plan])
        np.testing.assert_allclose(t_fn.prefix_state, j_one.prefix_state,
                                   atol=ATOL)
        assert len(t_mats) == len(j_mats)
        for t_tabs, j_tabs in zip(t_mats, j_mats):
            for t_tab, j_tab in zip(t_tabs, j_tabs):
                assert np.array_equal(t_tab, j_tab)
        if not j_mats:
            want = np.asarray(j_one([]))[None]
        else:
            want = np.asarray(jax.vmap(j_one)(j_mats))
        got = t_fn([tuple(torch.as_tensor(t) for t in tabs)
                    for tabs in t_mats], device="cpu")
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                                   err_msg=reg.name)


def test_chunked_scan_equals_one_pass():
    """A chunk that does not divide the variant count (36 = 7 * 5 + 1)."""
    _, tv, _, tres = _case("hwe10_d2_p2q6")
    for reg, whole in zip(tv.fragments, tres):
        res = tve.run_fragment(tv, reg.name, chunk_size=7, device="cpu")
        assert res.values.shape == whole.values.shape
        np.testing.assert_allclose(res.values.numpy(), whole.values.numpy(),
                                   atol=1e-7)


def test_fragment_without_slots_broadcasts_one_row():
    jv, tv, jres, tres = _case("three_fragments")
    free = next(r for r in tres if r.name == "frag3")
    assert free.touching == [] and free.values.shape == (1, 2)
    np.testing.assert_allclose(
        free.values.numpy(),
        next(r for r in jres if r.name == "frag3").values, atol=ATOL)


def test_chunk_cap_bounds_bytes():
    for n in (5, 13, 20, 24):
        cap = tve.chunk_cap(n)
        assert cap >= 1
        assert cap * 8 * (1 << n) <= 256 * 1024 * 1024 or cap == 1
    assert tve.chunk_cap(13) == 4096
    assert tve.chunk_cap(30) == 1


@pytest.mark.parametrize("kw", [
    dict(noise=object()), dict(dtype=torch.bfloat16), dict(collapse=True),
], ids=["noise", "dtype", "collapse"])
def test_make_sim_fn_refusals_name_their_roadmap_item(kw):
    """bf16 states (the serving mode) run since the streamed engine
    landed: float32 rows within 5e-3 of the f32 closure's.  Noise runs
    since the noise slice landed: with a routed, calibrated model and the
    same branch indices a site, the rows equal the JAX closure's within
    1e-6, and the sites and readout nodes are the JAX closure's bit for
    bit.  Collapse runs since the sampled engine's rows without a kernel
    landed: with the same draws, flags and weights, the rows equal the
    JAX closure's within 1e-6."""
    jv, tv, _, _ = _case("chain5")
    if "noise" in kw:
        _noisy_rows_match(jv, tv)
        return
    if "collapse" in kw:
        _collapse_rows_match(jv, tv)
        return
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        sim_fn, mats, _, _ = tve.make_sim_fn(tv, "frag0", fused_slots=True,
                                             **dict(kw, dtype=dtype))
        assert sim_fn.dtype == dtype
        rows[dtype] = sim_fn([tuple(torch.as_tensor(t) for t in tabs)
                              for tabs in mats])
    assert rows[torch.bfloat16].dtype == torch.float32
    assert float((rows[torch.bfloat16] - rows[torch.float32]).abs().max()) \
        < 5e-3


def _collapse_rows_match(jv, tv):
    sj, jmats, jpos, count = jve.make_sim_fn(jv, "frag0", collapse=True)
    sim_fn, tmats, tpos, tcount = tve.make_sim_fn(tv, "frag0", collapse=True)
    assert (tpos, tcount) == (jpos, count)
    assert sim_fn.collapse_slots == sj.collapse_slots
    rng = np.random.default_rng(2)
    # (u, mflag, w0, w1) a row: every flag > 0, so every site collapses
    args = {sid: tuple(rng.random(count).astype(np.float32)
                       for _ in range(4)) for sid in sim_fn.collapse_slots}
    want = jax.vmap(sj)(jmats, {k: tuple(jax.numpy.asarray(x) for x in v)
                                for k, v in args.items()})
    got = sim_fn([tuple(torch.as_tensor(t) for t in tabs)
                  for tabs in tmats], {k: tuple(torch.as_tensor(x)
                                                for x in v)
                                       for k, v in args.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _noisy_rows_match(jv, tv):
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
        noise as jnoise,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
        noise_model_from_other,
    )

    jm = jnoise.fake_kolkata_v2(relaxation=True)
    sim_one, jmats, jpos, count = jve.make_sim_fn(jv, "frag0", noise=jm)
    sim_fn, tmats, tpos, tcount = tve.make_sim_fn(
        tv, "frag0", noise=noise_model_from_other(jm))
    assert (tpos, tcount) == (jpos, count)
    assert sim_fn.readout_device == sim_one.readout_device
    assert len(sim_fn.noise_sites) == len(sim_one.noise_sites)
    for a, b in zip(sim_one.noise_sites, sim_fn.noise_sites):
        assert a[:2] == b[:2]
        for x, y in zip(a[2:], b[2:]):
            assert (x is None and y is None) or np.array_equal(x, y)
    rng = np.random.default_rng(4)
    idx = [jnoise._site_idx(rng, pr, (count,))
           for (_, _, pr, _, _) in sim_one.noise_sites]
    want = jax.vmap(sim_one)(
        jmats, [site[3][i] for site, i in zip(sim_one.noise_sites, idx)])
    got = sim_fn(
        [tuple(torch.as_tensor(t) for t in tabs) for tabs in tmats], "cpu",
        {s: torch.as_tensor(sim_fn.site_banks[s][idx[s]])
         for s in sim_fn.active_sites})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------------------
# knit
# ---------------------------------------------------------------------------

def _both_rows(name):
    """Rows of each package as the other takes them."""
    jv, tv, jres, tres = _case(name)
    j_as_t = [fragment_result_from_other(r, device="cpu") for r in jres]
    t_as_j = [fragment_result_to_numpy(r) for r in tres]
    return jv, tv, jres, tres, j_as_t, t_as_j


@pytest.mark.parametrize("name", sorted(CASES))
def test_knit_matches_jax_on_the_same_rows(name):
    jv, tv, jres, tres, j_as_t, t_as_j = _both_rows(name)
    want = jknit.knit(jv, jres)
    for rows in (j_as_t, tres):
        got = tknit.knit(tv, rows)
        assert isinstance(got, Distribution)
        assert got.bit_positions == want.bit_positions
        assert got.num_clbits == want.num_clbits
        np.testing.assert_allclose(got.values, np.asarray(want.values),
                                   atol=ATOL)
    # the port's rows through the JAX package's knit
    back = jknit.knit(jv, t_as_j)
    np.testing.assert_allclose(np.asarray(back.values),
                               np.asarray(want.values), atol=ATOL)
    assert abs(float(np.sum(got.values)) - 1) < 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_knit_values_marginal_matches_jax(name):
    jv, tv, jres, _, j_as_t, _ = _both_rows(name)
    data = _data_clbits(tv)
    keep = set(data[::2])
    want_v, want_pos = jknit.knit_values(jv, jres, keep_clbits=keep)
    got_v, got_pos = tknit.knit_values(tv, j_as_t, keep_clbits=keep)
    assert got_pos == want_pos == sorted(keep)
    assert isinstance(got_v, torch.Tensor)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=ATOL)
    # the marginal of the full knit
    full = tknit.knit(tv, j_as_t)
    idx = np.arange(len(full.values))
    key = np.zeros(len(idx), np.int64)
    for j, c in enumerate(sorted(keep)):
        key |= ((idx >> full.bit_positions.index(c)) & 1) << j
    np.testing.assert_allclose(
        got_v.numpy(),
        np.bincount(key, weights=full.values, minlength=1 << len(keep)),
        atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_expectation_z_matches_jax(name):
    jv, tv, jres, tres, j_as_t, _ = _both_rows(name)
    data = _data_clbits(tv)
    z_sets = [[data[0]], data[:2], data[1::2], data]
    want = np.asarray(jknit.expectation_z_multi(jv, jres, z_sets))
    for rows in (j_as_t, tres):
        got = tknit.expectation_z_multi(tv, rows, z_sets)
        assert got.shape == (len(z_sets),)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    one = tknit.expectation_z(tv, tres, z_sets[1])
    assert isinstance(one, float)
    assert one == pytest.approx(jknit.expectation_z(jv, jres, z_sets[1]),
                                abs=ATOL)
    # and the same from the knitted distribution
    dist = tknit.knit(tv, tres)
    idx = np.arange(len(dist.values))
    par = np.zeros(len(idx), np.int64)
    for c in z_sets[1]:
        par ^= (idx >> dist.bit_positions.index(c)) & 1
    assert one == pytest.approx(float(((1 - 2 * par) * dist.values).sum()),
                                abs=1e-6)


def test_expectation_z_refuses_an_unmeasured_clbit():
    cut = JCircuit([JRegister("frag0", 2), JRegister("frag1", 2)], 4)
    cut.h(0)
    cut.cx(0, 1)
    cut.append(_vgate("cz", [1, 2]))
    cut.cx(2, 3)
    cut.measure(0, 0)
    cut.measure(3, 3)
    jv, tv = JVirtualCircuit(cut), TVirtualCircuit(to_port(cut))
    tres = tve.run_all_fragments(tv, device="cpu")
    with pytest.raises(ValueError, match="never measured"):
        tknit.expectation_z(tv, tres, [0, 1])
    with pytest.raises(ValueError, match="never measured"):
        jknit.expectation_z(jv, jve.run_all_fragments(jv), [0, 1])
    assert tknit.expectation_z(tv, tres, [0, 3]) == pytest.approx(
        jknit.expectation_z(jv, jve.run_all_fragments(jv), [0, 3]), abs=ATOL)


@pytest.mark.parametrize("max_elems", [1 << 20, 8, 2])
@pytest.mark.parametrize("name", ["chain5", "hwe10_d2_p2q6"])
def test_knit_scalars_blocked_matches_jax(name, max_elems):
    jv, tv, jres, tres, j_as_t, _ = _both_rows(name)
    want = [float(x) for x in jknit.knit_scalars_blocked(jv, jres, max_elems)]
    got = [float(x) for x in tknit.knit_scalars_blocked(tv, j_as_t,
                                                        max_elems)]
    assert got == pytest.approx(want, abs=2e-6)
    full = tknit.knit(tv, tres).values.astype(np.float64)
    assert got[0] == pytest.approx(full.sum(), abs=1e-5)
    assert got[1] == pytest.approx(np.minimum(full, 0).sum(), abs=1e-5)


@pytest.mark.parametrize("max_elems", [1 << 20, 16])
def test_make_blocked_knit_assembles_the_knit(max_elems):
    jv, tv, jres, tres, _, _ = _both_rows("hwe10_d2_p2q6")
    block_fn, nb, bc, src_bits = tknit.make_blocked_knit(tv, tres, max_elems)
    _, j_nb, j_bc, j_src = jknit.make_blocked_knit(jv, jres, max_elems)
    assert (nb, bc, src_bits) == (j_nb, j_bc, j_src)
    flat = torch.cat([block_fn(j) for j in range(nb)], dim=1).reshape(-1)
    got = permute_bits_flat(flat, src_bits, sorted(src_bits))
    want, _ = tknit.knit_values(tv, tres)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-7)


def test_prune_distribution_matches_jax():
    vals = np.random.default_rng(3).normal(0, 2e-5, 64).astype(np.float32)
    vals[5] = 0.5
    got = tknit.prune_distribution(Distribution(vals, list(range(6)), 6))
    want = jknit.prune_distribution(JDistribution(vals, list(range(6)), 6))
    assert np.array_equal(got.values, np.asarray(want.values))
    assert got.values.dtype == np.float32 and 0 < (got.values != 0).sum() < 64


def test_fragment_results_cross_unchanged():
    _, _, jres, tres, j_as_t, t_as_j = _both_rows("chain5")
    for jr, carried in zip(jres, j_as_t):
        assert carried.values.dtype == torch.float32
        assert np.array_equal(carried.values.numpy(),
                              np.asarray(jr.values, np.float32))
        assert (carried.name, carried.bit_positions, carried.touching) == (
            jr.name, jr.bit_positions, jr.touching)
    for tr, carried in zip(tres, t_as_j):
        assert isinstance(carried.values, np.ndarray)
        assert np.array_equal(carried.values, tr.values.numpy())


# ---------------------------------------------------------------------------
# The slice: run_virtual_circuit(engine="xla" / "auto")
# ---------------------------------------------------------------------------

SLICE = {
    "ghz10_p2q5": ("ghz", 10, 1, 5, None, dict(maxNQpdCuts=2, maxNCuts=2)),
    "sup12_p2q7": ("sup", 12, 1, 7, 1,
                   dict(maxNQpdCuts=3, maxNCuts=3, maxCutsPerPartitions=3)),
    "hwe10_d2_p2q6": ("hwe", 10, 2, 6, 0,
                      dict(maxNQpdCuts=2, maxNCuts=2,
                           maxCutsPerPartitions=2)),
}
_SLICE_CACHE: dict = {}


def _slice(name):
    if name not in _SLICE_CACHE:
        gen, n, depth, cap, seed, kw = SLICE[name]
        _SLICE_CACHE[name] = cut_pair(gen, n, depth, cap, seed=seed, **kw)
    return _SLICE_CACHE[name]


@pytest.mark.parametrize("engine", ["xla", "auto"])
@pytest.mark.parametrize("name", sorted(SLICE))
def test_batched_engine_end_to_end(name, engine):
    jc, tc, jv, tv = _slice(name)
    got, info = trun.run_virtual_circuit(tv, engine=engine, device="cpu")
    want, _ = j_run(jv, engine=engine)
    assert got.bit_positions == want.bit_positions
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               atol=ATOL)
    assert info.run_time > 0 and info.knit_time > 0
    ideal = simulate_circuit(tc, device="cpu")
    assert hellinger_fidelity(ideal, got) > 1 - 1e-6
    assert j_fidelity(j_simulate(jc), want) > 1 - 1e-6
    kernel, kinfo = trun.run_virtual_circuit(tv, engine="pallas",
                                             device="cpu")
    assert kinfo.knit_time == 0.0
    np.testing.assert_allclose(got.values, kernel.values, atol=ATOL)
    assert hellinger_fidelity(kernel, got) > 1 - 1e-6


@pytest.mark.parametrize("engine", ["xla", "auto"])
def test_batched_engine_marginal_and_unprojected(engine):
    _, _, jv, tv = _slice("sup12_p2q7")
    keep = [0, 3, 4, 9]
    got, _ = trun.run_virtual_circuit(tv, engine=engine, keep_clbits=keep,
                                      project=False, device="cpu")
    want, _ = j_run(jv, engine=engine, keep_clbits=keep, project=False)
    assert got.bit_positions == want.bit_positions == keep
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               atol=ATOL)


def test_auto_takes_the_streamed_scan_above_its_threshold(monkeypatch):
    """Past ``AUTO_STREAM_LABELS`` global labels "auto" runs the streamed
    scan (here the kernel-backed one), below it the batched engine."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.run import (
        AUTO_STREAM_LABELS as J_THRESHOLD,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        streamed,
        variant_engine,
    )

    assert trun.AUTO_STREAM_LABELS == J_THRESHOLD == 16384
    _, _, _, tv = _slice("ghz10_p2q5")   # 6 labels
    calls = []
    real_scan = streamed.run_virtual_circuit_streamed
    real_batched = variant_engine.run_all_fragments
    monkeypatch.setattr(
        streamed, "run_virtual_circuit_streamed",
        lambda *a, **k: calls.append("scan") or real_scan(*a, **k))
    monkeypatch.setattr(
        variant_engine, "run_all_fragments",
        lambda *a, **k: calls.append("batched") or real_batched(*a, **k))
    below, _ = trun.run_virtual_circuit(tv, engine="auto", device="cpu")
    assert calls == ["batched"]
    monkeypatch.setattr(trun, "AUTO_STREAM_LABELS", 5)
    above, info = trun.run_virtual_circuit(tv, engine="auto", device="cpu")
    assert calls == ["batched", "scan"] and info.knit_time == 0.0
    np.testing.assert_allclose(above.values, below.values, atol=ATOL)
    trun.run_virtual_circuit(tv, engine="xla", device="cpu")
    assert calls == ["batched", "scan", "batched"]


@pytest.mark.parametrize("engine", ["xla", "auto"])
@pytest.mark.parametrize("kw", [
    dict(shots=100), dict(noise=object()), dict(dtype=torch.bfloat16),
    dict(mesh="one"),
], ids=["shots", "noise", "dtype", "mesh"])
def test_batched_engine_refusals_name_their_roadmap_item(engine, kw):
    """``mesh`` (a mesh of one in each package) is read by the sharded
    and sampled engines only: here, as in the JAX package, the result is
    the JAX engine's without it.  ``noise`` is no
    keyword of ``run_virtual_circuit``, a TypeError as in the JAX package
    (noise runs through ``ops.noise.run_noisy_virtual_circuit``).  Since
    the streamed engine landed: shots run (variant rows sampled; GHZ
    counts near 1/2 on its two outcomes); bf16 is JAX's ValueError
    on "xla" and routes "auto" to the streamed scan (within 5e-3)."""
    _, _, jv, tv = _slice("ghz10_p2q5")
    if "noise" in kw:
        with pytest.raises(TypeError, match="noise"):
            j_run(jv, engine=engine, **kw)
        with pytest.raises(TypeError, match="noise"):
            trun.run_virtual_circuit(tv, engine=engine, device="cpu", **kw)
        return
    if "shots" in kw:
        got, _ = trun.run_virtual_circuit(tv, engine=engine, device="cpu",
                                          **kw)
        # 100 sampled shots a row knit to a mass near 1 (as in the JAX
        # package), nearly all of it on the two GHZ outcomes
        total = float(got.values.sum())
        assert abs(total - 1.0) < 0.25
        assert got.values[0] > 0.25 and got.values[-1] > 0.25
        assert got.values[0] + got.values[-1] >= 0.9 * total
        return
    if "dtype" in kw and engine == "xla":
        with pytest.raises(ValueError, match="not engine='xla'"):
            trun.run_virtual_circuit(tv, engine=engine, device="cpu", **kw)
        return
    if "dtype" in kw:
        got, info = trun.run_virtual_circuit(tv, engine=engine,
                                             device="cpu", **kw)
        want, _ = trun.run_virtual_circuit(tv, engine=engine, device="cpu")
        assert info.knit_time == 0.0
        np.testing.assert_allclose(got.values, want.values, atol=5e-3)
        return
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.parallel.mesh import (  # noqa: E501
        make_mesh as j_make_mesh,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.parallel.mesh import (  # noqa: E501
        make_mesh,
    )

    want, _ = j_run(jv, engine=engine, mesh=j_make_mesh(1))
    got, _ = trun.run_virtual_circuit(tv, engine=engine, device="cpu",
                                      mesh=make_mesh(device="cpu"))
    np.testing.assert_allclose(got.values, want.values, atol=ATOL)


@pytest.mark.parametrize("engine", ["streamed", "sharded"])
def test_engines_still_to_port_name_their_roadmap_item(engine):
    """Both are ported now: "streamed" and "sharded" (one device: each
    fragment's mesh is (1, 1)) equal the batched engine."""
    _, _, _, tv = _slice("ghz10_p2q5")
    got, _ = trun.run_virtual_circuit(tv, engine=engine, device="cpu")
    want, _ = trun.run_virtual_circuit(tv, engine="xla", device="cpu")
    np.testing.assert_allclose(got.values, want.values, atol=ATOL)


def test_unknown_engine_and_sampled_knobs_are_refused():
    _, _, _, tv = _slice("ghz10_p2q5")
    with pytest.raises(ValueError, match="unknown engine"):
        trun.run_virtual_circuit(tv, engine="aer", device="cpu")
    with pytest.raises(ValueError, match="sampled-engine"):
        trun.run_virtual_circuit(tv, engine="xla", head_labels=3,
                                 device="cpu")


def test_batched_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, tv = _slice("ghz10_p2q5")
    for engine in ("xla", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trun.run_virtual_circuit(tv, engine=engine)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tve.run_all_fragments(tv)
    free_fn = tve.make_sim_fn(_case("three_fragments")[1], "frag3")[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        free_fn([])   # no slot block names a device: None means "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fragment_result_from_other(
            fragment_result_to_numpy(_case("chain5")[3][0]))
