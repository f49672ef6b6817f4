"""The port's sampled engine (ops/qpd_sampling.py) against the JAX
package's, on the CPU: the label samplers exactly, the blocked scan and
the public estimators with the same seeds (same labels, same collapse
draws -> same branch picks) to float tolerance.  The JAX side runs as its
own tests run it: ``pallas_variant=True``, the Pallas kernels in interpret
mode.  The port runs its kernels' plain versions (``device="cpu"``)."""
import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
    qpd_sampling as jq,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    qpd_sampling as tq,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
    run_virtual_circuit as t_run,
)
from torch_port_common import cut_pair, label_table, qft_gamma_pair

SCAN_ATOL = 1e-6
KNIT_TOL = dict(atol=5e-5, rtol=1e-3)  # JAX's own, kernel vs XLA route
Z_SETS = [[0], [0, 1, 2], [4], list(range(9))]


@pytest.fixture(scope="module")
def qft9():
    """qft-9 cut 8|1 in gamma mode (8 cp cuts): (jax virt, port virt)."""
    return qft_gamma_pair(9, 8)


@pytest.fixture(scope="module")
def sample1000(qft9):
    jv, _ = qft9
    uniq, counts = jq.sample_label_counts(jv, 1000, 5)
    return uniq, counts.astype(np.float64) / 1000


@pytest.mark.parametrize("method", ["iid", "lhs"])
def test_label_samplers_equal(qft9, method):
    jv, tv = qft9
    np.testing.assert_array_equal(
        jq.sample_labels(jv, 500, seed=3, method=method),
        tq.sample_labels(tv, 500, seed=3, method=method))
    for kw in (dict(), dict(chunk=128)):
        ju, jc = jq.sample_label_counts(jv, 700, 4, method=method, **kw)
        tu, tc = tq.sample_label_counts(tv, 700, 4, method=method, **kw)
        np.testing.assert_array_equal(ju, tu)
        np.testing.assert_array_equal(jc, tc)
    assert jq.cut_gammas(jv) == tq.cut_gammas(tv)
    assert jq.sampling_overhead(jv, eps=0.1) == \
        tq.sampling_overhead(tv, eps=0.1)


def test_stratified_split_and_expansion_equal(qft9):
    jv, tv = qft9
    js, ts = jq.stratified_split(jv, 12), tq.stratified_split(tv, 12)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tq.stratified_split(tv, 0) is None
    ju, jc = jq._sample_tail_counts(jv, 300, js[2], seed=2, method="lhs")
    tu, tc = tq._sample_tail_counts(tv, 300, ts[2], seed=2, method="lhs")
    np.testing.assert_array_equal(ju, tu)
    np.testing.assert_array_equal(jc, tc)
    for cap in (None, 3):
        jl, jf = jq._expand_measuring_counts(jv, ju, jc, cap=cap)
        tl, tf = tq._expand_measuring_counts(tv, tu, tc, cap=cap)
        np.testing.assert_array_equal(jl, tl)
        np.testing.assert_array_equal(jf, tf)
    jl, jf = jq._expand_measuring_mass(jv, js[0], js[1], 4)
    tl, tf = tq._expand_measuring_mass(tv, ts[0], ts[1], 4)
    np.testing.assert_array_equal(jl, tl)
    np.testing.assert_array_equal(jf, tf)
    for collapse in ("auto", True, False, [True, False]):
        assert jq._collapse_flags(jv, collapse) == \
            tq._collapse_flags(tv, collapse)


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


def test_scan_core_distribution_matches_jax(qft9, sample1000):
    """Same collapse_seed -> same draws -> same picks: estimate, second
    moment and control-variate moments, every fragment in collapse mode
    (the JAX kernel backs the wide one, its XLA route the narrow one;
    the port's kernel module backs both)."""
    jv, tv = qft9
    uniq, mass = sample1000
    kw = dict(flags=[True, True], collapse_seed=11, second_moment=True,
              control_stats=True)
    want = jq._scan_core(jv, uniq, mass, block=32, pallas_variant=True,
                         **kw)
    got = tq._scan_core(tv, uniq, mass, block=32, device="cpu", **kw)
    assert got[0].bit_positions == want[0].bit_positions
    _same_stats(got, want, SCAN_ATOL)
    # another block size feeds the same draws: the same estimate
    other = tq._scan_core(tv, uniq, mass, block=100, device="cpu", **kw)
    _same_stats(other, got, SCAN_ATOL)
    plain = tq._scan_core(tv, uniq, mass, block=len(uniq), device="cpu",
                          flags=[True, True], collapse_seed=11)
    np.testing.assert_allclose(plain.values, got[0].values, atol=SCAN_ATOL)


def test_scan_core_z_sets_match_jax(qft9, sample1000):
    jv, tv = qft9
    uniq, mass = sample1000
    kw = dict(z_sets=Z_SETS, flags=[True, True], collapse_seed=11,
              second_moment=True, control_stats=True)
    want = jq._scan_core(jv, uniq, mass, block=32, pallas_variant=True,
                         **kw)
    got = tq._scan_core(tv, uniq, mass, block=32, device="cpu", **kw)
    _same_stats(got, want, SCAN_ATOL)
    other = tq._scan_core(tv, uniq, mass, block=57, device="cpu", **kw)
    _same_stats(other, got, SCAN_ATOL)
    # the in-kernel z columns against the full rows through the sign
    # matrix: past 128 columns the scan takes that route
    many = Z_SETS + [[1]] * 130
    wide = tq._scan_core(tv, uniq, mass, z_sets=many, block=64,
                         device="cpu", flags=[True, True], collapse_seed=11)
    np.testing.assert_allclose(wide[: len(Z_SETS)], got[0], atol=SCAN_ATOL)


def test_scan_core_marginal_matches_full(qft9, sample1000):
    """keep_clbits: the in-kernel marginal equals the full estimate
    summed onto the kept bits; past 128 kept outcomes the scan reduces
    full rows in torch."""
    _, tv = qft9
    uniq, mass = sample1000
    kw = dict(flags=[True, True], collapse_seed=11, block=64, device="cpu")
    full = tq._scan_core(tv, uniq, mass, **kw)
    assert full.bit_positions == list(range(9))
    for keep in ([0, 1, 2], list(range(8))):
        marg = tq._scan_core(tv, uniq, mass, keep_clbits=keep, **kw)
        assert marg.bit_positions == keep
        want = np.asarray(full.values).reshape([2] * 9).sum(
            axis=tuple(8 - c for c in range(9) if c not in keep)
        ).reshape(-1)
        np.testing.assert_allclose(marg.values, want, atol=SCAN_ATOL)


def test_scan_core_ancilla_mode_matches_jax(qft9):
    """flags all False: exact per-label rows with deferral ancillas, from
    the variant kernel's full rows (n = 16 and 9) in both packages."""
    jv, tv = qft9
    uniq, counts = jq.sample_label_counts(jv, 400, 5)
    mass = counts.astype(np.float64) / 400
    want = jq._scan_core(jv, uniq, mass, flags=[False, False], block=16,
                         pallas_variant=True)
    got = tq._scan_core(tv, uniq, mass, flags=[False, False], block=16,
                        device="cpu")
    assert got.bit_positions == want.bit_positions
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               atol=SCAN_ATOL)


def test_scan_step_cache_reuse(qft9, sample1000):
    """A repeat estimate on the same VirtualCircuit builds no plan again:
    no new cache entry, the same row functions, the identical estimate;
    other kept clbits are another entry."""
    _, tv = qft9
    uniq, mass = sample1000
    tv.__dict__.pop("_scan_step_cache", None)
    kw = dict(flags=[True, True], collapse_seed=3, block=32, device="cpu")
    a = tq._scan_core(tv, uniq, mass, **kw)
    assert len(tv._scan_step_cache) == 1
    row_fns = list(next(iter(tv._scan_step_cache.values()))["row_fns"])
    b = tq._scan_core(tv, uniq, mass, second_moment=True, **kw)[0]
    assert len(tv._scan_step_cache) == 1
    assert next(iter(tv._scan_step_cache.values()))["row_fns"] == row_fns
    np.testing.assert_array_equal(a.values, b.values)
    tq._scan_core(tv, uniq, mass, keep_clbits=[0], **kw)
    assert len(tv._scan_step_cache) == 2


def test_sampled_knit_matches_jax(qft9):
    jv, tv = qft9
    args = dict(seed=2, keep_clbits=[0, 1, 2], with_stderr=True,
                method="lhs", control_variate=True, collapse=True)
    e0, s0 = jq.sampled_knit(jv, 4000, pallas_variant=True, **args)
    e1, s1 = tq.sampled_knit(tv, 4000, device="cpu", **args)
    assert e1.bit_positions == e0.bit_positions
    np.testing.assert_allclose(e1.values, np.asarray(e0.values), **KNIT_TOL)
    np.testing.assert_allclose(s1, s0, **KNIT_TOL)
    # the plain estimate (no stderr, no regression) is the first moment
    p1 = tq.sampled_knit(tv, 4000, seed=2, keep_clbits=[0, 1, 2],
                         method="lhs", collapse=True, device="cpu")
    assert abs(float(np.sum(p1.values)) - 1) < 0.2


def test_sampled_expectation_z_matches_jax(qft9):
    jv, tv = qft9
    zsets = [{0}, {0, 1, 2}, set(range(9))]
    args = dict(seed=2, method="lhs", with_stderr=True,
                control_variate=True, collapse=True)
    z0, t0 = jq.sampled_expectation_z(jv, zsets, 4000, pallas_variant=True,
                                      **args)
    z1, t1 = tq.sampled_expectation_z(tv, zsets, 4000, device="cpu", **args)
    np.testing.assert_allclose(z1, z0, **KNIT_TOL)
    np.testing.assert_allclose(t1, t0, **KNIT_TOL)


def test_full_grid_identity_against_pallas_engine():
    """All labels with their exact sampling mass reproduce the exact knit:
    ancilla-mode rows (the variant kernel's full rows, folded per label)
    against the port's ``engine="pallas"`` unprojected result."""
    _, _, _, tv = cut_pair("sup", 12, 1, 10, seed=5)
    vidx, total, _ = label_table(tv, 1)
    mass = np.ones(total)
    for g, vg in enumerate(tv.vgates):
        m = tq._variant_magnitudes(vg.spec)
        mass *= (m / m.sum())[vidx[:total, g]]
    assert abs(mass.sum() - 1) < 1e-12
    flags = [False] * len(tv.fragments)
    est, m2 = tq._estimate(tv, vidx[:total], mass, collapse=flags,
                           second_moment=True, device="cpu")
    exact, _ = t_run(tv, engine="pallas", chunk_size=64, project=False,
                     device="cpu")
    assert est.bit_positions == exact.bit_positions
    np.testing.assert_allclose(est.values, exact.values, atol=1e-6)
    assert m2.shape == est.values.shape and (m2 >= 0).all()
    z = tq._estimate_z(tv, vidx[:total], mass, [set(exact.bit_positions)],
                       collapse=flags, device="cpu")
    idx = np.arange(len(exact.values))
    par = np.zeros(len(idx), np.int64)
    for j in range(len(exact.bit_positions)):
        par ^= (idx >> j) & 1
    np.testing.assert_allclose(
        z[0], float(np.sum(exact.values * (1 - 2 * par))), atol=1e-6)


def test_label_block_follows_bytes(qft9):
    """The scan block comes from bytes on the card: narrow in-kernel
    outputs reach the cap, full 2^16 ancilla rows do not."""
    _, tv = qft9
    assert tq._label_block(tv, [True, True], keep_clbits=[0, 1]) == \
        tq._MAX_BLOCK
    assert tq._label_block(tv, [True, True], z_sets=[{0}]) == tq._MAX_BLOCK
    blk = tq._label_block(tv, [False, False])
    assert 1 <= blk < tq._MAX_BLOCK
    assert blk * 16 * ((1 << 16) + (1 << 9)) <= tq._CHUNK_BYTES_BUDGET
