"""The port's collapse kernel module against the JAX package's, on the CPU.

The same labels and the same uniform draws (numpy, fixed seeds) go through
the JAX row functions (the Pallas kernel in interpret mode where it serves
the fragment, the XLA collapse rows where it does not) and through the
port's ``_collapse_row_builder_pallas``, which on CPU tensors runs
``plain_collapse_rows``.  Same draws -> same branch picks, so rows agree to
the JAX kernel tests' own tolerance (atol 2e-6, f32 with another summation
order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
    pallas_variant as j_pv,
    qpd_sampling as jq,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    sampled_block_to_device,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    collapse_kernel as ck,
    qpd_sampling as tq,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from torch_port_common import qft_gamma_pair, to_port

ATOL = 2e-6  # test_collapse_builder_rows_exact's
L = 16


def _labels(jv, seed=3):
    uniq, _ = jq.sample_label_counts(jv, 64, seed)
    lab = np.asarray(
        np.concatenate([uniq] * (1 + L // max(1, len(uniq))))[:L], np.int32
    )
    return lab


def _draws(n_sites):
    return np.random.default_rng(7).random((L, max(1, n_sites))).astype(
        np.float32
    )


def _port_rows(tv, frag, lab, u, **kw):
    fn, pos, ns, _ = tq._collapse_row_builder_pallas(tv, frag, device="cpu",
                                                     **kw)
    rows, pos2 = fn(*sampled_block_to_device(lab, u, "cpu"))
    assert list(pos2) == list(pos)
    return fn, rows.numpy(), list(pos), ns


@pytest.fixture(scope="module")
def qft9():
    """qft-9 cut 8|1 in gamma mode (8 cp cuts), both packages, with the
    JAX rows of both fragments on 16 sampled labels."""
    jv, tv = qft_gamma_pair(9, 8)
    wide = next(r.name for r in jv.fragments
                if jv.programs[r.name].num_data_qubits >= 8)
    narrow = next(r.name for r in jv.fragments if r.name != wide)
    lab = _labels(jv)
    out = {"jv": jv, "tv": tv, "wide": wide, "narrow": narrow, "lab": lab}
    for frag in (wide, narrow):
        fx, posx, nsx, _ = jq._collapse_row_builder(jv, frag)
        u = _draws(nsx)
        rx, _ = fx(jnp.asarray(lab), jnp.asarray(u))
        out[frag] = {"xla": np.asarray(rx), "pos": list(posx), "ns": nsx,
                     "u": u, "jrows": rx}
    return out


def test_collapse_rows_match_jax_kernel(qft9):
    """The wide fragment (n = 8, 8 collapse sites): the port's rows
    against the JAX Pallas kernel's (interpret mode) and the XLA
    route's."""
    jv, tv, frag, lab = qft9["jv"], qft9["tv"], qft9["wide"], qft9["lab"]
    ref = qft9[frag]
    built = jq._collapse_row_builder_pallas(jv, frag, L)
    assert built is not None
    fp, posp, nsp, _ = built
    rp, _ = fp(jnp.asarray(lab), jnp.asarray(ref["u"]))
    fn, rows, pos, ns = _port_rows(tv, frag, lab, ref["u"])
    assert (pos, ns) == (list(posp), nsp) == (ref["pos"], ref["ns"])
    np.testing.assert_allclose(rows, np.asarray(rp), atol=ATOL)
    np.testing.assert_allclose(rows, ref["xla"], atol=ATOL)
    bits = fn.rows_fn.last_bits.numpy()
    assert bits.shape == (L, ns) and set(np.unique(bits)) <= {-1, 0, 1}
    assert (bits >= 0).any()


def test_collapse_rows_narrow_fragment(qft9):
    """The lone-qubit fragment (n = 1, 8 collapse sites): the JAX kernel
    does not serve it (None below 8 qubits); the port's kernel module
    does, against the JAX XLA collapse rows."""
    jv, tv, frag, lab = qft9["jv"], qft9["tv"], qft9["narrow"], qft9["lab"]
    assert jq._collapse_row_builder_pallas(jv, frag, L) is None
    ref = qft9[frag]
    fn, rows, pos, ns = _port_rows(tv, frag, lab, ref["u"])
    assert fn.rows_fn.plan.plan.n == 1
    assert (pos, ns) == (ref["pos"], ref["ns"])
    np.testing.assert_allclose(rows, ref["xla"], atol=ATOL)


@pytest.mark.parametrize("keep", [[0], [0, 2], [1, 3, 5], list(range(6))],
                         ids=["k0", "k02", "k135", "k0to5"])
def test_collapse_marginal_mode(qft9, keep):
    """In-kernel marginal: rows come back over the kept clbits, equal to
    the full rows composed with ``_marginalize_rows``: positions, column
    order and values."""
    jv, tv, frag, lab = qft9["jv"], qft9["tv"], qft9["wide"], qft9["lab"]
    ref = qft9[frag]
    want, wpos = jq._marginalize_rows(ref["jrows"], list(ref["pos"]),
                                      set(keep))
    fn, rows, pos, _ = _port_rows(tv, frag, lab, ref["u"],
                                  keep_clbits=set(keep))
    assert fn.rows_fn.plan.plan.mode == "marginal"
    assert pos == list(wpos) == [p for p in ref["pos"] if p in set(keep)]
    np.testing.assert_allclose(rows, np.asarray(want), atol=ATOL)


def test_collapse_marginal_mode_matches_jax_kernel(qft9):
    jv, tv, frag, lab = qft9["jv"], qft9["tv"], qft9["wide"], qft9["lab"]
    ref = qft9[frag]
    fm, posm, _, _ = jq._collapse_row_builder_pallas(jv, frag, L,
                                                     keep_clbits={1, 3, 5})
    rm, _ = fm(jnp.asarray(lab), jnp.asarray(ref["u"]))
    _, rows, pos, _ = _port_rows(tv, frag, lab, ref["u"],
                                 keep_clbits={1, 3, 5})
    assert pos == list(posm)
    np.testing.assert_allclose(rows, np.asarray(rm), atol=ATOL)


def test_collapse_marginal_splices_sources_without_ops():
    """A kept clbit whose qubit saw no op is a deterministic 0: its half
    of the marginal is zero, in the kept order."""
    rows = torch.tensor([[1.0, 2.0]])
    out = ck.splice_zero_bits(rows, [False, True])
    np.testing.assert_array_equal(out.numpy(), [[1.0, 0.0, 2.0, 0.0]])
    out = ck.splice_zero_bits(rows, [True, False])
    np.testing.assert_array_equal(out.numpy(), [[1.0, 2.0, 0.0, 0.0]])


def test_collapse_z_mode(qft9):
    """In-kernel Z columns: pre-reduced signed contributions plus the
    total column, ``z_pre`` set, against the JAX kernel's and against the
    full rows through the sign matrix."""
    jv, tv, frag, lab = qft9["jv"], qft9["tv"], qft9["wide"], qft9["lab"]
    ref = qft9[frag]
    zs = [{0}, {1, 2}, {4}, set(range(9))]
    fz, posz, _, _ = jq._collapse_row_builder_pallas(jv, frag, L, z_sets=zs)
    assert fz.z_pre
    rz, _ = fz(jnp.asarray(lab), jnp.asarray(ref["u"]))
    fn, rows, pos, _ = _port_rows(tv, frag, lab, ref["u"], z_sets=zs)
    assert fn.z_pre and pos == list(posz) == ref["pos"]
    assert rows.shape == (L, len(zs) + 1)
    np.testing.assert_allclose(rows, np.asarray(rz), atol=ATOL)
    signs = tq._z_sign_matrix(ref["pos"], zs, "cpu").numpy()
    np.testing.assert_allclose(rows[:, :-1], ref["xla"] @ signs, atol=ATOL)
    np.testing.assert_allclose(rows[:, -1], ref["xla"].sum(axis=1),
                               atol=ATOL)


def test_collapse_outcome_rule(qft9):
    """Past 128 kept outcomes or z columns the kernel does not serve the
    request (None): the caller takes full rows."""
    tv, frag = qft9["tv"], qft9["wide"]
    assert ck.build_plan(tv, frag, keep_clbits=set(range(1, 9))) is None
    assert ck.build_plan(tv, frag, keep_clbits=set(range(1, 8))) is not None
    assert ck.build_plan(tv, frag, z_sets=[{1}] * 128) is None
    with pytest.raises(ValueError, match="exclusive"):
        ck.build_plan(tv, frag, keep_clbits={1}, z_sets=[{1}])


def test_collapse_plan_matches_jax_plan(qft9):
    """Site order, slot entries and the op stream equal the JAX plan's:
    ``site_meta``, the entry gather keys, the prefix state and the step
    kinds and flat bits."""
    jv, tv, frag = qft9["jv"], qft9["tv"], qft9["wide"]
    (_call, j_tabs, j_gids, j_sites, j_prefix, j_n, _r, j_pos, j_act,
     j_src, _kept) = j_pv._build_call_collapse(jv, frag, L, interpret=True)
    plan = ck.build_plan(tv, frag)
    assert plan.n == j_n and plan.site_meta == list(j_sites)
    assert plan.positions == list(j_pos) and plan.active == list(j_act)
    assert plan.sources == list(j_src)
    assert plan.entry_gids == list(j_gids)
    for t_tab, j_tab in zip(plan.entry_tables, j_tabs):
        np.testing.assert_array_equal(
            t_tab, np.asarray(j_tab).reshape(len(j_tab), -1))
    np.testing.assert_allclose(plan.prefix.reshape(-1),
                               np.asarray(j_prefix).reshape(-1), atol=1e-6)
    # the JAX steps at final width (kind, payload, axes = active indices)
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.variant_engine import (  # noqa: E501
        make_sim_fn,
    )

    sim_one, _, _, _ = make_sim_fn(jv, frag, build_matrices=False,
                                   collapse=True, fuse_qubits=2)
    _, steps, _ = j_pv._finalize_plan_collapse(sim_one)
    assert len(steps) == len(plan.ops)
    site = 0
    for (kind, _payload, axes), row in zip(steps, plan.ops):
        nq, ja, jb, coef = (int(v) for v in row)
        bits = [j_n - 1 - a for a in axes]
        if kind == "collapse":
            assert (nq, ja, jb) == (0, bits[0], site)
            site += 1
        else:
            assert nq == len(axes) and [ja, jb][:nq] == bits
            assert (coef < 0) == (kind != "u")
    assert site == len(j_sites)


@pytest.fixture(scope="module")
def wire_cut():
    circ = j_gen_circ("ghz", 18, 1)
    cutter = JCutter(circ, maxNPartitions=2, maxNQubitsPerPartition=10,
                     forceNWireCuts=1, maxNQpdCuts=3, maxNCuts=3)
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    jv = JVirtualCircuit(cut)
    return jv, TVirtualCircuit(to_port(cut)), _labels(jv)


@pytest.mark.parametrize("which", [0, 1])
def test_collapse_rows_wire_cut(wire_cut, which):
    """A wire cut (8 variants): the measuring endpoint carries a collapse
    site, the prep endpoint has none; both against the JAX rows."""
    jv, tv, lab = wire_cut
    frag = jv.fragments[which].name
    assert jv.programs[frag].num_data_qubits >= 8
    fx, posx, nsx, _ = jq._collapse_row_builder(jv, frag)
    fp, posp, nsp, _ = jq._collapse_row_builder_pallas(jv, frag, L)
    u = _draws(nsx)
    rx, _ = fx(jnp.asarray(lab), jnp.asarray(u))
    rp, _ = fp(jnp.asarray(lab), jnp.asarray(u))
    _, rows, pos, ns = _port_rows(tv, frag, lab, u)
    assert (pos, ns) == (list(posx), nsx) == (list(posp), nsp)
    np.testing.assert_allclose(rows, np.asarray(rx), atol=ATOL)
    np.testing.assert_allclose(rows, np.asarray(rp), atol=ATOL)


def test_wire_cut_has_a_site_on_one_endpoint_only(wire_cut):
    _, tv, _ = wire_cut
    sites = [len(ck.build_plan(tv, r.name).site_meta) for r in tv.fragments]
    assert sorted(sites) == [0, 1]


def test_collapse_rows_wrapper_routes_by_device(qft9):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; a tensor on another device type is refused."""
    tv, frag, lab = qft9["tv"], qft9["wide"], qft9["lab"]
    dp = ck.CollapseDevicePlan(ck.build_plan(tv, frag), "cpu")
    ent = dp.gather_entries(torch.as_tensor(lab, dtype=torch.int64))
    cscal = torch.rand((L, dp.plan.n_sites, 4))
    before = ck.collapse_rows.launches
    got, bits = ck.collapse_rows(dp, ent, cscal)
    want, wbits = ck.plain_collapse_rows(dp, ent, cscal)
    assert ck.collapse_rows.launches == before
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(bits.numpy(), wbits.numpy())
    with pytest.raises(ValueError, match="unsupported device"):
        ck.collapse_rows(dp, ent.to("meta"), cscal.to("meta"))


def test_collapse_rows_preserve_total_and_follow_mflag(qft9):
    """Collapse keeps a row's total (the rescale undoes the projection),
    a site with mflag <= 0 changes nothing, and the work count follows
    the measuring sites."""
    tv, frag, lab = qft9["tv"], qft9["wide"], qft9["lab"]
    plan = ck.build_plan(tv, frag)
    dp = ck.CollapseDevicePlan(plan, "cpu")
    ent = dp.gather_entries(torch.as_tensor(lab, dtype=torch.int64))
    cscal = torch.ones((L, plan.n_sites, 4))
    cscal[:, :, 0] = torch.as_tensor(_draws(plan.n_sites))
    on, bits_on = ck.plain_collapse_rows(dp, ent, cscal)
    cscal_off = cscal.clone()
    cscal_off[:, :, 1] = 0.0
    off, bits_off = ck.plain_collapse_rows(dp, ent, cscal_off)
    np.testing.assert_allclose(on.sum(dim=1).numpy(),
                               off.sum(dim=1).numpy(), atol=1e-5)
    assert (bits_off == -1).all() and (bits_on >= 0).all()
    full = ck.work_counts(plan, ent, cscal)
    none = ck.work_counts(plan, ent, cscal_off)
    big = 1 << plan.n
    # every label its own run here: a measuring site adds its sums, its
    # projection and its rescale (7 an amplitude) on top of the same gates
    assert full["runs"] == none["runs"] == L
    assert full["flops"] - none["flops"] == L * len(plan.site_meta) * 7 * big
    assert full["bytes"] == none["bytes"]
