"""The torch port's streamed scan without a kernel (``engine="streamed"``)
on the CPU against the JAX package's ``ops/streamed.py``
(``pallas_variant=False``): the same circuits, cut by the JAX cutter and
carried into the port.  f32 values within 1e-6; split plans, suffix
stages, stage alignment and fusion widths equal field by field;
truncation keeps the same labels; bf16 within 5e-3 (total variation) of
f32 (the JAX bf16 test's bound); carry checkpoints resume; the results
fingerprint, numpy shot counts and the sampled batched route as in the
JAX package."""
import numpy as np
import pytest
import torch

import jax

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
    Circuit as JCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (
    sampling as jsampling,
    streamed as js,
    variant_engine as jve,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
    Distribution as JDistribution,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.run import (
    run_virtual_circuit as j_run,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.utils.checkpoint import (  # noqa: E501
    checkpoint_fingerprint as j_fingerprint,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch import (
    run as trun,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
    hellinger_fidelity,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    sampling as tsampling,
    streamed as ts,
    variant_engine as tve,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
    Distribution,
    simulate_circuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.utils.checkpoint import (  # noqa: E501
    checkpoint_fingerprint,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from torch_port_common import CUT_KW, cut_pair, to_port

ATOL = 1e-6


def _pair_of(jcirc, cap):
    cutter = JCutter(jcirc, maxNPartitions=2, maxNQubitsPerPartition=cap,
                     **CUT_KW)
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    return (jcirc, to_port(jcirc), JVirtualCircuit(cut),
            TVirtualCircuit(to_port(cut)))


def _angled_hwe(n, depth, cap, seed=1):
    """The hardware-efficient ansatz with its u angles drawn from
    ``default_rng(seed)`` (genCirc's own leave most rotations the
    identity), cut by the JAX cutter."""
    circ = j_gen_circ("hwe", n, depth, seed=0)
    rng = np.random.default_rng(seed)
    for ins in circ.instructions:
        if ins.name == "u":
            ins.params = [float(a) for a in rng.uniform(-np.pi, np.pi, 3)]
    return _pair_of(circ, cap)


def _skewed(n=6):
    """cp cuts with small angles: sharply skewed coefficient products
    (tests/test_truncation.py's circuit)."""
    circ = JCircuit(n, n)
    for q in range(n):
        circ.h(q)
    circ.cp(np.pi / 8, 0, n - 1)
    circ.cp(np.pi / 16, 1, n - 2)
    for i in range(n - 1):
        circ.cx(i, i + 1)
    for q in range(n):
        circ.measure(q, q)
    return circ


_CACHE = {}


def _case(key):
    if key not in _CACHE:
        _CACHE[key] = {
            # 12 qubits, 3 cz cuts, two 9/8-qubit fragments
            "sup12": lambda: cut_pair("sup", 12, 1, 7, seed=1,
                                      maxNQpdCuts=3, maxNCuts=3,
                                      maxCutsPerPartitions=3),
            # 10 qubits, several cx cuts: multi-level staging
            "hwe10": lambda: _angled_hwe(10, 3, 6),
            "hwe8": lambda: _angled_hwe(8, 2, 5),
            "skewed": lambda: _pair_of(_skewed(), 4),
        }[key]()
    return _CACHE[key]


def _jax_values(jv, chunk, **kw):
    step, xs, meta = js.make_streamed_knit(jv, chunk, **kw)
    return np.asarray(jax.jit(step)(xs)), meta


def _stages_key(stages):
    if stages is None:
        return None
    return [(st.r_out, st.m_in, list(st.sids), len(st.steps))
            for st in stages]


def _split_key(sp):
    if sp is None:
        return None
    return (sp.shared, sp.astrides, sp.n_anc, sp.split_idx, sp.m_split,
            len(sp.prefix_steps), len(sp.suffix_steps), sp.bank_bytes,
            sp.est_bytes, sp.est_flat_bytes, sp.build_bytes)


@pytest.mark.parametrize("sharing,mode", [
    ("flat", "full"), ("banks", "full"), ("hoisted", "full"),
    ("banks", "keep"), ("hoisted", "z"),
])
def test_streamed_matches_jax(sharing, mode):
    """Values within 1e-6 of JAX's scan without a kernel, with banks off,
    on, and hoisted (``step_fn(xs, bank_fn())``); the full
    distribution, a marginal and a Z contraction."""
    _, _, jv, tv = _case("sup12")
    chunk = 72
    kw = {"flat": {}, "banks": dict(share_prefix=True),
          "hoisted": dict(share_prefix=True, hoist_banks=True)}[sharing]
    kw.update({"full": {}, "keep": dict(keep_clbits={1, 4, 5, 9, 10}),
               "z": dict(z_clbits=frozenset({1, 4, 9}))}[mode])
    want, jmeta = _jax_values(jv, chunk, **kw)
    step, xs, meta = ts.make_streamed_knit(tv, chunk, device="cpu", **kw)
    got = step(xs) if sharing != "hoisted" else step(xs, meta["bank_fn"]())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert meta["positions"] == jmeta["positions"]
    assert [_split_key(s) for s in meta["splits"]] == \
        [_split_key(s) for s in jmeta["splits"]]
    assert (meta["bank_fn"] is None) == (sharing == "flat")
    assert meta["pallas_fragments"] == jmeta["pallas_fragments"]


def test_staged_suffix_multi_stage_matches_jax():
    """A bank budget that forces a shallow split leaves several vgates in
    the suffix: aligned chunks engage a multi-level group ladder, an
    unaligned one stages per label; every chunk within 1e-6 of JAX and
    of the flat scan, the stages and alignment equal to JAX's."""
    _, _, jv, tv = _case("hwe10")
    flat_step, flat_xs, _ = ts.make_streamed_knit(tv, 36, device="cpu")
    flat = flat_step(flat_xs).numpy()
    engaged = False
    for chunk in (36, 72, 32):
        kw = dict(share_prefix=True, bank_budget_bytes=1 << 14,
                  hoist_banks=True)
        want, jmeta = _jax_values(jv, chunk, **kw)
        step, xs, meta = ts.make_streamed_knit(tv, chunk, device="cpu",
                                               **kw)
        got = step(xs).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL,
                                   err_msg=f"chunk={chunk}")
        np.testing.assert_allclose(got, flat, atol=ATOL)
        np.testing.assert_allclose(step(xs, meta["bank_fn"]()).numpy(),
                                   want, atol=ATOL)
        assert meta["stage_align"] == jmeta["stage_align"]
        assert [_stages_key(s) for s in meta["stages"]] == \
            [_stages_key(s) for s in jmeta["stages"]]
        for st in meta["stages"]:
            if st is not None and chunk % meta["stage_align"] == 0:
                engaged |= any(t.r_out > 1 for t in st)
            if st is not None and chunk == 32:
                assert all(t.r_out == 1 for t in st)
    assert engaged, "aligned chunks never engaged a >1 group ladder"


@pytest.mark.parametrize("key", ["sup12", "hwe10", "skewed"])
def test_planners_equal_jax(key):
    """split_plan (flat-scored, hoisted, bf16-sized, tight budget),
    suffix_stages at several chunks, ideal_stage_align and the fusion
    width pick, fragment by fragment, field by field."""
    _, _, jv, tv = _case(key)
    specs_j = [vg.spec for vg in jv.vgates]
    specs_t = [vg.spec for vg in tv.vgates]
    gstride, _, total = tve.label_strides(specs_t, range(len(specs_t)))
    assert (gstride, total) == jve.label_strides(
        specs_j, range(len(specs_j)))[::2]
    for reg in tv.fragments:
        name = reg.name
        fq = ts._pick_fuse_qubits(tv, name, None)
        assert fq == js._pick_fuse_qubits(jv, name, None, True, None)
        for hoisted, state_bytes, budget in ((False, 4, 512 << 20),
                                             (True, 4, 512 << 20),
                                             (False, 2, 1 << 30),
                                             (True, 4, 1 << 14)):
            sim_t, _, _, _ = tve.make_sim_fn(tv, name, build_matrices=False,
                                             fused_slots=True,
                                             fuse_qubits=fq)
            sim_j, _, _, _ = jve.make_sim_fn(jv, name, build_matrices=False,
                                             fused_slots=True,
                                             fuse_qubits=fq)
            sp_t = tve.split_plan(sim_t, tv.programs[name], specs_t, total,
                                  budget, hoisted=hoisted,
                                  state_bytes=state_bytes)
            sp_j = jve.split_plan(sim_j, jv.programs[name], specs_j, total,
                                  budget, hoisted=hoisted,
                                  state_bytes=state_bytes)
            assert _split_key(sp_t) == _split_key(sp_j)
            if sp_t is None:
                continue
            assert [s[0] for s in sp_t.suffix_steps] == \
                [s[0] for s in sp_j.suffix_steps]
            for chunk in (-1, 0, 1, 6, 36, 72, 216, 32):
                st_t, r_t = tve.suffix_stages(sp_t, tv.programs[name],
                                              specs_t, gstride, chunk)
                st_j, r_j = jve.suffix_stages(sp_j, jv.programs[name],
                                              specs_j, gstride, chunk)
                assert (_stages_key(st_t), r_t) == (_stages_key(st_j), r_j)
            assert tve.ideal_stage_align(sp_t, tv.programs[name], specs_t,
                                         gstride) == jve.ideal_stage_align(
                sp_j, jv.programs[name], specs_j, gstride)


def test_trunc_eps_keeps_jax_labels_within_bound():
    """Certified truncation: the same kept label ids and dropped mass as
    JAX, values within 1e-6 of JAX's truncated scan, and within the
    certified L1 bound of the exact result."""
    _, _, jv, tv = _case("skewed")
    specs = [vg.spec for vg in tv.vgates]
    gstride, n_inst, total = tve.label_strides(specs, range(len(specs)))
    exact = ts.run_virtual_circuit_streamed(tv, chunk=32, device="cpu")
    for eps in (1e-4, 1e-2, 5e-2):
        kept, dropped = tve.truncate_labels(specs, gstride, n_inst, total,
                                            eps)
        jkept, jdropped = jve.truncate_labels(
            [vg.spec for vg in jv.vgates], gstride, n_inst, total, eps)
        np.testing.assert_array_equal(kept, jkept)
        assert dropped == jdropped <= eps
        want, jmeta = _jax_values(jv, 32, trunc_eps=eps, share_prefix=True)
        step, xs, meta = ts.make_streamed_knit(tv, 32, trunc_eps=eps,
                                               share_prefix=True,
                                               device="cpu")
        got = step(xs).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
        assert (meta["kept_labels"], meta["dropped_mass"],
                meta["stage_align"]) == (jmeta["kept_labels"],
                                         jmeta["dropped_mass"],
                                         jmeta["stage_align"])
        assert float(np.abs(got - exact.values).sum()) \
            <= meta["dropped_mass"] + 1e-5
        if eps >= 1e-2:
            assert meta["kept_labels"] < meta["global_labels"]


@pytest.mark.parametrize("name,n,depth,cap", [
    ("hwe", 8, 2, 5), ("aqft", 6, 2, 5), ("add", 6, 1, 5),
])
def test_bf16_within_5e3_of_f32(name, n, depth, cap):
    """bf16 states and banks against the f32 result of the same scan, on
    tests/test_bf16_serving.py's circuits (gate cuts; gate and wire cuts;
    wire cuts and deferral ancillas): total variation < 5e-3, float32
    output; the banks are bf16 and the knit float32."""
    _, _, _, tv = cut_pair(name, n, depth, cap, seed=None)
    f32 = ts.run_virtual_circuit_streamed(tv, chunk=32, device="cpu")
    b16 = ts.run_virtual_circuit_streamed(tv, chunk=32, device="cpu",
                                          dtype=torch.bfloat16)
    assert b16.bit_positions == f32.bit_positions
    assert b16.values.dtype == np.float32
    assert 0.5 * float(np.abs(f32.values - b16.values).sum()) < 5e-3
    step, xs, meta = ts.make_streamed_knit(tv, 32, device="cpu",
                                           share_prefix=True,
                                           hoist_banks=True,
                                           dtype=torch.bfloat16)
    if meta["bank_fn"] is not None:
        banks = meta["bank_fn"]()
        assert all(b.dtype == torch.bfloat16 for b in banks if b.numel())
        np.testing.assert_allclose(step(xs, banks).numpy(), f32.values,
                                   atol=5e-3)


def test_bf16_no_worse_than_jax_on_dense_rotations():
    """On circuits with dense rotations (u angles drawn at random) bf16's
    rounding moves the result further: total variation 4-5e-3 here,
    JAX's own bf16 7-9e-3 on the same circuits.  The port rounds once a
    pass (each gate combined in f32 from bf16 storage), so it stays no
    worse than the JAX package's bf16 on each."""
    import jax.numpy as jnp

    for key in ("hwe8", "sup12"):
        _, _, jv, tv = _case(key)
        f32 = ts.run_virtual_circuit_streamed(tv, chunk=32, device="cpu")
        b16 = ts.run_virtual_circuit_streamed(tv, chunk=32, device="cpu",
                                              dtype=torch.bfloat16)
        jb16 = js.run_virtual_circuit_streamed(jv, chunk=32,
                                               dtype=jnp.bfloat16)
        tv_port = 0.5 * float(np.abs(f32.values - b16.values).sum())
        tv_jax = 0.5 * float(np.abs(f32.values
                                    - np.asarray(jb16.values)).sum())
        print(f"{key}: bf16 total variation, port {tv_port:.3e}, "
              f"JAX {tv_jax:.3e}")
        assert tv_port <= tv_jax, (key, tv_port, tv_jax)


def test_streamed_checkpoint_resume(tmp_path):
    """Segmented carry checkpoints (tests/test_streamed_full.py's
    resume): the resumed result equals the plain one; a planted complete
    checkpoint with a doubled carry is used as it stands; a stale
    fingerprint is ignored.  The digest equals JAX's."""
    _, _, jv, tv = _case("sup12")
    want = ts.run_virtual_circuit_streamed(tv, chunk=8, device="cpu")
    ckpt = tmp_path / "stream"
    got = ts.run_virtual_circuit_streamed(tv, chunk=8, device="cpu",
                                          checkpoint_dir=ckpt,
                                          segment_chunks=2)
    np.testing.assert_allclose(got.values, want.values, atol=ATOL)
    assert (ckpt / "stream_carry.npz").exists()

    chunk = ts.auto_chunk(tv, 8)
    _, xs, meta = ts.make_streamed_knit(tv, chunk, device="cpu",
                                        share_prefix=True)
    seg = 2
    nseg = -(-meta["n_chunks"] // seg)
    fp = ts._stream_fingerprint(tv, chunk, seg, 0)
    assert fp == js._stream_fingerprint(jv, chunk, seg, [None, None], None,
                                        0)
    carry = meta["segment_fn"](torch.zeros(meta["carry_shape"]), xs)
    ts._save_stream_checkpoint(ckpt, fp, carry.numpy() * 2.0, nseg)
    doubled = ts.run_virtual_circuit_streamed(
        tv, chunk=8, device="cpu", checkpoint_dir=ckpt, segment_chunks=seg)
    np.testing.assert_allclose(doubled.values, 2.0 * want.values, atol=1e-5)

    ts._save_stream_checkpoint(ckpt, "not-the-fingerprint",
                               carry.numpy() * 2.0, nseg)
    clean = ts.run_virtual_circuit_streamed(
        tv, chunk=8, device="cpu", checkpoint_dir=ckpt, segment_chunks=seg)
    np.testing.assert_allclose(clean.values, want.values, atol=ATOL)


def test_interrupted_run_resumes_from_its_carry(tmp_path):
    """A run stopped after its first segment (segments driven by hand, as
    ``_run_segments`` drives them) resumes to the uninterrupted result."""
    _, _, _, tv = _case("hwe8")
    chunk, seg = 8, 2
    want = ts.run_virtual_circuit_streamed(tv, chunk=chunk, device="cpu")
    _, xs, meta = ts.make_streamed_knit(tv, chunk, device="cpu",
                                        share_prefix=True)
    assert meta["n_chunks"] > seg
    fp = ts._stream_fingerprint(tv, chunk, seg, 0)
    carry = meta["segment_fn"](torch.zeros(meta["carry_shape"]),
                               tuple(a[:seg] for a in xs))
    ts._save_stream_checkpoint(tmp_path, fp, carry.numpy(), 1)
    resumed = ts.run_virtual_circuit_streamed(
        tv, chunk=chunk, device="cpu", checkpoint_dir=tmp_path,
        segment_chunks=seg)
    np.testing.assert_allclose(resumed.values, want.values, atol=ATOL)


@pytest.mark.parametrize("key", ["sup12", "hwe10", "skewed"])
def test_checkpoint_fingerprint_equals_jax(key):
    _, _, jv, tv = _case(key)
    assert checkpoint_fingerprint(tv) == j_fingerprint(jv)
    assert checkpoint_fingerprint(tv, dtype=torch.bfloat16) == \
        j_fingerprint(jv, dtype=jax.numpy.bfloat16)
    assert checkpoint_fingerprint(tv, dtype=torch.float32) == \
        checkpoint_fingerprint(tv)


def test_sample_distribution_counts_equal_jax():
    rng = np.random.default_rng(3)
    vals = rng.random(64).astype(np.float32)
    vals[:5] = 0.0
    got = tsampling.sample_distribution(
        Distribution(vals, list(range(6)), 6), 20000, seed=11)
    want = jsampling.sample_distribution(
        JDistribution(vals, list(range(6)), 6), 20000, seed=11)
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    with pytest.raises(ValueError, match="nonpositive"):
        tsampling.sample_distribution(
            Distribution(np.zeros(4, np.float32), [0, 1], 2), 10)


def _marginal(dist, keep):
    """The oracle's marginal on ``keep`` as a {key: probability} dict."""
    mask = sum(1 << c for c in keep)
    out = {}
    for key, p in dist.to_dict().items():
        out[key & mask] = out.get(key & mask, 0.0) + p
    return out


def test_device_shots_sum_to_one_near_the_oracle():
    """Shots without a checkpoint: projection and inverse-CDF draws on the
    device; non-negative counts summing to 1 within 1e-6; on a 5-clbit
    marginal (32 outcomes: 20000 shots resolve it, where 4096 outcomes
    would leave the fidelity near 0.93 from sampling alone) fidelity >
    0.995 against the oracle's; the same seed draws the same counts."""
    jc, tc, _, tv = _case("sup12")
    keep = [1, 4, 5, 9, 10]
    oracle = _marginal(simulate_circuit(tc, device="cpu"), keep)
    dist, info = trun.run_virtual_circuit(tv, engine="streamed", shots=20000,
                                          chunk_size=72, device="cpu",
                                          keep_clbits=keep)
    assert info.knit_time == 0.0 and dist.bit_positions == keep
    assert (dist.values >= 0).all()
    assert abs(float(dist.values.sum()) - 1.0) < 1e-6
    assert hellinger_fidelity(oracle, dist) > 0.995
    idx = tsampling.sample_indices_device(
        torch.tensor([0.0, 0.25, 0.0, 0.75]), 4000,
        torch.Generator().manual_seed(0))
    assert set(idx.tolist()) <= {1, 3}
    again, _ = trun.run_virtual_circuit(tv, engine="streamed", shots=20000,
                                        chunk_size=72, device="cpu",
                                        keep_clbits=keep)
    np.testing.assert_array_equal(again.values, dist.values)


def test_checkpointed_shots_draw_with_numpy(tmp_path):
    _, _, _, tv = _case("sup12")
    exact = ts.run_virtual_circuit_streamed(tv, chunk=72, device="cpu",
                                            project=True)
    got = ts.run_virtual_circuit_streamed(tv, chunk=72, device="cpu",
                                          shots=5000, seed=4,
                                          checkpoint_dir=tmp_path)
    want = tsampling.sample_distribution(exact, 5000, 4)
    np.testing.assert_allclose(got.values, want.values, atol=1e-6)


def test_batched_route_shots_and_checkpoint(tmp_path):
    """engine="xla" with ``shots`` (variant rows sampled on the device)
    near the oracle, and with ``checkpoint_dir``: results saved, loaded
    on a rerun (equal to JAX's batched checkpointed run), a stale
    checkpoint re-simulated."""
    jc, tc, jv, tv = _case("sup12")
    keep = [1, 4, 5, 9, 10]
    shot, _ = trun.run_virtual_circuit(tv, engine="xla", shots=20000,
                                       device="cpu", keep_clbits=keep)
    # sampled rows knit to a mass near, not at, 1 (the JAX package's too)
    assert abs(float(shot.values.sum()) - 1.0) < 0.05
    assert hellinger_fidelity(
        _marginal(simulate_circuit(tc, device="cpu"), keep), shot) > 0.99
    want, _ = j_run(jv, engine="xla", checkpoint_dir=tmp_path / "jax")
    first, _ = trun.run_virtual_circuit(tv, engine="xla", device="cpu",
                                        checkpoint_dir=tmp_path / "t")
    assert (tmp_path / "t" / "fragment_results.json").exists()
    calls = []
    real = tve.run_all_fragments
    try:
        tve.run_all_fragments = lambda *a, **k: calls.append(1) or real(
            *a, **k)
        again, _ = trun.run_virtual_circuit(tv, engine="xla", device="cpu",
                                            checkpoint_dir=tmp_path / "t")
        assert calls == []
        np.testing.assert_allclose(again.values, first.values, atol=0)
        np.testing.assert_allclose(again.values, want.values, atol=ATOL)
        # another circuit's results in the directory: re-simulated
        _, _, _, other = _case("hwe8")
        trun.run_virtual_circuit(other, engine="xla", device="cpu",
                                 checkpoint_dir=tmp_path / "t")
        assert calls == [1]
    finally:
        tve.run_all_fragments = real


def test_run_streamed_matches_jax_engine_streamed():
    """run_virtual_circuit(engine="streamed") end to end against JAX's,
    projected, with a marginal."""
    jc, tc, jv, tv = _case("sup12")
    for kw in ({}, dict(keep_clbits=[1, 4, 9])):
        want, _ = j_run(jv, engine="streamed", chunk_size=72, **kw)
        got, info = trun.run_virtual_circuit(tv, engine="streamed",
                                             chunk_size=72, device="cpu",
                                             **kw)
        assert got.bit_positions == want.bit_positions
        np.testing.assert_allclose(got.values, want.values, atol=ATOL)
        if not kw:
            assert hellinger_fidelity(simulate_circuit(tc, device="cpu"),
                                      got) > 1 - 1e-6


@pytest.mark.parametrize("why", ["labels", "trunc_eps", "dtype"])
def test_auto_routes_as_jax(monkeypatch, why):
    """engine="auto" takes the scan without a kernel above the label
    threshold (lowered here), for trunc_eps and for bf16, as JAX
    run.py:283-300 does; the batched engine otherwise."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu import (
        run as jrun,
    )

    _, _, jv, tv = _case("skewed")
    calls = []
    real = ts.make_streamed_knit
    monkeypatch.setattr(ts, "make_streamed_knit", lambda *a, **k: calls.append(
        k["pallas_variant"]) or real(*a, **k))
    kw = {"labels": {}, "trunc_eps": dict(trunc_eps=1e-3),
          "dtype": dict(dtype=torch.bfloat16)}[why]
    if why == "labels":
        monkeypatch.setattr(trun, "AUTO_STREAM_LABELS", 5)
        monkeypatch.setattr(jrun, "AUTO_STREAM_LABELS", 5)
        want, _ = jrun.run_virtual_circuit(jv, engine="auto")
    elif why == "trunc_eps":
        want, _ = jrun.run_virtual_circuit(jv, engine="auto", trunc_eps=1e-3)
    got, info = trun.run_virtual_circuit(tv, engine="auto", device="cpu",
                                         **kw)
    assert calls == [False] and info.knit_time == 0.0
    if why != "dtype":
        np.testing.assert_allclose(got.values, want.values, atol=ATOL)
    monkeypatch.setattr(trun, "AUTO_STREAM_LABELS", 16384)
    below, info = trun.run_virtual_circuit(tv, engine="auto", device="cpu")
    assert calls == [False] and info.knit_time > 0.0


def test_pallas_refuses_trunc_eps_and_bf16():
    """engine="pallas" is float32 and exact: trunc_eps raises JAX's
    ValueError, bf16 a ValueError naming engine="streamed"."""
    _, _, jv, tv = _case("skewed")
    with pytest.raises(ValueError, match="trunc_eps"):
        j_run(jv, engine="pallas", trunc_eps=1e-3)
    with pytest.raises(ValueError, match="streamed-engine feature, not "
                                         "engine='pallas'"):
        trun.run_virtual_circuit(tv, engine="pallas", trunc_eps=1e-3,
                                 device="cpu")
    with pytest.raises(ValueError, match='engine="streamed"'):
        trun.run_virtual_circuit(tv, engine="pallas", dtype=torch.bfloat16,
                                 device="cpu")
    with pytest.raises(ValueError, match='engine="streamed"'):
        ts.make_streamed_knit(tv, 32, pallas_variant=True,
                              dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="not engine='xla'"):
        trun.run_virtual_circuit(tv, engine="xla", dtype=torch.bfloat16,
                                 device="cpu")


def test_new_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without ``device=`` the scan without a kernel, its shots and
    checkpoints, and the sampled batched route ask for CUDA and raise
    when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, tv = _case("skewed")
    for call in (
        lambda: ts.run_virtual_circuit_streamed(tv, chunk=32),
        lambda: ts.run_virtual_circuit_streamed(tv, chunk=32, shots=10),
        lambda: ts.run_virtual_circuit_streamed(tv, chunk=32,
                                                checkpoint_dir=tmp_path),
        lambda: ts.streamed_expectation_z(tv, [0], chunk=32),
        lambda: ts.make_streamed_knit(tv, 32, dtype=torch.bfloat16),
        lambda: trun.run_virtual_circuit(tv, engine="streamed"),
        lambda: trun.run_virtual_circuit(tv, engine="auto", trunc_eps=1e-3),
        lambda: trun.run_virtual_circuit(tv, engine="xla", shots=10),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_stored_sup25_plan_is_the_jax_cutters_plan():
    """The stored sup-25 plan (solved once by the port's solver, 12 s on
    a CPU) equals the plan the JAX package's native solver returns for
    the same circuit, and cuts sup-25 into fragments of 18 and 17
    simulated qubits over 10368 labels (4 gate cuts, 1 wire cut)."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.solver import (  # noqa: E501
        plan_signature as j_plan_signature,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.solver import (  # noqa: E501
        plan_signature,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.plans import (  # noqa: E501
        load_plan,
    )

    plan = load_plan("sup25_p2_q13")
    kw = dict(maxNPartitions=2, maxNQubitsPerPartition=13, **CUT_KW)
    jcut = JCutter(j_gen_circ("sup", 25, 1, seed=0), **kw)
    assert jcut.solve()
    assert plan_signature(plan) == j_plan_signature(jcut.plan)
    cutter = Cutter(genCirc("sup", 25, 1, seed=0), **kw)
    cutter.use_plan(plan)
    virt = TVirtualCircuit(cutter.getResultCircs()[3])
    assert [virt.programs[r.name].num_sim_qubits
            for r in virt.fragments] == [18, 17]
    assert [vg.spec.num_instantiations for vg in virt.vgates] == \
        [6, 8, 6, 6, 6]
    assert (cutter.nGateCuts, cutter.nWireCuts) == (4, 1)


def test_hellinger_fidelity_of_arrays_equals_the_dict_form():
    """Two distributions over the same clbits are compared as arrays
    (a 2^25-outcome dict costs minutes): the same number as the dict
    form, negative entries excluded from overlap and mass."""
    rng = np.random.default_rng(0)
    p = Distribution(rng.normal(size=256).astype(np.float32),
                     list(range(8)), 8)
    q = Distribution(np.abs(rng.normal(size=256)).astype(np.float32),
                     list(range(8)), 8)
    assert hellinger_fidelity(p, q) == pytest.approx(
        hellinger_fidelity(p.to_dict(), q.to_dict()), rel=1e-12)
    assert hellinger_fidelity(q, q) == pytest.approx(1.0, rel=1e-12)


def test_split_fns_compose_to_the_flat_rows():
    """make_prefix_fn: the prefix to the split, then the plan's suffix
    steps and the finished row, gives every variant's flat rows (within
    1e-6), for each fragment of a cut whose plans split."""
    _, _, _, tv = _case("hwe10")
    specs = [vg.spec for vg in tv.vgates]
    _, _, total = tve.label_strides(specs, range(len(specs)))
    for reg in tv.fragments:
        sim_fn, mats, _, _ = tve.make_sim_fn(tv, reg.name,
                                             fused_slots=True)
        sp = tve.split_plan(sim_fn, tv.programs[reg.name], specs, total,
                            1 << 14, hoisted=True)
        assert sp is not None
        blocks = {sid: tuple(torch.as_tensor(t) for t in tabs)
                  for sid, tabs in enumerate(mats)}
        flat = sim_fn([blocks[sid] for sid in range(len(mats))])
        states = tve.make_prefix_fn(sim_fn, sp)(blocks)
        assert states.shape[-1] == 1 << sp.m_split
        states, m = tve.exec_plan_steps(states, sp.m_split, sp.suffix_steps,
                                        blocks, slot_masks=sim_fn.slot_masks)
        rows = tve.finish_row(states, m, sim_fn.active_final, sim_fn.sources)
        torch.testing.assert_close(rows, flat, atol=ATOL, rtol=0)


def bf16_witness(n: int, cap: int, chunk: int = 64) -> dict:
    """bf16's total variation against float32 at a wider cut: sup-``n``
    (genCirc seed 0) cut into 2 partitions of ``cap`` qubits, the port's
    bf16 against the port's f32 and the JAX package's bf16 against its
    own f32, unprojected.  A witness that the port's rounding adds no
    error beyond the JAX package's at widths the CPU tests do not reach:
    ``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_streamed.py
    20 10`` prints one JSON line (sup-20: 15-qubit fragments, about 80 s
    on a CPU)."""
    import jax.numpy as jnp

    _, _, jv, tv = cut_pair("sup", n, 1, cap, seed=0)

    def dist(vals):
        return np.asarray(vals, np.float64)

    jf = dist(js.run_virtual_circuit_streamed(jv, chunk, project=False)
              .values)
    jb = dist(js.run_virtual_circuit_streamed(jv, chunk, project=False,
                                              dtype=jnp.bfloat16).values)
    tf = dist(ts.run_virtual_circuit_streamed(tv, chunk, project=False,
                                              device="cpu").values)
    tb = dist(ts.run_virtual_circuit_streamed(tv, chunk, project=False,
                                              device="cpu",
                                              dtype=torch.bfloat16).values)
    return {
        "circuit": f"sup-{n}", "cap": cap, "chunk": chunk,
        "fragment_sim_qubits": [tv.programs[r.name].num_sim_qubits
                                for r in tv.fragments],
        "labels": int(np.prod([vg.spec.num_instantiations
                               for vg in tv.vgates])),
        "tv_port": 0.5 * float(np.abs(tb - tf).sum()),
        "tv_jax": 0.5 * float(np.abs(jb - jf).sum()),
        "f32_port_vs_jax": float(np.abs(tf - jf).max()),
    }


def test_bf16_witness_no_worse_than_jax():
    """The bf16 witness on sup-12 (9-qubit fragments): the port's bf16
    error against its own f32 no larger than the JAX package's against
    its own, and the two f32 results within 1e-6."""
    w = bf16_witness(12, 7)
    assert w["f32_port_vs_jax"] <= ATOL
    assert w["tv_port"] <= w["tv_jax"], w


if __name__ == "__main__":
    import json
    import sys

    print(json.dumps(bf16_witness(*(int(a) for a in sys.argv[1:3]))))


@pytest.mark.parametrize("name,n,depth,cap", [
    ("hwe", 8, 2, 5),     # multiple gate cuts
    ("aqft", 6, 2, 5),    # gate + wire cuts
    ("add", 6, 1, 5),     # adder: wire cuts + deferral ancillas
])
def test_fused_slots_match_unfused(name, n, depth, cap):
    """The JAX keyword ``fused_slots`` (tests/test_shared_prefix.py's
    twin): one composed block a slot, or the pre, measure and post
    blocks apart, with banks off and on; each within 1e-6 of JAX's scan
    with the same keywords."""
    _, _, jv, tv = _pair_of(j_gen_circ(name, n, depth), cap)
    for fused in (False, True):
        for share in (False, True):
            want, _ = _jax_values(jv, 32, share_prefix=share,
                                  fused_slots=fused)
            step, xs, _ = ts.make_streamed_knit(
                tv, 32, share_prefix=share, fused_slots=fused, device="cpu")
            np.testing.assert_allclose(step(xs).numpy(), want, atol=ATOL,
                                       err_msg=str((fused, share)))


def test_streamed_knit_takes_fuse_qubits_and_pallas_staged():
    """The JAX keywords ``fuse_qubits`` (a fixed width, or "auto": the
    byte model) and ``pallas_staged`` (the variant kernel without its
    per-slot checkpoints: the same rows, here from its plain version)."""
    _, _, jv, tv = _case("hwe8")
    for fq in (3, 5, "auto"):
        want, _ = _jax_values(jv, 32, fuse_qubits=fq)
        step, xs, meta = ts.make_streamed_knit(tv, 32, fuse_qubits=fq,
                                               device="cpu")
        if fq != "auto":
            assert set(meta["fuse_qubits"].values()) == {fq}
        np.testing.assert_allclose(step(xs).numpy(), want, atol=ATOL)
    rows = {}
    for staged in (True, False):
        step, xs, meta = ts.make_streamed_knit(
            tv, 32, pallas_variant=True, pallas_staged=staged, device="cpu")
        assert all(p.plan.staged == staged
                   for p in meta["fragment_plans"].values())
        rows[staged] = step(xs).numpy()
    np.testing.assert_allclose(rows[False], rows[True], atol=ATOL)
    np.testing.assert_allclose(rows[True], want, atol=ATOL)
