"""The torch port's host layers against the JAX package's: the same
generator and cutter give the same plan, fragments, fused streams, slot
tables, label tables and fold weights; circuits round-trip through
``convert``."""
import numpy as np
import pytest

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.cutter import (  # noqa: E501
    Cutter as JCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.cutter.solver import (  # noqa: E501
    plan_signature as j_plan_signature,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.zoo import (  # noqa: E501
    genCirc as j_gen_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops import (  # noqa: E501
    fusion as j_fusion,
    knit as j_knit,
    variant_engine as j_ve,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as JVirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
    circuit_from_instructions,
    circuit_to_instructions,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
    Cutter as TCutter,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.solver import (  # noqa: E501
    plan_signature as t_plan_signature,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
    genCirc as t_gen_circ,
    generate_circ as t_generate_circ,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    fusion as t_fusion,
    knit as t_knit,
    variant_engine as t_ve,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit as TVirtualCircuit,
)
from torch_port_common import to_port

CASES = {
    # name: (genCirc args, Cutter kwargs)
    "sup20_seed0": (("sup", 20, 1, 0), dict(
        maxNPartitions=2, maxNQubitsPerPartition=10, maxNQpdCuts=5,
        maxNCuts=5, maxCutsPerPartitions=5)),
    "sup12_seed5": (("sup", 12, 1, 5), dict(
        maxNPartitions=2, maxNQubitsPerPartition=10, maxNQpdCuts=5,
        maxNCuts=5, maxCutsPerPartitions=5)),
    "ghz10": (("ghz", 10, 1, None), dict(
        maxNPartitions=2, maxNQubitsPerPartition=5, maxNQpdCuts=2,
        maxNCuts=2)),
}


def _both(case):
    (name, n, depth, seed), kw = CASES[case]
    out = []
    for gen, cutter_cls, virt_cls in ((j_gen_circ, JCutter, JVirtualCircuit),
                                      (t_gen_circ, TCutter, TVirtualCircuit)):
        circ = gen(name, n, depth, seed=seed)
        cutter = cutter_cls(circ, **kw)
        assert cutter.solve()
        out.append((circ, cutter, virt_cls(cutter.getResultCircs()[3])))
    return out


def _same(a, b):
    """Structural equality over tuples/lists/dicts/arrays/scalars."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    return a == b


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_circuit_and_plan(case):
    (jc, jcut, _), (tc, tcut, _) = _both(case)
    assert _same(circuit_to_instructions(jc), circuit_to_instructions(tc))
    assert j_plan_signature(jcut.plan) == t_plan_signature(tcut.plan)


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_fragment_programs(case):
    (_, _, jv), (_, _, tv) = _both(case)
    assert [r.name for r in jv.fragments] == [r.name for r in tv.fragments]
    assert [(vg.base_name, vg.params) for vg in jv.vgates] == \
        [(vg.base_name, vg.params) for vg in tv.vgates]
    for reg in jv.fragments:
        jp, tp = jv.programs[reg.name], tv.programs[reg.name]
        assert (jp.num_data_qubits, jp.num_sim_qubits) == \
            (tp.num_data_qubits, tp.num_sim_qubits)
        assert jp.touching == tp.touching
        assert jp.clbit_sources == tp.clbit_sources
        assert [(s.vgate_idx, s.side, s.qubit, s.ancilla) for s in jp.slots] \
            == [(s.vgate_idx, s.side, s.qubit, s.ancilla) for s in tp.slots]
        assert _same(jp.ops, tp.ops)


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_kernel_host_tables(case):
    """fused_stream, _slot_tables, label_strides, variant_index_table and
    fold_weights: the tables the kernel consumes."""
    (_, _, jv), (_, _, tv) = _both(case)
    specs_j = [vg.spec for vg in jv.vgates]
    specs_t = [vg.spec for vg in tv.vgates]
    for reg in jv.fragments:
        jp, tp = jv.programs[reg.name], tv.programs[reg.name]
        js, jm = j_fusion.fused_stream(j_ve._fuse_slot_ops(jp.ops), 2)
        ts, tm = t_fusion.fused_stream(t_ve._fuse_slot_ops(tp.ops), 2)
        assert js == ts and _same(jm, tm)
        for fused in (True, False):
            assert _same(j_ve._slot_tables(jp, specs_j, fused=fused),
                         t_ve._slot_tables(tp, specs_t, fused=fused))
        js_, jn, jc = j_ve.label_strides(specs_j, jp.touching)
        ts_, tn, tc = t_ve.label_strides(specs_t, tp.touching)
        assert (js_, jn, jc) == (ts_, tn, tc)
        padded = jc + 5
        assert _same(
            j_ve.variant_index_table(jp.touching, js_, jn, padded,
                                     clamp_to=jc),
            t_ve.variant_index_table(tp.touching, ts_, tn, padded,
                                     clamp_to=tc),
        )
        assert _same(j_knit.fold_weights(jv, reg.name),
                     t_knit.fold_weights(tv, reg.name))


@pytest.mark.parametrize("noise", [0.1, 1e-9])
def test_nearest_probability_distribution_matches(noise):
    """A few large entries over noise: 0.1 discards a short negative tail,
    1e-9 (an exact knit's rounding noise) cuts about half the entries."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.statevector import (  # noqa: E501
        Distribution as JDist,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
        Distribution as TDist,
    )

    vals = np.random.default_rng(0).normal(0.0, noise, 256).astype(np.float32)
    vals[:8] += 1.0
    j = j_knit.nearest_probability_distribution(JDist(vals, list(range(8)), 8))
    t = t_knit.nearest_probability_distribution(TDist(vals, list(range(8)), 8))
    np.testing.assert_array_equal(j.values, t.values)


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_round_trip(case):
    """A JAX cut circuit (vgate payloads included) carried into the port
    and back out is the same plain data, and builds the same fragments."""
    (_, jcut, jv), _ = _both(case)
    jcirc = jcut.getResultCircs()[3]
    data = circuit_to_instructions(jcirc)
    tcirc = circuit_from_instructions(*data)
    assert _same(circuit_to_instructions(tcirc), data)
    assert any(i["op"] is not None and i["op"]["kind"] == "vgate"
               for i in data[3])
    tv = TVirtualCircuit(to_port(jcirc))
    assert [tv.programs[r.name].num_sim_qubits for r in tv.fragments] == \
        [jv.programs[r.name].num_sim_qubits for r in jv.fragments]


def test_convert_rejects_register_mismatch():
    nq, nc, regs, instrs = circuit_to_instructions(t_gen_circ("ghz", 4, 1))
    with pytest.raises(ValueError):
        circuit_from_instructions(nq + 1, nc, regs, instrs)


def test_port_refuses_what_it_does_not_carry():
    """What the port still refuses: a cut circuit has no OpenQASM 2
    spelling (JAX's ValueError).  The zoo, qasm, teleport execution and,
    since the last modules landed, ``tracer`` are ported: a Tracer
    records the run's phases."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
        run_virtual_circuit,
    )

    circ = t_gen_circ("ghz", 4, 1)
    assert t_gen_circ("bv", 8, 1).num_qubits == 8
    assert t_generate_circ(8, 1, "adder").num_qubits == 8
    assert circ.to_qasm().startswith("OPENQASM 2.0;")
    cutter = TCutter(circ, maxNPartitions=2, maxNQubitsPerPartition=3)
    assert cutter.solve()
    cut = cutter.getResultCircs()[3]
    with pytest.raises(ValueError, match="not representable"):
        cut.to_qasm()
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.utils.profiling import (  # noqa: E501
        Tracer,
    )

    tracer = Tracer()
    run_virtual_circuit(TVirtualCircuit(cut), device="cpu", tracer=tracer)
    assert [p.name for p in tracer.phases] == ["stream_sim_knit"]


@pytest.mark.parametrize("name,n", [("qft", 9), ("qft", 16), ("aqft", 8),
                                    ("aqft", 16)])
def test_qft_generators_match(name, n):
    """genCirc("qft" / "aqft"): instruction for instruction."""
    assert _same(circuit_to_instructions(j_gen_circ(name, n, 1)),
                 circuit_to_instructions(t_gen_circ(name, n, 1)))


def _prepped_qft16(circuit_cls, library_qft):
    """The 16-qubit QFT behind an ``h`` and a seeded ``rz`` on every
    qubit, all measured (benchmarks/qft16_sampled.py, "prepped" leg)."""
    import math

    rng = np.random.default_rng(5)
    circ = circuit_cls(16, 16)
    for q in range(16):
        circ.h(q)
        circ.rz(float(rng.uniform(0, 2 * math.pi)), q)
    for ins in library_qft(16).instructions:
        circ.instructions.append(ins.copy())
    for q in range(16):
        circ.measure(q, q)
    return circ


GAMMA_CASES = {
    "qft9_q8": (lambda gen: gen("qft", 9, 1), dict(
        maxNPartitions=2, maxNQubitsPerPartition=8, gammaMode=True,
        maxNQpdCuts=20, maxNCuts=20, maxCutsPerPartitions=20)),
    "qft16_q15": (lambda gen: gen("qft", 16, 1), dict(
        maxNPartitions=2, maxNQubitsPerPartition=15, gammaMode=True)),
    "ghz18_wire": (lambda gen: gen("ghz", 18, 1), dict(
        maxNPartitions=2, maxNQubitsPerPartition=10, gammaMode=True,
        forceNWireCuts=1, maxNQpdCuts=3, maxNCuts=3)),
}


@pytest.mark.parametrize("case", sorted(GAMMA_CASES))
def test_gamma_mode_plans_match(case):
    """Cutter(gammaMode=True): the angle-aware search (cutter/gamma.py)
    gives the JAX cutter's plan, metrics and fragments."""
    build, kw = GAMMA_CASES[case]
    jcut, tcut = JCutter(build(j_gen_circ), **kw), TCutter(
        build(t_gen_circ), **kw)
    assert jcut.solve() and tcut.solve()
    assert j_plan_signature(jcut.plan) == t_plan_signature(tcut.plan)
    assert jcut.getModelKeyResults() == tcut.getModelKeyResults()
    jv = JVirtualCircuit(jcut.getResultCircs()[3])
    tv = TVirtualCircuit(tcut.getResultCircs()[3])
    assert _same(circuit_to_instructions(jv._circuit),
                 circuit_to_instructions(tv._circuit))
    # a second solve enumerates the next plan in both, or ends in both
    assert jcut.solve() == tcut.solve()
    assert j_plan_signature(jcut.plan) == t_plan_signature(tcut.plan)


def test_stored_qft16_plan_is_the_solvers_plan():
    """The stored gamma-mode plan of the prepped qft-16 equals the JAX
    cutter's and the port's own solve, crosses between the packages as
    JSON, and cuts 15|1 with 15 cp cuts at gamma_total 8.57."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.circuit.circuit import (  # noqa: E501
        Circuit as JCircuit,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.models.qft import (  # noqa: E501
        library_qft as j_library_qft,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
        Circuit as TCircuit,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
        plan_from_other,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.qft import (  # noqa: E501
        library_qft as t_library_qft,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.qpd_sampling import (  # noqa: E501
        sampling_overhead,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.plans import (  # noqa: E501
        load_plan,
    )

    kw = dict(maxNPartitions=2, maxNQubitsPerPartition=15, gammaMode=True)
    jc = _prepped_qft16(JCircuit, j_library_qft)
    tc = _prepped_qft16(TCircuit, t_library_qft)
    assert _same(circuit_to_instructions(jc), circuit_to_instructions(tc))
    stored = load_plan("qft16_prepped_p2_q15_gamma")
    jcut, tcut = JCutter(jc, **kw), TCutter(tc, **kw)
    assert jcut.solve() and tcut.solve()
    assert t_plan_signature(stored) == j_plan_signature(jcut.plan) \
        == t_plan_signature(tcut.plan)
    carried = plan_from_other(jcut.plan)
    assert t_plan_signature(carried) == t_plan_signature(stored)
    assert carried.metrics == stored.metrics == tcut.plan.metrics
    fresh = TCutter(tc, **kw)
    fresh.use_plan(stored)
    virt = TVirtualCircuit(fresh.getResultCircs()[3])
    assert [virt.programs[r.name].num_data_qubits
            for r in virt.fragments] == [15, 1]
    assert len(virt.vgates) == 15
    assert all(vg.base_name == "cp" for vg in virt.vgates)
    over = sampling_overhead(virt)
    assert over["gamma_total"] == pytest.approx(stored.metrics.S, rel=1e-12)
    assert stored.metrics.S == pytest.approx(8.570288790326419)


def test_stored_ghz40_plan_is_the_jax_cutters_plan():
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.plans import (  # noqa: E501
        load_plan,
    )

    kw = dict(maxNPartitions=2, maxNQubitsPerPartition=20, maxNQpdCuts=5,
              maxNCuts=5, maxCutsPerPartitions=5)
    jcut = JCutter(j_gen_circ("ghz", 40, 1), **kw)
    assert jcut.solve()
    stored = load_plan("ghz40_p2_q20")
    assert t_plan_signature(stored) == j_plan_signature(jcut.plan)
    cutter = TCutter(t_gen_circ("ghz", 40, 1), **kw)
    cutter.use_plan(stored)
    virt = TVirtualCircuit(cutter.getResultCircs()[3])
    assert [virt.programs[r.name].num_sim_qubits
            for r in virt.fragments] == [21, 21]
