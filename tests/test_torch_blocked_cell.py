"""Kernel 4 as the row engine of the served path, as the benchmark's
cell ``hwe40-sweep`` serves it, on the CPU at a small size: the
hardware-efficient ansatz on 10 qubits at depth 2, cut P2 Q5 into two
7-qubit fragments by two cx gate cuts (36 labels), its rows from the
blocked kernel's plain version, held to the two-block reference
(``portbench/reference/two_block.py``, the state as a sum of products
of two blocks split at the cut): the reference against the uncut
statevector, the port against the reference, every planted fault
(``portbench/blocked_faults.py``) caught, the blocked route's spans and
row counter, the frozen hwe-40 plan, and the reference free of JAX and
of the port."""
import ast
import json
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import blocked_faults, roofline  # noqa: E402
from portbench.cell import ROOT, Port, named_module  # noqa: E402
from portbench.trace import Trace  # noqa: E402

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E402,E501
    blocked_kernel as bk,
    variant_kernel as vk,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E402,E501
    Distribution,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E402,E501
    make_streamed_knit,
)
import torch_threads  # noqa: E402,F401 (torch's threads: a share of the cores)

N, DEPTH, BOUNDARY = 10, 2, 5
CUTTER = {"maxNPartitions": 2, "maxNQubitsPerPartition": 5,
          "maxNQpdCuts": 5, "maxNCuts": 5, "maxCutsPerPartitions": 5}
KEEP = [2, 3, 4, 5, 6, 7]   # three kept clbits on each side of the cut
RUN = {"engine": "pallas", "chunk_size": 1024, "project": True}
# Between the program's largest reading on seeds 11-13 (2.7e-7: float32
# rows) and the smallest of the faults it is there to catch (5.0e-4:
# rows_bf16; answer_altered 1e-2, the others 0.25 and up).
LIMIT = 1e-5


def _module(kind, name):
    return named_module(ROOT, kind, name)


def _instance(seed, n=N, depth=DEPTH):
    return _module("circuits", "hwea").generate(n, depth, seed,
                                                angles="uniform")


@pytest.fixture(scope="module")
def port():
    return Port()


@pytest.fixture(scope="module")
def cell(port):
    """The small deployment, its plan solved once and adopted by every
    request, as the cell's is."""
    cutter = port.Cutter(port.circuit(_instance(0)), **CUTTER)
    assert cutter.solve()
    config = {"cutter": CUTTER, "keep_clbits": KEEP, "boundary": BOUNDARY,
              "limit": LIMIT}
    return SimpleNamespace(config=config, plan_text=cutter.plan.to_json(),
                           entry=_module("entries", "distribution"),
                           check=_module("reference", "tv_two_block"))


@pytest.fixture
def blocked_route(monkeypatch):
    """Kernel 1's width gate lowered to 6 qubits, so the 7-qubit
    fragments take the blocked kernel's route unforced, as 21-24-qubit
    fragments do (window min(13, n - 1) = 6)."""
    monkeypatch.setattr(vk, "MAX_QUBITS", 6)
    monkeypatch.setattr(bk, "MAX_QUBITS", 6)


def _serve(port, cell, seed, **kw):
    answer, _ = port.serve(cell, _instance(seed), "cpu", **dict(RUN, **kw))
    return answer


@pytest.mark.parametrize("keep", [[1, 4, 5, 6, 9, 11], [0, 2], [7, 10],
                                  None])
def test_two_blocks_equal_the_uncut_statevector(keep):
    """hwe-12 at depth 3 split 6|6: three cx across, 8 terms; kept
    clbits on both sides, on one side, and all of them."""
    inst = _instance(5, 12, 3)
    want, wbits = _module("reference", "statevector").distribution(inst,
                                                                   keep)
    got, gbits = _module("reference", "two_block").distribution(inst, keep,
                                                                6)
    assert gbits == wbits
    assert float((got - want).abs().max()) < 1e-12


def test_two_blocks_hold_two_to_the_crossings_terms():
    tb = _module("reference", "two_block")
    state = tb.TwoBlocks(12, 6)
    for name, qubits, params in _instance(5, 12, 3)["gates"]:
        state.apply(name, qubits, params)
    assert state.terms == 8
    for a, b in tb.schmidt_factors(np.eye(4)[[0, 1, 3, 2]]):  # cx
        assert a.shape == b.shape == (2, 2)
    cx = sum(np.kron(a, b) for a, b in
             tb.schmidt_factors(np.eye(4)[[0, 1, 3, 2]]))
    np.testing.assert_allclose(cx, np.eye(4)[[0, 1, 3, 2]], atol=1e-14)


def test_the_blocked_route_equals_the_reference(port, cell):
    """Every row from the blocked kernel's plain version at window 4
    (the hook the blocked tests use): within 1e-5 of the reference."""
    inst = _instance(11)
    virt = port.front_end(cell, inst)
    step, xs, meta = make_streamed_knit(virt, 8, keep_clbits=KEEP,
                                        device="cpu", blocked_window=4,
                                        pallas_variant=True)
    assert set(meta["fragment_kernels"].values()) == {"blocked"}
    dist = Distribution(step(xs).numpy(), meta["positions"],
                        virt.num_clbits)
    answer = {"values": dist.values, "bit_positions": dist.bit_positions}
    assert cell.check.compare(cell, inst, answer, "cpu") < 1e-5


def test_the_served_route_is_within_the_limit(port, cell, blocked_route):
    for seed in (11, 12):
        answer = _serve(port, cell, seed)
        assert answer["bit_positions"] == KEEP
        assert cell.check.compare(cell, _instance(seed), answer, "cpu") \
            < LIMIT


@pytest.mark.parametrize("fault", blocked_faults.FAULTS)
def test_every_planted_fault_is_caught(port, cell, blocked_route, fault):
    served, undo = blocked_faults.plant(fault, port)
    try:
        served.serve(cell, _instance(0), "cpu", **RUN)   # the warm-up
        for seed in (11, 12):
            answer = _serve(served, cell, seed)
            assert cell.check.compare(cell, _instance(seed), answer,
                                      "cpu") > LIMIT
    finally:
        undo()


def test_a_fault_is_taken_out_again(port, cell, blocked_route):
    launches, rows = bk.blocked_rows.launches, bk.blocked_rows.rows
    real = (bk.blocked_rows, bk.device_plan, bk.apply_segment,
            port.run_virtual_circuit)
    for fault in blocked_faults.FAULTS:
        served, undo = blocked_faults.plant(fault, port)
        _serve(served, cell, 11)
        undo()
    assert (bk.blocked_rows, bk.device_plan, bk.apply_segment,
            port.run_virtual_circuit) == real
    assert bk.blocked_rows.rows > rows
    assert bk.blocked_rows.launches == launches   # no launch on the CPU
    assert cell.check.compare(cell, _instance(11), _serve(port, cell, 11),
                              "cpu") < LIMIT


def _span_names(port, cell, seed):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(port, cell, seed, chunk_size=8)
    return [e.name for e in prof.events() if e.name.startswith("port.")]


def test_the_blocked_spans_fire_on_the_blocked_route(port, cell,
                                                     blocked_route):
    """One ``port.blocked.build`` a fragment (the request's new virtual
    circuit builds its plans once) and one ``port.blocked.fold`` a
    fragment and chunk (36 labels: 5 chunks of 8)."""
    names = _span_names(port, cell, 12)
    assert names.count("port.blocked.build") == 2
    assert names.count("port.blocked.fold") == 2 * 5
    assert names.count("port.rows") == 2 * 5


def test_the_blocked_spans_stay_off_kernel_1s_route(port, cell):
    names = _span_names(port, cell, 12)
    assert "port.rows" in names
    assert not {"port.blocked.build", "port.blocked.fold"} & set(names)


def test_blocked_rows_counts_padded_labels_times_fragments(port, cell,
                                                           blocked_route):
    before = bk.blocked_rows.rows
    _serve(port, cell, 13, chunk_size=8)
    assert bk.blocked_rows.rows - before == 40 * 2   # 36 labels padded
    before = bk.blocked_rows.rows
    _serve(port, cell, 13, chunk_size=36)
    assert bk.blocked_rows.rows - before == 36 * 2


def test_kernel_1s_route_counts_no_blocked_row(port, cell):
    before = bk.blocked_rows.rows
    _serve(port, cell, 13)
    assert bk.blocked_rows.rows == before


def _traced(port, cell, device, seeds=(11, 12)):
    """A trace of ``device``'s intervals whose ``fragments`` cuts the
    requests ``seeds`` as a traced run's does (its inputs: the port,
    the cell, the pool and the window's requests sent)."""
    pool = [_instance(s) for s in seeds]
    win = {"sent": list(range(len(pool)))}
    tr = Trace(len(pool), (0.0, 1.0), device, [], [0.0] * len(pool),
               card="H100")
    tr.fragments = lambda: [
        roofline.fragments_of(port.front_end(cell, pool[i]), KEEP)
        for i in win["sent"]]
    return tr


def _read_share(reader, tr):
    peaks = {"f32_flops_per_s": 1e12, "bytes_per_s": 1e12}
    real = roofline.peaks
    roofline.peaks = lambda card: peaks
    try:
        return reader.read(tr)
    finally:
        roofline.peaks = real


KERNEL_4 = [("blocked_segment_kernel", 0.1, 0.3),
            ("blocked_segment_kernel", 0.4, 0.5)]


def test_the_roofline_reader_counts_kernel_4s_traffic(port, cell,
                                                      blocked_route):
    """The reader's traffic is the plans' work counts over the traced
    requests' chunks, at the window, pinned bits and chunk of the port's
    last kernel-4 chunk; its share is the least work's time over the
    kernel's, and a trace without kernel 4 reads nothing."""
    reader = _module("metrics", "blocked_kernel_roofline")
    ms = _module("metrics", "blocked_kernel_ms")
    _serve(port, cell, 13, chunk_size=8)
    window, pinned, chunk = bk.blocked_rows.last[7]
    assert (window, chunk) == (6, 8)
    no_kernel_4 = [("variant_rows_kernel", 0.1, 0.2)]
    assert reader.read(_traced(port, cell, no_kernel_4)) is None
    assert ms.read(_traced(port, cell, no_kernel_4)) is None
    tr = _traced(port, cell, KERNEL_4)
    real = roofline.fragments_of
    share = _read_share(reader, tr)
    assert roofline.fragments_of is real
    assert ms.read(tr) == pytest.approx(150.0)
    note = tr.notes["blocked_kernel_roofline"]
    want = 0
    for seed in (11, 12):
        virt = port.front_end(cell, _instance(seed))
        for r in virt.fragments:
            plan = bk.build_plan(virt, r.name, window, pinned)
            want += 5 * sum(bk.work_counts(plan, k, 8)["bytes"]
                            for k in range(len(plan.segments)))
    assert note["traffic_bytes"] == want
    assert note["traffic_bytes_per_s"] == pytest.approx(want / 0.3)
    assert note["last_chunk"] == {"7": [window, pinned, 8]}
    assert share == pytest.approx(100 * note["bound_s"] / 0.3)
    assert note["counters"]["rows"] == bk.blocked_rows.rows


def test_the_roofline_reader_reads_without_the_traffic(port, cell,
                                                       blocked_route):
    """A trace whose fragments hide the requests, or a port with no
    kernel-4 chunk of that width on record, still reads the share, and
    its note leaves the traffic out."""
    reader = _module("metrics", "blocked_kernel_roofline")
    _serve(port, cell, 13, chunk_size=8)
    full = _traced(port, cell, KERNEL_4)
    share = _read_share(reader, full)
    hidden = _traced(port, cell, KERNEL_4)
    frags = hidden.fragments
    hidden.fragments = lambda: frags()
    assert _read_share(reader, hidden) == pytest.approx(share)
    assert "traffic_bytes" not in hidden.notes["blocked_kernel_roofline"]
    other = _traced(port, cell, KERNEL_4)
    last = dict(bk.blocked_rows.last)
    bk.blocked_rows.last.pop(7)
    try:
        assert _read_share(reader, other) == pytest.approx(share)
    finally:
        bk.blocked_rows.last.update(last)
    assert "traffic_bytes" not in other.notes["blocked_kernel_roofline"]


def test_the_fold_reader_reads_the_device_time_inside_its_blocks():
    """The fold's metric is the device time of the operations inside the
    device-side copies of ``port.blocked.fold``, per request: kernel 4
    before and after a block, and the gaps inside one, are left out."""
    reader = _module("metrics", "blocked_fold_ms")
    fold = "port.blocked.fold"
    device = [("blocked_segment_kernel", 0.0, 1.0),
              (fold, 1.0, 1.5), ("gather", 1.0, 1.2),
              ("elementwise", 1.3, 1.5),
              ("blocked_segment_kernel", 1.5, 2.5),
              (fold, 2.5, 2.75), ("gather", 2.5, 2.75),
              ("Memcpy DtoH", 2.8, 2.9)]
    tr = Trace(2, (0.0, 3.0), device, [(fold, 0.5, 2.9)], [0.0, 0.0])
    assert reader.read(tr) == pytest.approx(1e3 * 0.65 / 2)
    tr = Trace(2, (0.0, 3.0), device[:1], [(fold, 0.5, 2.9)], [0.0, 0.0])
    assert reader.read(tr) is None


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 9])
def test_the_frozen_hwe40_plan_fits_every_seed(port, seed):
    """The cell's plan, the port's stored one, cuts instances of every
    seed into 1296 labels on two fragments of 24 simulated qubits."""
    from portbench.cell import check_plan, instances, load_cell

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.plans import (  # noqa: E501
        load_plan,
    )

    cell = load_cell("hwe40-sweep")
    assert json.loads(load_plan("hwe40_d4_p2_q20").to_json()) == \
        json.loads(cell.plan_text)
    virt = port.front_end(cell, instances(cell, seed)[0])
    check_plan(cell, virt)
    assert [vg.spec.gate_name for vg in virt.vgates] == ["cx"] * 4
    assert [virt.programs[r.name].num_data_qubits
            for r in virt.fragments] == [20, 20]


def test_the_frozen_hwe40_plan_resolves_equal():
    """The port's native solver re-solves genCirc("hwe", 40, 4) at P2
    Q20, cut limits 5, to the stored plan."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter import (  # noqa: E501
        solver,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.plans import (  # noqa: E501
        load_plan,
    )

    cutter = Cutter(genCirc("hwe", 40, 4, seed=0), maxNPartitions=2,
                    maxNQubitsPerPartition=20, maxNQpdCuts=5, maxNCuts=5,
                    maxCutsPerPartitions=5)
    assert cutter.solve()
    stored = load_plan("hwe40_d4_p2_q20")
    assert solver.plan_signature(cutter.plan) == \
        solver.plan_signature(stored)
    assert vars(cutter.plan.metrics) == vars(stored.metrics)


def test_the_cell_names_its_files():
    from portbench.cell import load_cell

    cell = load_cell("hwe40-sweep")
    assert cell.chips == 1 and cell.config["check"] == "tv_two_block"
    assert cell.config["keep_clbits"] == list(range(10, 30))
    assert cell.config["boundary"] == 20
    assert cell.traffic["family_options"] == {"angles": "uniform"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mine = [m for m in bench["per_layer"]
            if "hwe40-sweep" in m.get("workloads", [])]
    assert sorted(m["name"] for m in mine) == [
        "blocked_build_ms", "blocked_fold_ms", "blocked_kernel_ms",
        "blocked_kernel_roofline"]
    assert all(m["workloads"] == ["hwe40-sweep"] for m in mine)
    assert [m["name"] for m in cell.per_layer] == [m["name"] for m in mine]


def _imports(path: pathlib.Path) -> set:
    """The modules a file imports, relative ones resolved inside its
    package directory, followed."""
    seen, todo, names = set(), [path], set()
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    mods = [node.module] if node.module else \
                        [a.name for a in node.names]
                    todo.extend(p.parent / f"{m}.py" for m in mods)
                else:
                    names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("name", ["two_block", "tv_two_block"])
def test_the_reference_imports_neither_jax_nor_the_port(name):
    names = _imports(REPO / "portbench" / "reference" / f"{name}.py")
    assert names <= {"contextlib", "math", "numpy", "torch"}, names
