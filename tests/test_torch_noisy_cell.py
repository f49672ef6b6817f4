"""The trajectory-noise scan as the benchmark serves it, on the CPU: an
8-qubit supremacy circuit cut into two 4-qubit fragments by two cz gate
cuts (36 labels, 6 simulated qubits a fragment), run on the calibrated
Kolkata model with 2 trajectories a label through ``portbench``'s
``noisy`` entry, and held to the plain replay of its draws by the
``noisy_replay`` comparison: the answer against the replay, the routed
streams against the uncut statevector, every planted fault
(``portbench/noisy_faults.py``) caught, the reference free of JAX and of
the port."""
import ast
import dataclasses
import json
import math
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import noisy_faults  # noqa: E402
from portbench.cell import ROOT, Port, named_module  # noqa: E402

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E402,E501
    noise,
)
import torch_threads  # noqa: E402,F401 (torch's threads: a share of the cores)

N = 8
CUTTER = {"maxNPartitions": 2, "maxNQubitsPerPartition": 4,
          "maxNQpdCuts": 5, "maxNCuts": 5, "maxCutsPerPartitions": 5}
RUN = {"engine": "streamed", "chunk_size": 512, "shots": None}
# The limits of this tiny cell, each between the program's largest
# reading on seeds 11-13 and the smallest reading of the faults it is
# there to catch (seeds 11-12):
# routing: 5.9e-7 (the port's complex64 gate matrices) against 0.45
#   (state_unchanged);
# answer: 1.3e-7 (float32 rows) against 1.09e-3 (rows_bf16);
# draws: none at 2 trajectories, where 72 draws a site read a single
#   non-identity branch at the smallest rates (4e-5) as 18 sigma; the
#   term is held at 512 trajectories below.
LIMITS = {"routing": 5e-4, "answer": 1e-5, "draws": math.inf}
# At 512 trajectories the draws term sees the rates: the program reads
# 1.75-2.21 (seeds 11-13), rates_unrouted 4.24-4.33 (only device node 4
# of each fragment's placement is not its own unrouted slot).
DRAWS_512 = 3.0


def _module(kind, name):
    return named_module(ROOT, kind, name)


def _cell(plan_text, trajectories=2, draws=LIMITS["draws"]):
    config = {"cutter": CUTTER, "keep_clbits": None,
              "noise": {"model": "fake_kolkata_v2", "calibration_seed": 27,
                        "relaxation": False, "trajectories": trajectories,
                        "coupling": "heavy_hex_27"},
              "replay_limits": dict(LIMITS, draws=draws), "limit": 1}
    return SimpleNamespace(config=config, plan_text=plan_text,
                           entry=_module("entries", "noisy"))


@pytest.fixture(scope="module")
def port():
    return Port()


@pytest.fixture(scope="module")
def cell(port):
    """The tiny deployment, its plan solved once and adopted by every
    request, as the cell's is."""
    cutter = port.Cutter(port.circuit(_instance(0)), **CUTTER)
    assert cutter.solve()
    return _cell(cutter.plan.to_json())


def _instance(seed):
    return _module("circuits", "supremacy").generate(N, 1, seed)


def _serve(port, cell, seed):
    virt = port.front_end(cell, _instance(seed))
    return cell.entry.answer(port, cell, virt, "cpu", dict(RUN))


def _terms(cell, seed, answer):
    return _module("reference", "noisy_replay").terms(
        cell, _instance(seed), answer, "cpu")


@pytest.fixture(scope="module")
def served(port, cell):
    return {s: _serve(port, cell, s) for s in (11, 12)}


def test_the_frozen_sup20_plan_fits_every_seed(port):
    """The cell's plan, the port's stored one, cuts instances of every
    seed into 7776 labels on two fragments of 15 simulated qubits."""
    from portbench.cell import check_plan, instances, load_cell

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.plans import (  # noqa: E501
        load_plan,
    )

    cell = load_cell("sup20-kolkata-noisy")
    stored = load_plan("sup20_p2_q10").to_json()
    assert json.loads(stored) == json.loads(cell.plan_text)
    for seed in (0, 7, 2**31 + 9):
        check_plan(cell, port.front_end(cell, instances(cell, seed)[0]))


def test_the_plan_cuts_two_cz_gates(port, cell):
    virt = port.front_end(cell, _instance(3))
    assert [vg.spec.gate_name for vg in virt.vgates] == ["cz", "cz"]
    assert [(virt.programs[r.name].num_data_qubits,
             virt.programs[r.name].num_sim_qubits)
            for r in virt.fragments] == [(4, 6), (4, 6)]


def test_noisy_answer_equals_its_replay(cell, served):
    """float32 rows, mean, readout, knit and projection against the
    complex128 replay of the same draws: within 1e-5 in total
    variation (1.1e-7 read)."""
    for seed, answer in served.items():
        assert answer["bit_positions"] == list(range(N))
        terms = _terms(cell, seed, answer)
        assert terms["answer"] < LIMITS["answer"]
        reading = _module("reference", "noisy_replay").compare(
            cell, _instance(seed), answer, "cpu")
        assert reading <= 1


def test_routed_streams_knit_to_the_uncut_circuit(cell, served):
    """The streams' noise-free knit equals the uncut statevector to the
    rounding of the port's complex64 gate matrices."""
    nt = _module("reference", "noisy_trajectories")
    for seed, answer in served.items():
        replay = nt.Replay(_instance(seed), answer["noise"], 27, "cpu")
        assert replay.off_coupling(nt.HEAVY_HEX_27) == 0
        exact = replay.exact()
        assert nt.total_variation(exact, nt.uncut(_instance(seed), "cpu")) \
            < 1e-5
        assert _terms(cell, seed, answer)["routing"] < LIMITS["routing"]


def test_the_record_holds_the_streams_and_the_draws(served):
    record = served[11]["noise"]
    assert record["trajectories"] == 2 and record["labels"] == 36
    for frag in record["fragments"]:
        draws = frag["draws"]
        assert draws.dtype == np.int32 and draws.shape[:2] == (36, 2)
        assert set(np.unique(draws)) <= {0, 1, 2, 3}
        assert len(frag["ops"]) == len(frag["phys"])
        assert list(frag["positions"]) == sorted(frag["clbit_sources"])
        assert len(frag["readout_qubits"]) == len(frag["positions"])
        assert sorted(frag["slot_device"]) != list(range(4))  # routed


def test_requests_draw_their_own_noise(port, cell, served):
    assert served[11]["seed"] != served[12]["seed"]
    entry = _module("entries", "noisy")
    virt = port.front_end(cell, _instance(11))
    seeds = [entry.noise_seed(virt) for _ in range(3)]
    assert len(set(seeds)) == 3 and all(0 <= s < 2**31 for s in seeds)
    again = _module("entries", "noisy")
    assert [again.noise_seed(virt) for _ in range(3)] == seeds


def _caught(port, cell, fault, seeds=(11, 12)):
    """Readings of ``seeds`` with ``fault`` planted, after a warm-up
    request of instance 0, as a run makes one."""
    served_port, undo = noisy_faults.plant(fault, port)
    try:
        if seeds:
            served_port.serve(cell, _instance(0), "cpu", **RUN)
        for seed in seeds:
            inst = _instance(seed)
            answer, _ = served_port.serve(cell, inst, "cpu", **RUN)
            yield _module("reference", "noisy_replay").compare(
                cell, inst, answer, "cpu")
    finally:
        undo()


@pytest.mark.parametrize("fault", [f for f in noisy_faults.FAULTS
                                   if f != "rates_unrouted"])
def test_every_planted_fault_is_caught(port, cell, fault):
    assert all(r > 1 for r in _caught(port, cell, fault))


def test_rates_unrouted_is_caught_by_the_draws(port, cell):
    wide = _cell(cell.plan_text, trajectories=512, draws=DRAWS_512)
    program = [_terms(wide, s, _serve(port, wide, s))["draws"]
               for s in (11, 12)]
    assert max(program) < DRAWS_512
    assert all(r > 1 for r in _caught(port, wide, "rates_unrouted"))


def test_a_fault_is_taken_out_again(port, cell, served):
    for fault in noisy_faults.FAULTS:
        list(_caught(port, cell, fault, seeds=()))
    assert _terms(cell, 11, _serve(port, cell, 11))["answer"] < \
        LIMITS["answer"]


def test_the_replay_knows_the_cz_decomposition():
    """Each variant's local gates and measures, weighed by their
    coefficients and summed over the measured bit, give the channel of
    cz."""
    nt = _module("reference", "noisy_trajectories")
    rng = np.random.default_rng(0)
    rho = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    rho = rho @ rho.conj().T
    cz = np.diag([1, 1, 1, -1]).astype(complex)
    proj = [np.diag([1.0, 0.0]), np.diag([0.0, 1.0])]
    got = np.zeros((4, 4), complex)
    for v in range(6):
        for b in range(2):
            if not nt.CZ_MEASURE[v].any() and b:
                continue
            side = [proj[b] @ nt.CZ_LOCAL[v, s] if nt.CZ_MEASURE[v, s]
                    else nt.CZ_LOCAL[v, s] for s in range(2)]
            k = np.kron(side[0], side[1])
            got += nt.CZ_COEF[v, b] * (k @ rho @ k.conj().T)
    np.testing.assert_allclose(got, cz @ rho @ cz.conj().T, atol=1e-12)


def test_the_replays_calibration_is_the_models():
    nt = _module("reference", "noisy_trajectories")
    ref, model = nt.calibration(27), noise.fake_kolkata_v2(27)
    for key, vec in (("p1", model.p1_q), ("p2", model.p2_q),
                     ("ro01", model.ro01_q), ("ro10", model.ro10_q)):
        np.testing.assert_array_equal(ref[key], vec)
    assert sorted(map(sorted, nt.HEAVY_HEX_27)) == \
        sorted(map(sorted, model.coupling))


def test_smolin_is_the_nearest_distribution():
    nt = _module("reference", "noisy_trajectories")
    v = torch.tensor([0.6, 0.5, -0.05, -0.05], dtype=torch.float64)
    out = nt.smolin(v)
    # both negatives cut, their -0.1 shared over the two kept
    np.testing.assert_allclose(out.numpy(), [0.55, 0.45, 0, 0], atol=1e-15)
    p = torch.tensor([0.1, 0.2, 0.7], dtype=torch.float64)
    np.testing.assert_array_equal(nt.smolin(p).numpy(), p.numpy())


def test_a_record_that_does_not_fit_reads_inf(cell, served):
    answer = dict(served[11], noise=None)
    assert all(math.isinf(v) for v in _terms(cell, 11, answer).values())
    answer = dict(served[11], bit_positions=list(range(N - 1)))
    assert all(math.isinf(v) for v in _terms(cell, 11, answer).values())
    record = dict(served[11]["noise"])
    record["fragments"] = [dict(f, draws=f["draws"][:, :1])
                           for f in record["fragments"]]
    assert math.isinf(_terms(cell, 11, dict(served[11], noise=record))
                      ["draws"])


def test_the_entry_needs_the_record(port, cell, monkeypatch):
    real = noise.run_noisy_virtual_circuit

    def no_record(*a, **kw):
        dist, info = real(*a, **kw)
        return dist, dataclasses.replace(info, noise=None)
    monkeypatch.setattr(noise, "run_noisy_virtual_circuit", no_record)
    with pytest.raises(RuntimeError, match="noise record"):
        _serve(port, cell, 11)


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


@pytest.mark.parametrize("name", ["noisy_trajectories", "noisy_replay"])
def test_the_reference_imports_neither_jax_nor_the_port(name):
    names = _imports(REPO / "portbench" / "reference" / f"{name}.py")
    assert names <= {"math", "numpy", "torch"}, names
