"""Kernel 1's noisy rows on the CPU: the plan that ``variant_kernel.
build_noisy_plan`` makes of a noisy fragment's routed, unfused per-gate
plan, replayed in plain PyTorch (``plain_variant_rows``, and the
kernel's own rewritten table and schedule, ``replay_kernel_table``),
against the rows of ``variant_engine.make_sim_fn(noise=...)`` for the
same labels and branch indices; the streamed scan with that plan in
``_SimRows.noisy_rows`` against the scan without it; and the fragments
it does not take, which the scan logs.  The CUDA launch itself is held
to the plain replay in ``tests/test_torch_kernel_cuda.py``."""
import dataclasses
import logging
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.cell import ROOT, Port, named_module  # noqa: E402

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E402,E501
    Circuit,
    Register,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E402,E501
    to_device,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E402,E501
    noise,
    streamed,
    variant_kernel as vk,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.variant_engine import (  # noqa: E402,E501
    _slot_tables,
    make_sim_fn,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E402,E501
    VirtualCircuit,
)
import torch_threads  # noqa: E402,F401 (torch's threads: a share of the cores)

TOL = 1e-6
CUTTER8 = {"maxNPartitions": 2, "maxNQubitsPerPartition": 4,
           "maxNQpdCuts": 5, "maxNCuts": 5, "maxCutsPerPartitions": 5}
CUTTER12 = dict(CUTTER8, maxNQubitsPerPartition=6)


def _sup(n, seed):
    return named_module(ROOT, "circuits", "supremacy").generate(n, 1, seed)


@pytest.fixture(scope="module")
def port():
    return Port()


@pytest.fixture(scope="module")
def cell8(port):
    """The 8-qubit noisy cell of ``test_torch_noisy_cell.py``: two cz
    gate cuts, two fragments of 6 simulated qubits, routed onto heavy-hex
    27."""
    cutter = port.Cutter(port.circuit(_sup(8, 3)), **CUTTER8)
    assert cutter.solve()
    return VirtualCircuit(cutter.getResultCircs()[3])


@pytest.fixture(scope="module")
def top12(port):
    """A 12-qubit supremacy circuit with qubits 0 and 1 left unmeasured,
    cut in two: the fragment that holds them keeps them off its written
    clbits, so one of them takes the top flat bit (the bit a two-CTA
    cluster splits on the card) and its 2q sites cross it."""
    inst = _sup(12, 5)
    circ = Circuit(12, 10)
    for name, qubits, params in inst["gates"]:
        getattr(circ, name)(*params, *qubits)
    for c, q in enumerate(range(2, 12)):
        circ.measure(q, c)
    cutter = port.Cutter(circ, **CUTTER12)
    assert cutter.solve()
    return VirtualCircuit(cutter.getResultCircs()[3])


def _kolkata(trajectories, **kw):
    return dataclasses.replace(noise.fake_kolkata_v2(27, **kw),
                               trajectories=trajectories)


def _gate_noise_off(trajectories):
    """Readout kept, every gate's rate 0: no site is active, so the plan
    holds fixed gate rows and a prefix state of its own."""
    nm = _kolkata(trajectories)
    return dataclasses.replace(nm, p1=0.0, p2=0.0,
                               p1_q=np.zeros_like(nm.p1_q),
                               p2_q=np.zeros_like(nm.p2_q))


# (virtual circuit, fragment, model, trajectories, draws)
CASES = {
    "cell8_frag0_random": ("cell8", 0, _kolkata, 2, "random"),
    "cell8_frag1_random": ("cell8", 1, _kolkata, 2, "random"),
    "cell8_frag0_identity": ("cell8", 0, _kolkata, 2, "identity"),
    "cell8_frag1_seven_trajectories": ("cell8", 1, _kolkata, 7, "random"),
    "cell8_frag0_relaxation": ("cell8", 0, lambda t: _kolkata(
        t, relaxation=True), 3, "random"),
    "top12_frag0_2q_sites_on_the_top_bit": ("top12", 0, _kolkata, 2,
                                            "random"),
    "top12_frag1_full_rows": ("top12", 1, _kolkata, 2, "random"),
    "cell8_frag0_gate_noise_off": ("cell8", 0, _gate_noise_off, 2,
                                   "identity"),
}


def _plain_rows(sim_fn, virt, name, vidx, pidx):
    """The rows of the plain per-gate plan (``_SimRows.noisy_rows``'
    route without a kernel, before the mean)."""
    prog = virt.programs[name]
    specs = [vg.spec for vg in virt.vgates]
    c, t = pidx.shape[:2]
    tables = [to_device(list(tab), "cpu")
              for tab in _slot_tables(prog, specs, fused=False)]
    mats = [tuple(tab[vidx[:, s.vgate_idx]].repeat_interleave(t, dim=0)
                  for tab in tabs) for s, tabs in zip(prog.slots, tables)]
    flat = pidx.reshape(c * t, -1)
    pauli = {s: to_device(sim_fn.site_banks[s], "cpu")[flat[:, s]]
             for s in sim_fn.active_sites}
    return sim_fn(mats, "cpu", pauli)


@pytest.mark.parametrize("case", CASES)
def test_noisy_plan_replays_the_plain_rows(case, request):
    which, fi, model, t, draws = CASES[case]
    virt = request.getfixturevalue(which)
    name = virt.fragments[fi].name
    prog = virt.programs[name]
    specs = [vg.spec for vg in virt.vgates]
    sim_fn, _, positions, _ = make_sim_fn(
        virt, name, noise=model(t), build_matrices=False, fuse_qubits=3)
    rng = np.random.default_rng(len(case))
    c = 5
    n_inst = [s.num_instantiations for s in specs]
    vidx = torch.as_tensor(np.stack(
        [rng.integers(0, k, c) for k in n_inst], axis=1))
    shape = (c, t, len(sim_fn.noise_sites))
    pidx = torch.as_tensor(rng.integers(0, 4, shape) if draws == "random"
                           else np.zeros(shape, np.int64))
    fn = vk.make_noisy_chunk_kernel(sim_fn, prog, specs, "cpu")
    plan = fn.plan.plan
    assert not plan.staged and len(plan.row_segments) == 1
    assert plan.entry_gids == [
        stp[1] + len(specs) if stp[0] == "pauli"
        else prog.slots[stp[1]].vgate_idx
        for stp in sim_fn.run_plan if stp[0] not in ("ins", "u")]
    want = _plain_rows(sim_fn, virt, name, vidx, pidx)
    got = fn(vidx, pidx)
    assert got.shape == want.shape == (c * t, 1 << len(positions))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    # the kernel's own rewritten table, with its schedule
    idx = torch.cat([vidx.repeat_interleave(t, dim=0),
                     pidx.reshape(c * t, -1)], dim=1)
    ones = torch.ones((c * t, 1, 2))
    stage = torch.zeros(c * t, dtype=torch.int32)
    rows = vk.replay_kernel_table(fn.plan, fn.plan.gather_entries(idx), ones,
                                  stage, cap=4)
    if plan.fold is None:
        assert plan.n == len(positions)
    else:
        assert plan.fold[0] == [] and plan.fold[2] == len(positions)
    np.testing.assert_allclose(rows.numpy(), want.numpy(), atol=TOL, rtol=0)
    if which == "top12" and fi == 0:
        top = plan.n - 1
        assert plan.fold is not None
        assert any(nq == 2 and top in (ja, jb) and coef < 0
                   for nq, ja, jb, coef in plan.ops.tolist())
    if "gate_noise_off" in case:
        assert (plan.ops[:, 3] >= 0).any()          # fixed gate rows
        assert np.count_nonzero(plan.prefix_state) > 1


def test_the_scan_on_the_noisy_plan_equals_the_plain_scan(cell8,
                                                          monkeypatch):
    """``_SimRows.noisy_rows`` on kernel 1's plan (its plain replay, as
    the CPU runs it) gives the plain scan's answer for the same draws,
    and counts the same rows."""
    nm = _kolkata(3)
    counted = _SimRowsCounts()
    plain, _ = noise.run_noisy_virtual_circuit(
        cell8, nm, engine="streamed", seed=5, device="cpu")
    plain_rows = counted.delta()

    def on_the_plan(sim_fn, prog, specs, dev):
        return vk.make_noisy_chunk_kernel(sim_fn, prog, specs, dev), None

    monkeypatch.setattr(streamed, "_noisy_kernel", on_the_plan)
    launched = vk.variant_rows.noisy
    got, info = noise.run_noisy_virtual_circuit(
        cell8, nm, engine="streamed", seed=5, device="cpu")
    assert counted.delta() == plain_rows and plain_rows[0] > 0
    assert vk.variant_rows.noisy == launched      # nothing on a card
    np.testing.assert_allclose(got.values, plain.values, atol=TOL, rtol=0)
    assert info.noise["trajectories"] == 3


class _SimRowsCounts:
    def __init__(self):
        self.last = self._now()

    @staticmethod
    def _now():
        f = streamed._SimRows.noisy_rows
        return f.rows, f.site_passes

    def delta(self):
        now = self._now()
        out = (now[0] - self.last[0], now[1] - self.last[1])
        self.last = now
        return out


@pytest.fixture
def port_log(caplog):
    logger = logging.getLogger("HwAwareCutterTPU")
    level = logger.level
    logger.addHandler(caplog.handler)
    logger.setLevel(logging.INFO)
    caplog.set_level(logging.INFO)
    yield caplog
    logger.removeHandler(caplog.handler)
    logger.setLevel(level)


def _ccx_fragment():
    """Two fragments cut by a cz, one holding a ccx: a 3-qubit gate,
    which the kernel's 1q / 2q rows cannot apply."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
        Instruction,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_gates import (  # noqa: E501
        VirtualGateOp,
    )

    cut = Circuit([Register("frag0", 3), Register("frag1", 2)], 5)
    for q in range(5):
        cut.h(q)
    cut.ccx(0, 1, 2)
    cut.append(Instruction("vgate", [2, 3], op=VirtualGateOp("cz")))
    cut.cx(3, 4)
    for q in range(5):
        cut.measure(q, q)
    return VirtualCircuit(cut)


def test_the_scan_logs_the_fragments_kernel_1_does_not_take(cell8,
                                                             port_log):
    """Off a card every noisy fragment keeps the plain rows, and the scan
    says so; a fragment the kernel's plan cannot take (a 3-qubit gate)
    is refused on any device, a card's included, with the reason."""
    nm = dataclasses.replace(noise.NoiseModel(), trajectories=2)
    streamed.make_streamed_knit(cell8, 8, noise=_kolkata(2), device="cpu")
    virt = _ccx_fragment()
    streamed.make_streamed_knit(virt, 8, noise=nm, device="cpu")
    said = [r.getMessage() for r in port_log.records
            if "not on kernel 1" in r.getMessage()]
    assert len(said) == 4, said
    assert ["cpu tensors" in m for m in said] == [True, True, False, True]
    assert "'frag0'" in said[2] and "3-qubit op" in said[2], said
    sim_fn = make_sim_fn(virt, "frag0", noise=nm, build_matrices=False)[0]
    kernel, why = streamed._noisy_kernel(
        sim_fn, virt.programs["frag0"], [vg.spec for vg in virt.vgates],
        torch.device("cuda"))
    assert kernel is None and "3-qubit op" in why
