"""The CUDA kernels on the card against their plain PyTorch versions.

This file imports only the torch port (no JAX), so it also runs on the
card's machine: ``python -m pytest -m cuda tests/test_torch_kernel_cuda.py``.
Without a card every test skips (the CUDA kernel has no CPU mode).
Tolerance 1e-5: f32, different summation order."""
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
    Circuit,
    Instruction,
    Register,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    blocked_kernel as bk,
    variant_kernel as vk,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.variant_engine import (  # noqa: E501
    label_strides,
    variant_index_table,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
    VirtualCircuit,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_gates import (  # noqa: E501
    VirtualGateOp,
)

TOL = 1e-5


def _chain(nbig: int = 9):
    cut = Circuit([Register("frag0", nbig), Register("frag1", 2)], nbig + 2)
    cut.h(0)
    for i in range(nbig - 1):
        cut.cx(i, i + 1)
    for q in range(nbig):
        cut.rz(0.1 * (q + 1), q)
    cut.append(Instruction("vgate", [nbig - 1, nbig],
                           op=VirtualGateOp("cz")))
    cut.append(Instruction("vgate", [0, nbig],
                           op=VirtualGateOp("cp", params=(0.7,))))
    cut.cx(nbig, nbig + 1)
    for q in range(nbig + 2):
        cut.measure(q, q)
    return VirtualCircuit(cut)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return "cuda"


def _block(virt, c, seed):
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, total = label_strides(specs, range(len(specs)))
    vidx = variant_index_table(range(len(specs)), strides, n_inst, total)
    perm = np.random.default_rng(seed).permutation(total)[:c]
    return torch.as_tensor(vidx[perm], dtype=torch.int64)


# epilogues: full rows, and the fold keeping 9, 1 and 0 (z) data bits, so
# 2^d outputs cover both the one-thread-per-output and the tree-sum path
EPILOGUES = {"full": None, "fold": {}, "keep1": {"keep_clbits": [0]},
             "z": {"z_clbits": [0, 3, 7]}}


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("span", [1, 3, 36])
def test_kernel_matches_plain_on_card(card, epilogue, staged, span):
    virt = _chain()
    blk = _block(virt, 36, 1).to(card)
    kw = EPILOGUES[epilogue]
    folded = kw is not None
    if folded:
        fn, _ = vk.make_folded_chunk_kernel(virt, "frag0", 36, staged=staged,
                                            device=card, **kw)
    else:
        fn, _ = vk.make_chunk_kernel(virt, "frag0", 36, staged=staged,
                                     device=card)
    dp = fn.plan
    ent = dp.gather_entries(blk)
    n_w = max(1, len(dp.plan.fold[0])) if folded else 1
    ws = torch.rand((36, n_w, 2), device=card, dtype=torch.float32)
    st = dp.stages(blk)
    before = vk.variant_rows.launches
    got = vk.variant_rows(dp, ent, ws, st, span)
    want = vk.plain_variant_rows(dp, ent, ws)
    torch.cuda.synchronize()
    assert vk.variant_rows.launches == before + 1
    assert (got - want).abs().max().item() <= TOL


def _deep_chain(nbig: int = 14):
    """A 16-qubit fragment whose suffix is long: entangling layers after
    each of two cuts, so small windows give many segments."""
    cut = Circuit([Register("frag0", nbig), Register("frag1", 2)], nbig + 2)
    cut.h(0)
    for i in range(nbig - 1):
        cut.cx(i, i + 1)
    cut.append(Instruction("vgate", [nbig - 1, nbig],
                           op=VirtualGateOp("cz")))
    for i in range(nbig - 1):
        cut.ry(0.3 + 0.05 * i, i)
        cut.cx(i, i + 1)
    cut.append(Instruction("vgate", [0, nbig],
                           op=VirtualGateOp("cp", params=(0.7,))))
    for i in range(0, nbig - 2, 2):
        cut.cz(i, i + 2)
        cut.rx(0.2 + 0.1 * i, i + 1)
    cut.cx(nbig, nbig + 1)
    for q in range(nbig + 2):
        cut.measure(q, q)
    return VirtualCircuit(cut)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [8, 13, 14])
@pytest.mark.parametrize("labels", [1, 3, 36])
def test_blocked_kernel_matches_plain_on_card(card, window, labels):
    """Every segment launch counted; rows against the plain version and,
    marginalised, against the variant kernel's rows."""
    virt = _deep_chain()
    assert virt.programs["frag0"].num_sim_qubits >= 15
    blk = _block(virt, labels, 2).to(card)
    fn, pos = bk.make_blocked_chunk_kernel(virt, "frag0", labels,
                                           window=window, force=True,
                                           device=card)
    dp = fn.plan
    assert dp.plan.w == window
    if window == 8:
        assert len(dp.plan.segments) >= 3
    ent = dp.gather_entries(blk)
    before = bk.blocked_rows.launches
    got = bk.blocked_rows(dp, ent)
    torch.cuda.synchronize()
    assert bk.blocked_rows.launches == before + len(dp.plan.segments)
    want = bk.plain_blocked_rows(dp, ent)
    assert (got - want).abs().max().item() <= TOL
    v_fn, v_pos = vk.make_chunk_kernel(virt, "frag0", labels, device=card)
    assert v_pos == pos
    assert (fn(blk) - v_fn(blk)).abs().max().item() <= TOL


@pytest.mark.cuda
def test_blocked_kernel_refuses_a_wrong_state(card):
    """On a CUDA tensor the wrapper launches or raises: a state of the
    wrong shape is refused before any launch."""
    virt = _deep_chain()
    fn, _ = bk.make_blocked_chunk_kernel(virt, "frag0", 3, window=8,
                                         force=True, device=card)
    dp = fn.plan
    ent = dp.gather_entries(_block(virt, 3, 2).to(card))
    bad = torch.zeros((2, 2, 1 << dp.plan.n), device=card)
    before = bk.blocked_rows.launches
    with pytest.raises(ValueError, match="shape"):
        bk.apply_segment(dp, 0, bad, ent)
    assert bk.blocked_rows.launches == before


# ---------------------------------------------------------------------------
# The collapse kernel (csrc/collapse_kernel.cu)
# ---------------------------------------------------------------------------

def _qft_gamma_cut(n: int):
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc,
    )

    cutter = Cutter(genCirc("qft", n, 1), maxNPartitions=2,
                    maxNQubitsPerPartition=n - 1, gammaMode=True)
    assert cutter.solve()
    return VirtualCircuit(cutter.getResultCircs()[3])


_COLLAPSE_CUTS: dict = {}


def _collapse_case(n: int):
    """(virt, fragment name) whose collapse-mode state has ``n`` qubits:
    qft-9 cut 8|1 gives n = 8 and n = 1, qft-16 cut 15|1 n = 15."""
    total = 16 if n == 15 else 9
    if total not in _COLLAPSE_CUTS:
        _COLLAPSE_CUTS[total] = _qft_gamma_cut(total)
    virt = _COLLAPSE_CUTS[total]
    frag = next(r.name for r in virt.fragments
                if virt.programs[r.name].num_data_qubits == n)
    return virt, frag


COLLAPSE_EPILOGUES = {
    "rows": {},
    "marginal": {"keep_clbits": {0, 1, 2, 3}},
    "z": {"z_sets": [{0}, {1, 2}, set(range(16))]},
}


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", sorted(COLLAPSE_EPILOGUES))
@pytest.mark.parametrize("labels", [1, 3, 1024, 4096])
@pytest.mark.parametrize("n", [1, 8, 15])
def test_collapse_kernel_matches_plain_on_card(card, n, labels, epilogue):
    """Random labels, draws, measure flags and weights: picked bits equal
    (a flip only within 1e-6 of a threshold), rows within 1e-5, one
    launch counted."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        collapse_kernel as ck,
    )

    virt, frag = _collapse_case(n)
    plan = ck.build_plan(virt, frag, **COLLAPSE_EPILOGUES[epilogue])
    assert plan.n == n and len(plan.site_meta) >= 8
    dp = ck.CollapseDevicePlan(plan, card)
    rng = np.random.default_rng(100 * n + labels)
    lab = np.stack([rng.integers(0, vg.spec.num_instantiations, labels)
                    for vg in virt.vgates], axis=1)
    cscal = np.empty((labels, plan.n_sites, 4), np.float32)
    cscal[:, :, 0] = rng.random((labels, plan.n_sites))
    cscal[:, :, 1] = rng.integers(0, 2, (labels, plan.n_sites))
    cscal[:, :, 2:] = rng.uniform(-1, 1, (labels, plan.n_sites, 2))
    ent = dp.gather_entries(torch.as_tensor(lab, device=card))
    cscal = torch.as_tensor(cscal, device=card)
    before = ck.collapse_rows.launches
    got, bits = ck.collapse_rows(dp, ent, cscal)
    torch.cuda.synchronize()
    assert ck.collapse_rows.launches == before + 1
    want, wbits, margins = ck.plain_collapse_rows(dp, ent, cscal,
                                                  with_margins=True)
    assert got.shape == want.shape == (labels, plan.out_width)
    assert torch.isfinite(got).all()
    agree, near, far = ck.compare_picks(bits, wbits, margins)
    assert far == 0 and near <= max(1, labels // 100)
    assert (got - want)[agree].abs().max().item() <= TOL
    # a second launch repeats the first bit for bit (fixed-order sums)
    again, bits2 = ck.collapse_rows(dp, ent, cscal)
    assert torch.equal(again, got) and torch.equal(bits2, bits)


@pytest.mark.cuda
def test_collapse_kernel_refuses_wrong_scalars(card):
    """On a CUDA tensor the wrapper launches or raises: a scalar block of
    the wrong shape is refused before any launch."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        collapse_kernel as ck,
    )

    virt, frag = _collapse_case(8)
    dp = ck.CollapseDevicePlan(ck.build_plan(virt, frag), card)
    ent = dp.gather_entries(torch.zeros((3, len(virt.vgates)),
                                        dtype=torch.int64, device=card))
    before = ck.collapse_rows.launches
    with pytest.raises(ValueError, match="shape"):
        ck.collapse_rows(dp, ent, torch.zeros((3, 1, 4), device=card))
    assert ck.collapse_rows.launches == before
