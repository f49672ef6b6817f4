"""The torch port's variant kernel, plain version, against the JAX Pallas
kernel (ops/pallas_variant.py, interpret mode on the CPU).

On the CPU the port's wrapper runs its plain PyTorch version, which
replays every label in full; the CUDA kernel's staged schedule is held to
it on the card (test_torch_kernel_cuda.py).  Tolerance 2e-6, the JAX
kernel tests' own (f32, different summation order)."""
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu.ops.pallas_variant import (  # noqa: E501
    make_chunk_kernel as j_make_chunk_kernel,
    make_folded_chunk_kernel as j_make_folded_chunk_kernel,
)
from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    variant_kernel as vk,
)
from torch_port_common import chain_cut_pair, cut_pair, label_table, shuffled

ATOL = 2e-6


def _rows_both(jvirt, tvirt, name, chunk, rows_of, **kw):
    """Rows of every chunk of the global label table from the JAX kernel
    and the port, for ``rows_of(vidx) -> label order``."""
    import jax.numpy as jnp

    j_fn, j_pos = j_make_folded_chunk_kernel(
        jvirt, name, chunk, interpret=True, staged=False, **kw
    )
    t_fn, t_pos = vk.make_folded_chunk_kernel(
        tvirt, name, chunk, device="cpu", **kw
    )
    assert t_pos == j_pos
    vidx, total, padded = label_table(tvirt, chunk)
    arr = rows_of(vidx, total)
    for c0 in range(0, padded, chunk):
        blk = arr[c0:c0 + chunk]
        want = np.asarray(j_fn(jnp.asarray(blk)))
        got = t_fn(torch.as_tensor(blk, dtype=torch.int64)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("mode", ["dense", "keep", "z"])
def test_folded_kernel_rows_match_jax_fold(mode):
    """The in-kernel fold (vgate weights, dropped bits, z signs) equals
    the JAX fold-fused kernel row for row: dense, marginal and z modes
    (mirrors test_folded_kernel_rows_match_xla_fold)."""
    jvirt, tvirt = chain_cut_pair(8)
    kw = {"dense": {}, "keep": {"keep_clbits": [0, 1, 2, 5]},
          "z": {"z_clbits": [0, 3, 7]}}[mode]
    _rows_both(jvirt, tvirt, "frag0", 8, lambda v, t: v, **kw)


def test_folded_kernel_small_keep_rows():
    """d <= 1 kept bits (the JAX kernel's masked-lane epilogue; the port
    has one generic epilogue) matches exactly (mirrors
    test_folded_kernel_small_keep_masked_lane_path)."""
    jvirt, tvirt = chain_cut_pair(8)
    _rows_both(jvirt, tvirt, "frag0", 16, lambda v, t: v, keep_clbits=[0])


def test_folded_kernel_sup_fragment_rows():
    """A real optimal-cut supremacy fragment (sup-12, seed 5, dense 2q
    structure, cz cuts on interior qubits)."""
    _, _, jvirt, tvirt = cut_pair("sup", 12, 1, 10, seed=5)
    names = [r.name for r in tvirt.fragments
             if tvirt.programs[r.name].num_sim_qubits >= 8]
    assert names
    _rows_both(jvirt, tvirt, names[0], 64, lambda v, t: v)


@pytest.mark.parametrize("order", ["natural", "shuffled"])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_folded_kernel_staged_matches_unstaged_any_order(order, chunk):
    """The port's staged and unstaged plans give the JAX staged kernel's
    rows for any label order and any chunk split: chunks of 1 and 3 start
    where the stage array would otherwise say "resume", and the JAX kernel
    forces a full replay there (mirrors test_folded_kernel_staged_matches_
    unstaged_any_order).  The CUDA kernel's own block runs are held to the
    plain version in test_torch_kernel_cuda.py."""
    import jax.numpy as jnp

    jvirt, tvirt = chain_cut_pair(8)
    j_fn, _ = j_make_folded_chunk_kernel(jvirt, "frag0", chunk,
                                         interpret=True, staged=True)
    s_fn, _ = vk.make_folded_chunk_kernel(tvirt, "frag0", chunk,
                                          device="cpu")
    u_fn, _ = vk.make_folded_chunk_kernel(tvirt, "frag0", chunk,
                                          device="cpu", staged=False)
    assert s_fn.plan.plan.staged and len(s_fn.plan.plan.segments) == 2
    vidx, total, padded = label_table(tvirt, chunk)
    arr = vidx if order == "natural" else shuffled(vidx, total, 7)
    for c0 in range(0, padded, chunk):
        blk = torch.as_tensor(arr[c0:c0 + chunk], dtype=torch.int64)
        assert s_fn.plan.stages(blk)[0].item() == 0
        want = np.asarray(j_fn(jnp.asarray(arr[c0:c0 + chunk])))
        np.testing.assert_allclose(s_fn(blk).numpy(), want, atol=ATOL)
        np.testing.assert_allclose(u_fn(blk).numpy(), want, atol=ATOL)


def test_forced_full_replay_at_run_start_is_needed():
    """A CUDA block's run that starts mid-chunk (rows 3 and 6 of 8 with
    runs of 3) has no checkpoints although the stage array says "resume":
    effective_stages forces those rows to 0, at a cost in replayed work
    over the function's own stage array (which needs a full replay only
    at row 0)."""
    _, tvirt = chain_cut_pair(8)
    fn, _ = vk.make_folded_chunk_kernel(tvirt, "frag0", 8, device="cpu")
    dp = fn.plan
    vidx, _, _ = label_table(tvirt, 8)
    stage = dp.stages(torch.as_tensor(vidx[:8], dtype=torch.int64)).numpy()
    assert stage[0] == 0 and stage[3] > 0
    eff = vk.effective_stages(stage, 3)
    assert (eff[[0, 3, 6]] == 0).all()
    assert (eff[[1, 2, 4, 5, 7]] == stage[[1, 2, 4, 5, 7]]).all()
    own = vk.work_counts(dp.plan, stage, 2)
    kern = vk.work_counts(dp.plan, eff, 2)
    assert kern["flops"] > own["flops"]
    assert kern["pass_bytes"] > own["pass_bytes"]
    assert kern["bytes"] == own["bytes"]


@pytest.mark.parametrize("staged", [True, False])
def test_chunk_kernel_rows_match_jax(staged):
    """Full-row epilogue + marginalisation onto the written clbits equals
    the JAX make_chunk_kernel on shuffled label order (mirrors
    test_chunk_kernel_staged_matches_unstaged)."""
    import jax.numpy as jnp

    jvirt, tvirt = chain_cut_pair(8)
    chunk = 8
    j_fn, j_pos = j_make_chunk_kernel(jvirt, "frag0", chunk, interpret=True,
                                      staged=False)
    t_fn, t_pos = vk.make_chunk_kernel(tvirt, "frag0", chunk, device="cpu",
                                       staged=staged)
    assert t_pos == j_pos
    vidx, total, padded = label_table(tvirt, chunk)
    arr = shuffled(vidx, total, 3)
    for c0 in range(0, padded, chunk):
        want = np.asarray(j_fn(jnp.asarray(arr[c0:c0 + chunk])))
        got = t_fn(torch.as_tensor(arr[c0:c0 + chunk],
                                   dtype=torch.int64)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_width_gate_raises_not_implemented():
    """Past the port's width gate the kernel names the blocked kernel's
    ROADMAP item instead of running."""
    _, tvirt = chain_cut_pair(8)
    old = vk.MAX_QUBITS
    vk.MAX_QUBITS = 4
    try:
        with pytest.raises(NotImplementedError, match="kernel 4"):
            vk.build_plan(tvirt, "frag0")
    finally:
        vk.MAX_QUBITS = old


def test_work_counts_follow_replayed_segments():
    """The roofline bound counts only the segments a chunk replays."""
    _, tvirt = chain_cut_pair(8)
    plan = vk.build_plan(tvirt, "frag0", staged=True)
    full = vk.work_counts(plan, np.zeros(8, np.int64), 1)
    last = vk.work_counts(plan, np.array([0] + [1] * 7), 1)
    none = vk.work_counts(plan, np.array([0] + [2] * 7), 1)
    assert full["flops"] > last["flops"] > none["flops"] > 0
    assert full["bytes"] == last["bytes"]


def test_wrapper_counts_only_cuda_launches():
    """The CPU path runs the plain version and leaves the launch counter
    alone; a CUDA launch is the only place it moves."""
    _, tvirt = chain_cut_pair(8)
    fn, _ = vk.make_folded_chunk_kernel(tvirt, "frag0", 8, device="cpu")
    before = vk.variant_rows.launches
    vidx, _, _ = label_table(tvirt, 8)
    fn(torch.as_tensor(vidx[:8], dtype=torch.int64))
    assert vk.variant_rows.launches == before
