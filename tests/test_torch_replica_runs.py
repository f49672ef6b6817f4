"""The collapse kernel's replica runs (ops/collapse_kernel.find_runs), on
the CPU, on the label rows the sampled engine itself lays out for qft-16.

``qpd_sampling._expand_measuring_counts`` repeats each measuring label once
per sample with ``np.repeat``, so a label's replicas lie side by side and
differ only in their uniform draws.  The kernel runs their shared rows
once per run; these tests hold the run table to that structure."""
import numpy as np
import pytest
import torch

from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
    collapse_kernel as ck,
    qpd_sampling as tq,
)
from test_torch_op_rewrite import qft16

SAMPLES = 4000


@pytest.fixture(scope="module")
def rows():
    """qft-16's expanded label rows (lhs, seed 17) and, per fragment, the
    collapse row function (its plan and scalar block)."""
    virt = qft16()
    uniq, counts = tq.sample_label_counts(virt, SAMPLES, 17, method="lhs")
    lab, _ = tq._expand_measuring_counts(virt, uniq,
                                         counts.astype(np.float64))
    has = tq._label_has_measure(virt, uniq)
    reps = np.where(has, counts, 1)
    row_fns = [tq._collapse_row_builder_pallas(virt, r.name,
                                                keep_clbits=[0, 1, 2, 3],
                                                device="cpu")[0]
                for r in virt.fragments]
    return {"virt": virt, "uniq": uniq, "reps": reps, "lab": lab,
            "row_fns": row_fns}


def _block(fn, lab, seed=0):
    lab = torch.as_tensor(lab, dtype=torch.int64)
    dp = fn.rows_fn.plan
    u = torch.as_tensor(np.random.default_rng(seed).random(
        (len(lab), dp.plan.n_sites)).astype(np.float32))
    return dp.gather_entries(lab), fn.scalars(lab, u)


@pytest.mark.parametrize("frag", [0, 1])
def test_runs_follow_the_repeat_structure(rows, frag):
    """Uncapped, every run lies inside one label's replicas (a run may
    join neighbouring labels whose entries and scalars agree in this
    fragment), and the measuring ones start at their first mflag > 0."""
    fn = rows["row_fns"][frag]
    ent, cscal = _block(fn, rows["lab"])
    runs = ck.find_runs(ent, cscal, cap=len(rows["lab"])).numpy()
    assert runs[:, 1].sum() == len(rows["lab"])
    assert (runs[1:, 0] == np.cumsum(runs[:, 1])[:-1]).all()
    label_starts = np.concatenate([[0], np.cumsum(rows["reps"])[:-1]])
    # a label boundary inside a run only where both sides agree here
    assert set(runs[:, 0]) <= set(label_starts.tolist())
    assert len(runs) <= len(rows["uniq"])
    meas = (cscal[:, :, 1] > 0).numpy()
    for start, length, first in runs.tolist():
        block = meas[start:start + length]
        assert (block == block[0]).all()
        want = int(np.argmax(block[0])) if block[0].any() else meas.shape[1]
        assert first == want
    # the heavy labels make long runs: far fewer runs than rows
    assert len(runs) * 3 < len(rows["lab"])


def test_a_shuffled_block_gives_runs_of_one(rows):
    fn = rows["row_fns"][0]
    perm = np.random.default_rng(2).permutation(len(rows["lab"]))
    lab = rows["lab"][perm]
    ent, cscal = _block(fn, lab)
    runs = ck.find_runs(ent, cscal).numpy()
    key = np.concatenate([ent.numpy(),
                          cscal[:, :, 1:].reshape(len(lab), -1).numpy()],
                         axis=1)
    breaks = 1 + int((key[1:] != key[:-1]).any(axis=1).sum())
    assert len(runs) == breaks
    assert (runs[:, 1] == 1).mean() > 0.9


def test_the_cap_splits_long_runs(rows):
    fn = rows["row_fns"][0]
    heavy = int(np.argmax(rows["reps"]))
    count = int(rows["reps"][heavy])
    assert count > 20
    lab = np.repeat(rows["uniq"][heavy:heavy + 1], count, axis=0)
    ent, cscal = _block(fn, lab)
    runs = ck.find_runs(ent, cscal, cap=8).numpy()
    assert runs[:, 1].tolist() == [8] * (count // 8) + (
        [count % 8] if count % 8 else [])
    assert (runs[:, 0] == np.arange(0, count, 8)).all()
    assert len(set(runs[:, 2].tolist())) == 1
    whole = ck.find_runs(ent, cscal, cap=ck.RUN_CAP).numpy()
    assert whole[:, 1].max() == min(count, ck.RUN_CAP)


def test_run_table_resumes_at_the_first_measuring_site(rows):
    """The table the kernel reads: largest runs first; a run resumes at
    the ``OP_SITE_B`` row of its first measuring site, or past the table
    when it measures nowhere, also in a fragment without any site."""
    fn = rows["row_fns"][0]
    dp = fn.rows_fn.plan
    ent, cscal = _block(fn, rows["lab"])
    table, count = ck.run_table(dp, ent, cscal)
    table = table.numpy()
    runs = ck.find_runs(ent, cscal).numpy()
    assert table.dtype == np.int32 and len(table) == len(ent)
    assert count.tolist() == [len(runs)]
    assert (table[len(runs):, 1] == 0).all()
    table = table[:len(runs)]
    assert (np.diff(table[:, 1]) <= 0).all()
    assert sorted(map(tuple, table[:, :2].tolist())) == sorted(
        map(tuple, runs[:, :2].tolist()))
    n_rows = len(dp.plan.table.rows)
    for start, length, resume in table.tolist():
        first = runs[runs[:, 0] == start][0, 2]
        if first == dp.plan.n_sites:
            assert resume == n_rows
        else:
            assert resume == dp.plan.site_rows[first]
            assert dp.plan.table.rows[resume, 0] == ck.OP_SITE_B

    # a fragment with no collapse site: one dummy scalar column
    virt = rows["virt"]
    plan = ck.build_plan(virt, "frag0")
    plan.site_meta, plan.site_rows = [], []
    bare = ck.CollapseDevicePlan(plan, "cpu")
    scal = torch.zeros((len(ent), 1, 4))
    table, count = ck.run_table(bare, ent, scal)
    assert (table[:int(count), 2] == len(plan.table.rows)).all()
