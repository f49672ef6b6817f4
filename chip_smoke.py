#!/usr/bin/env python3
"""Drive the torch port on one CUDA card and hold its kernels to account.

Phases (any failure exits non-zero without the result line):

1. build   — ``nvcc`` builds csrc/variant_kernel.cu and
             csrc/blocked_kernel.cu for sm_90a, side by side;
2. kernel  — the variant kernel against its plain PyTorch version on the
             card, at sup-20 (seed 0, P2 Q10, 5/5/5 cuts) fragments and
             chunk 504: folded+staged, folded unstaged, full rows, and
             folded+staged on a shuffled label order; max |err| <= 1e-5;
3. blocked — the segmented blocked kernel against its plain version:
             sup-20's 15-qubit fragments forced through it at windows 10
             and 13 (one 504-label chunk; the variant kernel's rows are a
             third witness), and hwe-40's two 22-qubit fragments at the
             default window (14) and at 13, all 36 labels in chunks of
             16; <= 1e-5;
4. main    — genCirc("sup", 20, 1, seed=0) -> Cutter -> VirtualCircuit ->
             run_virtual_circuit(engine="pallas", chunk_size=504) on cuda,
             Hellinger fidelity against the uncut oracle > 1 - 1e-5, with
             the kernels' launch counts read around the run; ghz-24 (P2,
             Q12) the same way; sup-20 once more with every fragment
             forced through the blocked kernel (window 13), same oracle;
5. wide    — hwe-40 (depth 2, seed 0, P2 Q21, stored cut plan; two
             22-qubit fragments): the 20-clbit marginal through
             run_virtual_circuit(engine="pallas", keep_clbits=...) and
             <Z...Z> through streamed_expectation_z; the marginal sums to
             1, the two agree, the marginal knitted from the plain version
             agrees, and the blocked kernel was launched segments x chunks
             times per fragment.  ghz-40 (P2 Q20, cut on the host): the
             marginal is 1/2 on all-zeros and all-ones, <Z> on an even
             support is 1;
6. where the time goes — host build of the scan, the run without the
             simplex projection, and a torch.profiler trace (device time
             by kernel, device idle share of the wall) for sup-20, ghz-24
             and hwe-40;
7. report  — one JSON line of kernels (launches, error, times, bound), the
             card's name and power limit, and the contract's last line.

Run from the repository root: ``python3 chip_smoke.py``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PKG = "hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch"
TOL = 1e-5           # kernel vs plain: f32, different summation order
FID_MIN = 1 - 1e-5   # cut-vs-uncut oracle on the exact path
CHUNK = 504
DEV = "cuda"
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_F32 = 67e12      # H100 SXM f32 outside the tensor cores, FLOP/s
TPU_KERNEL = ("hardwareawareoptimalquantumcircuitcuttingandknitting_tpu/"
              "ops/pallas_variant.py:577")
TPU_BLOCKED = ("hardwareawareoptimalquantumcircuitcuttingandknitting_tpu/"
               "ops/pallas_blocked.py:168")
HWE_CHUNK = 512      # capped by auto_chunk to 16 labels at 22 qubits


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        else f"nvidia-smi failed ({res.returncode})"


def _time_ms(fn, reps: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _port(module: str):
    """A module of the port, by its name below the package."""
    return importlib.import_module(f"{PKG}.{module}")


def _cut(name, n, cap, seed, depth=1, stored_plan=None):
    """(circuit, VirtualCircuit) of genCirc(name, n, depth, seed) cut into
    2 partitions of at most ``cap`` qubits: by the solver, or by a plan
    stored in the package (solved once, loaded here)."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
        VirtualCircuit,
    )

    circ = genCirc(name, n, depth, seed=seed)
    cutter = Cutter(circ, maxNPartitions=2, maxNQubitsPerPartition=cap,
                    maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    if stored_plan is not None:
        cutter.use_plan(_port("plans").load_plan(stored_plan))
    elif not cutter.solve():
        raise RuntimeError(f"no cut plan for {name}-{n}")
    return circ, VirtualCircuit(cutter.getResultCircs()[3])


def phase_kernel(virt, report):
    """Every kernel mode against the plain version on sup-20's fragments,
    one chunk of 504 labels through both fragments per measurement."""
    import numpy as np
    import torch

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.convert import (  # noqa: E501
        to_device,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        variant_kernel as vk,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.knit import (  # noqa: E501
        fold_weights,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.variant_engine import (  # noqa: E501
        label_strides,
        variant_index_table,
    )

    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, total = label_strides(specs, range(len(specs)))
    vidx = variant_index_table(range(len(specs)), strides, n_inst, total)
    perm = np.random.default_rng(0).permutation(total)
    blocks = {
        "natural": torch.as_tensor(vidx[:CHUNK], device=DEV,
                                   dtype=torch.int64),
        "shuffled": torch.as_tensor(vidx[perm[:CHUNK]], device=DEV,
                                    dtype=torch.int64),
    }
    modes = [
        ("folded_staged", "natural", True, True),
        ("folded_unstaged", "natural", True, False),
        ("full_rows_staged", "natural", False, True),
        ("folded_staged_shuffled", "shuffled", True, True),
    ]
    names = [r.name for r in virt.fragments]
    rows = []
    for mode, order, folded, staged in modes:
        blk = blocks[order]
        calls = []
        err = 0.0
        # roofline work from the function's own stage array (a full replay
        # at row 0 only); what the kernel runs adds a full replay at the
        # start of every block's run
        work = {"bytes": 0, "flops": 0, "pass_bytes": 0}
        kwork = dict(work)
        for name in names:
            if folded:
                fn, _ = vk.make_folded_chunk_kernel(virt, name, CHUNK,
                                                    staged=staged,
                                                    device=DEV)
            else:
                fn, _ = vk.make_chunk_kernel(virt, name, CHUNK,
                                             staged=staged, device=DEV)
            dp = fn.plan
            if folded:
                w = to_device([np.asarray(t, np.float32)
                               for t in fold_weights(virt, name)], DEV)
                gids = list(virt.programs[name].touching)
                ws = torch.stack([t[blk[:, g]] for t, g in zip(w, gids)],
                                 dim=1).contiguous()
            else:
                ws = torch.ones((CHUNK, 1, 2), device=DEV)
            ent = dp.gather_entries(blk)
            st = dp.stages(blk)
            span = vk.default_labels_per_cta(CHUNK, DEV)
            got = vk.variant_rows(dp, ent, ws, st, span)
            want = vk.plain_variant_rows(dp, ent, ws)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{mode}/{name}: non-finite kernel rows")
            err = max(err, (got - want).abs().max().item())
            st_np = st.cpu().numpy()
            wk = vk.work_counts(dp.plan, st_np, ws.shape[1])
            kw = vk.work_counts(dp.plan, vk.effective_stages(st_np, span),
                                ws.shape[1])
            for key in work:
                work[key] += wk[key]
                kwork[key] += kw[key]
            calls.append((dp, ent, ws, st, span))
        ms = _time_ms(lambda: [vk.variant_rows(*a) for a in calls], reps=10)
        plain_ms = _time_ms(
            lambda: [vk.plain_variant_rows(*a[:3]) for a in calls], reps=2,
            warm=1,
        )
        bound_ms, bound_by = _bound(work)
        rows.append({
            "name": f"variant_rows/{mode}",
            "route": "cuda",
            "source": f"{PKG}/csrc/variant_kernel.cu",
            "replaces": TPU_KERNEL,
            "launches": None,  # filled from the main path's run
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "on_main_path": mode == "folded_staged",
            "work": work,
            "kernel_work": kwork,
        })
        print(f"kernel {mode}: max_abs_err={err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} "
              f"({bound_by}) for one {CHUNK}-label chunk "
              f"through {len(names)} fragments; kernel state passes "
              f"{kwork['pass_bytes'] / 1e9:.3f} GB = "
              f"{kwork['pass_bytes'] / ms / 1e6:.1f} GB/s; block-run "
              f"starts add {(kwork['flops'] - work['flops']) / 1e9:.4f} "
              f"GFLOP over the function's {work['flops'] / 1e9:.4f}",
              flush=True)
        if not err <= TOL:
            raise RuntimeError(f"{mode}: kernel vs plain {err:.3e} > {TOL}")
    report.setdefault("kernels", []).extend(rows)
    report["launches_during_comparison"] = vk.variant_rows.launches


def _bound(work):
    """(bound_ms, bound_by) of a work count on one H100."""
    t_bytes = work["bytes"] / PEAK_BYTES * 1e3
    t_ops = work["flops"] / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _label_blocks(virt, chunk, first_only=False):
    """The global label table in blocks of ``chunk`` rows on the card (the
    last one short)."""
    import torch

    ve = _port("ops.variant_engine")
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, total = ve.label_strides(specs, range(len(specs)))
    vidx = ve.variant_index_table(range(len(specs)), strides, n_inst, total)
    stop = chunk if first_only else total
    return [torch.as_tensor(vidx[c0:c0 + chunk], device=DEV,
                            dtype=torch.int64)
            for c0 in range(0, stop, chunk)]


def phase_blocked(label, virt, window, blocks, report, witness):
    """The blocked kernel against its plain version on every fragment of
    ``virt`` (forced through it at ``window``) and every label block;
    times for the first block through all fragments: the segment launches
    alone (the kernel), and the whole chunk with its re-tiles."""
    import torch

    bk = _port("ops.blocked_kernel")
    vk = _port("ops.variant_kernel")
    permute_bits_flat = _port("ops.bits").permute_bits_flat
    labels = blocks[0].shape[0]
    err = werr = 0.0
    seg_calls, chunk_calls = [], []
    work = {"bytes": 0, "flops": 0}
    segments = {}
    for name in (r.name for r in virt.fragments):
        fn, _ = bk.make_blocked_chunk_kernel(virt, name, labels,
                                             window=window, force=True,
                                             device=DEV)
        dp = fn.plan
        plan = dp.plan
        segments[name] = len(plan.segments)
        for blk in blocks:
            ent = dp.gather_entries(blk)
            got = bk.blocked_rows(dp, ent)
            want = bk.plain_blocked_rows(dp, ent)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{label}/{name}: non-finite kernel rows")
            err = max(err, (got - want).abs().max().item())
            del got, want
        if witness:
            v_fn, _ = vk.make_chunk_kernel(virt, name, labels, device=DEV)
            werr = max(werr, (fn(blocks[0]) - v_fn(blocks[0])).abs().max()
                       .item())
        # every segment of the first block with a state of its own to
        # run on (a launch works in place; its time does not depend on
        # the values)
        ent = dp.gather_entries(blocks[0])
        state = dp.prefix
        for k in range(len(plan.segments)):
            if k:
                state = permute_bits_flat(
                    state, list(range(plan.n)), plan.retiles[k - 1]
                ).clone(memory_format=torch.contiguous_format)
            seg_calls.append((dp, k, state, ent))
            state = bk.apply_segment(dp, k, state, ent)
            wk = bk.work_counts(plan, k, labels)
            work["bytes"] += wk["bytes"]
            work["flops"] += wk["flops"]
        del state
        chunk_calls.append((dp, ent))
    ms = _time_ms(lambda: [bk.apply_segment(*a) for a in seg_calls], reps=5)
    plain_ms = _time_ms(lambda: [bk.plain_segment(*a) for a in seg_calls],
                        reps=1, warm=1)
    chunk_ms = _time_ms(lambda: [bk.blocked_rows(*a) for a in chunk_calls],
                        reps=3, warm=1)
    plain_chunk_ms = _time_ms(
        lambda: [bk.plain_blocked_rows(*a) for a in chunk_calls], reps=1,
        warm=0,
    )
    bound_ms, bound_by = _bound(work)
    report.setdefault("kernels", []).append({
        "name": f"blocked_rows/{label}",
        "route": "cuda",
        "source": f"{PKG}/csrc/blocked_kernel.cu",
        "replaces": TPU_BLOCKED,
        "launches": None,  # filled from the main path's run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "on_main_path": False,  # set by the path that launches it
        "work": work,
        "chunk_ms": chunk_ms,
        "plain_chunk_ms": plain_chunk_ms,
        "window": plan.w,
        "labels": labels,
        "segments": segments,
        "variant_kernel_witness_err": werr if witness else None,
    })
    print(f"blocked {label}: window={plan.w} segments={segments} "
          f"blocks={[b.shape[0] for b in blocks]} max_abs_err={err:.3e} "
          f"witness_err={werr if witness else None} | one {labels}-label "
          f"chunk through {len(segments)} fragments: segment launches "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} "
          f"({bound_by}; {work['bytes'] / 1e9:.3f} GB, "
          f"{work['flops'] / 1e9:.3f} GFLOP) = "
          f"{work['bytes'] / ms / 1e6:.1f} GB/s; with re-tiles and "
          f"|psi|^2 chunk_ms={chunk_ms:.4f} plain_chunk_ms="
          f"{plain_chunk_ms:.4f}", flush=True)
    if not err <= TOL:
        raise RuntimeError(f"{label}: blocked kernel vs plain {err:.3e} > "
                           f"{TOL}")
    if witness and not werr <= TOL:
        raise RuntimeError(f"{label}: blocked vs variant kernel rows "
                           f"{werr:.3e} > {TOL}")


def _kernel_row(report, name):
    return next(r for r in report["kernels"] if r["name"] == name)


def _reset_counts():
    _port("ops.blocked_kernel").blocked_rows.launches = 0
    _port("ops.variant_kernel").variant_rows.launches = 0


def _counts():
    return {"blocked": _port("ops.blocked_kernel").blocked_rows.launches,
            "variant": _port("ops.variant_kernel").variant_rows.launches}


def phase_forced_sup20(circ, virt, report, window=13):
    """The oracle at a width that has one: sup-20 end to end with every
    fragment forced through the blocked kernel."""
    import torch

    streamed = _port("ops.streamed")
    sv = _port("ops.statevector")
    step, xs, meta = streamed.make_streamed_knit(
        virt, CHUNK, device=DEV, blocked_window=window
    )
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    values = step(xs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    row = _kernel_row(report, f"blocked_rows/sup20_w{window}")
    expect = meta["n_chunks"] * sum(row["segments"].values())
    dist = sv.Distribution(
        _port("ops.knit").smolin_project(values).to(torch.float32).cpu()
        .numpy(), meta["positions"], virt.num_clbits,
    )
    fid = _port("evaluate").hellinger_fidelity(
        sv.simulate_circuit(circ, device=DEV), dist
    )
    report["sup20_forced_blocked"] = {
        "window": window, "launches": counts, "expected_launches": expect,
        "fragment_kernels": meta["fragment_kernels"], "scan_s": wall,
        "fidelity": fid,
    }
    print(f"main sup20 forced blocked (window {window}): launches={counts} "
          f"expected={expect} scan_s={wall:.4f} fidelity={fid!r}",
          flush=True)
    if counts != {"blocked": expect, "variant": 0}:
        raise RuntimeError(f"forced blocked route launched {counts}, "
                           f"expected {expect} blocked launches only")
    if not fid > FID_MIN:
        raise RuntimeError(f"forced blocked fidelity {fid!r} <= {FID_MIN}")
    row["launches"] = counts["blocked"]
    row["on_main_path"] = True


def _written_data_clbits(virt):
    """Per fragment, the data clbits its measures write, ascending."""
    return [sorted(c for c in virt.programs[r.name].clbit_sources
                   if c < virt.num_clbits) for r in virt.fragments]


@contextlib.contextmanager
def _plain_segments():
    """Within: the blocked route runs its plain PyTorch segments instead
    of the kernel (the wrapper itself never does that on a CUDA tensor)."""
    bk = _port("ops.blocked_kernel")
    kernel = bk.apply_segment
    bk.apply_segment = bk.plain_segment
    try:
        yield
    finally:
        bk.apply_segment = kernel


def _z_of_marginal(values):
    """<Z...Z> over every bit of a flat little-endian distribution."""
    import numpy as np

    idx = np.arange(len(values))
    par = np.zeros(len(values), np.int64)
    for j in range(len(values).bit_length() - 1):
        par ^= (idx >> j) & 1
    return float(np.sum(np.asarray(values, np.float64) * (1 - 2 * par)))


def phase_wide(label, virt, report, analytic, kernel_row=None):
    """The blocked route's main path at full width: the marginal on 10
    written data clbits of each fragment through run_virtual_circuit and
    <Z...Z> on them through streamed_expectation_z, launches counted
    around each.  ``analytic``: the circuit is a GHZ state, whose marginal
    and even-support <Z> are known; otherwise the marginal is held to the
    scalar-carry <Z>.  Either way the same knit from the plain version's
    segments must agree.  ``kernel_row``: the report's kernel row whose
    launches this path supplies."""
    import numpy as np
    import torch

    streamed = _port("ops.streamed")
    run_virtual_circuit = _port("run").run_virtual_circuit
    keep = sorted(c for cs in _written_data_clbits(virt) for c in cs[:10])
    widths = [virt.programs[r.name].num_sim_qubits for r in virt.fragments]
    chunk = streamed.auto_chunk(virt, HWE_CHUNK)

    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    dist, _ = run_virtual_circuit(virt, engine="pallas",
                                  chunk_size=HWE_CHUNK, keep_clbits=keep,
                                  project=False, device=DEV)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _counts()
    values = np.asarray(dist.values, np.float64)
    total = float(values.sum())

    z_support = keep if not analytic else [keep[0], keep[-1]]
    _reset_counts()
    t0 = time.perf_counter()
    z_val = streamed.streamed_expectation_z(virt, z_support,
                                            chunk=HWE_CHUNK, device=DEV)
    z_s = time.perf_counter() - t0
    z_counts = _counts()

    # the scan alone, built once: which kernel backs which fragment, warm
    # times, and the same knit from the plain version's segments
    t0 = time.perf_counter()
    step, xs, meta = streamed.make_streamed_knit(virt, chunk,
                                                 keep_clbits=keep,
                                                 device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    segs = {n: len(dp.plan.segments)
            for n, dp in meta["fragment_plans"].items()}
    expect = meta["n_chunks"] * sum(segs.values())
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = step(xs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _reset_counts()
    with _plain_segments():
        plain = step(xs)
    torch.cuda.synchronize()
    plain_counts = _counts()
    plain_err = (warm - plain).abs().max().item()
    rerun_err = float(np.abs(warm.cpu().numpy() - dist.values).max())
    prof = _profile(lambda: step(xs))

    out = {
        "labels": meta["global_labels"], "fragment_sim_qubits": widths,
        "chunk": chunk, "n_chunks": meta["n_chunks"], "keep_clbits": keep,
        "segments": segs, "launches": counts, "expected_launches": expect,
        "z_launches": z_counts, "first_run_s": first_s,
        "expectation_z_s": z_s, "host_build_s": build_s,
        "warm_scan_s": walls, "marginal_sum": total, "z_support": z_support,
        "expectation_z": z_val, "plain_knit_max_abs_err": plain_err,
        "rerun_max_abs_err": rerun_err,
        "pallas_fragments": meta["pallas_fragments"],
        "fragment_kernels": meta["fragment_kernels"],
    }
    out.update(prof)
    report[label] = out
    print(f"main {label}: labels={out['labels']} fragment_sim_qubits="
          f"{widths} chunk={chunk} x{meta['n_chunks']} segments={segs} "
          f"launches={counts} expected={expect} z_launches={z_counts} "
          f"first_run_s={first_s:.4f} expectation_z_s={z_s:.4f} "
          f"host_build_s={build_s:.4f} warm_scan_s="
          f"{[round(w, 4) for w in walls]} marginal_sum={total!r} "
          f"expectation_z={z_val!r} plain_knit_err={plain_err:.3e} "
          f"device_busy_ms={out['device_busy_ms']} "
          f"idle_share={out['device_idle_share']}", flush=True)
    for row in out["device_ms_by_kernel"][:5]:
        print(f"  device {row['ms']:.3f} ms x{row['calls']}: "
              f"{row['kernel']}", flush=True)

    def need(ok, what):
        if not ok:
            raise RuntimeError(f"{label}: {what}")

    gate = _port("ops.variant_kernel").MAX_QUBITS
    need(all(w > gate for w in widths),
         f"fragment widths {widths} are within the variant kernel's gate")
    need(np.isfinite(values).all() and values.shape == (1 << len(keep),),
         "marginal not finite or of the wrong shape")
    need(counts == {"blocked": expect, "variant": 0},
         f"launched {counts}, expected {expect} blocked launches only")
    need(z_counts == counts, f"expectation launched {z_counts}")
    need(plain_counts == {"blocked": 0, "variant": 0},
         f"the plain knit launched kernels: {plain_counts}")
    need(all(meta["pallas_fragments"].values())
         and set(meta["fragment_kernels"].values()) == {"blocked"},
         "fragments not backed by the blocked kernel: "
         f"{meta['fragment_kernels']}")
    need(abs(total - 1) <= TOL, f"marginal sums to {total!r}")
    need(plain_err <= TOL and rerun_err <= TOL,
         f"plain knit differs by {plain_err:.3e}, rerun by {rerun_err:.3e}")
    if analytic:
        want = np.zeros_like(values)
        want[0] = want[-1] = 0.5
        ghz_err = float(np.abs(values - want).max())
        out["ghz_marginal_max_abs_err"] = ghz_err
        need(ghz_err <= TOL, f"GHZ marginal off by {ghz_err:.3e}")
        need(abs(z_val - 1) <= TOL, f"GHZ <ZZ> = {z_val!r}")
    else:
        z_marg = _z_of_marginal(values)
        out["z_of_marginal"] = z_marg
        need(abs(z_val - z_marg) <= TOL,
             f"<Z> {z_val!r} vs from the marginal {z_marg!r}")
    if kernel_row is not None:
        row = _kernel_row(report, kernel_row)
        row["launches"] = counts["blocked"]
        row["on_main_path"] = True


def _profile(fn):
    """A torch.profiler trace of one ``fn()``: device time by kernel and
    the device's busy share of the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels, copies): a host op's own device
    # time repeats the kernels it launched, so key_averages would count
    # them twice; busy time is the union of the device intervals
    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    busy_us, reach = 0.0, float("-inf")
    for s, t in sorted(spans):
        busy_us += max(0.0, t - max(s, reach))
        reach = max(reach, t)
    busy_ms = busy_us / 1e3
    by_kernel = sorted(((k, us / 1e3, n) for k, (us, n) in per_name.items()),
                       key=lambda t: -t[1])
    return {
        "profiled_wall_s": wall,
        "device_busy_ms": busy_ms if by_kernel else "not measured",
        "device_idle_share": (1 - busy_ms / (wall * 1e3)) if by_kernel
        else "not measured",
        "device_ms_by_kernel": [
            {"kernel": k[:80], "ms": ms, "calls": n}
            for k, ms, n in by_kernel[:8]
        ],
    }


def phase_main(label, circ, virt, report, timed_reps=1):
    """The user's path on the card, kernel launches counted around it."""
    import torch

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.evaluate import (  # noqa: E501
        hellinger_fidelity,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        variant_kernel as vk,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.statevector import (  # noqa: E501
        simulate_circuit,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
        run_virtual_circuit,
    )

    total = 1
    for vg in virt.vgates:
        total *= vg.spec.num_instantiations
    widths = [virt.programs[r.name].num_sim_qubits for r in virt.fragments]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    dist, info = run_virtual_circuit(virt, engine="pallas",
                                     chunk_size=CHUNK, device=DEV)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _counts()
    launches = counts["variant"]
    walls = []
    for _ in range(timed_reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_virtual_circuit(virt, engine="pallas", chunk_size=CHUNK,
                            device=DEV)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    oracle = simulate_circuit(circ, device=DEV)
    fid = hellinger_fidelity(oracle, dist)
    out = {
        "labels": total, "fragment_sim_qubits": widths,
        "chunk": CHUNK, "launches": launches, "first_run_s": first_s,
        "warm_wall_s": walls, "fidelity": fid,
    }
    report[label] = out
    print(f"main {label}: labels={total} fragment_sim_qubits={widths} "
          f"launches={launches} first_run_s={first_s:.4f} "
          f"warm_wall_s={[round(w, 4) for w in walls]} fidelity={fid!r}",
          flush=True)
    if not launches > 0 or counts["blocked"]:
        raise RuntimeError(f"{label}: launched {counts}, expected the "
                           "variant kernel only")
    if not fid > FID_MIN:
        raise RuntimeError(f"{label}: fidelity {fid!r} <= {FID_MIN}")


def phase_breakdown(label, virt, report):
    """Where one warm run's time goes: the host build of the scan (plans,
    prefix states, tables), the run without the simplex projection, and a
    torch.profiler trace of one run (device time by kernel, device busy
    share of the wall)."""
    import torch

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops.streamed import (  # noqa: E501
        make_streamed_knit,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.run import (  # noqa: E501
        run_virtual_circuit,
    )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    make_streamed_knit(virt, CHUNK, device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_virtual_circuit(virt, chunk_size=CHUNK, project=False, device=DEV)
    torch.cuda.synchronize()
    unprojected_s = time.perf_counter() - t0
    out = {"host_build_s": build_s, "warm_unprojected_s": unprojected_s}
    out.update(_profile(
        lambda: run_virtual_circuit(virt, chunk_size=CHUNK, device=DEV)
    ))
    report[label + "_breakdown"] = out
    print(f"breakdown {label}: host_build_s={build_s:.4f} "
          f"warm_unprojected_s={unprojected_s:.4f} profiled_wall_s="
          f"{out['profiled_wall_s']:.4f} device_busy_ms={out['device_busy_ms']} "
          f"idle_share={out['device_idle_share']}", flush=True)
    for row in out["device_ms_by_kernel"][:4]:
        print(f"  device {row['ms']:.3f} ms x{row['calls']}: "
              f"{row['kernel']}", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / PKG).is_dir():
        print(f"chip_smoke: {PKG} not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # exact f32 everywhere: no TF32 in any matrix product
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = _card_line()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    failed = []

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        try:
            fn(*args)
        except Exception as exc:  # a failed phase fails the run
            import traceback

            traceback.print_exc()
            failed.append(f"{name}: {exc}")
        report.setdefault("phase_s", {})[name] = time.perf_counter() - t0

    def build():
        libs = [_port("ops.variant_kernel").LIBRARY,
                _port("ops.blocked_kernel").LIBRARY]
        t0 = time.perf_counter()
        _port("ops.kernel_build").build_all(libs)
        report["build_s"] = time.perf_counter() - t0
        print(f"build: {report['build_s']:.2f} s for "
              f"{[lib.path.name for lib in libs]}")
        for lib in libs:
            for line in lib.log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {lib.stem}:", line.strip())

    phase("build", build)
    if failed:
        print("chip_smoke FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    cuts = {}

    def cut(key, *args, **kw):
        def run():
            cuts[key] = _cut(*args, **kw)
        phase("cut_" + key, run)
        return key in cuts

    if cut("sup20", "sup", 20, 10, 0):
        circ, virt = cuts["sup20"]
        phase("kernel", phase_kernel, virt, report)
        for window in (10, 13):
            phase(f"blocked_sup20_w{window}", phase_blocked,
                  f"sup20_w{window}", virt, window,
                  _label_blocks(virt, CHUNK, first_only=True), report, True)
        phase("main_sup20", phase_main, "sup20", circ, virt, report, 1)
        phase("main_sup20_forced_blocked", phase_forced_sup20, circ, virt,
              report)
        phase("breakdown_sup20", phase_breakdown, "sup20", virt, report)
    if cut("ghz24", "ghz", 24, 12, None):
        circ, virt = cuts["ghz24"]
        phase("main_ghz24", phase_main, "ghz24", circ, virt, report, 1)
        phase("breakdown_ghz24", phase_breakdown, "ghz24", virt, report)
    if cut("hwe40", "hwe", 40, 21, 0, depth=2,
           stored_plan="hwe40_d2_p2_q21"):
        _, virt = cuts["hwe40"]
        chunk = _port("ops.streamed").auto_chunk(virt, HWE_CHUNK)
        blocks = _label_blocks(virt, chunk)
        phase("blocked_hwe40", phase_blocked, "hwe40", virt,
              _port("ops.blocked_kernel").DEFAULT_WINDOW, blocks, report,
              False)
        # the other window the shared memory allows two CTAs per SM at
        phase("blocked_hwe40_w13", phase_blocked, "hwe40_w13", virt, 13,
              blocks, report, False)
        phase("main_hwe40", phase_wide, "hwe40", virt, report, False,
              "blocked_rows/hwe40")
    if cut("ghz40", "ghz", 40, 20, None):
        phase("main_ghz40", phase_wide, "ghz40", cuts["ghz40"][1], report,
              True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if failed:
        report["failed"] = failed
        (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
        print("chip_smoke FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    kernels = []
    for row in report["kernels"]:
        row = dict(row)
        if row["launches"] is None:
            # the sup-20 main path runs the variant kernel's folded+staged
            # mode only; a row no main path claimed was launched in its
            # comparison phase alone
            row["launches"] = (report["sup20"]["launches"]
                               if row["on_main_path"] else 0)
        for key in ("work", "kernel_work", "segments"):
            row.pop(key, None)
        kernels.append(row)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
