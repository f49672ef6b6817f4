#!/usr/bin/env python3
"""Drive the torch port on one CUDA card and hold its kernels to account.

Phases (any failure exits non-zero without the result line):

1. build   — ``nvcc`` builds csrc/variant_kernel.cu, csrc/blocked_kernel.cu
             and csrc/collapse_kernel.cu for sm_90a, side by side;
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
4. collapse — the collapse kernel against its plain version on one block
             of sampled labels, of the size the sampled engine's scan
             launches for that epilogue (4096 labels, or what 512 MiB of
             full rows hold), with numpy draws from a fixed seed:
             qft-16's two fragments (15 qubits and 1 qubit, 15 collapse
             sites each) as full rows, as the marginal on clbits 0..3 and
             as the Z columns of five z-sets, and both endpoints of a
             wire cut (ghz-18, P2 Q10, one wire cut) as full rows; picked
             bits equal (a flip only within 1e-6 of its threshold, counted
             apart), <= 1e-5;
5. main    — genCirc("sup", 20, 1, seed=0) -> Cutter -> VirtualCircuit ->
             run_virtual_circuit(engine="pallas", chunk_size=504) on cuda,
             Hellinger fidelity against the uncut oracle > 1 - 1e-5, with
             the kernels' launch counts read around the run; ghz-24 (P2,
             Q12) the same way; sup-20 once more with every fragment
             forced through the blocked kernel (window 13), same oracle;
6. sampled — sup-20 through the sampled engine's scan in ancilla mode (the
             variant kernel's full rows on a main path): all 7776 labels
             with their exact sampling mass reproduce the exact knit of
             engine="pallas" within 1e-6, and the kernel's full rows equal
             the plain version's on the scan's own first and last block.
             qft-16 (h and rz(uniform(0,
             2 pi), default_rng(5)) on each of 16 qubits, library_qft(16),
             all measured; Cutter(P2, Q15, gammaMode=True): 15 cp cuts):
             120000 samples, lhs, control variate, through
             run_virtual_circuit(engine="sampled", keep_clbits=[0..3]) and
             sampled_expectation_z on five z-sets; every marginal bin and
             every <Z_S> within 5 reported standard errors (floor 1e-3)
             of the 2^16 oracle, a second call builds no plan, and one
             block knitted from the plain version agrees within 1e-5;
7. wide    — hwe-40 (depth 2, seed 0, P2 Q21, stored cut plan; two
             22-qubit fragments): the 20-clbit marginal through
             run_virtual_circuit(engine="pallas", keep_clbits=...) and
             <Z...Z> through streamed_expectation_z; the marginal sums to
             1, the two agree, the marginal knitted from the plain version
             agrees, and the blocked kernel was launched segments x chunks
             times per fragment.  ghz-40 (P2 Q20, stored cut plan): the
             marginal is 1/2 on all-zeros and all-ones, <Z> on an even
             support is 1;
8. where the time goes — host build of the scan, the run without the
             simplex projection, and a torch.profiler trace (device time
             by kernel, device idle share of the wall) for sup-20, ghz-24,
             hwe-40 and qft-16 (there also the host's label sampling);
9. report  — one JSON line of kernels (launches, error, times, bound), the
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
TPU_COLLAPSE = ("hardwareawareoptimalquantumcircuitcuttingandknitting_tpu/"
                "ops/pallas_variant.py:1165")
HWE_CHUNK = 512      # capped by auto_chunk to 16 labels at 22 qubits
QFT_SAMPLES = 120000
QFT_SEED = 17
QFT_KEEP = [0, 1, 2, 3]
QFT_Z_SETS = [{0}, {8}, {15}, {0, 1, 2, 3}, set(range(16))]
WIRE_SAMPLES = 4096      # sampling budget behind the wire cut's label rows
STDERRS = 5.0            # sampled estimate against the oracle
STDERR_FLOOR = 1e-3


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
    _port("ops.collapse_kernel").collapse_rows.launches = 0


def _counts():
    return {"blocked": _port("ops.blocked_kernel").blocked_rows.launches,
            "variant": _port("ops.variant_kernel").variant_rows.launches,
            "collapse": _port("ops.collapse_kernel").collapse_rows.launches}


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
    if counts != {"blocked": expect, "variant": 0, "collapse": 0}:
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
    need(counts == {"blocked": expect, "variant": 0, "collapse": 0},
         f"launched {counts}, expected {expect} blocked launches only")
    need(z_counts == counts, f"expectation launched {z_counts}")
    need(plain_counts == {"blocked": 0, "variant": 0, "collapse": 0},
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


def _cut_qft16():
    """(circuit, VirtualCircuit) of the sampled engine's flagship: an
    ``h`` and an ``rz(uniform(0, 2 pi))`` from ``default_rng(5)`` on each
    of 16 qubits, ``library_qft(16)``, all measured, cut 15|1 by the
    gamma-mode solver.  The solved plan must equal the stored one."""
    import math

    import numpy as np

    Circuit = _port("circuit.circuit").Circuit
    plan_signature = _port("cutter.solver").plan_signature
    rng = np.random.default_rng(5)
    circ = Circuit(16, 16)
    for q in range(16):
        circ.h(q)
        circ.rz(float(rng.uniform(0, 2 * math.pi)), q)
    for ins in _port("models.qft").library_qft(16).instructions:
        circ.instructions.append(ins.copy())
    for q in range(16):
        circ.measure(q, q)
    cutter = _port("cutter.cutter").Cutter(
        circ, maxNPartitions=2, maxNQubitsPerPartition=15, gammaMode=True
    )
    if not cutter.solve():
        raise RuntimeError("no gamma-mode cut plan for qft-16")
    stored = _port("plans").load_plan("qft16_prepped_p2_q15_gamma")
    if plan_signature(cutter.plan) != plan_signature(stored):
        raise RuntimeError("the solver's qft-16 plan is not the stored one")
    virt = _port("virt.virtual_circuit").VirtualCircuit(
        cutter.getResultCircs()[3]
    )
    return circ, virt


def _cut_ghz18_wire():
    """ghz-18 cut into 2 partitions of at most 10 qubits with exactly one
    wire cut: one endpoint measures (a collapse site), one prepares."""
    circ = _port("models.zoo").genCirc("ghz", 18, 1)
    cutter = _port("cutter.cutter").Cutter(
        circ, maxNPartitions=2, maxNQubitsPerPartition=10,
        forceNWireCuts=1, maxNQpdCuts=3, maxNCuts=3,
    )
    if not cutter.solve():
        raise RuntimeError("no wire-cut plan for ghz-18")
    virt = _port("virt.virtual_circuit").VirtualCircuit(
        cutter.getResultCircs()[3]
    )
    return circ, virt


def _sampled_labels(virt, samples, seed):
    """The sampled engine's own label rows for a budget: unique labels,
    the measuring ones replicated per sample, and their masses."""
    import numpy as np

    tq = _port("ops.qpd_sampling")
    uniq, counts = tq.sample_label_counts(virt, samples, seed, method="lhs")
    lab, fc = tq._expand_measuring_counts(virt, uniq,
                                          counts.astype(np.float64))
    return uniq, lab, fc / samples


def _label_block_of(lab_all, count, seed=0):
    """``count`` of the label rows, picked with a seed, in their order."""
    import numpy as np

    count = min(count, len(lab_all))
    pick = np.sort(np.random.default_rng(seed).choice(
        len(lab_all), count, replace=False))
    return lab_all[pick]


def phase_collapse(label, virt, lab_all, modes, report):
    """The collapse kernel against its plain version on every fragment of
    ``virt`` in collapse mode: one block of the sampled label rows
    ``lab_all`` at the size the sampled engine's scan launches for that
    epilogue (``qpd_sampling._label_block``), numpy draws from a fixed
    seed, the scalars the sampled engine itself builds.  ``modes``:
    epilogue name -> keywords of the row function."""
    import numpy as np
    import torch

    ck = _port("ops.collapse_kernel")
    tq = _port("ops.qpd_sampling")
    to_block = _port("convert").sampled_block_to_device
    names = [r.name for r in virt.fragments]
    for mode, kw in modes.items():
        lab_np = _label_block_of(
            lab_all, tq._label_block(virt, [True] * len(names), **kw))
        c = lab_np.shape[0]
        calls = []
        err, near, far, sites, measuring = 0.0, 0, 0, {}, 0
        work = {"bytes": 0, "flops": 0, "pass_bytes": 0}
        for fi, name in enumerate(names):
            built = tq._collapse_row_builder_pallas(virt, name, device=DEV,
                                                    **kw)
            if built is None:
                raise RuntimeError(f"{label}/{mode}/{name}: no kernel")
            fn, _, ns, _ = built
            dp = fn.rows_fn.plan
            u = np.random.default_rng(7 + 7919 * fi).random(
                (c, max(1, ns))).astype(np.float32)
            lab, u_dev = to_block(lab_np, u, DEV)
            ent, cscal = dp.gather_entries(lab), fn.scalars(lab, u_dev)
            got, bits = ck.collapse_rows(dp, ent, cscal)
            want, wbits, margins = ck.plain_collapse_rows(
                dp, ent, cscal, with_margins=True)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{label}/{mode}/{name}: non-finite rows")
            agree, n_near, n_far = ck.compare_picks(bits, wbits, margins)
            near, far = near + n_near, far + n_far
            if bool(agree.any()):
                err = max(err, (got - want)[agree].abs().max().item())
            on = int((cscal[:, :, 1] > 0).sum())
            measuring += on
            wk = ck.work_counts(dp.plan, c, on)
            for key in work:
                work[key] += wk[key]
            sites[name] = {"n": dp.plan.n, "sites": ns, "ops": len(dp.plan.ops)}
            calls.append((dp, ent, cscal))
            del got, want, margins
        ms = _time_ms(lambda: [ck.collapse_rows(*a) for a in calls], reps=5)
        plain_ms = _time_ms(
            lambda: [ck.plain_collapse_rows(*a) for a in calls], reps=1,
            warm=1,
        )
        bound_ms, bound_by = _bound(work)
        report.setdefault("kernels", []).append({
            "name": f"collapse_rows/{label}_{mode}",
            "route": "cuda",
            "source": f"{PKG}/csrc/collapse_kernel.cu",
            "replaces": TPU_COLLAPSE,
            "launches": None,  # filled from the main path's run
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "on_main_path": False,  # set by the path that launches it
            "work": work,
            "labels": c,
            "fragments": sites,
            "measuring_sites": measuring,
            "picks_flipped_near_threshold": near,
            "picks_flipped_far": far,
        })
        print(f"collapse {label}/{mode}: fragments={sites} labels={c} "
              f"measuring_sites={measuring} max_abs_err={err:.3e} "
              f"picks flipped near a threshold={near} far={far} | one "
              f"block through {len(names)} fragments: ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} "
              f"({bound_by}; {work['bytes'] / 1e6:.3f} MB, "
              f"{work['flops'] / 1e9:.3f} GFLOP); state passes "
              f"{work['pass_bytes'] / 1e9:.3f} GB = "
              f"{work['pass_bytes'] / ms / 1e6:.1f} GB/s", flush=True)
        if far:
            raise RuntimeError(f"{label}/{mode}: {far} labels took another "
                               "branch far from its threshold")
        if not err <= TOL:
            raise RuntimeError(f"{label}/{mode}: kernel vs plain "
                               f"{err:.3e} > {TOL}")


@contextlib.contextmanager
def _plain_collapse():
    """Within: the sampled scan takes its collapse rows from the plain
    PyTorch version instead of the kernel (the wrapper itself never does
    that on a CUDA tensor)."""
    ck = _port("ops.collapse_kernel")
    kernel = ck.collapse_rows
    ck.collapse_rows = ck.plain_collapse_rows
    try:
        yield
    finally:
        ck.collapse_rows = kernel


def phase_sampled_sup20(virt, report):
    """The variant kernel's full rows on a main path: the sampled engine's
    scan over sup-20 in ancilla mode.  Every label with its exact sampling
    mass reproduces the exact knit (the identity the estimator is
    unbiased against), held to engine="pallas"'s unprojected result."""
    import numpy as np
    import torch

    tq = _port("ops.qpd_sampling")
    ve = _port("ops.variant_engine")
    run_virtual_circuit = _port("run").run_virtual_circuit
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, total = ve.label_strides(specs, range(len(specs)))
    vidx = ve.variant_index_table(range(len(specs)), strides, n_inst, total)
    mass = np.ones(total)
    for g, spec in enumerate(specs):
        m = tq._variant_magnitudes(spec)
        mass *= (m / m.sum())[vidx[:, g]]
    flags = tq._collapse_flags(virt, "auto")
    block = tq._label_block(virt, flags)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    est = tq._estimate(virt, vidx, mass, collapse=flags, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    exact, _ = run_virtual_circuit(virt, engine="pallas", chunk_size=CHUNK,
                                   project=False, device=DEV)
    err = float(np.abs(np.asarray(est.values, np.float64)
                       - np.asarray(exact.values, np.float64)).max())
    expect = -(-total // block) * len(virt.fragments)
    # the kernel's full rows against the plain version at the launch
    # shapes of this path: its first block and its short last one
    vk = _port("ops.variant_kernel")
    rows_err = 0.0
    for fn in next(iter(virt._scan_step_cache.values()))["row_fns"]:
        dp = fn.rows_fn.plan
        for rows in (vidx[:block], vidx[(total - 1) // block * block:]):
            blk = torch.as_tensor(rows, device=DEV, dtype=torch.int64)
            ones = torch.ones((len(rows), 1, 2), device=DEV)
            ent = dp.gather_entries(blk)
            got = vk.variant_rows(dp, ent, ones, dp.stages(blk))
            want = vk.plain_variant_rows(dp, ent, ones)
            rows_err = max(rows_err, (got - want).abs().max().item())
    report["sampled_sup20"] = {
        "labels": total, "collapse_flags": flags, "block": block,
        "launches": counts, "expected_launches": expect, "wall_s": wall,
        "mass_sum": float(mass.sum()), "max_abs_err_vs_exact_knit": err,
        "full_rows_max_abs_err_at_path_blocks": rows_err,
    }
    print(f"main sampled sup20 (ancilla mode, full grid): labels={total} "
          f"block={block} launches={counts} expected={expect} "
          f"wall_s={wall:.4f} max_abs_err_vs_exact_knit={err:.3e} "
          f"full rows vs plain at blocks of {block} and "
          f"{total - (total - 1) // block * block}: {rows_err:.3e}",
          flush=True)
    if any(flags):
        raise RuntimeError(f"sup-20 went to collapse mode: {flags}")
    if counts != {"blocked": 0, "variant": expect, "collapse": 0}:
        raise RuntimeError(f"sampled sup-20 launched {counts}, expected "
                           f"{expect} variant launches only")
    if est.bit_positions != exact.bit_positions or not err <= 1e-6:
        raise RuntimeError(f"full-grid identity off by {err:.3e}")
    if not rows_err <= TOL:
        raise RuntimeError(f"full rows vs plain {rows_err:.3e} > {TOL}")
    row = _kernel_row(report, "variant_rows/full_rows_staged")
    row["launches"] = counts["variant"]
    row["on_main_path"] = True


def phase_main_qft16(circ, virt, report):
    """This slice's path at full width: qft-16 through the sampled engine
    (both fragments in collapse mode), the marginal and the Z panel held
    to the 2^16 oracle by their own standard errors."""
    import numpy as np
    import torch

    tq = _port("ops.qpd_sampling")
    run_virtual_circuit = _port("run").run_virtual_circuit
    simulate_circuit = _port("ops.statevector").simulate_circuit
    flags = tq._collapse_flags(virt, "auto")
    over = tq.sampling_overhead(virt)
    knit_kw = dict(seed=QFT_SEED, keep_clbits=QFT_KEEP, method="lhs",
                   control_variate=True, device=DEV)

    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    dist, _ = run_virtual_circuit(
        virt, shots=QFT_SAMPLES, engine="sampled", seed=QFT_SEED,
        sample_method="lhs", sample_cv=True, keep_clbits=QFT_KEEP,
        project=False, device=DEV,
    )
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _counts()
    cache = virt._scan_step_cache
    built = {k: list(map(id, v["row_fns"])) for k, v in cache.items()}

    # the same estimate again, now with its standard errors: the same
    # seed feeds the same labels and draws, and no plan is built
    _reset_counts()
    t0 = time.perf_counter()
    est, se = tq.sampled_knit(virt, QFT_SAMPLES, with_stderr=True, **knit_kw)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    rebuilt = {k: list(map(id, v["row_fns"]))
               for k, v in cache.items()} != built
    rerun_err = float(np.abs(np.asarray(est.values)
                             - np.asarray(dist.values)).max())

    _reset_counts()
    t0 = time.perf_counter()
    z_est, z_se = tq.sampled_expectation_z(
        virt, QFT_Z_SETS, QFT_SAMPLES, seed=QFT_SEED + 1, method="lhs",
        with_stderr=True, control_variate=True, device=DEV,
    )
    torch.cuda.synchronize()
    z_s = time.perf_counter() - t0
    z_counts = _counts()

    # the oracle: the uncut circuit at 2^16 (bit j of the index = clbit j)
    probs = np.asarray(simulate_circuit(circ, device=DEV).values, np.float64)
    idx = np.arange(len(probs))
    key = np.zeros(len(probs), np.int64)
    for j, c in enumerate(QFT_KEEP):
        key |= ((idx >> c) & 1) << j
    oracle_m = np.bincount(key, weights=probs, minlength=1 << len(QFT_KEEP))
    oracle_z = []
    for s_z in QFT_Z_SETS:
        par = np.zeros(len(probs), np.int64)
        for c in s_z:
            par ^= (idx >> c) & 1
        oracle_z.append(float(((1 - 2 * par) * probs).sum()))
    est_v = np.asarray(est.values, np.float64)
    m_dev = np.abs(est_v - oracle_m) / np.maximum(se, STDERR_FLOOR)
    z_dev = np.abs(np.asarray(z_est) - np.asarray(oracle_z)) / np.maximum(
        z_se, STDERR_FLOOR)

    # where the host's share goes: label sampling, and the scan's build
    t0 = time.perf_counter()
    uniq, lab_all, mass = _sampled_labels(virt, QFT_SAMPLES, QFT_SEED)
    sample_s = time.perf_counter() - t0
    block = tq._label_block(virt, flags, keep_clbits=QFT_KEEP)
    t0 = time.perf_counter()
    tq._build_scan(virt, flags, QFT_KEEP, None, DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    # one block of the same labels and draws at the size the path
    # launches (a leading block of the label rows draws the leading rows
    # of the same stream), knitted from the kernel and from the plain
    # version
    head = min(block, len(lab_all))
    scan_kw = dict(keep_clbits=QFT_KEEP, flags=flags,
                   collapse_seed=QFT_SEED * 31 + 17, block=head,
                   second_moment=True, control_stats=True, device=DEV)
    k_est = tq._scan_core(virt, lab_all[:head], mass[:head], **scan_kw)
    k_bits = [fn.rows_fn.last_bits.clone()
              for fn in next(iter(cache.values()))["row_fns"]]
    _reset_counts()
    with _plain_collapse():
        p_est = tq._scan_core(virt, lab_all[:head], mass[:head], **scan_kw)
        p_bits = [fn.rows_fn.last_bits.clone()
                  for fn in next(iter(cache.values()))["row_fns"]]
    plain_counts = _counts()
    plain_err = max(
        float(np.abs(np.asarray(k_est[0].values)
                     - np.asarray(p_est[0].values)).max()),
        float(np.abs(k_est[1] - p_est[1]).max()),
    )
    flipped = sum(int((a != b).any(dim=1).sum())
                  for a, b in zip(k_bits, p_bits))
    prof = _profile(lambda: tq.sampled_knit(virt, QFT_SAMPLES,
                                            with_stderr=True, **knit_kw))

    n_blocks = -(-len(lab_all) // block)
    expect = n_blocks * len(virt.fragments)
    out = {
        "cuts": len(virt.vgates), "gamma_total": over["gamma_total"],
        "kappa": over["kappa"], "samples": QFT_SAMPLES,
        "fragment_data_qubits": [virt.programs[r.name].num_data_qubits
                                 for r in virt.fragments],
        "fragment_sim_qubits": [virt.programs[r.name].num_sim_qubits
                                for r in virt.fragments],
        "collapse_flags": flags, "unique_labels": len(uniq),
        "expanded_labels": len(lab_all), "block": block,
        "n_blocks": n_blocks, "launches": counts,
        "expected_launches": expect, "z_launches": z_counts,
        "first_call_s": first_s, "second_call_s": second_s,
        "expectation_z_s": z_s, "label_sampling_s": sample_s,
        "scan_build_s": build_s, "second_call_rebuilt_a_plan": rebuilt,
        "rerun_max_abs_err": rerun_err,
        "marginal": est_v.tolist(), "marginal_stderr": se.tolist(),
        "oracle_marginal": oracle_m.tolist(),
        "marginal_worst_stderrs": float(m_dev.max()),
        "z": np.asarray(z_est).tolist(), "z_stderr": z_se.tolist(),
        "oracle_z": oracle_z, "z_worst_stderrs": float(z_dev.max()),
        "plain_block_labels": head, "plain_knit_max_abs_err": plain_err,
        "plain_block_picks_flipped": flipped,
    }
    out.update(prof)
    report["qft16"] = out
    print(f"main qft16: cuts={out['cuts']} gamma={over['gamma_total']:.4f} "
          f"fragments data={out['fragment_data_qubits']} "
          f"sim={out['fragment_sim_qubits']} collapse={flags} "
          f"samples={QFT_SAMPLES} unique_labels={len(uniq)} "
          f"expanded_labels={len(lab_all)} block={block} x{n_blocks} "
          f"launches={counts} expected={expect} z_launches={z_counts} "
          f"first_call_s={first_s:.4f} second_call_s={second_s:.4f} "
          f"expectation_z_s={z_s:.4f} label_sampling_s={sample_s:.4f} "
          f"scan_build_s={build_s:.4f} rebuilt={rebuilt} "
          f"marginal worst {m_dev.max():.2f} stderrs (max stderr "
          f"{se.max():.2e}), z worst {z_dev.max():.2f} stderrs (max stderr "
          f"{z_se.max():.2e}) plain_knit_err={plain_err:.3e} "
          f"picks_flipped={flipped} device_busy_ms={out['device_busy_ms']} "
          f"idle_share={out['device_idle_share']}", flush=True)
    print(f"  marginal {np.round(est_v, 5).tolist()}\n  oracle   "
          f"{np.round(oracle_m, 5).tolist()}\n  z {np.round(z_est, 5).tolist()}"
          f" oracle {np.round(oracle_z, 5).tolist()}", flush=True)
    for row in out["device_ms_by_kernel"][:5]:
        print(f"  device {row['ms']:.3f} ms x{row['calls']}: "
              f"{row['kernel']}", flush=True)

    def need(ok, what):
        if not ok:
            raise RuntimeError(f"qft16: {what}")

    need(flags == [True, True], f"collapse flags {flags}")
    need(np.isfinite(est_v).all() and est_v.shape == (1 << len(QFT_KEEP),)
         and dist.bit_positions == QFT_KEEP,
         "marginal not finite or of the wrong shape")
    need(counts == {"blocked": 0, "variant": 0, "collapse": expect},
         f"launched {counts}, expected {expect} collapse launches only")
    need(z_counts["collapse"] > 0 and not z_counts["variant"],
         f"<Z> launched {z_counts}")
    need(plain_counts == {"blocked": 0, "variant": 0, "collapse": 0},
         f"the plain knit launched kernels: {plain_counts}")
    need(not rebuilt and len(cache) == 2,
         f"the second call built a plan ({len(cache)} cache entries)")
    need(rerun_err <= 1e-6, f"the second call differs by {rerun_err:.3e}")
    need(float(m_dev.max()) <= STDERRS,
         f"a marginal bin lies {m_dev.max():.2f} stderrs from the oracle")
    need(float(z_dev.max()) <= STDERRS,
         f"a <Z_S> lies {z_dev.max():.2f} stderrs from the oracle")
    need(plain_err <= TOL, f"plain knit differs by {plain_err:.3e} "
         f"({flipped} picks flipped)")
    for mode, n in (("marginal", counts["collapse"]),
                    ("z", z_counts["collapse"])):
        row = _kernel_row(report, f"collapse_rows/qft16_{mode}")
        row["launches"] = n
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
    if not launches > 0 or counts["blocked"] or counts["collapse"]:
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
                _port("ops.blocked_kernel").LIBRARY,
                _port("ops.collapse_kernel").LIBRARY]
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

    def cut(key, *args, build=_cut, **kw):
        def run():
            cuts[key] = build(*args, **kw)
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
        phase("sampled_sup20", phase_sampled_sup20, virt, report)
    if cut("qft16", build=_cut_qft16):
        circ, virt = cuts["qft16"]
        modes = {"rows": {}, "marginal": {"keep_clbits": QFT_KEEP},
                 "z": {"z_sets": QFT_Z_SETS}}
        phase("collapse_qft16", lambda: phase_collapse(
            "qft16", virt, _sampled_labels(virt, QFT_SAMPLES, QFT_SEED)[1],
            modes, report))
        phase("main_qft16", phase_main_qft16, circ, virt, report)
    if cut("ghz18_wire", build=_cut_ghz18_wire):
        _, virt = cuts["ghz18_wire"]
        phase("collapse_ghz18_wire", lambda: phase_collapse(
            "ghz18_wire", virt,
            _sampled_labels(virt, WIRE_SAMPLES, 3)[1], {"rows": {}},
            report))
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
    if cut("ghz40", "ghz", 40, 20, None, stored_plan="ghz40_p2_q20"):
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
        for key in ("work", "kernel_work", "segments", "fragments"):
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
