#!/usr/bin/env python3
"""Drive the torch port on one CUDA card and hold its kernel to account.

Phases (any failure exits non-zero without the result line):

1. build   — ``nvcc`` builds csrc/variant_kernel.cu for sm_90a;
2. kernel  — the variant kernel against its plain PyTorch version on the
             card, at sup-20 (seed 0, P2 Q10, 5/5/5 cuts) fragments and
             chunk 504: folded+staged, folded unstaged, full rows, and
             folded+staged on a shuffled label order; max |err| <= 1e-5;
3. main    — genCirc("sup", 20, 1, seed=0) -> Cutter -> VirtualCircuit ->
             run_virtual_circuit(engine="pallas", chunk_size=504) on cuda,
             Hellinger fidelity against the uncut oracle > 1 - 1e-5, with
             the kernel's launch count read around the run; then ghz-24
             (P2, Q12) the same way;
4. where the time goes — host build of the scan, the run without the
             simplex projection, and a torch.profiler trace (device time
             by kernel, device idle share of the wall) for both circuits;
5. report  — one JSON line of kernels (launches, error, times, bound), the
             card's name and power limit, and the contract's last line.

Run from the repository root: ``python3 chip_smoke.py``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

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


def _cut(name, n, cap, seed):
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.models.zoo import (  # noqa: E501
        genCirc,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
        VirtualCircuit,
    )

    circ = genCirc(name, n, 1, seed=seed)
    cutter = Cutter(circ, maxNPartitions=2, maxNQubitsPerPartition=cap,
                    maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    if not cutter.solve():
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
        t_bytes = work["bytes"] / PEAK_BYTES * 1e3
        t_ops = work["flops"] / PEAK_F32 * 1e3
        rows.append({
            "name": f"variant_rows/{mode}",
            "route": "cuda",
            "source": f"{PKG}/csrc/variant_kernel.cu",
            "replaces": TPU_KERNEL,
            "launches": None,  # filled from the main path's run
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "on_main_path": mode == "folded_staged",
            "work": work,
            "kernel_work": kwork,
        })
        print(f"kernel {mode}: max_abs_err={err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={max(t_bytes, t_ops):.6f} "
              f"({rows[-1]['bound_by']}) for one {CHUNK}-label chunk "
              f"through {len(names)} fragments; kernel state passes "
              f"{kwork['pass_bytes'] / 1e9:.3f} GB = "
              f"{kwork['pass_bytes'] / ms / 1e6:.1f} GB/s; block-run "
              f"starts add {(kwork['flops'] - work['flops']) / 1e9:.4f} "
              f"GFLOP over the function's {work['flops'] / 1e9:.4f}",
              flush=True)
        if not err <= TOL:
            raise RuntimeError(f"{mode}: kernel vs plain {err:.3e} > {TOL}")
    report["kernels"] = rows
    report["launches_during_comparison"] = vk.variant_rows.launches


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
    vk.variant_rows.launches = 0
    t0 = time.perf_counter()
    dist, info = run_virtual_circuit(virt, engine="pallas",
                                     chunk_size=CHUNK, device=DEV)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = vk.variant_rows.launches
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
    if not launches > 0:
        raise RuntimeError(f"{label}: the kernel was never launched")
    if not fid > FID_MIN:
        raise RuntimeError(f"{label}: fidelity {fid!r} <= {FID_MIN}")


def phase_breakdown(label, virt, report):
    """Where one warm run's time goes: the host build of the scan (plans,
    prefix states, tables), the run without the simplex projection, and a
    torch.profiler trace of one run (device time by kernel, device busy
    share of the wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_virtual_circuit(virt, chunk_size=CHUNK, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels, copies): a host op's own device
    # time repeats the kernels it launched, so key_averages would count
    # them twice; busy time is the union of the device intervals
    from torch.autograd import DeviceType

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
    out = {
        "host_build_s": build_s, "warm_unprojected_s": unprojected_s,
        "profiled_wall_s": wall,
        "device_busy_ms": busy_ms if by_kernel else "not measured",
        "device_idle_share": (1 - busy_ms / (wall * 1e3)) if by_kernel
        else "not measured",
        "device_ms_by_kernel": [
            {"kernel": k[:80], "ms": ms, "calls": n}
            for k, ms, n in by_kernel[:8]
        ],
    }
    report[label + "_breakdown"] = out
    print(f"breakdown {label}: host_build_s={build_s:.4f} "
          f"warm_unprojected_s={unprojected_s:.4f} profiled_wall_s="
          f"{wall:.4f} device_busy_ms={out['device_busy_ms']} "
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

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.ops import (  # noqa: E501
        variant_kernel as vk,
    )

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
        t0 = time.perf_counter()
        vk.build_library()
        report["build_s"] = time.perf_counter() - t0
        print(f"build: {report['build_s']:.2f} s ({vk._Library.path.name})")
        for line in vk._Library.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    phase("build", build)
    if failed:
        print("chip_smoke FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    sup = {}

    def cut_sup():
        sup["circ"], sup["virt"] = _cut("sup", 20, 10, 0)

    phase("cut_sup20", cut_sup)
    if "virt" in sup:
        phase("kernel", phase_kernel, sup["virt"], report)
        phase("main_sup20", phase_main, "sup20", sup["circ"], sup["virt"],
              report, 2)
        phase("breakdown_sup20", phase_breakdown, "sup20", sup["virt"],
              report)
    ghz = {}

    def cut_ghz():
        ghz["circ"], ghz["virt"] = _cut("ghz", 24, 12, None)

    phase("cut_ghz24", cut_ghz)
    if "virt" in ghz:
        phase("main_ghz24", phase_main, "ghz24", ghz["circ"], ghz["virt"],
              report, 1)
        phase("breakdown_ghz24", phase_breakdown, "ghz24", ghz["virt"],
              report)

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
        # the sup-20 main path runs the folded+staged mode only; the other
        # modes were launched in the comparison phase alone
        row["launches"] = (report["sup20"]["launches"]
                           if row["on_main_path"] else 0)
        row.pop("work")
        row.pop("kernel_work")
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
