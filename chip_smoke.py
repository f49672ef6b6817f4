#!/usr/bin/env python3
"""Drive the torch port on one CUDA card and hold its kernels to account.

Phases (any failure exits non-zero without the result line):

1. build   — ``nvcc`` builds csrc/variant_kernel.cu, csrc/blocked_kernel.cu,
             csrc/collapse_kernel.cu and csrc/sv_kernel.cu (the first and
             the third include csrc/statevec_common.cuh) for sm_90a, side
             by side;
2. kernel  — the variant kernel, through the row functions' call (labels
             sorted by slot digits, run table, kernel, rows put back),
             against its plain PyTorch version on the card, at sup-20
             (seed 0, P2 Q10, 5/5/5 cuts) fragments and chunk 504 (15
             qubits: a two-CTA cluster): folded+staged, folded unstaged,
             full rows, and folded+staged and full rows on a shuffled
             label order; max |err| <= 1e-5, a second call equal bit for
             bit, the kernel's passes and replayed work beside the
             function's own;
3. blocked — the segmented blocked kernel against its plain version:
             sup-20's 15-qubit fragments forced through it at windows 10
             and 13 (one 504-label chunk; the variant kernel's rows are a
             third witness), and hwe-40's two 22-qubit fragments at the
             default window (13) and at 14, all 36 labels in chunks of
             16, and the first chunk of hwe-40 with dense rotations
             (below); the prefix the card builds and the rows <= 1e-5
             (and <= 1e-4 of the largest entry), a second call equal bit
             for bit; the segment launches' time (GB/s against the
             bound) and the whole blocked_rows';
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
             Q12: 13 qubits, one CTA) the same way; sup-20 once more with
             every fragment forced through the blocked kernel (window
             13), same oracle;
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
             block knitted from the plain version agrees within 1e-5.
             The same qft-16 leg without a kernel (sample_pallas=False:
             make_sim_fn(collapse=True), plain PyTorch, no kernel
             launched): the same labels and draws (a quarter of the
             samples for its Z panel), the same 5-stderr gates, the
             first and last blocks of its scan against
             kernel 3's full rows from the same draws (picks equal, a
             flip only within 1e-6 of its threshold, rows <= 1e-5), cold
             and warm wall, a device-only trace of its first blocks; and
             its marginal with bf16 states, within 5e-3 of the f32 one;
7. wide    — hwe-40 (depth 2, seed 0, P2 Q21, stored cut plan; two
             22-qubit fragments): the 20-clbit marginal through
             run_virtual_circuit(engine="pallas", keep_clbits=...) and
             <Z...Z> through streamed_expectation_z; the marginal sums to
             1, the two agree, the marginal knitted from the plain version
             agrees, and the blocked kernel was launched segments x chunks
             times per fragment, plus its prefix segments once, in the
             first call (the device plans are cached on the circuit: a
             second scan build launches and builds nothing; both builds
             timed).  ghz-40 (P2 Q20, stored cut plan): the
             marginal is 1/2 on all-zeros and all-ones, <Z> on an even
             support is 1.  hwe-40 with dense rotations (its u angles
             redrawn from default_rng(1), the same stored cut): the
             marginal on 4 written data clbits a fragment through
             engine="pallas" (the blocked kernel) against the batched
             engine in plain PyTorch (engine="xla", no segments),
             <= 1e-5 and fidelity > 1 - 1e-5.  Both hwe-40s through
             the sampled engine's route without a kernel (22 qubits, past
             the variant kernel's gate): the 36 labels with exact masses
             through _estimate (the same 8-clbit marginal) and
             _estimate_z equal engine="pallas" within 1e-6, no kernel
             launched.  ghz-34 (P2 Q17, solved
             in the run: two 18-qubit fragments, the variant kernel's
             global-memory path) the same way, its first chunk against
             the plain version;
             hwe-16 (below) through run_virtual_circuit(engine="pallas")
             (13 qubits, one CTA), fidelity > 1 - 1e-5, its first chunk
             against the plain version;
8. sv      — the whole-fragment kernel (every variant of a fragment from
             one launch) against its plain version at the path's own
             size: all 248832 lanes of both fragments of hwe-16 (depth 5,
             seed 0, P2 Q10, 5 cx cuts, solved in the run) and of sup-20;
             a hand-built cut circuit with a 13-data-qubit fragment under
             a gate cut and a wire cut (the width gate: 64 KB of shared
             memory a lane), whose 14-qubit twin returns None; <= 1e-5.
             Then its main path: run_fragment_kernel per fragment ->
             knit.knit -> nearest_probability_distribution on hwe-16 and
             on sup-20 (a 2^20-outcome knit), fidelity > 1 - 1e-5, one
             launch per fragment; and beside it the batched engine on
             hwe-16: run_virtual_circuit(engine="xla") and "auto" at the
             same fidelity, the kernel's rows within 2e-5 of
             run_fragment's (on sup-20's dense rows too),
             expectation_z equal to the knitted distribution's within
             1e-5;
9. streamed — the scan without a kernel (plain PyTorch, no kernel
             launched).  sup-20: ancestor banks on and off, a
             stage-aligned chunk and an unaligned one, within 1e-5;
             trunc_eps=1e-3 within its certified L1 bound; a checkpointed
             run stopped after its first segment (segments driven by
             hand) resumed within 1e-6 of the whole run; 20000 shots on a
             6-clbit marginal, drawn on the card (only the indices
             fetched), fidelity > 0.995.  sup-25 (genCirc("sup", 25, 1,
             seed=0), stored plan plans/sup25_p2_q13.json: 10368 labels,
             fragments of 18 and 17 qubits, chunk 256, banks on):
             run_virtual_circuit(engine="streamed") cold (fidelity
             against the 2^25 oracle > 1 - 1e-5) and warm, engine="pallas"
             on the same circuit within 1e-5, engine="auto" with
             dtype=torch.bfloat16 (routed to the streamed scan) against
             f32 by total variation, streamed_expectation_z on two z-sets
             against the distribution's Z within 1e-5; splits, stages,
             times, a device-only trace (busy, idle share) and the peak
             memory;
10. noise  — the streamed scan's noisy rows on kernel 1, the rest plain
             PyTorch.  One chunk of sup-20's fragment 0 (32 labels x 8
             trajectories, 15 qubits: a two-CTA cluster) through
             variant_kernel.make_noisy_chunk_kernel against the
             per-gate plan without a kernel (within 1e-5; kernel and
             plain ms, variant_rows.noisy).
             sup-20 under
             fake_kolkata_v2 with 8 trajectories (chunk 32: 243 chunks)
             through run_noisy_virtual_circuit(engine="streamed",
             shots=1000, seed=7) cold and warm (one kernel 1 launch a
             chunk and fragment): mass 1, support <= 1000,
             peak memory, a device-only trace of the scan's first 16
             chunks; without shots: non-negative
             with the unprojected knit's mass, and the first chunk's rows
             of each fragment (the scan's meta["fragment_rows"]) equal to
             the CPU's from the same draws within 1e-5 (absolute and of
             the largest entry); gate noise zeroed, readout kept, one
             trajectory: streamed = batched within 2e-5; no noise at all
             (routed): fidelity > 1 - 1e-5 against engine="pallas".
             The same sup-20 and model through the sampled engine:
             run_noisy_virtual_circuit(engine="sampled", seed=7), the
             default budget of 2,000,000 label draws (all 7776 labels),
             cold and warm: non-negative with the unprojected estimate's
             mass; the first block's rows of each fragment against the
             CPU's from the same numpy draws within 1e-5; with the gate
             noise zeroed, the full grid with exact masses equal to the
             knit of run_fragment_noisy within 3e-5; the total variation
             of a 6-clbit marginal against the streamed result recorded.
             ghz-24 (P2 Q12): compare_original_with_cut with the
             untranspiled fake_kolkata_v2 at 1000 shots (a 2^24 uncut noisy
             simulation): input fidelity in [0.65, 0.80], cut fidelity
             > 0.97.  GHZ-8 (two 5-qubit fragments): ZNE of <Z^8> over the
             noisy streamed observable with T1/T2 nearer 1 than the raw
             value, mitigate_readout inverting apply_readout_error within
             1e-5;
11. sharded — the sharded engine (plain PyTorch over a process-group
             mesh; no kernel in either package).  sup-20 through
             run_virtual_circuit(engine="sharded") on a mesh of one,
             without a process group and inside an NCCL group of one
             (file:// store; its collectives counted), both within 1e-6
             of engine="pallas" and fidelity > 1 - 1e-5, bf16 within a
             total variation of BF16_TV of f32, no kernel launched; a 26-data-qubit fragment (27
             simulated, the hand-built cut of the JAX sharded tests) that
             engine="pallas" refuses, through run_fragment_sharded on
             the (1, 1) mesh that fragment_mesh(max_local_qubits=24)
             gives one card, within 1e-5 of the batched engine's
             run_fragment; qft-16's sampled estimate with mesh= (kernel
             3 the route) equal to mesh=None within 1e-6; sup-20's scan
             through parallel.sharded.streamed_values_dp (banks on, off,
             the kernel route) within 2e-6 of the whole scan.  Each
             prints the card, warm time, idle share, peak memory and
             error.  Exchanges between cards cannot run on one card;
12. variational — the variational path (ops/sweep.py, ops/hamiltonian.py,
             ops/optim.py, models/qaoa.py: plain PyTorch and autograd,
             no kernel in either package) at the full width of the
             repo's VQE configs (benchmarks/vqe_tpu.py, rebuilt with the
             port): tfim20 (20 qubits, 2 layers, cap 11, 5 cuts, solved
             in the run) from linspace(0.2, 1.7, 60): e_theta0 within
             5e-4 of the oracle (X flips and Z signs over the port's
             statevector on the card), the gradient equal to the CPU's
             within 2e-5, 1 + 10 steps of lr 0.1 descend, no kernel
             launched; qaoa16 (MaxCut on the 16-ring given as a plain
             object, P=1, cap 9, 8 cuts) at (2.0, 1.5) within 2e-3 of
             its oracle, 1 + 3 steps descend; tfim16's contraction and
             knitted distribution within 2e-5 (energy and gradient);
             tfim20's stochastic energy (20000 LHS samples) within 0.5
             of the exact one with a gradient of norm > 1e-3; one
             make_parameter_sweep runner on tfim20's ansatz in the Z
             basis serving three bindings, each within 3e-6 of
             run_virtual_circuit(engine="pallas") (kernel 1's knit) and
             fidelity > 1 - 1e-5 to the oracle; spsa_minimize and
             nes_minimize (10 steps, 8 probes a step) on tfim16 below
             the start, the batched population within 1e-5 of a loop,
             and a mesh of one (energy, gradient, population) within
             1e-6 of no mesh.  Each prints its times (build, first step,
             median steady step, idle share over two traced steps, peak
             memory) with the card;
13. front end — the cutter's host modules, feeding the kernels above
             (no kernel of their own).  Right after the build: the
             native cut solver built with g++ from native/cutsolver.cc
             into build/ (timed), and ghz-40 P2 Q20, hwe-40 P2 Q21 and
             sup-25 P2 Q13 re-solved from scratch by the port's Cutter,
             each equal to its stored plan (every later cut of this
             script is the native solver's too).  sup-20 through
             to_qasm and from_qasm: the same instructions, the same plan,
             engine="pallas" bit for bit.  BASELINE config #5: the seven
             rows of benchmarks/topology_teleport_sweep.py (seed 7, the
             reg rows drawn by models/graphs.py) with S, A, L, cut counts
             and Q_p equal to topology_teleport_sweep.json, run by
             engine="pallas" (teleport="execute" where a row teleports)
             at fidelity >= 1 - 1e-6 and within 1e-6 of the record.
             BASELINE config #1 (BV-5, P2 Q3, one wire cut) and bv-12 (P2
             Q7, 46656 labels), exact.  ghz-20 (P2 Q11, teleports only):
             teleport="execute" merges one 22-qubit fragment with no
             vgate (kernel 4).  ghz-24 (P3 Q9, maxNQpdCuts=1,
             maxNCuts=2): one teleport and one QPD cut, 26 qubits and
             12 instantiations once expanded, exact (>= 1 - 1e-6) and
             sampled (20000 lhs draws, control variate: >= 1 - 5e-3).
             Each prints its launches (counted around its run), times,
             idle share and peak memory with the card;
14. last modules — the host modules that feed kernels 1-2 (no kernel of
             their own).  BASELINE config #4 (sycamore-32, seed 0):
             depth 1 (P2 Q20, no cut, fragments of 18 and 14 qubits) on
             the 8-clbit marginal {0..7} and depth 3 (stored plan
             plans/syc32_d3_p2_q17.json: 4 gate cuts, 1296 labels, two
             20-qubit fragments, kernel 1's global-memory path) on
             {0, 1, 2, 3}, through run_virtual_circuit(engine="pallas",
             keep_clbits=...), each within 1e-5 of lightcone_marginal on
             the card.  compile_circuit(standard_pipeline(10), sup-20,
             5) and (standard_pipeline(12), ghz-24, 5) under
             random.seed(0): the JAX package's fragment widths and
             vgates, the PassLedger's stages, engine="pallas" at
             fidelity > 1 - 1e-5.  ghz-24 (P2 Q12): 20000 shots a row
             from sampled_sparse_fragment_rows (kernel 2's full rows,
             each fragment's first and last chunk held to the plain
             version within 1e-5), sparse_knit, fidelity > 0.99 to the
             analytic GHZ distribution.  sup-20 under a Tracer on engine="pallas"
             and "xla": the JAX package's phase names, the traced result
             bit for bit the untraced one, the walls side by side, a
             torch.profiler trace written under profiles/.  The
             roofline (ops/roofline.py at the H100's 3.35 TB/s) of
             sup-20, sup-25 and hwe-40 beside their measured warm times,
             and kernel 1's sup-20 chunk beside work_counts.  The lane
             engine on sup-20 frag0's first 504 labels within 1e-5 of
             make_sim_fn's rows, both timed.  transpile_to_basis /
             count_cnots of sup-20 and a circuit a fragment, the
             transpiled sup-20 cut and run against the untranspiled
             oracle (> 1 - 1e-5), circuit_n_tangle(ghz-24) = 1 within
             1e-5, and the PipelineConfig JSON -> make_cutter -> run ->
             run directory flow into benchmark_results/;
15. where the time goes — host build of the scan, the run without the
             simplex projection, and a torch.profiler trace (device time
             by kernel, device idle share of the wall) for sup-20, ghz-24,
             hwe-40, qft-16 (there also the host's label sampling) and
             the two hwe-16 routes (lane table, upload, kernel, knit);
16. report — one JSON line of kernels (launches, error, times, bound), the
             card's name and power limit, and the contract's last line.

Run from the repository root: ``python3 chip_smoke.py``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PKG = "hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch"
TOL = 1e-5           # kernel vs plain: f32, different summation order
REL_TOL = 1e-4       # the same, over the largest entry (dense 2^22 rows)
FID_MIN = 1 - 1e-5   # cut-vs-uncut oracle on the exact path
CHUNK = 504
DEV = "cuda"
PEAK_F32 = 67e12      # H100 SXM f32 outside the tensor cores, FLOP/s
TPU_KERNEL = ("hardwareawareoptimalquantumcircuitcuttingandknitting_tpu/"
              "ops/pallas_variant.py:577")
TPU_BLOCKED = ("hardwareawareoptimalquantumcircuitcuttingandknitting_tpu/"
               "ops/pallas_blocked.py:168")
TPU_COLLAPSE = ("hardwareawareoptimalquantumcircuitcuttingandknitting_tpu/"
                "ops/pallas_variant.py:1165")
TPU_SV = ("hardwareawareoptimalquantumcircuitcuttingandknitting_tpu/"
          "ops/pallas_sv.py:347")
ROWS_TOL = 2e-5      # whole-fragment kernel vs the batched engine's rows
# the whole-fragment kernel's rows are probabilities, as small as 3e-5 an
# entry on a dense fragment: its two limits are also held relative to the
# largest entry of the reference rows, fragment by fragment
WIDE_LANES = 4096    # lanes of the 13-qubit case, drawn from its own table
HWE_CHUNK = 512      # capped by auto_chunk to 16 labels at 22 qubits
QFT_SAMPLES = 120000
QFT_SEED = 17
QFT_KEEP = [0, 1, 2, 3]
QFT_Z_SETS = [{0}, {8}, {15}, {0, 1, 2, 3}, set(range(16))]
WIRE_SAMPLES = 4096      # sampling budget behind the wire cut's label rows
SUP25_CHUNK = 512        # capped by auto_chunk to 256 labels at 18 qubits
SHOTS = 20000
# bf16 states against f32, total variation.  JAX's bf16 test bound,
# 5e-3, is not met at these widths by either package: on sup-12/16/20
# (tests/test_torch_streamed.py's bf16_witness, CPU) the port gives
# 5.6e-3 / 1.81e-2 / 7.1e-3 and the JAX package's own bf16 9.4e-3 /
# 1.81e-2 / 8.7e-3.  sup-25 measured 7.6e-3 on the card; 1e-2 holds
# that value as a bound against regressions (PERF.md §6)
BF16_TV = 1e-2
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


def _cut(name, n, cap, seed, depth=1, stored_plan=None, angles=None):
    """(circuit, VirtualCircuit) of genCirc(name, n, depth, seed) cut into
    2 partitions of at most ``cap`` qubits: by the solver, or by a plan
    stored in the package (solved once, loaded here).  ``angles``: a seed
    the ``u`` rotations' angles are redrawn from, uniform in [-pi, pi)
    with numpy's default_rng (the hardware-efficient ansatz's "random"
    parameters: genCirc's "optimal" ones leave most rotations the
    identity); the gates and their qubits stay, so a stored plan still
    fits."""
    import numpy as np

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
    if angles is not None:
        # the ansatz's u gates come in columns of n: u(theta, 0, 0), then
        # u(0, 0, lambda), and so on
        rng = np.random.default_rng(angles)
        us = [ins for ins in circ.instructions if ins.name == "u"]
        for k, ins in enumerate(us):
            ins.params = [0.0, 0.0, 0.0]
            ins.params[2 * ((k // n) % 2)] = float(rng.uniform(-np.pi, np.pi))
    cutter = Cutter(circ, maxNPartitions=2, maxNQubitsPerPartition=cap,
                    maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    if stored_plan is not None:
        cutter.use_plan(_port("plans").load_plan(stored_plan))
    elif not cutter.solve():
        raise RuntimeError(f"no cut plan for {name}-{n}")
    return circ, VirtualCircuit(cutter.getResultCircs()[3])


def _variant_chunk(label, virt, blk, folded, staged, on_main_path=False):
    """One chunk of labels ``blk`` (on the card) through every fragment's
    row call of the variant kernel (``label_rows``: sorted by slot digits,
    run table, kernel, rows put back), held to the plain version on the
    order given, a second call equal bit for bit, and each plan's shared
    prefix (built on the card by the blocked kernel) held to its plain
    version on the CPU; times of the call, of the kernel alone (traced)
    and of the plain version; the roofline work of the function's own
    stages on the sorted chunk, and what the kernel's runs replay.
    Returns the kernels-line row."""
    import numpy as np
    import torch

    vk = _port("ops.variant_kernel")
    calls, err, prefix_err, frags = [], 0.0, 0.0, {}
    keys = ("bytes", "flops", "passes", "passes_before", "pass_bytes",
            "tile_passes", "tile_bytes")
    work, kwork = dict.fromkeys(keys, 0), dict.fromkeys(keys, 0)
    for name in (r.name for r in virt.fragments):
        if folded:
            fn, _ = vk.make_folded_chunk_kernel(virt, name, blk.shape[0],
                                                staged=staged, device=DEV)
        else:
            fn, _ = vk.make_chunk_kernel(virt, name, blk.shape[0],
                                         staged=staged, device=DEV)
        dp = fn.plan
        prefix_err = max(prefix_err, _prefix_err(dp))
        got = vk.label_rows(dp, blk, fn.weigh)
        torch.cuda.synchronize()
        launch = dict(vk.variant_rows.last_launch)
        again = vk.label_rows(dp, blk, fn.weigh)
        want = vk.plain_variant_rows(dp, dp.gather_entries(blk),
                                     fn.weigh(blk))
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{label}/{name}: non-finite kernel rows")
        if not torch.equal(got, again):
            raise RuntimeError(f"{label}/{name}: a launch does not repeat")
        err = max(err, (got - want).abs().max().item())
        order = dp.order(blk)
        sb = blk if order is None else blk[order]
        st = dp.stages(sb).cpu().numpy()
        ent = dp.gather_entries(sb).cpu().numpy()
        n_w = fn.weigh(sb).shape[1]
        n_seg = len(dp.plan.row_segments)
        wk = vk.work_counts(dp.plan, st, n_w, ent)
        kw = vk.work_counts(dp.plan, vk.effective_stages(
            st, n_seg, launch["cap"]), n_w, ent)
        for key in keys:
            work[key] += wk[key]
            kwork[key] += kw[key]
        frags[name] = {"n": dp.plan.n, "ops": len(dp.plan.ops),
                       "prefix_ops": len(dp.plan.prefix_ops),
                       "prefix_launches": dp.prefix_launches,
                       "rewritten_rows": len(dp.plan.table.rows),
                       "segments": n_seg, "runs": int(launch["runs"]),
                       "cap": launch["cap"], "grid": launch["grid"],
                       "threads": launch["threads"],
                       "cluster": launch["cluster"],
                       "tiled": launch["tiled"],
                       "window": launch["window"],
                       "tile_passes": launch["tile_passes"],
                       "scratch_bytes": launch["scratch_bytes"],
                       "stages": [int(x) for x in
                                  np.bincount(st, minlength=n_seg + 1)]}
        calls.append((dp, blk, fn.weigh))
        del got, again, want
    ms = _time_ms(lambda: [vk.label_rows(*a) for a in calls], reps=10)
    prof = _profile(lambda: [vk.label_rows(*a) for a in calls])
    kernel_ms = sum(r["ms"] for r in prof["device_ms_by_kernel"]
                    if "variant_rows_kernel" in r["kernel"])
    plain_ms = _time_ms(lambda: [
        vk.plain_variant_rows(dp, dp.gather_entries(b), w(b))
        for dp, b, w in calls], reps=2, warm=1)
    bound_ms, bound_by = _bound(work)
    row = {
        "name": f"variant_rows/{label}",
        "route": "cuda",
        "source": f"{PKG}/csrc/variant_kernel.cu",
        "replaces": TPU_KERNEL,
        "launches": None,  # filled from the main path's run
        "max_abs_err": err,
        "prefix_max_abs_err": prefix_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "on_main_path": on_main_path,
        "kernel_ms": kernel_ms,
        "labels": int(blk.shape[0]),
        "fragments": frags,
        "work": work,
        "kernel_work": kwork,
    }
    print(f"kernel {label}: fragments={frags} max_abs_err={err:.3e} "
          f"prefix_max_abs_err={prefix_err:.3e} | one "
          f"{blk.shape[0]}-label chunk through {len(calls)} fragments: "
          f"ms={ms:.4f} (the kernel alone, traced: {kernel_ms:.4f}; the "
          f"call's device busy {prof['device_busy_ms']}) plain_ms="
          f"{plain_ms:.4f} bound_ms={bound_ms:.6f} ({bound_by}; "
          f"{work['flops'] / 1e9:.4f} GFLOP of the function's own stages, "
          f"sorted); the kernel's runs replay "
          f"{kwork['flops'] / 1e9:.4f} GFLOP, {kwork['passes']} passes "
          f"(the function's stages: {work['passes']}; on the original "
          f"table: {kwork['passes_before']}); tile passes "
          f"{kwork['tile_passes']}, {kwork['tile_bytes'] / 1e9:.4f} GB of "
          f"state traffic (a pass a row: {kwork['pass_bytes'] / 1e9:.4f})",
          flush=True)
    if not err <= TOL:
        raise RuntimeError(f"{label}: kernel vs plain {err:.3e} > {TOL}")
    if not prefix_err <= TOL:
        raise RuntimeError(f"{label}: prefix vs plain {prefix_err:.3e} > "
                           f"{TOL}")
    return row


def phase_kernel(virt, report):
    """Every kernel mode against the plain version on sup-20's fragments,
    one chunk of 504 labels through both fragments per measurement: the
    fold (kernel 1) staged, unstaged and on a shuffled label order, full
    rows (kernel 2) staged and shuffled."""
    import numpy as np
    import torch

    ve = _port("ops.variant_engine")
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, total = ve.label_strides(specs, range(len(specs)))
    vidx = ve.variant_index_table(range(len(specs)), strides, n_inst, total)
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
        ("full_rows_shuffled", "shuffled", False, True),
    ]
    rows = [_variant_chunk(mode, virt, blocks[order], folded, staged,
                           on_main_path=mode == "folded_staged")
            for mode, order, folded, staged in modes]
    report.setdefault("kernels", []).extend(rows)
    report["launches_during_comparison"] = \
        _port("ops.variant_kernel").variant_rows.launches


def _bound(work):
    """(bound_ms, bound_by) of a work count on one H100."""
    peak_bytes = _port("ops.roofline").H100_HBM_BYTES_PER_S
    t_bytes = work["bytes"] / peak_bytes * 1e3
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


def _segment_chain(segment_fn, rows_fn, dp, ent):
    """Every segment launch of ``dp`` on one block's entries, as
    blocked_rows makes them: the first from the shared prefix, the rest
    in place, the last writing the |psi|^2 rows."""
    state = dp.prefix
    last = len(dp.plan.segments) - 1
    for k in range(last):
        state = segment_fn(dp, k, state, ent)
    return rows_fn(dp, last, state, ent)


def phase_blocked(label, virt, window, blocks, report, witness):
    """The blocked kernel against its plain version on every fragment of
    ``virt`` (forced through it at ``window``): the prefix the card built,
    and every label block's rows, a second call equal bit for bit; times
    for the first block through all fragments: the segment launches alone
    (the kernel), and the whole ``blocked_rows`` (segments and
    |psi|^2)."""
    import torch

    bk = _port("ops.blocked_kernel")
    vk = _port("ops.variant_kernel")
    labels = blocks[0].shape[0]
    err = werr = prefix_err = rel = 0.0
    repeat_equal = True
    chunk_calls = []
    work = {"bytes": 0, "flops": 0}
    segments, prefix_segments, rows, folded = {}, {}, {}, {}
    for name in (r.name for r in virt.fragments):
        fn, _ = bk.make_blocked_chunk_kernel(virt, name, labels,
                                             window=window, force=True,
                                             device=DEV)
        dp = fn.plan
        plan = dp.plan
        segments[name] = len(plan.segments)
        prefix_segments[name] = plan.n_prefix
        rows[name] = [r1 - r0 for r0, r1, _, _ in plan.row_segments]
        folded[name] = sum(a + b for a, b in plan.folded)
        prefix_err = max(prefix_err, (dp.prefix - bk.plain_prefix_state(dp))
                         .abs().max().item())
        for blk in blocks:
            ent = dp.gather_entries(blk)
            got = bk.blocked_rows(dp, ent)
            again = bk.blocked_rows(dp, ent)
            want = bk.plain_blocked_rows(dp, ent)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{label}/{name}: non-finite kernel rows")
            repeat_equal &= bool(torch.equal(got, again))
            diff = (got - want).abs().max().item()
            err = max(err, diff)
            rel = max(rel, diff / want.abs().max().item())
            del got, again, want
        if witness:
            v_fn, _ = vk.make_chunk_kernel(virt, name, labels, device=DEV)
            werr = max(werr, (fn(blocks[0]) - v_fn(blocks[0])).abs().max()
                       .item())
        ent = dp.gather_entries(blocks[0])
        for k in range(len(plan.segments)):
            wk = bk.work_counts(plan, k, labels, ent.cpu().numpy())
            work["bytes"] += wk["bytes"]
            work["flops"] += wk["flops"]
        chunk_calls.append((dp, ent))
    # the first block's segment launches (all of blocked_rows's launches)
    ms = _time_ms(lambda: [_segment_chain(bk.apply_segment, bk.segment_rows,
                                          *a) for a in chunk_calls], reps=5)
    plain_ms = _time_ms(lambda: [_segment_chain(bk.plain_segment,
                                                bk.plain_segment_rows, *a)
                                 for a in chunk_calls], reps=1, warm=1)
    chunk_ms = _time_ms(lambda: [bk.blocked_rows(*a) for a in chunk_calls],
                        reps=3, warm=1)
    plain_chunk_ms = _time_ms(
        lambda: [bk.plain_blocked_rows(*a) for a in chunk_calls], reps=1,
        warm=0,
    )
    bound_ms, bound_by = _bound(work)
    gbps = work["bytes"] / ms / 1e6
    report.setdefault("kernels", []).append({
        "name": f"blocked_rows/{label}",
        "route": "cuda",
        "source": f"{PKG}/csrc/blocked_kernel.cu",
        "replaces": TPU_BLOCKED,
        "launches": None,  # filled from the main path's run
        "max_abs_err": max(err, prefix_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "on_main_path": False,  # set by the path that launches it
        "work": work,
        "gbps": gbps,
        "chunk_ms": chunk_ms,
        "plain_chunk_ms": plain_chunk_ms,
        "window": plan.w,
        "pinned": plan.pinned,
        "labels": labels,
        "segments": segments,
        "prefix_segments": prefix_segments,
        "rows_a_segment": rows,
        "rows_folded": folded,
        "prefix_max_abs_err": prefix_err,
        "max_rel_err": rel,
        "second_call_equal": repeat_equal,
        "variant_kernel_witness_err": werr if witness else None,
    })
    print(f"blocked {label}: window={plan.w} pinned={plan.pinned} "
          f"segments={segments} "
          f"prefix_segments={prefix_segments} rows={rows} "
          f"folded={folded} blocks={[b.shape[0] for b in blocks]} "
          f"max_abs_err={err:.3e} max_rel_err={rel:.3e} "
          f"prefix_err={prefix_err:.3e} second_call_equal={repeat_equal} "
          f"witness_err={werr if witness else None} | one {labels}-label "
          f"chunk through {len(segments)} fragments: segment launches "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} "
          f"({bound_by}; {work['bytes'] / 1e9:.3f} GB, "
          f"{work['flops'] / 1e9:.3f} GFLOP) = {gbps:.1f} GB/s; "
          f"blocked_rows chunk_ms={chunk_ms:.4f} plain_chunk_ms="
          f"{plain_chunk_ms:.4f}", flush=True)
    if not err <= TOL or not prefix_err <= TOL:
        raise RuntimeError(f"{label}: blocked kernel vs plain {err:.3e}, "
                           f"prefix {prefix_err:.3e} > {TOL}")
    if not rel <= REL_TOL:
        raise RuntimeError(f"{label}: blocked kernel vs plain {rel:.3e} of "
                           f"the largest entry > {REL_TOL}")
    if not repeat_equal:
        raise RuntimeError(f"{label}: a second call differs")
    if witness and not werr <= TOL:
        raise RuntimeError(f"{label}: blocked vs variant kernel rows "
                           f"{werr:.3e} > {TOL}")


def _kernel_row(report, name):
    return next(r for r in report["kernels"] if r["name"] == name)


# the prefix_launches of the kernel 1, 3 and 5 plans built since
# _reset_counts
_PREFIX = {"launches": 0}


def _count_prefixes():
    """From here on every device plan of kernels 1, 3 and 5 built adds
    its own ``prefix_launches`` (the blocked kernel's launches that built
    its shared prefix) to the ``prefix`` count of :func:`_counts`."""
    for module, name in (("variant_kernel", "DevicePlan"),
                         ("collapse_kernel", "CollapseDevicePlan"),
                         ("sv_kernel", "SvDevicePlan")):
        _count_plan_prefixes(getattr(_port(f"ops.{module}"), name))


def _count_plan_prefixes(plan):
    init = plan.__init__

    def counted(self, *args, **kw):
        init(self, *args, **kw)
        _PREFIX["launches"] += self.prefix_launches

    plan.__init__ = counted


def _reset_counts():
    _port("ops.blocked_kernel").blocked_rows.launches = 0
    _port("ops.variant_kernel").variant_rows.launches = 0
    _port("ops.variant_kernel").variant_rows.noisy = 0
    _port("ops.collapse_kernel").collapse_rows.launches = 0
    _port("ops.collapse_kernel").collapse_rows.rows = 0
    _port("ops.sv_kernel").sv_rows.launches = 0
    _PREFIX["launches"] = 0


def _counts():
    """Each kernel's launches, counted where they launch, ``noisy``: the
    (label, trajectory) rows kernel 1 computed for the streamed scan's
    noisy rows, and ``prefix``: what the kernel 1, 3 and 5 plans built
    meanwhile say their prefixes took."""
    return {"blocked": _port("ops.blocked_kernel").blocked_rows.launches,
            "variant": _port("ops.variant_kernel").variant_rows.launches,
            "noisy": _port("ops.variant_kernel").variant_rows.noisy,
            "collapse": _port("ops.collapse_kernel").collapse_rows.launches,
            "sv": _port("ops.sv_kernel").sv_rows.launches,
            "prefix": _PREFIX["launches"]}


def _only(prefix=0, **launched):
    """The launch counts of a path that ran these kernels and no other,
    besides ``prefix`` blocked launches: the shared prefixes of the
    kernel 1, 3 and 5 plans it built, each a plan's
    ``prefix_launches``."""
    out = {"blocked": 0, "variant": 0, "noisy": 0, "collapse": 0, "sv": 0,
           **launched, "prefix": prefix}
    out["blocked"] += prefix
    return out


def _prefix_err(dp):
    """How far a kernel 1, 3 or 5 plan's shared prefix, built on the card
    by the blocked kernel, lies from the same chain's plain version on
    the CPU."""
    want, _ = _port("ops.blocked_kernel").build_prefix(
        dp.plan.prefix_ops, dp.plan.n, "cpu")
    return (dp.prefix.cpu() - want).abs().max().item()


def phase_forced_sup20(circ, virt, report, window=13):
    """The oracle at a width that has one: sup-20 end to end with every
    fragment forced through the blocked kernel."""
    import torch

    streamed = _port("ops.streamed")
    sv = _port("ops.statevector")
    step, xs, meta = streamed.make_streamed_knit(
        virt, CHUNK, device=DEV, blocked_window=window, pallas_variant=True
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
    if counts != _only(blocked=expect):
        raise RuntimeError(f"forced blocked route launched {counts}, "
                           f"expected {expect} blocked launches only")
    if not fid > FID_MIN:
        raise RuntimeError(f"forced blocked fidelity {fid!r} <= {FID_MIN}")
    row["launches"] = counts["blocked"]
    row["on_main_path"] = True


def phase_dense_wide(label, virt, report, kernel_row, keep_each=4):
    """hwe-40 with dense rotations (its 22-qubit fragments' states spread
    over every amplitude) end to end: the marginal on ``keep_each``
    written data clbits of each fragment through
    run_virtual_circuit(engine="pallas") (the blocked kernel, launches
    counted around it) against the batched engine in plain PyTorch
    (engine="xla": every variant's state gate by gate, no segments,
    tiles or folded moves), <= 1e-5 and Hellinger fidelity > 1 - 1e-5;
    the marginal sums to 1 and is spread (no bin above 1/2)."""
    import numpy as np
    import torch

    run_virtual_circuit = _port("run").run_virtual_circuit
    keep = sorted(c for cs in _written_data_clbits(virt)
                  for c in cs[:keep_each])
    _reset_counts()
    t0 = time.perf_counter()
    dist, _ = run_virtual_circuit(virt, engine="pallas",
                                  chunk_size=HWE_CHUNK, keep_clbits=keep,
                                  project=False, device=DEV)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    counts = _counts()
    _reset_counts()
    t0 = time.perf_counter()
    ref, _ = run_virtual_circuit(virt, engine="xla", keep_clbits=keep,
                                 project=False, device=DEV)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_counts = _counts()
    got = np.asarray(dist.values, np.float64)
    want = np.asarray(ref.values, np.float64)
    err = float(np.abs(got - want).max())
    fid = _port("evaluate").hellinger_fidelity(dist, ref)
    out = {"keep_clbits": keep, "launches": counts,
           "xla_launches": ref_counts, "pallas_s": kernel_s,
           "xla_s": ref_s, "max_abs_err_vs_xla": err,
           "fidelity_vs_xla": fid, "marginal_sum": float(got.sum()),
           "largest_bin": float(got.max())}
    report[label] = out
    print(f"main {label}: keep={len(keep)} clbits launches={counts} "
          f"xla_launches={ref_counts} pallas_s={kernel_s:.4f} "
          f"xla_s={ref_s:.4f} max_abs_err_vs_xla={err:.3e} "
          f"fidelity_vs_xla={fid!r} marginal_sum={float(got.sum())!r} "
          f"largest_bin={got.max():.4f}", flush=True)
    if not (np.isfinite(got).all() and got.shape == (1 << len(keep),)):
        raise RuntimeError(f"{label}: marginal not finite or misshaped")
    if not (counts["blocked"] > 0 and counts == _only(blocked=counts[
            "blocked"]) and ref_counts == _only()):
        raise RuntimeError(f"{label}: launches {counts}, xla {ref_counts}")
    if not abs(got.sum() - 1) <= TOL or not got.max() <= 0.5:
        raise RuntimeError(f"{label}: marginal sums to {got.sum()!r}, "
                           f"largest bin {got.max()!r}")
    if not err <= TOL or not fid > FID_MIN:
        raise RuntimeError(f"{label}: blocked vs batched engine {err:.3e}, "
                           f"fidelity {fid!r}")
    row = _kernel_row(report, kernel_row)
    row["launches"] = counts["blocked"]
    row["on_main_path"] = True


def _written_data_clbits(virt):
    """Per fragment, the data clbits its measures write, ascending."""
    return [sorted(c for c in virt.programs[r.name].clbit_sources
                   if c < virt.num_clbits) for r in virt.fragments]


@contextlib.contextmanager
def _plain_rows():
    """Within: the exact scan takes its rows from the plain PyTorch
    versions, the blocked kernel's segments and the variant kernel's rows,
    instead of the kernels (the wrappers themselves never do that on a
    CUDA tensor)."""
    bk = _port("ops.blocked_kernel")
    vk = _port("ops.variant_kernel")
    kept = bk.apply_segment, bk.segment_rows, vk.label_rows
    bk.apply_segment, bk.segment_rows = bk.plain_segment, bk.plain_segment_rows
    vk.label_rows = lambda dp, vidx, weigh: vk.plain_variant_rows(
        dp, dp.gather_entries(vidx), weigh(vidx))
    try:
        yield
    finally:
        bk.apply_segment, bk.segment_rows, vk.label_rows = kept


def _z_of_marginal(values):
    """<Z...Z> over every bit of a flat little-endian distribution."""
    import numpy as np

    idx = np.arange(len(values))
    par = np.zeros(len(values), np.int64)
    for j in range(len(values).bit_length() - 1):
        par ^= (idx >> j) & 1
    return float(np.sum(np.asarray(values, np.float64) * (1 - 2 * par)))


def phase_wide(label, virt, report, analytic, kernel_row=None,
               kernel="blocked"):
    """A main path at a width with no statevector oracle: the marginal on
    10 written data clbits of each fragment through run_virtual_circuit
    and <Z...Z> on them through streamed_expectation_z, launches counted
    around each.  ``kernel``: the one kernel every fragment must run on,
    the blocked kernel (21-24 qubits) or the variant kernel's global-
    memory path (16-20).  ``analytic``: the circuit is a GHZ state, whose
    marginal (its fidelity to the cut's) and even-support <Z> are known;
    otherwise the marginal is held to the scalar-carry <Z>.  Either way
    the same knit from the plain versions must agree.  ``kernel_row``: the
    report's kernel row whose launches this path supplies."""
    import numpy as np
    import torch

    streamed = _port("ops.streamed")
    bk = _port("ops.blocked_kernel")
    run_virtual_circuit = _port("run").run_virtual_circuit
    keep = sorted(c for cs in _written_data_clbits(virt) for c in cs[:10])
    widths = [virt.programs[r.name].num_sim_qubits for r in virt.fragments]
    chunk = streamed.auto_chunk(virt, HWE_CHUNK)

    # the first call builds the blocked plans (earlier phases may have
    # cached them on the circuit), the later ones find them
    bk.drop_device_plans(virt)
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
                                            chunk=HWE_CHUNK, device=DEV,
                                            pallas_variant=True)
    z_s = time.perf_counter() - t0
    z_counts = _counts()

    # the scan alone: its host build first with no plan cached (the
    # blocked prefix launches, once a build), then cached; which kernel
    # backs which fragment, warm times, and the same knit from the plain
    # version's segments
    builds, build_counts, metas = [], [], []
    bk.drop_device_plans(virt)
    for _ in range(2):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, xs, meta = streamed.make_streamed_knit(virt, chunk,
                                                     keep_clbits=keep,
                                                     device=DEV,
                                                     pallas_variant=True)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
        build_counts.append(_counts())
        metas.append(meta)
    segs = {n: len(dp.plan.segments)
            for n, dp in meta["fragment_plans"].items()}
    prefix_segs = {n: dp.plan.n_prefix
                   for n, dp in meta["fragment_plans"].items()
                   if meta["fragment_kernels"][n] == "blocked"}
    prefix = sum(prefix_segs.values())
    # a blocked launch per segment, a variant launch per fragment, a chunk
    expect = meta["n_chunks"] * (sum(segs.values()) if kernel == "blocked"
                                 else len(segs))
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = step(xs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _reset_counts()
    with _plain_rows():
        plain = step(xs)
    torch.cuda.synchronize()
    plain_counts = _counts()
    plain_err = (warm - plain).abs().max().item()
    rerun_err = float(np.abs(warm.cpu().numpy() - dist.values).max())
    prof = _profile(lambda: step(xs))

    out = {
        "labels": meta["global_labels"], "fragment_sim_qubits": widths,
        "chunk": chunk, "n_chunks": meta["n_chunks"], "keep_clbits": keep,
        "segments": segs, "prefix_segments": prefix_segs,
        "launches": counts, "expected_launches": expect + prefix,
        "z_launches": z_counts, "first_run_s": first_s,
        "expectation_z_s": z_s, "host_build_s": builds[0],
        "host_build_cached_s": builds[1], "build_launches": build_counts,
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
          f"prefix_segments={prefix_segs} launches={counts} "
          f"expected={expect}+{prefix} z_launches={z_counts} "
          f"first_run_s={first_s:.4f} expectation_z_s={z_s:.4f} "
          f"host_build_s={builds[0]:.4f} host_build_cached_s="
          f"{builds[1]:.4f} build_launches={build_counts} warm_scan_s="
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

    vk = _port("ops.variant_kernel")
    if kernel == "blocked":
        need(all(w > vk.MAX_QUBITS for w in widths),
             f"fragment widths {widths} are within the variant kernel's "
             "gate")
    else:
        need(all(_port("ops.kernel_build").CLUSTER_QUBITS < w <= vk.MAX_QUBITS
                 for w in widths),
             f"fragment widths {widths} are not the variant kernel's "
             "global-memory path")
    need(np.isfinite(values).all() and values.shape == (1 << len(keep),),
         "marginal not finite or of the wrong shape")
    # kernel 1's plans are built anew by each call, their prefixes too
    need(counts == _only(**{kernel: expect + prefix},
                         prefix=counts["prefix"]),
         f"launched {counts}, expected {expect} + {prefix} {kernel} "
         "launches and kernel 1's prefixes only")
    need(z_counts == _only(**{kernel: expect}, prefix=z_counts["prefix"]),
         f"expectation launched {z_counts}")
    need(build_counts == [_only(blocked=prefix,
                                prefix=build_counts[0]["prefix"]),
                          _only(prefix=build_counts[1]["prefix"])],
         f"builds launched {build_counts}, expected {prefix} prefix "
         "launches, then none but kernel 1's prefixes")
    need((counts["prefix"] > 0) == (kernel == "variant"),
         f"kernel 1's prefixes launched {counts['prefix']} times")
    need(all(metas[1]["fragment_plans"][n] is metas[0]["fragment_plans"][n]
             for n in prefix_segs), "the second build built a plan")
    need(plain_counts == _only(),
         f"the plain knit launched kernels: {plain_counts}")
    need(all(meta["pallas_fragments"].values())
         and set(meta["fragment_kernels"].values()) == {kernel},
         f"fragments not backed by the {kernel} kernel: "
         f"{meta['fragment_kernels']}")
    need(abs(total - 1) <= TOL, f"marginal sums to {total!r}")
    need(plain_err <= TOL and rerun_err <= TOL,
         f"plain knit differs by {plain_err:.3e}, rerun by {rerun_err:.3e}")
    if analytic:
        want = np.zeros_like(values)
        want[0] = want[-1] = 0.5
        ghz_err = float(np.abs(values - want).max())
        fid = float(np.sum(np.sqrt(np.clip(values, 0, None) * want)) ** 2)
        out["ghz_marginal_max_abs_err"] = ghz_err
        out["fidelity_vs_analytic_marginal"] = fid
        need(ghz_err <= TOL, f"GHZ marginal off by {ghz_err:.3e}")
        need(fid > FID_MIN, f"GHZ marginal fidelity {fid!r} <= {FID_MIN}")
        need(abs(z_val - 1) <= TOL, f"GHZ <ZZ> = {z_val!r}")
    else:
        z_marg = _z_of_marginal(values)
        out["z_of_marginal"] = z_marg
        need(abs(z_val - z_marg) <= TOL,
             f"<Z> {z_val!r} vs from the marginal {z_marg!r}")
    if kernel_row is not None:
        row = _kernel_row(report, kernel_row)
        row["launches"] = counts[kernel]
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
        work = {"bytes": 0, "flops": 0, "pass_bytes": 0, "passes": 0,
                "passes_before": 0}
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
            launch = dict(ck.collapse_rows.last_launch)
            launch["runs"] = int(launch["runs"])
            again, bits2 = ck.collapse_rows(dp, ent, cscal)
            if not (torch.equal(again, got) and torch.equal(bits2, bits)):
                raise RuntimeError(f"{label}/{mode}/{name}: a launch does "
                                   "not repeat")
            on = int((cscal[:, :, 1] > 0).sum())
            measuring += on
            wk = ck.work_counts(dp.plan, ent, cscal)
            for key in work:
                work[key] += wk[key]
            sites[name] = {"n": dp.plan.n, "sites": ns,
                           "ops": len(dp.plan.ops),
                           "rewritten_rows": len(dp.plan.table.rows),
                           "replica_runs": launch["runs"],
                           "run_cap": launch["cap"],
                           "uncapped_runs": wk["runs"],
                           "cluster": launch["cluster"],
                           "grid": launch["grid"],
                           "threads": launch["threads"],
                           "scratch_bytes": launch["scratch_bytes"],
                           "passes": wk["passes"],
                           "passes_before": wk["passes_before"]}
            if dp.plan.n <= 15 and launch["scratch_bytes"]:
                raise RuntimeError(f"{label}/{name}: global scratch at "
                                   f"n = {dp.plan.n}")
            calls.append((dp, ent, cscal))
            del got, want, margins, again
        ms = _time_ms(lambda: [ck.collapse_rows(*a) for a in calls], reps=5)
        # the kernel alone, without the wrapper's run table (torch ops)
        prof = _profile(lambda: [ck.collapse_rows(*a) for a in calls])
        kernel_ms = sum(r["ms"] for r in prof["device_ms_by_kernel"]
                        if "collapse_rows_kernel" in r["kernel"])
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
            "kernel_device_ms": kernel_ms,
            "wrapper_device_busy_ms": prof["device_busy_ms"],
        })
        print(f"collapse {label}/{mode}: fragments={sites} labels={c} "
              f"measuring_sites={measuring} max_abs_err={err:.3e} "
              f"picks flipped near a threshold={near} far={far} | one "
              f"block through {len(names)} fragments: ms={ms:.4f} (the "
              f"kernel alone, traced: {kernel_ms:.4f}; run tables and "
              f"kernel: device busy {prof['device_busy_ms']}) "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} "
              f"({bound_by}; {work['bytes'] / 1e6:.3f} MB, "
              f"{work['flops'] / 1e9:.3f} GFLOP, recounted: each gate what "
              f"its matrix needs, a replica run's shared prefix once); "
              f"passes over the state {work['passes']} (every label from "
              f"the prefix, every gate a pass: "
              f"{work['passes_before']}) = {work['pass_bytes'] / 1e9:.3f} GB "
              f"= {work['pass_bytes'] / ms / 1e6:.1f} GB/s", flush=True)
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
    rows_err = prefix_err = 0.0
    for fn in next(iter(virt._scan_step_cache.values()))["row_fns"]:
        dp, ones = fn.rows_fn.plan, fn.rows_fn.weigh
        prefix_err = max(prefix_err, _prefix_err(dp))
        for rows in (vidx[:block], vidx[(total - 1) // block * block:]):
            blk = torch.as_tensor(rows, device=DEV, dtype=torch.int64)
            got = vk.label_rows(dp, blk, ones)
            want = vk.plain_variant_rows(dp, dp.gather_entries(blk),
                                         ones(blk))
            rows_err = max(rows_err, (got - want).abs().max().item())
    report["sampled_sup20"] = {
        "labels": total, "collapse_flags": flags, "block": block,
        "launches": counts, "expected_launches": expect, "wall_s": wall,
        "mass_sum": float(mass.sum()), "max_abs_err_vs_exact_knit": err,
        "full_rows_max_abs_err_at_path_blocks": rows_err,
        "prefix_max_abs_err": prefix_err,
    }
    print(f"main sampled sup20 (ancilla mode, full grid): labels={total} "
          f"block={block} launches={counts} expected={expect} "
          f"wall_s={wall:.4f} max_abs_err_vs_exact_knit={err:.3e} "
          f"full rows vs plain at blocks of {block} and "
          f"{total - (total - 1) // block * block}: {rows_err:.3e} "
          f"prefix_max_abs_err={prefix_err:.3e}", flush=True)
    if any(flags):
        raise RuntimeError(f"sup-20 went to collapse mode: {flags}")
    if counts != _only(variant=expect, prefix=counts["prefix"]):
        raise RuntimeError(f"sampled sup-20 launched {counts}, expected "
                           f"{expect} variant launches and kernel 1's "
                           "prefixes only")
    if est.bit_positions != exact.bit_positions or not err <= 1e-6:
        raise RuntimeError(f"full-grid identity off by {err:.3e}")
    if not rows_err <= TOL or not prefix_err <= TOL:
        raise RuntimeError(f"full rows vs plain {rows_err:.3e}, prefix "
                           f"{prefix_err:.3e} > {TOL}")
    row = _kernel_row(report, "variant_rows/full_rows_staged")
    row["launches"] = counts["variant"]
    row["on_main_path"] = True


def _qft16_oracle(circ):
    """(marginal on ``QFT_KEEP``, <Z_S> of ``QFT_Z_SETS``) of the uncut
    circuit at 2^16 (bit j of the index = clbit j)."""
    import numpy as np

    simulate_circuit = _port("ops.statevector").simulate_circuit
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
    return oracle_m, oracle_z


def phase_main_qft16(circ, virt, report):
    """This slice's path at full width: qft-16 through the sampled engine
    (both fragments in collapse mode), the marginal and the Z panel held
    to the 2^16 oracle by their own standard errors."""
    import numpy as np
    import torch

    tq = _port("ops.qpd_sampling")
    run_virtual_circuit = _port("run").run_virtual_circuit
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
    rows = _port("ops.collapse_kernel").collapse_rows.rows
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

    oracle_m, oracle_z = _qft16_oracle(circ)
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
    row_fns = tq._build_scan(virt, flags, QFT_KEEP, None, DEV)["row_fns"]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    # the replica runs the kernel finds in each block of this path, per
    # fragment (they depend on the labels and site scalars, not on u)
    ck = _port("ops.collapse_kernel")
    runs_per_block = []
    for b0 in range(0, len(lab_all), block):
        lab = torch.as_tensor(lab_all[b0:b0 + block], device=DEV,
                              dtype=torch.int64)
        per = []
        for fn in row_fns:
            dp = fn.rows_fn.plan
            u = torch.zeros((lab.shape[0], dp.plan.n_sites), device=DEV)
            per.append(int(ck.find_runs(dp.gather_entries(lab),
                                        fn.scalars(lab, u)).shape[0]))
        runs_per_block.append(per)

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
    # kernel 3's shared prefixes, built on the card by the blocked kernel
    prefix_err = max(_prefix_err(fn.rows_fn.plan) for fn in row_fns)

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
        "expected_launches": expect, "collapse_rows": rows,
        "z_launches": z_counts,
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
        "replica_runs_per_block": runs_per_block,
        "prefix_max_abs_err": prefix_err,
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
          f"picks_flipped={flipped} prefix_max_abs_err={prefix_err:.3e} "
          f"device_busy_ms={out['device_busy_ms']} "
          f"idle_share={out['device_idle_share']}", flush=True)
    print(f"  replica runs per block of {block} label rows (fragments "
          f"{[r.name for r in virt.fragments]}): {runs_per_block}",
          flush=True)
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
    need(counts == _only(collapse=expect, prefix=counts["prefix"])
         and counts["prefix"] > 0,
         f"launched {counts}, expected {expect} collapse launches and "
         "kernel 3's prefixes only")
    need(rows == len(lab_all) * len(virt.fragments),
         f"kernel 3 counted {rows} rows, not {len(lab_all)} a fragment")
    need(prefix_err <= TOL, f"kernel 3's prefix vs plain {prefix_err:.3e}")
    need(z_counts["collapse"] > 0 and not z_counts["variant"],
         f"<Z> launched {z_counts}")
    need(plain_counts == _only(),
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


QFT_PLAIN_WINDOW = 4    # blocks of qft-16's scan without a kernel traced
# the Z panel without a kernel at a quarter of the samples (its own
# standard errors grow to match): 12-14 s instead of 45-55 s, which pays
# for the sharded engine's phases within the script's time
QFT_PLAIN_Z_SAMPLES = QFT_SAMPLES // 4
BF16_MAX_DIFF = 5e-3    # tests/test_bf16_serving.py, the sampled engine's


def _picks_against_kernel(fn, kfn, lab, u):
    """One block's rows without a kernel (``fn``) against kernel 3's full
    rows (``kfn``) from the same labels and draws: (labels whose picks
    differ, of them within 1e-6 of a threshold, beyond it, max |err| of
    the rows whose picks agree)."""
    ck = _port("ops.collapse_kernel")
    ve = _port("ops.variant_engine")
    picks = []
    rows, _ = fn(lab, u, picks)
    krows, _ = kfn(lab, u)
    bits, margins = ve.picked_bits(picks)
    agree, near, far = ck.compare_picks(bits, kfn.rows_fn.last_bits,
                                        margins)
    err = float((rows - krows).abs()[agree].max()) if bool(agree.any()) \
        else 0.0
    return int((~agree).sum()), near, far, err


def phase_main_qft16_plain(circ, virt, report):
    """qft-16 through the sampled engine without a kernel
    (``sample_pallas=False``: ``make_sim_fn(collapse=True)``, plain
    PyTorch), the "prepped" leg of phase main_qft16 at full width: the
    same 120000 samples, seed, lhs and control variate for the marginal,
    a quarter of them for the Z panel (``QFT_PLAIN_Z_SAMPLES``), each held
    to the 2^16 oracle within 5 of its own standard errors; no kernel
    launched.  The draws are the kernel route's (the
    same sampler call, the same collapse sites in the same draw
    columns), and the first and last blocks of this route's scan, from
    the same labels and draws, equal kernel 3's full rows (picks equal, a
    flip only within 1e-6 of its threshold).  Returns the f32 marginal
    for the bf16 phase."""
    import numpy as np
    import torch

    tq = _port("ops.qpd_sampling")
    run_virtual_circuit = _port("run").run_virtual_circuit
    flags = tq._collapse_flags(virt, "auto")
    knit_kw = dict(seed=QFT_SEED, keep_clbits=QFT_KEEP, method="lhs",
                   control_variate=True, pallas_variant=False, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    dist, cold_s = _timed(lambda: run_virtual_circuit(
        virt, shots=QFT_SAMPLES, engine="sampled", seed=QFT_SEED,
        sample_method="lhs", sample_cv=True, keep_clbits=QFT_KEEP,
        project=False, sample_pallas=False, device=DEV)[0])
    counts = _counts()
    (est, se), warm_s = _timed(lambda: tq.sampled_knit(
        virt, QFT_SAMPLES, with_stderr=True, **knit_kw))
    (z_est, z_se), z_s = _timed(lambda: tq.sampled_expectation_z(
        virt, QFT_Z_SETS, QFT_PLAIN_Z_SAMPLES, seed=QFT_SEED + 1,
        method="lhs", with_stderr=True, control_variate=True,
        pallas_variant=False, device=DEV))
    z_counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    oracle_m, oracle_z = _qft16_oracle(circ)
    est_v = np.asarray(est.values, np.float64)
    m_dev = np.abs(est_v - oracle_m) / np.maximum(se, STDERR_FLOOR)
    z_dev = np.abs(np.asarray(z_est) - np.asarray(oracle_z)) / np.maximum(
        z_se, STDERR_FLOOR)
    rerun_err = float(np.abs(est_v - np.asarray(dist.values)).max())

    # this route's scan and its draws against the kernel route's
    ent = next(e for k, e in virt._scan_step_cache.items()
               if k[3] == tuple(QFT_KEEP) and k[6] is False)
    kfns = [tq._collapse_row_builder_pallas(virt, r.name, device=DEV)[0]
            for r in virt.fragments]
    same_sites = [fn.sites == [sid for sid, _ in kfn.rows_fn.plan.plan
                               .site_meta]
                  for fn, kfn in zip(ent["row_fns"], kfns)]
    uniq, lab_all, mass = _sampled_labels(virt, QFT_SAMPLES, QFT_SEED)
    n_lab = len(lab_all)
    block = tq._label_block(virt, flags, QFT_KEEP, None, ent["states"])
    cseed = QFT_SEED * 31 + 17
    blocks = [(0, min(block, n_lab)), ((n_lab - 1) // block * block, n_lab)]
    picks = []
    for fi, (fn, kfn) in enumerate(zip(ent["row_fns"], kfns)):
        u_all = np.random.default_rng(cseed + 7919 * fi).random(
            (n_lab, max(1, ent["ns"][fi]))).astype(np.float32)
        for b0, b1 in blocks:
            lab = torch.as_tensor(lab_all[b0:b1], device=DEV,
                                  dtype=torch.int64)
            u = torch.as_tensor(u_all[b0:b1], device=DEV)
            flipped, near, far, err = _picks_against_kernel(fn, kfn, lab, u)
            picks.append({"fragment": virt.fragments[fi].name,
                          "block": [b0, b1], "flipped": flipped,
                          "near": near, "far": far, "max_abs_err": err})
    # the device's share, traced over the scan's first blocks
    win = min(n_lab, QFT_PLAIN_WINDOW * block)
    prof = _profile(lambda: tq._scan_core(
        virt, lab_all[:win], mass[:win], keep_clbits=QFT_KEEP, flags=flags,
        collapse_seed=cseed, second_moment=True, control_stats=True,
        pallas_variant=False, device=DEV), cpu=False)
    kernel = report.get("qft16", {})
    out = {
        "routes": ent["routes"], "state_qubits": [st[0] for st in
                                                  ent["states"]],
        "expanded_labels": n_lab, "block": block,
        "n_blocks": -(-n_lab // block), "launches": counts,
        "z_launches": z_counts, "cold_s": cold_s, "warm_s": warm_s,
        "expectation_z_s": z_s, "z_samples": QFT_PLAIN_Z_SAMPLES,
        "peak_gb": peak_gb,
        "rerun_max_abs_err": rerun_err, "same_sites": same_sites,
        "marginal": est_v.tolist(), "marginal_stderr": se.tolist(),
        "marginal_worst_stderrs": float(m_dev.max()),
        "z": np.asarray(z_est).tolist(), "z_stderr": z_se.tolist(),
        "z_worst_stderrs": float(z_dev.max()),
        "blocks_against_kernel_full_rows": picks,
        "trace_window_blocks": -(-win // block),
        "kernel_route": {k: kernel.get(k) for k in (
            "block", "n_blocks", "launches", "first_call_s",
            "second_call_s", "expectation_z_s", "device_busy_ms",
            "device_idle_share")},
    }
    out.update(prof)
    report["qft16_plain"] = out
    print(f"main qft16 without a kernel: routes={ent['routes']} "
          f"labels={n_lab} block={block} x{out['n_blocks']} "
          f"launches={counts} cold_s={cold_s:.3f} warm_s={warm_s:.3f} "
          f"expectation_z_s={z_s:.3f} peak_gb={peak_gb:.3f} marginal worst "
          f"{m_dev.max():.2f} stderrs, z worst {z_dev.max():.2f} stderrs, "
          f"rerun {rerun_err:.3e}; traced {out['trace_window_blocks']} "
          f"blocks: wall {prof['profiled_wall_s']:.3f} s busy_ms="
          f"{prof['device_busy_ms']} idle_share="
          f"{prof['device_idle_share']}", flush=True)
    print(f"  kernel route (main_qft16): {out['kernel_route']}", flush=True)
    for row in picks:
        print(f"  against kernel 3's full rows: {row}", flush=True)
    for row in prof["device_ms_by_kernel"][:5]:
        print(f"  device {row['ms']:.3f} ms x{row['calls']}: "
              f"{row['kernel']}", flush=True)

    def need(ok, what):
        if not ok:
            raise RuntimeError(f"qft16 without a kernel: {what}")

    need(flags == [True, True]
         and ent["routes"] == ["collapse, no kernel"] * 2,
         f"flags {flags}, routes {ent['routes']}")
    need(counts == _only() and z_counts == _only(),
         f"launched {counts}, {z_counts}")
    need(np.isfinite(est_v).all() and est_v.shape == (1 << len(QFT_KEEP),)
         and dist.bit_positions == QFT_KEEP,
         "marginal not finite or of the wrong shape")
    need(all(same_sites), f"collapse sites in another order: {same_sites}")
    need(rerun_err <= 1e-6, f"the second call differs by {rerun_err:.3e}")
    need(float(m_dev.max()) <= STDERRS,
         f"a marginal bin lies {m_dev.max():.2f} stderrs from the oracle")
    need(float(z_dev.max()) <= STDERRS,
         f"a <Z_S> lies {z_dev.max():.2f} stderrs from the oracle")
    for row in picks:
        need(row["far"] == 0 and row["max_abs_err"] <= TOL,
             f"against kernel 3's full rows: {row}")
    return est_v


def phase_sampled_qft16_bf16(virt, report, f32_marginal):
    """The marginal of phase main_qft16_plain with bf16 states
    (``dtype=torch.bfloat16``; the kernels are f32, so every fragment runs
    without one), against the f32 estimate without a kernel: the largest
    difference within the JAX package's 5e-3 and the total variation
    recorded."""
    import numpy as np
    import torch

    tq = _port("ops.qpd_sampling")
    _reset_counts()
    est, wall = _timed(lambda: tq.sampled_knit(
        virt, QFT_SAMPLES, seed=QFT_SEED, keep_clbits=QFT_KEEP,
        method="lhs", control_variate=True, dtype=torch.bfloat16,
        device=DEV))
    counts = _counts()
    routes = next(e["routes"] for k, e in virt._scan_step_cache.items()
                  if k[7] == str(torch.bfloat16))
    got = np.asarray(est.values, np.float64)
    diff = np.abs(got - np.asarray(f32_marginal, np.float64))
    out = {"wall_s": wall, "launches": counts, "routes": routes,
           "max_abs_diff_vs_f32": float(diff.max()),
           "total_variation_vs_f32": float(0.5 * diff.sum()),
           "marginal": got.tolist()}
    report["qft16_bf16"] = out
    print(f"sampled qft16 bf16: wall_s={wall:.3f} launches={counts} "
          f"routes={routes} max_abs_diff_vs_f32={diff.max():.3e} "
          f"tv_vs_f32={0.5 * diff.sum():.3e}", flush=True)
    if counts != _only() or routes != ["collapse, no kernel"] * 2:
        raise RuntimeError(f"bf16 launched {counts}, routes {routes}")
    if not (np.isfinite(got).all() and diff.max() <= BF16_MAX_DIFF):
        raise RuntimeError(f"bf16 against f32: {diff.max():.3e} > "
                           f"{BF16_MAX_DIFF}")


def _cut_wide13(n=13):
    """A hand-built cut circuit at the whole-fragment kernel's width gate:
    frag0 holds ``n`` data qubits under a chain of fixed gates, a gate cut
    (cz) and a wire cut (move) to a 2-qubit frag1, and more gates after
    the slots; every second qubit of frag0 is measured."""
    circuit = _port("circuit.circuit")
    VirtualGateOp = _port("virt.virtual_gates").VirtualGateOp
    cut = circuit.Circuit([circuit.Register("frag0", n),
                           circuit.Register("frag1", 2)], n + 2)
    cut.h(0)
    for q in range(n - 1):
        if q % 2:
            cut.cx(q + 1, q)
        else:
            cut.cx(q, q + 1)
    for q in range(n):
        cut.ry(0.2 * (q + 1), q)
        cut.rz(0.1 * (q + 1), q)
    cut.append(circuit.Instruction("vgate", [n - 1, n],
                                   op=VirtualGateOp("cz")))
    cut.rx(0.7, n - 1)
    cut.cp(0.9, n - 1, 0)
    cut.append(circuit.Instruction("vgate", [1, n + 1],
                                   op=VirtualGateOp("move")))
    cut.cx(n, n + 1)
    cut.h(2)
    for c, q in enumerate(list(range(0, n, 2)) + [n, n + 1]):
        cut.measure(q, c)
    return _port("virt.virtual_circuit").VirtualCircuit(cut)


def phase_sv(label, virt, report, names=None, lanes=None):
    """The whole-fragment kernel against its plain version on the
    fragments ``names`` of ``virt`` (default all), every lane of each
    fragment (or ``lanes`` of them, drawn with a seed); one launch per
    fragment.  The kernel reads no lane table; the plain version takes
    the JAX contract's lane table (``_slot_lane_params``).  The host's
    share is timed apart: the plan (op tables, prefix, per-slot tables)."""
    import numpy as np
    import torch

    sv = _port("ops.sv_kernel")
    names = names or [r.name for r in virt.fragments]
    calls, plain_calls, shapes = [], [], {}
    work = {"bytes": 0, "flops": 0, "pass_bytes": 0}
    lane_table_bytes = 0
    err = rel_err = 0.0
    plan_s = 0.0
    for fi, name in enumerate(names):
        t0 = time.perf_counter()
        plan = sv.build_plan(virt, name)
        plan_s += time.perf_counter() - t0
        built = sv.build_fragment_kernel(virt, name, device=DEV)
        if plan is None or built is None:
            raise RuntimeError(f"{label}/{name}: outside the kernel")
        fn, table, meta = built
        dp = fn.plan
        pick = None
        if lanes is not None:
            pick = np.random.default_rng(11 + fi).integers(
                0, meta["total"], lanes)
            table = table[pick]
        idx = None if pick is None else torch.as_tensor(pick, device=DEV)
        got = sv.sv_rows(dp, idx)
        again = sv.sv_rows(dp, idx)
        par = torch.as_tensor(table, device=DEV)
        want = sv.plain_sv_rows(dp, par)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{label}/{name}: non-finite kernel rows")
        if not torch.equal(got, again):
            raise RuntimeError(f"{label}/{name}: a launch does not repeat")
        frag_err = (got - want).abs().max().item()
        err = max(err, frag_err)
        rel_err = max(rel_err, frag_err / want.abs().max().item())
        del got, again, want
        kinds = dp.plan.ops[:, 0].tolist()
        count = meta["total"] if pick is None else len(pick)
        shapes[name] = {
            "n": dp.plan.n, "k": dp.plan.k, "m": len(dp.plan.meas_vgates),
            "lanes": count, "ops_1q": kinds.count(1),
            "ops_2q": kinds.count(2), "slots": kinds.count(3),
            "prefix_ops": len(dp.plan.prefix_ops),
            "rows_after_rewrite": len(dp.plan.table.rows),
            "row_kinds": {k: dp.plan.table.kinds.count(k)
                          for k in sorted(set(dp.plan.table.kinds))},
            "slot_table_rows": len(dp.plan.slot_tab),
            "threads_group": sv.launch_geometry(dp.plan.n),
        }
        wk = sv.work_counts(dp.plan, pick)
        shapes[name]["flops_per_lane_amplitude"] = (
            wk["flops"] / (count << dp.plan.n))
        for key in work:
            work[key] += wk[key]
        lane_table_bytes += 4 * count * dp.plan.p_cols
        calls.append((dp, idx))
        plain_calls.append((dp, par))
    ms = _time_ms(lambda: [sv.sv_rows(*a) for a in calls], reps=5)
    plain_ms = _time_ms(lambda: [sv.plain_sv_rows(*a) for a in plain_calls],
                        reps=1, warm=0)
    del plain_calls
    bound_ms, bound_by = _bound(work)
    old_bound_ms, _ = _bound({"bytes": work["bytes"] + lane_table_bytes,
                              "flops": work["flops"]})
    report.setdefault("kernels", []).append({
        "name": f"sv_rows/{label}",
        "route": "cuda",
        "source": f"{PKG}/csrc/sv_kernel.cu",
        "replaces": TPU_SV,
        "launches": None,  # filled from the main path's run
        "max_abs_err": err,
        "max_err_over_largest_entry": rel_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "on_main_path": False,  # set by the path that launches it
        "work": work,
        "bound_ms_with_lane_table_bytes": old_bound_ms,
        "fragments": shapes,
        "plan_host_s": plan_s,
    })
    print(f"sv {label}: fragments={shapes} max_abs_err={err:.3e} "
          f"(over the fragment's largest entry {rel_err:.3e}) | one "
          f"launch per fragment, {len(calls)} fragments: ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} ({bound_by}; "
          f"{work['bytes'] / 1e6:.1f} MB, {work['flops'] / 1e9:.2f} GFLOP = "
          f"{work['flops'] / ms / 1e9:.2f} TFLOP/s; counted with a lane "
          f"table's {lane_table_bytes / 1e6:.1f} MB: "
          f"{old_bound_ms:.6f}); shared-memory passes "
          f"{work['pass_bytes'] / 1e9:.1f} GB = "
          f"{work['pass_bytes'] / ms / 1e9:.2f} TB/s; host plan "
          f"{plan_s:.3f} s", flush=True)
    if not (err <= TOL and rel_err <= TOL):
        raise RuntimeError(f"{label}: sv kernel vs plain {err:.3e} (over "
                           f"the largest entry {rel_err:.3e}) > {TOL}")


def phase_sv_width_gate(report):
    """The width gate itself: 13 data qubits run (a lane's state fills
    64 KB of shared memory), held to the plain version and, through the
    entry point, to the batched engine's rows; 14 return None."""
    sv = _port("ops.sv_kernel")
    ve = _port("ops.variant_engine")
    virt = _cut_wide13(sv.MAX_KERNEL_QUBITS)
    phase_sv("wide13", virt, report, names=["frag0"], lanes=WIDE_LANES)
    got = [sv.run_fragment_kernel(virt, reg.name, device=DEV)
           for reg in virt.fragments]
    _, err, rel_err = _rows_vs_batched("wide13", virt, got)
    too_wide = sv.run_fragment_kernel(
        _cut_wide13(sv.MAX_KERNEL_QUBITS + 1), "frag0", device=DEV)
    report["sv_width_gate"] = {"rows_vs_batched_max_abs_err": err,
                               "rows_vs_batched_over_largest_entry": rel_err,
                               "width_14_result": repr(too_wide)}
    print(f"sv width gate: 13-qubit rows vs the batched engine {err:.3e} "
          f"(over the largest entry {rel_err:.3e}); 14 qubits -> "
          f"{too_wide!r}", flush=True)
    if not (err <= ROWS_TOL and rel_err <= ROWS_TOL):
        raise RuntimeError(f"wide13: kernel vs batched rows {err:.3e} "
                           f"(over the largest entry {rel_err:.3e})")
    if too_wide is not None:
        raise RuntimeError("a 14-qubit fragment did not return None")


@contextlib.contextmanager
def _lane_table_meter(stage):
    """Within: every call of ``sv_kernel._slot_lane_params`` (the host lane
    table the kernel no longer reads) adds its seconds to
    ``stage["lane_tables_s"]`` and one to ``stage["lane_table_calls"]``."""
    sv = _port("ops.sv_kernel")
    inner = sv._slot_lane_params
    stage.setdefault("lane_tables_s", 0.0)
    stage.setdefault("lane_table_calls", 0)

    def metered(*args, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            stage["lane_tables_s"] += time.perf_counter() - t0
            stage["lane_table_calls"] += 1

    sv._slot_lane_params = metered
    try:
        yield
    finally:
        sv._slot_lane_params = inner


def _sv_route(virt):
    """The kernel route a caller composes: every fragment's rows from the
    whole-fragment kernel, knit, projection.  Returns (distribution,
    results, seconds by stage; ``lane_tables_s`` is the time the route
    spent building host lane tables)."""
    sv = _port("ops.sv_kernel")
    tknit = _port("ops.knit")
    stage = {}
    with _lane_table_meter(stage):
        results = [sv.run_fragment_kernel(virt, reg.name, device=DEV,
                                          timings=stage)
                   for reg in virt.fragments]
    if any(r is None for r in results):
        raise RuntimeError("a fragment is outside the kernel")
    t0 = time.perf_counter()
    raw = tknit.knit(virt, results)
    t1 = time.perf_counter()
    dist = tknit.nearest_probability_distribution(raw)
    stage["knit_and_fetch_s"] = t1 - t0
    stage["projection_s"] = time.perf_counter() - t1
    return dist, results, stage


def phase_main_sv(label, circ, virt, report, kernel_row):
    """Kernel 5's main path on the card: ``run_fragment_kernel`` for every
    fragment -> ``knit.knit`` -> ``nearest_probability_distribution``,
    launches counted around it, fidelity against the uncut oracle."""
    import torch

    sv = _port("ops.sv_kernel")
    tknit = _port("ops.knit")
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    results = [sv.run_fragment_kernel(virt, reg.name, device=DEV)
               for reg in virt.fragments]
    if any(r is None for r in results):
        raise RuntimeError(f"{label}: a fragment is outside the kernel")
    dist = tknit.nearest_probability_distribution(tknit.knit(virt, results))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _counts()
    rows = {r.name: list(r.values.shape) for r in results}
    del results
    t0 = time.perf_counter()
    warm_dist, results, stage = _sv_route(virt)
    warm_s = time.perf_counter() - t0
    oracle = _port("ops.statevector").simulate_circuit(circ, device=DEV)
    fid = _port("evaluate").hellinger_fidelity(oracle, dist)
    warm_fid = _port("evaluate").hellinger_fidelity(oracle, warm_dist)
    prof = _profile(lambda: _sv_route(virt))
    out = {
        "rows": rows, "outcomes": len(dist.values), "launches": counts,
        "first_call_s": first_s, "warm_wall_s": warm_s, "stages": stage,
        "fidelity": fid, "warm_fidelity": warm_fid,
    }
    out.update(prof)
    report[label] = out
    print(f"main {label}: rows={rows} outcomes={out['outcomes']} "
          f"launches={counts} first_call_s={first_s:.4f} "
          f"warm_wall_s={warm_s:.4f} stages="
          f"{ {k: round(v, 4) for k, v in stage.items()} } fidelity={fid!r} "
          f"device_busy_ms={out['device_busy_ms']} "
          f"idle_share={out['device_idle_share']}", flush=True)
    for row in out["device_ms_by_kernel"][:5]:
        print(f"  device {row['ms']:.3f} ms x{row['calls']}: "
              f"{row['kernel']}", flush=True)
    if counts != _only(sv=len(virt.fragments), prefix=counts["prefix"]):
        raise RuntimeError(f"{label}: launched {counts}, expected one sv "
                           "launch per fragment and kernel 5's prefixes "
                           "only")
    if stage["lane_table_calls"]:
        raise RuntimeError(f"{label}: the route built a host lane table")
    if not (fid > FID_MIN and warm_fid > FID_MIN):
        raise RuntimeError(f"{label}: fidelity {fid!r} / {warm_fid!r} <= "
                           f"{FID_MIN}")
    row = _kernel_row(report, kernel_row)
    row["launches"] = counts["sv"]
    row["on_main_path"] = True
    return results


def _rows_vs_batched(label, virt, sv_results):
    """The whole-fragment kernel's ``FragmentResult`` of every fragment
    against the batched engine's ``run_fragment``: the same clbits and
    vgates, and the largest difference of the rows.  Returns (the batched
    results, that difference, and the largest difference over a fragment's
    largest entry)."""
    ve = _port("ops.variant_engine")
    rows_err = rel_err = 0.0
    results = []
    for got in sv_results:
        want = ve.run_fragment(virt, got.name, device=DEV)
        if (got.bit_positions, got.touching) != (want.bit_positions,
                                                 want.touching):
            raise RuntimeError(f"{label}/{got.name}: positions differ")
        frag_err = (got.values - want.values).abs().max().item()
        rows_err = max(rows_err, frag_err)
        rel_err = max(rel_err, frag_err / want.values.abs().max().item())
        results.append(want)
    return results, rows_err, rel_err


def phase_rows_sup20(virt, report, sv_results):
    """Kernel rows against the batched engine's on a dense distribution:
    sup-20's fragments (15 simulated qubits in the batched engine, 10
    data qubits in the kernel), every variant."""
    t0 = time.perf_counter()
    _, rows_err, rel_err = _rows_vs_batched("sup20", virt, sv_results)
    report["sup20_sv"]["kernel_rows_vs_run_fragment_max_abs_err"] = rows_err
    report["sup20_sv"]["kernel_rows_vs_run_fragment_over_largest_entry"] = (
        rel_err)
    report["sup20_sv"]["run_fragment_s"] = time.perf_counter() - t0
    print(f"main sup20_sv: kernel rows vs run_fragment {rows_err:.3e} "
          f"(over the largest entry {rel_err:.3e}; "
          f"{report['sup20_sv']['run_fragment_s']:.2f} s for the batched "
          "engine's rows)", flush=True)
    if not (rows_err <= ROWS_TOL and rel_err <= ROWS_TOL):
        raise RuntimeError(f"sup20: kernel vs batched rows {rows_err:.3e} "
                           f"(over the largest entry {rel_err:.3e})")


def phase_main_xla(circ, virt, report, sv_results):
    """The batched engine beside the kernel on hwe-16:
    ``run_virtual_circuit(engine="xla")`` and ``engine="auto"`` against
    the oracle; per fragment the kernel's rows against ``run_fragment``'s;
    ``expectation_z`` of both producers' rows against the knitted
    distribution's."""
    import numpy as np
    import torch

    tknit = _port("ops.knit")
    run_virtual_circuit = _port("run").run_virtual_circuit
    oracle = _port("ops.statevector").simulate_circuit(circ, device=DEV)
    fidelity = _port("evaluate").hellinger_fidelity

    out = {}
    dists = {}
    _reset_counts()
    for engine in ("xla", "auto"):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dists[engine], info = run_virtual_circuit(virt, engine=engine,
                                                      device=DEV)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[engine] = {"first_call_s": walls[0], "warm_wall_s": walls[1],
                       "run_time_s": info.run_time,
                       "knit_time_s": info.knit_time,
                       "fidelity": fidelity(oracle, dists[engine])}
    counts = _counts()
    engines_err = float(np.abs(dists["xla"].values
                               - dists["auto"].values).max())

    results, rows_err, rows_rel = _rows_vs_batched("hwe16", virt,
                                                   sv_results)

    z_clbits = sorted(c for cs in _written_data_clbits(virt) for c in cs)
    raw = tknit.knit(virt, results)
    z_dist = _z_of_marginal(raw.values)
    z_xla = tknit.expectation_z(virt, results, z_clbits)
    z_sv = tknit.expectation_z(virt, sv_results, z_clbits)
    prof = _profile(lambda: run_virtual_circuit(virt, engine="xla",
                                                device=DEV), cpu=False)
    out.update({
        "launches": counts, "xla_vs_auto_max_abs_err": engines_err,
        "kernel_rows_vs_run_fragment_max_abs_err": rows_err,
        "kernel_rows_vs_run_fragment_over_largest_entry": rows_rel,
        "z_clbits": z_clbits, "z_of_knitted_distribution": z_dist,
        "expectation_z_batched_rows": z_xla,
        "expectation_z_kernel_rows": z_sv,
    })
    out.update(prof)
    report["hwe16_xla"] = out
    print(f"main hwe16 batched: xla={out['xla']} auto={out['auto']} "
          f"launches={counts} xla_vs_auto={engines_err:.3e} kernel rows vs "
          f"run_fragment {rows_err:.3e} <Z> distribution={z_dist!r} "
          f"batched rows={z_xla!r} kernel rows={z_sv!r} "
          f"device_busy_ms={out['device_busy_ms']} "
          f"idle_share={out['device_idle_share']}", flush=True)
    for row in out["device_ms_by_kernel"][:5]:
        print(f"  device {row['ms']:.3f} ms x{row['calls']}: "
              f"{row['kernel']}", flush=True)

    def need(ok, what):
        if not ok:
            raise RuntimeError(f"hwe16 batched: {what}")

    need(raw.bit_positions == z_clbits and len(z_clbits) == 16,
         f"knitted clbits {raw.bit_positions}")
    for engine in ("xla", "auto"):
        need(out[engine]["fidelity"] > FID_MIN,
             f"engine={engine!r} fidelity {out[engine]['fidelity']!r}")
    need(counts == _only(), f"the batched engine launched {counts}")
    need(engines_err <= 1e-7, f"auto differs from xla by {engines_err:.3e}")
    need(rows_err <= ROWS_TOL and rows_rel <= ROWS_TOL,
         f"kernel rows vs run_fragment {rows_err:.3e} (over the largest "
         f"entry {rows_rel:.3e})")
    need(abs(z_xla - z_dist) <= TOL and abs(z_sv - z_dist) <= TOL,
         f"<Z> {z_xla!r} / {z_sv!r} vs the distribution's {z_dist!r}")


def _marginal_dict(dist, keep):
    """A distribution's marginal on ``keep`` as a {key: probability}
    dict (keys over the global clbits)."""
    import numpy as np

    vals = np.asarray(dist.values, np.float64)
    idx = np.arange(len(vals))
    key = np.zeros(len(vals), np.int64)
    for j, pos in enumerate(dist.bit_positions):
        if pos in keep:
            key |= ((idx >> j) & 1) << pos
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.bincount(inv, weights=vals)
    return {int(k): float(v) for k, v in zip(uniq, sums)}


def _z_of(values, positions, z_set):
    """<prod_{c in z_set} Z_c> of a flat little-endian distribution."""
    import numpy as np

    idx = np.arange(len(values))
    par = np.zeros(len(values), np.int64)
    for c in z_set:
        par ^= (idx >> positions.index(c)) & 1
    return float(np.sum(np.asarray(values, np.float64) * (1 - 2 * par)))


@contextlib.contextmanager
def _spy(module, name, record):
    """Within: ``module.name`` records each call's keywords (and its
    result) into ``record`` before returning it."""
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        record.append((kw, out))
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _split_rows(meta):
    """The splits and stages of a scan's meta, for the report."""
    rows = []
    for sp, st in zip(meta["splits"], meta["stages"]):
        rows.append(None if sp is None else {
            "shared_vgates": sp.shared, "n_anc": sp.n_anc,
            "m_split": sp.m_split, "bank_mb": sp.bank_bytes / 1e6,
            "stages": [{"r_out": t.r_out, "m_in": t.m_in, "sids": t.sids,
                        "steps": len(t.steps)} for t in st]})
    return rows


def phase_main_sup25_streamed(circ, virt, report):
    """sup-25 (stored plan: 10368 labels, fragments of 18 and 17 qubits)
    through the scan without a kernel, as a user calls it:
    ``run_virtual_circuit(engine="streamed")`` in f32 with banks, cold
    (projected, against the 2^25 oracle) and warm (unprojected);
    ``engine="pallas"`` on the same circuit (kernel 1's global path at
    17 and 18 qubits); ``engine="auto", dtype=torch.bfloat16`` (routed
    to the streamed scan) against f32 by total variation;
    ``streamed_expectation_z`` on two z-sets against the f32
    distribution's Z; a trace of one warm call and the peak memory."""
    import numpy as np
    import torch

    run_virtual_circuit = _port("run").run_virtual_circuit
    streamed = _port("ops.streamed")
    fidelity = _port("evaluate").hellinger_fidelity
    oracle, oracle_s = _timed(lambda: _port(
        "ops.statevector").simulate_circuit(circ, device=DEV))
    chunk = streamed.auto_chunk(virt, SUP25_CHUNK)
    _, _, meta = streamed.make_streamed_knit(virt, chunk, share_prefix=True,
                                             device=DEV)
    _, _, meta16 = streamed.make_streamed_knit(virt, chunk,
                                               share_prefix=True,
                                               dtype=torch.bfloat16,
                                               device=DEV)

    def run(**kw):
        return run_virtual_circuit(virt, chunk_size=SUP25_CHUNK,
                                   device=DEV, **kw)[0]

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    dist, cold_s = _timed(lambda: run(engine="streamed"))
    counts = _counts()
    fid = fidelity(oracle, dist)
    raw, warm_s = _timed(lambda: run(engine="streamed", project=False))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _reset_counts()
    pallas, pallas_s = _timed(lambda: run(engine="pallas", project=False))
    pallas_counts = _counts()
    pallas_err = float(np.abs(pallas.values - raw.values).max())
    # sup-25's entries are about 3e-8: the kernel's rows are also held
    # to the 2^25 oracle and against the largest entry
    pallas_fid = fidelity(oracle, pallas)
    pallas_rel = pallas_err / float(np.abs(raw.values).max())

    def tv(p, q):
        return 0.5 * float(np.abs(np.asarray(p.values, np.float64)
                                  - np.asarray(q.values, np.float64)).sum())

    # bf16 as the user calls it (projected, as the f32 result above), and
    # the unprojected quasi-distributions
    routed = []
    torch.cuda.reset_peak_memory_stats()
    with _spy(streamed, "make_streamed_knit", routed):
        b16, b16_s = _timed(lambda: run(engine="auto",
                                        dtype=torch.bfloat16))
    peak16_gb = torch.cuda.max_memory_allocated() / 1e9
    b16_raw = run(engine="auto", dtype=torch.bfloat16, project=False)
    tv16, tv16_raw = tv(b16, dist), tv(b16_raw, raw)
    written = sorted(c for cs in _written_data_clbits(virt) for c in cs)
    z_rows = []
    for z_set in ([written[0], written[len(written) // 2], written[-1]],
                  written):
        z, z_s = _timed(lambda: streamed.streamed_expectation_z(
            virt, z_set, chunk=SUP25_CHUNK, device=DEV))
        z_rows.append({"z_clbits": z_set, "z": z, "s": z_s,
                       "z_of_distribution": _z_of(raw.values,
                                                  raw.bit_positions, z_set)})
    prof = _profile(lambda: run(engine="streamed", project=False),
                    cpu=False)
    out = {
        "labels": meta["global_labels"], "chunk": chunk,
        "n_chunks": meta["n_chunks"],
        "fragment_sim_qubits": [virt.programs[r.name].num_sim_qubits
                                for r in virt.fragments],
        "fuse_qubits": meta["fuse_qubits"],
        "splits": _split_rows(meta), "stage_align": meta["stage_align"],
        "splits_bf16": _split_rows(meta16),
        "stage_align_bf16": meta16["stage_align"],
        "oracle_s": oracle_s, "cold_s": cold_s, "warm_s": warm_s,
        "fidelity": fid, "launches": counts, "peak_gb": peak_gb,
        "pallas_s": pallas_s, "pallas_launches": pallas_counts,
        "pallas_vs_streamed_max_abs_err": pallas_err,
        "pallas_vs_streamed_rel_err": pallas_rel,
        "pallas_fidelity": pallas_fid,
        "bf16_s": b16_s, "bf16_tv": tv16, "bf16_tv_unprojected": tv16_raw,
        "bf16_peak_gb": peak16_gb,
        "bf16_mass": float(np.asarray(b16_raw.values, np.float64).sum()),
        "bf16_fidelity": fidelity(oracle, b16),
        "bf16_routed": [{"dtype": str(kw.get("dtype")),
                         "pallas_variant": kw.get("pallas_variant")}
                        for kw, _ in routed],
        "z": z_rows,
    }
    out.update(prof)
    report["sup25_streamed"] = out
    print(f"main sup25 streamed: labels={out['labels']} chunk={chunk} "
          f"n_chunks={out['n_chunks']} qubits={out['fragment_sim_qubits']} "
          f"fuse={out['fuse_qubits']} stage_align={out['stage_align']} "
          f"(bf16 {out['stage_align_bf16']})", flush=True)
    for key in ("splits", "splits_bf16"):
        for row in out[key]:
            print(f"  {key}: {row}", flush=True)
    print(f"  oracle_s={oracle_s:.3f} cold_s={cold_s:.3f} "
          f"warm_s={warm_s:.3f} fidelity={fid!r} peak_gb={peak_gb:.3f} "
          f"launches={counts}", flush=True)
    print(f"  pallas_s={pallas_s:.3f} launches={pallas_counts} "
          f"vs streamed {pallas_err:.3e} (over the largest entry "
          f"{pallas_rel:.3e}) fidelity={pallas_fid!r}", flush=True)
    print(f"  bf16 (auto) s={b16_s:.3f} tv={tv16:.3e} (unprojected "
          f"{tv16_raw:.3e}) mass={out['bf16_mass']!r} fidelity="
          f"{out['bf16_fidelity']!r} peak_gb={peak16_gb:.3f} "
          f"routed={out['bf16_routed']}", flush=True)
    for row in z_rows:
        print(f"  <Z{row['z_clbits']}> = {row['z']!r} "
              f"({row['s']:.3f} s), distribution "
              f"{row['z_of_distribution']!r}", flush=True)
    print(f"  profiled_wall_s={out['profiled_wall_s']:.3f} "
          f"device_busy_ms={out['device_busy_ms']} "
          f"idle_share={out['device_idle_share']}", flush=True)
    for row in out["device_ms_by_kernel"][:6]:
        print(f"  device {row['ms']:.3f} ms x{row['calls']}: "
              f"{row['kernel']}", flush=True)

    def need(ok, what):
        if not ok:
            raise RuntimeError(f"sup25 streamed: {what}")

    need(out["labels"] == 10368 and out["fragment_sim_qubits"] == [18, 17],
         f"labels {out['labels']}, qubits {out['fragment_sim_qubits']}")
    need(all(s is not None for s in out["splits"]), "a fragment has no bank")
    need(counts == _only(), f"the scan without a kernel launched {counts}")
    need(fid > FID_MIN, f"fidelity {fid!r}")
    need(pallas_counts["variant"] > 0 and pallas_counts["prefix"] > 0
         and pallas_counts == _only(variant=pallas_counts["variant"],
                                    prefix=pallas_counts["prefix"]),
         f"engine='pallas' launched {pallas_counts}")
    need(pallas_err <= TOL and pallas_rel <= REL_TOL,
         f"pallas vs streamed {pallas_err:.3e} ({pallas_rel:.3e} of the "
         f"largest entry)")
    need(pallas_fid > FID_MIN, f"pallas fidelity {pallas_fid!r}")
    need([(r["dtype"], r["pallas_variant"]) for r in out["bf16_routed"]]
         == [("torch.bfloat16", False)],
         f"bf16 auto routed {out['bf16_routed']}")
    need(tv16 <= BF16_TV, f"bf16 total variation {tv16:.3e} > {BF16_TV}")
    for row in z_rows:
        need(abs(row["z"] - row["z_of_distribution"]) <= TOL,
             f"<Z{row['z_clbits']}> {row['z']!r} vs "
             f"{row['z_of_distribution']!r}")


def _skewed_cp(n=6):
    """n qubits under h, two cp gates of small angle across the cut and
    a cx chain, cut into 2 partitions of 4 qubits: the QPD weights are
    skewed, so certified truncation drops labels (sup-20's cz cuts
    weigh every label alike)."""
    import numpy as np

    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
        Circuit,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.cutter.cutter import (  # noqa: E501
        Cutter,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
        VirtualCircuit,
    )

    circ = Circuit(n, n)
    for q in range(n):
        circ.h(q)
    circ.cp(np.pi / 8, 0, n - 1)
    circ.cp(np.pi / 16, 1, n - 2)
    for i in range(n - 1):
        circ.cx(i, i + 1)
    for q in range(n):
        circ.measure(q, q)
    cutter = Cutter(circ, maxNPartitions=2, maxNQubitsPerPartition=4,
                    maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    if not cutter.solve():
        raise RuntimeError("no cut plan for the skewed cp circuit")
    return VirtualCircuit(cutter.getResultCircs()[3])


def phase_streamed_sup20(circ, virt, report):
    """sup-20's scan without a kernel: banks on and off, a stage-aligned
    chunk against an unaligned one, truncation within its certified
    bound (and, on a skewed cp cut that drops labels, equal to the CPU's
    truncated scan), a checkpointed run interrupted after its first segment (driven
    by hand) resumed, and 20000 device shots on a 6-clbit marginal."""
    import shutil

    import numpy as np

    streamed = _port("ops.streamed")
    sampling = _port("ops.sampling")
    fidelity = _port("evaluate").hellinger_fidelity
    oracle = _port("ops.statevector").simulate_circuit(circ, device=DEV)

    def scan(chunk=CHUNK, **kw):
        return streamed.run_virtual_circuit_streamed(
            virt, chunk, device=DEV, **kw)

    out = {}
    base, out["banks_s"] = _timed(lambda: scan(share_prefix=True))
    flat, out["flat_s"] = _timed(lambda: scan(share_prefix=False))
    out["banks_vs_flat"] = float(np.abs(base.values - flat.values).max())
    _, _, meta = streamed.make_streamed_knit(virt, CHUNK, share_prefix=True,
                                             device=DEV)
    align = meta["stage_align"]
    aligned = (CHUNK // align) * align
    unaligned = aligned - 1 if aligned % 2 == 0 else aligned - 2
    out.update(stage_align=align, aligned_chunk=aligned,
               unaligned_chunk=unaligned)
    a, out["aligned_s"] = _timed(lambda: scan(aligned))
    u, out["unaligned_s"] = _timed(lambda: scan(unaligned))
    out["aligned_vs_unaligned"] = float(np.abs(a.values - u.values).max())
    _, _, tmeta = streamed.make_streamed_knit(virt, CHUNK, trunc_eps=1e-3,
                                              share_prefix=True, device=DEV)
    trunc, out["trunc_s"] = _timed(lambda: scan(trunc_eps=1e-3))
    out.update(trunc_kept=tmeta["kept_labels"],
               trunc_dropped_mass=tmeta["dropped_mass"],
               trunc_l1=float(np.abs(np.asarray(trunc.values, np.float64)
                                     - base.values).sum()))

    # labels that truncation drops: the gather over the kept labels and
    # the per-label staging (chunk=-1) on the card, held to the same scan
    # on the CPU and to the certified L1 bound of the exact result
    skew = _skewed_cp()
    skew_exact = streamed.run_virtual_circuit_streamed(
        skew, 32, device=DEV).values
    out["skewed"] = []
    for eps in (1e-2, 5e-2):
        row = {"trunc_eps": eps}
        vals = {}
        for dev in ("cpu", DEV):
            step, xs, smeta = streamed.make_streamed_knit(
                skew, 32, trunc_eps=eps, share_prefix=True, device=dev)
            vals[dev] = step(xs).cpu().numpy()
            row[f"kept_{dev}"] = smeta["kept_labels"]
        row.update(labels=smeta["global_labels"],
                   dropped_mass=smeta["dropped_mass"],
                   banks=[s is not None for s in smeta["splits"]],
                   per_label_stages=all(
                       t.r_out == 1 for st in smeta["stages"] if st
                       for t in st),
                   card_vs_cpu=float(np.abs(vals[DEV] - vals["cpu"]).max()),
                   l1=float(np.abs(np.asarray(vals[DEV], np.float64)
                                   - skew_exact).sum()))
        out["skewed"].append(row)

    # a checkpointed run stopped after its first segment, then resumed
    ckpt = ROOT / "build" / "stream_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    seg = 4
    _, xs, smeta = streamed.make_streamed_knit(virt, CHUNK,
                                               share_prefix=True,
                                               device=DEV)
    fp = streamed._stream_fingerprint(virt, CHUNK, seg, 0)
    carry = smeta["segment_fn"](
        _port("convert").to_device(np.zeros(smeta["carry_shape"],
                                            np.float32), DEV),
        tuple(t[:seg] for t in xs))
    streamed._save_stream_checkpoint(ckpt, fp, carry.cpu().numpy(), 1)
    resumed, out["resumed_s"] = _timed(lambda: scan(checkpoint_dir=ckpt,
                                                    segment_chunks=seg))
    shutil.rmtree(ckpt, ignore_errors=True)
    out["resumed_vs_uninterrupted"] = float(
        np.abs(resumed.values - base.values).max())

    keep = sorted(c for cs in _written_data_clbits(virt) for c in cs)[:6]
    draws = []
    with _spy(sampling, "sample_indices_device", draws):
        shot, out["shots_s"] = _timed(lambda: scan(shots=SHOTS,
                                                   keep_clbits=keep))
    out.update(shots=SHOTS, shots_keep_clbits=keep,
               shots_fidelity=fidelity(_marginal_dict(oracle, keep), shot),
               shots_mass=float(shot.values.sum()),
               shots_draws=[{"shape": list(idx.shape),
                             "device": str(idx.device)} for _, idx in draws])
    report["sup20_streamed"] = out
    print(f"streamed sup20: {out}", flush=True)

    def need(ok, what):
        if not ok:
            raise RuntimeError(f"sup20 streamed: {what}")

    need(out["banks_vs_flat"] <= TOL, f"banks vs flat {out['banks_vs_flat']}")
    need(aligned % align == 0 and unaligned % align != 0,
         f"chunks {aligned} / {unaligned} against align {align}")
    need(out["aligned_vs_unaligned"] <= TOL,
         f"aligned vs unaligned {out['aligned_vs_unaligned']}")
    need(out["trunc_dropped_mass"] <= 1e-3
         and out["trunc_l1"] <= out["trunc_dropped_mass"] + TOL,
         f"truncation L1 {out['trunc_l1']} over its bound "
         f"{out['trunc_dropped_mass']}")
    for row in out["skewed"]:
        need(row[f"kept_{DEV}"] == row["kept_cpu"] < row["labels"]
             and all(row["banks"]) and row["per_label_stages"],
             f"skewed truncation {row}")
        need(row["card_vs_cpu"] <= TOL and row["dropped_mass"] <= row[
            "trunc_eps"] and row["l1"] <= row["dropped_mass"] + TOL,
             f"skewed truncation {row}")
    need(out["resumed_vs_uninterrupted"] <= 1e-6,
         f"resumed vs uninterrupted {out['resumed_vs_uninterrupted']}")
    need(out["shots_fidelity"] > 0.995 and abs(out["shots_mass"] - 1) < 1e-6,
         f"shots fidelity {out['shots_fidelity']!r}, mass "
         f"{out['shots_mass']!r}")
    need([d["shape"] for d in out["shots_draws"]] == [[SHOTS]]
         and out["shots_draws"][0]["device"].startswith("cuda"),
         f"draws {out['shots_draws']}")


NOISY_TRAJ = 8           # sup-20 noisy: fake_kolkata_v2, 8 trajectories
NOISY_SHOTS = 1000
NOISY_SEED = 7
NOISY_CHUNK = 512        # capped by auto_chunk to 32 labels (8 traj, noisy)
NOISY_ROWS_TOL = 2e-5    # the batched and streamed routes, same model
NOISY_TRACE_CHUNKS = 16  # chunks of the noisy streamed scan traced


NOISY_ROWS_REPS = 10     # kernel 1's noisy chunk, timed
NOISY_PLAIN_REPS = 3     # the per-gate plan without a kernel, timed


def phase_noisy_rows_sup20(virt, report):
    """Kernel 1's noisy rows on one chunk of the streamed scan: sup-20's
    fragment 0 (15 qubits: a two-CTA cluster) under ``fake_kolkata_v2``
    with 8 trajectories, the scan's 32 labels of its first chunk and
    their draws (256 rows), through
    ``variant_kernel.make_noisy_chunk_kernel``: within 1e-5 of the
    per-gate plan without a kernel (``make_sim_fn``'s rows on the
    gathered blocks, as ``_SimRows.noisy_rows`` runs it off a card; the
    card tests hold the kernel to its plan's plain replay too), a second
    launch bit for bit, ``variant_rows.noisy`` counting 256; the kernel's
    ms and the plain route's for the chunk."""
    import dataclasses

    import numpy as np
    import torch

    noise = _port("ops.noise")
    streamed = _port("ops.streamed")
    ve = _port("ops.variant_engine")
    vk = _port("ops.variant_kernel")
    nm = dataclasses.replace(noise.fake_kolkata_v2(), trajectories=NOISY_TRAJ)
    name = virt.fragments[0].name
    prog = virt.programs[name]
    specs = [vg.spec for vg in virt.vgates]
    chunk = streamed.auto_chunk(virt, NOISY_CHUNK, NOISY_TRAJ, noisy=True)
    sim_fn = ve.make_sim_fn(virt, name, noise=nm, build_matrices=False)[0]
    fn = vk.make_noisy_chunk_kernel(sim_fn, prog, specs, DEV)
    dp = fn.plan
    strides, n_inst, _ = ve.label_strides(specs, range(len(specs)))
    vidx = torch.as_tensor(ve.variant_index_table(
        range(len(specs)), strides, n_inst, chunk), device=DEV)
    pidx = torch.as_tensor(streamed._sample_pauli_indices(
        np.random.default_rng(NOISY_SEED),
        [(pr, bank) for (_, _, pr, bank, _) in sim_fn.noise_sites], chunk,
        NOISY_TRAJ), device=DEV, dtype=torch.int64)
    rows = chunk * NOISY_TRAJ
    tables = [[torch.as_tensor(t, device=DEV) for t in tabs]
              for tabs in ve._slot_tables(prog, specs, fused=False)]
    banks = {s: torch.as_tensor(sim_fn.site_banks[s], device=DEV)
             for s in sim_fn.active_sites}

    def plain():
        mats = [tuple(t[vidx[:, sl.vgate_idx]].repeat_interleave(
            NOISY_TRAJ, dim=0) for t in tabs)
            for sl, tabs in zip(prog.slots, tables)]
        flat = pidx.reshape(rows, -1)
        return sim_fn(mats, DEV, {s: b[flat[:, s]] for s, b in banks.items()})

    before = vk.variant_rows.noisy
    got = fn(vidx, pidx)
    torch.cuda.synchronize()
    counted = vk.variant_rows.noisy - before
    launch = dict(vk.variant_rows.last_launch)
    again = fn(vidx, pidx)
    per_gate = plain()
    torch.cuda.synchronize()
    out = {"fragment": name, "n": dp.plan.n, "rows": rows,
           "plan_rows": len(dp.plan.table.rows),
           "entry_stride": dp.plan.entry_stride, "noisy_counted": counted,
           "cluster": launch["cluster"], "grid": launch["grid"],
           "runs": int(launch["runs"]),
           "max_abs_err_plain": (got - per_gate).abs().max().item(),
           "repeats": bool(torch.equal(got, again))}
    del got, again, per_gate
    out["kernel_ms"] = _time_ms(lambda: fn(vidx, pidx), NOISY_ROWS_REPS)
    out["plain_ms"] = _time_ms(plain, NOISY_PLAIN_REPS, warm=1)
    report["noisy_rows_sup20"] = out
    print(f"noisy rows sup20 ({name}, n = {out['n']}, {rows} rows, "
          f"{out['plan_rows']} plan rows, {out['entry_stride']} entry "
          f"floats a row, cluster {out['cluster']}, grid {out['grid']}): "
          f"kernel_ms={out['kernel_ms']:.4f} plain_ms="
          f"{out['plain_ms']:.4f} max_abs_err "
          f"{out['max_abs_err_plain']:.3e} variant_rows.noisy +{counted}",
          flush=True)
    if not (out["max_abs_err_plain"] <= TOL and out["repeats"]
            and counted == rows and out["cluster"] == 2):
        raise RuntimeError(f"noisy rows sup20: {out}")


def phase_main_noisy_sup20(circ, virt, report):
    """sup-20 under ``fake_kolkata_v2`` with 8 trajectories, as the JAX
    package's noisy serving run (benchmarks/noisy_streamed_tpu.py "sup20")
    calls it: ``run_noisy_virtual_circuit(engine="streamed", shots=1000,
    seed=7)`` cold and warm (its noisy rows one kernel 1 launch a chunk
    and fragment; mass 1, support <= 1000, peak memory, a
    device-only trace of the scan's first chunks); the same call without
    shots (non-negative, the projection keeping the unprojected knit's
    mass) and the first chunk's rows of each fragment, from the scan's own
    per-chunk function, against the same draws on the CPU;
    with the gate noise zeroed, readout kept and one trajectory, the
    streamed and batched routes against each other; with no noise at
    all, the routed scan against ``engine="pallas"``."""
    import dataclasses

    import numpy as np
    import torch

    noise = _port("ops.noise")
    streamed = _port("ops.streamed")
    fidelity = _port("evaluate").hellinger_fidelity
    nm = dataclasses.replace(noise.fake_kolkata_v2(), trajectories=NOISY_TRAJ)

    def run(model=nm, engine="streamed", **kw):
        return noise.run_noisy_virtual_circuit(
            virt, model, engine=engine, seed=NOISY_SEED,
            chunk_size=NOISY_CHUNK, device=DEV, **kw)[0]

    chunk = streamed.auto_chunk(virt, NOISY_CHUNK, NOISY_TRAJ, noisy=True)
    out = {"trajectories": NOISY_TRAJ, "chunk": chunk, "model": nm.name}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    shot, out["cold_s"] = _timed(lambda: run(shots=NOISY_SHOTS))
    out["launches"] = _counts()
    _, out["warm_s"] = _timed(lambda: run(shots=NOISY_SHOTS))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out.update(shots=NOISY_SHOTS,
               shots_mass=float(np.sum(shot.values, dtype=np.float64)),
               shots_support=int(np.count_nonzero(shot.values)),
               outcomes=len(shot.values))
    print(f"main noisy sup20: chunk={chunk} cold_s={out['cold_s']:.3f} "
          f"warm_s={out['warm_s']:.3f} peak_gb={out['peak_gb']:.3f} "
          f"mass={out['shots_mass']!r} support={out['shots_support']}",
          flush=True)

    # without shots: the projected distribution (the projection moves no
    # mass: it keeps the knit's, which finite trajectories move off 1 as
    # an unbiased estimate), and the first chunk's rows of each fragment
    # against the same draws on the CPU
    full, out["no_shots_s"] = _timed(run)
    raw = streamed.run_virtual_circuit_streamed(
        virt, NOISY_CHUNK, noise=nm, seed=NOISY_SEED, device=DEV)
    out.update(no_shots_mass=float(np.sum(full.values, dtype=np.float64)),
               no_shots_min=float(np.min(full.values)),
               unprojected_mass=float(np.sum(raw.values, dtype=np.float64)))
    del raw
    metas = {dev: streamed.make_streamed_knit(
        virt, chunk, noise=nm, seed=NOISY_SEED, device=dev)[1:]
        for dev in (DEV, "cpu")}
    out.update(n_chunks=metas[DEV][1]["n_chunks"],
               labels=metas[DEV][1]["global_labels"], rows=[])
    # a device-only trace of the scan's first chunks (a whole call's
    # 350000 events take a minute to read)
    xs, meta = metas[DEV]
    out["trace_window_chunks"] = NOISY_TRACE_CHUNKS
    out.update(_profile(lambda: meta["segment_fn"](
        torch.zeros(meta["carry_shape"], device=DEV),
        tuple(x[:NOISY_TRACE_CHUNKS] for x in xs)), cpu=False))
    print(f"  traced {NOISY_TRACE_CHUNKS} chunks: profiled_wall_s="
          f"{out['profiled_wall_s']:.3f} trace_processing_s="
          f"{out['trace_processing_s']:.1f} device_busy_ms="
          f"{out['device_busy_ms']} idle_share={out['device_idle_share']}",
          flush=True)
    for row in out["device_ms_by_kernel"][:6]:
        print(f"  device {row['ms']:.3f} ms x{row['calls']}: "
              f"{row['kernel']}", flush=True)
    for fi, reg in enumerate(virt.fragments):
        rows = {}
        for dev, (xs, meta) in metas.items():
            t0 = time.perf_counter()
            rows[dev] = meta["fragment_rows"][fi](
                xs[0][0], None, xs[2 + fi][0]).cpu().numpy()
            rows[dev + "_s"] = time.perf_counter() - t0
        err = float(np.abs(rows[DEV] - rows["cpu"]).max())
        big = float(np.abs(rows["cpu"]).max())
        same_draws = bool(torch.equal(metas[DEV][0][2 + fi].cpu(),
                                      metas["cpu"][0][2 + fi]))
        out["rows"].append({"fragment": reg.name,
                            "shape": list(rows["cpu"].shape),
                            "max_abs_err": err, "rel_err": err / big,
                            "same_draws": same_draws,
                            "card_s": rows[DEV + "_s"],
                            "cpu_s": rows["cpu_s"]})
    del metas

    # gate noise zeroed, readout kept, one trajectory: streamed = batched
    zero = dataclasses.replace(nm, p1=0.0, p2=0.0, trajectories=1,
                               p1_q=np.zeros_like(nm.p1_q),
                               p2_q=np.zeros_like(nm.p2_q))
    ro_s, out["readout_streamed_s"] = _timed(lambda: run(zero))
    ro_b, out["readout_batched_s"] = _timed(lambda: run(zero, "auto"))
    out["readout_streamed_vs_batched"] = float(
        np.abs(ro_s.values - ro_b.values).max())
    # no noise at all (routed): the exact distribution
    free = noise.NoiseModel(name="noiseless", p1=0.0, p2=0.0,
                            readout01=0.0, readout10=0.0, trajectories=1,
                            num_qubits=27, coupling=nm.coupling)
    exact, out["noiseless_s"] = _timed(lambda: run(free))
    pallas = _port("run").run_virtual_circuit(virt, engine="pallas",
                                              chunk_size=CHUNK, device=DEV)[0]
    out["noiseless_fidelity"] = fidelity(pallas, exact)
    report["noisy_sup20"] = out
    print(f"  no_shots_s={out['no_shots_s']:.3f} mass="
          f"{out['no_shots_mass']!r} (unprojected "
          f"{out['unprojected_mass']!r}) n_chunks={out['n_chunks']}",
          flush=True)
    for row in out["rows"]:
        print(f"  first chunk rows {row}", flush=True)
    print(f"  readout only: streamed {out['readout_streamed_s']:.3f} s, "
          f"batched {out['readout_batched_s']:.3f} s, max diff "
          f"{out['readout_streamed_vs_batched']:.3e}; noiseless "
          f"{out['noiseless_s']:.3f} s fidelity "
          f"{out['noiseless_fidelity']!r}", flush=True)

    def need(ok, what):
        if not ok:
            raise RuntimeError(f"noisy sup20: {what}")

    need(out["labels"] == 7776 and chunk == 32,
         f"labels {out['labels']}, chunk {chunk}")
    frags = len(virt.fragments)
    need(out["launches"] == _only(
        variant=frags * out["n_chunks"],
        noisy=frags * out["n_chunks"] * chunk * NOISY_TRAJ),
        f"launched {out['launches']}")
    need(abs(out["shots_mass"] - 1.0) <= 1e-6
         and out["shots_support"] <= NOISY_SHOTS,
         f"shots mass {out['shots_mass']!r}, support "
         f"{out['shots_support']}")
    need(out["no_shots_min"] >= 0.0
         and abs(out["no_shots_mass"] - out["unprojected_mass"]) <= TOL,
         f"projected mass {out['no_shots_mass']!r} (unprojected "
         f"{out['unprojected_mass']!r}, least entry "
         f"{out['no_shots_min']!r})")
    for row in out["rows"]:
        need(row["same_draws"] and row["max_abs_err"] <= TOL
             and row["rel_err"] <= TOL, f"first chunk rows {row}")
    need(out["readout_streamed_vs_batched"] <= NOISY_ROWS_TOL,
         f"streamed vs batched {out['readout_streamed_vs_batched']:.3e}")
    need(out["noiseless_fidelity"] > FID_MIN,
         f"noiseless fidelity {out['noiseless_fidelity']!r}")
    return full


NOISY_READOUT_TOL = 3e-5  # test_noisy_sampled_readout_only_full_grid_identity
NOISY_TRACE_BLOCKS = 4    # blocks of the noisy sampled scan traced


def phase_main_noisy_sup20_sampled(circ, virt, report, streamed):
    """sup-20 under ``fake_kolkata_v2`` with 8 trajectories through the
    sampled engine: ``run_noisy_virtual_circuit(engine="sampled",
    shots=None, seed=7)``, the default budget (2,000,000 label draws, so
    every one of the 7776 labels appears), cold and warm, no kernel
    launched: non-negative, its mass the unprojected estimate's (the
    projection moves none; that mass is itself an estimate of 1, its
    standard error from the control-variate moments, recorded).  The first
    block's noisy rows of each fragment equal the CPU's from the same
    numpy draws within 1e-5 (absolute and of the largest entry).  With
    the gate noise zeroed (readout only), the full label grid with exact
    masses through ``_estimate(noise=...)`` equals the unprojected knit
    of ``run_fragment_noisy`` within 3e-5.  Recorded beside: the total
    variation of a 6-clbit marginal against ``streamed`` (phase
    main_noisy_sup20's projected result), label-sampling time, peak
    memory, and a device-only trace of the scan's first blocks."""
    import dataclasses

    import numpy as np
    import torch

    noise = _port("ops.noise")
    tq = _port("ops.qpd_sampling")
    ve = _port("ops.variant_engine")
    knit = _port("ops.knit")
    nm = dataclasses.replace(noise.fake_kolkata_v2(), trajectories=NOISY_TRAJ)
    models = [nm] * len(virt.fragments)
    budget = min(tq.sampling_overhead(virt, eps=0.05)["shots_for_eps"],
                 2_000_000)

    def run():
        return noise.run_noisy_virtual_circuit(
            virt, nm, engine="sampled", seed=NOISY_SEED, device=DEV)[0]

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    dist, cold_s = _timed(run)
    counts = _counts()
    again, warm_s = _timed(run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    uniq, cnt = tq.sample_label_counts(virt, budget, NOISY_SEED)
    sample_s = time.perf_counter() - t0
    mass = cnt.astype(np.float64) / budget
    (raw, stats), raw_s = _timed(lambda: tq._estimate(
        virt, uniq, mass, control_stats=True, noise=models,
        noise_seed=NOISY_SEED, device=DEV))
    raw_v = np.asarray(raw.values, np.float64)
    got = np.asarray(dist.values, np.float64)
    mass_se = float(np.sqrt(max(stats["y2"] - stats["y_mean"] ** 2, 0.0)
                            / budget))
    ent = next(e for k, e in virt._scan_step_cache.items()
               if k[8] is not None and k[3] is None and k[4] is None)
    block = tq._label_block(virt, [False] * len(virt.fragments),
                            states=ent["states"])

    # the first block's rows, card against CPU from the same draws
    rows = []
    for fi, reg in enumerate(virt.fragments):
        got_rows = {}
        for dev in (DEV, "cpu"):
            fn = tq._noisy_row_builder(virt, reg.name, nm, dev)[0]
            draws = fn.prepare(len(uniq), NOISY_SEED + fi)
            lab = torch.as_tensor(uniq[:block], device=dev,
                                  dtype=torch.int64)
            t0 = time.perf_counter()
            got_rows[dev] = fn.rows(lab, draws[:block]).cpu().numpy()
            got_rows[dev + "_s"] = time.perf_counter() - t0
        err = float(np.abs(got_rows[DEV] - got_rows["cpu"]).max())
        big = float(np.abs(got_rows["cpu"]).max())
        rows.append({"fragment": reg.name,
                     "shape": list(got_rows["cpu"].shape),
                     "max_abs_err": err, "rel_err": err / big,
                     "card_s": got_rows[DEV + "_s"],
                     "cpu_s": got_rows["cpu_s"]})

    # readout only: the full grid with exact masses = the exact noisy knit
    zero = dataclasses.replace(nm, p1=0.0, p2=0.0, trajectories=1,
                               p1_q=np.zeros_like(nm.p1_q),
                               p2_q=np.zeros_like(nm.p2_q))
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, total = ve.label_strides(specs, range(len(specs)))
    vidx = ve.variant_index_table(range(len(specs)), strides, n_inst, total)
    grid_mass = np.ones(total)
    for g, spec in enumerate(specs):
        m = tq._variant_magnitudes(spec)
        grid_mass *= (m / m.sum())[vidx[:, g]]
    grid, grid_s = _timed(lambda: tq._estimate(
        virt, vidx, grid_mass, noise=[zero] * len(virt.fragments),
        device=DEV))
    results = [noise.run_fragment_noisy(virt, reg.name, zero, seed=0,
                                        device=DEV)
               for reg in virt.fragments]
    exact, positions = knit.knit_values(virt, results)
    exact = exact.cpu().numpy().astype(np.float64)
    del results
    readout_err = float(np.abs(np.asarray(grid.values, np.float64)
                               - exact).max())

    # a 6-clbit marginal against the streamed engine's result
    keep = sorted(c for cs in _written_data_clbits(virt) for c in cs[:3])
    a, b = _marginal_dict(dist, keep), _marginal_dict(streamed, keep)
    tv = 0.5 * sum(abs(a.get(k, 0.0) - b.get(k, 0.0)) for k in set(a) | set(b))

    win = min(len(uniq), NOISY_TRACE_BLOCKS * block)
    prof = _profile(lambda: tq._scan_core(
        virt, uniq[:win], mass[:win], noise=models, noise_seed=NOISY_SEED,
        device=DEV), cpu=False)
    out = {
        "model": nm.name, "trajectories": NOISY_TRAJ, "budget": budget,
        "unique_labels": len(uniq), "block": block,
        "n_blocks": -(-len(uniq) // block), "routes": ent["routes"],
        "launches": counts, "cold_s": cold_s, "warm_s": warm_s,
        "warm_equal_cold": float(np.abs(np.asarray(again.values) - got)
                                 .max()),
        "label_sampling_s": sample_s, "raw_estimate_s": raw_s,
        "peak_gb": peak_gb, "mass": float(got.sum()),
        "unprojected_mass": float(raw_v.sum()), "mass_stderr": mass_se,
        "least_entry": float(got.min()),
        "projected_vs_raw_projection": float(np.abs(
            knit.nearest_probability_distribution(raw).values - got).max()),
        "first_block_rows": rows, "readout_only_grid_s": grid_s,
        "readout_only_max_abs_err": readout_err,
        "marginal_clbits": keep, "tv_vs_streamed": tv,
        "trace_window_blocks": -(-win // block),
    }
    out.update(prof)
    report["noisy_sup20_sampled"] = out
    print(f"main noisy sup20 sampled: budget={budget} labels={len(uniq)} "
          f"block={block} x{out['n_blocks']} routes={ent['routes']} "
          f"launches={counts} cold_s={cold_s:.3f} warm_s={warm_s:.3f} "
          f"label_sampling_s={sample_s:.3f} peak_gb={peak_gb:.3f} "
          f"mass={out['mass']!r} (unprojected {out['unprojected_mass']!r}, "
          f"stderr {mass_se:.4f}) least={out['least_entry']!r} "
          f"tv_vs_streamed={tv:.4f} readout_only_err={readout_err:.3e} "
          f"({grid_s:.3f} s); traced {out['trace_window_blocks']} blocks: "
          f"wall {prof['profiled_wall_s']:.3f} s busy_ms="
          f"{prof['device_busy_ms']} idle_share="
          f"{prof['device_idle_share']}", flush=True)
    for row in rows:
        print(f"  first block rows {row}", flush=True)
    for row in prof["device_ms_by_kernel"][:5]:
        print(f"  device {row['ms']:.3f} ms x{row['calls']}: "
              f"{row['kernel']}", flush=True)

    def need(ok, what):
        if not ok:
            raise RuntimeError(f"noisy sup20 sampled: {what}")

    need(budget == 2_000_000 and len(uniq) == 7776,
         f"budget {budget}, {len(uniq)} labels")
    need(counts == _only(), f"launched {counts}")
    need(ent["routes"] == ["noisy, no kernel"] * 2, f"{ent['routes']}")
    need(np.isfinite(got).all() and got.min() >= 0.0
         and abs(got.sum() - raw_v.sum()) <= 1e-6,
         f"projected mass {got.sum()!r} (unprojected {raw_v.sum()!r}), "
         f"least entry {got.min()!r}")
    need(out["projected_vs_raw_projection"] <= 1e-6
         and out["warm_equal_cold"] <= 1e-6,
         f"projection {out['projected_vs_raw_projection']:.3e}, warm "
         f"{out['warm_equal_cold']:.3e}")
    for row in rows:
        need(row["max_abs_err"] <= TOL and row["rel_err"] <= TOL,
             f"first block rows {row}")
    need(grid.bit_positions == positions
         and readout_err <= NOISY_READOUT_TOL,
         f"readout-only grid off by {readout_err:.3e}")


def phase_sampled_hwe40(label, virt, report):
    """hwe-40's two 22-qubit fragments in ancilla mode, past the variant
    kernel's 20-qubit gate, through the sampled engine's route without a
    kernel: the full grid of 36 labels with exact masses through
    ``_estimate`` on the 8-clbit marginal of phase main_hwe40_dense and
    through ``_estimate_z``, equal to ``engine="pallas"`` (kernel 4)
    within 1e-6; no kernel launched by the sampled route."""
    import numpy as np

    tq = _port("ops.qpd_sampling")
    ve = _port("ops.variant_engine")
    run_virtual_circuit = _port("run").run_virtual_circuit
    keep = sorted(c for cs in _written_data_clbits(virt) for c in cs[:4])
    z_sets = [set(keep), set(keep[:4]), {keep[0], keep[-1]}]
    specs = [vg.spec for vg in virt.vgates]
    strides, n_inst, total = ve.label_strides(specs, range(len(specs)))
    vidx = ve.variant_index_table(range(len(specs)), strides, n_inst, total)
    mass = np.ones(total)
    for g, spec in enumerate(specs):
        m = tq._variant_magnitudes(spec)
        mass *= (m / m.sum())[vidx[:, g]]
    flags = [False] * len(virt.fragments)
    _reset_counts()
    est, est_s = _timed(lambda: tq._estimate(
        virt, vidx, mass, keep_clbits=keep, collapse=flags, device=DEV))
    z, z_s = _timed(lambda: tq._estimate_z(virt, vidx, mass, z_sets,
                                           collapse=flags, device=DEV))
    counts = _counts()
    routes = [e["routes"] for e in virt._scan_step_cache.values()]
    ref, ref_s = _timed(lambda: run_virtual_circuit(
        virt, engine="pallas", chunk_size=HWE_CHUNK, keep_clbits=keep,
        project=False, device=DEV)[0])
    got = np.asarray(est.values, np.float64)
    want = np.asarray(ref.values, np.float64)
    err = float(np.abs(got - want).max())
    z_ref = [_z_of(want, ref.bit_positions, s_z) for s_z in z_sets]
    z_err = float(np.abs(np.asarray(z) - np.asarray(z_ref)).max())
    block = tq._label_block(virt, flags, keep, None,
                            next(iter(virt._scan_step_cache.values()))[
                                "states"])
    out = {"labels": total, "keep_clbits": keep, "block": block,
           "routes": routes, "launches": counts, "estimate_s": est_s,
           "estimate_z_s": z_s, "pallas_s": ref_s,
           "max_abs_err_vs_pallas": err, "z": list(map(float, z)),
           "z_max_abs_err_vs_pallas": z_err,
           "marginal_sum": float(got.sum())}
    report[f"sampled_{label}"] = out
    print(f"sampled {label}: labels={total} block={block} routes={routes} "
          f"launches={counts} estimate_s={est_s:.3f} "
          f"estimate_z_s={z_s:.3f} pallas_s={ref_s:.3f} "
          f"max_abs_err_vs_pallas={err:.3e} z_err={z_err:.3e} "
          f"marginal_sum={got.sum()!r}", flush=True)
    if counts != _only() or any(r != ["ancilla, no kernel"] * 2
                                for r in routes):
        raise RuntimeError(f"{label}: launched {counts}, routes {routes}")
    if not (np.isfinite(got).all() and est.bit_positions == keep
            and err <= 1e-6 and z_err <= 1e-6):
        raise RuntimeError(f"{label}: sampled vs pallas {err:.3e}, "
                           f"z {z_err:.3e}")


def phase_noisy_parity_ghz24(circ, virt, report):
    """The reference's noisy experiment on ghz-24 (P2 Q12):
    ``compare_original_with_cut`` with the untranspiled
    ``fake_kolkata_v2`` at 1000 shots, so the uncut leg runs
    ``simulate_noisy_circuit`` at 2^24 on the card (the exact first-order
    mixture of its calibration-bound sites).  The reference records an
    input fidelity of 0.731 (the JAX package 0.715, noisy_parity.json):
    held within [0.65, 0.80]; the cut fidelity above 0.97 (the bracket of
    noisy_spread.json starts at 0.9746)."""
    import dataclasses

    nm = dataclasses.replace(_port("ops.noise").fake_kolkata_v2(),
                             untranspiled=True)
    res, wall = _timed(lambda: _port("evaluate").compare_original_with_cut(
        circ, virt._circuit, noise_model=nm, shots=NOISY_SHOTS, seed=0,
        chunk_size=CHUNK, device=DEV))
    out = {"input_fidelity": res.input_fidelity,
           "cut_fidelity": res.cut_fidelity,
           "cut_vs_uncut_fidelity": res.cut_vs_uncut_fidelity,
           "wall_s": wall, "shots": NOISY_SHOTS}
    report["noisy_parity_ghz24"] = out
    print(f"noisy parity ghz24: {out}", flush=True)
    if not (0.65 <= res.input_fidelity <= 0.80 and res.cut_fidelity > 0.97):
        raise RuntimeError(f"noisy parity ghz24: {out}")


def phase_noisy_mitigation(report):
    """The flow of examples/mitigation.py on the card: GHZ-8 cut into two
    5-qubit fragments, ZNE (exponential fit over scales 1, 2, 3) of
    <Z^8> through the noisy streamed observable with depolarising noise
    and T1/T2 brings it nearer to 1 than the unmitigated value;
    ``mitigate_readout`` inverts ``apply_readout_error`` (calibrated
    per-qubit rates) within 1e-5."""
    import numpy as np

    cutter_mod = _port("cutter.cutter")
    noise = _port("ops.noise")
    mit = _port("ops.mitigation")
    circ = _port("models.zoo").genCirc("ghz", 8, 1)
    cutter = cutter_mod.Cutter(circ, maxNPartitions=2,
                               maxNQubitsPerPartition=5)
    if not cutter.solve():
        raise RuntimeError("noisy mitigation: no cut plan for ghz-8")
    virt = _port("virt.virtual_circuit").VirtualCircuit(
        cutter.getResultCircs()[3])
    z = sorted(ins.clbits[0] for ins in circ.instructions
               if ins.name == "measure")
    nm = noise.NoiseModel(p1=0.01, p2=0.05, readout01=0.0, readout10=0.0,
                          t1=20e-6, t2=25e-6, trajectories=96)
    (est, vals), zne_s = _timed(lambda: mit.zne_expectation_z(
        virt, z, nm, scales=(1.0, 2.0, 3.0), method="exp", seed=1,
        device=DEV))
    exact = _port("ops.statevector").simulate_circuit(circ, device=DEV)
    kol = noise.fake_kolkata_v2()
    qubits = list(range(len(exact.bit_positions)))
    noisy = noise.apply_readout_error(exact, kol, bit_qubits=qubits,
                                      device=DEV)
    back = mit.mitigate_readout(noisy, kol, bit_qubits=qubits)
    out = {"zne": est, "per_scale": vals, "zne_s": zne_s,
           "readout_shift": float(np.abs(noisy.values
                                         - exact.values).max()),
           "readout_inverse_err": float(np.abs(back.values
                                               - exact.values).max())}
    report["noisy_mitigation"] = out
    print(f"noisy mitigation: {out}", flush=True)
    if not (abs(est - 1.0) < abs(vals[0] - 1.0) and vals[0] < 0.99):
        raise RuntimeError(f"noisy mitigation: ZNE {est!r} from {vals}")
    if not (out["readout_inverse_err"] <= TOL
            and out["readout_shift"] > 1e-3):
        raise RuntimeError(f"noisy mitigation: readout {out}")


def _profile(fn, cpu=True):
    """A torch.profiler trace of one ``fn()``: device time by kernel and
    the device's busy share of the wall.  ``cpu=False`` traces the
    device alone (less overhead on a path of some 10^5 launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels, copies): a host op's own device
    # time repeats the kernels it launched, so key_averages would count
    # them twice; busy time is the union of the device intervals
    t_trace = time.perf_counter()
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
        "trace_processing_s": time.perf_counter() - t_trace,
        "device_busy_ms": busy_ms if by_kernel else "not measured",
        "device_idle_share": (1 - busy_ms / (wall * 1e3)) if by_kernel
        else "not measured",
        "device_ms_by_kernel": [
            {"kernel": k[:80], "ms": ms, "calls": n}
            for k, ms, n in by_kernel[:8]
        ],
    }


def phase_main(label, circ, virt, report, timed_reps=1, kernel_row=None):
    """The user's path on the card, kernel launches counted around it.
    ``kernel_row``: the report's kernel row whose launches this path
    supplies."""
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
    if counts != _only(variant=launches, prefix=counts["prefix"]) \
            or not launches > 0:
        raise RuntimeError(f"{label}: launched {counts}, expected the "
                           "variant kernel and its prefixes only")
    if not fid > FID_MIN:
        raise RuntimeError(f"{label}: fidelity {fid!r} <= {FID_MIN}")
    if kernel_row is not None:
        row = _kernel_row(report, kernel_row)
        row["launches"] = launches
        row["on_main_path"] = True


def phase_variant_witness(label, virt, report):
    """The variant kernel at another width class: the first chunk of the
    label grid through every fragment, folded and staged, as the main
    path launches it."""
    blk = _label_blocks(virt, CHUNK, first_only=True)[0]
    report.setdefault("kernels", []).append(
        _variant_chunk(label, virt, blk, True, True))


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
    make_streamed_knit(virt, CHUNK, device=DEV, pallas_variant=True)
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


# ---------------------------------------------------------------------------
# The sharded engine (plain PyTorch over a process-group mesh, no kernel)
# ---------------------------------------------------------------------------

WIDE_NBIG = 26           # data qubits of the wide fragment (27 simulated)
WIDE_LOCAL = 24          # max_local_qubits asked for it
DP_TOL = 2e-6            # tests/test_streamed_sharded.py


def _phase_line(label, report_row):
    """The line every sharded phase prints: the card, warm time, idle
    share, peak memory and error against its reference."""
    print(f"{label}: card={report_row['card']} warm_s="
          f"{report_row['warm_s']!r} idle_share="
          f"{report_row['device_idle_share']} peak_gb="
          f"{report_row['peak_gb']:.3f} max_abs_err="
          f"{report_row['max_abs_err']!r} ({report_row['reference']})",
          flush=True)


def _peak_run(fn):
    """``fn()`` timed, with the card's peak allocated memory around it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, secs = _timed(fn)
    return out, secs, torch.cuda.max_memory_allocated() / 1e9


def _collectives():
    """Within: every Mesh collective is counted by kind (the port's
    sharded engine calls them on its axis groups)."""
    mesh_mod = _port("parallel.mesh")
    counts = {"all_reduce": 0, "all_gather": 0, "exchange": 0}
    stack = contextlib.ExitStack()
    for name in counts:
        real = getattr(mesh_mod.Mesh, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            if self._live(a[1] if len(a) > 1 else kw.get("axis")):
                counts[_name] += 1
            return _real(self, *a, **kw)

        setattr(mesh_mod.Mesh, name, spy)
        stack.callback(setattr, mesh_mod.Mesh, name, real)
    return stack, counts


def phase_main_sharded_sup20(circ, virt, report, card):
    """sup-20 exact through ``engine="sharded"``: on a mesh of one with
    no process group, then inside an NCCL process group of one (a
    ``file://`` store, no network: the collectives run through NCCL on
    groups of one), both equal to ``engine="pallas"`` within 1e-6 with
    fidelity > 1 - 1e-5; then bf16 against f32 by total variation
    (``BF16_TV``: sup-20's entries are ~1e-6, so a difference of entries
    says nothing at this width).  No kernel is
    launched on this path."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    run = _port("run").run_virtual_circuit
    fidelity = _port("evaluate").hellinger_fidelity
    oracle = _port("ops.statevector").simulate_circuit(circ, device=DEV)
    ref = run(virt, engine="pallas", chunk_size=CHUNK, project=False,
              device=DEV)[0].values

    def sharded(**kw):
        return run(virt, engine="sharded", device=DEV, **kw)[0]

    out = {"card": card, "reference": "engine='pallas', project=False"}
    _reset_counts()
    cold, out["cold_s"] = _timed(lambda: sharded(project=False))
    out["launches"] = _counts()
    proj, out["warm_s"], out["peak_gb"] = _peak_run(lambda: sharded())
    out["fidelity"] = fidelity(oracle, proj)
    out["max_abs_err"] = float(np.abs(cold.values - ref).max())
    out.update(_profile(lambda: sharded(project=False), cpu=False))

    with tempfile.TemporaryDirectory() as tmp:
        # a world of one on one host: NCCL bootstraps over loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            stack, coll = _collectives()
            with stack:
                grp, out["nccl_s"] = _timed(lambda: sharded(project=False))
            out["nccl_collectives"] = dict(coll)
            out["nccl_backend"] = dist.get_backend()
        finally:
            dist.destroy_process_group()
    out["nccl_max_abs_err"] = float(np.abs(grp.values - ref).max())
    b16, out["bf16_s"] = _timed(lambda: sharded(project=False,
                                                dtype=torch.bfloat16))
    diff = np.abs(np.asarray(b16.values, np.float64) - cold.values)
    out["bf16_tv"] = float(0.5 * diff.sum())
    out["bf16_max_abs_err"] = float(diff.max())
    out["bf16_rel_to_max"] = float(diff.max() / np.abs(cold.values).max())
    report["sharded_sup20"] = out
    _phase_line("main_sharded_sup20", out)
    print(f"  cold_s={out['cold_s']:.4f} fidelity={out['fidelity']!r} "
          f"nccl_s={out['nccl_s']:.4f} nccl_err={out['nccl_max_abs_err']!r} "
          f"collectives={out['nccl_collectives']} bf16_s="
          f"{out['bf16_s']:.4f} bf16_tv={out['bf16_tv']!r} bf16_max_abs="
          f"{out['bf16_max_abs_err']!r} bf16_rel_to_max="
          f"{out['bf16_rel_to_max']!r} "
          f"launches={out['launches']}", flush=True)
    for row in out["device_ms_by_kernel"][:4]:
        print(f"  device {row['ms']:.3f} ms x{row['calls']}: "
              f"{row['kernel']}", flush=True)
    if out["launches"] != _only():
        raise RuntimeError(f"sharded sup20 launched {out['launches']}")
    for key, lim in (("max_abs_err", 1e-6), ("nccl_max_abs_err", 1e-6),
                     ("bf16_tv", BF16_TV)):
        if not out[key] <= lim:
            raise RuntimeError(f"sharded sup20: {key} {out[key]!r} > {lim}")
    if not out["fidelity"] > FID_MIN:
        raise RuntimeError(f"sharded sup20: fidelity {out['fidelity']!r}")
    if not all(out["nccl_collectives"][k] > 0
               for k in ("all_reduce", "all_gather")):
        raise RuntimeError(f"no NCCL collective ran: {out['nccl_collectives']}")


def _wide_cut(nbig=WIDE_NBIG):
    """JAX tests/test_sharded_fragment.py's asymmetric hand-built cut at
    ``nbig`` data qubits: a CX chain with rz, one cz cut onto a 2-qubit
    fragment (frag0 simulates nbig + 1 qubits: the cut's deferral
    ancilla)."""
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.circuit.circuit import (  # noqa: E501
        Circuit,
        Instruction,
        Register,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_circuit import (  # noqa: E501
        VirtualCircuit,
    )
    from hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch.virt.virtual_gates import (  # noqa: E501
        VirtualGateOp,
    )

    cut = Circuit([Register("frag0", nbig), Register("frag1", 2)], nbig + 2)
    cut.h(0)
    for i in range(nbig - 1):
        cut.cx(i, i + 1)
    for q in range(nbig):
        cut.rz(0.1 * (q + 1), q)
    cut.append(Instruction("vgate", [nbig - 1, nbig],
                           op=VirtualGateOp("cz")))
    cut.cx(nbig, nbig + 1)
    for q in range(nbig + 2):
        cut.measure(q, q)
    return None, VirtualCircuit(cut)


def phase_sharded_wide26(virt, report, card):
    """A fragment past the blocked kernel's 24-qubit gate, which
    ``engine="pallas"`` refuses: ``run_fragment_sharded`` on one card
    (``fragment_mesh(max_local_qubits=24)`` gives (1, 1) on a world of
    one), its rows within 1e-5 of the batched engine's
    ``variant_engine.run_fragment``."""
    import numpy as np
    import torch

    sf = _port("ops.sharded_fragment")
    prog = virt.programs["frag0"]
    n = prog.num_sim_qubits
    try:
        _port("ops.streamed").make_streamed_knit(virt, 1, device=DEV,
                                                 pallas_variant=True)
        refused = None
    except NotImplementedError as exc:
        refused = str(exc)
    mesh = sf.fragment_mesh(n, max_local_qubits=WIDE_LOCAL, device=DEV)
    out = {"card": card, "fragment_sim_qubits": n,
           "variants": virt.vgates[0].spec.num_instantiations,
           "mesh": dict(mesh.shape), "pallas_refusal": refused,
           "reference": "variant_engine.run_fragment (batched engine)"}
    _reset_counts()
    rows, out["cold_s"], _ = _peak_run(
        lambda: sf.run_fragment_sharded(virt, "frag0", mesh).values)
    out["launches"] = _counts()
    del rows
    prof = _profile(lambda: sf.run_fragment_sharded(virt, "frag0", mesh),
                    cpu=False)
    rows, out["warm_s"], out["peak_gb"] = _peak_run(
        lambda: sf.run_fragment_sharded(virt, "frag0", mesh).values)
    out.update(prof)
    want, out["reference_s"] = _timed(
        lambda: _port("ops.variant_engine").run_fragment(
            virt, "frag0", device=DEV).values)
    out["rows_shape"] = list(rows.shape)
    out["rows_gb"] = rows.numel() * 4 / 1e9
    out["max_abs_err"] = float((rows - want).abs().max())
    out["finite"] = bool(torch.isfinite(rows).all())
    del rows, want
    torch.cuda.empty_cache()
    report["sharded_wide26"] = out
    _phase_line("sharded_wide26", out)
    print(f"  sim_qubits={n} mesh={out['mesh']} rows={out['rows_shape']} "
          f"({out['rows_gb']:.2f} GB) cold_s={out['cold_s']:.4f} "
          f"reference_s={out['reference_s']:.4f} launches={out['launches']}"
          f"\n  engine='pallas' refuses it: {refused}", flush=True)
    if n <= 24 or refused is None or "sharded" not in refused:
        raise RuntimeError(f"wide26: {n} qubits, pallas refusal {refused!r}")
    if out["mesh"] != {"dp": 1, "amp": 1} or out["launches"] != _only():
        raise RuntimeError(f"wide26: mesh {out['mesh']}, launches "
                           f"{out['launches']}")
    if not (out["finite"] and out["max_abs_err"] <= TOL):
        raise RuntimeError(f"wide26: rows differ by {out['max_abs_err']!r}")


def phase_sampled_qft16_mesh1(virt, report, card):
    """qft-16's sampled estimate (the 120000 samples and seed of
    main_qft16) with ``mesh=`` a mesh of one: distribution and stderr
    equal to ``mesh=None`` within 1e-6, kernel 3 still the route."""
    import numpy as np

    tq = _port("ops.qpd_sampling")
    mesh = _port("parallel.mesh").make_mesh(device=DEV)
    kw = dict(with_stderr=True, seed=QFT_SEED, keep_clbits=QFT_KEEP,
              method="lhs", control_variate=True, device=DEV)
    (want, want_se), _ = _timed(lambda: tq.sampled_knit(virt, QFT_SAMPLES,
                                                        **kw))
    _reset_counts()
    (est, se), out_cold = _timed(lambda: tq.sampled_knit(
        virt, QFT_SAMPLES, mesh=mesh, **kw))
    counts = _counts()
    prof = _profile(lambda: tq.sampled_knit(virt, QFT_SAMPLES, mesh=mesh,
                                            **kw), cpu=False)
    (est, se), warm, peak = _peak_run(lambda: tq.sampled_knit(
        virt, QFT_SAMPLES, mesh=mesh, **kw))
    out = {"card": card, "mesh": dict(mesh.shape), "cold_s": out_cold,
           "warm_s": warm, "peak_gb": peak, "launches": counts,
           "reference": "sampled_knit(mesh=None)",
           "max_abs_err": float(np.abs(np.asarray(est.values)
                                       - np.asarray(want.values)).max()),
           "stderr_max_abs_err": float(np.abs(se - want_se).max())}
    out.update(prof)
    report["sampled_qft16_mesh1"] = out
    _phase_line("sampled_qft16_mesh1", out)
    print(f"  mesh={out['mesh']} launches={counts} stderr_err="
          f"{out['stderr_max_abs_err']!r}", flush=True)
    if not (counts["collapse"] > 0 and counts == _only(
            collapse=counts["collapse"])):
        raise RuntimeError(f"qft16 mesh1 launched {counts}")
    if not (out["max_abs_err"] <= 1e-6 and out["stderr_max_abs_err"] <= 1e-6):
        raise RuntimeError(f"qft16 mesh1 differs: {out['max_abs_err']!r}, "
                           f"stderr {out['stderr_max_abs_err']!r}")


def phase_streamed_sup20_dp1(virt, report, card):
    """``parallel.sharded.streamed_values_dp`` on a mesh of one (the scan's
    chunk axis over dp): banks on and off, and the kernel route, each
    equal to the unsharded scan within 2e-6."""
    streamed = _port("ops.streamed")
    dp_values = _port("parallel.sharded").streamed_values_dp
    mesh = _port("parallel.mesh").make_mesh(device=DEV)
    out = {"card": card, "reference": "step_fn(xs), the whole scan",
           "cases": {}}
    for key, kw in (("banks", dict(share_prefix=True)),
                    ("flat", dict(share_prefix=False)),
                    ("kernel", dict(pallas_variant=True))):
        step, xs, meta = streamed.make_streamed_knit(virt, CHUNK, device=DEV,
                                                     **kw)
        want, whole_s = _timed(lambda: step(xs))
        _reset_counts()
        got, cold_s = _timed(lambda: dp_values(meta, xs, mesh))
        counts = _counts()
        got, warm_s, peak = _peak_run(lambda: dp_values(meta, xs, mesh))
        out["cases"][key] = {"whole_s": whole_s, "cold_s": cold_s,
                             "warm_s": warm_s, "peak_gb": peak,
                             "launches": counts, "chunks": meta["n_chunks"],
                             "max_abs_err": float((got - want).abs().max())}
    prof = _profile(lambda: dp_values(meta, xs, mesh), cpu=False)
    out.update(prof)
    out["warm_s"] = {k: c["warm_s"] for k, c in out["cases"].items()}
    out["peak_gb"] = max(c["peak_gb"] for c in out["cases"].values())
    out["max_abs_err"] = max(c["max_abs_err"] for c in out["cases"].values())
    report["streamed_sup20_dp1"] = out
    _phase_line("streamed_sup20_dp1", out)
    for key, c in out["cases"].items():
        print(f"  {key}: whole_s={c['whole_s']:.4f} cold_s={c['cold_s']:.4f}"
              f" warm_s={c['warm_s']:.4f} err={c['max_abs_err']!r} "
              f"launches={c['launches']}", flush=True)
    launches = {k: c["launches"] for k, c in out["cases"].items()}
    if launches["kernel"]["variant"] <= 0 or launches["banks"] != _only():
        raise RuntimeError(f"streamed dp1 launches: {launches}")
    if not out["max_abs_err"] <= DP_TOL:
        raise RuntimeError(f"streamed dp1 differs by {out['max_abs_err']!r}")



# ---------------------------------------------------------------------------
# 12. the variational path (ops/sweep.py, ops/hamiltonian.py, ops/optim.py)
# ---------------------------------------------------------------------------
#
# The repo's VQE configs (benchmarks/vqe_tpu.py CONFIGS): tfim20 (20 qubits,
# 2 entangling layers, partition cap 11, 5 cuts) and qaoa16 (MaxCut on the
# 16-ring, P=1, cap 9, 8 cuts), plus tfim16 (1 layer, cap 9).  The ansatz,
# Hamiltonian and cutter arguments are that script's; they are rebuilt here
# with the port (the script imports the JAX package).  No kernel lies on this
# path: plain PyTorch with autograd, as the JAX package runs it in XLA.

VQE_CONFIGS = {"tfim16": (16, 1, 9), "tfim20": (20, 2, 11),
               "qaoa16": (16, 1, 9)}
VQE_JAX_RECORD = {"tfim20": -12.536766, "qaoa16": -7.538621}  # vqe_tpu.json
VQE_ORACLE_TOL = {"tfim20": 5e-4, "qaoa16": 2e-3}  # tests/test_hamiltonian.py
VQE_STEPS = 10           # benchmarks/vqe_tpu.py's steps, lr 0.1
VQE_GRAD_TOL = 2e-5      # the card's gradient against the CPU's
VQE_MODES_TOL = 2e-5     # contract vs distribution (test_hamiltonian.py:157)
VQE_SAMPLES = 20000      # the stochastic energy's LHS budget
VQE_SAMPLED_TOL = 0.5    # tests/test_hamiltonian.py:287
SWEEP_TOL = 3e-6         # tests/test_sweep.py:72
MESH1_TOL = 1e-6
POP_TOL = 1e-5


class _Ring:
    """The n-ring as a graph object with nodes() and edges() only (the
    card's machine has no networkx), edges in networkx's cycle_graph
    order, so the circuit is benchmarks/vqe_tpu.py's."""

    def __init__(self, n):
        self.n = n

    def nodes(self):
        return list(range(self.n))

    def edges(self):
        return [(0, 1), (0, self.n - 1)] + [(i, i + 1)
                                            for i in range(1, self.n - 1)]


def _tfim_terms(n, j=1.0, h=0.7):
    terms = []
    for i in range(n - 1):
        zz = ["I"] * n
        zz[i] = zz[i + 1] = "Z"
        terms.append((-j, "".join(zz)))
    for i in range(n):
        x = ["I"] * n
        x[i] = "X"
        terms.append((-h, "".join(x)))
    return terms


def _maxcut_terms(n):
    terms = []
    for i in range(n):
        zz = ["I"] * n
        zz[i] = zz[(i + 1) % n] = "Z"
        terms.append((0.5, "".join(zz)))
    terms.append((-0.5 * n, "I" * n))
    return terms


def _vqe_config(key):
    """(build(theta, mark), terms, theta0, cutter kwargs) of a config, as
    benchmarks/vqe_tpu.run_config sets them."""
    import numpy as np

    circuit = _port("circuit.circuit")
    n, layers, cap = VQE_CONFIGS[key]
    if key.startswith("qaoa"):
        qaoa = _port("models.qaoa")

        def build(th, mark=True):
            params = ([circuit.ParamRef(0, float(th[0])),
                       circuit.ParamRef(1, float(th[1]))] if mark
                      else [float(th[0]), float(th[1])])
            return qaoa.construct_qaoa_plus(P=1, G=_Ring(n), params=params)

        terms, th0, budget = _maxcut_terms(n), np.array([2.0, 1.5]), 8
    else:
        def build(th, mark=True):
            c = circuit.Circuit(n, n)
            k = 0
            for layer in range(layers + 1):
                for q in range(n):
                    c.ry(circuit.ParamRef(k, float(th[k])) if mark
                         else float(th[k]), q)
                    k += 1
                if layer < layers:
                    for i in range(n - 1):
                        c.cx(i, i + 1)
            return c

        terms = _tfim_terms(n)
        th0 = np.linspace(0.2, 1.7, (layers + 1) * n)
        budget = 5
    kw = dict(maxNPartitions=2, maxNQubitsPerPartition=cap,
              maxNQpdCuts=budget, maxNCuts=budget,
              maxCutsPerPartitions=budget)
    return build, terms, th0, kw


def _oracle_energy(circ, terms):
    """<H> on the uncut state of ``circ`` (no measurements) from the
    port's statevector on the card: Z terms as diagonal signs, X terms as
    bit flips (benchmarks/vqe_tpu.oracle_energy), in float64."""
    import torch

    sv = _port("ops.statevector")
    n = circ.num_qubits
    state = sv.run_statevector(sv.compile_circuit(circ), device=DEV)
    psi = torch.complex(state[0].double(), state[1].double())
    idx = torch.arange(1 << n, device=psi.device)
    total = 0.0
    for coeff, pauli in terms:
        phase = torch.ones(1 << n, dtype=torch.float64, device=psi.device)
        flip = 0
        for q, ch in enumerate(pauli):
            if ch == "Z":
                phase = phase * (1.0 - 2.0 * ((idx >> (n - 1 - q)) & 1))
            elif ch == "X":
                flip ^= 1 << (n - 1 - q)
            elif ch != "I":
                raise ValueError(f"oracle takes I, X and Z, not {ch!r}")
        total += coeff * float(torch.real(
            psi.conj() @ (phase * psi[idx ^ flip])))
    return total


def _value_and_grad(energy, theta, device):
    """(energy as a float, its gradient as numpy) at ``theta``."""
    import numpy as np
    import torch

    t = torch.tensor(np.asarray(theta, np.float32), device=device,
                     requires_grad=True)
    e = energy(t)
    (g,) = torch.autograd.grad(e, t)
    return float(e.detach()), g.detach().cpu().numpy()


def _descent(energy, theta, steps):
    """``steps`` of ``theta -= 0.1 * grad`` on the card (theta never
    leaves it): the energies, each step's time, and the final theta."""
    import torch

    t = torch.as_tensor(theta, dtype=torch.float32, device=DEV)
    energies, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.requires_grad_(True)
        e = energy(t)
        (g,) = torch.autograd.grad(e, t)
        t = (t - 0.1 * g).detach()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        energies.append(float(e.detach()))
    return energies, times, t


def _vqe_main(key, report, card, steps):
    """One config's main path: build (cut solve included), the first
    energy+gradient step, ``steps`` steady steps, all on the card with
    the kernels' counts read around the whole path (this path runs none
    of them), a device-only trace of two steps and the peak memory."""
    import numpy as np
    import torch

    hmod = _port("ops.hamiltonian")
    build, terms, th0, kw = _vqe_config(key)
    _reset_counts()
    (energy, info), build_s = _timed(
        lambda: hmod.make_hamiltonian_energy(build(th0), kw, terms,
                                             device=DEV))
    (e0, g0), first_s = _timed(lambda: _value_and_grad(energy, th0, DEV))
    torch.cuda.reset_peak_memory_stats()
    energies, times, theta = _descent(energy, th0 - 0.1 * g0, steps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts = _counts()
    prof = _profile(lambda: _descent(energy, theta, 2), cpu=False)
    oracle = _oracle_energy(build(th0, mark=False), terms)
    out = {"card": card, "config": key, "n_qubits": VQE_CONFIGS[key][0],
           "n_params": info.n_params, "n_groups": info.n_groups,
           "instances_per_eval": info.instances_per_step,
           "build_s": build_s, "first_step_s": first_s,
           "steady_step_s": float(np.median(times[1:] or times)),
           "step_s": times, "steps": 1 + steps, "e_theta0": e0,
           "e_oracle_theta0": oracle, "oracle_err": abs(e0 - oracle),
           "jax_record_theta0": VQE_JAX_RECORD[key],
           "jax_record_diff": e0 - VQE_JAX_RECORD[key],
           "energies": energies, "e_final": energies[-1],
           "descended": energies[-1] < e0, "peak_gb": peak,
           "launches": counts, "theta0": th0, "grad0": g0}
    out.update(prof)
    print(f"vqe_{key}: card={card} build_s={build_s:.3f} first_step_s="
          f"{first_s:.3f} steady_step_s={out['steady_step_s']!r} "
          f"instances_per_eval={info.instances_per_step} idle_share="
          f"{out['device_idle_share']} peak_gb={peak:.4f}", flush=True)
    print(f"  e_theta0={e0!r} oracle={oracle!r} err={out['oracle_err']!r} "
          f"(jax record {VQE_JAX_RECORD[key]}: {out['jax_record_diff']!r}) "
          f"e_final={energies[-1]!r} launches={counts}", flush=True)
    if counts != _only():
        raise RuntimeError(f"vqe_{key} launched a kernel: {counts}")
    if not out["oracle_err"] <= VQE_ORACLE_TOL[key]:
        raise RuntimeError(f"vqe_{key}: e_theta0 {e0!r} is "
                           f"{out['oracle_err']!r} from the oracle")
    if not out["descended"]:
        raise RuntimeError(f"vqe_{key} did not descend: {energies}")
    return energy, out


def phase_vqe_tfim20(report, card):
    """tfim20 as benchmarks/vqe_tpu.py runs it: e_theta0 within 5e-4 of
    the oracle, 10 steps of lr 0.1 descend, the card's gradient equal to
    the CPU's within 2e-5 (the energy built anew on the CPU)."""
    energy, out = _vqe_main("tfim20", report, card, VQE_STEPS)
    build, terms, th0, kw = _vqe_config("tfim20")
    cpu_energy, _ = _port("ops.hamiltonian").make_hamiltonian_energy(
        build(th0), kw, terms, device="cpu")
    e_cpu, g_cpu = _value_and_grad(cpu_energy, th0, "cpu")
    out["cpu_energy_err"] = abs(out["e_theta0"] - e_cpu)
    out["cpu_grad_err"] = float(abs(out.pop("grad0") - g_cpu).max())
    out.pop("theta0")
    report["vqe_tfim20"] = out
    print(f"  card vs cpu: energy {out['cpu_energy_err']!r} grad "
          f"{out['cpu_grad_err']!r}", flush=True)
    if not out["cpu_grad_err"] <= VQE_GRAD_TOL:
        raise RuntimeError(f"tfim20 gradient on the card differs from the "
                           f"CPU's by {out['cpu_grad_err']!r}")
    return energy, out["e_theta0"]


def phase_vqe_qaoa16(report, card):
    """qaoa16 (the ring as a plain object): the energy at (2.0, 1.5)
    within 2e-3 of the oracle, one gradient step (and the steps after
    it) descend."""
    _energy, out = _vqe_main("qaoa16", report, card, 3)
    out.pop("theta0")
    out.pop("grad0")
    report["vqe_qaoa16"] = out


def phase_vqe_tfim16_modes(report, card):
    """tfim16 through the contraction and through the knitted
    distribution: energies and gradients within 2e-5."""
    hmod = _port("ops.hamiltonian")
    build, terms, th0, kw = _vqe_config("tfim16")
    out = {"card": card}
    got = {}
    for mode, contract in (("contract", True), ("distribution", False)):
        energy, info = hmod.make_hamiltonian_energy(build(th0), kw, terms,
                                                    contract=contract,
                                                    device=DEV)
        _value_and_grad(energy, th0, DEV)
        got[mode], secs = _timed(lambda: _value_and_grad(energy, th0, DEV))
        out[f"{mode}_s"] = secs
    out["energy_err"] = abs(got["contract"][0] - got["distribution"][0])
    out["grad_err"] = float(abs(got["contract"][1]
                                - got["distribution"][1]).max())
    out["instances_per_eval"] = info.instances_per_step
    report["vqe_tfim16_modes"] = out
    print(f"vqe_tfim16_modes: card={card} contract_s={out['contract_s']!r} "
          f"distribution_s={out['distribution_s']!r} energy_err="
          f"{out['energy_err']!r} grad_err={out['grad_err']!r}", flush=True)
    if not (out["energy_err"] <= VQE_MODES_TOL
            and out["grad_err"] <= VQE_MODES_TOL):
        raise RuntimeError(f"tfim16 routes differ: {out}")


def phase_vqe_tfim20_sampled(report, card, e_exact):
    """tfim20's stochastic energy (20000 LHS samples shared by both
    groups) within 0.5 of the exact one; its gradient finite with norm
    above 1e-3; the time of one energy+gradient."""
    import numpy as np

    hmod = _port("ops.hamiltonian")
    build, terms, th0, kw = _vqe_config("tfim20")
    (energy, info), build_s = _timed(lambda: hmod.make_hamiltonian_energy(
        build(th0), kw, terms, num_samples=VQE_SAMPLES, sample_seed=0,
        sample_method="lhs", device=DEV))
    (e, g), cold_s = _timed(lambda: _value_and_grad(energy, th0, DEV))
    (e, g), warm_s = _timed(lambda: _value_and_grad(energy, th0, DEV))
    out = {"card": card, "build_s": build_s, "cold_s": cold_s,
           "warm_s": warm_s, "energy": e, "exact": e_exact,
           "err": abs(e - e_exact), "grad_norm": float(np.linalg.norm(g)),
           "instances_per_eval": info.instances_per_step}
    report["vqe_tfim20_sampled"] = out
    print(f"vqe_tfim20_sampled: card={card} samples={VQE_SAMPLES} "
          f"instances_per_eval={info.instances_per_step} warm_s={warm_s!r}"
          f" energy={e!r} exact={e_exact!r} grad_norm="
          f"{out['grad_norm']!r}", flush=True)
    if not (out["err"] < VQE_SAMPLED_TOL and np.isfinite(g).all()
            and out["grad_norm"] > 1e-3):
        raise RuntimeError(f"tfim20 sampled: {out}")


def phase_sweep_tfim20_bind(report, card):
    """make_parameter_sweep on tfim20's ansatz in the Z basis, without
    ParamRefs: three theta sets, each cut with the template's plan,
    bound and run through one runner; values within 3e-6 of
    run_virtual_circuit(engine="pallas") on the same VirtualCircuit
    (kernel 1's knit) and fidelity to the uncut oracle > 1 - 1e-5."""
    import numpy as np

    cutter_mod = _port("cutter.cutter")
    hmod = _port("ops.hamiltonian")
    sweep = _port("ops.sweep")
    run = _port("run")
    sv = _port("ops.statevector")
    evaluate = _port("evaluate")
    virt_mod = _port("virt.virtual_circuit")
    build, _terms, th0, kw = _vqe_config("tfim20")
    rng = np.random.default_rng(0)
    thetas = [th0, th0 + rng.normal(0, 0.3, th0.size),
              rng.uniform(-np.pi, np.pi, th0.size)]
    plan = None
    runner = bind = None
    out = {"card": card, "cases": []}
    for th in thetas:
        circ = hmod.measurement_circuit(build(th, mark=False), "Z" * 20)
        cutter = cutter_mod.Cutter(circ, **kw)
        if plan is None:
            if not cutter.solve():
                raise RuntimeError("no cut plan for tfim20")
            plan = cutter.plan
        else:
            cutter.use_plan(plan)
        virt = virt_mod.VirtualCircuit(cutter.getResultCircs()[3])
        if runner is None:
            runner, bind = sweep.make_parameter_sweep(virt, device=DEV)
        args, bind_s = _timed(lambda: bind(virt))
        vals, run_s = _timed(lambda: runner(args))
        vals, warm_s = _timed(lambda: runner(args))
        want, _ = run.run_virtual_circuit(virt, project=False, device=DEV)
        vals = vals.cpu().numpy()
        got = sv.Distribution(vals, sorted(range(20)), virt.num_clbits)
        fid = evaluate.hellinger_fidelity(
            sv.simulate_circuit(circ, device=DEV), got)
        out["cases"].append({
            "bind_s": bind_s, "cold_s": run_s, "warm_s": warm_s,
            "max_abs_err": float(np.abs(vals - want.values).max()),
            "fidelity": fid})
    out["runner_served"] = len(thetas)
    out["warm_s"] = [c["warm_s"] for c in out["cases"]]
    out["max_abs_err"] = max(c["max_abs_err"] for c in out["cases"])
    out["min_fidelity"] = min(c["fidelity"] for c in out["cases"])
    report["sweep_tfim20_bind"] = out
    print(f"sweep_tfim20_bind: card={card} warm_s={out['warm_s']!r} "
          f"max_abs_err={out['max_abs_err']!r} (engine=\"pallas\") "
          f"min_fidelity={out['min_fidelity']!r}", flush=True)
    if not (out["max_abs_err"] <= SWEEP_TOL
            and out["min_fidelity"] > FID_MIN):
        raise RuntimeError(f"sweep_tfim20_bind: {out}")


def phase_optim_tfim16(report, card):
    """spsa_minimize (10 steps, 4 pairs) and nes_minimize (10 steps, pop
    8) on tfim16's energy: the batched population equals a loop of
    single energies within 1e-5, both end below the start.  Then a mesh
    of one: make_hamiltonian_energy(mesh=) and population_energy(mesh=)
    equal to the unsharded energy, gradient and energies within 1e-6."""
    import numpy as np
    import torch

    hmod = _port("ops.hamiltonian")
    optim = _port("ops.optim")
    mesh = _port("parallel.mesh").make_mesh(1, device=DEV)
    build, terms, th0, kw = _vqe_config("tfim16")
    energy, _ = hmod.make_hamiltonian_energy(build(th0), kw, terms,
                                             device=DEV)
    thetas = torch.as_tensor(
        th0 + np.random.default_rng(0).normal(0, 0.1, (8, th0.size)),
        dtype=torch.float32, device=DEV)
    with torch.no_grad():
        batched, pop_s = _timed(lambda: optim.population_energy(energy)(
            thetas))
        batched, pop_s = _timed(lambda: optim.population_energy(energy)(
            thetas))
        loop, loop_s = _timed(lambda: torch.stack([energy(t)
                                                   for t in thetas]))
        meshed = optim.population_energy(energy, mesh)(thetas)
    start = float(energy(th0))
    out = {"card": card, "start": start, "population": 8,
           "population_s": pop_s, "loop_s": loop_s,
           "population_err": float((batched - loop).abs().max()),
           "mesh1_population_err": float((meshed - batched).abs().max())}
    for name, fn, kw_opt in (
            ("spsa", optim.spsa_minimize, dict(pairs=4, a=0.2, c=0.1)),
            ("nes", optim.nes_minimize, dict(pop=8, sigma=0.15, lr=0.1))):
        res, secs = _timed(lambda: fn(energy, th0, steps=10, key=3,
                                      device=DEV, **kw_opt))
        out[name] = {"energy": res.energy, "step_s": secs / 10,
                     "evaluations": res.evaluations,
                     "history": res.history.tolist()}
    e_mesh, _ = hmod.make_hamiltonian_energy(build(th0), kw, terms,
                                             mesh=mesh)
    a, ga = _value_and_grad(energy, th0, DEV)
    b, gb = _value_and_grad(e_mesh, th0, DEV)
    out["mesh1_energy_err"] = abs(a - b)
    out["mesh1_grad_err"] = float(abs(ga - gb).max())
    report["optim_tfim16"] = out
    print(f"optim_tfim16: card={card} start={start!r} spsa="
          f"{out['spsa']['energy']!r} ({out['spsa']['step_s']!r} s/step) "
          f"nes={out['nes']['energy']!r} ({out['nes']['step_s']!r} s/step)"
          f" population_s={pop_s!r} loop_s={loop_s!r} population_err="
          f"{out['population_err']!r} mesh1: energy "
          f"{out['mesh1_energy_err']!r} grad {out['mesh1_grad_err']!r} "
          f"population {out['mesh1_population_err']!r}", flush=True)
    if not out["population_err"] <= POP_TOL:
        raise RuntimeError(f"population differs from the loop: {out}")
    if not (out["spsa"]["energy"] < start and out["nes"]["energy"] < start):
        raise RuntimeError(f"optimisers did not descend: {out}")
    if not max(out["mesh1_energy_err"], out["mesh1_grad_err"],
               out["mesh1_population_err"]) <= MESH1_TOL:
        raise RuntimeError(f"mesh of one differs: {out}")


# ---------------------------------------------------------------------------
# The cutter's front end: native solver, teleport execution, OpenQASM, zoo
# (host modules that feed the kernels above; no kernel of their own)
# ---------------------------------------------------------------------------

FRONT_FID = 1 - 1e-6       # tests/test_teleport.py, tests/test_qasm.py
SAMPLED_TELE_FID = 1 - 5e-3  # tests/test_teleport.py:164-178
RECORD_TOL = 1e-6          # a sweep row's fidelity against its record
TELE_SHOTS = 20000
# the stored plans, re-solved: (plan, genCirc name, n, depth, cap, seed)
STORED_SOLVES = [("ghz40_p2_q20", "ghz", 40, 1, 20, None),
                 ("hwe40_d2_p2_q21", "hwe", 40, 2, 21, 0),
                 ("sup25_p2_q13", "sup", 25, 1, 13, 0)]
# benchmarks/topology_teleport_sweep.py's SWEEP (that script imports JAX):
# (tag, genCirc name, n, depth, caps, maxNQpdCuts, maxNCuts), seed 7
SWEEP_SEED = 7
SWEEP = [
    ("add6_sym", "add", 6, 1, [4, 4], 5, 5),
    ("add6_hetero", "add", 6, 1, [5, 3], 5, 5),
    ("ghz8_tele_only", "ghz", 8, 1, [6, 6], 0, 2),
    ("add10_hetero", "add", 10, 1, [9, 5], 5, 5),
    ("qaoa10_sym", "reg", 10, 1, [7, 7], 5, 5),
    ("qaoa10_hetero", "reg", 10, 1, [8, 4], 5, 5),
    ("erd10", "erd", 10, 1, [7, 7], 5, 5),
]


def _solved(circ, caps, **kw):
    """A ``Cutter`` of ``circ`` over ``len(caps)`` partitions, solved by
    the port (native solver), and the seconds the solve took."""
    cutter = _port("cutter.cutter").Cutter(
        circ, maxNPartitions=len(caps), maxNQubitsPerPartition=caps, **kw)
    t0 = time.perf_counter()
    if not cutter.solve():
        raise RuntimeError(f"no cut plan for {circ.name} {caps} {kw}")
    return cutter, time.perf_counter() - t0


def _counted(fn):
    """``fn()`` with the kernels' counts set to 0 just before and read
    just after: (result, seconds, counts)."""
    _reset_counts()
    out, secs = _timed(fn)
    return out, secs, _counts()


def _front_run(label, circ, virt, card, **kw):
    """The user's path: ``run_virtual_circuit(virt, **kw)`` on the card,
    counted (cold), then warm with the peak memory, a device-only trace
    of one more run, and the fidelity against the uncut oracle."""
    run = _port("run").run_virtual_circuit
    kw = dict(kw, device=DEV)
    (dist, _), cold_s, counts = _counted(lambda: run(virt, **kw))
    (_, _), warm_s, peak = _peak_run(lambda: run(virt, **kw))
    prof = _profile(lambda: run(virt, **kw), cpu=False)
    oracle = _port("ops.statevector").simulate_circuit(circ, device=DEV)
    fid = _port("evaluate").hellinger_fidelity(oracle, dist)
    out = {"card": card, "launches": counts, "cold_s": cold_s,
           "warm_s": warm_s, "peak_gb": peak, "fidelity": fid,
           "device_idle_share": prof["device_idle_share"],
           "device_busy_ms": prof["device_busy_ms"],
           "device_ms_by_kernel": prof["device_ms_by_kernel"][:4]}
    print(f"{label}: card={card} launches={counts} cold_s={cold_s:.4f} "
          f"warm_s={warm_s!r} idle_share={out['device_idle_share']} "
          f"peak_gb={peak:.4f} fidelity={fid!r}", flush=True)
    return out


def phase_native_solver(report, card):
    """Build the native cut solver (``g++``, ``native/cutsolver.cc``,
    into ``build/``) and re-solve three stored plans from scratch with
    the port's ``Cutter``: each plan equal to the stored one."""
    import platform

    native = _port("cutter.native_solver")
    signature = _port("cutter.solver").plan_signature
    built = not native.library_path().exists()
    _, build_s = _timed(native.load)
    out = {"host": platform.node(), "built": built, "build_s": build_s,
           "library": str(native.library_path().relative_to(ROOT)),
           "solves": {}}
    print(f"native_solver: host={out['host']} built={built} "
          f"build_s={build_s:.3f} library={out['library']}", flush=True)
    report["native_solver"] = out
    for key, name, n, depth, cap, seed in STORED_SOLVES:
        circ = _port("models.zoo").genCirc(name, n, depth, seed=seed)
        cutter, secs = _solved(circ, [cap, cap], maxNQpdCuts=5, maxNCuts=5,
                               maxCutsPerPartitions=5)
        same = signature(cutter.plan) == signature(
            _port("plans").load_plan(key))
        out["solves"][key] = {"solve_s": secs, "equal_to_stored": same,
                              "metrics": vars(cutter.plan.metrics)}
        print(f"  {key}: solve_s={secs:.4f} on {out['host']} "
              f"equal_to_stored={same}", flush=True)
        if not same:
            raise RuntimeError(f"native solve of {key} differs from the "
                               "stored plan")


def phase_teleport_sweep(report, card):
    """BASELINE config #5: the seven rows of
    benchmarks/topology_teleport_sweep.py cut by the port, their S, A, L,
    cut counts and Q_p equal to topology_teleport_sweep.json, each
    executed by ``engine="pallas"`` (``teleport="execute"`` where it has
    teleport cuts) at fidelity >= 1 - 1e-6 and within 1e-6 of the
    record."""
    record = {r["config"]: r for r in json.loads(
        (ROOT / "topology_teleport_sweep.json").read_text())["rows"]}
    zoo = _port("models.zoo")
    virtual = _port("virt.virtual_circuit").VirtualCircuit
    rows, bad = {}, []
    _reset_counts()
    for tag, name, n, depth, caps, qpd, cuts in SWEEP:
        circ = zoo.genCirc(name, n, depth, seed=SWEEP_SEED)
        cutter, solve_s = _solved(circ, caps, maxNQpdCuts=qpd, maxNCuts=cuts,
                                  maxCutsPerPartitions=cuts)
        S, A, L, n_w, n_g, _, q_p, _, _ = cutter.getModelKeyResults()
        tele = sum(1 for c in cutter.plan.cuts if c.teleport)
        got = {"S": S, "A": A, "L": L, "wire": n_w, "gate": n_g,
               "teleport": tele, "Q_p": list(q_p)}
        want = {k: record[tag][k] for k in got}
        mode = "execute" if tele else "qpd"
        before = _counts()
        (dist, _), run_s = _timed(lambda: _port("run").run_virtual_circuit(
            virtual(cutter.getResultCircs()[3]), engine="pallas",
            teleport=mode, device=DEV))
        launches = {k: v - before[k] for k, v in _counts().items()}
        fid = _port("evaluate").hellinger_fidelity(
            _port("ops.statevector").simulate_circuit(circ, device=DEV),
            dist)
        rows[tag] = {**got, "teleport_mode": mode, "solve_s": solve_s,
                     "run_s": run_s, "launches": launches, "fidelity": fid,
                     "record_fidelity": record[tag]["fidelity"]}
        print(f"  {tag}: {got} teleport={mode} solve_s={solve_s:.4f} "
              f"run_s={run_s:.4f} launches={launches} fidelity={fid!r} "
              f"(record {record[tag]['fidelity']})", flush=True)
        if got != want:
            bad.append(f"{tag}: {got} != record {want}")
        if not (fid >= FRONT_FID
                and abs(fid - record[tag]["fidelity"]) <= RECORD_TOL):
            bad.append(f"{tag}: fidelity {fid!r}")
    counts = _counts()
    report["teleport_sweep"] = {"card": card, "rows": rows,
                                "launches": counts}
    print(f"teleport_sweep: card={card} launches={counts}", flush=True)
    if bad:
        raise RuntimeError("; ".join(bad))
    if not counts["variant"] > 0:
        raise RuntimeError(f"teleport_sweep launched {counts}")


def phase_bv(report, card):
    """BASELINE config #1, BV-5 (P2 Q3: one wire cut, S = 8), and bv-12
    (P2 Q7: six gate cuts, 46656 labels, the scan on kernel 1), exact
    through ``engine="pallas"`` at fidelity >= 1 - 1e-6."""
    zoo = _port("models.zoo")
    virtual = _port("virt.virtual_circuit").VirtualCircuit
    out = {}
    for label, n, cap, want in (("bv5", 5, 3, (1, 0, 8)),
                                ("bv12", 12, 7, (0, 6, 46656))):
        circ = zoo.genCirc("bv", n, 1)
        cutter, solve_s = _solved(circ, [cap, cap])
        m = cutter.plan.metrics
        got = (m.n_wire_cuts, m.n_gate_cuts, m.S)
        row = _front_run(f"bv {label}", circ,
                         virtual(cutter.getResultCircs()[3]), card,
                         engine="pallas")
        row.update(solve_s=solve_s, wire_gate_S=got)
        out[label] = row
        if got != want:
            raise RuntimeError(f"{label}: cuts and S {got} != {want}")
        if not row["fidelity"] >= FRONT_FID:
            raise RuntimeError(f"{label}: fidelity {row['fidelity']!r}")
        if row["launches"] != _only(variant=row["launches"]["variant"],
                                    prefix=row["launches"]["prefix"]) \
                or not row["launches"]["variant"] > 0:
            raise RuntimeError(f"{label}: launched {row['launches']}")
    report["bv"] = out


def phase_teleport_ghz20(report, card):
    """ghz-20, P2 Q11, teleports only (``maxNQpdCuts=0, maxNCuts=2``):
    ``teleport="execute"`` merges both fragments into one 22-qubit
    fragment with no vgate; exact at fidelity >= 1 - 1e-6."""
    circ = _port("models.zoo").genCirc("ghz", 20, 1)
    cutter, solve_s = _solved(circ, [11, 11], maxNQpdCuts=0, maxNCuts=2)
    cut = cutter.getResultCircs()[3]
    virt = _port("virt.virtual_circuit").VirtualCircuit
    expanded = virt(_port("virt.teleport").expand_teleport_cuts(cut))
    shape = [(f.name, expanded.programs[f.name].num_sim_qubits)
             for f in expanded.fragments]
    row = _front_run("teleport_ghz20", circ, virt(cut), card,
                     engine="pallas", teleport="execute")
    row.update(solve_s=solve_s, fragments=shape,
               vgates=len(expanded.vgates))
    report["teleport_ghz20"] = row
    print(f"  fragments={shape} vgates={len(expanded.vgates)}", flush=True)
    if shape != [("telegroup0", 22)] or expanded.vgates:
        raise RuntimeError(f"teleport_ghz20: expanded into {shape}")
    if not row["fidelity"] >= FRONT_FID:
        raise RuntimeError(f"teleport_ghz20: fidelity {row['fidelity']!r}")
    if not sum(row["launches"].values()) > 0:
        raise RuntimeError("teleport_ghz20 launched no kernel")


def phase_teleport_ghz24_p3(report, card):
    """ghz-24, P3 Q9, one teleport and one QPD gate cut
    (``maxNQpdCuts=1, maxNCuts=2``): 26 qubits once expanded, 12
    instantiations; exact through ``engine="pallas"`` (>= 1 - 1e-6) and
    through the sampled engine at tests/test_teleport.py's settings
    (20000 shots, lhs, control variate: >= 1 - 5e-3)."""
    circ = _port("models.zoo").genCirc("ghz", 24, 1)
    cutter, solve_s = _solved(circ, [9, 9, 9], maxNQpdCuts=1, maxNCuts=2)
    cut = cutter.getResultCircs()[3]
    virt = _port("virt.virtual_circuit").VirtualCircuit
    expanded = virt(_port("virt.teleport").expand_teleport_cuts(cut))
    shape = [(f.name, expanded.programs[f.name].num_sim_qubits)
             for f in expanded.fragments]
    out = {"solve_s": solve_s, "fragments": shape,
           "qubits": expanded._circuit.num_qubits,
           "instantiations": expanded.total_instantiations()}
    print(f"teleport_ghz24_p3: fragments={shape} qubits={out['qubits']} "
          f"instantiations={out['instantiations']}", flush=True)
    if (out["qubits"], out["instantiations"]) != (26, 12):
        raise RuntimeError(f"teleport_ghz24_p3: expanded into {out}")
    out["exact"] = _front_run("  exact", circ, virt(cut), card,
                              engine="pallas", teleport="execute")
    out["sampled"] = _front_run(
        "  sampled", circ, virt(cut), card, engine="sampled",
        teleport="execute", shots=TELE_SHOTS, sample_method="lhs",
        sample_cv=True)
    report["teleport_ghz24_p3"] = out
    if not out["exact"]["fidelity"] >= FRONT_FID:
        raise RuntimeError(f"ghz24_p3 exact: {out['exact']['fidelity']!r}")
    if not out["sampled"]["fidelity"] >= SAMPLED_TELE_FID:
        raise RuntimeError(
            f"ghz24_p3 sampled: {out['sampled']['fidelity']!r}")
    for leg in ("exact", "sampled"):
        if not sum(out[leg]["launches"].values()) > 0:
            raise RuntimeError(f"ghz24_p3 {leg} launched no kernel")


def phase_qasm(circ, virt, report, card):
    """sup-20 through ``to_qasm`` and back: the same instructions, the
    same plan from the same ``Cutter`` settings, and an
    ``engine="pallas"`` distribution equal to the original's bit for bit
    (chunk 504)."""
    import numpy as np

    circuit = _port("circuit.circuit").Circuit
    to_ins = _port("convert").circuit_to_instructions
    text, to_s = _timed(circ.to_qasm)
    back, from_s = _timed(lambda: circuit.from_qasm(text))
    want, got = to_ins(circ), to_ins(back)
    same_ins = (got[:2] == want[:2] and got[3] == want[3]
                and got[2]["qregs"] == want[2]["qregs"]
                and got[2]["cregs"] == want[2]["cregs"])
    signature = _port("cutter.solver").plan_signature
    kw = dict(maxNQpdCuts=5, maxNCuts=5, maxCutsPerPartitions=5)
    cutter, _ = _solved(back, [10, 10], **kw)
    same_plan = signature(cutter.plan) == signature(
        _solved(circ, [10, 10], **kw)[0].plan)
    run = _port("run").run_virtual_circuit
    (dist, _), _, counts = _counted(lambda: run(
        _port("virt.virtual_circuit").VirtualCircuit(
            cutter.getResultCircs()[3]),
        engine="pallas", chunk_size=CHUNK, device=DEV))
    orig, _ = run(virt, engine="pallas", chunk_size=CHUNK, device=DEV)
    equal = (dist.bit_positions == orig.bit_positions
             and np.array_equal(dist.values, orig.values))
    report["qasm"] = {"card": card, "chars": len(text), "to_qasm_s": to_s,
                      "from_qasm_s": from_s, "same_instructions": same_ins,
                      "same_plan": same_plan, "bit_equal": equal,
                      "launches": counts}
    print(f"qasm: card={card} chars={len(text)} to_qasm_s={to_s:.4f} "
          f"from_qasm_s={from_s:.4f} same_instructions={same_ins} "
          f"same_plan={same_plan} bit_equal={equal} launches={counts}",
          flush=True)
    if not (same_ins and same_plan and equal):
        raise RuntimeError("qasm round trip differs")
    if counts != _only(variant=counts["variant"],
                       prefix=counts["prefix"]) or not counts["variant"]:
        raise RuntimeError(f"qasm: launched {counts}")

# ---------------------------------------------------------------------------
# The last modules (no kernel of their own): the lightcone oracle and
# BASELINE config #4, the compiler, the sparse knit, the tracer, the
# roofline, the lane engine and the host tools
# ---------------------------------------------------------------------------

SYC_D1_KEEP = list(range(8))
SYC_D3_KEEP = [0, 1, 2, 3]
SPARSE_SHOTS = 20000
SPARSE_FID = 0.99
COMPILE_BUDGET = 5
# standard_pipeline under random.seed(0) (ghz-24 takes the KL bisection,
# which draws from it): genCirc args, size, fragment sim widths and
# vgates as the JAX package gives them (tests/test_torch_compiler.py)
COMPILES = {"sup20": (("sup", 20, 1, 0), 10, [15, 15], 5),
            "ghz24": (("ghz", 24, 1, None), 12, [4, 6, 5, 7, 6, 6], 5)}
PROFILE_DIR = ROOT / "profiles" / "tracer"


def _syc32(label, depth, cap, keep, card, stored_plan=None):
    """genCirc("syc", 32, depth, seed=0) cut at P2 Q``cap`` (solved, or a
    stored plan), its marginal on ``keep`` through
    run_virtual_circuit(engine="pallas", keep_clbits=...) counted (cold),
    warm with the peak memory and a device-only trace, held to
    lightcone_marginal on the card.  Kernel 1's plans built again as the
    path builds them: each shared prefix, made on the card by the blocked
    kernel, held to its plain version on the CPU, and the prefix
    launches alone timed against the plain version on the card."""
    import torch

    bk = _port("ops.blocked_kernel")
    vk = _port("ops.variant_kernel")
    lc = _port("circuit.lightcone")
    run = _port("run").run_virtual_circuit
    (circ, virt), cut_s = _timed(lambda: _cut(
        "syc", 32, cap, 0, depth=depth, stored_plan=stored_plan))
    kw = dict(engine="pallas", keep_clbits=keep, device=DEV)
    (marg, _), cold_s, counts = _counted(lambda: run(virt, **kw))
    dps, _, plan_counts = _counted(lambda: [vk.make_folded_chunk_kernel(
        virt, r.name, CHUNK, keep_clbits=keep, device=DEV)[0].plan
        for r in virt.fragments])
    prefix_err = max(_prefix_err(dp) for dp in dps)
    chains = [bk.BlockedDevicePlan(bk.plan_prefix(dp.plan.prefix_ops,
                                                  dp.plan.n), DEV)
              for dp in dps]
    prefix_ms = _time_ms(lambda: [bk.prefix_state(c) for c in chains],
                         reps=5)
    prefix_plain_ms = _time_ms(
        lambda: [bk.plain_prefix_state(c) for c in chains], reps=2, warm=1)
    # a segment reads and writes the [2, 2^n] float32 state once
    prefix_bound = _bound({"bytes": sum(16 * c.plan.n_prefix << c.plan.n
                                        for c in chains), "flops": 0})
    del dps, chains
    torch.cuda.synchronize()
    (again, _), warm_s, peak = _peak_run(lambda: run(virt, **kw))
    prof = _profile(lambda: run(virt, **kw), cpu=False)
    sub, cmap = lc.lightcone_circuit(circ, set(keep))
    oracle, oracle_s = _timed(lambda: lc.lightcone_marginal(
        circ, set(keep), precomputed=(sub, cmap), device=DEV))
    err = float(abs(marg.values - oracle.values).max())
    labels = 1
    for vg in virt.vgates:
        labels *= vg.spec.num_instantiations
    out = {"card": card, "cut_s": cut_s, "labels": labels,
           "vgates": len(virt.vgates),
           "fragment_sim_qubits": [virt.programs[r.name].num_sim_qubits
                                   for r in virt.fragments],
           "keep": keep, "launches": counts, "cold_s": cold_s,
           "plan_launches": plan_counts, "prefix_max_abs_err": prefix_err,
           "prefix_ms": prefix_ms, "prefix_plain_ms": prefix_plain_ms,
           "prefix_bound": prefix_bound,
           "warm_s": warm_s, "peak_gb": peak,
           "device_idle_share": prof["device_idle_share"],
           "device_busy_ms": prof["device_busy_ms"],
           "device_ms_by_kernel": prof["device_ms_by_kernel"][:4],
           "lightcone_qubits": sub.num_qubits, "oracle_s": oracle_s,
           "max_abs_err": err,
           "rerun_equal": bool((again.values == marg.values).all())}
    print(f"syc32 {label}: card={card} labels={labels} fragment_sim_qubits="
          f"{out['fragment_sim_qubits']} launches={counts} cold_s="
          f"{cold_s:.4f} warm_s={warm_s!r} idle_share="
          f"{out['device_idle_share']} peak_gb={peak:.4f} lightcone_qubits="
          f"{sub.num_qubits} oracle_s={oracle_s:.4f} max_abs_err={err:.3e}"
          f"\n  kernel 1's plans again: launches={plan_counts} "
          f"prefix_max_abs_err={prefix_err:.3e} prefix launches alone "
          f"ms={prefix_ms:.4f} plain_ms={prefix_plain_ms:.4f} bound_ms="
          f"{prefix_bound[0]:.6f}", flush=True)
    if marg.bit_positions != oracle.bit_positions:
        raise RuntimeError(f"syc32 {label}: positions {marg.bit_positions}")
    if counts != _only(variant=counts["variant"],
                       prefix=counts["prefix"]) or not counts["variant"]:
        raise RuntimeError(f"syc32 {label}: launched {counts}")
    if not (plan_counts["prefix"] > 0
            and plan_counts == _only(prefix=plan_counts["prefix"])
            and counts["prefix"] == plan_counts["prefix"]):
        raise RuntimeError(f"syc32 {label}: the plans' prefixes launched "
                           f"{plan_counts}, the path's {counts}")
    if not prefix_err <= TOL:
        raise RuntimeError(f"syc32 {label}: prefix vs plain "
                           f"{prefix_err:.3e} > {TOL}")
    if not err <= TOL:
        raise RuntimeError(f"syc32 {label}: {err:.3e} from the lightcone "
                           f"oracle > {TOL}")
    return out


def phase_syc32_lightcone(report, card):
    """BASELINE config #4 (sycamore-32) at full width: depth 1 (P2 Q20, no
    cut: fragments of 18 and 14 qubits) on an 8-clbit marginal, depth 3
    (the stored plan, 4 gate cuts, two 20-qubit fragments: kernel 1's
    global-memory path) on a 4-clbit marginal, each within 1e-5 of the
    lightcone oracle; d3's kernel-1 prefixes, built by the blocked
    kernel, are its kernels-line row ``blocked_rows/variant_prefix``."""
    out = report["syc32_lightcone"] = {
        "d1": _syc32("d1", 1, 20, SYC_D1_KEEP, card)}
    d3 = out["d3"] = _syc32("d3", 3, 17, SYC_D3_KEEP, card,
                            stored_plan="syc32_d3_p2_q17")
    report.setdefault("kernels", []).append({
        "name": "blocked_rows/variant_prefix",
        "route": "cuda",
        "source": f"{PKG}/csrc/blocked_kernel.cu",
        "replaces": TPU_BLOCKED,
        "launches": d3["launches"]["prefix"],
        "max_abs_err": d3["prefix_max_abs_err"],
        "ms": d3["prefix_ms"],
        "plain_ms": d3["prefix_plain_ms"],
        "bound_ms": d3["prefix_bound"][0],
        "bound_by": d3["prefix_bound"][1],
        "library_ms": None,
        "on_main_path": True,
        "fragment_sim_qubits": d3["fragment_sim_qubits"],
    })


def phase_compiler(report, card):
    """compile_circuit(standard_pipeline(q), circuit, 5) for sup-20 and
    ghz-24 (random.seed(0)), each run through engine="pallas" against the
    uncut oracle; fragment widths and vgates as the JAX package's."""
    import random

    comp = _port("compiler.compiler")
    zoo = _port("models.zoo")
    out = {}
    for key, ((kind, n, depth, seed), size, widths, vgates) in \
            COMPILES.items():
        circ = zoo.genCirc(kind, n, depth, seed=seed)
        random.seed(0)
        t0 = time.perf_counter()
        virt, ledger = comp.compile_circuit(comp.standard_pipeline(size),
                                            circ, COMPILE_BUDGET)
        compile_s = time.perf_counter() - t0
        row = _front_run(f"compiler {key}", circ, virt, card,
                         engine="pallas")
        got = [virt.programs[r.name].num_sim_qubits for r in virt.fragments]
        row.update(compile_s=compile_s, fragment_sim_qubits=got,
                   vgates=len(virt.vgates), stages=[
                       {"pass": r.pass_name, "budget_before": r.budget_before,
                        "vgates_added": r.vgates_added,
                        "host_s": r.seconds} for r in ledger.records])
        out[key] = row
        print(f"compiler {key}: compile_s={compile_s:.4f} widths={got} "
              f"vgates={len(virt.vgates)} stages={row['stages']}",
              flush=True)
        if got != widths or len(virt.vgates) != vgates:
            raise RuntimeError(f"compiler {key}: {got} / {len(virt.vgates)}"
                               f" vgates, expected {widths} / {vgates}")
        if row["launches"] != _only(variant=row["launches"]["variant"],
                                    prefix=row["launches"]["prefix"]) \
                or not row["launches"]["variant"]:
            raise RuntimeError(f"compiler {key}: launched {row['launches']}")
        if not row["fidelity"] > FID_MIN:
            raise RuntimeError(f"compiler {key}: fidelity {row['fidelity']!r}")
    report["compiler"] = out


def _sparse_rows_err(virt, chunk_size=256):
    """Kernel 2's full rows against the plain version at the launch shapes
    of sampled_sparse_fragment_rows (its default chunk_size): each
    fragment's first and last chunk, labelled as that function labels
    them.  Returns (max abs err, [(fragment, chunk, chunks)])."""
    import torch

    ve = _port("ops.variant_engine")
    vk = _port("ops.variant_kernel")
    specs = [vg.spec for vg in virt.vgates]
    err, shapes = 0.0, []
    for reg in virt.fragments:
        prog = virt.programs[reg.name]
        if not prog.slots:
            continue
        strides, n_inst, flat = ve.label_strides(specs, prog.touching)
        chunk = min(chunk_size, flat, ve.chunk_cap(prog.num_sim_qubits))
        n_chunks = -(-flat // chunk)
        vidx = torch.as_tensor(ve.variant_index_table(
            prog.touching, strides, n_inst, n_chunks * chunk,
            clamp_to=flat), dtype=torch.int64, device=DEV)
        rows_fn = vk.make_chunk_kernel(virt, reg.name, chunk, device=DEV)[0]
        dp, ones = rows_fn.plan, rows_fn.weigh
        cols = torch.as_tensor(list(prog.touching), dtype=torch.int64,
                               device=DEV)
        for i in sorted({0, n_chunks - 1}):
            lab = torch.zeros((chunk, len(specs)), dtype=torch.int64,
                              device=DEV)
            lab[:, cols] = vidx[i * chunk:(i + 1) * chunk]
            got = vk.label_rows(dp, lab, ones)
            want = vk.plain_variant_rows(dp, dp.gather_entries(lab),
                                         ones(lab))
            err = max(err, (got - want).abs().max().item())
        shapes.append((reg.name, chunk, n_chunks))
    return err, shapes


def phase_sparse_knit(circ, virt, report, card):
    """ghz-24 (P2 Q12): sampled_sparse_fragment_rows at 20000 shots a row
    (seed 11 + i, kernel 2's full rows), then sparse_knit(rows=) and the
    projection, against the analytic GHZ distribution; kernel 2's rows
    against the plain version at this path's chunks."""
    sk = _port("virt.sparse_knit")
    fidelity = _port("evaluate").hellinger_fidelity

    def rows():
        return {reg.name: sk.sampled_sparse_fragment_rows(
            virt, reg.name, shots=SPARSE_SHOTS, seed=11 + i, device=DEV)
            for i, reg in enumerate(virt.fragments)}

    got, cold_s, counts = _counted(rows)
    _, rows_s = _timed(rows)
    q, knit_s = _timed(lambda: sk.sparse_knit(virt, rows=got)
                       .nearest_probability_distribution())
    ones = sum(1 << c for ins in circ.instructions if ins.name == "measure"
               for c in ins.clbits)
    fid = fidelity(q.to_dict(), {0: 0.5, ones: 0.5})
    rows_err, shapes = _sparse_rows_err(virt)
    out = {"card": card, "shots": SPARSE_SHOTS, "launches": counts,
           "rows_cold_s": cold_s, "rows_s": rows_s, "knit_s": knit_s,
           "keys": len(q), "fidelity": fid,
           "full_rows_max_abs_err_at_path_chunks": rows_err,
           "chunks": shapes}
    report["sparse_knit"] = out
    print(f"sparse_knit ghz24: card={card} launches={counts} rows_cold_s="
          f"{cold_s:.4f} rows_s={rows_s:.4f} knit_s={knit_s:.4f} keys="
          f"{len(q)} fidelity={fid!r} full rows vs plain at (fragment, "
          f"chunk, chunks) {shapes}: {rows_err:.3e}", flush=True)
    if counts != _only(variant=counts["variant"],
                       prefix=counts["prefix"]) or not counts["variant"]:
        raise RuntimeError(f"sparse_knit: launched {counts}")
    if not rows_err <= TOL:
        raise RuntimeError(f"sparse_knit: full rows vs plain {rows_err:.3e}"
                           f" > {TOL}")
    if not fid > SPARSE_FID:
        raise RuntimeError(f"sparse_knit: fidelity {fid!r} <= {SPARSE_FID}")


def phase_tracer(circ, virt, report, card):
    """sup-20 under engine="pallas" and "xla" with a Tracer: the JAX
    package's phase names, the traced result equal to the untraced one
    bit for bit, warm walls side by side; on "xla" a Tracer with a
    profile_dir writes its torch.profiler trace."""
    prof = _port("utils.profiling")
    run = _port("run").run_virtual_circuit
    out = {"card": card}
    for engine, names in (("pallas", ["stream_sim_knit"]),
                          ("xla", ["simulate", "knit", "project"])):
        kw = dict(engine=engine, chunk_size=CHUNK, device=DEV)
        run(virt, **kw)
        (plain, _), untraced_s = _timed(lambda: run(virt, **kw))
        tracer = prof.Tracer()
        (traced, _), traced_s = _timed(lambda: run(virt, tracer=tracer,
                                                   **kw))
        row = {"untraced_s": untraced_s, "traced_s": traced_s,
               "phases": tracer.report()["phases"]}
        if [p.name for p in tracer.phases] != names:
            raise RuntimeError(f"tracer {engine}: phases {tracer.phases}")
        if not (plain.values == traced.values).all():
            raise RuntimeError(f"tracer {engine}: traced result differs")
        if engine == "xla":
            pt = prof.Tracer(profile_dir=str(PROFILE_DIR))
            _, row["profiled_s"] = _timed(lambda: run(virt, tracer=pt,
                                                      **kw))
            trace = pathlib.Path(pt.traces[0])
            row["trace_mb"] = trace.stat().st_size / 1e6
            row["trace"] = str(trace.relative_to(ROOT))
        out[engine] = row
        print(f"tracer {engine}: card={card} untraced_s={untraced_s:.4f} "
              f"traced_s={traced_s:.4f} phases="
              f"{[(p['name'], p['seconds']) for p in row['phases']]}"
              + (f" profiled_s={row['profiled_s']:.4f} trace_mb="
                 f"{row['trace_mb']:.2f}" if engine == "xla" else ""),
              flush=True)
    report["tracer"] = out


def phase_roofline(report, cuts):
    """The analytic model (ops/roofline.py, the H100's peaks) of sup-20,
    sup-25 and hwe-40 beside their measured warm times from the phases
    above; kernel 1's sup-20 chunk: the model's bytes beside
    variant_kernel.work_counts."""
    roof = _port("ops.roofline")
    streamed = _port("ops.streamed")
    out = {}
    sup25 = _cut("sup", 25, 13, 0, stored_plan="sup25_p2_q13")[1]
    hwe40 = cuts["hwe40"][1]
    cases = [
        ("sup20", cuts["sup20"][1], CHUNK, None,
         {"pallas_warm_s": report.get("sup20", {}).get("warm_wall_s")}),
        ("sup25", sup25, streamed.auto_chunk(sup25, SUP25_CHUNK), None,
         {"pallas_s": report.get("sup25_streamed", {}).get("pallas_s"),
          "streamed_warm_s": report.get("sup25_streamed", {}).get(
              "warm_s")}),
        ("hwe40", hwe40, streamed.auto_chunk(hwe40, HWE_CHUNK),
         sorted(c for cs in _written_data_clbits(hwe40) for c in cs[:10]),
         {"pallas_warm_scan_s": report.get("hwe40", {}).get(
             "warm_scan_s")}),
    ]
    for key, virt, chunk, keep, measured in cases:
        t0 = time.perf_counter()
        model = roof.streamed_step_model(virt, chunk=chunk, keep_clbits=keep)
        model_s = time.perf_counter() - t0
        row = {"chunk": chunk, "global_labels": model.global_labels,
               "n_chunks": model.n_chunks,
               "total_bytes": model.total_bytes,
               "total_flops": model.total_flops,
               "knit_bytes": model.knit_bytes,
               "bound_s": model.seconds(roof.H100_HBM_BYTES_PER_S),
               "fragments": [dict(name=f.name, sim_qubits=f.sim_qubits,
                                  prefix_width=f.prefix_width,
                                  variants=f.num_variants,
                                  bytes_per_variant=f.bytes_per_variant)
                             for f in model.fragments],
               "measured": measured, "model_host_s": model_s}
        out[key] = row
        print(f"roofline {key}: chunk={chunk} labels={model.global_labels} "
              f"bytes={model.total_bytes} bound_s={row['bound_s']:.6f} "
              f"(at {roof.H100_HBM_BYTES_PER_S:.3g} B/s) measured={measured}"
              f" model_host_s={model_s:.3f}", flush=True)
    virt = cuts["sup20"][1]
    per_label = sum(roof.fragment_cost(virt, r.name).bytes_per_variant
                    for r in virt.fragments)
    work = _kernel_row(report, "variant_rows/folded_staged")["work"]
    out["kernel1_sup20_chunk"] = {
        "labels": CHUNK, "model_bytes": per_label * CHUNK,
        "work_counts_bytes": work["bytes"],
        "work_counts_pass_bytes": work["pass_bytes"]}
    print(f"roofline kernel 1, one {CHUNK}-label sup-20 chunk: model "
          f"{per_label * CHUNK} B (every pass through memory) beside "
          f"work_counts {work['bytes']} B (inputs and rows once) and "
          f"{work['pass_bytes']} B of the kernel's state passes", flush=True)
    report["roofline"] = out


def phase_lane_engine(virt, report):
    """sup-20 frag0's first 504-label chunk through the lane engine (chunk
    axis trailing) against make_sim_fn's rows of the same slot tables,
    both timed warm."""
    import torch

    ve = _port("ops.variant_engine")
    lane = _port("ops.lane_engine")
    name = virt.fragments[0].name
    sim_fn, all_mats, _, _ = ve.make_sim_fn(virt, name)
    mats = [tuple(torch.as_tensor(m[:CHUNK], device=DEV) for m in tabs)
            for tabs in all_mats]
    sim_chunk, _, _ = lane.make_lane_sim(virt, name, device=DEV)
    got, want = sim_chunk(mats), sim_fn(mats)
    err = (got - want.T).abs().max().item()
    lane_ms = _time_ms(lambda: sim_chunk(mats), reps=5, warm=1)
    rows_ms = _time_ms(lambda: sim_fn(mats), reps=5, warm=1)
    out = {"fragment": name, "labels": CHUNK,
           "sim_qubits": virt.programs[name].num_sim_qubits,
           "max_abs_err": err, "lane_ms": lane_ms, "make_sim_fn_ms": rows_ms}
    report["lane_engine"] = out
    print(f"lane_engine sup20/{name}: {CHUNK} labels max_abs_err={err:.3e} "
          f"lane_ms={lane_ms:.3f} make_sim_fn_ms={rows_ms:.3f}", flush=True)
    if not err <= TOL:
        raise RuntimeError(f"lane_engine: {err:.3e} > {TOL}")


def phase_host_tools(circ, virt, report, card):
    """The host tools: transpile_to_basis / count_cnots of sup-20 and of
    one circuit a fragment (the CNOT benchmark's rule), the transpiled
    sup-20 cut and run on kernel 1 against the untranspiled oracle;
    circuit_n_tangle(ghz-24) = 1; the benchmark CLI's flow
    (PipelineConfig JSON -> make_cutter -> run -> make_run_dir /
    save_circuit / save_metrics) into benchmark_results/."""
    tr = _port("circuit.transpile")
    cutter_mod = _port("cutter.cutter")
    config = _port("utils.config")
    art = _port("utils.artifacts")
    vc = _port("virt.virtual_circuit")
    run = _port("run").run_virtual_circuit
    t0 = time.perf_counter()
    tcirc = tr.transpile_to_basis(circ)
    transpile_s = time.perf_counter() - t0
    frag_cnots = []
    for variants in cutter_mod.generate_instantiation_circuits(virt):
        frag_cnots.append(tr.count_cnots(tr.transpile_to_basis(variants[0])))
    cutter, solve_s = _solved(tcirc, [10, 10], maxNQpdCuts=5, maxNCuts=5,
                              maxCutsPerPartitions=5)
    row = _front_run("host_tools transpiled sup20", circ,
                     vc.VirtualCircuit(cutter.getResultCircs()[3]), card,
                     engine="pallas")
    ghz = _port("models.zoo").genCirc("ghz", 24, 1)
    tau, tangle_s = _timed(lambda: _port(
        "utils.entanglement").circuit_n_tangle(ghz, device=DEV))
    cfg = config.PipelineConfig.from_json(config.PipelineConfig(
        config.CutterConfig(max_n_qubits_per_partition=10),
        config.ExecutionConfig(engine="pallas", chunk_size=CHUNK)).to_json())
    cli = config.make_cutter(circ, cfg.cutter)
    if not cli.solve():
        raise RuntimeError("host_tools: the config's cutter found no plan")
    cut = cli.getResultCircs()[3]
    dist, _ = run(vc.VirtualCircuit(cut), engine=cfg.execution.engine,
                  chunk_size=cfg.execution.chunk_size, device=DEV)
    fid = _port("evaluate").hellinger_fidelity(
        _port("ops.statevector").simulate_circuit(circ, device=DEV), dist)
    run_dir = art.make_run_dir(str(ROOT / cfg.results_dir), "sup_20_1_2_10")
    art.save_circuit(cut, run_dir, "cut")
    art.save_metrics(run_dir, {"fidelity": fid, "config": cfg})
    written = sorted(p.name for p in run_dir.iterdir())
    out = {"card": card, "cnots": tr.count_cnots(tcirc),
           "transpile_s": transpile_s, "fragment_cnots": frag_cnots,
           "transpiled_solve_s": solve_s, "transpiled": row,
           "ghz24_tangle": tau, "tangle_s": tangle_s, "cli_fidelity": fid,
           "run_dir": str(run_dir.relative_to(ROOT)), "written": written}
    report["host_tools"] = out
    print(f"host_tools: sup20 cnots={out['cnots']} transpile_s="
          f"{transpile_s:.4f} fragment_cnots={frag_cnots} transpiled "
          f"fidelity={row['fidelity']!r} ghz24 tangle={tau!r} tangle_s="
          f"{tangle_s:.4f} cli fidelity={fid!r} run_dir={out['run_dir']} "
          f"{written}", flush=True)
    if not row["fidelity"] > FID_MIN or not fid > FID_MIN:
        raise RuntimeError(f"host_tools: fidelity {row['fidelity']!r}, "
                           f"{fid!r}")
    if not abs(tau - 1.0) <= TOL:
        raise RuntimeError(f"host_tools: ghz-24 tangle {tau!r}")
    if written != ["cut.txt", "instantiations", "metrics.json"]:
        raise RuntimeError(f"host_tools: run dir holds {written}")


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
        """Run one phase; its result, or None when it failed."""
        t0 = time.perf_counter()
        out = None
        try:
            out = fn(*args)
        except Exception as exc:  # a failed phase fails the run
            import traceback

            traceback.print_exc()
            failed.append(f"{name}: {exc}")
        report.setdefault("phase_s", {})[name] = time.perf_counter() - t0
        return out

    def build():
        libs = [_port("ops.variant_kernel").LIBRARY,
                _port("ops.blocked_kernel").LIBRARY,
                _port("ops.collapse_kernel").LIBRARY,
                _port("ops.sv_kernel").LIBRARY]
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
    _count_prefixes()
    # the cut solver first: its build is timed here, before any cut
    phase("native_solver", phase_native_solver, report, card)
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
        phase("main_sharded_sup20", phase_main_sharded_sup20, circ, virt,
              report, card)
        phase("qasm", phase_qasm, circ, virt, report, card)
    if cut("wide26", build=_wide_cut):
        phase("sharded_wide26", phase_sharded_wide26, cuts["wide26"][1],
              report, card)
        del cuts["wide26"]
    if cut("qft16", build=_cut_qft16):
        circ, virt = cuts["qft16"]
        modes = {"rows": {}, "marginal": {"keep_clbits": QFT_KEEP},
                 "z": {"z_sets": QFT_Z_SETS}}
        phase("collapse_qft16", lambda: phase_collapse(
            "qft16", virt, _sampled_labels(virt, QFT_SAMPLES, QFT_SEED)[1],
            modes, report))
        phase("main_qft16", phase_main_qft16, circ, virt, report)
        phase("sampled_qft16_mesh1", phase_sampled_qft16_mesh1, virt,
              report, card)
        plain = phase("main_qft16_plain", phase_main_qft16_plain, circ,
                      virt, report)
        if plain is not None:
            phase("sampled_qft16_bf16", phase_sampled_qft16_bf16, virt,
                  report, plain)
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
        # the widest window: one 128 KB tile a CTA
        phase("blocked_hwe40_w14", phase_blocked, "hwe40_w14", virt, 14,
              blocks, report, False)
        phase("main_hwe40", phase_wide, "hwe40", virt, report, False,
              "blocked_rows/hwe40")
        phase("sampled_hwe40", phase_sampled_hwe40, "hwe40", virt, report)
    if cut("ghz40", "ghz", 40, 20, None, stored_plan="ghz40_p2_q20"):
        phase("main_ghz40", phase_wide, "ghz40", cuts["ghz40"][1], report,
              True)
    if cut("hwe40_dense", "hwe", 40, 21, 0, depth=2,
           stored_plan="hwe40_d2_p2_q21", angles=1):
        # the same cut with dense rotations: every amplitude in play
        _, virt = cuts["hwe40_dense"]
        chunk = _port("ops.streamed").auto_chunk(virt, HWE_CHUNK)
        phase("blocked_hwe40_dense", phase_blocked, "hwe40_dense", virt,
              _port("ops.blocked_kernel").DEFAULT_WINDOW,
              _label_blocks(virt, chunk, first_only=True), report, False)
        phase("main_hwe40_dense", phase_dense_wide, "hwe40_dense", virt,
              report, "blocked_rows/hwe40_dense")
        phase("sampled_hwe40_dense", phase_sampled_hwe40, "hwe40_dense",
              virt, report)
    if cut("ghz34", "ghz", 34, 17, None):
        # the variant kernel's global-memory path: two 18-qubit fragments
        _, virt = cuts["ghz34"]
        phase("kernel_ghz34", phase_variant_witness, "ghz34_folded_staged",
              virt, report)
        phase("main_ghz34", phase_wide, "ghz34", virt, report, True,
              "variant_rows/ghz34_folded_staged", "variant")
    if "sup20" in cuts:
        phase("streamed_sup20", phase_streamed_sup20, *cuts["sup20"], report)
        phase("streamed_sup20_dp1", phase_streamed_sup20_dp1,
              cuts["sup20"][1], report, card)
        phase("noisy_rows_sup20", phase_noisy_rows_sup20, cuts["sup20"][1],
              report)
        streamed = phase("main_noisy_sup20", phase_main_noisy_sup20,
                         *cuts["sup20"], report)
        if streamed is not None:
            phase("main_noisy_sup20_sampled", phase_main_noisy_sup20_sampled,
                  *cuts["sup20"], report, streamed)
        del streamed
    if "ghz24" in cuts:
        phase("noisy_parity_ghz24", phase_noisy_parity_ghz24,
              *cuts["ghz24"], report)
    phase("noisy_mitigation", phase_noisy_mitigation, report)
    if cut("sup25", "sup", 25, 13, 0, stored_plan="sup25_p2_q13"):
        phase("main_sup25_streamed", phase_main_sup25_streamed,
              *cuts["sup25"], report)
        del cuts["sup25"]
    if cut("hwe16", "hwe", 16, 10, 0, depth=5):
        circ, virt = cuts["hwe16"]
        # the variant kernel in one CTA's shared memory (13 qubits)
        phase("kernel_hwe16", phase_variant_witness, "hwe16_folded_staged",
              virt, report)
        phase("main_hwe16_pallas", phase_main, "hwe16_pallas", circ, virt,
              report, 1, "variant_rows/hwe16_folded_staged")
        phase("sv_hwe16", phase_sv, "hwe16", virt, report)
        rows = phase("main_hwe16_sv", phase_main_sv, "hwe16_sv", circ, virt,
                     report, "sv_rows/hwe16")
        if rows is not None:
            phase("main_hwe16_xla", phase_main_xla, circ, virt, report, rows)
        del rows
    phase("sv_width_gate", phase_sv_width_gate, report)
    tfim20 = phase("vqe_tfim20", phase_vqe_tfim20, report, card)
    phase("vqe_qaoa16", phase_vqe_qaoa16, report, card)
    phase("vqe_tfim16_modes", phase_vqe_tfim16_modes, report, card)
    if tfim20 is not None:
        phase("vqe_tfim20_sampled", phase_vqe_tfim20_sampled, report, card,
              tfim20[1])
    del tfim20
    phase("sweep_tfim20_bind", phase_sweep_tfim20_bind, report, card)
    phase("optim_tfim16", phase_optim_tfim16, report, card)
    phase("teleport_sweep", phase_teleport_sweep, report, card)
    phase("bv", phase_bv, report, card)
    phase("teleport_ghz20", phase_teleport_ghz20, report, card)
    phase("teleport_ghz24_p3", phase_teleport_ghz24_p3, report, card)
    # the last modules: no kernel of their own, they feed kernels 1-2
    phase("syc32_lightcone", phase_syc32_lightcone, report, card)
    phase("compiler", phase_compiler, report, card)
    if "ghz24" in cuts:
        phase("sparse_knit", phase_sparse_knit, *cuts["ghz24"], report, card)
    if "sup20" in cuts:
        phase("tracer", phase_tracer, *cuts["sup20"], report, card)
        phase("lane_engine", phase_lane_engine, cuts["sup20"][1], report)
        phase("host_tools", phase_host_tools, *cuts["sup20"], report, card)
        if "hwe40" in cuts:
            phase("roofline", phase_roofline, report, cuts)
    if "sup20" in cuts:
        circ, virt = cuts["sup20"]
        phase("sv_sup20", phase_sv, "sup20", virt, report)
        rows = phase("main_sup20_sv", phase_main_sv, "sup20_sv", circ, virt,
                     report, "sv_rows/sup20")
        if rows is not None:
            phase("rows_sup20_sv", phase_rows_sup20, virt, report, rows)
        del rows

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
        for key in ("work", "kernel_work", "segments", "fragments",
                    "rows_a_segment"):
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
