"""Faults planted under the timed path of a cell whose rows kernel 4
computes (``ops/blocked_kernel.py``), and the readings that the limit of
its comparison is set from, on the card.

    python3 portbench/blocked_faults.py --workload <name> --seeds 1 2 3 \\
        [--control-seeds 4 5] [--faults rows_bf16 ... --fault-seeds 6 7] \\
        [--requests N] [--out chiprun_out/blocked_faults.json]

For each seed, one run of the cell in this process serves ``--requests``
requests (by default as many as a run compares, the traffic's
``check``) and reads the cell's comparison on each answer: on the
port's timed route (the program's readings), for the control seeds on
the port's own lower-precision route that the configuration names, and
for each fault and fault seed with the fault planted.  Prints one JSON
object per run and the summary last: the program's largest reading,
the control's and each fault's smallest.

The faults (each ``plant(fault, port)`` returns the port to serve with
and a function that takes the fault out again):

- ``half_the_labels_blocked``: kernel 4's rows of the second half of
  each chunk of labels zeroed, the first half doubled;
- ``rows_bf16``: kernel 4's ``|psi|^2`` rows rounded to bfloat16;
- ``segment_skipped``: one suffix segment of the second fragment (its
  middle one) left out of every label's run;
- ``state_unchanged``, ``answer_altered``: ``faults.py``'s.
"""
import argparse
import importlib
import json
import pathlib
import sys
import weakref

HERE = pathlib.Path(__file__).resolve().parent
if sys.path and pathlib.Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(HERE.parent))

PORT = "hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch"
FAULTS = ("half_the_labels_blocked", "rows_bf16", "segment_skipped",
          "state_unchanged", "answer_altered")


def _rows_fault(bk, change):
    """Replace ``blocked_rows`` by ``change`` of its rows.  The port
    counts into the function it finds in its module, so the counters
    move to the replacement and back."""
    real = bk.blocked_rows

    def rows(dp, entries):
        return change(real(dp, entries))
    rows.launches, rows.rows = real.launches, real.rows
    rows.last = real.last   # one record of the last chunks, shared
    bk.blocked_rows = rows

    def undo():
        real.launches, real.rows = rows.launches, rows.rows
        bk.blocked_rows = real
    return undo


def _half(rows):
    rows = rows.clone()
    keep = rows.shape[0] // 2
    rows[keep:] = 0
    rows[:keep] *= 2
    return rows


def _bf16(rows):
    import torch

    return rows.to(torch.bfloat16).to(rows.dtype)


def _skip_segment(bk):
    """The second fragment's device plans run without their middle
    suffix segment (a state left as the segment before it made it)."""
    marked = weakref.WeakSet()
    real_plan, real_apply = bk.device_plan, bk.apply_segment

    def device_plan(virt, frag_name, *args, **kw):
        dp = real_plan(virt, frag_name, *args, **kw)
        if frag_name == virt.fragments[1].name:
            if len(dp.plan.segments) < 3:
                raise RuntimeError(f"{frag_name} has no middle segment")
            marked.add(dp)
        return dp

    def apply_segment(dp, k, state, entries):
        if dp in marked and k == len(dp.plan.segments) // 2:
            return state
        return real_apply(dp, k, state, entries)
    bk.device_plan, bk.apply_segment = device_plan, apply_segment

    def undo():
        bk.device_plan, bk.apply_segment = real_plan, real_apply
    return undo


def plant(fault: str, port):
    if fault in ("state_unchanged", "answer_altered"):
        from portbench import faults

        return faults.plant(fault, port)
    bk = importlib.import_module(f"{PORT}.ops.blocked_kernel")
    if fault == "half_the_labels_blocked":
        return port, _rows_fault(bk, _half)
    if fault == "rows_bf16":
        return port, _rows_fault(bk, _bf16)
    if fault == "segment_skipped":
        return port, _skip_segment(bk)
    raise ValueError(f"no fault {fault!r}; the faults are {FAULTS}")


class _Reading:
    """The cell's comparison, every answer's reading kept."""

    def __init__(self, check):
        self.check, self.values = check, []

    def compare(self, cell, instance, answer, device="cpu"):
        x = self.check.compare(cell, instance, answer, device)
        self.values.append(x)
        return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[], choices=FAULTS)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--requests", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from portbench.cell import Port, load_cell, run_cell

    cell = load_cell(args.workload)
    check = cell.check
    port = Port()
    n = args.requests or cell.traffic["check"]
    runs = [("program", s) for s in args.seeds] + \
        [("control", s) for s in args.control_seeds] + \
        [(f, s) for f in args.faults for s in args.fault_seeds]
    rows = []
    for kind, seed in runs:
        served, undo = (port, lambda: None) if kind in ("program",
                                                        "control") \
            else plant(kind, port)
        cell.check = reading = _Reading(check)
        try:
            out = run_cell(cell, seed, 0.0, False, port=served,
                           control=kind == "control", requests=n)
        finally:
            undo()
            cell.check = check
        row = {"workload": cell.name, "seed": seed, "kind": kind,
               "readings": reading.values, "checks": out["checks"],
               "correct": out["correct"], "failed": out["failed"],
               "errors": out["errors"],
               "request_s": out["metrics"].get("request_s", {}).get("value"),
               "check_s": out["notes"]["check_s"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": cell.name, "check": cell.config["check"],
               "limit": cell.config["limit"]}
    for kind in dict.fromkeys(k for k, _ in runs):
        got = [x for r in rows if r["kind"] == kind for x in r["readings"]]
        pick = max if kind == "program" else min
        summary[kind] = pick(got) if got else None
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"summary": summary, "rows": rows},
                                   indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
