"""Faults planted under the noisy cell's timed path, and the readings
that the limits of its comparison (``reference/noisy_replay.py``'s
``replay_limits``) are set from, on the card.

    python3 portbench/noisy_faults.py --workload <name> --seeds 1 2 3 \\
        [--faults rows_bf16 ... --fault-seeds 4 5] [--requests N] \\
        [--out noisy_faults.json]

For each seed, one run of the cell in this process serves ``--requests``
requests (by default as many as a run compares, the traffic's
``check``) and reads every term of the comparison on each: on the
port's timed route (the program's readings), and for each fault and
fault seed with the fault planted.  Prints one JSON object per run and
the summary last: per term the program's largest reading and each
fault's smallest.

The faults (each ``plant(fault, port)`` returns the port to serve with
and a function that takes the fault out again):

- ``rows_bf16``: every chunk's noisy rows rounded to bfloat16;
- ``gate_noise_skipped``: every trajectory simulated with the identity
  branch at every site (the gates' noise left out), readout kept;
- ``readout_skipped``: the readout channel left out;
- ``trajectory_dropped``: the last trajectory of every label left out of
  the simulation and the mean taken over the others;
- ``state_unchanged``: every request answered with the first answer
  again (``faults.py``'s);
- ``rates_unrouted``: every noise site drawn at the rate of the device
  qubit numbered as its placement slot (the layout before routing), not
  of the device node the slot is placed on.
"""
import argparse
import importlib
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
if sys.path and pathlib.Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(HERE.parent))

PORT = "hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch"
FAULTS = ("rows_bf16", "gate_noise_skipped", "readout_skipped",
          "trajectory_dropped", "state_unchanged", "rates_unrouted")


def _patch(owner, name, make):
    """Replace ``owner.name`` by ``make(real)``; returns the undo."""
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    return lambda: setattr(owner, name, real)


def _rows_fault(fault):
    """A replacement of ``_SimRows.noisy_rows`` that plants ``fault``."""
    import torch

    def make(real):
        def rows(self, vidx_chunk, pidx):
            if fault == "gate_noise_skipped":
                return real(self, vidx_chunk, torch.zeros_like(pidx))
            if fault == "trajectory_dropped":
                return real(self, vidx_chunk, pidx[:, :-1])
            if fault == "readout_skipped":
                kept, self.readout = self.readout, None
                try:
                    return real(self, vidx_chunk, pidx)
                finally:
                    self.readout = kept
            out = real(self, vidx_chunk, pidx)
            return out.to(torch.bfloat16).to(out.dtype)
        # the port counts into the function it finds on the class
        rows.rows = rows.site_passes = 0
        return rows
    return make


def plant(fault: str, port):
    if fault == "state_unchanged":
        from portbench import faults

        return faults.plant(fault, port)
    if fault == "rates_unrouted":
        noise = importlib.import_module(f"{PORT}.ops.noise")
        return port, _patch(
            noise, "fragment_noise_sites",
            lambda real: lambda nm, ops, phys: real(nm, ops, None))
    if fault in FAULTS:
        streamed = importlib.import_module(f"{PORT}.ops.streamed")
        return port, _patch(streamed._SimRows, "noisy_rows",
                            _rows_fault(fault))
    raise ValueError(f"no fault {fault!r}; the faults are {FAULTS}")


class _Reading:
    """The cell's comparison, every answer's terms kept."""

    def __init__(self, check):
        self.check, self.terms = check, []

    def compare(self, cell, instance, answer, device="cpu"):
        t = self.check.terms(cell, instance, answer, device)
        self.terms.append(t)
        limits = cell.config["replay_limits"]
        return max(t[k] / float(limits[k]) for k in t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
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
        [(f, s) for f in args.faults for s in args.fault_seeds]
    rows = []
    for kind, seed in runs:
        served, undo = (port, lambda: None) if kind == "program" else \
            plant(kind, port)
        cell.check = reading = _Reading(check)
        try:
            out = run_cell(cell, seed, 0.0, False, port=served,
                           requests=n)
        finally:
            undo()
            cell.check = check
        row = {"workload": cell.name, "seed": seed, "kind": kind,
               "terms": reading.terms, "reading": out["checks"],
               "correct": out["correct"], "failed": out["failed"],
               "errors": out["errors"],
               "request_s": out["metrics"].get("request_s", {}).get("value"),
               "check_s": out["notes"]["check_s"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": cell.name, "limits": cell.config["replay_limits"]}
    for kind in dict.fromkeys(k for k, _ in runs):
        got = [t for r in rows if r["kind"] == kind for t in r["terms"]]
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(t[k] for t in got) for k in got[0]} \
            if got else None
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"summary": summary, "rows": rows},
                                   indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
