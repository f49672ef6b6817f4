"""The comparison ``noisy_replay`` of a trajectory-noise knit
(``entries/noisy.py``'s answer) with its replay from the same draws
(``noisy_trajectories.py``): three readings an answer, each divided by
its limit (the configuration's ``replay_limits``), the largest held to
``limit`` 1:

- ``routing``: the total variation between the knit of the answer's
  routed streams, noise-free and without readout, and the uncut
  circuit's distribution (``statevector.py``); ``inf`` where a stream
  puts a two-qubit gate on device qubits that the configuration's
  coupling does not join.  It pins the streams the replay takes as data
  to the circuit's meaning, so that a stale answer or a wrong routing
  reads high here;
- ``draws``: over every noise site of both fragments, the largest
  ``|N - L T p| / sqrt(L T p (1 - p))``, N the site's non-identity
  branches over L labels x T trajectories and p the rate the reference
  gives the site; ``inf`` where T is not the configuration's
  ``trajectories`` or the stream has another number of sites than were
  drawn.  It holds the draws, which the answer term takes as given, to
  the device's calibration;
- ``answer``: the total variation between the answer and the replay of
  its draws (mean over trajectories, readout, knit, projection), which
  holds the arithmetic of the rows, their mean and readout, the knit
  and the projection to the configuration's precision.

Every reading is ``inf`` where the answer has no noise record, covers
other clbits or another number of outcomes, or the record does not fit
the instance.  The run reads the worst over the answers compared."""
import math

import numpy as np
import torch

from . import noisy_trajectories as nt

TERMS = ("routing", "draws", "answer")


def terms(cell, instance, answer, device="cpu") -> dict:
    """The three readings, each on its own scale (before its limit)."""
    inf = {k: math.inf for k in TERMS}
    cfg = cell.config["noise"]
    record = answer.get("noise")
    n = instance["num_qubits"]
    values = np.asarray(answer["values"], np.float64)
    if record is None or list(answer["bit_positions"]) != list(range(n)) \
            or values.shape != (1 << n,):
        return inf
    try:
        replay = nt.Replay(instance, record, cfg["calibration_seed"], device)
        exact = replay.exact()
        off = replay.off_coupling(nt.COUPLINGS[cfg["coupling"]])
        routing = math.inf if off else nt.total_variation(
            exact, nt.uncut(instance, device))
        traj = {np.asarray(f["draws"]).shape[1] for f in replay.frags}
        draws = math.inf if traj != {cfg["trajectories"]} or \
            record["trajectories"] != cfg["trajectories"] else \
            max(float(replay.site_z(f).max()) for f in range(2))
        got = torch.as_tensor(values, device=device)
        out = nt.total_variation(got, replay.noisy())
    except (ValueError, KeyError, IndexError) as exc:
        print(f"noisy_replay: the record does not fit the instance ({exc})")
        return inf
    return {"routing": nt.nan_to_inf(routing), "draws": nt.nan_to_inf(draws),
            "answer": nt.nan_to_inf(out)}


def compare(cell, instance, answer, device="cpu") -> float:
    """The reading: the largest term over its limit."""
    limits = cell.config["replay_limits"]
    t = terms(cell, instance, answer, device)
    return max(t[k] / float(limits[k]) for k in TERMS)
