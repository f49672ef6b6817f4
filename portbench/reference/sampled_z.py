"""The comparison ``sampled_z`` of a Monte-Carlo estimate with its own
error bars and with a replay of its trajectories
(``entries/sampled.py``'s answer): one reading per answer,

    max( max_b |est_b - exact_b| / max(se_b, SE_FLOOR),
         5 * max_b se_b / stderr_cap,
         5 * replay_error / replay_tol ),

with ``exact`` the reference's marginal of the same instance
(``qft_statevector.py``), ``se`` the answer's standard errors and
``replay_error`` the largest distance of the answer's probed trajectory
rows from their complex128 replay (``cp_trajectories.py``).  The first
term holds the estimate to the truth in its own error bars; the second
holds the error bars to what the configuration's sample budget buys
(``stderr_cap``), so that a smaller budget or an inflated error reads
above the limit of 5 as well; the third holds the rows that the
estimate is made of to the arithmetic of the configuration's precision
(``replay_tol``), which the first two, being statistical, cannot see.
``stderr_cap`` and ``replay_tol`` are keys of the configuration.  The
run reads the worst over the answers compared."""
import numpy as np

from .cp_trajectories import replay_error
from .qft_statevector import distribution

SE_FLOOR = 1e-3   # a bin's error bar is read as at least this


def terms(cell, instance, answer, device="cpu") -> dict:
    """The three terms of the reading, each on the limit's scale:
    ``z``, ``cap`` and ``replay``; ``inf`` where the answer covers other
    clbits, another number of outcomes, has no finite standard errors,
    or no trajectory rows that fit the instance."""
    inf = float("inf")
    ref, clbits = distribution(instance, cell.config.get("keep_clbits"),
                               device)
    exact = ref.cpu().numpy()
    values = np.asarray(answer["values"], np.float64)
    se = np.asarray(answer.get("stderr", ()), np.float64)
    if list(answer["bit_positions"]) != clbits or \
            values.shape != exact.shape or se.shape != exact.shape or \
            not np.isfinite(se).all():
        return {"z": inf, "cap": inf, "replay": inf}
    z = float(np.max(np.abs(values - exact) / np.maximum(se, SE_FLOOR)))
    cap = 5.0 * float(se.max()) / float(cell.config["stderr_cap"])
    probe = answer.get("probe")
    err = replay_error(instance, probe, device)[0] if probe else inf
    return {"z": z, "cap": cap,
            "replay": 5.0 * err / float(cell.config["replay_tol"])}


def compare(cell, instance, answer, device="cpu") -> float:
    """The reading: the largest of :func:`terms`."""
    return max(terms(cell, instance, answer, device).values())
