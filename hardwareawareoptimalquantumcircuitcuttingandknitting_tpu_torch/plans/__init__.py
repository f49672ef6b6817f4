"""Stored cut plans: solve once, cut many.

A plan that a deployment reuses is solved once, saved with
``Cutter.save_plan`` as a JSON file beside this module, and adopted with
``Cutter.use_plan`` (the native solver takes about a second on hwe-40,
the pure-Python search minutes):

* ``hwe40_d2_p2_q21`` — ``genCirc("hwe", 40, 2, seed=0)`` cut into 2
  partitions of at most 21 qubits (``maxNQpdCuts = maxNCuts =
  maxCutsPerPartitions = 5``): two gate cuts, 36 labels, two fragments of
  22 simulated qubits.
* ``hwe40_d4_p2_q20`` — ``genCirc("hwe", 40, 4, seed=0)`` cut into 2
  partitions of at most 20 qubits (the same three limits at 5), solved
  by this package's native solver (under 0.1 s): four cx gate cuts, on
  ``cx(19, 20)`` of each layer, 1296 labels, two fragments of 24
  simulated qubits (20 data qubits and 4 deferral ancillas each) — the
  blocked kernel at its widest.  The rotation angles do not enter the
  plan.
* ``ghz40_p2_q20`` — ``genCirc("ghz", 40, 1)`` cut into 2 partitions of at
  most 20 qubits (the same three limits at 5): one gate cut, 6 labels, two
  fragments of 21 simulated qubits.
* ``qft16_prepped_p2_q15_gamma`` — the 16-qubit QFT behind a layer of
  ``h`` and ``rz`` on every qubit (``models.qft.library_qft(16)``, all
  measured), cut 15|1 by ``Cutter(maxNPartitions=2,
  maxNQubitsPerPartition=15, gammaMode=True)``: 15 ``cp`` gate cuts with
  gamma_total 8.57, the sampled engine's flagship plan.  The ``rz`` angles
  do not enter the plan.
* ``sup25_p2_q13`` — ``genCirc("sup", 25, 1, seed=0)`` cut into 2
  partitions of at most 13 qubits (the same three limits at 5): four cz
  gate cuts and one wire cut, 10368 labels, fragments of 18 and 17
  simulated qubits — the streamed engine's configuration (the
  pure-Python search takes some 12 s on it).  The supremacy circuit's
  single-qubit gates do not enter the plan.
* ``sup20_p2_q10`` — ``genCirc("sup", 20, 1, seed=0)`` cut into 2
  partitions of at most 10 qubits (the three limits at 5), solved by
  this package's native solver (some 6 s): five cz gate cuts, 7776
  labels, two fragments of 15 simulated qubits (10 data qubits and 5
  deferral ancillas each) — the noisy streamed configuration on the
  calibrated 27-qubit model (``ops.noise.fake_kolkata_v2``).
* ``syc32_d3_p2_q17`` — ``genCirc("syc", 32, 3)`` (BASELINE config #4 at
  depth 3) cut into 2 partitions of at most 17 qubits (``maxNQpdCuts =
  maxNCuts = maxCutsPerPartitions = 6``), solved by this package's native
  solver (some 19 s): four gate cuts, 1296 labels, two fragments of 20
  simulated qubits (16 data qubits and 4 deferral ancillas each).
"""
from __future__ import annotations

import pathlib

from ..cutter.plan import CutPlan

_DIR = pathlib.Path(__file__).resolve().parent


def stored_plans() -> list[str]:
    """Names of the plans stored beside this module."""
    return sorted(p.stem for p in _DIR.glob("*.json"))


def load_plan(name: str) -> CutPlan:
    """The stored plan ``name`` (see :func:`stored_plans`)."""
    path = _DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"no stored plan {name!r}; stored: {stored_plans()}"
        )
    return CutPlan.load(path)
