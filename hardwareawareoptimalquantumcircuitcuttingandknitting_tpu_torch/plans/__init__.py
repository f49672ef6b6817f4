"""Stored cut plans: solve once, cut many.

The pure-Python cut search takes minutes on wide circuits, so a plan that
a deployment reuses is solved once, saved with ``Cutter.save_plan`` as a
JSON file beside this module, and adopted with ``Cutter.use_plan``:

* ``hwe40_d2_p2_q21`` — ``genCirc("hwe", 40, 2, seed=0)`` cut into 2
  partitions of at most 21 qubits (``maxNQpdCuts = maxNCuts =
  maxCutsPerPartitions = 5``): two gate cuts, 36 labels, two fragments of
  22 simulated qubits.
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
