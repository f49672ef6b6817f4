"""Knitting helpers: per-fragment fold weights and the simplex projection.

Port of the JAX package's ``ops/knit.py`` parts the ``engine="pallas"``
slice needs.  The knit contraction itself runs inside the streamed scan
(``ops/streamed.py``); the batched knit (``knit``, ``knit_values``,
``expectation_z``) is not ported yet (ROADMAP H100 port, queue A, "other
engines").  The fold weights are small host tables (numpy, as in the
JAX package) that the kernel's wrapper moves to the device; the simplex
projection is torch and runs on the device that holds the knit result.
"""
from __future__ import annotations

import numpy as np
import torch

from ..virt.virtual_circuit import VirtualCircuit
from .statevector import Distribution


def fold_weights(virt: VirtualCircuit, frag_name: str) -> list[np.ndarray]:
    """Per-touching-vgate knit weight matrices W[v, b] this fragment
    applies (owner-side logic).  Exposed so callers can pass them as
    runtime arguments (parameter sweeps re-bind RZZ/CP coefficients
    without recompiling the knit)."""
    prog = virt.programs[frag_name]
    sides: dict[int, list[int]] = {g: [] for g in prog.touching}
    for slot in prog.slots:
        sides[slot.vgate_idx].append(slot.side)
    out = []
    for g in prog.touching:
        spec = virt.vgates[g].spec
        my_sides = sides[g]
        both = len(my_sides) == 2
        w = np.ones((spec.num_instantiations, 2), dtype=np.float64)
        for v in range(spec.num_instantiations):
            if both or spec.owner_side[v] in my_sides:
                w[v] = spec.coef[v]
        out.append(w)
    return out


def smolin_project(vals: torch.Tensor) -> torch.Tensor:
    """Smolin projection onto the probability simplex, in float64 on
    ``vals``' own device, numerically the reference's ascending scan
    (quasi_distr.py:28-43) without its O(2^n) Python loop.

    In the reference loop the discarded entries are exactly a *prefix* of
    the ascending value order (once one entry passes, beta and num freeze
    and every later, larger, entry passes too).  So the cut index k* is
    the first position where ``v[k] + cumsum(v)[:k]/(n-k) >= 0`` and the
    output is ``v + beta/(n-k*)`` on the kept set, 0 on the discarded
    set.  The JAX package selects the negative tail on the host before
    sorting it; here one stable sort of the whole vector runs where the
    knit left it, so a distribution on the card is projected there and
    only the result is fetched.

    Tie caveat: entries that share the exact boundary value are cut in
    stable-sort order; the reference's order there depends on dict
    insertion order, so the published scan is not tie-deterministic
    either."""
    v = vals.reshape(-1).to(torch.float64)
    n = v.numel()
    if not bool((v < 0).any()):
        return v.clone()
    sv, order = torch.sort(v, stable=True)
    csum = torch.cat([sv.new_zeros(1), torch.cumsum(sv[:-1], 0)])
    left = n - torch.arange(n, dtype=torch.float64, device=v.device)
    ok = sv + csum / left >= 0
    if not bool(ok.any()):
        return torch.zeros_like(v)  # everything discarded (degenerate input)
    k = int(ok.to(torch.int8).argmax())
    out = v + csum[k] / (n - k)
    out[order[:k]] = 0.0
    return out


def nearest_probability_distribution(dist: Distribution) -> Distribution:
    """Project a quasi-distribution onto the probability simplex, matching
    the reference's Smolin-style projection (quasi_distr.py:28-43)."""
    out = smolin_project(torch.as_tensor(np.asarray(dist.values)))
    return Distribution(
        out.to(torch.float32).numpy(), dist.bit_positions, dist.num_clbits
    )
