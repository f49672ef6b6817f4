"""Shot sampling: emulate the reference's finite-shot estimates.

Port of the JAX package's ``ops/sampling.py``.  The reference converts
Aer counts into normalised quasi-distributions (quasi_distr.py:13-20).
Here multinomial counts are drawn from exact probabilities: per variant
row of the batched engine (:func:`sample_fragment_results`), or from the
streamed scan's knitted distribution (:func:`sample_distribution` on the
host, :func:`sample_indices_device` on the device).  Device draws come
from a ``torch.Generator`` seeded by the caller; the host draws are numpy
``default_rng(seed)``, as in the JAX package, so they give its counts.
"""
from __future__ import annotations

import numpy as np
import torch

from .statevector import Distribution
from .variant_engine import FragmentResult

# past this many sampled cells (rows x shots x outcomes) a block is drawn
# on the host with numpy's multinomial (the JAX package's bound)
_DEVICE_CELLS = 1 << 26


def sample_distribution(dist: Distribution, shots: int,
                        seed: int = 0) -> Distribution:
    """Multinomial counts/shots from a (non-negative) final distribution,
    with numpy's ``default_rng(seed)``: the streamed scan's shot path with
    a checkpoint (per-fragment rows never materialise there)."""
    p = np.asarray(dist.values, dtype=np.float64).clip(min=0.0)
    total = p.sum()
    if total <= 0:
        raise ValueError("cannot sample from an all-nonpositive distribution")
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(shots, p / total)
    return Distribution(
        (counts / float(shots)).astype(np.float32),
        dist.bit_positions,
        dist.num_clbits,
    )


def _multinomial_rows(probs: torch.Tensor, shots: int,
                      gen: torch.Generator) -> torch.Tensor:
    """Multinomial counts ``[V, K]`` of ``shots`` draws from each row of
    ``probs [V, K]``, on the rows' device."""
    v, k = probs.shape
    draws = torch.multinomial(probs, shots, replacement=True, generator=gen)
    counts = torch.zeros((v, k), dtype=torch.float32, device=probs.device)
    return counts.scatter_add_(1, draws, torch.ones_like(draws,
                                                         dtype=torch.float32))


def sample_fragment_results(
    results: list[FragmentResult], shots: int, seed: int = 0
) -> list[FragmentResult]:
    """Each variant row replaced by ``shots`` multinomial counts / shots
    (the reference's per-instantiation Aer counts).  Blocks past 2^26
    sampled cells draw on the host with numpy's ``default_rng(seed)``
    (the JAX package's rule, and its counts); smaller ones on the rows'
    device from a generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    gen = None
    out = []
    for res in results:
        values = torch.as_tensor(res.values, dtype=torch.float32)
        v, k = values.shape
        if v * shots * k > _DEVICE_CELLS:
            rows = values.cpu().numpy().astype(np.float64).clip(min=0.0)
            vals = np.empty((v, k), dtype=np.float32)
            for i in range(v):
                p = rows[i] / rows[i].sum()
                vals[i] = rng.multinomial(shots, p) / float(shots)
            sampled = torch.as_tensor(vals, device=values.device)
        else:
            if gen is None:
                gen = torch.Generator(device=values.device).manual_seed(seed)
            # rows are probability rows (exact engine); renormalise to
            # absorb float error before sampling
            probs = values.clamp(min=0.0)
            probs = probs / probs.sum(dim=1, keepdim=True)
            sampled = _multinomial_rows(probs, shots, gen) / float(shots)
        out.append(FragmentResult(res.name, sampled, res.bit_positions,
                                  res.touching))
    return out


def sample_indices_device(probs: torch.Tensor, shots: int,
                          gen: torch.Generator) -> torch.Tensor:
    """``[shots]`` outcome indices drawn from a non-negative flat
    distribution by inverse CDF (cumsum + searchsorted) on its device:
    no ``[shots, K]`` intermediate, so it scales to 2^25-wide supports.
    Indices are clipped to the valid range (a draw on the total mass, or
    an all-zero input); callers that must reject a non-positive mass
    check it apart."""
    cs = torch.cumsum(probs, 0)
    u = torch.rand(shots, generator=gen, device=probs.device,
                   dtype=probs.dtype) * cs[-1]
    idx = torch.searchsorted(cs, u, right=True)
    return idx.clamp(max=probs.shape[0] - 1)
