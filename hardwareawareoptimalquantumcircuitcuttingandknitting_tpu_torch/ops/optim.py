"""Population-batched, gradient-free optimisation on cut circuits.

Port of the JAX package's ``ops/optim.py``.  The differentiable sweep
(ops/sweep.py) serves gradient-based VQE/QAOA; shot-sampled or noisy
estimators call for population-based optimisers (SPSA, evolution
strategies), which share one compute shape — *evaluate the same circuit
at P parameter sets per step*.  :func:`population_energy` evaluates the
whole population in one batched pass (``torch.func.vmap`` over the
energy: the population times each fragment's variants is one batch of
states, never a Python loop over candidates), and the optimiser loop
keeps theta on the device, reading the host only at the end (the JAX
package runs it as one ``lax.scan`` under ``jit``).

With a mesh carrying a ``dp`` axis each rank evaluates its slice of the
population and the energies are gathered, so every rank sees all of
them.

Random directions come from a ``torch.Generator`` (``key=``: a generator,
or an int that seeds one on theta's device): the same schedules and
arithmetic as the JAX package, not its ``jax.random`` stream.  The
private loops (:func:`_spsa_loop`, :func:`_nes_loop`) take the
directions as tensors, so a caller can hand them any draws.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def population_energy(energy, mesh=None, axis: str = "dp"):
    """Batch ``energy(theta) -> 0-d tensor`` over a leading population
    axis.

    Returns ``energies(thetas)`` mapping ``[pop, n_params] -> [pop]``.
    With ``mesh`` (a ``parallel.mesh.Mesh`` whose ``axis`` names the
    data-parallel axis), each rank evaluates its contiguous slice of the
    population (any ``pop``: the last ranks may hold fewer candidates)
    and the energies are gathered, so every rank returns all ``pop``; the
    gradient w.r.t. ``thetas``, where one is taken, is summed over the
    axis and equals the unsharded one on every rank.

    ``energy`` must not itself be split over a live ``dp`` axis
    (``make_hamiltonian_energy(mesh=)`` with several ranks): its
    collectives cannot run once per candidate inside the batch.
    """
    if getattr(energy, "sharded", False):
        raise ValueError(
            "energy splits its variant rows over a dp axis of several "
            "ranks; population_energy batches candidates and cannot run "
            "those collectives per candidate: build the energy without "
            "mesh= and pass the mesh here"
        )
    batched = torch.func.vmap(energy)
    if mesh is None or not mesh._live(axis) or mesh.shape[axis] == 1:
        return batched

    from ..parallel.mesh import dp_slice, gather_rows, sum_grads

    def energies(thetas):
        thetas = torch.as_tensor(thetas, dtype=torch.float32,
                                 device=mesh.device)
        pop = thetas.shape[0]
        lo, hi = dp_slice(pop, mesh, axis)
        (mine,) = sum_grads([thetas], mesh, axis)
        mine = mine[lo:hi]
        # an empty slice still joins the graph, so every rank takes part
        # in the backward pass's collectives
        local = batched(mine) if hi > lo else mine.sum(dim=1)
        return gather_rows(local, mesh, pop, axis)

    return energies


@dataclass
class OptimResult:
    theta: np.ndarray        # final parameters [n_params]
    energy: float            # energy(theta) at the final parameters
    history: np.ndarray      # per-step population-mean energy [steps]
    evaluations: int         # total energy evaluations folded into launches


def _theta0(theta0, device) -> torch.Tensor:
    """``theta0`` as a float32 tensor: on its own device when it is a
    tensor, else on ``device`` (None: the card; raises without one)."""
    if isinstance(theta0, torch.Tensor):
        return theta0.detach().to(torch.float32)
    from ..convert import resolve_device

    return torch.as_tensor(np.asarray(theta0, np.float32),
                           device=resolve_device(device))


def _generator(key, device) -> torch.Generator:
    """``key`` itself when it is a ``torch.Generator``, else a generator
    on ``device`` seeded with the int ``key``."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


def _finish(theta, hist, energy, evaluations) -> OptimResult:
    """One final evaluation, then the single host read of the loop."""
    with torch.no_grad():
        e = energy(theta)
    return OptimResult(theta.cpu().numpy(), float(e), hist.cpu().numpy(),
                       evaluations=evaluations)


def _spsa_loop(energies, theta0, deltas, *, a, c, alpha, gamma, big_a):
    """SPSA's steps on directions ``deltas [steps, pairs, n]`` (+-1):
    returns ``(theta, history)`` on theta0's device, nothing read back.
    The JAX package's step arithmetic, in float32."""
    theta = theta0
    steps, pairs = deltas.shape[0], deltas.shape[1]
    ks = torch.arange(steps, dtype=torch.float32, device=theta.device)
    ck_all = c / (ks + 1.0) ** gamma
    ak_all = a / (ks + 1.0 + big_a) ** alpha
    hist = torch.empty(steps, dtype=torch.float32, device=theta.device)
    with torch.no_grad():
        for k in range(steps):
            ck, ak = ck_all[k], ak_all[k]
            delta = deltas[k]
            probes = torch.cat([theta + ck * delta, theta - ck * delta])
            e = energies(probes)
            e_plus, e_minus = e[:pairs], e[pairs:]
            # 1/delta == delta for Rademacher directions
            ghat = torch.mean(
                (e_plus - e_minus)[:, None] / (2.0 * ck) * delta, dim=0
            )
            theta = theta - ak * ghat
            hist[k] = torch.mean(e)
    return theta, hist


def spsa_minimize(energy, theta0, *, steps: int, key, pairs: int = 4,
                  a: float = 0.2, c: float = 0.1, alpha: float = 0.602,
                  gamma: float = 0.101, stability: float | None = None,
                  mesh=None, device=None) -> OptimResult:
    """Batched SPSA (simultaneous perturbation stochastic approximation).

    Per step, ``pairs`` independent Rademacher directions give ``2 *
    pairs`` energies in one batched evaluation and the gradient estimate
    averages the pairs (variance shrinks 1/pairs).  Gain schedules are
    the standard Spall sequences ``a_k = a / (k + 1 + A)^alpha``, ``c_k =
    c / (k + 1)^gamma`` with ``A = stability`` (default ``0.1 *
    steps``).

    ``history[k]`` is the mean of the step's ``2 * pairs`` probe energies
    (no extra evaluation is spent on it).  ``key``: a ``torch.Generator``
    or an int seed (a generator on theta's device); ``device``: where a
    numpy ``theta0`` goes (None: the card).
    """
    theta = _theta0(theta0, device)
    n = theta.shape[0]
    big_a = 0.1 * steps if stability is None else stability
    gen = _generator(key, theta.device)
    bits = torch.randint(0, 2, (steps, pairs, n), generator=gen,
                         device=gen.device)
    deltas = (2.0 * bits - 1.0).to(device=theta.device, dtype=torch.float32)
    theta, hist = _spsa_loop(
        population_energy(energy, mesh), theta, deltas, a=a, c=c,
        alpha=alpha, gamma=gamma, big_a=big_a,
    )
    return _finish(theta, hist, energy, 2 * pairs * steps + 1)


def _nes_loop(energies, theta0, eps_half, *, sigma, lr, fitness_shaping):
    """NES steps on antithetic halves ``eps_half [steps, pop // 2, n]``:
    returns ``(theta, history)`` on theta0's device, nothing read back.
    The JAX package's step arithmetic, in float32."""
    theta = theta0
    steps = eps_half.shape[0]
    pop = 2 * eps_half.shape[1]
    hist = torch.empty(steps, dtype=torch.float32, device=theta.device)
    with torch.no_grad():
        for k in range(steps):
            eps = torch.cat([eps_half[k], -eps_half[k]])
            e = energies(theta + sigma * eps)
            if fitness_shaping:
                ranks = torch.argsort(torch.argsort(e, stable=True),
                                      stable=True).to(torch.float32)
                fit = ranks / (pop - 1) - 0.5  # low energy -> negative
            else:
                fit = (e - e.mean()) / (e.std(correction=0) + 1e-8)
            grad = torch.sum(fit[:, None] * eps, dim=0) / (pop * sigma)
            theta = theta - lr * grad
            hist[k] = torch.mean(e)
    return theta, hist


def nes_minimize(energy, theta0, *, steps: int, key, pop: int = 8,
                 sigma: float = 0.15, lr: float = 0.1,
                 fitness_shaping: bool = True, mesh=None,
                 device=None) -> OptimResult:
    """Separable natural evolution strategies with antithetic sampling.

    Per step: ``pop`` antithetic Gaussian perturbations (``pop`` even;
    eps and -eps paired) are evaluated in one batched pass; the update is
    the fitness-weighted sum of directions.  ``fitness_shaping`` replaces
    raw energies by centered ranks (Wierstra et al. 2014's utility trick,
    simplified) for scale-invariance; otherwise energies are
    standardised within the step.  ``key`` and ``device`` as in
    :func:`spsa_minimize`.
    """
    if pop % 2:
        raise ValueError("pop must be even (antithetic sampling)")
    theta = _theta0(theta0, device)
    n = theta.shape[0]
    gen = _generator(key, theta.device)
    eps_half = torch.randn((steps, pop // 2, n), generator=gen,
                           device=gen.device).to(theta.device)
    theta, hist = _nes_loop(
        population_energy(energy, mesh), theta, eps_half, sigma=sigma,
        lr=lr, fitness_shaping=fitness_shaping,
    )
    return _finish(theta, hist, energy, pop * steps + 1)
