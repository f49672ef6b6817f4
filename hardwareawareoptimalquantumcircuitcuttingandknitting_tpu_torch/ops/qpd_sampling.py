"""Monte-Carlo QPD sampling: estimate the knit without enumerating labels.

Port of the JAX package's ``ops/qpd_sampling.py`` (``engine="sampled"``
there), single-device.  The estimator is the same:

  * each cut's coefficient table ``coef[v, b]`` factors into a sampling
    magnitude ``m[v] = max_b |coef[v, b]|`` and a bounded fold ratio
    ``coef[v, b] / m[v]``,
  * ``gamma_g = sum_v m[v]`` is the cut's 1-norm; sampling labels with
    ``P(v_g) = m_g[v_g] / gamma_g`` independently per cut and weighting
    each sample by ``prod_g gamma_g`` times the signs gives an unbiased
    estimator of the knitted distribution,
  * the estimator variance scales with ``kappa = (prod_g gamma_g)^2``.

All label sampling is numpy on the host with the JAX package's seeds and
call order, so both packages draw the same labels; the collapse draws
are ``default_rng(collapse_seed + 7919 * fi).random((L, ncols))`` and the
trajectory-noise branch indices ``default_rng(noise_seed + fi)`` per
fragment, for all ``L`` labels before any blocking, so both feed the
same draws whatever the block size.

Each fragment's rows take one of two routes, chosen when the scan is
built.  With ``pallas_variant=True`` (this package's default) a kernel
serves them where it can: a collapse-mode fragment from
``ops/collapse_kernel`` (every width from 1 to 20 active qubits), an
ancilla-mode fragment from the variant kernel's full rows
(``ops/variant_kernel.make_chunk_kernel``, up to 20 simulated qubits).
Every other fragment, and every fragment with ``pallas_variant=False``
(the JAX default), a bf16 ``dtype`` or a noise model, runs without a
kernel on ``variant_engine.make_sim_fn``: collapse mode
(:func:`_collapse_row_builder`, the measurement collapsed in the
simulation), deferred measurement (:func:`_ancilla_row_builder`), or
trajectory noise with the calibrated readout
(:func:`_noisy_row_builder`, each label's trajectories averaged inside
its block).  The width route is a route, not a fallback: the scan logs
which fragments a kernel backs.  The label scan is a Python loop over
blocks of device work sized by bytes (:func:`_label_block`); the
cross-fragment combination is one weighted ``torch.einsum`` over the
label axis per block, in float32 (a bf16 state's rows are float32).

Artefacts of the TPU route that are not carried over:

  * the float budget of a scan block and its re-evaluation for the
    in-kernel marginal (``_label_budget``) exist there because the
    backend's compile time grows with the largest buffer.  Here
    :func:`_label_block` picks the block from bytes on the card (rows,
    states and their temporaries against
    ``ops/streamed._CHUNK_BYTES_BUDGET``);
  * the scan-length bucketing and the padding rows serve ``jax.jit``'s
    static shapes: eager torch takes a short last block as it is.  The
    other half of that mechanism is kept: the built scan (plans and
    tables on the device) is cached on the ``VirtualCircuit``
    (``_scan_step_cache``), keyed by what the row functions depend on, so a
    repeat estimate builds no plan again;
  * the JAX package runs its noisy rows unblocked, ``[L * trajectories,
    2^k]`` at once; here they go through the blocked scan like every
    other route, so no such buffer exists;
  * ``sample_pallas`` / ``pallas_variant`` default to True: the kernels
    are this package's main path.

Refused: ``mesh=`` (the dp-sharded scan) with NotImplementedError naming
its ROADMAP item (queue A item 11, the sharded engine); noise with a
``dtype``, with a collapse-mode fragment or with ``mesh`` with the JAX
package's ValueError; a PEC model with ValueError naming the batched
engine.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import resolve_device, to_device
from ..utils.logger import get_logger
from ..virt.virtual_circuit import VirtualCircuit
from .bits import permute_bits_flat
from .collapse_kernel import MAX_OUTCOMES, make_collapse_chunk_kernel
from .knit import fold_weights
from .statevector import Distribution
from .streamed import _CHUNK_BYTES_BUDGET, _SimRows, _sample_pauli_indices
from .variant_engine import (
    _slot_tables,
    label_strides,
    label_weight_bounds,
    make_sim_fn,
)
from .variant_kernel import make_chunk_kernel

_MAX_BLOCK = 4096  # labels per scan block, whatever the budget allows
# float32 copies of a state live at once in a pass without a kernel (the
# state, the next one, a slice combination's outputs, an einsum's
# permuted operand)
_STATE_COPIES = 4


def _refuse_mesh(mesh) -> None:
    """The dp-sharded scan is the sharded engine's item."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the dp-sharded sampled scan) is not ported to the torch "
            "package yet: ROADMAP H100 port, queue A, item 11 (the sharded "
            "engine: mesh)"
        )


def _check_noise_args(noise, dtype, cflags, mesh) -> None:
    """The JAX package's argument checks of a noisy sampled estimate."""
    if noise is not None and dtype is not None:
        raise ValueError("noise and bf16 dtype are exclusive "
                         "(the trajectory-noise path is f32)")
    if noise is not None and any(cflags):
        raise ValueError("collapse mode is exact-path only; fragments "
                         "with noise models cannot collapse")
    if noise is not None and mesh is not None:
        raise ValueError(
            "mesh (dp-sharded sampled scan) and noise are exclusive: "
            "the trajectory-noise path runs single-device, so the mesh "
            "would be silently ignored — drop mesh= or noise="
        )
    _refuse_mesh(mesh)


def _variant_magnitudes(spec) -> np.ndarray:
    """Per-variant sampling magnitude ``m[v] = max_b |coef[v, b]|``.

    For the fixed-gate QPDs (cx/cy/cz, wire move) the magnitude is
    outcome-independent and this is just ``|coef[v, 0]|`` (the textbook
    gammas: 3 and 4); parameterised QPDs (rzz/cp) have outcome-dependent
    coefficients, for which sampling by the max and folding
    ``coef[v, b] / m[v]`` (a ratio in [-1, 1]) keeps the estimator
    unbiased with gamma = sum_v m[v]."""
    coef = np.asarray(spec.coef, np.float64)
    return np.maximum(np.abs(coef[:, 0]), np.abs(coef[:, 1]))


def cut_gammas(virt: VirtualCircuit) -> list[float]:
    """Per-vgate QPD 1-norms ``gamma_g = sum_v max_b |coef[v, b]|``."""
    return [
        float(_variant_magnitudes(vg.spec).sum()) for vg in virt.vgates
    ]


def sampling_overhead(virt: VirtualCircuit, eps: float | None = None):
    """``{"gammas", "gamma_total", "kappa", "shots_for_eps"}`` — the
    analytic sampling budget of this cut plan.  ``kappa = gamma_total^2``
    bounds the estimator variance per outcome; ``ceil(kappa / eps^2)``
    samples suffice for additive error ``eps`` (Hoeffding scale).  The
    cut search already minimises exactly this product (the S objective,
    cutter/solver.py:15 / reference Cutter.py:567-571)."""
    gammas = cut_gammas(virt)
    gamma_total = float(np.prod(gammas)) if gammas else 1.0
    out = {
        "gammas": gammas,
        "gamma_total": gamma_total,
        "kappa": gamma_total * gamma_total,
    }
    if eps is not None:
        out["shots_for_eps"] = int(np.ceil(out["kappa"] / (eps * eps)))
    return out


def _systematic_column(p: np.ndarray, n: int, rng) -> np.ndarray:
    """``n`` variant ids whose counts are the systematic-resampling
    allocation of ``n * p`` (each count is floor or ceil of ``n * p[v]``,
    exact in expectation over the uniform offset), independently
    permuted.  After the permutation every single row is marginally
    distributed exactly as ``p`` — the building block of the balanced
    (Latin-hypercube) label sampler."""
    edges = np.cumsum(p)
    edges[-1] = 1.0  # guard fp drift so searchsorted stays in range
    pos = (np.arange(n) + rng.random()) / n
    ids = np.searchsorted(edges, pos, side="right").astype(np.int32)
    return rng.permutation(ids)


def sample_labels(
    virt: VirtualCircuit, num_samples: int, seed: int = 0,
    method: str = "iid",
) -> np.ndarray:
    """[num_samples, n_vgates] int32 variant indices, drawn independently
    per cut with ``P(v) = max_b |coef[v, b]| / gamma``.

    ``method="lhs"``: balanced (Latin-hypercube) sampling — each cut's
    column is a systematic-resampling allocation of its variant
    distribution, independently permuted.  Rows stay exchangeable with
    the exact per-row marginal (the estimator remains unbiased), but
    each cut's EMPIRICAL variant counts are pinned to within 1 of
    ``n * p`` — the per-cut main-effect component of the estimator
    variance vanishes (O(gamma/n) instead of O(gamma/sqrt(n)) on
    single-cut plans; classic LHS variance decomposition)."""
    if method not in ("iid", "lhs"):
        raise ValueError(f"unknown sampling method {method!r}")
    rng = np.random.default_rng(seed)
    cols = []
    for vg in virt.vgates:
        m = _variant_magnitudes(vg.spec)
        p = m / m.sum()
        if method == "lhs":
            cols.append(_systematic_column(p, num_samples, rng))
        else:
            cols.append(
                rng.choice(len(m), size=num_samples, p=p).astype(np.int32)
            )
    if not cols:
        return np.zeros((num_samples, 0), np.int32)
    return np.stack(cols, axis=1)


def sample_label_counts(
    virt: VirtualCircuit,
    num_samples: int,
    seed: int = 0,
    chunk: int = 1 << 20,
    accept=None,
    max_draws: int = 1 << 27,
    method: str = "iid",
) -> tuple[np.ndarray, np.ndarray]:
    """(unique_labels [L, G], counts [L]) for ``num_samples`` accepted
    draws, accumulated chunk-by-chunk — peak memory is O(chunk + unique),
    not O(num_samples), so budgets far beyond the unique-label count cost
    nothing extra.

    ``accept``: optional vectorised predicate ``[n, G] -> bool mask``
    (rejection sampling — the stratified tail).  ``max_draws`` bounds the
    total draws so a vanishing acceptance rate fails loudly instead of
    hanging.

    ``method="lhs"`` balances each cut's variant counts per chunk (see
    :func:`sample_labels`); rows stay exchangeable, so rejection
    filtering and truncation to the remaining budget keep the accepted
    rows marginally distributed as the (conditional) target."""
    # Dedup via a BIG-ENDIAN mixed-radix int64 packing of each row when
    # the label grid fits in 63 bits: np.unique on int64 keys sorts in
    # the same lexicographic order as the tuple-dict path it replaces
    # (identical output ordering -> identical downstream collapse draws)
    # but far faster than np.unique(axis=0)'s void-dtype memcmp sort.
    radices = [
        max(1, len(_variant_magnitudes(vg.spec))) for vg in virt.vgates
    ]
    grid = 1
    for r in radices:
        grid *= r
    strides = None
    if 0 < grid <= (1 << 62) and radices:
        strides = np.empty(len(radices), np.int64)
        s = 1
        for g in range(len(radices) - 1, -1, -1):
            strides[g] = s
            s *= radices[g]
    packed_parts: list[np.ndarray] = []
    count_parts: list[np.ndarray] = []
    acc: dict[tuple, int] = {}
    rng_seed = seed
    done = 0
    drawn = 0
    while done < num_samples:
        # the 1024 floor amortises rejection-sampling misses; without a
        # predicate draw exactly the remainder (keeps LHS balance whole)
        want = num_samples - done
        take = min(chunk, want if accept is None else max(1024, want))
        if drawn + take > max_draws:
            raise ValueError(
                f"rejection sampling exceeded {max_draws} draws with "
                f"{done}/{num_samples} accepted — the acceptance rate is "
                "too small for this budget (shrink head_labels or the "
                "sample budget: a tiny gamma_tail needs few samples)"
            )
        labels = sample_labels(virt, take, seed=rng_seed, method=method)
        rng_seed += 1  # fresh stream per chunk
        drawn += take
        if accept is not None:
            labels = labels[accept(labels)]
            if len(labels) == 0:
                continue
        labels = labels[: num_samples - done]
        if strides is not None:
            pk, ct = np.unique(
                labels.astype(np.int64) @ strides, return_counts=True
            )
            packed_parts.append(pk)
            count_parts.append(ct.astype(np.int64))
        else:
            uniq, counts = np.unique(labels, axis=0, return_counts=True)
            for row, c in zip(uniq, counts):
                key = tuple(int(v) for v in row)
                acc[key] = acc.get(key, 0) + int(c)
        done += len(labels)
    G = len(virt.vgates)
    if strides is not None:
        if not packed_parts:
            return np.zeros((0, G), np.int32), np.zeros(0, np.int64)
        allp = np.concatenate(packed_parts)
        allc = np.concatenate(count_parts)
        uniq_p, inv = np.unique(allp, return_inverse=True)
        counts = np.zeros(len(uniq_p), np.int64)
        np.add.at(counts, inv, allc)
        uniq = np.empty((len(uniq_p), G), np.int32)
        rem = uniq_p
        for g in range(G - 1, -1, -1):
            uniq[:, g] = (rem % radices[g]).astype(np.int32)
            rem = rem // radices[g]
        return uniq, counts
    if not acc:
        return np.zeros((0, G), np.int32), np.zeros(0, np.int64)
    uniq = np.array(sorted(acc), np.int32).reshape(len(acc), G)
    counts = np.array([acc[tuple(int(v) for v in r)] for r in uniq],
                      np.int64)
    return uniq, counts


def stratified_split(virt: VirtualCircuit, head_labels: int):
    """Split the label grid for the stratified estimator: the up-to-
    ``head_labels`` heaviest labels (by sampling-magnitude product
    ``prod_g m_g(v_g)``) are enumerated EXACTLY; only the tail is
    sampled, from its conditional distribution with 1-norm
    ``gamma_tail`` — the estimator variance drops from ``gamma_total^2``
    to ``gamma_tail^2`` (control-variate/stratification role of
    CV4Quantum, arXiv:2502.08735, PAPERS.md; skewed rzz/cp products make
    gamma_tail << gamma_total).

    Head membership is purely weight-based (``w > threshold``, ties
    excluded) so a sampled label's side is decidable from its own
    weight.  Returns ``None`` when no strict-majority head exists
    (uniform cuts: every weight equal), head_labels <= 0, or the flat
    grid exceeds host memory (total > 2^22 — exactly the regime the
    plain estimator serves; a warning is logged); else
    ``(head_rows [H, G] int32, head_mass [H], threshold, gamma_head,
    gamma_tail)``."""
    specs = [vg.spec for vg in virt.vgates]
    if head_labels <= 0 or not specs:
        return None
    gstride, n_inst, total = label_strides(specs, range(len(specs)))
    if total > (1 << 22):
        get_logger(__name__).warning(
            f"stratified head disabled: the flat label grid "
            f"({total} labels) exceeds 2^22; using the plain estimator"
        )
        return None
    w = label_weight_bounds(specs, gstride, n_inst, total)
    ws = np.sort(w)[::-1]
    # threshold at the (head_labels+1)-th largest weight so the head
    # holds UP TO head_labels entries (strictly-greater keeps membership
    # decidable from a sample's own weight; ties at the threshold go to
    # the tail).  head_labels >= total admits the whole grid.
    t = float(ws[head_labels]) if head_labels < total else -1.0
    head_ids = np.nonzero(w > t)[0]
    if len(head_ids) == 0:
        return None
    gamma_head = float(w[head_ids].sum())
    gamma_tail = float(w.sum() - gamma_head)
    rows = np.stack([
        ((head_ids // gstride[g]) % n_inst[g]).astype(np.int32)
        for g in range(len(specs))
    ], axis=1)
    return rows, w[head_ids], t, gamma_head, gamma_tail


def _sample_tail_counts(
    virt: VirtualCircuit, num_samples: int, threshold: float,
    seed: int = 0, method: str = "iid",
) -> tuple[np.ndarray, np.ndarray]:
    """(unique tail labels [L, G], counts [L]): rejection-sample the
    product distribution, keeping draws whose magnitude product is
    <= threshold (the tail side of :func:`stratified_split`) until
    ``num_samples`` are accepted.  Acceptance rate is
    gamma_tail / gamma_total, so drawing cost stays
    gamma_tail * gamma_total / eps^2 — below the plain estimator's
    gamma_total^2 / eps^2 whenever a head exists (draws are capped by
    sample_label_counts' max_draws, which fails loudly)."""
    mags = [_variant_magnitudes(vg.spec) for vg in virt.vgates]

    def accept(labels):
        w = np.ones(len(labels), np.float64)
        for g, m in enumerate(mags):
            w *= m[labels[:, g]]
        return w <= threshold

    return sample_label_counts(virt, num_samples, seed, accept=accept,
                               method=method)


def _sign_weights(virt: VirtualCircuit, frag_name: str) -> list[np.ndarray]:
    """fold_weights with each owner-side coefficient normalised by its
    variant's sampling magnitude ``max_b |coef[v, b]|`` (the same ``m``
    :func:`sample_labels` draws with — the two MUST share the convention
    for unbiasedness).  Non-owner rows are ones (max 1, no-op).
    Zero-magnitude variants are never sampled; guard the division."""
    out = []
    for w in fold_weights(virt, frag_name):
        w = np.asarray(w, np.float64)
        mag = np.maximum(np.abs(w[:, 0]), np.abs(w[:, 1]))
        out.append(w / np.where(mag > 0, mag, 1.0)[:, None])
    return out


def _measured_here(virt, frag_name) -> dict[int, np.ndarray]:
    """vgate -> bool[n_inst]: does THIS fragment hold the measuring
    endpoint of variant v?  (The measuring side is always the owner —
    virt/tables.py owner_side convention — so exactly one fragment
    measures per measuring variant.)"""
    prog = virt.programs[frag_name]
    out: dict[int, np.ndarray] = {}
    for slot in prog.slots:
        spec = virt.vgates[slot.vgate_idx].spec
        m = np.array(
            [pair[slot.side].measure for pair in spec.endpoints], bool
        )
        g = slot.vgate_idx
        out[g] = out[g] | m if g in out else m
    return out


def _label_has_measure(virt, labels: np.ndarray) -> np.ndarray:
    """bool[L]: does the label's variant measure on ANY cut (either
    side)?  Labels without measuring variants are collapse-noise-free."""
    lab = np.asarray(labels)
    has = np.zeros(lab.shape[0], bool)
    for g, vg in enumerate(virt.vgates):
        m = np.array(
            [p[0].measure or p[1].measure for p in vg.spec.endpoints], bool
        )
        has |= m[lab[:, g]]
    return has


def _expand_measuring_counts(virt, uniq, counts, cap=None):
    """Replicate measuring unique labels so every SAMPLE gets its own
    independent collapse draw (collapse-mode rows are one-draw stochastic
    estimates; sharing a draw across a label's count would make the
    second-moment stderr underestimate the collapse noise — measured 7+
    sigma on qft-6 before this fix).  ``cap`` bounds replicas per label
    (cap=None = full per-sample independence, the honest default); with a
    cap the residual stderr understatement is <= count/cap on the capped
    (heavy, low-collapse-noise) labels.  Returns (labels [L', G],
    float_counts [L']) with sum(float_counts) == sum(counts)."""
    has = _label_has_measure(virt, uniq)
    c = counts.astype(np.int64)
    r = np.where(has, c if cap is None else np.minimum(c, int(cap)), 1)
    r = np.maximum(r, 1)
    labels = np.repeat(uniq, r, axis=0)
    fcounts = np.repeat(counts / r, r)
    return labels, fcounts


def _expand_measuring_mass(virt, rows, w, reps):
    """Head-path twin of :func:`_expand_measuring_counts`: exact-mass
    labels have no counts, so measuring labels get a fixed ``reps``
    independent draws (mass split evenly)."""
    has = _label_has_measure(virt, np.asarray(rows))
    r = np.where(has, max(1, int(reps)), 1)
    return np.repeat(rows, r, axis=0), np.repeat(np.asarray(w) / r, r)


def _collapse_head_groups(virt, head_rows, head_w, reps, est_fn,
                          control_variate, values, rebuild):
    """Collapse-mode stratified head with an HONEST stderr contribution.

    Head rows in collapse mode are one-draw stochastic estimates
    (expanded to ``reps`` independent draws per measuring label), NOT
    exact enumerations — treating the head as exact reports a standard
    error that omits its collapse noise entirely (zero when
    gamma_tail <= 0), the same failure mode
    :func:`_expand_measuring_counts` fixed on the tail (measured 7+
    sigma there).  The head mean is therefore computed from K
    independent replicate groups — the SAME total draw budget, ``reps``
    split across groups with distinct collapse seeds — and its
    per-outcome variance estimated as the sample variance of the group
    means / K (K-1 degrees of freedom; conservative-noisy but honest,
    and exactly zero at outcomes no collapse draw reaches).

    ``est_fn(rows, w, seed_offset)`` runs one group's estimate;
    ``values``/``rebuild`` adapt Distribution vs ndarray heads.
    Returns ``(head_est, head_var, head_stats)``; ``head_stats`` carries
    the control-variate ``y_mean`` (exact regardless of draws: collapse
    preserves row totals), or None.
    """
    K = 4 if reps >= 4 else 2
    g_rows, g_w = _expand_measuring_mass(
        virt, head_rows, head_w, max(1, reps // K)
    )
    groups, y_means = [], []
    template = None
    for k in range(K):
        out_k = est_fn(g_rows, g_w, 7717 * k)
        if control_variate:
            out_k, stats_k = out_k
            y_means.append(stats_k["y_mean"])
        template = out_k
        groups.append(np.asarray(values(out_k), np.float64))
    gm = np.stack(groups)
    head = rebuild(template, gm.mean(axis=0))
    head_var = gm.var(axis=0, ddof=1) / K
    stats = {"y_mean": float(np.mean(y_means))} if control_variate \
        else None
    return head, head_var, stats


def _collapse_flags(virt, collapse) -> list[bool]:
    """Per-fragment collapse-mode decision.  ``collapse``: True / False /
    "auto" — auto collapses a fragment when its ancilla-extended width
    is infeasible (> 2^24 states) or the deferral ancillas inflate the
    row width by > 2^8 over the data qubits (qft-16's lone-qubit
    fragment: 1 data + 15 ancillas)."""
    if isinstance(collapse, (list, tuple)):
        return [bool(c) for c in collapse]
    out = []
    for reg in virt.fragments:
        prog = virt.programs[reg.name]
        if collapse == "auto":
            out.append(
                prog.num_sim_qubits > 24
                or prog.num_sim_qubits - prog.num_data_qubits > 8
            )
        else:
            out.append(bool(collapse))
    return out


def _noise_models(virt: VirtualCircuit, noise):
    """Normalise ``noise`` into a per-fragment NoiseModel list (None =
    exact), with the reference's untranspiled-fragment semantics
    (ops/noise.run_noisy_virtual_circuit: fragments of an untranspiled
    model run noise-free — their instantiations' gates match no
    calibration entry).  None when no fragment is noisy."""
    if noise is None:
        return None
    if isinstance(noise, (list, tuple)):
        models = list(noise)
    else:
        models = [noise] * len(virt.fragments)
    if len(models) < len(virt.fragments):
        raise ValueError(f"{len(models)} noise models for "
                         f"{len(virt.fragments)} fragments")
    models = [
        None if (m is not None and getattr(m, "untranspiled", False))
        else m
        for m in models[: len(virt.fragments)]
    ]
    return None if all(m is None for m in models) else models


def _cv_adjust(est_values, m2, stats, y_expect):
    """Per-outcome control-variate regression (CV4Quantum role,
    arXiv:2502.08735, PAPERS.md — adapted from observable PEC to
    distribution knitting).

    X(x) = per-sample weighted signed-knit value at outcome x;
    Y = per-sample weighted signed TOTAL mass, with EXACT expectation
    ``y_expect`` (1 for the plain estimator; the tail's exact mass for
    the stratified tail).  The adjusted estimator

        X_cv(x) = X(x) - beta(x) * (Y - y_expect),
        beta(x) = Cov(X(x), Y) / Var(Y)

    stays unbiased up to the O(1/N) plug-in-beta term (beta estimated
    from the same sample — standard, vanishes as 1/N) and has variance
    Var(X)(1 - rho^2): the shared +/-gamma sign-product noise, the
    dominant variance source on coherent plans, cancels wherever X(x)
    tracks the total.  Returns ``(adjusted_values, adjusted_var)``
    with ``adjusted_var`` the per-outcome variance of X_cv (divide by N
    for the squared stderr)."""
    var_y = max(stats["y2"] - stats["y_mean"] ** 2, 0.0)
    var_x = np.maximum(m2 - est_values**2, 0.0)
    if var_y <= 1e-30:  # degenerate Y (single label / constant totals)
        return est_values, var_x
    cov = stats["xy"] - est_values * stats["y_mean"]
    beta = cov / var_y
    adj = est_values - beta * (stats["y_mean"] - y_expect)
    adj_var = np.maximum(var_x - cov * cov / var_y, 0.0)
    return adj, adj_var


# ---------------------------------------------------------------------------
# Per-label rows (torch)
# ---------------------------------------------------------------------------

def _fold_rows_per_label(virt, frag_name, rows, lab, positions,
                         weights=None):
    """Contract a fragment's vgate clbits out of per-label rows.

    ``rows``: [L, 2^k] per-unique-label outcome rows; ``lab``: [L, G]
    global label matrix (int64, on the rows' device); ``positions``:
    ascending global clbit ids (bit j of the row index carries
    positions[j]).  Returns ([L, 2^d], data positions) with each touching
    vgate's measure clbit contracted by its per-label sign weight (owner)
    or summed out (other endpoint).  ``weights``: the fragment's
    :func:`_sign_weights` already on the device.

    PARITY-CRITICAL twin of the exact fold (ops/streamed._apply_fold, the
    kernel's fold epilogue): the owner-side rule, the structurally-zero
    clbit branch, and the bit-split convention must stay in lockstep (the
    full-grid identity test catches drift).
    """
    prog = virt.programs[frag_name]
    touching = list(prog.touching)
    if weights is None:
        weights = to_device(_sign_weights(virt, frag_name), rows.device,
                            rows.dtype)
    positions = list(positions)
    k = len(positions)
    t = rows
    L = t.shape[0]
    for ti, g in enumerate(touching):
        wl = weights[ti][lab[:, g]]            # [L, 2] per-label weights
        cg = virt.num_clbits + g
        if cg in positions:
            j = positions.index(cg)
            high, low = 1 << (k - 1 - j), 1 << j
            t = t.reshape(L, high, 2, low)
            t = (
                t[:, :, 0, :] * wl[:, 0, None, None]
                + t[:, :, 1, :] * wl[:, 1, None, None]
            )
            positions.pop(j)
            k -= 1
            t = t.reshape(L, 1 << k)
        else:
            # clbit structurally zero in this fragment
            t = t * wl[:, 0, None]
    return t, positions


def _marginalize_rows(t, positions, keep_clbits):
    """Sum out data bits not in ``keep_clbits`` (marginal estimate)."""
    positions = list(positions)
    k = len(positions)
    L = t.shape[0]
    for p in [p for p in positions if p not in keep_clbits]:
        j = positions.index(p)
        high, low = 1 << (k - 1 - j), 1 << j
        t = t.reshape(L, high, 2, low).sum(dim=2)
        positions.pop(j)
        k -= 1
        t = t.reshape(L, 1 << k)
    return t, positions


def _collapse_tables(virt, frag_name, sids, dev):
    """Collapse mode's per-variant scalars for one fragment, on ``dev``:
    ``(site_tabs, fold)``.  ``site_tabs[i] = (vgate, [n_inst, 3] (mflag,
    w0, w1))`` for the collapse site at slot ``sids[i]``: variants
    measuring there fold at the site with ``w[v, b]``.  ``fold(lab)`` is
    every other variant's coefficient as ONE per-label scalar ``[l]``
    (``w[v, 0]``: owner-non-measuring, or 1 for non-owner rows), or None
    without a touching vgate — the convention of
    :func:`_fold_rows_per_label`."""
    prog = virt.programs[frag_name]
    weights = _sign_weights(virt, frag_name)
    ti_of = {g: i for i, g in enumerate(prog.touching)}
    mh = _measured_here(virt, frag_name)
    site_tabs = []
    for sid in sids:
        slot = prog.slots[sid]
        spec = virt.vgates[slot.vgate_idx].spec
        mrow = np.array(
            [1.0 if p[slot.side].measure else 0.0 for p in spec.endpoints],
            np.float32,
        )
        w = np.asarray(weights[ti_of[slot.vgate_idx]], np.float32)
        site_tabs.append((slot.vgate_idx, to_device(
            np.stack([mrow, w[:, 0], w[:, 1]], axis=1), dev)))
    nonmeas = [
        (g, to_device(np.where(mh[g], 1.0, np.asarray(weights[ti])[:, 0])
                      .astype(np.float32), dev))
        for ti, g in enumerate(prog.touching)
    ]

    def fold(lab):
        nm = None
        for g, tab in nonmeas:
            f = tab[lab[:, g]]
            nm = f if nm is None else nm * f
        return nm

    return site_tabs, fold


def _collapse_row_builder_pallas(virt, frag_name, dtype=None,
                                 keep_clbits=None, z_sets=None,
                                 device=None):
    """``(fn, positions, n_collapse_sites, width)`` for a collapse-mode
    fragment, its per-label simulation from the collapse kernel
    (ops/collapse_kernel.make_collapse_chunk_kernel: the mid-circuit
    collapse runs in the kernel).  ``fn(lab [l, G] int64, u [l,
    >= n_sites] f32) -> (rows [l, 2^d], positions)`` on ``device``; the
    uniform draws come in as an argument, and the rows come back FULLY
    folded over the vgate clbits: variants measuring HERE fold at the
    collapse site with ``w[v, b]``; every other variant multiplies by
    ``w[v, 0]`` (owner-non-measuring coefficient, or 1 for non-owner
    rows), the convention of :func:`_fold_rows_per_label`.  Returns None
    where the kernel does not serve the request (more than 128 kept
    outcomes or z columns, a state past 20 qubits, a non-f32 dtype).

    ``keep_clbits``: the in-kernel marginal: ``positions`` are the kept
    clbits and rows are ``[l, 2^|kept|]`` (:func:`_marginalize_rows` then
    no-ops downstream).  ``z_sets``: the in-kernel Z columns: rows are
    ``[l, n_z + 1]`` signed contributions plus the total column, and
    ``fn.z_pre`` is True so the scan skips its sign-matrix product.
    ``fn.rows_fn`` is the kernel's chunk function (its ``plan`` and the
    last call's picked bits), ``fn.scalars(lab, u)`` the kernel's
    per-label scalar block."""
    if dtype is not None and dtype != torch.float32:
        return None
    dev = resolve_device(device)
    built = make_collapse_chunk_kernel(
        virt, frag_name, keep_clbits=keep_clbits, z_sets=z_sets, device=dev,
    )
    if built is None:
        return None
    rows_fn, positions, site_meta = built
    site_tabs, fold = _collapse_tables(virt, frag_name,
                                       [sid for sid, _ in site_meta], dev)

    def scalars(lab, u):
        """``[l, n_sites, 4]`` (u, mflag, w0, w1) per collapse site."""
        if not site_tabs:
            return torch.zeros((lab.shape[0], 1, 4), dtype=torch.float32,
                               device=dev)
        return torch.stack([
            torch.cat([u[:, si, None], tab[lab[:, g]]], dim=1)
            for si, (g, tab) in enumerate(site_tabs)
        ], dim=1).contiguous()

    def fn(lab, u):
        rows = rows_fn(lab, scalars(lab, u))
        nm = fold(lab)
        return (rows if nm is None else rows * nm[:, None]), list(positions)

    fn.z_pre = z_sets is not None
    fn.rows_fn = rows_fn
    fn.scalars = scalars
    return fn, positions, len(site_meta), len(positions)


def _ancilla_row_builder_pallas(virt, frag_name, dtype=None, device=None):
    """Exact-path twin of :func:`_collapse_row_builder_pallas`: per-label
    rows with deferral ancillas from the variant kernel's full rows
    (ops/variant_kernel.make_chunk_kernel: the label matrix IS the
    kernel's per-chunk variant-index block, columns = global vgate ids),
    then the per-label fold.  ``fn(lab, u)`` ignores ``u``.  Same
    contract; None past the kernel's 20-qubit gate."""
    if dtype is not None and dtype != torch.float32:
        return None
    dev = resolve_device(device)
    built = make_chunk_kernel(virt, frag_name, _MAX_BLOCK, device=dev)
    if built is None:
        return None
    rows_fn, positions = built
    weights = to_device(_sign_weights(virt, frag_name), dev, torch.float32)

    def fn(lab, u):
        return _fold_rows_per_label(
            virt, frag_name, rows_fn(lab), lab, list(positions),
            weights=weights,
        )

    fn.rows_fn = rows_fn
    prog = virt.programs[frag_name]
    width = max(prog.num_sim_qubits, len(positions))
    return fn, list(positions), 0, width


def _collapse_row_builder(virt, frag_name, dtype=None, device=None):
    """Twin of :func:`_collapse_row_builder_pallas` without a kernel: the
    same ``(fn, positions, n_collapse_sites, width)`` contract, the same
    weight convention and draws, the simulation from
    ``variant_engine.make_sim_fn(collapse=True)`` (every label of a block
    one row of a batched state; a bf16 ``dtype`` keeps bf16 states and
    float32 rows).  ``fn(lab, u, picks=None)``: ``picks`` (a list)
    collects the branch picks (``variant_engine.picked_bits``).
    ``fn.state`` is ``(state qubits, row bits, 1)`` for the scan's block
    size, ``fn.sites`` the collapse sites' slot ids in the order of the
    draws' columns (the collapse kernel's ``site_meta`` order)."""
    dev = resolve_device(device)
    prog = virt.programs[frag_name]
    sim_fn, _, positions, _ = make_sim_fn(
        virt, frag_name, build_matrices=False, collapse=True, dtype=dtype,
    )
    tables = [to_device(list(t), dev, sim_fn.dtype) for t in _slot_tables(
        prog, [vg.spec for vg in virt.vgates], fused=False)]
    sids = sim_fn.collapse_slots
    site_tabs, fold = _collapse_tables(virt, frag_name, sids, dev)

    def fn(lab, u, picks=None):
        cargs = {sid: (u[:, ui], *tab[lab[:, g]].unbind(dim=1))
                 for ui, (sid, (g, tab)) in enumerate(zip(sids, site_tabs))}
        if prog.slots:
            mats = [tuple(t[lab[:, slot.vgate_idx]] for t in tabs)
                    for slot, tabs in zip(prog.slots, tables)]
            rows = sim_fn(mats, cargs, dev, picks)
        else:
            rows = sim_fn([], cargs, dev).expand(lab.shape[0], -1)
        nm = fold(lab)
        return (rows if nm is None else rows * nm[:, None]), list(positions)

    fn.state = (len(sim_fn.active_final), len(positions), 1)
    fn.sites = list(sids)  # slot id a draw column
    width = max(len(sim_fn.active_final), len(positions))
    return fn, positions, len(site_tabs), width


def _simulate_label_rows_collapse(virt, frag_name, lab, seed: int,
                                  dtype=None, device=None):
    """``([L, 2^d] rows, data positions)``: every label's rows with the
    vgate measurements collapsed in the simulation and the fold weights
    applied, from ``default_rng(seed)`` draws, without a kernel — unbiased
    one-draw estimates of the exact folded rows (the JAX package's
    function)."""
    dev = resolve_device(device)
    fn, positions, n_sites, _ = _collapse_row_builder(
        virt, frag_name, dtype=dtype, device=dev)
    lab = to_device(np.asarray(lab, np.int64), dev)
    u = np.random.default_rng(seed).random(
        (lab.shape[0], max(1, n_sites))).astype(np.float32)
    rows, _ = fn(lab, to_device(u, dev))
    return rows, positions


def _label_rows_fn(virt, frag_name, dtype, dev):
    """``(rows_fn, positions, sim_fn)``: ``rows_fn(lab [l, G])`` is every
    label's probability row with deferral ancillas, ``[l, 2^k]`` float32
    (slot tables gathered by the label's per-vgate variant index), from
    ``make_sim_fn(fused_slots=True, dtype=dtype)``."""
    prog = virt.programs[frag_name]
    sim_fn, _, positions, _ = make_sim_fn(
        virt, frag_name, build_matrices=False, fused_slots=True,
        dtype=dtype,
    )
    tables = [to_device(list(t), dev, sim_fn.dtype) for t in _slot_tables(
        prog, [vg.spec for vg in virt.vgates], fused=True)]

    def rows_fn(lab):
        if not prog.slots:
            return sim_fn([], dev).expand(lab.shape[0], -1)
        return sim_fn([tuple(t[lab[:, slot.vgate_idx]] for t in tabs)
                       for slot, tabs in zip(prog.slots, tables)])

    return rows_fn, list(positions), sim_fn


def _ancilla_row_builder(virt, frag_name, dtype=None, device=None):
    """Twin of :func:`_ancilla_row_builder_pallas` without a kernel:
    ``fn(lab, u)`` (u ignored) simulates with deferral ancillas
    (:func:`_label_rows_fn`), then folds the vgate clbits per label.
    Same ``(fn, positions, n_sites, width)`` contract."""
    dev = resolve_device(device)
    rows_fn, positions, sim_fn = _label_rows_fn(virt, frag_name, dtype, dev)
    weights = to_device(_sign_weights(virt, frag_name), dev, torch.float32)

    def fn(lab, u=None):
        return _fold_rows_per_label(virt, frag_name, rows_fn(lab), lab,
                                    positions, weights=weights)

    fn.state = (len(sim_fn.active_final), len(positions), 1)
    width = max(len(sim_fn.active_final), len(positions))
    return fn, positions, 0, width


def _simulate_label_rows(virt, frag_name, lab, dtype=None, device=None):
    """``([L, 2^k] rows, positions)``: a fragment's probability rows at
    each label, unfolded, without a kernel.  ``dtype``: bf16 states (rows
    still float32)."""
    dev = resolve_device(device)
    rows_fn, positions, _ = _label_rows_fn(virt, frag_name, dtype, dev)
    return rows_fn(to_device(np.asarray(lab, np.int64), dev)), positions


def _noisy_row_builder(virt, frag_name, nm, device=None):
    """Trajectory-noise rows for the scan, the sampled-label restriction
    of ``ops/noise.run_fragment_noisy`` (no kernel runs noise):
    ``(fn, positions, 0, width)`` with ``fn(lab, draws)`` the block's
    rows folded over the vgate clbits, each label's trajectories
    averaged inside the block, then the calibrated readout channel.

    ``fn.prepare(L, seed)`` makes the draws of all ``L`` labels before
    any blocking, the JAX package's (``default_rng(seed)``, every site's
    ``[L, trajectories]`` branch indices, balanced per label across its
    trajectories): an ``[L, T, S]`` index tensor the scan slices a block
    at a time, or for a fragment without slots its one averaged row
    (``T`` trajectories shared by every label) expanded to ``L``.
    ``fn.rows(lab, draws)`` gives the unfolded rows; ``fn.state`` is
    ``(state qubits, row bits, T)``.  A PEC model raises ValueError."""
    from .noise import (
        _apply_rows_readout,
        _site_active,
        _site_idx,
        fragment_readout_qubits,
    )

    dev = resolve_device(device)
    prog = virt.programs[frag_name]
    specs = [vg.spec for vg in virt.vgates]
    sim_fn, _, positions, _ = make_sim_fn(virt, frag_name, noise=nm,
                                          build_matrices=False)
    if any(w is not None for (*_, w) in sim_fn.noise_sites):
        raise ValueError(
            "PEC (signed quasi-sites) is batched-engine-only: "
            "run_noisy_virtual_circuit(engine='auto')")
    site_tabs = [(pr, bank) for (_, _, pr, bank, _) in sim_fn.noise_sites]
    k_traj = (nm.trajectories
              if any(_site_active(pr) for pr, _ in site_tabs) else 1)
    cq = fragment_readout_qubits(virt, frag_name, sim_fn)
    site_banks = {s: to_device(sim_fn.site_banks[s], dev)
                  for s in sim_fn.active_sites}
    tables = [to_device(list(t), dev) for t in _slot_tables(prog, specs)]
    gcols = [slot.vgate_idx for slot in prog.slots]
    sim = _SimRows(sim_fn, tables, gcols, None, 0, specs, dev,
                   torch.float32, site_banks)
    weights = to_device(_sign_weights(virt, frag_name), dev, torch.float32)

    def prepare(count, seed):
        rng = np.random.default_rng(seed)
        if prog.slots:
            if not site_tabs:
                return None
            return to_device(_sample_pauli_indices(rng, site_tabs, count,
                                                   k_traj), dev, torch.int64)
        if k_traj > 1:
            idx = [_site_idx(rng, pr, (k_traj,), balance_axis=0)
                   for pr, _ in site_tabs]
            row = sim_fn([], dev, {
                s: site_banks[s][to_device(idx[s], dev, torch.int64)]
                for s in sim_fn.active_sites}).mean(dim=0, keepdim=True)
        else:
            row = sim_fn([], dev)
        return _apply_rows_readout(row, positions, nm, cq).expand(count, -1)

    def rows(lab, draws):
        if not prog.slots:
            return draws
        if draws is None:  # no noise site: the exact rows
            out = sim_fn([tuple(t[lab[:, g]] for t in tabs)
                          for g, tabs in zip(gcols, tables)], dev)
        else:
            out = sim.noisy_rows(lab, draws)
        return _apply_rows_readout(out, positions, nm, cq)

    def fn(lab, draws):
        return _fold_rows_per_label(virt, frag_name, rows(lab, draws), lab,
                                    positions, weights=weights)

    fn.prepare, fn.rows = prepare, rows
    fn.state = (len(sim_fn.active_final), len(positions), k_traj)
    width = max(len(sim_fn.active_final), len(positions))
    return fn, list(positions), 0, width


def _simulate_label_rows_noisy(virt, frag_name, lab, nm, seed: int,
                               device=None):
    """``([L, 2^k] rows, positions)``: every label's trajectory-averaged
    noisy rows with the calibrated readout channel applied, unfolded (the
    JAX package's function, on :func:`_noisy_row_builder`): the draws
    made for all ``L`` labels from ``default_rng(seed)``, the simulation
    in blocks of :func:`_label_block`'s bytes."""
    dev = resolve_device(device)
    fn, positions, _, _ = _noisy_row_builder(virt, frag_name, nm, dev)
    lab = to_device(np.asarray(lab, np.int64), dev)
    count = lab.shape[0]
    draws = fn.prepare(count, seed)
    block = _block_of(_state_bytes(fn.state))
    parts = [fn.rows(lab[s:s + block],
                     None if draws is None else draws[s:s + block])
             for s in range(0, count, block)]
    return (torch.cat(parts) if parts else torch.zeros(
        (0, 1 << len(positions)), device=dev)), positions


def _row_floats(virt, frag_name, collapse: bool, keep_clbits, z_sets) -> int:
    """Floats per label of the rows one fragment's kernel row function
    hands back."""
    prog = virt.programs[frag_name]
    if not collapse:
        return 1 << prog.num_sim_qubits
    if z_sets is not None and len(z_sets) + 1 <= MAX_OUTCOMES:
        return len(z_sets) + 1
    if keep_clbits is not None:
        kept = [c for c in prog.clbit_sources
                if c < virt.num_clbits and c in set(keep_clbits)]
        if (1 << len(kept)) <= MAX_OUTCOMES:
            return 1 << len(kept)
    return 1 << prog.num_data_qubits


def _state_bytes(state) -> int:
    """Bytes per label of a row function without a kernel, ``state =
    (state qubits, row bits, trajectories)``: every trajectory's float32
    states (``_STATE_COPIES`` of them live in a pass) and its full row,
    then the label's row, its square and two temporaries of the fold."""
    w, k, traj = state
    return traj * (_STATE_COPIES * (8 << w) + (4 << k)) + (16 << k)


def _block_of(per_label: int) -> int:
    return int(max(1, min(_MAX_BLOCK, _CHUNK_BYTES_BUDGET // per_label)))


def _label_block(virt, flags, keep_clbits=None, z_sets=None,
                 states=None) -> int:
    """Labels per scan block, from bytes on the card: every fragment's
    rows stay inside ``ops/streamed._CHUNK_BYTES_BUDGET`` together; at
    most ``_MAX_BLOCK``.  A kernel's rows count with their square and two
    temporaries of the fold (f32; the collapse kernel's state scratch is
    per CUDA block, not per label); ``states[fi]``, where a fragment's
    rows come without a kernel (``fn.state`` of its builder), counts its
    whole states and full rows (:func:`_state_bytes`).  ``states=None``:
    a kernel serves every fragment."""
    states = states or [None] * len(virt.fragments)
    per_label = sum(
        16 * _row_floats(virt, r.name, flags[fi], keep_clbits, z_sets)
        if states[fi] is None else _state_bytes(states[fi])
        for fi, r in enumerate(virt.fragments)
    )
    return _block_of(per_label)


def _model_key(nm):
    """A hashable identity of a noise model: every field, arrays by
    bytes."""
    import dataclasses

    def frozen(v):
        if isinstance(v, np.ndarray):
            return (v.dtype.str, v.shape, v.tobytes())
        if isinstance(v, (list, tuple)):
            return tuple(frozen(x) for x in v)
        return v

    if nm is None:
        return None
    return tuple((f.name, frozen(getattr(nm, f.name)))
                 for f in dataclasses.fields(nm))


def _build_scan(virt, flags, keep_clbits, z_sets, dev, pallas_variant=True,
                dtype=None, noise=None):
    """The per-fragment row functions of one scan, on ``dev``: a noisy
    fragment's from :func:`_noisy_row_builder`; with ``pallas_variant``
    a kernel's where one serves the fragment (the collapse kernel, for a
    marginal or Z columns past its 128 outputs its full rows; the
    variant kernel's full rows), and the route without a kernel for every
    other fragment (past a kernel's width, a bf16 ``dtype``,
    ``pallas_variant=False``)."""
    row_fns, pos_raw, ns_raw, states, collapse, routes = [], [], [], [], \
        [], []
    for fi, reg in enumerate(virt.fragments):
        nm = None if noise is None else noise[fi]
        built = None
        if nm is not None:
            built, route = _noisy_row_builder(virt, reg.name, nm, dev), \
                "noisy, no kernel"
        elif flags[fi]:
            route = "collapse kernel"
            if pallas_variant:
                built = _collapse_row_builder_pallas(
                    virt, reg.name, dtype=dtype, keep_clbits=keep_clbits,
                    z_sets=z_sets, device=dev,
                ) or _collapse_row_builder_pallas(
                    # past the in-kernel marginal / z columns: full rows,
                    # reduced in torch by the scan
                    virt, reg.name, dtype=dtype, device=dev)
            if built is None:
                built, route = _collapse_row_builder(
                    virt, reg.name, dtype=dtype, device=dev), \
                    "collapse, no kernel"
        else:
            route = "variant kernel"
            if pallas_variant:
                built = _ancilla_row_builder_pallas(virt, reg.name,
                                                    dtype=dtype, device=dev)
            if built is None:
                built, route = _ancilla_row_builder(
                    virt, reg.name, dtype=dtype, device=dev), \
                    "ancilla, no kernel"
        fn, pos, ns, _w = built
        row_fns.append(fn)
        pos_raw.append(list(pos))
        ns_raw.append(ns)
        states.append(getattr(fn, "state", None))
        collapse.append(bool(flags[fi]) and nm is None)
        routes.append(route)
    bf16 = dtype is not None and dtype != torch.float32
    get_logger(__name__).info(
        "sampled engine: "
        + ", ".join(f"{r.name}: {route}"
                    for r, route in zip(virt.fragments, routes))
        + (" (kernels run float32 states only: bf16 runs without a kernel)"
           if bf16 and pallas_variant else "")
    )
    return {"row_fns": row_fns, "ns": ns_raw, "pos_raw": pos_raw,
            "states": states, "collapse": collapse, "routes": routes}


def _scan_core(
    virt: VirtualCircuit,
    labels: np.ndarray,
    mass: np.ndarray,
    *,
    z_sets=None,
    keep_clbits=None,
    second_moment: bool = False,
    control_stats: bool = False,
    gamma_override: float | None = None,
    dtype=None,
    flags=None,
    collapse_seed: int = 0,
    block: int | None = None,
    pallas_variant: bool = True,
    mesh=None,
    noise=None,
    noise_seed: int = 0,
    device=None,
):
    """The blocked estimate behind :func:`_estimate` / :func:`_estimate_z`:
    a loop over label blocks accumulates the weighted knit (and the
    optional second-moment / control-variate statistics) on ``device``
    (None = "cuda"), so the peak buffer is ``block x 2^width`` instead of
    ``L x 2^width``.  The collapse draws and the trajectory-noise draws
    (``noise``: one model or None a fragment, ``noise_seed``) are made
    for all ``L`` labels before blocking, so the estimate does not depend
    on ``block`` beyond f32 summation order.  ``block=None``: from the
    routes' bytes (:func:`_label_block`).

    The built scan (each fragment's plan and tables on the device) is
    cached on ``virt`` (``_scan_step_cache``), keyed by what the row
    functions depend on: the label width, the collapse flags, the kept
    clbits, the z-sets, the device, ``pallas_variant``, the dtype and
    the noise models.  A repeat estimate builds no plan again."""
    _refuse_mesh(mesh)
    dev = resolve_device(device)
    gamma_total = (
        sampling_overhead(virt)["gamma_total"]
        if gamma_override is None else float(gamma_override)
    )
    lab_np = np.asarray(labels, np.int32)
    mass = np.asarray(mass, np.float64)
    L, G = lab_np.shape
    flags = list(flags) if flags is not None \
        else [False] * len(virt.fragments)

    key = (
        "scan", G, tuple(flags),
        None if keep_clbits is None else tuple(sorted(keep_clbits)),
        None if z_sets is None
        else tuple(tuple(sorted(s)) for s in z_sets),
        str(dev), bool(pallas_variant),
        None if dtype is None else str(dtype),
        None if noise is None else tuple(_model_key(m) for m in noise),
    )
    cache = virt.__dict__.setdefault("_scan_step_cache", {})
    ent = cache.get(key)
    if ent is None:
        ent = _build_scan(virt, flags, keep_clbits, z_sets, dev,
                          pallas_variant=pallas_variant, dtype=dtype,
                          noise=noise)
        cache[key] = ent
    block = (_label_block(virt, flags, keep_clbits, z_sets, ent["states"])
             if block is None else max(1, int(block)))
    row_fns = ent["row_fns"]
    z_pre = [bool(getattr(fn, "z_pre", False)) for fn in row_fns]
    keep_set = None if keep_clbits is None else set(keep_clbits)
    pos_static = []
    for fi, pos in enumerate(ent["pos_raw"]):
        pos_f = [p for p in pos
                 if ent["collapse"][fi] or p < virt.num_clbits]
        if keep_set is not None:
            pos_f = [p for p in pos_f if p in keep_set]
        pos_static.append(pos_f)

    # the draws are data: all L labels at once, fragment by fragment
    data = []
    for fi, ns in enumerate(ent["ns"]):
        if ent["collapse"][fi]:
            rng = np.random.default_rng(collapse_seed + 7919 * fi)
            data.append(to_device(
                rng.random((L, max(1, ns))).astype(np.float32), dev))
        elif noise is not None and noise[fi] is not None:
            data.append(row_fns[fi].prepare(L, noise_seed + fi))
        else:
            data.append(None)
    lab_dev = to_device(lab_np, dev, torch.int64)
    w_dev = to_device((mass * gamma_total).astype(np.float32), dev)
    w2_dev = to_device(
        (mass * (gamma_total * gamma_total)).astype(np.float32), dev
    )

    # output layout (dist mode): LAST fragment = LOW bits (the knit's
    # convention), then one permutation to ascending clbit order
    src_bits: list[int] = []
    for pos_f in reversed(pos_static):
        src_bits.extend(pos_f)
    dst_bits = sorted(src_bits)
    out_w = (1 << len(src_bits)) if z_sets is None else len(z_sets)
    stats = second_moment or control_stats
    # 'z' is the label axis — fragment letters must not collide with it
    letters = "abdefghijklm"
    assert len(row_fns) <= len(letters)
    expr = (
        "z," + ",".join(f"z{letters[i]}" for i in range(len(row_fns)))
        + "->" + letters[: len(row_fns)]
    )

    def _comb(w_c, rows_list):
        return torch.einsum(expr, w_c, *rows_list).reshape(-1)

    def zeros(n=None):
        return torch.zeros(() if n is None else n, dtype=torch.float32,
                           device=dev)

    est = zeros(out_w)
    m2 = zeros(out_w) if stats else zeros()
    ym, y2 = zeros(), zeros()
    xy = zeros(out_w) if control_stats else zeros()
    sign_mats = {}
    for s in range(0, L, block):
        e = min(L, s + block)
        lab_c, w_c, w2_c = lab_dev[s:e], w_dev[s:e], w2_dev[s:e]
        rows_list = []
        for fi, fn in enumerate(row_fns):
            d = data[fi]
            rows, pos = fn(lab_c, None if d is None else d[s:e])
            if keep_set is not None:
                rows, pos = _marginalize_rows(rows, pos, keep_set)
            assert pos == pos_static[fi], (pos, pos_static[fi])
            rows_list.append(rows)
        if z_sets is None:
            est += _comb(w_c, rows_list)
            if stats:
                m2 += _comb(w2_c, [r * r for r in rows_list])
        else:
            prodmat = None
            for fi, (rows, pos) in enumerate(zip(rows_list, pos_static)):
                # pre-reduced rows (in-kernel z) already carry the
                # signed contributions; others go through the matrix
                if z_pre[fi]:
                    sc = rows[:, : len(z_sets)]
                else:
                    if fi not in sign_mats:
                        sign_mats[fi] = _z_sign_matrix(pos, z_sets, dev)
                    sc = rows @ sign_mats[fi]
                prodmat = sc if prodmat is None else prodmat * sc
            est += w_c @ prodmat
            if stats:
                m2 += w2_c @ (prodmat * prodmat)
        if control_stats:
            totals = None
            for fi, r in enumerate(rows_list):
                t = (
                    r[:, len(z_sets)]
                    if (z_sets is not None and z_pre[fi])
                    else r.sum(dim=1)
                )
                totals = t if totals is None else totals * t
            ym += torch.dot(w_c, totals)
            y2 += torch.dot(w2_c, totals * totals)
            if z_sets is None:
                xy += _comb(w2_c * totals, rows_list)
            else:
                xy += (w2_c * totals) @ prodmat
    if z_sets is None and src_bits:
        est = permute_bits_flat(est, src_bits, dst_bits)
        if stats:
            m2 = permute_bits_flat(m2, src_bits, dst_bits)
        if control_stats:
            xy = permute_bits_flat(xy, src_bits, dst_bits)

    if z_sets is None:
        est_out = Distribution(est.cpu().numpy(), dst_bits, virt.num_clbits)
    else:
        est_out = est.cpu().numpy().astype(np.float64)
    if not stats:
        return est_out
    out = [est_out]
    if second_moment:
        out.append(m2.cpu().numpy().astype(np.float64))
    if control_stats:
        out.append({
            "y_mean": float(ym),
            "y2": float(y2),
            "xy": xy.cpu().numpy().astype(np.float64),
        })
    return tuple(out)


def _estimate(
    virt: VirtualCircuit,
    labels: np.ndarray,
    mass: np.ndarray,
    keep_clbits=None,
    second_moment: bool = False,
    dtype=None,
    gamma_override: float | None = None,
    control_stats: bool = False,
    noise=None,
    noise_seed: int = 0,
    collapse=None,
    collapse_seed: int = 0,
    pallas_variant: bool = True,
    mesh=None,
    device=None,
):
    """Core estimator: ``sum_l mass[l] * gamma_total * signed_knit(l)``.

    With ``labels`` = the full label grid and ``mass`` = each label's
    exact sampling probability this reproduces the exact knit (the
    identity the estimator is unbiased against — tested); with sampled
    unique labels and ``mass = counts / num_samples`` it is the
    Monte-Carlo estimate.

    ``second_moment``: also return ``E[X^2]`` per outcome (X = the
    per-sample weighted value ``gamma * signed_knit``; the per-label
    square factors over the disjoint fragment bit groups, so it is the
    same einsum over squared rows) — the ingredient for standard
    errors.

    ``gamma_override``: per-sample weight scale replacing gamma_total —
    the stratified tail samples from the CONDITIONAL distribution over
    tail labels, whose normalisation is gamma_tail (see
    :func:`stratified_split`).

    ``control_stats``: additionally return the control-variate moments
    built on the per-label signed TOTAL mass ``Y_l = gamma *
    total_l`` where ``total_l = prod_f sum_x folded_rows_f[l, x]``
    (marginalisation preserves row sums, so totals are keep_clbits-
    independent): ``{"y_mean": E^[Y], "y2": E^[Y^2], "xy": E^[X Y] per
    outcome}``.  ``E[Y] = sum_x exact_knit(x) = 1`` exactly (trace
    preservation), making Y a zero-cost control variate — see
    :func:`sampled_knit`'s ``control_variate``.

    ``noise``: one NoiseModel or None a fragment (a noisy fragment's
    rows average its trajectories, drawn from ``noise_seed + fi``, and go
    through its calibrated readout; :func:`_noisy_row_builder`).

    Every estimate goes through the blocked scan (:func:`_scan_core`),
    its block from :func:`_label_block`."""
    flags = list(collapse) if collapse is not None else \
        [False] * len(virt.fragments)
    return _scan_core(
        virt, labels, mass, keep_clbits=keep_clbits,
        second_moment=second_moment, control_stats=control_stats,
        gamma_override=gamma_override, dtype=dtype, flags=flags,
        collapse_seed=collapse_seed, pallas_variant=pallas_variant,
        mesh=mesh, noise=noise, noise_seed=noise_seed, device=device,
    )


def sampled_knit_adaptive(
    virt: VirtualCircuit,
    eps: float,
    seed: int = 0,
    keep_clbits=None,
    dtype=None,
    head_labels: int = 0,
    method: str = "iid",
    initial: int = 4096,
    max_samples: int = 2_000_000,
    control_variate: bool = False,
    noise=None,
    noise_seed: int = 0,
    collapse="auto",
    collapse_reps: int | None = None,
    pallas_variant: bool = True,
    mesh=None,
    device=None,
):
    """eps-targeted sampling: grow the budget until the worst per-outcome
    EMPIRICAL standard error is <= ``eps``, then stop.

    The analytic Hoeffding budget ``kappa / eps^2`` (:func:`sampling_overhead`)
    is a worst-case bound; the sample's own moments are usually far
    tighter (signs cancel coherently on real plans, and the stratified
    head removes the heavy labels' variance entirely).  Each round
    re-draws ``n`` fresh samples (seeds disjoint per round) and
    quadruples ``n`` until the target is met, so total work is <= 4/3 of
    the final round's — re-simulation cost stays bounded because rows
    are only computed for deduplicated labels, whose count saturates.

    Returns ``(estimate, stderr, samples_used)``.  If ``max_samples`` is
    reached above ``eps`` the best estimate is returned with a warning —
    callers can check ``stderr.max()``.  Composes with ``head_labels``
    (stratified), ``method="lhs"`` (balanced; the iid stderr formula
    upper-bounds the true LHS variance, so the stop rule stays sound) and
    ``keep_clbits``."""
    if eps <= 0.0:
        raise ValueError(f"eps must be positive, got {eps}")
    n = max(1, min(int(initial), int(max_samples)))
    round_idx = 0
    while True:
        # wide seed stride: sample_label_counts advances its seed by 1
        # per chunk, so adjacent round seeds would overlap streams
        est, se = sampled_knit(
            virt, n, seed=seed + round_idx * 1_000_003,
            keep_clbits=keep_clbits,
            with_stderr=True, dtype=dtype, head_labels=head_labels,
            method=method, control_variate=control_variate,
            noise=noise, noise_seed=noise_seed + round_idx,
            collapse=collapse, collapse_reps=collapse_reps,
            pallas_variant=pallas_variant, mesh=mesh, device=device,
        )
        worst = float(se.max()) if se.size else 0.0
        if worst <= eps or n >= max_samples:
            if worst > eps:
                get_logger(__name__).warning(
                    f"sampled_knit_adaptive: budget exhausted at "
                    f"{n} samples with stderr {worst:.3g} > eps={eps:.3g}"
                    " — returning the best estimate (raise max_samples "
                    "for a tighter answer)"
                )
            return est, se, n
        # scale the next round by the measured variance ratio, snapped
        # to at least 4x so the geometric-work bound holds
        n = min(int(max_samples),
                max(4 * n, int(n * (worst / eps) ** 2)))
        round_idx += 1


def sampled_knit(
    virt: VirtualCircuit,
    num_samples: int,
    seed: int = 0,
    keep_clbits=None,
    with_stderr: bool = False,
    dtype=None,
    head_labels: int = 0,
    method: str = "iid",
    control_variate: bool = False,
    noise=None,
    noise_seed: int = 0,
    collapse="auto",
    collapse_reps: int | None = None,
    pallas_variant: bool = True,
    mesh=None,
    device=None,
):
    """Unbiased Monte-Carlo estimate of the knitted distribution from
    ``num_samples`` QPD samples — only the sampled labels' instances are
    simulated (deduplicated), instead of the full ``prod_g n_g`` grid, on
    ``device`` (None = "cuda").

    Per-outcome standard error ~ ``gamma_total / sqrt(num_samples)``;
    see :func:`sampling_overhead` for the budget.  ``keep_clbits``
    estimates a marginal (wide circuits) without materialising the full
    distribution.  ``with_stderr``: additionally return the per-outcome
    standard error of the estimate, ``sqrt((E[X^2] - E[X]^2) /
    num_samples)`` from the sample's own moments.

    ``head_labels``: stratified estimator — enumerate the up-to-that-
    many heaviest labels exactly and spend the whole sample budget on
    the tail (:func:`stratified_split`): stderr scale drops from
    gamma_total to gamma_tail.  No-op on uniform-coefficient cut sets.

    ``method="lhs"``: balanced (Latin-hypercube) label sampling — pins
    each cut's empirical variant counts to their expectation (see
    :func:`sample_labels`); composes with ``head_labels`` (the tail is
    drawn balanced, then rejection-filtered).  The ``with_stderr``
    estimate keeps the iid formula, which upper-bounds the true LHS
    variance (conservative).

    ``control_variate``: regress each outcome against the per-sample
    signed total mass, whose exact expectation is known (1, by trace
    preservation) — see :func:`_cv_adjust`.  Zero extra simulation (the
    totals are row sums of rows already computed); cancels the shared
    sign-product noise wherever an outcome's value tracks the total.
    Composes with every other knob; under ``head_labels`` the tail is
    regressed against its own exact mass ``1 - head_mass``.

    ``collapse``: True / False / "auto" / a per-fragment list
    (:func:`_collapse_flags`): a collapse-mode fragment measures its cuts
    in the simulation, an ancilla-mode fragment defers them onto
    ancillas.  ``pallas_variant`` (default True): a kernel serves every
    fragment it can (the collapse kernel, the variant kernel's full
    rows), the others run without one; False: every fragment without a
    kernel (the JAX package's default).  ``dtype=torch.bfloat16``: bf16
    states without a kernel, float32 rows and knit.

    ``noise``: one NoiseModel, a per-fragment list, or None — the
    sampled labels' instances run through the trajectory-noise engine
    with calibrated readout (:func:`_noisy_row_builder`, draws from
    ``noise_seed``), estimating the NOISY knit.  E[Y] = 1 still holds
    (every noise channel is trace-preserving), so ``control_variate``
    and the stderr/stratified/LHS machinery compose unchanged.  Noise
    with a ``dtype``, with a collapse-mode fragment or with ``mesh``
    raises the JAX package's ValueError; ``mesh`` raises
    NotImplementedError (the sharded engine's item)."""
    noise = _noise_models(virt, noise)
    cflags = _collapse_flags(virt, collapse)
    _check_noise_args(noise, dtype, cflags, mesh)
    ckw = dict(collapse=cflags, pallas_variant=pallas_variant, dtype=dtype,
               noise=noise, device=device)
    split = stratified_split(virt, head_labels) if head_labels else None
    if split is None:
        uniq, counts = sample_label_counts(virt, num_samples, seed,
                                           method=method)
        if any(cflags):
            uniq, fc = _expand_measuring_counts(
                virt, uniq, counts.astype(np.float64), cap=collapse_reps
            )
            mass = fc / num_samples
        else:
            mass = counts.astype(np.float64) / num_samples
        if not (with_stderr or control_variate):
            return _estimate(virt, uniq, mass, keep_clbits,
                             noise_seed=noise_seed,
                             collapse_seed=seed * 31 + 17, **ckw)
        est, m2, *rest = _estimate(
            virt, uniq, mass, keep_clbits, second_moment=True,
            control_stats=control_variate,
            noise_seed=noise_seed, collapse_seed=seed * 31 + 17,
            **ckw,
        )
        vals = np.asarray(est.values)
        if control_variate:
            vals, var = _cv_adjust(vals, m2, rest[0], 1.0)
            est = Distribution(vals, est.bit_positions, virt.num_clbits)
        else:
            var = np.maximum(m2 - vals**2, 0.0)
        if not with_stderr:
            return est
        return est, np.sqrt(var / num_samples)

    head_rows, head_w, thresh, gamma_head, gamma_tail = split
    head_var = None
    if any(cflags) and (with_stderr or control_variate):
        # collapse-mode head rows are stochastic — estimate their
        # variance from replicate groups (the head carries most of the
        # mass, so omitting its collapse noise materially understates
        # the reported stderr)
        head, head_var, head_stats = _collapse_head_groups(
            virt, head_rows, head_w, collapse_reps or 16,
            lambda rows, w, off: _estimate(
                virt, rows, w, keep_clbits,
                gamma_override=1.0, control_stats=control_variate,
                noise_seed=noise_seed,
                collapse_seed=seed * 31 + 29 + off, **ckw,
            ),
            control_variate,
            values=lambda h: h.values,
            rebuild=lambda h, v: Distribution(
                v, h.bit_positions, virt.num_clbits
            ),
        )
    else:
        if any(cflags):
            head_rows, head_w = _expand_measuring_mass(
                virt, head_rows, head_w, collapse_reps or 16
            )
        # head masses ARE the final per-label weights (gamma_override=1)
        head_out = _estimate(
            virt, head_rows, head_w, keep_clbits,
            gamma_override=1.0, control_stats=control_variate,
            noise_seed=noise_seed, collapse_seed=seed * 31 + 29,
            **ckw,
        )
        head, head_stats = head_out if control_variate \
            else (head_out, None)
    if gamma_tail <= 0.0:
        # the head IS the whole grid: exact unless collapse draws fed it
        if with_stderr:
            hv = head_var if head_var is not None \
                else np.zeros_like(np.asarray(head.values))
            return head, np.sqrt(hv)
        return head
    uniq, counts = _sample_tail_counts(virt, num_samples, thresh, seed,
                                       method=method)
    if any(cflags):
        uniq, fc = _expand_measuring_counts(
            virt, uniq, counts.astype(np.float64), cap=collapse_reps
        )
        mass = fc / num_samples
    else:
        mass = counts.astype(np.float64) / num_samples
    if not (with_stderr or control_variate):
        tail = _estimate(virt, uniq, mass, keep_clbits,
                         gamma_override=gamma_tail,
                         noise_seed=noise_seed + 503,
                         collapse_seed=seed * 31 + 43, **ckw)
        return Distribution(
            np.asarray(head.values) + np.asarray(tail.values),
            head.bit_positions, virt.num_clbits,
        )
    tail, m2, *rest = _estimate(
        virt, uniq, mass, keep_clbits, second_moment=True,
        gamma_override=gamma_tail, control_stats=control_variate,
        noise_seed=noise_seed + 503, collapse_seed=seed * 31 + 43,
        **ckw,
    )
    # the tail's sampling variance, plus the head's collapse-draw
    # variance when collapse mode fed it (head_var is None on the exact
    # enumeration path)
    tail_vals = np.asarray(tail.values)
    if control_variate:
        # the head's y_mean IS its exact mass (weights are exact, and
        # collapse preserves row totals), so the tail total's exact
        # expectation is 1 - head_mass
        tail_vals, var = _cv_adjust(
            tail_vals, m2, rest[0], 1.0 - head_stats["y_mean"],
        )
    else:
        var = np.maximum(m2 - tail_vals**2, 0.0)
    est = Distribution(
        np.asarray(head.values) + tail_vals,
        head.bit_positions, virt.num_clbits,
    )
    if not with_stderr:
        return est
    se2 = var / num_samples
    if head_var is not None:
        se2 = se2 + head_var
    return est, np.sqrt(se2)


def _z_sign_matrix(positions, z_sets, device):
    """[2^d, num_sets] f32 parity signs over the data bits ``positions``:
    column s at flat index x is ``(-1)^popcount(x & mask_s)`` with bit j
    of x carrying ``positions[j]`` (the :func:`_fold_rows_per_label` /
    knit layout).  Z bits absent from ``positions`` (structurally-zero
    clbits, or bits owned by another fragment) contribute +1."""
    d = len(positions)
    x = np.arange(1 << d, dtype=np.int64)
    cols = []
    for s in z_sets:
        par = np.zeros(1 << d, np.int64)
        for j, p in enumerate(positions):
            if p in s:
                par ^= (x >> j) & 1
        cols.append(1.0 - 2.0 * par)
    return to_device(np.stack(cols, axis=1).astype(np.float32), device)


def _estimate_z(
    virt: VirtualCircuit,
    labels: np.ndarray,
    mass: np.ndarray,
    z_sets,
    second_moment: bool = False,
    dtype=None,
    gamma_override: float | None = None,
    control_stats: bool = False,
    noise=None,
    noise_seed: int = 0,
    collapse=None,
    collapse_seed: int = 0,
    pallas_variant: bool = True,
    mesh=None,
    device=None,
):
    """Core observable estimator: ``[num_sets]`` vector of
    ``sum_l mass[l] * gamma * prod_f <Z_S>_f(l)``.

    The parity sign factorises over the fragments' disjoint clbit sets,
    so each fragment reduces to ONE scalar per (label, z-set): the
    collapse kernel's z columns, or a ``rows @ signs`` product — no
    global distribution of any size materialises, at any circuit width.
    ``second_moment`` / ``control_stats`` mirror :func:`_estimate` (the
    per-sample square factorises over fragments; Y is the signed total
    mass with exact expectation — for the empty z-set X == Y, so the CV
    is exact there).  ``noise`` as in :func:`_estimate`."""
    flags = list(collapse) if collapse is not None else \
        [False] * len(virt.fragments)
    return _scan_core(
        virt, labels, mass, z_sets=z_sets,
        second_moment=second_moment, control_stats=control_stats,
        gamma_override=gamma_override, dtype=dtype, flags=flags,
        collapse_seed=collapse_seed, pallas_variant=pallas_variant,
        mesh=mesh, noise=noise, noise_seed=noise_seed, device=device,
    )


def sampled_expectation_z(
    virt: VirtualCircuit,
    z_sets,
    num_samples: int,
    seed: int = 0,
    method: str = "iid",
    with_stderr: bool = False,
    control_variate: bool = False,
    dtype=None,
    head_labels: int = 0,
    noise=None,
    noise_seed: int = 0,
    collapse="auto",
    collapse_reps: int | None = None,
    pallas_variant: bool = True,
    mesh=None,
    device=None,
):
    """Unbiased Monte-Carlo estimate of ``<prod_{c in S} Z_c>`` for each
    ``S`` in ``z_sets``, from ``num_samples`` QPD label samples — the
    observable twin of :func:`sampled_knit`, serving the regime neither
    exact path covers: too many cuts to enumerate the label grid AND
    too wide to materialise a distribution.

    Returns ``[num_sets]`` float64 (plus ``[num_sets]`` stderr when
    ``with_stderr``).  Composes exactly like :func:`sampled_knit`:
    ``method="lhs"`` (balanced labels), ``head_labels`` (exact head +
    conditional tail, stderr scale gamma_tail) and ``control_variate`` —
    regression against the signed total mass (exact expectation 1: for
    observables the estimate tracks the total far more tightly than any
    single distribution outcome, so the reduction is larger than on
    knitted distributions).  ``noise`` estimates the NOISY observables,
    ``dtype`` and ``pallas_variant`` route as in :func:`sampled_knit`."""
    z_sets = [set(s) for s in z_sets]
    noise = _noise_models(virt, noise)
    cflags = _collapse_flags(virt, collapse)
    _check_noise_args(noise, dtype, cflags, mesh)
    ckw = dict(collapse=cflags, pallas_variant=pallas_variant, dtype=dtype,
               noise=noise, device=device)
    split = stratified_split(virt, head_labels) if head_labels else None
    if split is None:
        uniq, counts = sample_label_counts(virt, num_samples, seed,
                                           method=method)
        if any(cflags):
            uniq, fc = _expand_measuring_counts(
                virt, uniq, counts.astype(np.float64), cap=collapse_reps
            )
            mass = fc / num_samples
        else:
            mass = counts.astype(np.float64) / num_samples
        if not (with_stderr or control_variate):
            return _estimate_z(virt, uniq, mass, z_sets,
                               noise_seed=noise_seed,
                               collapse_seed=seed * 31 + 17, **ckw)
        est, m2, *rest = _estimate_z(
            virt, uniq, mass, z_sets, second_moment=True,
            control_stats=control_variate,
            noise_seed=noise_seed, collapse_seed=seed * 31 + 17,
            **ckw,
        )
        if control_variate:
            est, var = _cv_adjust(est, m2, rest[0], 1.0)
        else:
            var = np.maximum(m2 - est**2, 0.0)
        if not with_stderr:
            return est
        return est, np.sqrt(var / num_samples)

    head_rows, head_w, thresh, gamma_head, gamma_tail = split
    head_var = None
    if any(cflags) and (with_stderr or control_variate):
        # collapse-mode head rows are stochastic — replicate-group
        # variance, exactly as in sampled_knit
        head, head_var, head_stats = _collapse_head_groups(
            virt, head_rows, head_w, collapse_reps or 16,
            lambda rows, w, off: _estimate_z(
                virt, rows, w, z_sets, gamma_override=1.0,
                control_stats=control_variate,
                noise_seed=noise_seed,
                collapse_seed=seed * 31 + 29 + off, **ckw,
            ),
            control_variate,
            values=lambda h: h,
            rebuild=lambda _h, v: v,
        )
    else:
        if any(cflags):
            head_rows, head_w = _expand_measuring_mass(
                virt, head_rows, head_w, collapse_reps or 16
            )
        head_out = _estimate_z(
            virt, head_rows, head_w, z_sets,
            gamma_override=1.0, control_stats=control_variate,
            noise_seed=noise_seed, collapse_seed=seed * 31 + 29,
            **ckw,
        )
        head, head_stats = head_out if control_variate \
            else (head_out, None)
    if gamma_tail <= 0.0:
        if with_stderr:
            hv = head_var if head_var is not None else np.zeros_like(head)
            return head, np.sqrt(hv)
        return head
    uniq, counts = _sample_tail_counts(virt, num_samples, thresh, seed,
                                       method=method)
    if any(cflags):
        uniq, fc = _expand_measuring_counts(
            virt, uniq, counts.astype(np.float64), cap=collapse_reps
        )
        mass = fc / num_samples
    else:
        mass = counts.astype(np.float64) / num_samples
    if not (with_stderr or control_variate):
        tail = _estimate_z(virt, uniq, mass, z_sets,
                           gamma_override=gamma_tail,
                           noise_seed=noise_seed + 503,
                           collapse_seed=seed * 31 + 43, **ckw)
        return head + tail
    tail, m2, *rest = _estimate_z(
        virt, uniq, mass, z_sets, second_moment=True,
        gamma_override=gamma_tail, control_stats=control_variate,
        noise_seed=noise_seed + 503, collapse_seed=seed * 31 + 43,
        **ckw,
    )
    # tail sampling variance + the head's collapse-draw variance (None
    # on the exact enumeration path)
    if control_variate:
        tail, var = _cv_adjust(tail, m2, rest[0],
                               1.0 - head_stats["y_mean"])
    else:
        var = np.maximum(m2 - tail**2, 0.0)
    est = head + tail
    if not with_stderr:
        return est
    se2 = var / num_samples
    if head_var is not None:
        se2 = se2 + head_var
    return est, np.sqrt(se2)


def sampled_expectation_z_adaptive(
    virt: VirtualCircuit,
    z_sets,
    eps: float,
    seed: int = 0,
    method: str = "iid",
    control_variate: bool = False,
    dtype=None,
    head_labels: int = 0,
    initial: int = 4096,
    max_samples: int = 2_000_000,
    noise=None,
    noise_seed: int = 0,
    collapse="auto",
    collapse_reps: int | None = None,
    pallas_variant: bool = True,
    mesh=None,
    device=None,
):
    """eps-targeted observable estimation: grow the budget until every
    z-set's EMPIRICAL standard error is <= ``eps`` — the observable twin
    of :func:`sampled_knit_adaptive` (same geometric-growth schedule,
    total work <= 4/3 of the final round's; the Hoeffding budget
    kappa/eps^2 is a worst case the sample's own moments usually beat,
    and ``control_variate`` lowers them further at zero cost).

    Returns ``(estimates [num_sets], stderr [num_sets], samples_used)``;
    caps at ``max_samples`` with a warning like the knit twin."""
    if eps <= 0.0:
        raise ValueError(f"eps must be positive, got {eps}")
    n = max(1, min(int(initial), int(max_samples)))
    round_idx = 0
    while True:
        est, se = sampled_expectation_z(
            virt, z_sets, n, seed=seed + round_idx * 1_000_003,
            method=method, with_stderr=True,
            control_variate=control_variate, dtype=dtype,
            head_labels=head_labels,
            noise=noise, noise_seed=noise_seed + round_idx,
            collapse=collapse, collapse_reps=collapse_reps,
            pallas_variant=pallas_variant, mesh=mesh, device=device,
        )
        worst = float(se.max()) if se.size else 0.0
        if worst <= eps or n >= max_samples:
            if worst > eps:
                get_logger(__name__).warning(
                    f"sampled_expectation_z_adaptive: budget exhausted "
                    f"at {n} samples with stderr {worst:.3g} > "
                    f"eps={eps:.3g}"
                )
            return est, se, n
        n = min(int(max_samples),
                max(4 * n, int(n * (worst / eps) ** 2)))
        round_idx += 1
