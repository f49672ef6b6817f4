"""A plain complex128 replay of the trajectory rows that the sampled
engine returns with ``sample_probe`` (``entries/sampled.py``'s
``probe``), for circuits whose cut gates are ``cp`` gates.

A trajectory is one QPD label (a variant per cut gate) and one uniform
draw per collapse site.  On a fragment it is the fragment's part of the
circuit, in the circuit's order, with each cut ``cp(theta)`` on ``(a,
b)`` replaced on the fragment's endpoint by that variant's local gates.
The decomposition is the controlled phase's as the rz-framed
``rzz(-theta / 2)`` of Mitarai and Fujii (arXiv:1909.07534), in the
variant order of qvm's ``VirtualRZZ``: with ``c = cos(theta / 4)`` and
``s = sin(theta / 4)``,

    variant   endpoint a       endpoint b       coefficient (b = 0, 1)
    0         -                -                c^2, 0     (a's)
    1         z                z                s^2, 0     (a's)
    2         rz(-pi/2)        measure          cs, -cs    (b's)
    3         measure          rz(-pi/2)        cs, -cs    (a's)
    4         rz(pi/2)         measure          -cs, cs    (b's)
    5         measure          rz(pi/2)         -cs, cs    (a's)

framed by ``rz(theta / 2)`` before on ``a`` and after on ``b``.  A
measure is done in the simulation: ``p0`` and ``p1`` of the qubit,
``tot = p0 + p1``, the branch ``u * tot >= p0`` with the site's draw
``u``, the state projected on it and rescaled to ``tot``.  The row is
the final ``|psi|^2`` on the row's clbits times the product of the
coefficients over their largest magnitude: at a measure the picked
branch's, elsewhere the owner's ``b = 0`` one (1 on the other side).
Every cut gate on a fragment is one of its collapse sites, in the
circuit's order.
"""
import math

import numpy as np
import torch

from . import statevector
from .qft_statevector import cp_gates

PICK_TOL = 1e-5   # a trajectory whose draw lies this close to a branch's
                  # threshold is left out: rounding may pick either
_Z = np.diag([1.0, -1.0]).astype(complex)
_I = np.eye(2, dtype=complex)


def _rz(t):
    return np.diag([np.exp(-0.5j * t), np.exp(0.5j * t)])


def variants(theta: float):
    """``(ops [6, 2 sides, 2, 2], measures [6, 2] bool, coef [6, 2],
    owner [6])`` of the cut ``cp(theta)``: each side's local gate before
    its measure (the frame included on side 0; side 1's frame follows
    the measure), as in the table above."""
    c, s = math.cos(theta / 4), math.sin(theta / 4)
    if min(abs(c), abs(s)) < 1e-5:
        raise ValueError(f"cp({theta}) is a special case of the "
                         "decomposition, not replayed here")
    cs = c * s
    local = [(_I, _I), (_Z, _Z), (_rz(-math.pi / 2), _I),
             (_I, _rz(-math.pi / 2)), (_rz(math.pi / 2), _I),
             (_I, _rz(math.pi / 2))]
    frame = _rz(theta / 2)
    ops = np.array([[a @ frame, b] for a, b in local])
    measures = np.array([[False, False], [False, False], [False, True],
                         [True, False], [False, True], [True, False]])
    coef = np.array([[c * c, 0], [s * s, 0], [cs, -cs], [cs, -cs],
                     [-cs, cs], [-cs, cs]])
    owner = np.array([0, 0, 1, 0, 1, 0])
    return ops, measures, coef, owner


def _apply(state, mat, axes):
    """``mat`` ([d, d], or [K, d, d] one per trajectory) on the qubit
    ``axes`` of ``state [K, 2, ..., 2]``, its first axis the most
    significant bit of the gate's index."""
    n, k = state.dim() - 1, len(axes)
    src = [1 + a for a in axes]
    tail = list(range(n + 1 - k, n + 1))
    st = torch.movedim(state, src, tail)
    shape = st.shape
    st = st.reshape(shape[0], -1, 1 << k)
    st = st @ mat.transpose(-1, -2) if mat.dim() == 2 else \
        torch.einsum("kij,krj->kri", mat, st)
    return torch.movedim(st.reshape(shape), tail, src)


def _collapse(state, axis, u):
    """``(state, picked branch [K], margin [K])`` of the measure of
    ``axis``, one draw per trajectory."""
    sq = (state.abs() ** 2).flatten(1)
    tot = sq.sum(1)
    p1 = (state.select(1 + axis, 1).abs() ** 2).reshape(
        state.shape[0], -1).sum(1)
    p0 = tot - p1
    pick = u * tot >= p0
    margin = (u * tot - p0).abs() / tot
    shape = [1] * state.dim()
    shape[1 + axis] = 2
    bit = torch.arange(2, device=state.device).reshape(shape)
    keep = (bit == pick.reshape([-1] + [1] * (state.dim() - 1)))
    scale = torch.sqrt(tot / torch.where(pick, p1, p0).clamp_min(1e-300))
    scale = scale.reshape([-1] + [1] * (state.dim() - 1))
    return state * keep * scale, pick, margin


def cut_gates(instance, fragments) -> dict:
    """gate position -> cut index: the gates whose qubits lie in more
    than one fragment (each fragment a list of measured clbits), in the
    circuit's order."""
    qubit_of = statevector.measured_clbits(instance)
    frag_of = {qubit_of[c]: f for f, cl in enumerate(fragments) for c in cl}
    cuts = {}
    for i, (_, gq, _) in enumerate(instance["gates"]):
        if len({frag_of[q] for q in gq}) > 1:
            cuts[i] = len(cuts)
    return cuts


def fragment_rows(instance, cuts, clbits, positions, labels, draws,
                  device="cpu"):
    """``(rows [K, 2^len(positions)] float64, margin [K])`` of one
    fragment: its qubits are the measured ``clbits`` (``measure_all``),
    ``cuts`` the cut gates (:func:`cut_gates`), ``labels [K, cuts]`` a
    variant per cut gate, ``draws [K, sites]`` a draw per collapse site
    (None where no cut touches the fragment); ``margin`` is each
    trajectory's smallest distance of a draw from its threshold."""
    qubit_of = statevector.measured_clbits(instance)
    qubits = sorted(qubit_of[c] for c in clbits)
    axis = {q: i for i, q in enumerate(qubits)}
    labels = torch.as_tensor(np.asarray(labels), device=device).long()
    k = labels.shape[0]
    u = None if draws is None else \
        torch.as_tensor(np.asarray(draws, np.float64), device=device)
    state = torch.zeros((k, 1 << len(qubits)), dtype=torch.complex128,
                        device=device)
    state[:, 0] = 1.0
    state = state.reshape([k] + [2] * len(qubits))
    weight = torch.ones(k, dtype=torch.float64, device=device)
    margin = torch.full((k,), math.inf, dtype=torch.float64, device=device)
    mats = {}

    def fixed(name, params):
        key = (name, tuple(params))
        if key not in mats:
            mats[key] = torch.as_tensor(statevector.gate_matrix(name, params),
                                        device=device)
        return mats[key]

    site = 0
    for i, (name, gq, params) in enumerate(instance["gates"]):
        here = [q in axis for q in gq]
        if not any(here):
            continue
        if i not in cuts:
            for n2, q2, p2 in (cp_gates(gq, params[0]) if name == "cp"
                               else [(name, gq, params)]):
                state = _apply(state, fixed(n2, p2), [axis[q] for q in q2])
            continue
        if name != "cp":
            raise ValueError(f"a cut {name!r} gate; the replay knows cp")
        side = here.index(True)
        ops, measures, coef, owner = variants(params[0])
        v = labels[:, cuts[i]]
        ratio = torch.as_tensor(
            coef / np.abs(coef).max(axis=1, keepdims=True), device=device)
        a = axis[gq[side]]
        state = _apply(state, torch.as_tensor(ops[:, side], device=device)[v],
                       [a])
        meas = torch.as_tensor(measures[:, side], device=device)[v]
        collapsed, pick, m = _collapse(state, a, u[:, site])
        state = torch.where(meas.reshape([-1] + [1] * len(qubits)),
                            collapsed, state)
        margin = torch.where(meas, torch.minimum(margin, m), margin)
        owns = torch.as_tensor(owner == side, device=device)[v]
        weight = weight * torch.where(
            meas, ratio[v, pick.long()],
            torch.where(owns, ratio[v, 0], torch.ones_like(weight)))
        if side == 1:
            state = _apply(state, torch.as_tensor(_rz(params[0] / 2),
                                                  device=device), [a])
        site += 1
    probs = state.abs() ** 2
    kept = [axis[qubit_of[c]] for c in positions]
    drop = [1 + j for j in range(len(qubits)) if j not in kept]
    if drop:
        probs = probs.sum(dim=drop)
    # the last position's axis first, so that positions[0] is the lowest
    # bit
    order = sorted(kept)
    perm = [0] + [1 + order.index(j) for j in reversed(kept)]
    rows = probs.permute(perm).reshape(k, -1) * weight[:, None]
    return rows, margin


def replay_error(instance, probe, device="cpu") -> tuple[float, int]:
    """``(largest |row - replay| over the probe's fragments and
    trajectories, trajectories compared)``; a trajectory with a draw
    within ``PICK_TOL`` of its threshold on some fragment is left out.
    ``(inf, 0)`` where the probe does not fit the instance."""
    frags = probe["fragments"]
    cuts = cut_gates(instance, [f["clbits"] for f in frags])
    labels = np.asarray(probe["labels"])
    if labels.ndim != 2 or labels.shape[1] != len(cuts):
        return math.inf, 0
    errs, ok = [], torch.ones(labels.shape[0], dtype=torch.bool,
                              device=device)
    for f in frags:
        ref, margin = fragment_rows(instance, cuts, f["clbits"],
                                    f["positions"], labels, f["draws"],
                                    device)
        got = torch.as_tensor(np.asarray(f["rows"], np.float64),
                              device=device)
        if got.shape != ref.shape:
            return math.inf, 0
        errs.append((got - ref).abs().amax(dim=1))
        ok &= margin >= PICK_TOL
    if not bool(ok.any()):
        return math.inf, 0
    err = torch.stack(errs).amax(dim=0)[ok]
    return float(err.max()), int(ok.sum())
