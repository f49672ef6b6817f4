"""Noise models: the stand-in for the reference's qiskit fake backends
(FakeKolkataV2 / FakeAthens / FakeOpenPulse2Q-3Q — benchmark.py:5,95,
benchmark_different_backends.py:5,20-22).

Port of the JAX package's ``ops/noise.py``.  The host half (the
:class:`NoiseModel`, the fake-backend calibrations, the insertion sites
and the balanced trajectory samplers) is numpy, as there, so both
packages draw the same branch indices from the same
``np.random.default_rng`` seeds.  The device half runs on ``device``
(None = "cuda") in plain PyTorch, as the JAX package runs noise through
plain XLA and no Pallas kernel, but for the streamed scan's noisy rows:
on a card the variant kernel computes them
(ops/variant_kernel.make_noisy_chunk_kernel).

Model: per-gate depolarising noise simulated by Pauli-twirl trajectories
(each trajectory inserts one sampled Pauli per physical gate site; the
trajectories of a batch are rows of one state tensor), plus exact
readout-error application on the final probability vector (a per-bit 2x2
stochastic matrix contraction — deterministic, no sampling needed).

Every insertion site carries its own (sampling probs, Kraus bank) pair
(:func:`_depol_site` / :func:`_relax_site`), so the same trajectory
machinery also runs NON-unital channels: with ``t1``/``t2`` set on the
model, each physical gate additionally relaxes every touched qubit for
the gate's duration (thermal relaxation — amplitude damping toward |0>
plus the extra dephasing that closes the gap to T2).  Branch i of a site
applies K_i/sqrt(q_i) sampled with probability q_i; the engines average
UN-normalised trajectory rows, so the mean is the exact channel output
(importance-sampled quantum-jump unravelling).

Trajectories are drawn BALANCED along the trajectory axis (systematic
allocation + independent permutation per site, :func:`_site_idx`): each
trajectory keeps the exact iid marginal — the mean stays an unbiased
channel estimate — but the number of inserted Paulis per site is pinned
to within 1 of its expectation.

Engines: :func:`run_fragment_noisy` (variants x trajectories through the
batched engine, ops/variant_engine.py) behind
``run_noisy_virtual_circuit(engine="auto" | "xla")``, and the streamed
scan (ops/streamed.py, ``noise=``) behind ``engine="streamed"``, and the
sampled engine's noisy rows (ops/qpd_sampling.py, the sampled labels'
trajectories averaged a block at a time) behind ``engine="sampled"``.
``engine="pallas"``, the exact kernel route, raises ``ValueError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..circuit.circuit import Circuit
from ..circuit.gates import I2, X, Y, Z
from ..convert import resolve_device, to_device
from ..virt.virtual_circuit import VirtualCircuit
from .statevector import (
    Distribution,
    apply_block_einsum,
    apply_slices,
    compile_circuit,
    marginalize_flat,
    to_real_block,
)

_PAULI_BLOCKS = np.stack([to_real_block(m) for m in (I2, X, Y, Z)])


@dataclass
class NoiseModel:
    """Depolarising + readout error device model.

    Scalar rates apply uniformly; the optional per-qubit vectors
    (``p1_q``/``p2_q``/``ro01_q``/``ro10_q``, device-qubit-indexed)
    override them where present — the analog of qiskit fake backends'
    per-qubit calibration data (reference: FakeKolkataV2 at
    benchmark.py:94-103).  Fragment-local qubit i maps to device qubit i
    (trivial layout, as the reference's AerSimulator.from_backend does
    for untranspiled fragments)."""

    name: str = "generic"
    p1: float = 0.0005          # 1q gate depolarising probability
    p2: float = 0.01            # 2q gate depolarising probability
    readout01: float = 0.015    # P(read 1 | actual 0)
    readout10: float = 0.03     # P(read 0 | actual 1)
    trajectories: int = 16
    num_qubits: int | None = None  # capacity, for per-fragment mapping
    p1_q: np.ndarray | None = None     # [num_qubits] per-qubit 1q rates
    p2_q: np.ndarray | None = None     # [num_qubits]; pair rate = mean
    ro01_q: np.ndarray | None = None   # [num_qubits] P(read 1 | 0)
    ro10_q: np.ndarray | None = None   # [num_qubits] P(read 0 | 1)
    coupling: list | None = None       # device edge list; when set, noisy
                                       # sims route onto the topology
                                       # (circuit/routing.py)
    untranspiled: bool = False         # the reference's actual run
                                       # semantics: circuits go to the fake
                                       # backend untranspiled, so a
                                       # QuantumError binds only to (basis
                                       # gate, calibrated qubits) pairs
    # Thermal relaxation (T1/T2, seconds).  When set, every physical gate
    # additionally applies an amplitude+phase-damping channel to each
    # touched qubit for the gate's duration.  None = off.
    t1: float | None = None
    t2: float | None = None
    t1_q: np.ndarray | None = None     # [num_qubits] per-qubit T1
    t2_q: np.ndarray | None = None     # [num_qubits] per-qubit T2
    gate_time_1q: float = 35e-9        # typical IBM sx/x duration
    gate_time_2q: float = 300e-9       # typical IBM CX duration
    # Probabilistic error cancellation: insert the signed quasi-inverse
    # of every depolarising site (pec_inverse_site).  Batched engine only
    # (per-trajectory signed row weights); readout stays physical.
    pec: bool = False

    def _at(self, vec, scalar, q):
        if vec is None:
            return float(scalar)
        return float(vec[q % len(vec)])

    @property
    def has_relaxation(self) -> bool:
        return any(
            v is not None for v in (self.t1, self.t2, self.t1_q, self.t2_q)
        )

    def relax_gamma_lambda(self, q: int, duration: float) -> tuple[float, float]:
        """Thermal-relaxation channel parameters for device qubit ``q``
        over ``duration`` seconds: amplitude damping
        ``gamma = 1 - e^{-d/T1}`` and the extra phase damping
        ``lam = e^{-d/T1} - e^{-2 d/T2}``, so the coherence decay is
        exactly ``e^{-d/T2}`` (physical for T2 <= 2*T1; clipped at 0
        otherwise)."""
        t1 = self.t1 if self.t1_q is None else float(self.t1_q[q % len(self.t1_q)])
        t2 = self.t2 if self.t2_q is None else float(self.t2_q[q % len(self.t2_q)])
        e1 = 1.0 if t1 is None else float(np.exp(-duration / float(t1)))
        gamma = 1.0 - e1
        lam = 0.0 if t2 is None else max(
            0.0, e1 - float(np.exp(-2.0 * duration / float(t2)))
        )
        return gamma, lam

    def rate_1q(self, q: int) -> float:
        return self._at(self.p1_q, self.p1, q)

    def rate_2q(self, qa: int, qb: int) -> float:
        if self.p2_q is None:
            return float(self.p2)
        return 0.5 * (
            float(self.p2_q[qa % len(self.p2_q)])
            + float(self.p2_q[qb % len(self.p2_q)])
        )

    def readout_matrix(self, q: int) -> np.ndarray:
        e01 = self._at(self.ro01_q, self.readout01, q)
        e10 = self._at(self.ro10_q, self.readout10, q)
        return np.array(
            [[1 - e01, e10], [e01, 1 - e10]], dtype=np.float32
        )


def _line_coupling(n: int) -> list[tuple[int, int]]:
    return [(i, i + 1) for i in range(n - 1)]


def _depol_site(p: float) -> tuple[np.ndarray, np.ndarray]:
    """(probs4, bank4) for a depolarising insertion site: branch i is a
    (unitary) Pauli sampled with the channel probability itself."""
    probs = np.array([1.0 - p, p / 3.0, p / 3.0, p / 3.0], np.float64)
    return probs, _PAULI_BLOCKS


def _relax_site(gamma: float, lam: float) -> tuple[np.ndarray, np.ndarray]:
    """(probs4, bank4) for a thermal-relaxation (amplitude + phase
    damping) site.  Kraus operators

        K0 = diag(1, sqrt(1-gamma-lam))   (no jump)
        K1 = [[0, sqrt(gamma)], [0, 0]]   (decay |1> -> |0>)
        K2 = diag(0, sqrt(lam))           (phase jump)

    importance-sampled with q = (1-gamma-lam, gamma, lam): branch i
    applies B_i = K_i/sqrt(q_i), so the UN-normalised trajectory mean
    ``E[|B_i psi|^2] = sum_i |K_i psi|^2`` is the exact channel."""
    q0 = max(1e-12, 1.0 - gamma - lam)
    b0 = np.diag([1.0 / np.sqrt(q0), 1.0])
    b1 = np.array([[0.0, 1.0], [0.0, 0.0]])
    b2 = np.diag([0.0, 1.0])
    bank = np.stack([
        to_real_block(m) for m in (b0, b1, b2, np.zeros((2, 2)))
    ]).astype(_PAULI_BLOCKS.dtype)
    probs = np.array([q0, gamma, lam, 0.0], np.float64)
    return probs / probs.sum(), bank


def pec_inverse_site(p: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sampling probs4, bank4, branch_weights4) for the quasi-probability
    INVERSE of the 1-qubit depolarising channel (probabilistic error
    cancellation): with eta = 4p/3,

        D_p^{-1} = w0 I + sum_k w_k (P_k . P_k),
        w0 = (1 - eta/4)/(1 - eta),   w_k = -(eta/4)/(1 - eta)

    Branch i is sampled with |w_i|/gamma and the trajectory ROW is
    multiplied by branch_weights[i] = sign(w_i)*gamma."""
    eta = 4.0 * p / 3.0
    if eta >= 1.0:
        raise ValueError(f"depolarising p={p} has no quasi-inverse")
    w = np.array(
        [(1.0 - eta / 4.0) / (1.0 - eta)] + [-(eta / 4.0) / (1.0 - eta)] * 3,
        np.float64,
    )
    gamma = np.abs(w).sum()
    return np.abs(w) / gamma, _PAULI_BLOCKS, np.sign(w) * gamma


def gate_noise_sites(nm: NoiseModel, frag_axes, dev_axes):
    """All (fragment-local qubit, probs4, bank4, weights4-or-None)
    insertion sites for one physical gate on fragment-local qubits
    ``frag_axes`` mapped to device qubits ``dev_axes``: the depolarising
    site (one per gate, on the first qubit), then — with ``nm.pec`` — its
    signed quasi-inverse IMMEDIATELY after it, then one
    thermal-relaxation site per touched qubit when the model carries
    T1/T2."""
    sites = []
    if len(frag_axes) == 1:
        p = nm.rate_1q(dev_axes[0])
        dur = nm.gate_time_1q
    else:
        p = nm.rate_2q(dev_axes[0], dev_axes[1])
        dur = nm.gate_time_2q
    sites.append((frag_axes[0], *_depol_site(p), None))
    if nm.pec and p > 0.0:
        sites.append((frag_axes[0], *pec_inverse_site(p)))
    if nm.has_relaxation:
        for fq, dq in zip(frag_axes, dev_axes):
            gamma, lam = nm.relax_gamma_lambda(dq, dur)
            if gamma > 0.0 or lam > 0.0:
                sites.append((fq, *_relax_site(gamma, lam), None))
    return sites


def fragment_noise_sites(nm: NoiseModel, prog_ops, phys):
    """The physical-gate noise sites of a fragment's (routed) op stream:
    ``(after which op, on which qubit, probs4, bank4, weights4 | None)``
    — depolarising per gate, thermal relaxation per touched qubit, the
    PEC quasi-inverse with ``nm.pec`` (:func:`gate_noise_sites`); a
    ``slot_post`` (one endpoint of a cut 2q gate) carries half the 2q
    rate.  Ops on a deferral ancilla carry none (readout covers them).
    ``phys``: per-op device nodes from routing, or None (trivial
    layout).  The JAX package's ``make_sim_fn`` builds the same list."""
    sites: list[tuple[int, int, object, object, object]] = []
    for op_i, op in enumerate(prog_ops):
        kind = op[0]
        ph = phys[op_i] if phys is not None else op[2]
        if kind == "u":
            if any(p is None for p in ph):
                continue  # deferral-ancilla op: readout covers it
            for site in gate_noise_sites(nm, op[2], ph):
                sites.append((op_i, *site))
        elif kind == "slot_post":
            dev = ph[0] if ph and ph[0] is not None else op[2][0]
            p_half = 0.5 * nm.rate_2q(dev, dev)
            sites.append((op_i, op[2][0], *_depol_site(p_half), None))
            # the quasi-inverse sits right after its depolarising site,
            # before the (non-unital, non-commuting) relaxation site
            if nm.pec and p_half > 0.0:
                sites.append((op_i, op[2][0], *pec_inverse_site(p_half)))
            if nm.has_relaxation:
                gamma, lam = nm.relax_gamma_lambda(dev, nm.gate_time_2q)
                if gamma > 0.0 or lam > 0.0:
                    sites.append(
                        (op_i, op[2][0], *_relax_site(gamma, lam), None)
                    )
    return sites


# IBM heavy-hex basis set (FakeKolkataV2.configuration().basis_gates is
# ['id', 'rz', 'sx', 'x', 'cx', 'reset']); rz/id carry zero gate error on
# the device calibration, so only x/sx bind a 1q error and cx a 2q error.
_BASIS_1Q = frozenset({"x", "sx"})
_BASIS_2Q = frozenset({"cx"})


def untranspiled_site_rate(nm: NoiseModel, name, axes) -> float:
    """Aer's noise-binding rule for an UNtranspiled circuit on a fake
    backend: a QuantumError attaches to (instruction name, exact qubits)
    entries from the device calibration, nothing else (the reference's
    legs call ``backend.run`` directly, qvm/run.py:42, Utilities.py:44)."""
    if name is None or name in ("_defer", "unitary"):
        return 0.0
    if len(axes) == 1:
        return nm.rate_1q(axes[0]) if name in _BASIS_1Q else 0.0
    if name in _BASIS_2Q and nm.coupling is not None:
        a, b = axes[0], axes[1]
        for ca, cb in nm.coupling:
            if (a, b) == (ca, cb) or (a, b) == (cb, ca):
                return nm.rate_2q(a, b)
    return 0.0


def default_noise_model() -> NoiseModel:
    """FakeKolkataV2-flavoured parameters (27-qubit device class)."""
    return NoiseModel(name="fake_kolkata", num_qubits=27)


def fake_kolkata_v2(seed: int = 27, relaxation: bool = False) -> NoiseModel:
    """Per-qubit-calibrated 27-qubit device model standing in for qiskit's
    FakeKolkataV2 (reference noisy benchmark backend, benchmark.py:94-103):
    per-qubit calibration vectors synthesised around the device class's
    published medians with a fixed-seed log-normal spread, the JAX
    package's draws in its order (``relaxation=True`` adds per-qubit
    T1/T2 after them, leaving the depolarising/readout calibration
    unchanged)."""
    from ..circuit.routing import HEAVY_HEX_27

    rng = np.random.default_rng(seed)
    n = 27

    def spread(med, s):
        return np.clip(med * rng.lognormal(0.0, s, n), med / 6.0, med * 6.0)

    p1_q = spread(2.5e-4, 0.5)
    p2_q = spread(2.5e-3, 0.5)
    ro01_q = spread(0.008, 0.4)
    ro10_q = spread(0.017, 0.4)
    t1_q = t2_q = None
    if relaxation:
        t1_q = spread(100e-6, 0.3)
        # physical bound T2 <= 2*T1 (relax_gamma_lambda clips the rest)
        t2_q = np.minimum(spread(70e-6, 0.3), 2.0 * t1_q)
    return NoiseModel(
        name="fake_kolkata_v2" + ("_relax" if relaxation else ""),
        p1=2.5e-4, p2=2.5e-3, readout01=0.008, readout10=0.017,
        trajectories=16,
        num_qubits=n,
        p1_q=p1_q,
        p2_q=p2_q,
        ro01_q=ro01_q,
        ro10_q=ro10_q,
        coupling=HEAVY_HEX_27,
        t1_q=t1_q,
        t2_q=t2_q,
    )


def fake_athens() -> NoiseModel:
    """5-qubit line device (FakeAthens' real topology)."""
    return NoiseModel("fake_athens", 0.0004, 0.012, 0.02, 0.035,
                      num_qubits=5, coupling=_line_coupling(5))


def fake_open_pulse(n: int) -> NoiseModel:
    return NoiseModel(f"fake_openpulse{n}q", 0.001, 0.02, 0.03, 0.05,
                      num_qubits=n, coupling=_line_coupling(n))


def _site_idx(
    rng: np.random.Generator, probs, shape, balance_axis=None
) -> np.ndarray:
    """int32 branch indices sampled from the site's probability vector.

    ``balance_axis``: balanced (Latin-hypercube) sampling along that
    axis — the systematic-resampling allocation pins the number of
    non-identity branches to within 1 of expectation per slice, then an
    independent permutation restores the exact per-element marginal."""
    p = np.asarray(probs, np.float64)
    p = p / p.sum()
    if balance_axis is None:
        return rng.choice(len(p), size=shape, p=p).astype(np.int32)
    ax = balance_axis % len(shape)
    t = shape[ax]
    rest = tuple(d for i, d in enumerate(shape) if i != ax)
    edges = np.cumsum(p)
    edges[-1] = 1.0  # guard fp drift so searchsorted stays in range
    pos = (np.arange(t) + rng.random(rest + (1,))) / t
    ids = np.searchsorted(edges, pos, side="right").astype(np.int32)
    ids = rng.permuted(ids, axis=-1)
    return np.moveaxis(ids, -1, ax)


def _pauli_idx(
    rng: np.random.Generator, p: float, shape, balance_axis=None
) -> np.ndarray:
    """Pauli indices (0 = identity, 1..3 = X/Y/Z) with depolarising
    probability ``p`` — the depolarising-site special case of
    :func:`_site_idx` (bit-identical draws for a given rng state)."""
    return _site_idx(
        rng, [1.0 - p, p / 3.0, p / 3.0, p / 3.0], shape, balance_axis
    )


def _site_active(probs) -> bool:
    """Whether a site can deviate from the identity branch.  An inactive
    site always draws branch 0 (the identity of a depolarising bank), so
    the engines leave it out of the state passes; its draws are still
    made, keeping the rng stream the JAX package's."""
    return float(np.asarray(probs)[0]) < 1.0


def _traj_weights(site_w, idxs, shape) -> np.ndarray:
    """Per-trajectory signed row weight: the product of every signed
    quasi-site's sampled branch weight (PEC); ordinary probability sites
    (weights None) contribute 1."""
    w = np.ones(shape, np.float64)
    for w4, idx in zip(site_w, idxs):
        if w4 is not None:
            w = w * np.asarray(w4, np.float64)[idx]
    return w


def _sample_site_blocks(rng: np.random.Generator, site_tabs, shape,
                        balance_axis=None):
    """site_tabs: per-site (probs4, bank4) list [S]; returns real blocks
    [S, *shape, 2, 2, 2, 2] drawn from each site's own bank."""
    return [
        bank[_site_idx(rng, probs, shape, balance_axis)]
        for probs, bank in site_tabs
    ]


def readout_rows(rows: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Exact readout channel on rows ``[R, 2^k]``: little-endian bit ``j``
    of the flat index (``bit_positions[j]``) goes through the 2x2
    stochastic matrix ``mats[j]`` (``mats [k, 2, 2]`` on the rows'
    device), one contraction a bit."""
    r, k = rows.shape[0], mats.shape[0]
    for j in range(k):
        r4 = rows.reshape(r, 1 << (k - 1 - j), 2, 1 << j)
        rows = torch.einsum("ab,rhbl->rhal", mats[j], r4).reshape(r, -1)
    return rows


def _readout_mats(nm: NoiseModel, qubits) -> np.ndarray:
    return np.stack([nm.readout_matrix(q) for q in qubits])


def _apply_rows_readout(rows: torch.Tensor, bit_positions, nm: NoiseModel,
                        bit_qubits: dict[int, int]) -> torch.Tensor:
    """Exact readout channel on rows ``[V, 2^k]``: bit ``j`` of the flat
    index carries ``bit_positions[j]`` and goes through the calibrated
    matrix of device qubit ``bit_qubits.get(bit_positions[j], j)``
    (:func:`readout_rows` on the rows' device)."""
    if not bit_positions:
        return rows
    qubits = [bit_qubits.get(c, j) for j, c in enumerate(bit_positions)]
    return readout_rows(rows, to_device(_readout_mats(nm, qubits),
                                        rows.device))


def apply_readout_error(
    dist: Distribution, nm: NoiseModel, bit_qubits: list[int] | None = None,
    device=None,
) -> Distribution:
    """Exact readout-error channel on the written bits, on ``device``
    (None = "cuda").  ``bit_qubits``: per-bit device qubit (aligned with
    ``dist.bit_positions``) for per-qubit calibrated error rates; None
    uses the model's SCALAR rates on every bit (the per-qubit vectors
    are ignored — a bit index is not a device qubit)."""
    k = len(dist.bit_positions)
    if k == 0:
        return dist
    if bit_qubits is None:
        nm = NoiseModel(p1=nm.p1, p2=nm.p2, readout01=nm.readout01,
                        readout10=nm.readout10)
        bit_qubits = list(range(k))
    dev = resolve_device(device)
    vals = to_device(np.asarray(dist.values, np.float32), dev)[None]
    vals = readout_rows(vals, to_device(_readout_mats(nm, bit_qubits), dev))
    return Distribution(vals[0].cpu().numpy(), dist.bit_positions,
                        dist.num_clbits)


def _clbit_qubit_map(circ: Circuit) -> dict[int, int]:
    """clbit -> measured circuit qubit (for readout calibration)."""
    out: dict[int, int] = {}
    for ins in circ.instructions:
        if ins.name == "measure":
            out[ins.clbits[0]] = ins.qubits[0]
    return out


def frag_clbit_qubits(virt: VirtualCircuit, frag_name: str) -> dict[int, int]:
    """clbit -> fragment-local measured qubit.  Original clbits map to the
    data qubit their measure reads; a vgate clbit maps to the slot qubit
    of the (first) measuring endpoint in this fragment."""
    prog = virt.programs[frag_name]
    out: dict[int, int] = {}
    for kind, payload in prog.source:
        if kind == "ins" and payload.name == "measure":
            out[payload.clbits[0]] = payload.qubits[0]
    for slot in prog.slots:
        cg = virt.num_clbits + slot.vgate_idx
        if slot.ancilla is not None and cg not in out:
            out[cg] = slot.qubit
    return out


def fragment_readout_qubits(virt: VirtualCircuit, frag_name: str,
                            sim_fn) -> dict[int, int]:
    """clbit -> device qubit whose readout rates a fragment's bit takes:
    :func:`frag_clbit_qubits`, overridden by the routed placement's
    device node holding the bit (``sim_fn.readout_device``, set when the
    model carries a coupling map)."""
    cq = dict(frag_clbit_qubits(virt, frag_name))
    if sim_fn.readout_device is not None:
        cq.update({c: d for c, d in sim_fn.readout_device.items()
                   if d is not None})
    return cq


def _uncut_sites(nm: NoiseModel, gate_ops, names, phys):
    """Insertion sites of the uncut simulator: ``(op index, sim qubit,
    probs4, bank4, weights4 | None)``.  One depolarising site per op —
    zero-rate sites are KEPT so the rng consumption is reproducible
    across models — plus relaxation / PEC sites by
    :func:`gate_noise_sites`; untranspiled mode binds by
    :func:`untranspiled_site_rate`."""
    sites = []
    if nm.untranspiled:
        if nm.has_relaxation:
            raise ValueError(
                "untranspiled mode reproduces the reference's calibration-"
                "bound depolarising semantics; T1/T2 relaxation needs the "
                "calibrated (routed) mode")
        if nm.pec:
            raise ValueError(
                "untranspiled mode is the reference-parity path; PEC needs "
                "the calibrated mode")
        for i, (_, _, axes) in enumerate(gate_ops):
            sites.append((i, axes[0], *_depol_site(
                untranspiled_site_rate(nm, names[i], axes)), None))
        return sites
    for i, (_, _, axes) in enumerate(gate_ops):
        ph = phys[i] if phys is not None else axes
        # without routing, deferral ops keep their original axes: detect
        # them by name so bookkeeping CX/SWAP/c_if blocks stay noise-free
        if any(p is None for p in ph) or (
            phys is None and names[i] == "_defer"
        ):
            sites.append((i, axes[0], *_depol_site(0.0), None))
            continue
        for site in gate_noise_sites(nm, axes, ph):
            sites.append((i, *site))
    return sites


def simulate_noisy_circuit(
    circ: Circuit,
    nm: NoiseModel,
    shots: int | None = None,
    seed: int = 0,
    device=None,
) -> Distribution:
    """Uncut-circuit noisy simulation (the reference's
    ``backend.run(circuit)`` on a fake backend, Utilities.py:39-69), on
    ``device`` (None = "cuda").  With a coupling map (and not
    ``untranspiled``) the circuit is routed onto the device topology
    first; untranspiled mode runs the exact first-order depolarising
    mixture of its calibration-bound sites (deterministic); otherwise
    ``nm.trajectories`` balanced trajectories.  The per-bit calibrated
    readout channel is applied last, then ``shots`` are drawn
    (ops/sampling.sample_fragment_results)."""
    dev = resolve_device(device)
    compiled = compile_circuit(circ)
    n = compiled.num_sim_qubits
    rng = np.random.default_rng(seed)

    clbit_sources = dict(compiled.clbit_sources)
    gate_ops = [("u", u, axes) for u, axes in compiled.ops]
    phys = None
    slot_device = None
    if nm.coupling is not None and not nm.untranspiled:
        from ..circuit.routing import route_stream

        routed = route_stream(
            gate_ops, circ.num_qubits, clbit_sources, nm.coupling
        )
        gate_ops = routed.ops
        phys = routed.phys
        clbit_sources = routed.clbit_sources
        slot_device = routed.slot_device

    names = compiled.op_names or [None] * len(gate_ops)
    sites = _uncut_sites(nm, gate_ops, names, phys)
    sites_after: dict[int, list[int]] = {}
    for s_i, (op_i, *_rest) in enumerate(sites):
        sites_after.setdefault(op_i, []).append(s_i)
    active = [_site_active(pr) for (_, _, pr, _, _) in sites]
    k_traj = nm.trajectories
    if sites and not any(active):
        k_traj = 1  # no noise sites bind: one trajectory IS exact

    def sim_batch(site_mats, b):
        """|psi|^2 of ``b`` trajectories: ``site_mats[s]`` is site s's
        block per trajectory ``[b, 2, 2, 2, 2]`` (numpy)."""
        state = torch.zeros((b, 2, 1 << n), dtype=torch.float32, device=dev)
        state[:, 0, 0] = 1.0
        for i, (_, u, axes) in enumerate(gate_ops):
            u = np.asarray(u, np.complex128)
            state = apply_slices(state, lambda r, c: float(u[r, c].real),
                                 lambda r, c: float(u[r, c].imag), axes, n)
            for s_i in sites_after.get(i, ()):
                if active[s_i]:
                    state = apply_block_einsum(
                        state, to_device(site_mats[s_i], dev),
                        (sites[s_i][1],), n)
        return (state * state).sum(dim=1)

    # batch trajectories so the state block stays <= 2^26 floats a pass
    if not gate_ops:
        probs_vec = sim_batch([], 1)[0]
    elif nm.untranspiled:
        # Exact first-order depolarising mixture: with only the few
        # calibration-bound sites carrying noise (p ~ 1e-3 each),
        #   P = c0*P_ideal + sum_s p_s*c0/(1-p_s) * mean_{X,Y,Z} P_(s,Pauli)
        # up to O(p^2) — deterministic, unlike trajectory sampling.
        site_p = [1.0 - float(pr[0]) for (_, _, pr, _, _) in sites]
        nonzero = [i for i, p in enumerate(site_p) if p > 0.0]
        n_branch = 1 + 3 * len(nonzero)
        ident = _PAULI_BLOCKS[0]
        pauli_all = [
            np.broadcast_to(ident, (n_branch, 2, 2, 2, 2)).copy()
            for _ in sites
        ]
        weights = np.zeros(n_branch, dtype=np.float64)
        c0 = float(np.prod([1.0 - site_p[i] for i in nonzero])) if nonzero else 1.0
        weights[0] = c0
        b = 1
        for i in nonzero:
            for pi in (1, 2, 3):
                pauli_all[i][b] = _PAULI_BLOCKS[pi]
                weights[b] = site_p[i] * c0 / (1.0 - site_p[i]) / 3.0
                b += 1
        batch = max(1, min(n_branch, (1 << 26) // (1 << n)))
        acc = None
        for done in range(0, n_branch, batch):
            sel = np.arange(done, min(done + batch, n_branch))
            part = sim_batch([p[sel] for p in pauli_all], len(sel))
            part = (part.double() * to_device(weights[sel], dev)[:, None]
                    ).sum(dim=0)
            acc = part if acc is None else acc + part
        probs_vec = (acc / weights.sum()).to(torch.float32)
    else:
        batch = max(1, min(k_traj, (1 << 26) // (1 << n)))
        # balanced allocation over the FULL trajectory axis, sliced per
        # batch
        idx_all = [
            _site_idx(rng, pr, (k_traj,), balance_axis=0)
            for (_, _, pr, _, _) in sites
        ]
        # PEC: per-trajectory signed row weight
        w_traj = _traj_weights([s[4] for s in sites], idx_all, (k_traj,))
        acc = None
        for done in range(0, k_traj, batch):
            sel = np.arange(done, min(done + batch, k_traj))
            part = sim_batch(
                [sites[s][3][idx[sel]] for s, idx in enumerate(idx_all)],
                len(sel))
            part = (part.double() * to_device(w_traj[sel], dev)[:, None]
                    ).sum(dim=0)
            acc = part if acc is None else acc + part
        probs_vec = (acc / k_traj).to(torch.float32)

    positions = sorted(clbit_sources)
    sources = [clbit_sources[c] for c in positions]
    p = marginalize_flat(probs_vec, n, sources)
    cq = _clbit_qubit_map(circ)

    def _ro_qubit(c):
        s = clbit_sources[c]
        if slot_device is not None and s < len(slot_device):
            return slot_device[s]  # device node holding the value
        return cq.get(c, c)

    if positions:
        p = readout_rows(p.reshape(1, -1), to_device(_readout_mats(
            nm, [_ro_qubit(c) for c in positions]), dev))[0]
    if shots is not None:
        from .sampling import sample_fragment_results
        from .variant_engine import FragmentResult

        res = FragmentResult("uncut", p.reshape(1, -1), positions, [])
        p = sample_fragment_results([res], shots, seed)[0].values[0]
    return Distribution(p.cpu().numpy(), positions, compiled.num_clbits)


def run_fragment_noisy(
    virt: VirtualCircuit,
    frag_name: str,
    nm: NoiseModel,
    seed: int = 0,
    chunk_size: int = 256,
    device=None,
):
    """Noisy fragment execution on ``device`` (None = "cuda"): variants x
    trajectories through the batched engine (trajectory axis fastest,
    balanced per variant), weighted (PEC) and averaged over the
    trajectory axis; the per-qubit calibrated readout channel is applied
    to every variant row (device nodes from the routed placement when
    the model carries a coupling map).  Returns a ``FragmentResult``
    whose ``values`` stay on the device."""
    from .variant_engine import (
        FragmentResult,
        chunk_cap,
        make_sim_fn,
        scan_variant_rows,
    )

    dev = resolve_device(device)
    sim_fn, slot_mats, positions, flat_count = make_sim_fn(
        virt, frag_name, noise=nm
    )
    rng = np.random.default_rng(seed)
    k_traj = nm.trajectories
    prog = virt.programs[frag_name]
    site_tabs = [(pr, bank) for (_, _, pr, bank, _) in sim_fn.noise_sites]
    site_w = [w for (_, _, _, _, w) in sim_fn.noise_sites]
    cq = fragment_readout_qubits(virt, frag_name, sim_fn)

    if not prog.slots:
        if site_tabs:
            idxs = [_site_idx(rng, pr, (k_traj,), balance_axis=0)
                    for pr, _ in site_tabs]
            rows = sim_fn([], dev, {
                s: to_device(sim_fn.site_banks[s][idxs[s]], dev)
                for s in sim_fn.active_sites})
            w = _traj_weights(site_w, idxs, (k_traj,))
            row = (rows * to_device(w, dev, torch.float32)[:, None]).mean(
                dim=0, keepdim=True)
        else:
            # no physical-gate noise site (a deferral-only fragment): the
            # exact row IS the trajectory mean
            row = sim_fn([], dev)
        values = row.expand(flat_count, -1).contiguous()
    else:
        # batch = variants x trajectories (trajectory axis fastest); the
        # trajectory axis is balanced PER VARIANT
        total = flat_count * k_traj
        v_idx = np.repeat(np.arange(flat_count), k_traj)
        batched_slots = [tuple(np.asarray(m)[v_idx] for m in mats)
                         for mats in slot_mats]
        idxs = [_site_idx(rng, pr, (flat_count, k_traj), balance_axis=1)
                for pr, _ in site_tabs]
        w = _traj_weights(site_w, idxs, (flat_count, k_traj))
        chunk = min(chunk_size, total, chunk_cap(prog.num_sim_qubits))
        values = scan_variant_rows(
            sim_fn, batched_slots, total, chunk, dev,
            sites=[i.reshape(-1) for i in idxs],
        )
        values = values.reshape(flat_count, k_traj, -1)
        values = (values * to_device(w, dev, torch.float32)[:, :, None]
                  ).mean(dim=1)
    values = _apply_rows_readout(values, positions, nm, cq)
    return FragmentResult(frag_name, values, positions, list(prog.touching))


def _resolve_models(virt: VirtualCircuit, noise) -> list:
    """One model (or None) per fragment: ``noise`` itself, a list mapping
    fragment i -> model, or None for the ``virt.set_backend`` mapping;
    an untranspiled model runs its fragment exact (its h/rz/cp and QPD
    ops bind no calibrated (basis gate, qubits) entry)."""
    if noise is None:
        models = [virt.get_backend(reg.name) for reg in virt.fragments]
    elif isinstance(noise, (list, tuple)):
        models = list(noise)
    else:
        models = [noise] * len(virt.fragments)
    if len(models) < len(virt.fragments):
        raise ValueError(f"{len(models)} noise models for "
                         f"{len(virt.fragments)} fragments")
    models = [
        None if (m is not None and getattr(m, "untranspiled", False)) else m
        for m in models[: len(virt.fragments)]
    ]
    for reg, nm in zip(virt.fragments, models):
        if nm is not None and nm.num_qubits is not None:
            need = virt.programs[reg.name].num_data_qubits
            if need > nm.num_qubits:
                raise ValueError(f"fragment {reg.name} does not fit "
                                 f"backend {nm.name}")
    return models


def run_noisy_virtual_circuit(
    virt: VirtualCircuit,
    noise=None,
    shots: int | None = None,
    seed: int = 0,
    engine: str = "auto",
    chunk_size: int = 512,
    checkpoint_dir=None,
    device=None,
):
    """Noisy analog of ``run.run_virtual_circuit``, on ``device`` (None =
    "cuda").  ``noise`` is one NoiseModel for all fragments, a list
    mapping fragment i -> NoiseModel (the heterogeneous-backend path,
    Utilities.py:106-150), or None to use the per-fragment mapping set
    via ``virt.set_backend``; a fragment whose model is None (or
    untranspiled) runs on the exact engine.

    ``engine="auto"`` / ``"xla"`` (the JAX default): every fragment
    through :func:`run_fragment_noisy` (seed ``seed + i`` for fragment
    i), ``shots`` drawn per variant row, then the knit and the Smolin
    projection on the device.  ``engine="streamed"``: the constant-memory
    label scan with trajectory noise and readout in its body
    (ops/streamed.py; on a card each chunk's label x trajectory rows are
    one launch of the variant kernel), shot-sampled and checkpointable
    (``checkpoint_dir``).  ``engine="sampled"``: Monte-Carlo QPD sampling
    of the NOISY knit (ops/qpd_sampling.sampled_knit, ``noise_seed =
    seed``): ``shots`` is the label-sample budget (each QPD sample is one
    circuit execution on hardware, so the budgets coincide), None the
    plan's Hoeffding budget for eps = 0.05 capped at 2,000,000; then the
    nearest probability distribution.  ``engine="pallas"`` (the exact
    kernel route: noise takes ``"streamed"``, whose rows the variant
    kernel computes) and unknown engines raise ``ValueError``.  Returns
    ``(Distribution, RunTimeInfo)``; on ``engine="streamed"``
    ``RunTimeInfo.noise`` holds the scan's record of its noise, the
    routed op streams and the branch indices drawn
    (``ops.streamed.make_streamed_knit``'s ``meta["noise"]``)."""
    from ..run import RunTimeInfo

    if engine not in ("auto", "xla", "streamed", "sampled"):
        raise ValueError(
            f"noisy execution runs on engine='auto', 'xla', 'streamed' or "
            f"'sampled', not engine={engine!r} (engine='pallas' is the "
            "exact kernel route; on 'streamed' the variant kernel computes "
            "the noisy rows: ROADMAP H100 port, section C, 'On purpose')")
    dev = resolve_device(device)
    models = _resolve_models(virt, noise)

    def clock():
        # device work is asynchronous: a phase ends when the card is done
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    if engine == "sampled":
        from .knit import nearest_probability_distribution
        from .qpd_sampling import sampled_knit, sampling_overhead

        budget = shots
        if budget is None:
            budget = min(sampling_overhead(virt, eps=0.05)["shots_for_eps"],
                         2_000_000)
        now = clock()
        dist = sampled_knit(virt, budget, seed=seed, noise=models,
                            noise_seed=seed, device=dev)
        dist = nearest_probability_distribution(dist)
        return dist, RunTimeInfo(clock() - now, 0.0)
    if engine == "streamed":
        from .streamed import run_virtual_circuit_streamed

        now = clock()
        record: dict = {}
        dist = run_virtual_circuit_streamed(
            virt, chunk=chunk_size, project=True, noise=models,
            shots=shots, seed=seed, checkpoint_dir=checkpoint_dir,
            device=dev, noise_record=record,
        )
        return dist, RunTimeInfo(clock() - now, 0.0,
                                 noise=record or None)
    from .knit import knit_values, smolin_project
    from .variant_engine import run_fragment

    now = clock()
    results = []
    for i, reg in enumerate(virt.fragments):
        nm = models[i]
        if nm is None:
            results.append(run_fragment(virt, reg.name, device=dev))
        else:
            results.append(run_fragment_noisy(
                virt, reg.name, nm, seed=seed + i, chunk_size=chunk_size,
                device=dev))
    if shots is not None:
        from .sampling import sample_fragment_results

        results = sample_fragment_results(results, shots, seed)
    run_time = clock() - now
    now = clock()
    values, positions = knit_values(virt, results)
    knit_time = clock() - now
    values = smolin_project(values).to(torch.float32)
    return (Distribution(values.cpu().numpy(), positions, virt.num_clbits),
            RunTimeInfo(run_time, knit_time))
