"""A plain replay of a trajectory-noise knit on a calibrated device, in
complex128 states and float64 rows, for circuits whose cut gates are
``cz`` gate cuts.

What it takes from the run it replays, as data: each fragment's routed
op stream (the gates with their matrices on compact placement slots,
each op's device nodes, where each clbit ends, the slot -> device
map, and for the cut's measured bits the device qubit whose readout
they take) and the ``[labels, T, S]`` branch indices drawn.  Everything
else it makes itself:

- the cut gates: the instance's gates whose qubits lie in two
  fragments, in the circuit's order (vgate ``g`` is the g-th), and each
  fragment's slots, the cut gates that touch it in that order;
- each label's variants: global label ``L`` takes variant ``(L //
  6^(G-1-g)) % 6`` of cut ``g`` (the last cut fastest), from the cz
  decomposition of Mitarai and Fujii (arXiv:1909.07534) in the variant
  order of qvm's ``VirtualCZ``, ``b`` the measured bit:

      variant   endpoint 0    endpoint 1    coefficient (b = 0, 1)  owner
      0         sdg           sdg           1/2, -1/2               0
      1         s             s             1/2, -1/2               0
      2         measure       -             1/2, -1/2               0
      3         measure       z             -1/2, 1/2               0
      4         -             measure       1/2, -1/2               1
      5         z             measure       -1/2, 1/2               1

  a measure written to a fresh qubit by a cx (the measured bit is a
  position of the fragment's rows); the owner's fragment weighs its rows
  by the coefficient of the bit it reads (the bit stays 0 where the
  owner does not measure), the other fragment by 1;
- the noise sites and their rates, from its own regeneration of the
  device's calibration (:func:`calibration`): after every gate on
  device qubits (``u`` ops whose device nodes are all known) one
  depolarising site on the gate's first qubit, at the qubit's 1q rate or
  the mean of the two qubits' 2q rates; after each cut endpoint's last
  op (``slot_post``) one site at half the 2q rate of the endpoint's
  device node; none on the deferral bookkeeping (``u_aux``);
- the branches: draw 0, 1, 2, 3 applies I, X, Y, Z after the site's op;
- each label's row, the mean over its T trajectories of ``|psi|^2`` on
  the fragment's positions, then every bit through its device qubit's
  readout matrix ``[[1 - e01, e10], [e01, 1 - e10]]``;
- the knit, the sum over labels of the product of the fragments' rows
  weighed by their coefficients, and the Smolin projection onto the
  simplex (qvm's ``quasi_distr.nearest_probability_distribution``).

A trajectory whose every draw is 0 is the label's noise-free circuit, so
such rows are taken from the label's noise-free row (which the routing
term knits anyway) and only the others are simulated.  TF32 is off:
every product here is float64 or complex128.
"""
import math

import numpy as np
import torch

from . import statevector

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# IBM Falcon r5.11 (27 qubits, heavy hex), the coupling of FakeKolkataV2
HEAVY_HEX_27 = [
    (0, 1), (1, 2), (1, 4), (2, 3), (3, 5), (4, 7), (5, 8), (6, 7),
    (7, 10), (8, 9), (8, 11), (10, 12), (11, 14), (12, 13), (12, 15),
    (13, 14), (14, 16), (15, 18), (16, 19), (17, 18), (18, 21), (19, 20),
    (19, 22), (21, 23), (22, 25), (23, 24), (24, 25), (25, 26),
]
COUPLINGS = {"heavy_hex_27": HEAVY_HEX_27}
STATE_BYTES = 512 << 20   # the whole states of one block of rows

_S = np.diag([1.0, 1j])
_SDG = np.diag([1.0, -1j])
_Z = np.diag([1.0, -1.0]).astype(complex)
_I = np.eye(2, dtype=complex)
_PAULI = np.stack([_I, np.array([[0, 1], [1, 0]], complex),
                   np.array([[0, -1j], [1j, 0]]), _Z])
_CX = statevector.gate_matrix("cx")
# the cz decomposition's table above: local gate per (variant, side),
# measure flags, coefficients [variant, b], owner side
CZ_LOCAL = np.array([[_SDG, _SDG], [_S, _S], [_I, _I], [_I, _Z],
                     [_I, _I], [_Z, _I]])
CZ_MEASURE = np.array([[False, False], [False, False], [True, False],
                       [True, False], [False, True], [False, True]])
CZ_COEF = 0.5 * np.array([[1, -1], [1, -1], [1, -1], [-1, 1], [1, -1],
                          [-1, 1]], np.float64)
CZ_OWNER = np.array([0, 0, 0, 0, 1, 1])


def calibration(seed: int = 27) -> dict:
    """The per-qubit rates of the 27-qubit device model, float64: a
    log-normal spread around the device class's medians (1q 2.5e-4, 2q
    2.5e-3, readout P(1|0) 0.008 and P(0|1) 0.017, sigma 0.5, 0.5, 0.4,
    0.4), each clipped to a sixth and six times its median, drawn in
    that order from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def spread(med, s):
        return np.clip(med * rng.lognormal(0.0, s, 27), med / 6.0, med * 6.0)

    return {"p1": spread(2.5e-4, 0.5), "p2": spread(2.5e-3, 0.5),
            "ro01": spread(0.008, 0.4), "ro10": spread(0.017, 0.4)}


def _apply(state, mat, axes):
    """``mat`` ([d, d], or [R, d, d] one per row) on the qubit ``axes``
    of ``state [R, 2, ..., 2]``, the first of ``axes`` the most
    significant bit of the gate's index."""
    n, k = state.dim() - 1, len(axes)
    src = [1 + a for a in axes]
    tail = list(range(n + 1 - k, n + 1))
    st = torch.movedim(state, src, tail)
    shape = st.shape
    st = st.reshape(shape[0], -1, 1 << k)
    st = st @ mat.transpose(-1, -2) if mat.dim() == 2 else \
        torch.einsum("rij,rxj->rxi", mat, st)
    return torch.movedim(st.reshape(shape), tail, src)


def fragment_cuts(instance, data_clbits) -> tuple[list, list]:
    """``(cuts, slots)``: per cut gate, in the circuit's order, its
    name; per fragment (each a list of its data clbits, measure_all) the
    ``(cut, side)`` of its slots in order.  Raises where a qubit lies in
    no fragment or a gate in more than two."""
    qubit_of = statevector.measured_clbits(instance)
    frag_of = {qubit_of[c]: f for f, cl in enumerate(data_clbits)
               for c in cl}
    if sorted(frag_of) != list(range(instance["num_qubits"])):
        raise ValueError("the fragments do not cover the qubits once each")
    cuts, slots = [], [[] for _ in data_clbits]
    for name, gq, _ in instance["gates"]:
        frags = [frag_of[q] for q in gq]
        if len(set(frags)) == 1:
            continue
        if len(gq) != 2:
            raise ValueError(f"a cut {name!r} on {len(gq)} qubits")
        for side, f in enumerate(frags):
            slots[f].append((len(cuts), side))
        cuts.append(name)
    return cuts, slots


def label_variants(num_cuts: int, labels, device) -> torch.Tensor:
    """``[len(labels), num_cuts]`` variants of the global labels, the
    last cut fastest, 6 variants a cut."""
    lab = torch.as_tensor(np.asarray(labels), device=device).long()
    div = 6 ** torch.arange(num_cuts - 1, -1, -1, device=device)
    return (lab[:, None] // div) % 6


def noise_sites(frag, rates) -> list:
    """``[(op index, sim qubit, rate)]`` of a fragment's routed stream,
    in the stream's order (the module docstring's rule)."""
    if frag["phys"] is None:
        raise ValueError("the stream is not routed")
    sites = []
    for i, ((kind, _, axes), dev) in enumerate(zip(frag["ops"],
                                                   frag["phys"])):
        if kind == "u" and all(d is not None for d in dev):
            p = (rates["p1"][dev[0]] if len(dev) == 1 else
                 0.5 * (rates["p2"][dev[0]] + rates["p2"][dev[1]]))
            sites.append((i, axes[0], float(p)))
        elif kind == "slot_post":
            sites.append((i, axes[0], float(0.5 * rates["p2"][dev[0]])))
    return sites


def simulate_rows(frag, slots, variants, draws, sites, device):
    """``[R, 2^len(positions)]`` float64 ``|psi|^2`` of R rows of one
    fragment: ``variants [R, cuts]``, ``draws [R, S]`` (None: every
    branch the identity), ``slots`` the fragment's ``(cut, side)``.  A
    qubit enters the state in |0> at its first op, so a cut's measuring
    qubit costs nothing before its measure."""
    r = variants.shape[0]
    state = torch.ones((r,), dtype=torch.complex128, device=device)
    active = []                   # the state's qubits, axis 1 first

    def axes_of(qubits):
        nonlocal state
        for q in qubits:
            if q not in active:
                state = torch.stack([state, torch.zeros_like(state)], -1)
                active.append(q)
        return [active.index(q) for q in qubits]

    def tensor(m):
        return torch.as_tensor(np.asarray(m), device=device)

    gates = {id(m): tensor(np.asarray(m, np.complex128))
             for kind, m, _ in frag["ops"] if kind in ("u", "u_aux")}
    local, measure = tensor(CZ_LOCAL), tensor(CZ_MEASURE)
    pauli, cx = tensor(_PAULI), tensor(_CX)
    after = {}
    for s, (i, q, _) in enumerate(sites):
        after.setdefault(i, []).append((s, q))
    for i, (kind, payload, axes) in enumerate(frag["ops"]):
        ax = axes_of(axes)
        if kind in ("u", "u_aux"):
            state = _apply(state, gates[id(payload)], ax)
        else:
            cut, side = slots[payload]
            v = variants[:, cut]
            if kind == "slot_pre":
                state = _apply(state, local[v, side], ax)
            elif kind == "slot_meas":
                hit = measure[v, side]
                if bool(hit.any()):
                    idx = hit.nonzero().squeeze(1)
                    state[idx] = _apply(state[idx], cx, ax)
            elif kind != "slot_post":
                raise ValueError(f"an op {kind!r} in the stream")
        if draws is None:
            continue
        for s, q in after.get(i, ()):
            hit = draws[:, s] != 0
            if bool(hit.any()):
                idx = hit.nonzero().squeeze(1)
                state[idx] = _apply(state[idx], pauli[draws[idx, s]],
                                    axes_of([q]))
    src = axes_of([frag["clbit_sources"][c] for c in frag["positions"]])
    probs = state.real ** 2 + state.imag ** 2
    drop = [1 + a for a in range(len(active)) if a not in src]
    if drop:
        probs = probs.sum(dim=drop)
    # the last position's axis first, so that positions[0] is the lowest
    # bit
    order = sorted(src)
    perm = [0] + [1 + order.index(a) for a in reversed(src)]
    return probs.permute(perm).reshape(r, -1)


def _blocks(total: int, num_sim: int):
    step = max(1, STATE_BYTES // (16 << num_sim))
    for lo in range(0, total, step):
        yield lo, min(total, lo + step)


def readout(rows, frag, rates, num_clbits):
    """Every bit of ``rows [R, 2^k]`` through its device qubit's readout
    matrix: a data bit's qubit is the device node its value ends on
    (``slot_device`` of its source), a cut's bit the stream's
    ``readout_qubits``; raises where a data bit's disagrees."""
    r, k = rows.shape[0], len(frag["positions"])
    for j, c in enumerate(frag["positions"]):
        q = frag["readout_qubits"][j]
        if c < num_clbits and \
                q != frag["slot_device"][frag["clbit_sources"][c]]:
            raise ValueError(f"clbit {c} is read out on qubit {q}, its "
                             "value ends elsewhere")
        e01, e10 = float(rates["ro01"][q]), float(rates["ro10"][q])
        m = torch.tensor([[1 - e01, e10], [e01, 1 - e10]],
                         dtype=torch.float64, device=rows.device)
        r4 = rows.reshape(r, 1 << (k - 1 - j), 2, 1 << j)
        rows = torch.einsum("ab,rhbl->rhal", m, r4).reshape(r, -1)
    return rows


def fold(rows, frag, slots, variants, num_clbits):
    """``[L, 2^d]``: the fragment's rows weighed by each cut's
    coefficients, its cut bits summed out; ``d`` data bits, ascending."""
    pos = list(frag["positions"])
    lab = rows.shape[0]
    w_all = torch.as_tensor(CZ_COEF, device=rows.device)
    owner = torch.as_tensor(CZ_OWNER, device=rows.device)
    for cut, side in slots:
        v = variants[:, cut]
        w = torch.where((owner[v] == side)[:, None], w_all[v],
                        torch.ones_like(w_all[v]))
        c = num_clbits + cut
        if c not in pos:
            rows = rows * w[:, :1]
            continue
        j, k = pos.index(c), len(pos)
        r4 = rows.reshape(lab, 1 << (k - 1 - j), 2, 1 << j)
        rows = (r4[:, :, 0] * w[:, 0, None, None]
                + r4[:, :, 1] * w[:, 1, None, None]).reshape(lab, -1)
        pos.pop(j)
    return rows, pos


def knit(folded, num_clbits) -> torch.Tensor:
    """The sum over labels of the product of the fragments' folded rows
    (two fragments), laid out over clbits 0..num_clbits-1, clbit 0 the
    lowest bit."""
    (e0, d0), (e1, d1) = folded
    if sorted(d0 + d1) != list(range(num_clbits)):
        raise ValueError("the fragments' data bits are not the clbits")
    out = e0.transpose(0, 1) @ e1            # [2^|d0|, 2^|d1|]
    # axis a of a fragment's [2] * k view is its bit k-1-a
    axes = list(reversed(d0)) + list(reversed(d1))
    out = out.reshape([2] * num_clbits)
    return out.permute([axes.index(c) for c in
                        reversed(range(num_clbits))]).reshape(-1)


def smolin(values) -> torch.Tensor:
    """The nearest probability distribution (Smolin, Gambetta, Smith,
    arXiv:1106.5458), qvm's ascending scan: the smallest entries are
    zeroed while their deficit, shared over those left, keeps an entry
    negative; the rest take that share."""
    v = values.to(torch.float64)
    n = v.numel()
    sv, order = torch.sort(v)
    before = torch.cumsum(sv, 0) - sv          # sum of the smaller ones
    left = n - torch.arange(n, dtype=torch.float64, device=v.device)
    keep = sv + before / left >= 0
    k = int(keep.to(torch.int8).argmax()) if bool(keep.any()) else n
    out = torch.zeros_like(v)
    if k < n:
        out[order[k:]] = sv[k:] + before[k] / (n - k)
    return out


class Replay:
    """One answer's replay: ``clean`` (the knit of the noise-free
    streams without readout), ``noisy`` (the projected replay of the
    draws), and the draws' site counts; built lazily per fragment."""

    def __init__(self, instance, record, seed, device):
        self.inst, self.rec, self.dev = instance, record, device
        self.n = instance["num_qubits"]
        self.rates = calibration(seed)
        frags = record["fragments"]
        if any(f is None for f in frags) or len(frags) != 2:
            raise ValueError("the replay takes two noisy fragments")
        self.frags = frags
        data = [[c for c in f["positions"] if c < self.n] for f in frags]
        self.cut_names, self.slots = fragment_cuts(instance, data)
        if set(self.cut_names) != {"cz"}:
            raise ValueError(f"cut gates {set(self.cut_names)}: the replay "
                             "knows cz")
        self.labels = int(record["labels"])
        if self.labels != 6 ** len(self.cut_names):
            raise ValueError("the record's labels are not 6^cuts")
        self.var = label_variants(len(self.cut_names),
                                  np.arange(self.labels), device)
        self.sites = [noise_sites(f, self.rates) for f in frags]
        self._clean = [None, None]

    def num_sim(self, f) -> int:
        frag = self.frags[f]
        top = max(max(a) for _, _, a in frag["ops"] if a)
        return max(top, max(frag["clbit_sources"].values())) + 1

    def clean_rows(self, f) -> torch.Tensor:
        """``[L, 2^k]`` noise-free rows of fragment f, no readout."""
        if self._clean[f] is None:
            n_sim = self.num_sim(f)
            parts = [simulate_rows(self.frags[f], self.slots[f],
                                   self.var[lo:hi], None, self.sites[f],
                                   self.dev)
                     for lo, hi in _blocks(self.labels, n_sim)]
            self._clean[f] = torch.cat(parts)
        return self._clean[f]

    def mean_rows(self, f) -> torch.Tensor:
        """``[L, 2^k]``: each label's mean over its trajectories, a
        trajectory without a non-identity draw taken as the label's
        noise-free row."""
        frag = self.frags[f]
        draws = torch.as_tensor(np.asarray(frag["draws"][:self.labels]),
                                device=self.dev).long()
        t = draws.shape[1]
        clean = self.clean_rows(f)
        dirty = (draws != 0).any(dim=2)                 # [L, T]
        out = clean * (t - dirty.sum(1, keepdim=True)).to(clean.dtype)
        lab, traj = dirty.nonzero(as_tuple=True)
        n_sim = self.num_sim(f)
        for lo, hi in _blocks(lab.numel(), n_sim):
            rows = simulate_rows(frag, self.slots[f], self.var[lab[lo:hi]],
                                 draws[lab[lo:hi], traj[lo:hi]],
                                 self.sites[f], self.dev)
            out.index_add_(0, lab[lo:hi], rows)
        return out / t

    def exact(self) -> torch.Tensor:
        """The knit of the noise-free streams, no readout, unprojected."""
        folded = [fold(self.clean_rows(f), self.frags[f], self.slots[f],
                       self.var, self.n) for f in range(2)]
        return knit(folded, self.n)

    def noisy(self) -> torch.Tensor:
        """The replay of the draws: readout, knit, projection."""
        folded = []
        for f in range(2):
            rows = readout(self.mean_rows(f), self.frags[f], self.rates,
                           self.n)
            folded.append(fold(rows, self.frags[f], self.slots[f],
                               self.var, self.n))
        return smolin(knit(folded, self.n))

    def site_z(self, f) -> torch.Tensor:
        """Per site of fragment f: ``|N - L T p| / sqrt(L T p (1 - p))``,
        N its non-identity draws over labels x trajectories."""
        draws = np.asarray(self.frags[f]["draws"][:self.labels])
        if draws.shape[2] != len(self.sites[f]):
            raise ValueError(f"{draws.shape[2]} sites drawn, "
                             f"{len(self.sites[f])} in the stream")
        lt = draws.shape[0] * draws.shape[1]
        count = (draws != 0).sum(axis=(0, 1)).astype(np.float64)
        p = np.array([s[2] for s in self.sites[f]])
        return torch.as_tensor(np.abs(count - lt * p)
                               / np.sqrt(lt * p * (1 - p)))

    def off_coupling(self, coupling) -> int:
        """The two-qubit gates of the streams on device qubits that the
        coupling does not join."""
        edges = {frozenset(e) for e in coupling}
        bad = 0
        for frag in self.frags:
            for (kind, _, axes), dev in zip(frag["ops"], frag["phys"]):
                if kind == "u" and len(axes) == 2 and \
                        all(d is not None for d in dev):
                    bad += frozenset(dev) not in edges
        return bad


def total_variation(a, b) -> float:
    return float(0.5 * (a.to(torch.float64) - b.to(torch.float64)).abs()
                 .sum())


def uncut(instance, device) -> torch.Tensor:
    """The uncut circuit's noise-free distribution over every clbit."""
    return statevector.distribution(instance, None, device)[0]


def nan_to_inf(x: float) -> float:
    return math.inf if not math.isfinite(x) else x
