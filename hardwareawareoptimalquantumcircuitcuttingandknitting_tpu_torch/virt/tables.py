"""Quasi-probability-decomposition (QPD) tables as data.

Re-derivation of the reference's virtual-gate instantiation circuits and knit
coefficients (third_party/qvm/qvm/virtual_gates.py:58-310) into a uniform,
vmap-friendly representation.  Every instantiation of every cuttable gate is
expressed as one *slot* per endpoint:

    slot = (pre 2x2 unitary, measure flag, post 2x2 unitary)

applied to the endpoint qubit; the measure flag writes the vgate's clbit
(implemented downstream by a deferred-measurement CX onto a per-vgate
ancilla).  The knit step then reduces the variant axis with the signed
coefficient table ``coef[variant, clbit_value]``:

    knitted = sum_v sum_b coef[v, b] * D[..., v, ..., clbit=b, ...]

which is exactly the reference's ``split``+signed-sum knit
(virtual_gates.py:105-124,179-194,262-286, quasi_distr.py:45-53).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..circuit.gates import COMPLEX, H, I2, S, SDG, X, Z, rz

RZZ_ACCURACY = 1e-5  # reference: virtual_gates.py:223


@dataclass
class EndpointVariant:
    pre: np.ndarray = field(default_factory=lambda: I2)
    measure: bool = False
    post: np.ndarray = field(default_factory=lambda: I2)


@dataclass
class VGateSpec:
    """All variants of one virtual gate.

    ``coef[v, b]`` multiplies the distribution slice where the vgate's clbit
    equals ``b`` under variant ``v``.  ``owner_side[v]`` names the endpoint
    (0/1) whose fragment applies the coefficient — the measuring endpoint if
    the variant measures, else endpoint 0 (whose clbit is structurally 0).
    """

    gate_name: str
    endpoints: list[tuple[EndpointVariant, EndpointVariant]]
    coef: np.ndarray            # [n_variants, 2] float64
    owner_side: list[int]

    @property
    def num_instantiations(self) -> int:
        return len(self.endpoints)


def _compose(*mats: np.ndarray) -> np.ndarray:
    """Matrix for applying mats left-to-right in time order."""
    out = I2
    for m in mats:
        out = m @ out
    return np.ascontiguousarray(out.astype(COMPLEX))


def _ev(pre=(), measure=False, post=()) -> EndpointVariant:
    return EndpointVariant(_compose(*pre), measure, _compose(*post))


def move_spec() -> VGateSpec:
    """Wire-cut teleport-by-measurement ("VirtualMove", 8 variants).

    Reference: virtual_gates.py:58-124.  Endpoint 0 = the cut wire's source
    qubit, endpoint 1 = the fresh ancilla the wire moves onto.
    """
    e0 = [
        _ev(),                                  # 0: id / prep |0>
        _ev(),                                  # 1: id / prep |1>
        _ev(pre=[H], measure=True),             # 2: X-basis meas / prep |+>
        _ev(pre=[H], measure=True),             # 3: X-basis meas / prep |->
        _ev(pre=[SDG, H], measure=True),        # 4: Y-basis meas / prep |+i>
        _ev(pre=[SDG, H], measure=True),        # 5: Y-basis meas / prep |-i>
        _ev(measure=True),                      # 6: Z-basis meas / prep |0>
        _ev(measure=True),                      # 7: Z-basis meas / prep |1>
    ]
    e1 = [
        _ev(),
        _ev(pre=[X]),
        _ev(pre=[H]),
        _ev(pre=[X, H]),
        _ev(pre=[H, S]),
        _ev(pre=[X, H, S]),
        _ev(),
        _ev(pre=[X]),
    ]
    sign = np.array([1, 1, 1, -1, 1, -1, 1, -1], dtype=np.float64)
    coef = 0.5 * sign[:, None] * np.array([1.0, -1.0])[None, :]
    return VGateSpec("move", list(zip(e0, e1)), coef, [0] * 8)


def cz_spec() -> VGateSpec:
    """VirtualCZ, 6 variants (virtual_gates.py:153-194)."""
    e0 = [
        _ev(pre=[SDG]),
        _ev(pre=[S]),
        _ev(measure=True),
        _ev(measure=True),
        _ev(),
        _ev(pre=[Z]),
    ]
    e1 = [
        _ev(pre=[SDG]),
        _ev(pre=[S]),
        _ev(),
        _ev(pre=[Z]),
        _ev(measure=True),
        _ev(measure=True),
    ]
    sign = np.array([1, 1, 1, -1, 1, -1], dtype=np.float64)
    coef = 0.5 * sign[:, None] * np.array([1.0, -1.0])[None, :]
    owner = [0, 0, 0, 0, 1, 1]
    return VGateSpec("cz", list(zip(e0, e1)), coef, owner)


def _conjugate_side(
    spec: VGateSpec, side: int, before: np.ndarray, after: np.ndarray, name: str
) -> VGateSpec:
    """Wrap one endpoint's variants: apply ``before`` first and ``after``
    last (the reference composes whole instantiation circuits,
    virtual_gates.py:197-220,294-310)."""
    new_eps = []
    for pair in spec.endpoints:
        ev = pair[side]
        wrapped = EndpointVariant(
            _compose(before, ev.pre), ev.measure, _compose(ev.post, after)
        )
        if side == 0:
            new_eps.append((wrapped, pair[1]))
        else:
            new_eps.append((pair[0], wrapped))
    return VGateSpec(name, new_eps, spec.coef.copy(), list(spec.owner_side))


def cx_spec() -> VGateSpec:
    """VirtualCX = H(target)-conjugated VirtualCZ (virtual_gates.py:197-206)."""
    return _conjugate_side(cz_spec(), 1, H, H, "cx")


def cy_spec() -> VGateSpec:
    """VirtualCY = rz(∓π/2)(target)-conjugated VirtualCX
    (virtual_gates.py:209-220)."""
    return _conjugate_side(cx_spec(), 1, rz(-math.pi / 2), rz(math.pi / 2), "cy")


def rzz_spec(theta: float) -> VGateSpec:
    """VirtualRZZ(theta), 6 variants with cos/sin coefficients and
    near-Clifford special cases (virtual_gates.py:226-291)."""
    m_theta = -theta
    c = math.cos(m_theta / 2)
    s = math.sin(m_theta / 2)

    if abs(c) < RZZ_ACCURACY:
        # single variant: Z x Z, coefficient sin^2
        eps = [(_ev(pre=[Z]), _ev(pre=[Z]))]
        coef = np.array([[s * s, 0.0]])
        return VGateSpec("rzz", eps, coef, [0])
    if abs(s) < RZZ_ACCURACY:
        eps = [(_ev(), _ev())]
        coef = np.array([[c * c, 0.0]])
        return VGateSpec("rzz", eps, coef, [0])

    e0 = [
        _ev(),
        _ev(pre=[Z]),
        _ev(pre=[rz(-math.pi / 2)]),
        _ev(measure=True),
        _ev(pre=[rz(math.pi / 2)]),
        _ev(measure=True),
    ]
    e1 = [
        _ev(),
        _ev(pre=[Z]),
        _ev(measure=True),
        _ev(pre=[rz(-math.pi / 2)]),
        _ev(measure=True),
        _ev(pre=[rz(math.pi / 2)]),
    ]
    cs = c * s
    coef = np.array(
        [
            [c * c, 0.0],
            [s * s, 0.0],
            [cs, -cs],
            [cs, -cs],
            [-cs, cs],
            [-cs, cs],
        ]
    )
    owner = [0, 0, 1, 0, 1, 0]
    return VGateSpec("rzz", list(zip(e0, e1)), coef, owner)


def cphase_spec(theta: float) -> VGateSpec:
    """VirtualCPhase(theta): rz-framed VirtualRZZ(-theta/2)
    (virtual_gates.py:294-310).

    DELIBERATE FIX vs the reference: cp(θ) = [rz(θ/2) ⊗ rz(θ/2)] · rzz(-θ/2)
    up to global phase, so the local frame is rz(θ/2) per qubit.  The
    reference applies rz(λ/2) with λ = -θ/2 (virtual_gates.py:297,302-304),
    which implements cp(θ) followed by a spurious p(-3θ/4) on each qubit and
    degrades its own cut-vs-uncut fidelity on cp-heavy circuits (QFT/AQFT).
    Verified numerically in tests/test_qpd_channels.py.
    """
    lam = -theta / 2
    inner = rzz_spec(lam)
    frame = rz(theta / 2)
    spec = _conjugate_side(inner, 0, frame, I2, "cp")
    spec = _conjugate_side(spec, 1, I2, frame, "cp")
    return spec


def spec_for(name: str, params=()) -> VGateSpec:
    """Registry lookup, mirroring VIRTUAL_GATE_TYPES
    (virtual_gates.py:313-319)."""
    if name == "cx":
        return cx_spec()
    if name == "cy":
        return cy_spec()
    if name == "cz":
        return cz_spec()
    if name == "rzz":
        return rzz_spec(float(params[0]))
    if name in ("cp", "cu1"):
        return cphase_spec(float(params[0]))
    if name in ("move", "swap"):
        return move_spec()
    raise KeyError(f"gate {name!r} is not virtualizable")


# Names the cut searcher may select for gate cuts (Cutter.py:351-354).
VIRTUAL_GATE_NAMES = ("cx", "cy", "cz", "rzz", "cp", "cu1")
