"""Gate library: names, arities and unitary matrices.

First-party replacement for the role qiskit's gate classes play in the
reference (its src/HwAwareCutter/Cutter.py:10-18 imports qiskit gates).  All matrices follow the convention that for a k-qubit gate
applied to qubits ``(q_0, ..., q_{k-1})`` the matrix basis index is
``b(q_0) * 2^{k-1} + ... + b(q_{k-1})`` — i.e. the *first listed qubit is the
most significant bit of the gate-local index*.  Distribution keys produced by
the framework are little-endian in the global clbit index (clbit 0 is the LSB
of the integer key), matching the reference's
``QuasiDistr.from_counts`` (third_party/qvm/qvm/quasi_distr.py:13-20).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

COMPLEX = np.complex64
_SQ2 = 1.0 / math.sqrt(2.0)

I2 = np.eye(2, dtype=COMPLEX)
X = np.array([[0, 1], [1, 0]], dtype=COMPLEX)
Y = np.array([[0, -1j], [1j, 0]], dtype=COMPLEX)
Z = np.array([[1, 0], [0, -1]], dtype=COMPLEX)
H = np.array([[_SQ2, _SQ2], [_SQ2, -_SQ2]], dtype=COMPLEX)
S = np.array([[1, 0], [0, 1j]], dtype=COMPLEX)
SDG = np.array([[1, 0], [0, -1j]], dtype=COMPLEX)
T = np.array([[1, 0], [0, np.exp(1j * math.pi / 4)]], dtype=COMPLEX)
TDG = np.array([[1, 0], [0, np.exp(-1j * math.pi / 4)]], dtype=COMPLEX)
SX = 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]], dtype=COMPLEX)
SXDG = 0.5 * np.array([[1 - 1j, 1 + 1j], [1 + 1j, 1 - 1j]], dtype=COMPLEX)


def rx(theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=COMPLEX)


def ry(theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=COMPLEX)


def rz(theta: float) -> np.ndarray:
    return np.array(
        [[np.exp(-0.5j * theta), 0], [0, np.exp(0.5j * theta)]], dtype=COMPLEX
    )


def phase(lam: float) -> np.ndarray:
    return np.array([[1, 0], [0, np.exp(1j * lam)]], dtype=COMPLEX)


def u3(theta: float, phi: float, lam: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array(
        [
            [c, -np.exp(1j * lam) * s],
            [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
        ],
        dtype=COMPLEX,
    )


def u2(phi: float, lam: float) -> np.ndarray:
    return u3(math.pi / 2, phi, lam)


def _ctrl(u: np.ndarray) -> np.ndarray:
    """Controlled-U on (control, target); control is gate-local MSB."""
    out = np.eye(4, dtype=COMPLEX)
    out[2:, 2:] = u
    return out


CX = _ctrl(X)
CY = _ctrl(Y)
CZ = _ctrl(Z)
SWAP = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=COMPLEX
)
ISWAP = np.array(
    [[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]], dtype=COMPLEX
)


def rzz(theta: float) -> np.ndarray:
    e_m = np.exp(-0.5j * theta)
    e_p = np.exp(0.5j * theta)
    return np.diag([e_m, e_p, e_p, e_m]).astype(COMPLEX)


def cphase(lam: float) -> np.ndarray:
    return np.diag([1, 1, 1, np.exp(1j * lam)]).astype(COMPLEX)


def crz(theta: float) -> np.ndarray:
    return _ctrl(rz(theta))


def fsim(theta: float, phi: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array(
        [
            [1, 0, 0, 0],
            [0, c, -1j * s, 0],
            [0, -1j * s, c, 0],
            [0, 0, 0, np.exp(-1j * phi)],
        ],
        dtype=COMPLEX,
    )


# name -> (num_qubits, num_params, matrix factory)
_FIXED_1Q = {
    "id": I2, "x": X, "y": Y, "z": Z, "h": H, "s": S, "sdg": SDG,
    "t": T, "tdg": TDG, "sx": SX, "sxdg": SXDG,
}
_FIXED_2Q = {"cx": CX, "cy": CY, "cz": CZ, "swap": SWAP, "iswap": ISWAP}
_PARAM_1Q = {"rx": rx, "ry": ry, "rz": rz, "p": phase, "u1": phase,
             "u2": u2, "u3": u3, "u": u3}
_PARAM_2Q = {"rzz": rzz, "cp": cphase, "cu1": cphase, "crz": crz, "fsim": fsim}

GATE_ARITY = {**{n: 1 for n in _FIXED_1Q}, **{n: 2 for n in _FIXED_2Q},
              **{n: 1 for n in _PARAM_1Q}, **{n: 2 for n in _PARAM_2Q},
              "ccx": 3, "measure": 1, "barrier": None, "reset": 1,
              "initialize": None}

NON_UNITARY = {"measure", "barrier", "reset", "initialize"}


@lru_cache(maxsize=4096)
def _matrix_cached(name: str, params: tuple) -> np.ndarray:
    if name in _FIXED_1Q:
        out = _FIXED_1Q[name]
    elif name in _FIXED_2Q:
        out = _FIXED_2Q[name]
    elif name in _PARAM_1Q:
        out = _PARAM_1Q[name](*params)
    elif name in _PARAM_2Q:
        out = _PARAM_2Q[name](*params)
    elif name == "ccx":
        out = np.eye(8, dtype=COMPLEX)
        out[6:, 6:] = X
    else:
        raise KeyError(f"no matrix for gate {name!r}")
    # cached (and module-constant) arrays are shared across every caller:
    # freeze them so an accidental in-place edit can't corrupt a gate
    # globally for the rest of the process
    out.setflags(write=False)
    return out


def gate_matrix(name: str, params=()) -> np.ndarray:
    """Unitary matrix for a gate, cached on (name, params)."""
    return _matrix_cached(name, tuple(float(p) for p in params))
