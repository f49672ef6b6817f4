"""Exact simulation of a gate list as a sum of products of two blocks.

The qubits are split at a boundary ``b``: qubits ``0..b-1`` are the
left block, ``b..n-1`` the right.  The state is held as

    |psi> = sum_k L_k (x) R_k,

stacked as ``L [K] + [2] * b`` and ``R [K] + [2] * (n - b)`` complex128
tensors (axis ``1 + q`` is qubit ``q`` of the block).  A gate on one
side applies to that side's stack alone.  A two-qubit gate across the
boundary is applied by its operator-Schmidt decomposition, the SVD of
its 4x4 matrix regrouped as (left out, left in) x (right out, right in):
``U = sum_s A_s (x) B_s``, each ``A_s`` and ``B_s`` scaled by the root
of its singular value, so ``K`` grows by the rank (2 for ``cx`` and
``cz``).  Nothing is cut and nothing is sampled: a circuit that crosses
the boundary ``d`` times with ``cx`` is exact at ``K = 2^d``, two blocks
of ``2^b`` and ``2^(n-b)`` amplitudes a term.

The marginal on kept clbits (``measure_all``: clbit ``c`` is qubit
``c``), ``a`` the kept bits of the left block and ``c`` of the right, is

    p(a, c) = Re sum_{k,l} A_kl(a) B_kl(c),
    A_kl(a) = sum_x conj(L_k[a, x]) L_l[a, x],

``x`` the left qubits not kept (``B`` likewise on the right), laid out
as the port lays out a ``Distribution``: entry ``i`` is the outcome
whose j-th sorted clbit is bit j of ``i``.  Plain PyTorch in complex128
on whichever device it is given, TF32 off; the gate matrices are
``statevector.py``'s.  Nothing here imports the port.
"""
import contextlib

import numpy as np
import torch

from .statevector import gate_matrix, measured_clbits


def _apply(stack: torch.Tensor, u: torch.Tensor, axes) -> torch.Tensor:
    """``u`` (a ``[2^k, 2^k]`` matrix, first axis its most significant
    bit) on the block axes ``axes`` of every term of ``stack``."""
    k = len(axes)
    dims = [1 + a for a in axes]
    out = torch.tensordot(u.reshape([2] * (2 * k)), stack,
                          dims=(list(range(k, 2 * k)), dims))
    # tensordot puts the gate's output axes first
    return torch.movedim(out, list(range(k)), dims)


def schmidt_factors(matrix) -> list:
    """``[(A_s, B_s)]``: 2x2 complex128 matrices with ``matrix == sum_s
    kron(A_s, B_s)``, A on the gate's first qubit; the terms of
    nonzero singular value only."""
    m = np.asarray(matrix, dtype=complex).reshape(2, 2, 2, 2)
    # (out1, out2, in1, in2) -> (out1, in1) x (out2, in2)
    m = m.transpose(0, 2, 1, 3).reshape(4, 4)
    u, s, vh = np.linalg.svd(m)
    keep = s > 1e-12 * s[0]
    return [(np.sqrt(s[j]) * u[:, j].reshape(2, 2),
             np.sqrt(s[j]) * vh[j].reshape(2, 2))
            for j in np.flatnonzero(keep)]


class TwoBlocks:
    """The two stacks of a state split at ``boundary``."""

    def __init__(self, num_qubits: int, boundary: int, device="cpu"):
        if not 0 < boundary < num_qubits:
            raise ValueError(f"boundary {boundary} does not split "
                             f"{num_qubits} qubits")
        self.n, self.b, self.device = num_qubits, boundary, device
        self.left = self._zero(boundary)
        self.right = self._zero(num_qubits - boundary)
        self._mats = {}

    def _zero(self, width: int) -> torch.Tensor:
        st = torch.zeros(1 << width, dtype=torch.complex128,
                         device=self.device)
        st[0] = 1.0
        return st.reshape([1] + [2] * width)

    def _matrix(self, m) -> torch.Tensor:
        return torch.as_tensor(np.asarray(m, dtype=complex),
                               device=self.device)

    @property
    def terms(self) -> int:
        return self.left.shape[0]

    def apply(self, name: str, qubits, params=()) -> None:
        key = (name, tuple(params))
        if key not in self._mats:
            self._mats[key] = gate_matrix(name, params)
        m = self._mats[key]
        sides = [q >= self.b for q in qubits]
        if not any(sides):
            self.left = _apply(self.left, self._matrix(m), list(qubits))
        elif all(sides):
            self.right = _apply(self.right, self._matrix(m),
                                [q - self.b for q in qubits])
        elif len(qubits) == 2:
            self._across(m, qubits)
        else:
            raise ValueError(f"gate {name} on {qubits} spans the boundary "
                             "with more than two qubits")

    def _across(self, m, qubits) -> None:
        q1, q2 = qubits
        factors = schmidt_factors(m)
        if q1 >= self.b:  # the gate's first qubit is on the right
            factors = [(b, a) for a, b in factors]
            q1, q2 = q2, q1
        self.left = torch.cat([_apply(self.left, self._matrix(a), [q1])
                               for a, _ in factors])
        self.right = torch.cat([_apply(self.right, self._matrix(b),
                                       [q2 - self.b])
                                for _, b in factors])

    def _gram(self, stack: torch.Tensor, kept) -> torch.Tensor:
        """``[K, K, 2^len(kept)]``: sum over the other axes of
        ``conj(stack_k) * stack_l``, the kept index with ``kept[0]`` its
        least significant bit."""
        width = stack.dim() - 1
        kept_axes = [1 + q for q in reversed(kept)]
        rest = [1 + q for q in range(width) if q not in kept]
        flat = stack.permute([0] + kept_axes + rest).reshape(
            stack.shape[0], 1 << len(kept), -1)
        return torch.einsum("kax,lax->kla", flat.conj(), flat)

    def marginal(self, qubits) -> torch.Tensor:
        """The probability of each outcome of ``qubits`` (sorted), float64,
        entry ``i`` the outcome whose j-th qubit is bit j of ``i``."""
        qubits = sorted(qubits)
        left = [q for q in qubits if q < self.b]
        right = [q - self.b for q in qubits if q >= self.b]
        a = self._gram(self.left, left)
        c = self._gram(self.right, right)
        p = torch.einsum("kla,klc->ca", a, c)
        return p.real.reshape(-1)


def distribution(instance, keep=None, boundary=None,
                 device="cpu") -> tuple[torch.Tensor, list]:
    """``(probabilities, clbits)``: the exact distribution over the
    measured clbits (or the kept ones), float64 on ``device``, laid out
    as ``statevector.distribution`` lays it out.  ``boundary``: the
    first qubit of the right block (default half the qubits)."""
    qubit_of = measured_clbits(instance)
    clbits = sorted(qubit_of if keep is None else keep)
    n = instance["num_qubits"]
    with _no_tf32():
        state = TwoBlocks(n, n // 2 if boundary is None else boundary,
                          device)
        for name, qubits, params in instance["gates"]:
            state.apply(name, tuple(qubits), tuple(params))
        return state.marginal([qubit_of[c] for c in clbits]), clbits


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for the block, as it was after."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = was
