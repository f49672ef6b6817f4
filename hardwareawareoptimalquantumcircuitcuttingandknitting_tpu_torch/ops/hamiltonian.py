"""Pauli-string observables and Hamiltonian energies on cut circuits.

Port of the JAX package's ``ops/hamiltonian.py``:

  * a Hamiltonian is a list of ``(coeff, pauli_string)`` terms
    (string index i = qubit i, letters IXYZ),
  * terms are grouped by qubit-wise commutation; each group is measured by
    ONE cut-circuit execution in its rotated basis (H for X, S-dagger then
    H for Y),
  * :func:`make_hamiltonian_energy` composes the groups with the
    differentiable sweep (ops/sweep.make_differentiable_sweep) into one
    ``energy(theta)`` that ``torch.autograd`` differentiates — gradient-
    based VQE on circuits too large for one device.

The cut plan is solved ONCE (basis rotations are 1q gates and don't alter
the cut graph) and re-applied to every measurement group via
``Cutter.use_plan``, so all groups share one fragment structure.  The
grouping, the measurement circuits and the dense matrix are host numpy,
as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..circuit.circuit import Circuit

_I2 = np.eye(2, dtype=complex)
_PAULI = {
    "I": _I2,
    "X": np.array([[0, 1], [1, 0]], dtype=complex),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=complex),
    "Z": np.array([[1, 0], [0, -1]], dtype=complex),
}


def _validate(terms, n_qubits: int):
    out = []
    for coeff, pauli in terms:
        pauli = str(pauli).upper()
        if len(pauli) != n_qubits:
            raise ValueError(
                f"pauli {pauli!r} has {len(pauli)} letters for "
                f"{n_qubits} qubits"
            )
        if any(ch not in _PAULI for ch in pauli):
            raise ValueError(f"pauli {pauli!r}: letters must be I/X/Y/Z")
        out.append((float(coeff), pauli))
    return out


def group_qubitwise(terms):
    """Greedy qubit-wise-commuting grouping.  Returns a list of
    ``(basis, group_terms)``: ``basis`` is one string whose letter per
    qubit is the group's shared non-I operator (or I); every term in
    ``group_terms`` agrees with it on its own support."""
    groups: list[tuple[list[str], list]] = []
    for coeff, pauli in terms:
        placed = False
        for basis, members in groups:
            if all(
                p == "I" or basis[q] == "I" or basis[q] == p
                for q, p in enumerate(pauli)
            ):
                for q, p in enumerate(pauli):
                    if p != "I":
                        basis[q] = p
                members.append((coeff, pauli))
                placed = True
                break
        if not placed:
            groups.append(([*pauli], [(coeff, pauli)]))
    return [("".join(basis), members) for basis, members in groups]


def measurement_circuit(ansatz: Circuit, basis: str) -> Circuit:
    """Copy of ``ansatz`` with the basis rotation (X: H; Y: Sdg then H —
    both map the operator onto Z) and a full measure layer appended.
    Ansatzes built without clbits (the natural variational shape, e.g.
    models.qaoa.construct_qaoa_plus) get a ``meas`` register added."""
    if any(ins.name == "measure" for ins in ansatz.instructions):
        raise ValueError("ansatz must not contain measurements")
    c = ansatz.copy()
    if c.num_clbits < ansatz.num_qubits:
        from ..circuit.circuit import Register

        taken = {r.name for r in c.cregs}
        name = "meas"
        while name in taken:
            name += "_"
        c.add_creg(Register(name, ansatz.num_qubits - c.num_clbits))
    for q, b in enumerate(basis):
        if b == "X":
            c.h(q)
        elif b == "Y":
            c.sdg(q)
            c.h(q)
    for q in range(ansatz.num_qubits):
        c.measure(q, q)
    return c


def dense_matrix(terms, n_qubits: int) -> np.ndarray:
    """[2^n, 2^n] Hermitian matrix of the Hamiltonian; qubit 0 is the MSB
    of the flat index (the statevector convention)."""
    terms = _validate(terms, n_qubits)
    h = np.zeros((1 << n_qubits, 1 << n_qubits), dtype=complex)
    for coeff, pauli in terms:
        m = np.eye(1, dtype=complex)
        for ch in pauli:  # qubit 0 first => outermost kron factor => MSB
            m = np.kron(m, _PAULI[ch])
        h += coeff * m
    return h


@dataclass
class HamiltonianEnergyInfo:
    n_params: int
    n_groups: int
    constant: float
    plan: object  # the shared CutPlan
    instances_per_step: int  # QPD instances executed per energy evaluation


def make_hamiltonian_energy(ansatz: Circuit, cutter_kwargs: dict, terms,
                            contract: bool | None = None, mesh=None,
                            num_samples: int | None = None,
                            sample_seed: int = 0,
                            sample_method: str = "iid", device=None):
    """Build ``energy(theta)`` for ``<psi(theta)| H |psi(theta)>`` on the
    CUT ansatz.  ``ansatz`` carries :class:`~..circuit.circuit.ParamRef`
    angles (measurement-free); ``cutter_kwargs`` go to
    :class:`~..cutter.cutter.Cutter`.  Returns ``(energy, info)`` where
    ``energy(theta)`` (theta ``[info.n_params]``, numpy or a tensor) is a
    0-d float32 tensor that ``torch.autograd`` differentiates w.r.t.
    theta.

    One cut solve serves every measurement group (1q basis rotations do
    not change the cut graph), one runner per group.

    ``contract``: True routes each group through the fragment parity
    contraction (ops/knit.expectation_z_multi) — expectations come
    straight off the variant axes and NOTHING of size 2^n is built, so
    VQE runs at any circuit width.  False knits the full distribution
    per group and dots it with parity diagonals.  None (default) picks
    the contraction above 12 qubits.

    ``mesh`` (a ``parallel.mesh.Mesh`` with a ``"dp"`` axis): every
    fragment's QPD variant rows are split over ``dp`` and gathered
    before the knit (ops/sweep.py); energy and gradient are the
    unsharded ones on every rank.  A mesh of one rank changes nothing.

    ``num_samples``: STOCHASTIC VQE — every group's expectations are the
    Monte-Carlo QPD estimator over ONE shared label sample
    (ops/sweep.make_sampled_sweep) instead of the full variant grid.
    The fixed labels are common random numbers across theta, so
    gradients and energy differences are unbiased with the sampling
    noise differenced out.  ``sample_method="lhs"`` draws the labels
    balanced.  Implies the contraction path (``contract=False`` is
    rejected).

    ``device``: where the energy is computed (None: the mesh's device,
    else the card; raises without one — pass ``device="cpu"``).
    """
    from ..convert import resolve_device
    from ..cutter.cutter import Cutter
    from ..parallel.mesh import variant_sharding as _variant_sharding
    from ..virt.virtual_circuit import VirtualCircuit
    from .sweep import (
        make_differentiable_sweep,
        make_sampled_sweep,
        pauli_z_diagonal,
    )

    terms = _validate(terms, ansatz.num_qubits)
    if num_samples is not None:
        if contract is False:
            raise ValueError(
                "num_samples (stochastic VQE) uses the parity "
                "contraction; contract=False is not supported"
            )
        contract = True
    if contract is None:
        contract = ansatz.num_qubits > 12
    variant_sharding = None
    if mesh is not None:
        variant_sharding = _variant_sharding(mesh)
        if device is None:
            device = mesh.device
    dev = resolve_device(device)
    constant = sum(c for c, p in terms if set(p) == {"I"})
    groups = group_qubitwise(
        [(c, p) for c, p in terms if set(p) != {"I"}]
    )

    plan = None
    labels_mass = None  # one label sample shared by every group
    runners = []  # (runner_theta, coeffs [n] | [(coeff, diag)] per mode)
    n_params = 0
    instances = 0
    sharded = False
    for basis, members in groups:
        circ = measurement_circuit(ansatz, basis)
        cutter = Cutter(circ, **cutter_kwargs)
        if plan is None:
            if not cutter.solve():
                raise RuntimeError("cut search found no feasible plan")
            plan = cutter.plan
        else:
            cutter.use_plan(plan)
        virt = VirtualCircuit(cutter.getResultCircs()[3])
        supports = [
            {q for q, ch in enumerate(pauli) if ch != "I"}
            for _, pauli in members
        ]
        coeffs = torch.tensor([c for c, _ in members], dtype=torch.float32,
                              device=dev)
        if num_samples is not None:
            from .qpd_sampling import sample_label_counts

            if labels_mass is None:
                # specs are plan-determined and basis rotations are 1q,
                # so one sample serves every measurement group
                uniq, counts = sample_label_counts(
                    virt, num_samples, sample_seed, method=sample_method
                )
                labels_mass = (
                    uniq, counts.astype(np.float64) / num_samples
                )
            runner, k = make_sampled_sweep(
                virt, labels_mass[0], labels_mass[1], z_sets=supports,
                variant_sharding=variant_sharding, device=dev,
            )
            runners.append((runner, coeffs))
            instances += len(labels_mass[0]) * len(virt.fragments)
        elif contract:
            runner, k = make_differentiable_sweep(
                virt, z_sets=supports, variant_sharding=variant_sharding,
                device=dev,
            )
            runners.append((runner, coeffs))
            instances += virt.total_instantiations()
        else:
            runner, k = make_differentiable_sweep(
                virt, variant_sharding=variant_sharding, device=dev
            )
            # written DATA clbits (vgate measure clbits live at >=
            # num_clbits and are contracted away by the knit)
            positions = sorted(
                c
                for name in virt.programs
                for c in virt.programs[name].clbit_sources
                if c < virt.num_clbits
            )
            diags = [
                (coeff, torch.as_tensor(pauli_z_diagonal(positions, supp),
                                        device=dev))
                for (coeff, _), supp in zip(members, supports)
            ]
            runners.append((runner, diags))
            instances += virt.total_instantiations()
        n_params = max(n_params, k)
        sharded = sharded or runner.sharded

    def energy(theta):
        e = torch.tensor(constant, dtype=torch.float32, device=dev)
        for runner, payload in runners:
            if contract:
                e = e + torch.dot(payload, runner(theta))
            else:
                values = runner(theta)
                for coeff, diag in payload:
                    e = e + coeff * torch.dot(values, diag)
        return e

    energy.sharded = sharded
    info = HamiltonianEnergyInfo(
        n_params=n_params, n_groups=len(groups), constant=float(constant),
        plan=plan, instances_per_step=instances,
    )
    return energy, info
