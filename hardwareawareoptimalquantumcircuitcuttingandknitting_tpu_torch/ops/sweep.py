"""Parameter-sweep serving: one cut plan, many bindings, and gradients.

Port of the JAX package's ``ops/sweep.py``.  VQE/QAOA-style workloads
re-run the same circuit *structure* with new gate parameters.  Here the
whole cut-simulate-knit pipeline takes its gate blocks, QPD slot
matrices AND knit coefficients as runtime tensors; ``bind`` converts any
same-structure cut circuit into those arguments, and the runner built
once serves every binding (the JAX package compiles it once; here the
template -- skeletons, clbit sources, label counts -- is built once and
``bind`` never rebuilds it).

The JAX package ``vmap``s one fragment simulation over the variants; here
one batched state ``[V, 2, 2^n]`` goes through the skeleton (runtime
blocks applied by :func:`~.statevector.apply_block_einsum`: a gate block
is one ``[2, m, 2, m]`` tensor shared by every variant, a slot block one
per variant).  No kernel lies on this path in either package: the JAX
sweep is XLA under ``vmap``/``grad``, this one plain PyTorch under
``torch.autograd``.

``variant_sharding`` (``parallel.mesh.variant_sharding(mesh)``): each
``dp`` rank simulates its contiguous slice of a fragment's variant (or
sampled label) rows and the rows are gathered before the knit, which
every rank runs; the backward pass hands each rank its slice of the
rows' gradient and sums the gate blocks' gradients over ``dp``
(:func:`..parallel.mesh.gather_rows`, :func:`..parallel.mesh.sum_grads`),
so every rank holds the unsharded gradient.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..circuit.circuit import ParamRef
from ..convert import resolve_device, to_device
from ..virt.virtual_circuit import VirtualCircuit
from .fusion import fused_stream
from .knit import expectation_z_multi, fold_weights, knit_values
from .statevector import apply_block_einsum, marginalize_flat, to_real_block
from .variant_engine import (
    FragmentResult,
    _slot_matrices,
    _slot_tables,
    label_strides,
)


def _fused_stream(prog):
    """Shared fused op stream (ops/fusion.fused_stream) with the matrices
    converted to real blocks.  max_qubits=3 like the single-chip exact
    engine (variant_engine.make_sim_fn): every merged block saves a pass
    over the state in the steady serving loop."""
    skeleton, mats = fused_stream(prog.ops, max_qubits=3)
    return skeleton, [to_real_block(m) for m in mats]


def _sweep_device(device, variant_sharding):
    """``device``, else the sharding mesh's device, else the card."""
    if device is None and variant_sharding is not None:
        return variant_sharding.mesh.device
    return resolve_device(device)


def _dp_mesh(variant_sharding):
    """The mesh whose live ``dp`` axis splits the rows, or None (no
    sharding, or a ``dp`` axis of one rank: nothing to split)."""
    if variant_sharding is None:
        return None
    mesh = variant_sharding.mesh
    return mesh if mesh._live("dp") and mesh.shape["dp"] > 1 else None


def _simulate_rows(skeleton, blocks, mats, n: int, sources, batch: int,
                   device) -> torch.Tensor:
    """``[batch, 2^k]`` marginal rows of one fragment from |0...0>:
    ``blocks[i]`` is the ``i``-th fixed ("u") entry's shared ``[2, m, 2,
    m]`` block, ``mats[sid]`` the slot's per-row ``(pre, meas4, post)``
    ``[batch, 2, m, 2, m]`` blocks (the JAX ``sim_one`` under ``vmap``)."""
    state = torch.zeros((batch, 2, 1 << n), dtype=torch.float32,
                        device=device)
    state[:, 0, 0] = 1.0
    bi = 0
    for op in skeleton:
        if op[0] == "u":
            state = apply_block_einsum(state, blocks[bi], op[1], n)
            bi += 1
        else:
            kind, sid, axes = op
            pre, m4, post = mats[sid]
            mat = {"slot_pre": pre, "slot_meas": m4,
                   "slot_post": post}[kind]
            state = apply_block_einsum(state, mat, axes, n)
    return marginalize_flat((state * state).sum(dim=1), n, sources)


def _fragment_rows(skeleton, blocks, mats, n, sources, count, device,
                   mesh):
    """The ``[count, 2^k]`` rows of one fragment: every row simulated
    here, or (``mesh``) this ``dp`` rank's slice, gathered."""
    if not mats:
        row = _simulate_rows(skeleton, blocks, mats, n, sources, 1, device)
        return row.expand(count, row.shape[1])
    if mesh is None:
        return _simulate_rows(skeleton, blocks, mats, n, sources, count,
                              device)
    from ..parallel.mesh import dp_slice, gather_rows, sum_grads

    lo, hi = dp_slice(count, mesh)
    local = [tuple(t[lo:hi] for t in tabs) for tabs in mats]
    local_rows = _simulate_rows(skeleton, sum_grads(blocks, mesh), local, n,
                                sources, hi - lo, device)
    return gather_rows(local_rows, mesh, count)


def make_parameter_sweep(virt: VirtualCircuit, keep_clbits=None,
                         z_sets=None, variant_sharding=None, device=None):
    """Build (runner, bind) for the cut plan embodied by ``virt``.

    ``bind(other_virt)`` -> argument tuple (tensors on ``device``) for any
    VirtualCircuit with the same structure (same cut plan applied to a
    re-parameterised circuit; structural mismatch raises).
    ``runner(args)`` -> flat knitted quasi-distribution values.  One
    runner serves every binding: ``bind`` only fills tensors.

    ``z_sets`` (list of clbit sets): observable mode — the runner returns
    the ``[len(z_sets)]`` vector of <prod Z> expectations via the
    per-fragment parity contraction (ops/knit.expectation_z_multi)
    instead of knitting a distribution, so nothing of size
    2^num_clbits ever materialises (the wide-circuit serving shape).

    ``variant_sharding`` (``parallel.mesh.variant_sharding(mesh)``): each
    ``dp`` rank simulates its slice of every fragment's variant rows; the
    rows are gathered before the knit (see the module docstring).
    ``device``: where the tensors live (None: the mesh's device with a
    sharding, else the card; raises without one)."""
    dev = _sweep_device(device, variant_sharding)
    mesh = _dp_mesh(variant_sharding)
    frag_names = [r.name for r in virt.fragments]
    template = {}
    for name in frag_names:
        prog = virt.programs[name]
        skeleton, _blocks = _fused_stream(prog)
        positions = sorted(prog.clbit_sources)
        sources = [prog.clbit_sources[c] for c in positions]
        specs = [vg.spec for vg in virt.vgates]
        _, _, flat_count = label_strides(specs, prog.touching)
        template[name] = (
            skeleton, positions, sources, prog.num_sim_qubits, flat_count,
        )

    def runner(args):
        slot_mats, gate_blocks, weights = args
        results = []
        for fi, name in enumerate(frag_names):
            skeleton, positions, sources, n, flat_count = template[name]
            values = _fragment_rows(skeleton, gate_blocks[fi], slot_mats[fi],
                                    n, sources, flat_count, dev, mesh)
            results.append(FragmentResult(
                name, values, positions,
                list(virt.programs[name].touching),
            ))
        if z_sets is not None:
            return expectation_z_multi(virt, results, z_sets, weights)
        values, _pos = knit_values(
            virt, results, keep_clbits, weights=weights
        )
        return values

    runner.template = template  # skeletons, for the differentiable binder
    runner.device = dev

    def bind(other: VirtualCircuit):
        if [r.name for r in other.fragments] != frag_names:
            raise ValueError("fragment structure mismatch")
        slot_mats, gate_blocks, weights = [], [], []
        for name in frag_names:
            prog = other.programs[name]
            skeleton, positions, _srcs, n, flat_count = template[name]
            skel2, blocks2 = _fused_stream(prog)
            if skel2 != skeleton:
                raise ValueError(
                    f"fragment {name}: op structure differs from template"
                )
            specs = [vg.spec for vg in other.vgates]
            strides, n_inst, acc = label_strides(specs, prog.touching)
            slot_mats.append([
                tuple(to_device(t, dev, torch.float32) for t in tabs)
                for tabs in _slot_matrices(prog, specs, acc, strides, n_inst)
            ])
            gate_blocks.append(to_device(blocks2, dev, torch.float32))
            weights.append(to_device(fold_weights(other, name), dev,
                                     torch.float32))
        return (slot_mats, gate_blocks, weights)

    return runner, bind


# ---------------------------------------------------------------------------
# Differentiable sweep: torch.autograd through the cut-sim-knit pipeline
# ---------------------------------------------------------------------------
#
# Gates built with circuit.ParamRef parameters keep a reference to a
# position in an external theta vector.  make_differentiable_sweep
# rebuilds exactly those matrices from theta on every call (re-running
# the gate fuser on torch tensors — the fusion structure depends only on
# op axes, so the skeleton matches the template) and reuses
# make_parameter_sweep's runner: gradients of any function of the
# knitted distribution w.r.t. the circuit parameters, with the cut plan,
# QPD slot tables and knit weights as constants.


def _fsim_basis():
    e00 = np.zeros((4, 4), np.complex64); e00[0, 0] = 1
    mid_c = np.zeros((4, 4), np.complex64); mid_c[1, 1] = mid_c[2, 2] = 1
    mid_s = np.zeros((4, 4), np.complex64); mid_s[1, 2] = mid_s[2, 1] = 1
    e33 = np.zeros((4, 4), np.complex64); e33[3, 3] = 1
    return e00, mid_c, mid_s, e33


def _mat_theta(name: str, ps):
    """Differentiable complex64 matrix for a parameterised gate from its
    parameters ``ps`` (0-d float32 tensors on one device), matching
    circuit/gates.py's conventions (first listed qubit = gate-local
    MSB).  Gates: rx, ry, rz, p/u1, u/u2/u3, rzz, cp/cu1, crz, fsim."""
    from ..circuit import gates as G

    c64 = torch.complex64
    dev = ps[0].device

    def const(m):
        return torch.as_tensor(np.array(m), dtype=c64, device=dev)

    def e(x):
        return torch.complex(torch.cos(x), torch.sin(x))

    def diag(entries):
        return torch.diag(torch.stack([v.to(c64) for v in entries]))

    one = torch.ones((), dtype=c64, device=dev)
    if name in ("rx", "ry"):
        half = ps[0] * 0.5
        c = torch.cos(half).to(c64)
        s = torch.sin(half).to(c64)
        pauli = G.X if name == "rx" else G.Y
        return c * const(G.I2) - 1j * s * const(pauli)
    if name == "rz":
        half = ps[0] * 0.5
        return diag([e(-half), e(half)])
    if name in ("p", "u1"):
        return diag([one, e(ps[0])])
    if name in ("u3", "u", "u2"):
        if name == "u2":
            th = torch.tensor(math.pi / 2, dtype=torch.float32, device=dev)
            ph, lam = ps[0], ps[1]
        else:
            th, ph, lam = ps
        c = torch.cos(th * 0.5).to(c64)
        s = torch.sin(th * 0.5).to(c64)
        row0 = torch.stack([c, -e(lam) * s])
        row1 = torch.stack([e(ph) * s, e(ph) * e(lam) * c])
        return torch.stack([row0, row1])
    if name == "rzz":
        half = ps[0] * 0.5
        return diag([e(-half), e(half), e(half), e(-half)])
    if name in ("cp", "cu1"):
        return diag([one, one, one, e(ps[0])])
    if name == "crz":
        half = ps[0] * 0.5
        return diag([one, one, e(-half), e(half)])
    if name == "fsim":
        th, ph = ps
        c = torch.cos(th).to(c64)
        s = torch.sin(th).to(c64)
        e00, mid_c, mid_s, e33 = (const(m) for m in _fsim_basis())
        return e00 + c * mid_c - 1j * s * mid_s + e(-ph) * e33
    raise NotImplementedError(
        f"no differentiable matrix for parameterised gate {name!r}"
    )


def _real_block_traceable(u):
    """Differentiable twin of ops.statevector.to_real_block: complex
    ``[m, m]`` -> real ``[2, m, 2, m]``."""
    ur = torch.real(u).to(torch.float32)
    ui = torch.imag(u).to(torch.float32)
    return torch.stack(
        [torch.stack([ur, -ui], dim=1), torch.stack([ui, ur], dim=1)], dim=0
    )


def _check_no_param_cut_gates(virt: VirtualCircuit):
    for g, vg in enumerate(virt.vgates):
        if any(isinstance(p, ParamRef) for p in vg.params):
            raise NotImplementedError(
                f"cut gate {g} ({vg.base_name}) carries a ParamRef: its "
                "QPD slot tables and knit coefficients would depend on "
                "theta; keep ParamRefs off cut gates"
            )


def _count_params(virt: VirtualCircuit, frag_names) -> int:
    n_params = 0
    for name in frag_names:
        prog = virt.programs[name]
        for ins in prog.op_instrs.values():
            for p in ins.params:
                if isinstance(p, ParamRef):
                    n_params = max(n_params, p.index + 1)
    return n_params


def _device_ops(prog, device):
    """``prog.ops`` with every fixed gate's matrix a complex64 tensor on
    ``device`` (made once per sweep, not once per call)."""
    return [
        (op[0], torch.as_tensor(np.array(op[1]), dtype=torch.complex64,
                                device=device), op[2])
        if op[0] in ("u", "u_aux") else op
        for op in prog.ops
    ]


def _theta_gate_blocks(prog, theta, template_skel, frag_name, ops=None):
    """Differentiable fused gate blocks for one fragment: every op
    carrying a ParamRef is rebuilt from ``theta`` (via
    :func:`_mat_theta`), the fuser re-runs on torch tensors, and the
    skeleton is checked against the template (fusion structure depends
    only on op axes, so divergence means a bug, not data).  ``ops``:
    :func:`_device_ops` of ``prog`` on theta's device (made here when
    absent)."""
    if ops is None:
        ops = _device_ops(prog, theta.device)
    ops_theta = []
    for i, op in enumerate(ops):
        if op[0] in ("u", "u_aux"):
            ins = prog.op_instrs.get(i)
            if ins is not None and any(
                isinstance(p, ParamRef) for p in ins.params
            ):
                ps = [
                    theta[p.index] * p.scale + p.shift
                    if isinstance(p, ParamRef)
                    else torch.tensor(float(p), dtype=torch.float32,
                                      device=theta.device)
                    for p in ins.params
                ]
                ops_theta.append((op[0], _mat_theta(ins.name, ps), op[2]))
                continue
        ops_theta.append(op)
    skel, mats = fused_stream(ops_theta, max_qubits=3, xp=torch)
    if skel != template_skel:  # defensive: axes-only
        raise RuntimeError(
            f"fragment {frag_name}: traced fusion skeleton diverged"
        )
    return [_real_block_traceable(m) for m in mats]


def _as_theta(theta, device) -> torch.Tensor:
    """``theta`` as a float32 tensor on ``device`` (a tensor passed in
    keeps its autograd graph)."""
    if isinstance(theta, torch.Tensor):
        return theta.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(theta, np.float32), device=device)


def make_differentiable_sweep(virt: VirtualCircuit, keep_clbits=None,
                              z_sets=None, variant_sharding=None,
                              device=None):
    """Build ``runner_theta(theta) -> flat knitted values`` for a cut
    circuit whose gates carry :class:`~..circuit.circuit.ParamRef`
    parameters; ``torch.autograd`` differentiates it w.r.t. theta
    (shape ``[n_params]``).  Returns ``(runner_theta, n_params)``.

    ``z_sets``: observable mode — runner_theta returns the
    ``[len(z_sets)]`` vector of <prod Z> expectations via the fragment
    parity contraction; no 2^num_clbits array exists anywhere.

    The cut plan, QPD slot tables and knit weights are constants: only
    the parameterised gate matrices (and every fused block containing
    one) are rebuilt from theta.  Cut gates must not carry ParamRefs —
    cut cx/cz/cy around parameterised 1q/2q layers is the supported
    variational shape.
    """
    _check_no_param_cut_gates(virt)

    runner, bind = make_parameter_sweep(
        virt, keep_clbits, z_sets, variant_sharding, device
    )
    slot_mats_c, _gate_blocks_c, weights_c = bind(virt)
    frag_names = [r.name for r in virt.fragments]
    n_params = _count_params(virt, frag_names)
    ops = {name: _device_ops(virt.programs[name], runner.device)
           for name in frag_names}

    def runner_theta(theta):
        theta = _as_theta(theta, runner.device)
        gate_blocks = [
            _theta_gate_blocks(
                virt.programs[name], theta, runner.template[name][0], name,
                ops[name],
            )
            for name in frag_names
        ]
        return runner((slot_mats_c, gate_blocks, weights_c))

    runner_theta.sharded = _dp_mesh(variant_sharding) is not None
    return runner_theta, n_params


def make_sampled_sweep(virt: VirtualCircuit, labels, mass, z_sets=None,
                       variant_sharding=None, device=None):
    """Differentiable STOCHASTIC sweep: ``runner_theta(theta)`` evaluates
    the Monte-Carlo QPD estimator (ops/qpd_sampling) over a FIXED label
    sample instead of the full per-fragment variant grid — the
    variational twin of :func:`~.qpd_sampling.sampled_knit` /
    :func:`~.qpd_sampling.sampled_expectation_z`.

    ``labels [L, G]`` / ``mass [L]`` come from
    :func:`~.qpd_sampling.sample_label_counts` (``mass = counts / N``);
    with the FULL grid and exact mass the runner reproduces the exact
    sweep.  The labels are fixed across theta: common random numbers, so
    energy differences and gradients are unbiased with the sampling
    noise differenced out.

    Cost per fragment is ``L x 2^n_f`` instead of ``flat_count_f x
    2^n_f``.  ``z_sets`` -> [num_sets] expectations via the parity
    matmul; otherwise the flat knitted estimate over
    ``runner_theta.bit_positions``.  ``variant_sharding`` splits each
    fragment's per-label rows over ``dp`` as the exact sweep splits its
    variant rows."""
    from .bits import permute_bits_flat
    from .qpd_sampling import (
        _fold_rows_per_label,
        _sign_weights,
        _z_sign_matrix,
        sampling_overhead,
    )

    dev = _sweep_device(device, variant_sharding)
    mesh = _dp_mesh(variant_sharding)
    _check_no_param_cut_gates(virt)
    frag_names = [r.name for r in virt.fragments]
    n_params = _count_params(virt, frag_names)
    lab_np = np.asarray(labels, np.int32)
    n_labels = lab_np.shape[0]
    lab = to_device(lab_np, dev, torch.int64)
    gamma_total = sampling_overhead(virt)["gamma_total"]
    w = to_device(np.asarray(mass, np.float64) * gamma_total, dev,
                  torch.float32)
    if z_sets is not None:
        z_sets = [set(s) for s in z_sets]

    specs = [vg.spec for vg in virt.vgates]
    templates = {}
    slot_mats = {}
    signs = {}
    ops = {}
    for name in frag_names:
        prog = virt.programs[name]
        skeleton, _blocks = _fused_stream(prog)
        positions = sorted(prog.clbit_sources)
        sources = [prog.clbit_sources[c] for c in positions]
        templates[name] = (
            skeleton, positions, sources, prog.num_sim_qubits,
        )
        tables = _slot_tables(prog, specs, fused=False)
        slot_mats[name] = [
            tuple(to_device(t[lab_np[:, slot.vgate_idx]], dev, torch.float32)
                  for t in tabs)
            for slot, tabs in zip(prog.slots, tables)
        ]
        signs[name] = to_device(_sign_weights(virt, name), dev,
                                torch.float32)
        ops[name] = _device_ops(prog, dev)
    z_signs = {}

    def runner_theta(theta):
        theta = _as_theta(theta, dev)
        frag_rows = []
        frag_positions = []
        for name in frag_names:
            skeleton, positions, sources, nq = templates[name]
            blocks = _theta_gate_blocks(
                virt.programs[name], theta, skeleton, name, ops[name]
            )
            rows = _fragment_rows(skeleton, blocks, slot_mats[name], nq,
                                  sources, n_labels, dev, mesh)
            rows, pos = _fold_rows_per_label(
                virt, name, rows, lab, positions, signs[name]
            )
            frag_rows.append(rows)
            frag_positions.append(pos)
        if z_sets is not None:
            prodmat = None
            for name, rows, pos in zip(frag_names, frag_rows,
                                       frag_positions):
                if name not in z_signs:
                    z_signs[name] = _z_sign_matrix(pos, z_sets, dev)
                sc = rows @ z_signs[name]
                prodmat = sc if prodmat is None else prodmat * sc
            return w @ prodmat
        # distribution mode: weighted label-axis einsum, mirroring
        # ops/qpd_sampling._estimate's combine
        src_bits = []
        for pos in reversed(frag_positions):
            src_bits.extend(pos)
        dst_bits = sorted(src_bits)
        operands = [w, [0]]
        for i, rows in enumerate(frag_rows):
            operands += [rows, [0, 1 + i]]
        merged = torch.einsum(
            *operands, list(range(1, 1 + len(frag_rows)))
        ).reshape(-1)
        return permute_bits_flat(merged, src_bits, dst_bits)

    # static fold bookkeeping: the data clbits each fragment keeps
    runner_theta.bit_positions = sorted(
        p
        for name in frag_names
        for p in templates[name][1]
        if p < virt.num_clbits
    )
    runner_theta.sharded = mesh is not None
    return runner_theta, n_params


def pauli_z_diagonal(bit_positions, z_clbits) -> np.ndarray:
    """[2^m] vector of (-1)^(parity of the bits in ``z_clbits``) over the
    flat little-endian index (bit j carries ``bit_positions[j]``) — dot it
    with a runner's output values for <prod Z> expectation objectives."""
    m = len(bit_positions)
    idx = np.arange(1 << m)
    parity = np.zeros(1 << m, np.int64)
    for j, c in enumerate(bit_positions):
        if c in z_clbits:
            parity ^= (idx >> j) & 1
    return (1.0 - 2.0 * parity).astype(np.float32)
