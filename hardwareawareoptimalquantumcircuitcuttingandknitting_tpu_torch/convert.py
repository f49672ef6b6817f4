"""Carrying state into the torch package, and device placement.

The JAX package's "weights" are circuits and the host tables built from
them.  A circuit crosses between the two packages as plain Python and
numpy data (:func:`circuit_to_instructions` reads any object with the
``Circuit`` attributes, :func:`circuit_from_instructions` rebuilds this
package's ``Circuit``), so both packages can start from one object
without either importing the other.  A cut plan crosses as its JSON text
(:func:`plan_from_other`; the same text ``Cutter.save_plan`` writes and
``plans.load_plan`` reads), and a sampled label block with its collapse
draws as numpy arrays (:func:`sampled_block_to_device`), unchanged.  A
fragment's variant rows cross as numpy (:func:`fragment_result_from_other`
into this package, :func:`fragment_result_to_numpy` out of it), so either
package's rows can feed either package's knit.  A noise model crosses
field by field (:func:`noise_model_from_other`: numbers, numpy arrays and
the coupling list), so both packages compute with one model.  Host
tables become device tensors through :func:`to_device`.
"""
from __future__ import annotations

import numpy as np
import torch

from .circuit.circuit import Circuit, Instruction, ParamRef, Register
from .cutter.plan import CutPlan
from .virt.virtual_gates import VirtualGateOp, WireCutMark


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.
    Raises when CUDA is asked for (or implied) and absent — nothing falls
    back to the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU"
        )
    return dev


def to_device(tables, device, dtype=None):
    """Numpy table(s) -> tensor(s) on ``device``: a single array, or a
    list/tuple of arrays (returned as a list).  ``dtype`` overrides the
    array's own type (e.g. ``torch.float32``)."""
    if isinstance(tables, (list, tuple)):
        return [to_device(t, device, dtype) for t in tables]
    return torch.as_tensor(np.ascontiguousarray(tables), dtype=dtype,
                           device=device)


def _param_to_data(p):
    """A gate parameter as plain data: a float, or for a ``ParamRef`` (of
    either package) the dict of its ``index``, ``base``, ``scale`` and
    ``shift``, so the theta reference survives the crossing."""
    if type(p).__name__ == "ParamRef":
        return {"index": int(p.index), "base": float(p.base),
                "scale": float(p.scale), "shift": float(p.shift)}
    return float(p)


def _param_from_data(d):
    if isinstance(d, dict):
        return ParamRef(d["index"], d["base"], d["scale"], d["shift"])
    return float(d)


def _op_to_data(op):
    if op is None:
        return None
    if type(op).__name__ == "VirtualGateOp":
        return {"kind": "vgate", "base_name": op.base_name,
                "params": [_param_to_data(p) for p in op.params],
                "label": op.label, "teleport": bool(op.teleport)}
    if type(op).__name__ == "WireCutMark":
        return {"kind": "wirecut", "label": op.label,
                "teleport": bool(op.teleport)}
    if isinstance(op, np.ndarray):
        return {"kind": "array", "value": np.array(op)}
    raise TypeError(f"cannot carry instruction payload {type(op).__name__}")


def _op_from_data(data):
    if data is None:
        return None
    kind = data["kind"]
    if kind == "vgate":
        return VirtualGateOp(data["base_name"],
                             tuple(_param_from_data(p)
                                   for p in data["params"]),
                             data["label"], data["teleport"])
    if kind == "wirecut":
        return WireCutMark(data["label"], data["teleport"])
    if kind == "array":
        return np.array(data["value"])
    raise ValueError(f"unknown instruction payload kind {kind!r}")


def circuit_to_instructions(circ) -> tuple[int, int, dict, list[dict]]:
    """``(num_qubits, num_clbits, regs, instrs)`` of a circuit object with
    the ``Circuit`` attributes (this package's or the JAX package's): the
    plain form :func:`circuit_from_instructions` takes.  A parameter is a
    float, or a ``ParamRef``'s ``{"index", "base", "scale", "shift"}``
    dict (gates and cut gates alike)."""
    regs = {
        "name": circ.name,
        "qregs": [(r.name, r.size) for r in circ.qregs],
        "cregs": [(r.name, r.size) for r in circ.cregs],
    }
    instrs = [
        {
            "name": ins.name,
            "qubits": [int(q) for q in ins.qubits],
            "clbits": [int(c) for c in ins.clbits],
            "params": [_param_to_data(p) for p in ins.params],
            "label": ins.label,
            "condition": (None if ins.condition is None
                          else tuple(int(v) for v in ins.condition)),
            "op": _op_to_data(ins.op),
        }
        for ins in circ.instructions
    ]
    return circ.num_qubits, circ.num_clbits, regs, instrs


def circuit_from_instructions(num_qubits: int, num_clbits: int, regs: dict,
                              instrs: list[dict]) -> Circuit:
    """Rebuild this package's :class:`Circuit` from plain data: ``regs``
    holds ``qregs``/``cregs`` as ``(name, size)`` pairs (and optionally the
    circuit ``name``); each instruction is a dict with ``name``,
    ``qubits``, ``clbits``, ``params`` (floats, or ParamRef dicts rebuilt
    as this package's ``ParamRef``), ``label``, ``condition`` and
    ``op`` (None, a ``vgate``/``wirecut`` payload dict, or an ``array``
    holding a unitary)."""
    circ = Circuit(
        [Register(n, s) for n, s in regs["qregs"]],
        [Register(n, s) for n, s in regs["cregs"]],
        regs.get("name", "circuit"),
    )
    if circ.num_qubits != num_qubits or circ.num_clbits != num_clbits:
        raise ValueError(
            f"registers hold {circ.num_qubits} qubits / {circ.num_clbits} "
            f"clbits, expected {num_qubits} / {num_clbits}"
        )
    for d in instrs:
        cond = d.get("condition")
        circ.append(Instruction(
            d["name"], list(d["qubits"]), list(d.get("clbits", ())),
            [_param_from_data(p) for p in d.get("params", ())],
            d.get("label"),
            _op_from_data(d.get("op")),
            None if cond is None else tuple(cond),
        ))
    return circ


def plan_from_other(plan) -> CutPlan:
    """This package's :class:`CutPlan` from any plan object with a
    ``to_json()`` (this package's or the JAX package's): assignment, cuts
    and metrics cross as JSON text, gamma-mode plans (float ``S``)
    included."""
    return CutPlan.from_json(plan.to_json())


def sampled_block_to_device(labels, draws, device):
    """A sampled label block and its collapse draws, made with numpy, as
    the tensors the row functions take: ``labels [L, G]`` -> int64,
    ``draws [L, n_sites]`` -> float32, values unchanged."""
    return (to_device(np.asarray(labels), device, torch.int64),
            to_device(np.asarray(draws, np.float32), device))


def fragment_result_from_other(res, device=None):
    """This package's ``FragmentResult`` (``values`` a float32 tensor on
    ``device``, None = "cuda") from any object with ``name``, ``values``
    (array-like ``[num_variants, 2^k]``), ``bit_positions`` and
    ``touching``: the JAX package's result, or one from
    :func:`fragment_result_to_numpy`."""
    from .ops.variant_engine import FragmentResult

    return FragmentResult(
        res.name,
        # a copy: the result owns its rows, whatever the source array was
        to_device(np.array(res.values, np.float32),
                  resolve_device(device)),
        list(res.bit_positions), list(res.touching),
    )


def fragment_result_to_numpy(res):
    """A ``FragmentResult`` of this package with its ``values`` fetched to
    a numpy array: the form the JAX package's knit takes."""
    from .ops.variant_engine import FragmentResult

    return FragmentResult(
        res.name, res.values.detach().cpu().numpy(),
        list(res.bit_positions), list(res.touching),
    )


def noise_model_from_other(nm):
    """This package's ``ops.noise.NoiseModel`` with every field of ``nm``
    (this package's or the JAX package's model: scalars, per-qubit numpy
    vectors copied, the coupling list as tuples)."""
    import dataclasses

    from .ops.noise import NoiseModel

    kw = {}
    for f in dataclasses.fields(NoiseModel):
        v = getattr(nm, f.name)
        if isinstance(v, np.ndarray):
            v = np.array(v)
        elif f.name == "coupling" and v is not None:
            v = [tuple(int(q) for q in e) for e in v]
        kw[f.name] = v
    return NoiseModel(**kw)
