"""Checkpoint / resume of the batched engine's fragment results.

Port of the JAX package's ``utils/checkpoint.py``.  The reference
serialises nothing (SURVEY §5).  Here the cut plan (cutter/plan.py, JSON)
and the per-fragment variant rows (this module, one ``.npz`` a fragment
and a manifest) are on-disk formats, so the knit, projection and
fidelity can be rerun or resumed without re-simulating.  Rows are
fetched to numpy on save; a load returns numpy rows.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from ..ops.variant_engine import FragmentResult

_MANIFEST = "fragment_results.json"


def checkpoint_fingerprint(virt, dtype=None) -> str:
    """Identity of a virtual circuit's results: fragment names, variant
    layout (touching order), clbit layout and the gate content (op kinds,
    axes and matrices as complex128), plus the vgates' tables and
    endpoint circuits.  The same digest as the JAX package's for the
    same circuit.

    ``dtype``: the states' storage dtype; a non-float32 one (bf16
    serving) joins the identity under its numpy name, so an exact f32
    run never resumes bf16 results."""
    import hashlib

    h = hashlib.sha256()
    if dtype is not None and dtype != torch.float32:
        name = str(dtype).removeprefix("torch.")
        h.update(f"dtype={name}|".encode())
    h.update(str(virt.num_clbits).encode())
    for reg in virt.fragments:
        prog = virt.programs[reg.name]
        h.update(
            f"{reg.name}|{prog.num_sim_qubits}|{list(prog.touching)}|"
            f"{sorted(prog.clbit_sources.items())}|"
            f"{virt.num_instantiations(reg.name)}".encode()
        )
        for op in prog.ops:
            if op[0] in ("u", "u_aux"):
                h.update(f"{op[0]}|{op[2]}".encode())
                h.update(np.ascontiguousarray(
                    np.asarray(op[1], dtype=complex)
                ).tobytes())
            else:
                h.update(f"{op[0]}|{op[1]}|{op[2]}".encode())
    for vg in virt.vgates:
        spec = vg.spec
        coef = np.ascontiguousarray(np.asarray(spec.coef, dtype=np.float64))
        # gate name + endpoint variant circuits, not just coef: cx/cy/cz
        # share an identical coef table but give different results
        h.update(f"{spec.gate_name}|{list(spec.owner_side)}".encode())
        h.update(str(coef.shape).encode())
        h.update(coef.tobytes())
        for pair in spec.endpoints:
            for ev in pair:
                h.update(b"m" if ev.measure else b".")
                for mat in (ev.pre, ev.post):
                    h.update(np.ascontiguousarray(
                        np.asarray(mat, dtype=complex)
                    ).tobytes())
    return h.hexdigest()


def save_fragment_results(
    results: list[FragmentResult],
    directory: str | pathlib.Path,
    fingerprint: str | None = None,
) -> pathlib.Path:
    """Write one .npz per fragment plus a manifest; returns the dir."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    entries = []
    for res in results:
        fname = f"frag_{res.name}.npz"
        np.savez_compressed(
            directory / fname,
            values=torch.as_tensor(res.values).cpu().numpy(),
            bit_positions=np.asarray(res.bit_positions, dtype=np.int64),
            touching=np.asarray(res.touching, dtype=np.int64),
        )
        entries.append({"name": res.name, "file": fname})
    manifest = {"fingerprint": fingerprint, "fragments": entries}
    # atomic publish: a kill mid-write must not leave a truncated manifest
    tmp = directory / (_MANIFEST + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=2))
    tmp.replace(directory / _MANIFEST)
    return directory


def load_fragment_results(
    directory: str | pathlib.Path,
    expect_fingerprint: str | None = None,
) -> list[FragmentResult] | None:
    """Load a checkpoint (numpy rows).  With ``expect_fingerprint``,
    returns None when the stored fingerprint is absent or different (a
    stale checkpoint); a corrupt one also gives None (re-simulate)."""
    directory = pathlib.Path(directory)
    try:
        manifest = json.loads((directory / _MANIFEST).read_text())
    except (OSError, json.JSONDecodeError):
        return None
    if isinstance(manifest, list):  # pre-fingerprint layout
        manifest = {"fingerprint": None, "fragments": manifest}
    if (
        expect_fingerprint is not None
        and manifest.get("fingerprint") != expect_fingerprint
    ):
        return None
    out = []
    for entry in manifest["fragments"]:
        try:
            data = np.load(directory / entry["file"])
        except (OSError, ValueError):
            return None
        out.append(
            FragmentResult(
                entry["name"],
                data["values"],
                [int(x) for x in data["bit_positions"]],
                [int(x) for x in data["touching"]],
            )
        )
    return out


def has_checkpoint(directory: str | pathlib.Path) -> bool:
    return (pathlib.Path(directory) / _MANIFEST).exists()
