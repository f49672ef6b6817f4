"""hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch

PyTorch and CUDA port of the JAX package
``hardwareawareoptimalquantumcircuitcuttingandknitting_tpu`` for one
NVIDIA H100.  It imports ``torch`` and never ``jax``, and nothing of the
JAX package: the host layers it needs are its own copies.

Layers (the ``engine="pallas"`` exact path, the ``engine="streamed"``
scan without a kernel, the batched ``engine="xla"``, the
``engine="sampled"`` Monte-Carlo path and the ``engine="sharded"``
variant x amplitude co-sharding):
  circuit/   — typed circuit IR + gate library; routing onto a device
               coupling map (routing.py)
  models/    — supremacy, Sycamore, hardware-efficient-ansatz, QFT / AQFT,
               GHZ and QAOA (qaoa.py) generators
  cutter/    — optimal joint wire+gate cut search (pure-Python solver; the
               angle-aware gamma search) and the rewrite into fragments
  virt/      — QPD virtual-gate tables and fragment bookkeeping
  plans/     — stored cut plans (solve once, cut many)
  ops/       — the variant kernel (csrc/variant_kernel.cu, fragments of up
               to 20 qubits), the segmented blocked kernel
               (csrc/blocked_kernel.cu, 21..24 qubits) and the collapse
               kernel (csrc/collapse_kernel.cu, sampled labels with
               mid-circuit measure-and-collapse), each with its plain
               PyTorch version; the streamed label scan (with the
               kernels, or in plain PyTorch with ancestor banks, bf16
               states, truncation, checkpoints and shots); the batched
               engine; the QPD sampler (qpd_sampling.py); shot sampling
               (sampling.py); the uncut oracle; noise models and noisy
               execution through the batched and streamed engines
               (noise.py) and error mitigation (mitigation.py); the
               variational path in plain PyTorch with autograd: parameter
               sweeps (sweep.py), Pauli Hamiltonian energies and VQE
               (hamiltonian.py), population SPSA / NES (optim.py)
  parallel/  — process-group meshes over torch.distributed (mesh.py) and
               the sharded knit step and dp-split streamed scan
               (sharded.py); the amplitude-sharded statevector and the
               co-sharded fragment engine are ops/sharded_sv.py and
               ops/sharded_fragment.py
  utils/     — logging, fragment-result checkpoints (checkpoint.py)
  run.py, evaluate.py — the entry point and the fidelity harness
  convert.py — circuits, plans, noise models and label blocks across
               packages, tables onto devices

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; they raise when no card is present.  The names below
are importable from the package itself (each loads its module on first
use).
"""

import importlib

__version__ = "0.1.0"

_ENTRY_POINTS = {
    "run_virtual_circuit": "run",
    "simulate_circuit": "ops.statevector",
    "make_parameter_sweep": "ops.sweep",
    "make_differentiable_sweep": "ops.sweep",
    "make_sampled_sweep": "ops.sweep",
    "pauli_z_diagonal": "ops.sweep",
    "make_hamiltonian_energy": "ops.hamiltonian",
    "population_energy": "ops.optim",
    "spsa_minimize": "ops.optim",
    "nes_minimize": "ops.optim",
    "OptimResult": "ops.optim",
    "construct_qaoa_plus": "models.qaoa",
}
__all__ = sorted(_ENTRY_POINTS)


def __getattr__(name):
    if name in _ENTRY_POINTS:
        module = importlib.import_module(f"{__name__}.{_ENTRY_POINTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
