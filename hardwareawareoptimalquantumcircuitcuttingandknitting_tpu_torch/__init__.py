"""hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch

PyTorch and CUDA port of the JAX package
``hardwareawareoptimalquantumcircuitcuttingandknitting_tpu`` for one
NVIDIA H100.  It imports ``torch`` and never ``jax``, and nothing of the
JAX package: the host layers it needs are its own copies.

Layers (the ``engine="pallas"`` exact path, the ``engine="streamed"``
scan without a kernel, the batched ``engine="xla"`` and the
``engine="sampled"`` Monte-Carlo path):
  circuit/   — typed circuit IR + gate library; routing onto a device
               coupling map (routing.py)
  models/    — supremacy, Sycamore, hardware-efficient-ansatz, QFT / AQFT
               and GHZ generators
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
               (noise.py) and error mitigation (mitigation.py)
  utils/     — logging, fragment-result checkpoints (checkpoint.py)
  run.py, evaluate.py — the entry point and the fidelity harness
  convert.py — circuits, plans, noise models and label blocks across
               packages, tables onto devices

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; they raise when no card is present.
"""

__version__ = "0.1.0"
