"""hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch

PyTorch and CUDA port of the JAX package
``hardwareawareoptimalquantumcircuitcuttingandknitting_tpu`` for one
NVIDIA H100.  It imports ``torch`` and never ``jax``, and nothing of the
JAX package: the host layers it needs are its own copies.

Layers (this slice: the ``engine="pallas"`` exact path):
  circuit/   — typed circuit IR + gate library
  models/    — supremacy, Sycamore, hardware-efficient-ansatz and GHZ
               generators
  cutter/    — optimal joint wire+gate cut search (pure-Python solver) and
               the rewrite into fragments
  virt/      — QPD virtual-gate tables and fragment bookkeeping
  plans/     — stored cut plans (solve once, cut many)
  ops/       — the variant kernel (csrc/variant_kernel.cu, fragments of up
               to 20 qubits) and the segmented blocked kernel
               (csrc/blocked_kernel.cu, 21..24 qubits), each with its plain
               PyTorch version; the streamed label scan; the uncut oracle
  run.py, evaluate.py — the entry point and the fidelity harness
  convert.py — circuits across packages, tables onto devices

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; they raise when no card is present.
"""

__version__ = "0.1.0"
