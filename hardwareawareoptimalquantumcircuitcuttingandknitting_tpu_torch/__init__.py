"""hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch

PyTorch and CUDA port of the JAX package
``hardwareawareoptimalquantumcircuitcuttingandknitting_tpu`` for one
NVIDIA H100.  It imports ``torch`` and never ``jax``, and nothing of the
JAX package: the host layers it needs are its own copies.

Layers (this slice: the ``engine="pallas"`` exact path):
  circuit/   — typed circuit IR + gate library
  models/    — supremacy and GHZ generators
  cutter/    — optimal joint wire+gate cut search (pure-Python solver) and
               the rewrite into fragments
  virt/      — QPD virtual-gate tables and fragment bookkeeping
  ops/       — the variant kernel (csrc/variant_kernel.cu) and its plain
               PyTorch version, the streamed label scan, the uncut oracle
  run.py, evaluate.py — the entry point and the fidelity harness
  convert.py — circuits across packages, tables onto devices

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; they raise when no card is present.
"""

__version__ = "0.1.0"
