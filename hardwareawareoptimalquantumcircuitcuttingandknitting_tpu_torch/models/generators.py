"""qcg-compatible generator facade (reference: benchmarks/qcg/generators.py;
copy of the JAX package's ``models/generators.py``)."""
from .adder import gen_adder
from .bv import gen_BV
from .dynamics import gen_dynamics
from .hwea import gen_hwea
from .qft import gen_qft, library_qft
from .qwalk import gen_qwalk
from .supremacy import gen_supremacy
from .sycamore import gen_sycamore
from .uccsd import gen_uccsd

__all__ = [
    "gen_supremacy",
    "gen_sycamore",
    "gen_hwea",
    "gen_uccsd",
    "gen_qft",
    "library_qft",
    "gen_qwalk",
    "gen_dynamics",
    "gen_BV",
    "gen_adder",
]
