"""The torch port imports no JAX and nothing of the JAX package, and no
networkx (the card's machine has none)."""
import ast
import pathlib
import subprocess
import sys

import pytest

import torch_threads  # noqa: F401 (torch's threads: a share of the cores)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = "hardwareawareoptimalquantumcircuitcuttingandknitting_tpu_torch"
JAX_PKG = "hardwareawareoptimalquantumcircuitcuttingandknitting_tpu"


def _port_modules():
    for path in sorted((ROOT / PORT).rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield path, ".".join(parts)


def test_importing_every_port_module_loads_no_jax():
    mods = [name for _, name in _port_modules()]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'jaxlib' "
        "or m.split('.')[0] == 'networkx' "
        f"or m == {JAX_PKG!r} or m.startswith({JAX_PKG + '.'!r}))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_variational_modules_are_checked():
    """The variational path's modules are among those the two checks
    above import and read."""
    names = {name for _, name in _port_modules()}
    for mod in ("ops.sweep", "ops.hamiltonian", "ops.optim",
                "models.qaoa"):
        assert f"{PORT}.{mod}" in names, mod


def test_front_end_modules_are_checked():
    """The cutter's front end (native solver, teleport execution,
    OpenQASM, the zoo and its graphs) is among the modules the checks
    here import and read."""
    names = {name for _, name in _port_modules()}
    for mod in ("cutter.native_solver", "virt.teleport", "circuit.qasm",
                "models.graphs", "models.zoo", "models.generators",
                "models.bv", "models.adder", "models.random_circuit",
                "models.su2", "models.dynamics", "models.qwalk",
                "models.uccsd"):
        assert f"{PORT}.{mod}" in names, mod


def test_last_modules_are_checked():
    """The last modules ported (the compiler on ``models/graphs.py``,
    the lightcone oracle, the sparse knit, the tracer, the roofline, the
    lane engine and the host tools) are among the modules the checks
    here import and read, the no-networkx check included."""
    names = {name for _, name in _port_modules()}
    for mod in ("compiler.types", "compiler.dag", "compiler.partition",
                "compiler.passes", "compiler.qubit_reuser",
                "compiler.compiler", "circuit.lightcone",
                "circuit.transpile", "virt.quasi_distr", "virt.sparse_knit",
                "utils.profiling", "utils.entanglement", "utils.config",
                "utils.artifacts", "ops.roofline", "ops.lane_engine"):
        assert f"{PORT}.{mod}" in names, mod


def test_port_has_a_twin_of_every_jax_module():
    """Every ``.py`` file of the JAX package has a twin at the same path
    in the port, but the Pallas files (ported as ``csrc/`` kernels) and
    the artefacts of JAX or the TPU that are not ported."""
    jax_files = {p.relative_to(ROOT / JAX_PKG)
                 for p in (ROOT / JAX_PKG).rglob("*.py")}
    port_files = {p.relative_to(ROOT / PORT)
                  for p in (ROOT / PORT).rglob("*.py")}
    not_ported = {pathlib.Path(p) for p in (
        "ops/pallas_variant.py", "ops/pallas_blocked.py", "ops/pallas_sv.py",
        "_compile_probe.py", "bench_impl.py", "utils/jaxcache.py")}
    assert sorted(map(str, jax_files - port_files - not_ported)) == []


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_name_no_jax_import():
    files = [p for p, _ in _port_modules()] + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offending = []
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", JAX_PKG):
                offending.append((str(path.relative_to(ROOT)), name))
    assert not offending, offending


def test_port_has_no_networkx_dependency():
    """The card's machine has no networkx: neither the port (its zoo
    draws the QAOA graphs in ``models/graphs.py``) nor the smoke script
    may import it, nor name it to ``importlib``."""
    files = [p for p, _ in _port_modules()] + [ROOT / "chip_smoke.py"]
    offending = [
        str(p.relative_to(ROOT)) for p in files
        if any(n.split(".")[0] == "networkx" for n in _imported_names(p))
        or "import_module(\"networkx" in p.read_text()
        or "import_module('networkx" in p.read_text()
    ]
    assert not offending, offending


def test_stored_plans_load_without_jax():
    """The package's stored cut plans (JSON beside ``plans/__init__.py``)
    load through the port's own loader, in a process that never imports
    JAX or the JAX package."""
    code = (
        "import sys\n"
        f"from {PORT}.plans import load_plan, stored_plans\n"
        "names = stored_plans()\n"
        "assert 'hwe40_d2_p2_q21' in names, names\n"
        "assert 'qft16_prepped_p2_q15_gamma' in names, names\n"
        "for n in names:\n"
        "    plan = load_plan(n)\n"
        "    assert plan.num_partitions >= 2 and plan.cuts, n\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') "
        f"or m == {JAX_PKG!r} or m.startswith({JAX_PKG + '.'!r}))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# The kernel layer, each module with its level: the wrappers of kernels
# 1-2, 3 and 5 over kernel 4's (the shared prefix) over the host tables
# and the launch side.  A module imports only modules of a lower level.
KERNEL_LAYER = {"variant_kernel": 2, "collapse_kernel": 2, "sv_kernel": 2,
                "blocked_kernel": 1, "op_rewrite": 0, "kernel_build": 0}


def _ops_imports(path):
    """``(module, in_function)`` for every import in ``path`` of a module
    of the port's ``ops`` package, by its name there."""
    out = []

    def visit(node, in_fn):
        for child in ast.iter_child_nodes(node):
            names = []
            if isinstance(child, ast.ImportFrom):
                mod = child.module or ""
                if child.level == 1:
                    names = ([mod.split(".")[0]] if mod
                             else [a.name for a in child.names])
                elif mod == f"{PORT}.ops":
                    names = [a.name for a in child.names]
                elif mod.startswith(f"{PORT}.ops."):
                    names = [mod.split(".")[2]]
            elif isinstance(child, ast.Import):
                names = [a.name.split(".")[2] for a in child.names
                         if a.name.startswith(f"{PORT}.ops.")]
            out.extend((name, in_fn) for name in names)
            visit(child, in_fn or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)))

    visit(ast.parse(path.read_text()), False)
    return out


@pytest.mark.parametrize("module", sorted(KERNEL_LAYER))
def test_kernel_layer_imports_point_one_way(module):
    """The kernel layer's arrows point one way: {variant, collapse, sv}
    -> blocked_kernel (the shared prefix) -> {op_rewrite, kernel_build}.
    No module of the layer imports one of its own level or above, and
    none imports another inside a function (a lazy import that hides a
    cycle)."""
    found = _ops_imports(ROOT / PORT / "ops" / f"{module}.py")
    layer = [(name, in_fn) for name, in_fn in found if name in KERNEL_LAYER]
    assert layer or KERNEL_LAYER[module] == 0   # the parse sees imports
    for name, in_fn in layer:
        assert KERNEL_LAYER[name] < KERNEL_LAYER[module], \
            f"{module} imports {name}"
        assert not in_fn, f"{module} imports {name} inside a function"


def test_kernel_libraries_build_nothing_at_import():
    """Every CUDA source the port binds, and the native cut solver's C++
    source, exist in the checkout, and importing the modules starts no
    compiler and loads no library."""
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started at import')\n"
        "subprocess.Popen = subprocess.run = refuse\n"
        f"from {PORT}.ops import blocked_kernel, collapse_kernel, "
        "sv_kernel, variant_kernel\n"
        "for mod in (blocked_kernel, collapse_kernel, sv_kernel, "
        "variant_kernel):\n"
        "    lib = mod.LIBRARY\n"
        "    assert lib.source.is_file(), lib.source\n"
        "    assert lib.lib is None and lib.path is None\n"
        f"from {PORT}.cutter import native_solver\n"
        "assert native_solver.SOURCE.is_file(), native_solver.SOURCE\n"
        "assert native_solver._lib is None\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_package_exports_the_entry_points():
    """Each name of the package's ``__all__`` resolves to its module's
    object, loaded on first use."""
    import importlib

    pkg = importlib.import_module(PORT)
    for name in pkg.__all__:
        module = importlib.import_module(
            f"{PORT}.{pkg._ENTRY_POINTS[name]}")
        assert getattr(pkg, name) is getattr(module, name), name
    assert "make_hamiltonian_energy" in pkg.__all__
