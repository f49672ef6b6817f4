"""The torch port imports no JAX and nothing of the JAX package."""
import ast
import pathlib
import subprocess
import sys

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
    """The card's machine has no networkx: the port's zoo must not need
    it."""
    offending = [
        str(p.relative_to(ROOT)) for p, _ in _port_modules()
        if any(n.split(".")[0] == "networkx" for n in _imported_names(p))
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


def test_kernel_libraries_build_nothing_at_import():
    """Every CUDA source the port binds exists in the checkout, and
    importing the modules starts no compiler and loads no library."""
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
