"""Every public name of the JAX package has its counterpart in the port, and the
port imports nothing of JAX.

For each module ``cuvs_tpu/<path>.py`` the port has ``cuvs_tpu_torch/<path>.py``
(a Pallas module ``ops/<name>_pallas.py`` maps to ``ops/<name>.py``), and every
public top-level function, class and assignment of the reference's module is
defined there too, read from both sources by ``ast`` (nothing is imported).
Names that the port replaced on purpose are listed in ``EXEMPT`` with their
reason; none may be missing otherwise.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "cuvs_tpu", ROOT / "cuvs_tpu_torch"

# (reference module, name): the port's counterpart and why it differs
EXEMPT = {
    ("mg/snmg.py", "default_mesh"):
        "default_devices: the port's mg runs over a list of torch devices, not a jax Mesh",
}


def _defined(path: pathlib.Path) -> set:
    """Public names a module defines at top level (def, class, assignment)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _counterpart(rel: pathlib.Path) -> pathlib.Path:
    if rel.parts[0] == "ops" and rel.name.endswith("_pallas.py"):
        return PORT / "ops" / rel.name.replace("_pallas.py", ".py")
    return PORT / rel


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_the_reference_has_modules():
    assert len(REF_MODULES) > 50


@pytest.mark.parametrize("rel", REF_MODULES)
def test_module_has_its_port(rel):
    rel = pathlib.Path(rel)
    port = _counterpart(rel)
    assert port.exists(), f"cuvs_tpu/{rel} has no port ({port.relative_to(ROOT)})"
    exempt = {name for (mod, name) in EXEMPT if mod == str(rel)}
    missing = _defined(REF / rel) - _defined(port) - exempt
    assert not missing, f"cuvs_tpu/{rel}: {sorted(missing)} missing in {port.relative_to(ROOT)}"


def test_exemptions_are_still_needed():
    for (mod, name), reason in EXEMPT.items():
        assert name in _defined(REF / mod) and name not in _defined(_counterpart(
            pathlib.Path(mod))), f"{mod}:{name} is no longer exempt ({reason})"
        counterpart = reason.split(":")[0]
        assert counterpart in _defined(_counterpart(pathlib.Path(mod)))


PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_neither_jax_nor_the_jax_package(rel):
    """No import statement of the port (or of chip_smoke.py), at any depth,
    names jax, flax or the JAX package."""
    bad = []
    for node in ast.walk(ast.parse((ROOT / rel).read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "cuvs_tpu")]
    assert not bad, f"{rel} imports {bad}"
