"""Every public name of the JAX package has its counterpart in the port, and the
port imports nothing of JAX.

For each module ``cuvs_tpu/<path>.py`` the port has ``cuvs_tpu_torch/<path>.py``
(a Pallas module ``ops/<name>_pallas.py`` maps to ``ops/<name>.py``), and every
public top-level function, class and assignment of the reference's module is
defined there too, read from both sources by ``ast`` (nothing is imported).
Names that the port replaced on purpose are listed in ``EXEMPT`` with their
reason; none may be missing otherwise.

The same holds one level down: every parameter of each public function and
method (and each field of a public class body, such as a dataclass's) of the
reference has a parameter of that name in the port's counterpart. The port
may add parameters. Those it dropped or renamed on purpose are listed in
``PARAM_EXEMPT``, the reason starting with the parameters it covers.
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


# (reference module, function or Class.method): "<parameters>: why" for the
# reference's parameters the port does not take
_MG_DEVICES = "mesh: the port's mg runs over a list of torch devices, not a jax Mesh"
PARAM_EXEMPT = {
    ("mg/snmg.py", "build"): _MG_DEVICES + " (devices=)",
    ("mg/snmg.py", "build_streaming"): _MG_DEVICES + " (devices=)",
    ("mg/snmg.py", "search"): _MG_DEVICES + " (each shard's index carries its device)",
    ("mg/kmeans_mg.py", "fit"): _MG_DEVICES + " (devices=)",
    ("core/resources.py", "Resources"): _MG_DEVICES + " (the field devices)",
    ("neighbors/offload.py", "load"):
        "mmap: shards are loaded into pinned host memory, which a memory map cannot be",
    ("bench/measure.py", "timed_qps"):
        "nq: the port takes the query batch itself and rolls it each rep, so no rep "
        "re-searches the batch of the one before",
    ("ops/bf_topk_pallas.py", "fused_bf_topk"): "interpret: Pallas interpret mode, TPU-only",
    ("ops/bf_topk_pallas.py", "search"): "interpret: Pallas interpret mode, TPU-only",
    ("ops/ivf_scan_pallas.py", "fused_ivf_scan"):
        "inner, interpret: the MXU slice width and Pallas interpret mode, TPU-only",
    ("ops/ivf_scan_pallas.py", "fused_pq_scan"):
        "inner, interpret: the MXU slice width and Pallas interpret mode, TPU-only",
    ("neighbors/ivf_scan.py", "cluster_major_scan_fused"):
        "interpret: Pallas interpret mode, TPU-only",
    ("neighbors/ivf_scan.py", "cluster_major_scan_pq_fused"):
        "interpret: Pallas interpret mode, TPU-only",
    ("neighbors/ivf_scan.py", "cluster_major_scan_rabitq_fused"):
        "interpret: Pallas interpret mode, TPU-only",
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


def _arg_names(fn) -> list:
    a = fn.args
    extra = [x for x in (a.vararg, a.kwarg) if x is not None]
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs + extra]


def _parameters(path: pathlib.Path) -> dict:
    """{public function, Class (its body's fields) or Class.method (public or
    __init__): its parameter names} of one module, read by ast."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        public = not getattr(node, "name", "_").startswith("_")
        if public and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _arg_names(node)
        elif public and isinstance(node, ast.ClassDef):
            out[node.name] = [f.target.id for f in node.body
                              if isinstance(f, ast.AnnAssign) and isinstance(f.target, ast.Name)]
            for f in node.body:
                if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                        (not f.name.startswith("_") or f.name == "__init__"):
                    out[f"{node.name}.{f.name}"] = _arg_names(f)
    return out


def _exempt_params(reason: str) -> set:
    return {p.strip() for p in reason.split(":")[0].split(",")}


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


@pytest.mark.parametrize("rel", REF_MODULES)
def test_module_parameters_have_their_port(rel):
    """Every parameter of the reference's public functions, methods and class
    fields is taken by the port's counterpart, but those PARAM_EXEMPT names."""
    rel = pathlib.Path(rel)
    port = _parameters(_counterpart(rel))
    missing = {}
    for name, params in _parameters(REF / rel).items():
        if name not in port:  # a missing name is test_module_has_its_port's to report
            continue
        exempt = _exempt_params(PARAM_EXEMPT.get((str(rel), name), ""))
        lost = [p for p in params if p not in port[name] and p not in exempt]
        if lost:
            missing[name] = lost
    assert not missing, f"cuvs_tpu/{rel}: parameters missing in the port: {missing}"


@pytest.mark.parametrize("key", sorted(PARAM_EXEMPT))
def test_parameter_exemptions_are_still_needed(key):
    mod, name = key
    ref = _parameters(REF / mod)[name]
    port = _parameters(_counterpart(pathlib.Path(mod)))[name]
    for p in _exempt_params(PARAM_EXEMPT[key]):
        assert p in ref and p not in port, f"{mod}:{name}({p}) is no longer exempt"


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
