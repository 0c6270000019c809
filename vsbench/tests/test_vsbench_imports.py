"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port. Top-level names are compared whole: the port's
``cuvs_tpu_torch`` begins with the JAX package's ``cuvs_tpu``."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cuvs_tpu"}


def _modules():
    for p in sorted(HERE.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" not in rel.parts and "." not in rel.name:
            yield ".".join(rel.parts)


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_every_module_imports_without_jax():
    code = "\n".join(f"import {m}" for m in _modules())
    code += "\nfrom vsbench import spec\nbm = spec.benchmark()\n"
    code += "[spec.metric(m['name']) for m in bm['end_to_end'] + bm['per_layer']]\n"
    code += "[spec.algo(spec.config(bm, c['name'])['algo']) for c in bm['configs']]"
    loaded = _loaded(code)
    assert "cuvs_tpu_torch" in loaded  # the port's entry points are loaded
    assert not loaded & FORBIDDEN


def test_harness_and_entry_points_in_this_process():
    for m in _modules():
        importlib.import_module(m)
    loaded = _loaded("import vsbench.run, vsbench.harness, vsbench.algos.ivf_pq, "
                     "vsbench.algos.ivf_flat")
    assert not loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    tree = ast.parse((HERE / "reference.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"torch", "__future__"}
    loaded = _loaded("import vsbench.reference")
    assert not loaded & (FORBIDDEN | {"cuvs_tpu_torch"})
