"""Import hygiene of the port: no JAX, nothing of the reference package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "gmm_bench.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_were_found():
    assert len(PORT_FILES) > 10
    assert ROOT / "src" / "repro_torch" / "launch" / "serve.py" in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "traffic" / "queueing.py" in PORT_FILES
    for name in ("__init__", "probes", "recorder", "export", "schema"):
        assert ROOT / "src" / "repro_torch" / "obs" / f"{name}.py" in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "traffic" / "batching.py" in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "traffic" / "replan.py" in PORT_FILES


def test_serve_import_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.traffic, repro_torch.core.engine, repro_torch.obs; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
