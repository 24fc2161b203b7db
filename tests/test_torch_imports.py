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


# The process each gloo rank of the sharded tests runs: the port alone.
WORKERS = [ROOT / "tests" / "torch_ep_worker.py",
           ROOT / "tests" / "torch_tp_worker.py",
           ROOT / "tests" / "torch_zero_cp_worker.py"]


@pytest.mark.parametrize("path", WORKERS, ids=[p.name for p in WORKERS])
def test_worker_imports_no_jax_and_no_reference(path):
    names = _imported_modules(path)
    assert "repro_torch.models" in names
    bad = [n for n in names if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_were_found():
    assert len(PORT_FILES) > 10
    assert ROOT / "src" / "repro_torch" / "launch" / "serve.py" in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "traffic" / "queueing.py" in PORT_FILES
    for name in ("__init__", "probes", "recorder", "export", "schema"):
        assert ROOT / "src" / "repro_torch" / "obs" / f"{name}.py" in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "traffic" / "batching.py" in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "traffic" / "replan.py" in PORT_FILES
    for name in ("scenarios", "federation"):
        assert ROOT / "src" / "repro_torch" / "traffic" / f"{name}.py" \
            in PORT_FILES
    for rel in (("distributed", "__init__.py"), ("distributed", "elastic.py"),
                ("core", "simulator.py"), ("models", "frontends.py"),
                ("models", "ssm.py"), ("configs", "shapes.py"),
                *[("configs", f"{name}.py") for name in (
                    "granite_moe_3b_a800m", "qwen2_5_3b", "smollm_135m",
                    "minicpm_2b", "llava_next_mistral_7b", "musicgen_medium",
                    "mistral_large_123b", "jamba_1_5_large_398b",
                    "xlstm_350m")],
                ("tree.py",), ("optim", "adamw.py"), ("optim", "schedules.py"),
                ("data", "pipeline.py"), ("checkpoint", "store.py"),
                ("launch", "steps.py"), ("launch", "train.py"),
                ("launch", "roofline.py"), ("launch", "dryrun.py"),
                ("launch", "op_analysis.py"), ("counting.py",)):
        assert ROOT.joinpath("src", "repro_torch", *rel) in PORT_FILES


def test_serve_import_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.traffic, repro_torch.core.engine, repro_torch.obs, "
            "repro_torch.distributed, repro_torch.configs, "
            "repro_torch.models.frontends, repro_torch.models.ssm, "
            "repro_torch.configs.shapes; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_train_import_loads_no_jax():
    code = ("import sys, repro_torch.launch.train, repro_torch.optim, "
            "repro_torch.data, repro_torch.checkpoint, repro_torch.tree; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_dryrun_import_loads_no_jax():
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline, repro_torch.launch.op_analysis, "
            "repro_torch.counting; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_fake_group_is_imported_in_dryrun_only():
    """``torch.testing._internal`` (torch's test utilities, not a public
    API) is imported by ``launch/dryrun.py`` alone."""
    users = [p.relative_to(ROOT) for p in PORT_FILES
             if "torch.testing._internal" in p.read_text()]
    assert users == [Path("src/repro_torch/launch/dryrun.py")]
