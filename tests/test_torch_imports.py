"""The port stands alone: neither dsac_tpu_torch/ nor chip_smoke.py
imports JAX, Flax or anything of dsac_tpu (the card's machine has none of
them), and the package imports cleanly on a machine without CUDA."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "dsac_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "flax", "dsac_tpu")


def imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


# the data layer's modules, which the checks below must reach
DATA_LAYER = ("flags.py", "data/synthetic.py", "data/seven_scenes.py",
              "utils/native_io.py", "cli/common.py",
              "cli/export_synthetic.py", "cli/link_7scenes.py")


def test_files_are_found():
    assert len(FILES) > 20
    found = {str(p.relative_to(ROOT / "dsac_tpu_torch")) for p in FILES
             if p.is_relative_to(ROOT / "dsac_tpu_torch")}
    assert set(DATA_LAYER) <= found


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_package_imports_without_jax():
    """Import every module of the port in a fresh interpreter in which
    jax, flax and dsac_tpu cannot be imported."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'dsac_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib, dsac_tpu_torch\n"
        "for mod in pkgutil.walk_packages(dsac_tpu_torch.__path__,\n"
        "                                 'dsac_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
