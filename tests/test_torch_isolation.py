"""The port stands alone: no JAX, no `repro` package, at import or in source.

A fresh interpreter imports every `repro_torch` module and `chip_smoke`
(whose helpers are importable without a card) and must end up with
neither ``jax`` nor ``repro``/``repro.*`` in ``sys.modules``.
"""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.bound(chip_smoke.a4_counts(8, 192, 6, 8), 8)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_import_pulls_in_no_jax_and_no_reference():
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 15, out.stdout
    assert bad == "[]", out.stdout


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_the_walk_reaches_the_examples_and_the_mesh_modules():
    """The two tests above walk every module under `repro_torch`: the
    examples package, the slot-mesh modules and the LM modules are among
    them."""
    rel = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for name in ("examples/__init__.py", "examples/quickstart.py",
                 "examples/parallel_tempering.py", "examples/annealing_service.py",
                 "examples/quantum_annealing.py", "launch/mesh.py", "obs/skew.py",
                 "core/qmc.py", "runtime/ft.py", "configs/registry.py", "configs/gemma_2b.py",
                 "nn/param.py", "nn/basic.py", "nn/attention.py", "nn/moe.py",
                 "sharding/ctx.py", "models/decoder.py", "launch/serve.py",
                 "examples/serve_lm.py"):
        assert name in rel, name
