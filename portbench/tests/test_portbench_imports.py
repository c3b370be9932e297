"""What the benchmark may import: nothing under ``portbench/`` imports
JAX or the JAX package (top-level module names compared whole, so
``repro_torch`` is not ``repro``), and the reference imports nothing of
the program."""
import ast
import os
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not _imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PKG / "reference").rglob("*.py")):
        tops = _imported_tops(path)
        assert "repro_torch" not in tops and "portbench" not in tops, path


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(PKG.parent).with_suffix("").parts)
            for p in sorted(PKG.rglob("*.py"))
            if p.parent.name not in ("drivers", "metrics", "tests")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = {k.split('.')[0] for k in sys.modules} & "
            f"{FORBIDDEN!r}\n"
            "sys.exit(f'loaded {sorted(bad)}' if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ,
                              "PYTHONPATH": f"{PKG.parent}:"
                                            f"{PKG.parent / 'src'}"})
    assert res.returncode == 0, res.stdout + res.stderr
