"""The port imports neither jax nor the JAX package: every module of
``srack_tpu_torch/`` and ``chip_smoke.py`` read with ``ast``, and the
whole port (``io``, ``parallel``, ``rt``, ``__main__`` and every other
module) imported in a process where ``jax`` is blocked."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "srack_tpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "srack_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    bad = [(f.relative_to(ROOT), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_port_imports_with_jax_blocked():
    names = sorted(
        ".".join(("srack_tpu_torch",) + p.relative_to(
            ROOT / "srack_tpu_torch").with_suffix("").parts).removesuffix(
                ".__init__")
        for p in (ROOT / "srack_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'srack_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None}\n"
        "print('imported', len(" + repr(names) + "))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "imported" in proc.stdout
