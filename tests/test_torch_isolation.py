"""The port stands alone: apex_example_tpu_torch and chip_smoke.py import
no jax and no module of apex_example_tpu.

- every module of the port, and chip_smoke.py, imports in a subprocess
  whose ``sys.path`` starts with a poisoned ``jax``, ``jaxlib``, ``flax``
  and ``apex_example_tpu`` that raise on import;
- a static scan of every import statement in the port, matching the
  module ``apex_example_tpu`` and ``apex_example_tpu.*`` exactly (the
  port's own name shares that prefix);
- graftlint finds nothing new in the port's files.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "apex_example_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "apex_example_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        files += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    return sorted(files)


def _port_modules():
    import apex_example_tpu_torch
    return ["apex_example_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(
            apex_example_tpu_torch.__path__, "apex_example_tpu_torch."))


def _forbidden(module):
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_name_match_is_exact():
    assert _forbidden("apex_example_tpu")
    assert _forbidden("apex_example_tpu.serve.queue")
    assert _forbidden("jax.numpy")
    assert not _forbidden("apex_example_tpu_torch")
    assert not _forbidden("apex_example_tpu_torch.serve.queue")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            found.append(node.module)
    assert found == []


def test_every_module_imports_with_jax_and_the_jax_package_poisoned(
        tmp_path):
    for name in FORBIDDEN:
        pkg = tmp_path / name
        pkg.mkdir()
        (pkg / "__init__.py").write_text(
            f"raise ImportError('the port imported {name}')\n")
    modules = _port_modules()
    assert "apex_example_tpu_torch.serve.engine" in modules
    script = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {REPO!r}]\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_graftlint_finds_nothing_new_in_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "tools.graftlint", "--fail-on-new",
         "apex_example_tpu_torch", "chip_smoke.py"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
