"""The PyTorch port stands alone: `caffeonspark_tpu_torch` and
chip_smoke.py import neither jax, ml_dtypes (the card's machine has
neither) nor anything of `caffeonspark_tpu`, and h5py and pyarrow (also
missing there) only where HDF5 or parquet is asked for.

Two checks: every module of the port imports in a fresh interpreter in
which importing jax or ml_dtypes fails, and afterwards neither h5py
nor pyarrow is loaded and no module named
`caffeonspark_tpu` or `caffeonspark_tpu.*` is loaded (the prefix also
matches `caffeonspark_tpu_torch`, which is of course loaded); and an AST
scan of the port's sources and chip_smoke.py finds no such import.
"""

import ast
import os
import subprocess
import sys

import pytest
from torch_common import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "caffeonspark_tpu_torch")

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["ml_dtypes"] = None
import caffeonspark_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m in ("caffeonspark_tpu", "h5py", "pyarrow")
                or m.startswith("caffeonspark_tpu."))
print(len(names), ",".join(leaked))
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, leaked = out.stdout.strip().split(" ", 1) \
        if " " in out.stdout.strip() else (out.stdout.strip(), "")
    assert int(count) >= 20          # every module was walked
    assert leaked == ""


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "ml_dtypes",
                           "caffeonspark_tpu"), \
            f"{os.path.relpath(path, REPO)} imports {name}"
