"""The port imports neither JAX nor hulk_tpu.

Every module of hulk_tpu_torch is imported in a fresh interpreter with a
meta-path finder that refuses `jax`, `jaxlib` and `hulk_tpu` (not
`hulk_tpu_torch`); and no import statement anywhere in the package or in
chip_smoke.py, lazy ones inside functions included, names those packages.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "hulk_tpu_torch"
BLOCKED = ("jax", "jaxlib", "hulk_tpu")

_CHILD = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "hulk_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]
sys.meta_path.insert(0, Refuse())
import hulk_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hulk_tpu_torch.__path__, "hulk_tpu_torch.")]
for want in ("hulk_tpu_torch.parallel.mesh", "hulk_tpu_torch.stream.watchdog",
             "hulk_tpu_torch.entry", "hulk_tpu_torch.ops.flush_drift",
             "hulk_tpu_torch.ops.flush_drift_cuda"):
    assert want in names, want
for n in names:
    if n != "hulk_tpu_torch.__main__":  # runs the CLI when imported
        importlib.import_module(n)
import chip_smoke
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(len(names), loaded)
"""


def test_every_module_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n, loaded = out.stdout.split(maxsplit=1)
    assert int(n) >= 25
    assert loaded.strip() == "[]"


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_import_statement_names_jax_or_hulk_tpu():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files for name in _imported_names(f)
        if name.split(".")[0] in BLOCKED
    ]
    assert bad == []
