"""The port stands alone: it imports without JAX, flax or the JAX package."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    """Import the package and every submodule in a fresh interpreter (the
    suite's conftest has already imported jax in this one)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hicdiff_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(hicdiff_tpu_torch.__path__,"
        " 'hicdiff_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke, serve_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'hicdiff_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 12, names\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
