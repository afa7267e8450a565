"""The port stands alone: it imports without JAX, flax or the JAX package,
and without the host libraries the card's machine lacks (h5py, msgpack,
sklearn)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    """Import the package, every submodule and the port's scripts in a fresh
    interpreter (the suite's conftest has already imported jax in this one)
    in which h5py, msgpack and sklearn cannot be imported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('h5py', 'msgpack', 'sklearn'):\n"
        "            raise ImportError(f'{name} is blocked in this test')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import hicdiff_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(hicdiff_tpu_torch.__path__,"
        " 'hicdiff_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke, inference_torch, pretrain_baselines_torch, pretrain_torch\n"
        "import sample.stard_metric_normal_torch, serve_torch, train_torch\n"
        "import sample.stard_metric_cond_torch, sample.stard_metric_diff_torch\n"
        "import threed_comp_torch, tools.torch_quartet_metrics\n"
        "import tools.torch_convert_checkpoint, tools.torch_export_checkpoint\n"
        "import tools.torch_make_fullscale_fixture, tools.torch_latent_target\n"
        "import tools.torch_fullscale_quality, distill_torch\n"
        "import tools.torch_serve_concurrency_smoke, tools.torch_card_trajectory\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'hicdiff_tpu', 'h5py', 'msgpack', 'sklearn'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 53, names\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def _port_sources():
    """Every source file of the port: the package, the *_torch.py scripts,
    tools/torch_*.py, sample/*_torch.py and chip_smoke.py."""
    import glob

    pats = ["hicdiff_tpu_torch/**/*.py", "*_torch.py", "tools/torch_*.py", "sample/*_torch.py",
            "chip_smoke.py"]
    return sorted({p for pat in pats for p in glob.glob(os.path.join(ROOT, pat), recursive=True)})


def _imports_of(roots):
    """file:line of every import, at module level or inside a function, of
    a module under one of `roots` in the port's sources."""
    import ast

    files = _port_sources()
    assert len(files) >= 74, files
    assert os.path.join(ROOT, "tools", "torch_card_trajectory.py") in files
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                    node.func, "id", "")) in ("import_module", "__import__"):
                names = [a.value for a in node.args if isinstance(a, ast.Constant)]
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno}" for n in names
                    if str(n).split(".")[0] in roots]
    return bad


def test_port_imports_h5py_nowhere():
    """No port source imports h5py, at module level or inside a function:
    the port reads and writes .mcool files through its own
    `data/hdf5.py`, also where h5py is installed."""
    bad = _imports_of({"h5py"})
    assert not bad, bad


def test_port_imports_jax_nowhere():
    """No port source imports JAX, flax, optax or the JAX package, at
    module level or inside a function, so no path that the import test
    does not reach can need them either."""
    bad = _imports_of({"jax", "jaxlib", "flax", "optax", "hicdiff_tpu"})
    assert not bad, bad
