"""The port stands alone: no file of src/repro_torch/ (nor chip_smoke.py)
imports jax or the JAX package ``repro``, importing every port module
leaves both out of sys.modules, parameter trees carry across through numpy
with their key paths, and chip_smoke.py refuses to run without a GPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.codecs import build as jbuild  # noqa: E402
from repro.models import convnets as jnets  # noqa: E402
from repro_torch.interop import (params_from_numpy, params_to_numpy,  # noqa: E402
                                 tree_leaves, tree_map, tree_unflatten)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_every_port_module_imports_without_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 16 and bad.strip() == "[]", out.stdout


# a meta-path hook that makes jax and the JAX package unimportable
_BLOCK = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
    "            raise ImportError(f'{name} is blocked')\n"
    "sys.meta_path.insert(0, Block())\n")


def _run_blocked(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", _BLOCK + code],
                          capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=300)


@pytest.mark.parametrize("module", [
    "repro_torch.launch.train", "repro_torch.checkpoint",
    "repro_torch.models.lm", "repro_torch.data.pipeline",
    "repro_torch.optim"])
def test_training_modules_import_with_jax_absent(module):
    out = _run_blocked(f"import {module}\nprint('ok')\n")
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_training_cli_runs_with_jax_absent(tmp_path):
    """One reduced train step on the CPU, with a checkpoint, and jax and
    the JAX package unimportable."""
    out = _run_blocked(
        "from repro_torch.launch import train\n"
        "train.main(['--reduced', '--steps', '1', '--seq', '8', '--batch', "
        "'4', '--device', 'cpu', '--codec', 'c3sl:R=2', '--ckpt-dir', "
        f"{str(tmp_path)!r}])\n")
    assert out.returncode == 0, out.stderr
    assert "boundary traffic" in out.stdout and "final loss" in out.stdout
    assert (tmp_path / "step_00000001" / "arrays.npz").exists()


def test_chip_smoke_fails_without_a_gpu():
    """Where torch.cuda.is_available() is false the script exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=str(ROOT),
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_reference_params_round_trip_with_key_paths():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jnets.init_vgg16, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)
    t = params_from_numpy(tree, device="cpu")
    assert set(t) == set(tree) and len(t["convs"]) == len(tree["convs"]) == 13
    assert isinstance(t["convs"], list) and t["fc"]["w"].shape == (512, 10)
    back = params_to_numpy(t)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the port's leaf order is jax.tree's (dicts in sorted key order)
    assert [tuple(x.shape) for x in tree_leaves(t)] == \
        [x.shape for x in jax.tree.leaves(tree)]


def test_complex_key_spectrum_becomes_complex64():
    c = jbuild("c3sl:R=4,D=64")
    p = jax.tree.map(np.asarray, c.init(jax.random.PRNGKey(0)))
    t = params_from_numpy(p, device="cpu")
    assert t["keys"].dtype == torch.float32
    assert t["keys_fft"].dtype == torch.complex64
    np.testing.assert_array_equal(t["keys_fft"].numpy(), p["keys_fft"])
    t128 = params_from_numpy({"s": p["keys_fft"].astype(np.complex128)}, "cpu")
    assert t128["s"].dtype == torch.complex64


def test_tree_helpers_keep_structure():
    tree = {"b": [np.zeros(2), (np.ones(3), np.ones(1))], "a": {"x": np.zeros(1)}}
    leaves = tree_leaves(tree)
    assert [x.shape for x in leaves] == [(1,), (2,), (3,), (1,)]
    rebuilt = tree_unflatten(tree, [x + 1 for x in leaves])
    assert isinstance(rebuilt["b"][1], tuple)
    np.testing.assert_array_equal(rebuilt["b"][1][0], np.full(3, 2.0))
    summed = tree_map(lambda x, y: x + y, tree, rebuilt)
    np.testing.assert_array_equal(summed["a"]["x"], np.ones(1))
