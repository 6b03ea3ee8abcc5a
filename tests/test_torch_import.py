"""The port imports neither jax nor uml_tpu."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import uml_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(uml_tpu_torch.__file__)
MODULES = sorted(m.name for m in pkgutil.walk_packages([PKG_DIR],
                                                       "uml_tpu_torch."))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_package_imports_with_jax_blocked():
    """Every module of uml_tpu_torch imports in a process where importing
    jax fails, and none of them pulls in uml_tpu."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for name in {['uml_tpu_torch'] + MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'uml_tpu' "
        "or m.startswith(('uml_tpu.', 'jax.', 'flax'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", MODULES)
def test_module_source_imports_no_jax_or_uml_tpu(module):
    path = os.path.join(os.path.dirname(PKG_DIR),
                        *module.split(".")) + ".py"
    if not os.path.exists(path):
        path = os.path.join(path[:-3], "__init__.py")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "flax", "uml_tpu"), (module, name)


def test_module_list_covers_the_training_slice():
    """The walk above reaches the modules of the training path."""
    for name in ("uml_tpu_torch.cli.finetune", "uml_tpu_torch.cli.collect_results",
                 "uml_tpu_torch.train.supervised", "uml_tpu_torch.train.optim",
                 "uml_tpu_torch.metrics.alignment", "uml_tpu_torch.models.uml_head",
                 "uml_tpu_torch.utils.logging"):
        assert name in MODULES, name


def test_module_list_covers_the_stand_alone_ops():
    """... and the modules of the non-fused branch's ops."""
    for name in ("uml_tpu_torch.ops.attention", "uml_tpu_torch.ops.layer_norm",
                 "uml_tpu_torch.ops._vjp"):
        assert name in MODULES, name


def test_chip_smoke_source_imports_no_jax_or_uml_tpu():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "flax", "uml_tpu"), name
