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


def test_module_list_covers_the_dino_slice():
    """... and the modules of the DINO serving path."""
    for name in ("uml_tpu_torch.models.dino", "uml_tpu_torch.models.languagemodel",
                 "uml_tpu_torch.models.convert"):
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


def test_module_list_covers_the_language_model_and_resume_slice():
    """... and the modules of the LLaMA text encoder and the resume."""
    for name in ("uml_tpu_torch.models.llama", "uml_tpu_torch.core.checkpoint",
                 "uml_tpu_torch.core.prng"):
        assert name in MODULES, name


def test_module_list_covers_the_multibench_slice():
    """... and the 13 modules of the MultiBench self-supervised path."""
    for name in ("uml_tpu_torch.data.seq_augment", "uml_tpu_torch.data.robustness",
                 "uml_tpu_torch.data.affect", "uml_tpu_torch.data.mimic",
                 "uml_tpu_torch.data.preprocess_affect", "uml_tpu_torch.data.text_embed",
                 "uml_tpu_torch.metrics.alignment", "uml_tpu_torch.models.seq_autoencoder",
                 "uml_tpu_torch.models.convert", "uml_tpu_torch.train.probes",
                 "uml_tpu_torch.train.selfsup", "uml_tpu_torch.cli.multibench",
                 "uml_tpu_torch.cli.collect_results_mb"):
        assert name in MODULES, name


GAUSSIAN_AND_PARALLEL = [
    "uml_tpu_torch.cli.gaussian", "uml_tpu_torch.train.gaussian",
    "uml_tpu_torch.data.gaussian", "uml_tpu_torch.models.shared_autoencoder",
    "uml_tpu_torch.models.initializers", "uml_tpu_torch.core.distributed",
    "uml_tpu_torch.core.meshes", "uml_tpu_torch.parallel",
    "uml_tpu_torch.parallel.data_parallel", "uml_tpu_torch.utils.profiling",
]


@pytest.mark.parametrize("module", GAUSSIAN_AND_PARALLEL)
def test_gaussian_and_parallel_modules_are_checked(module):
    """The Gaussian family, data parallelism and profiling are among the
    modules the two tests above hold to no jax and no uml_tpu."""
    assert module in MODULES
