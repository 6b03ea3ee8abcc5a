"""A run without a card gives no result; a run's CPU path loads nothing
of JAX or the JAX package."""

import os
import subprocess
import sys

from port_bench import harness

ENV = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": harness.CHECKOUT}


def test_no_card_no_number():
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", "clip_vit_b16.train_bs64",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=harness.CHECKOUT, env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


SCRIPT = r"""
import sys, time, torch
from port_bench import harness
from port_bench.run import run_cell
from port_bench.tests import tiny
for cfg, name in ((tiny.clip_cfg(), "clip_vit_b16.train_bs64"),
                  (tiny.dino_cfg(), "dinov2_vit_b14.train_bs64"),
                  (tiny.clip_cfg(), "clip_vit_b16.extract_bs64"),
                  (tiny.dino_cfg(), "dinov2_vit_b14.extract_bs64"),
                  (tiny.text_cfg(), "mistral_7b.text_cupl30")):
    run_cell(tiny.cell(name), cfg, 5, 0.2, False, torch.device("cpu"), time.perf_counter())
assert "uml_tpu_torch" in sys.modules
print("FORBIDDEN", harness.forbidden_modules())
"""


def test_cpu_path_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=harness.CHECKOUT,
                          env=ENV, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "uml_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
