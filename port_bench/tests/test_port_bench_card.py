"""On the card, at each cell's own size: the control, and the faults
("half of the batch left out", the text cell's "pads counted in the
mean"), fail the cell's limits on three seeds.

    python3 -m pytest port_bench/tests -m cuda

Skips without a CUDA device (decided inside the test)."""

import pytest
import torch

from port_bench import compare, harness

SEEDS = (3300000001, 3300000002, 3300000003)
CELLS = ("clip_vit_b16.train_bs64", "dinov2_vit_b14.train_bs64",
         "clip_vit_b16.extract_bs64", "clip_vit_b16.train_bs256",
         "dinov2_vit_b14.extract_bs64", "mistral_7b.text_cupl30")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_the_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.cache_dirs()
    wl = harness.workload(name)
    cfg = harness.config(wl["config"])
    fam = harness.module("families", cfg["family"])
    readings = harness.module("drivers", wl["driver"]).readings
    device = torch.device("cuda", 0)
    for seed in SEEDS:
        for reading, numbers in readings(wl, cfg, fam, seed, device, True):
            ok, rows = compare.judge(numbers, wl["limits"])
            assert ok == (reading == "program"), (seed, reading, rows)
