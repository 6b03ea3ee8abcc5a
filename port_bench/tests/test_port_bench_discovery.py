"""A new cell of an existing driver, a new configuration and a new
per-layer metric are files only: the harness finds each by name."""

import glob
import json
import os
import shutil
import sys

import pytest
import torch

import port_bench.families
import port_bench.reference
from port_bench import flops, harness
from port_bench.reference import precision
from port_bench.reference.uml import features


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    root = tmp_path / "port_bench"
    shutil.copytree(harness.BENCH, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    monkeypatch.setattr(harness, "BENCH", str(root))
    return root


def test_new_cell_and_config_are_found_by_name(bench_copy):
    cfg = json.loads((bench_copy / "configs" / "clip_vit_b16.json").read_text())
    cfg.update(name="clip_vit_b32", vision_patch_size=32)
    (bench_copy / "configs" / "clip_vit_b32.json").write_text(json.dumps(cfg))
    cell = json.loads((bench_copy / "workloads" / "clip_vit_b16.train_bs64.json").read_text())
    cell.update(name="clip_vit_b32.train_bs128", config="clip_vit_b32", batch=128)
    (bench_copy / "workloads" / "clip_vit_b32.train_bs128.json").write_text(json.dumps(cell))

    wl = harness.workload("clip_vit_b32.train_bs128")
    assert wl["batch"] == 128
    assert harness.config(wl["config"])["vision_patch_size"] == 32
    assert harness.module("drivers", wl["driver"]).run is not None
    fam = harness.module("families", cfg["family"])
    assert fam.shape(cfg)["s"] == (224 // 32) ** 2 + 1
    assert fam.forward_ops(cfg, 128)


def test_a_misnamed_file_is_refused(bench_copy):
    cell = json.loads((bench_copy / "workloads" / "clip_vit_b16.train_bs64.json").read_text())
    (bench_copy / "workloads" / "other.json").write_text(json.dumps(cell))
    with pytest.raises(SystemExit):
        harness.workload("other")
    with pytest.raises(SystemExit):
        harness.workload("no_such_cell")


def test_new_metric_file_is_read_without_an_edit(bench_copy):
    (bench_copy / "metrics" / "host_wait_ms.train.py").write_text(
        '"""A metric a later change adds."""\n\nUNIT = "ms"\n\n\n'
        'def read(run):\n'
        '    return run["window_s"] * 1e3 if run.get("kind") == "train" else None\n')
    run = {"kind": "train", "window_s": 2.0, "steps": 10, "model_flops": 1e12,
           "peak_flops": 989e12, "trace": None}
    got = harness.per_layer(run)
    assert got["host_wait_ms.train"] == {"value": 2000.0, "unit": "ms"}
    assert "mfu.train" in got
    # a reader that finds nothing is left out of the line
    assert "optimizer_ms.train" not in got
    assert "host_wait_ms.train" not in harness.per_layer({**run, "kind": "extract"})


def test_every_metric_reader_declares_a_unit():
    """Every file of metrics/ is a reader with a unit, and the readers are
    the benchmark's per-layer metrics, unit for unit."""
    readers = harness.metric_readers()
    files = glob.glob(os.path.join(harness.BENCH, "metrics", "[!_]*.py"))
    assert len(readers) == len(files)
    assert all(isinstance(m.UNIT, str) and callable(m.read) for m in readers.values())
    with open(os.path.join(harness.CHECKOUT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m["unit"] for m in json.load(f)["per_layer"]}
    assert per_layer == {name: m.UNIT for name, m in readers.items()}


TOY_FAMILY = '''"""A family a later change adds: a tower of one product."""

from port_bench.reference import toy as plain

reference_features = plain.features


def resolution(cfg):
    return cfg["image_size"]


def feature_width(cfg):
    return cfg["width"]


def forward_ops(cfg, batch):
    k = cfg["image_size"] ** 2 * 3
    return [("toy_proj", 2.0 * batch * k * cfg["width"], 0.0)]


def counters():
    return {}
'''

TOY_REFERENCE = '''"""The toy tower, plainly."""


def features(sd, images_u8, cfg, mm):
    return mm(images_u8.reshape(images_u8.shape[0], -1).float(), sd["proj"])
'''


@pytest.fixture
def toy_family(tmp_path, monkeypatch):
    """families/toy.py and reference/toy.py in a directory of their own,
    on the packages' search paths."""
    for pkg, text in ((port_bench.families, TOY_FAMILY),
                      (port_bench.reference, TOY_REFERENCE)):
        where = tmp_path / pkg.__name__.split(".")[-1]
        where.mkdir()
        (where / "toy.py").write_text(text)
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(where)])
    yield
    for name in ("port_bench.families.toy", "port_bench.reference.toy"):
        sys.modules.pop(name, None)


def test_new_family_is_files_only(toy_family):
    cfg = {"name": "toy", "family": "toy", "image_size": 4, "width": 8}
    fam = harness.module("families", cfg["family"])
    ops = flops.train_step(fam.forward_ops(cfg, 2), fam.feature_width(cfg), 2, 2, 3, 8,
                           100, 50)
    # the tower's product forward and backward (the pixels take no
    # gradient), the head's two products forward and backward
    assert flops.model_flops(ops) == 2 * (2.0 * 2 * 48 * 8) + 3 * 2 * (2 * 2 * 8 * 3)
    sd = {"proj": torch.ones(48, 8)}
    images = torch.ones(2, 4, 4, 3, dtype=torch.uint8)
    got = features(fam.reference_features, cfg, sd, images, precision.matmul)
    assert got.shape == (2, 8) and float(got[0, 0]) == 48.0


# the configuration keys and family names that only families/,
# reference/<family>.py and the data files may hold
FAMILY_WORDS = ("vision_width", "hidden_size", "image_resolution", "image_size",
                "embed_dim", "vocab_size", '"clip_vit"', '"dinov2"', '"llama_encoder"')


def test_shared_files_name_no_family():
    shared = [p for p in glob.glob(os.path.join(harness.BENCH, "**", "*.py"), recursive=True)
              if os.sep + "families" + os.sep not in p and os.sep + "tests" + os.sep not in p
              and os.path.dirname(p) != os.path.join(harness.BENCH, "reference")]
    shared += [os.path.join(harness.BENCH, "reference", n)
               for n in ("__init__.py", "uml.py", "vit.py", "precision.py")]
    assert len(shared) > 20
    for path in shared:
        text = open(path).read()
        assert not [w for w in FAMILY_WORDS if w in text], path
