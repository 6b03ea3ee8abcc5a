"""The plain reference against the program's CPU path at a tiny size.

In float32 the program's plain paths compute what the reference
computes, so the two agree to float32 round-off: features, and the
compared numbers of the first three train steps.  In bfloat16 (what the
configurations state) they agree to bfloat16's rounding, and the float8
control does not."""

import pytest
import torch

from port_bench import compare, harness
from port_bench.drivers import extract, extract_text, train_step
from port_bench.reference import precision
from port_bench.reference.uml import features
from port_bench.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("make_cfg", [tiny.clip_cfg, tiny.dino_cfg])
def test_features_fp32_agree(make_cfg):
    cfg = {**make_cfg(), "compute_dtype": "float32"}
    fam = harness.module("families", cfg["family"])
    cell = {**tiny.cell("clip_vit_b16.extract_bs64"), "pool_batches": 1, "batch": 6}
    images = extract.pool(cell, cfg, fam, 7, CPU)[0]
    sd = fam.state_dict(cfg, 7, CPU)
    model = fam.build_backbone(cfg, sd, CPU)
    with torch.no_grad():
        got = model.encode_image_u8(torch.from_numpy(images)).float()
    want = features(fam.reference_features, cfg, fam.image_tower_keys(sd), torch.from_numpy(images),
                    precision.matmul)
    assert compare.feature_numbers(got, want)["feature_gap"] < 1e-5


def _numbers(cfg, name, mm="fp32"):
    wl = tiny.cell(name)
    fam = harness.module("families", cfg["family"])
    sd = fam.state_dict(cfg, 11, CPU)
    img_b, txt_b, rows, labels = train_step.pools(wl, cfg, fam, 11, CPU, sd)
    head, optimizer, step = train_step.build(wl, cfg, fam, 11, CPU, sd, rows, labels)
    names = [k for k, p in head.named_parameters() if p.requires_grad]
    prog_units, ref_units = fam.units(names)
    prog = train_step.first_steps(head, optimizer, step, img_b, txt_b, 3, prog_units)
    args = (wl, cfg, fam, 11, CPU, img_b, txt_b, rows, labels, ref_units)
    ref = train_step.reference(*args)
    control = train_step.reference(*args, mm="fp8")
    return compare.train_numbers(prog, ref), compare.train_numbers(control, ref)


@pytest.mark.parametrize("make_cfg,name", [(tiny.clip_cfg, "clip_vit_b16.train_bs64"),
                                           (tiny.dino_cfg, "dinov2_vit_b14.train_bs64")])
def test_train_step_fp32_agrees(make_cfg, name):
    prog, _ = _numbers({**make_cfg(), "compute_dtype": "float32"}, name)
    assert prog["loss_gap"] < 1e-5
    assert prog["grad_gap"] < 1e-4
    # AdamW's first steps are nearly sign(g) * lr: an element whose
    # gradient sits near round-off moves by a different amount
    assert prog["change_gap"] < 1e-3
    # the key bias is left out of the change by the rule on the reference
    assert prog["units_left_out"] >= 2


@pytest.mark.parametrize("make_cfg,name", [(tiny.clip_cfg, "clip_vit_b16.train_bs64"),
                                           (tiny.dino_cfg, "dinov2_vit_b14.train_bs64")])
def test_bf16_within_rounding_and_fp8_control_further(make_cfg, name):
    prog, control = _numbers(make_cfg(), name)
    assert prog["loss_gap"] < 0.02 and prog["grad_gap"] < 0.05
    assert max(control[k] / prog[k] for k in ("loss_gap", "grad_gap", "change_gap")) > 3


def test_llama_encoder_fp32_agrees():
    """The program's TextModel against the plain reference: 2 layers,
    hidden 64, 4 heads over 2 kv heads, left-padded rows of unequal
    length, seeded weights."""
    cfg = tiny.text_cfg()
    fam = harness.module("families", cfg["family"])
    wl = tiny.cell("mistral_7b.text_cupl30")
    calls = extract_text.pool(wl, fam.vocab(cfg), 5)
    ids, mask, lengths = calls[0]
    assert len(set(lengths)) > 1 and mask[:, 0].min() == 0 and mask[:, -1].min() == 1
    sd = fam.state_dict(cfg, 5, CPU)
    tm = fam.build_text_model(cfg, sd, CPU)
    got = torch.cat([torch.from_numpy(extract_text.encode(tm, c)) for c in calls])
    want = extract_text.reference(cfg, fam, 5, CPU, calls, range(len(calls)))
    assert got.shape == (len(calls) * 30, 64)
    assert compare.feature_numbers(got, want)["feature_gap"] < 1e-5


def test_llama_reference_reads_no_pad():
    """A row's features do not move when its pads' ids change."""
    cfg = tiny.text_cfg()
    fam = harness.module("families", cfg["family"])
    ids, mask, _ = extract_text.pool(tiny.cell("mistral_7b.text_cupl30"), 100, 9)[0]
    sd = fam.state_dict(cfg, 9, CPU)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    other = torch.where(mask.bool(), ids, torch.full_like(ids, 57))
    with precision.strict_fp32():
        a = fam.reference_features(sd, ids, mask, cfg, precision.matmul)
        b = fam.reference_features(sd, other, mask, cfg, precision.matmul)
    assert torch.equal(a, b)
