"""A whole run on the CPU at a tiny size, past the harness's look for a
card, with the timed path broken underneath: ``correct`` comes out false
for every fault a cell can have.

The numbers of a tiny model are not those of the cells' sizes, so the
limits here are four times what a sound tiny run of the same seed reads
(the cells' own limits are checked at their sizes on the card:
test_port_bench_card.py)."""

import time

import pytest
import torch

from port_bench import compare
from port_bench.run import run_cell
from port_bench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 77
TRAIN = [(tiny.clip_cfg, "clip_vit_b16.train_bs64"),
         (tiny.dino_cfg, "dinov2_vit_b14.train_bs64"),
         (tiny.clip_cfg, "clip_vit_b16.train_bs256")]
EXTRACT = (tiny.clip_cfg, "clip_vit_b16.extract_bs64")
DINO_EXTRACT = (tiny.dino_cfg, "dinov2_vit_b14.extract_bs64")
TEXT = (tiny.text_cfg, "mistral_7b.text_cupl30")


def _run(make_cfg, name, limits=None):
    wl = tiny.cell(name)
    if limits is not None:
        wl["limits"] = limits
    return run_cell(wl, make_cfg(), SEED, 0.3, False, CPU, time.perf_counter())


_sound = {}


def _limits(make_cfg, name):
    """Four times the sound tiny run's readings of the cell's numbers."""
    if name not in _sound:
        out = _run(make_cfg, name)
        _sound[name] = {k: 4 * max(out["numbers"][k], 1e-6)
                        for k in tiny.cell(name)["limits"]}
    return _sound[name]


@pytest.mark.parametrize("make_cfg,name", TRAIN + [EXTRACT, DINO_EXTRACT, TEXT])
def test_sound_run_passes_its_own_limits(make_cfg, name):
    out = _run(make_cfg, name, _limits(make_cfg, name))
    assert out["correct"], out["checks"]


def _state_unchanged(monkeypatch):
    from uml_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self, it: None)


def _half_batch(monkeypatch):
    from uml_tpu_torch.train import supervised

    full = supervised._weighted_loss

    def half(logits, labels, weights, denom, shard):
        h = len(labels) // 2
        return full(logits[:h], labels[:h], weights[:h], weights[:h].sum(), shard)

    monkeypatch.setattr(supervised, "_weighted_loss", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
@pytest.mark.parametrize("make_cfg,name", TRAIN)
def test_train_fault_is_not_correct(monkeypatch, fault, make_cfg, name):
    limits = _limits(make_cfg, name)
    fault(monkeypatch)
    out = _run(make_cfg, name, limits)
    assert not out["correct"], out["checks"]


def _rows_swapped(out):
    return out.flip(0)


def _half_rows_lost(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


@pytest.mark.parametrize("alter", [_rows_swapped, _half_rows_lost])
@pytest.mark.parametrize("cell", [EXTRACT, DINO_EXTRACT])
def test_extract_answer_altered_is_not_correct(monkeypatch, alter, cell):
    from uml_tpu_torch.models.encoders import ClipEncoder

    limits = _limits(*cell)
    encode = ClipEncoder.encode_staged

    def altered(self, batch, n, return_tokens=False):
        out, n = encode(self, batch, n, return_tokens)
        return alter(out), n

    monkeypatch.setattr(ClipEncoder, "encode_staged", altered)
    out = _run(*cell, limits)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("alter", [_rows_swapped, _half_rows_lost])
def test_text_answer_altered_is_not_correct(monkeypatch, alter):
    from uml_tpu_torch.models.languagemodel import TextModel

    limits = _limits(*TEXT)
    encode = TextModel.encode_ids

    def altered(self, input_ids, attention_mask, return_tokens=False):
        return alter(encode(self, input_ids, attention_mask, return_tokens))

    monkeypatch.setattr(TextModel, "encode_ids", altered)
    out = _run(*TEXT, limits)
    assert not out["correct"], out["checks"]


def _pads_counted(self, input_ids, attention_mask, return_tokens=False):
    """The fault "pads counted in the mean": the last hidden state pooled
    over every position of the padded rows."""
    ids = torch.as_tensor(input_ids, dtype=torch.long, device=self.device)
    mask = torch.as_tensor(attention_mask, dtype=torch.long, device=self.device)
    with torch.no_grad():
        return self.model(ids, mask).float().mean(1)


def test_text_pads_counted_is_not_correct(monkeypatch):
    from uml_tpu_torch.models.languagemodel import TextModel

    limits = _limits(*TEXT)
    monkeypatch.setattr(TextModel, "encode_ids", _pads_counted)
    out = _run(*TEXT, limits)
    assert not out["correct"], out["checks"]
    assert out["numbers"]["feature_nmse"] > 100 * limits["feature_nmse"]


def test_judge_fails_a_limit_not_set_and_a_nan():
    assert not compare.judge({"a": 0.1}, {"a": None})[0]
    assert not compare.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert compare.judge({"a": 0.1}, {"a": 0.2})[0]
