"""The program's spans (``utils/profiling.py``): off without a profiler,
the train step's and the extraction pipeline's phases under one, and
their clock against a ``torch.profiler`` chrome trace (all on the CPU)."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uml_tpu_torch.models import encoders
from uml_tpu_torch.models.clip import CLIP, ClipConfig
from uml_tpu_torch.models.uml_head import UMLHead
from uml_tpu_torch.train.optim import build_optimizer, build_schedule
from uml_tpu_torch.train.supervised import make_train_step
from uml_tpu_torch.utils import profiling

TINY = ClipConfig(embed_dim=64, image_resolution=64, vision_layers=1,
                  vision_width=128, vision_patch_size=32,
                  transformer_width=128, transformer_heads=2,
                  transformer_layers=1)
PHASES = ("uml.step.place", "uml.step.forward", "uml.step.backward",
          "uml.step.optimizer", "uml.step.metrics")


@pytest.fixture(autouse=True)
def _empty_buffer():
    """Every test starts and ends with the span buffer empty."""
    torch.set_num_threads(1)
    profiling.take_spans()
    yield
    profiling.take_spans()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _step():
    """A tiny head's step on the CPU (image inputs taken as features) and
    a batch of each modality."""
    rng = np.random.default_rng(0)
    model = UMLHead(feat_dim=8, num_classes=3, logit_scale=0.0)
    opt = build_optimizer("adamw", build_schedule(0.01, "cosine", 0, 10), 0.0)
    step = make_train_step(model, opt, has_image=True, has_text=True)

    def batch():
        return (rng.standard_normal((4, 8)).astype(np.float32),
                rng.integers(0, 3, 4), np.ones(4, np.float32))

    return step, batch(), batch()


def _encoder(tmp_path, monkeypatch):
    torch.save(CLIP(TINY).init_random(torch.Generator().manual_seed(2)).state_dict(),
               str(tmp_path / "ViT-B-32.pt"))
    monkeypatch.setenv("UML_CLIP_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("UML_CLIP_VERIFY_SHA", "0")
    return encoders.ClipEncoder("ViT-B/32", dtype=torch.float32, device="cpu")


def test_spans_are_off_by_default():
    """Without a profiler ``span`` hands out one shared no-op context and
    a step records nothing."""
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a") as got:
        assert got is None
    step, img, txt = _step()
    step(0, img, txt)
    assert profiling.take_spans() == []


def test_a_step_records_its_phases_inside_it():
    step, img, txt = _step()
    with _profiled():
        step(0, img, txt)
        step(1, img, txt)
    spans = profiling.take_spans()
    assert profiling.take_spans() == []
    roots = sorted((s for s in spans if s.name == "uml.step"), key=lambda s: s.start_ns)
    assert [r.parent for r in roots] == [None] * 2
    assert roots[0].end_ns <= roots[1].start_ns
    for root in roots:
        children = [s for s in spans if s.parent == root.id]
        assert {c.name for c in children} == set(PHASES)
        # place and forward once a modality, the optimizer around
        # zero_grad and around its step
        assert sorted(c.name for c in children) == sorted(
            [*PHASES, "uml.step.place", "uml.step.forward", "uml.step.optimizer"])
        for c in children:
            assert root.start_ns <= c.start_ns <= c.end_ns <= root.end_ns
            assert c.tid == root.tid
    assert len(spans) == 2 * 9


def test_spans_match_their_ranges_in_a_chrome_trace(tmp_path):
    """Under a profiler each span also opens a ``record_function`` range;
    on the trace's clock the span lies within 1 ms of it."""
    step, img, txt = _step()
    step(0, img, txt)
    with _profiled() as prof:
        for i in range(1, 3):
            step(i, img, txt)
    spans = profiling.take_spans()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    base = data["baseTimeNanoseconds"]
    ranges = sorted((e for e in data["traceEvents"] if e.get("ph") == "X"
                     and e.get("name", "").startswith("uml.step")),
                    key=lambda e: float(e["ts"]))
    spans.sort(key=lambda s: s.start_ns)
    assert [e["name"] for e in ranges] == [s.name for s in spans]
    assert len(spans) == 2 * 9
    for s, e in zip(spans, ranges):
        start = profiling.trace_us(s.start_ns, base)
        end = profiling.trace_us(s.end_ns, base)
        assert abs(start - float(e["ts"])) < 1000
        assert abs(end - float(e["ts"]) - float(e["dur"])) < 1000
        assert e["tid"] == s.tid


def test_trace_and_summarize_records_spans_and_restores_the_switch(tmp_path, capsys):
    """Spans record inside ``trace_and_summarize`` and stop after it."""
    step, img, txt = _step()
    with profiling.trace_and_summarize(str(tmp_path), quiet=True):
        step(0, img, txt)
        assert profiling.span("a") is not profiling.span("a")
    assert profiling.span("a") is profiling.span("b")
    step(1, img, txt)
    assert sum(s.name == "uml.step" for s in profiling.take_spans()) == 1


def test_extraction_records_stage_encode_and_fetch_of_one_batch(tmp_path, monkeypatch):
    enc = _encoder(tmp_path, monkeypatch)
    imgs = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    enc.encode_images(imgs)
    with _profiled():
        feats = enc.encode_images(imgs)
    assert feats.shape == (2, 64)
    spans = sorted(profiling.take_spans(), key=lambda s: s.start_ns)
    assert [s.name for s in spans] == [
        "uml.extract.stage", "uml.extract.encode", "uml.extract.fetch"]
    assert all(s.parent is None for s in spans)
    assert spans[0].end_ns <= spans[1].start_ns and spans[1].end_ns <= spans[2].start_ns


def test_nested_spans_name_the_span_around_them_on_their_thread():
    """A span's parent is the innermost open span of its own thread: one
    opened on another thread meanwhile is outermost there."""
    def elsewhere():
        with profiling.span("elsewhere"):
            pass

    with _profiled():
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
            worker = threading.Thread(target=elsewhere)
            worker.start()
            worker.join()
            with profiling.span("sibling"):
                pass
    spans = {s.name: s for s in profiling.take_spans()}
    assert set(spans) == {"outer", "inner", "elsewhere", "sibling"}
    assert spans["inner"].parent == spans["sibling"].parent == spans["outer"].id
    assert spans["outer"].parent is None and spans["elsewhere"].parent is None
    assert spans["elsewhere"].tid != spans["outer"].tid == spans["inner"].tid
    assert len({s.id for s in spans.values()}) == 4
